"""The benchmark's own tests, run on the CPU at a smoke size:

    python -m pytest geoffbench/tests -q

Every test runs against a checkout made in a temporary directory: the
benchmark's files and ``BENCHMARK.json`` as committed, plus the open-loop
cells kept under ``tests/data`` (Poisson documents and scanned pages on
llava-next-34b), which exercise the generator's open loop and the
pre-fetched page path that no committed cell runs yet.

Tests marked ``card`` need a CUDA card and skip without one; they decide
inside a fixture, never at import."""
import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
DATA = Path(__file__).resolve().parent / "data"
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

# a smoke size of every cell's architecture: the widths cut, the rest kept
SMALL = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
             d_ff=128, vocab_size=256)
SMALL_TEXT = dict(median=24, sigma=0.64, min=8, max=64)

COMMITTED = "qwen3-32b.doc-classify.batch2"
# the tests' own cells: (name, config, traffic)
TEST_CELLS = (("qwen3-32b.doc-classify.open", "qwen3-32b", "doc-classify.open"),
              ("llava-next-34b.page-classify.open", "llava-next-34b", "page-classify.open"))
WORKLOADS = (TEST_CELLS[0][0], TEST_CELLS[1][0], COMMITTED)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


def make_checkout(root: Path) -> Path:
    """The benchmark's files at ``root``, with the tests' cells added as a
    later change would add them: files and entries, no file edited."""
    shutil.copytree(ROOT / "geoffbench", root / "geoffbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for sub in ("configs", "traffic", "metrics"):
        for f in (DATA / sub).iterdir():
            shutil.copy(f, root / "geoffbench" / sub / f.name)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "llava-next-34b",
                             "source": "https://huggingface.co/llava-hf/llava-v1.6-34b-hf",
                             "file": "geoffbench/configs/llava-next-34b.json",
                             "reduced": [], "why": "the tests' page cell"})
    names = [c[0] for c in TEST_CELLS]
    for name, config, mix in TEST_CELLS:
        bench["workloads"].append({"name": name, "config": config, "traffic": mix,
                                   "chips": 1, "why": "a test's open-loop cell"})
    bench["end_to_end"].append({"name": "request_p90_s", "unit": "s", "better": "lower",
                                "bound": 0.25, "source": "host_clock", "workloads": names})
    for m in bench["per_layer"]:
        m["workloads"] = m["workloads"] + names
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


@pytest.fixture(scope="session")
def checkout(tmp_path_factory):
    return make_checkout(tmp_path_factory.mktemp("checkout"))


@pytest.fixture(autouse=True)
def _in_checkout(checkout, monkeypatch):
    from geoffbench import spec
    monkeypatch.setattr(spec, "ROOT", checkout)
    monkeypatch.setattr(spec, "HERE", checkout / "geoffbench")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100)")
    return torch.device("cuda")


def small_cell(name):
    """``name``'s cell at the smoke size, on the CPU, computing in bf16 as
    the cells do."""
    from geoffbench import spec
    from geoffbench.cell import Cell
    bench = spec.load_benchmark()
    entry = spec.workload(bench, name)
    arch = dict(spec.config(bench, entry["config"])["port"], **SMALL)
    if arch["num_patches"]:
        arch["num_patches"] = 8
    m = dict(spec.traffic(entry["traffic"]), text=dict(SMALL_TEXT))
    return Cell(name, "cpu", arch=arch, mix=m), bench
