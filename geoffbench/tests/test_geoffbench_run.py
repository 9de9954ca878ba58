"""Whole runs at a smoke size on the CPU: the result line's keys, the
faults that must turn ``correct`` false, a cell taken up from added files
alone, and the modules a run loads."""
import ast
import json
import shutil
import subprocess
import sys
import time

import pytest
import torch

from geoffbench import spec
from geoffbench import run as R
from geoffbench import trace as T

from conftest import COMMITTED, DATA, ROOT, WORKLOADS, small_cell

# limits at the smoke size, set from its readings as the cells' are from
# theirs: the program reads ~0.007 in logits_rel_err, the fp8 control ~0.07
SMOKE_LIMITS = {"failed": {"limit": 0}, "misrouted": {"limit": 0},
                "label_not_argmax": {"limit": 0}, "logits_rel_err": {"limit": 0.02},
                "label_gap": {"limit": None}}
SEED = 2**31 + 4242


class FakeTrace(T.DeviceTrace):
    """Device operations made up around the window (no card here)."""

    def start(self):
        self.offset_ns = time.time_ns() - time.perf_counter_ns()
        self.lo_ns = time.perf_counter_ns() + self.offset_ns

    def stop(self):
        self.hi_ns = time.perf_counter_ns() + self.offset_ns
        lo, span = self.lo_ns, self.hi_ns - self.lo_ns
        self.events = [("void flash_fwd_hopper<128>(CUtensorMap_st)", lo + span // 10,
                        lo + span // 5),
                       ("nvjet_tst_256x160", lo + span // 5, lo + span // 2)]


def run_small(name, monkeypatch=None, trace=False, limits=SMOKE_LIMITS, seconds=1.5):
    if trace:
        monkeypatch.setattr("geoffbench.cell.DeviceTrace", FakeTrace)
    cell, bench = small_cell(name)
    return R.measure(cell, SEED, seconds, trace, time.perf_counter(), limits, bench)


@pytest.mark.parametrize("name", WORKLOADS)
@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(name, trace, monkeypatch):
    res, lines = run_small(name, monkeypatch, trace)
    keys = list(res)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    bench = spec.load_benchmark()
    want = spec.metrics(bench, name, "per_layer" if trace else "end_to_end")
    assert set(res["metrics"]) == {m["name"] for m in want}
    for m in want:
        got = res["metrics"][m["name"]]
        assert got["unit"] == m["unit"] and isinstance(got["value"], float)
    dev = res["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert dev["busy_s"] > 0 and dev["window_s"] > 0
        b = res["breakdown"]
        assert 0 < len(b["device_ops"]) <= 10 and 0 < len(b["idle_gaps"]) <= 10
    else:
        assert "breakdown" not in res
    assert len(lines) == len(res["checks"])
    assert all(line.startswith("check ") and " limit " in line for line in lines)
    json.dumps(res)


def _patch_handler(monkeypatch, alter):
    """``alter(out)`` applied to every answer ``classify`` produces."""
    from geoffbench.cell import Cell
    orig = Cell._deploy

    def deploy(self):
        orig(self)
        w = self.dep._functions[("classify", "gpu")].wrapper
        fn = w.fn
        w.fn = lambda payload, data: alter(fn(payload, data))
    monkeypatch.setattr(Cell, "_deploy", deploy)


def test_a_sound_run_is_correct():
    res, _ = run_small("qwen3-32b.doc-classify.open")
    assert res["correct"] is True


def test_fault_label_altered_where_produced(monkeypatch):
    def alter(out):
        out["label"] = (out["label"] + 1) % 256
        return out
    _patch_handler(monkeypatch, alter)
    res, _ = run_small("qwen3-32b.doc-classify.open")
    assert res["correct"] is False
    assert res["checks"]["label_not_argmax"]["value"] > 0


def test_fault_answer_altered_where_produced(monkeypatch):
    from repro_torch.models import model as M
    orig = M.prefill

    def prefill(cfg, params, batch):
        logits, caches = orig(cfg, params, batch)
        return logits.roll(1, dims=-1), caches
    monkeypatch.setattr(M, "prefill", prefill)
    res, _ = run_small("llava-next-34b.page-classify.open")
    assert res["correct"] is False
    assert res["checks"]["logits_rel_err"]["value"] > 0.5


def test_fault_step_returns_its_state_unchanged(monkeypatch):
    from repro_torch.models import transformer as tfm
    monkeypatch.setattr(tfm, "run_blocks",
                        lambda cfg, p, x, *a, **k: (x, None, {}, 0.0))
    res, _ = run_small("qwen3-32b.doc-classify.batch2")
    assert res["correct"] is False


def test_fault_half_the_requests_left_out(monkeypatch):
    def alter(out):
        if out["id"] % 2:
            raise RuntimeError("dropped")
        return out
    # warm-up requests have negative ids: only the window's odd ones drop
    _patch_handler(monkeypatch, lambda out: out if out["id"] < 0 else alter(out))
    res, _ = run_small("qwen3-32b.doc-classify.open")
    assert res["correct"] is False and res["failed"] >= res["attempted"] // 2 - 1


def test_fault_answers_routed_to_the_wrong_request(monkeypatch):
    from repro_torch.core import Deployment
    orig = Deployment.run
    last = {}

    def run(self, spec_, payload, timeout_s=None):
        res = orig(self, spec_, payload, timeout_s)
        prev = last.get("out")
        last["out"] = res.outputs
        if prev is not None and payload["id"] >= 0:
            res.outputs = prev
        return res
    monkeypatch.setattr(Deployment, "run", run)
    res, _ = run_small("qwen3-32b.doc-classify.open")
    assert res["correct"] is False and res["checks"]["misrouted"]["value"] > 0


def test_fault_data_dependency_altered_on_delivery(monkeypatch):
    from repro_torch.core.prefetch import Prefetcher
    orig = Prefetcher.join

    def join(self, futs):
        data, exposed, modeled = orig(self, futs)
        return {k: torch.zeros_like(v) for k, v in data.items()}, exposed, modeled
    monkeypatch.setattr(Prefetcher, "join", join)
    res, _ = run_small("llava-next-34b.page-classify.open")
    assert res["correct"] is False


@pytest.mark.parametrize("name", ["qwen3-32b.doc-classify.open",
                                  "llava-next-34b.page-classify.open"])
def test_control_in_the_programs_place_is_not_correct(name, monkeypatch):
    """The fp8 reference served in place of the program's prefill."""
    from repro_torch.models import model as M
    cell, bench = small_cell(name)

    def prefill(cfg, params, batch):
        inp = {"tokens": batch["tokens"][0]}
        if "patches" in batch:
            inp["patches"] = batch["patches"][0]
        low = cell.model.last_logits(cell.arch, params, [inp], "fp8", cell.eps)[0]
        return low[None], {}
    monkeypatch.setattr(M, "prefill", prefill)
    res, _ = R.measure(cell, SEED, 1.5, False, time.perf_counter(), SMOKE_LIMITS, bench)
    assert res["correct"] is False
    assert res["checks"]["logits_rel_err"]["value"] > SMOKE_LIMITS["logits_rel_err"]["limit"]


ADDED_CELL = r'''
import json, sys, time
sys.path[:0] = [sys.argv[1], sys.argv[2]]
from geoffbench import run as R, spec
from geoffbench import trace as T
import geoffbench.cell as C
class Fake(T.DeviceTrace):
    def start(self):
        self.offset_ns = time.time_ns() - time.perf_counter_ns()
        self.lo_ns = time.perf_counter_ns() + self.offset_ns
    def stop(self):
        self.hi_ns = time.perf_counter_ns() + self.offset_ns
        self.events = [("k", self.lo_ns, self.lo_ns + 10)]
C.DeviceTrace = Fake
bench = spec.load_benchmark()
out = {}
for trace in (False, True):
    cell = C.Cell("tiny-7.doc-burst", "cpu")
    res, _ = R.measure(cell, 3, 1.0, trace, time.perf_counter(),
                       spec.limits("tiny-7.doc-burst"), bench)
    out[str(trace)] = res
print(json.dumps(out))
'''


TINY_MODEL = '''
"""The dense decoder, with the GEMMs as a kernel group of their own."""
from geoffbench import counts
from geoffbench.models import dense

layout, last_logits, prefill_flops = dense.layout, dense.last_logits, dense.prefill_flops


def bounds(arch, text_len, patches=0):
    return dict(dense.bounds(arch, text_len, patches),
                gemm=prefill_flops(arch, text_len, patches) / counts.PEAK_BF16_FLOPS)
'''


def test_a_cell_is_added_by_files_and_entries_alone(tmp_path):
    """A configuration with a model module of its own, a traffic mix, two
    per-layer metrics (one the roofline of the module's own kernel group,
    named by a pattern file) and its limits added as new files, and their
    entries added to BENCHMARK.json: the harness runs the new cell and
    reads the new metrics, no file edited."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "geoffbench", root / "geoffbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    g = root / "geoffbench"
    before = {p: p.read_bytes() for p in g.rglob("*") if p.is_file()}
    conf = json.loads((g / "configs" / "qwen3-32b.json").read_text())
    conf["name"] = conf["port"]["name"] = "tiny-7"
    conf["model"] = "tiny7"
    (g / "models" / "tiny7.py").write_text(TINY_MODEL)
    (g / "metrics" / "patterns" / "gemm").mkdir()
    (g / "metrics" / "patterns" / "gemm" / "fake.txt").write_text("^k$\n")
    (g / "metrics" / "fake.gemm_roofline.py").write_text(
        "from geoffbench.readers import roofline_pct\n\n\n"
        "def read(run):\n    return roofline_pct(run, 'gemm')\n")
    conf["port"].update(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                        head_dim=16, d_ff=128, vocab_size=300)
    (g / "configs" / "tiny-7.json").write_text(json.dumps(conf))
    mix = json.loads((DATA / "traffic" / "doc-classify.open.json").read_text())
    mix.update(rate_per_s=20.0, text={"median": 20, "sigma": 0.5, "min": 4, "max": 40})
    (g / "traffic" / "doc-burst.json").write_text(json.dumps(mix))
    (g / "metrics" / "fake.requests_seen.py").write_text(
        "def read(run):\n    return float(len(run.win.records))\n")
    (g / "limits" / "tiny-7.doc-burst.json").write_text(json.dumps(SMOKE_LIMITS))
    bench["configs"].append({"name": "tiny-7", "source": "https://example.org/tiny-7",
                             "file": "geoffbench/configs/tiny-7.json", "reduced": [],
                             "why": "a test's configuration"})
    bench["workloads"].append({"name": "tiny-7.doc-burst", "config": "tiny-7",
                               "traffic": "doc-burst", "chips": 1, "why": "a test's cell"})
    (g / "metrics" / "request_p90_s.py").write_bytes(
        (DATA / "metrics" / "request_p90_s.py").read_bytes())
    bench["end_to_end"].append({"name": "request_p90_s", "unit": "s", "better": "lower",
                                "bound": 0.25, "source": "host_clock",
                                "workloads": ["tiny-7.doc-burst"]})
    bench["per_layer"].append({"name": "fake.requests_seen", "unit": "1", "better": "higher",
                               "source": "program_counter", "layer": "workflow engine",
                               "moves": "request_p90_s", "workloads": ["tiny-7.doc-burst"]})
    bench["per_layer"].append({"name": "fake.gemm_roofline", "unit": "%", "better": "higher",
                               "source": "device_trace", "layer": "kernels",
                               "moves": "request_p90_s", "workloads": ["tiny-7.doc-burst"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    p = subprocess.run([sys.executable, "-c", ADDED_CELL, str(root), str(ROOT / "src")],
                       cwd=root, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert set(out["False"]["metrics"]) == {"request_p90_s", "setup_s"}
    assert out["True"]["metrics"]["fake.requests_seen"]["value"] == out["True"]["attempted"]
    assert out["True"]["metrics"]["fake.gemm_roofline"]["value"] > 0
    assert out["False"]["correct"] is True
    for path, data in before.items():
        assert path.read_bytes() == data, f"{path} was edited"


LOADED = r'''
import json, pathlib, sys, time
sys.path[:0] = [sys.argv[1], sys.argv[1] + "/src", sys.argv[1] + "/geoffbench/tests"]
mode = sys.argv[2]
if mode == "run":
    from conftest import WORKLOADS, small_cell
    from geoffbench import run as R, spec
    spec.ROOT = pathlib.Path(sys.argv[3])
    spec.HERE = spec.ROOT / "geoffbench"
    for name in WORKLOADS:
        cell, bench = small_cell(name)
        R.measure(cell, 1, 1.0, False, time.perf_counter(), {}, bench)
    import geoffbench.sweep, geoffbench.calibrate  # noqa: F401
else:
    import geoffbench.reference  # noqa: F401
    from geoffbench import spec
    for f in (spec.HERE / "models").glob("[!_]*.py"):
        spec.model({"model": f.stem})
print(json.dumps(sorted({m.split(".", 1)[0] for m in sys.modules})))
'''


@pytest.mark.parametrize("mode", ["run", "reference"])
def test_nothing_of_jax_or_the_jax_package_is_loaded(mode, checkout):
    """A run of each cell (set-up, window, metrics, check) loads no module
    whose top-level name is jax, jaxlib, flax or repro, compared whole; the
    reference and the model modules alone load nothing of the program
    either."""
    p = subprocess.run([sys.executable, "-c", LOADED, str(ROOT), mode, str(checkout)],
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    top = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert not top & set(R.FORBIDDEN), top & set(R.FORBIDDEN)
    if mode == "run":
        assert "repro_torch" in top
    else:
        assert "repro_torch" not in top and "geoffbench" in top


@pytest.mark.parametrize("path", ["reference.py"] + sorted(
    f"models/{f.name}" for f in (ROOT / "geoffbench" / "models").glob("*.py")))
def test_reference_imports_only_torch(path):
    """The reference's building blocks import torch alone; a model module
    torch and the benchmark's yardstick."""
    tree = ast.parse((ROOT / "geoffbench" / path).read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module)
    if path == "reference.py":
        assert names == {"__future__", "contextlib", "torch"}
    else:
        assert names <= {"__future__", "math", "torch", "torch.nn.functional",
                         "geoffbench", "geoffbench.counts", "geoffbench.reference",
                         "geoffbench.weights"}, names


def test_command_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert R.main(["--workload", COMMITTED, "--seed", "1", "--seconds", "1"]) != 0
    out = capsys.readouterr()
    assert out.out == "" and "CUDA" in out.err


def test_command_fails_in_a_checkout_of_the_benchmark_alone(tmp_path):
    """Only BENCHMARK.json and the benchmark's files: no program to run."""
    shutil.copytree(ROOT / "geoffbench", tmp_path / "geoffbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    p = subprocess.run([sys.executable, "geoffbench/run.py", "--workload", COMMITTED,
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
