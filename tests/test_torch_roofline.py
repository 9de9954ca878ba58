"""The port's roofline report and baseline check
(``repro_torch.launch.roofline``) on the dry-run's 16-rank smoke cells, as
``test_torch_dryrun.py`` builds them: the analytic memory term, the
bottleneck, ``--write`` then ``--check``, a drifted term, a missing cell
and the fault-5 flag; then held to the JAX package's report
(``benchmarks/roofline.py::_augment``) and baseline check
(``scripts/check_roofline_baselines.py``) on the same rows. The cells run
in a subprocess: a fake process group is global to its process."""
import copy
import importlib.util
import json
import os
import subprocess
import sys

import pytest

from repro_torch.configs.base import SHAPES, ShapeSpec
from repro_torch.configs.registry import get_config, smoke_config
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import roofline as rf
from repro_torch.launch.analytic import CellModel
from repro_torch.launch.dryrun import cell_defaults

ROOT = os.path.join(os.path.dirname(__file__), "..")
CFG = smoke_config("qwen3-1.7b").replace(num_heads=8, num_kv_heads=4, d_ff=256)
CELL_SHAPES = {"t": ShapeSpec("t", 64, 8, "train"),
               "p": ShapeSpec("p", 64, 8, "prefill"),
               "d": ShapeSpec("d", 64, 8, "decode")}
CELL = r"""
import sys, torch, torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.configs.base import ShapeSpec
from repro_torch.configs.registry import smoke_config
from repro_torch.launch.dryrun import run_cell
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=16)
mesh = DeviceMesh("cpu", torch.arange(16).reshape(4, 4),
                  mesh_dim_names=("data", "model"))
cfg = smoke_config("qwen3-1.7b").replace(num_heads=8, num_kv_heads=4, d_ff=256)
for shape in (ShapeSpec("t", 64, 8, "train"), ShapeSpec("p", 64, 8, "prefill"),
              ShapeSpec("d", 64, 8, "decode")):
    run_cell("qwen3-1.7b", shape.name, out_dir=sys.argv[1], device="cpu", cfg=cfg,
             mesh=mesh, shape=shape, micro_tokens=16, verbose=False)
"""


def smoke_resolve(r):
    shape = CELL_SHAPES[r["shape"]]
    return cell_defaults(CFG, shape), shape


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    p = subprocess.run([sys.executable, "-c", CELL, str(d)], env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, (p.stdout + p.stderr)[-4000:]
    assert sorted(os.listdir(d)) == [f"qwen3-1_7b__{s}__sp.json" for s in "dpt"]
    return d


def raw(d):
    return {n: json.load(open(os.path.join(d, n))) for n in sorted(os.listdir(d))}


def test_memory_term_is_the_analytic_hbm_bytes(cells):
    rows = rf.load(str(cells), resolve=smoke_resolve)
    counted = raw(cells)
    assert len(rows) == 3
    for r, c in zip(rows, counted.values()):
        cfg, shape = smoke_resolve(r)
        cm = CellModel(cfg, shape, {"data": 4, "model": 4}, r["micro_global_batch"])
        want = cm.hbm_bytes_dev(r["n_micro"], r["params"]) / meshlib.HBM_BW
        rl = r["roofline"]
        assert rl["memory_s"] == pytest.approx(want, rel=1e-12)
        assert rl["memory_s_counted_upper"] == c["roofline"]["memory_s"]
        assert rl["bottleneck_counted"] == c["roofline"]["bottleneck"]
        assert rl["compute_s"] == c["roofline"]["compute_s"]
        assert rl["collective_s"] == c["roofline"]["collective_s"]
        assert r["flags"] == []
    # the flags stay out of the dry-run's JSON
    assert all("flags" not in c for c in counted.values())


def test_bottleneck_is_the_largest_term(cells):
    for r in rf.load(str(cells), resolve=smoke_resolve):
        rl = r["roofline"]
        terms = {t[:-2]: rl[t] for t in rf.TERMS}
        assert rl["bottleneck"] == max(terms, key=terms.get)
        assert rl["step_s_lower_bound"] == max(terms.values())
        # the lower bound is at least the compute term: the fraction is at
        # most the useful ratio
        assert 0 < rf.roofline_fraction(r) <= r["useful_flops_ratio"] * (1 + 1e-12)
        assert rf.fmt_row(r).count(",") == rf.HEADER.count(",")


def test_write_then_check_passes(cells, tmp_path, capsys):
    base = str(tmp_path / "baselines.json")
    argv = ["--dir", str(cells), "--baseline", base]
    assert rf.main(argv + ["--write"], resolve=smoke_resolve) == 0
    assert sorted(json.load(open(base))) == [
        f"qwen3-1.7b|{s}|pod_4x4|" for s in "dpt"]
    assert rf.main(argv + ["--check"], resolve=smoke_resolve) == 0
    out = capsys.readouterr().out
    assert "all baselined roofline cells within tolerance" in out
    assert rf.HEADER in out and "# bottlenecks" in out


@pytest.mark.parametrize("move,rc", [(1.06, 1), (1.04, 0), (0.94, 1), (0.96, 0)])
@pytest.mark.parametrize("term", ["compute_s", "memory_s", "collective_s",
                                  "useful_flops_ratio"])
def test_a_moved_term_fails_past_five_percent(cells, tmp_path, term, move, rc):
    rows = rf.load(str(cells), resolve=smoke_resolve)
    base = str(tmp_path / "baselines.json")
    assert rf.check(rows, base, write=True) == 0
    saved = json.load(open(base))
    key = "qwen3-1.7b|t|pod_4x4|"
    saved[key][term] *= move
    # hold the bottleneck: only the moved number is under test
    json.dump(saved, open(base, "w"))
    assert rf.check(rows, base) == rc


def test_bottleneck_change_fails(cells, tmp_path):
    rows = rf.load(str(cells), resolve=smoke_resolve)
    base = str(tmp_path / "baselines.json")
    rf.check(rows, base, write=True)
    saved = json.load(open(base))
    key = "qwen3-1.7b|p|pod_4x4|"
    saved[key]["bottleneck"] = next(b for b in ("compute", "memory", "collective")
                                    if b != saved[key]["bottleneck"])
    json.dump(saved, open(base, "w"))
    assert rf.check(rows, base) == 1


def test_missing_cell_fails_without_allow_missing(cells, tmp_path, capsys):
    rows = rf.load(str(cells), resolve=smoke_resolve)
    base = str(tmp_path / "baselines.json")
    rf.check(rows, base, write=True)
    assert rf.check(rows[1:], base) == 1
    assert "MISSING from artifacts" in capsys.readouterr().out
    assert rf.check(rows[1:], base, allow_missing=True) == 0
    # a cell without a baseline is new, not a failure
    saved = json.load(open(base))
    del saved["qwen3-1.7b|d|pod_4x4|"]
    json.dump(saved, open(base, "w"))
    assert rf.check(rows, base) == 0
    assert "new: qwen3-1.7b|d|pod_4x4|" in capsys.readouterr().out
    assert rf.check(rows, str(tmp_path / "none.json")) == 1


def test_multi_pod_prefill_32k_row_is_flagged_replicated(cells):
    """Fault 5: on (pod=2, data=32, model=8) the 32 sequences of prefill_32k
    do not divide over pod x data = 64, so the batch replicates; on the
    single-pod mesh they split 32 ways. A smoke row renamed to those cells
    (the flags read the row's mesh and shape only)."""
    row = next(r for n, r in raw(cells).items() if r["shape"] == "p")
    cfg = get_config("recurrentgemma-9b")
    shape = SHAPES["prefill_32k"]
    out = {}
    for mesh in ("multipod_2x32x8", "pod_32x8"):
        r = copy.deepcopy(row)
        r.update(arch="recurrentgemma-9b", shape="prefill_32k", mesh=mesh,
                 micro_global_batch=shape.global_batch)
        out[mesh] = rf.augment(r, cell_defaults(cfg, shape), shape)["flags"]
    assert out == {"multipod_2x32x8": ["replicated-batch"], "pod_32x8": []}
    assert rf.mesh_shape("multipod_2x32x8") == dict(
        zip(meshlib.MULTI_POD[1], meshlib.MULTI_POD[0]))
    assert rf.mesh_shape("pod_32x8") == dict(
        zip(meshlib.SINGLE_POD[1], meshlib.SINGLE_POD[0]))


def test_peak_over_hbm_is_flagged(cells):
    r = rf.load(str(cells), resolve=smoke_resolve)[0]
    r = copy.deepcopy(r)
    r["roofline"]["memory_s"] = r["roofline"]["memory_s_counted_upper"]
    r["peak_temp_bytes"] = meshlib.HBM_BYTES + 1
    assert rf.augment(r, *smoke_resolve(r))["flags"] == ["over-hbm"]
    assert "over-hbm" in rf.fmt_row(r)


# -- held to the JAX package's report and baseline check ----------------------
REF_CELLS = (("qwen3-1.7b", "train_4k"), ("qwen3-1.7b", "decode_32k"),
             ("granite-moe-3b-a800m", "train_4k"),
             ("recurrentgemma-9b", "prefill_32k"))


def ref_modules():
    """The JAX package's report and its baseline check, as modules."""
    from benchmarks import roofline as jrf
    spec = importlib.util.spec_from_file_location(
        "check_roofline_baselines",
        os.path.join(ROOT, "scripts", "check_roofline_baselines.py"))
    jcheck = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jcheck)
    return jrf, jcheck


def renamed(cells, arch, shape, mesh):
    """The smoke train row renamed to a full-size cell on ``mesh``: the
    analytic term reads only the row's names, batch, n_micro and params."""
    row = copy.deepcopy(next(r for r in raw(cells).values() if r["shape"] == "t"))
    row.update(arch=arch, shape=shape, mesh=mesh, n_micro=1,
               micro_global_batch=SHAPES[shape].global_batch)
    return row


@pytest.mark.parametrize("winner", ["compute", "memory", "collective"])
@pytest.mark.parametrize("mesh", ["pod_16x16", "multipod_2x16x16"])
@pytest.mark.parametrize("arch,shape", REF_CELLS)
def test_augment_agrees_with_the_reference(cells, monkeypatch, arch, shape, mesh,
                                           winner):
    """One row renamed to a cell on the reference's own meshes goes through
    ``_augment`` and the port's ``augment``: the same HBM bytes (memory_s
    times each side's HBM_BW); with HBM_BW made equal, the same memory
    term, bottleneck and lower bound. The row's compute and collective
    terms are set around the memory term so that ``winner`` is largest."""
    jrf, _ = ref_modules()
    row = renamed(cells, arch, shape, mesh)
    mem = jrf._augment(copy.deepcopy(row))["roofline"]["memory_s"]
    for term in ("compute", "collective"):
        row["roofline"][f"{term}_s"] = mem * (2.0 if term == winner else 0.5)
    want = jrf._augment(copy.deepcopy(row))["roofline"]
    got = rf.augment(copy.deepcopy(row))["roofline"]
    assert got["memory_s"] * meshlib.HBM_BW == pytest.approx(
        want["memory_s"] * jrf.HBM_BW, rel=1e-12)
    assert want["bottleneck"] == winner
    monkeypatch.setattr(meshlib, "HBM_BW", jrf.HBM_BW)
    got = rf.augment(copy.deepcopy(row))["roofline"]
    assert got["bottleneck"] == want["bottleneck"]
    for k in ("memory_s", "step_s_lower_bound", "compute_s", "collective_s"):
        assert got[k] == pytest.approx(want[k], rel=1e-12), k
    assert got["memory_s_counted_upper"] == want["memory_s_xla_upper"]


@pytest.mark.parametrize("mesh,axes", [
    ("pod_32x8", {"data": 32, "model": 8}),
    ("multipod_2x32x8", {"pod": 2, "data": 32, "model": 8})])
@pytest.mark.parametrize("arch,shape", REF_CELLS)
def test_h100_mesh_memory_term_equals_the_reference_cell_model(cells, arch, shape,
                                                               mesh, axes):
    """On the H100 meshes, which are not square, the port's memory term is
    the reference's ``CellModel`` on the mesh's (pod, data, model) sizes,
    and not on the sizes with data and model swapped."""
    from repro.configs.base import SHAPES as JSHAPES
    from repro.configs.registry import get_config as jget
    from repro.launch.analytic import CellModel as JCellModel
    from repro.launch.dryrun import cell_defaults as jdefaults
    row = renamed(cells, arch, shape, mesh)
    jshape = JSHAPES[shape]
    jcfg = jdefaults(jget(arch), jshape)

    def ref_bytes(ms):
        return JCellModel(jcfg, jshape, ms, row["micro_global_batch"]).hbm_bytes_dev(
            row["n_micro"], row["params"])

    got = rf.augment(copy.deepcopy(row))["roofline"]["memory_s"] * meshlib.HBM_BW
    assert got == pytest.approx(ref_bytes(axes), rel=1e-12)
    swapped = dict(axes, data=axes["model"], model=axes["data"])
    assert got != pytest.approx(ref_bytes(swapped), rel=1e-3)


def test_summarize_and_cell_key_equal_the_reference(cells, monkeypatch):
    """``summarize`` and ``cell_key`` against the reference script's, with
    the peak made equal, on the smoke rows, a tagged one among them."""
    jrf, jcheck = ref_modules()
    monkeypatch.setattr(jrf, "PEAK_FLOPS_BF16", meshlib.PEAK_FLOPS_BF16)
    rows = rf.load(str(cells), resolve=smoke_resolve)
    rows.append(dict(copy.deepcopy(rows[0]), tag="variant"))
    for r in rows:
        assert rf.cell_key(r) == jcheck.cell_key(r)
        assert rf.summarize(r) == jcheck.summarize(r)
    assert len({rf.cell_key(r) for r in rows}) == 4


def _moved(term, f):
    def edit(base, rows):
        base["qwen3-1.7b|t|pod_4x4|"][term] *= f
        return base, rows
    return edit


def _flip_bottleneck(base, rows):
    cell = base["qwen3-1.7b|p|pod_4x4|"]
    cell["bottleneck"] = next(b for b in ("compute", "memory", "collective")
                              if b != cell["bottleneck"])
    return base, rows


# scenario -> (edit of (baseline, rows), the reference's exit code without
# --allow-missing, with it)
CHECK_CASES = {
    "unchanged": (lambda b, r: (b, r), 0, 0),
    **{f"{t}*{f}": (_moved(t, f), int(abs(f - 1) > 0.05), int(abs(f - 1) > 0.05))
       for t in (*rf.TERMS, "useful_flops_ratio", "roofline_fraction")
       for f in (0.94, 0.96, 1.04, 1.06)},
    "bottleneck": (_flip_bottleneck, 1, 1),
    "missing": (lambda b, r: (b, r[1:]), 1, 0),
    "new": (lambda b, r: ({k: v for k, v in b.items()
                           if k != "qwen3-1.7b|d|pod_4x4|"}, r), 0, 0),
}


@pytest.mark.parametrize("allow_missing", [False, True])
@pytest.mark.parametrize("case", sorted(CHECK_CASES))
def test_check_agrees_with_the_reference_script(cells, tmp_path, monkeypatch, capsys,
                                                case, allow_missing):
    """The reference script's ``--write`` and the port's write the same
    baseline (peak made equal); after the same edit of baseline or cells,
    both give the same exit code and the same lines for each cell."""
    jrf, jcheck = ref_modules()
    monkeypatch.setattr(jrf, "PEAK_FLOPS_BF16", meshlib.PEAK_FLOPS_BF16)
    rows = rf.load(str(cells), resolve=smoke_resolve)
    jbase, tbase = str(tmp_path / "ref.json"), str(tmp_path / "port.json")
    monkeypatch.setattr(jcheck, "BASELINE_PATH", jbase)
    monkeypatch.setattr(jrf, "load", lambda *a, **k: rows)
    assert jcheck.main(["--write"]) == 0
    assert rf.check(rows, tbase, write=True) == 0
    assert json.load(open(tbase)) == json.load(open(jbase))
    edit, rc, rc_allowed = CHECK_CASES[case]
    base, now = edit(json.load(open(jbase)), rows)
    for path in (jbase, tbase):
        with open(path, "w") as f:
            json.dump(base, f)
    monkeypatch.setattr(jrf, "load", lambda *a, **k: now)
    capsys.readouterr()
    want = jcheck.main(["--allow-missing"] if allow_missing else [])
    want_out = capsys.readouterr().out
    got = rf.check(now, tbase, allow_missing=allow_missing)
    got_out = capsys.readouterr().out
    assert want == (rc_allowed if allow_missing else rc)
    assert got == want

    def per_cell(out):
        return sorted(ln for ln in out.splitlines() if ln.startswith("  "))
    assert per_cell(got_out) == per_cell(want_out)
