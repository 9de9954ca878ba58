"""Roofline report and baseline check for the port's dry-run (the port of
``benchmarks/roofline.py`` and ``scripts/check_roofline_baselines.py``).

Reads the JSON cells that ``python -m repro_torch.launch.dryrun`` writes
(``experiments/dryrun_torch/`` by default) and prints one line a cell:

  compute    = FLOPs/dev / 989 TFLOP/s             (bf16 dense, H100 SXM5)
  memory     = analytic HBM bytes/dev / 3.35 TB/s  (HBM3)
  collective = NVLink bytes / 450 GB/s + InfiniBand bytes / 50 GB/s

with the bottleneck, the useful-FLOPs ratio (6·N_active·D / counted FLOPs)
and the roofline fraction (useful model time / the step's lower bound).

The dry-run's memory term counts every eager op's inputs and outputs: an
unfused upper bound. As the JAX package's report does, ``augment`` swaps it
for ``CellModel.hbm_bytes_dev`` (launch/analytic.py), keeps the counted
term as ``memory_s_counted_upper``, and picks the bottleneck and the step's
lower bound again. Mesh shapes and constants are the H100 fleet's
(launch/mesh.py). The report also flags, without writing them into the
dry-run's JSON:

  replicated-batch  the cell's batch does not divide over its batch axes,
                    so the all-or-nothing rule replicates it (the multi-pod
                    ``prefill_32k`` cells: 32 sequences over pod x data = 64)
  over-hbm          the peak of live op results exceeds one GPU's HBM

Baselines: ``--write`` records every cell's three terms, useful ratio,
roofline fraction and bottleneck; ``--check`` compares them within
``--rtol`` (5%). A baselined cell missing from the artifacts fails unless
``--allow-missing``; a cell without a baseline is reported as new.

Usage, from the checkout's root (the default paths are relative to the
current directory):
  python -m repro_torch.launch.roofline                  # the table
  python -m repro_torch.launch.roofline --dir DIR --check
  python -m repro_torch.launch.roofline --dir DIR --write
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from types import SimpleNamespace

from repro_torch.launch import mesh as meshlib

# relative to the current directory (the checkout's root), as the dry-run
# writes them
DRYRUN_DIR = os.path.join("experiments", "dryrun_torch")
BASELINE_PATH = os.path.join("experiments", "baselines",
                             "roofline_baselines_torch.json")
TERMS = ("compute_s", "memory_s", "collective_s")
CHECKED = (*TERMS, "useful_flops_ratio", "roofline_fraction")


def mesh_shape(name: str) -> dict:
    """``{axis: size}`` of a dry-run mesh name: ``pod_32x8`` is (data,
    model), ``multipod_2x32x8`` is (pod, data, model), the names of
    launch/mesh.py's SINGLE_POD and MULTI_POD."""
    kind, dims = name.split("_", 1)
    names = (meshlib.MULTI_POD if kind == "multipod" else meshlib.SINGLE_POD)[1]
    sizes = [int(x) for x in dims.split("x")]
    if len(sizes) != len(names):
        raise ValueError(f"mesh {name!r} does not have the axes {names}")
    return dict(zip(names, sizes))


def cell_config(r: dict) -> tuple:
    """(config, ShapeSpec) of a dry-run row, as the dry-run built them."""
    from repro_torch.configs.base import SHAPES
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.dryrun import apply_overrides, cell_defaults
    shape = SHAPES[r["shape"]]
    cfg = apply_overrides(cell_defaults(get_config(r["arch"]), shape),
                          r.get("overrides"))
    return cfg, shape


def batch_replicates(kind: str, batch: int, ms: dict) -> bool:
    """True where the rules of ``kind`` leave a batch of ``batch`` sequences
    whole on every rank of a mesh of shape ``ms``."""
    from repro_torch.dist import sharding as shd
    rules = shd.rules_for(kind, multi_pod="pod" in ms)
    spec = shd.pspec_for((batch,), ("batch",), rules, SimpleNamespace(shape=ms))
    return spec[0] is None


def augment(r: dict, cfg=None, shape=None) -> dict:
    """Swap the counted memory term for the analytic one, choose the
    bottleneck and the lower bound again, and add the report's flags
    (``r["flags"]``). ``cfg`` and ``shape`` default to the row's own."""
    from repro_torch.launch.analytic import CellModel
    if cfg is None or shape is None:
        cfg, shape = cell_config(r)
    ms = mesh_shape(r["mesh"])
    micro = r.get("micro_global_batch", 0)
    cm = CellModel(cfg, shape, ms, micro)
    hbm = cm.hbm_bytes_dev(r.get("n_micro", 1), r["params"])
    rl = r["roofline"]
    rl["memory_s_counted_upper"] = rl["memory_s"]
    rl["bottleneck_counted"] = rl["bottleneck"]
    rl["memory_s"] = hbm / meshlib.HBM_BW
    rl["bottleneck"] = max(((t[:-2], rl[t]) for t in TERMS), key=lambda kv: kv[1])[0]
    rl["step_s_lower_bound"] = max(rl[t] for t in TERMS)
    flags = []
    if batch_replicates(shape.kind, micro or shape.global_batch, ms):
        flags.append("replicated-batch")
    if r["peak_temp_bytes"] > meshlib.HBM_BYTES:
        flags.append("over-hbm")
    r["flags"] = flags
    return r


def load(d: str = DRYRUN_DIR, pattern: str = "*.json", resolve=cell_config) -> list:
    """Every dry-run row under ``d``, augmented; ``resolve(row)`` gives a
    row's (config, ShapeSpec)."""
    rows = []
    for f in sorted(glob.glob(os.path.join(d, pattern))):
        with open(f) as fh:
            r = json.load(fh)
        rows.append(augment(r, *resolve(r)))
    return rows


def roofline_fraction(r: dict) -> float:
    """Useful model-FLOPs time over the step's lower bound."""
    ideal_s = r["model_flops"] / (r["n_devices"] * meshlib.PEAK_FLOPS_BF16)
    lower = r["roofline"]["step_s_lower_bound"]
    return ideal_s / lower if lower > 0 else 0.0


HEADER = ("arch,shape,mesh,tag,compute_ms,memory_ms,collective_ms,bottleneck,"
          "memory_counted_ms,useful_flops_pct,roofline_frac_pct,peak_temp_gib,flags")


def fmt_row(r: dict) -> str:
    rl = r["roofline"]
    return (f"{r['arch']},{r['shape']},{r['mesh']},{r.get('tag', '') or '-'},"
            f"{rl['compute_s'] * 1e3:.4f},{rl['memory_s'] * 1e3:.4f},"
            f"{rl['collective_s'] * 1e3:.4f},{rl['bottleneck']},"
            f"{rl['memory_s_counted_upper'] * 1e3:.4f},"
            f"{r['useful_flops_ratio'] * 100:.3f},{roofline_fraction(r) * 100:.3f},"
            f"{r['peak_temp_bytes'] / 2**30:.2f},{'+'.join(r['flags']) or '-'}")


def split(rows: list, key: str = "bottleneck") -> dict:
    """{bottleneck: cells} over ``rows``."""
    out = {"compute": 0, "memory": 0, "collective": 0}
    for r in rows:
        out[r["roofline"][key]] += 1
    return out


def cell_key(r: dict) -> str:
    return f"{r['arch']}|{r['shape']}|{r['mesh']}|{r.get('tag', '') or ''}"


def summarize(r: dict) -> dict:
    rl = r["roofline"]
    out = {t: rl[t] for t in TERMS}
    out["bottleneck"] = rl["bottleneck"]
    out["useful_flops_ratio"] = r["useful_flops_ratio"]
    out["roofline_fraction"] = roofline_fraction(r)
    return out


def rel_delta(a: float, b: float) -> float:
    return abs(a - b) / max(abs(a), abs(b), 1e-12)


def check(rows: list, baseline_path: str = BASELINE_PATH, rtol: float = 0.05,
          allow_missing: bool = False, write: bool = False) -> int:
    """Write the baselines of ``rows`` (``write``) or compare ``rows`` with
    them; prints what it finds and returns an exit code."""
    current = {cell_key(r): summarize(r) for r in rows}
    if write:
        os.makedirs(os.path.dirname(os.path.abspath(baseline_path)), exist_ok=True)
        with open(baseline_path, "w") as f:
            json.dump(current, f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"wrote {len(current)} baseline cells -> {baseline_path}")
        return 0
    if not os.path.exists(baseline_path):
        print(f"no baseline file at {baseline_path}: run with --write first")
        return 1
    with open(baseline_path) as f:
        baselines = json.load(f)
    failures, drifted = [], []
    for key, base in sorted(baselines.items()):
        got = current.get(key)
        if got is None:
            line = f"  MISSING from artifacts: {key}"
            print(line + (" (allowed)" if allow_missing else ""))
            if not allow_missing:
                failures.append(key)
            continue
        deltas = {t: (base[t], got[t], rel_delta(base[t], got[t])) for t in CHECKED
                  if rel_delta(base[t], got[t]) > rtol}
        if base["bottleneck"] != got["bottleneck"]:
            deltas["bottleneck"] = (base["bottleneck"], got["bottleneck"], None)
        if deltas:
            drifted.append((key, deltas))
    new = sorted(set(current) - set(baselines))
    print(f"cells: {len(current)} current, {len(baselines)} baselined, "
          f"{len(new)} new (no baseline)")
    for key in new:
        print(f"  new: {key}")
    for key, deltas in drifted:
        failures.append(key)
        print(f"  DRIFTED: {key}")
        for term, (want, got_v, d) in deltas.items():
            extra = f" ({d * 100:.1f}% off)" if d is not None else ""
            print(f"    {term}: baseline={want} current={got_v}{extra}")
    if failures:
        print(f"FAIL: {len(failures)} cell(s) drifted or missing (rtol={rtol})")
        return 1
    print(f"all baselined roofline cells within tolerance (rtol={rtol})")
    return 0


def report(rows: list) -> None:
    print(HEADER)
    for r in rows:
        print(fmt_row(r))
    print(f"# bottlenecks, analytic memory term: {split(rows)}; "
          f"counted memory term: {split(rows, 'bottleneck_counted')}")
    for r in rows:
        if r["flags"]:
            print(f"# flagged {cell_key(r)}: {', '.join(r['flags'])}")


def main(argv=None, resolve=cell_config) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dir", default=DRYRUN_DIR, help="the dry-run's JSON cells")
    ap.add_argument("--baseline", default=BASELINE_PATH)
    ap.add_argument("--rtol", type=float, default=0.05,
                    help="relative tolerance per numeric term")
    ap.add_argument("--check", action="store_true",
                    help="compare the cells with the baseline file")
    ap.add_argument("--write", action="store_true",
                    help="write the baseline file from the cells")
    ap.add_argument("--allow-missing", action="store_true",
                    help="baselined cells absent from the artifacts only warn")
    args = ap.parse_args(argv)
    rows = load(args.dir, resolve=resolve)
    if not rows:
        print(f"no dry-run cells under {args.dir}: run "
              "`python -m repro_torch.launch.dryrun` first")
        return 1
    report(rows)
    if args.check or args.write:
        return check(rows, args.baseline, args.rtol, args.allow_missing, args.write)
    return 0


if __name__ == "__main__":
    sys.exit(main())
