"""Multi-pod dry-run: prove the distribution config is coherent (port of
``repro/launch/dryrun.py``).

For every (architecture x input-shape x mesh) cell, build the 256- or
512-GPU H100 mesh on a fake process group (this process is rank 0; the
collectives move nothing), and run the cell's programs eagerly on rank 0's
local shards as meta DTensors (no allocation, no data): the train micro
step (forward + backward + accumulate, run n_micro times a step) and the
optimizer apply step, or prefill, or one decode step. ``Accounting``
(launch/hlo_tools.py) records what rank 0 runs:

  flops        every matmul at its local shapes (``torch.utils.flop_counter``
               formulas). Eager PyTorch runs each chunk of the chunked
               attention and SSD loops, so the JAX dry-run's scan
               corrections (``CellModel.corrections_dev``) are recorded
               beside the count, not added.
  bytes        each op's inputs read and outputs written (views move
               nothing): an eager program's device-memory traffic, unfused.
  collectives  each functional collective's bytes and group, priced with
               the ring model of the JAX dry-run: within the "model" dim
               on NVLink, across "data" and "pod" on InfiniBand (the JSON's
               ``ici_wire_bytes`` and ``dcn_wire_bytes`` keys).
  memory       the peak bytes of live op results (the JSON's
               ``peak_temp_bytes``; inputs excluded, as XLA's temp size).

Kernel paths are off (``use_pallas=False``): a hand-written kernel runs on
the card only, and the training path is the plain one. The output has the
JAX dry-run's keys and goes to ``experiments/dryrun_torch/`` under the
current directory (not ``experiments/dryrun/``, which the JAX package's
tests read), or to ``--out-dir``.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k [--multi-pod]
  python -m repro_torch.launch.dryrun --all --both-meshes   # every live cell
  python -m repro_torch.launch.dryrun --cells qwen3-1.7b:train_4k,mamba2-370m:long_500k
  ... --device cpu      (the meshes' device type; default cuda)
  ... --set seq_shard_attn=true --tag variant_seqshard
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback

import torch

from repro_torch.configs.base import SHAPES, applicable_shapes
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.dist import sharding as shd
from repro_torch.launch import mesh as meshlib
from repro_torch.launch.analytic import CellModel
from repro_torch.launch.hlo_tools import Accounting
from repro_torch.models import model as M
from repro_torch.models import params as prm
from repro_torch.models.params import check_device
from repro_torch.optim import AdamW

OUT_DIR = os.path.join("experiments", "dryrun_torch")
MICRO_TOKENS_PER_DEV = 4096   # microbatch sizing target (activation memory)


def wire_bytes(op: str, out_bytes: float, group_size: int) -> float:
    """Per-device bytes on the wire, ring model: an all-gather moves the
    result x (G-1)/G, a reduce-scatter its (small) result x (G-1), an
    all-reduce twice the all-gather's, an all-to-all the all-gather's, a
    broadcast the result."""
    g = max(group_size, 1)
    if op == "all-gather" or op == "all-to-all":
        return out_bytes * (g - 1) / g
    if op == "reduce-scatter":
        return out_bytes * (g - 1)
    if op == "all-reduce":
        return 2 * out_bytes * (g - 1) / g
    return out_bytes


def price_collectives(records, nvlink_groups) -> dict:
    """Collectives' wire bytes: ``ici_wire_bytes`` for those whose group is
    in ``nvlink_groups`` (the "model" dim's, within one NVLink domain),
    ``dcn_wire_bytes`` for the rest (InfiniBand), and per op its count and
    wire bytes."""
    nv = ib = 0.0
    by_op: dict = {}
    for r in records:
        w = wire_bytes(r["op"], r["bytes"], r["group_size"])
        if r["group"] in nvlink_groups:
            nv += w
        else:
            ib += w
        d = by_op.setdefault(r["op"], {"count": 0, "wire_bytes": 0.0})
        d["count"] += 1
        d["wire_bytes"] += w
    return {"num_collectives": len(records), "ici_wire_bytes": nv,
            "dcn_wire_bytes": ib, "by_op": by_op}


# ---------------------------------------------------------------------------
# per-cell execution defaults (the baseline; --set overrides for hillclimbs)
# ---------------------------------------------------------------------------
def cell_defaults(cfg, shape):
    """The JAX dry-run's per-kind defaults with the kernel paths off.
    ``scan_layers`` has no meaning in eager PyTorch. ``attn_chunk_unroll``
    changes nothing in the port's run (its q chunks are a Python loop, one
    chunk live at a time, as in the JAX package's scan); it is set as the
    JAX dry-run sets it, so that ``CellModel`` counts the chunked
    attention's K/V reloads in its HBM bytes and records the scan
    correction, as for the JAX package's cells."""
    kw = {"use_pallas": False}
    if shape.kind == "train":
        kw["remat"] = cfg.remat if cfg.remat != "none" else "full"
        kw["attn_chunk_q"] = cfg.attn_chunk_q or 512
        kw["attn_chunk_unroll"] = False
        if cfg.vocab_size % 16 != 0 and cfg.vocab_size > 10_000:
            kw["ce_chunk"] = cfg.ce_chunk or 512
    elif shape.kind == "prefill":
        kw["attn_chunk_q"] = cfg.attn_chunk_q or 256
        kw["attn_chunk_unroll"] = False
    return cfg.replace(**kw)


def micro_batch_plan(shape, mesh, micro_tokens=None):
    """(micro_global_batch, n_micro) for train cells."""
    ms = shd.mesh_shape(mesh)
    batch_shards = ms.get("data", 1) * ms.get("pod", 1)
    per_dev = max(1, (micro_tokens or MICRO_TOKENS_PER_DEV) // shape.seq_len)
    micro = min(shape.global_batch, per_dev * batch_shards)
    n_micro = max(1, shape.global_batch // micro)
    return micro, n_micro


def apply_overrides(cfg, sets):
    for kv in sets or []:
        k, v = kv.split("=", 1)
        cur = getattr(cfg, k)
        if isinstance(cur, bool):
            v = v.lower() in ("1", "true", "yes")
        elif isinstance(cur, int):
            v = int(v)
        elif isinstance(cur, float):
            v = float(v)
        elif isinstance(cur, tuple):
            v = tuple(v.split(","))
        cfg = cfg.replace(**{k: v})
    return cfg


# ---------------------------------------------------------------------------
# cell runner
# ---------------------------------------------------------------------------
def _measure(fn) -> dict:
    """Run ``fn`` under ``Accounting``: its FLOPs, bytes moved, collective
    records and peak of live results, on this rank."""
    acc = Accounting(memory=True)
    with acc:
        fn()
    return {"flops": sum(acc.flops.values()), "bytes": acc.bytes,
            "collectives": acc.collectives, "temp": acc.peak_bytes}


def _model_program(cfg, shape, mesh, rules, micro_global) -> dict:
    """The model-bearing program (micro grad step / prefill / decode) at
    cfg's full depth."""
    pdefs = M.param_defs(cfg)
    params = prm.abstract_params(pdefs, getattr(torch, cfg.param_dtype), rules, mesh)
    if shape.kind == "train":
        mshape = shape.__class__(shape.name, shape.seq_len, micro_global, "train")
        batch = prm.abstract_params(M.batch_defs(cfg, mshape), None, rules, mesh)
        gacc = prm.abstract_params(M.grad_acc_defs(pdefs), torch.float32, rules, mesh)
        micro_step = M.make_micro_step(cfg)

        def fn():
            with shd.use_sharding(mesh, rules):
                micro_step(params, gacc, batch)
    elif shape.kind == "prefill":
        batch = prm.abstract_params(M.batch_defs(cfg, shape), None, rules, mesh)

        def fn():
            with shd.use_sharding(mesh, rules), torch.no_grad():
                M.prefill(cfg, params, batch)
    else:
        d = M.decode_input_defs(cfg, shape)
        token = prm.abstract_params(d["token"], None, rules, mesh)
        caches = prm.abstract_params(d["caches"], None, rules, mesh)

        def fn():
            with shd.use_sharding(mesh, rules), torch.no_grad():
                M.decode_step(cfg, params, token, caches, shape.seq_len - 1)
    return _measure(fn)


def _apply_program(cfg, mesh, rules, n_micro) -> dict:
    pdefs = M.param_defs(cfg)
    opt = AdamW()
    params = prm.abstract_params(pdefs, getattr(torch, cfg.param_dtype), rules, mesh)
    sdefs = opt.state_defs(pdefs)
    state = {"m": prm.abstract_params(sdefs["m"], torch.float32, rules, mesh),
             "v": prm.abstract_params(sdefs["v"], torch.float32, rules, mesh),
             "count": torch.zeros((), dtype=torch.int32, device="meta")}
    gacc = prm.abstract_params(M.grad_acc_defs(pdefs), torch.float32, rules, mesh)
    apply_step = M.make_apply_step(cfg, opt, n_micro)

    def fn():
        with shd.use_sharding(mesh, rules):
            apply_step(params, state, gacc, 0)
    return _measure(fn)


def mesh_name(mesh) -> str:
    ms = shd.mesh_shape(mesh)
    dims = "x".join(str(v) for v in ms.values())
    return ("multipod_" if "pod" in ms else "pod_") + dims


def run_cell(arch: str, shape_name: str, multi_pod: bool = False, sets=None,
             tag: str = "", out_dir: str = OUT_DIR, verbose: bool = True,
             micro_tokens: int = 0, *, device: str = "cuda", cfg=None,
             mesh=None, shape=None):
    """One cell: ``cfg`` (else ``arch``'s config) at ``shape`` (else
    ``SHAPES[shape_name]``) on ``mesh`` (else the production mesh, on a
    fake process group this function starts)."""
    check_device(device)
    shape = shape or SHAPES[shape_name]
    cfg = apply_overrides(cell_defaults(cfg or get_config(arch), shape), sets)
    if mesh is None:
        mesh = meshlib.make_production_mesh(
            multi_pod=multi_pod, device_type=torch.device(device).type)
    ms = shd.mesh_shape(mesh)
    n_dev = math.prod(ms.values())
    rules = shd.rules_for(shape.kind, multi_pod="pod" in ms,
                          seq_shard_attn=cfg.seq_shard_attn,
                          seq_shard_resid=cfg.seq_shard_resid)
    nvlink = {mesh.get_group("model").group_name} if "model" in ms else set()
    t0 = time.time()

    if shape.kind == "train":
        micro_global, n_micro = micro_batch_plan(shape, mesh, micro_tokens or None)
    else:
        micro_global, n_micro = shape.global_batch, 1
    model_m = _model_program(cfg, shape, mesh, rules, micro_global)
    apply_m = (_apply_program(cfg, mesh, rules, n_micro)
               if shape.kind == "train" else None)
    t_run = time.time() - t0

    cm = CellModel(cfg, shape, ms, micro_global)
    coll = price_collectives(model_m["collectives"], nvlink)
    flops_dev = model_m["flops"] * n_micro
    bytes_dev = model_m["bytes"] * n_micro
    ici = coll["ici_wire_bytes"] * n_micro
    dcn = coll["dcn_wire_bytes"] * n_micro
    peak_temp = model_m["temp"]
    if apply_m:
        ac = price_collectives(apply_m["collectives"], nvlink)
        flops_dev += apply_m["flops"]
        bytes_dev += apply_m["bytes"]
        ici += ac["ici_wire_bytes"]
        dcn += ac["dcn_wire_bytes"]
        peak_temp = max(peak_temp, apply_m["temp"])

    t_compute = flops_dev / meshlib.PEAK_FLOPS_BF16
    t_memory = bytes_dev / meshlib.HBM_BW
    t_coll = ici / meshlib.NVLINK_BW + dcn / meshlib.IB_BW
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mult = 6 if shape.kind == "train" else 2
    model_flops = mult * cfg.active_param_count() * tokens
    useful = model_flops / max(flops_dev * n_dev, 1.0)
    mp = "pod" in ms
    res = {
        "arch": arch, "shape": shape.name, "mesh": mesh_name(mesh),
        "tag": tag, "overrides": list(sets or []),
        "n_devices": n_dev, "n_micro": n_micro,
        "micro_global_batch": micro_global,
        "compile_s": round(t_run, 2),
        "flops_per_dev_step": flops_dev,
        "bytes_per_dev_step": bytes_dev,
        "scan_correction_flops_dev": cm.corrections_dev(),
        "diff_estimator": None,
        "collectives": {"ici_wire_bytes": ici, "dcn_wire_bytes": dcn,
                        "by_op": coll["by_op"]},
        "peak_temp_bytes": peak_temp,
        "roofline": {
            "compute_s": t_compute, "memory_s": t_memory,
            "collective_s": t_coll,
            "bottleneck": max((("compute", t_compute), ("memory", t_memory),
                               ("collective", t_coll)), key=lambda kv: kv[1])[0],
            "step_s_lower_bound": max(t_compute, t_memory, t_coll),
        },
        "model_flops": model_flops,
        "useful_flops_ratio": useful,
        "analytic_flops_dev": cm.model_flops_analytic_dev() * n_micro,
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
    }
    os.makedirs(out_dir, exist_ok=True)
    name = (f"{arch.replace('.', '_')}__{shape.name}__{'mp' if mp else 'sp'}"
            f"{('__' + tag) if tag else ''}.json")
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(res, f, indent=1)
    if verbose:
        print(f"[dryrun] {arch} {shape.name} {'mp' if mp else 'sp'} "
              f"run={t_run:.1f}s n_micro={n_micro} "
              f"compute={t_compute * 1e3:.2f}ms memory={t_memory * 1e3:.2f}ms "
              f"collective={t_coll * 1e3:.2f}ms "
              f"bottleneck={res['roofline']['bottleneck']} "
              f"useful={useful:.2%} peak_temp={peak_temp / 2**30:.2f}GiB",
              flush=True)
    return res


def live_cells():
    for arch in ARCH_IDS:
        for shape in applicable_shapes(get_config(arch)):
            yield arch, shape.name


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--cells", default="",
                    help="comma-separated arch:shape cells")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--set", action="append", dest="sets", default=[])
    ap.add_argument("--tag", default="")
    ap.add_argument("--micro-tokens", type=int, default=0,
                    help="override microbatch tokens/device (perf lever)")
    ap.add_argument("--out-dir", default=OUT_DIR)
    ap.add_argument("--device", default="cuda",
                    help="the meshes' device type (cpu runs anywhere)")
    args = ap.parse_args(argv)

    if args.all:
        cells = list(live_cells())
    elif args.cells:
        cells = [tuple(c.split(":")) for c in args.cells.split(",")]
    else:
        cells = [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    failures = []
    t0 = time.time()
    for mp in meshes:  # one fake process group per mesh size
        for arch, shape in cells:
            try:
                run_cell(arch, shape, mp, args.sets, args.tag, args.out_dir,
                         micro_tokens=args.micro_tokens, device=args.device)
            except Exception:
                failures.append((arch, shape, mp))
                traceback.print_exc()
    if failures:
        print("FAILURES:", failures)
        sys.exit(1)
    print(f"dry-run OK: {len(cells) * len(meshes)} cells in "
          f"{time.time() - t0:.1f} s")


if __name__ == "__main__":
    main()
