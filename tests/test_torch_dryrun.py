"""The port's dry-run accounting (``repro_torch.launch``): the reference's
``tests/test_dryrun.py`` re-pointed. The ring model prices a known list of
collective records as the reference's HLO parser prices the same ops; the
FLOP attribution is exact on a tanh MLP; the eager micro step's dot FLOPs
equal the reference's unrolled count without q chunks, and exceed it by one
layer's attention forward with them (5.6%; see the test); and dry-run cells
on fake process groups (16 ranks, and the 256-GPU production mesh) write
the reference's JSON keys. The cells run in subprocesses: a fake process
group is global to its process.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import smoke_config as jsmoke
from repro.launch.dryrun import parse_collectives
from repro.launch.hlo_tools import total_dot_flops as jtotal_dot_flops
from repro.models import model as JM
from repro_torch.configs.registry import smoke_config
from repro_torch.launch.dryrun import price_collectives, wire_bytes
from repro_torch.launch.hlo_tools import (dot_flops_by_module, top_dot_flops,
                                          total_dot_flops)
from repro_torch.models import model as M
from repro_torch.models.convert import params_from_jax
from repro_torch.models.tree import tree_map

ROOT = os.path.join(os.path.dirname(__file__), "..")
# the reference's run_cell result keys
KEYS = {"arch", "shape", "mesh", "tag", "overrides", "n_devices", "n_micro",
        "micro_global_batch", "compile_s", "flops_per_dev_step",
        "bytes_per_dev_step", "scan_correction_flops_dev", "diff_estimator",
        "collectives", "peak_temp_bytes", "roofline", "model_flops",
        "useful_flops_ratio", "analytic_flops_dev", "params", "active_params"}


def test_ring_model_on_known_records():
    """The reference's parser test, as records: an all-gather and a
    reduce-scatter in the model (NVLink) group, an all-reduce across pods
    (InfiniBand); the same wire bytes as the reference's HLO parser."""
    hlo = """
  %all-gather = f32[4096,512]{1,0} all-gather(%x), replica_groups=[16,16]<=[16,16]T(1,0)
  %ar = bf16[256,64]{1,0} all-reduce(%y), replica_groups=[128,2]<=[256]
  %rs.1 = f32[16,16]{1,0} reduce-scatter(%z), replica_groups=[16,16]<=[256]
"""
    ref = parse_collectives(hlo, pod_count=2)
    records = [
        {"op": "all-gather", "bytes": 4096 * 512 * 4, "group_size": 16, "group": "m"},
        {"op": "all-reduce", "bytes": 256 * 64 * 2, "group_size": 2, "group": "pod"},
        {"op": "reduce-scatter", "bytes": 16 * 16 * 4, "group_size": 16, "group": "m"},
    ]
    got = price_collectives(records, {"m"})
    assert got["num_collectives"] == ref["num_collectives"] == 3
    assert got["ici_wire_bytes"] == pytest.approx(ref["ici_wire_bytes"])
    assert got["dcn_wire_bytes"] == pytest.approx(ref["dcn_wire_bytes"])
    for op, d in ref["by_op"].items():
        assert got["by_op"][op] == pytest.approx(d)
    assert got["ici_wire_bytes"] == pytest.approx(4096 * 512 * 4 * 15 / 16
                                                  + 16 * 16 * 4 * 15)
    assert wire_bytes("all-to-all", 64, 4) == 48
    assert wire_bytes("broadcast", 64, 4) == 64


def test_total_dot_flops_exact_on_tanh_mlp():
    def f(x, w1, w2):
        return torch.tanh(x @ w1) @ w2
    args = (torch.zeros(64, 128), torch.zeros(128, 256), torch.zeros(256, 32))
    want = 2 * 64 * 128 * 256 + 2 * 64 * 256 * 32
    assert total_dot_flops(f, *args) == want
    assert top_dot_flops(f, *args, n=1) == [("?", want)]


@pytest.mark.parametrize("chunk", [0, 64], ids=["whole", "chunked"])
def test_micro_step_dot_flops_match_reference_unrolled(chunk):
    """The eager micro step (forward, full-remat recompute, backward) at the
    reference's test shapes against the reference's unrolled HLO dot count:
    equal without q chunks (603,979,776 both). With 64-row q chunks the
    port runs every chunk (no scan correction is added) and its per-chunk
    checkpoint recomputes one layer's attention forward that XLA's count
    does not hold: exactly 4·B·H·T·S·hd more, a 5.6% gap."""
    kw = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
              remat="full", scan_layers=False, attn_chunk_q=chunk,
              attn_chunk_unroll=True)
    jcfg = jsmoke("qwen3-1.7b").replace(**kw)
    cfg = smoke_config("qwen3-1.7b").replace(**kw)
    B, T = 2, 256
    batch = {"tokens": np.zeros((B, T), np.int32), "labels": np.zeros((B, T), np.int32)}
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    g0 = jax.tree_util.tree_map(lambda p: jnp.zeros(p.shape, jnp.float32), jparams)
    c = jax.jit(JM.make_micro_step(jcfg)).lower(
        jparams, g0, {k: jnp.asarray(v) for k, v in batch.items()}).compile()
    want = jtotal_dot_flops(c.as_text())
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg, "cpu")
    gacc = tree_map(lambda p: torch.zeros(p.shape), params)
    by = dot_flops_by_module(M.make_micro_step(cfg), params, gacc,
                             {k: torch.from_numpy(v) for k, v in batch.items()})
    got = sum(by.values())
    assert got == pytest.approx(want, rel=0.06), (got, want)
    assert got - want == (4 * B * 4 * T * T * 16 if chunk else 0)
    assert {"models.layers._sdpa", "models.layers.mlp",
            "models.transformer.unembed"} <= set(by)


def _run(code, *args, timeout=300):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    p = subprocess.run([sys.executable, "-c", code, *args], env=env,
                       capture_output=True, text=True, timeout=timeout)
    assert p.returncode == 0, (p.stdout + p.stderr)[-4000:]
    return p.stdout


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
             mesh=mesh, shape=shape, micro_tokens=16)
"""


def _invariants(d, n_devices):
    r = d["roofline"]
    assert set(d) == KEYS
    assert r["bottleneck"] in ("compute", "memory", "collective")
    assert d["flops_per_dev_step"] > 0 and d["bytes_per_dev_step"] > 0
    assert r["step_s_lower_bound"] >= max(r["compute_s"], 1e-12) - 1e-12
    assert d["n_devices"] == n_devices


def test_smoke_cells_on_a_fake_16_rank_mesh(tmp_path):
    """Train (2 microbatches: 4 sequences a micro step over data = 4),
    prefill and decode on (data=4, model=4): the reference's keys, FLOPs
    and collectives counted per rank, the train cell within its analytic
    estimate's order."""
    out = _run(CELL, str(tmp_path))
    assert out.count("[dryrun]") == 3
    cells = {}
    for name in os.listdir(tmp_path):
        d = json.load(open(tmp_path / name))
        _invariants(d, 16)
        assert d["mesh"] == "pod_4x4"
        cells[d["shape"]] = d
    assert sorted(cells) == ["d", "p", "t"]
    t = cells["t"]
    assert (t["n_micro"], t["micro_global_batch"]) == (2, 4)
    assert t["collectives"]["ici_wire_bytes"] > 0
    assert t["collectives"]["dcn_wire_bytes"] > 0
    assert t["scan_correction_flops_dev"] == 0.0  # T = 64 <= the 512 chunk
    assert 0.5 < t["flops_per_dev_step"] / t["analytic_flops_dev"] < 2.0
    assert cells["d"]["collectives"]["by_op"]


def test_cli_cell_on_the_256_gpu_mesh(tmp_path):
    """``python -m repro_torch.launch.dryrun`` on the production mesh (a
    fake process group of 256 ranks, data = 32 x model = 8), one decode
    cell, on the CPU."""
    out = _run("import runpy, sys; sys.argv = ['dryrun'] + sys.argv[1:]; "
               "runpy.run_module('repro_torch.launch.dryrun', run_name='__main__')",
               "--arch", "qwen3-1.7b", "--shape", "decode_32k", "--device", "cpu",
               "--out-dir", str(tmp_path))
    assert "dry-run OK: 1 cells" in out
    d = json.load(open(tmp_path / "qwen3-1_7b__decode_32k__sp.json"))
    _invariants(d, 256)
    assert d["mesh"] == "pod_32x8"
