"""The port's MoE layer against the JAX package's, on the same numpy inputs:
``layers.moe`` alone (output and aux loss) on the granite and moonshot smoke
configs, at the default capacity, at a capacity that drops most overflowing
choices and at one that drops none, in float32 and bf16; the routing slots
against the JAX package's loop; then both smoke models end to end (prefill
and 4 chained decode steps) with ``use_pallas`` on and off.

Float32 at atol = rtol = 1e-5 for the layer and 1e-4 for the model, as
``test_torch_model.py``: matmul summation order differs between the
frameworks. bf16 at atol = rtol = 2e-2 (the bf16 tolerance of
``tests/test_kernels.py``): the two frameworks round the SiLU's
intermediates in bf16 at other places (XLA fuses the logistic and the
product; torch rounds once), which moves an output by one bf16 ulp, 1.6e-2
at a magnitude of 2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as jlayers
from repro.configs.registry import get_config as jget_config
from repro.configs.registry import smoke_config as jax_smoke_config
from repro.models import model as JM
from repro.serving import pad_cache as jax_pad
from repro_torch.configs.registry import get_config, smoke_config
from repro_torch.dist.sharding import use_sharding
from repro_torch.models import layers
from repro_torch.models import model as M
from repro_torch.models.convert import params_from_jax
from repro_torch.models.tree import tree_leaves
from repro_torch.serving import pad_cache

ARCHS = ["granite-moe-3b-a800m", "moonshot-v1-16b-a3b"]
LAYER_TOL = dict(atol=1e-5, rtol=1e-5)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _layer_inputs(cfg, seed, B=2, T=24):
    rng = np.random.default_rng(seed)
    D, E, F_ = cfg.d_model, cfg.num_experts, cfg.d_ff
    p = {"router": rng.standard_normal((D, E), dtype=np.float32) * 0.3,
         "w_gate": rng.standard_normal((E, D, F_), dtype=np.float32) / 8,
         "w_up": rng.standard_normal((E, D, F_), dtype=np.float32) / 8,
         "w_down": rng.standard_normal((E, F_, D), dtype=np.float32) / 6}
    x = rng.standard_normal((B, T, D), dtype=np.float32)
    return p, x


def _both(arch, capacity_factor, seed, dtype="float32"):
    jcfg = jax_smoke_config(arch).replace(capacity_factor=capacity_factor)
    tcfg = smoke_config(arch).replace(capacity_factor=capacity_factor)
    p, x = _layer_inputs(tcfg, seed)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jout = jlayers.moe(jcfg, {k: jnp.asarray(v, jdt) for k, v in p.items()},
                       jnp.asarray(x, jdt))
    tp = {k: torch.from_numpy(v).to(tdt) for k, v in p.items()}
    tx = torch.from_numpy(x).to(tdt)
    return jout, layers.moe(tcfg, tp, tx), (tcfg, tp, tx)


def _drops(cfg, p, x):
    """(dropped choices, capacity) of one MoE call in the port's routing."""
    *_, pos, C = layers.moe_route(cfg, p, x.reshape(1, -1, x.shape[-1]))
    return int((pos >= C).sum()), C


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5, 8.0])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_matches_jax(arch, capacity_factor):
    """0.5 drops about half the choices: a dropped choice's zero update
    lands on slot C-1 of its expert, which holds a kept token, so an
    assignment in place of the scatter-add would zero that token's
    output. 8.0 drops none."""
    (jo, ja), (to, ta), (cfg, p, x) = _both(arch, capacity_factor, seed=3)
    dropped, C = _drops(cfg, p, x)
    if capacity_factor == 0.5:
        assert dropped > 0
    if capacity_factor == 8.0:
        assert dropped == 0 and C >= x.shape[0] * x.shape[1]
    assert to.dtype == x.dtype and tuple(to.shape) == tuple(x.shape)
    np.testing.assert_allclose(_np(to), _np(jo), **LAYER_TOL)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_bf16_matches_jax(arch, capacity_factor):
    (jo, ja), (to, ta), _ = _both(arch, capacity_factor, seed=4, dtype="bfloat16")
    assert to.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(to), _np(jo), **BF16_TOL)
    # routing runs in f32 on the same bf16 inputs: the aux loss agrees
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_route_slots_equal_jax_loop(capacity_factor):
    """The port's choice-major exclusive count gives each choice the slot
    the JAX package's per-choice loop gives it."""
    cfg = smoke_config("granite-moe-3b-a800m").replace(capacity_factor=capacity_factor)
    p, x = _layer_inputs(cfg, seed=5)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    xg = torch.from_numpy(x).reshape(1, -1, cfg.d_model)
    _, _, gate_i, pos, C = layers.moe_route(cfg, tp, xg)
    gi = gate_i.numpy()
    E, K = cfg.num_experts, cfg.top_k
    want = np.zeros_like(gi)
    base = np.zeros((1, 1, E), np.int64)
    for j in range(K):  # repro/models/layers.py's loop, in numpy
        oh = np.eye(E, dtype=np.int64)[gi[:, :, j]]
        within = np.cumsum(oh, axis=1) - oh
        want[:, :, j] = np.take_along_axis(within + base, gi[:, :, j:j + 1],
                                           axis=2)[:, :, 0]
        base = base + oh.sum(axis=1, keepdims=True)
    assert np.array_equal(pos.numpy(), want)
    assert C == max(1, int(xg.shape[1] * K / E * capacity_factor))


class _FakeMesh:
    def __init__(self, shape):
        self.shape = shape


@pytest.mark.parametrize("shape,n", [({"data": 2, "model": 2}, 48),
                                     ({"pod": 2, "data": 4, "model": 8}, 64),
                                     ({"pod": 2, "data": 4, "model": 8}, 12),
                                     ({"data": 1, "model": 4}, 48)],
                         ids=["2x2", "multipod", "multipod-indivisible", "1x4"])
def test_moe_batch_groups_equal_the_reference(shape, n):
    """The routing groups under a mesh: the reference's ``_batch_groups``
    (its "batch" axes' sizes, 1 where they do not divide the tokens)."""
    from repro.dist.sharding import use_sharding as jax_use_sharding
    from repro.dist.sharding import rules_for as jrules_for
    from repro_torch.dist.sharding import rules_for
    mp = "pod" in shape
    with use_sharding(_FakeMesh(shape), rules_for("train", multi_pod=mp)):
        got = layers._batch_groups(n)
    with jax_use_sharding(_FakeMesh(shape), jrules_for("train", multi_pod=mp)):
        want = jlayers._batch_groups(n)
    assert got == want


def test_moe_on_a_one_rank_mesh_equals_the_unmeshed_layer():
    """On a (1, 1) gloo mesh the layer runs on DTensors in one group and
    gives the unmeshed layer's output and aux loss exactly."""
    import torch.distributed as dist
    from repro_torch.dist.sharding import train_rules
    from repro_torch.launch.mesh import make_host_mesh
    cfg = smoke_config("granite-moe-3b-a800m")
    p, x = _layer_inputs(cfg, seed=6)
    p = {k: torch.from_numpy(v) for k, v in p.items()}
    want, want_aux = layers.moe(cfg, p, torch.from_numpy(x))
    started = not dist.is_initialized()
    try:
        mesh = make_host_mesh(device="cpu")
        with use_sharding(mesh, train_rules()):
            got, aux = layers.moe(cfg, p, torch.from_numpy(x))
        assert torch.equal(got.full_tensor(), want)
        assert torch.equal(torch.as_tensor(aux.full_tensor()), want_aux)
    finally:
        if started:
            dist.destroy_process_group()


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_and_defs_match_jax(arch):
    assert get_config(arch).param_count() == jget_config(arch).param_count()
    cfg = smoke_config(arch)
    defs = layers.moe_defs(cfg)
    jdefs = jlayers.moe_defs(jax_smoke_config(arch))
    assert {k: (d.shape, d.axes) for k, d in defs.items()} == {
        k: (d.shape, d.axes) for k, d in jdefs.items()}


# ---------------------------------------------------------------------------
# the whole model: prefill and 4 chained decode steps
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch, use_pallas):
    jcfg = jax_smoke_config(arch).replace(use_pallas=use_pallas)
    tcfg = smoke_config(arch).replace(use_pallas=use_pallas)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                         device="cpu")
    # the stacked experts and router arrive as the JAX package lays them out
    ffn = tp["blocks"]["cycle"]["p0"]["ffn"]
    L, E, D, F_ = tcfg.num_layers, tcfg.num_experts, tcfg.d_model, tcfg.d_ff
    assert tuple(ffn["w_gate"].shape) == (L, E, D, F_)
    assert tuple(ffn["router"].shape) == (L, D, E)
    T = 20
    toks = np.random.default_rng(0).integers(1, 200, size=(1, T)).astype(np.int32)
    jl, jc = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)})
    tl, tc = M.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
    for a, b in zip(tree_leaves(tc), jax.tree_util.tree_leaves(jc)):
        np.testing.assert_allclose(_np(a), _np(b), **MODEL_TOL)

    max_len = T + 8
    jc = jax_pad(jc, max_len, T, cfg=jcfg)
    tc = pad_cache(tc, max_len, T, cfg=tcfg)
    tok = int(np.argmax(np.asarray(jl)[0]))
    for step in range(4):
        cur = T + step
        jl, jc = JM.decode_step(jcfg, jp, jnp.asarray([[tok]], jnp.int32), jc,
                                jnp.int32(cur))
        tl, tc = M.decode_step(tcfg, tp, torch.tensor([[tok]], dtype=torch.int32),
                               tc, cur)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
        tok = int(np.argmax(np.asarray(jl)[0]))
