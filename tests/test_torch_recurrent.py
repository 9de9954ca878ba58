"""The recurrent families on the port against the JAX package, on the same
parameters (carried across with ``params_from_jax``): the ssd and rglru
blocks alone, then smoke mamba2-370m and recurrentgemma-9b end to end
(prefill and 4 chained decode steps), with ``use_pallas`` on (the port's
kernel wrappers run their plain versions on CPU tensors; the JAX package's
Pallas kernels run in interpret mode) and off.

Float32 at atol = rtol = 1e-4, as ``test_torch_model.py``: matmul
summation order differs between the frameworks. The bf16 variant checks
dtypes only: each framework rounds bf16 at other places.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.griffin as jgriffin
import repro.models.ssm as jssm
import repro.models.transformer as jtfm
from repro.configs.registry import smoke_config as jax_smoke_config
from repro.models import model as JM
from repro.serving import pad_cache as jax_pad
from repro_torch.configs.registry import smoke_config
from repro_torch.kernels import rglru_scan as RG
from repro_torch.kernels import ssd_scan as SS
from repro_torch.models import griffin, ssm
from repro_torch.models import model as M
from repro_torch.models import transformer as tfm
from repro_torch.models.convert import caches_from_jax, params_from_jax
from repro_torch.models.tree import tree_leaves, tree_map
from repro_torch.serving import pad_cache

TOL = dict(atol=1e-4, rtol=1e-4)

VARIANTS = {
    # arch, config overrides, prompt length
    "mamba2": ("mamba2-370m", {}, 20),        # 20 = 16 + 4: zero-dt padding
    "mamba2_chunk": ("mamba2-370m", {}, 32),  # two full chunks
    "rgemma": ("recurrentgemma-9b", {}, 20),
    # 8 = 2 cycles of (rglru, rglru, local) + 2 remainder rglru layers,
    # as the full model's 38 = 12 * 3 + 2
    "rgemma_8_layers": ("recurrentgemma-9b", {"num_layers": 8}, 20),
    # past the smoke window of 32: ring buffers; decode writes positions
    # 62..65 into ring slots 30, 31, 0, 1
    "rgemma_past_window": ("recurrentgemma-9b", {"num_layers": 8}, 62),
}


def _cfgs(arch, over, use_pallas=True, dtype=None):
    jcfg = jax_smoke_config(arch).replace(use_pallas=use_pallas, **over)
    tcfg = smoke_config(arch).replace(use_pallas=use_pallas, **over)
    if dtype:
        jcfg = jcfg.replace(compute_dtype=dtype)
        tcfg = tcfg.replace(compute_dtype=dtype)
    return jcfg, tcfg


def _params(jcfg, tcfg, seed=0):
    jp = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                         device="cpu")
    return jp, tp


def _prompt(n, seed=0):
    return np.random.default_rng(seed).integers(1, 200, size=(1, n)).astype(np.int32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close_trees(t_tree, j_tree):
    tl, jl = tree_leaves(t_tree), jax.tree_util.tree_leaves(j_tree)
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        assert tuple(a.shape) == tuple(np.shape(b))
        np.testing.assert_allclose(_np(a), _np(b), **TOL)


# ---------------------------------------------------------------------------
# one block
# ---------------------------------------------------------------------------
def _block_params(jp, tp, kind_key):
    """Layer 0 of a cycled block's stacked params, in both packages."""
    jb = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"]["cycle"][kind_key])
    tb = tree_map(lambda a: a[0], tp["blocks"]["cycle"][kind_key])
    return jb["mixer"], tb["mixer"]


@pytest.mark.parametrize("family", ["ssd", "rglru"])
@pytest.mark.parametrize("use_pallas", [True, False])
def test_block_prefill_then_decode_match_jax(family, use_pallas):
    arch = "mamba2-370m" if family == "ssd" else "recurrentgemma-9b"
    jcfg, tcfg = _cfgs(arch, {}, use_pallas)
    jp, tp = _params(jcfg, tcfg, seed=1)
    jmix, tmix = _block_params(jp, tp, "p0")
    jblock, tblock = ((jssm.ssd_block, ssm.ssd_block) if family == "ssd"
                      else (jgriffin.rglru_block, griffin.rglru_block))
    x = np.random.default_rng(2).standard_normal((2, 20, 64)).astype(np.float32)
    jo, jc = jblock(jcfg, jmix, jnp.asarray(x), "prefill", None, use_pallas)
    to, tc = tblock(tcfg, tmix, torch.from_numpy(x), "prefill", None, use_pallas)
    np.testing.assert_allclose(_np(to), _np(jo), **TOL)
    _close_trees(tc, jc)
    for step in range(3):
        xt = np.random.default_rng(10 + step).standard_normal((2, 1, 64)).astype(
            np.float32)
        jo, jc = jblock(jcfg, jmix, jnp.asarray(xt), "decode", jc, use_pallas)
        before = {k: v for k, v in tc.items()}
        to, tc = tblock(tcfg, tmix, torch.from_numpy(xt), "decode", tc, use_pallas)
        np.testing.assert_allclose(_np(to), _np(jo), **TOL)
        _close_trees(tc, jc)
        # the new state lands in the cache tensors that were passed in
        assert all(tc[k] is before[k] for k in before)


# ---------------------------------------------------------------------------
# the whole model: prefill and 4 chained decode steps
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_prefill_and_decode_match_jax(variant, use_pallas):
    arch, over, T = VARIANTS[variant]
    jcfg, tcfg = _cfgs(arch, over, use_pallas)
    jp, tp = _params(jcfg, tcfg)
    toks = _prompt(T)
    jl, jc = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)})
    tl, tc = M.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _close_trees(tc, jc)

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
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        tok = int(np.argmax(np.asarray(jl)[0]))
    _close_trees(tc, jc)


def test_past_window_caches_are_ring_buffers():
    """The window binds: the local layers' caches hold the last 32
    positions, rolled so slot i holds the position p with p % 32 == i."""
    arch, over, T = VARIANTS["rgemma_past_window"]
    _, tcfg = _cfgs(arch, over)
    _, tc = M.prefill(tcfg, M.init_params(tcfg, torch.Generator().manual_seed(0),
                                          device="cpu"),
                      {"tokens": torch.from_numpy(_prompt(T))})
    k, v = tc["cycle"]["p2"]
    assert k.shape[2] == v.shape[2] == tcfg.local_window < T


@pytest.mark.parametrize("variant", ["mamba2", "rgemma_8_layers", "rgemma_past_window"])
def test_jax_cache_feeds_port_decode(variant):
    """A JAX prefill cache of each family, carried across with
    caches_from_jax, gives JAX's decode logits in the port's decode_step."""
    arch, over, T = VARIANTS[variant]
    jcfg, tcfg = _cfgs(arch, over)
    jp, tp = _params(jcfg, tcfg)
    jl, jc = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(_prompt(T, seed=3))})
    jc = jax_pad(jc, T + 4, T, cfg=jcfg)
    tc = caches_from_jax(jax.tree_util.tree_map(np.asarray, jc), tcfg, device="cpu")
    _close_trees(tc, jc)
    tok = int(np.argmax(np.asarray(jl)[0]))
    for step in range(2):
        jl, jc = JM.decode_step(jcfg, jp, jnp.asarray([[tok]], jnp.int32), jc,
                                jnp.int32(T + step))
        tl, tc = M.decode_step(tcfg, tp, torch.tensor([[tok]], dtype=torch.int32),
                               tc, T + step)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        tok = int(np.argmax(np.asarray(jl)[0]))


def test_caches_from_jax_reads_sizes_from_the_axes():
    """Batch 3 and capacity 24 on a recurrentgemma cache whose local layers
    hold 24 slots (prompt within the window) and whose recurrent leaves have
    no sequence axis; a cache of another layout is refused."""
    jcfg, tcfg = _cfgs("recurrentgemma-9b", {"num_layers": 8})
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    toks = np.random.default_rng(5).integers(1, 200, size=(3, 20)).astype(np.int32)
    _, jc = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)})
    jc = jax.tree_util.tree_map(np.asarray, jax_pad(jc, 24, 20, cfg=jcfg))
    tc = caches_from_jax(jc, tcfg, device="cpu")
    assert tc["cycle"]["p2"][0].shape == (2, 3, 24, 1, 16)
    assert tc["cycle"]["p0"]["h"].shape == (2, 3, 64)
    assert tc["rem1"]["conv"].shape == (3, tcfg.conv_width - 1, 64)
    _, mcfg = _cfgs("mamba2-370m", {})
    with pytest.raises(ValueError, match="layout"):
        caches_from_jax(jc, mcfg, device="cpu")


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "recurrentgemma-9b"])
def test_caches_from_jax_refuses_a_mismatched_capacity(arch):
    """An attention cache (global for qwen3, local for recurrentgemma) whose
    v holds fewer slots than its k, neither S nor the ring buffer's
    min(window, S), is refused."""
    jcfg, tcfg = _cfgs(arch, {})
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    toks = np.random.default_rng(6).integers(1, 200, size=(1, 20)).astype(np.int32)
    _, jc = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)})
    jc = jax.tree_util.tree_map(np.asarray, jax_pad(jc, 24, 20, cfg=jcfg))
    caches_from_jax(jc, tcfg, device="cpu")
    pos = "p2" if arch == "recurrentgemma-9b" else "p0"
    k, v = jc["cycle"][pos]
    assert k.shape[2] == 24
    jc["cycle"][pos] = (k, v[:, :, :20])
    with pytest.raises(ValueError, match="cache shape"):
        caches_from_jax(jc, tcfg, device="cpu")


@pytest.mark.parametrize("arch", ["mamba2-370m", "recurrentgemma-9b"])
def test_param_count_matches_jax(arch):
    from repro.configs.registry import get_config as jget
    from repro_torch.configs.registry import get_config
    assert get_config(arch).param_count() == jget(arch).param_count()


# ---------------------------------------------------------------------------
# bf16: the dtype of every block output and cache leaf
# ---------------------------------------------------------------------------
def _layers(cfg, params, jax_side):
    """(kind, params, cache key path) of every layer, in order."""
    pattern = cfg.block_pattern
    n_cyc = cfg.num_layers // len(pattern)
    take = ((lambda t, i: jax.tree_util.tree_map(lambda a: a[i], t)) if jax_side
            else (lambda t, i: tree_map(lambda a: a[i], t)))
    out = []
    for i in range(n_cyc):
        for j, kind in enumerate(pattern):
            out.append((kind, take(params["blocks"]["cycle"][f"p{j}"], i),
                        ("cycle", f"p{j}", i)))
    for i, kind in enumerate(cfg.layer_kinds()[n_cyc * len(pattern):]):
        out.append((kind, params["blocks"][f"rem{i}"], (f"rem{i}",)))
    return out


def _cache_at(caches, path, jax_side):
    c = caches[path[0]]
    if len(path) == 1:
        return c
    c = c[path[1]]
    if jax_side:
        return jax.tree_util.tree_map(lambda a: a[path[2]], c)
    return tree_map(lambda a: a[path[2]], c)


def _dtype_name(x):
    return str(x.dtype).replace("torch.", "")


@pytest.mark.parametrize("variant", ["mamba2_remainder", "rgemma_8_layers"])
def test_bf16_block_output_and_cache_dtypes_match_jax(variant):
    """Serving dtypes: cast_params casts stacked (cycled) vectors to bf16
    and keeps the remainder layers' in f32; mixed operands promote to f32
    as in JAX. Every block's output and every cache leaf, in prefill and in
    one decode step, has the reference's dtype."""
    if variant == "mamba2_remainder":  # 3 = one (ssd, ssd) cycle + 1 remainder
        arch, over = "mamba2-370m", {"block_pattern": ("ssd", "ssd"), "num_layers": 3}
    else:
        arch, over = "recurrentgemma-9b", {"num_layers": 8}
    jcfg, tcfg = _cfgs(arch, over, dtype="bfloat16")
    jp, tp = _params(jcfg, tcfg)
    jp, tp = jtfm.cast_params(jcfg, jp), tfm.cast_params(tcfg, tp)
    toks = _prompt(20)
    jx = jtfm.embed_inputs(jcfg, jp, {"tokens": jnp.asarray(toks)})
    tx = tfm.embed_inputs(tcfg, tp, {"tokens": torch.from_numpy(toks)})
    pos_j, pos_t = jnp.arange(20), torch.arange(20, dtype=torch.int32)
    seen = set()
    for (kind, jb, _), (_, tb, _) in zip(_layers(jcfg, jp, True),
                                         _layers(tcfg, tp, False)):
        jx, jc, _ = jtfm.apply_block(jcfg, kind, jb, jx, pos_j, "prefill")
        tx, tc, _ = tfm.apply_block(tcfg, kind, tb, tx, pos_t, "prefill")
        assert _dtype_name(tx) == _dtype_name(jx), kind
        assert [_dtype_name(a) for a in tree_leaves(tc)] == [
            _dtype_name(a) for a in jax.tree_util.tree_leaves(jc)], kind
        seen |= {_dtype_name(tx)} | {_dtype_name(a) for a in tree_leaves(tc)}
    assert {"bfloat16", "float32"} <= seen

    # one decode step, layer by layer, from each package's own prefill
    _, jcs = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)})
    _, tcs = M.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks)})
    jcs, tcs = jax_pad(jcs, 24, 20, cfg=jcfg), pad_cache(tcs, 24, 20, cfg=tcfg)
    jx = jtfm.embed_inputs(jcfg, jp, {"tokens": jnp.asarray([[5]], jnp.int32)})
    tx = tfm.embed_inputs(tcfg, tp, {"tokens": torch.tensor([[5]], dtype=torch.int32)})
    for (kind, jb, path), (_, tb, _) in zip(_layers(jcfg, jp, True),
                                            _layers(tcfg, tp, False)):
        jx, jc, _ = jtfm.apply_block(jcfg, kind, jb, jx, jnp.full((1,), 20), "decode",
                                     _cache_at(jcs, path, True), jnp.int32(20))
        tx, tc, _ = tfm.apply_block(tcfg, kind, tb, tx,
                                    torch.full((1,), 20, dtype=torch.int32), "decode",
                                    _cache_at(tcs, path, False), 20)
        assert _dtype_name(tx) == _dtype_name(jx), kind
        assert [_dtype_name(a) for a in tree_leaves(tc)] == [
            _dtype_name(a) for a in jax.tree_util.tree_leaves(jc)], kind
        assert all(bool(torch.isfinite(a.float()).all()) for a in tree_leaves(tc))


# ---------------------------------------------------------------------------
# the kernel wrappers
# ---------------------------------------------------------------------------
def _ssd_args(device="cpu"):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, 32, 2, 16, generator=g)
    dt = torch.rand(1, 32, 2, generator=g)
    return [t.to(device) for t in (x, dt, torch.zeros(2), torch.randn(1, 32, 8),
                                   torch.randn(1, 32, 8))]


def _rglru_args(device="cpu"):
    return [t.to(device) for t in (-torch.rand(2, 9, 8), torch.randn(2, 9, 8))]


CASES = {"ssd_scan": (SS, lambda a: SS.ssd_scan(*a, 16), _ssd_args,
                      lambda a: SS._launch(*a, 16), "ssd_scan_fwd"),
         "rglru_scan": (RG, lambda a: RG.rglru_scan(*a), _rglru_args,
                        lambda a: RG._launch(*a), "rglru_scan_fwd")}


@pytest.mark.parametrize("name", list(CASES))
def test_wrapper_raises_off_cpu_and_cuda_and_counts_no_cpu_launch(name):
    mod, call, args, _, _ = CASES[name]
    fn = getattr(mod, name)
    before = fn.launches
    call(args())
    assert fn.launches == before  # the plain version is no launch
    with pytest.raises(ValueError, match="cuda or cpu"):
        call(args("meta"))
    assert fn.launches == before


class _FakeLib:
    def __init__(self, fn_name, err):
        self.calls = 0

        def fn(*a):
            self.calls += 1
            return err
        setattr(self, fn_name, fn)


@pytest.mark.parametrize("name", list(CASES))
def test_failed_build_or_launch_raises_and_never_falls_back(name, monkeypatch):
    """The kernel path (what a CUDA tensor takes) raises when the build
    fails or the launch returns a CUDA error, counts nothing, and does not
    hand back the plain version's result."""
    mod, _, args, launch, fn_name = CASES[name]
    fn = getattr(mod, name)
    before = fn.launches

    class _Stream:
        cuda_stream = 0
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: _Stream())

    def no_nvcc(*a, **k):
        raise RuntimeError("nvcc not found")
    monkeypatch.setattr(mod, "_lib", None)
    monkeypatch.setattr(mod.build, "load", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc"):
        launch(args())

    lib = _FakeLib(fn_name, 700)  # cudaErrorIllegalAddress
    monkeypatch.setattr(mod, "_lib", lib)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        launch(args())
    assert lib.calls == 1 and fn.launches == before

    ok = _FakeLib(fn_name, 0)
    monkeypatch.setattr(mod, "_lib", ok)
    launch(args())
    assert ok.calls == 1 and fn.launches == before + 1
    fn.launches = before
