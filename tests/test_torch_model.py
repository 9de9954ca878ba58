"""The port's model (prefill, decode_step, caches) against the JAX package on
the same parameters: JAX params carried across with ``params_from_jax``.

smoke_config("qwen3-1.7b") in float32; ``use_pallas=True`` runs the Pallas
kernel in interpret mode on the JAX side and the plain version on the
port's side (CPU tensors). Tolerance atol/rtol 1e-4: matmul summation order
differs between the frameworks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import smoke_config as jax_smoke_config
from repro.models import model as JM
from repro_torch.configs.registry import smoke_config
from repro_torch.models import model as M
from repro_torch.models.convert import caches_from_jax, params_from_jax
from repro_torch.models.params import ParamDef
from repro_torch.models.transformer import cast_params
from repro_torch.models.tree import tree_leaves, tree_map_with_path

TOL = dict(atol=1e-4, rtol=1e-4)

VARIANTS = {
    # (block pattern, local_window, prompt length)
    "global": (None, None, 16),
    "local_global": (("local", "global"), 8, 20),
}


def _cfgs(variant, use_pallas=True):
    pattern, window, _ = VARIANTS[variant]
    jcfg = jax_smoke_config("qwen3-1.7b").replace(use_pallas=use_pallas)
    tcfg = smoke_config("qwen3-1.7b").replace(use_pallas=use_pallas)
    if pattern is not None:
        jcfg = jcfg.replace(block_pattern=pattern, local_window=window)
        tcfg = tcfg.replace(block_pattern=pattern, local_window=window)
    return jcfg, tcfg


def _params(jcfg, tcfg):
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                         device="cpu")
    return jp, tp


def _prompt(n, seed=0):
    return np.random.default_rng(seed).integers(1, 200, size=(1, n)).astype(np.int32)


def _np_leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _t_leaves(tree):
    return [x.numpy() for x in tree_leaves(tree)]


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_prefill_and_decode_match_jax(variant, use_pallas):
    """Prefill logits and caches, then 4 chained decode steps (ring buffers
    included for the local/global pattern)."""
    jcfg, tcfg = _cfgs(variant, use_pallas)
    jp, tp = _params(jcfg, tcfg)
    T = VARIANTS[variant][2]
    toks = _prompt(T)
    jl, jc = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)})
    tl, tc = M.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for a, b in zip(_t_leaves(tc), _np_leaves(jc), strict=True):
        np.testing.assert_allclose(a, b, **TOL)

    from repro.serving import pad_cache as jax_pad
    from repro_torch.serving import pad_cache
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
    for a, b in zip(_t_leaves(tc), _np_leaves(jc), strict=True):
        np.testing.assert_allclose(a, b, **TOL)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_jax_cache_feeds_port_decode(variant):
    """A JAX prefill cache, carried across with caches_from_jax, gives JAX's
    decode logits in the port's decode_step."""
    jcfg, tcfg = _cfgs(variant)
    jp, tp = _params(jcfg, tcfg)
    T = VARIANTS[variant][2]
    from repro.serving import pad_cache as jax_pad
    jl, jc = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(_prompt(T, seed=3))})
    jc = jax_pad(jc, T + 4, T, cfg=jcfg)
    tc = caches_from_jax(jax.tree_util.tree_map(np.asarray, jc), tcfg, device="cpu")
    tok = int(np.argmax(np.asarray(jl)[0]))
    jl2, _ = JM.decode_step(jcfg, jp, jnp.asarray([[tok]], jnp.int32), jc,
                            jnp.int32(T))
    tl2, _ = M.decode_step(tcfg, tp, torch.tensor([[tok]], dtype=torch.int32),
                           tc, T)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), **TOL)


def test_init_params_distributions():
    """Zeros exact; normal leaves have std within 5% of their fan-in scale
    (the JAX package's init; the generators themselves differ)."""
    cfg = smoke_config("qwen3-1.7b").replace(d_model=256, d_ff=512,
                                             vocab_size=1024)
    defs = M.param_defs(cfg)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    checked = []

    def check(path, d):
        leaf = params
        for key in path.strip("[]").split("]["):
            leaf = leaf[key.strip("'")]
        assert tuple(leaf.shape) == d.shape and leaf.dtype == torch.float32
        if d.init == "zeros":
            assert torch.count_nonzero(leaf) == 0
        else:
            eff = d.shape[1:] if d.axes[0] == "layers" else d.shape
            scale = 1.0 if d.init == "embed" else eff[0] ** -0.5
            assert abs(leaf.std().item() / scale - 1) < 0.05, path
            assert abs(leaf.mean().item()) < 0.05 * scale, path
        checked.append(d.init)

    tree_map_with_path(check, defs, is_leaf=lambda x: isinstance(x, ParamDef))
    assert "zeros" in checked and "embed" in checked and "normal" in checked
    # same seed, same numbers; another seed, other numbers
    again = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    other = M.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    assert torch.equal(again["embed"], params["embed"])
    assert not torch.equal(other["embed"], params["embed"])


def _special_bounds(init):
    """The closed range of a non-normal init (``params._draw``)."""
    def inv_softplus(dt):
        return dt + np.log(-np.expm1(-dt))

    def logit_root(r):
        a = r ** (1 / 8)
        return np.log(a / (1 - a))
    return {"dt_bias": (inv_softplus(1e-3), inv_softplus(1e-1)),
            "ssd_alog": (0.0, np.log(16.0)),
            "lru_lambda": (logit_root(0.9), logit_root(0.999))}[init]


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mamba2-370m", "recurrentgemma-9b"])
def test_init_serving_params_dtypes_and_distributions(arch):
    """Each leaf in the dtype cast_params gives init_params' leaf (bf16
    matrices and stacked vectors, float32 vectors); zeros exact; every
    layer slice of a stacked normal leaf keeps the whole leaf's fan-in
    scale (std within 5%), as test_init_params_distributions pins for
    init_params; special inits inside their ranges; both draw through the
    same path, so every leaf equals init_params' leaf, cast."""
    cfg = smoke_config(arch).replace(d_model=256, vocab_size=1024,
                                     compute_dtype="bfloat16")
    if cfg.d_ff:
        cfg = cfg.replace(d_ff=512)
    if cfg.lru_width:
        cfg = cfg.replace(lru_width=256)
    defs = M.param_defs(cfg)
    serving = M.init_serving_params(cfg, torch.Generator().manual_seed(0),
                                    device="cpu")
    cast = cast_params(cfg, M.init_params(cfg, torch.Generator().manual_seed(0),
                                          device="cpu"))
    checked = []

    def pick(tree, path):
        for key in path.strip("[]").split("]["):
            tree = tree[key.strip("'")]
        return tree

    def check(path, d):
        leaf, want = pick(serving, path), pick(cast, path)
        assert tuple(leaf.shape) == d.shape and leaf.dtype == want.dtype, path
        stacked = d.axes[0] == "layers"
        if d.init in ("zeros", "ones"):
            assert torch.equal(leaf, torch.full_like(leaf, d.init == "ones"))
        elif d.init in ("dt_bias", "ssd_alog", "lru_lambda"):
            lo, hi = _special_bounds(d.init)
            f = leaf.float()
            pad = 0.01 * max(abs(lo), abs(hi))  # a bf16 rounding
            assert f.min().item() >= lo - pad and f.max().item() <= hi + pad, path
        else:
            eff = d.shape[1:] if stacked else d.shape
            scale = 1.0 if d.init == "embed" else eff[0] ** -0.5
            for part in (leaf if stacked else [leaf]):
                part = part.float()
                if part.numel() < 4096:  # too few draws for a 5% bar
                    continue
                assert abs(part.std().item() / scale - 1) < 0.05, path
                assert abs(part.mean().item()) < 0.05 * scale, path
        assert torch.equal(leaf, want), path
        if stacked and d.init not in ("zeros", "ones") and d.shape[0] > 1:
            assert not torch.equal(leaf[0], leaf[1]), path  # a draw a slice
        checked.append((d.init, stacked))

    tree_map_with_path(check, defs, is_leaf=lambda x: isinstance(x, ParamDef))
    assert ("normal", True) in checked and ("embed", False) in checked
    again = M.init_serving_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(again),
                                                 tree_leaves(serving)))


def test_param_count_matches_jax():
    for name in ("qwen3-1.7b",):
        from repro.configs.registry import get_config as jget
        from repro_torch.configs.registry import get_config
        assert get_config(name).param_count() == jget(name).param_count()


def test_entry_points_refuse_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = smoke_config("qwen3-1.7b")
    with pytest.raises(RuntimeError, match="CUDA"):
        M.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        M.init_serving_params(cfg, torch.Generator().manual_seed(0))
