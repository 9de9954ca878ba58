"""The five configs the port took over last, end to end against the JAX
package: llama3.2-3b (dense, tied), gemma3-27b (5:1 local:global with its
global rope theta, qk-norm, tied), qwen3-32b, hubert-xlarge (an encoder:
``frames`` through ``in_proj``, non-causal, no decode) and llava-next-34b
(``patches`` through ``patch_proj`` in front of the tokens, and tokens
alone). Each arch's ``smoke_config`` in float32, JAX params carried across
with ``params_from_jax``, ``use_pallas`` on (the Pallas flash kernel in
interpret mode on the JAX side, the plain versions on the port's CPU
tensors) and off: prefill logits and caches, then 4 chained decode steps
where the model decodes. Every sequence is at most 128 long, so the Pallas
kernel's ``T % block_q == 0`` holds (its block_q is min(128, T)); gemma3's
prompt of 48 passes its smoke window of 32, so its local layers return ring
buffers and decode wraps them. Tolerance atol = rtol = 1e-4, as
``test_torch_model.py``: matmul summation order differs between the
frameworks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import smoke_config as jax_smoke_config
from repro.models import model as JM
from repro.serving import pad_cache as jax_pad
from repro_torch.configs.registry import smoke_config
from repro_torch.models import model as M
from repro_torch.models import transformer as tfm
from repro_torch.models.convert import caches_from_jax, params_from_jax
from repro_torch.models.tree import tree_leaves
from repro_torch.serving import pad_cache

TOL = dict(atol=1e-4, rtol=1e-4)
DECODE_STEPS = 4

CASES = {
    # id: (arch, prompt tokens, frames, patches)
    "llama3.2-3b": ("llama3.2-3b", 20, 0, False),
    "gemma3-27b": ("gemma3-27b", 48, 0, False),
    "qwen3-32b": ("qwen3-32b", 16, 0, False),
    "hubert-xlarge": ("hubert-xlarge", 0, 32, False),
    "llava-next-34b-patches": ("llava-next-34b", 16, 0, True),
    "llava-next-34b-tokens": ("llava-next-34b", 16, 0, False),
}


def _params(arch, use_pallas):
    jcfg = jax_smoke_config(arch).replace(use_pallas=use_pallas)
    tcfg = smoke_config(arch).replace(use_pallas=use_pallas)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                         device="cpu")
    return jcfg, tcfg, jp, tp


def _batch(cfg, n_tokens, n_frames, patches, seed=0):
    """The same numpy inputs for both packages: {name: (jax, torch)}."""
    rng = np.random.default_rng(seed)
    out = {}
    if n_tokens:
        toks = rng.integers(1, cfg.vocab_size, size=(1, n_tokens)).astype(np.int32)
        out["tokens"] = toks
    if n_frames:
        out["frames"] = rng.standard_normal((1, n_frames, cfg.d_model),
                                            dtype=np.float32)
    if patches:
        out["patches"] = rng.standard_normal((1, cfg.num_patches, cfg.d_model),
                                             dtype=np.float32)
    return ({k: jnp.asarray(v) for k, v in out.items()},
            {k: torch.from_numpy(v) for k, v in out.items()})


def _np_leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _t_leaves(tree):
    return [x.numpy() for x in tree_leaves(tree)]


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("case", list(CASES))
def test_prefill_and_decode_match_jax(case, use_pallas):
    arch, n_tok, n_frames, patches = CASES[case]
    jcfg, tcfg, jp, tp = _params(arch, use_pallas)
    jb, tb = _batch(tcfg, n_tok, n_frames, patches)
    jl, jc = JM.prefill(jcfg, jp, jb)
    tl, tc = M.prefill(tcfg, tp, tb)
    assert tuple(tl.shape) == (1, tcfg.vocab_size) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    leaves_t, leaves_j = _t_leaves(tc), _np_leaves(jc)
    assert len(leaves_t) == len(leaves_j)
    for a, b in zip(leaves_t, leaves_j, strict=True):
        np.testing.assert_allclose(a, b, **TOL)
    if not tcfg.supports_decode:
        assert tc == {} and jc == {}  # an encoder returns no caches
        return

    T = n_tok + (tcfg.num_patches if patches else 0)
    max_len = T + 8
    jc = jax_pad(jc, max_len, T, cfg=jcfg)
    tc = pad_cache(tc, max_len, T, cfg=tcfg)
    tok = int(np.argmax(np.asarray(jl)[0]))
    for step in range(DECODE_STEPS):
        cur = T + step
        jl, jc = JM.decode_step(jcfg, jp, jnp.asarray([[tok]], jnp.int32), jc,
                                jnp.int32(cur))
        tl, tc = M.decode_step(tcfg, tp, torch.tensor([[tok]], dtype=torch.int32),
                               tc, cur)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        tok = int(np.argmax(np.asarray(jl)[0]))
    for a, b in zip(_t_leaves(tc), _np_leaves(jc), strict=True):
        np.testing.assert_allclose(a, b, **TOL)


def test_gemma3_local_caches_are_ring_buffers():
    """gemma3's smoke prompt passes its window: every local layer's cache
    is a ring buffer of the window (cycle p0..p4 and none of the global p5),
    in both packages, and carries across with caches_from_jax."""
    jcfg, tcfg, jp, tp = _params("gemma3-27b", True)
    jb, tb = _batch(tcfg, 48, 0, False)
    _, jc = JM.prefill(jcfg, jp, jb)
    _, tc = M.prefill(tcfg, tp, tb)
    W = tcfg.local_window
    assert W == 32
    for j, kind in enumerate(tcfg.block_pattern):
        want = W if kind == "local" else 48
        for leaf in tc["cycle"][f"p{j}"]:
            assert leaf.shape[2] == want, (j, kind, tuple(leaf.shape))
    carried = caches_from_jax(jax.tree_util.tree_map(np.asarray, jc), tcfg,
                              device="cpu")
    for a, b in zip(_t_leaves(carried), _t_leaves(tc), strict=True):
        np.testing.assert_allclose(a, b, **TOL)


@pytest.mark.parametrize("arch,leaves", [
    ("hubert-xlarge", {"in_proj", "head"}),
    ("llava-next-34b", {"embed", "patch_proj", "head"}),
    ("llama3.2-3b", {"embed"}),
])
def test_input_and_head_leaves_carry_across(arch, leaves):
    """params_from_jax carries the input projections and heads the config
    declares, unchanged."""
    _, tcfg, jp, tp = _params(arch, True)
    top = {k for k in tp if k not in ("blocks", "final_norm")}
    assert top == leaves
    for k in leaves:
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))


def test_patches_lead_the_sequence():
    """With patches the sequence is [patches @ patch_proj, embed[tokens]];
    without them, the tokens alone."""
    cfg = smoke_config("llava-next-34b")
    p = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    _, tb = _batch(cfg, 5, 0, True)
    x = tfm.embed_inputs(cfg, p, tb)
    P = cfg.num_patches
    assert tuple(x.shape) == (1, P + 5, cfg.d_model)
    torch.testing.assert_close(x[:, :P], tb["patches"] @ p["patch_proj"])
    torch.testing.assert_close(x[:, P:], p["embed"][tb["tokens"].long()])
    x_tok = tfm.embed_inputs(cfg, p, {"tokens": tb["tokens"]})
    torch.testing.assert_close(x_tok, x[:, P:])


def test_unknown_input_kind_raises():
    cfg = smoke_config("qwen3-1.7b")
    p = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(NotImplementedError, match="input_kind"):
        tfm.embed_inputs(cfg.replace(input_kind="pixels"), p,
                         {"tokens": torch.ones((1, 4), dtype=torch.int32)})
