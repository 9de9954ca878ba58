"""The kernel path with the residual adds and mamba2's gate taken into the
norms (``transformer.block_deferred``, ``add_rmsnorm``, ``gated_rmsnorm``)
against the composition it replaced: every block adding its own output and
each norm a separate call after it. On the CPU the fused wrappers run their
plain versions, which are that composition of eager ops, so the logits and
the caches of ``prefill`` and 4 ``decode_step``s must be bitwise equal, for
all four served families at smoke size, in float32 and in bfloat16 (where
cycled and remainder layers mix bf16 and f32 operands).

The JAX package is the reference of these models in ``test_torch_model``,
``test_torch_recurrent`` and ``test_torch_moe``; this file pins the
restructure itself.
"""
import contextlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs.registry import smoke_config
from repro_torch.kernels import rmsnorm as RN
from repro_torch.models import griffin, layers, ssm
from repro_torch.models import model as M
from repro_torch.models import transformer as tfm
from repro_torch.models.tree import tree_leaves, tree_map
from repro_torch.serving import pad_cache

VARIANTS = {
    # arch, config overrides: the served pattern at smoke size, and cuts
    # that leave remainder layers (unstacked f32 norm scales)
    "qwen3": ("qwen3-1.7b", {}),
    "mamba2": ("mamba2-370m", {}),
    "mamba2_remainder": ("mamba2-370m", {"block_pattern": ("ssd", "ssd"),
                                         "num_layers": 3}),
    "recurrentgemma": ("recurrentgemma-9b", {}),
    "recurrentgemma_remainder": ("recurrentgemma-9b", {"num_layers": 8}),
    "granite": ("granite-moe-3b-a800m", {}),
}
PROMPT, DECODE, MAX_LEN = 20, 4, 28


def _old_block(cfg, kind, p, x, positions, mode, cache=None, cur_index=None,
               delta=None):
    """A block as the kernel path ran it before the adds were deferred: the
    input norm a call of its own (inside ssd_block for mamba2), then
    ``x = x + h``, the second norm, ``x = x + f``. Returns the
    ``block_deferred`` tuple with nothing pending."""
    assert delta is None

    def norm(t, w):
        return layers.rmsnorm(t, w, use_kernel=cfg.use_pallas)

    bc = layers.block_cfg_for(cfg, kind)
    if bc.kind == "attn":
        h, c = layers.attention(cfg, bc, p["mixer"], norm(x, p["norm1"]), positions,
                                mode, cache, cur_index)
    elif bc.kind == "rglru":
        h, c = griffin.rglru_block(cfg, p["mixer"], norm(x, p["norm1"]), mode, cache,
                                   cfg.use_pallas)
    else:
        h, c = ssm.ssd_block(cfg, p["mixer"], x, mode, cache, cfg.use_pallas)
    x = x + h
    aux = 0.0
    if "ffn" in p:
        f, aux = layers.ffn(cfg, p["ffn"], norm(x, p["norm2"]))
        x = x + f
    return x, None, c, aux


def _old_gated(y, z, w, eps=1e-6, use_kernel=False):
    return layers.rmsnorm(y * F.silu(z), w, eps, use_kernel=use_kernel)


@contextlib.contextmanager
def _unfused():
    """The model as it was: blocks add their own outputs, mamba2's gate is
    an eager multiply before a norm call."""
    saved = (tfm.block_deferred, ssm.gated_rmsnorm)
    tfm.block_deferred, ssm.gated_rmsnorm = _old_block, _old_gated
    try:
        yield
    finally:
        tfm.block_deferred, ssm.gated_rmsnorm = saved


def _serve(cfg, params, prompt):
    """Logits of a prefill and DECODE greedy decode steps, and the caches."""
    tokens = torch.from_numpy(prompt)
    logits, caches = M.prefill(cfg, params, {"tokens": tokens})
    caches = pad_cache(caches, MAX_LEN, prompt.shape[1], cfg=cfg)
    out = [logits]
    for i in range(DECODE):
        tok = torch.argmax(out[-1], dim=-1, keepdim=True).to(torch.int32)
        logits, caches = M.decode_step(cfg, params, tok, caches, prompt.shape[1] + i)
        out.append(logits)
    return out, caches


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_kernel_path_is_bitwise_the_unfused_composition(variant, dtype):
    arch, over = VARIANTS[variant]
    cfg = smoke_config(arch).replace(use_pallas=True, compute_dtype=dtype, **over)
    params = tfm.cast_params(cfg, M.init_params(cfg, torch.Generator().manual_seed(0),
                                                device="cpu"))
    prompt = np.random.default_rng(1).integers(1, cfg.vocab_size,
                                               size=(1, PROMPT)).astype(np.int32)
    before = RN.rmsnorm.launches
    got, got_caches = _serve(cfg, params, prompt)
    with _unfused():
        want, want_caches = _serve(cfg, params, prompt)
    assert RN.rmsnorm.launches == before  # CPU tensors: plain versions, no launch
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert all(torch.isfinite(g).all() for g in got)
    for g, w in zip(tree_leaves(got_caches), tree_leaves(want_caches)):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_kernel_path_takes_the_fused_entry_points():
    """On the kernel path every norm after a residual add goes through
    add_rmsnorm and mamba2's norm_y through gated_rmsnorm, one call each:
    the calls a pass makes are the norms the pass has (the first block's
    input norm has no add before it)."""
    counts = {}
    names = ("rmsnorm_kernel", "add_rmsnorm_kernel", "gated_rmsnorm_kernel")
    saved = {n: getattr(layers, n) for n in names}

    def counting(n):
        def call(*a, **k):
            counts[n] = counts.get(n, 0) + 1
            return saved[n](*a, **k)
        return call
    try:
        for n in names:
            setattr(layers, n, counting(n))
        for arch in ("qwen3-1.7b", "mamba2-370m", "recurrentgemma-9b",
                     "granite-moe-3b-a800m"):
            counts.clear()
            cfg = smoke_config(arch).replace(use_pallas=True)
            params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
            M.prefill(cfg, params, {"tokens": torch.ones((1, 8), dtype=torch.int32)})
            kinds = cfg.layer_kinds()
            attn = sum(k in ("global", "local") for k in kinds)
            adds = len(kinds) * (1 + bool(cfg.d_ff))  # each block's adds: all pending
            assert counts.get("add_rmsnorm_kernel", 0) == adds, arch
            assert counts.get("gated_rmsnorm_kernel", 0) == kinds.count("ssd"), arch
            want = 1 + 2 * attn * bool(cfg.qk_norm)
            assert counts.get("rmsnorm_kernel", 0) == want, arch
    finally:
        for n, fn in saved.items():
            setattr(layers, n, fn)


def test_apply_block_returns_the_added_output():
    """``apply_block`` (the block as the reference's API has it) is
    ``block_deferred`` with its pending add made."""
    cfg = smoke_config("qwen3-1.7b").replace(use_pallas=True)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    p0 = tree_map(lambda a: a[0], params["blocks"]["cycle"])["p0"]
    x = torch.randn(1, 6, cfg.d_model, generator=torch.Generator().manual_seed(2))
    pos = torch.arange(6, dtype=torch.int32)
    y, _, _ = tfm.apply_block(cfg, "global", p0, x, pos, "prefill")
    xd, delta, _, _ = tfm.block_deferred(cfg, "global", p0, x, pos, "prefill")
    assert torch.equal(y, xd + delta)
