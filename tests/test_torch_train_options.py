"""The training options of the port's model that change how the loss is
computed but not its value, each against the port without it and against
the JAX package with it: the seq-chunked cross entropy (``ce_chunk``),
q-chunked attention (``attn_chunk_q`` at both ``attn_chunk_unroll``
values: the JAX package unrolls or scans, the port loops alike; banded K/V
slices for gemma3's local layers at window 8; these re-point
``test_models.py``'s ``test_ce_chunking_equals_full``,
``test_chunked_attention_equals_full`` and
``test_banded_local_attention_equals_masked``) and activation
checkpointing (``remat`` full and dots against none; a backward pass
recomputes what each leaves out). Smoke configs in float32, the JAX params
carried across with ``params_from_jax``.

Tolerances: a port option against the port without it rtol 1e-5 on the
loss, 1e-5 of the leaf's largest entry on the grads; against the JAX
package as ``test_torch_train_model.py`` (loss rtol 1e-5, grads 1e-4).
"""
import jax
import numpy as np
import pytest
import torch
from test_torch_train_model import (GRAD_REL, LOSS_RTOL, _cfgs, _params, assert_grads,
                                    jax_grads, make_batch, torch_grads)

from repro_torch.models import model as M
from repro_torch.models.tree import tree_leaves

SELF_REL = 1e-5      # a port option against the port without it


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the models are tiny, and the suite's workers
    share the host's cores (oversubscribed threads make steps slow and
    their walls noisy)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_grads_equal(a, b, rel=SELF_REL):
    for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=rel,
                                   atol=rel * max(float(y.abs().max()), 1e-30))


def _loss_and_grads(tcfg, tp, batch):
    (loss, _), grads = torch_grads(tcfg, tp, batch)
    return float(loss), grads


def _check_option(arch, base_kw, opt_kw, B, T, seed):
    """The port with ``opt_kw`` equals the port without it and the JAX
    package with it: loss and every grad."""
    jcfg, tcfg = _cfgs(arch, **base_kw)
    jp, tp = _params(jcfg, tcfg, seed)
    batch = make_batch(jcfg, B=B, T=T, seed=seed)
    l_plain, g_plain = _loss_and_grads(tcfg, tp, batch)
    l_opt, g_opt = _loss_and_grads(tcfg.replace(**opt_kw), tp, batch)
    np.testing.assert_allclose(l_opt, l_plain, rtol=SELF_REL)
    assert_grads_equal(g_opt, g_plain)
    (jl, _), jg = jax_grads(jcfg.replace(**opt_kw), jp, batch)
    np.testing.assert_allclose(l_opt, float(jl), rtol=LOSS_RTOL)
    assert_grads(g_opt, jg, GRAD_REL)


def test_ce_chunking_equals_full():
    _check_option("granite-moe-3b-a800m", {}, {"ce_chunk": 8}, B=2, T=32, seed=7)


@pytest.mark.parametrize("unroll", [True, False], ids=["unrolled", "looped"])
def test_chunked_attention_equals_full(unroll):
    _check_option("qwen3-1.7b", {"attn_chunk_q": 0},
                  {"attn_chunk_q": 16, "attn_chunk_unroll": unroll}, B=2, T=64, seed=4)


@pytest.mark.parametrize("unroll", [True, False], ids=["unrolled", "looped"])
def test_banded_local_attention_equals_masked(unroll):
    """gemma3's local layers at window 8: each q chunk of 16 reads a K/V band
    of 24 (S = 64 > window + chunk), the JAX package's banded slices."""
    _check_option("gemma3-27b", {"local_window": 8, "attn_chunk_q": 0},
                  {"attn_chunk_q": 16, "attn_chunk_unroll": unroll}, B=1, T=64, seed=5)


REMAT_CASES = {
    # id: (arch, config changes): a cycle of two attention kinds plus an
    # unstacked remainder layer; mamba2's ssd blocks; granite's MoE aux loss
    "qwen3-remainder": ("qwen3-1.7b", {"block_pattern": ("local", "global"),
                                       "local_window": 8, "num_layers": 3}),
    "mamba2": ("mamba2-370m", {}),
    "granite": ("granite-moe-3b-a800m", {}),
}


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("case", list(REMAT_CASES))
def test_remat_equals_none(case, remat):
    arch, kw = REMAT_CASES[case]
    _check_option(arch, dict(kw, remat="none"), {"remat": remat}, B=2, T=24, seed=6)


def test_remat_recomputes_the_cycle():
    """The backward pass of remat "full" recomputes every matmul of the
    cycles; "dots" recomputes only those with batch dims (attention's),
    keeping the rest; "none" recomputes nothing. Counted as the matmuls
    dispatched during the backward pass."""
    from torch.utils._python_dispatch import TorchDispatchMode
    mm = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
          torch.ops.aten.addmm.default}

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += func in mm
            return func(*args, **(kwargs or {}))

    jcfg, tcfg = _cfgs("qwen3-1.7b", num_layers=4)
    _, tp = _params(jcfg, tcfg)
    batch = {k: torch.from_numpy(v) for k, v in make_batch(jcfg, T=32).items()}

    def backward_matmuls(remat):
        leaves = [t.detach().requires_grad_() for t in tree_leaves(tp)]
        live = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(tp), leaves)
        loss, _ = M.forward_train(tcfg.replace(remat=remat), live, batch)
        Count.n = 0
        with Count():
            torch.autograd.grad(loss, leaves)
        return Count.n
    none, dots, full = (backward_matmuls(r) for r in ("none", "dots", "full"))
    assert none < dots < full, (none, dots, full)
