"""The training half of the port's model against the JAX package.

``forward_train`` (loss, metrics) and every gradient leaf against
``jax.value_and_grad`` for all ten ``smoke_config``s in float32, on the
same numpy-seeded batches (frames for hubert, patches in front of the
tokens for llava, labels with masked positions) and the JAX params carried
across with ``params_from_jax``. Then the kernel wrappers refuse grad:
with ``use_pallas=True`` the port raises under grad where ``jax.grad``
raises. The options that change how the loss is computed but not its
value are in ``test_torch_train_options.py``.

Tolerances: losses rtol 1e-5; gradients atol 1e-4 of the leaf's largest
reference entry plus rtol 1e-4 (matmul summation order differs between the
frameworks; the largest difference measured over the ten configs is 5e-6
of a leaf's largest entry).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCH_IDS
from repro.configs.registry import smoke_config as jax_smoke_config
from repro.models import model as JM
from repro_torch.configs.registry import smoke_config
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rglru_scan import rglru_scan
from repro_torch.kernels.rmsnorm import add_rmsnorm, gated_rmsnorm, rmsnorm
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models import model as M
from repro_torch.models.convert import params_from_jax
from repro_torch.models.tree import tree_leaves

LOSS_RTOL = 1e-5
GRAD_REL = 1e-4      # atol as a fraction of the leaf's largest entry; also rtol


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the models are tiny, and the suite's workers
    share the host's cores (oversubscribed threads make steps slow and
    their walls noisy)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, **kw):
    return jax_smoke_config(arch).replace(**kw), smoke_config(arch).replace(**kw)


def _params(jcfg, tcfg, seed=0):
    jp = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                               device="cpu")


def make_batch(cfg, B=2, T=16, seed=0):
    """numpy batch: inputs of the config's kind, labels with the first two
    positions masked (-1)."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.input_kind == "frames":
        out["frames"] = rng.standard_normal((B, T, cfg.d_model), dtype=np.float32)
    else:
        out["tokens"] = rng.integers(1, cfg.vocab_size, size=(B, T)).astype(np.int32)
        if cfg.input_kind == "tokens+patches":
            out["patches"] = rng.standard_normal((B, cfg.num_patches, cfg.d_model),
                                                 dtype=np.float32)
    labels = rng.integers(0, cfg.vocab_size, size=(B, T)).astype(np.int32)
    labels[:, :2] = -1
    out["labels"] = labels
    return out


def jax_grads(jcfg, jp, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    return jax.jit(jax.value_and_grad(lambda p, b: JM.forward_train(jcfg, p, b),
                                      has_aux=True))(jp, jb)


def torch_grads(tcfg, tp, batch):
    return M.value_and_grad(tcfg, tp, {k: torch.from_numpy(v) for k, v in batch.items()})


def assert_grads(got, want, rel):
    got = [g.numpy() for g in tree_leaves(got)]
    want = [np.asarray(g) for g in jax.tree_util.tree_leaves(want)]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=rel,
                                   atol=rel * max(float(np.max(np.abs(b))), 1e-30))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_train_and_grads_match_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg, tcfg)
    batch = make_batch(jcfg)
    (jl, jm), jg = jax_grads(jcfg, jp, batch)
    (tl, tm), tg = torch_grads(tcfg, tp, batch)
    assert torch.isfinite(tl)
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tm["ce"]), float(jm["ce"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tm["aux"]), float(jm["aux"]), rtol=LOSS_RTOL,
                               atol=1e-7)
    assert int(tm["tokens"]) == int(jm["tokens"]) == batch["labels"].size - 2 * 2
    if jcfg.num_experts:
        assert float(tm["aux"]) > 0
    assert_grads(tg, jg, GRAD_REL)


# ---------------------------------------------------------------------------
# the kernels refuse grad
# ---------------------------------------------------------------------------
def _wrapper_calls(g):
    x = torch.randn(2, 8, 4, 16, generator=g)
    w = torch.randn(16, generator=g)
    la = -torch.rand(1, 8, 16, generator=g)
    dt, bm, cm = (torch.rand(2, 8, 4, generator=g), torch.randn(2, 8, 16, generator=g),
                  torch.randn(2, 8, 16, generator=g))
    return {
        "flash_attention": (lambda q: flash_attention(q, x, x), x),
        "rmsnorm": (lambda t: rmsnorm(t, w), x),
        "add_rmsnorm": (lambda t: add_rmsnorm(t, x, w), x),
        "gated_rmsnorm": (lambda t: gated_rmsnorm(x, t, w), x),
        "ssd_scan": (lambda t: ssd_scan(t, dt, torch.zeros(4), bm, cm, 4), x),
        "rglru_scan": (lambda t: rglru_scan(la, t), torch.randn(1, 8, 16, generator=g)),
    }


@pytest.mark.parametrize("name", ["flash_attention", "rmsnorm", "add_rmsnorm",
                                  "gated_rmsnorm", "ssd_scan", "rglru_scan"])
def test_kernel_wrappers_refuse_grad(name):
    """On CPU tensors as on the card: an input that requires grad raises
    while grad is enabled; under no_grad, or without requires_grad, the
    wrapper returns what the plain version does."""
    call, arg = _wrapper_calls(torch.Generator().manual_seed(0))[name]
    want = call(arg)
    with pytest.raises(RuntimeError, match="no backward"):
        call(arg.clone().requires_grad_())
    with torch.no_grad():
        got = call(arg.clone().requires_grad_())
    for a, b in zip(tree_leaves(got), tree_leaves(want), strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mamba2-370m", "recurrentgemma-9b"])
def test_use_pallas_raises_under_grad_like_jax(arch):
    """``use_pallas=True``: ``jax.grad`` cannot go through the Pallas
    kernels and raises; the port's wrappers raise too, at the first
    kernel. Under no_grad the port's kernel path gives the plain path's
    loss."""
    jcfg, tcfg = _cfgs(arch, use_pallas=True)
    jp, tp = _params(jcfg, tcfg)
    batch = make_batch(jcfg, T=16)
    with pytest.raises(Exception):
        jax_grads(jcfg, jp, batch)
    with pytest.raises(RuntimeError, match="no backward"):
        torch_grads(tcfg, tp, batch)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        l_kernel, _ = M.forward_train(tcfg, tp, tb)
        l_plain, _ = M.forward_train(tcfg.replace(use_pallas=False), tp, tb)
    np.testing.assert_allclose(float(l_kernel), float(l_plain), rtol=LOSS_RTOL)
