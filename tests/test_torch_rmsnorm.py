"""The port's rmsnorm (plain version, which the wrapper runs on CPU tensors)
against the JAX package's Pallas kernel in interpret mode and its jnp
oracle, on the same numpy inputs; the model's norms routed by
``cfg.use_pallas``; and the wrapper's failure paths.

Tolerances are those of tests/test_kernels.py: 2e-5 in float32 (the order
of the sum of squares), 2e-2 in bfloat16 (the output is rounded to bf16 on
both sides, so a last-bit difference of the f32 value can move it one bf16
ulp).
"""
import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro_torch.kernels import rmsnorm as RN
from repro_torch.models import layers

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def tol(name):
    return (dict(rtol=2e-2, atol=2e-2) if name == "bfloat16"
            else dict(rtol=2e-5, atol=2e-5))


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape, dtype=np.float32)
    w = rng.standard_normal((shape[-1],), dtype=np.float32) * 0.1
    return x, w


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("shape", [(7, 64), (3, 5, 128), (1, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_and_ref(shape, dtype):
    x, w = _inputs(shape, seed=shape[-1])
    jdt, tdt = DTYPES[dtype]
    jx, jw = jnp.asarray(x, jdt), jnp.asarray(w)
    tx, tw = torch.from_numpy(x).to(tdt), torch.from_numpy(w)
    got = RN.rmsnorm(tx, tw)
    assert got.dtype == tdt and tuple(got.shape) == shape
    np.testing.assert_allclose(_np(got), _np(ops.rmsnorm(jx, jw)), **tol(dtype))
    np.testing.assert_allclose(_np(got), _np(ref.rmsnorm_ref(jx, jw)), **tol(dtype))


@pytest.mark.parametrize("x_dtype,w_dtype", [("float32", "bfloat16"),
                                             ("bfloat16", "float32"),
                                             ("bfloat16", "bfloat16")])
def test_mixed_dtypes_match_pallas_and_ref(x_dtype, w_dtype):
    """Stacked norm scales arrive in bf16 and a remainder layer's in f32,
    whatever the residual stream's dtype: the output takes x's dtype."""
    x, w = _inputs((4, 9, 128), seed=1)
    jx, jw = jnp.asarray(x, DTYPES[x_dtype][0]), jnp.asarray(w, DTYPES[w_dtype][0])
    tx = torch.from_numpy(x).to(DTYPES[x_dtype][1])
    tw = torch.from_numpy(w).to(DTYPES[w_dtype][1])
    got = RN.rmsnorm(tx, tw)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(_np(got), _np(ops.rmsnorm(jx, jw)), **tol(x_dtype))
    np.testing.assert_allclose(_np(got), _np(ref.rmsnorm_ref(jx, jw)), **tol(x_dtype))


def test_layers_rmsnorm_routes_by_use_kernel():
    """``layers.rmsnorm`` with ``use_kernel`` goes through the wrapper, which
    on CPU tensors runs the plain version: the same numbers, no launch."""
    x, w = (torch.from_numpy(a) for a in _inputs((3, 5, 64), seed=2))
    before = RN.rmsnorm.launches
    plain = layers.rmsnorm(x, w)
    kernel = layers.rmsnorm(x, w, use_kernel=True)
    assert torch.equal(plain, kernel)
    assert torch.equal(plain, RN.rmsnorm_plain(x, w))
    assert RN.rmsnorm.launches == before


def test_wrapper_raises_off_cpu_and_cuda_and_counts_no_cpu_launch():
    before = RN.rmsnorm.launches
    RN.rmsnorm(torch.ones(2, 8), torch.zeros(8))
    assert RN.rmsnorm.launches == before
    with pytest.raises(ValueError, match="cuda or cpu"):
        RN.rmsnorm(torch.ones(2, 8, device="meta"), torch.zeros(8, device="meta"))
    assert RN.rmsnorm.launches == before


@pytest.mark.parametrize("x,w,err", [
    (torch.ones(2, 8, dtype=torch.float16), torch.zeros(8), TypeError),
    (torch.ones(2, 8), torch.zeros(8, dtype=torch.float64), TypeError),
    (torch.ones(2, 8), torch.zeros(4), ValueError),
    (torch.ones(2, 8), torch.zeros(1, 8), ValueError),
    (torch.ones(1, RN.MAX_D + 8), torch.zeros(RN.MAX_D + 8), ValueError),
])
def test_kernel_path_checks_its_inputs(x, w, err):
    """What the kernel does not take raises before any build or launch."""
    with pytest.raises(err):
        RN._launch(x, w)


class _FakeLib:
    def __init__(self, err):
        self.calls = 0
        self.err = err

    def rmsnorm_fwd(self, *a):
        self.calls += 1
        return self.err


def test_failed_build_or_launch_raises_and_never_falls_back(monkeypatch):
    """The kernel path (what a CUDA tensor takes) raises when the build
    fails or the launch returns a CUDA error, counts nothing, and does not
    hand back the plain version's result."""
    x, w = torch.ones(3, 16), torch.zeros(16)
    before = RN.rmsnorm.launches

    class _Stream:
        cuda_stream = 0
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: _Stream())

    def no_nvcc(*a, **k):
        raise RuntimeError("nvcc not found")
    monkeypatch.setattr(RN, "_lib", None)
    monkeypatch.setattr(RN.build, "load", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc"):
        RN._launch(x, w)

    lib = _FakeLib(700)  # cudaErrorIllegalAddress
    monkeypatch.setattr(RN, "_lib", lib)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        RN._launch(x, w)
    assert lib.calls == 1 and RN.rmsnorm.launches == before

    ok = _FakeLib(0)
    monkeypatch.setattr(RN, "_lib", ok)
    RN._launch(x, w)
    assert ok.calls == 1 and RN.rmsnorm.launches == before + 1
    RN.rmsnorm.launches = before


def test_kernel_path_raises_without_a_card():
    """Without a card (and, here, without nvcc) the kernel path raises; it
    never runs the plain version instead."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    before = RN.rmsnorm.launches
    with pytest.raises((RuntimeError, ValueError)):
        RN._launch(torch.ones(3, 16), torch.zeros(16))
    assert RN.rmsnorm.launches == before
