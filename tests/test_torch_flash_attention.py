"""The port's flash attention (plain version, which the wrapper runs on CPU
tensors) against the JAX package's Pallas kernel in interpret mode and its
jnp oracle, on the same numpy inputs.

Tolerances are those of tests/test_kernels.py: 2e-5 in float32 (summation
order), 2e-2 in bfloat16 (p is rounded to bf16 before PV on both sides, but
the Pallas kernel keeps p in f32).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def tol(name):
    return (dict(rtol=2e-2, atol=2e-2) if name == "bfloat16"
            else dict(rtol=2e-5, atol=2e-5))


def _inputs(B, T, S, H, K, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, H, d), dtype=np.float32)
    k = rng.standard_normal((B, S, K, d), dtype=np.float32)
    v = rng.standard_normal((B, S, K, d), dtype=np.float32)
    return q, k, v


def _both(arrs, dtype_name):
    jdt, tdt = DTYPES[dtype_name]
    return ([jnp.asarray(a, jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize(
    "B,T,S,H,K,d",
    [
        (1, 128, 128, 4, 4, 64),  # MHA
        (2, 256, 256, 8, 2, 64),  # GQA 4:1
        (1, 128, 256, 4, 1, 128),  # MQA, T != S
    ],
)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 96), (False, None)])
def test_plain_matches_pallas_and_ref(B, T, S, H, K, d, dtype, causal, window):
    arrs = _inputs(B, T, S, H, K, d, seed=T * H + d)
    (jq, jk, jv), (tq, tk, tv) = _both(arrs, dtype)
    got = flash_attention(tq, tk, tv, causal=causal, window=window)
    pallas = ops.flash_attention(jq, jk, jv, causal=causal, window=window)
    oracle = ref.flash_attention_ref(jq, jk, jv, causal=causal, window=window)
    assert got.dtype == tq.dtype and tuple(got.shape) == (B, T, H, d)
    np.testing.assert_allclose(_np(got), _np(pallas), **tol(dtype))
    np.testing.assert_allclose(_np(got), _np(oracle), **tol(dtype))


@pytest.mark.parametrize("causal,window", [(True, None), (True, 40), (False, 30)])
def test_ragged_lengths_match_ref(causal, window):
    """T and S that no block size divides: the Pallas kernel asserts on
    them, the port takes them; held against the oracle."""
    arrs = _inputs(2, 100, 77, 6, 3, 32, seed=5)
    (jq, jk, jv), (tq, tk, tv) = _both(arrs, "float32")
    got = flash_attention(tq, tk, tv, causal=causal, window=window)
    want = ref.flash_attention_ref(jq, jk, jv, causal=causal, window=window)
    np.testing.assert_allclose(_np(got), _np(want), **tol("float32"))


def test_wrapper_on_cpu_counts_no_launch():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 16, 16, 2, 1, 16, 0))
    before = flash_attention.launches
    out = flash_attention(q, k, v)
    assert flash_attention.launches == before
    torch.testing.assert_close(out, flash_attention_plain(q, k, v))


def test_wrapper_rejects_non_cpu_non_cuda_device():
    q = torch.zeros((1, 4, 2, 16), device="meta")
    with pytest.raises(ValueError):
        flash_attention(q, q[:, :, :1], q[:, :, :1])
