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
from repro_torch.kernels import flash_attention as FA
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


# --- the wgmma kernel's tile order and its tile arithmetic (host side) ---
PLAN_CASES = [
    # T, S, causal, window
    (512, 512, True, None),      # qwen3's prefill
    (512, 512, True, 2048),      # recurrentgemma's local layers
    (300, 300, True, None),      # ragged
    (100, 77, True, 40),         # ragged window, T > S
    (1, 300, False, None),       # T = 1
    (37, 37, True, None),        # T < 64
    (128, 256, True, None),      # T != S
    (128, 256, False, None),     # T != S, non-causal
    (2500, 2500, True, 2048),    # the window binds
    (256, 256, True, 20),        # window inside one kv tile
    (130, 77, True, 40),         # rows that reach no key
]


def _mask(T, S, causal, window):
    t = np.arange(T)[:, None]
    s = np.arange(S)[None, :]
    m = np.ones((T, S), dtype=bool)
    if causal:
        m &= t >= s
    if window is not None:
        m &= (t - s) < window
    return m


@pytest.mark.parametrize("T,S,causal,window", PLAN_CASES)
def test_plan_covers_every_reachable_pair_once(T, S, causal, window):
    """Every (query, key) pair the masks leave reachable lies in exactly one
    block's kv tiles; every q tile is one block; q tiles run from the last
    down, so under a causal mask the longest come first."""
    blocks = FA.plan_tiles(T, S, causal, window)
    mask = _mask(T, S, causal, window)
    seen = np.zeros((T, S), dtype=int)
    for qt, kt0, kt1 in blocks:
        assert kt0 <= kt1
        rows = slice(qt * FA.TILE, min(qt * FA.TILE + FA.TILE, T))
        for kt in range(kt0, kt1):
            cols = slice(kt * FA.TILE, min(kt * FA.TILE + FA.TILE, S))
            seen[rows, cols] += mask[rows, cols]
    np.testing.assert_array_equal(seen, mask.astype(int))
    n_qt = -(-T // FA.TILE)
    assert [qt for qt, _, _ in blocks] == list(range(n_qt - 1, -1, -1))
    if causal and window is None and T == S:
        lengths = [kt1 - kt0 for _, kt0, kt1 in blocks]
        assert lengths == sorted(lengths, reverse=True)


@pytest.mark.parametrize("T,S,causal,window",
                         [c for c in PLAN_CASES
                          if c[0] <= 512 and c != (130, 77, True, 40)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiles_match_ref(T, S, causal, window, dtype):
    """The plain attention cut into the kernel's q and kv tiles, each q tile
    an online softmax in base 2 over its kv tiles, equals the JAX package's
    oracle."""
    arrs = _inputs(1, T, S, 6, 2, 64, seed=T + S)
    (jq, jk, jv), (tq, tk, tv) = _both(arrs, dtype)
    got = FA.flash_attention_tiles(tq, tk, tv, causal=causal, window=window)
    want = ref.flash_attention_ref(jq, jk, jv, causal=causal, window=window)
    assert got.dtype == tq.dtype
    np.testing.assert_allclose(_np(got), _np(want), **tol(dtype))


@pytest.mark.parametrize("H,K,d", [(24, 8, 64), (16, 1, 256)])
def test_tiles_match_ref_at_served_head_shapes(H, K, d):
    """The tile arithmetic with granite's GQA 24/8 at d = 64 and
    recurrentgemma's MQA 16/1 at d = 256, ragged T, in bfloat16."""
    arrs = _inputs(1, 100, 100, H, K, d, seed=H + d)
    (jq, jk, jv), (tq, tk, tv) = _both(arrs, "bfloat16")
    got = FA.flash_attention_tiles(tq, tk, tv, causal=True, window=None)
    want = ref.flash_attention_ref(jq, jk, jv, causal=True, window=None)
    np.testing.assert_allclose(_np(got), _np(want), **tol("bfloat16"))


def test_tiles_give_zero_on_rows_that_reach_no_key():
    """T > S + window - 1: the last rows reach no key. A q tile with no
    reachable kv tile (m = -1e30, l = 0) writes 0 (the Pallas kernel and
    the CUDA kernel agree; the plain versions average V); the other rows
    equal the oracle."""
    T, S, window = 130, 77, 40
    arrs = _inputs(2, T, S, 4, 2, 64, seed=9)
    (jq, jk, jv), (tq, tk, tv) = _both(arrs, "float32")
    got = _np(FA.flash_attention_tiles(tq, tk, tv, causal=True, window=window))
    want = _np(ref.flash_attention_ref(jq, jk, jv, causal=True, window=window))
    dead = ~_mask(T, S, True, window).any(axis=1)
    assert dead.sum() == T - (S + window - 1)
    np.testing.assert_array_equal(got[:, dead], 0.0)
    np.testing.assert_allclose(got[:, ~dead], want[:, ~dead], **tol("float32"))


def test_check_rejects_a_batch_over_the_grid():
    q = torch.zeros((FA.GRID_MAX + 1, 1, 1, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="batch"):
        FA._check(q, q, q, None)


@pytest.mark.parametrize("T", [FA.GRID_MAX * FA.TILE + 1, 2 * FA.GRID_MAX * FA.TILE])
def test_check_rejects_more_q_tiles_than_the_grid_takes(T):
    """More q tiles than the kernels' q-tile grid axis takes raises before
    any build or launch."""
    q = torch.empty((1, T, 1, 64), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="q tiles"):
        FA._check(q, q, q, None)


@pytest.mark.parametrize("case", ["dtype", "head_dim", "contiguous", "aligned",
                                  "window", "gqa"])
def test_check_rejects_what_the_kernels_do_not_take(case):
    """Each input the kernels do not take raises in ``_check``, before any
    build or launch."""
    q = torch.zeros((1, 64, 4, 64), dtype=torch.bfloat16)
    k = torch.zeros((1, 64, 2, 64), dtype=torch.bfloat16)
    v, window, err = k, None, ValueError
    if case == "dtype":
        q, k, v, err = q.half(), k.half(), v.half(), TypeError
    elif case == "head_dim":
        q, k, v = (t[..., :40].contiguous() for t in (q, k, v))
    elif case == "contiguous":
        q = torch.zeros((1, 4, 64, 64), dtype=torch.bfloat16).transpose(1, 2)
    elif case == "aligned":
        q = torch.zeros(1 * 64 * 4 * 64 + 1,
                        dtype=torch.bfloat16)[1:].view(1, 64, 4, 64)
    elif case == "window":
        window = 0
    elif case == "gqa":
        k = v = torch.zeros((1, 64, 3, 64), dtype=torch.bfloat16)
    with pytest.raises(err):
        FA._check(q, k, v, window)


# ---------------------------------------------------------------------------
# every head dim the Pallas kernel takes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", FA.HEAD_DIMS)
def test_check_accepts_every_head_dim_that_is_a_multiple_of_16(d, dtype):
    """The Pallas kernel's blocks span the whole head dim, so it takes any
    d; the port's kernels take every multiple of 16 up to 256."""
    q = torch.zeros((1, 64, 4, d), dtype=dtype)
    k = torch.zeros((1, 64, 2, d), dtype=dtype)
    FA._check(q, k, k, None)
    assert FA.kernel_source(dtype, d) == (
        "flash_attention_f32" if dtype == torch.float32
        else "flash_attention" if d in (64, 128, 256) else "flash_attention_mma")


@pytest.mark.parametrize("d", [8, 72, 250, 272])
def test_check_rejects_head_dims_no_kernel_takes(d):
    q = torch.zeros((1, 64, 4, d), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 16"):
        FA._check(q, q, q, None)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_matches_pallas_and_ref_at_head_dim_80(causal, dtype):
    """hubert-xlarge's head dim (80: non-causal MHA, 16 heads at full size),
    which the port's kernels take on the mma.sync and float32 paths."""
    arrs = _inputs(1, 128, 128, 4, 4, 80, seed=80)
    (jq, jk, jv), (tq, tk, tv) = _both(arrs, dtype)
    got = flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype and tuple(got.shape) == (1, 128, 4, 80)
    want = ops.flash_attention(jq, jk, jv, causal=causal)
    np.testing.assert_allclose(_np(got), _np(want), **tol(dtype))
    np.testing.assert_allclose(
        _np(got), _np(ref.flash_attention_ref(jq, jk, jv, causal=causal)), **tol(dtype))
