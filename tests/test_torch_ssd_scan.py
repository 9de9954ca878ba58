"""The port's SSD chunk scan against the JAX package's: ``ssd_scan`` (which
runs its plain version on CPU tensors) and ``ssd_scan_plain`` (which
``models.ssm`` calls ``ssd_chunked``) equal ``repro.kernels.ref.ssd_scan_ref`` and the
Pallas kernel (interpret mode on the CPU), on the cases and tolerances of
``tests/test_kernels.py``, plus Q == L and the serving dtypes (x, dt, A_log,
B, C all bf16). The CUDA kernel itself is held against ``ssd_scan_plain`` on
the card by ``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro_torch.kernels import ssd_scan as S

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def tol(name):
    return (dict(rtol=2e-2, atol=2e-2) if name == "bfloat16"
            else dict(rtol=2e-5, atol=2e-5))


def _inputs(B, L, H, P, N, seed):
    """The generator of ``tests/test_kernels.py`` in numpy: x, B, C normal,
    dt = softplus(normal), A_log = log U(1, 8)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, H, P), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, L, H)))).astype(np.float32)
    A_log = np.log(rng.uniform(1.0, 8.0, size=H)).astype(np.float32)
    Bm = rng.standard_normal((B, L, N), dtype=np.float32)
    Cm = rng.standard_normal((B, L, N), dtype=np.float32)
    return x, dt, A_log, Bm, Cm


def _both(arrs, dtypes):
    """arrs cast per ``dtypes`` (one name per array) for both packages."""
    j = [jnp.asarray(a, DTYPES[d][0]) for a, d in zip(arrs, dtypes)]
    t = [torch.from_numpy(a).to(DTYPES[d][1]) for a, d in zip(arrs, dtypes)]
    return j, t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize(
    "B,L,H,P,N,Q,bh",
    [
        (1, 64, 2, 16, 8, 16, 2),
        (2, 128, 4, 32, 16, 32, 2),  # head-blocked
        (1, 96, 3, 16, 8, 32, 1),  # H not a power of two
    ],
)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_and_ref(B, L, H, P, N, Q, bh, dtype):
    # dt in the input dtype, A_log f32: the reference test's choice
    arrs = _inputs(B, L, H, P, N, seed=L + H)
    j, t = _both(arrs, [dtype, dtype, "float32", dtype, dtype])
    yp, sp = ops.ssd_scan(*j, Q, block_h=bh)
    yr, sr = ref.ssd_scan_ref(*j, Q)
    for fn in (S.ssd_scan, S.ssd_scan_plain):
        y, s = fn(*t, Q)
        assert y.dtype == t[0].dtype and s.dtype == torch.float32
        assert tuple(y.shape) == (B, L, H, P) and tuple(s.shape) == (B, H, P, N)
        for want_y, want_s in ((yp, sp), (yr, sr)):
            np.testing.assert_allclose(_np(y), _np(want_y), **tol(dtype))
            np.testing.assert_allclose(_np(s), _np(want_s), **tol(dtype))


@pytest.mark.parametrize("case", ["q_equals_l", "serving_dtypes"])
def test_q_equals_l_and_serving_dtypes(case):
    """Q == L (one chunk); and every input bf16, as cast_params leaves a
    cycled mamba2 layer (its stacked A_log is bf16 too)."""
    if case == "q_equals_l":
        arrs, Q, dts = _inputs(1, 64, 2, 16, 8, seed=1), 64, ["float32"] * 5
    else:
        arrs, Q, dts = _inputs(2, 128, 3, 32, 16, seed=2), 32, ["bfloat16"] * 5
    j, t = _both(arrs, dts)
    yr, sr = ref.ssd_scan_ref(*j, Q)
    yp, sp = ops.ssd_scan(*j, Q)
    y, s = S.ssd_scan(*t, Q)
    assert y.dtype == t[0].dtype and s.dtype == torch.float32
    for want_y, want_s in ((yp, sp), (yr, sr)):
        np.testing.assert_allclose(_np(y), _np(want_y), **tol(dts[0]))
        np.testing.assert_allclose(_np(s), _np(want_s), **tol(dts[0]))


def test_zero_dt_padding_is_exact():
    """The block pads L to a chunk multiple with zero dt: y over the real
    rows and the final state are those of the unpadded sequence."""
    x, dt, A_log, Bm, Cm = (torch.from_numpy(a) for a in _inputs(1, 48, 2, 16, 8, 5))
    y, s = S.ssd_scan(x, dt, A_log, Bm, Cm, 48)

    def pad(a):  # 16 zero rows along L
        return torch.nn.functional.pad(a, (0, 0) * (a.ndim - 2) + (0, 16))
    yp, sp = S.ssd_scan(pad(x), pad(dt), A_log, pad(Bm), pad(Cm), 32)
    torch.testing.assert_close(yp[:, :48], y, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(sp, s, atol=2e-5, rtol=2e-5)


def test_ragged_length_raises():
    x, dt, A_log, Bm, Cm = (torch.from_numpy(a) for a in _inputs(1, 40, 2, 16, 8, 6))
    with pytest.raises(ValueError, match="multiple"):
        S.ssd_scan(x, dt, A_log, Bm, Cm, 16)


# --- the kernel's two passes (C·Bᵀ once per chunk, then the scan) ---

@pytest.mark.parametrize(
    "B,L,H,P,N,Q,oracle",
    [
        (1, 64, 2, 16, 8, 16, "ref"),     # the kernel tests' shapes: N = 8
        (2, 128, 4, 32, 16, 32, "ref"),   #   pads the mma depth of 16
        (1, 96, 3, 16, 8, 32, "ref"),
        (1, 64, 2, 16, 8, 64, "ref"),     # Q == L
        # chunks of 96 and 256: cum reaches -1e3, where the reference's
        # float32 prefix sums drift by ulps of |cum| (ROADMAP queue 3), so
        # the one-pass plain version (f64 prefix sums) is the oracle
        (2, 384, 2, 16, 16, 96, "plain"),   # the second t tile part padding
        (1, 1024, 2, 16, 16, 256, "plain"),  # 4 chunks of mamba2's length
    ],
)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_two_pass_decomposition_matches_ref(B, L, H, P, N, Q, oracle, dtype):
    """C·Bᵀ computed once per (batch, chunk) into the scratch layout, with
    the tiles the kernel never writes (s tile > t tile) set to NaN, then the
    scan tile for tile from it, equals the JAX package's oracle (or the
    one-pass plain version, see above): every head reads the same C·Bᵀ,
    and nothing reads past the causal half."""
    arrs = _inputs(B, L, H, P, N, seed=L + N + Q)
    j, t = _both(arrs, [dtype, dtype, "float32", dtype, dtype])
    cb = S.ssd_cb_plain(t[3], t[4], min(Q, L), fill=float("nan"))
    assert tuple(cb.shape) == S.cb_scratch_shape(B, L, min(Q, L))
    y, s = S.ssd_scan_from_cb(*t, cb, Q)
    yr, sr = (ref.ssd_scan_ref(*j, Q) if oracle == "ref"
              else S.ssd_scan_plain(*t, Q))
    assert y.dtype == t[0].dtype and s.dtype == torch.float32
    np.testing.assert_allclose(_np(y), _np(yr), **tol(dtype))
    np.testing.assert_allclose(_np(s), _np(sr), **tol(dtype))


def test_cb_scratch_holds_the_causal_half_of_c_b_t():
    """The scratch layout: (B, chunks, Qp, Qp), Qp = Q rounded up to 64;
    tile (t, s) with s <= t holds C_t·B_s of its chunk (zero past Q)."""
    Bm, Cm = (torch.from_numpy(a) for a in _inputs(2, 192, 1, 8, 16, seed=3)[3:])
    assert S.cb_scratch_shape(2, 192, 96) == (2, 2, 128, 128)
    cb = S.ssd_cb_plain(Bm, Cm, 96)
    want = np.einsum("bcqn,bcsn->bcqs", Cm.numpy().reshape(2, 2, 96, 16),
                     Bm.numpy().reshape(2, 2, 96, 16))
    tile = np.arange(128) // S.TILE
    keep = (tile[:, None] >= tile[None, :])[:96, :96]
    np.testing.assert_allclose(cb[:, :, :96, :96].numpy()[..., keep],
                               want[..., keep], rtol=1e-6, atol=1e-5)
    assert (cb[:, :, 96:] == 0).all() and (cb[:, :, :, 96:] == 0).all()
