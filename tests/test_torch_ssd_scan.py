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
