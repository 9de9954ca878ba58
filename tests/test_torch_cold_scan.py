"""The port's cold-start scan against the JAX package's: ``cold_scan_plain``
(what the wrapper runs for CPU tensors) and the torch ``cold_scan_parallel``
equal ``repro.kernels.ref.cold_scan_ref`` and the Pallas kernel (interpret
mode on the CPU) exactly, on the cases of ``tests/test_kernels.py``. Also
the port's own departures: ``keep_warm`` per row, and comparisons in the
input dtype. The CUDA kernel itself is held against ``cold_scan_plain`` on
the card by ``chip_smoke.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro_torch.kernels.cold_scan import (cold_scan, cold_scan_parallel,
                                           cold_scan_plain)


def _cold_case(key, B, T, interarrival, keep_warm, spread=0.3):
    """The generator of ``tests/test_kernels.py``: arrival times plus
    warm/cold end-time hypotheses around them (float32)."""
    k1, k2, k3 = jax.random.split(key, 3)
    gaps = interarrival * (0.5 + jax.random.uniform(k1, (T,)))
    t0 = jnp.cumsum(gaps)
    dur = spread * jax.random.uniform(k2, (B, T))
    cold_extra = spread * jax.random.uniform(k3, (B, T))
    warm_end = t0[None, :] + dur
    return t0, warm_end, warm_end + cold_extra, jnp.float32(keep_warm)


def _torch(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _port_masks(t0, warm, cold, kw):
    tt0, tw, tc = _torch(t0, warm, cold)
    kwf = float(kw)
    return (cold_scan(tt0, tw, tc, kwf).numpy(),
            cold_scan_plain(tt0, tw, tc, kwf).numpy(),
            cold_scan_parallel(tt0, tw, tc, kwf).numpy())


@pytest.mark.parametrize("B,T", [(1, 64), (3, 257), (130, 300)])
@pytest.mark.parametrize(
    "interarrival,keep_warm",
    [
        (1.0, 900.0),  # paper regime: warm after request 0
        (10.0, 1.0),  # every request cold
        (1.0, 0.95),  # straddling: the mask genuinely recurses
        (1.0, jnp.inf),  # never cold
    ],
)
def test_plain_and_parallel_match_ref_and_pallas(B, T, interarrival, keep_warm):
    t0, warm, cold, kw = _cold_case(jax.random.PRNGKey(7), B, T, interarrival,
                                    keep_warm)
    want = np.asarray(ref.cold_scan_ref(t0, warm, cold, kw))
    np.testing.assert_array_equal(np.asarray(ops.cold_scan(t0, warm, cold, kw)),
                                  want)
    for got in _port_masks(t0, warm, cold, kw):
        assert got.dtype == np.bool_ and got.shape == (B, T)
        np.testing.assert_array_equal(got, want)


def test_flip_heavy_regime():
    """keep_warm between the warm and cold gaps on most requests: every
    affine map is a flip, so the doubling loop runs to full depth."""
    T = 97
    t0 = 0.7 * jnp.arange(T, dtype=jnp.float32)
    warm = t0[None, :] + 0.02
    cold = warm + 0.5
    kw = jnp.float32(0.6)
    want = np.asarray(ref.cold_scan_ref(t0, warm, cold, kw))
    np.testing.assert_array_equal(np.asarray(ops.cold_scan(t0, warm, cold, kw)),
                                  want)
    for got in _port_masks(t0, warm, cold, kw):
        np.testing.assert_array_equal(got, want)
    assert want.sum() not in (0, T)  # the mask really alternates


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_keep_warm_per_row_matches_row_wise_reference(dtype):
    """One launch over rows whose keep_warm differ (placements on platforms
    with other keep_warm_s) equals one reference call per row."""
    B, T = 12, 180
    t0, warm, cold, _ = _cold_case(jax.random.PRNGKey(3), B, T, 1.0, 1.0)
    kws = np.array([0.5, 0.8, 0.9, 0.95, 1.0, 1.05, 1.2, 2.0, np.inf, 0.0,
                    0.97, 0.93], np.float32)
    want = np.stack([np.asarray(ref.cold_scan_ref(t0, warm[b:b + 1], cold[b:b + 1],
                                                  jnp.float32(kws[b])))[0]
                     for b in range(B)])
    tt0, tw, tc = (x.to(dtype) for x in _torch(t0, warm, cold))
    kw = torch.from_numpy(kws).to(dtype)
    for fn in (cold_scan, cold_scan_plain, cold_scan_parallel):
        np.testing.assert_array_equal(fn(tt0, tw, tc, kw).numpy(), want)
    assert len({tuple(r) for r in want.tolist()}) > 3  # rows really differ


def _sequential_f64(t0, warm, cold, kw):
    mask = np.zeros(warm.shape, bool)
    for b in range(warm.shape[0]):
        last = -np.inf
        for k in range(warm.shape[1]):
            mask[b, k] = (t0[k] - last) > kw
            last = cold[b, k] if mask[b, k] else warm[b, k]
    return mask


def test_float64_compares_in_float64():
    """Gaps within one float32 ulp of keep_warm: the f64 inputs decide them
    one way, an f32 cast (what the TPU kernel does) the other. The port
    compares in the input dtype and so matches the f64 recurrence."""
    T = 64
    rng = np.random.default_rng(0)
    t0 = 3.0 * np.arange(T, dtype=np.float64)
    delta = np.where(rng.random((4, T)) < 0.5, 1e-9, -1e-9)
    warm = t0[None, :] + 2.0 - delta  # warm gap to the next request: 1 + delta
    cold = warm + 0.5  # cold gap 0.5 + delta: never past keep_warm
    kw = 1.0
    want = _sequential_f64(t0, warm, cold, kw)
    as_f32 = _sequential_f64(*(a.astype(np.float32) for a in (t0, warm, cold)),
                             np.float32(kw))
    assert (want != as_f32).any()  # the f32 cast would flip comparisons
    tt0, tw, tc = _torch(t0, warm, cold)
    for fn in (cold_scan, cold_scan_plain, cold_scan_parallel):
        np.testing.assert_array_equal(fn(tt0, tw, tc, kw).numpy(), want)


def test_wrapper_raises_off_cpu_and_cuda_and_counts_no_cpu_launch():
    cold_scan.launches = 0
    t0, warm, cold, kw = _cold_case(jax.random.PRNGKey(1), 4, 40, 1.0, 0.95)
    tt0, tw, tc = _torch(t0, warm, cold)
    cold_scan(tt0, tw, tc, float(kw))
    assert cold_scan.launches == 0  # the plain version is no launch
    meta = [x.to("meta") for x in (tt0, tw, tc)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        cold_scan(*meta, 0.95)
    assert cold_scan.launches == 0


def test_keep_warm_shape_and_dtype_are_checked():
    t0, warm, cold = _torch(*_cold_case(jax.random.PRNGKey(1), 4, 40, 1.0, 0.95)[:3])
    with pytest.raises(ValueError, match="scalar or"):
        cold_scan(t0, warm, cold, torch.ones(3))
    with pytest.raises(TypeError, match="keep_warm"):
        cold_scan(t0, warm, cold, torch.ones(4, dtype=torch.float64))
    with pytest.raises(ValueError, match="scalar or"):  # a Python scalar, or (B,)
        cold_scan(t0, warm, cold, torch.tensor(0.95, dtype=torch.float32))
    rows = torch.full((4,), 0.95, dtype=torch.float32)
    np.testing.assert_array_equal(cold_scan(t0, warm, cold, rows).numpy(),
                                  cold_scan(t0, warm, cold, 0.95).numpy())


def test_zero_length_and_empty_rows():
    t0 = torch.zeros(0)
    assert cold_scan(t0, torch.zeros(3, 0), torch.zeros(3, 0), 1.0).shape == (3, 0)
    assert cold_scan_parallel(t0, torch.zeros(3, 0), torch.zeros(3, 0),
                              1.0).shape == (3, 0)
    t1 = torch.arange(5.0)
    assert cold_scan(t1, torch.zeros(0, 5), torch.zeros(0, 5), 1.0).shape == (0, 5)
