"""The port's RG-LRU scan against the JAX package's: ``rglru_scan`` (which
runs its plain version on CPU tensors), ``rglru_scan_plain`` and the port's
log-depth ``models.griffin.lru_scan`` equal ``repro.kernels.ref.
rglru_scan_ref`` (the associative scan) and the Pallas kernel (interpret
mode on the CPU), on the cases and tolerance of ``tests/test_kernels.py``
(atol = rtol = 1e-5). The port also takes T that is no chunk multiple,
where the Pallas kernel asserts; there it is held against the oracle. The
CUDA kernel itself is held against ``rglru_scan_plain`` on the card by
``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro.models.griffin import lru_scan as jax_lru_scan
from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_plain
from repro_torch.models.griffin import lru_scan

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(B, T, W, seed):
    """log_a = -softplus(normal), b normal (the reference test's draw)."""
    rng = np.random.default_rng(seed)
    log_a = -np.log1p(np.exp(rng.standard_normal((B, T, W)))).astype(np.float32)
    b = rng.standard_normal((B, T, W), dtype=np.float32)
    return log_a, b


def _port_versions():
    return (rglru_scan, rglru_scan_plain, lru_scan)


@pytest.mark.parametrize(
    "B,T,W,chunk,bw", [(1, 64, 32, 16, 32), (2, 128, 64, 64, 16), (1, 256, 16, 256, 16)]
)
def test_plain_matches_pallas_and_ref(B, T, W, chunk, bw):
    log_a, b = _inputs(B, T, W, seed=T + W)
    yp, hp = ops.rglru_scan(jnp.asarray(log_a), jnp.asarray(b), chunk=chunk,
                            block_w=bw)
    yr, hr = ref.rglru_scan_ref(jnp.asarray(log_a), jnp.asarray(b))
    for fn in _port_versions():
        y, h = fn(torch.from_numpy(log_a), torch.from_numpy(b))
        assert y.dtype == torch.float32 and tuple(y.shape) == (B, T, W)
        assert tuple(h.shape) == (B, W)
        for want_y, want_h in ((yp, hp), (yr, hr)):
            np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **TOL)
            np.testing.assert_allclose(h.numpy(), np.asarray(want_h), **TOL)


@pytest.mark.parametrize("T", [1, 7, 300])
def test_any_length_matches_ref(T):
    """T no chunk divides: the Pallas kernel asserts, the port scans."""
    log_a, b = _inputs(2, T, 24, seed=T)
    yr, hr = ref.rglru_scan_ref(jnp.asarray(log_a), jnp.asarray(b))
    for fn in _port_versions():
        y, h = fn(torch.from_numpy(log_a), torch.from_numpy(b))
        np.testing.assert_allclose(y.numpy(), np.asarray(yr), **TOL)
        np.testing.assert_allclose(h.numpy(), np.asarray(hr), **TOL)


def test_lru_scan_matches_jax_lru_scan():
    """The port's model-level oracle against the reference's
    ``models.griffin.lru_scan`` (an associative scan), both from zero."""
    log_a, b = _inputs(2, 50, 16, seed=9)
    yr, hr = jax_lru_scan(jnp.asarray(log_a), jnp.asarray(b))
    y, h = lru_scan(torch.from_numpy(log_a), torch.from_numpy(b))
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(hr), **TOL)
