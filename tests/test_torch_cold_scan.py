"""The port's cold-start scan against the JAX package's: ``cold_scan_plain``
(what the wrapper runs for CPU tensors) and the torch ``cold_scan_parallel``
equal ``repro.kernels.ref.cold_scan_ref`` and the Pallas kernel (interpret
mode on the CPU) exactly, on the cases of ``tests/test_kernels.py``. Also
the port's own departures: ``keep_warm`` per row, and comparisons in the
input dtype. ``cold_scan_words``, the CUDA kernel's arithmetic in plain
PyTorch, is held to the same oracles and to ``cold_scan_plain`` at every
chunking, across tile and chunk boundaries and on ends the simulator does
not make (cold before warm, NaN, +-inf). The CUDA kernel itself is held
against ``cold_scan_plain`` on the card by ``chip_smoke.py``."""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro_torch.kernels import cold_scan as CS
from repro_torch.kernels.cold_scan import (MAX_CHUNKS, TILE, cold_scan,
                                           cold_scan_parallel, cold_scan_plain,
                                           cold_scan_plan, cold_scan_words)


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


# ---------------------------------------------------------------------------
# cold_scan_words: the CUDA kernel's arithmetic (GF(2) maps of the select
# form, lanes of 4, a warp scan, tiles and chunks carrying the state)
# ---------------------------------------------------------------------------
CHUNKINGS = (1, 2, 4, 16)


@pytest.mark.parametrize("B,T", [(1, 64), (3, 257), (130, 300)])
@pytest.mark.parametrize(
    "interarrival,keep_warm",
    [(1.0, 900.0), (10.0, 1.0), (1.0, 0.95), (1.0, jnp.inf)],
)
def test_words_match_ref_and_plain(B, T, interarrival, keep_warm):
    t0, warm, cold, kw = _cold_case(jax.random.PRNGKey(7), B, T, interarrival,
                                    keep_warm)
    want = np.asarray(ref.cold_scan_ref(t0, warm, cold, kw))
    tt0, tw, tc = _torch(t0, warm, cold)
    np.testing.assert_array_equal(cold_scan_plain(tt0, tw, tc, float(kw)).numpy(), want)
    for n in CHUNKINGS:
        got = cold_scan_words(tt0, tw, tc, float(kw), n_chunks=n)
        assert got.dtype == torch.bool and tuple(got.shape) == (B, T)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,T", [(2, 1), (2, 127), (2, 128), (3, 129), (2, 383),
                                 (4, 1000), (2, 4097)])
def test_words_across_tile_and_chunk_boundaries(B, T, dtype):
    """T off the tile of 128 and on it, one request past it, chunks of one
    tile and of several, empty chunks past T: every chunking equals the
    plain version."""
    t0, warm, cold, _ = _cold_case(jax.random.PRNGKey(T), B, T, 1.0, 0.95)
    tt0, tw, tc = (x.to(dtype) for x in _torch(t0, warm, cold))
    want = cold_scan_plain(tt0, tw, tc, 0.95)
    assert T == 1 or 0 < int(want.sum()) < B * T  # the mask really recurses
    for n in CHUNKINGS:
        np.testing.assert_array_equal(
            cold_scan_words(tt0, tw, tc, 0.95, n_chunks=n).numpy(), want.numpy())


def _odd_ends(seed, B, T, dtype):
    """Cold ends before warm ends on half the rows, NaN and +-inf ends, an
    infinite and a NaN arrival; keep_warm per row, inf on the last."""
    rng = np.random.default_rng(seed)
    t0 = np.cumsum(0.5 + rng.random(T))
    warm = t0[None, :] + 0.3 * rng.random((B, T))
    cold = warm + 0.3 * rng.random((B, T))
    early = rng.random((B, 1)) < 0.5
    cold = np.where(early, warm - 0.3 * rng.random((B, T)), cold)
    for ends in (warm, cold):
        for v in (np.nan, np.inf, -np.inf):
            ends[rng.random((B, T)) < 0.02] = v
    t0[T // 3], t0[T // 2] = np.inf, np.nan
    kw = np.linspace(0.5, 1.2, B)
    kw[-1] = np.inf
    return (torch.from_numpy(t0).to(dtype), torch.from_numpy(warm).to(dtype),
            torch.from_numpy(cold).to(dtype), torch.from_numpy(kw).to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,T", [(6, 300), (3, 1030)])
def test_words_are_exact_for_any_ends(B, T, dtype):
    """The select form makes the recurrence's own two comparisons, so it
    equals it with cold ends before warm ends and with NaN and +-inf ends
    and arrivals; cold_scan_parallel's ``warm_gap & ~cold_gap`` map does
    not (it assumes cold_end >= warm_end)."""
    t0, warm, cold, kw = _odd_ends(B * T, B, T, dtype)
    want = cold_scan_plain(t0, warm, cold, kw)
    got = [cold_scan_words(t0, warm, cold, kw, n_chunks=n) for n in CHUNKINGS]
    for g in got:
        np.testing.assert_array_equal(g.numpy(), want.numpy())
    seq = _sequential_f64(*(a.double().numpy() for a in (t0, warm, cold)), 0.0)
    assert seq.shape == want.shape  # the recurrence runs on these inputs too
    f32_ref = np.stack([np.asarray(ref.cold_scan_ref(
        jnp.asarray(t0.float().numpy()), jnp.asarray(warm[b:b + 1].float().numpy()),
        jnp.asarray(cold[b:b + 1].float().numpy()), jnp.float32(kw[b])))[0]
        for b in range(B)])
    if dtype == torch.float32:
        np.testing.assert_array_equal(want.numpy(), f32_ref)
    flat = torch.full((B,), 0.9, dtype=dtype)
    assert not torch.equal(cold_scan_parallel(t0, warm, cold, flat),
                           cold_scan_plain(t0, warm, cold, flat))


@pytest.mark.parametrize("T", [97, 1000, 4097])
def test_words_carry_the_state_through_flip_only_tiles_and_chunks(T):
    """Every request from 2 on a flip (warm gap past keep_warm, cold gap
    not): each tile's and chunk's composed map keeps its flip bit, so the
    state entering a tile or a chunk decides all of it. Request 1 is cold
    whatever came before, so the first tile ends cold after an even number
    of flips and the state carried on is 1."""
    t0 = 0.7 * jnp.arange(T, dtype=jnp.float32)
    warm = jnp.stack([t0 + 0.02, t0 + 0.03]).at[:, 0].set(t0[0] - 1.0)
    cold = (warm + 0.5).at[:, 0].set(t0[0] - 1.0)
    want = np.asarray(ref.cold_scan_ref(t0, warm, cold, jnp.float32(0.6)))
    assert want[:, 1:].sum() not in (0, 2 * (T - 1))  # it alternates
    tt0, tw, tc = _torch(t0, warm, cold)
    for n in CHUNKINGS:
        np.testing.assert_array_equal(
            cold_scan_words(tt0, tw, tc, 0.6, n_chunks=n).numpy(), want)


def test_words_keep_warm_inf_per_row():
    """Rows with keep_warm = inf are never cold (request 0 included); the
    others recurse."""
    t0, warm, cold, _ = _cold_case(jax.random.PRNGKey(5), 8, 500, 1.0, 1.0)
    tt0, tw, tc = _torch(t0, warm, cold)
    kw = torch.tensor([0.95, float("inf")] * 4, dtype=torch.float32)
    want = cold_scan_plain(tt0, tw, tc, kw)
    assert not bool(want[1::2].any()) and bool(want[::2].any())
    for n in CHUNKINGS:
        assert torch.equal(cold_scan_words(tt0, tw, tc, kw, n_chunks=n), want)


@pytest.mark.parametrize("B,T,sms,want", [
    (4096, 4096, 132, (1, 32)),  # the sweep's node: a warp a row
    (2, 256, 132, (2, 1)),  # few rows, two tiles: a tile a warp
    (1, 4096, 132, (16, 2)),  # one row: up to 16 warps
    (1000, 2000, 132, (4, 4)),
    (5, 1, 132, (1, 1)),
])
def test_plan_splits_few_rows_into_chunks(B, T, sms, want):
    nch, tpc = cold_scan_plan(B, T, sms)
    assert (nch, tpc) == want
    assert nch & (nch - 1) == 0 and nch <= MAX_CHUNKS and nch * tpc * TILE >= T


class _FakeLib:
    def __init__(self, err):
        self.calls, self.err, self.args = 0, err, None

    def cold_scan_fwd(self, *a):
        self.calls += 1
        self.args = a
        return self.err


def test_kernel_path_raises_on_failure_counts_launches_and_passes_the_plan(
        monkeypatch):
    """A CUDA error raises and counts nothing, never the plain version
    instead; a launch counts once and is given cold_scan_plan's split."""
    t0, warm, cold = _torch(*_cold_case(jax.random.PRNGKey(2), 3, 300, 1.0, 0.95)[:3])

    class _Stream:
        cuda_stream = 0
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: _Stream())
    monkeypatch.setattr(CS, "_sm_count", lambda d: 132)
    before = CS.cold_scan.launches
    bad = _FakeLib(700)
    monkeypatch.setattr(CS, "_lib", bad)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        CS._launch(t0, warm, cold, 0.95)
    assert bad.calls == 1 and CS.cold_scan.launches == before
    ok = _FakeLib(0)
    monkeypatch.setattr(CS, "_lib", ok)
    CS._launch(t0, warm, cold, 0.95)
    assert ok.calls == 1 and CS.cold_scan.launches == before + 1
    assert ok.args[8:10] == cold_scan_plan(3, 300, 132)
    CS.cold_scan.launches = before


def test_kernel_path_raises_without_a_build(monkeypatch):
    """Without nvcc the kernel path raises; it never runs the plain version
    instead."""
    t0, warm, cold = _torch(*_cold_case(jax.random.PRNGKey(2), 3, 40, 1.0, 0.95)[:3])
    monkeypatch.setattr(CS, "_sm_count", lambda d: 132)
    monkeypatch.setattr(CS, "_lib", None)

    def no_nvcc(*a, **k):
        raise RuntimeError("nvcc not found")
    monkeypatch.setattr(CS.build, "load", no_nvcc)
    before = CS.cold_scan.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        CS._launch(t0, warm, cold, 0.95)
    assert CS.cold_scan.launches == before
