"""The port's rmsnorm (plain version, which the wrapper runs on CPU tensors)
against the JAX package's Pallas kernel in interpret mode and its jnp
oracle, on the same numpy inputs; the model's norms routed by
``cfg.use_pallas``; and the wrapper's failure paths. The same for the
kernel's prologues: ``add_rmsnorm`` against the reference's ``x + h``
followed by its rmsnorm, ``gated_rmsnorm`` against its
``rmsnorm(y * jax.nn.silu(z))``.

Tolerances are those of tests/test_kernels.py: 2e-5 in float32 (the order
of the sum of squares), 2e-2 in bfloat16 (the output is rounded to bf16 on
both sides, so a last-bit difference of the f32 value can move it one bf16
ulp).
"""
import contextlib

import jax
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


# ---------------------------------------------------------------------------
# the prologues: add_rmsnorm and gated_rmsnorm
# ---------------------------------------------------------------------------
MIXED = [("float32", "float32", "float32"), ("bfloat16", "bfloat16", "bfloat16"),
         ("bfloat16", "bfloat16", "float32"), ("float32", "bfloat16", "bfloat16"),
         ("bfloat16", "float32", "float32")]


@pytest.mark.parametrize("x_dtype,h_dtype,w_dtype", MIXED)
@pytest.mark.parametrize("shape", [(7, 64), (3, 5, 128)])
def test_add_rmsnorm_plain_matches_add_then_pallas_and_ref(shape, x_dtype, h_dtype,
                                                           w_dtype):
    """The reference's ``x = x + h`` then its rmsnorm, Pallas (interpret
    mode) and jnp: the sum in the promoted dtype, the norm of the rounded
    sum, both outputs in that dtype."""
    x, w = _inputs(shape, seed=shape[-1] + 3)
    h = np.random.default_rng(9).standard_normal(shape, dtype=np.float32)
    jx, jh = jnp.asarray(x, DTYPES[x_dtype][0]), jnp.asarray(h, DTYPES[h_dtype][0])
    jw = jnp.asarray(w, DTYPES[w_dtype][0])
    tx = torch.from_numpy(x).to(DTYPES[x_dtype][1])
    th = torch.from_numpy(h).to(DTYPES[h_dtype][1])
    tw = torch.from_numpy(w).to(DTYPES[w_dtype][1])
    s, got = RN.add_rmsnorm_plain(tx, th, tw)
    js = jx + jh
    out = "float32" if "float32" in (x_dtype, h_dtype) else "bfloat16"
    assert s.dtype == got.dtype == DTYPES[out][1] and tuple(got.shape) == shape
    np.testing.assert_array_equal(_np(s), _np(js))  # one rounding of the sum
    np.testing.assert_allclose(_np(got), _np(ops.rmsnorm(js, jw)), **tol(out))
    np.testing.assert_allclose(_np(got), _np(ref.rmsnorm_ref(js, jw)), **tol(out))


@pytest.mark.parametrize("y_dtype,z_dtype,w_dtype", MIXED)
@pytest.mark.parametrize("shape", [(7, 64), (2, 3, 256)])
def test_gated_rmsnorm_plain_matches_pallas_and_ref(shape, y_dtype, z_dtype, w_dtype):
    """The reference's ``rmsnorm(y * jax.nn.silu(z))`` (mamba2's norm_y),
    Pallas (interpret mode) and jnp."""
    y, w = _inputs(shape, seed=shape[-1] + 5)
    z = 2.0 * np.random.default_rng(11).standard_normal(shape, dtype=np.float32)
    jy, jz = jnp.asarray(y, DTYPES[y_dtype][0]), jnp.asarray(z, DTYPES[z_dtype][0])
    jw = jnp.asarray(w, DTYPES[w_dtype][0])
    ty = torch.from_numpy(y).to(DTYPES[y_dtype][1])
    tz = torch.from_numpy(z).to(DTYPES[z_dtype][1])
    tw = torch.from_numpy(w).to(DTYPES[w_dtype][1])
    got = RN.gated_rmsnorm_plain(ty, tz, tw)
    g = jy * jax.nn.silu(jz)
    out = "float32" if "float32" in (y_dtype, z_dtype) else "bfloat16"
    assert got.dtype == DTYPES[out][1] and tuple(got.shape) == shape
    # a bf16 operand: jax.nn.silu rounds its sigmoid to bf16 before the
    # product, torch's silu rounds once, so silu(z) and g differ by a bf16
    # ulp here and there whatever the output dtype
    t = tol("bfloat16" if "bfloat16" in (y_dtype, z_dtype) else "float32")
    np.testing.assert_allclose(_np(got), _np(ops.rmsnorm(g, jw)), **t)
    np.testing.assert_allclose(_np(got), _np(ref.rmsnorm_ref(g, jw)), **t)


def test_fused_wrappers_on_cpu_are_the_plain_versions_and_count_no_launch():
    x, w = (torch.from_numpy(a) for a in _inputs((3, 5, 64), seed=4))
    h = torch.randn(3, 5, 64, generator=torch.Generator().manual_seed(1))
    before = RN.rmsnorm.launches
    s, y = RN.add_rmsnorm(x, h, w)
    s_p, y_p = RN.add_rmsnorm_plain(x, h, w)
    assert torch.equal(s, s_p) and torch.equal(y, y_p)
    assert torch.equal(RN.gated_rmsnorm(x, h, w), RN.gated_rmsnorm_plain(x, h, w))
    assert torch.equal(layers.add_rmsnorm(x, h, w, use_kernel=True)[1],
                       layers.add_rmsnorm(x, h, w)[1])
    assert torch.equal(layers.gated_rmsnorm(x, h, w, use_kernel=True),
                       layers.gated_rmsnorm(x, h, w))
    assert RN.rmsnorm.launches == before


@pytest.mark.parametrize("name", ["add_rmsnorm", "gated_rmsnorm"])
def test_fused_wrappers_raise_off_cpu_and_cuda(name):
    fn = getattr(RN, name)
    before = RN.rmsnorm.launches
    meta = [torch.ones(2, 8, device="meta"), torch.ones(2, 8, device="meta"),
            torch.zeros(8, device="meta")]
    with pytest.raises(ValueError, match="cuda or cpu"):
        fn(*meta)
    assert RN.rmsnorm.launches == before


@pytest.mark.parametrize("h,err", [
    (torch.ones(2, 4), ValueError),  # another shape
    (torch.ones(2, 8, dtype=torch.float16), TypeError),
    (torch.ones(1, 8).expand(3, 8)[:2, :4], ValueError),
])
def test_fused_kernel_path_checks_its_inputs(h, err):
    """What the kernel does not take raises before any build or launch."""
    with pytest.raises(err):
        RN._launch(torch.ones(2, 8), torch.zeros(8), h=h, prologue=RN._ADD)


def test_rows_view_a_column_slice_and_copy_what_does_not_collapse():
    """A column slice (mamba2's z of its in_proj output) is read in place
    with its row stride; a view whose rows do not share one stride is
    copied."""
    wide = torch.randn(2, 3, 40)
    z = wide[..., :16]
    rows, ld = RN._rows(z)
    assert ld == 40 and rows.data_ptr() == z.data_ptr()
    assert torch.equal(rows[:, :16], z.reshape(6, 16))
    x = torch.randn(4, 6, 16).transpose(0, 1)  # (6, 4, 16): no single stride
    rows, ld = RN._rows(x)
    assert ld == 16 and rows.is_contiguous() and torch.equal(rows.view(6, 4, 16), x)
    c = torch.randn(3, 16)
    assert RN._rows(c) == (c, 16)


@pytest.mark.parametrize("prologue", [RN._NONE, RN._ADD, RN._GATE])
def test_fused_kernel_path_raises_on_failure_and_counts_each_launch(monkeypatch,
                                                                    prologue):
    """Each prologue's launch counts once on rmsnorm.launches; a CUDA error
    raises and counts nothing; none falls back to the plain version."""
    x, h, w = torch.ones(3, 16), torch.ones(3, 16), torch.zeros(16)

    class _Stream:
        cuda_stream = 0
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: _Stream())
    before = RN.rmsnorm.launches
    bad = _FakeLib(700)
    monkeypatch.setattr(RN, "_lib", bad)
    h_arg = None if prologue == RN._NONE else h
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        RN._launch(x, w, h=h_arg, prologue=prologue)
    assert bad.calls == 1 and RN.rmsnorm.launches == before
    ok = _FakeLib(0)
    monkeypatch.setattr(RN, "_lib", ok)
    out = RN._launch(x, w, h=h_arg, prologue=prologue)
    assert ok.calls == 1 and RN.rmsnorm.launches == before + 1
    assert isinstance(out, tuple) == (prologue == RN._ADD)
    RN.rmsnorm.launches = before
