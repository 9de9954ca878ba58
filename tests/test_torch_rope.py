"""The port's rope kernel (``kernels/rope.py``): the wrapper on CPU tensors
against ``layers.rope`` bit for bit, its input checks and failure paths,
its DTensor rule, and ``layers.attention``'s routing by ``cfg.use_pallas``.

Tests marked ``card`` need a CUDA card and skip without one. They hold the
kernel to ``layers.rope`` on the card bit for bit, check that it makes no
synchronising call, and trace a qwen3-1.7b prefill. This file imports no
JAX, so they run on the card with

    PYTHONPATH=src python -m pytest --noconftest -q -m card tests/test_torch_rope.py
"""
import contextlib

import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro_torch.configs.registry import get_config, smoke_config
from repro_torch.kernels import rope as RP
from repro_torch.models import layers

THETAS = (1e4, 5e5, 1e6, 5e6)
SERVED = ("qwen3-1.7b", "recurrentgemma-9b", "granite-moe-3b-a800m", "llama3.2-3b",
          "gemma3-27b", "qwen3-32b", "moonshot-v1-16b-a3b", "llava-next-34b",
          "hubert-xlarge")  # every served model with attention


def _qk(B, T, H, K, d, dtype, seed, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, T, H, d, generator=g).to(dtype)
    k = torch.randn(B, T, K, d, generator=g).to(dtype)
    return q.to(device), k.to(device)


def _positions(B, T, batched, dtype=torch.int32, device="cpu", start=0):
    p = torch.arange(start, start + T, dtype=dtype)
    if batched:  # each row its own offset, as per-slot positions would be
        p = p[None, :] + 7 * torch.arange(B, dtype=dtype)[:, None]
    return p.to(device)


def _bits_equal(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.view(torch.int16 if a.dtype == torch.bfloat16 else torch.int32),
        b.view(torch.int16 if b.dtype == torch.bfloat16 else torch.int32))


# ---------------------------------------------------------------------------
# CPU: the wrapper's plain version
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("theta", THETAS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("d", [16, 64, 80, 128, 256])
def test_wrapper_on_cpu_equals_layers_rope_bitwise(d, batched, dtype, theta):
    B, T, H, K = 2, 9, 4, 2
    q, k = _qk(B, T, H, K, d, dtype, seed=d)
    pos = _positions(B, T, batched, start=1000)
    before = RP.rope_qk.launches
    gq, gk = RP.rope_qk(q, k, pos, theta)
    assert _bits_equal(gq, layers.rope(q, pos, theta))
    assert _bits_equal(gk, layers.rope(k, pos, theta))
    assert RP.rope_qk.launches == before


def test_wrapper_raises_off_cpu_and_cuda():
    q, k = (torch.ones(1, 3, 2, 8, device="meta") for _ in range(2))
    before = RP.rope_qk.launches
    with pytest.raises(ValueError, match="cuda or cpu"):
        RP.rope_qk(q, k, torch.arange(3, device="meta"), 1e4)
    assert RP.rope_qk.launches == before


def test_wrapper_refuses_grad():
    q, k = _qk(1, 3, 2, 1, 8, torch.float32, seed=0)
    with pytest.raises(RuntimeError, match="no backward"):
        RP.rope_qk(q.requires_grad_(), k, torch.arange(3), 1e4)
    with torch.no_grad():
        RP.rope_qk(q, k, torch.arange(3), 1e4)


def _f(*shape, dtype=torch.bfloat16):
    return torch.zeros(*shape, dtype=dtype)


@pytest.mark.parametrize("q,k,pos,err", [
    (_f(1, 4, 2, 7), _f(1, 4, 1, 7), torch.arange(4), ValueError),  # odd d
    (_f(1, 4, 2, 264), _f(1, 4, 1, 264), torch.arange(4), ValueError),  # d > 256
    (_f(1, 4, 2, 8), _f(1, 4, 1, 8), torch.arange(5), ValueError),  # positions' T
    (_f(2, 4, 2, 8), _f(2, 4, 1, 8), torch.zeros(3, 4, dtype=torch.int64),
     ValueError),  # positions' B
    (_f(1, 4, 2, 8, dtype=torch.float16), _f(1, 4, 1, 8, dtype=torch.float16),
     torch.arange(4), TypeError),  # dtype
    (_f(1, 4, 2, 8), _f(1, 4, 1, 8, dtype=torch.float32), torch.arange(4),
     TypeError),  # q and k differ in dtype
    (_f(1, 4, 2, 8), _f(1, 4, 1, 8), torch.arange(4, dtype=torch.float32),
     TypeError),  # positions not integers
    (_f(1, 4, 2, 8), _f(2, 4, 1, 8), torch.arange(4), ValueError),  # B
    (_f(1, 4, 2, 8), _f(1, 4, 1, 16), torch.arange(4), ValueError),  # d
    (_f(1, 4, 2, 8), _f(1, 5, 1, 8), torch.arange(4), ValueError),  # T
    (_f(4, 2, 8), _f(4, 1, 8), torch.arange(4), ValueError),  # no batch dim
])
def test_kernel_path_checks_its_inputs(q, k, pos, err):
    """What the kernel does not take raises before any build or launch."""
    before = RP.rope_qk.launches
    with pytest.raises(err):
        RP._launch(q, k, pos, 1e4)
    assert RP.rope_qk.launches == before


class _FakeLib:
    def __init__(self, err):
        self.calls = []
        self.err = err

    def rope_qk_fwd(self, *a):
        self.calls.append(a)
        return self.err


def test_failed_build_or_launch_raises_and_never_falls_back(monkeypatch):
    """The kernel path (what a CUDA tensor takes) raises when the build
    fails or the launch returns a CUDA error, counts nothing, and does not
    hand back the plain version's result."""
    q, k = _qk(1, 5, 4, 2, 16, torch.bfloat16, seed=3)
    pos = torch.arange(5, dtype=torch.int64)
    before = RP.rope_qk.launches

    class _Stream:
        cuda_stream = 0
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: _Stream())

    def no_nvcc(*a, **kw):
        raise RuntimeError("nvcc not found")
    monkeypatch.setattr(RP, "_lib", None)
    monkeypatch.setattr(RP.build, "load", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc"):
        RP._launch(q, k, pos, 1e4)

    lib = _FakeLib(700)  # cudaErrorIllegalAddress
    monkeypatch.setattr(RP, "_lib", lib)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        RP._launch(q, k, pos, 1e4)
    assert len(lib.calls) == 1 and RP.rope_qk.launches == before

    ok = _FakeLib(0)
    monkeypatch.setattr(RP, "_lib", ok)
    gq, gk = RP._launch(q, k, pos, 5e5)
    (args,) = ok.calls
    # B, T, H, K, d, bf16, int64, unbatched positions, theta as a value
    assert args[5:14] == (1, 5, 4, 2, 16, 1, 1, 0, 5e5)
    assert gq.shape == q.shape and gk.shape == k.shape
    assert RP.rope_qk.launches == before + 1
    RP.rope_qk.launches = before


def test_kernel_path_raises_without_a_card():
    """Without a card (and, here, without nvcc) the kernel path raises; it
    never runs the plain version instead."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    q, k = _qk(1, 3, 2, 1, 8, torch.float32, seed=0)
    before = RP.rope_qk.launches
    with pytest.raises((RuntimeError, ValueError)):
        RP._launch(q, k, torch.arange(3), 1e4)
    assert RP.rope_qk.launches == before


@pytest.mark.parametrize("pos_ndim", [1, 2])
def test_dtensor_rule_takes_batch_and_head_splits_and_refuses_a_sequence_split(
        pos_ndim):
    rule = RP._rule(pos_ndim)
    R, S = Replicate(), Shard
    pos_b = S(0) if pos_ndim == 2 else R
    assert rule((S(0), R, R)) == ((S(0), S(0), pos_b), (S(0), S(0)))
    assert rule((S(2), S(2), R)) == ((S(2), S(2), R), (S(2), S(2)))
    # q split by heads beside replicated kv heads, or nothing split:
    # replicated first
    assert rule((S(2), R, R)) is None and rule((R, R, R)) is None
    for ps in ((S(1), R, R), (R, S(1), R), (R, R, S(pos_ndim - 1))):
        with pytest.raises(ValueError, match="sequence"):
            rule(ps)


# ---------------------------------------------------------------------------
# CPU: layers.attention's routing
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("use_pallas", [False, True])
def test_attention_routes_rope_by_use_pallas(monkeypatch, use_pallas):
    """With ``use_pallas`` q and k go through ``rope_qk`` once a layer; else
    through two ``rope`` calls. Both give the same numbers on the CPU."""
    from repro_torch.models import model as M
    cfg = smoke_config("qwen3-1.7b").replace(use_pallas=use_pallas)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.randint(1, cfg.vocab_size, (1, 12),
                           generator=torch.Generator().manual_seed(1))
    calls = {"rope": 0, "rope_qk": 0}

    def counted(name, fn):
        def call(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return call
    monkeypatch.setattr(layers, "rope", counted("rope", layers.rope))
    monkeypatch.setattr(layers, "rope_qk", counted("rope_qk", layers.rope_qk))
    with torch.no_grad():
        got, _ = M.prefill(cfg, params, {"tokens": tokens})
    n = cfg.num_layers
    assert calls == ({"rope": 0, "rope_qk": n} if use_pallas
                     else {"rope": 2 * n, "rope_qk": 0})
    monkeypatch.undo()
    with torch.no_grad():
        want, _ = M.prefill(cfg.replace(use_pallas=not use_pallas), params,
                            {"tokens": tokens})
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100)")
    return torch.device("cuda")


def _served_heads():
    """{(H, K, d): [thetas]} over the served models' attention layers."""
    out = {}
    for arch in SERVED:
        cfg = get_config(arch)
        thetas = {cfg.rope_theta} | ({cfg.rope_theta_global} - {0.0})
        out.setdefault((cfg.num_heads, cfg.num_kv_heads, cfg.head_dim), set()).update(
            thetas)
    return sorted((h, sorted(t)) for h, t in out.items())


@pytest.mark.card
@pytest.mark.parametrize("B,T,start", [(1, 1, 0), (1, 24, 0), (1, 1536, 0),
                                       (1, 4096, 0), (4, 1, 3000)])
def test_kernel_equals_layers_rope_bitwise_on_the_card(card, B, T, start):
    """Every served (H, K, d) and theta, bf16 and float32, positions (T,)
    int32 (what ``prefill`` and ``decode_step`` pass) and (B, T) int64; the
    last case is a decode step of 4 slots at position 3000."""
    bad = []
    for (H, K, d), thetas in _served_heads():
        for dtype in (torch.bfloat16, torch.float32):
            q, k = _qk(B, T, H, K, d, dtype, seed=d + T, device=card)
            for theta in thetas:
                for pos in (_positions(B, T, False, torch.int32, card, start),
                            _positions(B, T, True, torch.int64, card, start)):
                    gq, gk = RP.rope_qk(q, k, pos, theta)
                    wq, wk = layers.rope(q, pos, theta), layers.rope(k, pos, theta)
                    for name, g, w in (("q", gq, wq), ("k", gk, wk)):
                        if not _bits_equal(g, w):
                            diff = (g.float() - w.float()).abs()
                            bad.append(
                                f"{name} H{H} K{K} d{d} {dtype} theta {theta} pos "
                                f"{tuple(pos.shape)}: {int((diff > 0).sum())} "
                                f"differ, max {diff.max():.3g}")
    torch.cuda.synchronize()
    assert not bad, "\n".join(bad[:20])


@pytest.mark.card
def test_kernel_makes_no_synchronising_call(card):
    """Under ``set_sync_debug_mode("error")`` a synchronising call raises:
    the plain rope's copy of theta does, ``rope_qk`` does not."""
    q, k = _qk(1, 1536, 64, 8, 128, torch.bfloat16, seed=0, device=card)
    pos = torch.arange(1536, dtype=torch.int32, device=card)
    RP.rope_qk(q, k, pos, 1e6)  # builds and loads the library first
    before = RP.rope_qk.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            RP.rope_qk(q, k, pos, 1e6)
        with pytest.raises(RuntimeError):
            layers.rope(q, pos, 1e6)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert RP.rope_qk.launches == before + 3


@pytest.mark.card
def test_traced_prefill_reads_no_rope_sync_and_launches_once_a_layer(card):
    """A traced qwen3-1.7b prefill (full width and depth) under
    ``use_pallas``: ``sync_s`` 0.0, one ``rope_qk`` launch a layer, and
    last logits equal to an untraced prefill's."""
    from repro_torch import spanhook
    from repro_torch.models import model as M
    from repro_torch.obs import Tracer
    cfg = get_config("qwen3-1.7b").replace(use_pallas=True)
    params = M.init_serving_params(cfg, torch.Generator(card).manual_seed(0), card)
    tokens = torch.randint(1, cfg.vocab_size, (1, 1536), device=card,
                           generator=torch.Generator(card).manual_seed(1))
    with torch.no_grad():
        want, _ = M.prefill(cfg, params, {"tokens": tokens})
        before = RP.rope_qk.launches
        trace = Tracer().begin()
        with spanhook.bind(trace, trace.root):
            got, _ = M.prefill(cfg, params, {"tokens": tokens})
    launched = RP.rope_qk.launches - before
    (d,) = [s for s in trace.spans if s.kind == "dispatch"]
    assert d.attrs["sync_s"] == 0.0 and d.attrs["attention_s"] > 0.0
    assert launched == cfg.num_layers
    assert torch.equal(got, want)
