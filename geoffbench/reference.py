"""Building blocks of the plain references: float32 PyTorch, with no
kernel, cache or batching. Each configuration's model module
(``models/<name>.py``) composes its model's prefill from these, layer by
layer so that it fits beside the weights. Neither imports anything of the
program; both read only what the benchmark made: the configuration's
file, the weights (``weights.py``) and the requests' inputs
(``traffic.py``).

``Arith("fp8")`` is the control: every matmul operand (weights per output
channel, activations per row, q, k, v and the softmax's probabilities per
row) rounded through float8 e4m3 with its own scale, the step below the
configurations' bfloat16.
"""
from __future__ import annotations

import contextlib

import torch

FP8_MAX = 448.0


def qdq(x: torch.Tensor, dims) -> torch.Tensor:
    """x rounded through float8 e4m3, one scale per slice over ``dims``."""
    s = x.abs().amax(dim=dims, keepdim=True).clamp(min=1e-30) / FP8_MAX
    q = (x / s).clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn)
    return q.to(torch.float32) * s


class Arith:
    """float32 everywhere, or the fp8 control's rounding of matmul operands."""

    def __init__(self, precision: str):
        if precision not in ("float32", "fp8"):
            raise ValueError(f"precision {precision!r}: float32 or fp8")
        self.fp8 = precision == "fp8"

    def weight(self, w: torch.Tensor, n_in: int) -> torch.Tensor:
        """A weight whose first ``n_in`` dims are its inputs, in float32."""
        w = w.float()
        return qdq(w, tuple(range(n_in))) if self.fp8 else w

    def act(self, x: torch.Tensor) -> torch.Tensor:
        return qdq(x, (-1,)) if self.fp8 else x


@contextlib.contextmanager
def no_tf32():
    """float32 matmuls in float32: TF32 off for the reference's duration."""
    mm, cd = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd
        torch.set_float32_matmul_precision(prec)


def rmsnorm(x, w, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * (1.0 + w.float())


def rope(x, theta):
    """x: (T, n, d), position t at row t; the two halves of d rotated."""
    t, _, d = x.shape
    half = d // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float64, device=x.device) / half)
    ang = torch.arange(t, dtype=torch.float64, device=x.device)[:, None] * inv
    cos = torch.cos(ang).float()[:, None, :]
    sin = torch.sin(ang).float()[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, ar: Arith):
    """Causal GQA: q (T, H, d), k (T, K, d), v (T, K, dv) -> (T, H, dv),
    one kv head at a time, scaled by d ** -0.5."""
    t, h, d = q.shape
    kv = k.shape[1]
    g = h // kv
    q, k, v = ar.act(q), ar.act(k), ar.act(v)
    mask = torch.ones(t, t, dtype=torch.bool, device=q.device).tril_()
    out = q.new_empty(t, h, v.shape[-1])
    for j in range(kv):
        qj = q[:, j * g:(j + 1) * g].permute(1, 0, 2)        # (G, T, d)
        s = (qj @ k[:, j].T) * d ** -0.5                      # (G, T, T)
        s = s.masked_fill_(~mask, float("-inf"))
        p = ar.act(torch.softmax(s, dim=-1))
        out[:, j * g:(j + 1) * g] = (p @ v[:, j]).permute(1, 0, 2)
    return out
