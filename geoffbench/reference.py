"""The plain reference: a dense GQA decoder's prefill in float32 PyTorch,
with no kernel, cache or batching, layer by layer so that it fits beside
the weights. It imports nothing of the program and reads only what the
benchmark made: the configuration's file, the weights (``weights.py``)
and the requests' inputs (``traffic.py``).

The model, as published for Qwen3 and Llama-style decoders: token
embedding (llava: patch embeddings through a linear projection in front of
the text), then per layer a pre-norm attention block (RMSNorm; q, k, v
projections; Qwen3's per-head RMSNorm of q and k; rotary embedding with
``rope_theta`` on position 0..T-1, halves rotated; causal softmax
attention with kv head j serving query heads j*G..(j+1)*G-1; output
projection; residual add) and a pre-norm SwiGLU MLP (silu(x Wg) * (x Wu)
Wd, residual add); a final RMSNorm and the untied head, at the last
position only. Norm weights act as ``1 + w`` (the port's parametrisation
of the published ``w``). Each departure from the published configs is
listed in the configuration's file.

``precision="fp8"`` is the control: every matmul operand (weights per
output channel, activations per row, q, k, v and the softmax's
probabilities per row) rounded through float8 e4m3 with its own scale,
the step below the configuration's bfloat16.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def _qdq(x: torch.Tensor, dims) -> torch.Tensor:
    """x rounded through float8 e4m3, one scale per slice over ``dims``."""
    s = x.abs().amax(dim=dims, keepdim=True).clamp(min=1e-30) / FP8_MAX
    q = (x / s).clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn)
    return q.to(torch.float32) * s


class _Arith:
    """float32 everywhere, or the fp8 control's rounding of matmul operands."""

    def __init__(self, precision: str):
        if precision not in ("float32", "fp8"):
            raise ValueError(f"precision {precision!r}: float32 or fp8")
        self.fp8 = precision == "fp8"

    def weight(self, w: torch.Tensor, n_in: int) -> torch.Tensor:
        """A weight whose first ``n_in`` dims are its inputs, in float32."""
        w = w.float()
        return _qdq(w, tuple(range(n_in))) if self.fp8 else w

    def act(self, x: torch.Tensor) -> torch.Tensor:
        return _qdq(x, (-1,)) if self.fp8 else x


@contextlib.contextmanager
def _no_tf32():
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


def _attention(q, k, v, ar: _Arith):
    """Causal GQA: q (T, H, d), k/v (T, K, d) -> (T, H, d), one kv head at
    a time."""
    t, h, d = q.shape
    kv = k.shape[1]
    g = h // kv
    q, k, v = ar.act(q), ar.act(k), ar.act(v)
    mask = torch.ones(t, t, dtype=torch.bool, device=q.device).tril_()
    out = torch.empty_like(q)
    for j in range(kv):
        qj = q[:, j * g:(j + 1) * g].permute(1, 0, 2)        # (G, T, d)
        s = (qj @ k[:, j].T) * d ** -0.5                      # (G, T, T)
        s = s.masked_fill_(~mask, float("-inf"))
        p = ar.act(torch.softmax(s, dim=-1))
        out[:, j * g:(j + 1) * g] = (p @ v[:, j]).permute(1, 0, 2)
    return out


def last_logits(arch: dict, weights: dict, inputs: list, precision="float32",
                eps=1e-6) -> list:
    """Float32 logits at the last position of each input.

    ``arch``: a configuration's ``port`` group. ``weights``: the tree of
    ``weights.make``. ``inputs``: dicts with ``tokens`` (int ids) and, for
    a model of patches, ``patches`` ((P, d_model)). Runs layer by layer
    over all inputs, so one layer's weights are in float32 at a time."""
    ar = _Arith(precision)
    blk = weights["blocks"]["cycle"]["p0"]
    H, K, hd = arch["num_heads"], arch["num_kv_heads"], arch["head_dim"]
    theta = float(arch["rope_theta"])
    with torch.no_grad(), _no_tf32():
        emb = weights["embed"]
        xs = []
        for inp in inputs:
            x = ar.act(emb[inp["tokens"].to(emb.device).long()].float())
            if inp.get("patches") is not None:
                pp = ar.weight(weights["patch_proj"], 1)
                x = torch.cat([ar.act(inp["patches"].to(emb.device).float()) @ pp, x])
            xs.append(x)
        for layer in range(arch["num_layers"]):
            w = {k: v[layer] for k, v in blk["mixer"].items()}
            wq = ar.weight(w["wq"], 1).reshape(w["wq"].shape[0], -1)
            wk = ar.weight(w["wk"], 1).reshape(w["wk"].shape[0], -1)
            wv = ar.weight(w["wv"], 1).reshape(w["wv"].shape[0], -1)
            wo = ar.weight(w["wo"], 2).reshape(-1, w["wo"].shape[-1])
            wg = ar.weight(blk["ffn"]["w_gate"][layer], 1)
            wu = ar.weight(blk["ffn"]["w_up"][layer], 1)
            wd = ar.weight(blk["ffn"]["w_down"][layer], 1)
            n1, n2 = blk["norm1"][layer], blk["norm2"][layer]
            for i, x in enumerate(xs):
                t = x.shape[0]
                u = ar.act(rmsnorm(x, n1, eps))
                q = (u @ wq).view(t, H, hd)
                k = (u @ wk).view(t, K, hd)
                v = (u @ wv).view(t, K, hd)
                if arch["qk_norm"]:
                    q = rmsnorm(q, w["q_norm"], eps)
                    k = rmsnorm(k, w["k_norm"], eps)
                a = _attention(rope(q, theta), rope(k, theta), v, ar)
                x = x + ar.act(a.reshape(t, H * hd)) @ wo
                u = ar.act(rmsnorm(x, n2, eps))
                x = x + ar.act(F.silu(u @ wg) * (u @ wu)) @ wd
                xs[i] = x
            del wq, wk, wv, wo, wg, wu, wd
        head = ar.weight(weights["head"], 1)
        return [ar.act(rmsnorm(x[-1], weights["final_norm"], eps)) @ head for x in xs]
