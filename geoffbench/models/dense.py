"""The dense GQA decoder (Qwen3 and Llama-style decoders, and llava's
language model behind its patch projection): its weights as the port's
``param_defs`` lays them out, its plain reference and its counts.

The model, as published: token embedding (llava: patch embeddings through
a linear projection in front of the text), then per layer a pre-norm
attention block (RMSNorm; q, k, v projections; Qwen3's per-head RMSNorm of
q and k; rotary embedding with ``rope_theta`` on position 0..T-1, halves
rotated; causal softmax attention with kv head j serving query heads
j*G..(j+1)*G-1; output projection; residual add) and a pre-norm SwiGLU MLP
(silu(x Wg) * (x Wu) Wd, residual add); a final RMSNorm and the untied
head, at the last position only. Norm weights act as ``1 + w`` (the port's
parametrisation of the published ``w``). Each departure from the published
configs is listed in the configuration's file.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from geoffbench import counts
from geoffbench.reference import Arith, attention, no_tf32, rmsnorm, rope
from geoffbench.weights import NORM_STD


def layout(arch: dict) -> dict:
    """{path: (shape, std)} of every weight, in drawing order, layers
    stacked along a leading axis. Matrices are scaled by their fan-in; the
    embedding has unit rows."""
    L, D = arch["num_layers"], arch["d_model"]
    H, K, hd = arch["num_heads"], arch["num_kv_heads"], arch["head_dim"]
    FF, V = arch["d_ff"], arch["vocab_size"]
    p = "blocks/cycle/p0/"
    out = {
        "embed": ((V, D), 1.0),
        "head": ((D, V), D ** -0.5),
        "final_norm": ((D,), NORM_STD),
        p + "norm1": ((L, D), NORM_STD),
        p + "norm2": ((L, D), NORM_STD),
        p + "mixer/wq": ((L, D, H, hd), D ** -0.5),
        p + "mixer/wk": ((L, D, K, hd), D ** -0.5),
        p + "mixer/wv": ((L, D, K, hd), D ** -0.5),
        p + "mixer/wo": ((L, H, hd, D), (H * hd) ** -0.5),
        p + "ffn/w_gate": ((L, D, FF), D ** -0.5),
        p + "ffn/w_up": ((L, D, FF), D ** -0.5),
        p + "ffn/w_down": ((L, FF, D), FF ** -0.5),
    }
    if arch["qk_norm"]:
        out[p + "mixer/q_norm"] = ((L, hd), NORM_STD)
        out[p + "mixer/k_norm"] = ((L, hd), NORM_STD)
    if arch["input_kind"] == "tokens+patches":
        out["patch_proj"] = ((D, D), D ** -0.5)
    return out


def last_logits(arch: dict, weights: dict, inputs: list, precision="float32",
                eps=1e-6) -> list:
    """Float32 logits at the last position of each input.

    ``weights``: the tree of ``weights.make``. ``inputs``: dicts with
    ``tokens`` (int ids) and, for a model of patches, ``patches``
    ((P, d_model)). Runs layer by layer over all inputs, so one layer's
    weights are in float32 at a time."""
    ar = Arith(precision)
    blk = weights["blocks"]["cycle"]["p0"]
    H, K, hd = arch["num_heads"], arch["num_kv_heads"], arch["head_dim"]
    theta = float(arch["rope_theta"])
    with torch.no_grad(), no_tf32():
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
                a = attention(rope(q, theta), rope(k, theta), v, ar)
                x = x + ar.act(a.reshape(t, H * hd)) @ wo
                u = ar.act(rmsnorm(x, n2, eps))
                x = x + ar.act(F.silu(u @ wg) * (u @ wu)) @ wd
                xs[i] = x
            del wq, wk, wv, wo, wg, wu, wd
        head = ar.weight(weights["head"], 1)
        return [ar.act(rmsnorm(x[-1], weights["final_norm"], eps)) @ head for x in xs]


def prefill_flops(arch: dict, text_len: int, patches: int = 0) -> int:
    """Model operations of one prefill of ``patches + text_len`` positions:
    the q/k/v/o projections, causal attention and the gated MLP of every
    layer, the patch projection, and the head at the last position (the
    only logits a prefill computes). Norms, rope and the embedding gather
    are elementwise and left out."""
    t = text_len + patches
    d, hd, f = arch["d_model"], arch["head_dim"], arch["d_ff"]
    h, k = arch["num_heads"], arch["num_kv_heads"]
    layer = (2 * t * d * (h + 2 * k) * hd       # q, k, v
             + 2 * t * h * hd * d               # o
             + 2 * 3 * t * d * f                # gate, up, down
             + counts.attention_flops(t, h, hd))
    return (arch["num_layers"] * layer + 2 * patches * d * d
            + 2 * d * arch["vocab_size"])


def bounds(arch: dict, text_len: int, patches: int = 0) -> dict:
    """One prefill's least device time in each kernel group: attention,
    one causal call a layer over every position."""
    return {"attention": arch["num_layers"] * counts.attention_bound_s(
        text_len + patches, arch["num_heads"], arch["num_kv_heads"], arch["head_dim"])}
