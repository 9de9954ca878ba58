"""Quick smoke of every arch's reduced config: train forward, then prefill
and one decode step. Ends ``ALL OK``.

    PYTHONPATH=src python -m repro_torch.scripts.smoke_models [--device cpu]

Port of ``scripts/smoke_models.py``. With ``use_pallas`` every model kernel
runs on its own family's path: on the card each launches its
CUDA kernel, on the CPU its wrapper runs the plain version. Inputs come
from a numpy seed.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs.registry import ARCH_IDS, smoke_config
from repro_torch.models import model as M
from repro_torch.models.params import check_device

B, T = 2, 32


def smoke_batch(cfg, device, seed: int = 0) -> dict:
    """The reference's batch: zero tokens and labels, normal frames or
    patches where the arch takes them."""
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return torch.as_tensor(rng.standard_normal(shape, dtype=np.float32),
                               device=device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=device)

    if cfg.input_kind == "frames":
        return {"frames": normal(B, T, cfg.d_model), "labels": zeros(B, T)}
    if cfg.input_kind == "tokens+patches":
        P = cfg.num_patches
        return {"tokens": zeros(B, T - P), "patches": normal(B, P, cfg.d_model),
                "labels": zeros(B, T - P)}
    return {"tokens": zeros(B, T), "labels": zeros(B, T)}


def smoke_arch(arch: str, device="cuda") -> dict:
    """One arch: its smoke config (``use_pallas``) with params from seed 0,
    the train forward's loss, then (a decoder) prefill's and one decode
    step's logits, each checked for shape and finiteness. Returns the loss
    and the logits."""
    dev = check_device(device)
    cfg = smoke_config(arch).replace(use_pallas=True)
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    batch = smoke_batch(cfg, dev)
    with torch.no_grad():
        loss, _ = M.forward_train(cfg, params, batch)
        assert bool(torch.isfinite(loss)), (arch, loss)
        out = {"arch": arch, "loss": float(loss)}
        if cfg.supports_decode:
            pf_batch = {k: v for k, v in batch.items() if k != "labels"}
            logits, caches = M.prefill(cfg, params, pf_batch)
            assert tuple(logits.shape) == (B, cfg.vocab_size)
            tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
            # decode one step at the last position (cur_index = T - 1): the
            # prefill cache holds T slots, so this rewrites the last one
            logits2, _ = M.decode_step(cfg, params, tok, caches, T - 1)
            assert tuple(logits2.shape) == (B, cfg.vocab_size)
            assert bool(torch.isfinite(logits2).all()), arch
            out.update(prefill_logits=logits, decode_logits=logits2)
    return out


def main(device="cuda") -> list:
    results = []
    for arch in ARCH_IDS:
        r = smoke_arch(arch, device)
        line = f"{arch:24s} loss={r['loss']:8.4f}"
        if "decode_logits" in r:
            line += "  decode ok"
        print(line)
        results.append(r)
    print("ALL OK")
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda", help="'cpu' to run on the host")
    main(device=ap.parse_args().device)
