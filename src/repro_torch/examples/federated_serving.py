"""Federated serving: prefill/decode disaggregation as a GeoFF workflow.

Two "pods" (platforms): a prefill pod and a decode pod. Each request is a
two-step workflow — prefill builds the KV cache and ships it by reference
through the object store; the decode pod (pre-warmed via the poke) runs
the greedy decode steps. The placement optimizer decides whether decode
should run on the pod holding the cache (function shipping, §4.3/§5.3).
Then the same model under continuous batching (``ServingEngine``).

    PYTHONPATH=src python -m repro_torch.examples.federated_serving [--device cpu]

Port of ``examples/federated_serving.py``. ``main(cfg=None, params=None,
device=...)`` runs the reference's smoke qwen3-1.7b with weights drawn from
seed 0 unless given a config and its params, and returns what it prints as
a dict.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.registry import smoke_config
from repro_torch.core import (
    Deployment,
    Platform,
    PlatformRegistry,
    PlacementCosts,
    StepSpec,
    WorkflowSpec,
    place_chain,
)
from repro_torch.models import model as M
from repro_torch.models.params import check_device
from repro_torch.models.tree import tree_map
from repro_torch.serving import Request, ServingEngine, pad_cache

MAXLEN = 64
DECODE_STEPS = 7  # greedy steps after prefill's first token


def greedy(logits) -> int:
    return int(torch.argmax(logits[0]))


def build_platforms(device="cuda"):
    reg = PlatformRegistry()
    reg.register(Platform("prefill-pod", "us-east", native_prefetch=True,
                          device=device))
    reg.register(Platform("decode-pod", "us-west", native_prefetch=True,
                          device=device))
    return reg


def make_handlers(dep, cfg, params, device="cuda"):
    """(prefill_fn, decode_fn). Prefill pads its caches to ``MAXLEN`` and
    puts them in the store as host tensors (a request's key); decode fetches
    them, copies them to its device and runs ``DECODE_STEPS`` greedy steps
    (the decode step writes the copy in place)."""
    dev = torch.device(device)

    def prefill_fn(payload, data):
        prompt = payload
        tokens = torch.as_tensor(prompt, device=dev)[None]
        logits, caches = M.prefill(cfg, params, {"tokens": tokens})
        caches = pad_cache(caches, MAXLEN, len(prompt), cfg=cfg)
        key = f"kv/{hash(prompt.tobytes()) & 0xFFFF}"
        dep.store.put(key, tree_map(lambda t: t.cpu(), caches), region="us-east")
        return {"first_tok": greedy(logits), "kv_key": key, "pos": len(prompt)}

    def decode_fn(payload, data):
        host_caches, _ = dep.store.get(payload["kv_key"], "us-west")
        caches = tree_map(lambda t: t.to(dev, copy=True), host_caches)
        tok, cur = payload["first_tok"], payload["pos"]
        toks = [tok]
        for _ in range(DECODE_STEPS):
            logits, caches = M.decode_step(
                cfg, params, torch.tensor([[tok]], dtype=torch.int32, device=dev),
                caches, cur)
            tok = greedy(logits)
            toks.append(tok)
            cur += 1
        return toks

    return prefill_fn, decode_fn


def serve_spec():
    return WorkflowSpec(
        (StepSpec("prefill", "prefill-pod"), StepSpec("decode", "decode-pod")),
        "serve",
    )


def placement_costs():
    """The cache ships over DCN if decode runs remote from the cache."""
    return PlacementCosts(
        fetch_s=lambda n, p, d: (
            0.15 if (n, p) == ("decode", "decode-pod") else 0.01
        ),
        compute_s=lambda n, p: 0.2,
        transfer_s=lambda a, b, s: 0.0 if a == b else 0.02,
    )


def main(cfg=None, params=None, device="cuda") -> dict:
    check_device(device)  # raises without CUDA unless asked for the CPU
    cfg = cfg or smoke_config("qwen3-1.7b")
    if params is None:
        gen = torch.Generator(device=device).manual_seed(0)
        params = M.init_params(cfg, gen, device)
    out = {}

    with Deployment(build_platforms(device)) as dep:
        dep.store.network.set_link("us-east", "us-west", 0.02, 200e6)
        prefill_fn, decode_fn = make_handlers(dep, cfg, params, device)
        dep.deploy("prefill", prefill_fn, ["prefill-pod"])
        dep.deploy("decode", decode_fn, ["prefill-pod", "decode-pod"])

        # --- placement: should decode run where the KV cache lives? ---------
        placed = place_chain(serve_spec(), {"decode": ["prefill-pod", "decode-pod"]},
                             placement_costs())
        out["decode_platform"] = placed.steps[1].platform
        print(
            f"placement optimizer: decode -> {placed.steps[1].platform} "
            "(ships the function to the cache)"
        )

        # --- run a few requests through the disaggregated workflow ----------
        rng = np.random.default_rng(0)
        out["requests"] = []
        for i in range(3):
            prompt = rng.integers(1, 200, size=8).astype(np.int32)
            r = dep.run(placed, prompt)
            print(f"req {i}: {r.total_s * 1e3:7.1f} ms tokens={r.outputs}")
            out["requests"].append({"prompt": prompt.tolist(), "tokens": r.outputs,
                                    "total_s": r.total_s})

    # --- same model under the continuous-batching engine -----------------
    print("\ncontinuous batching on one pod:")
    eng = ServingEngine(cfg, params, max_batch=3, max_len=MAXLEN, device=device)
    prompts = [rng.integers(1, 200, size=6).astype(np.int32) for _ in range(6)]
    for i, prompt in enumerate(prompts):
        eng.submit(Request(i, prompt, max_new_tokens=6))
    t0 = time.perf_counter()
    stats = eng.run()
    dt = time.perf_counter() - t0
    print(
        f"  {stats['done']} requests in {dt * 1e3:.0f} ms "
        f"({stats['decode_steps']} decode steps, "
        f"{stats['prefills']} prefills, mean TTFT "
        f"{np.mean(stats['ttft_s']) * 1e3:.0f} ms)"
    )
    out["batching"] = {**stats, "wall_s": dt,
                       "prompts": [p.tolist() for p in prompts]}
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda", help="'cpu' to run on the host")
    main(device=ap.parse_args().device)
