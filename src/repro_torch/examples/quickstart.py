"""Quickstart: deploy a federated GeoFF workflow and watch pre-fetching work.

Three steps across three platforms (edge -> cloud A -> cloud B), the middle
one a real model forward on the card. Run:

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Port of ``examples/quickstart.py``. ``main(cfg=None, params=None,
device=...)`` runs the reference's smoke qwen3-1.7b with weights drawn from
seed 0 unless given a config and its params (plain tensors on ``device``,
as the reference leaves its params unsharded), and returns what it prints
as a dict.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs.registry import smoke_config
from repro_torch.core import (
    DataRef,
    Deployment,
    Platform,
    PlatformRegistry,
    StepSpec,
    WorkflowSpec,
    bind_sharding,
)
from repro_torch.dist import sharding as shd
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import model as M
from repro_torch.models.params import check_device

PROMPT, REROUTED_PROMPT = "hello federated serverless world", "hello again"


def build_platforms(mesh, device="cuda"):
    """Heterogeneous sharding configs: the edge node stays single-device
    (bind_sharding drops the mesh), the cloud regions carry ``mesh`` and
    the decode sharding rules, which the platform wrapper binds as the
    ambient ``use_sharding`` context around every step."""
    reg = PlatformRegistry()
    reg.register(bind_sharding(Platform("edge-berlin", "eu", kind="edge",
                                        native_prefetch=True, device=device)))
    reg.register(bind_sharding(Platform("cloud-us", "us", kind="cloud",
                                        device=device), mesh=mesh))
    reg.register(bind_sharding(Platform("cloud-eu", "eu", kind="cloud",
                                        device=device), mesh=mesh))
    return reg


def seed_table(store):
    """The external data dependency, homed in the US."""
    rng = np.random.default_rng(0)
    store.put("emb/table", rng.normal(size=(256, 64)).astype(np.float32),
              region="us")


def make_handlers(cfg, params, device="cuda"):
    """(tokenize, forward, project): one model, written once, deployable
    anywhere. ``forward`` returns the logits on the host (float32): under a
    cloud's mesh the shard constraints make them a DTensor, gathered whole
    first (``shd.full``), where the reference's ``np.asarray`` gathers a
    sharded array by itself."""
    dev = torch.device(device)

    def tokenize(payload, data):
        toks = np.frombuffer(payload.encode(), np.uint8).astype(np.int32)
        return toks % (cfg.vocab_size - 1) + 1

    def forward(payload, data):
        tokens = torch.as_tensor(payload, device=dev)[None]
        logits, _ = M.prefill(cfg, params, {"tokens": tokens})
        return shd.full(logits)[0].float().cpu().numpy()

    def project(payload, data):
        # pre-fetched while forward ran: onto the platform's card, or as
        # stored (numpy) on a CPU platform
        table = torch.as_tensor(data["emb/table"])
        x = torch.as_tensor(payload[:64], device=table.device)
        return float(x @ table[:64, 0])

    return tokenize, forward, project


def workflow_spec():
    return WorkflowSpec(
        (
            StepSpec("tokenize", "edge-berlin"),
            StepSpec("forward", "cloud-us"),
            StepSpec("project", "cloud-us", data_deps=(DataRef("emb/table", "us"),)),
        ),
        "quickstart",
    )


def main(cfg=None, params=None, device="cuda") -> dict:
    check_device(device)  # raises without CUDA unless asked for the CPU
    cfg = cfg or smoke_config("qwen3-1.7b")
    if params is None:
        gen = torch.Generator(device=device).manual_seed(0)
        params = M.init_params(cfg, gen, device)
    mesh = make_host_mesh(model_parallel=1, device=device)
    with Deployment(build_platforms(mesh, device)) as dep:
        dep.store.enforce_latency = True  # real (slept) transfer time
        dep.store.network.set_link("eu", "us", 0.08, 10e6)
        seed_table(dep.store)

        tokenize, forward, project = make_handlers(cfg, params, device)
        dep.deploy("tokenize", tokenize, ["edge-berlin"])
        dep.deploy("forward", forward, ["cloud-us", "cloud-eu"])
        dep.deploy("project", project, ["cloud-us"])

        # --- the per-request workflow spec (ad-hoc recomposition!) ----------
        wf = workflow_spec()
        r1 = dep.run(wf, PROMPT)  # cold
        r2 = dep.run(wf, PROMPT)  # warm + prefetch
        print(f"cold run:  {r1.total_s * 1e3:8.1f} ms   result={r1.outputs:.4f}")
        print(f"warm run:  {r2.total_s * 1e3:8.1f} ms   result={r2.outputs:.4f}")
        print("per-step timeline (warm):")
        for step, t in r2.timeline.items():
            print(
                f"  {step:10s} warm={t['warm_s'] * 1e3:7.2f}ms "
                f"fetch={t['fetch_s'] * 1e3:7.2f}ms "
                f"compute={t['compute_s'] * 1e3:7.2f}ms"
            )

        # reroute the forward step to the EU cloud — no redeployment
        r3 = dep.run(wf.reroute("forward", "cloud-eu"), REROUTED_PROMPT)
        print(f"rerouted:  {r3.total_s * 1e3:8.1f} ms   (forward now on cloud-eu)")
        print("prefetcher:", dep.prefetcher.stats)
        print("compile cache:", dep.cache.stats)
        return {
            "total_s": {"cold": r1.total_s, "warm": r2.total_s,
                        "rerouted": r3.total_s},
            "outputs": {"cold": r1.outputs, "warm": r2.outputs,
                        "rerouted": r3.outputs},
            "timeline_warm": r2.timeline,
            "prefetcher": dict(dep.prefetcher.stats),
            "compile_cache": dict(dep.cache.stats),
        }


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda", help="'cpu' to run on the host")
    main(device=ap.parse_args().device)
