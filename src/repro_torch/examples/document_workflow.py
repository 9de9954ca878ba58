"""The paper's document-processing workflow (§4.2) on the real middleware,
as a fan-out DAG: after ``check``, the virus scan and the OCR do not depend
on each other, so they run in parallel and join at ``e_mail`` (check ->
virus || ocr -> e_mail). Real handlers (a PDF check, a byte scan, a small
conv "OCR" model in float32 on the platform's device, an e-mail join) and
enforced network latencies.

Compares, on the same deployment:
  - the DAG with pre-fetching (branches overlap, fetches hidden),
  - the DAG without pre-fetching (parallel branches only),
  - the chain serialization of the same steps (the paper's §4.2 shape),
and the automated DAG placement (``place_dag`` wired into ``DagSpec``) that
ships OCR next to its data (§4.3/§5.3). Then prices the same workflow at
paper scale with the simulator: the numpy backend, and a placement sweep on
the torch backend (on the card, its cold-start scan is the ``cold_scan``
kernel).

    PYTHONPATH=src python -m repro_torch.examples.document_workflow [--device cpu]

Port of ``examples/document_workflow.py``: the same building blocks by
name; ``main`` returns what it prints as a dict.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import replace as dc_replace

import numpy as np
import torch

from repro_torch.core import DataRef, Deployment, Platform, PlatformRegistry
from repro_torch.core.shipping import PlacementCosts
from repro_torch.core.workflow import StepSpec, WorkflowSpec
from repro_torch.dag import DagDeployment, DagSpec, DagStep, place_dag_spec

PDF_SEED, STORE_SEED = 7, 11


def build_platforms(device="cuda"):
    """The four platforms, each running its steps on ``device``."""
    reg = PlatformRegistry()
    reg.register(Platform("tinyfaas-edge", "eu", kind="edge", native_prefetch=True,
                          device=device))
    reg.register(Platform("gcf", "eu", kind="cloud", device=device))
    reg.register(Platform("lambda-us", "us", kind="cloud", device=device))
    reg.register(Platform("lambda-eu", "eu2", kind="cloud", device=device))
    return reg


def make_pdf(seed: int = PDF_SEED) -> bytes:
    rng = np.random.default_rng(seed)
    return b"%PDF-1.7 " + rng.bytes(int(1.2e6))


def seed_store(store, rng):
    store.put("signatures/db", rng.bytes(2_000_000), region="us")
    store.put(
        "ocr/weights",
        rng.normal(size=(512, 8, 16)).astype(np.float32),
        region="us",
    )
    store.put("mail/template", b"Dear user, your document: ", region="us")


def check(payload, data):
    assert payload[:5] == b"%PDF-", "not a pdf"
    time.sleep(0.12)  # render/validate the document
    return payload


def virus(payload, data):
    db = data["signatures/db"]
    sig = db[:64]  # byte-scan against the signature db
    time.sleep(0.1)  # scan engine startup
    return {"clean": payload.find(sig) < 0}


def ocr(payload, data):
    """A conv "OCR" on the rendered 64x64 page: its 8x8 patches against the
    first 8 filters of the weights, in float32 on the device the weights
    were pre-fetched to (the platform's)."""
    w = torch.as_tensor(data["ocr/weights"])[:8]
    page = 64 * 64
    img = torch.as_tensor(
        np.frombuffer(payload[:page], np.uint8).reshape(64, 64).astype(np.float32),
        device=w.device,
    )
    patches = img.reshape(8, 8, 8, 8).permute(0, 2, 1, 3).reshape(64, 64)
    feats = torch.einsum("pq,qkc->pkc", patches[:, :8], w)
    return {"text": float(torch.relu(feats).sum())}  # a host value


def e_mail(payload, data):
    # fan-in: payload = {"virus": ..., "ocr": ...}
    template = data["mail/template"]
    return (
        template.decode()
        + f"{payload['ocr']['text']:.1f} (clean={payload['virus']['clean']})"
    )


def dag_spec(prefetch=True, ocr_platform="lambda-us"):
    return DagSpec(
        (
            DagStep("check", "tinyfaas-edge", prefetch=prefetch),
            DagStep(
                "virus",
                "gcf",
                data_deps=(DataRef("signatures/db", "us", 2_000_000),),
                prefetch=prefetch,
            ),
            DagStep(
                "ocr",
                ocr_platform,
                data_deps=(DataRef("ocr/weights", "us", 256 * 1024),),
                prefetch=prefetch,
            ),
            DagStep(
                "e_mail",
                "lambda-us",
                data_deps=(DataRef("mail/template", "us"),),
                prefetch=prefetch,
            ),
        ),
        (
            ("check", "virus"),
            ("check", "ocr"),
            ("virus", "e_mail"),
            ("ocr", "e_mail"),
        ),
        "docflow-dag",
    )


def deploy_all(dep):
    dep.store.enforce_latency = True
    for a, b in [("eu", "us"), ("eu2", "us"), ("eu", "eu2")]:
        dep.store.network.set_link(a, b, 0.06, 12e6)
    dep.deploy("check", check, ["tinyfaas-edge"])
    dep.deploy("virus", virus, ["gcf"])
    dep.deploy("ocr", ocr, ["lambda-us", "lambda-eu"])
    dep.deploy("e_mail", e_mail, ["lambda-us"])
    return dep


def placement_costs():
    """The automated placement's model: OCR's fetch is far from lambda-eu."""
    ocr_fetch = {("ocr", "lambda-eu"): 1.9, ("ocr", "lambda-us"): 0.25}
    return PlacementCosts(
        fetch_s=lambda name, p, deps: ocr_fetch.get((name, p), 0.0),
        compute_s=lambda name, p: 0.15,
        transfer_s=lambda a, b, size: 0.05 if a == b else 0.4,
    )


def auto_placed():
    """``place_dag_spec`` over OCR's two platforms, from lambda-eu."""
    return place_dag_spec(
        dag_spec(True, "lambda-eu"), {"ocr": ["lambda-eu", "lambda-us"]},
        placement_costs()
    )


def chain_email(payload, data):  # chain has no fan-in: adapt the join
    return e_mail({"virus": {"clean": True}, "ocr": payload}, data)


def chain_virus(payload, data):  # chain threads the pdf through virus
    virus(payload, data)
    return payload


def deploy_chain(dep):
    """``deploy_all`` with the chain's adapted virus and e-mail steps."""
    deploy_all(dep)
    dep.deploy("e_mail", chain_email, ["lambda-us"])
    dep.deploy("virus", chain_virus, ["gcf"])
    return dep


def chain_spec():
    return WorkflowSpec(
        (
            StepSpec("check", "tinyfaas-edge"),
            StepSpec("virus", "gcf", data_deps=(DataRef("signatures/db", "us"),)),
            StepSpec("ocr", "lambda-us", data_deps=(DataRef("ocr/weights", "us"),)),
            StepSpec(
                "e_mail", "lambda-us", data_deps=(DataRef("mail/template", "us"),)
            ),
        ),
        "docflow",
    )


def simulated(device="cuda") -> dict:
    """The same workflow at paper scale: 3 seeds x 1800 requests on the
    numpy backend, then both OCR placements in one torch sweep on
    ``device``, each beside the numpy backend's run of that placement."""
    from repro_torch.core import simulator as sm

    steps = sm.document_workflow_fig4()
    simspec = sm.ExperimentSpec(steps, n_requests=1800, seeds=(0, 1, 2))
    simulator = sm.WorkflowSimulator(sm.paper_platforms(), seed=0)
    totals = simulator.simulate(simspec, backend="numpy")  # (3, 1800)
    candidates = [
        steps,
        [dc_replace(s, platform="gcf") if s.name == "ocr" else s for s in steps],
    ]
    swept = simulator.simulate_placements(simspec, candidates, device=device)
    numpy_medians = [
        float(np.median(simulator.simulate(dc_replace(simspec, steps=c),
                                           backend="numpy")))
        for c in candidates
    ]
    return {
        "numpy_median_s": float(np.median(totals)),
        "labels": ["ocr@lambda", "ocr@gcf"],
        "sweep_medians_s": [float(np.median(c)) for c in swept.transpose(1, 0, 2)],
        "numpy_placement_medians_s": numpy_medians,
        "sweep_shape": list(swept.shape),
    }


def main(device="cuda") -> dict:
    pdf = make_pdf()
    out = {"device": str(device)}

    # --- the DAG on the dataflow engine --------------------------------------
    with deploy_all(DagDeployment(build_platforms(device))) as dag:
        seed_store(dag.store, np.random.default_rng(STORE_SEED))
        medians, emails = {}, {"dag": [], "chain": []}
        for spec, label in [
            (dag_spec(True), "dag geoff (pre-fetching)"),
            (dag_spec(False), "dag baseline (no poke)"),
        ]:
            emails["dag"].append(dag.run(spec, pdf).outputs)  # warm
            rs = [dag.run(spec, pdf) for _ in range(3)]
            emails["dag"] += [r.outputs for r in rs]
            ts = [r.total_s for r in rs]
            medians[label] = float(np.median(ts))
            print(f"{label:28s} median {np.median(ts) * 1e3:7.1f} ms")
        joins, pokes = dag.stats["joins"], dict(sorted(dag.stats["pokes"].items()))
        print("fan-in joins:", joins, " pokes:", pokes)
        # per-edge slack (the timing controller's learning signal): each of
        # e_mail's two in-edges carries its own gap — virus finishes early,
        # ocr late — which is exactly what per-edge poke delays exploit
        edges = dag.timing.report()["edges"]
        slack = {name: edges[name]["slack_s"] for name in sorted(edges)}
        for name, s in slack.items():
            print(f"  edge {name:18s} slack={s * 1e3:7.1f} ms")

        # automated placement: ship OCR next to its data (§4.3, exact DP)
        placed = auto_placed()
        print("place_dag ships ocr to:", placed.node("ocr").platform)
        rs = [dag.run(placed, pdf) for _ in range(3)]
        emails["dag"] += [r.outputs for r in rs]
        medians["dag auto-placed"] = float(np.median([r.total_s for r in rs]))
        print(f"{'dag auto-placed':28s} median "
              f"{medians['dag auto-placed'] * 1e3:7.1f} ms")

        # where did the milliseconds go? trace one request and attribute
        # its critical path to cold/fetch/compute/transfer/poke-slack
        from repro_torch.obs import Tracer, extract_critical_path, instrument

        tracer = instrument(dag, Tracer())
        emails["dag"].append(dag.run(dag_spec(True), pdf).outputs)
        cp = extract_critical_path(tracer.last())
        print(cp.format())

    # --- the chain serialization (a facade over the same dataflow core) ------
    with deploy_chain(Deployment(build_platforms(device))) as chain:
        seed_store(chain.store, np.random.default_rng(STORE_SEED))
        spec = chain_spec()
        emails["chain"].append(chain.run(spec, pdf).outputs)
        rs = [chain.run(spec, pdf) for _ in range(3)]
        emails["chain"] += [r.outputs for r in rs]
        medians["chain serialization"] = float(np.median([r.total_s for r in rs]))
        print(f"{'chain serialization':28s} median "
              f"{medians['chain serialization'] * 1e3:7.1f} ms")

    # --- the same workflow at paper scale, simulated ---------------------------
    # the numpy backend replays the paper's 30-minute stream in
    # milliseconds; the torch backend runs a whole (seeds x placements x
    # requests) sweep on the device
    sim = simulated(device)
    print(f"{'simulated (numpy, 3 seeds)':28s} median"
          f" {sim['numpy_median_s'] * 1e3:7.1f} ms")
    for label, med, ref in zip(sim["labels"], sim["sweep_medians_s"],
                               sim["numpy_placement_medians_s"]):
        print(f"{'  placement ' + label:28s} median {med * 1e3:7.1f} ms"
              f"  (numpy {ref * 1e3:7.1f} ms)")

    geoff = medians["dag geoff (pre-fetching)"]
    out.update(
        medians_s=medians, joins=joins, pokes=pokes, edge_slack_s=slack,
        placed_ocr=placed.node("ocr").platform, emails=emails,
        critical_path=list(cp.nodes), critical_path_total_s=cp.total_s,
        attribution_s=dict(cp.attribution), sim=sim,
        reduction_vs_no_poke=1.0 - geoff / medians["dag baseline (no poke)"],
        reduction_vs_chain=1.0 - geoff / medians["chain serialization"],
    )
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda", help="'cpu' to run on the host")
    main(device=ap.parse_args().device)
