"""Ops snapshot of the observability control plane, in one page.

Drives a handful of requests through the real document workflow
(``repro_torch.examples.document_workflow``) with the full
``repro_torch.obs`` level-2 stack attached — windowed metrics, an SLO
tracker, tail-based trace sampling — then prints (and writes
``OBS_report.json`` under ``--out-dir``, by default
``experiments/bench_torch/`` under the current directory):

  - the hottest metric series by windowed p99 (what is slow right now,
    not since birth),
  - the SLO's fast/slow burn rates and alert counters,
  - the tail sampler's retention accounting (kept/evicted, threshold),
  - the top-3 what-if profiler recommendations calibrated from the last
    retained trace ("pre-fetch X / stream edge Y / keep Z warm: -N% p95"),
    replayed on the simulator's torch backend on ``device``.

    PYTHONPATH=src python -m repro_torch.scripts.obs_report [--quick] [--device cpu]

Port of ``scripts/obs_report.py``: the same building blocks by name.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from repro_torch.examples import document_workflow as dw

OUT_DIR = os.path.join("experiments", "bench_torch")


def run_workflow(requests: int, device="cuda"):
    """Traced requests through the real document workflow with the level-2
    stack attached. Returns (tracer, slo, registry regions)."""
    from repro_torch.dag import DagDeployment
    from repro_torch.obs import (
        MetricsRegistry,
        SloSpec,
        SloTracker,
        TailSampler,
        Tracer,
    )

    # tight window (seconds of wall clock) so the report is about NOW;
    # min_count low enough that a short demo run arms the slow-trace test
    sampler = TailSampler(window_s=60.0, epochs=10, head_every=4, min_count=4)
    tracer = Tracer(metrics=MetricsRegistry(window_s=60.0), sampler=sampler)
    slo = SloTracker(
        SloSpec(
            "docflow-p95",
            objective_s=1.0,
            target=0.9,
            fast_window_s=10.0,
            slow_window_s=30.0,
            burn_threshold=2.0,
            min_count=4,
        ),
        tracer=tracer,
    )
    pdf = dw.make_pdf()
    with dw.deploy_all(
        DagDeployment(dw.build_platforms(device), tracer=tracer)
    ) as dag:
        dw.seed_store(dag.store, np.random.default_rng(dw.STORE_SEED))
        spec = dw.dag_spec(True)
        for _ in range(requests):
            result = dag.run(spec, pdf)
            slo.record(result.total_s, now=time.perf_counter())
        regions = {name: dag.registry.get(name).region for name in dag.registry.names()}
    return tracer, slo, regions


def build_report(tracer, slo, regions, quick: bool, device="cuda") -> dict:
    from repro_torch.obs import profile_trace

    top_series = [
        {"series": name, "w_p99_s": round(s["w_p99_s"], 6), "w_count": s["w_count"]}
        for name, s in tracer.metrics.top(5, key="w_p99_s")
    ]
    recs = []
    last = tracer.last()
    if last is not None:
        for iv in profile_trace(
            last, regions=regions, top=3, n_requests=60 if quick else 200,
            device=device,
        ):
            recs.append(
                {
                    "label": iv.label,
                    "kind": iv.kind,
                    "target": iv.target,
                    "delta_pct": round(iv.delta_pct, 2),
                    "predicted_p95_s": round(iv.predicted_s, 6),
                }
            )
    return {
        "top_series_by_windowed_p99": top_series,
        "slo": slo.snapshot(),
        "trace_sampler": tracer.sampler.snapshot(),
        "profiler_top3": recs,
    }


def print_report(report: dict) -> None:
    print("== hottest series (windowed p99) ==")
    for row in report["top_series_by_windowed_p99"]:
        print(f"  {row['series']:32s} {row['w_p99_s']:9.4f}s  n={row['w_count']}")
    s = report["slo"]
    print(
        f"== slo {s['slo']} ==  objective={s['objective_s']}s "
        f"burning={s['burning']} fast_burn={s['fast_burn']:.2f} "
        f"slow_burn={s['slow_burn']:.2f} alerts={s['alerts']}"
    )
    t = report["trace_sampler"]
    print(
        f"== tail sampler ==  seen={t['seen']} kept={t['kept']} "
        f"(slow={t['kept_slow']} slo={t['kept_slo']} head={t['kept_head']}) "
        f"evicted={t['evicted']} threshold={t['threshold_s']:.4f}s"
    )
    print("== what to fix next (what-if profiler) ==")
    for rec in report["profiler_top3"]:
        print(f"  {rec['label']}")


def main(quick: bool = False, out_dir: str = OUT_DIR, device="cuda") -> dict:
    tracer, slo, regions = run_workflow(requests=4 if quick else 8, device=device)
    report = build_report(tracer, slo, regions, quick, device=device)
    print_report(report)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "OBS_report.json")
    with open(path, "w") as f:
        json.dump(report, f, indent=1, sort_keys=True, default=str)
    print(f"report: {path}")
    return report


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--quick", action="store_true", help="fewer requests")
    ap.add_argument("--out-dir", default=OUT_DIR)
    ap.add_argument("--device", default="cuda", help="'cpu' to run on the host")
    args = ap.parse_args()
    main(quick=args.quick, out_dir=args.out_dir, device=args.device)
