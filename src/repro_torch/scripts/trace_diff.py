"""Sim-vs-real critical-path diffing: where does the model disagree?

Runs the §4.2 document workflow twice —

  1. on the real dataflow engine (``repro_torch.examples.
     document_workflow``'s deployment) with an ``obs.Tracer`` attached, and
  2. on the scalar simulator, calibrated step by step from what the real
     trace observed (compute/fetch/cold medians, per-edge transfer seconds,
     estimated poke message latency),

then extracts the critical path of each trace and prints the per-bucket
latency attribution side by side. A large delta in one bucket is a
localized statement about the model ("the simulator's transfer model is
0.3 s optimistic on virus->e_mail"), not "the totals differ".

Both traces are also exported as one Chrome/Perfetto JSON
(``TRACE_docflow.json`` under ``--out-dir``, by default
``experiments/bench_torch/`` under the current directory): load it in
ui.perfetto.dev to see the real and simulated requests as adjacent process
tracks.

    PYTHONPATH=src python -m repro_torch.scripts.trace_diff [--quick] [--device cpu]

Port of ``scripts/trace_diff.py``: the same building blocks by name, the
real engine's platforms on ``device`` (the card by default).
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from repro_torch.examples import document_workflow as dw

OUT_DIR = os.path.join("experiments", "bench_torch")


# -- real engine run ------------------------------------------------------------
def run_real(warm_runs: int = 1, device="cuda"):
    """One traced request through the real document-workflow DAG (after
    ``warm_runs`` untraced warm-up requests). Returns (trace, tracer)."""
    from repro_torch.dag import DagDeployment
    from repro_torch.obs import MetricsRegistry, Tracer

    tracer = Tracer(metrics=MetricsRegistry())
    pdf = dw.make_pdf()
    with dw.deploy_all(
        DagDeployment(dw.build_platforms(device), tracer=tracer)
    ) as dag:
        dw.seed_store(dag.store, np.random.default_rng(dw.STORE_SEED))
        spec = dw.dag_spec(True)
        for _ in range(warm_runs):
            dag.run(spec, pdf)
        tracer.clear()  # keep only the measured request
        dag.run(spec, pdf)
    return tracer.last(), tracer


# -- calibration ----------------------------------------------------------------
def calibrated_sim_trace(real_trace):
    """Simulate the same DAG with every draw pinned to what the real trace
    observed — ``obs.profiler.calibrate`` does the trace -> model
    extraction (cold/compute/fetch medians, per-edge ``transfer_table``,
    estimated poke latency); region metadata comes from the deployment's
    platform registry so unobserved edges still price correctly. Returns
    (trace, simulator). The scalar backend runs on the host: the registry
    is built on the CPU, since only its regions are read."""
    from repro_torch.core import simulator as sm
    from repro_torch.obs import Tracer, calibrate

    reg = dw.build_platforms("cpu")
    world = calibrate(
        real_trace, regions={name: reg.get(name).region for name in reg.names()}
    )
    tracer = Tracer()
    simulator = world.simulator(seed=0)
    spec = sm.ExperimentSpec(
        world.steps,
        edges=world.edges,
        n_requests=1,
        prefetch=world.prefetch,
        tracer=tracer,
    )
    simulator.simulate(spec, backend="scalar")
    return tracer.last(), simulator


# -- diff -----------------------------------------------------------------------
def diff_rows(real_trace, sim_trace) -> dict:
    from repro_torch.obs import BUCKETS, extract_critical_path

    real_cp = extract_critical_path(real_trace)
    sim_cp = extract_critical_path(sim_trace)
    rows = {
        "real_total_s": round(real_cp.total_s, 6),
        "sim_total_s": round(sim_cp.total_s, 6),
        "real_path": "->".join(real_cp.nodes),
        "sim_path": "->".join(sim_cp.nodes),
    }
    ra, sa = real_cp.attribution, sim_cp.attribution
    for bucket in BUCKETS:
        rows[f"real_{bucket}_s"] = round(ra.get(bucket, 0.0), 6)
        rows[f"sim_{bucket}_s"] = round(sa.get(bucket, 0.0), 6)
        rows[f"delta_{bucket}_s"] = round(sa.get(bucket, 0.0) - ra.get(bucket, 0.0), 6)
    return rows


def print_table(rows: dict) -> None:
    from repro_torch.obs import BUCKETS

    print(f"{'bucket':12s} {'real_s':>9s} {'sim_s':>9s} {'delta_s':>9s}")
    for bucket in BUCKETS:
        print(
            f"{bucket:12s} {rows[f'real_{bucket}_s']:9.4f}"
            f" {rows[f'sim_{bucket}_s']:9.4f}"
            f" {rows[f'delta_{bucket}_s']:+9.4f}"
        )
    print(
        f"{'total':12s} {rows['real_total_s']:9.4f} {rows['sim_total_s']:9.4f}"
        f" {rows['sim_total_s'] - rows['real_total_s']:+9.4f}"
    )
    print(f"real path: {rows['real_path']}")
    print(f"sim path:  {rows['sim_path']}")


def main(quick: bool = False, out_dir: str = OUT_DIR, device="cuda") -> dict:
    """Prints the table and writes the Perfetto file; returns the diff rows
    with the file's path under ``"trace_path"``."""
    from repro_torch.obs import write_chrome_trace

    real_trace, tracer = run_real(warm_runs=1 if quick else 2, device=device)
    sim_trace, _ = calibrated_sim_trace(real_trace)
    rows = diff_rows(real_trace, sim_trace)
    print_table(rows)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "TRACE_docflow.json")
    write_chrome_trace(path, [real_trace, sim_trace], tracer=tracer)
    print(f"perfetto trace: {path}")
    return {**rows, "trace_path": path}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--quick", action="store_true", help="single warm-up run")
    ap.add_argument("--out-dir", default=OUT_DIR)
    ap.add_argument("--device", default="cuda", help="'cpu' to run on the host")
    args = ap.parse_args()
    main(quick=args.quick, out_dir=args.out_dir, device=args.device)
