"""DAG simulation facade — the recurrence lives in the unified simulator.

``repro_torch.core.simulator.WorkflowSimulator`` executes one dataflow recurrence
for chains and DAGs (``payload[v] = max over preds of end[u] + transfer``),
mirroring the runtime where the chain deployer is a facade over the
dataflow engine. This module keeps the historical DAG-side names importable
(``DagWorkflowSimulator`` IS the unified simulator) and hosts the
calibrated DAG shapes used by the chain-vs-DAG experiments.
"""

from __future__ import annotations

from repro_torch.core.simulator import (  # noqa: F401
    DagTrace,
    Dist,
    SimStep,
    WorkflowSimulator,
    serialize_chain,
)

# A degenerate subclass kept for its established name: every capability —
# run_request AND run_dag_request — already lives on the unified simulator.
DagWorkflowSimulator = WorkflowSimulator


# ---------------------------------------------------------------------------
# calibrated DAG shapes (the paper's §4.2 workflow, restructured)
# ---------------------------------------------------------------------------
def document_dag_fig4():
    """The Fig-4 document workflow as a real fan-out: after ``check``, the
    virus scan and the OCR don't depend on each other — run them in
    parallel and join at ``e_mail``. Same calibrated distributions as
    ``simulator.document_workflow_fig4`` so the chain serialization of
    these steps IS the paper's chain."""
    steps = [
        SimStep("check", "tinyfaas-edge", compute=Dist(0.22)),
        SimStep("virus", "gcf", compute=Dist(0.30), fetch=Dist(0.32)),
        SimStep("ocr", "lambda-us-east-1", compute=Dist(0.45), fetch=Dist(1.45)),
        SimStep("e_mail", "lambda-us-east-1", compute=Dist(0.20), fetch=Dist(0.85)),
    ]
    edges = [
        ("check", "virus"),
        ("check", "ocr"),
        ("virus", "e_mail"),
        ("ocr", "e_mail"),
    ]
    return steps, edges
