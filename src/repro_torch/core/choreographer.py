"""The GeoFF chain deployer — a thin facade over the dataflow core.

This repo carries exactly ONE implementation of the choreography protocol
(poke -> prepare off the critical path -> payload): the dataflow engine in
``repro.dag.engine``. The paper's workflows are chains (§3.2), and a chain
is the degenerate DAG — each step's single successor is one edge — so
``Deployment`` keeps the paper-shaped client API (``run(WorkflowSpec)`` ->
``StepResult`` with a per-step timeline) and lifts every request through
``DagSpec.from_chain`` onto ``DagDeployment``'s dataflow loop.

Everything the chain middleware used to do itself happens in the engine,
semantics unchanged:

  1. invoking a step POKES its successor (two-phase protocol, phase 1),
     triggering pre-warm (AOT compile) and data pre-fetch OFF the critical
     path; pokes cascade so every step prepares as soon as the workflow is
     invoked (§5.5 eager default; the learned controller delays per edge);
  2. the step joins its own prepared futures, runs the handler, and sends
     the PAYLOAD (phase 2) — directly on native platforms, buffered through
     the object store on public-cloud platforms (§4.1), one one-shot
     ``__payload__`` key per edge, deleted after the GET;
  3. the deployer packages (handler, wrapper, middleware) per
     (function, platform), so one function definition runs anywhere
     (federated deployment, §3.1) — ``deploy`` is inherited unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.dag.engine import DagDeployment, DeployedFn  # noqa: F401 (compat)
from repro_torch.dag.spec import DagSpec
from repro_torch.core.workflow import WorkflowSpec


@dataclass
class StepResult:
    request_id: str
    outputs: object
    timeline: dict  # step -> {phase: seconds}
    total_s: float


class Deployment(DagDeployment):
    """The GeoFF deployer + client entry point for chain workflows.

    Inherits the deployment surface (``deploy``, ``shutdown``, context
    manager) from the dataflow engine; only ``run`` differs, translating
    the chain ``WorkflowSpec`` request/response shapes.
    """

    def run(
        self, spec: WorkflowSpec, payload, timeout_s: Optional[float] = None
    ) -> StepResult:
        """Invoke the first step with the input and the workflow spec —
        exactly what a GeoFF client sends. Executes on the dataflow core
        (chain = degenerate DAG); the result keeps the chain-era shape,
        including the old synchronous semantics of waiting as long as the
        steps take (pass ``timeout_s`` to bound it)."""
        result = super().run(DagSpec.from_chain(spec), payload, timeout_s)
        return StepResult(
            result.request_id, result.outputs, result.timeline, result.total_s
        )
