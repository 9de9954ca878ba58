"""Per-request workflow specifications (GeoFF §3.2).

A ``WorkflowSpec`` is runtime DATA attached to every invocation — not a
deployment artifact. The client (or a routing optimizer, §5.4) decides the
route per request; the same deployed steps serve different routes without
redeployment ("ad-hoc recomposition"). JSON round-trips so a spec can travel
inside the invocation payload exactly as in the paper.

Each step names: the function to run, the platform to run it on, its
external data dependencies (pre-fetchable), and whether its successor should
be poked (pre-warm + pre-fetch) when this step starts.

Execution-wise a chain is the degenerate DAG: ``Deployment.run`` lifts the
spec via ``repro.dag.spec.DagSpec.from_chain`` onto the dataflow engine, so
this module stays pure data — the protocol lives in one place.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import Optional


@dataclass(frozen=True)
class DataRef:
    """A reference to an object in a region-homed object store."""

    key: str
    store_region: str = ""  # "" = wherever the key currently lives
    size_bytes: int = 0  # advisory (placement/pre-fetch planning)

    def to_json(self):
        return asdict(self)

    @staticmethod
    def from_json(d):
        return DataRef(**d)


@dataclass(frozen=True)
class StepSpec:
    name: str  # function name (must be deployed)
    platform: str  # platform id to invoke on (per-request!)
    data_deps: tuple = ()  # tuple[DataRef] — pre-fetchable inputs
    prefetch: bool = True  # poke successor -> prewarm + prefetch
    sync: bool = False  # synchronous call (native platforms only)
    params: dict = field(default_factory=dict)  # free-form step config

    def to_json(self):
        return {
            "name": self.name,
            "platform": self.platform,
            "data_deps": [d.to_json() for d in self.data_deps],
            "prefetch": self.prefetch,
            "sync": self.sync,
            "params": self.params,
        }

    @staticmethod
    def from_json(d):
        return StepSpec(
            name=d["name"],
            platform=d["platform"],
            data_deps=tuple(DataRef.from_json(x) for x in d.get("data_deps", ())),
            prefetch=d.get("prefetch", True),
            sync=d.get("sync", False),
            params=d.get("params", {}),
        )


@dataclass(frozen=True)
class WorkflowSpec:
    """A chain of steps — the degenerate DAG the dataflow core executes."""

    steps: tuple  # tuple[StepSpec]
    workflow_id: str = ""

    def __post_init__(self):
        assert self.steps, "empty workflow"

    def successor(self, index: int) -> Optional[StepSpec]:
        return self.steps[index + 1] if index + 1 < len(self.steps) else None

    def reroute(self, step_name: str, platform: str) -> "WorkflowSpec":
        """Ad-hoc recomposition: same workflow, one step moved (no redeploy)."""
        steps = tuple(
            StepSpec(s.name, platform, s.data_deps, s.prefetch, s.sync, s.params)
            if s.name == step_name
            else s
            for s in self.steps
        )
        return WorkflowSpec(steps, self.workflow_id)

    def to_json(self) -> str:
        return json.dumps(
            {
                "workflow_id": self.workflow_id,
                "steps": [s.to_json() for s in self.steps],
            }
        )

    @staticmethod
    def from_json(s: str) -> "WorkflowSpec":
        d = json.loads(s)
        return WorkflowSpec(
            tuple(StepSpec.from_json(x) for x in d["steps"]),
            d.get("workflow_id", ""),
        )


@dataclass
class Invocation:
    """What travels between steps: payload + the spec + bookkeeping."""

    spec: WorkflowSpec
    step_index: int
    payload: object
    request_id: str = ""
    t_start: float = 0.0  # workflow start (for end-to-end duration)
