"""Per-request DAG workflow specifications (fan-out/fan-in, beyond GeoFF).

GeoFF's workflows are chains (paper §3.2); ``DagSpec`` generalizes the
per-request spec to a directed acyclic graph so branches can execute
concurrently and a step can join several predecessors (the DFlow /
DataFlower dataflow model, PAPERS.md). The design keeps every property the
chain spec had:

  - it is runtime DATA that travels inside the invocation (JSON
    round-trip), so routing stays per-request — ad-hoc recomposition via
    ``reroute`` / ``apply_placement`` needs no redeployment;
  - steps are the same (function, platform, data_deps, prefetch) tuples, so
    every deployed function serves chains and DAGs alike;
  - a chain is just a degenerate DAG: ``DagSpec.from_chain`` lifts any
    existing ``WorkflowSpec`` losslessly — it is how the chain facade
    (``core.choreographer.Deployment``) routes every chain request onto
    the one dataflow engine.

Edges are named pairs of step names. ``__post_init__`` validates the graph
(unique names, known endpoints, no self-loops or duplicates, acyclic), so a
spec that deserializes is a spec the engine can execute.
"""

from __future__ import annotations

import json
from dataclasses import dataclass

from repro_torch.core.shipping import PlacementCosts, place_dag
from repro_torch.core.workflow import StepSpec, WorkflowSpec


@dataclass(frozen=True)
class DagStep(StepSpec):
    """A DAG node: identical runtime contract to a chain ``StepSpec``.

    A node with several in-edges is a fan-in join: the engine buffers each
    predecessor's payload and fires the handler once with
    ``{pred_name: payload}``. Single-predecessor nodes receive the payload
    unwrapped, exactly like a chain step, so chain handlers port unchanged.

    ``fn`` optionally names the deployed function when it differs from the
    node name ("" = same). Node names must be unique per spec, but a
    workflow may invoke the same function at two nodes — ``from_chain``
    relies on this to lift chains that repeat a step.
    """

    fn: str = ""  # deployed function name; "" -> the node name

    def resolved_fn(self) -> str:
        return self.fn or self.name

    def to_json(self):
        d = StepSpec.to_json(self)
        if self.fn:
            d["fn"] = self.fn
        return d

    @staticmethod
    def from_json(d) -> "DagStep":
        s = StepSpec.from_json(d)
        return DagStep(
            s.name,
            s.platform,
            s.data_deps,
            s.prefetch,
            s.sync,
            s.params,
            d.get("fn", ""),
        )

    @staticmethod
    def from_step(s: StepSpec, name: str = "", fn: str = "") -> "DagStep":
        return DagStep(
            name or s.name, s.platform, s.data_deps, s.prefetch, s.sync, s.params, fn
        )


@dataclass(frozen=True)
class DagSpec:
    """A DAG of steps with named edges ``(src_name, dst_name)``."""

    steps: tuple  # tuple[DagStep]
    edges: tuple  # tuple[tuple[str, str]]
    workflow_id: str = ""

    def __post_init__(self):
        if not self.steps:
            raise ValueError("empty workflow")
        names = [s.name for s in self.steps]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate step names: {names}")
        known = set(names)
        seen = set()
        for e in self.edges:
            a, b = e
            if a not in known or b not in known:
                raise ValueError(f"edge {e} references unknown step")
            if a == b:
                raise ValueError(f"self-edge {e}")
            if (a, b) in seen:
                raise ValueError(f"duplicate edge {e}")
            seen.add((a, b))
        # normalize edges to tuples (from_json hands us lists)
        object.__setattr__(self, "edges", tuple((a, b) for a, b in self.edges))
        if len(self.topo_order()) != len(names):
            raise ValueError("workflow graph has a cycle")

    # -- graph accessors -------------------------------------------------------
    def node(self, name: str) -> DagStep:
        for s in self.steps:
            if s.name == name:
                return s
        raise KeyError(name)

    def successors(self, name: str) -> tuple:
        return tuple(b for a, b in self.edges if a == name)

    def predecessors(self, name: str) -> tuple:
        return tuple(a for a, b in self.edges if b == name)

    def sources(self) -> tuple:
        dsts = {b for _, b in self.edges}
        return tuple(s.name for s in self.steps if s.name not in dsts)

    def sinks(self) -> tuple:
        srcs = {a for a, _ in self.edges}
        return tuple(s.name for s in self.steps if s.name not in srcs)

    def topo_order(self) -> tuple:
        """Kahn's algorithm, deterministic: ties broken by ``steps`` order."""
        pos = {s.name: i for i, s in enumerate(self.steps)}
        indeg = {s.name: 0 for s in self.steps}
        for _, b in self.edges:
            indeg[b] += 1
        order = []
        ready = sorted((n for n, d in indeg.items() if d == 0), key=pos.get)
        while ready:
            u = ready.pop(0)
            order.append(u)
            for v in self.successors(u):
                indeg[v] -= 1
                if indeg[v] == 0:
                    ready.append(v)
            ready.sort(key=pos.get)
        return tuple(order)

    # -- recomposition (per-request routing, no redeploy) ----------------------
    def reroute(self, step_name: str, platform: str) -> "DagSpec":
        """Ad-hoc recomposition: same workflow, one step moved."""
        return self.apply_placement({step_name: platform})

    def apply_placement(self, placement: dict, platforms=None) -> "DagSpec":
        """Move every step named in ``placement`` (a ``{name: platform}``
        map, e.g. the output of ``shipping.place_dag``) to its platform.

        Validates its input: a placement naming an unknown step raises
        ``ValueError`` with the offending name, and when ``platforms`` (the
        deployment's platform set, e.g. ``registry.names()``) is given, so
        does a target platform outside it — a hot-swapped route must never
        point at a platform that cannot serve it."""
        known = {s.name for s in self.steps}
        for name in placement:
            if name not in known:
                raise ValueError(
                    f"placement names unknown step {name!r}; "
                    f"steps: {sorted(known)}"
                )
        if platforms is not None:
            allowed = set(platforms)
            for name, platform in placement.items():
                if platform not in allowed:
                    raise ValueError(
                        f"placement moves step {name!r} to unknown platform "
                        f"{platform!r}; platforms: {sorted(allowed)}"
                    )
        steps = tuple(
            DagStep(
                s.name,
                placement.get(s.name, s.platform),
                s.data_deps,
                s.prefetch,
                s.sync,
                s.params,
                s.fn,
            )
            for s in self.steps
        )
        return DagSpec(steps, self.edges, self.workflow_id)

    # -- serialization ---------------------------------------------------------
    def to_json(self) -> str:
        return json.dumps(
            {
                "workflow_id": self.workflow_id,
                "steps": [s.to_json() for s in self.steps],
                "edges": [list(e) for e in self.edges],
            }
        )

    @staticmethod
    def from_json(s: str) -> "DagSpec":
        d = json.loads(s)
        return DagSpec(
            tuple(DagStep.from_json(x) for x in d["steps"]),
            tuple((a, b) for a, b in d.get("edges", ())),
            d.get("workflow_id", ""),
        )

    # -- chain interop ---------------------------------------------------------
    @staticmethod
    def from_chain(wf: WorkflowSpec) -> "DagSpec":
        """Lift a chain ``WorkflowSpec`` into the degenerate DAG.

        Chains may invoke the same function twice (they are positional);
        DAG node names must be unique, so repeated names get an ``@index``
        suffix with ``fn`` pointing back at the deployed function."""
        counts: dict = {}
        for s in wf.steps:
            counts[s.name] = counts.get(s.name, 0) + 1
        steps = []
        for i, s in enumerate(wf.steps):
            if counts[s.name] > 1:
                steps.append(DagStep.from_step(s, name=f"{s.name}@{i}", fn=s.name))
            else:
                steps.append(DagStep.from_step(s))
        names = [s.name for s in steps]
        edges = tuple((names[i], names[i + 1]) for i in range(len(names) - 1))
        return DagSpec(tuple(steps), edges, wf.workflow_id)


def place_dag_spec(
    spec: DagSpec, candidates: dict, costs: PlacementCosts, prefetch: bool = True
) -> DagSpec:
    """Automated placement for a DAG spec (paper §5.3, generalized).

    Runs ``shipping.place_dag`` over the spec's nodes and edges and applies
    the resulting ``{name: platform}`` routes — the DAG analogue of
    ``place_chain`` returning a re-routed spec.
    """
    nodes = {s.name: s for s in spec.steps}
    placement = place_dag(nodes, list(spec.edges), candidates, costs, prefetch)
    return spec.apply_placement(placement)
