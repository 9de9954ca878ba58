"""repro_torch.dag — the dataflow execution core (chains are degenerate DAGs).

  spec     DagSpec / DagStep — per-request DAG routing (JSON round-trip,
           topological validation, from_chain lift, place_dag wiring)
  engine   DagDeployment — the one dataflow executor: pokes cascade along
           edges, nodes fire when their last predecessor payload lands,
           branches run concurrently on the platform executors

The JAX package's simulator facade (``repro.dag.sim``) is not ported yet.
"""

from repro_torch.dag.spec import DagSpec, DagStep, place_dag_spec  # noqa: F401
from repro_torch.dag.engine import DagDeployment, DagResult, DeployedFn  # noqa: F401
