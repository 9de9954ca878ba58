"""GeoFF core, PyTorch port: federated serverless choreography with data
pre-fetching, with steps running on CUDA devices.

  workflow        per-request WorkflowSpec / StepSpec / DataRef
  platform        Platform registry + PlatformWrapper + NetworkModel;
                  a Platform names its torch device ("cuda" by default)
  store           region-homed ObjectStore (S3 stand-in, real payloads)
  choreographer   chain facade over the dataflow core (repro_torch.dag)
  prewarm         CompileCache — the first call on the card as the cold start
  prefetch        future-based data pre-fetching with side-stream copies
  shipping        placement optimizer (exact DAG DP + greedy baseline)
  timing          learned per-edge poke-delay controller
  faults          deterministic transient/outage injection + retry budgets
"""

from repro_torch.core.workflow import (  # noqa: F401
    DataRef,
    Invocation,
    StepSpec,
    WorkflowSpec,
)
from repro_torch.core.platform import (  # noqa: F401
    NetworkModel,
    Platform,
    PlatformRegistry,
    PlatformWrapper,
    bind_sharding,
)
from repro_torch.core.store import ObjectStore, StreamConfig  # noqa: F401
from repro_torch.core.choreographer import Deployment, StepResult  # noqa: F401
from repro_torch.core.prewarm import CompileCache, TensorSpec  # noqa: F401
from repro_torch.core.prefetch import DoubleBuffer, Prefetcher  # noqa: F401
from repro_torch.core.shipping import (  # noqa: F401
    PlacementCosts,
    chain_cost,
    dag_cost,
    place_chain,
    place_dag,
    place_dag_greedy,
)
from repro_torch.core.timing import PokeTimingController  # noqa: F401
from repro_torch.core.faults import (  # noqa: F401
    FaultEvent,
    FaultSchedule,
    InjectedFault,
    OutageEvent,
    RetryPolicy,
    availability,
)
