"""repro_torch.jobs — the durability layer over the DAG engine.

One import surface for everything a failure-aware deployment needs: the
job manager (idempotent ids, dead letters, exact submission ledger), the
fault model shared with the simulator, and the engine-side retry/hedge
policy knobs.
"""

from repro_torch.core.faults import (
    FaultEvent,
    FaultSchedule,
    InjectedFault,
    OutageEvent,
    RetryPolicy,
    availability,
)
from repro_torch.dag.engine import FaultInjector

from repro_torch.jobs.manager import DeadLetter, Job, JobManager, job_id

__all__ = [
    "DeadLetter",
    "FaultEvent",
    "FaultInjector",
    "FaultSchedule",
    "InjectedFault",
    "Job",
    "JobManager",
    "OutageEvent",
    "RetryPolicy",
    "availability",
    "job_id",
]
