"""Durable jobs over ``DagDeployment``: idempotent submission, dead
lettering, and an exact submission ledger. A copy of the JAX package's
``jobs/manager.py``: nothing in it depends on a framework.

The engine executes REQUESTS — fire-and-forget, at-most-once, errors
propagate to whoever called ``run``. A production workflow needs JOBS:
submit the same work twice and get one execution; let a request exhaust
its retry budget and get a durable record of the failure instead of a
lost exception. ``JobManager`` is that layer, modeled on the production
Job -> Stage -> Task controller pattern:

  job identity      SHA256 over the workflow's placement-INDEPENDENT
                    content: sorted (step, function) pairs, the edge set,
                    and the payload repr. Recomposition moves steps across
                    platforms without changing what the job computes, so
                    the id survives a cutover — resubmitting after a
                    failover still dedups.
  dedup             re-submitting a COMPLETED job returns the recorded
                    result (counted in ``deduped``), not a re-execution.
                    Re-submitting a RUNNING job joins the in-flight
                    execution and shares its outcome. Re-submitting a
                    DEAD-LETTERED job re-executes: dead letters are a
                    record, not a tombstone.
  dead letter       a job whose execution raised (e.g. an ``InjectedFault``
                    that survived the engine's per-step retry budget) or
                    timed out (``DagResult(status="timeout")``) lands in
                    ``dead_letters`` with the error and request id, and
                    emits a ``job.dead_letter`` control-plane event on the
                    tracer — same ring as ``recompose.decision``.
  exact ledger      every ``submit`` increments ``submitted`` and exactly
                    one of ``kept`` / ``dead_lettered`` (joiners count by
                    the shared execution's final status), so
                    ``kept + dead_lettered == submitted`` holds exactly,
                    under any number of client threads — the chaos-test
                    invariant.

Retry/backoff/hedging live BELOW this layer, in the engine
(``DagDeployment(retry=...)``): the manager decides what a failure means,
the engine decides how hard to try before calling it one.
"""

from __future__ import annotations

import hashlib
import threading
import time
from dataclasses import dataclass, field
from typing import Optional


def job_id(spec, payload) -> str:
    """SHA256 job identity from placement-independent workflow content.

    Two submissions are the same job iff they run the same functions over
    the same DAG shape on the same payload — WHERE each step runs is
    excluded on purpose, so a recomposition (or manual failover) does not
    reset idempotency. The payload participates via ``repr``; callers
    wanting custom identity semantics can pre-hash into the payload.
    """
    ident = (
        sorted((s.name, s.resolved_fn()) for s in spec.steps),
        sorted(spec.edges),
        repr(payload),
    )
    return hashlib.sha256(repr(ident).encode()).hexdigest()[:16]


@dataclass
class Job:
    """One unit of durable work. ``status`` moves running -> completed |
    dead_lettered; ``done`` is set exactly when the status is final."""

    job_id: str
    status: str = "running"
    result: object = None  # DagResult when completed
    error: Optional[str] = None
    attempts: int = 0  # end-to-end executions of this job id
    deduped: int = 0  # submissions served from the record / joined
    done: threading.Event = field(default_factory=threading.Event)


@dataclass(frozen=True)
class DeadLetter:
    """Durable record of one failed execution (budget exhausted, handler
    error, or timeout) — the audit surface the chaos test and the bench
    read back."""

    job_id: str
    error: str
    at: float
    request_id: Optional[str] = None


class JobManager:
    """Idempotent job front-end over a ``DagDeployment`` or
    ``AdaptiveDeployment``.

    With a plain deployment, ``submit(payload, spec=...)`` names the
    workflow per call; with an adaptive deployment the active route-table
    spec is used (identity is placement-independent, so route swaps do not
    fork job ids). ``timeout_s`` bounds every execution, which is what
    keeps ``submit`` a bounded join even for threads that attach to an
    in-flight duplicate.
    """

    def __init__(self, deployment, tracer=None, timeout_s: Optional[float] = 120.0):
        self.deployment = deployment
        self.tracer = tracer if tracer is not None else getattr(
            deployment, "tracer", None
        )
        self.timeout_s = timeout_s
        self._lock = threading.Lock()
        self._jobs: dict = {}  # job_id -> Job (latest execution record)
        self.dead_letters: list = []  # DeadLetter, one per failed execution
        self.stats = {
            "submitted": 0,
            "kept": 0,
            "dead_lettered": 0,
            "deduped": 0,
            "executed": 0,
        }

    def _is_adaptive(self) -> bool:
        return hasattr(self.deployment, "routes")

    def get(self, jid: str) -> Optional[Job]:
        with self._lock:
            return self._jobs.get(jid)

    def submit(self, payload, spec=None, timeout_s: Optional[float] = None) -> Job:
        """Execute (or dedup) one job; blocks until its status is final.

        Exactly one of ``kept``/``dead_lettered`` is incremented per call,
        whichever way the submission resolves — fresh execution, joined
        in-flight duplicate, or recorded result.
        """
        timeout = timeout_s if timeout_s is not None else self.timeout_s
        if self._is_adaptive():
            ident_spec = self.deployment.routes.spec
        elif spec is not None:
            ident_spec = spec
        else:
            raise ValueError("spec is required for a non-adaptive deployment")
        jid = job_id(ident_spec, payload)
        with self._lock:
            self.stats["submitted"] += 1
            job = self._jobs.get(jid)
            if job is not None and job.status == "completed":
                # idempotent replay: the recorded result, not a re-run
                job.deduped += 1
                self.stats["deduped"] += 1
                self.stats["kept"] += 1
                return job
            if job is not None and job.status == "running":
                joined = job
            else:
                # new job, or a dead-lettered one being retried
                joined = None
                job = Job(job_id=jid)
                self._jobs[jid] = job
        if joined is not None:
            # bounded join: the executing thread always finalizes in its
            # ``finally`` and every execution is itself timeout-bounded
            joined.done.wait()
            with self._lock:
                joined.deduped += 1
                self.stats["deduped"] += 1
                if joined.status == "completed":
                    self.stats["kept"] += 1
                else:
                    self.stats["dead_lettered"] += 1
            return joined
        return self._execute(
            job, ident_spec if spec is None else spec, payload, timeout
        )

    def _execute(self, job: Job, spec, payload, timeout) -> Job:
        err: Optional[str] = None
        rid: Optional[str] = None
        result = None
        try:
            if self._is_adaptive():
                result = self.deployment.run(payload, timeout)
            else:
                result = self.deployment.run(spec, payload, timeout)
            rid = result.request_id
            if getattr(result, "status", "ok") != "ok":
                err = result.error or result.status
        except BaseException as exc:
            err = repr(exc)
        finally:
            with self._lock:
                job.attempts += 1
                self.stats["executed"] += 1
                if err is None:
                    job.status = "completed"
                    job.result = result
                    self.stats["kept"] += 1
                else:
                    job.status = "dead_lettered"
                    job.error = err
                    self.stats["dead_lettered"] += 1
                    self.dead_letters.append(
                        DeadLetter(job.job_id, err, time.time(), rid)
                    )
            if err is not None and self.tracer is not None:
                self.tracer.record_event(
                    "job.dead_letter",
                    {"job_id": job.job_id, "error": err, "request_id": rid},
                )
            job.done.set()
        return job

    def snapshot(self) -> dict:
        """Report surface: the ledger plus dead-letter summaries."""
        with self._lock:
            return {
                **self.stats,
                "jobs": len(self._jobs),
                "dead_letters": [
                    {"job_id": d.job_id, "error": d.error, "request_id": d.request_id}
                    for d in self.dead_letters
                ],
            }
