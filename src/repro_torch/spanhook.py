"""Host spans below a step's handler, opened by the code the handler runs.

The engine binds a step's ``compute`` span, with its trace, on the thread
that runs the step's handler (``bind``). Code below the handler, such as
``models.model.prefill``, opens a child span of it (``begin``) and ends it
(``end``) without a handle passed down and without importing the engine
or ``obs``: this module imports nothing of the port, so model code imports
it without a cycle.

A span begun here is the thread's innermost span (``current``) until it
is closed, and carries ``cpu_s``, the seconds the thread ran on a CPU over
the span (``time.thread_time``): below its wall time, the thread waited
off the CPU (the interpreter lock, a blocking call that sleeps; a wait
that spins counts as CPU time). Times are ``time.perf_counter`` seconds,
the engine's clock. With nothing bound, ``begin`` and ``current`` are one
thread-local read each and return None.
"""
from __future__ import annotations

import threading
import time

_tls = threading.local()


class bind:
    """Context manager: ``span`` of ``trace`` (an ``obs.Trace``) is the
    calling thread's bound span; ``trace`` None binds nothing."""

    __slots__ = ("_at", "_prev")

    def __init__(self, trace, span):
        self._at = None if trace is None else (trace, span)

    def __enter__(self):
        self._prev = getattr(_tls, "at", None)
        _tls.at = self._at
        return self

    def __exit__(self, *exc):
        _tls.at = self._prev
        return False


def bound():
    """The calling thread's (trace, innermost span), or None: what a job
    handed to another thread binds there."""
    return getattr(_tls, "at", None)


def current():
    """The calling thread's innermost span (the last one opened and not yet
    closed, else the bound one), or None when nothing is bound."""
    at = getattr(_tls, "at", None)
    return None if at is None else at[1]


def begin(name: str, kind: str):
    """A new child of the thread's innermost span, in its trace, made the
    innermost; None when nothing is bound. End it with ``end``."""
    at = getattr(_tls, "at", None)
    if at is None:
        return None
    trace, parent = at
    span = trace.span(name, kind, parent=parent)
    stack = _tls.__dict__.setdefault("stack", [])
    stack.append((at, time.thread_time()))
    _tls.at = (trace, span)
    return span


def end(span):
    """End ``span``, the innermost one ``begin`` made, with its ``cpu_s``,
    and make its parent the innermost again."""
    cpu = time.thread_time()
    span.end()
    prev, cpu0 = _tls.stack.pop()
    span.attrs["cpu_s"] = cpu - cpu0
    _tls.at = prev
