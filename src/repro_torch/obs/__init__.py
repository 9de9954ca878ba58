"""repro_torch.obs — per-request tracing, histogram metrics, critical-path
attribution, SLOs, tail sampling, causal profiling, and Perfetto export.

Port of the JAX package's ``obs``. The observability layer over the GeoFF
engine and simulator: a ``Tracer`` collects per-request span trees from the
real DAG engine and all three simulator backends (scalar, numpy, torch) in
one schema, ``MetricsRegistry`` keeps bounded log-bucketed latency
histograms, ``extract_critical_path`` attributes end-to-end latency to
cold/fetch/compute/transfer/stream-wait/poke-slack, and
``write_chrome_trace`` exports Perfetto JSON. ``WindowedHistogram`` turns
quantiles time-local ("p95 over the last N seconds"),
``SloSpec``/``SloTracker`` evaluate multi-window burn rates and emit
``slo.burn`` events, ``TailSampler`` keeps only the traces worth debugging
(slow / SLO-violating / head-sampled), and ``calibrate``/``WhatIfProfiler``
replay observed traces with virtual speedups to rank what to fix next —
advice the recomposition controller closes the loop on (``trigger="slo"``).

Every module but ``profiler`` is framework-neutral and a copy of its
reference; ``profiler`` replays on the port's simulator, on the card by
default. Spans are stamped on the host clock: an engine handler that
launches CUDA work must return host values or synchronise before it
returns, or its device time lands in whatever span comes next.

``instrument(deployment)`` wires a tracer into a live deployment the same
way ``repro_torch.adapt.attach`` wires telemetry.
"""

from repro_torch.obs.critical_path import (
    BUCKETS,
    CriticalPath,
    Segment,
    extract_critical_path,
)
from repro_torch.obs.metrics import LogHistogram, MetricsRegistry, WindowedHistogram
from repro_torch.obs.perfetto import to_chrome_trace, write_chrome_trace
from repro_torch.obs.profiler import (
    CalibratedWorkflow,
    Intervention,
    WhatIfProfiler,
    calibrate,
    profile_trace,
)
from repro_torch.obs.sampler import TailSampler
from repro_torch.obs.slo import SloSpec, SloTracker
from repro_torch.obs.trace import Span, Trace, Tracer, instrument

__all__ = [
    "BUCKETS",
    "CalibratedWorkflow",
    "CriticalPath",
    "Intervention",
    "LogHistogram",
    "MetricsRegistry",
    "Segment",
    "SloSpec",
    "SloTracker",
    "Span",
    "TailSampler",
    "Trace",
    "Tracer",
    "WhatIfProfiler",
    "WindowedHistogram",
    "calibrate",
    "extract_critical_path",
    "instrument",
    "profile_trace",
    "to_chrome_trace",
    "write_chrome_trace",
]
