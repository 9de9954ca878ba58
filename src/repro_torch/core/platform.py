"""Platforms and platform wrappers (GeoFF §3.1).

A ``Platform`` is a named compute location a step can be deployed to: a
GPU (``device="cuda:0"``), a host, or a CPU "edge" node — the analogue of
AWS Lambda / Google Cloud Functions / tinyFaaS in the paper. Platforms carry
a region and capability flags; a ``NetworkModel`` gives inter-region
latency/bandwidth (used by the placement optimizer and the simulator).

The ``PlatformWrapper`` is the paper's platform-specific wrapper: it adapts
a mesh-polymorphic step function to a concrete platform (binds mesh +
sharding rules, and makes the platform's CUDA device current around the
step) so the SAME function code deploys anywhere. ``overhead_s`` measures
the wrapper's own work.

Port of ``repro/core/platform.py``: ``Platform`` gains ``device``, which
defaults to ``"cuda"``; a CUDA platform on a machine without CUDA raises
at construction instead of running on the CPU.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from repro_torch.dist import sharding as shd


@dataclass(frozen=True)
class Platform:
    name: str
    region: str
    kind: str = "cloud"  # cloud | private | edge
    native_prefetch: bool = False  # provider-side poke interception (§4.4)
    allows_sync: bool = True  # public clouds: async only (§4.1)
    cold_start_s: float = 0.5  # modeled cold-start latency
    mesh: Optional[object] = None  # DeviceMesh (None = one device)
    rules: Optional[object] = None  # ShardingRules for this platform
    device: str = "cuda"  # torch device the platform's steps run on

    def __post_init__(self):
        if torch.device(self.device).type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"platform {self.name!r} wants device {self.device!r} but CUDA "
                "is not available; pass device='cpu' to run it on the CPU")

    def executor_key(self):
        return self.name


def bind_sharding(
    platform: Platform, mesh=None, rules=None, workload: str = "decode"
) -> Platform:
    """Attach a mesh + sharding rules to a platform (heterogeneous federation).

    Every platform in a GeoFF deployment can carry its own placement config:
    an edge node is a single device (mesh dropped, everything replicated), a
    cloud region runs the logical-axis rules for its workload — multi-pod
    rules when the mesh has a "pod" axis. The PlatformWrapper then binds the
    pair as the ambient ``use_sharding`` context around every step it runs,
    so the SAME step function deploys to either.
    """
    if platform.kind == "edge":
        mesh = None  # edge nodes are single-device
    if rules is None:
        multi_pod = mesh is not None and "pod" in shd.mesh_shape(mesh)
        rules = shd.rules_for_platform(platform.kind, workload, multi_pod=multi_pod)
    return dataclasses.replace(platform, mesh=mesh, rules=rules)


class NetworkModel:
    """Inter-region RTT/bandwidth. Symmetric; defaults are public-cloud-ish
    medians (calibrated further in core/simulator.py)."""

    def __init__(
        self, rtt_s=None, bandwidth_Bps=None, default_rtt=0.09, default_bw=50e6
    ):
        self._rtt = dict(rtt_s or {})
        self._bw = dict(bandwidth_Bps or {})
        self.default_rtt = default_rtt
        self.default_bw = default_bw

    @staticmethod
    def _key(a, b):
        return (min(a, b), max(a, b))

    def set_link(self, a, b, rtt_s, bw_Bps):
        self._rtt[self._key(a, b)] = rtt_s
        self._bw[self._key(a, b)] = bw_Bps

    def rtt(self, a, b):
        if a == b:
            return 0.001
        return self._rtt.get(self._key(a, b), self.default_rtt)

    def bandwidth(self, a, b):
        if a == b:
            return 10e9
        return self._bw.get(self._key(a, b), self.default_bw)

    def transfer_s(self, a, b, size_bytes):
        return self.rtt(a, b) / 2.0 + size_bytes / self.bandwidth(a, b)


class PlatformRegistry:
    """Deployed platforms + one executor per platform (each FaaS platform
    runs its functions independently — threads model that concurrency, and
    for real GPU steps they give true compute/transfer overlap)."""

    def __init__(self, network: Optional[NetworkModel] = None):
        self._platforms: dict = {}
        self._executors: dict = {}
        self.network = network or NetworkModel()
        self._lock = threading.Lock()

    def register(self, platform: Platform):
        with self._lock:
            self._platforms[platform.name] = platform
            self._executors.setdefault(
                platform.name,
                ThreadPoolExecutor(
                    max_workers=8, thread_name_prefix=f"plat-{platform.name}"
                ),
            )
        return platform

    def get(self, name: str) -> Platform:
        return self._platforms[name]

    def executor(self, name: str) -> ThreadPoolExecutor:
        return self._executors[name]

    def names(self):
        return list(self._platforms)

    def shutdown(self):
        for ex in self._executors.values():
            ex.shutdown(wait=False, cancel_futures=True)


class PlatformWrapper:
    """Adapts one step function to one platform. Call overhead is measured
    and exposed via ``overhead_s``."""

    def __init__(self, platform: Platform, fn: Callable, name: str = ""):
        self.platform = platform
        self.fn = fn
        self.name = name or getattr(fn, "__name__", "step")
        self.calls = 0
        self.overhead_s = 0.0
        # concurrent requests to the same (function, platform) run this
        # wrapper from several executor threads — the counters need a lock
        # (unlocked += lost updates under contention)
        self._stats_lock = threading.Lock()

    def __call__(self, *args, **kwargs):
        t0 = time.perf_counter()
        p = self.platform
        if p.mesh is not None and p.rules is not None:
            ctx = shd.use_sharding(p.mesh, p.rules)
        else:
            ctx = _null_ctx()
        dev = torch.device(p.device)
        dev_ctx = torch.cuda.device(dev) if dev.type == "cuda" else _null_ctx()
        t1 = time.perf_counter()  # wrapper work before user code
        with ctx, dev_ctx:
            out = self.fn(*args, **kwargs)
        with self._stats_lock:
            self.calls += 1
            self.overhead_s += t1 - t0
        return out


class _null_ctx:
    def __enter__(self):
        return None

    def __exit__(self, *a):
        return False
