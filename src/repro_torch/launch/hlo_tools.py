"""Per-device FLOP, collective and memory accounting of an eager program
(the port's counterpart of ``repro/launch/hlo_tools.py``, which parses
XLA's optimized HLO).

``Accounting`` is a dispatch mode. It lets every DTensor op through to
DTensor (returning ``NotImplemented``), so what it sees are the ops each
rank really runs on its local tensors: a matmul's FLOPs from
``torch.utils.flop_counter``'s formulas at the local shapes, each
functional collective (``torch.ops._c10d_functional``) with its result's
bytes and its group, and each result's storage, whose live bytes it
tracks. FLOPs are attributed to the innermost function of the port's model
code on the Python stack (``models.layers.attention``), where the JAX
package attributes a dot to its jaxpr ``op_name``.
"""
from __future__ import annotations

import sys
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

_PKG = "repro_torch."
_SKIP = ("repro_torch.launch.", "repro_torch.kernels.__init__")
_COLLECTIVES = {"all_gather_into_tensor": "all-gather",
                "reduce_scatter_tensor": "reduce-scatter",
                "all_reduce": "all-reduce", "all_to_all_single": "all-to-all",
                "broadcast": "broadcast"}


def _where() -> str:
    """``module.function`` of the innermost frame in the port's code (not
    this package's), e.g. ``models.layers.attention``."""
    f = sys._getframe(2)
    while f is not None:
        name = f.f_globals.get("__name__", "")
        if name.startswith(_PKG) and not name.startswith(_SKIP):
            return f"{name[len(_PKG):]}.{f.f_code.co_name}"
        f = f.f_back
    return "?"


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _is_fake(t) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)


class Accounting(TorchDispatchMode):
    """Counts, per rank, while active: ``flops`` {where: FLOPs}, ``bytes``
    (each op's inputs and outputs; views and collectives move none here),
    ``collectives`` [{op, bytes, group_size, group}], and, where ``memory``
    is True, the peak of the bytes held by the storages of op results
    (``peak_bytes``). Freed storages are swept out of the count only when
    it passes 1.01 x the peak so far, so the recorded peak is within 1% below
    the true one (a sweep every op made the dry-run's cells 2x slower)."""

    def __init__(self, memory: bool = False):
        super().__init__()
        self.flops = defaultdict(float)
        self.bytes = 0.0
        self.collectives: list = []
        self.memory = memory
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor runs the local ops, seen next
        out = func(*args, **kwargs)
        if any(_is_fake(t) for t in tree_leaves((args, kwargs, out))
               if isinstance(t, torch.Tensor)):
            return out  # DTensor's sharding propagation, not a rank's op
        packet = func.overloadpacket
        if func.namespace == "_c10d_functional":
            if packet.__name__ in _COLLECTIVES:
                self._collective(packet.__name__, args, out)
        elif not func.is_view:
            self.bytes += sum(_nbytes(t) for t in tree_leaves((args, kwargs, out))
                              if isinstance(t, torch.Tensor))
            if packet in flop_registry:
                self.flops[_where()] += float(
                    flop_registry[packet](*args, **kwargs, out_val=out))
        if self.memory:
            self._track(out)
        return out

    def _collective(self, name, args, out):
        from torch.distributed.distributed_c10d import _resolve_process_group
        group = _resolve_process_group(args[-1])
        self.collectives.append({
            "op": _COLLECTIVES[name], "group_size": group.size(),
            "group": args[-1],
            "bytes": sum(_nbytes(t) for t in tree_leaves(out)
                         if isinstance(t, torch.Tensor))})

    def _track(self, out):
        from torch.multiprocessing.reductions import StorageWeakRef
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            if st._cdata not in self._live:
                self._live[st._cdata] = (StorageWeakRef(st), st.nbytes())
                self.live_bytes += st.nbytes()
        if self.live_bytes > 1.01 * self.peak_bytes:
            for key in [k for k, (ref, _) in self._live.items() if ref.expired()]:
                self.live_bytes -= self._live.pop(key)[1]
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)


def dot_flops_by_module(fn, *args, **kwargs) -> dict:
    """{module.function: FLOPs} of the matmuls (and other ops with a
    ``torch.utils.flop_counter`` formula) ``fn(*args, **kwargs)`` runs on
    this rank."""
    with Accounting() as acc:
        fn(*args, **kwargs)
    return dict(acc.flops)


def top_dot_flops(fn, *args, n: int = 25, **kwargs):
    d = dot_flops_by_module(fn, *args, **kwargs)
    return sorted(d.items(), key=lambda kv: -kv[1])[:n]


def total_dot_flops(fn, *args, **kwargs) -> float:
    return sum(dot_flops_by_module(fn, *args, **kwargs).values())
