"""Logical-axis sharding rules (minimal port of ``repro/dist/sharding.py``).

Model code names tensor dimensions with LOGICAL axes ("batch", "embed",
"act_ff", ...). The rule tables map them onto mesh axes ("data"/"model",
plus "pod" across pods). This port keeps the tables, ``rules_for_platform``
and the thread-local ambient context (``use_sharding`` /
``current_sharding``) so platforms and model code keep their call shape.

``shard`` is the identity outside a mesh context: the single-card path.
Distribution over a device mesh is later work, so ``shard`` with a mesh
bound raises ``NotImplementedError`` rather than silently replicating.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Mapping, Optional, Tuple, Union

# A logical axis maps to one mesh axis, a tuple of mesh axes (consumed
# together, e.g. batch -> ("pod", "data")), or None (always replicated).
AxisSpec = Union[None, str, Tuple[str, ...]]


# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ShardingRules:
    """An immutable logical-axis -> mesh-axes table.

    ``lookup`` is the only read path; unknown names resolve to None
    (replicated) so new logical axes degrade safely.
    """

    table: Mapping[str, AxisSpec]
    name: str = "custom"

    def lookup(self, logical: Optional[str]) -> AxisSpec:
        if logical is None:
            return None
        return self.table.get(logical)

    def replace(self, **updates: AxisSpec) -> "ShardingRules":
        """A copy with some logical axes remapped (hillclimb lever)."""
        t = dict(self.table)
        t.update(updates)
        return ShardingRules(t, name=self.name + "+")

    def items(self):
        return self.table.items()


# Parameter axes. "layers" is the stacked-layer axis (never sharded);
# "embed" carries the FSDP shard; widths carry tensor parallelism.
_PARAM_TABLE: Mapping[str, AxisSpec] = {
    "layers": None,
    "embed": "data",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "ff": "model",
    "vocab": "model",
    "expert": "model",
    "inner": "model",
    "lru": "model",
    "conv": None,
}

# Activation axes common to every workload.
_ACT_TABLE: Mapping[str, AxisSpec] = {
    "act_heads": "model",
    "act_kv": "model",
    "act_embed": None,
    "act_ff": "model",
    "act_vocab": "model",
    "act_expert": "model",
    "act_inner": "model",
}


def train_rules(*, multi_pod: bool = False, seq_shard_attn: bool = False,
                seq_shard_resid: bool = False) -> ShardingRules:
    """Rules for the train (and prefill) programs."""
    table = dict(_PARAM_TABLE)
    table.update(_ACT_TABLE)
    table.update({
        "batch": ("pod", "data") if multi_pod else "data",
        "seq": "model" if seq_shard_resid else None,
        "attn_seq": "model" if seq_shard_attn else None,
        "cache_seq": "model",
    })
    return ShardingRules(table, name="train" + ("_mp" if multi_pod else ""))


def decode_rules(*, multi_pod: bool = False) -> ShardingRules:
    """Rules for the decode step: KV caches shard their seq dim over
    "model"; the T=1 activation seq axes stay replicated."""
    table = dict(_PARAM_TABLE)
    table.update(_ACT_TABLE)
    table.update({
        "batch": ("pod", "data") if multi_pod else "data",
        "seq": None,
        "attn_seq": None,
        "cache_seq": "model",
    })
    return ShardingRules(table, name="decode" + ("_mp" if multi_pod else ""))


def replicated_rules() -> ShardingRules:
    """Everything replicated — edge platforms / single-device runs."""
    return ShardingRules({}, name="replicated")


def rules_for(kind: str, *, multi_pod: bool = False,
              seq_shard_attn: bool = False,
              seq_shard_resid: bool = False) -> ShardingRules:
    """Rules for a ShapeSpec kind: "train" | "prefill" | "decode"."""
    if kind in ("train", "prefill"):
        return train_rules(multi_pod=multi_pod, seq_shard_attn=seq_shard_attn,
                           seq_shard_resid=seq_shard_resid)
    if kind == "decode":
        return decode_rules(multi_pod=multi_pod)
    raise ValueError(f"unknown workload kind: {kind!r}")


def rules_for_platform(platform_kind: str, workload: str = "decode", *,
                       multi_pod: bool = False) -> ShardingRules:
    """Heterogeneous federation: edge nodes are single-device (everything
    replicated); cloud and private platforms run the mesh rules for their
    workload."""
    if platform_kind == "edge":
        return replicated_rules()
    return rules_for(workload, multi_pod=multi_pod)


# ---------------------------------------------------------------------------
# ambient context
# ---------------------------------------------------------------------------
class _Ambient(threading.local):
    """Per-thread stack of (mesh, rules). Thread-local on purpose: each
    platform runs steps on its own executor threads (core/platform.py)."""

    def __init__(self):
        self.stack = []


_AMBIENT = _Ambient()


def current_sharding():
    """(mesh, rules) of the innermost active context, else (None, None)."""
    if _AMBIENT.stack:
        return _AMBIENT.stack[-1]
    return (None, None)


class use_sharding:
    """Context manager binding (mesh, rules) for the current thread.
    Reusable and reentrant."""

    def __init__(self, mesh, rules):
        self.mesh = mesh
        self.rules = rules

    def __enter__(self):
        _AMBIENT.stack.append((self.mesh, self.rules))
        return self

    def __exit__(self, *exc):
        _AMBIENT.stack.pop()
        return False


def shard(x, *axes):
    """Constrain ``x`` to the ambient sharding; identity (``x`` itself, not
    a copy) outside a mesh context."""
    mesh, rules = current_sharding()
    if mesh is None or rules is None:
        return x
    raise NotImplementedError(
        "shard() under a device mesh: distribution is not ported yet; run "
        "single-card platforms (Platform.mesh=None)")
