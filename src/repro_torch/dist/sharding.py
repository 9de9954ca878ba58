"""Logical-axis sharding rules: the single placement source (port of
``repro/dist/sharding.py``).

Every tensor in the codebase names its dimensions with LOGICAL axes
("batch", "embed", "act_ff", ...) instead of mesh axes. This module owns the
table that maps logical axes onto the mesh ("data"/"model", plus "pod"
across pods on the multi-pod mesh), and the resolver that turns (shape,
logical axes, rules, mesh) into a concrete ``PartitionSpec`` and from there
into DTensor placements over a ``torch.distributed.DeviceMesh``.

Layout strategy (H100 meshes, launch/mesh.py):

  params        FSDP over "data" on the embed dim; tensor-parallel over
                "model" on heads / ff / vocab / experts / inner widths.
                The "pod" axis never shards parameters.
  activations   batch over "data" (x "pod" when multi-pod); the act_* width
                axes over "model".
  levers        seq_shard_attn, seq_shard_resid map the relevant seq axes
                onto "model".

``pspec_for`` guarantees a VALID spec for any shape on any mesh: a dim the
mapped mesh axes do not divide replicates, a mesh axis is never used twice
in one spec (the first logical axis wins), and mesh axes the mesh lacks
replicate the dim. ``mesh_shape`` is the one reader of a mesh's
``{name: size}``: a ``DeviceMesh``'s ``.shape`` is a tuple of sizes.

The ambient half (``use_sharding`` / ``current_sharding`` / ``shard``) lets
model code state constraints without threading mesh and rules through every
call. Contexts nest and are thread-local. ``shard`` returns ``x`` itself
outside a mesh context; under one it redistributes ``x`` (a DTensor, or a
plain tensor taken as replicated) to the resolved placements, which moves
data and never changes values. A ``DeviceMesh`` context also lets plain
tensors (masks, positions) mix with DTensors as replicated values, on the
context's thread only.
"""
from __future__ import annotations

import math
import threading
from dataclasses import dataclass
from typing import Mapping, Optional, Sequence, Tuple, Union

import torch

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
# resolution
# ---------------------------------------------------------------------------
class PartitionSpec(tuple):
    """Per tensor dim: None, a mesh axis name, or a tuple of names (major to
    minor). A tuple, so it compares equal to ``jax.sharding.PartitionSpec``
    with the same entries."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


def mesh_shape(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh`` (its ``mesh_dim_names``
    with its ``shape``), or of anything whose ``.shape`` is such a mapping
    (the tests' fake meshes)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def _axes_of(entry) -> tuple:
    return (entry,) if isinstance(entry, str) else tuple(entry)


def pspec_for(shape: Sequence[int], axes: Sequence[Optional[str]],
              rules: ShardingRules, mesh) -> PartitionSpec:
    """Resolve logical axes to a PartitionSpec that is always valid.

    Per dim (left to right): look the logical axis up in the rules; keep the
    mapping only if every mesh axis exists, none was already used by an
    earlier dim, and their combined size divides the dim; otherwise the dim
    replicates. All-or-nothing per dim: a ("pod", "data") batch never
    degrades to a bare "data" shard, it replicates.
    """
    assert len(shape) == len(axes), (tuple(shape), tuple(axes))
    mshape = mesh_shape(mesh)
    used: set = set()
    parts: list = []
    for dim, logical in zip(shape, axes):
        entry = rules.lookup(logical)
        resolved = None
        if entry is not None:
            mesh_axes = _axes_of(entry)
            if all(a in mshape and a not in used for a in mesh_axes):
                total = math.prod(mshape[a] for a in mesh_axes)
                if total > 0 and dim % total == 0:
                    resolved = (mesh_axes[0] if len(mesh_axes) == 1
                                else mesh_axes)
                    used.update(mesh_axes)
        parts.append(resolved)
    return PartitionSpec(*parts)


def validate_rules(rules: ShardingRules, mesh) -> dict:
    """Which logical axes CAN shard on this mesh? {logical: mesh_axes|None}.
    Purely diagnostic: pspec_for already degrades per tensor."""
    mshape = mesh_shape(mesh)
    out = {}
    for logical, entry in rules.items():
        if entry is None:
            out[logical] = None
            continue
        out[logical] = (entry if all(a in mshape for a in _axes_of(entry))
                        else None)
    return out


def describe(rules: ShardingRules, mesh=None) -> str:
    """Human-readable rule table (README / dry-run logs)."""
    lines = [f"ShardingRules[{rules.name}]"]
    avail = validate_rules(rules, mesh) if mesh is not None else None
    for logical in sorted(rules.table):
        entry = rules.table[logical]
        note = ""
        if avail is not None and entry is not None and avail[logical] is None:
            note = "   (unavailable on this mesh -> replicated)"
        lines.append(f"  {logical:12s} -> {entry!r}{note}")
    return "\n".join(lines)


def placements_for(spec: Sequence, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: one per mesh dim,
    ``Shard(i)`` where tensor dim i's entry names that mesh dim, else
    ``Replicate()``; a mesh dim of size 1 holds the whole tensor and is
    ``Replicate()`` either way. DTensor splits a tensor dim sharded over
    several mesh dims in mesh-dim order, outermost first, so a tuple entry
    must list its axes in the mesh's order: then its local chunk is the one
    JAX gives (major to minor)."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        mesh_axes = _axes_of(entry)
        idx = [names.index(a) for a in mesh_axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} lists mesh axes out of the "
                             f"mesh's order {tuple(names)}")
        for j in idx:
            if mesh.size(j) > 1:
                out[j] = Shard(i)
    return tuple(out)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def full(x):
    """All of ``x``: a DTensor gathered (a collective every rank of its
    mesh joins; a partial sum is reduced), any other value as it is."""
    return x.full_tensor() if is_dtensor(x) else x


def as_dtensor(x, mesh):
    """``x`` as a DTensor on ``mesh``: a DTensor as it is, a plain tensor as
    replicated (every rank holds the same values)."""
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def fsdp_gather(x):
    """A param at its point of use under the ambient rules: whole along the
    mesh dims that shard the batch ("data", "pod"), still split along the
    rest ("model"). Params are stored sharded over the batch dims too
    (FSDP); gathered where used, each rank's matmuls run on its own batch
    rows, and the backward pass reduce-scatters the grad to the stored
    layout. (Left to DTensor's propagation, a matmul of batch-sharded
    activations by an embed-sharded weight gathers the activations
    instead and repeats the whole batch's work on every data rank.)
    ``x`` itself outside a mesh context or for a plain tensor."""
    mesh, rules = current_sharding()
    if mesh is None or rules is None or not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    batch_axes = _axes_of(rules.lookup("batch") or ())
    want = tuple(Replicate() if isinstance(p, Shard) and name in batch_axes
                 else p for name, p in zip(mesh.mesh_dim_names, x.placements))
    return x if want == tuple(x.placements) else x.redistribute(x.device_mesh,
                                                                 want)


def vocab_rows(table, tokens):
    """``table[tokens]``. For a DTensor table split along its rows (the
    vocab), each rank looks up the rows its shard holds, zero elsewhere,
    and the rows are summed over the vocab's mesh dims: the model-parallel
    embedding (``_VocabRows``). Tokens split along a mesh dim that splits
    the vocab are replicated there first; the rows take the tokens' other
    splits. DTensor's own index and embedding rules fail on such a table
    in some torch versions, or mask by the wrong rows once the batch is
    split."""
    if not is_dtensor(table):
        return table[tokens]
    from torch.distributed.tensor import Replicate, Shard
    mesh = table.device_mesh
    vocab = tuple(p == Shard(0) for p in table.placements)
    want = tuple(p if v else Replicate() for p, v in zip(table.placements, vocab))
    if want != tuple(table.placements):
        table = table.redistribute(mesh, want)
    tokens = as_dtensor(tokens, mesh)
    tok_want = tuple(Replicate() if v else p for p, v in zip(tokens.placements, vocab))
    if tok_want != tuple(tokens.placements):
        tokens = tokens.redistribute(mesh, tok_want)
    return _VocabRows.apply(table, tokens, vocab)


class _VocabRows(torch.autograd.Function):
    """Forward: each rank's rows from its vocab shard, all-reduced over the
    vocab's mesh dims (replicated there, split as the tokens elsewhere).
    Backward: each rank scatters the rows' grads of its tokens into its
    shard; that is a partial sum over the mesh dims that split the tokens,
    reduced into the table's placements."""

    @staticmethod
    def forward(ctx, table, tokens, vocab):
        from torch.distributed import _functional_collectives as funcol
        from torch.distributed.tensor import DTensor
        mesh = table.device_mesh
        lo, n = local_slice(table, 0)
        t = tokens.to_local() - lo
        hit = (t >= 0) & (t < n)
        t = t.clamp(0, max(n - 1, 0))
        local = table.to_local()
        rows = local[t] * hit[..., None].to(local.dtype)
        for j, v in enumerate(vocab):
            if v:
                rows = funcol.wait_tensor(funcol.all_reduce(rows, "sum",
                                                            mesh.get_group(j)))
        ctx.save_for_backward(t, hit)
        ctx.meta = (table, tokens.placements)
        return DTensor.from_local(rows, mesh, tokens.placements, run_check=False)

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed.tensor import DTensor, Partial, Shard
        t, hit = ctx.saved_tensors
        table, tok_placements = ctx.meta
        mesh = table.device_mesh
        g = grad.redistribute(mesh, tok_placements).to_local()
        local = table.to_local()
        g_local = torch.zeros(local.shape, dtype=g.dtype, device=g.device)
        g_local.index_put_((t,), g * hit[..., None].to(g.dtype), accumulate=True)
        partial = tuple(Partial() if isinstance(q, Shard) and not p == Shard(0)
                        else p for p, q in zip(table.placements, tok_placements))
        g_table = DTensor.from_local(g_local.to(local.dtype), mesh, partial,
                                     run_check=False)
        return g_table.redistribute(mesh, table.placements), None, None


def redistribute(x, spec: Sequence, mesh):
    """``x`` (a DTensor, or a plain tensor taken as replicated) with the
    placements of ``spec``; ``x`` itself where it has them already."""
    x = as_dtensor(x, mesh)
    placements = placements_for(spec, mesh)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(mesh, placements)


def meta_dtensor(shape, dtype, spec: Sequence, mesh):
    """A DTensor of global ``shape`` in ``spec``'s placements whose local
    tensor is an empty meta tensor of this rank's shard shape."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    placements = placements_for(spec, mesh)
    local, _ = compute_local_shape_and_global_offset(shape, mesh, placements)
    return DTensor.from_local(
        torch.empty(local, dtype=dtype, device="meta"), mesh, placements,
        run_check=False, shape=torch.Size(shape),
        stride=torch.empty(shape, device="meta").stride())


def rows_fit(x, n: int):
    """``x`` ready to have its leading dim regrouped into ``n`` rows (MoE's
    groups back into the batch): a DTensor split along dim 0 into more
    shards than divide ``n`` has that dim replicated first (DTensor's
    reshape of such a split fails in some torch versions)."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    mesh = x.device_mesh
    ways = math.prod(mesh.size(j) for j, p in enumerate(x.placements)
                     if p == Shard(0))
    if n % ways == 0:
        return x
    return x.redistribute(mesh, [Replicate() if p == Shard(0) else p
                                 for p in x.placements])


def local_slice(x, dim: int):
    """(first global index, length) of this rank's shard of DTensor ``x``
    along ``dim``."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    shape, offset = compute_local_shape_and_global_offset(
        x.shape, x.device_mesh, x.placements)
    return offset[dim], shape[dim]


def new_zeros(x, shape, axes=None):
    """``x.new_zeros(shape)``; for a DTensor ``x`` a DTensor of ``shape``
    laid out by the ambient rules for the logical ``axes`` (``x``'s own
    placements where no mesh context is bound or ``axes`` is None)."""
    if not is_dtensor(x):
        return x.new_zeros(shape)
    from torch.distributed.tensor import zeros
    mesh, rules = current_sharding()
    placements = x.placements
    if mesh is not None and rules is not None and axes is not None:
        placements = placements_for(pspec_for(shape, axes, rules, mesh), mesh)
    return zeros(shape, dtype=x.dtype, device_mesh=x.device_mesh,
                 placements=placements)


def write_(dst, dim: int, start: int, src) -> None:
    """``dst.narrow(dim, start, src.shape[dim]).copy_(src)``, in place, also
    where ``dst`` is a DTensor sharded along ``dim``: each rank writes the
    part of the window its own shard holds, into that shard's storage.
    (Slicing a DTensor along a sharded dim gathers it into a new tensor, so
    a plain ``copy_`` into the slice would be lost.) ``src`` is first
    redistributed to ``dst``'s placements with ``dim`` replicated."""
    if not is_dtensor(dst):
        dst.narrow(dim, start, src.shape[dim]).copy_(src)
        return
    from torch.distributed.tensor import Replicate, Shard
    mesh = dst.device_mesh
    want = tuple(Replicate() if p == Shard(dim) else p for p in dst.placements)
    src = as_dtensor(src, mesh)
    if tuple(src.placements) != want:
        src = src.redistribute(mesh, want)
    off, n = local_slice(dst, dim)
    lo, hi = max(start, off), min(start + src.shape[dim], off + n)
    if lo < hi:
        dst.to_local().narrow(dim, lo - off, hi - lo).copy_(
            src.to_local().narrow(dim, lo - start, hi - lo))


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


def _is_device_mesh(mesh) -> bool:
    return getattr(mesh, "mesh_dim_names", None) is not None and hasattr(
        mesh, "get_group")


class use_sharding:
    """Context manager binding (mesh, rules) for the current thread.
    Reusable and reentrant. Over a ``DeviceMesh`` it also lets plain tensors
    mix with DTensors in an op as replicated values (DTensor's implicit
    replication, a per-thread flag restored on exit): the masks and
    positions model code makes are the same on every rank."""

    def __init__(self, mesh, rules):
        self.mesh = mesh
        self.rules = rules
        self._saved = threading.local()

    def __enter__(self):
        _AMBIENT.stack.append((self.mesh, self.rules))
        if _is_device_mesh(self.mesh):
            stack = self._saved.__dict__.setdefault("flags", [])
            stack.append(torch._C._get_dtensor_allow_implicit_replication())
            torch._C._set_dtensor_allow_implicit_replication(True)
        return self

    def __exit__(self, *exc):
        _AMBIENT.stack.pop()
        if _is_device_mesh(self.mesh):
            torch._C._set_dtensor_allow_implicit_replication(
                self._saved.flags.pop())
        return False


def shard_in_place(x, *axes):
    """``shard(x, *axes)`` for a tensor that is written in place (a decode
    cache): ``x`` itself (wrapped as a replicated DTensor if plain, on the
    same storage) where it already has the resolved placements; raises
    where ``shard`` would have to move it into a new tensor, since writes
    to the new one would never reach the caller's."""
    mesh, rules = current_sharding()
    if mesh is None or rules is None:
        return x
    spec = pspec_for(x.shape, axes, rules, mesh)
    want = placements_for(spec, mesh)
    have = (tuple(x.placements) if is_dtensor(x)
            else tuple(placements_for((None,) * x.ndim, mesh)))
    if have != want:
        raise ValueError(
            f"a tensor written in place is laid out as {have}, not as {want} "
            f"(logical axes {axes}); build it in that layout (the prefill's "
            "caches, models.model.spec_zeros or distribute with rules and mesh)")
    return as_dtensor(x, mesh)


def shard(x, *axes):
    """Constrain ``x`` to the ambient sharding: ``x`` itself outside a mesh
    context (not a copy); under a ``DeviceMesh`` ``x`` redistributed to the
    placements of ``pspec_for(x.shape, axes)``, its values unchanged."""
    mesh, rules = current_sharding()
    if mesh is None or rules is None:
        return x
    return redistribute(x, pspec_for(x.shape, axes, rules, mesh), mesh)
