"""Hand-written CUDA kernels of the port, with their plain PyTorch versions."""
import torch


def refuse_grad(name: str, *tensors) -> None:
    """Raise where autograd would record a call of kernel ``name``.

    The kernels have no backward, as the Pallas kernels they port have none
    (``jax.grad`` through one fails). A kernel's output has no ``grad_fn``,
    so a graph through it would silently leave out every term behind it;
    the wrapper raises instead, on CUDA and CPU tensors alike, so that a
    CPU run refuses what a run on the card would. Under ``torch.no_grad()``
    or on inputs that do not require grad nothing changes.
    """
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward: an input requires grad. Run it under "
            "torch.no_grad(), or train on the plain path (use_pallas=False), "
            "as the JAX package does")


_DTENSOR = []  # [DTensor], imported at first use


def _dtensor_type():
    if not _DTENSOR:
        from torch.distributed.tensor import DTensor
        _DTENSOR.append(DTensor)
    return _DTENSOR[0]


def on_local_shards(fn, tensors, rule, n_out: int):
    """``fn`` on the local shards of ``tensors`` where one of them is a
    DTensor; None where none is (the caller goes on with them).

    ``rule(placements)`` takes the inputs' placements on one mesh dim and
    returns (the inputs' placements, the outputs' placements) under which
    ``fn`` is independent along that mesh dim, or None. Where it returns
    None, or would split a dim unevenly, every input is replicated along
    that mesh dim first. The inputs are redistributed to the chosen
    placements, ``fn`` runs on the local tensors (so a CUDA kernel launches
    on them as on any other tensor), and each output is wrapped with its
    placements. A plain input is taken as replicated."""
    DTensor = _dtensor_type()
    mesh = next((t.device_mesh for t in tensors if isinstance(t, DTensor)),
                None)
    if mesh is None:
        return None
    from torch.distributed.tensor import Replicate, Shard
    ins = [t if isinstance(t, DTensor) else
           DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
           for t in tensors]
    want_in = [[] for _ in ins]
    want_out = [[] for _ in range(n_out)]
    for j in range(mesh.ndim):
        got = rule(tuple(t.placements[j] for t in ins))
        if got is not None and any(
                isinstance(p, Shard) and t.shape[p.dim] % mesh.size(j)
                for t, p in zip(ins, got[0])):
            got = None
        if got is None:
            got = ((Replicate(),) * len(ins), (Replicate(),) * n_out)
        for acc, p in zip(want_in, got[0]):
            acc.append(p)
        for acc, p in zip(want_out, got[1]):
            acc.append(p)
    local = [(t if tuple(t.placements) == tuple(w) else t.redistribute(mesh, w)
              ).to_local() for t, w in zip(ins, want_in)]
    outs = fn(*local)
    single = not isinstance(outs, tuple)
    wrapped = tuple(DTensor.from_local(o, mesh, w, run_check=False)
                    for o, w in zip((outs,) if single else outs, want_out))
    return wrapped[0] if single else wrapped


def local_call(fn, tensors, rule, n_out: int = 1):
    """``fn(*tensors)``, on the local shards (``on_local_shards``) where one
    of them is a DTensor."""
    out = on_local_shards(fn, tensors, rule, n_out)
    return fn(*tensors) if out is None else out


def shard_dim(p):
    """The tensor dim placement ``p`` shards, or None."""
    from torch.distributed.tensor import Shard
    return p.dim if isinstance(p, Shard) else None


def along(ps, dims, outs):
    """A rule's answer: every input sharded as ``dims`` says (None:
    replicated), and the outputs as ``outs``."""
    from torch.distributed.tensor import Replicate, Shard

    def pl(d):
        return Replicate() if d is None else Shard(d)
    return tuple(pl(d) for d in dims), tuple(pl(d) for d in outs)
