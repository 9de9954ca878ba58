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
