"""Device meshes over NVIDIA H100s (port of ``repro/launch/mesh.py``).

``make_host_mesh`` is a ``("data", "model")`` ``DeviceMesh`` over the
ranks of this process's default process group: one rank per GPU under
``torchrun``, the tests' gloo ranks on the CPU, or, where no group exists,
a one-rank group this function starts itself (NCCL on cuda, gloo on cpu,
over an in-process ``HashStore``), so one process on one card needs no
launcher and no environment variables.

``make_production_mesh`` is for the dry-run only: a mesh over a FAKE
process group of 256 or 512 ranks, whose collectives move nothing. The
geometry is the H100 fleet's:

  single pod:  (data=32, model=8)        = 256 GPUs. "model" is the 8-GPU
               NVLink domain of one DGX H100 node; 32 nodes are one DGX
               SuperPOD scalable unit on the InfiniBand fabric.
  multi-pod:   (pod=2, data=32, model=8) = 512 GPUs. Gradient reduction over
               "pod" is the only collective between the two units.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.models.params import check_device

SINGLE_POD = ((32, 8), ("data", "model"))
MULTI_POD = ((2, 32, 8), ("pod", "data", "model"))

# H100 SXM5 constants for the roofline terms (per GPU).
PEAK_FLOPS_BF16 = 989e12  # FLOP/s, dense bf16 (NVIDIA H100 SXM5 datasheet)
HBM_BW = 3.35e12  # B/s, HBM3 (NVIDIA H100 SXM5 datasheet)
HBM_BYTES = 80e9  # B, HBM3 capacity (NVIDIA H100 SXM5 datasheet: 80 GB)
NVLINK_BW = 450e9  # B/s per direction per GPU, NVLink 4 (H100 SXM5 datasheet)
IB_BW = 50e9  # B/s per GPU: one ConnectX-7 400 Gb/s NDR port per GPU
#               (DGX H100 user guide)


def _ensure_group(device: torch.device) -> None:
    """A one-rank default process group where none exists."""
    if dist.is_initialized():
        return
    backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)


def make_host_mesh(model_parallel: int = 1, device="cuda"):
    """A ``(data, model)`` mesh over the ranks of the default process group
    (a one-rank group is started where there is none): ``data = world //
    model_parallel``. On cuda each rank's GPU is ``cuda:<rank % count>``.
    Raises where ``device`` names CUDA and there is none."""
    from torch.distributed.device_mesh import DeviceMesh
    dev = check_device(device)
    _ensure_group(dev)
    n = dist.get_world_size()
    if model_parallel < 1 or n % model_parallel:
        raise ValueError(f"model_parallel={model_parallel} does not divide the "
                         f"{n} ranks of the process group")
    if dev.type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return DeviceMesh(dev.type,
                      torch.arange(n).reshape(n // model_parallel, model_parallel),
                      mesh_dim_names=("data", "model"))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cpu"):
    """The 256- or 512-GPU mesh on a fake process group (dry-run only: this
    process becomes rank 0 of a group whose collectives do nothing). Starts
    the fake group (replacing a fake group of the other size), so it cannot
    share a process with a real one."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    shape, names = MULTI_POD if multi_pod else SINGLE_POD
    n = math.prod(shape)
    if dist.is_initialized() and dist.get_backend() != "fake":
        raise RuntimeError(
            f"the production mesh needs a fake process group of {n} ranks; "
            f"this process already has a {dist.get_backend()} group")
    if dist.is_initialized() and dist.get_world_size() != n:
        dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=names)
