"""Mesh construction of the port, as the JAX package's
``repro.launch.mesh``. Functions, not module-level meshes, so importing this
module touches no process group.

``make_production_mesh`` is the dry-run's 16x16 (or 2x16x16) mesh on a fake
process group of 256 (or 512) ranks in this one process: collectives are
recorded, never run (``torch.testing._internal.distributed.fake_pg``,
present in torch 2.13). ``make_local_mesh`` is a 1x1 mesh with the same
axis names over one real rank, for the steps on one card.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _init_group(backend: str, world_size: int, store) -> None:
    if dist.is_initialized() and dist.get_backend() == "fake" == backend \
            and dist.get_world_size() != world_size:
        dist.destroy_process_group()      # the other production mesh's
    if dist.is_initialized():
        if dist.get_backend() != backend or \
                dist.get_world_size() != world_size:
            raise RuntimeError(
                f"a {dist.get_backend()} process group of "
                f"{dist.get_world_size()} ranks is already initialised; "
                f"this mesh needs {backend} over {world_size}")
        return
    dist.init_process_group(backend, store=store, rank=0,
                            world_size=world_size)


def make_production_mesh(*, multi_pod: bool = False):
    """(16, 16) ``("data", "model")`` or (2, 16, 16) ``("pod", "data",
    "model")`` over a fake process group of rank 0 of 256 (or 512)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    _init_group("fake", n, FakeStore())
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


def make_local_mesh(device: str = "cuda"):
    """A 1x1 ``("data", "model")`` mesh over one rank: NCCL on the card by
    default, gloo when ``device="cpu"``. Raises when no CUDA device is
    present and the CPU was not asked for."""
    from torch.distributed.device_mesh import init_device_mesh
    if device == "cpu":
        backend = "gloo"
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("make_local_mesh: no CUDA device (pass "
                               "device='cpu' for a gloo mesh)")
        backend = "nccl"
        torch.cuda.set_device(0)
    _init_group(backend, 1, dist.HashStore())
    return init_device_mesh(device, (1, 1), mesh_dim_names=("data", "model"))


def destroy() -> None:
    """Tear down the process group a mesh above set up."""
    if dist.is_initialized():
        dist.destroy_process_group()
