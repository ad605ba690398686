"""Production mesh construction.

The port of ``src/repro/launch/mesh.py`` onto ``torch.distributed``:
functions over ``init_device_mesh``, never module-level constants, so
importing this module touches no device or process-group state. The
process group must exist first: ``torchrun`` with NCCL on cards, gloo or
the fake group (the dry run's 256 or 512 ranks in one process) on the
CPU. The mesh's device type follows the group's backend.

Topology:
  single-pod: (data=16, model=16) = 256 ranks; ``model`` is the inner,
              contiguous axis (tensor-parallel collectives stay local).
  multi-pod:  (pod=2, data=16, model=16) = 512 ranks; ``pod`` is the
              outer axis, which only data-parallel gradient reduction
              crosses.
"""
from __future__ import annotations


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    return _mesh(shape, multi_pod)


def make_debug_mesh(*, multi_pod: bool = False):
    """Tiny mesh for multi-process CPU tests: (2,2) or (2,2,2)."""
    shape = (2, 2, 2) if multi_pod else (2, 2)
    return _mesh(shape, multi_pod)


def make_mesh(shape: tuple, axes: tuple):
    """A mesh of ``shape`` named ``axes`` over the process group's ranks
    (``shape``'s product must be the world size)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("initialise a process group before building a "
                           "mesh (torchrun with NCCL, gloo or the fake "
                           "group)")
    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device, tuple(shape), mesh_dim_names=tuple(axes))


def _mesh(shape, multi_pod: bool):
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)
