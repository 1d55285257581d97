"""Meshes, in PyTorch: the port of ``repro/launch/mesh.py``.

``make_production_mesh`` and ``make_mesh`` build a
``torch.distributed`` ``DeviceMesh`` over the ranks of the process group
that the caller started (``torch.distributed.init_process_group``, with its
address, world size and rank).  They are functions, not module constants,
so that importing this module touches no process group.

``fake_world(n)`` stands in for the reference's host device count
(``XLA_FLAGS=--xla_force_host_platform_device_count``): it starts a
``"fake"`` process group of ``n`` ranks in this process, whose collectives
move nothing, so that the dry run (``launch/dryrun.py``) can place meta
DTensors on the 256- and 512-device production meshes.  It is the one
place that imports ``FakeStore``, an internal of torch's test utilities.
A fake group must never share a process with a real one.
"""
from __future__ import annotations

import math
from typing import Sequence


def fake_world(n: int) -> None:
    """Start a fake process group of ``n`` ranks (this process rank 0); a
    no-op when one of ``n`` ranks is already up."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == n:
            return
        raise RuntimeError(f"fake_world({n}): a process group of "
                           f"{dist.get_world_size()} ranks "
                           f"({dist.get_backend()}) is already up")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def _world() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 0


def _device_mesh(shape: Sequence[int], axes: Sequence[str], device: str):
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    n = math.prod(shape)
    ranks = torch.arange(n, dtype=torch.int64).reshape(tuple(shape))
    return DeviceMesh(device, ranks, mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """The reference's (16, 16) ``("data", "model")`` mesh, or (2, 16, 16)
    ``("pod", "data", "model")`` with ``multi_pod``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    world = _world()
    if world < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} devices, found {world}; run under "
            f"fake_world({n}) (dryrun.py starts it)")
    return _device_mesh(shape, axes, device)


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device: str = "cuda"):
    """A mesh of the first prod(shape) ranks, for training and for elastic
    re-meshing (``runtime/elastic.py``); on the cards unless ``device``
    asks for the CPU."""
    n = math.prod(shape)
    world = _world()
    if world < n:
        raise RuntimeError(f"need {n} devices, have {world}")
    return _device_mesh(shape, axes, device)
