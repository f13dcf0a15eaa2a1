"""Mesh construction (the port of the JAX package's ``launch/mesh.py``).

A mesh is a ``torch.distributed`` ``DeviceMesh`` over the initialised
default process group; its ``data`` dimension is the shard axis of the
sharded device waves (``distributed.kvshard.serve_wave_sharded``,
``distributed.rangeshard.range_wave_sharded``).  Functions, not constants:
importing this module touches no device and no process group.

The device is the card unless the caller passes ``device="cpu"``; without
CUDA the card raises.  The backend is never chosen silently: NCCL on the
card, ``gloo`` on the CPU, and ``gloo`` on the card only when the caller
says so (``backend="gloo"``: ranks that share one card, which NCCL
refuses).  ``init_process_group`` and the mesh functions apply the same
rule and check each other.
"""

from __future__ import annotations

from datetime import timedelta
from typing import Tuple

import torch
import torch.distributed as dist

from ..device import resolve_device

TIMEOUT_S = 600  # a collective waits this long for a rank that does not come


def production_mesh_shape(multi_pod: bool = False) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """The production meshes' shape and axis names, without building one:
    16x16 = 256 devices a pod as ``("data", "model")``; 2 pods = 512 as
    ``("pod", "data", "model")``.  ``data`` is DP / the KV shard axis,
    ``model`` TP/EP, ``pod`` pure DP (the slowest links carry only gradient
    reductions)."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def mesh_backend(device=None, backend=None) -> Tuple[torch.device, str]:
    """(device, backend) by the module's rule: ``device`` None means the
    card (raises without CUDA; "cuda" means the current card, by its
    index); ``backend`` None means NCCL on the card and ``gloo`` on the
    CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cpu" and backend != "gloo":
        raise ValueError(f"a CPU mesh runs on gloo, not {backend!r}")
    return dev, backend


def init_process_group(rank: int, world_size: int, init_method: str, *, device=None, backend=None) -> str:
    """Initialise the default process group for one rank with the module's
    backend rule (``init_method`` e.g. ``file:///tmp/x`` or
    ``tcp://localhost:<port>``).  Returns the backend."""
    dev, backend = mesh_backend(device, backend)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world_size, timeout=timedelta(seconds=TIMEOUT_S)
    )
    return backend


def _mesh(shape, axes, device, backend):
    dev, backend = mesh_backend(device, backend)
    if not dist.is_initialized():
        raise RuntimeError("no process group: call launch.mesh.init_process_group on every rank first")
    if dist.get_backend() != backend:
        raise ValueError(
            f"the default process group runs {dist.get_backend()!r}, a {dev.type} mesh here needs {backend!r}"
            " (backend='gloo' for ranks that share one card)"
        )
    n = 1
    for s in shape:
        n *= s
    if n != dist.get_world_size():
        raise ValueError(f"a {shape} mesh needs {n} ranks, the process group has {dist.get_world_size()}")
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(dev.type, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(multi_pod: bool = False, *, device=None, backend=None):
    """The production mesh (``production_mesh_shape``) over 256 or 512
    initialised ranks."""
    shape, axes = production_mesh_shape(multi_pod)
    return _mesh(shape, axes, device, backend)


def make_debug_mesh(data: int = 1, model: int = 1, *, device=None, backend=None):
    """A ``(data, model)`` mesh over however many ranks the process group
    has (tests, one host)."""
    return _mesh((data, model), ("data", "model"), device, backend)


def data_axis(mesh) -> Tuple[object, int, int]:
    """(process group, size, this rank's coordinate) of the mesh's ``data``
    dimension."""
    dim = mesh.mesh_dim_names.index("data")
    return mesh.get_group("data"), mesh.size(dim), mesh.get_local_rank("data")
