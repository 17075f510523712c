"""Process groups and device meshes on ``torch.distributed``
(sdmatte_tpu/parallel/mesh.py).

The JAX package's scale-out is SPMD: a ``data`` mesh, the batch (or the
video's frames) split over it, parameters replicated, XLA inserting the one
collective training needs.  Here each process owns one device and one slice
of the batch; :func:`make_mesh` is a 1-D ``("data",)`` ``DeviceMesh`` over
every process and :func:`make_hybrid_mesh` a 2-D ``("dcn", "data")`` one,
hosts by the devices of a host.  Both carry the batch over all their axes,
so consumers ask :func:`data_spec` for their slice and never name an axis.

The backend is NCCL when the card is there and gloo on the CPU.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def distributed_init(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *,
                     backend: Optional[str] = None) -> bool:
    """Join the process group, once per process, before any collective.

    Arguments fall back to the JAX package's environment names
    (``COORDINATOR_ADDRESS`` as ``host:port``, ``NUM_PROCESSES``,
    ``PROCESS_ID``) and then to the ones ``torchrun`` sets (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``).  Returns
    False, doing nothing, when none of them is set, so a single-process
    caller may call it unconditionally.  A process that finds the card
    binds to device ``LOCAL_RANK`` (0 without it) and takes NCCL."""
    env = os.environ
    address = coordinator_address or env.get("COORDINATOR_ADDRESS")
    n = num_processes if num_processes is not None else _env_int("NUM_PROCESSES", "WORLD_SIZE")
    rank = process_id if process_id is not None else _env_int("PROCESS_ID", "RANK")
    if dist.is_initialized():
        return True
    if not address and not env.get("MASTER_ADDR"):
        return False
    if n is None or rank is None:
        raise ValueError("distributed_init needs the number of processes and this "
                         "process's id (NUM_PROCESSES / PROCESS_ID or WORLD_SIZE / RANK)")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", 0)))
    init = f"tcp://{address}" if address else "env://"
    dist.init_process_group(backend, init_method=init, world_size=n, rank=rank,
                            timeout=timedelta(minutes=10))
    return True


def _env_int(*names: str) -> Optional[int]:
    for name in names:
        if os.environ.get(name):
            return int(os.environ[name])
    return None


def _device_type() -> str:
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs the process group: call distributed_init "
                           "(or torch.distributed.init_process_group) first")
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "data") -> DeviceMesh:
    """1-D mesh over every process of the group (one device each)."""
    device_type, world = _device_type(), dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"requested {n_devices} devices, the process group has {world}: "
                         f"a mesh covers every process")
    return init_device_mesh(device_type, (world,), mesh_dim_names=(axis_name,))


def make_hybrid_mesh(n_hosts: Optional[int] = None,
                     devices_per_host: Optional[int] = None,
                     axis_names: Sequence[str] = ("dcn", "data")) -> DeviceMesh:
    """2-D ``(dcn, data)`` mesh: hosts x the devices of each host.  Ranks are
    laid out host-major (``torchrun`` numbers a host's processes
    consecutively), so the inner axis is one host's devices.  The grid must
    cover every process exactly, as in the JAX package: a process left out
    would wait forever at the first collective."""
    device_type, world = _device_type(), dist.get_world_size()
    if devices_per_host is None:
        devices_per_host = (world // n_hosts if n_hosts
                            else int(os.environ.get("LOCAL_WORLD_SIZE", world)))
    if n_hosts is None:
        n_hosts = world // devices_per_host
    if n_hosts * devices_per_host != world:
        raise ValueError(f"requested {n_hosts}x{devices_per_host}, the process group has "
                         f"{world} processes: a hybrid mesh must cover every process exactly")
    return init_device_mesh(device_type, (n_hosts, devices_per_host),
                            mesh_dim_names=tuple(axis_names))


def data_axes(mesh: DeviceMesh) -> tuple:
    """Mesh axes that carry the batch or frame dimension: all of them, in
    mesh order."""
    return tuple(mesh.mesh_dim_names)


def data_index(mesh: DeviceMesh) -> int:
    """This process's position along the flattened data axes."""
    return int(np.ravel_multi_index(tuple(mesh.get_coordinate()), tuple(mesh.shape)))


def data_group(mesh: DeviceMesh):
    """The process group spanning every data axis (the group of a 1-D mesh;
    the whole world for a hybrid one, which covers it exactly)."""
    return mesh.get_group() if mesh.ndim == 1 else dist.group.WORLD


def data_spec(mesh: DeviceMesh, n: int) -> slice:
    """This process's slice of axis 0 of a global batch of ``n``."""
    world = mesh.size()
    if n % world:
        raise ValueError(f"a batch of {n} does not divide evenly over {world} processes")
    per = n // world
    i = data_index(mesh)
    return slice(i * per, (i + 1) * per)


def shard_batch(x, mesh: DeviceMesh):
    """This process's slice of the leading (batch / frame) axis of every
    tensor in ``x`` (a tensor, or a dict or list of them)."""
    if isinstance(x, dict):
        return {k: shard_batch(v, mesh) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(shard_batch(v, mesh) for v in x)
    return x[data_spec(mesh, x.shape[0])]


def replicate(x, mesh: DeviceMesh):
    """Every process's copy of ``x`` (a module's parameters and buffers, or
    the tensors of a dict) made equal to rank 0's, in place, by a broadcast
    over the mesh (which covers every process, rank 0 first).  Returns
    ``x``."""
    group = data_group(mesh)
    tensors = (list(x.state_dict().values()) if isinstance(x, torch.nn.Module)
               else list(x.values()))
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t, src=0, group=group)
    return x
