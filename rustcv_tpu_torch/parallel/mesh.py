"""Device meshes on ``torch.distributed`` (port of ``rustcv_tpu.parallel.mesh``).

The stream axis is the data-parallel axis: every stage of a tick is local to
its stream, so a rank computes its own streams and touches no collective
until a fleet-wide reduction (``corner_counts_psum``) or a gather of the
streams for the caller (``gather_streams``).

The reference's mesh is single-controller: one process drives its local
chips, and ``jax.Array`` shards hide which chip holds what. PyTorch drives
each device from its own process, so here a mesh is a
:class:`~torch.distributed.device_mesh.DeviceMesh` with ONE RANK PER DEVICE:
NCCL on ``"cuda"`` (rank r on ``cuda:LOCAL_RANK``) and gloo on ``"cpu"``.
A rank holds its own shard as a plain local tensor; ``DTensor`` appears only
at :func:`shard_batch`'s boundary. Every function here that communicates is
called by every rank of the mesh.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def _ensure_process_group(device_type: str) -> None:
    """The default process group for ``device_type``'s backend. A launcher
    (``torchrun``) sets ``WORLD_SIZE`` and the rendezvous in the
    environment; a process that no launcher started and that made no group
    gets a one-rank group on an in-process store, as ``jax.devices()`` gives
    a single process its one chip. On ``"cuda"`` the rank's device becomes
    the current one."""
    if device_type not in _BACKENDS:
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got {device_type!r}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a 'cuda' mesh was requested but torch.cuda.is_available() is False")
    backend = _BACKENDS[device_type]
    if not dist.is_initialized():
        if "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend)
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    elif backend not in dist.get_backend():
        raise ValueError(f"the process group's backend {dist.get_backend()!r} cannot serve a "
                         f"{device_type!r} mesh ({backend})")
    if device_type == "cuda":
        local = os.environ.get("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local is not None
                              else dist.get_rank() % torch.cuda.device_count())


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank drives in ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def stream_mesh(device_type: str = "cuda", axis: str = "stream") -> DeviceMesh:
    """A 1-D mesh over every rank of the world, named for the stream axis."""
    _ensure_process_group(device_type)
    return init_device_mesh(device_type, (dist.get_world_size(),), mesh_dim_names=(axis,))


def grid_mesh(
    n_streams: int,
    n_rows: int,
    device_type: str = "cuda",
    axes: Sequence[str] = ("stream", "rows"),
) -> DeviceMesh:
    """A 2-D (streams × rows) mesh: the outer axis data-parallels stream
    groups, the inner axis splits each frame's rows into bands (spatial
    parallelism with halo exchange, :mod:`.spatial`). Rank ``s·n_rows + r``
    sits at ``(s, r)``: the rows axis varies fastest, as in the reference."""
    _ensure_process_group(device_type)
    world = dist.get_world_size()
    if world != n_streams * n_rows:
        raise ValueError(
            f"grid_mesh: {n_streams}x{n_rows} needs {n_streams * n_rows} ranks, got {world}")
    return init_device_mesh(device_type, (n_streams, n_rows), mesh_dim_names=tuple(axes))


def stream_sharding(mesh: DeviceMesh) -> list:
    """Placements that split a ``[N, ...]`` batch over the mesh's first axis
    (replicated over a second)."""
    return [Shard(0)] + [Replicate()] * (mesh.ndim - 1)


def replicated(mesh: DeviceMesh) -> list:
    return [Replicate()] * mesh.ndim


def _on_mesh(x, mesh: DeviceMesh) -> torch.Tensor:
    return torch.as_tensor(x).to(mesh_device(mesh))


def shard_batch(x, mesh: DeviceMesh) -> DTensor:
    """Place a host batch (the same on every rank) on the mesh, split along
    axis 0: each rank keeps its own rows and nothing is sent. A batch that
    does not divide over the first axis raises ``ValueError``, as
    ``jax.device_put`` does with a ``NamedSharding``."""
    t = _on_mesh(x, mesh)
    shards = mesh.size(0)
    if t.ndim == 0 or t.shape[0] % shards:
        raise ValueError(f"a batch of shape {tuple(t.shape)} does not divide over the mesh's "
                         f"{shards} shards on axis 0")
    k = t.shape[0] // shards
    lo = mesh.get_local_rank(0) * k
    return DTensor.from_local(t[lo:lo + k].contiguous(), mesh, stream_sharding(mesh),
                              run_check=False)


def _local(x, mesh: DeviceMesh) -> torch.Tensor:
    return x.to_local() if isinstance(x, DTensor) else _on_mesh(x, mesh)


def corner_counts_psum(corner_mask, mesh: DeviceMesh) -> torch.Tensor:
    """Fleet-wide reduction: the total of ``corner_mask`` (this rank's shard,
    a DTensor from :func:`shard_batch` or a local tensor) over every shard
    of the mesh's first axis, as int32. One ``all_reduce``; every rank gets
    the same 0-d tensor."""
    total = _local(corner_mask, mesh).to(torch.int32).sum(dtype=torch.int32)
    dist.all_reduce(total, group=mesh.get_group(0))
    return total


def gather_streams(x, mesh: DeviceMesh):
    """Every shard of the mesh's first axis, concatenated in stream order:
    the port's counterpart of ``np.asarray`` on a sharded ``jax.Array``.
    ``x`` is this rank's ``[k, ...]`` shard, a tensor (the result is on the
    mesh's device) or a numpy array (the result is numpy). One
    ``all_gather``; every rank calls it and gets the whole batch."""
    as_numpy = isinstance(x, np.ndarray)
    t = _local(x, mesh).contiguous()
    group = mesh.get_group(0)
    parts = [torch.empty_like(t) for _ in range(mesh.size(0))]
    dist.all_gather(parts, t, group=group)
    out = torch.cat(parts)
    return out.cpu().numpy() if as_numpy else out
