"""Parallel execution on ``torch.distributed``: device meshes with one rank
per device, the stream axis split over ranks, row bands with halo exchange.

Launchers: ``python -m rustcv_tpu_torch.parallel.launch`` (the engine over
every rank's streams and the fleet's frames/s; ``torchrun
--nproc-per-node N`` on a host with N cards) and ``python -m
rustcv_tpu_torch.parallel.rehearse_2d`` (the 2-D streams × rows stencil
across processes, checked against the golden chain)."""

from .mesh import (
    corner_counts_psum, gather_streams, grid_mesh, replicated, shard_batch, stream_mesh,
    stream_sharding,
)
from .spatial import blur_sobel_mag_spatial, blur_sobel_mag_spatial_2d

__all__ = [
    "blur_sobel_mag_spatial", "blur_sobel_mag_spatial_2d",
    "corner_counts_psum", "gather_streams", "grid_mesh", "replicated", "shard_batch",
    "stream_mesh", "stream_sharding",
]
