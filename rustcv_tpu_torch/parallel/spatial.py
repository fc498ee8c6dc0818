"""Spatial parallelism: one frame's rows split into bands across ranks
(port of ``rustcv_tpu.parallel.spatial``).

Each rank owns a horizontal band ``[N, H/R, W]`` of the frames and gets
``HALO`` rows from each neighbour band over ``torch.distributed``
point-to-point ops (the reference's ``lax.ppermute`` pair), then runs the
whole-frame blur + Sobel |∇| on the band with its halos and crops them away.

The band computation is :func:`band_blur_sobel`: the stack
``[top halo; band; bottom halo]`` goes through K1
(:func:`rustcv_tpu_torch.ops.kernels.stencil.blur_sobel_mag`) on a CUDA
tensor and its plain chain on a CPU tensor. It is exact by construction:

* Sobel reads blurred rows i±1 and the Gaussian reads rows ±2, so a kept
  row depends on rows i-3..i+3 alone; with HALO = 3 true neighbour rows on
  each side every kept row, and every blurred row it reads, is computed
  from true rows, and the stack's replicated border reaches only cropped
  rows.
* A band at a global edge gets no halo there: the stack's edge is the
  image's, and K1's own border is the two-stage rule of the golden chain
  (Gaussian replicating the original, Sobel the blurred image).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..ops.kernels.stencil import blur_sobel_mag
from .mesh import mesh_device

_G5 = (1, 4, 6, 4, 1)  # the Gaussian's taps (rustcv_tpu/ops/pallas/stencil.py:36)
HALO = len(_G5) // 2 + 1  # rows of context: Gaussian 2 + Sobel 1


def band_blur_sobel(band: torch.Tensor, top: Optional[torch.Tensor] = None,
                    bot: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Blur + Sobel |∇| of a band u8 ``[N, rows, W]`` given the ``HALO`` rows
    above it (``top``, ``None`` on the first band) and below it (``bot``,
    ``None`` on the last): the band's rows of the whole frame's result."""
    # Exact: a kept row reads rows ±3 (Sobel ±1 of blurred rows, Gaussian ±2), all true rows
    # of the stack; K1's replicate border reaches only halo rows, which the crop drops.
    stack = torch.cat([p for p in (top, band, bot) if p is not None], dim=-2)
    lo = 0 if top is None else top.shape[-2]
    return blur_sobel_mag(stack)[:, lo:lo + band.shape[-2]].contiguous()


def _exchange_halos(band: torch.Tensor, group) -> tuple:
    """Send this band's first ``HALO`` rows to the band above and its last
    ``HALO`` rows to the band below, and receive theirs: ``(top, bot)``,
    ``None`` at a global edge. One batch of point-to-point ops on the rows
    group (peers by their global rank)."""
    ranks = dist.get_process_group_ranks(group)
    me = ranks.index(dist.get_rank())
    top = bot = None
    ops = []
    if me > 0:
        top = torch.empty_like(band[:, :HALO])
        ops += [dist.P2POp(dist.isend, band[:, :HALO].contiguous(), ranks[me - 1], group),
                dist.P2POp(dist.irecv, top, ranks[me - 1], group)]
    if me < len(ranks) - 1:
        bot = torch.empty_like(band[:, -HALO:])
        ops += [dist.P2POp(dist.isend, band[:, -HALO:].contiguous(), ranks[me + 1], group),
                dist.P2POp(dist.irecv, bot, ranks[me + 1], group)]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return top, bot


def _check_bands(band: torch.Tensor, mesh: DeviceMesh, n_rows: int, what: str) -> None:
    """The reference's checks on the global array, made on the bands: every
    rank of the world holds a band of one shape (the batch and the height
    divide evenly over the mesh) at least ``HALO`` rows high. One
    ``all_gather`` of the shapes, so every rank raises together."""
    if band.ndim != 3:
        raise ValueError(f"{what}: expected a band [N, rows, W], got shape {tuple(band.shape)}")
    if mesh.size() != dist.get_world_size():
        raise ValueError(f"{what}: the mesh must span the world ({mesh.size()} of "
                         f"{dist.get_world_size()} ranks)")
    dev = mesh_device(mesh)
    if band.device != dev:
        raise ValueError(f"{what}: the band is on {band.device}, this rank's device is {dev}")
    shape = torch.tensor(band.shape, dtype=torch.int64, device=dev)
    shapes = [torch.empty_like(shape) for _ in range(dist.get_world_size())]
    dist.all_gather(shapes, shape)
    shapes = {tuple(s.tolist()) for s in shapes}
    if len(shapes) != 1:
        raise ValueError(f"{what}: the ranks hold bands of shapes {sorted(shapes)}: the batch and "
                         f"the height must divide evenly over the mesh")
    if band.shape[-2] < HALO:
        raise ValueError(f"{what}: band height {band.shape[-2]} < halo {HALO}: use fewer row "
                         f"ranks for this image height ({n_rows} now)")


def blur_sobel_mag_spatial(gray: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """Gaussian5 + Sobel + |∇| with the rows split over a 1-D mesh.

    ``gray`` is this rank's band, u8 ``[N, H/R, W]`` (or ``[H/R, W]``) of
    the frames ``[N, H, W]``, band r on the rank at coordinate r; the result
    is the same band of the whole frames' |∇|, bit-exact with the golden
    chain. Every rank of the mesh calls it."""
    if mesh.ndim != 1:
        raise ValueError(f"spatial sharding expects a 1-D mesh, got axes {mesh.mesh_dim_names}")
    squeeze = gray.ndim == 2
    band = gray[None] if squeeze else gray
    _check_bands(band, mesh, mesh.size(0), "blur_sobel_mag_spatial")
    out = band_blur_sobel(band, *_exchange_halos(band, mesh.get_group(0)))
    return out[0] if squeeze else out


def blur_sobel_mag_spatial_2d(gray: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """Gaussian5 + Sobel + |∇| on a 2-D (streams × rows) mesh: the batch is
    split over the stream axis (no collective) and each frame's rows over
    the rows axis, with halo exchange inside each stream group.

    ``gray`` is this rank's block, u8 ``[N/S, H/R, W]``: streams of stream
    group s and band r on the rank at ``(s, r)``. Bit-exact with the golden
    chain. Every rank of the mesh calls it."""
    if mesh.ndim != 2:
        raise ValueError(f"2-D spatial sharding expects a 2-axis mesh, got {mesh.mesh_dim_names}")
    _check_bands(gray, mesh, mesh.size(1), "blur_sobel_mag_spatial_2d")
    return band_blur_sobel(gray, *_exchange_halos(gray, mesh.get_group(1)))
