"""K1: fused blur + Sobel |∇| (``csrc/stencil.cu``).

Replaces the Pallas kernels ``rustcv_tpu/ops/pallas/stencil_v3.py``
(``blur_sobel_mag_pallas_v3``), ``stencil.py`` (v1) and ``stencil_v2.py``
(v2); the three compute the same function, so ``stencil_impl`` values
``pallas``, ``pallas_v1`` and ``pallas_v2`` all run this kernel.

Bound on the card: bytes (1 B read, 1 B written per pixel), with the integer
arithmetic close behind. The kernel marches a warp down a strip of rows,
each lane 4 columns, with the horizontal and vertical sums in 16-bit lanes
of registers and the neighbours by warp shuffles, so no intermediate
reaches device memory; the plain version below writes and re-reads int32
planes between its passes. Any H and W, at any address.
"""

from __future__ import annotations

import torch

from .. import filters
from . import _build

launches = 0  # kernel launches since the last reset (see kernels.reset_launch_counts)


def blur_sobel_mag_plain(gray: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: gaussian5_u8 → sobel3_gray → magnitude."""
    return filters.blur_sobel_mag_u8(gray)


def blur_sobel_mag(gray: torch.Tensor) -> torch.Tensor:
    """Gaussian5 + Sobel + exact |∇| on u8 gray [N, H, W].

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    on the current stream (no synchronisation)."""
    global launches
    if not isinstance(gray, torch.Tensor) or gray.ndim != 3:
        raise ValueError("gray must be a u8 tensor [N, H, W]")
    n, h, w = gray.shape
    _build.expect(gray, "gray", torch.uint8, (n, h, w))
    if min(n, h, w) < 1 or n > 65535:
        raise ValueError(f"gray shape {tuple(gray.shape)}: need 1 <= N <= 65535 and H, W >= 1")
    if gray.device.type == "cpu":
        return blur_sobel_mag_plain(gray)
    out = torch.empty_like(gray)
    lib = _build.library()
    with torch.cuda.device(gray.device):
        rc = lib.rcv_blur_sobel_mag(
            gray.data_ptr(), out.data_ptr(), n, h, w, _build.stream_of(gray))
    _build.check(rc, "blur_sobel_mag")
    launches += 1
    return out
