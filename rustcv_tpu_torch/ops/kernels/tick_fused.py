"""K5: the whole YUYV tick in one kernel — decode, overlay, packed-BGR
store and blur + Sobel |∇| (``csrc/yuyv_tick.cu``).

Replaces the Pallas kernel ``rustcv_tpu/ops/pallas/tick_fused.py``
(``yuyv_tick_fused``).

Bound on the card: bytes (2 B read, 4 B written per pixel). It runs K1's
row march (``csrc/stencil.cuh``) on gray rows decoded in registers from
the wire words, so gray never reaches device memory; each lane decodes its
own words once per row and stores their overlaid BGR from the same decode.
The plain version below is K4's plain version followed by K1's. Any even
W, any H and words at any address (the Pallas kernel needed 8 | H and
returned None otherwise, leaving the caller to run the unfused chain).
"""

from __future__ import annotations

import torch

from .. import filters
from . import _build
from .decode_interleave import check_yuyv_args, yuyv_decode_interleave_plain

launches = 0  # kernel launches since the last reset (see kernels.reset_launch_counts)


def yuyv_tick_fused_plain(src, width, height, rects=None, colors=None,
                          thickness=0, overlay=False):
    """The plain PyTorch version: decode (+overlay), then the filter chain
    on the pre-overlay gray."""
    bgr, gray = yuyv_decode_interleave_plain(src, width, height, rects, colors,
                                             thickness, overlay)
    return bgr, filters.blur_sobel_mag_u8(gray)


def yuyv_tick_fused(src: torch.Tensor, width: int, height: int,
                    rects=None, colors=None, thickness=0, overlay=False):
    """YUYV u8 [N, H*W*2] → (packed BGR u8 [N, H, W*3], filtered u8
    [N, H, W]); arguments as :func:`.decode_interleave.yuyv_decode_interleave`.
    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    on the current stream."""
    global launches
    n = check_yuyv_args(src, width, height, rects, colors, overlay)
    thickness = int(thickness)
    if src.device.type == "cpu":
        return yuyv_tick_fused_plain(src, width, height, rects, colors,
                                     thickness, overlay)
    bgr = torch.empty((n, height, width * 3), dtype=torch.uint8, device=src.device)
    filt = torch.empty((n, height, width), dtype=torch.uint8, device=src.device)
    lib = _build.library()
    with torch.cuda.device(src.device):
        rc = lib.rcv_yuyv_tick_fused(
            src.data_ptr(),
            rects.data_ptr() if overlay else None,
            colors.data_ptr() if overlay else None,
            thickness, int(overlay), bgr.data_ptr(), filt.data_ptr(),
            n, height, width, _build.stream_of(src))
    _build.check(rc, "yuyv_tick_fused")
    launches += 1
    return bgr, filt
