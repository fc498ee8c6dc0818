"""K4: fused YUYV decode + overlay + packed-BGR interleave
(``csrc/yuyv_tick.cu``).

Replaces the Pallas kernel ``rustcv_tpu/ops/pallas/decode_interleave.py``
(``yuyv_decode_interleave``). It emits packed BGR rows with the rectangle
overlay applied, and the gray plane of the frame before the overlay (the
input of the gray filters).

Bound on the card: bytes (2 B read, 4 B written per pixel). A warp walks
2 rows of one stream; a lane owns 8 pixels (4 words) of a row, loads them
as one 16-byte word and prefetches the next row's, decodes on the FP32
pipe (as K5), takes luma with ``dp4a``, overlays with masks classified
once per lane and once per row, and stores 8 gray bytes and 24 BGR bytes,
the warp's BGR staged in shared memory so that every store instruction
covers whole sectors. Where W % 8 != 0 or the words do not
start on a 16-byte boundary, the kernel's second form reads words (or
bytes) and stores 16-bit pairs. Any even W, any H, words at any address
(the Pallas kernel needed 8 | H and fell back otherwise). The plain
version below makes int32 planes, stacks them and draws the overlay in a
second pass over the BGR image.
"""

from __future__ import annotations

import torch

from .. import color, draw
from . import _build

launches = 0  # kernel launches since the last reset (see kernels.reset_launch_counts)


def check_yuyv_args(src, width: int, height: int, rects, colors, overlay: bool) -> int:
    """Validate the arguments K4 and K5 share; returns N."""
    if not isinstance(src, torch.Tensor) or src.ndim != 2:
        raise ValueError("src must be a u8 tensor [N, H*W*2]")
    n = src.shape[0]
    if width < 2 or width % 2 or height < 1:
        raise ValueError(f"need an even width >= 2 and height >= 1, got {width}x{height}")
    if not 1 <= n <= 65535 or height > 65535:
        raise ValueError(f"need 1 <= N <= 65535 and H <= 65535, got N={n}, H={height}")
    _build.expect(src, "src", torch.uint8, (n, height * width * 2))
    if overlay:
        _build.expect(rects, "rects", torch.int32, (n, 4), src.device)
        _build.expect(colors, "colors", torch.uint8, (n, 3), src.device)
    return n


def yuyv_decode_interleave_plain(src, width, height, rects=None, colors=None,
                                 thickness=0, overlay=False):
    """The plain PyTorch version: colour ops then the overlay."""
    bgr = color.yuyv_to_bgr_packed(src, width, height)
    gray = color.yuyv_to_gray(src, width, height)
    if overlay:
        bgr = draw.rectangle_packed(bgr, rects, colors, thickness)
    return bgr, gray


def yuyv_decode_interleave(src: torch.Tensor, width: int, height: int,
                           rects=None, colors=None, thickness=0, overlay=False):
    """YUYV u8 [N, H*W*2] → (packed BGR u8 [N, H, W*3], gray u8 [N, H, W]).

    With ``overlay``, ``rects`` int32 [N, 4] (x, y, w, h) and ``colors`` u8
    [N, 3] on src's device and an int ``thickness`` draw one rectangle per
    stream on the BGR output. A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel on the current stream."""
    global launches
    n = check_yuyv_args(src, width, height, rects, colors, overlay)
    thickness = int(thickness)
    if src.device.type == "cpu":
        return yuyv_decode_interleave_plain(src, width, height, rects, colors,
                                            thickness, overlay)
    bgr = torch.empty((n, height, width * 3), dtype=torch.uint8, device=src.device)
    gray = torch.empty((n, height, width), dtype=torch.uint8, device=src.device)
    lib = _build.library()
    with torch.cuda.device(src.device):
        rc = lib.rcv_yuyv_decode_interleave(
            src.data_ptr(),
            rects.data_ptr() if overlay else None,
            colors.data_ptr() if overlay else None,
            thickness, int(overlay), bgr.data_ptr(), gray.data_ptr(),
            n, height, width, _build.stream_of(src))
    _build.check(rc, "yuyv_decode_interleave")
    launches += 1
    return bgr, gray
