"""K6: the Harris response, one CUDA kernel in two arithmetic forms
(``csrc/harris.cu``).

Replaces the Pallas kernel ``rustcv_tpu/ops/pallas/harris.py``
(``harris_response_pallas``), which computes the float32 response of
``features.harris_response``. The same kernel, with int32 arithmetic,
computes the frozen fixed-point response ``features.harris_response_i32``
that defines config 4's corners, so the corner path runs it on every tick.

Both forms: integer Sobel on replicate-padded gray, the three gradient
products, a separable 5×5 (1, 4, 6, 4, 1) window over the replicate-padded
*products*, then ``det − k·tr²``:

* f32 (K6): gradients scaled by 1/(255·4), taps /16, ``det − (k·tr)·tr``;
* int32: taps summed, ``(Σ + 128) >> 8`` then ``>> 5``,
  ``det − k_num·(((sxx5 + syy5) >> 1)² >> 8)``.

Bound on the card: the response reads 1 B and writes 4 B per pixel, but
its arithmetic (about 65 instructions per pixel) is the nearer limit. The
kernel is a register row march (``csrc/stencil.cuh``): a warp walks a
strip of 11 to 24 rows, a lane owns 4 columns, neighbours come by warp
shuffles, the vertical Sobel sums and the vertical window are cascades
held in registers, and the products run on the FP32 pipe (the int32 form
as the exact bits of ``p + 1.5·2²³``). No shared memory, no barrier. The
plain versions below write and re-read int32 or float32 planes between
some twenty passes.
"""

from __future__ import annotations

import ctypes

import torch

from .. import filters
from . import _build

# The kernel's grid: strips of at least MIN_ROWS rows, 4 strips per block,
# at most 65535 blocks down a plane.
MIN_ROWS = 11
MAX_H = 65535 * 4 * MIN_ROWS

# Kernel launches since the last reset (see kernels.reset_launch_counts).
launches_f32 = 0
launches_i32 = 0

_GAUSS5_F = tuple(float(x) / 16.0 for x in filters.GAUSS5)  # exact in float32
_NORM = torch.tensor(1.0 / (255.0 * 4.0), dtype=torch.float32)


def _smooth5_f32(m: torch.Tensor) -> torch.Tensor:
    tmp = filters._taps(m, m.ndim - 1, _GAUSS5_F, 2)
    return filters._taps(tmp, m.ndim - 2, _GAUSS5_F, 2)


def harris_response_plain(gray: torch.Tensor, k: float = 0.04) -> torch.Tensor:
    """The plain PyTorch version of the float32 response, u8 (..., H, W) →
    float32 (..., H, W): the chain of ``rustcv_tpu.ops.features.harris_response``,
    one rounding per operation in the same order."""
    gx, gy = filters.sobel3_gray(gray)
    norm = _NORM.to(gray.device)
    fx = gx.to(torch.float32) * norm
    fy = gy.to(torch.float32) * norm
    sxx = _smooth5_f32(fx * fx)
    syy = _smooth5_f32(fy * fy)
    sxy = _smooth5_f32(fx * fy)
    det = sxx * syy - sxy * sxy
    tr = sxx + syy
    kf = torch.tensor(k, dtype=torch.float32, device=gray.device)
    return det - kf * tr * tr


def _smooth5_i32(m: torch.Tensor) -> torch.Tensor:
    """Separable integer 5×5 Gaussian, (Σ+128)>>8 (arithmetic shift)."""
    acc = filters._taps(filters._taps(m, m.ndim - 1, filters.GAUSS5, 2), m.ndim - 2,
                        filters.GAUSS5, 2)
    return (acc + 128) >> 8


def harris_response_i32_plain(gray: torch.Tensor, k_num: int = 41) -> torch.Tensor:
    """The plain PyTorch version of the fixed-point response, u8 (..., H, W)
    → int32 (..., H, W), bit-exact with ``golden.harris_response_i32`` (no
    intermediate overflows int32; the proof is there)."""
    gx, gy = filters.sobel3_gray(gray)
    sxx5 = _smooth5_i32(gx * gx) >> 5
    syy5 = _smooth5_i32(gy * gy) >> 5
    sxy5 = _smooth5_i32(gx * gy) >> 5
    det = sxx5 * syy5 - sxy5 * sxy5
    trh = (sxx5 + syy5) >> 1
    return det - k_num * ((trh * trh) >> 8)


def _check(gray) -> tuple:
    if not isinstance(gray, torch.Tensor) or gray.ndim not in (2, 3):
        raise ValueError("gray must be a u8 tensor [N, H, W] or [H, W]")
    n, h, w = (1, *gray.shape) if gray.ndim == 2 else gray.shape
    _build.expect(gray, "gray", torch.uint8, gray.shape)
    if min(n, h, w) < 1 or n > 65535 or h > MAX_H:
        raise ValueError(f"gray shape {tuple(gray.shape)}: need 1 <= N <= 65535, "
                         f"1 <= H <= {MAX_H} (strips of {MIN_ROWS} rows) and W >= 1")
    return n, h, w


def harris_response(gray: torch.Tensor, k: float = 0.04) -> torch.Tensor:
    """Float32 Harris response of u8 gray [N, H, W] or [H, W].

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel on the current stream (no synchronisation)."""
    global launches_f32
    n, h, w = _check(gray)
    if gray.device.type == "cpu":
        return harris_response_plain(gray, k)
    out = torch.empty(gray.shape, dtype=torch.float32, device=gray.device)
    lib = _build.library()
    with torch.cuda.device(gray.device):
        rc = lib.rcv_harris_response_f32(gray.data_ptr(), out.data_ptr(), n, h, w,
                                         ctypes.c_float(k), _build.stream_of(gray))
    _build.check(rc, "harris_response_f32")
    launches_f32 += 1
    return out


def harris_response_i32(gray: torch.Tensor, k_num: int = 41) -> torch.Tensor:
    """Fixed-point (int32) Harris response of u8 gray [N, H, W] or [H, W].

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel on the current stream (no synchronisation)."""
    global launches_i32
    n, h, w = _check(gray)
    k_num = int(k_num)
    if not -2**31 <= k_num < 2**31:
        raise ValueError(f"k_num must fit int32, got {k_num}")
    if gray.device.type == "cpu":
        return harris_response_i32_plain(gray, k_num)
    out = torch.empty(gray.shape, dtype=torch.int32, device=gray.device)
    lib = _build.library()
    with torch.cuda.device(gray.device):
        rc = lib.rcv_harris_response_i32(gray.data_ptr(), out.data_ptr(), n, h, w, k_num,
                                         _build.stream_of(gray))
    _build.check(rc, "harris_response_i32")
    launches_i32 += 1
    return out
