"""Stencil filters (port of the main-path subset of
``rustcv_tpu.ops.filters``): 5×5 Gaussian, 3×3 Sobel and the exact integer
gradient magnitude, bit-exact with the reference's frozen specs.

Integer taps are shifted adds on replicate-padded int32 tensors. The chain
``gaussian5_u8 → sobel3_gray → gradient_magnitude_u8`` is the plain version
of the blur+Sobel kernel (:mod:`.kernels.stencil`), including its two-stage
border rule: the Gaussian replicates the original at the border, then the
Sobel replicates the blurred image.
"""

from __future__ import annotations

import torch

GAUSS5 = (1, 4, 6, 4, 1)  # per-axis taps, sum 16


def _replicate_pad(a: torch.Tensor, axis: int, r: int) -> torch.Tensor:
    n = a.shape[axis]
    idx = torch.arange(-r, n + r, device=a.device).clamp(0, n - 1)
    return a.index_select(axis, idx)


def _taps(a: torch.Tensor, axis: int, weights, r: int) -> torch.Tensor:
    """Σ w_k · shift_k(a) along ``axis`` with replicate border, int32."""
    p = _replicate_pad(a, axis, r)
    n = a.shape[axis]
    acc = None
    for k, w in enumerate(weights):
        if w == 0:
            continue
        sl = p.narrow(axis, k, n)
        term = w * sl if w != 1 else sl
        acc = term if acc is None else acc + term
    return acc


def gaussian5_u8(img: torch.Tensor, has_channels: bool = None) -> torch.Tensor:  # type: ignore[assignment]
    """5×5 Gaussian on u8, replicate border, (Σ+128)>>8. The spatial axes
    are the last two, or (-3, -2) when a trailing channel axis is present
    (guessed as in the reference when ``has_channels`` is None)."""
    if has_channels is None:
        has_channels = img.ndim >= 3 and img.shape[-1] in (1, 3, 4)
    ax_h, ax_w = (img.ndim - 3, img.ndim - 2) if has_channels else (img.ndim - 2, img.ndim - 1)
    a = img.to(torch.int32)
    tmp = _taps(a, ax_w, GAUSS5, 2)
    acc = _taps(tmp, ax_h, GAUSS5, 2)
    return ((acc + 128) >> 8).to(torch.uint8)


def sobel3_gray(gray: torch.Tensor):
    """Sobel gx/gy on u8 gray (..., H, W) → int32 pair."""
    a = gray.to(torch.int32)
    ax_h, ax_w = a.ndim - 2, a.ndim - 1
    smooth_v = _taps(a, ax_h, (1, 2, 1), 1)
    diff_v = _taps(a, ax_h, (-1, 0, 1), 1)
    gx = _taps(smooth_v, ax_w, (-1, 0, 1), 1)
    gy = _taps(diff_v, ax_w, (1, 2, 1), 1)
    return gx, gy


def isqrt_exact(x: torch.Tensor) -> torch.Tensor:
    """Exact floor-sqrt of non-negative int32 (f32 sqrt + two fix-ups)."""
    s = x.to(torch.float32).sqrt().to(torch.int32)
    s = torch.where((s + 1) * (s + 1) <= x, s + 1, s)
    s = torch.where(s * s > x, s - 1, s)
    return s


def gradient_magnitude_u8(gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """min(255, isqrt(gx²+gy²)); |gx|, |gy| ≤ 1020 so the sum fits int32."""
    mag2 = gx * gx + gy * gy
    return isqrt_exact(mag2).clamp(max=255).to(torch.uint8)


def blur_sobel_mag_u8(gray: torch.Tensor) -> torch.Tensor:
    """gray u8 (..., H, W) → Gaussian5 → Sobel → |∇| u8 (..., H, W)."""
    blurred = gaussian5_u8(gray, has_channels=False)
    return gradient_magnitude_u8(*sobel3_gray(blurred))
