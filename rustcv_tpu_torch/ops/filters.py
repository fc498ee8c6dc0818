"""Stencil filters (port of the pipeline's subset of
``rustcv_tpu.ops.filters``): 5×5 Gaussian, 3×3 Sobel, the exact integer
gradient magnitude and Canny, bit-exact with the reference's frozen specs.

Integer taps are shifted adds on replicate-padded int32 tensors. The chain
``gaussian5_u8 → sobel3_gray → gradient_magnitude_u8`` is the plain version
of the blur+Sobel kernel (:mod:`.kernels.stencil`), including its two-stage
border rule: the Gaussian replicates the original at the border, then the
Sobel replicates the blurred image.
"""

from __future__ import annotations

import torch

GAUSS5 = (1, 4, 6, 4, 1)  # per-axis taps, sum 16
# Bounded hysteresis rounds of Canny: the frozen spec's constant
# (rustcv_tpu/ops/golden.py:999), copied because importing the JAX package's
# ops loads jax.
CANNY_HYST_ROUNDS = 16


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


def _window_reduce(img: torch.Tensor, ksize: int, fn) -> torch.Tensor:
    """fn-reduce over a ksize×ksize window, replicate border. The spatial
    axes are guessed as in the reference: (-3, -2) when the last axis has
    1, 3 or 4 entries and there are at least three axes, else (-2, -1)."""
    has_channels = img.ndim >= 3 and img.shape[-1] in (1, 3, 4)
    ax_h, ax_w = (img.ndim - 3, img.ndim - 2) if has_channels else (img.ndim - 2, img.ndim - 1)
    r = ksize // 2
    p = _replicate_pad(_replicate_pad(img, ax_h, r), ax_w, r)
    h, w = img.shape[ax_h], img.shape[ax_w]
    acc = None
    for dy in range(ksize):
        for dx in range(ksize):
            sl = p.narrow(ax_h, dy, h).narrow(ax_w, dx, w)
            acc = sl if acc is None else fn(acc, sl)
    return acc


def canny_u8(gray: torch.Tensor, low: int = 40, high: int = 90) -> torch.Tensor:
    """Canny edges on u8 gray (..., H, W) → u8 mask (255/0), bit-exact with
    the frozen integer spec (``golden.canny``): Gaussian5 → Sobel → exact
    |∇| → fixed-point sector NMS (out-of-image neighbours 0) → double
    threshold → CANNY_HYST_ROUNDS rounds of 3×3 hysteresis growth."""
    blurred = gaussian5_u8(gray, has_channels=False)
    gx, gy = sobel3_gray(blurred)
    mag = isqrt_exact(gx * gx + gy * gy)

    a = gx.abs()
    b = gy.abs()
    sector0 = (b << 16) <= a * 27146  # ~horizontal gradient (tan 22.5°)
    sector2 = (b << 16) >= a * 158218  # ~vertical gradient (tan 67.5°)
    diagonal = ~sector0 & ~sector2
    diag_main = diagonal & (gx * gy >= 0)
    diag_anti = diagonal & (gx * gy < 0)

    h, w = mag.shape[-2], mag.shape[-1]
    p = mag.new_zeros((*mag.shape[:-2], h + 2, w + 2))
    p[..., 1:-1, 1:-1] = mag

    def nb(dy, dx):
        return p[..., 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

    zero = torch.zeros((), dtype=mag.dtype, device=mag.device)
    n1 = torch.where(sector0, nb(0, -1), zero)
    n2 = torch.where(sector0, nb(0, 1), zero)
    n1 = torch.where(sector2, nb(-1, 0), n1)
    n2 = torch.where(sector2, nb(1, 0), n2)
    n1 = torch.where(diag_main, nb(-1, -1), n1)
    n2 = torch.where(diag_main, nb(1, 1), n2)
    n1 = torch.where(diag_anti, nb(-1, 1), n1)
    n2 = torch.where(diag_anti, nb(1, -1), n2)
    nms = torch.where((mag >= n1) & (mag >= n2), mag, zero)

    strong = (nms > high).to(torch.uint8)
    weak = nms > low
    for _ in range(CANNY_HYST_ROUNDS):
        grown = _window_reduce(strong * 255, 3, torch.maximum) > 0
        strong = torch.where(weak & grown, torch.ones_like(strong), strong)
    return strong * 255
