"""Harris corner detection + non-max suppression (port of
``rustcv_tpu.ops.features``; BASELINE config 4), and sub-pixel corner
refinement (``corner_sub_pix``).

The corners are defined by the frozen fixed-point response
:func:`harris_response_i32`; masks and corner lists are integer throughout
and array-equal with the reference. :func:`harris_response` is the float32
response surface (``cv2.cornerHarris``'s), within the reference's tolerance.

Both responses are the Harris kernel (:mod:`.kernels.harris`): a CPU tensor
runs its plain version, a CUDA tensor the kernel. The threshold, the NMS
and the top-K on the response are plain PyTorch on either device.
"""

from __future__ import annotations

import numpy as np
import torch

from . import kernels

I32_MIN = -(2**31)


def _per_image(fn, gray: torch.Tensor, arg):
    """Apply the [N, H, W] kernel wrapper ``fn`` to gray (..., H, W)."""
    if gray.ndim < 2:
        raise ValueError(f"gray must be (..., H, W), got shape {tuple(gray.shape)}")
    hw = gray.shape[-2:]
    out = fn(gray.reshape(-1, *hw).contiguous(), arg)
    return out.reshape(*gray.shape[:-2], *hw)


def harris_response(gray_u8: torch.Tensor, k: float = 0.04) -> torch.Tensor:
    """Harris response (..., H, W) float32; spec = golden.harris_response."""
    return _per_image(kernels.harris_response, gray_u8, k)


def harris_response_i32(gray_u8: torch.Tensor, k_num: int = 41) -> torch.Tensor:
    """Fixed-point Harris response (..., H, W) int32, bit-exact with
    golden.harris_response_i32 (``k_num`` is k in units of 1/1024)."""
    return _per_image(kernels.harris_response_i32, gray_u8, k_num)


def _corner_mask(resp: torch.Tensor, threshold_rel: float, nms_radius: int) -> torch.Tensor:
    """resp > t_num·(max >> 12), max per image over the last two axes, AND
    resp equal to its (2r+1)² window max, with −2³¹ outside the image."""
    spatial_max = resp.amax(dim=(-2, -1), keepdim=True)
    t_num = int(round(threshold_rel * 4096))
    thresh = t_num * (spatial_max >> 12)

    r = nms_radius
    h, w = resp.shape[-2], resp.shape[-1]
    p = resp.new_full((*resp.shape[:-2], h + 2 * r, w + 2 * r), I32_MIN)
    p[..., r:r + h, r:r + w] = resp
    neigh_max = resp
    for dy in range(2 * r + 1):
        for dx in range(2 * r + 1):
            neigh_max = torch.maximum(neigh_max, p[..., dy:dy + h, dx:dx + w])
    return (resp > thresh) & (resp >= neigh_max)


def harris_corners(
    gray_u8: torch.Tensor,
    k: float = 0.04,
    threshold_rel: float = 0.01,
    nms_radius: int = 1,
) -> torch.Tensor:
    """Boolean corner mask (..., H, W), array-equal with golden.harris_corners."""
    resp = harris_response_i32(gray_u8, k_num=int(round(k * 1024)))
    return _corner_mask(resp, threshold_rel, nms_radius)


def harris_corner_list(
    gray_u8: torch.Tensor,
    max_corners: int = 1024,
    k: float = 0.04,
    threshold_rel: float = 0.01,
    nms_radius: int = 1,
):
    """Top-K corner (y, x) coordinates int32 (..., K, 2) and validity mask
    bool (..., K), ordered by response, equal responses lowest flat index
    first (``jax.lax.top_k``'s order). Invalid slots are ties at −2³¹ and
    carry coordinates too, in the same order."""
    resp = harris_response_i32(gray_u8, k_num=int(round(k * 1024)))
    return _top_corners(resp, _corner_mask(resp, threshold_rel, nms_radius), max_corners)


def _top_corners(resp: torch.Tensor, mask: torch.Tensor, max_corners: int):
    """The ``max_corners`` highest responses under ``mask``, per image."""
    h, w = resp.shape[-2], resp.shape[-1]
    if h * w < max_corners:
        raise ValueError(f"max_corners={max_corners} exceeds the {h}x{w} image's {h * w} pixels")
    scores = torch.where(mask, resp, I32_MIN).reshape(*resp.shape[:-2], h * w)
    # One unique int64 key per pixel: the score above, the reversed flat
    # index below, so topk's order is the score's, ties lowest index first.
    rev = torch.arange(h * w - 1, -1, -1, dtype=torch.int64, device=resp.device)
    key = scores.to(torch.int64) * 2**32 + rev
    top_key = key.topk(max_corners, dim=-1).values
    top = torch.div(top_key, 2**32, rounding_mode="floor")
    idx = (h * w - 1) - (top_key - top * 2**32)
    coords = torch.stack([idx // w, idx % w], dim=-1).to(torch.int32)
    return coords, top > I32_MIN


def corner_sub_pix(gray_u8: torch.Tensor, pts, win: int = 11, iters: int = 10) -> torch.Tensor:
    """Sub-pixel corner refinement (OpenCV ``cornerSubPix``): for each corner
    q, solve Σ wᵢ ∇Iᵢ∇Iᵢᵀ (q − pᵢ) = 0 over a win×win window (Gaussian-ish
    weights exp(−2r²/half²)) and iterate ``iters`` times, all points at
    once: each iteration gathers every point's (win+3)² patch (its origin
    clamped into the image) and interpolates it bilinearly.

    ``gray_u8`` (H, W) u8; ``pts`` [K, 2] (x, y) → refined [K, 2] float32
    on the image's device. A point whose window leaves the image, or that
    moves more than ``win``, is returned unrefined. Oracle:
    :func:`corner_sub_pix_numpy` (float64; agreement about 1e-3)."""
    h, w = gray_u8.shape
    dev = gray_u8.device
    half = win // 2
    size = win + 2
    a = gray_u8.to(torch.float32)
    p0 = torch.as_tensor(pts, dtype=torch.float32, device=dev).reshape(-1, 2)
    off = torch.arange(-half, half + 1, dtype=torch.float32, device=dev)
    oy, ox = torch.meshgrid(off, off, indexing="ij")
    wgt = torch.exp(-2.0 * (ox * ox + oy * oy) / float(max(half, 1) ** 2))
    span = torch.arange(size + 1, device=dev)

    def patches(ty, tx):
        """(K, size, size) bilinear patches with top-left corners (ty, tx)."""
        y0, x0 = torch.floor(ty), torch.floor(tx)
        fy, fx = (ty - y0)[:, None, None], (tx - x0)[:, None, None]
        yi = y0.to(torch.int64).clamp(0, h - (size + 1))[:, None] + span
        xi = x0.to(torch.int64).clamp(0, w - (size + 1))[:, None] + span
        p = a[yi[:, :, None], xi[:, None, :]]
        top = p[:, :size, :size] * (1 - fx) + p[:, :size, 1:] * fx
        bot = p[:, 1:, :size] * (1 - fx) + p[:, 1:, 1:] * fx
        return top * (1 - fy) + bot * fy

    q = p0
    for _ in range(iters):
        big = patches(q[:, 1] - half - 1.0, q[:, 0] - half - 1.0)
        gx = (big[:, 1:-1, 2:] - big[:, 1:-1, :-2]) * 0.5
        gy = (big[:, 2:, 1:-1] - big[:, :-2, 1:-1]) * 0.5
        proj = gx * ox + gy * oy
        axx, axy, ayy = ((wgt * u).sum(dim=(1, 2)) for u in (gx * gx, gx * gy, gy * gy))
        bx, by = ((wgt * u * proj).sum(dim=(1, 2)) for u in (gx, gy))
        det = axx * ayy - axy * axy
        inv = torch.where(det.abs() > 1e-6, 1.0 / det, torch.zeros_like(det))
        q = q + torch.stack([(ayy * bx - axy * by) * inv, (-axy * bx + axx * by) * inv], dim=-1)
    inside = ((p0[:, 0] - half - 1 >= 0) & (p0[:, 0] + half + 1 <= w - 1)
              & (p0[:, 1] - half - 1 >= 0) & (p0[:, 1] + half + 1 <= h - 1))
    moved = (q - p0).abs().amax(dim=-1)
    return torch.where((inside & (moved <= win))[:, None], q, p0)


def corner_sub_pix_numpy(gray: np.ndarray, pts: np.ndarray, win: int = 11, iters: int = 10):
    """Float64 oracle for :func:`corner_sub_pix` (the same algorithm:
    origin-clamped patches, Gaussian window, Gauss-Newton updates)."""
    h, w = gray.shape
    half = win // 2
    a = gray.astype(np.float64)
    off = np.arange(-half, half + 1, dtype=np.float64)
    oy, ox = np.meshgrid(off, off, indexing="ij")
    wgt = np.exp(-2.0 * (ox * ox + oy * oy) / float(max(half, 1) ** 2))

    def patch(ty, tx, size):
        y0 = int(np.floor(ty))
        x0 = int(np.floor(tx))
        fy = ty - y0
        fx = tx - x0
        y0 = min(max(y0, 0), h - (size + 1))
        x0 = min(max(x0, 0), w - (size + 1))
        p = a[y0:y0 + size + 1, x0:x0 + size + 1]
        top = p[:size, :size] * (1 - fx) + p[:size, 1:] * fx
        bot = p[1:, :size] * (1 - fx) + p[1:, 1:] * fx
        return top * (1 - fy) + bot * fy

    out = np.array(pts, np.float64).reshape(-1, 2).copy()
    for k in range(len(out)):
        px, py = out[k]
        if not (px - half - 1 >= 0 and px + half + 1 <= w - 1
                and py - half - 1 >= 0 and py + half + 1 <= h - 1):
            continue
        q = out[k].copy()
        for _ in range(iters):
            big = patch(q[1] - half - 1.0, q[0] - half - 1.0, win + 2)
            gx = (big[1:-1, 2:] - big[1:-1, :-2]) * 0.5
            gy = (big[2:, 1:-1] - big[:-2, 1:-1]) * 0.5
            axx = (wgt * gx * gx).sum()
            axy = (wgt * gx * gy).sum()
            ayy = (wgt * gy * gy).sum()
            bx = (wgt * gx * (gx * ox + gy * oy)).sum()
            by = (wgt * gy * (gx * ox + gy * oy)).sum()
            det = axx * ayy - axy * axy
            if abs(det) <= 1e-6:
                break
            q = q + np.array([(ayy * bx - axy * by) / det, (-axy * bx + axx * by) / det])
        if np.abs(q - out[k]).max() <= win:
            out[k] = q
    return out.astype(np.float32)
