"""Harris corner detection + non-max suppression (port of
``rustcv_tpu.ops.features``; BASELINE config 4).

The corners are defined by the frozen fixed-point response
:func:`harris_response_i32`; masks and corner lists are integer throughout
and array-equal with the reference. :func:`harris_response` is the float32
response surface (``cv2.cornerHarris``'s), within the reference's tolerance.

Both responses are the Harris kernel (:mod:`.kernels.harris`): a CPU tensor
runs its plain version, a CUDA tensor the kernel. The threshold, the NMS
and the top-K on the response are plain PyTorch on either device.
"""

from __future__ import annotations

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
