"""Stereo block matching (port of ``rustcv_tpu.ops.stereo``; OpenCV
``StereoBM`` role): disparity from a rectified L/R pair.

The cost volume is the D shifted absolute differences (one gather of the
right image for every d), box-filtered with separable integer taps on the
pair's device; the disparity is an argmin over D and sub-pixel refinement
fits the parabola through the three costs around the winner. Memory: the
[D, H, W] int32 volume is 236 MB at 1280×720 with 64 disparities, and a
few such tensors are alive at once.

Frozen spec:
- cost(d) = Σ_window |L(x, y) − R(x−d, y)| (exact integer; replicate
  border for the window, columns x < d take the clamped R column 0);
- disparity = argmin_d cost (ties → smallest d);
- validity: the LEFT image's window texture Σ|∂x L| (central difference)
  must exceed texture·window² (reject flat regions — a flat pair matches
  everywhere with zero cost), and the uniqueness test min2 ≥
  min·(1 + uniq/100) over d outside ±1 of the winner;
- sub-pixel (float32): d + (c⁻ − c⁺) / (2·(c⁻ − 2c + c⁺)) clamped to
  ±0.5, 0 at the volume edges or degenerate denominators.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .filters import _taps
from .tensors import as_tensor


def _box(a: torch.Tensor, r: int) -> torch.Tensor:
    ones = (1,) * (2 * r + 1)
    return _taps(_taps(a, a.ndim - 1, ones, r), a.ndim - 2, ones, r)


def stereo_bm(
    left,
    right,
    num_disparities: int = 64,
    block_size: int = 15,
    texture: int = 10,
    uniqueness: int = 10,
):
    """u8 rectified pair (H, W) → (disparity float32 (H, W), valid bool),
    tensors on the pair's device (numpy goes to the card).

    Invalid pixels (texture/uniqueness failures, d-range columns) carry
    disparity 0 and valid False."""
    lf = as_tensor(left).to(torch.int32)
    rt = as_tensor(right, lf.device).to(torch.int32)
    h, w = lf.shape
    r = block_size // 2
    dev = lf.device
    d_axis = torch.arange(num_disparities, device=dev)
    # R(x − d) for every d at once; columns x < d clamp to column 0
    cols = torch.clamp(torch.arange(w, device=dev)[None, :] - d_axis[:, None], min=0)
    shifted = rt[:, cols].permute(1, 0, 2)  # [D, H, W]
    costs = _box((lf[None] - shifted).abs_(), r)
    del shifted
    cmin, best = torch.min(costs, dim=0)

    # validity: texture (left-image gradient energy) + uniqueness
    n_win = (2 * r + 1) ** 2
    dx = _taps(lf, 1, (-1, 0, 1), 1).abs()
    textured = _box(dx, r) > texture * n_win
    near = (d_axis[:, None, None] - best[None]).abs() <= 1
    second = torch.where(near, 1 << 24, costs).amin(dim=0)
    unique = second * 100 >= cmin * (100 + uniqueness)
    # columns that can't see the full disparity range are invalid
    in_range = torch.arange(w, device=dev)[None, :] >= (num_disparities - 1)
    valid = textured & unique & in_range

    # sub-pixel parabola
    dm1 = torch.clamp(best - 1, 0, num_disparities - 1)
    dp1 = torch.clamp(best + 1, 0, num_disparities - 1)
    cm = torch.gather(costs, 0, dm1[None])[0].to(torch.float32)
    cp = torch.gather(costs, 0, dp1[None])[0].to(torch.float32)
    c0 = cmin.to(torch.float32)
    denom = cm - 2.0 * c0 + cp
    frac = torch.where(
        (best > 0) & (best < num_disparities - 1) & (denom > 0),
        torch.clamp((cm - cp) / (2.0 * torch.clamp(denom, min=1e-9)), -0.5, 0.5),
        0.0,
    )
    disp = torch.where(valid, best.to(torch.float32) + frac, 0.0)
    return disp, valid


def stereo_bm_numpy(
    left: np.ndarray,
    right: np.ndarray,
    num_disparities: int = 64,
    block_size: int = 15,
    texture: int = 10,
    uniqueness: int = 10,
) -> Tuple[np.ndarray, np.ndarray]:
    """Oracle — same frozen spec, float64/ int64 NumPy."""
    h, w = left.shape
    r = block_size // 2
    lf = left.astype(np.int64)
    rt = right.astype(np.int64)

    def box(a):
        p = np.pad(a, ((r, r), (r, r)), mode="edge")
        acc = np.zeros_like(a)
        for dy in range(2 * r + 1):
            for dx in range(2 * r + 1):
                acc = acc + p[dy : dy + h, dx : dx + w]
        return acc

    costs = np.stack([
        box(np.abs(lf - np.pad(rt, ((0, 0), (d, 0)), mode="edge")[:, :w]))
        for d in range(num_disparities)
    ])
    best = costs.argmin(axis=0)
    cmin = costs.min(axis=0)
    n_win = (2 * r + 1) ** 2
    pdx = np.pad(lf, ((0, 0), (1, 1)), mode="edge")
    dx = np.abs(pdx[:, 2:] - pdx[:, :-2])
    textured = box(dx) > texture * n_win
    d_axis = np.arange(num_disparities)[:, None, None]
    masked = np.where(np.abs(d_axis - best[None]) <= 1, 2**30, costs)
    second = masked.min(axis=0)
    unique = second * 100 >= cmin * (100 + uniqueness)
    xcol = np.arange(w)[None, :]
    valid = textured & unique & (xcol >= num_disparities - 1)
    dm1 = np.clip(best - 1, 0, num_disparities - 1)
    dp1 = np.clip(best + 1, 0, num_disparities - 1)
    ii, jj = np.mgrid[0:h, 0:w]
    cm = costs[dm1, ii, jj].astype(np.float64)
    cp = costs[dp1, ii, jj].astype(np.float64)
    c0 = cmin.astype(np.float64)
    denom = cm - 2.0 * c0 + cp
    frac = np.where(
        (best > 0) & (best < num_disparities - 1) & (denom > 0),
        np.clip((cm - cp) / (2.0 * np.maximum(denom, 1e-9)), -0.5, 0.5),
        0.0,
    )
    disp = np.where(valid, best + frac, 0.0).astype(np.float32)
    return disp, valid
