"""Semi-global stereo matching (port of ``rustcv_tpu.ops.sgbm``; OpenCV
``StereoSGBM`` role) — disparity
from a rectified L/R pair with smoothness-aware path aggregation.

The reference has no SGBM (its vision surface stops at capture); this is
an OpenCV-parity addition in the StereoBM family (ops/stereo.py), spec
frozen here with a float64/int64 NumPy oracle (:func:`stereo_sgbm_numpy`).

The port (:func:`stereo_sgbm`)
-----------------------------
- Matching cost: Birchfield–Tomasi sampling-insensitive absolute
  difference on the clipped x-Sobel prefiltered images, box-summed over
  ``block_size``, for every d at once (one gather of the right image).
- Path aggregation is the SGM recurrence
  ``L_r(p,d) = C(p,d) + min(L_r(q,d), L_r(q,d±1)+P1, min_d' L_r(q)+P2)
  − min_d' L_r(q)``. The reference runs it as a ``lax.scan``; here it is
  a Python loop along the scan axis with an int32 ``[M, D]`` carry,
  vectorized over the perpendicular axis and the disparity axis. Each
  step's L is added into the one path-sum volume at once, so no
  direction's ``[H, W, D]`` volume is ever alive (the cost volume and the
  sum are the two big tensors: 236 MB each at 1280×720, D = 64).
- Winner-take-all, uniqueness, sub-pixel parabola and the left↔right
  consistency check are elementwise, with ``torch.gather`` where the
  reference took ``take_along_axis``.

Frozen spec (oracle = :func:`stereo_sgbm_numpy`, int64/float64):
- prefilter: 3×3 Sobel-x (replicate border), ``tab = clip(g, ±cap) + cap``;
- cost: BT min-over-half-samples on the prefiltered pair, d-columns with
  ``x − d < 0`` sample the clamped column 0; box window ``block_size``;
- aggregation: ``num_dirs`` ∈ {4, 8} paths (H±, V± [+ 4 diagonals]),
  integer P1/P2, paths starting outside the image contribute ``C`` alone;
- disparity: argmin over D of the path sum (ties → smallest d);
- validity: uniqueness ``min2·100 ≥ min·(100+uniq)`` over ``|d−best|>1``,
  left-band columns ``x < D−1`` invalid, and (when ``disp12_max_diff ≥
  0``) ``|dL(x) − dR(x−dL)| ≤ disp12_max_diff`` with
  ``dR(x) = argmin_d S(y, x+d, d)``;
- sub-pixel: the BM parabola on S, clamped to ±0.5.

Defaults follow OpenCV: ``P1 = 8·block_size²``, ``P2 = 32·block_size²``
(single-channel), ``prefilter_cap = 63``. Invalid pixels carry 0/False.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .filters import _replicate_pad, _taps
from .tensors import as_tensor

_BIG = 1 << 28


# ---------------------------------------------------------------------------
# shared spec pieces (numpy, int64) — the device twin mirrors each exactly
# ---------------------------------------------------------------------------

def _prefilter_numpy(img: np.ndarray, cap: int) -> np.ndarray:
    p = np.pad(img.astype(np.int64), 1, mode="edge")
    g = (p[:-2, 2:] + 2 * p[1:-1, 2:] + p[2:, 2:]
         - p[:-2, :-2] - 2 * p[1:-1, :-2] - p[2:, :-2])
    return np.clip(g, -cap, cap) + cap


def _bt_cost_numpy(lf: np.ndarray, rt: np.ndarray, d: int) -> np.ndarray:
    """BT cost of L(x) vs R(x−d), clamped sampling (int64)."""
    h, w = lf.shape
    rs = np.pad(rt, ((0, 0), (d, 0)), mode="edge")[:, :w]
    # half-sample neighbourhoods (replicate border)
    def half(a):
        pa = np.pad(a, ((0, 0), (1, 1)), mode="edge")
        lo = (pa[:, :-2] + a) // 2     # midpoint toward x−1 (floor)
        hi = (pa[:, 2:] + a) // 2      # midpoint toward x+1
        return np.minimum(np.minimum(lo, hi), a), np.maximum(np.maximum(lo, hi), a)
    lmin, lmax = half(lf)
    rmin, rmax = half(rs)
    a = np.maximum(0, np.maximum(lf - rmax, rmin - lf))
    b = np.maximum(0, np.maximum(rs - lmax, lmin - rs))
    return np.minimum(a, b)


def _box_numpy(a: np.ndarray, r: int) -> np.ndarray:
    h, w = a.shape
    p = np.pad(a, r, mode="edge")
    acc = np.zeros_like(a)
    for dy in range(2 * r + 1):
        for dx in range(2 * r + 1):
            acc = acc + p[dy:dy + h, dx:dx + w]
    return acc


def _cand_numpy(lp: np.ndarray, p1: int, p2: int) -> np.ndarray:
    """SGM transition term ``min(...) − minL`` for carry ``lp [..., D]``."""
    minl = lp.min(axis=-1, keepdims=True)
    up = np.concatenate([lp[..., 1:], np.full_like(lp[..., :1], _BIG)], -1)
    dn = np.concatenate([np.full_like(lp[..., :1], _BIG), lp[..., :-1]], -1)
    cand = np.minimum(np.minimum(lp, np.minimum(up, dn) + p1), minl + p2)
    return cand - minl


_DIRS4 = ((0, 1), (0, -1), (1, 0), (-1, 0))
_DIRS8 = _DIRS4 + ((1, 1), (1, -1), (-1, 1), (-1, -1))


def _aggregate_numpy(c: np.ndarray, p1: int, p2: int, dirs) -> np.ndarray:
    hh, ww, dd = c.shape
    s = np.zeros_like(c)
    for dy, dx in dirs:
        l = np.zeros_like(c)
        if dy == 0:
            xs = range(ww) if dx > 0 else range(ww - 1, -1, -1)
            for x in xs:
                px = x - dx
                if 0 <= px < ww:
                    l[:, x] = c[:, x] + _cand_numpy(l[:, px], p1, p2)
                else:
                    l[:, x] = c[:, x]
        else:
            ys = range(hh) if dy > 0 else range(hh - 1, -1, -1)
            for y in ys:
                py = y - dy
                if not (0 <= py < hh):
                    l[y] = c[y]
                    continue
                lp = l[py]
                if dx:
                    z = np.zeros_like(lp[:1])
                    lp = (np.concatenate([z, lp[:-1]], 0) if dx > 0
                          else np.concatenate([lp[1:], z], 0))
                l[y] = c[y] + _cand_numpy(lp, p1, p2)
        s += l
    return s


def stereo_sgbm_numpy(
    left: np.ndarray,
    right: np.ndarray,
    num_disparities: int = 64,
    block_size: int = 5,
    p1: int | None = None,
    p2: int | None = None,
    uniqueness: int = 10,
    disp12_max_diff: int = 1,
    num_dirs: int = 8,
    prefilter_cap: int = 63,
) -> Tuple[np.ndarray, np.ndarray]:
    """Oracle — the frozen spec above in int64/float64 NumPy."""
    if p1 is None:
        p1 = 8 * block_size * block_size
    if p2 is None:
        p2 = 32 * block_size * block_size
    h, w = left.shape
    r = block_size // 2
    lf = _prefilter_numpy(np.asarray(left), prefilter_cap)
    rt = _prefilter_numpy(np.asarray(right), prefilter_cap)
    c = np.stack([_box_numpy(_bt_cost_numpy(lf, rt, d), r)
                  for d in range(num_disparities)], axis=-1)  # [H,W,D]
    s = _aggregate_numpy(c, p1, p2, _DIRS8 if num_dirs == 8 else _DIRS4)

    best = s.argmin(axis=-1)
    smin = s.min(axis=-1)
    d_axis = np.arange(num_disparities)[None, None, :]
    masked = np.where(np.abs(d_axis - best[..., None]) <= 1, _BIG, s)
    second = masked.min(axis=-1)
    unique = second * 100 >= smin * (100 + uniqueness)
    xcol = np.arange(w)[None, :]
    valid = unique & (xcol >= num_disparities - 1)

    if disp12_max_diff >= 0:
        # dispR(y, x) = argmin_d S(y, x + d, d)
        sp = np.pad(s, ((0, 0), (0, num_disparities), (0, 0)),
                    constant_values=_BIG)
        ii, jj, kk = np.ogrid[0:h, 0:w, 0:num_disparities]
        sr = sp[ii, jj + kk, kk]
        disp_r = sr.argmin(axis=-1)
        xr = np.clip(xcol - best, 0, w - 1)
        dr_at = disp_r[np.arange(h)[:, None], xr]
        valid &= np.abs(best - dr_at) <= disp12_max_diff

    dm1 = np.clip(best - 1, 0, num_disparities - 1)
    dp1c = np.clip(best + 1, 0, num_disparities - 1)
    ii, jj = np.mgrid[0:h, 0:w]
    cm = s[ii, jj, dm1].astype(np.float64)
    cp = s[ii, jj, dp1c].astype(np.float64)
    c0 = smin.astype(np.float64)
    denom = cm - 2.0 * c0 + cp
    frac = np.where(
        (best > 0) & (best < num_disparities - 1) & (denom > 0),
        np.clip((cm - cp) / (2.0 * np.maximum(denom, 1e-9)), -0.5, 0.5),
        0.0,
    )
    disp = np.where(valid, best + frac, 0.0).astype(np.float32)
    return disp, valid


# ---------------------------------------------------------------------------
# device twin (int32 costs, float32 sub-pixel), on the pair's device
# ---------------------------------------------------------------------------

def _prefilter(img: torch.Tensor, cap: int) -> torch.Tensor:
    g = _taps(_taps(img.to(torch.int32), 0, (1, 2, 1), 1), 1, (-1, 0, 1), 1)
    return torch.clamp(g, -cap, cap) + cap


def _half(a: torch.Tensor):
    """Per-pixel (min, max) of the pixel and its two half-samples
    (floored midpoints toward x−1 and x+1, replicate border)."""
    p = _replicate_pad(a, a.ndim - 1, 1)
    w = a.shape[-1]
    lo = torch.div(p[..., :w] + a, 2, rounding_mode="floor")
    hi = torch.div(p[..., 2:] + a, 2, rounding_mode="floor")
    return (torch.minimum(torch.minimum(lo, hi), a),
            torch.maximum(torch.maximum(lo, hi), a))


def _cost_volume(lf: torch.Tensor, rt: torch.Tensor, num_disparities: int,
                 r: int) -> torch.Tensor:
    """BT costs of L(x) vs R(x−d) for every d, box-summed: int32 [H, W, D]."""
    h, w = lf.shape
    d_axis = torch.arange(num_disparities, device=lf.device)
    cols = torch.clamp(torch.arange(w, device=lf.device)[None, :] - d_axis[:, None], min=0)
    rs = rt[:, cols].permute(1, 0, 2)  # [D, H, W]: R(x − d), column 0 clamped
    lmin, lmax = _half(lf)
    rmin, rmax = _half(rs)
    a = torch.clamp(torch.maximum(lf - rmax, rmin - lf), min=0)
    b = torch.clamp(torch.maximum(rs - lmax[None], lmin[None] - rs), min=0)
    ones = (1,) * (2 * r + 1)
    c = _taps(_taps(torch.minimum(a, b), 2, ones, r), 1, ones, r)
    return c.permute(1, 2, 0).contiguous()


# (scan axis, reverse, carry shift): H±, V±, then the four diagonals
_DEV_DIRS4 = ((1, False, 0), (1, True, 0), (0, False, 0), (0, True, 0))
_DEV_DIRS8 = _DEV_DIRS4 + ((0, False, 1), (0, False, -1),
                           (0, True, 1), (0, True, -1))


def _aggregate_into(s: torch.Tensor, c: torch.Tensor, axis: int, reverse: bool,
                    shift: int, p1: int, p2: int) -> int:
    """Add one SGM path over ``c [H, W, D]`` into ``s``, step by step along
    the scan axis (0 rows / 1 columns); returns the number of steps.

    The carry lives in a buffer with a ``_BIG`` column at each end of the
    disparity axis (the d±1 neighbours at the range ends) and a zero row
    at each end of the perpendicular axis: a diagonal path reads the
    carry one row over, and the zero row it takes in at the border is the
    SGM border condition (``cand(0) − min 0 ≡ 0``, so L = C there). No
    path volume is kept: each step's L is added into ``s`` at once."""
    n = c.shape[axis]
    m, nd = c.shape[1 - axis], c.shape[2]
    buf = torch.zeros((m + 2, nd + 2), dtype=torch.int32, device=c.device)
    buf[:, 0] = _BIG
    buf[:, -1] = _BIG
    rows = slice(1 - shift, m + 1 - shift)
    lp, up, dn = buf[rows, 1:-1], buf[rows, 2:], buf[rows, :-2]
    carry = buf[1:-1, 1:-1]
    t = torch.empty((m, nd), dtype=torch.int32, device=c.device)
    for k in (range(n - 1, -1, -1) if reverse else range(n)):
        minl = lp.amin(dim=-1, keepdim=True)
        torch.minimum(up, dn, out=t)
        t.add_(p1)
        torch.minimum(t, lp, out=t)
        torch.minimum(t, minl + p2, out=t)
        t.sub_(minl)
        t.add_(c.select(axis, k))
        carry.copy_(t)
        s.select(axis, k).add_(t)
    return n


def stereo_sgbm(
    left,
    right,
    num_disparities: int = 64,
    block_size: int = 5,
    p1: int | None = None,
    p2: int | None = None,
    uniqueness: int = 10,
    disp12_max_diff: int = 1,
    num_dirs: int = 8,
    prefilter_cap: int = 63,
):
    """u8 rectified pair (H, W) → (disparity float32 (H, W), valid bool),
    tensors on the pair's device (numpy goes to the card).

    Device twin of :func:`stereo_sgbm_numpy`: the integer pipeline is
    exact, the sub-pixel fraction float32 against the oracle's float64.
    The path recurrence is a Python loop over the scan axis, one int32
    ``[M, D]`` carry per step: W + H steps per horizontal and vertical
    pair, 2·H more for each diagonal pair (:data:`last_steps` holds the
    last call's count)."""
    global last_steps
    if p1 is None:
        p1 = 8 * block_size * block_size
    if p2 is None:
        p2 = 32 * block_size * block_size
    lt = as_tensor(left)
    dev = lt.device
    h, w = lt.shape
    r = block_size // 2
    lf = _prefilter(lt, prefilter_cap)
    rt = _prefilter(as_tensor(right, dev), prefilter_cap)
    c = _cost_volume(lf, rt, num_disparities, r)
    del lf, rt

    s = torch.zeros_like(c)
    steps = 0
    for axis, rev, shift in (_DEV_DIRS8 if num_dirs == 8 else _DEV_DIRS4):
        steps += _aggregate_into(s, c, axis, rev, shift, p1, p2)
    last_steps = steps
    del c

    smin, best = torch.min(s, dim=-1)
    d_axis = torch.arange(num_disparities, device=dev)
    near = (d_axis[None, None, :] - best[..., None]).abs() <= 1
    second = torch.where(near, _BIG, s).amin(dim=-1)
    unique = second * 100 >= smin * (100 + uniqueness)
    xcol = torch.arange(w, device=dev)[None, :]
    valid = unique & (xcol >= num_disparities - 1)

    if disp12_max_diff >= 0:
        # dispR(y, x) = argmin_d S(y, x + d, d), _BIG past the right edge
        sr = torch.full_like(s, _BIG)
        for d in range(min(num_disparities, w)):
            sr[:, :w - d, d] = s[:, d:, d]
        disp_r = torch.argmin(sr, dim=-1)
        del sr
        xr = torch.clamp(xcol - best, 0, w - 1)
        dr_at = torch.gather(disp_r, 1, xr)
        valid = valid & ((best - dr_at).abs() <= disp12_max_diff)

    dm1 = torch.clamp(best - 1, 0, num_disparities - 1)
    dp1 = torch.clamp(best + 1, 0, num_disparities - 1)
    cm = torch.gather(s, -1, dm1[..., None])[..., 0].to(torch.float32)
    cp = torch.gather(s, -1, dp1[..., None])[..., 0].to(torch.float32)
    c0 = smin.to(torch.float32)
    denom = cm - 2.0 * c0 + cp
    frac = torch.where(
        (best > 0) & (best < num_disparities - 1) & (denom > 0),
        torch.clamp((cm - cp) / (2.0 * torch.clamp(denom, min=1e-9)), -0.5, 0.5),
        0.0,
    )
    disp = torch.where(valid, best.to(torch.float32) + frac, 0.0)
    return disp, valid


last_steps = 0
