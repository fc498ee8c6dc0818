"""Histogram-of-Oriented-Gradients descriptors + sliding-window linear
SVM detection (port of ``rustcv_tpu.ops.hog``; OpenCV ``HOGDescriptor``
role, Dalal & Triggs 2005).

On the tensor's device:
- orientation soft-binning: each pixel's magnitude goes to its two
  orientation bins by two ``scatter_add_``s into 9 planes (one entry per
  pixel each, so the sums are exact in any order);
- spatial soft-binning (bilinear into the 4 neighboring cells) is
  separable: per axis two weight profiles and two pad+reshape group-sums;
- block normalization is elementwise; scoring every 8-px-stride window
  against a 3780-dim SVM is one 36-channel 15×7 correlation over the
  block grid (``conv2d`` in full float32 on the card).

Frozen spec (float64 oracle :func:`hog_cells_numpy` etc.):
- gradients: central differences on f64 u8 (replicate border), UNSIGNED
  orientation (mod 180°), 9 bins of 20°;
- orientation interpolation: ``b = ang/20 − 0.5``, linear split between
  ``floor(b) mod 9`` and ``(floor(b)+1) mod 9``;
- spatial interpolation: cell centers at ``8k + 3.5``; per axis the
  magnitude splits linearly between the two nearest cells (border
  contributions falling outside drop);
- blocks: 2×2 cells (stride 1 cell = 8 px), L2-Hys: normalize by
  ``√(‖v‖² + 1e-3²)``, clip at 0.2, renormalize;
- window (64×128): blocks row-major (y outer), cells row-major within
  block, bins innermost → 7·15·36 = 3780 dims;
- detection: score = w·desc + b on every 8-px grid window, candidates
  ≥ threshold, greedy IoU NMS (0.3) host-side.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .filters import _replicate_pad
from .tensors import full_f32

CELL = 8
NBINS = 9
BLOCK = 2              # cells per block side
WIN_W, WIN_H = 64, 128
_EPS = 1e-3
_CLIP = 0.2


# ---------------------------------------------------------------------------
# oracle (float64)
# ---------------------------------------------------------------------------

def _axis_profiles(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-pixel (w_lo, f) for one axis: cell centers at 8k+3.5."""
    x = np.arange(n, dtype=np.float64)
    c = (x - 3.5) / CELL
    f = c - np.floor(c)
    return 1.0 - f, f


def _group_cells(plane_lo: np.ndarray, plane_hi: np.ndarray,
                 axis: int) -> np.ndarray:
    """Separable spatial binning along ``axis`` (length must be a
    multiple of 8): pad 4, group-sum by 8; lo → groups[1:],
    hi → groups[:-1]."""
    n = plane_lo.shape[axis]
    ncell = n // CELL
    pad = [(0, 0)] * plane_lo.ndim
    pad[axis] = (4, 4)
    shp = list(plane_lo.shape)
    shp[axis:axis + 1] = [ncell + 1, CELL]

    def grouped(p):
        return np.pad(p, pad).reshape(shp).sum(axis=axis + 1)

    lo = grouped(plane_lo)
    hi = grouped(plane_hi)
    sl_lo = [slice(None)] * lo.ndim
    sl_lo[axis] = slice(1, None)
    sl_hi = [slice(None)] * hi.ndim
    sl_hi[axis] = slice(None, -1)
    return lo[tuple(sl_lo)] + hi[tuple(sl_hi)]


def hog_cells_numpy(img: np.ndarray) -> np.ndarray:
    """u8 gray (H, W), H/W multiples of 8 → cell histograms
    [H/8, W/8, 9] float64."""
    a = np.asarray(img, np.float64)
    h, w = a.shape
    if h % CELL or w % CELL:
        raise ValueError("image dims must be multiples of 8")
    p = np.pad(a, 1, mode="edge")
    dx = (p[1:-1, 2:] - p[1:-1, :-2]) * 0.5
    dy = (p[2:, 1:-1] - p[:-2, 1:-1]) * 0.5
    mag = np.hypot(dx, dy)
    ang = np.rad2deg(np.arctan2(dy, dx)) % 180.0
    b = ang / (180.0 / NBINS) - 0.5
    b0 = np.floor(b).astype(int)
    fb = b - b0
    b0 = b0 % NBINS
    b1 = (b0 + 1) % NBINS

    wy_lo, wy_f = _axis_profiles(h)
    wx_lo, wx_f = _axis_profiles(w)
    out = np.zeros((h // CELL, w // CELL, NBINS))
    for k in range(NBINS):
        vk = mag * ((b0 == k) * (1.0 - fb) + (b1 == k) * fb)
        colx = _group_cells(vk * wx_lo[None, :], vk * wx_f[None, :], 1)
        out[..., k] = _group_cells(colx * wy_lo[:, None],
                                   colx * wy_f[:, None], 0)
    return out


def _l2hys(v: np.ndarray) -> np.ndarray:
    n = np.sqrt((v * v).sum(axis=-1, keepdims=True) + _EPS * _EPS)
    v = np.minimum(v / n, _CLIP)
    n = np.sqrt((v * v).sum(axis=-1, keepdims=True) + _EPS * _EPS)
    return v / n


def hog_blocks_numpy(img: np.ndarray) -> np.ndarray:
    """→ normalized block grid [H/8−1, W/8−1, 36] float64."""
    c = hog_cells_numpy(img)
    blocks = np.concatenate([
        c[:-1, :-1], c[:-1, 1:], c[1:, :-1], c[1:, 1:]], axis=-1)
    return _l2hys(blocks)


def hog_window_numpy(img: np.ndarray) -> np.ndarray:
    """64×128 u8 window → 3780-dim descriptor (row-major blocks)."""
    if img.shape != (WIN_H, WIN_W):
        raise ValueError("window must be 128x64")
    return hog_blocks_numpy(img).reshape(-1)


def hog_score_map_numpy(img: np.ndarray, svm_w: np.ndarray,
                        svm_b: float) -> np.ndarray:
    """Linear-SVM score of every 8-px-stride 64×128 window →
    [n_win_y, n_win_x] float64."""
    blocks = hog_blocks_numpy(img)
    by, bx, _ = blocks.shape
    wby, wbx = WIN_H // CELL - 1, WIN_W // CELL - 1
    wt = np.asarray(svm_w, np.float64).reshape(wby, wbx, 4 * NBINS)
    ny, nx = by - wby + 1, bx - wbx + 1
    if ny <= 0 or nx <= 0:
        return np.zeros((0, 0))
    out = np.full((ny, nx), float(svm_b))
    for i in range(wby):
        for j in range(wbx):
            out += np.einsum("yxk,k->yx",
                             blocks[i:i + ny, j:j + nx], wt[i, j])
    return out


# ---------------------------------------------------------------------------
# tensors (float32)
# ---------------------------------------------------------------------------

def _group(p: torch.Tensor, axis: int) -> torch.Tensor:
    """Pad 4 on both sides of ``axis`` and sum groups of 8 along it."""
    n = p.shape[axis]
    pad = [0, 0] * (p.ndim - axis - 1) + [4, 4]
    shp = list(p.shape)
    shp[axis:axis + 1] = [n // CELL + 1, CELL]
    return F.pad(p, pad).reshape(shp).sum(dim=axis + 1)


def hog_blocks(img: torch.Tensor) -> torch.Tensor:
    """Tensor twin of :func:`hog_blocks_numpy` (float32, ~1e-4): u8 gray
    (H, W), H/W multiples of 8 → [H/8−1, W/8−1, 36] on its device."""
    a = img.to(torch.float32)
    h, w = a.shape
    if h % CELL or w % CELL:
        raise ValueError("image dims must be multiples of 8")
    dev = a.device
    p = _replicate_pad(_replicate_pad(a, 0, 1), 1, 1)
    dx = (p[1:-1, 2:] - p[1:-1, :-2]) * 0.5
    dy = (p[2:, 1:-1] - p[:-2, 1:-1]) * 0.5
    mag = torch.hypot(dx, dy)
    ang = torch.rad2deg(torch.atan2(dy, dx)) % 180.0
    b = ang / (180.0 / NBINS) - 0.5
    b0f = torch.floor(b)
    fb = b - b0f
    b0 = b0f.to(torch.int64) % NBINS
    b1 = (b0 + 1) % NBINS
    planes = torch.zeros((NBINS, h, w), dtype=torch.float32, device=dev)
    planes.scatter_add_(0, b0[None], (mag * (1.0 - fb))[None])
    planes.scatter_add_(0, b1[None], (mag * fb)[None])

    wy_lo, wy_f = (torch.as_tensor(v, dtype=torch.float32, device=dev)[:, None]
                   for v in _axis_profiles(h))
    wx_lo, wx_f = (torch.as_tensor(v, dtype=torch.float32, device=dev)[None, :]
                   for v in _axis_profiles(w))
    colx = _group(planes * wx_lo, 2)[:, :, 1:] + _group(planes * wx_f, 2)[:, :, :-1]
    cells = _group(colx * wy_lo, 1)[:, 1:, :] + _group(colx * wy_f, 1)[:, :-1, :]
    c = cells.permute(1, 2, 0)
    blocks = torch.cat([c[:-1, :-1], c[:-1, 1:], c[1:, :-1], c[1:, 1:]], dim=-1)
    n = torch.sqrt((blocks * blocks).sum(-1, keepdim=True) + _EPS * _EPS)
    v = torch.clamp(blocks / n, max=_CLIP)
    n = torch.sqrt((v * v).sum(-1, keepdim=True) + _EPS * _EPS)
    return v / n


def hog_score_map(img: torch.Tensor, svm_w, svm_b) -> torch.Tensor:
    """Sliding-window scores on the device: the 15×7×36 SVM correlated over
    the block grid in one ``conv2d`` → [n_win_y, n_win_x] float32."""
    blocks = hog_blocks(img)
    by, bx, _ = blocks.shape
    wby, wbx = WIN_H // CELL - 1, WIN_W // CELL - 1
    wt = torch.as_tensor(np.asarray(svm_w, np.float32) if not isinstance(svm_w, torch.Tensor)
                         else svm_w, device=blocks.device).to(torch.float32)
    wt = wt.reshape(wby, wbx, 4 * NBINS).permute(2, 0, 1)[None]
    if by < wby or bx < wbx:
        return torch.zeros((0, 0), dtype=torch.float32, device=blocks.device)
    with full_f32(blocks.device):
        out = F.conv2d(blocks.permute(2, 0, 1)[None], wt)[0, 0]
    return out + torch.as_tensor(svm_b, dtype=torch.float32, device=blocks.device)


def detect_multi_scale(img, svm_w: np.ndarray, svm_b: float,
                       threshold: float = 0.0, scale: float = 1.2,
                       nms_iou: float = 0.3, use_device: bool = False):
    """Pyramid sliding-window detection → (boxes int [N, 4] (x, y, w,
    h) in original coords, scores float [N]) after greedy NMS. A tensor
    ``img`` (or ``use_device`` with a numpy one, then on the card) is
    scored and resized on its device, with the same fixed-point resize;
    each score map is read back once."""
    if isinstance(img, torch.Tensor) or use_device:
        from .resize import resize_bilinear

        img = torch.as_tensor(img, device=img.device if isinstance(img, torch.Tensor) else "cuda")

        def score(crop):
            return hog_score_map(crop, svm_w, svm_b).cpu().numpy()
    else:
        from .golden import resize_bilinear

        img = np.asarray(img)

        def score(crop):
            return hog_score_map_numpy(crop, svm_w, svm_b)

    boxes, scores = [], []
    s = 1.0
    cur = img
    while cur.shape[0] >= WIN_H and cur.shape[1] >= WIN_W:
        ch = (cur.shape[0] // CELL) * CELL
        cw = (cur.shape[1] // CELL) * CELL
        sm = score(cur[:ch, :cw])
        for yy, xx in np.argwhere(sm >= threshold):
            boxes.append((int(round(xx * CELL * s)),
                          int(round(yy * CELL * s)),
                          int(round(WIN_W * s)), int(round(WIN_H * s))))
            scores.append(float(sm[yy, xx]))
        s *= scale
        nh, nw = int(img.shape[0] / s), int(img.shape[1] / s)
        if nh < WIN_H or nw < WIN_W:
            break
        cur = resize_bilinear(img[..., None], nw, nh)[..., 0] \
            if img.ndim == 2 else resize_bilinear(img, nw, nh)
    return _nms(boxes, scores, nms_iou)


def _nms(boxes, scores, nms_iou: float):
    """Greedy IoU suppression in descending score order (stable)."""
    if not boxes:
        return np.zeros((0, 4), int), np.zeros(0)
    bx = np.asarray(boxes)
    sc = np.asarray(scores)
    order = np.argsort(-sc, kind="stable")
    keep = []
    for i in order:
        ok = True
        for j in keep:
            xa = max(bx[i, 0], bx[j, 0])
            ya = max(bx[i, 1], bx[j, 1])
            xb = min(bx[i, 0] + bx[i, 2], bx[j, 0] + bx[j, 2])
            yb = min(bx[i, 1] + bx[i, 3], bx[j, 1] + bx[j, 3])
            inter = max(xb - xa, 0) * max(yb - ya, 0)
            union = bx[i, 2] * bx[i, 3] + bx[j, 2] * bx[j, 3] - inter
            if union > 0 and inter / union > nms_iou:
                ok = False
                break
        if ok:
            keep.append(i)
    return bx[keep], sc[keep]
