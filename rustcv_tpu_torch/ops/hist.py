"""Histogram ops (port of ``rustcv_tpu.ops.hist``: OpenCV ``calcHist``,
``LUT``, ``equalizeHist``, CLAHE, ``calcBackProject`` for hue,
``meanShift`` and ``CamShift``), on tensors where the caller's tensor is.

The counts are integer ``bincount``s (CLAHE's tiles one ``bincount`` over
an index offset by 256 per tile) and a lookup is a gather ``lut[img]``: no
float arithmetic touches a count or a table entry, so every op here equals
the reference's frozen spec and its numpy oracle bit for bit.

- ``calc_hist``: hist[b] = #pixels with value b (int32).
- ``equalize_hist``: cv2's own float32 LUT, cvRound(f32(cdf − cdf_min) ·
  (255.f / f32(N − cdf_min))), round half to even; identity for a
  constant image.
- ``clahe``: edge-pad to grid multiples (tiles th×tw); clip limit
  L = max(1, clip_limit·th·tw // 256); the excess redistributes as
  +excess//256 per bin and +1 to the first excess%256; lut[i] =
  (255·cdf[i] + n//2) // n; bilinear interpolation of the four nearest
  tiles' LUTs on the half-tile-shifted lattice with integer weights
  (2r+1), (Σ w·lut + D//2) // D, D = 4·th·tw; crop.

``calc_hue_hist``, ``mean_shift`` and ``cam_shift`` are host numpy, as in
the reference; ``back_project_hue`` keeps a tensor's hue on its device.
"""

from __future__ import annotations

import numpy as np
import torch


def calc_hist_numpy(gray: np.ndarray) -> np.ndarray:
    return np.bincount(gray.reshape(-1), minlength=256).astype(np.int32)


def equalize_hist_numpy(gray: np.ndarray) -> np.ndarray:
    """Bit-exact cv2.equalizeHist: the LUT is cvRound(f32(sum) * f32
    scale) with scale = 255.f/(total - hist[first]) — the f32 product
    and the round-half-to-even must BOTH be replicated or knife-edge
    CDF values flip by 1 LSB."""
    hist = calc_hist_numpy(gray).astype(np.int64)
    cdf = np.cumsum(hist)
    n = int(cdf[-1])
    populated = np.nonzero(hist)[0]
    cdf_min = int(cdf[populated[0]]) if populated.size else 0
    denom = n - cdf_min
    if denom <= 0:
        return gray.copy()  # constant image: identity
    scale = np.float32(255.0) / np.float32(denom)
    lut = np.rint((cdf - cdf_min).astype(np.float32) * scale)
    return np.clip(lut, 0, 255).astype(np.uint8)[gray]


def calc_hist(gray: torch.Tensor) -> torch.Tensor:
    """u8 tensor (any shape) → [256] int32 counts (exact)."""
    return torch.bincount(gray.reshape(-1), minlength=256).to(torch.int32)


def apply_lut(img: torch.Tensor, lut) -> torch.Tensor:
    """u8 tensor (any shape) × 256-entry LUT → the LUT's dtype, ``lut[img]``
    (OpenCV ``LUT``); a host table is uploaded to the image's device."""
    table = torch.as_tensor(np.asarray(lut) if not torch.is_tensor(lut) else lut,
                            device=img.device).reshape(256)
    return table[img.to(torch.int64)]


def equalize_hist(gray: torch.Tensor) -> torch.Tensor:
    """Histogram equalization, bit-exact vs cv2 at any size (cv2's float32
    LUT arithmetic), all on the tensor's device."""
    hist = calc_hist(gray).to(torch.int64)
    cdf = torch.cumsum(hist, 0)
    first = torch.argmax((hist > 0).to(torch.uint8))  # lowest populated bin
    cdf_min = cdf[first]
    denom = cdf[-1] - cdf_min
    scale = torch.tensor(255.0, dtype=torch.float32, device=gray.device) / (
        denom.clamp(min=1).to(torch.float32))
    lut = torch.round((cdf - cdf_min).to(torch.float32) * scale).clamp(0, 255).to(torch.uint8)
    return torch.where(denom > 0, lut[gray.to(torch.int64)], gray)


# ---------------------------------------------------------------------------
# CLAHE
# ---------------------------------------------------------------------------


def clahe_numpy(
    gray: np.ndarray, clip_limit: int = 40, grid: tuple = (8, 8)
) -> np.ndarray:
    """Float-free CLAHE oracle (see the frozen spec above)."""
    gy, gx = grid
    h, w = gray.shape
    th = -(-h // gy)
    tw = -(-w // gx)
    img = np.pad(gray, ((0, gy * th - h), (0, gx * tw - w)), mode="edge")
    n = th * tw
    limit = max(1, clip_limit * n // 256)
    tiles = img.reshape(gy, th, gx, tw).transpose(0, 2, 1, 3)
    luts = np.zeros((gy, gx, 256), np.int64)
    for i in range(gy):
        for j in range(gx):
            hst = np.bincount(tiles[i, j].reshape(-1), minlength=256).astype(np.int64)
            excess = int(np.maximum(hst - limit, 0).sum())
            hst = np.minimum(hst, limit) + excess // 256
            hst[: excess % 256] += 1
            cdf = np.cumsum(hst)
            luts[i, j] = np.clip((255 * cdf + n // 2) // n, 0, 255)
    pimg = np.pad(
        img, ((th // 2, th - th // 2), (tw // 2, tw - tw // 2)), mode="edge"
    )
    cy, cx = gy + 1, gx + 1
    cells = pimg.reshape(cy, th, cx, tw).transpose(0, 2, 1, 3).astype(np.int64)
    wy = (2 * np.arange(th) + 1).reshape(th, 1)
    wx = (2 * np.arange(tw) + 1).reshape(1, tw)
    d = 4 * th * tw
    out = np.zeros_like(cells)
    for i in range(cy):
        for j in range(cx):
            p = cells[i, j]
            v = []
            for di in (0, 1):
                for dj in (0, 1):
                    ti = min(max(i - 1 + di, 0), gy - 1)
                    tj = min(max(j - 1 + dj, 0), gx - 1)
                    v.append(luts[ti, tj][p])
            acc = (
                (2 * th - wy) * (2 * tw - wx) * v[0]
                + (2 * th - wy) * wx * v[1]
                + wy * (2 * tw - wx) * v[2]
                + wy * wx * v[3]
            )
            out[i, j] = (acc + d // 2) // d
    res = out.transpose(0, 2, 1, 3).reshape(cy * th, cx * tw)
    res = res[th // 2 : th // 2 + gy * th, tw // 2 : tw // 2 + gx * tw]
    return np.clip(res, 0, 255).astype(np.uint8)[:h, :w]


def _lattice(n_out: int, t: int, g: int, device):
    """Per output row (or column) of the interpolation: the weight 2r+1 of
    its position r in its half-tile-shifted cell, and the tiles of the
    cell's two corners, clamped to the grid."""
    s = torch.arange(n_out, device=device) + t // 2  # position in the shifted lattice
    cell = s // t
    return 2 * (s % t) + 1, (cell - 1).clamp(0, g - 1), cell.clamp(0, g - 1)


def clahe(gray: torch.Tensor, clip_limit: int = 40, grid: tuple = (8, 8)) -> torch.Tensor:
    """Contrast-limited adaptive histogram equalization (OpenCV
    ``createCLAHE`` role), bit-exact vs :func:`clahe_numpy`: one bincount
    for every tile's histogram, the LUTs in int64, and four gathers of the
    corner tiles' LUTs per pixel."""
    gy, gx = grid
    h, w = gray.shape
    th = -(-h // gy)
    tw = -(-w // gx)
    dev = gray.device
    rows = torch.arange(gy * th, device=dev).clamp(max=h - 1)
    cols = torch.arange(gx * tw, device=dev).clamp(max=w - 1)
    img = gray.to(torch.int64).index_select(0, rows).index_select(1, cols)  # edge pad
    n = th * tw
    limit = max(1, clip_limit * n // 256)
    tile = ((torch.arange(gy * th, device=dev) // th)[:, None] * gx
            + (torch.arange(gx * tw, device=dev) // tw)[None, :])
    hist = torch.bincount((tile * 256 + img).reshape(-1),
                          minlength=gy * gx * 256).reshape(gy * gx, 256)
    excess = (hist - limit).clamp(min=0).sum(dim=-1, keepdim=True)
    hist = hist.clamp(max=limit) + excess // 256
    hist = hist + (torch.arange(256, device=dev) < excess % 256).to(torch.int64)
    cdf = torch.cumsum(hist, dim=-1)
    luts = ((255 * cdf + n // 2) // n).clamp(0, 255).reshape(-1)  # [tile * 256 + value]

    wy, ty0, ty1 = _lattice(h, th, gy, dev)
    wx, tx0, tx1 = _lattice(w, tw, gx, dev)
    p = img[:h, :w]
    wy, ty0, ty1 = wy[:, None], ty0[:, None], ty1[:, None]
    wx, tx0, tx1 = wx[None, :], tx0[None, :], tx1[None, :]

    def lut_at(ty, tx):
        return luts[(ty * gx + tx) * 256 + p]

    d = 4 * th * tw
    acc = ((2 * th - wy) * (2 * tw - wx) * lut_at(ty0, tx0)
           + (2 * th - wy) * wx * lut_at(ty0, tx1)
           + wy * (2 * tw - wx) * lut_at(ty1, tx0)
           + wy * wx * lut_at(ty1, tx1))
    return ((acc + d // 2) // d).clamp(0, 255).to(torch.uint8)


def calc_hue_hist(hsv: np.ndarray, mask: np.ndarray = None) -> np.ndarray:
    """Normalized 180-bin hue histogram of an HSV image (host; optionally
    restricted to ``mask`` != 0) — the model half of
    :func:`back_project_hue`."""
    hue = np.asarray(hsv)[..., 0].reshape(-1)
    if mask is not None:
        hue = hue[np.asarray(mask).reshape(-1) != 0]
    h = np.bincount(hue, minlength=256)[:180].astype(np.float64)
    s = h.sum()
    return h / s if s > 0 else h


def _hue_lut(hue_hist) -> np.ndarray:
    h = np.asarray(hue_hist, np.float64).reshape(-1)
    nbins = min(len(h), 180)
    h = h[:nbins]
    peak = h.max() if nbins else 0.0
    lut = np.zeros(256, np.uint8)
    if peak > 0:
        bins = (np.arange(180) * nbins) // 180
        lut[:180] = np.clip(np.round(255.0 * h[bins] / peak), 0, 255).astype(
            np.uint8
        )
    return lut


def back_project_hue(hsv, hue_hist: np.ndarray):
    """Histogram backprojection (OpenCV ``calcBackProject`` for the hue
    channel): per-pixel likelihood u8 = 255·hist[bin(hue)]/max(hist) — the
    CamShift/mean-shift tracking weight image. Models with fewer than 180
    bins map via bin = hue·nbins // 180 (the common 16-bin usage). A tensor
    stays on its device (a tensor comes back); a numpy array is looked up
    on the host."""
    lut = _hue_lut(hue_hist)
    a = hsv if hasattr(hsv, "ndim") else np.asarray(hsv)
    hue = a[..., 0] if a.ndim == 3 else a
    if torch.is_tensor(hue):
        return apply_lut(hue, lut)
    return lut[np.asarray(hue)]


def mean_shift(prob: np.ndarray, window: tuple, max_iter: int = 20,
               eps: float = 0.0):
    """OpenCV ``meanShift``: iterate the search window to the centroid of
    the weight image (e.g. :func:`back_project_hue` output) until the
    shift is below ``eps`` or ``max_iter``. ``window`` = (x, y, w, h);
    returns (iterations_used, final_window)."""
    p = np.asarray(prob, np.float64)
    hh, ww = p.shape[:2]
    x, y, w, h = (int(v) for v in window)
    w = max(1, min(w, ww))
    h = max(1, min(h, hh))
    x = min(max(x, 0), ww - w)  # clamp BEFORE the loop too (max_iter=0
    y = min(max(y, 0), hh - h)  # must still return an in-bounds window)
    it = 0
    for it in range(1, max_iter + 1):
        x = min(max(x, 0), ww - w)
        y = min(max(y, 0), hh - h)
        roi = p[y : y + h, x : x + w]
        m00 = roi.sum()
        if m00 <= 0:
            break
        xs = np.arange(w)
        ys = np.arange(h)
        cx = (roi.sum(axis=0) * xs).sum() / m00
        cy = (roi.sum(axis=1) * ys).sum() / m00
        # window center INDEX is x + (w-1)/2; move it onto the centroid
        nx = int(round(x + cx - (w - 1) / 2.0))
        ny = int(round(y + cy - (h - 1) / 2.0))
        nx = min(max(nx, 0), ww - w)
        ny = min(max(ny, 0), hh - h)
        if abs(nx - x) <= eps and abs(ny - y) <= eps:
            x, y = nx, ny
            break
        x, y = nx, ny
    return it, (x, y, w, h)


def cam_shift(prob: np.ndarray, window: tuple, max_iter: int = 10):
    """OpenCV ``CamShift`` (simplified): meanShift convergence, then the
    window resizes from the zeroth moment (s = 2·√(m00/255), CamShift's
    classic rule) and recenters. Returns ((cx, cy, w, h), window)."""
    it, (x, y, w, h) = mean_shift(prob, window, max_iter=max_iter)
    p = np.asarray(prob, np.float64)
    roi = p[y : y + h, x : x + w]
    m00 = roi.sum()
    if m00 > 0:
        s = int(round(2.0 * np.sqrt(m00 / 255.0)))
        nw = max(4, s)
        nh = max(4, int(round(s * h / max(w, 1))))
        cx = x + w / 2.0
        cy = y + h / 2.0
        x = int(round(cx - nw / 2.0))
        y = int(round(cy - nh / 2.0))
        w, h = nw, nh
        hh, ww = p.shape[:2]
        w = min(w, ww)
        h = min(h, hh)
        x = min(max(x, 0), ww - w)
        y = min(max(y, 0), hh - h)
    return (x + w / 2.0, y + h / 2.0, w, h), (x, y, w, h)
