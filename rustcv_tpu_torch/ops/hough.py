"""Hough transforms (port of ``rustcv_tpu.ops.hough``): standard lines
(OpenCV ``HoughLines``), gradient circles (``HoughCircles``) and the
deterministic segment spec (``HoughLinesP`` role), with the numpy oracles.

The reference compacts edge points with ``top_k`` over a raster-ordered
score and accumulates votes as one-hot hi/lo matmuls, because a TPU has no
scatter. Here the edge points are the first ``max_points`` nonzeros in
raster order and the votes are integer ``bincount``s: into
``[n_thetas, rho_bins]`` for lines, into the ``hq × wq`` centre grid over
every radius at once for circles, and into ``[K, n_radii]`` for each
circle's radius. Peaks are taken by a stable descending sort, so among
equal votes the lower flat index comes first, as ``top_k`` gives it.

Float32 rounding (the reference's jitted program on XLA): the line
``rho = cos·x + sin·y`` is contracted to ``fma(cos, x, sin·y)`` and the bin
scale ``(rho_bins − 1) / (2·diag)`` is folded into one float32 constant;
the circle centre ``x − r·n`` is ``fma(−r, n, x)`` and its division by
``dp`` a multiply by the float32 reciprocal; the output ``rho`` is
``fma(bin, step, −diag)`` with ``step`` folded in float32. The
contractions are computed exactly in float64 and rounded once to float32,
on the CPU and on the card alike, so the bins and values are the
reference's.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .tensors import as_tensor


def _edge_points(flag: torch.Tensor, max_points: int) -> torch.Tensor:
    """Flat indices of the first ``max_points`` set flags in raster order."""
    return torch.nonzero(flag.reshape(-1)).reshape(-1)[:max_points]


def _peaks_desc(flat: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest values and their indices, lower index first among
    equal values (``lax.top_k``'s order)."""
    vals, idx = torch.sort(flat, descending=True, stable=True)
    return vals[:k], idx[:k]


def _nms3(acc: torch.Tensor) -> torch.Tensor:
    """3×3 wrap-around maximum of the other eight neighbours and itself."""
    best = acc
    for d0 in (-1, 0, 1):
        for d1 in (-1, 0, 1):
            if d0 == 0 and d1 == 0:
                continue
            best = torch.maximum(best, torch.roll(acc, (d0, d1), (0, 1)))
    return best


def hough_lines(
    edges,
    n_thetas: int = 180,
    rho_bins: int = 2048,
    max_points: int = 65536,
    max_lines: int = 32,
    threshold: int = 50,
):
    """Binary edge mask (H, W) u8 → (lines [max_lines, 2] float32
    (rho, theta-radians), valid bool, votes int32), tensors on the mask's
    device (a numpy mask goes to the card).

    ``rho`` spans [−D, D] (D = image diagonal) over ``rho_bins`` bins;
    thetas cover [0, π). Edge points beyond ``max_points`` are dropped
    (raster order)."""
    e = as_tensor(edges)
    dev = e.device
    h, w = e.shape
    diag = float(np.hypot(h, w))
    idx = _edge_points(e != 0, min(max_points, h * w))
    ys = (idx // w).to(torch.float64)
    xs = (idx % w).to(torch.float64)

    thetas = np.arange(n_thetas, dtype=np.float64) * (np.pi / n_thetas)
    cos_t = torch.from_numpy(np.cos(thetas).astype(np.float32)).to(dev)
    sin_t = torch.from_numpy(np.sin(thetas).astype(np.float32)).to(dev)
    sy = (sin_t[:, None] * ys.to(torch.float32)[None, :]).to(torch.float64)
    rho = (cos_t.to(torch.float64)[:, None] * xs[None, :] + sy).to(torch.float32)
    scale = np.float32(rho_bins - 1) / np.float32(2.0 * diag)
    binf = (rho + np.float32(diag)) * float(scale)
    b = torch.clamp(torch.round(binf), 0, rho_bins - 1).to(torch.int64)
    t = torch.arange(n_thetas, device=dev)[:, None]
    votes = torch.bincount((t * rho_bins + b).reshape(-1),
                           minlength=n_thetas * rho_bins).to(torch.int32)
    votes = votes.reshape(n_thetas, rho_bins)

    peak = (votes >= _nms3(votes)) & (votes >= threshold)
    flat_v = torch.where(peak, votes, 0).reshape(-1)
    topv, pidx = _peaks_desc(flat_v, max_lines)
    t_idx = pidx // rho_bins
    r_idx = pidx % rho_bins
    step = float(np.float32(2.0 * diag) / np.float32(rho_bins - 1))
    rho_val = (r_idx.to(torch.float64) * step - float(np.float32(diag))).to(torch.float32)
    theta_val = t_idx.to(torch.float32) * float(np.float32(np.pi / n_thetas))
    return torch.stack([rho_val, theta_val], dim=-1), topv > 0, topv


# ---------------------------------------------------------------------------
# NumPy oracle (classical accumulator, same quantization)
# ---------------------------------------------------------------------------


def hough_lines_numpy(
    edges: np.ndarray,
    n_thetas: int = 180,
    rho_bins: int = 2048,
    threshold: int = 50,
    max_lines: int = 32,
) -> Tuple[np.ndarray, np.ndarray]:
    h, w = edges.shape
    diag = float(np.hypot(h, w))
    ys, xs = np.nonzero(edges)
    thetas = np.arange(n_thetas, dtype=np.float64) * (np.pi / n_thetas)
    cos_t = np.cos(thetas).astype(np.float32)
    sin_t = np.sin(thetas).astype(np.float32)
    acc = np.zeros((n_thetas, rho_bins), np.int64)
    xf = xs.astype(np.float32)
    yf = ys.astype(np.float32)
    for t in range(n_thetas):
        rho = cos_t[t] * xf + sin_t[t] * yf
        binf = ((rho + np.float32(diag)) * np.float32(rho_bins - 1)) / np.float32(2.0 * diag)
        b = np.clip(np.round(binf), 0, rho_bins - 1).astype(np.int64)
        np.add.at(acc[t], b, 1)
    best = acc.copy()
    for dt in (-1, 0, 1):
        for dr in (-1, 0, 1):
            if dt == 0 and dr == 0:
                continue
            best = np.maximum(best, np.roll(np.roll(acc, dt, 0), dr, 1))
    peak = (acc >= best) & (acc >= threshold)
    flat = np.where(peak, acc, 0).reshape(-1)
    order = np.argsort(-flat, kind="stable")[:max_lines]
    keep = flat[order] > 0
    order = order[keep]
    t_idx = order // rho_bins
    r_idx = order % rho_bins
    rho_val = r_idx * (2.0 * diag) / (rho_bins - 1) - diag
    theta_val = t_idx * (np.pi / n_thetas)
    return np.stack([rho_val, theta_val], axis=-1), flat[order]


# ---------------------------------------------------------------------------
# HoughCircles
# ---------------------------------------------------------------------------


def hough_circles(
    gray,
    dp: int = 4,
    min_radius: int = 10,
    max_radius: int = 60,
    edge_threshold: int = 60,
    vote_threshold: int = 20,
    max_points: int = 4096,
    max_circles: int = 16,
):
    """Gradient (2-1) Hough circle transform (OpenCV ``HoughCircles``
    HOUGH_GRADIENT role) on u8 gray (H, W) → (circles [K, 3] float32
    (cx, cy, r), valid bool, votes int32) on the image's device. Callers
    apply min-dist dedup (the facade does greedy suppression).

    Both gradient directions vote into the ``H/dp × W/dp`` centre grid
    (at most 262144 bins, the reference's limit); each peak centre's
    radius is the arg-max of its edge points' rounded distances."""
    from .filters import sobel3_gray

    g = as_tensor(gray)
    dev = g.device
    h, w = g.shape
    hq, wq = (h + dp - 1) // dp, (w + dp - 1) // dp
    if hq * wq > 512 * 512:
        raise ValueError("H/dp * W/dp must be <= 262144 (raise dp)")
    n_r = max_radius - min_radius + 1

    gx, gy = sobel3_gray(g)
    edge = gx * gx + gy * gy > edge_threshold * edge_threshold
    idx = _edge_points(edge, min(max_points, h * w))
    ys = (idx // w).to(torch.float32)
    xs = (idx % w).to(torch.float32)
    gxe = gx.reshape(-1)[idx].to(torch.float64)
    gye = gy.reshape(-1)[idx].to(torch.float64)
    # integer squares: exact; 1/√ correctly rounded (float64, then float32)
    inv = (1.0 / torch.sqrt(torch.clamp(gxe * gxe + gye * gye, min=1.0))).to(torch.float32)
    nx = (gxe.to(torch.float32) * inv).to(torch.float64)
    ny = (gye.to(torch.float32) * inv).to(torch.float64)

    radii = torch.arange(min_radius, max_radius + 1, device=dev, dtype=torch.float64)[:, None]
    xd, yd = xs.to(torch.float64), ys.to(torch.float64)
    cx = torch.cat([(xd - radii * nx).to(torch.float32), (xd + radii * nx).to(torch.float32)], 1)
    cy = torch.cat([(yd - radii * ny).to(torch.float32), (yd + radii * ny).to(torch.float32)], 1)
    inv_dp = float(np.float32(1.0 / dp))  # XLA's reciprocal multiply
    qx = torch.round(cx * inv_dp).to(torch.int64)
    qy = torch.round(cy * inv_dp).to(torch.int64)
    ok = (qx >= 0) & (qx < wq) & (qy >= 0) & (qy < hq)
    acc = torch.bincount((qy * wq + qx)[ok], minlength=hq * wq).to(torch.int32).reshape(hq, wq)

    peak = (acc >= _nms3(acc)) & (acc >= vote_threshold)
    flat_v = torch.where(peak, acc, 0).reshape(-1)
    topv, pidx = _peaks_desc(flat_v, max_circles)
    pcy = (pidx // wq).to(torch.float32) * dp
    pcx = (pidx % wq).to(torch.float32) * dp

    # radius per centre: rounded distances (integer offsets: the squares
    # and their sum are exact) → [K, R] histogram
    dx = xs[None, :] - pcx[:, None]
    dy = ys[None, :] - pcy[:, None]
    rbin = torch.round(torch.sqrt(dx * dx + dy * dy)).to(torch.int64) - min_radius
    okr = (rbin >= 0) & (rbin < n_r)
    k = torch.arange(pidx.shape[0], device=dev)[:, None].expand_as(rbin)
    rhist = torch.bincount((k * n_r + rbin)[okr], minlength=pidx.shape[0] * n_r)
    rhist = rhist.reshape(pidx.shape[0], n_r)
    r_votes, r_best = torch.max(rhist, dim=1)
    radius = (r_best + min_radius).to(torch.float32)

    circ = torch.stack([pcx, pcy, radius], dim=-1)
    valid = (topv > 0) & (r_votes >= vote_threshold)
    # order by the final (radius-histogram) votes
    rank = torch.where(valid, r_votes, -1)
    _, order = _peaks_desc(rank, max_circles)
    return circ[order], valid[order], r_votes[order].to(torch.int32)


def hough_circles_numpy(
    gray: np.ndarray,
    dp: int = 4,
    min_radius: int = 10,
    max_radius: int = 60,
    edge_threshold: int = 60,
    vote_threshold: int = 20,
    max_points: int = 4096,
    max_circles: int = 16,
):
    """Oracle — classical scatter accumulator, same f32 quantization."""
    from . import golden

    h, w = gray.shape
    hq, wq = (h + dp - 1) // dp, (w + dp - 1) // dp
    n_r = max_radius - min_radius + 1
    gx, gy = golden.sobel3_gray(gray)
    edge = (gx.astype(np.int64) ** 2 + gy.astype(np.int64) ** 2
            > edge_threshold * edge_threshold)
    ys_a, xs_a = np.nonzero(edge)
    order = np.arange(len(ys_a))[:max_points]  # raster order, same cap
    ys = ys_a[order].astype(np.float32)
    xs = xs_a[order].astype(np.float32)
    gxe = gx[ys_a[order], xs_a[order]].astype(np.float32)
    gye = gy[ys_a[order], xs_a[order]].astype(np.float32)
    inv = np.float32(1.0) / np.sqrt(np.maximum(gxe * gxe + gye * gye, np.float32(1.0)))
    nx, ny = gxe * inv, gye * inv
    acc = np.zeros((hq, wq), np.float64)
    for r in np.arange(min_radius, max_radius + 1, dtype=np.float32):
        for sgn in (-1.0, 1.0):
            cx = xs + np.float32(sgn) * (r * nx)
            cy = ys + np.float32(sgn) * (r * ny)
            qx = np.round(cx / np.float32(dp)).astype(np.int64)
            qy = np.round(cy / np.float32(dp)).astype(np.int64)
            ok = (qx >= 0) & (qx < wq) & (qy >= 0) & (qy < hq)
            np.add.at(acc, (qy[ok], qx[ok]), 1.0)
    best = acc.copy()
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            best = np.maximum(best, np.roll(np.roll(acc, dy, 0), dx, 1))
    peak = (acc >= best) & (acc >= vote_threshold)
    flat = np.where(peak, acc, 0.0).reshape(-1)
    order2 = np.argsort(-flat, kind="stable")[:max_circles]
    out, votes = [], []
    for p in order2:
        if flat[p] <= 0:
            continue
        pcy = (p // wq) * dp
        pcx = (p % wq) * dp
        dist = np.sqrt((xs - np.float32(pcx)) ** 2 + (ys - np.float32(pcy)) ** 2)
        rbin = np.round(dist).astype(np.int64) - min_radius
        okr = (rbin >= 0) & (rbin < n_r)
        rhist = np.bincount(rbin[okr], minlength=n_r)
        rb = int(np.argmax(rhist))
        if rhist[rb] >= vote_threshold:
            out.append((float(pcx), float(pcy), float(rb + min_radius)))
            votes.append(int(rhist[rb]))
    out = np.array(out, np.float32).reshape(-1, 3)
    votes = np.array(votes, np.int32)
    order = np.argsort(-votes, kind="stable")  # final-vote order (device match)
    return out[order], votes[order]


def hough_lines_p(
    edges,
    n_thetas: int = 180,
    rho_bins: int = 2048,
    threshold: int = 50,
    min_line_length: float = 30.0,
    max_line_gap: float = 5.0,
    max_lines: int = 32,
    max_segments: int = 64,
    tol: float = 1.0,
):
    """Line segments (OpenCV ``HoughLinesP`` role), deterministic spec:
    the accumulator (:func:`hough_lines`, on a tensor's device; a numpy
    mask goes to the card) finds the top peak lines, then a host pass walks
    each line's inlier points (|x·cosθ + y·sinθ − rho| ≤ ``tol``), sorts
    them by projection along the line, splits where consecutive-point
    spacing exceeds ``max_line_gap`` and keeps spans of at least
    ``min_line_length``. Returns int32 [M, 4] (x1, y1, x2, y2),
    M ≤ max_segments, ordered by line strength then position."""
    lines, valid, _votes = hough_lines(
        edges, n_thetas=n_thetas, rho_bins=rho_bins,
        max_lines=max_lines, threshold=threshold,
    )
    lines = lines[valid].cpu().numpy()
    e = edges.cpu().numpy() if isinstance(edges, torch.Tensor) else np.asarray(edges)
    ys, xs = np.nonzero(e)
    segs = []
    used = np.zeros(xs.shape[0], bool)
    for rho_v, theta_v in lines:
        if len(segs) >= max_segments:
            break
        c, s = np.cos(theta_v), np.sin(theta_v)
        d = np.abs(xs * c + ys * s - rho_v)
        on = (d <= tol) & ~used
        if not on.any():
            continue
        px, py = xs[on], ys[on]
        proj = -px * s + py * c
        order = np.argsort(proj, kind="stable")
        px, py, proj = px[order], py[order], proj[order]
        breaks = np.flatnonzero(np.diff(proj) > max_line_gap)
        starts = np.concatenate([[0], breaks + 1])
        ends = np.concatenate([breaks, [proj.size - 1]])
        hit = np.flatnonzero(on)[order]
        for a, b in zip(starts, ends):
            if proj[b] - proj[a] >= min_line_length:
                segs.append((px[a], py[a], px[b], py[b]))
                used[hit[a:b + 1]] = True  # points consumed, like OpenCV
                if len(segs) >= max_segments:
                    break
    if not segs:
        return np.zeros((0, 4), np.int32)
    return np.asarray(segs, np.int32)
