"""Generalized Hough transform (port of ``rustcv_tpu.ops.ghough``), Ballard
variant (OpenCV ``createGeneralizedHoughBallard`` role): detect translated
instances of an arbitrary edge template.

Frozen spec (float-free voting, int32 accumulator):
- template: edge pixels from our Canny spec; gradient orientation from
  the 3×3 Sobel pair, quantized to ``levels`` bins over [0, 2π);
  R-table bin b holds the displacements (centre − edge pixel) of all
  template edges with orientation b (deduplicated);
- detect: image edges + orientations the same way; every edge pixel
  with orientation b casts one vote at p + r for each r in bin b;
  peaks = local 3×3 maxima ≥ votes_threshold, sorted by votes.

The reference's device twin shifts a per-bin edge mask once per R-table
entry in a ``lax.scan`` (a TPU has no scatter). The port's twin
(:func:`_accumulate_device`) casts every (entry, edge point) vote in one
flattened integer ``bincount`` on the image's device, and quantizes the
orientations in float64 as the oracle does. Integer votes: bit-exact
against the numpy oracle. ``ghough_detect_guil`` is host numpy, as in the
reference.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .golden import canny, sobel3_gray


def _orientations(gray: np.ndarray, levels: int) -> np.ndarray:
    gx, gy = sobel3_gray(np.asarray(gray))
    ang = np.arctan2(gy.astype(np.float64), gx.astype(np.float64))
    b = np.round(ang / (2.0 * np.pi / levels)).astype(np.int64) % levels
    return b


def build_r_table(template_gray: np.ndarray, levels: int = 64,
                  canny_low: int = 40, canny_high: int = 90
                  ) -> np.ndarray:
    """→ (K, 3) int32 rows (bin, dy, dx): displacements from edge
    pixels to the template centre, grouped by quantized orientation."""
    t = np.asarray(template_gray)
    edges = canny(t, canny_low, canny_high) > 0
    bins = _orientations(t, levels)
    cy, cx = (t.shape[0] - 1) / 2.0, (t.shape[1] - 1) / 2.0
    ys, xs = np.nonzero(edges)
    rows = np.stack([bins[ys, xs],
                     np.round(cy - ys).astype(np.int64),
                     np.round(cx - xs).astype(np.int64)], axis=1)
    return np.unique(rows, axis=0).astype(np.int32)


def ghough_accumulate_numpy(gray: np.ndarray, r_table: np.ndarray,
                            levels: int = 64, canny_low: int = 40,
                            canny_high: int = 90) -> np.ndarray:
    """Oracle — int32 vote accumulator (H, W)."""
    g = np.asarray(gray)
    h, w = g.shape
    edges = canny(g, canny_low, canny_high) > 0
    bins = _orientations(g, levels)
    acc = np.zeros((h, w), np.int32)
    ys, xs = np.nonzero(edges)
    bs = bins[ys, xs]
    for b, dy, dx in r_table:
        sel = bs == b
        vy = ys[sel] + dy
        vx = xs[sel] + dx
        ok = (vy >= 0) & (vy < h) & (vx >= 0) & (vx < w)
        np.add.at(acc, (vy[ok], vx[ok]), 1)
    return acc


def _accumulate_device(gray: torch.Tensor, table: np.ndarray, levels: int = 64,
                       canny_low: int = 40, canny_high: int = 90) -> torch.Tensor:
    """Device twin: every (R-table entry, edge point of the entry's bin)
    pair casts one vote at point + displacement, all pairs at once in one
    integer ``bincount`` on the image's device (exact, as the oracle)."""
    from . import filters as _filters

    dev = gray.device
    h, w = gray.shape
    edges = _filters.canny_u8(gray, canny_low, canny_high) > 0
    gx, gy = _filters.sobel3_gray(gray)
    ang = torch.atan2(gy.to(torch.float64), gx.to(torch.float64))
    bins = torch.remainder(torch.round(ang / (2.0 * np.pi / levels)).to(torch.int64), levels)
    pts = torch.nonzero(edges.reshape(-1)).reshape(-1)
    if pts.numel() == 0 or len(table) == 0:
        return torch.zeros((h, w), dtype=torch.int32, device=dev)
    pb = bins.reshape(-1)[pts]
    # edge points grouped by bin: order[start[b] : start[b] + count[b]]
    order = torch.argsort(pb, stable=True)
    count = torch.bincount(pb, minlength=levels)
    start = torch.cumsum(count, 0) - count
    tbl = torch.as_tensor(np.asarray(table, np.int64), device=dev)
    tb, tdy, tdx = tbl[:, 0], tbl[:, 1], tbl[:, 2]
    n_k = count[tb]
    entry = torch.repeat_interleave(torch.arange(len(tbl), device=dev), n_k)
    within = torch.arange(entry.numel(), device=dev) - (torch.cumsum(n_k, 0) - n_k)[entry]
    p = pts[order[start[tb][entry] + within]]
    vy = p // w + tdy[entry]
    vx = p % w + tdx[entry]
    ok = (vy >= 0) & (vy < h) & (vx >= 0) & (vx < w)
    acc = torch.bincount((vy * w + vx)[ok], minlength=h * w)
    return acc.to(torch.int32).reshape(h, w)


def ghough_accumulate(gray, r_table: np.ndarray, levels: int = 64,
                      canny_low: int = 40, canny_high: int = 90):
    """Dispatch: the numpy oracle for a numpy image, the device twin for a
    tensor (bit-exact: integer votes either way)."""
    if isinstance(gray, np.ndarray):
        return ghough_accumulate_numpy(gray, r_table, levels,
                                       canny_low, canny_high)
    return _accumulate_device(gray, r_table, levels, canny_low, canny_high)


def ghough_detect(gray, r_table: np.ndarray, votes_threshold: int,
                  levels: int = 64, canny_low: int = 40,
                  canny_high: int = 90
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """→ (positions (N, 2) float32 (x, y), votes (N,) int32), strongest
    first — OpenCV ``GeneralizedHoughBallard.detect`` role."""
    acc = ghough_accumulate(gray, r_table, levels, canny_low, canny_high)
    acc = acc.cpu().numpy() if isinstance(acc, torch.Tensor) else np.asarray(acc)
    h, w = acc.shape
    p = np.pad(acc, 1)
    is_peak = np.ones((h, w), bool)
    for dy in range(3):
        for dx in range(3):
            if dy == 1 and dx == 1:
                continue
            neigh = p[dy:dy + h, dx:dx + w]
            # strict on the lexicographically earlier side breaks ties
            if (dy, dx) < (1, 1):
                is_peak &= acc >= neigh
            else:
                is_peak &= acc > neigh
    is_peak &= acc >= votes_threshold
    ys, xs = np.nonzero(is_peak)
    votes = acc[ys, xs]
    order = np.argsort(-votes, kind="stable")
    pos = np.stack([xs[order], ys[order]], axis=1).astype(np.float32)
    return pos, votes[order].astype(np.int32)


def ghough_detect_guil(gray, r_table: np.ndarray, votes_threshold: int,
                       angles=np.deg2rad(np.arange(-40, 41, 10)),
                       scales=(0.8, 1.0, 1.25), levels: int = 64,
                       canny_low: int = 40, canny_high: int = 90
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                  np.ndarray]:
    """Rotation/scale-aware variant (OpenCV
    ``createGeneralizedHoughGuil`` role): vote each (angle, scale)
    hypothesis with the transformed R-table (displacements rotated and
    scaled, orientation bins shifted by the same angle), keep the
    best-scoring hypothesis per accumulator peak → (positions (N, 2)
    float32 (x, y), votes (N,), angles_rad (N,), scales (N,)),
    strongest first."""
    g = np.asarray(gray)
    h, w = g.shape
    edges = canny(g, canny_low, canny_high) > 0
    bins = _orientations(g, levels)
    ys, xs = np.nonzero(edges)
    bs = bins[ys, xs]

    best_votes = np.zeros((h, w), np.int32)
    best_ang = np.zeros((h, w), np.float64)
    best_scl = np.ones((h, w), np.float64)
    tbl = np.asarray(r_table, np.int64)
    for ang in np.atleast_1d(angles):
        ca, sa = np.cos(ang), np.sin(ang)
        bshift = int(np.round(ang / (2.0 * np.pi / levels)))
        for scl in scales:
            acc = np.zeros((h, w), np.int32)
            for b, dy, dx in tbl:
                # rotate the displacement by ang, scale by scl
                rdx = scl * (ca * dx - sa * dy)
                rdy = scl * (sa * dx + ca * dy)
                # ±1 orientation-bin tolerance absorbs the angle-grid
                # quantization (10° grid vs 5.6° bins)
                dbin = (bs - (b + bshift)) % levels
                sel = (dbin <= 1) | (dbin >= levels - 1)
                vy = ys[sel] + int(np.round(rdy))
                vx = xs[sel] + int(np.round(rdx))
                ok = (vy >= 0) & (vy < h) & (vx >= 0) & (vx < w)
                np.add.at(acc, (vy[ok], vx[ok]), 1)
            # 3×3 vote smoothing before hypothesis competition
            pa = np.pad(acc, 1)
            sm = sum(pa[dy:dy + h, dx:dx + w]
                     for dy in range(3) for dx in range(3))
            better = sm > best_votes
            best_votes = np.where(better, sm, best_votes)
            best_ang = np.where(better, ang, best_ang)
            best_scl = np.where(better, scl, best_scl)

    # peak extraction (same tie-safe 3×3 NMS as the Ballard path)
    p = np.pad(best_votes, 1)
    is_peak = np.ones((h, w), bool)
    for dy in range(3):
        for dx in range(3):
            if dy == 1 and dx == 1:
                continue
            neigh = p[dy:dy + h, dx:dx + w]
            if (dy, dx) < (1, 1):
                is_peak &= best_votes >= neigh
            else:
                is_peak &= best_votes > neigh
    is_peak &= best_votes >= votes_threshold
    py, px = np.nonzero(is_peak)
    votes = best_votes[py, px]
    order = np.argsort(-votes, kind="stable")
    return (np.stack([px[order], py[order]], 1).astype(np.float32),
            votes[order].astype(np.int32),
            best_ang[py, px][order], best_scl[py, px][order])
