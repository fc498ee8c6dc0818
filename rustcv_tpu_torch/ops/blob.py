"""Blob detection (copy of ``rustcv_tpu.ops.blob``; the OpenCV
``SimpleBlobDetector`` role).

Each threshold level's binarization + connected-component labeling (the
native union-find, ops/ccl.py); each component is traced alone in its
bounding box (the reference traces it in a whole-frame mask: the same
contour, in time that grows with the component, not the frame);
per-component geometry (area, perimeter,
circularity, convexity, inertia) uses the host contour utilities
(ops/shape.py) on O(perimeter) point lists. Centers are merged across
threshold levels and kept when they repeat — the OpenCV stability rule.

Frozen spec (OpenCV defaults unless noted):
- thresholds: min_threshold .. max_threshold step threshold_step; binary
  mask = gray < t for dark blobs (blob_color = 0), gray > t for bright
  (blob_color = 255);
- per component: contour (shoelace) area in [min_area, max_area];
  circularity =
  4πA/P² >= min_circularity (P = closed contour arc length); convexity =
  A/hull_area >= min_convexity; inertia ratio = λ_min/λ_max of the
  component's second central moments >= min_inertia; center = mask
  centroid;
- blobs across levels merge when centers are closer than
  min_dist_between_blobs; a blob must appear in >= min_repeatability
  levels; reported center/size = mean over its levels (size = mean
  equivalent-circle diameter).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np


def _component_pixels(labels: np.ndarray, n: int):
    """(ys, xs) of each component 1..n in raster order (what
    ``np.nonzero(labels == comp)`` gives), from one sort of the
    foreground pixels."""
    flat = labels.reshape(-1)
    idx = np.flatnonzero(flat)
    idx = idx[np.argsort(flat[idx], kind="stable")]
    bounds = np.searchsorted(flat[idx], np.arange(1, n + 2))
    w = labels.shape[1]
    for comp in range(n):
        yield np.divmod(idx[bounds[comp]:bounds[comp + 1]], w)


@dataclass(frozen=True)
class BlobParams:
    min_threshold: int = 50
    max_threshold: int = 220
    threshold_step: int = 10
    blob_color: int = 0  # 0 = dark blobs, 255 = bright blobs
    min_repeatability: int = 2
    min_dist_between_blobs: float = 10.0
    min_area: float = 25.0
    max_area: float = 5000.0
    min_circularity: float = 0.7  # traced-polygon values run lower
    min_convexity: float = 0.9   # than the continuous ideal on small blobs
    min_inertia: float = 0.1


def detect_blobs(gray: np.ndarray, params: BlobParams = BlobParams()
                 ) -> np.ndarray:
    """u8 gray (H, W) → [K, 3] float64 (cx, cy, diameter), sorted by
    raster position of the center."""
    from .ccl import connected_components, find_contours
    from .shape import contour_area, convex_hull

    g = gray.cpu().numpy() if hasattr(gray, "cpu") else np.asarray(gray)
    if g.ndim != 2:
        raise ValueError("detect_blobs expects a gray (H, W) image")
    per_level: List[List[Tuple[float, float, float]]] = []
    for t in range(params.min_threshold, params.max_threshold + 1,
                   params.threshold_step):
        mask = (g < t) if params.blob_color == 0 else (g > t)
        if not mask.any():
            per_level.append([])
            continue
        n, labels = connected_components(mask.astype(np.uint8))
        found = []
        for comp, (ys, xs) in enumerate(_component_pixels(labels, n), start=1):
            # the component alone in its bounding box and a 1-px margin:
            # the contour the whole-frame mask gives, moved by the origin
            y0, x0 = int(ys.min()) - 1, int(xs.min()) - 1
            sel = np.zeros((int(ys.max()) - y0 + 2, int(xs.max()) - x0 + 2), np.uint8)
            sel[ys - y0, xs - x0] = 1
            cont = [c + np.array([x0, y0], np.int32) for c in find_contours(sel)]
            if not cont:
                continue
            boundary = max(cont, key=len)
            # contour (shoelace) area, as OpenCV's moments-based filters
            area = contour_area(boundary)
            if not (params.min_area <= area <= params.max_area):
                continue
            cy, cx = ys.mean(), xs.mean()
            # inertia: eigen ratio of second central moments
            mu20 = ((xs - cx) ** 2).mean()
            mu02 = ((ys - cy) ** 2).mean()
            mu11 = ((xs - cx) * (ys - cy)).mean()
            tr = mu20 + mu02
            det = mu20 * mu02 - mu11 * mu11
            disc = max(tr * tr / 4 - det, 0.0)
            lmax = tr / 2 + np.sqrt(disc)
            lmin = tr / 2 - np.sqrt(disc)
            if lmax > 1e-12 and lmin / lmax < params.min_inertia:
                continue
            from .shape import arc_length

            perim = arc_length(boundary, closed=True)
            if perim <= 0:
                continue
            circ = 4.0 * np.pi * area / (perim * perim)
            if circ < params.min_circularity:
                continue
            hull = convex_hull(boundary)
            ha = contour_area(hull)
            if ha > 0 and area / ha < params.min_convexity:
                continue
            found.append((cx, cy, 2.0 * np.sqrt(area / np.pi)))
        per_level.append(found)

    # merge across levels: greedy center grouping
    groups: List[List[Tuple[float, float, float]]] = []
    for level in per_level:
        for cand in level:
            for grp in groups:
                gx, gy = np.mean([c[0] for c in grp]), np.mean([c[1] for c in grp])
                if np.hypot(cand[0] - gx, cand[1] - gy) < params.min_dist_between_blobs:
                    grp.append(cand)
                    break
            else:
                groups.append([cand])
    out = []
    for grp in groups:
        if len(grp) >= params.min_repeatability:
            out.append((np.mean([c[0] for c in grp]),
                        np.mean([c[1] for c in grp]),
                        np.mean([c[2] for c in grp])))
    out.sort(key=lambda c: (round(c[1]), round(c[0])))
    return np.asarray(out, np.float64).reshape(-1, 3)
