"""Copy of ``rustcv_tpu.ops.scissors`` (the port's ``golden``). Intelligent Scissors / live-wire segmentation (OpenCV
``segmentation::IntelligentScissorsMB`` role, Mortensen-Barrett 1995):
interactive minimum-cost edge-following paths.

Frozen spec (host — Dijkstra is pointer-chasing, the GrabCut escape):
- local cost of stepping onto pixel q from p:
  ``c = w_edge·f_edge(q) + w_dir·f_dir(p, q) + w_mag·f_mag(q)`` with
  the Mortensen-Barrett defaults (0.43, 0.43, 0.14);
  f_edge = 0 on Canny edges else 1 (our frozen Canny spec);
  f_mag = 1 − |∇| / max|∇| (clamped at ``gradient_magnitude_max``);
  f_dir = the gradient-direction smoothness term
  (2/3π)·(acos d(p,q) + acos d(q,p)) with the unit link vector and
  the gradient normals, exactly the paper's form;
- diagonal steps scale the cost by √2 (path-length fairness);
- ``build_map`` = one Dijkstra from the seed over the 8-neighborhood;
  ``get_contour`` backtracks → (N, 2) int32 (x, y), seed → target.

Tested against cv2's IntelligentScissorsMB on ridge-following scenes
(mean path deviation ≤ 2 px) in tests/test_scissors.py.
"""

from __future__ import annotations

import heapq
from typing import Optional, Tuple

import numpy as np

from .golden import canny, sobel3_gray

W_EDGE = 0.43
W_DIR = 0.43
W_MAG = 0.14

_STEPS = [(-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1),
          (1, 0), (1, 1)]


class IntelligentScissors:
    """OpenCV ``IntelligentScissorsMB`` API shape: ``apply_image`` →
    ``build_map(seed_xy)`` → ``get_contour(target_xy)``."""

    def __init__(self, canny_low: int = 30, canny_high: int = 90,
                 gradient_magnitude_max: float = 0.0):
        self.canny_low = canny_low
        self.canny_high = canny_high
        self.mag_max = gradient_magnitude_max

    def apply_image(self, gray: np.ndarray) -> "IntelligentScissors":
        g = np.asarray(gray)
        if g.ndim == 3:
            g = g[..., 0]
        self.shape = g.shape
        edges = canny(g, self.canny_low, self.canny_high) > 0
        gx, gy = sobel3_gray(g)
        gx = gx.astype(np.float64)
        gy = gy.astype(np.float64)
        mag = np.hypot(gx, gy)
        top = self.mag_max if self.mag_max > 0 else max(mag.max(), 1e-9)
        self.f_mag = 1.0 - np.minimum(mag, top) / top
        self.f_edge = np.where(edges, 0.0, 1.0)
        n = np.maximum(mag, 1e-9)
        # gradient normal D'(p) = (gy, -gx)/|∇|
        self.dx = gy / n
        self.dy = -gx / n
        return self

    def _link_cost(self, py, px, qy, qx) -> float:
        sy, sx = qy - py, qx - px
        ln = np.hypot(sy, sx)
        ly, lx = sy / ln, sx / ln
        # orient the link with the normal at p
        dpl = self.dx[py, px] * lx + self.dy[py, px] * ly
        if dpl < 0:
            lx, ly, dpl = -lx, -ly, -dpl
        dql = self.dx[qy, qx] * lx + self.dy[qy, qx] * ly
        f_dir = (2.0 / (3.0 * np.pi)) * (
            np.arccos(np.clip(dpl, -1, 1))
            + np.arccos(np.clip(dql, -1, 1)))
        c = (W_EDGE * self.f_edge[qy, qx] + W_DIR * f_dir
             + W_MAG * self.f_mag[qy, qx])
        return c * ln

    def build_map(self, seed_xy: Tuple[int, int]) -> None:
        h, w = self.shape
        sx, sy = int(seed_xy[0]), int(seed_xy[1])
        if not (0 <= sx < w and 0 <= sy < h):
            raise ValueError("seed outside the image")
        dist = np.full((h, w), np.inf)
        self.prev = np.full((h, w, 2), -1, np.int32)
        dist[sy, sx] = 0.0
        heap = [(0.0, sy, sx)]
        while heap:
            d, y, x = heapq.heappop(heap)
            if d > dist[y, x]:
                continue
            for dy, dx in _STEPS:
                qy, qx = y + dy, x + dx
                if not (0 <= qy < h and 0 <= qx < w):
                    continue
                nd = d + self._link_cost(y, x, qy, qx)
                if nd < dist[qy, qx]:
                    dist[qy, qx] = nd
                    self.prev[qy, qx] = (y, x)
                    heapq.heappush(heap, (nd, qy, qx))
        self.dist = dist
        self.seed = (sy, sx)

    def get_contour(self, target_xy: Tuple[int, int]) -> np.ndarray:
        """→ (N, 2) int32 (x, y), seed first (cv2's order)."""
        tx, ty = int(target_xy[0]), int(target_xy[1])
        h, w = self.shape
        if not (0 <= tx < w and 0 <= ty < h):
            raise ValueError("target outside the image")
        path = []
        y, x = ty, tx
        while (y, x) != self.seed:
            path.append((x, y))
            py, px = self.prev[y, x]
            if py < 0:
                raise ValueError("target unreachable (call build_map)")
            y, x = int(py), int(px)
        path.append((self.seed[1], self.seed[0]))
        return np.asarray(path[::-1], np.int32)
