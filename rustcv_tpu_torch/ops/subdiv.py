"""Planar subdivision (OpenCV ``Subdiv2D`` role): incremental Delaunay
triangulation with Voronoi duals.

Frozen spec (host float64): Bowyer-Watson insertion over a super
triangle spanning the bounding rect; exact-enough in-circumcircle via
the standard 3×3 determinant (f64, points are pixel-scale); the
Delaunay triangulation of points in general position is unique, so the
triangle SET matches cv2.Subdiv2D's exactly on the test fixtures.
Voronoi facets are the convex polygons of circumcenters around each
site (ordered by angle), clipped only by construction (callers clip to
their ROI like cv2 users do).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


class Subdiv2D:
    """``Subdiv2D(rect)`` → ``insert(pt)`` / ``insert_multiple`` →
    ``get_triangle_list()`` (N, 6), ``get_voronoi_facet_list()``,
    ``find_nearest(pt)``."""

    def __init__(self, rect: Tuple[float, float, float, float]):
        x, y, w, h = (float(v) for v in rect)
        self.rect = (x, y, w, h)
        m = 10.0 * max(w, h, 1.0)
        # super-triangle far outside the rect
        self._super = [np.array([x - m, y - m]),
                       np.array([x + 2 * m + w, y - m]),
                       np.array([x + w / 2, y + 2 * m + h])]
        self.points: List[np.ndarray] = []
        # triangles as index triples into super(0..2 → -1,-2,-3)+points
        self._tris: List[Tuple[int, int, int]] = [(-1, -2, -3)]

    def _coord(self, i: int) -> np.ndarray:
        return self._super[-i - 1] if i < 0 else self.points[i]

    @staticmethod
    def _circum(a, b, c):
        d = 2.0 * (a[0] * (b[1] - c[1]) + b[0] * (c[1] - a[1])
                   + c[0] * (a[1] - b[1]))
        if abs(d) < 1e-12:
            return None, np.inf
        ux = ((a @ a) * (b[1] - c[1]) + (b @ b) * (c[1] - a[1])
              + (c @ c) * (a[1] - b[1])) / d
        uy = ((a @ a) * (c[0] - b[0]) + (b @ b) * (a[0] - c[0])
              + (c @ c) * (b[0] - a[0])) / d
        center = np.array([ux, uy])
        return center, float(((a - center) ** 2).sum())

    def insert(self, pt) -> int:
        p = np.asarray(pt, np.float64).ravel()[:2]
        x, y, w, h = self.rect
        if not (x <= p[0] <= x + w and y <= p[1] <= y + h):
            raise ValueError("point outside the subdivision rect")
        idx = len(self.points)
        self.points.append(p.copy())
        bad = []
        for t in self._tris:
            a, b, c = (self._coord(i) for i in t)
            center, r2 = self._circum(a, b, c)
            if center is not None and ((p - center) ** 2).sum() < r2 \
                    + 1e-9:
                bad.append(t)
        # boundary of the bad-triangle cavity
        edges = {}
        for t in bad:
            for e in ((t[0], t[1]), (t[1], t[2]), (t[2], t[0])):
                key = tuple(sorted(e))
                edges[key] = edges.get(key, 0) + 1
        boundary = [e for e, n in edges.items() if n == 1]
        self._tris = [t for t in self._tris if t not in bad]
        for e in boundary:
            self._tris.append((e[0], e[1], idx))
        return idx

    def insert_multiple(self, pts: Sequence) -> None:
        for p in np.asarray(pts, np.float64).reshape(-1, 2):
            self.insert(p)

    def get_triangle_list(self) -> np.ndarray:
        """(N, 6) float32 triangles (x1,y1,x2,y2,x3,y3) — only those
        whose vertices are all real sites (cv2 semantics)."""
        out = []
        for t in self._tris:
            if all(i >= 0 for i in t):
                out.append(np.concatenate([self.points[i] for i in t]))
        return (np.asarray(out, np.float32) if out
                else np.zeros((0, 6), np.float32))

    def find_nearest(self, pt) -> Tuple[int, np.ndarray]:
        p = np.asarray(pt, np.float64).ravel()[:2]
        d = [((q - p) ** 2).sum() for q in self.points]
        i = int(np.argmin(d))
        return i, self.points[i].copy()

    def get_voronoi_facet_list(self, idx: Optional[Sequence[int]] = None
                               ) -> Tuple[List[np.ndarray], np.ndarray]:
        """→ (facets: list of (K, 2) float32 polygons CCW, centers
        (N, 2)). Facets of hull sites extend toward super-triangle
        circumcenters (far away) like cv2's unbounded cells."""
        sites = range(len(self.points)) if idx is None else idx
        facets = []
        centers = []
        for s in sites:
            ccs = []
            for t in self._tris:
                if s in t:
                    a, b, c = (self._coord(i) for i in t)
                    center, _ = self._circum(a, b, c)
                    if center is not None:
                        ccs.append(center)
            if not ccs:
                facets.append(np.zeros((0, 2), np.float32))
                centers.append(self.points[s])
                continue
            ccs = np.asarray(ccs)
            ang = np.arctan2(ccs[:, 1] - self.points[s][1],
                             ccs[:, 0] - self.points[s][0])
            facets.append(ccs[np.argsort(ang)].astype(np.float32))
            centers.append(self.points[s])
        return facets, np.asarray(centers, np.float32)
