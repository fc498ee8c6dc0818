"""Octree over 3-D point clouds (OpenCV ``Octree`` role): insertion,
membership, K-nearest and radius queries, deletion.

A real octree (cubic nodes split into 8 children at ``max_points`` per
leaf), not a KD wrapper — queries prune by node-box distance. Exactness
is verified against brute force in tests.
"""

from __future__ import annotations

import heapq
from typing import List, Optional, Tuple

import numpy as np


class _Node:
    __slots__ = ("center", "half", "points", "children")

    def __init__(self, center, half):
        self.center = center
        self.half = half
        self.points: List[int] = []
        self.children: Optional[List["_Node"]] = None


class Octree:
    def __init__(self, points=None, max_points: int = 16,
                 origin=None, size: Optional[float] = None):
        pts = (np.zeros((0, 3)) if points is None
               else np.asarray(points, np.float64).reshape(-1, 3))
        if size is None:
            if len(pts):
                lo = pts.min(0) - 1e-6
                hi = pts.max(0) + 1e-6
                center = (lo + hi) / 2
                half = float((hi - lo).max() / 2 + 1e-6)
            else:
                center = np.zeros(3)
                half = 1.0
        else:
            center = (np.zeros(3) if origin is None
                      else np.asarray(origin, np.float64)) + size / 2.0
            half = size / 2.0
        self.max_points = max_points
        self.root = _Node(center, half)
        self.points: List[np.ndarray] = []
        self.alive: List[bool] = []
        for p in pts:
            self.insert_point(p)

    def is_point_in_bounds(self, p) -> bool:
        p = np.asarray(p, np.float64)
        return bool((np.abs(p - self.root.center)
                     <= self.root.half + 1e-12).all())

    def _child_index(self, node, p):
        return ((p[0] > node.center[0]) + 2 * (p[1] > node.center[1])
                + 4 * (p[2] > node.center[2]))

    def _split(self, node):
        node.children = []
        for i in range(8):
            off = np.array([(i & 1), (i >> 1) & 1, (i >> 2) & 1],
                           np.float64) * 2 - 1
            node.children.append(_Node(node.center
                                       + off * node.half / 2,
                                       node.half / 2))
        for pi in node.points:
            c = self._child_index(node, self.points[pi])
            node.children[c].points.append(pi)
        node.points = []

    def insert_point(self, p) -> int:
        p = np.asarray(p, np.float64).ravel()[:3]
        if not self.is_point_in_bounds(p):
            raise ValueError("point outside the octree bounds")
        idx = len(self.points)
        self.points.append(p.copy())
        self.alive.append(True)
        node = self.root
        while node.children is not None:
            node = node.children[self._child_index(node, p)]
        node.points.append(idx)
        if len(node.points) > self.max_points and node.half > 1e-9:
            self._split(node)
        return idx

    def delete_point(self, p, tol: float = 1e-9) -> bool:
        p = np.asarray(p, np.float64)
        for i, q in enumerate(self.points):
            if self.alive[i] and np.abs(q - p).max() <= tol:
                self.alive[i] = False
                return True
        return False

    def _box_dist2(self, node, q) -> float:
        d = np.maximum(np.abs(q - node.center) - node.half, 0.0)
        return float((d * d).sum())

    def radius_neighbours(self, q, radius: float
                          ) -> Tuple[np.ndarray, np.ndarray]:
        q = np.asarray(q, np.float64)
        r2 = radius * radius
        out = []

        def visit(node):
            if self._box_dist2(node, q) > r2:
                return
            if node.children is not None:
                for c in node.children:
                    visit(c)
                return
            for pi in node.points:
                if self.alive[pi]:
                    d2 = float(((self.points[pi] - q) ** 2).sum())
                    if d2 <= r2:
                        out.append((d2, pi))

        visit(self.root)
        out.sort()
        return (np.asarray([i for _, i in out], np.int32),
                np.asarray([d for d, _ in out]))

    def k_nearest_neighbours(self, q, k: int
                             ) -> Tuple[np.ndarray, np.ndarray]:
        q = np.asarray(q, np.float64)
        heap = []  # max-heap (-d2, idx)

        def visit(node):
            if len(heap) == k and self._box_dist2(node, q) > -heap[0][0]:
                return
            if node.children is not None:
                order = sorted(node.children,
                               key=lambda c: self._box_dist2(c, q))
                for c in order:
                    visit(c)
                return
            for pi in node.points:
                if not self.alive[pi]:
                    continue
                d2 = float(((self.points[pi] - q) ** 2).sum())
                if len(heap) < k:
                    heapq.heappush(heap, (-d2, pi))
                elif d2 < -heap[0][0]:
                    heapq.heapreplace(heap, (-d2, pi))

        visit(self.root)
        out = sorted((-d, i) for d, i in heap)
        return (np.asarray([i for _, i in out], np.int32),
                np.asarray([d for d, _ in out]))
