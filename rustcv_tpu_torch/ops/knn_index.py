"""KNN index (OpenCV ``flann::Index`` role): a k-d tree over float
descriptors with exact backtracking search, plus the brute-force
Hamming path for binary descriptors.

Unlike FLANN's approximate randomized trees, this index is EXACT
(verified against brute force in tests) — for the dataset sizes the
matcher paths produce (10²–10⁵ descriptors) the exact tree is already
fast, and determinism fits the repo's fidelity contract. The
``checks`` knob of FLANN (quality/speed trade) is therefore accepted
and ignored.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


class KnnIndex:
    """``KnnIndex(data).knn_search(queries, k)`` →
    (indices (Q, k) int32, dists (Q, k) float32 — squared L2, FLANN's
    convention)."""

    def __init__(self, data: np.ndarray, leaf_size: int = 16):
        self.data = np.asarray(data, np.float64)
        if self.data.ndim != 2:
            raise ValueError("data must be (N, D)")
        n = len(self.data)
        self.leaf_size = max(1, int(leaf_size))
        # nodes as flat arrays: split dim/value, children, point ranges
        self.idx = np.arange(n)
        self.nodes = []
        self._build(0, n)

    def _build(self, lo: int, hi: int) -> int:
        node_id = len(self.nodes)
        self.nodes.append(None)
        if hi - lo <= self.leaf_size:
            self.nodes[node_id] = ("leaf", lo, hi)
            return node_id
        pts = self.data[self.idx[lo:hi]]
        dim = int(np.argmax(pts.max(axis=0) - pts.min(axis=0)))
        order = np.argsort(pts[:, dim], kind="stable")
        self.idx[lo:hi] = self.idx[lo:hi][order]
        mid = (lo + hi) // 2
        split_val = float(self.data[self.idx[mid], dim])
        left = self._build(lo, mid)
        right = self._build(mid, hi)
        self.nodes[node_id] = ("split", dim, split_val, left, right)
        return node_id

    def _search_one(self, q: np.ndarray, k: int):
        import heapq

        heap = []  # max-heap of (-dist2, index)

        def visit(node_id):
            node = self.nodes[node_id]
            if node[0] == "leaf":
                _, lo, hi = node
                ids = self.idx[lo:hi]
                d2 = ((self.data[ids] - q) ** 2).sum(axis=1)
                for dist, i in zip(d2, ids):
                    if len(heap) < k:
                        heapq.heappush(heap, (-dist, int(i)))
                    elif dist < -heap[0][0]:
                        heapq.heapreplace(heap, (-dist, int(i)))
                return
            _, dim, val, left, right = node
            near, far = (left, right) if q[dim] <= val else (right, left)
            visit(near)
            gap = q[dim] - val
            if len(heap) < k or gap * gap < -heap[0][0]:
                visit(far)

        visit(0)
        out = sorted(((-d, i) for d, i in heap))
        return out

    def knn_search(self, queries: np.ndarray, k: int = 1,
                   checks: Optional[int] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
        q = np.asarray(queries, np.float64)
        if q.ndim == 1:
            q = q[None]
        k = min(k, len(self.data))
        idx = np.zeros((len(q), k), np.int32)
        dist = np.zeros((len(q), k), np.float32)
        for row, query in enumerate(q):
            for col, (d2, i) in enumerate(self._search_one(query, k)):
                idx[row, col] = i
                dist[row, col] = d2
        return idx, dist


def radius_search(index: KnnIndex, query: np.ndarray, radius: float,
                  max_results: int = 32
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """FLANN ``radiusSearch`` role: all points with squared L2 within
    ``radius`` (FLANN uses squared distances), nearest first."""
    ids, d2 = index.knn_search(query, k=min(max_results,
                                            len(index.data)))
    keep = d2[0] <= radius
    return ids[0][keep], d2[0][keep]
