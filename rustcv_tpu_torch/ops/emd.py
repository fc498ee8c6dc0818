"""Earth mover's distance between weighted signatures (OpenCV ``EMD``
role).

The reference has no histogram comparison beyond norms; OpenCV-parity
addition. Signatures are tiny (tens to hundreds of rows) — host float64
exact min-cost flow, far below device break-even (the calib/epipolar
split).

Frozen spec: the transportation problem is solved EXACTLY by successive
shortest augmenting paths with Dijkstra + Johnson potentials on the
bipartite flow network source → suppliers → consumers → sink (float
capacities; each augmentation saturates at least one arc, so the loop
terminates in ≤ n₁+n₂ rounds of the support). EMD = total cost / total
flow with total flow = min(Σw₁, Σw₂) (OpenCV's unbalanced convention).
Ground distances: "l1", "l2", "l2sq", or a user (n₁, n₂) cost matrix.
"""

from __future__ import annotations

import heapq
from typing import Optional, Tuple

import numpy as np


def _ground_cost(a: np.ndarray, b: np.ndarray, dist: str) -> np.ndarray:
    d = a[:, None, :] - b[None, :, :]
    if dist == "l1":
        return np.abs(d).sum(-1)
    if dist == "l2":
        return np.sqrt((d * d).sum(-1))
    if dist == "l2sq":
        return (d * d).sum(-1)
    raise ValueError(f"unknown distance {dist!r}")


def emd(signature1, signature2, dist: str = "l2",
        cost: Optional[np.ndarray] = None,
        return_flow: bool = False):
    """EMD between signatures ``[w, x₀, x₁, …]`` per row (OpenCV ``EMD``
    role) → float, or (float, flow (n₁, n₂)) with ``return_flow``.
    Zero-weight rows are allowed; weights must be non-negative with a
    positive total on both sides."""
    s1 = np.asarray(signature1, np.float64).reshape(len(signature1), -1)
    s2 = np.asarray(signature2, np.float64).reshape(len(signature2), -1)
    w1, w2 = s1[:, 0], s2[:, 0]
    if (w1 < 0).any() or (w2 < 0).any():
        raise ValueError("signature weights must be non-negative")
    tot1, tot2 = w1.sum(), w2.sum()
    if tot1 <= 0 or tot2 <= 0:
        raise ValueError("signature weights must have positive totals")
    if cost is not None:
        c = np.asarray(cost, np.float64)
        if c.shape != (len(s1), len(s2)):
            raise ValueError(f"cost must be {(len(s1), len(s2))}")
        if (c < 0).any():
            raise ValueError("cost matrix must be non-negative")
    else:
        if s1.shape[1] < 2 or s1.shape[1] != s2.shape[1]:
            raise ValueError("signatures need matching coordinate dims")
        c = _ground_cost(s1[:, 1:], s2[:, 1:], dist)

    n1, n2 = len(s1), len(s2)
    # nodes: 0 = source, 1..n1 suppliers, n1+1..n1+n2 consumers, last = sink
    n = n1 + n2 + 2
    src, snk = 0, n - 1
    # adjacency as arrays: to, cap, cost, flow; arc i has twin i^1
    to, cap, cst = [], [], []

    def arc(u, v, capacity, c_uv, graph):
        graph[u].append(len(to))
        to.append(v)
        cap.append(capacity)
        cst.append(c_uv)
        graph[v].append(len(to))
        to.append(u)
        cap.append(0.0)
        cst.append(-c_uv)

    graph = [[] for _ in range(n)]
    for i in range(n1):
        if w1[i] > 0:
            arc(src, 1 + i, w1[i], 0.0, graph)
    for j in range(n2):
        if w2[j] > 0:
            arc(1 + n1 + j, snk, w2[j], 0.0, graph)
    for i in range(n1):
        if w1[i] <= 0:
            continue
        for j in range(n2):
            if w2[j] > 0:
                arc(1 + i, 1 + n1 + j, np.inf, float(c[i, j]), graph)

    need = min(tot1, tot2)
    flow_left = need
    total_cost = 0.0
    pot = np.zeros(n)
    flow_ij = np.zeros((n1, n2)) if return_flow else None
    eps = 1e-12 * max(1.0, need)
    while flow_left > eps:
        # Dijkstra with potentials
        dist_v = np.full(n, np.inf)
        dist_v[src] = 0.0
        prev_arc = np.full(n, -1, np.int64)
        settled = np.zeros(n, bool)
        pq = [(0.0, src)]
        while pq:
            d, u = heapq.heappop(pq)
            # Each node settles once, and a label moves only by more than
            # a relative slack: two nodes whose distances differ in the
            # last bits cannot keep relaxing each other's arcs, so
            # prev_arc stays a tree rooted at the source.
            if settled[u] or d > dist_v[u] + 1e-12 * max(1.0, abs(d)):
                continue
            settled[u] = True
            for a in graph[u]:
                if cap[a] <= eps:
                    continue
                v = to[a]
                if settled[v]:
                    continue
                nd = d + cst[a] + pot[u] - pot[v]
                if nd < dist_v[v] - 1e-12 * max(1.0, abs(nd)):
                    dist_v[v] = nd
                    prev_arc[v] = a
                    heapq.heappush(pq, (nd, v))
        if not np.isfinite(dist_v[snk]):
            break  # no augmenting path (shouldn't happen with inf arcs)
        pot = np.where(np.isfinite(dist_v), pot + dist_v, pot)
        # bottleneck along the path
        push = flow_left
        v = snk
        steps = 0
        while v != src:
            steps += 1
            if steps > n:
                raise RuntimeError("emd: the augmenting path does not reach the source")
            a = int(prev_arc[v])
            push = min(push, cap[a])
            v = to[a ^ 1]
        v = snk
        while v != src:
            a = int(prev_arc[v])
            cap[a] -= push
            cap[a ^ 1] += push
            total_cost += push * cst[a]
            if flow_ij is not None:
                u = to[a ^ 1]
                if 1 <= u <= n1 and n1 < v < snk:
                    flow_ij[u - 1, v - 1 - n1] += push
                elif 1 <= v <= n1 and n1 < u < snk:
                    flow_ij[v - 1, u - 1 - n1] -= push
            v = to[a ^ 1]
        flow_left -= push
    result = total_cost / need
    if return_flow:
        return result, flow_ij
    return result
