"""Copy of ``rustcv_tpu.ops.lsd`` (the port's ``shape`` and ``golden``). Line segment detection (OpenCV ximgproc ``FastLineDetector`` role;
``createLineSegmentDetector`` niche).

The reference has no feature detectors; OpenCV-parity addition. The TPU
split follows FLD's own structure: the edge map comes from the device
Canny (ops/filters.canny_u8, bit-exact vs golden.canny), and the
chain-tracing + splitting — sequential pointer chasing — is the host
escape (the findContours precedent, O(edge pixels)).

Frozen spec (deterministic):
1. Edge map: the package's frozen Canny (low/high thresholds).
2. Chains: scanning raster order, each unvisited edge pixel seeds a
   chain extended greedily in both directions; at each step the FIRST
   unvisited edge neighbor in the fixed order (E, SE, S, SW, W, NW, N,
   NE), preferring the direction of travel when extending (the
   neighbor closest in angle to the previous step wins; ties by the
   fixed order). Visited pixels belong to exactly one chain.
3. Splitting: Douglas-Peucker (ops/shape.approx_poly_dp, open
   polyline) at ``distance_threshold``; consecutive vertex pairs are
   candidate segments.
4. Filtering: segments shorter than ``length_threshold`` are dropped.
   Endpoints are pixel coordinates (x, y) of the traced chain.
5. Optional merge: co-linear segment pairs (angle difference below
   ``merge_angle`` rad, endpoint gap below ``merge_gap`` px, lateral
   offset below ``distance_threshold``) merge into their extreme-point
   span, repeated to fixpoint in segment order.
"""

from __future__ import annotations

from typing import List

import numpy as np

from .shape import approx_poly_dp

# neighbor preference ring: E, SE, S, SW, W, NW, N, NE
_NBRS = ((0, 1), (1, 1), (1, 0), (1, -1), (0, -1), (-1, -1), (-1, 0),
         (-1, 1))


def _trace_chains(edges: np.ndarray) -> List[np.ndarray]:
    h, w = edges.shape
    on = edges != 0
    visited = np.zeros_like(on)
    chains = []
    ys, xs = np.nonzero(on)
    for sy, sx in zip(ys, xs):
        if visited[sy, sx]:
            continue
        visited[sy, sx] = True

        def walk(y, x, py, px):
            """Greedy walk preferring the previous direction."""
            path = []
            while True:
                best = None
                best_key = None
                for k, (dy, dx) in enumerate(_NBRS):
                    ny, nx = y + dy, x + dx
                    if not (0 <= ny < h and 0 <= nx < w):
                        continue
                    if not on[ny, nx] or visited[ny, nx]:
                        continue
                    if py is None:
                        key = (0.0, k)
                    else:
                        vy, vx = y - py, x - px
                        dot = (dy * vy + dx * vx) / np.hypot(
                            dy, dx) / max(np.hypot(vy, vx), 1e-12)
                        key = (-dot, k)  # closest in angle first
                    if best_key is None or key < best_key:
                        best_key = key
                        best = (ny, nx)
                if best is None:
                    return path
                py, px = y, x
                y, x = best
                visited[y, x] = True
                path.append((y, x))

        fwd = walk(sy, sx, None, None)
        prev = fwd[0] if fwd else None
        bwd = walk(sy, sx, prev[0] if prev else None,
                   prev[1] if prev else None)
        chain = [(y, x) for (y, x) in reversed(bwd)] + [(sy, sx)] + fwd
        chains.append(np.asarray(chain, np.int64))
    return chains


def _merge_segments(segs: np.ndarray, merge_angle: float, merge_gap: float,
                    lateral: float) -> np.ndarray:
    segs = [s.copy() for s in segs]
    changed = True
    while changed:
        changed = False
        i = 0
        while i < len(segs):
            j = i + 1
            while j < len(segs):
                a, b = segs[i], segs[j]
                va = a[2:] - a[:2]
                vb = b[2:] - b[:2]
                la, lb = np.hypot(*va), np.hypot(*vb)
                if la < 1e-9 or lb < 1e-9:
                    j += 1
                    continue
                cosang = abs(float(va @ vb) / (la * lb))
                if cosang < np.cos(merge_angle):
                    j += 1
                    continue
                # endpoint gap: closest pair of endpoints
                ends_a = (a[:2], a[2:])
                ends_b = (b[:2], b[2:])
                gap = min(np.hypot(*(pa - pb))
                          for pa in ends_a for pb in ends_b)
                if gap > merge_gap:
                    j += 1
                    continue
                # lateral offset of b's endpoints from a's line
                n = np.array([-va[1], va[0]]) / la
                off = max(abs(float((pb - a[:2]) @ n)) for pb in ends_b)
                if off > lateral:
                    j += 1
                    continue
                # merge: extreme projections onto a's direction
                d = va / la
                pts = np.stack([a[:2], a[2:], b[:2], b[2:]])
                t = (pts - a[:2]) @ d
                p0 = pts[np.argmin(t)]
                p1 = pts[np.argmax(t)]
                segs[i] = np.concatenate([p0, p1])
                del segs[j]
                changed = True
            i += 1
    return np.asarray(segs, np.float64).reshape(-1, 4)


def detect_line_segments(
    gray,
    length_threshold: float = 10.0,
    distance_threshold: float = 1.41421356,
    canny_low: int = 40,
    canny_high: int = 90,
    do_merge: bool = False,
    merge_angle: float = 0.05,
    merge_gap: float = 5.0,
    edges=None,
) -> np.ndarray:
    """Detect line segments (OpenCV ``FastLineDetector.detect`` role) →
    float64 (N, 4) rows (x1, y1, x2, y2) in detection order. ``edges``
    short-circuits the Canny stage with a precomputed edge mask (the
    device hot path: run ops/filters.canny_u8 on-chip, trace here)."""
    if edges is None:
        from . import golden

        g = np.asarray(gray, np.uint8)
        if g.ndim != 2:
            raise ValueError("detect_line_segments expects a gray image")
        edges = golden.canny(g, low=canny_low, high=canny_high)
    edges = np.asarray(edges)
    segs = []
    for chain in _trace_chains(edges):
        if len(chain) < 2:
            continue
        pts = chain[:, ::-1].astype(np.float64)  # (y, x) → (x, y)
        poly = approx_poly_dp(pts, distance_threshold, closed=False)
        for k in range(len(poly) - 1):
            p, q = poly[k], poly[k + 1]
            if np.hypot(*(q - p)) >= length_threshold:
                segs.append(np.concatenate([p, q]))
    out = np.asarray(segs, np.float64).reshape(-1, 4)
    if do_merge and len(out) > 1:
        out = _merge_segments(out, merge_angle, merge_gap,
                              distance_threshold)
        out = out[np.hypot(out[:, 2] - out[:, 0],
                           out[:, 3] - out[:, 1]) >= length_threshold]
    return out
