"""Copy of ``rustcv_tpu.ops.chessboard`` (the port's ``ccl`` and
``shape``; the refinement is the port's ``features.corner_sub_pix`` on a
tensor). Chessboard corner detection (OpenCV ``findChessboardCorners`` /
``drawChessboardCorners`` roles) — the missing front end of the
calibration pipeline (ops/calib.py has ``calibrate_camera`` /
``stereo_calibrate``; this supplies their image points).

The reference has no calibration at all; OpenCV-parity addition. Host
deterministic pipeline composed from this package's own primitives (the
ArUco precedent, ops/aruco.py): binarize → erode to split the black
squares → contour quads → corner clustering → lattice BFS → canonical
row-major grid → device sub-pixel refinement.

Frozen spec (deterministic; divergences from OpenCV documented inline):
1. Binarization attempts, in order, first grid win: mean adaptive
   threshold (block ∈ {min_dim//4, min_dim//8, 21} rounded up to odd,
   C = 10), then the global mean. Black mask = pixels BELOW threshold.
2. The mask is eroded (3×3 rect, 1 then 2 iterations per attempt) so
   diagonally-touching black squares separate into one quad each.
3. 4-connected components → Moore contours → Douglas-Peucker at
   ε ∈ {2%, 4%, 6%, 8%} of the perimeter until a convex quad results;
   quads smaller than 10 px² or thinner than 4:1 side ratio are dropped.
4. Quad corners cluster greedily (union-find over pairs closer than
   0.45 × median quad side); clusters touching ≥ 2 distinct quads are
   inner-corner candidates at the member mean.
5. Quad sides whose both endpoints are candidates become lattice edges;
   BFS from a degree-2 corner assigns integer (u, v) coordinates by
   matching each edge direction to the start corner's two axes (dot
   > 0.6 after normalization — mild perspective tolerated by spec).
6. The filled u×v grid must be exactly pattern_size (either
   orientation). Canonical order (documented convention, matches how
   ``calibrate_camera`` object points are generated): transpose so the
   FIRST axis is rows; flip so corner (0,0) is the min-(x+y) corner and
   row 0 runs left→right (increasing x).
7. ``refine=True`` snaps the grid to saddle points with
   features.corner_sub_pix (win 11) on the original gray image.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from .ccl import find_contours
from .shape import approx_poly_dp, arc_length, contour_area, is_contour_convex


def _binarize_attempts(gray: np.ndarray):
    """Yield black-square masks per the frozen attempt order."""
    h, w = gray.shape
    md = min(h, w)
    img = gray.astype(np.float64)
    for block in (md // 4, md // 8, 21):
        block = max(3, block) | 1
        # mean adaptive threshold, C = 10 (box mean via cumsum padding)
        pad = block // 2
        padded = np.pad(img, pad, mode="edge")
        c = np.cumsum(np.cumsum(padded, axis=0), axis=1)
        c = np.pad(c, ((1, 0), (1, 0)))
        s = (c[block:, block:] - c[:-block, block:]
             - c[block:, :-block] + c[:-block, :-block])
        mean = s / (block * block)
        for iters in (1, 2):
            yield (img < mean - 10.0), iters
    glob = img.mean()
    for iters in (1, 2):
        yield (img < glob), iters


def _erode(mask: np.ndarray, iters: int) -> np.ndarray:
    m = mask
    for _ in range(iters):
        p = np.pad(m, 1, constant_values=False)
        m = (p[1:-1, 1:-1] & p[:-2, 1:-1] & p[2:, 1:-1]
             & p[1:-1, :-2] & p[1:-1, 2:]
             & p[:-2, :-2] & p[:-2, 2:] & p[2:, :-2] & p[2:, 2:])
    return m


def _quads(mask: np.ndarray) -> List[np.ndarray]:
    """Convex quads from the mask's external contours."""
    out = []
    for contour in find_contours(mask):
        if len(contour) < 4:
            continue
        per = arc_length(contour, closed=True)
        area = contour_area(contour)
        if area < 10.0:
            continue
        for frac in (0.02, 0.04, 0.06, 0.08):
            poly = approx_poly_dp(contour, frac * per, closed=True)
            if len(poly) == 4 and is_contour_convex(poly):
                sides = np.linalg.norm(np.roll(poly, -1, 0) - poly, axis=1)
                if sides.min() > 1e-9 and sides.max() / sides.min() < 4.0:
                    out.append(np.asarray(poly, np.float64))
                break
    return out


def _cluster_corners(quads: List[np.ndarray]):
    """Greedy union-find clustering of all quad corners → candidate
    inner corners (clusters spanning ≥ 2 quads)."""
    pts = np.concatenate(quads, axis=0)          # (4Q, 2)
    owner = np.repeat(np.arange(len(quads)), 4)
    sides = np.concatenate([
        np.linalg.norm(np.roll(q, -1, 0) - q, axis=1) for q in quads])
    thresh = 0.45 * float(np.median(sides))
    n = len(pts)
    parent = np.arange(n)

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    # pairwise within-threshold union (Q is tens to low hundreds)
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    t2 = thresh * thresh
    for i in range(n):
        for j in np.nonzero(d2[i, i + 1:] < t2)[0]:
            a, b = find(i), find(int(i + 1 + j))
            if a != b:
                parent[max(a, b)] = min(a, b)
    roots = np.array([find(i) for i in range(n)])
    clusters = {}
    for i, r in enumerate(roots):
        clusters.setdefault(int(r), []).append(i)
    cand_pos, cand_of = [], {}
    for r, members in sorted(clusters.items()):
        if len({int(owner[m]) for m in members}) >= 2:
            cand_of[r] = len(cand_pos)
            cand_pos.append(pts[members].mean(axis=0))
    corner_id = np.full(n, -1)
    for i, r in enumerate(roots):
        if int(r) in cand_of:
            corner_id[i] = cand_of[int(r)]
    return np.asarray(cand_pos, np.float64), corner_id


def _lattice(cand_pos: np.ndarray, corner_id: np.ndarray,
             n_quads: int) -> Optional[np.ndarray]:
    """Integer lattice coordinates per candidate via edge-direction BFS
    → (K, 2) int array or None."""
    k = len(cand_pos)
    adj = [set() for _ in range(k)]
    for q in range(n_quads):
        ids = corner_id[4 * q: 4 * q + 4]
        for s in range(4):
            a, b = int(ids[s]), int(ids[(s + 1) % 4])
            if a >= 0 and b >= 0 and a != b:
                adj[a].add(b)
                adj[b].add(a)
    deg = np.array([len(a) for a in adj])
    if k == 0 or deg.max() == 0:
        return None
    # start at a degree-2 node (a lattice corner); lowest index for
    # determinism
    starts = np.nonzero(deg == 2)[0]
    if len(starts) == 0:
        return None
    s0 = int(starts[0])
    nbrs = sorted(adj[s0])
    e1 = cand_pos[nbrs[0]] - cand_pos[s0]
    e2 = cand_pos[nbrs[1]] - cand_pos[s0]
    e1 = e1 / max(np.linalg.norm(e1), 1e-12)
    e2 = e2 / max(np.linalg.norm(e2), 1e-12)
    coords = {s0: (0, 0)}
    queue = [s0]
    while queue:
        u = queue.pop(0)
        cu = coords[u]
        for v in sorted(adj[u]):
            d = cand_pos[v] - cand_pos[u]
            d = d / max(np.linalg.norm(d), 1e-12)
            dots = (float(d @ e1), float(-(d @ e1)),
                    float(d @ e2), float(-(d @ e2)))
            best = int(np.argmax(dots))
            if dots[best] < 0.6:
                return None                       # shear too strong
            step = ((1, 0), (-1, 0), (0, 1), (0, -1))[best]
            cv = (cu[0] + step[0], cu[1] + step[1])
            if v in coords:
                if coords[v] != cv:
                    return None                   # inconsistent lattice
            else:
                coords[v] = cv
                queue.append(v)
    if len(coords) != k:
        return None                               # disconnected corners
    out = np.zeros((k, 2), np.int64)
    for i, c in coords.items():
        out[i] = c
    out -= out.min(axis=0)
    return out


def _order_grid(cand_pos: np.ndarray, uv: np.ndarray,
                pattern_size: Tuple[int, int]) -> Optional[np.ndarray]:
    """Canonical row-major (rows, cols, 2) grid or None."""
    cols, rows = pattern_size
    span = uv.max(axis=0) + 1
    if sorted(span) != sorted((cols, rows)) or len(cand_pos) != cols * rows:
        return None
    grid = np.full((span[0], span[1], 2), np.nan)
    for p, (u, v) in zip(cand_pos, uv):
        if not np.isnan(grid[u, v, 0]):
            return None
        grid[u, v] = p
    if np.isnan(grid).any():
        return None
    # first axis = rows
    if grid.shape[0] != rows:
        grid = grid.transpose(1, 0, 2)
        if grid.shape[0] != rows or grid.shape[1] != cols:
            return None
    # corner (0,0) = min-(x+y) of the four grid corners
    if (grid[0, 0].sum() > grid[-1, -1].sum()):
        grid = grid[::-1, ::-1]
    if (grid[0, 0].sum() > grid[-1, 0].sum()
            or grid[0, 0].sum() > grid[0, -1].sum()):
        # start corner must be the global min corner; flip the one axis
        if grid[-1, 0].sum() < grid[0, 0].sum():
            grid = grid[::-1, :]
        else:
            grid = grid[:, ::-1]
    # row 0 runs left→right
    if grid[0, 0, 0] > grid[0, -1, 0]:
        grid = grid[:, ::-1]
    return grid


def find_chessboard_corners(
    gray,
    pattern_size: Tuple[int, int],
    refine: bool = True,
) -> Tuple[bool, np.ndarray]:
    """Find the inner corners of a chessboard (OpenCV
    ``findChessboardCorners`` role). ``gray``: (H, W) u8 (callers convert
    color), a tensor or a numpy array; ``pattern_size`` = (cols, rows) of
    INNER corners. The refinement runs on the tensor's device, or on the
    card for a numpy array. Returns
    (found, corners float64 (rows·cols, 2) row-major, row 0 at the
    min-(x+y) board corner running left→right) — the same traversal as
    the standard ``calibrate_camera`` object-point grids."""
    device = None
    if isinstance(gray, torch.Tensor):
        device, gray = gray.device, gray.cpu().numpy()
    gray = np.asarray(gray)
    if gray.ndim == 3:
        raise ValueError("find_chessboard_corners expects a gray image")
    cols, rows = pattern_size
    if cols < 2 or rows < 2:
        raise ValueError("pattern_size must be >= 2x2 inner corners")
    for mask, iters in _binarize_attempts(gray):
        m = _erode(mask, iters)
        if not m.any():
            continue
        quads = _quads(m)
        if len(quads) < (cols * rows) // 2:
            continue
        cand_pos, corner_id = _cluster_corners(quads)
        if len(cand_pos) != cols * rows:
            continue
        uv = _lattice(cand_pos, corner_id, len(quads))
        if uv is None:
            continue
        grid = _order_grid(cand_pos, uv, pattern_size)
        if grid is None:
            continue
        corners = grid.reshape(-1, 2)
        if refine:
            from .features import corner_sub_pix
            from .tensors import as_tensor

            refined = corner_sub_pix(as_tensor(gray.astype(np.uint8), device),
                                     corners.astype(np.float32), win=11)
            corners = refined.cpu().numpy().astype(np.float64)
        return True, corners
    return False, np.zeros((0, 2), np.float64)




def estimate_chessboard_sharpness(gray: np.ndarray, pattern_size,
                                  corners: np.ndarray,
                                  rise_distance: float = 0.8
                                  ) -> Tuple[float, float, float]:
    """OpenCV ``estimateChessboardSharpness`` role: average 10→90%
    rise width of the black/white edge profiles between neighboring
    inner corners → (sharpness_px, avg_min, avg_max). Lower = sharper;
    grows with defocus/motion blur (tests pin the monotonicity and a
    ≤2× envelope vs cv2)."""
    g = np.asarray(gray, np.float64)
    if g.ndim == 3:
        g = g[..., 0]
    h, w = g.shape
    cols, rows = pattern_size
    grid = np.asarray(corners, np.float64).reshape(rows, cols, 2)

    def sample(p):
        x = np.clip(p[..., 0], 0, w - 1.001)
        y = np.clip(p[..., 1], 0, h - 1.001)
        x0 = np.floor(x).astype(np.int64)
        y0 = np.floor(y).astype(np.int64)
        fx = x - x0
        fy = y - y0
        return (g[y0, x0] * (1 - fx) * (1 - fy)
                + g[y0, x0 + 1] * fx * (1 - fy)
                + g[y0 + 1, x0] * (1 - fx) * fy
                + g[y0 + 1, x0 + 1] * fx * fy)

    widths, mins, maxs = [], [], []
    ts = np.linspace(-3.0, 3.0, 25)
    pairs = []
    for r in range(rows):
        for c in range(cols - 1):
            pairs.append((grid[r, c], grid[r, c + 1]))
    for c in range(cols):
        for r in range(rows - 1):
            pairs.append((grid[r, c], grid[r + 1, c]))
    for a, b in pairs:
        mid = (a + b) / 2.0
        d = b - a
        nrm = np.hypot(d[0], d[1])
        if nrm < 1e-9:
            continue
        # the grid edge runs ALONG the corner pair; the black→white
        # transition is crossed PERPENDICULAR to it at the midpoint
        u = np.array([-d[1], d[0]]) / nrm
        pts = mid[None, :] + ts[:, None] * u[None, :]
        if (pts[:, 0].min() < 1 or pts[:, 0].max() > w - 2
                or pts[:, 1].min() < 1 or pts[:, 1].max() > h - 2):
            continue
        prof = sample(pts)
        lo, hi = prof.min(), prof.max()
        if hi - lo < 16:
            continue
        t10 = lo + 0.1 * (hi - lo)
        t90 = lo + 0.9 * (hi - lo)
        inside = (prof > t10) & (prof < t90)
        # rise width = span of samples inside the transition band
        idx = np.nonzero(inside)[0]
        if len(idx) == 0:
            width = 0.0
        else:
            width = (ts[idx[-1]] - ts[idx[0]]) + (ts[1] - ts[0])
        widths.append(width)
        mins.append(lo)
        maxs.append(hi)
    if not widths:
        return 0.0, 0.0, 0.0
    return (float(np.mean(widths)), float(np.mean(mins)),
            float(np.mean(maxs)))
