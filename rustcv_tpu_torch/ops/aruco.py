"""Copy of ``rustcv_tpu.ops.aruco`` (the port's ``ccl``, ``shape``, ``warp``,
``calib`` and ``geometry``; the ChArUco refinement is the port's
``features.corner_sub_pix`` on a tensor).

ArUco-style fiducial marker generation, detection, and pose (OpenCV
``cv::aruco`` role: Dictionary / drawMarker / detectMarkers /
estimatePoseSingleMarkers).

OpenCV's predefined dictionaries (DICT_4X4_50 …) are data tables; this
module generates its own dictionaries deterministically (the
``custom_dictionary`` role — seeded greedy codes with a minimum
rotation-aware Hamming distance), plus the drawer, so generation and
detection are self-consistent end-to-end without copying any OpenCV
data.

Detection composes this framework's own primitives:
    threshold → connected components + Moore contours (ops/ccl.py) →
    approxPolyDP quads (ops/shape.py) → perspective rectification
    (ops/warp.get_perspective_transform) → grid bit sampling →
    rotation-aware dictionary match.
Pose comes from the planar homography decomposition
(``K⁻¹H → [r1 r2 t]``, the standard planar PnP), refined by
:func:`rustcv_tpu_torch.ops.calib.solve_pnp`-style projection checks.

Frozen spec:
- marker: ``bits × bits`` payload inside a 1-cell black border; drawn
  white-on-black cells of ``cell_px`` pixels each;
- dictionary: seeded ``default_rng``; candidate codes accepted when the
  minimum Hamming distance to every accepted code over ALL 4 rotations
  (and to the candidate's own rotations, guarding self-ambiguity) is
  ≥ ``min_dist`` (default bits²//4);
- detection: binary = ``img < mean(img)`` (markers are black-bordered
  on light background; pass ``thresh`` to override); components sized
  [64 px², 90% of image]; quads = approxPolyDP at 5% perimeter with
  exactly 4 convex vertices; bits sampled at rectified cell centers
  with majority vote over a 3×3 neighborhood; border must be all
  black; payload matched against the dictionary over 4 rotations
  (exact match only); corners reordered so corner 0 is the marker's
  canonical top-left, clockwise.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from . import ccl, shape, warp


class Dictionary:
    """``n`` marker codes of ``bits × bits`` payload bits."""

    def __init__(self, codes: np.ndarray, bits: int):
        self.codes = codes          # [n, bits, bits] bool
        self.bits = bits

    @classmethod
    def generate(cls, n: int = 50, bits: int = 4, seed: int = 7,
                 min_dist: Optional[int] = None) -> "Dictionary":
        if min_dist is None:
            min_dist = (bits * bits) // 4
        rng = np.random.default_rng(seed)
        codes: List[np.ndarray] = []
        tries = 0
        while len(codes) < n:
            tries += 1
            if tries > 200000:
                raise RuntimeError("dictionary generation stalled; "
                                   "lower n or min_dist")
            cand = rng.integers(0, 2, (bits, bits)).astype(bool)
            rots = [np.rot90(cand, k) for k in range(4)]
            # self-ambiguity: rotations of itself must differ
            if any((cand ^ r).sum() < min_dist for r in rots[1:]):
                continue
            ok = True
            for c in codes:
                if any((c ^ r).sum() < min_dist for r in rots):
                    ok = False
                    break
            if ok:
                codes.append(cand)
        return cls(np.stack(codes), bits)

    def match(self, payload: np.ndarray) -> Tuple[int, int]:
        """→ (marker id, rotation k) or (-1, 0). Exact match over 4
        rotations: payload == rot90(code, k)."""
        for k in range(4):
            r = np.rot90(payload, -k)
            hits = np.all(self.codes == r[None], axis=(1, 2))
            idx = np.nonzero(hits)[0]
            if len(idx):
                return int(idx[0]), k
        return -1, 0


def draw_marker(dic: Dictionary, marker_id: int,
                cell_px: int = 8) -> np.ndarray:
    """→ u8 image of (bits+2)·cell_px square: black border + payload
    (True bit = white cell)."""
    bits = dic.bits
    grid = np.zeros((bits + 2, bits + 2), bool)
    grid[1:-1, 1:-1] = dic.codes[marker_id]
    img = np.where(np.repeat(np.repeat(grid, cell_px, 0), cell_px, 1),
                   255, 0).astype(np.uint8)
    return img


def _order_quad(pts: np.ndarray) -> np.ndarray:
    """Order 4 points clockwise starting top-left (y-down image)."""
    c = pts.mean(axis=0)
    ang = np.arctan2(pts[:, 1] - c[1], pts[:, 0] - c[0])
    order = np.argsort(ang)       # CCW in math = CW in y-down? keep CW:
    pts = pts[order]
    # rotate so the first point is the one with smallest x+y
    start = int(np.argmin(pts.sum(axis=1)))
    return np.roll(pts, -start, axis=0)


def detect_markers(img: np.ndarray, dic: Dictionary,
                   thresh: Optional[float] = None,
                   min_area: float = 64.0):
    """u8 gray (H, W) → (corners list of float32 [4, 2] (x, y) CW from
    canonical top-left, ids int32 [N]). Unmatched quads are dropped."""
    g = np.asarray(img)
    if g.ndim == 3:
        g = g[..., 0]
    t = float(g.mean()) if thresh is None else float(thresh)
    dark = g < t
    h, w = g.shape
    contours = ccl.find_contours(dark)
    bits = dic.bits
    cells = bits + 2
    out_corners, out_ids = [], []
    for cont in contours:
        if len(cont) < 8:
            continue
        area = shape.contour_area(cont)
        if area < min_area or area > 0.9 * h * w:
            continue
        peri = shape.arc_length(cont, closed=True)
        quad = shape.approx_poly_dp(cont, 0.05 * peri, closed=True)
        if len(quad) != 4 or not shape.is_contour_convex(quad):
            continue
        q = _order_quad(np.asarray(quad, np.float64))
        # rectify to a canonical (cells·8)² canvas and sample cells
        side = cells * 8
        dstq = np.array([[0, 0], [side - 1, 0], [side - 1, side - 1],
                         [0, side - 1]], np.float64)
        hmat = warp.get_perspective_transform(q, dstq)
        rect = warp.warp_perspective_numpy(
            g[..., None], hmat, (side, side))[..., 0]
        rb = rect < t
        # majority vote over 3×3 at each cell center
        grid = np.zeros((cells, cells), bool)
        for i in range(cells):
            for j in range(cells):
                cy, cx = i * 8 + 4, j * 8 + 4
                win = rb[cy - 1:cy + 2, cx - 1:cx + 2]
                grid[i, j] = win.mean() > 0.5
        border = np.concatenate([grid[0], grid[-1], grid[1:-1, 0],
                                 grid[1:-1, -1]])
        if not border.all():
            continue
        payload = ~grid[1:-1, 1:-1]          # True bit = white cell
        mid, rot = dic.match(payload)
        if mid < 0:
            continue
        # rotate corner order so corner 0 is the canonical top-left:
        # payload == rot90(code, rot) means the drawn marker appears
        # rotated rot·90° CCW in the image, so the canonical top-left
        # sits rot quad-steps BEHIND the image's top-left corner.
        out_corners.append(np.roll(q, rot, axis=0).astype(np.float32))
        out_ids.append(mid)
    return out_corners, np.asarray(out_ids, np.int32)


def estimate_pose_single_markers(corners, marker_length: float, K,
                                 dist=(0, 0, 0, 0, 0)):
    """Planar pose per marker (OpenCV ``estimatePoseSingleMarkers``
    role): homography decomposition K⁻¹H → [r1 r2 t], orthonormalized
    → (rvecs [N, 3], tvecs [N, 3]). Marker corners in its own frame:
    (±L/2, ±L/2, 0), corner 0 at (−L/2, −L/2)."""
    from . import calib

    K = np.asarray(K, np.float64)
    half = marker_length / 2.0
    obj = np.array([[-half, -half], [half, -half], [half, half],
                    [-half, half]], np.float64)
    rvecs, tvecs = [], []
    for c in corners:
        c = np.asarray(c, np.float64).reshape(4, 2)
        und = calib.undistort_points(c, K, dist)
        hmat = warp.get_perspective_transform(obj, und)
        a = np.linalg.inv(K) @ hmat
        s = np.sqrt(np.linalg.norm(a[:, 0]) * np.linalg.norm(a[:, 1]))
        if s < 1e-12:
            rvecs.append(np.zeros(3))
            tvecs.append(np.zeros(3))
            continue
        a = a / s
        if a[2, 2] < 0:
            a = -a
        r1, r2, t = a[:, 0], a[:, 1], a[:, 2]
        r3 = np.cross(r1, r2)
        rm = np.stack([r1, r2, r3], axis=1)
        u, _, vt = np.linalg.svd(rm)
        rm = u @ np.diag([1.0, 1.0, np.linalg.det(u @ vt)]) @ vt
        rvecs.append(calib.rodrigues(rm))
        tvecs.append(t)
    return np.asarray(rvecs), np.asarray(tvecs)


# ---------------------------------------------------------------------------
# Boards (OpenCV ``aruco.GridBoard`` / ``aruco.CharucoBoard`` roles)
# ---------------------------------------------------------------------------

class GridBoard:
    """Planar grid of markers (OpenCV ``aruco.GridBoard`` role):
    ``size`` = (markers_x, markers_y), marker side ``marker_length``,
    gap ``marker_separation`` (same units). Marker ids are row-major
    starting at ``first_id``. Object corners per marker follow the
    detect_markers order (CW from top-left)."""

    def __init__(self, size, marker_length: float,
                 marker_separation: float, dic: Dictionary,
                 first_id: int = 0):
        self.size = (int(size[0]), int(size[1]))
        self.marker_length = float(marker_length)
        self.marker_separation = float(marker_separation)
        self.dic = dic
        self.ids = np.arange(first_id,
                             first_id + size[0] * size[1], dtype=np.int32)

    def marker_object_corners(self, marker_id: int) -> np.ndarray:
        """(4, 3) object-space corners of one marker (z = 0)."""
        mx, _ = self.size
        idx = int(marker_id - self.ids[0])
        gx, gy = idx % mx, idx // mx
        step = self.marker_length + self.marker_separation
        x0, y0 = gx * step, gy * step
        ln = self.marker_length
        return np.array([[x0, y0, 0], [x0 + ln, y0, 0],
                         [x0 + ln, y0 + ln, 0], [x0, y0 + ln, 0]],
                        np.float64)

    def draw(self, cell_px: int = 8, margin_cells: int = 1) -> np.ndarray:
        """Render the full board → u8 image (white background)."""
        bits = self.dic.bits
        mcell = bits + 2
        sep_px = max(1, int(round(
            self.marker_separation / self.marker_length * mcell))) \
            * cell_px
        mpx = mcell * cell_px
        mx, my = self.size
        w = mx * mpx + (mx - 1) * sep_px + 2 * margin_cells * cell_px
        h = my * mpx + (my - 1) * sep_px + 2 * margin_cells * cell_px
        img = np.full((h, w), 255, np.uint8)
        for i, mid in enumerate(self.ids):
            gx, gy = i % mx, i // mx
            x0 = margin_cells * cell_px + gx * (mpx + sep_px)
            y0 = margin_cells * cell_px + gy * (mpx + sep_px)
            img[y0:y0 + mpx, x0:x0 + mpx] = draw_marker(
                self.dic, int(mid), cell_px)
        return img


def estimate_pose_board(corners, ids, board: GridBoard, k,
                        dist=(0, 0, 0, 0, 0)):
    """OpenCV ``estimatePoseBoard`` role: one rigid pose from ALL
    detected board markers → (n_used, rvec, tvec). Uses the planar
    solve_pnp over the stacked 2D-3D correspondences."""
    from . import calib

    obj, img = [], []
    id_set = set(int(i) for i in board.ids)
    for c, i in zip(corners, np.asarray(ids).ravel()):
        if int(i) in id_set:
            obj.append(board.marker_object_corners(int(i)))
            img.append(np.asarray(c, np.float64).reshape(4, 2))
    if not obj:
        return 0, None, None
    obj_all = np.concatenate(obj)
    img_all = np.concatenate(img)
    rvec, tvec = calib.solve_pnp(obj_all, img_all,
                                 np.asarray(k, np.float64), dist)
    return len(obj), rvec, tvec


class CharucoBoard:
    """Chessboard with ArUco markers in the white squares (OpenCV
    ``aruco.CharucoBoard`` role). ``size`` = (squares_x, squares_y);
    chessboard INNER corners are the calibration points, ids row-major
    over the (squares_x−1)·(squares_y−1) inner lattice."""

    def __init__(self, size, square_length: float, marker_length: float,
                 dic: Dictionary):
        self.size = (int(size[0]), int(size[1]))
        self.square_length = float(square_length)
        self.marker_length = float(marker_length)
        self.dic = dic
        sx, sy = self.size
        # markers sit in the "white" squares (checkerboard parity 1)
        self.marker_cells = [(cx, cy) for cy in range(sy)
                             for cx in range(sx) if (cx + cy) % 2 == 1]
        self.ids = np.arange(len(self.marker_cells), dtype=np.int32)

    def chessboard_corners(self) -> np.ndarray:
        """((sx−1)·(sy−1), 3) inner-corner object points, row-major."""
        sx, sy = self.size
        s = self.square_length
        pts = [(x * s, y * s, 0.0) for y in range(1, sy)
               for x in range(1, sx)]
        return np.asarray(pts, np.float64)

    def marker_object_corners(self, marker_id: int) -> np.ndarray:
        cx, cy = self.marker_cells[int(marker_id)]
        s = self.square_length
        ln = self.marker_length
        off = (s - ln) / 2.0
        x0, y0 = cx * s + off, cy * s + off
        return np.array([[x0, y0, 0], [x0 + ln, y0, 0],
                         [x0 + ln, y0 + ln, 0], [x0, y0 + ln, 0]],
                        np.float64)

    def draw(self, square_px: int = 32) -> np.ndarray:
        sx, sy = self.size
        img = np.full((sy * square_px, sx * square_px), 255, np.uint8)
        for cy in range(sy):
            for cx in range(sx):
                if (cx + cy) % 2 == 0:
                    img[cy * square_px:(cy + 1) * square_px,
                        cx * square_px:(cx + 1) * square_px] = 0
        mpx = int(round(self.marker_length / self.square_length
                        * square_px))
        bits = self.dic.bits
        cell = max(1, mpx // (bits + 2))
        mpx = cell * (bits + 2)
        off = (square_px - mpx) // 2
        for mid, (cx, cy) in enumerate(self.marker_cells):
            patch = draw_marker(self.dic, mid, cell)
            y0 = cy * square_px + off
            x0 = cx * square_px + off
            img[y0:y0 + mpx, x0:x0 + mpx] = patch
        return img


def interpolate_corners_charuco(corners, ids, img, board: CharucoBoard,
                                k=None, dist=(0, 0, 0, 0, 0)):
    """OpenCV ``interpolateCornersCharuco`` role: from the detected
    markers, fit the board→image homography and predict + locally
    refine every visible chessboard inner corner → (charuco_corners
    (N, 2) float64, charuco_ids (N,) int32). The refinement runs on the
    device of ``img`` if it is a tensor, else on the card."""
    from . import calib
    from .features import corner_sub_pix
    from .tensors import as_tensor

    obj, imgp = [], []
    for c, i in zip(corners, np.asarray(ids).ravel()):
        if 0 <= int(i) < len(board.marker_cells):
            obj.append(board.marker_object_corners(int(i))[:, :2])
            imgp.append(np.asarray(c, np.float64).reshape(4, 2))
    if len(obj) < 1:
        return np.zeros((0, 2)), np.zeros(0, np.int32)
    from .geometry import find_homography

    h_mat, _ = find_homography(np.concatenate(obj),
                               np.concatenate(imgp))
    if h_mat is None:
        return np.zeros((0, 2)), np.zeros(0, np.int32)
    cb = board.chessboard_corners()[:, :2]
    hpts = np.concatenate([cb, np.ones((len(cb), 1))], 1) @ h_mat.T
    pred = hpts[:, :2] / hpts[:, 2:3]
    device = img.device if isinstance(img, torch.Tensor) else None
    g = img.cpu().numpy() if device is not None else np.asarray(img)
    if g.ndim == 3:
        g = g[..., 0]
    hh, ww = g.shape
    keep = ((pred[:, 0] > 4) & (pred[:, 0] < ww - 5)
            & (pred[:, 1] > 4) & (pred[:, 1] < hh - 5))
    pred = pred[keep]
    ids_out = np.nonzero(keep)[0].astype(np.int32)
    if len(pred):
        pred = corner_sub_pix(as_tensor(g, device), pred.astype(np.float32),
                              win=9).cpu().numpy().astype(np.float64)
    return pred, ids_out
