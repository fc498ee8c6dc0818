"""Copy of ``rustcv_tpu.ops.colorchecker`` (the port's ``ccl``, ``golden``,
``shape``, ``geometry`` and ``core_ops``). ColorChecker chart detection (OpenCV ``mcc::CCheckerDetector``
role): locate a Macbeth-style 24-patch (6×4) chart and sample its
patch colors — the front end of the color-calibration loop whose back
end is ops/core_ops.color_correction_matrix.

Detection: threshold + contours → the largest dark quadrilateral
(the chart's border frame), ordered corners → homography to the
canonical 6×4 grid → per-patch median color sampled from the central
60% of each cell. The canonical 24 sRGB reference values ship with the
module (the published BabelColor averages, rounded — data computed
from the public spec, not copied from any implementation).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

# Published sRGB (D65) reference values for the classic 24-patch chart
# (row-major, patch 1 = dark skin ... 24 = black), 0-255.
REFERENCE_SRGB = np.array([
    [115, 82, 68], [194, 150, 130], [98, 122, 157], [87, 108, 67],
    [133, 128, 177], [103, 189, 170],
    [214, 126, 44], [80, 91, 166], [193, 90, 99], [94, 60, 108],
    [157, 188, 64], [224, 163, 46],
    [56, 61, 150], [70, 148, 73], [175, 54, 60], [231, 199, 31],
    [187, 86, 149], [8, 133, 161],
    [243, 243, 242], [200, 200, 200], [160, 160, 160], [122, 122, 121],
    [85, 85, 85], [52, 52, 52],
], np.float64)


def _order_corners(pts: np.ndarray) -> np.ndarray:
    c = pts.mean(0)
    ang = np.arctan2(pts[:, 1] - c[1], pts[:, 0] - c[0])
    p = pts[np.argsort(ang)]
    # start at the top-left-most corner
    start = int(np.argmin(p.sum(1)))
    return np.roll(p, -start, axis=0)


def detect_color_checker(bgr: np.ndarray
                         ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """→ (corners (4, 2) float64 TL,TR,BR,BL of the chart frame,
    patch_colors (24, 3) float64 BGR row-major) or None."""
    from .ccl import find_contours
    from .golden import bgr_to_gray
    from .shape import approx_poly_dp, contour_area

    img = np.asarray(bgr)
    gray = bgr_to_gray(img) if img.ndim == 3 else img
    h, w = gray.shape
    # the chart frame is dark: threshold below the global median
    thr = np.percentile(gray, 35)
    mask = (gray < thr).astype(np.uint8)
    best = None
    best_area = 0.0
    for contour in find_contours(mask):
        area = abs(contour_area(contour))
        if area < 0.01 * h * w or area <= best_area:
            continue
        approx = approx_poly_dp(contour, 0.05 * np.sqrt(area) * 4)
        if len(approx) == 4:
            best = np.asarray(approx, np.float64).reshape(4, 2)
            best_area = area
    if best is None:
        return None
    corners = _order_corners(best)
    # homography canonical grid → image (6 cols × 4 rows inside the
    # frame with a 3% margin)
    from .geometry import find_homography

    canon = np.array([[0.0, 0], [6, 0], [6, 4], [0, 4]])
    hmat, _ = find_homography(canon, corners)
    if hmat is None:
        return None
    colors = np.zeros((24, 3))
    src = img if img.ndim == 3 else np.stack([img] * 3, -1)
    for r in range(4):
        for c in range(6):
            # central 60% of the cell
            us = np.linspace(c + 0.2, c + 0.8, 5)
            vs = np.linspace(r + 0.2, r + 0.8, 5)
            uu, vv = np.meshgrid(us, vs)
            pts = np.stack([uu.ravel(), vv.ravel(),
                            np.ones(uu.size)], 1) @ hmat.T
            px = pts[:, 0] / pts[:, 2]
            py = pts[:, 1] / pts[:, 2]
            xi = np.clip(np.round(px).astype(int), 0, w - 1)
            yi = np.clip(np.round(py).astype(int), 0, h - 1)
            colors[r * 6 + c] = np.median(src[yi, xi], axis=0)
    return corners, colors


def color_checker_ccm(patch_colors_bgr: np.ndarray,
                      affine: bool = True) -> np.ndarray:
    """Fit the CCM mapping the DETECTED patch colors onto the published
    reference (linear RGB in [0,1]) → (3, 3|4) for
    ops.core_ops.apply_ccm."""
    from .core_ops import color_correction_matrix

    src = np.asarray(patch_colors_bgr, np.float64)[:, ::-1] / 255.0
    ref = REFERENCE_SRGB / 255.0
    return color_correction_matrix(src, ref, affine=affine)
