"""Contrast-preserving decolorization (OpenCV ``decolor`` role,
Lu/Xu/Jia 2012): map BGR → gray with a polynomial color-to-gray model
whose weights maximize preservation of color CONTRAST (iso-luminant
edges that plain luminance flattens stay visible).

Frozen spec (float64, deterministic):
- model: g = Σ w_k · b_k(r, g, b) over the 9 monomials
  {r, g, b, r², g², b², rg, rb, gb} on [0,1] channels;
- pairs: all 4-neighbor pixel pairs (subsampled on a fixed stride
  grid) plus pinned-MWC random pairs; target contrast δ_ij = the CIE76
  Lab color difference / 100;
- energy (bimodal): E = Σ min((Δg − δ)², (Δg + δ)²) — solved by
  alternating sign assignment and least squares (converges in ≤10
  rounds; ties initialize from the luminance ordering);
- weights constrained to Σ w(linear terms) = 1 via soft penalty, then
  the output is min-max rescaled to the input luminance range
  (matching cv2's normalized output);
- color_boost: Lab with chroma scaled by 1.3, back to BGR (cv2's
  companion output's role).

Tests compare contrast preservation against cv2.decolor on
iso-luminant scenes (both must beat plain luminance; outputs
correlate), not pixel equality — cv2's discrete weight search (they
quantize weights to a lattice) differs from our continuous solve.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .golden import bgr_to_lab as bgr_to_lab_numpy
from .golden import lab_to_bgr as lab_to_bgr_numpy
from .core_ops import RNG


def _basis(rgb: np.ndarray) -> np.ndarray:
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    return np.stack([r, g, b, r * r, g * g, b * b, r * g, r * b,
                     g * b], axis=-1)


def decolor(bgr: np.ndarray, stride: int = 4, n_random: int = 1024,
            rounds: int = 10) -> Tuple[np.ndarray, np.ndarray]:
    """→ (gray u8 (H, W), color_boost u8 BGR)."""
    img = np.asarray(bgr)
    h, w = img.shape[:2]
    rgb = img[..., ::-1].astype(np.float64) / 255.0

    # contrast targets from Lab differences
    lab = bgr_to_lab_numpy(img).astype(np.float64)
    lab = lab * np.array([100.0 / 255.0, 1.0, 1.0]) \
        - np.array([0.0, 128.0, 128.0])

    ys, xs = np.mgrid[0:h:stride, 0:w:stride]
    ys, xs = ys.ravel(), xs.ravel()
    pairs = []
    for dy, dx in ((0, stride), (stride, 0)):
        ok = (ys + dy < h) & (xs + dx < w)
        pairs.append(np.stack([ys[ok], xs[ok], ys[ok] + dy,
                               xs[ok] + dx], 1))
    rng = RNG(7)
    rnd = np.array([[rng.uniform_int(0, h), rng.uniform_int(0, w),
                     rng.uniform_int(0, h), rng.uniform_int(0, w)]
                    for _ in range(n_random)])
    pairs = np.concatenate(pairs + [rnd])
    p1 = pairs[:, :2]
    p2 = pairs[:, 2:]

    dlab = lab[p1[:, 0], p1[:, 1]] - lab[p2[:, 0], p2[:, 1]]
    delta = np.sqrt((dlab ** 2).sum(-1)) / 100.0
    keep = delta > 1e-3
    p1, p2, delta = p1[keep], p2[keep], delta[keep]

    bas = _basis(rgb)
    db = bas[p1[:, 0], p1[:, 1]] - bas[p2[:, 0], p2[:, 1]]  # (P, 9)

    # init signs from luminance ordering
    lum = 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]
    s = np.sign(lum[p1[:, 0], p1[:, 1]] - lum[p2[:, 0], p2[:, 1]])
    s[s == 0] = 1.0

    # soft constraint: r+g+b weights sum to 1
    c = np.zeros(9)
    c[:3] = 1.0
    lam = float(len(delta))
    ata = db.T @ db + lam * np.outer(c, c) + 1e-9 * np.eye(9)
    wvec = None
    for _ in range(rounds):
        atb = db.T @ (s * delta) + lam * c
        wvec = np.linalg.solve(ata, atb)
        dg = db @ wvec
        new_s = np.where(np.abs(dg - delta) <= np.abs(dg + delta),
                         1.0, -1.0)
        if (new_s == s).all():
            break
        s = new_s

    gray = bas @ wvec
    lo, hi = gray.min(), gray.max()
    if hi - lo < 1e-9:
        gray_u8 = np.full((h, w), int(round(lo * 255)), np.uint8)
    else:
        gray_u8 = np.clip(np.rint((gray - lo) / (hi - lo) * 255.0),
                          0, 255).astype(np.uint8)

    # color boost: Lab chroma ×1.3
    lab_u8 = bgr_to_lab_numpy(img).astype(np.float64)
    lab_u8[..., 1:] = (lab_u8[..., 1:] - 128.0) * 1.3 + 128.0
    boost = lab_to_bgr_numpy(np.clip(lab_u8, 0, 255).astype(np.uint8))
    return gray_u8, boost


def contrast_preservation(gray: np.ndarray, bgr: np.ndarray,
                          stride: int = 4) -> float:
    """Diagnostic: correlation between gray-level differences and Lab
    color differences over neighbor pairs (higher = better)."""
    img = np.asarray(bgr)
    h, w = img.shape[:2]
    lab = bgr_to_lab_numpy(img).astype(np.float64)
    g = np.asarray(gray, np.float64)
    dgs, dcs = [], []
    for dy, dx in ((0, stride), (stride, 0)):
        a = lab[:h - dy or h, :w - dx or w]
        b = lab[dy:, dx:]
        dc = np.sqrt(((a - b) ** 2).sum(-1)).ravel()
        dg = np.abs(g[:h - dy or h, :w - dx or w] - g[dy:, dx:]).ravel()
        dgs.append(dg)
        dcs.append(dc)
    dg = np.concatenate(dgs)
    dc = np.concatenate(dcs)
    if dg.std() < 1e-9 or dc.std() < 1e-9:
        return 0.0
    return float(np.corrcoef(dg, dc)[0, 1])
