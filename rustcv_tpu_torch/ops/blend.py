"""Stitching detail components (port of ``rustcv_tpu.ops.blend``: OpenCV
``detail::MultiBandBlender`` / ``detail::GainCompensator`` /
``detail::VoronoiSeamFinder`` roles): multi-band Laplacian blending on
tensors where the caller's tensor is, least-squares exposure gains and the
Voronoi seam on the host.

Frozen specs (float64 oracles):
- multi_band_blend: Laplacian pyramids of both images + Gaussian
  pyramid of the mask, per-level ``L = m·L1 + (1−m)·L2``, collapsed;
  5-tap [1,4,6,4,1]/16 blur, levels = min(⌊log2(min(H,W))⌋−2, n_bands).
  The device form is float32 with the reference's order of summation
  (each blur a left-to-right sum of weighted taps, rows then columns):
  within ±1 LSB of the float64 oracle;
- gain_compensation: Brown-Lowe pairwise gains — minimize
  ``Σ_ij N_ij ((g_i Ī_ij − g_j Ī_ji)/σ_N)² + Σ_i N_i (1−g_i)²/σ_g²``
  with σ_N = 10.1, σ_g = 0.1 (the published constants), closed-form
  linear solve.
- voronoi_seam: each overlap pixel goes to the mask it lies deeper in
  (exact L2 distance to the mask's outside, :mod:`.ccl`; ties to the
  first).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def _blur5(a: np.ndarray) -> np.ndarray:
    k = np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0
    p = np.pad(a, ((2, 2), (0, 0)) + ((0, 0),) * (a.ndim - 2),
               mode="edge")
    out = sum(w * p[i:i + a.shape[0]] for i, w in enumerate(k))
    p = np.pad(out, ((0, 0), (2, 2)) + ((0, 0),) * (a.ndim - 2),
               mode="edge")
    return sum(w * p[:, i:i + a.shape[1]] for i, w in enumerate(k))


def _down(a):
    return _blur5(a)[::2, ::2]


def _up(a, shape):
    out = np.zeros(shape[:2] + a.shape[2:], a.dtype)
    out[::2, ::2] = a
    return _blur5(out) * 4.0


def _levels_for(h: int, w: int, n_bands: int) -> int:
    return max(1, min(int(np.log2(min(h, w))) - 2, n_bands))


def multi_band_blend_numpy(img1: np.ndarray, img2: np.ndarray,
                           mask1: np.ndarray,
                           n_bands: int = 5) -> np.ndarray:
    """Blend two aligned images: ``mask1`` (float [0,1] or bool) keeps
    img1. u8 in → u8 out."""
    a = np.asarray(img1, np.float64)
    b = np.asarray(img2, np.float64)
    m = np.asarray(mask1, np.float64)
    if a.ndim == 3 and m.ndim == 2:
        m = m[..., None]
    levels = _levels_for(a.shape[0], a.shape[1], n_bands)

    ga, gb, gm = [a], [b], [m]
    for _ in range(levels - 1):
        ga.append(_down(ga[-1]))
        gb.append(_down(gb[-1]))
        gm.append(_down(gm[-1]))
    out = None
    for lv in reversed(range(levels)):
        if lv == levels - 1:
            la, lb = ga[lv], gb[lv]
        else:
            la = ga[lv] - _up(ga[lv + 1], ga[lv].shape)
            lb = gb[lv] - _up(gb[lv + 1], gb[lv].shape)
        blended = gm[lv] * la + (1.0 - gm[lv]) * lb
        out = blended if out is None else _up(out, blended.shape) \
            + blended
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


_BLUR5 = (0.0625, 0.25, 0.375, 0.25, 0.0625)  # [1, 4, 6, 4, 1] / 16, exact in float32


def _blur5_t(a: torch.Tensor) -> torch.Tensor:
    """Separable 5-tap binomial, replicate border, rows then columns; each
    pass sums its weighted taps left to right in float32."""
    h, w = a.shape[0], a.shape[1]
    rows = torch.arange(-2, h + 2, device=a.device).clamp(0, h - 1)
    p = a.index_select(0, rows)
    out = _BLUR5[0] * p[0:h]
    for i in range(1, 5):
        out = out + _BLUR5[i] * p[i:i + h]
    cols = torch.arange(-2, w + 2, device=a.device).clamp(0, w - 1)
    p = out.index_select(1, cols)
    out = _BLUR5[0] * p[:, 0:w]
    for i in range(1, 5):
        out = out + _BLUR5[i] * p[:, i:i + w]
    return out


def _down_t(x: torch.Tensor) -> torch.Tensor:
    return _blur5_t(x)[::2, ::2]


def _up_t(x: torch.Tensor, shape) -> torch.Tensor:
    out = torch.zeros(tuple(shape[:2]) + tuple(x.shape[2:]), dtype=x.dtype, device=x.device)
    out[::2, ::2] = x
    return _blur5_t(out) * 4.0


def multi_band_blend(img1: torch.Tensor, img2: torch.Tensor, mask1,
                     n_bands: int = 5) -> torch.Tensor:
    """Blend two aligned images on img1's device (numpy images on the
    CPU): ``mask1`` (float [0,1] or bool; a host mask is uploaded) keeps
    img1. u8 in → u8 out."""
    a = torch.as_tensor(img1).to(torch.float32)
    b = torch.as_tensor(img2, device=a.device).to(torch.float32)
    m = torch.as_tensor(mask1, device=a.device).to(torch.float32)
    if a.ndim == 3 and m.ndim == 2:
        m = m[..., None]
    levels = _levels_for(a.shape[0], a.shape[1], n_bands)

    ga, gb, gm = [a], [b], [m]
    for _ in range(levels - 1):
        ga.append(_down_t(ga[-1]))
        gb.append(_down_t(gb[-1]))
        gm.append(_down_t(gm[-1]))
    out = None
    for lv in reversed(range(levels)):
        if lv == levels - 1:
            la, lb = ga[lv], gb[lv]
        else:
            la = ga[lv] - _up_t(ga[lv + 1], ga[lv].shape)
            lb = gb[lv] - _up_t(gb[lv + 1], gb[lv].shape)
        blended = gm[lv] * la + (1.0 - gm[lv]) * lb
        out = blended if out is None else _up_t(out, blended.shape) + blended
    return torch.round(out).clamp(0, 255).to(torch.uint8)


def gain_compensation(images: Sequence[np.ndarray],
                      masks: Sequence[np.ndarray]) -> np.ndarray:
    """Brown-Lowe exposure gains (OpenCV ``detail::GainCompensator``):
    per-image scalar gains g minimizing the pairwise overlap error →
    (N,) float64. ``masks`` are validity masks in the shared frame."""
    n = len(images)
    sigma_n, sigma_g = 10.1, 0.1
    imeans = np.zeros((n, n))
    counts = np.zeros((n, n))
    for i in range(n):
        mi = np.asarray(masks[i]).astype(bool)
        gi = np.asarray(images[i], np.float64)
        if gi.ndim == 3:
            gi = gi.mean(axis=-1)
        for j in range(n):
            if i == j:
                continue
            ov = mi & np.asarray(masks[j]).astype(bool)
            counts[i, j] = ov.sum()
            if counts[i, j]:
                imeans[i, j] = gi[ov].mean()
    # OpenCV's normal equations: α = 1/σ_N², β = 1/σ_g²
    alpha = 1.0 / sigma_n ** 2
    beta = 1.0 / sigma_g ** 2
    a = np.zeros((n, n))
    b = np.zeros(n)
    for i in range(n):
        for j in range(n):
            if i == j:
                continue
            nij = counts[i, j]
            if nij == 0:
                continue
            a[i, i] += nij * (beta + alpha * imeans[i, j] ** 2)
            a[i, j] -= nij * alpha * imeans[i, j] * imeans[j, i]
            b[i] += nij * beta
    if not a.any():
        return np.ones(n)
    return np.linalg.solve(a + 1e-12 * np.eye(n), b)


def voronoi_seam(mask1, mask2) -> Tuple[np.ndarray, np.ndarray]:
    """OpenCV ``detail::VoronoiSeamFinder`` role: split the overlap by
    which image's valid region owns the pixel more deeply (exact L2
    distance to the region border) → adjusted (mask1, mask2), bool numpy.
    Masks on a device are fetched once."""
    from .ccl import _host_mask, distance_transform_l2_with_labels

    m1 = _host_mask(mask1).astype(bool)
    m2 = _host_mask(mask2).astype(bool)
    # distance to the OUTSIDE of each region (zero pixels = ~mask)
    d1, _ = distance_transform_l2_with_labels(m1.astype(np.uint8))
    d2, _ = distance_transform_l2_with_labels(m2.astype(np.uint8))
    overlap = m1 & m2
    keep1 = d1 >= d2
    out1 = m1 & (~overlap | keep1)
    out2 = m2 & (~overlap | ~keep1)
    return out1, out2
