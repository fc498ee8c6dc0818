"""Corner-response family (port of ``rustcv_tpu.ops.corner``; OpenCV
``spatialGradient`` / ``cornerMinEigenVal`` / ``cornerEigenValsAndVecs`` /
``preCornerDetect`` roles).

Float response surfaces with OpenCV's scaling conventions, apart from the
integer Harris spec of :mod:`.features`:

- gradients are the separable binomial⊛difference kernels
  (:func:`.filters.deriv_kernels`) with BORDER_REFLECT_101, OpenCV's
  default border (``sobel_xy`` replicates);
- cornerEigenValsAndVecs / cornerMinEigenVal scale each gradient by
  1/(2^(ksize-1) · 255 · blockSize) and window-sum the products with an
  unnormalized blockSize box (reflect-101);
- preCornerDetect = (Dxx·Dy² + Dyy·Dx² − 2·Dxy·Dx·Dy) / (2^(ksize-1)·255)³.

Tensors take shifted-view taps and elementwise algebra on their device
(the 2×2 eigen system in closed form); the float64 ``*_numpy`` oracles are
the reference's.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .filters import deriv_kernels
from .tensors import as_tensor


def _sep_filter_np(a: np.ndarray, kx: np.ndarray, ky: np.ndarray
                   ) -> np.ndarray:
    """Separable correlation, reflect-101 border, float64."""
    rx, ry = len(kx) // 2, len(ky) // 2
    h, w = a.shape
    p = np.pad(a, ((0, 0), (rx, rx)), mode="reflect")
    out = np.zeros((h, w), np.float64)
    for k, wgt in enumerate(kx):
        if wgt:
            out += wgt * p[:, k:k + w]
    p = np.pad(out, ((ry, ry), (0, 0)), mode="reflect")
    out2 = np.zeros((h, w), np.float64)
    for k, wgt in enumerate(ky):
        if wgt:
            out2 += wgt * p[k:k + h, :]
    return out2


def _reflect101(a: torch.Tensor, axis: int, r: int) -> torch.Tensor:
    n = a.shape[axis]
    idx = torch.arange(-r, n + r, device=a.device).abs()
    idx = torch.where(idx >= n, 2 * (n - 1) - idx, idx)
    return a.index_select(axis, idx)


def _sep_filter_t(a: torch.Tensor, kx, ky) -> torch.Tensor:
    rx, ry = len(kx) // 2, len(ky) // 2
    h, w = a.shape
    p = _reflect101(a, 1, rx)
    out = sum(float(wgt) * p[:, k:k + w] for k, wgt in enumerate(kx) if wgt)
    p = _reflect101(out, 0, ry)
    return sum(float(wgt) * p[k:k + h, :] for k, wgt in enumerate(ky) if wgt)


def _box_sum_np(a: np.ndarray, block: int) -> np.ndarray:
    r = block // 2
    h, w = a.shape
    p = np.pad(a, r, mode="reflect")
    out = np.zeros((h, w), np.float64)
    for dy in range(block):
        for dx in range(block):
            out += p[dy:dy + h, dx:dx + w]
    return out


def _box_sum_t(a: torch.Tensor, block: int) -> torch.Tensor:
    r = block // 2
    h, w = a.shape
    p = _reflect101(_reflect101(a, 0, r), 1, r)
    return sum(p[dy:dy + h, dx:dx + w] for dy in range(block) for dx in range(block))


# ---------------------------------------------------------------------------
# spatialGradient


def spatial_gradient_numpy(gray: np.ndarray, ksize: int = 3
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Oracle — int results (the kernels are integral)."""
    a = np.asarray(gray, np.float64)
    kx1, ky1 = deriv_kernels(1, 0, ksize)
    dx = _sep_filter_np(a, kx1, ky1)
    kx2, ky2 = deriv_kernels(0, 1, ksize)
    dy = _sep_filter_np(a, kx2, ky2)
    return dx.astype(np.int32), dy.astype(np.int32)


def spatial_gradient(gray: torch.Tensor, ksize: int = 3
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx, dy) int32, exact, on the tensor's device (a numpy image goes to
    the card)."""
    a = as_tensor(gray).to(torch.int32)
    kx1, ky1 = deriv_kernels(1, 0, ksize)
    kx2, ky2 = deriv_kernels(0, 1, ksize)
    return (_sep_filter_t(a, kx1, ky1).to(torch.int32),
            _sep_filter_t(a, kx2, ky2).to(torch.int32))


# ---------------------------------------------------------------------------
# covariance products (shared)


def _cov_np(gray: np.ndarray, block: int, ksize: int):
    a = np.asarray(gray, np.float64)
    scale = 1.0 / ((1 << (ksize - 1)) * 255.0 * block)
    kx1, ky1 = deriv_kernels(1, 0, ksize)
    kx2, ky2 = deriv_kernels(0, 1, ksize)
    dx = _sep_filter_np(a, kx1, ky1) * scale
    dy = _sep_filter_np(a, kx2, ky2) * scale
    return (_box_sum_np(dx * dx, block), _box_sum_np(dy * dy, block),
            _box_sum_np(dx * dy, block))


def _cov_t(gray: torch.Tensor, block: int, ksize: int):
    a = as_tensor(gray).to(torch.float32)
    scale = 1.0 / ((1 << (ksize - 1)) * 255.0 * block)
    kx1, ky1 = deriv_kernels(1, 0, ksize)
    kx2, ky2 = deriv_kernels(0, 1, ksize)
    dx = _sep_filter_t(a, kx1, ky1) * scale
    dy = _sep_filter_t(a, kx2, ky2) * scale
    return (_box_sum_t(dx * dx, block), _box_sum_t(dy * dy, block),
            _box_sum_t(dx * dy, block))


# ---------------------------------------------------------------------------
# cornerMinEigenVal


def corner_min_eigen_val_numpy(gray: np.ndarray, block_size: int = 3,
                               ksize: int = 3) -> np.ndarray:
    sxx, syy, sxy = _cov_np(gray, block_size, ksize)
    half_tr = (sxx + syy) * 0.5
    disc = np.sqrt(((sxx - syy) * 0.5) ** 2 + sxy * sxy)
    return (half_tr - disc).astype(np.float32)


def corner_min_eigen_val(gray: torch.Tensor, block_size: int = 3,
                         ksize: int = 3) -> torch.Tensor:
    sxx, syy, sxy = _cov_t(gray, block_size, ksize)
    half_tr = (sxx + syy) * 0.5
    disc = torch.sqrt(((sxx - syy) * 0.5) ** 2 + sxy * sxy)
    return half_tr - disc


# ---------------------------------------------------------------------------
# cornerEigenValsAndVecs


def corner_eigen_vals_and_vecs_numpy(gray: np.ndarray, block_size: int = 3,
                                     ksize: int = 3) -> np.ndarray:
    """(H, W, 6): λ1, λ2 (descending), x1, y1, x2, y2 — unit
    eigenvectors of the scaled covariance (sign is arbitrary; tests
    compare collinearity)."""
    sxx, syy, sxy = _cov_np(gray, block_size, ksize)
    half_tr = (sxx + syy) * 0.5
    disc = np.sqrt(((sxx - syy) * 0.5) ** 2 + sxy * sxy)
    l1, l2 = half_tr + disc, half_tr - disc

    def unit_vec(lam):
        # eigenvector of [[a,b],[b,c]] for λ: (b, λ-a), with the
        # degenerate isotropic fallback (1, 0)
        vx, vy = sxy, lam - sxx
        n = np.sqrt(vx * vx + vy * vy)
        bad = n < 1e-12
        vx = np.where(bad, 1.0, vx)
        vy = np.where(bad, 0.0, vy)
        n = np.where(bad, 1.0, n)
        return vx / n, vy / n

    x1, y1 = unit_vec(l1)
    x2, y2 = unit_vec(l2)
    return np.stack([l1, l2, x1, y1, x2, y2], axis=-1).astype(np.float32)


def corner_eigen_vals_and_vecs(gray: torch.Tensor, block_size: int = 3,
                               ksize: int = 3) -> torch.Tensor:
    sxx, syy, sxy = _cov_t(gray, block_size, ksize)
    half_tr = (sxx + syy) * 0.5
    disc = torch.sqrt(((sxx - syy) * 0.5) ** 2 + sxy * sxy)
    l1, l2 = half_tr + disc, half_tr - disc

    def unit_vec(lam):
        vx, vy = sxy, lam - sxx
        n = torch.sqrt(vx * vx + vy * vy)
        bad = n < 1e-12
        vx = torch.where(bad, 1.0, vx)
        vy = torch.where(bad, 0.0, vy)
        n = torch.where(bad, 1.0, n)
        return vx / n, vy / n

    x1, y1 = unit_vec(l1)
    x2, y2 = unit_vec(l2)
    return torch.stack([l1, l2, x1, y1, x2, y2], dim=-1)


# ---------------------------------------------------------------------------
# preCornerDetect


def pre_corner_detect_numpy(gray: np.ndarray, ksize: int = 3) -> np.ndarray:
    a = np.asarray(gray, np.float64)
    f = (1 << (ksize - 1)) * 255.0
    factor = 1.0 / (f * f * f)
    dx = _sep_filter_np(a, *deriv_kernels(1, 0, ksize))
    dy = _sep_filter_np(a, *deriv_kernels(0, 1, ksize))
    dxx = _sep_filter_np(a, *deriv_kernels(2, 0, ksize))
    dyy = _sep_filter_np(a, *deriv_kernels(0, 2, ksize))
    dxy = _sep_filter_np(a, *deriv_kernels(1, 1, ksize))
    out = factor * (dxx * dy * dy + dyy * dx * dx - 2.0 * dxy * dx * dy)
    return out.astype(np.float32)


def pre_corner_detect(gray: torch.Tensor, ksize: int = 3) -> torch.Tensor:
    a = as_tensor(gray).to(torch.float32)
    f = (1 << (ksize - 1)) * 255.0
    factor = 1.0 / (f * f * f)
    dx = _sep_filter_t(a, *deriv_kernels(1, 0, ksize))
    dy = _sep_filter_t(a, *deriv_kernels(0, 1, ksize))
    dxx = _sep_filter_t(a, *deriv_kernels(2, 0, ksize))
    dyy = _sep_filter_t(a, *deriv_kernels(0, 2, ksize))
    dxy = _sep_filter_t(a, *deriv_kernels(1, 1, ksize))
    return factor * (dxx * dy * dy + dyy * dx * dx - 2.0 * dxy * dx * dy)
