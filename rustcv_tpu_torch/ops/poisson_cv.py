"""Copy of ``rustcv_tpu.ops.poisson_cv`` (imports the port's ``color`` and
``canny_cv``). cv2-exact seamless-cloning family (photo module Poisson editing).

OpenCV's seamless cloning (photo/src/seamless_cloning_impl.cpp role)
solves the Poisson equation over the WHOLE image rectangle with a
DST-I spectral solver and Dirichlet boundary = the original image's
1-px border — NOT an iterative hole solve.  This module reproduces
that structure (verified differentially against cv2 5.0 in
tests/test_poisson_cv.py; the ops/poisson.py iterative variants remain
the frozen framework spec used by imgproc/).

Pipeline (per function):
  1. forward-difference gradients of destination and masked patch
     (filter2D [0,-1,1] semantics, reflect-101 border) — computed on
     the CROPPED ROI mats for seamlessClone (cv2 passes a cloned
     destination ROI and a fresh zero-backed source ROI to
     normalClone, so ROI-edge gradients reflect within the ROI),
  2. per-variant gradient edit (scalar multipliers, Canny edge
     gating, magnitude compression, mixed |gx-gy| selection),
  3. patch gradients scaled by the 3x-eroded mask (3x3 full kernel;
     the erode sees PARENT mask pixels past a ROI edge, i.e. zeros),
  4. destination gradients scaled by the bitwise_not of the SAME
     eroded mask (cv2's evaluate() inverts it in place — the caller's
     mask array comes back inverted from cv2; we don't reproduce that
     side effect),
  5. divergence via backward differences, minus the boundary
     Laplacian, solved per channel by DST-I eigenvalue division,
  6. interior written back with C truncation-toward-zero + clip,
     border kept from the destination.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "seamless_clone_cv", "color_change_cv", "illumination_change_cv",
    "texture_flattening_cv",
]

NORMAL_CLONE = 1
MIXED_CLONE = 2
MONOCHROME_TRANSFER = 3


# ------------------------------------------------------------ gradients

def _grad_x(img: np.ndarray) -> np.ndarray:
    """filter2D kernel [0,-1,1] (forward diff), BORDER_REFLECT_101."""
    f = img.astype(np.float32)
    out = np.empty_like(f)
    out[:, :-1] = f[:, 1:] - f[:, :-1]
    # at the last column reflect-101 mirrors index w -> w-2
    out[:, -1] = f[:, -2] - f[:, -1]
    return out


def _grad_y(img: np.ndarray) -> np.ndarray:
    f = img.astype(np.float32)
    out = np.empty_like(f)
    out[:-1, :] = f[1:, :] - f[:-1, :]
    out[-1, :] = f[-2, :] - f[-1, :]
    return out


def _lap_x(g: np.ndarray) -> np.ndarray:
    """filter2D kernel [-1,1,0] (backward diff), BORDER_REFLECT_101."""
    out = np.empty_like(g)
    out[:, 1:] = g[:, 1:] - g[:, :-1]
    out[:, 0] = g[:, 0] - g[:, 1]
    return out


def _lap_y(g: np.ndarray) -> np.ndarray:
    out = np.empty_like(g)
    out[1:, :] = g[1:, :] - g[:-1, :]
    out[0, :] = g[0, :] - g[1, :]
    return out


def _erode3x3(mask: np.ndarray, iterations: int = 3) -> np.ndarray:
    """u8 erode, 3x3 full kernel, cv2 default border (+inf for erode =
    border pixels never shrink the minimum; edge-replicate is
    equivalent for min)."""
    m = np.asarray(mask, np.uint8)
    for _ in range(iterations):
        p = np.pad(m, 1, mode="edge")
        windows = [p[dy:dy + m.shape[0], dx:dx + m.shape[1]]
                   for dy in range(3) for dx in range(3)]
        m = np.minimum.reduce(windows)
    return m


# ------------------------------------------------------------ DST solve

def _dst1(a: np.ndarray, axis: int) -> np.ndarray:
    """DST-I along ``axis`` via the odd-extension FFT (cv2's dst()):
    for length N, X[k] = sum_n a[n] sin(pi (k+1)(n+1)/(N+1))."""
    a = np.moveaxis(a, axis, -1)
    n = a.shape[-1]
    ext = np.zeros(a.shape[:-1] + (2 * n + 2,), np.float64)
    ext[..., 1:n + 1] = a
    ext[..., n + 2:] = -a[..., ::-1]
    sp = np.fft.rfft(ext, axis=-1)
    out = -0.5 * sp.imag[..., 1:n + 1]
    return np.moveaxis(out, -1, axis)


def _poisson_solver_u8(img_u8: np.ndarray, lap: np.ndarray) -> np.ndarray:
    """One channel: Dirichlet boundary from img border, DST-I eigen
    division, interior truncation-toward-zero (cv2 Cloning::solve)."""
    h, w = img_u8.shape
    bound = img_u8.astype(np.float32).copy()
    bound[1:-1, 1:-1] = 0.0
    # Laplacian (ksize=1 kernel [[0,1,0],[1,-4,1],[0,1,0]]), reflect101
    p = np.pad(bound, 1, mode="reflect")
    blap = (p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:]
            - 4.0 * bound)
    mod_diff = (lap - blap)[1:-1, 1:-1].astype(np.float64)

    i = np.arange(w - 2)
    j = np.arange(h - 2)
    fx = 2.0 * np.cos(np.pi * (i + 1) / (w - 1))
    fy = 2.0 * np.cos(np.pi * (j + 1) / (h - 1))
    res = _dst1(_dst1(mod_diff, 1), 0)
    res /= (fx[None, :] + fy[:, None] - 4.0)
    # inverse DST-I via the odd-extension DFT pair: forward X = S x,
    # inverse x = (2/(N+1)) S X per axis.
    interior = _dst1(_dst1(res, 1), 0)
    interior *= 4.0 / ((w - 1) * (h - 1))

    out = img_u8.copy()
    vals = np.trunc(interior)
    out[1:-1, 1:-1] = np.clip(vals, 0, 255).astype(np.uint8)
    return out


def _evaluate(dest_u8: np.ndarray, eroded_mask_u8: np.ndarray,
              dest_gx, dest_gy, patch_gx, patch_gy) -> np.ndarray:
    """cv2 Cloning::evaluate: destination gradients scaled by the
    bitwise_not of the ERODED mask (patch gradients arrive already
    scaled by the same eroded mask), divergence, solve per channel.
    NB cv2 performs the bitwise_not IN PLACE on the caller's mask —
    the Python-level mask argument comes back inverted; we do not
    reproduce that side effect."""
    inv = ((255 - np.asarray(eroded_mask_u8, np.uint8)).astype(np.float32)
           / 255.0)[..., None]
    gx = dest_gx * inv + patch_gx
    gy = dest_gy * inv + patch_gy
    lap = _lap_x(gx) + _lap_y(gy)
    out = np.empty_like(dest_u8)
    for c in range(dest_u8.shape[2]):
        out[..., c] = _poisson_solver_u8(dest_u8[..., c], lap[..., c])
    return out


def _gray_of(mask: np.ndarray) -> np.ndarray:
    m = np.asarray(mask)
    if m.ndim == 3 and m.shape[-1] == 1:
        m = m[..., 0]
    if m.ndim == 3:
        from .color import bgr_to_gray_cv
        return bgr_to_gray_cv(m)
    return np.asarray(m, np.uint8)


def _masked_patch(src: np.ndarray, gray: np.ndarray) -> np.ndarray:
    patch = np.zeros_like(src)
    nz = gray != 0
    patch[nz] = src[nz]
    return patch


def _prep_full(src: np.ndarray, mask: np.ndarray):
    """Full-image variants (colorChange/illuminationChange/texture):
    gradients of src and masked patch, eroded mask (u8 + float)."""
    gray = _gray_of(mask)
    patch = _masked_patch(src, gray)
    dgx, dgy = _grad_x(src), _grad_y(src)
    pgx, pgy = _grad_x(patch), _grad_y(patch)
    er = _erode3x3(gray, 3)
    return patch, er, dgx, dgy, pgx, pgy, er.astype(np.float32) / 255.0


# ------------------------------------------------------------ variants

def color_change_cv(src: np.ndarray, mask: np.ndarray,
                    red_mul: float = 1.0, green_mul: float = 1.0,
                    blue_mul: float = 1.0) -> np.ndarray:
    """OpenCV ``colorChange``: per-channel gradient scaling inside the
    mask (channel 2 = red)."""
    src = np.asarray(src, np.uint8)
    _, er, dgx, dgy, pgx, pgy, mf = _prep_full(src, mask)
    mul = np.array([blue_mul, green_mul, red_mul], np.float32)
    pgx = pgx * mf[..., None] * mul
    pgy = pgy * mf[..., None] * mul
    return _evaluate(src, er, dgx, dgy, pgx, pgy)


def illumination_change_cv(src: np.ndarray, mask: np.ndarray,
                           alpha: float = 0.2,
                           beta: float = 0.4) -> np.ndarray:
    """OpenCV ``illuminationChange``: gradient magnitudes compressed by
    alpha^beta * |g|^-beta inside the mask (NaNs from zero gradients
    patched to 0, as cv2's patchNaNs does)."""
    src = np.asarray(src, np.uint8)
    _, er, dgx, dgy, pgx, pgy, mf = _prep_full(src, mask)
    pgx = pgx * mf[..., None]
    pgy = pgy * mf[..., None]
    mag = np.sqrt(pgx * pgx + pgy * pgy).astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        sx = (pgx * np.float32(alpha ** beta)
              * np.power(mag, np.float32(-beta)))
        sy = (pgy * np.float32(alpha ** beta)
              * np.power(mag, np.float32(-beta)))
    pgx = np.nan_to_num(sx, nan=0.0, posinf=0.0, neginf=0.0)
    pgy = np.nan_to_num(sy, nan=0.0, posinf=0.0, neginf=0.0)
    return _evaluate(src, er, dgx, dgy, pgx, pgy)


def texture_flattening_cv(src: np.ndarray, mask: np.ndarray,
                          low_threshold: float = 30.0,
                          high_threshold: float = 45.0,
                          kernel_size: int = 3) -> np.ndarray:
    """OpenCV ``textureFlattening``: only patch gradients on Canny
    edges of the masked patch survive (Canny runs on the 3-channel
    masked patch with ``kernel_size`` as the Sobel aperture)."""
    from .canny_cv import canny_cv

    src = np.asarray(src, np.uint8)
    patch, er, dgx, dgy, pgx, pgy, mf = _prep_full(src, mask)
    edges = canny_cv(patch, low_threshold, high_threshold, kernel_size)
    keep = (edges == 255)[..., None]
    pgx = np.where(keep, pgx, 0.0) * mf[..., None]
    pgy = np.where(keep, pgy, 0.0) * mf[..., None]
    return _evaluate(src, er, dgx, dgy, pgx, pgy)


def seamless_clone_cv(src: np.ndarray, dst: np.ndarray, mask: np.ndarray,
                      p, flags: int = 1) -> np.ndarray:
    """OpenCV ``seamlessClone``: ROI around the mask's bounding box is
    blended into ``dst`` centred at ``p``.  flags: 1=NORMAL_CLONE,
    2=MIXED_CLONE, 3=MONOCHROME_TRANSFER.

    cv2 zeroes the 1-px border of the mask before taking the bounding
    rect, passes destinationROI as a clone and sourceROI as a fresh
    zero-backed mat into normalClone (so gradients reflect-101 within
    the ROI), and erodes the mask ROI as a VIEW (the erode reads
    parent zeros past the bbox edge)."""
    src = np.asarray(src, np.uint8)
    dst = np.asarray(dst, np.uint8)
    gray = np.asarray(_gray_of(mask), np.uint8).copy()
    # cv2: mask 1-px border zeroed before boundingRect
    gray[0, :] = 0
    gray[-1, :] = 0
    gray[:, 0] = 0
    gray[:, -1] = 0

    ys, xs = np.nonzero(gray)
    if len(ys) == 0:
        return dst.copy()
    minx, maxx = int(xs.min()), int(xs.max())
    miny, maxy = int(ys.min()), int(ys.max())
    lenx = maxx - minx + 1
    leny = maxy - miny + 1
    minxd = int(p[0]) - lenx // 2
    minyd = int(p[1]) - leny // 2
    if (minxd < 0 or minyd < 0 or minxd + lenx > dst.shape[1]
            or minyd + leny > dst.shape[0]):
        raise ValueError(
            "seamlessClone: destination ROI "
            f"({minxd},{minyd})+{lenx}x{leny} outside dst "
            f"{dst.shape[1]}x{dst.shape[0]}")

    sy = slice(miny, miny + leny)
    sx = slice(minx, minx + lenx)

    # sourceROI: fresh zero mat filled by the masked src ROI
    patch = _masked_patch(src[sy, sx], gray[sy, sx])
    pgx, pgy = _grad_x(patch), _grad_y(patch)
    # destinationROI: a clone — reflect-101 at ROI edges
    blend = dst.copy()
    dest_roi = blend[minyd:minyd + leny, minxd:minxd + lenx].copy()
    dgx, dgy = _grad_x(dest_roi), _grad_y(dest_roi)
    # mask erode on the ROI view: parent pixels (zeros past the tight
    # bbox) participate -> erode the full mask, then crop
    er = _erode3x3(gray, 3)[sy, sx]
    mf = er.astype(np.float32) / 255.0

    if flags == MIXED_CLONE:
        # per element: |px - py| > |dx - dy| keeps the patch gradient,
        # dest wins ties; both scaled by the eroded mask
        use_p = np.abs(pgx - pgy) > np.abs(dgx - dgy)
        pgx = np.where(use_p, pgx, dgx) * mf[..., None]
        pgy = np.where(use_p, pgy, dgy) * mf[..., None]
    elif flags == MONOCHROME_TRANSFER:
        from .color import bgr_to_gray_cv
        g = bgr_to_gray_cv(patch)
        pgx = _grad_x(g)[..., None].repeat(3, axis=2) * mf[..., None]
        pgy = _grad_y(g)[..., None].repeat(3, axis=2) * mf[..., None]
    else:  # NORMAL_CLONE
        pgx = pgx * mf[..., None]
        pgy = pgy * mf[..., None]

    out_roi = _evaluate(dest_roi, er, dgx, dgy, pgx, pgy)
    blend[minyd:minyd + leny, minxd:minxd + lenx] = out_roi
    return blend
