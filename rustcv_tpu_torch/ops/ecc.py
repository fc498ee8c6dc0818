"""ECC image alignment (port of ``rustcv_tpu.ops.ecc``; OpenCV
``findTransformECC`` / ``computeECC`` roles — Evangelidis & Psarakis,
PAMI 2008).

Beside the frozen float64 host oracle (the default backend) runs a tensor
twin on the images' device (``backend="device"``): each iteration is
bilinear sampling at warp-derived coordinates, elementwise Jacobians, the
normal equations in full float32 (no TF32 on the card) and one tiny (n×n,
n ≤ 8) ``solve_ex``; the iterations are a Python loop with no host read,
the parameters frozen on the device once converged.

Frozen spec (float64 oracle; forward-additive ECC):
- warp W(x; p) maps TEMPLATE coords → INPUT coords (OpenCV's
  convention): "translation" (2 dof), "euclidean" (3), "affine" (6),
  "homography" (8, matrix normalized to m22 = 1);
- sampling: bilinear with clamp-to-edge coordinates (every template
  pixel participates — no validity mask);
- per iteration: iw = I(W(x)), gradients of I sampled the same way
  (central differences on I first, then warped), steepest-descent
  images G = [∇I_w]·∂W/∂p, zero-mean t̄ and ī over the full template,
  projection P = G(GᵀG)⁻¹Gᵀ, λ = (‖ī‖² − īᵀPī)/(t̄ᵀī − t̄ᵀPī),
  Δp = (GᵀG)⁻¹Gᵀ(λt̄ − ī), p += Δp;
- a non-positive λ denominator means the images are uncorrelated in
  the current basin: the oracle raises ValueError (OpenCV errors the
  same way), the device twin freezes further updates and reports
  rho = −1 (on the same iteration, with no host read);
- stop after ``iterations`` or when |ρ − ρ_prev| < ``eps``
  (ρ = t̄ᵀī/(‖t̄‖·‖ī‖)); returns (rho, warp) with warp 2×3 (3×3 for
  homography).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .tensors import full_f32

__all__ = ["find_transform_ecc", "find_transform_ecc_numpy",
           "compute_ecc"]

_MOTIONS = ("translation", "euclidean", "affine", "homography")


def _warp_init(motion: str, warp) -> np.ndarray:
    if motion not in _MOTIONS:
        raise ValueError(f"unknown motion type {motion!r}")
    if warp is None:
        return np.eye(3, dtype=np.float64) if motion == "homography" \
            else np.eye(2, 3, dtype=np.float64)
    w = np.asarray(warp, np.float64)
    if motion == "homography":
        if w.shape == (2, 3):
            w = np.vstack([w, [0.0, 0.0, 1.0]])
        if w.shape != (3, 3):
            raise ValueError("homography warp must be 3x3")
        return w / w[2, 2]
    if w.shape == (3, 3):
        w = w[:2]
    if w.shape != (2, 3):
        raise ValueError("warp must be 2x3")
    return w.copy()


def _params_of(motion: str, w: np.ndarray) -> np.ndarray:
    if motion == "translation":
        return np.array([w[0, 2], w[1, 2]])
    if motion == "euclidean":
        return np.array([np.arctan2(w[1, 0], w[0, 0]), w[0, 2], w[1, 2]])
    if motion == "affine":
        return w[:2].reshape(-1)
    return np.array([w[0, 0], w[0, 1], w[0, 2], w[1, 0], w[1, 1],
                     w[1, 2], w[2, 0], w[2, 1]])


def _warp_of(motion: str, p: np.ndarray) -> np.ndarray:
    if motion == "translation":
        return np.array([[1.0, 0, p[0]], [0, 1.0, p[1]]])
    if motion == "euclidean":
        c, s = np.cos(p[0]), np.sin(p[0])
        return np.array([[c, -s, p[1]], [s, c, p[2]]])
    if motion == "affine":
        return p.reshape(2, 3)
    return np.array([[p[0], p[1], p[2]], [p[3], p[4], p[5]],
                     [p[6], p[7], 1.0]])


def _sample_np(img: np.ndarray, xs: np.ndarray, ys: np.ndarray):
    h, w = img.shape
    x = np.clip(xs, 0.0, w - 1.0)
    y = np.clip(ys, 0.0, h - 1.0)
    x0 = np.minimum(np.floor(x).astype(np.int64), w - 2)
    y0 = np.minimum(np.floor(y).astype(np.int64), h - 2)
    fx = x - x0
    fy = y - y0
    a = img[y0, x0]
    b = img[y0, x0 + 1]
    c = img[y0 + 1, x0]
    d = img[y0 + 1, x0 + 1]
    return a * (1 - fx) * (1 - fy) + b * fx * (1 - fy) + \
        c * (1 - fx) * fy + d * fx * fy


def _coords(motion: str, p: np.ndarray, h: int, w: int):
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    m = _warp_of(motion, p)
    if motion == "homography":
        d = m[2, 0] * xs + m[2, 1] * ys + m[2, 2]
        return ((m[0, 0] * xs + m[0, 1] * ys + m[0, 2]) / d,
                (m[1, 0] * xs + m[1, 1] * ys + m[1, 2]) / d, d)
    return (m[0, 0] * xs + m[0, 1] * ys + m[0, 2],
            m[1, 0] * xs + m[1, 1] * ys + m[1, 2], None)


def _jacobian_np(motion: str, gx, gy, xs, ys, p, denom):
    """Steepest-descent images (N, n_params)."""
    if motion == "translation":
        cols = [gx, gy]
    elif motion == "euclidean":
        c, s = np.cos(p[0]), np.sin(p[0])
        dxdth = -s * xs - c * ys
        dydth = c * xs - s * ys
        cols = [gx * dxdth + gy * dydth, gx, gy]
    elif motion == "affine":
        cols = [gx * xs, gx * ys, gx, gy * xs, gy * ys, gy]
    else:  # homography (denominators from the current warp)
        wx, wy, d = denom
        inv = 1.0 / d
        cols = [gx * xs * inv, gx * ys * inv, gx * inv,
                gy * xs * inv, gy * ys * inv, gy * inv,
                (-gx * wx - gy * wy) * xs * inv,
                (-gx * wx - gy * wy) * ys * inv]
    return np.stack([c.reshape(-1) for c in cols], axis=1)


def find_transform_ecc_numpy(
    template,
    image,
    motion: str = "affine",
    warp=None,
    iterations: int = 50,
    eps: float = 1e-6,
) -> Tuple[float, np.ndarray]:
    """Frozen ECC spec → (rho, warp 2×3 or 3×3 float64)."""
    t = np.asarray(template, np.float64)
    im = np.asarray(image, np.float64)
    if t.ndim != 2 or im.ndim != 2:
        raise ValueError("ECC expects gray images")
    h, w = t.shape
    p = _params_of(motion, _warp_init(motion, warp))
    gy_full, gx_full = np.gradient(im)
    tz = t - t.mean()
    tnorm = np.linalg.norm(tz)
    tzf = tz.reshape(-1)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    rho_prev = -np.inf
    rho = -1.0
    for _ in range(iterations):
        wx, wy, d = _coords(motion, p, h, w)
        iw = _sample_np(im, wx, wy)
        gx = _sample_np(gx_full, wx, wy)
        gy = _sample_np(gy_full, wx, wy)
        iz = (iw - iw.mean()).reshape(-1)
        inorm = np.linalg.norm(iz)
        rho = float(tzf @ iz / max(tnorm * inorm, 1e-300))
        if abs(rho - rho_prev) < eps:
            break
        rho_prev = rho
        g = _jacobian_np(motion, gx, gy, xs, ys, p, (wx, wy, d))
        g = g - g.mean(axis=0)          # zero-mean like t̄, ī
        gtg = g.T @ g
        try:
            gtg_inv = np.linalg.inv(gtg)
        except np.linalg.LinAlgError:
            raise ValueError("ECC: singular Jacobian (flat image?)")
        gti = g.T @ iz
        gtt = g.T @ tzf
        num = inorm * inorm - gti @ gtg_inv @ gti
        den = tzf @ iz - gtt @ gtg_inv @ gti
        if den <= 0:
            raise ValueError(
                "ECC: non-positive correlation denominator — the images "
                "may be uncorrelated or the initial warp too far off")
        lam = num / den
        err = lam * tzf - iz
        dp = gtg_inv @ (g.T @ err)
        p = p + dp
    return rho, _warp_of(motion, p)


def compute_ecc(template, image) -> float:
    """Enhanced correlation coefficient of two equal-size gray images
    (OpenCV ``computeECC`` role): zero-mean normalized correlation."""
    t = np.asarray(template, np.float64)
    im = np.asarray(image, np.float64)
    tz = (t - t.mean()).reshape(-1)
    iz = (im - im.mean()).reshape(-1)
    return float(tz @ iz / max(np.linalg.norm(tz) * np.linalg.norm(iz),
                               1e-300))


# ---------------------------------------------------------------------------
# device twin (float32, fixed iteration count)
# ---------------------------------------------------------------------------

def _sample_t(planes, xs, ys):
    """Bilinear samples of the [C, H, W] planes at (xs, ys) (clamped to
    the image) with one set of indices and weights → [C, N]."""
    _, h, w = planes.shape
    x = torch.clamp(xs, 0.0, w - 1.0).reshape(-1)
    y = torch.clamp(ys, 0.0, h - 1.0).reshape(-1)
    x0 = torch.clamp(torch.floor(x).to(torch.int64), max=w - 2)
    y0 = torch.clamp(torch.floor(y).to(torch.int64), max=h - 2)
    fx = x - x0
    fy = y - y0
    flat = planes.reshape(planes.shape[0], -1)
    i00 = y0 * w + x0

    def at(off):
        return flat.index_select(1, i00 + off)

    return at(0) * ((1 - fx) * (1 - fy)) + at(1) * (fx * (1 - fy)) + \
        at(w) * ((1 - fx) * fy) + at(w + 1) * (fx * fy)


def _ecc_core(t, im, p0, motion: str, iterations: int, eps: float):
    """(rho, p) float32 tensors after ``iterations`` rounds; converged or
    degenerate rounds leave p as it was. The steepest-descent images are
    rows [n, N], so every product is a row-major GEMM or GEMV."""
    h, w = t.shape
    dev = t.device
    t = t.to(torch.float32)
    im = im.to(device=dev, dtype=torch.float32)
    gy_full, gx_full = torch.gradient(im)
    planes = torch.stack([im, gx_full, gy_full])
    tz = t - t.mean()
    tnorm = torch.linalg.vector_norm(tz)
    tzf = tz.reshape(-1)
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w).reshape(-1)
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w).reshape(-1)

    def warp_coords(p):
        if motion == "translation":
            return xs + p[0], ys + p[1], None
        if motion == "euclidean":
            c, s = torch.cos(p[0]), torch.sin(p[0])
            return c * xs - s * ys + p[1], s * xs + c * ys + p[2], None
        if motion == "affine":
            return (p[0] * xs + p[1] * ys + p[2],
                    p[3] * xs + p[4] * ys + p[5], None)
        d = p[6] * xs + p[7] * ys + 1.0
        return ((p[0] * xs + p[1] * ys + p[2]) / d,
                (p[3] * xs + p[4] * ys + p[5]) / d, d)

    def jac(p, gx, gy, denom):
        if motion == "translation":
            rows = [gx, gy]
        elif motion == "euclidean":
            c, s = torch.cos(p[0]), torch.sin(p[0])
            rows = [gx * (-s * xs - c * ys) + gy * (c * xs - s * ys),
                    gx, gy]
        elif motion == "affine":
            rows = [gx * xs, gx * ys, gx, gy * xs, gy * ys, gy]
        else:
            wx, wy, d = denom
            inv = 1.0 / d
            rows = [gx * xs * inv, gx * ys * inv, gx * inv,
                    gy * xs * inv, gy * ys * inv, gy * inv,
                    (-gx * wx - gy * wy) * xs * inv,
                    (-gx * wx - gy * wy) * ys * inv]
        return torch.stack(rows)

    p = p0.to(device=dev, dtype=torch.float32)
    nparam = p.shape[0]
    ridge = 1e-12 * torch.eye(nparam, dtype=torch.float32, device=dev)
    rho_prev = torch.tensor(-2.0, device=dev)
    frozen = torch.tensor(False, device=dev)
    with full_f32(dev):
        for _ in range(iterations):
            wx, wy, d = warp_coords(p)
            iw, gx, gy = _sample_t(planes, wx, wy)
            iz = iw - iw.mean()
            inorm = torch.linalg.vector_norm(iz)
            rho = tzf @ iz / torch.clamp(tnorm * inorm, min=1e-30)
            g = jac(p, gx, gy, (wx, wy, d))
            g = g - g.mean(dim=1, keepdim=True)
            gtg = g @ g.T + ridge
            gti = g @ iz
            gtt = g @ tzf
            sol_i = torch.linalg.solve_ex(gtg, gti)[0]
            num = inorm * inorm - gti @ sol_i
            den = tzf @ iz - gtt @ sol_i
            bad = den <= 0
            lam = num / torch.where(bad, 1.0, den)
            err = lam * tzf - iz
            dp = torch.linalg.solve_ex(gtg, g @ err)[0]
            conv = torch.abs(rho - rho_prev) < eps
            stop = frozen | bad | conv
            p = torch.where(stop, p, p + dp)
            rho_prev = torch.where(bad, -1.0, rho)
            frozen = stop | frozen
    return rho_prev, p


def find_transform_ecc(
    template,
    image,
    motion: str = "affine",
    warp=None,
    iterations: int = 50,
    eps: float = 1e-6,
    backend: str = "host",
):
    """ECC alignment (OpenCV ``findTransformECC`` role) → (rho, warp).
    ``backend`` = "host" (f64 oracle, default — raises on uncorrelated
    images like OpenCV) | "device" (the float32 twin on the device of
    ``template`` or ``image`` when either is a tensor, else on the card;
    it freezes and reports rho = −1 instead of raising; agreement with the
    oracle ~1e-2 px of warp translation on synthetic scenes)."""
    if backend == "host":
        return find_transform_ecc_numpy(template, image, motion, warp,
                                        iterations, eps)
    if backend != "device":
        raise ValueError(backend)
    dev = next((a.device for a in (template, image) if isinstance(a, torch.Tensor)),
               torch.device("cuda"))
    p0 = _params_of(motion, _warp_init(motion, warp))
    rho, p = _ecc_core(torch.as_tensor(np.asarray(template) if not isinstance(template, torch.Tensor)
                                       else template, device=dev),
                       torch.as_tensor(np.asarray(image) if not isinstance(image, torch.Tensor)
                                       else image, device=dev),
                       torch.as_tensor(p0, dtype=torch.float32), motion,
                       int(iterations), float(eps))
    out = torch.cat([rho.reshape(1).double(), p.double()]).cpu().numpy()
    return float(out[0]), _warp_of(motion, out[1:])


def find_transform_ecc_multiscale(template, image, motion: str = "affine",
                                  levels: int = 3, iterations: int = 30,
                                  eps: float = 1e-6
                                  ) -> Tuple[float, np.ndarray]:
    """Coarse-to-fine ECC (OpenCV ``findTransformECCMultiScale`` role):
    solve on a pyramid, upscaling the warp's translation part between
    levels — converges for displacements far beyond the single-scale
    basin. → (rho, warp)."""
    from .golden import pyr_down

    t = np.asarray(template)
    im = np.asarray(image)
    pyr_t = [t]
    pyr_i = [im]
    for _ in range(levels - 1):
        pyr_t.append(pyr_down(pyr_t[-1]))
        pyr_i.append(pyr_down(pyr_i[-1]))
    warp = None
    rho = 0.0
    for lvl in range(levels - 1, -1, -1):
        if warp is not None:
            warp = warp.copy()
            if warp.shape == (3, 3):
                warp[0, 2] *= 2.0
                warp[1, 2] *= 2.0
                warp[2, 0] /= 2.0
                warp[2, 1] /= 2.0
            else:
                warp[:, 2] *= 2.0
        rho, warp = find_transform_ecc_numpy(
            pyr_t[lvl], pyr_i[lvl], motion=motion, warp=warp,
            iterations=iterations, eps=eps)
    return rho, warp
