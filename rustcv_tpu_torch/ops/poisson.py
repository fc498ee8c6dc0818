"""Poisson image editing (port of ``rustcv_tpu.ops.poisson``; OpenCV
``seamlessClone`` role, Pérez et al. 2003): NORMAL_CLONE and MIXED_CLONE.

The reference has no photo compositing; OpenCV-parity addition in the
inpaint family (ops/inpaint.py). The reference's device twin runs the
Jacobi relaxation as a ``lax.fori_loop`` over the whole image; the port's
(:func:`seamless_clone` on a tensor) runs the same fixed ``max_iters``
steps as a Python loop of in-place tensor ops over the hole's bounding
box, on the destination's device. ``color_change``,
``illumination_change`` and ``texture_flattening`` are the reference's
host numpy, copied.

Frozen spec (float64 oracle :func:`seamless_clone_numpy`):
- the source patch and mask are placed centred at ``center`` (x, y) in
  the destination; mask pixels outside the destination are dropped;
- guidance field per 4-neighbor edge: ``v_pq = g(p) − g(q)`` of the
  source (NORMAL_CLONE); MIXED_CLONE takes whichever of source/dest
  gradient has the larger |magnitude| per edge (per channel);
- solve ``4f(p) − Σ_q f(q) = Σ_q v_pq`` on mask pixels, ``f = dst``
  outside (Dirichlet); Jacobi iterations from ``f₀ = dst`` until max
  update < ``tol`` (or ``max_iters``); edges leaving the image use the
  replicate value (zero-gradient boundary);
- output rounded half-up, clipped u8.
"""

from __future__ import annotations

import numpy as np
import torch

NORMAL_CLONE = 1
MIXED_CLONE = 2


def _patch_grads(src: np.ndarray):
    """Per-edge source gradients v_pq = g(p) − g(q) in PATCH space with
    replicate borders (zero gradient across the patch edge) — guidance
    must come from the source data, never from the empty canvas."""
    p = np.pad(src.astype(np.float64), ((1, 1), (1, 1), (0, 0)),
               mode="edge")
    g = src.astype(np.float64)
    return [g - p[:-2, 1:-1], g - p[2:, 1:-1],
            g - p[1:-1, :-2], g - p[1:-1, 2:]]


def _place(src: np.ndarray, mask: np.ndarray, dst_shape, center):
    """Embed the source's guidance gradients + mask into dst-sized
    canvases centred at ``center``; returns (4 gradient canvases f64,
    hole bool)."""
    dh, dw = dst_shape[:2]
    sh, sw = mask.shape
    cx, cy = int(center[0]), int(center[1])
    y0 = cy - sh // 2
    x0 = cx - sw // 2
    sy0, sx0 = max(-y0, 0), max(-x0, 0)
    sy1 = min(dh - y0, sh)
    sx1 = min(dw - x0, sw)
    grads = [np.zeros(dst_shape, np.float64) for _ in range(4)]
    hole = np.zeros((dh, dw), bool)
    if sy1 > sy0 and sx1 > sx0:
        for canvas, pg in zip(grads, _patch_grads(src)):
            canvas[y0 + sy0:y0 + sy1, x0 + sx0:x0 + sx1] = \
                pg[sy0:sy1, sx0:sx1]
        hole[y0 + sy0:y0 + sy1, x0 + sx0:x0 + sx1] = \
            mask[sy0:sy1, sx0:sx1].astype(bool)
    # boundary pixels cannot be interior unknowns (need a Dirichlet ring)
    hole[0, :] = hole[-1, :] = False
    hole[:, 0] = hole[:, -1] = False
    return grads, hole


def _rhs(grads, d: np.ndarray, mixed: bool) -> np.ndarray:
    """Σ_q v_pq (f64, per channel) from embedded source gradients,
    optionally mixing in stronger destination gradients per edge."""
    p = np.pad(d, ((1, 1), (1, 1), (0, 0)), mode="edge")
    dshifts = (p[:-2, 1:-1], p[2:, 1:-1], p[1:-1, :-2], p[1:-1, 2:])
    total = np.zeros_like(d)
    for vg, dq in zip(grads, dshifts):
        if mixed:
            vd = d - dq
            v = np.where(np.abs(vd) > np.abs(vg), vd, vg)
        else:
            v = vg
        total += v
    return total


def seamless_clone_numpy(src: np.ndarray, dst: np.ndarray,
                         mask: np.ndarray, center,
                         flags: int = NORMAL_CLONE,
                         max_iters: int = 4000,
                         tol: float = 0.01) -> np.ndarray:
    """Oracle — float64 Jacobi. src u8 (h, w[, C]), dst u8 (H, W[, C]),
    mask (h, w), center (x, y) in dst coords → u8 like dst."""
    src = np.asarray(src)
    dst = np.asarray(dst)
    single = dst.ndim == 2
    s3 = src[..., None] if src.ndim == 2 else src
    d3 = (dst[..., None] if single else dst).astype(np.float64)
    grads, hole = _place(s3, np.asarray(mask), d3.shape, center)
    if not hole.any():
        return dst.copy()
    rhs = _rhs(grads, d3, flags == MIXED_CLONE)
    hm = hole[..., None]
    f = d3.copy()
    for _ in range(max_iters):
        p = np.pad(f, ((1, 1), (1, 1), (0, 0)), mode="edge")
        nsum = p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:]
        new = np.where(hm, (nsum + rhs) / 4.0, d3)
        delta = np.abs(new - f)[hole].max()
        f = new
        if delta < tol:
            break
    out = np.clip(np.floor(f + 0.5), 0, 255).astype(np.uint8)
    return out[..., 0] if single else out


def _clone_core(grads: np.ndarray, d3: torch.Tensor, hole: np.ndarray, flags: int,
                max_iters: int) -> torch.Tensor:
    """Fixed-iteration float32 Jacobi on ``d3 [H, W, C]``'s device over the
    hole's bounding box and its one-pixel ring (the hole never touches the
    image border, and outside the hole ``f`` stays ``dst``, so the box is
    the whole problem). Two preallocated buffers take turns; each step is
    six in-place tensor ops and reads nothing back to the host."""
    ys, xs = np.nonzero(hole)
    r0, r1, c0, c1 = ys.min() - 1, ys.max() + 2, xs.min() - 1, xs.max() + 2
    dev = d3.device
    dc = d3[r0:r1, c0:c1]
    hm = torch.from_numpy(hole[r0 + 1:r1 - 1, c0 + 1:c1 - 1, None]).to(dev)
    g = torch.from_numpy(np.ascontiguousarray(
        grads[:, r0 + 1:r1 - 1, c0 + 1:c1 - 1], np.float32)).to(dev)
    di = dc[1:-1, 1:-1]
    rhs = torch.zeros_like(di)
    for i, dq in enumerate((dc[:-2, 1:-1], dc[2:, 1:-1], dc[1:-1, :-2], dc[1:-1, 2:])):
        vg = g[i]
        if flags == MIXED_CLONE:
            vd = di - dq
            rhs = rhs + torch.where(torch.abs(vd) > torch.abs(vg), vd, vg)
        else:
            rhs = rhs + vg
    hmf = hm.to(torch.float32)
    keep = di * (1.0 - hmf)  # dst where the mask is off (exact: × 1 or × 0)
    f, nxt = dc.clone(), dc.clone()
    t = torch.empty_like(di)
    for _ in range(max_iters):
        torch.add(f[:-2, 1:-1], f[2:, 1:-1], out=t)
        t.add_(f[1:-1, :-2]).add_(f[1:-1, 2:]).add_(rhs).mul_(0.25)
        torch.addcmul(keep, t, hmf, out=nxt[1:-1, 1:-1])
        f, nxt = nxt, f
    out = d3.clone()
    out[r0:r1, c0:c1] = f
    return torch.clamp(torch.floor(out + 0.5), 0, 255).to(torch.uint8)


def seamless_clone(src, dst, mask, center, flags: int = NORMAL_CLONE,
                   max_iters: int = 4000):
    """Device twin (float32 fixed-iteration Jacobi on ``dst``'s device;
    ±1 LSB vs the oracle on converged problems). A numpy ``dst`` runs the
    oracle."""
    if isinstance(dst, np.ndarray):
        return seamless_clone_numpy(src, dst, mask, center, flags,
                                    max_iters)
    src_np = src.cpu().numpy() if isinstance(src, torch.Tensor) else np.asarray(src)
    single = dst.ndim == 2
    s3 = src_np[..., None] if src_np.ndim == 2 else src_np
    d3 = (dst[..., None] if single else dst).to(torch.float32)
    mask_np = mask.cpu().numpy() if isinstance(mask, torch.Tensor) else np.asarray(mask)
    grads, hole = _place(s3, mask_np, tuple(d3.shape), center)
    if not hole.any():
        return dst
    out = _clone_core(np.stack(grads), d3, hole, flags, max_iters)
    return out[..., 0] if single else out


# ---------------------------------------------------------------------------
# Poisson-editing extensions (OpenCV colorChange / illuminationChange /
# textureFlattening roles) — same solver, modified guidance fields.
# ---------------------------------------------------------------------------

def _solve_with_grads(grads, dst, hole, max_iters, tol):
    """Oracle Jacobi solve with explicit gradient canvases (f64)."""
    d3 = dst.astype(np.float64)
    rhs = _rhs(grads, d3, mixed=False)
    hm = hole[..., None]
    f = d3.copy()
    for _ in range(max_iters):
        p = np.pad(f, ((1, 1), (1, 1), (0, 0)), mode="edge")
        nsum = p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:]
        new = np.where(hm, (nsum + rhs) / 4.0, d3)
        delta = np.abs(new - f)[hole].max() if hole.any() else 0.0
        f = new
        if delta < tol:
            break
    return np.clip(np.floor(f + 0.5), 0, 255).astype(np.uint8)


def _self_grads(img3: np.ndarray):
    """Gradient canvases of the image itself (full-canvas patch)."""
    return _patch_grads(img3.astype(np.float64))


def color_change(img: np.ndarray, mask: np.ndarray, mul=(1.5, 1.0, 1.0),
                 max_iters: int = 4000, tol: float = 0.01) -> np.ndarray:
    """OpenCV ``colorChange`` role: per-channel gradient scaling inside
    the mask, seamlessly re-integrated. ``mul`` = BGR multipliers."""
    img = np.asarray(img)
    d3 = img[..., None] if img.ndim == 2 else img
    hole = np.asarray(mask).astype(bool).copy()
    hole[0, :] = hole[-1, :] = False
    hole[:, 0] = hole[:, -1] = False
    m = np.asarray(mul, np.float64).reshape(1, 1, -1)
    grads = [g * m for g in _self_grads(d3)]
    out = _solve_with_grads(grads, d3, hole, max_iters, tol)
    return out[..., 0] if img.ndim == 2 else out


def illumination_change(img: np.ndarray, mask: np.ndarray,
                        alpha: float = 0.2, beta: float = 0.4,
                        max_iters: int = 4000,
                        tol: float = 0.01) -> np.ndarray:
    """OpenCV ``illuminationChange`` role (Pérez §4.4): gradients scale
    by ``(α_eff/|v|)^β`` with ``α_eff = alpha · mean|v|`` over the mask
    — gradients above the (alpha-scaled) mask average compress,
    flattening strong illumination; weak texture is gently lifted."""
    img = np.asarray(img)
    d3 = img[..., None] if img.ndim == 2 else img
    hole = np.asarray(mask).astype(bool).copy()
    hole[0, :] = hole[-1, :] = False
    hole[:, 0] = hole[:, -1] = False
    grads = []
    for g in _self_grads(d3):
        mag = np.abs(g).mean(axis=-1, keepdims=True)
        a_eff = alpha * max(float(mag[hole].mean()), 1e-6)
        scale = np.power(a_eff / np.maximum(mag, 1e-3), beta)
        grads.append(g * scale)
    out = _solve_with_grads(grads, d3, hole, max_iters, tol)
    return out[..., 0] if img.ndim == 2 else out


def texture_flattening(img: np.ndarray, mask: np.ndarray,
                       low_threshold: float = 8.0,
                       max_iters: int = 4000,
                       tol: float = 0.01) -> np.ndarray:
    """OpenCV ``textureFlattening`` role: only gradients with magnitude
    ≥ ``low_threshold`` survive inside the mask (edge-only guidance —
    Pérez §4.3's Canny variant with a plain magnitude gate, frozen)."""
    img = np.asarray(img)
    d3 = img[..., None] if img.ndim == 2 else img
    hole = np.asarray(mask).astype(bool).copy()
    hole[0, :] = hole[-1, :] = False
    hole[:, 0] = hole[:, -1] = False
    grads = []
    for g in _self_grads(d3):
        mag = np.abs(g).sum(axis=-1, keepdims=True)
        grads.append(np.where(mag >= low_threshold, g, 0.0))
    out = _solve_with_grads(grads, d3, hole, max_iters, tol)
    return out[..., 0] if img.ndim == 2 else out
