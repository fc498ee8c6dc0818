"""Variational flow refinement (port of ``rustcv_tpu.ops.varref``; OpenCV
``VariationalRefinement`` role, Brox et al. 2004 energy): polish an initial dense flow field with a
robust brightness-constancy data term + gradient-constancy term and
Charbonnier-smoothed total-variation regularization.

Frozen spec (float64 oracle):
- warp I1 by the current flow (bilinear, border clamp) once per outer
  (fixed-point) iteration; linearize brightness constancy around it:
  ``ρ(du, dv) = I_t + I_x·du + I_y·dv`` with I_x/I_y the averaged
  central-difference gradients of warped I1 and I0;
- gradient constancy: same linearization per gradient channel;
- robust weights ``ψ'(s²) = 1/√(s² + ε²)`` (ε = 1e-3) recomputed each
  inner iteration for the data term and for the smoothness term (edges
  between 4-neighbors);
- the Euler-Lagrange system is solved by ``sor_iterations`` red-black
  SOR sweeps (ω = 1.6) for the flow INCREMENT (du, dv), which is added
  to the flow after each of ``fixed_point_iterations`` outer rounds;
- intensities scaled to [0,1]; delta (brightness) and gamma (gradient)
  weigh the data terms, alpha the smoothness — defaults 5/10/20 as in
  OpenCV.

cv2's implementation differs in discretization details, so outputs are
not bit-equal; tests pin (a) end-point-error reduction of a noisy flow
on ground-truth scenes and (b) EPE within 1.5× of
cv2.VariationalRefinement on the same inputs.

On the tensor's device the refinement is two nested Python loops of
elementwise ops (fixed-point rounds, SOR sweeps) with no host read,
red-black via checkerboard masks, the warp a bilinear gather.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .tensors import as_tensor

EPS2 = 1e-6
OMEGA = 1.6


def _warp_np(img: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    h, w = img.shape
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    x = np.clip(xs + u, 0.0, w - 1.0)
    y = np.clip(ys + v, 0.0, h - 1.0)
    x0 = np.clip(np.floor(x).astype(np.int64), 0, w - 2)
    y0 = np.clip(np.floor(y).astype(np.int64), 0, h - 2)
    fx = x - x0
    fy = y - y0
    a = img[y0, x0]
    b = img[y0, x0 + 1]
    c = img[y0 + 1, x0]
    d = img[y0 + 1, x0 + 1]
    return (a * (1 - fx) * (1 - fy) + b * fx * (1 - fy)
            + c * (1 - fx) * fy + d * fx * fy)


def _cgrad_np(img: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    gx = np.zeros_like(img)
    gy = np.zeros_like(img)
    gx[:, 1:-1] = 0.5 * (img[:, 2:] - img[:, :-2])
    gy[1:-1, :] = 0.5 * (img[2:, :] - img[:-2, :])
    return gx, gy


def variational_refine_numpy(i0: np.ndarray, i1: np.ndarray,
                             flow: np.ndarray, alpha: float = 20.0,
                             delta: float = 5.0, gamma: float = 10.0,
                             fixed_point_iterations: int = 5,
                             sor_iterations: int = 5) -> np.ndarray:
    """Oracle — flow (H, W, 2) float refined against u8/float frames."""
    f0 = np.asarray(i0, np.float64) / 255.0
    f1 = np.asarray(i1, np.float64) / 255.0
    u = np.asarray(flow[..., 0], np.float64).copy()
    v = np.asarray(flow[..., 1], np.float64).copy()
    h, w = f0.shape
    g0x, g0y = _cgrad_np(f0)

    for _ in range(fixed_point_iterations):
        wrp = _warp_np(f1, u, v)
        w1x, w1y = _cgrad_np(wrp)
        ix = 0.5 * (g0x + w1x)
        iy = 0.5 * (g0y + w1y)
        it = wrp - f0
        # gradient-constancy channels (linearized with second derivs)
        ixx, ixy = _cgrad_np(ix)
        iyx, iyy = _cgrad_np(iy)
        itx = w1x - g0x
        ity = w1y - g0y

        du = np.zeros((h, w))
        dv = np.zeros((h, w))
        yy, xx = np.mgrid[0:h, 0:w]
        red = ((yy + xx) % 2) == 0
        for _ in range(sor_iterations):
            # robust data weight
            r = it + ix * du + iy * dv
            rgx = itx + ixx * du + ixy * dv
            rgy = ity + iyx * du + iyy * dv
            psi_d = delta / np.sqrt(r * r + EPS2)
            psi_g = gamma / np.sqrt(rgx * rgx + rgy * rgy + EPS2)
            # smoothness weights on the CURRENT total flow
            uu = u + du
            vv = v + dv
            ugx, ugy = _cgrad_np(uu)
            vgx, vgy = _cgrad_np(vv)
            psi_s = alpha / np.sqrt(ugx ** 2 + ugy ** 2 + vgx ** 2
                                    + vgy ** 2 + EPS2)

            a11 = psi_d * ix * ix + psi_g * (ixx ** 2 + iyx ** 2)
            a12 = psi_d * ix * iy + psi_g * (ixx * ixy + iyx * iyy)
            a22 = psi_d * iy * iy + psi_g * (ixy ** 2 + iyy ** 2)
            b1 = -(psi_d * ix * it + psi_g * (ixx * itx + iyx * ity))
            b2 = -(psi_d * iy * it + psi_g * (ixy * itx + iyy * ity))

            for phase in (red, ~red):
                ngh_w = np.zeros((h, w))
                su = np.zeros((h, w))
                sv = np.zeros((h, w))
                for dy_, dx_ in ((-1, 0), (1, 0), (0, -1), (0, 1)):
                    wgt = np.zeros((h, w))
                    nu = np.zeros((h, w))
                    nv = np.zeros((h, w))
                    ys0 = slice(max(dy_, 0), h + min(dy_, 0))
                    xs0 = slice(max(dx_, 0), w + min(dx_, 0))
                    yd = slice(max(-dy_, 0), h + min(-dy_, 0))
                    xd = slice(max(-dx_, 0), w + min(-dx_, 0))
                    wgt[yd, xd] = psi_s[ys0, xs0] + psi_s[yd, xd]
                    nu[yd, xd] = (u + du)[ys0, xs0]
                    nv[yd, xd] = (v + dv)[ys0, xs0]
                    ngh_w += 0.5 * wgt
                    su += 0.5 * wgt * nu
                    sv += 0.5 * wgt * nv
                diag_u = a11 + ngh_w
                diag_v = a22 + ngh_w
                new_du = (b1 + su - ngh_w * u - a12 * dv) / diag_u
                new_dv = (b2 + sv - ngh_w * v - a12 * new_du) / diag_v
                du = np.where(phase, (1 - OMEGA) * du + OMEGA * new_du,
                              du)
                dv = np.where(phase, (1 - OMEGA) * dv + OMEGA * new_dv,
                              dv)
        u = u + du
        v = v + dv
    return np.stack([u, v], axis=-1)


def _warp_t(img, u, v):
    h, w = img.shape
    dev = img.device
    xs = torch.arange(w, device=dev)[None, :]
    ys = torch.arange(h, device=dev)[:, None]
    x = torch.clamp(xs + u, 0.0, w - 1.0)
    y = torch.clamp(ys + v, 0.0, h - 1.0)
    x0 = torch.clamp(torch.floor(x).to(torch.int64), 0, w - 2)
    y0 = torch.clamp(torch.floor(y).to(torch.int64), 0, h - 2)
    fx = x - x0
    fy = y - y0
    a = img[y0, x0]
    b = img[y0, x0 + 1]
    c = img[y0 + 1, x0]
    d = img[y0 + 1, x0 + 1]
    return (a * (1 - fx) * (1 - fy) + b * fx * (1 - fy)
            + c * (1 - fx) * fy + d * fx * fy)


def _cgrad_t(img):
    gx = torch.zeros_like(img)
    gy = torch.zeros_like(img)
    gx[:, 1:-1] = 0.5 * (img[:, 2:] - img[:, :-2])
    gy[1:-1, :] = 0.5 * (img[2:, :] - img[:-2, :])
    return gx, gy


def _shift(a: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[y, x] = a[y+dy, x+dx], zero outside."""
    h, w = a.shape
    out = torch.zeros_like(a)
    out[max(-dy, 0):h + min(-dy, 0), max(-dx, 0):w + min(-dx, 0)] = \
        a[max(dy, 0):h + min(dy, 0), max(dx, 0):w + min(dx, 0)]
    return out


def variational_refine(i0: torch.Tensor, i1: torch.Tensor, flow,
                       alpha: float = 20.0, delta: float = 5.0,
                       gamma: float = 10.0,
                       fixed_point_iterations: int = 5,
                       sor_iterations: int = 5) -> torch.Tensor:
    """Flow (H, W, 2) refined against u8 frames (same spec, float32), on
    i0's device (numpy frames go to the card)."""
    i0 = as_tensor(i0)
    dev = i0.device
    scale = torch.tensor(255.0, device=dev)
    f0 = i0.to(torch.float32) / scale
    f1 = as_tensor(i1, dev).to(torch.float32) / scale
    flow = as_tensor(flow, dev)
    u = flow[..., 0].to(torch.float32)
    v = flow[..., 1].to(torch.float32)
    h, w = f0.shape
    g0x, g0y = _cgrad_t(f0)
    yy = torch.arange(h, device=dev)[:, None]
    xx = torch.arange(w, device=dev)[None, :]
    red = ((yy + xx) % 2) == 0
    inside = {d: _shift(torch.ones((h, w), dtype=torch.float32, device=dev), *d)
              for d in ((-1, 0), (1, 0), (0, -1), (0, 1))}

    for _ in range(fixed_point_iterations):
        wrp = _warp_t(f1, u, v)
        w1x, w1y = _cgrad_t(wrp)
        ix = 0.5 * (g0x + w1x)
        iy = 0.5 * (g0y + w1y)
        it = wrp - f0
        ixx, ixy = _cgrad_t(ix)
        iyx, iyy = _cgrad_t(iy)
        itx = w1x - g0x
        ity = w1y - g0y

        du = torch.zeros_like(u)
        dv = torch.zeros_like(u)
        for _ in range(sor_iterations):
            r = it + ix * du + iy * dv
            rgx = itx + ixx * du + ixy * dv
            rgy = ity + iyx * du + iyy * dv
            psi_d = delta / torch.sqrt(r * r + EPS2)
            psi_g = gamma / torch.sqrt(rgx * rgx + rgy * rgy + EPS2)
            ugx, ugy = _cgrad_t(u + du)
            vgx, vgy = _cgrad_t(v + dv)
            psi_s = alpha / torch.sqrt(ugx ** 2 + ugy ** 2 + vgx ** 2
                                       + vgy ** 2 + EPS2)
            a11 = psi_d * ix * ix + psi_g * (ixx ** 2 + iyx ** 2)
            a12 = psi_d * ix * iy + psi_g * (ixx * ixy + iyx * iyy)
            a22 = psi_d * iy * iy + psi_g * (ixy ** 2 + iyy ** 2)
            b1 = -(psi_d * ix * it + psi_g * (ixx * itx + iyx * ity))
            b2 = -(psi_d * iy * it + psi_g * (ixy * itx + iyy * ity))
            for phase in (red, ~red):
                ngh_w = torch.zeros_like(u)
                su = torch.zeros_like(u)
                sv = torch.zeros_like(u)
                for d in ((-1, 0), (1, 0), (0, -1), (0, 1)):
                    wgt = (_shift(psi_s, *d) + psi_s) * inside[d]
                    ngh_w = ngh_w + 0.5 * wgt
                    su = su + 0.5 * wgt * _shift(u + du, *d)
                    sv = sv + 0.5 * wgt * _shift(v + dv, *d)
                new_du = (b1 + su - ngh_w * u - a12 * dv) / (a11 + ngh_w)
                new_dv = (b2 + sv - ngh_w * v - a12 * new_du) / (a22 + ngh_w)
                du = torch.where(phase, (1 - OMEGA) * du + OMEGA * new_du, du)
                dv = torch.where(phase, (1 - OMEGA) * dv + OMEGA * new_dv, dv)
        u = u + du
        v = v + dv
    return torch.stack([u, v], dim=-1)
