"""Dense optical flow via polynomial expansion (port of
``rustcv_tpu.ops.farneback``; Farnebäck 2003, the OpenCV
``calcOpticalFlowFarneback`` role).

Every stage is dense elementwise or separable-correlation work on the
tensor's device. The polynomial expansion is six separable Gaussian-basis
correlations (shifted views) followed by the constant 6x6 normal-equation
inverse applied as per-pixel linear combinations: a weighted sum of
planes with float64-built coefficients, so no matmul, and no TF32 on the
card. The window aggregation is a separable box filter; the 2x2 solve is
closed-form elementwise. The only gather is the bilinear sampling of the
second image's five coefficient planes at flow-displaced positions, all
five sharing one set of indices and weights. Pyramid levels are
half-resolution (frozen pyr_scale = 0.5): the decimation is a strided
view.

Frozen spec (ours; float32 device == float64 oracle within tolerance):
- applicability w(t) = exp(-t^2 / (2*poly_sigma^2)), t in [-n, n], no
  normalization (it cancels in the normal equations); basis
  {1, x, y, x^2, y^2, xy}; correlations use replicate border;
- f(p) ~ c + b.p + p'Ap with A = [[axx, axy/2], [axy/2, ayy]]; dual
  coefficients are G^{-1} @ projections, G[i,j] = sum w(x)w(y) phi_i phi_j
  (computed and inverted in float64 on host — a compile-time constant);
- update: sample plane set of image 2 at q = clip(p + flow, borders)
  bilinearly; A~ = (A1 + A2(q))/2, rhs = -0.5*(b2(q) - b1) + A~ @ flow;
  accumulate M = sum_box(A~'A~), v = sum_box(A~' rhs) over
  winsize x winsize (uniform box, replicate border); flow' = M^{-1} v
  where det(M) > 1e-9, else the prior flow;
- pyramid: 5-tap [1,4,6,4,1]/16 separable smooth + ::2 decimation
  (float); flow upsampled by pixel duplication x2 and scaled x2; levels
  clamped so the coarsest level is at least max(winsize, 2*poly_n+1) on
  both sides.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from .filters import _taps


@lru_cache(maxsize=None)
def _poly_inv(n: int, sigma: float) -> Tuple[Tuple[float, ...], np.ndarray]:
    """Gaussian applicability taps and the 6x6 normal-equation inverse.

    Returns (g taps as python floats, G^{-1} float64 [6, 6]). Basis order:
    1, x, y, x^2, y^2, xy (x = column offset, y = row offset)."""
    t = np.arange(-n, n + 1, dtype=np.float64)
    g = np.exp(-(t * t) / (2.0 * sigma * sigma))
    xx, yy = np.meshgrid(t, t)  # [2n+1, 2n+1]
    w = np.outer(g, g)
    basis = np.stack([
        np.ones_like(xx), xx, yy, xx * xx, yy * yy, xx * yy,
    ]).reshape(6, -1)
    G = (basis * w.reshape(1, -1)) @ basis.T
    return tuple(float(v) for v in g), np.linalg.inv(G)


def _sep(f: torch.Tensor, kx, ky, n: int) -> torch.Tensor:
    """Separable correlation with replicate border (float)."""
    return _taps(_taps(f, f.ndim - 1, kx, n), f.ndim - 2, ky, n)


def _poly_exp(f: torch.Tensor, n: int, sigma: float) -> torch.Tensor:
    """float32 plane (H, W) -> [5, H, W]: bx, by, axx, ayy, axy."""
    g, ginv = _poly_inv(n, sigma)
    t = np.arange(-n, n + 1, dtype=np.float64)
    gx = tuple(float(v) for v in np.asarray(g) * t)
    gxx = tuple(float(v) for v in np.asarray(g) * t * t)
    p = (
        _sep(f, g, g, n),      # <w f, 1>
        _sep(f, gx, g, n),     # <w f, x>
        _sep(f, g, gx, n),     # <w f, y>
        _sep(f, gxx, g, n),    # <w f, x^2>
        _sep(f, g, gxx, n),    # <w f, y^2>
        _sep(f, gx, gx, n),    # <w f, xy>
    )
    inv = ginv[1:].astype(np.float32)  # drop the constant row
    return torch.stack([sum(float(inv[c, k]) * p[k] for k in range(6)) for c in range(5)])


def _box(a: torch.Tensor, win: int) -> torch.Tensor:
    r = win // 2
    ones = (1.0,) * (2 * r + 1)
    return _taps(_taps(a, a.ndim - 1, ones, r), a.ndim - 2, ones, r)


def _sample_planes(planes: torch.Tensor, fx: torch.Tensor, fy: torch.Tensor) -> torch.Tensor:
    """Bilinear-sample [5, H, W] coefficient planes at (x + fx, y + fy),
    coordinates clamped to the image; one shared index set for all 5."""
    _, h, w = planes.shape
    dev = planes.device
    xg = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    yg = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    cx = torch.clamp(xg + fx, 0.0, w - 1.0)
    cy = torch.clamp(yg + fy, 0.0, h - 1.0)
    x0 = torch.clamp(torch.floor(cx).to(torch.int64), 0, w - 2)
    y0 = torch.clamp(torch.floor(cy).to(torch.int64), 0, h - 2)
    ax = cx - x0.to(torch.float32)
    ay = cy - y0.to(torch.float32)
    flat = planes.reshape(5, h * w)
    base = (y0 * w + x0).reshape(-1)

    def take(off):
        return flat[:, base + off].reshape(5, h, w)

    w00 = ((1 - ax) * (1 - ay))[None]
    w01 = (ax * (1 - ay))[None]
    w10 = ((1 - ax) * ay)[None]
    w11 = (ax * ay)[None]
    return (take(0) * w00 + take(1) * w01 +
            take(w) * w10 + take(w + 1) * w11)


def _flow_iter(p1: torch.Tensor, p2: torch.Tensor, fx: torch.Tensor, fy: torch.Tensor,
               win: int) -> Tuple[torch.Tensor, torch.Tensor]:
    s = _sample_planes(p2, fx, fy)
    a11 = 0.5 * (p1[2] + s[2])
    a22 = 0.5 * (p1[3] + s[3])
    a12 = 0.25 * (p1[4] + s[4])  # off-diagonal = axy/2, averaged
    r1 = -0.5 * (s[0] - p1[0]) + a11 * fx + a12 * fy
    r2 = -0.5 * (s[1] - p1[1]) + a12 * fx + a22 * fy
    g11 = _box(a11 * a11 + a12 * a12, win)
    g12 = _box(a12 * (a11 + a22), win)
    g22 = _box(a22 * a22 + a12 * a12, win)
    h1 = _box(a11 * r1 + a12 * r2, win)
    h2 = _box(a12 * r1 + a22 * r2, win)
    det = g11 * g22 - g12 * g12
    ok = torch.abs(det) > 1e-9
    inv = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    nfx = (g22 * h1 - g12 * h2) * inv
    nfy = (g11 * h2 - g12 * h1) * inv
    return torch.where(ok, nfx, fx), torch.where(ok, nfy, fy)


def _down(f: torch.Tensor) -> torch.Tensor:
    k = (1.0 / 16, 4.0 / 16, 6.0 / 16, 4.0 / 16, 1.0 / 16)
    return _sep(f, k, k, 2)[::2, ::2]


def _upsample(f: torch.Tensor, lh: int, lw: int) -> torch.Tensor:
    """×2 pixel duplication, values ×2, cut or edge-extended to (lh, lw)."""
    up = (2.0 * f.repeat_interleave(2, 0).repeat_interleave(2, 1))[:lh, :lw]
    if up.shape != (lh, lw):  # odd parent dims: replicate last row/col
        ys = torch.arange(lh, device=f.device).clamp(max=up.shape[0] - 1)
        xs = torch.arange(lw, device=f.device).clamp(max=up.shape[1] - 1)
        up = up[ys[:, None], xs[None, :]]
    return up


def _levels_for(h: int, w: int, levels: int, win: int, n: int) -> int:
    floor = max(win, 2 * n + 1)
    lv = 1
    while lv < levels and min(h, w) // (1 << lv) >= floor:
        lv += 1
    return lv


def farneback_flow(
    prev: torch.Tensor,
    next: torch.Tensor,
    levels: int = 3,
    winsize: int = 13,
    iterations: int = 3,
    poly_n: int = 5,
    poly_sigma: float = 1.1,
) -> torch.Tensor:
    """u8 gray pair (H, W) -> dense flow float32 (H, W, 2) [fx, fy]
    mapping prev -> next (prev(p) ~ next(p + flow(p))), on prev's device."""
    h, w = prev.shape
    lv = _levels_for(h, w, levels, winsize, poly_n)
    f1 = prev.to(torch.float32)
    f2 = next.to(device=prev.device, dtype=torch.float32)
    pyr = [(f1, f2)]
    for _ in range(lv - 1):
        f1, f2 = _down(f1), _down(f2)
        pyr.append((f1, f2))
    fx = fy = None
    for f1, f2 in reversed(pyr):
        lh, lw = f1.shape
        if fx is None:
            fx = torch.zeros_like(f1)
            fy = torch.zeros_like(f1)
        else:
            fx, fy = _upsample(fx, lh, lw), _upsample(fy, lh, lw)
        p1 = _poly_exp(f1, poly_n, poly_sigma)
        p2 = _poly_exp(f2, poly_n, poly_sigma)
        for _ in range(iterations):
            fx, fy = _flow_iter(p1, p2, fx, fy, winsize)
    return torch.stack([fx, fy], dim=-1)


# ---------------------------------------------------------------- oracle

def _poly_exp_np(f: np.ndarray, n: int, sigma: float) -> np.ndarray:
    g, ginv = _poly_inv(n, sigma)
    t = np.arange(-n, n + 1, dtype=np.float64)
    g = np.asarray(g)
    kern = {"g": g, "gx": g * t, "gxx": g * t * t}

    def corr(a, kx, ky):
        h, w = a.shape
        p = np.pad(a, n, mode="edge")
        acc = np.zeros((h, w))
        for dy in range(2 * n + 1):
            for dx in range(2 * n + 1):
                acc += ky[dy] * kx[dx] * p[dy:dy + h, dx:dx + w]
        return acc

    p = np.stack([
        corr(f, kern["g"], kern["g"]), corr(f, kern["gx"], kern["g"]),
        corr(f, kern["g"], kern["gx"]), corr(f, kern["gxx"], kern["g"]),
        corr(f, kern["g"], kern["gxx"]), corr(f, kern["gx"], kern["gx"]),
    ])
    return np.einsum("cp,phw->chw", ginv[1:], p.reshape(6, *f.shape))


def _box_np(a: np.ndarray, win: int) -> np.ndarray:
    r = win // 2
    h, w = a.shape
    p = np.pad(a, r, mode="edge")
    acc = np.zeros((h, w))
    for dy in range(2 * r + 1):
        for dx in range(2 * r + 1):
            acc += p[dy:dy + h, dx:dx + w]
    return acc


def farneback_flow_numpy(
    prev: np.ndarray,
    next: np.ndarray,
    levels: int = 3,
    winsize: int = 13,
    iterations: int = 3,
    poly_n: int = 5,
    poly_sigma: float = 1.1,
) -> np.ndarray:
    """Oracle — same frozen spec in float64."""
    h, w = prev.shape
    lv = _levels_for(h, w, levels, winsize, poly_n)
    k = np.array([1, 4, 6, 4, 1], np.float64) / 16.0

    def down(f):
        hh, ww = f.shape
        p = np.pad(f, 2, mode="edge")
        acc = np.zeros((hh, ww))
        for dy in range(5):
            for dx in range(5):
                acc += k[dy] * k[dx] * p[dy:dy + hh, dx:dx + ww]
        return acc[::2, ::2]

    pyr = [(prev.astype(np.float64), next.astype(np.float64))]
    for _ in range(lv - 1):
        pyr.append((down(pyr[-1][0]), down(pyr[-1][1])))
    fx = fy = None
    for f1, f2 in reversed(pyr):
        lh, lw = f1.shape
        if fx is None:
            fx = np.zeros((lh, lw))
            fy = np.zeros((lh, lw))
        else:
            fx = (2.0 * np.repeat(np.repeat(fx, 2, 0), 2, 1))[:lh, :lw]
            fy = (2.0 * np.repeat(np.repeat(fy, 2, 0), 2, 1))[:lh, :lw]
            py, px = lh - fx.shape[0], lw - fx.shape[1]
            if py or px:
                fx = np.pad(fx, ((0, py), (0, px)), mode="edge")
                fy = np.pad(fy, ((0, py), (0, px)), mode="edge")
        p1 = _poly_exp_np(f1, poly_n, poly_sigma)
        p2 = _poly_exp_np(f2, poly_n, poly_sigma)
        for _ in range(iterations):
            xg, yg = np.meshgrid(np.arange(lw), np.arange(lh))
            cx = np.clip(xg + fx, 0.0, lw - 1.0)
            cy = np.clip(yg + fy, 0.0, lh - 1.0)
            x0 = np.clip(np.floor(cx).astype(np.int64), 0, lw - 2)
            y0 = np.clip(np.floor(cy).astype(np.int64), 0, lh - 2)
            ax, ay = cx - x0, cy - y0
            s = (p1 * 0.0)
            for c in range(5):
                pl = p2[c]
                s[c] = (pl[y0, x0] * (1 - ax) * (1 - ay)
                        + pl[y0, x0 + 1] * ax * (1 - ay)
                        + pl[y0 + 1, x0] * (1 - ax) * ay
                        + pl[y0 + 1, x0 + 1] * ax * ay)
            a11 = 0.5 * (p1[2] + s[2])
            a22 = 0.5 * (p1[3] + s[3])
            a12 = 0.25 * (p1[4] + s[4])
            r1 = -0.5 * (s[0] - p1[0]) + a11 * fx + a12 * fy
            r2 = -0.5 * (s[1] - p1[1]) + a12 * fx + a22 * fy
            g11 = _box_np(a11 * a11 + a12 * a12, winsize)
            g12 = _box_np(a12 * (a11 + a22), winsize)
            g22 = _box_np(a22 * a22 + a12 * a12, winsize)
            h1 = _box_np(a11 * r1 + a12 * r2, winsize)
            h2 = _box_np(a12 * r1 + a22 * r2, winsize)
            det = g11 * g22 - g12 * g12
            ok = np.abs(det) > 1e-9
            inv = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)
            fx = np.where(ok, (g22 * h1 - g12 * h2) * inv, fx)
            fy = np.where(ok, (g11 * h2 - g12 * h1) * inv, fy)
    return np.stack([fx, fy], axis=-1).astype(np.float32)
