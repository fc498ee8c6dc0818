"""DIS dense optical flow (port of ``rustcv_tpu.ops.disflow``; OpenCV
``DISOpticalFlow`` role, Kroeger et al. 2016: Dense Inverse Search).

On the tensor's device:
- Inverse search is per patch, and every pixel of a patch shares the
  patch's translation, so the warped-patch sample is one (8+1)² gather at
  the integer part (its origin clamped into an edge-padded I1, as the
  reference clamps it) lerped by the shared fraction. All patches of a
  level form one batch; the Gauss-Newton steps are a Python loop of
  batched ops (no host read), the inverse-compositional Hessian
  precomputed per patch.
- Densification samples I1 at per-pixel displaced coordinates (a
  per-pixel gather, like remap); each pixel blends the ≤4 covering
  patches' flows by inverse residual weight, accumulated with
  ``index_put_`` (the reference accumulates patch by patch: the float32
  sums differ in order only).

Frozen spec (float64 oracle :func:`dis_flow_numpy`):
- images → [0,1] floats; pyramid = 5-tap binomial blur + ``[::2]``
  decimation, coarsest level has min dim ≥ 16, processing stops at
  ``finest_scale`` (default 1 = half resolution; the last flow
  upsamples ×2 per remaining level with values ×2);
- per level: patches ``patch_size`` = 8 on a ``stride`` = 4 grid
  (grid positions clamped so patches stay inside); per patch
  ``iters`` = 8 inverse-compositional Gauss-Newton steps on
  ``Σ (I1(x+u) − I0(x))²`` with H from I0 central-difference
  gradients (+1e-6 diagonal), u clamped to ±patch_size drift from its
  init; out-of-image samples clamp (edge);
- densification: pixel flow = Σ_p w_p·u_p / Σ w_p over covering
  patches, ``w_p = 1 / max(1e-4, (I1(x+u_p) − I0(x))²)``;
- no variational refinement (OpenCV's is optional; documented
  divergence — compose with Farneback for smoothness-regularized
  fields).

Returns flow [H, W, 2] float32 (u = x-displacement, v = y) mapping
I0 → I1: ``I1(x + u(x)) ≈ I0(x)``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .filters import _replicate_pad

PATCH = 8
STRIDE = 4


def _blur_dec(a, xp):
    t = np.array([1, 4, 6, 4, 1], np.float64) / 16.0
    if xp is not np:
        t = t.astype(np.float32)
    p = xp.pad(a, ((0, 0), (2, 2)), mode="edge")
    out = sum(t[k] * p[:, k:k + a.shape[1]] for k in range(5))
    p = xp.pad(out, ((2, 2), (0, 0)), mode="edge")
    out = sum(t[k] * p[k:k + a.shape[0], :] for k in range(5))
    return out[::2, ::2]


def _grad(a, xp):
    p = xp.pad(a, 1, mode="edge")
    gx = (p[1:-1, 2:] - p[1:-1, :-2]) * 0.5
    gy = (p[2:, 1:-1] - p[:-2, 1:-1]) * 0.5
    return gx, gy


def _grid(h: int, w: int) -> Tuple[np.ndarray, np.ndarray]:
    ys = np.arange(0, max(h - PATCH, 0) + 1, STRIDE)
    xs = np.arange(0, max(w - PATCH, 0) + 1, STRIDE)
    if ys[-1] != h - PATCH:
        ys = np.append(ys, h - PATCH)
    if xs[-1] != w - PATCH:
        xs = np.append(xs, w - PATCH)
    return ys, xs


def _sample_patch_np(img, oy, ox):
    """8×8 bilinear window at float origin (edge clamp)."""
    h, w = img.shape
    y0 = int(np.floor(oy))
    x0 = int(np.floor(ox))
    fy = oy - y0
    fx = ox - x0

    def win(dy, dx):
        yy = np.clip(y0 + dy + np.arange(PATCH), 0, h - 1)
        xx = np.clip(x0 + dx + np.arange(PATCH), 0, w - 1)
        return img[np.ix_(yy, xx)]

    return (win(0, 0) * (1 - fy) * (1 - fx) + win(0, 1) * (1 - fy) * fx
            + win(1, 0) * fy * (1 - fx) + win(1, 1) * fy * fx)


def _bilinear_np(img, ys, xs):
    h, w = img.shape
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    fy = np.clip(ys - y0, 0.0, 1.0)
    fx = np.clip(xs - x0, 0.0, 1.0)
    return (img[y0, x0] * (1 - fy) * (1 - fx) + img[y0, x1] * (1 - fy) * fx
            + img[y1, x0] * fy * (1 - fx) + img[y1, x1] * fy * fx)


def _level_np(i0, i1, flow_init, iters):
    h, w = i0.shape
    gx, gy = _grad(i0, np)
    ys, xs = _grid(h, w)
    n_py, n_px = len(ys), len(xs)
    u = np.zeros((n_py, n_px, 2))
    for a, oy in enumerate(ys):
        for b, ox in enumerate(xs):
            p0 = i0[oy:oy + PATCH, ox:ox + PATCH]
            jx = gx[oy:oy + PATCH, ox:ox + PATCH]
            jy = gy[oy:oy + PATCH, ox:ox + PATCH]
            hxx = (jx * jx).sum() + 1e-6
            hyy = (jy * jy).sum() + 1e-6
            hxy = (jx * jy).sum()
            det = hxx * hyy - hxy * hxy
            cy, cx = oy + PATCH // 2, ox + PATCH // 2
            u0 = flow_init[cy, cx].copy()
            uv = u0.copy()
            for _ in range(iters):
                wp = _sample_patch_np(i1, oy + uv[1], ox + uv[0])
                r = wp - p0
                bx = (jx * r).sum()
                by = (jy * r).sum()
                du = np.array([(hyy * bx - hxy * by) / det,
                               (hxx * by - hxy * bx) / det])
                uv = uv - du
                drift = uv - u0
                uv = u0 + np.clip(drift, -PATCH, PATCH)
            u[a, b] = uv
    # densification
    ygrid, xgrid = np.mgrid[0:h, 0:w].astype(np.float64)
    num = np.zeros((h, w, 2))
    den = np.zeros((h, w))
    for a, oy in enumerate(ys):
        for b, ox in enumerate(xs):
            sl = np.s_[oy:oy + PATCH, ox:ox + PATCH]
            uv = u[a, b]
            samp = _bilinear_np(i1, ygrid[sl] + uv[1], xgrid[sl] + uv[0])
            wgt = 1.0 / np.maximum((samp - i0[sl]) ** 2, 1e-4)
            num[sl] += wgt[..., None] * uv
            den[sl] += wgt
    return num / den[..., None]


def dis_flow_numpy(img0: np.ndarray, img1: np.ndarray,
                   finest_scale: int = 1, iters: int = 8) -> np.ndarray:
    """Oracle — float64. u8 gray pair → flow float32 [H, W, 2]."""
    i0 = np.asarray(img0, np.float64) / 255.0
    i1 = np.asarray(img1, np.float64) / 255.0
    h, w = i0.shape
    p0s, p1s = [i0], [i1]
    while min(p0s[-1].shape) >= 32:
        p0s.append(_blur_dec(p0s[-1], np))
        p1s.append(_blur_dec(p1s[-1], np))
    flow = np.zeros(p0s[-1].shape + (2,))
    for lv in range(len(p0s) - 1, finest_scale - 1, -1):
        flow = _level_np(p0s[lv], p1s[lv], flow, iters)
        if lv > finest_scale:
            hh, ww = p0s[lv - 1].shape
            up = np.repeat(np.repeat(flow, 2, 0), 2, 1)[:hh, :ww] * 2.0
            flow = up
    for _ in range(finest_scale):
        hh = min(flow.shape[0] * 2, h)
        ww = min(flow.shape[1] * 2, w)
        flow = np.repeat(np.repeat(flow, 2, 0), 2, 1)[:h, :w] * 2.0
    return flow[:h, :w].astype(np.float32)


# ---------------------------------------------------------------------------
# tensors
# ---------------------------------------------------------------------------

def _edge_pad(a: torch.Tensor, r: int) -> torch.Tensor:
    return _replicate_pad(_replicate_pad(a, 0, r), 1, r)


def _blur_dec_t(a: torch.Tensor) -> torch.Tensor:
    t = (np.array([1, 4, 6, 4, 1], np.float64) / 16.0).astype(np.float32)
    h, w = a.shape
    p = _replicate_pad(a, 1, 2)
    out = sum(float(t[k]) * p[:, k:k + w] for k in range(5))
    p = _replicate_pad(out, 0, 2)
    out = sum(float(t[k]) * p[k:k + h, :] for k in range(5))
    return out[::2, ::2]


def _windows(a: torch.Tensor, oy: torch.Tensor, ox: torch.Tensor, size: int) -> torch.Tensor:
    """[P, size, size] windows of ``a`` at integer origins [P]."""
    span = torch.arange(size, device=a.device)
    return a[(oy[:, None] + span)[:, :, None], (ox[:, None] + span)[:, None, :]]


def _level_t(i0, i1, flow_init, iters):
    h, w = i0.shape
    dev = i0.device
    p = _edge_pad(i0, 1)
    gx = (p[1:-1, 2:] - p[1:-1, :-2]) * 0.5
    gy = (p[2:, 1:-1] - p[:-2, 1:-1]) * 0.5
    # I1 edge-padded so the shared-fraction sample reads replicate values
    # out of range, as the oracle's per-index clamp; the pad exceeds
    # init-flow + drift excursions.
    pad1 = 4 * PATCH
    i1p = _edge_pad(i1, pad1)
    ys, xs = _grid(h, w)
    oys, oxs = np.meshgrid(ys, xs, indexing="ij")
    oy = torch.as_tensor(oys.ravel(), dtype=torch.int64, device=dev)
    ox = torch.as_tensor(oxs.ravel(), dtype=torch.int64, device=dev)
    p0 = _windows(i0, oy, ox, PATCH)
    jx = _windows(gx, oy, ox, PATCH)
    jy = _windows(gy, oy, ox, PATCH)
    hxx = (jx * jx).sum(dim=(1, 2)) + 1e-6
    hyy = (jy * jy).sum(dim=(1, 2)) + 1e-6
    hxy = (jx * jy).sum(dim=(1, 2))
    det = hxx * hyy - hxy * hxy
    u0 = flow_init[oy + PATCH // 2, ox + PATCH // 2]
    oyf = oy.to(torch.float32)
    oxf = ox.to(torch.float32)

    def sample(uy, ux):
        fy0 = torch.floor(oyf + uy)
        fx0 = torch.floor(oxf + ux)
        iy = torch.clamp(fy0 + pad1, 0, h + 2 * pad1 - PATCH - 1).to(torch.int64)
        ix = torch.clamp(fx0 + pad1, 0, w + 2 * pad1 - PATCH - 1).to(torch.int64)
        fy = torch.clamp(oyf + uy - fy0, 0.0, 1.0)[:, None, None]
        fx = torch.clamp(oxf + ux - fx0, 0.0, 1.0)[:, None, None]
        big = _windows(i1p, iy, ix, PATCH + 1)
        return (big[:, :-1, :-1] * (1 - fy) * (1 - fx)
                + big[:, :-1, 1:] * (1 - fy) * fx
                + big[:, 1:, :-1] * fy * (1 - fx)
                + big[:, 1:, 1:] * fy * fx)

    uv = u0
    for _ in range(iters):
        r = sample(uv[:, 1], uv[:, 0]) - p0
        bx = (jx * r).sum(dim=(1, 2))
        by = (jy * r).sum(dim=(1, 2))
        du = torch.stack([(hyy * bx - hxy * by) / det,
                          (hxx * by - hxy * bx) / det], dim=-1)
        uv = u0 + torch.clamp(uv - du - u0, -PATCH, PATCH)

    # densification: per-pixel gathers of I1 at displaced coordinates
    span = torch.arange(PATCH, device=dev)
    yy = (oy[:, None] + span)[:, :, None].expand(-1, PATCH, PATCH)
    xx = (ox[:, None] + span)[:, None, :].expand(-1, PATCH, PATCH)
    sy = yy.to(torch.float32) + uv[:, 1, None, None]
    sx = xx.to(torch.float32) + uv[:, 0, None, None]
    y0 = torch.clamp(torch.floor(sy), 0, h - 1).to(torch.int64)
    x0 = torch.clamp(torch.floor(sx), 0, w - 1).to(torch.int64)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    fy = torch.clamp(sy - y0, 0.0, 1.0)
    fx = torch.clamp(sx - x0, 0.0, 1.0)
    samp = (i1[y0, x0] * (1 - fy) * (1 - fx) + i1[y0, x1] * (1 - fy) * fx
            + i1[y1, x0] * fy * (1 - fx) + i1[y1, x1] * fy * fx)
    wgt = 1.0 / torch.clamp((samp - p0) ** 2, min=1e-4)
    num = torch.zeros((h, w, 2), dtype=torch.float32, device=dev)
    den = torch.zeros((h, w), dtype=torch.float32, device=dev)
    num.index_put_((yy, xx), wgt[..., None] * uv[:, None, None, :], accumulate=True)
    den.index_put_((yy, xx), wgt, accumulate=True)
    return num / den[..., None]


def _upsample2(flow: torch.Tensor, hh: int, ww: int) -> torch.Tensor:
    return flow.repeat_interleave(2, 0).repeat_interleave(2, 1)[:hh, :ww] * 2.0


def dis_flow(img0: torch.Tensor, img1: torch.Tensor, finest_scale: int = 1,
             iters: int = 8) -> torch.Tensor:
    """u8 gray pair → flow float32 [H, W, 2] on img0's device; flows match
    the oracle to ~1e-2 px on well-conditioned scenes."""
    dev = img0.device
    i0 = img0.to(torch.float32) / torch.tensor(255.0, device=dev)
    i1 = img1.to(device=dev, dtype=torch.float32) / torch.tensor(255.0, device=dev)
    h, w = i0.shape
    p0s, p1s = [i0], [i1]
    while min(p0s[-1].shape) >= 32:
        p0s.append(_blur_dec_t(p0s[-1]))
        p1s.append(_blur_dec_t(p1s[-1]))
    flow = torch.zeros(p0s[-1].shape + (2,), dtype=torch.float32, device=dev)
    for lv in range(len(p0s) - 1, finest_scale - 1, -1):
        flow = _level_t(p0s[lv], p1s[lv], flow, iters)
        if lv > finest_scale:
            hh, ww = p0s[lv - 1].shape
            flow = _upsample2(flow, hh, ww)
    for _ in range(finest_scale):
        flow = _upsample2(flow, h, w)
    return flow[:h, :w]
