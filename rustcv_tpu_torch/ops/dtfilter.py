"""Domain-transform edge-preserving filtering (port of
``rustcv_tpu.ops.dtfilter``) and the OpenCV photo ops
built on it (``edgePreservingFilter`` / ``detailEnhance`` /
``stylization`` / ``pencilSketch`` roles; Gastal & Oliveira 2011, the
recursive RF filter OpenCV's photo module uses).

The reference's device twin runs the recursive filter as a ``lax.scan``
along the scan axis. The recursion is first-order linear
(``y ← a + w·y``), so the port's twin (:func:`dt_filter`) runs it as a
Hillis–Steele doubling scan of the affine maps on the image's device:
⌈log₂ n⌉ rounds per pass, and another float32 rounding order (the bar is
±1 LSB against the float64 oracle, ±2 for the derived ops). Per
iteration: horizontal left→right, right→left, then the vertical pair; the
per-pixel feedback weight ``a^d`` is precomputed elementwise.

Frozen spec (float64 oracle :func:`dt_filter_numpy`):
- domain derivative along an axis:
  ``d(x) = 1 + (σ_s/σ_r)·Σ_c |I_c(x) − I_c(x−1)|`` on [0,1] floats of
  the GUIDE image (first column d = ∞ ⇒ weight 0);
- ``N = 3`` iterations; at iteration i (0-based):
  ``σ_H(i) = σ_s·√3·2^(N−i−1)/√(4^N − 1)``, ``a = exp(−√2/σ_H)``,
  feedback weight ``w = a^d``;
- recursion ``J(x) = (1 − w(x))·J(x) + w(x)·J(x−1)`` applied L→R then
  R→L (on the result), then the same pair vertically — per iteration;
- derived ops (documented divergence from OpenCV's exact recipes; the
  API roles and qualitative behavior match):
  ``edge_preserving_filter`` = the filter itself (σ_s 60, σ_r 0.4);
  ``detail_enhance`` = base + 3·(src − base) (σ_s 10, σ_r 0.15);
  ``stylization`` = filtered image darkened by its own edge magnitude
  (σ_s 60, σ_r 0.45; edge term = clip(1 − 4·‖∇base‖, 0.25, 1));
  ``pencil_sketch`` = dodge of luma by its DT-smoothed base
  (``255·min(g/(b+1), 1)²``, σ_s 60, σ_r 2.0 — the LARGE σ_r makes the
  base blur across edges, which is what draws the stroke on the dark
  side), color variant = sketch × (src blended toward white by
  ``shade_factor``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .filters import _replicate_pad
from .tensors import as_tensor

_N_ITERS = 3


def _sigma_h(sigma_s: float, i: int) -> float:
    return sigma_s * np.sqrt(3.0) * (2.0 ** (_N_ITERS - i - 1)) \
        / np.sqrt(4.0 ** _N_ITERS - 1.0)


# ---------------------------------------------------------------------------
# oracle
# ---------------------------------------------------------------------------

def _domain_d(guide: np.ndarray, sigma_s: float, sigma_r: float,
              axis: int) -> np.ndarray:
    g = guide
    diff = np.abs(np.diff(g, axis=axis)).sum(axis=-1)
    pad = [(0, 0), (0, 0)]
    pad[axis] = (1, 0)
    d = 1.0 + (sigma_s / sigma_r) * np.pad(diff, pad)
    # first sample has no predecessor: infinite domain distance
    idx = [slice(None)] * 2
    idx[axis] = 0
    d[tuple(idx)] = np.inf
    return d


def _rf_pass_np(img: np.ndarray, w: np.ndarray, axis: int) -> np.ndarray:
    """One L→R + R→L recursive pair along ``axis`` (w = a^d)."""
    out = img.copy()
    n = img.shape[axis]
    sl = lambda i: tuple(
        [slice(None)] * axis + [i] + [slice(None)] * (img.ndim - axis - 1))
    wsl = lambda i: tuple(
        [slice(None)] * axis + [i] + [slice(None)] * (2 - axis - 1))
    for x in range(1, n):
        ww = w[wsl(x)][..., None]
        out[sl(x)] = (1 - ww) * out[sl(x)] + ww * out[sl(x - 1)]
    for x in range(n - 2, -1, -1):
        ww = w[wsl(x + 1)][..., None]
        out[sl(x)] = (1 - ww) * out[sl(x)] + ww * out[sl(x + 1)]
    return out


def dt_filter_numpy(guide: np.ndarray, src: np.ndarray,
                    sigma_s: float = 60.0,
                    sigma_r: float = 0.4) -> np.ndarray:
    """Oracle — guide/src u8 (H, W, C) → filtered float64 [0,1]·255 u8."""
    g = np.asarray(guide, np.float64) / 255.0
    j = np.asarray(src, np.float64) / 255.0
    dh = _domain_d(g, sigma_s, sigma_r, 1)
    dv = _domain_d(g, sigma_s, sigma_r, 0)
    for i in range(_N_ITERS):
        a = np.exp(-np.sqrt(2.0) / _sigma_h(sigma_s, i))
        wh = np.where(np.isinf(dh), 0.0, a ** np.minimum(dh, 700))
        wv = np.where(np.isinf(dv), 0.0, a ** np.minimum(dv, 700))
        j = _rf_pass_np(j, wh, 1)
        j = _rf_pass_np(j, wv, 0)
    return np.clip(np.floor(j * 255.0 + 0.5), 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# device twin
# ---------------------------------------------------------------------------

def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` as the float32 reciprocal multiply that XLA makes of a
    division by a constant: the same bits on the CPU and on the card (a
    CUDA division by a host scalar is a reciprocal multiply, a CPU one a
    true division)."""
    return x * float(np.float32(1.0 / c))


def _csum(x: torch.Tensor) -> torch.Tensor:
    """Σ over a trailing axis of 3 channels, left to right (a reduction's
    order differs between devices)."""
    return (x[..., 0] + x[..., 1]) + x[..., 2]


def _exp(x: torch.Tensor) -> torch.Tensor:
    """float32 ``exp`` through float64 (one rounding: the same bits on the
    CPU and on the card)."""
    return torch.exp(x.to(torch.float64)).to(torch.float32)


def _affine_scan(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive scan of ``y[i] = a[i] + b[i]·y[i−1]`` along ``dim``
    (``b[0] = 0``): Hillis–Steele doubling over the affine maps, each round
    composing every map with the one 2^r before it, ⌈log₂ n⌉ rounds."""
    n = a.shape[dim]
    d = 1
    while d < n:
        a_new = a.narrow(dim, d, n - d) + b.narrow(dim, d, n - d) * a.narrow(dim, 0, n - d)
        a = torch.cat([a.narrow(dim, 0, d), a_new], dim)
        if 2 * d < n:
            b_new = b.narrow(dim, d, n - d) * b.narrow(dim, 0, n - d)
            b = torch.cat([b.narrow(dim, 0, d), b_new], dim)
        d *= 2
    return a


def _rf_pass(img: torch.Tensor, w: torch.Tensor, axis: int) -> torch.Tensor:
    """The oracle's recursive pair along ``axis`` of ``img [H, W, C]``
    (``w [H, W]``, zero at index 0): L→R ``J(x) = (1 − w(x))·J(x) +
    w(x)·J(x−1)``, then R→L on the result with ``w(x+1)``."""
    n = img.shape[axis]
    wf = w[..., None]
    f = _affine_scan((1 - wf) * img, wf, axis)
    zero = torch.zeros_like(wf.narrow(axis, 0, 1))
    wb = torch.flip(torch.cat([wf.narrow(axis, 1, n - 1), zero], axis), [axis])
    fr = torch.flip(f, [axis])
    return torch.flip(_affine_scan((1 - wb) * fr, wb, axis), [axis])


def dt_filter(guide, src, sigma_s: float = 60.0, sigma_r: float = 0.4) -> torch.Tensor:
    """Device twin (float32; ±1 LSB vs the oracle): guide/src u8 (H, W, C)
    on their device (numpy goes to the card). The recursion is a doubling
    scan (:func:`_affine_scan`), not the reference's ``lax.scan`` over
    columns and rows: log₂ W + log₂ H rounds per pass instead of W + H
    steps, with float32 rounding in another order."""
    gt = as_tensor(guide)
    g = _div(gt.to(torch.float32), 255.0)
    j = _div(as_tensor(src, gt.device).to(torch.float32), 255.0)
    ratio = sigma_s / sigma_r
    dh = 1.0 + ratio * F.pad(_csum(torch.abs(torch.diff(g, dim=1))), (1, 0, 0, 0))
    dv = 1.0 + ratio * F.pad(_csum(torch.abs(torch.diff(g, dim=0))), (0, 0, 1, 0))
    first_h = (torch.arange(g.shape[1], device=g.device) == 0)[None, :]
    first_v = (torch.arange(g.shape[0], device=g.device) == 0)[:, None]
    for i in range(_N_ITERS):
        log_a = float(np.float32(np.log(np.exp(-np.sqrt(2.0) / _sigma_h(sigma_s, i)))))
        wh = torch.where(first_h, 0.0, _exp(torch.clamp(dh, max=700) * log_a))
        wv = torch.where(first_v, 0.0, _exp(torch.clamp(dv, max=700) * log_a))
        j = _rf_pass(j, wh, 1)
        j = _rf_pass(j, wv, 0)
    return torch.clamp(torch.floor(j * 255.0 + 0.5), 0, 255).to(torch.uint8)


# ---------------------------------------------------------------------------
# derived photo ops (work on numpy arrays or tensors)
# ---------------------------------------------------------------------------

def _filt(img, sigma_s, sigma_r):
    if isinstance(img, np.ndarray):
        return dt_filter_numpy(img, img, sigma_s, sigma_r)
    return dt_filter(img, img, sigma_s, sigma_r)


def _u8(x):
    if isinstance(x, np.ndarray):
        return np.clip(np.floor(x + 0.5), 0, 255).astype(np.uint8)
    return torch.clamp(torch.floor(x + 0.5), 0, 255).to(torch.uint8)


def _f32(x):
    return x.astype(np.float32) if isinstance(x, np.ndarray) else x.to(torch.float32)


def edge_preserving_filter(img, sigma_s: float = 60.0,
                           sigma_r: float = 0.4):
    """OpenCV ``edgePreservingFilter`` (RECURS_FILTER) role."""
    return _filt(img, sigma_s, sigma_r)


def _unit(x):
    """x / 255: numpy divides, a tensor takes :func:`_div`."""
    return x / 255.0 if isinstance(x, np.ndarray) else _div(x, 255.0)


def _mean3(x):
    """The channel mean: numpy's, or :func:`_csum` × 1/3 on a tensor."""
    return x.mean(-1) if isinstance(x, np.ndarray) else _div(_csum(x), 3.0)


def detail_enhance(img, sigma_s: float = 10.0, sigma_r: float = 0.15):
    """OpenCV ``detailEnhance`` role: base + 3·detail."""
    base = _f32(_filt(img, sigma_s, sigma_r))
    return _u8(base + 3.0 * (_f32(img) - base))


def _edge_term(gray):
    """clip(1 − 4·‖∇gray‖, 0.25, 1), backward differences (0 on the
    first row and column)."""
    if isinstance(gray, np.ndarray):
        pad_y = np.pad(gray, ((1, 0), (0, 0)), mode="edge")
        pad_x = np.pad(gray, ((0, 0), (1, 0)), mode="edge")
        gy = gray - pad_y[:-1]
        gx = gray - pad_x[:, :-1]
        return np.clip(1.0 - 4.0 * np.sqrt(gx * gx + gy * gy), 0.25, 1.0)
    gy = gray - torch.cat([gray[:1], gray[:-1]], 0)
    gx = gray - torch.cat([gray[:, :1], gray[:, :-1]], 1)
    return torch.clamp(1.0 - 4.0 * torch.sqrt(gx * gx + gy * gy), 0.25, 1.0)


def stylization(img, sigma_s: float = 60.0, sigma_r: float = 0.45):
    """OpenCV ``stylization`` role: flat regions + darkened edges."""
    base = _unit(_f32(_filt(img, sigma_s, sigma_r)))
    edge = _edge_term(_mean3(base))
    return _u8(base * edge[..., None] * 255.0)


def pencil_sketch(img, sigma_s: float = 60.0, sigma_r: float = 2.0,
                  shade_factor: float = 0.05):
    """OpenCV ``pencilSketch`` role → (gray sketch u8 (H, W), color
    pencil u8 (H, W, C))."""
    src = _f32(img)
    gray = _mean3(src)
    if isinstance(img, np.ndarray):
        gimg = np.stack([gray, gray, gray], axis=-1).astype(np.uint8)
        base = _filt(gimg, sigma_s, sigma_r).astype(np.float32)[..., 0]
        ratio = np.minimum(gray / (base + 1.0), 1.0)
        sketch = np.clip(np.floor(255.0 * ratio * ratio + 0.5), 0, 255)
    else:
        gimg = torch.stack([gray, gray, gray], dim=-1).to(torch.uint8)
        base = _filt(gimg, sigma_s, sigma_r).to(torch.float32)[..., 0]
        ratio = torch.clamp(gray / (base + 1.0), max=1.0)
        sketch = torch.clamp(torch.floor(255.0 * ratio * ratio + 0.5), 0, 255)
    # color pencil: sketch shading modulating the source colors
    color = _u8(_unit(sketch[..., None])
                * (src * (1 - shade_factor) + 255.0 * shade_factor))
    return _u8(sketch), color


# ---------------------------------------------------------------------------
# Guided filter (He et al. 2010; OpenCV ximgproc.guidedFilter role)
# ---------------------------------------------------------------------------
# Frozen spec (f64 oracle): gray guide I, filter input p (any channels),
# box means of radius r (replicate border):
#   a = cov(I, p) / (var(I) + eps),  b = mean(p) − a·mean(I)
#   q = mean(a)·I + mean(b)
# Output dtype follows the input (u8 rounds half-up). Pure box filters +
# elementwise.

def _box_mean(a, r):
    """The reference's replicate-bordered (2r+1)² box mean over the first
    two axes: float64 numpy, or float32 on a tensor's device (÷ n as the
    float32 reciprocal multiply that XLA makes of it). Its column pass
    runs over the already column-padded row sums, so the column window of
    x spans columns x − 2r … x (the frozen spec, kept as it is)."""
    n = 2 * r + 1
    if isinstance(a, np.ndarray):
        pad = [(r, r), (r, r)] + [(0, 0)] * (a.ndim - 2)
        p = np.pad(a, pad, mode="edge")
        out = sum(p[k:k + a.shape[0]] for k in range(n)) / n
        p2 = np.pad(out, [(0, 0), (r, r)] + [(0, 0)] * (a.ndim - 2), mode="edge")
        return sum(p2[:, k:k + a.shape[1]] for k in range(n)) / n
    inv = float(np.float32(1.0 / n))
    h, w = a.shape[:2]
    # the reference's padding exactly: rows and columns first, the row sums
    # keep the padded columns, then the columns are padded once more
    p = _replicate_pad(_replicate_pad(a, 0, r), 1, r)
    out = p[0:h]
    for k in range(1, n):
        out = out + p[k:k + h]
    p2 = _replicate_pad(out * inv, 1, r)
    acc = p2[:, 0:w]
    for k in range(1, n):
        acc = acc + p2[:, k:k + w]
    return acc * inv


def guided_filter(guide, src, radius: int = 8, eps: float = 1e-3):
    """Edge-preserving smoothing of ``src`` steered by gray ``guide``
    (both u8 or float; u8 scales to [0,1]). Works on numpy (f64 oracle)
    or tensors (float32 on the guide's device)."""
    if isinstance(guide, np.ndarray):
        g = guide.astype(np.float64)
        p = src.astype(np.float64)
        to_u8 = lambda q: np.clip(np.floor(q * 255.0 + 0.5), 0, 255).astype(np.uint8)  # noqa: E731
    else:
        g = guide.to(torch.float32)
        p = as_tensor(src, guide.device).to(torch.float32)
        to_u8 = lambda q: torch.clamp(torch.floor(q * 255.0 + 0.5), 0, 255).to(torch.uint8)  # noqa: E731
    was_u8 = src.dtype in (np.uint8, torch.uint8)
    if guide.dtype in (np.uint8, torch.uint8):
        g = _unit(g)
    if was_u8:
        p = _unit(p)
    gg = g[..., None] if p.ndim == 3 else g
    mean_i = _box_mean(g, radius)
    mean_p = _box_mean(p, radius)
    mean_ip = _box_mean(gg * p, radius)
    mean_ii = _box_mean(g * g, radius)
    var_i = mean_ii - mean_i * mean_i
    mi = mean_i[..., None] if p.ndim == 3 else mean_i
    vi = var_i[..., None] if p.ndim == 3 else var_i
    a = (mean_ip - mi * mean_p) / (vi + eps)
    b = mean_p - a * mi
    q = _box_mean(a, radius) * gg + _box_mean(b, radius)
    return to_u8(q) if was_u8 else q
