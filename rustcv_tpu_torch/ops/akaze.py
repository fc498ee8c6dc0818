"""AKAZE keypoints + descriptors (port of ``rustcv_tpu.ops.akaze``;
OpenCV ``AKAZE`` role — Alcantarilla et al. 2013, nonlinear scale space +
M-LDB binary descriptors).

Dense/sparse split:
- dense: the nonlinear scale space is Fast-Explicit-Diffusion, 4-neighbor
  stencil steps, elementwise on the device (:func:`build_scale_space`
  has a tensor twin :func:`build_scale_space_device`, float32 vs float64
  ≤ 1e-3); the contrast k is the oracle's host histogram;
- sparse: per-keypoint refinement, orientation and M-LDB sampling are
  host float64 (hundreds of points).

Frozen spec (float64, deterministic; divergences from OpenCV's AKAZE
documented inline):
- input u8 → [0, 1], base = Gaussian σ₀ = 1.6; contrast k = the 70th
  percentile of nonzero Scharr magnitudes of a σ = 1 pre-blur, over a
  300-bin histogram, k scaled ×0.75 per octave drop;
- evolution: ``n_octaves`` × ``n_sublevels`` levels,
  σ_global(i) = σ₀·2^(o + s/S); per octave the image halves
  ([::2, ::2]) and times are octave-local (σ_local = σ_global/2^o,
  t = σ²/2); each sublevel advances by one FED cycle with conductivity
  g₂ = 1/(1 + (|∇L|/k)²) FIXED over the cycle, explicit steps
  τ_j = τ_max/(2cos²(π(2j+1)/(4n+2))) rescaled to sum to the cycle
  time (τ_max = 0.25, n minimal with τ_max·(n²+n)/3 ≥ T); diffusion
  step = half-sum flux form with replicate borders;
- detector: R = σ_local⁴·(Lxx·Lyy − Lxy²), second derivatives =
  Scharr∘Scharr (divergence: OpenCV steps derivatives by round(σ));
  extrema: R > threshold, strictly greater than the 8 spatial
  neighbors, ≥ the same pixel's response at in-octave neighbor
  sublevels, 5-px border excluded; spatial 2-D quadratic sub-pixel
  refinement (divergence: no cross-scale refinement);
- orientation: SURF-style — Scharr gradient samples within radius
  6σ_local, Gaussian-weighted (σ = 2.5σ_local), strongest 60° sliding
  window of summed vectors (512 discrete window starts);
- descriptor: M-LDB 486 bits — grids 2×2, 3×3, 4×4 over a rotated
  patch of half-width 5σ_local; per cell the means of (L, dx', dy')
  (gradients rotated into the keypoint frame) sampled on a 4×4
  sub-grid per cell with bilinear taps; bit = mean_i(ch) > mean_j(ch)
  for every cell pair i < j and channel; packed little-endian into 61
  bytes (+3 zero pad → 64 for the Hamming matcher).

Keypoints return as float32 [N, 6]: (x, y, size, angle_deg, response,
class_id = evolution index) in ORIGINAL image coordinates (size =
2·σ_global); descriptors as u8 [N, 64].
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from .filters import _replicate_pad
from .tensors import full_f32

SIGMA0 = 1.6
TAU_MAX = 0.25
DEFAULT_THRESHOLD = 0.001
_PATTERN_R = 5.0      # descriptor half-width in σ_local units
_ORI_R = 6.0
_GRIDS = (2, 3, 4)


# ---------------------------------------------------------------------------
# dense stage: nonlinear scale space (oracle)
# ---------------------------------------------------------------------------

def _gauss_blur(img: np.ndarray, sigma: float) -> np.ndarray:
    if sigma <= 0:
        return img.copy()
    r = max(1, int(np.ceil(4.0 * sigma)))
    i = np.arange(-r, r + 1, dtype=np.float64)
    t = np.exp(-(i * i) / (2.0 * sigma * sigma))
    t /= t.sum()
    p = np.pad(img, ((0, 0), (r, r)), mode="edge")
    out = sum(t[k] * p[:, k:k + img.shape[1]] for k in range(len(t)))
    p = np.pad(out, ((r, r), (0, 0)), mode="edge")
    return sum(t[k] * p[k:k + img.shape[0], :] for k in range(len(t)))


def _scharr(img: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    p = np.pad(img, 1, mode="edge")
    smooth_y = 3.0 * p[:-2] + 10.0 * p[1:-1] + 3.0 * p[2:]
    gx = (smooth_y[:, 2:] - smooth_y[:, :-2]) / 32.0
    smooth_x = 3.0 * p[:, :-2] + 10.0 * p[:, 1:-1] + 3.0 * p[:, 2:]
    gy = (smooth_x[2:, :] - smooth_x[:-2, :]) / 32.0
    return gx, gy


def _fed_taus(cycle_time: float) -> np.ndarray:
    n = 1
    while TAU_MAX * (n * n + n) / 3.0 < cycle_time:
        n += 1
    j = np.arange(n, dtype=np.float64)
    taus = TAU_MAX / (2.0 * np.cos(np.pi * (2 * j + 1)
                                   / (4 * n + 2)) ** 2)
    return taus * (cycle_time / taus.sum())


def _diffusion_step(l: np.ndarray, g: np.ndarray,
                    tau: float) -> np.ndarray:
    lp = np.pad(l, 1, mode="edge")
    gp = np.pad(g, 1, mode="edge")
    c = g
    fe = (gp[1:-1, 2:] + c) * (lp[1:-1, 2:] - l)
    fw = (gp[1:-1, :-2] + c) * (lp[1:-1, :-2] - l)
    fs = (gp[2:, 1:-1] + c) * (lp[2:, 1:-1] - l)
    fn = (gp[:-2, 1:-1] + c) * (lp[:-2, 1:-1] - l)
    return l + tau * 0.5 * (fe + fw + fs + fn)


def contrast_k(img01: np.ndarray) -> float:
    gx, gy = _scharr(_gauss_blur(img01, 1.0))
    mag = np.hypot(gx, gy)
    nz = mag[mag > 0]
    if len(nz) == 0:
        return 0.03
    hist, edges = np.histogram(nz, bins=300, range=(0.0, float(nz.max())))
    csum = np.cumsum(hist)
    idx = int(np.searchsorted(csum, 0.7 * csum[-1]))
    return float(edges[min(idx + 1, 300)]) or 0.03


def _level_plan(n_octaves: int, n_sublevels: int):
    """[(octave, sublevel, σ_global, σ_local)] per evolution index."""
    plan = []
    for o in range(n_octaves):
        for s in range(n_sublevels):
            sg = SIGMA0 * 2.0 ** (o + s / n_sublevels)
            plan.append((o, s, sg, sg / 2.0 ** o))
    return plan


def build_scale_space(img01: np.ndarray, n_octaves: int = 4,
                      n_sublevels: int = 4, k: Optional[float] = None):
    """Oracle nonlinear scale space → (levels: list of f64 arrays in
    octave resolution, plan: [(o, s, σ_global, σ_local)], k)."""
    if k is None:
        k = contrast_k(img01)
    plan = _level_plan(n_octaves, n_sublevels)
    levels: List[np.ndarray] = []
    l = _gauss_blur(img01, SIGMA0)
    kk = float(k)
    t_prev = (SIGMA0 ** 2) / 2.0
    for (o, s, sg, sl) in plan:
        if s == 0 and o > 0:
            l = l[::2, ::2]
            kk *= 0.75
            t_prev = (SIGMA0 * 2.0 ** ((o - 1) + (n_sublevels - 1)
                                       / n_sublevels) / 2.0 ** o) ** 2 / 2.0
        t_cur = sl * sl / 2.0
        if t_cur > t_prev:
            gx, gy = _scharr(l)
            g = 1.0 / (1.0 + (gx * gx + gy * gy) / (kk * kk))
            for tau in _fed_taus(t_cur - t_prev):
                l = _diffusion_step(l, g, float(tau))
        levels.append(l.copy())
        t_prev = t_cur
    return levels, plan, k


def build_scale_space_device(img01, n_octaves: int = 4,
                             n_sublevels: int = 4,
                             k: Optional[float] = None):
    """Tensor twin of :func:`build_scale_space` (float32; same plan, and k
    from the oracle's host histogram) on the device of ``img01`` (a
    tensor; a numpy image goes to the card). Returns the levels as device
    tensors."""
    if isinstance(img01, torch.Tensor):
        dev = img01.device
        x_np = img01.double().cpu().numpy()
    else:
        dev = torch.device("cuda")
        x_np = np.asarray(img01, np.float64)
    if k is None:
        k = contrast_k(x_np)
    plan = _level_plan(n_octaves, n_sublevels)

    def edge(a, r):
        return _replicate_pad(_replicate_pad(a, 0, r), 1, r)

    def blur(a, sigma):
        r = max(1, int(np.ceil(4.0 * sigma)))
        i = np.arange(-r, r + 1, dtype=np.float32)
        t = np.exp(-(i * i) / (2.0 * sigma * sigma))
        t = t / t.sum()
        h, w = a.shape
        p = _replicate_pad(a, 1, r)
        a = sum(float(t[j]) * p[:, j:j + w] for j in range(2 * r + 1))
        p = _replicate_pad(a, 0, r)
        return sum(float(t[j]) * p[j:j + h, :] for j in range(2 * r + 1))

    def scharr(a):
        p = edge(a, 1)
        sy = 3.0 * p[:-2] + 10.0 * p[1:-1] + 3.0 * p[2:]
        gx = (sy[:, 2:] - sy[:, :-2]) / 32.0
        sx = 3.0 * p[:, :-2] + 10.0 * p[:, 1:-1] + 3.0 * p[:, 2:]
        gy = (sx[2:, :] - sx[:-2, :]) / 32.0
        return gx, gy

    def dstep(l, g, tau):
        lp = edge(l, 1)
        gp = edge(g, 1)
        fe = (gp[1:-1, 2:] + g) * (lp[1:-1, 2:] - l)
        fw = (gp[1:-1, :-2] + g) * (lp[1:-1, :-2] - l)
        fs = (gp[2:, 1:-1] + g) * (lp[2:, 1:-1] - l)
        fn = (gp[:-2, 1:-1] + g) * (lp[:-2, 1:-1] - l)
        return l + tau * 0.5 * (fe + fw + fs + fn)

    l0 = (img01.to(torch.float32) if isinstance(img01, torch.Tensor)
          else torch.as_tensor(x_np.astype(np.float32), device=dev))
    l = blur(l0, SIGMA0)
    kk = float(k)
    t_prev = (SIGMA0 ** 2) / 2.0
    levels = []
    for (o, s, sg, sl) in plan:
        if s == 0 and o > 0:
            l = l[::2, ::2]
            kk *= 0.75
            t_prev = (SIGMA0 * 2.0 ** ((o - 1) + (n_sublevels - 1)
                                       / n_sublevels) / 2.0 ** o) ** 2 / 2.0
        t_cur = sl * sl / 2.0
        if t_cur > t_prev:
            gx, gy = scharr(l)
            g = 1.0 / (1.0 + (gx * gx + gy * gy) / torch.tensor(kk * kk, device=dev))
            for tau in _fed_taus(t_cur - t_prev):
                l = dstep(l, g, float(tau))
        levels.append(l)
        t_prev = t_cur
    return levels, plan, k


def hessian_response(l: np.ndarray, sigma_local: float) -> np.ndarray:
    gx, gy = _scharr(l)
    lxx, lxy = _scharr(gx)
    _, lyy = _scharr(gy)
    return (sigma_local ** 4) * (lxx * lyy - lxy * lxy)


# ---------------------------------------------------------------------------
# sparse stage (host)
# ---------------------------------------------------------------------------

def _find_extrema(responses, plan, n_sublevels: int, threshold: float):
    """[(idx, y, x, R)] strict spatial maxima ≥ in-octave scale nbrs."""
    out = []
    for i, r in enumerate(responses):
        o, s = plan[i][0], plan[i][1]
        h, w = r.shape
        if h < 12 or w < 12:
            continue
        core = r[1:-1, 1:-1]
        nb = np.stack([
            r[:-2, :-2], r[:-2, 1:-1], r[:-2, 2:],
            r[1:-1, :-2], r[1:-1, 2:],
            r[2:, :-2], r[2:, 1:-1], r[2:, 2:],
        ])
        m = (core > threshold) & (core > nb.max(axis=0))
        if s > 0:
            m &= core >= responses[i - 1][1:-1, 1:-1]
        if s + 1 < n_sublevels and i + 1 < len(responses):
            m &= core >= responses[i + 1][1:-1, 1:-1]
        m[:4, :] = m[-4:, :] = m[:, :4] = m[:, -4:] = False
        ys, xs = np.nonzero(m)
        for y, x in zip(ys + 1, xs + 1):
            out.append((i, int(y), int(x), float(r[y, x])))
    return out


def _refine_2d(r: np.ndarray, y: int, x: int):
    """One quadratic step (dx, dy) clamped to ±0.5."""
    dx = (r[y, x + 1] - r[y, x - 1]) * 0.5
    dy = (r[y + 1, x] - r[y - 1, x]) * 0.5
    dxx = r[y, x + 1] + r[y, x - 1] - 2 * r[y, x]
    dyy = r[y + 1, x] + r[y - 1, x] - 2 * r[y, x]
    dxy = (r[y + 1, x + 1] - r[y + 1, x - 1] - r[y - 1, x + 1]
           + r[y - 1, x - 1]) * 0.25
    det = dxx * dyy - dxy * dxy
    if abs(det) < 1e-18:
        return 0.0, 0.0
    ox = -(dyy * dx - dxy * dy) / det
    oy = -(dxx * dy - dxy * dx) / det
    return float(np.clip(ox, -0.5, 0.5)), float(np.clip(oy, -0.5, 0.5))


def _sample(img: np.ndarray, y: float, x: float) -> float:
    h, w = img.shape
    x = min(max(x, 0.0), w - 1.0)
    y = min(max(y, 0.0), h - 1.0)
    x0 = min(int(x), w - 2)
    y0 = min(int(y), h - 2)
    fx, fy = x - x0, y - y0
    return float(img[y0, x0] * (1 - fx) * (1 - fy)
                 + img[y0, x0 + 1] * fx * (1 - fy)
                 + img[y0 + 1, x0] * (1 - fx) * fy
                 + img[y0 + 1, x0 + 1] * fx * fy)


def _orientation(gx: np.ndarray, gy: np.ndarray, y: float, x: float,
                 sl: float) -> float:
    """Dominant 60° window angle (radians, image convention)."""
    r = max(2, int(round(_ORI_R * sl)))
    h, w = gx.shape
    ys = np.arange(max(0, int(y) - r), min(h, int(y) + r + 1))
    xs = np.arange(max(0, int(x) - r), min(w, int(x) + r + 1))
    yy, xx = np.meshgrid(ys, xs, indexing="ij")
    d2 = (yy - y) ** 2 + (xx - x) ** 2
    m = d2 <= r * r
    if not m.any():
        return 0.0
    wgt = np.exp(-d2[m] / (2.0 * (2.5 * sl) ** 2))
    vx = gx[yy[m], xx[m]] * wgt
    vy = gy[yy[m], xx[m]] * wgt
    ang = np.arctan2(vy, vx)
    best, best_a = -1.0, 0.0
    for start in np.linspace(-np.pi, np.pi, 512, endpoint=False):
        dd = (ang - start) % (2 * np.pi)
        sel = dd < np.pi / 3
        if not sel.any():
            continue
        sx, sy = vx[sel].sum(), vy[sel].sum()
        norm = sx * sx + sy * sy
        if norm > best:
            best = norm
            best_a = np.arctan2(sy, sx)
    return float(best_a)


def _mldb_offsets():
    """Static unit-scale sample offsets per grid: (px, py, cell_index)
    stacked over all grids — scaled by R and rotated per keypoint."""
    offs = []
    for d in _GRIDS:
        cell = 2.0 / d
        sub = (np.arange(4) + 0.5) * cell / 4
        cells = []
        for gi in range(d):
            for gj in range(d):
                py = -1.0 + gi * cell + sub
                px = -1.0 + gj * cell + sub
                pyy, pxx = np.meshgrid(py, px, indexing="ij")
                cells.append(np.stack([pxx.ravel(), pyy.ravel()], axis=1))
        offs.append(np.stack(cells))     # (d², 16, 2)
    return offs


_OFFS = _mldb_offsets()
_PAIRS = [np.array([(i, j) for i in range(d * d)
                    for j in range(i + 1, d * d)]) for d in _GRIDS]


def _sample_vec(img: np.ndarray, ys: np.ndarray, xs: np.ndarray):
    h, w = img.shape
    x = np.clip(xs, 0.0, w - 1.0)
    y = np.clip(ys, 0.0, h - 1.0)
    x0 = np.minimum(x.astype(np.int64), w - 2)
    y0 = np.minimum(y.astype(np.int64), h - 2)
    fx, fy = x - x0, y - y0
    return (img[y0, x0] * (1 - fx) * (1 - fy)
            + img[y0, x0 + 1] * fx * (1 - fy)
            + img[y0 + 1, x0] * (1 - fx) * fy
            + img[y0 + 1, x0 + 1] * fx * fy)


def _mldb_descriptor(l: np.ndarray, gx: np.ndarray, gy: np.ndarray,
                     y: float, x: float, sl: float,
                     angle: float) -> np.ndarray:
    """486-bit M-LDB → u8 [64] (61 bytes + zero pad); vectorized
    bilinear sampling over the static offset tables."""
    c, s = np.cos(angle), np.sin(angle)
    R = _PATTERN_R * sl
    bits = []
    for gidx, d in enumerate(_GRIDS):
        off = _OFFS[gidx] * R                    # (n_cells, 16, 2)
        ix = x + c * off[..., 0] - s * off[..., 1]
        iy = y + s * off[..., 0] + c * off[..., 1]
        lv = _sample_vec(l, iy, ix).mean(axis=1)
        dxv = _sample_vec(gx, iy, ix)
        dyv = _sample_vec(gy, iy, ix)
        dxr = (c * dxv + s * dyv).mean(axis=1)
        dyr = (-s * dxv + c * dyv).mean(axis=1)
        means = np.stack([lv, dxr, dyr], axis=1)  # (n_cells, 3)
        pi, pj = _PAIRS[gidx][:, 0], _PAIRS[gidx][:, 1]
        bits.append((means[pi] > means[pj]).reshape(-1))
    allbits = np.concatenate(bits)
    out = np.zeros(64, np.uint8)
    idx = np.nonzero(allbits)[0]
    np.bitwise_or.at(out, idx >> 3, (1 << (idx & 7)).astype(np.uint8))
    return out


def match_descriptors_hamming(d1, d2, ratio: float = 0.8) -> np.ndarray:
    """Hamming matching for byte-packed descriptors of any width (the
    BRIEF matcher is fixed at 256 bits) → int32 [M, 2] (i1, i2): ±1
    product (dot = nbits − 2·hamming, exact in float32: on the
    descriptors' device when either is a tensor, in full float32 there),
    Lowe ratio + mutual cross-check — the ops/brief.py protocol."""
    dev = next((d.device for d in (d1, d2) if isinstance(d, torch.Tensor)), None)
    a = np.asarray(d1.cpu() if isinstance(d1, torch.Tensor) else d1, np.uint8)
    b = np.asarray(d2.cpu() if isinstance(d2, torch.Tensor) else d2, np.uint8)
    if a.size == 0 or b.size == 0:
        return np.zeros((0, 2), np.int32)
    nbits = a.shape[1] * 8
    b1 = np.unpackbits(a, axis=1, bitorder="little").astype(
        np.float32) * 2.0 - 1.0
    b2 = np.unpackbits(b, axis=1, bitorder="little").astype(
        np.float32) * 2.0 - 1.0
    if dev is None:
        dot = b1 @ b2.T
    else:
        with full_f32(dev):
            dot = (torch.as_tensor(b1, device=dev) @ torch.as_tensor(b2, device=dev).T).cpu().numpy()
    ham = (nbits - dot) / 2.0
    j = np.argmin(ham, axis=1)
    i = np.arange(ham.shape[0])
    best = ham[i, j]
    if ham.shape[1] > 1:
        part = np.partition(ham, 1, axis=1)
        second = np.where(part[:, 0] == best, part[:, 1], part[:, 0])
        keep = best < ratio * np.maximum(second, 1e-9)
    else:
        keep = np.ones(len(i), bool)
    back = np.argmin(ham, axis=0)
    mutual = back[j] == i
    sel = keep & mutual
    return np.stack([i[sel], j[sel]], axis=1).astype(np.int32)


def detect_and_compute(
    gray,
    n_octaves: int = 4,
    n_sublevels: int = 4,
    threshold: float = DEFAULT_THRESHOLD,
    max_keypoints: int = 2000,
    backend: str = "host",
) -> Tuple[np.ndarray, np.ndarray]:
    """AKAZE detect+compute (OpenCV ``AKAZE.detectAndCompute`` role) →
    (keypoints float32 [N, 6], descriptors u8 [N, 64]). ``backend`` =
    "host" (f64 oracle scale space) | "device" (f32 FED scale space on the
    device of a tensor ``gray``, else on the card; sparse stage
    identical)."""
    if isinstance(gray, torch.Tensor):
        if gray.ndim != 2:
            raise ValueError("akaze expects a gray image")
        x01 = gray.to(torch.float64) / torch.tensor(255.0, dtype=torch.float64,
                                                     device=gray.device)
        if backend == "host":
            x01 = x01.cpu().numpy()
    else:
        img = np.asarray(gray)
        if img.ndim != 2:
            raise ValueError("akaze expects a gray image")
        x01 = img.astype(np.float64) / 255.0
    if backend == "device":
        lv, plan, _ = build_scale_space_device(x01, n_octaves,
                                               n_sublevels)
        levels = [a.double().cpu().numpy() for a in lv]
    elif backend == "host":
        levels, plan, _ = build_scale_space(x01, n_octaves, n_sublevels)
    else:
        raise ValueError(backend)
    responses = [hessian_response(l, plan[i][3])
                 for i, l in enumerate(levels)]
    raw = _find_extrema(responses, plan, n_sublevels, threshold)
    raw.sort(key=lambda t: (-t[3], t[0], t[1], t[2]))
    raw = raw[:max_keypoints]
    grads = {}
    kps, descs = [], []
    for i, yy, xx, resp in raw:
        o, s, sg, sl = plan[i]
        ox, oy = _refine_2d(responses[i], yy, xx)
        fy, fx = yy + oy, xx + ox
        if i not in grads:
            grads[i] = _scharr(levels[i])
        gx, gy = grads[i]
        ang = _orientation(gx, gy, fy, fx, sl)
        desc = _mldb_descriptor(levels[i], gx, gy, fy, fx, sl, ang)
        scale = 2.0 ** o
        kps.append((fx * scale, fy * scale, 2.0 * sg,
                    float(np.degrees(ang) % 360.0), resp, float(i)))
        descs.append(desc)
    if not kps:
        return (np.zeros((0, 6), np.float32), np.zeros((0, 64), np.uint8))
    return (np.asarray(kps, np.float32), np.stack(descs))
