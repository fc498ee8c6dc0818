"""SIFT keypoints + descriptors (port of ``rustcv_tpu.ops.sift``; OpenCV
``SIFT`` role, Lowe 2004). The patent expired in 2020; the algorithm here
is the published one, re-derived, with every constant frozen below.

Dense/sparse split:
- The dense work, the Gaussian pyramid and its DoG, is separable blurs on
  the device (:func:`build_pyramids` has a tensor twin
  :func:`build_pyramids_device` whose float32 planes match the float64
  oracle to ~1e-3 of the [0, 1] range); each octave is read back once.
- The SPARSE work — sub-pixel refinement, orientation histograms,
  128-d descriptors — is per-keypoint host float64 (hundreds of
  keypoints, far below device break-even; the moments/contours
  precedent).

Frozen spec (all float64 host, deterministic):
- input u8 → [0, 1]; optional ×2 bilinear upscale (src_x = dst_x/2 −
  0.25, the resize half-pixel rule); assumed camera blur 0.5 (1.0 when
  doubled); base blurred to ``sigma``;
- per octave ``n_layers + 3`` Gaussians, incremental blurs with
  ``σ_s = sigma·2^{s/n}``; next octave = layer ``n_layers`` subsampled
  ``[::2, ::2]``; Gaussian taps ``exp(−i²/2σ²)`` normalized, radius
  ``ceil(4σ)``; DoG = adjacent differences;
- extrema: |D| > 0.5·contrast_threshold/n_layers, ≥ (maxima) or ≤
  (minima) all 26 neighbors, layers 1..n_layers, 5-px image border;
- refinement: ≤ 5 Newton steps on the 3-D quadratic (central-difference
  gradient/Hessian), reject |contrast·n_layers| < contrast_threshold
  and spatial-Hessian edge ratio tr²/det ≥ (r+1)²/r (r =
  edge_threshold);
- orientation: 36-bin magnitude histogram, Gaussian σ = 1.5·scl,
  radius = round(3·1.5·scl), circular [1,4,6,4,1]/16 smoothing, peaks
  ≥ 0.8·max, parabolic bin refinement, angle = 360 − 10·bin;
- descriptor: 4×4 spatial × 8 orientation bins, hist_width = 3·scl,
  trilinear soft-assignment, Gaussian weight over (r/d)²+(c/d)² with
  σ = d/2, clip at 0.2 of the L2 norm, renormalize, u8 = min(255,
  round(512·v)).

Keypoints return as float32 [N, 6]: (x, y, size, angle_deg, response,
octave) in ORIGINAL image coordinates; descriptors as u8 [N, 128].
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from .filters import _replicate_pad

_N_BINS_ORI = 36
_D_DESC = 4
_N_DESC_ORI = 8
_PEAK_RATIO = 0.8
_DESC_MAG_THR = 0.2
_INT_DESC_FCTR = 512.0


# ---------------------------------------------------------------------------
# dense stage: pyramids
# ---------------------------------------------------------------------------

def _gauss_taps(sigma: float) -> np.ndarray:
    r = max(1, int(np.ceil(4.0 * sigma)))
    i = np.arange(-r, r + 1, dtype=np.float64)
    t = np.exp(-(i * i) / (2.0 * sigma * sigma))
    return t / t.sum()


def _blur(img: np.ndarray, sigma: float) -> np.ndarray:
    if sigma <= 0:
        return img.copy()
    t = _gauss_taps(sigma)
    r = len(t) // 2
    p = np.pad(img, ((0, 0), (r, r)), mode="edge")
    out = np.zeros_like(img)
    for k in range(len(t)):
        out += t[k] * p[:, k:k + img.shape[1]]
    p = np.pad(out, ((r, r), (0, 0)), mode="edge")
    out2 = np.zeros_like(img)
    for k in range(len(t)):
        out2 += t[k] * p[k:k + img.shape[0], :]
    return out2


def _upscale2(img: np.ndarray) -> np.ndarray:
    """×2 bilinear with src_x = dst_x/2 − 0.25 (edge clamped)."""
    h, w = img.shape

    def axis_up(a, n):  # upsample the LAST axis n → 2n
        x = np.arange(2 * n) / 2.0 - 0.25
        x0 = np.clip(np.floor(x).astype(int), 0, n - 1)
        x1 = np.minimum(x0 + 1, n - 1)
        f = np.clip(x - x0, 0.0, 1.0)
        return a[..., x0] * (1 - f) + a[..., x1] * f

    return axis_up(axis_up(img, w).T, h).T


def _sigmas(sigma: float, n_layers: int) -> np.ndarray:
    """Incremental blur sigmas for layers 1..n+2."""
    k = 2.0 ** (1.0 / n_layers)
    sig = np.zeros(n_layers + 3)
    prev = sigma
    for s in range(1, n_layers + 3):
        total = sigma * (k ** s)
        sig[s] = np.sqrt(total * total - prev * prev)
        prev = total
    return sig


def n_octaves_for(shape: Tuple[int, int]) -> int:
    return max(1, int(np.round(np.log2(min(shape)))) - 2)


def build_pyramids(
    img: np.ndarray, n_octaves: Optional[int] = None, n_layers: int = 3,
    sigma: float = 1.6, double_image: bool = True,
) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """u8 (H, W) → (gaussian octaves [n+3, h, w] f64 in [0,1],
    DoG octaves [n+2, h, w])."""
    base = np.asarray(img, np.float64) / 255.0
    if double_image:
        base = _upscale2(base)
        init_blur = np.sqrt(max(sigma * sigma - 1.0, 0.01))
    else:
        init_blur = np.sqrt(max(sigma * sigma - 0.25, 0.01))
    base = _blur(base, init_blur)
    if n_octaves is None:
        n_octaves = n_octaves_for(base.shape)
    sig = _sigmas(sigma, n_layers)
    gs, dogs = [], []
    cur = base
    for _ in range(n_octaves):
        layers = [cur]
        for s in range(1, n_layers + 3):
            layers.append(_blur(layers[-1], sig[s]))
        g = np.stack(layers)
        gs.append(g)
        dogs.append(g[1:] - g[:-1])
        cur = g[n_layers][::2, ::2]
        if min(cur.shape) < 8:
            break
    return gs, dogs


def build_pyramids_device(img, n_octaves: Optional[int] = None,
                          n_layers: int = 3, sigma: float = 1.6,
                          double_image: bool = True):
    """Tensor twin of :func:`build_pyramids`: float32 separable blurs on
    the device of ``img`` (a tensor; a numpy image goes to the card);
    returns host float64 numpy pyramids for the sparse stage. Planes agree
    with the float64 oracle to ~1e-3 (of the [0,1] range)."""
    a = torch.as_tensor(np.asarray(img) if not isinstance(img, torch.Tensor) else img,
                        device=img.device if isinstance(img, torch.Tensor) else "cuda")
    dev = a.device

    def blur_t(x, sigma_):
        if sigma_ <= 0:
            return x
        t = _gauss_taps(sigma_).astype(np.float32)
        r = len(t) // 2
        h, w = x.shape
        p = _replicate_pad(x, 1, r)
        out = sum(float(t[k]) * p[:, k:k + w] for k in range(len(t)))
        p = _replicate_pad(out, 0, r)
        return sum(float(t[k]) * p[k:k + h, :] for k in range(len(t)))

    base = a.to(torch.float32) / torch.tensor(255.0, device=dev)
    if double_image:
        h, w = base.shape

        def axis_up_t(x, n):
            u = np.arange(2 * n) / 2.0 - 0.25
            x0 = np.clip(np.floor(u).astype(int), 0, n - 1)
            x1 = np.minimum(x0 + 1, n - 1)
            f = torch.as_tensor(np.clip(u - x0, 0.0, 1.0).astype(np.float32), device=dev)
            return (x[..., torch.as_tensor(x0, device=dev)] * (1 - f)
                    + x[..., torch.as_tensor(x1, device=dev)] * f)

        base = axis_up_t(axis_up_t(base, w).T, h).T
        init_blur = float(np.sqrt(max(sigma * sigma - 1.0, 0.01)))
    else:
        init_blur = float(np.sqrt(max(sigma * sigma - 0.25, 0.01)))
    base = blur_t(base, init_blur)
    if n_octaves is None:
        n_octaves = n_octaves_for(base.shape)
    sig = _sigmas(sigma, n_layers)
    gs, dogs = [], []
    cur = base
    for _ in range(n_octaves):
        layers = [cur]
        for s in range(1, n_layers + 3):
            layers.append(blur_t(layers[-1], float(sig[s])))
        g = torch.stack(layers)
        gs.append(g.double().cpu().numpy())
        dogs.append((g[1:] - g[:-1]).double().cpu().numpy())
        cur = g[n_layers][::2, ::2]
        if min(cur.shape) < 8:
            break
    return gs, dogs


# ---------------------------------------------------------------------------
# sparse stage: refinement, orientation, descriptor (host float64)
# ---------------------------------------------------------------------------

def _find_extrema(dog: np.ndarray, thr: float) -> np.ndarray:
    """DoG octave [S, H, W] → int candidates [K, 3] (s, y, x)."""
    s, h, w = dog.shape
    if h < 12 or w < 12:
        return np.zeros((0, 3), np.int64)
    c = dog[1:-1, 5:-5, 5:-5]
    is_max = np.abs(c) > thr
    is_min = is_max.copy()
    for ds in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if ds == 0 and dy == 0 and dx == 0:
                    continue
                n = dog[1 + ds:s - 1 + ds, 5 + dy:h - 5 + dy,
                        5 + dx:w - 5 + dx]
                is_max &= c >= n
                is_min &= c <= n
    ss, yy, xx = np.nonzero((is_max & (c > 0)) | (is_min & (c < 0)))
    return np.stack([ss + 1, yy + 5, xx + 5], axis=1)


def _refine(dog: np.ndarray, s: int, y: int, x: int, n_layers: int,
            contrast_threshold: float, edge_threshold: float):
    """Newton refinement → (s, y, x, offset (ds, dy, dx), contrast) or
    None when rejected."""
    ns, h, w = dog.shape
    for _ in range(5):
        d = dog
        dd = np.array([
            (d[s, y, x + 1] - d[s, y, x - 1]) * 0.5,
            (d[s, y + 1, x] - d[s, y - 1, x]) * 0.5,
            (d[s + 1, y, x] - d[s - 1, y, x]) * 0.5,
        ])
        v = d[s, y, x]
        dxx = d[s, y, x + 1] + d[s, y, x - 1] - 2 * v
        dyy = d[s, y + 1, x] + d[s, y - 1, x] - 2 * v
        dss = d[s + 1, y, x] + d[s - 1, y, x] - 2 * v
        dxy = (d[s, y + 1, x + 1] - d[s, y + 1, x - 1]
               - d[s, y - 1, x + 1] + d[s, y - 1, x - 1]) * 0.25
        dxs = (d[s + 1, y, x + 1] - d[s + 1, y, x - 1]
               - d[s - 1, y, x + 1] + d[s - 1, y, x - 1]) * 0.25
        dys = (d[s + 1, y + 1, x] - d[s + 1, y - 1, x]
               - d[s - 1, y + 1, x] + d[s - 1, y - 1, x]) * 0.25
        hmat = np.array([[dxx, dxy, dxs], [dxy, dyy, dys], [dxs, dys, dss]])
        try:
            off = -np.linalg.solve(hmat, dd)
        except np.linalg.LinAlgError:
            return None
        if np.all(np.abs(off) < 0.5):
            break
        x += int(np.round(off[0]))
        y += int(np.round(off[1]))
        s += int(np.round(off[2]))
        if not (1 <= s <= n_layers and 5 <= y < dog.shape[1] - 5
                and 5 <= x < dog.shape[2] - 5):
            return None
    else:
        return None
    contrast = dog[s, y, x] + 0.5 * dd @ off
    if abs(contrast) * n_layers < contrast_threshold:
        return None
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    r = edge_threshold
    if det <= 0 or tr * tr * r >= (r + 1) * (r + 1) * det:
        return None
    return s, y, x, off, contrast


def _orientations(g: np.ndarray, y: float, x: float, scl: float):
    """36-bin orientation histogram peaks → list of angles (deg)."""
    h, w = g.shape
    sig = 1.5 * scl
    radius = int(np.round(3.0 * sig))
    yc, xc = int(np.round(y)), int(np.round(x))
    y0, y1 = max(yc - radius, 1), min(yc + radius, h - 2)
    x0, x1 = max(xc - radius, 1), min(xc + radius, w - 2)
    if y1 <= y0 or x1 <= x0:
        return []
    ys, xs = np.mgrid[y0:y1 + 1, x0:x1 + 1]
    dx = g[ys, xs + 1] - g[ys, xs - 1]
    dy = g[ys - 1, xs] - g[ys + 1, xs]       # y-down image, standard ori
    mag = np.hypot(dx, dy)
    ori = np.rad2deg(np.arctan2(dy, dx)) % 360.0
    wgt = np.exp(-(((ys - yc) ** 2 + (xs - xc) ** 2)
                   / (2.0 * sig * sig)))
    bins = np.round(ori * (_N_BINS_ORI / 360.0)).astype(int) % _N_BINS_ORI
    hist = np.bincount(bins.ravel(), (mag * wgt).ravel(), _N_BINS_ORI)
    # circular [1,4,6,4,1]/16 smoothing
    sm = np.zeros_like(hist)
    for k, c in ((-2, 1), (-1, 4), (0, 6), (1, 4), (2, 1)):
        sm += c * np.roll(hist, k)
    hist = sm / 16.0
    mx = hist.max()
    if mx <= 0:
        return []
    out = []
    for i in range(_N_BINS_ORI):
        l = hist[(i - 1) % _N_BINS_ORI]
        r_ = hist[(i + 1) % _N_BINS_ORI]
        if hist[i] > l and hist[i] > r_ and hist[i] >= _PEAK_RATIO * mx:
            b = i + 0.5 * (l - r_) / (l - 2 * hist[i] + r_)
            # raw histogram angle theta (the atan2 frame the descriptor
            # subtracts in) -- callers store 360 - theta for display
            out.append((b % _N_BINS_ORI) * (360.0 / _N_BINS_ORI))
    return out


def _descriptor(g: np.ndarray, y: float, x: float, scl: float,
                angle: float) -> np.ndarray:
    h, w = g.shape
    d, n = _D_DESC, _N_DESC_ORI
    # y-down image frame: the grid rotation uses +θ where the pixel
    # orientations subtract θ — the y-axis inversion flips the sense
    # (verified by the rotation-invariance test; the −θ pairing loses it)
    cos_t = np.cos(np.deg2rad(angle))
    sin_t = np.sin(np.deg2rad(angle))
    bins_per_deg = n / 360.0
    hist_width = 3.0 * scl
    radius = int(np.round(hist_width * np.sqrt(2.0) * (d + 1) * 0.5))
    radius = min(radius, int(np.hypot(h, w)))
    yc, xc = int(np.round(y)), int(np.round(x))
    y0, y1 = max(yc - radius, 1), min(yc + radius, h - 2)
    x0, x1 = max(xc - radius, 1), min(xc + radius, w - 2)
    if y1 <= y0 or x1 <= x0:
        return np.zeros(d * d * n, np.uint8)
    ys, xs = np.mgrid[y0:y1 + 1, x0:x1 + 1]
    j = xs - x
    i = ys - y
    x_rot = (j * cos_t - i * sin_t) / hist_width
    y_rot = (j * sin_t + i * cos_t) / hist_width
    rbin = y_rot + d / 2 - 0.5
    cbin = x_rot + d / 2 - 0.5
    sel = (rbin > -1) & (rbin < d) & (cbin > -1) & (cbin < d)
    if not sel.any():
        return np.zeros(d * d * n, np.uint8)
    dx = g[ys, xs + 1] - g[ys, xs - 1]
    dy = g[ys - 1, xs] - g[ys + 1, xs]
    mag = np.hypot(dx, dy)
    ori = (np.rad2deg(np.arctan2(dy, dx)) - angle) % 360.0
    wgt = np.exp(-(x_rot ** 2 + y_rot ** 2) / (0.5 * d * d))
    rbin, cbin = rbin[sel], cbin[sel]
    obin = (ori[sel] * bins_per_deg) % n
    val = (mag * wgt)[sel]

    hist = np.zeros((d + 2, d + 2, n))
    r0 = np.floor(rbin).astype(int)
    c0 = np.floor(cbin).astype(int)
    o0 = np.floor(obin).astype(int)
    fr, fc, fo = rbin - r0, cbin - c0, obin - o0
    for dr in (0, 1):
        wr = val * (fr if dr else 1 - fr)
        for dc in (0, 1):
            wc = wr * (fc if dc else 1 - fc)
            for do in (0, 1):
                wo = wc * (fo if do else 1 - fo)
                np.add.at(hist, (r0 + dr + 1, c0 + dc + 1,
                                 (o0 + do) % n), wo)
    vec = hist[1:-1, 1:-1, :].reshape(-1)
    nrm = np.linalg.norm(vec)
    if nrm > 1e-12:
        vec = np.minimum(vec, _DESC_MAG_THR * nrm)
        nrm = np.linalg.norm(vec)
        if nrm > 1e-12:
            vec = vec / nrm
    return np.minimum(np.round(_INT_DESC_FCTR * vec), 255).astype(np.uint8)


def detect_and_compute(
    img: np.ndarray,
    n_features: int = 0,
    n_layers: int = 3,
    contrast_threshold: float = 0.04,
    edge_threshold: float = 10.0,
    sigma: float = 1.6,
    double_image: bool = True,
    use_device: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """u8 gray (H, W) → (keypoints float32 [N, 6] (x, y, size,
    angle_deg, response, octave), descriptors u8 [N, 128]), sorted by
    |response| descending (capped at ``n_features`` when > 0). A tensor
    ``img`` builds its pyramids on its device (``use_device`` sends a numpy
    image to the card); the sparse stage is host float64 either way."""
    on_device = use_device or isinstance(img, torch.Tensor)
    if not on_device:
        img = np.asarray(img)
    if img.ndim == 3:
        img = img[..., 0]
    build = build_pyramids_device if on_device else build_pyramids
    gs, dogs = build(img, None, n_layers, sigma, double_image)
    thr = 0.5 * contrast_threshold / n_layers
    scale0 = 0.5 if double_image else 1.0
    kps, descs = [], []
    for o, dog in enumerate(dogs):
        for s0, y0, x0 in _find_extrema(dog, thr):
            ref = _refine(dog, int(s0), int(y0), int(x0), n_layers,
                          contrast_threshold, edge_threshold)
            if ref is None:
                continue
            s, y, x, off, contrast = ref
            scl = sigma * 2.0 ** ((s + off[2]) / n_layers)
            g = gs[o][s]
            for theta in _orientations(g, y + off[1], x + off[0], scl):
                desc = _descriptor(g, y + off[1], x + off[0], scl, theta)
                ang = (360.0 - theta) % 360.0
                kps.append((
                    (x + off[0]) * (2.0 ** o) * scale0,
                    (y + off[1]) * (2.0 ** o) * scale0,
                    scl * (2.0 ** o) * scale0 * 2.0,
                    ang,
                    abs(contrast),
                    o,
                ))
                descs.append(desc)
    if not kps:
        return np.zeros((0, 6), np.float32), np.zeros((0, 128), np.uint8)
    kp = np.asarray(kps, np.float32)
    dsc = np.stack(descs)
    order = np.argsort(-kp[:, 4], kind="stable")
    if n_features > 0:
        order = order[:n_features]
    return kp[order], dsc[order]


def match_descriptors_l2(d1: np.ndarray, d2: np.ndarray,
                         ratio: float = 0.75) -> np.ndarray:
    """L2 matching with Lowe ratio + mutual cross-check → int32 [M, 2].
    ‖a−b‖² expands to one [N1,128]@[128,N2] float64 host matmul
    (descriptor counts are small)."""
    a = np.asarray(d1, np.float64)
    b = np.asarray(d2, np.float64)
    if len(a) == 0 or len(b) == 0:
        return np.zeros((0, 2), np.int32)
    d2m = (np.sum(a * a, 1)[:, None] + np.sum(b * b, 1)[None, :]
           - 2.0 * (a @ b.T))
    d2m = np.maximum(d2m, 0.0)
    j = np.argmin(d2m, axis=1)
    i = np.arange(len(a))
    best = d2m[i, j]
    keep = np.ones(len(a), bool)
    if d2m.shape[1] > 1:
        part = np.partition(d2m, 1, axis=1)
        keep &= best < (ratio * ratio) * part[:, 1]
    back = np.argmin(d2m, axis=0)
    keep &= back[j] == i
    return np.stack([i[keep], j[keep]], axis=-1).astype(np.int32)
