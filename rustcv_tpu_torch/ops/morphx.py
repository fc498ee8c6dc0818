"""Extended morphology: skeleton thinning and anisotropic diffusion
(port of ``rustcv_tpu.ops.morphx``: OpenCV ximgproc ``thinning`` /
``anisotropicDiffusion`` roles), on tensors where the caller's tensor is.

Frozen specs:
- thinning: Zhang-Suen (1984), exact. Two alternating sub-iterations
  delete a set pixel p when 2 ≤ B(p) ≤ 6, A(p) = 1 (01 transitions in
  the clockwise ring p2..p9,p2), and the sub-iteration's two products
  of cardinal neighbors are zero (1: p2·p4·p6 = p4·p6·p8 = 0;
  2: p2·p4·p8 = p2·p6·p8 = 0), repeated until a full double pass
  changes nothing. Borders are zero-padded. The device form is a Python
  loop of double passes that reads one flag back per pass and stops at the
  same fixed point: bit-exact with the oracle.
- anisotropic_diffusion: Perona-Malik with the exponential conduction
  g = exp(−(|∇|/K)²), 4-neighbor fluxes, zero-flux (replicate)
  borders: I ← I + α·Σ_d g(∇_d I)·∇_d I per iteration, float; u8
  callers round+clip at the end. Device float32 vs the float64 oracle
  within ±1 LSB after the final round for sane (α ≤ 0.25, K ≥ 1)
  settings.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["thinning", "thinning_numpy", "anisotropic_diffusion",
           "anisotropic_diffusion_numpy"]


# ---------------------------------------------------------------------------
# Zhang-Suen thinning
# ---------------------------------------------------------------------------

def _ring_np(m: np.ndarray):
    """p2..p9: N, NE, E, SE, S, SW, W, NW of each pixel (zero-padded)."""
    p = np.pad(m, 1)
    return [
        p[:-2, 1:-1], p[:-2, 2:], p[1:-1, 2:], p[2:, 2:],
        p[2:, 1:-1], p[2:, :-2], p[1:-1, :-2], p[:-2, :-2],
    ]


def _subpass_np(m: np.ndarray, second: bool) -> np.ndarray:
    r = _ring_np(m)
    b = sum(x.astype(np.int32) for x in r)
    ring = r + [r[0]]
    a = sum(((ring[i] == 0) & (ring[i + 1] == 1)).astype(np.int32)
            for i in range(8))
    p2, p4, p6, p8 = r[0], r[2], r[4], r[6]
    if not second:
        cond = (p2 * p4 * p6 == 0) & (p4 * p6 * p8 == 0)
    else:
        cond = (p2 * p4 * p8 == 0) & (p2 * p6 * p8 == 0)
    kill = (m == 1) & (b >= 2) & (b <= 6) & (a == 1) & cond
    return m & ~kill


def thinning_numpy(mask) -> np.ndarray:
    """Frozen Zhang-Suen spec → u8 (0/1) skeleton."""
    m = (np.asarray(mask) != 0).astype(np.uint8)
    while True:
        n1 = _subpass_np(m, False)
        n2 = _subpass_np(n1, True)
        if np.array_equal(n2, m):
            return n2
        m = n2


def _ring_t(m: torch.Tensor):
    p = F.pad(m, (1, 1, 1, 1))
    return [
        p[:-2, 1:-1], p[:-2, 2:], p[1:-1, 2:], p[2:, 2:],
        p[2:, 1:-1], p[2:, :-2], p[1:-1, :-2], p[:-2, :-2],
    ]


def _subpass_t(m: torch.Tensor, second: bool) -> torch.Tensor:
    r = _ring_t(m)
    b = sum(x.to(torch.int32) for x in r)
    ring = r + [r[0]]
    a = sum(((ring[i] == 0) & (ring[i + 1] == 1)).to(torch.int32)
            for i in range(8))
    p2, p4, p6, p8 = r[0], r[2], r[4], r[6]
    if not second:
        cond = (p2 * p4 * p6 == 0) & (p4 * p6 * p8 == 0)
    else:
        cond = (p2 * p4 * p8 == 0) & (p2 * p6 * p8 == 0)
    kill = (m == 1) & (b >= 2) & (b <= 6) & (a == 1) & cond
    return m & (~kill).to(torch.uint8)


def thinning_passes(mask: torch.Tensor):
    """(skeleton u8 (0/1), double passes run): the Zhang-Suen loop until a
    double pass changes nothing (that last pass included)."""
    m = (mask != 0).to(torch.uint8)
    if m.ndim != 2:
        raise ValueError("thinning expects a 2-D mask")
    passes = 0
    while True:
        nxt = _subpass_t(_subpass_t(m, False), True)
        passes += 1
        if torch.equal(nxt, m):  # one flag read back per double pass
            return nxt, passes
        m = nxt


def thinning(mask: torch.Tensor) -> torch.Tensor:
    """Skeletonize a binary mask (OpenCV ximgproc ``thinning``
    THINNING_ZHANGSUEN role) → u8 (0/1) tensor on the mask's device,
    bit-exact vs :func:`thinning_numpy`."""
    return thinning_passes(mask)[0]


# ---------------------------------------------------------------------------
# Perona-Malik anisotropic diffusion
# ---------------------------------------------------------------------------

def anisotropic_diffusion_numpy(img, alpha: float = 0.15, k: float = 20.0,
                                niters: int = 10) -> np.ndarray:
    """Frozen Perona-Malik spec (f64). u8 in → u8 out (round+clip);
    float in → float64 out. Channels diffuse independently."""
    a = np.asarray(img)
    was_u8 = a.dtype == np.uint8
    x = a.astype(np.float64)
    chans = x[None] if x.ndim == 2 else np.moveaxis(x, -1, 0)
    out = []
    for c in chans:
        cur = c
        for _ in range(niters):
            p = np.pad(cur, 1, mode="edge")
            dn = p[:-2, 1:-1] - cur
            ds = p[2:, 1:-1] - cur
            de = p[1:-1, 2:] - cur
            dw = p[1:-1, :-2] - cur
            flux = sum(np.exp(-(d / k) ** 2) * d for d in (dn, ds, de, dw))
            cur = cur + alpha * flux
        out.append(cur)
    y = out[0] if x.ndim == 2 else np.stack(out, axis=-1)
    if was_u8:
        return np.clip(np.floor(y + 0.5), 0, 255).astype(np.uint8)
    return y


def _replicate1(x: torch.Tensor) -> torch.Tensor:
    """(H, W, C) → (H+2, W+2, C), edges replicated."""
    h, w = x.shape[0], x.shape[1]
    rows = torch.arange(-1, h + 1, device=x.device).clamp(0, h - 1)
    cols = torch.arange(-1, w + 1, device=x.device).clamp(0, w - 1)
    return x.index_select(0, rows).index_select(1, cols)


def anisotropic_diffusion(img: torch.Tensor, alpha: float = 0.15, k: float = 20.0,
                          niters: int = 10) -> torch.Tensor:
    """Perona-Malik diffusion (OpenCV ximgproc ``anisotropicDiffusion``
    role) in float32 on the tensor's device; u8 in → u8 out. Oracle:
    :func:`anisotropic_diffusion_numpy` (within ±1 LSB)."""
    was_u8 = img.dtype == torch.uint8
    cur = img.to(torch.float32)
    squeeze = cur.ndim == 2
    if squeeze:
        cur = cur[..., None]
    a = float(np.float32(alpha))
    kk = torch.tensor(k, dtype=torch.float32, device=cur.device)
    for _ in range(int(niters)):
        p = _replicate1(cur)
        dn = p[:-2, 1:-1] - cur
        ds = p[2:, 1:-1] - cur
        de = p[1:-1, 2:] - cur
        dw = p[1:-1, :-2] - cur
        flux = sum(torch.exp(-((d / kk) ** 2)) * d for d in (dn, ds, de, dw))
        cur = cur + a * flux
    y = cur[..., 0] if squeeze else cur
    if was_u8:
        return torch.floor(y + 0.5).clamp(0, 255).to(torch.uint8)
    return y
