"""Global translation registration via phase correlation (port of
``rustcv_tpu.ops.registration``; the OpenCV ``phaseCorrelate`` role).

Two ``rfft2``s, a normalized cross-power spectrum and one ``irfft2``
(cuFFT on the card), then the peak and a 3×3 weighted centroid read with
wrapped indices, all on the tensor's device with no host read.

Frozen spec:
- inputs promoted to float32; optional Hann window (the outer product of
  per-axis Hann, periodic=False convention: 0.5 − 0.5 cos(2πi/(n−1)));
- R = F1 · conj(F2) / max(|F1 · conj(F2)|, eps), eps = 1e-12; r =
  irfft2(R) (real response);
- peak = the first maximum of r in raster order; shift components mapped
  to the signed range (± N/2);
- sub-pixel: 3×3 weighted centroid around the peak on max(r, 0) values,
  weights renormalized within the window;
- sign convention: ``phase_correlate(prev, next)`` returns (dx, dy) such
  that next(p) ≈ prev(p − d), i.e. content moved by +d from prev to
  next — the same convention as the dense/sparse flow ops.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _hann(n: int) -> np.ndarray:
    if n == 1:
        return np.ones(1, np.float32)
    i = np.arange(n, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * i / (n - 1))).astype(np.float32)


def _windowed(prev: torch.Tensor, next: torch.Tensor, window: bool):
    h, w = prev.shape
    f1 = prev.to(torch.float32)
    f2 = next.to(torch.float32).to(f1.device)
    if window:
        win = torch.as_tensor(np.outer(_hann(h), _hann(w)), device=f1.device)
        f1 = f1 * win
        f2 = f2 * win
    return f1, f2


def phase_correlate(
    prev: torch.Tensor, next: torch.Tensor, window: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(H, W) pair → ((dx, dy) float32, response float32 peak value in
    [0, 1]-ish; higher = more confident), on the inputs' device."""
    h, w = prev.shape
    f1, f2 = _windowed(prev, next, window)
    x = torch.conj(torch.fft.rfft2(f1)) * torch.fft.rfft2(f2)
    r = torch.fft.irfft2(x / torch.clamp(torch.abs(x), min=1e-12), s=(h, w))
    return _peak_refine(r, h, w)


def _peak_refine(r: torch.Tensor, h: int, w: int):
    """The peak (lowest flat index among equal maxima, as ``argmax``) and
    its 3×3 weighted centroid; the window wraps around the borders."""
    flat = r.reshape(-1)
    idx = torch.arange(h * w, device=r.device)
    peak = torch.where(flat == flat.max(), idx, h * w).min()
    py = peak // w
    px = peak % w
    off = torch.arange(-1, 2, device=r.device)
    win3 = r[((py + off) % h)[:, None], ((px + off) % w)[None, :]]
    win3 = torch.clamp(win3, min=0.0)
    tot = torch.clamp(win3.sum(), min=1e-12)
    offf = off.to(torch.float32)
    cy = (win3 * offf[:, None]).sum() / tot
    cx = (win3 * offf[None, :]).sum() / tot
    sx = torch.where(px > w // 2, px - w, px).to(torch.float32) + cx
    sy = torch.where(py > h // 2, py - h, py).to(torch.float32) + cy
    return torch.stack([sx, sy]), flat[peak]


def phase_correlate_matmul(
    prev: torch.Tensor, next: torch.Tensor, window: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's FFT-free twin of :func:`phase_correlate` (its
    spectra were basis matmuls); here the full complex spectra come from
    :func:`.transform.dft2_planes` on ``torch.fft``. Same frozen spec,
    same peak refinement."""
    from .transform import dft2_planes, idft2_planes

    h, w = prev.shape
    f1, f2 = _windowed(prev, next, window)
    a_re, a_im = dft2_planes(f1)
    b_re, b_im = dft2_planes(f2)
    # X = conj(F1) · F2
    x_re = a_re * b_re + a_im * b_im
    x_im = a_re * b_im - a_im * b_re
    mag = torch.clamp(torch.sqrt(x_re * x_re + x_im * x_im), min=1e-12)
    r, _ = idft2_planes(x_re / mag, x_im / mag, scale=True)
    return _peak_refine(r, h, w)


def phase_correlate_numpy(
    prev: np.ndarray, next: np.ndarray, window: bool = True
) -> Tuple[np.ndarray, float]:
    """Oracle — same frozen spec in float64."""
    h, w = prev.shape
    f1 = prev.astype(np.float64)
    f2 = next.astype(np.float64)
    if window:
        win = np.outer(_hann(h).astype(np.float64), _hann(w).astype(np.float64))
        f1, f2 = f1 * win, f2 * win
    X = np.conj(np.fft.rfft2(f1)) * np.fft.rfft2(f2)
    R = X / np.maximum(np.abs(X), 1e-12)
    r = np.fft.irfft2(R, s=(h, w))
    py, px = np.unravel_index(int(np.argmax(r)), r.shape)
    rc = np.roll(np.roll(r, h // 2 - py, axis=0), w // 2 - px, axis=1)
    win3 = np.maximum(rc[h // 2 - 1 : h // 2 + 2, w // 2 - 1 : w // 2 + 2], 0.0)
    tot = max(win3.sum(), 1e-12)
    off = np.arange(-1, 2, dtype=np.float64)
    cy = float((win3 * off[:, None]).sum() / tot)
    cx = float((win3 * off[None, :]).sum() / tot)
    sx = (px - w if px > w // 2 else px) + cx
    sy = (py - h if py > h // 2 else py) + cy
    return np.array([sx, sy], np.float32), float(r[py, px])


def phase_correlate_iterative(prev: np.ndarray, next: np.ndarray,
                              max_iters: int = 5,
                              window: bool = True
                              ) -> Tuple[np.ndarray, float]:
    """Iterative sub-pixel refinement of phase correlation (OpenCV
    ``phaseCorrelateIterative`` role, Hrazdíra 2020): after each
    estimate, the measured shift is cancelled with an exact Fourier
    phase ramp and the residual re-measured; the accumulated shift
    converges well below the single-pass centroid bias. →
    ((dx, dy) float32, response of the first pass). Host float64."""
    h, w = prev.shape
    f2 = np.asarray(next, np.float64)
    total = np.zeros(2)
    resp = 0.0
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.rfftfreq(w)[None, :]
    spec2 = np.fft.rfft2(f2 * (np.outer(_hann(h), _hann(w))
                               if window else 1.0))
    for it in range(max_iters):
        # shift src2 BACK by the accumulated estimate (phase ramp)
        ramp = np.exp(2j * np.pi * (fx * total[0] + fy * total[1]))
        shifted = np.fft.irfft2(spec2 * ramp, s=(h, w))
        d, r = phase_correlate_numpy(np.asarray(prev, np.float64),
                                     shifted, window=window)
        if it == 0:
            resp = r
        total += d
        if np.hypot(d[0], d[1]) < 5e-3:
            break
    return total.astype(np.float32), float(resp)
