"""Discrete transforms (port of ``rustcv_tpu.ops.transform``; OpenCV
``dct`` / ``idct`` / ``dft`` / ``idft`` / ``mulSpectrums`` /
``getOptimalDFTSize`` roles).

The 2-D orthonormal DCT-II is two products with the float64-built cosine
basis (``B @ A @ Bᵀ``) in full float32 (:func:`.tensors.full_f32`). The
DFT is ``torch.fft`` (cuFFT on the card); the reference formed its
``dft2_planes`` as basis matmuls only because its chip had no FFT. The
float64 oracle :func:`dct_numpy` is the reference's.

Frozen spec:
- dct: orthonormal DCT-II, ``C[k, n] = s_k·cos(π(2n+1)k / 2N)`` with
  ``s_0 = √(1/N)``, ``s_k = √(2/N)`` (OpenCV's normalization); idct is
  the exact transpose (DCT-III);
- 1-D inputs (row/column vectors) transform along their single
  non-unit axis, matching OpenCV;
- mulSpectrums: elementwise complex product, optional conjugation of B;
- getOptimalDFTSize: smallest 5-smooth (2^a·3^b·5^c) integer ≥ n.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .tensors import as_tensor, full_f32


@lru_cache(maxsize=32)
def _dct_basis(n: int) -> np.ndarray:
    """Orthonormal DCT-II basis (float64): row k = frequency k."""
    k = np.arange(n)[:, None].astype(np.float64)
    m = np.arange(n)[None, :].astype(np.float64)
    b = np.cos(np.pi * (2.0 * m + 1.0) * k / (2.0 * n))
    b *= np.sqrt(2.0 / n)
    b[0] *= np.sqrt(0.5)
    return b


@lru_cache(maxsize=32)
def _dct_basis_on(n: int, device: str) -> torch.Tensor:
    return torch.as_tensor(_dct_basis(n), dtype=torch.float32, device=device)


def dct_numpy(a: np.ndarray, inverse: bool = False) -> np.ndarray:
    """Oracle — float64. 2-D arrays transform both axes; 1-row/1-col
    arrays transform their long axis only (OpenCV semantics)."""
    a = np.asarray(a, np.float64)
    if a.ndim != 2:
        raise ValueError("dct expects a 2-D array (use shape (1, N) for 1-D)")
    h, w = a.shape
    bh, bw = _dct_basis(h), _dct_basis(w)
    if inverse:
        bh, bw = bh.T, bw.T
    if h == 1:
        return a @ bw.T
    if w == 1:
        return bh @ a
    return bh @ a @ bw.T


def dct(a: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """Float32 basis products on the tensor's device (a numpy array goes to
    the card, as the reference's jitted ``dct`` sends it to its device);
    full float32 there: TF32 would be off by about 1e-3 of the range."""
    a = as_tensor(a).to(torch.float32)
    if a.ndim != 2:
        raise ValueError("dct expects a 2-D array (use shape (1, N) for 1-D)")
    h, w = a.shape
    dev = str(a.device)
    bh, bw = _dct_basis_on(h, dev), _dct_basis_on(w, dev)
    if inverse:
        bh, bw = bh.T, bw.T
    with full_f32(a.device):
        if h == 1:
            return a @ bw.T
        if w == 1:
            return bh @ a
        return (bh @ a) @ bw.T


def idct(a, **kw):
    """OpenCV ``idct``: the inverse orthonormal transform."""
    if isinstance(a, np.ndarray):
        return dct_numpy(a, inverse=True)
    return dct(a, inverse=True)


def mul_spectrums(a, b, conj_b: bool = False):
    """Elementwise complex spectrum product (OpenCV ``mulSpectrums``
    role, complex-array form). Works on numpy arrays or tensors."""
    if isinstance(a, np.ndarray):
        return a * (np.conj(b) if conj_b else b)
    return a * (torch.conj(b) if conj_b else b)


def _as_fft_input(a: torch.Tensor) -> torch.Tensor:
    return a if a.is_floating_point() or a.is_complex() else a.to(torch.float32)


def dft(a):
    """2-D forward DFT → complex (OpenCV ``dft`` complex-output role)."""
    if isinstance(a, np.ndarray):
        return np.fft.fft2(a)
    return torch.fft.fft2(_as_fft_input(a))


def idft(a, scale: bool = True):
    """2-D inverse DFT (complex). ``scale=False`` matches OpenCV's
    unnormalized default; True divides by N (DFT_SCALE)."""
    if isinstance(a, np.ndarray):
        out = np.fft.ifft2(a)
        if not scale:
            out = out * a.shape[0] * a.shape[1]
        return out
    return torch.fft.ifft2(_as_fft_input(a), norm="backward" if scale else "forward")


def dft2_planes(x: torch.Tensor):
    """2-D forward DFT over the last two axes of a real tensor as
    (re, im) float32 planes (leading axes batch): cuFFT on the card."""
    f = torch.fft.fft2(x.to(torch.float32))
    return f.real.contiguous(), f.imag.contiguous()


def idft2_planes(re: torch.Tensor, im: torch.Tensor, scale: bool = True):
    """Inverse of :func:`dft2_planes` on (re, im) planes (``scale``
    divides by H·W; leading axes batch). Returns (re, im)."""
    out = torch.fft.ifft2(torch.complex(re, im), norm="backward" if scale else "forward")
    return out.real.contiguous(), out.imag.contiguous()


def mul_spectrums_planes(a, b, conj_b: bool = False):
    """:func:`mul_spectrums` on (re, im) plane pairs."""
    ar, ai = a
    br, bi = b
    if conj_b:
        bi = -bi
    return ar * br - ai * bi, ar * bi + ai * br


def get_optimal_dft_size(n: int) -> int:
    """Smallest 5-smooth integer ≥ n (OpenCV ``getOptimalDFTSize``)."""
    if n <= 0:
        raise ValueError("n must be positive")
    best = None
    p2 = 1
    while p2 < 2 * n:
        p23 = p2
        while p23 < 2 * n:
            p235 = p23
            while p235 < n:
                p235 *= 5
            if best is None or p235 < best:
                best = p235
            p23 *= 3
        p2 *= 2
    return best
