"""Template matching (port of ``rustcv_tpu.ops.template``; OpenCV
``matchTemplate`` parity for the common methods).

- Templates under 256 px of area: the cross-correlation is one float32
  ``conv2d`` (cuDNN on the card, in full float32: :func:`.tensors.full_f32`);
- larger templates: FFT cross-correlation, ``irfft2(rfft2(img) ·
  conj(rfft2(zero-padded template)))`` (cuFFT), whose circular wrap only
  touches indices outside the valid output region;
- window statistics (Σ W, Σ W²): int64 integral images and 4-corner
  differences, exact at every size (the reference's uint32 form relies on
  wraparound);
- the correlation takes the image less its integer mean c (exact in
  float32): Σ T·W = Σ T·(W − c) + c·Σ T, and Σ T′ = 0 for ``ccoeff_normed``.
  A float32 FFT's rounding grows with the energy of its input, which the
  mean dominates; uncentred, the 24×24 ``ccoeff_normed`` map of a 1080p
  test pattern sits 2.6e-6 to 8.5e-5 off the float64 oracle, depending
  on the FFT library's code path, against 1e-6 centred.

Frozen spec (float32 device / float64 oracle :func:`match_template_numpy`,
tolerance-tested):

- ``ccoeff_normed``: R = Σ(T′·W) / √(ΣT′² · Σ(W−mean(W))²) with
  T′ = T − mean(T); degenerate windows (zero variance on either side) → 0.
- ``ccorr_normed``:  R = Σ(T·W) / √(ΣT² · ΣW²); zero denominators → 0.
- ``sqdiff``:        R = Σ(T−W)² = ΣT² − 2Σ(T·W) + ΣW². Accuracy is
  relative to the response scale; peak locations are unaffected.

Output shape (H−th+1, W−tw+1), peak (ccoeff/ccorr: max; sqdiff: min) at
the template's top-left corner.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .tensors import full_f32

METHODS = ("ccoeff_normed", "ccorr_normed", "sqdiff")

# Templates with area ≥ this go through the FFT route (the conv's work
# scales with the template's area; the FFT's does not).
FFT_AREA_THRESHOLD = 256


def _window_sums(img_u8: torch.Tensor, th: int, tw: int):
    """Exact (Σ W, Σ W²) of every valid window from int64 integral images,
    as float32 maps."""
    a = img_u8.to(torch.int64)

    def win(x):
        ii = F.pad(x.cumsum(0).cumsum(1), (1, 0, 1, 0))
        s = ii[th:, tw:] - ii[:-th, tw:] - ii[th:, :-tw] + ii[:-th, :-tw]
        return s.to(torch.float32)

    return win(a), win(a * a)


def _conv_cross(a_f32: torch.Tensor, t_f32: torch.Tensor) -> torch.Tensor:
    """Valid-region Σ T·W as one single-channel correlation."""
    with full_f32(a_f32.device):
        return F.conv2d(a_f32[None, None], t_f32[None, None])[0, 0]


def _fft_cross(a_f32: torch.Tensor, t_f32: torch.Tensor) -> torch.Tensor:
    """Valid-region Σ T·W via FFT. The template is zero-padded to the image
    size; circular wraparound only reaches output rows/cols beyond the valid
    (H−th+1, W−tw+1) region, which are sliced away."""
    h, w = a_f32.shape
    th, tw = t_f32.shape
    spec = torch.fft.rfft2(a_f32) * torch.conj(torch.fft.rfft2(t_f32, s=(h, w)))
    full = torch.fft.irfft2(spec, s=(h, w))
    return full[: h - th + 1, : w - tw + 1]


def match_template(
    img: torch.Tensor, tmpl: torch.Tensor, method: str = "ccoeff_normed"
) -> torch.Tensor:
    """u8 grayscale image (H, W) × template (th, tw) → float32 response map
    (H−th+1, W−tw+1) on the image's device. The route (conv or FFT) follows
    the template's area; both meet the same tolerance against the float64
    oracle."""
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r} (one of {METHODS})")
    tmpl = tmpl.to(img.device)
    c = (img.sum(dtype=torch.int64) // img.numel()).to(torch.float32)  # no host sync
    a = img.to(torch.float32) - c
    t = tmpl.to(torch.float32)
    th, tw = t.shape
    n = float(th * tw)
    cross_fn = _fft_cross if th * tw >= FFT_AREA_THRESHOLD else _conv_cross

    s1, s2 = _window_sums(img, th, tw)
    if method == "sqdiff":
        return s2 - 2.0 * (cross_fn(a, t) + c * torch.sum(t)) + torch.sum(t * t)
    if method == "ccorr_normed":
        denom = torch.sqrt(s2 * torch.sum(t * t))
        cross = cross_fn(a, t) + c * torch.sum(t)
        return torch.where(denom > 0, cross / torch.clamp(denom, min=1e-20), 0.0)
    # ccoeff_normed: Σ T′ = 0, so the T′ correlation of the centred image
    # is that of the image.
    tp = t - torch.mean(t)
    win_var = s2 - s1 * s1 / n  # Σ(W − mean W)²
    denom = torch.sqrt(torch.clamp(win_var, min=0.0) * torch.sum(tp * tp))
    return torch.where(denom > 1e-6, cross_fn(a, tp) / torch.clamp(denom, min=1e-20), 0.0)


def min_max_loc(resp) -> Tuple[float, float, Tuple[int, int], Tuple[int, int]]:
    """(min_val, max_val, (min_x, min_y), (max_x, max_y)) of a 2-D response
    (OpenCV ``minMaxLoc``; locations are (x, y), the first extremum in raster
    order). A tensor is reduced on its device and read back once."""
    if isinstance(resp, torch.Tensor):
        w = resp.shape[1]
        flat = resp.reshape(-1)
        idx = torch.arange(flat.numel(), device=flat.device)
        mn, mx = flat.min(), flat.max()
        imin = torch.where(flat == mn, idx, flat.numel()).min()
        imax = torch.where(flat == mx, idx, flat.numel()).min()
        v = torch.stack([mn.double(), mx.double(), imin.double(), imax.double()]).cpu().tolist()
        imin, imax = int(v[2]), int(v[3])
        return v[0], v[1], (imin % w, imin // w), (imax % w, imax // w)
    a = np.asarray(resp)
    imin = int(np.argmin(a))
    imax = int(np.argmax(a))
    w = a.shape[1]
    return (
        float(a.flat[imin]),
        float(a.flat[imax]),
        (imin % w, imin // w),
        (imax % w, imax // w),
    )


# ---------------------------------------------------------------------------
# NumPy oracle (float64)
# ---------------------------------------------------------------------------


def match_template_numpy(
    img: np.ndarray, tmpl: np.ndarray, method: str = "ccoeff_normed"
) -> np.ndarray:
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}")
    a = img.astype(np.float64)
    t = tmpl.astype(np.float64)
    th, tw = t.shape
    win = np.lib.stride_tricks.sliding_window_view(a, (th, tw))
    n = th * tw
    if method == "sqdiff":
        return np.einsum("hwij,hwij->hw", win - t, win - t)
    if method == "ccorr_normed":
        cross = np.einsum("hwij,ij->hw", win, t)
        denom = np.sqrt(np.einsum("hwij,hwij->hw", win, win) * np.sum(t * t))
        return np.where(denom > 0, cross / np.maximum(denom, 1e-300), 0.0)
    tp = t - t.mean()
    cross = np.einsum("hwij,ij->hw", win, tp)
    s1 = np.einsum("hwij->hw", win)
    s2 = np.einsum("hwij,hwij->hw", win, win)
    win_var = s2 - s1 * s1 / n
    denom = np.sqrt(np.maximum(win_var, 0.0) * np.sum(tp * tp))
    return np.where(denom > 1e-6, cross / np.maximum(denom, 1e-300), 0.0)
