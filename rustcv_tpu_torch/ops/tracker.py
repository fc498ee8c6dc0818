"""MOSSE correlation-filter tracking (port of ``rustcv_tpu.ops.tracker``;
OpenCV ``legacy::TrackerMOSSE`` role, Bolme et al. 2010; spec frozen in
:mod:`.golden`).

A tracking step (:func:`step`) is a clamped crop (an index gather from
origin tensors, no host read) → preprocess → ``torch.fft`` → correlate
with the filter → peak + PSR → re-crop at the new centre → blended filter
update, all gated on the PSR threshold with ``torch.where``. The state
(A, B, centre) stays on its device between frames.

Banks: every state field has a leading bank axis, and a lone tracker is a
bank of one, so N same-window-size objects track in one batch of kernels
(the reference vmaps its functional core for this). :func:`init` takes
one bbox or N of one size; :func:`step` takes one gray frame that every
tracker of the bank reads, or N frames, one each.

Tolerance contract (the reference's): float32 against the float64 golden;
the integer peak trajectory matches, the response peak and PSR within
5e-3.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from . import golden
from .tensors import as_tensor

__all__ = ["MosseState", "init", "step", "TrackerMOSSE"]


class MosseState(NamedTuple):
    """Tracker-bank state on the device, every field with a leading bank
    axis N."""

    a_re: torch.Tensor     # float32 [N, h, w] filter numerator
    a_im: torch.Tensor     # float32 [N, h, w]
    b: torch.Tensor        # float32 [N, h, w] filter denominator
    g_re: torch.Tensor     # float32 [N, h, w] desired-response spectrum
    g_im: torch.Tensor     # float32 [N, h, w]
    center: torch.Tensor   # int64 [N, 2] (cy, cx)


def _hann(h: int, w: int, device) -> torch.Tensor:
    def hann1(n):
        if n == 1:
            return torch.ones(1, dtype=torch.float32, device=device)
        k = torch.arange(n, dtype=torch.float32, device=device)
        return 0.5 - 0.5 * torch.cos(2.0 * np.pi * k / (n - 1))
    return torch.outer(hann1(h), hann1(w))


def _bboxes(bbox) -> np.ndarray:
    """One (x, y, w, h) or N of them → int64 [N, 4]; one size for all."""
    b = np.asarray(bbox, np.int64).reshape(-1, 4)
    if len(b) == 0 or (b[:, 2:] != b[0, 2:]).any():
        raise ValueError("a bank tracks boxes of one size")
    return b


def _crop(frame: torch.Tensor, cy: torch.Tensor, cx: torch.Tensor, h: int, w: int):
    """Clamped h×w crops centred at (cy, cx) [N] of a frame (H, W) that
    the bank shares or of frames (N, H, W): an index gather from the
    clamped origins (no host read) → (patches [N, h, w], oy, ox)."""
    fh, fw = frame.shape[-2:]
    oy = torch.clamp(cy - h // 2, 0, fh - h)
    ox = torch.clamp(cx - w // 2, 0, fw - w)
    rows = (oy[:, None] + torch.arange(h, device=frame.device))[:, :, None]
    cols = (ox[:, None] + torch.arange(w, device=frame.device))[:, None, :]
    if frame.ndim == 2:
        return frame[rows, cols], oy, ox
    n = torch.arange(frame.shape[0], device=frame.device)[:, None, None]
    return frame[n, rows, cols], oy, ox


def _argmax2(r: torch.Tensor):
    """Per bank member: (py, px) of the first maximum of r [N, h, w]."""
    w = r.shape[-1]
    flat = torch.argmax(r.reshape(r.shape[0], -1), dim=1)
    return flat // w, flat % w


def _at(r: torch.Tensor, py: torch.Tensor, px: torch.Tensor) -> torch.Tensor:
    return r[torch.arange(r.shape[0], device=r.device), py, px]


def _preprocess(patch: torch.Tensor) -> torch.Tensor:
    """log1p, zero mean / unit std over each patch, Hann window."""
    p = torch.log1p(patch.to(torch.float32))
    mean = p.mean(dim=(-2, -1), keepdim=True)
    std = p.std(dim=(-2, -1), keepdim=True, correction=0)
    return (p - mean) / (std + golden.MOSSE_EPS) * _hann(*p.shape[-2:], p.device)


def _gauss(h: int, w: int, device) -> torch.Tensor:
    ys = (torch.arange(h, device=device) - h // 2).to(torch.float32)[:, None]
    xs = (torch.arange(w, device=device) - w // 2).to(torch.float32)[None, :]
    return torch.exp(-(ys ** 2 + xs ** 2) / (2.0 * golden.MOSSE_SIGMA ** 2))


def _init_core(frame: torch.Tensor, cy, cx, h: int, w: int) -> MosseState:
    dev = frame.device
    patch = _crop(frame, cy, cx, h, w)[0].to(torch.float32)          # [N, h, w]
    # all 8 perturbation warps share one sampling grid: four bilinear taps
    # at clamped integer coordinates
    angs = torch.tensor([a for a, _ in golden.MOSSE_WARPS], dtype=torch.float32, device=dev)
    scs = torch.tensor([s for _, s in golden.MOSSE_WARPS], dtype=torch.float32, device=dev)
    c = (torch.cos(angs) / scs)[:, None, None]                        # [P, 1, 1]
    s = (torch.sin(angs) / scs)[:, None, None]
    cyf, cxf = (h - 1) / 2.0, (w - 1) / 2.0
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None] - cyf
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :] - cxf
    sx = c * xs + s * ys + cxf                                        # [P, h, w]
    sy = -s * xs + c * ys + cyf
    x0 = torch.clamp(torch.floor(sx), 0, w - 1).to(torch.int64)
    y0 = torch.clamp(torch.floor(sy), 0, h - 1).to(torch.int64)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    fx = torch.clamp(sx - x0, 0.0, 1.0)
    fy = torch.clamp(sy - y0, 0.0, 1.0)
    top = patch[:, y0, x0] * (1 - fx) + patch[:, y0, x1] * fx
    bot = patch[:, y1, x0] * (1 - fx) + patch[:, y1, x1] * fx
    warped = top * (1 - fy) + bot * fy                                # [N, P, h, w]

    f = torch.fft.fft2(_preprocess(warped))
    g = torch.fft.fft2(_gauss(h, w, dev))
    fr, fi, gr, gi = f.real, f.imag, g.real, g.imag
    # A = Σ_p G · conj(F_p); B = Σ_p |F_p|²
    a_re = (gr * fr + gi * fi).sum(1)
    a_im = (gi * fr - gr * fi).sum(1)
    b = (fr * fr + fi * fi).sum(1)
    n = patch.shape[0]
    return MosseState(a_re, a_im, b, gr.expand(n, h, w).contiguous(),
                      gi.expand(n, h, w).contiguous(), torch.stack([cy, cx], 1))


def init(frame, bbox) -> MosseState:
    """Train filters on ``bbox`` = (x, y, w, h), or on N boxes of one
    size, of a gray frame (u8 or float): a tensor stays on its device, a
    numpy array goes to the card. Returns a bank of N (a lone box: N = 1)."""
    b = _bboxes(bbox)
    w, h = int(b[0, 2]), int(b[0, 3])
    if h < 4 or w < 4:
        raise ValueError("MOSSE window must be at least 4x4")
    f = as_tensor(frame)
    cy = torch.as_tensor(b[:, 1] + h // 2, device=f.device)
    cx = torch.as_tensor(b[:, 0] + w // 2, device=f.device)
    return _init_core(f, cy, cx, h, w)


def step(state: MosseState, frame, lr: float = 0.2,
         psr_threshold: float = 5.7):
    """One tracking step of the bank on a gray frame (H, W) or frames
    (N, H, W) → (new_state, ok bool [N], psr float32 [N]), device tensors:
    read them only when the host needs the verdict."""
    f = as_tensor(frame, state.center.device)
    n, h, w = state.g_re.shape
    cy, cx = state.center[:, 0], state.center[:, 1]
    patch, oy, ox = _crop(f, cy, cx, h, w)
    fz = torch.fft.fft2(_preprocess(patch))
    fr, fi = fz.real, fz.imag
    inv_b = 1.0 / (state.b + golden.MOSSE_EPS)
    rr = (fr * state.a_re - fi * state.a_im) * inv_b
    ri = (fr * state.a_im + fi * state.a_re) * inv_b
    resp = torch.fft.ifft2(torch.complex(rr, ri)).real
    py, px = _argmax2(resp)

    # PSR over the sidelobe: everything outside the 11×11 square at the peak
    ys = torch.arange(h, device=f.device)[None, :, None]
    xs = torch.arange(w, device=f.device)[None, None, :]
    excl = ((ys - py[:, None, None]).abs() <= 5) & ((xs - px[:, None, None]).abs() <= 5)
    n_side = (h * w - excl.sum(dim=(1, 2))).to(torch.float32)
    side_mean = torch.where(excl, 0.0, resp).sum(dim=(1, 2)) / n_side
    side_var = torch.where(excl, 0.0, (resp - side_mean[:, None, None]) ** 2).sum(
        dim=(1, 2)) / n_side
    peak = _at(resp, py, px)
    psr = (peak - side_mean) / (torch.sqrt(side_var) + golden.MOSSE_EPS)
    ok = psr >= psr_threshold

    fh, fw = f.shape[-2:]
    ncy = torch.where(ok, torch.clamp(oy + py, h // 2, fh - h + h // 2), cy)
    ncx = torch.where(ok, torch.clamp(ox + px, w // 2, fw - w + w // 2), cx)

    f2 = torch.fft.fft2(_preprocess(_crop(f, ncy, ncx, h, w)[0]))
    f2r, f2i = f2.real, f2.imag
    rate = torch.where(ok, lr, 0.0).to(torch.float32)[:, None, None]
    # G · conj(F2)
    na_re = state.g_re * f2r + state.g_im * f2i
    na_im = state.g_im * f2r - state.g_re * f2i
    new = MosseState(rate * na_re + (1.0 - rate) * state.a_re,
                     rate * na_im + (1.0 - rate) * state.a_im,
                     rate * (f2r * f2r + f2i * f2i) + (1.0 - rate) * state.b,
                     state.g_re, state.g_im, torch.stack([ncy, ncx], 1))
    return new, ok, psr


def gray_of(image, device="cuda"):
    """The gray plane a tracker reads, as a tensor: a Mat's (its device
    tensor, or its host bytes on its target device), a tensor's (where it
    is) or an array's (on ``device``); BGR converts by the exact luma."""
    a = image
    if hasattr(a, "to_numpy"):  # Mat
        a = a.device() if a.is_on_device else torch.as_tensor(a.to_numpy(), device=a.target)
    a = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a), device=device)
    if a.ndim == 3 and a.shape[-1] == 1:
        return a[..., 0]
    if a.ndim == 3:
        from .color import bgr_to_gray

        return bgr_to_gray(a)
    return a


def gray_of_host(image) -> np.ndarray:
    """The gray plane as numpy, for the float64 host backends; BGR converts
    by golden.bgr_to_gray (the same integer luma)."""
    a = image.to_numpy() if hasattr(image, "to_numpy") else image
    a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    if a.ndim == 3 and a.shape[-1] == 1:
        return a[..., 0]
    return golden.bgr_to_gray(a) if a.ndim == 3 else a


def read_verdict(ok: torch.Tensor, score: torch.Tensor, center: torch.Tensor):
    """(ok, score, cy, cx) of a bank of one, in one host read."""
    v = torch.stack([ok[0].to(torch.float64), score[0].to(torch.float64),
                     center[0, 0].to(torch.float64), center[0, 1].to(torch.float64)]).cpu()
    return bool(v[0]), float(v[1]), int(v[2]), int(v[3])


class TrackerMOSSE:
    """OpenCV legacy tracker API: ``init(image, bbox)`` then
    ``ok, bbox = update(image)``; bbox = (x, y, w, h). ``backend="host"``
    runs the float64 golden spec; ``backend="device"`` (default) runs the
    float32 twin with its state on the first image's device (a numpy image
    goes to the card, a host Mat to its target), and reads ``ok`` and the
    PSR once per frame."""

    def __init__(self, learning_rate: float = 0.2,
                 psr_threshold: float = 5.7, backend: str = "device"):
        if backend not in ("device", "host"):
            raise ValueError(backend)
        self.learning_rate = float(learning_rate)
        self.psr_threshold = float(psr_threshold)
        self.backend = backend
        self._state = None
        self._size: Tuple[int, int] = (0, 0)
        self.last_psr = float("nan")

    def init(self, image, bbox) -> None:
        x, y, w, h = (int(v) for v in bbox)
        self._size = (h, w)
        if self.backend == "host":
            self._state = golden.mosse_init(gray_of_host(image), (x, y, w, h))
        else:
            self._state = init(gray_of(image), (x, y, w, h))

    def update(self, image):
        if self._state is None:
            raise RuntimeError("call init() first")
        if self.backend == "host":
            self._state, ok, psr = golden.mosse_step(
                self._state, gray_of_host(image), lr=self.learning_rate,
                psr_threshold=self.psr_threshold)
            cy, cx = self._state["center"]
        else:
            self._state, ok_d, psr_d = step(
                self._state, gray_of(image, self._state.center.device), lr=self.learning_rate,
                psr_threshold=self.psr_threshold)
            ok, psr, cy, cx = read_verdict(ok_d, psr_d, self._state.center)
        self.last_psr = float(psr)
        h, w = self._size
        return bool(ok), (cx - w // 2, cy - h // 2, w, h)
