"""KCF tracker (port of ``rustcv_tpu.ops.kcf``; OpenCV ``TrackerKCF``
role, Henriques et al. 2015) — kernelized correlation filter on a padded
window, gray features.

Companion to the MOSSE tracker (ops/tracker.py): the same step design (a
clamped index-gather crop, ``torch.where``-gated updates, state on the
device, a leading bank axis with a lone tracker a bank of one), plus the
Gaussian-kernel ridge regression in the Fourier domain that distinguishes
KCF. Spectra are ``torch.fft`` (cuFFT on the card); the state keeps them
as (re, im) float32 planes under the reference's field names.

Frozen spec (float64 oracle in this module):
- window = (⌊1+padding⌋×) target size: ``win = floor(target·2.5)``
  (padding 1.5), min 8 px per side;
- features: ``gray/255 − 0.5`` × Hann (the MOSSE Hann);
- regression target: unit-peak Gaussian at (h//2, w//2),
  ``σ = √(th·tw)·output_sigma_factor`` with factor 0.1 (target size,
  not window size);
- Gaussian kernel correlation:
  ``k = exp(−max(‖x‖² + ‖z‖² − 2·irfft2(x̂*·ẑ), 0) / (σ_k²·N))``,
  σ_k = 0.2, N = window pixel count;
- train: ``α̂ = ŷ / (k̂xx + λ)``, λ = 1e−4;
- detect at the OLD centre; peak of ``irfft2(k̂(x_model, z)·α̂)`` moves
  the centre (response is centred like MOSSE's: peak at (h//2, w//2) =
  no motion); confidence = peak value, ``ok = peak ≥ detect_thresh``
  (0.35); on failure the state freezes (no adaptation, centre holds);
- update: ``x_model ← (1−η)x_model + η·z``, ``α̂ ← (1−η)α̂ + η·α̂_z``
  with η = 0.075, α̂_z trained on the re-cropped patch at the new
  centre.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from . import golden
from .tensors import as_tensor
from .tracker import _argmax2, _at, _bboxes, _crop, _hann, gray_of, gray_of_host, read_verdict

__all__ = ["KcfState", "init", "step", "TrackerKCF",
           "kcf_init", "kcf_step"]

PADDING = 1.5
OUTPUT_SIGMA_FACTOR = 0.1
KERNEL_SIGMA = 0.2
LAMBDA = 1e-4
INTERP_FACTOR = 0.075
DETECT_THRESH = 0.35


# ---------------------------------------------------------------------------
# float64 oracle
# ---------------------------------------------------------------------------

def _hann_np(h: int, w: int) -> np.ndarray:
    return golden.mosse_hann(h, w)


def _features_np(patch: np.ndarray) -> np.ndarray:
    return (patch.astype(np.float64) / 255.0 - 0.5) * _hann_np(*patch.shape)


def _kernel_np(x: np.ndarray, z: np.ndarray) -> np.ndarray:
    h, w = x.shape
    n = h * w
    xf = np.fft.rfft2(x)
    zf = np.fft.rfft2(z)
    cross = np.fft.irfft2(np.conj(xf) * zf, s=(h, w))
    d = (x * x).sum() + (z * z).sum() - 2.0 * cross
    return np.exp(-np.maximum(d, 0.0) / (KERNEL_SIGMA * KERNEL_SIGMA * n))


def _win_of_target(w: int, h: int) -> Tuple[int, int]:
    return (max(int(np.floor(h * (1.0 + PADDING))), 8),
            max(int(np.floor(w * (1.0 + PADDING))), 8))


def kcf_init(frame: np.ndarray, bbox) -> dict:
    """bbox = (x, y, w, h). Returns the oracle state dict."""
    x, y, tw, th = (int(v) for v in bbox)
    if tw < 4 or th < 4:
        raise ValueError("KCF target must be at least 4x4")
    wh, ww = _win_of_target(tw, th)
    cy, cx = y + th // 2, x + tw // 2
    patch, _, _ = golden._mosse_crop(np.asarray(frame, np.float64),
                                     cy, cx, wh, ww)
    xm = _features_np(patch)
    sig = np.sqrt(tw * th) * OUTPUT_SIGMA_FACTOR
    yresp = golden.mosse_gauss(wh, ww, sig)
    yf = np.fft.rfft2(yresp)
    k = _kernel_np(xm, xm)
    alphaf = yf / (np.fft.rfft2(k) + LAMBDA)
    return {"x": xm, "alphaf": alphaf, "yf": yf, "center": (cy, cx),
            "size": (wh, ww), "target": (th, tw)}


def kcf_step(state: dict, frame: np.ndarray,
             interp_factor: float = INTERP_FACTOR,
             detect_thresh: float = DETECT_THRESH):
    """One step → (new_state, ok, peak_response)."""
    wh, ww = state["size"]
    cy, cx = state["center"]
    f = np.asarray(frame, np.float64)
    patch, oy, ox = golden._mosse_crop(f, cy, cx, wh, ww)
    z = _features_np(patch)
    k = _kernel_np(state["x"], z)
    resp = np.fft.irfft2(np.fft.rfft2(k) * state["alphaf"], s=(wh, ww))
    py, px = np.unravel_index(int(resp.argmax()), resp.shape)
    peak = float(resp[py, px])
    if peak < detect_thresh:
        return state, False, peak
    fh, fw = f.shape
    ncy = oy + wh // 2 + (int(py) - wh // 2)
    ncx = ox + ww // 2 + (int(px) - ww // 2)
    ncy = int(np.clip(ncy, wh // 2, fh - wh + wh // 2))
    ncx = int(np.clip(ncx, ww // 2, fw - ww + ww // 2))
    patch2, _, _ = golden._mosse_crop(f, ncy, ncx, wh, ww)
    z2 = _features_np(patch2)
    k2 = _kernel_np(z2, z2)
    alphaf2 = state["yf"] / (np.fft.rfft2(k2) + LAMBDA)
    eta = interp_factor
    new = {
        "x": (1 - eta) * state["x"] + eta * z2,
        "alphaf": (1 - eta) * state["alphaf"] + eta * alphaf2,
        "yf": state["yf"], "center": (ncy, ncx),
        "size": (wh, ww), "target": state["target"],
    }
    return new, True, peak


# ---------------------------------------------------------------------------
# tensor twin (float32)
# ---------------------------------------------------------------------------

class KcfState(NamedTuple):
    """Tracker-bank state on the device, every field with a leading bank
    axis N; spectra as (re, im) float32 planes."""

    x: torch.Tensor          # float32 [N, h, w] model features
    alphaf_re: torch.Tensor  # float32 [N, h, w]
    alphaf_im: torch.Tensor  # float32 [N, h, w]
    yf_re: torch.Tensor      # float32 [N, h, w]
    yf_im: torch.Tensor      # float32 [N, h, w]
    center: torch.Tensor     # int64 [N, 2] (cy, cx)


def _features(patch: torch.Tensor) -> torch.Tensor:
    return (patch.to(torch.float32) / 255.0 - 0.5) * _hann(*patch.shape[-2:], patch.device)


def _kernel(x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Gaussian kernel correlation of x and z [N, h, w]."""
    h, w = x.shape[-2:]
    cross = torch.fft.ifft2(torch.conj(torch.fft.fft2(x)) * torch.fft.fft2(z)).real
    d = ((x * x).sum(dim=(-2, -1), keepdim=True) + (z * z).sum(dim=(-2, -1), keepdim=True)
         - 2.0 * cross)
    return torch.exp(-torch.clamp(d, min=0.0) / (KERNEL_SIGMA * KERNEL_SIGMA * h * w))


def _train(yf: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """α̂ = ŷ / (k̂zz + λ), complex."""
    return yf / (torch.fft.fft2(_kernel(z, z)) + LAMBDA)


def _init_core(frame: torch.Tensor, cy, cx, wh: int, ww: int, sig: float) -> KcfState:
    xm = _features(_crop(frame, cy, cx, wh, ww)[0])
    dev = frame.device
    ys = (torch.arange(wh, device=dev) - wh // 2).to(torch.float32)[:, None]
    xs = (torch.arange(ww, device=dev) - ww // 2).to(torch.float32)[None, :]
    yf = torch.fft.fft2(torch.exp(-(ys ** 2 + xs ** 2) / (2.0 * sig * sig)))
    a = _train(yf, xm)
    n = xm.shape[0]
    return KcfState(xm, a.real, a.imag, yf.real.expand(n, wh, ww).contiguous(),
                    yf.imag.expand(n, wh, ww).contiguous(), torch.stack([cy, cx], 1))


def init(frame, bbox) -> KcfState:
    """A bank of trackers on ``bbox`` = (x, y, w, h), or N boxes of one
    size, of a gray frame: a tensor stays on its device, a numpy array
    goes to the card."""
    b = _bboxes(bbox)
    tw, th = int(b[0, 2]), int(b[0, 3])
    if tw < 4 or th < 4:
        raise ValueError("KCF target must be at least 4x4")
    wh, ww = _win_of_target(tw, th)
    sig = float(np.sqrt(tw * th) * OUTPUT_SIGMA_FACTOR)
    f = as_tensor(frame)
    cy = torch.as_tensor(b[:, 1] + th // 2, device=f.device)
    cx = torch.as_tensor(b[:, 0] + tw // 2, device=f.device)
    return _init_core(f, cy, cx, wh, ww, sig)


def step(state: KcfState, frame, interp_factor: float = INTERP_FACTOR,
         detect_thresh: float = DETECT_THRESH):
    """One tracking step of the bank on a gray frame (H, W) or frames
    (N, H, W) → (new_state, ok bool [N], peak float32 [N]), device
    tensors: read them only when the host needs the verdict."""
    f = as_tensor(frame, state.center.device)
    wh, ww = state.x.shape[-2:]
    cy, cx = state.center[:, 0], state.center[:, 1]
    patch, oy, ox = _crop(f, cy, cx, wh, ww)
    k = _kernel(state.x, _features(patch))
    alphaf = torch.complex(state.alphaf_re, state.alphaf_im)
    resp = torch.fft.ifft2(torch.fft.fft2(k) * alphaf).real
    py, px = _argmax2(resp)
    peak = _at(resp, py, px)
    ok = peak >= detect_thresh

    fh, fw = f.shape[-2:]
    ncy = torch.where(ok, torch.clamp(oy + py, wh // 2, fh - wh + wh // 2), cy)
    ncx = torch.where(ok, torch.clamp(ox + px, ww // 2, fw - ww + ww // 2), cx)

    z2 = _features(_crop(f, ncy, ncx, wh, ww)[0])
    a2 = _train(torch.complex(state.yf_re, state.yf_im), z2)
    eta = torch.where(ok, interp_factor, 0.0).to(torch.float32)[:, None, None]
    new = KcfState(
        (1 - eta) * state.x + eta * z2,
        (1 - eta) * state.alphaf_re + eta * a2.real,
        (1 - eta) * state.alphaf_im + eta * a2.imag,
        state.yf_re, state.yf_im, torch.stack([ncy, ncx], 1))
    return new, ok, peak


class TrackerKCF:
    """OpenCV tracker API: ``init(image, bbox)``, ``ok, bbox =
    update(image)``. ``backend`` = "device" (float32 twin, default: state
    on the first image's device, a numpy image on the card, a host Mat on
    its target; one host read per frame) | "host" (float64 oracle)."""

    def __init__(self, interp_factor: float = INTERP_FACTOR,
                 detect_thresh: float = DETECT_THRESH,
                 backend: str = "device"):
        if backend not in ("device", "host"):
            raise ValueError(backend)
        self.interp_factor = float(interp_factor)
        self.detect_thresh = float(detect_thresh)
        self.backend = backend
        self._state = None
        self._target: Tuple[int, int] = (0, 0)
        self.last_response = float("nan")

    def init(self, image, bbox) -> None:
        x, y, w, h = (int(v) for v in bbox)
        self._target = (h, w)
        if self.backend == "host":
            self._state = kcf_init(gray_of_host(image), (x, y, w, h))
        else:
            self._state = init(gray_of(image), (x, y, w, h))

    def update(self, image):
        if self._state is None:
            raise RuntimeError("call init() first")
        if self.backend == "host":
            self._state, ok, peak = kcf_step(
                self._state, gray_of_host(image),
                interp_factor=self.interp_factor,
                detect_thresh=self.detect_thresh)
            cy, cx = self._state["center"]
        else:
            self._state, ok_d, peak_d = step(
                self._state, gray_of(image, self._state.center.device),
                interp_factor=self.interp_factor, detect_thresh=self.detect_thresh)
            ok, peak, cy, cx = read_verdict(ok_d, peak_d, self._state.center)
        self.last_response = float(peak)
        h, w = self._target
        return bool(ok), (cx - w // 2, cy - h // 2, w, h)
