"""CSRT tracker (port of ``rustcv_tpu.ops.csrt``; OpenCV ``TrackerCSRT``
role — Lukežič et al. 2017, "Discriminative Correlation Filter with
Channel and Spatial Reliability").

Third member of the tracker family (ops/tracker.py MOSSE, ops/kcf.py): the
same step design (a clamped index-gather crop, ``torch.where``-gated
re-learning, state on the device, a leading bank axis with a lone tracker
a bank of one), plus the three CSRT ingredients — multi-channel features,
a spatial reliability mask constraining the filter support, and
channel-reliability weighting. A step is a crop → 9-channel features
(gray + 8 hard-binned gradient orientations, elementwise) → ``torch.fft``
over channels → weighted response sum → peak → re-learn (the 16-bin
histograms by ``bincount``, the mask, 4 fixed ADMM rounds, the channel
weights).

Frozen spec (float64 oracle in this module; divergences from OpenCV
documented: fixed scale — the DSST scale pyramid is out of scope like
MOSSE/KCF —, gray-intensity histograms instead of HSV color, hard
orientation binning instead of fHOG):
- window = floor(target·(1+1.5) padding), min 16 px per side; target
  rect must be ≥ 8×8;
- features: c₀ = gray/255 − 0.5; c₁..c₈ = |∇|/255 hard-assigned to
  ⌊θ·8/π⌋ mod 8 orientation bins (central differences, zero-padded
  borders); every channel × Hann;
- spatial reliability: 16-bin intensity histograms (+1 smoothing) of
  the central target rect (fg) vs the rest of the window (bg) →
  posterior q = p_fg/(p_fg + p_bg) per pixel; m = (q ≥ 0.5) AND the
  centered ⌊1.5·target⌋ rect; if Σm < max(16, 0.1·target area) the
  mask falls back to the exact target rect (a vanished-contrast guard);
- regression target: unit-peak Gaussian over CIRCULAR distance from
  (0, 0), σ = √(tw·th)·0.1 — peak at the origin: the response peak at
  (0, 0) means "no motion" and the signed wrap of the peak position is
  the displacement;
- constrained per-channel filter, CORRELATION form (response
  R_c(z) = irfft2(ẑ_c ⊙ conj(ĝ_c))); 4 ADMM rounds with
  μ₀ = 5, β = 3, μmax = 20, λ = 0.01:
    ĥ = (f̂⊙conj(ŷ) + μ·fft(g) − fft(l)) / (|f̂|² + λ + μ)
    g = m ⊙ (irfft(ĥ) + l/μ);  l += μ·(irfft(ĥ) − g);  μ ← min(βμ, μmax)
- channel reliability: w_c = max(0, max(R_c(f))) + 1e−6, normalized to
  Σw = 1, blended with learning rate on update;
- response scale: s = Σ_c w_c·max(R_c(f)) (the weighted TRAINING peak)
  makes confidence self-calibrating;
- detect at the old centre: R = Σ_c w_c·R_c(z); displacement =
  ((peak + win//2) mod win) − win//2 per axis; ok = peak/s ≥
  detect_thresh (0.3); on failure state freezes;
- update (learning rate η = 0.04): histograms, filter g, and channel
  weights all blend (1−η)·old + η·new from the re-crop at the new
  centre; the regression target and window geometry are fixed.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from . import golden
from .tensors import as_tensor
from .tracker import _argmax2, _at, _bboxes, _crop, _hann, gray_of, gray_of_host, read_verdict

__all__ = ["CsrtState", "init", "step", "TrackerCSRT",
           "csrt_init", "csrt_step"]

PADDING = 1.5
OUTPUT_SIGMA_FACTOR = 0.1
LAMBDA = 0.01
MU0, BETA, MU_MAX = 5.0, 3.0, 20.0
ADMM_ITERS = 4
ETA = 0.04
DETECT_THRESH = 0.3
N_BINS = 16
N_ORIENT = 8


def _win_of_target(tw: int, th: int) -> Tuple[int, int]:
    return (max(int(np.floor(th * (1.0 + PADDING))), 16),
            max(int(np.floor(tw * (1.0 + PADDING))), 16))


# ---------------------------------------------------------------------------
# float64 oracle
# ---------------------------------------------------------------------------

def _features_np(patch: np.ndarray) -> np.ndarray:
    """u8 (h, w) → (9, h, w) float64 Hann-windowed channels."""
    p = patch.astype(np.float64)
    h, w = p.shape
    gx = np.zeros_like(p)
    gy = np.zeros_like(p)
    gx[:, 1:-1] = (p[:, 2:] - p[:, :-2]) * 0.5
    gy[1:-1, :] = (p[2:, :] - p[:-2, :]) * 0.5
    mag = np.hypot(gx, gy) / 255.0
    theta = np.arctan2(gy, gx) % np.pi
    bins = np.minimum((theta * (N_ORIENT / np.pi)).astype(np.int64),
                      N_ORIENT - 1)
    ch = [p / 255.0 - 0.5]
    for b in range(N_ORIENT):
        ch.append(np.where(bins == b, mag, 0.0))
    hann = golden.mosse_hann(h, w)
    return np.stack(ch) * hann


def _mask_np(patch: np.ndarray, th: int, tw: int, hist_fg: np.ndarray,
             hist_bg: np.ndarray) -> np.ndarray:
    h, w = patch.shape
    b = np.minimum(patch.astype(np.int64) >> 4, N_BINS - 1)
    q = hist_fg[b] / (hist_fg[b] + hist_bg[b])
    m = q >= 0.5
    rh = min(int(np.floor(1.5 * th)), h)
    rw = min(int(np.floor(1.5 * tw)), w)
    y0, x0 = (h - rh) // 2, (w - rw) // 2
    rect = np.zeros((h, w), bool)
    rect[y0:y0 + rh, x0:x0 + rw] = True
    m = m & rect
    if m.sum() < max(16, 0.1 * th * tw):
        m = np.zeros((h, w), bool)
        y0, x0 = (h - th) // 2, (w - tw) // 2
        m[y0:y0 + th, x0:x0 + tw] = True
    return m.astype(np.float64)


def _hists_np(patch: np.ndarray, th: int, tw: int):
    h, w = patch.shape
    b = np.minimum(patch.astype(np.int64) >> 4, N_BINS - 1)
    y0, x0 = (h - th) // 2, (w - tw) // 2
    fg_mask = np.zeros((h, w), bool)
    fg_mask[y0:y0 + th, x0:x0 + tw] = True
    fg = np.bincount(b[fg_mask], minlength=N_BINS).astype(np.float64) + 1.0
    bg = np.bincount(b[~fg_mask], minlength=N_BINS).astype(np.float64) + 1.0
    return fg / fg.sum(), bg / bg.sum()


def _learn_np(feats: np.ndarray, yf: np.ndarray,
              mask: np.ndarray) -> np.ndarray:
    """ADMM-constrained per-channel filters → g (C, h, w) float64."""
    c, h, w = feats.shape
    fhat = np.fft.rfft2(feats)
    g = np.zeros((c, h, w))
    l = np.zeros((c, h, w))
    mu = MU0
    denom_base = (fhat * np.conj(fhat)).real + LAMBDA
    num = fhat * np.conj(yf)
    for _ in range(ADMM_ITERS):
        hhat = (num + mu * np.fft.rfft2(g) - np.fft.rfft2(l)) / (
            denom_base + mu)
        h_sp = np.fft.irfft2(hhat, s=(h, w))
        g = mask * (h_sp + l / mu)
        l = l + mu * (h_sp - g)
        mu = min(BETA * mu, MU_MAX)
    return g


def _weights_np(feats: np.ndarray, g: np.ndarray):
    c, h, w = feats.shape
    resp = np.fft.irfft2(np.fft.rfft2(feats) * np.conj(np.fft.rfft2(g)),
                         s=(h, w))
    peaks = np.maximum(resp.reshape(c, -1).max(axis=1), 0.0) + 1e-6
    wgt = peaks / peaks.sum()
    return wgt, float((wgt * peaks).sum())


def csrt_init(frame: np.ndarray, bbox) -> dict:
    """bbox = (x, y, w, h). Returns the oracle state dict."""
    x, y, tw, th = (int(v) for v in bbox)
    if tw < 8 or th < 8:
        raise ValueError("CSRT target must be at least 8x8")
    wh, ww = _win_of_target(tw, th)
    cy, cx = y + th // 2, x + tw // 2
    f = np.asarray(frame, np.float64)
    patch, _, _ = golden._mosse_crop(f, cy, cx, wh, ww)
    patch = patch.astype(np.uint8)
    sig = np.sqrt(tw * th) * OUTPUT_SIGMA_FACTOR
    iy = np.minimum(np.arange(wh), wh - np.arange(wh)).astype(np.float64)
    ix = np.minimum(np.arange(ww), ww - np.arange(ww)).astype(np.float64)
    d2 = iy[:, None] ** 2 + ix[None, :] ** 2
    yresp = np.exp(-d2 / (2.0 * sig * sig))
    yf = np.fft.rfft2(yresp)
    hist_fg, hist_bg = _hists_np(patch, th, tw)
    mask = _mask_np(patch, th, tw, hist_fg, hist_bg)
    feats = _features_np(patch)
    g = _learn_np(feats, yf, mask)
    wgt, scale = _weights_np(feats, g)
    return {"g": g, "w": wgt, "scale": scale, "yf": yf,
            "hist_fg": hist_fg, "hist_bg": hist_bg, "center": (cy, cx),
            "size": (wh, ww), "target": (th, tw)}


def csrt_step(state: dict, frame: np.ndarray, eta: float = ETA,
              detect_thresh: float = DETECT_THRESH):
    """One step → (new_state, ok, peak_response)."""
    wh, ww = state["size"]
    th, tw = state["target"]
    cy, cx = state["center"]
    f = np.asarray(frame, np.float64)
    patch, oy, ox = golden._mosse_crop(f, cy, cx, wh, ww)
    patch = patch.astype(np.uint8)
    z = _features_np(patch)
    resp = np.fft.irfft2(
        np.fft.rfft2(z) * np.conj(np.fft.rfft2(state["g"])), s=(wh, ww))
    r = (state["w"][:, None, None] * resp).sum(axis=0)
    py, px = np.unravel_index(int(r.argmax()), r.shape)
    peak = float(r[py, px]) / state["scale"]
    if peak < detect_thresh:
        return state, False, peak
    dy = int((py + wh // 2) % wh) - wh // 2   # signed wrap
    dx = int((px + ww // 2) % ww) - ww // 2
    fh, fw = f.shape
    ncy = int(np.clip(oy + wh // 2 + dy, wh // 2, fh - wh + wh // 2))
    ncx = int(np.clip(ox + ww // 2 + dx, ww // 2, fw - ww + ww // 2))
    patch2, _, _ = golden._mosse_crop(f, ncy, ncx, wh, ww)
    patch2 = patch2.astype(np.uint8)
    fg2, bg2 = _hists_np(patch2, th, tw)
    hist_fg = (1 - eta) * state["hist_fg"] + eta * fg2
    hist_bg = (1 - eta) * state["hist_bg"] + eta * bg2
    mask = _mask_np(patch2, th, tw, hist_fg, hist_bg)
    z2 = _features_np(patch2)
    g2 = _learn_np(z2, state["yf"], mask)
    w2, s2 = _weights_np(z2, g2)
    new = {
        "g": (1 - eta) * state["g"] + eta * g2,
        "w": (1 - eta) * state["w"] + eta * w2,
        "scale": (1 - eta) * state["scale"] + eta * s2,
        "yf": state["yf"], "hist_fg": hist_fg, "hist_bg": hist_bg,
        "center": (ncy, ncx), "size": (wh, ww), "target": (th, tw),
    }
    return new, True, peak


# ---------------------------------------------------------------------------
# tensor twin (float32)
# ---------------------------------------------------------------------------

class CsrtState(NamedTuple):
    """Tracker-bank state on the device, every field with a leading bank
    axis N."""

    g: torch.Tensor        # float32 [N, C, h, w] masked filters
    w: torch.Tensor        # float32 [N, C] channel weights
    scale: torch.Tensor    # float32 [N] training response peak
    yf_re: torch.Tensor    # float32 [N, h, w]
    yf_im: torch.Tensor    # float32 [N, h, w]
    hist_fg: torch.Tensor  # float32 [N, 16]
    hist_bg: torch.Tensor  # float32 [N, 16]
    center: torch.Tensor   # int64 [N, 2] (cy, cx)


def _orient_bins(gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """⌊θ·8/π⌋ of θ = atan2(gy, gx) mod π without atan2: the count of bin
    edges kπ/8 (k = 1..7) at or below θ, each a sign test of the gradient
    turned into the upper half plane, (u, v). The edges at π/4, π/2 and
    3π/4 are exact compares (v ≥ u, u ≤ 0, u + v ≤ 0); a half-integer
    gradient of u8 pixels lies at least 9.6e-4 from the other edges, far
    beyond float32's rounding. So the card and the CPU bin alike, and as
    the float64 oracle does, where a float32 atan2 one ulp low would move
    a pixel on an edge (gx = gy is common) to the bin below."""
    neg = gy < 0
    u = torch.where(neg, -gx, gx)
    v = torch.where(neg, -gy, gy)
    bins = (v >= u).to(torch.int64) + (u <= 0) + (u + v <= 0)
    for k in (1, 3, 5, 7):
        bins = bins + (v * float(np.cos(k * np.pi / 8)) >= u * float(np.sin(k * np.pi / 8)))
    return torch.where(v == 0, 0, bins)


def _features(patch: torch.Tensor) -> torch.Tensor:
    """u8 patches [N, h, w] → [N, 9, h, w] Hann-windowed channels."""
    p = patch.to(torch.float32)
    gx = torch.zeros_like(p)
    gy = torch.zeros_like(p)
    gx[..., :, 1:-1] = (p[..., :, 2:] - p[..., :, :-2]) * 0.5
    gy[..., 1:-1, :] = (p[..., 2:, :] - p[..., :-2, :]) * 0.5
    mag = torch.hypot(gx, gy) / 255.0
    bins = _orient_bins(gx, gy)
    orient = torch.arange(N_ORIENT, device=p.device)[:, None, None]
    ch = torch.cat([(p / 255.0 - 0.5)[:, None],
                    torch.where(bins[:, None] == orient, mag[:, None], 0.0)], dim=1)
    return ch * _hann(*p.shape[-2:], p.device)


def _rect(h: int, w: int, rh: int, rw: int, device) -> torch.Tensor:
    """The centred rh×rw rectangle of an h×w window, bool."""
    y0, x0 = (h - rh) // 2, (w - rw) // 2
    m = torch.zeros((h, w), dtype=torch.bool, device=device)
    m[y0:y0 + rh, x0:x0 + rw] = True
    return m


def _hists(patch: torch.Tensor, th: int, tw: int):
    """16-bin intensity histograms (+1) of the target rect and the rest,
    normalized: two ``bincount``s over the bank."""
    n, h, w = patch.shape
    b = torch.clamp(patch.to(torch.int64) >> 4, max=N_BINS - 1)
    fg = _rect(h, w, th, tw, patch.device).to(torch.int64)
    key = (torch.arange(n, device=patch.device)[:, None, None] * 2 + fg) * N_BINS + b
    counts = torch.bincount(key.reshape(-1), minlength=n * 2 * N_BINS).view(n, 2, N_BINS)
    c = counts.to(torch.float32) + 1.0
    fgh, bgh = c[:, 1], c[:, 0]
    return fgh / fgh.sum(1, keepdim=True), bgh / bgh.sum(1, keepdim=True)


def _mask(patch: torch.Tensor, th: int, tw: int, hist_fg: torch.Tensor,
          hist_bg: torch.Tensor) -> torch.Tensor:
    n, h, w = patch.shape
    b = torch.clamp(patch.to(torch.int64) >> 4, max=N_BINS - 1).reshape(n, -1)
    pf = torch.gather(hist_fg, 1, b).view(n, h, w)
    pb = torch.gather(hist_bg, 1, b).view(n, h, w)
    q = pf / (pf + pb)
    rh, rw = min(int(np.floor(1.5 * th)), h), min(int(np.floor(1.5 * tw)), w)
    m = (q >= 0.5) & _rect(h, w, rh, rw, patch.device)
    fallback = m.sum(dim=(1, 2)) < max(16, 0.1 * th * tw)
    return torch.where(fallback[:, None, None], _rect(h, w, th, tw, patch.device), m).to(
        torch.float32)


def _learn(feats: torch.Tensor, yf: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """ADMM-constrained per-channel filters [N, C, h, w] (yf complex
    [N, h, w], mask [N, h, w])."""
    fhat = torch.fft.fft2(feats)
    denom_base = fhat.real ** 2 + fhat.imag ** 2 + LAMBDA
    num = fhat * torch.conj(yf)[:, None]
    m = mask[:, None]
    g = torch.zeros_like(feats)
    lag = torch.zeros_like(feats)
    mu = MU0
    for _ in range(ADMM_ITERS):
        hhat = (num + mu * torch.fft.fft2(g) - torch.fft.fft2(lag)) / (denom_base + mu)
        h_sp = torch.fft.ifft2(hhat).real
        g = m * (h_sp + lag / mu)
        lag = lag + mu * (h_sp - g)
        mu = min(BETA * mu, MU_MAX)
    return g


def _responses(z: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Per-channel correlation responses irfft2(ẑ ⊙ conj(ĝ)) [N, C, h, w]."""
    return torch.fft.ifft2(torch.fft.fft2(z) * torch.conj(torch.fft.fft2(g))).real


def _weights(feats: torch.Tensor, g: torch.Tensor):
    resp = _responses(feats, g)
    peaks = torch.clamp(resp.flatten(2).amax(2), min=0.0) + 1e-6      # [N, C]
    wgt = peaks / peaks.sum(1, keepdim=True)
    return wgt, (wgt * peaks).sum(1)


def _init_core(frame: torch.Tensor, cy, cx, wh: int, ww: int, th: int, tw: int,
               sig: float) -> CsrtState:
    patch = _crop(frame, cy, cx, wh, ww)[0].to(torch.float32).to(torch.uint8)
    dev = frame.device
    ar_h = torch.arange(wh, device=dev)
    ar_w = torch.arange(ww, device=dev)
    iy = torch.minimum(ar_h, wh - ar_h).to(torch.float32)
    ix = torch.minimum(ar_w, ww - ar_w).to(torch.float32)
    d2 = iy[:, None] ** 2 + ix[None, :] ** 2
    yf = torch.fft.fft2(torch.exp(-d2 / (2.0 * sig * sig)))
    n = patch.shape[0]
    yfb = yf.expand(n, wh, ww)
    fg, bg = _hists(patch, th, tw)
    mask = _mask(patch, th, tw, fg, bg)
    feats = _features(patch)
    g = _learn(feats, yfb, mask)
    wgt, scale = _weights(feats, g)
    return CsrtState(g, wgt, scale, yfb.real.contiguous(), yfb.imag.contiguous(), fg, bg,
                     torch.stack([cy, cx], 1))


def init(frame, bbox) -> CsrtState:
    """A bank of trackers on ``bbox`` = (x, y, w, h), or N boxes of one
    size, of a gray frame: a tensor stays on its device, a numpy array
    goes to the card."""
    b = _bboxes(bbox)
    tw, th = int(b[0, 2]), int(b[0, 3])
    if tw < 8 or th < 8:
        raise ValueError("CSRT target must be at least 8x8")
    wh, ww = _win_of_target(tw, th)
    sig = float(np.sqrt(tw * th) * OUTPUT_SIGMA_FACTOR)
    f = as_tensor(frame)
    cy = torch.as_tensor(b[:, 1] + th // 2, device=f.device)
    cx = torch.as_tensor(b[:, 0] + tw // 2, device=f.device)
    return _init_core(f, cy, cx, wh, ww, th, tw, sig)


def step(state: CsrtState, frame, eta: float = ETA,
         detect_thresh: float = DETECT_THRESH, target=None):
    """One tracking step of the bank on a gray frame (H, W) or frames
    (N, H, W) → (new_state, ok bool [N], peak float32 [N]), device
    tensors. ``target`` = (th, tw); when None it is derived from the
    window (the init convention)."""
    f = as_tensor(frame, state.center.device)
    wh, ww = state.g.shape[-2:]
    if target is None:
        th = int(round(wh / (1.0 + PADDING)))
        tw = int(round(ww / (1.0 + PADDING)))
    else:
        th, tw = target
    cy, cx = state.center[:, 0], state.center[:, 1]
    patch, oy, ox = _crop(f, cy, cx, wh, ww)
    z = _features(patch.to(torch.float32).to(torch.uint8))
    r = (state.w[:, :, None, None] * _responses(z, state.g)).sum(1)
    py, px = _argmax2(r)
    peak = _at(r, py, px) / state.scale
    ok = peak >= detect_thresh

    dy = (py + wh // 2) % wh - wh // 2   # signed wrap
    dx = (px + ww // 2) % ww - ww // 2
    fh, fw = f.shape[-2:]
    ncy = torch.where(ok, torch.clamp(oy + wh // 2 + dy, wh // 2, fh - wh + wh // 2), cy)
    ncx = torch.where(ok, torch.clamp(ox + ww // 2 + dx, ww // 2, fw - ww + ww // 2), cx)

    patch2 = _crop(f, ncy, ncx, wh, ww)[0].to(torch.float32).to(torch.uint8)
    fg2, bg2 = _hists(patch2, th, tw)
    e = torch.where(ok, eta, 0.0).to(torch.float32)[:, None]
    hist_fg = (1 - e) * state.hist_fg + e * fg2
    hist_bg = (1 - e) * state.hist_bg + e * bg2
    mask = _mask(patch2, th, tw, hist_fg, hist_bg)
    z2 = _features(patch2)
    g2 = _learn(z2, torch.complex(state.yf_re, state.yf_im), mask)
    w2, s2 = _weights(z2, g2)
    new = CsrtState(
        (1 - e[:, :, None, None]) * state.g + e[:, :, None, None] * g2,
        (1 - e) * state.w + e * w2,
        (1 - e[:, 0]) * state.scale + e[:, 0] * s2,
        state.yf_re, state.yf_im, hist_fg, hist_bg, torch.stack([ncy, ncx], 1))
    return new, ok, peak


class TrackerCSRT:
    """OpenCV tracker API: ``init(image, bbox)``, ``ok, bbox =
    update(image)``. ``backend`` = "device" (float32 twin, default: state
    on the first image's device, a numpy image on the card, a host Mat on
    its target; one host read per frame) | "host" (float64 oracle)."""

    def __init__(self, eta: float = ETA,
                 detect_thresh: float = DETECT_THRESH,
                 backend: str = "device"):
        if backend not in ("device", "host"):
            raise ValueError(backend)
        self.eta = float(eta)
        self.detect_thresh = float(detect_thresh)
        self.backend = backend
        self._state = None
        self._target: Tuple[int, int] = (0, 0)
        self.last_response = float("nan")

    def init(self, image, bbox) -> None:
        x, y, w, h = (int(v) for v in bbox)
        self._target = (h, w)
        if self.backend == "host":
            self._state = csrt_init(gray_of_host(image), (x, y, w, h))
        else:
            self._state = init(gray_of(image), (x, y, w, h))

    def update(self, image):
        if self._state is None:
            raise RuntimeError("call init() first")
        if self.backend == "host":
            self._state, ok, peak = csrt_step(
                self._state, gray_of_host(image), eta=self.eta,
                detect_thresh=self.detect_thresh)
            cy, cx = self._state["center"]
        else:
            self._state, ok_d, peak_d = step(
                self._state, gray_of(image, self._state.center.device), eta=self.eta,
                detect_thresh=self.detect_thresh, target=self._target)
            ok, peak, cy, cx = read_verdict(ok_d, peak_d, self._state.center)
        self.last_response = float(peak)
        h, w = self._target
        return bool(ok), (cx - w // 2, cy - h // 2, w, h)
