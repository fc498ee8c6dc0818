"""DSST scale filter (copy of ``rustcv_tpu.ops.dsst_scale``; Danelljan
2014; the scale-estimation component of OpenCV's CSRT/DSST trackers),
standalone and composable with any of our translation trackers
(MOSSE/KCF/CSRT/MIL keep their own position logic; this estimates the
scale CHANGE at a known center).

Frozen spec (float64):
- S = 17 scale samples a^n, a = 1.02, n ∈ [−8, 8]; each sample crops
  target_size·a^n around the center and resizes to a fixed 32×32
  template whose Hann-windowed intensities form one feature column;
- a 1-D MOSSE filter over the SCALE axis: desired response g is a
  σ = 1.1 Gaussian peaked at the current scale; Ĥ = ĝ·f̂* /
  (Σ f̂·f̂* + λ), trained per feature dimension and averaged, updated
  with learning rate η = 0.03;
- update(frame, center) evaluates the filter and multiplies the
  running scale by a^(argmax − 8) (parabolic sub-bin refinement).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .golden import resize_bilinear

N_SCALES = 17
SCALE_STEP = 1.02
TEMPLATE = 32
LAMBDA = 1e-2
ETA = 0.03
SIGMA = 1.1


def _hann(n: int) -> np.ndarray:
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / (n - 1))


class ScaleEstimator:
    def __init__(self, frame: np.ndarray, center: Tuple[float, float],
                 target_size: Tuple[int, int]):
        self.base = (float(target_size[0]), float(target_size[1]))
        self.scale = 1.0
        exps = np.arange(N_SCALES) - N_SCALES // 2
        self.factors = SCALE_STEP ** exps
        g = np.exp(-0.5 * (exps / SIGMA) ** 2)
        self.gf = np.fft.rfft(np.fft.ifftshift(
            np.roll(g, 0)))  # peak at index center after ifftshift
        self.win = _hann(N_SCALES)
        f = self._features(frame, center)
        ff = np.fft.rfft(f, axis=0)
        self.num = self.gf[:, None] * np.conj(ff)
        self.den = (np.conj(ff) * ff).sum(axis=1).real

    def _features(self, frame: np.ndarray, center) -> np.ndarray:
        g = np.asarray(frame, np.float64)
        if g.ndim == 3:
            g = g.mean(-1)
        h, w = g.shape
        cx, cy = float(center[0]), float(center[1])
        cols = []
        for s in self.factors * self.scale:
            tw = max(4, int(round(self.base[0] * s)))
            th = max(4, int(round(self.base[1] * s)))
            x0 = int(round(cx - tw / 2))
            y0 = int(round(cy - th / 2))
            xs = np.clip(np.arange(x0, x0 + tw), 0, w - 1)
            ys = np.clip(np.arange(y0, y0 + th), 0, h - 1)
            patch = g[np.ix_(ys, xs)].astype(np.uint8)
            small = resize_bilinear(
                np.stack([patch] * 3, -1), TEMPLATE, TEMPLATE)[..., 0]
            cols.append(small.astype(np.float64).ravel() / 255.0 - 0.5)
        f = np.stack(cols)  # (S, D)
        return f * self.win[:, None]

    def update(self, frame: np.ndarray, center) -> float:
        """→ the new absolute scale (relative to the init size)."""
        f = self._features(frame, center)
        ff = np.fft.rfft(f, axis=0)
        resp = np.fft.irfft(
            (self.num * ff).sum(axis=1) / (self.den + LAMBDA),
            n=N_SCALES)
        resp = np.fft.fftshift(resp)
        k = int(np.argmax(resp))
        # parabolic refinement over the scale bins
        if 0 < k < N_SCALES - 1:
            denom = 2 * resp[k] - resp[k - 1] - resp[k + 1]
            frac = (0.5 * (resp[k + 1] - resp[k - 1]) / denom
                    if abs(denom) > 1e-12 else 0.0)
        else:
            frac = 0.0
        delta = (k - N_SCALES // 2) + np.clip(frac, -0.5, 0.5)
        self.scale *= SCALE_STEP ** delta
        # train on the NEW scale
        f = self._features(frame, center)
        ff = np.fft.rfft(f, axis=0)
        self.num = ((1 - ETA) * self.num
                    + ETA * self.gf[:, None] * np.conj(ff))
        self.den = ((1 - ETA) * self.den
                    + ETA * (np.conj(ff) * ff).sum(axis=1).real)
        return self.scale

    @property
    def size(self) -> Tuple[int, int]:
        return (int(round(self.base[0] * self.scale)),
                int(round(self.base[1] * self.scale)))
