"""TrackerMIL (copy of ``rustcv_tpu.ops.mil``; OpenCV ``TrackerMIL``
role, Babenko et al. 2009): online multiple-instance-learning tracker
with Haar-like features.

Frozen spec (float64, deterministic — the feature bank comes from the
bit-exact cv::RNG so runs reproduce):
- features: 250 Haar-like features; each is 2-4 random rectangles
  inside the target box with weights ±1/√(nrects), value = Σ w·rectsum
  on the raw intensity (integral image), normalized by rect area;
- weak classifiers: per-feature online Gaussians for the positive and
  negative class (means/sigmas blended with learning rate 0.85 per
  frame — OpenCV's posterior update), log-likelihood-ratio stumps;
- MIL boosting: greedily select 50 of the 250 stumps maximizing the
  noisy-OR bag likelihood (positive bag = patches within radius 4 of
  the centre, negatives = ring samples), re-selected every update;
- track: scan all positions within search radius 25, score with the
  selected stumps, move to the argmax (confidence = mean σ(score)).

Host implementation (vectorized numpy): the greedy bag-likelihood
boosting is inherently sequential — the GrabCut/Telea host-escape
precedent; per-step work is ~250 features × ~2k candidates, microsecond
scale on any CPU, far below a device dispatch. Tested for tracking
behavior (moving/occluded targets) in tests/test_mil.py and compared
qualitatively against cv2.TrackerMIL on the same scenes.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .core_ops import RNG

N_FEATURES = 250
N_SELECT = 50
POS_RADIUS = 4.0
NEG_COUNT = 65
INIT_NEG_RADIUS_SCALE = 2.0
SEARCH_RADIUS = 25.0
LEARN_RATE = 0.85
SIGMA_FLOOR = 1e-3


def _integral(img: np.ndarray) -> np.ndarray:
    s = np.zeros((img.shape[0] + 1, img.shape[1] + 1), np.float64)
    s[1:, 1:] = np.cumsum(np.cumsum(img.astype(np.float64), 0), 1)
    return s


def _make_features(w: int, h: int, seed: int = 1) -> List[np.ndarray]:
    """Feature bank: list of (nrect, 5) arrays (x0, y0, x1, y1, weight)
    with rects inside [0,w)×[0,h) — from the pinned MWC RNG."""
    rng = RNG(seed)
    feats = []
    for _ in range(N_FEATURES):
        nr = rng.uniform_int(2, 5)
        rects = []
        wgt = 1.0 / np.sqrt(nr)
        for _ in range(nr):
            x0 = rng.uniform_int(0, max(w - 2, 1))
            y0 = rng.uniform_int(0, max(h - 2, 1))
            x1 = x0 + 1 + rng.uniform_int(0, w - x0 - 1)
            y1 = y0 + 1 + rng.uniform_int(0, h - y0 - 1)
            sgn = 1.0 if rng.uniform_int(0, 2) else -1.0
            rects.append((x0, y0, x1, y1, sgn * wgt))
        feats.append(np.asarray(rects, np.float64))
    return feats


def _sample_features(sat: np.ndarray, feats: List[np.ndarray],
                     xs: np.ndarray, ys: np.ndarray) -> np.ndarray:
    """Feature matrix (n_samples, n_features) for top-left corners
    (xs, ys) of the target box — fully vectorized over samples."""
    out = np.zeros((len(xs), len(feats)), np.float64)
    for fi, rects in enumerate(feats):
        acc = np.zeros(len(xs), np.float64)
        for (x0, y0, x1, y1, wgt) in rects:
            ax0 = xs + int(x0)
            ay0 = ys + int(y0)
            ax1 = xs + int(x1)
            ay1 = ys + int(y1)
            s = (sat[ay1, ax1] - sat[ay0, ax1]
                 - sat[ay1, ax0] + sat[ay0, ax0])
            acc += wgt * s / ((x1 - x0) * (y1 - y0))
        out[:, fi] = acc
    return out


class _Stumps:
    """Per-feature online Gaussian class models + LLR scoring."""

    def __init__(self, n: int):
        self.mu1 = np.zeros(n)
        self.sig1 = np.ones(n)
        self.mu0 = np.zeros(n)
        self.sig0 = np.ones(n)
        self._fresh = True

    def update(self, pos: np.ndarray, neg: np.ndarray) -> None:
        pm, ps = pos.mean(0), np.maximum(pos.std(0), SIGMA_FLOOR)
        nm, ns = neg.mean(0), np.maximum(neg.std(0), SIGMA_FLOOR)
        if self._fresh:
            self.mu1, self.sig1 = pm, ps
            self.mu0, self.sig0 = nm, ns
            self._fresh = False
        else:
            lr = LEARN_RATE
            self.sig1 = np.sqrt(lr * self.sig1 ** 2 + (1 - lr) * ps ** 2
                                + lr * (1 - lr) * (self.mu1 - pm) ** 2)
            self.mu1 = lr * self.mu1 + (1 - lr) * pm
            self.sig0 = np.sqrt(lr * self.sig0 ** 2 + (1 - lr) * ns ** 2
                                + lr * (1 - lr) * (self.mu0 - nm) ** 2)
            self.mu0 = lr * self.mu0 + (1 - lr) * nm
        self.sig1 = np.maximum(self.sig1, SIGMA_FLOOR)
        self.sig0 = np.maximum(self.sig0, SIGMA_FLOOR)

    def llr(self, f: np.ndarray) -> np.ndarray:
        """(n_samples, n_features) log p1/p0 per stump."""
        l1 = (-0.5 * ((f - self.mu1) / self.sig1) ** 2
              - np.log(self.sig1))
        l0 = (-0.5 * ((f - self.mu0) / self.sig0) ** 2
              - np.log(self.sig0))
        return np.clip(l1 - l0, -10.0, 10.0)


def _greedy_select(llr_pos: np.ndarray, llr_neg: np.ndarray,
                   k: int) -> np.ndarray:
    """MIL noisy-OR greedy stump selection: maximize
    log(1 − Π_pos(1 − σ(H))) + Σ_neg log(1 − σ(H))."""
    n_feat = llr_pos.shape[1]
    hp = np.zeros(llr_pos.shape[0])
    hn = np.zeros(llr_neg.shape[0])
    chosen: List[int] = []
    avail = np.ones(n_feat, bool)

    def sigmoid(x):
        return 1.0 / (1.0 + np.exp(-x))

    for _ in range(min(k, n_feat)):
        cand_hp = hp[:, None] + llr_pos          # (npos, nfeat)
        cand_hn = hn[:, None] + llr_neg
        p_pos = sigmoid(cand_hp)
        p_neg = sigmoid(cand_hn)
        # noisy-OR positive bag + independent negatives
        bag = 1.0 - np.prod(1.0 - p_pos, axis=0)
        ll = (np.log(np.maximum(bag, 1e-12))
              + np.log(np.maximum(1.0 - p_neg, 1e-12)).sum(axis=0))
        ll = np.where(avail, ll, -np.inf)
        best = int(np.argmax(ll))
        chosen.append(best)
        avail[best] = False
        hp = hp + llr_pos[:, best]
        hn = hn + llr_neg[:, best]
    return np.asarray(chosen, np.int64)


class TrackerMIL:
    """OpenCV ``TrackerMIL`` API: ``init(image, bbox)`` then
    ``update(image) -> (ok, bbox)`` with bbox = (x, y, w, h)."""

    def __init__(self, seed: int = 1):
        self._seed = seed

    @staticmethod
    def _gray(image) -> np.ndarray:
        a = np.asarray(image)
        if a.ndim == 3:
            a = (a.astype(np.float64) @ [0.114, 0.587, 0.299])
        return a.astype(np.float64)

    def _clamp_grid(self, sat, cx, cy, radius):
        h, w = sat.shape[0] - 1, sat.shape[1] - 1
        xs = np.arange(max(0, int(cx - radius)),
                       min(w - self.tw, int(cx + radius)) + 1)
        ys = np.arange(max(0, int(cy - radius)),
                       min(h - self.th, int(cy + radius)) + 1)
        gx, gy = np.meshgrid(xs, ys)
        d2 = (gx - cx) ** 2 + (gy - cy) ** 2
        keep = d2 <= radius * radius
        return gx[keep], gy[keep]

    def init(self, image, bbox) -> None:
        x, y, w, h = (int(v) for v in bbox)
        self.tw, self.th = w, h
        self.x, self.y = x, y
        self.feats = _make_features(w, h, self._seed)
        self.stumps = _Stumps(N_FEATURES)
        gray = self._gray(image)
        sat = _integral(gray)
        self._train(sat, x, y, init=True)

    def _train(self, sat, cx, cy, init: bool = False) -> None:
        pxs, pys = self._clamp_grid(sat, cx, cy, POS_RADIUS)
        f_pos = _sample_features(sat, self.feats, pxs, pys)
        # negative ring
        rad = SEARCH_RADIUS * (INIT_NEG_RADIUS_SCALE if init else 1.0)
        nxs, nys = self._clamp_grid(sat, cx, cy, rad)
        d2 = (nxs - cx) ** 2 + (nys - cy) ** 2
        ring = d2 > (POS_RADIUS * 2) ** 2
        nxs, nys = nxs[ring], nys[ring]
        if len(nxs) > NEG_COUNT:
            rng = RNG(self._seed + 7)
            sel = np.array([rng.uniform_int(0, len(nxs))
                            for _ in range(NEG_COUNT)])
            nxs, nys = nxs[sel], nys[sel]
        f_neg = _sample_features(sat, self.feats, nxs, nys)
        self.stumps.update(f_pos, f_neg)
        self.selected = _greedy_select(self.stumps.llr(f_pos),
                                       self.stumps.llr(f_neg), N_SELECT)

    def update(self, image) -> Tuple[bool, Tuple[int, int, int, int]]:
        gray = self._gray(image)
        sat = _integral(gray)
        xs, ys = self._clamp_grid(sat, self.x, self.y, SEARCH_RADIUS)
        if len(xs) == 0:
            return False, (self.x, self.y, self.tw, self.th)
        f = _sample_features(sat, self.feats, xs, ys)
        scores = self.stumps.llr(f)[:, self.selected].sum(axis=1)
        best = int(np.argmax(scores))
        # the response plateaus over the positive-bag radius; the raw
        # argmax tie-breaks toward low indices (a backward bias), so
        # move to the centroid of the near-max plateau instead
        top = scores >= scores[best] - 0.02 * max(
            scores[best] - scores.min(), 1e-9)
        self.x = int(round(xs[top].mean()))
        self.y = int(round(ys[top].mean()))
        conf = 1.0 / (1.0 + np.exp(-scores[best] / len(self.selected)))
        self._train(sat, self.x, self.y)
        return bool(conf > 0.4), (self.x, self.y, self.tw, self.th)
