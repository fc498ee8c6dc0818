"""Copy of ``rustcv_tpu.ops.grabcut`` (the min-cut through the port's
``native.maxflow_grid``). GrabCut interactive foreground extraction (the OpenCV ``grabCut``
role) — real graph-cut energy minimization, not an approximation.

Split: per-pixel GMM color likelihoods are dense vectorized math; the
min-cut is combinatorial pointer-chasing, so it runs in the native C++
Dinic solver (native/maxflow.cpp) over the standard 8-connected vision
grid — mirroring how the reference keeps its runtime native while the
dense path stays array-shaped.

Frozen procedure (deterministic; OpenCV grabcut.cpp roles):
- mask codes: 0 = BGD, 1 = FGD, 2 = PR_BGD, 3 = PR_FGD; rect init sets
  outside to BGD and inside to PR_FGD;
- each iteration: fit a K=5 full-covariance GMM per side (seeded
  k-means++ + 3 Lloyd rounds + one hard-assignment refit; cov + 0.01·I
  regularization), unaries = −log Σ_k w_k N(z|μ_k, Σ_k);
- pairwise: β = 1/(2·mean ‖z_p − z_q‖²) over all 8-neighbor pairs,
  n-link = γ·exp(−β‖z_p − z_q‖²) (γ/√2 on diagonals), γ = 50;
- t-links: known BGD (0, λ), known FGD (λ, 0), unknown
  (−log P_bg, −log P_fg) with λ = 9γ; energies scaled ×100 to int64;
- min cut: source side = foreground; only unknown pixels update
  (→ PR_FGD / PR_BGD), user-known pixels never change.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

GC_BGD, GC_FGD, GC_PR_BGD, GC_PR_FGD = 0, 1, 2, 3
_K = 5
_GAMMA = 50.0
_LAMBDA = 9.0 * _GAMMA
_SCALE = 100.0


def _kmeans(x: np.ndarray, k: int, seed: int) -> np.ndarray:
    """Seeded k-means++ + 3 Lloyd rounds → component index per row."""
    rng = np.random.default_rng(seed)
    n = len(x)
    k = min(k, n)
    centers = [x[rng.integers(n)]]
    for _ in range(1, k):
        d2 = np.min(
            [((x - c) ** 2).sum(axis=1) for c in centers], axis=0)
        tot = d2.sum()
        if tot <= 0:
            centers.append(x[rng.integers(n)])
            continue
        centers.append(x[np.searchsorted(np.cumsum(d2 / tot),
                                         rng.random())])
    c = np.asarray(centers)
    for _ in range(3):
        d2 = ((x[:, None, :] - c[None]) ** 2).sum(axis=2)
        a = d2.argmin(axis=1)
        for j in range(k):
            sel = x[a == j]
            if len(sel):
                c[j] = sel.mean(axis=0)
    return d2.argmin(axis=1)


class _GMM:
    def __init__(self, x: np.ndarray, seed: int):
        a = _kmeans(x, _K, seed)
        self.w = np.zeros(_K)
        self.mu = np.zeros((_K, 3))
        self.icov = np.zeros((_K, 3, 3))
        self.logdet = np.zeros(_K)
        self._learn(x, a)
        # one hard-assignment refinement round
        self._learn(x, self.assign(x))

    def _learn(self, x: np.ndarray, a: np.ndarray) -> None:
        n = len(x)
        for j in range(_K):
            sel = x[a == j]
            self.w[j] = len(sel) / n
            if len(sel) == 0:
                self.mu[j] = 0
                self.icov[j] = np.eye(3)
                self.logdet[j] = 0.0
                continue
            self.mu[j] = sel.mean(axis=0)
            d = sel - self.mu[j]
            cov = (d.T @ d) / len(sel) + 0.01 * np.eye(3)
            self.icov[j] = np.linalg.inv(cov)
            self.logdet[j] = float(np.linalg.slogdet(cov)[1])

    def _comp_logp(self, x: np.ndarray) -> np.ndarray:
        """[N, K] log(w_k · N(x|μ_k, Σ_k)) (−inf for empty comps)."""
        out = np.full((len(x), _K), -np.inf)
        for j in range(_K):
            if self.w[j] <= 0:
                continue
            d = x - self.mu[j]
            m = np.einsum("ni,ij,nj->n", d, self.icov[j], d)
            out[:, j] = (np.log(self.w[j]) - 0.5 * self.logdet[j]
                         - 0.5 * m - 1.5 * np.log(2 * np.pi))
        return out

    def assign(self, x: np.ndarray) -> np.ndarray:
        return self._comp_logp(x).argmax(axis=1)

    def neglog(self, x: np.ndarray) -> np.ndarray:
        lp = self._comp_logp(x)
        mx = lp.max(axis=1)
        tot = mx + np.log(np.exp(lp - mx[:, None]).sum(axis=1))
        return np.clip(-tot, 0.0, 1e4)


def _nlinks(img: np.ndarray) -> Tuple[np.ndarray, ...]:
    z = img.astype(np.float64)
    h, w = z.shape[:2]
    dr_ = ((z[:, 1:] - z[:, :-1]) ** 2).sum(axis=-1)
    dd = ((z[1:, :] - z[:-1, :]) ** 2).sum(axis=-1)
    ddr = ((z[1:, 1:] - z[:-1, :-1]) ** 2).sum(axis=-1)
    ddl = ((z[1:, :-1] - z[:-1, 1:]) ** 2).sum(axis=-1)
    total = dr_.sum() + dd.sum() + ddr.sum() + ddl.sum()
    count = dr_.size + dd.size + ddr.size + ddl.size
    beta = 0.0 if total <= 0 else 1.0 / (2.0 * total / count)

    r = np.zeros((h, w)); r[:, :-1] = _GAMMA * np.exp(-beta * dr_)
    d = np.zeros((h, w)); d[:-1, :] = _GAMMA * np.exp(-beta * dd)
    dg = _GAMMA / np.sqrt(2.0)
    drp = np.zeros((h, w)); drp[:-1, :-1] = dg * np.exp(-beta * ddr)
    dlp = np.zeros((h, w)); dlp[:-1, 1:] = dg * np.exp(-beta * ddl)
    return r, d, drp, dlp


def _mincut(h, w, cap_src, cap_snk, r, d, dr, dl) -> np.ndarray:
    from .. import native

    def q(a):
        return np.round(np.asarray(a).reshape(h, w) * _SCALE).astype(np.int64)

    # raises RuntimeError (with the compiler's output) when the library
    # did not build
    return native.maxflow_grid(q(cap_src), q(cap_snk), q(r), q(d), q(dr), q(dl))[1]


def grab_cut(
    img: np.ndarray,
    mask: Optional[np.ndarray] = None,
    rect: Optional[Tuple[int, int, int, int]] = None,
    iter_count: int = 5,
    seed: int = 0,
) -> np.ndarray:
    """u8 BGR (H, W, 3) → int mask (H, W) with GC_* codes. Initialize
    with ``rect`` (x, y, w, h) OR a prefilled ``mask``; pass the returned
    mask back (with user edits) to continue refining."""
    if img.ndim != 3 or img.shape[-1] != 3:
        raise ValueError("grab_cut expects a BGR (H, W, 3) image")
    h, w = img.shape[:2]
    if mask is None:
        if rect is None:
            raise ValueError("provide rect or mask")
        mask = np.full((h, w), GC_BGD, np.uint8)
        x0, y0, rw, rh = rect
        mask[max(y0, 0) : y0 + rh, max(x0, 0) : x0 + rw] = GC_PR_FGD
    else:
        mask = np.asarray(mask, np.uint8).copy()
        if mask.shape != (h, w):
            raise ValueError("mask shape mismatch")
        if not np.isin(mask, [0, 1, 2, 3]).all():
            raise ValueError("mask must use GC_* codes 0..3")
        if rect is not None:
            x0, y0, rw, rh = rect
            inside = np.zeros((h, w), bool)
            inside[max(y0, 0) : y0 + rh, max(x0, 0) : x0 + rw] = True
            mask[~inside] = GC_BGD
            mask[inside & (mask != GC_BGD) & (mask != GC_FGD)] = GC_PR_FGD
    z = img.reshape(-1, 3).astype(np.float64)
    r, d, dr, dl = _nlinks(img)
    unknown = np.isin(mask, [GC_PR_BGD, GC_PR_FGD])
    if not unknown.any():
        return mask
    for it in range(iter_count):
        fg_sel = np.isin(mask, [GC_FGD, GC_PR_FGD]).reshape(-1)
        bg_sel = ~fg_sel
        if fg_sel.sum() == 0 or bg_sel.sum() == 0:
            break  # degenerate: one side empty — nothing to model
        fgm = _GMM(z[fg_sel], seed * 1000 + it * 2)
        bgm = _GMM(z[bg_sel], seed * 1000 + it * 2 + 1)
        cap_src = np.zeros((h, w))
        cap_snk = np.zeros((h, w))
        unk = np.isin(mask, [GC_PR_BGD, GC_PR_FGD])
        uflat = unk.reshape(-1)
        cap_src[unk] = bgm.neglog(z[uflat])  # attached to FG ⇔ unlikely BG
        cap_snk[unk] = fgm.neglog(z[uflat])
        cap_src[mask == GC_FGD] = _LAMBDA
        cap_snk[mask == GC_BGD] = _LAMBDA
        fg_side = _mincut(h, w, cap_src, cap_snk, r, d, dr, dl).astype(bool)
        new = mask.copy()
        new[unk & fg_side] = GC_PR_FGD
        new[unk & ~fg_side] = GC_PR_BGD
        if np.array_equal(new, mask):
            mask = new
            break
        mask = new
    return mask
