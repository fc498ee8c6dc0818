"""Background subtraction — Gaussian-mixture model per pixel (port of
``rustcv_tpu.ops.bgsub``; the OpenCV ``BackgroundSubtractorMOG2`` role,
Zivkovic-style update rules, frozen simplified spec below).

The model is [K, H, W(, C)] float32 planes on the frame's device, and
every rule — matching, ownership, running-moment updates, weight
normalization, the sorted-cumulative-weight background test — is
elementwise with the K axis unrolled (K=4 default). Sums over channels and
components run in a fixed left-to-right order, so the card and the CPU add
the same terms in the same order. State threads functionally through
:func:`mog2_step`, so a clip is a Python loop of steps with no host read.

Frozen spec (per pixel, per frame x):
- distance d2_k = Σ_c (x_c − μ_kc)²; match_k = d2_k < T_var · v_k · C;
  best = argmin_k d2_k among matches (ties → smallest k);
- foreground decision BEFORE updating: sort components by weight
  descending (stable; ties → smaller k first); the background set is the
  smallest prefix whose cumulative weight exceeds ``ratio`` (a component
  is in the set if the cumulative weight BEFORE it is < ratio); the pixel
  is foreground iff it matches nothing or its best match is not in the
  background set;
- update (α = learning rate): w_k ← (1−α)·w_k + α·o_k with o_k = [k is
  best match]; matched component: ρ = α / max(w_k', 1e-6), μ ← μ + ρ·δ,
  v ← v + ρ·(d2/C − v), v clamped to [v_min, v_max];
- no match: the lowest-weight component (ties → smallest k) is replaced
  with μ = x, v = v_init, w = α;
- weights renormalized to sum 1 each frame.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from .tensors import as_tensor


class MOG2Params(NamedTuple):
    alpha: float = 0.01  # learning rate (OpenCV: 1/history)
    var_threshold: float = 16.0  # squared-mahalanobis match gate
    ratio: float = 0.9  # background cumulative-weight prefix
    var_init: float = 225.0  # variance for fresh components (15^2)
    var_min: float = 4.0
    var_max: float = 5000.0


def mog2_init(shape: Tuple[int, ...], k: int = 4, device="cuda"):
    """Fresh model for frames of ``shape`` ((H, W) or (H, W, C)) on
    ``device``: (w [K,H,W], mean [K,*shape], var [K,H,W]) — all zeros
    except var (var_init) so the first frame seeds component 0."""
    shape = tuple(shape)
    hw = shape[:2]
    w = torch.zeros((k,) + hw, dtype=torch.float32, device=device)
    mean = torch.zeros((k,) + shape, dtype=torch.float32, device=device)
    var = torch.full((k,) + hw, MOG2Params().var_init, dtype=torch.float32, device=device)
    return w, mean, var


def _csum(a: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, left to right."""
    out = a[..., 0]
    for c in range(1, a.shape[-1]):
        out = out + a[..., c]
    return out


def _argmin0(a: torch.Tensor) -> torch.Tensor:
    """argmin over axis 0, ties → the smallest index."""
    best = torch.zeros(a.shape[1:], dtype=torch.int64, device=a.device)
    cur = a[0]
    for k in range(1, a.shape[0]):
        better = a[k] < cur
        best = torch.where(better, k, best)
        cur = torch.where(better, a[k], cur)
    return best


def mog2_step(state, frame: torch.Tensor, params: MOG2Params = MOG2Params()):
    """One model update: (state, u8 frame (H, W) or (H, W, C) on the
    model's device) → (new state, fg mask bool (H, W))."""
    w, mean, var = state
    k = w.shape[0]
    p = params
    x = frame.to(torch.float32)
    chan = x.ndim == 3
    nc = x.shape[-1] if chan else 1
    delta = x[None] - mean  # [K, H, W(, C)]
    d2 = _csum(delta * delta) if chan else delta * delta  # [K, H, W]

    match = d2 < p.var_threshold * var * nc
    d2m = torch.where(match, d2, torch.full_like(d2, 3.4e38))
    best = _argmin0(d2m)  # [H, W]
    any_match = match.any(0)
    kidx = torch.arange(k, device=w.device).view(k, *([1] * (w.ndim - 1)))
    onehot = (kidx == best[None]) & any_match[None]

    # ---- foreground decision on the PRE-update model -------------------
    # rank by weight desc (stable): the weight of every component that
    # sorts before component i (heavier, or as heavy with a smaller index)
    cum_before = torch.zeros_like(w)
    for j in range(k):
        wj = w[j][None]
        before = (wj > w) | ((wj == w) & (j < kidx))
        cum_before = cum_before + torch.where(before, wj, 0.0)
    in_bg = cum_before < p.ratio
    bg_at_best = torch.gather(in_bg, 0, best[None])[0]
    fg = ~(any_match & bg_at_best)

    # ---- update --------------------------------------------------------
    o = onehot.to(torch.float32)
    w2 = (1.0 - p.alpha) * w + p.alpha * o
    rho = torch.full_like(w2, p.alpha) / torch.clamp(w2, min=1e-6)
    upd = o * rho
    mean2 = mean + (upd[..., None] if chan else upd) * delta
    d2c = d2 / torch.full_like(d2, nc) if nc != 1 else d2
    var2 = torch.clamp(var + upd * (d2c - var), p.var_min, p.var_max)

    # ---- replacement when nothing matched ------------------------------
    worst = _argmin0(w2 + 1e-7 * kidx.to(torch.float32))
    repl = (kidx == worst[None]) & ~any_match[None]
    w2 = torch.where(repl, p.alpha, w2)
    mean2 = torch.where(repl[..., None] if chan else repl, x[None], mean2)
    var2 = torch.where(repl, p.var_init, var2)

    w2 = w2 / w2.sum(0, keepdim=True)
    return (w2, mean2, var2), fg


def _top(state):
    """The highest-weight component's mean and variance (ties → the
    smallest k, as ``argmax``)."""
    w, mean, var = state
    top = torch.argmax(w, dim=0)
    idx = top[None, ..., None].expand(1, *mean.shape[1:]) if mean.ndim == 4 else top[None]
    return torch.gather(mean, 0, idx)[0], torch.gather(var, 0, top[None])[0]


def shadow_mask(state, frame: torch.Tensor, fg: torch.Tensor,
                tau: float = 0.5) -> torch.Tensor:
    """Shadow detection on foreground pixels (OpenCV MOG2's
    ``detectShadows`` role, Prati-style chromatic test): with B the
    top-weight background mean, brightness ratio r = (x·B)/(B·B); the
    pixel is SHADOW when τ ≤ r < 1 and its chromatic residual
    ‖x − r·B‖² is within the matched variance gate. → bool (H, W)."""
    b, v = _top(state)
    x = frame.to(torch.float32)
    if b.ndim == 3:
        r = _csum(x * b) / torch.clamp(_csum(b * b), min=1e-6)
        resid = _csum((x - r[..., None] * b) ** 2)
        nch = x.shape[-1]
    else:
        r = x / torch.clamp(b, min=1e-6)
        resid = torch.zeros_like(x)
        nch = 1
    gate = MOG2Params().var_threshold * v * nch
    return fg.bool() & (r >= tau) & (r < 1.0) & (resid <= gate)


def _frame_tensor(frame, device):
    """(tensor, whether the caller gets numpy back): a tensor or a device
    Mat stays where it is; a host Mat goes to its target device, numpy to
    ``device`` (the model's, or the card for the first frame)."""
    if hasattr(frame, "to_numpy"):  # Mat
        t = frame.device() if frame.is_on_device else as_tensor(frame.to_numpy(), frame.target)
        return (t[..., 0] if t.ndim == 3 and t.shape[-1] == 1 else t), not frame.is_on_device
    if isinstance(frame, torch.Tensor):
        return frame, False
    return as_tensor(frame, device), True


class BackgroundSubtractorMOG2:
    """Stateful wrapper (OpenCV-style ``apply``): feeds frames through
    :func:`mog2_step`; the model stays on the first frame's device. A
    tensor or a device Mat gives a tensor mask on that device; a numpy
    frame (sent to the card) or a host Mat (run where its target is)
    gives numpy, as the reference's ``apply`` does."""

    def __init__(self, k: int = 4, detect_shadows: bool = False,
                 shadow_tau: float = 0.5, **kw):
        self._k = k
        self._params = MOG2Params(**kw)
        self._state = None
        self._detect_shadows = detect_shadows
        self._shadow_tau = shadow_tau

    def apply(self, frame):
        f, to_host = _frame_tensor(frame, None if self._state is None else self._state[0].device)
        if self._state is None:
            self._state = mog2_init(f.shape, self._k, f.device)
        elif tuple(f.shape) != tuple(self._state[1].shape[1:]):
            raise ValueError(
                f"frame shape {tuple(f.shape)} != model shape "
                f"{tuple(self._state[1].shape[1:])} (create a new subtractor)")
        f = f.to(self._state[0].device)
        prev_state = self._state
        self._state, fg = mog2_step(self._state, f, self._params)
        if self._detect_shadows:
            sh = shadow_mask(prev_state, f, fg, tau=self._shadow_tau)
            out = torch.where(sh, 127, torch.where(fg, 255, 0)).to(torch.uint8)
        else:
            out = fg
        return out.cpu().numpy() if to_host else out

    @property
    def background(self) -> np.ndarray:
        """Highest-weight component's mean (u8) — the modeled background."""
        if self._state is None:
            raise RuntimeError("apply() at least one frame first")
        sel, _ = _top(self._state)
        return torch.clamp(torch.round(sel), 0, 255).to(torch.uint8).cpu().numpy()


# ---------------------------------------------------------------- oracle

def mog2_step_numpy(state, frame: np.ndarray,
                    params: MOG2Params = MOG2Params()):
    """Same frozen spec, float64 loops (oracle)."""
    w, mean, var = [np.array(s, np.float64) for s in state]
    p = params
    x = frame.astype(np.float64)
    chan = x.ndim == 3
    nc = x.shape[-1] if chan else 1
    k = w.shape[0]
    h, wd = w.shape[1:]
    fg = np.zeros((h, wd), bool)
    for yy in range(h):
        for xx in range(wd):
            xv = x[yy, xx] if chan else np.array([x[yy, xx]])
            d2s = np.array([
                np.sum((xv - (mean[c, yy, xx] if chan else [mean[c, yy, xx]])) ** 2)
                for c in range(k)
            ])
            matches = d2s < p.var_threshold * var[:, yy, xx] * nc
            order = sorted(range(k), key=lambda c: (-w[c, yy, xx], c))
            cum = 0.0
            in_bg = np.zeros(k, bool)
            for c in order:
                in_bg[c] = cum < p.ratio
                cum += w[c, yy, xx]
            if matches.any():
                best = int(np.argmin(np.where(matches, d2s, np.inf)))
                fg[yy, xx] = not in_bg[best]
                for c in range(k):
                    o = 1.0 if c == best else 0.0
                    w[c, yy, xx] = (1 - p.alpha) * w[c, yy, xx] + p.alpha * o
                rho = p.alpha / max(w[best, yy, xx], 1e-6)
                if chan:
                    mean[best, yy, xx] += rho * (xv - mean[best, yy, xx])
                else:
                    mean[best, yy, xx] += rho * (xv[0] - mean[best, yy, xx])
                var[best, yy, xx] += rho * (d2s[best] / nc - var[best, yy, xx])
                var[best, yy, xx] = min(max(var[best, yy, xx], p.var_min), p.var_max)
            else:
                fg[yy, xx] = True
                w[:, yy, xx] *= 1 - p.alpha
                worst = int(np.argmin(w[:, yy, xx] + 1e-7 * np.arange(k)))
                w[worst, yy, xx] = p.alpha
                mean[worst, yy, xx] = xv if chan else xv[0]
                var[worst, yy, xx] = p.var_init
            w[:, yy, xx] /= w[:, yy, xx].sum()
    return (w, mean, var), fg
