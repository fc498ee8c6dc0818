"""KNN background subtraction (port of ``rustcv_tpu.ops.knn_bgsub``;
OpenCV ``BackgroundSubtractorKNN`` role, Zivkovic & van der Heijden 2006 —
the sample-consensus companion to MOG2, ops/bgsub.py).

The model is an [N, H, W(, C)] float32 sample bank per pixel on the
frame's device; matching is N squared-distance compares, the k-NN vote a
sum of match bits, and the sample replacement writes the slot picked by a
compare with a cyclic slot clock: a 0-d int32 tensor on the device, so
nothing per frame reads it on the host. State threads functionally
through :func:`knn_step`.

Frozen spec (per pixel, per frame x; deterministic — OpenCV's
stochastic sample replacement is replaced by a cyclic clock, a
documented divergence that keeps device/oracle bit-agreement):
- match_i = Σ_c (x_c − s_ic)² < dist2_threshold (default 400);
- background iff Σ match_i ≥ k_nn (default 2);
- init: every slot holds the init frame;
- update every ``update_period`` frames (default 1): the slot at
  ``clock mod N`` is overwritten with x IF the pixel was background,
  or always after ``n_fg_max`` consecutive foreground frames (absorbs
  scene changes; counter resets on background) — then clock += 1;
- shadows are not modeled here (MOG2's detect_shadows covers the role).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .bgsub import _csum, _frame_tensor
from .tensors import as_tensor


class KNNParams(NamedTuple):
    dist2_threshold: float = 400.0
    k_nn: int = 2
    update_period: int = 1
    n_fg_max: int = 30


class KNNState(NamedTuple):
    samples: torch.Tensor   # float32 [N, H, W(, C)]
    clock: torch.Tensor     # int32 0-d — cyclic replacement slot
    fg_run: torch.Tensor    # int32 [H, W] consecutive-foreground counter


def knn_init(frame, n_samples: int = 7) -> KNNState:
    """Bank seeded with the init frame in every slot (matching pixels
    immediately read background; a zero bank would deadlock — nothing
    writes until something reads background). A tensor frame keeps its
    device; numpy goes to the card."""
    x = as_tensor(frame).to(torch.float32)
    return KNNState(
        x[None].expand((n_samples,) + tuple(x.shape)).clone(),
        torch.zeros((), dtype=torch.int32, device=x.device),
        torch.zeros(tuple(x.shape[:2]), dtype=torch.int32, device=x.device),
    )


def knn_step(state: KNNState, frame: torch.Tensor,
             params: KNNParams = KNNParams()):
    """→ (new_state, fg_mask bool [H, W])."""
    x = frame.to(torch.float32)
    s = state.samples
    if x.ndim != s.ndim - 1:
        raise ValueError("frame rank must be samples rank - 1")
    d2 = (s - x[None]) ** 2
    if x.ndim == 3:
        d2 = _csum(d2)
    match = d2 < params.dist2_threshold          # [N, H, W]
    bg = match.sum(0) >= params.k_nn
    fg = ~bg

    fg_run = torch.where(fg, state.fg_run + 1, 0).to(torch.int32)
    absorb = fg_run >= params.n_fg_max
    do_update = (state.clock % params.update_period) == 0
    write = (bg | absorb) & do_update            # [H, W]
    slot = state.clock // params.update_period % s.shape[0]
    one_hot = torch.arange(s.shape[0], device=s.device) == slot
    wmask = write[None] & one_hot.view(-1, 1, 1)
    if x.ndim == 3:
        wmask = wmask[..., None]
    new_samples = torch.where(wmask, x[None], s)
    fg_run = torch.where(absorb, 0, fg_run).to(torch.int32)
    return KNNState(new_samples, state.clock + 1, fg_run), fg


def knn_step_numpy(state, frame: np.ndarray,
                   params: KNNParams = KNNParams()):
    """float64 oracle — same spec, dict state {'samples','clock','fg_run'}."""
    x = np.asarray(frame, np.float64)
    s = state["samples"]
    d2 = (s - x[None]) ** 2
    if x.ndim == 3:
        d2 = d2.sum(axis=-1)
    match = d2 < params.dist2_threshold
    votes = match.sum(axis=0)
    bg = votes >= params.k_nn
    fg = ~bg
    fg_run = np.where(fg, state["fg_run"] + 1, 0)
    absorb = fg_run >= params.n_fg_max
    do_update = (state["clock"] % params.update_period) == 0
    write = (bg | absorb) & do_update
    slot = state["clock"] // params.update_period % s.shape[0]
    new_samples = s.copy()
    new_samples[slot][write] = x[write]
    fg_run = np.where(absorb, 0, fg_run)
    return {"samples": new_samples, "clock": state["clock"] + 1,
            "fg_run": fg_run}, fg


def knn_init_numpy(frame, n_samples: int = 7):
    x = np.asarray(frame, np.float64)
    return {"samples": np.tile(x[None], (n_samples,) + (1,) * x.ndim),
            "clock": 0, "fg_run": np.zeros(tuple(x.shape[:2]), np.int64)}


class BackgroundSubtractorKNN:
    """OpenCV-style object API: ``apply(frame) -> fg mask u8`` (255
    foreground); the bank stays on the first frame's device. A tensor or
    a device Mat gives a tensor mask on that device; a numpy frame (sent
    to the card) or a host Mat (run where its target is) gives numpy, as
    the reference's ``apply`` does."""

    def __init__(self, n_samples: int = 7, **kw):
        self.params = KNNParams(**kw)
        self.n_samples = n_samples
        self._state = None

    def apply(self, frame):
        f, to_host = _frame_tensor(frame, None if self._state is None
                                   else self._state.samples.device)
        if self._state is None:
            self._state = knn_init(f, self.n_samples)
        self._state, fg = knn_step(self._state, f.to(self._state.samples.device), self.params)
        out = fg.to(torch.uint8) * 255
        return out.cpu().numpy() if to_host else out

    def background(self) -> np.ndarray:
        """Mean of the sample bank (diagnostic view)."""
        if self._state is None:
            raise RuntimeError("apply() first")
        return self._state.samples.mean(0).cpu().numpy()
