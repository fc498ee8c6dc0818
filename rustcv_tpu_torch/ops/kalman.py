"""Kalman filtering (port of ``rustcv_tpu.ops.kalman``; OpenCV
``cv::KalmanFilter`` role).

Three layers:

- :class:`KalmanFilter` — the OpenCV object API (predict/correct with the
  exact member names), host float64, one tracker: the frozen spec of
  :mod:`.golden`.
- :func:`predict_batch` / :func:`correct_batch` — float32 updates of a
  bank of N trackers (``(N, S)`` states, ``(N, S, S)`` covariances, model
  matrices shared or per tracker) on the tensors' device (a numpy input
  goes to the card): batched einsums in full float32 (no TF32 on the
  card, :func:`.tensors.full_f32`) and one batched ``solve_ex`` (no error
  check, so no host sync).
- :func:`filter_scan` — a whole T-step pass over a measurement sequence:
  a Python loop of predict/correct with no host read, so the card runs the
  steps back to back.

Tolerance contract (the reference's): float32 against the float64 golden
at rtol 1e-4 over conditioned models.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import golden
from .tensors import as_tensor, full_f32

__all__ = ["KalmanFilter", "predict_batch", "correct_batch", "filter_scan"]


class KalmanFilter:
    """OpenCV ``cv::KalmanFilter`` API: construct with state/measurement
    (and optional control) dimensions, set the model matrices, then
    alternate ``predict()``/``correct(z)``. Member names match OpenCV's
    (snake_case): ``transition_matrix``, ``measurement_matrix``,
    ``process_noise_cov``, ``measurement_noise_cov``, ``control_matrix``,
    ``state_pre/state_post``, ``error_cov_pre/error_cov_post``, ``gain``.

    Like OpenCV, ``predict()`` copies the prior into the posterior so that
    consecutive predicts without a correct keep propagating."""

    def __init__(self, dynam_params: int, measure_params: int,
                 control_params: int = 0):
        if dynam_params < 1 or measure_params < 1:
            raise ValueError("state and measurement dims must be >= 1")
        d, m, c = dynam_params, measure_params, control_params
        self.transition_matrix = np.eye(d)
        self.measurement_matrix = np.zeros((m, d))
        self.process_noise_cov = np.eye(d)
        self.measurement_noise_cov = np.eye(m)
        self.control_matrix = np.zeros((d, c)) if c > 0 else None
        self.state_pre = np.zeros(d)
        self.state_post = np.zeros(d)
        self.error_cov_pre = np.zeros((d, d))
        self.error_cov_post = np.zeros((d, d))
        self.gain = np.zeros((d, m))

    def predict(self, control: Optional[np.ndarray] = None) -> np.ndarray:
        # Accept column-vector state from callers (cv2 idiom stores
        # statePost as (d, 1)); keep the internal state 1-D so the
        # innovation below stays a vector, not a broadcast outer product.
        self.state_post = np.asarray(self.state_post,
                                     np.float64).reshape(-1)
        self.state_pre, self.error_cov_pre = golden.kalman_predict(
            self.state_post, self.error_cov_post,
            self.transition_matrix, self.process_noise_cov,
            self.control_matrix, control,
        )
        # OpenCV copies pre → post in predict (kalman.cpp): repeated
        # predicts without a correct keep extrapolating.
        self.state_post = self.state_pre.copy()
        self.error_cov_post = self.error_cov_pre.copy()
        return self.state_pre

    def correct(self, measurement: np.ndarray) -> np.ndarray:
        self.state_pre = np.asarray(self.state_pre, np.float64).reshape(-1)
        measurement = np.asarray(measurement, np.float64).reshape(-1)
        self.state_post, self.error_cov_post, self.gain = golden.kalman_correct(
            self.state_pre, self.error_cov_pre, measurement,
            self.measurement_matrix, self.measurement_noise_cov,
        )
        return self.state_post


def _device_of(*xs) -> torch.device:
    """The first tensor's device, else the card."""
    return next((x.device for x in xs if isinstance(x, torch.Tensor)), torch.device("cuda"))


def _f32(dev, *xs):
    return [as_tensor(x, dev).to(torch.float32) for x in xs]


def predict_batch(x, P, A, Q):
    """Batched time update: x (N, S), P (N, S, S); A/Q shared (S, S) or
    per-tracker (N, S, S). Returns (x', P') in float32."""
    dev = _device_of(x, P, A, Q)
    x, P, A, Q = _f32(dev, x, P, A, Q)
    # Branch on rank: an ellipsis einsum would SUM a per-tracker A over
    # the bank instead of applying each tracker's own.
    a = "nij" if A.ndim == 3 else "ij"
    al = a.replace("i", "l").replace("j", "k")
    with full_f32(dev):
        xp = torch.einsum(f"{a},nj->ni", A, x)
        Pp = torch.einsum(f"{a},njk,{al}->nil", A, P, A) + Q
    return xp, Pp


def correct_batch(x, P, z, H, R):
    """Batched measurement update: z (N, M); H (M, S), R (M, M) shared (or
    batched with a leading N). Returns (x⁺ (N, S), P⁺ (N, S, S), K
    (N, S, M)) in float32 — the formulas of golden.kalman_correct."""
    dev = _device_of(x, P, z, H, R)
    x, P, z, H, R = _f32(dev, x, P, z, H, R)
    h = "nij" if H.ndim == 3 else "ij"
    hj = h.replace("i", "p").replace("j", "k").replace("p", "j")
    with full_f32(dev):
        HP = torch.einsum(f"{h},njk->nik", H, P)             # (N, M, S)
        S = torch.einsum(f"nik,{hj}->nij", HP, H) + R        # (N, M, M)
        K = torch.linalg.solve_ex(S, HP)[0].transpose(1, 2)  # (N, S, M)
        innov = z - torch.einsum(f"{h},nj->ni", H, x)
        xn = x + torch.einsum("nij,nj->ni", K, innov)
        Pn = P - torch.einsum("nij,njk->nik", K, HP)
    return xn, Pn, K


def filter_scan(x0, P0, zs, A, H, Q, R):
    """A full predict/correct pass over a measurement sequence: zs
    (T, N, M) → filtered states (T, N, S) and the final (x, P). The T
    steps are issued back to back with no host read."""
    dev = _device_of(x0, P0, zs, A, H, Q, R)
    x, P, zs, A, H, Q, R = _f32(dev, x0, P0, zs, A, H, Q, R)
    xs = []
    for t in range(zs.shape[0]):
        xp, Pp = predict_batch(x, P, A, Q)
        x, P, _ = correct_batch(xp, Pp, zs[t], H, R)
        xs.append(x)
    out = torch.stack(xs) if xs else x.new_zeros((0,) + tuple(x.shape))
    return out, x, P
