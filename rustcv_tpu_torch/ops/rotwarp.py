"""Rotation warpers for panorama compositing (OpenCV
``PyRotationWarper`` role, cylindrical / spherical / plane types).

Frozen spec (float64 maps, bilinear sampling through ops/warp's
remap): a destination pixel (u, v) in warped coordinates maps to the
unit ray of the projection model, rotated by Rᵀ, and projected through
K — the standard OpenCV detail::RotationWarper backward maps:

- cylindrical: ray = (sin(u/s), v/s, cos(u/s));
- spherical:   ray = (sin(u/s)·sin(v/s)? — cv2's convention is
  x = s·atan2(X, Z), y = s·(π − acos(Y/‖P‖)) — inverted here exactly);
- plane:       ray = (u/s, v/s, 1).

The warped ROI (corner + size) comes from projecting the source
border, matching cv2's detect-then-build flow; tests compare both the
returned corner and the pixel content against cv2.PyRotationWarper
(≥0.9 correlation on overlapping area — interpolation details differ
by ≤1 px at the seams).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .warp import remap_numpy


def _forward(xyz: np.ndarray, kind: str, scale: float) -> np.ndarray:
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    if kind == "plane":
        return np.stack([scale * x / z, scale * y / z], -1)
    if kind == "cylindrical":
        return np.stack([scale * np.arctan2(x, z),
                         scale * y / np.hypot(x, z)], -1)
    if kind == "spherical":
        u = scale * np.arctan2(x, z)
        w = np.sqrt(x * x + y * y + z * z)
        v = scale * (np.pi - np.arccos(np.clip(y / np.maximum(w, 1e-12),
                                               -1, 1)))
        return np.stack([u, v], -1)
    raise ValueError(f"unknown warper type {kind!r}")


def _backward(uv_u: np.ndarray, uv_v: np.ndarray, kind: str,
              scale: float) -> np.ndarray:
    if kind == "plane":
        return np.stack([uv_u / scale, uv_v / scale,
                         np.ones_like(uv_u)], -1)
    if kind == "cylindrical":
        return np.stack([np.sin(uv_u / scale), uv_v / scale,
                         np.cos(uv_u / scale)], -1)
    if kind == "spherical":
        phi = np.pi - uv_v / scale          # angle from +Y
        y = np.cos(phi)
        r = np.sin(phi)
        return np.stack([r * np.sin(uv_u / scale), y,
                         r * np.cos(uv_u / scale)], -1)
    raise ValueError(f"unknown warper type {kind!r}")


class RotationWarper:
    """``RotationWarper(kind, scale).warp(img, K, R)`` →
    (corner (x, y), warped u8 image)."""

    def __init__(self, kind: str, scale: float):
        self.kind = kind
        self.scale = float(scale)

    def warp(self, img: np.ndarray, k, r
             ) -> Tuple[Tuple[int, int], np.ndarray]:
        a = np.asarray(img)
        h, w = a.shape[:2]
        k = np.asarray(k, np.float64)
        r = np.asarray(r, np.float64)
        # project the source border to find the warped ROI
        bx = np.concatenate([np.arange(w), np.full(h, w - 1.0),
                             np.arange(w)[::-1], np.zeros(h)])
        by = np.concatenate([np.zeros(w), np.arange(h),
                             np.full(w, h - 1.0), np.arange(h)[::-1]])
        rays = np.stack([bx, by, np.ones_like(bx)], -1) @ \
            np.linalg.inv(k).T @ r.T
        uv = _forward(rays, self.kind, self.scale)
        u0, v0 = np.floor(uv.min(axis=0)).astype(int)
        u1, v1 = np.ceil(uv.max(axis=0)).astype(int)
        out_w, out_h = u1 - u0 + 1, v1 - v0 + 1
        us, vs = np.meshgrid(np.arange(u0, u1 + 1, dtype=np.float64),
                             np.arange(v0, v1 + 1, dtype=np.float64))
        rays_b = _backward(us, vs, self.kind, self.scale)
        cam = rays_b @ r @ k.T  # (Rᵀ ray) projected: ray·Rᵀᵀ = ray·R
        valid = cam[..., 2] > 1e-9
        mx = np.where(valid, cam[..., 0] / np.where(valid, cam[..., 2],
                                                    1.0), -1.0)
        my = np.where(valid, cam[..., 1] / np.where(valid, cam[..., 2],
                                                    1.0), -1.0)
        if a.ndim == 3:
            out = np.stack([remap_numpy(a[..., c],
                                        mx.astype(np.float32),
                                        my.astype(np.float32))
                            for c in range(a.shape[2])], -1)
        else:
            out = remap_numpy(a, mx.astype(np.float32),
                              my.astype(np.float32))
        inside = (valid & (mx >= 0) & (mx <= w - 1) & (my >= 0)
                  & (my <= h - 1))
        if out.ndim == 3:
            out = np.where(inside[..., None], out, 0)
        else:
            out = np.where(inside, out, 0)
        return (int(u0), int(v0)), out.astype(a.dtype)
