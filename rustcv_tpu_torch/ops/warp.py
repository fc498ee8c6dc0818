"""Affine, perspective and polar warps and ``remap`` (port of
``rustcv_tpu.ops.warp``: OpenCV ``warpAffine`` / ``getRotationMatrix2D`` /
``warpPerspective`` / ``remap`` / ``warpPolar`` roles), on tensors where the
caller's tensor is.

Frozen spec (device bit-exact vs the NumPy oracle):
- the user matrix M (2×3, or the 3×3 homography) maps SRC → DST (OpenCV
  convention); it is inverted on the host in float64 and each destination
  pixel's source coordinate (src_x = a11·x + a12·y + a13 at pixel centres,
  no half-pixel shift; the projective divide in float64) is quantized to
  the 1/2048 weight grid BEFORE the taps are taken, so float64 trig
  residue (cos 90° ≈ 6e-17) cannot flip a tap at an exact boundary;
- bilinear: 11-bit fixed-point weights, one rounding ``(Σ + 2^21) >> 22``
  in int32 (255·2048·2048 < 2^31); nearest: round half up of the
  coordinate;
- border: "constant" (value 0 outside) or "replicate" (clamp).

The coordinate tables are float64 host numpy, cached by matrix key, and
uploaded once per (key, sizes, mode, device). The device form gathers the
four taps with ``index_select`` on the flattened image (the reference
packs a 2×2 neighbourhood into one word to gather once on the TPU; the
clamped taps are the same). ``remap`` quantizes its float32 maps on the
device in float32 (``torch.round``/``torch.floor``: exact, the scale is a
power of two). ``warp_polar`` and its legacy forms build host maps and go
through ``remap``. The ``*_cv_numpy`` forms, ``convert_maps`` and the
nearest and cubic remaps are host numpy copies of the reference.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from . import golden

BORDERS = ("constant", "replicate")
MODES = ("bilinear", "nearest")


def get_rotation_matrix_2d(
    center: Tuple[float, float], angle_deg: float, scale: float = 1.0
) -> np.ndarray:
    """OpenCV ``getRotationMatrix2D``: rotation about ``center`` by
    ``angle_deg`` (counter-clockwise for y-down images) with ``scale``."""
    a = np.deg2rad(angle_deg)
    alpha = scale * np.cos(a)
    beta = scale * np.sin(a)
    cx, cy = center
    return np.array(
        [
            [alpha, beta, (1 - alpha) * cx - beta * cy],
            [-beta, alpha, beta * cx + (1 - alpha) * cy],
        ],
        np.float64,
    )


def _invert_affine(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, np.float64).reshape(2, 3)
    a = m[:, :2]
    b = m[:, 2]
    ai = np.linalg.inv(a)
    return np.hstack([ai, (-ai @ b)[:, None]])


@lru_cache(maxsize=64)
def _coord_tables(
    m_key: tuple, src_w: int, src_h: int, dst_w: int, dst_h: int, mode: str
):
    """Per-dst-pixel source taps (int32) + 11-bit weights, float64 host
    math (the frozen spec's precision)."""
    minv = np.array(m_key, np.float64).reshape(2, 3)
    xs = np.arange(dst_w, dtype=np.float64)
    ys = np.arange(dst_h, dtype=np.float64)
    gx, gy = np.meshgrid(xs, ys)
    sx = minv[0, 0] * gx + minv[0, 1] * gy + minv[0, 2]
    sy = minv[1, 0] * gx + minv[1, 1] * gy + minv[1, 2]
    # Quantize coordinates to the 1/2048 weight grid FIRST (part of the
    # frozen spec): float64 trig residue (cos 90° ≈ 6e-17) otherwise pushes
    # exact-boundary coordinates "outside" and flips taps.
    one_f = float(golden.RESIZE_ONE)
    sx = np.round(sx * one_f) / one_f
    sy = np.round(sy * one_f) / one_f
    if mode == "nearest":
        nx = np.floor(sx + 0.5).astype(np.int64)
        ny = np.floor(sy + 0.5).astype(np.int64)
        inside = (nx >= 0) & (nx < src_w) & (ny >= 0) & (ny < src_h)
        return (
            np.clip(nx, 0, src_w - 1).astype(np.int32),
            np.clip(ny, 0, src_h - 1).astype(np.int32),
            inside,
        )
    one = golden.RESIZE_ONE
    x0 = np.floor(sx).astype(np.int64)
    y0 = np.floor(sy).astype(np.int64)
    wx = np.round((sx - x0) * one).astype(np.int32)
    wy = np.round((sy - y0) * one).astype(np.int32)
    # Left/top overhang: both clamped taps collapse to index 0, so the
    # weight is irrelevant to the spec — zero it (keeps the packed-quad
    # device form, whose second tap is index 1, bit-identical).
    wx = np.where(x0 < 0, 0, wx)
    wy = np.where(y0 < 0, 0, wy)
    # "inside" means all four taps land in-bounds after the clamp-free
    # test; the clamped taps below implement replicate, the mask constant.
    inside = (sx >= 0) & (sx <= src_w - 1) & (sy >= 0) & (sy <= src_h - 1)
    x0c = np.clip(x0, 0, src_w - 1).astype(np.int32)
    x1c = np.clip(x0 + 1, 0, src_w - 1).astype(np.int32)
    y0c = np.clip(y0, 0, src_h - 1).astype(np.int32)
    y1c = np.clip(y0 + 1, 0, src_h - 1).astype(np.int32)
    return x0c, x1c, y0c, y1c, wx, wy, inside


def _as_key(m: np.ndarray) -> tuple:
    return tuple(np.asarray(m, np.float64).reshape(6).tolist())


@lru_cache(maxsize=16)
def _device_tables(kind: str, key: tuple, src_w: int, src_h: int, dst_w: int, dst_h: int,
                   mode: str, device: torch.device):
    """The host tables of ``kind`` ("affine" or "perspective") uploaded to
    ``device``: (flat tap indices, weights, inside mask), once per key."""
    build = _coord_tables if kind == "affine" else _persp_tables
    tabs = build(key, src_w, src_h, dst_w, dst_h, mode)
    if mode == "nearest":
        nx, ny, inside = tabs
        idx = (ny.astype(np.int64) * src_w + nx).astype(np.int32).reshape(-1)
        taps, weights = (idx,), ()
    else:
        x0, x1, y0, y1, wx, wy, inside = tabs
        row0 = y0.astype(np.int64) * src_w
        row1 = y1.astype(np.int64) * src_w
        taps = tuple((r + c).astype(np.int32).reshape(-1)
                     for r, c in ((row0, x0), (row0, x1), (row1, x0), (row1, x1)))
        weights = (wx, wy)

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return (tuple(up(t) for t in taps), tuple(up(w.astype(np.int32)) for w in weights),
            up(inside))


def _gather(img: torch.Tensor, idx: torch.Tensor, out_hw) -> torch.Tensor:
    """``img`` (H, W[, C]) at flat pixel indices → (*out_hw[, C]) int32."""
    flat = img.reshape(img.shape[0] * img.shape[1], -1)
    return flat.index_select(0, idx).to(torch.int32).reshape(*out_hw, *img.shape[2:])


def _lerp(img: torch.Tensor, taps, wx: torch.Tensor, wy: torch.Tensor, out_hw) -> torch.Tensor:
    """The fixed-point bilinear spec: four taps, 11-bit weights, one
    rounding; int32 throughout."""
    one = golden.RESIZE_ONE
    if img.ndim == 3:
        wx, wy = wx[..., None], wy[..., None]
    i00, i01, i10, i11 = (_gather(img, t, out_hw) for t in taps)
    top = i00 * (one - wx) + i01 * wx
    bot = i10 * (one - wx) + i11 * wx
    acc = top * (one - wy) + bot * wy
    return (acc + (1 << (2 * golden.RESIZE_SHIFT - 1))) >> (2 * golden.RESIZE_SHIFT)


def _finish(img: torch.Tensor, out: torch.Tensor, inside: torch.Tensor, border: str):
    out = out.clamp(0, 255).to(torch.uint8)
    if border == "constant":
        mask = inside[..., None] if img.ndim == 3 else inside
        out = torch.where(mask, out, torch.zeros((), dtype=torch.uint8, device=out.device))
    return out


def _warp_tables(img: torch.Tensor, kind: str, key: tuple, dst_w: int, dst_h: int,
                 mode: str, border: str) -> torch.Tensor:
    src_h, src_w = img.shape[0], img.shape[1]
    taps, weights, inside = _device_tables(kind, key, src_w, src_h, dst_w, dst_h, mode,
                                           img.device)
    if mode == "nearest":
        out = _gather(img, taps[0], (dst_h, dst_w))
    else:
        wx, wy = weights
        out = _lerp(img, taps, wx, wy, (dst_h, dst_w))
    return _finish(img, out, inside, border)


def warp_affine(
    img: torch.Tensor,
    m,
    dst_size: Tuple[int, int],
    mode: str = "bilinear",
    border: str = "constant",
) -> torch.Tensor:
    """Device affine warp: u8 (H, W[, C]) × M (2×3 src→dst) →
    (dst_h, dst_w[, C]) u8. ``dst_size`` is (w, h)."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r} (one of {MODES})")
    if border not in BORDERS:
        raise ValueError(f"unknown border {border!r} (one of {BORDERS})")
    key = _as_key(_invert_affine(m))
    return _warp_tables(img, "affine", key, int(dst_size[0]), int(dst_size[1]), mode, border)


def remap(img: torch.Tensor, map_x, map_y, border: str = "constant") -> torch.Tensor:
    """OpenCV ``remap``: sample u8 ``img`` (H, W[, C]) at float32 per-pixel
    source coordinates (``map_x``/``map_y``, any output shape; host maps
    are uploaded to the image's device) — the undistort/rectify primitive.

    Same fixed-point bilinear spec as warpAffine (11-bit weights quantized
    from the maps in float32, one rounding)."""
    if border not in BORDERS:
        raise ValueError(f"unknown border {border!r} (one of {BORDERS})")
    src_h, src_w = img.shape[0], img.shape[1]
    one = golden.RESIZE_ONE
    mx = torch.as_tensor(map_x, device=img.device).to(torch.float32)
    my = torch.as_tensor(map_y, device=img.device).to(torch.float32)
    # Quantize coordinates to the weight grid first (the affine spec's
    # rule, applied to the maps).
    sx = torch.round(mx * one) / one
    sy = torch.round(my * one) / one
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    wx = torch.round((sx - x0) * one).to(torch.int32)
    wy = torch.round((sy - y0) * one).to(torch.int32)
    wx = torch.where(x0 < 0, 0, wx)
    wy = torch.where(y0 < 0, 0, wy)
    inside = (sx >= 0) & (sx <= src_w - 1) & (sy >= 0) & (sy <= src_h - 1)
    x0c = x0.clamp(0, src_w - 1).to(torch.int32)
    y0c = y0.clamp(0, src_h - 1).to(torch.int32)
    x1c = (x0c + 1).clamp(max=src_w - 1)
    y1c = (y0c + 1).clamp(max=src_h - 1)
    taps = tuple((r * src_w + c).reshape(-1)
                 for r, c in ((y0c, x0c), (y0c, x1c), (y1c, x0c), (y1c, x1c)))
    out = _lerp(img, taps, wx, wy, tuple(mx.shape))
    return _finish(img, out, inside, border)


def remap_numpy(img: np.ndarray, map_x: np.ndarray, map_y: np.ndarray,
                border: str = "constant") -> np.ndarray:
    """Oracle for :func:`remap` — same spec, NumPy (maps quantized through
    float32 exactly as the device sees them)."""
    if border not in BORDERS:
        raise ValueError(f"unknown border {border!r}")
    src_h, src_w = img.shape[:2]
    one = golden.RESIZE_ONE
    sx = np.round(map_x.astype(np.float32).astype(np.float64) * one) / one
    sy = np.round(map_y.astype(np.float32).astype(np.float64) * one) / one
    x0 = np.floor(sx).astype(np.int64)
    y0 = np.floor(sy).astype(np.int64)
    wx = np.round((sx - x0) * one).astype(np.int64)
    wy = np.round((sy - y0) * one).astype(np.int64)
    wx = np.where(x0 < 0, 0, wx)
    wy = np.where(y0 < 0, 0, wy)
    inside = (sx >= 0) & (sx <= src_w - 1) & (sy >= 0) & (sy <= src_h - 1)
    x0c = np.clip(x0, 0, src_w - 1)
    x1c = np.clip(x0c + 1, 0, src_w - 1)
    y0c = np.clip(y0, 0, src_h - 1)
    y1c = np.clip(y0c + 1, 0, src_h - 1)
    a = img.astype(np.int64)
    if img.ndim == 3:
        wx = wx[..., None]
        wy = wy[..., None]
        inside = inside[..., None]
    top = a[y0c, x0c] * (one - wx) + a[y0c, x1c] * wx
    bot = a[y1c, x0c] * (one - wx) + a[y1c, x1c] * wx
    acc = top * (one - wy) + bot * wy
    out = (acc + (1 << (2 * golden.RESIZE_SHIFT - 1))) >> (2 * golden.RESIZE_SHIFT)
    out = np.clip(out, 0, 255).astype(np.uint8)
    if border == "constant":
        out = np.where(inside, out, 0)
    return out


def warp_affine_numpy(
    img: np.ndarray,
    m,
    dst_size: Tuple[int, int],
    mode: str = "bilinear",
    border: str = "constant",
) -> np.ndarray:
    """Float64 oracle — same frozen spec, pure NumPy."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    if border not in BORDERS:
        raise ValueError(f"unknown border {border!r}")
    dst_w, dst_h = int(dst_size[0]), int(dst_size[1])
    src_h, src_w = img.shape[:2]
    key = _as_key(_invert_affine(m))
    a = img.astype(np.int64)
    if mode == "nearest":
        nx, ny, inside = _coord_tables(key, src_w, src_h, dst_w, dst_h, mode)
        out = a[ny, nx]
    else:
        x0, x1, y0, y1, wx, wy, inside = _coord_tables(
            key, src_w, src_h, dst_w, dst_h, mode
        )
        one = golden.RESIZE_ONE
        wxe = wx[..., None].astype(np.int64) if img.ndim == 3 else wx.astype(np.int64)
        wye = wy[..., None].astype(np.int64) if img.ndim == 3 else wy.astype(np.int64)
        top = a[y0, x0] * (one - wxe) + a[y0, x1] * wxe
        bot = a[y1, x0] * (one - wxe) + a[y1, x1] * wxe
        acc = top * (one - wye) + bot * wye
        out = (acc + (1 << (2 * golden.RESIZE_SHIFT - 1))) >> (
            2 * golden.RESIZE_SHIFT
        )
    out = np.clip(out, 0, 255).astype(np.uint8)
    if border == "constant":
        maske = inside[..., None] if img.ndim == 3 else inside
        out = np.where(maske, out, 0)
    return out


def get_perspective_transform(src_pts, dst_pts) -> np.ndarray:
    """OpenCV ``getPerspectiveTransform``: exact 3×3 homography mapping 4
    source points to 4 destination points (float64 linear solve)."""
    src = np.asarray(src_pts, np.float64).reshape(4, 2)
    dst = np.asarray(dst_pts, np.float64).reshape(4, 2)
    a = np.zeros((8, 8))
    b = np.zeros(8)
    for i, ((x, y), (u, v)) in enumerate(zip(src, dst)):
        a[2 * i] = [x, y, 1, 0, 0, 0, -u * x, -u * y]
        a[2 * i + 1] = [0, 0, 0, x, y, 1, -v * x, -v * y]
        b[2 * i] = u
        b[2 * i + 1] = v
    h = np.linalg.solve(a, b)
    return np.append(h, 1.0).reshape(3, 3)


@lru_cache(maxsize=64)
def _persp_tables(
    h_key: tuple, src_w: int, src_h: int, dst_w: int, dst_h: int, mode: str
):
    """Perspective coordinate tables: H maps SRC→DST (OpenCV convention);
    dst pixels pull from src via H⁻¹ with the projective divide done here
    in float64 — the device still sees pure integer taps/weights."""
    hinv = np.linalg.inv(np.array(h_key, np.float64).reshape(3, 3))
    xs = np.arange(dst_w, dtype=np.float64)
    ys = np.arange(dst_h, dtype=np.float64)
    gx, gy = np.meshgrid(xs, ys)
    den = hinv[2, 0] * gx + hinv[2, 1] * gy + hinv[2, 2]
    den = np.where(np.abs(den) < 1e-12, 1e-12, den)
    sx = (hinv[0, 0] * gx + hinv[0, 1] * gy + hinv[0, 2]) / den
    sy = (hinv[1, 0] * gx + hinv[1, 1] * gy + hinv[1, 2]) / den
    one_f = float(golden.RESIZE_ONE)
    sx = np.round(sx * one_f) / one_f
    sy = np.round(sy * one_f) / one_f
    if mode == "nearest":
        nx = np.floor(sx + 0.5).astype(np.int64)
        ny = np.floor(sy + 0.5).astype(np.int64)
        inside = (nx >= 0) & (nx < src_w) & (ny >= 0) & (ny < src_h)
        return (
            np.clip(nx, 0, src_w - 1).astype(np.int32),
            np.clip(ny, 0, src_h - 1).astype(np.int32),
            inside,
        )
    one = golden.RESIZE_ONE
    x0 = np.floor(sx).astype(np.int64)
    y0 = np.floor(sy).astype(np.int64)
    wx = np.round((sx - x0) * one).astype(np.int32)
    wy = np.round((sy - y0) * one).astype(np.int32)
    wx = np.where(x0 < 0, 0, wx)
    wy = np.where(y0 < 0, 0, wy)
    inside = (sx >= 0) & (sx <= src_w - 1) & (sy >= 0) & (sy <= src_h - 1)
    x0c = np.clip(x0, 0, src_w - 1).astype(np.int32)
    x1c = np.clip(x0 + 1, 0, src_w - 1).astype(np.int32)
    y0c = np.clip(y0, 0, src_h - 1).astype(np.int32)
    y1c = np.clip(y0 + 1, 0, src_h - 1).astype(np.int32)
    return x0c, x1c, y0c, y1c, wx, wy, inside


def warp_perspective(
    img: torch.Tensor,
    h_mat,
    dst_size: Tuple[int, int],
    mode: str = "bilinear",
    border: str = "constant",
) -> torch.Tensor:
    """OpenCV ``warpPerspective``: u8 (H, W[, C]) × 3×3 homography
    (src→dst) → (dst_h, dst_w[, C]) u8 — the sampling spec of
    :func:`warp_affine`; the projective divide lives in the host table
    build."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r} (one of {MODES})")
    if border not in BORDERS:
        raise ValueError(f"unknown border {border!r} (one of {BORDERS})")
    key = tuple(np.asarray(h_mat, np.float64).reshape(9).tolist())
    return _warp_tables(img, "perspective", key, int(dst_size[0]), int(dst_size[1]), mode,
                        border)


def warp_perspective_numpy(
    img: np.ndarray,
    h_mat,
    dst_size: Tuple[int, int],
    mode: str = "bilinear",
    border: str = "constant",
) -> np.ndarray:
    """Oracle for :func:`warp_perspective` (same tables, NumPy lerp)."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    if border not in BORDERS:
        raise ValueError(f"unknown border {border!r}")
    dst_w, dst_h = int(dst_size[0]), int(dst_size[1])
    src_h, src_w = img.shape[:2]
    key = tuple(np.asarray(h_mat, np.float64).reshape(9).tolist())
    a = img.astype(np.int64)
    if mode == "nearest":
        nx, ny, inside = _persp_tables(key, src_w, src_h, dst_w, dst_h, mode)
        out = a[ny, nx]
    else:
        x0, x1, y0, y1, wx, wy, inside = _persp_tables(
            key, src_w, src_h, dst_w, dst_h, mode
        )
        one = golden.RESIZE_ONE
        wxe = wx[..., None].astype(np.int64) if img.ndim == 3 else wx.astype(np.int64)
        wye = wy[..., None].astype(np.int64) if img.ndim == 3 else wy.astype(np.int64)
        top = a[y0, x0] * (one - wxe) + a[y0, x1] * wxe
        bot = a[y1, x0] * (one - wxe) + a[y1, x1] * wxe
        acc = top * (one - wye) + bot * wye
        out = (acc + (1 << (2 * golden.RESIZE_SHIFT - 1))) >> (
            2 * golden.RESIZE_SHIFT
        )
    out = np.clip(out, 0, 255).astype(np.uint8)
    if border == "constant":
        maske = inside[..., None] if img.ndim == 3 else inside
        out = np.where(maske, out, 0)
    return out


# ---------------------------------------------------------------------------
# Polar warps (OpenCV warpPolar / linearPolar / logPolar roles)
# ---------------------------------------------------------------------------
# Frozen spec (host float64 map build, device = the remap spec above):
#   forward  dst(φ_row, ρ_col) samples src at
#       angle = φ_row · 2π / dst_h
#       rho   = ρ_col · max_radius / dst_w            (linear)
#       rho   = exp(ρ_col · ln(max_radius) / dst_w) − 1   (semilog)
#       (map_x, map_y) = center + rho · (cos angle, sin angle)
#   inverse  dst(y, x) samples the POLAR image at
#       rho = |(x, y) − center|, angle = atan2 wrapped to [0, 2π)
#       (map_x, map_y) = (rho-index of rho, angle / (2π / src_polar_h))
# Out-of-range samples take the remap "constant" (0) border unless told
# otherwise. Maps are host tables like undistort's: per-geometry, built
# once, traced into the device remap — changing center/radius never
# recompiles.


def fast_atan2_deg_f32(y: np.ndarray, x: np.ndarray) -> np.ndarray:
    """cv2's ``fastAtan2`` (mathfuncs.cpp): degree-domain polynomial
    approximation evaluated in float32 — the angle source inside
    cartToPolar/phase and the inverse warpPolar maps."""
    f = np.float32
    deg = 180.0 / np.pi
    p1 = f(0.9997878412794807 * deg)
    p3 = f(-0.3258083974640975 * deg)
    p5 = f(0.1555786518463281 * deg)
    p7 = f(-0.04432655554792128 * deg)
    eps = f(np.finfo(np.float64).eps)
    xf = np.asarray(x, np.float32)
    yf = np.asarray(y, np.float32)
    ax, ay = np.abs(xf), np.abs(yf)
    big = ax >= ay
    c = np.where(big, ay / (ax + eps), ax / (ay + eps)).astype(np.float32)
    c2 = c * c
    poly = (((p7 * c2 + p5) * c2 + p3) * c2 + p1) * c
    a = np.where(big, poly, f(90.0) - poly).astype(np.float32)
    a = np.where(xf < 0, f(180.0) - a, a).astype(np.float32)
    a = np.where(yf < 0, f(360.0) - a, a).astype(np.float32)
    return a


def warp_polar_inverse_maps_cv(polar_size: Tuple[int, int],
                               dsize: Tuple[int, int],
                               center: Tuple[float, float],
                               max_radius: float, semilog: bool = False):
    """cv2's EXACT inverse-warpPolar map construction (imgwarp.cpp): the
    polar source is wrap-padded by ANGLE_BORDER=1 rows, per-pixel angle
    comes from float32 cartToPolar (fastAtan2 degrees → ·π/180 in f32),
    magnitude from float32 hypot, then the Kangle/Kmag scalings are f32
    multiplies. Returns (mx, my) addressing the PADDED polar image
    (caller pads 1 row top/bottom with wrap)."""
    ph, pw = polar_size
    dh, dw = dsize
    f = np.float32
    cx, cy = f(center[0]), f(center[1])
    ys, xs = np.mgrid[0:dh, 0:dw].astype(np.float32)
    bufx = xs - cx
    bufy = ys - cy
    # cartToPolar f32: magnitude + angle (degrees → radians, f32 scale)
    mag = np.sqrt(bufx * bufx + bufy * bufy, dtype=np.float32)
    ang = fast_atan2_deg_f32(bufy, bufx) * f(np.pi / 180.0)
    if semilog:
        # same Klog the forward pass uses (log(maxRadius)/width)
        klog = np.log(max_radius) / pw  # double
        rho = (np.log1p(mag.astype(np.float32)) * f(1.0 / klog))
    else:
        kmag = max_radius / pw  # double
        rho = mag * f(1.0 / kmag)
    kangle = 2.0 * np.pi / ph  # double
    phi = ang * f(1.0 / kangle) + f(1.0)  # +ANGLE_BORDER
    return rho.astype(np.float32), phi.astype(np.float32)


def warp_polar_maps(src_size: Tuple[int, int], center: Tuple[float, float],
                    max_radius: float, dst_size: Tuple[int, int],
                    semilog: bool = False, inverse: bool = False):
    """Build (map_x, map_y) float32 for :func:`remap` implementing the
    polar spec above. ``src_size``/``dst_size`` are (h, w)."""
    cx, cy = float(center[0]), float(center[1])
    dst_h, dst_w = dst_size
    if not inverse:
        phi = (np.arange(dst_h, dtype=np.float64) * (2.0 * np.pi / dst_h))
        idx = np.arange(dst_w, dtype=np.float64)
        if semilog:
            rho = np.exp(idx * (np.log(max(max_radius, 1e-12)) / dst_w)) - 1.0
        else:
            rho = idx * (max_radius / dst_w)
        mx = cx + rho[None, :] * np.cos(phi)[:, None]
        my = cy + rho[None, :] * np.sin(phi)[:, None]
    else:
        # src here is the POLAR image; dst is cartesian
        src_h, src_w = src_size
        ys, xs = np.mgrid[0:dst_h, 0:dst_w].astype(np.float64)
        dx, dy = xs - cx, ys - cy
        rho = np.hypot(dx, dy)
        ang = np.mod(np.arctan2(dy, dx), 2.0 * np.pi)
        if semilog:
            k = np.log(max(max_radius, 1e-12)) / src_w
            mx = np.log(rho + 1.0) / k
        else:
            mx = rho * (src_w / max_radius)
        my = ang * (src_h / (2.0 * np.pi))
    return mx.astype(np.float32), my.astype(np.float32)


def warp_polar(img, center, max_radius: float, dst_size: Tuple[int, int],
               semilog: bool = False, inverse: bool = False,
               border: str = "constant"):
    """OpenCV ``warpPolar`` role. Forward: (H, W[, C]) cartesian →
    (dst_h, dst_w) polar (rows = angle, cols = radius). ``inverse``
    maps a polar image back to cartesian ``dst_size``. A tensor takes the
    device remap with the host maps uploaded; NumPy inputs use the
    oracle."""
    src_size = (img.shape[0], img.shape[1])
    mx, my = warp_polar_maps(src_size, center, max_radius, dst_size,
                             semilog, inverse)
    if isinstance(img, np.ndarray):
        return remap_numpy(img, mx, my, border)
    return remap(img, torch.from_numpy(mx), torch.from_numpy(my), border)


def linear_polar(img, center, max_radius: float, inverse: bool = False,
                 border: str = "constant"):
    """Legacy OpenCV ``linearPolar``: warp_polar with dst = src size."""
    return warp_polar(img, center, max_radius,
                      (img.shape[0], img.shape[1]), False, inverse, border)


def log_polar(img, center, max_radius: float, inverse: bool = False,
              border: str = "constant"):
    """Legacy OpenCV ``logPolar`` (semilog radius axis), dst = src size."""
    return warp_polar(img, center, max_radius,
                      (img.shape[0], img.shape[1]), True, inverse, border)


def convert_maps(map_x: np.ndarray, map_y: np.ndarray):
    """OpenCV ``convertMaps`` (CV_16SC2 form): float maps → fixed-point
    (int16 integer coords (H, W, 2), uint16 5-bit-fraction interpolation
    index fy·32 + fx). Bit-exact vs cv2 (tests)."""
    mx = np.asarray(map_x, np.float64)
    my = np.asarray(map_y, np.float64)
    sx = np.round(mx * 32.0).astype(np.int64)
    sy = np.round(my * 32.0).astype(np.int64)
    ix = sx >> 5
    iy = sy >> 5
    fx = (sx & 31).astype(np.uint16)
    fy = (sy & 31).astype(np.uint16)
    m1 = np.stack([np.clip(ix, -32768, 32767),
                   np.clip(iy, -32768, 32767)], axis=-1).astype(np.int16)
    m2 = (fy * 32 + fx).astype(np.uint16)
    return m1, m2


def remap_nearest_numpy(img: np.ndarray, map_x: np.ndarray,
                        map_y: np.ndarray, border: str = "constant",
                        border_value=0) -> np.ndarray:
    """OpenCV ``remap`` INTER_NEAREST with float maps, bit-exact: source
    index = cvRound(map) (round-half-to-even, np.round), out-of-range →
    border rule (imgproc/remap.cpp remapNearest)."""
    if border not in BORDERS:
        raise ValueError(f"unknown border {border!r}")
    src_h, src_w = img.shape[:2]
    sx = np.round(np.asarray(map_x, np.float32).astype(np.float64)
                  ).astype(np.int64)
    sy = np.round(np.asarray(map_y, np.float32).astype(np.float64)
                  ).astype(np.int64)
    inside = (sx >= 0) & (sx < src_w) & (sy >= 0) & (sy < src_h)
    xc = np.clip(sx, 0, src_w - 1)
    yc = np.clip(sy, 0, src_h - 1)
    out = img[yc, xc]
    if border == "constant":
        ins = inside if img.ndim == 2 else inside[..., None]
        out = np.where(ins, out, np.asarray(border_value, img.dtype))
    return out


def _cubic_weights(x: np.ndarray, A: float = -0.75) -> np.ndarray:
    """Catmull-Rom-family 4-tap weights (OpenCV interpolateCubic,
    A = -0.75) for fractional offset x in [0, 1): (..., 4) float64."""
    w0 = ((A * (x + 1) - 5 * A) * (x + 1) + 8 * A) * (x + 1) - 4 * A
    w1 = ((A + 2) * x - (A + 3)) * x * x + 1
    xm = 1 - x
    w2 = ((A + 2) * xm - (A + 3)) * xm * xm + 1
    return np.stack([w0, w1, w2, 1.0 - w0 - w1 - w2], axis=-1)


def remap_cubic_numpy(img: np.ndarray, map_x: np.ndarray,
                      map_y: np.ndarray, border: str = "constant",
                      border_value=0) -> np.ndarray:
    """OpenCV 5.0 ``remap`` INTER_CUBIC, bit-exact: UNQUANTIZED float
    weights (cv2 5's remap takes the float path — verified exact against
    cv2.remap in tests; the old 1/32 fixed-point table path differs by
    up to 6 LSB from what cv2 5 actually computes), taps border-resolved,
    final round-half-to-even + saturate."""
    if border not in BORDERS:
        raise ValueError(f"unknown border {border!r}")
    src_h, src_w = img.shape[:2]
    fx = np.asarray(map_x, np.float32).astype(np.float64)
    fy = np.asarray(map_y, np.float32).astype(np.float64)
    x0 = np.floor(fx).astype(np.int64)
    y0 = np.floor(fy).astype(np.int64)
    wx = _cubic_weights(fx - x0)
    wy = _cubic_weights(fy - y0)
    a = img.astype(np.float64)
    chan = () if img.ndim == 2 else (img.shape[2],)
    acc = np.zeros(map_x.shape + chan, np.float64)
    cval = np.asarray(border_value, np.float64)
    for dy in range(4):
        yy = y0 - 1 + dy
        y_in = (yy >= 0) & (yy < src_h)
        yc = np.clip(yy, 0, src_h - 1)
        for dx in range(4):
            xx = x0 - 1 + dx
            t_in = y_in & (xx >= 0) & (xx < src_w)
            xc = np.clip(xx, 0, src_w - 1)
            tap = a[yc, xc]
            if border == "constant":
                ins = t_in if img.ndim == 2 else t_in[..., None]
                tap = np.where(ins, tap, cval)
            wk = wy[..., dy] * wx[..., dx]
            acc += tap * (wk if img.ndim == 2 else wk[..., None])
    return np.clip(np.round(acc), 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# cv2 5.0-exact warp family (numpy, facade path)
#
# OpenCV 5's warpAffine/warpPerspective/remap compute float coordinates
# (double inverse matrix), interpolate in full float precision (no 5-bit
# fixed-point tables), and round half-to-EVEN into u8 — pinned by
# translation probes at the .5 boundaries and 400-case differential
# sweeps (tests/test_cv2_differential.py). These are deliberately
# separate from the frozen RustCV-spec fixed-point warps above.


def _border_index_cv(p: np.ndarray, n: int, mode: str) -> np.ndarray:
    """cv2 ``borderInterpolate`` for non-constant modes."""
    if mode == "replicate":
        return np.clip(p, 0, n - 1)
    if mode == "wrap":
        return p % n
    if mode == "reflect":
        q = p % (2 * n)
        return np.where(q >= n, 2 * n - 1 - q, q)
    if mode == "reflect101":
        if n == 1:
            return np.zeros_like(p)
        per = 2 * n - 2
        q = p % per
        return np.where(q >= n, per - q, q)
    raise ValueError(f"unknown border {mode!r}")


def _finish_cv(acc: np.ndarray, dtype) -> np.ndarray:
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        return np.clip(np.rint(acc), info.min, info.max).astype(dtype)
    return acc.astype(dtype)


def _sample_cv(img: np.ndarray, X: np.ndarray, Y: np.ndarray, mode: str,
               border: str, border_value) -> np.ndarray:
    """Sample ``img`` at float coordinates (X, Y) with cv2 semantics:
    float bilinear (or half-even nearest), per-tap border handling."""
    h, w = img.shape[:2]
    chans = img.reshape(h, w, -1)
    nc = chans.shape[2]
    bval = np.zeros(nc, np.float64)
    bv = np.atleast_1d(np.asarray(border_value, np.float64)).ravel()
    bval[:len(bv[:nc])] = bv[:nc]

    def taps(yy, xx):
        if border == "constant":
            inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            cy = np.clip(yy, 0, h - 1)
            cx = np.clip(xx, 0, w - 1)
            v = chans[cy, cx].astype(np.float64)
            return np.where(inside[..., None], v, bval)
        return chans[_border_index_cv(yy, h, border),
                     _border_index_cv(xx, w, border)].astype(np.float64)

    if mode == "nearest":
        sx = np.rint(X).astype(np.int64)
        sy = np.rint(Y).astype(np.int64)
        out = taps(sy, sx)
    else:  # bilinear
        fl_x = np.floor(X)
        fl_y = np.floor(Y)
        fx = X - fl_x
        fy = Y - fl_y
        sx = np.clip(fl_x, -(1 << 40), 1 << 40).astype(np.int64)
        sy = np.clip(fl_y, -(1 << 40), 1 << 40).astype(np.int64)
        out = ((1 - fy) * (1 - fx))[..., None] * taps(sy, sx) \
            + ((1 - fy) * fx)[..., None] * taps(sy, sx + 1) \
            + (fy * (1 - fx))[..., None] * taps(sy + 1, sx) \
            + (fy * fx)[..., None] * taps(sy + 1, sx + 1)
    out = _finish_cv(out, img.dtype)
    return out[..., 0] if img.ndim == 2 else out


def invert_affine_cv(m) -> np.ndarray:
    """cv2 ``invertAffineTransform``'s double arithmetic, digit for
    digit (D := 1/det or 0)."""
    m = np.asarray(m, np.float64)
    det = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    det = 1.0 / det if det != 0 else 0.0
    a00 = m[1, 1] * det
    a01 = -m[0, 1] * det
    a10 = -m[1, 0] * det
    a11 = m[0, 0] * det
    return np.array([[a00, a01, -a00 * m[0, 2] - a01 * m[1, 2]],
                     [a10, a11, -a10 * m[0, 2] - a11 * m[1, 2]]])


def warp_affine_cv_numpy(img: np.ndarray, m, dst_size, mode="bilinear",
                         border="constant", border_value=0,
                         inverse_map=False) -> np.ndarray:
    """cv2 5.0 ``warpAffine``, bit-exact for integer dtypes (u8 verified
    over 400 random warps incl. border values; half-even rounding)."""
    mi = np.asarray(m, np.float64) if inverse_map else invert_affine_cv(m)
    dw, dh = int(dst_size[0]), int(dst_size[1])
    xs = np.arange(dw, dtype=np.float64)[None, :]
    ys = np.arange(dh, dtype=np.float64)[:, None]
    X = mi[0, 0] * xs + mi[0, 1] * ys + mi[0, 2]
    Y = mi[1, 0] * xs + mi[1, 1] * ys + mi[1, 2]
    return _sample_cv(img, X, Y, mode, border, border_value)


def warp_perspective_cv_numpy(img: np.ndarray, m, dst_size,
                              mode="bilinear", border="constant",
                              border_value=0,
                              inverse_map=False) -> np.ndarray:
    """cv2 5.0 ``warpPerspective``: double per-pixel homography divide,
    then the same float sampling as :func:`warp_affine_cv_numpy`."""
    mm = np.asarray(m, np.float64)
    mi = mm if inverse_map else np.linalg.inv(mm)
    dw, dh = int(dst_size[0]), int(dst_size[1])
    xs = np.arange(dw, dtype=np.float64)[None, :]
    ys = np.arange(dh, dtype=np.float64)[:, None]
    wq = mi[2, 0] * xs + mi[2, 1] * ys + mi[2, 2]
    wq = np.where(wq != 0, 1.0 / np.where(wq != 0, wq, 1.0), 0.0)
    X = (mi[0, 0] * xs + mi[0, 1] * ys + mi[0, 2]) * wq
    Y = (mi[1, 0] * xs + mi[1, 1] * ys + mi[1, 2]) * wq
    return _sample_cv(img, X, Y, mode, border, border_value)


def remap_linear_cv_numpy(img: np.ndarray, map_x, map_y,
                          border="constant", border_value=0) -> np.ndarray:
    """cv2 5.0 ``remap`` INTER_LINEAR: float maps sampled with the same
    full-float bilinear + half-even rounding as the warps."""
    X = np.asarray(map_x, np.float64)
    Y = np.asarray(map_y, np.float64)
    return _sample_cv(img, X, Y, "bilinear", border, border_value)
