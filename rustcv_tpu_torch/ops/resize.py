"""Resize (port of ``rustcv_tpu.ops.resize``): bilinear in the HWC, plane
and packed-rows forms, bicubic, nearest-neighbour and area, each bit-exact
with its frozen spec (``golden.resize_bilinear``, ``resize_bicubic``,
``resize_nearest``, ``resize_area``).

Per output pixel the tables give a low source index and an 11-bit weight of
the next one (half-pixel centres, float64 on the host). The device work is
int32: the horizontal pass keeps unshifted 11-bit sums, the vertical pass
rounds once, ``(Σ + 2²¹) >> 22``. Where the horizontal table is an integer
stride (any integer-factor downscale, e.g. 1920→640: every third pixel, no
weight) its taps are a strided slice instead of a gather.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .golden import RESIZE_ONE, RESIZE_SHIFT, resize_bicubic_coeffs, resize_nearest_coeffs

_ROUND = 1 << (2 * RESIZE_SHIFT - 1)


@lru_cache(maxsize=128)
def resize_coeffs(src_size: int, dst_size: int):
    """Per-output-pixel (lo index, hi weight) int32 tables: a copy of
    ``golden.resize_coeffs`` (rustcv_tpu/ops/golden.py:664-680)."""
    dx = np.arange(dst_size, dtype=np.float64)
    fx = (dx + 0.5) * (src_size / dst_size) - 0.5
    ix = np.floor(fx).astype(np.int64)
    ix = np.clip(ix, 0, max(src_size - 2, 0))
    fx_clamped = np.minimum(fx, src_size - 1)
    frac = np.clip(fx_clamped - ix, 0.0, 1.0)
    w_hi = np.round(frac * RESIZE_ONE).astype(np.int32)
    return ix.astype(np.int32), w_hi


@lru_cache(maxsize=128)
def _tables(src: int, dst: int, device: torch.device):
    """(lo, hi, w_hi) as int64 / int64 / int32 tensors on ``device``, made
    once per shape pair so a steady tick uploads nothing."""
    lo, w_hi = resize_coeffs(src, dst)
    hi = np.minimum(lo + 1, src - 1)
    return (torch.from_numpy(lo.astype(np.int64)).to(device),
            torch.from_numpy(hi.astype(np.int64)).to(device),
            torch.from_numpy(w_hi).to(device))


def _hstride(src: int, dst: int):
    """(k, o, w) when the horizontal table is lo[x] = k·x + o with one
    weight w and the hi tap inside the k-pixel group, else None (same rule
    as the reference's ``_hstride``)."""
    lo, whi = resize_coeffs(src, dst)
    if dst < 2 or src % dst != 0:
        return None
    k, o = int(lo[1] - lo[0]), int(lo[0])
    if k < 1 or src != k * dst or not np.all(np.diff(lo) == k) or not np.all(whi == whi[0]):
        return None
    w = int(whi[0])
    if w > 0 and o + 1 >= k:
        return None
    return k, o, w


def _lerp(lo: torch.Tensor, hi: torch.Tensor, w_hi) -> torch.Tensor:
    """lo·(ONE − w) + hi·w in int32."""
    return lo.to(torch.int32) * (RESIZE_ONE - w_hi) + hi.to(torch.int32) * w_hi


def _vertical(tmp: torch.Tensor, axis: int, src_h: int, dst_h: int) -> torch.Tensor:
    """The vertical pass along ``axis`` and the one rounding → u8."""
    lo, hi, w = _tables(src_h, dst_h, tmp.device)
    shape = [1] * tmp.ndim
    shape[axis] = dst_h
    w = w.reshape(shape)
    acc = _lerp(tmp.index_select(axis, lo), tmp.index_select(axis, hi), w)
    return ((acc + _ROUND) >> (2 * RESIZE_SHIFT)).clamp(0, 255).to(torch.uint8)


def resize_bilinear(img: torch.Tensor, dst_w: int, dst_h: int) -> torch.Tensor:
    """Resize (..., H, W, C) u8 → (..., dst_h, dst_w, C) u8."""
    src_h, src_w = img.shape[-3], img.shape[-2]
    lo, hi, w = _tables(src_w, dst_w, img.device)
    tmp = _lerp(img.index_select(-2, lo), img.index_select(-2, hi), w[:, None])
    return _vertical(tmp, tmp.ndim - 3, src_h, dst_h)


def resize_bilinear_plane(plane: torch.Tensor, dst_w: int, dst_h: int) -> torch.Tensor:
    """Resize single-channel planes (..., H, W) (u8 or int) → (..., dst_h,
    dst_w) u8; resize is per channel, so this equals the HWC form."""
    src_h, src_w = plane.shape[-2], plane.shape[-1]
    st = _hstride(src_w, dst_w)
    if st is not None:
        k, o, w = st
        g = plane.reshape(*plane.shape[:-1], dst_w, k)
        tmp = _lerp(g[..., o], g[..., o + 1] if w else g[..., o], w)
    else:
        lo, hi, w = _tables(src_w, dst_w, plane.device)
        tmp = _lerp(plane.index_select(-1, lo), plane.index_select(-1, hi), w)
    return _vertical(tmp, tmp.ndim - 2, src_h, dst_h)


def resize_bilinear_packed(src: torch.Tensor, src_w: int, src_h: int, dst_w: int,
                           dst_h: int) -> torch.Tensor:
    """Packed BGR rows (..., H, W*3) u8 → (..., dst_h, dst_w*3) u8, the same
    bytes as :func:`resize_bilinear` on the (..., H, W, 3) view."""
    batch = src.shape[:-2]
    a = src.reshape(*batch, src_h, src_w * 3)
    st = _hstride(src_w, dst_w)
    if st is not None:
        k, o, w = st
        g = a.reshape(*batch, src_h, dst_w, 3 * k)
        lo = g[..., 3 * o:3 * o + 3]
        hi = g[..., 3 * o + 3:3 * o + 6] if w else lo
        tmp = _lerp(lo, hi, w).reshape(*batch, src_h, dst_w * 3)
    else:
        lo, hi, w = _tables(src_w, dst_w, a.device)
        lanes = torch.arange(3, device=a.device)
        tmp = _lerp(a.index_select(-1, (lo[:, None] * 3 + lanes).reshape(-1)),
                    a.index_select(-1, (hi[:, None] * 3 + lanes).reshape(-1)),
                    w.repeat_interleave(3))
    return _vertical(tmp, tmp.ndim - 2, src_h, dst_h)


@lru_cache(maxsize=128)
def _cubic_tables(src: int, dst: int, device: torch.device):
    """The four (tap index int64, weight int32) pairs of
    :func:`resize_bicubic_coeffs` on ``device``, made once per shape pair."""
    taps, wts = resize_bicubic_coeffs(src, dst)
    return [(torch.from_numpy(taps[:, j].astype(np.int64)).to(device),
             torch.from_numpy(np.ascontiguousarray(wts[:, j])).to(device)) for j in range(4)]


@lru_cache(maxsize=128)
def _nearest_table(src: int, dst: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(resize_nearest_coeffs(src, dst).astype(np.int64)).to(device)


def resize_bicubic(img: torch.Tensor, dst_w: int, dst_h: int) -> torch.Tensor:
    """INTER_CUBIC resize (..., H, W, C) u8 → (..., dst_h, dst_w, C) u8,
    bit-exact with golden.resize_bicubic (a = −0.75, 11-bit weights, one
    final rounding; int32 sums). A 2-D input resizes a gray plane."""
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    a = img.to(torch.int32)
    tmp = sum(a.index_select(-2, idx) * w[:, None]
              for idx, w in _cubic_tables(img.shape[-2], dst_w, img.device))
    acc = sum(tmp.index_select(-3, idx) * w[:, None, None]
              for idx, w in _cubic_tables(img.shape[-3], dst_h, img.device))
    out = ((acc + _ROUND) >> (2 * RESIZE_SHIFT)).clamp(0, 255).to(torch.uint8)
    return out[..., 0] if squeeze else out


def resize_nearest(img: torch.Tensor, dst_w: int, dst_h: int) -> torch.Tensor:
    """Nearest-neighbour resize (..., H, W, C) u8 (golden.resize_nearest)."""
    return img.index_select(-3, _nearest_table(img.shape[-3], dst_h, img.device)).index_select(
        -2, _nearest_table(img.shape[-2], dst_w, img.device))


def resize_area(img: torch.Tensor, dst_w: int, dst_h: int) -> torch.Tensor:
    """Area (box-mean) resize (..., H, W, C) u8 (golden.resize_area): an
    integer downscale is the exact k×k mean rounded half up; any other
    ratio takes the bilinear spec."""
    src_h, src_w = img.shape[-3], img.shape[-2]
    if not (dst_w <= src_w and dst_h <= src_h and src_w % dst_w == 0 and src_h % dst_h == 0):
        return resize_bilinear(img, dst_w, dst_h)
    ky, kx = src_h // dst_h, src_w // dst_w
    a = img.to(torch.int32).reshape(*img.shape[:-3], dst_h, ky, dst_w, kx, img.shape[-1])
    n = kx * ky
    return ((a.sum(dim=(-4, -2)) + n // 2) // n).to(torch.uint8)
