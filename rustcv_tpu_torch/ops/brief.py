"""BRIEF-256 and ORB descriptors with Hamming matching (port of
``rustcv_tpu.ops.brief``): the describe/match half of the feature
pipeline (FAST/Harris detect → BRIEF describe → match).

- One 5×5 Gaussian over the whole image (the frozen blur spec), then every
  keypoint's 33×33 patch is read at once: each keypoint's origin is
  clamped into the image (as the reference's ``dynamic_slice`` clamps it)
  and the 256 fixed point pairs are gathered and compared; the bits pack
  into 8 uint32 words. No loop over keypoints.
- Matching: Hamming distances by XOR and popcount of the packed words, on
  the descriptors' device; the ratio test and the cross-check are the
  reference's numpy on the [N, M] distance matrix.

Frozen spec: upright BRIEF (no orientation steering), pair pattern drawn
once from a fixed RNG seed (gaussian-ish, clipped to the patch), compare
strictly-greater on the blurred image. ORB: intensity-centroid angle over
a 31×31 circular patch, the pattern rotated by the angle's bin (30 bins).
Tensor and oracle descriptors are equal bit for bit.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from .filters import gaussian5_u8

PATCH = 33  # sampling patch (half = 16)
NBITS = 256


@lru_cache(maxsize=1)
def brief_pattern() -> np.ndarray:
    """[256, 4] int32 (y1, x1, y2, x2) offsets in [-16, 16], frozen
    (seeded normal pattern, the classic BRIEF G-II choice)."""
    rng = np.random.default_rng(20240131)
    pts = np.clip(
        np.round(rng.normal(0.0, PATCH / 5.0, size=(NBITS, 4))), -16, 16
    ).astype(np.int32)
    return pts


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """bool [K, 256] → uint32 [K, 8], bit b of word w is pair 32·w + b."""
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    words = (bits.to(torch.int64).reshape(-1, 8, 32) << shifts).sum(-1)
    return words.to(torch.uint32)


def _centres(pts, h: int, w: int, half: int, side: int, device):
    """Rounded keypoint centres (x, y) int64, the clamped patch origins and
    the in-image mask of a ``side``×``side`` patch of half-width ``half``."""
    p = torch.as_tensor(pts, dtype=torch.float32, device=device).reshape(-1, 2)
    x = torch.round(p[:, 0]).to(torch.int64)
    y = torch.round(p[:, 1]).to(torch.int64)
    ok = (x >= half) & (x <= w - 1 - half) & (y >= half) & (y <= h - 1 - half)
    oy = torch.clamp(y - half, 0, h - side)
    ox = torch.clamp(x - half, 0, w - side)
    return oy, ox, ok


def _pair_bits(blurred: torch.Tensor, oy, ox, o1, o2) -> torch.Tensor:
    """patch[o1] > patch[o2] per keypoint; ``o1``/``o2`` are flat offsets
    in the 33×33 patch, [256] or one row per keypoint [K, 256]."""
    w = blurred.shape[1]
    flat = blurred.reshape(-1)
    base = (oy * w + ox)[:, None]

    def at(o):
        return flat[base + (o // PATCH) * w + o % PATCH]

    return at(o1) > at(o2)


def brief_descriptors(gray: torch.Tensor, pts):
    """u8 gray (H, W) × [K, 2] float32 (x, y) keypoints → (desc uint32
    [K, 8], valid bool [K]) on the image's device. Keypoints whose 33×33
    patch leaves the image are invalid (descriptor zeroed)."""
    h, w = gray.shape
    half = PATCH // 2
    blurred = gaussian5_u8(gray, has_channels=False).to(torch.int32)
    pat = torch.as_tensor(brief_pattern(), dtype=torch.int64, device=gray.device)
    o1 = (pat[:, 0] + half) * PATCH + (pat[:, 1] + half)
    o2 = (pat[:, 2] + half) * PATCH + (pat[:, 3] + half)
    oy, ox, ok = _centres(pts, h, w, half, PATCH, gray.device)
    bits = _pair_bits(blurred, oy, ox, o1, o2) & ok[:, None]
    return _pack_bits(bits), ok


def _popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each non-negative int64 below 2³² (SWAR)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (x * 0x01010101 & 0xFFFFFFFF) >> 24


def _hamming(d1, d2) -> np.ndarray:
    """[N, M] Hamming distances of packed uint32 descriptors, as float32
    (the reference's ``(256 − dot) / 2``); tensors on their device."""
    if isinstance(d1, torch.Tensor) or isinstance(d2, torch.Tensor):
        dev = (d1 if isinstance(d1, torch.Tensor) else d2).device
        a = torch.as_tensor(np.asarray(d1) if not isinstance(d1, torch.Tensor) else d1,
                            device=dev).to(torch.int64)
        b = torch.as_tensor(np.asarray(d2) if not isinstance(d2, torch.Tensor) else d2,
                            device=dev).to(torch.int64)
        ham = _popcount(a[:, None, :] ^ b[None, :, :]).sum(-1)
        return ham.cpu().numpy().astype(np.float32)
    a = np.asarray(d1, np.uint32)
    b = np.asarray(d2, np.uint32)
    x = np.bitwise_xor(a[:, None, :], b[None, :, :])
    bits = np.unpackbits(x.view(np.uint8), axis=-1)
    return bits.sum(-1, dtype=np.int64).astype(np.float32)


def match_descriptors(
    d1, d2, valid1=None, valid2=None, ratio: float = 0.8
) -> np.ndarray:
    """Hamming matching with Lowe ratio test → int32 [M, 2] (i1, i2).

    A match survives when best < ratio·second-best and it wins the mutual
    cross-check; ties go to the lowest index."""
    ham = _hamming(d1, d2)
    if valid1 is not None:
        ham[~_host_bool(valid1)] = NBITS + 1
    if valid2 is not None:
        ham[:, ~_host_bool(valid2)] = NBITS + 1
    if ham.size == 0:
        return np.zeros((0, 2), np.int32)
    best2 = np.partition(ham, 1, axis=1)[:, :2] if ham.shape[1] > 1 else None
    j = np.argmin(ham, axis=1)
    i = np.arange(ham.shape[0])
    d_best = ham[i, j]
    keep = d_best <= NBITS
    if best2 is not None:
        # Strict inequality: an exact tie (ambiguous top-2) must reject —
        # at best == second == 0 any epsilon slack would wrongly keep it.
        keep &= d_best < ratio * best2[:, 1]
    # mutual cross-check
    back = np.argmin(ham, axis=0)
    keep &= back[j] == i
    return np.stack([i[keep], j[keep]], axis=-1).astype(np.int32)


def _host_bool(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.cpu().numpy()
    return np.asarray(v, bool)


# ---------------------------------------------------------------------------
# NumPy oracle
# ---------------------------------------------------------------------------


def brief_descriptors_numpy(
    gray: np.ndarray, pts: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    from . import golden

    h, w = gray.shape
    half = PATCH // 2
    blurred = golden.gaussian5_u8(gray).astype(np.int64)
    pat = brief_pattern()
    descs = np.zeros((len(pts), 8), np.uint32)
    valid = np.zeros(len(pts), bool)
    for k, (px, py) in enumerate(np.asarray(pts, np.float64)):
        x = int(np.round(px))
        y = int(np.round(py))
        if not (half <= x <= w - 1 - half and half <= y <= h - 1 - half):
            continue
        valid[k] = True
        patch = blurred[y - half : y + half + 1, x - half : x + half + 1]
        for b in range(NBITS):
            y1, x1, y2, x2 = pat[b]
            if patch[y1 + half, x1 + half] > patch[y2 + half, x2 + half]:
                descs[k, b // 32] |= np.uint32(1) << np.uint32(b % 32)
    return descs, valid


# ---------------------------------------------------------------------------
# ORB: intensity-centroid orientation + steered (rotated) BRIEF
# ---------------------------------------------------------------------------

ORB_RADIUS = 15  # orientation patch half-side (31x31, circular mask)
ORB_NBINS = 30  # angle discretization for the steered pattern (12 deg)


@lru_cache(maxsize=1)
def _centroid_masks() -> Tuple[np.ndarray, np.ndarray]:
    """x- and y-coordinate planes over the 31x31 circular patch."""
    r = ORB_RADIUS
    t = np.arange(-r, r + 1, dtype=np.float32)
    xx, yy = np.meshgrid(t, t)
    circ = (xx * xx + yy * yy <= r * r).astype(np.float32)
    return (xx * circ), (yy * circ)


@lru_cache(maxsize=1)
def _steered_offsets() -> Tuple[np.ndarray, np.ndarray]:
    """Flat patch indices of both pattern points for every angle bin:
    ([NBINS, 256] o1, [NBINS, 256] o2) int32. Rotated offsets are rounded
    then clipped to the 33x33 patch (same clip rule as the base pattern)."""
    half = PATCH // 2
    pat = brief_pattern().astype(np.float64)  # [256, 4] (y1, x1, y2, x2)
    o1 = np.zeros((ORB_NBINS, NBITS), np.int32)
    o2 = np.zeros((ORB_NBINS, NBITS), np.int32)
    for b in range(ORB_NBINS):
        th = 2.0 * np.pi * b / ORB_NBINS
        c, s = np.cos(th), np.sin(th)

        def rot(y, x):
            rx = np.clip(np.round(x * c - y * s), -half, half).astype(np.int32)
            ry = np.clip(np.round(x * s + y * c), -half, half).astype(np.int32)
            return (ry + half) * PATCH + (rx + half)

        o1[b] = rot(pat[:, 0], pat[:, 1])
        o2[b] = rot(pat[:, 2], pat[:, 3])
    return o1, o2


def orb_orientations(gray: torch.Tensor, pts) -> torch.Tensor:
    """Intensity-centroid angle (radians, [0, 2pi)) per keypoint, float32:
    m10/m01 moments over the circular 31x31 patch (ORB's orientation),
    every patch's origin clamped into the image (the angle near an edge
    uses the shifted patch, as the oracle). The moments are integers below
    2²⁴, exact in any summation order; the angle is taken in float64 and
    rounded once."""
    h, w = gray.shape
    r = ORB_RADIUS
    side = 2 * r + 1
    mx, my = _centroid_masks()
    dev = gray.device
    oy, ox, _ = _centres(pts, h, w, r, side, dev)
    span = torch.arange(side, device=dev)
    g = gray.to(torch.float32)
    patch = g[(oy[:, None] + span)[:, :, None], (ox[:, None] + span)[:, None, :]]
    m10 = (patch * torch.as_tensor(mx, device=dev)).sum(dim=(1, 2))
    m01 = (patch * torch.as_tensor(my, device=dev)).sum(dim=(1, 2))
    th = torch.atan2(m01.double(), m10.double()).to(torch.float32)
    return torch.where(th < 0, th + 2 * np.pi, th)


def orb_descriptors(gray: torch.Tensor, pts, angles):
    """Steered BRIEF-256: like :func:`brief_descriptors` but the pair
    pattern is rotated by each keypoint's angle, discretized to ORB_NBINS
    bins (the OpenCV ORB scheme). Returns (desc uint32 [K, 8], valid). The
    bin is the reference's float32 arithmetic, divided by a device tensor
    (a CUDA division by a host scalar multiplies by its reciprocal)."""
    h, w = gray.shape
    half = PATCH // 2
    dev = gray.device
    blurred = gaussian5_u8(gray, has_channels=False).to(torch.int32)
    o1t, o2t = (torch.as_tensor(o, dtype=torch.int64, device=dev) for o in _steered_offsets())
    two_pi = torch.tensor(2.0 * np.pi, dtype=torch.float32, device=dev)
    th = torch.as_tensor(angles, device=dev).to(torch.float32).reshape(-1)
    m = torch.fmod(th, two_pi)
    m = torch.where(m < 0, m + two_pi, m)
    b = torch.clamp(torch.floor(m / two_pi * ORB_NBINS).to(torch.int64), 0, ORB_NBINS - 1)
    oy, ox, ok = _centres(pts, h, w, half, PATCH, dev)
    bits = _pair_bits(blurred, oy, ox, o1t[b], o2t[b]) & ok[:, None]
    return _pack_bits(bits), ok


def orb_orientations_numpy(gray: np.ndarray, pts: np.ndarray) -> np.ndarray:
    h, w = gray.shape
    r = ORB_RADIUS
    side = 2 * r + 1
    mx, my = _centroid_masks()
    out = np.zeros(len(pts), np.float64)
    g = gray.astype(np.float64)
    for k, (px, py) in enumerate(np.asarray(pts, np.float64)):
        x = int(np.round(px))
        y = int(np.round(py))
        y0 = min(max(y - r, 0), h - side)
        x0 = min(max(x - r, 0), w - side)
        patch = g[y0 : y0 + side, x0 : x0 + side]
        th = np.arctan2(np.sum(patch * my), np.sum(patch * mx))
        out[k] = th + 2 * np.pi if th < 0 else th
    return out


def orb_descriptors_numpy(
    gray: np.ndarray, pts: np.ndarray, angles: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    from . import golden

    h, w = gray.shape
    half = PATCH // 2
    blurred = golden.gaussian5_u8(gray).astype(np.int64)
    o1t, o2t = _steered_offsets()
    descs = np.zeros((len(pts), 8), np.uint32)
    valid = np.zeros(len(pts), bool)
    for k, (px, py) in enumerate(np.asarray(pts, np.float64)):
        x = int(np.round(px))
        y = int(np.round(py))
        if not (half <= x <= w - 1 - half and half <= y <= h - 1 - half):
            continue
        valid[k] = True
        b = int(np.floor(np.mod(angles[k], 2 * np.pi) / (2 * np.pi) * ORB_NBINS))
        b = min(max(b, 0), ORB_NBINS - 1)
        patch = blurred[y - half : y + half + 1, x - half : x + half + 1].reshape(-1)
        for i in range(NBITS):
            if patch[o1t[b, i]] > patch[o2t[b, i]]:
                descs[k, i // 32] |= np.uint32(1) << np.uint32(i % 32)
    return descs, valid
