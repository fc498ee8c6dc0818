"""JPEG reconstruction on the device, the numeric half of the hybrid MJPEG
decode (port of ``rustcv_tpu.ops.jpeg_tpu``): block-packed coefficients →
dense block rows → dequantize → 8×8 IDCT as one ``[nblocks, 64] @ [64, 64]``
float32 product → chroma upsampling → YCbCr → BGR.

The host half is the port's C++ entropy decoder
(:func:`rustcv_tpu_torch.native.jpeg_entropy_decode_blockpacked`).

The frozen reconstruction spec is the reference's:

- float32 IDCT with basis M[u, x] = 0.5·C(u)·cos((2x+1)uπ/16), sample =
  clamp(round(idct + 128)) per component (round half to even);
- chroma upsampling = libjpeg's *fancy* integer filters (h2v2: vertical
  3:1 then horizontal ``(3t + tn + 8|7) >> 4``; h2v1: ``(3s + sn + 1|2) >>
  2``), nearest for other factors;
- colour: R = Y + 1.402·Cr', G = Y − 0.344136·Cb' − 0.714136·Cr',
  B = Y + 1.772·Cb' in float32, each product fused with its sum (XLA's
  contraction), rounded, clamped.

Every integer stage is bit-exact with the reference, and so is the colour
(all 2²⁴ inputs). The float32 IDCT product (TF32 off on the card) may
round a tie the other way where its summation order differs, so decoded
bytes agree within max |diff| ≤ 1 on a small share. ``decode_jpeg_numpy``
is a copy of the reference's float64 oracle.

The functions take any leading batch dims. Unlike the reference's
one-hot reduce over the K slots, :func:`unpack_block_coeffs` scatter-adds
them: the unused ``(0, 0)`` slots add 0 at index 0, which an assigning
scatter would race with a block's real DC coefficient.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from .jpeg_encode import _matmul_f32, idct_basis, idct_kmat


@lru_cache(maxsize=16)
def _kmat(device: torch.device) -> torch.Tensor:
    """The [64, 64] IDCT matrix on ``device``, made once."""
    return torch.from_numpy(idct_kmat()).to(device)


def dequant_idct_plane(coeffs: torch.Tensor, qt: torch.Tensor) -> torch.Tensor:
    """(..., bh, bw, 8, 8) int16 coefficients and an (8, 8) quant table →
    int32 samples (..., bh·8, bw·8) in [0, 255]."""
    bh, bw = coeffs.shape[-4], coeffs.shape[-3]
    batch = coeffs.shape[:-4]
    f = coeffs.reshape(*batch, bh * bw, 64).to(torch.float32) * qt.reshape(64).to(torch.float32)
    spatial = _matmul_f32(f, _kmat(coeffs.device))
    samples = torch.round(spatial + 128.0).clamp(0, 255).to(torch.int32)
    nd = len(batch)
    perm = (*range(nd), nd, nd + 2, nd + 1, nd + 3)
    return samples.reshape(*batch, bh, bw, 8, 8).permute(perm).reshape(*batch, bh * 8, bw * 8)


def _neighbours(x: torch.Tensor, dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(prev, next) taps along ``dim`` with the border replicated."""
    n = x.shape[dim]
    prev = torch.cat([x.narrow(dim, 0, 1), x.narrow(dim, 0, n - 1)], dim=dim)
    nxt = torch.cat([x.narrow(dim, 1, n - 1), x.narrow(dim, n - 1, 1)], dim=dim)
    return prev, nxt


def _interleave(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    """a and b interleaved along ``dim`` (a first)."""
    dim = dim % a.ndim
    shape = list(a.shape)
    shape[dim] *= 2
    return torch.stack([a, b], dim=dim + 1).reshape(shape)


def upsample_h2v1_fancy(c: torch.Tensor) -> torch.Tensor:
    """libjpeg h2v1 fancy: out[2i] = (3s + prev + 1) >> 2, out[2i+1] =
    (3s + next + 2) >> 2, on int32 planes (..., H, W) → (..., H, 2W)."""
    prev, nxt = _neighbours(c, -1)
    return _interleave((3 * c + prev + 1) >> 2, (3 * c + nxt + 2) >> 2, -1)


def upsample_h2v2_fancy(c: torch.Tensor) -> torch.Tensor:
    """libjpeg h2v2 fancy: vertical t = 3·cur + near, then horizontal
    (3t + t_near + 8|7) >> 4: (..., H, W) → (..., 2H, 2W)."""
    prev_r, next_r = _neighbours(c, -2)
    t = _interleave(3 * c + prev_r, 3 * c + next_r, -2)
    prev_c, next_c = _neighbours(t, -1)
    return _interleave((3 * t + prev_c + 8) >> 4, (3 * t + next_c + 7) >> 4, -1)


def upsample(c: torch.Tensor, fh: int, fv: int) -> torch.Tensor:
    """Upsample a chroma plane by (fh, fv): fancy for 2×2 and 2×1, nearest
    for any other factor."""
    if (fh, fv) == (1, 1):
        return c
    if (fh, fv) == (2, 2):
        return upsample_h2v2_fancy(c)
    if (fh, fv) == (2, 1):
        return upsample_h2v1_fancy(c)
    return c.repeat_interleave(fv, dim=-2).repeat_interleave(fh, dim=-1)


def unpack_coeffs(pos: torch.Tensor, val: torch.Tensor, total: int) -> torch.Tensor:
    """FLAT-packed nonzeros (..., cap) → dense coefficient vector (..., total)
    int16: a scatter-add in int32 (zero-filled entries add 0 at 0). Kept for
    parity with the reference; the engine unpacks the block-packed form."""
    out = torch.zeros((*pos.shape[:-1], total), dtype=torch.int32, device=pos.device)
    return out.scatter_add_(-1, pos.long(), val.to(torch.int32)).to(torch.int16)


def choose_block_packing(nnzb: np.ndarray) -> Tuple[int, int]:
    """Pick (K, dense-row capacity) from a frame's per-block nonzero counts:
    the K in {2, 4, 6, 8} that minimizes wire bytes (K slots per block at 3 B
    + 132 B per busy block), with 4× headroom on the busy-block capacity,
    rounded up to 1024 rows (a copy of the reference's policy)."""
    nb = nnzb.size
    best_k, best_bytes, best_busy = 4, None, 0
    for k in (2, 4, 6, 8):
        busy = int((nnzb > k).sum())
        bytes_ = nb * k * 3 + busy * 132
        if best_bytes is None or bytes_ < best_bytes:
            best_k, best_bytes, best_busy = k, bytes_, busy
    cap = int(-(-max(1024, 4 * best_busy) // 1024) * 1024)
    return best_k, min(cap, nb)


def unpack_block_coeffs(idx: torch.Tensor, val: torch.Tensor, dense_ids: torch.Tensor,
                        dense_rows: torch.Tensor) -> torch.Tensor:
    """BLOCK-packed coefficients → dense block rows (..., nblocks, 64) int16.

    ``idx``/``val``: (..., nblocks, K) per-block slots (uint8 natural
    coefficient index / int16 value, zero-filled when unused).
    ``dense_ids``/``dense_rows``: (..., cap) and (..., cap, 64), the busy
    blocks shipped whole; padded entries carry id == nblocks, a scratch row
    that is dropped. The slots are scatter-added in int32, then the dense
    rows are copied over their blocks."""
    nblocks = idx.shape[-2]
    batch = idx.shape[:-2]
    blocks = torch.zeros((*batch, nblocks + 1, 64), dtype=torch.int32, device=idx.device)
    blocks[..., :nblocks, :].scatter_add_(-1, idx.long(), val.to(torch.int32))
    blocks = blocks.to(torch.int16)
    rows = dense_ids.long()[..., None].expand(*dense_ids.shape, 64)
    blocks.scatter_(-2, rows, dense_rows.to(torch.int16))
    return blocks[..., :nblocks, :]


def _fma32(acc: torch.Tensor, c: float, x: torch.Tensor) -> torch.Tensor:
    """float32 ``acc + c·x`` rounded once, as a fused multiply-add: ``c`` is
    a float32 constant and ``x`` an integer below 2⁹ in magnitude, so the
    float64 product and sum are exact before the one rounding."""
    return (acc.to(torch.float64) + float(np.float32(c)) * x).to(torch.float32)


def ycbcr_to_bgr_planes(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor):
    """YCbCr planes (any integer dtype) → (b, g, r) u8 planes. Each
    product is fused with its sum, one float32 rounding per term, as XLA
    compiles the reference's expressions; the same bits on every device."""
    yf = y.to(torch.float64)
    d = cb.to(torch.float64) - 128.0
    e = cr.to(torch.float64) - 128.0
    r = _fma32(yf, 1.402, e)
    g = _fma32(_fma32(yf, -0.344136, d), -0.714136, e)
    b = _fma32(yf, 1.772, d)
    return tuple(torch.round(p).clamp(0, 255).to(torch.uint8) for p in (b, g, r))


def ycbcr_to_bgr(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor) -> torch.Tensor:
    """YCbCr planes → interleaved BGR u8 (..., H, W, 3)."""
    return torch.stack(ycbcr_to_bgr_planes(y, cb, cr), dim=-1)


def decode_jpeg_tpu(data, device="cuda") -> torch.Tensor:
    """Full hybrid decode of one baseline JPEG: the host entropy decode, then
    the reconstruction on ``device``. Returns (H, W, 3) u8 BGR (a gray JPEG
    broadcast to three channels). The name is the reference's; kept for
    parity with it, since the engine decodes in batches."""
    from .. import native

    info, coeffs, qts = native.jpeg_entropy_decode(data)
    h, w = info["height"], info["width"]
    hmax, vmax = max(info["h_samp"]), max(info["v_samp"])
    planes = []
    for c in range(info["ncomp"]):
        plane = dequant_idct_plane(torch.from_numpy(coeffs[c]).to(device),
                                   torch.from_numpy(qts[c].astype(np.int32)).to(device))
        plane = upsample(plane, hmax // info["h_samp"][c], vmax // info["v_samp"][c])
        planes.append(plane[:h, :w])
    if info["ncomp"] == 1:
        return planes[0].to(torch.uint8)[..., None].expand(h, w, 3).contiguous()
    return ycbcr_to_bgr(*planes)


def decode_jpeg_numpy(data) -> np.ndarray:
    """The float64 numpy oracle of the same spec (a copy of the reference's
    ``decode_jpeg_numpy``, on the port's entropy decoder): (H, W, 3) u8 BGR."""
    from .. import native

    info, coeffs, qts = native.jpeg_entropy_decode(data)
    h, w = info["height"], info["width"]
    hmax = max(info["h_samp"])
    vmax = max(info["v_samp"])
    m = idct_basis().astype(np.float64)

    planes = []
    for c in range(info["ncomp"]):
        f = coeffs[c].astype(np.float64) * qts[c].astype(np.float64)
        spatial = np.einsum("ux,abuv,vy->abxy", m, f, m)
        samples = np.clip(np.round(spatial + 128.0), 0, 255).astype(np.int64)
        bh, bw = samples.shape[:2]
        plane = samples.transpose(0, 2, 1, 3).reshape(bh * 8, bw * 8)
        fh = hmax // info["h_samp"][c]
        fv = vmax // info["v_samp"][c]
        if (fh, fv) == (2, 2):
            prev_r = np.vstack([plane[:1], plane[:-1]])
            next_r = np.vstack([plane[1:], plane[-1:]])
            t = np.empty((plane.shape[0] * 2, plane.shape[1]), np.int64)
            t[0::2] = 3 * plane + prev_r
            t[1::2] = 3 * plane + next_r
            prev_c = np.hstack([t[:, :1], t[:, :-1]])
            next_c = np.hstack([t[:, 1:], t[:, -1:]])
            out = np.empty((t.shape[0], t.shape[1] * 2), np.int64)
            out[:, 0::2] = (3 * t + prev_c + 8) >> 4
            out[:, 1::2] = (3 * t + next_c + 7) >> 4
            plane = out
        elif (fh, fv) == (2, 1):
            prev_c = np.hstack([plane[:, :1], plane[:, :-1]])
            next_c = np.hstack([plane[:, 1:], plane[:, -1:]])
            out = np.empty((plane.shape[0], plane.shape[1] * 2), np.int64)
            out[:, 0::2] = (3 * plane + prev_c + 1) >> 2
            out[:, 1::2] = (3 * plane + next_c + 2) >> 2
            plane = out
        elif (fh, fv) != (1, 1):
            plane = np.repeat(np.repeat(plane, fv, axis=0), fh, axis=1)
        planes.append(plane[:h, :w])

    if info["ncomp"] == 1:
        yp = planes[0].astype(np.uint8)
        return np.stack([yp, yp, yp], axis=-1)
    y = planes[0].astype(np.float64)
    d = planes[1].astype(np.float64) - 128.0
    e = planes[2].astype(np.float64) - 128.0
    out = np.stack(
        [y + 1.772 * d, y - 0.344136 * d - 0.714136 * e, y + 1.402 * e], axis=-1
    )
    return np.clip(np.round(out), 0, 255).astype(np.uint8)
