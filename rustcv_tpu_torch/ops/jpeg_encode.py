"""JPEG encode, the numeric half on the device (port of
``rustcv_tpu.ops.jpeg_encode``): BGR → YCbCr → chroma subsampling →
forward DCT as one ``[nblocks, 64] @ [64, 64]`` product → quantization.
The host half, the Huffman coding into JFIF bytes, is the port's C++ coder
:func:`rustcv_tpu_torch.native.jpeg_entropy_encode` (``_packed``).

The frozen encode spec is the reference's (its float64 oracle is
``encode_coeffs_numpy`` there): edge-replicate padding to whole MCUs;
Y/Cb/Cr in float32, rounded half to even and clamped to [0, 255]; integer
subsampling, 4:2:0 ``(a+b+c+d+2)>>2`` and 4:2:2 ``(a+b+1)>>1``; level
shift −128; the product with ``fdct_kmat`` in float32; ``round(F / q)``
clamped to [−1023, 1023], int16. Integer stages are bit-exact with the
reference; the float32 colour and transform may differ from it by an ulp
(XLA on the CPU contracts into FMAs), so coefficients agree within the
reference's own tolerance: max |diff| ≤ 1 on < 0.5 % of them.

This module also holds the DCT basis (``idct_basis``, ``idct_kmat``: the
reference's ``rustcv_tpu/ops/jpeg_tpu.py:32-53``), which the MJPEG decode
(:mod:`.jpeg_tpu`) imports. The numpy helpers ``split_blob`` and
``unpack_coeff_rows_numpy`` are copies, because importing the JAX module
loads jax.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Tuple

import numpy as np
import torch

# Annex K.1/K.2 base quantization tables (natural row-major order).
BASE_QT_LUMA = np.array(
    [
        16, 11, 10, 16, 24, 40, 51, 61,
        12, 12, 14, 19, 26, 58, 60, 55,
        14, 13, 16, 24, 40, 57, 69, 56,
        14, 17, 22, 29, 51, 87, 80, 62,
        18, 22, 37, 56, 68, 109, 103, 77,
        24, 35, 55, 64, 81, 104, 113, 92,
        49, 64, 78, 87, 103, 121, 120, 101,
        72, 92, 95, 98, 112, 100, 103, 99,
    ],
    np.int64,
)
BASE_QT_CHROMA = np.array(
    [
        17, 18, 24, 47, 99, 99, 99, 99,
        18, 21, 26, 66, 99, 99, 99, 99,
        24, 26, 56, 99, 99, 99, 99, 99,
        47, 66, 99, 99, 99, 99, 99, 99,
        99, 99, 99, 99, 99, 99, 99, 99,
        99, 99, 99, 99, 99, 99, 99, 99,
        99, 99, 99, 99, 99, 99, 99, 99,
        99, 99, 99, 99, 99, 99, 99, 99,
    ],
    np.int64,
)

_SAMP = {"4:2:0": (2, 2), "4:2:2": (2, 1), "4:4:4": (1, 1)}
SUBSAMPLINGS = tuple(_SAMP)


@lru_cache(maxsize=1)
def idct_basis() -> np.ndarray:
    """M[u, x] = 0.5·C(u)·cos((2x+1)uπ/16), float32 (computed in float64)."""
    u = np.arange(8)[:, None]
    x = np.arange(8)[None, :]
    m = 0.5 * np.cos((2 * x + 1) * u * np.pi / 16)
    m[0, :] *= 1 / np.sqrt(2)
    return m.astype(np.float32)


@lru_cache(maxsize=1)
def idct_kmat() -> np.ndarray:
    """The 2-D IDCT as one [64, 64] matrix: K[u·8+v, x·8+y] = M[u,x]·M[v,y]."""
    m = idct_basis().astype(np.float64)
    return np.einsum("ux,vy->uvxy", m, m).reshape(64, 64).astype(np.float32)


@lru_cache(maxsize=1)
def fdct_kmat() -> np.ndarray:
    """The forward 2-D DCT as one [64, 64] matrix: the IDCT's transpose
    (the separable basis is orthogonal)."""
    return np.ascontiguousarray(idct_kmat().T)


@lru_cache(maxsize=64)
def quant_tables(quality: int) -> Tuple[np.ndarray, np.ndarray]:
    """IJG quality scaling → (luma, chroma) uint16 tables, natural order."""
    q = min(100, max(1, int(quality)))
    scale = 5000 // q if q < 50 else 200 - 2 * q
    qy = np.clip((BASE_QT_LUMA * scale + 50) // 100, 1, 255)
    qc = np.clip((BASE_QT_CHROMA * scale + 50) // 100, 1, 255)
    return qy.astype(np.uint16), qc.astype(np.uint16)


def _geometry(w: int, h: int, subsampling: str) -> dict:
    """MCU-aligned geometry for a 3-component image."""
    if subsampling not in _SAMP:
        raise ValueError(f"unknown subsampling {subsampling!r}; one of {SUBSAMPLINGS}")
    fh, fv = _SAMP[subsampling]
    mcus_x = -(-w // (8 * fh))
    mcus_y = -(-h // (8 * fv))
    return {
        "pad_w": mcus_x * 8 * fh,
        "pad_h": mcus_y * 8 * fv,
        "h_samp": [fh, 1, 1],
        "v_samp": [fv, 1, 1],
        "blocks": [(mcus_y * fv, mcus_x * fh), (mcus_y, mcus_x), (mcus_y, mcus_x)],
    }


@lru_cache(maxsize=16)
def _device_tables(quality: int, device: torch.device):
    """(fdct_kmat, luma table, chroma table) as float32 tensors on
    ``device``, made once so a steady tick uploads nothing."""
    qy, qc = quant_tables(quality)
    return tuple(torch.from_numpy(np.asarray(a, np.float32)).to(device)
                 for a in (fdct_kmat(), qy, qc))


def _blocks(plane: torch.Tensor) -> torch.Tensor:
    """(..., H, W) → (..., nblocks, 64) block rows, natural order in-block."""
    h, w = plane.shape[-2], plane.shape[-1]
    batch = plane.shape[:-2]
    nd = len(batch)
    perm = (*range(nd), nd, nd + 2, nd + 1, nd + 3)
    return plane.reshape(*batch, h // 8, 8, w // 8, 8).permute(perm).reshape(
        *batch, (h // 8) * (w // 8), 64)


def _matmul_f32(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """x @ k in full float32, as the reference's Precision.HIGHEST: on a
    CUDA device TF32 is switched off for the product and restored after."""
    if x.device.type != "cuda":
        return torch.matmul(x, k)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return torch.matmul(x, k)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _fdct_quant(plane: torch.Tensor, qt: torch.Tensor, kmat: torch.Tensor) -> torch.Tensor:
    """Integer plane → quantized coefficient rows (..., nblocks, 64) int16."""
    x = _blocks(plane).to(torch.float32) - 128.0
    q = torch.round(_matmul_f32(x, kmat) / qt)
    return q.clamp(-1023, 1023).to(torch.int16)


def _subsample_h2v2(p: torch.Tensor) -> torch.Tensor:
    h, w = p.shape[-2], p.shape[-1]
    q = p.reshape(*p.shape[:-2], h // 2, 2, w // 2, 2).to(torch.int32)
    return (q.sum(dim=(-3, -1), dtype=torch.int32) + 2) >> 2


def _subsample_h2v1(p: torch.Tensor) -> torch.Tensor:
    w = p.shape[-1]
    q = p.reshape(*p.shape[:-1], w // 2, 2).to(torch.int32)
    return (q.sum(dim=-1, dtype=torch.int32) + 1) >> 1


def _edge_pad(p: torch.Tensor, pad_h: int, pad_w: int) -> torch.Tensor:
    """Pad (..., H, W) to (..., pad_h, pad_w) by repeating the last row and
    column."""
    h, w = p.shape[-2], p.shape[-1]
    if pad_h != h:
        p = p.index_select(-2, torch.arange(pad_h, device=p.device).clamp(max=h - 1))
    if pad_w != w:
        p = p.index_select(-1, torch.arange(pad_w, device=p.device).clamp(max=w - 1))
    return p


def encode_coeffs_from_planes(
    b: torch.Tensor,
    g: torch.Tensor,
    r: torch.Tensor,
    quality: int = 90,
    subsampling: str = "4:2:0",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """B/G/R planes (..., H, W), u8 or int32 → quantized coefficient rows
    per component (..., nb, 64) int16, natural order over the padded MCU
    grid."""
    h, w = b.shape[-2], b.shape[-1]
    geo = _geometry(w, h, subsampling)
    kmat, qy, qc = _device_tables(int(quality), b.device)
    bf, gf, rf = (_edge_pad(p, geo["pad_h"], geo["pad_w"]).to(torch.float32) for p in (b, g, r))
    y = 0.299 * rf + 0.587 * gf + 0.114 * bf
    cb = -0.168736 * rf - 0.331264 * gf + 0.5 * bf + 128.0
    cr = 0.5 * rf - 0.418688 * gf - 0.081312 * bf + 128.0
    y, cb, cr = (torch.round(p).clamp(0, 255).to(torch.int32) for p in (y, cb, cr))
    fh, fv = _SAMP[subsampling]
    if (fh, fv) == (2, 2):
        cb, cr = _subsample_h2v2(cb), _subsample_h2v2(cr)
    elif (fh, fv) == (2, 1):
        cb, cr = _subsample_h2v1(cb), _subsample_h2v1(cr)
    return _fdct_quant(y, qy, kmat), _fdct_quant(cb, qc, kmat), _fdct_quant(cr, qc, kmat)


def encode_coeffs(bgr: torch.Tensor, quality: int = 90, subsampling: str = "4:2:0"):
    """(..., H, W, 3) u8 BGR → quantized coefficient rows per component
    (the reference's ``encode_coeffs_tpu``, with any batch dims)."""
    return encode_coeffs_from_planes(bgr[..., 0], bgr[..., 1], bgr[..., 2], quality, subsampling)


def encode_coeffs_gray(gray: torch.Tensor, quality: int = 90) -> torch.Tensor:
    """(..., H, W) u8 gray → quantized luma coefficient rows (..., nb, 64)
    (the reference's ``encode_coeffs_gray_tpu``)."""
    h, w = gray.shape[-2], gray.shape[-1]
    kmat, qy, _ = _device_tables(int(quality), gray.device)
    plane = _edge_pad(gray, -(-h // 8) * 8, -(-w // 8) * 8).to(torch.int32)
    return _fdct_quant(plane, qy, kmat)


def _jfif(comps, quality: int, w: int, h: int, g: dict) -> bytes:
    from .. import native

    qy, qc = quant_tables(quality)
    grids = [np.asarray(c).reshape(*g["blocks"][i], 64) for i, c in enumerate(comps)]
    return native.jpeg_entropy_encode(grids, [qy, qc, qc], w, h, g["h_samp"], g["v_samp"])


def encode_jpeg(bgr, quality: int = 90, subsampling: str = "4:2:0") -> bytes:
    """Full encode: the numeric half on ``bgr``'s device, the Huffman coding
    on the host. ``bgr`` is (H, W, 3) u8 BGR, a tensor or a numpy array; a
    2-D input encodes gray. Returns baseline JFIF bytes."""
    a = torch.as_tensor(bgr)
    h, w = int(a.shape[0]), int(a.shape[1])
    if a.ndim == 2:
        g = {"blocks": [(-(-h // 8), -(-w // 8))], "h_samp": [1], "v_samp": [1]}
        return _jfif([encode_coeffs_gray(a, quality).cpu()], quality, w, h, g)
    comps = [c.cpu() for c in encode_coeffs(a, quality, subsampling)]
    return _jfif(comps, quality, w, h, _geometry(w, h, subsampling))


def encode_jpeg_batch(bgr, quality: int = 90, subsampling: str = "4:2:0") -> List[bytes]:
    """(N, H, W, 3) u8 BGR → N JFIF byte strings: one batched numeric pass,
    then the host coder per frame."""
    a = torch.as_tensor(bgr)
    h, w = int(a.shape[1]), int(a.shape[2])
    g = _geometry(w, h, subsampling)
    comps = [c.cpu() for c in encode_coeffs(a, quality, subsampling)]
    return [_jfif([c[i] for c in comps], quality, w, h, g) for i in range(a.shape[0])]


def pack_coeff_rows(
    coeffs: torch.Tensor, k_slots: int, dense_cap: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Block-pack quantized coefficient rows (..., B, 64) int16.

    Per block, the first ``k_slots`` nonzeros become (position u8, value
    i16) slot pairs; a block with more nonzeros ships whole as a dense row
    (its slots stay zero). Returns ``(idx u8 (..., B, K), val i16 (..., B,
    K), dense_ids i32 (..., DCAP), dense_rows i16 (..., DCAP, 64), n_dense
    i32 (...))`` with DCAP = min(dense_cap, B): the dense ids are the busy
    blocks by nnz descending, equal nnz lowest block first
    (``jax.lax.top_k``'s order), and B in unused slots. ``n_dense`` is the
    true busy count: above DCAP the packing is incomplete and the caller
    falls back to the dense rows."""
    b = coeffs.shape[-2]
    nz = coeffs != 0
    nnz = nz.sum(-1, dtype=torch.int32)
    rank = torch.cumsum(nz.to(torch.int32), dim=-1) - 1
    # A light block's k-th nonzero goes to slot k; everything else to a
    # spare slot K that is dropped (the kept slots get one writer each).
    slot = torch.where(nz & (nnz <= k_slots)[..., None], rank, k_slots).to(torch.int64)
    pos = torch.arange(64, dtype=torch.int32, device=coeffs.device).expand_as(slot)
    idx = torch.zeros((*coeffs.shape[:-1], k_slots + 1), dtype=torch.int32, device=coeffs.device)
    val = torch.zeros_like(idx, dtype=torch.int16)
    idx = idx.scatter(-1, slot, pos)[..., :k_slots].to(torch.uint8)
    val = val.scatter(-1, slot, coeffs)[..., :k_slots]

    dense_cap = min(dense_cap, b)  # tiny images: the cap cannot exceed the blocks
    score = torch.where(nnz > k_slots, nnz, -1).to(torch.int64)
    # One unique int64 key per block: the score above, the reversed block
    # index below, so topk's order is the score's, ties lowest block first.
    rev = torch.arange(b - 1, -1, -1, dtype=torch.int64, device=coeffs.device)
    top_key = (score * 2**32 + rev).topk(dense_cap, dim=-1).values
    top = torch.div(top_key, 2**32, rounding_mode="floor")
    ids = (b - 1) - (top_key - top * 2**32)
    valid = top > 0
    rows = coeffs.gather(-2, ids[..., None].expand(*ids.shape, 64))
    return (
        idx,
        val,
        torch.where(valid, ids, b).to(torch.int32),
        rows * valid[..., None].to(torch.int16),
        (nnz > k_slots).sum(-1, dtype=torch.int32),
    )


def blob_from_packed(idx, val, dense_ids, dense_rows, ndense) -> torch.Tensor:
    """The packed outputs as one u8 tensor (..., blob_bytes): [idx u8 | val
    i16 | dense_ids i32 | dense_rows i16 | ndense i32], each flattened
    little-endian, so delivery is one device→host copy per tick. Inverse:
    :func:`split_blob`."""
    batch = idx.shape[:-2]

    def u8(a):
        return a.contiguous().view(torch.uint8).reshape(*batch, -1)

    return torch.cat([u8(idx), u8(val), u8(dense_ids), u8(dense_rows), u8(ndense[..., None])],
                     dim=-1)


def split_blob(blob: np.ndarray, nbt: int, k: int, dcap: int):
    """Host inverse of :func:`blob_from_packed` for one batch item or a
    batch: (idx, val, dense_ids, dense_rows, ndense) numpy arrays (a copy of
    the reference's, rustcv_tpu/ops/jpeg_encode.py:353-372)."""
    batch = blob.shape[:-1]
    o0 = nbt * k
    o1 = o0 + nbt * k * 2
    o2 = o1 + dcap * 4
    o3 = o2 + dcap * 64 * 2
    o4 = o3 + 4
    if blob.shape[-1] != o4:
        raise ValueError(f"blob length {blob.shape[-1]} != expected {o4}")

    def seg(a, dt):  # batched slices are row-strided: compact before the view
        return np.ascontiguousarray(a).view(dt)

    idx = blob[..., :o0].reshape(*batch, nbt, k)
    val = seg(blob[..., o0:o1], np.int16).reshape(*batch, nbt, k)
    ids = seg(blob[..., o1:o2], np.int32).reshape(*batch, dcap)
    rows = seg(blob[..., o2:o3], np.int16).reshape(*batch, dcap, 64)
    nd = seg(blob[..., o3:o4], np.int32).reshape(*batch)
    return idx, val, ids, rows, nd


def unpack_coeff_rows_numpy(idx, val, dense_ids, dense_rows, nblocks):
    """Host oracle: undo :func:`pack_coeff_rows` to dense (B, 64) int16 for
    one item (a copy of the reference's)."""
    out = np.zeros((nblocks + 1, 64), np.int16)
    np.add.at(out[:nblocks], (np.arange(nblocks)[:, None], idx.astype(np.intp)), val)
    out[dense_ids] = dense_rows
    return out[:nblocks]
