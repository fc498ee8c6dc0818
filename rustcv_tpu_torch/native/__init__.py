"""The port's host C++ (the JPEG entropy coder, the full host JPEG decode,
the glyph rasterizer, the frame ring, the V4L2 driver, the
connected-components union-find, the MSER component tree, the grid
max-flow, the LZW and PackBits loops of the TIFF and GIF codecs and the
WebP decodes and encodes), built with g++ at first use and bound with ctypes.

Fifteen sources: ``jpeg_encode.cpp`` (quantized coefficient grids, dense or
block-packed, → baseline JFIF bytes, Annex K Huffman tables),
``jpeg_entropy.cpp`` (baseline JFIF → coefficient grids and quant tables,
which checks a payload exactly: Huffman coding is lossless; the flat-
and block-packed forms that feed the hybrid MJPEG decode; and, for the
host decode alone, progressive, multi-scan, four-component, lossless and
arithmetic-coded streams), ``jpeg_host.cpp``
(the full decode to BGR on the host, libjpeg-turbo's default decode without
libjpeg, with the colour rule libtiff sets for a TIFF page; Pillow's CMYK →
RGB and libtiff's YCbCr → RGB), ``png_filter.cpp`` (the PNG reader's scanline unfiltering),
``text_raster.cpp`` (put_text's glyph rasterizer), ``capture.cpp`` (the
threaded frame ring behind :class:`NativeRing`: a ``std::thread`` producer
writes the frozen test pattern as YUYV into its slots) and ``v4l2.cpp``
(the direct-ioctl V4L2 driver behind ``capture.v4l2``; a host without
``linux/videodev2.h`` builds its stub, ``rcv_v4l2_available() == 0``)
``unionfind.cpp`` (min-root union-find and the two-pass component
labeling behind ``ops.ccl``: :func:`ccl_label`, :func:`union_find`),
``mser.cpp`` (the MSER component-tree pass behind ``ops.mser``:
:func:`mser_triples`), ``maxflow.cpp`` (Dinic max-flow on the
8-connected pixel grid behind ``ops.grabcut``: :func:`maxflow_grid`) and
``lzw.cpp`` (GIF LZW decode and encode, TIFF LZW and PackBits decode behind
``imgcodecs.gif`` and ``imgcodecs.tiff``: :func:`gif_lzw_decode`,
:func:`gif_lzw_encode`, :func:`tiff_lzw_decode`, :func:`packbits_decode`),
``vp8.cpp`` (the lossy WebP decode, a VP8 key frame to RGBA as libwebp
gives it: :func:`vp8_info`, :func:`vp8_decode`), ``vp8l.cpp`` (the
lossless decode: :func:`vp8l_info`, :func:`vp8l_decode`; and the ALPH
plane, which ``vp8_decode`` applies), ``vp8enc.cpp`` (the lossy encode, Y,
U and V planes to a VP8 key frame as libwebp's encoder makes it for
Pillow's default save: :func:`vp8_encode`; it shares ``vp8.cpp``'s
tables, transforms and predictors) and ``vp8lenc.cpp`` (the ALPH plane's
lossless coder: :func:`alph_encode`), behind ``imgcodecs.webp``.
The library goes to ``build/rustcv_tpu_torch/`` beside the package, under a
name made from a hash of the sources and the flags, so an edited source
rebuilds and an unchanged one loads at once.

:func:`available` is False when the build failed; every function of the
library then raises with the compiler's output (:func:`build_error`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np

_HERE = Path(__file__).resolve().parent
SOURCES = (_HERE / "jpeg_encode.cpp", _HERE / "jpeg_entropy.cpp", _HERE / "jpeg_host.cpp",
           _HERE / "png_filter.cpp", _HERE / "text_raster.cpp", _HERE / "capture.cpp",
           _HERE / "v4l2.cpp", _HERE / "unionfind.cpp", _HERE / "mser.cpp",
           _HERE / "maxflow.cpp", _HERE / "lzw.cpp", _HERE / "vp8.cpp", _HERE / "vp8l.cpp",
           _HERE / "vp8enc.cpp", _HERE / "vp8lenc.cpp")
BUILD_DIR = _HERE.parents[1] / "build" / "rustcv_tpu_torch"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None
# What the last build or load did: library path and g++ seconds (0 if cached).
build_info: dict = {}


def _compile() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    lib_path = BUILD_DIR / f"librustcv_coder_{h.hexdigest()[:16]}.so"
    if lib_path.is_file():
        build_info.update(path=str(lib_path), seconds=0.0)
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), *map(str, SOURCES)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed (exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib_path)  # atomic: concurrent builders never see half a file
    build_info.update(path=str(lib_path), seconds=time.perf_counter() - t0)
    return lib_path


def _bind(lib: ctypes.CDLL) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i16p = ctypes.POINTER(ctypes.c_int16)
    u16p = ctypes.POINTER(ctypes.c_uint16)
    i32p = ctypes.POINTER(ctypes.c_int32)
    intp = ctypes.POINTER(ctypes.c_int)
    longp = ctypes.POINTER(ctypes.c_long)
    lib.rcv_jpeg_info.restype = ctypes.c_int
    lib.rcv_jpeg_info.argtypes = [u8p, ctypes.c_long, intp, intp, intp, intp, intp, intp, intp]
    lib.rcv_jpeg_host_info.restype = ctypes.c_int
    lib.rcv_jpeg_host_info.argtypes = [u8p, ctypes.c_long, intp, intp, intp, intp, intp, intp, intp,
                                       intp]
    lib.rcv_jpeg_coeffs.restype = ctypes.c_int
    lib.rcv_jpeg_coeffs.argtypes = [u8p, ctypes.c_long, i16p, i16p, i16p, u16p, u16p, u16p]
    lib.rcv_jpeg_coeffs_packed.restype = ctypes.c_int
    lib.rcv_jpeg_coeffs_packed.argtypes = [u8p, ctypes.c_long, i32p, i16p, ctypes.c_long,
                                           u16p, u16p, u16p, longp]
    lib.rcv_jpeg_coeffs_blockpacked.restype = ctypes.c_int
    lib.rcv_jpeg_coeffs_blockpacked.argtypes = [
        u8p, ctypes.c_long, u8p, i16p, ctypes.c_int, i32p, i16p, ctypes.c_long,
        u16p, u16p, u16p, longp,
    ]
    lib.rcv_jpeg_entropy_encode.restype = ctypes.c_long
    lib.rcv_jpeg_entropy_encode.argtypes = [
        i16p, i16p, i16p, ctypes.c_int, intp, intp, intp, intp,
        ctypes.c_int, ctypes.c_int, u16p, u16p, u8p, ctypes.c_long,
    ]
    lib.rcv_text_glyph.restype = ctypes.c_int
    lib.rcv_text_glyph.argtypes = [i32p, u8p, ctypes.c_int, i32p, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_int, u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.rcv_png_unfilter.restype = ctypes.c_int
    lib.rcv_png_unfilter.argtypes = [u8p, ctypes.c_long, ctypes.c_int, ctypes.c_long, ctypes.c_int,
                                     u8p]
    lib.rcv_jpeg_decode_bgr.restype = ctypes.c_int
    lib.rcv_jpeg_decode_bgr.argtypes = [u8p, ctypes.c_long, u8p, ctypes.c_long, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_int]
    lib.rcv_cmyk_to_rgb.restype = None
    lib.rcv_cmyk_to_rgb.argtypes = [u8p, ctypes.c_long, u8p]
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.rcv_tiff_ycbcr_to_rgb.restype = ctypes.c_int
    lib.rcv_tiff_ycbcr_to_rgb.argtypes = [u8p, ctypes.c_long, f32p, f32p, u8p]
    lib.rcv_jpeg_entropy_encode_packed.restype = ctypes.c_long
    lib.rcv_jpeg_entropy_encode_packed.argtypes = [
        u8p, i16p, ctypes.c_int, i32p, i16p, ctypes.c_int,
        ctypes.c_int, intp, intp, intp, intp,
        ctypes.c_int, ctypes.c_int, u16p, u16p, u8p, ctypes.c_long,
    ]
    # capture.cpp: the frame ring (its producer runs rcv_synth_yuyv).
    lib.rcv_ring_create.restype = ctypes.c_void_p
    lib.rcv_ring_create.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.rcv_ring_start.restype = ctypes.c_int
    lib.rcv_ring_start.argtypes = [ctypes.c_void_p, ctypes.c_double, ctypes.c_int]
    lib.rcv_ring_stop.restype = None
    lib.rcv_ring_stop.argtypes = [ctypes.c_void_p]
    lib.rcv_ring_destroy.restype = None
    lib.rcv_ring_destroy.argtypes = [ctypes.c_void_p]
    lib.rcv_ring_dequeue.restype = ctypes.c_long
    lib.rcv_ring_dequeue.argtypes = [ctypes.c_void_p, ctypes.POINTER(u8p), longp, longp,
                                     ctypes.c_long]
    lib.rcv_ring_requeue.restype = None
    lib.rcv_ring_requeue.argtypes = [ctypes.c_void_p, ctypes.c_long]
    lib.rcv_ring_dropped.restype = ctypes.c_long
    lib.rcv_ring_dropped.argtypes = [ctypes.c_void_p]
    lib.rcv_ring_slot_bytes.restype = ctypes.c_long
    lib.rcv_ring_slot_bytes.argtypes = [ctypes.c_void_p]
    # v4l2.cpp: the direct-ioctl driver (or its stub).
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.rcv_v4l2_available.restype = ctypes.c_int
    lib.rcv_v4l2_available.argtypes = []
    lib.rcv_v4l2_open.restype = ctypes.c_void_p
    lib.rcv_v4l2_open.argtypes = [ctypes.c_char_p, intp]
    lib.rcv_v4l2_enum_modes.restype = ctypes.c_long
    lib.rcv_v4l2_enum_modes.argtypes = [ctypes.c_void_p, u32p, intp, intp, intp, ctypes.c_long]
    lib.rcv_v4l2_setup.restype = ctypes.c_int
    lib.rcv_v4l2_setup.argtypes = [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_int, u32p, intp, intp, intp, longp]
    lib.rcv_v4l2_dequeue.restype = ctypes.c_long
    lib.rcv_v4l2_dequeue.argtypes = [ctypes.c_void_p, ctypes.POINTER(u8p), longp, longp, longp]
    lib.rcv_v4l2_set_ctrl.restype = ctypes.c_int
    lib.rcv_v4l2_set_ctrl.argtypes = [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_int32]
    lib.rcv_v4l2_get_ctrl.restype = ctypes.c_int
    lib.rcv_v4l2_get_ctrl.argtypes = [ctypes.c_void_p, ctypes.c_uint32,
                                      ctypes.POINTER(ctypes.c_int32)]
    lib.rcv_v4l2_restart.restype = ctypes.c_int
    lib.rcv_v4l2_restart.argtypes = [ctypes.c_void_p]
    lib.rcv_v4l2_stop.restype = ctypes.c_int
    lib.rcv_v4l2_stop.argtypes = [ctypes.c_void_p]
    lib.rcv_v4l2_close.restype = None
    lib.rcv_v4l2_close.argtypes = [ctypes.c_void_p]
    # unionfind.cpp: the connected-components host half.
    lib.rcv_union_find.restype = ctypes.c_long
    lib.rcv_union_find.argtypes = [i32p, ctypes.c_long, i32p, i32p, ctypes.c_long]
    for fn in (lib.rcv_ccl_label, lib.rcv_ccl_label8):
        fn.restype = ctypes.c_long
        fn.argtypes = [u8p, ctypes.c_long, ctypes.c_long, i32p]
    # mser.cpp and maxflow.cpp: the MSER triples and the GrabCut min-cut.
    lib.rcv_mser.restype = ctypes.c_long
    lib.rcv_mser.argtypes = [u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                             ctypes.c_int, ctypes.c_double, ctypes.c_double, i32p, ctypes.c_long]
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.rcv_maxflow_grid.restype = ctypes.c_int64
    lib.rcv_maxflow_grid.argtypes = [ctypes.c_int32, ctypes.c_int32, i64p, i64p, i64p, i64p,
                                     i64p, i64p, u8p]
    # lzw.cpp: the TIFF and GIF codecs' bit-level loops.
    for fn in (lib.rcv_gif_lzw_decode, lib.rcv_gif_lzw_encode):
        fn.restype = ctypes.c_long
        fn.argtypes = [u8p, ctypes.c_long, ctypes.c_int, u8p, ctypes.c_long]
    for fn in (lib.rcv_tiff_lzw_decode, lib.rcv_packbits_decode):
        fn.restype = ctypes.c_long
        fn.argtypes = [u8p, ctypes.c_long, u8p, ctypes.c_long]
    # vp8.cpp and vp8l.cpp: the WebP decodes.
    lib.rcv_vp8_info.restype = ctypes.c_int
    lib.rcv_vp8_info.argtypes = [u8p, ctypes.c_long, intp, intp]
    lib.rcv_vp8_decode.restype = ctypes.c_int
    lib.rcv_vp8_decode.argtypes = [u8p, ctypes.c_long, u8p, ctypes.c_long, ctypes.c_void_p,
                                   ctypes.c_long]
    lib.rcv_vp8l_info.restype = ctypes.c_int
    lib.rcv_vp8l_info.argtypes = [u8p, ctypes.c_long, intp, intp, intp]
    lib.rcv_vp8l_decode.restype = ctypes.c_int
    lib.rcv_vp8l_decode.argtypes = [u8p, ctypes.c_long, ctypes.c_void_p, ctypes.c_long]
    # vp8enc.cpp and vp8lenc.cpp: the WebP encodes.
    lib.rcv_vp8_encode.restype = ctypes.c_long
    lib.rcv_vp8_encode.argtypes = [u8p, ctypes.c_long, u8p, u8p, ctypes.c_long, u8p, ctypes.c_long,
                                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_int, u8p, ctypes.c_long]
    lib.rcv_alph_encode.restype = ctypes.c_long
    lib.rcv_alph_encode.argtypes = [u8p, ctypes.c_long, ctypes.c_int, ctypes.c_int, u8p,
                                    ctypes.c_long]


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built on first use; None if the build failed."""
    global _lib, _build_error
    with _lock:
        if _lib is None and _build_error is None:
            try:
                lib = ctypes.CDLL(str(_compile()))
                _bind(lib)
                _lib = lib
            except (OSError, RuntimeError) as e:
                _build_error = str(e)
        return _lib


def available() -> bool:
    return get_lib() is not None


def build_error() -> Optional[str]:
    get_lib()
    return _build_error


def _need_lib() -> ctypes.CDLL:
    lib = get_lib()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_build_error}")
    return lib


def _as_u8_buf(data: "np.ndarray | bytes") -> np.ndarray:
    """Flat uint8 view of the bytes (a copy only for non-arrays or
    non-contiguous arrays)."""
    if isinstance(data, np.ndarray):
        if data.dtype == np.uint8 and data.flags.c_contiguous:
            return data.reshape(-1)
        return np.ascontiguousarray(data).reshape(-1).view(np.uint8)
    return np.frombuffer(bytes(data), np.uint8)


def _ptr(a: np.ndarray, ctype=ctypes.c_uint8):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _info(lib, buf: np.ndarray) -> tuple:
    w, h, nc = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    hs, vs = (ctypes.c_int * 3)(), (ctypes.c_int * 3)()
    bw, bh = (ctypes.c_int * 3)(), (ctypes.c_int * 3)()
    rc = lib.rcv_jpeg_info(_ptr(buf), buf.size, ctypes.byref(w), ctypes.byref(h),
                           ctypes.byref(nc), hs, vs, bw, bh)
    if rc != 0:
        raise ValueError(f"unsupported or corrupt JPEG (rcv_jpeg_info rc={rc})")
    n = nc.value
    info = {"width": w.value, "height": h.value, "ncomp": n,
            "h_samp": [hs[c] for c in range(n)], "v_samp": [vs[c] for c in range(n)]}
    return info, [(bh[c], bw[c]) for c in range(n)]


def jpeg_entropy_decode(data: "np.ndarray | bytes"):
    """Baseline-JPEG entropy decode → coefficient grids + quant tables.

    Returns ``(info, coeffs, qtables)``: info is a dict with
    width/height/ncomp/h_samp/v_samp, ``coeffs[c]`` is int16
    (bh, bw, 8, 8) in natural order (full padded MCU grid), ``qtables[c]``
    is uint16 (8, 8). Raises ValueError for non-baseline streams.
    """
    lib = _need_lib()
    buf = _as_u8_buf(data)
    info, blocks = _info(lib, buf)
    ncomp = info["ncomp"]
    outs = [np.zeros((*blocks[c], 64) if c < ncomp else (1, 1, 64), np.int16) for c in range(3)]
    qs = [np.zeros(64, np.uint16) for _ in range(3)]
    rc = lib.rcv_jpeg_coeffs(_ptr(buf), buf.size,
                             *(_ptr(o, ctypes.c_int16) for o in outs),
                             *(_ptr(q, ctypes.c_uint16) for q in qs))
    if rc != 0:
        raise ValueError(f"JPEG entropy decode failed (rc={rc})")
    coeffs = [outs[c].reshape(*blocks[c], 8, 8) for c in range(ncomp)]
    return info, coeffs, [qs[c].reshape(8, 8) for c in range(ncomp)]


def jpeg_entropy_info(data: "np.ndarray | bytes") -> dict:
    """Header-only parse: geometry and the per-component padded block grids
    (``blocks``: (bh, bw) per component). Kept for parity with the
    reference; the engine reads the geometry from its decodes."""
    info, blocks = _info(_need_lib(), _as_u8_buf(data))
    info["blocks"] = blocks
    return info


_OVER_CAPACITY = -24  # the decoder's return code when the packed buffers are full


def _u16_tables():
    return [np.zeros(64, np.uint16) for _ in range(3)]


def jpeg_entropy_decode_packed(data: "np.ndarray | bytes", capacity: int):
    """Entropy decode to FLAT-packed nonzero coefficients.

    Returns ``(info, pos, val, nnz, qts)``: ``pos`` (int32) / ``val`` (int16)
    hold ``capacity`` entries whose first ``nnz`` are the nonzeros as flat
    indices into the concatenated dense per-component layout (a scatter-add
    of ``val`` into zeros gives :func:`jpeg_entropy_decode`'s grids); the
    rest are zero. Returns ``None`` when the frame has more than
    ``capacity`` nonzeros (the caller decodes dense instead). Kept for
    parity with the reference; the engine stages the block-packed form."""
    lib = _need_lib()
    buf = _as_u8_buf(data)
    info, blocks = _info(lib, buf)
    info["blocks"] = blocks
    pos = np.zeros(capacity, np.int32)
    val = np.zeros(capacity, np.int16)
    qs = _u16_tables()
    nnz = ctypes.c_long()
    rc = lib.rcv_jpeg_coeffs_packed(_ptr(buf), buf.size, _ptr(pos, ctypes.c_int32),
                                    _ptr(val, ctypes.c_int16), capacity,
                                    *(_ptr(q, ctypes.c_uint16) for q in qs), ctypes.byref(nnz))
    if rc == _OVER_CAPACITY:
        return None
    if rc != 0:
        raise ValueError(f"JPEG packed entropy decode failed (rc={rc})")
    return info, pos, val, int(nnz.value), [qs[c].reshape(8, 8) for c in range(info["ncomp"])]


def jpeg_entropy_decode_blockpacked(
    data: "np.ndarray | bytes",
    k: int,
    dense_cap: int,
    out_idx: Optional[np.ndarray] = None,
    out_val: Optional[np.ndarray] = None,
    out_dense_ids: Optional[np.ndarray] = None,
    out_dense_rows: Optional[np.ndarray] = None,
):
    """Entropy decode to BLOCK-packed coefficients.

    ``idx``/``val`` are ``[total_blocks, k]`` (uint8 natural coefficient
    index / int16 value; unused slots zero) over the concatenated
    per-component block grid. Blocks with more than ``k`` nonzeros take the
    dense-row escape: ``dense_ids`` (int32 global block id) and
    ``dense_rows`` (int16 [dense_cap, 64]). Entries past ``dense_n`` carry
    id == total_blocks and zero rows, so the arrays unpack as they are.
    ``out_*`` buffers (C-contiguous, of those shapes and dtypes) are
    written in place instead of new arrays; the dense ones may hold more
    than ``dense_cap`` rows.

    Returns ``(info, idx, val, dense_ids, dense_rows, dense_n, qts)``, or
    ``None`` when the busy blocks exceed ``dense_cap`` (the caller decodes
    dense instead). A buffer of another block grid (the geometry or the
    subsampling changed) raises ValueError."""
    lib = _need_lib()
    buf = _as_u8_buf(data)
    info, blocks = _info(lib, buf)
    info["blocks"] = blocks
    nblocks = sum(bh * bw for bh, bw in blocks)

    def out(given, shape, dtype, rows_at_least=False):
        if given is None:
            return np.zeros(shape, dtype)
        fits = (given.shape[1:] == shape[1:] and given.shape[0] >= shape[0] if rows_at_least
                else given.shape == shape)
        if not fits or given.dtype != dtype or not given.flags.c_contiguous:
            raise ValueError(
                f"staging {given.shape} {given.dtype} != frame's {shape} {np.dtype(dtype)} "
                "(geometry or subsampling changed mid-stream)")
        return given

    idx = out(out_idx, (nblocks, k), np.uint8)
    val = out(out_val, (nblocks, k), np.int16)
    dense_ids = out(out_dense_ids, (dense_cap,), np.int32, rows_at_least=True)
    dense_rows = out(out_dense_rows, (dense_cap, 64), np.int16, rows_at_least=True)
    qs = _u16_tables()
    dense_n = ctypes.c_long()
    rc = lib.rcv_jpeg_coeffs_blockpacked(
        _ptr(buf), buf.size, _ptr(idx), _ptr(val, ctypes.c_int16), k,
        _ptr(dense_ids, ctypes.c_int32), _ptr(dense_rows, ctypes.c_int16), dense_cap,
        *(_ptr(q, ctypes.c_uint16) for q in qs), ctypes.byref(dense_n))
    if rc == _OVER_CAPACITY:
        return None
    if rc != 0:
        raise ValueError(f"JPEG blockpacked entropy decode failed (rc={rc})")
    n = int(dense_n.value)
    dense_ids[n:] = nblocks  # the scratch-row id (buffers are reused across ticks)
    dense_rows[n:] = 0
    qts = [qs[c].reshape(8, 8) for c in range(info["ncomp"])]
    return info, idx, val, dense_ids, dense_rows, n, qts


def _geometry(ncomp: int, blocks, h_samp, v_samp) -> tuple:
    if ncomp not in (1, 3):
        raise ValueError(f"ncomp must be 1 or 3, got {ncomp}")
    bws, bhs = (ctypes.c_int * 3)(), (ctypes.c_int * 3)()
    hs, vs = (ctypes.c_int * 3)(), (ctypes.c_int * 3)()
    for c in range(ncomp):
        bhs[c], bws[c] = blocks[c]
        hs[c], vs[c] = h_samp[c], v_samp[c]
    return bws, bhs, hs, vs


def _tables(qts, ncomp: int) -> tuple:
    q0 = np.ascontiguousarray(qts[0], np.uint16).reshape(64)
    q1 = np.ascontiguousarray(qts[1], np.uint16).reshape(64) if ncomp == 3 else q0
    return q0, q1


def jpeg_entropy_encode(coeffs: list, qts: list, width: int, height: int,
                        h_samp: list, v_samp: list) -> bytes:
    """Baseline-JPEG entropy encode: quantized coefficient grids → JFIF bytes.

    ``coeffs[c]`` is int16 ``[bh, bw, 64]`` (or ``[bh, bw, 8, 8]``) in
    natural order over the full padded MCU grid, ``qts[c]`` the
    natural-order quant table (uint16, 64 entries; component 0 = luma table,
    components 1-2 share the chroma table). Standard Annex-K Huffman tables,
    single interleaved scan.
    """
    lib = _need_lib()
    ncomp = len(coeffs)
    arrs = [np.ascontiguousarray(c, np.int16).reshape(c.shape[0], c.shape[1], 64)
            for c in coeffs]
    geom = _geometry(ncomp, [a.shape[:2] for a in arrs], h_samp, v_samp)
    total_blocks = sum(a.shape[0] * a.shape[1] for a in arrs)
    arrs += [np.zeros((1, 1, 64), np.int16)] * (3 - ncomp)
    q0, q1 = _tables(qts, ncomp)
    # Worst case per coefficient: a 16-bit code + 10 magnitude bits, doubled
    # by 0xFF byte stuffing → 6.5 B; 8 B per coefficient + headers.
    cap = 4096 + total_blocks * 64 * 8
    out = np.empty(cap, np.uint8)
    n = lib.rcv_jpeg_entropy_encode(
        *(_ptr(a, ctypes.c_int16) for a in arrs), ncomp, *geom, width, height,
        _ptr(q0, ctypes.c_uint16), _ptr(q1, ctypes.c_uint16), _ptr(out), cap)
    if n < 0:
        raise ValueError(f"JPEG entropy encode failed (rc={n})")
    return out[:n].tobytes()


def jpeg_entropy_encode_packed(idx: np.ndarray, val: np.ndarray, dense_ids: np.ndarray,
                               dense_rows: np.ndarray, blocks: list, qts: list, width: int,
                               height: int, h_samp: list, v_samp: list) -> bytes:
    """Entropy-encode from block-packed coefficients (the layout of
    :func:`rustcv_tpu_torch.ops.jpeg_encode.pack_coeff_rows`): ``idx``/``val``
    are [nbt, K] u8/i16 over the component-concatenated block axis,
    ``dense_ids`` [dcap] i32 (a sentinel >= nbt is unused) and
    ``dense_rows`` [dcap, 64] i16 the busy-block escape; ``blocks`` the
    per-component (bh, bw). The bytes are those of :func:`jpeg_entropy_encode`
    on the equivalent dense grids."""
    lib = _need_lib()
    ncomp = len(blocks)
    geom = _geometry(ncomp, blocks, h_samp, v_samp)
    idx = np.ascontiguousarray(idx, np.uint8)
    val = np.ascontiguousarray(val, np.int16)
    dense_ids = np.ascontiguousarray(dense_ids, np.int32)
    dense_rows = np.ascontiguousarray(dense_rows, np.int16).reshape(-1, 64)
    if idx.shape != val.shape or idx.ndim != 2:
        raise ValueError(f"idx/val shape mismatch: {idx.shape} vs {val.shape}")
    nbt = sum(bh * bw for bh, bw in blocks)
    if idx.shape[0] != nbt:
        raise ValueError(f"idx rows {idx.shape[0]} != total blocks {nbt}")
    q0, q1 = _tables(qts, ncomp)
    cap = 4096 + nbt * 64 * 8
    out = np.empty(cap, np.uint8)
    n = lib.rcv_jpeg_entropy_encode_packed(
        _ptr(idx), _ptr(val, ctypes.c_int16), idx.shape[1],
        _ptr(dense_ids, ctypes.c_int32), _ptr(dense_rows, ctypes.c_int16),
        int(dense_ids.shape[0]), ncomp, *geom, width, height,
        _ptr(q0, ctypes.c_uint16), _ptr(q1, ctypes.c_uint16), _ptr(out), cap)
    if n < 0:
        raise ValueError(f"JPEG packed entropy encode failed (rc={n})")
    return out[:n].tobytes()


def text_glyph(points: np.ndarray, on_curve: np.ndarray, ends: np.ndarray, canvas: np.ndarray,
               org: tuple, clip: tuple) -> None:
    """Rasterize one glyph outline (``text_raster.cpp``) and compose it over
    ``canvas`` (C-contiguous (H, W) u8, in place) as Pillow composes glyphs.

    ``points`` int32 [P, 2] 26.6, ``on_curve`` u8 [P], ``ends`` int32 [C]
    (each contour's last point); the outline's origin is put at canvas
    column ``org[0]``, on the baseline under row ``org[1] - 1``; only
    ``clip`` = (x0, y0, x1, y1) is written."""
    lib = _need_lib()
    if canvas.dtype != np.uint8 or canvas.ndim != 2 or not canvas.flags.c_contiguous:
        raise ValueError("canvas must be a C-contiguous (H, W) uint8 array")
    pts = np.ascontiguousarray(points, np.int32)
    on = np.ascontiguousarray(on_curve, np.uint8)
    e = np.ascontiguousarray(ends, np.int32)
    rc = lib.rcv_text_glyph(_ptr(pts, ctypes.c_int32), _ptr(on), len(pts), _ptr(e, ctypes.c_int32),
                            len(e), int(org[0]), int(org[1]), _ptr(canvas), canvas.shape[1],
                            canvas.shape[0], *map(int, clip))
    if rc != 0:
        raise ValueError(f"malformed glyph outline (rcv_text_glyph rc={rc})")


def _frame(lib, buf: np.ndarray) -> tuple:
    """(width, height, components) of any frame the host decode parses."""
    w, h, nc, flags = ctypes.c_int(), ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    arrs = [(ctypes.c_int * 4)() for _ in range(4)]
    rc = lib.rcv_jpeg_host_info(_ptr(buf), buf.size, ctypes.byref(w), ctypes.byref(h),
                                ctypes.byref(nc), *arrs, ctypes.byref(flags))
    if rc != 0:
        raise ValueError(f"unsupported or corrupt JPEG (rcv_jpeg_host_info rc={rc})")
    return w.value, h.value, nc.value


def jpeg_header(data: "np.ndarray | bytes") -> tuple:
    """(width, height, components) from the frame header of a JPEG the host
    decode reads: baseline, extended sequential, progressive, lossless and
    arithmetic-coded, of one, three or four components. Raises ValueError
    for one it does not read (libjpeg refuses it too, or Pillow does)."""
    w, h, nc = _frame(_need_lib(), _as_u8_buf(data))
    if nc == 2:  # read only with no colour conversion (jpeg_decode_bgr)
        raise ValueError("unsupported or corrupt JPEG (rcv_jpeg_host_info rc=-6)")
    return w, h, nc


def cmyk_to_rgb(cmyk: np.ndarray) -> np.ndarray:
    """Pillow's CMYK → RGB (``Convert.c``'s integer formula, the copy the
    JPEG decode uses): (..., 4) u8 → (..., 3) u8."""
    lib = _need_lib()
    src = np.ascontiguousarray(cmyk, np.uint8)
    out = np.empty(src.shape[:-1] + (3,), np.uint8)
    lib.rcv_cmyk_to_rgb(_ptr(src), src.size // 4, _ptr(out))
    return out


# The colour rules of jpeg_decode_bgr, as the C decode numbers them
_COLOUR = {"stream": 0, "ycbcr": 1, "none": 2}


def jpeg_decode_bgr(data: "np.ndarray | bytes", out: Optional[np.ndarray] = None,
                    colour: str = "stream") -> np.ndarray:
    """Full host decode of a JPEG (``jpeg_host.cpp``: the port's entropy
    decoder over every scan, Huffman or arithmetic, libjpeg's block
    smoothing of a progressive stream left unrefined, the integer islow
    IDCT or a lossless frame's predictors, libjpeg's upsampler per
    component, the integer YCbCr tables, Pillow's CMYK; no libjpeg) → BGR
    (H, W, 3) u8: what Pillow's libjpeg-turbo and ``convert("RGB")`` give.

    ``colour`` is the rule libjpeg's caller sets for the components:
    ``"stream"`` the stream's own markers (Pillow's JPEG reads);
    ``"ycbcr"`` YCbCr → RGB whatever the markers say (libtiff's
    ``JPEGCOLORMODE_RGB`` on a YCbCr page; three components, else
    ValueError); ``"none"`` no conversion (libtiff on every other page):
    the upsampled components as they are, (H, W, components) in their
    order, four not inverted.

    ``out`` (optional) is written in place: an (H, W, 3) u8 array (H, W,
    components for ``"none"``) whose rows may be strided (a Mat's padded
    rows), with packed pixels; the frame must be its size (the decode
    checks it, so the header is parsed once). Raises ValueError for a
    corrupt stream, one libjpeg or Pillow refuses, or an ``out`` of
    another size."""
    lib = _need_lib()
    buf = _as_u8_buf(data)
    if out is None:
        w, h, nc = _frame(lib, buf)
        out = np.empty((h, w, nc if colour == "none" else 3), np.uint8)
    n = out.shape[2] if out.ndim == 3 else 0
    if (out.ndim != 3 or (n != 3 and colour != "none") or out.dtype != np.uint8
            or out.strides[1:] != (n, 1) or not out.flags.writeable):
        raise ValueError("out must be a writable (H, W, 3) uint8 array with packed pixels")
    h, w = out.shape[:2]
    rc = lib.rcv_jpeg_decode_bgr(_ptr(buf), buf.size, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                                 out.strides[0], w, h, _COLOUR[colour])
    if rc == -41:
        raise ValueError(f"out must be the frame's size, not ({h}, {w}, {n})")
    if rc != 0:
        raise ValueError(f"JPEG decode failed (rcv_jpeg_decode_bgr rc={rc})")
    return out


def tiff_ycbcr_to_rgb(ycbcr: np.ndarray, luma=(0.299, 0.587, 0.114),
                      ref_bw=(0.0, 255.0, 128.0, 255.0, 128.0, 255.0)) -> np.ndarray:
    """libtiff's YCbCr → RGB (``tif_color.c``, which Pillow reaches through
    ``TIFFRGBAImage``): (..., 3) u8 Y, Cb, Cr → (..., 3) u8 R, G, B with
    the tables of the YCbCrCoefficients (``luma``) and ReferenceBlackWhite
    (``ref_bw``) tags, made in single precision as libtiff makes them.
    Raises ValueError where libtiff refuses the tags."""
    lib = _need_lib()
    src = np.ascontiguousarray(ycbcr, np.uint8)
    out = np.empty(src.shape, np.uint8)
    lu = np.asarray(luma, np.float32)
    rb = np.asarray(ref_bw, np.float32)
    if lu.size != 3 or rb.size != 6 or src.shape[-1:] != (3,):
        raise ValueError("tiff_ycbcr_to_rgb takes (..., 3) samples, 3 coefficients, 6 references")
    if lib.rcv_tiff_ycbcr_to_rgb(_ptr(src), src.size // 3, _ptr(lu, ctypes.c_float),
                                 _ptr(rb, ctypes.c_float), _ptr(out)) != 0:
        raise ValueError("invalid YCbCrCoefficients or ReferenceBlackWhite values")
    return out


def png_unfilter(raw: bytes, height: int, row_bytes: int, bpp: int) -> np.ndarray:
    """Undo PNG's per-row filters (``png_filter.cpp``): ``raw`` is the
    inflated image data, ``height`` rows of a filter byte and ``row_bytes``
    bytes; returns (height, row_bytes) u8. Raises ValueError for a bad
    filter type or short data."""
    lib = _need_lib()
    buf = _as_u8_buf(raw)
    out = np.empty((height, row_bytes), np.uint8)
    rc = lib.rcv_png_unfilter(_ptr(buf), buf.size, height, row_bytes, bpp, _ptr(out))
    if rc != 0:
        raise ValueError("corrupt PNG image data" if rc == -2 else "unknown PNG filter type")
    return out


def gif_lzw_decode(data: bytes, min_bits: int, n: int) -> np.ndarray:
    """GIF image data (its sub-blocks joined) → up to ``n`` colour indices
    (``lzw.cpp``): fewer when the end code or the data comes first. Raises
    ValueError for a corrupt stream or a minimum code size outside 1-8."""
    lib = _need_lib()
    buf = _as_u8_buf(data)
    out = np.zeros(n, np.uint8)
    got = lib.rcv_gif_lzw_decode(_ptr(buf), buf.size, int(min_bits), _ptr(out), n)
    if got < 0:
        raise ValueError("corrupt GIF image data" if got == -1 else
                         f"bad GIF LZW minimum code size {min_bits}")
    return out[:got]


def gif_lzw_encode(idx: np.ndarray, min_bits: int) -> bytes:
    """Colour indices (u8, each below ``1 << min_bits``) → GIF LZW codes,
    clear code first and end code last, not yet cut into sub-blocks."""
    lib = _need_lib()
    buf = np.ascontiguousarray(idx, np.uint8).ravel()
    cap = 64 + buf.size * 2  # at most 12 bits per index, plus the clears
    out = np.empty(cap, np.uint8)
    got = lib.rcv_gif_lzw_encode(_ptr(buf), buf.size, int(min_bits), _ptr(out), cap)
    if got < 0:
        raise ValueError(f"GIF LZW encode failed (rc={got})")
    return out[:got].tobytes()


def tiff_lzw_decode(data: bytes, n: int) -> np.ndarray:
    """A TIFF LZW strip or tile → up to ``n`` bytes (fewer when the end
    code or the data comes first). Raises ValueError for a corrupt stream,
    ``not_ported`` for old-style LZW."""
    from ..core.errors import not_ported

    lib = _need_lib()
    buf = _as_u8_buf(data)
    out = np.zeros(n, np.uint8)
    got = lib.rcv_tiff_lzw_decode(_ptr(buf), buf.size, _ptr(out), n)
    if got == -3:
        raise not_ported("old-style (LSB-first) TIFF LZW", item="8")
    if got < 0:
        raise ValueError("corrupt TIFF LZW data")
    return out[:got]


def packbits_decode(data: bytes, n: int) -> np.ndarray:
    """A PackBits strip or tile → up to ``n`` bytes (fewer when the data
    ends first)."""
    lib = _need_lib()
    buf = _as_u8_buf(data)
    out = np.zeros(n, np.uint8)
    got = lib.rcv_packbits_decode(_ptr(buf), buf.size, _ptr(out), n)
    return out[:got]


_WEBP_ERRORS = {-1: "corrupt", -2: "truncated", -3: "corrupt alpha in a",
                -4: "unsupported (not a displayable key frame)", -5: "too large a"}


def _webp_error(rc: int, what: str) -> ValueError:
    return ValueError(f"{_WEBP_ERRORS.get(rc, 'corrupt')} {what} bitstream")


def vp8_info(data: "np.ndarray | bytes") -> tuple:
    """(width, height) of a VP8 chunk's payload (libwebp's ``VP8GetInfo``
    checks); raises ValueError where they fail."""
    lib = _need_lib()
    buf = _as_u8_buf(data)
    w, h = ctypes.c_int(), ctypes.c_int()
    rc = lib.rcv_vp8_info(_ptr(buf), buf.size, ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise _webp_error(rc, "VP8")
    return w.value, h.value


def vp8l_info(data: "np.ndarray | bytes") -> tuple:
    """(width, height, alpha bit) of a VP8L chunk's payload; raises
    ValueError for a bad signature or version."""
    lib = _need_lib()
    buf = _as_u8_buf(data)
    w, h, a = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = lib.rcv_vp8l_info(_ptr(buf), buf.size, ctypes.byref(w), ctypes.byref(h), ctypes.byref(a))
    if rc != 0:
        raise _webp_error(rc, "VP8L")
    return w.value, h.value, a.value


def _rgba_out(out: Optional[np.ndarray], w: int, h: int) -> np.ndarray:
    if out is None:
        return np.empty((h, w, 4), np.uint8)
    if out.shape != (h, w, 4) or out.dtype != np.uint8 or out.strides[1:] != (4, 1):
        raise ValueError(f"out must be ({h}, {w}, 4) u8 with packed pixels")
    return out


def vp8_decode(data: "np.ndarray | bytes", alpha: "np.ndarray | bytes | None" = None,
               out: Optional[np.ndarray] = None) -> np.ndarray:
    """A VP8 chunk's payload (the pad byte too where the file has one) →
    (H, W, 4) RGBA u8 (``vp8.cpp``: libwebp's default decode, fancy
    upsampling), alpha from the ALPH chunk's payload ``alpha`` (255 without
    one). ``out``: an (H, W, 4) u8 view to write into, such as a region of
    a larger canvas. Raises ValueError for a corrupt or truncated stream."""
    lib = _need_lib()
    buf = _as_u8_buf(data)
    w, h = vp8_info(buf)
    out = _rgba_out(out, w, h)
    abuf = None if alpha is None else _as_u8_buf(alpha)
    rc = lib.rcv_vp8_decode(_ptr(buf), buf.size, None if abuf is None else _ptr(abuf),
                            0 if abuf is None else abuf.size, out.ctypes.data, out.strides[0])
    if rc != 0:
        raise _webp_error(rc, "VP8")
    return out


def vp8l_decode(data: "np.ndarray | bytes", out: Optional[np.ndarray] = None) -> np.ndarray:
    """A VP8L chunk's payload → (H, W, 4) RGBA u8 (``vp8l.cpp``); ``out`` as
    for :func:`vp8_decode`. Raises ValueError for a corrupt or truncated
    stream."""
    lib = _need_lib()
    buf = _as_u8_buf(data)
    w, h, _ = vp8l_info(buf)
    out = _rgba_out(out, w, h)
    rc = lib.rcv_vp8l_decode(_ptr(buf), buf.size, out.ctypes.data, out.strides[0])
    if rc != 0:
        raise _webp_error(rc, "VP8L")
    return out


def _plane(a: np.ndarray, name: str) -> np.ndarray:
    a = np.asarray(a)
    if a.dtype != np.uint8 or a.ndim != 2:
        raise ValueError(f"{name} must be a 2-D uint8 plane")
    return a if a.strides[1] == 1 and a.strides[0] >= a.shape[1] else np.ascontiguousarray(a)


def vp8_encode(y: np.ndarray, u: np.ndarray, v: np.ndarray, quality: int = 80, method: int = 4,
               filter_strength: int = 60, alpha: Optional[np.ndarray] = None) -> bytes:
    """Y (H, W), U and V ((H + 1) // 2, (W + 1) // 2) u8 planes → a VP8
    chunk's payload, a key frame as libwebp's encoder makes it
    (``vp8enc.cpp``): ``quality`` 0-100, ``method`` (4 and up weigh the
    spectral distortion in the luma choices), ``filter_strength`` 0-100 (60
    is Pillow's; 0 turns the loop filter off, as libwebp's animation encoder
    does for a blended frame). With ``alpha`` (the (H, W) plane the ALPH
    chunk carries), the colour under transparent pixels is flattened first,
    as libwebp's ``WebPCleanupTransparentArea`` does. Raises ValueError for
    bad planes or a side above 16383, RuntimeError when the library did
    not build."""
    lib = _need_lib()
    y, u, v = _plane(y, "y"), _plane(u, "u"), _plane(v, "v")
    h, w = y.shape
    if not (1 <= w <= 16383 and 1 <= h <= 16383):
        raise ValueError(f"vp8_encode: a {w}x{h} frame (each side must be 1-16383)")
    if u.shape != ((h + 1) // 2, (w + 1) // 2) or v.shape != u.shape or u.strides != v.strides:
        raise ValueError("vp8_encode: U and V must be (H + 1) // 2 x (W + 1) // 2, alike")
    if alpha is not None:
        alpha = _plane(alpha, "alpha")
        if alpha.shape != (h, w):
            raise ValueError("vp8_encode: alpha must be (H, W)")
    mbs = ((w + 15) // 16) * ((h + 15) // 16)
    cap = 4096 + 2400 * mbs  # above the largest frame the coder writes
    out = np.empty(cap, np.uint8)
    n = lib.rcv_vp8_encode(_ptr(y), y.strides[0], _ptr(u), _ptr(v), u.strides[0],
                           None if alpha is None else _ptr(alpha),
                           0 if alpha is None else alpha.strides[0], w, h, int(quality),
                           int(method), int(filter_strength), _ptr(out), cap)
    if n < 0:
        raise ValueError(f"vp8_encode failed (code {n})")
    return out[:n].tobytes()


def alph_encode(alpha: np.ndarray) -> bytes:
    """An (H, W) u8 alpha plane → an ALPH chunk's payload (``vp8lenc.cpp``):
    VP8L-compressed under the alpha filter that gives the smallest stream,
    or raw where that is smaller. Lossless:
    ``vp8_decode``'s alpha reads it back exactly. Raises ValueError for a
    bad plane, RuntimeError when the library did not build."""
    lib = _need_lib()
    a = _plane(alpha, "alpha")
    h, w = a.shape
    if not (1 <= w <= 16383 and 1 <= h <= 16383):
        raise ValueError(f"alph_encode: a {w}x{h} plane (each side must be 1-16383)")
    cap = 1 + w * h
    out = np.empty(cap, np.uint8)
    n = lib.rcv_alph_encode(_ptr(a), a.strides[0], w, h, _ptr(out), cap)
    if n < 0:
        raise ValueError(f"alph_encode failed (code {n})")
    return out[:n].tobytes()


def ccl_label(mask: np.ndarray, connectivity: int = 4) -> tuple:
    """Two-pass union-find connected components (4- or 8-connectivity)
    over a u8 mask (``unionfind.cpp``): returns ``(count, labels int32
    (H, W))``, components numbered 1..count by raster-first pixel,
    background 0. Raises RuntimeError when the library did not build."""
    lib = _need_lib()
    if connectivity not in (4, 8):
        raise ValueError(f"connectivity must be 4 or 8, got {connectivity}")
    m = np.ascontiguousarray(mask, np.uint8)
    if m.ndim != 2:
        raise ValueError(f"ccl_label: 2-D mask required, got {m.shape}")
    labels = np.empty(m.shape, np.int32)
    fn = lib.rcv_ccl_label8 if connectivity == 8 else lib.rcv_ccl_label
    n = fn(_ptr(m), m.shape[0], m.shape[1], _ptr(labels, ctypes.c_int32))
    if n < 0:
        raise ValueError(f"ccl_label failed (rc={n})")
    return int(n), labels


def union_find(n: int, edges_a: np.ndarray, edges_b: np.ndarray) -> tuple:
    """Min-root union-find over ``n`` nodes with undirected edges
    ``(edges_a[i], edges_b[i])``: returns ``(count, root)`` where
    ``root[i]`` is the SMALLEST node id in i's component. Raises
    RuntimeError when the library did not build."""
    lib = _need_lib()
    ea = np.ascontiguousarray(edges_a, np.int32)
    eb = np.ascontiguousarray(edges_b, np.int32)
    if ea.shape != eb.shape or ea.ndim != 1:
        raise ValueError(f"edge arrays must be 1-D and equal: {ea.shape} vs {eb.shape}")
    parent = np.empty(int(n), np.int32)
    cnt = lib.rcv_union_find(_ptr(parent, ctypes.c_int32), int(n), _ptr(ea, ctypes.c_int32),
                             _ptr(eb, ctypes.c_int32), int(ea.shape[0]))
    if cnt < 0:
        raise ValueError(f"union_find failed (rc={cnt}; edge id out of range?)")
    return int(cnt), parent


def mser_triples(gray: np.ndarray, delta: int, min_area: int, max_area: int,
                 max_variation: float, min_diversity: float) -> np.ndarray:
    """MSER (seed, level, area) triples (``mser.cpp``), bit-identical to
    the frozen Python spec ``ops.mser._mser_triples_spec``: int32 (N, 3)
    sorted by (seed, level). Raises RuntimeError when the library did not
    build (the reference returns None there and its caller falls back)."""
    lib = _need_lib()
    g = np.ascontiguousarray(gray, np.uint8)
    if g.ndim != 2:
        raise ValueError(f"mser_triples: 2-D gray required, got {g.shape}")
    cap = 4096
    while True:
        out = np.empty((cap, 3), np.int32)
        cnt = lib.rcv_mser(_ptr(g), g.shape[0], g.shape[1], int(delta), int(min_area),
                           int(max_area), float(max_variation), float(min_diversity),
                           _ptr(out, ctypes.c_int32), cap)
        if cnt < 0:
            raise ValueError(f"rcv_mser failed (rc={cnt})")
        if cnt <= cap:
            return out[:cnt].copy()
        cap = int(cnt)


def maxflow_grid(cap_src: np.ndarray, cap_snk: np.ndarray, right: np.ndarray,
                 down: np.ndarray, down_right: np.ndarray, down_left: np.ndarray) -> np.ndarray:
    """Min cut of the 8-connected pixel grid (``maxflow.cpp``, Dinic):
    int64 (H, W) terminal capacities and the four n-link planes (right,
    down, down-right, down-left) → (max-flow value, u8 (H, W) labels, 1
    where the pixel stays on the source side). Raises RuntimeError when
    the library did not build."""
    lib = _need_lib()
    h, w = cap_src.shape
    planes = [np.ascontiguousarray(a, np.int64).reshape(-1)
              for a in (cap_src, cap_snk, right, down, down_right, down_left)]
    if any(p.size != h * w for p in planes):
        raise ValueError("maxflow_grid: every plane must be (H, W)")
    labels = np.zeros(h * w, np.uint8)
    flow = lib.rcv_maxflow_grid(h, w, *(_ptr(p, ctypes.c_int64) for p in planes), _ptr(labels))
    return int(flow), labels.reshape(h, w)


def v4l2_available() -> bool:
    """Whether the library was built with the V4L2 driver (a Linux host
    with ``linux/videodev2.h``) rather than its stub. Raises RuntimeError
    when the library did not build."""
    return bool(_need_lib().rcv_v4l2_available())


class NativeRing:
    """Threaded producer ring, the native capture front end
    (``capture.cpp``).

    The producer thread writes the frozen test pattern as YUYV frames into
    the ring's slots, at ``fps`` when paced, else as fast as it can;
    :meth:`dequeue` blocks like DQBUF and returns a zero-copy view of a
    slot. A consumer holds at most ``slots - 1`` slots and hands each back
    with :meth:`requeue`; while it holds all of them the producer drops
    frames (sequence gaps, :attr:`dropped`). The ``Frame`` invalidation
    contract is kept one level up, in ``capture.native_source``."""

    def __init__(self, slots: int, width: int, height: int):
        self._lib = _need_lib()
        self._ring = self._lib.rcv_ring_create(slots, width, height)
        self.width = width
        self.height = height
        self.slot_bytes = self._lib.rcv_ring_slot_bytes(self._ring)

    def start(self, fps: float, paced: bool = True) -> None:
        if self._lib.rcv_ring_start(self._ring, float(fps), 1 if paced else 0) != 0:
            raise RuntimeError("the ring's producer is already running")

    def stop(self) -> None:
        self._lib.rcv_ring_stop(self._ring)

    def dequeue(self, timeout_ms: int = 2000):
        """→ (slot, data view (slot_bytes,) u8, seq, ts_ns), or None on a
        timeout or when the ring stopped."""
        data = ctypes.POINTER(ctypes.c_uint8)()
        seq = ctypes.c_long()
        ts = ctypes.c_long()
        slot = self._lib.rcv_ring_dequeue(self._ring, ctypes.byref(data), ctypes.byref(seq),
                                          ctypes.byref(ts), timeout_ms)
        if slot < 0:
            return None
        view = np.ctypeslib.as_array(data, shape=(self.slot_bytes,))
        return int(slot), view, int(seq.value), int(ts.value)

    def requeue(self, slot: int) -> None:
        self._lib.rcv_ring_requeue(self._ring, slot)

    @property
    def dropped(self) -> int:
        return int(self._lib.rcv_ring_dropped(self._ring))

    def close(self) -> None:
        """Stop the producer and free the ring (idempotent)."""
        if self._ring:
            self._lib.rcv_ring_destroy(self._ring)
            self._ring = None

    def __del__(self):
        if getattr(self, "_ring", None):
            self.close()
