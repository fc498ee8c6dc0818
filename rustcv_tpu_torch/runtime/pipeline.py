"""The per-tick pipeline (port of ``rustcv_tpu.runtime.pipeline``: every
uncompressed wire format, the full-host MJPEG decode's BGR staging and the
hybrid MJPEG reconstruction).

``raw u8 [N, raw_bytes] → decode → (resize) → (filter) → (overlay) → (JPEG
encode) → outputs`` for a batch of N streams, as a plain function on
tensors. The decode converts any uncompressed format (YUYV, UYVY, NV12,
YV12, BGRA32, RGBA32, RGB24, BGR24, GRAY8, the four Bayer patterns); the
BGR image is emitted as packed rows ``(N, H, W*3)`` exactly where the
reference emits them, else as ``(N, H, W, 3)``: the same bytes. With
``mjpeg_hybrid`` the input is the host entropy decoder's
coefficients instead (block-packed with ``mjpeg_packed``, else dense
grids), and the decode is :mod:`rustcv_tpu_torch.ops.jpeg_tpu`'s
dequantize → IDCT → upsample → colour, resized in plane form. The filter
reads the resized image before the overlay; the
encoder reads it after. The stages run as the plain PyTorch ops of
:mod:`rustcv_tpu_torch.ops` or, where a spec selects them, as the CUDA
kernels of :mod:`rustcv_tpu_torch.ops.kernels`:

* ``stencil_impl`` ``"pallas"``, ``"pallas_v1"`` or ``"pallas_v2"`` runs the
  blur_sobel filter as the stencil kernel (K1); ``"xla"`` runs the plain chain.
* ``harris`` and ``harris_points`` run the Harris kernel (K6, int32 form)
  for the response, then the plain threshold, NMS and top-K.
* ``RUSTCV_DECODE=pallas`` decodes with the fused decode+overlay kernel (K4)
  for the gray filters; ``RUSTCV_DECODE=pallas_tick`` runs the whole
  blur_sobel tick as one kernel (K5). Unset or ``xla``: the plain decode.
  Both kernels read YUYV: neither runs for another format, with
  ``resize_to``, with ``encode_jpeg`` or for MJPEG, as in the reference.
* ``RUSTCV_DECODE=xla_fused`` paints the overlay on the YUYV decode's pixel
  pairs before the interleave (``color.yuyv_to_bgr_packed_overlay``, plain
  PyTorch) for a YUYV spec with the overlay and no resize; the filters then
  read the painted image, as the reference's do. Any other spec takes the
  plain decode. The blur_sobel stencil is still K1 where ``stencil_impl``
  selects it.
* ``encode_jpeg`` > 0 adds the encoder's numeric half (``enc_y``,
  ``enc_cb``, ``enc_cr``: int16 coefficient rows) and, with
  ``encode_packed``, their block-packed form and its byte blob for the
  host Huffman coder; plain PyTorch, the DCT a float32 ``torch.matmul``.

For the full-host MJPEG decode the staged bytes are already BGR24 (or
RGB24), decoded on the host, and go through that format's decode.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from functools import lru_cache
from typing import Optional, Tuple

import torch

from ..core.pixel_format import PixelFormat

from ..ops import color as _color
from ..ops import decode as _decode
from ..ops import draw as _draw
from ..ops import features as _features
from ..ops import filters as _filters
from ..ops import jpeg_encode as _jenc
from ..ops import jpeg_tpu as _jpeg
from ..ops import kernels as _kernels
from ..ops import resize as _resize

STENCIL_IMPLS = ("xla", "pallas", "pallas_v1", "pallas_v2")
FILTERS = ("none", "gaussian", "sobel_mag", "blur_sobel", "canny", "harris", "harris_points")
# Filters that read the gray plane, which K4 emits beside the BGR image.
GRAY_FILTERS = ("sobel_mag", "blur_sobel", "canny", "harris", "harris_points")
HARRIS_POINTS = 256  # corners per stream of the harris_points filter


@dataclass(frozen=True)
class PipelineSpec:
    """Static description of one pipeline variant (same fields as the
    reference's, so a spec means the same thing in both packages)."""

    pixel_format: PixelFormat
    width: int
    height: int
    resize_to: Optional[Tuple[int, int]] = None  # (w, h) after convert
    filter: str = "none"  # one of FILTERS
    overlay: bool = False  # rectangle overlay on the BGR output
    emit_bgr: bool = True  # return the BGR image
    emit_filtered: bool = True  # return the filter output (if any)
    stencil_impl: str = "xla"  # xla | pallas | pallas_v1 | pallas_v2
    mjpeg_hybrid: bool = False
    mjpeg_packed: bool = False
    coeff_geometry: Tuple[Tuple[int, int], ...] = ()
    mjpeg_staged_bgr: bool = False
    encode_jpeg: int = 0
    encode_subsampling: str = "4:2:0"
    encode_packed: int = 0
    encode_dense_cap: int = 0

    def raw_bytes(self) -> int:
        """Bytes of one stream's staging row: BGR for MJPEG (the full-host
        decode stages BGR or RGB), else the wire format's size."""
        if self.pixel_format == PixelFormat.MJPEG:
            return self.width * self.height * 3
        return self.pixel_format.buffer_size(self.width, self.height)

    def staged_format(self) -> PixelFormat:
        """The format of the staged bytes (the full-host MJPEG decode's
        output, else the wire format)."""
        if self.pixel_format == PixelFormat.MJPEG:
            return PixelFormat.BGR24 if self.mjpeg_staged_bgr else PixelFormat.RGB24
        return self.pixel_format


def decode_mode() -> str:
    """The ``RUSTCV_DECODE`` mode, read as the reference reads it."""
    return os.environ.get("RUSTCV_DECODE", "xla")


def _check_ported(spec: PipelineSpec, mode: str) -> None:
    fmt = spec.pixel_format
    if fmt == PixelFormat.MJPEG:
        if spec.mjpeg_packed and len(spec.coeff_geometry) != 3:
            raise ValueError("mjpeg_packed needs coeff_geometry: (bh, bw) of Y, Cb and Cr")
    elif spec.mjpeg_hybrid or spec.mjpeg_packed:
        raise ValueError("mjpeg_hybrid and mjpeg_packed need pixel_format MJPEG")
    # What each wire format's layout allows: pixel pairs share chroma, 4:2:0
    # shares it over 2×2 sites, the demosaic mirrors about an edge pixel.
    if fmt in _PAIRWISE and spec.width % 2:
        raise ValueError(f"{fmt.value} needs an even width, got {spec.width}")
    if fmt in (PixelFormat.NV12, PixelFormat.YV12) and spec.height % 2:
        raise ValueError(f"{fmt.value} needs an even height, got {spec.height}")
    if fmt.is_bayer and min(spec.width, spec.height) < 2:
        raise ValueError(f"{fmt.value} needs W, H >= 2, got {spec.width}x{spec.height}")
    if spec.resize_to is not None and min(spec.resize_to) < 1:
        raise ValueError(f"resize_to must be positive, got {spec.resize_to}")
    if spec.encode_jpeg and spec.encode_subsampling not in _jenc.SUBSAMPLINGS:
        raise ValueError(f"unknown encode_subsampling {spec.encode_subsampling!r}")
    if spec.encode_packed and (not spec.encode_jpeg or spec.encode_dense_cap < 1):
        raise ValueError("encode_packed needs encode_jpeg > 0 and encode_dense_cap >= 1")
    if spec.filter not in FILTERS:
        raise ValueError(f"unknown filter {spec.filter!r}")
    if spec.stencil_impl not in STENCIL_IMPLS:
        raise ValueError(f"unknown stencil_impl {spec.stencil_impl!r}")


# Formats whose pixel pairs share chroma: the reference decodes them in pair
# form into packed rows at any (even) width.
_PAIRWISE = (PixelFormat.YUYV, PixelFormat.UYVY, PixelFormat.NV12, PixelFormat.YV12)


def packed_output(spec: PipelineSpec) -> bool:
    """Whether the reference emits ``spec``'s BGR as packed rows (N, H, W*3)
    rather than (N, H, W, 3) (its ``packed`` rule, which follows its word
    tricks): the pairwise formats at any width, BGRA32, RGB24, BGR24 and
    Bayer at a width that is a multiple of 4, a resize only between two such
    widths, hybrid MJPEG at an output width that is; never GRAY8 or RGBA32."""
    fmt = spec.staged_format()
    if spec.mjpeg_hybrid:
        return (spec.resize_to[0] if spec.resize_to else spec.width) % 4 == 0
    return (
        (fmt in _PAIRWISE + (PixelFormat.BGRA32, PixelFormat.RGB24, PixelFormat.BGR24)
         or fmt.is_bayer)
        and (fmt in _PAIRWISE or spec.width % 4 == 0)
        and (spec.resize_to is None or (spec.width % 4 == 0 and spec.resize_to[0] % 4 == 0))
    )


# The gray plane straight from the raw bytes where the reference takes it so
# (the same values as the luma of the decoded BGR).
_RAW_GRAY = {
    PixelFormat.YUYV: _color.yuyv_to_gray, PixelFormat.UYVY: _color.uyvy_to_gray,
    PixelFormat.NV12: _color.nv12_to_gray, PixelFormat.YV12: _color.yv12_to_gray,
    PixelFormat.RGB24: _color.rgb_to_gray_packed_rows,
    PixelFormat.BGR24: _color.bgr_to_gray_packed_rows,
}


def _build(spec: PipelineSpec, mode: str):
    _check_ported(spec, mode)
    w, h = spec.width, spec.height
    hybrid = spec.mjpeg_hybrid
    fmt = spec.staged_format()
    # K4 and K5 decode YUYV at the input size: neither runs for another
    # format, with a resize or with an encode, as in the reference.
    plain_size = fmt == PixelFormat.YUYV and spec.resize_to is None and not spec.encode_jpeg
    fused_decode = plain_size and mode == "pallas" and spec.filter in GRAY_FILTERS
    fused_tick = (
        plain_size and mode == "pallas_tick" and spec.filter == "blur_sobel"
        and spec.emit_bgr and spec.emit_filtered
    )
    # xla_fused: the overlay on the pair planes (YUYV at the input size).
    overlay_on_pairs = (fmt == PixelFormat.YUYV and spec.resize_to is None and spec.overlay
                        and mode == "xla_fused")
    cur_w, cur_h = (w, h) if spec.resize_to is None else spec.resize_to
    # The image stays in packed rows throughout; the output takes the
    # reference's layout (the same bytes either way).
    packed_out = packed_output(spec)

    def reconstruct_mjpeg(x):
        """Coefficients → packed BGR rows at the output size. ``x`` is
        ``(idx, val, dense_ids, dense_rows, qty, qtc)`` with mjpeg_packed,
        else the dense grids ``(y, cb, cr, qty, qtc)``, (N, bh, bw, 8, 8)
        int16 each; the quant tables (8, 8) are shared by the batch."""
        if spec.mjpeg_packed:
            idx, val, dense_ids, dense_rows, qty, qtc = x
            dense = _jpeg.unpack_block_coeffs(idx, val, dense_ids, dense_rows)
            comps, off = [], 0
            for bh, bw in spec.coeff_geometry:
                comps.append(dense[:, off:off + bh * bw].reshape(-1, bh, bw, 8, 8))
                off += bh * bw
        else:
            *comps, qty, qtc = x
        planes = [_jpeg.dequant_idct_plane(c, qt) for c, qt in zip(comps, (qty, qtc, qtc))]
        # upsampling factors from the planes' shapes
        fy = planes[0].shape[-2] // planes[1].shape[-2]
        fx = planes[0].shape[-1] // planes[1].shape[-1]
        cb, cr = (_jpeg.upsample(p, fx, fy)[..., :h, :w] for p in planes[1:])
        b, g, r = _jpeg.ycbcr_to_bgr_planes(planes[0][..., :h, :w], cb, cr)
        if spec.resize_to is not None:
            b, g, r = _resize.resize_bilinear_plane(torch.stack([b, g, r], dim=-3),
                                                     cur_w, cur_h).unbind(-3)
        return _color.interleave_bgr_planes(b, g, r, cur_w, cur_h)

    def run(raw, rects, rect_colors, thickness):
        """raw u8 [N, H*W*2] (the coefficient tuple of
        :func:`reconstruct_mjpeg` for hybrid MJPEG); rects int32 [N, 4],
        rect_colors u8 [N, 3] and an int thickness (read only with
        spec.overlay) → dict of outputs."""
        if fused_tick:
            bgr, filtered = _kernels.yuyv_tick_fused(
                raw, w, h, rects, rect_colors, thickness, overlay=spec.overlay)
            return {"bgr": bgr, "filtered": filtered, "_sync": bgr.reshape(-1)[:1]}
        overlay_done = False
        if fused_decode:
            bgr, gray = _kernels.yuyv_decode_interleave(
                raw, w, h, rects, rect_colors, thickness, overlay=spec.overlay)
            overlay_done = True
        elif hybrid:
            bgr = reconstruct_mjpeg(raw)  # resized inside, in plane form
            gray = None
        elif overlay_on_pairs:
            bgr = _color.yuyv_to_bgr_packed_overlay(raw, w, h, rects, rect_colors, thickness)
            gray = None
            overlay_done = True
        else:
            hwc = _decode.convert_on_device(raw, fmt, w, h)
            bgr = hwc.reshape(*hwc.shape[:-3], h, w * 3)  # a view: packed rows
            gray = None
        if spec.resize_to is not None and not hybrid:
            bgr = _resize.resize_bilinear_packed(bgr, w, h, cur_w, cur_h)
        decoded = bgr  # before the overlay, but xla_fused painted it already (as the reference)

        def gray_plane():
            if gray is not None:
                return gray
            if spec.resize_to is None and not hybrid and fmt in _RAW_GRAY:
                return _RAW_GRAY[fmt](raw, w, h)
            return _color.bgr_to_gray_packed_rows(decoded, cur_w, cur_h)

        if spec.filter == "gaussian":
            # Packed rows would blur across channels: blur the (H, W, 3) view.
            filtered = _filters.gaussian5_u8(bgr.reshape(*bgr.shape[:-1], cur_w, 3))
        elif spec.filter == "sobel_mag":
            filtered = _filters.gradient_magnitude_u8(*_filters.sobel3_gray(gray_plane()))
        elif spec.filter == "blur_sobel":
            if spec.stencil_impl == "xla":
                filtered = _filters.blur_sobel_mag_u8(gray_plane())
            else:
                filtered = _kernels.blur_sobel_mag(gray_plane())
        elif spec.filter == "canny":
            filtered = _filters.canny_u8(gray_plane())
        elif spec.filter == "harris":
            filtered = _features.harris_corners(gray_plane())
        else:
            filtered = None

        if spec.overlay and not overlay_done:
            bgr = _draw.rectangle_packed(bgr, rects, rect_colors, thickness)
        out = {}
        if spec.emit_bgr:
            out["bgr"] = bgr if packed_out else bgr.reshape(*bgr.shape[:-1], cur_w, 3)
        if spec.emit_filtered and filtered is not None:
            out["filtered"] = filtered
        if spec.filter == "harris_points":
            # Fixed-size top-K corners + validity per stream (no mask).
            out["corners"], out["corners_valid"] = _features.harris_corner_list(
                gray_plane(), max_corners=HARRIS_POINTS)
        if spec.encode_jpeg:
            # The encoder reads the image after the overlay.
            out.update(_encode(bgr, cur_w, spec))
        if not out:
            raise ValueError("the spec emits no output (emit_bgr=False and no filter)")
        # One-element completion token: fetching it waits for the tick. The
        # probe is the first output, as the reference picks it: bgr, else
        # filtered, else the corners or the coefficients.
        out["_sync"] = next(iter(out.values())).reshape(-1)[:1]
        return out

    return run


def _encode(bgr, w: int, spec: PipelineSpec) -> dict:
    """The encoder's numeric half on packed rows: enc_y/enc_cb/enc_cr
    coefficient rows and, with ``spec.encode_packed``, their block-packed
    form and its one-copy blob (layout: ``jpeg_encode.split_blob``)."""
    cy, ccb, ccr = _jenc.encode_coeffs(bgr.reshape(*bgr.shape[:-1], w, 3),
                                       spec.encode_jpeg, spec.encode_subsampling)
    out = {"enc_y": cy, "enc_cb": ccb, "enc_cr": ccr}
    if spec.encode_packed:
        packed = _jenc.pack_coeff_rows(torch.cat([cy, ccb, ccr], dim=-2),
                                       spec.encode_packed, spec.encode_dense_cap)
        out.update(zip(("enc_idx", "enc_val", "enc_dense_ids", "enc_dense_rows", "enc_ndense"),
                       packed))
        out["enc_blob"] = _jenc.blob_from_packed(*packed)
    return out


@lru_cache(maxsize=64)
def _cached(spec: PipelineSpec, mode: str):
    return _build(spec, mode)


def get_pipeline(spec: PipelineSpec):
    """The pipeline function for ``spec`` under the current ``RUSTCV_DECODE``
    mode (cached by both, so a changed mode never serves a stale pipeline)."""
    return _cached(spec, decode_mode())


def make_dummy_overlay(n: int, device="cuda"):
    """Placeholder overlay args for specs with overlay=False, on ``device``
    (the card unless the caller names another; raises where that is the
    card and there is none)."""
    from ..core.mat import torch_device

    device = torch_device(device)
    return (
        torch.zeros((n, 4), dtype=torch.int32, device=device),
        torch.zeros((n, 3), dtype=torch.uint8, device=device),
        0,
    )
