"""Frame decode dispatch: raw pixel formats → BGR (port of
``rustcv_tpu.ops.decode``; ``rustcv-camera/src/decode.rs:36-86``).

:func:`convert_on_device` dispatches on the wire format to the converters
of :mod:`.color`, returning the (..., H, W, 3) BGR image on the input's
device; the engine's pipeline decodes every uncompressed format with it.

- :func:`decode_frame_host` decodes a Frame into a host Mat: the same
  converters on a CPU tensor over the frame's bytes, written through the
  Mat's (stride-aware) buffer. The reference runs its numpy oracles
  (``golden``) there; the bytes are the same.
- :func:`decode_to_device` decodes a Frame to a (H, W, 3) u8 tensor on a
  device: the raw bytes are uploaded and converted there. MJPEG takes the
  hybrid decode (:mod:`.jpeg_tpu`) with ``mjpeg_hybrid=True``, else the
  full host decode, uploaded.

The full host decode of MJPEG (:func:`decode_mjpeg_host`, and
:func:`decode_mjpeg_host_rgb` in RGB order) is the port's C++ decoder
(:func:`..native.jpeg_decode_bgr`): libjpeg-turbo's default decode, which
the reference gets from Pillow, with no libjpeg. It writes BGR rows
straight into the destination, at its stride. :func:`decode_mjpeg_into_mat`
and the engine's host staging size a frame with :func:`mjpeg_size`, which
refuses a four-component one as the reference's libjpeg BGR binding does.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ..core.errors import DecodeError
from ..core.pixel_format import PixelFormat
from . import color


def decode_mjpeg_host(data, out=None) -> np.ndarray:
    """MJPEG → (H, W, 3) BGR u8 on the host, into ``out`` when given (an
    (H, W, 3) array whose rows may be strided, e.g. a Mat's ``array``).
    A corrupt frame raises DecodeError."""
    from .. import native

    try:
        return native.jpeg_decode_bgr(data, out=out)
    except ValueError as e:
        raise DecodeError(f"JPEG decompress: {e}") from e


def decode_mjpeg_host_rgb(data) -> np.ndarray:
    """MJPEG → (H, W, 3) RGB u8 on the host: the host decode's channels
    swapped, what the reference gets from Pillow's ``convert("RGB")``. A
    corrupt frame raises DecodeError."""
    return np.ascontiguousarray(decode_mjpeg_host(data)[..., ::-1])


def mjpeg_size(data) -> tuple:
    """(width, height) from the header of an MJPEG frame that libjpeg
    decodes to BGR; a corrupt header raises DecodeError, and so does a
    four-component (CMYK or YCCK) frame: the reference's pitched decode
    (its libjpeg-turbo binding, asked for BGR) has no BGR output of one."""
    from .. import native

    try:
        w, h, nc = native.jpeg_header(data)
    except ValueError as e:
        raise DecodeError(f"JPEG decompress: {e}") from e
    if nc == 4:
        raise DecodeError("JPEG decompress: no BGR output of a four-component "
                          "(CMYK or YCCK) JPEG")
    return w, h


def decode_mjpeg_into_mat(data, mat) -> None:
    """MJPEG → BGR decoded straight into the Mat's (stride-aware) host
    buffer, the Mat sized from the JPEG header (:func:`mjpeg_size`: a
    CMYK or YCCK frame raises DecodeError, as in the reference's libjpeg
    binding). Where that binding's libjpeg-turbo 2.1 differs from Pillow's
    3.1 (lossless frames, some smoothed progressive ones), the port reads
    as Pillow does (the port map's DEVIATIONS)."""
    w, h = mjpeg_size(data)
    mat.ensure_size(h, w, 3)
    decode_mjpeg_host(data, out=mat.array)


def _raw_tensor(frame) -> torch.Tensor:
    """The frame's bytes as a flat u8 CPU tensor, without a copy where they
    are contiguous. Ring slots are read-only views; nothing writes to them."""
    flat = np.ascontiguousarray(frame.data).reshape(-1)
    fmt = frame.pixel_format
    if fmt in (PixelFormat.BGR24, PixelFormat.GRAY8) or fmt.is_bayer:
        flat = flat[: fmt.buffer_size(frame.width, frame.height)]
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "The given NumPy array is not writable")
        return torch.from_numpy(flat)


def _check_bottom_up(frame) -> bool:
    """Whether the frame is bottom-up; raises where the format's rows are not
    local (planar 4:2:0 and the Bayer mosaic), as the reference does."""
    fmt = frame.pixel_format
    if not getattr(frame, "bottom_up", False):
        return False
    if fmt in (PixelFormat.NV12, PixelFormat.YV12) or fmt.is_bayer:
        raise DecodeError(f"bottom-up layout unsupported for planar/CFA format {fmt}")
    return True


def convert_on_device(raw: torch.Tensor, fmt: PixelFormat, width: int,
                      height: int) -> torch.Tensor:
    """Raw u8 bytes, flat last axis (optionally batched) → BGR u8 (..., H,
    W, 3) on raw's device, for every uncompressed format."""
    if fmt == PixelFormat.YUYV:
        return color.yuyv_to_bgr(raw, width, height)
    if fmt == PixelFormat.UYVY:
        return color.uyvy_to_bgr(raw, width, height)
    if fmt == PixelFormat.NV12:
        return color.nv12_to_bgr(raw, width, height)
    if fmt == PixelFormat.YV12:
        return color.yv12_to_bgr(raw, width, height)
    if fmt == PixelFormat.BGRA32:
        return color.bgra_to_bgr(raw, width, height)
    if fmt == PixelFormat.RGBA32:
        return color.rgba_to_bgr(raw, width, height)
    if fmt == PixelFormat.RGB24:
        return color.rgb_to_bgr(raw, width, height)
    if fmt == PixelFormat.BGR24:
        return raw.reshape(*raw.shape[:-1], height, width, 3)
    if fmt == PixelFormat.GRAY8:
        g = raw.reshape(*raw.shape[:-1], height, width)
        return g[..., None].expand(*g.shape, 3).contiguous()
    if fmt.is_bayer:
        return color.demosaic_bilinear(raw, fmt.value.split("_")[1], width, height)
    raise DecodeError(f"unsupported device format: {fmt}")


def decode_frame_host(frame, mat) -> None:
    """Decode a Frame into a host Mat (reference decode.rs:36-86 semantics)."""
    w, h = frame.width, frame.height
    fmt = frame.pixel_format
    if fmt == PixelFormat.MJPEG:
        decode_mjpeg_into_mat(frame.data, mat)
        return
    flip = _check_bottom_up(frame)
    bgr = convert_on_device(_raw_tensor(frame), fmt, w, h)
    mat.ensure_size(h, w, 3)
    # Negative-pitch sources deliver rows bottom-to-top
    # (rustcv-backend-msmf/src/stream.rs:317-410): row-local decodes
    # commute with the flip, so flipping the decoded image is exact.
    torch.from_numpy(mat.array).copy_(bgr.flip(0) if flip else bgr)


def decode_to_device(frame, device="cuda", mjpeg_hybrid: bool = False) -> torch.Tensor:
    """Decode one Frame to a (H, W, 3) u8 BGR tensor on ``device``.

    ``mjpeg_hybrid=True`` decodes MJPEG by the coefficient-level path: the
    C++ entropy decode on the host, dequantization, IDCT, upsampling and
    colour on ``device`` (:mod:`.jpeg_tpu`); otherwise MJPEG is decoded on
    the host and uploaded, as in the reference."""
    from ..core.mat import torch_device

    dev = torch_device(device)
    fmt = frame.pixel_format
    if fmt == PixelFormat.MJPEG:
        if mjpeg_hybrid:
            from . import jpeg_tpu

            return jpeg_tpu.decode_jpeg_tpu(frame.data, dev)
        return torch.from_numpy(decode_mjpeg_host(frame.data)).to(dev)
    flip = _check_bottom_up(frame)
    out = convert_on_device(_raw_tensor(frame).to(dev), fmt, frame.width, frame.height)
    return out.flip(-3) if flip else out
