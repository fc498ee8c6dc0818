"""FourCC codes and pixel-format model.

Behavioral parity with the reference:
- ``rustcv-core/src/pixel_format.rs:6-162`` — ``FourCC(u32)`` newtype with named
  constants, ``PixelFormat::{Known, Unknown}``, ``is_compressed/is_bayer/bpp_estimate``.
- ``rustcv-camera/src/pixel_format.rs:22-172`` — the closed enum
  ``{Mjpeg, Yuyv, Nv12, Bgr24, Rgb24, Bgra32, Other(u32)}`` with
  ``from_fourcc/to_fourcc/fourcc_str`` round-trip semantics.

We keep one enum (:class:`PixelFormat`) covering the union of both, plus the
raw :class:`FourCC` value type so unknown formats survive round-trips exactly
as in the reference's tests (``rustcv-camera/src/pixel_format.rs:144-172``).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass


def fourcc(code: str) -> int:
    """Pack a 4-character code into a little-endian u32 (V4L2 convention)."""
    if len(code) != 4:
        raise ValueError(f"FourCC must be 4 chars, got {code!r}")
    b = code.encode("ascii")
    return b[0] | (b[1] << 8) | (b[2] << 16) | (b[3] << 24)


@dataclass(frozen=True)
class FourCC:
    """A four-character pixel-format code (reference: ``FourCC(u32)`` newtype)."""

    value: int

    @classmethod
    def from_str(cls, code: str) -> "FourCC":
        return cls(fourcc(code))

    def __str__(self) -> str:
        chars = []
        for shift in (0, 8, 16, 24):
            c = (self.value >> shift) & 0xFF
            chars.append(chr(c) if 32 <= c < 127 else "?")
        return "".join(chars)

    def __repr__(self) -> str:
        return f"FourCC({str(self)!r})"


# Named constants mirroring rustcv-core/src/pixel_format.rs:36-79.
YUYV = FourCC.from_str("YUYV")
UYVY = FourCC.from_str("UYVY")
NV12 = FourCC.from_str("NV12")
YV12 = FourCC.from_str("YV12")
BGR3 = FourCC.from_str("BGR3")
RGB3 = FourCC.from_str("RGB3")
RGBA = FourCC.from_str("RGBA")
BGRA = FourCC.from_str("BGRA")
MJPG = FourCC.from_str("MJPG")
H264 = FourCC.from_str("H264")
BA81 = FourCC.from_str("BA81")  # Bayer BGGR
GBRG = FourCC.from_str("GBRG")
GRBG = FourCC.from_str("GRBG")
RGGB = FourCC.from_str("RGGB")
Z16 = FourCC.from_str("Z16 ")  # depth


class PixelFormat(enum.Enum):
    """Pixel formats the pipeline understands.

    Union of the reference's closed enum (``rustcv-camera``) and the
    well-known FourCC set (``rustcv-core``). ``OTHER`` carries an arbitrary
    FourCC for unknown-format preservation.
    """

    MJPEG = "MJPEG"
    YUYV = "YUYV"
    UYVY = "UYVY"
    NV12 = "NV12"
    YV12 = "YV12"
    BGR24 = "BGR24"
    RGB24 = "RGB24"
    BGRA32 = "BGRA32"
    RGBA32 = "RGBA32"
    GRAY8 = "GRAY8"
    BAYER_BGGR = "BAYER_BGGR"
    BAYER_GBRG = "BAYER_GBRG"
    BAYER_GRBG = "BAYER_GRBG"
    BAYER_RGGB = "BAYER_RGGB"
    DEPTH16 = "DEPTH16"
    H264 = "H264"
    OTHER = "OTHER"

    # ---- classification (rustcv-core/src/pixel_format.rs:90-127) ----

    @property
    def is_compressed(self) -> bool:
        return self in (PixelFormat.MJPEG, PixelFormat.H264)

    @property
    def is_bayer(self) -> bool:
        return self in (
            PixelFormat.BAYER_BGGR,
            PixelFormat.BAYER_GBRG,
            PixelFormat.BAYER_GRBG,
            PixelFormat.BAYER_RGGB,
        )

    def bpp_estimate(self) -> float:
        """Bytes-per-pixel estimate (compressed formats: conservative bound).

        Mirrors the intent of ``bpp_estimate`` in
        ``rustcv-core/src/pixel_format.rs:109-127``.
        """
        return {
            PixelFormat.MJPEG: 0.5,
            PixelFormat.H264: 0.25,
            PixelFormat.YUYV: 2.0,
            PixelFormat.UYVY: 2.0,
            PixelFormat.NV12: 1.5,
            PixelFormat.YV12: 1.5,
            PixelFormat.BGR24: 3.0,
            PixelFormat.RGB24: 3.0,
            PixelFormat.BGRA32: 4.0,
            PixelFormat.RGBA32: 4.0,
            PixelFormat.GRAY8: 1.0,
            PixelFormat.BAYER_BGGR: 1.0,
            PixelFormat.BAYER_GBRG: 1.0,
            PixelFormat.BAYER_GRBG: 1.0,
            PixelFormat.BAYER_RGGB: 1.0,
            PixelFormat.DEPTH16: 2.0,
            PixelFormat.OTHER: 2.0,
        }[self]

    def buffer_size(self, width: int, height: int) -> int:
        """Exact raw buffer size in bytes for uncompressed formats."""
        if self in (PixelFormat.YUYV, PixelFormat.UYVY, PixelFormat.DEPTH16):
            return width * height * 2
        if self in (PixelFormat.NV12, PixelFormat.YV12):
            return width * height * 3 // 2
        if self in (PixelFormat.BGR24, PixelFormat.RGB24):
            return width * height * 3
        if self in (PixelFormat.BGRA32, PixelFormat.RGBA32):
            return width * height * 4
        if self == PixelFormat.GRAY8 or self.is_bayer:
            return width * height
        raise ValueError(f"{self} has no fixed buffer size")


_FMT_TO_FOURCC = {
    PixelFormat.MJPEG: MJPG,
    PixelFormat.YUYV: YUYV,
    PixelFormat.UYVY: UYVY,
    PixelFormat.NV12: NV12,
    PixelFormat.YV12: YV12,
    PixelFormat.BGR24: BGR3,
    PixelFormat.RGB24: RGB3,
    PixelFormat.BGRA32: BGRA,
    PixelFormat.RGBA32: RGBA,
    PixelFormat.BAYER_BGGR: BA81,
    PixelFormat.BAYER_GBRG: GBRG,
    PixelFormat.BAYER_GRBG: GRBG,
    PixelFormat.BAYER_RGGB: RGGB,
    PixelFormat.DEPTH16: Z16,
    PixelFormat.H264: H264,
}
_FOURCC_TO_FMT = {fcc.value: fmt for fmt, fcc in _FMT_TO_FOURCC.items()}
# GRAY8 maps out as V4L2's 'GREY' (to_fourcc below); accept it and the
# common 'Y800' alias back, preserving from_fourcc(to_fourcc(f))[0] == f.
_FOURCC_TO_FMT[FourCC.from_str("GREY").value] = PixelFormat.GRAY8
_FOURCC_TO_FMT[FourCC.from_str("Y800").value] = PixelFormat.GRAY8


def from_fourcc(fcc: "FourCC | int | str"):
    """FourCC → (PixelFormat, FourCC). Unknown codes map to OTHER but keep the
    raw code (round-trip preservation, ``rustcv-camera/src/pixel_format.rs:96-136``)."""
    if isinstance(fcc, str):
        fcc = FourCC.from_str(fcc)
    elif isinstance(fcc, int):
        fcc = FourCC(fcc)
    fmt = _FOURCC_TO_FMT.get(fcc.value, PixelFormat.OTHER)
    return fmt, fcc


def to_fourcc(fmt: PixelFormat, other: "FourCC | None" = None) -> FourCC:
    if fmt == PixelFormat.OTHER:
        if other is None:
            raise ValueError("OTHER format requires its original FourCC")
        return other
    if fmt == PixelFormat.GRAY8:
        return FourCC.from_str("GREY")
    return _FMT_TO_FOURCC[fmt]
