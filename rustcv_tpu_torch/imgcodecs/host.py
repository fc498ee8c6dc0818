"""Host image codecs without Pillow: PNG, BMP and PNM (PBM, PGM, PPM,
PFM) here, TIFF, GIF and WebP in :mod:`.tiff`, :mod:`.gif` and
:mod:`.webp`, for the
``"host"`` backend of :mod:`rustcv_tpu_torch.imgcodecs` and the highgui
PNG dump.

A read gives what the reference gets from Pillow 12's ``Image.open(...)
.convert("RGB")``, byte for byte, as a numpy array in the file's channel
order: (H, W) gray, (H, W, 3) RGB or (H, W, 4) RGBA, already in 8 bits;
the facade turns it into a BGR Mat (gray repeated, alpha dropped).
Pillow's ``info`` for the file (the metadata the reference reports) comes
from :func:`.apng.png_info`, :func:`bmp_info` and :func:`pnm_info`.

* PNG: every bit depth and colour type the format allows, plain or Adam7
  interlaced, every filter type (``native.png_unfilter``, per pass), chunk
  CRCs checked before the image data as Pillow checks them. Pillow's
  conversions: 1-, 2- and 4-bit gray scale by 255 / (2^d - 1); 16-bit gray
  is Pillow's ``I;16`` and clips at 255; 16-bit RGB, RGBA and gray+alpha
  keep the high byte; palette indices past the PLTE are black. Writes
  what Pillow's ``save`` writes of every mode ``Image.fromarray`` makes
  but ``F`` (:func:`pillow_image`: ``1``, ``L``, ``LA``, ``I;16``, ``I``
  clipped to 16 bits, ``RGB``, ``RGBA``), its rows filtered as Pillow
  chooses on the image's device (:mod:`.png_filter`), deflated at Pillow's
  zlib settings and cut into its IDAT chunks, text as ``tEXt`` (or
  ``iTXt`` when it is not Latin-1).
* BMP: the OS/2 12-byte core header (3-byte palette entries) and the 40,
  52, 56, 64, 108 and 124-byte headers; 1-, 4- and 8-bit palettes (gray
  palettes as Pillow's ``1`` and ``L`` modes), 16-bit 5-5-5, 24 and 32-bit,
  the bit-field layouts Pillow accepts (16-bit 5-6-5 and 5-5-5, 24-bit,
  eight 32-bit ones), RLE8 and RLE4 as Pillow's decoder reads them
  (absolute runs, end of line, delta, end of bitmap); bottom-up or
  top-down. Writes 8-bit gray (a gray palette), 24-bit and 32-bit, as
  Pillow writes them.
* PNM: ``P1``-``P3`` (ASCII) and ``P4``-``P6`` (binary), comments in the
  header and in ASCII samples as Pillow takes them, every maxval 1-65535
  with Pillow's split: gray above 255 is its ``I`` mode and clips, colour
  scales; a sample above maxval in an ASCII file raises. PFM ``Pf`` (gray
  float32, rows bottom-up, little-endian for a negative scale), clipped
  and truncated to 0-255 as Pillow converts ``F``. Writes binary ``P5`` and
  ``P6``.

An animated PNG's chunks are kept, with acTL's frame count and ``loop``,
for :mod:`.apng`, which reads its fcTL and its frames (a read gives frame
0). What Pillow refuses raises :class:`CodecError`
(the facade's ``CameraError``); Pillow's own PNM extensions raise
``not_ported``.
"""

from __future__ import annotations

import io
import math
import re
import struct
import zlib
from typing import Dict, Optional, Tuple

import numpy as np

from ..core.errors import not_ported

LEFTOVERS = "8"  # the ROADMAP Queue 1 item of what stays not ported
_PNG_SIG = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> channels, and the bit depths the format allows for it
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))  # (x0, y0, dx, dy) of each pass
_TEXT_LIMIT = 1 << 20  # Pillow's MAX_TEXT_CHUNK: the largest inflated text chunk
_CHUNK_TYPE = re.compile(rb"\w\w\w\w")


class CodecError(ValueError):
    """A corrupt or truncated file, or one Pillow refuses."""


TIFF_PREFIXES = (b"MM\x00\x2a", b"II\x2a\x00", b"MM\x2a\x00", b"II\x00\x2a", b"MM\x00\x2b",
                 b"II\x2b\x00")  # Pillow's TIFF prefixes


def sniff(data: bytes) -> str:
    """The format of encoded image bytes: "png", "bmp", "pnm", "jpeg",
    "tiff", "gif", "webp", or raises CodecError for an unknown one."""
    head = bytes(data[:12])
    if head.startswith(_PNG_SIG):
        return "png"
    if head.startswith(b"BM"):
        return "bmp"
    if head[:1] == b"P" and head[1:2] and head[1] in b"0123456fy":  # Pillow's PPM test
        return "pnm"
    if head.startswith(b"\xff\xd8"):
        return "jpeg"
    if head.startswith(TIFF_PREFIXES):
        return "tiff"
    if head.startswith((b"GIF87a", b"GIF89a")):
        return "gif"
    if head[:4] == b"RIFF" and head[8:12] == b"WEBP":
        return "webp"
    raise CodecError("unknown image format")


# -- PNG ----------------------------------------------------------------------


def _chunks(data: bytes):
    """(type, body, before the first IDAT) of each chunk up to IEND."""
    if not data.startswith(_PNG_SIG):
        raise CodecError("not a PNG file")
    p, before = len(_PNG_SIG), True
    while p + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[p:p + 8])
        if not _CHUNK_TYPE.match(kind):
            raise CodecError(f"broken PNG file (chunk {kind!r})")
        body = data[p + 8:p + 8 + n]
        crc = data[p + 8 + n:p + 12 + n]
        if len(body) != n or len(crc) != 4:
            raise CodecError("truncated PNG chunk")
        if kind in (b"IDAT", b"fdAT"):  # the image data: Image.open reads up to it
            before = False
        # Pillow checks the CRCs of the chunks it reads before the image data
        if before and zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise CodecError(f"bad CRC in PNG chunk {kind!r}")
        yield kind, body, before
        if kind == b"IEND":
            return
        p += 12 + n
    raise CodecError("PNG without IEND")


def _inflate_text(blob: bytes) -> bytes:
    d = zlib.decompressobj()
    out = d.decompress(blob, _TEXT_LIMIT)
    if d.unconsumed_tail:
        raise CodecError("decompressed PNG text chunk too large")
    return out


def _text_chunk(kind: bytes, body: bytes, info: dict) -> None:
    """A tEXt, zTXt or iTXt chunk into ``info`` as Pillow's PNG reader puts
    it there (iTXt's XMP also as bytes under ``"xmp"``)."""
    if kind == b"iTXt":
        key, sep, r = body.partition(b"\x00")
        if not sep or len(r) < 2:
            return
        flag, method, r = r[0], r[1], r[2:]
        parts = r.split(b"\x00", 2)
        if len(parts) < 3:
            return
        lang, tkey, value = parts
        if flag:
            if method:
                return
            try:
                value = _inflate_text(value)
            except zlib.error:
                return
        if key == b"XML:com.adobe.xmp":
            info["xmp"] = value
        try:
            k, _l, _t, v = (key.decode("latin-1"), lang.decode("utf-8"), tkey.decode("utf-8"),
                            value.decode("utf-8"))
        except UnicodeError:
            return
        info[k] = v
        return
    key, _, value = body.partition(b"\x00")
    if kind == b"zTXt":
        if value and value[0] != 0:
            raise CodecError(f"unknown compression method {value[0]} in zTXt chunk")
        try:
            value = _inflate_text(value[1:])
        except zlib.error:
            value = b""
    if key:
        text = value.decode("latin-1", "replace")
        info[key.decode("latin-1")] = value if kind == b"tEXt" and key == b"exif" else text


class _Png:
    """One parse of a PNG: header, palette, transparency, image data, and
    Pillow's ``info`` before the image data (``info``, what ``Image.open``
    gives) and after it (``late``, what ``load()`` adds)."""

    def __init__(self, data: bytes):
        try:
            self._parse(bytes(data))
        except (struct.error, IndexError) as e:  # a chunk too short for its fields
            raise CodecError(f"broken PNG chunk: {e}") from e

    def _parse(self, data: bytes) -> None:
        self.header = self.palette = None
        self.idat, self.info, self.late = [], {}, {}
        # for animated PNG (:mod:`.apng`): every chunk, where the image data
        # starts, acTL's frame count, whether an fcTL came before the data
        self.chunks, self.first_data, self.n_frames = [], None, None
        self.apng = framed = loaded = False  # loaded: load() stops at the next frame's fcTL
        i16, i32 = (lambda b: struct.unpack(">H", b[:2])[0]), (lambda b: struct.unpack(">I", b[:4])[0])
        for kind, body, before in _chunks(data):
            self.chunks.append((kind, body))
            if kind in (b"IDAT", b"fdAT") and self.first_data is None:
                self.first_data = len(self.chunks) - 1
                if not framed and self.n_frames is not None:
                    self.info["default_image"] = True
            if loaded:
                continue
            info = self.info if before else self.late
            if kind == b"IHDR":
                if len(body) < 13:
                    raise CodecError("truncated IHDR chunk")
                self.header = struct.unpack(">IIBBBBB", body[:13])
                if body[12]:
                    info["interlace"] = 1
                if body[11]:
                    raise CodecError("unknown filter category")
            elif kind == b"IDAT":
                self.idat.append(body)
            elif kind in (b"acTL", b"fcTL", b"fdAT"):
                self.apng = True
                if before:
                    framed = framed or kind == b"fcTL"
                    if kind == b"acTL":
                        self._actl(body)
                elif kind == b"fcTL" and self.frame_count() > 1:
                    loaded = True
            elif self.header is None or kind == b"IEND":
                continue
            elif kind == b"PLTE":
                if before and self.header[3] == 3:
                    self.palette = body
            elif kind == b"tRNS":
                depth, ctype = self.header[2:4]
                if ctype == 3:
                    if re.match(rb"^\xff*\x00\xff*$", body):
                        if body.find(b"\x00") >= 0:
                            info["transparency"] = body.find(b"\x00")
                    else:
                        info["transparency"] = body
                elif ctype == 0:
                    info["transparency"] = (255 if i16(body) else 0) if depth == 1 else i16(body)
                elif ctype == 2:
                    info["transparency"] = (i16(body), i16(body[2:]), i16(body[4:]))
            elif kind == b"gAMA":
                info["gamma"] = i32(body) / 100000.0
            elif kind == b"sRGB":
                if not body:
                    raise CodecError("truncated sRGB chunk")
                info["srgb"] = body[0]
            elif kind == b"cHRM":
                info["chromaticity"] = tuple(v / 100000.0 for v in
                                             struct.unpack(f">{len(body) // 4}I", body[:len(body) // 4 * 4]))
            elif kind == b"pHYs":
                if len(body) < 9:
                    raise CodecError("truncated pHYs chunk")
                px, py = struct.unpack(">II", body[:8])
                if body[8] == 1:
                    info["dpi"] = (px * 0.0254, py * 0.0254)
                elif body[8] == 0:
                    info["aspect"] = (px, py)
            elif kind == b"iCCP":
                i = body.find(b"\x00")
                if i + 1 >= len(body) or body[i + 1] != 0:
                    raise CodecError("unknown compression method in iCCP chunk")
                info["icc_profile"] = body[i + 2:]  # bytes: left out of the metadata either way
            elif kind in (b"tEXt", b"zTXt", b"iTXt"):
                _text_chunk(kind, body, info)
            elif kind == b"eXIf":
                info["exif"] = b"Exif\x00\x00" + body
        if self.header is None:
            raise CodecError("PNG without IHDR")
        w, h, depth, ctype = self.header[:4]
        if ctype not in _PNG_DEPTHS or depth not in _PNG_DEPTHS[ctype] or w == 0 or h == 0:
            raise CodecError(f"bad PNG header: {w}x{h}, {depth}-bit colour type {ctype}")
        if self.first_data is None:
            raise CodecError("PNG without image data")

    def _actl(self, body: bytes) -> None:
        """An acTL before the image data, as Pillow's ``chunk_acTL`` reads
        it: the frame count, and ``loop`` into ``info``."""
        if len(body) < 8:
            raise CodecError("APNG contains truncated acTL chunk")
        n = struct.unpack(">I", body[:4])[0]
        if self.n_frames is not None:  # a second acTL: Pillow falls back to the default image
            self.n_frames = None
        elif 0 < n <= 0x80000000:
            self.n_frames = n
            self.info["loop"] = struct.unpack(">I", body[4:8])[0]

    def frame_count(self) -> int:
        """Pillow's ``n_frames``: acTL's count (1 without a valid one), one
        more where the image data is a default image outside the animation."""
        return (self.n_frames or 1) + (1 if self.info.get("default_image") else 0)

    def samples(self) -> np.ndarray:
        """The samples, (H, W, channels), u8 or u16 (16-bit)."""
        w, h, depth, ctype, _comp, _filt, interlace = self.header
        return png_samples(self.idat, w, h, depth, ctype, interlace)

    def rgb(self) -> np.ndarray:
        """What Pillow's ``convert("RGB")`` reads of a still PNG: (H, W) gray
        or (H, W, 3) RGB, u8 (an animated PNG's frames are :mod:`.apng`'s)."""
        if self.apng:
            raise CodecError("an animated PNG: its frames are read by imgcodecs.apng")
        return self.convert_rgb(self.storage(self.samples()))

    def storage(self, px: np.ndarray) -> np.ndarray:
        """Samples → Pillow's storage of the file's mode, (H, W, C): palette
        indices, gray scaled to 8 bits (16-bit gray stays u16, Pillow's
        I;16), 16-bit colour and alpha by their high byte."""
        depth, ctype = self.header[2:4]
        if ctype == 3:
            return px
        if depth == 16:
            return px if ctype == 0 else (px >> 8).astype(np.uint8)
        if depth < 8:
            return (px * (255 // ((1 << depth) - 1))).astype(np.uint8)
        return px

    def convert_rgb(self, px: np.ndarray) -> np.ndarray:
        """Pillow's storage of the mode (:meth:`storage`, or an APNG's
        composite) → ``convert("RGB")``'s (H, W) gray or (H, W, 3) RGB, u8."""
        depth, ctype = self.header[2:4]
        if ctype == 3:
            pal = np.zeros((256, 3), np.uint8)  # Pillow's: past the PLTE is black
            if self.palette is None:
                raise CodecError("palette PNG without PLTE")
            n = min(256, len(self.palette) // 3)
            pal[:n] = np.frombuffer(self.palette, np.uint8, n * 3).reshape(n, 3)
            return pal[px[..., 0]]
        if depth == 16 and ctype == 0:  # Pillow's I;16: convert("RGB") clips
            return np.minimum(px[..., 0], 255).astype(np.uint8)
        if ctype in (0, 4):
            return px[..., 0]
        return px[..., :3]


def png_samples(idat, w: int, h: int, depth: int, ctype: int, interlace: int) -> np.ndarray:
    """The samples of a (w, h) image in the zlib stream of the ``idat``
    chunk bodies, (h, w, channels), u8 or u16 (16-bit): unfiltered, and
    Adam7 passes put in place."""
    from .. import native

    ch = _PNG_CHANNELS[ctype]
    try:
        raw = zlib.decompressobj().decompress(b"".join(idat))
    except zlib.error as e:
        raise CodecError(f"corrupt PNG image data: {e}") from e
    bpp = max(1, depth * ch // 8)
    if not interlace:
        return _png_rows(native.png_unfilter(raw, h, (w * ch * depth + 7) // 8, bpp), w, ch,
                         depth)
    out = np.zeros((h, w, ch), np.uint16 if depth == 16 else np.uint8)
    p = 0
    for x0, y0, dx, dy in _ADAM7:
        pw, ph = -(-(w - x0) // dx) if w > x0 else 0, -(-(h - y0) // dy) if h > y0 else 0
        if pw == 0 or ph == 0:
            continue
        rb = (pw * ch * depth + 7) // 8
        need = ph * (rb + 1)
        if p + need > len(raw):
            raise CodecError("corrupt PNG image data")
        rows = native.png_unfilter(raw[p:p + need], ph, rb, bpp)
        out[y0::dy, x0::dx] = _png_rows(rows, pw, ch, depth)
        p += need
    return out


def _png_rows(rows: np.ndarray, w: int, ch: int, depth: int) -> np.ndarray:
    """Unfiltered rows (n, row bytes) → samples (n, w, ch)."""
    n = rows.shape[0]
    if depth == 8:
        return rows[:, :w * ch].reshape(n, w, ch)
    if depth == 16:
        return rows[:, :2 * w * ch].copy().view(">u2").astype(np.uint16).reshape(n, w, ch)
    per = 8 // depth
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    vals = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return vals.reshape(n, rows.shape[1] * per)[:, :w].reshape(n, w, 1)


def read_png(data: bytes) -> Tuple[np.ndarray, Dict[str, str]]:
    """Still PNG bytes → (what Pillow reads in 8 bits: (H, W) gray or
    (H, W, 3) RGB, the text chunks before the image data)."""
    png = _Png(data)
    return png.rgb(), {k: v for k, v in png.info.items() if isinstance(v, str)}


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


# Image.fromarray's modes (its _fromarray_typemap, in the machine's byte
# order): (shape past (H, W), numpy type string) → mode
_FROMARRAY = {((1, 1), "|b1"): "1", ((1, 1), "|u1"): "L", ((1, 1), "|i1"): "I",
              ((1, 1), "<u2"): "I;16", ((1, 1), "<i2"): "I", ((1, 1), "<u4"): "I",
              ((1, 1), "<i4"): "I", ((1, 1), "<f4"): "F", ((1, 1), "<f8"): "F",
              ((1, 1, 2), "|u1"): "LA", ((1, 1, 3), "|u1"): "RGB", ((1, 1, 4), "|u1"): "RGBA"}
_TORCH_TYPESTR = {"bool": "|b1", "uint8": "|u1", "int8": "|i1", "uint16": "<u2", "int16": "<i2",
                  "uint32": "<u4", "int32": "<i4", "int64": "<i8", "float16": "<f2",
                  "float32": "<f4", "float64": "<f8"}
# Pillow's PNG _OUTMODES: mode → (bit depth, colour type); I is written as I;16, clipped
PNG_MODES = {"1": (1, 0), "L": (8, 0), "LA": (8, 4), "I;16": (16, 0), "I": (16, 0),
             "RGB": (8, 2), "RGBA": (8, 6)}
_MAXBLOCK = 65536  # Pillow's ImageFile.MAXBLOCK: the least block its encoder writes at once


def pillow_mode(a) -> str:
    """The mode of ``Image.fromarray(a)`` (numpy, or a tensor as numpy would
    hold it): ``1`` (bool), ``L``, ``LA``, ``RGB``, ``RGBA`` (u8 with 2, 3, 4
    channels), ``I;16`` (u16), ``I`` (i8, i16, u32, i32), ``F`` (f32, f64);
    Pillow's TypeError for any other dtype or shape."""
    import torch

    if isinstance(a, torch.Tensor):
        typestr = _TORCH_TYPESTR.get(str(a.dtype).rpartition(".")[2], str(a.dtype))
    else:
        a = np.asarray(a)
        typestr = a.dtype.str.replace(">", "<")
    key = ((1, 1) + tuple(a.shape[2:]), typestr)
    mode = _FROMARRAY.get(key) if a.ndim in (2, 3) else None
    if mode is None:
        raise TypeError(f"Cannot handle this data type: {key[0]}, {key[1]}")
    return mode


def pillow_image(a):
    """(mode, pixels) of ``Image.fromarray(a)``: pixels a tensor on ``a``'s
    device (numpy on the CPU), bool for ``1``, u8 for ``L``, ``LA``,
    ``RGB`` and ``RGBA``, int32 for ``I;16`` and ``I`` (i8 read as its
    bytes, u32 as int32, as Pillow's raw modes read them), float32 for
    ``F``."""
    import torch

    mode = pillow_mode(a)
    if not isinstance(a, torch.Tensor):
        a = np.asarray(a)
        a = a.astype(a.dtype.newbyteorder("="), copy=False)
        kind = a.dtype.str[1:]
        a = torch.from_numpy(np.ascontiguousarray(
            a.astype(np.int32) if kind == "u2" else a.view(np.int32) if kind == "u4" else a))
    elif a.dtype == torch.uint32:
        a = a.view(torch.int32)
    elif a.dtype == torch.uint16:  # through int16: unsigned 16-bit tensors have few kernels
        a = a.view(torch.int16).to(torch.int32) & 0xFFFF
    if a.dtype == torch.int8:
        a = a.view(torch.uint8)
    if mode in ("I", "I;16"):
        a = a.to(torch.int32)
    elif mode == "F":
        a = a.to(torch.float32)
    return mode, a


def deflate(raw: bytes) -> bytes:
    """zlib of PNG image data with Pillow's settings (``ZipEncode.c``: level
    6, its default ``compress_level``; memory level 9; ``Z_FILTERED``)."""
    z = zlib.compressobj(6, zlib.DEFLATED, 15, 9, zlib.Z_FILTERED)
    return z.compress(raw) + z.flush()


def png_blocks(px, mode: str) -> list:
    """The image data of ``px`` (a ``mode`` image, :func:`pillow_image`'s
    pixels) as Pillow's encoder writes it: the rows filtered as Pillow
    chooses (:func:`.png_filter.filter_rows`, on ``px``'s device), deflated
    with its zlib settings, cut into the blocks it writes at once
    (``max(MAXBLOCK, 4 * width)`` bytes), each an IDAT or fdAT body."""
    from .png_filter import filter_rows

    if mode == "I":  # Pillow's I → I;16B packer clips
        px = px.clamp(0, 65535)
    data = deflate(filter_rows(px, PNG_MODES[mode][0]).cpu().numpy().tobytes())
    size = max(_MAXBLOCK, 4 * int(px.shape[1]))
    return [data[i:i + size] for i in range(0, len(data), size)] or [b""]


def png_file(mode: str, px, text: Optional[Dict[str, str]] = None, size=None) -> bytes:
    """A still PNG of ``px`` in ``mode``, as Pillow's ``save`` writes it:
    IHDR (of ``size``, (w, h), where given: an animation's canvas), the
    text chunks, the IDAT chunks, IEND. A mode PNG has no writer for
    (``F``) raises Pillow's OSError."""
    if mode not in PNG_MODES:
        raise OSError(f"cannot write mode {mode} as PNG")
    depth, ctype = PNG_MODES[mode]
    w, h = size or (int(px.shape[1]), int(px.shape[0]))
    out = [_PNG_SIG, _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0))]
    for key, value in (text or {}).items():
        key, value = str(key), str(value)
        try:
            out.append(_chunk(b"tEXt", key.encode("latin-1") + b"\x00" + value.encode("latin-1")))
        except UnicodeEncodeError:
            out.append(_chunk(b"iTXt", key.encode("latin-1") + b"\x00\x00\x00\x00\x00"
                              + value.encode("utf-8")))
    out += [_chunk(b"IDAT", b) for b in png_blocks(px, mode)]
    out.append(_chunk(b"IEND", b""))
    return b"".join(out)


def write_png(img, text: Optional[Dict[str, str]] = None) -> bytes:
    """An image as the reference hands it to Pillow (numpy, or a tensor
    filtered on its device) → PNG bytes, as ``Image.fromarray(img).save``
    writes them: every mode of :func:`pillow_image` but ``F`` (OSError);
    what ``fromarray`` refuses raises its TypeError."""
    return png_file(*pillow_image(img), text)


# -- BMP ----------------------------------------------------------------------

# Bit-field masks Pillow accepts → the byte of each of R, G, B in a pixel
# (32 and 24-bit), or its 16-bit layout.
_BMP_FIELDS32 = {
    (0xFF0000, 0xFF00, 0xFF, 0x0): (2, 1, 0), (0xFF000000, 0xFF0000, 0xFF00, 0x0): (3, 2, 1),
    (0xFF000000, 0xFF00, 0xFF, 0x0): (3, 1, 0), (0xFF000000, 0xFF0000, 0xFF00, 0xFF): (3, 2, 1),
    (0xFF, 0xFF00, 0xFF0000, 0xFF000000): (0, 1, 2), (0xFF0000, 0xFF00, 0xFF, 0xFF000000): (2, 1, 0),
    (0xFF000000, 0xFF00, 0xFF, 0xFF0000): (3, 1, 0), (0x0, 0x0, 0x0, 0x0): (2, 1, 0),
}
_BMP_FIELDS16 = {(0xF800, 0x7E0, 0x1F): 565, (0x7C00, 0x3E0, 0x1F): 555}


class _Bmp:
    """Pillow's reading of a BMP header (``BmpImagePlugin._bitmap``)."""

    def __init__(self, data: bytes):
        d = self.data = bytes(data)
        if len(d) < 18 or not d.startswith(b"BM"):
            raise CodecError("not a BMP file")
        u16 = lambda p: struct.unpack("<H", d[p:p + 2])[0]  # noqa: E731
        u32 = lambda p: struct.unpack("<I", d[p:p + 4])[0]  # noqa: E731
        offset, hsize = u32(10), u32(14)
        if len(d) < 14 + hsize:
            raise CodecError("truncated BMP header")
        self.info, self.masks = {}, None
        pos = 14 + hsize  # where the file is read next
        self.colors = 0
        if hsize == 12:
            w, h, bits, comp, pad, self.top_down = u16(18), u16(20), u16(24), 0, 3, False
        elif hsize in (40, 52, 56, 64, 108, 124):
            self.top_down = d[25] == 0xFF
            w, h = u32(18), u32(22)
            if self.top_down:
                h = 2 ** 32 - h
            bits, comp, pad = u16(28), u32(30), 4
            ppm = (u32(38), u32(42))
            self.colors = u32(46)
            self.info["dpi"] = tuple(x / 39.3701 for x in ppm)
            if comp == 3:
                if hsize - 4 >= 48:
                    n = 4 if hsize - 4 >= 52 else 3
                    self.masks = tuple(u32(54 + 4 * i) for i in range(n)) + (0,) * (4 - n)
                else:
                    if len(d) < pos + 12:
                        raise CodecError("truncated BMP bit fields")
                    self.masks = tuple(u32(pos + 4 * i) for i in range(3)) + (0,)
                    pos += 12
        else:
            raise CodecError(f"unsupported BMP header type ({hsize})")
        self.w, self.h, self.bits, self.comp = w, h, bits, comp
        self.colors = self.colors or (1 << bits)
        if offset == 14 + hsize and bits <= 8:
            offset += 4 * self.colors
        if bits not in (1, 4, 8, 16, 24, 32):
            raise CodecError(f"unsupported BMP pixel depth ({bits})")
        if comp == 3:
            if not ((bits == 32 and self.masks in _BMP_FIELDS32)
                    or (bits in (24, 16) and self.masks[:3] in (_BMP_FIELDS16 if bits == 16 else
                                                                {(0xFF0000, 0xFF00, 0xFF): 0}))):
                raise CodecError("unsupported BMP bitfields layout")
        elif comp not in (0, 1, 2):
            raise CodecError(f"unsupported BMP compression ({comp})")
        self.mode, self.palette = ("P" if bits <= 8 else "RGB"), None
        if bits <= 8:
            if not 0 < self.colors <= 65536:
                raise CodecError(f"unsupported BMP palette size ({self.colors})")
            raw = d[pos:pos + pad * self.colors]
            gray = all(raw[i * pad:i * pad + 3] == bytes([v]) * 3 for i, v in
                       enumerate((0, 255) if self.colors == 2 else range(self.colors)))
            if gray:
                self.mode = "1" if self.colors == 2 else "L"
            else:
                pal = np.zeros((256, 3), np.uint8)  # Pillow's: past the palette is black
                n = min(256, len(raw) // pad)
                pal[:n] = np.frombuffer(raw, np.uint8, n * pad).reshape(n, pad)[:, 2::-1]
                self.palette = pal
        self.info["compression"] = comp
        if not offset:  # Pillow reads on from where the header ends
            offset = pos + (pad * self.colors if bits <= 8 else 0)
        self.offset = offset
        if comp in (1, 2) and bits > 8:
            raise CodecError(f"RLE compression of a {bits}-bit BMP")
        if w == 0 or h == 0 or w >= 1 << 31 or h >= 1 << 31:
            raise CodecError(f"bad BMP size {w}x{h}")

    def rgb(self) -> np.ndarray:
        """What Pillow's ``convert("RGB")`` reads: (H, W) gray or (H, W, 3)
        RGB, u8."""
        if self.comp in (1, 2):
            return self._rle()
        w, h, bits = self.w, self.h, self.bits
        stride = ((w * bits + 31) >> 3) & ~3
        if len(self.data) < self.offset + stride * h:
            raise CodecError("truncated BMP pixel data")
        rows = np.frombuffer(self.data, np.uint8, stride * h, self.offset).reshape(h, stride)
        if not self.top_down:
            rows = rows[::-1]
        if self.mode == "1":  # a black and white palette: Pillow unpacks bits, whatever the depth
            return (np.unpackbits(rows, axis=1)[:, :w] * 255).astype(np.uint8)
        if self.mode == "L":  # a gray ramp palette: Pillow reads bytes, if a row has enough
            if w > stride:
                raise CodecError(f"{bits}-bit BMP with a gray ramp palette: codec configuration")
            return rows[:, :w].copy()
        if bits <= 8:
            return self.palette[_png_rows(rows, w, 1, bits)[..., 0]]
        if bits == 16:
            v = rows[:, :2 * w].copy().view("<u2").astype(np.uint32)
            if self.comp == 3 and _BMP_FIELDS16[self.masks[:3]] == 565:
                r, g, b = (v >> 11) & 31, (v >> 5) & 63, v & 31
                return np.stack([r * 255 // 31, g * 255 // 63, b * 255 // 31], -1).astype(np.uint8)
            r, g, b = (v >> 10) & 31, (v >> 5) & 31, v & 31
            return np.stack([r * 255 // 31, g * 255 // 31, b * 255 // 31], -1).astype(np.uint8)
        px = rows[:, :w * bits // 8].reshape(h, w, bits // 8)
        order = _BMP_FIELDS32[self.masks] if self.comp == 3 and bits == 32 else (2, 1, 0)
        return px[..., list(order)]

    def _rle(self) -> np.ndarray:
        """Pillow's ``BmpRleDecoder``, step for step (its delta reads two
        bytes more than the spec's), then the palette."""
        if self.mode == "1":
            raise not_ported("RLE BMP with a black and white palette", item=LEFTOVERS)
        rle4, w, h = self.comp == 2, self.w, self.h
        f = io.BytesIO(self.data)
        f.seek(self.offset)
        out, x, total = bytearray(), 0, w * h
        while len(out) < total:
            pixels, byte = f.read(1), f.read(1)
            if not pixels or not byte:
                break
            n, b = pixels[0], byte[0]
            if n:
                n = min(n, max(0, w - x)) if x + n > w else n
                out += bytes([b >> 4, b & 15] * (n // 2) + [b >> 4] * (n % 2)) if rle4 else byte * n
                x += n
            elif b == 0:  # end of line
                out += bytes(-len(out) % w)
                x = 0
            elif b == 1:  # end of bitmap
                break
            elif b == 2:  # delta
                if len(f.read(2)) < 2:
                    break
                step = f.read(2)
                if len(step) < 2:
                    raise CodecError("truncated BMP RLE delta")
                out += bytes(step[0] + step[1] * w)
                x = len(out) % w
            else:  # an absolute run of b pixels
                count = b // 2 if rle4 else b
                got = f.read(count)
                out += bytes(v for c in got for v in (c >> 4, c & 15)) if rle4 else got
                if len(got) < count:
                    break
                x += b
                if f.tell() % 2:
                    f.seek(1, io.SEEK_CUR)
        if len(out) < total:
            raise CodecError("not enough BMP image data")
        idx = np.frombuffer(bytes(out[:total]), np.uint8).reshape(h, w)
        if not self.top_down:
            idx = idx[::-1]
        return idx.copy() if self.mode == "L" else self.palette[idx]


def read_bmp(data: bytes) -> np.ndarray:
    """BMP bytes → what Pillow reads in 8 bits: (H, W) gray or (H, W, 3) RGB."""
    return _Bmp(data).rgb()


def bmp_info(data: bytes) -> dict:
    """Pillow's ``info`` of a BMP: ``dpi`` (not the 12-byte header) and
    ``compression``."""
    return _Bmp(data).info


def write_bmp(img: np.ndarray) -> bytes:
    """(H, W) gray, (H, W, 3) RGB or (H, W, 4) RGBA u8 → BMP bytes: 8-bit
    with a gray palette, 24-bit or 32-bit, bottom-up."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    if img.ndim == 2:
        bpp, px, palette = 8, img, np.repeat(np.arange(256, dtype=np.uint8), 4).reshape(256, 4)
        palette[:, 3] = 0
    elif img.shape[2] in (3, 4):
        bpp, palette = img.shape[2] * 8, None
        px = img[..., [2, 1, 0] if img.shape[2] == 3 else [2, 1, 0, 3]].reshape(h, -1)
    else:
        raise CodecError(f"cannot write {img.shape[2]}-channel images as BMP")
    stride = (w * bpp // 8 + 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    rows[:, : px.shape[1]] = px
    pal = b"" if palette is None else palette.tobytes()
    offset = 14 + 40 + len(pal)
    body = rows[::-1].tobytes()
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, bpp, 0, len(body), 3780, 3780,
                       0 if palette is None else 256, 0 if palette is None else 256)
    return b"BM" + struct.pack("<IHHI", offset + len(body), 0, 0, offset) + info + pal + body


# -- PNM ------------------------------------------------------------------------

_WHITESPACE = b" \t\n\x0b\x0c\r"
_PNM_MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L", b"P6": "RGB",
              b"Pf": "F"}
_PILLOW_PNM = (b"P0CMYK", b"PyP", b"PyRGBA", b"PyCMYK")  # Pillow's own extensions
_SAFEBLOCK = 1 << 16  # Pillow's block of ASCII samples


class _Pnm:
    """Pillow's reading of a PNM header (``PpmImagePlugin``): byte for
    byte, comments and token limits included."""

    def __init__(self, data: bytes):
        self.f = f = io.BytesIO(bytes(data))
        magic = b""
        for _ in range(6):
            c = f.read(1)
            if not c or c in _WHITESPACE:
                break
            magic += c
        if magic in _PILLOW_PNM:
            raise not_ported(f"Pillow's {magic.decode()} images", item=LEFTOVERS)
        if magic not in _PNM_MODES:
            raise CodecError("not a PPM file")
        self.magic, self.mode, self.info = magic, _PNM_MODES[magic], {}
        try:
            self.w, self.h = int(self._token()), int(self._token())
            if self.mode == "F":
                scale = float(self._token())
                if scale == 0.0 or not math.isfinite(scale):
                    raise CodecError("scale must be finite and non-zero")
                self.info["scale"] = abs(scale)
                self.little = scale < 0
            elif self.mode != "1":
                self.maxval = int(self._token())
                if not 0 < self.maxval < 65536:
                    raise CodecError("maxval must be greater than 0 and less than 65536")
        except ValueError as e:  # int() and float() of a bad token
            raise CodecError(str(e)) from e
        if self.w <= 0 or self.h <= 0:
            raise CodecError(f"bad PNM size {self.w}x{self.h}")
        self.start = f.tell()

    def _token(self) -> bytes:
        f, token = self.f, b""
        while len(token) <= 10:
            c = f.read(1)
            if not c:
                break
            if c in _WHITESPACE:
                if not token:
                    continue
                break
            if c == b"#":
                while f.read(1) not in b"\r\n":
                    pass
                continue
            token += c
        if not token:
            raise CodecError("reached EOF while reading the PNM header")
        if len(token) > 10:
            raise CodecError("token too long in the PNM header")
        return token

    def rgb(self) -> np.ndarray:
        """What Pillow's ``convert("RGB")`` reads: (H, W) gray or (H, W, 3)
        RGB, u8."""
        w, h, f = self.w, self.h, self.f
        bands = 3 if self.mode == "RGB" else 1
        f.seek(self.start)
        if self.mode == "F":
            raw = f.read(4 * w * h)
            if len(raw) < 4 * w * h:
                raise CodecError("truncated PFM samples")
            v = np.frombuffer(raw, "<f4" if self.little else ">f4").reshape(h, w)[::-1]
            v = np.nan_to_num(v.astype(np.float64), nan=0.0, posinf=255.0, neginf=0.0)
            return np.clip(np.trunc(v), 0, 255).astype(np.uint8)  # Pillow's F → L
        if self.magic == b"P4":
            stride = (w + 7) // 8
            raw = f.read(stride * h)
            if len(raw) < stride * h:
                raise CodecError("truncated PBM samples")
            bits = np.unpackbits(np.frombuffer(raw, np.uint8).reshape(h, stride), axis=1)[:, :w]
            return ((1 - bits) * 255).astype(np.uint8)  # a 1 bit is black
        if self.magic in (b"P1", b"P2", b"P3"):
            v = self._plain(w * h * bands)
        else:
            wide = self.maxval > 255
            n = w * h * bands
            raw = f.read(n * (2 if wide else 1))
            if len(raw) < n * (2 if wide else 1):
                raise CodecError("not enough PNM image data")
            v = np.frombuffer(raw, ">u2" if wide else np.uint8).astype(np.int64)
            if self.maxval != 255:
                out_max = 65535 if self.mode == "L" and wide else 255
                if not (self.mode == "L" and self.maxval == 65535):
                    v = np.minimum(out_max, np.rint(v / self.maxval * out_max)).astype(np.int64)
        if self.mode == "L" and self.maxval > 255:  # Pillow's I: convert("RGB") clips
            v = np.minimum(v, 255)
        return v.astype(np.uint8).reshape((h, w, 3) if bands == 3 else (h, w))

    def _plain(self, total: int) -> np.ndarray:
        """Pillow's ``PpmPlainDecoder`` over the ASCII samples: block by
        block, comments cut up to and with their line end."""
        f, spans = self.f, [False]

        def block():
            return f.read(_SAFEBLOCK)

        def comment_end(b, start=0):
            a, c = b.find(b"\n", start), b.find(b"\r", start)
            return min(a, c) if a * c > 0 else max(a, c)

        def uncomment(b):
            if spans[0]:
                while b:
                    e = comment_end(b)
                    if e != -1:
                        b = b[e + 1:]
                        break
                    b = block()
            spans[0] = False
            while True:
                s = b.find(b"#")
                if s == -1:
                    break
                e = comment_end(b, s)
                if e != -1:
                    b = b[:s] + b[e + 1:]
                else:
                    b, spans[0] = b[:s], True
                    break
            return b

        if self.mode == "1":
            data = bytearray()
            while len(data) != total:
                b = block()
                if not b:
                    break
                tokens = b"".join(uncomment(b).split())
                if any(t not in (48, 49) for t in tokens):
                    raise CodecError("invalid token in a plain PBM")
                data = (data + tokens)[:total]
            if len(data) < total:
                raise CodecError("not enough PNM image data")
            return np.where(np.frombuffer(bytes(data), np.uint8) == 49, 0, 255)
        maxval, out_max = self.maxval, (65535 if self.mode == "L" and self.maxval > 255 else 255)
        values, half = [], b""
        while len(values) != total:
            b = block()
            if not b:
                if not half:
                    break
                b = b" "
            b = uncomment(b)
            if half:
                b, half = half + b, b""
            tokens = b.split()
            if b and not b[-1:].isspace():
                half = tokens.pop()
                if len(half) > 10:
                    raise CodecError("token too long in PNM samples")
            for t in tokens:
                if len(t) > 10:
                    raise CodecError("token too long in PNM samples")
                try:
                    v = int(t)
                except ValueError as e:
                    raise CodecError(str(e)) from e
                if v < 0 or v > maxval:
                    raise CodecError(f"PNM sample {v} outside 0-{maxval}")
                values.append(round(v / maxval * out_max))
                if len(values) == total:
                    break
        if len(values) < total:
            raise CodecError("not enough PNM image data")
        return np.array(values, np.int64)


def read_pnm(data: bytes) -> np.ndarray:
    """PNM bytes → what Pillow reads in 8 bits: (H, W) gray or (H, W, 3) RGB."""
    return _Pnm(data).rgb()


def pnm_info(data: bytes) -> dict:
    """Pillow's ``info`` of a PNM: ``scale`` for a PFM, else nothing."""
    return _Pnm(data).info


def write_pnm(img: np.ndarray) -> bytes:
    """(H, W) gray → P5, (H, W, 3) RGB → P6; (H, W, 4) RGBA → P6 of its
    RGB, as Pillow writes it."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim == 3 and img.shape[2] == 4:
        img = np.ascontiguousarray(img[..., :3])
    if img.ndim == 3 and img.shape[2] != 3:
        raise CodecError(f"cannot write {img.shape[2]}-channel images as PPM")
    h, w = img.shape[:2]
    return b"%s\n%d %d\n255\n" % (b"P5" if img.ndim == 2 else b"P6", w, h) + img.tobytes()


# -- the facade's view ------------------------------------------------------------


def to_bgr(img: np.ndarray) -> np.ndarray:
    """A decoded image in the file's channels → (H, W, 3) BGR, as the
    reference's ``convert("RGB")`` then channel swap gives it."""
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=2)
    if img.shape[2] == 2:  # gray + alpha
        return np.repeat(img[..., :1], 3, axis=2)
    return np.ascontiguousarray(img[..., 2::-1])


def from_mat_array(a: np.ndarray) -> np.ndarray:
    """A Mat's (H, W, C) array → the image the reference hands Pillow
    (``a[..., ::-1]``: RGB from BGR), gray as (H, W)."""
    if a.ndim == 3 and a.shape[2] == 1:
        return a[..., 0]
    return np.ascontiguousarray(a[..., ::-1])


def read_tiff(data: bytes) -> np.ndarray:
    """A TIFF's first page (:mod:`.tiff`)."""
    from . import tiff

    return tiff.read_tiff(data)


def read_gif(data: bytes) -> np.ndarray:
    """A GIF's first frame (:mod:`.gif`)."""
    from . import gif

    return gif.read_gif(data)


def read_webp(data: bytes) -> np.ndarray:
    """A WebP's first frame (:mod:`.webp`)."""
    from . import webp

    return webp.read_webp(data)


def write_tiff(img: np.ndarray) -> bytes:
    """One page, uncompressed (:func:`.tiff.write_tiff`)."""
    from . import tiff

    return tiff.write_tiff([img])


def write_gif(img) -> bytes:
    """One frame (:func:`.gif.write_gif`): numpy, or a tensor quantized on
    its device."""
    from . import gif

    return gif.write_gif([img])


def write_webp(img) -> bytes:
    """A still lossy WebP (:func:`.webp.write_webp`): numpy, or a tensor whose
    planes are made on its device."""
    from . import webp

    return webp.write_webp(img)


# PNG (still or animated) is :func:`.apng.read_png`'s
DECODERS = {"bmp": read_bmp, "pnm": read_pnm, "tiff": read_tiff,
            "gif": read_gif, "webp": read_webp}
ENCODERS = {"png": write_png, "bmp": write_bmp, "pnm": write_pnm, "tiff": write_tiff,
            "gif": write_gif, "webp": write_webp}
EXTENSIONS = {"png": "png", "bmp": "bmp", "dib": "bmp", "ppm": "pnm", "pgm": "pnm",
              "pnm": "pnm", "pbm": "pnm", "pfm": "pnm", "jpg": "jpeg", "jpeg": "jpeg",
              "jpe": "jpeg", "jfif": "jpeg", "tif": "tiff", "tiff": "tiff", "gif": "gif",
              "webp": "webp"}
