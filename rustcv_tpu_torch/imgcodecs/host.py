"""Host image codecs without Pillow: PNG, BMP and PPM/PGM, for the
``"host"`` backend of :mod:`rustcv_tpu_torch.imgcodecs` and the highgui
PNG dump.

Images are numpy arrays in the file's channel order: (H, W) gray, (H, W,
3) RGB or (H, W, 4) RGBA; the facade turns them into BGR Mats as the
reference's ``Image.convert("RGB")`` does (gray repeated, alpha dropped,
palettes looked up).

* PNG: read 8-bit gray, gray+alpha, RGB, RGBA and palette images,
  non-interlaced, every filter type (``native.png_unfilter``), with the
  ``tEXt``/``zTXt``/``iTXt`` text; write 8-bit gray, RGB and RGBA with
  filter None and the standard library's ``zlib``, text as ``tEXt`` (or
  ``iTXt`` when it is not Latin-1). Chunk CRCs are checked.
* BMP: read 8-bit palette, 24-bit and 32-bit (``BI_RGB`` or
  ``BI_BITFIELDS``), bottom-up or top-down; write 8-bit gray (a gray
  palette), 24-bit and 32-bit, as Pillow writes them.
* PPM/PGM: read and write binary ``P5``/``P6`` with maxval up to 255.

The bytes may differ from Pillow's (zlib level, filters, chunks); the
pixels each side reads from the other's files are the same. 16-bit
samples, interlaced PNGs, other BMP depths and compressions, ASCII PNM,
EXIF, and TIFF, GIF and WebP raise ``not_ported``.
"""

from __future__ import annotations

import re
import struct
import zlib
from typing import Dict, Optional, Tuple

import numpy as np

from ..core.errors import not_ported

LEFTOVERS = "8"  # the ROADMAP Queue 1 item of what stays not ported
_PNG_SIG = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> channels
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


class CodecError(ValueError):
    """A corrupt or truncated file."""


def sniff(data: bytes) -> str:
    """The format of encoded image bytes: "png", "bmp", "pnm", "jpeg", or
    raises (not_ported for TIFF, GIF and WebP; CodecError for unknown)."""
    head = bytes(data[:12])
    if head.startswith(_PNG_SIG):
        return "png"
    if head.startswith(b"BM"):
        return "bmp"
    if head[:1] == b"P" and head[1:2] in b"123456":
        return "pnm"
    if head.startswith(b"\xff\xd8"):
        return "jpeg"
    for magic, name in ((b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"), (b"GIF8", "GIF")):
        if head.startswith(magic):
            raise not_ported(f"reading {name} images", item=LEFTOVERS)
    if head[:4] == b"RIFF" and head[8:12] == b"WEBP":
        raise not_ported("reading WebP images", item=LEFTOVERS)
    raise CodecError("unknown image format")


# -- PNG ----------------------------------------------------------------------


def _chunks(data: bytes):
    if not data.startswith(_PNG_SIG):
        raise CodecError("not a PNG file")
    p = len(_PNG_SIG)
    while p + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[p:p + 8])
        body = data[p + 8:p + 8 + n]
        crc = data[p + 8 + n:p + 12 + n]
        if len(body) != n or len(crc) != 4:
            raise CodecError("truncated PNG chunk")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise CodecError(f"bad CRC in PNG chunk {kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        p += 12 + n
    raise CodecError("PNG without IEND")


def _text_chunk(kind: bytes, body: bytes) -> Tuple[str, str]:
    key, _, rest = body.partition(b"\x00")
    if kind == b"tEXt":
        return key.decode("latin-1"), rest.decode("latin-1")
    if kind == b"zTXt":
        return key.decode("latin-1"), zlib.decompress(rest[1:]).decode("latin-1")
    compressed, rest = rest[0], rest[2:]  # iTXt: flag, method, language, translated key
    _lang, _, rest = rest.partition(b"\x00")
    _tkey, _, text = rest.partition(b"\x00")
    return key.decode("latin-1"), (zlib.decompress(text) if compressed else text).decode("utf-8")


def read_png(data: bytes) -> Tuple[np.ndarray, Dict[str, str]]:
    """PNG bytes → (image in the file's channels, text metadata)."""
    from .. import native

    data = bytes(data)
    header, palette, idat, text = None, None, [], {}
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind in (b"tEXt", b"zTXt", b"iTXt"):
            key, value = _text_chunk(kind, body)
            text[key] = value
        elif kind == b"eXIf":
            raise not_ported("EXIF metadata", item=LEFTOVERS)
    if header is None:
        raise CodecError("PNG without IHDR")
    w, h, depth, ctype, _comp, _filt, interlace = header
    if ctype not in _PNG_CHANNELS:
        raise CodecError(f"bad PNG colour type {ctype}")
    if depth != 8 or interlace:
        raise not_ported(f"PNG with {depth}-bit samples{' interlaced' if interlace else ''}",
                         item=LEFTOVERS)
    ch = _PNG_CHANNELS[ctype]
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise CodecError(f"corrupt PNG image data: {e}") from e
    px = native.png_unfilter(raw, h, w * ch, ch).reshape(h, w, ch)
    if ctype == 3:
        if palette is None:
            raise CodecError("palette PNG without PLTE")
        return palette[np.minimum(px[..., 0], len(palette) - 1)], text
    return (px[..., 0] if ch == 1 else px), text


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def write_png(img: np.ndarray, text: Optional[Dict[str, str]] = None) -> bytes:
    """(H, W) gray, (H, W, 3) RGB or (H, W, 4) RGBA u8 → PNG bytes."""
    img = np.ascontiguousarray(img, np.uint8)
    ch = 1 if img.ndim == 2 else img.shape[2]
    ctype = {1: 0, 3: 2, 4: 6}.get(ch)
    if ctype is None:
        raise CodecError(f"cannot write {ch}-channel images as PNG")
    h, w = img.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * ch)], axis=1)
    out = [_PNG_SIG, _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))]
    for key, value in (text or {}).items():
        key, value = str(key), str(value)
        try:
            out.append(_chunk(b"tEXt", key.encode("latin-1") + b"\x00" + value.encode("latin-1")))
        except UnicodeEncodeError:
            out.append(_chunk(b"iTXt", key.encode("latin-1") + b"\x00\x00\x00\x00\x00"
                              + value.encode("utf-8")))
    out.append(_chunk(b"IDAT", zlib.compress(rows.tobytes())))
    out.append(_chunk(b"IEND", b""))
    return b"".join(out)


# -- BMP ----------------------------------------------------------------------


def read_bmp(data: bytes) -> np.ndarray:
    """BMP bytes → (H, W, 3) RGB (or (H, W, 4) RGBA for 32-bit)."""
    data = bytes(data)
    if len(data) < 26 or not data.startswith(b"BM"):
        raise CodecError("not a BMP file")
    offset, dib = struct.unpack("<I", data[10:14])[0], struct.unpack("<I", data[14:18])[0]
    if dib in (12, 16, 64):  # the OS/2 headers
        raise not_ported(f"BMP with a {dib}-byte header", item=LEFTOVERS)
    if dib not in (40, 52, 56, 108, 124):
        raise CodecError(f"bad BMP header size {dib}")
    if len(data) < 14 + dib:
        raise CodecError("truncated BMP header")
    w, h, _planes, bpp, comp = struct.unpack("<iiHHI", data[18:34])
    colors = struct.unpack("<I", data[46:50])[0]
    top_down, h = h < 0, abs(h)
    if w <= 0 or h == 0:
        raise CodecError(f"bad BMP size {w}x{h}")
    if bpp not in (8, 24, 32) or comp not in (0, 3) or (comp == 3 and bpp != 32):
        raise not_ported(f"{bpp}-bit BMP with compression {comp}", item=LEFTOVERS)
    stride = (w * bpp // 8 + 3) & ~3
    if len(data) < offset + stride * h:
        raise CodecError("truncated BMP pixel data")
    rows = np.frombuffer(data, np.uint8, stride * h, offset).reshape(h, stride)
    if not top_down:
        rows = rows[::-1]
    if bpp == 8:
        n = colors or 256
        pal = np.frombuffer(data, np.uint8, 4 * n, 14 + dib).reshape(n, 4)[:, 2::-1]
        return pal[np.minimum(rows[:, :w], n - 1)]
    px = rows[:, : w * bpp // 8].reshape(h, w, bpp // 8)
    if bpp == 24:
        return px[..., ::-1]
    if comp == 3:
        masks = struct.unpack("<III", data[54:66])
        if masks != (0xFF0000, 0xFF00, 0xFF):
            raise not_ported(f"BMP bit fields {masks}", item=LEFTOVERS)
    return px[..., [2, 1, 0, 3]]


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


# -- PPM / PGM ------------------------------------------------------------------

_PNM_TOKEN = re.compile(rb"(?:\s|#[^\n]*\n)*(\S+)")


def read_pnm(data: bytes) -> np.ndarray:
    """Binary P5/P6 bytes → (H, W) gray or (H, W, 3) RGB."""
    data = bytes(data)
    magic = data[:2]
    if magic not in (b"P5", b"P6"):
        raise not_ported(f"PNM type {magic.decode('latin-1', 'replace')}", item=LEFTOVERS)
    p, vals = 2, []
    for _ in range(3):
        m = _PNM_TOKEN.match(data, p)
        if m is None:
            raise CodecError("truncated PNM header")
        vals.append(int(m.group(1)))
        p = m.end()
    w, h, maxval = vals
    if w <= 0 or h <= 0:
        raise CodecError(f"bad PNM size {w}x{h}")
    if not 0 < maxval < 256:
        raise not_ported(f"PNM with maxval {maxval}", item=LEFTOVERS)
    p += 1  # the one whitespace byte before the samples
    ch = 1 if magic == b"P5" else 3
    if len(data) < p + w * h * ch:
        raise CodecError("truncated PNM samples")
    px = np.frombuffer(data, np.uint8, w * h * ch, p).reshape(h, w, ch)
    if maxval != 255:
        px = ((px.astype(np.uint32) * 255 + maxval // 2) // maxval).astype(np.uint8)
    return px[..., 0] if ch == 1 else px


def write_pnm(img: np.ndarray) -> bytes:
    """(H, W) gray → P5, (H, W, 3) RGB → P6."""
    img = np.ascontiguousarray(img, np.uint8)
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


DECODERS = {"png": lambda d: read_png(d)[0], "bmp": read_bmp, "pnm": read_pnm}
ENCODERS = {"png": write_png, "bmp": write_bmp, "pnm": write_pnm}
EXTENSIONS = {"png": "png", "bmp": "bmp", "dib": "bmp", "ppm": "pnm", "pgm": "pnm",
              "pnm": "pnm", "pbm": "pnm", "jpg": "jpeg", "jpeg": "jpeg", "jpe": "jpeg",
              "jfif": "jpeg"}
NOT_PORTED_EXTENSIONS = {"tif": "TIFF", "tiff": "TIFF", "gif": "GIF", "webp": "WebP"}
