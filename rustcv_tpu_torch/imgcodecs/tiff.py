"""TIFF without Pillow: what the reference's Pillow 12 reads and writes, for
:mod:`rustcv_tpu_torch.imgcodecs`.

A read gives what ``Image.open(...)`` then ``convert("RGB")`` gives, page by
page (``ImageSequence``), byte for byte:

* structure: ``II`` and ``MM`` byte order, classic TIFF and little-endian
  BigTIFF (Pillow reads a big-endian BigTIFF header as a classic one and
  fails), the IFD chain as ``TiffImageFile._seek`` walks it (a repeated
  offset ends it), strips and tiles, planar configuration 1 and 2;
* compression: none, PackBits, LZW and both Deflate codes; predictor 2
  undone per row modulo 2^bits (Pillow reads an uncompressed strip with its
  own raw decoder, which ignores the predictor and the byte counts, and
  every compressed one through libtiff);
* pixels: every key of Pillow's ``OPEN_INFO`` for photometric 0-3 and 5
  at 1, 2, 4, 8 and 16 bits, 32-bit ``I`` and ``F``, with ExtraSamples, fill
  order 2, then Pillow's ``convert("RGB")`` from that mode (``I;16`` and
  ``I`` clip, ``F`` truncates, CMYK by Pillow's integer formula, associated
  alpha un-premultiplied as Pillow's ``RGBa`` unpacker does); the EXIF
  orientation applied as ``TiffImageFile.load_end`` applies it.

* JPEG compression (code 7), as libtiff's JPEG codec reads it for Pillow:
  each strip or tile a JPEG decoded by the port's host JPEG decode after
  the tables libjpeg holds by then (JPEGTables, then those of the chunks
  before); a YCbCr page of one plane converted by libjpeg, every other
  page's components kept as they are; libtiff's checks (the chunk's size,
  components and sampling factors, YCbCrSubsampling fixed up from the first
  chunk where it is missing); a short stream leaves what Pillow's reused
  strip buffer held;
* the YCbCr photometric on PackBits, LZW and Deflate, as libtiff's RGBA
  reader (which Pillow takes for it) reads it: data units of every
  subsampling it reads, its 4x4 quirks, libtiff's integer conversion with
  YCbCrCoefficients and ReferenceBlackWhite (``native.tiff_ycbcr_to_rgb``),
  chunks that fail read on as libtiff reads on; uncompressed, Pillow's raw
  read of four bytes a pixel.

What Pillow reads through libtiff beyond that (old-style JPEG, CCITT, LZMA,
ZSTD, WebP and JBIG compression, old-style LZW, predictor 3, CIELab, 12-bit
samples) raises ``not_ported`` (ROADMAP Queue 1 item 8); what Pillow
refuses raises :class:`~.host.CodecError`.

A write is Pillow's ``_save`` without compression: one strip per page,
Pillow's tags, the pages in one IFD chain (``save_all``).
"""

from __future__ import annotations

import re
import struct
import zlib
from typing import List, Optional, Tuple

import numpy as np

from ..core.errors import not_ported
from .host import LEFTOVERS, TIFF_PREFIXES, CodecError

# Pillow's names of the compression codes (TiffImagePlugin.COMPRESSION_INFO)
COMPRESSION_INFO = {
    1: "raw", 2: "tiff_ccitt", 3: "group3", 4: "group4", 5: "tiff_lzw", 6: "tiff_jpeg",
    7: "jpeg", 8: "tiff_adobe_deflate", 32771: "tiff_raw_16", 32773: "packbits",
    32809: "tiff_thunderscan", 32946: "tiff_deflate", 34676: "tiff_sgilog",
    34677: "tiff_sgilog24", 34925: "lzma", 50000: "zstd", 50001: "webp",
}
_READ = ("raw", "packbits", "tiff_lzw", "tiff_adobe_deflate", "tiff_deflate", "jpeg")
_MAX_SAMPLES = 6  # Pillow's MAX_SAMPLESPERPIXEL
# libtiff's YCbCr subsamplings (h, v) its RGBA reader converts (tif_getimage.c)
_YCBCR_PUT = ((1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4))


def _open_info() -> dict:
    """Pillow's ``OPEN_INFO`` for the forms read here: (byte order,
    photometric, sample format, fill order, bits, extra samples) → (mode,
    raw mode). Built for both byte orders at once, as Pillow lists them."""
    rows = [
        (0, (1,), 1, (1,), (), "1", "1;I"), (0, (1,), 2, (1,), (), "1", "1;IR"),
        (1, (1,), 1, (1,), (), "1", "1"), (1, (1,), 2, (1,), (), "1", "1;R"),
        (0, (1,), 1, (2,), (), "L", "L;2I"), (0, (1,), 2, (2,), (), "L", "L;2IR"),
        (1, (1,), 1, (2,), (), "L", "L;2"), (1, (1,), 2, (2,), (), "L", "L;2R"),
        (0, (1,), 1, (4,), (), "L", "L;4I"), (0, (1,), 2, (4,), (), "L", "L;4IR"),
        (1, (1,), 1, (4,), (), "L", "L;4"), (1, (1,), 2, (4,), (), "L", "L;4R"),
        (0, (1,), 1, (8,), (), "L", "L;I"), (0, (1,), 2, (8,), (), "L", "L;IR"),
        (1, (1,), 1, (8,), (), "L", "L"), (1, (2,), 1, (8,), (), "L", "L"),
        (1, (1,), 2, (8,), (), "L", "L;R"),
        (1, (1,), 1, (8, 8), (2,), "LA", "LA"),
        (2, (1,), 1, (8, 8, 8), (), "RGB", "RGB"), (2, (1,), 2, (8, 8, 8), (), "RGB", "RGB;R"),
        (2, (1,), 1, (8, 8, 8, 8), (), "RGBA", "RGBA"),
        (2, (1,), 1, (8, 8, 8, 8), (0,), "RGB", "RGBX"),
        (2, (1,), 1, (8, 8, 8, 8, 8), (0, 0), "RGB", "RGBXX"),
        (2, (1,), 1, (8, 8, 8, 8, 8, 8), (0, 0, 0), "RGB", "RGBXXX"),
        (2, (1,), 1, (8, 8, 8, 8), (1,), "RGBA", "RGBa"),
        (2, (1,), 1, (8, 8, 8, 8, 8), (1, 0), "RGBA", "RGBaX"),
        (2, (1,), 1, (8, 8, 8, 8, 8, 8), (1, 0, 0), "RGBA", "RGBaXX"),
        (2, (1,), 1, (8, 8, 8, 8), (2,), "RGBA", "RGBA"),
        (2, (1,), 1, (8, 8, 8, 8, 8), (2, 0), "RGBA", "RGBAX"),
        (2, (1,), 1, (8, 8, 8, 8, 8, 8), (2, 0, 0), "RGBA", "RGBAXX"),
        (2, (1,), 1, (8, 8, 8, 8), (999,), "RGBA", "RGBA"),
        (3, (1,), 1, (1,), (), "P", "P;1"), (3, (1,), 2, (1,), (), "P", "P;1R"),
        (3, (1,), 1, (2,), (), "P", "P;2"), (3, (1,), 2, (2,), (), "P", "P;2R"),
        (3, (1,), 1, (4,), (), "P", "P;4"), (3, (1,), 2, (4,), (), "P", "P;4R"),
        (3, (1,), 1, (8,), (), "P", "P"), (3, (1,), 1, (8, 8), (0,), "P", "PX"),
        (3, (1,), 1, (8, 8), (2,), "PA", "PA"), (3, (1,), 2, (8,), (), "P", "P;R"),
        (5, (1,), 1, (8, 8, 8, 8), (), "CMYK", "CMYK"),
        (5, (1,), 1, (8, 8, 8, 8, 8), (0,), "CMYK", "CMYKX"),
        (5, (1,), 1, (8, 8, 8, 8, 8, 8), (0, 0), "CMYK", "CMYKXX"),
        (6, (1,), 1, (8,), (), "L", "L"), (6, (1,), 1, (8, 8, 8), (), "RGB", "RGBX"),
    ]
    table = {}
    for prefix in (b"II", b"MM"):
        for photo, fmt, fill, bits, extra, mode, raw in rows:
            table[(prefix, photo, fmt, fill, bits, extra)] = (mode, raw)
        end = "L" if prefix == b"II" else "B"
        for photo, bits, extra, mode, raw in (
                (2, (16, 16, 16), (), "RGB", "RGB"), (2, (16,) * 4, (), "RGBA", "RGBA"),
                (2, (16,) * 4, (0,), "RGB", "RGBX"), (2, (16,) * 4, (1,), "RGBA", "RGBa"),
                (2, (16,) * 4, (2,), "RGBA", "RGBA"), (5, (16,) * 4, (), "CMYK", "CMYK")):
            table[(prefix, photo, (1,), 1, bits, extra)] = (mode, f"{raw};16{end}")
        table[(prefix, 1, (2,), 1, (16,), ())] = ("I", "I;16BS" if prefix == b"MM" else "I;16S")
        table[(prefix, 0, (3,), 1, (32,), ())] = ("F", "F;32BF" if prefix == b"MM" else "F;32F")
        table[(prefix, 1, (3,), 1, (32,), ())] = ("F", "F;32BF" if prefix == b"MM" else "F;32F")
        table[(prefix, 1, (2,), 1, (32,), ())] = ("I", "I;32BS" if prefix == b"MM" else "I;32S")
    table[(b"II", 0, (1,), 1, (16,), ())] = ("I;16", "I;16")
    table[(b"II", 1, (1,), 1, (16,), ())] = ("I;16", "I;16")
    table[(b"MM", 1, (1,), 1, (16,), ())] = ("I;16B", "I;16B")
    table[(b"II", 1, (1,), 2, (16,), ())] = ("I;16", "I;16R")
    table[(b"II", 1, (1,), 1, (32,), ())] = ("I", "I;32N")
    return table


OPEN_INFO = _open_info()
# OPEN_INFO keys Pillow has that this module leaves to item 8 (12-bit gray
# and CIELab)
_LATER = {(b"II", 1, (1,), 1, (12,), ()): "12-bit TIFF"}
for _p in (b"II", b"MM"):
    _LATER[(_p, 8, (1,), 1, (8, 8, 8), ())] = "CIELab TIFF"
# Fill-order-2 raw modes Pillow has no unpacker for (its raw path raises)
_NO_UNPACKER = ("L;IR", "P;1R", "P;2R", "P;4R")
# The one-band raw modes Pillow unpacks each plane of a planar page with,
# by mode (its raw path takes the raw mode's letters one by one)
_PLANAR_BANDS = {"1": "1", "L": "L", "RGB": "RGB", "RGBA": "RGBA", "CMYK": "CMYK"}
# Raw modes Pillow keeps for libtiff's output, which is in the host's byte
# order: a compressed big-endian page of these reads byte-swapped.
_SWAPPED = ("F;32BF", "I;32BS", "I;16BS")
# TIFF tags whose count is one in Pillow's tag table (TiffTags.TAGS_V2): a
# longer value of one of them reads as its first element.
ONE_VALUE = frozenset((
    254, 255, 256, 257, 259, 262, 263, 264, 265, 266, 269, 270, 271, 272, 274, 277, 278, 282,
    283, 284, 285, 286, 287, 288, 289, 290, 292, 293, 296, 305, 306, 315, 316, 317, 322, 323,
    332, 333, 334, 337, 347, 512, 513, 514, 515, 531, 32995, 32997, 32998, 33432, 33723, 34665,
    34675, 34853, 36864, 37724, 40960, 40965, 41730, 45056, 45057, 45058, 45060, 45313, 45569,
    45570, 45571, 45572, 45573, 45574, 45575, 45576, 45577, 45578, 45579, 45580, 45581, 50741,
    50780, 50839))
# TIFF field type → (bytes per value, struct format)
TYPES = {1: (1, "B"), 2: (1, "B"), 3: (2, "H"), 4: (4, "L"), 5: (8, "L"), 6: (1, "b"),
         7: (1, "B"), 8: (2, "h"), 9: (4, "l"), 10: (8, "l"), 11: (4, "f"), 12: (8, "d"),
         13: (4, "L"), 16: (8, "Q")}
XMP_ORIENTATION = rb'tiff:Orientation(="|>)([0-9])'  # where Pillow finds it in an XMP packet


def directory(data: bytes, offset: int, e: str, big: bool) -> Tuple[dict, Optional[int]]:
    """The IFD at ``offset`` as Pillow's ``ImageFileDirectory_v2.load``
    reads it: {tag: (type, value bytes)} in the directory's order (unknown
    types and empty values skipped), and the next IFD's offset (None when
    the directory is cut short, which ends it where the cut is)."""
    entries: dict = {}
    try:
        count = struct.unpack(e + ("Q" if big else "H"), data[offset:offset + (8 if big else 2)])[0]
        p = offset + (8 if big else 2)
        size_e = 20 if big else 12
        for _ in range(count):
            if p + size_e > len(data):
                return entries, None
            if big:
                tag, typ, n, inline = struct.unpack(e + "HHQ8s", data[p:p + 20])
            else:
                tag, typ, n, inline = struct.unpack(e + "HHL4s", data[p:p + 12])
            p += size_e
            if typ not in TYPES:
                continue
            size = n * TYPES[typ][0]
            if size > len(inline):
                at = struct.unpack(e + ("Q" if big else "L"), inline)[0]
                if at + size > len(data):
                    return entries, None  # Pillow's _safe_read raises and ends the directory
                raw = data[at:at + size]
            else:
                raw = inline[:size]
            if raw:
                entries[tag] = (typ, raw)
        nxt = struct.unpack(e + ("Q" if big else "L"), data[p:p + (8 if big else 4)])[0]
    except struct.error:
        return entries, None
    return entries, nxt


def _values(typ: int, raw: bytes, e: str) -> tuple:
    size, fmt = TYPES[typ]
    if typ in (1, 2, 7):
        return tuple(raw)
    if typ in (5, 10):
        v = struct.unpack(f"{e}{len(raw) // 4}{fmt}", raw)
        return tuple(a / b if b else float("nan") for a, b in zip(v[::2], v[1::2]))
    return struct.unpack(f"{e}{len(raw) // size}{fmt}", raw)


class _Page:
    """One IFD: ``tags`` as Pillow's ``tag_v2.get`` gives them (a scalar for
    the one-value tags, else a tuple)."""

    def __init__(self, data: bytes, offset: int, e: str, big: bool):
        self.offset = offset
        self.entries, self.next = directory(data, offset, e, big)
        self.e = e

    def get(self, tag: int, default=None):
        if tag not in self.entries:
            return default
        typ, raw = self.entries[tag]
        if typ == 2:
            text = raw[:-1] if raw.endswith(b"\x00") else raw
            return text.decode("latin-1", "replace")
        v = _values(typ, raw, self.e)
        return v[0] if tag in ONE_VALUE else v


class Tiff:
    """A parsed TIFF file: its pages (the IFD chain) and their pixels."""

    def __init__(self, data: bytes):
        self.data = data = bytes(data)
        if data[:4] not in TIFF_PREFIXES:
            raise CodecError("not a TIFF file")
        self.prefix = data[:2]
        self.e = ">" if self.prefix == b"MM" else "<"
        self.big = data[2] == 43  # as Pillow tests it: a big-endian BigTIFF is read as classic
        try:
            nxt = struct.unpack(self.e + ("Q" if self.big else "L"),
                                data[8:16] if self.big else data[4:8])[0]
        except struct.error as err:
            raise CodecError("truncated TIFF header") from err
        self.pages: List[_Page] = []
        seen = []
        while nxt:
            if nxt >= 2 ** 63:
                raise CodecError("unable to seek to TIFF frame")
            page = _Page(data, nxt, self.e, self.big)
            seen.append(nxt)
            self.pages.append(page)
            nxt = 0 if page.next is None or page.next in seen else page.next
        if not self.pages:
            raise CodecError("TIFF file without an image")

    def __len__(self) -> int:
        return len(self.pages)

    def setup(self, k: int) -> dict:
        """Pillow's ``_setup`` of page ``k``: its mode, raw mode and layout;
        raises where Pillow raises, ``not_ported`` where the port has not
        followed it yet."""
        t = self.pages[k]
        if 0xBC01 in t.entries:
            raise CodecError("Windows Media Photo files not yet supported")
        code = t.get(259, 1)
        if code not in COMPRESSION_INFO:
            raise CodecError(f"unknown TIFF compression {code}")
        comp = COMPRESSION_INFO[code]
        planar = t.get(284, 1)
        photo = 6 if comp == "tiff_jpeg" else t.get(262, 0)
        fill = t.get(266, 1)
        w, h = t.get(256), t.get(257)
        if w is None or h is None:
            raise CodecError("missing TIFF dimensions")
        if not isinstance(w, int) or not isinstance(h, int):
            raise CodecError("invalid TIFF dimensions")
        fmt = t.get(339, (1,))
        if len(fmt) > 1 and max(fmt) == min(fmt) == 1:
            fmt = (1,)
        bits = t.get(258, (1,))
        extra = t.get(338, ())
        spp = t.get(277, 3 if comp == "tiff_jpeg" and photo in (2, 6) else 1)
        if spp > _MAX_SAMPLES:
            raise CodecError("invalid value for samples per pixel")
        if spp < len(bits):
            bits = bits[:spp]
        elif spp > len(bits) and len(bits) == 1:
            bits = bits * spp
        if len(bits) != spp:
            raise CodecError("unknown TIFF data organization")
        key = (self.prefix, photo, fmt, fill, bits, extra)
        if key in _LATER:
            raise not_ported(f"reading {_LATER[key]} images", item=LEFTOVERS)
        if key not in OPEN_INFO:
            raise CodecError(f"unknown TIFF pixel mode {key[1:]}")
        mode, raw = OPEN_INFO[key]
        if comp not in _READ:
            name = "old-style JPEG" if comp == "tiff_jpeg" else comp
            raise not_ported(f"reading TIFF with {name} compression", item=LEFTOVERS)
        if comp == "raw" and fill == 2 and raw in _NO_UNPACKER:
            raise CodecError(f"unknown raw mode {raw} for given image mode")
        if planar == 2:
            if mode in ("P", "PA") or (comp == "raw" and bits[0] != 8):
                raise not_ported(f"reading {bits[0]}-bit planar TIFF of mode {mode}",
                                 item=LEFTOVERS)
            if comp == "raw" and any(c not in _PLANAR_BANDS.get(mode, "") for c in raw[:spp]):
                raise CodecError(f"unknown raw mode for the bands of {raw}")  # Pillow's band unpackers
            if comp != "raw" and "X" in raw and photo != 6:  # YCbCr: libtiff's RGBA reader
                raise CodecError("planar TIFF with extra samples: decoder error")
        strips = 273 in t.entries
        if not strips and 324 not in t.entries:
            raise CodecError("unknown TIFF data organization")
        if strips:
            offsets, cw, ch = t.get(273), w, t.get(278, h)
        else:
            offsets, cw, ch = t.get(324), t.get(322), t.get(323)
            if not isinstance(cw, int) or not isinstance(ch, int):
                raise CodecError("invalid TIFF tile dimensions")
        counts = t.get(325 if not strips else 279, ())
        predictor = t.get(317, 1) if comp not in ("raw", "jpeg") else 1  # libtiff's JPEG has none
        if predictor not in (1, 2):
            raise not_ported(f"TIFF predictor {predictor}", item=LEFTOVERS)
        if comp == "raw" and photo == 6 and planar == 1 and not strips and cw and w % cw:
            raise not_ported("reading uncompressed tiled YCbCr TIFF", item=LEFTOVERS)
        return dict(w=w, h=h, comp=comp, mode=mode, raw=raw, bits=bits, spp=spp, planar=planar,
                    fill=fill, strips=strips, offsets=offsets, counts=counts, cw=cw, ch=ch,
                    predictor=predictor, photo=photo)

    # -- pixels ---------------------------------------------------------------

    def _blob(self, s: dict, i: int) -> bytes:
        """The stored bytes of strip or tile ``i`` (its byte count's worth)."""
        if i >= len(s["counts"]):
            raise CodecError("TIFF strip without a byte count")
        off = s["offsets"][i]
        return self.data[off:off + s["counts"][i]]

    def _chunk(self, s: dict, i: int, need: int, partial: bool = False) -> np.ndarray:
        """The ``need`` bytes strip or tile ``i`` decompresses to (with
        ``partial``, what it gives when its data ends first)."""
        from .. import native

        if s["comp"] == "raw":  # Pillow's raw decoder: from the offset on, byte counts unread
            off = s["offsets"][i]
            raw = self.data[off:off + need]
            if len(raw) < need:
                raise CodecError("TIFF image file is truncated")
            raw = np.frombuffer(raw, np.uint8)
            return _reverse_bits(raw) if s["fill"] == 2 else raw
        blob = self._blob(s, i)
        if s["fill"] == 2:
            blob = _reverse_bits(np.frombuffer(blob, np.uint8)).tobytes()
        comp = s["comp"]
        try:
            if comp == "tiff_lzw":
                out = native.tiff_lzw_decode(blob, need)
            elif comp == "packbits":
                out = native.packbits_decode(blob, need)
            else:
                d = zlib.decompressobj()
                out = np.frombuffer(d.decompress(blob, need), np.uint8)
        except zlib.error as err:
            raise CodecError(f"corrupt TIFF Deflate data: {err}") from err
        if out.size < need and not partial:
            raise CodecError(f"not enough TIFF image data ({out.size} of {need} bytes)")
        return out

    def _grid(self, s: dict) -> Tuple[int, int]:
        """(chunks across, chunks down) of one plane."""
        if s["strips"]:
            return 1, (-(-s["h"] // s["ch"]) if s["ch"] > 0 else 1)
        return -(-s["w"] // s["cw"]), -(-s["h"] // s["ch"])

    def samples(self, k: int) -> Tuple[np.ndarray, dict]:
        """Page ``k``'s samples (H, W, samples per pixel) in the file's
        values (u8, u16, i32 or f32) and its setup; a YCbCr page outside
        the raw path as RGB, converted as libtiff converts it."""
        s = self.setup(k)
        if s["comp"] == "jpeg":
            return self._jpeg_samples(s, k), s
        if s["photo"] == 6 and s["comp"] != "raw":
            return self._ycbcr_samples(s, k), s
        return self._plain_samples(s), s

    def _plain_samples(self, s: dict) -> np.ndarray:
        """The samples of every page but the YCbCr and JPEG ones."""
        w, h, bits, spp = s["w"], s["h"], s["bits"][0], s["spp"]
        planes = spp if s["planar"] == 2 else 1
        per = 1 if s["planar"] == 2 else spp
        if s["photo"] == 6 and s["planar"] == 1:
            per = 4  # Pillow's raw mode RGBX: four bytes per pixel, no conversion
        cw, ch = s["cw"], s["ch"]
        dtype = _dtype(s["raw"], bits, self.e)
        out = np.zeros((h, w, max(spp, per)),
                       dtype.newbyteorder("=") if dtype.itemsize > 1 else dtype)
        offsets = list(s["offsets"])
        raw_path = s["comp"] == "raw"
        across, down = self._grid(s)
        if raw_path and cw == w and ch == h and s["planar"] != 2:
            offsets = offsets[-1:]  # Pillow: "every tile covers the image", the last offset
            across = down = 1
        s["offsets"] = offsets
        row_bytes = (cw * bits * per + 7) // 8
        i = 0
        for p in range(planes):
            for ty in range(down):
                for tx in range(across):
                    if i >= len(offsets):
                        break
                    y0, x0 = ty * ch, tx * cw
                    rows = ch
                    if s["strips"] or raw_path:
                        rows = min(ch, h - y0)
                    if rows <= 0:
                        continue
                    chunk = self._chunk(s, i, rows * row_bytes)
                    i += 1
                    v = _unpack(chunk[:rows * row_bytes].reshape(rows, row_bytes), cw, per, bits,
                                dtype)
                    if s["predictor"] == 2:
                        if bits < 8:
                            raise CodecError(f"horizontal differencing of {bits}-bit TIFF samples")
                        v = _undo_predictor(v)
                    rh, rw = min(rows, h - y0), min(cw, w - x0)
                    out[y0:y0 + rh, x0:x0 + rw, p:p + per] = v[:rh, :rw]
        return out

    def _ycbcr_samples(self, s: dict, k: int) -> np.ndarray:
        """A YCbCr page of PackBits, LZW or Deflate as Pillow reads it,
        through libtiff's RGBA reader: each strip's or tile's data units
        (h x v luma samples, then Cb and Cr, padded at the right and bottom
        edges) spread over their pixels, then libtiff's conversion with the
        page's YCbCrCoefficients and ReferenceBlackWhite (or, planar, the
        three planes at subsampling (1, 1), the only planar form it reads)."""
        if s["bits"] != (8, 8, 8):
            raise CodecError("TIFF YCbCr reader: can not handle format")
        t = self.pages[k]
        hs, vs = _subsampling(t)
        if s["planar"] == 2:
            if (hs, vs) != (1, 1):
                raise CodecError("TIFF YCbCr reader: can not handle planar subsampled format")
            return _ycbcr_to_rgb(self._plain_samples(s), t)
        if (hs, vs) not in _YCBCR_PUT:
            raise CodecError(f"TIFF YCbCr reader: can not handle subsampling {(hs, vs)}")
        w, h, cw, ch = s["w"], s["h"], s["cw"], s["ch"]
        unit = hs * vs + 2
        uc = -(-cw // hs)
        # libtiff reads a strip as whole scanlines of floor(unit row / v)
        # bytes, so where v does not divide a unit row, the last bytes of
        # each strip are not read: they keep what the buffer held
        scan = uc * unit // vs
        # the predictor's rows: a scanline on strips, tile width x 3 on tiles
        pred_row = scan if s["strips"] else cw * 3
        out = np.zeros((h, w, 3), np.uint8)
        across, down = self._grid(s)
        # Pillow reads a strip or a row of tiles per TIFFRGBAImageGet, which
        # reads into a buffer of its own, made when its first chunk's data
        # is read (where that fails, the page fails). A chunk that fails
        # later leaves the reader going (Pillow asks it not to stop): one
        # whose data cannot be read, or that decodes short, is zeros past
        # what its codec wrote; one whose predictor rows are not whole
        # samples keeps its differences.
        for ty in range(down):
            buf = None
            for tx in range(across):
                i = ty * across + tx
                if i >= len(s["offsets"]):
                    break
                y0, x0 = ty * ch, tx * cw
                rows = min(ch, h - y0) if s["strips"] else ch
                rh, rw = min(ch, h - y0), min(cw, w - x0)
                if rh <= 0:
                    continue
                ur = -(-rows // vs)
                need = ur * vs * scan if s["strips"] else ur * uc * unit
                count = s["counts"][i] if i < len(s["counts"]) else 0
                if count <= 0 or s["offsets"][i] + count > len(self.data):  # TIFFFillStrip fails
                    if buf is None:
                        raise CodecError("TIFF strip or tile without its data")
                    buf[:need] = 0
                else:
                    if buf is None:  # a strip's rows (RowsPerStrip may pass the height)
                        buf = np.zeros(-(-(min(ch, h) if s["strips"] else ch) // vs) * uc * unit,
                                       np.uint8)
                    data = self._chunk(s, i, need, partial=True)[:need]
                    buf[:data.size] = data
                    buf[data.size:need] = 0
                    if s["predictor"] == 2 and data.size == need and not (
                            need % pred_row or pred_row % 3):
                        buf[:need] = np.cumsum(buf[:need].reshape(-1, pred_row // 3, 3), axis=1,
                                               dtype=np.uint8).reshape(-1)
                # the units the put reads: ceil(rw / h) per unit row, then a
                # skip past the rest of a tile's row, which libtiff's 4x4 put
                # reckons in 4x2 units (10 bytes, not 18)
                nu, nr = -(-rw // hs), -(-rh // vs)
                skip = (cw - rw) // hs * (10 if (hs, vs) == (4, 4) else unit)
                at = (np.arange(nr)[:, None, None] * (nu * unit + skip)
                      + np.arange(nu)[None, :, None] * unit + np.arange(unit))
                u = buf[at]
                y = u[..., :hs * vs].reshape(nr, nu, vs, hs).transpose(0, 2, 1, 3)
                full = np.empty((nr * vs, nu * hs, 3), np.uint8)
                full[..., 0] = y.reshape(nr * vs, nu * hs)
                full[..., 1:] = np.repeat(np.repeat(u[..., hs * vs:], vs, axis=0), hs, axis=1)
                out[y0:y0 + rh, x0:x0 + rw] = full[:rh, :rw]
        return _ycbcr_to_rgb(out, t)

    def _jpeg_samples(self, s: dict, k: int) -> np.ndarray:
        """A page of JPEG compression (code 7) as Pillow reads it through
        libtiff's JPEG codec: each strip or tile a JPEG of its own, decoded
        by the host JPEG decode after the tables libjpeg holds by then (the
        JPEGTables tag's, then those of the chunks before it). A YCbCr page
        of one plane is converted by libjpeg (libtiff's JPEGCOLORMODE_RGB),
        every other page keeps its components (JCS_UNKNOWN), and a planar
        YCbCr page goes through libtiff's RGBA reader and its conversion.
        libtiff's checks raise CodecError: the chunk's size against the
        strip's or tile's (a last strip may hold more rows), its components,
        its sampling factors against YCbCrSubsampling (fixed up from the
        first chunk where the tag is missing, as JPEGFixupTagsSubsampling
        does). Rows and columns a chunk's JPEG leaves out keep what Pillow's
        reused strip buffer held: the chunk before it, zeros at first."""
        from .. import native

        t = self.pages[k]
        w, h, cw, ch, spp = s["w"], s["h"], s["cw"], s["ch"], s["spp"]
        contig = s["planar"] != 2
        ycc = s["photo"] == 6
        if any(b != 8 for b in s["bits"]):
            raise CodecError("improper JPEG data precision")
        if ycc and contig and spp != 3:
            raise CodecError("unknown raw mode for given image mode")  # Pillow's raw mode RGB
        expect = (1, 1)
        if ycc:
            expect = _subsampling(t, None)
            if expect is None and contig:
                expect = _fixup_subsampling(self._blob(s, 0), spp)
            expect = expect or (2, 2)
            if not contig and expect != (1, 1):
                raise CodecError("TIFF YCbCr reader: can not handle planar subsampled format")
        tables = _jpeg_tables(t.entries[347][1]) if 347 in t.entries else []
        per = spp if contig else 1
        planes = 1 if contig else spp
        across, down = self._grid(s)
        out = np.zeros((h, w, spp), np.uint8)
        buffers: dict = {}
        for ty in range(down):  # Pillow's order: rows of chunks, then planes, then across
            if ycc and not contig:  # libtiff's RGBA reader: buffers per strip or tile row
                buffers = {}
            for p in range(planes):
                for tx in range(across):
                    i = p * across * down + ty * across + tx
                    if i >= len(s["offsets"]):
                        raise CodecError("TIFF strip or tile out of range")
                    y0, x0 = ty * ch, tx * cw
                    seg_w, seg_h = (w, min(ch, h - y0)) if s["strips"] else (cw, ch)
                    blob = self._blob(s, i)
                    stream = blob
                    if blob[:2] == b"\xff\xd8":  # the held tables spliced in after SOI
                        stream = blob[:2] + b"".join(tables) + blob[2:]
                    for seg in _jpeg_tables(blob, whole=False):  # a repeat overrides in place
                        if seg in tables:
                            tables.remove(seg)
                        tables.append(seg)
                    jw, jh, factors = _sof(stream)
                    nc = len(factors)
                    tall_last = s["strips"] and jw == seg_w and y0 + seg_h == h
                    if jw > seg_w or (jh > seg_h and not tall_last):
                        raise CodecError("JPEG strip/tile size exceeds expected dimensions")
                    if nc != per:
                        raise CodecError("improper JPEG component count")
                    if factors[0] != (expect if contig else (1, 1)) or any(
                            f != (1, 1) for f in factors[1:]):
                        raise CodecError("improper JPEG sampling factors")
                    try:
                        dec = native.jpeg_decode_bgr(stream, colour="ycbcr" if ycc and contig
                                                     else "none")
                    except ValueError as err:
                        raise CodecError(f"corrupt TIFF JPEG data: {err}") from err
                    if ycc and contig:
                        dec = dec[..., ::-1]
                    # one buffer per plane in libtiff's RGBA reader, one in Pillow's
                    buf = buffers.setdefault(p if ycc and not contig else 0,
                                             np.zeros((min(ch, h) if s["strips"] else ch, cw, per),
                                                      np.uint8))
                    rows = min(jh, seg_h)
                    buf[:rows, :jw] = dec[:rows]
                    rh, rw = min(seg_h, h - y0), min(cw, w - x0)
                    out[y0:y0 + rh, x0:x0 + rw, p:p + per] = buf[:rh, :rw]
        return _ycbcr_to_rgb(out, t) if ycc and not contig else out

    def rgb(self, k: int) -> np.ndarray:
        """Page ``k`` as Pillow's ``convert("RGB")`` gives it after loading:
        (H, W) gray or (H, W, 3) RGB u8, the EXIF orientation applied."""
        v, s = self.samples(k)
        if s["comp"] != "raw" and s["raw"] in _SWAPPED:
            v = v.byteswap()
        img = _convert(v, s, self.pages[k])
        return _orient(img, self.orientation(k))

    def orientation(self, k: int) -> int:
        """The EXIF orientation ``load_end`` applies: tag 274, else the XMP's."""
        t = self.pages[k]
        o = t.get(274)
        if o is None and 700 in t.entries:
            m = re.search(XMP_ORIENTATION, t.entries[700][1])
            o = int(m[2]) if m else None
        return o if isinstance(o, int) else 1


def _subsampling(page: _Page, default=(2, 2)):
    """YCbCrSubsampling (tag 530) as libtiff holds it: ``default`` where
    the tag is missing or has not two values."""
    v = page.get(530)
    return tuple(v) if isinstance(v, tuple) and len(v) == 2 else default


def _ycbcr_to_rgb(v: np.ndarray, page: _Page) -> np.ndarray:
    """libtiff's YCbCr → RGB of (H, W, 3) samples with the page's
    YCbCrCoefficients (tag 529, three values) and ReferenceBlackWhite (532,
    six values); a tag of another count is ignored, as libtiff ignores it."""
    from .. import native

    luma, ref = page.get(529), page.get(532)
    luma = luma if isinstance(luma, tuple) and len(luma) == 3 else (0.299, 0.587, 0.114)
    ref = ref if isinstance(ref, tuple) and len(ref) == 6 else (0, 255, 128, 255, 128, 255)
    try:
        return native.tiff_ycbcr_to_rgb(v, luma, ref)
    except ValueError as err:
        raise CodecError(f"TIFF YCbCr reader: {err}") from err


_MARKER = re.compile(rb"\xff[^\x00\xd0-\xd7\xff]")  # a marker in entropy-coded data


def _jpeg_tables(data: bytes, whole: bool = True) -> List[bytes]:
    """The DQT and DHT segments of a JPEG stream, in order: what libjpeg
    keeps from one image to the next (DRI, DAC and the rest start again at
    each SOI). ``whole``: a JPEGTables field, which must be a tables-only
    stream (SOI, tables, EOI), else libtiff's "Bogus JPEGTables field"."""
    out: List[bytes] = []
    if data[:2] != b"\xff\xd8":
        if whole:
            raise CodecError("bogus JPEGTables field")
        return out
    p = 2
    while p + 4 <= len(data):
        if data[p] != 0xFF:
            break
        m = data[p + 1]
        if m == 0xFF:  # fill byte
            p += 1
            continue
        if m == 0xD9:
            return out
        n = struct.unpack(">H", data[p + 2:p + 4])[0]
        if m in (0xDB, 0xC4):
            out.append(data[p:p + 2 + n])
        elif whole and m in (0xDA, 0xC0, 0xC1, 0xC2, 0xC3, 0xC9, 0xCA, 0xCB):
            raise CodecError("bogus JPEGTables field")
        p += 2 + n
        if m == 0xDA:  # past the scan's entropy-coded data to its next marker
            found = _MARKER.search(data, p)
            if found is None:
                break
            p = found.start()
    return out  # cut short: libtiff's source ends it with a fake EOI


def _sof(stream: bytes) -> Tuple[int, int, List[Tuple[int, int]]]:
    """(width, height, each component's (h, v)) as a JPEG's frame header
    gives them (libjpeg's ``comp_info``, which libtiff checks, a lone
    component's factors too); CodecError where there is none."""
    p = 2 if stream[:2] == b"\xff\xd8" else len(stream)
    while p + 4 <= len(stream) and stream[p] == 0xFF:
        m = stream[p + 1]
        if m == 0xFF:
            p += 1
            continue
        n = struct.unpack(">H", stream[p + 2:p + 4])[0]
        if 0xC0 <= m <= 0xCF and m not in (0xC4, 0xC8, 0xCC):
            head = stream[p + 5:p + 10]
            if len(head) == 5:
                h, w, nc = struct.unpack(">HHB", head)
                f = stream[p + 11:p + 11 + 3 * nc:3]
                if len(f) == nc:
                    return w, h, [(b >> 4, b & 15) for b in f]
            break
        p += 2 + n
    raise CodecError("corrupt TIFF JPEG data: no frame header")


def _fixup_subsampling(blob: bytes, spp: int) -> Optional[Tuple[int, int]]:
    """libtiff's JPEGFixupTagsSubsampling: the luma factors of the first
    strip's or tile's frame header, where its other components are 1x1 and
    both factors are 1, 2 or 4; None where it gives up (the default 2x2
    stays)."""
    p = 0
    while True:
        p = blob.find(b"\xff", p)
        if p < 0:
            return None
        while p < len(blob) and blob[p] == 0xFF:
            p += 1
        if p >= len(blob):
            return None
        m = blob[p]
        p += 1
        if m == 0xD8:
            continue
        if m in (0xFE, 0xDB, 0xDA, 0xC4, 0xDD) or 0xE0 <= m <= 0xEF:
            if p + 2 > len(blob):
                return None
            n = struct.unpack(">H", blob[p:p + 2])[0]
            if n < 2:
                return None
            p += n
            continue
        if m not in (0xC0, 0xC1, 0xC2, 0xC9, 0xCA):
            return None
        sof = blob[p:p + 2 + 8 + 3 * spp]
        if len(sof) < 2 + 8 + 3 * (spp - 1) or struct.unpack(">H", sof[:2])[0] != 8 + 3 * spp:
            return None
        ph, pv = sof[9] >> 4, sof[9] & 15
        if any(sof[9 + 3 * o] != 0x11 for o in range(1, spp)):
            return None
        if ph not in (1, 2, 4) or pv not in (1, 2, 4):
            return None
        return ph, pv


_REVERSED = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def _reverse_bits(a: np.ndarray) -> np.ndarray:
    """Fill order 2: each byte's bits in reverse order."""
    return _REVERSED[a]


def _dtype(raw: str, bits: int, e: str) -> np.dtype:
    if bits <= 8:
        return np.dtype(np.uint8)
    if bits == 16:
        return np.dtype(e + ("i2" if raw.startswith("I;16") and raw.endswith("S") else "u2"))
    if raw.startswith("F"):
        return np.dtype(e + "f4")
    return np.dtype(e + "i4")  # Pillow's I;32N and I;32S: both read as signed


def _unpack(rows: np.ndarray, width: int, per: int, bits: int, dtype: np.dtype) -> np.ndarray:
    """Rows of packed samples → (rows, width, per) values (sub-byte
    samples MSB first, each row starting on a byte)."""
    n = rows.shape[0]
    if bits < 8:
        shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
        v = (rows[:, :, None] >> shifts) & ((1 << bits) - 1)
        return v.reshape(n, -1)[:, :width * per].reshape(n, width, per)
    nb = bits // 8
    v = np.ascontiguousarray(rows[:, :width * per * nb]).view(dtype)
    return v.astype(dtype.newbyteorder("=")).reshape(n, width, per)


def _undo_predictor(v: np.ndarray) -> np.ndarray:
    """Horizontal differencing undone along each row, sample by sample,
    modulo 2^bits (libtiff's ``horAcc``): a float page on its words."""
    if v.dtype.kind == "f":
        u = v.view(np.uint32)
        return np.cumsum(u, axis=1, dtype=np.uint32).view(np.float32)
    unsigned = v.dtype.kind == "i"
    u = v.view(v.dtype.str.replace("i", "u")) if unsigned else v
    acc = np.cumsum(u, axis=1, dtype=u.dtype)
    return acc.view(v.dtype) if unsigned else acc


def _convert(v: np.ndarray, s: dict, page: _Page) -> np.ndarray:
    """Samples in mode ``s["mode"]`` (raw mode ``s["raw"]``) → Pillow's
    ``convert("RGB")``: (H, W) gray or (H, W, 3) RGB u8."""
    mode, raw, bits = s["mode"], s["raw"], s["bits"][0]
    inverted = raw.startswith(("1;I", "L;2I", "L;4I", "L;I"))
    if mode in ("1", "L"):
        g = v[..., 0].astype(np.int32)
        scale = 255 // ((1 << bits) - 1) if bits < 8 else 1
        g = g * scale
        return (255 - g if inverted else g).astype(np.uint8)
    if mode in ("I;16", "I;16B", "I"):
        return np.clip(v[..., 0].astype(np.int64), 0, 255).astype(np.uint8)
    if mode == "F":
        f = np.nan_to_num(v[..., 0].astype(np.float64), nan=0.0, posinf=255.0, neginf=0.0)
        return np.clip(np.trunc(f), 0, 255).astype(np.uint8)
    if bits == 16:  # Pillow's ;16L / ;16B unpackers keep each sample's high byte
        v = (v >> 8).astype(np.uint8)
    if mode == "LA":
        return v[..., 0].astype(np.uint8)
    if mode in ("P", "PA"):
        cmap = page.get(320)
        if cmap is None:
            raise CodecError("palette TIFF without a colour map")
        n = len(cmap) // 3
        pal = np.zeros((256, 3), np.uint8)
        cm = (np.asarray(cmap[:3 * n], np.int64) // 256).astype(np.uint8).reshape(3, n).T
        pal[:min(n, 256)] = cm[:256]
        return pal[v[..., 0]]
    if mode == "CMYK":  # Pillow's formula, the one copy the JPEG decode uses too
        from .. import native

        return native.cmyk_to_rgb(v[..., :4])
    rgb = v[..., :3].astype(np.int32)
    if raw.startswith("RGBa"):  # associated alpha: Pillow un-premultiplies
        a = v[..., 3:4].astype(np.int32)
        un = np.clip(rgb * 255 // np.maximum(a, 1), 0, 255)
        rgb = np.where(a == 0, 0, np.where(a == 255, rgb, un))
    return rgb.astype(np.uint8)


def _orient(img: np.ndarray, o: int) -> np.ndarray:
    """``ImageOps.exif_transpose`` of orientation ``o``."""
    t = (1, 0) + tuple(range(2, img.ndim))
    if o == 2:
        img = img[:, ::-1]
    elif o == 3:
        img = img[::-1, ::-1]
    elif o == 4:
        img = img[::-1]
    elif o == 5:
        img = img.transpose(t)
    elif o == 6:
        img = np.rot90(img, -1)
    elif o == 7:
        img = img.transpose(t)[::-1, ::-1]
    elif o == 8:
        img = np.rot90(img, 1)
    return np.ascontiguousarray(img)


def read_pages(data: bytes) -> List[np.ndarray]:
    """Every page as Pillow reads it: (H, W) gray or (H, W, 3) RGB u8. Each
    page is set up before any is decoded, as ``n_frames`` sets them up."""
    t = Tiff(data)
    for k in range(len(t)):
        t.setup(k)
    return [t.rgb(k) for k in range(len(t))]


def read_tiff(data: bytes) -> np.ndarray:
    """The first page, as ``Image.open(...).convert("RGB")`` reads it."""
    return Tiff(data).rgb(0)


def count(data: bytes) -> int:
    """Pillow's ``n_frames``: the pages, each set up."""
    t = Tiff(data)
    for k in range(len(t)):
        t.setup(k)
    return len(t)


def tiff_info(data: bytes) -> dict:
    """Pillow's ``info`` after ``Image.open``: ``compression`` by Pillow's
    name, and ``dpi`` and ``resolution`` as tuples (left out of the
    reference's metadata, as the XMP and ICC bytes are)."""
    t = Tiff(data)
    s = t.setup(0)
    page = t.pages[0]
    info: dict = {}
    if 700 in page.entries:
        info["xmp"] = page.entries[700][1]
    info["compression"] = s["comp"]
    xres, yres = page.get(282, 1), page.get(283, 1)
    if isinstance(xres, tuple):
        xres = xres[0]
    if isinstance(yres, tuple):
        yres = yres[0]
    if xres and yres:
        unit = page.get(296)
        if unit == 2:
            info["dpi"] = (xres, yres)
        elif unit == 3:
            info["dpi"] = (xres * 2.54, yres * 2.54)
        elif unit is None:
            info["dpi"] = (xres, yres)
            info["resolution"] = (xres, yres)
        else:
            info["resolution"] = (xres, yres)
    if 34675 in page.entries:
        info["icc_profile"] = page.entries[34675][1]
    return info


# -- the writer ------------------------------------------------------------------

# Pillow's SAVE_INFO for the modes Image.fromarray makes of a u8 Mat:
# channels → (photometric, bits, extra samples)
_SAVE = {1: (1, (8,), None), 2: (1, (8, 8), 2), 3: (2, (8, 8, 8), None),
         4: (2, (8, 8, 8, 8), 2)}


def _entry(tag: int, typ: int, values, pos: int, tail: bytearray) -> bytes:
    """One 12-byte IFD entry; a value longer than 4 bytes goes to ``tail``
    (which starts at ``pos`` in the file)."""
    body = struct.pack(f"<{len(values)}{'H' if typ == 3 else 'L'}", *values)
    if len(body) <= 4:
        return struct.pack("<HHL", tag, typ, len(values)) + body.ljust(4, b"\x00")
    at = pos + len(tail)
    tail += body
    return struct.pack("<HHLL", tag, typ, len(values), at)


def write_tiff(pages: List[np.ndarray]) -> bytes:
    """u8 pages, each (H, W) gray, (H, W, 2) gray + alpha, (H, W, 3) RGB or
    (H, W, 4) RGBA in the channel order given → an uncompressed TIFF, one
    strip per page, as Pillow's ``_save`` writes it (little-endian). Pages
    after the first are laid out as Pillow's ``AppendingTiffWriter`` appends
    them: each starts on 16 bytes with a TIFF header of its own, which the
    IFD chain skips, and a file of several pages ends on 16 bytes."""
    if not pages:
        raise CodecError("no pages to write")
    out = bytearray()
    link = None  # where the next IFD's offset goes
    for img in pages:
        img = np.ascontiguousarray(img)
        if img.dtype != np.uint8:
            raise not_ported(f"writing {img.dtype} images as TIFF", item=LEFTOVERS)
        ch = 1 if img.ndim == 2 else img.shape[2]
        if ch not in _SAVE:
            raise CodecError(f"cannot write {ch}-channel images as TIFF")
        photo, bits, extra = _SAVE[ch]
        h, w = img.shape[:2]
        out += bytes(-len(out) % 16) + b"II*\x00\x08\x00\x00\x00"
        ifd_at = len(out)
        if link is not None:
            struct.pack_into("<L", out, link, ifd_at)
        tags = {256: (4, (w,)), 257: (4, (h,)), 258: (3, bits), 259: (3, (1,)),
                262: (3, (photo,)), 273: (4, (0,)), 278: (4, (h,)), 279: (4, (w * h * ch,)),
                284: (3, (1,))}
        if ch > 1:
            tags[277] = (3, (ch,))
        if extra is not None:
            tags[338] = (3, (extra,))
        n = len(tags)
        tail_at = ifd_at + 2 + 12 * n + 4
        width = {3: 2, 4: 4}
        tail_len = sum(len(v) * width[t] for t, v in tags.values() if len(v) * width[t] > 4)
        tags[273] = (4, (tail_at + tail_len,))
        body, tail = bytearray(struct.pack("<H", n)), bytearray()
        for tag in sorted(tags):
            body += _entry(tag, *tags[tag], tail_at, tail)
        link = ifd_at + len(body)
        out += body + b"\x00\x00\x00\x00" + tail
        out += img.tobytes()
    if len(pages) > 1:
        out += bytes(-len(out) % 16)
    return bytes(out)
