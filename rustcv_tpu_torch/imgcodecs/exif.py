"""Image metadata without Pillow: the EXIF tags of IFD0 and Pillow's
``info``, as the reference reports them (``imread_with_metadata``,
``cv2.imreadWithMetadata``, ``cv2.imdecodeWithMetadata``).

The reference takes ``{str(k): str(v)}`` of Pillow's ``info`` after
``Image.open`` where the value is a str, int or float (tuples and bytes are
left out), then ``exif:<tag>`` for each item of ``getexif()``. This module
gives the same dict, in the same order:

* ``info``: for PNG the chunks before the image data (``interlace``,
  ``gamma``, ``srgb``, ``transparency``, the text chunks; of an animated
  PNG acTL's ``loop``, the first fcTL's ``duration``, ``disposal`` and
  ``blend``, and ``default_image``); for JPEG the
  markers before the first scan (``jfif``, ``jfif_unit``, ``adobe``,
  ``adobe_transform``, ``progressive``, ``progression``); for BMP
  ``compression``; for PFM ``scale``; for TIFF ``compression`` by Pillow's
  name; for GIF ``background``, ``loop``, ``transparency`` and the first
  frame's ``duration``; for WebP ``loop`` and ``background`` (and the
  ``icc_profile``, ``exif`` and ``xmp`` chunks, which are bytes)
  (``imgcodecs.host``, :func:`jpeg_info`, ``imgcodecs.tiff.tiff_info``,
  ``imgcodecs.gif.gif_info``, ``imgcodecs.webp.webp_info``);
* EXIF: a TIFF-structured IFD0 from a JPEG's APP1 ``Exif\\0\\0``, a PNG's
  ``eXIf`` or its ``Raw profile type exif`` text (read from the chunks
  after the image data too, as ``getexif()`` loads the image first), a
  WebP's ``EXIF`` chunk (with or without its ``Exif\\0\\0`` prefix), a
  TIFF file's own first IFD (BigTIFF too); read
  as Pillow's ``ImageFileDirectory_v2`` reads it: a scalar for one value
  (and for a tag the TIFF tables give one value) and a tuple otherwise,
  ASCII without its NUL, rationals as ``IFDRational`` prints them,
  UNDEFINED and BYTE as bytes, the Exif and GPS pointers as ints; an XMP
  ``tiff:Orientation`` gives 0x0112 where IFD0 has none. Pillow iterates
  the tags as a Python set of ints, and so does this module, built the
  way Pillow builds it; a JPEG without a density reads its resolution
  tags first (Pillow's ``_read_dpi_from_exif``), which moves them ahead.
"""

from __future__ import annotations

import re
import struct
from typing import List, Optional, Tuple

from ..core.errors import not_ported
from . import host as _host
from .tiff import ONE_VALUE, TYPES, XMP_ORIENTATION, directory

# The names of values in Pillow's tag table (TiffTags.TAGS_V2), which an ASCII
# value of these tags becomes.
_ENUMS = {
    259: {"Uncompressed": 1, "CCITT 1d": 2, "Group 3 Fax": 3, "Group 4 Fax": 4, "LZW": 5,
          "JPEG": 6, "PackBits": 32773},
    262: {"WhiteIsZero": 0, "BlackIsZero": 1, "RGB": 2, "RGB Palette": 3, "Transparency Mask": 4,
          "CMYK": 5, "YCbCr": 6, "CieLAB": 8, "CFA": 32803, "LinearRaw": 32892},
    284: {"Contiguous": 1, "Separate": 2},
    296: {"none": 1, "inch": 2, "cm": 3},
    317: {"none": 1, "Horizontal Differencing": 2},
    50741: {"Unsafe": 0, "Safe": 1},
}
ORIENTATION, RESOLUTION_UNIT, X_RESOLUTION = 0x0112, 0x0128, 0x011A


class _Rational:
    """A TIFF rational as Pillow's ``IFDRational`` prints it."""

    __slots__ = ("num", "den")

    def __init__(self, num: int, den: int):
        self.num, self.den = num, den

    def __repr__(self) -> str:
        return "nan" if self.den == 0 else str(self.num / self.den)

    __str__ = __repr__


class _BadHeader(Exception):
    """EXIF whose TIFF header Pillow cannot read: ``getexif()`` raises."""


def _ifd0(data: bytes) -> Tuple[dict, str]:
    """IFD0 of TIFF-structured EXIF: {tag: (type, value bytes)} in the
    directory's order, as Pillow's ``ImageFileDirectory_v2.load`` keeps it
    (a truncated directory keeps the entries before the cut)."""
    head = data[:8]
    if head[:4] not in _host.TIFF_PREFIXES:
        raise _BadHeader("not a TIFF header")
    if head[2] == 43:  # BigTIFF: Pillow's 8-byte read of its header fails
        raise _BadHeader("BigTIFF header")
    e = ">" if head[:2] == b"MM" else "<"
    if len(head) < 8:
        raise _BadHeader("short TIFF header")
    return directory(data, struct.unpack(e + "L", head[4:8])[0], e, False)[0], e


def _value(tag: int, typ: int, raw: bytes, e: str):
    """One tag's value as ``Exif.__getitem__`` gives it."""
    if typ in (1, 7):
        return raw
    if typ == 2:
        text = (raw[:-1] if raw.endswith(b"\x00") else raw).decode("latin-1", "replace")
        return _ENUMS.get(tag, {}).get(text, text)
    size, fmt = TYPES[typ]
    if typ in (5, 10):
        v = struct.unpack(f"{e}{len(raw) // 4}{fmt}", raw)
        vals = tuple(_Rational(a, b) for a, b in zip(v[::2], v[1::2]))
    else:
        vals = struct.unpack(f"{e}{len(raw) // size}{fmt}", raw)
    return vals[0] if tag in ONE_VALUE or len(vals) == 1 else vals


def exif_entries(exif, xmp=None, read_first=(), ifd=None) -> List[Tuple[int, str]]:
    """``[(tag, str(value))]`` of ``getexif().items()``, in Pillow's order.

    ``exif``: the EXIF bytes (a leading ``Exif\\0\\0`` is dropped) or None;
    ``xmp``: the XMP packet (str or bytes) or None; ``read_first``: tags
    read before the items (in order, up to the first absent one), which
    Pillow keeps apart from the directory's and so iterates first; ``ifd``:
    a directory already read, ({tag: (type, bytes)}, byte order), in place
    of ``exif`` (a TIFF file's own)."""
    found: dict = {}  # Pillow's Exif._data: values already read
    entries, e = ifd if ifd is not None else ({}, "<")
    entries = dict(entries)
    if exif is not None:
        if not isinstance(exif, bytes):
            return []
        while exif.startswith(b"Exif\x00\x00"):
            exif = exif[6:]
        if exif:
            try:
                entries, e = _ifd0(exif)
            except _BadHeader:
                return []
    if ORIENTATION not in entries and xmp:
        m = re.search(XMP_ORIENTATION.decode() if isinstance(xmp, str) else XMP_ORIENTATION, xmp)
        if m:
            found[ORIENTATION] = int(m[2])
    for tag in read_first:
        if tag in found:
            continue
        if tag not in entries:
            break
        found[tag] = _value(tag, *entries.pop(tag), e)
    # Pillow: set(_data), then update() from an iterator over set(_tagdata) |
    # set(_tags_v2): element by element, which sets the iteration order
    keys = set(found)
    keys.update(iter(set(entries) | set()))
    return [(k, str(found[k] if k in found else _value(k, *entries[k], e))) for k in keys]


def jpeg_info(data: bytes) -> dict:
    """Pillow's ``info`` of a JPEG after ``Image.open``: what its marker
    handlers put there up to the first scan, read byte by byte as
    ``JpegImageFile._open`` reads (``dpi`` from EXIF aside: a tuple, which
    the metadata leaves out)."""
    data = bytes(data)
    if not data.startswith(b"\xff\xd8\xff"):
        raise _host.CodecError("not a JPEG file")
    info: dict = {}
    i16 = lambda b, o=0: struct.unpack(">H", b[o:o + 2])[0]  # noqa: E731
    p, cur = 3, 0xFF
    try:
        while True:
            if cur != 0xFF:  # junk between segments
                cur, p = data[p], p + 1
                continue
            code, p = 0xFF00 | data[p], p + 1
            if code == 0xFFFF:
                continue
            if code == 0xFF00:
                cur, p = data[p], p + 1
                continue
            if code < 0xFFC0:
                raise _host.CodecError("no JPEG marker found")
            m = code & 0xFF
            if not (m == 0xC8 or 0xD0 <= m <= 0xD9 or 0xF0 <= m <= 0xFD):  # it has a length
                n = i16(data, p) - 2
                s = data[p + 2:p + 2 + n]
                if len(s) < n:
                    raise _host.CodecError("truncated JPEG marker segment")
                p += 2 + max(n, 0)
                if m == 0xE0 and s.startswith(b"JFIF"):
                    info["jfif"] = i16(s, 5)
                    info["jfif_version"] = divmod(info["jfif"], 256)
                    if len(s) >= 12:
                        unit, density = s[7], (i16(s, 8), i16(s, 10))
                        if unit in (1, 2):
                            info["dpi"] = density if unit == 1 else tuple(d * 2.54 for d in density)
                        info["jfif_unit"], info["jfif_density"] = unit, density
                elif m == 0xE1 and s.startswith(b"Exif\x00\x00"):
                    info["exif"] = info["exif"] + s[6:] if "exif" in info else s
                elif m == 0xE1 and s.startswith(b"http://ns.adobe.com/xap/1.0/\x00"):
                    info["xmp"] = s.split(b"\x00", 1)[1]
                elif m == 0xE2 and s.startswith(b"MPF\x00"):
                    raise not_ported("the metadata of multi-picture (MPO) JPEG files",
                                     item=_host.LEFTOVERS)
                elif m == 0xEE and s.startswith(b"Adobe"):
                    info["adobe"] = i16(s, 5)
                    if len(s) > 11:
                        info["adobe_transform"] = s[11]
                elif m == 0xFE:
                    info["comment"] = s
                elif 0xC0 <= m <= 0xCF and m not in (0xC4, 0xCC):  # Pillow's SOF handler
                    if s[0] != 8:
                        raise _host.CodecError(f"cannot handle {s[0]}-bit layers")
                    if s[5] not in (1, 3, 4):
                        raise _host.CodecError(f"cannot handle {s[5]}-layer images")
                    if m in (0xC2, 0xC6, 0xCA, 0xCE):
                        info["progressive"] = info["progression"] = 1
                elif m == 0xDA:
                    return info
            cur, p = data[p], p + 1
    except (IndexError, struct.error) as e:  # the file ends before its first scan
        raise _host.CodecError("truncated JPEG header") from e


def _shown(info: dict) -> dict:
    """The reference's filter of ``info``: str, int and float values, as str."""
    return {str(k): str(v) for k, v in info.items() if isinstance(v, (str, int, float))}


def _parts(data: bytes):
    """(info after Image.open, info when getexif() runs, tags read first)."""
    fmt = _host.sniff(data)
    if fmt == "png":
        from .apng import png_info

        info, late = png_info(data)
        return info, (info if "exif" in info else {**info, **late}), ()
    if fmt == "jpeg":
        info = jpeg_info(data)
        first = (RESOLUTION_UNIT, X_RESOLUTION) if "exif" in info and "dpi" not in info else ()
        return info, info, first
    if fmt == "tiff":
        from .tiff import tiff_info

        info = tiff_info(data)
        return info, info, ()
    if fmt == "gif":
        from .gif import gif_info

        info = gif_info(data)
        return info, info, ()
    if fmt == "webp":
        from .webp import webp_info

        info = webp_info(data)
        return info, info, ()
    info = _host.bmp_info(data) if fmt == "bmp" else _host.pnm_info(data)
    return info, info, ()


def info_metadata(data: bytes) -> dict:
    """Pillow's ``info`` as the reference's ``imdecodeWithMetadata`` shows
    it: str, int and float values as str, no EXIF."""
    return _shown(_parts(bytes(data))[0])


def metadata(data: bytes) -> dict:
    """The reference's ``imread_with_metadata`` dict of an image file:
    :func:`info_metadata`, then ``exif:<tag>`` for each EXIF tag."""
    data = bytes(data)
    info, at_exif, first = _parts(data)
    meta = _shown(info)
    if _host.sniff(data) == "tiff":  # getexif() reads the file's own first IFD
        from . import tiff

        t = tiff.Tiff(data)
        page = t.pages[0]
        for tag, value in exif_entries(None, info.get("xmp"), ifd=(page.entries, t.e)):
            meta[f"exif:{tag}"] = value
        return meta
    exif = at_exif.get("exif")
    if exif is None and "Raw profile type exif" in at_exif:
        try:
            exif = bytes.fromhex("".join(at_exif["Raw profile type exif"].split("\n")[3:]))
        except (ValueError, TypeError):  # getexif() raises: the reference shows no tags
            return meta
    xmp: Optional[object] = at_exif.get("XML:com.adobe.xmp") or at_exif.get("xmp")
    for tag, value in exif_entries(exif, xmp, first):
        meta[f"exif:{tag}"] = value
    return meta
