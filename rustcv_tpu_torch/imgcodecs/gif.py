"""GIF without Pillow: what the reference's Pillow 12 reads and writes, for
:mod:`rustcv_tpu_torch.imgcodecs`.

A read gives each frame as ``ImageSequence`` then ``convert("RGB")`` gives
it, byte for byte, under Pillow's default ``RGB_AFTER_FIRST`` strategy:
GIF87a and GIF89a, global and local palettes (a palette that is the gray
ramp is no palette to Pillow: the frame is ``L``), interlaced frames,
frame offsets (a frame past the screen grows it), the graphic control
extension (transparency, disposal 0-3, duration; a frame without disposal
bits keeps the last one's), the NETSCAPE loop and comments. The first frame
is a palette image; each later one is composited in RGB over the one
before exactly as ``GifImageFile._seek``, ``load_prepare`` and ``load_end``
do: what disposal 2 paints (the transparent index first, else the
background, in the frame's palette), what disposal 3 restores, how a
transparent index on the first frame converts. :func:`gif_info` is
Pillow's ``info`` after ``Image.open``.

A write is Pillow's ``_save`` / ``_write_multiple_frames`` with its
defaults (``optimize``, no palette given): a gray frame keeps its used
grays as its palette; an RGB frame goes through Pillow's median cut
(:mod:`.quantize`: Pillow's palette and indices; a frame of at most 256
colours keeps them, in the cut's order); frames equal
after quantization merge and add their durations; each later frame is
cropped to where it differs from the one before, with a local palette and,
where the palette has room, a transparent index over the pixels that did
not change; duration in centiseconds (``int(ms / 10)``), the NETSCAPE loop
only when a loop is given; a lone frame interlaced when both sides are at
least 16 pixels. The LZW loops are ``native/lzw.cpp``'s.
"""

from __future__ import annotations

import struct
from typing import List, Optional

import numpy as np

from ..core.errors import not_ported
from .host import LEFTOVERS, CodecError

_HEADS = (b"GIF87a", b"GIF89a")


def _palette_needed(p: bytes) -> bool:
    """Pillow's ``_is_palette_needed``: False for the gray ramp 0, 1, 2, ..."""
    return any(not (i // 3 == p[i] == p[i + 1] == p[i + 2]) for i in range(0, len(p) - 2, 3))


class _Frame:
    """One image descriptor and the blocks before it."""

    def __init__(self):
        self.transparency = self.duration = self.comment = None
        self.disposal_bits = 0
        self.extent = self.palette = self.data = None
        self.interlace, self.bits, self.truncated = False, 8, False


class _Reader:
    """Pillow's ``GifImageFile.data``: one sub-block, or None at a
    terminator (which it consumes) or at the end of the file."""

    def __init__(self, data: bytes, p: int):
        self.d, self.p = data, p

    def byte(self) -> Optional[int]:
        if self.p >= len(self.d):
            return None
        self.p += 1
        return self.d[self.p - 1]

    def block(self) -> Optional[bytes]:
        size = self.byte()
        if not size:
            return None
        self.p += size
        return self.d[self.p - size:self.p]


def _frames(data: bytes, start: int, info: dict) -> List[_Frame]:
    """Every frame's blocks, as ``_seek`` parses them (``info`` gets the
    NETSCAPE loop, read on the first frame only)."""
    out: List[_Frame] = []
    r = _Reader(data, start)
    while True:
        f = _Frame()
        while True:
            c = r.byte()
            if c is None or c == 0x3B:
                return out
            if c == 0x21:  # an extension
                label = r.byte()
                block = r.block()
                if label == 0xF9 and block is not None:
                    flags = block[0]
                    if flags & 1:
                        f.transparency = block[3]
                    f.duration = struct.unpack("<H", block[1:3])[0] * 10
                    f.disposal_bits = (flags & 0b11100) >> 2
                elif label == 0xFE:
                    comment = b""
                    while block:
                        comment += block
                        block = r.block()
                    f.comment = comment if f.comment is None else f.comment + b"\n" + comment
                    continue
                elif label == 0xFF and not out and block is not None:
                    if block.startswith(b"NETSCAPE2.0"):
                        block = r.block()
                        if block and len(block) >= 3 and block[0] == 1:
                            info["loop"] = struct.unpack("<H", block[1:3])[0]
                while r.block():
                    pass
            elif c == 0x2C:  # an image descriptor
                d = data[r.p:r.p + 9]
                if len(d) < 9:
                    raise CodecError("truncated GIF image descriptor")
                r.p += 9
                x0, y0, w, h, flags = struct.unpack("<HHHHB", d)
                f.extent = (x0, y0, x0 + w, y0 + h)
                f.interlace = bool(flags & 64)
                if flags & 128:
                    size = 3 << ((flags & 7) + 1)
                    pal = data[r.p:r.p + size]
                    r.p += size
                    f.palette = pal if _palette_needed(pal) else False
                bits = r.byte()
                if bits is None:
                    raise CodecError("truncated GIF image data")
                f.bits = bits
                parts = []
                while True:
                    size = r.byte()
                    if size is None:
                        f.truncated = True
                        break
                    if size == 0:
                        break
                    parts.append(data[r.p:r.p + size])
                    if r.p + size > len(data):
                        f.truncated = True
                    r.p += size
                f.data = b"".join(parts)
                out.append(f)
                break
            # any other byte is skipped, as Pillow skips it


def _header(data: bytes):
    data = bytes(data)
    if data[:6] not in _HEADS or len(data) < 13:
        raise CodecError("not a GIF file")
    w, h, flags, background = struct.unpack("<HHBB", data[6:12])
    info = {"version": data[:6]}
    palette = None
    if flags & 128:
        info["background"] = background
        p = data[13:13 + (3 << ((flags & 7) + 1))]
        if _palette_needed(p):
            palette = p
    return data, (w, h), info, palette


def _rgb_table(palette) -> np.ndarray:
    """A palette's 256 entries as Pillow's P image holds them: the entries
    given, black past them."""
    pal = np.zeros((256, 3), np.uint8)
    if palette:
        n = min(256, len(palette) // 3)
        pal[:n] = np.frombuffer(palette, np.uint8, n * 3).reshape(n, 3)
    return pal


class Gif:
    """A parsed GIF: Pillow's ``info`` after ``Image.open``, the frames."""

    def __init__(self, data: bytes):
        self.data, self.size, self.info, self.global_palette = _header(data)
        loop: dict = {}
        flags = self.data[10]
        self.frames = _frames(self.data, 13 + ((3 << ((flags & 7) + 1)) if flags & 128 else 0),
                              loop)
        if not self.frames:
            raise CodecError("image not found in GIF frame")
        first = self.frames[0]
        if "loop" in loop:
            self.info["loop"] = loop["loop"]
        if first.transparency is not None:
            self.info["transparency"] = first.transparency
        if first.comment:
            self.info["comment"] = first.comment
        if first.duration is not None:
            self.info["duration"] = first.duration

    def __len__(self) -> int:
        return len(self.frames)

    def durations(self) -> List[Optional[int]]:
        """Each frame's ``info["duration"]`` (None where it has no graphic
        control extension)."""
        return [f.duration for f in self.frames]

    def _indices(self, f: _Frame) -> np.ndarray:
        """The frame's colour indices in stream order."""
        from .. import native

        x0, y0, x1, y1 = f.extent
        w, h = x1 - x0, y1 - y0
        if not 1 <= f.bits <= 8:
            raise not_ported(f"GIF LZW minimum code size {f.bits}", item=LEFTOVERS)
        got = native.gif_lzw_decode(f.data, f.bits, w * h)
        if f.truncated and got.size < w * h:  # Pillow's load of a cut frame raises
            raise CodecError("GIF image file is truncated")
        return got

    def rgb_frames(self) -> List[np.ndarray]:
        """Every frame as Pillow's ``ImageSequence`` and ``convert("RGB")``
        give it: (H, W, 3) u8, or (H, W) for a GIF without palettes."""
        out = []
        size = list(self.size)
        mode = None
        im = None  # the canvas: indices (P, L) or RGB
        im_palette = None  # the palette of a P canvas
        info_trans = None  # info["transparency"] while the canvas is P
        disposal_method = 0
        dispose = None  # (patch, extent) pasted before the next frame
        for k, f in enumerate(self.frames):
            x0, y0, x1, y1 = f.extent
            if x1 > size[0] or y1 > size[1]:
                size = [max(x1, size[0]), max(y1, size[1])]
            if f.disposal_bits:
                disposal_method = f.disposal_bits
            if dispose is not None:
                _paste(im, *dispose)
            frame_palette = f.palette if f.palette is not None else self.global_palette
            if k == 0:
                mode = "P" if frame_palette else "L"
                im_palette = frame_palette if frame_palette else None
            elif mode == "P":
                table = _rgb_table(im_palette)
                im = table[im]
                mode = "RGB"
                info_trans = None
            elif mode == "L" and frame_palette:
                raise not_ported("a GIF frame with a palette after one without", item=LEFTOVERS)
            tr = f.transparency
            if k == 0:
                info_trans = tr

            def color_of(c):
                if frame_palette:
                    if c * 3 + 3 > len(frame_palette):
                        c = 0
                    return np.frombuffer(frame_palette[c * 3:c * 3 + 3], np.uint8)
                return np.array([c, c, c], np.uint8)

            dispose = None
            ew, eh = x1 - x0, y1 - y0
            if disposal_method == 2:
                color = info_trans if info_trans is not None else tr
                if color is None:
                    color = self.info.get("background", 0)
                patch = (np.full((eh, ew), color, np.uint8) if mode in ("P", "L")
                         else np.broadcast_to(color_of(color), (eh, ew, 3)).copy())
                dispose = (patch, f.extent)
            elif disposal_method == 3:
                if im is not None:
                    dispose = (_crop(im, f.extent), f.extent)
                elif tr is not None:
                    patch = (np.full((eh, ew), tr, np.uint8) if mode in ("P", "L")
                             else np.broadcast_to(color_of(tr), (eh, ew, 3)).copy())
                    dispose = (patch, f.extent)

            idx = self._indices(f)
            H, W = size[1], size[0]
            if k == 0:
                im = np.full((H, W), tr if tr is not None else 0, np.uint8)
                _decode_into(im, idx, f, -1, f.extent[:2])
            elif mode == "L":
                if im.shape != (H, W):
                    im = _grown(im, H, W, np.zeros(1, np.uint8))
                _decode_into(im, idx, f, -1 if tr is None else tr, f.extent[:2])
            else:  # RGB: the frame decoded on its own, then pasted where not transparent
                sub = np.full((y1 - y0, x1 - x0), (tr or 0) if frame_palette else 0, np.uint8)
                _decode_into(sub, idx, f, -1, (0, 0))
                table = _rgb_table(frame_palette if frame_palette else None)
                rgb = table[sub] if frame_palette else np.repeat(sub[..., None], 3, axis=2)
                if im.shape[:2] != (H, W):  # the screen grew: black, or the palette's first colour
                    im = _grown(im, H, W, np.zeros(3, np.uint8) if tr is not None else table[0])
                im = im.copy()
                region = im[y0:y1, x0:x1]
                region[...] = rgb if tr is None else np.where((sub == tr)[..., None], region, rgb)
            out.append(_rgb_table(im_palette)[im] if mode == "P" else im.copy())
        return out


def _crop(im: np.ndarray, extent) -> np.ndarray:
    """Pillow's crop: the box, zero past the image."""
    x0, y0, x1, y1 = extent
    out = np.zeros((y1 - y0, x1 - x0) + im.shape[2:], im.dtype)
    h, w = im.shape[:2]
    sx0, sy0, sx1, sy1 = min(x0, w), min(y0, h), min(x1, w), min(y1, h)
    out[sy0 - y0:sy1 - y0, sx0 - x0:sx1 - x0] = im[sy0:sy1, sx0:sx1]
    return out


def _paste(im: np.ndarray, patch: np.ndarray, extent) -> None:
    x0, y0 = extent[:2]
    h, w = im.shape[:2]
    ph, pw = min(patch.shape[0], h - y0), min(patch.shape[1], w - x0)
    if ph > 0 and pw > 0:
        im[y0:y0 + ph, x0:x0 + pw] = patch[:ph, :pw]


def _grown(im: np.ndarray, h: int, w: int, fill: np.ndarray) -> np.ndarray:
    """``im`` pasted at the corner of an h x w canvas of ``fill``."""
    out = np.empty((h, w) + im.shape[2:], np.uint8)
    out[...] = fill[0] if im.ndim == 2 else fill
    out[:im.shape[0], :im.shape[1]] = im
    return out


def _decode_into(dst: np.ndarray, idx: np.ndarray, f: _Frame, transparency: int, at) -> None:
    """Write the frame's decoded indices into ``dst`` from ``at`` (x, y), row
    by row as the stream gives them (deinterlaced), clipped to ``dst``; a
    pixel of index ``transparency`` is skipped; pixels the stream does not
    reach are left."""
    x1, y1, x2, y2 = f.extent
    w, h = x2 - x1, y2 - y1
    if w == 0 or h == 0:
        return
    order = np.arange(h)
    if f.interlace:
        order = np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8), np.arange(2, h, 4),
                                np.arange(1, h, 2)])
    x0, y0 = at
    H, W = dst.shape[:2]
    n = min(w, W - x0)
    for r in range(-(-idx.size // w)):
        yy = y0 + order[r]
        row = idx[r * w:(r + 1) * w][:n]
        if yy >= H or n <= 0:
            continue
        out = dst[yy, x0:x0 + row.size]
        if transparency >= 0:
            m = row != transparency
            out[m] = row[m]
        else:
            out[...] = row


def read_frames(data: bytes) -> List[np.ndarray]:
    """Every frame as Pillow reads it: (H, W, 3) RGB or (H, W) gray, u8."""
    return Gif(data).rgb_frames()


def read_gif(data: bytes) -> np.ndarray:
    """The first frame, as ``Image.open(...).convert("RGB")`` reads it."""
    g = Gif(data)
    g.frames = g.frames[:1]
    return g.rgb_frames()[0]


def count(data: bytes) -> int:
    """Pillow's ``n_frames``."""
    return len(Gif(data))


def gif_info(data: bytes) -> dict:
    """Pillow's ``info`` after ``Image.open``: ``version`` (bytes),
    ``background``, ``loop``, ``transparency``, ``comment`` (bytes) and
    ``duration``, in Pillow's order."""
    return Gif(data).info


# -- the writer ------------------------------------------------------------------


class _Out:
    """A normalized frame: its indices (H, W) u8 and palette (m, 3) u8."""

    __slots__ = ("idx", "pal", "info")

    def __init__(self, idx: np.ndarray, pal: np.ndarray):
        self.idx, self.pal, self.info = idx, pal, {}

    def rgb(self) -> np.ndarray:
        return self.pal[self.idx]


def _normalize(frame) -> _Out:
    """``_normalize_mode`` then ``_normalize_palette`` (optimize, no palette
    given): gray → its used grays; RGB → Pillow's median cut."""
    from .quantize import quantize

    is_tensor = not isinstance(frame, np.ndarray)
    if str(frame.dtype) not in ("uint8", "torch.uint8"):
        raise not_ported(f"writing {frame.dtype} images as GIF", item=LEFTOVERS)
    nd = frame.ndim
    ch = 1 if nd == 2 else frame.shape[2]
    if ch == 4:
        raise not_ported("writing 4-channel images as GIF", item=LEFTOVERS)
    if ch == 2:  # Pillow's LA: convert("L") keeps the gray
        frame = frame[..., 0]
        ch = 1
    if ch == 1:
        g = (frame.cpu().numpy() if is_tensor else np.asarray(frame))
        g = g.reshape(g.shape[0], g.shape[1])
        used, idx = np.unique(g, return_inverse=True)
        return _Out(idx.reshape(g.shape).astype(np.uint8), np.repeat(used[:, None], 3, axis=1))
    if ch != 3:
        raise CodecError(f"cannot write {ch}-channel images as GIF")
    idx, pal = quantize(frame)
    h, w = idx.shape
    counts = np.bincount(idx.ravel(), minlength=len(pal))
    used = np.flatnonzero(counts)
    # _get_optimize: drop the unused entries of a frame under 512 x 512 with holes
    if h * w < 512 * 512 and used.max() >= len(used):
        remap = np.zeros(len(pal), np.uint8)
        remap[used] = np.arange(len(used))
        return _Out(remap[idx], pal[used])
    return _Out(idx, pal)


def _new_color_index(f: _Out) -> Optional[int]:
    """``ImagePalette._new_color_index``: the entry after the palette, else
    the last unused one, else None (no room)."""
    if len(f.pal) < 256:
        return len(f.pal)
    counts = np.bincount(f.idx.ravel(), minlength=256)
    free = np.flatnonzero(counts[:256] == 0)
    return int(free[-1]) if free.size else None


def _bbox(mask: np.ndarray):
    ys, xs = np.flatnonzero(mask.any(1)), np.flatnonzero(mask.any(0))
    if ys.size == 0:
        return None
    return int(xs[0]), int(ys[0]), int(xs[-1]) + 1, int(ys[-1]) + 1


def _table_size(n: int) -> int:
    """``_get_color_table_size`` of an n-entry palette."""
    if n == 0:
        return 0
    if n * 3 < 9:
        return 1
    return int(np.ceil(np.log2(n))) - 1


def _palette_bytes(pal: np.ndarray) -> bytes:
    size = _table_size(len(pal))
    return pal.tobytes() + bytes(3 * max(0, (2 << size) - len(pal)))


def _lzw_blocks(idx: np.ndarray) -> bytes:
    from .. import native

    codes = native.gif_lzw_encode(np.ascontiguousarray(idx).ravel(), 8)
    out = bytearray(b"\x08")
    for i in range(0, len(codes), 255):
        chunk = codes[i:i + 255]
        out += bytes([len(chunk)]) + chunk
    return bytes(out + b"\x00")


def _local(f: _Out, idx: np.ndarray, offset, info: dict, table: bool, interlace: bool) -> bytes:
    """``_write_local_header`` and the image data of one frame."""
    out = bytearray()
    tr = info.get("transparency")
    duration = int(info["duration"] / 10) if "duration" in info else 0
    if tr is not None or duration != 0:
        out += b"!\xf9\x04" + bytes([1 if tr is not None else 0]) + struct.pack("<H", duration) \
            + bytes([tr or 0, 0])
    flags = 64 if interlace else 0
    if table:
        flags |= 128 | _table_size(len(f.pal))
    h, w = idx.shape
    out += b"," + struct.pack("<HHHHB", offset[0], offset[1], w, h, flags)
    if table:
        out += _palette_bytes(f.pal)
    if interlace:
        order = np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8), np.arange(2, h, 4),
                                np.arange(1, h, 2)])
        idx = idx[order]
    return bytes(out) + _lzw_blocks(idx)


def _global(f: _Out, info: dict) -> bytes:
    """``_get_global_header``: GIF89a where the frame has transparency, a
    loop or a duration; its palette as the global one; NETSCAPE when a loop
    is given."""
    h, w = f.idx.shape
    v89 = "transparency" in info or info.get("loop") is not None or info.get("duration")
    out = b"GIF" + (b"89a" if v89 else b"87a") + struct.pack("<HH", w, h)
    out += bytes([_table_size(len(f.pal)) + 128, 0, 0]) + _palette_bytes(f.pal)
    if info.get("loop") is not None:
        out += b"!\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", info["loop"]) + b"\x00"
    return out


def write_gif(frames, duration=None, loop: Optional[int] = None) -> bytes:
    """Frames → a GIF, as Pillow's ``save(save_all=True, append_images=...,
    duration=..., loop=...)`` writes them with its defaults. A frame is an
    (H, W) gray, (H, W, 2) gray + alpha or (H, W, 3) RGB u8 array, numpy or
    a tensor (quantized on its device); ``duration`` ms per frame (a list) or
    for all (a number)."""
    frames = list(frames)
    if not frames:
        raise CodecError("no frames to write")
    base: dict = {}
    if duration is not None and not isinstance(duration, (list, tuple)):
        base["duration"] = duration
    if loop is not None:
        base["loop"] = loop
    kept, prev = [], None  # kept: [_Out, bbox, info, the frame written]
    for n, frame in enumerate(frames):
        f = _normalize(frame)
        info = dict(base)
        if isinstance(duration, (list, tuple)):
            info["duration"] = duration[n]
        if kept:
            if f.pal.tobytes() == prev.pal.tobytes():
                diff = f.idx != prev.idx
            else:
                diff = (f.rgb() != prev.rgb()).any(2)
            box = _bbox(diff)
            if box is None:  # equal to the frame before: merged, its duration added
                if info.get("duration"):
                    kept[-1][2]["duration"] += info["duration"]
                continue
            written = f.idx
            tr = _new_color_index(f)
            if tr is not None:
                info["transparency"] = tr
                written = np.where(diff, f.idx, np.uint8(tr))
        else:
            box, written = None, f.idx
        prev = f
        kept.append([f, box, info, written])
    if len(kept) == 1:  # _write_single_frame: the first frame, interlaced where it can be
        f, _, info, _ = kept[0]
        info = dict(base, **({"duration": info["duration"]} if "duration" in info else {}))
        h, w = f.idx.shape
        return _global(f, info) + _local(f, f.idx, (0, 0), info, False, min(h, w) >= 16) + b";"
    out = bytearray()
    for f, box, info, written in kept:
        if box is None:
            out += _global(f, info) + _local(f, written, (0, 0), info, False, False)
        else:
            x0, y0, x1, y1 = box
            out += _local(f, written[y0:y1, x0:x1], (x0, y0), info, True, False)
    return bytes(out + b";")
