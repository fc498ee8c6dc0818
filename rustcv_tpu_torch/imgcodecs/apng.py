"""Animated PNG (APNG) without Pillow, read and written as Pillow 12's
``PngImagePlugin`` reads and writes it.

Reads (:class:`Apng`, over :class:`.host._Png`'s chunks and acTL): the
``fcTL`` and ``fdAT`` chunks with the checks Pillow makes (truncated
chunks, sequence numbers, frames outside the image, an fcTL without image
data) and the errors it raises on them (:class:`.host.CodecError`); each
frame's image data unfiltered as a still PNG's is (every colour type, bit
depth and Adam7), in its ``bbox``. A walk over the frames (:class:`_Walk`)
is Pillow's ``ImageSequence``: each step a ``_seek`` (the frame before
loaded and disposed, the next fcTL read and checked), each frame's pixels
a ``load`` (its data decoded, composited, then ``load_end``), in Pillow's
storage of the file's mode: the previous frame's disposal (``OP_NONE``,
``OP_BACKGROUND`` to zeros, ``OP_PREVIOUS`` to the composite before it;
``OP_PREVIOUS`` on the first frame is ``OP_BACKGROUND``), then
``OP_SOURCE`` (the frame replaces its box) or ``OP_OVER`` (each byte of
the box blended by the frame's alpha: an RGBA or LA alpha, a palette's
``tRNS`` alphas, RGB's ``tRNS`` colour; 1-, L- and P-mode indices blended
as bytes, as Pillow's paste does; a 16-bit gray frame raises, as Pillow's
conversion of its box to RGBA does). An image data that precedes every
fcTL is a default image: frame 0, and the canvas the animation starts on.
A frame is then ``convert("RGB")``'s (:meth:`.host._Png.convert_rgb`).
``n_frames``, the durations (ms, floats: ``delay_num / delay_den``, a zero
denominator 100), disposals, blends, boxes and ``loop`` are Pillow's
``info``. A missing frame ends the frames, as Pillow's ``EOFError`` ends
``ImageSequence``, but a frame acTL counts past the last one raises at its
seek, as Pillow's seek past IEND does; the frames after the first of an
interlaced animation raise at their load, as Pillow 12.1's decoder does on
them.

Writes (:func:`write_apng`): Pillow's ``_write_multiple_frames`` with what
the port's callers pass it (durations and a loop), for every mode
``Image.fromarray`` makes: the written mode is RGBA if a frame is RGBA,
else RGB if one is RGB, else one of the frames' modes (a fixed order where
Pillow's choice hangs on string hashing), every frame converted to it as
Pillow converts it; the canvas is the largest width and height. Each frame
is compared in RGBA with the frame before it over their common top-left
part: an equal frame adds its duration to the one before where both have
one, else the frame is written cropped to the box of what changed. The
comparisons run in torch on the frames' device, and so do the row filters
(:mod:`.png_filter`). The control chunks (``acTL``, each ``fcTL``:
sequence, size, offset, delay as
``Fraction(ms / 1000).limit_denominator(65535)``, dispose ``OP_NONE``,
blend ``OP_SOURCE``) and the image data before zlib are Pillow's byte for
byte, and the data is cut into chunks of Pillow's block size
(:func:`.host.png_blocks`), so the sequence numbers agree.
"""

from __future__ import annotations

import struct
from fractions import Fraction
from typing import Optional, Tuple

import numpy as np

from . import host as _host
from .host import CodecError, _chunk

OP_NONE, OP_BACKGROUND, OP_PREVIOUS = 0, 1, 2  # dispose_op
OP_SOURCE, OP_OVER = 0, 1  # blend_op
_DATA = (b"IDAT", b"DDAT", b"fdAT")  # the chunks Pillow's load_read takes image data from


def read_png(data: bytes) -> np.ndarray:
    """What Pillow's ``Image.open(...).convert("RGB")`` reads of a PNG: a
    still PNG's image, an animated PNG's frame 0; (H, W) gray or (H, W, 3)
    RGB, u8."""
    png = _host._Png(data)
    return next(Apng(png).frames()) if png.apng else png.rgb()


def png_info(data: bytes) -> Tuple[dict, dict]:
    """Pillow's ``info`` of a PNG after ``Image.open`` (the chunks before
    the image data; an animated PNG's first fcTL too) and what ``load()``
    adds after it."""
    png = _host._Png(data)
    return (Apng(png).info if png.apng else png.info), png.late


def count(data: bytes) -> int:
    """Pillow's ``n_frames`` of a PNG (1 for a still one)."""
    png = _host._Png(data)
    return Apng(png).n_frames if png.apng else 1


class Apng:
    """The frames of a parsed PNG (:class:`.host._Png`, or its bytes), as
    Pillow's ``ImageSequence`` gives them. ``info`` is Pillow's after
    ``Image.open``, which reads (and checks) the fcTL before the image
    data."""

    def __init__(self, png):
        if not isinstance(png, _host._Png):
            png = _host._Png(png)
        self.png = png
        self.n_frames = png.frame_count()
        self.loop = png.info.get("loop", 0)
        opened, header = _Walk(png, self.n_frames, None, {}), False  # Image.open's reading
        for kind, body in png.chunks[:png.first_data]:
            header = header or kind == b"IHDR"
            if kind == b"fcTL":
                if not header:  # Pillow's chunk_fcTL has no image size to hold the frame to
                    raise CodecError("APNG contains invalid frames")
                opened.info.update(opened.frame_control(body))
        kind, body = png.chunks[png.first_data]
        if kind == b"fdAT":
            opened.sequence(body, 4, "fDAT")
        self.info = dict(png.info, **opened.info)
        self._opened = opened.seq, opened.info  # what a rewind goes back to

    def walk(self):
        """Pillow's ``ImageSequence`` from a rewind: one :class:`_Walk`,
        yielded once per frame just after that frame's seek (its fcTL read
        and checked), before its load; a walk of its own each call."""
        w = _Walk(self.png, self.n_frames, *self._opened)
        for frame in range(self.n_frames):
            if frame and not w.seek():
                return
            yield w

    def composites(self):
        """Each frame's composite in Pillow's storage of the mode (H, W, C),
        with its ``info`` (``bbox``, ``duration``, ``disposal``, ``blend``
        where the file gives them)."""
        for w in self.walk():
            yield w.load().copy(), dict(w.info)

    def frames(self):
        """Each frame as ``convert("RGB")`` reads it: (H, W) gray or (H, W, 3)
        RGB, u8."""
        for canvas, _info in self.composites():
            yield self.png.convert_rgb(canvas)


def _alpha(png, box: np.ndarray) -> Optional[np.ndarray]:
    """The alpha Pillow's ``OP_OVER`` pastes a box of the canvas with
    (``convert("RGBA")`` of it, the file's transparency applied), or None
    where it is 255 throughout."""
    depth, ctype = png.header[2:4]
    t = png.info.get("transparency")
    if ctype in (4, 6):
        return box[..., -1]
    if ctype == 2 and isinstance(t, tuple):
        return np.where((box == np.array(t)).all(-1), 0, 255)
    if ctype == 3 and isinstance(t, bytes):
        alphas = np.full(256, 255)
        alphas[:len(t[:256])] = np.frombuffer(t[:256], np.uint8)
        return alphas[box[..., 0]]
    if ctype == 3 and isinstance(t, int):
        return np.where(box[..., 0] == t, 0, 255)
    if ctype == 0 and depth == 16:  # Pillow's load_end converts the box's core image to RGBA
        raise CodecError("conversion from I;16 to RGBA not supported")
    return None


class _Walk:
    """One pass of Pillow's seeks and loads over an animated PNG's frames,
    from the state ``Image.open`` leaves (the last sequence number, the
    fcTL read): its own sequence counter, chunk position and canvas."""

    def __init__(self, png, n_frames: int, seq: Optional[int], info: dict):
        self.png, self.n_frames, self.seq, self.info = png, n_frames, seq, dict(info)
        self.frame, self.at, self.loaded = 0, png.first_data, False
        self.canvas = self.prev = self.dispose = self.extent = None
        self._setup_disposal()

    def sequence(self, body: bytes, need: int, name: str) -> None:
        """An fcTL's or fdAT's sequence number, checked as Pillow checks it."""
        if len(body) < need:
            raise CodecError(f"APNG contains truncated {name} chunk")
        seq = struct.unpack(">I", body[:4])[0]
        if (self.seq is None and seq != 0) or (self.seq is not None and self.seq != seq - 1):
            raise CodecError("APNG contains frame sequence errors")
        self.seq = seq

    def frame_control(self, body: bytes) -> dict:
        """Pillow's ``chunk_fcTL``: the sequence and the frame's place checked,
        → its ``bbox``, ``duration`` (ms, a float; a zero denominator is
        100), ``disposal`` and ``blend``."""
        self.sequence(body, 26, "fcTL")
        w, h, px, py = struct.unpack(">IIII", body[4:20])
        if px + w > self.png.header[0] or py + h > self.png.header[1]:
            raise CodecError("APNG contains invalid frames")
        num, den = struct.unpack(">HH", body[20:24])
        return {"bbox": (px, py, px + w, py + h),
                "duration": float(num) / float(den or 100) * 1000, "disposal": body[24],
                "blend": body[25]}

    def _setup_disposal(self) -> None:
        """The end of Pillow's ``_seek``: the frame's extent, and what its
        disposal puts back there before the next frame (the composite before
        it, zeros, or nothing)."""
        if self.info.get("bbox"):
            self.extent = self.info["bbox"]
        dop = self.info.get("disposal")
        if dop == OP_PREVIOUS and self.prev is None:
            dop = OP_BACKGROUND
        if dop == OP_PREVIOUS:
            x0, y0, x1, y1 = self.extent
            self.dispose = self.prev[y0:y1, x0:x1].copy()
        else:
            self.dispose = 0 if dop == OP_BACKGROUND else None

    def seek(self) -> bool:
        """Pillow's ``_seek`` to the next frame: the frame before loaded
        (where the caller did not) and disposed, the next fcTL read and
        checked; False where the file has no more frames."""
        self.load()
        if self.dispose is not None:
            x0, y0, x1, y1 = self.extent
            self.canvas[y0:y1, x0:x1] = self.dispose
        self.prev = self.canvas.copy()
        png, pos, frame_start = self.png, self.at, False
        if pos < len(png.chunks) and png.chunks[pos][0] == b"IEND":
            # load_end read IEND: Pillow's seek then skips the last data chunk's length past
            # the end of the file
            raise CodecError("Truncated File Read (acTL counts more frames than the file has)")
        while pos < len(png.chunks):
            kind, body = png.chunks[pos]
            if kind == b"IEND":
                return False
            if kind == b"fcTL":
                if frame_start:
                    raise CodecError("APNG missing frame data")
                frame_start = True
                self.info.update(self.frame_control(body))
            elif kind == b"fdAT":
                self.sequence(body, 4, "fDAT")
                if frame_start:
                    self.frame, self.at, self.loaded = self.frame + 1, pos, False
                    self._setup_disposal()
                    return True
            elif kind == b"acTL" and len(body) < 8:
                raise CodecError("APNG contains truncated acTL chunk")
            pos += 1
        return False

    def load(self) -> np.ndarray:
        """Pillow's ``load`` of the frame sought: its image data decoded into
        its box and, ``OP_OVER``, blended over the composite before it, then
        ``load_end``; → the composite (H, W, C) in Pillow's storage of the
        mode (the walk's own array: copy it to keep it)."""
        if self.loaded:
            return self.canvas
        png = self.png
        w, h, depth, ctype, _comp, _filt, interlace = png.header
        if interlace and self.frame:  # Pillow's load appends the interlace flag again at every frame
            raise CodecError("Pillow cannot decode the later frames of an interlaced "
                             "animated PNG (its decoder takes at most 3 arguments)")
        x0, y0, x1, y1 = self.info.get("bbox") or (0, 0, w, h)
        data, pos = [], self.at
        while pos < len(png.chunks) and png.chunks[pos][0] in _DATA:
            kind, body = png.chunks[pos]
            if kind == b"fdAT":
                if pos != self.at:  # the seek checked the first one
                    self.sequence(body, 4, "fDAT")
                body = body[4:]
            data.append(body)
            pos += 1
        px = png.storage(_host.png_samples(data, x1 - x0, y1 - y0, depth, ctype, interlace))
        if self.canvas is None:
            self.canvas = np.zeros((h, w) + px.shape[2:], px.dtype)
        self.canvas[y0:y1, x0:x1] = px
        if self.prev is not None and self.info.get("blend") == OP_OVER:
            a = _alpha(png, px)
            if a is not None:
                a = a.astype(np.int64)[..., None]
                v = self.prev[y0:y1, x0:x1].astype(np.int64) * (255 - a) + px * a + 128
                self.prev[y0:y1, x0:x1] = (((v >> 8) + v) >> 8).astype(self.prev.dtype)
            else:
                self.prev[y0:y1, x0:x1] = px
            self.canvas = self.prev
        self.at, self.loaded = self._load_end(pos), True
        return self.canvas

    def _load_end(self, pos: int) -> int:
        """Pillow's ``load_end``: the chunks after a frame's data, up to IEND
        or (animated) the next fcTL, with their checks; → where the next
        seek reads on."""
        png = self.png
        while pos < len(png.chunks):
            kind, body = png.chunks[pos]
            if kind == b"IEND" or (kind == b"fcTL" and self.n_frames > 1):
                return pos
            if kind == b"fdAT":
                self.sequence(body, 4, "fDAT")
            elif kind == b"acTL" and len(body) < 8:
                raise CodecError("APNG contains truncated acTL chunk")
            elif kind == b"fcTL":
                self.frame_control(body)
            pos += 1
        return pos


# -- the writer --------------------------------------------------------------------------------


# The written mode from the frames' modes: Pillow takes RGBA, then RGB (then P, which
# Image.fromarray never makes); among the rest it takes whatever set.pop() gives, which hangs
# on Python's string hashing. The port takes the first of this order
# (tests/test_torch_port_map.py's DEVIATIONS).
_MODE_ORDER = ("RGBA", "RGB", "LA", "L", "I;16", "I", "F", "1")


def _gray8(px, mode: str):
    """Pillow's ``convert("L")`` of a one-band mode, or LA's gray band."""
    import torch

    if mode == "1":
        return px.to(torch.uint8) * 255
    if mode in ("L", "LA"):
        return px[..., 0] if mode == "LA" else px
    return px.clamp(0, 255).to(torch.uint8)  # I;16, I; F truncated


def _convert(px, mode: str, to: str):
    """Pillow's ``convert(to)`` of ``mode`` pixels (:func:`.host.pillow_image`)
    where the mode order asks for it: to RGBA or RGB from any mode, to LA or
    L from the gray ones, to I;16 from I (clipped), 1 or F (through L), to I
    from 1 or F (truncated)."""
    import torch

    if mode == to:
        return px
    if to == "I":
        return px.to(torch.int32) * (255 if mode == "1" else 1)
    if to == "I;16":
        return px.clamp(0, 65535) if mode == "I" else _gray8(px, mode).to(torch.int32)
    if mode in ("RGB", "RGBA"):
        rgb, alpha = px[..., :3], (px[..., 3:] if mode == "RGBA" else None)
    else:
        g = _gray8(px, mode)
        if to == "L":
            return g
        rgb = g[..., None].expand(*g.shape, 1 if to == "LA" else 3)
        alpha = px[..., 1:] if mode == "LA" else None
    if to == "RGB":
        return rgb
    if alpha is None:
        alpha = torch.full_like(rgb[..., :1], 255)
    return torch.cat([rgb, alpha], -1)


def _bbox(diff) -> Optional[tuple]:
    """``getbbox()`` of a (H, W) bool tensor: (x0, y0, x1, y1), or None."""
    rows, cols = diff.any(1).nonzero(), diff.any(0).nonzero()
    if len(rows) == 0:
        return None
    return int(cols[0]), int(rows[0]), int(cols[-1]) + 1, int(rows[-1]) + 1


def write_apng(frames, duration=None, loop: Optional[int] = None) -> bytes:
    """Frames → an animated PNG, as Pillow's ``save(save_all=True,
    append_images=..., duration=..., loop=...)`` writes it (one frame left
    after merging: a still PNG on the animation's canvas). ``duration`` is
    ms, one for every frame or a list, or None (no delay, no merging). A
    frame is what ``Image.fromarray`` takes (:func:`.host.pillow_image`),
    numpy or a tensor (compared and filtered on its device). Each frame is
    converted to the written mode (:data:`_MODE_ORDER`; F raises Pillow's
    OSError) and compared in RGBA with the frame kept before it over their
    common top-left part: an equal frame adds its duration to the one
    before where both have one, else the frame is written cropped to the box
    of what changed (its own size where nothing did). The canvas is the
    widest and the tallest frame; a smaller frame keeps its size, and Pillow
    writes nothing of the canvas outside it."""
    frames = [_host.pillow_image(f) for f in frames]
    if not frames:
        raise CodecError("no frames to write")
    modes = {m for m, _ in frames}
    mode = next(m for m in _MODE_ORDER if m in modes)
    if mode not in _host.PNG_MODES:
        raise OSError(f"cannot write mode {mode} as PNG")
    depth, ctype = _host.PNG_MODES[mode]
    w, h = (max(int(px.shape[i]) for _, px in frames) for i in (1, 0))
    kept = []  # [frame in the mode, its RGBA, bbox, duration]
    for n, (m, px) in enumerate(frames):
        ms = duration[n] if isinstance(duration, (list, tuple)) else duration
        img = _convert(px, m, mode)
        rgba = _convert(img, mode, "RGBA")
        bbox = None
        if kept:
            prev = kept[-1][1]
            ch, cw = min(rgba.shape[0], prev.shape[0]), min(rgba.shape[1], prev.shape[1])
            bbox = _bbox((rgba[:ch, :cw] != prev[:ch, :cw]).any(2))
            if bbox is None and ms is not None:
                kept[-1][3] += ms
                continue
        kept.append([img, rgba, bbox, ms])
    if len(kept) == 1:
        return _host.png_file(mode, kept[0][0], size=(w, h))
    out = [_host._PNG_SIG,
           _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0)),
           _chunk(b"acTL", struct.pack(">II", len(kept), loop or 0))]
    seq = 0
    for k, (img, _rgba, bbox, ms) in enumerate(kept):
        x0, y0, x1, y1 = bbox or (0, 0, int(img.shape[1]), int(img.shape[0]))
        delay = Fraction((ms or 0) / 1000).limit_denominator(65535)
        if delay.numerator > 65535:
            raise CodecError("cannot write duration")
        out.append(_chunk(b"fcTL", struct.pack(
            ">IIIIIHHBB", seq, x1 - x0, y1 - y0, x0, y0, delay.numerator, delay.denominator,
            OP_NONE, OP_SOURCE)))
        seq += 1
        blocks = _host.png_blocks(img[y0:y1, x0:x1], mode)
        if k == 0:
            out += [_chunk(b"IDAT", b) for b in blocks]
        else:
            for b in blocks:
                out.append(_chunk(b"fdAT", struct.pack(">I", seq) + b))
                seq += 1
    out.append(_chunk(b"IEND", b""))
    return b"".join(out)
