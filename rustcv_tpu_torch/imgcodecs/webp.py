"""WebP without Pillow: what the reference's Pillow 12 (libwebp 1.6) reads,
for :mod:`rustcv_tpu_torch.imgcodecs`.

Pillow reads every WebP, still or animated, through libwebp's
``WebPAnimDecoder``: a still image is one frame of the animation decoder.
This module is that decoder without libwebp:

* the RIFF parse is ``WebPDemux``'s (``demux/demux.c``): Pillow's
  ``_accept`` (``RIFF``, ``WEBP``, then ``VP8 ``, ``VP8L`` or ``VP8X``), the
  RIFF size (a file shorter than it says is refused, bytes past it are
  ignored), odd chunk sizes and their padding, the ``VP8X`` flags and canvas,
  ``ICCP``, ``EXIF`` and ``XMP `` (kept only where their flag is set),
  ``ANIM`` (background, loop) and ``ANMF`` (offsets, duration, blend and
  dispose bits, an inner ``ALPH`` and ``VP8 `` or ``VP8L``); unknown chunks
  are skipped; the checks that make the demuxer refuse a file are its;
* each frame is decoded by the port's C++ (``native.vp8_decode``,
  ``native.vp8l_decode``), and composited as ``WebPAnimDecoderGetNext``
  composites it (``demux/anim_decode.c``): its keyframe rule, disposal to
  transparent black (the ANIM background is not used), and
  ``BlendPixelNonPremult``'s integer arithmetic for blended non-keyframes
  (outside the rectangle the frame before disposed), vectorised in numpy;
* the canvas is RGBA, or RGB where Pillow's ``rawmode`` is ``RGBX`` (the
  file has no alpha by ``WebPGetFeatures``); ``convert("RGB")`` drops alpha
  without compositing it;
* :func:`webp_info` is Pillow's ``info``: ``loop``, ``background``,
  ``icc_profile``, ``exif`` and ``xmp``, and once a frame is loaded its
  ``timestamp`` and ``duration`` (the differences of libwebp's timestamps).

What the demuxer or the decoder refuses raises :class:`CodecError`.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

import numpy as np

from .host import CodecError

_MAX_CHUNK_PAYLOAD = 0xFFFFFFFF - 8 - 1
_MAX_IMAGE_AREA = 1 << 32
ICCP_FLAG, ALPHA_FLAG, EXIF_FLAG, XMP_FLAG, ANIMATION_FLAG = 0x20, 0x10, 0x08, 0x04, 0x02
_VALID_FLAGS = ICCP_FLAG | ALPHA_FLAG | EXIF_FLAG | XMP_FLAG | ANIMATION_FLAG
_IMAGE_TAGS = (b"VP8 ", b"VP8L", b"VP8X")  # Pillow's _accept


def accept(data: bytes) -> bool:
    """Pillow's ``WebPImagePlugin._accept``."""
    return data[:4] == b"RIFF" and data[8:12] == b"WEBP" and data[12:16] in _IMAGE_TAGS


class _NeedMore(Exception):
    """The demuxer's PARSE_NEED_MORE_DATA: an error for a whole file."""


class Frame:
    """One frame as the demuxer stores it: the image chunk (and ALPH) as
    byte spans of the file, its placement and its bits."""

    def __init__(self):
        self.x = self.y = self.width = self.height = self.duration = 0
        self.dispose = False  # True: to background
        self.blend = True
        self.has_alpha = False
        self.num = 0
        self.image: Optional[Tuple[int, int]] = None  # (offset, size) of the chunk, header on
        self.alpha: Optional[Tuple[int, int]] = None
        self.lossless = False


def _le24(b: bytes, p: int) -> int:
    return b[p] | (b[p + 1] << 8) | (b[p + 2] << 16)


def _features(payload: bytes, size: int, lossless: bool) -> Tuple[int, int, bool]:
    """``WebPGetFeatures`` of one image chunk: ``payload`` with its pad
    byte, ``size`` the chunk header's; → (w, h, alpha bit)."""
    from .. import native

    if lossless:
        if len(payload) < 5:
            raise _NeedMore
        try:
            return native.vp8l_info(payload)
        except ValueError as e:
            raise CodecError(str(e)) from None
    if len(payload) < 10:
        raise _NeedMore
    try:
        w, h = native.vp8_info(payload)
    except ValueError as e:
        raise CodecError(str(e)) from None
    if (payload[0] | (payload[1] << 8) | (payload[2] << 16)) >> 5 >= size:
        raise CodecError("corrupt VP8 bitstream (partition 0 past the chunk)")
    return w, h, False


class WebP:
    """A WebP file as ``WebPDemux`` parses it (``canvas``, ``loop``,
    ``bgcolor``, ``frames``, the stored metadata chunks)."""

    def __init__(self, data: bytes):
        data = bytes(data)
        if not accept(data):
            raise CodecError("not a WebP file")
        if len(data) < 20:
            raise CodecError("truncated WebP header")
        riff_size = struct.unpack("<I", data[4:8])[0]
        if riff_size < 8 or riff_size > _MAX_CHUNK_PAYLOAD:
            raise CodecError("bad RIFF size")
        self.end = riff_size + 8
        if len(data) < self.end:
            raise CodecError("truncated WebP file (shorter than its RIFF size)")
        self.data = data[:self.end]
        self.flags = 0
        self.ext = False
        self.loop, self.bgcolor = 1, 0xFFFFFFFF
        self.canvas = (-1, -1)
        self.frames: List[Frame] = []
        self.chunks: List[Tuple[bytes, bytes]] = []  # the stored metadata and unknown chunks
        try:
            if data[12:16] == b"VP8X":
                self._parse_vp8x(12)
                self._check_extended()
            else:
                self._single_image(12)
                self._check_simple()
        except _NeedMore:
            raise CodecError("truncated or inconsistent WebP chunks") from None

    # -- demux/demux.c ---------------------------------------------------------

    def _size_invalid(self, pos: int, size: int) -> bool:
        return size > self.end - pos

    def _store_frame(self, pos: int, num: int, min_size: int, f: Frame) -> int:
        """StoreFrame: the ALPH and image chunks from ``pos``; returns where
        parsing stops (an unknown chunk is left for the caller)."""
        d = self.data
        if self.end - pos < 8 or self.end - pos < min_size:
            raise _NeedMore
        alpha_chunks = image_chunks = 0
        while True:
            start = pos
            tag = d[pos:pos + 4]
            size = struct.unpack("<I", d[pos + 4:pos + 8])[0]
            pos += 8
            if size > _MAX_CHUNK_PAYLOAD:
                raise CodecError("bad WebP chunk size")
            padded = size + (size & 1)
            if self._size_invalid(pos, padded):
                raise CodecError("WebP chunk past the RIFF end")
            done = False
            if tag == b"ALPH" and alpha_chunks == 0:
                alpha_chunks = 1
                f.alpha = (start, 8 + padded)
                f.has_alpha = True
                f.num = num
                pos += padded
            elif tag in (b"VP8 ", b"VP8L") and image_chunks == 0:
                if tag == b"VP8L" and alpha_chunks > 0:
                    raise CodecError("ALPH before a VP8L chunk")
                f.lossless = tag == b"VP8L"
                f.width, f.height, alpha = _features(d[pos:pos + padded], size, f.lossless)
                image_chunks = 1
                f.image = (start, 8 + padded)
                f.has_alpha |= bool(alpha)
                f.num = num
                pos += padded
            elif tag == b"VP8L" and alpha_chunks > 0:
                raise CodecError("ALPH before a VP8L chunk")
            else:
                pos, done = start, True
            if done or pos == self.end:
                return pos
            if self.end - pos < 8:
                raise _NeedMore

    def _single_image(self, pos: int) -> int:
        if self.frames:
            raise CodecError("a second image in a WebP file")
        if self._size_invalid(pos, 8):
            raise CodecError("bad WebP chunk")
        f = Frame()
        pos = self._store_frame(pos, 1, 0, f)
        if not (self.flags & ALPHA_FLAG) and f.alpha is not None:
            f.alpha, f.has_alpha = None, False  # an ALPH chunk without the alpha flag
        if not self.ext and f.width > 0 and f.height > 0:
            self.canvas = (f.width, f.height)
            self.flags |= ALPHA_FLAG if f.has_alpha else 0
        self.frames.append(f)
        return pos

    def _parse_vp8x(self, pos: int) -> None:
        d = self.data
        self.ext = True
        size = struct.unpack("<I", d[pos + 4:pos + 8])[0]
        pos += 8
        if size > _MAX_CHUNK_PAYLOAD or size < 10:
            raise CodecError("bad VP8X chunk")
        size += size & 1
        if self._size_invalid(pos, size):
            raise CodecError("bad VP8X chunk")
        self.flags = d[pos]
        self.canvas = (1 + _le24(d, pos + 4), 1 + _le24(d, pos + 7))
        if self.canvas[0] * self.canvas[1] >= _MAX_IMAGE_AREA:
            raise CodecError("WebP canvas too large")
        pos += size
        if self._size_invalid(pos, 8):
            raise CodecError("bad WebP chunk")
        if self.end - pos < 8:
            raise _NeedMore
        is_animation = bool(self.flags & ANIMATION_FLAG)
        anim_chunks = 0
        while True:
            start = pos
            tag = d[pos:pos + 4]
            size = struct.unpack("<I", d[pos + 4:pos + 8])[0]
            pos += 8
            if size > _MAX_CHUNK_PAYLOAD:
                raise CodecError("bad WebP chunk size")
            padded = size + (size & 1)
            if self._size_invalid(pos, padded):
                raise CodecError("WebP chunk past the RIFF end")
            if tag == b"VP8X":
                raise CodecError("a second VP8X chunk")
            if tag in (b"ALPH", b"VP8 ", b"VP8L"):
                if anim_chunks > 0 or is_animation:
                    raise CodecError("an image outside ANMF in an animation")
                pos = self._single_image(start)
            elif tag == b"ANIM":
                if padded < 6:
                    raise CodecError("bad ANIM chunk")
                if anim_chunks == 0:
                    anim_chunks = 1
                    self.bgcolor = struct.unpack("<I", d[pos:pos + 4])[0]
                    self.loop = struct.unpack("<H", d[pos + 4:pos + 6])[0]
                pos += padded
            elif tag == b"ANMF":
                if anim_chunks == 0:
                    raise CodecError("ANMF before ANIM")
                pos = self._animation_frame(pos, padded, is_animation)
            else:
                store = {b"ICCP": ICCP_FLAG, b"EXIF": EXIF_FLAG, b"XMP ": XMP_FLAG}.get(tag)
                if store is None or self.flags & store:
                    self.chunks.append((tag, d[pos:pos + size]))
                pos += padded
            if pos == self.end:
                return
            if self.end - pos < 8:
                raise _NeedMore

    def _animation_frame(self, pos: int, chunk_size: int, is_animation: bool) -> int:
        d = self.data
        if self._size_invalid(pos, 16) or chunk_size < 16:
            raise CodecError("bad ANMF chunk")
        f = Frame()
        f.x, f.y = 2 * _le24(d, pos), 2 * _le24(d, pos + 3)
        f.width, f.height = 1 + _le24(d, pos + 6), 1 + _le24(d, pos + 9)
        f.duration = _le24(d, pos + 12)
        bits = d[pos + 15]
        f.dispose, f.blend = bool(bits & 1), not (bits & 2)
        if f.width * f.height >= _MAX_IMAGE_AREA:
            raise CodecError("WebP frame too large")
        pos += 16
        end = self._store_frame(pos, len(self.frames) + 1, chunk_size - 16, f)
        if end - pos > chunk_size - 16:
            raise CodecError("ANMF frame past its chunk")
        if is_animation and f.num > 0:
            self.frames.append(f)
        return end

    def _check_simple(self) -> None:
        if self.canvas[0] <= 0 or self.canvas[1] <= 0 or not self.frames:
            raise CodecError("no image in the WebP file")
        if self.frames[0].width <= 0 or self.frames[0].height <= 0:
            raise CodecError("no image in the WebP file")

    def _check_extended(self) -> None:
        is_animation = bool(self.flags & ANIMATION_FLAG)
        if self.canvas[0] <= 0 or self.canvas[1] <= 0 or not self.frames:
            raise CodecError("no image in the WebP file")
        if self.flags & ~_VALID_FLAGS:
            raise CodecError("reserved VP8X flags set")
        for f in self.frames:
            if not is_animation and f.num > 1:
                raise CodecError("several frames in a still WebP")
            if f.image is None:
                raise CodecError("a WebP frame without an image")
            if f.alpha is not None and f.alpha[0] > f.image[0]:
                raise CodecError("ALPH after the image")
            if f.width <= 0 or f.height <= 0:
                raise CodecError("empty WebP frame")
            if is_animation:
                if f.x < 0 or f.y < 0 or f.x + f.width > self.canvas[0] or \
                        f.y + f.height > self.canvas[1]:
                    raise CodecError("WebP frame outside the canvas")
            elif f.x or f.y or (f.width, f.height) != self.canvas:
                raise CodecError("WebP image and canvas sizes differ")

    # -- what Pillow reads -----------------------------------------------------

    def chunk(self, tag: bytes) -> Optional[bytes]:
        for t, body in self.chunks:
            if t == tag:
                return body
        return None

    def has_alpha(self) -> bool:
        """``WebPGetFeatures(...).has_alpha`` of the file, as Pillow's
        ``_anim_decoder_new`` sniffs its mode (True where it fails)."""
        d = self.data
        p = 12
        if d[12:16] == b"VP8X":
            if struct.unpack("<I", d[16:20])[0] != 10:
                return True
            if self.flags & ANIMATION_FLAG:
                return bool(self.flags & ALPHA_FLAG)
            has = bool(self.flags & ALPHA_FLAG)
            p, alpha_data = 30, False
            while p + 8 <= len(d) and d[p:p + 4] not in (b"VP8 ", b"VP8L"):
                alpha_data |= d[p:p + 4] == b"ALPH"
                n = struct.unpack("<I", d[p + 4:p + 8])[0]
                p += (8 + n + 1) & ~1
            f = self.frames[0]
            if f.lossless:
                has = bool(_features(d[f.image[0] + 8:f.image[0] + f.image[1]], 0, True)[2])
            return has or alpha_data
        f = self.frames[0]
        return f.lossless and bool(_features(d[p + 8:p + f.image[1]], 0, True)[2])

    def decode(self, f: Frame, out: np.ndarray) -> None:
        """The frame's pixels (``WebPDecode`` of its fragment) into ``out``
        ((h, w, 4) RGBA, a region of the canvas)."""
        from .. import native

        d = self.data
        body = d[f.image[0] + 8:f.image[0] + f.image[1]]
        try:
            if f.lossless:
                native.vp8l_decode(body, out=out)
            else:
                alpha = None
                if f.alpha is not None:
                    n = struct.unpack("<I", d[f.alpha[0] + 4:f.alpha[0] + 8])[0]
                    alpha = d[f.alpha[0] + 8:f.alpha[0] + 8 + n]
                native.vp8_decode(body, alpha, out=out)
        except ValueError as e:
            raise CodecError(f"failed to decode a WebP frame: {e}") from None


def _is_key_frame(f: Frame, prev: Optional[Frame], prev_key: bool, canvas) -> bool:
    """anim_decode.c's IsKeyFrame."""
    if prev is None:
        return True
    full = (f.width, f.height) == canvas
    if (not f.has_alpha or not f.blend) and full:
        return True
    return prev.dispose and ((prev.width, prev.height) == canvas or prev_key)


def _blend(src: np.ndarray, dst: np.ndarray, mask: np.ndarray) -> None:
    """``BlendPixelRowNonPremult`` of ``src`` over ``dst`` (RGBA u8, same
    shape) where ``mask`` and the source alpha is not 255, into ``src``."""
    sa = src[..., 3].astype(np.uint32)
    sel = mask & (sa != 255)
    take_dst = sel & (sa == 0)
    mix = sel & (sa != 0)
    if mix.any():
        s = src[mix].astype(np.uint64)
        t = dst[mix].astype(np.uint64)
        src_a = s[:, 3]
        dst_factor_a = (t[:, 3] * (256 - src_a)) >> 8
        blend_a = src_a + dst_factor_a
        scale = (1 << 24) // blend_a
        out = np.empty_like(s)
        for c in range(3):
            out[:, c] = ((s[:, c] * src_a + t[:, c] * dst_factor_a) * scale) >> 24
        out[:, 3] = blend_a
        src[mix] = (out & 0xFF).astype(np.uint8)
    src[take_dst] = dst[take_dst]


def decode_frames(w: WebP, limit: Optional[int] = None) -> List[np.ndarray]:
    """The canvases ``WebPAnimDecoderGetNext`` gives, in order (the first
    ``limit`` of them), (H, W, 4) RGBA or (H, W, 3) RGB by Pillow's
    ``rawmode``."""
    cw, ch = w.canvas
    rgba = w.has_alpha()
    disposed = np.zeros((ch, cw, 4), np.uint8)  # the canvas before a frame, as disposed
    out = []
    prev: Optional[Frame] = None
    prev_key = False
    for i, f in enumerate(w.frames[:limit]):
        key = _is_key_frame(f, prev, prev_key, w.canvas)
        curr = np.zeros_like(disposed) if key else disposed.copy()
        region = curr[f.y:f.y + f.height, f.x:f.x + f.width]
        w.decode(f, region)
        if i > 0 and f.blend and not key:
            mask = np.ones((f.height, f.width), bool)
            if prev.dispose:  # the disposed rectangle is transparent black: no blend there
                x0, x1 = max(f.x, prev.x), min(f.x + f.width, prev.x + prev.width)
                y0, y1 = max(f.y, prev.y), min(f.y + f.height, prev.y + prev.height)
                if x0 < x1 and y0 < y1:
                    mask[y0 - f.y:y1 - f.y, x0 - f.x:x1 - f.x] = False
            _blend(region, disposed[f.y:f.y + f.height, f.x:f.x + f.width], mask)
        out.append(curr if rgba else curr[..., :3])
        disposed = curr.copy()
        if f.dispose:
            disposed[f.y:f.y + f.height, f.x:f.x + f.width] = 0
        prev, prev_key = f, key
    return out


def read_frames(data: bytes) -> List[np.ndarray]:
    """Every frame's canvas, (H, W, 4) RGBA or (H, W, 3) RGB by Pillow's
    ``rawmode``, as ``ImageSequence`` gives them."""
    return decode_frames(WebP(data))


def read_webp(data: bytes) -> np.ndarray:
    """The first frame's canvas (what ``Image.open(...).convert`` loads)."""
    return decode_frames(WebP(data), limit=1)[0]


def count(data: bytes) -> int:
    """Pillow's ``n_frames``: the demuxer's frame count (no frame decoded)."""
    return len(WebP(data).frames)


def webp_info(data: bytes, loaded: Optional[int] = None) -> dict:
    """Pillow's ``info`` after ``Image.open`` (and, with ``loaded``, after
    that frame is loaded: its ``timestamp`` and ``duration``)."""
    w = WebP(data)
    b = w.bgcolor
    info = {"loop": w.loop,
            "background": ((b >> 16) & 0xFF, (b >> 8) & 0xFF, b & 0xFF, (b >> 24) & 0xFF)}
    for key, tag in (("icc_profile", b"ICCP"), ("exif", b"EXIF"), ("xmp", b"XMP ")):
        value = w.chunk(tag)
        if value:
            info[key] = value
    if loaded is not None:
        info["timestamp"] = sum(f.duration for f in w.frames[:loaded])
        info["duration"] = w.frames[loaded].duration
    return info
