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


# -- writing -----------------------------------------------------------------------------
#
# What the reference's Pillow writes (WebPImagePlugin ``_save`` and
# ``_save_all`` over libwebp): a still at quality 80, method 4; an animation
# through ``WebPAnimEncoder`` at quality 80, method 0, kmin 3, kmax 5. The
# VP8 key frames come from the port's encoder (``native.vp8_encode``), the
# alpha planes from its lossless coder (``native.alph_encode``), the planes
# from ``webp_yuv.import_yuva`` on the image's own device.

QUALITY, STILL_METHOD, ANIM_METHOD, KMIN, KMAX = 80, 4, 0, 3, 5
FILTER_STRENGTH = 60  # WebPConfigPreset's; a blended animation frame has none
MAX_SIDE = 16383


def _chunk(tag: bytes, body: bytes) -> bytes:
    return tag + struct.pack("<I", len(body)) + body + (b"\0" if len(body) & 1 else b"")


def _riff(chunks: bytes) -> bytes:
    return b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WEBP" + chunks


def _put24(v: int) -> bytes:
    return int(v).to_bytes(3, "little")


def _rgba(frame):
    """A frame as the reference hands it to Pillow (numpy or a tensor; gray
    (H, W), (H, W, 2) gray and alpha, RGB or RGBA) → (H, W, 4) u8 RGBA on
    its device, as Pillow's ``_convert_frame`` converts it."""
    import torch

    t = frame if isinstance(frame, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(frame))
    if t.dtype != torch.uint8:
        raise CodecError(f"cannot write {t.dtype} images as WebP")
    if t.ndim == 3 and t.shape[2] == 1:
        t = t[..., 0]
    if t.ndim == 2:
        t = t[..., None]
    c = t.shape[2] if t.ndim == 3 else 0
    if c not in (1, 2, 3, 4):
        raise CodecError(f"cannot write {c}-channel images as WebP")
    opaque = torch.full_like(t[..., :1], 255)
    if c in (1, 2):  # L and LA: gray in each colour channel
        return torch.cat([t[..., :1].expand(*t.shape[:2], 3), t[..., 1:] if c == 2 else opaque], -1)
    return t if c == 4 else torch.cat([t, opaque], -1)


def _check_size(w: int, h: int) -> None:
    if w > MAX_SIDE or h > MAX_SIDE:
        raise CodecError(f"encoding error 5: Image size exceeds WebP limit of {MAX_SIDE} pixels")


def _encode_frame(rgba, method: int, filter_strength: int) -> Tuple[bytes, Optional[bytes]]:
    """(H, W, 4) RGBA on any device → (the VP8 payload, the ALPH payload or
    None where every pixel is opaque): the planes imported on the device,
    then the host's coders."""
    from .. import native
    from .webp_yuv import import_yuva

    alpha = rgba[..., 3]
    transparent = bool((alpha != 255).any())
    y, u, v = import_yuva(rgba[..., :3], alpha if transparent else None)
    a = alpha.cpu().numpy() if transparent else None
    vp8 = native.vp8_encode(y.cpu().numpy(), u.cpu().numpy(), v.cpu().numpy(), QUALITY, method,
                            filter_strength, alpha=a)
    return vp8, (native.alph_encode(a) if transparent else None)


def _image_chunks(vp8: bytes, alph: Optional[bytes]) -> bytes:
    return (_chunk(b"ALPH", alph) if alph is not None else b"") + _chunk(b"VP8 ", vp8)


def _vp8x(flags: int, w: int, h: int) -> bytes:
    return _chunk(b"VP8X", bytes([flags, 0, 0, 0]) + _put24(w - 1) + _put24(h - 1))


def _still(vp8: bytes, alph: Optional[bytes], w: int, h: int, exif: bytes = b"",
           icc: bytes = b"", xmp: bytes = b"") -> bytes:
    if alph is None and not (exif or icc or xmp):
        return _riff(_chunk(b"VP8 ", vp8))
    flags = (ICCP_FLAG if icc else 0) | (ALPHA_FLAG if alph is not None else 0) | \
        (EXIF_FLAG if exif else 0) | (XMP_FLAG if xmp else 0)
    return _riff(_vp8x(flags, w, h) + (_chunk(b"ICCP", icc) if icc else b"") +
                 _image_chunks(vp8, alph) + (_chunk(b"EXIF", exif) if exif else b"") +
                 (_chunk(b"XMP ", xmp) if xmp else b""))


def write_webp(frame, exif: bytes = b"", icc: bytes = b"", xmp: bytes = b"") -> bytes:
    """One image → a still WebP, as Pillow's ``_save`` writes it (lossy,
    quality 80, method 4): a bare ``VP8 `` chunk where every pixel is opaque
    and there is no metadata, else ``VP8X`` (its flags and canvas), ``ICCP``,
    ``ALPH`` and ``VP8 ``, ``EXIF``, ``XMP `` (libwebp's muxer order)."""
    rgba = _rgba(frame)
    h, w = rgba.shape[:2]
    _check_size(w, h)
    vp8, alph = _encode_frame(rgba, STILL_METHOD, FILTER_STRENGTH)
    if exif.startswith(b"Exif\x00\x00"):
        exif = exif[6:]
    return _still(vp8, alph, w, h, exif, icc, xmp)


# anim_encode.c: the changed rectangle, and the blocks blending can keep

def _max_diff(quality: float) -> int:
    """QualityToMaxDiff: how far a pixel may move and still count as kept."""
    val = (quality / 100.0) ** 0.5
    return int(31 * (1 - val) + 1 * val + 0.5)


def _similar(src, dst, max_diff: int):
    """PixelsAreSimilar per pixel of two (..., 4) RGBA tensors."""
    import torch

    s, d = src.to(torch.int32), dst.to(torch.int32)
    da = d[..., 3:]
    return (s[..., 3] == d[..., 3]) & ((s[..., :3] - d[..., :3]).abs() * da <= max_diff * 255).all(-1)


def _changed_rect(prev, curr, max_diff: int) -> Optional[Tuple[int, int, int, int]]:
    """MinimizeChangeRectangle then SnapToEvenOffsets: the box (x, y, w, h)
    of the pixels that are not similar, its corner moved to even
    coordinates; None where every pixel is."""
    import torch

    changed = ~_similar(prev, curr, max_diff)
    rows = torch.nonzero(changed.any(1)).flatten()
    if rows.numel() == 0:
        return None
    cols = torch.nonzero(changed.any(0)).flatten()
    y0, y1 = int(rows[0]), int(rows[-1]) + 1
    x0, x1 = int(cols[0]), int(cols[-1]) + 1
    return x0 & ~1, y0 & ~1, x1 - (x0 & ~1), y1 - (y0 & ~1)


def _flatten_similar_blocks(prev, curr, rect, max_diff: int):
    """FlattenSimilarBlocks: each 8x8 block of the canvas grid inside the
    rectangle (from the grid line after its top and left edges) whose pixels
    are all opaque in ``prev`` and similar to ``curr`` becomes transparent,
    coloured with the mean of ``prev`` there; returns the new ``curr``."""
    import torch

    x, y, w, h = rect
    xs, xe = (x + 8) & ~7, (x + w) & ~7
    ys, ye = (y + 8) & ~7, (y + h) & ~7
    if xs >= xe or ys >= ye:
        return curr
    p, c = prev[ys:ye, xs:xe], curr[ys:ye, xs:xe]
    nby, nbx = (ye - ys) // 8, (xe - xs) // 8
    ok = (_similar(p, c, max_diff) & (p[..., 3] == 255)).reshape(nby, 8, nbx, 8).all(3).all(1)
    if not bool(ok.any()):
        return curr
    mean = (p[..., :3].to(torch.int32).reshape(nby, 8, nbx, 8, 3).sum((1, 3)) // 64)
    flat = torch.cat([mean, torch.zeros_like(mean[..., :1])], -1).to(torch.uint8)
    block = flat[:, None, :, None].expand(nby, 8, nbx, 8, 4).reshape(ye - ys, xe - xs, 4)
    mask = ok[:, None, :, None, None].expand(nby, 8, nbx, 8, 1).reshape(ye - ys, xe - xs, 1)
    curr = curr.clone()
    curr[ys:ye, xs:xe] = torch.where(mask, block, c)
    return curr


class _Frame:
    def __init__(self, rect, blend: bool, vp8: bytes, alph: Optional[bytes]):
        self.rect, self.blend, self.vp8, self.alph = rect, blend, vp8, alph
        self.duration = 0
        self.sub: Optional["_Frame"] = None  # a key frame's encoding as a sub-frame

    @property
    def size(self) -> int:
        return len(self.vp8) + (len(self.alph) if self.alph is not None else 0)


def _sub_frame(prev, curr, max_diff: int, first: bool) -> Optional[_Frame]:
    """The frame as a rectangle of what changed (None where nothing did),
    blended over the canvas before it with its kept blocks transparent (not
    the first frame's, which is a key frame over a transparent canvas)."""
    rect = _changed_rect(prev, curr, max_diff)
    if rect is None:
        if not first:
            return None
        rect = (0, 0, 1, 1)  # an empty first frame is 1x1
    if not first:
        curr = _flatten_similar_blocks(prev, curr, rect, max_diff)
    x, y, w, h = rect
    vp8, alph = _encode_frame(curr[y:y + h, x:x + w], ANIM_METHOD,
                              0 if not first else FILTER_STRENGTH)
    return _Frame(rect, not first, vp8, alph)


def _key_frame(curr) -> _Frame:
    h, w = curr.shape[:2]
    vp8, alph = _encode_frame(curr, ANIM_METHOD, FILTER_STRENGTH)
    return _Frame((0, 0, w, h), False, vp8, alph)


def write_animation(frames: list, durations=None, loop: int = 0) -> bytes:
    """Frames (as :func:`write_webp` takes them, one canvas size) → what
    Pillow's ``_save_all`` writes through libwebp's ``WebPAnimEncoder``
    (lossy, quality 80, method 0, kmin 3, kmax 5, background 0): one frame
    in all is :func:`write_webp`'s still. Else each frame is compared with
    the one before: one whose pixels all stay within ``QualityToMaxDiff`` of
    it is merged into it (its duration added); any other is the rectangle
    that changed, blended, with its unchanged 8x8 blocks transparent. From
    the fourth frame after a key frame to the sixth, each frame is also
    encoded whole, and the one of that window whose whole encoding costs
    least over its rectangle's becomes a key frame (anim_encode.c's
    CacheFrame). Where one frame is left after merging, it is written as a
    still; else ``VP8X`` (animation, and alpha where a frame has an ALPH
    chunk), ``ANIM`` and one ``ANMF`` per frame. ``durations``: ms per
    frame (0 by default, as the reference's ``imwritemulti`` leaves them),
    or one for all."""
    import torch

    if len(frames) == 1:
        return write_webp(frames[0])
    if not frames:
        raise CodecError("no frames to write")
    canvases = [_rgba(f) for f in frames]
    h, w = canvases[0].shape[:2]
    if any(tuple(c.shape[:2]) != (h, w) for c in canvases):  # WebPAnimEncoderAdd's errors
        raise RuntimeError("ERROR adding frame: Invalid frame dimensions.")
    if w > MAX_SIDE or h > MAX_SIDE:
        raise RuntimeError("ERROR adding frame. WebPEncodingError: 5.")
    if durations is None:
        durations = 0
    if not isinstance(durations, (list, tuple)):
        durations = [durations] * len(frames)
    max_diff = _max_diff(QUALITY)
    out: List[_Frame] = []
    prev = torch.zeros_like(canvases[0])  # the canvas starts transparent black
    since_key, best_delta, window_key = 0, None, None
    for i, curr in enumerate(canvases):
        frame = _sub_frame(prev, curr, max_diff, first=i == 0)
        if frame is None:  # merged into the frame before (and not counted)
            out[-1].duration += int(durations[i])
            continue
        if i > 0:
            since_key += 1
            if since_key > KMIN:
                key = _key_frame(curr)
                delta = key.size - frame.size
                if best_delta is None or delta <= best_delta:
                    if window_key is not None:  # the window's earlier pick goes back to its rectangle
                        out[window_key].sub.duration = out[window_key].duration
                        out[window_key] = out[window_key].sub
                    key.sub = frame
                    frame, best_delta, window_key = key, delta, len(out)
                if since_key >= KMAX:
                    since_key, best_delta, window_key = 0, None, None
        frame.duration = int(durations[i])
        out.append(frame)
        prev = curr
    if len(out) == 1:  # OptimizeSingleFrame: the one frame left, as a still
        f = out[0]
        if f.rect != (0, 0, w, h):
            f = _key_frame(canvases[0])
        return _still(f.vp8, f.alph, w, h)
    anim_alpha = any(f.alph is not None for f in out)
    body = _vp8x(ANIMATION_FLAG | (ALPHA_FLAG if anim_alpha else 0), w, h)
    body += _chunk(b"ANIM", struct.pack("<IH", 0, int(loop)))
    for f in out:
        x, y, fw, fh = f.rect
        head = _put24(x // 2) + _put24(y // 2) + _put24(fw - 1) + _put24(fh - 1) + \
            _put24(f.duration) + bytes([0 if f.blend else 2])
        body += _chunk(b"ANMF", head + _image_chunks(f.vp8, f.alph))
    return _riff(body)

