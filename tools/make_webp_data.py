"""Write ``tests/data/webp/``: the WebP files that ``chip_smoke.py`` reads on
the card and holds to the truths in its ``manifest.json``, and the encoder
that ``tests/test_torch_webp.py`` writes its streams with.

Run it only where Pillow with its bundled libwebp 1.6.0 is present: it loads
that libwebp with ctypes (``encode``) to reach every ``WebPConfig`` field,
which Pillow's ``save`` does not expose (``filter_type``,
``filter_sharpness``, ``segments``, ``partitions``, ``alpha_filtering``,
``alpha_compression``, ``near_lossless``, ...), and reads each file back
with Pillow for the manifest. The port never runs it, and nothing at run
time needs Pillow or libwebp.

    python tools/make_webp_data.py [--out DIR]

The files are small stills at 641x361 and a few odd tiny sizes (lossy with
each filter type, several segments and partitions; lossless with each
transform; both alpha compressions and each alpha filter), a hand-muxed
animation with sub-rectangle, blended and disposed frames, and for phase 4x
the 1920x1080 test pattern as lossy q80 and as lossless, and an 8-frame
640x360 lossy animation. The manifest holds, per file, the SHA-256 of every
frame's BGR bytes as the reference reads them (``Image.open(...)`` frame by
frame, ``convert("RGB")``, flipped), the shapes, ``n_frames``, the
durations, the loop and the reference's metadata dict. Writing is
deterministic: a second run rewrites the directory byte for byte.
"""

from __future__ import annotations

import argparse
import ctypes
import glob
import hashlib
import io
import json
import os
import struct
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "webp")
ENCODER_ABI = 0x0210  # WEBP_ENCODER_ABI_VERSION of libwebp 1.6 (the major byte is checked)


class Config(ctypes.Structure):
    """libwebp 1.6's ``WebPConfig``."""

    _fields_ = [(n, ctypes.c_float if n in ("quality", "target_PSNR") else ctypes.c_int) for n in (
        "lossless", "quality", "method", "image_hint", "target_size", "target_PSNR", "segments",
        "sns_strength", "filter_strength", "filter_sharpness", "filter_type", "autofilter",
        "alpha_compression", "alpha_filtering", "alpha_quality", "pass", "show_compressed",
        "preprocessing", "partitions", "partition_limit", "emulate_jpeg_size", "thread_level",
        "low_memory", "near_lossless", "exact", "use_delta_palette", "use_sharp_yuv", "qmin",
        "qmax")]


_p, _i, _u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32


class Picture(ctypes.Structure):
    """libwebp 1.6's ``WebPPicture``."""

    _fields_ = [("use_argb", _i), ("colorspace", _i), ("width", _i), ("height", _i),
                ("y", _p), ("u", _p), ("v", _p), ("y_stride", _i), ("uv_stride", _i),
                ("a", _p), ("a_stride", _i), ("pad1", _u * 2), ("argb", _p), ("argb_stride", _i),
                ("pad2", _u * 3), ("writer", _p), ("custom_ptr", _p), ("extra_info_type", _i),
                ("extra_info", _p), ("stats", _p), ("error_code", _i), ("progress_hook", _p),
                ("user_data", _p), ("pad3", _u * 3), ("pad4", _p), ("pad5", _p),
                ("pad6", _u * 8), ("memory_", _p), ("memory_argb_", _p), ("pad7", _p * 2)]


class MemoryWriter(ctypes.Structure):
    _fields_ = [("mem", ctypes.POINTER(ctypes.c_uint8)), ("size", ctypes.c_size_t),
                ("max_size", ctypes.c_size_t), ("pad", _u)]


_LIB = None


def lib() -> ctypes.CDLL:
    """Pillow's bundled libwebp (its libsharpyuv loaded first, globally)."""
    global _LIB
    if _LIB is None:
        import PIL

        libdir = os.path.realpath(os.path.join(os.path.dirname(PIL.__file__), "..", "pillow.libs"))
        ctypes.CDLL(glob.glob(os.path.join(libdir, "libsharpyuv-*.so*"))[0], mode=ctypes.RTLD_GLOBAL)
        w = ctypes.CDLL(glob.glob(os.path.join(libdir, "libwebp-*.so*"))[0])
        w.WebPGetEncoderVersion.restype = _i
        if w.WebPGetEncoderVersion() != 0x010600:
            raise RuntimeError(f"libwebp {w.WebPGetEncoderVersion():#08x}, not 1.6.0")
        w.WebPConfigInitInternal.argtypes = [ctypes.POINTER(Config), _i, ctypes.c_float, _i]
        w.WebPPictureInitInternal.argtypes = [ctypes.POINTER(Picture), _i]
        w.WebPPictureImportRGBA.argtypes = [ctypes.POINTER(Picture), _p, _i]
        w.WebPPictureImportRGB.argtypes = [ctypes.POINTER(Picture), _p, _i]
        w.WebPMemoryWriterInit.argtypes = [ctypes.POINTER(MemoryWriter)]
        w.WebPMemoryWriterClear.argtypes = [ctypes.POINTER(MemoryWriter)]
        w.WebPEncode.argtypes = [ctypes.POINTER(Config), ctypes.POINTER(Picture)]
        w.WebPPictureFree.argtypes = [ctypes.POINTER(Picture)]
        w.WebPValidateConfig.argtypes = [ctypes.POINTER(Config)]
        _LIB = w
    return _LIB


def encode(img: np.ndarray, lossless: bool = False, quality: float = 75.0, **fields) -> bytes:
    """A WebP file of ``img`` ((H, W, 3) RGB or (H, W, 4) RGBA u8) as
    ``WebPEncode`` writes it, every other ``WebPConfig`` field by name."""
    w = lib()
    img = np.ascontiguousarray(img, np.uint8)
    cfg = Config()
    if not w.WebPConfigInitInternal(ctypes.byref(cfg), 0, ctypes.c_float(quality), ENCODER_ABI):
        raise RuntimeError("WebPConfigInit failed")
    cfg.lossless = int(lossless)
    for k, v in fields.items():
        setattr(cfg, k, v)
    if not w.WebPValidateConfig(ctypes.byref(cfg)):
        raise ValueError(f"invalid WebPConfig {fields}")
    pic = Picture()
    if not w.WebPPictureInitInternal(ctypes.byref(pic), ENCODER_ABI):
        raise RuntimeError("WebPPictureInit failed")
    pic.use_argb = int(lossless)
    pic.height, pic.width = img.shape[:2]
    importer = w.WebPPictureImportRGBA if img.shape[2] == 4 else w.WebPPictureImportRGB
    if not importer(ctypes.byref(pic), img.ctypes.data, img.strides[0]):
        raise RuntimeError("WebPPictureImport failed")
    wr = MemoryWriter()
    w.WebPMemoryWriterInit(ctypes.byref(wr))
    pic.writer = ctypes.cast(w.WebPMemoryWrite, _p).value
    pic.custom_ptr = ctypes.cast(ctypes.byref(wr), _p).value
    try:
        if not w.WebPEncode(ctypes.byref(cfg), ctypes.byref(pic)):
            raise RuntimeError(f"WebPEncode failed (error {pic.error_code})")
        return ctypes.string_at(wr.mem, wr.size)
    finally:
        w.WebPPictureFree(ctypes.byref(pic))
        w.WebPMemoryWriterClear(ctypes.byref(wr))


# -- the container, muxed by hand ------------------------------------------


def chunk(tag: bytes, body: bytes) -> bytes:
    """One RIFF chunk, padded to an even size."""
    return tag + struct.pack("<I", len(body)) + body + b"\x00" * (len(body) & 1)


def chunks(data: bytes) -> list:
    """[(tag, body)] of a WebP file's top-level chunks."""
    out, p = [], 12
    while p + 8 <= len(data):
        tag, n = data[p:p + 4], struct.unpack("<I", data[p + 4:p + 8])[0]
        out.append((tag, data[p + 8:p + 8 + n]))
        p += 8 + n + (n & 1)
    return out


def image_chunks(data: bytes) -> bytes:
    """The ALPH (if any) and VP8/VP8L chunks of a still WebP, as bytes."""
    return b"".join(chunk(t, b) for t, b in chunks(data) if t in (b"ALPH", b"VP8 ", b"VP8L"))


def riff(body: bytes) -> bytes:
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body


def u24(v: int) -> bytes:
    return struct.pack("<I", v)[:3]


def vp8x(w: int, h: int, flags: int) -> bytes:
    """A VP8X chunk: flags ICCP 0x20, ALPHA 0x10, EXIF 0x08, XMP 0x04, ANIM 0x02."""
    return chunk(b"VP8X", bytes([flags, 0, 0, 0]) + u24(w - 1) + u24(h - 1))


def still(data: bytes, icc: bytes = None, exif: bytes = None, xmp: bytes = None,
          extra: bytes = b"") -> bytes:
    """A still WebP re-muxed with VP8X and the metadata chunks (``extra``:
    raw chunks put before the image, such as an unknown chunk)."""
    import PIL.Image

    im = PIL.Image.open(io.BytesIO(data))
    alpha = any(t == b"ALPH" for t, _ in chunks(data)) or (
        chunks(data)[-1][0] == b"VP8L" and im.mode == "RGBA")
    flags = (0x20 if icc else 0) | (0x10 if alpha else 0) | (0x08 if exif else 0) | (
        0x04 if xmp else 0)
    body = vp8x(*im.size, flags) + (chunk(b"ICCP", icc) if icc else b"") + extra
    body += image_chunks(data) + (chunk(b"EXIF", exif) if exif else b"") + (
        chunk(b"XMP ", xmp) if xmp else b"")
    return riff(body)


def animation(w: int, h: int, frames: list, loop: int = 0, background=(255, 255, 255, 255),
              alpha: bool = True) -> bytes:
    """An animated WebP muxed by hand. ``frames``: dicts with ``data`` (a
    still WebP file whose image chunks the frame carries), ``x``, ``y``
    (even), ``duration``, ``dispose`` (1: to background) and ``blend``
    (False: no blend)."""
    r, g, b, a = background
    body = vp8x(w, h, 0x02 | (0x10 if alpha else 0)) + chunk(
        b"ANIM", bytes([b, g, r, a]) + struct.pack("<H", loop))
    for f in frames:
        import PIL.Image

        fw, fh = PIL.Image.open(io.BytesIO(f["data"])).size
        bits = (1 if f.get("dispose") else 0) | (0 if f.get("blend", True) else 2)
        head = u24(f.get("x", 0) // 2) + u24(f.get("y", 0) // 2) + u24(fw - 1) + u24(fh - 1)
        body += chunk(b"ANMF", head + u24(f.get("duration", 100)) + bytes([bits]) +
                      image_chunks(f["data"]))
    return riff(body)


def alph_raw(data: bytes, alpha: np.ndarray, filt: int) -> bytes:
    """``data`` (a lossy still) with its alpha replaced by an uncompressed
    ALPH chunk of ``alpha`` under filter ``filt`` (0 none, 1 horizontal, 2
    vertical, 3 gradient), filtered as libwebp's encoder filters."""
    a = alpha.astype(np.int16)
    f = np.zeros_like(a)
    if filt == 0:
        f = a
    else:
        f[0, 0] = a[0, 0]
        f[0, 1:] = a[0, 1:] - a[0, :-1]  # the first row is horizontal in every filter
        if filt == 1:
            f[1:, 0] = a[1:, 0] - a[:-1, 0]
            f[1:, 1:] = a[1:, 1:] - a[1:, :-1]
        elif filt == 2:
            f[1:, :] = a[1:, :] - a[:-1, :]
        else:
            f[1:, 0] = a[1:, 0] - a[:-1, 0]
            g = a[1:, :-1] + a[:-1, 1:] - a[:-1, :-1]
            f[1:, 1:] = a[1:, 1:] - np.clip(g, 0, 255)
    body = bytes([filt << 2]) + (f & 0xFF).astype(np.uint8).tobytes()
    vp8 = [(t, b) for t, b in chunks(data) if t == b"VP8 "][0][1]
    h, w = alpha.shape
    return riff(vp8x(w, h, 0x10) + chunk(b"ALPH", body) + chunk(b"VP8 ", vp8))


# -- the fixtures -------------------------------------------------------------


def pattern(w: int, h: int, seed: int = 0, noise: bool = True) -> np.ndarray:
    """(H, W, 3) RGB: gradients, flat fields, edges and (``noise``) noise on
    the right half (a seeded stand-in for a camera frame)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.zeros((h, w, 3), np.float64)
    img[..., 0] = 255 * x / max(w - 1, 1)
    img[..., 1] = 255 * y / max(h - 1, 1)
    img[..., 2] = 128 + 100 * np.sin(x / 9.0) * np.cos(y / 13.0)
    img[(x // 40 + y // 40) % 2 == 0] *= 0.6
    img[h // 3:h // 2, w // 4:w // 2] = (30, 200, 90)  # a flat field
    if noise:
        img += rng.normal(0, 12, img.shape) * ((x > w // 2)[..., None])
    return np.clip(img, 0, 255).astype(np.uint8)


def alpha_of(w: int, h: int) -> np.ndarray:
    y, x = np.mgrid[0:h, 0:w]
    a = (255 * (x + y) / max(w + h - 2, 1)).astype(np.uint8)
    a[(x // 16) % 3 == 0] = 0
    a[(y // 16) % 4 == 1] = 255
    return a


def palette_image(w: int, h: int, n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    pal = rng.integers(0, 256, (n, 4), dtype=np.uint8)
    pal[:, 3] = 255
    y, x = np.mgrid[0:h, 0:w]
    return pal[((x // 7) * 3 + (y // 5)) % n]


def fixtures() -> dict:
    """{name: bytes} of every fixture."""
    w, h = 641, 361
    img = pattern(w, h)
    smooth = pattern(w, h, noise=False)  # lossless files stay small
    rgba = np.dstack([img, alpha_of(w, h)])
    out = {
        "lossy_simple.webp": encode(img, quality=75, filter_type=0, filter_strength=60,
                                    segments=1, partitions=0),
        "lossy_normal_seg4_part3.webp": encode(img, quality=50, filter_type=1,
                                               filter_strength=40, filter_sharpness=3,
                                               segments=4, partitions=3, method=6),
        "lossy_q100_nofilter.webp": encode(img, quality=100, filter_strength=0, segments=2,
                                           partitions=1, method=2),
        "lossless_m0.webp": encode(smooth, lossless=True, quality=0, method=0),
        "lossless_m6.webp": encode(smooth, lossless=True, quality=100, method=6),
        "lossless_palette16.webp": encode(palette_image(w, h, 16), lossless=True, quality=50,
                                          method=4),
        "lossless_palette2_w1.webp": encode(palette_image(1, 37, 2), lossless=True),
        "alpha_lossy_vp8l.webp": encode(rgba, quality=70, alpha_compression=1,
                                        alpha_filtering=2),
        "alpha_lossy_raw.webp": encode(rgba, quality=70, alpha_compression=0,
                                       alpha_filtering=1),
        "alpha_lossless.webp": encode(np.dstack([smooth, alpha_of(w, h)]), lossless=True,
                                      quality=75, exact=1),
        "tiny_1x1.webp": encode(pattern(1, 1), quality=80),
        "tiny_17x33.webp": encode(pattern(17, 33, 3), quality=30, filter_type=1,
                                  filter_strength=100),
        "meta_exif_icc_xmp.webp": still(encode(pattern(33, 17, 4), quality=80),
                                        icc=b"\x00" * 31, exif=_exif(),
                                        xmp=b"<x:xmpmeta>tiff:Orientation=\"3\"</x:xmpmeta>",
                                        extra=chunk(b"ZZZZ", b"odd")),
    }
    fw, fh = 96, 64
    f0 = np.dstack([pattern(fw, fh, 5), np.full((fh, fw), 255, np.uint8)])
    sub = np.dstack([pattern(40, 30, 6), alpha_of(40, 30)])
    out["anim_blend_dispose.webp"] = animation(fw, fh, [
        {"data": encode(f0, quality=60), "duration": 40},
        {"data": encode(sub, lossless=True), "x": 10, "y": 8, "duration": 80, "dispose": 1},
        {"data": encode(sub[::-1].copy(), quality=50), "x": 30, "y": 20, "duration": 120},
        {"data": encode(sub, lossless=True, exact=1), "x": 50, "y": 30, "blend": False,
         "duration": 60, "dispose": 1},
    ], loop=3)
    big = pattern(1920, 1080, 7)
    out["p1080_lossy_q80.webp"] = encode(big, quality=80, method=4)
    out["p1080_lossless.webp"] = encode(pattern(1920, 1080, 7, noise=False), lossless=True,
                                        quality=25, method=1)
    aw, ah = 640, 360
    out["anim8_640x360.webp"] = animation(aw, ah, [
        {"data": encode(np.roll(pattern(aw, ah, 8), 24 * i, axis=1), quality=80, method=0),
         "duration": 40} for i in range(8)], loop=0, alpha=False)
    return out


def _exif() -> bytes:
    """EXIF with Orientation 3 and Make "Cam" (little-endian IFD0)."""
    ifd = struct.pack("<H", 2) + struct.pack("<HHII", 0x010F, 2, 4, 0x00) + struct.pack(
        "<HHIHH", 0x0112, 3, 1, 3, 0) + struct.pack("<I", 0)
    ifd = ifd.replace(struct.pack("<HHII", 0x010F, 2, 4, 0), struct.pack("<HHI", 0x010F, 2, 4)
                      + b"Cam\x00")
    return b"Exif\x00\x00II*\x00" + struct.pack("<I", 8) + ifd


def truth(data: bytes) -> dict:
    """What the reference reads of ``data``: per-frame BGR hashes and
    shapes, ``n_frames``, durations, loop and the metadata dict."""
    from PIL import Image, ImageSequence

    with Image.open(io.BytesIO(data)) as im:
        meta = {str(k): str(v) for k, v in (im.info or {}).items()
                if isinstance(v, (str, int, float))}
        for k, v in im.getexif().items():
            meta[f"exif:{k}"] = str(v)
        n = int(getattr(im, "n_frames", 1))
        loop = int(im.info.get("loop", 0))
        hashes, shapes, durations = [], [], []
        for fr in ImageSequence.Iterator(im):
            bgr = np.ascontiguousarray(np.asarray(fr.convert("RGB"))[..., ::-1])
            hashes.append(hashlib.sha256(bgr.tobytes()).hexdigest())
            shapes.append(list(bgr.shape))
            durations.append(int(fr.info.get("duration", 100)))
    return {"bytes": len(data), "sha256": hashlib.sha256(data).hexdigest(), "n_frames": n,
            "loop": loop, "durations": durations, "shapes": shapes, "frames": hashes,
            "metadata": meta}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    manifest = {}
    for name, data in sorted(fixtures().items()):
        with open(os.path.join(args.out, name), "wb") as f:
            f.write(data)
        manifest[name] = truth(data)
    with open(os.path.join(args.out, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(os.path.getsize(os.path.join(args.out, n)) for n in os.listdir(args.out))
    print(f"make_webp_data: {len(manifest)} files and manifest.json, {total} bytes in {args.out}")


if __name__ == "__main__":
    sys.exit(main())
