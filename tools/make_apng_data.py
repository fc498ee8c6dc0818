"""Write ``tests/data/apng/``: the animated PNG files that ``chip_smoke.py``
reads on the card (phases 3z and 4z) and ``tests/test_torch_apng.py``
reads on the CPU, with the truths in its ``manifest.json``.

Run it where Pillow 12.1 is present:

    python tools/make_apng_data.py [--out DIR]

Pillow writes most files (``save(save_all=True, ...)``): RGB with a list of
durations, RGBA with lists of disposals and blends over half-transparent
alpha, L, P with a transparent index, a repeated frame (merged into the one
before), ``default_image=True``, loops 0 and 3, and an 8-frame 1920x1080 RGB
animation for phase 4z's timings. :func:`apng_stream` builds, chunk by
chunk, what Pillow does not write: a 16-bit RGBA animation, an Adam7
interlaced one, a zero delay denominator, an ``OP_PREVIOUS`` first frame
and a 16-bit gray frame blended ``OP_OVER`` (Pillow 12.1 reads its first
frame and fails on the blend).
The manifest holds per file what the reference reads (``Image.open``, frame
by frame ``convert("RGB")``, flipped to BGR): the SHA-256 of every frame's
bytes, the shape, ``n_frames``, the durations and loop of its
``imreadanimation``, its ``imread_with_metadata`` dict, and the error
that stops the frames where there is one (``read_error``: Pillow 12.1
decodes only the first frame of an interlaced APNG, and cannot convert a
16-bit gray box to RGBA to blend it); and the control
chunks of what the reference writes of those frames: ``imwritemulti``'s
(no durations, loop 0) and ``imwriteanimation``'s (the durations and loop
read), as ``acTL`` (frames, plays) and each ``fcTL`` (width, height, x, y,
delay numerator and denominator, dispose, blend), with the SHA-256 of the
frames Pillow reads back. The port never runs this script; a second run
rewrites the directory byte for byte.
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
import os
import struct
import sys
import zlib

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402

OUT = os.path.join(ROOT, "tests", "data", "apng")
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _rows(samples: np.ndarray, depth: int) -> bytes:
    """Rows of (h, w, ch) samples (u8, or u16 written big-endian), each
    with filter byte 0."""
    h = samples.shape[0]
    raw = samples.astype(">u2").tobytes() if depth == 16 else samples.astype(np.uint8).tobytes()
    stride = len(raw) // h if h else 0
    return b"".join(b"\x00" + raw[i * stride:(i + 1) * stride] for i in range(h))


def image_data(samples: np.ndarray, depth: int, interlace: bool) -> bytes:
    """zlib of an image's rows (Adam7 passes one after another when
    ``interlace``)."""
    if not interlace:
        return zlib.compress(_rows(samples, depth))
    h, w = samples.shape[:2]
    out = b""
    for x0, y0, dx, dy in _ADAM7:
        sub = samples[y0::dy, x0::dx]
        if sub.size:
            out += _rows(sub, depth)
    return zlib.compress(out)


def apng_stream(size, depth: int, ctype: int, frames: list, plays: int = 0, interlace=False,
                palette=None, trns=None, default=None, n_frames=None) -> bytes:
    """An animated PNG built chunk by chunk. ``frames``: dicts of
    ``samples`` (h, w, ch), ``xy`` (offset), ``delay`` (num, den),
    ``dispose``, ``blend``; the first is in IDAT unless ``default`` (the
    samples of a default image) is given."""
    w, h = size
    out = [b"\x89PNG\r\n\x1a\n",
           _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace))),
           _chunk(b"acTL", struct.pack(">II", len(frames) if n_frames is None else n_frames,
                                       plays))]
    if palette is not None:
        out.append(_chunk(b"PLTE", bytes(np.asarray(palette, np.uint8).ravel())))
    if trns is not None:
        out.append(_chunk(b"tRNS", trns))
    if default is not None:
        out.append(_chunk(b"IDAT", image_data(default, depth, interlace)))
    seq = 0
    for k, f in enumerate(frames):
        fh, fw = f["samples"].shape[:2]
        x, y = f.get("xy", (0, 0))
        num, den = f.get("delay", (1, 10))
        out.append(_chunk(b"fcTL", struct.pack(">IIIIIHHBB", seq, fw, fh, x, y, num, den,
                                               f.get("dispose", 0), f.get("blend", 0))))
        seq += 1
        data = image_data(f["samples"], depth, interlace)
        if k == 0 and default is None:
            out.append(_chunk(b"IDAT", data))
        else:
            out.append(_chunk(b"fdAT", struct.pack(">I", seq) + data))
            seq += 1
    out.append(_chunk(b"IEND", b""))
    return b"".join(out)


def _pillow(frames: list, **kw) -> bytes:
    """What Pillow's ``save(save_all=True, ...)`` writes of the frames
    (arrays, or Pillow images)."""
    from PIL import Image

    ims = [f if isinstance(f, Image.Image) else Image.fromarray(f) for f in frames]
    buf = io.BytesIO()
    ims[0].save(buf, "PNG", save_all=True, append_images=ims[1:], **kw)
    return buf.getvalue()


def files() -> dict:
    """{file name: bytes}, every file of the directory but the manifest."""
    from PIL import Image

    rng = np.random.default_rng(25)
    h, w = 45, 61

    def moving(n: int, ch: int, step: int = 7) -> list:
        base = rng.integers(0, 256, (h, w, ch), np.uint8)
        out = []
        for i in range(n):
            f = base.copy()
            f[5 + i * 3:20 + i * 3, 4 + step * i:19 + step * i] = rng.integers(0, 256, ch)
            out.append(f)
        return out

    rgba = moving(5, 4)
    for i, f in enumerate(rgba):
        f[..., 3] = [0, 128, 255, 77, 200][i]
        f[::3, ::4, 3] = 255
    pal = [Image.fromarray(f).quantize(12) for f in moving(4, 3)]
    rep = moving(3, 3)
    out = {
        "rgb_durations.png": _pillow(moving(4, 3), duration=[40, 70, 100, 33]),
        "rgba_dispose_blend.png": _pillow(rgba, duration=50, disposal=[0, 1, 2, 0, 1],
                                          blend=[0, 1, 1, 0, 1]),
        "gray_l.png": _pillow([f[..., 0] for f in moving(4, 3)], duration=[20, 40, 60, 80],
                              loop=3),
        "p_transparency.png": _pillow(pal, transparency=3, duration=90, blend=1),
        "repeated_frame.png": _pillow([rep[0], rep[1], rep[1].copy(), rep[2]],
                                      duration=[10, 20, 30, 40]),
        "default_image.png": _pillow(moving(3, 3), duration=[25, 50], default_image=True),
        "loop0_rgb.png": _pillow(moving(3, 3), loop=0, duration=60),
    }
    # what Pillow does not write, chunk by chunk
    s16 = rng.integers(0, 65536, (h, w, 4)).astype(np.uint16)
    box = rng.integers(0, 65536, (10, 12, 4)).astype(np.uint16)
    box[..., 3] = np.array([0, 30000, 65535])[rng.integers(0, 3, (10, 12))]
    out["rgba16.png"] = apng_stream((w, h), 16, 6, [
        dict(samples=s16), dict(samples=box, xy=(20, 9), blend=1, dispose=1),
        dict(samples=box[::-1], xy=(3, 30), blend=0)], plays=2)
    ri = rng.integers(0, 256, (h, w, 3), np.uint8)
    out["interlaced.png"] = apng_stream((w, h), 8, 2, [
        dict(samples=ri), dict(samples=rng.integers(0, 256, (13, 21, 3), np.uint8), xy=(30, 20)),
        dict(samples=rng.integers(0, 256, (1, 5, 3), np.uint8), xy=(2, 2))], interlace=True)
    out["delay_den0.png"] = apng_stream((w, h), 8, 2, [
        dict(samples=ri, delay=(7, 0)), dict(samples=ri[:9, :9], xy=(1, 1), delay=(3, 0))])
    g = rng.integers(0, 256, (h, w, 2), np.uint8)
    out["previous_first.png"] = apng_stream((w, h), 8, 4, [
        dict(samples=g, dispose=2), dict(samples=g[:20, :30], xy=(10, 10), dispose=2, blend=1),
        dict(samples=g[5:25, 5:15], xy=(40, 5), dispose=0, blend=1)])
    g16 = rng.integers(0, 65536, (h, w, 1))
    out["gray16_blend.png"] = apng_stream((w, h), 16, 0, [
        dict(samples=g16, dispose=1), dict(samples=g16[10:30, 5:40] // 3, xy=(12, 8), blend=1)])
    out["anim8_1920x1080.png"] = _pillow(chip_smoke.apng_timing_frames(), duration=40)
    return out


def _bgr(f) -> np.ndarray:
    a = np.asarray(f.convert("RGB"))
    return np.ascontiguousarray(a[..., ::-1])


def read_truths(data: bytes) -> dict:
    """What the reference reads of one file."""
    from PIL import Image, ImageSequence

    frames, durations, error = [], [], None
    with Image.open(io.BytesIO(data)) as im:
        meta = {str(k): str(v) for k, v in (im.info or {}).items()
                if isinstance(v, (str, int, float))}
        loop = int(im.info.get("loop", 0))
        n = int(getattr(im, "n_frames", 1))
        try:
            for f in ImageSequence.Iterator(im):
                frames.append(_bgr(f))
                durations.append(int(f.info.get("duration", 100)))
        except Exception as e:  # Pillow 12.1 fails on an interlaced APNG's later frames, a 16-bit gray blend
            error = type(e).__name__
    return {"sha256": [hashlib.sha256(f.tobytes()).hexdigest() for f in frames],
            "shape": list(frames[0].shape), "n_frames": n, "durations": durations, "loop": loop,
            "metadata": meta, "read_error": error}, frames


def write_truths(frames: list, durations: list, loop: int) -> dict:
    """The control chunks and the frames read back of what the reference
    writes of ``frames`` (BGR): ``imwritemulti`` and ``imwriteanimation``."""
    from PIL import Image, ImageSequence

    rgb = [f[..., ::-1] for f in frames]
    out = {}
    for name, kw in (("writemulti", {}), ("writeanimation", {"duration": durations,
                                                             "loop": loop})):
        data = _pillow(rgb, **kw)
        with Image.open(io.BytesIO(data)) as im:
            back = [_bgr(f) for f in ImageSequence.Iterator(im)]
        out[name] = dict(chip_smoke.apng_controls(data), sha256=[hashlib.sha256(f.tobytes()).hexdigest()
                                                 for f in back])
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    manifest = {}
    for name, data in sorted(files().items()):
        with open(os.path.join(args.out, name), "wb") as f:
            f.write(data)
        truth, frames = read_truths(data)
        truth.update(write_truths(frames, truth["durations"], truth["loop"]))
        manifest[name] = truth
        print(f"{name}: {len(data)} bytes, {truth['n_frames']} frames", flush=True)
    with open(os.path.join(args.out, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
