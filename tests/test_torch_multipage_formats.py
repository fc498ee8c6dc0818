"""TIFF and GIF, every page and frame (ROADMAP Queue 1 item 8b), on the CPU
against Pillow 12, which the JAX package's codecs reach, and against
``rustcv_tpu.imgcodecs`` and ``rustcv_tpu.cv2`` call for call.

* Reads are exact: ``imread``, ``imdecode``, ``imreadmulti`` and
  ``imcount`` of every TIFF form the port reads (each compression Pillow
  writes, each mode, predictor 2; tiles, big-endian, planar 2, BigTIFF,
  fill order 2, sub-byte photometric 0, associated alpha, orientation,
  written by ``chip_smoke.tiff_file``) and every GIF form (Pillow's
  animations; ``chip_smoke.gif_file``'s local palettes, interlace, offsets,
  transparency, each disposal and LZW code size) equal Pillow's
  ``convert("RGB")`` of each page and frame, and its ``n_frames``. The forms
  left for later raise ``not_ported`` (item 8).
* Metadata: ``imread_with_metadata`` and ``cv2.imdecodeWithMetadata`` give
  the reference's dicts, key for key and in order.
* TIFF writes: Pillow reads them back to exactly the input, with the
  reference's ``n_frames``, mode and tags 256, 257, 258, 259, 262, 277 and
  284.
* GIF writes (since item 8d-i with Pillow's own median cut,
  tests/test_torch_quantize.py): read back by Pillow, the frame count,
  durations and loop equal the reference's write of the same frames; where
  the reference's round trip is exact the port's is; per frame and channel
  the max and mean |diff| against the input are no larger than the
  reference's (:data:`GIF_BAR_FRAMES`; the seeded frames the port's own cut
  once missed by a level are
  :func:`test_gif_write_max_error_where_the_port_misses` and the two after
  it).
* cv2's ``imcount``, ``imreadmulti``, ``imwritemulti``, ``haveImageReader``
  and the six multi-page and animation calls answer as ``rustcv_tpu.cv2``
  does for TIFF, GIF and the still formats (and, since items 8c, 8c-ii
  and 8d-i, for the reads and writes of an animated WebP and an animated
  PNG, tests/test_torch_apng.py).

Sizes are small and odd (23x17, 37x23); inputs come from numpy seeds.
"""

import io
import struct
import warnings

import numpy as np
import pytest
from PIL import Image, ImageSequence, TiffImagePlugin

import chip_smoke as S
import rustcv_tpu.cv2 as R
from rustcv_tpu import imgcodecs as jax_codecs
from rustcv_tpu.core.mat import Mat as JMat
import rustcv_tpu_torch.cv2 as P
from rustcv_tpu_torch import core, imgcodecs, native
from rustcv_tpu_torch.core import Mat
from rustcv_tpu_torch.imgcodecs import exif, gif, quantize, tiff

W, H = 23, 17


def _rng(seed):
    return np.random.default_rng(seed)


def _pillow_frames(data):
    """The reference's reads: each page or frame, RGB → BGR, and n_frames."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        im = Image.open(io.BytesIO(data))
        frames = [np.asarray(f.convert("RGB"))[..., ::-1].copy() for f in ImageSequence.Iterator(im)]
        return frames, getattr(Image.open(io.BytesIO(data)), "n_frames", 1)


def _reads_as_pillow(data, tmp_path, name="x.img"):
    """imread, imdecode, imreadmulti and imcount of ``data`` equal Pillow's,
    byte for byte, on every page."""
    want, n = _pillow_frames(data)
    path = tmp_path / name
    path.write_bytes(data)
    assert imgcodecs.imcount(str(path)) == n == len(want)
    got = [m.to_numpy() for m in imgcodecs.imreadmulti(str(path), device="cpu")]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.array_equal(g, w)
    assert np.array_equal(imgcodecs.imread(str(path), device="cpu").to_numpy(), want[0])
    assert np.array_equal(imgcodecs.imdecode(data, device="cpu").to_numpy(), want[0])
    return want


def _pillow_tiff(im, **kw):
    buf = io.BytesIO()
    im.save(buf, "TIFF", **kw)
    return buf.getvalue()


def _mode_image(mode, seed, w=W, h=H):
    rng = _rng(seed)
    if mode == "1":
        return Image.fromarray(rng.integers(0, 2, (h, w)).astype(bool))
    if mode == "P":
        return Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8)).quantize(40)
    if mode == "I;16":
        return Image.frombytes(mode, (w, h), rng.integers(0, 700, (h, w)).astype("<u2").tobytes())
    if mode == "I":
        return Image.frombytes(mode, (w, h), rng.integers(-300, 600, (h, w)).astype("<i4").tobytes())
    if mode == "F":
        return Image.frombytes(mode, (w, h), rng.normal(100, 120, (h, w)).astype("<f4").tobytes())
    bands = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4, "CMYK": 4}[mode]
    return Image.frombytes(mode, (w, h), rng.integers(0, 256, (h, w, bands), np.uint8).tobytes())


# -- TIFF reads ----------------------------------------------------------------------

MODES = ["1", "L", "LA", "P", "RGB", "RGBA", "CMYK", "I;16", "I", "F"]
COMPRESSIONS = ["raw", "packbits", "tiff_lzw", "tiff_adobe_deflate", "tiff_deflate"]


@pytest.mark.parametrize("comp", COMPRESSIONS)
@pytest.mark.parametrize("mode", MODES)
def test_tiff_pillow_writes_each_compression_and_mode(comp, mode, tmp_path):
    _reads_as_pillow(_pillow_tiff(_mode_image(mode, 1), compression=comp), tmp_path)


@pytest.mark.parametrize("comp", ["tiff_lzw", "tiff_adobe_deflate", "tiff_deflate"])
@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "CMYK", "I;16", "I", "F"])
def test_tiff_predictor_2(comp, mode, tmp_path):
    _reads_as_pillow(_pillow_tiff(_mode_image(mode, 2), compression=comp, tiffinfo={317: 2}),
                     tmp_path)


@pytest.mark.parametrize("comp", ["raw", "tiff_lzw"])
def test_tiff_pillow_multi_page(comp, tmp_path):
    ims = [_mode_image(m, 3 + i) for i, m in enumerate(["RGB", "L", "P", "CMYK", "I;16"])]
    buf = io.BytesIO()
    ims[0].save(buf, "TIFF", save_all=True, append_images=ims[1:], compression=comp)
    assert len(_reads_as_pillow(buf.getvalue(), tmp_path)) == 5


SMOKE_TIFFS = [name for name, _, _ in S.tiff_cases(8, 8)]


@pytest.mark.parametrize("name", SMOKE_TIFFS)
def test_tiff_forms_the_test_writes(name, tmp_path):
    """Tiles, big-endian, planar 2, BigTIFF, sub-byte photometric 0, fill
    order 2, associated alpha, orientation... (chip_smoke.tiff_file) against
    Pillow, and against chip_smoke.tiff_truth (phase 3w's truths)."""
    data, truths = {n: (d, t) for n, d, t in S.tiff_cases(W, H)}[name]
    want = _reads_as_pillow(data, tmp_path)
    assert all(np.array_equal(a, b) for a, b in zip(want, truths))


def _page(**kw):
    rng = _rng(kw.pop("seed", 4))
    spp = kw.pop("spp", 3)
    dtype = kw.pop("dtype", np.uint8)
    hi = kw.pop("hi", 256)
    return dict(samples=rng.integers(0, hi, (H, W, spp)).astype(dtype), **kw)


EXTRA_TIFFS = {
    "MM 16-bit gray, LZW": (dict(_page(spp=1, dtype=np.uint16, hi=65536), photo=1, comp=5), "MM"),
    "MM 16-bit RGBA, Deflate": (dict(_page(spp=4, dtype=np.uint16, hi=65536), photo=2, comp=8,
                                     extra=(2,)), "MM"),
    "16-bit CMYK": (dict(_page(spp=4, dtype=np.uint16, hi=65536), photo=5), "II"),
    "16-bit RGB, associated alpha": (dict(_page(spp=4, dtype=np.uint16, hi=65536), photo=2,
                                          extra=(1,)), "II"),
    "MM float32, Deflate (byte-swapped by Pillow)": (dict(
        samples=_rng(5).normal(100, 50, (H, W, 1)).astype(np.float32), photo=1, fmt=3, comp=8),
        "MM"),
    "MM int32, LZW (byte-swapped by Pillow)": (dict(_page(spp=1, dtype=np.int32, hi=900),
                                                     photo=1, fmt=2, comp=5), "MM"),
    "signed 16-bit gray": (dict(samples=_rng(6).integers(-500, 500, (H, W, 1)).astype(np.int16),
                                photo=1, fmt=2), "II"),
    "MM signed 16-bit gray, Deflate (byte-swapped by Pillow)": (dict(
        samples=_rng(6).integers(-500, 500, (H, W, 1)).astype(np.int16), photo=1, fmt=2, comp=8),
        "MM"),
    "RGBX": (dict(_page(spp=4), photo=2, extra=(0,)), "II"),
    "RGBXX, LZW": (dict(_page(spp=5), photo=2, extra=(0, 0), comp=5), "II"),
    "RGBA without ExtraSamples": (dict(_page(spp=4), photo=2), "II"),
    "CMYKX, PackBits": (dict(_page(spp=5), photo=5, extra=(0,), comp=32773), "MM"),
    "palette + alpha": (dict(_page(spp=2), photo=3, extra=(2,), colormap=_rng(7).integers(
        0, 65536, 768)), "II"),
    "1-bit palette, fill order 2, LZW": (dict(_page(spp=1, hi=2), photo=3, bits=1, fill=2,
                                              comp=5, colormap=_rng(8).integers(0, 65536, 6)),
                                         "II"),
    "2-bit WhiteIsZero, Deflate": (dict(_page(spp=1, hi=4), photo=0, bits=2, comp=8), "MM"),
    "8-bit WhiteIsZero, fill order 2, PackBits": (dict(_page(spp=1), photo=0, fill=2,
                                                       comp=32773), "II"),
    "bilevel, fill order 2": (dict(_page(spp=1, hi=2), photo=1, bits=1, fill=2), "MM"),
    "bilevel, LZW, fill order 2": (dict(_page(spp=1, hi=2), photo=1, bits=1, comp=5, fill=2),
                                   "II"),
    "raw with predictor 2 (ignored by Pillow)": (dict(_page(), photo=2, predictor=2), "II"),
    "planar RGBA, LZW": (dict(_page(spp=4), photo=2, planar=2, extra=(2,), comp=5), "MM"),
    "planar gray + alpha, Deflate": (dict(_page(spp=2), photo=1, planar=2, extra=(2,), comp=8),
                                     "II"),
    "planar associated alpha, LZW": (dict(_page(spp=4), photo=2, planar=2, extra=(1,), comp=5),
                                     "II"),
    "planar 16-bit RGB, Deflate": (dict(_page(spp=3, dtype=np.uint16, hi=65536), photo=2,
                                        planar=2, comp=8), "MM"),
    "planar 16-bit gray, LZW": (dict(_page(spp=1, dtype=np.uint16, hi=65536), photo=1, planar=2,
                                     comp=5), "II"),
    "raw planar CMYK": (dict(_page(spp=4), photo=5, planar=2), "II"),
    "tiles on the edge, PackBits": (dict(_page(), photo=2, comp=32773, tile=(16, 16)), "MM"),
    "raw tiles": (dict(_page(spp=1), photo=1, tile=(16, 16)), "II"),
    "one-row strips, Deflate": (dict(_page(), photo=2, comp=32946, rows=1), "II"),
}
for _o in range(1, 9):
    EXTRA_TIFFS[f"orientation {_o}"] = (dict(_page(), photo=2, comp=5, tags={274: (3, [_o])}), "II")


@pytest.mark.parametrize("name", list(EXTRA_TIFFS))
def test_tiff_more_forms(name, tmp_path):
    pg, order = EXTRA_TIFFS[name]
    _reads_as_pillow(S.tiff_file([pg], order), tmp_path)


def test_tiff_xmp_orientation_and_the_ifd_chain(tmp_path):
    """Orientation from the XMP packet (tag 700) where tag 274 is absent; a
    chain whose last IFD points back at the first ends there."""
    xmp = list(b'<x:xmpmeta><rdf:Description tiff:Orientation="8"/></x:xmpmeta>')
    data = S.tiff_file([dict(_page(), photo=2, tags={700: (1, xmp)})])
    _reads_as_pillow(data, tmp_path, "xmp.tif")
    two = bytearray(S.tiff_file([dict(_page(seed=1), photo=2), dict(_page(seed=2, spp=1),
                                                                     photo=1)]))
    first = struct.unpack("<L", two[4:8])[0]
    second = struct.unpack("<L", two[first + 2 + 12 * struct.unpack("<H", two[first:first + 2])[0]:][:4])[0]
    n2 = struct.unpack("<H", two[second:second + 2])[0]
    struct.pack_into("<L", two, second + 2 + 12 * n2, first)  # a loop back to page 0
    assert len(_reads_as_pillow(bytes(two), tmp_path, "loop.tif")) == 2


LATER_TIFFS = {
    "old-style JPEG": lambda: S.tiff_file([dict(_page(), photo=6, comp=6)]),
    "Group 4": lambda: _pillow_tiff(_mode_image("1", 9), compression="group4"),
    "Group 3": lambda: _pillow_tiff(_mode_image("1", 9), compression="group3"),
    "CCITT 1d": lambda: _pillow_tiff(_mode_image("1", 9), compression="tiff_ccitt"),
    "LZMA": lambda: _pillow_tiff(_mode_image("RGB", 9), compression="lzma"),
    "ZSTD": lambda: _pillow_tiff(_mode_image("RGB", 9), compression="zstd"),
    "CIELab": lambda: _pillow_tiff(_mode_image("RGB", 9).convert("LAB")),
    "predictor 3": lambda: _pillow_tiff(_mode_image("F", 9), compression="tiff_adobe_deflate",
                                        tiffinfo={317: 3}),
    "12-bit gray": lambda: S.tiff_file([dict(_page(spp=1, dtype=np.uint16, hi=4096), photo=1,
                                             bits=16, tags={258: (3, [12])})]),
    "old-style LZW": lambda: _old_style_lzw(),
}


def _old_style_lzw():
    """An LZW page whose strip starts 0x00 0x01: libtiff's old-style
    (LSB-first) LZW, which the port leaves for later."""
    data = bytearray(S.tiff_file([dict(_page(), photo=2, comp=5)]))
    off = tiff.Tiff(bytes(data)).setup(0)["offsets"][0]
    data[off:off + 2] = b"\x00\x01"
    return bytes(data)


@pytest.mark.parametrize("name", list(LATER_TIFFS))
def test_tiff_forms_left_for_later_raise_not_ported(name, tmp_path):
    data = LATER_TIFFS[name]()
    path = tmp_path / "x.tif"
    path.write_bytes(data)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 8"):
        imgcodecs.imreadmulti(str(path), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 8"):
        imgcodecs.imdecode(data, device="cpu")


REFUSED_TIFFS = {
    "unknown mode": lambda: S.tiff_file([dict(_page(spp=2), photo=2)]),
    "cut raw": lambda: _pillow_tiff(_mode_image("RGB", 1))[:-100],
    "cut LZW": lambda: (lambda d: d[:len(d) // 2])(_pillow_tiff(_mode_image("RGB", 1),
                                                               compression="tiff_lzw")),
    "big-endian BigTIFF": lambda: S.tiff_file([dict(_page(), photo=2)], "MM", big=True),
    "no IFD": lambda: b"II*\x00" + bytes(60),
    "raw planar gray + alpha": lambda: S.tiff_file([dict(_page(spp=2), photo=1, planar=2,
                                                         extra=(2,))]),
    "raw planar RGBX": lambda: S.tiff_file([dict(_page(spp=4), photo=2, planar=2, extra=(0,))]),
    "Deflate planar RGBX": lambda: S.tiff_file([dict(_page(spp=4), photo=2, planar=2, extra=(0,),
                                                     comp=8)]),
    "raw 8-bit WhiteIsZero, fill order 2": lambda: S.tiff_file([dict(_page(spp=1), photo=0,
                                                                     fill=2)]),
    "raw 4-bit palette, fill order 2": lambda: S.tiff_file([dict(
        _page(spp=1, hi=16), photo=3, bits=4, fill=2, colormap=_rng(8).integers(0, 65536, 48))]),
}


@pytest.mark.parametrize("name", list(REFUSED_TIFFS))
def test_tiff_refusals(name):
    """What Pillow refuses raises CameraError: an unknown mode, a cut file,
    a big-endian BigTIFF (Pillow reads its header as a classic one), the
    raw modes Pillow has no unpacker for, libtiff's planar extra samples."""
    for data in (REFUSED_TIFFS[name](),):
        with pytest.raises(Exception):
            _pillow_frames(data)[0][0].tobytes()
        with pytest.raises(core.CameraError):
            imgcodecs.imdecode(data, device="cpu")


# -- GIF reads ----------------------------------------------------------------------------


def _pillow_gif(frames, **kw):
    buf = io.BytesIO()
    ims = [Image.fromarray(f) for f in frames]
    ims[0].save(buf, "GIF", save_all=True, append_images=ims[1:], **kw)
    return buf.getvalue()


def _palette_frames(n, colours, seed, w=W, h=H):
    rng = _rng(seed)
    pal = rng.integers(0, 256, (colours, 3), np.uint8)
    return [pal[rng.integers(0, colours, (h, w))] for _ in range(n)]


PILLOW_GIFS = {
    "few colours": lambda: _pillow_gif(_palette_frames(3, 40, 1)),
    "durations and loop": lambda: _pillow_gif(_palette_frames(4, 20, 2), duration=[40, 80, 120, 30],
                                              loop=2),
    "gray": lambda: _pillow_gif([_rng(3).integers(0, 256, (H, W), np.uint8) for _ in range(3)]),
    "noise (quantized)": lambda: _pillow_gif([_rng(4).integers(0, 256, (H, W, 3), np.uint8)
                                              for _ in range(3)]),
    "one frame": lambda: _pillow_gif(_palette_frames(1, 30, 5, 40, 33)),
    "disposal 2 with transparency": lambda: _pillow_gif(_palette_frames(3, 30, 6), disposal=2,
                                                        transparency=0),
    "disposal per frame": lambda: _pillow_gif(_palette_frames(4, 30, 7), disposal=[0, 1, 2, 3]),
    "comment and background": lambda: _pillow_gif(_palette_frames(2, 10, 8), comment=b"hello",
                                                  background=3),
}


@pytest.mark.parametrize("name", list(PILLOW_GIFS))
def test_gif_pillow_writes(name, tmp_path):
    _reads_as_pillow(PILLOW_GIFS[name](), tmp_path)


@pytest.mark.parametrize("case", range(len(S.GIF_CODE_SIZES)))
def test_gif_forms_the_test_writes(case, tmp_path):
    """chip_smoke.gif_file's local palettes, interlace, offsets,
    transparency, disposals 1-3 and LZW code sizes against Pillow and
    against chip_smoke.gif_truth (phase 3w's truths)."""
    _, data, truths, durations, loop = S.gif_cases(37, 23)[case]
    want = _reads_as_pillow(data, tmp_path)
    assert all(np.array_equal(a, b) for a, b in zip(want, truths))
    ok, anim = P.imdecodeanimation(np.frombuffer(data, np.uint8))
    ref = R.imdecodeanimation(np.frombuffer(data, np.uint8))[1]
    assert ok and anim.durations == ref.durations == durations and anim.loop_count == \
        ref.loop_count == loop


def _gif_frames(rng, n, colours, w=W, h=H, **kw):
    pal = rng.integers(0, 256, (colours, 3))
    frames = []
    for i in range(n):
        fw, fh = max(1, w - 3 * i), max(1, h - 2 * i)
        f = dict(idx=rng.integers(0, colours, (fh, fw)), at=(i, i))
        f.update({k: v[i] if isinstance(v, list) else v for k, v in kw.items()})
        frames.append(f)
    frames[0]["at"] = (0, 0)
    frames[0]["idx"] = rng.integers(0, colours, (h, w))
    return pal, frames


def _hand_gifs():
    rng = _rng(11)
    out = {}
    for d in range(4):
        pal, fr = _gif_frames(rng, 4, 16, disposal=d, transparency=[None, 2, None, 5])
        out[f"disposal {d}"] = S.gif_file((W, H), pal, fr)
    pal, fr = _gif_frames(rng, 3, 16, disposal=2)
    out["disposal 2, no transparency"] = S.gif_file((W, H), pal, fr)
    pal, fr = _gif_frames(rng, 3, 16, transparency=3)
    out["transparency on the first frame"] = S.gif_file((W, H), pal, fr)
    pal, fr = _gif_frames(rng, 3, 16, transparency=3, disposal=[3, 2, 0])
    out["first frame transparent, disposals 3 then 2"] = S.gif_file((W, H), pal, fr)
    pal, fr = _gif_frames(rng, 3, 64, interlace=True, bits=6)
    out["interlaced, code size 6"] = S.gif_file((W, H), pal, fr)
    pal, fr = _gif_frames(rng, 3, 16, palette=[rng.integers(0, 256, (16, 3)) for _ in range(3)])
    out["local palettes"] = S.gif_file((W, H), pal, fr)
    pal, fr = _gif_frames(rng, 2, 4, bits=2)
    fr[1]["at"] = (W - 4, H - 3)  # past the screen: it grows
    fr[1]["idx"] = rng.integers(0, 4, (9, 11))
    out["a frame past the screen"] = S.gif_file((W, H), pal, fr)
    ramp = np.repeat(np.arange(16)[:, None], 3, axis=1)
    pal, fr = _gif_frames(rng, 3, 16, transparency=[None, 4, None])
    out["a gray-ramp palette (mode L)"] = S.gif_file((W, H), ramp, fr)
    pal, fr = _gif_frames(rng, 2, 2, bits=7)
    out["indices past the palette"] = S.gif_file((W, H), pal, [dict(f, idx=f["idx"] * 60) for f in fr])
    pal, fr = _gif_frames(rng, 2, 8, bits=3, duration=[0, 50])
    out["zero duration, loop 0"] = S.gif_file((W, H), pal, fr, loop=0)
    return out


HAND_GIFS = _hand_gifs()


@pytest.mark.parametrize("name", list(HAND_GIFS))
def test_gif_hand_built(name, tmp_path):
    data = HAND_GIFS[name]
    _reads_as_pillow(data, tmp_path)
    path = tmp_path / "a.gif"
    path.write_bytes(data)
    got, want = P.imreadanimation(str(path), 1, 2), R.imreadanimation(str(path), 1, 2)
    assert got[0] == want[0] and got[1].durations == want[1].durations
    assert got[1].loop_count == want[1].loop_count
    assert all(np.array_equal(a, b) for a, b in zip(got[1].frames, want[1].frames))


def test_gif_refusals():
    good = HAND_GIFS["disposal 0"]
    for data in (good[:40], b"GIF89a" + bytes(3), b"GIF88a" + good[6:]):
        with pytest.raises(Exception):
            _pillow_frames(data)[0][0].tobytes()
        with pytest.raises(core.CameraError):
            imgcodecs.imdecode(data, device="cpu")


# -- metadata -----------------------------------------------------------------------------


def _tiff_with_tags():
    ifd = TiffImagePlugin.ImageFileDirectory_v2()
    ifd[270], ifd[305], ifd[315], ifd[33432] = "a scan", "rustcv", "someone", "(c)"
    return _pillow_tiff(_mode_image("RGB", 12), tiffinfo=ifd, dpi=(300, 150),
                        compression="tiff_lzw")


METADATA = {
    "LZW TIFF": lambda: _pillow_tiff(_mode_image("RGB", 13), compression="tiff_lzw"),
    "TIFF with tags and dpi": _tiff_with_tags,
    "multi-page TIFF": lambda: S.tiff_cases(W, H)[-2][1],
    "big-endian TIFF": lambda: S.tiff_file([dict(_page(), photo=2, tags={296: (3, [3]),
                                                                           282: (5, [72, 1]),
                                                                           283: (5, [30, 7])})],
                                           "MM"),
    "BigTIFF": lambda: S.tiff_cases(W, H)[-1][1],
    "TIFF, orientation": lambda: S.tiff_file([dict(_page(), photo=2, tags={274: (3, [6])})]),
    "GIF with loop": lambda: PILLOW_GIFS["durations and loop"](),
    "GIF, transparency": lambda: HAND_GIFS["transparency on the first frame"],
    "GIF, comment": lambda: PILLOW_GIFS["comment and background"](),
    "GIF87a": lambda: PILLOW_GIFS["few colours"](),
}


@pytest.mark.parametrize("name", list(METADATA))
def test_metadata_is_the_references(name, tmp_path, jax_cpu):
    data = METADATA[name]()
    path = tmp_path / "x.img"
    path.write_bytes(data)
    mat, meta = imgcodecs.imread_with_metadata(str(path), device="cpu")
    want_mat, want = jax_codecs.imread_with_metadata(str(path))
    assert meta == want and list(meta) == list(want)
    assert np.array_equal(mat.to_numpy(), want_mat.to_numpy())
    assert exif.metadata(data) == meta
    got, ref = P.imdecodeWithMetadata(np.frombuffer(data, np.uint8)), \
        R.imdecodeWithMetadata(np.frombuffer(data, np.uint8))
    assert got[1:] == ref[1:] and np.array_equal(got[0], ref[0])


def test_the_issue_examples_of_metadata(tmp_path, jax_cpu):
    """An LZW TIFF's compression and tags in Pillow's order (296 before 273),
    a GIF's background, loop and duration."""
    meta = exif.metadata(_pillow_tiff(_mode_image("RGB", 14, 47, 5), compression="tiff_lzw",
                                      dpi=(72, 72)))
    keys = list(meta)
    assert meta["compression"] == "tiff_lzw" and meta["exif:256"] == "47"
    assert meta["exif:258"] == "(8, 8, 8)" and meta["exif:282"] == "72.0"
    assert keys.index("exif:296") < keys.index("exif:273")
    data = _pillow_gif(_palette_frames(2, 8, 15), duration=30, loop=2)
    assert exif.metadata(data) == {"background": "0", "loop": "2", "duration": "30"}


@pytest.mark.parametrize("ext", [".tiff", ".gif"])
@pytest.mark.parametrize("gray", [False, True])
def test_imencode_with_metadata_tiff_and_gif(ext, gray):
    a = _palette_frames(1, 30, 16)[0][..., ::-1]
    if gray:
        a = a[..., 1].copy()
    got = P.imencodeWithMetadata(ext, a, ["Title"], ["x"])
    want = R.imencodeWithMetadata(ext, a, ["Title"], ["x"])
    assert got[0] is want[0] is True
    back, ref = R.imdecodeWithMetadata(got[1]), R.imdecodeWithMetadata(want[1])
    assert back[1:] == ref[1:] and np.array_equal(back[0], ref[0])


# -- TIFF writes --------------------------------------------------------------------------

_TAGS = (256, 257, 258, 259, 262, 273, 277, 278, 279, 284)


def _tags(data):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        im = Image.open(io.BytesIO(data))
        out = []
        for f in ImageSequence.Iterator(im):
            out.append((f.mode, {t: f.tag_v2.get(t) for t in _TAGS}, np.asarray(f).copy()))
        return out


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_tiff_write_reads_back_exactly_with_the_references_tags(channels, tmp_path, jax_cpu):
    rng = _rng(17 + channels)
    shape = (H, W) if channels == 1 else (H, W, channels)
    frames = [rng.integers(0, 256, shape, np.uint8) for _ in range(3)]
    port, ref = tmp_path / "p.tiff", tmp_path / "r.tiff"
    assert imgcodecs.imwritemulti(str(port), [Mat.from_array(f, device="cpu") for f in frames])
    # the reference's own Mat of a gray frame is (H, W, 1), which its Pillow
    # cannot take: it gets the arrays, as its cv2 wrapper gives them
    assert jax_codecs.imwritemulti(str(ref), frames)
    assert port.read_bytes() == ref.read_bytes()  # one strip per page, laid out as Pillow's
    got, want = _tags(port.read_bytes()), _tags(ref.read_bytes())
    assert len(got) == len(want) == 3
    for (gm, gt, ga), (wm, wt, wa), f in zip(got, want, frames):
        assert gm == wm and gt == wt
        assert np.array_equal(ga, wa)
        assert np.array_equal(ga, f if f.ndim == 2 else f[..., ::-1])


@pytest.mark.parametrize("call", ["imwrite", "imencode"])
def test_tiff_still_writes(call, tmp_path, jax_cpu):
    a = _rng(21).integers(0, 256, (H, W, 3), np.uint8)
    if call == "imwrite":
        for ext in (".tif", ".tiff"):
            assert imgcodecs.imwrite(str(tmp_path / f"p{ext}"), Mat.from_array(a, device="cpu"))
            assert jax_codecs.imwrite(str(tmp_path / f"r{ext}"), JMat.from_array(a))
            assert (tmp_path / f"p{ext}").read_bytes() == (tmp_path / f"r{ext}").read_bytes()
            assert np.array_equal(_pillow_frames((tmp_path / f"p{ext}").read_bytes())[0][0], a)
        return
    data = imgcodecs.imencode(".tiff", Mat.from_array(a, device="cpu"))
    assert np.array_equal(_pillow_frames(data)[0][0], a)
    with pytest.raises(core.CameraError):
        imgcodecs.imencode(".tif", Mat.from_array(a, device="cpu"))
    with pytest.raises(Exception):
        jax_codecs.imencode(".tif", JMat.from_array(a))


# -- GIF writes ---------------------------------------------------------------------------


def _smooth(h, w, seed):
    yy, xx = np.mgrid[0:h, 0:w]
    rng = _rng(seed)
    base = 128 + 100 * np.sin(xx / 9.0)[..., None] * np.cos(yy[..., None] / 7.0 + np.arange(3))
    return np.clip(base + rng.normal(0, 4, (h, w, 3)), 0, 255).astype(np.uint8)


def _camera(h, w, t, rng):
    """A frame of the capture simulator's test pattern with sensor noise."""
    from rustcv_tpu_torch.capture.simulation import synth_bgr

    return np.clip(synth_bgr(w, h, t)[..., ::-1] + rng.normal(0, 3, (h, w, 3)), 0, 255) \
        .astype(np.uint8)


def _blob(rng, h=48, w=64):
    import scipy.ndimage as nd

    blob = nd.gaussian_filter(rng.normal(0, 1, (h, w, 3)), (4, 4, 0))
    return ((blob - blob.min()) / (blob.max() - blob.min()) * 255).astype(np.uint8)


def _bar_frames():
    rng = _rng(31)
    h, w = 48, 64
    bars = np.repeat(np.repeat(rng.integers(0, 256, (1, 8, 3)), w // 8, 1), h, 0)
    blob = _blob(rng, h, w)
    return {
        "256 colours or fewer": _palette_frames(3, 200, 32, w, h),
        "gray": [rng.integers(0, 256, (h, w), np.uint8) for _ in range(3)],
        "a frame repeated": [f for f in _palette_frames(2, 60, 33, w, h) for _ in range(2)],
        "uniform noise": [rng.integers(0, 256, (h, w, 3), np.uint8) for _ in range(2)],
        "small noise": [rng.integers(0, 256, (23, 31, 3), np.uint8)],
        "bars and noise": [np.clip(bars + rng.normal(0, 10, (h, w, 3)), 0, 255).astype(np.uint8)],
        "smooth": [_smooth(h, w, 34), _smooth(h, w, 35)],
        "blobs": [blob],
        "few then many": _palette_frames(1, 50, 36, w, h) + [rng.integers(0, 256, (h, w, 3),
                                                                           np.uint8)],
        "camera": [_camera(90, 160, t, _rng(37 + t)) for t in range(3)],
    }


GIF_BAR_FRAMES = _bar_frames()


def _errors(back, frames):
    out = []
    for b, f in zip(back, frames):
        f3 = f if f.ndim == 3 else np.repeat(f[..., None], 3, axis=2)
        d = np.abs(b.astype(np.int64) - f3[..., ::-1].astype(np.int64))  # back is BGR; f RGB
        out.append((d.max((0, 1)), d.mean((0, 1)), len(np.unique(f3.reshape(-1, 3), axis=0))))
    return out


def _gif_bar(port: bytes, ref: bytes, frames, durations=True):
    """The GIF write bar: Pillow reads both files to the same frame count
    (and durations and loop); exact where the reference is; max and mean
    |diff| per frame and channel no larger than the reference's (the mean
    up to 10 % larger over 256 colours)."""
    got, n_got = _pillow_frames(port)
    want, n_want = _pillow_frames(ref)
    assert n_got == n_want == len(got) == len(want)
    gi, wi = Image.open(io.BytesIO(port)), Image.open(io.BytesIO(ref))
    assert gi.info.get("loop") == wi.info.get("loop")
    if durations:
        assert [f.info.get("duration", 100) for f in ImageSequence.Iterator(gi)] == \
            [f.info.get("duration", 100) for f in ImageSequence.Iterator(wi)]
    kept, last = [], None
    for f in frames:  # the frames Pillow keeps: an equal one merges into the one before
        if last is None or not np.array_equal(f, last):
            kept.append(f)
        last = f
    for (gmax, gmean, n), (wmax, wmean, _) in zip(_errors(got, kept), _errors(want, kept)):
        if wmax.max() == 0:
            assert gmax.max() == 0
        assert (gmax <= wmax).all(), (gmax, wmax)
        assert (gmean <= wmean * (1.1 if n > 256 else 1.0) + 1e-12).all(), (gmean, wmean)


@pytest.mark.parametrize("name", [n for n in GIF_BAR_FRAMES])
def test_gif_imwritemulti_bar(name, tmp_path, jax_cpu):
    frames = GIF_BAR_FRAMES[name]
    port, ref = tmp_path / "p.gif", tmp_path / "r.gif"
    assert imgcodecs.imwritemulti(str(port), [Mat.from_array(
        f[..., ::-1].copy() if f.ndim == 3 else f, device="cpu") for f in frames])
    assert jax_codecs.imwritemulti(str(ref), [f[..., ::-1].copy() if f.ndim == 3 else f
                                              for f in frames])
    _gif_bar(port.read_bytes(), ref.read_bytes(), frames)


@pytest.mark.parametrize("name", [n for n in GIF_BAR_FRAMES])
def test_gif_imwriteanimation_bar(name, tmp_path):
    frames = GIF_BAR_FRAMES[name]
    durations = [40 + 30 * i for i in range(len(frames))]
    out = []
    for C in (P, R):
        a = C.Animation(3)
        a.frames = [f[..., ::-1].copy() if f.ndim == 3 else f for f in frames]
        a.durations = durations
        ok, buf = C.imencodeanimation(".gif", a)
        assert ok
        out.append(buf.tobytes())
        path = tmp_path / f"{C.__name__}.gif"
        assert C.imwriteanimation(str(path), a)
        assert path.read_bytes() == out[-1]
    _gif_bar(out[0], out[1], frames)


def _gradient(seed, h=96, w=128):
    rng = _rng(seed)
    rng.integers(0, 256, (h, w, 3), np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    return np.clip(np.stack([xx * 2, yy * 2, (xx + yy)], -1) + rng.normal(0, 6, (h, w, 3)), 0,
                   255).astype(np.uint8)


def test_gif_write_max_error_where_the_port_misses():
    """The seeded noisy gradient on which the port's median cut once left
    its largest green and blue errors a level above Pillow's: held to the
    bar (max |diff| per channel no larger than Pillow's, the mean up to 10 %
    larger) and to a palette whose every entry is used."""
    a = _gradient(3)
    idx, pal = quantize.quantize(a)
    port = np.abs(pal[idx].astype(np.int64) - a)
    ref = np.abs(_pillow_frames(_pillow_gif([a]))[0][0][..., ::-1].astype(np.int64) - a)
    assert (port.max((0, 1)) <= ref.max((0, 1))).all(), (port.max((0, 1)), ref.max((0, 1)))
    assert (port.mean((0, 1)) <= ref.mean((0, 1)) * 1.1).all()
    assert len(np.unique(idx)) == len(pal) == 256


def test_gif_write_error_bar_on_a_gradient_where_the_port_misses():
    """The noisy gradient on which the port's own median cut once left its
    largest green |diff| above Pillow's: with Pillow's cut the errors are
    Pillow's."""
    a = _gradient(0, 48, 64)
    a[..., 2] = np.clip(128 + _rng(0).normal(0, 6, a.shape[:2]), 0, 255).astype(np.uint8)
    idx, pal = quantize.quantize(a)
    port = np.abs(pal[idx].astype(np.int64) - a)
    ref = np.abs(_pillow_frames(_pillow_gif([a]))[0][0][..., ::-1].astype(np.int64) - a)
    assert (port.max((0, 1)) <= ref.max((0, 1))).all()
    assert (port.mean((0, 1)) <= ref.mean((0, 1)) * 1.1).all()


def test_gif_imwritemulti_durations_where_the_cuts_differ(tmp_path, jax_cpu):
    """Pillow writes a graphic control block, so a 0 ms duration, where its
    median cut leaves a palette entry unused (on the second of these frames
    it leaves two), which the port's own cut once did not: with Pillow's cut
    the durations read back equal."""
    frames = [_blob(np.random.default_rng(s)) for s in (0, 1)]
    port, ref = tmp_path / "p.gif", tmp_path / "r.gif"
    assert imgcodecs.imwritemulti(str(port), [Mat.from_array(f[..., ::-1].copy(), device="cpu")
                                              for f in frames])
    assert jax_codecs.imwritemulti(str(ref), [f[..., ::-1].copy() for f in frames])
    _gif_bar(port.read_bytes(), ref.read_bytes(), frames)


def test_gif_single_frame_writes(tmp_path, jax_cpu):
    """imwrite and imencode of one frame: Pillow's single-frame write
    (interlaced when both sides are 16 or more) reads back exactly."""
    for w, h in ((W, H), (40, 33)):
        a = _palette_frames(1, 30, 40, w, h)[0]
        data = imgcodecs.imencode(".gif", Mat.from_array(a[..., ::-1].copy(), device="cpu"))
        ref = jax_codecs.imencode(".gif", JMat.from_array(a[..., ::-1].copy()))
        assert bool(data[10] & 0x80) and (data.find(b",") > 0)
        _gif_bar(data, ref, [a])
        assert np.array_equal(_pillow_frames(data)[0][0], a[..., ::-1])
        assert imgcodecs.imwrite(str(tmp_path / "x.gif"), Mat.from_array(a[..., ::-1].copy(),
                                                                          device="cpu"))


def test_quantize_keeps_up_to_256_colours_and_maps_to_the_nearest():
    """A frame of 256 colours keeps them (in the cut's order, Pillow's); a
    noisy one maps every pixel to a nearest entry, the one Pillow picks."""
    rng = _rng(41)
    pal = rng.integers(0, 256, (256, 3), np.uint8)
    a = pal[rng.integers(0, 256, (30, 40))]
    idx, got = quantize.quantize(a)
    assert np.array_equal(got[idx], a)
    im = Image.fromarray(a).convert("P", palette=Image.Palette.ADAPTIVE)
    assert np.array_equal(np.asarray(im), idx)
    noise = rng.integers(0, 256, (30, 40, 3), np.uint8)
    idx, pal = quantize.quantize(noise)
    d = ((noise.reshape(-1, 1, 3).astype(np.int64) - pal[None].astype(np.int64)) ** 2).sum(2)
    assert len(pal) == 256
    assert np.array_equal(d[np.arange(d.shape[0]), idx.ravel()], d.min(1))
    im = Image.fromarray(noise).convert("P", palette=Image.Palette.ADAPTIVE)
    assert np.array_equal(np.asarray(im), idx)
    import torch

    box = torch.from_numpy(idx.ravel().astype(np.int64))  # each colour's own entry kept
    t = quantize.nearest(torch.from_numpy(noise.reshape(-1, 3)), box, pal)
    assert np.array_equal(t.numpy(), idx.ravel())


def test_gif_write_refusals(tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 8"):
        imgcodecs.imwritemulti(str(tmp_path / "a.gif"), [Mat.from_array(
            np.zeros((4, 4, 4), np.uint8), device="cpu")])
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 8"):
        gif.write_gif([np.zeros((4, 4), np.uint16)])


# -- the native loops ---------------------------------------------------------------------


@pytest.mark.parametrize("bits", [2, 3, 4, 5, 6, 7, 8])
def test_gif_lzw_round_trip_and_pillow(bits, tmp_path):
    """The port's encoder at each code size read back by the port's
    decoder, and the test's own encoder (chip_smoke.gif_lzw) too."""
    rng = _rng(50 + bits)
    idx = rng.integers(0, 1 << bits, 9000).astype(np.uint8)
    idx[:3000] = idx[0]  # long runs: the table fills and clears
    codes = native.gif_lzw_encode(idx, bits)
    assert np.array_equal(native.gif_lzw_decode(codes, bits, idx.size), idx)
    blocks = S.gif_lzw(idx, bits)
    joined = b"".join(blocks[1 + i + 1:1 + i + 1 + blocks[1 + i]] for i in
                      _block_starts(blocks[1:]))
    assert np.array_equal(native.gif_lzw_decode(joined, bits, idx.size), idx)


def _block_starts(b):
    out, i = [], 0
    while b[i]:
        out.append(i)
        i += 1 + b[i]
    return out


def test_lzw_and_packbits_never_read_or_write_out_of_bounds():
    rng = _rng(60)
    for _ in range(300):
        junk = rng.integers(0, 256, rng.integers(0, 300)).astype(np.uint8).tobytes()
        n = int(rng.integers(0, 500))
        for fn in (lambda: native.gif_lzw_decode(junk, int(rng.integers(1, 9)), n),
                   lambda: native.tiff_lzw_decode(junk, n), lambda: native.packbits_decode(junk, n)):
            try:
                out = fn()
            except (ValueError, NotImplementedError):
                continue
            assert out.size <= n
    with pytest.raises(ValueError):
        native.gif_lzw_decode(bytes([0b1111_1111, 0xFF]), 2, 10)  # a code past the table
    with pytest.raises(ValueError):
        native.gif_lzw_decode(b"\x00", 9, 10)
    data = bytes(range(200)) * 3
    assert native.tiff_lzw_decode(S.tiff_lzw(data), len(data)).tobytes() == data
    assert native.packbits_decode(S.packbits(data), len(data)).tobytes() == data


# -- cv2 ----------------------------------------------------------------------------------


def _still(tmp_path, ext, C):
    path = str(tmp_path / f"still_{C.__name__}{ext}")
    R.imwrite(path, _palette_frames(1, 30, 70)[0])
    return path


def _same(got, want):
    if isinstance(want, np.ndarray):
        return isinstance(got, np.ndarray) and np.array_equal(got, want)
    if isinstance(want, (list, tuple)):
        return type(got) is type(want) and len(got) == len(want) and all(
            _same(a, b) for a, b in zip(got, want))
    return got == want


FILES = [".tiff", ".tif", ".gif", ".png", ".bmp", ".ppm", ".jpg"]


@pytest.mark.parametrize("ext", FILES)
@pytest.mark.parametrize("call", ["imcount", "imreadmulti", "imreadmulti gray", "imreadmulti range",
                                  "haveImageReader", "imreadanimation", "imdecodemulti",
                                  "imdecodeanimation"])
def test_cv2_reads_answer_as_the_references(ext, call, tmp_path):
    frames = [f[..., ::-1].copy() for f in _palette_frames(3, 30, 71)]
    path = str(tmp_path / f"in{ext}")
    if ext in (".tiff", ".tif", ".gif"):
        assert R.imwritemulti(path, frames)
    else:
        R.imwrite(path, frames[0])
    buf = np.fromfile(path, np.uint8)
    fn = {"imcount": lambda C: C.imcount(path),
          "imreadmulti": lambda C: C.imreadmulti(path),
          "imreadmulti gray": lambda C: C.imreadmulti(path, flags=0),
          "imreadmulti range": lambda C: C.imreadmulti(path, start=1, count=1),
          "haveImageReader": lambda C: C.haveImageReader(path),
          "imreadanimation": lambda C: (lambda r: (r[0], r[1].frames, r[1].durations,
                                                   r[1].loop_count))(C.imreadanimation(path, 1)),
          "imdecodemulti": lambda C: C.imdecodemulti(buf),
          "imdecodeanimation": lambda C: (lambda r: (r[0], r[1].frames, r[1].durations,
                                                     r[1].loop_count))(C.imdecodeanimation(buf))}[call]
    got, want = fn(P), fn(R)
    assert _same(got, want), (got, want)


@pytest.mark.parametrize("ext", [".tiff", ".tif", ".gif", ".jpg", ".bmp", ".ppm", ".xyz",
                                 ".png"])
@pytest.mark.parametrize("kind", ["colour", "gray"])
def test_cv2_imwritemulti_answers_as_the_references(ext, kind, tmp_path):
    frames = _palette_frames(3, 30, 72)
    if kind == "gray":
        frames = [f[..., 0].copy() for f in frames]
    ok = P.imwritemulti(str(tmp_path / f"p{ext}"), frames)
    assert ok is R.imwritemulti(str(tmp_path / f"r{ext}"), frames)
    if ok:
        assert _same(R.imreadmulti(str(tmp_path / f"p{ext}")), R.imreadmulti(str(tmp_path / f"r{ext}")))


@pytest.mark.parametrize("ext", [".tiff", ".tif", ".gif", ".png", ".jpg", ".bmp", "tiff"])
def test_cv2_imencodemulti_answers_as_the_references(ext):
    frames = [f[..., ::-1].copy() for f in _palette_frames(3, 30, 73)]
    got, want = P.imencodemulti(ext, frames), R.imencodemulti(ext, frames)
    assert got[0] is want[0]
    if want[0]:
        assert _same(R.imdecodemulti(got[1]), R.imdecodemulti(want[1]))
    else:
        assert got[1].size == want[1].size == 0
    assert P.imencodemulti(ext, [])[0] is R.imencodemulti(ext, [])[0] is False


@pytest.mark.parametrize("ext", [".gif", ".tiff", ".tif", ".xyz", ".png"])
@pytest.mark.parametrize("loop", [0, 4])
def test_cv2_animation_writes_answer_as_the_references(ext, loop, tmp_path):
    frames = [f[..., ::-1].copy() for f in _palette_frames(3, 30, 74)]
    frames.insert(1, frames[0].copy())
    outs = []
    for C in (P, R):
        a = C.Animation(loop)
        a.frames, a.durations = frames, [40, 80, 80, 160]
        path = str(tmp_path / f"{C.__name__}{ext}")
        outs.append((C.imwriteanimation(path, a), C.imencodeanimation(ext, a)[0]))
        if outs[-1][0]:
            r = R.imreadanimation(path)
            outs[-1] += (len(r[1].frames), r[1].durations, r[1].loop_count)
    assert outs[0] == outs[1]
    empty = P.Animation()
    assert P.imwriteanimation(str(tmp_path / f"e{ext}"), empty) is False
    assert P.imencodeanimation(ext, empty)[0] is False


def test_cv2_animated_png_and_webp_raise_not_ported(tmp_path):
    """Animated PNG (item 8d-i) and the WebP writes (item 8c-ii), which once
    raised not_ported, write animations the reference reads with its frame
    count; the reference's animated PNG reads back through the port as
    through the reference (tests/test_torch_apng.py holds them to its
    files)."""
    frames = [f[..., ::-1].copy() for f in _palette_frames(2, 30, 75)]
    a = P.Animation()
    a.frames = frames
    assert P.imwriteanimation(str(tmp_path / "a.png"), a)
    ok, png = P.imencodeanimation(".png", a)
    assert ok and P.imwritemulti(str(tmp_path / "b.png"), frames)
    for data in (png.tobytes(), (tmp_path / "a.png").read_bytes(),
                 (tmp_path / "b.png").read_bytes()):
        buf = np.frombuffer(data, np.uint8)
        assert _same(P.imdecodemulti(buf), R.imdecodemulti(buf))
        with Image.open(io.BytesIO(data)) as im:
            assert im.n_frames == 2 and im.size == (frames[0].shape[1], frames[0].shape[0])
    ok, mine = P.imencodeanimation(".webp", a)
    assert ok and P.imwritemulti(str(tmp_path / "b.webp"), frames)
    for data in (mine.tobytes(), (tmp_path / "b.webp").read_bytes()):
        with Image.open(io.BytesIO(data)) as im:
            assert im.n_frames == 2 and im.size == (frames[0].shape[1], frames[0].shape[0])
    ra = R.Animation()
    ra.frames = frames
    ok, apng = R.imencodeanimation(".png", ra)
    assert ok
    got, want = P.imdecodeanimation(apng), R.imdecodeanimation(apng)
    assert got[0] is want[0] is True
    assert _same((got[1].frames, got[1].durations, got[1].loop_count),
                 (want[1].frames, want[1].durations, want[1].loop_count))
    ok, webp = R.imencodeanimation(".webp", ra)
    assert ok
    # the reads of an animated WebP are item 8c's: they answer as the reference's
    path = str(tmp_path / "w.webp")
    (tmp_path / "w.webp").write_bytes(webp.tobytes())
    anim = (lambda r: (r[0], r[1].frames, r[1].durations, r[1].loop_count))
    for call in (lambda C: C.imdecodemulti(webp), lambda C: anim(C.imreadanimation(path)),
                 lambda C: C.imcount(path), lambda C: C.haveImageReader(path)):
        got, want = call(P), call(R)
        assert _same(got, want), (got, want)
    assert P.imcount(path) == 2


# -- chip_smoke.py's phase 3w ---------------------------------------------------------------


def test_smoke_phase_3w_rehearsed_on_the_cpu(monkeypatch):
    """Phase 3w's whole script on CPU Mats at 29x19: every equality holds
    and no kernel launches."""
    counts = S.run_formats_8b(dev="cpu", w=29, h=19)
    assert not any(counts.values())
