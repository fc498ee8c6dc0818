"""WebP reads (ROADMAP Queue 1 item 8c), on the CPU against Pillow 12.1 with
its libwebp 1.6, which the JAX package's codecs reach, and against
``rustcv_tpu.imgcodecs`` and ``rustcv_tpu.cv2`` call for call.

* Reads are exact: ``imread``, ``imdecode``, ``imreadmulti`` and
  ``imcount`` equal Pillow's ``convert("RGB")`` of every frame (max |diff|
  0) and its ``n_frames``, on streams written here by libwebp's own encoder
  (``tools/make_webp_data.encode``, every ``WebPConfig`` field): lossy at
  each quality, method, segment count, filter type, strength and
  sharpness, partition count, SNS, autofilter and sharp YUV, at odd sizes;
  lossless at each method and quality, ``exact``, near-lossless, palettes
  of 2-256 colours and more, gray, a width of 1; alpha raw and
  VP8L-compressed under each filter (the ALPH filters also hand-made);
  VP8X with ICCP, EXIF and XMP, odd chunk padding and an unknown chunk;
  animations by Pillow and muxed here to reach each blend and dispose bit.
* Counts, loops, durations and metadata equal the reference's.
* A file Pillow refuses raises ``CameraError`` in ``imread`` and
  ``imdecode``; cv2's read calls answer as the reference's; a truncated or
  corrupt stream never crashes the process.
* The fixtures ``chip_smoke.py`` reads on the card (``tests/data/webp``)
  hold the truths of their manifest, and phase 3x runs here on the CPU.
* WebP writes (item 8c-ii, once ``not_ported``) write what the port reads
  back; tests/test_torch_webp_write.py holds them to the reference's.
"""

import hashlib
import io
import itertools
import json
import struct
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image, ImageSequence

import chip_smoke as S
import rustcv_tpu.cv2 as R
from rustcv_tpu import imgcodecs as jax_codecs
import rustcv_tpu_torch.cv2 as P
from rustcv_tpu_torch import imgcodecs, native
from rustcv_tpu_torch.core import CameraError, Mat
from rustcv_tpu_torch.imgcodecs import exif, host, webp
from tools import make_webp_data as WD

DATA = Path(__file__).resolve().parent / "data" / "webp"
W, H = 37, 23


def _pillow(data):
    """The reference's reads of ``data``: BGR frames, n_frames, durations,
    loop, or the exception ``Image.open`` or a frame's load raises."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with Image.open(io.BytesIO(data)) as im:
            loop = im.info.get("loop", 0)
            frames, durations = [], []
            for f in ImageSequence.Iterator(im):
                frames.append(np.asarray(f.convert("RGB"))[..., ::-1].copy())
                durations.append(int(f.info.get("duration", 100)))
            return frames, im.n_frames, durations, loop


def _reads(data, tmp_path, name="x.webp"):
    """Every read of the port equals Pillow's, byte for byte and frame for
    frame; returns Pillow's frames."""
    want, n, durations, loop = _pillow(data)
    path = tmp_path / name
    path.write_bytes(data)
    assert imgcodecs.imcount(str(path)) == n == len(want)
    got = [m.to_numpy() for m in imgcodecs.imreadmulti(str(path), device="cpu")]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.array_equal(g, w)
    assert np.array_equal(imgcodecs.imread(str(path), device="cpu").to_numpy(), want[0])
    assert np.array_equal(imgcodecs.imdecode(data, device="cpu").to_numpy(), want[0])
    steps, lp = imgcodecs.animation_frames(data)
    assert [read()[1] for read in steps] == durations and lp == loop
    return want


def _img(w=W, h=H, seed=0, kind="pattern"):
    if kind == "pattern":
        return WD.pattern(w, h, seed)
    y, x = np.mgrid[0:h, 0:w]
    if kind == "gradient":
        return np.dstack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1),
                          (x + y) * 255 // max(w + h - 2, 1)]).astype(np.uint8)
    if kind == "flat":
        return np.full((h, w, 3), (40, 180, 90), np.uint8)
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)  # noise


# -- lossy (VP8) ------------------------------------------------------------------------------

LOSSY = {f"q{q}": dict(quality=q) for q in (0, 5, 50, 80, 100)}
LOSSY.update({f"method{m}": dict(method=m, quality=70) for m in range(7)})
LOSSY.update({f"seg{s}_ft{t}_fs{f}_sh{sh}": dict(segments=s, filter_type=t, filter_strength=f,
                                                 filter_sharpness=sh, quality=40 + 10 * s)
              for s, t, f, sh in itertools.product((1, 2, 3, 4), (0, 1), (0, 30, 100), (0, 7))})
LOSSY.update({f"partitions{p}": dict(partitions=p, quality=60) for p in range(4)})
LOSSY.update({"sns0": dict(sns_strength=0), "sns100": dict(sns_strength=100),
              "autofilter": dict(autofilter=1, quality=35), "sharp_yuv": dict(use_sharp_yuv=1),
              "dithering": dict(preprocessing=2, quality=30)})


@pytest.mark.parametrize("name", list(LOSSY))
def test_lossy_settings(name, tmp_path):
    _reads(WD.encode(_img(), **LOSSY[name]), tmp_path)


SIZES = [(s, k) for s in ((1, 1), (1, 17), (17, 1), (15, 15), (16, 16), (17, 33))
         for k in ("pattern", "noise", "gradient", "flat")] + [((641, 361), "pattern")]


@pytest.mark.parametrize("size,kind", SIZES, ids=[f"{w}x{h}_{k}" for (w, h), k in SIZES])
def test_lossy_sizes_and_content(size, kind, tmp_path):
    _reads(WD.encode(_img(*size, seed=3, kind=kind), quality=75, filter_type=1,
                     filter_strength=50, segments=4), tmp_path)


# -- lossless (VP8L) ----------------------------------------------------------------------------


@pytest.mark.parametrize("method", range(7))
@pytest.mark.parametrize("quality", [0, 50, 100])
def test_lossless_methods(method, quality, tmp_path):
    _reads(WD.encode(_img(seed=method), lossless=True, method=method, quality=quality), tmp_path)


@pytest.mark.parametrize("near", [0, 20, 40, 60, 80, 100])
def test_lossless_near_lossless(near, tmp_path):
    _reads(WD.encode(_img(seed=9), lossless=True, near_lossless=near), tmp_path)


@pytest.mark.parametrize("colors", [2, 3, 4, 5, 16, 17, 256, 300])
def test_lossless_palettes(colors, tmp_path):
    img = WD.palette_image(W, H, min(colors, 256), seed=colors)[..., :3].copy()
    if colors > 256:  # more colours than a palette holds
        img[::2, ::3] = np.random.default_rng(0).integers(0, 256, img[::2, ::3].shape)
    _reads(WD.encode(img, lossless=True, method=5), tmp_path)


@pytest.mark.parametrize("case", ["gray", "width1", "height1", "exact_on", "exact_off"])
def test_lossless_forms(case, tmp_path):
    if case == "gray":
        data = WD.encode(np.dstack([_img()[..., 1]] * 3), lossless=True)
    elif case == "width1":
        data = WD.encode(_img(1, 40, 4), lossless=True)
    elif case == "height1":
        data = WD.encode(_img(40, 1, 4), lossless=True)
    else:
        rgba = np.dstack([_img(seed=5), WD.alpha_of(W, H)])
        rgba[..., :3][rgba[..., 3] == 0] = (200, 10, 70)  # alpha 0 under non-zero RGB
        data = WD.encode(rgba, lossless=True, exact=int(case == "exact_on"))
    _reads(data, tmp_path)


# -- alpha ---------------------------------------------------------------------------------------


@pytest.mark.parametrize("compression", [0, 1])
@pytest.mark.parametrize("filtering", [0, 1, 2])
@pytest.mark.parametrize("alpha_quality", [100, 50])
def test_alpha_lossy(compression, filtering, alpha_quality, tmp_path):
    rgba = np.dstack([_img(seed=6), WD.alpha_of(W, H)])
    rgba[..., :3][rgba[..., 3] == 0] = 255  # alpha 0 under non-zero RGB
    _reads(WD.encode(rgba, quality=60, alpha_compression=compression, alpha_filtering=filtering,
                     alpha_quality=alpha_quality, exact=1), tmp_path)


@pytest.mark.parametrize("filt", [0, 1, 2, 3])
def test_alpha_filters_made_by_hand(filt, tmp_path):
    """Uncompressed ALPH chunks under each filter (none, horizontal,
    vertical, gradient), filtered here, unfiltered as libwebp does."""
    a = WD.alpha_of(W, H)
    a[5:9] = np.random.default_rng(filt).integers(0, 256, (4, W))
    data = WD.alph_raw(WD.encode(_img(seed=7), quality=60), a, filt)
    _reads(data, tmp_path)
    assert np.array_equal(webp.read_frames(data)[0][..., 3], a)


def test_alpha_lossless_rgba(tmp_path):
    rgba = np.dstack([_img(seed=8), WD.alpha_of(W, H)])
    _reads(WD.encode(rgba, lossless=True, exact=1), tmp_path)


# -- containers and metadata -----------------------------------------------------------------------

_XMP = b'<x:xmpmeta><rdf:Description tiff:Orientation="6"/></x:xmpmeta>'


def _containers():
    base = WD.encode(_img(seed=10), quality=70)
    alpha = WD.encode(np.dstack([_img(seed=10), WD.alpha_of(W, H)]), quality=70)
    ll = WD.encode(_img(seed=10), lossless=True)
    exif = WD._exif()
    return {
        "icc": WD.still(base, icc=b"\x00\x01" * 20),
        "exif": WD.still(base, exif=exif),
        "exif_no_prefix": WD.still(base, exif=exif[6:]),
        "xmp": WD.still(base, xmp=_XMP),
        "xmp_and_exif": WD.still(alpha, exif=exif, xmp=_XMP, icc=b"abc"),
        "odd_unknown": WD.still(ll, extra=WD.chunk(b"ABCD", b"odd")),
        "odd_exif": WD.still(base, exif=exif + b"x"),
        "alpha_vp8x": WD.still(alpha),
        "lossless_vp8x": WD.still(ll),
        "flag_missing": WD.riff(WD.vp8x(W, H, 0) + WD.image_chunks(alpha)),  # ALPH without the flag
        "trailing": WD.riff(WD.chunk(b"VP8 ", WD.chunks(base)[0][1]) + WD.chunk(b"JUNK", b"1234")),
        "past_riff": base + b"tail bytes past the RIFF size",
    }


CONTAINERS = _containers()


@pytest.mark.parametrize("name", list(CONTAINERS))
def test_containers(name, tmp_path, jax_cpu):
    data = CONTAINERS[name]
    _reads(data, tmp_path)
    path = tmp_path / "m.webp"
    path.write_bytes(data)
    want = jax_codecs.imread_with_metadata(str(path))[1]
    assert list(imgcodecs.imread_with_metadata(str(path), device="cpu")[1].items()) == \
        list(want.items())
    assert list(exif.metadata(data).items()) == list(want.items())
    got, want = P.imdecodeWithMetadata(np.frombuffer(data, np.uint8)), \
        R.imdecodeWithMetadata(np.frombuffer(data, np.uint8))
    assert np.array_equal(got[0], want[0]) and got[1:] == want[1:]


def test_the_issue_example_of_metadata(tmp_path, jax_cpu):
    """A still lossy WebP with an EXIF chunk: the reference's dict."""
    data = WD.still(WD.encode(_img(seed=11), quality=80), exif=WD._exif())
    path = tmp_path / "e.webp"
    path.write_bytes(data)
    assert jax_codecs.imread_with_metadata(str(path))[1] == \
        {"loop": "1", "exif:274": "3", "exif:271": "Cam"} == \
        imgcodecs.imread_with_metadata(str(path), device="cpu")[1]


def test_webp_info_is_pillows():
    """``webp_info`` (after open, and after each frame's load) equals
    Pillow's ``info``, key for key and in order."""
    data = CONTAINERS["xmp_and_exif"]
    with Image.open(io.BytesIO(data)) as im:
        assert list(webp.webp_info(data).items()) == list(im.info.items())
        im.load()
        assert list(webp.webp_info(data, loaded=0).items()) == list(im.info.items())
    data = (DATA / "anim_blend_dispose.webp").read_bytes()
    with Image.open(io.BytesIO(data)) as im:
        for i in range(im.n_frames):
            im.seek(i)
            im.load()
            assert list(webp.webp_info(data, loaded=i).items()) == list(im.info.items())


# -- animations ------------------------------------------------------------------------------------


def _pil_anim(frames, **kw):
    ims = [Image.fromarray(f) for f in frames]
    buf = io.BytesIO()
    ims[0].save(buf, "WEBP", save_all=True, append_images=ims[1:], **kw)
    return buf.getvalue()


PIL_ANIMS = {"lossy": dict(), "lossless": dict(lossless=True), "mixed": dict(allow_mixed=True),
             "kmin1_kmax2": dict(kmin=1, kmax=2), "no_keyframes": dict(kmin=9, kmax=10),
             "all_keyframes": dict(kmax=1), "durations_loop3": dict(duration=[40, 80, 120, 10],
                                                                     loop=3),
             "loop0": dict(loop=0, duration=70), "q10_m0": dict(quality=10, method=0)}


@pytest.mark.parametrize("alpha", [False, True])
@pytest.mark.parametrize("name", list(PIL_ANIMS))
def test_pillow_animations(name, alpha, tmp_path):
    frames = [np.roll(_img(48, 32, s), 4 * s, axis=1) for s in range(4)]
    if alpha:
        frames = [np.dstack([f, (WD.alpha_of(48, 32) // (s + 1)).astype(np.uint8)])
                  for s, f in enumerate(frames)]
    _reads(_pil_anim(frames, **PIL_ANIMS[name]), tmp_path)


def _muxed(dispose0, blend1, dispose1, blend2, lossless, loop):
    enc = (lambda a: WD.encode(a, lossless=True, exact=1)) if lossless else \
        (lambda a: WD.encode(a, quality=60))
    clear = np.dstack([_img(64, 48, 11), WD.alpha_of(64, 48)])
    semi = np.dstack([_img(30, 20, 12), WD.alpha_of(30, 20)])
    semi[..., :3][semi[..., 3] == 0] = (250, 0, 250)
    half = semi.copy()
    half[..., 3] = 128
    opaque = np.dstack([_img(30, 20, 13), np.full((20, 30), 255, np.uint8)])
    return WD.animation(64, 48, [
        {"data": enc(clear), "duration": 30, "dispose": dispose0},
        {"data": enc(semi), "x": 10, "y": 6, "blend": blend1, "dispose": dispose1, "duration": 50},
        {"data": enc(half), "x": 20, "y": 16, "blend": blend2, "duration": 70},
        {"data": enc(opaque), "x": 34, "y": 28, "duration": 90, "dispose": 1},
        {"data": enc(half), "x": 30, "y": 24, "duration": 0}], loop=loop)


@pytest.mark.parametrize("bits", list(itertools.product([0, 1], [True, False], [0, 1],
                                                        [True, False])),
                         ids=lambda b: "d{}b{}d{}b{}".format(*map(int, b)))
@pytest.mark.parametrize("lossless", [False, True])
def test_muxed_blend_and_dispose(bits, lossless, tmp_path):
    """Hand-muxed ANMF frames: sub-rectangles at offsets, semi-transparent
    frames over transparent pixels, each blend and dispose bit."""
    _reads(_muxed(*bits, lossless, loop=3 * bits[0]), tmp_path)


def test_full_canvas_keyframe_rules(tmp_path):
    """Full-canvas frames: opaque or unblended ones are keyframes, a
    blended one with alpha is not, a frame after a full-canvas disposal is."""
    full = np.dstack([_img(32, 24, 14), np.full((24, 32), 255, np.uint8)])
    see = np.dstack([_img(32, 24, 15), WD.alpha_of(32, 24)])
    data = WD.animation(32, 24, [
        {"data": WD.encode(see, quality=50)}, {"data": WD.encode(see, lossless=True)},
        {"data": WD.encode(full, quality=50), "dispose": 1},
        {"data": WD.encode(see, lossless=True, exact=1)},
        {"data": WD.encode(see, quality=50), "blend": False}], loop=2)
    _reads(data, tmp_path)


# -- cv2 and the reference -------------------------------------------------------------------------

CV2_FILES = {"still": lambda: WD.encode(_img(seed=16), quality=70),
             "lossless": lambda: WD.encode(_img(seed=16), lossless=True),
             "anim": lambda: _muxed(1, True, 1, True, False, 3),
             "pil_anim": lambda: _pil_anim([_img(48, 32, s) for s in range(3)], duration=[40, 80, 120],
                                           loop=3)}


@pytest.mark.parametrize("name", list(CV2_FILES))
@pytest.mark.parametrize("call", ["imcount", "imreadmulti", "imreadmulti gray", "imreadmulti range",
                                  "haveImageReader", "imreadanimation", "imdecodemulti",
                                  "imdecodeanimation", "imdecodeWithMetadata"])
def test_cv2_reads_answer_as_the_references(name, call, tmp_path):
    path = str(tmp_path / "in.webp")
    data = CV2_FILES[name]()
    Path(path).write_bytes(data)
    buf = np.frombuffer(data, np.uint8)
    anim = (lambda r: (r[0], r[1].frames, r[1].durations, r[1].loop_count))
    fn = {"imcount": lambda C: C.imcount(path),
          "imreadmulti": lambda C: C.imreadmulti(path),
          "imreadmulti gray": lambda C: C.imreadmulti(path, flags=0),
          "imreadmulti range": lambda C: C.imreadmulti(path, start=1, count=1),
          "haveImageReader": lambda C: C.haveImageReader(path),
          "imreadanimation": lambda C: anim(C.imreadanimation(path)),
          "imdecodemulti": lambda C: C.imdecodemulti(buf),
          "imdecodeanimation": lambda C: anim(C.imdecodeanimation(buf, start=1)),
          "imdecodeWithMetadata": lambda C: C.imdecodeWithMetadata(buf)}[call]
    got, want = fn(P), fn(R)
    assert _same(got, want), (got, want)


def _same(got, want):
    if isinstance(want, np.ndarray):
        return isinstance(got, np.ndarray) and got.shape == want.shape and np.array_equal(got, want)
    if isinstance(want, (list, tuple)):
        return type(got) is type(want) and len(got) == len(want) and all(
            _same(a, b) for a, b in zip(got, want))
    return got == want


def test_reference_reads_agree(tmp_path, jax_cpu):
    """The reference's own ``imread`` and ``imreadmulti`` give the port's."""
    for i, data in enumerate([CV2_FILES["anim"](), CONTAINERS["alpha_vp8x"]]):
        path = str(tmp_path / f"{i}.webp")
        Path(path).write_bytes(data)
        want = [m.to_numpy() for m in jax_codecs.imreadmulti(path)]
        got = [m.to_numpy() for m in imgcodecs.imreadmulti(path, device="cpu")]
        assert len(got) == len(want) and all(np.array_equal(g, w) for g, w in zip(got, want))
        assert np.array_equal(imgcodecs.imread(path, device="cpu").to_numpy(),
                              jax_codecs.imread(path).to_numpy())
        assert imgcodecs.imcount(path) == jax_codecs.imcount(path)


# -- refusals and robustness -----------------------------------------------------------------------


def _refusals():
    still = WD.encode(np.dstack([_img(seed=17), WD.alpha_of(W, H)]), quality=60)
    anim = _muxed(0, True, 1, True, True, 0)
    out = {}
    for label, data in (("still", still), ("anim", anim)):
        for cut in (13, 20, 30, len(data) // 2, len(data) - 1):
            out[f"{label}_cut{cut}"] = data[:cut]
            # the RIFF size patched to the cut: the demuxer reads on, a stream ends early
            out[f"{label}_cut{cut}_patched"] = data[:4] + struct.pack("<I", cut - 8) + data[8:cut]
    out["no_vp8_chunk"] = WD.riff(WD.chunk(b"ABCD", b"1234"))
    out["bad_flags"] = WD.riff(WD.vp8x(W, H, 0x81) + WD.image_chunks(still))
    out["canvas_mismatch"] = WD.riff(WD.vp8x(W + 1, H, 0x10) + WD.image_chunks(still))
    out["anmf_outside"] = WD.animation(20, 20, [{"data": WD.encode(_img(seed=1), quality=50)}])
    out["anmf_before_anim"] = WD.riff(WD.vp8x(W, H, 0x02) + WD.chunk(b"ANMF", bytes(16)))
    out["short_riff"] = b"RIFF\x04\x00\x00\x00WEBPVP8 "
    vp8 = WD.chunks(WD.encode(_img(seed=1), quality=50))[0][1]
    out["bad_signature"] = WD.riff(WD.chunk(b"VP8 ", vp8[:3] + b"\x00\x00\x00" + vp8[6:]))
    out["interframe"] = WD.riff(WD.chunk(b"VP8 ", bytes([vp8[0] | 1]) + vp8[1:]))
    ll = WD.chunks(WD.encode(_img(seed=1), lossless=True))[0][1]
    out["bad_vp8l_version"] = WD.riff(WD.chunk(b"VP8L", ll[:4] + bytes([ll[4] | 0x20]) + ll[5:]))
    out["vp8l_garbage"] = WD.riff(WD.chunk(b"VP8L", ll[:5] + bytes(range(256)) * 2))
    out["vp8_garbage"] = WD.riff(WD.chunk(b"VP8 ", vp8[:10] + bytes(range(200)) * 3))
    return out


REFUSALS = _refusals()


@pytest.mark.parametrize("name", list(REFUSALS))
def test_refusals_and_truncations(name, tmp_path):
    """Where Pillow refuses the file (at ``Image.open`` or at a frame's
    load), ``imread`` and ``imdecode`` raise CameraError and cv2's read
    calls answer as the reference's; where it reads, the port reads the
    same."""
    data = REFUSALS[name]
    try:
        _pillow(data)
    except Exception:  # noqa: BLE001 - Pillow's refusal, whatever its kind
        path = tmp_path / "bad.webp"
        path.write_bytes(data)
        with pytest.raises(CameraError):
            imgcodecs.imread(str(path), device="cpu")
        with pytest.raises(CameraError):
            imgcodecs.imdecode(data, device="cpu")
        buf = np.frombuffer(data, np.uint8)
        for call in (lambda C: C.imcount(str(path)), lambda C: C.imreadmulti(str(path))[0],
                     lambda C: C.haveImageReader(str(path)),
                     lambda C: C.imreadanimation(str(path))[0],
                     lambda C: C.imdecodeanimation(buf)[0]):
            assert call(P) == call(R)
        return
    _reads(data, tmp_path)


def test_corrupt_streams_never_crash():
    """Random byte flips and cuts of every kind of stream: the decoders
    return or raise ValueError, never read or write out of bounds."""
    rng = np.random.default_rng(23)
    streams = [WD.encode(_img(seed=18), quality=q, partitions=p) for q, p in ((5, 0), (90, 3))]
    streams += [WD.encode(_img(seed=18), lossless=True, method=m) for m in (0, 6)]
    streams.append(WD.encode(np.dstack([_img(seed=18), WD.alpha_of(W, H)]), quality=50))
    n = 0
    for data in streams:
        for _ in range(60):
            b = bytearray(data)
            for i in rng.integers(20, len(b), int(rng.integers(1, 6))):
                b[i] = int(rng.integers(0, 256))
            b = bytes(b[:int(rng.integers(21, len(b) + 1))])
            b = b[:4] + struct.pack("<I", len(b) - 8) + b[8:]
            try:
                webp.read_frames(b)
            except ValueError:
                n += 1
    assert n > 0
    vp8 = WD.chunks(streams[0])[0][1]
    for fn in (lambda d: native.vp8_decode(d), lambda d: native.vp8l_decode(d),
               lambda d: native.vp8_decode(vp8, alpha=d)):
        for cut in range(0, 40):
            try:
                fn(bytes(rng.integers(0, 256, cut, dtype=np.uint8)))
            except ValueError:
                pass


def test_writes_still_raise_not_ported(tmp_path):
    """Item 8c-ii, ported: every WebP write that once raised ``not_ported``
    writes a WebP the port reads back at the image's size (the bars against
    the reference's files are tests/test_torch_webp_write.py's);
    ``imencodemulti`` still answers False, as the reference's does."""
    img = _img()
    mat = Mat.from_array(img[..., ::-1].copy(), device="cpu")
    a = P.Animation()
    a.frames = [img, _img(seed=1)]
    for what, call in (
            ("imwrite", lambda: imgcodecs.imwrite(str(tmp_path / "x.webp"), mat)
             and (tmp_path / "x.webp").read_bytes()),
            ("imencode", lambda: imgcodecs.imencode(".webp", mat)),
            ("imwritemulti", lambda: imgcodecs.imwritemulti(str(tmp_path / "m.webp"), [mat, mat])
             and (tmp_path / "m.webp").read_bytes()),
            ("cv2.imwrite", lambda: P.imwrite(str(tmp_path / "y.webp"), torch.from_numpy(img))
             and (tmp_path / "y.webp").read_bytes()),
            ("cv2.imencode", lambda: P.imencode(".webp", torch.from_numpy(img))[1].tobytes()),
            ("cv2.imwriteanimation", lambda: P.imwriteanimation(str(tmp_path / "a.webp"), a)
             and (tmp_path / "a.webp").read_bytes()),
            ("cv2.imencodeanimation", lambda: P.imencodeanimation(".webp", a)[1].tobytes()),
            ("cv2.imencodeWithMetadata", lambda: P.imencodeWithMetadata(".webp", img)[1].tobytes())):
        data = call()
        assert isinstance(data, bytes) and webp.accept(data), what
        assert all(f.shape[:2] == (H, W) for f in webp.read_frames(data)), what
    # the reference's imencodemulti knows TIFF and GIF only: (False, empty) for WebP
    frames = [_img(), _img(seed=1)]
    got, want = P.imencodemulti(".webp", [torch.from_numpy(f) for f in frames]), \
        R.imencodemulti(".webp", frames)
    assert got[0] is want[0] is False and got[1].size == want[1].size == 0


# -- the fixtures of the smoke ---------------------------------------------------------------------

MANIFEST = json.loads((DATA / "manifest.json").read_text())


@pytest.mark.parametrize("name", sorted(MANIFEST))
def test_manifest_is_pillows_read_of_each_fixture(name, tmp_path, jax_cpu):
    """The truths ``chip_smoke.py`` holds the card's reads to are the
    reference's reads of the committed files, and the port reads them."""
    data = (DATA / name).read_bytes()
    m = MANIFEST[name]
    assert len(data) == m["bytes"] and hashlib.sha256(data).hexdigest() == m["sha256"]
    want, n, durations, loop = _pillow(data)
    assert [hashlib.sha256(np.ascontiguousarray(f).tobytes()).hexdigest() for f in want] == \
        m["frames"]
    assert [list(f.shape) for f in want] == m["shapes"]
    assert (n, durations, loop) == (m["n_frames"], m["durations"], m["loop"])
    (tmp_path / name).write_bytes(data)
    assert jax_codecs.imread_with_metadata(str(tmp_path / name))[1] == m["metadata"]
    got = webp.read_frames(data)
    assert [hashlib.sha256(host.to_bgr(f).tobytes()).hexdigest() for f in got] == m["frames"]


def test_fixtures_are_small():
    assert sum(p.stat().st_size for p in DATA.iterdir()) < 2_500_000


def test_smoke_phase_3x_rehearsed_on_the_cpu():
    """Phase 3x's whole script on the CPU: every fixture read onto the
    device equals the CPU read and the manifest, and no kernel launches."""
    counts = S.run_formats_8c(dev="cpu")
    assert not any(counts.values())
