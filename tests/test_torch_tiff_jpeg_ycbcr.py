"""TIFF pages with new-style JPEG compression and with the YCbCr photometric
(ROADMAP Queue 1 item 8d-ii-c-i) on the CPU, against the reference, whose
reads go through Pillow 12.1, its libtiff 4.7 and libjpeg-turbo 3.1
(``Image.open(...).convert("RGB")`` page by page, flipped to BGR).

* JPEG (code 7): each strip or tile a JPEG of its own after the tables
  libjpeg holds (JPEGTables, then the chunks before); a YCbCr page of one
  plane converted by libjpeg, every other page's components kept; the
  checks libtiff makes (chunk size, a last strip of a whole RowsPerStrip,
  components, sampling factors against YCbCrSubsampling, fixed up from the
  first chunk where the tag is missing); Pillow's reused strip buffer
  behind a short stream; planar pages; Pillow's own JPEG writes.
* YCbCr on PackBits, LZW and Deflate: libtiff's RGBA reader (data units
  of every subsampling it reads, its 4x4 quirks, the predictor's rows, the
  conversion with YCbCrCoefficients and ReferenceBlackWhite exact on all
  2^24 inputs), and Pillow's raw read of an uncompressed page.
* The host JPEG decode's colour rule: the default leaves every file of
  ``tests/data/jpeg`` byte for byte as it was.

The fixtures are ``tests/data/tiff`` (``tools/make_tiff_data.py``); the
seeded pages are made here with ``chip_smoke.tiff_file`` and Pillow's JPEG
encoder. Every read equals the reference's bytes (tolerance 0) or raises
its error class: CameraError from ``imread``, ``imdecode`` and
``imreadmulti``, cv2's False or 0 from its swallowing calls; old-style JPEG
raises ``not_ported``. Where the reference reads heap contents (a first
strip whose stream is short) the port reads zeros, and no test asks it."""

import hashlib
import io
import json
import os
import warnings

import numpy as np
import pytest
from PIL import Image, ImageSequence

import chip_smoke as S
import rustcv_tpu.cv2 as R
import rustcv_tpu_torch.cv2 as P
from rustcv_tpu import imgcodecs as ref_codecs
from rustcv_tpu_torch import core, imgcodecs, native
from rustcv_tpu_torch.imgcodecs import tiff
from tools import make_tiff_data as TD

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "tiff")
with open(os.path.join(DATA, "manifest.json")) as _f:
    MANIFEST = json.load(_f)
NAMES = sorted(MANIFEST)
JPEG_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "jpeg")
with open(os.path.join(JPEG_DATA, "manifest.json")) as _f:
    JPEG_MANIFEST = json.load(_f)


def _data(name: str) -> bytes:
    with open(os.path.join(DATA, name), "rb") as f:
        return f.read()


def _sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _pillow_pages(data: bytes):
    """Pillow's pages as BGR, or the class name of what ends the walk last."""
    pages = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            for frame in ImageSequence.Iterator(Image.open(io.BytesIO(data))):
                pages.append(np.ascontiguousarray(np.asarray(frame.convert("RGB"))[..., ::-1]))
        except Exception as e:  # noqa: BLE001 - the class is the answer
            pages.append(type(e).__name__)
    return pages


def _reads_as_pillow(data: bytes) -> None:
    """``imdecode`` and ``imreadmulti``'s pages equal Pillow's, or both
    raise (CameraError from the port)."""
    want = _pillow_pages(data)
    if isinstance(want[0], str):
        with pytest.raises(core.CameraError):
            imgcodecs.imdecode(data, device="cpu")
        return
    got = imgcodecs.imdecode(data, device="cpu").to_numpy()
    assert got.shape == want[0].shape and np.array_equal(got, want[0])
    if isinstance(want[-1], str):
        with pytest.raises(ValueError):
            imgcodecs.decode_frames(data)
        return
    pages = imgcodecs.decode_frames(data)
    assert len(pages) == len(want)
    for g, w in zip(pages, want):
        assert g.shape == w.shape and np.array_equal(g, w)


# -- the fixtures -----------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_manifest_is_a_fresh_reference_read(name, tmp_path):
    """The committed file and its manifest entry agree with Pillow and the
    reference here, so a stale manifest fails on the CPU and not only on
    the card."""
    data, m = _data(name), MANIFEST[name]
    assert hashlib.sha256(data).hexdigest() == m["sha256"] and len(data) == m["bytes"]
    path = tmp_path / name
    path.write_bytes(data)
    assert R.imcount(str(path)) == m["count"]
    got = [{"error": p} if isinstance(p, str) else {"shape": list(p.shape), "bgr_sha256": _sha(p)}
           for p in _pillow_pages(data)]
    assert got == m["pages"]


def _outcome(fn):
    try:
        return "read", fn()
    except Exception as e:  # noqa: BLE001 - the class is the answer
        return type(e).__name__, None


@pytest.mark.parametrize("name", NAMES)
def test_fixture_reads_are_the_references(name, jax_cpu):
    """imread, imdecode, imreadmulti and imcount, and cv2's imread,
    imcount, imreadmulti, imdecodemulti, imreadanimation and
    imdecodeanimation: the reference's bytes and answers, or its error
    class; old-style JPEG ``not_ported`` through every one of them."""
    path = os.path.join(DATA, name)
    data, m = _data(name), MANIFEST[name]
    buf = np.frombuffer(data, np.uint8)
    if m["form"] == "not_ported":
        for call in (lambda: imgcodecs.imread(path, device="cpu"),
                     lambda: imgcodecs.imdecode(data, device="cpu"),
                     lambda: imgcodecs.imreadmulti(path, device="cpu"),
                     lambda: imgcodecs.imcount(path), lambda: P.imread(path),
                     lambda: P.imcount(path), lambda: P.imreadmulti(path),
                     lambda: P.imdecodemulti(buf), lambda: P.imreadanimation(path),
                     lambda: P.imdecodeanimation(buf)):
            with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 8"):
                call()
        return
    outcome, ref = _outcome(lambda: ref_codecs.imread(path).to_numpy())
    assert outcome == m["imread"]
    if ref is None:
        for call in (lambda: imgcodecs.imread(path, device="cpu"),
                     lambda: imgcodecs.imdecode(data, device="cpu"), lambda: P.imread(path)):
            with pytest.raises(core.CameraError):
                call()
    else:
        for got in (imgcodecs.imread(path, device="cpu").to_numpy(),
                    imgcodecs.imdecode(data, device="cpu").to_numpy(), P.imread(path)):
            assert got.shape == ref.shape and np.array_equal(got, ref)
    assert imgcodecs.imcount(path) == m["count"] == P.imcount(path)
    if "error" in m["pages"][-1]:
        with pytest.raises(core.CameraError):
            imgcodecs.imreadmulti(path, device="cpu")
    else:
        pages = [mat.to_numpy() for mat in imgcodecs.imreadmulti(path, device="cpu")]
        assert [(list(p.shape), _sha(p)) for p in pages] == [
            (p["shape"], p["bgr_sha256"]) for p in m["pages"]]
    for call in ("imreadmulti", "imdecodemulti", "imreadanimation", "imdecodeanimation"):
        arg = path if call.startswith("imread") else buf
        ref_outcome, ref_call = _outcome(lambda: getattr(R, call)(arg))
        if ref_outcome != "read":  # a page Pillow opens but cannot load: both raise
            with pytest.raises((ValueError, core.CameraError)):
                getattr(P, call)(arg)
            continue
        port = getattr(P, call)(arg)
        assert port[0] == ref_call[0]
        if call.endswith("animation"):
            assert port[1].durations == ref_call[1].durations
            assert port[1].loop_count == ref_call[1].loop_count
            port, ref_call = (port[0], port[1].frames), (ref_call[0], ref_call[1].frames)
        assert len(port[1]) == len(ref_call[1])
        assert all(np.array_equal(a, b) for a, b in zip(port[1], ref_call[1]))


def test_refused_forms_answer_false_or_zero_through_cv2(tmp_path):
    """cv2's swallowing calls give False or 0 for the pages Pillow opens but
    cannot load, as the reference's do, and the counts Pillow's n_frames
    gives where it opens them."""
    for name in NAMES:
        m = MANIFEST[name]
        if m["form"] != "refused":
            continue
        path = os.path.join(DATA, name)
        assert P.imcount(path) == R.imcount(path) == m["count"]
        assert P.imreadmulti(path) == (False, []) == R.imreadmulti(path)
        assert P.haveImageReader(path) == R.haveImageReader(path)


# -- seeded JPEG pages -------------------------------------------------------------


def _jpeg_case(seed: int):
    """A seeded JPEG page: odd sizes, each subsampling, qualities 50-95,
    strips or tiles, tables in the strips, in JPEGTables or both, restart
    markers, II or MM; YCbCr of one plane, or another photometric."""
    rng = np.random.default_rng(1000 + seed)
    w, h = (int(x) for x in rng.integers(5, 70, 2))
    while w % 8 == 0 or h % 8 == 0:
        w, h = w + 1, h + 3
    photo = int(rng.choice([6, 6, 6, 2, 1, 5]))
    sub = int(rng.integers(0, 3)) if photo == 6 else 0
    spp = {6: 3, 2: 3, 1: 1, 5: 4}[photo]
    img = rng.integers(0, 256, (h, w, spp)).astype(np.uint8)
    img = (img // 8 * 8 + (np.arange(w) % 8)[None, :, None]).astype(np.uint8)
    quality = int(rng.integers(50, 96))
    tables = rng.choice(["strip", "only", "both"])
    kw = {"quality": quality, "subsampling": sub}
    if rng.random() < 0.3:
        kw["restart_marker_blocks"] = int(rng.integers(1, 5))
    made = {}

    def enc(blk, plane):
        j = TD.pillow_jpeg(blk, **kw)
        if tables == "strip":
            return j
        made["t"], body = TD.split_tables(j, keep=tables == "both")
        return body

    pg = dict(samples=img, photo=photo, comp=7, jpeg=enc)
    if photo == 6:
        pg["ycbcr"] = [(1, 1), (2, 1), (2, 2)][sub]
    layout = rng.integers(0, 3)
    if layout == 1:
        pg["rows"] = int(rng.integers(1, max(2, h)))
    elif layout == 2:
        pg["tile"] = (16 * int(rng.integers(1, 3)), 16 * int(rng.integers(1, 3)))
    order = "MM" if rng.random() < 0.3 else "II"
    data = S.tiff_file([pg], order)
    if tables != "strip":
        pg["tags"] = {347: (7, list(made["t"]))}
        data = S.tiff_file([pg], order)
    return data


@pytest.mark.parametrize("seed", range(110))
def test_seeded_jpeg_pages_read_as_pillow(seed):
    _reads_as_pillow(_jpeg_case(seed))


# -- seeded YCbCr pages ------------------------------------------------------------


def _ycbcr_case(seed: int):
    """A seeded YCbCr page on PackBits, LZW or Deflate: every subsampling
    libtiff reads, odd sizes, strips or tiles, predictor 2, random
    YCbCrCoefficients and ReferenceBlackWhite, an orientation, II or MM."""
    rng = np.random.default_rng(2000 + seed)
    w, h = (int(x) for x in rng.integers(3, 60, 2))
    sub = [(1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4)][seed % 7]
    comp = int(rng.choice([5, 8, 32773, 32946]))
    pg = dict(samples=rng.integers(0, 256, (h, w, 3)).astype(np.uint8), photo=6, comp=comp,
              ycbcr=sub, tags={})
    layout = rng.integers(0, 3)
    if layout == 1:
        pg["rows"] = int(rng.integers(1, max(2, h)))
    elif layout == 2:
        pg["tile"] = (16 * int(rng.integers(1, 3)), 16 * int(rng.integers(1, 3)))
    if comp != 32773 and rng.random() < 0.4:
        pg["predictor"] = 2
    if rng.random() < 0.6:
        r, b = rng.uniform(0.05, 0.45, 2)
        pg["tags"][529] = (5, TD.rationals([r, 1 - r - b, b]))
    if rng.random() < 0.6:
        lo = rng.integers(0, 40, 3)
        hi = rng.integers(200, 256, 3)
        pg["tags"][532] = (5, TD.rationals([lo[0], hi[0], 128 - lo[1], 128 + hi[1] // 2,
                                          128 - lo[2], 128 + hi[2] // 2]))
    if rng.random() < 0.3:
        pg["tags"][274] = (3, [int(rng.integers(1, 9))])
    return S.tiff_file([pg], "MM" if rng.random() < 0.3 else "II")


@pytest.mark.parametrize("seed", range(110))
def test_seeded_ycbcr_pages_read_as_pillow(seed):
    _reads_as_pillow(_ycbcr_case(seed))


@pytest.mark.parametrize("page", [
    dict(photo=6, comp=7, ycbcr=(2, 2)), dict(photo=6, comp=8, ycbcr=(2, 2)),
    dict(photo=2, comp=7, planar=2)], ids=["JPEG YCbCr", "Deflate YCbCr", "planar JPEG RGB"])
def test_rows_per_strip_past_the_height(page):
    """RowsPerStrip 2^32 - 1 (libtiff's "one strip"): one strip of the
    image's rows, read as Pillow reads it."""
    rgb = np.random.default_rng(3).integers(0, 256, (29, 37, 3)).astype(np.uint8)
    sub = 2 if page.get("ycbcr") else 0
    _reads_as_pillow(S.tiff_file([dict(page, samples=rgb, tags={278: (4, [2 ** 32 - 1])},
                                       jpeg=lambda b, p: TD.pillow_jpeg(b, subsampling=sub))]))


def test_tiff_ycbcr_to_rgb_is_libtiffs_on_every_input():
    """libtiff's YCbCr → RGB, default tags, on all 2^24 (Y, Cb, Cr): one
    4096 x 4096 Deflate page read by Pillow against the C++ tables."""
    i = np.arange(1 << 24, dtype=np.uint32)
    ycc = np.stack([i >> 16, (i >> 8) & 255, i & 255], -1).astype(np.uint8).reshape(4096, 4096, 3)
    data = S.tiff_file([dict(samples=ycc, photo=6, comp=8, ycbcr=(1, 1), rows=256)])
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    np.testing.assert_array_equal(native.tiff_ycbcr_to_rgb(ycc), want)


@pytest.mark.parametrize("tags", [
    {529: [0.2126, 0.7152, 0.0722]}, {532: [16, 235, 128, 240, 128, 240]},
    {529: [0.3, 0.6, 0.1], 532: [10, 200, 100, 250, 120, 230]},
    {529: [0.299, 0.587, 0.114], 532: [0, 255, 0, 255, 0, 255]},
    {532: [255, 0, 128, 255, 128, 255]}, {529: [0.9, 0.05, 0.9]}])
def test_tiff_ycbcr_to_rgb_tags(tags):
    """The conversion with other YCbCrCoefficients and ReferenceBlackWhite
    on a seeded million inputs, against Pillow's read."""
    ycc = np.random.default_rng(7).integers(0, 256, (1000, 1000, 3)).astype(np.uint8)
    data = S.tiff_file([dict(samples=ycc, photo=6, comp=8, ycbcr=(1, 1), rows=100, tags={
        k: (5, TD.rationals(v)) for k, v in tags.items()})])
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    got = imgcodecs.imdecode(data, device="cpu").to_numpy()[..., ::-1]
    np.testing.assert_array_equal(got, want)
    luma = tags.get(529, (0.299, 0.587, 0.114))
    ref = tags.get(532, (0, 255, 128, 255, 128, 255))
    np.testing.assert_array_equal(native.tiff_ycbcr_to_rgb(ycc, luma, ref), want)


def test_ycbcr_coefficients_libtiff_refuses():
    """A zero green coefficient: libtiff refuses the tags, Pillow raises."""
    ycc = np.zeros((8, 8, 3), np.uint8)
    data = S.tiff_file([dict(samples=ycc, photo=6, comp=8, ycbcr=(1, 1),
                             tags={529: (5, [1, 2, 0, 1, 1, 2])})])
    assert isinstance(_pillow_pages(data)[0], str)
    with pytest.raises(core.CameraError):
        imgcodecs.imdecode(data, device="cpu")


# -- the colour rule of the host JPEG decode ---------------------------------------


@pytest.mark.parametrize("name", sorted(n for n, m in JPEG_MANIFEST.items()
                                        if m["entry"]["imread"] == "read"))
def test_the_default_colour_rule_leaves_every_jpeg_as_it_was(name):
    """The stream's own rule (the default, and named) reads every fixture of
    ``tests/data/jpeg`` to its manifest's bytes."""
    with open(os.path.join(JPEG_DATA, name), "rb") as f:
        data = f.read()
    m = JPEG_MANIFEST[name]
    for got in (native.jpeg_decode_bgr(data), native.jpeg_decode_bgr(data, colour="stream")):
        assert list(got.shape) == m["shape"] and _sha(got) == m["bgr_sha256"]


@pytest.mark.parametrize("sub", [0, 1, 2])
def test_colour_rules_against_libjpeg(sub):
    """"ycbcr" converts whatever the markers say (an Adobe transform 0 too);
    "none" hands back the upsampled components (libjpeg's YCbCr output,
    Pillow's draft mode) and a four-component frame not inverted."""
    rng = np.random.default_rng(sub)
    rgb = rng.integers(0, 256, (29, 37, 3)).astype(np.uint8)
    j = TD.pillow_jpeg(rgb, quality=85, subsampling=sub)
    want = np.asarray(Image.open(io.BytesIO(j)).convert("RGB"))[..., ::-1]
    np.testing.assert_array_equal(native.jpeg_decode_bgr(j, colour="ycbcr"), want)
    im = Image.open(io.BytesIO(j))
    im.draft("YCbCr", im.size)
    np.testing.assert_array_equal(native.jpeg_decode_bgr(j, colour="none"), np.asarray(im))
    cmyk = TD.pillow_jpeg(np.concatenate([rgb, rgb[..., :1]], 2), quality=85)
    inverted = np.asarray(Image.open(io.BytesIO(cmyk)))  # Pillow's CMYK;I
    np.testing.assert_array_equal(native.jpeg_decode_bgr(cmyk, colour="none"), 255 - inverted)
    with pytest.raises(ValueError):
        native.jpeg_decode_bgr(cmyk, colour="ycbcr")


def test_old_style_jpeg_and_the_other_forms_stay_not_ported():
    """Old-style JPEG raises not_ported at setup (Pillow reads the
    fixture); a 12-bit page too, whatever its compression."""
    with pytest.raises(NotImplementedError, match="old-style JPEG"):
        tiff.count(_data("refused_old_style_jpeg.tif"))
    data = S.tiff_file([dict(samples=np.zeros((8, 8, 1), np.uint16), photo=1, bits=16, comp=7,
                             jpeg=lambda b, p: b"", tags={258: (3, [12])})])
    with pytest.raises(NotImplementedError, match="12-bit"):
        imgcodecs.imdecode(data, device="cpu")


def test_phases_3zc_and_4zc_on_the_cpu(monkeypatch):
    """chip_smoke's phase 3zc with the CPU in the card's place, and 4zc's
    1080p pages read by the port as Pillow reads them (its times on the
    host clock)."""
    import time

    assert not any(S.run_formats_8d_ii_c(dev="cpu").values())
    for label, data in S.tiff_jpeg_ycbcr_1080().items():
        got = tiff.read_tiff(data)
        want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        assert got.shape == want.shape and np.array_equal(got, want), label

    def host_ms(fn, reps, warm=True):
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t) * 1e3 / reps

    monkeypatch.setattr(S, "cuda_ms", host_ms)
    S.time_formats_8d_ii_c("cpu", dev="cpu")
