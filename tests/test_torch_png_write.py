"""PNG and animated PNG writes (ROADMAP Queue 1 item 8d-ii-a), on the CPU
against Pillow 12.1, which the JAX package's codecs reach, and against
``rustcv_tpu.imgcodecs`` and ``rustcv_tpu.cv2`` call for call.

* The row filters (``imgcodecs.png_filter``) against a numpy oracle of
  Pillow's rule (None, Up, Sub, Paeth by Σ min(v, 256 - v), the first of
  equal scores kept) and against the filter bytes and filtered rows of
  Pillow's own files, over modes, depths, widths and seeds; the tie cases.
* Every still mode ``Image.fromarray`` makes (1, L, LA, RGB, RGBA, I;16, I
  from i8, i16, u32 and i32) written by ``host.write_png`` with Pillow's
  chunks, image data before zlib and at most 1.02x its size, read back by
  Pillow to the reference's pixels; the refusals (F: OSError; what
  ``fromarray`` refuses: TypeError). ``imwrite``/``imencode`` of a
  2-channel Mat answer as the reference's (an LA file), and
  ``cv2.imencodeWithMetadata`` of every dtype and shape gives the
  reference's file or its exception class, or ``not_ported`` where Pillow
  writes a format the port has no writer for yet.
* Animated PNG: LA, I;16, 1 and I frames, the mixed modes whose written
  mode Pillow fixes (an RGB or RGBA frame among them), mixed sizes (a
  frame merged, one cropped, one smaller than the canvas) and the refusals,
  against Pillow's file; the mode sets where Pillow's choice hangs on
  string hashing against Pillow's file of the frames converted to the
  port's choice.
* Phase 3za of ``chip_smoke.py`` runs here on CPU tensors and Mats, and
  ``tests/data/png/write_refs.json`` is what Pillow writes of its cases.
"""

import io
import json
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke as S
import rustcv_tpu.cv2 as R
from rustcv_tpu import core as jax_core
from rustcv_tpu import imgcodecs as jax_codecs
import rustcv_tpu_torch.cv2 as P
from rustcv_tpu_torch import imgcodecs
from rustcv_tpu_torch.core import Mat
from rustcv_tpu_torch.imgcodecs import apng, host, png_filter
from tools import make_png_write_refs as MR

REFS = Path(__file__).resolve().parent / "data" / "png" / "write_refs.json"


def _pillow_file(frames, kw=None) -> bytes:
    """Pillow's PNG of ``frames``: a still (``kw`` None) or an animation."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)  # Pillow 12 deprecates writing I
        return MR.pillow_png(frames, kw)


def _pillow_reads(data: bytes):
    """Pillow's frames of a PNG (each ``convert("RGB")``), its n_frames and
    the durations, or the exception that stops the read."""
    try:
        im = Image.open(io.BytesIO(data))
        frames, durations = [], []
        for k in range(getattr(im, "n_frames", 1)):
            im.seek(k)
            frames.append(np.asarray(im.convert("RGB")))
            durations.append(im.info.get("duration"))
        return frames, durations
    except Exception as e:  # noqa: BLE001 - Pillow's answer, whatever it is
        return type(e)


def _same_png(mine: bytes, ref: bytes) -> None:
    """The bars: Pillow's chunks in its order, IHDR, acTL, fcTL and fdAT
    fields, each frame's image data before zlib byte for byte, at most 1.02x
    its size, and Pillow reads both files to the same frames."""
    got, want = S.png_summary(mine), S.png_summary(ref)
    for key in ("chunks", "controls", "frames_sha256"):
        assert got[key] == want[key], key
    assert got["bytes"] <= S.PNG_SIZE_RATIO * want["bytes"]
    a, b = _pillow_reads(mine), _pillow_reads(ref)
    if isinstance(b, type):
        assert a is b
        return
    assert a[1] == b[1] and len(a[0]) == len(b[0])
    assert all(np.array_equal(x, y) for x, y in zip(a[0], b[0]))


# -- the row filters --------------------------------------------------------------------------


def _oracle(raw: np.ndarray, bpp: int) -> np.ndarray:
    """Pillow's filter choice in numpy, row by row: (H, 1 + n) u8."""
    h, n = raw.shape
    out = np.zeros((h, n + 1), np.uint8)
    prior = np.zeros(n, np.int64)
    for y in range(h):
        r = raw[y].astype(np.int64)
        a = np.concatenate([np.zeros(bpp, np.int64), r[:-bpp]])[:n]
        c = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])[:n]
        b = prior
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        best = None
        for kind, v in ((0, r), (2, r - b), (1, r - a), (4, r - paeth)):
            v = v & 255
            score = int(np.minimum(v, 256 - v).sum())
            if best is None or score < best[0]:
                best = (score, kind, v)
        out[y, 0], out[y, 1:] = best[1], best[2]
        prior = r
    return out


def _image(mode: str, h: int, w: int, seed: int) -> np.ndarray:
    """A seeded image in ``mode``: a gradient with noise rows, every fifth."""
    rng = np.random.default_rng(seed)
    g = S.png_gradient(seed, w, h)
    if mode == "1":
        return g[..., 1] > 127
    if mode == "I;16":
        return g[..., 1].astype(np.uint16) * 256 + g[..., 0]
    if mode == "L":
        return np.ascontiguousarray(g[..., 1])
    if mode == "LA":
        return np.dstack([g[..., 1], rng.integers(0, 256, (h, w)).astype(np.uint8) & 0xF0])
    if mode == "RGBA":
        return np.dstack([g, (np.arange(w) * 9 % 256).astype(np.uint8)[None].repeat(h, 0)])
    return g


def _raw(img: np.ndarray, mode: str) -> np.ndarray:
    h = img.shape[0]
    if mode == "1":
        return np.packbits(img, axis=1)
    if mode == "I;16":
        return img.astype(">u2").view(np.uint8).reshape(h, -1)
    return img.reshape(h, -1)


_BPP = {"1": 1, "L": 1, "LA": 2, "RGB": 3, "RGBA": 4, "I;16": 2}
_DEPTH = {"1": 1, "I;16": 16}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("w", [1, 7, 8, 9, 33])
@pytest.mark.parametrize("mode", list(_BPP))
def test_filters_equal_the_oracle_and_pillows(mode, w, seed):
    img = _image(mode, 11, w, seed + w)
    got = png_filter.filter_rows(torch.from_numpy(host.pillow_image(img)[1].numpy()),
                                 _DEPTH.get(mode, 8)).numpy()
    assert np.array_equal(got, _oracle(_raw(img, mode), _BPP[mode]))
    idat = S.png_summary(_pillow_file([img]))["frames_sha256"][0]
    assert S._sha(got) == idat


@pytest.mark.parametrize("mode", ["RGB", "L", "I;16", "1"])
def test_filters_at_1080p_equal_pillows(mode):
    """The issue's image: 1,080 rows, each Pillow's filter byte and bytes."""
    img = _image(mode, 1080, 1920, 5)
    got = png_filter.filter_rows(host.pillow_image(img)[1], _DEPTH.get(mode, 8)).numpy()
    assert S._sha(got) == S.png_summary(_pillow_file([img]))["frames_sha256"][0]
    assert set(np.unique(got[:, 0])) <= {0, 1, 2, 4}


TIES = {  # rows whose scores tie: (image, the filter Pillow takes for the second row)
    "none and sub": ([[100, 100, 0], [0, 0, 0]], 0),
    "none, sub and up": ([[0, 3, 4, 5], [4, 1, 3, 2]], 0),
    "all four": ([[3, 0, 3], [0, 0, 5]], 0),
    "none and up": ([[250, 150], [100, 200]], 0),
    "none and paeth": ([[0, 3, 5, 1], [4, 0, 3, 4]], 0),
    "sub and up": ([[0, 4, 4, 1, 0], [1, 2, 5, 5, 1]], 2),
    "sub, up and paeth": ([[0, 2, 5, 3], [0, 4, 4, 5]], 2),
    "sub and paeth": ([[0, 50], [250, 200]], 1),
    "up and paeth": ([[5, 0], [3, 0]], 2),
    "zero rows": ([[0, 0, 0], [0, 0, 0]], 0),
}


@pytest.mark.parametrize("name", list(TIES))
def test_ties_go_to_the_earlier_filter(name):
    rows, want = TIES[name]
    img = np.array(rows, np.uint8)
    got = png_filter.filter_rows(torch.from_numpy(img), 8).numpy()
    assert got[1, 0] == want
    assert np.array_equal(got, _oracle(img, 1))
    assert S._sha(got) == S.png_summary(_pillow_file([img]))["frames_sha256"][0]


# -- still PNGs -------------------------------------------------------------------------------


def _array(dtype: str, shape, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if dtype == "bool":
        return rng.integers(0, 2, shape).astype(bool)
    top = {"uint8": (0, 256), "uint16": (0, 65536), "int8": (-128, 128),
           "int16": (-40000, 40000), "int32": (-70000, 70000), "uint32": (0, 1 << 32)}
    lo, hi = top.get(dtype, (-10, 300))
    return rng.integers(lo, hi, shape).astype(dtype)


STILLS = [("uint8", (13, 17)), ("uint8", (13, 17, 2)), ("uint8", (13, 17, 3)),
          ("uint8", (13, 17, 4)), ("bool", (13, 17)), ("uint16", (13, 17)),
          ("int8", (13, 17)), ("int16", (13, 17)), ("int32", (13, 17)), ("uint32", (13, 17)),
          ("uint8", (1, 1)), ("bool", (3, 9)), ("uint16", (2, 1)), ("uint8", (5, 300, 3))]


@pytest.mark.parametrize("dtype,shape", STILLS)
@pytest.mark.parametrize("seed", [0, 1])
def test_still_writes_equal_pillows(dtype, shape, seed):
    a = _array(dtype, shape, seed + len(shape))
    mine = host.write_png(a)
    _same_png(mine, _pillow_file([a]))
    assert host.write_png(torch.from_numpy(a)) == mine  # a CPU tensor: the same bytes


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA", "1", "I;16"])
def test_1080p_still_writes_equal_pillows(mode):
    img = _image(mode, 1080, 1920, 3)
    _same_png(host.write_png(img), _pillow_file([img]))


@pytest.mark.parametrize("dtype,shape,error", [
    ("float32", (4, 5), OSError), ("float64", (4, 5), OSError),
    ("uint16", (4, 5, 3), TypeError), ("uint16", (4, 5, 2), TypeError),
    ("uint8", (4, 5, 1), TypeError), ("int64", (4, 5), TypeError), ("float16", (4, 5), TypeError),
    ("bool", (4, 5, 3), TypeError), ("float32", (4, 5, 3), TypeError),
])
def test_still_refusals_are_pillows(dtype, shape, error):
    a = _array(dtype, shape, 0)
    with pytest.raises(error) as mine:
        host.write_png(a)
    with pytest.raises(error) as ref:
        _pillow_file([a])
    if error is TypeError:
        assert str(mine.value) == str(ref.value)


def test_text_chunks_and_blocks_are_pillows():
    """Text before the image data as PngInfo.add_text writes it, and the
    image data cut into Pillow's blocks (65,536 bytes, or 4 x width)."""
    from PIL import PngImagePlugin

    img = np.random.default_rng(4).integers(0, 256, (200, 20000, 3)).astype(np.uint8)
    info = PngImagePlugin.PngInfo()
    text = {"Title": "x", "Author": "héllo", "Comment": "ünï ☃"}
    for k, v in text.items():
        info.add_text(k, v)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "PNG", pnginfo=info)
    mine = host.write_png(img, text)
    _same_png(mine, buf.getvalue())
    assert S.png_summary(mine)["chunks"].count("IDAT") > 1


@pytest.mark.parametrize("device_mat", [False, True])
@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_imwrite_and_imencode_of_mats_answer_as_the_references(channels, device_mat, tmp_path,
                                                               jax_cpu):
    """A 2-channel Mat, once refused, writes the reference's LA file; a
    device Mat (a CPU tensor here: the filters run where it is) the host
    Mat's bytes. (The reference cannot write a 1-channel Mat: Pillow refuses
    (H, W, 1); the port writes it gray, as before.)"""
    a = _array("uint8", (21, 34, channels), channels)
    mat = Mat.from_device(torch.from_numpy(a)) if device_mat else Mat.from_array(a, device="cpu")
    data = imgcodecs.imencode(".png", mat)
    assert imgcodecs.imwrite(str(tmp_path / "x.png"), mat)
    assert (tmp_path / "x.png").read_bytes() == data
    assert imgcodecs.imwrite_with_metadata(str(tmp_path / "m.png"), mat, {"k": "v"})
    if channels == 1:
        _same_png(data, _pillow_file([a[..., 0]]))
        return
    ref = jax_codecs.imencode(".png", jax_core.Mat.from_array(a))
    assert jax_codecs.imwrite(str(tmp_path / "r.png"), jax_core.Mat.from_array(a))
    assert jax_codecs.imwrite_with_metadata(str(tmp_path / "rm.png"), jax_core.Mat.from_array(a),
                                            {"k": "v"})
    _same_png(data, ref)
    _same_png((tmp_path / "m.png").read_bytes(), (tmp_path / "rm.png").read_bytes())
    assert Image.open(tmp_path / "x.png").mode == {2: "LA", 3: "RGB", 4: "RGBA"}[channels]


def test_cv2_imwrite_of_a_2_channel_array(tmp_path, jax_cpu):
    """cv2's imwrite and imencode of a 2-channel image (a CPU tensor: numpy
    goes to the card) write the reference's LA file."""
    a = _array("uint8", (9, 10, 2), 3)
    assert P.imwrite(str(tmp_path / "p.png"), torch.from_numpy(a)) is True
    assert R.imwrite(str(tmp_path / "r.png"), a) is True
    _same_png((tmp_path / "p.png").read_bytes(), (tmp_path / "r.png").read_bytes())
    ok, buf = P.imencode(".png", torch.from_numpy(a))
    assert ok and buf.tobytes() == (tmp_path / "p.png").read_bytes()


# -- cv2.imencodeWithMetadata of every dtype ----------------------------------------------------

_EXTS = [".png", ".jpg", ".bmp", ".ppm", ".tiff", ".gif", ".webp"]
_DTYPES = ["bool", "uint8", "int8", "uint16", "int16", "uint32", "int32", "int64", "float16",
           "float32", "float64"]


def _answer(f, ext, a):
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            ok, buf = f(ext, a, None, {"Title": "t"})
        return ok, buf.tobytes()
    except NotImplementedError:
        return "not_ported", None
    except Exception as e:  # noqa: BLE001 - the reference's class, whatever it is
        return type(e), None


@pytest.mark.parametrize("channels", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("ext", _EXTS)
def test_imencode_with_metadata_of_every_dtype(ext, dtype, channels):
    """The reference's file, or its exception class; ``not_ported`` only
    where Pillow writes and the port has no writer yet (ROADMAP Queue 1
    items 8d-ii-c and 8d-ii-f)."""
    a = _array(dtype, (6, 7) + ((channels,) if channels else ()), channels)
    got, data = _answer(P.imencodeWithMetadata, ext, a)
    want, ref = _answer(R.imencodeWithMetadata, ext, a)
    if got == "not_ported":
        assert want is True
        mode = Image.open(io.BytesIO(ref)).mode
        assert (ext in (".tiff", ".gif", ".webp") or dtype != "uint8"
                or (ext == ".gif" and channels == 4)), (ext, dtype, channels, mode)
        return
    assert got == want, (got, want)
    if got is not True:
        return
    if ext == ".png":
        _same_png(data, ref)
    else:
        with Image.open(io.BytesIO(data)) as m, Image.open(io.BytesIO(ref)) as r:
            assert (m.mode, m.size) == (r.mode, r.size)


# -- animated PNG -----------------------------------------------------------------------------


def _frames(shape, dtype, n, seed, top=None):
    rng = np.random.default_rng(seed)
    return S._png_moving(rng, shape, n, top or (2 if dtype == "bool" else 256), dtype) \
        if dtype != "bool" else [f.astype(bool) for f in S._png_moving(rng, shape, n, 2)]


APNGS = {
    "LA": lambda: _frames((17, 23, 2), np.uint8, 4, 1),
    "I;16": lambda: _frames((17, 23), np.uint16, 4, 2, 700),
    "I;16 above 255 only": lambda: [np.full((4, 5), 300, np.uint16),
                                    np.full((4, 5), 400, np.uint16)],
    "1": lambda: _frames((17, 23), "bool", 3, 3),
    "I from int32": lambda: _frames((17, 23), np.int32, 3, 4, 70000),
    "L and RGB": lambda: [_frames((17, 23), np.uint8, 2, 5)[0],
                          _frames((17, 23, 3), np.uint8, 2, 5)[1]],
    "LA, RGBA and I;16": lambda: [_frames((17, 23, 2), np.uint8, 2, 6)[0],
                                  _frames((17, 23, 4), np.uint8, 2, 6)[1],
                                  _frames((17, 23), np.uint16, 2, 6, 600)[0]],
    "1 and RGB": lambda: [_frames((17, 23), "bool", 2, 7)[0],
                          _frames((17, 23, 3), np.uint8, 2, 7)[0]],
    "I, F and RGBA": lambda: [_array("int16", (17, 23), 8), _array("float32", (17, 23), 8),
                              _frames((17, 23, 4), np.uint8, 2, 8)[1]],
    "F and RGB": lambda: [_array("float64", (17, 23), 9), _frames((17, 23, 3), np.uint8, 2, 9)[0]],
    "sizes": lambda: [_array("uint8", (45, 61, 3), 10), _array("uint8", (30, 40, 3), 11),
                      _array("uint8", (60, 80, 3), 12)],
    "a smaller frame equal on the overlap": lambda: [
        _array("uint8", (60, 80, 3), 13)[:30, :40].copy(), _array("uint8", (60, 80, 3), 13)],
    "a larger frame cropped": lambda: [_array("uint8", (60, 80, 3), 14),
                                       _array("uint8", (60, 80, 3), 14)[:40, :50].copy()],
    "sizes and modes": lambda: [_array("uint8", (20, 30, 2), 15), _array("uint8", (25, 12, 4), 16),
                                _array("uint16", (9, 40), 17)],
}
_KWS = [{}, {"duration": 40}, {"duration": [10, 20, 30, 40], "loop": 3}]


@pytest.mark.parametrize("kw", range(len(_KWS)))
@pytest.mark.parametrize("name", list(APNGS))
def test_apng_writes_equal_pillows(name, kw):
    frames = APNGS[name]()
    kw = dict(_KWS[kw])
    if isinstance(kw.get("duration"), list):
        kw["duration"] = kw["duration"][:len(frames)]
    mine = apng.write_apng(frames, **kw)
    ref = _pillow_file(frames, kw)
    _same_png(mine, ref)
    assert apng.write_apng([torch.from_numpy(f) for f in frames], **kw) == mine


@pytest.mark.parametrize("frames,error", [
    (lambda: [_array("float32", (4, 5), 0)] * 2, OSError),
    (lambda: [_array("float64", (4, 5), 0), _array("float32", (3, 3), 1)], OSError),
    (lambda: [_array("uint16", (4, 5, 3), 0)] * 2, TypeError),
    (lambda: [_array("uint8", (4, 5), 0), _array("int64", (4, 5), 0)], TypeError),
])
def test_apng_refusals_are_pillows(frames, error):
    frames = frames()
    with pytest.raises(error):
        apng.write_apng(frames)
    with pytest.raises(error):
        _pillow_file(frames, {})


UNFIXED = {  # frame mode sets where Pillow's written mode hangs on string hashing → the port's
    ("uint8", "uint8-2"): "LA", ("uint8", "uint16"): "L", ("uint16", "int32"): "I;16",
    ("bool", "uint8"): "L", ("bool", "uint16"): "I;16", ("int32", "float32"): "I",
    ("bool", "uint8-2", "float32"): "LA", ("float32", "bool"): "F",
}


def _unfixed_frame(kind: str, seed: int):
    if kind == "uint8-2":
        return _array("uint8", (11, 13, 2), seed)
    return _array(kind, (11, 13), seed)


@pytest.mark.parametrize("kinds", list(UNFIXED), ids=lambda k: "+".join(k))
def test_apng_modes_pillow_leaves_to_hashing(kinds):
    """The port writes such frames in its fixed choice (a DEVIATION in
    tests/test_torch_port_map.py), which is one of Pillow's: Pillow's file
    of the frames converted to that mode first, or its OSError for F."""
    frames = [_unfixed_frame(k, i) for i, k in enumerate(kinds)]
    mode = UNFIXED[kinds]
    assert {host.pillow_mode(f) for f in frames} >= {mode}
    if mode == "F":
        with pytest.raises(OSError):
            apng.write_apng(frames)
        return
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        ims = [Image.fromarray(f).convert(mode) for f in frames]
        buf = io.BytesIO()
        ims[0].save(buf, "PNG", save_all=True, append_images=ims[1:], duration=25)
    _same_png(apng.write_apng(frames, duration=25), buf.getvalue())


def test_cv2_animation_writes_of_the_new_forms(tmp_path, jax_cpu):
    """cv2's imwriteanimation, imencodeanimation and imwritemulti of LA and
    mixed-size frames answer as the reference's, with its bytes' bars; of
    float frames False, as the reference's."""
    la = [f[..., ::-1].copy() for f in APNGS["LA"]()]
    sizes = APNGS["sizes"]()
    for frames in (la, sizes, [_array("float32", (4, 5), 0)] * 2):
        files = {}
        for C in (P, R):
            a = C.Animation(2)
            a.frames, a.durations = frames, [40] * len(frames)
            ok, buf = C.imencodeanimation(".png", a)
            path = tmp_path / f"{C.__name__}.png"
            assert C.imwriteanimation(str(path), a) is ok
            assert C.imwritemulti(str(tmp_path / f"m{C.__name__}.png"), frames) is ok
            files[C] = buf.tobytes() if ok else None
            if ok:
                assert path.read_bytes() == files[C]
        if files[R] is None:
            assert files[P] is None
        else:
            _same_png(files[P], files[R])


def test_a_device_mat_animation_writes_the_host_mats_bytes():
    """LA frames of different sizes as CPU-tensor Mats (compared and filtered
    where they are): the host Mats' bytes."""
    frames = [_array("uint8", (20, 30, 2), 1), _array("uint8", (12, 35, 2), 2)]
    dev = [Mat.from_device(torch.from_numpy(f)) for f in frames]
    on_host = [Mat.from_array(f, device="cpu") for f in frames]
    assert imgcodecs.encode_frames("png", dev, duration=[5, 6]) == \
        imgcodecs.encode_frames("png", on_host, duration=[5, 6])


# -- chip_smoke.py's phase 3za ----------------------------------------------------------------


def test_write_refs_are_pillows():
    """``tests/data/png/write_refs.json`` is what Pillow writes of
    ``chip_smoke.png_write_frames()`` (``tools/make_png_write_refs.py``)."""
    refs = json.loads(REFS.read_text())
    cases = S.png_write_frames()
    assert sorted(refs) == sorted(cases)
    for name, (frames, kw) in cases.items():
        assert S.png_summary(_pillow_file(frames, kw)) == refs[name], name


def test_smoke_phase_3za_rehearsed_on_the_cpu():
    """Phase 3za's whole script on CPU tensors and Mats: every case the
    CPU's bytes, Pillow's chunks, controls and image data; no kernel
    launches."""
    counts = S.run_formats_8d_writes(dev="cpu")
    assert not any(counts.values())
