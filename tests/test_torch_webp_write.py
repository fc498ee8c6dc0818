"""WebP writes (ROADMAP Queue 1 item 8c-ii), on the CPU, against the
reference's calls (``rustcv_tpu.imgcodecs`` and ``rustcv_tpu.cv2``, which
write through Pillow 12.1 and its libwebp 1.6).

Byte equality with libwebp's encoder is not asked. Each file the port
writes is held to the reference's file of the same frames by these bars:

* Pillow reads it with the reference's mode (``RGB``, or ``RGBA`` where
  the reference's file has alpha), ``n_frames``, per-frame durations and
  loop;
* the port's reader (``imgcodecs.webp.read_frames``) gives Pillow's read
  byte for byte (max |diff| 0): the stream conforms;
* per frame, the PSNR of the RGB read back against the input (all
  channels, u8) is at most 0.5 dB below the reference file's (equal frames
  count as infinite);
* the whole file is at most 1.25x the reference's size;
* a 4-channel still reads back with its alpha exactly the input's.

Inputs: stills at 1x1, 2x2, 17x33, 641x361 and 1920x1080, gray, BGR and
BGRA (alpha with holes and a soft edge), flat, gradient and seeded noise,
and the 1080p test pattern of ``tools/make_webp_data.py``; animations of
2, 4 and 8 frames at 640x360 (small moving boxes, whole-frame change,
repeated frames that merge) through ``imwritemulti``,
``imwriteanimation`` (durations 40/50/60/70, loop 3) and
``imencodeanimation``. Also: the answers that are not files (empty Mats,
a side of 16384, other dtypes, ``imencodemulti``), the native coders
against the port's decoders (a VP8 round trip within 0.5 dB of the same
planes through libwebp's decode, ALPH exactly lossless), a CPU-tensor Mat
and a host Mat of the same pixels giving identical bytes, and the write
references phase 3y of ``chip_smoke.py`` holds the card to.
"""

import io
import json
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image, ImageSequence

import chip_smoke as S
import rustcv_tpu.cv2 as R
import rustcv_tpu_torch.cv2 as P
from rustcv_tpu import imgcodecs as jax_codecs
from rustcv_tpu.core.mat import Mat as RMat
from rustcv_tpu_torch import imgcodecs, native
from rustcv_tpu_torch.core import CameraError, Mat
from rustcv_tpu_torch.imgcodecs import webp
from rustcv_tpu_torch.imgcodecs.webp_yuv import import_yuva
from tools import make_webp_data as WD
from tools import make_webp_write_refs as WR

PSNR_SLACK_DB, SIZE_RATIO = 0.5, 1.25


def _read(data):
    """What Pillow reads: (mode, n_frames, durations, loop, frames in the
    file's mode)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with Image.open(io.BytesIO(data)) as im:
            frames, durations = [], []
            for f in ImageSequence.Iterator(im):
                frames.append(np.asarray(f.convert(im.mode)).copy())
                durations.append(f.info.get("duration"))
            return im.mode, im.n_frames, durations, im.info.get("loop"), frames


def _kept(inputs):
    """The input frames an animation keeps (a frame equal to the one before
    merges into it)."""
    return [i for i, f in enumerate(inputs) if i == 0 or not np.array_equal(f, inputs[i - 1])]


def _bars(mine: bytes, ref: bytes, inputs: list):
    """Every bar of the module's docstring; ``inputs``: the images the
    reference hands Pillow (gray, RGB or RGBA)."""
    m_mode, m_n, m_dur, m_loop, m_frames = _read(mine)
    r_mode, r_n, r_dur, r_loop, r_frames = _read(ref)
    assert (m_mode, m_n, m_dur, m_loop) == (r_mode, r_n, r_dur, r_loop)
    port = webp.read_frames(mine)
    assert len(port) == m_n and all(np.array_equal(p, f) for p, f in zip(port, m_frames))
    kept = _kept(inputs) if len(inputs) > 1 else [0]
    assert len(kept) == m_n
    for k, i in enumerate(kept):
        rgb = WR.rgb_of(inputs[i])
        got, want = WR.psnr(m_frames[k][..., :3], rgb), WR.psnr(r_frames[k][..., :3], rgb)
        assert got >= want - PSNR_SLACK_DB, (k, got, want)
    assert len(mine) <= SIZE_RATIO * len(ref), (len(mine), len(ref))
    if len(inputs) == 1 and inputs[0].ndim == 3 and inputs[0].shape[2] == 4:
        assert m_mode == "RGBA" and np.array_equal(m_frames[0][..., 3], inputs[0][..., 3])


# -- the inputs --------------------------------------------------------------------------

SIZES = [(1, 1), (2, 2), (17, 33), (641, 361), (1920, 1080)]


def _content(kind: str, w: int, h: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    if kind == "flat":
        return np.broadcast_to(np.array([30, 140, 220], np.uint8), (h, w, 3)).copy()
    if kind == "gradient":
        return np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1),
                         (x + y) * 255 // max(w + h - 2, 1)], -1).astype(np.uint8)
    return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)


def _alpha(w: int, h: int) -> np.ndarray:
    """Holes (0) and a soft edge (a ramp around an ellipse)."""
    y, x = np.mgrid[0:h, 0:w]
    r = np.hypot((x - w / 2) / max(w / 2, 1), (y - h / 2) / max(h / 2, 1))
    a = np.clip((1.1 - r) * 600, 0, 255).astype(np.uint8)
    a[((x // 8) + (y // 8)) % 5 == 0] = 0
    return a


def _still(form: str, kind: str, w: int, h: int) -> np.ndarray:
    """The image the reference hands Pillow."""
    rgb = _content(kind, w, h)
    if form == "gray":
        return rgb[..., 1].copy()
    if form == "bgra":
        return np.dstack([rgb, _alpha(w, h)])
    return rgb


STILLS = [(form, kind, w, h) for w, h in SIZES for form in ("gray", "bgr", "bgra")
          for kind in ("flat", "gradient", "noise")]


def _mat_array(img: np.ndarray) -> np.ndarray:
    """The Mat's array whose reversed channels are ``img`` (what the
    reference hands Pillow is ``a[..., ::-1]``)."""
    return np.ascontiguousarray(img[..., ::-1]) if img.ndim == 3 else img[..., None].copy()


@pytest.mark.parametrize("form,kind,w,h", STILLS, ids=[f"{f}-{k}-{w}x{h}" for f, k, w, h in STILLS])
def test_still_meets_the_bars(form, kind, w, h, tmp_path, jax_cpu):
    """imencode (BGR, BGRA) and imencodeWithMetadata (gray, which the
    reference's Mat cannot hold) against the reference's file."""
    img = _still(form, kind, w, h)
    a = _mat_array(img)
    if form == "gray":
        ok, ref = R.imencodeWithMetadata(".webp", img)
        ok2, mine = P.imencodeWithMetadata(".webp", torch.from_numpy(img))
        assert ok and ok2
        ref, mine = ref.tobytes(), mine.tobytes()
        assert imgcodecs.imencode(".webp", Mat.from_array(a, device="cpu")) == mine
    else:
        ref = jax_codecs.imencode(".webp", RMat.from_array(a))
        mine = imgcodecs.imencode(".webp", Mat.from_array(a, device="cpu"))
    _bars(mine, ref, [img])


def test_the_1080p_test_pattern_meets_the_bars(tmp_path, jax_cpu):
    """imwrite and imwrite_with_metadata (which writes no metadata, as the
    reference's ``img.save(path)``) of the test pattern."""
    img = WD.pattern(1920, 1080, 7)
    a = _mat_array(img)
    assert jax_codecs.imwrite(str(tmp_path / "r.webp"), RMat.from_array(a))
    assert imgcodecs.imwrite(str(tmp_path / "p.webp"), Mat.from_array(a, device="cpu"))
    assert imgcodecs.imwrite_with_metadata(str(tmp_path / "m.webp"),
                                           Mat.from_array(a, device="cpu"), {"Title": "x"})
    mine = (tmp_path / "p.webp").read_bytes()
    assert (tmp_path / "m.webp").read_bytes() == mine
    _bars(mine, (tmp_path / "r.webp").read_bytes(), [img])


# -- animations ------------------------------------------------------------------------------

AW, AH = 640, 360


def _animation(kind: str, n: int) -> list:
    base = _content("gradient", AW, AH)
    base[(np.mgrid[0:AH, 0:AW].sum(0) // 24) % 7 == 0] //= 2
    if kind == "whole":
        return [np.roll(base, 37 * i, axis=1) for i in range(n)]
    order = [0, 0, 1, 1, 1, 2, 3, 3] if kind == "repeated" else list(range(8))
    frames = []
    for i in order[:n]:
        f = base.copy()
        f[40 + 12 * i:84 + 12 * i, 60 + 25 * i:120 + 25 * i] = (255, 40, 40)
        f[200:230, 500 - 30 * i:540 - 30 * i] = (20, 20, 230)
        frames.append(f)
    return frames


ANIMS = [(n, kind, call) for n in (2, 4, 8) for kind in ("boxes", "whole", "repeated")
         for call in ("imwritemulti", "imwriteanimation", "imencodeanimation")]
DURATIONS = [40, 50, 60, 70]


@pytest.mark.parametrize("n,kind,call", ANIMS, ids=[f"{n}-{k}-{c}" for n, k, c in ANIMS])
def test_animation_meets_the_bars(n, kind, call, tmp_path, jax_cpu):
    frames = _animation(kind, n)
    bgr = [_mat_array(f) for f in frames]
    if call == "imwritemulti":
        assert jax_codecs.imwritemulti(str(tmp_path / "r.webp"), [RMat.from_array(b) for b in bgr])
        assert imgcodecs.imwritemulti(str(tmp_path / "p.webp"),
                                      [Mat.from_array(b, device="cpu") for b in bgr])
        ref, mine = (tmp_path / "r.webp").read_bytes(), (tmp_path / "p.webp").read_bytes()
    else:
        anims = []
        for C in (R, P):
            a = C.Animation(3)
            a.frames = bgr if C is R else [torch.from_numpy(b) for b in bgr]
            a.durations = [DURATIONS[i % 4] for i in range(n)]
            anims.append(a)
        if call == "imwriteanimation":
            assert R.imwriteanimation(str(tmp_path / "r.webp"), anims[0])
            assert P.imwriteanimation(str(tmp_path / "p.webp"), anims[1])
            ref, mine = (tmp_path / "r.webp").read_bytes(), (tmp_path / "p.webp").read_bytes()
        else:
            (ok, ref), (ok2, mine) = (R.imencodeanimation(".webp", anims[0]),
                                      P.imencodeanimation(".webp", anims[1]))
            assert ok and ok2
            ref, mine = ref.tobytes(), mine.tobytes()
    _bars(mine, ref, frames)


def test_one_frame_is_the_still_and_every_merged_frame_a_still(tmp_path):
    """One frame in all is Pillow's still (method 4); frames that all merge
    into the first leave one frame, written as a still too, as libwebp's
    ``WebPAnimEncoderAssemble`` writes it."""
    f = _content("gradient", 64, 48)
    assert webp.write_animation([f]) == webp.write_webp(f)
    merged = webp.write_animation([f, f, f], durations=[10, 20, 30])
    assert merged[12:16] == b"VP8 " and webp.count(merged) == 1


# -- what is not a file -------------------------------------------------------------------------

def _answer(call):
    try:
        return call()
    except Exception as e:  # the answer is the exception's type
        return type(e)


BIG = np.zeros((1, 16384, 3), np.uint8)


@pytest.mark.parametrize("case", ["empty", "big", "big_bgra", "imencodemulti", "float", "uint16",
                                  "anim_big", "anim_sizes", "anim_empty", "meta_big"])
def test_answers_that_are_not_files(case, tmp_path, jax_cpu):
    """False from imwrite where Pillow raises ValueError/OSError,
    CameraError from imencode, the reference's own exceptions elsewhere
    (libwebp's RuntimeError for an animation frame it refuses, Pillow's
    ValueError through imencodeWithMetadata), Image.fromarray's TypeError
    for a 16-bit colour imencodeWithMetadata and not_ported for a 16-bit
    gray one (Pillow writes it; the port's WebP writer is 8-bit), and
    imencodemulti's (False, empty)."""
    p, r = str(tmp_path / "p.webp"), str(tmp_path / "r.webp")
    if case in ("empty", "big", "big_bgra"):
        a = {"empty": np.zeros((0, 0, 3), np.uint8), "big": BIG,
             "big_bgra": np.zeros((16384, 1, 4), np.uint8)}[case]
        assert imgcodecs.imwrite(p, Mat.from_array(a, device="cpu")) is \
            jax_codecs.imwrite(r, RMat.from_array(a)) is False
        assert _answer(lambda: imgcodecs.imencode(".webp", Mat.from_array(a, device="cpu"))) is \
            CameraError
        assert _answer(lambda: jax_codecs.imencode(".webp", RMat.from_array(a))).__name__ == \
            "CameraError"
        assert P.imwrite(p, torch.from_numpy(a)) is R.imwrite(r, a) is False
    elif case == "imencodemulti":
        got, want = P.imencodemulti(".webp", [torch.from_numpy(BIG)] * 2), \
            R.imencodemulti(".webp", [BIG] * 2)
        assert got[0] is want[0] is False and got[1].size == want[1].size == 0
    elif case in ("float", "uint16"):
        a = np.zeros((8, 8, 3), np.float32 if case == "float" else np.uint16)
        assert _answer(lambda: Mat.from_array(a, device="cpu")) is TypeError
        assert _answer(lambda: RMat.from_array(a)) is TypeError
        if case == "uint16":  # fromarray refuses 16-bit colour; Pillow writes 16-bit gray
            assert _answer(lambda: P.imencodeWithMetadata(".webp", a)) is \
                _answer(lambda: R.imencodeWithMetadata(".webp", a)) is TypeError
            with pytest.raises(NotImplementedError, match="item 8"):
                P.imencodeWithMetadata(".webp", a[..., 0].copy())
    elif case in ("anim_big", "anim_sizes", "anim_empty"):
        frames = {"anim_big": [BIG, BIG], "anim_empty": [],
                  "anim_sizes": [np.zeros((8, 8, 3), np.uint8), np.zeros((9, 8, 3), np.uint8)]}
        frames = frames[case]
        anims = []
        for C in (R, P):
            a = C.Animation()
            a.frames = frames if C is R else [torch.from_numpy(f) for f in frames]
            anims.append(a)
        # an empty animation is False; libwebp's RuntimeError for the others goes through
        want = False if case == "anim_empty" else RuntimeError
        assert _answer(lambda: R.imwriteanimation(r, anims[0])) is want
        assert _answer(lambda: P.imwriteanimation(p, anims[1])) is want
        enc = [_answer(lambda: C.imencodeanimation(".webp", an)) for C, an in zip((R, P), anims)]
        assert enc[0] is enc[1] is RuntimeError if want is RuntimeError else \
            enc[0][0] is enc[1][0] is False
        assert P.imwritemulti(p, [torch.from_numpy(f) for f in frames]) is \
            R.imwritemulti(r, frames) is False
    else:
        with pytest.raises(ValueError):
            R.imencodeWithMetadata(".webp", BIG)
        with pytest.raises(ValueError):
            P.imencodeWithMetadata(".webp", torch.from_numpy(BIG))


# -- the native coders -----------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["gradient", "noise"])
def test_vp8_round_trip(kind):
    """The planes through the port's encoder and decoder and through
    libwebp's decode (Pillow): the same pixels, and a PSNR within 0.5 dB of
    the reference's file of the same image."""
    img = _content(kind, 97, 61)
    y, u, v = import_yuva(torch.from_numpy(img))
    data = native.vp8_encode(y.numpy(), u.numpy(), v.numpy())
    riff = webp._riff(webp._chunk(b"VP8 ", data))
    back = native.vp8_decode(data)[..., :3]
    assert np.array_equal(back, _read(riff)[4][0])
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "WEBP")
    assert WR.psnr(back, img) >= WR.psnr(_read(buf.getvalue())[4][0], img) - PSNR_SLACK_DB


# planes whose smallest stream takes each alpha filter (0-3), and raw ones
ALPH_PLANES = [("holes", 1, 0), ("ring", 1, 1), ("stripes", 1, 2), ("plane", 1, 3),
               ("mask2", 1, 0), ("column", 1, 0), ("noise", 0, 0), ("one", 0, 0)]


@pytest.mark.parametrize("plane,compression,filt", ALPH_PLANES, ids=[p for p, _, _ in ALPH_PLANES])
def test_alph_is_lossless(plane, compression, filt):
    """``alph_encode`` → the decoder's alpha, exact, under each filter and
    raw (the header byte says which the coder kept)."""
    rng = np.random.default_rng(3)
    y, x = np.mgrid[0:61, 0:97]
    a = {"holes": _alpha(64, 40) // 255 * 255, "ring": _alpha(97, 61),
         "stripes": (x * 37 % 256).astype(np.uint8),
         "plane": np.clip(x * 2 + y * 3 - 40, 0, 255).astype(np.uint8),
         "mask2": (rng.random((33, 65)) > 0.5).astype(np.uint8) * 255,
         "column": rng.integers(0, 3, (40, 1), np.uint8) * 90,
         "noise": rng.integers(0, 256, (30, 50), dtype=np.uint8),
         "one": np.array([[7]], np.uint8)}[plane]
    h, w = a.shape
    vp8 = native.vp8_encode(*(p.numpy() for p in import_yuva(torch.zeros((h, w, 3),
                                                                          dtype=torch.uint8))))
    alph = native.alph_encode(a)
    assert (alph[0] & 3, (alph[0] >> 2) & 3) == (compression, filt)
    assert np.array_equal(native.vp8_decode(vp8, alpha=alph)[..., 3], a)


def test_a_failed_build_makes_the_coders_raise(monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_error", "g++: error")
    monkeypatch.setattr(native, "get_lib", lambda: None)
    with pytest.raises(RuntimeError, match="g\\+\\+: error"):
        native.vp8_encode(np.zeros((2, 2), np.uint8), np.zeros((1, 1), np.uint8),
                          np.zeros((1, 1), np.uint8))
    with pytest.raises(RuntimeError, match="g\\+\\+: error"):
        native.alph_encode(np.zeros((2, 2), np.uint8))


# -- the device -------------------------------------------------------------------------------

@pytest.mark.parametrize("form", ["bgr", "bgra", "gray", "anim"])
def test_a_tensor_mat_and_a_host_mat_give_the_same_bytes(form, tmp_path):
    """The planes made on a CPU tensor (a device Mat's route) equal the host
    Mat's: identical files."""
    if form == "anim":
        frames = [_mat_array(f) for f in _animation("boxes", 4)]
        host = imgcodecs.encode_frames("webp", [Mat.from_array(f, device="cpu") for f in frames])
        dev = imgcodecs.encode_frames("webp", [Mat.from_device(torch.from_numpy(f))
                                               for f in frames])
    else:
        a = _mat_array(_still(form, "gradient", 131, 77))
        host = imgcodecs.imencode(".webp", Mat.from_array(a, device="cpu"))
        dev = imgcodecs.imencode(".webp", Mat.from_device(torch.from_numpy(a)))
    assert host == dev


# -- phase 3y's references and script ---------------------------------------------------------------

def test_write_refs_are_the_references(jax_cpu):
    """``tests/data/webp/write_refs.json`` is what the reference writes of
    phase 3y's inputs (regenerated here with its calls)."""
    committed = json.loads((Path(S.WEBP_DATA) / "write_refs.json").read_text())
    assert committed == WR.references()


def test_smoke_phase_3y_rehearsed_on_the_cpu():
    """Phase 3y's script with CPU tensors for the card: identical bytes from
    the two routes, every bar against the committed references, no kernel
    launched."""
    counts = S.run_formats_8c_writes(dev="cpu")
    assert not any(counts.values())
