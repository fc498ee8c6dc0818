"""The port's text (put_text, get_text_size, the blends and the engine's
text overlay) on the CPU against the JAX package, whose masks come from
Pillow with raqm (FreeType and HarfBuzz).

The tolerance is 0 everywhere: masks, text sizes and blended pixels are
byte-equal, at every pixel size 1-160 and for printable ASCII and Latin-1
(U+00A0-U+00FF, the soft hyphen among them). The three frozen masks of ``tests/test_spec_freeze.py`` are
computed with jax, Pillow and ``rustcv_tpu`` blocked. Inputs are made from
seeds."""

import hashlib
import os
import random
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import rustcv_tpu.core as jax_core
from rustcv_tpu import imgproc as jax_ip
from rustcv_tpu.capture import SimulationDriver as JaxDriver
from rustcv_tpu.ops import golden as jax_golden
from rustcv_tpu.ops import text as R
from rustcv_tpu.runtime import MultiStreamEngine as JaxEngine
from rustcv_tpu_torch import core, imgproc, native
from rustcv_tpu_torch.capture import SimulationDriver
from rustcv_tpu_torch.core import Mat
from rustcv_tpu_torch.ops import draw, golden
from rustcv_tpu_torch.ops import text as P
from rustcv_tpu_torch.runtime import MultiStreamEngine

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]

# tests/test_spec_freeze.py:119-121
FROZEN = {
    ("FPS: 42.0", 1.0): ("ee52d0a2ba9dbb36", (24, 128), 0, -19),
    ("Hello, RustCV!", 0.75): ("56b219d91ce6f70f", (18, 128), 0, -14),
    ("XyZ 089", 2.0): ("d4ad8f4689ecea68", (48, 256), 0, -38),
}


def _same_mask(text, scale):
    got, want = P.rasterize(text, scale), R.rasterize(text, scale)
    assert got[0].shape == want[0].shape and got[1:] == want[1:], (text, scale)
    np.testing.assert_array_equal(got[0], want[0], err_msg=repr((text, scale)))


def test_frozen_masks_without_the_reference():
    script = textwrap.dedent(
        f"""
        import sys, hashlib
        sys.modules["jax"] = None
        sys.modules["PIL"] = None
        sys.modules["rustcv_tpu"] = None
        from rustcv_tpu_torch.ops import text
        for (s, scale), (want, shape, dx, dy) in {FROZEN!r}.items():
            mask, gdx, gdy = text.rasterize(s, scale)
            got = (hashlib.sha256(mask.tobytes()).hexdigest()[:16], mask.shape, gdx, gdy)
            assert got == (want, shape, dx, dy), (s, scale, got)
        print("OK")
        """
    )
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")


def test_frozen_masks_match_the_reference_here():
    for (s, scale), (want, shape, dx, dy) in FROZEN.items():
        mask, gdx, gdy = P.rasterize(s, scale)
        assert (hashlib.sha256(mask.tobytes()).hexdigest()[:16], mask.shape, gdx, gdy) == (
            want, shape, dx, dy)
        _same_mask(s, scale)


_SPECIAL = ["AV", "To", "Wa", "Ty", "AVAVAV", "Toy Ty Wa", "fi", "fl", "ffi", "ffl", "ff",
            "office", "fluffy waffle", "  leading", "trailing  ", " both ", "0123456789",
            "!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~", "FPS: 59.94", "cam 7 | 1080p", " ",
            # Latin-1, and the soft hyphen, which HarfBuzz hides: ligatures and
            # kerning reach across it
            "héllo", "Ça va, Ñandú? «Ærø» ¿½ µ°", "A\xadV", "f\xadi", "f\xadf\xadl", "\xad",
            "\xad\xadT\xado\xad", "\xa0\xa0nbsp\xa0", "ÀÁÂÃÄÅ àáâãäå ÿþý"]
_CHARS = [chr(c) for c in list(range(0x20, 0x7F)) + list(range(0xA0, 0x100))]


def _sweep(n_random=560, seed=20261017):
    """(text, font_scale): the special strings at spread sizes, every
    printable ASCII and Latin-1 character alone, and random strings of them
    of 1-24 characters at pixel sizes over 1-160 (some scales between
    sizes)."""
    rng = random.Random(seed)
    cases = [(s, (1 + 37 * i % 160) / 20) for i, s in enumerate(_SPECIAL)]
    cases += [(c, (1 + 13 * ord(c) % 160) / 20) for c in _CHARS if c != " "]
    for i in range(n_random):
        s = "".join(rng.choice(_CHARS) for _ in range(rng.randint(1, 24)))
        px = 1 + i % 160 if i < 320 else rng.randint(1, 160)
        cases.append((s, px / 20 + rng.choice([0.0, 0.0, 0.012, -0.012]) * (px > 1)))
    return cases


_CASES = _sweep()
_CHUNKS = 12


@pytest.mark.parametrize("chunk", range(_CHUNKS))
def test_sweep_matches_the_reference_byte_for_byte(chunk):
    for text, scale in _CASES[chunk::_CHUNKS]:
        _same_mask(text, scale)
        assert P.get_text_size(text, scale) == R.get_text_size(text, scale), (text, scale)


def test_sweep_covers_what_it_says():
    assert len(_CASES) >= 700
    sizes = {max(1, round(s * 20)) for _, s in _CASES}
    assert sizes == set(range(1, 161))
    assert {len(t) for t, _ in _CASES} >= set(range(1, 25))
    assert set("".join(t for t, _ in _CASES)) == set(_CHARS)


@pytest.mark.parametrize("px", range(1, 161))
def test_every_pixel_size_of_the_data(px):
    _same_mask("Hg fi AV 1.5% Wy_ é\xadà ÿ", px / 20)
    assert P.get_text_size("Hg", px / 20) == R.get_text_size("Hg", px / 20)


@pytest.mark.parametrize("text,scale", [("", 1.0), ("x", 0.5)])
def test_empty_and_tiny_strings(text, scale):
    _same_mask(text, scale)


@pytest.mark.parametrize("text,scale,inside", [
    ("hi", 0.35, True), ("hi", 3.3, True), ("hi", 0.2, True), ("héllo", 1.0, True),
    ("tab\there", 1.0, False), ("two\nlines", 1.0, False), ("hi", 8.1, False),
    ("\u0101 Latin Extended-A", 1.0, False), ("\x7f", 1.0, False), ("\x9f", 1.0, False)])
def test_outside_the_data_raises_not_ported(text, scale, inside):
    """What the data covers (pixel sizes 1-160, ASCII and Latin-1) is
    byte-equal to the reference; control characters, other scripts and
    sizes past 160 raise."""
    if inside:
        _same_mask(text, scale)
        assert P.get_text_size(text, scale) == R.get_text_size(text, scale)
        return
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 8"):
        P.rasterize(text, scale)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 8"):
        P.get_text_size(text, scale)


def test_masks_are_cached_and_read_only():
    a = P.rasterize("cached", 1.0)
    assert P.rasterize("cached", 1.0) is a
    assert not a[0].flags.writeable


@pytest.mark.parametrize("clockwise", [True, False])
@pytest.mark.parametrize("x0,y0,x1,y1", [(16, 16, 80, 80), (0, 0, 64, 64), (5, 70, 200, 133)])
def test_rasterizer_covers_a_square_by_its_area(clockwise, x0, y0, x1, y1):
    """A lone rectangle's coverage is its area in each pixel, on 0..256
    (255 at most). A clockwise contour (TrueType's outer winding, y up)
    gives positive areas; a counter-clockwise one's negative areas are
    complemented."""
    pts = [(x0, y0), (x0, y1), (x1, y1), (x1, y0)]
    if not clockwise:
        pts = pts[::-1]
    canvas = np.zeros((8, 8), np.uint8)
    native.text_glyph(np.array(pts, np.int32), np.ones(4, np.uint8), np.array([3], np.int32),
                      canvas, org=(0, 8), clip=(0, 0, 8, 8))
    want = np.zeros((8, 8), np.int64)
    for row in range(8):
        ylo, yhi = (7 - row) * 64, (8 - row) * 64  # pixel row's span, 26.6, y up
        for col in range(8):
            fx = max(0, min(x1, (col + 1) * 64) - max(x0, col * 64))
            fy = max(0, min(y1, yhi) - max(y0, ylo))
            area = fx * fy * 32  # 26.6² → (1/256 px)², doubled as the cells keep it
            cov = area >> 9 if clockwise else -area >> 9
            cov = ~cov if cov < 0 else cov
            want[row, col] = min(cov, 255)
    np.testing.assert_array_equal(canvas, want)


# -- put_text on Mats --------------------------------------------------------------

ORIGINS = [(5, 20), (-7, 3), (-60, 10), (30, -2), (50, 60), (58, 47), (200, 200), (0, 13)]


def _img(h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)


@pytest.mark.parametrize("org", ORIGINS)
def test_put_text_matches_the_jax_facade(jax_cpu, org):
    a = _img(48, 64, org[0] + 100)
    text, scale, color = "AVfi Wa 3!", 0.75, (10, 200, 30)
    want = jax_core.Mat.from_array(a.copy())
    jax_ip.put_text(want, text, jax_ip.Point(*org), scale, jax_ip.Scalar(*color))
    jax_dev = jax_core.Mat.from_array(a.copy())
    jax_dev.device()
    jax_ip.put_text(jax_dev, text, jax_ip.Point(*org), scale, jax_ip.Scalar(*color))
    np.testing.assert_array_equal(jax_dev.to_numpy(), want.to_numpy())
    padded = Mat.new(48, 64, 3, step=64 * 3 + 7, device="cpu")
    padded.array[:] = a
    for mat in (Mat.from_array(a.copy(), device="cpu"), padded,
                Mat.from_device(torch.from_numpy(a.copy()))):
        imgproc.put_text(mat, text, imgproc.Point(*org), scale, imgproc.Scalar(*color))
        np.testing.assert_array_equal(mat.to_numpy(), want.to_numpy())


def test_get_text_size_and_empty_mat(jax_cpu):
    for text, scale in (("Hello", 1.0), ("fi AV", 0.6), ("X", 3.2)):
        assert imgproc.get_text_size(text, scale) == jax_ip.get_text_size(text, scale)
    imgproc.put_text(Mat.empty(), "x", imgproc.Point(0, 0), 1.0, imgproc.Scalar.all(255))


# -- the blends --------------------------------------------------------------------


def _blend_ref(img, mask, x0, y0, color):
    out = img.copy()
    golden.blend_mask(out, mask, x0, y0, color)
    return out


@pytest.mark.parametrize("seed", range(4))
def test_golden_blend_matches_the_reference(seed):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (20, 30, 3), np.uint8)
    mask = rng.integers(0, 256, (7, 11), np.uint8)
    for x0, y0 in ((3, 4), (-5, -2), (25, 17), (-11, 0), (30, 20)):
        color = tuple(int(c) for c in rng.integers(0, 256, 3))
        a, b = img.copy(), img.copy()
        golden.blend_mask(a, mask, x0, y0, color)
        jax_golden.blend_mask(b, mask, x0, y0, color)
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", range(4))
def test_blend_mask_at_matches_golden(seed):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (3, 20, 30, 3), np.uint8)
    mask = rng.integers(0, 256, (7, 11), np.uint8)
    for x0, y0 in ((3, 4), (-5, -2), (25, 17), (-11, 0), (30, 20), (-40, 5)):
        color = tuple(int(c) for c in rng.integers(0, 256, 3))
        got = draw.blend_mask_at(torch.from_numpy(imgs), mask, x0, y0, color).numpy()
        for i in range(3):
            np.testing.assert_array_equal(got[i], _blend_ref(imgs[i], mask, x0, y0, color))
        one = draw.blend_mask_at(torch.from_numpy(imgs[0]), torch.from_numpy(mask), x0, y0, color)
        np.testing.assert_array_equal(one.numpy(), got[0])


@pytest.mark.parametrize("per_stream", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_packed_batch_blends_match_golden(seed, per_stream):
    rng = np.random.default_rng(seed)
    n, h, w = 4, 16, 24
    imgs = rng.integers(0, 256, (n, h, w, 3), np.uint8)
    masks = rng.integers(0, 256, (n, 6, 9), np.uint8)
    orgs = np.array([[2, 3], [-4, -2], [20, 12], [-9, 16]], np.int64)
    color = tuple(int(c) for c in rng.integers(0, 256, 3))
    packed = torch.from_numpy(imgs.reshape(n, h, w * 3))
    if per_stream:
        got = draw.blend_masks_packed_batch(packed, np.repeat(masks, 3, axis=2), orgs, color)
    else:
        got = draw.blend_mask_packed_batch(packed, np.repeat(masks[0], 3, axis=1), orgs, color)
    got = got.numpy().reshape(n, h, w, 3)
    for i in range(n):
        m = masks[i] if per_stream else masks[0]
        np.testing.assert_array_equal(got[i], _blend_ref(imgs[i], m, *orgs[i], color))
    np.testing.assert_array_equal(packed.numpy(), imgs.reshape(n, h, w * 3))  # input untouched


# -- the engine's text overlay ------------------------------------------------------


def _cfg(pkg, fmt="YUYV", fps=60):
    return pkg.SimpleConfig(width=64, height=48, fps=fps, pixel_format=getattr(pkg.PixelFormat, fmt))


def _set_mode(monkeypatch, mode):
    if mode is None:
        monkeypatch.delenv("RUSTCV_DECODE", raising=False)
    else:
        monkeypatch.setenv("RUSTCV_DECODE", mode)


TEXTS = ["FPS 60.0", ["cam 0", "cam 1"], ["fi", "AV Wa"], "FPS 59.9"]


@pytest.mark.parametrize("device_sim", [True, False])
@pytest.mark.parametrize("mode", [None, "pallas", "pallas_tick"])
def test_engine_text_matches_the_jax_engine(jax_cpu, monkeypatch, mode, device_sim):
    _set_mode(monkeypatch, mode)
    kw = dict(filter="blur_sobel", overlay=True, device_sim=device_sim)
    port = MultiStreamEngine(SimulationDriver(device_count=2, paced=False), 2, _cfg(core),
                             device="cpu", **kw)
    ref = JaxEngine(JaxDriver(device_count=2, paced=False), 2, _cfg(jax_core), **kw)
    rects = np.array([[4, 4, 20, 10], [-3, 30, 40, 40]], np.int32)
    colors = np.array([[0, 255, 0], [255, 0, 255]], np.uint8)
    try:
        for i, text in enumerate(TEXTS):  # a changed string on each tick
            args = dict(rects=rects, rect_colors=colors, block=True, text=text,
                        text_org=(3 + i, 20), text_scale=0.6 + 0.1 * i, text_color=(0, 255 - i, 255))
            got, want = port.tick(**args), ref.tick(**args)
            for key in ("bgr", "filtered"):
                np.testing.assert_array_equal(got.numpy(key), want.numpy(key), err_msg=f"{key} {text}")
        with pytest.raises(ValueError, match="need 2 strings, got 3"):
            port.tick(text=["a", "b", "c"])
    finally:
        port.close()
        ref.close()


def test_engine_text_repeats_without_upload_and_with_defaults(jax_cpu):
    port = MultiStreamEngine(SimulationDriver(device_count=2, paced=False), 2, _cfg(core),
                             device_sim=True, device="cpu")
    ref = JaxEngine(JaxDriver(device_count=2, paced=False), 2, _cfg(jax_core), device_sim=True)
    try:
        for _ in range(2):
            np.testing.assert_array_equal(port.tick(block=True, text="cached").numpy("bgr"),
                                          ref.tick(block=True, text="cached").numpy("bgr"))
        cache = port._text_cache
        port.tick(block=True, text="cached")
        assert port._text_cache is cache  # the same device masks
    finally:
        port.close()
        ref.close()


@pytest.mark.parametrize("mode", [None, "pallas", "pallas_tick"])
def test_hybrid_mjpeg_engine_text_is_the_blend_of_its_frames(monkeypatch, mode):
    """The hybrid decode is within its bound of the reference's, not equal,
    so the text is checked against the port's own untexted tick."""
    _set_mode(monkeypatch, mode)

    def make():
        return MultiStreamEngine(SimulationDriver(device_count=2, paced=False), 2,
                                 _cfg(core, "MJPEG", 30), mjpeg_backend="hybrid", device="cpu")

    plain, texted = make(), make()
    try:
        for text in ("FPS 30", ["a", "bb"]):
            base = plain.tick(block=True).numpy("bgr")
            got = texted.tick(block=True, text=text, text_org=(2, 30)).numpy("bgr")
            for i in range(2):
                s = text if isinstance(text, str) else text[i]
                mask, dx, dy = P.rasterize(s, 1.0)
                np.testing.assert_array_equal(got[i], _blend_ref(base[i], mask, 2 + dx, 30 + dy,
                                                                 (0, 255, 255)))
    finally:
        plain.close()
        texted.close()
