"""Animated PNG (ROADMAP Queue 1 item 8d-i), on the CPU against Pillow 12.1,
which the JAX package's codecs reach, and against ``rustcv_tpu.imgcodecs``
and ``rustcv_tpu.cv2`` call for call.

* Every fixture of ``tests/data/apng`` (``tools/make_apng_data.py``: Pillow's
  RGB, RGBA, L and P animations with lists of durations, disposals and
  blends, a repeated frame, a default image, loops; hand-built 16-bit RGBA,
  interlaced, zero delay denominator and ``OP_PREVIOUS`` first frame) read
  by ``imread``, ``imreadmulti``, ``imcount``, ``imread_with_metadata`` and
  cv2's ``imreadanimation``, ``imdecodeanimation`` and ``imdecodemulti``
  equals the reference's: frames byte for byte, counts, int durations,
  loop, the metadata dict, and where Pillow fails (the later frames of an
  interlaced animation) the same failure; the manifest is Pillow's.
* Pillow's animations with disposal and blend lists or scalars and a
  default image read as Pillow reads them.
* Writes of RGB, gray and BGRA frames with durations (lists or scalars) and
  loops, what the port's callers pass, read back in Pillow with the
  frames, ``n_frames`` and ``info`` of the reference's file, with equal
  ``acTL`` and ``fcTL`` fields (sequence numbers too); cv2's
  ``imwritemulti``, ``imwriteanimation`` and ``imencodeanimation`` of
  ``.png`` answer as the reference's, and ``imencodemulti`` of ``.png``
  (False, empty).
* A seeded sweep of small random animations, each way, and hand-built
  broken streams (truncated chunks, sequence errors, frames outside the
  image, missing frame data) against Pillow's answer, read whole and by
  cv2's ``imdecodeanimation`` from a start frame for a count of frames
  against ``rustcv_tpu.cv2``'s.
* Phase 3z of ``chip_smoke.py`` runs here on CPU Mats.
"""

import io
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
from rustcv_tpu_torch import imgcodecs
from rustcv_tpu_torch.core import CameraError, Mat
from rustcv_tpu_torch.imgcodecs import apng
from tools import make_apng_data as AD

DATA = Path(__file__).resolve().parent / "data" / "apng"
MANIFEST = json.loads((DATA / "manifest.json").read_text())
FIXTURES = sorted(MANIFEST)


def _pillow(data: bytes):
    """The reference's reads of ``data``: (BGR frames, each frame's info,
    n_frames, loop, the exception that stopped the frames or None), or the
    exception ``Image.open`` raises."""
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            im = Image.open(io.BytesIO(data))
    except Exception as e:  # noqa: BLE001 - the reference's answer, whatever it is
        return e
    frames, infos, err = [], [], None
    try:
        for f in ImageSequence.Iterator(im):
            frames.append(np.asarray(f.convert("RGB"))[..., ::-1].copy())
            infos.append(dict(f.info))
    except Exception as e:  # noqa: BLE001
        err = e
    return frames, infos, getattr(im, "n_frames", 1), im.info.get("loop", 0), err


def _port(data: bytes):
    """The port's reads, in :func:`_pillow`'s shape (the infos: durations)."""
    try:
        a = apng.Apng(data)
    except ValueError as e:
        return e
    frames, durations, err = [], [], None
    try:
        for canvas, info in a.composites():
            frames.append(np.ascontiguousarray(imgcodecs._host.to_bgr(a.png.convert_rgb(canvas))))
            durations.append(info.get("duration"))
    except ValueError as e:
        err = e
    return frames, durations, a.n_frames, a.loop, err


def _same_reads(data: bytes):
    """The port reads ``data`` as Pillow does: the same frames, durations,
    count and loop, and an error where Pillow's open or frames stop on
    one."""
    want, got = _pillow(data), _port(data)
    if isinstance(want, Exception):
        assert isinstance(got, Exception), (want, got)
        return
    assert not isinstance(got, Exception), (want, got)
    frames, infos, n, loop, err = want
    assert (got[2], got[3]) == (n, loop)
    assert (got[4] is None) == (err is None), (got[4], err)
    assert len(got[0]) == len(frames)
    for g, w in zip(got[0], frames):
        assert g.shape == w.shape and np.array_equal(g, w)
    assert got[1] == [i.get("duration") for i in infos]


# -- the fixtures -----------------------------------------------------------------------------


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_reads_equal_the_references(name, tmp_path, jax_cpu):
    path = str(DATA / name)
    m = MANIFEST[name]
    assert imgcodecs.imcount(path) == jax_codecs.imcount(path) == m["n_frames"]
    got = imgcodecs.imread(path, device="cpu").to_numpy()
    assert np.array_equal(got, jax_codecs.imread(path).to_numpy())
    mat, meta = imgcodecs.imread_with_metadata(path, device="cpu")
    want_mat, want = jax_codecs.imread_with_metadata(path)
    assert meta == want == m["metadata"]
    assert np.array_equal(mat.to_numpy(), want_mat.to_numpy())
    if m["read_error"] is None:
        got = [x.to_numpy() for x in imgcodecs.imreadmulti(path, device="cpu")]
        want = [x.to_numpy() for x in jax_codecs.imreadmulti(path)]
        assert len(got) == len(want) == len(m["sha256"])
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
    else:  # the reference's read raises on the second frame; the port's too
        with pytest.raises(Exception):
            jax_codecs.imreadmulti(path)
        with pytest.raises(CameraError):
            imgcodecs.imreadmulti(path, device="cpu")
    buf = np.fromfile(path, np.uint8)
    fields = lambda r: (r[0], r[1].frames, r[1].durations, r[1].loop_count)  # noqa: E731
    for call in (lambda C: fields(C.imreadanimation(path)),
                 lambda C: fields(C.imdecodeanimation(buf)),
                 lambda C: fields(C.imreadanimation(path, 1, 1)),
                 lambda C: fields(C.imreadanimation(path, 0, 1))):
        got, want = call(P), call(R)
        assert got[0] is want[0] and got[2:] == want[2:] and len(got[1]) == len(want[1])
        assert all(np.array_equal(a, b) for a, b in zip(got[1], want[1]))
    assert fields(P.imreadanimation(path))[2] == m["durations"]
    if m["read_error"] is None:
        got, want = P.imdecodemulti(buf), R.imdecodemulti(buf)
        assert got[0] is want[0] is True and len(got[1]) == len(want[1])
        assert all(np.array_equal(a, b) for a, b in zip(got[1], want[1]))
    assert P.imcount(path) == R.imcount(path) and P.haveImageReader(path) is R.haveImageReader(path)


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_manifest_is_pillows(name):
    """The committed truths are what Pillow reads and writes now."""
    data = (DATA / name).read_bytes()
    truth, frames = AD.read_truths(data)
    truth.update(AD.write_truths(frames, truth["durations"], truth["loop"]))
    assert truth == MANIFEST[name]
    _same_reads(data)


def test_fixtures_stay_small():
    assert sum(p.stat().st_size for p in DATA.iterdir()) < 1 << 20
    assert sorted(p.name for p in DATA.glob("*.png")) == FIXTURES


# -- writes -----------------------------------------------------------------------------------


def _controls(data: bytes) -> list:
    """IHDR, acTL, every fcTL (with its sequence number) and each data
    chunk's kind and sequence number."""
    out, p = [], 8
    while p < len(data):
        n, kind = struct.unpack(">I4s", data[p:p + 8])
        body = data[p + 8:p + 8 + n]
        if kind == b"IHDR":
            out.append(("IHDR",) + struct.unpack(">IIBBBBB", body))
        elif kind == b"acTL":
            out.append(("acTL",) + struct.unpack(">II", body))
        elif kind == b"fcTL":
            out.append(("fcTL",) + struct.unpack(">IIIIIHHBB", body))
        elif kind == b"fdAT":
            out.append(("fdAT", struct.unpack(">I", body[:4])[0]))
        elif kind == b"IDAT":
            out.append(("IDAT",))
        p += 12 + n
    return out


def _reference_file(frames, **kw):
    buf = io.BytesIO()
    ims = [Image.fromarray(f) for f in frames]
    ims[0].save(buf, "PNG", save_all=True, append_images=ims[1:], **kw)
    return buf.getvalue()


def _same_writes(frames, **kw):
    """``write_apng`` of RGB / gray / RGBA arrays (and of CPU tensors)
    against Pillow's save with the same arguments: the same failure, or
    files Pillow reads to the same frames, count and info, with the same
    control chunks."""
    try:
        ref = _reference_file(frames, **kw)
    except ValueError:
        with pytest.raises(ValueError):
            apng.write_apng(frames, **kw)
        return None
    mine = apng.write_apng(frames, **kw)
    assert apng.write_apng([torch.from_numpy(f) for f in frames], **kw) == mine
    assert _controls(mine) == _controls(ref)
    got, want = _pillow(mine), _pillow(ref)
    assert got[2:4] == want[2:4] and got[1] == want[1] and got[4] is want[4] is None
    assert len(got[0]) == len(want[0])
    assert all(np.array_equal(a, b) for a, b in zip(got[0], want[0]))
    _same_reads(mine)
    return mine


def _moving(seed, n, ch, h=17, w=23):
    """``n`` frames of ``ch`` channels with a box moving; the third equals
    the second."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h, w, 4)).astype(np.uint8)
    full = []
    for i in range(n):
        f = base.copy()
        f[2 + i:8 + 2 * i, 3 * i:4 + 3 * i] = rng.integers(0, 256, 4)
        full.append(full[1].copy() if i == 2 else f)
    return [f[..., 0].copy() if ch == 1 else f[..., :ch].copy() for f in full]


WRITES = {
    "rgb duration list": (3, dict(duration=[40, 70, 100, 30])),
    "rgb duration and loop": (3, dict(duration=50, loop=3)),
    "gray duration list": (1, dict(duration=[10, 20, 30, 40], loop=0)),
    "gray duration": (1, dict(duration=25)),
    "gray no arguments": (1, {}),
    "rgba duration list": (4, dict(duration=[40, 40, 80, 80])),
    "rgba loop": (4, dict(loop=2)),
    "rgba zero durations": (4, dict(duration=[0, 0, 0, 0], loop=1)),
    "rgb durations of 0.5 ms steps": (3, dict(duration=[12.5, 0.5, 1000, 65.25])),
    "rgb no arguments": (3, {}),
}


@pytest.mark.parametrize("name", list(WRITES))
def test_writes_equal_the_references(name):
    ch, kw = WRITES[name]
    _same_writes(_moving(len(name), 4, ch), **kw)


OPTIONS = {
    "rgb disposal list": (3, dict(duration=[40, 70, 100, 30], disposal=[0, 1, 2, 1])),
    "rgb blend list": (3, dict(duration=50, disposal=2, blend=[0, 1, 1, 0], loop=3)),
    "gray disposal none": (1, dict(duration=25, disposal=[0, 0, 0, 0])),
    "gray previous": (1, dict(duration=25, disposal=[0, 2, 0, 0])),
    "rgba disposal list": (4, dict(duration=[40, 40, 80, 80], disposal=[2, 2, 1, 0])),
    "rgba blend": (4, dict(blend=1, loop=2)),
    "rgba default image": (4, dict(duration=[30, 60, 90], default_image=True)),
}


@pytest.mark.parametrize("name", list(OPTIONS))
def test_reads_of_pillows_disposals_blends_and_default_images(name, jax_cpu):
    """Options of Pillow's writer that no caller of the port's passes: the
    files Pillow writes with them read as Pillow and the reference read
    them, whole and through cv2's animation reads."""
    ch, kw = OPTIONS[name]
    frames = _moving(len(name), 4, ch)
    data = _reference_file(frames, **kw)
    _same_reads(data)
    _same_cv2_reads(data, [(0, 32767), (1, 1), (2, 5)])


def test_writes_of_mixed_modes_and_one_frame():
    """Gray and RGB frames write RGB, any RGBA frame RGBA; frames that merge
    into one write a still PNG, as Pillow's."""
    f = _moving(3, 3, 4)
    _same_writes([f[0][..., 0].copy(), f[1][..., :3].copy(), f[2][..., :3].copy()], duration=20)
    _same_writes([f[0][..., :3].copy(), f[1], f[2][..., 0].copy()])
    one = f[0][..., :3].copy()
    data = _same_writes([one, one.copy(), one.copy()], duration=[10, 20, 30])
    assert b"acTL" not in data
    with pytest.raises(ValueError, match="duration"):
        apng.write_apng([one, one[::-1].copy()], duration=[70000 * 1000, 1])
    with pytest.raises(ValueError):
        _reference_file([one, one[::-1].copy()], duration=[70000 * 1000, 1])


@pytest.mark.parametrize("ext", [".png", ".PNG"])
@pytest.mark.parametrize("loop", [0, 3])
def test_cv2_png_animation_writes_answer_as_the_references(ext, loop, tmp_path, jax_cpu):
    frames = [f[..., ::-1].copy() for f in _moving(5, 4, 3)]
    frames.insert(1, frames[0].copy())
    files = {}
    for C in (P, R):
        a = C.Animation(loop)
        a.frames, a.durations = frames, [40, 80, 80, 160, 33]
        path = tmp_path / f"{C.__name__}{ext}"
        assert C.imwriteanimation(str(path), a)
        ok, buf = C.imencodeanimation(ext, a)
        assert ok and buf.tobytes() == path.read_bytes()
        mpath = tmp_path / f"m{C.__name__}{ext}"
        assert C.imwritemulti(str(mpath), frames)
        files[C] = (path.read_bytes(), mpath.read_bytes())
        assert C.imencodemulti(ext, frames)[0] is False and C.imencodemulti(ext, frames)[1].size == 0
    for mine, ref in zip(files[P], files[R]):
        assert _controls(mine) == _controls(ref)
        got, want = _pillow(mine), _pillow(ref)
        assert got[1:4] == want[1:4] and all(np.array_equal(a, b) for a, b in zip(got[0], want[0]))
    got, want = R.imreadanimation(str(tmp_path / f"rustcv_tpu_torch.cv2{ext}")), \
        R.imreadanimation(str(tmp_path / f"rustcv_tpu.cv2{ext}"))
    assert got[1].durations == want[1].durations == [120, 240, 33]
    mats = [Mat.from_array(f, device="cpu") for f in frames]
    assert imgcodecs.imwritemulti(str(tmp_path / "i.png"), mats)
    assert jax_codecs.imwritemulti(str(tmp_path / "j.png"), frames)
    assert _controls((tmp_path / "i.png").read_bytes()) == _controls((tmp_path / "j.png").read_bytes())


def test_a_device_mat_writes_the_host_mats_bytes(tmp_path):
    """The frames' comparisons run on the Mats' device (a CPU tensor here):
    the same bytes as host Mats."""
    frames = _moving(9, 4, 3)
    dev = [Mat.from_device(torch.from_numpy(f.copy())) for f in frames]
    host = [Mat.from_array(f.copy(), device="cpu") for f in frames]
    assert imgcodecs.encode_frames("png", dev, duration=[1, 2, 3, 4], loop=2) == \
        imgcodecs.encode_frames("png", host, duration=[1, 2, 3, 4], loop=2)


# -- the sweep --------------------------------------------------------------------------------


def _random_animation(seed, writer_options=True):
    rng = np.random.default_rng(seed)
    mode = ["RGB", "RGBA", "L", "P", "LA"][seed % 5]
    h, w = (int(v) for v in rng.integers(3, 24, 2))
    n = int(rng.integers(1, 6))
    base = rng.integers(0, 256, (h, w, 4)).astype(np.uint8)
    frames = []
    for _ in range(n):
        f = base.copy()
        if rng.random() < 0.7:
            y, x = int(rng.integers(0, h)), int(rng.integers(0, w))
            f[y:y + int(rng.integers(1, h)), x:x + int(rng.integers(1, w))] = rng.integers(0, 256, 4)
        if rng.random() < 0.3:
            f[..., 3] = rng.choice([0, 128, 255], (h, w))
        base = f if rng.random() < 0.8 else base
        frames.append(f)
    kw = {}
    if rng.random() < 0.7:
        kw["duration"] = [int(v) for v in rng.integers(0, 300, n)] if rng.random() < 0.5 \
            else int(rng.integers(0, 300))
    for key, top in (("disposal", 3), ("blend", 2)):
        if rng.random() < 0.6:
            kw[key] = [int(v) for v in rng.integers(0, top, n)] if rng.random() < 0.5 \
                else int(rng.integers(0, top))
    if rng.random() < 0.3:
        kw["loop"] = int(rng.integers(0, 5))
    if not writer_options:  # what the port's callers pass its writer
        return mode, frames, {k: v for k, v in kw.items() if k in ("duration", "loop")}
    if rng.random() < 0.2 and n > 1:
        kw["default_image"] = True
        for key in ("duration", "disposal", "blend"):
            if isinstance(kw.get(key), list):
                kw[key] = kw[key][1:]
    return mode, frames, kw


@pytest.mark.parametrize("seed", range(40))
def test_sweep_reads_of_pillows_animations(seed):
    mode, frames, kw = _random_animation(seed)
    ims = [Image.fromarray(f, "RGBA") for f in frames]
    ims = [im.convert("RGB").quantize(16) if mode == "P" else im.convert(mode) for im in ims]
    if mode == "P" and seed % 2:
        kw["transparency"] = seed % 16
    buf = io.BytesIO()
    try:
        ims[0].save(buf, "PNG", save_all=True, append_images=ims[1:], **kw)
    except ValueError:  # Pillow's own refusals (an L frame disposed to the background)
        return
    _same_reads(buf.getvalue())


@pytest.mark.parametrize("seed", range(40))
def test_sweep_writes_equal_pillows(seed):
    mode, frames, kw = _random_animation(seed + 1000, writer_options=False)
    ch = {"RGB": 3, "RGBA": 4, "L": 1, "P": 3, "LA": 4}[mode]
    _same_writes([f[..., 0].copy() if ch == 1 else f[..., :ch].copy() for f in frames], **kw)


# -- broken and odd streams -------------------------------------------------------------------


def _stream(**kw):
    rng = np.random.default_rng(4)
    a, b = rng.integers(0, 256, (6, 7, 3)), rng.integers(0, 256, (3, 4, 3))
    frames = kw.pop("frames", [dict(samples=a), dict(samples=b, xy=(2, 1))])
    return AD.apng_stream((7, 6), 8, 2, frames, **kw)


def _patched(data: bytes, kind: bytes, which: int, new_body) -> bytes:
    """``data`` with the ``which``-th chunk of ``kind`` given another body
    (a function of the old one; CRC redone) or removed (None)."""
    out, p, seen = [data[:8]], 8, 0
    while p < len(data):
        n, k = struct.unpack(">I4s", data[p:p + 8])
        body = data[p + 8:p + 8 + n]
        if k == kind:
            if seen == which:
                if new_body is None:
                    p += 12 + n
                    seen += 1
                    continue
                body = new_body(body)
            seen += 1
        out.append(AD._chunk(k, body))
        p += 12 + n
    return b"".join(out)


BROKEN = {
    "acTL truncated": lambda: _patched(_stream(), b"acTL", 0, lambda b: b[:6]),
    "acTL of 0 frames": lambda: _stream(n_frames=0),
    "acTL of more frames than the file": lambda: _stream(n_frames=4),
    "acTL of fewer frames than the file": lambda: _stream(n_frames=1),
    "two acTL": lambda: _patched(_stream(), b"IHDR", 0, lambda b: b + b"")[:33]
    + AD._chunk(b"acTL", struct.pack(">II", 2, 0)) + _stream()[33:],
    "fcTL truncated": lambda: _patched(_stream(), b"fcTL", 0, lambda b: b[:20]),
    "fcTL sequence not 0": lambda: _patched(_stream(), b"fcTL", 0,
                                            lambda b: struct.pack(">I", 5) + b[4:]),
    "fcTL sequence skips": lambda: _patched(_stream(), b"fcTL", 1,
                                            lambda b: struct.pack(">I", 7) + b[4:]),
    "fdAT sequence skips": lambda: _patched(_stream(), b"fdAT", 0,
                                            lambda b: struct.pack(">I", 9) + b[4:]),
    "fdAT truncated": lambda: _patched(_stream(), b"fdAT", 0, lambda b: b[:2]),
    "frame outside the image": lambda: _patched(_stream(), b"fcTL", 1, lambda b: b[:12]
                                                + struct.pack(">I", 5) + b[16:]),
    "frame without data": lambda: _patched(_stream(), b"fdAT", 0, None),
    "delay denominator 0": lambda: _stream(frames=[
        dict(samples=np.zeros((6, 7, 3)), delay=(7, 0)), dict(samples=np.ones((2, 2, 3)),
                                                             delay=(0, 0))]),
    "OP_PREVIOUS first then OP_BACKGROUND": lambda: _stream(frames=[
        dict(samples=np.full((6, 7, 3), 9), dispose=2),
        dict(samples=np.full((2, 3, 3), 200), xy=(1, 1), dispose=1),
        dict(samples=np.full((1, 1, 3), 50), xy=(5, 4))]),
    "default image": lambda: _stream(default=np.full((6, 7, 3), 77)),
    "first fcTL smaller than the image": lambda: _stream(frames=[
        dict(samples=np.full((3, 4, 3), 40), xy=(1, 2)), dict(samples=np.full((2, 2, 3), 9))]),
    "palette with tRNS alphas, blended": lambda: AD.apng_stream((5, 4), 8, 3, [
        dict(samples=np.arange(20).reshape(4, 5, 1) % 4),
        dict(samples=(np.arange(6).reshape(2, 3, 1) + 1) % 4, xy=(1, 1), blend=1)],
        palette=[[0, 0, 0], [255, 0, 0], [0, 255, 0], [0, 0, 255]], trns=b"\xff\x80\x00"),
    "rgb with tRNS, blended": lambda: AD.apng_stream((5, 4), 8, 2, [
        dict(samples=np.full((4, 5, 3), 30)),
        dict(samples=np.array([[[1, 2, 3], [200, 9, 9]]] * 2), xy=(2, 1), blend=1)],
        trns=struct.pack(">HHH", 1, 2, 3)),
    "1-bit gray": lambda: AD.apng_stream((9, 3), 1, 0, [
        dict(samples=np.arange(27).reshape(3, 9, 1) % 2),
        dict(samples=np.ones((1, 2, 1), int), xy=(3, 1), blend=1)]),
    "16-bit gray, source": lambda: AD.apng_stream((4, 3), 16, 0, [
        dict(samples=np.arange(12).reshape(3, 4, 1) * 40),
        dict(samples=np.full((1, 2, 1), 9), xy=(1, 1))]),
    "16-bit gray + alpha, blended": lambda: AD.apng_stream((4, 3), 16, 4, [
        dict(samples=np.full((3, 4, 2), 30000)),
        dict(samples=np.array([[[65535, 0], [1000, 40000]]]), xy=(1, 1), blend=1)]),
}


@pytest.mark.parametrize("name", list(BROKEN))
def test_broken_and_odd_streams_read_as_pillows(name):
    _same_reads(BROKEN[name]())


def _same_cv2_reads(data: bytes, ranges) -> None:
    """cv2's ``imdecodeanimation`` of ``data`` from each (start, count) of
    ``ranges`` answers as the reference's: the reference's seek of the
    frame after the last one asked for fails it where that seek fails."""
    buf = np.frombuffer(data, np.uint8)
    for start, count in ranges:
        got = P.imdecodeanimation(buf, start=start, count=count)
        want = R.imdecodeanimation(buf, start=start, count=count)
        assert got[0] is want[0], (start, count)
        assert (got[1].durations, got[1].loop_count) == (want[1].durations, want[1].loop_count)
        assert len(got[1].frames) == len(want[1].frames), (start, count)
        assert all(np.array_equal(a, b) for a, b in zip(got[1].frames, want[1].frames))


@pytest.mark.parametrize("name", list(BROKEN))
def test_broken_and_odd_streams_through_cv2_from_a_start_for_a_count(name, jax_cpu):
    _same_cv2_reads(BROKEN[name](), [(0, 1), (0, 2), (1, 1), (0, 32767), (2, 1)])


def test_what_the_writer_leaves_is_not_ported(tmp_path, jax_cpu):
    """The writes the port once refused (item 8d-ii-a), as Pillow makes them:
    2-channel (LA) and mixed-size frames give Pillow's file, a u16 3-channel
    frame Image.fromarray's TypeError; cv2's imwritemulti of LA frames
    writes the reference's bytes, and of u16 3-channel frames answers False
    as the reference's does."""
    f = np.random.default_rng(7).integers(0, 256, (4, 5, 3), np.uint8)
    for frames in ([f[..., :2], f[::-1, :, :2].copy()], [f, f[:2]]):
        assert apng.write_apng(frames) == _reference_file(frames)
    u16 = [f.astype(np.uint16), f.astype(np.uint16)]
    with pytest.raises(TypeError, match="Cannot handle this data type"):
        apng.write_apng(u16)
    with pytest.raises(TypeError, match="Cannot handle this data type"):
        _reference_file(u16)
    for C in (P, R):
        assert C.imwritemulti(str(tmp_path / f"{C.__name__}.png"), [f[..., :2], f[..., 1:]])
        assert C.imwritemulti(str(tmp_path / f"{C.__name__}16.png"), u16) is False
    assert (tmp_path / "rustcv_tpu_torch.cv2.png").read_bytes() == \
        (tmp_path / "rustcv_tpu.cv2.png").read_bytes()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["rustcv_tpu.cv2.png",
                                                          "rustcv_tpu_torch.cv2.png"]


def test_a_16_bit_gray_blend_is_not_ported():
    """Pillow's load of a 16-bit gray frame blended OP_OVER converts its box
    to RGBA, which Pillow 12.1 cannot do for I;16: its frames stop there
    with a ValueError, and the port's stop there too, after the same
    frames."""
    data = AD.apng_stream((4, 3), 16, 0, [dict(samples=np.full((3, 4, 1), 500)),
                                          dict(samples=np.full((1, 2, 1), 9), xy=(1, 1),
                                               blend=1)])
    _same_reads(data)
    frames = _pillow(data)[0]
    assert len(frames) == 1 and isinstance(_pillow(data)[4], ValueError)
    with pytest.raises(ValueError, match="I;16 to RGBA"):
        list(apng.Apng(data).frames())


# -- chip_smoke.py's phase 3z -----------------------------------------------------------------


def test_smoke_phase_3z_rehearsed_on_the_cpu():
    """Phase 3z's whole script on CPU Mats: every fixture read and written
    as the manifest says, the quantizer's frames Pillow's; no kernel
    launches."""
    counts = S.run_formats_8d(dev="cpu")
    assert not any(counts.values())
