"""The port's host codecs (PNG, BMP, PPM/PGM), the highgui PNG dump, the
full host JPEG decode, ``mjpeg_backend="host"`` and the host JPEG encoders
on the CPU against the JAX package, which reaches Pillow and libjpeg-turbo
for all of them.

* Files either side writes read to equal pixels on the other side, and the
  default calls (``imwrite``, ``imread``, ``imencode(".png")``) give the
  reference's pixels; the bytes may differ.
* The host JPEG decode equals ``rustcv_tpu.ops.decode.decode_mjpeg_host_rgb``
  (libjpeg-turbo's default decode, through Pillow) byte for byte, BGR order.
* The host JPEG encoders (``imencode(".jpg")`` and ``VideoWriter()`` with
  the host named, and by default for a host frame; a device frame encodes
  on its device by default) are the port's encoder on a CPU tensor: other
  bytes than Pillow's, held to the encoder's stated tolerance against
  Pillow's own encode at the same settings
  (``tests/test_jpeg_encode.py:141-165``: PSNR at most 0.5 dB below it).

Inputs are made from seeds; sizes are small."""

import io
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image, PngImagePlugin

import rustcv_tpu.capture.simulation as jax_sim
import rustcv_tpu.core as jax_core
from rustcv_tpu import capture as jax_capture
from rustcv_tpu import highgui as jax_hg
from rustcv_tpu import imgcodecs as jax_codecs
from rustcv_tpu.capture import SimulationDriver as JaxDriver
from rustcv_tpu.ops.decode import decode_mjpeg_host_rgb
from rustcv_tpu.runtime import MultiStreamEngine as JaxEngine
from rustcv_tpu_torch import core, highgui, imgcodecs, native
from rustcv_tpu_torch.capture import ModeDescriptor, SimulationDriver, VideoCapture, VideoWriter
from rustcv_tpu_torch.capture import simulation as sim
from rustcv_tpu_torch.core import Mat
from rustcv_tpu_torch.imgcodecs import host
from rustcv_tpu_torch.ops import decode, jpeg_encode
from rustcv_tpu_torch.runtime import MultiStreamEngine

torch.set_num_threads(2)

SHAPES = [(17, 23, 3), (16, 32, 3), (9, 31, 1), (12, 5, 1)]  # BGR and gray, odd widths


def _img(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


def _smooth(h, w, seed):
    """A photographic-ish BGR image: JPEG's codec loss stays small."""
    yy, xx = np.mgrid[0:h, 0:w]
    rng = np.random.default_rng(seed)
    base = 127 + 90 * np.sin(xx / (5.0 + seed))[..., None] * np.cos(yy / 7.0)[..., None]
    return np.clip(base + rng.normal(0, 6, (h, w, 3)), 0, 255).astype(np.uint8)


def _mat(a):
    return Mat.from_array(a, device="cpu")


def _pillow_reads(data):
    """What the reference's imread gives for these bytes: RGB → BGR."""
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))[..., ::-1]


def _as_bgr(a):
    return np.repeat(a, 3, axis=2) if a.shape[2] == 1 else a


# -- PNG, BMP, PPM/PGM both ways -------------------------------------------------

FORMATS = ["png", "bmp", "ppm", "pgm"]


@pytest.mark.parametrize("ext", FORMATS)
@pytest.mark.parametrize("shape", SHAPES)
def test_port_files_read_to_equal_pixels_in_the_reference(jax_cpu, tmp_path, ext, shape):
    a = _img(shape, sum(shape))
    path = str(tmp_path / f"x.{ext}")
    assert imgcodecs.imwrite(path, _mat(a))
    np.testing.assert_array_equal(jax_codecs.imread(path).to_numpy(), _as_bgr(a))
    back = imgcodecs.imread(path, device="cpu")
    assert back.is_on_device and back.device().device.type == "cpu"
    np.testing.assert_array_equal(back.to_numpy(), _as_bgr(a))


@pytest.mark.parametrize("ext", FORMATS)
@pytest.mark.parametrize("shape", SHAPES)
def test_reference_files_read_to_equal_pixels_in_the_port(jax_cpu, tmp_path, ext, shape):
    a = _img(shape, sum(shape) + 1)
    path = str(tmp_path / f"x.{ext}")
    if shape[2] == 1:  # the reference cannot write a gray Mat: Pillow's gray image
        Image.fromarray(a[..., 0], "L").save(path)
    else:
        assert jax_codecs.imwrite(path, jax_core.Mat.from_array(a))
    want = jax_codecs.imread(path).to_numpy()
    np.testing.assert_array_equal(want, _as_bgr(a))
    np.testing.assert_array_equal(imgcodecs.imread(path, device="cpu").to_numpy(), want)


@pytest.mark.parametrize("mode", ["RGBA", "LA", "P", "L", "RGB"])
def test_png_modes_pillow_writes(mode):
    rng = np.random.default_rng(len(mode))
    rgb = Image.fromarray(rng.integers(0, 256, (13, 19, 3), np.uint8))
    img = rgb.quantize(40) if mode == "P" else rgb.convert(mode)
    if mode == "RGBA":
        img.putalpha(Image.fromarray(rng.integers(0, 256, (13, 19), np.uint8)))
    buf = io.BytesIO()
    img.save(buf, "PNG")
    got = imgcodecs.imdecode(buf.getvalue(), device="cpu").to_numpy()
    np.testing.assert_array_equal(got, _pillow_reads(buf.getvalue()))


def _filtered_png(img, ftype):
    """A PNG whose rows all use filter ``ftype``, made here (Pillow picks
    its own filters)."""
    h, w, ch = img.shape
    x = img.reshape(h, w * ch).astype(np.int64)
    out = np.zeros((h, w * ch + 1), np.uint8)
    out[:, 0] = ftype
    for r in range(h):
        up = x[r - 1] if r else np.zeros(w * ch, np.int64)
        for i in range(w * ch):
            a = x[r, i - ch] if i >= ch else 0
            b, c = up[i], (up[i - ch] if i >= ch else 0)
            if ftype == 0:
                pred = 0
            elif ftype == 1:
                pred = a
            elif ftype == 2:
                pred = b
            elif ftype == 3:
                pred = (a + b) // 2
            else:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            out[r, i + 1] = (x[r, i] - pred) % 256

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    ctype = {1: 0, 3: 2, 4: 6}[ch]
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(out.tobytes())) + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("ftype", range(5))
def test_png_every_filter_type(ftype, channels):
    img = _img((7, 9, channels), ftype * 10 + channels)
    data = _filtered_png(img, ftype)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))).reshape(img.shape), img)
    np.testing.assert_array_equal(imgcodecs.imdecode(data, device="cpu").to_numpy(),
                                  _pillow_reads(data))


def test_png_text_metadata_round_trips_both_ways(jax_cpu, tmp_path):
    a = _img((10, 12, 3), 5)
    meta = {"camera": "sim:0", "note": "ünïcode ℕ", "fps": "30"}
    port_path, ref_path = str(tmp_path / "p.png"), str(tmp_path / "r.png")
    assert imgcodecs.imwrite_with_metadata(port_path, _mat(a), meta)
    mat, got = jax_codecs.imread_with_metadata(port_path)
    np.testing.assert_array_equal(mat.to_numpy(), a)
    assert got == meta
    assert jax_codecs.imwrite_with_metadata(ref_path, jax_core.Mat.from_array(a), meta)
    mat, got = imgcodecs.imread_with_metadata(ref_path, device="cpu")
    np.testing.assert_array_equal(mat.to_numpy(), a)
    assert got == meta
    info = PngImagePlugin.PngInfo()
    info.add_text("z", "compressed", zip=True)
    info.add_itxt("i", "ℕ itxt", zip=True)
    buf = io.BytesIO()
    Image.fromarray(a).save(buf, "PNG", pnginfo=info)
    assert host.read_png(buf.getvalue())[1] == {"z": "compressed", "i": "ℕ itxt"}


def test_default_calls_give_the_references_pixels(jax_cpu, tmp_path):
    a = _img((21, 27, 3), 9)
    np.testing.assert_array_equal(_pillow_reads(imgcodecs.imencode(".png", _mat(a))), a)
    ref_png = jax_codecs.imencode(".png", jax_core.Mat.from_array(a))
    np.testing.assert_array_equal(imgcodecs.imdecode(ref_png, device="cpu").to_numpy(),
                                  jax_codecs.imdecode(ref_png).to_numpy())
    for ext in ("png", "bmp", "ppm", "jpg"):
        path = str(tmp_path / f"d.{ext}")
        assert jax_codecs.imwrite(path, jax_core.Mat.from_array(a))
        np.testing.assert_array_equal(imgcodecs.imread(path, device="cpu").to_numpy(),
                                      jax_codecs.imread(path).to_numpy())


def test_the_dump_writes_a_png_the_reference_reads(monkeypatch, tmp_path, jax_cpu):
    monkeypatch.setenv("RUSTCV_TPU_DISPLAY_DIR", str(tmp_path))
    a = _img((14, 22, 3), 3)
    highgui.imshow("cam 0/main", _mat(a))
    highgui.imshow("dev", Mat.from_device(torch.from_numpy(a[::-1].copy())))
    assert sorted(p.name for p in tmp_path.iterdir()) == ["cam_0_main.png", "dev.png"]
    np.testing.assert_array_equal(jax_codecs.imread(str(tmp_path / "cam_0_main.png")).to_numpy(), a)
    np.testing.assert_array_equal(jax_codecs.imread(str(tmp_path / "dev.png")).to_numpy(), a[::-1])
    monkeypatch.setenv("RUSTCV_TPU_DISPLAY_DIR", str(tmp_path / "ref"))
    jax_hg.imshow("cam 0/main", jax_core.Mat.from_array(a))
    np.testing.assert_array_equal(
        imgcodecs.imread(str(tmp_path / "ref" / "cam_0_main.png"), device="cpu").to_numpy(), a)
    highgui.destroy_all_windows()
    jax_hg.destroy_all_windows()


@pytest.mark.parametrize("call", ["tiff", "gif", "webp", "multi", "count", "writemulti", "exif",
                                  "png16", "ascii_pnm"])
def test_what_stays_not_ported_raises(tmp_path, call, jax_cpu):
    """TIFF, GIF, the multi-page calls (item 8b), WebP reads (item 8c) and
    writes (item 8c-ii), animated PNG writes (item 8d-i), EXIF, 16-bit PNG
    and ASCII PNM, which once raised ``not_ported``, read and write as the
    reference does."""
    a = _img((4, 4, 3), 0)
    buf = io.BytesIO()
    if call == "webp":  # the write (item 8c-ii) is Pillow's size; the read (item 8c) the reference's
        assert imgcodecs.imwrite(str(tmp_path / f"x.{call}"), _mat(a))
        assert jax_codecs.imwrite(str(tmp_path / f"r.{call}"), jax_core.Mat.from_array(a))
        with Image.open(tmp_path / f"x.{call}") as im:
            assert im.size == (4, 4) and im.mode == "RGB"
        assert (tmp_path / f"x.{call}").stat().st_size <= 1.25 * (tmp_path / f"r.{call}").stat().st_size
        Image.fromarray(a).save(buf, call.upper())
        np.testing.assert_array_equal(imgcodecs.imdecode(buf.getvalue(), device="cpu").to_numpy(),
                                      jax_codecs.imdecode(buf.getvalue()).to_numpy())
        return
    if call in ("tiff", "gif"):
        path = tmp_path / f"x.{call}"
        assert imgcodecs.imwrite(str(path), _mat(a))
        assert jax_codecs.imwrite(str(tmp_path / f"r.{call}"), jax_core.Mat.from_array(a))
        np.testing.assert_array_equal(jax_codecs.imread(str(path)).to_numpy(), a)
        Image.fromarray(a).save(buf, call.upper())
        np.testing.assert_array_equal(imgcodecs.imdecode(buf.getvalue(), device="cpu").to_numpy(),
                                      jax_codecs.imdecode(buf.getvalue()).to_numpy())
        return
    if call == "exif":
        exif = Image.Exif()
        exif[0x010F] = "maker"
        Image.fromarray(a).save(buf, "PNG", exif=exif)
    elif call == "png16":
        Image.fromarray(a[..., 0].astype(np.uint16) * 257).save(buf, "PNG")
    elif call == "ascii_pnm":
        buf.write(b"P3\n1 1\n255\n1 2 3\n")
    path = tmp_path / "x.png"
    path.write_bytes(buf.getvalue())
    if call == "exif":
        mat, meta = imgcodecs.imread_with_metadata(str(path), device="cpu")
        want_mat, want = jax_codecs.imread_with_metadata(str(path))
        assert meta == want == {"exif:271": "maker"}
        np.testing.assert_array_equal(mat.to_numpy(), want_mat.to_numpy())
        return
    if call in ("png16", "ascii_pnm"):
        read = (imgcodecs.imread(str(path), device="cpu") if call == "png16"
                else imgcodecs.imdecode(buf.getvalue(), device="cpu"))
        np.testing.assert_array_equal(read.to_numpy(), _pillow_reads(buf.getvalue()))
        return
    if call == "writemulti":  # a .png of one frame is a still PNG, of more an animated one
        ref = tmp_path / "r.png"
        for frames in ([a], [a, a[::-1].copy()]):
            assert imgcodecs.imwritemulti(str(path), [_mat(f) for f in frames])
            assert jax_codecs.imwritemulti(str(ref), [jax_core.Mat.from_array(f) for f in frames])
            got = [m.to_numpy() for m in jax_codecs.imreadmulti(str(path))]
            want = [m.to_numpy() for m in jax_codecs.imreadmulti(str(ref))]
            assert len(got) == len(want) == len(frames)
            assert all(np.array_equal(x, y) for x, y in zip(got, want))
        assert imgcodecs.imwritemulti(str(tmp_path / "x.tiff"), [_mat(a), _mat(a[::-1])])
        got = [m.to_numpy() for m in jax_codecs.imreadmulti(str(tmp_path / "x.tiff"))]
        assert len(got) == 2 and np.array_equal(got[1], a[::-1])
        return
    Image.fromarray(a).save(path, "PNG")
    if call == "count":
        assert imgcodecs.imcount(str(path)) == jax_codecs.imcount(str(path)) == 1
        return
    got = imgcodecs.imreadmulti(str(path), device="cpu")
    want = jax_codecs.imreadmulti(str(path))
    assert len(got) == len(want) == 1
    np.testing.assert_array_equal(got[0].to_numpy(), want[0].to_numpy())


def test_corrupt_and_unknown_files(tmp_path):
    good = host.write_png(_img((5, 6, 3), 1))
    bad_crc = bytearray(good)
    bad_crc[40] ^= 0xFF
    bad_size = bytearray(host.write_bmp(_img((2, 3, 3), 2)))
    bad_size[18:22] = (-3).to_bytes(4, "little", signed=True)
    for data in (bytes(bad_crc), good[:30], b"BM" + b"\x00" * 30, b"P6\n4 4\n255\n\x00",
                 bytes(bad_size), b"P6\n0 4\n255\n", b"nope"):
        with pytest.raises(core.CameraError):
            imgcodecs.imdecode(data, device="cpu")
    assert not imgcodecs.imwrite(str(tmp_path / "x.unknownext"), _mat(_img((4, 4, 3), 0)))
    # Pillow writes a 4-channel image to PPM as P6 of its first three channels
    assert imgcodecs.imwrite(str(tmp_path / "x.ppm"), _mat(_img((4, 4, 4), 0)))
    assert jax_codecs.imwrite(str(tmp_path / "j.ppm"), jax_core.Mat.from_array(_img((4, 4, 4), 0)))
    assert (tmp_path / "x.ppm").read_bytes() == (tmp_path / "j.ppm").read_bytes()


# -- the host JPEG decode ----------------------------------------------------------

SUBSAMPLING = {"4:4:4": 0, "4:2:2": 1, "4:2:0": 2}


def _pillow_jpeg(bgr, quality, sub, restart=0, gray=False):
    img = Image.fromarray(bgr[..., ::-1]).convert("L") if gray else Image.fromarray(bgr[..., ::-1])
    kw = {"quality": quality, "subsampling": SUBSAMPLING[sub]}
    if restart:
        kw["restart_marker_blocks"] = restart
    buf = io.BytesIO()
    img.save(buf, "JPEG", **kw)
    return buf.getvalue()


def _check_decode(data):
    want = decode_mjpeg_host_rgb(data)[..., ::-1]
    got = native.jpeg_decode_bgr(data)
    np.testing.assert_array_equal(got, want)
    padded = Mat.new(want.shape[0], want.shape[1], 3, step=want.shape[1] * 3 + 13, device="cpu")
    decode.decode_mjpeg_into_mat(data, padded)
    np.testing.assert_array_equal(padded.to_numpy(), want)


@pytest.mark.parametrize("restart", [0, 2])
@pytest.mark.parametrize("sub", ["4:4:4", "4:2:2", "4:2:0", "gray"])
@pytest.mark.parametrize("w,h", [(64, 48), (23, 17), (33, 31), (3, 2), (1, 40), (130, 9)])
def test_host_decode_of_pillow_jpegs_is_libjpegs(w, h, sub, restart):
    bgr = _smooth(h, w, w + h)
    for quality in (50, 90):
        _check_decode(_pillow_jpeg(bgr, quality, "4:2:0" if sub == "gray" else sub, restart,
                                   gray=sub == "gray"))


@pytest.mark.parametrize("sub", ["4:4:4", "4:2:2", "4:2:0", "gray"])
@pytest.mark.parametrize("w,h", [(64, 48), (23, 17), (37, 29)])
def test_host_decode_of_the_ports_jpegs_is_libjpegs(w, h, sub):
    bgr = _img((h, w, 3), w * h)
    for quality in (60, 95):
        if sub == "gray":
            data = jpeg_encode.encode_jpeg(bgr[..., 1], quality)
        else:
            data = jpeg_encode.encode_jpeg(bgr, quality, sub)
        _check_decode(data)


def test_host_decode_of_the_simulated_mjpeg_and_faults():
    for seq in range(3):
        _check_decode(sim.synth_raw(96, 64, core.PixelFormat.MJPEG, seq))
    with pytest.raises(core.DecodeError):
        decode.decode_mjpeg_host(b"\xff\xd8\xff\xe0garbage")
    mat = Mat.new(4, 4, 3, device="cpu")
    with pytest.raises(ValueError, match="out must be"):
        native.jpeg_decode_bgr(_pillow_jpeg(_smooth(8, 8, 0), 90, "4:2:0"), out=mat.array)


def test_frame_and_videocapture_host_decode_of_mjpeg(jax_cpu, monkeypatch):
    """Frame.decode_bgr, decode_to_device and VideoCapture's host read of
    MJPEG equal the reference's host decode."""
    monkeypatch.setitem(jax_sim._ENCODERS, jax_core.PixelFormat.MJPEG, sim.encode_mjpeg)
    raw = sim.synth_raw(64, 48, core.PixelFormat.MJPEG, 3)
    frame = core.Frame(raw, 64, 48, core.PixelFormat.MJPEG, 3, core.Timestamp(0, 0.0))
    want = decode_mjpeg_host_rgb(raw)[..., ::-1]
    np.testing.assert_array_equal(frame.decode_bgr().to_numpy(), want)
    np.testing.assert_array_equal(decode.decode_to_device(frame, "cpu").numpy(), want)
    cap = VideoCapture(0, SimulationDriver(
        paced=False, modes=[ModeDescriptor(core.PixelFormat.MJPEG, 64, 48, (30,))]))
    ref = jax_capture.VideoCapture(0, JaxDriver(
        paced=False, modes=[jax_capture.ModeDescriptor(jax_core.PixelFormat.MJPEG, 64, 48, (30,))]))
    try:
        mat, rmat = Mat(device="cpu"), jax_core.Mat()
        for _ in range(2):
            assert cap.read(mat) and ref.read(rmat)
            np.testing.assert_array_equal(mat.to_numpy(), rmat.to_numpy())
    finally:
        cap.release()


# -- mjpeg_backend="host" -----------------------------------------------------------


def _cfg(pkg):
    return pkg.SimpleConfig(width=64, height=48, fps=30, pixel_format=pkg.PixelFormat.MJPEG)


@pytest.mark.parametrize("kw", [{}, {"resize_to": (32, 24)}, {"filter": "blur_sobel", "overlay": True}],
                         ids=["plain", "resize", "blur_sobel"])
def test_mjpeg_backend_host_matches_the_jax_engine(jax_cpu, monkeypatch, kw):
    monkeypatch.setitem(jax_sim._ENCODERS, jax_core.PixelFormat.MJPEG, sim.encode_mjpeg)
    port = MultiStreamEngine(SimulationDriver(device_count=2, paced=False), 2, _cfg(core),
                             mjpeg_backend="host", device="cpu", **kw)
    ref = JaxEngine(JaxDriver(device_count=2, paced=False), 2, _cfg(jax_core),
                    mjpeg_backend="host", **kw)
    try:
        for i in range(3):
            text = None if i == 0 else ["a", "fi"]
            got, want = port.tick(block=True, text=text), ref.tick(block=True, text=text)
            assert list(got.sequences) == list(want.sequences)
            for key in ("bgr", "filtered"):
                if key in want.outputs:
                    np.testing.assert_array_equal(got.numpy(key), want.numpy(key))
        stats = port.run(3, warmup=1, measure_latency=False)
        assert stats.frames == 6 and stats.host_gather_ms > 0
    finally:
        port.close()
        ref.close()


def test_mjpeg_backend_host_contains_a_corrupt_frame():
    port = MultiStreamEngine(SimulationDriver(device_count=2, paced=False), 2, _cfg(core),
                             mjpeg_backend="host", device="cpu")
    try:
        first = port.tick(block=True).numpy("bgr")
        src = port.sources[1]
        real = src.next_frame

        def corrupt():
            f = real()
            return core.Frame(np.frombuffer(b"\xff\xd8\xff\xe0bad", np.uint8), f.width, f.height,
                              f.pixel_format, f.sequence, f.timestamp)

        src.next_frame = corrupt
        res = port.tick(block=True)
        assert res.sequences[1] == -1 and port.stream_errors[1] == 1
        np.testing.assert_array_equal(res.numpy("bgr")[1], first[1])
    finally:
        port.close()


# -- the host JPEG encoders ----------------------------------------------------------


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 99.0 if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


@pytest.mark.parametrize("quality", [75, 90])
@pytest.mark.parametrize("w,h", [(64, 48), (70, 50)])
def test_imencode_jpeg_host_within_the_encoders_tolerance(jax_cpu, w, h, quality):
    bgr = _smooth(h, w, quality)
    ours = imgcodecs.imencode(".jpg", _mat(bgr), quality)
    assert ours == imgcodecs.imencode(".jpg", _mat(bgr), quality, backend="host")
    assert ours == jpeg_encode.encode_jpeg(torch.from_numpy(bgr), quality)  # a CPU tensor
    theirs = jax_codecs.imencode(".jpg", jax_core.Mat.from_array(bgr), quality)
    assert _psnr(_pillow_reads(ours), bgr) >= _psnr(_pillow_reads(theirs), bgr) - 0.5
    np.testing.assert_array_equal(imgcodecs.imdecode(ours, device="cpu").to_numpy(),
                                  _pillow_reads(ours))


def test_videowriter_default_encoder_round_trip(jax_cpu, tmp_path):
    frames = [_smooth(48, 64, i) for i in range(3)]
    path, ref_path = str(tmp_path / "p.avi"), str(tmp_path / "r.avi")
    with VideoWriter(path, fps=30, frame_size=(64, 48)) as w:
        for f in frames:
            w.write(_mat(f))
    with jax_capture.VideoWriter(ref_path, fps=30, frame_size=(64, 48)) as w:
        for f in frames:
            w.write(f)
    ours = jax_capture.AviMjpegReader(path)
    theirs = jax_capture.AviMjpegReader(ref_path)
    assert len(ours) == len(theirs) == 3
    for i, f in enumerate(frames):
        a, b = ours.frame_bytes(i).tobytes(), theirs.frame_bytes(i).tobytes()
        assert _psnr(_pillow_reads(a), f) >= _psnr(_pillow_reads(b), f) - 0.5
        assert a == jpeg_encode.encode_jpeg(torch.from_numpy(f), 90)
    cap = VideoCapture(path)
    try:
        mat = Mat(device="cpu")
        for i in range(3):
            assert cap.read(mat)
            np.testing.assert_array_equal(mat.to_numpy(),
                                          _pillow_reads(ours.frame_bytes(i).tobytes()))
    finally:
        cap.release()


def test_default_jpeg_encode_runs_where_the_frame_is(monkeypatch, tmp_path):
    """With no backend or encoder named, a JPEG encodes where the frame is:
    a device Mat's or tensor's own tensor goes to the encoder (no host
    copy), a host Mat's pixels go as a CPU tensor (no upload). ``"host"``
    always hands the encoder a CPU copy, ``"tpu"`` the Mat's device tensor.
    Here the device is the CPU, or "meta", where a tensor has no bytes to
    copy to the host."""
    seen = []

    def encode(img, quality=90, subsampling="4:2:0"):
        seen.append(img)
        return b"\xff\xd8\xff\xd9"

    monkeypatch.setattr(jpeg_encode, "encode_jpeg", encode)
    bgr = _smooth(48, 64, 0)
    on_dev = Mat.from_device(torch.from_numpy(bgr.copy()))
    imgcodecs.imencode(".jpg", on_dev)
    assert seen[-1] is on_dev.device()
    imgcodecs.imencode(".jpg", on_dev, backend="tpu")
    assert seen[-1] is on_dev.device()
    imgcodecs.imencode(".jpg", on_dev, backend="host")
    assert seen[-1] is not on_dev.device() and seen[-1].device.type == "cpu"
    assert imgcodecs.imwrite(str(tmp_path / "d.jpg"), on_dev) and seen[-1] is on_dev.device()
    on_host = Mat.from_array(bgr)  # its device is the card, never reached
    imgcodecs.imencode(".jpg", on_host)
    assert seen[-1].device.type == "cpu" and not on_host.is_on_device
    gray = Mat.from_device(torch.from_numpy(bgr[..., 0].copy()))
    imgcodecs.imencode(".jpg", gray)
    assert seen[-1] is gray.device() and seen[-1].ndim == 2

    meta = torch.empty((48, 64, 3), dtype=torch.uint8, device="meta")
    with VideoWriter(str(tmp_path / "m.avi"), frame_size=(64, 48)) as w:
        w.write(meta)
        assert seen[-1] is meta
        w.write(Mat.from_device(meta))
        assert seen[-1] is meta
        w.write(Mat.from_array(bgr))
        assert seen[-1].device.type == "cpu"
    with VideoWriter(str(tmp_path / "h.avi"), frame_size=(64, 48), encoder="host") as w:
        w.write(on_dev)
        assert seen[-1].device.type == "cpu"
        with pytest.raises(NotImplementedError):  # "host" copies the frame to the CPU
            w.write(meta)
    with pytest.raises(ValueError, match="unknown encoder"):
        VideoWriter(str(tmp_path / "x.avi"), encoder="gpu")
