"""The port's ``Camera``, ``VideoCapture``, the MJPEG-AVI file I/O and
``videoio`` against ``rustcv_tpu`` on the CPU.

Both packages read the same simulated frames (raw formats are
byte-identical between the two simulations). Host decodes and
``decode_on_device=True`` decodes (the port on ``device="cpu"``, the
reference on JAX's CPU backend) must give the same bytes for every format
the facade reads. Video files written by one package read in the other;
their hybrid MJPEG decodes agree within ``tests/test_torch_mjpeg.py``'s
tolerance (max |diff| <= 1 on < 0.5 % of bytes).

Every capture is released in a ``finally``, and every ``read`` and
``set_resolution`` runs under a timeout: a hung worker fails its test
instead of holding the suite.
"""

import contextlib
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import rustcv_tpu.capture as jax_capture
import rustcv_tpu.core as jax_core
import rustcv_tpu.videoio as jax_videoio
from rustcv_tpu import native as jax_native
from rustcv_tpu.ops import jpeg_tpu as jax_jpeg
from rustcv_tpu_torch import capture, core, native, videoio
from rustcv_tpu_torch.capture import AviMjpegReader, ModeDescriptor, SimulationDriver, avi
from rustcv_tpu_torch.core import CameraConfig, Mat, PixelFormat, Priority, SimpleConfig
from rustcv_tpu_torch.ops import jpeg_encode, jpeg_tpu
from rustcv_tpu_torch.prelude import Camera, VideoCapture, VideoWriter

torch.set_num_threads(2)

TIMEOUT_S = 60
FACADE_FORMATS = ["YUYV", "UYVY", "NV12", "YV12", "BGRA32", "RGB24", "GRAY8", "BAYER_RGGB"]
CLOSE = (1, 5e-3)  # max |diff|, share of bytes: hybrid decode against the JAX package's

_pool = ThreadPoolExecutor(max_workers=4, thread_name_prefix="facade-test")


def _bounded(fn, *args):
    """``fn(*args)`` on a helper thread, failing the test after TIMEOUT_S."""
    return _pool.submit(fn, *args).result(timeout=TIMEOUT_S)


@contextlib.contextmanager
def _opened(cap_type, *args, **kwargs):
    cap = cap_type(*args, **kwargs)
    try:
        yield cap
    finally:
        cap.release()
        assert not cap._worker.is_alive()


def _drivers(fmt, w=64, h=48):
    """A port and a reference simulation driver with one mode."""
    return (SimulationDriver(paced=False, modes=[ModeDescriptor(PixelFormat[fmt], w, h, (60,))]),
            jax_capture.SimulationDriver(
                paced=False, modes=[jax_capture.ModeDescriptor(jax_core.PixelFormat[fmt], w, h, (60,))]))


def _read_n(cap, n, mat):
    out = []
    for _ in range(n):
        assert _bounded(cap.read, mat)
        out.append(mat.to_numpy())
    return out


def _close(got, want, bound=CLOSE):
    d = np.abs(np.asarray(got).astype(np.int64) - np.asarray(want).astype(np.int64))
    assert d.shape == np.asarray(want).shape
    assert d.max() <= bound[0] and (d > 0).mean() < bound[1], (d.max(), (d > 0).mean())


# -- Camera -------------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["YUYV", "NV12", "BAYER_GBRG"])
def test_camera_matches_the_reference(fmt):
    cfg = SimpleConfig(width=64, height=48, fps=60, pixel_format=PixelFormat[fmt])
    jcfg = jax_core.SimpleConfig(width=64, height=48, fps=60, pixel_format=jax_core.PixelFormat[fmt])
    port = Camera.open_with("sim:0", cfg, SimulationDriver(paced=False))
    ref = jax_capture.Camera.open_with("sim:0", jcfg, jax_capture.SimulationDriver(paced=False))
    with port, ref:
        assert port.resolved_config().width == ref.resolved_config().width == 64
        mat, jmat = Mat(), jax_core.Mat()
        for _ in range(2):
            port.read_decoded(mat)
            ref.read_decoded(jmat)
            np.testing.assert_array_equal(mat.to_numpy(), jmat.to_numpy())
        dev = port.read_decoded_device(device="cpu")
        want = np.asarray(ref.read_decoded_device())
        assert dev.device.type == "cpu"
        np.testing.assert_array_equal(dev.numpy(), want)
        assert port.next_frame().sequence == ref.next_frame().sequence == 3


def test_default_driver_is_the_simulation():
    assert isinstance(capture.default_driver(), SimulationDriver)
    assert capture.default_driver() is capture.default_driver()
    with Camera.open() as cam, \
            jax_capture.Camera.open("sim:0", jax_capture.SimulationDriver()) as ref:
        got, want = cam.resolved_config(), ref.resolved_config()
        assert (got.width, got.height, got.fps, got.pixel_format.value) == (
            want.width, want.height, want.fps, want.pixel_format.value)


# -- VideoCapture ---------------------------------------------------------------


@pytest.mark.parametrize("fmt", FACADE_FORMATS)
def test_videocapture_host_decode_matches_the_reference(fmt):
    """The reference facade's host path converts YUYV, BGRA32, NV12 and
    RGB24 and copies every other format's raw bytes; so does the port's,
    also into a reused Mat whose padded step it keeps."""
    drv, jdrv = _drivers(fmt)
    with _opened(VideoCapture, 0, drv) as cap, _opened(jax_capture.VideoCapture, 0, jdrv) as jcap:
        mat = Mat.new(48, 64, 3, step=64 * 3 + 5, device="cpu")
        got = _read_n(cap, 3, mat)
        want = _read_n(jcap, 3, jax_core.Mat())
        assert mat.step == 197 and not mat.is_on_device
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("fmt", FACADE_FORMATS)
def test_videocapture_device_decode_matches_the_reference(fmt):
    drv, jdrv = _drivers(fmt)
    with _opened(VideoCapture, 0, drv, decode_on_device=True, device="cpu") as cap, \
            _opened(jax_capture.VideoCapture, 0, jdrv, decode_on_device=True) as jcap:
        mat = Mat(device="cpu")
        got = _read_n(cap, 3, mat)
        assert mat.is_on_device and mat.device().device.type == "cpu"
        want = _read_n(jcap, 3, jax_core.Mat())
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_host_and_device_decode_agree_on_yuyv():
    """The pair the card's smoke holds equal: YUYV by the host decode and on
    the device, frame for frame."""
    drv = SimulationDriver(paced=False)
    with _opened(VideoCapture, 0, drv) as host, \
            _opened(VideoCapture, 0, drv, decode_on_device=True, device="cpu") as dev:
        for cap in (host, dev):
            assert _bounded(cap.set_resolution, 160, 120)
        a, b = _read_n(host, 2, Mat(device="cpu")), _read_n(dev, 2, Mat(device="cpu"))
        assert a[0].shape == (120, 160, 3)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_set_resolution_matches_the_reference():
    drv, jdrv = SimulationDriver(paced=False), jax_capture.SimulationDriver(paced=False)
    with _opened(VideoCapture, 0, drv) as cap, _opened(jax_capture.VideoCapture, 0, jdrv) as jcap:
        assert cap.wait_until_resolved() and jcap.wait_until_resolved()
        assert (cap.get_width(), cap.get_height()) == (jcap.get_width(), jcap.get_height())
        for w, h in ((160, 120), (64, 48)):
            assert _bounded(cap.set_resolution, w, h) and _bounded(jcap.set_resolution, w, h)
            assert (cap.get_width(), cap.get_height()) == (w, h) == (jcap.get_width(), jcap.get_height())
            got, want = _read_n(cap, 1, Mat(device="cpu")), _read_n(jcap, 1, jax_core.Mat())
            np.testing.assert_array_equal(got[0], want[0])
        # a resolution no mode has fails the REQUIRED renegotiation in both
        assert not _bounded(cap.set_resolution, 12345, 7)
        assert not _bounded(jcap.set_resolution, 12345, 7)
        assert type(cap.last_error).__name__ == type(jcap.last_error).__name__
        assert not cap.is_opened() and not jcap.is_opened()
        assert not _bounded(cap.read, Mat(device="cpu")) and not _bounded(jcap.read, jax_core.Mat())
        # ...and a later one recovers
        assert _bounded(cap.set_resolution, 64, 48) and cap.is_opened()
        assert _bounded(cap.read, Mat(device="cpu"))


def test_degraded_open_recovers():
    """An open that fails leaves the worker alive: read() is False and a
    later set_resolution recovers, as in the reference."""
    bad = CameraConfig().resolution(12345, 7, Priority.REQUIRED)
    jbad = jax_core.CameraConfig().resolution(12345, 7, jax_core.Priority.REQUIRED)
    drv, jdrv = SimulationDriver(paced=False), jax_capture.SimulationDriver(paced=False)
    with _opened(VideoCapture, 0, drv, bad) as cap, _opened(jax_capture.VideoCapture, 0, jdrv, jbad) as jcap:
        assert not cap.wait_until_resolved() and not jcap.wait_until_resolved()
        assert type(cap.last_error).__name__ == type(jcap.last_error).__name__
        assert cap._worker.is_alive() and cap.get_width() == 0
        assert not _bounded(cap.read, Mat(device="cpu"))
        assert _bounded(cap.set_resolution, 64, 48) and cap.is_opened()
        assert _bounded(cap.read, Mat(device="cpu"))


def test_unknown_device_and_release():
    drv = SimulationDriver(paced=False, device_count=1,
                           modes=[ModeDescriptor(PixelFormat.YUYV, 64, 48, (60,))])
    assert capture.resolve_device_id(0, drv) == "sim:0"
    assert capture.resolve_device_id(5, drv) == "sim:5"
    assert capture.resolve_device_id("sim:3", drv) == "sim:3"
    with _opened(VideoCapture, 5, drv) as cap:
        assert not cap.wait_until_resolved()
        assert isinstance(cap.last_error, core.DeviceNotFound)
    cap = VideoCapture(0, drv)
    try:
        assert _bounded(cap.read, Mat(device="cpu"))
    finally:
        cap.release()
    assert not cap._worker.is_alive() and not cap.read(Mat(device="cpu")) and not cap.set_resolution(64, 48)
    cap.release()  # twice is harmless


def test_device_decode_without_the_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        VideoCapture(0, SimulationDriver(paced=False), decode_on_device=True)
    with pytest.raises(RuntimeError, match="cuda"):
        VideoCapture(0, SimulationDriver(paced=False), device="cuda")


def test_read_decodes_where_the_mat_is(monkeypatch):
    """By default ``read`` decodes on the Mat's device: the host decode for
    a CPU Mat, the card for ``Mat()``, which raises where there is no card.
    ``decode_on_device=False`` takes the host decode into any Mat, and a
    ``device`` named by the caller overrides the Mat's."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    drv = SimulationDriver(paced=False, modes=[ModeDescriptor(PixelFormat.YUYV, 64, 48, (60,))])
    with _opened(VideoCapture, 0, drv) as cap, \
            _opened(VideoCapture, 0, drv, decode_on_device=False) as host, \
            _opened(VideoCapture, 0, drv, device="cpu") as named:
        cpu_mat = Mat(device="cpu")
        got = _read_n(cap, 1, cpu_mat)
        assert not cpu_mat.is_on_device and cpu_mat.target == "cpu"
        card_mat = Mat()
        with pytest.raises(RuntimeError, match="cuda"):
            _bounded(cap.read, card_mat)
        for c in (host, named):
            mat = Mat()
            assert _read_n(c, 1, mat)[0].shape == got[0].shape == (48, 64, 3)
            assert not mat.is_on_device and mat.target == "cuda"


# -- AVI files ----------------------------------------------------------------


def _clip_frames(n, w=64, h=48):
    from rustcv_tpu_torch.capture.simulation import synth_bgr

    return [synth_bgr(w, h, i) for i in range(n)]


@pytest.fixture(scope="module")
def coders():
    assert native.available(), native.build_error()
    if not jax_native.available():
        pytest.skip(f"the reference's native library is unavailable: {jax_native.build_error()}")


def test_avi_round_trip(tmp_path, coders):
    """VideoWriter → AviMjpegReader → VideoCapture(path): the frame count,
    the container, and each frame's pixels against the hybrid decode of
    the same bytes; the reference reads the port's file and its decode
    agrees within tolerance."""
    path = str(tmp_path / "clip.avi")
    frames = _clip_frames(5)
    with VideoWriter(path, fps=25, frame_size=(64, 48), quality=85, device="cpu") as w:
        w.write(Mat.from_array(frames[0], device="cpu"))
        w.write(frames[1])
        w.write(torch.from_numpy(frames[2]))
        w.write(Mat.from_device(torch.from_numpy(frames[3])))
        w.write(Mat.from_array(frames[4], device="cpu"))
        assert w.frame_count == 5 and w.is_opened()
    assert not w.is_opened()
    reader, jreader = AviMjpegReader(path), jax_capture.AviMjpegReader(path)
    assert (len(reader), reader.width, reader.height, reader.fps, reader.declared_frames) == (
        len(jreader), jreader.width, jreader.height, jreader.fps, jreader.declared_frames) == (
        5, 64, 48, 25.0, 5)
    for i, f in enumerate(frames):
        data = reader.frame_bytes(i)
        assert data.tobytes() == jreader.frame_bytes(i).tobytes()
        assert data.tobytes() == jpeg_encode.encode_jpeg(torch.from_numpy(f), quality=85)
    assert avi.is_video_file(path) and not avi.is_video_file(str(tmp_path / "no.avi"))

    with _opened(VideoCapture, path, decode_on_device=True, mjpeg_hybrid=True, device="cpu") as cap, \
            _opened(jax_capture.VideoCapture, path, decode_on_device=True, mjpeg_hybrid=True) as jcap:
        assert cap.wait_until_resolved() and (cap.get_width(), cap.get_height()) == (64, 48)
        mat, jmat = Mat(device="cpu"), jax_core.Mat()
        for i in range(5):
            assert _bounded(cap.read, mat) and _bounded(jcap.read, jmat)
            want = jpeg_tpu.decode_jpeg_tpu(reader.frame_bytes(i), "cpu").numpy()
            np.testing.assert_array_equal(mat.to_numpy(), want)
            _close(mat.to_numpy(), jmat.to_numpy())
        assert not _bounded(cap.read, mat) and not _bounded(jcap.read, jmat)  # end of video
        assert cap.last_error is None


def test_port_reads_a_reference_written_file(tmp_path, coders):
    path = str(tmp_path / "ref.avi")
    frames = _clip_frames(3, 160, 120)
    with jax_capture.VideoWriter(path, fps=30, frame_size=(160, 120), encoder="tpu") as w:
        for f in frames:
            w.write(f)
    reader = AviMjpegReader(path)
    assert (len(reader), reader.width, reader.height) == (3, 160, 120)
    src = capture.FileDriver(loop=True).open(path, CameraConfig())[0]
    src.start()
    seen = [src.next_frame() for _ in range(4)]
    assert [f.sequence for f in seen] == [0, 1, 2, 3] and src.position == 1  # looped
    for i in range(3):
        got = jpeg_tpu.decode_jpeg_tpu(reader.frame_bytes(i), "cpu").numpy()
        _close(got, np.asarray(jax_jpeg.decode_jpeg_tpu(reader.frame_bytes(i))))


def test_writer_rejects_as_the_reference(tmp_path):
    with pytest.raises(core.CameraError):
        VideoWriter(str(tmp_path / "a.avi"), fourcc="XVID", device="cpu")
    with pytest.raises(core.CameraError):
        VideoWriter(str(tmp_path / "b.avi"), fps=0, device="cpu")
    with VideoWriter(str(tmp_path / "c.avi"), frame_size=(64, 48), device="cpu") as w:
        with pytest.raises(core.CameraError):
            w.write(np.zeros((48, 32, 3), np.uint8))
    with pytest.raises(core.CameraError):
        w.write_encoded(b"\xff\xd8")
    with pytest.raises(core.DeviceNotFound):
        AviMjpegReader(str(tmp_path / "missing.avi"))
    (tmp_path / "bad.avi").write_bytes(b"RIFX0000AVI ")
    with pytest.raises(core.DecodeError):
        AviMjpegReader(str(tmp_path / "bad.avi"))


def test_mjpeg_decodes_that_are_not_ported(tmp_path, coders):
    """Ported now: the host decode of MJPEG, and the device decode without
    the hybrid path (the host decode, uploaded), both the reference's host
    decode; and ``VideoWriter(encoder="host")``, which is what the default
    does with a host frame."""
    from rustcv_tpu.ops.decode import decode_mjpeg_host_rgb

    path = str(tmp_path / "clip.avi")
    with VideoWriter(path, frame_size=(64, 48), device="cpu") as w:
        w.write(_clip_frames(1)[0])
    want = decode_mjpeg_host_rgb(AviMjpegReader(path).frame_bytes(0))[..., ::-1]
    for kwargs in ({}, {"decode_on_device": True, "device": "cpu"}):
        with _opened(VideoCapture, path, **kwargs) as cap:
            mat = Mat(device="cpu")
            assert _bounded(cap.read, mat)
            np.testing.assert_array_equal(mat.to_numpy(), want)
    with VideoWriter(str(tmp_path / "h.avi"), frame_size=(64, 48), encoder="host") as w:
        w.write(_clip_frames(1)[0])
    assert (tmp_path / "h.avi").read_bytes() == (tmp_path / "clip.avi").read_bytes()


# -- videoio --------------------------------------------------------------------


def test_create_driver():
    assert isinstance(videoio.create_driver("simulation", paced=False), SimulationDriver)
    assert isinstance(videoio.create_driver("file"), capture.FileDriver)
    from rustcv_tpu.capture.v4l2 import V4L2Driver as JaxV4L2Driver
    from rustcv_tpu_torch.capture.v4l2 import V4L2Driver, list_video_devices

    if not list_video_devices():
        assert videoio.default_backend() == jax_videoio.default_backend() == "simulation"
    assert isinstance(videoio.create_driver("v4l2"), V4L2Driver)
    assert isinstance(jax_videoio.create_driver("v4l2"), JaxV4L2Driver)
    for mod in (videoio, jax_videoio):  # the native ring's devices are the simulation's
        assert type(mod.create_driver("native", paced=False)).__name__ == "SimulationDriver"
    for mod in (videoio, jax_videoio):
        with pytest.raises(ValueError):
            mod.create_driver("gstreamer")
    assert set(videoio.__all__) == set(jax_videoio.__all__)
    assert os.path.basename(videoio.__file__) == "videoio.py"
