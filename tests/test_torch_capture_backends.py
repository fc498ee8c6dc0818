"""The port's capture backends without a camera: the V4L2 driver
(``rustcv_tpu_torch.capture.v4l2``: discovery, ``DeviceNotFound`` for a
missing node, a node that is no capture device rejected, the factory and
the default driver's probe) and the native frame ring
(``native.NativeRing`` and ``capture.native_source``: free-run sequencing,
drops under a stalled consumer, the frame-source contract), ported from
``tests/test_v4l2.py`` and ``tests/test_native.py``. The ring's frames are
held byte-equal to the port's ``synth_raw``, to the reference's
``rustcv_tpu.capture.simulation.synth_raw`` and to the reference's own
native generator for the same sequence numbers. Only live capture needs a
camera, and skips without one."""

import glob
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import rustcv_tpu.videoio as jax_videoio
from rustcv_tpu import native as jax_native
from rustcv_tpu.capture import simulation as jax_sim
from rustcv_tpu.core import PixelFormat as JaxPixelFormat
from rustcv_tpu_torch import native, videoio
from rustcv_tpu_torch.capture import Camera, SimulationDriver, camera
from rustcv_tpu_torch.capture import v4l2 as port_v4l2
from rustcv_tpu_torch.capture.native_source import NativeSimulationSource
from rustcv_tpu_torch.capture.simulation import synth_raw
from rustcv_tpu_torch.core import (CameraConfig, CameraError, DeviceNotFound, Mat, PixelFormat,
                                   ResolvedConfig, SimpleConfig, SimulationError)
from rustcv_tpu_torch.ops import decode

torch.set_num_threads(2)

W, H = 64, 48


def _yuyv(seq, w=W, h=H):
    return synth_raw(w, h, PixelFormat.YUYV, seq)


# -- V4L2 -----------------------------------------------------------------------


def test_the_library_builds_with_the_v4l2_driver_or_its_stub():
    assert native.available(), native.build_error()
    assert native.v4l2_available() in (True, False)
    if glob.glob("/usr/include/linux/videodev2.h"):
        assert native.v4l2_available()


def test_factory_and_discovery():
    drv = videoio.create_driver("v4l2")
    assert isinstance(drv, port_v4l2.V4L2Driver)
    assert isinstance(videoio.create_driver("native", paced=False), SimulationDriver)
    devs = drv.list_devices()
    assert isinstance(devs, list)
    if not port_v4l2.list_video_devices():
        assert devs == [] and videoio.default_backend() == "simulation"
        assert jax_videoio.default_backend() == "simulation"
    assert port_v4l2.list_video_devices() == sorted(glob.glob("/dev/video*"))


def test_missing_device_raises_device_not_found():
    with pytest.raises(DeviceNotFound):
        port_v4l2.enumerate_modes("/dev/video255")
    with pytest.raises(CameraError):
        port_v4l2.V4L2Driver().open("/dev/video255", CameraConfig())
    with pytest.raises(CameraError):
        port_v4l2.V4L2Driver().open_simple("/dev/video255", SimpleConfig())


def test_non_video_node_rejected():
    """/dev/null opens but fails QUERYCAP: a clean CameraError."""
    with pytest.raises(CameraError):
        port_v4l2.enumerate_modes("/dev/null")


def test_controls_trigger_unsupported():
    ctl = port_v4l2._V4L2Controls(None)  # set_trigger never touches the source
    with pytest.raises(SimulationError):
        ctl.set_trigger(None)


def test_controls_of_a_closed_source_raise():
    class Closed:  # a closed source's handle is None; the C call is never made
        _h = None
        _lib = SimpleNamespace(rcv_v4l2_set_ctrl=lambda *args: 0)

    with pytest.raises(CameraError, match="closed"):
        port_v4l2._V4L2Controls(Closed()).set_gain(2.0)


@pytest.fixture()
def fresh_default(monkeypatch):
    monkeypatch.setattr(camera, "_DEFAULT_DRIVER", None)


def test_default_driver_probe(monkeypatch, fresh_default):
    """No node: simulation, with nothing built. A node that is no capture
    device: skipped, simulation again."""
    monkeypatch.setattr(port_v4l2, "list_video_devices", lambda: [])
    assert isinstance(camera.default_driver(), SimulationDriver)
    monkeypatch.setattr(camera, "_DEFAULT_DRIVER", None)
    monkeypatch.setattr(port_v4l2, "list_video_devices", lambda: ["/dev/null", "/dev/video255"])
    assert isinstance(camera.default_driver(), SimulationDriver)
    assert videoio.default_backend() == "simulation"


def test_default_driver_raises_a_build_error(monkeypatch, fresh_default):
    """Unlike the reference, which falls back to simulation on any error,
    a native library that does not build raises."""
    def broken():
        raise RuntimeError("native library unavailable: g++ failed")

    monkeypatch.setattr(port_v4l2, "list_video_devices", lambda: ["/dev/video0"])
    monkeypatch.setattr(native, "v4l2_available", broken)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        camera.default_driver()


def test_a_stub_build_is_a_camera_error(monkeypatch):
    monkeypatch.setattr(native, "v4l2_available", lambda: False)
    with pytest.raises(CameraError, match="videodev2"):
        port_v4l2.enumerate_modes("/dev/video0")


def test_compact_rows_of_a_padded_stride():
    """Padded packed rows are compacted (one copy), exact rows stay a view,
    padded planar frames are refused."""
    src = object.__new__(port_v4l2.V4L2Source)
    src._path = "/dev/video0"
    src._cfg = ResolvedConfig(6, 4, 30, PixelFormat.YUYV, 4)
    src._stride = 16
    padded = np.arange(16 * 4, dtype=np.uint8)
    np.testing.assert_array_equal(src._compact_rows(padded),
                                  padded.reshape(4, 16)[:, :12].reshape(-1))
    exact = np.arange(12 * 4, dtype=np.uint8)
    assert src._compact_rows(exact) is exact
    with pytest.raises(CameraError, match="inconsistent"):
        src._compact_rows(np.zeros(50, np.uint8))
    src._cfg = ResolvedConfig(6, 4, 30, PixelFormat.NV12, 4)
    with pytest.raises(CameraError, match="planar"):
        src._compact_rows(np.zeros(16 * 6, np.uint8))


@pytest.mark.skipif(not glob.glob("/dev/video*"), reason="no V4L2 camera on this host")
def test_live_capture_zero_copy():
    drv = port_v4l2.V4L2Driver()
    devs = drv.list_devices()
    if not devs:
        pytest.skip("video nodes exist but none are capture devices")
    src, _ = drv.open_simple(devs[0].id, SimpleConfig(width=640, height=480))
    try:
        f1 = src.next_frame()
        assert f1.data.size > 0
        f2 = src.next_frame()
        assert f2.sequence >= f1.sequence
        with pytest.raises(RuntimeError):
            _ = f1.data  # use after requeue
    finally:
        src.close()


# -- the native ring --------------------------------------------------------------


def test_ring_free_run_sequenced():
    ring = native.NativeRing(4, W, H)
    ring.start(fps=1000, paced=False)
    try:
        seqs = []
        for _ in range(5):
            res = ring.dequeue()
            assert res is not None
            slot, view, seq, _ts = res
            seqs.append(seq)
            np.testing.assert_array_equal(view, _yuyv(seq))
            ring.requeue(slot)
        assert seqs == sorted(seqs) and len(set(seqs)) == 5
    finally:
        ring.stop()
        ring.close()
    ring.close()  # idempotent


@pytest.mark.parametrize("w,h,seq", [(64, 48, 0), (160, 120, 42), (130, 54, 999)])
def test_ring_pattern_is_the_references(w, h, seq):
    """The port's frame for a sequence number is the reference's: its numpy
    generator and its own C++ generator (the port keeps the latter
    internal to the ring)."""
    want = jax_sim.synth_raw(w, h, JaxPixelFormat.YUYV, seq)
    np.testing.assert_array_equal(synth_raw(w, h, PixelFormat.YUYV, seq), want)
    np.testing.assert_array_equal(jax_native.synth_yuyv(w, h, seq), want)


def test_ring_frames_equal_the_references_ring():
    """Both rings free-run; every frame each dequeues equals the other
    package's generator for its sequence number."""
    ours, theirs = native.NativeRing(3, W, H), jax_native.NativeRing(3, W, H)
    for ring in (ours, theirs):
        ring.start(fps=1000, paced=False)
    try:
        for _ in range(3):
            for ring, gen in ((ours, lambda s: jax_native.synth_yuyv(W, H, s)),
                              (theirs, _yuyv)):
                slot, view, seq, _ = ring.dequeue()
                np.testing.assert_array_equal(view, gen(seq))
                ring.requeue(slot)
    finally:
        ours.close()
        theirs.close()


def test_ring_drops_when_the_consumer_stalls():
    ring = native.NativeRing(2, W, H)
    ring.start(fps=500, paced=True)
    try:
        assert ring.dequeue() is not None
        time.sleep(0.1)  # hold the slot: one free slot for ~50 frames
        assert ring.dropped > 0
        with pytest.raises(RuntimeError, match="already running"):
            ring.start(fps=500)
    finally:
        ring.close()


def test_ring_dequeue_times_out_when_stopped():
    ring = native.NativeRing(2, W, H)
    try:
        assert ring.dequeue(timeout_ms=20) is None  # never started
    finally:
        ring.close()


def _source(paced=False, fmt=PixelFormat.YUYV, buffers=4):
    return NativeSimulationSource(ResolvedConfig(W, H, 120, fmt, buffers), paced=paced)


def test_native_source_frame_source_contract():
    src = _source()
    with pytest.raises(CameraError):  # StreamNotStarted
        src.next_frame()
    src.start()
    try:
        f0 = src.next_frame()
        s0 = f0.sequence
        np.testing.assert_array_equal(f0.data, _yuyv(s0))
        owned = f0.to_owned()
        f1 = src.next_frame()
        assert f1.sequence > s0
        with pytest.raises(RuntimeError):
            _ = f0.data  # slot requeued: the view is invalid
        np.testing.assert_array_equal(owned.data, _yuyv(s0))
        tel = src.telemetry()
        assert tel.link_throughput_mbps > 0 and tel.dropped_frames >= 0
        assert src.resolved_config().width == W
    finally:
        src.close()
    with pytest.raises(RuntimeError):
        _ = f1.data  # stop invalidates the last frame


def test_native_source_drops_show_in_telemetry():
    src = _source(paced=True, buffers=2)
    src.start()
    try:
        src.next_frame()
        time.sleep(0.1)  # 120 fps: ~12 frames while both slots are held
        assert src.telemetry().dropped_frames > 0
        f = src.next_frame()
        np.testing.assert_array_equal(f.data, _yuyv(f.sequence))
    finally:
        src.close()


def test_native_source_is_yuyv_only():
    with pytest.raises(SimulationError, match="YUYV"):
        _source(fmt=PixelFormat.NV12)


def test_native_source_behind_a_camera():
    """``Camera`` over the ring: the host decode into a Mat and the device
    decode (CPU tensors here) of the same frames as the reference decode."""
    src = _source()
    cam = Camera(src, None)
    try:
        mat = Mat(device="cpu")
        for _ in range(3):
            cam.read_decoded(mat)
            seq = src._prev_frame.sequence
            want = decode.convert_on_device(torch.from_numpy(_yuyv(seq)), PixelFormat.YUYV, W, H)
            np.testing.assert_array_equal(mat.to_numpy(), want.numpy())
            got = cam.read_decoded_device("cpu")
            seq = src._prev_frame.sequence
            want = decode.convert_on_device(torch.from_numpy(_yuyv(seq)), PixelFormat.YUYV, W, H)
            assert torch.equal(got, want)
    finally:
        cam.close()
        src.close()
