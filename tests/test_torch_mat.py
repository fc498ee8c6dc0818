"""The port's ``Mat``, ``TickMeter`` and ``Frame.decode_bgr`` against
``rustcv_tpu.core`` on the CPU.

A Mat's host side is the reference's (a padded ``step``, ``ensure_size``,
``data``/``array``); its device twin is a torch tensor, here on the CPU
(``device="cpu"``), and must invalidate like the reference's JAX twin.
``Frame.decode_bgr`` runs the port's converters on a CPU tensor and must
give the reference's golden bytes for every raw format, bit for bit."""

import time

import numpy as np
import pytest
import torch

import rustcv_tpu.core as jax_core
from rustcv_tpu_torch import core
from rustcv_tpu_torch.capture.simulation import synth_bgr, synth_raw
from rustcv_tpu_torch.core import DecodeError, Mat, PixelFormat, TickMeter

torch.set_num_threads(2)

RAW_FORMATS = ["YUYV", "UYVY", "NV12", "YV12", "BGR24", "RGB24", "BGRA32", "RGBA32",
               "GRAY8", "BAYER_BGGR", "BAYER_GBRG", "BAYER_GRBG", "BAYER_RGGB"]
ROW_LOCAL = ["YUYV", "UYVY", "BGR24", "RGB24", "BGRA32", "RGBA32", "GRAY8"]


def _img(h, w, c=3, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (h, w, c), dtype=np.uint8)


def _state(m):
    return (m.rows, m.cols, m.channels, m.step, m.row_bytes, m.total(), m.shape,
            m.is_empty(), m.is_on_device)


@pytest.mark.parametrize("make", [
    lambda M: M.empty(), lambda M: M.new(4, 5), lambda M: M.new(4, 5, 3, step=20),
    lambda M: M.zeros(3, 7, 1), lambda M: M.from_array(_img(6, 5)),
    lambda M: M.from_array(_img(6, 5)[..., 0]), lambda M: M(2, 3, 4),
], ids=["empty", "new", "padded", "zeros_gray", "from_array", "from_array_hw", "rgba"])
def test_constructors_match_the_reference(make):
    got, want = make(Mat), make(jax_core.Mat)
    assert _state(got) == _state(want) and repr(got) == repr(want)
    assert np.array_equal(got.data, want.data) and np.array_equal(got.to_numpy(), want.to_numpy())


def test_bad_inputs_raise_as_in_the_reference():
    for M in (Mat, jax_core.Mat):
        with pytest.raises(ValueError):
            M(2, 3, 3, step=8)
        with pytest.raises(TypeError):
            M.from_array(np.zeros((2, 2, 3), np.float32))


def test_padded_step_writes_stay_in_the_pixels():
    """Writes through ``array`` land in the strided buffer; the bytes past
    ``row_bytes`` do not move, as in the reference."""
    got, want = Mat.new(4, 5, 3, step=20), jax_core.Mat.new(4, 5, 3, step=20)
    for m in (got, want):
        m.data[:, 15:] = 7  # padding
        m.array[:] = _img(4, 5, seed=1)
        m.array[1, 2] = (1, 2, 3)
    assert np.array_equal(got.data, want.data)
    assert (got.data[:, 15:] == 7).all() and got.array.strides == (20, 3, 1)
    assert np.array_equal(got.to_numpy(), want.to_numpy())


def test_ensure_size_reallocates_only_on_change():
    for M in (Mat, jax_core.Mat):
        m = M.new(4, 5, 3, step=20)
        buf = m.data
        m.ensure_size(4, 5, 3)
        assert m.data is buf and m.step == 20
        m.ensure_size(6, 5, 3)
        assert m.data is not buf and m.step == 15 and m.data.shape == (6, 15)
        m.ensure_size(6, 5, 1)
        assert m.step == 5 and m.shape == (6, 5, 1)


def test_twins_and_their_invalidation():
    a = _img(6, 5, seed=2)
    m = Mat.from_array(a, device="cpu")
    assert not m.is_on_device and m.target == "cpu"
    t = m.device()
    assert m.is_on_device and t.dtype == torch.uint8 and t.device.type == "cpu"
    assert np.array_equal(t.numpy(), a) and m.device() is t
    # writing through ``array`` drops the device twin; device() uploads anew
    m.array[0, 0] = (9, 9, 9)
    assert not m.is_on_device
    assert m.device()[0, 0].tolist() == [9, 9, 9]
    # ``data`` drops it too
    m.data
    assert not m.is_on_device
    # set_device drops the host twin; ``data`` then reads the tensor's bytes
    b = torch.from_numpy(_img(3, 4, seed=3))
    m.set_device(b)
    assert m.is_on_device and m.shape == (3, 4, 3) and m.step == 12
    assert repr(m) == "Mat(3x4x3, step=12, device)"
    assert np.array_equal(m.to_numpy(), b.numpy()) and np.array_equal(m.data.reshape(3, 4, 3), b.numpy())
    assert not m.is_on_device


def test_to_numpy_and_data_never_alias_a_cpu_tensor():
    t = torch.from_numpy(_img(3, 4, seed=4))
    m = Mat.from_device(t)
    m.to_numpy()[:] = 0
    m.array[:] = 0
    assert t.sum() > 0


def test_from_device_wraps_without_a_copy():
    t = torch.from_numpy(_img(3, 4, seed=5))
    m = Mat.from_device(t)
    assert m.device() is t and m.shape == (3, 4, 3) and m.target == t.device
    g = Mat.from_device(t[..., 0])
    assert g.shape == (3, 4, 1) and g.step == 4


def test_copy_is_independent():
    m = Mat.new(3, 4, 3, step=16, device="cpu")
    m.array[:] = _img(3, 4, seed=6)
    c = m.copy()
    assert (c.step, c.target) == (16, "cpu") and np.array_equal(c.data, m.data)
    c.array[:] = 0
    assert m.to_numpy().sum() > 0
    d = Mat.from_device(torch.from_numpy(_img(3, 4, seed=7)))
    e = d.copy()
    e.device().zero_()
    assert d.device().sum() > 0
    assert Mat.empty().copy().is_empty()


def test_the_card_asked_for_without_one_raises(monkeypatch):
    """No silent CPU fallback: a Mat whose device is the card raises on
    upload where torch has no CUDA device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m = Mat.from_array(_img(2, 2))
    assert m.target == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        m.device()
    assert not m.is_on_device


def test_tick_meter_matches_the_reference(monkeypatch):
    clock = iter(np.arange(0.0, 100.0, 0.25).tolist())
    monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
    got, want = TickMeter(), jax_core.TickMeter()
    probes = ("get_counter", "get_time_sec", "get_time_milli", "get_time_micro", "get_fps",
              "get_avg_time_milli")
    for step in ("probe", "stop", "start", "stop", "probe", "start", "stop", "start", "probe",
                 "stop", "probe", "reset", "probe", "start", "stop", "probe"):
        if step == "probe":
            assert [getattr(got, p)() for p in probes] == [getattr(want, p)() for p in probes]
        else:
            getattr(got, step)()
            getattr(want, step)()
    assert got.get_counter() == 1 and got.get_avg_time_milli() == 500.0  # the meters share the clock


def _frames(fmt, w, h, seq, bottom_up=False):
    """The same frame bytes as a port Frame and a reference Frame."""
    pf = PixelFormat[fmt]
    if pf == PixelFormat.RGBA32:  # the simulation sends no RGBA; make it by hand
        bgr = synth_bgr(w, h, seq)
        data = np.concatenate([bgr[..., ::-1], np.full((h, w, 1), 200, np.uint8)], -1).reshape(-1)
    else:
        data = synth_raw(w, h, pf, seq)
    ts = core.Timestamp(seq, 0.0)
    port = core.Frame(data, w, h, pf, seq, ts, bottom_up=bottom_up)
    ref = jax_core.Frame(data, w, h, jax_core.PixelFormat[fmt], seq,
                         jax_core.Timestamp(seq, 0.0), bottom_up=bottom_up)
    return port, ref


@pytest.mark.parametrize("w,h", [(64, 48), (160, 120)])
@pytest.mark.parametrize("fmt", RAW_FORMATS)
def test_decode_bgr_matches_the_reference(fmt, w, h):
    port, ref = _frames(fmt, w, h, seq=w + 3)
    got, want = port.decode_bgr(), ref.decode_bgr()
    assert isinstance(got, Mat) and not got.is_on_device
    assert got.shape == want.shape == (h, w, 3)
    np.testing.assert_array_equal(got.to_numpy(), want.to_numpy())


@pytest.mark.parametrize("fmt", ROW_LOCAL)
def test_decode_bottom_up_matches_the_reference(fmt):
    port, ref = _frames(fmt, 64, 48, seq=5, bottom_up=True)
    np.testing.assert_array_equal(port.decode_bgr().to_numpy(), ref.decode_bgr().to_numpy())


@pytest.mark.parametrize("fmt", ["NV12", "YV12", "BAYER_GRBG"])
def test_decode_bottom_up_planar_raises_as_in_the_reference(fmt):
    port, ref = _frames(fmt, 64, 48, seq=5, bottom_up=True)
    with pytest.raises(DecodeError):
        port.decode_bgr()
    with pytest.raises(jax_core.DecodeError):
        ref.decode_bgr()


def test_host_decode_into_a_padded_mat():
    """decode_frame_host writes through the Mat's strided view: a padded Mat
    of the frame's size keeps its step and its padding."""
    from rustcv_tpu_torch.ops.decode import decode_frame_host

    port, ref = _frames("YUYV", 64, 48, seq=9)
    mat = Mat.new(48, 64, 3, step=64 * 3 + 13)
    mat.data[:, 192:] = 5
    decode_frame_host(port, mat)
    assert mat.step == 205 and (mat.data[:, 192:] == 5).all()
    np.testing.assert_array_equal(mat.to_numpy(), ref.decode_bgr().to_numpy())


def test_decode_to_device_matches_the_host_decode():
    from rustcv_tpu_torch.ops.decode import decode_to_device

    for fmt in RAW_FORMATS:
        port, _ = _frames(fmt, 64, 48, seq=11)
        out = decode_to_device(port, "cpu")
        assert out.shape == (48, 64, 3) and out.dtype == torch.uint8
        np.testing.assert_array_equal(out.numpy(), port.decode_bgr().to_numpy())
    up, _ = _frames("BGRA32", 64, 48, seq=11, bottom_up=True)
    np.testing.assert_array_equal(decode_to_device(up, "cpu").numpy(), up.decode_bgr().to_numpy())


def test_mjpeg_host_decode_is_not_ported():
    """The host decode of MJPEG is ported now: ``decode_bgr`` and the
    non-hybrid ``decode_to_device`` give the reference's host decode
    (libjpeg-turbo's, through Pillow) of the same bytes."""
    from rustcv_tpu.ops.decode import decode_mjpeg_host_rgb
    from rustcv_tpu_torch.ops.decode import decode_to_device

    raw = synth_raw(64, 48, PixelFormat.MJPEG, 0)
    port = core.Frame(raw, 64, 48, PixelFormat.MJPEG, 0, core.Timestamp(0, 0.0))
    want = decode_mjpeg_host_rgb(raw)[..., ::-1]
    np.testing.assert_array_equal(port.decode_bgr().to_numpy(), want)
    np.testing.assert_array_equal(decode_to_device(port, "cpu").numpy(), want)
    assert decode_to_device(port, "cpu", mjpeg_hybrid=True).shape == (48, 64, 3)
