"""The port's engine against the JAX engine, tick for tick and bit-exact,
for every wire format it stages: host-staged for every format the
simulation encodes, device-sim for those both packages synthesize on the
device (with and without the frame pool), with and without the filter and
overlay, at a width on and off a multiple of 4, resized, in every decode
mode, and across the two packages' state snapshots. Each output has the
reference's layout: packed rows (N, H, W*3) or (N, H, W, 3)."""

import numpy as np
import pytest
import torch

import rustcv_tpu.core as jax_core
import rustcv_tpu.runtime.pipeline as jax_pipeline
from rustcv_tpu.capture import SimulationDriver as JaxDriver
from rustcv_tpu.capture.source import ModeDescriptor as JaxModeDescriptor
from rustcv_tpu.runtime import MultiStreamEngine as JaxEngine
from rustcv_tpu_torch.capture import ModeDescriptor, SimulationDriver
from rustcv_tpu_torch.capture import simulation as sim
from rustcv_tpu_torch.core import PixelFormat, SimpleConfig, SimulationError
from rustcv_tpu_torch.ops import kernels
from rustcv_tpu_torch.runtime import MultiStreamEngine
from rustcv_tpu_torch.runtime import pipeline as port_pipeline

torch.set_num_threads(2)

OUTPUTS = ("bgr", "filtered")
HOST_FORMATS = [f for f in sim._ENCODERS if f != PixelFormat.MJPEG]
SIM_FORMATS = [PixelFormat.NV12, PixelFormat.BGRA32, PixelFormat.RGB24, PixelFormat.BGR24]
SIZES = [(64, 48), (66, 50)]  # width on and off a multiple of 4
STAGES = {"none": dict(filter="none"), "blur_sobel": dict(filter="blur_sobel", overlay=True)}


def _jfmt(fmt):
    return jax_core.PixelFormat(fmt.value)


def _port(fmt, w, h, n=2, n_unique=0, device_sim=False, **kw):
    driver = SimulationDriver(device_count=n, paced=False, n_unique_frames=n_unique,
                              modes=[ModeDescriptor(fmt, w, h, (60,))])
    return MultiStreamEngine(driver, n, SimpleConfig(width=w, height=h, fps=60, pixel_format=fmt),
                             device_sim=device_sim, device="cpu", **kw)


def _jax(fmt, w, h, n=2, n_unique=0, device_sim=False, **kw):
    driver = JaxDriver(device_count=n, paced=False, n_unique_frames=n_unique,
                       modes=[JaxModeDescriptor(_jfmt(fmt), w, h, (60,))])
    cfg = jax_core.SimpleConfig(width=w, height=h, fps=60, pixel_format=_jfmt(fmt))
    return JaxEngine(driver, n, cfg, device_sim=device_sim, **kw)


def _overlay(n, seed=0):
    rng = np.random.default_rng(seed)
    rects = np.stack([rng.integers(-10, 40, n), rng.integers(-10, 30, n),
                      rng.integers(0, 60, n), rng.integers(0, 50, n)], 1).astype(np.int32)
    return rects, rng.integers(0, 256, (n, 3), np.uint8)


def _ticks(eng, k, rects=None, colors=None):
    """k ticks: each output's raw layout and values, and the sequences."""
    out = []
    for _ in range(k):
        res = eng.tick(rects=rects, rect_colors=colors, block=True)
        out.append({key: np.asarray(res.outputs[key]) for key in OUTPUTS if key in res.outputs}
                   | {"seqs": np.asarray(res.sequences)})
    return out


def _assert_same(port_ticks, jax_ticks):
    assert len(port_ticks) == len(jax_ticks)
    for i, (p, j) in enumerate(zip(port_ticks, jax_ticks)):
        assert set(p) == set(j)
        for key in j:
            assert p[key].shape == j[key].shape, (i, key, p[key].shape, j[key].shape)
            np.testing.assert_array_equal(p[key], j[key], err_msg=f"tick {i} {key}")


def _set_mode(monkeypatch, mode):
    if mode is None:
        monkeypatch.delenv("RUSTCV_DECODE", raising=False)
    else:
        monkeypatch.setenv("RUSTCV_DECODE", mode)
    jax_pipeline.get_pipeline.cache_clear()


def _compare(monkeypatch, fmt, w, h, ticks=2, mode=None, **kw):
    _set_mode(monkeypatch, mode)
    rects, colors = _overlay(kw.get("n", 2), seed=w + h)
    port = _ticks(_port(fmt, w, h, **kw), ticks, rects, colors)
    _assert_same(port, _ticks(_jax(fmt, w, h, **kw), ticks, rects, colors))
    return port


@pytest.mark.parametrize("stage", list(STAGES))
@pytest.mark.parametrize("w,h", SIZES)
@pytest.mark.parametrize("fmt", HOST_FORMATS, ids=lambda f: f.value)
def test_host_staged_format_matches_jax(jax_cpu, monkeypatch, fmt, w, h, stage):
    port = _compare(monkeypatch, fmt, w, h, **STAGES[stage])
    spec = port_pipeline.PipelineSpec(fmt, w, h)
    want = (2, h, w * 3) if port_pipeline.packed_output(spec) else (2, h, w, 3)
    assert port[0]["bgr"].shape == want


@pytest.mark.parametrize("stage", list(STAGES))
@pytest.mark.parametrize("w,h", SIZES)
@pytest.mark.parametrize("fmt", SIM_FORMATS, ids=lambda f: f.value)
def test_device_sim_format_matches_jax(jax_cpu, monkeypatch, fmt, w, h, stage):
    _compare(monkeypatch, fmt, w, h, ticks=3, device_sim=True, **STAGES[stage])


@pytest.mark.parametrize("w,h", SIZES)
@pytest.mark.parametrize("fmt", SIM_FORMATS, ids=lambda f: f.value)
def test_device_sim_frame_pool_matches_jax(jax_cpu, monkeypatch, fmt, w, h):
    _compare(monkeypatch, fmt, w, h, ticks=4, device_sim=True, n_unique=3,
             filter="blur_sobel", overlay=True)


MODE_CASES = ([(f, False, 0) for f in HOST_FORMATS]
              + [(f, True, k) for f in SIM_FORMATS + [PixelFormat.YUYV] for k in (0, 3)])
YUYV_KERNELS = ("yuyv_decode_interleave", "yuyv_tick_fused")


@pytest.mark.parametrize("mode", ["pallas", "pallas_tick"])
@pytest.mark.parametrize("fmt,device_sim,n_unique", MODE_CASES,
                         ids=[f"{f.value}-{'sim' if d else 'host'}{'-pool' if k else ''}"
                              for f, d, k in MODE_CASES])
def test_other_formats_take_the_plain_decode_in_kernel_modes(jax_cpu, monkeypatch, mode, fmt,
                                                             device_sim, n_unique):
    """K4 and K5 read YUYV only: under pallas (K4's mode) and pallas_tick
    (K5's), with blur_sobel, every other format calls neither and takes the
    plain decode and the stencil (K1's route), as in the reference; its
    ticks equal the JAX engine's in that mode and the port's default mode's.
    YUYV, the control, calls the mode's kernel each tick."""
    calls = []
    for name in YUYV_KERNELS:
        real = getattr(kernels, name)

        def spy(*args, _name=name, _real=real, **kw):
            calls.append(_name)
            return _real(*args, **kw)

        monkeypatch.setattr(kernels, name, spy)
    kw = dict(device_sim=device_sim, n_unique=n_unique, filter="blur_sobel", overlay=True,
              stencil_impl="pallas")
    got = _compare(monkeypatch, fmt, 66, 50, mode=mode, **kw)
    if fmt == PixelFormat.YUYV:
        want = YUYV_KERNELS[0] if mode == "pallas" else YUYV_KERNELS[1]
        assert calls == [want] * 2
        return
    assert calls == []
    _set_mode(monkeypatch, None)
    rects, colors = _overlay(2, seed=66 + 50)
    _assert_same(got, _ticks(_port(fmt, 66, 50, **kw), 2, rects, colors))


RESIZE_CASES = [(PixelFormat.NV12, 64, 48, (32, 24)), (PixelFormat.RGB24, 66, 50, (32, 24)),
                (PixelFormat.BAYER_BGGR, 64, 48, (40, 30)), (PixelFormat.GRAY8, 64, 48, (33, 20)),
                (PixelFormat.BGRA32, 64, 48, (34, 26))]


@pytest.mark.parametrize("fmt,w,h,size", RESIZE_CASES,
                         ids=[f"{c[0].value}-{c[1]}-{c[3][0]}" for c in RESIZE_CASES])
def test_resized_formats_match_jax(jax_cpu, monkeypatch, fmt, w, h, size):
    port = _compare(monkeypatch, fmt, w, h, resize_to=size, filter="blur_sobel", overlay=True)
    assert port[0]["filtered"].shape == (2, size[1], size[0])


def test_host_outputs_outlive_their_staging_slot(jax_cpu, monkeypatch):
    """BGR24 with no stage: the output is a view of the uploaded bytes, so
    it must not be the staging buffer itself, which the tick after next
    fills again (the CPU upload copies, as the card's does)."""
    _set_mode(monkeypatch, None)
    port = _port(PixelFormat.BGR24, 64, 48)
    kept = [port.tick(block=True).outputs["bgr"] for _ in range(4)]
    want = _ticks(_jax(PixelFormat.BGR24, 64, 48), 4)
    for i, t in enumerate(kept):
        np.testing.assert_array_equal(t.numpy(), want[i]["bgr"], err_msg=f"tick {i}")


@pytest.mark.parametrize("fmt", [f for f in HOST_FORMATS if f not in SIM_FORMATS + [PixelFormat.YUYV]],
                         ids=lambda f: f.value)
def test_device_sim_of_unsynthesized_formats_raises_as_in_jax(jax_cpu, monkeypatch, fmt):
    """The device cannot make UYVY, YV12, GRAY8 or Bayer frames in either
    package: the first tick raises, and a frame pool raises at once."""
    _set_mode(monkeypatch, None)
    for make in (_port, _jax):
        eng = make(fmt, 64, 48, device_sim=True)
        with pytest.raises((SimulationError, jax_core.SimulationError), match="cannot encode"):
            eng.tick(block=True)
        with pytest.raises((SimulationError, jax_core.SimulationError), match="cannot encode"):
            make(fmt, 64, 48, device_sim=True, n_unique=2)


@pytest.mark.parametrize("fmt,device_sim", [(PixelFormat.NV12, True), (PixelFormat.BGRA32, False),
                                            (PixelFormat.BAYER_RGGB, False)])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_format_state_carries_across_packages(jax_cpu, monkeypatch, fmt, device_sim, direction):
    _set_mode(monkeypatch, None)
    rects, colors = _overlay(2, seed=9)
    kw = dict(filter="blur_sobel", overlay=True, device_sim=device_sim)
    first = _jax if direction == "jax_to_port" else _port
    a = first(fmt, 64, 48, **kw)
    _ticks(a, 2, rects, colors)
    state = a.export_state()
    assert state["pixel_format"] == fmt.value
    if direction == "jax_to_port":
        b = MultiStreamEngine.from_state(state, device="cpu")
    else:
        b = JaxEngine.from_state(state)
    assert b.export_state() == state
    got = _ticks(b, 2, rects, colors)
    want = _ticks(a, 2, rects, colors)
    if device_sim:  # the clock resumes; a host path opens its sources anew
        _assert_same(got, want)
    else:
        _assert_same(got, _ticks(first(fmt, 64, 48, **kw), 2, rects, colors))


@pytest.mark.parametrize("fmt,w,h", [(PixelFormat.UYVY, 65, 48), (PixelFormat.NV12, 64, 47),
                                     (PixelFormat.YV12, 63, 48), (PixelFormat.BAYER_RGGB, 1, 4)])
def test_format_size_checks(fmt, w, h):
    with pytest.raises(ValueError, match="needs"):
        port_pipeline.get_pipeline(port_pipeline.PipelineSpec(fmt, w, h))
