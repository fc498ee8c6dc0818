"""The port's MultiStreamEngine (device="cpu") against the JAX engine,
tick for tick and bit-exact: decode modes, stencil implementations, the
Canny and Harris filters, sub-batching, the overlay cache, the frame pool,
the model zoo, and state carried across the two packages.

RUSTCV_DECODE is set on both engines with monkeypatch. The JAX package's
get_pipeline is cached by spec alone and reads the variable only when it
builds, so its cache is cleared whenever the variable changes here; the
port's get_pipeline keys its cache by the mode as well."""

import dataclasses
import enum

import numpy as np
import pytest
import torch

import rustcv_tpu.core as jax_core
import rustcv_tpu.models as jax_models
import rustcv_tpu.runtime.pipeline as jax_pipeline
from rustcv_tpu.capture import SimulationDriver as JaxDriver
from rustcv_tpu.runtime import MultiStreamEngine as JaxEngine
from rustcv_tpu_torch import core, models
from rustcv_tpu_torch.core import CameraError, PixelFormat, SimulationError
from rustcv_tpu_torch.capture import SimulationDriver
from rustcv_tpu_torch.ops import kernels
from rustcv_tpu_torch.runtime import MultiStreamEngine
from rustcv_tpu_torch.runtime import pipeline as port_pipeline

torch.set_num_threads(2)

OUTPUTS = ("bgr", "filtered", "corners", "corners_valid")


def _cfg(w, h, fmt=PixelFormat.YUYV, pkg=core):
    """A SimpleConfig of ``pkg``'s core types: the port's, or the JAX
    package's for its engine."""
    return pkg.SimpleConfig(width=w, height=h, fps=60, pixel_format=pkg.PixelFormat(fmt.value))


def _overlay(n, seed=0):
    rng = np.random.default_rng(seed)
    rects = np.stack([rng.integers(-10, 40, n), rng.integers(-10, 30, n),
                      rng.integers(0, 60, n), rng.integers(0, 50, n)], 1).astype(np.int32)
    return rects, rng.integers(0, 256, (n, 3), np.uint8)


def _jax(w, h, n, n_unique=0, **kw):
    return JaxEngine(JaxDriver(device_count=n, paced=False, n_unique_frames=n_unique), n,
                     _cfg(w, h, pkg=jax_core), device_sim=True, **kw)


def _port(w, h, n, n_unique=0, **kw):
    return MultiStreamEngine(SimulationDriver(device_count=n, paced=False,
                                              n_unique_frames=n_unique), n,
                             _cfg(w, h), device_sim=True, device="cpu", **kw)


def _ticks(eng, k, rects=None, colors=None):
    out = []
    for _ in range(k):
        res = eng.tick(rects=rects, rect_colors=colors, block=True)
        out.append({key: res.numpy(key) for key in OUTPUTS if key in res.outputs}
                   | {"seqs": np.asarray(res.sequences)})
    return out


def _assert_same(port_ticks, jax_ticks):
    assert len(port_ticks) == len(jax_ticks)
    for i, (p, j) in enumerate(zip(port_ticks, jax_ticks)):
        assert set(p) == set(j)
        for key in j:
            np.testing.assert_array_equal(p[key], j[key], err_msg=f"tick {i} {key}")


def _set_mode(monkeypatch, mode):
    if mode is None:
        monkeypatch.delenv("RUSTCV_DECODE", raising=False)
    else:
        monkeypatch.setenv("RUSTCV_DECODE", mode)
    jax_pipeline.get_pipeline.cache_clear()


@pytest.mark.parametrize("mode", [None, "pallas", "pallas_tick"])
@pytest.mark.parametrize("w,h,n", [(64, 48, 3), (160, 120, 4)])
def test_engine_matches_jax_in_each_decode_mode(jax_cpu, monkeypatch, mode, w, h, n):
    _set_mode(monkeypatch, mode)
    rects, colors = _overlay(n, seed=w)
    kw = dict(filter="blur_sobel", overlay=True)
    ref = _ticks(_jax(w, h, n, **kw), 3, rects, colors)
    kernels.reset_launch_counts()
    port = _port(w, h, n, **kw)
    assert port.spec.stencil_impl == "xla"  # the CPU default
    _assert_same(_ticks(port, 3, rects, colors), ref)
    # on the CPU the kernel wrappers take their plain versions: no launches
    assert sum(kernels.launch_counts().values()) == 0


@pytest.mark.parametrize("filt", ["blur_sobel", "gaussian", "harris_points"])
@pytest.mark.parametrize("overlay", [True, False])
@pytest.mark.parametrize("w,h,n", [(64, 48, 3), (34, 24, 2)])
def test_xla_fused_matches_jax(jax_cpu, monkeypatch, filt, overlay, w, h, n):
    """``RUSTCV_DECODE=xla_fused``: the overlay painted on the YUYV pixel
    pairs (the filters then read the painted image, as the reference's
    do); without the overlay the plain decode."""
    _set_mode(monkeypatch, "xla_fused")
    rects, colors = _overlay(n, seed=w + n)
    kw = dict(filter=filt, overlay=overlay)
    _assert_same(_ticks(_port(w, h, n, **kw), 3, rects, colors),
                 _ticks(_jax(w, h, n, **kw), 3, rects, colors))


def test_xla_fused_leaves_other_specs_on_the_plain_decode(jax_cpu, monkeypatch):
    """A resize, or another wire format, takes the default path under
    xla_fused, as in the reference."""
    rects, colors = _overlay(2, seed=1)
    kw = dict(filter="blur_sobel", overlay=True)
    fused, plain = [], []
    for mode, out in (("xla_fused", fused), (None, plain)):
        _set_mode(monkeypatch, mode)
        out.append(_ticks(_port(64, 48, 2, resize_to=(32, 24), **kw), 2, rects, colors))
        out.append(_ticks(MultiStreamEngine(
            SimulationDriver(device_count=2, paced=False), 2, _cfg(64, 48, PixelFormat.NV12),
            device_sim=True, device="cpu", **kw), 2, rects, colors))
    for a, b in zip(fused, plain):
        _assert_same(a, b)


@pytest.mark.parametrize("mode", ["pallas", "pallas_tick"])
@pytest.mark.parametrize("impl", ["pallas", "pallas_v1", "pallas_v2"])
def test_kernel_modes_and_stencil_impls_match_jax(jax_cpu, monkeypatch, mode, impl):
    """Every (decode mode, Pallas stencil) pair in both engines."""
    _set_mode(monkeypatch, mode)
    rects, colors = _overlay(2, seed=3)
    kw = dict(filter="blur_sobel", overlay=True, stencil_impl=impl)
    _assert_same(_ticks(_port(64, 48, 2, **kw), 2, rects, colors),
                 _ticks(_jax(64, 48, 2, **kw), 2, rects, colors))


@pytest.mark.parametrize("impl", ["xla", "pallas", "pallas_v1", "pallas_v2"])
def test_every_stencil_impl_matches_jax(jax_cpu, monkeypatch, impl):
    _set_mode(monkeypatch, None)
    rects, colors = _overlay(3, seed=1)
    kw = dict(filter="blur_sobel", overlay=True, stencil_impl=impl)
    _assert_same(_ticks(_port(64, 48, 3, **kw), 3, rects, colors),
                 _ticks(_jax(64, 48, 3, **kw), 3, rects, colors))


@pytest.mark.parametrize("filt", ["none", "gaussian", "sobel_mag"])
@pytest.mark.parametrize("mode", [None, "pallas"])
def test_other_filters_match_jax(jax_cpu, monkeypatch, filt, mode):
    _set_mode(monkeypatch, mode)
    rects, colors = _overlay(2, seed=2)
    kw = dict(filter=filt, overlay=True)
    _assert_same(_ticks(_port(64, 48, 2, **kw), 2, rects, colors),
                 _ticks(_jax(64, 48, 2, **kw), 2, rects, colors))


@pytest.mark.parametrize("filt", ["canny", "harris", "harris_points"])
@pytest.mark.parametrize("mode", [None, "pallas", "pallas_tick"])
def test_feature_filters_match_jax(jax_cpu, monkeypatch, filt, mode):
    """Under pallas the gray comes from K4; under pallas_tick (K5 serves
    blur_sobel only) from the plain decode, as in the reference."""
    _set_mode(monkeypatch, mode)
    rects, colors = _overlay(2, seed=8)
    kw = dict(filter=filt, overlay=True)
    port = _ticks(_port(64, 48, 2, **kw), 3, rects, colors)
    _assert_same(port, _ticks(_jax(64, 48, 2, **kw), 3, rects, colors))
    if filt == "harris_points":
        assert port[0]["corners"].shape == (2, 256, 2) and port[0]["corners"].dtype == np.int32
        assert port[0]["corners_valid"].shape == (2, 256) and port[0]["corners_valid"].any()
        assert "filtered" not in port[0]
    else:
        assert port[0]["filtered"].shape == (2, 48, 64)


@pytest.mark.parametrize("filt", ["harris", "harris_points"])
def test_feature_filters_in_sub_batches_without_bgr(jax_cpu, monkeypatch, filt):
    """emit_bgr=False leaves no bgr to probe for the _sync token: the probe
    is the first output (filtered, or the corners), in the pipeline and in
    the sub-batch loop alike."""
    _set_mode(monkeypatch, None)
    kw = dict(filter=filt, emit_bgr=False)
    port = _port(64, 48, 4, sub_batch=2, **kw)
    res = port.tick(block=True)
    first = "filtered" if filt == "harris" else "corners"
    assert next(iter(res.outputs)) == first and "bgr" not in res.outputs
    assert torch.equal(res.outputs["_sync"], res.outputs[first].reshape(-1)[:1])
    ref = _jax(64, 48, 4, sub_batch=2, **kw)
    _assert_same([_ticks(port, 2)[-1]], [_ticks(ref, 3)[-1]])
    _assert_same(_ticks(_port(64, 48, 4, **kw), 3), _ticks(_jax(64, 48, 4, **kw), 3))


def test_sub_batch_matches_monolithic_and_jax(jax_cpu, monkeypatch):
    _set_mode(monkeypatch, None)
    rects, colors = _overlay(4, seed=4)
    kw = dict(filter="blur_sobel", overlay=True)
    sub = _ticks(_port(64, 48, 4, sub_batch=2, **kw), 3, rects, colors)
    _assert_same(sub, _ticks(_port(64, 48, 4, **kw), 3, rects, colors))
    _assert_same(sub, _ticks(_jax(64, 48, 4, sub_batch=2, **kw), 3, rects, colors))


def test_frame_pool_matches_jax(jax_cpu, monkeypatch):
    """n_unique_frames > 0: ticks gather from a pool made once on the device."""
    _set_mode(monkeypatch, None)
    kw = dict(filter="blur_sobel", overlay=False)
    _assert_same(_ticks(_port(64, 48, 2, n_unique=3, **kw), 5),
                 _ticks(_jax(64, 48, 2, n_unique=3, **kw), 5))


def test_overlay_cache_uploads_again_after_a_rect_change(jax_cpu, monkeypatch):
    _set_mode(monkeypatch, None)
    rects, colors = _overlay(3, seed=5)
    kw = dict(filter="blur_sobel", overlay=True)
    port, ref = _port(64, 48, 3, **kw), _jax(64, 48, 3, **kw)
    before = _ticks(port, 1, rects, colors)
    _assert_same(before, _ticks(ref, 1, rects, colors))
    cached = port._overlay_cache[1][0]
    rects[:, 0] += 7  # mutate the caller's array in place
    after = _ticks(port, 1, rects, colors)
    assert port._overlay_cache[1][0] is not cached
    _assert_same(after, _ticks(ref, 1, rects, colors))
    # unchanged content reuses the cached device args
    _ticks(port, 1, rects.copy(), colors.copy())
    assert port._overlay_cache[1][0] is not cached
    again = port._overlay_cache[1][0]
    _ticks(port, 1, rects.copy(), colors.copy())
    assert port._overlay_cache[1][0] is again


@pytest.mark.parametrize("filt", ["blur_sobel", "harris"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_state_carries_across_packages(jax_cpu, monkeypatch, direction, filt):
    _set_mode(monkeypatch, None)
    rects, colors = _overlay(3, seed=6)
    kw = dict(filter=filt, overlay=True)
    first, second = (_jax, _port) if direction == "jax_to_port" else (_port, _jax)
    a = first(64, 48, 3, **kw)
    _ticks(a, 2, rects, colors)
    state = a.export_state()
    if direction == "jax_to_port":
        b = MultiStreamEngine.from_state(state, device="cpu")
    else:
        b = JaxEngine.from_state(state)
    assert b.export_state() == state
    _assert_same(_ticks(b, 2, rects, colors), _ticks(a, 2, rects, colors))


def test_export_state_has_the_reference_keys(jax_cpu):
    assert set(_port(64, 48, 2).export_state()) == set(_jax(64, 48, 2).export_state())


def test_run_reports_frames_and_no_drops():
    eng = _port(64, 48, 2, filter="blur_sobel", overlay=True)
    rects, colors = _overlay(2)
    stats = eng.run(4, warmup=1, rects=rects, rect_colors=colors)
    assert (stats.ticks, stats.frames, stats.dropped_frames) == (4, 8, 0)
    assert len(stats.latencies_ms) == 4 and stats.fps_total > 0
    stats = eng.run(3, warmup=0, measure_latency=False)
    assert stats.frames == 6 and stats.latencies_ms == []
    assert eng.export_state()["sequences"] == [8, 8]
    eng.close()


def test_tick_outputs_and_layout():
    with _port(64, 48, 2, filter="blur_sobel", overlay=True) as eng:
        res = eng.tick(block=True)
        assert set(res.outputs) == {"bgr", "filtered", "_sync", "_next_seqs"}
        assert tuple(res.outputs["bgr"].shape) == (2, 48, 64 * 3)
        assert res.numpy("bgr").shape == (2, 48, 64, 3)
        assert res.outputs["_sync"].numel() == 1
        assert res.outputs["_next_seqs"].tolist() == [1, 1]


def test_cuda_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        MultiStreamEngine(SimulationDriver(device_count=1, paced=False), 1, _cfg(64, 48),
                          device_sim=True)


def test_pipeline_cache_keys_the_decode_mode(monkeypatch):
    spec = port_pipeline.PipelineSpec(PixelFormat.YUYV, 64, 48, filter="blur_sobel")
    monkeypatch.setenv("RUSTCV_DECODE", "pallas")
    a = port_pipeline.get_pipeline(spec)
    monkeypatch.setenv("RUSTCV_DECODE", "pallas_tick")
    b = port_pipeline.get_pipeline(spec)
    monkeypatch.setenv("RUSTCV_DECODE", "pallas")
    assert a is not b and port_pipeline.get_pipeline(spec) is a


def _device_sim_tick(fmt):
    """One device-sim tick of ``fmt``, which the device cannot synthesize in
    either package: the reference raises SimulationError at the first tick."""
    return lambda mp: MultiStreamEngine(
        SimulationDriver(device_count=1, paced=False), 1, _cfg(64, 48, fmt), device_sim=True,
        device="cpu").tick(block=True)


def _mesh_with_sub_batch(mp):
    """``sub_batch`` on a mesh, which the reference refuses too (``mesh=``
    itself runs: tests/test_torch_parallel.py)."""
    import torch.distributed as dist

    from rustcv_tpu_torch.parallel import stream_mesh

    made = not dist.is_initialized()
    try:
        _port(64, 48, 2, mesh=stream_mesh("cpu"), sub_batch=1)
    finally:
        if made and dist.is_initialized():
            dist.destroy_process_group()


@pytest.mark.parametrize(
    "make,error,match",
    [
        pytest.param(lambda mp: MultiStreamEngine(
            SimulationDriver(device_count=1, paced=False), 1, _cfg(64, 48, PixelFormat.MJPEG),
            mjpeg_backend="host", device_sim=True, device="cpu"), CameraError,
            "device_sim does not support MJPEG", id="mjpeg_host"),
        pytest.param(_mesh_with_sub_batch, ValueError, "sub_batch is per-chip", id="mesh"),
        pytest.param(lambda mp: _port(64, 48, 1).tick(text="tab\there"), NotImplementedError,
                     "ROADMAP queue 1 item 8", id="text"),
        pytest.param(_device_sim_tick(PixelFormat.UYVY), SimulationError, "cannot encode",
                     id="uyvy"),
        pytest.param(_device_sim_tick(PixelFormat.YV12), SimulationError, "cannot encode",
                     id="yv12"),
    ],
)
def test_unported_specs_raise(monkeypatch, make, error, match):
    """What the port does not run raises NotImplementedError naming the
    ROADMAP; what the reference cannot run either raises the reference's
    own error."""
    with pytest.raises(error, match=match):
        make(monkeypatch)


def _small(model, w=160, h=120, n=2):
    return dataclasses.replace(model, width=w, height=h, n_streams=n)


def test_config4_through_the_zoo_matches_jax(jax_cpu, monkeypatch):
    """Config 4 at 160×120 with 2 streams, 3 ticks, both zoos; then a port
    engine rebuilt from the JAX engine's export_state() continues it."""
    _set_mode(monkeypatch, None)
    port_model = _small(models.get_model("config4_harris_1080p"))
    jax_model = _small(jax_models.get_model("config4_harris_1080p"))
    ref_eng = jax_model.engine()
    ref = _ticks(ref_eng, 3)
    port = port_model.engine(device="cpu")
    assert port.spec.filter == "harris" and port._sub_batch is None
    _assert_same(_ticks(port, 3), ref)
    resumed = MultiStreamEngine.from_state(ref_eng.export_state(), device="cpu")
    assert resumed.spec.filter == "harris"
    _assert_same(_ticks(resumed, 2), _ticks(ref_eng, 2))


def _fields(model) -> dict:
    """A model's fields, each enum as its value (the two packages have
    their own PixelFormat classes with the same values)."""
    return {k: v.value if isinstance(v, enum.Enum) else v
            for k, v in dataclasses.asdict(model).items()}


# The port's own values: config 3 runs as one batch on the H100, faster
# than the reference's sub_batch=4 (PERF.md §6).
PORT_FIELDS = {"config3_blur_sobel_4k": {"sub_batch": None}}


def test_zoo_models_match_the_reference():
    """Every model carries the reference's fields, but PORT_FIELDS."""
    assert list(models.MODELS) == list(jax_models.MODELS)
    assert jax_models.get_model("config3_blur_sobel_4k").sub_batch == 4
    for name, ref in jax_models.MODELS.items():
        port = models.get_model(name)
        assert _fields(port) == {**_fields(ref), **PORT_FIELDS.get(name, {})}, name
    with pytest.raises(KeyError, match="unknown model"):
        models.get_model("config9")


@pytest.mark.parametrize("name", ["config1_convert_overlay", "config3_blur_sobel_4k",
                                  "config4_harris_1080p", "config5_end_to_end_4k",
                                  "config6_transcode"])
def test_zoo_raw_models_build_their_engines(name):
    model = models.get_model(name)
    small = _small(model, 64, 48, n=2 * model.sub_batch if model.sub_batch else 1)
    with small.engine(device="cpu") as eng:
        assert (eng.spec.filter, eng.spec.overlay) == (model.filter, model.overlay)
        assert eng._sub_batch == model.sub_batch  # the reference passes it as is
        out = eng.tick(block=True).outputs
        assert "bgr" in out and ("filtered" in out) == (model.filter != "none")


def test_device_sim_mjpeg_raises():
    """MJPEG has no device-sim form: its entropy decode is host work, as in
    the reference."""
    with pytest.raises(core.CameraError, match="device_sim"):
        MultiStreamEngine(SimulationDriver(device_count=1, paced=False), 1,
                          _cfg(64, 48, PixelFormat.MJPEG), device_sim=True,
                          mjpeg_backend="hybrid", device="cpu")


def test_zoo_config2_builds_its_hybrid_engine_and_ticks():
    model = _small(models.get_model("config2_mjpeg_resize"), 64, 48, n=2)
    small = dataclasses.replace(model, resize_to=(32, 24))
    with small.engine(device="cpu") as eng:
        assert eng._mjpeg_hybrid and not eng._device_sim
        res = eng.tick(block=True)
        assert eng.spec.mjpeg_packed and len(eng.spec.coeff_geometry) == 3
        assert res.numpy("bgr").shape == (2, 24, 32, 3) and res.sequences.tolist() == [0, 0]
        assert eng.export_state()["device_sim"] is False


def test_dummy_overlay_defaults_to_the_card(monkeypatch):
    """``make_dummy_overlay`` uses the card unless the caller names another
    device (as ``Mat()`` does): with no card its default raises instead of
    making CPU tensors; ``device="cpu"`` still makes them, with the
    reference's values."""
    rects, colors, thickness = port_pipeline.make_dummy_overlay(3, device="cpu")
    want = jax_pipeline.make_dummy_overlay(3)
    assert rects.device.type == colors.device.type == "cpu"
    assert np.array_equal(rects.numpy(), np.asarray(want[0]))
    assert np.array_equal(colors.numpy(), np.asarray(want[1])) and thickness == want[2]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        port_pipeline.make_dummy_overlay(3)
