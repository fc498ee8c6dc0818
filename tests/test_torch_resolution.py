"""``set_resolution``, ``warm_buckets`` and the shape buckets of the port
against the JAX package on the CPU.

``bucket_for`` picks the reference's bucket on a grid of sizes;
``warm_buckets`` counts the buckets as the reference does and builds their
pipelines, so a swap to one builds nothing; a resolution swap on the
device-sim (with and without the frame pool), host-staged, hybrid MJPEG and
encoded paths is followed by ticks equal to a JAX engine's that made the
same swap (the encoder's float32 DCT and the hybrid decode within the
reference's tolerance, max |diff| <= 1 on < 0.5 %, everything else
bit-exact)."""

import dataclasses

import numpy as np
import pytest
import torch

import rustcv_tpu.capture.simulation as jax_sim
import rustcv_tpu.core as jax_core
import rustcv_tpu.models as jax_models
import rustcv_tpu.runtime.pipeline as jax_pipeline
from rustcv_tpu import native as jax_native
from rustcv_tpu.capture import SimulationDriver as JaxDriver
from rustcv_tpu.runtime import MultiStreamEngine as JaxEngine
from rustcv_tpu.runtime import buckets as jax_buckets
from rustcv_tpu_torch import core, models, native
from rustcv_tpu_torch.capture import SimulationDriver
from rustcv_tpu_torch.capture import simulation as sim
from rustcv_tpu_torch.core import PixelFormat
from rustcv_tpu_torch.runtime import MultiStreamEngine
from rustcv_tpu_torch.runtime import buckets
from rustcv_tpu_torch.runtime import pipeline as port_pipeline

torch.set_num_threads(2)

OUTPUTS = ("bgr", "filtered", "enc_y", "enc_cb", "enc_cr")


def _cfg(w, h, fmt, pkg):
    return pkg.SimpleConfig(width=w, height=h, fps=60, pixel_format=pkg.PixelFormat(fmt.value))


def _port(w, h, n, fmt, n_unique=0, device_sim=True, **kw):
    return MultiStreamEngine(SimulationDriver(device_count=n, paced=False,
                                              n_unique_frames=n_unique), n,
                             _cfg(w, h, fmt, core), device_sim=device_sim, device="cpu", **kw)


def _jax(w, h, n, fmt, n_unique=0, device_sim=True, **kw):
    return JaxEngine(JaxDriver(device_count=n, paced=False, n_unique_frames=n_unique), n,
                     _cfg(w, h, fmt, jax_core), device_sim=device_sim, **kw)


def _overlay(n, seed=0):
    rng = np.random.default_rng(seed)
    rects = np.stack([rng.integers(-10, 40, n), rng.integers(-10, 30, n),
                      rng.integers(4, 60, n), rng.integers(4, 50, n)], 1).astype(np.int32)
    return rects, rng.integers(0, 256, (n, 3), np.uint8)


def _ticks(eng, k, rects=None, colors=None):
    out = []
    for _ in range(k):
        res = eng.tick(rects=rects, rect_colors=colors, block=True)
        out.append({key: np.asarray(res.outputs[key]) for key in OUTPUTS if key in res.outputs}
                   | {"seqs": np.asarray(res.sequences)})
    return out


def _assert_same(port_ticks, jax_ticks, close=()):
    """Equal tick for tick; the keys in ``close`` within max |diff| <= 1 on
    < 0.5 % of the values."""
    assert len(port_ticks) == len(jax_ticks)
    for i, (p, j) in enumerate(zip(port_ticks, jax_ticks)):
        assert set(p) == set(j)
        for key in j:
            assert p[key].shape == j[key].shape, (i, key)
            if key in close:
                d = np.abs(p[key].astype(np.int64) - j[key].astype(np.int64))
                assert d.max() <= 1 and (d > 0).mean() < 5e-3, (i, key, d.max())
            else:
                np.testing.assert_array_equal(p[key], j[key], err_msg=f"tick {i} {key}")


@pytest.fixture()
def plain_decode(monkeypatch):
    monkeypatch.delenv("RUSTCV_DECODE", raising=False)
    jax_pipeline.get_pipeline.cache_clear()


# -- shape buckets ------------------------------------------------------------


def test_shape_buckets_are_the_references():
    assert buckets.SHAPE_BUCKETS == jax_buckets.SHAPE_BUCKETS


@pytest.mark.parametrize("h", [1, 200, 288, 384, 480, 600, 720, 900, 1080, 1620, 2160, 4000])
def test_bucket_for_matches_the_reference_on_a_grid(h):
    """Every width from 1 to 4,000 in steps of 37 (and the buckets' own
    widths, and their neighbours) at this height."""
    widths = set(range(1, 4001, 37))
    widths |= {bw + d for bw, _ in buckets.SHAPE_BUCKETS for d in (-1, 0, 1)}
    for w in sorted(widths):
        assert buckets.bucket_for(w, h) == jax_buckets.bucket_for(w, h), (w, h)


# -- warm_buckets -------------------------------------------------------------


@pytest.mark.parametrize("fmt,device_sim,sizes", [
    (PixelFormat.YUYV, True, [(64, 48), (160, 120), (65, 48)]),
    (PixelFormat.YUYV, False, [(65, 49), (64, 48), (160, 120)]),
    (PixelFormat.BGRA32, False, [(64, 48), (66, 50), (160, 120)]),
    (PixelFormat.NV12, True, [(64, 48), (160, 120)]),
])
def test_warm_buckets_counts_as_jax_and_swaps_warm(jax_cpu, plain_decode, fmt, device_sim, sizes):
    """The count skips odd widths of YUYV only, as the reference does; a
    swap to a warmed size (160×120, one of the simulated sensor's modes)
    builds no pipeline."""
    port = _port(64, 48, 2, fmt, device_sim=device_sim, filter="blur_sobel")
    ref = _jax(64, 48, 2, fmt, device_sim=device_sim, filter="blur_sobel")
    n = port.warm_buckets(buckets=sizes)
    assert n == ref.warm_buckets(buckets=sizes) == len([s for s in sizes if s[0] % 2 == 0
                                                        or fmt != PixelFormat.YUYV])
    before = port_pipeline._cached.cache_info().misses
    port.set_resolution(160, 120)  # built by the warm-up
    assert port_pipeline._cached.cache_info().misses == before
    assert _ticks(port, 1)[0]["filtered"].shape == (2, 120, 160)
    port.close()
    ref.close()


def test_warm_buckets_on_hybrid_mjpeg_warms_the_dense_program(plain_decode):
    """A hybrid MJPEG engine (after its first gather chose the packed
    program) warms each bucket's dense program, the spec a swap makes; the
    reference's warm-up cannot feed a hybrid pipeline and raises."""
    assert native.available(), native.build_error()
    eng = _port(64, 48, 2, PixelFormat.MJPEG, device_sim=False, mjpeg_backend="hybrid",
                filter="blur_sobel", overlay=True)
    _ticks(eng, 1)
    assert eng.spec.mjpeg_packed
    assert eng.warm_buckets(buckets=[(64, 48), (160, 120), (65, 49)]) == 3
    before = port_pipeline._cached.cache_info().misses
    eng.set_resolution(160, 120)
    assert port_pipeline._cached.cache_info().misses == before
    ticks = _ticks(eng, 2)
    assert ticks[1]["bgr"].shape == (2, 120, 160 * 3) and eng.spec.mjpeg_packed
    assert ticks[1]["seqs"].tolist() == [1, 1]
    eng.close()


# -- set_resolution -----------------------------------------------------------

SWAP_CASES = {
    "device_sim": (PixelFormat.YUYV, dict(filter="blur_sobel", overlay=True)),
    "device_sim_pool": (PixelFormat.YUYV, dict(n_unique=3, filter="blur_sobel", overlay=True)),
    "device_sim_nv12": (PixelFormat.NV12, dict(filter="sobel_mag", overlay=True)),
    "host_staged": (PixelFormat.YUYV, dict(device_sim=False, filter="blur_sobel", overlay=True)),
    "host_staged_bgra": (PixelFormat.BGRA32, dict(device_sim=False, filter="gaussian")),
    "host_staged_bayer": (PixelFormat.BAYER_GRBG,
                          dict(device_sim=False, filter="blur_sobel", overlay=True)),
}


@pytest.mark.parametrize("case", list(SWAP_CASES))
def test_set_resolution_matches_jax(jax_cpu, plain_decode, case):
    """64×48 → 160×120 → 64×48: after each swap the state snapshot and two
    ticks equal the JAX engine's."""
    fmt, kw = SWAP_CASES[case]
    rects, colors = _overlay(2, seed=6)
    port, ref = _port(64, 48, 2, fmt, **kw), _jax(64, 48, 2, fmt, **kw)
    _assert_same(_ticks(port, 2, rects, colors), _ticks(ref, 2, rects, colors))
    for size in ((160, 120), (64, 48)):
        port.set_resolution(*size)
        ref.set_resolution(*size)
        assert (port.spec.width, port.spec.height) == size
        assert port.export_state() == ref.export_state()
        _assert_same(_ticks(port, 2, rects, colors), _ticks(ref, 2, rects, colors))
    port.close()
    ref.close()


def test_set_resolution_remakes_the_host_staging(plain_decode):
    """The host path's two staging slots take the new frame size, and the
    events of the old uploads are dropped."""
    eng = _port(64, 48, 2, PixelFormat.UYVY, device_sim=False, filter="blur_sobel")
    _ticks(eng, 2)
    eng.set_resolution(160, 120)
    assert [tuple(t.shape) for slot in eng._staging for t, _ in slot] == [(2, 160 * 120 * 2)] * 2
    assert eng._staging_events == [None, None]
    assert _ticks(eng, 1)[0]["bgr"].shape == (2, 120, 160 * 3)
    eng.close()


@pytest.mark.parametrize("resize_to", [None, (32, 24)])
def test_set_resolution_on_the_encoded_path_matches_jax(jax_cpu, plain_decode, resize_to):
    """Config 6 cut small: without a resize the dense-row cap follows the
    new size, as in the reference, and the payloads are JFIF frames of the
    output size."""
    if not jax_native.available():
        pytest.skip(f"the reference's native library is unavailable: {jax_native.build_error()}")
    port_model, jax_model = (dataclasses.replace(zoo.get_model("config6_transcode"), width=64,
                                                 height=48, n_streams=2, resize_to=resize_to)
                             for zoo in (models, jax_models))
    port, ref = port_model.engine(device="cpu"), jax_model.engine()
    close = ("enc_y", "enc_cb", "enc_cr")
    _assert_same(_ticks(port, 1), _ticks(ref, 1), close)
    port.set_resolution(160, 120)
    ref.set_resolution(160, 120)
    assert (port.spec.encode_packed, port.spec.encode_dense_cap) == (
        ref.spec.encode_packed, ref.spec.encode_dense_cap)
    _assert_same(_ticks(port, 2), _ticks(ref, 2), close)
    for payload in port.encode_payloads(port.tick(block=True)):
        info, _, _ = native.jpeg_entropy_decode(payload)
        assert (info["width"], info["height"]) == (resize_to or (160, 120))
    port.close()


@pytest.fixture()
def same_mjpeg_bytes(monkeypatch):
    """The JAX simulation encodes MJPEG with the port's encoder."""
    assert native.available(), native.build_error()
    if not jax_native.available():
        pytest.skip(f"the reference's native library is unavailable: {jax_native.build_error()}")
    monkeypatch.setitem(jax_sim._ENCODERS, jax_core.PixelFormat.MJPEG, sim.encode_mjpeg)


def test_set_resolution_on_hybrid_mjpeg_matches_jax(jax_cpu, plain_decode, same_mjpeg_bytes):
    """The hybrid coefficient staging is dropped and remade by the next
    gather at the new size; the decode is within the JAX hybrid path's
    max |diff| <= 1 on < 0.5 %."""
    kw = dict(device_sim=False, mjpeg_backend="hybrid", filter="blur_sobel")
    port = _port(64, 48, 2, PixelFormat.MJPEG, **kw)
    ref = _jax(64, 48, 2, PixelFormat.MJPEG, **kw)
    _assert_same(_ticks(port, 1), _ticks(ref, 1), ("bgr", "filtered"))
    port.set_resolution(160, 120)
    ref.set_resolution(160, 120)
    assert port._coeff_staging is None and not port.spec.mjpeg_packed
    ticks = _ticks(port, 2)
    _assert_same(ticks, _ticks(ref, 2), ("bgr", "filtered"))
    assert ticks[0]["bgr"].shape == (2, 120, 160 * 3) and port.spec.mjpeg_packed
    assert port.spec.coeff_geometry == ((16, 20), (8, 10), (8, 10))  # whole 16×16 MCUs
    port.close()
