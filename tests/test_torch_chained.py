"""``run_chained`` of the port's engine against the JAX engine on the CPU.

The chained function (k whole device-sim ticks, returning only the probe
``_sync`` and the advanced clock ``_next_seqs``) equals the JAX engine's
``_build_sim_fn_chained(k)`` for configs 1, 3, 4 and 5 cut small, a
frame-pool engine and NV12, with the caller's rects honoured, and its probe
wraps in int32 as the reference's does; on the CPU ``run_chained`` calls it
eagerly (a CUDA device replays it as a CUDA graph,
``tests/test_torch_cuda.py``). A host-staged engine refuses it with the
reference's CameraError. The resolution swap is in
``tests/test_torch_resolution.py``."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rustcv_tpu.core as jax_core
import rustcv_tpu.models as jax_models
import rustcv_tpu.runtime.pipeline as jax_pipeline
from rustcv_tpu.capture import SimulationDriver as JaxDriver
from rustcv_tpu.runtime import MultiStreamEngine as JaxEngine
from rustcv_tpu_torch import core, models
from rustcv_tpu_torch.capture import SimulationDriver
from rustcv_tpu_torch.core import CameraError, PixelFormat
from rustcv_tpu_torch.runtime import MultiStreamEngine

torch.set_num_threads(2)

OUTPUTS = ("bgr", "filtered", "corners", "corners_valid", "enc_y", "enc_cb", "enc_cr")


def _cfg(w, h, fmt=PixelFormat.YUYV, pkg=core):
    return pkg.SimpleConfig(width=w, height=h, fps=60, pixel_format=pkg.PixelFormat(fmt.value))


def _port(w, h, n, fmt=PixelFormat.YUYV, n_unique=0, device_sim=True, **kw):
    return MultiStreamEngine(SimulationDriver(device_count=n, paced=False,
                                              n_unique_frames=n_unique), n,
                             _cfg(w, h, fmt), device_sim=device_sim, device="cpu", **kw)


def _jax(w, h, n, fmt=PixelFormat.YUYV, n_unique=0, device_sim=True, **kw):
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
    """Equal tick for tick; the keys in ``close`` (the encoder's float32
    DCT) within the reference's tolerance, max |diff| <= 1 on < 0.5 %."""
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


def _small(name, w, h, n=None, **changes):
    """A zoo model of both packages cut to w×h (and n streams)."""
    out = []
    for zoo in (models, jax_models):
        m = zoo.get_model(name)
        out.append(dataclasses.replace(m, width=w, height=h, n_streams=n or m.n_streams,
                                       **changes))
    return out


# -- the chained function ---------------------------------------------------

CHAIN_CASES = {
    "config1": lambda: _small("config1_convert_overlay", 64, 48),
    "config4": lambda: _small("config4_harris_1080p", 64, 48),
    "config4_points": lambda: _small("config4_harris_1080p", 64, 48, filter="harris_points"),
    "config3_sub_batch": lambda: _small("config3_blur_sobel_4k", 64, 48, n=4, sub_batch=2),
    "config5": lambda: _small("config5_end_to_end_4k", 66, 50, n=2),
}


def _engines(case):
    if case == "frame_pool":
        kw = dict(filter="blur_sobel", overlay=True)
        return _port(64, 48, 2, n_unique=3, **kw), _jax(64, 48, 2, n_unique=3, **kw)
    if case == "nv12":
        kw = dict(filter="sobel_mag", overlay=True)
        return (_port(64, 48, 2, PixelFormat.NV12, **kw), _jax(64, 48, 2, PixelFormat.NV12, **kw))
    port_model, jax_model = CHAIN_CASES[case]()
    return port_model.engine(device="cpu"), jax_model.engine()


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("case", [*CHAIN_CASES, "frame_pool", "nv12"])
def test_chained_function_matches_jax(jax_cpu, plain_decode, case, k):
    """``_sync`` and ``_next_seqs`` of k chained ticks equal the JAX
    chain's, from a clock at 5 with the caller's rects, thickness 2."""
    port, ref = _engines(case)
    rects, colors = _overlay(port.n, seed=k)
    seqs = np.arange(5, 5 + port.n, dtype=np.int32)
    got = port._build_sim_fn_chained(k)(torch.from_numpy(seqs), torch.from_numpy(rects),
                                        torch.from_numpy(colors), 2)
    want = ref._build_sim_fn_chained(k)(jnp.asarray(seqs), jnp.asarray(rects),
                                        jnp.asarray(colors), jnp.int32(2))
    assert got["_sync"].dtype == torch.int32 and tuple(got["_sync"].shape) == (1,)
    np.testing.assert_array_equal(got["_sync"].numpy(), np.asarray(want["_sync"]))
    np.testing.assert_array_equal(got["_next_seqs"].numpy(), np.asarray(want["_next_seqs"]))
    assert set(got) == {"_sync", "_next_seqs"}


def test_chained_probe_is_the_wrapped_sum_of_the_ticks(plain_decode):
    """The probe is the int32-wrapped sum of every output of every tick (a
    big enough image makes the int64 sum leave the int32 range)."""
    eng = _port(1280, 720, 4, overlay=True)
    rects, colors = _overlay(4, seed=3)
    got = eng._build_sim_fn_chained(2)(torch.zeros(4, dtype=torch.int32),
                                      torch.from_numpy(rects), torch.from_numpy(colors), 2)
    total = 0
    for res in (eng.tick(rects=rects, rect_colors=colors, thickness=2) for _ in range(2)):
        total += int(res.outputs["bgr"].sum(dtype=torch.int64))
    assert total > 2**31
    assert int(got["_sync"][0]) == (total + 2**31) % 2**32 - 2**31


@pytest.mark.parametrize("case", ["config1", "config4", "frame_pool"])
def test_run_chained_advances_the_clock_as_jax(jax_cpu, plain_decode, case):
    """run_chained's counts and stream clock equal the JAX engine's, with
    and without the caller's rects; the next tick continues the clock."""
    port, ref = _engines(case)
    rects, colors = _overlay(port.n, seed=4)
    for kw in (dict(rects=rects, rect_colors=colors), {}):
        a = port.run_chained(10, chain=3, warmup=2, **kw)
        b = ref.run_chained(10, chain=3, warmup=2, **kw)
        assert (a.ticks, a.frames) == (b.ticks, b.frames) == (9, 9 * port.n)
        assert a.wall_s > 0
        np.testing.assert_array_equal(port._seqs, ref._seqs)
    assert port._seqs.tolist() == [30] * port.n  # (2 warm-up + 3 dispatches) × 3, twice
    _assert_same(_ticks(port, 2, rects, colors), _ticks(ref, 2, rects, colors))


def test_run_chained_caches_one_chain_per_key(plain_decode, monkeypatch):
    eng = _port(64, 48, 2, filter="blur_sobel", overlay=True)
    eng.run_chained(4, chain=2)
    first = eng._chain(2)
    eng.run_chained(4, chain=2)
    assert eng._chain(2) is first and len(eng._chains) == 1
    eng.run_chained(3, chain=3)
    monkeypatch.setenv("RUSTCV_DECODE", "pallas")  # the engine's pipeline stays its own
    eng.run_chained(4, chain=2)
    assert len(eng._chains) == 2 and eng._chain(2) is first
    eng.set_resolution(160, 120)
    assert eng._chains == {}
    assert first.graph is None  # the CPU runs the chain eagerly


def test_run_chained_needs_device_sim():
    eng = _port(64, 48, 2, device_sim=False)
    with pytest.raises(CameraError, match="device_sim"):
        eng.run_chained(4, chain=2)
    eng.close()


@pytest.mark.parametrize("argv", [["0"], ["x"], ["3", "4"]])
def test_chain_profile_probe_refuses_bad_arguments(argv):
    from rustcv_tpu_torch.probes import chain_profile

    assert chain_profile.main(argv) == 2


def test_chain_profile_probe_needs_a_card():
    from rustcv_tpu_torch.probes import chain_profile

    if not torch.cuda.is_available():
        assert chain_profile.main(["2"]) == 1
