"""The port's host-staged engine path (device_sim=False, YUYV) on the CPU
against the JAX package's host path, tick for tick and bit-exact: every
decode mode and stencil implementation, the Harris filter (K6's route),
the port's own device-sim tick of the same sequences, a prefetching run,
per-stream fault containment with its drop math, and the state snapshot
across the two packages."""

import numpy as np
import pytest
import torch

import rustcv_tpu.core as jax_core
import rustcv_tpu.runtime.pipeline as jax_pipeline
from rustcv_tpu.capture import SimulationDriver as JaxDriver
from rustcv_tpu.runtime import MultiStreamEngine as JaxEngine
from rustcv_tpu_torch import core
from rustcv_tpu_torch.capture import SimulationDriver
from rustcv_tpu_torch.core import CameraError, PixelFormat
from rustcv_tpu_torch.ops import kernels
from rustcv_tpu_torch.runtime import MultiStreamEngine

torch.set_num_threads(2)

OUTPUTS = ("bgr", "filtered", "corners", "corners_valid")


def _cfg(w, h, pkg=core):
    return pkg.SimpleConfig(width=w, height=h, fps=60, pixel_format=pkg.PixelFormat.YUYV)


def _overlay(n, seed=0):
    rng = np.random.default_rng(seed)
    rects = np.stack([rng.integers(-10, 40, n), rng.integers(-10, 30, n),
                      rng.integers(0, 60, n), rng.integers(0, 50, n)], 1).astype(np.int32)
    return rects, rng.integers(0, 256, (n, 3), np.uint8)


def _jax(w, h, n, n_unique=0, **kw):
    return JaxEngine(JaxDriver(device_count=n, paced=False, n_unique_frames=n_unique), n,
                     _cfg(w, h, jax_core), device_sim=False, **kw)


def _port(w, h, n, n_unique=0, device_sim=False, **kw):
    return MultiStreamEngine(SimulationDriver(device_count=n, paced=False,
                                              n_unique_frames=n_unique), n,
                             _cfg(w, h), device_sim=device_sim, device="cpu", **kw)


def _fetch(res):
    return ({key: res.numpy(key) for key in OUTPUTS if key in res.outputs}
            | {"seqs": np.asarray(res.sequences)})


def _ticks(eng, k, rects=None, colors=None):
    return [_fetch(eng.tick(rects=rects, rect_colors=colors, block=True)) for _ in range(k)]


def _assert_same(got, want):
    assert len(got) == len(want)
    for i, (p, j) in enumerate(zip(got, want)):
        assert set(p) == set(j)
        for key in j:
            np.testing.assert_array_equal(p[key], j[key], err_msg=f"tick {i} {key}")


def _set_mode(monkeypatch, mode):
    if mode is None:
        monkeypatch.delenv("RUSTCV_DECODE", raising=False)
    else:
        monkeypatch.setenv("RUSTCV_DECODE", mode)
    jax_pipeline.get_pipeline.cache_clear()


@pytest.mark.parametrize("impl", ["xla", "pallas", "pallas_v1", "pallas_v2"])
@pytest.mark.parametrize("mode", [None, "pallas", "pallas_tick"])
def test_staged_tick_matches_jax_in_each_mode_and_stencil(jax_cpu, monkeypatch, mode, impl):
    _set_mode(monkeypatch, mode)
    rects, colors = _overlay(3, seed=7)
    kw = dict(filter="blur_sobel", overlay=True, stencil_impl=impl)
    kernels.reset_launch_counts()
    port = _port(64, 48, 3, **kw)
    _assert_same(_ticks(port, 3, rects, colors), _ticks(_jax(64, 48, 3, **kw), 3, rects, colors))
    assert sum(kernels.launch_counts().values()) == 0  # the CPU runs the plain versions
    port.close()


@pytest.mark.parametrize("mode", [None, "pallas", "pallas_tick"])
@pytest.mark.parametrize("w,h,n", [(160, 120, 4), (64, 48, 2)])
def test_staged_tick_matches_jax_at_each_size(jax_cpu, monkeypatch, mode, w, h, n):
    _set_mode(monkeypatch, mode)
    rects, colors = _overlay(n, seed=w)
    kw = dict(filter="blur_sobel", overlay=True)
    port = _port(w, h, n, **kw)
    _assert_same(_ticks(port, 3, rects, colors), _ticks(_jax(w, h, n, **kw), 3, rects, colors))
    port.close()


@pytest.mark.parametrize("filt", ["harris", "harris_points", "none"])
@pytest.mark.parametrize("mode", [None, "pallas"])
def test_staged_filters_match_jax(jax_cpu, monkeypatch, filt, mode):
    """``harris`` on the host path is K6's route there (the int32 form)."""
    _set_mode(monkeypatch, mode)
    rects, colors = _overlay(2, seed=9)
    kw = dict(filter=filt, overlay=True)
    _assert_same(_ticks(_port(64, 48, 2, **kw), 3, rects, colors),
                 _ticks(_jax(64, 48, 2, **kw), 3, rects, colors))


@pytest.mark.parametrize("n_unique", [0, 3])
@pytest.mark.parametrize("mode", [None, "pallas_tick"])
def test_staged_tick_matches_the_ports_device_sim_tick(monkeypatch, mode, n_unique):
    _set_mode(monkeypatch, mode)
    rects, colors = _overlay(3, seed=11)
    kw = dict(filter="blur_sobel", overlay=True)
    host = _port(160, 120, 3, n_unique, **kw)
    sim = _port(160, 120, 3, n_unique, device_sim=True, **kw)
    _assert_same(_ticks(host, 5, rects, colors), _ticks(sim, 5, rects, colors))
    host.close()


def _recording(eng):
    """Wrap ``eng.tick`` so every result a run makes is kept, fetched."""
    seen = []
    tick = eng.tick

    def recorded(*args, **kwargs):
        res = tick(*args, **kwargs)
        seen.append(_fetch(res))
        return res

    eng.tick = recorded
    return seen


@pytest.mark.parametrize("n,workers", [(3, 8), (1, 8), (4, 1)])
def test_prefetching_run_matches_sequential_ticks(n, workers):
    """run(measure_latency=False) gathers tick k+1 on a thread while tick k
    runs; its ticks equal sequential blocking ticks, and the double buffer
    hands each tick its own frames."""
    rects, colors = _overlay(n, seed=n)
    kw = dict(filter="blur_sobel", overlay=True)
    eng = _port(64, 48, n, decode_workers=workers, **kw)
    seen = _recording(eng)
    stats = eng.run(7, warmup=2, measure_latency=False, rects=rects, rect_colors=colors)
    assert eng._prefetch_pool is not None
    assert (stats.ticks, stats.frames, stats.dropped_frames) == (7, 7 * n, 0)
    assert stats.host_gather_ms > 0 and stats.latencies_ms == []
    assert len(seen) == 9
    _assert_same(seen, _ticks(_port(64, 48, n, **kw), 9, rects, colors))
    eng.close()
    assert eng._prefetch_pool is None and eng._gather_pool is None


def test_latency_run_reports_gather_and_latency():
    eng = _port(64, 48, 2, filter="blur_sobel")
    stats = eng.run(4, warmup=1)
    assert len(stats.latencies_ms) == 4 and stats.p99_latency_ms >= stats.p50_latency_ms > 0
    assert stats.host_gather_ms > 0 and stats.dropped_frames == 0
    assert eng._prefetch_pool is None  # latency mode stays sequential
    eng.close()


class _Flaky:
    """Wraps a source: fails every call after ``fail_after`` (or, with
    ``first=True``, the first ``fail_after`` calls)."""

    def __init__(self, inner, fail_after, error, first=False):
        self._inner, self._count, self._n, self._error, self._first = (
            inner, 0, fail_after, error, first)

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def next_frame(self):
        self._count += 1
        if (self._count <= self._n) if self._first else (self._count > self._n):
            raise self._error("synthetic device failure")
        return self._inner.next_frame()


def test_one_stream_fails_and_the_batch_survives_as_in_jax(jax_cpu):
    port, ref = _port(64, 48, 4), _jax(64, 48, 4)
    port._sources[2] = _Flaky(port._sources[2], 1, CameraError)
    ref._sources[2] = _Flaky(ref._sources[2], 1, jax_core.CameraError)
    got, want = _ticks(port, 3), _ticks(ref, 3)
    _assert_same(got, want)
    assert got[1]["seqs"].tolist() == [1, 1, -1, 1] and got[2]["seqs"].tolist() == [2, 2, -1, 2]
    assert port.stream_errors.tolist() == [0, 0, 2, 0] == ref.stream_errors.tolist()
    # stream 2 keeps showing its last good frame, tick 0's
    np.testing.assert_array_equal(got[2]["bgr"][2], got[0]["bgr"][2])
    assert not np.array_equal(got[2]["bgr"][0], got[0]["bgr"][0])


@pytest.mark.parametrize("first,fail_after", [(False, 3), (True, 2), (False, 0)])
def test_drop_count_ignores_the_fault_sentinel(first, fail_after):
    """A fault on the run's last tick, on its first ticks, or on every tick:
    no frame was dropped, and -1 enters neither count."""
    eng = _port(64, 48, 2)
    eng._sources[1] = _Flaky(eng._sources[1], fail_after, CameraError, first=first)
    stats = eng.run(6, warmup=0, measure_latency=False)
    assert stats.dropped_frames == 0
    assert eng.stream_errors[1] == (fail_after if first else 6 - fail_after)
    eng.close()


def test_drop_count_sees_a_real_gap():
    """A stream whose sequences skip ahead has dropped frames."""
    eng = _port(64, 48, 2)
    src = eng._sources[0]

    class Skipping:
        def __getattr__(self, name):
            return getattr(src, name)

        def next_frame(self):
            src.next_frame()  # one frame lost per frame delivered
            return src.next_frame()

    eng._sources[0] = Skipping()
    stats = eng.run(5, warmup=0, measure_latency=False)
    assert stats.dropped_frames == 4  # sequences 1, 3, 5, 7, 9: four gaps
    eng.close()


def test_a_fault_that_is_not_a_camera_error_ends_the_tick():
    eng = _port(64, 48, 2)
    eng._sources[0] = _Flaky(eng._sources[0], 0, RuntimeError)
    with pytest.raises(RuntimeError, match="synthetic"):
        eng.tick()
    eng.close()


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_host_path_state_carries_across_packages(jax_cpu, monkeypatch, direction):
    _set_mode(monkeypatch, None)
    rects, colors = _overlay(2, seed=4)
    kw = dict(filter="blur_sobel", overlay=True)
    first = _jax(64, 48, 2, **kw) if direction == "jax_to_port" else _port(64, 48, 2, **kw)
    _ticks(first, 2, rects, colors)
    state = first.export_state()
    assert state["device_sim"] is False and state["tick_index"] == 2
    if direction == "jax_to_port":
        b, other = MultiStreamEngine.from_state(state, device="cpu"), JaxEngine.from_state(state)
    else:
        b, other = JaxEngine.from_state(state), MultiStreamEngine.from_state(state, device="cpu")
    assert b.export_state() == state == other.export_state()
    assert not b._device_sim and not other._device_sim
    # Both rebuilt host engines open their sources anew, as the reference does.
    _assert_same(_ticks(b, 2, rects, colors), _ticks(other, 2, rects, colors))


def test_host_path_export_state_has_the_references_values(jax_cpu):
    port, ref = _port(64, 48, 2, filter="blur_sobel"), _jax(64, 48, 2, filter="blur_sobel")
    _ticks(port, 2)
    _ticks(ref, 2)
    assert port.export_state() == ref.export_state()


def test_host_path_construction():
    eng = _port(64, 48, 3, decode_workers=2)
    assert not eng._device_sim and len(eng._staging) == 2
    assert all(t.shape == (3, 64 * 48 * 2) and not t.is_pinned() for (t, _), in eng._staging)
    assert eng._gather_pool is not None and eng.stream_errors.tolist() == [0, 0, 0]
    eng.close()
    single = _port(64, 48, 1)
    assert single._gather_pool is None  # one stream gathers on the caller's thread
    assert single.tick(block=True).sequences.tolist() == [0]
    with pytest.raises(ValueError, match="sub_batch"):
        _port(64, 48, 4, sub_batch=2)
    assert _port(64, 48, 1, device_sim=True).export_state()["device_sim"] is True


def test_gather_alternates_the_staging_slots():
    eng = _port(64, 48, 2)
    slots = [eng.gather()[0] for _ in range(4)]
    assert slots == [0, 1, 0, 1]
    eng.close()


def test_driver_shares_the_cycled_frames_between_its_sources(jax_cpu, monkeypatch):
    """n_unique_frames frames are encoded once per driver and configuration
    and shared by its sources as the encoding only: each source cycles its
    own read-only copy (separate memory, as separate cameras' buffers), and
    the bytes are the JAX package's frames."""
    from rustcv_tpu.capture.simulation import synth_raw as jax_synth_raw
    from rustcv_tpu_torch.capture import simulation

    encoded = []
    synth = simulation.synth_raw
    monkeypatch.setattr(simulation, "synth_raw",
                        lambda w, h, fmt, seq: encoded.append(seq) or synth(w, h, fmt, seq))
    drv = SimulationDriver(device_count=3, paced=False, n_unique_frames=2)
    srcs = [drv.open_simple(f"sim:{i}", _cfg(64, 48))[0] for i in range(3)]
    assert encoded == [0, 1]
    frames = []
    for src in srcs:
        src.start()
        frames.append([src.next_frame().data for _ in range(3)])
    assert frames[0][2] is frames[0][0]  # a cycle of two
    for a in range(3):
        assert not frames[a][0].flags.writeable
        for b in range(a):
            for seq in (0, 1):
                assert not np.shares_memory(frames[a][seq], frames[b][seq])
    for a in range(3):
        for seq in (0, 1):
            np.testing.assert_array_equal(
                frames[a][seq], jax_synth_raw(64, 48, jax_core.PixelFormat.YUYV, seq))
    other = SimulationDriver(device_count=1, paced=False, n_unique_frames=2)
    other.open_simple("sim:0", _cfg(64, 48))
    assert encoded == [0, 1, 0, 1]  # another driver encodes its own


def test_host_gather_ab_probe_refuses_bad_modes_and_a_missing_card():
    """The shared-vs-separate frames probe runs only on a card, and only in
    the engine's decode modes."""
    from rustcv_tpu_torch.probes import host_gather_ab

    assert host_gather_ab.main(["no_such_mode"]) == 2
    if not torch.cuda.is_available():
        assert host_gather_ab.main([]) == 1
