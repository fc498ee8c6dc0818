"""The port's ``utils`` against the reference's (``tests/test_utils.py``):
StageTimer and CaptureStats on the same records give the same reports;
``get_logger``'s namespace; ``profile_trace`` on torch.profiler writes a
Chrome trace of the region and raises where the profiler fails."""

import json
import time

import numpy as np
import pytest
import torch

from rustcv_tpu import utils as jax_utils
from rustcv_tpu_torch import utils
from rustcv_tpu_torch.utils import CaptureStats, StageTimer, get_logger, profile_trace


def test_stage_timer_accumulates():
    t = StageTimer()
    with t.stage("a"):
        time.sleep(0.01)
    with t.stage("a"):
        pass
    t.add("b", 0.5)
    s = t.summary()
    assert s["a"]["count"] == 2
    assert s["a"]["total_ms"] >= 10
    assert s["b"]["avg_ms"] == 500.0
    t.reset()
    assert t.summary() == {}


def test_stage_timer_adds_as_the_references():
    ours, ref = StageTimer(), jax_utils.StageTimer()
    for name, sec in (("gather", 0.25), ("h2d", 0.125), ("gather", 0.5)):
        ours.add(name, sec)
        ref.add(name, sec)
    assert ours.summary() == ref.summary()


@pytest.mark.parametrize("seqs", [(0, 1, 2, 5, 6), (3,), (7, 8, 9), (0, 4, 4, 10)])
def test_capture_stats_report_equals_the_references(seqs):
    ours, ref = CaptureStats(), jax_utils.CaptureStats()
    t = np.cumsum(np.random.default_rng(len(seqs)).uniform(0.005, 0.05, len(seqs))) + 100.0
    for seq, ts in zip(seqs, t):
        ours.record(seq, float(ts))
        ref.record(seq, float(ts))
    assert ours.report() == ref.report()
    assert (ours.drop_rate, ours.p99_interval_ms) == (ref.drop_rate, ref.p99_interval_ms)


def test_capture_stats_drop_accounting():
    cs = CaptureStats()
    t = 100.0
    for seq in (0, 1, 2, 5, 6):  # gap 3-4 = 2 drops
        cs.record(seq, t)
        t += 0.01
    r = cs.report()
    assert r["frames"] == 5
    assert r["dropped"] == 2
    assert abs(r["fps"] - 100.0) < 1
    assert cs.drop_rate == 2 / 7


def test_capture_stats_intervals():
    cs = CaptureStats()
    for i in range(4):
        cs.record(i, 10.0 + sum([0.0, 0.01, 0.02, 0.07][: i + 1]))
    assert cs.max_interval_ms >= 40


def test_capture_stats_empty():
    cs = CaptureStats()
    assert cs.fps == 0.0 and cs.dropped == 0 and cs.p99_interval_ms == 0.0
    assert cs.report() == jax_utils.CaptureStats().report()


def test_logger_namespace():
    assert get_logger().name == "rustcv_tpu_torch"
    assert get_logger("x").name == "x"
    assert utils.__all__ == jax_utils.__all__


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with profile_trace(str(tmp_path / "trace")) as path:
        (torch.arange(4096, dtype=torch.float32) * 2).sum()
    assert path.startswith(str(tmp_path / "trace")) and path.endswith(".json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)


def test_profile_trace_raises_where_the_profiler_fails(tmp_path, monkeypatch):
    """No silent trace-less fallback: a profiler that fails to start raises."""
    import torch.profiler

    def refuse(*args, **kwargs):
        raise RuntimeError("profiler refused to start")

    monkeypatch.setattr(torch.profiler, "profile", refuse)
    with pytest.raises(RuntimeError, match="refused"):
        with profile_trace(str(tmp_path)):
            pass
