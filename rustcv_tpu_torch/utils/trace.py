"""Tracing, profiling and capture statistics (port of
``rustcv_tpu.utils.trace``).

- :func:`get_logger`: standard logging under one namespace.
- :class:`StageTimer`: wall time accumulated per named stage (host gather,
  upload, kernel, download).
- :class:`CaptureStats`: streaming frames/s, interval percentiles and drop
  rate, with the reference's ``report()`` keys.
- :func:`profile_trace`: a ``torch.profiler`` trace of a region (the host's
  ops and, where PyTorch was built with CUDA, the card's kernels), written
  as a Chrome trace for Perfetto or ``chrome://tracing``.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


def get_logger(name: str = "rustcv_tpu_torch") -> logging.Logger:
    return logging.getLogger(name)


class StageTimer:
    """Accumulate wall time per named stage; thread-compatible enough for
    the engine's single-consumer loops."""

    def __init__(self) -> None:
        self._total: Dict[str, float] = defaultdict(float)
        self._count: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._total[name] += time.perf_counter() - t0
            self._count[name] += 1

    def add(self, name: str, seconds: float) -> None:
        self._total[name] += seconds
        self._count[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {
                "total_ms": self._total[k] * 1e3,
                "count": self._count[k],
                "avg_ms": self._total[k] * 1e3 / max(1, self._count[k]),
            }
            for k in self._total
        }

    def reset(self) -> None:
        self._total.clear()
        self._count.clear()


@dataclass
class CaptureStats:
    """Streaming frames/s, interval and drop statistics."""

    intervals_s: List[float] = field(default_factory=list)
    first_seq: Optional[int] = None
    last_seq: Optional[int] = None
    frames: int = 0
    _last_t: Optional[float] = None

    def record(self, sequence: int, t: Optional[float] = None) -> None:
        t = time.perf_counter() if t is None else t
        if self._last_t is not None:
            self.intervals_s.append(t - self._last_t)
        self._last_t = t
        if self.first_seq is None:
            self.first_seq = sequence
        self.last_seq = sequence
        self.frames += 1

    @property
    def fps(self) -> float:
        if not self.intervals_s:
            return 0.0
        return 1.0 / float(np.mean(self.intervals_s))

    @property
    def p99_interval_ms(self) -> float:
        if not self.intervals_s:
            return 0.0
        return float(np.percentile(self.intervals_s, 99)) * 1e3

    @property
    def max_interval_ms(self) -> float:
        if not self.intervals_s:
            return 0.0
        return float(np.max(self.intervals_s)) * 1e3

    @property
    def dropped(self) -> int:
        if self.first_seq is None or self.last_seq is None:
            return 0
        expected = self.last_seq - self.first_seq + 1
        return max(0, expected - self.frames)

    @property
    def drop_rate(self) -> float:
        if self.first_seq is None or self.last_seq is None:
            return 0.0
        expected = self.last_seq - self.first_seq + 1
        return self.dropped / max(1, expected)

    def report(self) -> Dict[str, float]:
        return {
            "frames": self.frames,
            "fps": round(self.fps, 2),
            "p99_interval_ms": round(self.p99_interval_ms, 3),
            "max_interval_ms": round(self.max_interval_ms, 3),
            "dropped": self.dropped,
            "drop_rate": round(self.drop_rate, 4),
        }


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Trace a region with ``torch.profiler``: the CPU activity, and the
    CUDA activity where this PyTorch build has it. Yields the path of the
    Chrome trace (``log_dir/trace_<pid>.json``), written when the region
    ends. A profiler that fails to start raises."""
    from torch.profiler import ProfilerActivity, profile, supported_activities

    activities = [a for a in (ProfilerActivity.CPU, ProfilerActivity.CUDA)
                  if a in supported_activities()]
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{os.getpid()}.json")
    with profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(path)
