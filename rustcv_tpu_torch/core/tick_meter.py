"""TickMeter — OpenCV ``cv::TickMeter`` clone (the port's copy of
``rustcv_tpu.core.tick_meter``, same behaviour).

Reference: ``rustcv/src/core/tick_meter.rs:5-67`` — start/stop accumulate
elapsed wall time across intervals; ``get_counter`` counts completed
start/stop pairs; ``get_fps`` = counter / total seconds; ``reset`` clears.
"""

from __future__ import annotations

import time


class TickMeter:
    __slots__ = ("_start", "_total_sec", "_counter")

    def __init__(self) -> None:
        self._start: float | None = None
        self._total_sec = 0.0
        self._counter = 0

    def start(self) -> None:
        self._start = time.perf_counter()

    def stop(self) -> None:
        if self._start is None:
            return
        self._total_sec += time.perf_counter() - self._start
        self._start = None
        self._counter += 1

    def reset(self) -> None:
        self._start = None
        self._total_sec = 0.0
        self._counter = 0

    def get_counter(self) -> int:
        return self._counter

    def get_time_sec(self) -> float:
        return self._total_sec

    def get_time_milli(self) -> float:
        return self._total_sec * 1e3

    def get_time_micro(self) -> float:
        return self._total_sec * 1e6

    def get_fps(self) -> float:
        if self._total_sec <= 0.0:
            return 0.0
        return self._counter / self._total_sec

    def get_avg_time_milli(self) -> float:
        if self._counter == 0:
            return 0.0
        return self.get_time_milli() / self._counter
