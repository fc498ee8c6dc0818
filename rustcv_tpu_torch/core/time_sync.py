"""ClockSynchronizer — software PLL for hardware→system timestamp mapping.

Reference: ``rustcv-core/src/time.rs:18-154``. Sliding-window (default 30)
least-squares linear regression mapping hardware timestamps (ns) to system
monotonic arrival times, correcting crystal drift and transport jitter.
Fewer than 5 samples → simple offset fallback against the first sample.

Pure host-side math; identical algorithm, vectorized with NumPy.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Deque, Tuple

import numpy as np

_PROCESS_START = time.monotonic()


class ClockSynchronizer:
    def __init__(self, window_size: int = 30):
        self.window_size = max(2, window_size)
        self.history: Deque[Tuple[int, float]] = deque(maxlen=self.window_size)
        self.estimated_slope = 1.0   # system-seconds per hardware-ns, scaled below
        self.estimated_offset = 0.0

    def correct(self, hw_ns: int, arrival_monotonic: float | None = None) -> float:
        """Map a hardware timestamp to corrected system time.

        Returns seconds since process start (the analog of the reference's
        ``Duration`` since the process-start anchor, ``time.rs:140-153``).
        """
        if arrival_monotonic is None:
            arrival_monotonic = time.monotonic()
        self.history.append((hw_ns, arrival_monotonic))

        if len(self.history) < 5:
            # Offset-only fallback (time.rs:53-66): align to the first sample.
            base_hw, base_sys = self.history[0]
            elapsed_hw_s = max(0, hw_ns - base_hw) * 1e-9
            return (base_sys - _PROCESS_START) + elapsed_hw_s

        self._recalculate_regression()
        base_hw, base_sys = self.history[0]
        dx = float(hw_ns - base_hw)
        predicted_dy_s = self.estimated_slope * dx + self.estimated_offset
        return (base_sys - _PROCESS_START) + max(0.0, predicted_dy_s)

    def _recalculate_regression(self) -> None:
        """Least squares over the window (time.rs:84-117), x in hw-ns deltas,
        y in system-seconds deltas; slope therefore carries the ns→s scale."""
        base_hw, base_sys = self.history[0]
        xs = np.array([hw - base_hw for hw, _ in self.history], dtype=np.float64)
        ys = np.array([sys - base_sys for _, sys in self.history], dtype=np.float64)
        n = float(len(xs))
        sum_x = xs.sum()
        sum_y = ys.sum()
        sum_xy = float(np.dot(xs, ys))
        sum_xx = float(np.dot(xs, xs))
        denom = n * sum_xx - sum_x * sum_x
        if abs(denom) < 1e-6:
            # Degenerate (timestamps did not advance): identity mapping in
            # ns→s scale, zero offset (time.rs:108-111).
            self.estimated_slope = 1e-9
            self.estimated_offset = 0.0
        else:
            self.estimated_slope = (n * sum_xy - sum_x * sum_y) / denom
            self.estimated_offset = (sum_y * sum_xx - sum_x * sum_xy) / denom

    @property
    def drift_ppm(self) -> float:
        """Estimated crystal drift in parts-per-million vs nominal 1ns/ns."""
        return (self.estimated_slope * 1e9 - 1.0) * 1e6
