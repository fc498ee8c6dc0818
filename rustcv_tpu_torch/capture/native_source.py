"""Native-backed simulation source: a C++ producer thread and frame ring
(the port of ``rustcv_tpu.capture.native_source``).

The closest structural analog of the reference's Stack-B V4L2 backend
(``rustcv-camera/src/backend/linux/mod.rs``): a native ring
(``native/capture.cpp``) fills with sensor-rate frames off the GIL,
``next_frame`` blocks like DQBUF and returns a zero-copy NumPy view of the
slot, the previous slot is re-queued on the next dequeue (its ``Frame``
invalidated first), and consumer lag shows up as sequence gaps and the
ring's drop counter in :meth:`telemetry`.

Frames are byte-equal to :func:`.simulation.synth_raw` for their sequence
number (the same frozen pattern, compiled from the same constants). YUYV
only.
"""

from __future__ import annotations

from typing import Optional

from ..core.config import ResolvedConfig
from ..core.errors import CameraError, SimulationError, StreamNotStarted
from ..core.frame import Frame, FrameMetadata, Timestamp
from ..core.pixel_format import PixelFormat
from ..core.telemetry import DeviceTelemetry
from ..core.time_sync import ClockSynchronizer
from .source import FrameSource


class NativeSimulationSource(FrameSource):
    """A :class:`FrameSource` over :class:`rustcv_tpu_torch.native.NativeRing`
    with ``max(2, buffer_count)`` slots. Building the ring builds the native
    library at first use; a failed build raises RuntimeError with the
    compiler's output."""

    def __init__(self, resolved: ResolvedConfig, *, paced: bool = True):
        from .. import native

        if resolved.pixel_format != PixelFormat.YUYV:
            raise SimulationError("native source currently produces YUYV only")
        self._cfg = resolved
        self._paced = paced
        self._ring = native.NativeRing(max(2, resolved.buffer_count), resolved.width,
                                       resolved.height)
        self._started = False
        self._clock = ClockSynchronizer(30)
        self._prev_frame: Optional[Frame] = None
        self._prev_slot: Optional[int] = None

    def start(self) -> None:
        if not self._started:
            self._ring.start(self._cfg.fps, paced=self._paced)
            self._started = True

    def stop(self) -> None:
        if self._started:
            self._ring.stop()
            self._started = False
        if self._prev_frame is not None:
            self._prev_frame.invalidate()
            self._prev_frame = None

    def resolved_config(self) -> ResolvedConfig:
        return self._cfg

    def next_frame(self) -> Frame:
        if not self._started:
            raise StreamNotStarted("call start() before next_frame()")
        # Requeue the previous slot: its Frame view becomes invalid.
        if self._prev_frame is not None:
            self._prev_frame.invalidate()
        if self._prev_slot is not None:
            self._ring.requeue(self._prev_slot)
            self._prev_slot = None

        res = self._ring.dequeue(timeout_ms=5000)
        if res is None:
            raise CameraError("native ring dequeue timed out")
        slot, view, seq, ts_ns = res
        self._prev_slot = slot
        frame = Frame(
            view, self._cfg.width, self._cfg.height, PixelFormat.YUYV,
            seq, Timestamp(ts_ns, self._clock.correct(ts_ns)),
            metadata=FrameMetadata(exposure_us=10_000, gain=1.0),
        )
        self._prev_frame = frame
        return frame

    def telemetry(self) -> DeviceTelemetry:
        t = DeviceTelemetry(temperature_c=45.0)
        t.dropped_frames = self._ring.dropped
        t.link_throughput_mbps = int(
            self._cfg.width * self._cfg.height * 2 * self._cfg.fps * 8 / 1e6
        )
        return t

    def close(self) -> None:
        self.stop()
        self._ring.close()
