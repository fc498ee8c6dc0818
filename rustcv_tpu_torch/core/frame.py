"""Frame types — zero-copy borrowed frames and owned deep copies.

Reference parity:
- ``rustcv-core/src/frame.rs:10-76`` — ``Frame<'a>`` (data, width, height,
  stride, format, sequence, timestamp, metadata), ``Timestamp{hw_raw_ns,
  system_synced}``, ``FrameMetadata{exposure, gain, trigger_fired,
  strobe_active}``.
- ``rustcv-camera/src/frame.rs:52-233`` — lifetime-bound zero-copy ``Frame``
  whose borrow prevents double-dequeue, ``to_owned()`` deep copy,
  ``OwnedFrame``, ``decode_bgr()`` into a ``Mat``.

Rust enforces the ring-buffer contract with the borrow checker
(``rustcv-camera/src/frame.rs:26-51``). Python cannot, so we enforce it at
runtime: when the source requeues the underlying slot it calls
:meth:`Frame.invalidate`, and any later access to ``data`` raises
``RuntimeError`` — use-after-requeue becomes a loud error instead of a race.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .pixel_format import PixelFormat


@dataclass(frozen=True)
class Timestamp:
    """Raw hardware timestamp + PLL-corrected system time (frame.rs:41-48)."""

    hw_raw_ns: int
    system_synced_s: float  # seconds since process start, via ClockSynchronizer


@dataclass(frozen=True)
class FrameMetadata:
    """Actual sensor state when the frame was captured (frame.rs:51-56)."""

    exposure_us: Optional[int] = None
    gain: Optional[float] = None
    trigger_fired: bool = False
    strobe_active: bool = False


class Frame:
    """A zero-copy view of one captured frame.

    ``data`` is a read-only NumPy view into the source's ring slot — no copy.
    The view is only valid until the next dequeue on the same source.
    """

    __slots__ = (
        "_data", "width", "height", "stride", "pixel_format",
        "sequence", "timestamp", "metadata", "_valid", "bottom_up",
    )

    def __init__(
        self,
        data: np.ndarray,
        width: int,
        height: int,
        pixel_format: PixelFormat,
        sequence: int,
        timestamp: Timestamp,
        stride: Optional[int] = None,
        metadata: FrameMetadata = FrameMetadata(),
        bottom_up: bool = False,
    ):
        self._data = data
        self.width = width
        self.height = height
        self.stride = stride
        self.pixel_format = pixel_format
        self.sequence = sequence
        self.timestamp = timestamp
        self.metadata = metadata
        # Bottom-up row order (the negative-pitch layout Media Foundation
        # sources produce — rustcv-backend-msmf/src/stream.rs:317-410);
        # decoders flip to top-down. Row-local formats only.
        self.bottom_up = bottom_up
        self._valid = True

    @property
    def data(self) -> np.ndarray:
        """Raw frame bytes (flat u8). Raises if the slot was requeued."""
        if not self._valid:
            raise RuntimeError(
                "Frame accessed after its ring slot was requeued "
                "(the Rust reference prevents this at compile time; "
                "copy with to_owned() to keep a frame across dequeues)"
            )
        return self._data

    @property
    def timestamp_us(self) -> int:
        """Convenience µs timestamp (rustcv-camera frame.rs naming)."""
        return self.timestamp.hw_raw_ns // 1000

    def invalidate(self) -> None:
        self._valid = False

    def to_owned(self) -> "OwnedFrame":
        """Deep copy that outlives the ring slot (frame.rs:165-174)."""
        return OwnedFrame(
            data=self.data.copy(),
            width=self.width,
            height=self.height,
            pixel_format=self.pixel_format,
            sequence=self.sequence,
            timestamp=self.timestamp,
            stride=self.stride,
            metadata=self.metadata,
            bottom_up=self.bottom_up,
        )

    def decode_bgr(self):
        """Decode to a host BGR Mat (frame.rs:186-190), by the port's
        converters on the CPU."""
        from ..ops import decode as _decode
        from .mat import Mat

        mat = Mat()
        _decode.decode_frame_host(self, mat)
        return mat


@dataclass
class OwnedFrame:
    """An owning frame (deep copy), safe to keep indefinitely (frame.rs:205-233)."""

    data: np.ndarray
    width: int
    height: int
    pixel_format: PixelFormat
    sequence: int
    timestamp: Timestamp
    stride: Optional[int] = None
    metadata: FrameMetadata = field(default_factory=FrameMetadata)
    bottom_up: bool = False

    def as_frame(self) -> Frame:
        return Frame(
            self.data, self.width, self.height, self.pixel_format,
            self.sequence, self.timestamp, self.stride, self.metadata,
            bottom_up=self.bottom_up,
        )
