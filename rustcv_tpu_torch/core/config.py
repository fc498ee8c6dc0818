"""Camera/stream configuration builders.

The reference ships two builder styles; we provide both:

1. :class:`CameraConfig` — priority-scored multi-requirement lists
   (``rustcv-core/src/builder.rs:4-61``): each requirement carries a
   :class:`Priority`; negotiation scores candidate modes (see
   :mod:`rustcv_tpu_torch.capture.negotiate`).
2. :class:`SimpleConfig` — Option-based with auto-format policy
   (``rustcv-camera/src/config.rs:23-115``): unset pixel format is chosen by
   fps (<60 → MJPEG for bandwidth, ≥60 → YUYV for decode cost, policy at
   ``config.rs:36-45``). Resolution defaults to 640×480, fps to 30.

:class:`ResolvedConfig` reports what the source actually applied
(``rustcv-camera/src/config.rs:129-149``).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from .pixel_format import PixelFormat


class Priority(enum.IntEnum):
    """Requirement weight (reference ``builder.rs:13-18``)."""

    LOW = 0
    MEDIUM = 50
    HIGH = 100
    REQUIRED = 255  # must be satisfied or negotiation fails


@dataclass
class CameraConfig:
    """Priority-scored requirement lists (Stack-A style)."""

    resolution_req: List[Tuple[int, int, Priority]] = field(default_factory=list)
    fps_req: Optional[Tuple[int, Priority]] = None
    format_req: List[Tuple[PixelFormat, Priority]] = field(default_factory=list)
    buffer_count: int = 3
    # Default 256-byte stride alignment for SIMD/DMA friendliness
    # (reference builder.rs:9,33). On TPU this also keeps H2D staging aligned.
    align_stride: Optional[int] = 256

    def resolution(self, w: int, h: int, p: Priority = Priority.MEDIUM) -> "CameraConfig":
        self.resolution_req.append((w, h, p))
        return self

    def fps(self, fps: int, p: Priority = Priority.MEDIUM) -> "CameraConfig":
        self.fps_req = (fps, p)
        return self

    def format(self, fmt: PixelFormat, p: Priority = Priority.MEDIUM) -> "CameraConfig":
        self.format_req.append((fmt, p))
        return self

    def with_buffer_count(self, count: int) -> "CameraConfig":
        self.buffer_count = count
        return self


@dataclass
class SimpleConfig:
    """Option-based builder with auto-format policy (Stack-B style)."""

    width: Optional[int] = None
    height: Optional[int] = None
    fps: Optional[int] = None
    pixel_format: Optional[PixelFormat] = None
    buffer_count: int = 5  # ~166 ms of slack at 30 fps (config.rs:53-57)

    def resolution(self, width: int, height: int) -> "SimpleConfig":
        self.width = width
        self.height = height
        return self

    def with_fps(self, fps: int) -> "SimpleConfig":
        self.fps = fps
        return self

    def with_pixel_format(self, fmt: PixelFormat) -> "SimpleConfig":
        self.pixel_format = fmt
        return self

    def with_buffer_count(self, count: int) -> "SimpleConfig":
        self.buffer_count = count
        return self

    def effective_format(self) -> PixelFormat:
        """Auto-format policy: fps<60 → MJPEG, fps≥60 → YUYV (config.rs:36-45)."""
        if self.pixel_format is not None:
            return self.pixel_format
        fps = self.fps if self.fps is not None else 30
        return PixelFormat.MJPEG if fps < 60 else PixelFormat.YUYV


@dataclass(frozen=True)
class ResolvedConfig:
    """What the source actually applied (``config.rs:129-149``)."""

    width: int
    height: int
    fps: int
    pixel_format: PixelFormat
    buffer_count: int
