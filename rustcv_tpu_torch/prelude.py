"""prelude — the one-line import mirroring ``rustcv::prelude``
(``rustcv/src/lib.rs:12-16``: Mat, TickMeter, VideoCapture; port of
``rustcv_tpu.prelude``)."""

from .capture import Camera, VideoCapture, VideoWriter
from .core import Mat, PixelFormat, SimpleConfig, TickMeter

__all__ = [
    "Camera", "Mat", "PixelFormat", "SimpleConfig", "TickMeter",
    "VideoCapture", "VideoWriter",
]
