"""Core types of the port: configs, pixel formats, errors, frames, the
``Mat`` image container, ``TickMeter``, telemetry and the clock
synchroniser (numpy-only; a Mat's device side imports torch at first use).

These are the port's own copies of the reference's core modules, with the
same names and behaviour.
"""

from .config import CameraConfig, Priority, ResolvedConfig, SimpleConfig
from .errors import (
    BackendError,
    BandwidthExceeded,
    BufferAllocationFailed,
    BufferOverflow,
    CameraError,
    DecodeError,
    DeviceBusy,
    DeviceNotFound,
    Disconnected,
    FormatNotSupported,
    ResolutionNotSupported,
    SimulationError,
    StreamNotStarted,
)
from .frame import Frame, FrameMetadata, OwnedFrame, Timestamp
from .mat import Mat
from .pixel_format import FourCC, PixelFormat, from_fourcc, to_fourcc
from .telemetry import DeviceHealthStatus, DeviceTelemetry, HealthIssue, HealthLevel
from .tick_meter import TickMeter
from .time_sync import ClockSynchronizer

__all__ = [
    "BackendError", "BandwidthExceeded", "BufferAllocationFailed",
    "BufferOverflow", "CameraConfig", "CameraError", "ClockSynchronizer",
    "DecodeError", "DeviceBusy", "DeviceHealthStatus", "DeviceNotFound",
    "DeviceTelemetry", "Disconnected", "FormatNotSupported", "FourCC",
    "Frame", "FrameMetadata", "HealthIssue", "HealthLevel", "Mat",
    "OwnedFrame", "PixelFormat", "Priority", "ResolvedConfig",
    "ResolutionNotSupported", "SimpleConfig", "SimulationError",
    "StreamNotStarted", "TickMeter", "Timestamp", "from_fourcc", "to_fourcc",
]
