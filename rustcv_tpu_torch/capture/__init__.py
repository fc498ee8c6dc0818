"""Capture layer of the port: FrameSource protocol, simulation driver,
negotiation, the ``Camera`` and ``VideoCapture`` facades, the MJPEG-AVI
file driver and writer, and (as submodules, imported where used) the
V4L2 driver ``capture.v4l2`` and the native ring source
``capture.native_source``. Importing it loads no torch; decoding does."""

from .avi import AviMjpegReader, FileDriver, FileSource, VideoWriter
from .camera import Camera, default_driver
from .negotiate import negotiate, negotiate_simple, resolve, score_mode, score_mode_msmf
from .simulation import (
    SimulationDriver,
    SimulationSource,
    default_modes,
    encode_bgra,
    encode_mjpeg,
    encode_nv12,
    encode_rgb,
    encode_yuyv,
    synth_bgr,
    synth_raw,
)
from .source import (
    DeviceControls,
    DeviceInfo,
    Driver,
    FrameSource,
    LensControl,
    ModeDescriptor,
    SensorControl,
    SystemControl,
    TriggerConfig,
    TriggerMode,
    TriggerPolarity,
)
from .videocapture import VideoCapture, resolve_device_id

__all__ = [
    "AviMjpegReader", "Camera", "DeviceControls", "DeviceInfo", "Driver",
    "FileDriver", "FileSource", "FrameSource", "LensControl",
    "ModeDescriptor", "SensorControl", "SimulationDriver", "SimulationSource",
    "SystemControl", "TriggerConfig", "TriggerMode", "TriggerPolarity",
    "VideoCapture", "VideoWriter", "default_driver", "default_modes",
    "encode_bgra", "encode_mjpeg", "encode_nv12", "encode_rgb", "encode_yuyv",
    "negotiate", "negotiate_simple", "resolve",
    "resolve_device_id", "score_mode", "score_mode_msmf", "synth_bgr", "synth_raw",
]
