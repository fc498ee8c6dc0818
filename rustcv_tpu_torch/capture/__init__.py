"""Capture layer of the port: FrameSource protocol, simulation driver and
negotiation (numpy-only, no torch). The ``Camera``/``VideoCapture`` facades
and the AVI file driver are not ported yet (ROADMAP queue 1)."""

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

__all__ = [
    "DeviceControls", "DeviceInfo", "Driver", "FrameSource", "LensControl",
    "ModeDescriptor", "SensorControl", "SimulationDriver", "SimulationSource",
    "SystemControl", "TriggerConfig", "TriggerMode", "TriggerPolarity",
    "default_modes", "encode_bgra", "encode_mjpeg", "encode_nv12",
    "encode_rgb", "encode_yuyv", "negotiate", "negotiate_simple", "resolve",
    "score_mode", "score_mode_msmf", "synth_bgr", "synth_raw",
]
