"""Camera — the synchronous zero-copy capture API (Stack B analog; port of
``rustcv_tpu.capture.camera``).

Reference: ``rustcv-camera/src/camera.rs:39-162`` — ``open``/``open_with`` →
negotiate + start; ``next_frame()`` returns a zero-copy Frame view valid
until the next dequeue; ``read_decoded(&mut Mat)`` captures + decodes to BGR
reusing the Mat allocation.

:meth:`read_decoded_device` decodes to a BGR tensor on a device
(uncompressed raw bytes upload and convert there), the building block the
batched runtime executor composes per stream.
"""

from __future__ import annotations

from typing import Optional

from ..core.config import ResolvedConfig, SimpleConfig
from ..core.frame import Frame
from ..core.mat import Mat
from ..core.telemetry import DeviceTelemetry
from .simulation import SimulationDriver
from .source import DeviceControls, Driver, FrameSource

_DEFAULT_DRIVER: Optional[Driver] = None


def default_driver() -> Driver:
    """A V4L2 driver when a capture device is present, else the simulation
    driver (one per process): the run-time analog of the reference's
    compile-time backend switch.

    Without a ``/dev/video*`` node nothing is built. With one, a node that
    turns out to be no capture device (a ``CameraError`` from the node) is
    skipped, and simulation serves when none is left; a native library
    that did not build raises (the reference falls back to simulation on
    any error)."""
    global _DEFAULT_DRIVER
    if _DEFAULT_DRIVER is None:
        from .v4l2 import V4L2Driver, list_video_devices

        drv = V4L2Driver() if list_video_devices() else None
        _DEFAULT_DRIVER = drv if drv is not None and drv.list_devices() else SimulationDriver()
    return _DEFAULT_DRIVER


class Camera:
    """Primary zero-copy capture handle."""

    def __init__(self, source: FrameSource, controls: DeviceControls):
        self._source = source
        self.controls = controls
        self._source.start()

    # -- constructors (camera.rs:55-91) ---------------------------------

    @classmethod
    def open(cls, device_id: str = "sim:0", driver: Optional[Driver] = None) -> "Camera":
        return cls.open_with(device_id, SimpleConfig(), driver)

    @classmethod
    def open_with(
        cls, device_id: str, config: SimpleConfig, driver: Optional[Driver] = None
    ) -> "Camera":
        drv = driver if driver is not None else default_driver()
        if hasattr(drv, "open_simple"):
            source, controls = drv.open_simple(device_id, config)
        else:
            from ..core.config import CameraConfig, Priority

            cfg = CameraConfig()
            if config.width is not None and config.height is not None:
                cfg = cfg.resolution(config.width, config.height, Priority.HIGH)
            if config.fps is not None:
                cfg = cfg.fps(config.fps, Priority.MEDIUM)
            if config.pixel_format is not None:
                cfg = cfg.format(config.pixel_format, Priority.HIGH)
            source, controls = drv.open(device_id, cfg)
        return cls(source, controls)

    # -- capture (camera.rs:113-137) ------------------------------------

    def next_frame(self) -> Frame:
        """Blocking zero-copy dequeue; ~33 ms at 30 fps (camera-rate bound)."""
        return self._source.next_frame()

    def read_decoded(self, mat: Mat) -> None:
        """Capture + decode to BGR into a reused Mat (host, bit-exact path)."""
        from ..ops import decode as _decode

        frame = self.next_frame()
        _decode.decode_frame_host(frame, mat)

    def read_decoded_device(self, device="cuda"):
        """Capture + decode to a (H, W, 3) u8 BGR tensor on ``device``."""
        from ..ops import decode as _decode

        return _decode.decode_to_device(self.next_frame(), device)

    # -- info ------------------------------------------------------------

    def resolved_config(self) -> ResolvedConfig:
        return self._source.resolved_config()

    def telemetry(self) -> DeviceTelemetry:
        return self._source.telemetry()

    @property
    def source(self) -> FrameSource:
        return self._source

    def close(self) -> None:
        self._source.stop()

    def __enter__(self) -> "Camera":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
