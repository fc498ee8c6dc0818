"""videoio — facade module mirroring ``rustcv::videoio`` (port of
``rustcv_tpu.videoio``).

The reference exposes capture through ``rustcv::videoio::VideoCapture`` with
a compile-time backend factory (``videoio/backend.rs``); here the factory is
:func:`create_driver` and backends are runtime-pluggable Driver objects.
"""

from __future__ import annotations

from .capture import (
    Camera,
    FileDriver,
    SimulationDriver,
    VideoCapture,
    VideoWriter,
    default_driver,
    resolve_device_id,
)
from .capture.source import Driver


def create_driver(backend: str = "simulation", **kwargs) -> Driver:
    """Backend factory (the ``create_driver``/``BackendType`` analog,
    ``rustcv/src/videoio/backend.rs:6-48``): "simulation" (Python),
    "native" (the C++ ring, ``capture.native_source``: its sources are opened
    one by one, so the devices come from the simulation driver), "v4l2"
    (direct-ioctl capture from ``/dev/video*`` on Linux, ``capture.v4l2``)
    and "file"."""
    if backend in ("simulation", "native"):
        return SimulationDriver(**kwargs)
    if backend == "v4l2":
        from .capture.v4l2 import V4L2Driver

        return V4L2Driver(**kwargs)
    if backend == "file":
        return FileDriver(**kwargs)
    raise ValueError(
        f"unknown backend {backend!r} (available: simulation, native, v4l2, file)"
    )


def default_backend() -> str:
    """"v4l2" when a V4L2 capture device is present, else "simulation" (the
    reference's compile-time OS switch, made at run time): the probe of
    :func:`default_driver`."""
    from .capture.v4l2 import V4L2Driver

    return "v4l2" if isinstance(default_driver(), V4L2Driver) else "simulation"


__all__ = [
    "Camera", "Driver", "FileDriver", "SimulationDriver", "VideoCapture",
    "VideoWriter", "create_driver", "default_backend", "default_driver",
    "resolve_device_id",
]
