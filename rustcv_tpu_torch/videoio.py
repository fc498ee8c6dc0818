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
from .core.errors import not_ported


def create_driver(backend: str = "simulation", **kwargs) -> Driver:
    """Backend factory (the ``create_driver``/``BackendType`` analog,
    ``rustcv/src/videoio/backend.rs:6-48``): "simulation" and "file". The
    reference's "native" (C++ ring) and "v4l2" (direct-ioctl capture)
    backends are not ported and raise."""
    if backend == "simulation":
        return SimulationDriver(**kwargs)
    if backend == "file":
        return FileDriver(**kwargs)
    if backend in ("native", "v4l2"):
        raise not_ported(f"the {backend!r} capture backend",
                         "it needs a copy of the reference's C++ capture source", "11")
    raise ValueError(
        f"unknown backend {backend!r} (available: simulation, native, v4l2, file)"
    )


def default_backend() -> str:
    """The backend :func:`default_driver` uses: "simulation" (the
    reference prefers "v4l2" when a camera is present; not ported)."""
    return "simulation"


__all__ = [
    "Camera", "Driver", "FileDriver", "SimulationDriver", "VideoCapture",
    "VideoWriter", "create_driver", "default_backend", "default_driver",
    "resolve_device_id",
]
