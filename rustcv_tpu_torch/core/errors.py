"""Error taxonomy for rustcv_tpu_torch.

Mirrors the reference's two error enums:
- ``rustcv-core/src/error.rs:4-32`` (Stack A: Disconnected, BandwidthExceeded,
  DeviceBusy, BufferOverflow, FormatNotSupported, SimulationError, BackendError, Io)
- ``rustcv-camera/src/error.rs:13-65`` (Stack B: DeviceNotFound, DeviceBusy,
  FormatNotSupported, ResolutionNotSupported, StreamNotStarted,
  BufferAllocationFailed, DecodeError, Io)

We unify both taxonomies under a single exception hierarchy so user code can
catch ``CameraError`` for anything capture-related, while keeping the specific
subclasses for precise handling.
"""

from __future__ import annotations


class CameraError(Exception):
    """Base class for all capture/pipeline errors."""


class DeviceNotFound(CameraError):
    """No such device / stream id (reference: DeviceNotFound)."""

    def __init__(self, device: str):
        super().__init__(f"camera device not found: {device}")
        self.device = device


class Disconnected(CameraError):
    """Device disappeared mid-stream (reference: Disconnected)."""


class DeviceBusy(CameraError):
    """Device already opened exclusively elsewhere (reference: DeviceBusy)."""


class BandwidthExceeded(CameraError):
    """Requested config exceeds link bandwidth.

    Carries the same structured payload as the reference
    (``rustcv-core/src/error.rs``: required, limit, suggestion).
    """

    def __init__(self, required_mbps: int, limit_mbps: int, suggestion: str = ""):
        super().__init__(
            f"bandwidth exceeded: required {required_mbps} Mbps > limit "
            f"{limit_mbps} Mbps. {suggestion}"
        )
        self.required_mbps = required_mbps
        self.limit_mbps = limit_mbps
        self.suggestion = suggestion


class BufferOverflow(CameraError):
    """Consumer fell behind the producer ring (reference: BufferOverflow)."""


class FormatNotSupported(CameraError):
    """Pixel format not supported by the source (reference: FormatNotSupported)."""

    def __init__(self, fmt) -> None:
        super().__init__(f"pixel format not supported: {fmt}")
        self.format = fmt


class ResolutionNotSupported(CameraError):
    """Resolution outside of the source's capability (reference: ResolutionNotSupported)."""

    def __init__(self, width: int, height: int):
        super().__init__(f"resolution not supported: {width}x{height}")
        self.width = width
        self.height = height


class StreamNotStarted(CameraError):
    """Operation requires a started stream (reference: StreamNotStarted)."""


class BufferAllocationFailed(CameraError):
    """Host/device staging-buffer allocation failed (reference: BufferAllocationFailed)."""


class DecodeError(CameraError):
    """Raw frame could not be decoded to BGR (reference: DecodeError)."""


class SimulationError(CameraError):
    """Simulation-source specific failure (reference: SimulationError)."""


class BackendError(CameraError):
    """Opaque backend failure (reference: BackendError)."""


class EndOfStream(CameraError):
    """A finite source (video file) ran out of frames — the exception form
    of the facade protocol's EndOfStream response (videoio/mod.rs:33);
    ``VideoCapture.read`` maps it to ``False`` without recording an error."""


def not_ported(what: str, why: str = "", item: str = "") -> NotImplementedError:
    """The error raised where the port does not run something the reference
    does yet: it names what, why (``why``) and the ROADMAP Queue 1 item
    that will port it (``item``)."""
    reason = f": {why}" if why else ""
    where = f"ROADMAP queue 1 item {item}" if item else "ROADMAP queue 1"
    return NotImplementedError(f"{what} is not ported to rustcv_tpu_torch yet{reason} ({where})")

