"""Real V4L2 capture backend, the direct-ioctl zero-copy driver (the port
of ``rustcv_tpu.capture.v4l2``).

Ports the reference's flagship Stack-B backend
(``rustcv-camera/src/backend/linux/mod.rs:38-446``, ``sys.rs:18-443``) behind
this package's :class:`FrameSource`/:class:`Driver` protocol:

- device discovery walks ``/dev/video*`` (Stack-A ``device.rs:15-41``);
- mode enumeration + the SAME Python negotiation scoring used by the
  simulation driver (``capture/negotiate.py``) pick fmt×size×fps;
- the native layer (``native/v4l2.cpp``) applies S_FMT/S_PARM, disables
  ``exposure_auto_priority`` (the low-light throttle fix), mmaps the kernel
  ring, and serves ONE blocking DQBUF per frame;
- ``next_frame`` returns a zero-copy view of the mmap buffer; the previous
  buffer is re-queued on the next call, and the previous Frame is
  invalidated (use-after-requeue raises — the borrow-checker contract).

On a camera-less host a missing node raises ``DeviceNotFound`` and a node
that is no capture device ``CameraError``. A native library that did not
build raises RuntimeError with the compiler's output; one built without
``linux/videodev2.h`` raises ``CameraError``.
"""

from __future__ import annotations

import ctypes
import glob
from typing import List, Optional, Tuple

import numpy as np

from ..core.config import CameraConfig, ResolvedConfig, SimpleConfig
from ..core.errors import (
    CameraError, DeviceNotFound, FormatNotSupported, StreamNotStarted,
)
from ..core.frame import Frame, FrameMetadata, Timestamp
from ..core.pixel_format import FourCC, PixelFormat, from_fourcc, to_fourcc
from ..core.telemetry import DeviceTelemetry
from ..core.time_sync import ClockSynchronizer
from .negotiate import negotiate, resolve
from .source import (
    DeviceControls, DeviceInfo, Driver, FrameSource, LensControl,
    ModeDescriptor, SensorControl, SystemControl, TriggerConfig,
)

# V4L2 control ids (the reference's hand-defined set,
# rustcv-backend-v4l2/src/controls.rs:15-26 + sys.rs:443).
CID_EXPOSURE_AUTO = 0x009A0901      # 1 = manual, 3 = aperture-priority auto
CID_EXPOSURE_ABSOLUTE = 0x009A0902  # units of 100 µs
CID_GAIN = 0x00980913
CID_FOCUS_ABSOLUTE = 0x009A090A
CID_FOCUS_AUTO = 0x009A090C
CID_ZOOM_ABSOLUTE = 0x009A090D
EXPOSURE_MANUAL = 1
EXPOSURE_APERTURE_PRIORITY = 3


def _lib():
    from .. import native

    if not native.v4l2_available():  # raises RuntimeError if the build failed
        raise CameraError("V4L2 backend unavailable: the native library was built "
                          "without linux/videodev2.h")
    return native.get_lib()


def list_video_devices() -> List[str]:
    return sorted(glob.glob("/dev/video*"))


def enumerate_modes(path: str) -> List[ModeDescriptor]:
    """Open + QUERYCAP + enumerate discrete fmt×size modes, then close."""
    lib = _lib()
    err = ctypes.c_int()
    h = lib.rcv_v4l2_open(path.encode(), ctypes.byref(err))
    if not h:
        raise DeviceNotFound(f"{path} (rc={err.value})")
    try:
        cap = 256
        fourccs = (ctypes.c_uint32 * cap)()
        ws = (ctypes.c_int * cap)()
        hs = (ctypes.c_int * cap)()
        fps = (ctypes.c_int * cap)()
        n = lib.rcv_v4l2_enum_modes(h, fourccs, ws, hs, fps, cap)
        modes = []
        for i in range(n):
            fmt, _ = from_fourcc(FourCC(fourccs[i]))
            modes.append(
                ModeDescriptor(
                    pixel_format=fmt, width=ws[i], height=hs[i],
                    fps_options=(fps[i],) if fps[i] > 0 else (30,),
                )
            )
        return modes
    finally:
        lib.rcv_v4l2_close(h)


class V4L2Source(FrameSource):
    """One open, streaming V4L2 device (zero-copy DQBUF semantics)."""

    def __init__(self, path: str, resolved: ResolvedConfig):
        lib = _lib()
        err = ctypes.c_int()
        self._h = lib.rcv_v4l2_open(path.encode(), ctypes.byref(err))
        if not self._h:
            raise DeviceNotFound(f"{path} (rc={err.value})")
        self._lib = lib
        self._path = path
        got_fcc = ctypes.c_uint32()
        gw = ctypes.c_int()
        gh = ctypes.c_int()
        gs = ctypes.c_int()
        gsize = ctypes.c_long()
        rc = lib.rcv_v4l2_setup(
            self._h, to_fourcc(resolved.pixel_format).value,
            resolved.width, resolved.height, resolved.fps,
            resolved.buffer_count,
            ctypes.byref(got_fcc), ctypes.byref(gw), ctypes.byref(gh),
            ctypes.byref(gs), ctypes.byref(gsize),
        )
        if rc != 0:
            lib.rcv_v4l2_close(self._h)
            self._h = None
            raise CameraError(f"V4L2 setup failed on {path} (rc={rc})")
        fmt, _ = from_fourcc(FourCC(got_fcc.value))
        if fmt == PixelFormat.OTHER:
            # Close before raising: STREAMON already ran, so leaking the
            # handle would keep the camera busy (EBUSY for every later open).
            lib.rcv_v4l2_close(self._h)
            self._h = None
            raise FormatNotSupported(f"driver applied unknown fourcc {got_fcc.value:#x}")
        # The driver may adjust geometry: the RESOLVED config is what it did.
        self._cfg = ResolvedConfig(
            width=gw.value, height=gh.value, fps=resolved.fps,
            pixel_format=fmt, buffer_count=resolved.buffer_count,
        )
        self._stride = gs.value
        self._started = True  # STREAMON happened in setup
        self._clock = ClockSynchronizer(30)
        self._prev_frame: Optional[Frame] = None
        self._first_seq: Optional[int] = None
        self._last_seq: Optional[int] = None
        self._frames = 0

    def start(self) -> None:
        if self._h is None:
            raise CameraError("source closed")
        if not self._started:
            rc = self._lib.rcv_v4l2_restart(self._h)
            if rc != 0:
                raise CameraError(f"V4L2 restart failed on {self._path} (rc={rc})")
            self._started = True

    def stop(self) -> None:
        if self._h is not None and self._started:
            self._lib.rcv_v4l2_stop(self._h)
            self._started = False
        if self._prev_frame is not None:
            self._prev_frame.invalidate()
            self._prev_frame = None

    def resolved_config(self) -> ResolvedConfig:
        return self._cfg

    def next_frame(self) -> Frame:
        if self._h is None or not self._started:
            raise StreamNotStarted("call start() before next_frame()")
        if self._prev_frame is not None:
            self._prev_frame.invalidate()  # its mmap buffer is re-queued now
        data = ctypes.POINTER(ctypes.c_uint8)()
        used = ctypes.c_long()
        seq = ctypes.c_long()
        ts = ctypes.c_long()
        slot = self._lib.rcv_v4l2_dequeue(
            self._h, ctypes.byref(data), ctypes.byref(used),
            ctypes.byref(seq), ctypes.byref(ts),
        )
        if slot < 0:
            raise CameraError(f"DQBUF failed on {self._path} (rc={slot})")
        raw_view = np.ctypeslib.as_array(data, shape=(used.value,))
        view = self._compact_rows(raw_view)
        stride = self._stride if view is raw_view and self._stride else None
        if self._first_seq is None:
            self._first_seq = int(seq.value)
        self._last_seq = int(seq.value)
        self._frames += 1
        frame = Frame(
            view, self._cfg.width, self._cfg.height, self._cfg.pixel_format,
            int(seq.value),
            Timestamp(int(ts.value), self._clock.correct(int(ts.value))),
            stride=stride,
            metadata=FrameMetadata(),
        )
        self._prev_frame = frame
        return frame

    def _compact_rows(self, view: np.ndarray) -> np.ndarray:
        """De-stride padded rows: some drivers align bytesperline (e.g. to
        64 B), but every decoder here assumes packed rows. Packed-format
        frames with stride padding are compacted (one copy — padding makes
        zero-copy impossible anyway); exactly-packed frames stay zero-copy.
        MJPEG is a byte stream (no rows); padded PLANAR frames are rejected
        (per-plane pitches are driver-specific)."""
        fmt = self._cfg.pixel_format
        if fmt == PixelFormat.MJPEG or not self._stride:
            return view
        h, w = self._cfg.height, self._cfg.width
        expected = fmt.buffer_size(w, h)
        if view.size == expected:
            return view  # packed already (stride == row bytes)
        if fmt in (PixelFormat.NV12, PixelFormat.YV12):
            raise CameraError(
                f"padded stride {self._stride} unsupported for planar {fmt}"
            )
        if view.size != self._stride * h:
            raise CameraError(
                f"frame bytes {view.size} inconsistent with stride "
                f"{self._stride} × {h} rows on {self._path}"
            )
        row_bytes = expected // h
        return np.ascontiguousarray(
            view[: self._stride * h].reshape(h, self._stride)[:, :row_bytes]
        ).reshape(-1)

    def telemetry(self) -> DeviceTelemetry:
        t = DeviceTelemetry()
        if self._first_seq is not None and self._last_seq is not None:
            expected = self._last_seq - self._first_seq + 1
            t.dropped_frames = max(0, expected - self._frames)
        return t

    def close(self) -> None:
        if self._h is not None:
            self.stop()
            self._lib.rcv_v4l2_close(self._h)
            self._h = None

    def __del__(self):
        if getattr(self, "_h", None) is not None:
            self.close()


class _V4L2Controls(SensorControl, LensControl, SystemControl):
    """Real control planes over VIDIOC_S_CTRL/G_CTRL, following the
    reference's sequences (controls.rs:44-105,125-138): exposure = auto→
    manual then absolute (100 µs units); focus = autofocus off then
    absolute; export_state = JSON snapshot of exposure/gain."""

    def __init__(self, source: "V4L2Source"):
        self._src = source

    def _handle(self):
        h = self._src._h
        if h is None:  # guard: a NULL handle would segfault in C
            raise CameraError("V4L2 source is closed")
        return h

    def _set(self, cid: int, value: int) -> None:
        rc = self._src._lib.rcv_v4l2_set_ctrl(self._handle(), cid, int(value))
        if rc != 0:
            raise CameraError(f"V4L2 control {cid:#x} set failed (rc={rc})")

    def _get(self, cid: int) -> Optional[int]:
        out = ctypes.c_int32()
        rc = self._src._lib.rcv_v4l2_get_ctrl(self._handle(), cid, ctypes.byref(out))
        return int(out.value) if rc == 0 else None

    # SensorControl (controls.rs:44-60)
    def set_exposure(self, exposure_us: Optional[int]) -> None:
        if exposure_us is None:
            self._set(CID_EXPOSURE_AUTO, EXPOSURE_APERTURE_PRIORITY)
        else:
            self._set(CID_EXPOSURE_AUTO, EXPOSURE_MANUAL)
            self._set(CID_EXPOSURE_ABSOLUTE, max(1, exposure_us // 100))

    def set_gain(self, gain: Optional[float]) -> None:
        if gain is not None:
            self._set(CID_GAIN, int(gain))

    # LensControl (controls.rs:84-105)
    def set_zoom(self, zoom: float) -> None:
        self._set(CID_ZOOM_ABSOLUTE, int(zoom))

    def set_focus(self, focus: Optional[int]) -> None:
        if focus is None:
            self._set(CID_FOCUS_AUTO, 1)
        else:
            self._set(CID_FOCUS_AUTO, 0)
            self._set(CID_FOCUS_ABSOLUTE, focus)

    # SystemControl
    def force_reset(self) -> None:
        """STREAMOFF → re-queue the whole ring → STREAMON on the same fd
        (clears wedged queues/sequence state). Faults that need full
        renegotiation (S_FMT/REQBUFS) go through the facade's
        stop→reopen path instead (mod.rs:115-147 semantics)."""
        self._src.stop()
        self._src.start()

    def set_trigger(self, config: TriggerConfig) -> None:
        from ..core.errors import SimulationError

        raise SimulationError("hardware trigger not supported on V4L2 UVC devices")

    def export_state(self) -> dict:
        # controls.rs:125-138: JSON snapshot of exposure/gain (None when the
        # device does not expose the control).
        return {
            "exposure_auto": self._get(CID_EXPOSURE_AUTO),
            "exposure_absolute": self._get(CID_EXPOSURE_ABSOLUTE),
            "gain": self._get(CID_GAIN),
            "zoom": self._get(CID_ZOOM_ABSOLUTE),
            "focus": self._get(CID_FOCUS_ABSOLUTE),
        }


def _make_controls(source: "V4L2Source") -> DeviceControls:
    ctl = _V4L2Controls(source)
    return DeviceControls(sensor=ctl, lens=ctl, system=ctl)


class V4L2Driver(Driver):
    """Driver over ``/dev/video*`` (Stack-A ``V4l2Driver`` semantics)."""

    device_prefix = "/dev/video"  # int index → "/dev/video{i}" (mod.rs:305)

    def list_devices(self) -> List[DeviceInfo]:
        out = []
        for path in list_video_devices():
            try:
                modes = enumerate_modes(path)
            except CameraError:
                continue  # metadata/output nodes etc.
            if not any(m.pixel_format != PixelFormat.OTHER for m in modes):
                # Stepwise/continuous-only or idle loopback nodes enumerate
                # zero usable discrete modes — opening them can never work,
                # and listing them would steal the default from simulation.
                continue
            out.append(DeviceInfo(id=path, name=path, driver="v4l2"))
        return out

    def open(
        self, device_id: str, config: CameraConfig
    ) -> Tuple[FrameSource, DeviceControls]:
        modes = enumerate_modes(device_id)
        modes = [m for m in modes if m.pixel_format != PixelFormat.OTHER]
        if not modes:
            raise FormatNotSupported(f"{device_id} exposes no supported formats")
        best = negotiate(config, modes)
        resolved = ResolvedConfig(
            width=best.width, height=best.height,
            fps=best.fps_options[0], pixel_format=best.pixel_format,
            buffer_count=config.buffer_count,
        )
        src = V4L2Source(device_id, resolved)
        return src, _make_controls(src)

    def open_simple(
        self, device_id: str, config: SimpleConfig
    ) -> Tuple[FrameSource, DeviceControls]:
        modes = [
            m for m in enumerate_modes(device_id)
            if m.pixel_format != PixelFormat.OTHER
        ]
        if not modes:
            raise FormatNotSupported(f"{device_id} exposes no supported formats")
        resolved = resolve(config, modes)
        src = V4L2Source(device_id, resolved)
        return src, _make_controls(src)
