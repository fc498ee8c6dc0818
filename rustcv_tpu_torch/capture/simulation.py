"""Deterministic simulation frame source (the PyTorch port's jax-free copy
of ``rustcv_tpu.capture.simulation``; raw frames are byte-identical, MJPEG
frames come from the port's own encoder instead of Pillow).

The reference only sketched simulation (empty ``rustcv-simulation`` crate,
``Stream::inject_frame`` unimplemented — ``rustcv-core/src/traits.rs:119-121``);
BASELINE configs all run on a synthetic source, so this module builds what the
reference left blank: a deterministic procedural camera whose frames are a
pure function of ``(width, height, pixel_format, sequence)``. Tests can
regenerate any frame independently and compare pipeline output pixel-exactly.

Pattern: SMPTE-style color bars + a seq-animated diagonal gradient + a moving
white square (motion for drop/latency eyeballing). Encoders to YUYV / UYVY / NV12 /
YV12 / GRAY8 / BGRA / RGB / BGR / Bayer / MJPEG are frozen integer specs
(forward BT.601:
``Y = ((66R+129G+25B+128)>>8)+16`` etc., chroma co-sited averaging).

Ring-buffer semantics mirror the V4L2 mmap ring
(``rustcv-camera/src/backend/linux/mod.rs:194-237``): ``next_frame`` requeues
the previous slot (invalidating its Frame — use-after-requeue raises) and
dequeues the next. In paced mode the sequence number advances with wall-clock
time like a real sensor, so a slow consumer sees sequence gaps — the drop
detection signal the reference benches rely on
(``rustcv-camera/benches/capture.rs:163-169``).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.config import CameraConfig, ResolvedConfig, SimpleConfig
from ..core.errors import (
    BandwidthExceeded,
    CameraError,
    DeviceNotFound,
    SimulationError,
    StreamNotStarted,
)
from ..core.frame import Frame, FrameMetadata, Timestamp
from ..core.pixel_format import PixelFormat
from ..core.telemetry import DeviceTelemetry
from ..core.time_sync import ClockSynchronizer

from .negotiate import negotiate, resolve
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
)

# ---------------------------------------------------------------------------
# Procedural pattern + encoders (frozen specs)
# ---------------------------------------------------------------------------

_BAR_COLORS_BGR = np.array(
    [  # SMPTE-ish: white, yellow, cyan, green, magenta, red, blue, black
        [235, 235, 235], [20, 235, 235], [235, 235, 20], [20, 235, 20],
        [235, 20, 235], [20, 20, 235], [235, 20, 20], [20, 20, 20],
    ],
    dtype=np.uint8,
)


def synth_bgr(width: int, height: int, seq: int) -> np.ndarray:
    """Deterministic BGR test pattern for frame ``seq`` (H, W, 3) u8."""
    ys = np.arange(height, dtype=np.int32)[:, None]
    xs = np.arange(width, dtype=np.int32)[None, :]

    # Color bars in the top 2/3
    bar = (xs * 8 // max(width, 1)).clip(0, 7)
    img = _BAR_COLORS_BGR[np.broadcast_to(bar, (height, width))].copy()

    # Bottom 1/3: seq-animated diagonal gradient
    grad = ((xs + ys[height * 2 // 3 :] + seq * 7) % 256).astype(np.uint8)
    img[height * 2 // 3 :, :, 0] = grad
    img[height * 2 // 3 :, :, 1] = 255 - grad
    img[height * 2 // 3 :, :, 2] = (grad.astype(np.int32) * 2 % 256).astype(np.uint8)

    # Moving white square (size ~ h/8) bouncing horizontally
    sq = max(4, height // 8)
    span = max(1, width - sq)
    pos = (seq * max(2, width // 64)) % (2 * span)
    x0 = pos if pos < span else 2 * span - pos
    y0 = max(0, height // 2 - sq // 2)
    img[y0 : y0 + sq, x0 : x0 + sq] = 255
    return img


def bgr_to_yuv_int(bgr: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Forward BT.601 integer (frozen): per-pixel Y, U, V int32 planes."""
    b = bgr[..., 0].astype(np.int32)
    g = bgr[..., 1].astype(np.int32)
    r = bgr[..., 2].astype(np.int32)
    y = ((66 * r + 129 * g + 25 * b + 128) >> 8) + 16
    u = ((-38 * r - 74 * g + 112 * b + 128) >> 8) + 128
    v = ((112 * r - 94 * g - 18 * b + 128) >> 8) + 128
    return np.clip(y, 0, 255), np.clip(u, 0, 255), np.clip(v, 0, 255)


def encode_yuyv(bgr: np.ndarray) -> np.ndarray:
    """BGR → packed YUYV; chroma = average of the pixel pair ((a+b+1)>>1)."""
    h, w = bgr.shape[:2]
    y, u, v = bgr_to_yuv_int(bgr)
    y = y.reshape(h, w // 2, 2)
    up = (u.reshape(h, w // 2, 2).sum(axis=-1) + 1) >> 1
    vp = (v.reshape(h, w // 2, 2).sum(axis=-1) + 1) >> 1
    out = np.empty((h, w // 2, 4), dtype=np.uint8)
    out[..., 0] = y[..., 0]
    out[..., 1] = up
    out[..., 2] = y[..., 1]
    out[..., 3] = vp
    return out.reshape(-1)


def encode_yv12(bgr: np.ndarray) -> np.ndarray:
    """BGR → YV12 (planar Y, V, U — V first); chroma = 2×2 average."""
    h, w = bgr.shape[:2]
    y, u, v = bgr_to_yuv_int(bgr)
    u4 = (u.reshape(h // 2, 2, w // 2, 2).sum(axis=(1, 3)) + 2) >> 2
    v4 = (v.reshape(h // 2, 2, w // 2, 2).sum(axis=(1, 3)) + 2) >> 2
    return np.concatenate(
        [y.astype(np.uint8).reshape(-1), v4.astype(np.uint8).reshape(-1),
         u4.astype(np.uint8).reshape(-1)]
    )


def encode_nv12(bgr: np.ndarray) -> np.ndarray:
    """BGR → NV12; chroma = 2×2 average ((Σ+2)>>2)."""
    h, w = bgr.shape[:2]
    y, u, v = bgr_to_yuv_int(bgr)
    u4 = u.reshape(h // 2, 2, w // 2, 2).sum(axis=(1, 3))
    v4 = v.reshape(h // 2, 2, w // 2, 2).sum(axis=(1, 3))
    uv = np.empty((h // 2, w // 2, 2), dtype=np.uint8)
    uv[..., 0] = (u4 + 2) >> 2
    uv[..., 1] = (v4 + 2) >> 2
    return np.concatenate([y.astype(np.uint8).reshape(-1), uv.reshape(-1)])


def encode_uyvy(bgr: np.ndarray) -> np.ndarray:
    """BGR → packed UYVY (chroma-first 4:2:2, same pair averaging)."""
    h, w = bgr.shape[:2]
    y, u, v = bgr_to_yuv_int(bgr)
    y = y.reshape(h, w // 2, 2)
    up = (u.reshape(h, w // 2, 2).sum(axis=-1) + 1) >> 1
    vp = (v.reshape(h, w // 2, 2).sum(axis=-1) + 1) >> 1
    out = np.empty((h, w // 2, 4), dtype=np.uint8)
    out[..., 0] = up
    out[..., 1] = y[..., 0]
    out[..., 2] = vp
    out[..., 3] = y[..., 1]
    return out.reshape(-1)


def encode_gray(bgr: np.ndarray) -> np.ndarray:
    """BGR → GRAY8 via the frozen integer luma ((77R+150G+29B+128)>>8)."""
    b = bgr[..., 0].astype(np.int32)
    g = bgr[..., 1].astype(np.int32)
    r = bgr[..., 2].astype(np.int32)
    return ((77 * r + 150 * g + 29 * b + 128) >> 8).astype(np.uint8).reshape(-1)


def encode_bgra(bgr: np.ndarray) -> np.ndarray:
    h, w = bgr.shape[:2]
    out = np.empty((h, w, 4), dtype=np.uint8)
    out[..., :3] = bgr
    out[..., 3] = 255
    return out.reshape(-1)


def encode_rgb(bgr: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(bgr[..., ::-1]).reshape(-1)


def encode_mjpeg(bgr: np.ndarray, quality: int = 90) -> np.ndarray:
    """BGR → baseline JFIF bytes, 4:2:0, by the port's own encoder (the
    numeric half on the CPU, then its C++ coder). The reference encodes with
    Pillow, so the bytes differ from its frames; both decode to the same
    picture within the codec's loss."""
    from ..ops.jpeg_encode import encode_jpeg

    return np.frombuffer(encode_jpeg(np.ascontiguousarray(bgr), quality, "4:2:0"), np.uint8)


def _bayer_encoder(pattern: str):
    """BGR → the raw mosaic of a ``pattern`` sensor, flat (the frozen spec
    ``ops.golden.mosaic_bayer``)."""
    def encode(bgr: np.ndarray) -> np.ndarray:
        from ..ops.golden import mosaic_bayer

        return mosaic_bayer(bgr, pattern).reshape(-1)

    return encode


_ENCODERS = {
    PixelFormat.YUYV: encode_yuyv,
    PixelFormat.UYVY: encode_uyvy,
    PixelFormat.GRAY8: encode_gray,
    PixelFormat.NV12: encode_nv12,
    PixelFormat.YV12: encode_yv12,
    PixelFormat.BGRA32: encode_bgra,
    PixelFormat.RGB24: encode_rgb,
    PixelFormat.BGR24: lambda bgr: np.ascontiguousarray(bgr).reshape(-1),
    PixelFormat.MJPEG: encode_mjpeg,
    PixelFormat.BAYER_BGGR: _bayer_encoder("BGGR"),
    PixelFormat.BAYER_GBRG: _bayer_encoder("GBRG"),
    PixelFormat.BAYER_GRBG: _bayer_encoder("GRBG"),
    PixelFormat.BAYER_RGGB: _bayer_encoder("RGGB"),
}


def synth_raw(width: int, height: int, fmt: PixelFormat, seq: int) -> np.ndarray:
    """Deterministic raw frame bytes for any supported format."""
    if fmt not in _ENCODERS:
        raise SimulationError(f"simulation cannot encode {fmt}")
    return _ENCODERS[fmt](synth_bgr(width, height, seq))


# ---------------------------------------------------------------------------
# Mode table (mirrors the reference's preset resolutions, bridge.m:236-241)
# ---------------------------------------------------------------------------

_DEFAULT_RESOLUTIONS = (
    # tiny modes (fast tests) + the reference's preset table (bridge.m:236-241)
    (64, 48), (160, 120), (352, 288), (640, 480), (1280, 720),
    (1920, 1080), (3840, 2160),
)
_DEFAULT_FORMATS = (
    PixelFormat.YUYV, PixelFormat.UYVY, PixelFormat.MJPEG,
    PixelFormat.NV12, PixelFormat.YV12,
    PixelFormat.BGRA32, PixelFormat.RGB24, PixelFormat.BGR24,
    PixelFormat.BAYER_RGGB, PixelFormat.BAYER_BGGR,
    PixelFormat.BAYER_GBRG, PixelFormat.BAYER_GRBG,
)
_DEFAULT_FPS = (30, 60, 120)


def default_modes() -> List[ModeDescriptor]:
    return [
        ModeDescriptor(fmt, w, h, _DEFAULT_FPS)
        for fmt in _DEFAULT_FORMATS
        for (w, h) in _DEFAULT_RESOLUTIONS
    ]


# ---------------------------------------------------------------------------
# The source
# ---------------------------------------------------------------------------


class SimulationSource(FrameSource):
    """A deterministic procedural camera stream.

    ``paced=True`` emulates sensor timing: sequence numbers track wall clock
    (slow consumers observe gaps = drops). ``paced=False`` free-runs at
    maximum rate with contiguous sequence numbers (bench mode).
    ``n_unique_frames > 0`` precomputes that many encoded frames and cycles
    them — removes host synthesis cost from throughput measurements, like a
    camera that DMAs at line rate regardless of scene content. A
    ``frame_cache`` dict (the driver's) shares the encoding between the
    sources of one configuration; each source still cycles its own read-only
    copy, as each camera DMAs into buffers of its own.
    """

    def __init__(
        self,
        resolved: ResolvedConfig,
        *,
        paced: bool = True,
        n_unique_frames: int = 0,
        start_seq: int = 0,
        frame_cache: Optional[Dict[tuple, List[np.ndarray]]] = None,
    ):
        self._cfg = resolved
        self._paced = paced
        self._seq = start_seq
        self._started = False
        self._start_time = 0.0
        self._clock = ClockSynchronizer(30)
        self._telemetry = DeviceTelemetry(link_throughput_mbps=0)
        self._last_seq: Optional[int] = None
        self._prev_frame: Optional[Frame] = None
        self._injected: List[Tuple[np.ndarray, PixelFormat, int, int]] = []
        self._lock = threading.Lock()
        self._trigger_mode = TriggerMode.FREE_RUN
        self._trigger_sem = threading.Semaphore(0)

        n_slots = max(2, resolved.buffer_count)
        self._cache: List[np.ndarray] = []
        if n_unique_frames > 0:
            cache = frame_cache if frame_cache is not None else {}
            key = (resolved.width, resolved.height, resolved.pixel_format, n_unique_frames)
            if key not in cache:
                cache[key] = [synth_raw(resolved.width, resolved.height, resolved.pixel_format, s)
                              for s in range(n_unique_frames)]
            # A copy costs far less than an encode, and keeps the memory a
            # gather reads per tick that of separate cameras.
            self._cache = [f.copy() for f in cache[key]]
            for f in self._cache:
                f.setflags(write=False)
        # Ring slots sized for the largest raw frame we may hold.
        self._slots: List[Optional[np.ndarray]] = [None] * n_slots
        self._slot_idx = 0

    # -- lifecycle ------------------------------------------------------

    def start(self) -> None:
        self._started = True
        self._start_time = time.monotonic()

    def stop(self) -> None:
        self._started = False
        if self._prev_frame is not None:
            self._prev_frame.invalidate()
            self._prev_frame = None

    def resolved_config(self) -> ResolvedConfig:
        return self._cfg

    # -- capture --------------------------------------------------------

    def _current_seq(self) -> int:
        if not self._paced:
            s = self._seq
            self._seq += 1
            return s
        elapsed = time.monotonic() - self._start_time
        seq = int(elapsed * self._cfg.fps)
        # Block until the next frame boundary (camera-rate bound, the analog
        # of the blocking DQBUF wait — camera.rs:107-112).
        if self._last_seq is not None and seq <= self._last_seq:
            next_due = self._start_time + (self._last_seq + 1) / self._cfg.fps
            delay = next_due - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            seq = self._last_seq + 1
        return seq

    def set_trigger_config(self, config: TriggerConfig) -> None:
        self._trigger_mode = config.mode

    def fire_trigger(self) -> None:
        """Software-trigger one frame (TriggerMode.SOFTWARE)."""
        self._trigger_sem.release()

    def next_frame(self) -> Frame:
        if not self._started:
            raise StreamNotStarted("call start() before next_frame()")

        triggered = False
        if self._trigger_mode == TriggerMode.SOFTWARE:
            # Gated capture: block until a software trigger fires
            # (TriggerConfig semantics, rustcv-core/src/traits.rs:27-90).
            if not self._trigger_sem.acquire(timeout=5.0):
                raise CameraError("software trigger timeout (no fire_trigger())")
            triggered = True

        # Requeue previous slot → its Frame becomes invalid.
        if self._prev_frame is not None:
            self._prev_frame.invalidate()

        with self._lock:
            if self._injected:
                data, fmt, w, h = self._injected.pop(0)
                seq = self._seq
                self._seq += 1
                hw_ns = int(seq * 1e9 / self._cfg.fps)
                ts = Timestamp(hw_ns, self._clock.correct(hw_ns))
                frame = Frame(data, w, h, fmt, seq, ts)
                self._prev_frame = frame
                return frame

        seq = self._current_seq()
        if self._last_seq is not None and seq > self._last_seq + 1:
            self._telemetry.dropped_frames += seq - self._last_seq - 1
        self._last_seq = seq

        if self._cache:
            raw = self._cache[seq % len(self._cache)]
        else:
            raw = synth_raw(self._cfg.width, self._cfg.height, self._cfg.pixel_format, seq)

        # Copy into the ring slot so the returned view aliases stable
        # storage (the mmap-slot analog); cached frames skip the copy and
        # alias the cache entry directly (it is immutable by contract).
        if self._cache:
            view = raw
        else:
            slot = self._slots[self._slot_idx]
            if slot is None or slot.shape != raw.shape:
                slot = raw.copy()
                self._slots[self._slot_idx] = slot
            else:
                np.copyto(slot, raw)
            view = slot
            self._slot_idx = (self._slot_idx + 1) % len(self._slots)

        hw_ns = int(seq * 1e9 / self._cfg.fps)
        ts = Timestamp(hw_ns, self._clock.correct(hw_ns))
        frame = Frame(
            view, self._cfg.width, self._cfg.height, self._cfg.pixel_format,
            seq, ts,
            metadata=FrameMetadata(
                exposure_us=10_000, gain=1.0, trigger_fired=triggered
            ),
        )
        self._prev_frame = frame
        return frame

    # -- simulation hooks (the part the reference left unimplemented) ----

    def inject_frame(self, data, pixel_format: PixelFormat, width: int, height: int) -> None:
        arr = np.asarray(data, dtype=np.uint8).reshape(-1)
        with self._lock:
            self._injected.append((arr, pixel_format, width, height))

    def telemetry(self) -> DeviceTelemetry:
        t = self._telemetry
        bpf = self._cfg.pixel_format.bpp_estimate() * self._cfg.width * self._cfg.height
        t.link_throughput_mbps = int(bpf * self._cfg.fps * 8 / 1e6)
        t.temperature_c = 45.0
        return t


# ---------------------------------------------------------------------------
# Controls (simulated)
# ---------------------------------------------------------------------------


class SimSensorControl(SensorControl):
    def __init__(self) -> None:
        self.exposure_us: Optional[int] = None  # None = auto
        self.gain: Optional[float] = None

    def set_exposure(self, exposure_us: Optional[int]) -> None:
        self.exposure_us = exposure_us

    def set_gain(self, gain: Optional[float]) -> None:
        self.gain = gain


class SimLensControl(LensControl):
    def __init__(self) -> None:
        self.zoom = 1.0
        self.focus: Optional[int] = None

    def set_zoom(self, zoom: float) -> None:
        self.zoom = zoom

    def set_focus(self, focus: Optional[int]) -> None:
        self.focus = focus


class SimSystemControl(SystemControl):
    def __init__(
        self,
        sensor: SimSensorControl,
        lens: SimLensControl,
        source: Optional[SimulationSource] = None,
    ):
        self._sensor = sensor
        self._lens = lens
        self._source = source
        self.trigger = TriggerConfig()
        self.reset_count = 0

    def force_reset(self) -> None:
        self.reset_count += 1
        self._sensor.exposure_us = None
        self._sensor.gain = None
        self._lens.zoom = 1.0
        self._lens.focus = None
        if self._source is not None:
            self._source.set_trigger_config(TriggerConfig())

    def set_trigger(self, config: TriggerConfig) -> None:
        self.trigger = config
        if self._source is not None:
            self._source.set_trigger_config(config)

    def fire_trigger(self) -> None:
        """Fire one software trigger (gates next_frame in SOFTWARE mode)."""
        if self._source is not None:
            self._source.fire_trigger()

    def export_state(self) -> Dict:
        """Settings snapshot (traits.rs:154-158 / v4l2 controls.rs:125-138)."""
        return {
            "exposure_us": self._sensor.exposure_us,
            "gain": self._sensor.gain,
            "zoom": self._lens.zoom,
            "focus": self._lens.focus,
            "trigger_mode": self.trigger.mode.value,
        }


# ---------------------------------------------------------------------------
# The driver
# ---------------------------------------------------------------------------


class SimulationDriver(Driver):
    """Enumerates N virtual cameras: ids ``sim:0`` … ``sim:{N-1}``."""

    def __init__(
        self,
        device_count: int = 8,
        modes: Optional[Sequence[ModeDescriptor]] = None,
        *,
        paced: bool = True,
        n_unique_frames: int = 0,
        bandwidth_limit_mbps: Optional[int] = None,
    ):
        self.device_count = device_count
        self.modes = list(modes) if modes is not None else default_modes()
        self.paced = paced
        self.n_unique_frames = n_unique_frames
        # Simulated link budget: opening a mode whose estimated throughput
        # exceeds it raises BandwidthExceeded with a structured suggestion
        # (the reference's error contract, rustcv-core/src/error.rs).
        self.bandwidth_limit_mbps = bandwidth_limit_mbps
        # The n_unique_frames frames per configuration, encoded once for
        # every source this driver opens (each source copies them).
        self._frames: Dict[tuple, List[np.ndarray]] = {}

    def _check_bandwidth(self, resolved: ResolvedConfig) -> None:
        if self.bandwidth_limit_mbps is None:
            return
        bpf = resolved.pixel_format.bpp_estimate() * resolved.width * resolved.height
        required = int(bpf * resolved.fps * 8 / 1e6)
        if required > self.bandwidth_limit_mbps:
            raise BandwidthExceeded(
                required, self.bandwidth_limit_mbps,
                suggestion="reduce resolution/fps or prefer MJPEG (compressed)",
            )

    def list_devices(self) -> List[DeviceInfo]:
        return [
            DeviceInfo(id=f"sim:{i}", name=f"Simulated Camera {i}", driver="simulation")
            for i in range(self.device_count)
        ]

    def _check_id(self, device_id: str) -> int:
        try:
            prefix, idx = device_id.split(":")
            i = int(idx)
            if prefix != "sim" or not (0 <= i < self.device_count):
                raise ValueError
        except ValueError:
            raise DeviceNotFound(device_id) from None
        return i

    def open(self, device_id: str, config: CameraConfig):
        i = self._check_id(device_id)
        mode = negotiate(config, self.modes)
        fps = 30
        if config.fps_req is not None:
            fps = min(mode.fps_options, key=lambda f: abs(f - config.fps_req[0]))
        resolved = ResolvedConfig(
            width=mode.width, height=mode.height, fps=fps,
            pixel_format=mode.pixel_format, buffer_count=config.buffer_count,
        )
        self._check_bandwidth(resolved)
        src = SimulationSource(
            resolved, paced=self.paced, n_unique_frames=self.n_unique_frames,
            start_seq=0, frame_cache=self._frames,
        )
        sensor = SimSensorControl()
        lens = SimLensControl()
        controls = DeviceControls(sensor, lens, SimSystemControl(sensor, lens, src))
        return src, controls

    def open_simple(self, device_id: str, config: SimpleConfig):
        """Stack-B open path: Option-based config + min-distance negotiation."""
        self._check_id(device_id)
        resolved = resolve(config, self.modes)
        self._check_bandwidth(resolved)
        src = SimulationSource(
            resolved, paced=self.paced, n_unique_frames=self.n_unique_frames,
            frame_cache=self._frames,
        )
        sensor = SimSensorControl()
        lens = SimLensControl()
        controls = DeviceControls(sensor, lens, SimSystemControl(sensor, lens, src))
        return src, controls
