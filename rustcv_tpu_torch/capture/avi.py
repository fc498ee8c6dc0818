"""MJPEG-AVI video file I/O — ``VideoWriter`` and a file-backed capture
driver, completing the OpenCV-style videoio surface (port of
``rustcv_tpu.capture.avi``; the container code is the reference's).

The reference captures only live cameras; OpenCV users also expect
``VideoWriter`` and ``VideoCapture("file.avi")``. MJPEG-in-AVI is the
natural container here because both halves reuse the device JPEG codec:

- **write**: frames encode through :mod:`rustcv_tpu_torch.ops.jpeg_encode`
  (FDCT where the frame is by default, on a CPU tensor for
  ``encoder="host"``, on the device for ``"tpu"`` → the port's host Huffman
  coder) and land in a standard RIFF-AVI ('MJPG') any player/OpenCV build
  can read.
- **read**: :class:`FileSource` emits the stored JPEG bytes as
  ``PixelFormat.MJPEG`` frames through the standard ``FrameSource``
  protocol, so the whole stack — ``VideoCapture`` facade AND the batched
  ``MultiStreamEngine`` hybrid path (host entropy decode → device IDCT) —
  consumes video files exactly like cameras.

Container details: RIFF('AVI ') → LIST hdrl (avih + strl(strh 'vids'/'MJPG'
+ strf BITMAPINFOHEADER)) → LIST movi ('00dc' chunks, even-padded) → idx1.
Single video stream, no audio, no OpenDML extensions (files < 2 GiB).
"""

from __future__ import annotations

import io
import os
import struct
import threading
import time
from typing import List, Optional, Tuple

import numpy as np

from ..core.config import CameraConfig, ResolvedConfig
from ..core.errors import CameraError, DecodeError, DeviceNotFound, EndOfStream
from ..core.frame import Frame, Timestamp
from ..core.mat import Mat
from ..core.pixel_format import PixelFormat
from .source import DeviceControls, DeviceInfo, Driver, FrameSource


def _fourcc(s: str) -> bytes:
    return s.encode("ascii")


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------


class VideoWriter:
    """OpenCV-style video writer (MJPEG-in-AVI).

    ``VideoWriter(path, fourcc="MJPG", fps=30, frame_size=(w, h))`` then
    ``write(mat_or_bgr_array)`` per frame and ``release()`` (or use as a
    context manager). By default each frame encodes where it is: on its
    device for a CUDA tensor or a device Mat, on the CPU for a host frame.
    ``encoder="host"`` (the reference's default, Pillow there) encodes every
    frame on a CPU tensor; the bytes differ from Pillow's, the decoded
    frames agree within the encoder's tolerance. ``encoder="tpu"`` (the
    reference's name) uploads host frames to ``device`` and encodes there.
    The Huffman coding is the port's C++ coder's in each case. For device-resident
    batches, encode with :func:`rustcv_tpu_torch.ops.jpeg_encode.encode_jpeg_batch`
    and append the payloads with :meth:`write_encoded`.
    """

    def __init__(
        self,
        path: str,
        fourcc: str = "MJPG",
        fps: float = 30.0,
        frame_size: Tuple[int, int] = (640, 480),
        quality: int = 90,
        encoder: Optional[str] = None,
        device="cuda",
    ):
        if encoder not in (None, "host", "tpu"):
            raise ValueError(f"VideoWriter: unknown encoder {encoder!r}")
        self._encoder = encoder
        if fourcc.upper() != "MJPG":
            raise CameraError(
                f"VideoWriter: only MJPG is supported, got {fourcc!r}"
            )
        if fps <= 0 or frame_size[0] <= 0 or frame_size[1] <= 0:
            raise CameraError("VideoWriter: fps and frame_size must be positive")
        self._w, self._h = int(frame_size[0]), int(frame_size[1])
        self._fps = float(fps)
        self._quality = int(quality)
        self._device = device
        self._f = open(path, "wb")
        self._index: List[Tuple[int, int]] = []  # (offset-in-movi, size)
        self._lock = threading.Lock()
        self._closed = False
        self._write_headers(nframes=0)  # placeholders; patched on release
        self._movi_start = self._f.tell()  # just after 'movi' fourcc

    # -- container plumbing ------------------------------------------------

    def _write_headers(self, nframes: int) -> None:
        f = self._f
        w, h = self._w, self._h
        us_per_frame = int(round(1_000_000 / self._fps))
        buf = io.BytesIO()
        # avih — MainAVIHeader (56 bytes)
        buf.write(_fourcc("avih") + struct.pack("<I", 56))
        buf.write(
            struct.pack(
                "<14I",
                us_per_frame, 0, 0, 0x10,  # AVIF_HASINDEX
                nframes, 0, 1, 0, w, h, 0, 0, 0, 0,
            )
        )
        # strl = strh + strf
        strh_body = _fourcc("vids") + _fourcc("MJPG") + struct.pack(
            "<IHHIIIIIIiI",
            0,  # dwFlags
            0, 0,  # wPriority, wLanguage
            0,  # dwInitialFrames
            1000, int(round(self._fps * 1000)),  # dwScale/dwRate → fps
            0,  # dwStart
            nframes,  # dwLength
            0,  # dwSuggestedBufferSize
            -1,  # dwQuality (default)
            0,  # dwSampleSize
        ) + struct.pack("<4H", 0, 0, w, h)  # rcFrame
        strh = _fourcc("strh") + struct.pack("<I", 56) + strh_body
        strf = _fourcc("strf") + struct.pack("<I", 40)
        strf += struct.pack(
            "<IiiHH4sIiiII", 40, w, h, 1, 24, _fourcc("MJPG"),
            w * h * 3, 0, 0, 0, 0,
        )
        strl = _fourcc("LIST") + struct.pack("<I", 4 + len(strh) + len(strf))
        strl += _fourcc("strl") + strh + strf
        hdrl_body = buf.getvalue() + strl
        f.seek(0)
        f.write(_fourcc("RIFF") + struct.pack("<I", 0) + _fourcc("AVI "))
        f.write(_fourcc("LIST") + struct.pack("<I", 4 + len(hdrl_body)))
        f.write(_fourcc("hdrl") + hdrl_body)
        f.write(_fourcc("LIST") + struct.pack("<I", 0) + _fourcc("movi"))

    def write_encoded(self, jpeg_bytes: bytes) -> None:
        """Append one already-encoded JPEG frame (must match frame_size)."""
        if self._closed:
            raise CameraError("VideoWriter: already released")
        with self._lock:
            off = self._f.tell() - self._movi_start + 4
            size = len(jpeg_bytes)
            self._f.write(_fourcc("00dc") + struct.pack("<I", size))
            self._f.write(jpeg_bytes)
            if size % 2:
                self._f.write(b"\x00")
            self._index.append((off, size))

    def write(self, frame) -> None:
        """Encode + append one frame: Mat, (H, W, 3) BGR, or (H, W) gray
        uint8 array or tensor (gray frames become grayscale JPEG chunks)."""
        import torch

        from ..core.mat import torch_device
        from ..ops.jpeg_encode import encode_jpeg

        if isinstance(frame, Mat):
            bgr = frame.device() if frame.is_on_device else torch.from_numpy(frame.to_numpy())
            if bgr.ndim == 3 and bgr.shape[-1] == 1:  # a gray Mat
                bgr = bgr[..., 0]
        else:
            bgr = torch.as_tensor(frame)
        if tuple(bgr.shape[:2]) != (self._h, self._w):
            raise CameraError(
                f"VideoWriter: frame is {bgr.shape[1]}x{bgr.shape[0]}, "
                f"writer was opened for {self._w}x{self._h}"
            )
        if self._encoder == "host":
            bgr = bgr.cpu()
        elif self._encoder == "tpu" and bgr.device.type == "cpu":
            bgr = bgr.to(torch_device(self._device))
        self.write_encoded(encode_jpeg(bgr, quality=self._quality))

    @property
    def frame_count(self) -> int:
        return len(self._index)

    def is_opened(self) -> bool:
        return not self._closed

    def release(self) -> None:
        """Finalize the index and all size fields, close the file."""
        if self._closed:
            return
        with self._lock:
            self._closed = True
            f = self._f
            movi_end = f.tell()
            # idx1
            f.write(_fourcc("idx1") + struct.pack("<I", 16 * len(self._index)))
            for off, size in self._index:
                f.write(
                    _fourcc("00dc") + struct.pack("<III", 0x10, off, size)
                )
            riff_end = f.tell()
            # Re-write headers with the real frame count FIRST (identical
            # layout; it also re-emits the placeholder movi/RIFF sizes)...
            self._write_headers(nframes=len(self._index))
            # ...then patch the sizes so they win.
            f.seek(self._movi_start - 8)  # movi LIST size field
            f.write(struct.pack("<I", movi_end - self._movi_start + 4))
            f.seek(4)  # RIFF size
            f.write(struct.pack("<I", riff_end - 8))
            f.close()

    def __enter__(self) -> "VideoWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.release()


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------


class AviMjpegReader:
    """Minimal robust RIFF-AVI parser: geometry + per-frame JPEG payloads.

    Accepts any single-video-stream MJPG AVI (ours or third-party); scans
    the movi list sequentially ('00dc'/'00db' chunks), so files with
    missing or lying idx1 indexes still read. Every size field is bounds-
    checked against the buffer — malformed files raise ``DecodeError``.
    """

    def __init__(self, path: str):
        if not os.path.exists(path):
            raise DeviceNotFound(f"no such video file: {path}")
        with open(path, "rb") as f:
            self._buf = f.read()
        b = self._buf
        if len(b) < 12 or b[:4] != b"RIFF" or b[8:12] != b"AVI ":
            raise DecodeError(f"{path}: not a RIFF AVI file")
        self.width = 0
        self.height = 0
        self.fps = 30.0
        self.declared_frames = 0
        self.frames: List[Tuple[int, int]] = []  # (offset, size) of JPEG bytes
        self._parse()

    def _u32(self, p: int) -> int:
        return struct.unpack_from("<I", self._buf, p)[0]

    def _parse(self) -> None:
        b = self._buf
        p, end = 12, len(b)
        while p + 8 <= end:
            tag = b[p : p + 4]
            size = self._u32(p + 4)
            body = p + 8
            if body + size > end:
                size = end - body  # tolerate truncated final chunk
            if tag == b"LIST" and size >= 4:
                kind = b[body : body + 4]
                if kind in (b"hdrl", b"movi"):
                    self._parse_list(body + 4, body + size, kind)
            p = body + size + (size % 2)

    def _parse_list(self, p: int, end: int, kind: bytes) -> None:
        b = self._buf
        while p + 8 <= end:
            tag = b[p : p + 4]
            size = self._u32(p + 4)
            body = p + 8
            if body + size > end:
                size = max(0, end - body)
            if kind == b"hdrl":
                if tag == b"avih" and size >= 40:
                    us_pf = self._u32(body)
                    if us_pf:
                        self.fps = 1_000_000 / us_pf
                    self.declared_frames = self._u32(body + 16)
                    self.width = self._u32(body + 32)
                    self.height = self._u32(body + 36)
                elif tag == b"LIST" and size >= 4:
                    self._parse_list(body + 4, body + size, b"hdrl")
            else:  # movi
                if tag[2:4] in (b"dc", b"db") and size > 0:
                    self.frames.append((body, size))
                elif tag == b"LIST" and size >= 4:  # 'rec ' groups
                    self._parse_list(body + 4, body + size, b"movi")
            p = body + size + (size % 2)

    def __len__(self) -> int:
        return len(self.frames)

    def frame_bytes(self, i: int) -> np.ndarray:
        """Zero-copy uint8 view of frame i's JPEG payload."""
        off, size = self.frames[i]
        return np.frombuffer(self._buf, np.uint8, count=size, offset=off)


# ---------------------------------------------------------------------------
# FrameSource / Driver integration
# ---------------------------------------------------------------------------


class FileSource(FrameSource):
    """A video file as a ``FrameSource``: emits stored JPEG payloads as
    ``PixelFormat.MJPEG`` frames (decode happens downstream exactly like a
    live MJPEG camera — the hybrid decode in the port).

    ``paced=True`` sleeps to the container fps (a real-time playback
    source); default is as-fast-as-possible (offline processing). ``loop``
    wraps around instead of ending the stream.
    """

    def __init__(
        self,
        path: str,
        paced: bool = False,
        loop: bool = False,
        reader: Optional[AviMjpegReader] = None,
    ):
        # A shared reader avoids N copies of the file bytes when N sources
        # read the same clip (the reader is immutable after parse; each
        # source keeps only its own cursor).
        self._reader = reader if reader is not None else AviMjpegReader(path)
        if not self._reader.frames:
            raise DecodeError(f"{path}: no video frames found")
        self._paced = paced
        self._loop = loop
        self._pos = 0
        self._seq = 0
        self._started = False
        self._t0 = None
        self._pace_base = 0
        self._last_frame: Optional[Frame] = None

    def start(self) -> None:
        self._started = True
        self._t0 = time.monotonic()
        # Pacing restarts from the CURRENT position: without this, a
        # stop()/start() cycle would stall ~_seq/fps seconds.
        self._pace_base = self._seq

    def stop(self) -> None:
        self._started = False

    def rewind(self) -> None:
        self._pos = 0

    def seek(self, frame_index: int) -> None:
        """Position the stream at ``frame_index`` (0-based; the next
        ``next_frame`` returns it). Out-of-range indexes behave like EOF
        (or wrap when looping)."""
        if frame_index < 0:
            raise ValueError(f"seek: negative frame index {frame_index}")
        self._pos = int(frame_index)

    @property
    def position(self) -> int:
        return self._pos

    @property
    def frame_count(self) -> int:
        return len(self._reader)

    def next_frame(self) -> Frame:
        from ..core.errors import StreamNotStarted

        if not self._started:
            raise StreamNotStarted("FileSource: start() first")
        if self._pos >= len(self._reader):
            if not self._loop:
                raise EndOfStream(
                    f"end of video ({len(self._reader)} frames)"
                )
            self._pos = 0
        if self._last_frame is not None:
            self._last_frame.invalidate()
        if self._paced:
            due = self._t0 + (self._seq - self._pace_base) / max(self._reader.fps, 1e-6)
            delay = due - time.monotonic()
            if delay > 0:
                time.sleep(delay)
        data = self._reader.frame_bytes(self._pos)
        hw_ns = int(self._seq / max(self._reader.fps, 1e-6) * 1e9)
        frame = Frame(
            data,
            self._reader.width,
            self._reader.height,
            PixelFormat.MJPEG,
            self._seq,
            Timestamp(hw_ns, hw_ns / 1e9),
        )
        self._pos += 1
        self._seq += 1
        self._last_frame = frame
        return frame

    def resolved_config(self) -> ResolvedConfig:
        return ResolvedConfig(
            width=self._reader.width,
            height=self._reader.height,
            fps=int(round(self._reader.fps)),
            pixel_format=PixelFormat.MJPEG,
            buffer_count=1,
        )


class FileDriver(Driver):
    """Driver over video files: the device id IS the path. Opening the same
    path N times yields N independent sources (batch processing a file
    across engine streams). A constructor ``path`` serves as the default
    for non-path ids (the batched engine opens streams as ``sim:{i}``)."""

    device_prefix = ""

    def __init__(
        self, path: Optional[str] = None, paced: bool = False, loop: bool = False
    ):
        self._path = path
        self._paced = paced
        self._loop = loop
        self._readers: dict = {}  # path → shared AviMjpegReader (one copy)

    def list_devices(self) -> List[DeviceInfo]:
        if self._path:
            return [DeviceInfo(id=self._path, name=os.path.basename(self._path), driver="file")]
        return []  # files aren't enumerable; open by path

    def open(self, device_id: str, config: CameraConfig):
        path = device_id if os.path.isfile(device_id) else self._path
        if not path:
            raise DeviceNotFound(f"no such video file: {device_id}")
        reader = self._readers.get(path)
        if reader is None:
            reader = AviMjpegReader(path)
            self._readers[path] = reader
        src = FileSource(path, paced=self._paced, loop=self._loop, reader=reader)
        return src, DeviceControls()


def is_video_file(path) -> bool:
    """True when ``path`` names an existing AVI file (VideoCapture's
    string-argument routing test)."""
    return (
        isinstance(path, str)
        and path.lower().endswith(".avi")
        and os.path.isfile(path)
    )
