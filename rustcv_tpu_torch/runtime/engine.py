"""MultiStreamEngine — batched execution of N simulated capture streams on
one CUDA device (port of ``rustcv_tpu.runtime.engine``, the device-sim path).

Each tick synthesizes every stream's wire-format frame on the device from
its sequence number (:mod:`rustcv_tpu_torch.ops.synth`), runs the pipeline
of :mod:`.pipeline` on the batch, and advances the stream clock on the
device: the next sequence numbers are an output that the next tick takes
as input, and the overlay arguments are cached by content, so a steady
tick uploads nothing.

The engine takes an explicit ``device`` (``"cuda"`` by default, which
raises where CUDA is absent; tests pass ``"cpu"``). Its snapshot
(:meth:`export_state` / :meth:`from_state`) has the reference engine's
keys, so a stream clock continues across the two packages tick for tick.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import native
from ..capture.source import Driver, FrameSource
from ..core.config import ResolvedConfig, SimpleConfig
from ..core.errors import CameraError
from ..core.pixel_format import PixelFormat
from ..ops import jpeg_encode as _jenc
from ..ops import synth as _synth
from .pipeline import PipelineSpec, get_pipeline, make_dummy_overlay, not_ported

_ENC_KEYS = ("enc_y", "enc_cb", "enc_cr")  # the dense coefficient rows, per component


@dataclass
class TickResult:
    """Outputs of one engine tick (device tensors unless fetched)."""

    outputs: Dict[str, torch.Tensor]
    sequences: np.ndarray  # [N] per-stream frame sequence numbers
    tick_index: int

    def numpy(self, key: str = "bgr") -> np.ndarray:
        out = self.outputs[key].cpu().numpy()
        if key == "bgr" and out.ndim == 3:
            # Packed rows (N, H, W*3) → user-facing (N, H, W, 3)
            n, h, w3 = out.shape
            out = out.reshape(n, h, w3 // 3, 3)
        return out


@dataclass
class EngineStats:
    ticks: int = 0
    frames: int = 0
    wall_s: float = 0.0
    p50_latency_ms: float = 0.0
    p99_latency_ms: float = 0.0
    host_gather_ms: float = 0.0
    dropped_frames: int = 0
    latencies_ms: List[float] = field(default_factory=list)

    @property
    def fps_total(self) -> float:
        return self.frames / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def fps_per_stream(self) -> float:
        return self.ticks / self.wall_s if self.wall_s > 0 else 0.0


class MultiStreamEngine:
    """Own N sources; run the batched pipeline once per tick."""

    def __init__(
        self,
        driver: Driver,
        n_streams: int,
        config: SimpleConfig,
        *,
        filter: str = "none",
        resize_to=None,
        overlay: bool = False,
        emit_bgr: bool = True,
        mesh=None,
        device_sim: bool = False,
        stencil_impl: Optional[str] = None,
        encode_jpeg_quality: int = 0,
        encode_subsampling: str = "4:2:0",
        encode_packed: Optional[bool] = None,
        sub_batch: Optional[int] = None,
        device="cuda",
    ):
        """``device_sim=True`` synthesizes frames on the device — the only
        path ported so far. ``sub_batch`` runs the stream batch as chunks of
        that size, one after another, writing into preallocated outputs
        (must divide ``n_streams``). ``stencil_impl=None`` picks the stencil
        kernel on a CUDA device and the plain chain on the CPU.

        ``encode_jpeg_quality > 0`` adds the JPEG encoder's numeric half to
        every tick (after the overlay), which :meth:`encode_payloads`,
        :meth:`stream_encoded` and :meth:`run_encoded` finish into one JFIF
        per stream with the host coder. ``encode_packed`` (default: when the
        native coder is available) block-packs the coefficients on the
        device with the reference's K = 10 slots per block and
        ``min(blocks, max(128, blocks // 16))`` dense rows."""
        if n_streams < 1:
            raise ValueError("n_streams must be >= 1")
        if not device_sim:
            raise not_ported("the host-staged engine path (device_sim=False)")
        if mesh is not None:
            raise not_ported("mesh (multi-device) execution")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but torch.cuda.is_available() is False")
        self.n = n_streams
        self._driver = driver
        self._sources: List[FrameSource] = []
        self._open_all(config)

        rc = self._sources[0].resolved_config()
        self._resolved = rc
        if rc.pixel_format == PixelFormat.MJPEG:
            raise CameraError("device_sim does not support MJPEG streams")
        if stencil_impl is None:
            stencil_impl = "pallas" if self.device.type == "cuda" else "xla"
        pack_k = pack_cap = 0
        if int(encode_jpeg_quality) > 0:
            if encode_packed is None:
                encode_packed = native.available()
            if encode_packed:
                dw, dh = resize_to if resize_to is not None else (rc.width, rc.height)
                nbt = sum(bh * bw for bh, bw in
                          _jenc._geometry(dw, dh, encode_subsampling)["blocks"])
                pack_k = 10
                pack_cap = min(nbt, max(128, nbt // 16))
        self.spec = PipelineSpec(
            pixel_format=rc.pixel_format,
            width=rc.width,
            height=rc.height,
            resize_to=resize_to,
            filter=filter,
            overlay=overlay,
            emit_bgr=emit_bgr,
            stencil_impl=stencil_impl,
            encode_jpeg=int(encode_jpeg_quality),
            encode_subsampling=encode_subsampling,
            encode_packed=pack_k,
            encode_dense_cap=pack_cap,
        )
        self._fn = get_pipeline(self.spec)
        # Ticks whose busy blocks overflowed the dense rows, so their
        # payloads were coded from the dense coefficient grids instead.
        self.encode_dense_fallbacks = 0
        self._lock = threading.Lock()  # the count above and the pools below
        self._encode_pool: Optional[ThreadPoolExecutor] = None  # the coder, per stream
        self._fetch_pool: Optional[ThreadPoolExecutor] = None  # finishes ticks in turn
        self._side_stream = None  # CUDA stream of the over-capacity copies
        if sub_batch is not None:
            if n_streams % sub_batch:
                raise ValueError(f"sub_batch={sub_batch} must divide n_streams={n_streams}")
            if sub_batch == n_streams:
                sub_batch = None  # monolithic anyway
        self._sub_batch = sub_batch
        self._seqs = np.zeros(self.n, np.int64)
        self._seqs_dev = None
        self._overlay_cache = None  # (content key, device args)
        self._sim_t0 = time.monotonic()
        self._frame_pool = None
        pool_k = getattr(self._driver, "n_unique_frames", 0)
        if pool_k > 0:
            # K wire-format frames made once on the device; ticks gather
            # from the pool like a camera's DMA ring.
            self._frame_pool = _synth.synth_raw(
                torch.arange(pool_k, dtype=torch.int32, device=self.device),
                rc.width, rc.height, rc.pixel_format,
            )
        self._tick_index = 0

    def _one_tick(self, seqs, rects, colors, thickness):
        spec = self.spec
        if self._frame_pool is not None:
            idx = torch.remainder(seqs, self._frame_pool.shape[0]).long()
            raw = self._frame_pool.index_select(0, idx)
        else:
            raw = _synth.synth_raw(seqs, spec.width, spec.height, spec.pixel_format)
        return self._fn(raw, rects, colors, thickness)

    def _sim_tick(self, seqs, rects, colors, thickness):
        """synth → pipeline → clock for the whole batch, in chunks of
        ``sub_batch`` streams when set."""
        sub = self._sub_batch
        if sub is None:
            out = self._one_tick(seqs, rects, colors, thickness)
        else:
            out = {}
            for lo in range(0, self.n, sub):
                part = self._one_tick(seqs[lo:lo + sub], rects[lo:lo + sub],
                                      colors[lo:lo + sub], thickness)
                for key, v in part.items():
                    if key == "_sync":
                        continue
                    if key not in out:
                        out[key] = torch.empty((self.n, *v.shape[1:]), dtype=v.dtype,
                                               device=v.device)
                    out[key][lo:lo + sub].copy_(v)
            out["_sync"] = next(iter(out.values())).reshape(-1)[:1]  # the pipeline's probe
        # Self-advancing stream clock: the next tick takes this as input.
        out["_next_seqs"] = seqs + 1
        return out

    # ------------------------------------------------------------------

    def _open_all(self, config: SimpleConfig) -> None:
        for s in self._sources:
            s.stop()
        self._sources = []
        for i in range(self.n):
            src, _ = self._driver.open_simple(f"sim:{i}", config)
            src.start()
            self._sources.append(src)
        # Homogeneous-batch invariant: one shape bucket per engine.
        cfgs = {
            (s.resolved_config().width, s.resolved_config().height,
             s.resolved_config().pixel_format)
            for s in self._sources
        }
        if len(cfgs) != 1:
            raise CameraError(f"streams negotiated heterogeneous configs: {cfgs}")

    @property
    def resolved_config(self) -> ResolvedConfig:
        return self._resolved

    @property
    def sources(self) -> Sequence[FrameSource]:
        return tuple(self._sources)

    # ------------------------------------------------------------------

    def _overlay_args(self, rects, rect_colors, thickness):
        """Device overlay args, cached by CONTENT (an id() key could serve
        stale rects once a caller's array is freed and its id reused)."""
        if not self.spec.overlay:
            if self._overlay_cache is None or self._overlay_cache[0] != "dummy":
                self._overlay_cache = ("dummy", make_dummy_overlay(self.n, self.device))
            return self._overlay_cache[1]
        key = (
            None if rects is None else np.asarray(rects).tobytes(),
            None if rect_colors is None else np.asarray(rect_colors).tobytes(),
            thickness,
        )
        if self._overlay_cache is None or self._overlay_cache[0] != key:
            r = np.zeros((self.n, 4), np.int32) if rects is None else rects
            c = np.zeros((self.n, 3), np.uint8) if rect_colors is None else rect_colors
            r = np.array(np.broadcast_to(np.asarray(r).astype(np.int32), (self.n, 4)))
            c = np.array(np.broadcast_to(np.asarray(c).astype(np.uint8), (self.n, 3)))
            args = (torch.from_numpy(r).to(self.device), torch.from_numpy(c).to(self.device),
                    int(thickness))
            self._overlay_cache = (key, args)
        return self._overlay_cache[1]

    def tick(
        self,
        rects: Optional[np.ndarray] = None,
        rect_colors: Optional[np.ndarray] = None,
        thickness: int = 2,
        block: bool = False,
        text: Optional[str] = None,
    ) -> TickResult:
        """One batched step. ``block=False`` leaves the outputs in flight on
        the device's stream; ``block=True`` waits for them by fetching the
        one-element ``_sync`` output.

        Overlay args are cached by content: a changed value is uploaded
        again, an unchanged one costs no transfer."""
        if text is not None:
            raise not_ported("text overlay (text=)")
        paced = getattr(self._driver, "paced", False)
        if paced:
            # Sensor-timed sequences: the wall clock drives seq, so a slow
            # consumer sees gaps (drop semantics kept on the device path).
            seq_now = int((time.monotonic() - self._sim_t0) * self._resolved.fps)
            seqs = np.maximum(self._seqs, seq_now)
            self._seqs_dev = None  # clock jumped: must upload
        else:
            seqs = self._seqs.copy()
        if self._seqs_dev is not None:
            x = self._seqs_dev  # device-resident, fed back from the last tick
        else:
            x = torch.from_numpy(seqs.astype(np.int32)).to(self.device)
        self._seqs = seqs + 1

        r, c, th = self._overlay_args(rects, rect_colors, thickness)
        out = self._sim_tick(x, r, c, th)
        self._seqs_dev = out["_next_seqs"]
        if block:
            out["_sync"].cpu()  # a device→host copy waits for the tick
        res = TickResult(out, seqs, self._tick_index)
        self._tick_index += 1
        return res

    def run(
        self,
        n_ticks: int,
        *,
        warmup: int = 3,
        measure_latency: bool = True,
        rects: Optional[np.ndarray] = None,
        rect_colors: Optional[np.ndarray] = None,
    ) -> EngineStats:
        """Sustained throughput + latency harness: FPS, P50/P99 tick latency
        (host clock around a blocking tick) and dropped frames."""
        stats = EngineStats()
        for _ in range(warmup):
            self.tick(rects=rects, rect_colors=rect_colors, block=True)

        lat: List[float] = []
        first = None
        res = None
        t0 = time.perf_counter()
        for _ in range(n_ticks):
            t_s = time.perf_counter()
            res = self.tick(rects=rects, rect_colors=rect_colors, block=measure_latency)
            if measure_latency:
                lat.append((time.perf_counter() - t_s) * 1e3)
            if first is None:
                first = res.sequences
        if res is not None:
            # One stream runs the ticks in order: the last tick's token
            # bounds the whole run.
            res.outputs["_sync"].cpu()
        wall = time.perf_counter() - t0

        stats.ticks = n_ticks
        stats.frames = n_ticks * self.n
        stats.wall_s = wall
        if lat:
            stats.latencies_ms = lat
            stats.p50_latency_ms = float(np.percentile(lat, 50))
            stats.p99_latency_ms = float(np.percentile(lat, 99))
        if res is not None:
            # A paced clock skips the sequences a slow consumer missed.
            expected = int((res.sequences - first + 1).sum())
            stats.dropped_frames = max(0, expected - stats.frames)
        return stats

    # -- JPEG transcode delivery -----------------------------------------

    def _require_encode(self) -> None:
        if not self.spec.encode_jpeg:
            raise CameraError("engine was built without encode_jpeg_quality; no transcode outputs")

    def _pool(self, attr: str, workers: int, prefix: str) -> ThreadPoolExecutor:
        with self._lock:
            if getattr(self, attr) is None:
                setattr(self, attr, ThreadPoolExecutor(max_workers=workers,
                                                       thread_name_prefix=prefix))
            return getattr(self, attr)

    def _count_fallback(self) -> None:
        with self._lock:
            self.encode_dense_fallbacks += 1

    def encode_payloads(self, res: TickResult) -> List[bytes]:
        """Finish a tick's JPEG transcode: one JFIF byte string per stream.

        Fetches the block-packed coefficients (the dense grids without
        packing, or on a tick whose busy blocks overflow the dense rows)
        and runs the host Huffman coder per stream; waits for the tick."""
        self._require_encode()
        out = res.outputs
        if self.spec.encode_packed:
            if (out["enc_ndense"].cpu().numpy() <= self.spec.encode_dense_cap).all():
                return self._encode_from_host_packed(*(
                    out[k].cpu().numpy()
                    for k in ("enc_idx", "enc_val", "enc_dense_ids", "enc_dense_rows")))
            self._count_fallback()
        return self._encode_from_host(*(out[k].cpu().numpy() for k in _ENC_KEYS))

    def _enc_geometry(self):
        dw, dh = self.spec.resize_to or (self.spec.width, self.spec.height)
        g = _jenc._geometry(dw, dh, self.spec.encode_subsampling)
        qy, qc = _jenc.quant_tables(self.spec.encode_jpeg)
        return dw, dh, g, qy, qc

    def _encode_pool_map(self, fn) -> List[bytes]:
        """``fn`` over the streams; the ctypes coder releases the GIL, so
        streams are coded in parallel on a pool of up to 8 threads."""
        if self.n == 1:
            return [fn(0)]
        pool = self._pool("_encode_pool", min(8, self.n), "rustcv-encode")
        return list(pool.map(fn, range(self.n)))

    def _encode_from_host_packed(self, idx, val, dense_ids, dense_rows) -> List[bytes]:
        """Host Huffman coding straight from the packed slot and dense rows."""
        dw, dh, g, qy, qc = self._enc_geometry()
        return self._encode_pool_map(lambda i: native.jpeg_entropy_encode_packed(
            idx[i], val[i], dense_ids[i], dense_rows[i],
            g["blocks"], [qy, qc, qc], dw, dh, g["h_samp"], g["v_samp"]))

    def _encode_from_host(self, cy, cb, cr) -> List[bytes]:
        """Host Huffman coding of fetched dense coefficient rows."""
        dw, dh, g, qy, qc = self._enc_geometry()
        return self._encode_pool_map(lambda i: native.jpeg_entropy_encode(
            [arr[i].reshape(*g["blocks"][c], 64) for c, arr in enumerate((cy, cb, cr))],
            [qy, qc, qc], dw, dh, g["h_samp"], g["v_samp"]))

    def _copy_out(self, res: TickResult, keys, ring: list, slot: int):
        """Start the device→host copy of ``res``'s ``keys`` into the pinned
        buffers ``ring[slot]`` (made at first use) and record a CUDA event
        after it; returns (host tensors, event). On the CPU the outputs are
        the host tensors and there is no event."""
        outs = [res.outputs[key] for key in keys]
        if self.device.type != "cuda":
            return outs, None
        if len(ring) <= slot:
            ring.append([torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in outs])
        stream = torch.cuda.current_stream(self.device)
        for host, t in zip(ring[slot], outs):
            host.copy_(t, non_blocking=True)
        event = torch.cuda.Event()
        event.record(stream)
        return ring[slot], event

    def _finish_encoded(self, res: TickResult, hosts, event) -> List[bytes]:
        """Wait for one tick's copy (its event only) and code its payloads."""
        if event is not None:
            event.synchronize()
        vals = [h.numpy() for h in hosts]
        if self.spec.encode_packed:
            idx, val, ids, rows, nd = _jenc.split_blob(
                vals[0], res.outputs["enc_idx"].shape[-2], self.spec.encode_packed,
                self.spec.encode_dense_cap)
            if (nd <= self.spec.encode_dense_cap).all():
                return self._encode_from_host_packed(idx, val, ids, rows)
            # Over-capacity tick: the dense grids are outputs too.
            self._count_fallback()
            vals = self._fetch_dense(res)
        return self._encode_from_host(*vals)

    def _fetch_dense(self, res: TickResult) -> list:
        """Copy a finished tick's dense coefficient grids to the host. On a
        CUDA device the copy runs on a side stream: on the tick's own stream
        it would wait for the ticks issued after it."""
        outs = [res.outputs[k] for k in _ENC_KEYS]
        if self.device.type != "cuda":
            return [t.numpy() for t in outs]
        with self._lock:
            if self._side_stream is None:
                self._side_stream = torch.cuda.Stream(self.device)
        hosts = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in outs]
        with torch.cuda.stream(self._side_stream):
            for host, t in zip(hosts, outs):
                host.copy_(t, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._side_stream)
        event.synchronize()
        return [h.numpy() for h in hosts]

    def stream_encoded(
        self,
        *,
        depth: int = 2,
        rects: Optional[np.ndarray] = None,
        rect_colors: Optional[np.ndarray] = None,
        thickness: int = 2,
        stop=None,
        max_ticks: Optional[int] = None,
    ):
        """Generator of ``(TickResult, [JFIF bytes per stream])``: the
        pipelined encoded-delivery path (the reference's JPEG fan-out,
        ``web_streaming.rs:44-100``, with the encoder's numeric half in the
        tick).

        Per iteration: issue tick k, start the copy of its payload outputs
        (the packed blob, else the dense grids) into pinned host buffers
        with ``non_blocking=True`` and record a CUDA event after it; a
        worker thread waits for that event and Huffman-codes the tick on
        the coder pool; then tick k − ``depth`` is yielded. Device work,
        copies and host coding of different ticks overlap, and nothing
        waits for the whole device. ``stop`` (a ``threading.Event``) or
        ``max_ticks`` ends the stream; the ticks in flight are yielded."""
        self._require_encode()
        if depth < 0:
            raise ValueError(f"depth must be >= 0, got {depth}")
        keys = ("enc_blob",) if self.spec.encode_packed else _ENC_KEYS
        fetch = self._pool("_fetch_pool", 1, "rustcv-fetch")
        ring: list = []  # depth + 1 sets of pinned buffers, reused in turn
        inflight = deque()
        k = 0
        while (max_ticks is None or k < max_ticks) and (stop is None or not stop.is_set()):
            res = self.tick(rects=rects, rect_colors=rect_colors, thickness=thickness, block=False)
            # Slot k % (depth+1) last held tick k-depth-1, already yielded.
            hosts, event = self._copy_out(res, keys, ring, k % (depth + 1))
            inflight.append((res, fetch.submit(self._finish_encoded, res, hosts, event)))
            if len(inflight) > depth:
                done, fut = inflight.popleft()
                yield done, fut.result()
            k += 1
        while inflight:
            done, fut = inflight.popleft()
            yield done, fut.result()

    def run_encoded(
        self,
        n_ticks: int,
        *,
        warmup: int = 3,
        rects: Optional[np.ndarray] = None,
        rect_colors: Optional[np.ndarray] = None,
    ) -> Tuple[EngineStats, float]:
        """Sustained encoded delivery: drives :meth:`stream_encoded` for
        ``n_ticks`` and returns ``(EngineStats, payload MB per tick)``;
        frames count ticks whose JPEG bytes reached the host."""
        for _ in range(warmup):
            self.tick(rects=rects, rect_colors=rect_colors, block=True)
        stats = EngineStats()
        payload_bytes = n_out = 0
        t0 = time.perf_counter()
        for _res, payloads in self.stream_encoded(rects=rects, rect_colors=rect_colors,
                                                  max_ticks=n_ticks):
            payload_bytes += sum(len(p) for p in payloads)
            n_out += 1
        stats.wall_s = time.perf_counter() - t0
        stats.ticks = n_out
        stats.frames = n_out * self.n
        return stats, payload_bytes / max(1, n_out) / 1e6

    # -- not ported yet -------------------------------------------------

    def run_chained(self, *args, **kwargs):
        raise not_ported("run_chained")

    def set_resolution(self, width: int, height: int) -> None:
        raise not_ported("set_resolution")

    # ------------------------------------------------------------------

    def export_state(self) -> dict:
        """JSON-serializable snapshot of the configuration and stream
        positions, with the reference engine's keys."""
        rc = self._resolved
        return {
            "n_streams": self.n,
            "width": rc.width,
            "height": rc.height,
            "fps": rc.fps,
            "pixel_format": rc.pixel_format.value,
            "buffer_count": rc.buffer_count,
            "filter": self.spec.filter,
            "resize_to": list(self.spec.resize_to) if self.spec.resize_to else None,
            "overlay": self.spec.overlay,
            "device_sim": True,
            "sequences": [int(s) for s in self._seqs],
            "tick_index": self._tick_index,
        }

    @classmethod
    def from_state(cls, state: dict, driver=None, device="cuda",
                   **overrides) -> "MultiStreamEngine":
        """Rebuild an engine from an :meth:`export_state` snapshot of this
        engine or of the reference's; stream clocks resume where it left.
        The snapshot holds no encode settings (the reference's keys):
        ``overrides`` (e.g. ``encode_jpeg_quality=85``) go to the engine."""
        from ..capture import SimulationDriver

        if driver is None:
            driver = SimulationDriver(device_count=state["n_streams"], paced=False)
        eng = cls(
            driver, state["n_streams"],
            SimpleConfig(
                width=state["width"], height=state["height"], fps=state["fps"],
                pixel_format=PixelFormat(state["pixel_format"]),
                buffer_count=state["buffer_count"],
            ),
            filter=state["filter"],
            resize_to=tuple(state["resize_to"]) if state["resize_to"] else None,
            overlay=state["overlay"],
            device_sim=state["device_sim"],
            device=device,
            **overrides,
        )
        eng._seqs = np.array(state["sequences"], np.int64)
        eng._seqs_dev = None
        eng._tick_index = state["tick_index"]
        return eng

    def close(self) -> None:
        for s in self._sources:
            s.stop()
        with self._lock:
            for attr in ("_encode_pool", "_fetch_pool"):
                if getattr(self, attr) is not None:
                    getattr(self, attr).shutdown(wait=False)
                    setattr(self, attr, None)

    def __enter__(self) -> "MultiStreamEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
