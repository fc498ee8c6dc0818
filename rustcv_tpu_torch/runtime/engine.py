"""MultiStreamEngine — batched execution of N capture streams on one CUDA
device (port of ``rustcv_tpu.runtime.engine``).

Four ways a tick gets its frames:

* ``device_sim=True``: each stream's wire-format frame is synthesized on
  the device from its sequence number (:mod:`rustcv_tpu_torch.ops.synth`:
  YUYV, NV12, BGRA32, RGB24, BGR24), and the stream clock advances on the
  device: the next sequence numbers are an output that the next tick takes
  as input, so a steady tick uploads nothing. :meth:`run_chained` runs
  whole chains of such ticks per dispatch, as a CUDA graph on the card.
* the host-staged path (``device_sim=False``, any uncompressed format): a
  thread pool pulls one
  frame per stream into a staging block ``[N, raw_bytes]`` on the host,
  and one copy uploads it. The staging is double-buffered and, on a CUDA
  device, pinned: the copy is ``non_blocking`` and a CUDA event recorded
  after it stays with its buffer, and the gather that next reuses that
  buffer waits for that event alone. In :meth:`run`'s throughput mode a
  prefetch thread gathers tick k+1 while tick k is uploaded and computed.
* the hybrid MJPEG path (``mjpeg_backend="hybrid"``): the host does only
  the sequential entropy decode, with the port's C++ decoder, into
  block-packed coefficient staging (the first frame sizes it: K slots per
  block and a dense-row escape for busy blocks), uploaded the same way;
  the device does the rest (:mod:`rustcv_tpu_torch.ops.jpeg_tpu`). A tick
  whose busy blocks overflow the escape runs a second program on the
  dense coefficient grids.
* the full-host MJPEG path (``mjpeg_backend="host"``): the gather pool
  decodes each stream's frame to BGR with the port's C++ decoder
  (:func:`rustcv_tpu_torch.native.jpeg_decode_bgr`) straight into its row
  of the pinned staging, and one ``non_blocking`` upload per tick follows,
  as on the host-staged path.

A failing source does not end a host tick: its stream reuses its previous
staging row, the fault is counted in ``stream_errors`` and the tick reports
``seq = -1`` for it. The overlay arguments are cached on the device by
content. :meth:`set_resolution` hot-swaps every stream to a new size;
:meth:`warm_buckets` readies the pipelines of the shape buckets first.

The engine takes an explicit ``device`` (``"cuda"`` by default, which
raises where CUDA is absent; tests pass ``"cpu"``). Its snapshot
(:meth:`export_state` / :meth:`from_state`) has the reference engine's
keys, so a stream clock continues across the two packages tick for tick.

With ``mesh=`` (a :class:`~torch.distributed.device_mesh.DeviceMesh` of
:mod:`rustcv_tpu_torch.parallel`, one rank per device) the engine of rank
r owns the streams ``[r·k, (r+1)·k)`` of the ``n_streams``, ``k = n_streams
/ shards`` of the mesh's first axis, on the rank's device. Everything it
returns is its own streams', in stream order; no frame data crosses ranks.
:func:`rustcv_tpu_torch.parallel.gather_streams` gathers them.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import native
from ..capture.source import Driver, FrameSource
from ..core.config import ResolvedConfig, SimpleConfig
from ..core.errors import CameraError, DecodeError
from ..core.pixel_format import PixelFormat
from ..ops import decode as _decode
from ..ops import jpeg_encode as _jenc
from ..ops import jpeg_tpu as _jpeg
from ..ops import kernels as _kernels
from ..ops import synth as _synth
from . import buckets as _buckets
from .pipeline import PipelineSpec, get_pipeline, make_dummy_overlay

_ENC_KEYS = ("enc_y", "enc_cb", "enc_cr")  # the dense coefficient rows, per component
_CHAIN_THICKNESS = 2  # run_chained's overlay thickness, the reference's
_log = logging.getLogger("rustcv_tpu_torch")


class _Chain:
    """One chain of ``k`` device-sim ticks with its own static inputs
    (``seqs`` int32 [N], ``rects``, ``colors``) and output (``sync``, the
    probe of the last dispatch). A dispatch runs the chain and writes the
    advanced clock back into ``seqs``.

    On a CUDA device the chain is captured once into a CUDA graph and a
    dispatch is a replay. Before the capture, one eager chain on a side
    stream builds everything made at first use (the kernels' library, the
    pipeline, the resize tables, the DCT basis), so the captured region
    issues only device work. On the CPU a dispatch calls the chain.

    ``launches`` is what the kernel wrappers counted while the graph was
    captured (kernel name → launches): the kernels every replay runs, since
    a replay calls no wrapper. Empty on the CPU."""

    def __init__(self, eng: "MultiStreamEngine", k: int):
        dev = eng.device
        self._fn = eng._build_sim_fn_chained(k)
        self.seqs = torch.zeros(eng.n, dtype=torch.int32, device=dev)
        self.rects = torch.zeros((eng.n, 4), dtype=torch.int32, device=dev)
        self.colors = torch.zeros((eng.n, 3), dtype=torch.uint8, device=dev)
        self.sync: Optional[torch.Tensor] = None
        self.graph = None
        self.launches: Dict[str, int] = {}
        if dev.type == "cuda":
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                self._step()
            torch.cuda.current_stream(dev).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            before = _kernels.launch_counts()
            with torch.cuda.graph(graph):
                self.sync = self._step()
            after = _kernels.launch_counts()
            self.launches = {name: n - before[name] for name, n in after.items()
                             if n != before[name]}
            self.graph = graph

    def _step(self) -> torch.Tensor:
        out = self._fn(self.seqs, self.rects, self.colors, _CHAIN_THICKNESS)
        self.seqs.copy_(out["_next_seqs"])
        return out["_sync"]

    def dispatch(self) -> None:
        if self.graph is None:
            self.sync = self._step()
        else:
            self.graph.replay()


@dataclass
class TickResult:
    """Outputs of one engine tick (device tensors unless fetched)."""

    outputs: Dict[str, torch.Tensor]
    sequences: np.ndarray  # [N] per-stream frame sequence numbers (-1: a contained fault)
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
        decode_workers: int = 8,
        device_sim: bool = False,
        stencil_impl: Optional[str] = None,
        mjpeg_backend: str = "host",
        encode_jpeg_quality: int = 0,
        encode_subsampling: str = "4:2:0",
        encode_packed: Optional[bool] = None,
        sub_batch: Optional[int] = None,
        device="cuda",
    ):
        """``device_sim=True`` synthesizes frames on the device; otherwise
        frames come from the sources through host staging (raw formats) or, for
        MJPEG, through the full host decode to BGR staging
        (``mjpeg_backend="host"``) or the host entropy decode
        (``mjpeg_backend="hybrid"``). ``decode_workers``
        threads gather the streams. ``sub_batch`` (device-sim only) runs the
        stream batch as chunks of that size, one after another, writing into
        preallocated outputs (must divide ``n_streams``). ``stencil_impl=None``
        picks the stencil kernel on a CUDA device and the plain chain on the
        CPU.

        ``encode_jpeg_quality > 0`` adds the JPEG encoder's numeric half to
        every tick (after the overlay), which :meth:`encode_payloads`,
        :meth:`stream_encoded` and :meth:`run_encoded` finish into one JFIF
        per stream with the host coder. ``encode_packed`` (default: when the
        native coder is available) block-packs the coefficients on the
        device with the reference's K = 10 slots per block and
        ``min(blocks, max(128, blocks // 16))`` dense rows.

        ``mesh`` splits the streams over the mesh's first axis: this rank's
        engine runs its ``n_streams / shards`` streams (``self.n``) from
        stream ``self.first_stream`` on, on the rank's device (``device``
        must name it, or be its type). ``n_streams`` must divide by the
        mesh's size, and ``sub_batch`` does not go with a mesh, as in the
        reference. Callers pass per-stream arguments (rects, colours, text)
        for all ``n_streams``; each rank takes its own rows."""
        if n_streams < 1:
            raise ValueError("n_streams must be >= 1")
        if mjpeg_backend not in ("host", "hybrid"):
            raise ValueError(f"unknown mjpeg_backend {mjpeg_backend!r}")
        self.device = torch.device(device)
        self.n_streams = n_streams
        self.mesh = mesh
        self.first_stream = 0
        if mesh is not None:
            self.device = self._rank_device(mesh, self.device)
            if n_streams % mesh.size():
                raise ValueError(f"n_streams={n_streams} not divisible by mesh size {mesh.size()}")
            if sub_batch is not None:
                raise ValueError("sub_batch is per-chip; shards on a mesh are already narrow")
            n_streams //= mesh.size(0)
            self.first_stream = mesh.get_local_rank(0) * n_streams
        elif self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but torch.cuda.is_available() is False")
        self.n = n_streams  # this engine's streams
        self._driver = driver
        self._sources: List[FrameSource] = []
        self._open_all(config)

        rc = self._sources[0].resolved_config()
        self._resolved = rc
        mjpeg = rc.pixel_format == PixelFormat.MJPEG
        if mjpeg and device_sim:
            raise CameraError("device_sim does not support MJPEG streams")
        self._mjpeg_hybrid = mjpeg and mjpeg_backend == "hybrid"
        # The full-host decode: the gather pool decodes each frame to BGR
        # straight into its pinned staging row (native.jpeg_decode_bgr).
        self._mjpeg_host = mjpeg and not self._mjpeg_hybrid
        if mjpeg and not native.available():
            raise CameraError(f"mjpeg_backend={mjpeg_backend!r} needs the native coder: "
                              f"{native.build_error()}")
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
            mjpeg_hybrid=self._mjpeg_hybrid,
            mjpeg_staged_bgr=self._mjpeg_host,
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
        self._prefetch_pool: Optional[ThreadPoolExecutor] = None  # run()'s next gather
        self._side_stream = None  # CUDA stream of the over-capacity copies
        self.stream_errors = np.zeros(self.n, np.int64)  # contained faults per stream
        # Gathers that found their staging buffer's upload still in flight
        # and waited for it (a host path outrunning the device).
        self.staging_waits = 0
        # Hybrid MJPEG ticks that ran the dense program (a stream's busy
        # blocks overflowed the dense rows).
        self.mjpeg_dense_ticks = 0
        self._device_sim = device_sim
        if sub_batch is not None:
            if not device_sim:
                raise ValueError("sub_batch requires device_sim=True")
            if n_streams % sub_batch:
                raise ValueError(f"sub_batch={sub_batch} must divide n_streams={n_streams}")
            if sub_batch == n_streams:
                sub_batch = None  # monolithic anyway
        self._sub_batch = sub_batch
        self._seqs = np.zeros(self.n, np.int64)  # the device-sim stream clock
        self._seqs_dev = None
        self._overlay_cache = None  # (content key, device args)
        self._text_cache = None  # ((text, scale), (device masks, dx, dy))
        self._text_params = None  # ((x, y, colour), (device origins, device colour))
        self._sim_t0 = time.monotonic()
        self._frame_pool = None
        self._chains: Dict[int, _Chain] = {}  # run_chained's chains by length (CUDA graphs)
        # Host staging: two slots, each a list of (tensor, numpy view) pairs
        # (pinned on a CUDA device), and per slot the event recorded after
        # its last upload. The hybrid slots are sized by the first frame.
        self._staging: List[list] = []
        self._staging_events: list = [None, None]
        self._staging_idx = 0
        self._coeff_staging = None  # hybrid: the dense grids of over-capacity ticks
        self._fn_dense = None  # hybrid: the dense-grid program
        self._qts = None  # hybrid: (luma, chroma) quant tables on the device
        self._gather_pool: Optional[ThreadPoolExecutor] = None
        self._last_gather_s = 0.0
        if device_sim:
            pool_k = getattr(self._driver, "n_unique_frames", 0)
            if pool_k > 0:
                # K wire-format frames made once on the device; ticks gather
                # from the pool like a camera's DMA ring.
                self._frame_pool = _synth.synth_raw(
                    torch.arange(pool_k, dtype=torch.int32, device=self.device),
                    rc.width, rc.height, rc.pixel_format,
                )
        else:
            if not self._mjpeg_hybrid:
                shape = (self.n, self.spec.raw_bytes())
                self._staging = [[self._host_buffer(shape, np.uint8)] for _ in range(2)]
            if mjpeg or self.n > 1:
                self._gather_pool = ThreadPoolExecutor(max_workers=decode_workers,
                                                       thread_name_prefix="rustcv-decode")
        self._tick_index = 0

    @staticmethod
    def _rank_device(mesh, device: torch.device) -> torch.device:
        from ..parallel.mesh import mesh_device

        dev = mesh_device(mesh)
        if device.type != dev.type or device.index not in (None, dev.index):
            raise ValueError(f"device {str(device)!r} is not this rank's device {dev} in the mesh")
        return dev

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

    def _build_sim_fn_chained(self, k: int):
        """``k`` whole device-sim ticks as one function of the stream clock
        (the reference's ``lax.scan`` chain): ``run(seqs, rects, colors,
        thickness)`` → ``{"_sync": int32 [1], "_next_seqs": seqs + k}``.

        ``_sync`` is the probe: the sum of every output of every tick, in
        int32 with the reference's wrap, so no tick's work can be left out.
        A tick's outputs are dropped once summed: the chain holds one tick's
        memory, not k ticks'."""
        def run(seqs, rects, rect_colors, thickness):
            total = torch.zeros((), dtype=torch.int64, device=seqs.device)
            for _ in range(k):
                out = self._sim_tick(seqs, rects, rect_colors, thickness)
                for key, v in out.items():
                    if not key.startswith("_"):
                        total = total + v.sum(dtype=torch.int64)
                seqs = out["_next_seqs"]
                del out
            probe = torch.remainder(total + 2**31, 2**32) - 2**31  # int32 wrap
            return {"_sync": probe.to(torch.int32).reshape(1), "_next_seqs": seqs}

        return run

    def _chain(self, k: int) -> "_Chain":
        """The chain of ``k`` ticks of the current spec (captured as a CUDA
        graph on a CUDA device), made at first use; :meth:`set_resolution`
        drops the chains of the old spec. The decode mode needs no key of
        its own: the engine's pipeline is fixed when the spec is made."""
        if k not in self._chains:
            self._chains[k] = _Chain(self, k)
        return self._chains[k]

    def run_chained(
        self,
        n_ticks: int,
        *,
        chain: int = 16,
        warmup: int = 1,
        rects: Optional[np.ndarray] = None,
        rect_colors: Optional[np.ndarray] = None,
    ) -> EngineStats:
        """Dispatch-amortized throughput harness (device-sim only): each
        dispatch runs ``chain`` whole ticks, ``max(1, n_ticks // chain)``
        dispatches back to back after ``warmup`` (at least 1) synced ones,
        and one fetch of the last probe bounds the run.

        On a CUDA device a dispatch is one replay of a CUDA graph captured
        once per chain length and spec: the host issues no op per tick, so
        the rate is the device's own. Frames are made on the
        device, so it leaves out the host ingest path (``run`` measures
        that). On the CPU the same chain runs eagerly. A capture that fails
        raises; nothing falls back to eager ticks on a CUDA device.

        The caller's rects and colours (thickness 2, the reference's) are
        copied into the chain's own tensors before the dispatches; the
        stream clock advances on the device and is read once, at the end."""
        if not self._device_sim:
            raise CameraError("run_chained requires device_sim=True")
        ch = self._chain(chain)
        r, c = self._host_overlay(rects, rect_colors)
        ch.rects.copy_(torch.from_numpy(r))
        ch.colors.copy_(torch.from_numpy(c))
        ch.seqs.copy_(torch.from_numpy(self._seqs.astype(np.int32)))
        for _ in range(max(1, warmup)):
            ch.dispatch()
        ch.sync.cpu()
        n_disp = max(1, n_ticks // chain)
        t0 = time.perf_counter()
        for _ in range(n_disp):
            ch.dispatch()
        ch.sync.cpu()  # one stream runs the dispatches in order
        wall = time.perf_counter() - t0

        self._seqs = ch.seqs.cpu().numpy().astype(np.int64)
        self._seqs_dev = None
        stats = EngineStats()
        stats.ticks = n_disp * chain
        stats.frames = stats.ticks * self.n
        stats.wall_s = wall
        return stats

    # ------------------------------------------------------------------

    def _open_all(self, config: SimpleConfig) -> None:
        for s in self._sources:
            s.stop()
        self._sources = []
        for i in range(self.first_stream, self.first_stream + self.n):
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

    # -- host staging ----------------------------------------------------

    def _host_buffer(self, shape, dtype) -> tuple:
        """A staging buffer as (tensor, numpy view of the same memory):
        pinned on a CUDA device, so its upload can be ``non_blocking``."""
        if self.device.type != "cuda":
            arr = np.zeros(shape, dtype)
            return torch.from_numpy(arr), arr
        t = torch.zeros(shape, dtype=torch.from_numpy(np.zeros(0, dtype)).dtype, pin_memory=True)
        return t, t.numpy()

    def _claim_slot(self) -> int:
        """The staging slot the next gather fills. Its last upload may still
        be reading it: wait for that upload's event (and nothing else)."""
        slot = self._staging_idx
        self._staging_idx ^= 1
        event = self._staging_events[slot]
        if event is not None and not event.query():
            self.staging_waits += 1
            event.synchronize()
        return slot

    def _upload(self, slot: int) -> list:
        """Start the host→device copy of staging ``slot`` and record the
        event the slot's next gather waits for. On the CPU the inputs are
        copies of the staging tensors."""
        hosts = [t for t, _ in self._staging[slot]]
        if self.device.type != "cuda":
            # A copy, as the device's: an output that is a view of its
            # input (BGR24 with no overlay) must not change with a later
            # gather into the same slot.
            return [t.clone() for t in hosts]
        outs = [t.to(self.device, non_blocking=True) for t in hosts]
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        self._staging_events[slot] = event
        return outs

    def _gather_row(self, i: int, staging: np.ndarray, prev: np.ndarray, seqs: np.ndarray) -> None:
        """Fill stream i's staging row. Per-stream fault containment: a
        failing source does not end the tick; its stream reuses its last
        good frame (the previous buffer's row), the error is counted and its
        sequence is -1."""
        try:
            frame = self._sources[i].next_frame()
            seqs[i] = frame.sequence
            if self._mjpeg_host:
                w, h = self._resolved.width, self._resolved.height
                got = _decode.mjpeg_size(frame.data)  # a corrupt frame: a stream fault
                if got != (w, h):
                    raise CameraError(f"stream {i} geometry {got} != negotiated ({w}, {h})")
                _decode.decode_mjpeg_host(frame.data, out=staging[i].reshape(h, w, 3))
            else:
                staging[i] = frame.data.reshape(-1)
        except CameraError as e:
            self.stream_errors[i] += 1
            seqs[i] = -1
            staging[i] = prev[i]
            _log.warning("stream %d capture failed (reusing last frame): %s",
                         self.first_stream + i, e)

    def _map_streams(self, fn, first: int = 0) -> None:
        """``fn(i)`` for streams ``first``..N-1, on the gather pool when there
        is one; every result is read, so an error is raised here."""
        if self._gather_pool is None:
            for i in range(first, self.n):
                fn(i)
            return
        for fut in [self._gather_pool.submit(fn, i) for i in range(first, self.n)]:
            fut.result()

    def gather(self) -> Tuple[int, np.ndarray]:
        """Pull one frame per stream into the next staging slot; returns the
        slot and the sequences."""
        slot = self._claim_slot()
        staging, prev = self._staging[slot][0][1], self._staging[slot ^ 1][0][1]
        seqs = np.zeros(self.n, np.int64)
        self._map_streams(lambda i: self._gather_row(i, staging, prev, seqs))
        return slot, seqs

    # -- hybrid MJPEG gather (C++ entropy decode → coefficient staging) ----

    def _check_geometry(self, i: int, info: dict) -> None:
        if (info["width"], info["height"]) != (self._resolved.width, self._resolved.height):
            raise CameraError(f"stream {i} geometry {info['width']}x{info['height']} != negotiated")

    def _entropy_decode_checked(self, i: int):
        frame = self._sources[i].next_frame()
        info, coeffs, qts = native.jpeg_entropy_decode(frame.data)
        self._check_geometry(i, info)
        return frame.sequence, coeffs, qts

    def _init_hybrid(self) -> tuple:
        """Sizing pass: stream 0's first frame fixes the coefficient geometry
        (subsampling), the quant tables and the packed capacity, and selects
        the packed program. Returns (seq, dense coefficients) of that frame
        for the first tick."""
        seq, coeffs, qts = self._entropy_decode_checked(0)
        if len(coeffs) != 3 or coeffs[1].shape != coeffs[2].shape:
            raise CameraError("hybrid MJPEG expects three components, Cb and Cr alike")
        nblocks = int(sum(c.shape[0] * c.shape[1] for c in coeffs))
        nnzb = np.concatenate([(c != 0).sum(axis=(2, 3)).reshape(-1) for c in coeffs])
        self._packed_k, self._dense_cap = _jpeg.choose_block_packing(nnzb)
        k, cap = self._packed_k, self._dense_cap
        tables = []
        for q in qts[:2]:
            t, _ = self._host_buffer((8, 8), np.int32)
            t.copy_(torch.from_numpy(q.astype(np.int32)))
            tables.append(t.to(self.device, non_blocking=True))
        self._qts = tuple(tables)
        # The dense grids serve only over-capacity ticks: plain arrays,
        # whose pages stay unallocated until such a tick writes them.
        self._coeff_staging = [[np.zeros((self.n, *c.shape), np.int16) for c in coeffs]
                               for _ in range(2)]
        staging = []
        for _ in range(2):
            bufs = [self._host_buffer(s, d) for s, d in (
                ((self.n, nblocks, k), np.uint8), ((self.n, nblocks, k), np.int16),
                ((self.n, cap), np.int32), ((self.n, cap, 64), np.int16))]
            bufs[2][1][:] = nblocks  # the scratch-row id
            staging.append(bufs)
        self._staging = staging
        self._fn_dense = self._fn
        geom = tuple((int(c.shape[0]), int(c.shape[1])) for c in coeffs)
        self.spec = replace(self.spec, mjpeg_packed=True, coeff_geometry=geom)
        self._fn = get_pipeline(self.spec)
        return seq, coeffs

    def _pack_dense_host(self, i: int, coeffs, staging) -> bool:
        """Block-pack dense grids into stream i's packed rows on the host
        (the encoder's packing; its busy blocks come in another order than
        the decoder's, which the unpack does not see). Returns False if the
        busy blocks exceed the dense-row capacity."""
        blocks = torch.from_numpy(np.concatenate([c.reshape(-1, 64) for c in coeffs]))
        *packed, n_dense = _jenc.pack_coeff_rows(blocks, self._packed_k, self._dense_cap)
        if int(n_dense) > self._dense_cap:
            return False
        for dst, src in zip(staging, packed):
            dst[i] = src.numpy()
        return True

    def _gather_row_hybrid(self, i, staging, prev_staging, dense_bufs, seqs, dense_flags):
        """Block-packed entropy decode of stream i's frame into its staging
        rows; a frame whose busy blocks exceed the capacity decodes dense
        instead and flags the tick. Faults are contained as in
        :meth:`_gather_row`: the previous tick's packed rows are reused."""
        try:
            frame = self._sources[i].next_frame()
            seqs[i] = frame.sequence
            try:
                r = native.jpeg_entropy_decode_blockpacked(
                    frame.data, self._packed_k, self._dense_cap,
                    out_idx=staging[0][i], out_val=staging[1][i],
                    out_dense_ids=staging[2][i], out_dense_rows=staging[3][i])
            except ValueError as e:  # a corrupt frame, or another block grid
                raise DecodeError(str(e)) from e
            if r is None:  # busy blocks over capacity: decode dense, same bytes
                # The aborted packed decode left the rows half written:
                # restore the last good ones, which a later fault reuses.
                for cur, prev in zip(staging, prev_staging):
                    cur[i] = prev[i]
                try:
                    info, coeffs, _ = native.jpeg_entropy_decode(frame.data)
                except ValueError as e:
                    raise DecodeError(str(e)) from e
                self._check_geometry(i, info)
                for c in range(3):
                    if len(coeffs) != 3 or dense_bufs[c][i].shape != coeffs[c].shape:
                        raise DecodeError(
                            f"stream {i} coefficient grids {[a.shape for a in coeffs]} != "
                            "negotiated (subsampling changed)")
                for c in range(3):
                    dense_bufs[c][i] = coeffs[c]
                dense_flags[i] = True
                return
            self._check_geometry(i, r[0])
        except CameraError as e:
            self.stream_errors[i] += 1
            seqs[i] = -1
            for cur, prev in zip(staging, prev_staging):
                cur[i] = prev[i]  # the last good packed rows
            _log.warning("stream %d hybrid capture failed (reusing last frame): %s",
                         self.first_stream + i, e)

    def gather_hybrid(self) -> Tuple[str, int, np.ndarray]:
        """One frame per stream → block-packed coefficient staging (the host
        does only the entropy decode, which releases the GIL, so streams
        decode in parallel). Returns ``(kind, slot, seqs)``: kind
        ``"packed"``, or ``"dense"`` when a stream overflowed the dense-row
        capacity and the whole batch runs the dense program from the
        slot's dense grids."""
        seqs = np.zeros(self.n, np.int64)
        seed = None
        if self._coeff_staging is None:
            seqs[0], seed = self._init_hybrid()
        slot = self._claim_slot()
        staging = [a for _, a in self._staging[slot]]
        prev_staging = [a for _, a in self._staging[slot ^ 1]]
        dense_bufs = self._coeff_staging[slot]
        dense_flags = np.zeros(self.n, bool)
        if seed is not None and not self._pack_dense_host(0, seed, staging):
            for c in range(3):
                dense_bufs[c][0] = seed[c]
            dense_flags[0] = True
        self._map_streams(lambda i: self._gather_row_hybrid(
            i, staging, prev_staging, dense_bufs, seqs, dense_flags),
            first=0 if seed is None else 1)
        if not dense_flags.any():
            return "packed", slot, seqs
        # A rare tick: the packed streams' dense grids are made on the host
        # (the same unpack as the device's), and the batch runs dense.
        for i in np.flatnonzero(~dense_flags):
            row = _jpeg.unpack_block_coeffs(*(torch.from_numpy(a[i]) for a in staging))
            row = row.reshape(-1).numpy()
            off = 0
            for b in dense_bufs:
                b[i] = row[off:off + b[i].size].reshape(b[i].shape)
                off += b[i].size
        return "dense", slot, seqs

    def _gather_any(self) -> tuple:
        """One frame per stream, tagged for :meth:`tick`'s ``pregathered``:
        ``(kind, slot, seqs)``."""
        if self._mjpeg_hybrid:
            return self.gather_hybrid()
        slot, seqs = self.gather()
        return "raw", slot, seqs

    def _timed_gather(self):
        t = time.perf_counter()
        pre = self._gather_any()
        return pre, time.perf_counter() - t

    def _staged_inputs(self, pregathered):
        """Gather (unless ``pregathered``) and upload: (pipeline, its input,
        sequences)."""
        if pregathered is None:
            pregathered, self._last_gather_s = self._timed_gather()
        kind, slot, seqs = pregathered
        if kind == "raw":
            return self._fn, self._upload(slot)[0], seqs
        if kind == "packed":
            return self._fn, tuple(self._upload(slot)) + self._qts, seqs
        # Over-capacity tick: the dense grids are plain host arrays, so their
        # copy returns once the bytes have left them.
        self.mjpeg_dense_ticks += 1
        grids = tuple(torch.from_numpy(b).to(self.device) for b in self._coeff_staging[slot])
        return self._fn_dense, grids + self._qts, seqs

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
            r, c = self._host_overlay(rects, rect_colors)
            args = (torch.from_numpy(r).to(self.device), torch.from_numpy(c).to(self.device),
                    int(thickness))
            self._overlay_cache = (key, args)
        return self._overlay_cache[1]

    def _own_rows(self, a, dtype, width: int) -> np.ndarray:
        """This engine's streams' rows of a per-stream argument given for
        all ``n_streams`` (or broadcast to them), as a fresh host array."""
        a = np.broadcast_to(np.asarray(a).astype(dtype), (self.n_streams, width))
        return np.array(a[self.first_stream:self.first_stream + self.n], order="C")

    def _host_overlay(self, rects, rect_colors) -> Tuple[np.ndarray, np.ndarray]:
        """The caller's rects and colours (zeros where None) as this
        engine's int32 [n, 4] and u8 [n, 3] host arrays."""
        r = np.zeros(4, np.int32) if rects is None else rects
        c = np.zeros(3, np.uint8) if rect_colors is None else rect_colors
        return self._own_rows(r, np.int32, 4), self._own_rows(c, np.uint8, 3)

    def tick(
        self,
        rects: Optional[np.ndarray] = None,
        rect_colors: Optional[np.ndarray] = None,
        thickness: int = 2,
        block: bool = False,
        text=None,
        text_org: Tuple[int, int] = (10, 30),
        text_scale: float = 1.0,
        text_color: Tuple[int, int, int] = (0, 255, 255),
        pregathered=None,
    ) -> TickResult:
        """One batched step. ``block=False`` leaves the outputs in flight on
        the device's stream; ``block=True`` waits for them by fetching the
        one-element ``_sync`` output. ``pregathered`` (host paths) is a
        gather made ahead, as :meth:`run`'s prefetch thread makes it.
        ``text`` (a string for every stream, or a list of N) is blended onto
        the BGR output with its baseline at ``text_org`` (:meth:`_apply_text`).

        Overlay args are cached by content: a changed value is uploaded
        again, an unchanged one costs no transfer."""
        r, c, th = self._overlay_args(rects, rect_colors, thickness)
        if self._device_sim:
            if getattr(self._driver, "paced", False):
                # Sensor-timed sequences: the wall clock drives seq, so a
                # slow consumer sees gaps (drop semantics kept on the device
                # path).
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
            out = self._sim_tick(x, r, c, th)
            self._seqs_dev = out["_next_seqs"]
        else:
            fn, x, seqs = self._staged_inputs(pregathered)
            out = fn(x, r, c, th)
        if text is not None and "bgr" in out and out["bgr"].ndim == 3:
            out = dict(out)
            out["bgr"] = self._apply_text(out["bgr"], text, text_org, text_scale, text_color)
        if block:
            out["_sync"].cpu()  # a device→host copy waits for the tick
        res = TickResult(out, seqs, self._tick_index)
        self._tick_index += 1
        return res

    def _apply_text(self, bgr_packed: torch.Tensor, text, org, scale, color) -> torch.Tensor:
        """Text overlay on packed-rows BGR (N, H, W*3), after the pipeline.

        ``text`` is one string for every stream or a list of ``n_streams``
        (per-camera FPS counters, names; each rank blends its own). Masks
        are rasterized on the host per (text, scale) with bucketed canvases,
        repeated ×3 for the packed layout and
        kept on the device in a one-entry cache; the origins and the colour
        in another. A change uploads from pinned memory without waiting for
        the stream; an unchanged overlay uploads nothing."""
        from ..ops import draw as _draw
        from ..ops import text as _text

        per_stream = isinstance(text, (list, tuple))
        key = (tuple(text) if per_stream else text, float(scale))
        if self._text_cache is None or self._text_cache[0] != key:
            self._text_cache = None  # keep one live mask set (bounded memory)
            if per_stream:
                if len(text) != self.n_streams:
                    raise ValueError(f"need {self.n_streams} strings, got {len(text)}")
                own = text[self.first_stream:self.first_stream + self.n]
                rendered = [_text.rasterize(t, scale) for t in own]
                mh = max(m.shape[0] for m, _, _ in rendered)
                mw = max(m.shape[1] for m, _, _ in rendered)
                stack = np.zeros((self.n, mh, mw), np.uint8)
                for i, (m, _, _) in enumerate(rendered):
                    stack[i, : m.shape[0], : m.shape[1]] = m
                mask3 = np.repeat(stack, 3, axis=2)
                dx, dy = rendered[0][1], rendered[0][2]
            else:
                mask, dx, dy = _text.rasterize(text, scale)
                mask3 = np.repeat(mask, 3, axis=1)
            self._text_cache = (key, (_draw._on(mask3, torch.uint8, self.device), dx, dy))
        mask3_dev, dx, dy = self._text_cache[1]
        pkey = (int(org[0]) + dx, int(org[1]) + dy, tuple(int(v) for v in color))
        if self._text_params is None or self._text_params[0] != pkey:
            orgs = np.tile(np.array([pkey[:2]], np.int64), (self.n, 1))
            self._text_params = (pkey, (_draw._on(orgs, torch.int64, self.device),
                                        _draw._on(np.array(color, np.int32), torch.int32,
                                                  self.device)))
        orgs_dev, color_dev = self._text_params[1]
        if per_stream:
            return _draw.blend_masks_packed_batch(bgr_packed, mask3_dev, orgs_dev, color_dev)
        return _draw.blend_mask_packed_batch(bgr_packed, mask3_dev, orgs_dev, color_dev)

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
        (host clock around a blocking tick), host gather ms per tick and
        dropped frames.

        With ``measure_latency=False`` on a host path, a prefetch thread
        gathers tick k+1 while tick k is uploaded and computed, and
        ``host_gather_ms`` is that (mostly hidden) gather's time. Drops are
        counted per stream between its first and last good sequence; a
        contained fault's ``-1`` enters neither."""
        stats = EngineStats()
        for _ in range(warmup):
            self.tick(rects=rects, rect_colors=rect_colors, block=True)

        first_seqs = np.full(self.n, -1, np.int64)
        last_seqs = np.full(self.n, -1, np.int64)
        good_counts = np.zeros(self.n, np.int64)
        lat: List[float] = []
        prefetch = not measure_latency and not self._device_sim and n_ticks > 0
        if prefetch:
            with self._lock:
                if self._prefetch_pool is None:
                    self._prefetch_pool = ThreadPoolExecutor(max_workers=1,
                                                             thread_name_prefix="rustcv-prefetch")
        res = None
        gather_total = 0.0
        t0 = time.perf_counter()
        gfut = self._prefetch_pool.submit(self._timed_gather) if prefetch else None
        for k in range(n_ticks):
            self._last_gather_s = 0.0
            if measure_latency:
                t_s = time.perf_counter()
                res = self.tick(rects=rects, rect_colors=rect_colors, block=True)
                lat.append((time.perf_counter() - t_s) * 1e3)
            elif prefetch:
                pre, self._last_gather_s = gfut.result()
                if k + 1 < n_ticks:
                    gfut = self._prefetch_pool.submit(self._timed_gather)
                res = self.tick(rects=rects, rect_colors=rect_colors, pregathered=pre)
            else:
                res = self.tick(rects=rects, rect_colors=rect_colors)
            gather_total += self._last_gather_s
            good = res.sequences >= 0
            first_seqs = np.where((first_seqs < 0) & good, res.sequences, first_seqs)
            last_seqs = np.where(good, res.sequences, last_seqs)
            good_counts += good
        if res is not None:
            # One stream runs the ticks in order: the last tick's token
            # bounds the whole run.
            res.outputs["_sync"].cpu()
        wall = time.perf_counter() - t0

        stats.ticks = n_ticks
        stats.frames = n_ticks * self.n
        stats.wall_s = wall
        stats.host_gather_ms = gather_total * 1e3 / max(1, n_ticks)
        if lat:
            stats.latencies_ms = lat
            stats.p50_latency_ms = float(np.percentile(lat, 50))
            stats.p99_latency_ms = float(np.percentile(lat, 99))
        valid = first_seqs >= 0
        if valid.any():
            # A paced clock skips the sequences a slow consumer missed.
            expected = (last_seqs[valid] - first_seqs[valid] + 1).sum()
            stats.dropped_frames = int(max(0, expected - good_counts[valid].sum()))
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

    # -- resolution hot swap ---------------------------------------------

    def _spec_at(self, width: int, height: int, pixel_format: PixelFormat) -> PipelineSpec:
        """This engine's spec at another frame size, as a swap makes it (the
        reference's): a fresh spec of the same stages, the hybrid decode
        dense until its first gather sizes the packing, and the encoder's
        dense-row cap following the new size when there is no resize."""
        spec = self.spec
        pack_cap = spec.encode_dense_cap
        if spec.encode_packed and spec.resize_to is None:
            nbt = sum(bh * bw for bh, bw in
                      _jenc._geometry(width, height, spec.encode_subsampling)["blocks"])
            pack_cap = min(nbt, max(128, nbt // 16))
        return PipelineSpec(
            pixel_format=pixel_format, width=width, height=height,
            resize_to=spec.resize_to, filter=spec.filter, overlay=spec.overlay,
            emit_bgr=spec.emit_bgr, stencil_impl=spec.stencil_impl,
            mjpeg_hybrid=spec.mjpeg_hybrid, mjpeg_staged_bgr=spec.mjpeg_staged_bgr,
            encode_jpeg=spec.encode_jpeg, encode_subsampling=spec.encode_subsampling,
            encode_packed=spec.encode_packed, encode_dense_cap=pack_cap,
        )

    def warm_buckets(self, buckets=None) -> int:
        """Build this engine's pipeline for every shape bucket (default
        :data:`.buckets.SHAPE_BUCKETS`; odd widths skipped for YUYV), the
        spec a :meth:`set_resolution` to it makes, and run one synced tick
        of each on zero frames, so the first tick after the swap finds its
        pipeline and tables made and the allocator sized. Returns the
        number of buckets warmed, as the reference counts them; a hybrid
        MJPEG engine warms its dense program on 4:2:0 coefficient grids
        (the reference's warm-up refuses hybrid engines)."""
        fmt = self.spec.pixel_format
        specs = [self._spec_at(w, h, fmt)
                 for (w, h) in (buckets if buckets is not None else _buckets.SHAPE_BUCKETS)
                 if fmt != PixelFormat.YUYV or w % 2 == 0]
        return _buckets.warm(specs, self.n, self.device)

    def set_resolution(self, width: int, height: int) -> None:
        """Hot-swap every stream to a new resolution (blocking), with the
        reference's stop → renegotiate → restart semantics: the sources
        reopen at the new size, a new spec is made (:meth:`_spec_at`), and
        everything made for the old geometry is rebuilt or dropped: the
        pipeline, the host staging and its events, the hybrid staging,
        dense program and quant tables (remade by the next gather), the
        overlay cache, the frame pool and the chained graphs."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)  # nothing in flight reads the old buffers
        cfg = SimpleConfig(
            width=width, height=height, fps=self._resolved.fps,
            pixel_format=self._resolved.pixel_format, buffer_count=self._resolved.buffer_count,
        )
        self._open_all(cfg)
        rc = self._sources[0].resolved_config()
        self._resolved = rc
        self.spec = self._spec_at(rc.width, rc.height, rc.pixel_format)
        self._fn = get_pipeline(self.spec)
        self._coeff_staging = None
        self._fn_dense = None
        self._qts = None
        self._overlay_cache = None
        self._chains = {}
        self._staging_events = [None, None]
        if self._device_sim:
            if self._frame_pool is not None:
                self._frame_pool = _synth.synth_raw(
                    torch.arange(self._frame_pool.shape[0], dtype=torch.int32, device=self.device),
                    rc.width, rc.height, rc.pixel_format)
        elif self._mjpeg_hybrid:
            self._staging = []
        else:
            shape = (self.n, self.spec.raw_bytes())
            self._staging = [[self._host_buffer(shape, np.uint8)] for _ in range(2)]

    # ------------------------------------------------------------------

    def export_state(self) -> dict:
        """JSON-serializable snapshot of the configuration and stream
        positions, with the reference engine's keys. ``sequences`` is the
        device-sim stream clock; a host path's positions are its sources'
        own, as in the reference. On a mesh, ``n_streams`` is the whole
        count and ``sequences`` this rank's streams': the ranks' lists
        gathered in stream order make the whole snapshot."""
        rc = self._resolved
        return {
            "n_streams": self.n_streams,
            "width": rc.width,
            "height": rc.height,
            "fps": rc.fps,
            "pixel_format": rc.pixel_format.value,
            "buffer_count": rc.buffer_count,
            "filter": self.spec.filter,
            "resize_to": list(self.spec.resize_to) if self.spec.resize_to else None,
            "overlay": self.spec.overlay,
            "device_sim": self._device_sim,
            "sequences": [int(s) for s in self._seqs],
            "tick_index": self._tick_index,
        }

    @classmethod
    def from_state(cls, state: dict, driver=None, device="cuda", mesh=None,
                   **overrides) -> "MultiStreamEngine":
        """Rebuild an engine from an :meth:`export_state` snapshot of this
        engine or of the reference's; device-sim stream clocks resume where
        it left, a host path opens its sources anew. The snapshot holds no
        encode or MJPEG settings (the reference's keys): ``overrides`` (e.g.
        ``encode_jpeg_quality=85``, ``mjpeg_backend="hybrid"``) go to the
        engine. With ``mesh``, ``state`` is the whole snapshot (every
        stream's position) and each rank resumes its own streams."""
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
            mesh=mesh,
            **overrides,
        )
        seqs = np.array(state["sequences"], np.int64)
        if seqs.shape != (eng.n_streams,):
            raise ValueError(f"the snapshot holds {seqs.size} stream positions, "
                             f"not n_streams={eng.n_streams}")
        eng._seqs = seqs[eng.first_stream:eng.first_stream + eng.n]
        eng._seqs_dev = None
        eng._tick_index = state["tick_index"]
        return eng

    def close(self) -> None:
        for s in self._sources:
            s.stop()
        with self._lock:
            for attr in ("_gather_pool", "_prefetch_pool", "_encode_pool", "_fetch_pool"):
                if getattr(self, attr) is not None:
                    getattr(self, attr).shutdown(wait=False)
                    setattr(self, attr, None)

    def __enter__(self) -> "MultiStreamEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
