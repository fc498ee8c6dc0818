"""The pipeline model zoo (port of ``rustcv_tpu.models.zoo``): BASELINE
configs as models that build the port's :class:`MultiStreamEngine`.

BASELINE.json "configs" (quoted in SURVEY.md §6):
1. 640×480 YUYV→BGR convert + rectangle overlay, one synthetic frame.
2. 1080p MJPEG decode → BGR → bilinear resize to 640×480, batch of 8.
3. 5×5 Gaussian + Sobel gradient magnitude on 4K frames, fused, batch 32.
4. Harris corner detection + NMS on a 1080p stream.
5. End-to-end 8-stream pipeline at 4K: capture-sim → decode → convert →
   filter → overlay, sustained multi-batch throughput.

The six models carry the reference's field values but one, and all six
run. Config 3 runs its 32 streams as one batch (``sub_batch=None``): on
one H100 80GB HBM3 at 700 W that beat the reference's ``sub_batch=4`` (its
optimum on its own chip) by 4.8–5.1 % in each of three runs, at 10.66 GiB
of peak device memory against 2.49 (PERF.md §6). Config 2 runs through the
hybrid MJPEG decode (host entropy decode, the rest on the device), config
6 (8 × 1080p → 640×480, blur/Sobel, overlay and a q85 JPEG encode per
stream) through the encoded delivery.

    eng = get_model("config2_mjpeg_resize").engine(device="cuda")
    eng = get_model("config4_harris_1080p").engine(device="cuda")
    eng = get_model("config6_transcode").engine(device="cuda")
    for res, jpegs in eng.stream_encoded(max_ticks=100): ...
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from ..core.config import SimpleConfig
from ..core.errors import CameraError
from ..core.pixel_format import PixelFormat


def default_mjpeg_backend() -> str:
    """Backend of the MJPEG models: the block-packed hybrid decode, which
    needs the port's native library. The reference falls back to the
    full-host decode without it; the port's full-host decode is in the same
    library, so it raises."""
    from .. import native

    if not native.available():
        raise CameraError(f"MJPEG needs the native coder: {native.build_error()}")
    return "hybrid"


@dataclass(frozen=True)
class PipelineModel:
    """Declarative pipeline bundle → engine factory."""

    name: str
    description: str
    n_streams: int
    width: int
    height: int
    pixel_format: PixelFormat
    filter: str = "none"
    resize_to: Optional[Tuple[int, int]] = None
    overlay: bool = False
    fps: int = 60
    encode_jpeg_quality: int = 0  # > 0: fused MJPEG-out transcode
    # sequential sub-ticks for wide batches (the reference's measured
    # optimum on its chip: 8 at 1080p, 4 at 4K)
    sub_batch: Optional[int] = None

    def engine(self, driver=None, *, device_sim: Optional[bool] = None, mesh=None,
               device="cuda", **overrides):
        """Build the port's MultiStreamEngine for this model on ``device``.

        ``device_sim`` defaults to True for the raw formats (frames made on
        the device) and False for MJPEG, whose entropy decode is host work;
        MJPEG takes :func:`default_mjpeg_backend`. ``overrides`` are passed
        to the engine last."""
        from ..capture import SimulationDriver
        from ..runtime import MultiStreamEngine

        if driver is None:
            driver = SimulationDriver(device_count=self.n_streams, paced=False)
        if device_sim is None:
            device_sim = self.pixel_format != PixelFormat.MJPEG
        kwargs = dict(
            filter=self.filter,
            resize_to=self.resize_to,
            overlay=self.overlay,
            encode_jpeg_quality=self.encode_jpeg_quality,
            device_sim=device_sim,
            mesh=mesh,
            device=device,
        )
        if self.sub_batch is not None and device_sim and mesh is None:
            kwargs["sub_batch"] = self.sub_batch
        if self.pixel_format == PixelFormat.MJPEG and "mjpeg_backend" not in overrides:
            kwargs["mjpeg_backend"] = default_mjpeg_backend()
        kwargs.update(overrides)
        return MultiStreamEngine(
            driver,
            self.n_streams,
            SimpleConfig(
                width=self.width, height=self.height, fps=self.fps,
                pixel_format=self.pixel_format,
            ),
            **kwargs,
        )


config1_convert_overlay = PipelineModel(
    name="config1_convert_overlay",
    description="640x480 YUYV->BGR convert + rectangle overlay (BASELINE config 1)",
    n_streams=1, width=640, height=480,
    pixel_format=PixelFormat.YUYV, overlay=True, fps=30,
)

config2_mjpeg_resize = PipelineModel(
    name="config2_mjpeg_resize",
    description="1080p MJPEG decode -> BGR -> resize 640x480, batch 8 (config 2)",
    n_streams=8, width=1920, height=1080,
    pixel_format=PixelFormat.MJPEG, resize_to=(640, 480), fps=30,
)

config3_blur_sobel_4k = PipelineModel(
    name="config3_blur_sobel_4k",
    description="fused 5x5 Gaussian + Sobel |grad| on 4K, batch 32 (config 3)",
    n_streams=32, width=3840, height=2160,
    pixel_format=PixelFormat.YUYV, filter="blur_sobel", fps=30,
    sub_batch=None,  # one batch: faster on one H100 than the reference's 4 (see above)
)

config4_harris_1080p = PipelineModel(
    name="config4_harris_1080p",
    description="Harris corners + NMS on 1080p (config 4)",
    n_streams=1, width=1920, height=1080,
    pixel_format=PixelFormat.YUYV, filter="harris", fps=60,
)

config5_end_to_end_4k = PipelineModel(
    name="config5_end_to_end_4k",
    description="8-stream 4K capture-sim->decode->convert->filter->overlay (config 5)",
    n_streams=8, width=3840, height=2160,
    pixel_format=PixelFormat.YUYV, filter="blur_sobel", overlay=True, fps=60,
)

config6_transcode = PipelineModel(
    name="config6_transcode",
    description=(
        "8x1080p decode -> blur/Sobel -> overlay -> fused VGA MJPEG encode "
        "(beyond-BASELINE serving shape; engine.encode_payloads finishes)"
    ),
    n_streams=8, width=1920, height=1080,
    pixel_format=PixelFormat.YUYV, filter="blur_sobel",
    resize_to=(640, 480), overlay=True, fps=60, encode_jpeg_quality=85,
)

MODELS: Dict[str, PipelineModel] = {
    m.name: m
    for m in (
        config1_convert_overlay, config2_mjpeg_resize, config3_blur_sobel_4k,
        config4_harris_1080p, config5_end_to_end_4k, config6_transcode,
    )
}


def get_model(name: str) -> PipelineModel:
    if name not in MODELS:
        raise KeyError(f"unknown model {name!r}; available: {sorted(MODELS)}")
    return MODELS[name]
