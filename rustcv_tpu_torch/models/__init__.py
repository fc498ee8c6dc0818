"""models — named end-to-end pipeline configurations of the port (the
BASELINE configs; see :mod:`.zoo`)."""

from .zoo import (
    MODELS,
    PipelineModel,
    config1_convert_overlay,
    config2_mjpeg_resize,
    config3_blur_sobel_4k,
    config4_harris_1080p,
    config5_end_to_end_4k,
    config6_transcode,
    get_model,
)

__all__ = [
    "MODELS", "PipelineModel", "config1_convert_overlay",
    "config2_mjpeg_resize", "config3_blur_sobel_4k", "config4_harris_1080p",
    "config5_end_to_end_4k", "config6_transcode", "get_model",
]
