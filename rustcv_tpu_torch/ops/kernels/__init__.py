"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Each kernel module holds a wrapper (the plain version for a CPU tensor, the
kernel for a CUDA tensor), the plain version and a launch counter per
kernel. The CUDA sources live in ``rustcv_tpu_torch/csrc`` and build at
first use (:mod:`._build`).
"""

from . import decode_interleave, harris, mosaic_shuffle, stencil, tick_fused
from .decode_interleave import yuyv_decode_interleave
from .harris import harris_response, harris_response_i32
from .stencil import blur_sobel_mag
from .tick_fused import yuyv_tick_fused

# kernel name → (module, the module's launch counter)
_MODULES = {
    "blur_sobel_mag": (stencil, "launches"),
    "yuyv_decode_interleave": (decode_interleave, "launches"),
    "yuyv_tick_fused": (tick_fused, "launches"),
    "harris_response_f32": (harris, "launches_f32"),
    "harris_response_i32": (harris, "launches_i32"),
    "mosaic_shuffle": (mosaic_shuffle, "launches"),
}


def launch_counts() -> dict:
    """Kernel launches per kernel since the last reset."""
    return {name: getattr(mod, attr) for name, (mod, attr) in _MODULES.items()}


def reset_launch_counts() -> None:
    for mod, attr in _MODULES.values():
        setattr(mod, attr, 0)


__all__ = [
    "blur_sobel_mag", "harris_response", "harris_response_i32", "launch_counts",
    "mosaic_shuffle", "reset_launch_counts", "yuyv_decode_interleave", "yuyv_tick_fused",
]
