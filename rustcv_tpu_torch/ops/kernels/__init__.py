"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Each kernel module holds a wrapper (the plain version for a CPU tensor, the
kernel for a CUDA tensor), the plain version and a launch counter.
The CUDA sources live in ``rustcv_tpu_torch/csrc`` and build at first use
(:mod:`._build`).
"""

from . import decode_interleave, stencil, tick_fused
from .decode_interleave import yuyv_decode_interleave
from .stencil import blur_sobel_mag
from .tick_fused import yuyv_tick_fused

_MODULES = {
    "blur_sobel_mag": stencil,
    "yuyv_decode_interleave": decode_interleave,
    "yuyv_tick_fused": tick_fused,
}


def launch_counts() -> dict:
    """Kernel launches per kernel since the last reset."""
    return {name: mod.launches for name, mod in _MODULES.items()}


def reset_launch_counts() -> None:
    for mod in _MODULES.values():
        mod.launches = 0


__all__ = [
    "blur_sobel_mag", "launch_counts", "reset_launch_counts",
    "yuyv_decode_interleave", "yuyv_tick_fused",
]
