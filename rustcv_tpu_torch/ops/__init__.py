"""Device ops of the port (PyTorch): frame synthesis, YUYV colour, the
blur/Sobel filters, the rectangle overlay, and the CUDA kernels in
:mod:`.kernels`."""

from . import color, draw, filters, kernels, synth

__all__ = ["color", "draw", "filters", "kernels", "synth"]
