"""Device ops of the port (PyTorch): frame synthesis, YUYV colour, the
blur/Sobel and Canny filters, Harris corners, the rectangle overlay, and
the CUDA kernels in :mod:`.kernels`."""

from . import color, draw, features, filters, kernels, synth

__all__ = ["color", "draw", "features", "filters", "kernels", "synth"]
