"""Device ops of the port (PyTorch): frame synthesis, YUYV colour, the
blur/Sobel and Canny filters, Harris corners, the rectangle overlay, and
the CUDA kernels in :mod:`.kernels`. The other modules (the processing
ops, the codecs, the host numpy modules) are imported where they are
used."""

from . import color, draw, features, filters, kernels, synth

__all__ = ["color", "draw", "features", "filters", "kernels", "synth"]
