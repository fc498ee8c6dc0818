"""rustcv_tpu_torch — the PyTorch/CUDA port of :mod:`rustcv_tpu`.

The JAX package ``rustcv_tpu`` stays the reference; this package mirrors its
module names (``capture``, ``models``, ``ops``, ``runtime``, and the
OpenCV-style facade ``prelude``, ``imgproc``, ``highgui``, ``imgcodecs``,
``videoio``) and computes the same bytes
with PyTorch for the glue and hand-written CUDA kernels (``csrc/``) where the
reference used Pallas. It imports nothing of the JAX package: its core
types (``core``) and its host JPEG coder (``native``) are its own copies.

    from rustcv_tpu_torch.capture import SimulationDriver
    from rustcv_tpu_torch.runtime import MultiStreamEngine
    from rustcv_tpu_torch.prelude import Mat, TickMeter, VideoCapture
    from rustcv_tpu_torch import highgui, imgcodecs, imgproc

Importing this package is light: no torch and no kernel build until a
submodule that needs them is used.
"""

__all__ = ["capture", "core", "highgui", "imgcodecs", "imgproc", "models", "native", "ops",
           "prelude", "runtime", "videoio"]


def __getattr__(name):
    import importlib

    if name in __all__:
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
