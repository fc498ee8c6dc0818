"""rustcv_tpu_torch — the PyTorch/CUDA port of :mod:`rustcv_tpu`.

The JAX package ``rustcv_tpu`` stays the reference; this package mirrors its
module names (``capture``, ``models``, ``ops``, ``runtime``, ``parallel``,
``utils``, and the OpenCV-style facade ``prelude``, ``imgproc``,
``highgui``, ``imgcodecs``, ``videoio``) and computes the same bytes
with PyTorch for the glue and hand-written CUDA kernels (``csrc/``) where the
reference used Pallas. It imports nothing of the JAX package: its core
types (``core``) and its host JPEG coder (``native``) are its own copies.

    from rustcv_tpu_torch.capture import SimulationDriver
    from rustcv_tpu_torch.runtime import MultiStreamEngine
    from rustcv_tpu_torch.prelude import Mat, TickMeter, VideoCapture
    from rustcv_tpu_torch import highgui, imgcodecs, imgproc
    from rustcv_tpu_torch.parallel import stream_mesh

Importing this package is light: no torch and no kernel build until a
submodule that needs them is used. ``__version__``, ``Mat`` and
``TickMeter`` resolve at first use too.
"""

_MODULES = ("capture", "core", "highgui", "imgcodecs", "imgproc", "models", "native", "ops",
            "parallel", "prelude", "runtime", "utils", "videoio")
_NAMES = {"__version__": ".version", "Mat": ".core", "TickMeter": ".core"}  # name → its module
__all__ = ["Mat", "TickMeter", "__version__", *_MODULES]


def __getattr__(name):
    import importlib

    if name in _MODULES:
        return importlib.import_module(f".{name}", __name__)
    if name in _NAMES:
        return getattr(importlib.import_module(_NAMES[name], __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
