"""cv2.utils role: debugging/logging helpers (the port of
``rustcv_tpu.cv2.utils``)."""
from . import logging  # noqa: F401
from .._device import _a


def dumpInputArray(a):
    a = _a(a)
    return (f"InputArray: size(-1x-1) kind=MAT flags=0 total={a.size} "
            f"dims={a.ndim} size={a.shape}")


def dumpBool(v):
    return f"Bool: {bool(v)}"


def dumpInt(v):
    return f"Int: {int(v)}"


def dumpFloat(v):
    return f"Float: {float(v):.2f}"


def dumpDouble(v):
    return f"Double: {float(v):.2f}"


def dumpCString(s):
    return f"String: {s}"
