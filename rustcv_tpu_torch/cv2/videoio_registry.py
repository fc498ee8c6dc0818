"""cv2.videoio_registry role: enumerate the port's capture backends (the
port of ``rustcv_tpu.cv2.videoio_registry``)."""
from .. import videoio as _vio

_BACKENDS = {1800: "V4L2", 2000: "RUSTCV_SIM", 1900: "RUSTCV_AVI"}


def getBackends():
    return list(_BACKENDS.keys())

def getBackendName(api):
    return _BACKENDS.get(int(api), "UNKNOWN")

def getCameraBackends():
    return list(_BACKENDS.keys())

def getStreamBackends():
    return [1900]

def getWriterBackends():
    return [1900]

def hasBackend(api):
    return int(api) in _BACKENDS

def isBackendBuiltIn(api):
    return int(api) in _BACKENDS
