"""cv2.parallel role: backend selection is a no-op — host-side
parallelism lives in the native worker pools (setNumThreads) and
device-side in PyTorch and the CUDA kernels (the port of
``rustcv_tpu.cv2.parallel``)."""


def setParallelForBackend(backendName, propagateNumThreads=True):
    return True
