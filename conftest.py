"""Session set-up for every test run from the repository's root.

The JAX package builds its native library (``rustcv_tpu/native/
librustcv_capture.so``) in place, the first time a process asks for it,
with no lock: g++ writes straight to the final path. Under pytest-xdist
every worker collects the test modules, and several modules ask for the
library at import (``tests/test_native.py``, ``test_mser.py``,
``test_jpeg_encode.py``, ``test_v4l2.py``, ``test_encode_packed.py``), so on
a fresh checkout several workers link the same file at once; a worker that
loads it while another linker is still writing it fails ("file too short")
and keeps that failure for the whole session, so its tests skip or fail.

``pytest_configure`` builds the library once, in the xdist controller (or a
plain run) before any worker starts, under a file lock against a second
pytest run in the same checkout; the workers then find it finished and up
to date. Where the JAX package cannot be imported (a host without jax), it
does nothing.
"""

import fcntl
import os

_HERE = os.path.dirname(os.path.abspath(__file__))


def pytest_configure(config):
    if hasattr(config, "workerinput"):  # an xdist worker: the controller built it
        return
    try:
        from rustcv_tpu import native
    except ImportError:
        return
    lock_dir = os.path.join(_HERE, "build")
    os.makedirs(lock_dir, exist_ok=True)
    with open(os.path.join(lock_dir, "rustcv_tpu_native.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            native.get_lib()
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
