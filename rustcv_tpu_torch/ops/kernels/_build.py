"""Build and load the port's CUDA kernels (``rustcv_tpu_torch/csrc``).

At first use, ``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` (one
``nvcc`` per source, all started together) and links the objects into one
shared library with a plain C interface, which is loaded with ``ctypes``
(no PyTorch headers, so the build takes seconds). The library is cached in
``build/rustcv_tpu_torch/`` beside the package, under a name made from a
hash of the sources and the flags, so an edited source rebuilds and an
unchanged one loads at once.

Every C launcher takes device pointers, ints and the CUDA stream, and
returns ``cudaGetLastError()``; :func:`check` raises when it is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "rustcv_tpu_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C function → argument types (pointers and the stream as c_void_p).
_SIGNATURES = {
    "rcv_blur_sobel_mag": (_P, _P, _I, _I, _I, _P),
    "rcv_yuyv_decode_interleave": (_P, _P, _P, _I, _I, _P, _P, _I, _I, _I, _P),
    "rcv_yuyv_tick_fused": (_P, _P, _P, _I, _I, _P, _P, _I, _I, _I, _P),
    "rcv_harris_response_f32": (_P, _P, _I, _I, _I, _F, _P),
    "rcv_harris_response_i32": (_P, _P, _I, _I, _I, _I, _P),
    "rcv_mosaic_shuffle": (_I, _P, _P, _P, _P, _I, _I, _I, _P),
}

_lock = threading.Lock()
_lib = None
# What the last build or load did: library path, seconds, nvcc's log.
build_info: dict = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH); the CUDA "
            "kernels of rustcv_tpu_torch need the CUDA toolkit to build"
        )
    return found


def _compile() -> Path:
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    lib_path = BUILD_DIR / f"librustcv_kernels_{h.hexdigest()[:16]}.so"
    if lib_path.is_file():
        build_info.update(path=str(lib_path), seconds=0.0, log="(cached)")
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    objs = [tmp.with_suffix(f".{src.stem}.o") for src in sources]
    compiles = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                for src, obj in zip(sources, objs)]
    link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
    t0 = time.perf_counter()
    try:
        with ThreadPoolExecutor(max_workers=len(compiles)) as pool:
            procs = list(pool.map(_run, compiles))  # one nvcc per source, in parallel
        procs.append(_run(link))
    except RuntimeError:
        tmp.unlink(missing_ok=True)
        raise
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    log = "\n".join(p.stderr for p in procs)
    os.replace(tmp, lib_path)  # atomic: concurrent builders never see half a file
    build_info.update(path=str(lib_path), seconds=seconds, log=log)
    return lib_path


def _run(cmd) -> subprocess.CompletedProcess:
    """Run one nvcc command; raise with its output if it fails."""
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
    return proc


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_compile()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            lib.rcv_error_string.argtypes = [ctypes.c_int]
            lib.rcv_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(code: int, kernel: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if code != 0:
        msg = library().rcv_error_string(code).decode()
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {code} ({msg})")


def stream_of(t) -> int:
    """The handle of PyTorch's current CUDA stream on ``t``'s device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def expect(t, name: str, dtype, shape, device=None) -> None:
    """Raise ValueError unless ``t`` is a contiguous tensor of ``dtype`` and
    ``shape`` (on ``device`` when given) — what the kernels take."""
    import torch

    if not isinstance(t, torch.Tensor):
        raise ValueError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name} must be {dtype} of shape {tuple(shape)}, got {t.dtype} {tuple(t.shape)}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {t.device}")
