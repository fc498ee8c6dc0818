"""imgcodecs — imread / imwrite / imencode / imdecode with BGR discipline
(port of ``rustcv_tpu.imgcodecs``; ``rustcv/src/imgcodecs/mod.rs:9-76``).

JPEG only, through the reference's ``"tpu"`` backend, which here means the
port's device codec: :mod:`..ops.jpeg_encode` (colour, subsampling, FDCT
and quantization on the Mat's device, the Huffman coding in the port's C++
coder) and :mod:`..ops.jpeg_tpu` (entropy decode on the host,
dequantization, IDCT, upsampling and colour on the device). It is the
default backend, since the port has no other. The reference's ``"host"``
backend and every other format go through Pillow there, and raise
``not_ported`` here; so do ``imreadmulti``, ``imwritemulti``, ``imcount``
and the metadata forms.
"""

from __future__ import annotations

import os

from ..core.errors import NEEDS_PILLOW, CameraError, not_ported
from ..core.mat import Mat

_JPEG = ("jpg", "jpeg")


def _check(backend: str, ext: str, what: str) -> None:
    if backend == "host":
        raise not_ported(f"{what}'s host backend", NEEDS_PILLOW, "8")
    if backend != "tpu":
        raise ValueError(f"{what}: unknown backend {backend!r}")
    if ext not in _JPEG:
        raise not_ported(f"{what} of {ext!r} images", NEEDS_PILLOW, "8")


def _suffix(path: str) -> str:
    return os.path.splitext(path)[1].lower().lstrip(".")


def imencode(ext: str, mat: Mat, quality: int = 95, backend: str = "tpu") -> bytes:
    """Encode a BGR (or gray) Mat to baseline JFIF bytes (OpenCV
    ``imencode``), 4:2:0, on the Mat's device (a host Mat is uploaded to
    its device first)."""
    from ..ops.jpeg_encode import encode_jpeg

    _check(backend, ext.lower().lstrip("."), "imencode")
    if mat.is_empty():
        raise CameraError("imencode: empty Mat")
    img = mat.device()
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    return encode_jpeg(img, quality=quality)


def imdecode(data: bytes, backend: str = "tpu", device="cuda") -> Mat:
    """Decode JPEG bytes to a BGR Mat on ``device`` (OpenCV ``imdecode``)."""
    from ..core.mat import torch_device
    from ..ops.jpeg_tpu import decode_jpeg_tpu

    _check(backend, "jpg" if bytes(data[:2]) == b"\xff\xd8" else "non-JPEG", "imdecode")
    return Mat.from_device(decode_jpeg_tpu(data, torch_device(device)))


def imread(path: str, device="cuda") -> Mat:
    """Load a JPEG file as a BGR Mat on ``device``. Raises on missing or
    corrupt files."""
    _check("tpu", _suffix(path), "imread")
    if not os.path.exists(path):
        raise CameraError(f"imread: no such file: {path}")
    with open(path, "rb") as f:
        data = f.read()
    try:
        return imdecode(data, device=device)
    except ValueError as e:  # the entropy decoder's: corrupt or unsupported
        raise CameraError(f"imread: cannot decode {path}: {e}") from e


def imwrite(path: str, mat: Mat) -> bool:
    """Write a BGR Mat to a JPEG file (format from the extension), at
    quality 75, the default of the reference's Pillow save."""
    _check("tpu", _suffix(path), "imwrite")
    if mat.is_empty():
        return False
    data = imencode(".jpg", mat, 75)
    try:
        with open(path, "wb") as f:
            f.write(data)
    except OSError:
        return False
    return True


__all__ = ["imread", "imwrite", "imencode", "imdecode"]
