"""Shared helpers of the ``tests/test_torch_cv2_*.py`` files, which hold
``rustcv_tpu_torch.cv2`` against ``rustcv_tpu.cv2``:

* :func:`later_names`: which public names of the reference's facade its
  later modules bring (ROADMAP Queue 1 item 7b: ``_calib3d``, ``_algos``,
  ``_extras``, ``_misc3``, the submodules and the ``detail_*`` aliases),
  read from the reference itself; the rest is the core (item 7a);
* :func:`same`: a reference result against the port's, equal or within a
  bar;
* :func:`as_on_the_card`: CPU tensors that refuse a numpy view unless
  they were downloaded, as CUDA tensors do;
* :func:`port_args`: the one rule for which arguments the port receives as
  CPU tensors;
* :data:`BARS` and :data:`CHECKS`: the names whose port result is not
  bit-equal to the reference's (the reference's host form against the
  port's tensor op), with their bars.

It imports no jax at import time (``tests/test_torch_cuda.py`` runs it on
the card's machine, which has none).
"""
from __future__ import annotations

import contextlib
import inspect
import math
import types

import numpy as np
import torch

LATER_MODULES = ("_calib3d", "_algos", "_extras", "_misc3")


def later_names() -> set:
    """The reference's public names that only its 7b modules bring."""
    import importlib

    import rustcv_tpu.cv2 as R

    out = set()
    for mod in LATER_MODULES:
        m = importlib.import_module(f"rustcv_tpu.cv2.{mod}")
        out |= set(getattr(m, "__all__", None) or
                   [n for n in vars(m) if not n.startswith("_")])
    for n in dir(R):
        v = getattr(R, n)
        if n.startswith("detail_") or (isinstance(v, types.ModuleType)
                                       and v.__name__.startswith("rustcv_tpu.cv2.")):
            out.add(n)
    return {n for n in out if hasattr(R, n) and not n.startswith("_")}


def _host(v):
    if isinstance(v, torch.Tensor):
        return v.numpy()
    return v


def same(ref, port, bar, where="result"):
    """Assert ``port`` holds ``ref``: equal, or within ``bar`` (max |diff|)."""
    ref, port = _host(ref), _host(port)
    if isinstance(ref, np.ndarray):
        port = np.asarray(port)
        assert port.shape == ref.shape, (where, port.shape, ref.shape)
        assert port.dtype == ref.dtype, (where, port.dtype, ref.dtype)
        if ref.dtype == object:
            for r, p in zip(ref.ravel(), port.ravel()):
                same(r, p, bar, where)
            return
        if callable(bar):
            bar = bar(ref)
        if bar:
            diff = np.abs(ref.astype(np.float64) - port.astype(np.float64))
            assert np.array_equal(np.isnan(diff), np.isnan(ref.astype(np.float64))), where
            assert np.nanmax(diff, initial=0.0) <= bar, (where, np.nanmax(diff))
        else:
            np.testing.assert_array_equal(port, ref, err_msg=where)
        return
    if isinstance(ref, (tuple, list)):
        assert isinstance(port, (tuple, list)), (where, type(port))
        assert len(port) == len(ref), (where, len(port), len(ref))
        for i, (r, p) in enumerate(zip(ref, port)):
            same(r, p, bar, f"{where}[{i}]")
        return
    if isinstance(ref, dict):
        assert set(port) == set(ref), where
        for k in ref:
            same(ref[k], port[k], bar, f"{where}[{k!r}]")
        return
    if isinstance(ref, float) and isinstance(port, float):
        if ref == port:
            return
        if math.isnan(ref):
            assert math.isnan(port), where
        else:
            assert abs(ref - port) <= (bar or 0.0), (where, ref, port)
        return
    if ref is None or isinstance(ref, (bool, int, str, bytes, np.generic)):
        assert type(port).__name__ == type(ref).__name__ or (
            isinstance(ref, (int, float, np.generic)) and not isinstance(ref, bool)), (where, ref, port)
        if isinstance(ref, (float, np.floating)) and bar:
            assert abs(float(ref) - float(port)) <= bar, (where, ref, port)
        else:
            assert port == ref, (where, ref, port)
        return
    # value objects (KeyPoint, DMatch, RotatedRect, ...): their fields
    assert type(port).__name__ == type(ref).__name__, (where, type(ref), type(port))
    fields = getattr(type(ref), "__slots__", None) or list(getattr(ref, "__dict__", {}))
    for f in fields:
        if f.startswith("_"):
            continue
        same(getattr(ref, f), getattr(port, f), bar, f"{where}.{f}")


def _refuse(what):
    raise TypeError(f"{what} of a tensor that is not on the host (a CUDA tensor has no "
                    "numpy view): the facade must download it first")


@contextlib.contextmanager
def as_on_the_card(monkeypatch):
    """Within the block CPU tensors behave as tensors on the card do towards
    numpy: ``np.asarray(t)`` and ``t.numpy()`` raise unless ``t`` came from
    a download (``.cpu()``, ``.to("cpu")``). Code that passes here on CPU
    tensors downloads explicitly."""
    real = {n: getattr(torch.Tensor, n) for n in ("cpu", "to", "numpy", "__array__")}

    def host(t):
        t._on_host = True
        return t

    def cpu(self, *a, **k):
        return host(real["cpu"](self, *a, **k).clone())

    def to(self, *a, **k):
        out = real["to"](self, *a, **k)
        dev = k.get("device", a[0] if a and isinstance(a[0], (str, torch.device)) else None)
        return host(out.clone()) if dev is not None and torch.device(dev).type == "cpu" else out

    def numpy(self, *a, **k):
        if not getattr(self, "_on_host", False):
            _refuse("numpy()")
        return real["numpy"](self, *a, **k)

    def array(self, *a, **k):
        if not getattr(self, "_on_host", False):
            _refuse("np.asarray()")
        return real["__array__"](self, *a, **k)

    with monkeypatch.context() as mp:
        mp.setattr(torch.Tensor, "cpu", cpu)
        mp.setattr(torch.Tensor, "to", to)
        mp.setattr(torch.Tensor, "numpy", numpy)
        mp.setattr(torch.Tensor, "__array__", array)
        yield


# Bars (max |diff|) where the port's result is not bit-equal to the
# reference's, with their source. The reference runs the golden host form
# on a host Mat (or JAX on its CPU); the port runs the tensor op on the
# Mat's device.
BARS = {
    "inpaint": (1, "±1 LSB: the diffusion inpaint (docs/OPS.md; "
                   "tests/test_torch_photo.py)"),
    "cornerHarris": (1e-6, "atol 1e-6, the reference's own bar for its "
                           "Harris kernel (tests/test_pallas_harris.py)"),
    "cornerSubPix": (1e-3, "1e-3 px, corner_sub_pix's bar "
                           "(tests/test_torch_filters_ext.py)"),
}
BARS["dct"] = (0.0255, "atol 1e-4 on unit-scale data (tests/test_torch_transform_template.py), "
                       "×255 for u8 data: the DCT is linear")
BARS["matchTemplate"] = (
    lambda ref: 1e-4 * max(1.0, float(np.abs(ref).max())),
    "max |Δ| / max(1, max |oracle|) < 1e-4 (tests/test_torch_transform_template.py)")
BARS["addWeighted"] = (1, "±1 LSB at non-dyadic weights: the device form rounds a "
                          "float32 sum (tests/test_torch_arith.py)")
# The float corner responses: atol 3e-6 · max(1, max |response|), the
# reference's own bar (tests/test_corner.py, tests/test_torch_corner_fast_brief.py).
for _n in ("cornerMinEigenVal", "preCornerDetect"):
    BARS[_n] = (lambda ref: 3e-6 * max(1.0, float(np.abs(ref).max())),
                "atol 3e-6 · max(1, max |response|) (tests/test_corner.py)")


def _kmeans_check(ref, port, ra, pa):
    """k-means: the float32 twin against JAX's: centers within 1e-3,
    labels 99.9 % equal, compactness within 1e-3 relative
    (tests/test_torch_segment.py::test_kmeans_matches_the_oracle)."""
    assert abs(port[0] - ref[0]) <= 1e-3 * abs(ref[0])
    assert port[1].dtype == ref[1].dtype and port[1].shape == ref[1].shape
    assert (port[1] == ref[1]).mean() > 0.999
    assert port[2].dtype == ref[2].dtype and np.abs(port[2] - ref[2]).max() < 1e-3


def _eigen_check(ref, port, ra, pa):
    """The eigenvalues within 3e-6 · max(1, max |λ|); the eigenvectors
    collinear (|dot| > 0.999) where the eigenvalues are separated by more
    than 1e-4 of that scale (tests/test_torch_corner_fast_brief.py)."""
    assert port.shape == ref.shape and port.dtype == ref.dtype
    scale = max(1.0, float(np.abs(ref[..., :2]).max()))
    assert np.abs(port[..., :2] - ref[..., :2]).max() <= 3e-6 * scale
    sep = (ref[..., 0] - ref[..., 1]) > 1e-4 * scale
    for base in (2, 4):
        dot = np.abs(port[..., base] * ref[..., base] + port[..., base + 1] * ref[..., base + 1])
        assert dot[sep].min() > 0.999


CHECKS = {"kmeans": _kmeans_check, "cornerEigenValsAndVecs": _eigen_check}


# The one rule for which arguments the port receives as CPU tensors: an
# image (a 2-D or 3-D array) passed under one of the image parameter names
# of the cv2 signatures (or in an ``images`` list), or k-means' data. Points, matrices, masks,
# kernels, tables, output buffers and lists go to both sides as the same
# numpy values.
IMAGE_PARAMS = {
    "src", "src1", "src2", "image", "img", "img1", "img2", "frame", "mat",
    "prevImg", "nextImg", "prev", "next", "left", "right", "templ",
    "probImage", "gray", "inputImage", "templateImage", "array", "m",
    "data",
}


def port_args(func, args, kwargs):
    """``args``/``kwargs`` with the images of :data:`IMAGE_PARAMS` as CPU
    tensors."""
    try:
        names = list(inspect.signature(func).parameters)
    except ValueError:  # a builtin's constructor (the error classes)
        names = []

    def conv(name, v):
        if name in IMAGE_PARAMS and isinstance(v, np.ndarray) and v.ndim in (2, 3):
            return torch.from_numpy(v.copy())
        if name == "images" and isinstance(v, list):
            return [conv("image", x) for x in v]
        return v

    return (tuple(conv(names[i] if i < len(names) else "", v)
                  for i, v in enumerate(args)),
            {k: conv(k, v) for k, v in kwargs.items()})
