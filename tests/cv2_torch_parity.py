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
  port's tensor op), with their bars;
* :func:`later_callables` and :func:`later_plan`: item 7b's callables of
  either facade and their arguments, made for one side without the other
  (the card's tests sweep the port's alone).

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

from cv2_callcov import camK, dist5, img_u8, pts2f, pts3f

LATER_MODULES = ("_calib3d", "_algos", "_extras", "_misc3")


# The submodules whose public callables the 7b sweeps call.
SUBMODULES = ("aruco", "barcode", "detail", "dnn", "fisheye", "mcc", "parallel", "samples",
              "utils", "utils.logging", "videoio_registry")


def facade_get(cv, dotted):
    """``cv.a.b`` of ``"a.b"``."""
    obj = cv
    for part in dotted.split("."):
        obj = getattr(obj, part)
    return obj


def later_callables(cv) -> list:
    """The 7b callables of the facade ``cv`` (the reference's or the port's),
    read from ``cv`` alone: the four later modules' ``__all__`` callables,
    the ``detail_*`` aliases, and (dotted) the public callables each of
    :data:`SUBMODULES` defines."""
    import importlib

    out = set()
    for mod in LATER_MODULES:
        m = importlib.import_module(f"{cv.__name__}.{mod}")
        out |= {n for n in m.__all__ if callable(getattr(cv, n, None))}
    out |= {n for n in dir(cv) if n.startswith("detail_")}
    subs = []
    for mod in SUBMODULES:
        m = facade_get(cv, mod)
        subs += [f"{mod}.{n}" for n, v in sorted(vars(m).items())
                 if not n.startswith("_") and callable(v) and not isinstance(v, types.ModuleType)
                 and getattr(v, "__module__", None) == m.__name__]
    return sorted(out) + subs


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


# The calls of ROADMAP Queue 1 item 7b that reach the ones above.
BARS["find4QuadCornerSubpix"] = (1e-3, "cornerSubPix's bar: 1e-3 px")
BARS["goodFeaturesToTrackWithQuality"] = (
    lambda ref: 3e-6 * max(1.0, float(np.abs(ref).max())),
    "the corners equal (integer pixels), the quality cornerMinEigenVal's or "
    "cornerHarris's value at each: atol 3e-6 · max(1, max |response|)")


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


def _decoded_check(ref, port, ra, pa):
    """imdecodeWithMetadata of each side's own PNG bytes (other bytes of
    the same pixels): the same image, keys and values."""
    same(ref[0], port[0], 0)
    assert list(ref[1:]) == list(port[1:])


def _encoded_check(ref, port, ra, pa):
    """imencodeWithMetadata's bytes differ (zlib level, filters); read back
    by the port's own decoder (held to Pillow's in
    tests/test_torch_image_formats.py) they give the same image and text."""
    from rustcv_tpu_torch.cv2._extras import imdecodeWithMetadata

    assert ref[0] is port[0] is True
    _decoded_check(imdecodeWithMetadata(_host(ref[1])), imdecodeWithMetadata(_host(port[1])),
                   ra, pa)


def _frames_check(ref, port, ra, pa):
    """imdecodemulti of each side's own PNG bytes: the same frames."""
    assert ref[0] is port[0] is True
    same(ref[1], port[1], 0)


def _animation_check(ref, port, ra, pa):
    """imdecodeanimation of each side's own PNG bytes: the same frames,
    durations and loop."""
    assert ref[0] is port[0]
    same(ref[1].frames, port[1].frames, 0)
    assert ref[1].durations == port[1].durations and ref[1].loop_count == port[1].loop_count


def _animation_bytes_check(ref, port, ra, pa):
    """imencodeanimation's GIF bytes differ (the port's writer and median
    cut, not Pillow's: tests/test_torch_multipage_formats.py holds its bar);
    read back by the port's decoder (held to Pillow's there) these frames of
    at most 256 colours give the same frames, durations and loop."""
    from rustcv_tpu_torch.cv2._extras import imdecodeanimation

    assert ref[0] is port[0] is True
    _animation_check(imdecodeanimation(_host(ref[1])), imdecodeanimation(_host(port[1])), ra, pa)


CHECKS = {"kmeans": _kmeans_check, "cornerEigenValsAndVecs": _eigen_check,
          "imdecodeWithMetadata": _decoded_check, "imencodeWithMetadata": _encoded_check,
          "imdecodemulti": _frames_check, "imdecodeanimation": _animation_check,
          "imencodeanimation": _animation_bytes_check}


# The one rule for which arguments the port receives as CPU tensors: an
# image (a 2-D or 3-D array) passed under one of the image parameter names
# of the cv2 signatures (or in an ``images`` or ``srcImgs`` list), or
# k-means' data. Points, matrices, masks, kernels, tables, output buffers
# and lists go to both sides as the same numpy values.
IMAGE_PARAMS = {
    "src", "src1", "src2", "image", "img", "img1", "img2", "frame", "mat",
    "prevImg", "nextImg", "prev", "next", "left", "right", "templ",
    "probImage", "gray", "inputImage", "templateImage", "array", "m",
    "data", "distorted", "input_image", "disparity", "depth",
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
        if name in ("images", "srcImgs") and isinstance(v, list):
            return [conv("image", x) for x in v]
        return v

    return (tuple(conv(names[i] if i < len(names) else "", v)
                  for i, v in enumerate(args)),
            {k: conv(k, v) for k, v in kwargs.items()})


# Per-name arguments of the 7b callables, made for one side (``cv`` is the
# reference's facade or the port's) where the shared synthesizer makes the
# reference's objects (dictionaries, boards, trackbars), writes fixed paths
# under /tmp or needs Pillow (neither is on the card's machine).
def _dict(cv):
    return cv.aruco.getPredefinedDictionary(0)


def _charuco(cv):
    return cv.aruco.CharucoBoard((4, 3), 0.08, 0.05, _dict(cv))


def _marker(cv):
    """Marker 0 of the dictionary on a white margin, 96×96."""
    out = np.full((96, 96), 255, np.uint8)
    out[16:80, 16:80] = cv.aruco.generateImageMarker(_dict(cv), 0, 64)
    return out


def _charuco_image(cv):
    """The ChArUco board of :func:`_charuco` on a white margin: markers
    that its detector finds, and inner corners to refine."""
    out = np.full((200, 260), 255, np.uint8)
    out[20:180, 20:240] = _charuco(cv).generateImage((220, 160))
    return out


def _marker_quads(cv):
    corners, ids, _ = cv.aruco.detectMarkers(_charuco_image(cv), _dict(cv))
    return [np.asarray(c) for c in corners], ids


def _trackbar(cv, *extra):
    cv.namedWindow("callcov")
    cv.createTrackbar("tb", "callcov", 0, 10, lambda *_: None)
    return ("tb", "callcov") + tuple(extra)


LATER_LOCAL = {
    "aruco.detectMarkers": lambda tmp, cv: ((_marker(cv), _dict(cv)), {}),
    "aruco.estimatePoseBoard": lambda tmp, cv: (
        ([pts2f(4).reshape(1, 4, 2)], np.array([[0]], np.int32),
         cv.aruco.GridBoard((2, 2), 0.05, 0.01, _dict(cv)), camK(), dist5(), np.zeros(3),
         np.zeros(3)), {}),
    "aruco.generateImageMarker": lambda tmp, cv: ((_dict(cv), 0, 64), {}),
    "aruco.interpolateCornersCharuco": lambda tmp, cv: (
        (*_marker_quads(cv), _charuco_image(cv), _charuco(cv)), {}),
    "aruco_ArucoDetector": lambda tmp, cv: ((_dict(cv),), {}),
    "aruco.ArucoDetector": lambda tmp, cv: ((_dict(cv),), {}),
    "aruco_Board": lambda tmp, cv: (
        ([pts3f(4).reshape(4, 3)], _dict(cv), np.array([[0]], np.int32)), {}),
    "aruco.Board": lambda tmp, cv: (
        ([pts3f(4).reshape(4, 3)], _dict(cv), np.array([[0]], np.int32)), {}),
    "aruco_CharucoBoard": lambda tmp, cv: (((4, 3), 0.08, 0.05, _dict(cv)), {}),
    "aruco.CharucoBoard": lambda tmp, cv: (((4, 3), 0.08, 0.05, _dict(cv)), {}),
    "aruco_CharucoDetector": lambda tmp, cv: ((_charuco(cv),), {}),
    "aruco.CharucoDetector": lambda tmp, cv: ((_charuco(cv),), {}),
    "aruco_GridBoard": lambda tmp, cv: (((2, 2), 0.05, 0.01, _dict(cv)), {}),
    "aruco.GridBoard": lambda tmp, cv: (((2, 2), 0.05, 0.01, _dict(cv)), {}),
    "aruco.Dictionary": lambda tmp, cv: ((_dict(cv)._d,), {}),
    "getTrackbarPos": lambda tmp, cv: (_trackbar(cv), {}),
    "setTrackbarPos": lambda tmp, cv: (_trackbar(cv, 1), {}),
    "setTrackbarMin": lambda tmp, cv: (_trackbar(cv, 0), {}),
    "setTrackbarMax": lambda tmp, cv: (_trackbar(cv, 10), {}),
    "readOpticalFlow": lambda tmp, cv: ((_flo(tmp, cv),), {}),
    "loadMesh": lambda tmp, cv: ((_mesh(tmp, cv),), {}),
    "loadPointCloud": lambda tmp, cv: ((_cloud(tmp, cv),), {}),
    "imdecodemulti": lambda tmp, cv: ((_png_bytes(cv),), {}),
    "imdecodeWithMetadata": lambda tmp, cv: ((_png_bytes(cv), 1), {}),
    "imdecodeanimation": lambda tmp, cv: ((_png_bytes(cv),), {}),
    "imreadanimation": lambda tmp, cv: ((_png_file(tmp, cv),), {}),
    "imencodeanimation": lambda tmp, cv: ((".gif", _animation(cv)), {}),
    "imwriteanimation": lambda tmp, cv: ((str(tmp / "a.gif"), _animation(cv)), {}),
    "KeyPoint_overlap": lambda tmp, cv: ((cv.KeyPoint(10, 10, 8), cv.KeyPoint(13, 11, 6)), {}),
    "Animation": lambda tmp, cv: ((), {}),
    "loadChromaticAberrationParams": lambda tmp, cv: ((_ca_node(tmp, cv),), {}),
    "detail.computeImageFeatures": lambda tmp, cv: (
        (cv.ORB_create(), [img_u8(3, 96, 128), img_u8(3, 96, 128)[::-1].copy()]), {}),
    "detail.computeImageFeatures2": lambda tmp, cv: ((cv.ORB_create(), img_u8(3, 96, 128)), {}),
    "detail.leaveBiggestComponent": lambda tmp, cv: (
        ([cv.detail.ImageFeatures(i, (40, 32)) for i in range(4)], _matches(cv), 1.0), {}),
    "detail.matchesGraphAsString": lambda tmp, cv: (
        (["a.png", "b.png", "c.png", "d.png"], _matches(cv), 1.0), {}),
}


def _ca_node(tmp, cv):
    path = str(tmp / "ca.json")
    fs = cv.FileStorage(path, cv.FILE_STORAGE_WRITE)
    fs.write("coefficients", np.arange(12, dtype=np.float32).reshape(4, 3))
    fs.write("image_width", 640)
    fs.write("image_height", 480)
    fs.write("degree", 1)
    fs.release()
    return cv.FileStorage(path, cv.FILE_STORAGE_READ).root()


def _matches(cv):
    """Pairwise matches of four images: 0-1 and 2-3 confident, 1-2 not."""
    out = []
    for (i, j), conf in (((0, 1), 2.5), ((1, 2), 0.4), ((2, 3), 1.7), ((1, 0), 2.5)):
        mi = cv.detail.MatchesInfo()
        mi.src_img_idx, mi.dst_img_idx, mi.confidence = i, j, conf
        mi.matches = [cv.DMatch(k, k, 0, float(k)) for k in range(3 + i)]
        mi.num_inliers = 2 + j
        out.append(mi)
    return out


def _flo(tmp, cv):
    path = str(tmp / "in.flo")
    cv.writeOpticalFlow(path, np.random.default_rng(3).normal(0, 2, (32, 40, 2)).astype(np.float32))
    return path


def _mesh(tmp, cv):
    path = str(tmp / "mesh.ply")
    cv.saveMesh(path, pts3f(4).reshape(-1, 3), np.array([[0, 1, 2]], np.int32))
    return path


def _cloud(tmp, cv):
    path = str(tmp / "cloud.ply")
    cv.savePointCloud(path, pts3f(4).reshape(-1, 3))
    return path


def _host_image(cv, a):
    """``a`` as the side passes an image it means to stay on the host: the
    reference's numpy array, the port's CPU tensor (a numpy image would go
    to the card)."""
    return a if cv.__name__ == "rustcv_tpu.cv2" else torch.from_numpy(a)


def _png_bytes(cv):
    return cv.imencode(".png", _host_image(cv, img_u8()))[1]


def _png_file(tmp, cv):
    path = str(tmp / "in.png")
    cv.imwrite(path, _host_image(cv, img_u8()))
    return path


def _animation(cv):
    a = cv.Animation()
    a.frames = [img_u8(), img_u8()[::-1].copy()]
    a.durations = [100, 100]
    return a


def later_plan(name, func, tmp_path, cv):
    """``(args, kwargs)`` for the 7b callable ``name`` of the facade ``cv``
    (the reference's or the port's): cv2_callcov's synthesized arguments
    (32×40 images), or :data:`LATER_LOCAL`'s, with the synthesizer's fixed
    /tmp paths moved under ``tmp_path``."""
    from cv2_callcov import OVERRIDES, build_call

    if name in LATER_LOCAL:
        return LATER_LOCAL[name](tmp_path, cv)
    plan = build_call(func, name, OVERRIDES)
    assert not isinstance(plan, str), f"{name}: {plan}"
    args, kwargs = plan

    def relocate(v):
        if isinstance(v, str) and v.startswith("/tmp/rcv_callcov"):
            return str(tmp_path / v.rsplit("/", 1)[1])
        return v

    return tuple(relocate(v) for v in args), {k: relocate(v) for k, v in kwargs.items()}
