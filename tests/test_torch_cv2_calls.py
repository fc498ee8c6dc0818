"""The port's cv2 facade (``rustcv_tpu_torch.cv2``) call for call against the
reference's (``rustcv_tpu.cv2``): one case per public callable of the core
modules (``__init__``, ``_classes``, ``_util``, ``_filestorage``; the
constants are ``tests/test_torch_cv2_constants.py``'s).

Each case builds the same seeded arguments twice with ``cv2_callcov``'s
synthesizer (32×40 images), hands one set to the reference as numpy and the
other to the port with its images as CPU tensors (the one rule:
:func:`port_args`), and holds the results equal: exactly, or within the bar
that :data:`BARS` states for the name. Arguments written in place (draws,
output buffers) are compared after the call too. A reference call that
raises must raise the same exception class (by name) in the port.
"""
from __future__ import annotations

import inspect
import types

import numpy as np
import pytest
import torch

import rustcv_tpu.cv2 as R
import rustcv_tpu_torch.cv2 as P
from cv2_callcov import OVERRIDES, build_call, img_u8
from cv2_torch_parity import BARS, CHECKS, as_on_the_card, later_names, port_args, same

CORE_MODULES = ("rustcv_tpu.cv2", "rustcv_tpu.cv2._classes",
                "rustcv_tpu.cv2._util", "rustcv_tpu.cv2._filestorage")
EXCLUDE = {"builtins_max", "builtins_min"}  # Python's own min/max


def _core_callables():
    out = []
    later = later_names()
    for n in sorted(dir(R)):
        if n.startswith("_") or n in EXCLUDE or n in later:
            continue
        f = getattr(R, n)
        if isinstance(f, types.ModuleType) or not callable(f):
            continue
        if getattr(f, "__module__", None) in CORE_MODULES:
            out.append(n)
    return out


CORE = _core_callables()
FUNCTIONS = [n for n in CORE if not isinstance(getattr(R, n), type)]
CLASSES = [n for n in CORE if isinstance(getattr(R, n), type)]

# Names whose result is not a function of the arguments (a clock, the
# build) or whose value names the package: only the result's type is held.
TYPE_ONLY = {
    "getTickCount": "a clock", "getCPUTickCount": "a clock",
    "getBuildInformation": "reports torch and CUDA, the reference JAX",
}

# The reference's swallow-all wrappers return False / 0 / [] on any
# exception; the port lets its own not_ported through. None of the sweep's
# calls reaches one any more: the synthesized imwritemulti writes a ".png",
# an animated PNG on both sides (item 8d-i), and imcount and imreadmulti of
# the PNG answer as the reference's (item 8b).
RAISES_WHERE_REFERENCE_SWALLOWS: set = set()


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(255.0 ** 2 / mse) if mse else np.inf


def _jpeg_check(ref, port, ra, pa):
    """JPEG bytes differ (the port's encoder, not Pillow's): both decode to
    the input's size, the port's within 0.5 dB PSNR of the reference's
    (the encoder's stated tolerance, tests/test_torch_codecs_host.py)."""
    assert port[0] is ref[0] is True
    img = ra[1]
    want, got = R.imdecode(ref[1]), R.imdecode(port[1])
    assert got.shape == want.shape == img.shape
    assert _psnr(got, img) >= _psnr(want, img) - 0.5


CHECKS = dict(CHECKS, imencode=_jpeg_check)

# Per-name arguments where the shared synthesizer writes fixed paths under
# /tmp (another test reads them concurrently) or takes a file from it.
_LOCAL = {}


def _png(tmp_path):
    path = str(tmp_path / "in.png")
    R.imwrite(path, img_u8())
    return path


_LOCAL["imread"] = lambda tmp: ((_png(tmp), 1), {})
_LOCAL["imreadWithMetadata"] = lambda tmp: ((_png(tmp), 1), {})
_LOCAL["haveImageReader"] = lambda tmp: ((_png(tmp),), {})
_LOCAL["imcount"] = lambda tmp: ((_png(tmp),), {})
_LOCAL["imreadmulti"] = lambda tmp: ((_png(tmp),), {})
_LOCAL["error"] = _LOCAL["Error"] = lambda tmp: (("message",), {})
_LOCAL["KalmanFilter"] = lambda tmp: ((4, 2), {})


def _plan(name, func, tmp_path):
    if name in _LOCAL:
        return _LOCAL[name](tmp_path)
    plan = build_call(func, name, OVERRIDES)
    assert not isinstance(plan, str), f"{name}: {plan}"
    args, kwargs = plan

    def relocate(v):
        if isinstance(v, str) and v.startswith("/tmp/rcv_callcov"):
            return str(tmp_path / v.rsplit("/", 1)[1])
        return v

    return tuple(relocate(v) for v in args), {k: relocate(v) for k, v in kwargs.items()}


def _run(func, args, kwargs):
    try:
        return func(*args, **kwargs), None
    except Exception as e:  # noqa: BLE001 - the class is what is compared
        return None, e


def _run_port(func, args, kwargs, monkeypatch):
    """The port's call with ``np.asarray(tensor)`` refused, as it is for a
    tensor on the card: the CPU tensors stand in for CUDA ones."""
    with as_on_the_card(monkeypatch):
        return _run(func, args, kwargs)


def _release(obj):
    for m in ("release", "close"):
        if hasattr(obj, m) and callable(getattr(obj, m)):
            getattr(obj, m)()


def _same_global_state():
    """theRNG and the thread count are each facade's global state, which
    other tests in the process (one facade alone) may have moved: both start
    each case from the same."""
    for cv in (R, P):
        cv.setRNGSeed(19)
    P.setNumThreads(R.getNumThreads())


@pytest.mark.parametrize("name", FUNCTIONS)
def test_call_matches_reference(name, tmp_path, monkeypatch):
    rf, pf = getattr(R, name), getattr(P, name)
    _same_global_state()
    (tmp_path / "ref").mkdir(exist_ok=True)
    (tmp_path / "port").mkdir(exist_ok=True)
    ra, rk = _plan(name, rf, tmp_path / "ref")
    pa, pk = port_args(rf, *_plan(name, rf, tmp_path / "port"))
    rout, rerr = _run(rf, ra, rk)
    pout, perr = _run_port(pf, pa, pk, monkeypatch)
    if name in RAISES_WHERE_REFERENCE_SWALLOWS:
        assert rerr is None, rerr
        assert isinstance(perr, NotImplementedError), perr
        return
    if rerr is not None:
        assert perr is not None, f"{name}: the reference raised {rerr!r}, the port returned"
        assert type(perr).__name__ == type(rerr).__name__, (name, rerr, perr)
        return
    if perr is not None:
        raise perr
    if name in TYPE_ONLY:
        assert type(pout).__name__ == type(rout).__name__
        return
    if name in CHECKS:
        CHECKS[name](rout, pout, ra, pa)
        return
    bar = BARS.get(name, (0, ""))[0]
    same(rout, pout, bar)
    for i, (r, p) in enumerate(zip(ra, pa)):
        if isinstance(r, np.ndarray):
            same(r, p, bar, f"argument {i} after the call")


@pytest.mark.parametrize("name", CLASSES)
def test_class_constructs_as_reference(name, tmp_path, monkeypatch):
    rc, pc = getattr(R, name), getattr(P, name)
    ra, rk = _plan(name, rc, tmp_path)
    pa, pk = port_args(rc, ra, rk)
    robj, rerr = _run(rc, ra, rk)
    pobj, perr = _run_port(pc, pa, pk, monkeypatch)
    try:
        if rerr is not None:
            assert perr is not None and type(perr).__name__ == type(rerr).__name__, (rerr, perr)
            return
        if perr is not None:
            raise perr
        assert type(pobj).__name__ == type(robj).__name__
        assert sorted(n for n in dir(pc) if not n.startswith("_")) == \
            sorted(n for n in dir(rc) if not n.startswith("_"))
    finally:
        for o in (robj, pobj):
            if o is not None:
                _release(o)


def test_the_sweep_covers_the_core():
    """Every public callable of the core modules is a case, and the port
    has each of them."""
    assert len(FUNCTIONS) > 300 and len(CLASSES) > 20, (len(FUNCTIONS), len(CLASSES))
    for n in CORE:
        assert callable(getattr(P, n)), n


# ---------------------------------------------------------------- variants
# The sweep above takes each wrapper's defaults; these cases take the
# branches behind its flags (codes, border and interpolation modes, depths,
# the gray and filled draws), on the same images.

def _bgr():
    return img_u8()


def _gray():
    return img_u8(0)


def _bgra():
    a = img_u8(4)
    a[..., 3] = 200
    return a


def _cross():
    return np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]], np.uint8)


def _hitmiss():
    return np.array([[0, 1, 0], [1, -1, 1], [0, 1, 0]], np.int8)


def _binary():
    g = np.zeros((32, 40), np.uint8)
    g[4:14, 5:20] = 255
    g[18:28, 24:36] = 255
    g[8:11, 9:12] = 0
    return g


def _affine():
    return np.array([[0.9, 0.1, 2.0], [-0.1, 0.95, 1.5]], np.float64)


def _homography():
    return np.array([[1.0, 0.05, 1.0], [0.02, 0.98, 2.0], [1e-4, 2e-4, 1.0]])


def _maps():
    ys, xs = np.mgrid[0:32, 0:40].astype(np.float32)
    return xs * 0.93 + 1.3, ys * 1.05 - 0.7


C_ = R  # the constants are the same on both sides (test_torch_cv2_constants)
VARIANTS = []


def _v(vid, name, build):
    VARIANTS.append(pytest.param(name, build, id=f"{name}-{vid}"))


for _code in ("COLOR_BGR2RGB", "COLOR_BGR2BGRA", "COLOR_BGR2GRAY", "COLOR_RGB2GRAY",
              "COLOR_BGR2HSV", "COLOR_RGB2HSV", "COLOR_HSV2BGR", "COLOR_HSV2RGB",
              "COLOR_BGR2Lab", "COLOR_RGB2Lab", "COLOR_Lab2BGR", "COLOR_Lab2RGB",
              "COLOR_BGR2YCrCb", "COLOR_RGB2YCrCb", "COLOR_YCrCb2BGR", "COLOR_YCrCb2RGB",
              "COLOR_BGR2YUV", "COLOR_BGR2BGR565", "COLOR_BGR2XYZ", "COLOR_BGR2HLS",
              "COLOR_BGR2YUV_I420", "COLOR_BGR2Luv"):
    _v(_code, "cvtColor", lambda c=_code: ((_bgr(), getattr(C_, c)), {}))
for _code in ("COLOR_BGRA2BGR", "COLOR_BGRA2GRAY", "COLOR_RGBA2GRAY", "COLOR_BGRA2RGBA"):
    _v(_code, "cvtColor", lambda c=_code: ((_bgra(), getattr(C_, c)), {}))
for _code in ("COLOR_GRAY2BGR", "COLOR_GRAY2BGRA", "COLOR_BayerBG2BGR", "COLOR_BayerGR2RGB",
              "COLOR_BayerBG2GRAY"):
    _v(_code, "cvtColor", lambda c=_code: ((_gray(), getattr(C_, c)), {}))
_v("f32-gray", "cvtColor", lambda: ((_bgr().astype(np.float32), C_.COLOR_BGR2GRAY), {}))
_v("yuv-nv12", "cvtColor", lambda: ((img_u8(0, 48, 40), C_.COLOR_YUV2BGR_NV12), {}))
_v("nv21-rgb", "cvtColorTwoPlane",
   lambda: ((_gray(), img_u8(0, 16, 40), C_.COLOR_YUV2RGB_NV21), {}))
for _code in ("COLOR_BayerBG2BGR", "COLOR_BayerGB2RGB", "COLOR_BayerRG2BGR"):
    _v(_code, "demosaicing", lambda c=_code: ((_gray(), getattr(C_, c)), {}))

for _t in range(5):
    _v(f"type{_t}", "threshold", lambda t=_t: ((_gray(), 100, 200, t), {}))
_v("otsu", "threshold", lambda: ((_gray(), 0, 255, C_.THRESH_BINARY | C_.THRESH_OTSU), {}))
_v("triangle", "threshold",
   lambda: ((_gray(), 0, 255, C_.THRESH_BINARY_INV | C_.THRESH_TRIANGLE), {}))
_v("bgr", "threshold", lambda: ((_bgr(), 90, 255, C_.THRESH_TRUNC), {}))
_v("mean-inv", "adaptiveThreshold",
   lambda: ((_gray(), 255, C_.ADAPTIVE_THRESH_MEAN_C, C_.THRESH_BINARY_INV, 5, 3), {}))
_v("gaussian", "adaptiveThreshold",
   lambda: ((_gray(), 255, C_.ADAPTIVE_THRESH_GAUSSIAN_C, C_.THRESH_BINARY, 7, 2), {}))
_v("bgr", "inRange", lambda: ((_bgr(), (20, 30, 40), (180, 200, 220)), {}))

for _i in range(5):
    _v(f"interp{_i}", "resize", lambda i=_i: ((_bgr(), (23, 17)), {"interpolation": i}))
_v("fx", "resize", lambda: ((_gray(), None), {"fx": 1.5, "fy": 0.75}))
_v("up-area", "resize", lambda: ((_bgr(), (61, 50)), {"interpolation": C_.INTER_AREA}))
_v("f32", "resize", lambda: ((_bgr().astype(np.float32), (20, 16)), {}))
for _fc in (-1, 0, 1):
    _v(f"code{_fc}", "flip", lambda f=_fc: ((_bgr(), f), {}))
for _rc in (0, 1, 2):
    _v(f"code{_rc}", "rotate", lambda r=_rc: ((_gray(), r), {}))
for _b in range(5):
    _v(f"border{_b}", "copyMakeBorder", lambda b=_b: ((_bgr(), 2, 3, 4, 1, b), {"value": 7}))
    _v(f"border{_b}", "GaussianBlur", lambda b=_b: ((_bgr(), (5, 5), 0), {"borderType": b}))
    _v(f"border{_b}", "Sobel", lambda b=_b: ((_gray(), C_.CV_16S, 1, 0), {"borderType": b}))
_v("k3", "GaussianBlur", lambda: ((_gray(), (3, 3), 0), {}))
_v("k7s15", "GaussianBlur", lambda: ((_bgr(), (7, 7), 1.5), {}))
_v("auto", "GaussianBlur", lambda: ((_gray(), (0, 0), 1.2), {}))
_v("aniso", "GaussianBlur", lambda: ((_bgr(), (5, 3), 1.1), {"sigmaY": 0.7}))
for _inter in (0, 1, 2):
    _v(f"flags{_inter}", "warpAffine", lambda i=_inter: ((_bgr(), _affine(), (36, 30)),
                                                         {"flags": i, "borderMode": 1}))
    _v(f"flags{_inter}", "warpPerspective", lambda i=_inter: ((_gray(), _homography(), (40, 32)),
                                                              {"flags": i}))
    _v(f"interp{_inter}", "remap", lambda i=_inter: ((_bgr(), *_maps(), i), {}))
_v("inverse", "warpAffine",
   lambda: ((_gray(), _affine(), (40, 32)), {"flags": 1 | C_.WARP_INVERSE_MAP, "borderValue": 9}))
_v("log", "warpPolar", lambda: ((_gray(), (40, 32), (20, 16), 15, C_.WARP_POLAR_LOG), {}))
_v("inverse", "warpPolar",
   lambda: ((_gray(), (40, 32), (20, 16), 15, C_.WARP_INVERSE_MAP | C_.INTER_LINEAR), {}))

_v("k5", "blur", lambda: ((_bgr(), (5, 3)), {}))
_v("unnorm", "boxFilter", lambda: ((_gray(), C_.CV_32F, (3, 3)), {"normalize": False}))
for _k in (3, 5):
    _v(f"k{_k}", "medianBlur", lambda k=_k: ((_bgr(), k), {}))
_v("d5", "bilateralFilter", lambda: ((_bgr(), 5, 40, 5), {}))
_v("u8", "filter2D", lambda: ((_bgr(), -1, np.array([[0, -1, 0], [-1, 5, -1], [0, -1, 0]], np.float32)), {}))
_v("f32-delta", "filter2D",
   lambda: ((_gray(), C_.CV_32F, np.ones((3, 3), np.float32) / 9), {"delta": 1.5}))
_v("u8", "sepFilter2D", lambda: ((_bgr(), -1, np.array([1, 2, 1.0]) / 4, np.array([1, 2, 1.0]) / 4), {}))
_v("s16", "sepFilter2D", lambda: ((_gray(), C_.CV_16S, np.array([-1, 0, 1.0]), np.array([1, 2, 1.0])), {}))
for _dx, _dy, _k, _d in ((0, 1, 3, "CV_16S"), (1, 1, 5, "CV_64F"), (2, 0, 3, "CV_32F"), (1, 0, 1, "CV_16S")):
    _v(f"{_dx}{_dy}k{_k}{_d}", "Sobel",
       lambda a=(_dx, _dy, _k, _d): ((_gray(), getattr(C_, a[3]), a[0], a[1]), {"ksize": a[2]}))
_v("y", "Scharr", lambda: ((_bgr(), C_.CV_16S, 0, 1), {"scale": 2}))
_v("k1", "Laplacian", lambda: ((_gray(), C_.CV_16S), {}))
_v("k3", "Laplacian", lambda: ((_gray(), C_.CV_64F), {"ksize": 3}))
_v("l2", "Canny", lambda: ((_gray(), 30, 90), {"L2gradient": True}))
_v("k5", "Canny", lambda: ((_bgr(), 100, 300), {"apertureSize": 5}))
_v("cross2", "erode", lambda: ((_gray(), _cross()), {"iterations": 2}))
_v("cross2", "dilate", lambda: ((_bgr(), _cross()), {"iterations": 2}))
for _op in range(2, 8):
    _v(f"op{_op}-square", "morphologyEx", lambda o=_op: ((_binary(), o, np.ones((3, 3), np.uint8)), {}))
    _v(f"op{_op}-cross", "morphologyEx", lambda o=_op: ((_binary(), o, _cross()), {}))
_v("hitmiss", "morphologyEx", lambda: ((_binary(), C_.MORPH_HITMISS, _hitmiss()), {}))
for _s in range(3):
    _v(f"shape{_s}-rect", "getStructuringElement", lambda s=_s: ((s, (5, 3)), {}))
    _v(f"shape{_s}", "getStructuringElement", lambda s=_s: ((s, (5, 5)), {}))
_v("bgr", "pyrDown", lambda: ((_bgr(),), {}))
_v("f32", "pyrUp", lambda: ((_gray().astype(np.float32),), {}))
_v("u8", "stackBlur", lambda: ((_bgr(), (5, 3)), {}))
_v("f32", "stackBlur", lambda: ((_gray().astype(np.float32), (3, 5)), {}))
_v("mask", "calcHist", lambda: (([_gray()], [0], _binary(), [16], [0, 256]), {}))
_v("full", "calcHist", lambda: (([_bgr()], [1], None, [256], [0, 256]), {}))
for _nt in ("NORM_MINMAX", "NORM_INF", "NORM_L1", "NORM_L2"):
    _v(_nt, "normalize", lambda n=_nt: ((_gray(),), {"alpha": 10, "beta": 200,
                                                     "norm_type": getattr(C_, n)}))
_v("table", "LUT", lambda: ((_bgr(), (255 - np.arange(256)).astype(np.uint8)), {}))
for _f in ("add", "subtract", "absdiff", "bitwise_and", "bitwise_or", "bitwise_xor",
           "multiply", "divide", "min", "max"):
    _v("bgr-pair", _f, lambda: ((_bgr(), img_u8(3)[::-1].copy()), {}))
_v("gray", "countNonZero", lambda: ((_binary(),), {}))
_v("f", "addWeighted", lambda: ((_bgr(), 0.3, img_u8(3)[::-1].copy(), 0.6, 4.0), {}))
_v("ab", "convertScaleAbs", lambda: ((_gray(),), {"alpha": 1.7, "beta": -20}))
_v("bin", "connectedComponents", lambda: ((_binary(),), {"connectivity": 4}))
_v("bin", "connectedComponentsWithStats", lambda: ((_binary(),), {}))
for _dt, _ms in (("DIST_L1", 3), ("DIST_C", 3), ("DIST_L2", 3), ("DIST_L2", 5), ("DIST_L2", 0)):
    _v(f"{_dt}{_ms}", "distanceTransform", lambda a=(_dt, _ms): ((_binary(), getattr(C_, a[0]), a[1]), {}))
for _mode in ("RETR_EXTERNAL", "RETR_LIST", "RETR_CCOMP", "RETR_TREE"):
    _v(_mode, "findContours", lambda m=_mode: ((_binary(), getattr(C_, m), C_.CHAIN_APPROX_SIMPLE), {}))
for _tm in range(6):
    _v(f"m{_tm}", "matchTemplate", lambda t=_tm: ((_bgr(), _bgr()[5:13, 6:16].copy(), t), {}))
_v("bin", "HoughLinesP", lambda: ((_binary(), 1, np.pi / 180, 5), {"minLineLength": 4, "maxLineGap": 2}))
_v("gray", "goodFeaturesToTrack", lambda: ((_gray(), 20, 0.05, 3), {}))
_v("bgr", "cornerHarris", lambda: ((_bgr(), 2, 3, 0.06), {}))
_v("cmap", "applyColorMap", lambda: ((_gray(), C_.COLORMAP_VIRIDIS), {}))
_v("gray", "equalizeHist", lambda: ((_gray(),), {}))

# draws: on a BGR and a gray image, outlines and fills (in place, compared
# after the call)
for _img, _mk in (("bgr", _bgr), ("gray", _gray)):
    _v(_img, "line", lambda m=_mk: ((m(), (3, 4), (35, 28), (10, 200, 30)), {"thickness": 2}))
    _v(_img + "-filled", "circle", lambda m=_mk: ((m(), (20, 16), 9, (255, 0, 0)), {"thickness": -1}))
    _v(_img + "-filled", "rectangle", lambda m=_mk: ((m(), (5, 4), (25, 20), (9, 99, 199)), {"thickness": -1}))
    _v(_img, "rectangle", lambda m=_mk: ((m(), (30, 25), (3, 2), 128), {"thickness": 2}))
    _v(_img + "-arc", "ellipse", lambda m=_mk: ((m(), (20, 16), (12, 7), 20, 30, 250, (0, 255, 255)), {}))
    _v(_img + "-pie", "ellipse", lambda m=_mk: ((m(), (20, 16), (12, 7), 20, 30, 250, 77), {"thickness": -1}))
    _v(_img + "-full", "ellipse", lambda m=_mk: ((m(), (20, 16), (12, 7), 20, 0, 360, 77), {"thickness": 2}))
    _v(_img, "fillPoly", lambda m=_mk: ((m(), [np.array([[2, 2], [30, 5], [20, 28]], np.int32)], (1, 2, 3)), {}))
    _v(_img, "polylines", lambda m=_mk: ((m(), [np.array([[2, 2], [30, 5], [20, 28]], np.int32)], True, 250), {}))
    _v(_img, "putText", lambda m=_mk: ((m(), "Hi", (3, 25), 0, 0.6, (0, 0, 255)), {}))
    _v(_img, "arrowedLine", lambda m=_mk: ((m(), (3, 30), (35, 4), 200), {"tipLength": 0.3}))
    _v(_img, "drawMarker", lambda m=_mk: ((m(), (20, 16), (0, 255, 0)), {"markerType": 2}))


@pytest.mark.parametrize("name,build", VARIANTS)
def test_variant_matches_reference(name, build, monkeypatch):
    rf, pf = getattr(R, name), getattr(P, name)
    ra, rk = build()
    pa, pk = port_args(rf, *build())
    rout, rerr = _run(rf, ra, rk)
    pout, perr = _run_port(pf, pa, pk, monkeypatch)
    if rerr is not None:
        assert perr is not None, f"{name}: the reference raised {rerr!r}, the port returned"
        assert type(perr).__name__ == type(rerr).__name__, (name, rerr, perr)
        return
    if perr is not None:
        raise perr
    bar = BARS.get(name, (0, ""))[0]
    same(rout, pout, bar)
    for i, (r, p) in enumerate(zip(ra, pa)):
        if isinstance(r, np.ndarray):
            same(r, p, bar, f"argument {i} after the call")
