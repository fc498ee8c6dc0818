"""The port's detectors and host modules of group 4a: Haar cascades
(``rustcv_tpu_torch.ops.cascade``), and the copies ``qr``, ``mser`` (over
the port's native ``mser.cpp``), ``lsd``, ``scissors``, ``viz``,
``colorchecker``, ``grabcut`` (over the port's native ``maxflow.cpp``) and
``poisson_cv``, with their ``imgproc`` names, against ``rustcv_tpu`` on
the same seeded inputs.

Tolerances, the reference's own (``tests/test_cascade.py``,
``test_qr.py``, ``test_mser.py``, ``test_lsd.py``, ``test_scissors.py``,
``test_viz.py``, ``test_colorchecker.py``, ``test_grabcut.py``,
``test_poisson_cv.py``):
- cascades: the trained model equal; the tensor scorer's ``ok`` equal to
  the JAX twin's and the float64 oracle's, margins within 1e-2 (float32
  against float64); detections equal;
- every host copy and both native passes: equal outputs.

The reference's ``mser`` falls back to its Python spec when its native
library is missing; the port's raises instead (a port-map deviation),
which ``test_mser_native_build_failure_raises`` pins."""

import numpy as np
import pytest
import torch

from rustcv_tpu import imgproc as jax_ip
from rustcv_tpu import native as jax_native
from rustcv_tpu.core.mat import Mat as JMat
from rustcv_tpu.ops import cascade as JC
from rustcv_tpu.ops import colorchecker as JCC
from rustcv_tpu.ops import grabcut as JGC
from rustcv_tpu.ops import lsd as JL
from rustcv_tpu.ops import mser as JM
from rustcv_tpu.ops import poisson_cv as JPC
from rustcv_tpu.ops import qr as JQ
from rustcv_tpu.ops import scissors as JSC
from rustcv_tpu.ops import viz as JV
from rustcv_tpu_torch import imgproc as port_ip
from rustcv_tpu_torch import native
from rustcv_tpu_torch.core import Mat
from rustcv_tpu_torch.ops import cascade as PC
from rustcv_tpu_torch.ops import colorchecker as PCC
from rustcv_tpu_torch.ops import grabcut as PGC
from rustcv_tpu_torch.ops import lsd as PL
from rustcv_tpu_torch.ops import mser as PM
from rustcv_tpu_torch.ops import poisson_cv as PPC
from rustcv_tpu_torch.ops import qr as PQ
from rustcv_tpu_torch.ops import scissors as PSC
from rustcv_tpu_torch.ops import viz as PV

WIN = 24


def _make_pos(n, rng):
    out = []
    for _ in range(n):
        p = rng.integers(90, 130, (WIN, WIN))
        p[4:10, 3:21] = rng.integers(20, 50, (6, 18))
        p[14:22, 6:18] = rng.integers(170, 220, (8, 12))
        out.append(np.clip(p, 0, 255))
    return np.stack(out).astype(np.uint8)


@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(0)
    pos, neg = _make_pos(60, rng), rng.integers(0, 256, (300, WIN, WIN)).astype(np.uint8)
    return (PC.train_cascade(pos, neg, n_stages=3, n_stumps=8),
            JC.train_cascade(pos, neg, n_stages=3, n_stumps=8))


def _cascade_scene(seed=5, shape=(96, 120)):
    rng = np.random.default_rng(seed)
    scene = rng.integers(0, 256, shape).astype(np.uint8)
    scene[30:54, 60:84] = _make_pos(1, np.random.default_rng(2))[0]
    return scene


def test_cascade_training_and_json_equal(models):
    port, ref = models
    assert port.to_json() == ref.to_json()
    back = PC.Cascade.from_json(port.to_json())
    img = _cascade_scene()
    assert all(np.array_equal(a, b) for a, b in zip(PC.score_windows(img, back),
                                                      JC.score_windows(img, ref)))


@pytest.mark.parametrize("seed,shape", [(5, (96, 120)), (8, (180, 240))])
def test_cascade_tensor_scorer_ok_equal(jax_cpu, models, seed, shape):
    port, ref = models
    img = _cascade_scene(seed, shape)
    ok, margin = PC.score_windows_device(torch.from_numpy(img), port)
    assert isinstance(ok, np.ndarray) and ok.dtype == bool
    j_ok, j_m = JC.score_windows_device(img, ref)
    g_ok, g_m = JC.score_windows(img, ref)
    assert np.array_equal(ok, j_ok) and np.array_equal(ok, g_ok) and ok.any()
    assert np.abs(margin - j_m).max() <= 1e-2 and np.abs(margin - g_m).max() <= 1e-2


def test_cascade_detection_equal(jax_cpu, models):
    port, ref = models
    img = _cascade_scene()
    want = JC.detect_multi_scale(img, ref, use_device=True)
    got = PC.detect_multi_scale(img, port, use_device=True, device="cpu")
    assert np.array_equal(got[0], want[0]) and np.abs(got[1] - want[1]).max() <= 1e-2
    host = PC.detect_multi_scale(img, port)
    assert all(np.array_equal(a, b) for a, b in zip(host, JC.detect_multi_scale(img, ref)))
    hits = [b for b in got[0] if abs(b[0] - 60) <= 3 and abs(b[1] - 30) <= 3]
    assert len(hits) == 1


def _blob_image(seed=0, h=120, w=160, blobs=((40, 50, 18, 30), (80, 110, 14, 60))):
    img = np.full((h, w), 220, np.int32)
    yy, xx = np.mgrid[0:h, 0:w]
    for cy, cx, r, v in blobs:
        d = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)
        ramp = (v + (d - r) / 6 * (220 - v)).astype(np.int32)
        img = np.where(d < r, v, np.where(d < r + 6, ramp, img))
    rng = np.random.default_rng(seed)
    img = img + rng.normal(0, 2, img.shape).astype(np.int32)
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("kind", ["noise", "blobs", "gradient"])
def test_mser_native_is_the_spec_and_the_reference(kind):
    rng = np.random.default_rng(len(kind))
    for _ in range(3):
        h, w = int(rng.integers(24, 80)), int(rng.integers(24, 80))
        if kind == "noise":
            img = rng.integers(0, 256, (h, w)).astype(np.uint8)
        elif kind == "blobs":
            img = _blob_image(seed=int(rng.integers(99)), h=h, w=w,
                              blobs=((h // 3, w // 3, min(h, w) // 5, 40),))
        else:
            img = (np.linspace(0, 255, w)[None, :]
                   + rng.normal(0, 8, (h, w))).clip(0, 255).astype(np.uint8)
        args = (img, 5, 20, h * w // 2, 0.25, 0.2)
        got = native.mser_triples(*args)
        assert got.dtype == np.int32 and np.array_equal(got, jax_native.mser_triples(*args))
        assert PM._mser_triples_spec(*args) == [tuple(int(v) for v in r) for r in got]
        assert PM.mser_triples(*args) == PM.mser_triples(*args, use_native=False)


def test_mser_regions_equal():
    img = _blob_image()
    for pol in ("dark", "bright", "both"):
        got, want = PM.mser_regions(img, polarity=pol), JM.mser_regions(img, polarity=pol)
        assert np.array_equal(got[1], want[1])
        assert all(np.array_equal(a, b) for a, b in zip(got[0], want[0]))
    assert len(PM.mser_regions(img, polarity="dark")[0]) >= 2
    with pytest.raises(ValueError):
        PM.mser_regions(img, polarity="sideways")


def _broken_library(monkeypatch, tmp_path):
    broken = tmp_path / "mser.cpp"
    broken.write_text("extern \"C\" long rcv_mser( { not C++ }\n")
    monkeypatch.setattr(native, "SOURCES", (broken,))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_error", None)
    assert not native.available()


def test_mser_native_build_failure_raises(monkeypatch, tmp_path):
    """No silent fallback: where the reference's ``mser_triples`` runs its
    Python spec without the library, the port's raises the compiler's
    error; ``use_native=False`` still runs the spec on request."""
    img = _blob_image(h=40, w=50, blobs=((20, 25, 8, 40),))
    want = PM._mser_triples_spec(img, 5, 20, 1000, 0.25, 0.2)
    _broken_library(monkeypatch, tmp_path)
    for call in (lambda: native.mser_triples(img, 5, 20, 1000, 0.25, 0.2),
                 lambda: PM.mser_triples(img, 5, 20, 1000),
                 lambda: PM.mser_regions(img)):
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            call()
    assert PM.mser_triples(img, 5, 20, 1000, use_native=False) == want


def test_grabcut_native_build_failure_raises(monkeypatch, tmp_path):
    img = np.zeros((20, 24, 3), np.uint8)
    img[5:15, 6:18] = 200
    _broken_library(monkeypatch, tmp_path)
    z = np.zeros((4, 5), np.int64)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.maxflow_grid(z, z, z, z, z, z)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        PGC.grab_cut(img, rect=(4, 3, 16, 14), iter_count=1)


def test_maxflow_is_the_references():
    import ctypes

    rng = np.random.default_rng(3)
    h, w = 9, 11
    planes = [rng.integers(0, 60, (h, w)).astype(np.int64) for _ in range(6)]
    flow, labels = native.maxflow_grid(*planes)
    lib = jax_native.get_lib()
    i64p = ctypes.POINTER(ctypes.c_int64)
    ref = np.zeros(h * w, np.uint8)
    want = lib.rcv_maxflow_grid(h, w, *(np.ascontiguousarray(p).reshape(-1).ctypes.data_as(i64p)
                                        for p in planes),
                                ref.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    assert flow == want and np.array_equal(labels, ref.reshape(h, w))
    src = np.zeros((4, 5), np.int64)
    src[:, :2] = 1000
    snk = np.zeros((4, 5), np.int64)
    snk[:, 3:] = 1000
    z = np.zeros((4, 5), np.int64)
    flow, lab = native.maxflow_grid(src, snk, np.full((4, 5), 10), np.full((4, 5), 10), z, z)
    assert flow == 40 and lab[:, :2].all() and not lab[:, 3:].any()


@pytest.mark.parametrize("seed", [0, 1])
def test_grabcut_equal(seed):
    rng = np.random.default_rng(seed)
    img = (rng.random((40, 50, 3)) * 60).astype(np.uint8)
    img[10:30, 15:35] += 150
    for kw in (dict(rect=(12, 8, 26, 24), iter_count=2),
               dict(mask=np.where(rng.random((40, 50)) > 0.5, 2, 3).astype(np.uint8),
                    iter_count=1, seed=3)):
        assert np.array_equal(PGC.grab_cut(img, **kw), JGC.grab_cut(img, **kw))


def test_qr_round_trip_equal():
    for v, lvl, mask, text in ((1, "L", 0, "HELLO"), (2, "M", 3, "rustcv torch"),
                               (4, "Q", 5, "group 4a of the port")):
        m = PQ.encode(text, v, lvl, mask)
        assert np.array_equal(m, JQ.encode(text, v, lvl, mask))
        assert PQ.decode_matrix(m) == JQ.decode_matrix(m) == text
        img = PQ.draw(m, 6)
        assert np.array_equal(img, JQ.draw(m, 6))
        got, want = PQ.detect_and_decode(img), JQ.detect_and_decode(img)
        assert got[0] == want[0] == text and np.array_equal(got[1], want[1])
    cw = PQ.rs_encode(list(range(10, 29)), 7)
    assert cw == JQ.rs_encode(list(range(10, 29)), 7)
    bad = list(cw)
    bad[3] ^= 0x5A
    assert PQ.rs_correct(bad, 7) == JQ.rs_correct(bad, 7) == cw


def test_lsd_equal():
    img = np.full((240, 320), 220, np.uint8)
    img[60:180, 80:240] = 60
    for t in np.linspace(0, 1, 600):
        y, x = int(round(20 + t * 200)), int(round(10 + t * 290))
        img[y, max(0, x - 1):x + 2] = 30
    for kw in ({}, {"length_threshold": 50}, {"do_merge": False}):
        got, want = PL.detect_line_segments(img, **kw), JL.detect_line_segments(img, **kw)
        assert np.array_equal(got, want) and len(got) >= 4


def test_scissors_equal():
    img = np.zeros((60, 80), np.uint8)
    ys, xs = np.mgrid[0:60, 0:80]
    img[np.abs(ys - (20 + 10 * np.sin(xs / 12.0))) < 1.5] = 220
    a = PSC.IntelligentScissors(30, 90).apply_image(img)
    b = JSC.IntelligentScissors(30, 90).apply_image(img)
    a.build_map((5, 20))
    b.build_map((5, 20))
    for target in ((75, 22), (40, 50)):
        assert np.array_equal(a.get_contour(target), b.get_contour(target))


def test_viz_equal():
    rng = np.random.default_rng(1234)
    for _ in range(50):
        p1 = tuple(int(v) for v in rng.integers(-60, 160, 2))
        p2 = tuple(int(v) for v in rng.integers(-60, 160, 2))
        assert PV.clip_line((0, 0, 100, 80), p1, p2) == JV.clip_line((0, 0, 100, 80), p1, p2)
    args = ((50, 40), (20, 10), 30, 0, 360, 90)
    assert np.array_equal(PV.ellipse2poly(*args), JV.ellipse2poly(*args))
    img = rng.integers(0, 256, (60, 80), np.uint8)
    kp = np.array([[20.0, 30.0, 12.0, 45.0], [60.0, 10.0, 8.0, 180.0]])
    assert np.array_equal(PV.draw_keypoints(img, kp, rich=True),
                          JV.draw_keypoints(img, kp, rich=True))
    assert np.array_equal(PV.draw_keypoints(img, kp), JV.draw_keypoints(img, kp))
    img2 = rng.integers(0, 256, (50, 70), np.uint8)
    m = np.array([[0, 1], [1, 0]])
    assert np.array_equal(PV.draw_matches(img, kp, img2, kp[::-1], m),
                          JV.draw_matches(img, kp, img2, kp[::-1], m))
    canvas = np.zeros((40, 40, 3), np.uint8)
    for kind in ("cross", "star", "diamond", "triangle_down"):
        got = PV.draw_marker(canvas, (20, 20), (0, 255, 0), kind, 12, 2)
        assert np.array_equal(got, JV.draw_marker(canvas, (20, 20), (0, 255, 0), kind, 12, 2))
        assert got.any() and not canvas.any()


def _render_chart(shape=(300, 420)):
    img = np.full((*shape, 3), 190, np.uint8)
    x0, y0, cw, chh, sep, frame = 60, 50, 48, 44, 6, 10
    w_total, h_total = 6 * cw + 7 * sep, 4 * chh + 5 * sep
    img[y0 - frame:y0 + h_total + frame, x0 - frame:x0 + w_total + frame] = 20
    img[y0:y0 + h_total, x0:x0 + w_total] = 250
    for r in range(4):
        for c in range(6):
            y, x = y0 + sep + r * (chh + sep), x0 + sep + c * (cw + sep)
            img[y:y + chh, x:x + cw] = PCC.REFERENCE_SRGB[r * 6 + c][::-1]
    return img


def test_colorchecker_equal():
    img = _render_chart()
    got, want = PCC.detect_color_checker(img), JCC.detect_color_checker(img)
    assert got is not None and all(np.array_equal(a, b) for a, b in zip(got, want))
    assert np.array_equal(PCC.color_checker_ccm(got[1]), JCC.color_checker_ccm(want[1]))
    assert PCC.detect_color_checker(np.full((60, 80, 3), 128, np.uint8)) is None


def test_poisson_cv_equal():
    rng = np.random.default_rng(7)
    src = rng.integers(60, 200, (40, 48, 3)).astype(np.uint8)
    dst = rng.integers(0, 255, (64, 80, 3)).astype(np.uint8)
    mask = np.zeros((40, 48), np.uint8)
    mask[8:32, 10:38] = 255
    for flags in (1, 2):
        assert np.array_equal(PPC.seamless_clone_cv(src, dst, mask, (40, 32), flags),
                              JPC.seamless_clone_cv(src, dst, mask, (40, 32), flags))
    full = np.zeros((40, 48), np.uint8)
    full[8:32, 10:38] = 255
    assert np.array_equal(PPC.color_change_cv(src, full), JPC.color_change_cv(src, full))
    assert np.array_equal(PPC.illumination_change_cv(src, full),
                          JPC.illumination_change_cv(src, full))
    assert np.array_equal(PPC.texture_flattening_cv(src, full),
                          JPC.texture_flattening_cv(src, full))


def test_detect_wrappers_four_ways(jax_cpu, models):
    """The ``imgproc`` names on the port's host Mat and CPU-tensor Mat
    against the reference's host and JAX Mats."""
    port, ref = models
    scene = _cascade_scene()
    qr_img = PQ.draw(PQ.encode("group 4a", 2, "M", 1), 5)
    blobs = _blob_image()
    rng = np.random.default_rng(4)
    bgr = (rng.random((40, 50, 3)) * 60).astype(np.uint8)
    bgr[10:30, 15:35] += 150

    def ports(a):
        return (Mat.from_array(a, device="cpu"), Mat.from_device(torch.from_numpy(a.copy())))

    def refs(a):
        host, dev = JMat.from_array(a), JMat.from_array(a)
        dev.device()
        return host, dev

    for k in range(2):
        got = port_ip.cascade_detect_multi_scale(ports(scene)[k], port)
        want = jax_ip.cascade_detect_multi_scale(refs(scene)[k], ref)
        assert np.array_equal(got[0], want[0]) and np.abs(got[1] - want[1]).max() <= 1e-2
        got = port_ip.qr_detect_and_decode(ports(qr_img)[k])
        want = jax_ip.qr_detect_and_decode(refs(qr_img)[k])
        assert got[0] == want[0] == "group 4a" and np.array_equal(got[1], want[1])
        got = port_ip.detect_mser_regions(ports(blobs)[k])
        want = jax_ip.detect_mser_regions(refs(blobs)[k])
        assert np.array_equal(got[1], want[1]) and len(got[0]) == len(want[0])
        got = port_ip.detect_line_segments(ports(blobs)[k], length_threshold=10)
        assert np.array_equal(got, jax_ip.detect_line_segments(refs(blobs)[k],
                                                               length_threshold=10))
        got = port_ip.grab_cut(ports(bgr)[k], rect=(12, 8, 26, 24), iter_count=1)
        assert np.array_equal(got, jax_ip.grab_cut(refs(bgr)[k], rect=(12, 8, 26, 24),
                                                   iter_count=1))
    assert np.array_equal(port_ip.detect_mser_regions(blobs)[1],
                          jax_ip.detect_mser_regions(blobs)[1])
    for name in ("IntelligentScissors", "detect_color_checker", "color_checker_ccm",
                 "clip_line", "ellipse2poly", "draw_keypoints", "draw_matches", "draw_marker"):
        assert getattr(port_ip, name).__module__.startswith("rustcv_tpu_torch.ops."), name
