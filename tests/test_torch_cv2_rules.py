"""The decisions of the port's cv2 facade that the reference does not make,
pinned (``rustcv_tpu_torch/cv2/_device.py``):

* a numpy image that a wrapper hands to a Mat or to a device op goes to
  the card: without one the call raises before any computation; which
  wrappers do so (with their default arguments) is frozen in
  :data:`CARD_NAMES`, every other wrapper runs on the host as the
  reference's does;
* in-place draws mutate the caller's numpy array (on the host, in its own
  buffer) or CPU tensor;
* the reference's swallow-all wrappers keep cv2's False / 0 for a missing
  or unreadable file and let ``not_ported`` through;
* a name of ROADMAP Queue 1 item 7b raises ``not_ported``.
"""
import numpy as np
import pytest
import torch

import rustcv_tpu.cv2 as R
import rustcv_tpu_torch.cv2 as P
from test_torch_cv2_calls import FUNCTIONS, _plan

# The wrappers that send a numpy image to the card (with the synthesized
# default arguments of tests/cv2_callcov.py): the reference sends these
# through its Mat (the golden host form) or to JAX's device.
CARD_NAMES = frozenset("""
    GaussianBlur HoughCircles HoughLines HoughLinesP LUT Laplacian PSNR
    Scharr Sobel absdiff adaptiveThreshold add addWeighted applyColorMap
    bilateralFilter bitwise_and bitwise_not bitwise_or bitwise_xor
    buildOpticalFlowPyramid calcOpticalFlowFarneback calcOpticalFlowPyrLK
    connectedComponents connectedComponentsWithStats convertScaleAbs
    cornerEigenValsAndVecs cornerHarris cornerMinEigenVal cornerSubPix
    countNonZero dct demosaicing detailEnhance dilate edgePreservingFilter
    equalizeHist erode fastNlMeansDenoising fastNlMeansDenoisingColored
    filter2D findChessboardCorners findChessboardCornersSB flip
    goodFeaturesToTrack grabCut hasNonZero imencode imshow imwrite inRange
    inpaint integral kmeans matchTemplate medianBlur morphologyEx normalize
    pencilSketch preCornerDetect pyrDown pyrMeanShiftFiltering sepFilter2D
    spatialGradient stackBlur stylization subtract threshold undistort
    watershed
""".split())


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_the_card_names_are_wrappers():
    assert CARD_NAMES <= set(FUNCTIONS) and len(CARD_NAMES) > 60


@pytest.mark.parametrize("name", FUNCTIONS)
def test_numpy_goes_to_the_card_exactly_where_a_mat_or_device_op_takes_it(name, tmp_path,
                                                                         no_card):
    args, kwargs = _plan(name, getattr(R, name), tmp_path)
    try:
        getattr(P, name)(*args, **kwargs)
    except NotImplementedError:  # a RuntimeError too: the not_ported ones
        pass
    except RuntimeError as e:
        assert name in CARD_NAMES and "is_available() is False" in str(e), (name, e)
        return
    except Exception:  # noqa: BLE001 - the sweep holds the classes; here only the device
        pass
    assert name not in CARD_NAMES, f"{name} ran on the host"


@pytest.mark.parametrize("call,spies", [
    (lambda g: P.cornerHarris(g, 2, 3, 0.04), ["ops.features.harris_response"]),
    (lambda g: P.GaussianBlur(g, (5, 5), 0), ["imgproc.copy_make_border", "imgproc.gaussian_blur"]),
    (lambda g: P.goodFeaturesToTrack(g, 50, 0.01, 5),
     ["imgproc.good_features_to_track", "ops.features.harris_corner_list"]),
], ids=["cornerHarris", "GaussianBlur", "goodFeaturesToTrack"])
def test_numpy_without_a_card_raises_before_any_cpu_work(call, spies, no_card, monkeypatch):
    import importlib

    ran = []
    for dotted in spies:
        mod, fn = dotted.rsplit(".", 1)
        m = importlib.import_module("rustcv_tpu_torch." + mod)
        monkeypatch.setattr(m, fn, lambda *a, _n=dotted, **k: ran.append(_n))
    g = np.random.default_rng(0).integers(0, 256, (48, 64), dtype=np.uint8)
    with pytest.raises(RuntimeError, match="is_available"):
        call(g)
    assert ran == []


DRAWS = [
    ("line", lambda cv, im: cv.line(im, (2, 3), (40, 30), (10, 200, 30), 2)),
    ("circle", lambda cv, im: cv.circle(im, (20, 16), 9, (255, 0, 0), -1)),
    ("rectangle", lambda cv, im: cv.rectangle(im, (5, 4), (25, 20), (9, 99, 199), 2)),
    ("rectangle filled", lambda cv, im: cv.rectangle(im, (5, 4), (25, 20), (9, 99, 199), -1)),
    ("ellipse", lambda cv, im: cv.ellipse(im, (20, 16), (12, 7), 20, 0, 360, (0, 255, 255), 1)),
    ("fillPoly", lambda cv, im: cv.fillPoly(im, [np.array([[2, 2], [30, 5], [20, 28]])], (1, 2, 3))),
    ("putText", lambda cv, im: cv.putText(im, "Hi", (3, 25), 0, 0.6, (0, 0, 255))),
    ("drawMarker", lambda cv, im: cv.drawMarker(im, (20, 16), (0, 255, 0))),
    ("drawContours", lambda cv, im: cv.drawContours(
        im, [np.array([[[5, 5]], [[30, 6]], [[25, 25]]], np.int32)], -1, (7, 7, 7), 1)),
]


# drawMarker on a gray image raises in both facades (its glyph is BGR)
DRAW_CASES = [pytest.param(name, draw, gray, id=f"{name}-{'gray' if gray else 'bgr'}")
              for name, draw in DRAWS for gray in (False, True)
              if not (gray and name == "drawMarker")]


@pytest.mark.parametrize("name,draw,gray", DRAW_CASES)
def test_in_place_draws_mutate_the_callers_array_on_the_host(name, draw, gray, no_card):
    base = np.random.default_rng(1).integers(0, 256, (32, 48, 3), dtype=np.uint8)
    img = np.ascontiguousarray(base[..., 0]) if gray else base.copy()
    want = img.copy()
    draw(R, want)
    out = draw(P, img)  # no card: a numpy image is drawn on the host
    assert out is img
    np.testing.assert_array_equal(img, want)
    assert not np.array_equal(img, np.ascontiguousarray(base[..., 0]) if gray else base)


@pytest.mark.parametrize("name,draw,gray", DRAW_CASES)
def test_in_place_draws_mutate_the_callers_tensor_where_it_is(name, draw, gray):
    base = np.random.default_rng(1).integers(0, 256, (32, 48, 3), dtype=np.uint8)
    img = np.ascontiguousarray(base[..., 0]) if gray else base.copy()
    want = img.copy()
    draw(R, want)
    t = torch.from_numpy(img.copy())
    ptr = t.data_ptr()
    out = draw(P, t)
    assert out is t and t.data_ptr() == ptr
    np.testing.assert_array_equal(t.numpy(), want)


def test_a_contiguous_bgr_array_is_drawn_without_a_copy(monkeypatch):
    """The host Mat of a draw wraps the caller's own buffer: the draw writes
    into it and the facade copies nothing back."""
    from rustcv_tpu_torch.cv2 import _device

    copies = []
    monkeypatch.setattr(_device.np, "copyto", lambda *a, **k: copies.append(a))
    img = np.zeros((24, 32, 3), np.uint8)
    P.rectangle(img, (2, 2), (20, 15), (0, 255, 0), 1)
    assert img[2, 2:20].tolist() == [[0, 255, 0]] * 18 and copies == []


def test_multi_page_wrappers_let_not_ported_through(tmp_path):
    png = str(tmp_path / "a.png")
    R.imwrite(png, np.zeros((8, 8, 3), np.uint8))
    with pytest.raises(NotImplementedError, match="item 8"):
        P.imcount(png)
    with pytest.raises(NotImplementedError, match="item 8"):
        P.imreadmulti(png)
    with pytest.raises(NotImplementedError, match="item 8"):
        P.imwritemulti(str(tmp_path / "b.tiff"), [np.zeros((8, 8, 3), np.uint8)])
    # cv2's answers for a missing file or directory stay
    assert P.imcount(str(tmp_path / "none.tif")) == R.imcount(str(tmp_path / "none.tif")) == 0
    assert P.imreadmulti(str(tmp_path / "none.tif")) == (False, [])
    assert P.imwritemulti(str(tmp_path / "no" / "dir.tif"), [np.zeros((8, 8), np.uint8)]) is False


def test_have_image_reader_asks_the_ports_codecs(tmp_path):
    png = str(tmp_path / "a.png")
    R.imwrite(png, np.zeros((8, 8, 3), np.uint8))
    (tmp_path / "junk.png").write_bytes(b"not an image at all")
    (tmp_path / "a.tif").write_bytes(b"II*\x00" + bytes(60))
    assert P.haveImageReader(png) is R.haveImageReader(png) is True
    assert P.haveImageReader(str(tmp_path / "junk.png")) is False
    assert P.haveImageReader(str(tmp_path / "missing.png")) is False
    with pytest.raises(NotImplementedError, match="item 8"):
        P.haveImageReader(str(tmp_path / "a.tif"))


def test_video_writer_open_is_false_for_a_bad_path_or_codec(tmp_path):
    w = P.VideoWriter()
    assert w.open(str(tmp_path / "no" / "dir.avi"), P.VideoWriter_fourcc(*"MJPG"), 30,
                  (64, 48)) is False
    assert w.open(str(tmp_path / "a.avi"), P.VideoWriter_fourcc(*"XVID"), 30, (64, 48)) is \
        R.VideoWriter().open(str(tmp_path / "r.avi"), R.VideoWriter_fourcc(*"XVID"), 30,
                             (64, 48))
    assert not w.isOpened()


def test_item_7b_names_raise_not_ported():
    for name in ("aruco", "solveP3P", "detail_Blender", "DISOpticalFlow_create"):
        if name in P._ITEM_7B:
            with pytest.raises(NotImplementedError, match=r"item 7\)"):
                getattr(P, name)
    assert "aruco" in P._ITEM_7B
