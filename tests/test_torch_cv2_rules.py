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
  or unreadable file and let ``not_ported`` (the forms of item 8d-ii, a
  4-channel GIF write among them) through;
* the later modules (ROADMAP Queue 1 item 7b) follow the same rules: which
  of their wrappers send a numpy image to the card is frozen in
  :data:`LATER_CARD_NAMES`, ``addText`` and ``thresholdWithMask`` write
  into the caller's buffer; the six functions the reference runs with
  Pillow for multi-page and animated files (item 8b) and
  ``imdecodeWithMetadata`` and ``imencodeWithMetadata`` (item 8a) run the
  port's own codecs and answer as the reference's for TIFF and GIF.
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
    """imcount and imreadmulti of a PNG and imwritemulti of a TIFF answer as
    the reference's (item 8b), of a WebP (item 8c-ii) and of an animated
    PNG (item 8d-i); a 4-channel GIF written by imwritemulti (item 8d-ii)
    still raises not_ported through the swallowing wrapper."""
    png = str(tmp_path / "a.png")
    R.imwrite(png, np.zeros((8, 8, 3), np.uint8))
    assert P.imcount(png) == R.imcount(png) == 1
    got, want = P.imreadmulti(png), R.imreadmulti(png)
    assert got[0] is want[0] is True and np.array_equal(got[1][0], want[1][0])
    frames = [np.full((8, 8, 3), v, np.uint8) for v in (0, 90, 200)]
    assert P.imwritemulti(str(tmp_path / "b.tiff"), frames) is \
        R.imwritemulti(str(tmp_path / "r.tiff"), frames) is True
    assert P.imcount(str(tmp_path / "b.tiff")) == R.imcount(str(tmp_path / "b.tiff")) == 3
    assert P.imwritemulti(str(tmp_path / "c.png"), frames) is \
        R.imwritemulti(str(tmp_path / "r.png"), frames) is True
    assert P.imcount(str(tmp_path / "c.png")) == R.imcount(str(tmp_path / "r.png")) == 3
    got, want = P.imreadmulti(str(tmp_path / "c.png")), R.imreadmulti(str(tmp_path / "r.png"))
    assert got[0] is want[0] is True and _equal(got[1], want[1])
    bgra = [np.full((8, 8, 4), v, np.uint8) for v in (0, 90)]
    assert R.imwritemulti(str(tmp_path / "r.gif"), bgra) is True
    with pytest.raises(NotImplementedError, match="item 8"):
        P.imwritemulti(str(tmp_path / "d.gif"), bgra)
    assert P.imwritemulti(str(tmp_path / "c.webp"), frames) is \
        R.imwritemulti(str(tmp_path / "r.webp"), frames) is True
    assert P.imcount(str(tmp_path / "c.webp")) == R.imcount(str(tmp_path / "r.webp")) == 3
    # cv2's answers for a missing file or directory stay
    assert P.imcount(str(tmp_path / "none.tif")) == R.imcount(str(tmp_path / "none.tif")) == 0
    assert P.imreadmulti(str(tmp_path / "none.tif")) == (False, [])
    assert P.imwritemulti(str(tmp_path / "no" / "dir.tif"), [np.zeros((8, 8), np.uint8)]) is False


def test_have_image_reader_asks_the_ports_codecs(tmp_path):
    png = str(tmp_path / "a.png")
    R.imwrite(png, np.zeros((8, 8, 3), np.uint8))
    (tmp_path / "junk.png").write_bytes(b"not an image at all")
    (tmp_path / "a.tif").write_bytes(b"II*\x00" + bytes(60))  # no IFD: Image.open fails
    R.imwritemulti(str(tmp_path / "b.gif"), [np.zeros((8, 8, 3), np.uint8)])
    R.imwrite(str(tmp_path / "c.webp"), np.zeros((8, 8, 3), np.uint8))
    assert P.haveImageReader(png) is R.haveImageReader(png) is True
    assert P.haveImageReader(str(tmp_path / "junk.png")) is False
    assert P.haveImageReader(str(tmp_path / "missing.png")) is False
    tif = str(tmp_path / "a.tif")
    assert P.haveImageReader(tif) is R.haveImageReader(tif) is False
    gif = str(tmp_path / "b.gif")
    assert P.haveImageReader(gif) is R.haveImageReader(gif) is True
    webp = str(tmp_path / "c.webp")  # a WebP read is ported (item 8c)
    assert P.haveImageReader(webp) is R.haveImageReader(webp) is True


def test_video_writer_open_is_false_for_a_bad_path_or_codec(tmp_path):
    w = P.VideoWriter()
    assert w.open(str(tmp_path / "no" / "dir.avi"), P.VideoWriter_fourcc(*"MJPG"), 30,
                  (64, 48)) is False
    assert w.open(str(tmp_path / "a.avi"), P.VideoWriter_fourcc(*"XVID"), 30, (64, 48)) is \
        R.VideoWriter().open(str(tmp_path / "r.avi"), R.VideoWriter_fourcc(*"XVID"), 30,
                             (64, 48))
    assert not w.isOpened()


def test_item_7b_names_raise_not_ported():
    """Item 7b's names are ported: none raises ``not_ported`` on access any
    more, and item 8b's multi-page encode answers as the reference's."""
    for name in ("aruco", "solveP3P", "detail_Blender", "DISOpticalFlow_create"):
        getattr(P, name)
    assert not hasattr(P, "_ITEM_7B")
    frames = [np.zeros((8, 8, 3), np.uint8)]
    got, want = P.imencodemulti(".tiff", frames), R.imencodemulti(".tiff", frames)
    assert got[0] is want[0] is True
    assert np.array_equal(R.imdecodemulti(got[1])[1][0], R.imdecodemulti(want[1])[1][0])


# ------------------------------------------------------------ item 7b

from cv2_torch_parity import facade_get, later_plan  # noqa: E402
from test_torch_cv2_later_calls import FUNCTIONS as LATER_FUNCTIONS  # noqa: E402

# The 7b wrappers that send a numpy image to the card (with the synthesized
# arguments of tests/test_torch_cv2_later_calls.py): where the reference's
# wrapper makes a Mat, calls one of the core wrappers above, or reaches a
# device op (the chessboard and ChArUco refinements, the fisheye remap).
LATER_CARD_NAMES = frozenset("""
    checkChessboard connectedComponentsWithAlgorithm
    connectedComponentsWithStatsWithAlgorithm filter2Dp find4QuadCornerSubpix
    findChessboardCornersSBWithMeta goodFeaturesToTrackWithQuality
    thresholdWithMask aruco.interpolateCornersCharuco detail.computeImageFeatures
    detail.computeImageFeatures2 fisheye.undistortImage
""".split())


def test_the_later_card_names_are_wrappers():
    assert LATER_CARD_NAMES <= set(LATER_FUNCTIONS)


@pytest.mark.parametrize("name", LATER_FUNCTIONS)
def test_a_later_wrapper_sends_numpy_to_the_card_exactly_where_the_reference_does(
        name, tmp_path, no_card):
    args, kwargs = later_plan(name, facade_get(R, name), tmp_path, P)
    level = P.utils.logging.getLogLevel()  # global state setLogLevel changes: put back after
    try:
        facade_get(P, name)(*args, **kwargs)
    except RuntimeError as e:  # NotImplementedError (not_ported, the guards) too
        if "is_available() is False" not in str(e):
            return
        assert name in LATER_CARD_NAMES, (name, e)
        return
    except Exception:  # noqa: BLE001 - the sweep holds the classes; here only the device
        pass
    finally:
        P.utils.logging.setLogLevel(level)
    assert name not in LATER_CARD_NAMES, f"{name} ran on the host"


def _spy(monkeypatch, dotted, ran):
    import importlib

    mod, fn = dotted.rsplit(".", 1)
    m = importlib.import_module("rustcv_tpu_torch." + mod)
    monkeypatch.setattr(m, fn, lambda *a, _n=dotted, **k: ran.append(_n))


@pytest.mark.parametrize("call,spies", [
    (lambda g: P.GFTTDetector_create(50, 0.01, 5).detect(g),
     ["imgproc.good_features_to_track", "ops.features.harris_corner_list"]),
    (lambda g: P.goodFeaturesToTrackWithQuality(g, 50, 0.01, 5, useHarrisDetector=True),
     ["imgproc.good_features_to_track", "ops.features.harris_corner_list",
      "ops.features.harris_response"]),
    (lambda g: P.FarnebackOpticalFlow_create().calc(g, g[::-1].copy(), None),
     ["imgproc.calc_optical_flow_farneback", "ops.farneback.farneback_flow",
      "ops.farneback.farneback_flow_numpy"]),
    (lambda g: P.SparsePyrLKOpticalFlow_create().calc(
        g, g[::-1].copy(), np.array([[[20.0, 20.0]]], np.float32)),
     ["imgproc.calc_optical_flow_pyr_lk"]),
    (lambda g: P.fisheye.undistortImage(g, np.array([[40.0, 0, 32], [0, 40.0, 24], [0, 0, 1]]),
                                        np.zeros(4)),
     ["ops.warp.remap"]),
], ids=["GFTTDetector.detect", "goodFeaturesToTrackWithQuality", "FarnebackOpticalFlow.calc",
        "SparsePyrLKOpticalFlow.calc", "fisheye.undistortImage"])
def test_a_later_numpy_call_without_a_card_raises_before_any_cpu_work(call, spies, no_card,
                                                                     monkeypatch):
    ran = []
    for dotted in spies:
        _spy(monkeypatch, dotted, ran)
    g = np.random.default_rng(0).integers(0, 256, (48, 64), dtype=np.uint8)
    with pytest.raises(RuntimeError, match="is_available"):
        call(g)
    assert ran == []


def _add_text(cv, im):
    return cv.addText(im, "Hi 7b", (3, 25), "DejaVu", 14, (0, 200, 255))


def _threshold_with_mask(cv, im):
    """``src`` a numpy image for the reference, a CPU tensor for the port:
    without a card the port's threshold runs on the CPU, and only ``dst``
    (``im``) is the caller's numpy array or tensor."""
    mask = np.zeros(im.shape[:2], np.uint8)
    mask[4:20, 6:30] = 1
    src = np.random.default_rng(2).integers(0, 256, im.shape, dtype=np.uint8)
    if cv is P:
        src = torch.from_numpy(src)
    return cv.thresholdWithMask(src, im, mask, 120, 255, cv.THRESH_BINARY)[1]


IN_PLACE = [("addText", _add_text), ("thresholdWithMask", _threshold_with_mask)]


@pytest.mark.parametrize("name,write", IN_PLACE, ids=[n for n, _ in IN_PLACE])
def test_later_in_place_writes_land_in_the_callers_array(name, write, no_card):
    base = np.random.default_rng(1).integers(0, 256, (32, 48, 3), dtype=np.uint8)
    img = base[..., 0].copy() if name == "thresholdWithMask" else base.copy()
    want = img.copy()
    write(R, want)
    out = write(P, img)  # no card: addText draws on the host, in the caller's buffer
    assert out is img
    np.testing.assert_array_equal(img, want)
    assert not np.array_equal(img, base[..., 0] if img.ndim == 2 else base)


@pytest.mark.parametrize("name,write", IN_PLACE, ids=[n for n, _ in IN_PLACE])
def test_later_in_place_writes_land_in_the_callers_tensor(name, write):
    base = np.random.default_rng(1).integers(0, 256, (32, 48, 3), dtype=np.uint8)
    img = base[..., 0].copy() if name == "thresholdWithMask" else base.copy()
    want = img.copy()
    write(R, want)
    t = torch.from_numpy(img.copy())
    ptr = t.data_ptr()
    out = write(P, t)
    assert out is t and t.data_ptr() == ptr
    np.testing.assert_array_equal(t.numpy(), want)


def test_add_text_on_a_contiguous_array_copies_nothing_back(monkeypatch):
    from rustcv_tpu_torch.cv2 import _device

    copies = []
    monkeypatch.setattr(_device.np, "copyto", lambda *a, **k: copies.append(a))
    img = np.zeros((24, 48, 3), np.uint8)
    P.addText(img, "Hi", (2, 18), "DejaVu", 14, (0, 255, 0))
    assert img.any() and copies == []


# The six functions the reference runs with Pillow for multi-page and
# animated files (items 8b and 8d-i): each call, on a two-frame GIF and on a
# two-frame animated PNG the reference wrote, answers as the reference's.
PILLOW_BOUND = [
    ("imencodemulti", lambda C, tmp, buf, ext: _decoded(C.imencodemulti(
        ext, [np.zeros((8, 8, 3), np.uint8), np.full((8, 8, 3), 90, np.uint8)]))),
    ("imdecodemulti", lambda C, tmp, buf, ext: C.imdecodemulti(buf)),
    ("imreadanimation", lambda C, tmp, buf, ext: _fields(C.imreadanimation(
        _gif_file(tmp, buf, ext)))),
    ("imwriteanimation", lambda C, tmp, buf, ext: (
        C.imwriteanimation(str(tmp / f"b{ext}"), _anim(C)),
        _fields(R.imreadanimation(str(tmp / f"b{ext}"))))),
    ("imdecodeanimation", lambda C, tmp, buf, ext: _fields(C.imdecodeanimation(buf))),
    ("imencodeanimation", lambda C, tmp, buf, ext: _fields(R.imdecodeanimation(
        C.imencodeanimation(ext, _anim(C))[1]))),
]


def _gif(ext=".gif"):
    """A real two-frame GIF (or animated PNG), written by the reference
    (Pillow)."""
    a = R.Animation()
    a.frames = [np.zeros((8, 8, 3), np.uint8), np.full((8, 8, 3), 200, np.uint8)]
    a.durations = [50, 50]
    ok, buf = R.imencodeanimation(ext, a)
    assert ok
    return buf


def _gif_file(tmp, gif, ext=".gif"):
    path = tmp / f"a{ext}"
    path.write_bytes(gif.tobytes())
    return str(path)


def _anim(C):
    a = C.Animation(2)
    a.frames = [np.zeros((8, 8, 3), np.uint8), np.full((8, 8, 3), 60, np.uint8)]
    a.durations = [30, 70]
    return a


def _decoded(out):
    return out[0], R.imdecodemulti(out[1])[1] if out[0] else out[1].size


def _fields(out):
    ok, anim = out
    return ok, anim.frames, anim.durations, anim.loop_count


def _equal(a, b):
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("name,call", PILLOW_BOUND, ids=[n for n, _ in PILLOW_BOUND])
def test_each_pillow_bound_name_raises_not_ported_item_8(name, call, tmp_path):
    """Items 8b and 8d-i: each of the six answers as the reference's on a
    GIF and on an animated PNG (the name is kept from when they raised
    not_ported)."""
    for ext in (".gif", ".png"):
        buf = _gif(ext)
        assert R.imdecodemulti(buf)[0] is True and len(R.imdecodemulti(buf)[1]) == 2
        (tmp_path / ext[1:] / "p").mkdir(parents=True)
        (tmp_path / ext[1:] / "r").mkdir()
        got = call(P, tmp_path / ext[1:] / "p", buf, ext)
        want = call(R, tmp_path / ext[1:] / "r", buf, ext)
        assert _equal(got, want), (ext, got, want)


def _png_text(C):
    return C.imencodeWithMetadata(".png", np.zeros((8, 8, 3), np.uint8), ["Title"], ["x"])


METADATA = [
    ("imdecodeWithMetadata", lambda C: C.imdecodeWithMetadata(_png_text(R)[1])),
    ("imencodeWithMetadata", lambda C: R.imdecodeWithMetadata(_png_text(C)[1])),
]


@pytest.mark.parametrize("name,call", METADATA, ids=[n for n, _ in METADATA])
def test_the_metadata_names_run_the_ports_codecs(name, call):
    """Of the eight functions that were Pillow-bound, the two metadata ones
    (item 8a) answer as the reference does: a PNG's text comes back, in
    order, with the same pixels; the six multi-page ones are item 8b's."""
    assert len(PILLOW_BOUND) == 6 and name not in dict(PILLOW_BOUND)
    got, want = call(P), call(R)
    assert got[1:] == want[1:] == (["Title"], ["x"]) and np.array_equal(got[0], want[0])


def test_the_swallowing_wrappers_keep_false_for_what_is_no_image(tmp_path):
    junk = np.frombuffer(b"not an image at all, not even close", np.uint8)
    (tmp_path / "junk.gif").write_bytes(junk.tobytes())
    for path in (str(tmp_path / "missing.gif"), str(tmp_path / "junk.gif")):
        ok, anim = P.imreadanimation(path)
        assert ok is R.imreadanimation(path)[0] is False
        assert type(anim).__name__ == "Animation" and anim.frames == []
    assert P.imdecodemulti(junk) == R.imdecodemulti(junk) == (False, [])
    ok, anim = P.imdecodeanimation(junk)
    assert ok is R.imdecodeanimation(junk)[0] is False and anim.frames == []
