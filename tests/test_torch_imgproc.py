"""The port's ``imgproc`` against ``rustcv_tpu.imgproc`` on the CPU.

Each drawing call runs four ways on the same seeded image: on the
reference's host Mat (its golden masks) and device Mat (JAX on the CPU),
and on the port's host Mat (with a padded ``step``) and device Mat (a CPU
tensor). Host against host and device against device are bit-exact, and
the port's host Mat keeps its padding bytes. The one place the reference's
own two paths differ is a rectangle edge past the last column: its host
path (``golden.rectangle``, a faithful copy of ``drawing.rs``) lets it
bleed into the next row, its device path clips; the port clips on both,
and that case is held to the reference's device path.

The processing ops (``cvt_gray``, bilinear ``resize``, the 5×5
``gaussian_blur``, ``sobel_magnitude``, ``canny``, ``harris_corners``)
are bit-exact the same four ways; the other resize modes, the other
Gaussian kernels and the rest of the processing wrappers are held the
same way in ``test_torch_color_ext.py``, ``test_torch_filters_ext.py`` and
``test_torch_resize_ext.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rustcv_tpu.core as jax_core
import rustcv_tpu.imgproc as jax_ip
from rustcv_tpu_torch import imgproc as port_ip
from rustcv_tpu_torch.capture.simulation import synth_bgr
from rustcv_tpu_torch.core import Mat

torch.set_num_threads(2)

PAD = 7  # extra bytes per row of the port's host Mat


def _img(h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


def _ref_mats(img):
    return (jax_core.Mat.from_array(img.copy()),
            jax_core.Mat.from_device(jnp.asarray(img)))


def _port_mats(img):
    h, w = img.shape[:2]
    host = Mat.new(h, w, 3, step=w * 3 + PAD, device="cpu")
    host.data[:, w * 3:] = 0xAB
    host.array[:] = img
    return host, Mat.from_device(torch.from_numpy(img.copy()))


def _four_ways(call, img):
    """(port host, port device, reference host, reference device) after
    ``call(module, mat)`` on each."""
    ref_host, ref_dev = _ref_mats(img)
    host, dev = _port_mats(img)
    call(jax_ip, ref_host)
    call(jax_ip, ref_dev)
    call(port_ip, host)
    call(port_ip, dev)
    w3 = img.shape[1] * 3
    assert not host.is_on_device and dev.is_on_device and dev.device().device.type == "cpu"
    assert (host.data[:, w3:] == 0xAB).all()  # the padding never moves
    return host.to_numpy(), dev.to_numpy(), ref_host.to_numpy(), ref_dev.to_numpy()


def _same(call, img):
    host, dev, ref_host, ref_dev = _four_ways(call, img)
    np.testing.assert_array_equal(host, ref_host)
    np.testing.assert_array_equal(dev, ref_dev)
    np.testing.assert_array_equal(host, dev)
    return host


def P(x, y):
    return x, y


LINES = [  # (p1, p2), thickness 1 to 4 each
    (P(3, 4), P(60, 40)), (P(-20, 10), P(90, 30)), (P(10, -5), P(10, 70)),
    (P(32, 24), P(32, 24)), (P(63, 0), P(0, 47)), (P(-50, -50), P(-10, -20)),
]
CIRCLES = [(P(32, 24), 10), (P(0, 0), 15), (P(70, 30), 12), (P(20, 40), 0), (P(-5, 50), 30)]
ELLIPSES = [  # (center, axes, angle)
    (P(32, 24), (20, 10), 0.0), (P(32, 24), (20, 10), 30.0), (P(10, 40), (25, 8), 90.0),
    (P(60, 5), (15, 30), 135.0), (P(32, 24), (0, 10), 45.0), (P(32, 24), (3, 3), 17.5),
]
POLYS = [
    [(5, 5), (60, 10), (30, 45)],                      # triangle
    [(10, 10), (50, 10), (30, 25), (50, 40), (10, 40)],  # concave
    [(-20, -10), (80, 5), (40, 70)],                   # past every edge
    [(5, 5), (5, 5), (20, 30), (40, 8)],               # a repeated vertex
]
RECTS = [  # (x, y, w, h); no edge reaches past the last column at thickness <= 4
    (10, 8, 30, 20), (-9, -5, 40, 20), (20, 30, 40, 40), (0, 0, 64, 48), (5, 5, 3, 2),
    (30, 10, 0, 10), (70, 10, 5, 5),
]


@pytest.mark.parametrize("thickness", [1, 2, 3, 4])
@pytest.mark.parametrize("p1,p2", LINES)
def test_line(p1, p2, thickness):
    _same(lambda ip, m: ip.line(m, ip.Point(*p1), ip.Point(*p2), ip.Scalar(10, 200, 30), thickness),
          _img(48, 64, seed=thickness))


@pytest.mark.parametrize("thickness", [-1, 1, 2, 3, 4])
@pytest.mark.parametrize("center,radius", CIRCLES)
def test_circle(center, radius, thickness):
    _same(lambda ip, m: ip.circle(m, ip.Point(*center), radius, ip.Scalar(1, 2, 250), thickness),
          _img(48, 64, seed=radius))


@pytest.mark.parametrize("thickness", [-1, 1, 2, 4])
@pytest.mark.parametrize("center,axes,angle", ELLIPSES)
def test_ellipse(center, axes, angle, thickness):
    _same(lambda ip, m: ip.ellipse(m, ip.Point(*center), axes, angle, ip.Scalar(90, 80, 70), thickness),
          _img(48, 64, seed=int(angle)))


@pytest.mark.parametrize("pts", POLYS)
def test_fill_poly(pts):
    _same(lambda ip, m: ip.fill_poly(m, np.array(pts), ip.Scalar(255, 0, 255)), _img(48, 64, seed=len(pts)))


@pytest.mark.parametrize("closed", [False, True])
def test_polylines_and_arrowed_line(closed):
    pts = [(3, 3), (60, 10), (50, 45), (-4, 30)]

    def call(ip, m):
        ip.polylines(m, pts, ip.Scalar(0, 255, 255), 2, closed=closed)
        ip.arrowed_line(m, ip.Point(5, 40), ip.Point(58, 8), ip.Scalar(255, 255, 0), 1, tip_length=0.3)
        ip.arrowed_line(m, ip.Point(9, 9), ip.Point(9, 9), ip.Scalar(1, 1, 1))

    _same(call, _img(48, 64, seed=3))


@pytest.mark.parametrize("thickness", [1, 2, 3, 4])
@pytest.mark.parametrize("rect", RECTS)
def test_rectangle(rect, thickness):
    _same(lambda ip, m: ip.rectangle(m, ip.Rect(*rect), ip.Scalar(0, 255, 0), thickness),
          _img(48, 64, seed=thickness))


def test_rectangle_past_the_last_column_clips():
    """x_min + thickness > cols: the reference's host path bleeds into the
    next row, its device path clips; the port clips on both."""
    call = lambda ip, m: ip.rectangle(m, ip.Rect(61, 40, 9, 9), ip.Scalar(0, 0, 255), 4)  # noqa: E731
    host, dev, ref_host, ref_dev = _four_ways(call, _img(48, 64, seed=9))
    np.testing.assert_array_equal(host, ref_dev)
    np.testing.assert_array_equal(dev, ref_dev)
    assert not np.array_equal(ref_host, ref_dev)


def test_a_larger_frame():
    def call(ip, m):
        ip.rectangle(m, ip.Rect(100, 100, 400, 300), ip.Scalar(0, 255, 0), 2)
        ip.line(m, ip.Point(0, 119), ip.Point(159, 0), ip.Scalar(255, 0, 0), 3)
        ip.circle(m, ip.Point(80, 60), 25, ip.Scalar(0, 0, 255), -1)
        ip.ellipse(m, ip.Point(80, 60), (50, 20), 60.0, ip.Scalar(9, 9, 9), 2)
        ip.fill_poly(m, [(10, 100), (60, 70), (150, 119)], ip.Scalar(7, 8, 9))

    _same(call, _img(120, 160, seed=11))


def test_drawing_needs_three_channels_and_skips_empty_mats():
    gray = Mat.from_array(np.zeros((4, 4), np.uint8), device="cpu")
    with pytest.raises(ValueError):
        port_ip.line(gray, port_ip.Point(0, 0), port_ip.Point(3, 3), port_ip.Scalar.all(255))
    empty = Mat.empty()
    port_ip.rectangle(empty, port_ip.Rect(0, 0, 2, 2), port_ip.Scalar.all(1))
    port_ip.ellipse(empty, port_ip.Point(0, 0), (2, 2), 0.0, port_ip.Scalar.all(1))
    assert empty.is_empty()


def test_types_match_the_reference():
    assert port_ip.Scalar.new(1, 2, 3).bgr == jax_ip.Scalar.new(1, 2, 3).bgr == (1, 2, 3)
    assert port_ip.Scalar.all(7) == port_ip.Scalar(7, 7, 7)
    assert port_ip.Rect(1, 2, 3, 4) == port_ip.Rect(x=1, y=2, width=3, height=4)
    assert port_ip.Point(1, 2).x == 1


# -- processing ops ----------------------------------------------------------------

PROCESSING = {
    "cvt_gray": lambda ip, m: ip.cvt_gray(m),
    "resize_down": lambda ip, m: ip.resize(m, 40, 30),
    "resize_up": lambda ip, m: ip.resize(m, 100, 77),
    "gaussian_blur": lambda ip, m: ip.gaussian_blur(m),
    "sobel_magnitude": lambda ip, m: ip.sobel_magnitude(m),
    "canny": lambda ip, m: ip.canny(m),
    "canny_thresholds": lambda ip, m: ip.canny(m, 20, 60),
}


def _processing_images():
    smooth = synth_bgr(64, 48, 17)
    noisy = np.clip(smooth.astype(np.int16) + np.random.default_rng(5).integers(-20, 21, smooth.shape),
                    0, 255).astype(np.uint8)
    return {"synth": smooth, "noisy": noisy, "random": _img(48, 64, seed=21)}


@pytest.mark.parametrize("image", ["synth", "noisy", "random"])
@pytest.mark.parametrize("op", sorted(PROCESSING))
def test_processing_ops(op, image):
    img = _processing_images()[image]
    ref_host, ref_dev = _ref_mats(img)
    host, dev = _port_mats(img)
    got_host, got_dev = PROCESSING[op](port_ip, host), PROCESSING[op](port_ip, dev)
    assert not got_host.is_on_device and got_host.target == "cpu" and got_dev.is_on_device
    want_host, want_dev = PROCESSING[op](jax_ip, ref_host), PROCESSING[op](jax_ip, ref_dev)
    assert got_host.shape == want_host.shape
    np.testing.assert_array_equal(got_host.to_numpy(), want_host.to_numpy())
    np.testing.assert_array_equal(got_dev.to_numpy(), want_dev.to_numpy())


@pytest.mark.parametrize("kwargs", [{}, {"k": 0.06, "threshold_rel": 0.05}, {"nms_radius": 2}])
@pytest.mark.parametrize("image", ["synth", "noisy"])
def test_harris_corners(image, kwargs):
    img = _processing_images()[image]
    ref_host, ref_dev = _ref_mats(img)
    host, dev = _port_mats(img)
    got = port_ip.harris_corners(host, **kwargs)
    assert got.dtype == bool and got.shape == (48, 64)
    np.testing.assert_array_equal(got, jax_ip.harris_corners(ref_host, **kwargs))
    np.testing.assert_array_equal(port_ip.harris_corners(dev, **kwargs),
                                  jax_ip.harris_corners(ref_dev, **kwargs))


def test_processing_on_a_gray_mat():
    g = synth_bgr(64, 48, 3)[..., 1]
    got = port_ip.canny(Mat.from_array(g, device="cpu"))
    want = jax_ip.canny(jax_core.Mat.from_array(g))
    np.testing.assert_array_equal(got.to_numpy(), want.to_numpy())
    np.testing.assert_array_equal(port_ip.harris_corners(Mat.from_device(torch.from_numpy(g))),
                                  jax_ip.harris_corners(jax_core.Mat.from_device(jnp.asarray(g))))


def test_what_is_not_ported_raises():
    """Text outside the font data (a size past 160 px, a character outside
    ASCII and Latin-1) raises; what once was outside it (80 px, "naïve")
    draws as the reference draws."""
    m = Mat.from_array(_img(8, 8, seed=0), device="cpu")
    for text, scale in (("hi", 8.5), ("na\u012dve", 1.0), ("two\nlines", 1.0)):
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 8"):
            port_ip.put_text(m, text, port_ip.Point(1, 6), scale, port_ip.Scalar.all(255))
    for text, scale in (("hi", 4.0), ("naïve", 1.0)):
        a = _img(120, 200, seed=1)
        got, want = Mat.from_array(a.copy(), device="cpu"), jax_core.Mat.from_array(a.copy())
        port_ip.put_text(got, text, port_ip.Point(3, 90), scale, port_ip.Scalar(0, 200, 255))
        jax_ip.put_text(want, text, jax_ip.Point(3, 90), scale, jax_ip.Scalar(0, 200, 255))
        np.testing.assert_array_equal(got.to_numpy(), want.to_numpy())
    with pytest.raises(ValueError):
        port_ip.resize(m, 4, 4, "lanczos")


# -- the draw ops under the facade, with per-image params ---------------------------


def test_draw_ops_with_batched_params():
    """``ops.draw``'s rectangle (HWC) and packed-rows line, circle, mask
    paint and filled polygon against ``rustcv_tpu.ops.draw`` on a batch of
    images, with params per image (the reference's mask paint and polygon
    take one colour for the batch) or shared."""
    from rustcv_tpu.ops import draw as J

    from rustcv_tpu_torch.ops import draw as T

    n, h, w = 3, 48, 64
    rng = np.random.default_rng(8)
    img = rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)
    packed = img.reshape(n, h, w * 3)
    colors = rng.integers(0, 256, (n, 3), dtype=np.uint8)
    rects = np.array([[10, 8, 30, 20], [-9, -5, 40, 20], [5, 5, 3, 2]], np.int32)
    p1 = np.array([[3, 4], [-20, 10], [32, 24]], np.int32)
    p2 = np.array([[60, 40], [90, 30], [32, 24]], np.int32)
    thick = np.array([1, 3, 4], np.int32)
    centers = np.array([[32, 24], [0, 0], [70, 30]], np.int32)
    radii = np.array([10, 15, 12], np.int32)
    mask = (rng.random((h, w)) > 0.7).astype(np.uint8) * 255
    pts = np.array([(10, 10), (50, 10), (30, 25), (50, 40), (10, 40)], np.int32)
    t = torch.from_numpy
    cases = [
        (T.rectangle(t(img), t(rects), t(colors), t(thick)),
         J.rectangle(jnp.asarray(img), rects, colors, thick)),
        (T.rectangle(t(img), (10, 8, 30, 20), (0, 255, 0), 2),
         J.rectangle(jnp.asarray(img), np.array([10, 8, 30, 20]), np.array([0, 255, 0]), 2)),
        (T.line_packed(t(packed), t(p1), t(p2), t(colors), t(thick)),
         J.line_packed(jnp.asarray(packed), p1, p2, colors, thick)),
        (T.circle_packed(t(packed), t(centers), t(radii), t(colors), t(thick - 2)),
         J.circle_packed(jnp.asarray(packed), centers, radii, colors, thick - 2)),
        (T.paint_mask_packed(t(packed), mask, t(colors[0])),
         J.paint_mask_packed(jnp.asarray(packed), jnp.asarray(mask), colors[0])),
        (T.fill_poly_packed(t(packed), t(pts), t(colors[1])),
         J.fill_poly_packed(jnp.asarray(packed), pts, colors[1])),
        (T.fill_poly_packed(t(packed), pts, (1, 2, 3), include_edges=False),
         J.fill_poly_packed(jnp.asarray(packed), pts, np.array([1, 2, 3]), include_edges=False)),
    ]
    for i, (got, want) in enumerate(cases):
        assert got.dtype == torch.uint8, i
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"case {i}")
    assert not np.array_equal(cases[0][0].numpy(), img)
