"""The port's filters (``rustcv_tpu_torch.ops.filters``: pyramids,
morphology, medians, thresholds, box and stack blurs, the adaptive
threshold, the bilateral filter, Laplacian, Scharr, ``filter2D``, integral
images, directional derivatives), ``ops.features.corner_sub_pix`` and their
``imgproc`` wrappers, against ``rustcv_tpu.ops.filters`` / ``features``
(JAX on the CPU) and the frozen oracle ``rustcv_tpu.ops.golden`` on the
same seeded inputs.

Tolerances: exact for every integer spec; ``filter2d`` exact for a dyadic
kernel that is not rank 1 and within ±1 LSB otherwise (the reference's
documented tolerance, which the 5×5-default ``gaussian_blur`` at another
``ksize`` or ``sigma`` inherits); ``corner_sub_pix`` within 1e-3 px of the
float64 oracle and of the JAX function."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rustcv_tpu.core as jax_core
import rustcv_tpu.imgproc as jax_ip
from rustcv_tpu.ops import features as JF
from rustcv_tpu.ops import filters as J
from rustcv_tpu.ops import golden as G
from rustcv_tpu_torch import imgproc as port_ip
from rustcv_tpu_torch.capture.simulation import synth_bgr
from rustcv_tpu_torch.core import Mat
from rustcv_tpu_torch.ops import features as PF
from rustcv_tpu_torch.ops import filters as P

torch.set_num_threads(2)

F2D_TOL = 1  # ±1 LSB: a general float kernel's float32 sums against float64
SUBPIX_TOL = 1e-3  # px: the reference's float32 refinement against its oracle


def _img(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


BGR = (2, 24, 35, 3)  # a batch of BGR images with an odd width
GRAY = (2, 23, 34)  # a batch of gray images with an odd height
IMAGES = {"bgr": BGR, "gray": GRAY, "hw": (23, 35)}


def _exact(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(got.astype(np.int64), want.astype(np.int64))


def _within(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.abs(got.astype(np.int64) - want.astype(np.int64)).max(initial=0) <= tol


# (op, port call, JAX call, golden call on one image or None)
_SE = P.get_structuring_element("ellipse", 5)
CASES = {
    "pyr_down": (P.pyr_down, J.pyr_down, G.pyr_down),
    "pyr_up": (P.pyr_up, J.pyr_up, G.pyr_up),
    "erode3": (lambda x: P.erode_u8(x, 3), lambda x: J.erode_u8(x, 3), lambda x: G.erode(x, 3)),
    "dilate5": (lambda x: P.dilate_u8(x, 5), lambda x: J.dilate_u8(x, 5),
                lambda x: G.dilate(x, 5)),
    "median3": (P.median3_u8, J.median3_u8, G.median3),
    "median5": (lambda x: P.median_u8(x, 5), lambda x: J.median_u8(x, 5),
                lambda x: G.median_k(x, 5)),
    "median7": (lambda x: P.median_u8(x, 7), lambda x: J.median_u8(x, 7),
                lambda x: G.median_k(x, 7)),
    "stack_blur": (lambda x: P.stack_blur_u8(x, 5, 9), lambda x: J.stack_blur_u8(x, 5, 9),
                   lambda x: G.stack_blur_u8(x, 5, 9)),
    "box_blur": (lambda x: P.box_blur_u8(x, 5), lambda x: J.box_blur_u8(x, 5), None),
    "erode_kernel": (lambda x: P.erode_kernel_u8(x, _SE), lambda x: J.erode_kernel_u8(x, _SE),
                     lambda x: G.erode_kernel(x, _SE)),
    "dilate_kernel": (lambda x: P.dilate_kernel_u8(x, _SE),
                      lambda x: J.dilate_kernel_u8(x, _SE), lambda x: G.dilate_kernel(x, _SE)),
}
for _op in P.MORPH_OPS:
    CASES[_op] = (lambda x, o=_op: P.morphology_ex_u8(x, o, 3),
                  lambda x, o=_op: J.morphology_ex_u8(x, o, 3),
                  lambda x, o=_op: G.morphology_ex(x, o, 3))
for _t in P.THRESHOLD_TYPES:
    CASES["threshold_" + _t] = (lambda x, t=_t: P.threshold_u8(x, 100, 200, t),
                                lambda x, t=_t: J.threshold_u8(x, 100, 200, t),
                                lambda x, t=_t: G.threshold(x, 100, 200, t))


@pytest.mark.parametrize("name,kind", [(n, k) for n in CASES for k in ("bgr", "gray")
                                       if k == "bgr" or not n.startswith("threshold")])
def test_filter_matches_jax_and_golden(name, kind):
    """Each filter on a batch of BGR images and of gray images (the
    element-wise thresholds on BGR only)."""
    port, jax_fn, golden_fn = CASES[name]
    x = _img(IMAGES[kind], seed=len(name))
    got = port(torch.from_numpy(x)).numpy()
    _exact(got, jax_fn(jnp.asarray(x)))
    if golden_fn is not None:
        _exact(got[0], golden_fn(x[0]))


GRAY_CASES = {
    "adaptive_mean": (lambda g: P.adaptive_threshold_u8(g, 255, "mean", 11, 2, False),
                      lambda g: J.adaptive_threshold_u8(g, 255, "mean", 11, 2, False),
                      lambda g: G.adaptive_threshold(g, 255, "mean", 11, 2, False)),
    "adaptive_gaussian_inv": (lambda g: P.adaptive_threshold_u8(g, 200, "gaussian", 5, -3, True),
                              lambda g: J.adaptive_threshold_u8(g, 200, "gaussian", 5, -3, True),
                              lambda g: G.adaptive_threshold(g, 200, "gaussian", 5, -3, True)),
    "bilateral": (lambda g: P.bilateral5_u8(g, 25), lambda g: J.bilateral5_u8(g, 25),
                  lambda g: G.bilateral5_u8(g, 25)),
    "bilateral_s9": (lambda g: P.bilateral5_u8(g, 9), lambda g: J.bilateral5_u8(g, 9),
                     lambda g: G.bilateral5_u8(g, 9)),
    "laplacian": (P.laplacian3, J.laplacian3, G.laplacian3),
    "scharr_x": (lambda g: P.scharr3_gray(g)[0], lambda g: J.scharr3_gray(g)[0],
                 lambda g: G.scharr3_gray(g)[0]),
    "scharr_y": (lambda g: P.scharr3_gray(g)[1], lambda g: J.scharr3_gray(g)[1],
                 lambda g: G.scharr3_gray(g)[1]),
}
for _dx, _dy, _k in ((1, 0, 3), (0, 1, 3), (2, 0, 5), (1, 1, 5), (0, 2, 7)):
    GRAY_CASES[f"sobel_{_dx}{_dy}_k{_k}"] = (
        lambda g, a=(_dx, _dy, _k): P.sobel_xy(g, *a), lambda g, a=(_dx, _dy, _k): J.sobel_xy(g, *a),
        lambda g, a=(_dx, _dy, _k): P.sobel_xy_numpy(g, *a))


@pytest.mark.parametrize("name", list(GRAY_CASES))
def test_gray_filter_matches_jax_and_golden(name):
    port, jax_fn, golden_fn = GRAY_CASES[name]
    g = _img(GRAY, seed=len(name))
    got = port(torch.from_numpy(g)).numpy()
    _exact(got, jax_fn(jnp.asarray(g)))
    _exact(got[0], golden_fn(g[0]))


def test_gray_only_filters_refuse_bgr():
    x = torch.from_numpy(_img((8, 9, 3), seed=0))
    for fn in (P.adaptive_threshold_u8, P.bilateral5_u8):
        with pytest.raises(ValueError, match="gray"):
            fn(x)


@pytest.mark.parametrize("dx,dy,k", [(1, 0, 3), (0, 1, 5), (2, 0, 3), (1, 1, 7)])
def test_deriv_kernels_and_numpy_oracle(dx, dy, k):
    for a, b in zip(P.deriv_kernels(dx, dy, k), J.deriv_kernels(dx, dy, k)):
        np.testing.assert_array_equal(a, b)
    g = _img((23, 35), seed=k)
    np.testing.assert_array_equal(P.sobel_xy_numpy(g, dx, dy, k), J.sobel_xy_numpy(g, dx, dy, k))


@pytest.mark.parametrize("shape", ["rect", "cross", "ellipse"])
@pytest.mark.parametrize("k", [1, 3, 7])
def test_structuring_elements(shape, k):
    np.testing.assert_array_equal(P.get_structuring_element(shape, k),
                                  J.get_structuring_element(shape, k))


KERNELS = {  # name → (kernel, tolerance)
    "laplace_dyadic": (np.array([[0, 1, 0], [1, -4, 1], [0, 1, 0]]) / 2.0, 0),
    "sharpen_dyadic": (np.array([[0, -1, 0, 1, 0], [-1, 5, -1, 0, 1], [0, -1, 0, 1, 2]]) / 4.0, 0),
    "binomial_rank1": (np.outer([1, 2, 1], [1, 4, 6, 4, 1]) / 64.0, F2D_TOL),
    "random": (np.random.default_rng(11).normal(size=(3, 5)), F2D_TOL),
    "random_7x3": (np.random.default_rng(12).uniform(-0.5, 1, size=(7, 3)), F2D_TOL),
}


@pytest.mark.parametrize("name", list(KERNELS))
@pytest.mark.parametrize("kind", ["bgr", "gray"])
def test_filter2d(name, kind):
    kernel, tol = KERNELS[name]
    x = _img(IMAGES[kind], seed=len(name))
    got = P.filter2d_u8(torch.from_numpy(x), kernel).numpy()
    _within(got, J.filter2d_u8(jnp.asarray(x), kernel), tol)
    _within(got[0], G.filter2d(x[0], kernel), tol)


def test_filter2d_zero_kernel_gives_zeros():
    """golden.filter2d's answer (the reference's separable path fails on
    an all-zero kernel)."""
    x = _img(BGR, seed=0)
    got = P.filter2d_u8(torch.from_numpy(x), np.zeros((3, 5))).numpy()
    _exact(got[1], G.filter2d(x[1], np.zeros((3, 5))))
    assert not got.any()


@pytest.mark.parametrize("shape", [(23, 35), (1, 1), (40, 3)])
def test_integral_is_goldens(shape):
    g = _img(shape, seed=shape[0])
    got = P.integral_u8(torch.from_numpy(g)).numpy()
    assert got.dtype == np.int64
    _exact(got, G.integral(g))
    _exact(got, J.integral_u8(jnp.asarray(g)))
    with pytest.raises(ValueError):
        P.integral_u8(torch.from_numpy(_img((4, 5, 3), seed=0)))


def test_median_in_bands_equals_one_band(monkeypatch):
    """The median's row bands (its memory bound) give the same image as one
    band."""
    x = torch.from_numpy(_img((2, 37, 29, 3), seed=4))
    whole = P.median_u8(x, 5)
    monkeypatch.setattr(P, "_MEDIAN_CHUNK", 29 * 3 * 2 * 25 * 3)  # three rows per band
    np.testing.assert_array_equal(P.median_u8(x, 5).numpy(), whole.numpy())


# -- corner_sub_pix -----------------------------------------------------------


def _corner_scene(w, h, seq):
    """A smoothed gray synth frame and its Harris corners (x, y) + 0.3 px,
    the points corner refinement is for."""
    from rustcv_tpu_torch.ops import color

    g = P.gaussian5_u8(color.bgr_to_gray(torch.from_numpy(synth_bgr(w, h, seq))),
                       has_channels=False)
    coords, valid = PF.harris_corner_list(g, max_corners=64)
    pts = coords[valid].numpy()[:, ::-1].astype(np.float32) + np.float32(0.3)
    return g, pts


@pytest.mark.parametrize("w,h,seq", [(96, 64, 3), (160, 120, 11), (131, 77, 5)])
def test_corner_sub_pix_matches_oracle_and_jax(w, h, seq):
    g, pts = _corner_scene(w, h, seq)
    edge = np.array([[1.0, 1.0], [w - 2.0, h / 2], [w / 2, 2.5]], np.float32)  # windows leave
    pts = np.concatenate([pts, edge])
    got = PF.corner_sub_pix(g, pts).numpy()
    assert got.dtype == np.float32 and got.shape == pts.shape
    np.testing.assert_allclose(got, PF.corner_sub_pix_numpy(g.numpy(), pts), atol=SUBPIX_TOL)
    np.testing.assert_allclose(got, JF.corner_sub_pix_numpy(g.numpy(), pts), atol=SUBPIX_TOL)
    np.testing.assert_allclose(got, JF.corner_sub_pix(jnp.asarray(g.numpy()), jnp.asarray(pts)),
                               atol=SUBPIX_TOL)
    np.testing.assert_array_equal(got[-3:], edge)  # returned unrefined
    # a tensor of points, and other window sizes
    np.testing.assert_allclose(PF.corner_sub_pix(g, torch.from_numpy(pts), win=7, iters=4).numpy(),
                               PF.corner_sub_pix_numpy(g.numpy(), pts, win=7, iters=4),
                               atol=SUBPIX_TOL)


# -- the imgproc wrappers: the port's host and device (CPU tensor) Mats against
#    the reference's host and device (JAX) Mats ---------------------------------

def _mats(img):
    port = (Mat.from_array(img.copy(), device="cpu"), Mat.from_device(torch.from_numpy(img.copy())))
    ref = (jax_core.Mat.from_array(img.copy()), jax_core.Mat.from_device(jnp.asarray(img)))
    return port, ref


def _out(x):
    return x.to_numpy() if hasattr(x, "to_numpy") else np.asarray(x)


MAT_WRAPPERS = {  # name → (call, tolerance, image kinds)
    "pyr_down": (lambda ip, m: ip.pyr_down(m), 0, "bgr gray"),
    "pyr_up": (lambda ip, m: ip.pyr_up(m), 0, "bgr gray"),
    "stack_blur": (lambda ip, m: ip.stack_blur(m, 7), 0, "bgr gray"),
    "stack_blur_kh": (lambda ip, m: ip.stack_blur(m, 3, 9), 0, "bgr"),
    "box_blur": (lambda ip, m: ip.box_blur(m, 3), 0, "bgr gray"),
    "threshold": (lambda ip, m: ip.threshold(m, 90, 250, "trunc"), 0, "bgr gray"),
    "erode": (lambda ip, m: ip.erode(m, 3), 0, "bgr gray"),
    "dilate": (lambda ip, m: ip.dilate(m, 5), 0, "bgr gray"),
    "erode_kernel": (lambda ip, m: ip.erode_kernel(m, ip.get_structuring_element("cross", 5)), 0,
                     "bgr gray"),
    "dilate_kernel": (lambda ip, m: ip.dilate_kernel(m, ip.get_structuring_element("ellipse", 5)),
                      0, "bgr"),
    "median_blur3": (lambda ip, m: ip.median_blur(m, 3), 0, "bgr gray"),
    "median_blur5": (lambda ip, m: ip.median_blur(m, 5), 0, "bgr gray"),
    "morphology_ex": (lambda ip, m: ip.morphology_ex(m, "gradient", 3), 0, "bgr gray"),
    "filter2d": (lambda ip, m: ip.filter2d(m, np.array([[1, 2, 1], [0, 4, 0], [-1, -2, -1]]) / 8),
                 0, "bgr gray"),
    "filter2d_rank1": (lambda ip, m: ip.filter2d(m, np.outer([1, 0, -1], [1, 2, 1]) / 4), F2D_TOL,
                       "gray"),
    "sep_filter_2d": (lambda ip, m: ip.sep_filter_2d(m, [0.25, 0.5, 0.25], [0.1, 0.3, 0.6]),
                      F2D_TOL, "bgr"),
    "gaussian_blur_k3": (lambda ip, m: ip.gaussian_blur(m, 3), F2D_TOL, "bgr gray"),
    "gaussian_blur_sigma": (lambda ip, m: ip.gaussian_blur(m, 5, 1.5), F2D_TOL, "bgr"),
    "gaussian_blur_k9": (lambda ip, m: ip.gaussian_blur(m, 9), F2D_TOL, "bgr"),
    "adaptive_threshold": (lambda ip, m: ip.adaptive_threshold(m, 255, "mean", 7, 3), 0, "gray"),
    "bilateral_filter": (lambda ip, m: ip.bilateral_filter(m, 20), 0, "gray"),
    "integral": (lambda ip, m: ip.integral(m), 0, "bgr gray"),
    "sobel": (lambda ip, m: ip.sobel(m, 1, 1, 5), 0, "bgr gray"),
    "laplacian": (lambda ip, m: ip.laplacian(m), 0, "bgr gray"),
    "scharr": (lambda ip, m: ip.scharr(m, 0, 1), 0, "bgr gray"),
}


@pytest.mark.parametrize("name,kind", [(n, k) for n, v in MAT_WRAPPERS.items()
                                       for k in v[2].split()])
def test_filter_wrappers_four_ways(name, kind):
    call, tol, _ = MAT_WRAPPERS[name]
    img = _img((23, 35, 3) if kind == "bgr" else (23, 35, 1), seed=len(name))
    (p_host, p_dev), (r_host, r_dev) = _mats(img)
    got_host, got_dev = call(port_ip, p_host), call(port_ip, p_dev)
    if isinstance(got_host, Mat):
        assert not got_host.is_on_device and got_dev.is_on_device
    _within(_out(got_host), _out(call(jax_ip, r_host)), tol)
    _within(_out(got_dev), _out(call(jax_ip, r_dev)), tol)


def test_gray_only_wrappers_refuse_bgr():
    m = Mat.from_array(_img((8, 9, 3), seed=0), device="cpu")
    for fn in (port_ip.adaptive_threshold, port_ip.bilateral_filter):
        with pytest.raises(ValueError, match="gray"):
            fn(m)
    with pytest.raises(ValueError):
        port_ip.scharr(m, 1, 1)


@pytest.mark.parametrize("kind", ["bgr", "gray"])
def test_corner_wrappers_four_ways(kind):
    """``good_features_to_track`` (with and without quality) and
    ``corner_sub_pix`` on the Mat's side."""
    img = synth_bgr(96, 64, 7)
    if kind == "gray":
        img = G.bgr_to_gray(img)[..., None]
    (p_host, p_dev), (r_host, r_dev) = _mats(img)
    for port, ref in ((p_host, r_host), (p_dev, r_dev)):
        pts = port_ip.good_features_to_track(port, 32)
        np.testing.assert_array_equal(pts, jax_ip.good_features_to_track(ref, 32))
        assert pts.dtype == np.float32 and 0 < len(pts) <= 32
        q, quality = port_ip.good_features_to_track_with_quality(port, 32, k=0.05)
        want_q, want_quality = jax_ip.good_features_to_track_with_quality(ref, 32, k=0.05)
        np.testing.assert_array_equal(q, want_q)
        np.testing.assert_array_equal(quality, want_quality)
        refined = port_ip.corner_sub_pix(port, pts + 0.25, win=7)
        np.testing.assert_allclose(refined, jax_ip.corner_sub_pix(ref, pts + 0.25, win=7),
                                   atol=SUBPIX_TOL)
    # more corners asked for than the image has pixels
    tiny = Mat.from_array(_img((4, 5, 3), seed=1), device="cpu")
    assert len(port_ip.good_features_to_track(tiny, 256)) <= 20
