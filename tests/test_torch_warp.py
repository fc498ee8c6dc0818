"""The port's warps (``rustcv_tpu_torch.ops.warp``: affine, perspective,
``remap``, polar) and their ``imgproc`` wrappers, against
``rustcv_tpu.ops.warp`` (JAX on the CPU, its packed-quad gathers) and its
numpy oracles on the same seeded inputs; the host numpy forms (the
``*_cv_numpy`` warps, ``convert_maps``, the nearest and cubic remaps, the
polar maps) against the reference's.

Tolerance: exact everywhere (an integer fixed-point spec over float64 host
tables; ``remap`` quantizes its float32 maps by powers of two). The cases
cover the boundary taps: 90° rotations, whose float64 residue would flip
taps without the quantization; left and top overhang; both borders; both
modes; odd sizes and a destination of another size."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rustcv_tpu.core as jax_core
import rustcv_tpu.imgproc as jax_ip
from rustcv_tpu.ops import warp as J
from rustcv_tpu_torch import imgproc as port_ip
from rustcv_tpu_torch.core import Mat
from rustcv_tpu_torch.ops import warp as P

torch.set_num_threads(2)


def _img(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _exact(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, want.shape)
    np.testing.assert_array_equal(got, want)


SHAPES = {"bgr": (24, 35, 3), "gray": (23, 34)}  # (H, W, 1) Mats: the wrappers' cases


def _affine(name, h, w):
    c = ((w - 1) / 2.0, (h - 1) / 2.0)
    return {
        "rot90": J.get_rotation_matrix_2d(c, 90.0),
        "rot180": J.get_rotation_matrix_2d(c, 180.0),
        "rot270": J.get_rotation_matrix_2d(c, -90.0),
        "rot30_s09": J.get_rotation_matrix_2d(c, 30.0, 0.9),
        "rot_odd_centre": J.get_rotation_matrix_2d((3.5, 2.25), -17.0, 1.3),
        "overhang_left_top": np.array([[1.0, 0.0, 3.25], [0.0, 1.0, 2.5]]),
        "overhang_right_bottom": np.array([[1.0, 0.0, -4.5], [0.0, 1.0, -3.75]]),
        "shear": np.array([[1.0, 0.3, -2.0], [-0.2, 1.1, 1.0]]),
    }[name]


AFFINE = ("rot90", "rot180", "rot270", "rot30_s09", "rot_odd_centre", "overhang_left_top",
          "overhang_right_bottom", "shear")


@pytest.mark.parametrize("name", AFFINE)
@pytest.mark.parametrize("mode", P.MODES)
@pytest.mark.parametrize("border", P.BORDERS)
@pytest.mark.parametrize("kind", list(SHAPES))
def test_warp_affine(name, mode, border, kind):
    img = _img(SHAPES[kind], len(name))
    h, w = img.shape[:2]
    m = _affine(name, h, w)
    for dsize in ((w, h), (w + 5, h - 3)):
        got = P.warp_affine(torch.from_numpy(img), m, dsize, mode, border).numpy()
        _exact(got, J.warp_affine_numpy(img, m, dsize, mode, border))
        _exact(got, np.asarray(J.warp_affine(jnp.asarray(img), m, dsize, mode, border)))
        _exact(P.warp_affine_numpy(img, m, dsize, mode, border), got)


HOMOGRAPHIES = {
    "mild": np.array([[1.1, 0.05, -2.0], [0.02, 0.95, 1.5], [1e-3, -5e-4, 1.0]]),
    "keystone": np.array([[0.8, -0.1, 4.0], [0.0, 0.7, 2.0], [0.0, -0.01, 1.0]]),
    "four_points": J.get_perspective_transform([[0, 0], [30, 2], [33, 20], [1, 22]],
                                               [[2, 1], [31, 0], [30, 22], [0, 20]]),
}


@pytest.mark.parametrize("name", list(HOMOGRAPHIES))
@pytest.mark.parametrize("mode", P.MODES)
@pytest.mark.parametrize("border", P.BORDERS)
@pytest.mark.parametrize("kind", ["bgr", "gray"])
def test_warp_perspective(name, mode, border, kind):
    img = _img(SHAPES[kind], len(name) + 1)
    hm = HOMOGRAPHIES[name]
    dsize = (img.shape[1] - 2, img.shape[0] + 4)
    got = P.warp_perspective(torch.from_numpy(img), hm, dsize, mode, border).numpy()
    _exact(got, J.warp_perspective_numpy(img, hm, dsize, mode, border))
    _exact(got, np.asarray(J.warp_perspective(jnp.asarray(img), hm, dsize, mode, border)))
    _exact(P.warp_perspective_numpy(img, hm, dsize, mode, border), got)


def test_matrix_helpers():
    for args in (((3.0, 4.5), 30.0, 1.0), ((0.0, 0.0), -90.0, 2.5)):
        np.testing.assert_array_equal(P.get_rotation_matrix_2d(*args), J.get_rotation_matrix_2d(*args))
    src, dst = [[0, 0], [9, 1], [10, 8], [1, 9]], [[1, 1], [8, 0], [9, 9], [0, 8]]
    np.testing.assert_array_equal(P.get_perspective_transform(src, dst),
                                  J.get_perspective_transform(src, dst))
    m = J.get_rotation_matrix_2d((5, 5), 33, 0.7)
    np.testing.assert_array_equal(P.invert_affine_cv(m), J.invert_affine_cv(m))
    with pytest.raises(ValueError):
        P.warp_affine(torch.zeros(4, 4, dtype=torch.uint8), m, (4, 4), mode="cubic")
    with pytest.raises(ValueError):
        P.warp_perspective(torch.zeros(4, 4, dtype=torch.uint8), np.eye(3), (4, 4),
                           border="wrap")


def _maps(kind, shape, h, w, seed):
    rng = np.random.default_rng(seed)
    if kind == "random":  # in and around the image, any fraction
        return ((rng.random(shape) * (w + 6) - 3).astype(np.float32),
                (rng.random(shape) * (h + 6) - 3).astype(np.float32))
    if kind == "grid":  # exact pixel centres and half pixels, the tap boundaries
        ys, xs = np.mgrid[0:shape[0], 0:shape[1]].astype(np.float32)
        return xs * 0.5 - 1.0, ys * 0.5 - 0.5
    # an undistortion-like radial field
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    cx, cy = (w - 1) / 2, (h - 1) / 2
    r2 = ((xs - cx) ** 2 + (ys - cy) ** 2) / (cx * cx + cy * cy)
    k = 1 + 0.12 * r2 - 0.03 * r2 * r2
    return ((xs - cx) * k + cx).astype(np.float32), ((ys - cy) * k + cy).astype(np.float32)


@pytest.mark.parametrize("maps", ["random", "grid", "radial"])
@pytest.mark.parametrize("border", P.BORDERS)
@pytest.mark.parametrize("kind", ["bgr", "gray"])
def test_remap(maps, border, kind):
    img = _img(SHAPES[kind], 3)
    h, w = img.shape[:2]
    mx, my = _maps(maps, (19, 27), h, w, 4)
    got = P.remap(torch.from_numpy(img), mx, my, border).numpy()
    _exact(got, J.remap_numpy(img, mx, my, border))
    _exact(got, np.asarray(J.remap(jnp.asarray(img), jnp.asarray(mx), jnp.asarray(my), border)))
    _exact(P.remap(torch.from_numpy(img), torch.from_numpy(mx), torch.from_numpy(my),
                   border).numpy(), got)


@pytest.mark.parametrize("semilog", [False, True])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("kind", ["bgr", "gray"])
def test_warp_polar(semilog, inverse, kind):
    img = _img(SHAPES[kind], 5)
    h, w = img.shape[:2]
    args = ((w / 2, h / 2), 14.0, (20, 30), semilog, inverse)
    got = P.warp_polar(torch.from_numpy(img), *args).numpy()
    _exact(got, np.asarray(J.warp_polar(jnp.asarray(img), *args)))
    _exact(got, J.warp_polar(img, *args))  # the reference's numpy path
    _exact(P.warp_polar(img, *args), got)
    for fn in ("linear_polar", "log_polar"):
        got = getattr(P, fn)(torch.from_numpy(img), (w / 2, h / 2), 12.0, inverse).numpy()
        _exact(got, np.asarray(getattr(J, fn)(jnp.asarray(img), (w / 2, h / 2), 12.0, inverse)))


HOST_FORMS = {  # name → (call on a module and an image)
    "warp_affine_cv_numpy": lambda M, a: M.warp_affine_cv_numpy(
        a, M.get_rotation_matrix_2d((10, 8), 25, 1.1), (30, 20), "bilinear", "reflect101"),
    "warp_affine_cv_numpy_nearest": lambda M, a: M.warp_affine_cv_numpy(
        a, np.array([[1.0, 0.2, 1.5], [0.1, 0.9, -2.0]]), (30, 20), "nearest", "wrap"),
    "warp_affine_cv_numpy_constant": lambda M, a: M.warp_affine_cv_numpy(
        a, np.array([[0.9, 0.0, 3.3], [0.0, 1.2, -1.7]]), (36, 25), "bilinear", "constant",
        (10, 20, 30)),
    "warp_perspective_cv_numpy": lambda M, a: M.warp_perspective_cv_numpy(
        a, HOMOGRAPHIES["mild"], (30, 20), "bilinear", "reflect"),
    "remap_linear_cv_numpy": lambda M, a: M.remap_linear_cv_numpy(
        a, *_maps("random", (15, 17), 24, 35, 6), "replicate"),
    "remap_nearest_numpy": lambda M, a: M.remap_nearest_numpy(
        a, *_maps("random", (15, 17), 24, 35, 7), "constant", 9),
    "remap_cubic_numpy": lambda M, a: M.remap_cubic_numpy(
        a, *_maps("random", (15, 17), 24, 35, 8), "replicate"),
    "remap_cubic_numpy_constant": lambda M, a: M.remap_cubic_numpy(
        a, *_maps("grid", (15, 17), 24, 35, 8), "constant", 7),
    "convert_maps": lambda M, a: M.convert_maps(*_maps("random", (15, 17), 24, 35, 9)),
    "warp_polar_maps": lambda M, a: M.warp_polar_maps((24, 35), (17.0, 12.0), 15.0, (20, 30),
                                                      True, False),
    "warp_polar_maps_inverse": lambda M, a: M.warp_polar_maps((20, 30), (17.0, 12.0), 15.0,
                                                              (24, 35), False, True),
    "warp_polar_inverse_maps_cv": lambda M, a: M.warp_polar_inverse_maps_cv(
        (20, 30), (24, 35), (17.0, 12.0), 15.0, True),
    "fast_atan2_deg_f32": lambda M, a: M.fast_atan2_deg_f32(
        a[..., 0].astype(np.float32) - 128, a[..., 1].astype(np.float32) - 128),
}


@pytest.mark.parametrize("name", list(HOST_FORMS))
def test_host_forms_are_the_references(name):
    img = _img(SHAPES["bgr"], len(name))
    got, want = HOST_FORMS[name](P, img), HOST_FORMS[name](J, img)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        _exact(g, w)


# -- the imgproc wrappers: the port's host and device (CPU tensor) Mats against
#    the reference's host and device (JAX) Mats ---------------------------------


def _mats(img):
    port = (Mat.from_array(img.copy(), device="cpu"), Mat.from_device(torch.from_numpy(img.copy())))
    ref = (jax_core.Mat.from_array(img.copy()), jax_core.Mat.from_device(jnp.asarray(img)))
    return port, ref


_RADIAL = _maps("radial", None, 23, 35, 0)
WRAPPERS = {
    "warp_affine": lambda ip, m: ip.warp_affine(
        m, ip.get_rotation_matrix_2d((17, 11), 30, 0.9), (35, 23)),
    "warp_affine_nearest_replicate": lambda ip, m: ip.warp_affine(
        m, ip.get_rotation_matrix_2d((17, 11), 90), (30, 26), "nearest", "replicate"),
    "warp_perspective": lambda ip, m: ip.warp_perspective(m, HOMOGRAPHIES["keystone"], (35, 23)),
    "warp_perspective_nearest": lambda ip, m: ip.warp_perspective(
        m, HOMOGRAPHIES["mild"], (31, 25), "nearest", "replicate"),
    "remap": lambda ip, m: ip.remap(m, *_RADIAL),
    "remap_replicate": lambda ip, m: ip.remap(m, *_RADIAL, border="replicate"),
    "rotate": lambda ip, m: ip.rotate(m, 90),
    "rotate_scaled": lambda ip, m: ip.rotate(m, -40, (5, 6), 1.2),
    "warp_polar": lambda ip, m: ip.warp_polar(m, (17, 11), 15.0, (24, 36)),
    "warp_polar_inverse_semilog": lambda ip, m: ip.warp_polar(m, (17, 11), 15.0, (23, 35), True,
                                                              True),
    "linear_polar": lambda ip, m: ip.linear_polar(m, (17, 11), 14.0),
    "log_polar_inverse": lambda ip, m: ip.log_polar(m, (17, 11), 14.0, True),
}


@pytest.mark.parametrize("name", list(WRAPPERS))
@pytest.mark.parametrize("kind", ["bgr", "gray"])
def test_warp_wrappers_four_ways(name, kind):
    call = WRAPPERS[name]
    img = _img((23, 35, 3) if kind == "bgr" else (23, 35, 1), len(name))
    (p_host, p_dev), (r_host, r_dev) = _mats(img)
    got_host, got_dev = call(port_ip, p_host), call(port_ip, p_dev)
    assert not got_host.is_on_device and got_dev.is_on_device
    _exact(got_host.to_numpy(), call(jax_ip, r_host).to_numpy())
    _exact(got_dev.to_numpy(), call(jax_ip, r_dev).to_numpy())


def test_remap_wrapper_takes_tensor_maps():
    img = _img((23, 35, 3), 1)
    (p_host, p_dev), (r_host, _) = _mats(img)
    mx, my = (torch.from_numpy(a) for a in _RADIAL)
    want = jax_ip.remap(r_host, *_RADIAL).to_numpy()
    _exact(port_ip.remap(p_dev, mx, my).to_numpy(), want)
    _exact(port_ip.remap(p_host, mx, my).to_numpy(), want)


def test_device_tables_are_cached_per_key():
    img = torch.from_numpy(_img((23, 35, 3), 2))
    m = P.get_rotation_matrix_2d((10, 10), 12.0)
    P._device_tables.cache_clear()
    for _ in range(3):
        P.warp_affine(img, m, (35, 23))
    info = P._device_tables.cache_info()
    assert (info.misses, info.hits) == (1, 2)
