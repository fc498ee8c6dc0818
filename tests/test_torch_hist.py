"""The port's histogram ops (``rustcv_tpu_torch.ops.hist``) and their
``imgproc`` wrappers, against ``rustcv_tpu.ops.hist`` (JAX on the CPU, its
nibble one-hot matmuls) and its numpy oracles on the same seeded inputs.

Tolerance: exact everywhere. The counts are integer and the lookups
gathers; ``equalize_hist`` builds cv2's float32 LUT as the reference
does; CLAHE is all integer."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rustcv_tpu.core as jax_core
import rustcv_tpu.imgproc as jax_ip
from rustcv_tpu.ops import golden as G
from rustcv_tpu.ops import hist as J
from rustcv_tpu_torch import imgproc as port_ip
from rustcv_tpu_torch.core import Mat
from rustcv_tpu_torch.ops import hist as P

torch.set_num_threads(2)


def _img(shape, seed, levels=256):
    return (np.random.default_rng(seed).integers(0, levels, shape) * (256 // levels)).astype(
        np.uint8)


def _exact(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


IMAGES = {  # name → (shape, levels): full range, few levels (ties in the CDF), tiny
    "gray": ((24, 35), 256),
    "odd": ((23, 34), 256),
    "few_levels": ((37, 29), 8),
    "tiny": ((5, 9), 256),
    "flat": ((6, 7), 1),
}


@pytest.mark.parametrize("name", list(IMAGES))
def test_calc_hist_and_equalize(name):
    shape, levels = IMAGES[name]
    g = _img(shape, len(name), levels)
    t = torch.from_numpy(g)
    counts = P.calc_hist(t).numpy()
    _exact(counts, J.calc_hist_numpy(g))
    _exact(counts, np.asarray(J.calc_hist(jnp.asarray(g))))
    eq = P.equalize_hist(t).numpy()
    _exact(eq, J.equalize_hist_numpy(g))
    _exact(eq, np.asarray(J.equalize_hist(jnp.asarray(g))))
    _exact(P.calc_hist_numpy(g), J.calc_hist_numpy(g))
    _exact(P.equalize_hist_numpy(g), J.equalize_hist_numpy(g))


@pytest.mark.parametrize("shape", [(24, 35), (24, 35, 3), (2, 9, 11)])
def test_apply_lut(shape):
    img = _img(shape, 3)
    table = np.random.default_rng(4).integers(0, 256, 256, dtype=np.uint8)
    got = P.apply_lut(torch.from_numpy(img), table).numpy()
    _exact(got, table[img])
    _exact(got, np.asarray(J.apply_lut(jnp.asarray(img), jnp.asarray(table))))
    _exact(P.apply_lut(torch.from_numpy(img), torch.from_numpy(table)).numpy(), got)


CLAHE = {  # name → (image, clip limit, grid)
    "default": ("gray", 40, (8, 8)),
    "odd_grid": ("odd", 40, (3, 5)),
    "hard_clip": ("gray", 2, (4, 4)),
    "no_clip": ("odd", 1000, (2, 3)),
    "few_levels": ("few_levels", 10, (5, 4)),
    "tiles_of_one_row": ("tiny", 40, (5, 3)),
    "flat": ("flat", 40, (2, 2)),
}


@pytest.mark.parametrize("name", list(CLAHE))
def test_clahe(name):
    kind, clip, grid = CLAHE[name]
    shape, levels = IMAGES[kind]
    g = _img(shape, len(name), levels)
    got = P.clahe(torch.from_numpy(g), clip, grid).numpy()
    _exact(got, J.clahe_numpy(g, clip, grid))
    _exact(got, np.asarray(J.clahe(jnp.asarray(g), clip, grid)))
    _exact(P.clahe_numpy(g, clip, grid), got)


def _hsv(seed):
    bgr = _img((23, 35, 3), seed)
    return G.bgr_to_hsv(bgr)


@pytest.mark.parametrize("bins", [180, 16, 30])
def test_hue_hist_and_back_projection(bins):
    hsv = _hsv(5)
    mask = (_img((23, 35), 6) > 100).astype(np.uint8)
    model = J.calc_hue_hist(hsv, mask)
    np.testing.assert_array_equal(P.calc_hue_hist(hsv, mask), model)
    np.testing.assert_array_equal(P.calc_hue_hist(hsv), J.calc_hue_hist(hsv))
    model = np.array([c.sum() for c in np.array_split(model, bins)])  # a coarser model
    want = J.back_project_hue(hsv, model)
    got = P.back_project_hue(torch.from_numpy(hsv), model)
    assert torch.is_tensor(got)
    _exact(got.numpy(), want)
    _exact(P.back_project_hue(hsv, model), want)  # numpy in, numpy out
    _exact(P.back_project_hue(torch.from_numpy(hsv[..., 0].copy()), model).numpy(), want)
    _exact(P.back_project_hue(hsv, np.zeros(bins)), np.zeros((23, 35), np.uint8))


def _blob(seed):
    y, x = np.mgrid[0:60, 0:80]
    cy, cx = 20 + seed, 50 - seed
    return (255 * np.exp(-((y - cy) ** 2 + (x - cx) ** 2) / 60.0)).astype(np.uint8)


@pytest.mark.parametrize("window", [(5, 5, 20, 16), (0, 40, 10, 10), (70, 50, 30, 30)])
def test_mean_shift_and_cam_shift(window):
    prob = _blob(3)
    assert P.mean_shift(prob, window) == J.mean_shift(prob, window)
    assert P.mean_shift(prob, window, max_iter=0, eps=1.0) == J.mean_shift(
        prob, window, max_iter=0, eps=1.0)
    assert P.cam_shift(prob, window) == J.cam_shift(prob, window)


# -- the imgproc wrappers: the port's host and device (CPU tensor) Mats against
#    the reference's host and device (JAX) Mats ---------------------------------


def _mats(img):
    port = (Mat.from_array(img.copy(), device="cpu"), Mat.from_device(torch.from_numpy(img.copy())))
    ref = (jax_core.Mat.from_array(img.copy()), jax_core.Mat.from_device(jnp.asarray(img)))
    return port, ref


def _out(x):
    return x.to_numpy() if hasattr(x, "to_numpy") else np.asarray(x)


_TABLE = (255 * (np.arange(256) / 255.0) ** 0.6).astype(np.uint8)
_MODEL = J.calc_hue_hist(_hsv(7))

WRAPPERS = {  # name → (call, image kinds)
    "calc_hist": (lambda ip, m: ip.calc_hist(m), "bgr gray"),
    "equalize_hist": (lambda ip, m: ip.equalize_hist(m), "gray"),
    "lut": (lambda ip, m: ip.lut(m, _TABLE), "bgr gray"),
    "apply_color_map_jet": (lambda ip, m: ip.apply_color_map(m, "jet"), "bgr gray"),
    "apply_color_map_hot": (lambda ip, m: ip.apply_color_map(m, "hot"), "gray"),
    "clahe": (lambda ip, m: ip.clahe(m, 40, (4, 4)), "gray"),
    "clahe_odd": (lambda ip, m: ip.clahe(m, 3, (3, 5)), "gray"),
    "back_project": (lambda ip, m: ip.back_project(m, _MODEL), "hsv"),
    "calc_hue_hist": (lambda ip, m: ip.calc_hue_hist(m), "hsv"),
    "mean_shift": (lambda ip, m: ip.mean_shift(m, (3, 4, 12, 10)), "gray"),
    "cam_shift": (lambda ip, m: ip.cam_shift(m, (3, 4, 12, 10)), "gray"),
}


def _kind_img(kind, seed):
    if kind == "bgr":
        return _img((23, 35, 3), seed)
    if kind == "hsv":
        return _hsv(seed)
    return _img((23, 35, 1), seed)


@pytest.mark.parametrize("name,kind", [(n, k) for n, v in WRAPPERS.items()
                                       for k in v[1].split()])
def test_hist_wrappers_four_ways(name, kind):
    call = WRAPPERS[name][0]
    img = _kind_img(kind, len(name))
    (p_host, p_dev), (r_host, r_dev) = _mats(img)
    got_host, got_dev = call(port_ip, p_host), call(port_ip, p_dev)
    if isinstance(got_host, Mat):
        assert not got_host.is_on_device and got_dev.is_on_device
    want_host, want_dev = call(jax_ip, r_host), call(jax_ip, r_dev)
    if isinstance(want_host, tuple):
        assert got_host == want_host and got_dev == want_dev
        return
    _exact(_out(got_host), _out(want_host))
    _exact(_out(got_dev), _out(want_dev))


def test_gray_only_hist_wrappers_refuse_bgr():
    m = Mat.from_array(_img((8, 9, 3), 0), device="cpu")
    for fn in (port_ip.equalize_hist, port_ip.clahe,
               lambda x: port_ip.mean_shift(x, (0, 0, 4, 4))):
        with pytest.raises(ValueError):
            fn(m)


def test_counts_and_lookups_use_no_matmul():
    """The reference's nibble one-hot matmuls are a TPU way to count and to
    look up; the port counts with bincount and looks up with a gather."""
    import inspect

    src = inspect.getsource(P)
    for word in ("matmul", "einsum", " @ ", "torch.mm", "bmm"):
        assert word not in src, word
