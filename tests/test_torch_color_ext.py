"""The port's HSV, YCrCb, Lab, range-mask and moment ops
(``rustcv_tpu_torch.ops.color``), their ``imgproc`` wrappers, the host
``*_cv`` forms and the YUYV decode with the overlay on the pixel pairs,
against ``rustcv_tpu.ops.color`` (JAX on the CPU) and the frozen oracle
``rustcv_tpu.ops.golden`` on the same seeded inputs.

Tolerances: exact for every integer spec (HSV, YCrCb, ranges, moments, the
overlay decode, the ``*_cv`` tables); ±1 LSB for Lab both ways, the
reference's documented tolerance for its float32 form of the float64
spec (against the JAX package and against the oracle)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rustcv_tpu.core as jax_core
import rustcv_tpu.imgproc as jax_ip
from rustcv_tpu.ops import color as J
from rustcv_tpu.ops import golden as G
from rustcv_tpu_torch import imgproc as port_ip
from rustcv_tpu_torch.core import Mat
from rustcv_tpu_torch.ops import color as P

torch.set_num_threads(2)

SHAPES = [(24, 34), (2, 23, 35)]  # (H, W) and a batch with odd sides
LAB_TOL = 1  # ±1 LSB: the reference's float32 Lab against its float64 spec


def _bgr(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, (*shape, 3), dtype=np.uint8)


def _cube(step=5):
    """The colour cube on a grid of every step-th level and 255, as a
    (1, n, 3) image."""
    levels = np.unique(np.r_[np.arange(0, 256, step), 255]).astype(np.uint8)
    g = np.stack(np.meshgrid(levels, levels, levels, indexing="ij"), -1)
    return g.reshape(1, -1, 3)


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert diff.max(initial=0) <= tol, diff.max()


EXACT = ["bgr_to_hsv", "hsv_to_bgr", "bgr_to_ycrcb", "ycrcb_to_bgr"]
LAB = ["bgr_to_lab", "lab_to_bgr"]


@pytest.mark.parametrize("name", EXACT + LAB)
@pytest.mark.parametrize("shape", SHAPES + ["cube"])
def test_conversion_matches_jax_and_golden(name, shape):
    img = _cube() if shape == "cube" else _bgr(shape, seed=len(shape))
    tol = LAB_TOL if name in LAB else 0
    got = getattr(P, name)(torch.from_numpy(img)).numpy()
    _close(got, getattr(J, name)(jnp.asarray(img)), tol)
    flat = img.reshape(-1, 3)  # golden's specs take one image
    _close(got.reshape(-1, 3), getattr(G, name)(flat[None])[0], tol)


def test_hsv_round_trip_within_the_specs_bound():
    img = _bgr((40, 41), seed=3)
    back = P.hsv_to_bgr(P.bgr_to_hsv(torch.from_numpy(img))).numpy()
    _close(back, G.hsv_to_bgr(G.bgr_to_hsv(img)), 0)


@pytest.mark.parametrize("lo,hi", [((10, 20, 30), (200, 210, 220)), ((0, 0, 0), (255, 255, 255)),
                                   ((128, 0, 50), (128, 255, 60))])
@pytest.mark.parametrize("shape", SHAPES)
def test_in_range(shape, lo, hi):
    img = _bgr(shape, seed=5)
    got = P.in_range(torch.from_numpy(img), lo, hi).numpy()
    _close(got, J.in_range(jnp.asarray(img), jnp.asarray(lo), jnp.asarray(hi)), 0)
    _close(got, G.in_range(img, lo, hi), 0)
    # bounds as tensors on the image's device
    _close(P.in_range(torch.from_numpy(img), torch.tensor(lo), torch.tensor(hi)).numpy(), got, 0)


@pytest.mark.parametrize("shape", [(24, 34), (23, 35, 3), (31, 5000)])
def test_moments_exact(shape):
    """Row partials and totals, wider than the reference's 4096-column
    device limit too (the port's partials are int64 everywhere)."""
    mask = np.random.default_rng(7).integers(0, 256, shape, dtype=np.uint8)
    t = torch.from_numpy(mask)
    want = G.moments(mask)
    assert P.moments(t) == want == J.moments(jnp.asarray(mask))
    rows = P.moments_rows(t).numpy()
    if shape[-1] <= 4096:
        np.testing.assert_array_equal(rows, np.asarray(J.moments_rows(jnp.asarray(mask))))
    assert rows.dtype == np.int64 and int(rows[:, 0].sum()) == want["m00"]
    assert "centroid" not in P.moments(torch.zeros(4, 5, dtype=torch.uint8))


@pytest.mark.parametrize("name", ["bgr_to_gray_cv", "bgr_to_hsv_cv", "bgr_to_lab_cv"])
def test_cv_host_forms(name):
    img = _cube(step=2)
    np.testing.assert_array_equal(getattr(P, name)(img), getattr(J, name)(img))


_OVERLAY_JAX = jax.jit(J.yuyv_to_bgr_packed_overlay, static_argnums=(1, 2))


@pytest.mark.parametrize("w,h,n,thickness", [(34, 24, 3, 1), (64, 48, 2, 3), (2, 3, 1, 2)])
def test_yuyv_overlay_decode(w, h, n, thickness):
    rng = np.random.default_rng(w * h)
    src = rng.integers(0, 256, (n, h * w * 2), dtype=np.uint8)
    rects = np.array([[3, 2, w // 2, h // 2], [-5, -3, w + 9, h + 4], [w - 3, h - 2, 9, 9]],
                     np.int32)[:n]
    colors = rng.integers(0, 256, (n, 3), dtype=np.uint8)
    got = P.yuyv_to_bgr_packed_overlay(torch.from_numpy(src), w, h, torch.from_numpy(rects),
                                       torch.from_numpy(colors), thickness).numpy()
    _close(got, _OVERLAY_JAX(jnp.asarray(src), w, h, jnp.asarray(rects), jnp.asarray(colors),
                             thickness), 0)
    # the overlay painted after the decode: the same bytes
    from rustcv_tpu_torch.ops import draw

    after = draw.rectangle_packed(P.yuyv_to_bgr_packed(torch.from_numpy(src), w, h),
                                  torch.from_numpy(rects), torch.from_numpy(colors), thickness)
    np.testing.assert_array_equal(got, after.numpy())


# -- the imgproc wrappers: the port's host and device (CPU tensor) Mats
#    against the reference's host and device (JAX) Mats ------------------------

WRAPPERS = {
    "cvt_hsv": (lambda ip, m: ip.cvt_hsv(m), 0),
    "cvt_hsv_to_bgr": (lambda ip, m: ip.cvt_hsv_to_bgr(m), 0),
    "cvt_ycrcb": (lambda ip, m: ip.cvt_ycrcb(m), 0),
    "cvt_ycrcb_to_bgr": (lambda ip, m: ip.cvt_ycrcb_to_bgr(m), 0),
    "cvt_lab": (lambda ip, m: ip.cvt_lab(m), LAB_TOL),
    "cvt_lab_to_bgr": (lambda ip, m: ip.cvt_lab_to_bgr(m), LAB_TOL),
    "cvt_gray": (lambda ip, m: ip.cvt_gray(m), 0),
    "in_range": (lambda ip, m: ip.in_range(m, (20, 30, 40), (180, 200, 220)), 0),
}


def _mats(img):
    port = (Mat.from_array(img.copy(), device="cpu"), Mat.from_device(torch.from_numpy(img.copy())))
    ref = (jax_core.Mat.from_array(img.copy()), jax_core.Mat.from_device(jnp.asarray(img)))
    return port, ref


@pytest.mark.parametrize("name", list(WRAPPERS))
@pytest.mark.parametrize("hw", [(24, 34), (23, 35)])
def test_color_wrappers_four_ways(name, hw):
    call, tol = WRAPPERS[name]
    img = _bgr(hw, seed=hw[1])
    (p_host, p_dev), (r_host, r_dev) = _mats(img)
    out_host, out_dev = call(port_ip, p_host), call(port_ip, p_dev)
    assert not out_host.is_on_device and out_dev.is_on_device
    _close(out_host.to_numpy(), call(jax_ip, r_host).to_numpy(), tol)
    _close(out_dev.to_numpy(), call(jax_ip, r_dev).to_numpy(), tol)


@pytest.mark.parametrize("channels", [1, 3])
def test_moments_wrapper(channels):
    img = np.random.default_rng(channels).integers(0, 256, (23, 35, channels), dtype=np.uint8)
    (p_host, p_dev), (r_host, r_dev) = _mats(img)
    assert port_ip.moments(p_host) == jax_ip.moments(r_host)
    assert port_ip.moments(p_dev) == jax_ip.moments(r_dev)
