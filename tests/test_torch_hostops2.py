"""The port's copies of the jax-free modules of group 2 and of Queue 1
item 3 (``rustcv_tpu_torch.ops.asift``, ``rotwarp``, ``canny_cv``,
``color_cv2``, ``decolor``) and their ``imgproc`` names, value for value
against the reference's modules on the same seeded inputs.

Tolerance: exact everywhere. ``decolor`` draws its random pairs with
``core_ops.RNG(7)`` (cv::RNG's multiply-with-carry), so its result is
exact only if the port's generator replays the reference's stream; ASIFT
runs the port's SIFT on every simulated view."""

import numpy as np
import pytest
import torch

import rustcv_tpu.imgproc as jax_ip
from rustcv_tpu.ops import asift as JAs
from rustcv_tpu.ops import canny_cv as JCc
from rustcv_tpu.ops import color_cv2 as JC2
from rustcv_tpu.ops import decolor as JDc
from rustcv_tpu.ops import rotwarp as JRw
from rustcv_tpu_torch import imgproc as port_ip
from rustcv_tpu_torch.ops import asift as PAs
from rustcv_tpu_torch.ops import canny_cv as PCc
from rustcv_tpu_torch.ops import color_cv2 as PC2
from rustcv_tpu_torch.ops import decolor as PDc
from rustcv_tpu_torch.ops import rotwarp as PRw

torch.set_num_threads(2)


def _img(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _exact(got, want):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _exact(g, w)
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


# --- color_cv2 --------------------------------------------------------------

BGR = _img((12, 18, 3), 1)
BGRA = _img((12, 18, 4), 2)
GRAY = _img((12, 18), 3)
P16 = _img((12, 18, 2), 4)
YUV420 = _img((18, 18), 5)
YUV422 = _img((12, 18, 2), 6)

COLOR = {
    "bgr_to_packed16_565": lambda m: m.bgr_to_packed16(BGR, 6),
    "bgr_to_packed16_555a": lambda m: m.bgr_to_packed16(BGRA, 5, rgb=True),
    "packed16_to_bgr_565": lambda m: m.packed16_to_bgr(P16, 6),
    "packed16_to_bgr_555a": lambda m: m.packed16_to_bgr(P16, 5, rgb=True, alpha=True),
    "packed16_to_gray": lambda m: m.packed16_to_gray(P16, 6),
    "gray_to_packed16": lambda m: m.gray_to_packed16(GRAY, 5),
    "bgr_to_xyz_cv": lambda m: m.bgr_to_xyz_cv(BGR),
    "xyz_to_bgr_cv": lambda m: m.xyz_to_bgr_cv(BGR, rgb=True),
    "bgr_to_yuv_cv": lambda m: m.bgr_to_yuv_cv(BGR),
    "yuv_to_bgr_cv": lambda m: m.yuv_to_bgr_cv(BGR),
    "bgr_to_hsv_full_cv": lambda m: m.bgr_to_hsv_full_cv(BGR),
    "hsv_to_bgr_full_cv": lambda m: m.hsv_to_bgr_full_cv(BGR, rgb=True),
    "bgr_to_hls_cv": lambda m: m.bgr_to_hls_cv(BGR),
    "bgr_to_hls_cv_full": lambda m: m.bgr_to_hls_cv(BGR, full=True),
    "hls_to_bgr_cv": lambda m: m.hls_to_bgr_cv(BGR),
    "hls_to_bgr_cv_full": lambda m: m.hls_to_bgr_cv(BGR, rgb=True, full=True),
    "bgr_to_luv_cv": lambda m: m.bgr_to_luv_cv(BGR),
    "bgr_to_luv_cv_linear": lambda m: m.bgr_to_luv_cv(BGR, srgb=False),
    "luv_to_bgr_cv": lambda m: m.luv_to_bgr_cv(BGR),
    "bgr_to_lab_linear_cv": lambda m: m.bgr_to_lab_linear_cv(BGR),
    "yuv420_to_bgr_cv": lambda m: m.yuv420_to_bgr_cv(GRAY, GRAY[::2, ::2], GRAY[1::2, ::2],
                                                     alpha=True),
    "split_420_buffer": lambda m: tuple(m.split_420_buffer(YUV420, k)[0]
                                        for k in ("nv12", "nv21", "i420", "yv12")),
    "bgr_to_yuv420_cv": lambda m: m.bgr_to_yuv420_cv(BGR, "i420"),
    "bgr_to_yuv420_cv_yv12": lambda m: m.bgr_to_yuv420_cv(BGR, "yv12", rgb=True),
    "yuv422_to_bgr_cv": lambda m: tuple(m.yuv422_to_bgr_cv(YUV422, k) for k in ("yuy2", "yvyu",
                                                                                "uyvy")),
    "bgr_to_yuv422_cv": lambda m: tuple(m.bgr_to_yuv422_cv(BGR, k) for k in ("yuy2", "uyvy")),
    "yuv420_to_gray_cv": lambda m: m.yuv420_to_gray_cv(YUV420),
    "yuv422_to_gray_cv": lambda m: m.yuv422_to_gray_cv(YUV422, "uyvy"),
}


@pytest.mark.parametrize("name", list(COLOR))
def test_color_cv2_is_the_reference(name):
    _exact(COLOR[name](PC2), COLOR[name](JC2))


# --- canny_cv ---------------------------------------------------------------


@pytest.mark.parametrize("aperture,l2", [(3, False), (3, True), (5, False), (7, True)])
@pytest.mark.parametrize("channels", [1, 3])
def test_canny_cv_is_the_reference(aperture, l2, channels):
    from rustcv_tpu.ops.golden import gaussian5_u8

    img = gaussian5_u8(_img((40, 52, 3), aperture))
    img = img if channels == 3 else img[..., 1]
    lo, hi = (30, 90) if aperture == 3 else (300, 900) if aperture == 5 else (3000, 9000)
    _exact(PCc.canny_cv(img, lo, hi, aperture, l2), JCc.canny_cv(img, lo, hi, aperture, l2))


# --- decolor ----------------------------------------------------------------


@pytest.mark.parametrize("kw", [{}, dict(stride=2, n_random=256, rounds=4)])
def test_decolor_is_the_reference(kw):
    img = _img((24, 32, 3), 7)
    got = PDc.decolor(img, **kw)
    _exact(got, JDc.decolor(img, **kw))
    assert PDc.contrast_preservation(got[0], img) == JDc.contrast_preservation(got[0], img)
    _exact(port_ip.decolor(img, **kw), jax_ip.decolor(img, **kw))


# --- rotation warpers -------------------------------------------------------


@pytest.mark.parametrize("kind", ["plane", "cylindrical", "spherical"])
def test_rotation_warper_is_the_reference(kind):
    img = np.zeros((40, 56, 3), np.uint8)
    img[::5] = 255
    img[:, ::7] = 128
    k = np.array([[60.0, 0, 28], [0, 60.0, 20], [0, 0, 1]], np.float32)
    th = 0.15
    r = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]], np.float32)
    got = PRw.RotationWarper(kind, 60.0).warp(img, k, r)
    want = JRw.RotationWarper(kind, 60.0).warp(img, k, r)
    assert got[0] == want[0]
    _exact(got[1], want[1])
    got2 = port_ip.RotationWarper(kind, 60.0).warp(img, k, r)
    assert got2[0] == want[0]
    _exact(got2[1], want[1])


# --- ASIFT ------------------------------------------------------------------


def _blob_scene():
    rng = np.random.default_rng(7)
    h, w = 48, 60
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.zeros((h, w))
    for _ in range(8):
        cy, cx, s = rng.uniform(8, h - 8), rng.uniform(8, w - 8), rng.uniform(2, 4)
        img += rng.uniform(80, 200) * np.exp(-((ys - cy) ** 2 + (xs - cx) ** 2) / (2 * s * s))
    return np.clip(img, 0, 255).astype(np.uint8)


def test_affine_detect_and_compute_is_the_reference():
    g = _blob_scene()
    want = JAs.affine_detect_and_compute(g, n_features=30)
    assert len(want[0]) > 0
    _exact(PAs.affine_detect_and_compute(g, n_features=30), want)
    _exact(port_ip.affine_detect_and_compute(g, n_features=30),
           jax_ip.affine_detect_and_compute(g, n_features=30))
    assert PAs._simulations() == JAs._simulations()
