"""The port's SIFT, AKAZE and HOG (``rustcv_tpu_torch.ops.sift``,
``akaze``, ``hog``) and their ``imgproc`` names, against ``rustcv_tpu``
(JAX on the CPU) and its float64 numpy oracles on the same seeded inputs.

Tolerances, the reference's own (``tests/test_sift.py``,
``tests/test_akaze.py``, ``tests/test_hog.py``):
- SIFT pyramids: max |Δ| < 2e-3 of the [0, 1] range against the float64
  oracle; keypoint counts within max(3, 15 %) of the host's; on the CPU the
  tensor pyramids equal JAX's, so keypoints and descriptors are equal too;
- AKAZE scale spaces: max |Δ| < 1e-3 against the oracle, the same plan and
  contrast k; over 90 % of the keypoints shared with the host backend; on
  the CPU keypoints and descriptors equal JAX's device backend;
- the host paths (numpy copies) equal the reference's exactly;
- matchers: exact;
- HOG blocks: atol 2e-4, score maps atol 1e-2; detections equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rustcv_tpu.core as jax_core
import rustcv_tpu.imgproc as jax_ip
from rustcv_tpu.ops import akaze as JA
from rustcv_tpu.ops import golden as G
from rustcv_tpu.ops import hog as JH
from rustcv_tpu.ops import sift as JS
from rustcv_tpu_torch import imgproc as port_ip
from rustcv_tpu_torch.core import Mat
from rustcv_tpu_torch.ops import akaze as PA
from rustcv_tpu_torch.ops import hog as PH
from rustcv_tpu_torch.ops import sift as PS

torch.set_num_threads(2)


def _blobs(seed, shape, n=12):
    """Gaussian blobs of a few scales on a dark ground (SIFT/AKAZE fire on
    them; few keypoints keep the host stage short)."""
    rng = np.random.default_rng(seed)
    h, w = shape
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.zeros(shape)
    for _ in range(n):
        cy, cx, s, v = rng.uniform(8, h - 8), rng.uniform(8, w - 8), rng.uniform(2, 5), rng.uniform(80, 200)
        img += v * np.exp(-((ys - cy) ** 2 + (xs - cx) ** 2) / (2 * s * s))
    return np.clip(img + rng.normal(0, 2, shape), 0, 255).astype(np.uint8)


SIFT_IMG = _blobs(1, (56, 72))
AKAZE_IMG = _blobs(2, (64, 80), 16)


# --- SIFT -------------------------------------------------------------------


@pytest.mark.parametrize("double_image", [True, False])
def test_sift_pyramids(double_image):
    gp, dp = PS.build_pyramids_device(torch.from_numpy(SIFT_IMG), double_image=double_image)
    gh, dh = JS.build_pyramids(SIFT_IMG, double_image=double_image)
    gj, dj = JS.build_pyramids_device(SIFT_IMG, double_image=double_image)
    assert len(gp) == len(gh) == len(gj)
    for a, b, c in zip(gp, gh, gj):
        assert a.dtype == np.float64 and np.abs(a - b).max() < 2e-3
        np.testing.assert_array_equal(a, c)
    for a, c in zip(dp, dj):
        np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize("kw", [{}, dict(n_features=8), dict(double_image=False,
                                                             contrast_threshold=0.02)])
def test_sift_detect_and_compute(kw):
    kp, desc = PS.detect_and_compute(torch.from_numpy(SIFT_IMG), **kw)
    kj, dj = JS.detect_and_compute(SIFT_IMG, use_device=True, **kw)
    kh, dh = JS.detect_and_compute(SIFT_IMG, **kw)
    assert kp.dtype == np.float32 and desc.dtype == np.uint8 and desc.shape[1] == 128
    np.testing.assert_array_equal(kp, kj)
    np.testing.assert_array_equal(desc, dj)
    assert abs(len(kp) - len(kh)) <= max(3, 0.15 * len(kh)) and len(kh) > 0
    ph, pdh = PS.detect_and_compute(SIFT_IMG, **kw)
    np.testing.assert_array_equal(ph, kh)
    np.testing.assert_array_equal(pdh, dh)


def test_sift_flat_image_and_l2_matching():
    kp, d = PS.detect_and_compute(torch.full((40, 48), 90, dtype=torch.uint8))
    assert kp.shape == (0, 6) and d.shape == (0, 128)
    _, d1 = JS.detect_and_compute(SIFT_IMG)
    _, d2 = JS.detect_and_compute(np.roll(SIFT_IMG, (2, 3), (0, 1)))
    for ratio in (0.75, 0.9):
        np.testing.assert_array_equal(PS.match_descriptors_l2(d1, d2, ratio),
                                      JS.match_descriptors_l2(d1, d2, ratio))
    assert PS.match_descriptors_l2(d1[:0], d2).shape == (0, 2)
    assert PS.n_octaves_for((720, 1280)) == JS.n_octaves_for((720, 1280))


# --- AKAZE ------------------------------------------------------------------


def test_akaze_scale_space():
    x01 = AKAZE_IMG / 255.0
    lp, plan, k = PA.build_scale_space_device(torch.from_numpy(x01), 3, 3)
    lh, plan_h, k_h = JA.build_scale_space(x01, 3, 3)
    lj, plan_j, k_j = JA.build_scale_space_device(x01, 3, 3)
    assert plan == plan_h == plan_j and k == k_h == k_j
    for a, b, c in zip(lp, lh, lj):
        assert np.abs(a.double().numpy() - b).max() < 1e-3
        np.testing.assert_array_equal(a.numpy(), np.asarray(c))
    assert PA.contrast_k(x01) == JA.contrast_k(x01)


@pytest.mark.parametrize("kw", [dict(n_octaves=3, n_sublevels=3), dict(n_octaves=2, n_sublevels=4,
                                                                       max_keypoints=10)])
def test_akaze_detect_and_compute(kw):
    kp, desc = PA.detect_and_compute(torch.from_numpy(AKAZE_IMG), backend="device", **kw)
    kj, dj = JA.detect_and_compute(AKAZE_IMG, backend="device", **kw)
    kh, dh = JA.detect_and_compute(AKAZE_IMG, **kw)
    np.testing.assert_array_equal(kp, kj)
    np.testing.assert_array_equal(desc, dj)
    set_h = {tuple(np.round(k[:2], 1)) for k in kh}
    set_d = {tuple(np.round(k[:2], 1)) for k in kp}
    assert len(set_h & set_d) > 0.9 * max(len(set_h), len(set_d)) and len(kh) > 0
    ph, pdh = PA.detect_and_compute(AKAZE_IMG, **kw)
    np.testing.assert_array_equal(ph, kh)
    np.testing.assert_array_equal(pdh, dh)
    th, tdh = PA.detect_and_compute(torch.from_numpy(AKAZE_IMG), **kw)  # a tensor, host backend
    np.testing.assert_array_equal(th, kh)


@pytest.mark.parametrize("width", [64, 32, 7])
def test_hamming_matcher_any_width(width):
    rng = np.random.default_rng(width)
    a = rng.integers(0, 256, (30, width), dtype=np.uint8)
    b = np.concatenate([a[::-1][:20], rng.integers(0, 256, (5, width), dtype=np.uint8)])
    b[3, 0] ^= 1
    want = JA.match_descriptors_hamming(a, b)
    np.testing.assert_array_equal(PA.match_descriptors_hamming(a, b), want)
    np.testing.assert_array_equal(PA.match_descriptors_hamming(torch.from_numpy(a), b), want)
    assert PA.match_descriptors_hamming(a[:0], b).shape == (0, 2)


# --- HOG --------------------------------------------------------------------

HOG_IMG = G.gaussian5_u8(np.random.default_rng(3).integers(0, 256, (136, 96), dtype=np.uint8))


@pytest.mark.parametrize("shape", [(136, 96), (64, 64), (16, 24)])
def test_hog_blocks(shape):
    img = HOG_IMG[:shape[0], :shape[1]]
    got = PH.hog_blocks(torch.from_numpy(img)).numpy()
    want = JH.hog_blocks_numpy(img)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=2e-4)
    np.testing.assert_allclose(got, np.asarray(JH.hog_blocks(jnp.asarray(img))), atol=2e-4)
    np.testing.assert_array_equal(PH.hog_blocks_numpy(img), want)
    np.testing.assert_array_equal(PH.hog_cells_numpy(img), JH.hog_cells_numpy(img))
    with pytest.raises(ValueError):
        PH.hog_blocks(torch.zeros((60, 64), dtype=torch.uint8))


def test_hog_score_map_and_window():
    w = np.random.default_rng(4).normal(0, 0.1, 3780).astype(np.float32)
    got = PH.hog_score_map(torch.from_numpy(HOG_IMG), w, 0.25).numpy()
    want = JH.hog_score_map_numpy(HOG_IMG, w, 0.25)
    assert got.shape == want.shape == (2, 5)
    np.testing.assert_allclose(got, want, atol=1e-2)
    np.testing.assert_allclose(got, np.asarray(JH.hog_score_map(
        jnp.asarray(HOG_IMG), jnp.asarray(w), jnp.float32(0.25))), atol=1e-2)
    win = HOG_IMG[:128, :64]
    np.testing.assert_array_equal(PH.hog_window_numpy(win), JH.hog_window_numpy(win))


def _planted():
    rng = np.random.default_rng(5)
    scene = rng.integers(0, 40, (176, 144)).astype(np.uint8)
    scene[30:158, 40:104] = HOG_IMG[:128, :64]
    w = JH.hog_window_numpy(HOG_IMG[:128, :64]).astype(np.float32)
    return scene, w / np.linalg.norm(w), -0.5 * float(np.linalg.norm(w))


@pytest.mark.parametrize("threshold", [0.0, -5.0])
def test_hog_detect_multi_scale(threshold):
    scene, w, b = _planted()
    want = JH.detect_multi_scale(scene, w, b, threshold=threshold)
    got_h = PH.detect_multi_scale(scene, w, b, threshold=threshold)
    np.testing.assert_array_equal(got_h[0], want[0])
    np.testing.assert_array_equal(got_h[1], want[1])
    want_d = JH.detect_multi_scale(scene, w, b, threshold=threshold, use_device=True)
    got_d = PH.detect_multi_scale(torch.from_numpy(scene), w, b, threshold=threshold)
    np.testing.assert_array_equal(got_d[0], want_d[0])
    np.testing.assert_allclose(got_d[1], want_d[1], atol=1e-2)
    assert len(want[0]) >= 1


# --- imgproc names, four ways -----------------------------------------------


def _mats(img):
    port = (Mat.from_array(img.copy(), device="cpu"), Mat.from_device(torch.from_numpy(img.copy())))
    ref = (jax_core.Mat.from_array(img.copy()), jax_core.Mat.from_device(jnp.asarray(img)))
    return port, ref


WRAPPERS = {  # name → (call, image); device results exact against the reference's device Mat
    "sift_features": (lambda ip, m: ip.sift_features(m, n_features=20), SIFT_IMG),
    "akaze_features": (lambda ip, m: ip.akaze_features(m, n_octaves=2, n_sublevels=3), AKAZE_IMG),
    "hog_descriptor": (lambda ip, m: ip.hog_descriptor(m), HOG_IMG[:64, :48]),
}


@pytest.mark.parametrize("name", list(WRAPPERS))
@pytest.mark.parametrize("kind", ["gray", "bgr"])
def test_feature_wrappers_four_ways(name, kind):
    call, img = WRAPPERS[name]
    img = np.repeat(img[..., None], 3, -1) if kind == "bgr" else img[..., None]
    (ph, pd), (rh, rd) = _mats(img)
    for got, want in ((call(port_ip, ph), call(jax_ip, rh)), (call(port_ip, pd), call(jax_ip, rd))):
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for a, b in zip(got, want):
            b = np.asarray(b)
            assert isinstance(a, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape
            if name == "hog_descriptor":
                np.testing.assert_allclose(a, b, atol=2e-4)
            else:
                np.testing.assert_array_equal(a, b)


def test_detect_and_match_names():
    scene, w, b = _planted()
    (ph, pd), (rh, rd) = _mats(scene[..., None])
    for p, r in ((ph, rh), (pd, rd)):
        got = port_ip.hog_detect_multi_scale(p, w, b)
        want = jax_ip.hog_detect_multi_scale(r, w, b)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(got[1], want[1], atol=1e-2)
    _, d1 = JS.detect_and_compute(SIFT_IMG)
    np.testing.assert_array_equal(port_ip.match_descriptors_l2(d1, d1[::-1]),
                                  jax_ip.match_descriptors_l2(d1, d1[::-1]))
    _, a1 = JA.detect_and_compute(AKAZE_IMG, 2, 3)
    np.testing.assert_array_equal(port_ip.match_descriptors_hamming_any(a1, a1[::-1]),
                                  jax_ip.match_descriptors_hamming_any(a1, a1[::-1]))
