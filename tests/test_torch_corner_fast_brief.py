"""The port's corner responses, FAST and BRIEF/ORB
(``rustcv_tpu_torch.ops.corner``, ``fast``, ``brief``) and their
``imgproc`` names, against ``rustcv_tpu`` (JAX on the CPU) and its numpy
oracles on the same seeded inputs.

Tolerances, the reference's own (``tests/test_corner.py``,
``tests/test_fast.py``, ``tests/test_brief.py``, ``tests/test_orb.py``):
- ``spatial_gradient``: exact (int32);
- the float responses: atol 3e-6 · max(1, max |response|) against the
  float64 oracle and against JAX; eigenvectors collinear (|dot| > 0.999)
  where the eigenvalues are well separated;
- FAST masks, scores and top-K corner lists: exact (against the oracle
  on every image, JAX on the noise image), ties in the reference's order
  (lowest flat index first);
- BRIEF and ORB descriptors and validity: bit for bit; ORB angles within
  1e-3 rad of the oracle (and of JAX); matches exact. Keypoints within 16
  px of every edge, and off the image, are among the cases."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rustcv_tpu.core as jax_core
import rustcv_tpu.imgproc as jax_ip
from rustcv_tpu.ops import brief as JB
from rustcv_tpu.ops import corner as JC
from rustcv_tpu.ops import fast as JF
from rustcv_tpu.ops import golden as G
from rustcv_tpu_torch import imgproc as port_ip
from rustcv_tpu_torch.core import Mat
from rustcv_tpu_torch.ops import brief as PB
from rustcv_tpu_torch.ops import corner as PC
from rustcv_tpu_torch.ops import fast as PF

torch.set_num_threads(2)


def _smooth(seed, shape):
    rng = np.random.default_rng(seed)
    return G.gaussian5_u8(G.gaussian5_u8(rng.integers(0, 256, shape, dtype=np.uint8)))


def _blocks(seed, shape):
    """Piecewise-flat texture with sharp corners (FAST fires on it)."""
    rng = np.random.default_rng(seed)
    h, w = shape
    cells = rng.integers(0, 5, (h // 6 + 1, w // 7 + 1)) * 60
    return np.kron(cells, np.ones((6, 7), np.int64))[:h, :w].astype(np.uint8)


IMG = _smooth(1234, (48, 64))


# --- corner responses -------------------------------------------------------


@pytest.mark.parametrize("ksize", [3, 5, 7])
def test_spatial_gradient_exact(ksize):
    t = torch.from_numpy(IMG)
    dx, dy = PC.spatial_gradient(t, ksize)
    jdx, jdy = JC.spatial_gradient(jnp.asarray(IMG), ksize)
    ndx, ndy = JC.spatial_gradient_numpy(IMG, ksize)
    for got, a, b in ((dx, jdx, ndx), (dy, jdy, ndy)):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(a))
        np.testing.assert_array_equal(got.numpy(), b)
    np.testing.assert_array_equal(PC.spatial_gradient_numpy(IMG, ksize)[0], ndx)


@pytest.mark.parametrize("block,ksize", [(3, 3), (5, 3), (3, 5), (5, 5), (7, 3)])
def test_min_eigen_val(block, ksize):
    ours = JC.corner_min_eigen_val_numpy(IMG, block, ksize)
    tol = 3e-6 * max(1, float(ours.max()))
    got = PC.corner_min_eigen_val(torch.from_numpy(IMG), block, ksize).numpy()
    np.testing.assert_allclose(got, ours, atol=tol)
    np.testing.assert_allclose(got, np.asarray(JC.corner_min_eigen_val(jnp.asarray(IMG), block,
                                                                       ksize)), atol=tol)
    np.testing.assert_array_equal(PC.corner_min_eigen_val_numpy(IMG, block, ksize), ours)


@pytest.mark.parametrize("block,ksize", [(3, 3), (5, 5)])
def test_eigen_vals_and_vecs(block, ksize):
    ours = JC.corner_eigen_vals_and_vecs_numpy(IMG, block, ksize)
    scale = max(1.0, float(np.abs(ours[..., :2]).max()))
    got = PC.corner_eigen_vals_and_vecs(torch.from_numpy(IMG), block, ksize).numpy()
    ref = np.asarray(JC.corner_eigen_vals_and_vecs(jnp.asarray(IMG), block, ksize))
    np.testing.assert_allclose(got[..., :2], ours[..., :2], atol=3e-6 * scale)
    np.testing.assert_allclose(got[..., :2], ref[..., :2], atol=3e-6 * scale)
    sep = (ours[..., 0] - ours[..., 1]) > 1e-4 * scale
    for base in (2, 4):
        dot = np.abs(got[..., base] * ours[..., base] + got[..., base + 1] * ours[..., base + 1])
        assert dot[sep].min() > 0.999
    np.testing.assert_array_equal(PC.corner_eigen_vals_and_vecs_numpy(IMG, block, ksize), ours)


@pytest.mark.parametrize("ksize", [3, 5])
def test_pre_corner_detect(ksize):
    ours = JC.pre_corner_detect_numpy(IMG, ksize)
    scale = max(1e-6, float(np.abs(ours).max()))
    got = PC.pre_corner_detect(torch.from_numpy(IMG), ksize).numpy()
    np.testing.assert_allclose(got, ours, atol=3e-6 * scale)
    np.testing.assert_allclose(got, np.asarray(JC.pre_corner_detect(jnp.asarray(IMG), ksize)),
                               atol=3e-6 * scale)
    np.testing.assert_array_equal(PC.pre_corner_detect_numpy(IMG, ksize), ours)


def test_corner_names_in_imgproc():
    t = torch.from_numpy(IMG)
    j = jnp.asarray(IMG)
    np.testing.assert_array_equal(port_ip.spatial_gradient(t)[0].numpy(),
                                  np.asarray(jax_ip.spatial_gradient(j)[0]))
    scale = max(1.0, float(np.abs(np.asarray(jax_ip.corner_min_eigen_val(j))).max()))
    for name in ("corner_min_eigen_val", "pre_corner_detect"):
        want = np.asarray(getattr(jax_ip, name)(j))
        got = getattr(port_ip, name)(t).numpy()
        np.testing.assert_allclose(got, want, atol=3e-6 * max(scale, float(np.abs(want).max())))
    got = port_ip.corner_eigen_vals_and_vecs(t).numpy()[..., :2]
    want = np.asarray(jax_ip.corner_eigen_vals_and_vecs(j))[..., :2]
    np.testing.assert_allclose(got, want, atol=3e-6 * max(1.0, float(np.abs(want).max())))


# --- FAST -------------------------------------------------------------------

FAST_IMGS = {"blocks": _blocks(3, (60, 80)), "noise": np.random.default_rng(4).integers(
    0, 256, (40, 52), dtype=np.uint8), "flat": np.full((24, 30), 90, np.uint8)}


@pytest.mark.parametrize("name", list(FAST_IMGS))
@pytest.mark.parametrize("pattern", ["9_16", "7_12", "5_8"])
@pytest.mark.parametrize("nms", [True, False])
@pytest.mark.parametrize("threshold", [10, 40])
def test_fast_response_exact(name, pattern, nms, threshold):
    """Against the oracle everywhere, and against JAX on the noise image
    (each static argument set compiles anew there)."""
    img = FAST_IMGS[name]
    cm, sc = PF.fast_response(torch.from_numpy(img), threshold, None, nms, pattern)
    om, osc = JF.fast_corners_numpy(img, threshold, None, nms, pattern)
    np.testing.assert_array_equal(cm.numpy(), om)
    np.testing.assert_array_equal(sc.numpy(), osc)
    if name == "noise":
        jm, js = JF.fast_response(jnp.asarray(img), threshold, None, nms, pattern)
        np.testing.assert_array_equal(cm.numpy(), np.asarray(jm))
        np.testing.assert_array_equal(sc.numpy(), np.asarray(js))
    pm, ps = PF.fast_corners_numpy(img, threshold, None, nms, pattern)
    np.testing.assert_array_equal(pm, om)
    np.testing.assert_array_equal(ps, osc)


@pytest.mark.parametrize("name", ["blocks", "noise"])
@pytest.mark.parametrize("k", [5, 64, 300])
def test_fast_corner_list_order_and_ties(name, k):
    """Equal scores are common on the piecewise-flat image: the list must
    keep ``lax.top_k``'s order (lowest flat index first)."""
    img = FAST_IMGS[name]
    yx, valid = PF.fast_corner_list(torch.from_numpy(img), max_corners=k)
    jyx, jvalid = JF.fast_corner_list(jnp.asarray(img), max_corners=k)
    np.testing.assert_array_equal(yx.numpy(), np.asarray(jyx))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    assert yx.dtype == torch.int32


# --- BRIEF / ORB ------------------------------------------------------------


def _keypoints(h, w, seed, n=40):
    """Random keypoints, then ones inside 16 px of each edge, on the image's
    corners, off the image, and on half-pixel rounding ties."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(0, w - 1, n), rng.uniform(0, h - 1, n)], 1)
    edge = [[3.2, 20.0], [w - 4.6, 25.0], [30.0, 2.7], [33.0, h - 1.2], [0.0, 0.0],
            [w - 1.0, h - 1.0], [15.5, 16.5], [16.5, 15.5], [w - 16.5, h - 17.5],
            [-3.0, 10.0], [w + 2.0, h + 5.0], [40.5, 30.5]]
    return np.concatenate([pts, edge]).astype(np.float32)


BIMG = _smooth(7, (72, 96))
PTS = _keypoints(72, 96, 8)


def test_brief_descriptors_bit_exact():
    d, v = PB.brief_descriptors(torch.from_numpy(BIMG), PTS)
    jd, jv = JB.brief_descriptors(jnp.asarray(BIMG), jnp.asarray(PTS))
    nd, nv = JB.brief_descriptors_numpy(BIMG, PTS)
    assert d.dtype == torch.uint32 and d.shape == (len(PTS), 8)
    for a, b in ((d, jd), (v, jv)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(d.numpy(), nd)
    np.testing.assert_array_equal(v.numpy(), nv)
    assert 0 < nv.sum() < len(PTS)
    pd, pv = PB.brief_descriptors_numpy(BIMG, PTS)
    np.testing.assert_array_equal(pd, nd)
    np.testing.assert_array_equal(PB.brief_pattern(), JB.brief_pattern())


def test_orb_orientations_and_descriptors():
    t = torch.from_numpy(BIMG)
    ang = PB.orb_orientations(t, PTS).numpy()
    want = JB.orb_orientations_numpy(BIMG, PTS)
    assert np.abs(ang - want).max() < 1e-3
    assert np.abs(ang - np.asarray(JB.orb_orientations(jnp.asarray(BIMG), jnp.asarray(PTS)))).max() < 1e-3
    np.testing.assert_array_equal(PB.orb_orientations_numpy(BIMG, PTS), want)
    # descriptors from the same angles: bit for bit, bins at the edges too
    angles = np.concatenate([ang[:-4], np.float32([0.0, 2 * np.pi, 2 * np.pi * 29.5 / 30, -0.1])])
    d, v = PB.orb_descriptors(t, PTS, torch.from_numpy(angles))
    jd, jv = JB.orb_descriptors(jnp.asarray(BIMG), jnp.asarray(PTS), jnp.asarray(angles))
    nd, nv = JB.orb_descriptors_numpy(BIMG, PTS, angles)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(d.numpy(), nd)
    pd, pv = PB.orb_descriptors_numpy(BIMG, PTS, angles)
    np.testing.assert_array_equal(pd, nd)
    np.testing.assert_array_equal(PB._steered_offsets()[0], JB._steered_offsets()[0])


@pytest.mark.parametrize("shift", [(0, 0), (2, 3), (-5, 1)])
@pytest.mark.parametrize("ratio", [0.8, 1.0])
def test_match_descriptors_exact(shift, ratio):
    dy, dx = shift
    img2 = np.roll(BIMG, (dy, dx), (0, 1))
    d1, v1 = JB.brief_descriptors_numpy(BIMG, PTS)
    d2, v2 = JB.brief_descriptors_numpy(img2, PTS + np.float32([dx, dy]))
    want = JB.match_descriptors(d1, d2, v1, v2, ratio)
    for args in ((d1, d2, v1, v2), (torch.from_numpy(d1), torch.from_numpy(d2),
                                    torch.from_numpy(v1), torch.from_numpy(v2))):
        np.testing.assert_array_equal(PB.match_descriptors(*args, ratio=ratio), want)
    np.testing.assert_array_equal(PB.match_descriptors(d1, d2, ratio=ratio),
                                  JB.match_descriptors(d1, d2, ratio=ratio))
    assert len(want) > 10


def test_match_descriptors_ties_and_empty():
    d = np.zeros((4, 8), np.uint32)
    d[1, 0] = 1
    np.testing.assert_array_equal(PB.match_descriptors(d, d), JB.match_descriptors(d, d))
    z = np.zeros((0, 8), np.uint32)
    assert PB.match_descriptors(z, d).shape == JB.match_descriptors(z, d).shape == (0, 2)


# --- imgproc names, four ways -----------------------------------------------


def _mats(img):
    port = (Mat.from_array(img.copy(), device="cpu"), Mat.from_device(torch.from_numpy(img.copy())))
    ref = (jax_core.Mat.from_array(img.copy()), jax_core.Mat.from_device(jnp.asarray(img)))
    return port, ref


KIMG = {"gray": _blocks(5, (64, 80))[..., None],
        "bgr": np.stack([_blocks(5, (64, 80)), _blocks(6, (64, 80)), _blocks(5, (64, 80))], -1)}

WRAPPERS = {
    "fast_corners": lambda ip, m: ip.fast_corners(m, threshold=20, max_corners=50),
    "fast_corners_no_nms": lambda ip, m: ip.fast_corners(m, threshold=30, nms=False),
    "compute_brief": lambda ip, m: ip.compute_brief(m, _keypoints(64, 80, 9)),
    "orb_features": lambda ip, m: ip.orb_features(m, max_keypoints=40),
}


@pytest.mark.parametrize("name", list(WRAPPERS))
@pytest.mark.parametrize("kind", list(KIMG))
def test_feature_wrappers_four_ways(name, kind):
    call = WRAPPERS[name]
    (ph, pd), (rh, rd) = _mats(KIMG[kind])
    for got, want in ((call(port_ip, ph), call(jax_ip, rh)), (call(port_ip, pd), call(jax_ip, rd))):
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert isinstance(a, np.ndarray) and a.dtype == np.asarray(b).dtype
            if name == "orb_features" and a.dtype == np.float32 and a.ndim == 1:
                assert np.abs(a - np.asarray(b)).max() < 1e-3  # angles
            else:
                np.testing.assert_array_equal(a, np.asarray(b))


def test_match_descriptors_wrapper():
    d1, v1 = JB.brief_descriptors_numpy(BIMG, PTS)
    d2, v2 = JB.brief_descriptors_numpy(np.roll(BIMG, 1, 1), PTS + np.float32([1, 0]))
    np.testing.assert_array_equal(port_ip.match_descriptors(d1, d2, v1, v2),
                                  jax_ip.match_descriptors(d1, d2, v1, v2))
