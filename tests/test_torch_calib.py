"""The port's camera model and calibration (``rustcv_tpu_torch.ops.calib``
and ``ops.calib_ext``) and their ``imgproc`` names against ``rustcv_tpu``
on the same seeded inputs.

- The host float64 code is a copy: every function gives outputs equal to
  the reference's (``np.array_equal``, NaN equal to NaN).
- ``undistort`` and ``fisheye_undistort`` build their maps on the host and
  remap on the image's device through the port's ``warp.remap``, which is
  bit-exact against JAX's: both equal JAX's exactly.
- The end-to-end case renders 8 distorted board views under a known K,
  detects them with ``imgproc.find_chessboard_corners``, calibrates and
  undistorts a frame, each step in the port against the same step in the
  JAX package: ``found`` equal, corners within 1e-3 px, K within 1e-5
  relative and the distortion within 5e-3 of JAX's (k3 is the least
  determined: 9.3e-4 apart here), K within 3 % of the truth (the
  reference's own bar, ``tests/test_chessboard.py``); a board view
  undistorted with JAX's K and distortion equal to JAX's byte for byte,
  and with the port's own within 1."""

import numpy as np
import pytest
import torch

from rustcv_tpu import imgproc as jax_ip
from rustcv_tpu.core.mat import Mat as JMat
from rustcv_tpu.ops import calib as JC
from rustcv_tpu.ops import calib_ext as JE
from rustcv_tpu_torch import imgproc as port_ip
from rustcv_tpu_torch.core import Mat
from rustcv_tpu_torch.ops import calib as PC
from rustcv_tpu_torch.ops import calib_ext as PE

K = np.array([[600.0, 0, 330.0], [0, 590.0, 245.0], [0, 0, 1.0]])
DIST = np.array([-0.18, 0.06, 0.0008, -0.0012, -0.01])
FISH = np.array([0.05, -0.01, 0.002, -0.0005])
SQ = 0.03  # board square, metres
COLS_SQ, ROWS_SQ = 10, 7
PATTERN = (COLS_SQ - 1, ROWS_SQ - 1)


def _same(got, want):
    """Equal values through tuples, lists and dicts (NaN equals NaN)."""
    if isinstance(want, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _same(got[k], want[k])
    elif want is None or isinstance(want, (bool, str)):
        assert got == want
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, w.shape, g.dtype, w.dtype)
        assert np.array_equal(g, w, equal_nan=g.dtype.kind in "fc")


def _board_obj(cols=COLS_SQ, rows=ROWS_SQ):
    gx, gy = np.meshgrid(np.arange(1, cols), np.arange(1, rows))
    return np.stack([gx.ravel(), gy.ravel(), np.zeros(gx.size)], 1) * SQ


def _views(n=6, seed=3, k=K, dist=DIST):
    """Projected corners of n board poses: (objects, image points, poses)."""
    rng = np.random.default_rng(seed)
    obj = _board_obj()
    objs, imgs, poses = [], [], []
    for _ in range(n):
        rv = rng.uniform(-0.3, 0.3, 3)
        tv = np.array([rng.uniform(-0.03, 0.03) - SQ * COLS_SQ / 2,
                       rng.uniform(-0.03, 0.03) - SQ * ROWS_SQ / 2, rng.uniform(0.55, 0.8)])
        objs.append(obj)
        imgs.append(JC.project_points(obj, rv, tv, k, dist))
        poses.append((rv, tv))
    return objs, imgs, poses


def _stereo(seed=5, views=5):
    """A distorted stereo rig seeing ``views`` board poses: the arguments of
    ``stereo_calibrate`` followed by the true (R, T)."""
    k2 = np.array([[560.0, 0, 320], [0, 565.0, 250], [0, 0, 1]])
    d2 = (-0.015, 0.008, 0.0, 0.0008, 0.0)
    rg, tg = JC.rodrigues(np.array([0.02, -0.12, 0.01])), np.array([-0.2, 0.01, 0.02])
    objs, i1, poses = _views(views, seed)
    i2 = [JC.project_points(o, JC.rodrigues(rg @ JC.rodrigues(rv)), rg @ tv + tg, k2, d2)
          for o, (rv, tv) in zip(objs, poses)]
    return objs, i1, i2, K, DIST, k2, d2, rg, tg


def _pnp_case(planar: bool, n=20, seed=4):
    rng = np.random.default_rng(seed)
    obj = rng.uniform(-0.2, 0.2, (n, 3))
    if planar:
        obj[:, 2] = 0.0
    rv, tv = np.array([0.1, -0.2, 0.05]), np.array([0.03, -0.02, 0.9])
    return obj, JC.project_points(obj, rv, tv, K, DIST) + rng.normal(0, 0.2, (n, 2)), rv, tv


def _homography_case():
    rv = np.array([0.05, -0.08, 0.02])
    r = JC.rodrigues(rv)
    t, n, d = np.array([0.1, -0.05, 0.02]), np.array([0.0, 0.0, 1.0]), 1.5
    return K @ (r + np.outer(t, n) / d) @ np.linalg.inv(K)


def _calib_cases():
    rng = np.random.default_rng(11)
    objs, imgs, _ = _views()
    pts = rng.uniform(0, 600, (40, 2))
    obj_p, img_p, rv, tv = _pnp_case(True)
    obj_n, img_n, _, _ = _pnp_case(False)
    stereo = _stereo()
    x = rng.uniform(-1, 1, (30, 3))
    a = np.array([[0.9, -0.1, 0.05, 0.3], [0.1, 1.1, 0.0, -0.2], [0.02, 0.0, 0.95, 0.1]])
    y = x @ a[:, :3].T + a[:, 3]
    y[::7] += 5.0
    disp = rng.uniform(1, 30, (24, 32)).astype(np.float32)
    q = np.array([[1, 0, 0, -16.0], [0, 1, 0, -12.0], [0, 0, 0, 500.0], [0, 0, 1 / 0.1, 0]])
    h = _homography_case()
    obj3 = rng.uniform(-0.3, 0.3, (25, 3)) + [0, 0, 1.5]
    return {
        "rodrigues vec": lambda m: m.rodrigues(np.array([0.3, -0.2, 0.9])),
        "rodrigues mat": lambda m: m.rodrigues(JC.rodrigues(np.array([2.5, -0.4, 1.1]))),
        "project_points": lambda m: m.project_points(obj_n, rv, tv, K, DIST),
        "undistort_points": lambda m: m.undistort_points(pts, K, DIST),
        "undistort_points new_K": lambda m: m.undistort_points(pts, K, DIST, new_K=K * 0.9),
        "undistort_points_cv": lambda m: m.undistort_points_cv(pts, K, DIST, r=JC.rodrigues(
            np.array([0.01, 0.02, 0.0])), p=K),
        "init_undistort_rectify_map": lambda m: m.init_undistort_rectify_map(K, DIST, None,
                                                                             (64, 48)),
        "init_undistort_rectify_map r": lambda m: m.init_undistort_rectify_map(
            K, DIST, K * 0.8, (64, 48), r=JC.rodrigues(np.array([0.02, -0.01, 0.0]))),
        "get_optimal_new_camera_matrix 0": lambda m: m.get_optimal_new_camera_matrix(
            K, DIST, (640, 480), alpha=0.0),
        "get_optimal_new_camera_matrix 1": lambda m: m.get_optimal_new_camera_matrix(
            K, DIST, (640, 480), alpha=1.0, new_size=(800, 600), center_principal_point=True),
        "solve_pnp planar": lambda m: m.solve_pnp(obj_p, img_p, K, DIST),
        "solve_pnp general": lambda m: m.solve_pnp(obj_n, img_n, K, DIST),
        "refine_pose": lambda m: m.refine_pose(obj_n, img_n, K, DIST, rv + 0.02, tv - 0.01),
        "calibrate_camera": lambda m: m.calibrate_camera(objs, imgs, (640, 480)),
        "solve_pnp_ransac": lambda m: m.solve_pnp_ransac(
            obj_n, np.concatenate([img_n[:15], img_n[15:] + 40.0]), K, DIST),
        "stereo_calibrate": lambda m: m.stereo_calibrate(*stereo[:7], iterations=10),
        "stereo_rectify": lambda m: m.stereo_rectify(K, DIST, stereo[5], stereo[6], (640, 480),
                                                     stereo[7], stereo[8]),
        "reproject_image_to_3d": lambda m: m.reproject_image_to_3d(disp, q),
        "decompose_homography_mat": lambda m: m.decompose_homography_mat(h, K),
        "estimate_affine_3d": lambda m: m.estimate_affine_3d(x, y, ransac_thresh=1.0),
        "fisheye_project_points": lambda m: m.fisheye_project_points(obj3, rv, tv, K, FISH),
        "fisheye_undistort_points": lambda m: m.fisheye_undistort_points(pts, K, FISH),
        "fisheye_init_undistort_rectify_map": lambda m: m.fisheye_init_undistort_rectify_map(
            K, FISH, K * 0.7, (64, 48)),
    }


_CALIB = _calib_cases()


@pytest.mark.parametrize("name", sorted(_CALIB))
def test_calib_host_copy_equal(name):
    _same(_CALIB[name](PC), _CALIB[name](JC))


def _ext_cases(tmp):
    rng = np.random.default_rng(21)
    objs, imgs, _ = _views(5, seed=8)
    obj_n, img_n, _, _ = _pnp_case(False, n=12, seed=6)
    p = K @ np.concatenate([JC.rodrigues(np.array([0.2, -0.3, 0.1])),
                            np.array([[0.3], [-0.2], [2.0]])], 1)
    src2 = rng.normal(0, 20, (40, 2))
    dst2 = src2 + [3.5, -2.0]
    dst2[::9] += 30.0
    src3 = rng.normal(0, 20, (40, 3))
    dst3 = src3 + [1.0, -2.0, 0.5]
    pts1 = rng.uniform(50, 590, (40, 2))
    pts2 = pts1 + [12.0, 0.0] + rng.normal(0, 0.3, (40, 2))
    f = np.array([[0, 0, 0.0], [0, 0, -1.0], [0, 1.0, 0]])
    disp = np.full((30, 40), 8.0, np.float32)
    disp[10:13, 10:13] = 30.0
    disp[20, 30] = 50.0
    flow = rng.normal(0, 3, (12, 16, 2)).astype(np.float32)
    path = str(tmp / "flow.flo")
    stereo = _stereo(seed=9, views=4)
    img = np.zeros((96, 128, 3), np.uint8)
    h = _homography_case()
    num, rs, ts, ns = JC.decompose_homography_mat(h, K)
    before = rng.uniform(100, 500, (20, 2))
    bh = np.concatenate([before, np.ones((20, 1))], 1) @ h.T
    after = bh[:, :2] / bh[:, 2:]
    return {
        "compose_rt": lambda m: m.compose_rt(np.array([0.1, 0.2, -0.3]), np.array([1.0, 2, 3]),
                                             np.array([-0.2, 0.1, 0.4]), np.array([0.5, 0, 1])),
        "decompose_projection_matrix": lambda m: m.decompose_projection_matrix(p),
        "calibration_matrix_values": lambda m: m.calibration_matrix_values(K, (640, 480), 3.6, 2.7),
        "sampson_distance": lambda m: m.sampson_distance(np.array([10.0, 20, 1]),
                                                         np.array([12.0, 19, 1]), f + 0.01),
        "estimate_translation_2d": lambda m: m.estimate_translation_2d(src2, dst2),
        "estimate_translation_3d": lambda m: m.estimate_translation_3d(src3, dst3),
        "init_camera_matrix_2d": lambda m: m.init_camera_matrix_2d(objs, imgs, (640, 480)),
        "stereo_rectify_uncalibrated": lambda m: m.stereo_rectify_uncalibrated(
            pts1, pts2, f, (640, 480)),
        "filter_speckles": lambda m: m.filter_speckles(disp.copy(), 0.0, 10, 2.0),
        "optical_flow file": lambda m: (m.write_optical_flow(path, flow),
                                        m.read_optical_flow(path)),
        "solve_p3p": lambda m: m.solve_p3p(obj_n[:3], img_n[:3], K),
        "calibrate_camera_extended": lambda m: m.calibrate_camera_extended(
            objs, imgs, (640, 480), iterations=10),
        "register_cameras": lambda m: m.register_cameras(*stereo[:7], iterations=8),
        "solve_pnp_generic": lambda m: m.solve_pnp_generic(obj_n, img_n, K, DIST),
        "draw_frame_axes": lambda m: m.draw_frame_axes(img.copy(), K / 5, DIST,
                                                       np.array([0.1, 0.2, 0.0]),
                                                       np.array([0.0, 0.0, 1.0]), 0.2, 2),
        "filter_homography_decomp_by_visible_refpoints": lambda m: (
            m.filter_homography_decomp_by_visible_refpoints(rs, ns, before, after)),
        "solve_pnp_epnp": lambda m: m.solve_pnp_epnp(obj_n, img_n, K, DIST),
        "init_inverse_rectification_map": lambda m: m.init_inverse_rectification_map(
            K, DIST, K, (64, 48)),
    }


_EXT_NAMES = sorted(_ext_cases(__import__("pathlib").Path(".")))


@pytest.mark.parametrize("name", _EXT_NAMES)
def test_calib_ext_host_copy_equal(name, tmp_path):
    (tmp_path / "port").mkdir()
    (tmp_path / "ref").mkdir()
    got = _ext_cases(tmp_path / "port")[name](PE)
    want = _ext_cases(tmp_path / "ref")[name](JE)
    _same(got, want)


def _frame(h=48, w=64, c=3, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (h, w, c) if c else (h, w), np.uint8)


@pytest.mark.parametrize("channels", [0, 1, 3])
def test_undistort_equals_jax(channels, jax_cpu):
    img = _frame(60, 80, channels)
    k = K / 8
    k[2, 2] = 1.0
    want = np.asarray(JC.undistort(jax_cpu.numpy.asarray(img), k, DIST))
    got = PC.undistort(torch.from_numpy(img), k, DIST)
    assert got.device.type == "cpu" and np.array_equal(got.numpy(), want)
    got = PC.undistort(torch.from_numpy(img), k, DIST, k * 0.9)
    want = np.asarray(JC.undistort(img, k, DIST, k * 0.9))
    assert np.array_equal(got.numpy(), want)


def test_undistort_zero_distortion_is_identity():
    img = _frame(48, 64)
    out = PC.undistort(torch.from_numpy(img), K / 10 + np.diag([0, 0, 0.9]), (0, 0, 0, 0, 0))
    assert np.array_equal(out.numpy(), img)


@pytest.mark.parametrize("channels", [0, 3])
def test_fisheye_undistort_equals_jax(channels, jax_cpu):
    img = _frame(60, 80, channels, seed=3)
    k = K / 8
    k[2, 2] = 1.0
    want = np.asarray(JC.fisheye_undistort(jax_cpu.numpy.asarray(img), k, FISH, k * 0.8))
    got = PC.fisheye_undistort(torch.from_numpy(img), k, FISH, k * 0.8)
    assert isinstance(got, torch.Tensor) and np.array_equal(got.numpy(), want)
    # the reference remaps a numpy image with its host oracle: the same bytes
    got = PC.fisheye_undistort(torch.from_numpy(img), k, FISH)
    _same(got.numpy(), JC.fisheye_undistort(img, k, FISH))


@pytest.mark.parametrize("fisheye", [False, True])
def test_undistort_numpy_input_goes_to_the_card(fisheye):
    """A numpy image goes to the card (here, with no card, the upload
    raises)."""
    fn, dist = (PC.fisheye_undistort, FISH) if fisheye else (PC.undistort, DIST)
    with pytest.raises((RuntimeError, AssertionError)):
        fn(_frame(), K / 10 + np.diag([0, 0, 0.9]), dist)


def test_imgproc_undistort_four_ways(jax_cpu):
    """``imgproc.undistort`` on the port's host Mat and CPU-tensor Mat
    against the reference's host and JAX Mats: equal bytes, and each Mat's
    side kept."""
    img = _frame(60, 80)
    k = K / 8
    k[2, 2] = 1.0
    ref_host = jax_ip.undistort(JMat.from_array(img), k, DIST)
    jm = JMat.from_array(img)
    jm.device()
    ref_dev = jax_ip.undistort(jm, k, DIST).to_numpy()
    assert np.array_equal(ref_host.to_numpy(), ref_dev)
    for mat in (Mat.from_array(img, device="cpu"), Mat.from_device(torch.from_numpy(img.copy()))):
        out = port_ip.undistort(mat, k, DIST)
        assert out.is_on_device == mat.is_on_device
        assert np.array_equal(out.to_numpy(), ref_dev)


def test_imgproc_solve_pnp_refine_equal():
    obj, img, rv, tv = _pnp_case(False)
    got = port_ip.solve_pnp_refine(obj, img, K, DIST, rv + 0.03, tv + 0.02, 15)
    _same(got, jax_ip.solve_pnp_refine(obj, img, K, DIST, rv + 0.03, tv + 0.02, 15))


@pytest.mark.parametrize("mod,name", [(PC, "calibrate_camera"), (PC, "rodrigues"),
                                      (PC, "undistort_points"), (PC, "fisheye_undistort"),
                                      (PE, "compose_rt"), (PE, "init_inverse_rectification_map"),
                                      (PE, "read_optical_flow")])
def test_imgproc_reexports_are_the_port_functions(mod, name):
    assert getattr(port_ip, name) is getattr(mod, name)


# -- the end-to-end calibration path ----------------------------------------


def render_view(rv, tv, k=K, dist=DIST, size=(640, 480), noise=1.5, seed=0):
    """A 10×7-square board at pose (rv, tv) seen by camera (k, dist): each
    pixel's ideal ray (the inverse distortion) meets the board plane; two
    3×3 box blurs soften the edges. Returns (u8 image, true corners
    (rows·cols, 2) in the object-point order)."""
    w, h = size
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    und = JC.undistort_points(np.stack([xs.ravel(), ys.ravel()], 1), k, dist)
    nrm = np.concatenate([und, np.ones((len(und), 1))], 1) @ np.linalg.inv(k).T
    r = JC.rodrigues(np.asarray(rv, np.float64))
    b = nrm @ np.linalg.inv(np.column_stack([r[:, 0], r[:, 1], tv])).T
    bx, by = b[:, 0] / b[:, 2] / SQ, b[:, 1] / b[:, 2] / SQ
    inside = (bx >= 0) & (bx < COLS_SQ) & (by >= 0) & (by < ROWS_SQ)
    black = ((np.floor(bx).astype(int) + np.floor(by).astype(int)) % 2 == 0) & inside
    img = np.where(black, 40.0, 200.0).reshape(h, w)
    img += np.random.default_rng(seed).normal(0, noise, img.shape)
    for _ in range(2):
        p = np.pad(img, 1, mode="edge")
        img = sum(p[dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)) / 9.0
    truth = JC.project_points(_board_obj(), rv, tv, k, dist)
    return np.clip(img, 0, 255).astype(np.uint8), truth


def align_to_truth(corners, truth, pattern=PATTERN):
    """The detection reordered to the object-point traversal (the detector's
    canonical frame may be a flip of it) and its largest error."""
    cols, rows = pattern
    cg = corners.reshape(rows, cols, 2)
    tg = truth.reshape(rows, cols, 2)
    flips = (lambda a: a, lambda a: a[::-1, ::-1], lambda a: a[::-1, :], lambda a: a[:, ::-1])
    err, f = min(((np.linalg.norm(f(cg) - tg, axis=2).max(), f) for f in flips),
                 key=lambda e: e[0])
    return f(cg).reshape(-1, 2), err


def test_calibration_path_end_to_end(jax_cpu):
    rng = np.random.default_rng(7)
    obj = _board_obj()
    found = {"port": [], "jax": []}
    views = []
    for v in range(8):
        rv = rng.uniform(-0.25, 0.25, 3)
        tv = np.array([rng.uniform(-0.03, 0.03) - SQ * COLS_SQ / 2,
                       rng.uniform(-0.03, 0.03) - SQ * ROWS_SQ / 2, rng.uniform(0.55, 0.8)])
        img, truth = render_view(rv, tv, seed=v)
        views.append(img)
        mat = Mat.from_array(img, device="cpu") if v % 2 else Mat.from_device(torch.from_numpy(img))
        fp, cp = port_ip.find_chessboard_corners(mat, PATTERN)
        fj, cj = jax_ip.find_chessboard_corners(JMat.from_array(img), PATTERN)
        assert fp == fj
        if not fp:
            continue
        assert np.abs(cp - cj).max() <= 1e-3
        for side, c in (("port", cp), ("jax", cj)):
            aligned, err = align_to_truth(c, truth)
            assert err < 1.0
            found[side].append(aligned)
    assert len(found["port"]) >= 6
    rms_p, k_p, d_p, _, _ = PC.calibrate_camera([obj] * len(found["port"]), found["port"],
                                                (640, 480))
    rms_j, k_j, d_j, _, _ = JC.calibrate_camera([obj] * len(found["jax"]), found["jax"],
                                                (640, 480))
    assert rms_p < 1.0
    np.testing.assert_allclose(k_p, k_j, rtol=1e-5)
    np.testing.assert_allclose(d_p, d_j, rtol=0, atol=5e-3)
    for i in (0, 1):
        assert abs(k_p[i, i] - K[i, i]) / K[i, i] < 0.03
        assert abs(k_p[i, 2] - K[i, 2]) < 15
    frame = np.repeat(views[0][..., None], 3, -1)
    ref = jax_ip.undistort(JMat.from_array(frame), k_j, d_j).to_numpy()
    out = port_ip.undistort(Mat.from_device(torch.from_numpy(frame)), k_j, d_j)
    assert out.is_on_device and np.array_equal(out.to_numpy(), ref)
    own = port_ip.undistort(Mat.from_array(frame, device="cpu"), k_p, d_p).to_numpy()
    assert np.abs(own.astype(int) - ref).max() <= 1
