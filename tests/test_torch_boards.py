"""The port's calibration-target detectors (``rustcv_tpu_torch.ops.chessboard``,
``ops.chessboard_sb``, ``ops.circles_grid`` and ``ops.aruco``) and their
``imgproc`` names against ``rustcv_tpu`` on the same seeded renders.

- ``chessboard`` and ``chessboard_sb``: host pipelines whose refinement
  (``features.corner_sub_pix``, float32) and, for SB, whose likelihood
  field (one 16-channel ``conv2d``) run on a tensor: ``found`` equal and
  corners within 1e-3 px of JAX's; the SB field within 1e-5 of its float64
  oracle (``tests/test_chessboard_sb.py``) and of JAX's field; the
  reference's own bars on the detections (grid error < 0.8 px for the quad
  ladder, < 1.0 px for SB, ``tests/test_chessboard.py``).
- ``circles_grid`` and ``aruco`` are host copies: equal outputs, but for
  the ChArUco corners, refined on a tensor (within 1e-3 px); the
  reference's bars (centres within 1 px, marker corners within 3 px, pose
  within 1e-3, board pose within 0.02 rad / 0.01 m) hold on the port.

Boards are rendered here with numpy (``test_chessboard.render_board``,
disc grids, markers warped by ``warp.warp_perspective_numpy``)."""

import numpy as np
import pytest
import torch

from rustcv_tpu import imgproc as jax_ip
from rustcv_tpu.core.mat import Mat as JMat
from rustcv_tpu.ops import aruco as JA
from rustcv_tpu.ops import calib as JCal
from rustcv_tpu.ops import chessboard as JCB
from rustcv_tpu.ops import chessboard_sb as JSB
from rustcv_tpu.ops import circles_grid as JCG
from rustcv_tpu_torch import imgproc as port_ip
from rustcv_tpu_torch.core import Mat
from rustcv_tpu_torch.ops import aruco as PA
from rustcv_tpu_torch.ops import chessboard as PCB
from rustcv_tpu_torch.ops import chessboard_sb as PSB
from rustcv_tpu_torch.ops import circles_grid as PCG
from rustcv_tpu_torch.ops import warp as PW
from test_chessboard import PATTERN, _h, grid_error, render_board

BOARDS = {  # name → (image height, width, board homography, noise)
    "fronto": (400, 500, _h(0.0, 40, 60, 50), 2.0),
    "perspective": (420, 520, _h(0.12, 38, 60, 50, 1e-4, -6e-5), 3.0),
    "rotated_90": (420, 340, _h(np.pi / 2, 36, 300, 40), 2.0),
}


def _board(name, seed=0):
    h, w, hm, noise = BOARDS[name]
    return render_board(h, w, hm, noise=noise, seed=seed)


def _close(got, want, tol=1e-3):
    (fg, cg), (fw, cw) = got, want
    assert fg == fw
    assert cg.shape == cw.shape and cg.dtype == cw.dtype == np.float64
    if fg:
        assert np.abs(cg - cw).max() <= tol


@pytest.mark.parametrize("refine", [True, False])
@pytest.mark.parametrize("name", sorted(BOARDS))
def test_chessboard_matches_jax(name, refine):
    img, truth = _board(name)
    got = PCB.find_chessboard_corners(torch.from_numpy(img), PATTERN, refine=refine)
    _close(got, JCB.find_chessboard_corners(img, PATTERN, refine=refine))
    bar = (1.0 if name == "rotated_90" else 0.8) if refine else 2.0  # test_chessboard.py's
    assert got[0] and grid_error(got[1], truth) < bar


def test_chessboard_numpy_refinement_goes_to_the_card():
    """A numpy image with no device named is refined on the card (here,
    with no card, the upload raises)."""
    img, _ = _board("fronto")
    with pytest.raises((RuntimeError, AssertionError)):
        PCB.find_chessboard_corners(img, PATTERN)


def test_chessboard_rejects_blank():
    got = PCB.find_chessboard_corners(torch.full((200, 200), 128, dtype=torch.uint8), PATTERN)
    assert got[0] is False and got[1].shape == (0, 2)
    _close(got, JCB.find_chessboard_corners(np.full((200, 200), 128, np.uint8), PATTERN))


def test_estimate_chessboard_sharpness_equal():
    img, truth = _board("perspective")
    _, corners = JCB.find_chessboard_corners(img, PATTERN)
    for g in (img, np.repeat(img[..., None], 3, -1)):
        got = PCB.estimate_chessboard_sharpness(g, PATTERN, corners)
        assert got == JCB.estimate_chessboard_sharpness(g, PATTERN, corners)
    assert port_ip.estimate_chessboard_sharpness is PCB.estimate_chessboard_sharpness


@pytest.mark.parametrize("shape,seed", [((48, 64), 0), ((37, 53), 1), ((64, 80), 2)])
def test_sb_likelihood_matches_oracle_and_jax(shape, seed, jax_cpu):
    img = np.random.default_rng(seed).uniform(0, 1, shape)
    got = PSB._likelihood(torch.as_tensor(img, dtype=torch.float32)).numpy()
    assert got.dtype == np.float32 and got.shape == shape
    assert np.abs(got - PSB._likelihood_numpy(img)).max() < 1e-5
    want = np.asarray(JSB._likelihood(jax_cpu.numpy.asarray(img, jax_cpu.numpy.float32)))
    assert np.abs(got - want).max() < 1e-5
    assert np.array_equal(PSB._kernels_np(), JSB._kernels_np())


def _blurred(name, k=3):
    img, truth = _board(name)
    p = np.pad(img.astype(np.float64), k, mode="edge")
    h, w = img.shape
    out = sum(p[dy:dy + h, dx:dx + w] for dy in range(2 * k + 1)
              for dx in range(2 * k + 1)) / (2 * k + 1) ** 2
    return out.astype(np.uint8), truth


SB_CASES = {"fronto": lambda: _board("fronto"), "perspective": lambda: _board("perspective"),
            "rotated_90": lambda: _board("rotated_90"), "blurred": lambda: _blurred("fronto")}


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("name", sorted(SB_CASES))
def test_sb_matches_jax(name, normalize):
    img, truth = SB_CASES[name]()
    got = PSB.find_chessboard_corners_sb(torch.from_numpy(img), PATTERN, normalize=normalize)
    _close(got, JSB.find_chessboard_corners_sb(img, PATTERN, normalize=normalize))
    assert got[0] and grid_error(got[1], truth) < 1.0


def test_sb_rejects_blank_and_noise():
    for img in (np.full((120, 160), 128, np.uint8),
                np.random.default_rng(3).integers(0, 256, (120, 160)).astype(np.uint8)):
        got = PSB.find_chessboard_corners_sb(torch.from_numpy(img), PATTERN)
        _close(got, JSB.find_chessboard_corners_sb(img, PATTERN))
        assert not got[0]


def _mats(img):
    """The port's host Mat and CPU-tensor Mat, the reference's host Mat."""
    return (Mat.from_array(img, device="cpu"), Mat.from_device(torch.from_numpy(img.copy())),
            JMat.from_array(img))


@pytest.mark.parametrize("bgr", [False, True])
def test_imgproc_chessboard_wrappers(bgr):
    img, truth = _board("perspective", seed=1)
    if bgr:
        img = np.repeat(img[..., None], 3, -1)
    host, dev, ref = _mats(img)
    for fn in ("find_chessboard_corners", "find_chessboard_corners_sb"):
        want = getattr(jax_ip, fn)(ref, PATTERN)
        for m in (host, dev):
            got = getattr(port_ip, fn)(m, PATTERN)
            _close(got, want)
    _close(port_ip.find_chessboard_corners(host, PATTERN, refine=False),
           jax_ip.find_chessboard_corners(img, PATTERN, refine=False))


# -- circle grids -----------------------------------------------------------


def _render_discs(centers, radius, hmat, shape, noise=2.0, seed=0):
    h, w = shape
    img = np.full(shape, 215.0)
    p = np.concatenate([centers, np.ones((len(centers), 1))], 1) @ hmat.T
    p = p[:, :2] / p[:, 2:3]
    ys, xs = np.mgrid[0:h, 0:w]
    for cx, cy in p:
        img[(xs - cx) ** 2 + (ys - cy) ** 2 <= radius * radius] = 35.0
    img += np.random.default_rng(seed).normal(0, noise, shape)
    q = np.pad(img, 1, mode="edge")
    img = sum(q[dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)) / 9.0
    return np.clip(img, 0, 255).astype(np.uint8), p


def _h_for(scale, tx, ty, tilt=0.0):
    return np.array([[scale, tilt * scale, tx], [-tilt * scale * 0.5, scale, ty],
                     [1e-4, -8e-5, 1.0]])


CIRCLES = {  # name → (pattern, asymmetric, radius, homography, shape)
    "symmetric": ((5, 4), False, 11.0, _h_for(34.0, 70.0, 55.0, tilt=0.08), (240, 320)),
    "asymmetric": ((4, 11), True, 6.0, _h_for(15.0, 50.0, 30.0, tilt=0.05), (240, 320)),
    "small": ((4, 3), False, 10.0, _h_for(30.0, 60.0, 40.0), (200, 280)),
}


@pytest.mark.parametrize("name", sorted(CIRCLES))
def test_circles_grid_equal(name):
    pattern, asym, radius, hmat, shape = CIRCLES[name]
    obj = PCG.circles_grid_object_points(pattern, 1.0, asymmetric=asym)
    assert np.array_equal(obj, JCG.circles_grid_object_points(pattern, 1.0, asymmetric=asym))
    img, centres = _render_discs(obj[:, :2], radius, hmat, shape)
    found, got = PCG.find_circles_grid(img, pattern, asymmetric=asym)
    wfound, want = JCG.find_circles_grid(img, pattern, asymmetric=asym)
    assert found and wfound and np.array_equal(got, want)
    nearest = np.linalg.norm(got[:, None] - centres[None], axis=2).min(axis=1)
    assert nearest.max() <= 1.0
    assert port_ip.find_circles_grid is PCG.find_circles_grid


def test_circles_grid_rejects_sparse():
    img = np.full((120, 160), 220, np.uint8)
    assert PCG.find_circles_grid(img, (4, 3)) == JCG.find_circles_grid(img, (4, 3))


# -- ArUco ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def dics():
    return PA.Dictionary.generate(24, 4, seed=7), JA.Dictionary.generate(24, 4, seed=7)


def test_dictionary_and_markers_equal(dics):
    pd, jd = dics
    assert np.array_equal(pd.codes, jd.codes) and pd.bits == jd.bits
    for mid in (0, 5, 23):
        assert np.array_equal(PA.draw_marker(pd, mid, 6), JA.draw_marker(jd, mid, 6))
        for k in range(4):
            assert pd.match(np.rot90(pd.codes[mid], k)) == jd.match(np.rot90(jd.codes[mid], k))


def _paste_warped(canvas, patch, hmat):
    warped = PW.warp_perspective_numpy(patch[..., None], hmat, canvas.shape[::-1])[..., 0]
    mask = PW.warp_perspective_numpy(np.full_like(patch, 255)[..., None], hmat,
                                     canvas.shape[::-1])[..., 0]
    canvas[mask > 128] = warped[mask > 128]
    return canvas


def _marker_scenes(pd):
    rot = np.full((200, 260), 200, np.uint8)
    rot[60:108, 80:128] = np.rot90(PA.draw_marker(pd, 5, 8), 1)
    multi = np.full((240, 320), 190, np.uint8)
    for mid, (y, x) in [(2, (30, 40)), (9, (30, 200)), (17, (150, 120))]:
        multi[y:y + 48, x:x + 48] = PA.draw_marker(pd, mid, 8)
    srcq = np.array([[0, 0], [59, 0], [59, 59], [0, 59]], np.float64)
    dstq = np.array([[90, 60], [200, 70], [190, 170], [80, 150]], np.float64)
    persp = _paste_warped(np.full((240, 320), 200, np.uint8), PA.draw_marker(pd, 11, 10),
                          PW.get_perspective_transform(srcq, dstq))
    noise = np.random.default_rng(2).integers(0, 256, (160, 200)).astype(np.uint8)
    return {"rotated": rot, "multiple": multi, "perspective": persp, "noise": noise}


@pytest.mark.parametrize("name", ["rotated", "multiple", "perspective", "noise"])
def test_detect_markers_equal(name, dics):
    pd, jd = dics
    img = _marker_scenes(pd)[name]
    corners, ids = PA.detect_markers(img, pd)
    wc, wi = JA.detect_markers(img, jd)
    assert np.array_equal(ids, wi) and len(corners) == len(wc)
    assert all(np.array_equal(a, b) for a, b in zip(corners, wc))
    for m in _mats(img)[:2]:
        c2, i2 = port_ip.detect_aruco_markers(m, pd)
        assert np.array_equal(i2, ids) and all(np.array_equal(a, b) for a, b in zip(c2, corners))
    if name == "perspective":
        for dq in np.array([[90, 60], [200, 70], [190, 170], [80, 150]], np.float64):
            assert np.min(np.linalg.norm(corners[0] - dq, axis=1)) < 3.0


def test_pose_single_markers_equal():
    k = np.array([[400.0, 0, 160], [0, 400.0, 120], [0, 0, 1]])
    length, rvec, tvec = 0.1, np.array([0.1, -0.2, 0.05]), np.array([0.02, -0.01, 0.6])
    half = length / 2
    obj = np.array([[-half, -half, 0], [half, -half, 0], [half, half, 0], [-half, half, 0]])
    px = [JCal.project_points(obj, rvec, tvec, k, (0,) * 5).astype(np.float32)]
    got = PA.estimate_pose_single_markers(px, length, k)
    want = JA.estimate_pose_single_markers(px, length, k)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert np.abs(got[0][0] - rvec).max() < 1e-3 and np.abs(got[1][0] - tvec).max() < 1e-3


def _board_view(board_img, k, rvec, tvec, scale, origin_px, size):
    """The board image seen by camera ``k`` at pose (rvec, tvec): object
    point (0, 0) at board pixel ``origin_px`` (pixel centres at +0.5),
    ``scale`` metres per board pixel; white outside the board."""
    r = JCal.rodrigues(np.asarray(rvec, np.float64))
    shift = np.array([[1, 0, -origin_px + 0.5], [0, 1, -origin_px + 0.5], [0, 0, 1.0]])
    hmat = k @ np.column_stack([r[:, 0], r[:, 1], tvec]) @ np.diag([scale, scale, 1.0]) @ shift
    return _paste_warped(np.full(size[::-1], 255, np.uint8), board_img, hmat)


def test_grid_board_pose_equal(dics):
    pd, jd = dics
    board, jboard = PA.GridBoard((4, 3), 0.04, 0.02, pd), JA.GridBoard((4, 3), 0.04, 0.02, jd)
    img = board.draw(cell_px=10)
    assert np.array_equal(img, jboard.draw(cell_px=10))
    assert np.array_equal(board.marker_object_corners(5), jboard.marker_object_corners(5))
    k = np.array([[520.0, 0, 160], [0, 520.0, 120], [0, 0, 1.0]])
    rvec, tvec = np.array([0.15, -0.1, 0.05]), np.array([-0.1, -0.07, 0.45])
    view = _board_view(img, k, rvec, tvec, 0.04 / (pd.bits + 2) / 10.0, 10.0, (320, 240))
    corners, ids = PA.detect_markers(view, pd)
    assert len(ids) >= 6
    got = PA.estimate_pose_board(corners, ids, board, k)
    want = JA.estimate_pose_board(corners, ids, jboard, k)
    assert got[0] == want[0] and all(np.array_equal(a, b) for a, b in zip(got[1:], want[1:]))
    np.testing.assert_allclose(got[1], rvec, atol=0.02)
    np.testing.assert_allclose(got[2], tvec, atol=0.01)


def test_charuco_interpolation_matches_jax(dics):
    pd, jd = dics
    board = PA.CharucoBoard((5, 4), 0.04, 0.03, pd)
    jboard = JA.CharucoBoard((5, 4), 0.04, 0.03, jd)
    img = board.draw(square_px=40)
    assert np.array_equal(img, jboard.draw(square_px=40))
    assert np.array_equal(board.chessboard_corners(), jboard.chessboard_corners())
    k = np.array([[540.0, 0, 170], [0, 540.0, 130], [0, 0, 1.0]])
    rvec, tvec = np.array([0.1, -0.12, 0.03]), np.array([-0.09, -0.06, 0.5])
    view = _board_view(img, k, rvec, tvec, 0.04 / 40.0, 0.0, (340, 260))
    corners, ids = PA.detect_markers(view, pd)
    assert len(ids) >= 5
    pts, pids = PA.interpolate_corners_charuco(corners, ids, torch.from_numpy(view), board, k)
    wpts, wids = JA.interpolate_corners_charuco(corners, ids, view, jboard, k)
    assert np.array_equal(pids, wids) and len(pts) >= 8
    assert pts.dtype == np.float64 and np.abs(pts - wpts).max() <= 1e-3
    truth = JCal.project_points(board.chessboard_corners(), rvec, tvec, k, (0,) * 5)
    assert np.median(np.linalg.norm(pts - truth[pids], axis=1)) < 0.7
