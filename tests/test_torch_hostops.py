"""The port's copies of the reference's host (numpy) modules
(``rustcv_tpu_torch.ops``: ``barcode``, ``draw_cv``, ``emd``, ``epipolar``,
``geometry``, ``knn_index``, ``octree``, ``resize_cv``, ``shape``,
``subdiv``, ``tsdf``) and the host functions of ``ops.core_ops``, against
the reference's modules on the same seeded inputs: one case per public
function (a class's case drives its methods).

Tolerance: exact. The same float64 numpy code runs on both sides, so
every output is equal value for value, ``RNG``'s stream included."""

import importlib

import numpy as np
import pytest

rng = np.random.default_rng


def _pts(n, seed, scale=50.0):
    return rng(seed).uniform(0, scale, (n, 2))


def _contour(seed):
    t = np.sort(rng(seed).uniform(0, 2 * np.pi, 14))
    r = rng(seed + 1).uniform(10, 20, 14)
    return np.stack([30 + r * np.cos(t), 30 + r * np.sin(t)], 1).round().astype(np.int32)


def _matches(seed, n=40):
    """Correspondences through a known homography, with outliers."""
    src = _pts(n, seed, 100.0)
    h = np.array([[1.05, 0.02, 3.0], [-0.03, 0.97, -2.0], [1e-4, 2e-4, 1.0]])
    p = np.concatenate([src, np.ones((n, 1))], 1) @ h.T
    dst = p[:, :2] / p[:, 2:]
    dst[::7] += rng(seed + 1).uniform(-20, 20, dst[::7].shape)
    return src, dst


def _stereo(seed, n=30):
    """Two views of seeded 3-D points: (pts1, pts2, K, P1, P2)."""
    x = np.concatenate([rng(seed).uniform(-1, 1, (n, 2)), rng(seed + 1).uniform(4, 8, (n, 1))], 1)
    k = np.array([[400.0, 0, 160], [0, 400.0, 120], [0, 0, 1]])
    a = 0.1
    r = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
    t = np.array([[-0.5], [0.05], [0.02]])
    p1 = k @ np.hstack([np.eye(3), np.zeros((3, 1))])
    p2 = k @ np.hstack([r, t])
    h = np.concatenate([x, np.ones((n, 1))], 1)
    u1, u2 = h @ p1.T, h @ p2.T
    return u1[:, :2] / u1[:, 2:], u2[:, :2] / u2[:, 2:], k, p1, p2


def _fundamental(M):
    a, b, _, _, _ = _stereo(3)
    return M.fit_fundamental_8point(a, b)


def _tsdf(M):
    vol = M.TsdfVolume(resolution=16, voxel_size=0.05, origin=(-0.4, -0.4, 0.2))
    k = np.array([[40.0, 0, 16], [0, 40.0, 12], [0, 0, 1]])
    depth = np.full((24, 32), 0.6) + 0.01 * rng(4).random((24, 32))
    vol.integrate(depth, k, np.eye(3), np.zeros(3))
    return vol.tsdf, vol.weight, vol.raycast(k, np.eye(3), np.zeros(3), (24, 32)), vol.extract_cloud()


def _octree(M):
    pts = rng(5).uniform(-0.99, 0.99, (60, 3))
    tree = M.Octree(pts[:40], max_points=4, origin=(-1.0, -1.0, -1.0), size=2.0)
    for p in pts[40:]:
        tree.insert_point(p)
    deleted = tree.delete_point(pts[3])
    return (deleted, tree.is_point_in_bounds([0.2, 0.3, -0.1]), tree.radius_neighbours([0, 0, 0], 0.5),
            tree.k_nearest_neighbours([0.1, -0.2, 0.3], 5))


def _knn(M):
    idx = M.KnnIndex(rng(6).uniform(0, 1, (80, 4)), leaf_size=8)
    q = rng(7).uniform(0, 1, (5, 4))
    return idx.knn_search(q, k=3), M.radius_search(idx, q[:1], 0.2)


def _subdiv(M):
    s = M.Subdiv2D((0, 0, 100, 100))
    s.insert_multiple(_pts(20, 8, 90.0) + 5)
    s.insert((50.0, 50.0))
    return s.get_triangle_list(), s.find_nearest((40.0, 61.0)), s.get_voronoi_facet_list()


def _barcode_roundtrip(M):
    bits = M.encode_ean13("400638133393")
    img = M.draw_barcode(bits)
    return bits, img, M.detect_and_decode(img)


HOST = {  # (module, case) → call(module)
    ("barcode", "ean13_checksum"): lambda M: M.ean13_checksum("590123412345"),
    ("barcode", "encode_ean13"): lambda M: M.encode_ean13("400638133393"),
    ("barcode", "draw_barcode"): lambda M: M.draw_barcode(M.encode_ean13("978020137962"), 2, 40),
    ("barcode", "decode_ean13_scanline"): lambda M: M.decode_ean13_scanline(
        M.draw_barcode(M.encode_ean13("978020137962"))[20]),
    ("barcode", "detect_and_decode"): _barcode_roundtrip,
    ("draw_cv", "clip_line"): lambda M: [M.clip_line((40, 30), p, q) for p, q in
                                         (((-5, 3), (50, 20)), ((3, 4), (9, 9)), ((-9, -9), (-1, -3)))],
    ("draw_cv", "line_thin"): lambda M: [M.line_thin(np.zeros((20, 30, 3), np.uint8), (2, 3), (27, 15),
                                                     (10, 200, 30), c) for c in (4, 8)],
    # integer weights: with float weights whose totals differ in the last
    # bits, the reference's augmenting loop does not end (ROADMAP Queue 3)
    ("emd", "emd"): lambda M: M.emd(np.concatenate([rng(9).integers(1, 5, (6, 1)), _pts(6, 10)], 1),
                                    np.concatenate([rng(11).integers(1, 5, (5, 1)), _pts(5, 12)],
                                                   1), "l2", None, True),
    ("emd", "emd_l1"): lambda M: M.emd(np.concatenate([np.ones((4, 1)), _pts(4, 13)], 1),
                                       np.concatenate([np.ones((4, 1)), _pts(4, 14)], 1), "l1"),
    ("epipolar", "fit_fundamental_8point"): _fundamental,
    ("epipolar", "sampson_distance"): lambda M: M.sampson_distance(_fundamental(M), *_stereo(4)[:2]),
    ("epipolar", "find_fundamental_mat"): lambda M: M.find_fundamental_mat(*_stereo(5)[:2]),
    ("epipolar", "find_fundamental_mat_8point"): lambda M: M.find_fundamental_mat(
        *_stereo(5)[:2], method="8point"),
    ("epipolar", "compute_correspond_epilines"): lambda M: M.compute_correspond_epilines(
        _stereo(6)[0], 1, _fundamental(M)),
    ("epipolar", "find_essential_mat"): lambda M: M.find_essential_mat(*_stereo(7)[:3]),
    ("epipolar", "decompose_essential_mat"): lambda M: M.decompose_essential_mat(
        M.find_essential_mat(*_stereo(8)[:3])[0]),
    ("epipolar", "recover_pose"): lambda M: M.recover_pose(
        M.find_essential_mat(*_stereo(9)[:3])[0], *_stereo(9)[:3]),
    ("epipolar", "correct_matches"): lambda M: M.correct_matches(_fundamental(M), *_stereo(10)[:2]),
    ("epipolar", "triangulate_points"): lambda M: M.triangulate_points(
        _stereo(11)[3], _stereo(11)[4], *_stereo(11)[:2]),
    ("geometry", "estimate_affine_partial_2d"): lambda M: M.estimate_affine_partial_2d(*_matches(12)),
    ("geometry", "estimate_affine_2d"): lambda M: M.estimate_affine_2d(*_matches(13)),
    ("geometry", "find_homography"): lambda M: M.find_homography(*_matches(14)),
    ("knn_index", "KnnIndex"): _knn,
    ("knn_index", "radius_search"): lambda M: M.radius_search(
        M.KnnIndex(_pts(30, 15)), _pts(1, 16), 200.0, 8),
    ("octree", "Octree"): _octree,
    ("resize_cv", "resize_cv_u8"): lambda M: [
        M.resize_cv_u8(rng(17).integers(0, 256, (23, 35, 3), dtype=np.uint8), w, h, i)
        for w, h, i in ((17, 12, 1), (50, 31, 0), (12, 9, 3), (40, 40, 2), (11, 7, 3))],
    ("subdiv", "Subdiv2D"): _subdiv,
    ("tsdf", "TsdfVolume"): _tsdf,
    ("shape", "contour_area"): lambda M: (M.contour_area(_contour(18)),
                                          M.contour_area(_contour(18), True)),
    ("shape", "arc_length"): lambda M: (M.arc_length(_contour(19)), M.arc_length(_contour(19), False)),
    ("shape", "bounding_rect"): lambda M: M.bounding_rect(_contour(20)),
    ("shape", "convex_hull"): lambda M: (M.convex_hull(_contour(21)), M.convex_hull(_contour(21), True)),
    ("shape", "convex_hull_cv_indices"): lambda M: M.convex_hull_cv_indices(_contour(22)),
    ("shape", "convex_hull_cv"): lambda M: M.convex_hull_cv(_contour(23), True),
    ("shape", "min_area_rect"): lambda M: M.min_area_rect(_contour(24)),
    ("shape", "approx_poly_dp"): lambda M: (M.approx_poly_dp(_contour(25), 2.0),
                                            M.approx_poly_dp(_contour(25), 3.5, False)),
    ("shape", "min_enclosing_circle"): lambda M: M.min_enclosing_circle(_contour(26)),
    ("shape", "fit_line"): lambda M: (M.fit_line(_pts(20, 27)), M.fit_line(_pts(20, 27), "huber")),
    ("shape", "fit_ellipse"): lambda M: M.fit_ellipse(_contour(28)),
    ("shape", "convex_hull_indices"): lambda M: M.convex_hull_indices(_contour(29)),
    ("shape", "point_polygon_test"): lambda M: [M.point_polygon_test(_contour(30), p, d)
                                                for p in ((30, 30), (2, 2), (45, 30)) for d in (0, 1)],
    ("shape", "is_contour_convex"): lambda M: (M.is_contour_convex(_contour(31)),
                                               M.is_contour_convex(M.convex_hull(_contour(31)))),
    ("shape", "convexity_defects"): lambda M: M.convexity_defects(
        _contour(32), M.convex_hull_indices(_contour(32))),
    ("shape", "box_points"): lambda M: M.box_points(((10.0, 20.0), (8.0, 4.0), 30.0)),
    ("shape", "intersect_convex_convex"): lambda M: M.intersect_convex_convex(
        M.convex_hull(_contour(33)), M.convex_hull(_contour(34)) + 5),
    ("shape", "rotated_rectangle_intersection"): lambda M: M.rotated_rectangle_intersection(
        ((10.0, 10.0), (8.0, 6.0), 20.0), ((12.0, 11.0), (7.0, 9.0), -35.0)),
    ("shape", "fit_ellipse_direct"): lambda M: M.fit_ellipse_direct(_contour(35)),
    ("shape", "fit_ellipse_ams"): lambda M: M.fit_ellipse_ams(_contour(36)),
    ("shape", "approx_poly_n"): lambda M: M.approx_poly_n(M.convex_hull(_contour(37)), 4),
    ("shape", "min_enclosing_triangle"): lambda M: M.min_enclosing_triangle(_contour(38)[::2]),
    ("shape", "min_enclosing_convex_polygon"): lambda M: M.min_enclosing_convex_polygon(
        _contour(39), 5),
}


def _rng_stream(M):
    r = M.RNG(1234)
    out = [r.next() for _ in range(5)]
    out += [r.uniform_int(-7, 90) for _ in range(5)] + [r.uniform_float(-2.0, 3.0) for _ in range(5)]
    return (out, r.randu((4, 6), 0, 256, np.uint8), r.randu((3, 5), -1.5, 2.5),
            r.gaussian(2.0), r.randn((3, 4), 1.0, 0.5), M.RNG(0).next(), r.state)


_A = rng(40).normal(size=(4, 4))
_S = _A @ _A.T + 4 * np.eye(4)
_CMP_HIST = (rng(41).uniform(0, 1, 32), rng(42).uniform(0, 1, 32))

CORE = {  # case → call(core_ops module)
    "RNG": _rng_stream,
    "rand_shuffle": lambda M: M.rand_shuffle(np.arange(20), M.RNG(99)),
    "find_non_zero": lambda M: M.find_non_zero(rng(43).integers(0, 3, (7, 9))),
    "transform_points": lambda M: (M.transform_points(_pts(6, 44), _A[:2, :2]),
                                   M.transform_points(_pts(6, 44), _A[:2, :3])),
    "perspective_transform": lambda M: M.perspective_transform(_pts(6, 45), _S[:3, :3]),
    "get_affine_transform": lambda M: M.get_affine_transform(_pts(3, 46), _pts(3, 47)),
    "set_identity": lambda M: M.set_identity((3, 4), 2.5),
    "scale_add": lambda M: M.scale_add(_A, 0.5, _S),
    "determinant": lambda M: M.determinant(_A),
    "invert": lambda M: (M.invert(_A), M.invert(_A, "svd"), M.invert(np.zeros((2, 2)))),
    "solve": lambda M: (M.solve(_A, _S[:, 0]), M.solve(_A[:, :3], _S[:, :2], "svd")),
    "eigen": lambda M: M.eigen(_S),
    "sv_decomp": lambda M: M.sv_decomp(_A[:, :3]),
    "sv_back_subst": lambda M: M.sv_back_subst(*M.sv_decomp(_A), _S[:, 1]),
    "calc_covar_matrix": lambda M: (M.calc_covar_matrix(_pts(9, 48)),
                                    M.calc_covar_matrix(_pts(9, 48), False, True, True)),
    "mahalanobis": lambda M: M.mahalanobis(_S[0], _S[1], np.linalg.inv(_S)),
    "pca_compute": lambda M: (M.pca_compute(rng(49).normal(size=(12, 4))),
                              M.pca_compute(rng(49).normal(size=(12, 4)), None, 2)),
    "pca_project": lambda M: M.pca_project(_A, _S[0], _S[:2]),
    "pca_back_project": lambda M: M.pca_back_project(_A[:, :2], _S[0], _S[:2]),
    "compare_hist": lambda M: [M.compare_hist(*_CMP_HIST, m) for m in
                               ("correl", "chisqr", "intersect", "bhattacharyya", "chisqr_alt",
                                "kl_div")],
    "create_hanning_window": lambda M: M.create_hanning_window((7, 5)),
    "convert_points_to_homogeneous": lambda M: M.convert_points_to_homogeneous(_pts(4, 50)),
    "convert_points_from_homogeneous": lambda M: M.convert_points_from_homogeneous(_S[:, :3]),
    "complete_symm": lambda M: (M.complete_symm(_A), M.complete_symm(_A, True)),
    "invert_affine_transform": lambda M: M.invert_affine_transform(_A[:2, :3]),
    "solve_cubic": lambda M: [M.solve_cubic(c) for c in ([1, -6, 11, -6], [0, 1, -3, 2],
                                                         [1, 0, 0, 1])],
    "solve_poly": lambda M: M.solve_poly([6, -5, -2, 1]),
    "trace": lambda M: M.trace(_A),
    "mul_transposed": lambda M: (M.mul_transposed(_A[:, :3]), M.mul_transposed(_A, False, 0.5)),
    "sum_elems": lambda M: (M.sum_elems(_A), M.sum_elems(rng(51).integers(0, 9, (3, 4, 3)))),
    "batch_distance": lambda M: [M.batch_distance(q, t, 3, n) for n, q, t in (
        ("l2", _pts(5, 52), _pts(9, 53)), ("l1", _pts(5, 54), _pts(9, 55)),
        ("hamming", rng(56).integers(0, 256, (4, 8), dtype=np.uint8),
         rng(57).integers(0, 256, (6, 8), dtype=np.uint8)))],
    "eigen_non_symmetric": lambda M: M.eigen_non_symmetric(_S + np.triu(_S)),
    "mat_mul_deriv": lambda M: M.mat_mul_deriv(_A[:2, :3], _S[:3, :2]),
    "integral2": lambda M: M.integral2(rng(58).integers(0, 256, (6, 9))),
    "integral3": lambda M: M.integral3(rng(59).integers(0, 256, (6, 9))),
    "color_correction_matrix": lambda M: (M.color_correction_matrix(_S[:, :3], _A[:, :3]),
                                          M.color_correction_matrix(_S[:, :3], _A[:, :3], False)),
    "apply_ccm": lambda M: (M.apply_ccm(rng(60).integers(0, 256, (4, 5, 3), dtype=np.uint8),
                                        np.eye(3, 4) * 0.9),
                            M.apply_ccm(rng(61).uniform(0, 1, (4, 5, 3)), np.eye(3) * 1.1)),
    "solve_lp": lambda M: [M.solve_lp(c, a) for c, a in (
        ([3, 2], [[1, 1, 4], [1, 3, 6]]), ([1, 1], [[-1, 0, -1], [0, 1, 2], [1, 1, 8]]),
        ([1, 1], [[1, -1, 1]]), ([1, 0], [[1, 0, -1], [-1, 0, -2]]))],
    "border_interpolate": lambda M: [M.border_interpolate(p, 5, b) for p in (-7, -1, 2, 5, 12)
                                     for b in ("constant", "replicate", "wrap", "reflect",
                                               "reflect101")],
    "rectangle_intersection_area": lambda M: M.rectangle_intersection_area((0, 0, 4.5, 3),
                                                                           (2, 1, 5, 5)),
    "build_mst": lambda M: (M.build_mst(5, [[0, 1, 3], [1, 2, 1], [2, 3, 4], [3, 4, 2], [0, 4, 9],
                                            [1, 3, 2.5], [2, 2, 0]]), M.build_mst(3, [[0, 1, 1]])),
    "get_rect_sub_pix": lambda M: (M.get_rect_sub_pix(rng(62).integers(0, 256, (9, 11, 3),
                                                                       dtype=np.uint8),
                                                      (5, 4), (4.3, 6.8)),
                                   M.get_rect_sub_pix(rng(63).uniform(0, 1, (9, 11)), (6, 6),
                                                      (0.2, 8.9))),
    "check_range": lambda M: (M.check_range(_A), M.check_range(_A, -0.5, 0.5),
                              M.check_range(np.array([1.0, np.nan]))),
}


def _equal(got, want):
    if isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _equal(got[k], want[k])
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, (type(got), got.dtype)
        np.testing.assert_array_equal(got, want)
    else:
        assert type(got) is type(want) and (got == want or (got != got and want != want)), (got, want)


@pytest.mark.parametrize("case", sorted(HOST), ids=lambda c: ".".join(c))
def test_host_module_case_equals_the_references(case):
    mod, _ = case
    port = importlib.import_module(f"rustcv_tpu_torch.ops.{mod}")
    ref = importlib.import_module(f"rustcv_tpu.ops.{mod}")
    _equal(HOST[case](port), HOST[case](ref))


@pytest.mark.parametrize("case", sorted(CORE))
def test_core_ops_host_case_equals_the_references(case):
    from rustcv_tpu.ops import core_ops as J
    from rustcv_tpu_torch.ops import core_ops as P

    _equal(CORE[case](P), CORE[case](J))


def test_every_public_function_has_a_case():
    import ast
    from pathlib import Path

    root = Path(__file__).resolve().parents[1] / "rustcv_tpu" / "ops"
    covered = {name for _, name in HOST}
    for mod in sorted({m for m, _ in HOST}):
        tree = ast.parse((root / f"{mod}.py").read_text())
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.ClassDef)) and not node.name.startswith("_"):
                assert node.name in covered, (mod, node.name)


def test_detect_barcodes_decodes_an_encoded_ean13():
    from rustcv_tpu_torch import imgproc
    from rustcv_tpu_torch.ops import barcode

    img = barcode.draw_barcode(imgproc.encode_ean13("400638133393"))
    assert imgproc.detect_barcodes(img) == ["4006381333931"]


def test_rng_streams_value_for_value():
    from rustcv_tpu.ops import core_ops as J
    from rustcv_tpu_torch.ops import core_ops as P

    a, b = P.RNG(0xDEADBEEF), J.RNG(0xDEADBEEF)
    assert [a.next() for _ in range(1000)] == [b.next() for _ in range(1000)]
    np.testing.assert_array_equal(a.randu((50, 40), -100, 100, np.int32),
                                  b.randu((50, 40), -100, 100, np.int32))


# -- the block's other imgproc names, four ways (the port's host and device
#    Mats against the reference's host and device Mats) ---------------------


def _mats(img):
    import jax.numpy as jnp
    import torch

    import rustcv_tpu.core as jax_core
    from rustcv_tpu_torch.core import Mat

    port = (Mat.from_array(img.copy(), device="cpu"), Mat.from_device(torch.from_numpy(img.copy())))
    ref = (jax_core.Mat.from_array(img.copy()), jax_core.Mat.from_device(jnp.asarray(img)))
    return port, ref


def _draw(ip, m, fn):
    fn(ip, m)
    return m


_CONTOURS = [_contour(64), _contour(65)[:5]]
_CORNERS = np.stack(np.meshgrid(np.arange(4) * 6 + 5.2, np.arange(3) * 7 + 4.7), -1).reshape(-1, 2)
MAT_CALLS = {
    "flip_0": lambda ip, m: ip.flip(m, 0),
    "flip_1": lambda ip, m: ip.flip(m, 1),
    "flip_both": lambda ip, m: ip.flip(m, -1),
    "draw_contours": lambda ip, m: _draw(ip, m, lambda ip, m: ip.draw_contours(
        m, _CONTOURS, -1, ip.Scalar(10, 200, 30), 2)),
    "draw_contours_filled": lambda ip, m: _draw(ip, m, lambda ip, m: ip.draw_contours(
        m, _CONTOURS, 0, ip.Scalar(250, 20, 90), -1)),
    "draw_chessboard_corners": lambda ip, m: _draw(ip, m, lambda ip, m: ip.draw_chessboard_corners(
        m, (4, 3), _CORNERS, True)),
    "draw_chessboard_corners_not_found": lambda ip, m: _draw(
        ip, m, lambda ip, m: ip.draw_chessboard_corners(m, (4, 3), _CORNERS, False)),
    "hu_moments": lambda ip, m: ip.hu_moments(m),
    "match_shapes": lambda ip, m: np.array(ip.match_shapes(m, ip.flip(m, 1))),
}


@pytest.mark.parametrize("name", list(MAT_CALLS))
def test_block_mat_names_four_ways(name):
    call = MAT_CALLS[name]
    img = rng(66).integers(0, 256, (31, 45, 3), dtype=np.uint8)
    if name in ("hu_moments", "match_shapes"):
        img = np.zeros((31, 45, 1), np.uint8)
        img[5:20, 8:30] = 255
        img[12:26, 20:24] = 255
    import rustcv_tpu.imgproc as jax_ip
    from rustcv_tpu_torch import imgproc as port_ip

    (p_host, p_dev), (r_host, r_dev) = _mats(img)
    for port, ref in ((p_host, r_host), (p_dev, r_dev)):
        got, want = call(port_ip, port), call(jax_ip, ref)
        if hasattr(got, "to_numpy"):
            assert got.is_on_device == port.is_on_device
            got, want = got.to_numpy(), want.to_numpy()
        _equal(got, np.asarray(want))


def test_block_host_names_equal_the_references():
    import rustcv_tpu.imgproc as jax_ip
    from rustcv_tpu_torch import imgproc as port_ip

    for args in ((7, 2.0, 0.3, 5.0, 0.5), ((9, 5), 1.5, 1.2, 4.0, 0.8, 0.0), (0, 2.0, 0.7, 6.0, 1.0)):
        _equal(port_ip.get_gabor_kernel(*args), jax_ip.get_gabor_kernel(*args))
    y = rng(67).integers(0, 256, (8, 12), dtype=np.uint8)
    for uv in (rng(68).integers(0, 256, (4, 6, 2), dtype=np.uint8),
               rng(69).integers(0, 256, (4, 12), dtype=np.uint8)):
        _equal(port_ip.cvt_color_two_plane(y, uv), jax_ip.cvt_color_two_plane(y, uv))
    for name in ("estimate_affine_2d", "estimate_affine_partial_2d"):
        _equal(getattr(port_ip, name)(*_matches(70), iters=50),
               getattr(jax_ip, name)(*_matches(70), iters=50))


# --- emd: the repaired augmenting loop (ROADMAP Queue 3) --------------------


def _queue3_signatures(dtype, normalized):
    """ROADMAP Queue 3's input: 6 and 5 weighted 2-D points; with the
    weights divided by their sums the two totals differ in the last bits."""
    w1, w2 = rng(9).uniform(0, 1, (6, 1)), rng(11).uniform(0, 1, (5, 1))
    if normalized:
        w1, w2 = w1 / w1.sum(), w2 / w2.sum()
    return (np.concatenate([w1, _pts(6, 10)], 1).astype(dtype),
            np.concatenate([w2, _pts(5, 12)], 1).astype(dtype))


def _transport_optimum(s1, s2, dist="l2"):
    """The same unbalanced transport problem as a linear program:
    min Σ c·f over f ≥ 0 with row sums ≤ w1, column sums ≤ w2 and
    Σ f = min(Σw1, Σw2); EMD = optimum / total."""
    from scipy.optimize import linprog

    a, b = np.asarray(s1, np.float64), np.asarray(s2, np.float64)
    w1, w2 = a[:, 0], b[:, 0]
    d = a[:, None, 1:] - b[None, :, 1:]
    cost = {"l1": np.abs(d).sum(-1), "l2": np.sqrt((d * d).sum(-1)), "l2sq": (d * d).sum(-1)}[dist]
    n1, n2 = len(w1), len(w2)
    rows = np.kron(np.eye(n1), np.ones(n2))
    cols = np.kron(np.ones(n1), np.eye(n2))
    total = min(w1.sum(), w2.sum())
    res = linprog(cost.ravel(), A_ub=np.vstack([rows, cols]), b_ub=np.concatenate([w1, w2]),
                  A_eq=np.ones((1, n1 * n2)), b_eq=[total], method="highs")
    assert res.status == 0
    return res.fun / total


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("normalized", [False, True])
def test_emd_ends_on_float_weights_at_the_transport_optimum(dtype, normalized):
    """Queue 3's input used to loop forever: two nodes whose distances
    differ by less than an ulp kept relaxing each other's arcs, leaving a
    cycle in the path tree. Each node now settles once, labels move only by
    a relative slack, and a path walk longer than the graph raises. The
    result must come within 5 s and equal linprog's optimum to 1e-9
    relative."""
    import signal
    import time

    from rustcv_tpu_torch.ops.emd import emd

    s1, s2 = _queue3_signatures(dtype, normalized)

    def _timeout(*_):
        raise TimeoutError("emd did not end within 5 s")

    old = signal.signal(signal.SIGALRM, _timeout)
    signal.alarm(5)
    try:
        t0 = time.perf_counter()
        got, flow = emd(s1, s2, return_flow=True)
        assert time.perf_counter() - t0 < 5.0
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)
    want = _transport_optimum(s1, s2)
    assert abs(got - want) <= 1e-9 * abs(want)
    total = min(float(s1[:, 0].astype(np.float64).sum()), float(s2[:, 0].astype(np.float64).sum()))
    assert abs(flow.sum() - total) <= 1e-9 * total and (flow >= -1e-12).all()


# Integer-weight cases on which the reference's loop does not end either
# (its copy of the fault: near-equal distances of float coordinates).
REFERENCE_DOES_NOT_END = {(1, "l2"), (1, "l2sq"), (2, "l1"), (2, "l2"), (3, "l2sq")}


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("dist", ["l1", "l2", "l2sq"])
def test_emd_integer_weights_match_linprog_and_the_reference(seed, dist):
    """Every case equals linprog's optimum to 1e-9 relative; where the
    reference ends, the port's result and flow equal its own."""
    import signal

    from rustcv_tpu_torch.ops.emd import emd

    n1, n2 = 3 + seed, 7 - seed % 3
    s1 = np.concatenate([rng(seed).integers(1, 6, (n1, 1)), _pts(n1, seed + 20)], 1)
    s2 = np.concatenate([rng(seed + 40).integers(1, 6, (n2, 1)), _pts(n2, seed + 60)], 1)

    def _timeout(*_):
        raise TimeoutError("emd did not end within 5 s")

    old = signal.signal(signal.SIGALRM, _timeout)
    signal.alarm(5)
    try:
        got, flow = emd(s1, s2, dist, None, True)
        if (seed, dist) not in REFERENCE_DOES_NOT_END:
            from rustcv_tpu.ops.emd import emd as ref_emd

            want, want_flow = ref_emd(s1, s2, dist, None, True)
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)
    opt = _transport_optimum(s1, s2, dist)
    assert abs(got - opt) <= 1e-9 * abs(opt)
    if (seed, dist) not in REFERENCE_DOES_NOT_END:
        assert got == pytest.approx(want, rel=1e-12, abs=1e-12)
        np.testing.assert_allclose(flow, want_flow, atol=1e-9)
