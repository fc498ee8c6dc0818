"""The port's 3-D module, RGB-D odometry and stitching
(``rustcv_tpu_torch.ops.threed``, ``ops.odometry``, ``ops.stitch``) and
their ``imgproc`` names against ``rustcv_tpu`` on the same seeded inputs.

- The host float64 code is a copy (point-cloud and mesh I/O,
  ``depth_to_3d``, ``find_planes``, ``register_depth``, ``warp_frame``,
  ``rescale_depth``, the numpy rasterizer and normals, odometry, the host
  stitch composites): equal outputs.
- ``triangle_rasterize``'s tensor twin (chunks of triangles, a least-z
  reduction with the lower index first, merged with a strict ``<``)
  against JAX's ``lax.scan``: the covered pixels differ on at most 0.1 %
  (edge pixels where a weight rounds across 0: XLA contracts products
  into FMAs), depth within 1e-5 relative and colour within 1e-4 relative
  where both cover; also with chunks far smaller than the mesh.
- ``rgbd_normals``: rtol 1e-5 against JAX's twin and the float64 oracle
  (``tests/test_threed.py``).
- Odometry recovers a known motion within 2e-3 (``tests/test_odometry.py``).
- The stitch device composite on CPU tensors: within ±1 of JAX's device
  composite (XLA may contract ``w·img + acc`` into an FMA, so a sum on .5
  can round the other way); against the host composite, mean < 1.5 and
  99th percentile ≤ 4 (``tests/test_stitch.py``)."""

import numpy as np
import pytest
import torch

from rustcv_tpu import imgproc as jax_ip
from rustcv_tpu.core.mat import Mat as JMat
from rustcv_tpu.ops import calib as JCal
from rustcv_tpu.ops import odometry as JO
from rustcv_tpu.ops import stitch as JS
from rustcv_tpu.ops import threed as JT
from rustcv_tpu_torch import imgproc as port_ip
from rustcv_tpu_torch.core import Mat
from rustcv_tpu_torch.ops import odometry as PO
from rustcv_tpu_torch.ops import stitch as PS
from rustcv_tpu_torch.ops import threed as PT
from test_stitch import _scene
from test_torch_calib import _same

K = np.array([[75.0, 0, 40.0], [0, 75.0, 30.0], [0, 0, 1.0]])


def _planes_depth(h=60, w=80, seed=0):
    """A fronto-parallel wall (left) and a slanted floor (right), with noise."""
    rng = np.random.default_rng(seed)
    vs, us = np.mgrid[0:h, 0:w].astype(np.float64)
    z = np.where(us < w // 2, 2.0, 1.0 + 0.02 * vs)
    return (z + rng.normal(0, 0.002, z.shape)).astype(np.float32)


def _threed_cases(tmp):
    rng = np.random.default_rng(5)
    depth = _planes_depth()
    depth[5:9, 10:14] = 0.0
    pts = rng.uniform(-2, 2, (17, 3)).astype(np.float32)
    faces = rng.integers(0, 17, (9, 3))
    kr = np.array([[80.0, 0, 41], [0, 80.0, 31], [0, 0, 1.0]])
    rt = np.eye(4)
    rt[:3, :3] = JCal.rodrigues(np.array([0.01, -0.02, 0.005]))
    rt[:3, 3] = [0.05, -0.02, 0.01]
    image = rng.integers(0, 256, (60, 80, 3), np.uint8)
    verts = np.concatenate([rng.uniform(0, 64, (30, 2)), rng.uniform(0.2, 3, (30, 1))],
                           1).astype(np.float32)
    idx = rng.integers(0, 30, (40, 3)).astype(np.int32)
    cols = rng.uniform(0, 255, (30, 3)).astype(np.float32)

    def io(m, name):
        path = str(tmp / name)
        m.save_point_cloud(path, pts)
        return open(path).read(), m.load_point_cloud(path)

    def mesh(m):
        path = str(tmp / "mesh.ply")
        m.save_mesh(path, pts, faces)
        return open(path).read(), m.load_mesh(path)

    return {
        "point cloud ply": lambda m: io(m, "c.ply"),
        "point cloud obj": lambda m: io(m, "c.obj"),
        "mesh ply": mesh,
        "depth_to_3d": lambda m: m.depth_to_3d(depth, K),
        "depth_to_3d_sparse": lambda m: m.depth_to_3d_sparse(
            np.arange(24.0).reshape(12, 2), depth[0, :12], K),
        "find_planes": lambda m: m.find_planes(m.depth_to_3d(_planes_depth(seed=1), K),
                                               min_size=300, threshold=0.02),
        "register_depth": lambda m: m.register_depth(K, kr, rt, depth, (80, 60)),
        "register_depth dilate": lambda m: m.register_depth(K, kr, rt, depth, (80, 60),
                                                            dilate=True),
        "warp_frame": lambda m: m.warp_frame(depth, image, rt, K),
        "warp_frame no image": lambda m: m.warp_frame(depth, None, rt, K),
        "rescale_depth": lambda m: m.rescale_depth(depth * 1000, 0.001),
        "triangle_rasterize_numpy": lambda m: m.triangle_rasterize_numpy(verts, idx, cols, 64, 48),
        "rgbd_normals_numpy": lambda m: m.rgbd_normals_numpy(m.depth_to_3d(depth, K)),
    }


_THREED = sorted(_threed_cases(None))


@pytest.mark.parametrize("name", _THREED)
def test_threed_host_copy_equal(name, tmp_path):
    (tmp_path / "port").mkdir()
    (tmp_path / "ref").mkdir()
    _same(_threed_cases(tmp_path / "port")[name](PT), _threed_cases(tmp_path / "ref")[name](JT))


def _mesh(seed, n_tris, n_verts=None, w=64, h=48):
    rng = np.random.default_rng(seed)
    nv = n_verts or 3 * n_tris
    verts = np.concatenate([rng.uniform(-6, w + 6, (nv, 2)), rng.uniform(0.2, 3, (nv, 1))],
                           1).astype(np.float32)
    idx = (np.arange(3 * n_tris) if n_verts is None
           else rng.integers(0, nv, 3 * n_tris)).reshape(-1, 3).astype(np.int32)
    cols = rng.uniform(0, 255, (nv, 3)).astype(np.float32)
    return verts, idx, cols


def _raster_close(got, want):
    """Asserts the bars; returns how many pixels' cover differs."""
    (c, d), (wc, wd) = [tuple(np.asarray(a) for a in x) for x in (got, want)]
    assert c.shape == wc.shape and d.shape == wd.shape and c.dtype == d.dtype == np.float32
    cover, wcover = np.isfinite(d), np.isfinite(wd)
    mismatch = int((cover != wcover).sum())
    assert mismatch <= 0.001 * d.size, mismatch
    both = cover & wcover
    np.testing.assert_allclose(d[both], wd[both], rtol=1e-5, atol=0)
    np.testing.assert_allclose(c[both], wc[both], rtol=1e-4, atol=1e-4)
    assert (c[~cover] == 0).all()
    return mismatch


@pytest.mark.parametrize("chunk_px", [None, 7, 64])
@pytest.mark.parametrize("seed,n_tris,shared", [(0, 300, True), (1, 200, False), (2, 400, True)])
def test_triangle_rasterize_matches_jax(seed, n_tris, shared, chunk_px, monkeypatch, jax_cpu):
    """Several hundred triangles at 64×48; ``chunk_px`` triangles per chunk
    (None: the whole mesh in one chunk)."""
    jnp = jax_cpu.numpy
    if chunk_px is not None:
        monkeypatch.setattr(PT, "_CHUNK_ELEMS", 64 * 48 * chunk_px)
    verts, idx, cols = _mesh(seed, n_tris, 160 if shared else None)
    got = PT.triangle_rasterize(torch.from_numpy(verts), torch.from_numpy(idx),
                                torch.from_numpy(cols), 64, 48)
    assert all(t.device.type == "cpu" for t in got)
    mismatch = _raster_close(got, JT.triangle_rasterize(jnp.asarray(verts), jnp.asarray(idx),
                                                        jnp.asarray(cols), 64, 48))
    print(f"cover mismatch {mismatch} of {64 * 48} px")
    # the reference's own bar against the numpy oracle (cover within 3 %)
    _, d_np = JT.triangle_rasterize_numpy(verts, idx, cols, 64, 48)
    assert (np.isfinite(d_np) != np.isfinite(got[1].numpy())).mean() < 0.03


def test_triangle_rasterize_ties_keep_the_first_triangle(monkeypatch):
    """Two triangles at equal depth: the lower index wins, as the scan's
    strict ``<`` keeps it, also across chunks."""
    verts = np.array([[5, 5, 1], [55, 8, 1], [20, 40, 1], [6, 6, 1], [50, 9, 1], [22, 38, 1],
                      [10, 10, 0.5], [50, 12, 0.5], [25, 35, 0.5]], np.float32)
    idx = np.arange(9, dtype=np.int32).reshape(3, 3)
    cols = np.array([[255, 0, 0]] * 3 + [[0, 255, 0]] * 3 + [[0, 0, 255]] * 3, np.float32)
    for chunk in (1 << 26, 64 * 48):
        monkeypatch.setattr(PT, "_CHUNK_ELEMS", chunk)
        c, d = (t.numpy() for t in PT.triangle_rasterize(torch.from_numpy(verts), idx, cols, 64,
                                                          48))
        assert np.isfinite(d[8, 30]) and d[8, 30] == 1.0
        np.testing.assert_allclose(c[8, 30], [255, 0, 0], atol=1e-3)
        np.testing.assert_allclose(c[20, 30], [0, 0, 255], atol=1e-3)
        assert d[20, 30] == 0.5
        assert d[0, 0] == np.inf and (c[0, 0] == 0).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_rgbd_normals_matches_jax_and_oracle(seed, jax_cpu):
    pts = PT.depth_to_3d(_planes_depth(seed=seed), K)
    pts[10:14, 20:30] += np.random.default_rng(seed).normal(0, 0.05, (4, 10, 3)).astype(np.float32)
    got = PT.rgbd_normals(torch.from_numpy(pts))
    assert got.device.type == "cpu" and got.dtype == torch.float32
    want = np.asarray(JT.rgbd_normals(jax_cpu.numpy.asarray(pts)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), PT.rgbd_normals_numpy(pts), rtol=1e-5, atol=1e-5)


def test_imgproc_threed_names_are_the_port_functions():
    for name in ("depth_to_3d", "find_planes", "load_point_cloud", "depth_to_3d_sparse",
                 "load_mesh", "register_depth", "rescale_depth", "rgbd_normals", "save_mesh",
                 "save_point_cloud", "triangle_rasterize", "warp_frame"):
        assert getattr(port_ip, name) is getattr(PT, name)
    assert port_ip.rgbd_odometry is PO.rgbd_odometry


# -- odometry -----------------------------------------------------------------


def _render_depth(k, rvec, tvec, shape=(60, 80)):
    """Depth of three planes (two walls and a floor) seen from (rvec, tvec)."""
    h, w = shape
    vs, us = np.mgrid[0:h, 0:w].astype(np.float64)
    rays = np.stack([us, vs, np.ones_like(us)], -1) @ np.linalg.inv(k).T
    cam_rays = rays @ JCal.rodrigues(np.asarray(rvec, np.float64)).T
    origin = np.asarray(tvec, np.float64)
    depth = np.full((h, w), np.inf)
    for n, d in ((np.array([0.0, 0, -1]), -3.0), (np.array([-1.0, 0, -0.2]), -2.0),
                 (np.array([0.0, -1, -0.1]), -1.2)):
        denom = cam_rays @ n
        tt = (d - origin @ n) / np.where(np.abs(denom) > 1e-9, denom, 1e-9)
        hit = (tt > 0.1) & (np.abs(denom) > 1e-9)
        depth = np.where(hit & (tt < depth), tt, depth)
    return np.where(np.isinf(depth), 0.0, depth)


def test_odometry_recovers_motion_equal():
    d0 = _render_depth(K, (0, 0, 0), (0, 0, 0))
    rv_true, tv_true = np.array([0.01, -0.02, 0.005]), np.array([0.01, 0.005, -0.02])
    r = JCal.rodrigues(rv_true)
    d1 = _render_depth(K, JCal.rodrigues(r.T), -r.T @ tv_true)
    got = PO.rgbd_odometry(d0, d1, K, levels=2, iters=15)
    _same(got, JO.rgbd_odometry(d0, d1, K, levels=2, iters=15))
    ok, rv, tv = got
    assert ok
    np.testing.assert_allclose(rv, rv_true, atol=2e-3)
    np.testing.assert_allclose(tv, tv_true, atol=2e-3)


def test_odometry_identity_equal():
    d0 = _render_depth(K, (0, 0, 0), (0, 0, 0))
    got = PO.rgbd_odometry(d0, d0, K, levels=2, iters=5)
    _same(got, JO.rgbd_odometry(d0, d0, K, levels=2, iters=5))
    assert got[0] and np.abs(got[1]).max() < 1e-6 and np.abs(got[2]).max() < 1e-6


# -- stitching ----------------------------------------------------------------


def _pair(color=False):
    wide = _scene(shape=(140, 300))
    if color:
        wide = np.stack([wide, 255 - wide, wide // 2], axis=-1)
    return wide[10:130, 0:170].copy(), wide[10:130, 110:300].copy()


@pytest.fixture(scope="module")
def host_gray():
    left, right = _pair()
    got = PS.stitch([left, right], return_offset=True)
    want = JS.stitch([left, right], return_offset=True)
    return got, want


def test_stitch_host_composite_equal(host_gray):
    got, want = host_gray
    _same(got, want)


def _composite_close(got, want, host):
    assert got.shape == want.shape == host.shape and got.dtype == np.uint8
    d = np.abs(got.astype(int) - want)
    print(f"device composite: {int((d > 0).sum())} of {d.size} values differ from JAX's "
          f"(max {int(d.max())})")
    assert d.max() <= 1
    diff = np.abs(got.astype(int) - host)
    assert diff.mean() < 1.5 and np.percentile(diff, 99) <= 4


@pytest.mark.parametrize("color", [False, True])
def test_stitch_device_composite_matches_jax(color, host_gray, jax_cpu):
    jnp = jax_cpu.numpy
    left, right = _pair(color)
    got = PS.stitch([torch.from_numpy(left), torch.from_numpy(right)])
    want = JS.stitch([jnp.asarray(left), jnp.asarray(right)])
    host = host_gray[1][0] if not color else JS.stitch([left, right])
    assert isinstance(got, np.ndarray)
    _composite_close(got, want, host)


def test_stitch_multiband_equal():
    left, right = _pair(color=True)
    _same(PS.stitch([left, right], blend="multiband"), JS.stitch([left, right], blend="multiband"))


def test_stitch_failures_raise():
    with pytest.raises(ValueError):
        PS.stitch([_scene(shape=(64, 64))])
    a, b = _scene(seed=1, shape=(100, 100)), _scene(seed=2, shape=(100, 100))
    with pytest.raises(PS.StitchError):
        PS.stitch([a, b])


def test_imgproc_stitch_images(host_gray, jax_cpu):
    """Host Mats take the host composite (equal to the reference's); device
    Mats the device composite (within ±1 of the reference's on JAX Mats);
    both return a host Mat."""
    left, right = _pair()
    host = port_ip.stitch_images([Mat.from_array(left, device="cpu"),
                                  Mat.from_array(right, device="cpu")])
    assert not host.is_on_device and np.array_equal(host.to_numpy()[..., 0], host_gray[1][0])
    dev = port_ip.stitch_images([Mat.from_device(torch.from_numpy(left)),
                                 Mat.from_device(torch.from_numpy(right))])
    jl, jr = JMat.from_array(left), JMat.from_array(right)
    jl.device(), jr.device()
    ref = jax_ip.stitch_images([jl, jr])
    assert not dev.is_on_device
    _composite_close(dev.to_numpy()[..., 0], ref.to_numpy()[..., 0], host_gray[1][0])
