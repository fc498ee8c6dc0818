"""The port's Hough transforms (``rustcv_tpu_torch.ops.hough`` and
``ghough``) and stereo matchers (``stereo``, ``sgbm``) with their
``imgproc`` names, against ``rustcv_tpu`` (JAX on the CPU) and its numpy
oracles on the same seeded inputs.

Tolerances, the reference's own (``tests/test_hough.py``,
``test_hough_circles.py``, ``test_ghough.py``, ``test_stereo.py``,
``test_sgbm.py``):
- exact: Hough lines (values, flags and votes), circles (centres, radii,
  flags, votes), segments, the generalized Hough accumulators, peaks and
  the rotation/scale variant;
- ``stereo_bm``: ``valid`` equal, disparity within 1e-4;
- ``stereo_sgbm``: ``valid`` and ``floor(disp + 0.5)`` equal, disparity
  within 1e-3."""

import numpy as np
import pytest
import torch

from rustcv_tpu import imgproc as jax_ip
from rustcv_tpu.core.mat import Mat as JMat
from rustcv_tpu.ops import ghough as JG
from rustcv_tpu.ops import golden as G
from rustcv_tpu.ops import hough as JH
from rustcv_tpu.ops import sgbm as JS
from rustcv_tpu.ops import stereo as JB
from rustcv_tpu_torch import imgproc as port_ip
from rustcv_tpu_torch.core import Mat
from rustcv_tpu_torch.ops import ghough as PG
from rustcv_tpu_torch.ops import hough as PH
from rustcv_tpu_torch.ops import sgbm as PS
from rustcv_tpu_torch.ops import stereo as PB


def _line_mask(h, w, segments):
    m = np.zeros((h, w), np.uint8)
    for (y0, x0, y1, x1) in segments:
        n = max(abs(y1 - y0), abs(x1 - x0)) + 1
        ys = np.linspace(y0, y1, n).round().astype(int)
        xs = np.linspace(x0, x1, n).round().astype(int)
        m[ys, xs] = 255
    return m


def _edges(seed, h, w):
    """Three long segments across the frame (one from each edge pair, moved
    by the seed) and 1 % seeded noise."""
    rng = np.random.default_rng(seed)
    a, b = (int(v) for v in rng.integers(0, h // 4, 2))
    segs = [(a, 0, h - 1 - b, w - 1), (h - 1 - a, 0, b, w - 1),
            (h // 2 + a // 2, 0, h // 2 + a // 2, w - 1)]
    noise = (rng.random((h, w)) > 0.99).astype(np.uint8) * 255
    return np.maximum(_line_mask(h, w, segs), noise)


def _circles_scene(seed, h, w, n=3):
    rng = np.random.default_rng(seed)
    img = np.full((h, w), 30, np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    for _ in range(n):
        cy, cx, r = rng.integers(20, h - 20), rng.integers(20, w - 20), rng.integers(12, 30)
        img[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = 200
    return np.clip(img.astype(int) + rng.integers(-10, 10, (h, w)), 0, 255).astype(np.uint8)


def _np(x):
    return np.asarray(x) if not isinstance(x, torch.Tensor) else x.numpy()


@pytest.mark.parametrize("seed,shape", [(0, (100, 140)), (1, (240, 320)), (2, (300, 200)),
                                        (3, (64, 64))])
def test_hough_lines_equal_jax(jax_cpu, seed, shape):
    e = _edges(seed, *shape)
    want = JH.hough_lines(e, threshold=30, max_lines=16)
    got = PH.hough_lines(torch.from_numpy(e), threshold=30, max_lines=16)
    for a, b in zip(want, got):
        assert np.array_equal(_np(a), _np(b))
    assert got[1].any()


def test_hough_lines_axis_aligned_and_capped(jax_cpu):
    e = _line_mask(120, 160, [(30, 10, 30, 149), (10, 80, 109, 80)])
    lines, valid, votes = PH.hough_lines(torch.from_numpy(e), threshold=50, max_lines=8)
    got = {(round(float(r), 1), round(float(np.degrees(t)), 1), int(v))
           for (r, t), ok, v in zip(lines.numpy(), valid.numpy(), votes.numpy()) if ok}
    assert (30.0, 90.0, 140) in got and (80.0, 0.0, 100) in got
    # a cap below the edge count drops the raster-last points, as the reference does
    for cap in (50, 200):
        want = JH.hough_lines(e, threshold=20, max_lines=8, max_points=cap)
        got = PH.hough_lines(torch.from_numpy(e), threshold=20, max_lines=8, max_points=cap)
        assert all(np.array_equal(_np(a), _np(b)) for a, b in zip(want, got))


def test_hough_numpy_oracles_are_copies():
    e = _edges(5, 100, 140)
    for a, b in zip(JH.hough_lines_numpy(e, threshold=30), PH.hough_lines_numpy(e, threshold=30)):
        assert np.array_equal(a, b)
    img = _circles_scene(5, 120, 160)
    for a, b in zip(JH.hough_circles_numpy(img, vote_threshold=15),
                    PH.hough_circles_numpy(img, vote_threshold=15)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("seed,shape,dp", [(0, (100, 140), 4), (1, (240, 320), 3),
                                           (2, (160, 200), 2)])
def test_hough_circles_equal_jax(jax_cpu, seed, shape, dp):
    img = _circles_scene(seed, *shape)
    kw = dict(dp=dp, min_radius=10, max_radius=35, vote_threshold=15)
    want = JH.hough_circles(img, **kw)
    got = PH.hough_circles(torch.from_numpy(img), **kw)
    for a, b in zip(want, got):
        assert np.array_equal(_np(a), _np(b))
    assert got[1].sum() >= 3


def test_hough_circles_grid_cap_raises():
    with pytest.raises(ValueError, match="262144"):
        PH.hough_circles(torch.zeros((2100, 2100), dtype=torch.uint8), dp=4)


def test_hough_lines_p_equal_jax(jax_cpu):
    e = _line_mask(120, 160, [(20, 10, 20, 100), (20, 120, 20, 150), (30, 30, 110, 120)])
    want = JH.hough_lines_p(e, threshold=30, min_line_length=20, max_line_gap=5)
    got = PH.hough_lines_p(torch.from_numpy(e), threshold=30, min_line_length=20, max_line_gap=5)
    assert np.array_equal(want, got) and len(got) >= 2 and got.dtype == np.int32


def _template(size=32):
    t = np.full((size, size), 40, np.uint8)
    for y in range(6, 26):
        t[y, 6:6 + (y - 5)] = 210
    t[8:12, 20:29] = 210
    return t


def _ghough_scene(noise=0):
    img = np.full((140, 180), 40, np.uint8)
    for (cy, cx) in [(40, 50), (90, 120)]:
        img[cy - 16:cy + 16, cx - 16:cx + 16] = _template()
    if noise:
        rng = np.random.default_rng(noise)
        img = np.clip(img.astype(int) + rng.integers(-20, 20, img.shape), 0, 255).astype(np.uint8)
    return img


@pytest.mark.parametrize("noise", [0, 7])
def test_ghough_accumulate_and_detect_equal_jax(jax_cpu, noise):
    import jax.numpy as jnp

    t = _template()
    table = PG.build_r_table(t)
    assert np.array_equal(table, JG.build_r_table(t))
    scene = _ghough_scene(noise)
    acc = PG.ghough_accumulate(torch.from_numpy(scene), table)
    assert isinstance(acc, torch.Tensor) and acc.dtype == torch.int32
    assert np.array_equal(acc.numpy(), np.asarray(JG.ghough_accumulate(jnp.asarray(scene), table)))
    assert np.array_equal(acc.numpy(), PG.ghough_accumulate_numpy(scene, table))
    for port_in in (scene, torch.from_numpy(scene)):
        got = PG.ghough_detect(port_in, table, len(table) // 4)
        want = JG.ghough_detect(scene, table, len(table) // 4)
        assert all(np.array_equal(a, b) for a, b in zip(got, want)) and len(got[0]) >= 2
    got = PG.ghough_detect_guil(scene, table, 30)
    want = JG.ghough_detect_guil(scene, table, 30)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


def test_ghough_empty_edges():
    table = PG.build_r_table(_template())
    acc = PG.ghough_accumulate(torch.full((40, 50), 57, dtype=torch.uint8), table)
    assert acc.shape == (40, 50) and int(acc.max()) == 0


@pytest.fixture()
def textured():
    rng = np.random.default_rng(1234)
    return G.gaussian5_u8(rng.integers(0, 256, (120, 300), np.uint8))


@pytest.mark.parametrize("d_true,nd,bs", [(9, 16, 9), (17, 32, 11)])
def test_stereo_bm_equal_jax(jax_cpu, textured, d_true, nd, bs):
    left, right = textured[:, 0:160], textured[:, d_true:160 + d_true]
    wd, wv = (np.asarray(a) for a in JB.stereo_bm(left, right, num_disparities=nd, block_size=bs))
    gd, gv = PB.stereo_bm(torch.from_numpy(left), torch.from_numpy(right), num_disparities=nd,
                          block_size=bs)
    assert np.array_equal(gv.numpy(), wv) and np.abs(gd.numpy() - wd).max() < 1e-4
    od, ov = PB.stereo_bm_numpy(left, right, num_disparities=nd, block_size=bs)
    assert np.array_equal(gv.numpy(), ov) and np.abs(gd.numpy() - od).max() < 1e-4
    assert np.median(gd.numpy()[gv.numpy()]) == pytest.approx(d_true, abs=0.1)


def test_stereo_bm_flat_rejected():
    flat = torch.full((60, 120), 128, dtype=torch.uint8)
    _, valid = PB.stereo_bm(flat, flat, num_disparities=16, block_size=9)
    assert not valid.any()


def _pair(h=40, w=96, d=5, seed=7):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h, w + d)).astype(np.uint8)
    return base[:, :w], base[:, d:d + w]


@pytest.mark.parametrize("num_dirs,lr", [(4, 1), (8, 1), (8, -1)])
def test_stereo_sgbm_equal_jax(jax_cpu, num_dirs, lr):
    left, right = _pair()
    kw = dict(num_disparities=16, num_dirs=num_dirs, disp12_max_diff=lr)
    wd, wv = (np.asarray(a) for a in JS.stereo_sgbm(left, right, **kw))
    gd, gv = PS.stereo_sgbm(torch.from_numpy(left), torch.from_numpy(right), **kw)
    gd, gv = gd.numpy(), gv.numpy()
    assert np.array_equal(gv, wv)
    assert np.array_equal(np.floor(gd + 0.5), np.floor(wd + 0.5))
    assert np.abs(gd - wd).max() <= 1e-3
    od, ov = PS.stereo_sgbm_numpy(left, right, **kw)
    assert np.array_equal(gv, ov) and np.abs(gd - od).max() <= 1e-3
    assert PS.last_steps == (2 * 96 + 2 * 40 + (4 * 40 if num_dirs == 8 else 0))


def test_stereo_sgbm_two_planes_and_occlusion(jax_cpu):
    h, w = 40, 120
    rng = np.random.default_rng(11)
    base = rng.integers(0, 256, (h, w + 16)).astype(np.uint8)
    left = base[:, :w]
    right = np.empty_like(left)
    right[:, :w // 2] = base[:, 4:4 + w // 2]
    right[:, w // 2:] = base[:, 9 + w // 2:9 + w]
    wd, wv = (np.asarray(a) for a in JS.stereo_sgbm(left, right, num_disparities=16))
    gd, gv = PS.stereo_sgbm(torch.from_numpy(left), torch.from_numpy(right), num_disparities=16)
    assert np.array_equal(gv.numpy(), wv) and np.abs(gd.numpy() - wd).max() <= 1e-3
    off = PS.stereo_sgbm(torch.from_numpy(left), torch.from_numpy(right), num_disparities=16,
                         disp12_max_diff=-1)[1]
    assert int(off.sum()) > int(gv.sum())


def test_hough_stereo_wrappers_four_ways(jax_cpu, textured):
    """The ``imgproc`` names on the port's host Mat and CPU-tensor Mat
    against the reference's host and JAX Mats."""
    img = np.zeros((120, 160), np.uint8)
    img[40:60, 10:150] = 220
    circ = _circles_scene(3, 120, 160)
    left, right = textured[:, 0:160], textured[:, 9:169]

    def ports(a):
        return (Mat.from_array(a, device="cpu"), Mat.from_device(torch.from_numpy(a.copy())))

    def refs(a):
        host, dev = JMat.from_array(a), JMat.from_array(a)
        dev.device()
        return host, dev

    edges_p = [port_ip.canny(m) for m in ports(np.repeat(img[..., None], 3, -1))]
    edges_r = [jax_ip.canny(m) for m in refs(np.repeat(img[..., None], 3, -1))]
    for ep, er, cp, cr, lp, lr, rp, rr in zip(edges_p, edges_r, ports(circ), refs(circ),
                                              ports(left), refs(left), ports(right), refs(right)):
        got = port_ip.hough_lines(ep, threshold=60, max_lines=8)
        assert np.array_equal(got, jax_ip.hough_lines(er, threshold=60, max_lines=8))
        assert len(got) >= 2
        assert np.array_equal(port_ip.hough_lines_p(ep, threshold=60),
                              jax_ip.hough_lines_p(er, threshold=60))
        kw = dict(min_radius=10, max_radius=35, vote_threshold=15)
        got, want = port_ip.hough_circles(cp, **kw), jax_ip.hough_circles(cr, **kw)
        assert np.array_equal(got, want) and len(got) >= 2
        got, want = port_ip.stereo_bm(lp, rp, 16, 9), jax_ip.stereo_bm(lr, rr, 16, 9)
        assert isinstance(got[0], np.ndarray) and np.array_equal(got[1], want[1])
        assert np.abs(got[0] - want[0]).max() < 1e-4
        got = port_ip.stereo_sgbm(lp, rp, num_disparities=16, num_dirs=4)
        want = jax_ip.stereo_sgbm(lr, rr, num_disparities=16, num_dirs=4)
        assert np.array_equal(got[1], want[1]) and np.abs(got[0] - want[0]).max() <= 1e-3
    t = _template()
    assert port_ip.build_r_table is PG.build_r_table
    table = port_ip.build_r_table(t)
    for a, b in zip(port_ip.ghough_detect(_ghough_scene(), table, 20),
                    jax_ip.ghough_detect(_ghough_scene(), table, 20)):
        assert np.array_equal(a, b)
    assert port_ip.ghough_detect_guil is PG.ghough_detect_guil
