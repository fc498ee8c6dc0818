"""The port's flow and alignment (``rustcv_tpu_torch.ops.optflow``,
``farneback``, ``disflow``, ``varref``, ``tvl1``, ``ecc``) and their
``imgproc`` names, against ``rustcv_tpu`` (JAX on the CPU) and its float64
numpy oracles on the same seeded inputs.

Tolerances, the reference's own (``tests/test_optflow.py``,
``test_farneback.py``, ``test_disflow.py``, ``test_varref.py``,
``test_ecc.py``):
- LK: status exact and points within 1e-3 px of the float64 oracle,
  every point, those whose windows overhang any edge included (16 px and
  closer); against JAX the same on points whose windows stay clear of the
  top and left edges (see :func:`test_lk_top_edge_follows_the_oracle`);
- Farnebäck: 99th percentile of |Δ| < 1e-3 px and max < 0.05 px;
- DIS: max |Δ| < 0.05 px away from a 16-px border;
- variational refinement: max |Δ| < 2e-2 px away from a 4-px border;
- TV-L1 (u8 out): within 1 LSB (the reference states no device tolerance);
- ECC (device twin): |Δrho| < 1e-3, warp entries within 0.05; the
  degenerate case reports rho = −1 as the reference's twin does."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rustcv_tpu.core as jax_core
import rustcv_tpu.imgproc as jax_ip
from rustcv_tpu.capture import simulation as sim
from rustcv_tpu.ops import disflow as JD
from rustcv_tpu.ops import ecc as JE
from rustcv_tpu.ops import farneback as JFb
from rustcv_tpu.ops import golden as G
from rustcv_tpu.ops import optflow as JO
from rustcv_tpu.ops import tvl1 as JT
from rustcv_tpu.ops import varref as JV
from rustcv_tpu.ops import warp as JW
from rustcv_tpu_torch import imgproc as port_ip
from rustcv_tpu_torch.core import Mat
from rustcv_tpu_torch.ops import disflow as PD
from rustcv_tpu_torch.ops import ecc as PE
from rustcv_tpu_torch.ops import farneback as PFb
from rustcv_tpu_torch.ops import optflow as PO
from rustcv_tpu_torch.ops import tvl1 as PT
from rustcv_tpu_torch.ops import varref as PV

torch.set_num_threads(2)


def _scene(w, h, seed, noise=20):
    img = G.bgr_to_gray(sim.synth_bgr(w, h, seed))
    add = np.random.default_rng(seed + 100).integers(0, noise, img.shape)
    return np.clip(img.astype(np.int32) + add, 0, 255).astype(np.uint8)


def _texture(seed, shape):
    rng = np.random.default_rng(seed)
    return G.gaussian5_u8(G.gaussian5_u8(rng.integers(0, 256, shape, dtype=np.uint8)))


def _moved(img, dx, dy):
    h, w = img.shape
    return JW.warp_affine_numpy(img, np.array([[1.0, 0.0, dx], [0.0, 1.0, dy]]), (w, h),
                                border="replicate")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --- Lucas–Kanade -----------------------------------------------------------

PREV = _scene(128, 96, 3)
NEXT = _moved(PREV, 3.4, -2.2)


def _lk_points(h, w, seed):
    rng = np.random.default_rng(seed)
    inner = np.stack([rng.uniform(20, w - 1, 40), rng.uniform(20, h - 1, 40)], 1)
    edge = [[w - 2.5, 40.0], [w - 10.2, h - 3.3], [60.0, h - 1.0], [w - 16.0, h - 16.0],
            [w - 1.0, h - 1.0]]  # near the right and bottom edges
    return np.concatenate([inner, edge]).astype(np.float32)


def _lk_edge_points(h, w):
    return np.array([[1.0, 30.0], [5.5, 6.5], [15.9, 40.0], [40.0, 2.2], [0.0, 0.0],
                     [w - 2.5, 3.0], [10.0, h - 8.0], [-2.0, 20.0], [30.0, h + 3.0]],
                    np.float32)


@pytest.mark.parametrize("win,levels,iters", [(21, 3, 10), (11, 2, 5), (15, 0, 10), (9, 1, 20)])
def test_lk_matches_jax_and_oracle(win, levels, iters):
    pts = _lk_points(96, 128, win)
    got, st = PO.calc_optical_flow_pyr_lk(_t(PREV), _t(NEXT), pts, win=win, levels=levels,
                                          iters=iters)
    jp, js = JO.calc_optical_flow_pyr_lk(jnp.asarray(PREV), jnp.asarray(NEXT), jnp.asarray(pts),
                                         win=win, levels=levels, iters=iters)
    op, os_ = JO.calc_optical_flow_pyr_lk_numpy(PREV, NEXT, pts, win=win, levels=levels,
                                                iters=iters)
    np.testing.assert_array_equal(st.numpy(), np.asarray(js))
    np.testing.assert_array_equal(st.numpy(), os_)
    assert np.abs(got.numpy() - np.asarray(jp)).max() < 1e-3
    assert np.abs(got.numpy() - op).max() < 1e-3
    assert st.numpy().sum() > 30


@pytest.mark.parametrize("win,levels", [(21, 3), (11, 2), (7, 0)])
def test_lk_edge_points_follow_the_oracle(win, levels):
    """Windows overhanging every edge: the gather's origin is clamped into
    the image and the weights keep the unclamped fraction, as the frozen
    spec (the oracle) says."""
    pts = _lk_edge_points(96, 128)
    got, st = PO.calc_optical_flow_pyr_lk(_t(PREV), _t(NEXT), pts, win=win, levels=levels)
    op, os_ = JO.calc_optical_flow_pyr_lk_numpy(PREV, NEXT, pts, win=win, levels=levels)
    np.testing.assert_array_equal(st.numpy(), os_)
    assert np.abs(got.numpy() - op).max() < 1e-3


def test_lk_top_edge_follows_the_oracle():
    """A point whose template drifts over the top edge during its
    iterations. The reference's device twin reads that patch from the
    bottom of the image (``lax.dynamic_slice`` wraps a negative origin) and
    leaves its own oracle by pixels; the port clamps the origin as the
    oracle and its docstring say (ROADMAP Queue 3)."""
    base = G.gaussian5_u8(np.random.default_rng(3).integers(0, 256, (100, 130)).astype(np.uint8))
    a, b = base[10:90, 10:120], base[12:92, 7:117]
    pts = np.array([[53.610283, 6.521118]], np.float32)
    got, st = PO.calc_optical_flow_pyr_lk(_t(a), _t(b), pts, win=11, levels=0)
    op, os_ = JO.calc_optical_flow_pyr_lk_numpy(a, b, pts, win=11, levels=0)
    jp, _ = JO.calc_optical_flow_pyr_lk(jnp.asarray(a), jnp.asarray(b), jnp.asarray(pts),
                                        win=11, levels=0)
    assert np.abs(got.numpy() - op).max() < 1e-3 and st.numpy().tolist() == os_.tolist()
    assert np.abs(np.asarray(jp) - op).max() > 1.0


def test_lk_small_image_raises_and_pyramid():
    with pytest.raises(ValueError):
        PO.calc_optical_flow_pyr_lk(_t(PREV[:20, :20]), _t(NEXT[:20, :20]), [[5.0, 5.0]])
    pyr = PO.build_optical_flow_pyramid(PREV, 4)
    want = JO.build_optical_flow_pyramid(PREV, 4)
    assert len(pyr) == len(want) == 4
    for a, b in zip(pyr, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(PO.calc_optical_flow_pyr_lk_numpy(
        PREV, NEXT, _lk_points(96, 128, 1))[0], JO.calc_optical_flow_pyr_lk_numpy(
        PREV, NEXT, _lk_points(96, 128, 1))[0])


# --- Farnebäck --------------------------------------------------------------


@pytest.mark.parametrize("shape,kw", [((52, 64), {}), ((45, 61), dict(levels=3, winsize=7,
                                                                         poly_n=7, poly_sigma=1.5)),
                                      ((40, 56), dict(levels=1, iterations=5))])
def test_farneback_matches_jax_and_oracle(shape, kw):
    h, w = shape
    a = _texture(5, (h + 8, w + 8))
    i0, i1 = a[4:4 + h, 4:4 + w], a[2:2 + h, 5:5 + w]
    got = PFb.farneback_flow(_t(i0), _t(i1), **kw).numpy()
    want = JFb.farneback_flow_numpy(i0, i1, **kw)
    ref = np.asarray(JFb.farneback_flow(jnp.asarray(i0), jnp.asarray(i1), **kw))
    for other in (want, ref):
        d = np.abs(got - other)
        assert np.quantile(d, 0.99) < 1e-3 and d.max() < 0.05
    np.testing.assert_array_equal(PFb.farneback_flow_numpy(i0, i1, **kw), want)


def test_farneback_zero_motion():
    a = _texture(6, (48, 64))
    assert np.abs(PFb.farneback_flow(_t(a), _t(a)).numpy()).max() < 1e-5


# --- DIS and the variational refinement -------------------------------------


def _dis_pair(seed, shape, dx, dy):
    rng = np.random.default_rng(seed)
    from rustcv_tpu.ops.sift import _blur

    base = _blur(rng.integers(0, 256, shape).astype(np.float64), 2.0)
    base = (base - base.min()) / np.ptp(base) * 255
    h, w = shape
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    moved = JD._bilinear_np(base, ys - dy, xs - dx)
    return base.astype(np.uint8), np.clip(moved, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("finest_scale,iters", [(1, 8), (0, 8), (2, 5)])
@pytest.mark.parametrize("shape,motion", [((80, 96), (2.1, -1.2)), ((77, 101), (-3.0, 4.5))])
def test_dis_matches_jax_and_oracle(finest_scale, iters, shape, motion):
    i0, i1 = _dis_pair(sum(shape), shape, *motion)
    got = PD.dis_flow(_t(i0), _t(i1), finest_scale, iters).numpy()
    want = JD.dis_flow_numpy(i0, i1, finest_scale, iters)
    ref = np.asarray(JD.dis_flow(jnp.asarray(i0), jnp.asarray(i1), finest_scale, iters))
    sl = np.s_[16:-16, 16:-16]
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.abs(got[sl] - want[sl]).max() < 0.05
    assert np.abs(got[sl] - ref[sl]).max() < 0.05
    if (finest_scale, shape) == (0, (80, 96)):
        np.testing.assert_array_equal(PD.dis_flow_numpy(i0, i1, finest_scale, iters), want)


@pytest.fixture(scope="module")
def varref_pair():
    base = _texture(1234, (70, 90))
    i1 = JW.warp_affine_numpy(base, np.array([[1.0, 0, 1.5], [0, 1.0, -1.0]]), (90, 70))
    true_flow = np.zeros((70, 90, 2), np.float32)
    true_flow[..., 0], true_flow[..., 1] = 1.5, -1.0
    return base, i1, true_flow


@pytest.mark.parametrize("kw", [{}, dict(alpha=10.0, fixed_point_iterations=3, sor_iterations=7)])
def test_variational_refine_matches_jax_and_oracle(varref_pair, kw):
    i0, i1, tf = varref_pair
    noisy = tf + np.random.default_rng(1).normal(0, 0.3, tf.shape).astype(np.float32)
    got = PV.variational_refine(_t(i0), _t(i1), _t(noisy), **kw).numpy()
    want = JV.variational_refine_numpy(i0, i1, noisy, **kw)
    ref = np.asarray(JV.variational_refine(jnp.asarray(i0), jnp.asarray(i1), jnp.asarray(noisy),
                                           **kw))
    assert np.abs(got - want)[4:-4, 4:-4].max() < 2e-2
    assert np.abs(got - ref)[4:-4, 4:-4].max() < 2e-2
    np.testing.assert_array_equal(PV.variational_refine_numpy(i0, i1, noisy, **kw), want)


# --- TV-L1 ------------------------------------------------------------------


@pytest.mark.parametrize("n_obs,lam,niters", [(3, 1.0, 30), (1, 0.5, 10), (5, 1.5, 20)])
def test_denoise_tvl1_matches_jax_and_oracle(n_obs, lam, niters):
    rng = np.random.default_rng(n_obs)
    clean = (np.arange(60)[:, None] // 15 * 60 + np.arange(80)[None, :] // 20 * 20).astype(np.uint8)
    obs = [np.clip(clean + rng.normal(0, 20, clean.shape), 0, 255).astype(np.uint8)
           for _ in range(n_obs)]
    got = PT.denoise_tvl1(_t(np.stack(obs)), lam=lam, niters=niters).numpy()
    want = JT.denoise_tvl1_numpy(obs, lam=lam, niters=niters)
    ref = np.asarray(JT.denoise_tvl1(jnp.asarray(np.stack(obs)), lam=lam, niters=niters))
    assert got.dtype == np.uint8
    assert np.abs(got.astype(int) - want).max() <= 1
    assert np.abs(got.astype(int) - ref).max() <= 1
    np.testing.assert_array_equal(PT.denoise_tvl1_numpy(obs, lam=lam, niters=niters), want)
    assert PT.tv_l1_energy(got, obs) == pytest.approx(JT.tv_l1_energy(got, obs))


# --- ECC --------------------------------------------------------------------


def _ecc_warps():
    th = 0.02
    return {
        "translation": np.array([[1, 0, 1.5], [0, 1, 2.0]], float),
        "euclidean": np.array([[np.cos(th), -np.sin(th), 1.5], [np.sin(th), np.cos(th), 2.0]]),
        "affine": np.array([[1.01, 0.02, 1.5], [-0.01, 0.99, 2.0]]),
        "homography": np.array([[1.01, 0.02, 1.5], [-0.01, 0.99, 2.0], [1e-5, -1e-5, 1.0]]),
    }


@pytest.mark.parametrize("motion", ["translation", "euclidean", "affine", "homography"])
def test_ecc_device_twin_matches_jax_and_oracle(motion):
    t = _texture(6, (64, 80)).astype(np.float64)
    m = _ecc_warps()[motion]
    if m.shape == (3, 3):
        img = JW.warp_perspective_numpy(t.astype(np.uint8), m, (80, 64), border="replicate")
    else:
        img = JW.warp_affine_numpy(t.astype(np.uint8), m, (80, 64), border="replicate")
    rho, warp = PE.find_transform_ecc(_t(t.astype(np.float32)), _t(img), motion, iterations=60,
                                      backend="device")
    rho_h, warp_h = JE.find_transform_ecc_numpy(t, img, motion, iterations=60)
    rho_j, warp_j = JE.find_transform_ecc(t, img, motion, iterations=60, backend="device")
    assert abs(rho - rho_h) < 1e-3 and abs(rho - rho_j) < 1e-3
    assert np.abs(warp - warp_h).max() < 0.05 and np.abs(warp - warp_j).max() < 0.05
    assert warp.shape == warp_h.shape
    got_h = PE.find_transform_ecc(t, img, motion, iterations=60)  # host: the oracle
    assert got_h[0] == rho_h
    np.testing.assert_array_equal(got_h[1], warp_h)


def test_ecc_degenerate_and_semantics():
    rng = np.random.default_rng(9)
    a = rng.normal(128, 30, (64, 64))
    b = rng.normal(128, 30, (64, 64))
    rho, _ = PE.find_transform_ecc(_t(a.astype(np.float32)), _t(b.astype(np.float32)), "affine",
                                   backend="device")
    rho_j, _ = JE.find_transform_ecc(a, b, "affine", backend="device")
    assert rho <= 0.2 and (rho == -1.0) == (rho_j == -1.0)
    with pytest.raises(ValueError):
        PE.find_transform_ecc(a, b, "affine")
    with pytest.raises(ValueError):
        PE.find_transform_ecc(a, b, "spiral", backend="device")
    t = _texture(7, (32, 40)).astype(np.float64)
    assert PE.compute_ecc(t, t) == JE.compute_ecc(t, t)
    u = rng.normal(size=t.shape)
    assert PE.compute_ecc(t, u) == JE.compute_ecc(t, u)


def test_ecc_freezes_once_converged():
    """Identical images converge on the first round: the twin freezes its
    parameters there (no host read) and stays at the identity."""
    t = _texture(8, (40, 48)).astype(np.float32)
    rho, warp = PE.find_transform_ecc(_t(t), _t(t), "affine", iterations=30, backend="device")
    np.testing.assert_allclose(warp, np.eye(2, 3), atol=1e-3)
    assert rho == pytest.approx(1.0, abs=1e-5)


def test_ecc_multiscale_matches_reference():
    t = _scene(160, 120, 4)
    img = _moved(t, 7.0, -4.5)
    got = PE.find_transform_ecc_multiscale(t, img, "translation", levels=3, iterations=20)
    want = JE.find_transform_ecc_multiscale(t, img, "translation", levels=3, iterations=20)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])


# --- imgproc names, four ways -----------------------------------------------


def _mats(img):
    port = (Mat.from_array(img.copy(), device="cpu"), Mat.from_device(torch.from_numpy(img.copy())))
    ref = (jax_core.Mat.from_array(img.copy()), jax_core.Mat.from_device(jnp.asarray(img)))
    return port, ref


def _pairs(kind):
    a, b = PREV[:64, :96], NEXT[:64, :96]
    if kind == "bgr":
        a, b = (np.repeat(x[..., None], 3, -1) for x in (a, b))
    else:
        a, b = a[..., None], b[..., None]
    return _mats(a), _mats(b)


FLOW_WRAPPERS = {  # name → (call, |Δ| bound of the device outputs, away from a border)
    "lk": (lambda ip, p, n: ip.calc_optical_flow_pyr_lk(p, n, _lk_points(64, 96, 2), win=11,
                                                        levels=2), 1e-3),
    "farneback": (lambda ip, p, n: ip.calc_optical_flow_farneback(p, n, 2, 7), 0.05),
    "dis": (lambda ip, p, n: ip.calc_optical_flow_dis(p, n), 0.05),
    "dis_fast": (lambda ip, p, n: ip.calc_optical_flow_dis(p, n, preset="fast"), 0.05),
    "phase": (lambda ip, p, n: ip.phase_correlate(p, n), 1e-3),
}


@pytest.mark.parametrize("name", list(FLOW_WRAPPERS))
@pytest.mark.parametrize("kind", ["gray", "bgr"])
def test_flow_wrappers_four_ways(name, kind):
    call, tol = FLOW_WRAPPERS[name]
    ((ph, pd), (rh, rd)), ((nh, nd), (qh, qd)) = _pairs(kind)
    host, want_h = call(port_ip, ph, nh), call(jax_ip, rh, qh)
    dev, want_d = call(port_ip, pd, nd), call(jax_ip, rd, qd)
    host = host if isinstance(host, tuple) else (host,)
    want_h = want_h if isinstance(want_h, tuple) else (want_h,)
    dev = dev if isinstance(dev, tuple) else (dev,)
    want_d = want_d if isinstance(want_d, tuple) else (want_d,)
    for a, b in zip(host, want_h):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b, o in zip(dev, want_d, want_h):
        a, b, o = np.asarray(a), np.asarray(b), np.asarray(o)
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.dtype == bool:
            np.testing.assert_array_equal(a, b)
        elif a.ndim == 3:
            sl = np.s_[16:-16, 16:-16]
            assert np.abs(a[sl] - o[sl]).max() < tol and np.abs(a[sl] - b[sl]).max() < tol
        else:
            assert np.abs(a - o).max() < tol


def test_dis_refine_wrapper():
    """``refine=True``: the host Mat refines with the reference's oracle;
    a device Mat refines on its device, within the refinement's
    device-vs-oracle tolerance of the reference's host result."""
    ((ph, pd), (rh, rd)), ((nh, nd), (qh, qd)) = _pairs("gray")
    np.testing.assert_array_equal(port_ip.calc_optical_flow_dis(ph, nh, refine=True),
                                  jax_ip.calc_optical_flow_dis(rh, qh, refine=True))
    got = port_ip.calc_optical_flow_dis(pd, nd, refine=True)
    want = jax_ip.calc_optical_flow_dis(rd, qd, refine=True)
    sl = np.s_[16:-16, 16:-16]
    assert got.dtype == np.float32 and np.abs(got[sl] - want[sl]).max() < 0.05


def test_denoise_tvl1_and_variational_refine_wrappers():
    rng = np.random.default_rng(2)
    clean = (np.arange(40)[:, None] // 10 * 60 + np.arange(48)[None, :] // 12 * 20).astype(np.uint8)
    obs = [np.clip(clean + rng.normal(0, 20, clean.shape), 0, 255).astype(np.uint8)[..., None]
           for _ in range(3)]
    host = port_ip.denoise_tvl1([Mat.from_array(o, device="cpu") for o in obs], niters=10)
    want = jax_ip.denoise_tvl1([jax_core.Mat.from_array(o) for o in obs], niters=10)
    np.testing.assert_array_equal(host, want)
    dev = port_ip.denoise_tvl1([Mat.from_device(_t(o[..., 0])) for o in obs], niters=10)
    want_d = jax_ip.denoise_tvl1([jax_core.Mat.from_device(jnp.asarray(o[..., 0])) for o in obs],
                                 niters=10)
    assert dev.dtype == np.uint8 and np.abs(dev.astype(int) - np.asarray(want_d)).max() <= 1
    a, b = PREV[:40, :48], NEXT[:40, :48]
    flow = np.zeros((40, 48, 2), np.float32)
    got = port_ip.variational_refine(_t(a), _t(b), _t(flow)).numpy()
    ref = np.asarray(jax_ip.variational_refine(jnp.asarray(a), jnp.asarray(b), jnp.asarray(flow)))
    assert np.abs(got - ref)[4:-4, 4:-4].max() < 2e-2


def test_ecc_and_pyramid_names():
    t = _texture(6, (48, 64)).astype(np.float64)
    img = _moved(t.astype(np.uint8), 1.2, -0.7)
    got = port_ip.find_transform_ecc(t, img, "translation", iterations=30)
    want = jax_ip.find_transform_ecc(t, img, "translation", iterations=30)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    assert port_ip.compute_ecc(t, img) == jax_ip.compute_ecc(t, img)
    got = port_ip.find_transform_ecc_multiscale(t, img, "translation", levels=2, iterations=10)
    want = jax_ip.find_transform_ecc_multiscale(t, img, "translation", levels=2, iterations=10)
    np.testing.assert_array_equal(got[1], want[1])
    for a, b in zip(port_ip.build_optical_flow_pyramid(PREV, 3),
                    jax_ip.build_optical_flow_pyramid(PREV, 3)):
        np.testing.assert_array_equal(a, b)
