"""The port's arithmetic (``rustcv_tpu_torch.ops.arith``) and its
``imgproc`` wrappers, against ``rustcv_tpu.ops.arith`` (JAX on the CPU),
its numpy oracles and the frozen ``rustcv_tpu.ops.golden.normalize_u8``
on the same seeded inputs.

Tolerances: exact for the integer ops, ``convert_scale_abs`` and
``add_weighted`` at dyadic weights; ±1 LSB for ``add_weighted`` at other
weights and for ``normalize`` (float32 against the float64 spec), the
reference's documented tolerances; RTOL for the float results (``norm``
L2, ``psnr``), whose sums run in another order, and STD_RTOL for
``mean_std_dev``, whose float32 one-pass variance cancels;
``accumulate_weighted`` equal to its numpy oracle and within 1 ulp of the
JAX function."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rustcv_tpu.core as jax_core
import rustcv_tpu.imgproc as jax_ip
from rustcv_tpu.ops import arith as J
from rustcv_tpu.ops import golden as G
from rustcv_tpu_torch import imgproc as port_ip
from rustcv_tpu_torch.core import Mat
from rustcv_tpu_torch.ops import arith as P

torch.set_num_threads(2)

LSB = 1  # ±1 LSB: float32 weights or scales against the float32/float64 oracle
RTOL = 1e-5  # float32 sums in another order
# mean_std_dev's float32 one-pass variance, E[x²] − m², cancels: the order
# of its sums moves the stddev by more
STD_RTOL = 1e-4

SHAPES = {"bgr": (24, 35, 3), "gray": (23, 34), "batch": (2, 9, 17, 3)}


def _img(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _exact(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def _within(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.abs(got.astype(np.int64) - want.astype(np.int64)).max(initial=0) <= tol


BINARY = {
    "add_u8": (P.add_u8, J.add_u8, lambda a, b: np.minimum(a.astype(int) + b, 255)),
    "subtract_u8": (P.subtract_u8, J.subtract_u8, lambda a, b: np.maximum(a.astype(int) - b, 0)),
    "absdiff_u8": (P.absdiff_u8, J.absdiff_u8, lambda a, b: np.abs(a.astype(int) - b)),
    "bitwise_and": (P.bitwise_and, J.bitwise_and, np.bitwise_and),
    "bitwise_or": (P.bitwise_or, J.bitwise_or, np.bitwise_or),
    "bitwise_xor": (P.bitwise_xor, J.bitwise_xor, np.bitwise_xor),
}


@pytest.mark.parametrize("name", list(BINARY))
@pytest.mark.parametrize("kind", list(SHAPES))
def test_binary_ops_are_exact(name, kind):
    port, jax_fn, ref = BINARY[name]
    a, b = _img(SHAPES[kind], 1), _img(SHAPES[kind], 2)
    got = port(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    _exact(got, np.asarray(jax_fn(jnp.asarray(a), jnp.asarray(b))))
    _exact(got, ref(a, b).astype(np.uint8))


@pytest.mark.parametrize("kind", list(SHAPES))
def test_bitwise_not_and_count_non_zero(kind):
    a = _img(SHAPES[kind], 3)
    a[a < 60] = 0
    _exact(P.bitwise_not(torch.from_numpy(a)).numpy(), np.asarray(J.bitwise_not(jnp.asarray(a))))
    n = P.count_non_zero(torch.from_numpy(a))
    assert n.dtype == torch.int32 and int(n) == int(J.count_non_zero(jnp.asarray(a)))
    assert int(n) == np.count_nonzero(a)


WEIGHTS = {  # (alpha, beta, gamma), tolerance against the oracle and JAX
    "dyadic": ((0.75, 0.25, 0.0), 0),
    "dyadic_gamma": ((0.5, 0.125, 3.5), 0),
    "non_dyadic": ((0.3, 0.7, 0.0), LSB),
    "non_dyadic_gamma": ((0.61, 0.43, -7.3), LSB),
}


@pytest.mark.parametrize("name", list(WEIGHTS))
@pytest.mark.parametrize("kind", ["bgr", "gray"])
def test_add_weighted(name, kind):
    (alpha, beta, gamma), tol = WEIGHTS[name]
    a, b = _img(SHAPES[kind], 4), _img(SHAPES[kind], 5)
    got = P.add_weighted_u8(torch.from_numpy(a), alpha, torch.from_numpy(b), beta, gamma).numpy()
    _within(got, J.add_weighted_numpy(a, alpha, b, beta, gamma), tol)
    _within(got, np.asarray(J.add_weighted_u8(jnp.asarray(a), alpha, jnp.asarray(b), beta, gamma)),
            tol)


@pytest.mark.parametrize("alpha,beta", [(1.0, 0.0), (-1.5, 20.0), (0.37, -9.0)])
def test_convert_scale_abs(alpha, beta):
    a = _img(SHAPES["bgr"], 6)
    got = P.convert_scale_abs_u8(torch.from_numpy(a), alpha, beta).numpy()
    _exact(got, J.convert_scale_abs_numpy(a, alpha, beta))
    _exact(got, np.asarray(J.convert_scale_abs_u8(jnp.asarray(a), alpha, beta)))


@pytest.mark.parametrize("kind", ["l1", "l2", "inf"])
@pytest.mark.parametrize("shape", ["bgr", "gray"])
def test_norm(kind, shape):
    a = _img(SHAPES[shape], 7)
    got = P.norm_u8(torch.from_numpy(a), kind)
    assert got.dtype == torch.float32 and got.ndim == 0
    want = float(J.norm_u8(jnp.asarray(a), kind))
    if kind == "l2":
        np.testing.assert_allclose(float(got), want, rtol=RTOL)
        np.testing.assert_allclose(float(got), J.norm_numpy(a, kind), rtol=RTOL)
    else:
        assert float(got) == want == J.norm_numpy(a, kind)
    with pytest.raises(ValueError):
        P.norm_u8(torch.from_numpy(a), "l3")


@pytest.mark.parametrize("shape", ["bgr", "gray", "batch"])
def test_mean_stddev_and_psnr(shape):
    a, b = _img(SHAPES[shape], 8), _img(SHAPES[shape], 9)
    m, s = P.mean_stddev_u8(torch.from_numpy(a))
    jm, js = J.mean_stddev_u8(jnp.asarray(a))
    f = a.astype(np.float64)
    np.testing.assert_allclose([float(m), float(s)], [float(jm), float(js)], rtol=STD_RTOL)
    np.testing.assert_allclose([float(m), float(s)], [f.mean(), f.std()], rtol=STD_RTOL)
    got = P.psnr_u8(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got, J.psnr_u8(jnp.asarray(a), jnp.asarray(b)), rtol=RTOL)
    assert P.psnr_u8(torch.from_numpy(a), torch.from_numpy(a)) == float("inf")


@pytest.mark.parametrize("kind", ["minmax", "inf", "l1", "l2"])
@pytest.mark.parametrize("alpha,beta", [(0.0, 255.0), (10.0, 200.0), (300.0, 0.0)])
def test_normalize(kind, alpha, beta):
    a = _img(SHAPES["bgr"], 10) // 2 + 40
    got = P.normalize_u8(torch.from_numpy(a), alpha, beta, kind).numpy()
    _within(got, G.normalize_u8(a, alpha, beta, kind), LSB)
    _within(got, np.asarray(J.normalize_u8(jnp.asarray(a), alpha, beta, kind)), LSB)


def test_normalize_of_a_flat_image_is_alpha_or_zero():
    a = np.full((5, 7), 9, np.uint8)
    _exact(P.normalize_u8(torch.from_numpy(a), 30.0, 90.0).numpy(), G.normalize_u8(a, 30.0, 90.0))
    z = np.zeros((5, 7), np.uint8)
    _exact(P.normalize_u8(torch.from_numpy(z), 30.0, 0.0, "l2").numpy(), z)
    with pytest.raises(ValueError):
        P.normalize_u8(torch.from_numpy(a), kind="l3")


@pytest.mark.parametrize("alpha", [0.1, 0.5, 0.037])
def test_accumulate_weighted(alpha):
    acc = np.random.default_rng(11).uniform(0, 255, SHAPES["bgr"]).astype(np.float32)
    src = _img(SHAPES["bgr"], 12)
    got = P.accumulate_weighted(torch.from_numpy(acc), torch.from_numpy(src), alpha).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, J.accumulate_weighted_numpy(acc, src, alpha))
    # XLA contracts the reference's two products and sum into an FMA: 1 ulp
    np.testing.assert_array_max_ulp(got, np.asarray(J.accumulate_weighted(
        jnp.asarray(acc), jnp.asarray(src), alpha)), maxulp=1)
    # a host accumulator with a tensor frame
    np.testing.assert_array_equal(P.accumulate_weighted(acc, torch.from_numpy(src), alpha).numpy(),
                                  got)


@pytest.mark.parametrize("fn", ["add_weighted_numpy", "convert_scale_abs_numpy", "norm_numpy",
                                "accumulate_weighted_numpy"])
def test_numpy_oracles_are_the_references(fn):
    a, b = _img((6, 7), 13), _img((6, 7), 14)
    args = {"add_weighted_numpy": (a, 0.3, b, 0.6, 2.0), "convert_scale_abs_numpy": (a, -0.7, 3.0),
            "norm_numpy": (a, "l2"),
            "accumulate_weighted_numpy": (a.astype(np.float32), b, 0.2)}[fn]
    np.testing.assert_array_equal(getattr(P, fn)(*args), getattr(J, fn)(*args))


# -- the imgproc wrappers: the port's host and device (CPU tensor) Mats against
#    the reference's host and device (JAX) Mats ---------------------------------


def _mats(img):
    port = (Mat.from_array(img.copy(), device="cpu"), Mat.from_device(torch.from_numpy(img.copy())))
    ref = (jax_core.Mat.from_array(img.copy()), jax_core.Mat.from_device(jnp.asarray(img)))
    return port, ref


def _out(x):
    return x.to_numpy() if hasattr(x, "to_numpy") else np.asarray(x)


PAIR_WRAPPERS = {  # name → (call on two Mats, tolerance)
    "add": (lambda ip, a, b: ip.add(a, b), 0),
    "subtract": (lambda ip, a, b: ip.subtract(a, b), 0),
    "absdiff": (lambda ip, a, b: ip.absdiff(a, b), 0),
    "add_weighted_dyadic": (lambda ip, a, b: ip.add_weighted(a, 0.25, b, 0.75, 1.0), 0),
    "add_weighted": (lambda ip, a, b: ip.add_weighted(a, 0.3, b, 0.6, 2.0), LSB),
    "bitwise_and": (lambda ip, a, b: ip.bitwise_and(a, b), 0),
    "bitwise_or": (lambda ip, a, b: ip.bitwise_or(a, b), 0),
    "bitwise_xor": (lambda ip, a, b: ip.bitwise_xor(a, b), 0),
}


@pytest.mark.parametrize("name", list(PAIR_WRAPPERS))
@pytest.mark.parametrize("kind", ["bgr", "gray"])
def test_pair_wrappers_four_ways(name, kind):
    """Host pairs, device pairs, and a host Mat with a device Mat (the
    result on the device)."""
    call, tol = PAIR_WRAPPERS[name]
    shape = (23, 35, 3) if kind == "bgr" else (23, 35, 1)
    (pa_h, pa_d), (ra_h, ra_d) = _mats(_img(shape, 15))
    (pb_h, pb_d), (rb_h, rb_d) = _mats(_img(shape, 16))
    got_h = call(port_ip, pa_h, pb_h)
    got_d = call(port_ip, pa_d, pb_d)
    got_mixed = call(port_ip, pa_h, pb_d)
    assert not got_h.is_on_device and got_d.is_on_device and got_mixed.is_on_device
    _within(_out(got_h), _out(call(jax_ip, ra_h, rb_h)), tol)
    _within(_out(got_d), _out(call(jax_ip, ra_d, rb_d)), tol)
    _within(_out(got_mixed), _out(call(jax_ip, ra_h, rb_d)), tol)


MAT_WRAPPERS = {  # name → (call, tolerance)
    "convert_scale_abs": (lambda ip, m: ip.convert_scale_abs(m, -1.25, 30.0), 0),
    "bitwise_not": (lambda ip, m: ip.bitwise_not(m), 0),
    "count_non_zero": (lambda ip, m: ip.count_non_zero(m), 0),
    "norm_inf": (lambda ip, m: ip.norm(m, "inf"), 0),
    "norm_l1": (lambda ip, m: ip.norm(m, "l1"), 0),
    "normalize_minmax": (lambda ip, m: ip.normalize(m, 20.0, 220.0), LSB),
    "normalize_l2": (lambda ip, m: ip.normalize(m, 900.0, 0.0, "l2"), LSB),
    "normalize_l1": (lambda ip, m: ip.normalize(m, 30000.0, 0.0, "l1"), LSB),
    "normalize_inf": (lambda ip, m: ip.normalize(m, 100.0, 0.0, "inf"), LSB),
}


@pytest.mark.parametrize("name", list(MAT_WRAPPERS))
@pytest.mark.parametrize("kind", ["bgr", "gray"])
def test_mat_wrappers_four_ways(name, kind):
    call, tol = MAT_WRAPPERS[name]
    img = _img((23, 35, 3) if kind == "bgr" else (23, 35, 1), len(name))
    img[img < 40] = 0
    (p_host, p_dev), (r_host, r_dev) = _mats(img)
    got_host, got_dev = call(port_ip, p_host), call(port_ip, p_dev)
    if isinstance(got_host, Mat):
        assert not got_host.is_on_device and got_dev.is_on_device
    else:
        assert got_host == got_dev
    _within(_out(got_host), _out(call(jax_ip, r_host)), tol)
    _within(_out(got_dev), _out(call(jax_ip, r_dev)), tol)


@pytest.mark.parametrize("kind", ["bgr", "gray"])
def test_float_wrappers(kind):
    """``norm`` L2, ``mean_std_dev`` and ``psnr`` within RTOL of the
    reference on both sides."""
    img = _img((23, 35, 3) if kind == "bgr" else (23, 35, 1), 17)
    other = _img(img.shape, 18)
    (p_host, p_dev), (r_host, r_dev) = _mats(img)
    (q_host, q_dev), (s_host, s_dev) = _mats(other)
    for port, ref, port2, ref2 in ((p_host, r_host, q_host, s_host),
                                   (p_dev, r_dev, q_dev, s_dev)):
        np.testing.assert_allclose(port_ip.norm(port), jax_ip.norm(ref), rtol=RTOL)
        np.testing.assert_allclose(port_ip.mean_std_dev(port), jax_ip.mean_std_dev(ref),
                                   rtol=STD_RTOL)
        np.testing.assert_allclose(port_ip.psnr(port, port2), jax_ip.psnr(ref, ref2), rtol=RTOL)


def test_accumulate_weighted_wrapper():
    frames = [_img((23, 35, 3), s) for s in (19, 20, 21)]
    acc_p = acc_d = acc_r = None
    for f in frames:
        (p_host, p_dev), (r_host, _) = _mats(f)
        acc_p = port_ip.accumulate_weighted(acc_p, p_host, 0.25)
        acc_d = port_ip.accumulate_weighted(acc_d, p_dev, 0.25)
        acc_r = jax_ip.accumulate_weighted(acc_r, r_host, 0.25)
    assert isinstance(acc_p, np.ndarray) and torch.is_tensor(acc_d)
    np.testing.assert_array_equal(acc_p, np.asarray(acc_r))  # both the numpy oracle
    np.testing.assert_array_equal(acc_d.numpy(), acc_p)
