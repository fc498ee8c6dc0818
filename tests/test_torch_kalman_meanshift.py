"""The port's Kalman banks (``rustcv_tpu_torch.ops.kalman``) and mean-shift
filtering (``ops.meanshift_filter``) with ``imgproc.pyr_mean_shift_filtering``,
against ``rustcv_tpu`` (JAX on the CPU) and its float64 oracles on the same
seeded inputs.

Tolerances, the reference's own (``tests/test_kalman.py``,
``test_meanshift_filter.py``):
- Kalman: the object API equals the float64 golden (rtol 1e-12); the
  float32 banks within rtol 1e-4, atol 1e-5 of it, and within 1e-5
  relative of JAX's banks; ``filter_scan`` equals the stepwise updates;
- mean-shift: the float32 twin within ±1 of the float64 oracle on at
  least 99 % of pixels, median difference 0; the oracle is the
  reference's value for value."""

import numpy as np
import pytest
import torch

import rustcv_tpu.ops.kalman as JK
from rustcv_tpu.ops import golden as G
from rustcv_tpu.ops import meanshift_filter as JM
from rustcv_tpu_torch import imgproc as port_ip
from rustcv_tpu_torch.core import Mat
from rustcv_tpu_torch.ops import golden as PG
from rustcv_tpu_torch.ops import kalman as PK
from rustcv_tpu_torch.ops import meanshift_filter as PM

torch.set_num_threads(2)


def _cv_model(dt=1.0, q=1e-2, r=0.5):
    """Constant-velocity 1-D model: state (pos, vel), measure pos."""
    A = np.array([[1.0, dt], [0.0, 1.0]])
    H = np.array([[1.0, 0.0]])
    Q = q * np.array([[dt ** 3 / 3, dt ** 2 / 2], [dt ** 2 / 2, dt]])
    R = np.array([[r]])
    return A, H, Q, R


def _cv_model_2d(q=1e-2, r=0.5):
    """Constant velocity in 2-D: state (x, y, vx, vy), measure (x, y)."""
    A = np.eye(4)
    A[0, 2] = A[1, 3] = 1.0
    H = np.eye(2, 4)
    return A, H, q * np.eye(4), r * np.eye(2)


def _t(*xs):
    return [torch.from_numpy(np.asarray(x)) for x in xs]


def test_object_api_is_the_golden(rng):
    A, H, Q, R = _cv_model()
    kf = PK.KalmanFilter(2, 1)
    kf.transition_matrix, kf.measurement_matrix = A, H
    kf.process_noise_cov, kf.measurement_noise_cov = Q, R
    kf.state_post = np.array([0.0, 0.0])
    kf.error_cov_post = np.eye(2)
    x, P = kf.state_post.copy(), kf.error_cov_post.copy()
    for t in range(5):
        z = np.array([float(t) + rng.normal()])
        xp = kf.predict()
        gx, gP = G.kalman_predict(x, P, A, Q)
        np.testing.assert_allclose(xp, gx, rtol=1e-12)
        np.testing.assert_allclose(kf.error_cov_pre, gP, rtol=1e-12)
        xc = kf.correct(z)
        gxc, gPc, gK = G.kalman_correct(gx, gP, z, H, R)
        np.testing.assert_allclose(xc, gxc, rtol=1e-12)
        np.testing.assert_allclose(kf.error_cov_post, gPc, rtol=1e-12)
        np.testing.assert_allclose(kf.gain, gK, rtol=1e-12)
        x, P = gxc, gPc
    # the port's golden copies are the reference's
    for a, b in zip(PG.kalman_correct(x, P, [1.0], H, R), G.kalman_correct(x, P, [1.0], H, R)):
        np.testing.assert_array_equal(a, b)
    # OpenCV copies pre → post in predict: two predicts move two steps
    kf = PK.KalmanFilter(2, 1)
    kf.transition_matrix, kf.process_noise_cov = A, Q
    kf.state_post, kf.error_cov_post = np.array([0.0, 1.0]), np.eye(2)
    kf.predict()
    assert kf.predict()[0] == pytest.approx(2.0)
    kf = PK.KalmanFilter(2, 1, control_params=1)
    kf.control_matrix = np.array([[0.5], [1.0]])
    kf.state_post = np.zeros((2, 1))  # the cv2 column-vector idiom
    np.testing.assert_allclose(kf.predict(control=np.array([2.0])), [1.0, 2.0])
    with pytest.raises(ValueError):
        PK.KalmanFilter(0, 1)


@pytest.mark.parametrize("model", ["1d", "2d"])
def test_banks_match_golden_and_jax(rng, jax_cpu, model):
    A, H, Q, R = _cv_model() if model == "1d" else _cv_model_2d()
    N, S, M = 7, A.shape[0], H.shape[0]
    x = rng.normal(size=(N, S))
    P = np.stack([np.eye(S) * (1 + 0.1 * i) for i in range(N)])
    z = rng.normal(size=(N, M))
    xp, Pp = PK.predict_batch(*_t(x, P, A, Q))
    xn, Pn, K = PK.correct_batch(xp, Pp, *_t(z, H, R))
    assert xp.dtype == Pn.dtype == K.dtype == torch.float32
    jxp, jPp = JK.predict_batch(x, P, A, Q)
    jxn, jPn, jK = JK.correct_batch(jxp, jPp, z, H, R)
    for got, want in ((xp, jxp), (Pp, jPp), (xn, jxn), (Pn, jPn), (K, jK)):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-5 * max(1.0, np.abs(want).max())
    for i in range(N):
        gx, gP = G.kalman_predict(x[i], P[i], A, Q)
        np.testing.assert_allclose(xp[i].numpy(), gx, rtol=1e-4, atol=1e-5)
        gxc, gPc, gK = G.kalman_correct(gx, gP, z[i], H, R)
        np.testing.assert_allclose(xn[i].numpy(), gxc, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(Pn[i].numpy(), gPc, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(K[i].numpy(), gK, rtol=1e-4, atol=1e-5)


def test_per_tracker_model_matrices(rng, jax_cpu):
    """A batched (N, S, S) A applies each tracker's own (the rank branch:
    an ellipsis einsum would sum them), and a batched H and R too."""
    N = 3
    A = np.stack([np.eye(2) * (1 + 0.1 * i) for i in range(N)])
    Q = np.stack([np.eye(2) * 0.01] * N)
    H = np.stack([np.array([[1.0, 0.1 * i]]) for i in range(N)])
    R = np.stack([np.eye(1) * (0.5 + i) for i in range(N)])
    x = rng.normal(size=(N, 2))
    P = np.stack([np.eye(2)] * N)
    z = rng.normal(size=(N, 1))
    xp, Pp = PK.predict_batch(*_t(x, P, A, Q))
    xn, Pn, K = PK.correct_batch(xp, Pp, *_t(z, H, R))
    for i in range(N):
        gx, gP = G.kalman_predict(x[i], P[i], A[i], Q[i])
        np.testing.assert_allclose(xp[i].numpy(), gx, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(Pp[i].numpy(), gP, rtol=1e-4, atol=1e-5)
        gxc, gPc, _ = G.kalman_correct(gx, gP, z[i], H[i], R[i])
        np.testing.assert_allclose(xn[i].numpy(), gxc, rtol=1e-4, atol=1e-5)
    jxp, _ = JK.predict_batch(x, P, A, Q)
    np.testing.assert_allclose(xp.numpy(), np.asarray(jxp), rtol=1e-5, atol=1e-6)


def test_filter_scan_equals_stepwise_and_jax(rng, jax_cpu):
    A, H, Q, R = _cv_model()
    T, N = 12, 4
    x0 = rng.normal(size=(N, 2)).astype(np.float32)
    P0 = np.stack([np.eye(2, dtype=np.float32)] * N)
    zs = rng.normal(size=(T, N, 1)).astype(np.float32)
    xs, xf, Pf = PK.filter_scan(*_t(x0, P0, zs, A, H, Q, R))
    x, P = _t(x0, P0)
    for t in range(T):
        xp, Pp = PK.predict_batch(x, P, *_t(A, Q))
        x, P, _ = PK.correct_batch(xp, Pp, *_t(zs[t], H, R))
        np.testing.assert_allclose(xs[t].numpy(), x.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(xf.numpy(), x.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(Pf.numpy(), P.numpy(), rtol=1e-5, atol=1e-6)
    jxs, jxf, jPf = JK.filter_scan(x0, P0, zs, A, H, Q, R)
    np.testing.assert_allclose(xs.numpy(), np.asarray(jxs), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(Pf.numpy(), np.asarray(jPf), rtol=1e-5, atol=1e-5)
    # a constant-velocity track converges on its velocity
    pos = np.cumsum(np.full(60, 0.7)) + 3.0
    meas = (pos + rng.normal(0, np.sqrt(0.5), 60))[:, None, None].astype(np.float32)
    xs, xf, _ = PK.filter_scan(*_t(np.array([[3.0, 0.0]], np.float32),
                                   np.eye(2, dtype=np.float32)[None], meas, A, H, Q, R))
    assert xs.shape == (60, 1, 2) and abs(float(xf[0, 0]) - pos[-1]) < 1.0


def _ms_scene(seed=0, noise=8):
    rng = np.random.default_rng(seed)
    img = np.zeros((48, 64, 3), np.float64)
    img[:, :32] = (60, 80, 100)
    img[:, 32:] = (180, 160, 140)
    img += rng.normal(0, noise, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def test_mean_shift_oracle_is_the_references():
    img = _ms_scene()[:24, :32]
    for kw in (dict(sp=3, sr=30.0, max_level=1, max_iter=3),
               dict(sp=2, sr=10.0, max_level=0, max_iter=2)):
        assert np.array_equal(PM.pyr_mean_shift_numpy(img, **kw),
                              JM.pyr_mean_shift_numpy(img, **kw))
    flat = np.full((16, 20, 3), 77, np.uint8)
    assert np.array_equal(PM.pyr_mean_shift_numpy(flat, sp=4, sr=20.0, max_level=0), flat)


@pytest.mark.parametrize("seed,sp,sr,level,iters", [(0, 3, 30.0, 0, 2), (1, 4, 25.0, 1, 3),
                                                    (2, 5, 12.0, 1, 5)])
def test_mean_shift_twin_within_the_contract(jax_cpu, seed, sp, sr, level, iters):
    img = _ms_scene(seed, noise=8 + 4 * seed)[:32, :40]
    oracle = JM.pyr_mean_shift_numpy(img, sp=sp, sr=sr, max_level=level, max_iter=iters)
    got = PM.pyr_mean_shift(torch.from_numpy(img), sp=sp, sr=sr, max_level=level,
                            max_iter=iters)
    assert got.dtype == torch.uint8 and got.shape == img.shape
    diff = np.abs(got.numpy().astype(int) - oracle.astype(int))
    assert (diff <= 1).mean() > 0.99 and np.median(diff) == 0
    if sp == 3:  # JAX's twin is the same arithmetic in the same order
        want = np.asarray(JM.pyr_mean_shift(img, sp=sp, sr=sr, max_level=level, max_iter=iters))
        assert (np.abs(got.numpy().astype(int) - want) <= 1).mean() > 0.99


def test_pyr_mean_shift_filtering_wrapper(jax_cpu):
    """A host Mat runs the float64 oracle, a device Mat the float32 twin."""
    img = _ms_scene(3)[:24, :32]
    kw = dict(sp=3, sr=30.0, max_level=1, max_iter=2)
    host = port_ip.pyr_mean_shift_filtering(Mat.from_array(img, device="cpu"), **kw)
    assert not host.is_on_device
    assert np.array_equal(host.to_numpy(), JM.pyr_mean_shift_numpy(img, **kw))
    dev = port_ip.pyr_mean_shift_filtering(Mat.from_device(torch.from_numpy(img.copy())), **kw)
    assert dev.is_on_device
    assert np.array_equal(dev.to_numpy(), PM.pyr_mean_shift(torch.from_numpy(img), **kw).numpy())
