"""The port's transforms, phase correlation and template matching
(``rustcv_tpu_torch.ops.transform``, ``registration``, ``template``) and
their ``imgproc`` names, against ``rustcv_tpu`` (JAX on the CPU) and its
float64 numpy oracles on the same seeded inputs.

Tolerances, the reference's own (``tests/test_transform_polar.py``,
``tests/test_registration.py``, ``tests/test_template.py``):
- DCT/IDCT: atol 1e-4 against the float64 oracle and against JAX, on
  unit-normal inputs as the reference's test;
- the DFT on ``torch.fft`` against numpy's: atol 2e-5 of the spectrum's
  largest magnitude; the inverse round trip atol 1e-3;
- phase correlation: shift atol 1e-3 and response within 1e-3 of JAX and
  of the float64 oracle, the integer peak at the same place;
- template matching: max |Δ| / max(1, max |oracle|) < 1e-4 on both routes
  (conv below 256 px of area, FFT above), the peak at the template's
  source; ``min_max_loc`` exact (values and the first extremum in raster
  order, ties included)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rustcv_tpu.core as jax_core
import rustcv_tpu.imgproc as jax_ip
from rustcv_tpu.capture import simulation as sim
from rustcv_tpu.ops import golden as G
from rustcv_tpu.ops import registration as JR
from rustcv_tpu.ops import template as JT
from rustcv_tpu.ops import transform as JX
from rustcv_tpu_torch import imgproc as port_ip
from rustcv_tpu_torch.core import Mat
from rustcv_tpu_torch.ops import registration as PR
from rustcv_tpu_torch.ops import template as PT
from rustcv_tpu_torch.ops import transform as PX

torch.set_num_threads(2)


def _tex(seed, h, w):
    rng = np.random.default_rng(seed)
    return G.gaussian5_u8(rng.integers(0, 256, (h, w), dtype=np.uint8))


def _scene(seed, w, h, noise_seed):
    img = G.bgr_to_gray(sim.synth_bgr(w, h, seed))
    noise = np.random.default_rng(noise_seed).integers(0, 12, size=img.shape, dtype=np.uint8)
    return np.clip(img.astype(np.int32) + noise, 0, 255).astype(np.uint8)


# --- DCT / DFT --------------------------------------------------------------


@pytest.mark.parametrize("shape", [(24, 35), (1, 40), (30, 1), (48, 64)])
@pytest.mark.parametrize("inverse", [False, True])
def test_dct_matches_jax_and_oracle(shape, inverse):
    a = np.random.default_rng(sum(shape)).normal(0, 1, shape).astype(np.float32)
    got = PX.dct(torch.from_numpy(a), inverse=inverse).numpy()
    np.testing.assert_allclose(got, PX.dct_numpy(a, inverse=inverse), atol=1e-4)
    np.testing.assert_allclose(got, np.asarray(JX.dct(jnp.asarray(a), inverse=inverse)),
                               atol=1e-4)
    np.testing.assert_array_equal(PX.dct_numpy(a, inverse), JX.dct_numpy(a, inverse))


def test_idct_dispatch_and_round_trip():
    a = np.random.default_rng(0).random((16, 24))
    np.testing.assert_array_equal(PX.idct(a), JX.idct(a))  # numpy → the float64 oracle
    t = torch.from_numpy(a.astype(np.float32))
    np.testing.assert_allclose(PX.idct(PX.dct(t)).numpy(), a, atol=1e-4)


def test_dft2_planes_match_numpy_fft():
    x = np.random.default_rng(2).random((48, 64)).astype(np.float32) * 255
    re, im = PX.dft2_planes(torch.from_numpy(x))
    f = np.fft.fft2(x.astype(np.float64))
    scale = np.abs(f).max()
    np.testing.assert_allclose(re.numpy(), f.real, atol=2e-5 * scale)
    np.testing.assert_allclose(im.numpy(), f.imag, atol=2e-5 * scale)
    jre, jim = JX.dft2_planes(jnp.asarray(x))
    np.testing.assert_allclose(re.numpy(), np.asarray(jre), atol=2e-5 * scale)
    np.testing.assert_allclose(im.numpy(), np.asarray(jim), atol=2e-5 * scale)


@pytest.mark.parametrize("scale", [True, False])
def test_idft2_planes_round_trip(scale):
    x = np.random.default_rng(3).random((40, 56)).astype(np.float32) * 100
    re, im = PX.dft2_planes(torch.from_numpy(x))
    rr, ri = PX.idft2_planes(re, im, scale=scale)
    div = 1.0 if scale else 40 * 56
    np.testing.assert_allclose(rr.numpy() / div, x, atol=1e-3)
    assert float(ri.abs().max()) / div < 1e-3
    jr, ji = JX.idft2_planes(*JX.dft2_planes(jnp.asarray(x)), scale=scale)
    np.testing.assert_allclose(rr.numpy() / div, np.asarray(jr) / div, atol=1e-3)


@pytest.mark.parametrize("conj_b", [False, True])
def test_spectrum_products(conj_b):
    rng = np.random.default_rng(4)
    a = rng.random((24, 32)) + 1j * rng.random((24, 32))
    b = rng.random((24, 32)) + 1j * rng.random((24, 32))
    want = JX.mul_spectrums(a, b, conj_b=conj_b)
    np.testing.assert_array_equal(PX.mul_spectrums(a, b, conj_b=conj_b), want)
    got = PX.mul_spectrums(torch.from_numpy(a), torch.from_numpy(b), conj_b=conj_b).numpy()
    np.testing.assert_allclose(got, want, atol=1e-12)
    re, im = PX.mul_spectrums_planes((a.real, a.imag), (b.real, b.imag), conj_b=conj_b)
    np.testing.assert_allclose(re, want.real, atol=1e-12)
    np.testing.assert_allclose(im, want.imag, atol=1e-12)


def test_dft_idft_tensor_and_numpy():
    x = np.random.default_rng(5).random((16, 20)).astype(np.float32)
    np.testing.assert_array_equal(PX.dft(x), JX.dft(x))
    np.testing.assert_array_equal(PX.idft(PX.dft(x), scale=False), JX.idft(JX.dft(x), scale=False))
    f = PX.dft(torch.from_numpy(x))
    np.testing.assert_allclose(f.numpy(), np.asarray(JX.dft(jnp.asarray(x))), atol=2e-5 * 320)
    for scale in (True, False):
        back = PX.idft(f, scale=scale).numpy()
        np.testing.assert_allclose(back.real, x * (1 if scale else 320), atol=1e-3 * (1 if scale else 320))
    u8 = (x * 255).astype(np.uint8)
    np.testing.assert_allclose(PX.dft(torch.from_numpy(u8)).numpy(), np.fft.fft2(u8), atol=1e-1)


@pytest.mark.parametrize("n", [1, 7, 97, 100, 481, 1080, 1921, 4095])
def test_get_optimal_dft_size(n):
    assert PX.get_optimal_dft_size(n) == JX.get_optimal_dft_size(n)


# --- phase correlation ------------------------------------------------------

SHIFTS = [(5, (3, -7)), (6, (0, 0)), (7, (-4, 9)), (8, (11, 2))]


@pytest.mark.parametrize("seed,shift", SHIFTS)
@pytest.mark.parametrize("window", [True, False])
def test_phase_correlate_matches_jax_and_oracle(seed, shift, window):
    dy, dx = shift
    base = _tex(seed, 96, 128)
    nxt = np.roll(np.roll(base, dx, axis=1), dy, axis=0)
    d_j, r_j = JR.phase_correlate(jnp.asarray(base), jnp.asarray(nxt), window=window)
    d_n, r_n = JR.phase_correlate_numpy(base, nxt, window=window)
    for fn in (PR.phase_correlate, PR.phase_correlate_matmul):
        d, r = fn(torch.from_numpy(base), torch.from_numpy(nxt), window=window)
        np.testing.assert_allclose(d.numpy(), np.asarray(d_j), atol=1e-3)
        np.testing.assert_allclose(d.numpy(), d_n, atol=1e-3)
        assert abs(float(r) - float(r_j)) < 1e-3 and abs(float(r) - r_n) < 1e-3
        assert np.array_equal(np.round(d.numpy()), np.round(d_n))  # the same integer peak
    d_p, r_p = PR.phase_correlate_numpy(base, nxt, window=window)
    np.testing.assert_array_equal(d_p, d_n)
    assert r_p == r_n


def test_phase_correlate_sub_pixel_and_iterative():
    base = _tex(9, 64, 80)
    m = np.array([[1.0, 0.0, 2.4], [0.0, 1.0, -1.3]])
    from rustcv_tpu.ops.warp import warp_affine_numpy

    nxt = warp_affine_numpy(base, m, (80, 64))
    d, _ = PR.phase_correlate(torch.from_numpy(base), torch.from_numpy(nxt))
    np.testing.assert_allclose(d.numpy(), np.asarray(JR.phase_correlate(
        jnp.asarray(base), jnp.asarray(nxt))[0]), atol=1e-3)
    got = PR.phase_correlate_iterative(base, nxt)
    want = JR.phase_correlate_iterative(base, nxt)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]


def test_peak_ties_take_the_first_in_raster_order():
    r = torch.zeros((8, 10))
    r[2, 7] = r[5, 1] = r[2, 3] = 1.0
    d, resp = PR._peak_refine(r, 8, 10)
    assert float(resp) == 1.0 and d.numpy().tolist() == [3.0, 2.0]


# --- template matching ------------------------------------------------------


@pytest.fixture(scope="module")
def scene():
    img = _scene(7, 160, 120, 1)
    return img, img[41:65, 88:120].copy(), (88, 41)


@pytest.mark.parametrize("method", PT.METHODS)
@pytest.mark.parametrize("size", [(12, 16), (24, 32)])  # conv route, FFT route
def test_match_template_matches_jax_and_oracle(scene, method, size):
    img, _, _ = scene
    th, tw = size
    tmpl = img[41:41 + th, 88:88 + tw].copy()
    assert (th * tw >= PT.FFT_AREA_THRESHOLD) == (size == (24, 32))
    want = JT.match_template_numpy(img, tmpl, method)
    got = PT.match_template(torch.from_numpy(img), torch.from_numpy(tmpl), method).numpy()
    ref = np.asarray(JT.match_template(jnp.asarray(img), jnp.asarray(tmpl), method))
    assert got.shape == want.shape == ref.shape and got.dtype == np.float32
    scale = max(1.0, float(np.abs(want).max()))
    assert np.max(np.abs(got - want)) / scale < 1e-4
    assert np.max(np.abs(got - ref)) / scale < 1e-4
    mn, mx, mnloc, mxloc = PT.min_max_loc(torch.from_numpy(got))
    assert (mnloc if method == "sqdiff" else mxloc) == (88, 41)
    np.testing.assert_array_equal(PT.match_template_numpy(img, tmpl, method), want)


def test_match_template_fft_route_correlates_the_centred_image():
    """The FFT's float32 rounding grows with its input's energy, which an
    image's mean dominates. On this mid-grey, low-contrast scene the map of
    the image as it is sits 3.5e-5 off the float64 oracle; the port
    correlates the image less its integer mean and stays within 1e-5."""
    from rustcv_tpu_torch.probes.template_rounding import _uncentred_ccoeff

    img = (128 + np.random.default_rng(5).integers(0, 16, (120, 160))).astype(np.uint8)
    tmpl = img[41:65, 88:120].copy()
    assert tmpl.size >= PT.FFT_AREA_THRESHOLD
    want = JT.match_template_numpy(img, tmpl, "ccoeff_normed")
    got = PT.match_template(torch.from_numpy(img), torch.from_numpy(tmpl)).numpy()
    assert np.abs(got - want).max() < 1e-5
    uncentred = _uncentred_ccoeff(torch.from_numpy(img), torch.from_numpy(tmpl))
    assert np.abs(uncentred - want).max() > 1e-5


def test_match_template_flat_windows_are_zero():
    img = torch.full((40, 50), 128, dtype=torch.uint8)
    tmpl = torch.full((8, 8), 77, dtype=torch.uint8)
    for method in ("ccoeff_normed", "ccorr_normed"):
        assert torch.isfinite(PT.match_template(img, tmpl, method)).all()
    assert (PT.match_template(img, tmpl, "ccoeff_normed") == 0).all()
    with pytest.raises(ValueError):
        PT.match_template(img, tmpl, "nope")


def test_window_sums_are_exact_int64():
    """The window sums the reference forms with uint32 wraparound are exact
    int64 integral-image differences here, at a size where uint32 prefix
    sums wrap (255² · 300 · 300 > 2³²)."""
    img = np.full((300, 300), 255, np.uint8)
    s1, s2 = PT._window_sums(torch.from_numpy(img), 64, 64)
    assert float(s1[0, 0]) == 255 * 64 * 64 and float(s2[-1, -1]) == np.float32(255 * 255 * 64 * 64)


@pytest.mark.parametrize("case", ["ties", "random", "negative_zero", "single"])
def test_min_max_loc_exact(case):
    rng = np.random.default_rng(len(case))
    a = {"ties": np.array([[1, 3, 3], [0, 3, 0], [0, 2, 1]], np.float32),
         "random": rng.normal(size=(17, 23)).astype(np.float32),
         "negative_zero": np.array([[0.0, -0.0], [1.0, 1.0]], np.float32),
         "single": np.array([[4.5]], np.float32)}[case]
    want = JT.min_max_loc(a)
    assert PT.min_max_loc(a) == want
    assert PT.min_max_loc(torch.from_numpy(a)) == want
    assert port_ip.min_max_loc(torch.from_numpy(a)) == jax_ip.min_max_loc(a)


# --- imgproc names, four ways -----------------------------------------------


def _mats(img):
    port = (Mat.from_array(img.copy(), device="cpu"), Mat.from_device(torch.from_numpy(img.copy())))
    ref = (jax_core.Mat.from_array(img.copy()), jax_core.Mat.from_device(jnp.asarray(img)))
    return port, ref


@pytest.mark.parametrize("method", PT.METHODS)
@pytest.mark.parametrize("th,tw", [(10, 12), (20, 16)])
@pytest.mark.parametrize("kind", ["gray", "bgr"])
def test_match_template_wrapper_four_ways(method, th, tw, kind):
    # noise keeps the windows' variances off zero, as the reference's tests do
    noise = np.random.default_rng(2).integers(0, 12, (72, 96, 3), dtype=np.uint8)
    bgr = np.clip(sim.synth_bgr(96, 72, 4).astype(np.int32) + noise, 0, 255).astype(np.uint8)
    img = bgr if kind == "bgr" else G.bgr_to_gray(bgr)[..., None]
    (ph, pd), (rh, rd) = _mats(img)
    (pth, ptd), (rth, rtd) = _mats(img[20:20 + th, 30:30 + tw].copy())
    host, dev = port_ip.match_template(ph, pth, method), port_ip.match_template(pd, ptd, method)
    want_h, want_d = jax_ip.match_template(rh, rth, method), jax_ip.match_template(rd, rtd, method)
    np.testing.assert_array_equal(host, want_h)  # the same float64 oracle
    # The device Mats against the reference's host Mat (its float64 oracle)
    # at the reference's device-vs-oracle tolerance; the reference's own
    # float32 device map can sit up to 2e-4 off that oracle on this scene,
    # so against it only the extrema's places are held.
    scale = max(1.0, float(np.abs(want_h).max()))
    assert isinstance(dev, np.ndarray) and np.max(np.abs(dev - want_h)) / scale < 1e-4
    loc = 2 if method == "sqdiff" else 3
    assert port_ip.min_max_loc(dev)[loc] == jax_ip.min_max_loc(want_d)[loc] == (30, 20)
    mixed = port_ip.match_template(pd, pth, method)  # a host template against a device image
    assert np.max(np.abs(mixed - dev)) == 0


@pytest.mark.parametrize("window", [True, False])
def test_phase_correlate_wrapper_four_ways(window):
    base = _tex(11, 48, 64)[..., None]
    nxt = np.roll(base, (2, -3), (0, 1))
    (ph, pd), (rh, rd) = _mats(base)
    (nh, nd), (qh, qd) = _mats(nxt)
    d_h, r_h = port_ip.phase_correlate(ph, nh, window=window)
    w_h, s_h = jax_ip.phase_correlate(rh, qh, window=window)
    np.testing.assert_array_equal(d_h, w_h)
    assert r_h == s_h
    d_d, r_d = port_ip.phase_correlate(pd, nd, window=window)
    w_d, s_d = jax_ip.phase_correlate(rd, qd, window=window)
    np.testing.assert_allclose(d_d, w_d, atol=1e-3)
    assert abs(r_d - s_d) < 1e-3 and isinstance(r_d, float)


def test_transform_names_in_imgproc():
    x = np.random.default_rng(6).random((12, 18)).astype(np.float32)
    t = torch.from_numpy(x)
    np.testing.assert_allclose(port_ip.dct(t).numpy(), np.asarray(jax_ip.dct(jnp.asarray(x))), atol=1e-4)
    np.testing.assert_array_equal(port_ip.idct(x.astype(np.float64)), jax_ip.idct(x.astype(np.float64)))
    np.testing.assert_array_equal(port_ip.dft(x), jax_ip.dft(x))
    np.testing.assert_array_equal(port_ip.idft(jax_ip.dft(x)), jax_ip.idft(jax_ip.dft(x)))
    a = jax_ip.dft(x)
    np.testing.assert_array_equal(port_ip.mul_spectrums(a, a, True), jax_ip.mul_spectrums(a, a, True))
    assert port_ip.get_optimal_dft_size(1081) == jax_ip.get_optimal_dft_size(1081)
    base = _tex(12, 48, 64)
    nxt = np.roll(base, (1, 2), (0, 1))
    got, want = port_ip.phase_correlate_iterative(base, nxt), jax_ip.phase_correlate_iterative(base, nxt)
    np.testing.assert_array_equal(got[0], want[0])
