"""The port's thinning and anisotropic diffusion
(``rustcv_tpu_torch.ops.morphx``), its multi-band blend and gain
compensation (``ops.blend``) and their ``imgproc`` wrappers, against
``rustcv_tpu.ops.morphx`` / ``blend`` (JAX on the CPU) and their float64
or exact numpy oracles on the same seeded inputs.

Tolerances: ``thinning`` exact (a binary algorithm); ``anisotropic_diffusion``
and ``multi_band_blend`` within ±1 LSB of the float64 oracles and of the
JAX functions (float32 against float64, the reference's documented
tolerance); ``gain_compensation`` exact (the same float64 host code)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rustcv_tpu.core as jax_core
import rustcv_tpu.imgproc as jax_ip
from rustcv_tpu.ops import blend as JB
from rustcv_tpu.ops import morphx as JM
from rustcv_tpu_torch import imgproc as port_ip
from rustcv_tpu_torch.core import Mat
from rustcv_tpu_torch.ops import blend as PB
from rustcv_tpu_torch.ops import morphx as PM

torch.set_num_threads(2)

LSB = 1  # ±1 LSB: float32 diffusion and pyramids against float64


def _img(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _within(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, want.shape)
    assert np.abs(got.astype(np.int64) - want.astype(np.int64)).max(initial=0) <= tol


def _mask(kind, shape, seed):
    rng = np.random.default_rng(seed)
    if kind == "noise":
        return (rng.random(shape) > 0.45).astype(np.uint8) * 255
    y, x = np.mgrid[0:shape[0], 0:shape[1]]
    if kind == "blobs":  # thick shapes with holes: long thinning runs
        r1 = (y - shape[0] / 3) ** 2 + (x - shape[1] / 3) ** 2
        r2 = (y - 2 * shape[0] / 3) ** 2 + (x - 2 * shape[1] / 3) ** 2
        return (((r1 < 60) & (r1 > 6)) | (r2 < 40) | ((y > 2) & (y < 7))).astype(np.uint8)
    if kind == "border":  # set pixels on the image border (zero padding)
        m = np.zeros(shape, np.uint8)
        m[:, :4] = 1
        m[-3:, :] = 7
        return m
    return np.zeros(shape, np.uint8)  # empty


@pytest.mark.parametrize("kind", ["noise", "blobs", "border", "empty"])
@pytest.mark.parametrize("shape", [(24, 35), (31, 40)])
def test_thinning(kind, shape):
    m = _mask(kind, shape, 1)
    got, passes = PM.thinning_passes(torch.from_numpy(m))
    assert passes >= 1 and got.dtype == torch.uint8
    want = JM.thinning_numpy(m)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(PM.thinning(torch.from_numpy(m)).numpy(),
                                  np.asarray(JM.thinning(jnp.asarray(m))))
    np.testing.assert_array_equal(PM.thinning_numpy(m), want)


@pytest.mark.parametrize("kind", ["noise", "blobs"])
def test_thinning_of_a_skeleton_is_its_fixed_point(kind):
    """An already-thin mask: one double pass, which changes nothing."""
    skel = JM.thinning_numpy(_mask(kind, (31, 40), 2))
    assert skel.any()
    got, passes = PM.thinning_passes(torch.from_numpy(skel * 255))
    assert passes == 1
    np.testing.assert_array_equal(got.numpy(), skel)


def test_thinning_refuses_a_non_2d_mask():
    with pytest.raises(ValueError):
        PM.thinning(torch.zeros(2, 3, 4, dtype=torch.uint8))


DIFFUSION = {  # name → (alpha, k, niters)
    "default": (0.15, 20.0, 10),
    "strong": (0.25, 5.0, 7),
    "one_pass": (0.1, 40.0, 1),
}


@pytest.mark.parametrize("name", list(DIFFUSION))
@pytest.mark.parametrize("shape", [(24, 35, 3), (23, 34)])
def test_anisotropic_diffusion(name, shape):
    alpha, k, n = DIFFUSION[name]
    img = _img(shape, 3)
    got = PM.anisotropic_diffusion(torch.from_numpy(img), alpha, k, n).numpy()
    _within(got, JM.anisotropic_diffusion_numpy(img, alpha, k, n), LSB)
    _within(got, np.asarray(JM.anisotropic_diffusion(jnp.asarray(img), alpha, k, n)), LSB)
    _within(PM.anisotropic_diffusion_numpy(img, alpha, k, n),
            JM.anisotropic_diffusion_numpy(img, alpha, k, n), 0)


def test_anisotropic_diffusion_of_floats():
    x = np.random.default_rng(4).uniform(0, 100, (12, 17)).astype(np.float32)
    got = PM.anisotropic_diffusion(torch.from_numpy(x), 0.2, 15.0, 5).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, JM.anisotropic_diffusion_numpy(x, 0.2, 15.0, 5), atol=1e-3)
    np.testing.assert_allclose(got, np.asarray(JM.anisotropic_diffusion(jnp.asarray(x), 0.2,
                                                                          15.0, 5)), atol=1e-3)


def _blend_mask(kind, shape):
    h, w = shape[:2]
    y, x = np.mgrid[0:h, 0:w]
    if kind == "half":
        return (x < w // 2).astype(np.float64)
    if kind == "bool_disc":
        return (y - h / 2) ** 2 + (x - w / 3) ** 2 < (h / 3) ** 2
    return np.clip(x / (w - 1.0), 0, 1)  # a ramp


@pytest.mark.parametrize("mask", ["half", "bool_disc", "ramp"])
@pytest.mark.parametrize("shape,bands", [((24, 35, 3), 5), ((23, 34), 5), ((40, 64, 3), 2),
                                         ((9, 11), 5)])
def test_multi_band_blend(mask, shape, bands):
    a, b = _img(shape, 5), _img(shape, 6)
    m = _blend_mask(mask, shape)
    got = PB.multi_band_blend(torch.from_numpy(a), torch.from_numpy(b), m, bands).numpy()
    _within(got, JB.multi_band_blend_numpy(a, b, m, bands), LSB)
    _within(got, np.asarray(JB.multi_band_blend(jnp.asarray(a), jnp.asarray(b), jnp.asarray(m),
                                                bands)), LSB)
    _within(PB.multi_band_blend(a, b, m, bands).numpy(), got, 0)  # numpy images
    _within(PB.multi_band_blend_numpy(a, b, m, bands), JB.multi_band_blend_numpy(a, b, m, bands),
            0)


@pytest.mark.parametrize("n", [2, 3])
def test_gain_compensation(n):
    rng = np.random.default_rng(7)
    base = _img((20, 30, 3), 8).astype(np.float64)
    images = [np.clip(base * g, 0, 255).astype(np.uint8) for g in rng.uniform(0.7, 1.3, n)]
    masks = [np.zeros((20, 30), bool) for _ in range(n)]
    for i, m in enumerate(masks):
        m[:, 5 * i:5 * i + 20] = True
    np.testing.assert_array_equal(PB.gain_compensation(images, masks),
                                  JB.gain_compensation(images, masks))
    disjoint = [np.eye(20, 30, k=0, dtype=bool), np.eye(20, 30, k=25, dtype=bool)]
    np.testing.assert_array_equal(PB.gain_compensation(images[:2], disjoint), np.ones(2))


def test_voronoi_seam_is_left_for_the_ccl_module(monkeypatch):
    """``voronoi_seam`` arrived with the ``ccl`` module: it splits the
    overlap by ``ccl``'s exact L2 distance, as the reference's does, and
    ``imgproc`` re-exports it."""
    from rustcv_tpu_torch.ops import ccl

    m1 = np.zeros((30, 40), np.uint8)
    m1[:, :28] = 1
    m2 = np.zeros((30, 40), np.uint8)
    m2[4:, 12:] = 255
    calls = []
    real = ccl.distance_transform_l2_with_labels
    monkeypatch.setattr(ccl, "distance_transform_l2_with_labels",
                        lambda m: calls.append(m.shape) or real(m))
    got, want = PB.voronoi_seam(m1, m2), JB.voronoi_seam(m1, m2)
    assert calls == [(30, 40), (30, 40)]
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert port_ip.voronoi_seam is PB.voronoi_seam


# -- the imgproc wrappers: the port's host and device (CPU tensor) Mats against
#    the reference's host and device (JAX) Mats ---------------------------------


def _mats(img):
    port = (Mat.from_array(img.copy(), device="cpu"), Mat.from_device(torch.from_numpy(img.copy())))
    ref = (jax_core.Mat.from_array(img.copy()), jax_core.Mat.from_device(jnp.asarray(img)))
    return port, ref


WRAPPERS = {  # name → (call, tolerance, image kinds)
    "thinning": (lambda ip, m: ip.thinning(m), 0, "mask"),
    "anisotropic_diffusion": (lambda ip, m: ip.anisotropic_diffusion(m), LSB, "bgr gray"),
    "anisotropic_diffusion_k5": (lambda ip, m: ip.anisotropic_diffusion(m, 0.2, 5.0, 4), LSB,
                                 "bgr"),
}


@pytest.mark.parametrize("name,kind", [(n, k) for n, v in WRAPPERS.items()
                                       for k in v[2].split()])
def test_wrappers_four_ways(name, kind):
    call, tol, _ = WRAPPERS[name]
    if kind == "mask":
        img = (_mask("blobs", (31, 40), 0) * 255)[..., None]
    else:
        img = _img((23, 35, 3) if kind == "bgr" else (23, 35, 1), len(name))
    (p_host, p_dev), (r_host, r_dev) = _mats(img)
    got_host, got_dev = call(port_ip, p_host), call(port_ip, p_dev)
    assert not got_host.is_on_device and got_dev.is_on_device
    _within(got_host.to_numpy(), call(jax_ip, r_host).to_numpy(), tol)
    _within(got_dev.to_numpy(), call(jax_ip, r_dev).to_numpy(), tol)


def test_reexported_blend_matches_the_references():
    a, b = _img((24, 35, 3), 9), _img((24, 35, 3), 10)
    m = _blend_mask("half", a.shape)
    _within(port_ip.multi_band_blend(torch.from_numpy(a), torch.from_numpy(b), m).numpy(),
            np.asarray(jax_ip.multi_band_blend(jnp.asarray(a), jnp.asarray(b), jnp.asarray(m))),
            LSB)
    assert port_ip.gain_compensation is PB.gain_compensation
