"""The port's photo modules (``rustcv_tpu_torch.ops.nlmeans``, ``dtfilter``,
``poisson``, ``inpaint``, ``hdr``) and their ``imgproc`` names, against
``rustcv_tpu`` (JAX on the CPU) and its numpy oracles on the same seeded
inputs.

Tolerances, the reference's own (``tests/test_nlmeans.py``,
``test_dtfilter.py``, ``test_poisson.py``, ``test_inpaint.py``,
``test_hdr.py``, ``test_hdr_ext.py``):
- NL-means (single, coloured, temporal): within ±1 of the JAX twin and of
  the float64 oracle;
- the domain-transform filter and the guided filter: within ±1; the
  derived ops (detail enhance, stylization, pencil sketch) within ±2;
- seamless cloning and the diffusion inpaint: within ±1;
- Mertens fusion: within 2e-3;
- the host copies (Telea, the Poisson editing extensions, MTB alignment,
  Debevec, Robertson, the tonemaps): equal to the reference's outputs."""

import numpy as np
import pytest
import torch

from rustcv_tpu import imgproc as jax_ip
from rustcv_tpu.core.mat import Mat as JMat
from rustcv_tpu.ops import dtfilter as JD
from rustcv_tpu.ops import hdr as JH
from rustcv_tpu.ops import inpaint as JI
from rustcv_tpu.ops import nlmeans as JN
from rustcv_tpu.ops import poisson as JP
from rustcv_tpu_torch import imgproc as port_ip
from rustcv_tpu_torch.core import Mat
from rustcv_tpu_torch.ops import dtfilter as PD
from rustcv_tpu_torch.ops import hdr as PH
from rustcv_tpu_torch.ops import inpaint as PI
from rustcv_tpu_torch.ops import nlmeans as PN
from rustcv_tpu_torch.ops import poisson as PP


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _diff(a, b) -> int:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max())


def _noisy(seed=5, shape=(32, 40), sigma=12):
    rng = np.random.default_rng(seed)
    clean = np.full(shape, 40.0)
    clean[8:24, 10:30] += 180.0
    return np.clip(clean + rng.normal(0, sigma, shape), 0, 255).astype(np.uint8)


def _noisy_step(h=48, w=64, seed=2):
    rng = np.random.default_rng(seed)
    img = np.full((h, w), 60.0)
    img[:, w // 2:] = 190.0
    img = np.clip(img + rng.normal(0, 12, (h, w)), 0, 255).astype(np.uint8)
    return np.stack([img] * 3, axis=-1)


@pytest.mark.parametrize("h,template,search", [(15.0, 5, 9), (10.0, 7, 21), (12.0, 3, 7)])
def test_nl_means_within_one(jax_cpu, h, template, search):
    import jax.numpy as jnp

    img = _noisy(shape=(24, 28) if search == 21 else (32, 40))
    got = PN.nl_means(_t(img), h, template, search)
    assert got.dtype == torch.uint8
    assert _diff(got, JN.nl_means(jnp.asarray(img), h, template, search)) <= 1
    assert _diff(got, PN.nl_means_numpy(img, h, template, search)) <= 1
    assert np.array_equal(PN.nl_means_numpy(img, h, template, search),
                          JN.nl_means_numpy(img, h, template, search))


def test_nl_means_colored_and_multi_within_one(jax_cpu):
    import jax.numpy as jnp

    rng = np.random.default_rng(9)
    clean = np.zeros((24, 28, 3))
    clean[...] = (60, 120, 200)
    clean[6:18, 8:20] = (200, 80, 40)
    bgr = np.clip(clean + rng.normal(0, 10, clean.shape), 0, 255).astype(np.uint8)
    got = PN.nl_means_colored(_t(bgr), 12.0, 12.0, 5, 9)
    assert _diff(got, JN.nl_means_colored(jnp.asarray(bgr), 12.0, 12.0, 5, 9)) <= 1
    frames = np.stack([_noisy(seed=s, shape=(30, 36), sigma=20) for s in range(5)])
    got = PN.nl_means_multi(_t(frames), 2, 3, h=12.0, template=5, search=9)
    assert _diff(got, JN.nl_means_multi(jnp.asarray(frames), 2, 3, h=12.0, template=5,
                                        search=9)) <= 1
    want = JN.nl_means_multi_numpy(frames, 2, 3, h=12.0, template=5, search=9)
    assert np.array_equal(PN.nl_means_multi_numpy(frames, 2, 3, h=12.0, template=5, search=9),
                          want)
    assert _diff(got, want) <= 1
    cframes = np.stack([bgr] * 3)
    assert np.array_equal(
        PN.nl_means_colored_multi_numpy(cframes, 1, 3, 12.0, 12.0, 5, 9),
        JN.nl_means_colored_multi_numpy(cframes, 1, 3, 12.0, 12.0, 5, 9))
    with pytest.raises(ValueError):
        PN.nl_means_multi(_t(frames), 0, 5)


def _dt_inputs():
    rng = np.random.default_rng(3)
    return [_noisy_step(), rng.integers(0, 256, (40, 56, 3)).astype(np.uint8),
            np.clip(rng.normal(128, 40, (64, 90, 3)), 0, 255).astype(np.uint8)]


@pytest.mark.parametrize("case", [0, 1, 2])
def test_dt_filter_within_one(jax_cpu, case):
    import jax.numpy as jnp

    img = _dt_inputs()[case]
    for ss, sr in ((60.0, 0.4), (10.0, 0.15), (60.0, 2.0)):
        got = PD.dt_filter(_t(img), _t(img), ss, sr)
        assert _diff(got, JD.dt_filter(jnp.asarray(img), jnp.asarray(img), ss, sr)) <= 1
        assert _diff(got, PD.dt_filter_numpy(img, img, ss, sr)) <= 1
    j = jnp.asarray(img)
    for name in ("edge_preserving_filter", "detail_enhance", "stylization"):
        got = getattr(PD, name)(_t(img))
        assert _diff(got, getattr(JD, name)(j)) <= 2
        assert np.array_equal(getattr(PD, name)(img), getattr(JD, name)(img))
    got, want = PD.pencil_sketch(_t(img)), JD.pencil_sketch(j)
    assert _diff(got[0], want[0]) <= 2 and _diff(got[1], want[1]) <= 2
    assert all(np.array_equal(a, b) for a, b in zip(PD.pencil_sketch(img), JD.pencil_sketch(img)))


def test_affine_scan_is_the_recursion():
    rng = np.random.default_rng(0)
    x = rng.random((37, 5)).astype(np.float64)
    w = rng.random((37, 5))
    w[0] = 0.0
    want = np.empty_like(x)
    want[0] = x[0]
    for i in range(1, 37):
        want[i] = (1 - w[i]) * x[i] + w[i] * want[i - 1]
    got = PD._affine_scan(torch.from_numpy((1 - w) * x), torch.from_numpy(w), 0).numpy()
    assert np.abs(got - want).max() < 1e-12


def test_guided_filter_within_one(jax_cpu):
    import jax.numpy as jnp

    rng = np.random.default_rng(9)
    g = rng.integers(0, 256, (40, 56)).astype(np.uint8)
    src = rng.integers(0, 256, (40, 56, 3)).astype(np.uint8)
    for s in (src, src[..., 0]):
        got = PD.guided_filter(_t(g), _t(s), radius=5)
        assert _diff(got, JD.guided_filter(jnp.asarray(g), jnp.asarray(s), radius=5)) <= 1
        assert _diff(got, PD.guided_filter(g, s, radius=5)) <= 1
        assert np.array_equal(PD.guided_filter(g, s, 5), JD.guided_filter(g, s, 5))
    f = src.astype(np.float32) / 255.0
    got = PD.guided_filter(_t(g), _t(f), radius=4)
    assert np.abs(got.numpy() - np.asarray(JD.guided_filter(jnp.asarray(g), jnp.asarray(f),
                                                            radius=4))).max() < 1e-5


def _clone_cases():
    ys, xs = np.mgrid[0:24, 0:24].astype(np.float64)
    src = np.clip(120 + 3 * xs + 2 * ys, 0, 255).astype(np.uint8)
    dst = np.tile(np.linspace(20, 90, 64).astype(np.uint8), (64, 1))
    mask = np.zeros((24, 24), bool)
    mask[3:-3, 3:-3] = True
    rng = np.random.default_rng(3)
    src3 = rng.integers(100, 200, (20, 20, 3)).astype(np.uint8)
    dst3 = rng.integers(0, 80, (48, 48, 3)).astype(np.uint8)
    return [(src, dst, mask, (30, 30)), (src3, dst3, np.ones((20, 20), bool), (24, 24)),
            (src3, dst3, np.ones((20, 20), bool), (5, 40))]


@pytest.mark.parametrize("case", [0, 1, 2])
@pytest.mark.parametrize("flags", [1, 2])
def test_seamless_clone_within_one(jax_cpu, case, flags):
    import jax.numpy as jnp

    src, dst, mask, c = _clone_cases()[case]
    got = PP.seamless_clone(src, _t(dst), mask, c, flags, max_iters=1500)
    assert isinstance(got, torch.Tensor) and got.shape == dst.shape
    assert _diff(got, JP.seamless_clone(src, jnp.asarray(dst), mask, c, flags,
                                        max_iters=1500)) <= 1
    want = PP.seamless_clone_numpy(src, dst, mask, c, flags)
    assert np.array_equal(want, JP.seamless_clone_numpy(src, dst, mask, c, flags))
    assert _diff(PP.seamless_clone(src, _t(dst), mask, c, flags), want) <= 1


def test_seamless_clone_outside_is_identity():
    src = np.full((16, 16), 200, np.uint8)
    dst = torch.full((32, 32), 50, dtype=torch.uint8)
    assert torch.equal(PP.seamless_clone(src, dst, np.ones((16, 16), bool), (200, 200)), dst)


def test_poisson_editing_extensions_are_copies():
    ys, xs = np.mgrid[0:48, 0:64].astype(np.float64)
    bump = 90.0 * np.exp(-((ys - 24) ** 2 + (xs - 32) ** 2) / (2 * 6.0 ** 2))
    img = np.stack([np.clip(60 + bump, 0, 255), np.clip(60 + 0.5 * bump, 0, 255),
                    np.full((48, 64), 120.0)], axis=-1).astype(np.uint8)
    mask = np.zeros((48, 64), bool)
    mask[8:40, 12:52] = True
    assert np.array_equal(PP.color_change(img, mask, (1.8, 1.0, 1.0)),
                          JP.color_change(img, mask, (1.8, 1.0, 1.0)))
    assert np.array_equal(PP.illumination_change(img, mask, 0.2, 0.6),
                          JP.illumination_change(img, mask, 0.2, 0.6))
    assert np.array_equal(PP.texture_flattening(img, mask, 8.0),
                          JP.texture_flattening(img, mask, 8.0))


def _inpaint_cases():
    ys, xs = np.mgrid[0:48, 0:64].astype(np.float64)
    img = np.clip(60 + 2.0 * xs + 1.0 * ys, 0, 255).astype(np.uint8)
    m = np.zeros((48, 64), bool)
    m[20:24, 10:50] = True
    m[8:40, 30:33] = True
    damaged = img.copy()
    damaged[m] = 255
    edge = np.zeros((48, 64), bool)
    edge[0:5, 0:10] = True
    edge[-3:, -8:] = True
    rng = np.random.default_rng(0)
    bgr = rng.integers(0, 255, (30, 40, 3)).astype(np.uint8)
    band = np.zeros((30, 40), bool)
    band[10:20, :] = True
    return [(damaged, m), (damaged, edge), (bgr, band)]


@pytest.mark.parametrize("case", [0, 1, 2])
def test_inpaint_within_one_and_telea_copy(jax_cpu, case):
    import jax.numpy as jnp

    img, mask = _inpaint_cases()[case]
    got = PI.inpaint_diffusion(_t(img), mask)
    assert _diff(got, JI.inpaint_diffusion(jnp.asarray(img), jnp.asarray(mask))) <= 1
    assert _diff(got, PI.inpaint_diffusion_numpy(img, mask)) <= 1
    assert np.array_equal(got.numpy()[~mask], img[~mask])
    assert np.array_equal(PI.inpaint(img, mask, 3, "telea"), JI.inpaint(img, mask, 3, "telea"))
    with pytest.raises(ValueError):
        PI.inpaint(img, mask, method="navier")


def _radiance_scene(h=64, w=96):
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    rad = np.where(xs < w / 2, 0.02, 1.0) * (1.0 + 0.4 * np.sin(xs * 1.1) * np.cos(ys * 0.9))
    return np.stack([rad, rad * 0.8, rad * 1.2], axis=-1)


def _expose(rad, t):
    return np.clip(rad * t * 255.0, 0, 255).astype(np.uint8)


def test_merge_mertens_within_tolerance(jax_cpu):
    import jax.numpy as jnp

    stack = np.stack([_expose(_radiance_scene(), t) for t in (0.25, 1.0, 8.0)])
    got = PH.merge_mertens(_t(stack))
    assert got.dtype == torch.float32 and got.shape == stack.shape[1:]
    assert np.abs(got.numpy() - np.asarray(JH.merge_mertens(jnp.asarray(stack)))).max() <= 2e-3
    want = PH.merge_mertens_numpy(list(stack))
    assert np.array_equal(want, JH.merge_mertens_numpy(list(stack)))
    assert np.abs(got.numpy() - want).max() <= 2e-3


def test_hdr_host_copies_equal():
    rng = np.random.default_rng(4321)
    radiance = (rng.random((24, 32, 3)) ** 2 * 4 + 0.02).astype(np.float32)
    times = np.array([0.0125, 0.05, 0.2, 0.8], np.float32)
    imgs = [np.clip(radiance * 255 * t * 4, 0, 255).astype(np.uint8) for t in times]
    assert np.array_equal(PH.merge_robertson_numpy(imgs, times),
                          JH.merge_robertson_numpy(imgs, times))
    resp = PH.calibrate_robertson(imgs, times)
    assert np.array_equal(resp, JH.calibrate_robertson(imgs, times))
    assert np.array_equal(PH.calibrate_debevec(imgs, times), JH.calibrate_debevec(imgs, times))
    hdr_img = (rng.random((24, 32, 3)).astype(np.float32) ** 2 * 8 + 0.02)
    for fn in ("tonemap_drago_numpy", "tonemap_mantiuk_numpy", "tonemap_reinhard_numpy",
               "tonemap_reinhard_cv"):
        assert np.array_equal(getattr(PH, fn)(hdr_img), getattr(JH, fn)(hdr_img)), fn
    yy, xx = np.mgrid[0:96, 0:128].astype(np.float64)
    base = (120 + 80 * np.sin(xx / 9.0) * np.cos(yy / 7.0)).astype(np.uint8)
    moved = JH._shift2d(base, 4, -6)
    assert PH.align_mtb_shift(base, moved) == JH.align_mtb_shift(base, moved)
    stack = [np.stack([base] * 3, -1), np.stack([moved] * 3, -1), np.stack([base] * 3, -1)]
    assert all(np.array_equal(a, b) for a, b in zip(PH.align_mtb(stack), JH.align_mtb(stack)))


def test_photo_wrappers_four_ways(jax_cpu):
    """The ``imgproc`` names on the port's host Mat and CPU-tensor Mat
    against the reference's host and JAX Mats."""
    gray = _noisy(shape=(48, 64))
    step = _noisy_step()
    stack = [_expose(_radiance_scene(), t) for t in (0.25, 1.0, 8.0)]
    src, dst, mask, c = _clone_cases()[1]
    inp, hole = _inpaint_cases()[0]

    def ports(a):
        return (Mat.from_array(a, device="cpu"), Mat.from_device(_t(a.copy())))

    def refs(a):
        host, dev = JMat.from_array(a), JMat.from_array(a)
        dev.device()
        return host, dev

    def same_side(out, p):
        assert out.is_on_device == p.is_on_device

    for k in range(2):
        gp, gr = ports(gray)[k], refs(gray)[k]
        out = port_ip.fast_nl_means_denoising(gp, 15.0, 5, 9)
        same_side(out, gp)
        want = jax_ip.fast_nl_means_denoising(gr, 15.0, 5, 9)
        assert _diff(out.to_numpy(), want.to_numpy()) <= 1
        sp, sr = ports(step)[k], refs(step)[k]
        out = port_ip.fast_nl_means_denoising_colored(sp, 12.0, 12.0, 5, 9)
        same_side(out, sp)
        assert _diff(out.to_numpy(), jax_ip.fast_nl_means_denoising_colored(
            sr, 12.0, 12.0, 5, 9).to_numpy()) <= 1
        out = port_ip.guided_filter(gp, sp, 5)
        same_side(out, sp)
        assert _diff(out.to_numpy(), jax_ip.guided_filter(gr, sr, 5).to_numpy()) <= 1
        for name in ("edge_preserving_filter", "detail_enhance", "stylization"):
            out = getattr(port_ip, name)(sp)
            same_side(out, sp)
            assert _diff(out.to_numpy(), getattr(jax_ip, name)(sr).to_numpy()) <= 2, name
        (sk, co), (wsk, wco) = port_ip.pencil_sketch(sp), jax_ip.pencil_sketch(sr)
        assert _diff(sk.to_numpy(), wsk.to_numpy()) <= 2
        assert _diff(co.to_numpy(), wco.to_numpy()) <= 2
        dp, dr = ports(dst)[k], refs(dst)[k]
        out = port_ip.seamless_clone(Mat.from_array(src, device="cpu"), dp, mask, c)
        same_side(out, dp)
        assert _diff(out.to_numpy(), jax_ip.seamless_clone(JMat.from_array(src), dr, mask,
                                                           c).to_numpy()) <= 1
        ip_, ir = ports(inp)[k], refs(inp)[k]
        for method in ("telea", "diffusion"):
            assert _diff(port_ip.inpaint(ip_, hole, method=method).to_numpy(),
                         jax_ip.inpaint(ir, hole, method=method).to_numpy()) <= 1
        for fn in ("color_change", "illumination_change", "texture_flattening"):
            assert np.array_equal(getattr(port_ip, fn)(sp, hole[:48, :64]).to_numpy(),
                                  getattr(jax_ip, fn)(sr, hole[:48, :64]).to_numpy()), fn
        # the reference's wrapper takes arrays (its Mats keep a channel axis
        # that its temporal twin and oracle refuse); the port's takes both
        arrays = [_noisy(seed=s, shape=(30, 36), sigma=20) for s in range(5)]
        got = port_ip.fast_nl_means_denoising_multi([ports(a)[k] for a in arrays], 2, 3, 12.0,
                                                    5, 9)
        assert isinstance(got, np.ndarray) and got.shape == (30, 36)
        assert _diff(got, jax_ip.fast_nl_means_denoising_multi(arrays, 2, 3, 12.0, 5, 9)) <= 1
        mats = [ports(a)[k] for a in stack]
        got = port_ip.merge_mertens(mats)
        assert isinstance(got, np.ndarray)
        assert np.abs(got - jax_ip.merge_mertens([refs(a)[k] for a in stack])).max() <= 2e-3
    cstack = [step, step, step]
    args = (cstack, 1, 3, 12.0, 12.0, 5, 9)
    assert np.array_equal(port_ip.fast_nl_means_denoising_colored_multi(*args),
                          jax_ip.fast_nl_means_denoising_colored_multi(*args))
    times = np.array([0.25, 1.0, 8.0], np.float32)
    hmats = [Mat.from_array(a, device="cpu") for a in stack]
    jmats = [JMat.from_array(a) for a in stack]
    assert np.array_equal(port_ip.merge_robertson(hmats, times),
                          jax_ip.merge_robertson(jmats, times))
    assert np.array_equal(port_ip.calibrate_robertson(hmats, times),
                          jax_ip.calibrate_robertson(jmats, times))
    hdr_img = np.random.default_rng(1).random((24, 32, 3)).astype(np.float32) * 4 + 0.02
    assert np.array_equal(port_ip.tonemap_drago(hdr_img), jax_ip.tonemap_drago(hdr_img))
    assert np.array_equal(port_ip.tonemap_mantiuk(hdr_img), jax_ip.tonemap_mantiuk(hdr_img))
    aligned = port_ip.align_mtb(hmats)
    assert all(np.array_equal(a.to_numpy(), b.to_numpy())
               for a, b in zip(aligned, jax_ip.align_mtb(jmats)))
