"""The port's bicubic, nearest-neighbour and area resizes
(``rustcv_tpu_torch.ops.resize``), their tables (``ops.golden``) and
``imgproc.resize`` in every mode, against ``rustcv_tpu.ops.resize`` (JAX on
the CPU) and the frozen oracle ``rustcv_tpu.ops.golden`` on the same seeded
inputs. Every mode is a fixed-point or integer spec: the tolerance is
exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rustcv_tpu.core as jax_core
import rustcv_tpu.imgproc as jax_ip
from rustcv_tpu.ops import golden as G
from rustcv_tpu.ops import resize as J
from rustcv_tpu_torch import imgproc as port_ip
from rustcv_tpu_torch.core import Mat
from rustcv_tpu_torch.ops import golden as PG
from rustcv_tpu_torch.ops import resize as P

torch.set_num_threads(2)

MODES = ("resize_bicubic", "resize_nearest", "resize_area")
# (dst_w, dst_h) from a 35 × 24 source: integer and fractional downscales,
# upscales, a mixed ratio and a single pixel.
SIZES = [(7, 8), (5, 6), (17, 13), (70, 48), (50, 31), (35, 24), (1, 1)]


def _img(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("src,dst", [(24, 8), (35, 17), (5, 40), (1, 3), (1920, 640)])
def test_tables_are_goldens(src, dst):
    for a, b in zip(PG.resize_bicubic_coeffs(src, dst), G.resize_bicubic_coeffs(src, dst)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(PG.resize_nearest_coeffs(src, dst),
                                  G.resize_nearest_coeffs(src, dst))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dw,dh", SIZES)
def test_resize_matches_jax_and_golden(mode, dw, dh):
    x = _img((2, 24, 35, 3), seed=dw * dh)
    got = getattr(P, mode)(torch.from_numpy(x), dw, dh).numpy()
    np.testing.assert_array_equal(got, np.asarray(getattr(J, mode)(jnp.asarray(x), dw, dh)))
    np.testing.assert_array_equal(got[1], getattr(G, mode)(x[1], dw, dh))


@pytest.mark.parametrize("dw,dh", [(13, 9), (70, 50)])
def test_bicubic_of_a_gray_plane(dw, dh):
    g = _img((24, 35), seed=dw)
    got = P.resize_bicubic(torch.from_numpy(g), dw, dh).numpy()
    assert got.shape == (dh, dw)
    np.testing.assert_array_equal(got, np.asarray(J.resize_bicubic(jnp.asarray(g), dw, dh)))
    np.testing.assert_array_equal(got, G.resize_bicubic(g, dw, dh))


def test_bicubic_keeps_flat_images_flat():
    flat = torch.full((9, 13, 3), 201, dtype=torch.uint8)
    assert (P.resize_bicubic(flat, 31, 5) == 201).all()


@pytest.mark.parametrize("interpolation", ["bilinear", "nearest", "area", "cubic"])
@pytest.mark.parametrize("dw,dh", [(17, 12), (70, 48)])
@pytest.mark.parametrize("channels", [3, 1])
def test_imgproc_resize_four_ways(interpolation, dw, dh, channels):
    img = _img((24, 35, channels), seed=dw + channels)
    port = (Mat.from_array(img.copy(), device="cpu"), Mat.from_device(torch.from_numpy(img.copy())))
    ref = (jax_core.Mat.from_array(img.copy()), jax_core.Mat.from_device(jnp.asarray(img)))
    for p, r in zip(port, ref):
        got = port_ip.resize(p, dw, dh, interpolation)
        assert got.is_on_device == p.is_on_device and got.shape == (dh, dw, channels)
        np.testing.assert_array_equal(got.to_numpy(),
                                      jax_ip.resize(r, dw, dh, interpolation).to_numpy())
    with pytest.raises(ValueError):
        port_ip.resize(port[0], 4, 4, "lanczos")
