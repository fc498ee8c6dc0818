"""The port's Harris features and Canny (rustcv_tpu_torch.ops.features,
ops.filters.canny_u8) against the JAX package on the CPU.

Integer outputs (the fixed-point response, corner masks, corner lists,
Canny) are array-equal, tie order included. The float32 response is held
to the reference's own tolerance for its Pallas kernel (rtol 2e-4,
atol 1e-6, tests/test_pallas_harris.py) against ``features.harris_response``
and ``harris_response_pallas`` run in interpret mode, and is bit-exact with
the numpy oracle (one rounding per operation in the oracle's order).

Inputs are made with numpy from a seed and handed to both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustcv_tpu.ops import features as JF
from rustcv_tpu.ops import filters as JFl
from rustcv_tpu.ops import golden
from rustcv_tpu.ops.pallas.harris import harris_response_pallas
from rustcv_tpu_torch.ops import features as TF
from rustcv_tpu_torch.ops import filters as TFl

torch.set_num_threads(2)

RESPONSE_SHAPES = [((2, 48, 64), 16), ((1, 100, 130), 32), ((1, 135, 256), 128),
                   ((1, 6, 128), 64), ((48, 64), 16)]
SMALL_SHAPES = [(1, 1, 1), (2, 2, 5), (1, 5, 2), (3, 50, 130), (2, 48, 64), (48, 64),
                (2, 16, 4)]


def _gray(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


def _board(h=64, w=64, cell=8):
    ys, xs = np.mgrid[0:h, 0:w]
    return (((ys // cell) + (xs // cell)) % 2 * 255).astype(np.uint8)


def _eq(port, ref):
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


@pytest.mark.parametrize("shape,tile", RESPONSE_SHAPES)
def test_harris_response_within_tolerance_of_jax_and_pallas(jax_cpu, shape, tile):
    g = _gray(shape, seed=sum(shape))
    port = TF.harris_response(torch.from_numpy(g)).numpy()
    assert port.dtype == np.float32 and port.shape == shape
    np.testing.assert_allclose(port, np.asarray(JF.harris_response(jnp.asarray(g))),
                               rtol=2e-4, atol=1e-6)
    pallas = harris_response_pallas(jnp.asarray(g), tile_rows=tile)
    np.testing.assert_allclose(port, np.asarray(pallas), rtol=2e-4, atol=1e-6)
    oracle = np.stack([golden.harris_response(x) for x in g.reshape(-1, *shape[-2:])])
    np.testing.assert_array_equal(port.reshape(oracle.shape), oracle)


@pytest.mark.parametrize("k", [0.04, 0.06])
@pytest.mark.parametrize("shape", SMALL_SHAPES)
def test_harris_response_i32_matches_jax_and_golden(shape, k):
    g = _gray(shape, seed=7 * sum(shape))
    k_num = int(round(k * 1024))
    port = TF.harris_response_i32(torch.from_numpy(g), k_num=k_num)
    assert port.dtype == torch.int32
    _eq(port, JF.harris_response_i32(jnp.asarray(g), k_num=k_num))
    oracle = np.stack([golden.harris_response_i32(x, k_num) for x in g.reshape(-1, *shape[-2:])])
    _eq(port.reshape(oracle.shape), oracle)


@pytest.mark.parametrize("kw", [{}, dict(k=0.06, threshold_rel=0.02, nms_radius=2)],
                         ids=["defaults", "k0.06-t0.02-r2"])
@pytest.mark.parametrize("image", ["random", "board", "flat", "batch"])
def test_harris_corners_match_jax_and_golden(image, kw):
    g = {"random": _gray((48, 64), 3), "board": _board(), "flat": np.full((40, 56), 9, np.uint8),
         "batch": np.stack([_board(48, 64, 6), _gray((48, 64), 4), np.zeros((48, 64), np.uint8)])}[image]
    port = TF.harris_corners(torch.from_numpy(g), **kw)
    assert port.dtype == torch.bool
    _eq(port, JF.harris_corners(jnp.asarray(g), **kw))
    oracle = np.stack([golden.harris_corners(x, **kw) for x in g.reshape(-1, *g.shape[-2:])])
    _eq(port.reshape(oracle.shape), oracle)
    if image == "board":
        assert port.any()  # the board's inner corners are found


@pytest.mark.parametrize("max_corners", [256, 1024])
@pytest.mark.parametrize("image", ["random", "board", "flat", "batch"])
def test_harris_corner_list_matches_jax_tie_order_included(image, max_corners):
    """A flat frame has no valid slot (all ties at −2³¹); the board has
    many equal responses. Coordinates of every slot, valid or not, match."""
    g = {"random": _gray((48, 64), 5), "board": _board(), "flat": np.full((64, 64), 200, np.uint8),
         "batch": np.stack([_board(), np.full((64, 64), 1, np.uint8), _gray((64, 64), 6)])}[image]
    coords, valid = TF.harris_corner_list(torch.from_numpy(g), max_corners=max_corners)
    jc, jv = JF.harris_corner_list(jnp.asarray(g), max_corners=max_corners)
    assert coords.dtype == torch.int32 and valid.dtype == torch.bool
    _eq(coords, jc)
    _eq(valid, jv)
    if image == "flat":
        assert not valid.any()
    if image == "board":
        assert 0 < int(valid.sum()) < max_corners


def test_harris_corner_list_needs_enough_pixels():
    with pytest.raises(ValueError, match="max_corners"):
        TF.harris_corner_list(torch.zeros((10, 20), dtype=torch.uint8), max_corners=256)


@pytest.mark.parametrize("low,high", [(40, 90), (10, 30)])
@pytest.mark.parametrize("shape", SMALL_SHAPES + [(64, 64)])
def test_canny_matches_jax_and_golden(shape, low, high):
    """(2, 16, 4) pins the reference's channel guess in the hysteresis
    window (a last axis of 4 is taken as channels)."""
    g = _board(*shape) if shape == (64, 64) else _gray(shape, seed=11 * sum(shape))
    port = TFl.canny_u8(torch.from_numpy(g), low=low, high=high)
    assert port.dtype == torch.uint8
    _eq(port, JFl.canny_u8(jnp.asarray(g), low=low, high=high))
    if g.ndim == 2:
        _eq(port, golden.canny(g, low=low, high=high))


@pytest.mark.parametrize("ksize", [1, 3, 5])
@pytest.mark.parametrize("shape", [(20, 30), (2, 20, 30), (20, 30, 3), (2, 9, 4)])
def test_window_reduce_matches_jax(shape, ksize):
    g = _gray(shape, seed=ksize + sum(shape))
    _eq(TFl._window_reduce(torch.from_numpy(g), ksize, torch.maximum),
        JFl._window_reduce(jnp.asarray(g), ksize, jnp.maximum))
    _eq(TFl._window_reduce(torch.from_numpy(g), ksize, torch.minimum),
        JFl._window_reduce(jnp.asarray(g), ksize, jnp.minimum))
