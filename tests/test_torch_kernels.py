"""The port's kernel modules on the CPU: each wrapper's plain version (what
a CPU tensor runs) against the JAX package's Pallas kernels K1–K5, run as
that package's own tests run them here (interpret mode), bit-exact.

The CUDA kernels themselves run only on the card (tests/test_torch_cuda.py
and chip_smoke.py compare them with these plain versions there)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustcv_tpu.ops import color as JC
from rustcv_tpu.ops import draw as JD
from rustcv_tpu.ops import filters as JF
from rustcv_tpu.ops.pallas.decode_interleave import yuyv_decode_interleave as j_decode
from rustcv_tpu.ops.pallas.stencil import blur_sobel_mag_pallas
from rustcv_tpu.ops.pallas.stencil_v2 import blur_sobel_mag_pallas_v2
from rustcv_tpu.ops.pallas.stencil_v3 import blur_sobel_mag_pallas_v3
from rustcv_tpu.ops.pallas.tick_fused import yuyv_tick_fused as j_tick
from rustcv_tpu_torch.ops import kernels
from rustcv_tpu_torch.ops.kernels import decode_interleave, stencil, tick_fused

torch.set_num_threads(2)

SHAPES = [(96, 48), (130, 64), (256, 96)]
JAX_STENCILS = {
    "v1": blur_sobel_mag_pallas,
    "v2": blur_sobel_mag_pallas_v2,
    "v3": blur_sobel_mag_pallas_v3,
}


def _eq(port, ref, msg=""):
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref), err_msg=msg)


def _inputs(w, h, n, seed):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, 256, (n, h * w * 2), np.uint8)
    rects = np.stack([
        [w // 4, h // 5, w // 2, h // 2],     # inside, across tiles
        [-7, -3, w // 3, h + 10],             # clipped at the frame edge
        [w - 5, h - 4, 40, 40],               # clipped at the bottom-right corner
        [3, 3, 2, 1],                         # thinner than the thickness
    ][:n]).astype(np.int32)
    colors = rng.integers(0, 256, (n, 3), np.uint8)
    return src, rects, colors


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("impl", sorted(JAX_STENCILS))
@pytest.mark.parametrize("w,h", SHAPES)
def test_stencil_plain_matches_pallas(jax_cpu, impl, w, h):
    rng = np.random.default_rng(w + h)
    gray = rng.integers(0, 256, (2, h, w), np.uint8)
    port = stencil.blur_sobel_mag(torch.from_numpy(gray))
    _eq(port, JAX_STENCILS[impl](jnp.asarray(gray)))


@pytest.mark.parametrize("overlay", [True, False])
@pytest.mark.parametrize("w,h", SHAPES)
def test_decode_interleave_plain_matches_pallas(jax_cpu, overlay, w, h):
    src, rects, colors = _inputs(w, h, 3, seed=w * h)
    bgr, gray = decode_interleave.yuyv_decode_interleave(*_t(src), w, h, *_t(rects, colors),
                                                         3, overlay=overlay)
    ref = j_decode(jnp.asarray(src), w, h, jnp.asarray(rects), jnp.asarray(colors),
                   jnp.int32(3), overlay=overlay)
    assert ref is not None
    _eq(bgr, ref[0], "bgr")
    _eq(gray, ref[1], "gray")


@pytest.mark.parametrize("w,h", SHAPES)
def test_tick_fused_plain_matches_pallas(jax_cpu, w, h):
    src, rects, colors = _inputs(w, h, 4, seed=w + 7 * h)
    bgr, filt = tick_fused.yuyv_tick_fused(*_t(src), w, h, *_t(rects, colors), 2, overlay=True)
    ref = j_tick(jnp.asarray(src), w, h, jnp.asarray(rects), jnp.asarray(colors),
                 jnp.int32(2), overlay=True)
    assert ref is not None
    _eq(bgr, ref[0], "bgr")
    _eq(filt, ref[1], "filtered")


def _jax_xla_tick(src, w, h, rects, colors, thickness):
    """The reference's XLA chain, which its pipeline runs when a Pallas
    tick kernel returns None."""
    j = jnp.asarray(src)
    bgr = JD.rectangle_packed(JC.yuyv_to_bgr_packed(j, w, h), jnp.asarray(rects),
                              jnp.asarray(colors), jnp.int32(thickness))
    gray = JC.yuyv_to_gray(j, w, h)
    blurred = JF.gaussian5_u8(gray, has_channels=False)
    return bgr, gray, JF.gradient_magnitude_u8(*JF.sobel3_gray(blurred))


@pytest.mark.parametrize("w,h", [(96, 50), (34, 13)])
def test_ragged_height_matches_xla_fallback(jax_cpu, w, h):
    """Where H is not a multiple of 8 the Pallas kernels return None and the
    reference runs its XLA chain; the port's kernels take any H and match it."""
    src, rects, colors = _inputs(w, h, 2, seed=h)
    assert j_tick(jnp.asarray(src), w, h, jnp.asarray(rects), jnp.asarray(colors),
                  jnp.int32(2), overlay=True) is None
    assert j_decode(jnp.asarray(src), w, h, jnp.asarray(rects), jnp.asarray(colors),
                    jnp.int32(2), overlay=True) is None
    ref_bgr, ref_gray, ref_filt = _jax_xla_tick(src, w, h, rects, colors, 2)
    bgr, filt = tick_fused.yuyv_tick_fused(*_t(src), w, h, *_t(rects, colors), 2, overlay=True)
    _eq(bgr, ref_bgr, "tick bgr")
    _eq(filt, ref_filt, "tick filtered")
    bgr, gray = decode_interleave.yuyv_decode_interleave(*_t(src), w, h, *_t(rects, colors),
                                                         2, overlay=True)
    _eq(bgr, ref_bgr, "decode bgr")
    _eq(gray, ref_gray, "decode gray")


def test_cpu_wrappers_count_no_launch():
    kernels.reset_launch_counts()
    src, rects, colors = _inputs(64, 48, 2, seed=0)
    kernels.yuyv_tick_fused(*_t(src), 64, 48, *_t(rects, colors), 2, overlay=True)
    kernels.yuyv_decode_interleave(*_t(src), 64, 48, *_t(rects, colors), 2, overlay=True)
    kernels.blur_sobel_mag(torch.zeros((1, 8, 8), dtype=torch.uint8))
    assert kernels.launch_counts() == {
        "blur_sobel_mag": 0, "yuyv_decode_interleave": 0, "yuyv_tick_fused": 0}


def _src(w=64, h=48, n=2):
    return torch.zeros((n, h * w * 2), dtype=torch.uint8)


_R = torch.zeros((2, 4), dtype=torch.int32)
_C = torch.zeros((2, 3), dtype=torch.uint8)


@pytest.mark.parametrize(
    "call",
    [
        pytest.param(lambda: kernels.blur_sobel_mag(torch.zeros((1, 8, 8), dtype=torch.int32)),
                     id="stencil-dtype"),
        pytest.param(lambda: kernels.blur_sobel_mag(torch.zeros((8, 8, 2), dtype=torch.uint8)[..., 0]),
                     id="stencil-noncontiguous"),
        pytest.param(lambda: kernels.blur_sobel_mag(torch.zeros((1, 2, 8, 8), dtype=torch.uint8)),
                     id="stencil-rank"),
        pytest.param(lambda: kernels.blur_sobel_mag(torch.zeros((8, 8), dtype=torch.uint8)),
                     id="stencil-2d"),
        pytest.param(lambda: kernels.blur_sobel_mag(torch.zeros((0, 8, 8), dtype=torch.uint8)),
                     id="stencil-empty"),
        pytest.param(lambda: kernels.yuyv_decode_interleave(_src(63), 63, 48), id="odd-width"),
        pytest.param(lambda: kernels.yuyv_decode_interleave(_src(), 64, 47), id="size-mismatch"),
        pytest.param(lambda: kernels.yuyv_decode_interleave(_src().float(), 64, 48), id="src-dtype"),
        pytest.param(lambda: kernels.yuyv_tick_fused(_src(), 64, 48, _R[:1], _C, 2, overlay=True),
                     id="rects-shape"),
        pytest.param(lambda: kernels.yuyv_tick_fused(_src(), 64, 48, _R.long(), _C, 2, overlay=True),
                     id="rects-dtype"),
        pytest.param(lambda: kernels.yuyv_tick_fused(_src(), 64, 48, _R, _C.int(), 2, overlay=True),
                     id="colors-dtype"),
        pytest.param(lambda: kernels.yuyv_tick_fused(_src(), 64, 48, _R.numpy(), _C, 2, overlay=True),
                     id="rects-not-tensor"),
    ],
)
def test_wrappers_reject_what_the_kernels_do_not_take(call):
    with pytest.raises(ValueError):
        call()
