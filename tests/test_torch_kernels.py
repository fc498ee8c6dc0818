"""The port's kernel modules on the CPU: each wrapper's plain version (what
a CPU tensor runs) against the JAX package's Pallas kernels K1–K6, run as
that package's own tests run them here (interpret mode): bit-exact for
K1–K5, and for K6's float32 response within the reference's tolerance
(rtol 2e-4, atol 1e-6). K6's int32 form has no Pallas twin; it is held
bit-exact against the frozen oracle ``golden.harris_response_i32``.

The CUDA kernels themselves run only on the card (tests/test_torch_cuda.py
and chip_smoke.py compare them with these plain versions there)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustcv_tpu.ops import color as JC
from rustcv_tpu.ops import draw as JD
from rustcv_tpu.ops import filters as JF
from rustcv_tpu.ops import golden
from rustcv_tpu.ops.pallas.harris import harris_response_pallas
from rustcv_tpu.ops.pallas.decode_interleave import yuyv_decode_interleave as j_decode
from rustcv_tpu.ops.pallas.stencil import blur_sobel_mag_pallas
from rustcv_tpu.ops.pallas.stencil_v2 import blur_sobel_mag_pallas_v2
from rustcv_tpu.ops.pallas.stencil_v3 import blur_sobel_mag_pallas_v3
from rustcv_tpu.ops.pallas.tick_fused import yuyv_tick_fused as j_tick
from rustcv_tpu_torch.ops import filters as TF
from rustcv_tpu_torch.ops import kernels
from rustcv_tpu_torch.ops.kernels import decode_interleave, harris, stencil, tick_fused

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


@pytest.mark.parametrize("w,h", [(64, 48), (130, 100), (256, 135), (128, 6), (5, 2), (1, 1)])
def test_harris_plain_matches_pallas_and_golden(jax_cpu, w, h):
    """Tiny and ragged shapes too: the window replicates the products, not
    the gray, at every edge and at a partial last tile."""
    gray = np.random.default_rng(w * h).integers(0, 256, (2, h, w), np.uint8)
    f32 = harris.harris_response(torch.from_numpy(gray))
    assert f32.dtype == torch.float32
    ref = harris_response_pallas(jnp.asarray(gray), tile_rows=32)
    np.testing.assert_allclose(f32.numpy(), np.asarray(ref), rtol=2e-4, atol=1e-6)
    i32 = harris.harris_response_i32(torch.from_numpy(gray), 41)
    _eq(i32, np.stack([golden.harris_response_i32(g, 41) for g in gray]))
    # a 2-D image is one plane
    _eq(harris.harris_response_i32(torch.from_numpy(gray[1])), i32[1].numpy())
    _eq(harris.harris_response(torch.from_numpy(gray[1])), f32[1].numpy())


def test_harris_i32_wraps_like_int32_tensors():
    """A large k_num overflows the last step; the plain version (and the
    kernel, in unsigned arithmetic) wraps as int32 tensors do."""
    gray = torch.from_numpy(np.random.default_rng(9).integers(0, 256, (1, 24, 40), np.uint8))
    got = harris.harris_response_i32(gray, 100_000).long()
    gx, gy = (g.long() for g in TF.sobel3_gray(gray))
    s5 = [((TF._taps(TF._taps(m, 2, TF.GAUSS5, 2), 1, TF.GAUSS5, 2) + 128) >> 8) >> 5
          for m in (gx * gx, gy * gy, gx * gy)]
    det = s5[0] * s5[1] - s5[2] * s5[2]
    exact = det - 100_000 * ((((s5[0] + s5[1]) >> 1) ** 2) >> 8)
    wrapped = (exact + 2**31) % 2**32 - 2**31
    assert torch.equal(got, wrapped)
    assert not torch.equal(exact, wrapped)  # the case does overflow


def test_cpu_wrappers_count_no_launch():
    kernels.reset_launch_counts()
    src, rects, colors = _inputs(64, 48, 2, seed=0)
    kernels.yuyv_tick_fused(*_t(src), 64, 48, *_t(rects, colors), 2, overlay=True)
    kernels.yuyv_decode_interleave(*_t(src), 64, 48, *_t(rects, colors), 2, overlay=True)
    kernels.blur_sobel_mag(torch.zeros((1, 8, 8), dtype=torch.uint8))
    kernels.harris_response(torch.zeros((1, 8, 8), dtype=torch.uint8))
    kernels.harris_response_i32(torch.zeros((8, 8), dtype=torch.uint8))
    kernels.mosaic_shuffle.mosaic_shuffle("lane_roll", torch.zeros((8, 128), dtype=torch.int32))
    assert kernels.launch_counts() == {
        "blur_sobel_mag": 0, "yuyv_decode_interleave": 0, "yuyv_tick_fused": 0,
        "harris_response_f32": 0, "harris_response_i32": 0, "mosaic_shuffle": 0}


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
        pytest.param(lambda: kernels.harris_response(torch.zeros((1, 8, 8), dtype=torch.int32)),
                     id="harris-dtype"),
        pytest.param(lambda: kernels.harris_response_i32(torch.zeros((1, 1, 8, 8), dtype=torch.uint8)),
                     id="harris-rank"),
        pytest.param(lambda: kernels.harris_response_i32(torch.zeros((8, 8, 2), dtype=torch.uint8)[..., 0]),
                     id="harris-noncontiguous"),
        pytest.param(lambda: kernels.harris_response(torch.zeros((0, 8, 8), dtype=torch.uint8)),
                     id="harris-empty"),
        pytest.param(lambda: kernels.harris_response_i32(torch.zeros((1, 8, 8), dtype=torch.uint8),
                                                         2**31), id="harris-k_num"),
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
