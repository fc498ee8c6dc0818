"""The port's ops (rustcv_tpu_torch.ops) against their JAX counterparts in
rustcv_tpu.ops and the host generator, bit-exact (tolerance 0: every stage
is integer arithmetic, and the float sqrt is corrected to an exact floor).

Inputs are made with numpy from a seed and handed to both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustcv_tpu.capture import simulation as jsim
from rustcv_tpu.core import PixelFormat as JaxPixelFormat
from rustcv_tpu.ops import color as JC
from rustcv_tpu.ops import draw as JD
from rustcv_tpu.ops import filters as JF
from rustcv_tpu.ops import synth as JS
from rustcv_tpu_torch.capture import simulation as tsim
from rustcv_tpu_torch.core import PixelFormat, SimulationError
from rustcv_tpu_torch.ops import color as TC
from rustcv_tpu_torch.ops import draw as TD
from rustcv_tpu_torch.ops import filters as TF
from rustcv_tpu_torch.ops import synth as TS

torch.set_num_threads(2)


def _eq(port, ref):
    np.testing.assert_array_equal(port.numpy() if isinstance(port, torch.Tensor) else port,
                                  np.asarray(ref))


# -- synth ------------------------------------------------------------------

@pytest.mark.parametrize(
    "w,h,seqs",
    [
        (64, 48, [0, 1, 17, 999]),
        (160, 120, [5, 123_456]),
        (130, 54, [3, 1_000_000_007]),
        # int32 wrap of seq*7 and seq*(W//64), and seqs near the int32 limit
        (352, 288, [2**31 - 1, 2**31 - 8, 306_783_378]),
        (2, 8, [0, 7]),
    ],
)
def test_synth_raw_matches_jax(w, h, seqs):
    port = TS.synth_raw(torch.tensor(seqs, dtype=torch.int32), w, h, PixelFormat.YUYV)
    ref = JS.synth_raw(jnp.asarray(seqs, jnp.int32), w, h, JaxPixelFormat.YUYV)
    assert port.dtype == torch.uint8 and tuple(port.shape) == (len(seqs), h * w * 2)
    _eq(port, ref)


@pytest.mark.parametrize("w,h", [(64, 48), (160, 120), (130, 54)])
@pytest.mark.parametrize("seq", [0, 1, 17, 999, 40_000])
def test_synth_raw_matches_host_generator(w, h, seq):
    port = TS.synth_raw(torch.tensor([seq], dtype=torch.int32), w, h, PixelFormat.YUYV)[0]
    _eq(port, tsim.synth_raw(w, h, PixelFormat.YUYV, seq))


@pytest.mark.parametrize(
    "fmt",
    [PixelFormat.YUYV, PixelFormat.UYVY, PixelFormat.GRAY8, PixelFormat.NV12,
     PixelFormat.YV12, PixelFormat.BGRA32, PixelFormat.RGB24, PixelFormat.BGR24],
)
def test_host_generators_byte_identical(fmt):
    """The port's jax-free host generator emits the reference's bytes."""
    for seq in (0, 5, 321):
        np.testing.assert_array_equal(tsim.synth_raw(64, 48, fmt, seq),
                                      jsim.synth_raw(64, 48, JaxPixelFormat(fmt.value), seq))


def test_synth_unported_formats_raise():
    """Formats neither package can simulate raise its SimulationError: on
    the device, those the reference does not synthesize there; on the host,
    a format with no encoder."""
    for fmt in (PixelFormat.UYVY, PixelFormat.YV12, PixelFormat.BAYER_RGGB):
        with pytest.raises(SimulationError, match="cannot encode"):
            TS.synth_raw(torch.zeros(1, dtype=torch.int32), 64, 48, fmt)
    with pytest.raises(SimulationError, match="cannot encode"):
        tsim.synth_raw(64, 48, PixelFormat.RGBA32, 0)


# -- color ------------------------------------------------------------------

@pytest.mark.parametrize("w,h,n", [(64, 48, 2), (130, 50, 3), (2, 1, 1), (256, 96, 1)])
def test_yuyv_decode_matches_jax(w, h, n):
    rng = np.random.default_rng(w * 1000 + h)
    src = rng.integers(0, 256, (n, h * w * 2), np.uint8)
    t, j = torch.from_numpy(src), jnp.asarray(src)
    _eq(TC.yuyv_to_bgr_packed(t, w, h), JC.yuyv_to_bgr_packed(j, w, h))
    _eq(TC.yuyv_to_gray(t, w, h), JC.yuyv_to_gray(j, w, h))


def test_yuyv_decode_row_form_input():
    """(H, W*2) rows decode like the flat form, as in the reference."""
    rng = np.random.default_rng(4)
    src = rng.integers(0, 256, (2, 24, 40 * 2), np.uint8)
    _eq(TC.yuyv_to_bgr_packed(torch.from_numpy(src), 40, 24),
        JC.yuyv_to_bgr_packed(jnp.asarray(src), 40, 24))
    _eq(TC.yuyv_to_gray(torch.from_numpy(src), 40, 24),
        JC.yuyv_to_gray(jnp.asarray(src), 40, 24))


# -- filters ----------------------------------------------------------------

@pytest.mark.parametrize("shape", [(3, 37, 53), (1, 5, 4), (2, 96, 130)])
def test_gaussian_sobel_magnitude_match_jax(shape):
    rng = np.random.default_rng(sum(shape))
    gray = rng.integers(0, 256, shape, np.uint8)
    t, j = torch.from_numpy(gray), jnp.asarray(gray)
    _eq(TF.gaussian5_u8(t, has_channels=False), JF.gaussian5_u8(j, has_channels=False))
    tgx, tgy = TF.sobel3_gray(t)
    jgx, jgy = JF.sobel3_gray(j)
    _eq(tgx, jgx)
    _eq(tgy, jgy)
    _eq(TF.gradient_magnitude_u8(tgx, tgy), JF.gradient_magnitude_u8(jgx, jgy))
    blurred = JF.gaussian5_u8(j, has_channels=False)
    _eq(TF.blur_sobel_mag_u8(t), JF.gradient_magnitude_u8(*JF.sobel3_gray(blurred)))


def test_gaussian_channels_match_jax():
    rng = np.random.default_rng(9)
    img = rng.integers(0, 256, (2, 20, 30, 3), np.uint8)
    _eq(TF.gaussian5_u8(torch.from_numpy(img)), JF.gaussian5_u8(jnp.asarray(img)))


def test_gradient_magnitude_extremes_match_jax():
    rng = np.random.default_rng(11)
    gx = rng.integers(-1020, 1021, (64, 64)).astype(np.int32)
    gy = rng.integers(-1020, 1021, (64, 64)).astype(np.int32)
    gx[0, :4] = [1020, -1020, 0, 1020]
    gy[0, :4] = [1020, -1020, 0, -1020]
    _eq(TF.gradient_magnitude_u8(torch.from_numpy(gx), torch.from_numpy(gy)),
        JF.gradient_magnitude_u8(jnp.asarray(gx), jnp.asarray(gy)))


def test_isqrt_exact_exhaustive():
    """Every int the Sobel magnitude can produce: [0, 2·1020²]."""
    x = np.arange(0, 2 * 1020 * 1020 + 1, dtype=np.int32)
    want = np.floor(np.sqrt(x.astype(np.float64))).astype(np.int32)
    got = TF.isqrt_exact(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(JF.isqrt_exact(jnp.asarray(x))))


# -- draw -------------------------------------------------------------------

_RECTS = np.array(
    [
        [20, 10, 30, 20],    # inside
        [-15, -8, 60, 30],   # clipped at the top-left edge
        [50, 40, 0, 10],     # degenerate (zero width)
        [55, 35, 100, 100],  # clipped at the bottom-right edge
        [10, 10, 3, 40],     # thinner than the thickness: edge overdraw
        [-200, 5, 10, 10],   # entirely off the canvas
    ],
    np.int32,
)


@pytest.mark.parametrize("thickness", [1, 2, 3, 25])
def test_rectangle_packed_matches_jax(thickness):
    n, h, w = len(_RECTS), 48, 64
    rng = np.random.default_rng(thickness)
    img = rng.integers(0, 256, (n, h, w * 3), np.uint8)
    colors = rng.integers(0, 256, (n, 3), np.uint8)
    port = TD.rectangle_packed(torch.from_numpy(img), torch.from_numpy(_RECTS),
                               torch.from_numpy(colors), thickness)
    ref = JD.rectangle_packed(jnp.asarray(img), jnp.asarray(_RECTS), jnp.asarray(colors),
                              jnp.int32(thickness))
    _eq(port, ref)


def test_rectangle_packed_single_rect_broadcasts():
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (3, 20, 30 * 3), np.uint8)
    rect, color = np.array([2, 3, 10, 8], np.int32), np.array([1, 2, 3], np.uint8)
    _eq(TD.rectangle_packed(torch.from_numpy(img), rect, color, 2),
        JD.rectangle_packed(jnp.asarray(img), jnp.asarray(rect), jnp.asarray(color),
                            jnp.int32(2)))
