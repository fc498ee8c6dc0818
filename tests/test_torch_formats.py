"""Every wire format the engine stages, in the port against the JAX
package on the CPU, bit-exact: the colour converters (against the JAX
functions and ``golden``), the Bayer mosaic and the port's own copy of the
golden Bayer specs, the simulated frames of both ``SimulationDriver``s, the
device synthesis and ``convert_on_device``. Inputs are random bytes from a
seed, at small sizes with widths on and off a multiple of 4. The engine's
tick per format, and the guard that keeps the YUYV kernels off other
formats, are in ``tests/test_torch_formats_engine.py``."""

import numpy as np
import pytest
import torch

import rustcv_tpu.capture.simulation as jax_sim
import rustcv_tpu.core as jax_core
from rustcv_tpu.capture.source import ModeDescriptor as JaxModeDescriptor
from rustcv_tpu.ops import color as jax_color
from rustcv_tpu.ops import decode as jax_decode
from rustcv_tpu.ops import golden
from rustcv_tpu.ops import synth as jax_synth
from rustcv_tpu_torch.capture import ModeDescriptor, SimulationDriver
from rustcv_tpu_torch.capture import simulation as sim
from rustcv_tpu_torch.core import DecodeError, PixelFormat, SimpleConfig, SimulationError
from rustcv_tpu_torch.ops import color, decode, synth
from rustcv_tpu_torch.ops import golden as port_golden

torch.set_num_threads(2)

BAYER = ("BGGR", "GBRG", "GRBG", "RGGB")
RAW_FORMATS = [f for f in PixelFormat if f not in (PixelFormat.MJPEG, PixelFormat.H264)
               and f.value in {g.value for g in jax_core.PixelFormat}
               and f in sim._ENCODERS]


def _bytes(n, size, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, size), np.uint8)


def _jfmt(fmt):
    return jax_core.PixelFormat(fmt.value)


def _same(port, ref):
    got = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    want = np.asarray(ref)
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, want.shape)
    np.testing.assert_array_equal(got, want)


# (converter name, bytes per pixel ×2, needs an even height, golden twin)
PAIRWISE = [("yuyv", 4, False, golden.yuyv_to_bgr), ("uyvy", 4, False, golden.uyvy_to_bgr),
            ("nv12", 3, True, golden.nv12_to_bgr), ("yv12", 3, True, golden.yv12_to_bgr)]


@pytest.mark.parametrize("w,h,n", [(64, 48, 2), (70, 10, 3), (2, 2, 1), (6, 4, 1)])
@pytest.mark.parametrize("name,bpp2,even_h,gold", PAIRWISE, ids=[p[0] for p in PAIRWISE])
def test_pairwise_converters_match_jax_and_golden(jax_cpu, name, bpp2, even_h, gold, w, h, n):
    raw = _bytes(n, w * h * bpp2 // 2, seed=w * h + bpp2)
    x = torch.from_numpy(raw)
    packed = getattr(color, f"{name}_to_bgr_packed")(x, w, h)
    _same(packed, getattr(jax_color, f"{name}_to_bgr_packed")(raw, w, h))
    assert tuple(packed.shape) == (n, h, w * 3)
    hwc = getattr(color, f"{name}_to_bgr")(x, w, h)
    _same(hwc, getattr(jax_color, f"{name}_to_bgr")(raw, w, h))
    for i in range(n):
        _same(hwc[i], gold(raw[i], w, h))
    gray = getattr(color, f"{name}_to_gray")(x, w, h)
    _same(gray, getattr(jax_color, f"{name}_to_gray")(raw, w, h))
    _same(gray, golden.bgr_to_gray(hwc.numpy()))
    # rows (N, H, row bytes) read as the flat form
    if name in ("yuyv", "uyvy"):
        _same(getattr(color, f"{name}_to_bgr_packed")(x.reshape(n, h, w * 2), w, h), packed)


@pytest.mark.parametrize("w,h,n", [(64, 48, 2), (8, 3, 1), (4, 1, 2)])
def test_word_form_converters_match_jax(jax_cpu, w, h, n):
    """The converters the reference computes with u32 word tricks (width a
    multiple of 4), against the JAX functions and golden."""
    bgra = _bytes(n, w * h * 4, seed=w + 1)
    rgb = _bytes(n, w * h * 3, seed=w + 2)
    _same(color.bgra_to_bgr_packed(torch.from_numpy(bgra), w, h),
          jax_color.bgra_to_bgr_packed(bgra, w, h))
    _same(color.rgb_to_bgr_packed(torch.from_numpy(rgb), w, h),
          jax_color.rgb_to_bgr_packed(rgb, w, h))
    _same(color.rgb_to_gray_packed_rows(torch.from_numpy(rgb), w, h),
          jax_color.rgb_to_gray_packed_rows(rgb, w, h))
    _same(color.bgr_to_gray_packed_rows(torch.from_numpy(rgb), w, h),
          jax_color.bgr_to_gray_packed_rows(rgb, w, h))
    for i in range(n):
        _same(color.rgb_to_gray_packed_rows(torch.from_numpy(rgb[i]), w, h),
              golden.bgr_to_gray(golden.rgb_to_bgr(rgb[i], w, h)))


@pytest.mark.parametrize("w,h,n", [(64, 48, 2), (66, 50, 1), (7, 5, 2), (1, 3, 1)])
def test_any_width_converters_match_jax_and_golden(jax_cpu, w, h, n):
    bgra = _bytes(n, w * h * 4, seed=w * 3)
    rgb = _bytes(n, w * h * 3, seed=w * 5)
    for port, ref, gold, raw in (
            (color.bgra_to_bgr, jax_color.bgra_to_bgr, golden.bgra_to_bgr, bgra),
            (color.rgba_to_bgr, jax_color.rgba_to_bgr, golden.rgba_to_bgr, bgra),
            (color.rgb_to_bgr, jax_color.rgb_to_bgr, golden.rgb_to_bgr, rgb)):
        got = port(torch.from_numpy(raw), w, h)
        _same(got, ref(raw, w, h))
        for i in range(n):
            _same(got[i], gold(raw[i], w, h))
    img = rgb.reshape(n, h, w, 3)
    _same(color.bgr_to_gray(torch.from_numpy(img)), jax_color.bgr_to_gray(img))
    _same(color.bgr_to_gray(torch.from_numpy(img)), golden.bgr_to_gray(img))


@pytest.mark.parametrize("pattern", BAYER)
@pytest.mark.parametrize("w,h,n", [(64, 48, 2), (66, 50, 1), (2, 2, 1), (7, 5, 2), (3, 2, 1)])
def test_demosaic_matches_jax_and_golden(jax_cpu, pattern, w, h, n):
    raw = _bytes(n, w * h, seed=w * h + len(pattern))
    got = color.demosaic_bilinear(torch.from_numpy(raw), pattern, w, h)
    _same(got, jax_color.demosaic_bilinear(raw, pattern, w, h))
    for i in range(n):
        _same(got[i], golden.demosaic_bilinear(raw[i].reshape(h, w), pattern))
        _same(got[i], port_golden.demosaic_bilinear(raw[i].reshape(h, w), pattern))
    packed = color.demosaic_bilinear_packed(torch.from_numpy(raw), pattern, w, h)
    assert tuple(packed.shape) == (n, h, w * 3)
    if w % 2 == 0:
        _same(packed, jax_color.demosaic_bilinear_packed(raw, pattern, w, h))


def test_demosaic_refuses_a_one_pixel_side():
    with pytest.raises(ValueError, match="H, W >= 2"):
        color.demosaic_bilinear(torch.zeros(4, dtype=torch.uint8), "RGGB", 4, 1)


@pytest.mark.parametrize("pattern", BAYER)
def test_bayer_mosaic_is_goldens_and_demosaics_back(pattern):
    bgr = sim.synth_bgr(34, 22, 5)
    mosaic = port_golden.mosaic_bayer(bgr, pattern)
    np.testing.assert_array_equal(mosaic, golden.mosaic_bayer(bgr, pattern))
    np.testing.assert_array_equal(sim.synth_raw(34, 22, PixelFormat[f"BAYER_{pattern}"], 5),
                                  mosaic.reshape(-1))
    assert port_golden.BAYER_PATTERNS == golden.BAYER_PATTERNS
    np.testing.assert_array_equal(port_golden.demosaic_bilinear(mosaic, pattern),
                                  golden.demosaic_bilinear(mosaic, pattern))
    # every site keeps its own channel through the demosaic
    out = color.demosaic_bilinear(torch.from_numpy(mosaic.reshape(-1)), pattern, 34, 22).numpy()
    ry, rx = port_golden.BAYER_PATTERNS[pattern]["r"]
    np.testing.assert_array_equal(out[ry::2, rx::2, 2], bgr[ry::2, rx::2, 2])


FRAME_SIZES = [(64, 48), (66, 50)]


@pytest.mark.parametrize("w,h", FRAME_SIZES)
@pytest.mark.parametrize("fmt", RAW_FORMATS, ids=[f.value for f in RAW_FORMATS])
def test_simulated_frames_are_the_jax_packages(fmt, w, h):
    """Both SimulationDrivers give the same bytes for (w, h, format, seq),
    through synth_raw and through a source's next_frame."""
    for seq in (0, 1, 7):
        np.testing.assert_array_equal(sim.synth_raw(w, h, fmt, seq),
                                      jax_sim.synth_raw(w, h, _jfmt(fmt), seq))
    port = SimulationDriver(device_count=1, paced=False, n_unique_frames=8,
                            modes=[ModeDescriptor(fmt, w, h, (30,))])
    ref = jax_sim.SimulationDriver(device_count=1, paced=False, n_unique_frames=8,
                                   modes=[JaxModeDescriptor(_jfmt(fmt), w, h, (30,))])
    ps, _ = port.open_simple("sim:0", SimpleConfig(width=w, height=h, fps=30, pixel_format=fmt))
    js, _ = ref.open_simple("sim:0", jax_core.SimpleConfig(width=w, height=h, fps=30,
                                                           pixel_format=_jfmt(fmt)))
    ps.start()
    js.start()
    for seq in range(8):
        a, b = ps.next_frame(), js.next_frame()
        assert a.sequence == b.sequence == seq
        if seq in (0, 1, 7):
            np.testing.assert_array_equal(a.data, b.data)


SYNTH_FORMATS = [PixelFormat.YUYV, PixelFormat.NV12, PixelFormat.BGRA32, PixelFormat.RGB24,
                 PixelFormat.BGR24]


@pytest.mark.parametrize("w,h", FRAME_SIZES)
@pytest.mark.parametrize("fmt", SYNTH_FORMATS, ids=[f.value for f in SYNTH_FORMATS])
def test_device_synthesis_matches_jax_and_the_host_frames(jax_cpu, fmt, w, h):
    """Sequence numbers past 2**31 / 7 wrap seq * 7 in int32 as the
    reference does."""
    seqs = np.array([0, 1, 7, 2**31 - 5], np.int32)
    got = synth.synth_raw(torch.from_numpy(seqs), w, h, fmt)
    _same(got, jax_synth.synth_raw(seqs, w, h, _jfmt(fmt)))
    for i in range(3):
        np.testing.assert_array_equal(got[i].numpy(), sim.synth_raw(w, h, fmt, int(seqs[i])))


@pytest.mark.parametrize("fmt", [f for f in RAW_FORMATS if f not in SYNTH_FORMATS],
                         ids=lambda f: f.value)
def test_device_synthesis_of_other_formats_raises_as_in_jax(jax_cpu, fmt):
    seqs = np.zeros(2, np.int32)
    with pytest.raises(SimulationError, match="cannot encode"):
        synth.synth_raw(torch.from_numpy(seqs), 16, 8, fmt)
    with pytest.raises(jax_core.SimulationError, match="cannot encode"):
        jax_synth.synth_raw(seqs, 16, 8, _jfmt(fmt))


PAIRWISE_FORMATS = (PixelFormat.YUYV, PixelFormat.UYVY, PixelFormat.NV12, PixelFormat.YV12)
CONVERT_CASES = [(fmt, w, h) for fmt in RAW_FORMATS + [PixelFormat.RGBA32]
                 for w, h in ((64, 48), (66, 50), (7, 6))
                 if w % 2 == 0 or fmt not in PAIRWISE_FORMATS]  # pixel pairs: even widths


@pytest.mark.parametrize("fmt,w,h", CONVERT_CASES,
                         ids=[f"{f.value}-{w}x{h}" for f, w, h in CONVERT_CASES])
def test_convert_on_device_matches_jax(jax_cpu, fmt, w, h):
    raw = _bytes(2, fmt.buffer_size(w, h), seed=w + h)
    got = decode.convert_on_device(torch.from_numpy(raw), fmt, w, h)
    assert tuple(got.shape) == (2, h, w, 3)
    _same(got, jax_decode.convert_on_device(raw, _jfmt(fmt), w, h))


def test_convert_on_device_refuses_a_format_without_a_decode():
    with pytest.raises(DecodeError, match="unsupported"):
        decode.convert_on_device(torch.zeros(8, dtype=torch.uint8), PixelFormat.H264, 2, 2)
