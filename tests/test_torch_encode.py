"""The port's resize, packed-BGR helpers and JPEG encode (config 6's path)
against the JAX package on the CPU.

Integer stages (resize, colour, subsampling, block packing, the blob) are
bit-exact with the JAX functions and the frozen oracles. The float32 colour
and DCT may round an ulp apart from XLA's (which contracts into FMAs), so
coefficients are held to the reference's own tolerance
(tests/test_jpeg_encode.py:115-128): max |diff| <= 1 on a share < 5e-3.
Payloads are checked by the port's native entropy decoder, which returns
the quantized coefficients exactly (Huffman coding is lossless)."""

import dataclasses
import enum

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rustcv_tpu.models as jax_models
import rustcv_tpu.runtime.pipeline as jax_pipeline
from rustcv_tpu.core import PixelFormat as JaxPixelFormat
from rustcv_tpu.ops import color as JC
from rustcv_tpu.ops import golden
from rustcv_tpu.ops import jpeg_encode as JE
from rustcv_tpu.ops import jpeg_tpu as JT
from rustcv_tpu.ops import resize as JR
from rustcv_tpu_torch import models, native
from rustcv_tpu_torch.capture.simulation import synth_bgr
from rustcv_tpu_torch.core import PixelFormat
from rustcv_tpu_torch.ops import color as TC
from rustcv_tpu_torch.ops import jpeg_encode as TE
from rustcv_tpu_torch.ops import kernels
from rustcv_tpu_torch.ops import resize as TR
from rustcv_tpu_torch.runtime import MultiStreamEngine
from rustcv_tpu_torch.runtime import pipeline as port_pipeline

torch.set_num_threads(2)

needs_native = pytest.mark.skipif(not native.available(), reason="native library unavailable")

RESIZES = [  # (src_w, src_h, dst_w, dst_h)
    (1920, 1080, 640, 480),  # config 6: stride-3 columns, generic rows
    (130, 54, 64, 48),       # generic both ways
    (64, 48, 96, 72),        # upscale
    (1, 9, 4, 5),            # one source column
    (7, 1, 3, 2),            # one source row
    (9, 7, 1, 1),            # one output pixel
]
SUBSAMPLINGS = ["4:2:0", "4:2:2", "4:4:4"]
ENC_KEYS = ("enc_y", "enc_cb", "enc_cr")
PACK_KEYS = ("enc_idx", "enc_val", "enc_dense_ids", "enc_dense_rows", "enc_ndense")


def _image(h, w, c=3, n=None, seed=0):
    """A smooth random u8 image (upsampled noise plus a little grain)."""
    rng = np.random.default_rng(seed)
    shape = (n,) if n else ()
    coarse = rng.integers(0, 256, (*shape, h // 8 + 2, w // 8 + 2, c)).astype(np.float64)
    img = coarse.repeat(8, -3).repeat(8, -2)[..., :h, :w, :] + rng.normal(0, 6, (*shape, h, w, c))
    return np.clip(img, 0, 255).astype(np.uint8)


def _close(got, want, what=""):
    """The reference's coefficient tolerance."""
    d = np.abs(np.asarray(got).astype(np.int32) - np.asarray(want).astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() < 5e-3, f"{what}: max {d.max()}, share {(d > 0).mean()}"


def _golden_hwc(img, dw, dh):
    return np.stack([golden.resize_bilinear(im, dw, dh) for im in img])


# -- resize -------------------------------------------------------------------


@pytest.mark.parametrize("sw,sh,dw,dh", RESIZES)
def test_resize_forms_match_jax_and_golden(jax_cpu, sw, sh, dw, dh):
    img = _image(sh, sw, n=1, seed=sw + sh)
    want = _golden_hwc(img, dw, dh)
    port = TR.resize_bilinear(torch.from_numpy(img), dw, dh).numpy()
    np.testing.assert_array_equal(port, want)
    np.testing.assert_array_equal(port, np.asarray(JR.resize_bilinear(jnp.asarray(img), dw, dh)))
    packed = img.reshape(1, sh, sw * 3)
    got = TR.resize_bilinear_packed(torch.from_numpy(packed), sw, sh, dw, dh).numpy()
    np.testing.assert_array_equal(got, want.reshape(1, dh, dw * 3))
    np.testing.assert_array_equal(
        got, np.asarray(JR.resize_bilinear_packed(jnp.asarray(packed), sw, sh, dw, dh)))
    plane = np.moveaxis(img, -1, -3).astype(np.int32)  # (1, 3, H, W) int planes
    got = TR.resize_bilinear_plane(torch.from_numpy(plane), dw, dh).numpy()
    np.testing.assert_array_equal(got, np.moveaxis(want, -1, -3))
    np.testing.assert_array_equal(
        got, np.asarray(JR.resize_bilinear_plane(jnp.asarray(plane), dw, dh)))


def test_config6_columns_are_a_stride_3_subsample():
    """1920 → 640 takes every third column from the second, weight 0."""
    assert TR._hstride(1920, 640) == (3, 1, 0) and TR._hstride(1080, 480) is None
    lo, w = TR.resize_coeffs(1920, 640)
    np.testing.assert_array_equal(lo, 3 * np.arange(640) + 1)
    assert not w.any()
    for src, dst in ((1920, 640), (1080, 480), (130, 64), (1, 4), (9, 1)):
        for a, b in zip(TR.resize_coeffs(src, dst), golden.resize_coeffs(src, dst)):
            np.testing.assert_array_equal(a, b)


# -- colour helpers -------------------------------------------------------------


@pytest.mark.parametrize("n,h,w", [(2, 48, 64), (1, 5, 8), (3, 2, 4)])
def test_packed_bgr_helpers_match_jax(jax_cpu, n, h, w):
    img = np.random.default_rng(h * w).integers(0, 256, (n, h, w * 3), np.uint8)
    t, j = torch.from_numpy(img), jnp.asarray(img)
    np.testing.assert_array_equal(TC.bgr_to_gray_packed_rows(t, w, h).numpy(),
                                  np.asarray(JC.bgr_to_gray_packed_rows(j, w, h)))
    flat = img.reshape(n, -1)
    np.testing.assert_array_equal(TC.bgr_to_gray_packed_rows(torch.from_numpy(flat), w, h).numpy(),
                                  np.asarray(JC.bgr_to_gray_packed_rows(jnp.asarray(flat), w, h)))
    planes = TC.unpack_bgr_planes(t, w, h)
    for p, q in zip(planes, JC.unpack_bgr_planes(j, w, h)):
        assert p.dtype == torch.int32
        np.testing.assert_array_equal(p.numpy(), np.asarray(q))
    back = TC.interleave_bgr_planes(*planes, w, h).numpy()
    np.testing.assert_array_equal(back, img)
    np.testing.assert_array_equal(
        back, np.asarray(JC.interleave_bgr_planes(*(jnp.asarray(p.numpy()) for p in planes), w, h)))


def test_gray_of_any_width_is_the_hwc_luma():
    """No width % 4 limit: equal to golden.bgr_to_gray on the HWC view."""
    img = _image(9, 6, seed=3)
    got = TC.bgr_to_gray_packed_rows(torch.from_numpy(img.reshape(9, 18)), 6, 9).numpy()
    np.testing.assert_array_equal(got, golden.bgr_to_gray(img))


# -- encode ---------------------------------------------------------------------


def test_dct_basis_and_quant_tables_match_jax():
    np.testing.assert_array_equal(TE.idct_basis(), JT.idct_basis())
    np.testing.assert_array_equal(TE.idct_kmat(), JT.idct_kmat())
    np.testing.assert_array_equal(TE.fdct_kmat(), JE.fdct_kmat())
    for q in (1, 50, 85, 100):
        for a, b in zip(TE.quant_tables(q), JE.quant_tables(q)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    for s in SUBSAMPLINGS:
        assert TE._geometry(130, 54, s) == JE._geometry(130, 54, s)


@pytest.mark.parametrize("subsampling", SUBSAMPLINGS)
@pytest.mark.parametrize("w,h", [(130, 54), (64, 48)])
def test_encode_coeffs_within_the_reference_tolerance(jax_cpu, subsampling, w, h):
    imgs = _image(h, w, n=2, seed=w * h)
    planes = [imgs[..., c] for c in range(3)]
    port = TE.encode_coeffs_from_planes(*(torch.from_numpy(p) for p in planes), 85, subsampling)
    ref = JE.encode_coeffs_from_planes(*(jnp.asarray(p) for p in planes), 85, subsampling)
    for i in range(2):
        oracle, _, _ = JE.encode_coeffs_numpy(imgs[i], 85, subsampling)
        for c in range(3):
            assert port[c].dtype == torch.int16 and port[c].shape == ref[c].shape
            _close(port[c][i], ref[c][i], f"vs jax, component {c}")
            _close(port[c][i], oracle[c].reshape(-1, 64), f"vs the float64 oracle, component {c}")
    # the (H, W, 3) entry point is the same function
    for a, b in zip(TE.encode_coeffs(torch.from_numpy(imgs), 85, subsampling), port):
        assert torch.equal(a, b)


def test_encode_gray_within_tolerance(jax_cpu):
    gray = _image(37, 50, c=1, seed=9)[..., 0]
    got = TE.encode_coeffs_gray(torch.from_numpy(gray), 70)
    _close(got, JE.encode_coeffs_gray_tpu(jnp.asarray(gray), 70), "gray")


def _coeffs(rng, nblocks=96, busy_every=17, k=10):
    """Sparse quantized rows; every ``busy_every``-th block busier than K,
    with busy counts drawn from a narrow range so nnz ties are common."""
    c = np.zeros((nblocks, 64), np.int16)
    for b in range(nblocks):
        nnz = rng.integers(0, k) if b % busy_every else k + rng.integers(1, 4)
        pos = rng.choice(64, size=nnz, replace=False)
        c[b, pos] = rng.integers(-1023, 1024, size=nnz).astype(np.int16)
    return c


@pytest.mark.parametrize("busy_every,dcap", [(17, 32), (3, 8), (1, 200), (5, 1000)])
def test_pack_coeff_rows_and_blob_match_jax(jax_cpu, busy_every, dcap):
    """Ties in nnz (jax.lax.top_k order), overflow (n_dense > cap) and a
    cap larger than the blocks included."""
    rng = np.random.default_rng(busy_every * 7 + dcap)
    c = np.stack([_coeffs(rng, busy_every=busy_every), _coeffs(rng, busy_every=busy_every)])
    port = TE.pack_coeff_rows(torch.from_numpy(c), 10, dcap)
    ref = JE.pack_coeff_rows(jnp.asarray(c), 10, dcap)
    for p, r in zip(port, ref):
        assert p.numpy().dtype == np.asarray(r).dtype
        np.testing.assert_array_equal(p.numpy(), np.asarray(r))
    blob = TE.blob_from_packed(*port).numpy()
    np.testing.assert_array_equal(blob, np.asarray(JE.blob_from_packed(*ref)))
    cap = min(dcap, c.shape[1])
    split = TE.split_blob(blob, c.shape[1], 10, cap)
    for a, b, r in zip(split, JE.split_blob(blob, c.shape[1], 10, cap), port):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, r.numpy())
    for i in range(2):
        if port[4][i] <= cap:
            dense = TE.unpack_coeff_rows_numpy(*(a[i] for a in split[:4]), c.shape[1])
            np.testing.assert_array_equal(dense, c[i])


@needs_native
@pytest.mark.parametrize("subsampling", SUBSAMPLINGS)
def test_payloads_are_the_native_coders_bytes(subsampling):
    img = synth_bgr(96, 64, 5)
    g = TE._geometry(96, 64, subsampling)
    qy, qc = TE.quant_tables(85)
    coeffs = [c.numpy() for c in TE.encode_coeffs(torch.from_numpy(img), 85, subsampling)]
    grids = [c.reshape(*g["blocks"][i], 64) for i, c in enumerate(coeffs)]
    dense = native.jpeg_entropy_encode(grids, [qy, qc, qc], 96, 64, g["h_samp"], g["v_samp"])
    assert TE.encode_jpeg(img, 85, subsampling) == dense
    assert TE.encode_jpeg_batch(np.stack([img, img]), 85, subsampling) == [dense, dense]
    allc = torch.from_numpy(np.concatenate(coeffs))
    idx, val, ids, rows, nd = (a.numpy() for a in TE.pack_coeff_rows(allc, 10, 64))
    assert nd <= 64
    assert native.jpeg_entropy_encode_packed(
        idx, val, ids, rows, g["blocks"], [qy, qc, qc], 96, 64, g["h_samp"], g["v_samp"]) == dense
    info, dec, qts = native.jpeg_entropy_decode(dense)
    for c in range(3):
        np.testing.assert_array_equal(dec[c].reshape(-1, 64), coeffs[c])
    gray = img[..., 1]
    info, dec, qts = native.jpeg_entropy_decode(TE.encode_jpeg(gray, 60))
    assert info["ncomp"] == 1
    np.testing.assert_array_equal(dec[0].reshape(-1, 64),
                                  TE.encode_coeffs_gray(torch.from_numpy(gray), 60).numpy())


# -- config 6 as a slice ----------------------------------------------------------


def _fields(spec) -> dict:
    """A spec's fields, each enum as its value (the two packages have their
    own PixelFormat classes with the same values)."""
    return {k: v.value if isinstance(v, enum.Enum) else v
            for k, v in dataclasses.asdict(spec).items()}


def _small(model):
    return dataclasses.replace(model, width=128, height=96, n_streams=2, resize_to=(64, 48))


def _overlay():
    return (np.array([[4, 4, 30, 20], [-3, 10, 50, 60]], np.int32),
            np.array([[0, 255, 0], [9, 200, 7]], np.uint8))


def _set_mode(monkeypatch, mode):
    if mode is None:
        monkeypatch.delenv("RUSTCV_DECODE", raising=False)
    else:
        monkeypatch.setenv("RUSTCV_DECODE", mode)
    jax_pipeline.get_pipeline.cache_clear()


def _decodes_to(payloads, res):
    """Every stream's JFIF entropy-decodes to the tick's coefficients."""
    assert len(payloads) == res.outputs["bgr"].shape[0]
    for i, p in enumerate(payloads):
        info, dec, qts = native.jpeg_entropy_decode(p)
        assert (info["width"], info["height"], info["ncomp"]) == (64, 48, 3)
        for c, key in enumerate(ENC_KEYS):
            np.testing.assert_array_equal(dec[c].reshape(-1, 64), res.outputs[key][i].numpy())
        np.testing.assert_array_equal(qts[0].reshape(-1), TE.quant_tables(85)[0])


@needs_native
def test_config6_slice_matches_jax(jax_cpu, monkeypatch):
    """Config 6 cut to 2 streams of 128×96 → 64×48, 3 ticks through both
    zoos: bgr and filtered bit-exact, coefficients within tolerance, the
    packed outputs array-equal given the same coefficients, and payloads
    that decode to the coefficients."""
    _set_mode(monkeypatch, None)
    rects, colors = _overlay()
    ref_eng = _small(jax_models.get_model("config6_transcode")).engine()
    port = _small(models.get_model("config6_transcode")).engine(device="cpu")
    assert _fields(port.spec) == _fields(ref_eng.spec)
    assert (port.spec.encode_jpeg, port.spec.encode_packed) == (85, 10)
    for _ in range(3):
        p = port.tick(rects=rects, rect_colors=colors, block=True)
        r = ref_eng.tick(rects=rects, rect_colors=colors, block=True)
        assert set(p.outputs) == set(r.outputs)
        for key in ("bgr", "filtered"):
            np.testing.assert_array_equal(p.numpy(key), r.numpy(key))
        for key in ENC_KEYS:
            _close(p.outputs[key], r.outputs[key], key)
        same = TE.pack_coeff_rows(
            torch.from_numpy(np.concatenate([np.asarray(r.outputs[k]) for k in ENC_KEYS], -2)),
            port.spec.encode_packed, port.spec.encode_dense_cap)
        for key, a in zip(PACK_KEYS, same):
            np.testing.assert_array_equal(a.numpy(), np.asarray(r.outputs[key]), err_msg=key)
        payloads = port.encode_payloads(p)
        _decodes_to(payloads, p)
        if all(np.array_equal(p.outputs[k].numpy(), np.asarray(r.outputs[k])) for k in ENC_KEYS):
            assert payloads == ref_eng.encode_payloads(r)
    port.close()


@needs_native
def test_config6_delivery_paths(monkeypatch):
    _set_mode(monkeypatch, None)
    rects, colors = _overlay()
    with _small(models.get_model("config6_transcode")).engine(device="cpu") as eng:
        streamed = list(eng.stream_encoded(max_ticks=3, rects=rects, rect_colors=colors))
        assert [res.tick_index for res, _ in streamed] == [0, 1, 2]
        for res, payloads in streamed:
            _decodes_to(payloads, res)
            assert payloads == eng.encode_payloads(res)
        stats, mb = eng.run_encoded(3, warmup=1)
        assert (stats.ticks, stats.frames) == (3, 6) and 0 < mb < 0.1 and stats.fps_total > 0
        assert eng.encode_dense_fallbacks == 0
        assert eng._fetch_pool is not None
    assert eng._fetch_pool is None and eng._encode_pool is None  # close() shut them


@needs_native
def test_dense_delivery_and_over_capacity_fallback(monkeypatch):
    """Without packing the dense grids are coded; a tick whose busy blocks
    overflow the dense rows falls back to them, counted, same bytes."""
    _set_mode(monkeypatch, None)
    model = _small(models.get_model("config6_transcode"))
    dense = model.engine(device="cpu", encode_packed=False)
    assert dense.spec.encode_packed == 0
    res = dense.tick(block=True)
    assert not set(PACK_KEYS) & set(res.outputs)
    want = [dense.encode_payloads(res)]
    _decodes_to(want[0], res)
    [(res, streamed)] = dense.stream_encoded(max_ticks=1, depth=0)
    _decodes_to(streamed, res)
    want.append(streamed)
    packed = model.engine(device="cpu")
    packed.spec = dataclasses.replace(packed.spec, encode_dense_cap=1)
    packed._fn = port_pipeline.get_pipeline(packed.spec)
    res = packed.tick(block=True)
    assert int(res.outputs["enc_ndense"].max()) > 1
    assert packed.encode_payloads(res) == want[0]
    assert [p for _, p in packed.stream_encoded(max_ticks=1)] == [want[1]]
    assert packed.encode_dense_fallbacks == 2


@pytest.mark.parametrize("mode", ["pallas", "pallas_tick"])
def test_config6_runs_the_default_path_under_kernel_modes(monkeypatch, mode):
    """K4 and K5 decode at the input size: with a resize and an encode the
    pipeline never calls them, whatever RUSTCV_DECODE says."""
    _set_mode(monkeypatch, None)
    rects, colors = _overlay()
    want = _small(models.get_model("config6_transcode")).engine(device="cpu").tick(
        rects=rects, rect_colors=colors, block=True)

    def refuse(*args, **kwargs):
        raise AssertionError("a fused decode kernel was called")

    monkeypatch.setattr(kernels, "yuyv_decode_interleave", refuse)
    monkeypatch.setattr(kernels, "yuyv_tick_fused", refuse)
    _set_mode(monkeypatch, mode)
    got = _small(models.get_model("config6_transcode")).engine(device="cpu").tick(
        rects=rects, rect_colors=colors, block=True)
    assert set(got.outputs) == set(want.outputs)
    for key, v in want.outputs.items():
        assert torch.equal(got.outputs[key], v), key


@pytest.mark.parametrize("w,h,dw,dh", [(130, 54, 64, 48), (64, 48, 66, 50)])
def test_resize_layouts_match_jax(jax_cpu, monkeypatch, w, h, dw, dh):
    """A width not a multiple of 4 gives (N, H, W, 3) in both packages
    (the same bytes); gray filters read the resized image."""
    _set_mode(monkeypatch, None)
    spec = dict(width=w, height=h, resize_to=(dw, dh), filter="sobel_mag", overlay=True,
                encode_jpeg=90)
    raw = np.random.default_rng(w).integers(0, 256, (2, h * w * 2), np.uint8)
    rects, colors = _overlay()
    port = port_pipeline.get_pipeline(port_pipeline.PipelineSpec(PixelFormat.YUYV, **spec))(
        torch.from_numpy(raw), torch.from_numpy(rects), torch.from_numpy(colors), 2)
    ref = jax_pipeline.get_pipeline(jax_pipeline.PipelineSpec(JaxPixelFormat.YUYV, **spec))(
        jnp.asarray(raw), jnp.asarray(rects), jnp.asarray(colors), 2)
    assert set(port) == set(ref)
    for key in ("bgr", "filtered", "_sync"):
        np.testing.assert_array_equal(port[key].numpy(), np.asarray(ref[key]), err_msg=key)
    for key in ENC_KEYS:
        _close(port[key], ref[key], key)


@needs_native
def test_port_engine_continues_config6_from_jax_state(jax_cpu, monkeypatch):
    _set_mode(monkeypatch, None)
    rects, colors = _overlay()
    ref_eng = _small(jax_models.get_model("config6_transcode")).engine()
    for _ in range(2):
        ref_eng.tick(rects=rects, rect_colors=colors, block=True)
    resumed = MultiStreamEngine.from_state(ref_eng.export_state(), device="cpu",
                                           encode_jpeg_quality=85)
    assert resumed.export_state() == ref_eng.export_state()
    assert resumed.spec.resize_to == (64, 48) and resumed.spec.encode_jpeg == 85
    for _ in range(2):
        p = resumed.tick(rects=rects, rect_colors=colors, block=True)
        r = ref_eng.tick(rects=rects, rect_colors=colors, block=True)
        np.testing.assert_array_equal(p.sequences, r.sequences)
        for key in ("bgr", "filtered"):
            np.testing.assert_array_equal(p.numpy(key), r.numpy(key))
        for key in ENC_KEYS:
            _close(p.outputs[key], r.outputs[key], key)
        _decodes_to(resumed.encode_payloads(p), p)
