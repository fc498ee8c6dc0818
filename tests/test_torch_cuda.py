"""The port's CUDA kernels on the card: each kernel against its plain
PyTorch version on the same CUDA tensors (bit-exact; the float32 Harris
response within the reference's rtol 2e-4, atol 1e-6), the Mosaic probe's
cases (K7) against their numpy refs too, and the engine's decode modes,
config 6's transcode, every wire format, the chained tick as a CUDA graph
and the resolution swap against each other and against the CPU; and the
OpenCV-style facade: a Mat's device round trip, draws on a CUDA Mat
against a host Mat (with no blocking copy), ``harris_corners`` on a CUDA
Mat through K6, ``VideoCapture``'s device decode and the JPEG codecs; the
text blends, ``put_text`` on a CUDA Mat (no blocking copy), the engine's
text overlay and ``mjpeg_backend="host"`` against their CPU forms; the
one-rank NCCL mesh; and every ``imgproc`` wrapper of the colour, filter,
resize and corner ops on a CUDA Mat against a host Mat (exact, or ±1 LSB
for Lab and float kernels, 1e-3 px for ``corner_sub_pix``), the
``xla_fused`` engine against the default mode and the CPU, and the native
ring's device decode against its host decode; and every device wrapper of
the second block (arithmetic, histograms, warps, thinning, diffusion,
blend, the float32 core ops) on a CUDA Mat or CUDA tensors against the
same call on the host (exact, ±1 LSB where the reference documents it, a
relative tolerance for float results); and every call of group 2 (corner
responses, FAST, BRIEF/ORB and matching, LK, Farnebäck, DIS, TV-L1,
template matching, phase correlation, the DFT/DCT, ECC's device twin, HOG,
SIFT, AKAZE) on a CUDA Mat or CUDA tensors against the same call on the
host with the reference's device-vs-oracle tolerances, with no kernel
launched, ECC's loop with no host read, and the full-float32 guard holding
with TF32 switched on; and group 3 with the segmentation head of group 4
(the background subtractors, the trackers alone and in banks, Kalman's
``filter_scan``, mean shift, k-means, watershed, SLIC, the components,
contours, distance transforms, blobs, the Voronoi seam) on CUDA inputs
against CPU inputs, with the subtractors' and trackers' state staying on
the card (one host read per ``update``), a bank stepping as one batch, and
``full_f32`` in force around k-means' and Kalman's products; and
``make_dummy_overlay``'s default device, the card; and group 4a (the Hough
transforms, stereo BM/SGBM, NL-means, the domain-transform and guided
filters, Poisson cloning, the diffusion inpaint, Mertens fusion, the
cascade scorer and their wrappers) on CUDA inputs against CPU inputs at
the reference's tolerances (the cascade's ``ok`` outside a 1e-3 margin
band), with their results on the card and no kernel launched, and
``mser``/``grabcut`` raising when the native build fails; and group 4b
(the undistortions, byte-equal to the CPU port and staying on the card;
the SB likelihood in full float32 with TF32 on; the chessboard refinements
on the card for a numpy board; the rasterizer, the normals and the stitch
composite against the CPU port at the reference's bars); and the cv2
facade (``rustcv_tpu_torch.cv2``), its core and its later modules and
submodules: every function with numpy images (on the card where it hands
them to a Mat or a device op) against CPU tensors, ``cornerHarris``,
``goodFeaturesToTrack``, ``GFTTDetector.detect`` and
``goodFeaturesToTrackWithQuality`` launching each K6 form once per form
they reach, CUDA tensors against CPU tensors, and draws on a CUDA tensor;
and TIFF and GIF read onto the card and written from CUDA Mats (the GIF's
colour mapping on the card) against the CPU; and every WebP fixture of
``tests/data/webp`` read onto the card against the CPU read and the
reference's hashes in its manifest, and WebP written from CUDA Mats equal
to the bytes written from host Mats; and every animated PNG fixture of
``tests/data/apng`` read onto the card against the CPU read and the
reference's hashes, animated PNG written from CUDA Mats equal to the bytes
written from host Mats, and the GIF quantizer on CUDA frames equal to
Pillow's hashes (``tests/data/gif/quant_refs.json``) and the CPU's; and
PNG's row filters on CUDA tensors equal to the CPU's, and every case of
phase 3za (``chip_smoke.png_write_frames``) written from CUDA tensors and
CUDA Mats equal to the bytes written on the CPU and to Pillow's chunks,
controls and image data (``tests/data/png/write_refs.json``); and every
JPEG fixture of ``tests/data/jpeg`` (CMYK and YCCK, smoothed progressive,
lossless, arithmetic-coded, and the forms that stay refused) read onto the
card against the CPU read and the reference's hashes in its manifest.

Marked ``cuda``; every test skips where torch.cuda.is_available() is false.
Run on a machine with the card: ``python -m pytest tests/test_torch_cuda.py -q
--noconftest`` (the suite's conftest imports jax, which that machine lacks).
"""

import dataclasses
import functools
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from rustcv_tpu_torch import native
from rustcv_tpu_torch.capture import SimulationDriver
from rustcv_tpu_torch.capture import simulation as sim
from rustcv_tpu_torch.core import Mat, PixelFormat, SimpleConfig
from rustcv_tpu_torch.models import get_model
from rustcv_tpu_torch.ops import kernels
from rustcv_tpu_torch.ops.kernels import decode_interleave, harris, mosaic_shuffle, stencil, tick_fused
from rustcv_tpu_torch.probes import mosaic_shuffle as probe
from rustcv_tpu_torch.runtime import MultiStreamEngine

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(w, h, n, device, seed=0):
    rng = np.random.default_rng(seed)
    src = torch.from_numpy(rng.integers(0, 256, (n, h * w * 2), np.uint8)).to(device)
    rects = torch.from_numpy(np.stack([
        [w // 3, h // 4, w // 2, h // 2], [-9, -5, w + 20, h // 3], [w - 3, h - 2, 9, 9],
    ] * n)[:n].astype(np.int32)).to(device)
    colors = torch.from_numpy(rng.integers(0, 256, (n, 3), np.uint8)).to(device)
    return src, rects, colors


@pytest.mark.parametrize("w,h,n", [(64, 48, 2), (130, 50, 3), (2, 1, 1), (1920, 1080, 2)])
def test_kernels_match_plain_versions(cuda, w, h, n):
    src, rects, colors = _inputs(w, h, n, cuda, seed=w + h)
    gray = torch.from_numpy(np.random.default_rng(h).integers(0, 256, (n, h, w), np.uint8)).to(cuda)
    kernels.reset_launch_counts()
    assert torch.equal(stencil.blur_sobel_mag(gray), stencil.blur_sobel_mag_plain(gray))
    for overlay in (True, False):
        got = decode_interleave.yuyv_decode_interleave(src, w, h, rects, colors, 3, overlay)
        want = decode_interleave.yuyv_decode_interleave_plain(src, w, h, rects, colors, 3, overlay)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        got = tick_fused.yuyv_tick_fused(src, w, h, rects, colors, 3, overlay)
        want = tick_fused.yuyv_tick_fused_plain(src, w, h, rects, colors, 3, overlay)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {
        "blur_sobel_mag": 1, "yuyv_decode_interleave": 2, "yuyv_tick_fused": 2,
        "harris_response_f32": 0, "harris_response_i32": 0, "mosaic_shuffle": 0}


def _misaligned(t, offset=1):
    """A contiguous copy of ``t`` starting ``offset`` bytes into a buffer."""
    buf = torch.empty(t.numel() + offset, dtype=torch.uint8, device=t.device)
    view = buf[offset:].view(t.shape)
    view.copy_(t)
    return view


def _overlay_pool(w, h, n, device):
    """Per-stream rects inside and across strips of rows, over the frame
    edges, and one rectangle taller than a strip."""
    pool = [[w // 3, h // 4, w // 2, h // 2], [-9, -5, w + 20, h // 3], [w - 3, h - 2, 9, 9],
            [1, 30, w - 2, 45], [0, 7, 3, 100]]
    return torch.tensor([pool[i % len(pool)] for i in range(n)], dtype=torch.int32, device=device)


# (W, H, N): W % 8 in every residue, images smaller than the ±3 halo, the
# main path's shapes.
K1_SHAPES = [(131, 37, 3), (134, 9, 2), (6, 3, 1), (2, 1, 1), (1, 2, 1), (129, 70, 1),
             (132, 33, 2), (133, 8, 1), (135, 40, 1), (136, 41, 2), (640, 480, 8),
             (1920, 1080, 8)]
K5_SHAPES = [(134, 9, 2), (6, 3, 1), (2, 1, 1), (130, 50, 3), (132, 33, 2), (136, 41, 2),
             (258, 70, 1), (1920, 1080, 8)]


@pytest.mark.parametrize("w,h,n", K1_SHAPES)
def test_blur_sobel_kernel_matches_plain_version(cuda, w, h, n):
    """K1 bit-exact, at an aligned address and one byte past it."""
    gray = torch.from_numpy(np.random.default_rng(w * h).integers(0, 256, (n, h, w), np.uint8)).to(cuda)
    kernels.reset_launch_counts()
    for g in (gray, _misaligned(gray)):
        assert torch.equal(stencil.blur_sobel_mag(g), stencil.blur_sobel_mag_plain(g))
    torch.cuda.synchronize()
    assert kernels.launch_counts()["blur_sobel_mag"] == 2


@pytest.mark.parametrize("w,h,n", K5_SHAPES)
def test_tick_fused_kernel_matches_plain_version(cuda, w, h, n):
    """K5 bit-exact with and without the overlay, with rectangles across
    strip edges and a thickness above a strip's rows, for words at any
    address."""
    src, _, colors = _inputs(w, h, n, cuda, seed=w * 3 + h)
    rects = _overlay_pool(w, h, n, cuda)
    kernels.reset_launch_counts()
    for overlay, thickness in ((True, 2), (True, 70), (False, 0)):
        want = tick_fused.yuyv_tick_fused_plain(src, w, h, rects, colors, thickness, overlay)
        for s in (src, _misaligned(src), _misaligned(src, 2)):
            got = tick_fused.yuyv_tick_fused(s, w, h, rects, colors, thickness, overlay)
            assert all(torch.equal(a, b) for a, b in zip(got, want)), (overlay, thickness)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["yuyv_tick_fused"] == 9


@pytest.mark.parametrize("n,h,w", [(2, 48, 64), (3, 50, 130), (1, 1, 2), (1, 2, 1),
                                   (1, 5, 5), (1, 33, 31), (8, 1080, 1920)])
def test_harris_kernel_matches_plain_versions(cuda, n, h, w):
    gray = torch.from_numpy(np.random.default_rng(h * w).integers(0, 256, (n, h, w), np.uint8)).to(cuda)
    kernels.reset_launch_counts()
    for k_num in (41, 61):
        assert torch.equal(harris.harris_response_i32(gray, k_num),
                           harris.harris_response_i32_plain(gray, k_num))
    for k in (0.04, 0.06):
        torch.testing.assert_close(harris.harris_response(gray, k),
                                   harris.harris_response_plain(gray, k), rtol=2e-4, atol=1e-6)
    # a 2-D image is one plane
    assert torch.equal(harris.harris_response_i32(gray[0]), harris.harris_response_i32_plain(gray[0]))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert (counts["harris_response_i32"], counts["harris_response_f32"]) == (3, 2)


@pytest.mark.parametrize("filt", ["harris", "harris_points", "canny"])
def test_config4_engine_on_the_card_matches_the_cpu(cuda, monkeypatch, filt):
    model = dataclasses.replace(get_model("config4_harris_1080p"), width=160, height=120,
                                n_streams=2)
    keys = ("filtered",) if filt != "harris_points" else ("corners", "corners_valid")
    results = {}
    for mode in ("xla", "pallas"):
        monkeypatch.setenv("RUSTCV_DECODE", mode)
        for dev in ("cpu", cuda):
            eng = model.engine(device=dev, filter=filt)
            res = [eng.tick(block=True) for _ in range(3)]
            results[mode, str(dev)] = [[r.numpy(k) for k in keys] for r in res]
    ref = results["xla", "cpu"]
    for key, ticks in results.items():
        for got, want in zip(ticks, ref):
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b, err_msg=str(key))


# (W, H, N): W % 8 in every even residue, H below a strip's rows, the main
# path's shape.
K4_SHAPES = [(2, 1, 1), (6, 3, 1), (130, 5, 2), (132, 33, 2), (134, 9, 2), (136, 41, 2),
             (258, 70, 1), (520, 7, 3), (1920, 1080, 8)]


@pytest.mark.parametrize("w,h,n", K4_SHAPES)
def test_decode_interleave_kernel_matches_plain_version(cuda, w, h, n):
    """K4 bit-exact with and without the overlay, with rectangles across
    strip edges and a thickness above a strip's rows, for words at any
    address."""
    src, _, colors = _inputs(w, h, n, cuda, seed=w * 5 + h)
    rects = _overlay_pool(w, h, n, cuda)
    kernels.reset_launch_counts()
    for overlay, thickness in ((True, 2), (True, 70), (False, 0)):
        want = decode_interleave.yuyv_decode_interleave_plain(src, w, h, rects, colors, thickness,
                                                              overlay)
        for s in (src, _misaligned(src), _misaligned(src, 2)):
            got = decode_interleave.yuyv_decode_interleave(s, w, h, rects, colors, thickness, overlay)
            assert all(torch.equal(a, b) for a, b in zip(got, want)), (overlay, thickness)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["yuyv_decode_interleave"] == 9


# (N, H, W): H around the kernel's strip heights (11 .. 24 rows) and below
# the ±3 halo, W % 4 in every residue, config 4's 1 × 1080p and 8 × 1080p.
K6_SHAPES = [(1, 1, 5), (1, 3, 6), (2, 6, 7), (1, 11, 64), (2, 12, 65), (1, 13, 66),
             (3, 23, 131), (1, 24, 130), (2, 25, 129), (1, 49, 132), (1, 1080, 1920),
             (8, 1080, 1920)]


@pytest.mark.parametrize("n,h,w", K6_SHAPES)
def test_harris_kernel_strip_edges(cuda, n, h, w):
    """Both Harris forms bit-exact with their plain versions across strip
    edges, on an aligned and a misaligned plane, for k_num 41, 61 and
    100,000 (where k_num·(...) wraps) and float32 k 0.04 and 0.06."""
    gray = torch.from_numpy(np.random.default_rng(n * h + w).integers(0, 256, (n, h, w), np.uint8)).to(cuda)
    kernels.reset_launch_counts()
    for g in (gray, _misaligned(gray)):
        for k_num in (41, 61, 100_000):
            assert torch.equal(harris.harris_response_i32(g, k_num),
                               harris.harris_response_i32_plain(gray, k_num)), k_num
        for k in (0.04, 0.06):
            assert torch.equal(harris.harris_response(g, k), harris.harris_response_plain(gray, k)), k
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert (counts["harris_response_i32"], counts["harris_response_f32"]) == (6, 4)


def test_engine_decode_modes_agree(cuda, monkeypatch):
    cfg = SimpleConfig(width=160, height=120, fps=60, pixel_format=PixelFormat.YUYV)
    rects = np.array([[20, 10, 60, 40]] * 3, np.int32)
    colors = np.array([[0, 255, 0]] * 3, np.uint8)
    results = {}
    for mode in ("xla", "pallas", "pallas_tick"):
        monkeypatch.setenv("RUSTCV_DECODE", mode)
        for impl in ("xla", None):
            eng = MultiStreamEngine(SimulationDriver(device_count=3, paced=False), 3, cfg,
                                    filter="blur_sobel", overlay=True, device_sim=True,
                                    stencil_impl=impl, device=cuda)
            res = [eng.tick(rects=rects, rect_colors=colors, block=True) for _ in range(3)]
            results[mode, impl] = [(r.numpy("bgr"), r.numpy("filtered")) for r in res]
    ref = results["xla", "xla"]
    for key, ticks in results.items():
        for (b, f), (rb, rf) in zip(ticks, ref):
            np.testing.assert_array_equal(b, rb, err_msg=str(key))
            np.testing.assert_array_equal(f, rf, err_msg=str(key))


@pytest.mark.parametrize("name", list(mosaic_shuffle.CASES))
def test_mosaic_shuffle_kernels_match_plain_and_ref(cuda, name):
    kernels.reset_launch_counts()
    result = probe.run_case(name, cuda)
    torch.cuda.synchronize()
    assert probe.exact(result), name
    assert kernels.launch_counts()["mosaic_shuffle"] == 1


def test_config6_on_the_card_matches_the_cpu(cuda):
    """Config 6 cut to 2 streams of 128×96 → 64×48: bgr and filtered equal
    to the CPU's, coefficients within the reference's tolerance (max |diff|
    <= 1 on < 0.5 %), and every payload decodes to the card's coefficients."""
    assert native.available(), native.build_error()
    model = dataclasses.replace(get_model("config6_transcode"), width=128, height=96,
                                n_streams=2, resize_to=(64, 48))
    card, cpu = model.engine(device=cuda), model.engine(device="cpu")
    for res, payloads in card.stream_encoded(max_ticks=3):
        ref = cpu.tick(block=True)
        for key in ("bgr", "filtered"):
            np.testing.assert_array_equal(res.numpy(key), ref.numpy(key))
        for c, key in enumerate(("enc_y", "enc_cb", "enc_cr")):
            got = res.numpy(key)
            d = np.abs(got.astype(np.int32) - ref.numpy(key).astype(np.int32))
            assert d.max() <= 1 and (d > 0).mean() < 5e-3
            for i, p in enumerate(payloads):
                np.testing.assert_array_equal(native.jpeg_entropy_decode(p)[1][c].reshape(-1, 64),
                                              got[i])
    card.close()


def _host_engine(device, fmt=PixelFormat.YUYV, n=3, **kw):
    cfg = SimpleConfig(width=160, height=120, fps=60, pixel_format=fmt)
    if fmt == PixelFormat.MJPEG:
        kw.setdefault("mjpeg_backend", "hybrid")
    return MultiStreamEngine(SimulationDriver(device_count=n, paced=False), n, cfg,
                             device_sim=False, device=device, **kw)


def _close_bytes(got, want):
    """max |diff| <= 1 on < 0.5 % of bytes (the float32 IDCT's ties)."""
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert d.max() <= 1 and (d > 0).mean() < 5e-3, (d.max(), (d > 0).mean())


@pytest.mark.parametrize("fmt", [PixelFormat.YUYV, PixelFormat.MJPEG])
def test_host_path_stages_in_pinned_memory_and_matches_the_cpu(cuda, monkeypatch, fmt):
    monkeypatch.delenv("RUSTCV_DECODE", raising=False)
    kw = dict(filter="blur_sobel", overlay=True)
    rects = np.array([[20, 10, 60, 40]] * 3, np.int32)
    colors = np.array([[0, 255, 0]] * 3, np.uint8)
    card, cpu = _host_engine(cuda, fmt, **kw), _host_engine("cpu", fmt, **kw)
    kernels.reset_launch_counts()
    for _ in range(3):
        got = card.tick(rects=rects, rect_colors=colors, block=True)
        want = cpu.tick(rects=rects, rect_colors=colors, block=True)
        assert got.sequences.tolist() == want.sequences.tolist()
        for key in ("bgr", "filtered"):
            if fmt == PixelFormat.YUYV:
                np.testing.assert_array_equal(got.numpy(key), want.numpy(key))
            else:
                _close_bytes(got.numpy(key), want.numpy(key))
    torch.cuda.synchronize()
    assert kernels.launch_counts()["blur_sobel_mag"] == 3
    assert all(t.is_pinned() and t.device.type == "cpu" for slot in card._staging for t, _ in slot)
    assert all(e is not None for e in card._staging_events)
    card.close()


@pytest.mark.parametrize("fmt", [PixelFormat.YUYV, PixelFormat.MJPEG])
def test_prefetch_reuse_under_load(cuda, monkeypatch, fmt):
    """A spin kernel ahead of every upload keeps each copy in flight while the
    prefetch thread gathers the next ticks, so the gather for tick k+2 finds
    tick k's copy still reading its buffer: it must wait for that copy's
    event, and every tick of the run equals the CPU's sequential ticks."""
    monkeypatch.delenv("RUSTCV_DECODE", raising=False)
    card = _host_engine(cuda, fmt, n=2, filter="sobel_mag")
    upload = card._upload

    def slow_upload(slot):
        torch.cuda._sleep(200_000_000)  # about 100 ms of device time
        return upload(slot)

    card._upload = slow_upload
    seen = []
    tick = card.tick

    def recorded(*args, **kwargs):
        res = tick(*args, **kwargs)
        seen.append(res)
        return res

    card.tick = recorded
    card.run(8, warmup=0, measure_latency=False)
    assert card.staging_waits > 0  # the hazard was there
    cpu = _host_engine("cpu", fmt, n=2, filter="sobel_mag")
    for res in seen:
        want = cpu.tick(block=True)
        assert res.sequences.tolist() == want.sequences.tolist()
        for key in ("bgr", "filtered"):
            if fmt == PixelFormat.YUYV:
                np.testing.assert_array_equal(res.numpy(key), want.numpy(key))
            else:
                _close_bytes(res.numpy(key), want.numpy(key))
    card.close()


@pytest.mark.parametrize("fmt", [PixelFormat.YUYV, PixelFormat.MJPEG])
def test_steady_host_ticks_do_not_synchronize(cuda, monkeypatch, fmt):
    """After warm-up, a host tick, blocking gather or prefetched, issues no
    call that waits for the device (torch's sync debug mode raises on one):
    the upload and the pipeline stay queued behind the device's work."""
    monkeypatch.delenv("RUSTCV_DECODE", raising=False)
    eng = _host_engine(cuda, fmt, n=2, filter="blur_sobel", overlay=True)
    for _ in range(3):
        eng.tick(block=True)
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            eng.tick()
            eng.tick(pregathered=eng._gather_any())
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    eng.close()


def test_config2_on_the_card_matches_the_cpu(cuda):
    """Config 2 cut to 2 streams of 160×120 → 64×48, packed and forced
    dense, against the CPU's ticks of the same frames."""
    model = dataclasses.replace(get_model("config2_mjpeg_resize"), width=160, height=120,
                                n_streams=2, resize_to=(64, 48))
    card, cpu = model.engine(device=cuda), model.engine(device="cpu")
    for t in range(3):
        if t == 2:
            card._dense_cap = 0  # every busy block over capacity: the dense program
        got, want = card.tick(block=True), cpu.tick(block=True)
        assert got.sequences.tolist() == want.sequences.tolist() == [t, t]
        _close_bytes(got.numpy("bgr"), want.numpy("bgr"))
    card.close()


# -- every wire format, run_chained as a CUDA graph, set_resolution ----------

_FORMATS = [f for f in sim._ENCODERS if f != PixelFormat.MJPEG]
_SIM_FORMATS = (PixelFormat.YUYV, PixelFormat.NV12, PixelFormat.BGRA32, PixelFormat.RGB24,
                PixelFormat.BGR24)


def _format_engine(device, fmt, w, h, device_sim, n=2, **kw):
    from rustcv_tpu_torch.capture import ModeDescriptor

    driver = SimulationDriver(device_count=n, paced=False,
                              modes=[ModeDescriptor(fmt, w, h, (60,)),
                                     ModeDescriptor(fmt, 160, 120, (60,))])
    return MultiStreamEngine(driver, n, SimpleConfig(width=w, height=h, fps=60, pixel_format=fmt),
                             device_sim=device_sim, device=device, **kw)


@pytest.mark.parametrize("w,h", [(160, 120), (162, 122)])
@pytest.mark.parametrize("fmt", _FORMATS, ids=lambda f: f.value)
def test_each_format_on_the_card_matches_the_cpu(cuda, monkeypatch, fmt, w, h):
    """Host-staged, and device-sim where the device makes the format: every
    tick equal to the CPU's, in the same layout, K1 once per tick."""
    rects = np.array([[20, 10, 60, 40], [-5, 50, 300, 20]], np.int32)
    colors = np.array([[0, 255, 0], [9, 8, 7]], np.uint8)
    for mode in ("xla", "pallas"):
        monkeypatch.setenv("RUSTCV_DECODE", mode)
        for device_sim in (False, True) if fmt in _SIM_FORMATS else (False,):
            kw = dict(filter="blur_sobel", overlay=True)
            card = _format_engine(cuda, fmt, w, h, device_sim, **kw)
            cpu = _format_engine("cpu", fmt, w, h, device_sim, **kw)
            kernels.reset_launch_counts()
            for _ in range(2):
                got = card.tick(rects=rects, rect_colors=colors, block=True)
                want = cpu.tick(rects=rects, rect_colors=colors, block=True)
                for key in ("bgr", "filtered"):
                    assert got.outputs[key].shape == want.outputs[key].shape
                    np.testing.assert_array_equal(got.outputs[key].cpu().numpy(),
                                                  want.outputs[key].numpy())
            torch.cuda.synchronize()
            counts = {k: v for k, v in kernels.launch_counts().items() if v}
            fused = fmt == PixelFormat.YUYV and mode == "pallas"
            assert counts == ({"blur_sobel_mag": 2, "yuyv_decode_interleave": 2} if fused
                              else {"blur_sobel_mag": 2})
            card.close()


_CHAINED = [("config1_convert_overlay", "xla"), ("config4_harris_1080p", "xla"),
            ("config4_harris_1080p", "pallas"), ("config5_end_to_end_4k", "pallas_tick")]


def _tick_launches(fn):
    """What the kernel wrappers counted in one synced call of ``fn``."""
    before = kernels.launch_counts()
    fn()
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


@pytest.mark.parametrize("name,mode", _CHAINED)
def test_chained_graph_replay_equals_eager_ticks(cuda, monkeypatch, name, mode):
    """One replay of a captured chain of 4 ticks: the probe and clock of 4
    eager ticks on the card and of the CPU's chain; the wrappers counted 4
    × the eager tick's launches of each kernel while the graph was captured
    (none for config 1's plain ops), and a replay calls no wrapper."""
    monkeypatch.setenv("RUSTCV_DECODE", mode)
    model = dataclasses.replace(get_model(name), width=160, height=120,
                                n_streams=min(2, get_model(name).n_streams))
    eng, cpu = model.engine(device=cuda), model.engine(device="cpu")
    rects = np.array([[20, 10, 60, 40]] * eng.n, np.int32)
    colors = np.array([[0, 255, 0]] * eng.n, np.uint8)
    tick = _tick_launches(lambda: eng.tick(rects=rects, rect_colors=colors, thickness=2))
    ch = eng._chain(4)
    assert ch.graph is not None
    assert ch.launches == {k: 4 * v for k, v in tick.items()}
    if name.startswith("config1"):
        assert ch.launches == {}
    ch.rects.copy_(torch.from_numpy(rects))
    ch.colors.copy_(torch.from_numpy(colors))
    ch.seqs.fill_(3)
    assert _tick_launches(ch.dispatch) == {}
    args = (torch.from_numpy(rects), torch.from_numpy(colors), 2)
    eager = eng._build_sim_fn_chained(4)(torch.full((eng.n,), 3, dtype=torch.int32, device=cuda),
                                         *(a.to(cuda) if isinstance(a, torch.Tensor) else a
                                           for a in args))
    want = cpu._build_sim_fn_chained(4)(torch.full((eng.n,), 3, dtype=torch.int32), *args)
    assert torch.equal(ch.sync, eager["_sync"]) and torch.equal(ch.sync.cpu(), want["_sync"])
    assert ch.seqs.tolist() == [7] * eng.n == want["_next_seqs"].tolist()
    # a second replay continues the clock
    ch.dispatch()
    want = cpu._build_sim_fn_chained(4)(want["_next_seqs"], *args)
    assert torch.equal(ch.sync.cpu(), want["_sync"]) and ch.seqs.tolist() == [11] * eng.n


@pytest.mark.parametrize("name,mode", _CHAINED)
def test_chained_capture_makes_no_host_sync(cuda, monkeypatch, name, mode):
    """With PyTorch's sync debug mode at "error", any op that waits for the
    device inside the chain (``.item()``, ``.cpu()``, a blocking copy)
    raises: the capture and a replay of each chain go through."""
    monkeypatch.setenv("RUSTCV_DECODE", mode)
    model = dataclasses.replace(get_model(name), width=160, height=120,
                                n_streams=min(2, get_model(name).n_streams))
    eng = model.engine(device=cuda)
    eng.tick(block=True)  # the kernels' build and the overlay's upload come first
    torch.cuda.set_sync_debug_mode("error")
    try:
        ch = eng._chain(3)
        ch.dispatch()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert ch.graph is not None and ch.seqs.tolist() == [6] * eng.n


def test_run_chained_on_the_card_matches_the_cpu(cuda, monkeypatch):
    monkeypatch.delenv("RUSTCV_DECODE", raising=False)
    model = dataclasses.replace(get_model("config4_harris_1080p"), width=160, height=120)
    card, cpu = model.engine(device=cuda), model.engine(device="cpu")
    rects = np.array([[20, 10, 60, 40]], np.int32)
    colors = np.array([[0, 255, 0]], np.uint8)
    for eng in (card, cpu):
        stats = eng.run_chained(20, chain=4, warmup=2, rects=rects, rect_colors=colors)
        assert (stats.ticks, stats.frames) == (20, 20)
    assert card._seqs.tolist() == cpu._seqs.tolist() == [28]
    assert card._chain(4).graph is not None and cpu._chain(4).graph is None
    assert torch.equal(card._chain(4).sync.cpu(), cpu._chain(4).sync)
    got, want = card.tick(block=True), cpu.tick(block=True)
    assert got.sequences.tolist() == want.sequences.tolist() == [28]
    np.testing.assert_array_equal(got.numpy("filtered"), want.numpy("filtered"))


_FAILED_CAPTURE = """
import numpy as np, torch
from rustcv_tpu_torch.capture import SimulationDriver
from rustcv_tpu_torch.core import PixelFormat, SimpleConfig
from rustcv_tpu_torch.runtime import MultiStreamEngine
eng = MultiStreamEngine(SimulationDriver(device_count=1, paced=False), 1,
                        SimpleConfig(width=64, height=48, fps=60, pixel_format=PixelFormat.YUYV),
                        device_sim=True, filter="blur_sobel", device="cuda")
tick = eng._sim_tick
def syncing_tick(*args, **kwargs):
    out = tick(*args, **kwargs)
    out["filtered"].sum().item()  # a host sync inside the captured region
    return out
eng._sim_tick = syncing_tick
try:
    eng.run_chained(8, chain=4)
except RuntimeError as e:
    print("RAISED", type(e).__name__, str(e).splitlines()[0][:200])
else:
    print("NO ERROR")
"""


def test_a_failed_capture_raises(cuda):
    """A host sync in the chained tick fails the capture, and run_chained
    raises instead of running eager ticks (in a process of its own: a
    failed capture may leave an error on the context)."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(repo) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", _FAILED_CAPTURE], cwd=repo, env=env,
                          capture_output=True, text=True, timeout=300)
    assert "RAISED" in proc.stdout, (proc.stdout, proc.stderr[-2000:])


@pytest.mark.parametrize("device_sim", [True, False])
def test_set_resolution_on_the_card_matches_the_cpu(cuda, monkeypatch, device_sim):
    monkeypatch.delenv("RUSTCV_DECODE", raising=False)
    kw = dict(filter="blur_sobel", overlay=True)
    card = _format_engine(cuda, PixelFormat.NV12, 64, 48, device_sim, **kw)
    cpu = _format_engine("cpu", PixelFormat.NV12, 64, 48, device_sim, **kw)
    assert card.warm_buckets(buckets=[(64, 48), (160, 120)]) == 2
    for size in ((160, 120), (64, 48), (160, 120)):
        for eng in (card, cpu):
            eng.tick(block=True)
            eng.set_resolution(*size)
        got, want = card.tick(block=True), cpu.tick(block=True)
        assert got.sequences.tolist() == want.sequences.tolist()
        for key in ("bgr", "filtered"):
            np.testing.assert_array_equal(got.numpy(key), want.numpy(key))
    card.close()


# -- the OpenCV-style facade on the card -------------------------------------------


def _facade_draws(mat):
    """The drawing calls of chip_smoke.py's facade phase."""
    from rustcv_tpu_torch import imgproc as ip

    ip.rectangle(mat, ip.Rect(60, 60, 200, 150), ip.Scalar(0, 255, 0), 2)
    ip.rectangle(mat, ip.Rect(-9, -5, 40, 20), ip.Scalar(1, 2, 3), 4)
    ip.line(mat, ip.Point(-20, 10), ip.Point(150, 100), ip.Scalar(255, 0, 0), 3)
    ip.circle(mat, ip.Point(80, 60), 25, ip.Scalar(0, 0, 255), -1)
    ip.circle(mat, ip.Point(150, 10), 30, ip.Scalar(0, 9, 255), 2)
    ip.fill_poly(mat, [(10, 100), (60, 70), (150, 119), (40, 90)], ip.Scalar(7, 8, 9))
    ip.ellipse(mat, ip.Point(80, 60), (50, 20), 30.0, ip.Scalar(9, 9, 9), 2)


def test_mat_device_round_trip(cuda):
    from rustcv_tpu_torch.core import Mat

    img = np.random.default_rng(3).integers(0, 256, (120, 160, 3), np.uint8)
    mat = Mat.new(120, 160, 3, step=160 * 3 + 11)
    mat.array[:] = img
    t = mat.device()  # a Mat's device is the card unless the caller names another
    assert t.is_cuda and mat.is_on_device and np.array_equal(t.cpu().numpy(), img)
    mat.array[0, 0] = (1, 2, 3)
    assert not mat.is_on_device and mat.device()[0, 0].tolist() == [1, 2, 3]
    mat.set_device(t)
    assert mat.step == 480 and np.array_equal(mat.data.reshape(120, 160, 3), img)
    assert np.array_equal(Mat.from_device(t).to_numpy(), img)


def test_draws_on_a_cuda_mat_match_a_host_mat(cuda):
    """Every draw on a CUDA Mat equals the same draw on a host Mat, and
    makes no blocking host-to-device copy (the sync debug mode raises on
    one)."""
    from rustcv_tpu_torch.core import Mat

    img = np.random.default_rng(4).integers(0, 256, (120, 160, 3), np.uint8)
    host, dev = Mat.from_array(img.copy()), Mat.from_array(img.copy())
    dev.device()
    _facade_draws(dev)  # warm: the first calls build nothing, but load modules
    dev = Mat.from_array(img.copy())
    dev.device()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _facade_draws(dev)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    _facade_draws(host)
    assert dev.is_on_device and dev.device().is_cuda and not host.is_on_device
    np.testing.assert_array_equal(dev.to_numpy(), host.to_numpy())


def test_harris_corners_on_a_cuda_mat_runs_k6(cuda):
    from rustcv_tpu_torch import imgproc
    from rustcv_tpu_torch.capture.simulation import synth_bgr
    from rustcv_tpu_torch.core import Mat

    img = synth_bgr(160, 120, 7)
    dev = Mat.from_array(img)
    dev.device()
    kernels.reset_launch_counts()
    got = imgproc.harris_corners(dev)
    assert kernels.launch_counts()["harris_response_i32"] == 1
    want = imgproc.harris_corners(Mat.from_array(img, device="cpu"))
    assert got.any() and np.array_equal(got, want)


def test_videocapture_and_codecs_on_the_card(cuda):
    from rustcv_tpu_torch import imgcodecs
    from rustcv_tpu_torch.core import Mat
    from rustcv_tpu_torch.prelude import VideoCapture

    drv = SimulationDriver(paced=False)
    host = VideoCapture(0, drv, decode_on_device=False)
    card = VideoCapture(0, drv, decode_on_device=True)
    default = VideoCapture(0, drv)  # follows Mat(): the card
    try:
        for cap in (host, card, default):
            assert cap.set_resolution(160, 120)
        a, b, c = Mat(), Mat(), Mat()
        for _ in range(3):
            assert host.read(a) and card.read(b) and default.read(c)
            assert b.device().is_cuda and c.device().is_cuda and not a.is_on_device
            np.testing.assert_array_equal(a.to_numpy(), b.to_numpy())
            np.testing.assert_array_equal(a.to_numpy(), c.to_numpy())
    finally:
        host.release()
        card.release()
        default.release()
    data = imgcodecs.imencode(".jpg", b, 90, backend="tpu")
    assert imgcodecs.imencode(".jpg", b, 90) == data  # the default encodes where the Mat is
    cpu = imgcodecs.imencode(".jpg", Mat.from_array(a.to_numpy(), device="cpu"), 90)
    for got, want in zip(native.jpeg_entropy_decode(data)[1], native.jpeg_entropy_decode(cpu)[1]):
        d = np.abs(got.astype(np.int64) - want)
        assert d.max() <= 1 and (d > 0).mean() < 5e-3
    dec = imgcodecs.imdecode(data, backend="tpu")
    assert dec.device().is_cuda
    want = imgcodecs.imdecode(data, backend="tpu", device="cpu").to_numpy()
    d = np.abs(dec.to_numpy().astype(np.int64) - want)
    assert d.max() <= 1 and (d > 0).mean() < 5e-3
    host = imgcodecs.imdecode(data)  # the host decode, uploaded to the card
    assert host.device().is_cuda
    np.testing.assert_array_equal(host.to_numpy(), native.jpeg_decode_bgr(data))


@pytest.mark.parametrize("colours", ["few", "many", "gray"])
def test_tiff_and_gif_on_the_card_match_the_cpu(cuda, tmp_path, colours):
    """TIFF and GIF (item 8b): ``imreadmulti`` onto the card equals the CPU
    read page for page; ``imwritemulti`` of CUDA Mats (the GIF's
    nearest-entry mapping on the card) writes the bytes CPU Mats write; an
    ``imencode(".gif")`` of a CUDA Mat likewise."""
    from rustcv_tpu_torch import imgcodecs
    from rustcv_tpu_torch.core import Mat

    rng = np.random.default_rng(22)
    if colours == "few":
        pal = rng.integers(0, 256, (100, 3), np.uint8)
        frames = [pal[rng.integers(0, 100, (61, 83))] for _ in range(3)]
    elif colours == "many":
        frames = [rng.integers(0, 256, (61, 83, 3), np.uint8) for _ in range(3)]
    else:
        frames = [rng.integers(0, 256, (61, 83), np.uint8) for _ in range(3)]
    for ext in (".tiff", ".gif"):
        written = []
        for side in ("cuda", "cpu"):
            path = tmp_path / f"{side}{ext}"
            assert imgcodecs.imwritemulti(str(path), [Mat.from_array(f.copy(), device=side)
                                                      for f in frames])
            written.append(path.read_bytes())
        assert written[0] == written[1]
        card = imgcodecs.imreadmulti(str(path), device="cuda")
        cpu = imgcodecs.imreadmulti(str(path), device="cpu")
        assert len(card) == len(cpu) == 3
        for a, b in zip(card, cpu):
            assert a.device().is_cuda
            np.testing.assert_array_equal(a.to_numpy(), b.to_numpy())
    assert imgcodecs.imencode(".gif", Mat.from_array(frames[0].copy(), device="cuda")) == \
        imgcodecs.imencode(".gif", Mat.from_array(frames[0].copy(), device="cpu"))


# -- text and the host codecs (what Pillow does in the reference) ---------------------


def test_text_blends_on_the_card_match_the_host(cuda):
    """The three device blends on CUDA tensors equal golden.blend_mask, and
    make no blocking copy (the masks, origins and colour come from pinned
    memory)."""
    from rustcv_tpu_torch.ops import draw, golden

    rng = np.random.default_rng(7)
    n, h, w = 3, 40, 70
    imgs = rng.integers(0, 256, (n, h, w, 3), np.uint8)
    masks = rng.integers(0, 256, (n, 12, 33), np.uint8)
    orgs = np.array([[5, 4], [-10, -3], [60, 35]], np.int64)
    color = (3, 200, 77)
    dev = torch.from_numpy(imgs).to(cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        at = draw.blend_mask_at(dev, masks[0], -4, 30, color)
        one = draw.blend_mask_packed_batch(dev.reshape(n, h, w * 3), np.repeat(masks[0], 3, 1),
                                           orgs, color)
        per = draw.blend_masks_packed_batch(dev.reshape(n, h, w * 3), np.repeat(masks, 3, 2),
                                            orgs, color)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for i in range(n):
        for got, m, (x0, y0) in ((at, masks[0], (-4, 30)), (one, masks[0], orgs[i]),
                                 (per, masks[i], orgs[i])):
            want = imgs[i].copy()
            golden.blend_mask(want, m, int(x0), int(y0), color)
            np.testing.assert_array_equal(got.reshape(n, h, w, 3)[i].cpu().numpy(), want)


def test_put_text_on_a_cuda_mat_matches_a_host_mat(cuda):
    from rustcv_tpu_torch import imgproc
    from rustcv_tpu_torch.core import Mat

    img = np.random.default_rng(8).integers(0, 256, (120, 160, 3), np.uint8)
    dev, host = Mat.from_array(img), Mat.from_array(img, device="cpu")
    dev.device()
    for mat, sync in ((dev, True), (host, False)):
        if sync:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            for org, scale in (((5, 30), 1.0), ((-9, 118), 2.0), ((140, 10), 0.6)):
                imgproc.put_text(mat, "FPS: 29.97 fi AV", imgproc.Point(*org), scale,
                                 imgproc.Scalar(0, 255, 255))
        finally:
            if sync:
                torch.cuda.set_sync_debug_mode(0)
    assert dev.is_on_device and dev.device().is_cuda
    np.testing.assert_array_equal(dev.to_numpy(), host.to_numpy())


@pytest.mark.parametrize("mode", [None, "pallas", "pallas_tick"])
def test_engine_text_on_the_card_matches_the_cpu(cuda, monkeypatch, mode):
    if mode is None:
        monkeypatch.delenv("RUSTCV_DECODE", raising=False)
    else:
        monkeypatch.setenv("RUSTCV_DECODE", mode)
    cfg = SimpleConfig(width=160, height=120, fps=60, pixel_format=PixelFormat.YUYV)

    def make(device):
        return MultiStreamEngine(SimulationDriver(device_count=2, paced=False), 2, cfg,
                                 filter="blur_sobel", overlay=True, device_sim=True, device=device)

    card, cpu = make("cuda"), make("cpu")
    try:
        for text in ("FPS 60.0", ["cam 0 fi", "cam 1 AV"], ["x", "Wa"]):
            a = card.tick(block=True, text=text, text_org=(4, 40)).numpy("bgr")
            b = cpu.tick(block=True, text=text, text_org=(4, 40)).numpy("bgr")
            np.testing.assert_array_equal(a, b)
    finally:
        card.close()
        cpu.close()


def test_mjpeg_backend_host_on_the_card_matches_the_cpu(cuda):
    cfg = SimpleConfig(width=160, height=120, fps=30, pixel_format=PixelFormat.MJPEG)

    def make(device):
        return MultiStreamEngine(SimulationDriver(device_count=2, paced=False), 2, cfg,
                                 mjpeg_backend="host", resize_to=(64, 48), device=device)

    card, cpu = make("cuda"), make("cpu")
    try:
        for _ in range(3):
            np.testing.assert_array_equal(card.tick(block=True).numpy("bgr"),
                                          cpu.tick(block=True).numpy("bgr"))
    finally:
        card.close()
        cpu.close()


@pytest.mark.parametrize("n_bands", [2, 4, 8])
def test_band_route_through_k1_equals_k1_on_the_whole_batch(cuda, n_bands):
    """The spatial route: each row band with its neighbours' HALO rows
    through ``band_blur_sobel`` (K1 once per band), cropped and
    concatenated, equals K1 on the whole batch and the plain chain."""
    from rustcv_tpu_torch.parallel.spatial import HALO, band_blur_sobel

    gray = torch.from_numpy(np.random.default_rng(n_bands).integers(
        0, 256, (2, 1080, 256), np.uint8)).to(cuda)
    whole = stencil.blur_sobel_mag(gray)
    assert torch.equal(whole, stencil.blur_sobel_mag_plain(gray))
    b = 1080 // n_bands
    kernels.reset_launch_counts()
    out = []
    for r in range(n_bands):
        lo, hi = r * b, (r + 1) * b
        out.append(band_blur_sobel(gray[:, lo:hi], gray[:, lo - HALO:lo] if r else None,
                                   gray[:, hi:hi + HALO] if r < n_bands - 1 else None))
    assert torch.equal(torch.cat(out, 1), whole)
    assert kernels.launch_counts()["blur_sobel_mag"] == n_bands


def test_one_rank_nccl_mesh_engine_equals_meshless(cuda, monkeypatch):
    """A one-rank NCCL mesh over the card: the engine's ticks equal the
    meshless engine's, the rows mesh's stencil equals K1, the fleet sum is
    the reference test's 9."""
    import torch.distributed as dist

    from rustcv_tpu_torch import parallel

    monkeypatch.delenv("RUSTCV_DECODE", raising=False)
    cfg = SimpleConfig(width=320, height=240, fps=60, pixel_format=PixelFormat.YUYV)
    rects = np.array([[10, 20, 100, 80]] * 4, np.int32)
    colors = np.array([[0, 255, 0]] * 4, np.uint8)
    mesh = parallel.stream_mesh("cuda")
    try:
        def make(m):
            return MultiStreamEngine(SimulationDriver(device_count=4, paced=False), 4, cfg,
                                     filter="blur_sobel", overlay=True, device_sim=True, mesh=m)

        with make(mesh) as eng, make(None) as ref:
            for _ in range(3):
                a = eng.tick(rects=rects, rect_colors=colors)
                b = ref.tick(rects=rects, rect_colors=colors)
                for key in ("bgr", "filtered"):
                    assert torch.equal(parallel.gather_streams(a.outputs[key], mesh), b.outputs[key])
                assert (parallel.gather_streams(a.sequences, mesh) == b.sequences).all()
        gray = torch.from_numpy(np.random.default_rng(3).integers(
            0, 256, (2, 240, 320), np.uint8)).to(cuda)
        rows = parallel.stream_mesh("cuda", axis="rows")
        assert torch.equal(parallel.blur_sobel_mag_spatial(gray, rows), stencil.blur_sobel_mag(gray))
        mask = np.zeros((8, 16, 16), bool)
        mask[:, 4, 4] = True
        mask[0, 8, 8] = True
        assert int(parallel.corner_counts_psum(parallel.shard_batch(mask, mesh), mesh)) == 9
    finally:
        dist.destroy_process_group()


# -- the capture backends and the first group of device ops on the card -----------

_LSB = {"cvt_lab", "cvt_lab_to_bgr", "gaussian_blur_k3", "gaussian_blur_s", "gaussian_blur_k9",
        "filter2d_general", "sep_filter_2d"}


def _slice_wrappers(ip):
    """name → call(mat) of every imgproc wrapper of the slice."""
    se = ip.get_structuring_element("ellipse", 5)
    general = np.random.default_rng(9).normal(size=(3, 5))
    calls = {
        "cvt_hsv": ip.cvt_hsv, "cvt_hsv_to_bgr": ip.cvt_hsv_to_bgr, "cvt_ycrcb": ip.cvt_ycrcb,
        "cvt_ycrcb_to_bgr": ip.cvt_ycrcb_to_bgr, "cvt_lab": ip.cvt_lab,
        "cvt_lab_to_bgr": ip.cvt_lab_to_bgr,
        "in_range": lambda m: ip.in_range(m, (20, 30, 40), (180, 200, 220)),
        "moments": ip.moments, "pyr_down": ip.pyr_down, "pyr_up": ip.pyr_up,
        "stack_blur": lambda m: ip.stack_blur(m, 7, 3), "box_blur": lambda m: ip.box_blur(m, 5),
        "gaussian_blur_k3": lambda m: ip.gaussian_blur(m, 3),
        "gaussian_blur_s": lambda m: ip.gaussian_blur(m, 5, 1.3),
        "gaussian_blur_k9": lambda m: ip.gaussian_blur(m, 9),
        "threshold": lambda m: ip.threshold(m, 100, 200, "tozero"),
        "erode": lambda m: ip.erode(m, 3), "dilate": lambda m: ip.dilate(m, 5),
        "erode_kernel": lambda m: ip.erode_kernel(m, se),
        "dilate_kernel": lambda m: ip.dilate_kernel(m, se),
        "morphology_ex": lambda m: ip.morphology_ex(m, "tophat", 5),
        "median_blur3": lambda m: ip.median_blur(m, 3), "median_blur5": lambda m: ip.median_blur(m, 5),
        "median_blur7": lambda m: ip.median_blur(m, 7),
        "filter2d_dyadic": lambda m: ip.filter2d(m, np.array([[0, 1, 0], [1, -4, 1], [0, 1, 0]]) / 2),
        "filter2d_general": lambda m: ip.filter2d(m, general),
        "sep_filter_2d": lambda m: ip.sep_filter_2d(m, [0.2, 0.5, 0.3], [0.1, 0.8, 0.1]),
        "integral": ip.integral, "sobel": lambda m: ip.sobel(m, 1, 1, 5),
        "laplacian": ip.laplacian, "scharr": lambda m: ip.scharr(m, 0, 1),
        "good_features_to_track": lambda m: ip.good_features_to_track(m, 64),
    }
    for size, mode in (((64, 48), "nearest"), ((64, 48), "area"), ((64, 48), "cubic"),
                       ((64, 48), "bilinear"), ((400, 300), "cubic"), ((400, 300), "area")):
        calls[f"resize_{mode}_{size[0]}"] = lambda m, s=size, md=mode: ip.resize(m, *s, md)
    return calls


def _slice_out(x):
    return x.to_numpy() if hasattr(x, "to_numpy") else x


@pytest.mark.parametrize("name", list(_slice_wrappers(__import__("rustcv_tpu_torch.imgproc",
                                                                 fromlist=["x"]))))
def test_slice_wrappers_on_a_cuda_mat_match_a_host_mat(cuda, name):
    from rustcv_tpu_torch import imgproc as ip
    from rustcv_tpu_torch.capture.simulation import synth_bgr
    from rustcv_tpu_torch.core import Mat

    img = synth_bgr(161, 120, 5)
    img[::7] = np.random.default_rng(1).integers(0, 256, img[::7].shape, np.uint8)
    call = _slice_wrappers(ip)[name]
    dev = Mat.from_array(img.copy())
    dev.device()
    got = call(dev)
    want = call(Mat.from_array(img.copy(), device="cpu"))
    if isinstance(got, Mat):
        assert got.is_on_device and got.device().is_cuda
    if isinstance(want, dict):
        assert got == want
        return
    got, want = _slice_out(got), _slice_out(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    tol = 1 if name in _LSB else 0
    assert np.abs(got.astype(np.int64) - want.astype(np.int64)).max(initial=0) <= tol


@pytest.mark.parametrize("name", ["adaptive_threshold", "bilateral_filter", "corner_sub_pix"])
def test_slice_gray_wrappers_on_a_cuda_mat(cuda, name):
    from rustcv_tpu_torch import imgproc as ip
    from rustcv_tpu_torch.capture.simulation import synth_bgr
    from rustcv_tpu_torch.core import Mat
    from rustcv_tpu_torch.ops import golden

    gray = np.ascontiguousarray(synth_bgr(161, 120, 5)[..., 1:2])
    dev, host = Mat.from_array(gray.copy()), Mat.from_array(gray.copy(), device="cpu")
    if name == "corner_sub_pix":
        pts = ip.good_features_to_track(host, 32) + np.float32(0.3)
        np.testing.assert_allclose(ip.corner_sub_pix(dev, pts), ip.corner_sub_pix(host, pts),
                                   atol=1e-3)
        return
    call = {"adaptive_threshold": lambda m: ip.adaptive_threshold(m, 255, "mean", 9, 2),
            "bilateral_filter": lambda m: ip.bilateral_filter(m, 25)}[name]
    np.testing.assert_array_equal(call(dev).to_numpy(), call(host).to_numpy())


def test_good_features_to_track_on_a_cuda_mat_runs_k6(cuda):
    from rustcv_tpu_torch import imgproc as ip
    from rustcv_tpu_torch.capture.simulation import synth_bgr
    from rustcv_tpu_torch.core import Mat

    img = synth_bgr(160, 120, 3)
    dev = Mat.from_array(img)
    dev.device()
    kernels.reset_launch_counts()
    got = ip.good_features_to_track(dev, 32)
    assert kernels.launch_counts()["harris_response_i32"] == 1
    np.testing.assert_array_equal(got, ip.good_features_to_track(Mat.from_array(img, device="cpu"),
                                                                 32))


@pytest.mark.parametrize("mode", [None, "xla_fused"])
def test_xla_fused_on_the_card_matches_the_default_and_the_cpu(cuda, monkeypatch, mode):
    """xla_fused ticks equal the default mode's on the card and the CPU
    port's, with one K1 launch per tick and no K4 or K5."""
    def ticks(device, m):
        if m is None:
            monkeypatch.delenv("RUSTCV_DECODE", raising=False)
        else:
            monkeypatch.setenv("RUSTCV_DECODE", m)
        eng = MultiStreamEngine(SimulationDriver(device_count=3, paced=False), 3,
                                SimpleConfig(width=320, height=240, fps=60,
                                             pixel_format=PixelFormat.YUYV),
                                filter="blur_sobel", overlay=True, device_sim=True, device=device)
        rects = np.array([[10, 20, 100, 80], [-5, -5, 400, 50], [300, 200, 40, 60]], np.int32)
        colors = np.array([[0, 255, 0], [1, 2, 3], [255, 0, 255]], np.uint8)
        out = []
        for _ in range(3):
            res = eng.tick(rects=rects, rect_colors=colors, block=True)
            out.append((res.numpy("bgr"), res.numpy("filtered")))
        eng.close()
        return out

    want = ticks("cpu", mode)
    base = ticks("cuda", None)
    kernels.reset_launch_counts()
    got = ticks("cuda", mode)
    counts = kernels.launch_counts()
    assert counts["blur_sobel_mag"] == 3
    assert counts["yuyv_decode_interleave"] == counts["yuyv_tick_fused"] == 0
    for g, w, b in zip(got, want, base):
        for x, y, z in zip(g, w, b):
            np.testing.assert_array_equal(x, y)
            np.testing.assert_array_equal(x, z)


def test_native_ring_device_decode_matches_the_host_decode(cuda):
    from rustcv_tpu_torch.capture import Camera
    from rustcv_tpu_torch.capture.native_source import NativeSimulationSource
    from rustcv_tpu_torch.core import Mat, ResolvedConfig
    from rustcv_tpu_torch.ops import decode

    src = NativeSimulationSource(ResolvedConfig(320, 240, 120, PixelFormat.YUYV, 4), paced=False)
    cam = Camera(src, None)
    try:
        for _ in range(3):
            got = cam.read_decoded_device("cuda")
            frame = sim.synth_raw(320, 240, PixelFormat.YUYV, src._prev_frame.sequence)
            mat = Mat(device="cpu")
            decode.decode_frame_host(src._prev_frame, mat)
            assert got.is_cuda
            np.testing.assert_array_equal(got.cpu().numpy(), mat.to_numpy())
            np.testing.assert_array_equal(src._prev_frame.data, frame)
    finally:
        cam.close()
        src.close()


# -- the second block of ops: every device wrapper on a CUDA Mat (or CUDA
#    tensors) against the same call on a host Mat (the CPU port) -------------

_BLOCK2_LSB = {"add_weighted", "normalize_minmax", "normalize_l1", "normalize_l2", "normalize_inf",
               "anisotropic_diffusion", "multi_band_blend"}
_BLOCK2_REL = {"norm_l2": 1e-5, "mean_std_dev": 1e-4, "psnr": 1e-5, "magnitude": 2e-6,
               "phase": 2e-6, "cart_to_polar": 2e-6, "fast_atan2": 2e-6, "cube_root": 2e-6}


def _block2_inputs(device):
    """Mats (a CUDA Mat or a host Mat) and tensors of one seeded frame."""
    from rustcv_tpu_torch.capture.simulation import synth_bgr
    from rustcv_tpu_torch.core import Mat
    from rustcv_tpu_torch.ops import color, filters

    img = synth_bgr(161, 120, 5)
    img[::7] = np.random.default_rng(1).integers(0, 256, img[::7].shape, np.uint8)
    gray = color.bgr_to_gray(torch.from_numpy(img)).numpy()
    arrays = {"bgr": img, "bgr2": np.ascontiguousarray(np.roll(img, 9, axis=1)),
              "gray": gray[..., None], "hsv": color.bgr_to_hsv(torch.from_numpy(img)).numpy(),
              "mask": ((gray > 128) * 255).astype(np.uint8)[..., None]}
    side = {}
    for k, a in arrays.items():
        m = Mat.from_array(a.copy(), device=device)
        if device == "cuda":
            m.device()
        side[k] = m
    gx, gy = filters.sobel3_gray(torch.from_numpy(gray).to(device))
    side["gx"], side["gy"] = gx.float(), gy.float()
    side["bgr_t"] = torch.from_numpy(img).to(device)
    side["bgr2_t"] = torch.from_numpy(arrays["bgr2"]).to(device)
    side["ramp"] = torch.linspace(0, 1, 161).expand(120, 161).contiguous().to(device)
    return side


def _block2_wrappers(ip):
    rot = ip.get_rotation_matrix_2d((80, 59.5), 30, 0.9)
    hom = np.array([[0.92, 0.06, 4.0], [-0.03, 0.95, 2.5], [2e-4, 4e-4, 1.0]])
    ys, xs = np.mgrid[0:120, 0:161].astype(np.float32)
    mx, my = xs * 1.02 - 1.5, ys * 0.97 + 1.25
    model = np.bincount(np.arange(180) % 30, minlength=180)[:180].astype(np.float64)
    calls = {
        "add": lambda s: ip.add(s["bgr"], s["bgr2"]),
        "subtract": lambda s: ip.subtract(s["bgr"], s["bgr2"]),
        "absdiff": lambda s: ip.absdiff(s["bgr"], s["bgr2"]),
        "add_weighted_dyadic": lambda s: ip.add_weighted(s["bgr"], 0.75, s["bgr2"], 0.25),
        "add_weighted": lambda s: ip.add_weighted(s["bgr"], 0.3, s["bgr2"], 0.6, 7.0),
        "convert_scale_abs": lambda s: ip.convert_scale_abs(s["bgr"], -1.3, 40.0),
        "bitwise_and": lambda s: ip.bitwise_and(s["bgr"], s["bgr2"]),
        "bitwise_or": lambda s: ip.bitwise_or(s["bgr"], s["bgr2"]),
        "bitwise_xor": lambda s: ip.bitwise_xor(s["bgr"], s["bgr2"]),
        "bitwise_not": lambda s: ip.bitwise_not(s["bgr"]),
        "count_non_zero": lambda s: ip.count_non_zero(s["mask"]),
        "norm_l1": lambda s: ip.norm(s["bgr"], "l1"),
        "norm_l2": lambda s: ip.norm(s["bgr"], "l2"),
        "norm_inf": lambda s: ip.norm(s["gray"], "inf"),
        "mean_std_dev": lambda s: ip.mean_std_dev(s["bgr"]),
        "psnr": lambda s: ip.psnr(s["bgr"], s["bgr2"]),
        "calc_hist": lambda s: ip.calc_hist(s["bgr"]),
        "equalize_hist": lambda s: ip.equalize_hist(s["gray"]),
        "lut": lambda s: ip.lut(s["bgr"], np.arange(256)[::-1]),
        "apply_color_map": lambda s: ip.apply_color_map(s["gray"], "jet"),
        "clahe": lambda s: ip.clahe(s["gray"], 40, (8, 8)),
        "back_project": lambda s: ip.back_project(s["hsv"], model),
        "remap": lambda s: ip.remap(s["bgr"], mx, my),
        "remap_replicate": lambda s: ip.remap(s["bgr"], mx, my, "replicate"),
        "warp_polar": lambda s: ip.warp_polar(s["bgr"], (80, 60), 60.0, (90, 70)),
        "warp_polar_inverse": lambda s: ip.warp_polar(s["bgr"], (80, 60), 60.0, (120, 161), True,
                                                      True),
        "rotate": lambda s: ip.rotate(s["gray"], 90),
        "flip": lambda s: ip.flip(s["bgr"], -1),
        "thinning": lambda s: ip.thinning(s["mask"]),
        "anisotropic_diffusion": lambda s: ip.anisotropic_diffusion(s["bgr"]),
        "multi_band_blend": lambda s: ip.multi_band_blend(s["bgr_t"], s["bgr2_t"], s["ramp"], 5),
        "magnitude": lambda s: ip.magnitude(s["gx"], s["gy"]),
        "phase": lambda s: ip.phase(s["gx"], s["gy"]),
        "cart_to_polar": lambda s: ip.cart_to_polar(s["gx"], s["gy"], True),
        "fast_atan2": lambda s: ip.fast_atan2(s["gy"], s["gx"]),
        "cube_root": lambda s: ip.cube_root(s["gx"] * s["gy"]),
    }
    for kind in ("minmax", "l1", "l2", "inf"):
        calls[f"normalize_{kind}"] = lambda s, k=kind: ip.normalize(s["bgr"], 200.0, 10.0, k)
    for mode in ("bilinear", "nearest"):
        for border in ("constant", "replicate"):
            calls[f"warp_affine_{mode}_{border}"] = (
                lambda s, m=mode, b=border: ip.warp_affine(s["bgr"], rot, (161, 120), m, b))
            calls[f"warp_perspective_{mode}_{border}"] = (
                lambda s, m=mode, b=border: ip.warp_perspective(s["bgr"], hom, (150, 130), m, b))
    return calls


def _block2_np(x):
    if isinstance(x, tuple):
        return tuple(_block2_np(v) for v in x)
    if hasattr(x, "to_numpy"):
        assert not x.is_on_device or x.device().is_cuda
        return x.to_numpy()
    if torch.is_tensor(x):
        return x.cpu().numpy()
    return np.asarray(x)


@pytest.mark.parametrize("name", list(_block2_wrappers(__import__("rustcv_tpu_torch.imgproc",
                                                                  fromlist=["x"]))))
def test_block2_wrappers_on_the_card_match_the_cpu_port(cuda, name):
    from rustcv_tpu_torch import imgproc as ip

    call = _block2_wrappers(ip)[name]
    got = call(_block2_inputs("cuda"))
    want = call(_block2_inputs("cpu"))
    if hasattr(got, "is_on_device"):
        assert got.is_on_device and got.device().is_cuda
    got, want = _block2_np(got), _block2_np(want)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert g.shape == w.shape and g.dtype == w.dtype
        if name in _BLOCK2_REL:
            np.testing.assert_allclose(g, w, rtol=_BLOCK2_REL[name], atol=1e-5)
        else:
            tol = 1 if name in _BLOCK2_LSB else 0
            assert np.abs(g.astype(np.int64) - w.astype(np.int64)).max(initial=0) <= tol


# -- group 2, features and flow: every device call on a CUDA Mat or CUDA
#    tensors against the same call on the host (a host Mat runs the
#    reference's numpy form, a CPU-tensor Mat or tensor the port's op), with
#    the reference's device-vs-oracle tolerances; and the full-float32 guard
#    against TF32 ------------------------------------------------------------

_G2_W, _G2_H = 160, 136
_G2_MOTION = np.array([[1.0, 0.0005, 1.6], [-0.0005, 1.0, -0.9]])


def _g2_inputs(device):
    """A CUDA side or a host side of one seeded textured frame, the frame
    moved by _G2_MOTION, three noisy copies and a unit-normal plane."""
    from rustcv_tpu_torch.core import Mat
    from rustcv_tpu_torch.ops import golden, warp

    rng = np.random.default_rng(3)
    gray = golden.gaussian5_u8(golden.gaussian5_u8(rng.integers(0, 256, (_G2_H, _G2_W), np.uint8)))
    gray2 = warp.warp_affine_numpy(gray, _G2_MOTION, (_G2_W, _G2_H), border="replicate")
    obs = [np.clip(gray + rng.normal(0, 20, gray.shape), 0, 255).astype(np.uint8) for _ in range(3)]
    card = device == "cuda"

    def mat(a):
        m = Mat.from_array(a[..., None].copy(), device=device)
        if card:
            m.device()
        return m

    def tmat(a):
        return mat(a) if card else Mat.from_device(torch.from_numpy(a.copy()))

    return {"host": not card, "dev": device, "gray": mat(gray), "gray2": mat(gray2),
            "gray_c": tmat(gray), "gray2_c": tmat(gray2), "obs_c": [tmat(o) for o in obs],
            "tmpl_c": tmat(gray[40:52, 60:74]), "tmpl_fft_c": tmat(gray[30:62, 50:82]),
            "gray_t": torch.from_numpy(gray).to(device), "gray2_t": torch.from_numpy(gray2).to(device),
            "gray_np": gray, "plane_t": torch.from_numpy(rng.normal(0, 1, (96, 128)).astype(
                np.float32)).to(device)}


def _g2_points(n, seed):
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(20, _G2_W - 21, n), rng.uniform(20, _G2_H - 21, n)], 1)
    edge = [[3.0, 60.0], [_G2_W - 5.0, 40.0], [80.0, 2.5], [70.0, _G2_H - 4.0], [12.0, 14.0]]
    return np.concatenate([pts, edge]).astype(np.float32)


def _g2_brief_match(ip, s):
    pts = _g2_points(40, 5)
    d1, v1 = ip.compute_brief(s["gray"], pts)
    d2, v2 = ip.compute_brief(s["gray2"], pts @ _G2_MOTION[:, :2].T.astype(np.float32)
                              + _G2_MOTION[:, 2].astype(np.float32))
    on = (lambda a: a) if s["host"] else (lambda a: torch.from_numpy(a).to(s["dev"]))
    return d1, v1, d2, v2, ip.match_descriptors(on(d1), on(d2), on(v1), on(v2))


def _g2_calls(ip):
    """name → (call on a side, tolerance): 0 exact; ("scaled", r) |Δ| ≤
    r·max(1, max |host|); ("abs", a); ("flow", max, border); "lk"; "orb";
    "ecc"; ("lsb", n); ("keypoints", rule)."""
    from rustcv_tpu_torch.ops import hog, template

    svm = np.random.default_rng(4).normal(0, 0.05, 3780).astype(np.float32)
    lk_pts = _g2_points(60, 6)
    calls = {}
    for k in (3, 5):
        calls[f"spatial_gradient_k{k}"] = (lambda s, k=k: ip.spatial_gradient(s["gray_t"], k), 0)
        for name in ("corner_min_eigen_val", "pre_corner_detect"):
            args = (3, k) if name == "corner_min_eigen_val" else (k,)
            calls[f"{name}_k{k}"] = (lambda s, n=name, a=args: getattr(ip, n)(s["gray_t"], *a),
                                     ("scaled", 3e-6))
        calls[f"corner_eigen_vals_and_vecs_k{k}"] = (
            lambda s, k=k: ip.corner_eigen_vals_and_vecs(s["gray_t"], 3, k)[..., :2], ("scaled", 3e-6))
    calls.update({
        "fast_corners": (lambda s: ip.fast_corners(s["gray"], 10, max_corners=400), 0),
        "orb_features": (lambda s: ip.orb_features(s["gray"], 64, 10), "orb"),
        "brief_match": (lambda s: _g2_brief_match(ip, s), 0),
        "lk": (lambda s: ip.calc_optical_flow_pyr_lk(s["gray"], s["gray2"], lk_pts, 15, 2), "lk"),
        "farneback": (lambda s: ip.calc_optical_flow_farneback(s["gray_c"], s["gray2_c"]),
                      ("flow", 0.05, 0)),
        "dis": (lambda s: ip.calc_optical_flow_dis(s["gray_c"], s["gray2_c"]), ("flow", 0.05, 16)),
        "dis_refine": (lambda s: ip.calc_optical_flow_dis(s["gray_c"], s["gray2_c"], refine=True),
                       ("flow", 0.05, 16)),
        "denoise_tvl1": (lambda s: np.squeeze(ip.denoise_tvl1(s["obs_c"], 1.0, 30)), ("lsb", 1)),
        "phase_correlate": (lambda s: ip.phase_correlate(s["gray"], s["gray2"]), ("abs", 1e-3)),
        "phase_correlate_no_window": (lambda s: ip.phase_correlate(s["gray"], s["gray2"], False),
                                      ("abs", 1e-3)),
        "dft": (lambda s: ip.dft(s["plane_t"]), ("abs", 2e-5 * 200)),
        "idft": (lambda s: ip.idft(ip.dft(s["plane_t"])).real, ("abs", 1e-3)),
        "dct": (lambda s: ip.dct(s["plane_t"]), ("abs", 1e-4)),
        "idct": (lambda s: ip.idct(ip.dct(s["plane_t"])), ("abs", 1e-4)),
        "hog_descriptor": (lambda s: ip.hog_descriptor(s["gray"]), ("abs", 2e-4)),
        "hog_score_map": (lambda s: hog.hog_score_map_numpy(s["gray_np"], svm, 0.1) if s["host"]
                          else hog.hog_score_map(s["gray_t"], svm, 0.1), ("abs", 1e-2)),
        "sift": (lambda s: ip.sift_features(s["gray"]), ("keypoints", "count")),
        "akaze": (lambda s: ip.akaze_features(s["gray"], 3, 3), ("keypoints", "shared")),
        "min_max_loc": (lambda s: template.min_max_loc(template.match_template(
            s["gray_t"], s["gray_t"][40:52, 60:74], "sqdiff")), "minmax"),
    })
    for m in ("ccoeff_normed", "ccorr_normed", "sqdiff"):
        for t in ("tmpl_c", "tmpl_fft_c"):
            calls[f"match_template_{t}_{m}"] = (
                lambda s, t=t, m=m: ip.match_template(s["gray_c"], s[t], m), ("template", 1e-4))
    for motion in ("affine", "homography"):
        calls[f"ecc_{motion}"] = (lambda s, m=motion: ip.find_transform_ecc(
            s["gray_t"], s["gray2_t"], m, iterations=50, backend="device"), "ecc")
    return calls


def _g2_np(x):
    if isinstance(x, tuple):
        return tuple(_g2_np(v) for v in x)
    if hasattr(x, "to_numpy"):
        return x.to_numpy()
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _g2_check(name, tol, got, want):
    if tol == 0:
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert g.shape == w.shape and g.dtype == w.dtype, name
            np.testing.assert_array_equal(g, w)
    elif tol == "orb":
        for i in (0, 2, 3):
            np.testing.assert_array_equal(got[i], want[i])
        assert np.abs(got[1] - want[1]).max() < 1e-3
    elif tol == "lk":
        np.testing.assert_array_equal(got[1], want[1])
        assert np.abs(got[0] - want[0]).max() < 1e-3
    elif tol == "ecc":
        assert abs(float(got[0]) - float(want[0])) < 1e-3
        assert np.abs(got[1] - want[1]).max() < 0.05
    elif tol == "minmax":
        assert got[2] == want[2] == (60, 40)
    elif tol[0] == "scaled":
        assert np.abs(got - want).max() <= tol[1] * max(1.0, float(np.abs(want).max()))
    elif tol[0] == "abs":
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert np.abs(np.asarray(g) - np.asarray(w)).max() <= tol[1], name
    elif tol[0] == "flow":
        b = tol[2]
        sl = np.s_[b:got.shape[0] - b, b:got.shape[1] - b]
        assert got.shape == want.shape and np.abs(got[sl] - want[sl]).max() < tol[1]
    elif tol[0] == "lsb":
        assert np.abs(got.astype(np.int64) - want).max() <= tol[1]
    elif tol[0] == "template":
        assert np.abs(got - want).max() / max(1.0, float(np.abs(want).max())) < tol[1]
    elif tol[0] == "keypoints":
        sg = {tuple(np.round(k[:2], 1)) for k in got[0]}
        sw = {tuple(np.round(k[:2], 1)) for k in want[0]}
        if tol[1] == "count":
            assert abs(len(got[0]) - len(want[0])) <= max(3, 0.15 * len(want[0])) and len(want[0])
        else:
            assert len(sg & sw) > 0.9 * max(len(sg), len(sw)) and len(sw)


@pytest.mark.parametrize("name", list(_g2_calls(__import__("rustcv_tpu_torch.imgproc",
                                                           fromlist=["x"]))))
def test_group2_on_the_card_matches_the_cpu_port(cuda, name):
    from rustcv_tpu_torch import imgproc as ip
    from rustcv_tpu_torch.ops import kernels

    call, tol = _g2_calls(ip)[name]
    kernels.reset_launch_counts()
    got = call(_g2_inputs("cuda"))
    assert not any(kernels.launch_counts().values())  # group 2 runs no kernel
    if hasattr(got, "is_cuda"):
        assert got.is_cuda
    want = call(_g2_inputs("cpu"))
    _g2_check(name, tol, _g2_np(got), _g2_np(want))


def test_ecc_device_twin_reads_nothing_back_before_its_end(cuda, monkeypatch):
    """The twin's 50 iterations freeze on the device: no ``.item()`` or
    host copy of a CUDA tensor inside the loop."""
    from rustcv_tpu_torch.ops import ecc

    s = _g2_inputs("cuda")
    calls = []
    real = torch.Tensor.item

    def spy(self):
        calls.append(self.device.type)
        return real(self)

    monkeypatch.setattr(torch.Tensor, "item", spy)
    rho, p = ecc._ecc_core(s["gray_t"], s["gray2_t"], torch.tensor([1.0, 0, 0, 0, 1.0, 0]),
                           "affine", 50, 1e-6)
    assert calls == [] and rho.is_cuda and p.is_cuda


def test_full_f32_guard_holds_under_tf32(cuda):
    """TF32 switched on globally (cuDNN's default, and what
    ``torch.set_float32_matmul_precision("high")`` does): the DCT's basis
    products, template matching's correlation and ECC's normal equations
    still meet the float64 oracles at the reference's tolerances, and the
    flags are as the caller left them afterwards. The raw product under
    TF32 is shown to miss the DCT's tolerance, so this test can see TF32."""
    from rustcv_tpu_torch.ops import template, transform

    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        a = np.random.default_rng(7).normal(0, 1, (512, 768)).astype(np.float32)
        want = transform.dct_numpy(a)
        t = torch.from_numpy(a).to(cuda)
        bh = torch.as_tensor(transform._dct_basis(512), dtype=torch.float32, device=cuda)
        bw = torch.as_tensor(transform._dct_basis(768), dtype=torch.float32, device=cuda)
        raw = ((bh @ t) @ bw.T).cpu().numpy()
        assert np.abs(raw - want).max() > 1e-4  # a bare product under TF32 misses the tolerance
        assert np.abs(transform.dct(t).cpu().numpy() - want).max() < 1e-4
        assert np.abs(transform.idct(transform.dct(t)).cpu().numpy() - a).max() < 1e-4
        s = _g2_inputs("cuda")
        img, tm = s["gray_np"], s["gray_np"][40:52, 60:74]
        for m in template.METHODS:
            got = template.match_template(s["gray_t"], torch.from_numpy(tm).to(cuda), m).cpu().numpy()
            ref = template.match_template_numpy(img, tm, m)
            assert np.abs(got - ref).max() / max(1.0, float(np.abs(ref).max())) < 1e-4
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


# -- group 3 and the segmentation head of group 4: each call on CUDA inputs
#    against the same call on CPU inputs ---------------------------------------

def test_make_dummy_overlay_defaults_to_the_card(cuda):
    from rustcv_tpu_torch.runtime.pipeline import make_dummy_overlay

    rects, colors, _ = make_dummy_overlay(4)
    assert rects.device.type == colors.device.type == "cuda"
    assert make_dummy_overlay(4, device="cpu")[0].device.type == "cpu"


def _g3_clip(n=6, h=72, w=96, seed=30):
    """A seeded gray clip: a bright square moving 3 px a frame, a darkened
    band from frame 3 (MOG2's shadows)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(60, 200, (h, w, 3)).astype(np.uint8)
    out = []
    for t in range(n):
        f = np.clip(base.astype(int) + rng.integers(-2, 3, base.shape), 0, 255).astype(np.uint8)
        f[20:36, 10 + 3 * t:26 + 3 * t] = 250
        if t >= 3:
            f[50:62] = (f[50:62] * 0.6).astype(np.uint8)
        out.append(f)
    return np.stack(out)


def _g3_calls():
    """name → (call on a device name, check(got, want) on numpy)."""
    from rustcv_tpu_torch import imgproc as ip
    from rustcv_tpu_torch.ops import bgsub, ccl, csrt, kalman, kcf, meanshift_filter, tracker

    clip = _g3_clip()
    gray = clip[..., 1].copy()
    rng = np.random.default_rng(31)
    mask = (rng.random((72, 96)) < 0.45).astype(np.uint8) * 255

    def t(a, dev):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def mog2(frames, shadows):
        def call(dev):
            sub = bgsub.BackgroundSubtractorMOG2(detect_shadows=shadows)
            return np.stack([sub.apply(t(f, dev)).cpu().numpy() for f in frames])
        return call

    def knn(dev):
        sub = ip.create_background_subtractor_knn()
        return np.stack([sub.apply(t(f, dev)).cpu().numpy() for f in clip])

    def track(mod, boxes):
        def call(dev):
            st = mod.init(t(gray[0], dev), boxes)
            out = []
            for f in gray[1:]:
                st, ok, score = mod.step(st, t(f, dev))
                out.append(np.concatenate([st.center.cpu().numpy().ravel(),
                                           ok.cpu().numpy().ravel(), score.cpu().numpy().ravel()]))
            assert st.center.device.type == torch.device(dev).type
            return np.stack(out)
        return call

    def scan(dev):
        n = 64
        a = np.eye(4, dtype=np.float32)
        a[0, 2] = a[1, 3] = 1
        zs = np.random.default_rng(32).normal(0, 1, (20, n, 2)).astype(np.float32)
        xs, xf, pf = kalman.filter_scan(t(np.zeros((n, 4), np.float32), dev),
                                        t(np.tile(np.eye(4, dtype=np.float32), (n, 1, 1)), dev),
                                        t(zs, dev), t(a, dev), t(np.eye(2, 4, dtype=np.float32), dev),
                                        t(np.eye(4, dtype=np.float32) * 0.01, dev),
                                        t(np.eye(2, dtype=np.float32) * 0.5, dev))
        return xs.cpu().numpy()

    def track_check(n):
        """Centres and ``ok`` equal, the scores within 5e-3, per step."""
        def check(got, want):
            assert np.array_equal(got[:, :3 * n], want[:, :3 * n])
            assert np.abs(got[:, 3 * n:] - want[:, 3 * n:]).max() < 5e-3
        return check

    def within1(got, want):
        assert (np.abs(got.astype(int) - want) <= 1).mean() > 0.99

    def share(rate):
        def check(got, want):
            assert got.shape == want.shape and (got == want).mean() >= rate
        return check

    def exact(got, want):
        if isinstance(want, tuple):
            for g, w in zip(got, want):
                exact(g, w)
            return
        assert np.array_equal(np.asarray(got), np.asarray(want))

    boxes4 = [(10, 20, 16, 16), (40, 10, 16, 16), (60, 40, 16, 16), (20, 46, 16, 16)]
    markers = np.zeros((72, 96), np.int32)
    markers[5, 5], markers[60, 90], markers[36, 48] = 1, 2, 3
    return {
        "mog2 gray": (mog2(gray, False), share(0.9999)),
        "mog2 bgr": (mog2(clip, False), share(0.9999)),
        "mog2 bgr shadows": (mog2(clip, True), share(0.9999)),
        "knn": (knn, exact),
        "mosse": (track(tracker, (20, 18, 24, 24)), track_check(1)),
        "kcf": (track(kcf, (10, 20, 16, 16)), track_check(1)),
        "csrt": (track(csrt, (10, 20, 16, 16)), track_check(1)),
        "mosse bank": (track(tracker, [(x, y, 24, 24) for x, y, _, _ in boxes4]), track_check(4)),
        "kcf bank": (track(kcf, boxes4), track_check(4)),
        "csrt bank": (track(csrt, boxes4), track_check(4)),
        "filter_scan": (scan, lambda g, w: np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)),
        "pyr_mean_shift": (lambda dev: meanshift_filter.pyr_mean_shift(
            t(clip[0, :32, :40], dev), sp=3, sr=25.0, max_iter=3).cpu().numpy(), within1),
        "kmeans_quantize": (lambda dev: ip.kmeans_quantize(Mat.from_device(t(clip[0], dev)), 8)[0]
                            .to_numpy(), share(0.999)),
        "watershed": (lambda dev: ip.watershed(Mat.from_device(t(gray[0][..., None], dev)),
                                               markers), exact),
        "slic": (lambda dev: ip.slic_superpixels(t(clip[0], dev), region_size=16)[0], share(0.97)),
        "components": (lambda dev: ip.connected_components_with_stats(
            Mat.from_device(t(mask[..., None], dev)))[1:], exact),
        "components 8": (lambda dev: ccl.connected_components(t(mask, dev), connectivity=8), exact),
        "find_contours": (lambda dev: tuple(ip.find_contours(Mat.from_device(t(mask[..., None],
                                                                               dev)))), exact),
        "distance_transform": (lambda dev: ip.distance_transform(
            Mat.from_device(t(mask[..., None], dev))), exact),
        "distance_l2": (lambda dev: ccl.distance_transform_l2_with_labels(t(mask, dev)), exact),
        "detect_blobs": (lambda dev: ip.detect_blobs(Mat.from_device(t(np.where(
            mask[..., None] > 0, 40, 220).astype(np.uint8), dev))), exact),
        "voronoi_seam": (lambda dev: ip.voronoi_seam(t(mask, dev), t(255 - mask, dev)), exact),
    }


@pytest.mark.parametrize("name", list(_g3_calls()))
def test_group3_on_the_card_matches_the_cpu(cuda, name):
    call, check = _g3_calls()[name]
    kernels.reset_launch_counts()
    got = call("cuda")
    assert not any(kernels.launch_counts().values())  # this slice runs no kernel
    check(got, call("cpu"))


def test_subtractor_and_tracker_state_stays_on_the_card(cuda, monkeypatch):
    """The models and filters live on the card between frames; a frame
    costs the trackers one host read (``ok``, the score, the centre) and
    the subtractors none."""
    from rustcv_tpu_torch import imgproc as ip
    from rustcv_tpu_torch.ops import csrt, kcf, tracker

    clip = _g3_clip()
    mog2 = ip.create_background_subtractor_mog2(detect_shadows=True)
    knn = ip.create_background_subtractor_knn()
    reads = []
    real = torch.Tensor.cpu

    def spy(self, *a, **k):
        reads.append(self.device.type)
        return real(self, *a, **k)

    monkeypatch.setattr(torch.Tensor, "cpu", spy)
    for f in clip:
        m = Mat.from_device(torch.from_numpy(f).to(cuda))
        assert mog2.apply(m).is_cuda and knn.apply(m).is_cuda
    assert all(s.is_cuda for s in mog2._state) and knn._state.samples.is_cuda
    assert knn._state.clock.is_cuda and reads == []
    for cls in (tracker.TrackerMOSSE, kcf.TrackerKCF, csrt.TrackerCSRT):
        trk = cls()
        trk.init(Mat.from_device(torch.from_numpy(clip[0]).to(cuda)), (10, 20, 16, 16))
        reads.clear()
        for f in clip[1:]:
            trk.update(Mat.from_device(torch.from_numpy(f).to(cuda)))
        assert all(v.is_cuda for v in trk._state) and reads == ["cuda"] * (len(clip) - 1)
    monkeypatch.setattr(torch.Tensor, "cpu", real)
    fresh = ip.create_background_subtractor_mog2()  # a numpy frame goes to the card
    assert isinstance(fresh.apply(clip[0]), np.ndarray) and fresh._state[0].is_cuda


def test_a_bank_runs_as_one_batch(cuda):
    """A bank of 4 steps once for all 4 (one call, every field with a bank
    axis of 4) and equals 4 lone trackers."""
    from rustcv_tpu_torch.ops import csrt, kcf, tracker

    gray = torch.from_numpy(_g3_clip()[..., 1].copy()).to(cuda)
    boxes = [(10, 20, 16, 16), (40, 10, 16, 16), (60, 40, 16, 16), (20, 46, 16, 16)]
    for mod in (tracker, kcf, csrt):
        bank = mod.init(gray[0], boxes)
        lone = [mod.init(gray[0], b) for b in boxes]
        for f in gray[1:]:
            bank, ok, score = mod.step(bank, f)
            assert all(v.shape[0] == 4 for v in bank) and ok.shape == score.shape == (4,)
            steps = [mod.step(s, f) for s in lone]
            lone = [s for s, _, _ in steps]
            assert torch.equal(bank.center, torch.cat([s.center for s in lone]))
            assert torch.allclose(score, torch.cat([sc for _, _, sc in steps]), atol=1e-5)


def test_full_f32_is_in_force_around_kmeans_and_kalman(cuda, monkeypatch):
    """With TF32 switched on globally, every product k-means and the Kalman
    banks run sees it off (``ops/tensors.full_f32``), and the results meet
    the float64 oracles at the reference's tolerances."""
    from rustcv_tpu_torch.ops import golden, kalman, kmeans

    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    seen = []
    real_einsum, real_matmul = torch.einsum, torch.Tensor.__matmul__

    def einsum(*a, **k):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return real_einsum(*a, **k)

    def matmul(self, other):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return real_matmul(self, other)

    try:
        monkeypatch.setattr(torch, "einsum", einsum)
        monkeypatch.setattr(torch.Tensor, "__matmul__", matmul)
        rng = np.random.default_rng(33)
        pts = np.concatenate([rng.normal(m, 3.0, (4000, 3)) for m in (20, 120, 220)]
                             ).astype(np.float32)
        init = kmeans.kmeans_pp_init(pts, 3)
        c, lab, _ = kmeans.kmeans(torch.from_numpy(pts).to(cuda), 3, 10, init_centers=init)
        oc, ol, _ = kmeans.kmeans_numpy(pts, 3, 10, init_centers=init)
        assert np.abs(c.cpu().numpy() - oc).max() < 1e-3
        assert (lab.cpu().numpy() == ol).mean() > 0.999
        A = np.array([[1.0, 1.0], [0.0, 1.0]])
        H, Q, R = np.array([[1.0, 0.0]]), np.eye(2) * 1e-2, np.array([[0.5]])
        x = rng.normal(size=(16, 2)) * 100
        P = np.stack([np.eye(2) * (1 + i) for i in range(16)])
        z = rng.normal(size=(16, 1)) * 100
        on = [torch.from_numpy(v).to(cuda) for v in (x, P, A, Q)]
        xp, Pp = kalman.predict_batch(*on)
        xn, Pn, K = kalman.correct_batch(xp, Pp, *[torch.from_numpy(v).to(cuda) for v in (z, H, R)])
        for i in range(16):
            gx, gP = golden.kalman_predict(x[i], P[i], A, Q)
            gxc, gPc, gK = golden.kalman_correct(gx, gP, z[i], H, R)
            np.testing.assert_allclose(xn[i].cpu().numpy(), gxc, rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(K[i].cpu().numpy(), gK, rtol=1e-4, atol=1e-5)
        assert seen and not any(seen)
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


@functools.lru_cache(maxsize=1)
def _g4a_inputs():
    """Seeded inputs of group 4a (made once): a textured gray image, a
    scene of discs, a noisy step, a BGR stack of the three, a cascade
    trained on seeded patches."""
    from rustcv_tpu_torch.ops import cascade, golden

    rng = np.random.default_rng(40)
    tex = golden.gaussian5_u8(rng.integers(0, 256, (72, 140), np.uint8))
    h, w = 72, 96
    yy, xx = np.mgrid[0:h, 0:w]
    discs = np.full((h, w), 30, np.uint8)
    for cy, cx, r in ((24, 30, 14), (48, 70, 18)):
        discs[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = 200
    discs = np.clip(discs.astype(int) + rng.integers(-8, 8, (h, w)), 0, 255).astype(np.uint8)
    step = np.full((h, w), 60, np.uint8)
    step[:, w // 2:] = 190
    step = np.clip(step + rng.normal(0, 12, (h, w)), 0, 255).astype(np.uint8)
    bgr = np.stack([step, discs, tex[:, :w]], -1)
    pos = rng.integers(90, 130, (30, 24, 24))
    pos[:, 4:10, 3:21] = 30
    pos[:, 14:22, 6:18] = 200
    model = cascade.train_cascade(pos.astype(np.uint8),
                                  rng.integers(0, 256, (60, 24, 24)).astype(np.uint8),
                                  n_stages=2, n_stumps=4, stride=8)
    return tex, discs, step, bgr, model


def _g4a_calls():
    """name → (call on a device name, check(got, want) on numpy)."""
    from rustcv_tpu_torch import imgproc as ip
    from rustcv_tpu_torch.ops import (cascade, dtfilter, ghough, hdr, hough, inpaint, nlmeans,
                                      poisson, sgbm, stereo)

    tex, discs, step, bgr, model = _g4a_inputs()
    left, right = tex[:, :96].copy(), tex[:, 7:103].copy()
    edges = np.where(discs > 120, 255, 0).astype(np.uint8)
    hole = np.zeros(step.shape, bool)
    hole[20:30, 10:80] = True

    def t(a, dev):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def host(x):
        if isinstance(x, (tuple, list)):
            return tuple(host(v) for v in x)
        return x.cpu().numpy() if isinstance(x, torch.Tensor) else x

    def exact(got, want):
        if isinstance(want, tuple):
            for g, w in zip(got, want):
                exact(g, w)
            return
        assert np.array_equal(np.asarray(got), np.asarray(want))

    def within(n):
        def check(got, want):
            for g, w in zip(got if isinstance(got, tuple) else (got,),
                            want if isinstance(want, tuple) else (want,)):
                assert np.abs(np.asarray(g).astype(np.float64) - np.asarray(w)).max() <= n
        return check

    def disparity(tol):
        def check(got, want):
            assert np.array_equal(got[1], want[1])
            assert np.array_equal(np.floor(got[0] + 0.5), np.floor(want[0] + 0.5))
            assert np.abs(got[0] - want[0]).max() <= tol
        return check

    def band(got, want, eps=1e-3):
        """``ok`` equal wherever the CPU margin is clear of the stage
        threshold by more than ``eps``; margins within 1e-3."""
        outside = np.abs(want[1]) > eps
        assert np.array_equal(got[0][outside], want[0][outside])
        assert np.abs(got[1] - want[1]).max() <= 1e-3

    stack = np.stack([bgr // 4, bgr // 2, bgr])
    return {
        "hough_lines": (lambda dev: host(hough.hough_lines(t(edges, dev), threshold=10)), exact),
        "hough_lines_p": (lambda dev: hough.hough_lines_p(t(edges, dev), threshold=10), exact),
        "hough_circles": (lambda dev: host(hough.hough_circles(
            t(discs, dev), min_radius=8, max_radius=24, vote_threshold=10)), exact),
        "ghough": (lambda dev: host(ghough.ghough_accumulate(
            t(discs, dev), ghough.build_r_table(discs[10:40, 14:46]))), exact),
        "stereo_bm": (lambda dev: host(stereo.stereo_bm(t(left, dev), t(right, dev), 16, 9)),
                      disparity(1e-4)),
        "stereo_sgbm 4": (lambda dev: host(sgbm.stereo_sgbm(t(left, dev), t(right, dev), 16,
                                                            num_dirs=4)), disparity(1e-3)),
        "stereo_sgbm 8": (lambda dev: host(sgbm.stereo_sgbm(t(left, dev), t(right, dev), 16)),
                          disparity(1e-3)),
        "nl_means": (lambda dev: host(nlmeans.nl_means(t(step, dev), 12.0, 5, 11)), within(1)),
        "nl_means_colored": (lambda dev: host(nlmeans.nl_means_colored(t(bgr, dev), 10, 10, 5, 9)),
                             within(1)),
        "nl_means_multi": (lambda dev: host(nlmeans.nl_means_multi(
            t(np.stack([step, discs, step]), dev), 1, 3, 12.0, 5, 9)), within(1)),
        "dt_filter": (lambda dev: host(dtfilter.dt_filter(t(bgr, dev), t(bgr, dev))), within(1)),
        "detail_enhance": (lambda dev: host(dtfilter.detail_enhance(t(bgr, dev))), within(2)),
        "stylization": (lambda dev: host(dtfilter.stylization(t(bgr, dev))), within(2)),
        "pencil_sketch": (lambda dev: host(dtfilter.pencil_sketch(t(bgr, dev))), within(2)),
        "guided_filter": (lambda dev: host(dtfilter.guided_filter(t(step, dev), t(bgr, dev), 5)),
                          within(1)),
        "seamless_clone": (lambda dev: host(poisson.seamless_clone(
            bgr[10:40, 10:50], t(bgr[:, ::-1], dev), np.ones((30, 40), bool), (48, 36), 1, 800)),
            within(1)),
        "seamless_clone mixed": (lambda dev: host(poisson.seamless_clone(
            bgr[10:40, 10:50], t(bgr[:, ::-1], dev), np.ones((30, 40), bool), (48, 36), 2, 800)),
            within(1)),
        "inpaint_diffusion": (lambda dev: host(inpaint.inpaint_diffusion(t(bgr, dev), hole, 800)),
                              within(1)),
        "merge_mertens": (lambda dev: host(hdr.merge_mertens(t(stack, dev))), within(2e-3)),
        "cascade": (lambda dev: cascade.score_windows_device(t(tex, dev), model), band),
        "wrappers": (lambda dev: (ip.hough_circles(Mat.from_device(t(discs[..., None], dev)),
                                                   min_radius=8, max_radius=24,
                                                   vote_threshold=10),
                                  ip.fast_nl_means_denoising(Mat.from_device(t(step[..., None], dev)),
                                                             12.0, 5, 9).to_numpy(),
                                  ip.edge_preserving_filter(Mat.from_device(t(bgr, dev))).to_numpy(),
                                  ip.inpaint(Mat.from_device(t(bgr, dev)), hole,
                                             method="diffusion").to_numpy()),
                     within(1)),
    }


@pytest.mark.parametrize("name", list(_g4a_calls()))
def test_group4a_on_the_card_matches_the_cpu(cuda, name):
    call, check = _g4a_calls()[name]
    kernels.reset_launch_counts()
    got = call("cuda")
    assert not any(kernels.launch_counts().values())  # this slice runs no kernel
    check(got, call("cpu"))


def test_group4a_results_stay_on_the_card(cuda):
    """The device twins take CUDA tensors and return CUDA tensors; a device
    Mat's wrapper returns a device Mat."""
    from rustcv_tpu_torch import imgproc as ip
    from rustcv_tpu_torch.ops import (dtfilter, ghough, hdr, hough, inpaint, nlmeans, poisson,
                                      sgbm, stereo)

    tex, discs, step, bgr, _ = _g4a_inputs()
    g = torch.from_numpy(discs).to(cuda)
    c = torch.from_numpy(bgr).to(cuda)
    outs = [*hough.hough_lines(g), *hough.hough_circles(g), *stereo.stereo_bm(g, g, 16, 9),
            *sgbm.stereo_sgbm(g, g, 16, num_dirs=4), nlmeans.nl_means(g, 10.0, 3, 7),
            dtfilter.dt_filter(c, c), dtfilter.guided_filter(g, c, 4),
            poisson.seamless_clone(bgr[:8, :8], c, np.ones((8, 8), bool), (40, 30), 1, 10),
            inpaint.inpaint_diffusion(c, discs > 120, 10), hdr.merge_mertens(c[None].repeat(2, 1, 1, 1)),
            ghough.ghough_accumulate(g, ghough.build_r_table(discs[10:40, 14:46]))]
    assert all(o.is_cuda for o in outs)
    m = Mat.from_device(c)
    for out in (ip.fast_nl_means_denoising_colored(m, 10, 10, 3, 7), ip.detail_enhance(m),
                ip.seamless_clone(Mat.from_array(bgr[:8, :8], device="cpu"), m,
                                  np.ones((8, 8), bool), (40, 30))):
        assert out.is_on_device and out.device().is_cuda


def test_mser_and_grabcut_raise_without_the_native_library(cuda, monkeypatch, tmp_path):
    from rustcv_tpu_torch.ops import grabcut, mser

    broken = tmp_path / "mser.cpp"
    broken.write_text("extern \"C\" long rcv_mser( { not C++ }\n")
    monkeypatch.setattr(native, "SOURCES", (broken,))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_error", None)
    img = np.zeros((20, 24, 3), np.uint8)
    img[5:15, 6:18] = 200
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        mser.mser_regions(img[..., 0])
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        grabcut.grab_cut(img, rect=(4, 3, 16, 14), iter_count=1)


def _g4b_board(h=240, w=320, angle=0.12, sq=22.0, origin=(50.0, 40.0)):
    """A 10×7-square board rotated by ``angle``, two 3×3 box blurs."""
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    c, s = np.cos(angle), np.sin(angle)
    bx = (c * (xs - origin[0]) + s * (ys - origin[1])) / sq
    by = (-s * (xs - origin[0]) + c * (ys - origin[1])) / sq
    inside = (bx >= 0) & (bx < 10) & (by >= 0) & (by < 7)
    img = np.where(inside & ((np.floor(bx) + np.floor(by)) % 2 == 0), 40.0, 200.0)
    for _ in range(2):
        p = np.pad(img, 1, mode="edge")
        img = sum(p[dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)) / 9.0
    return img.astype(np.uint8)


_G4B_K = np.array([[300.0, 0, 162.0], [0, 296.0, 118.0], [0, 0, 1.0]])
_G4B_DIST = np.array([-0.18, 0.06, 0.0008, -0.0012, -0.01])


def _g4b_frame(h=240, w=320, seed=50):
    rng = np.random.default_rng(seed)
    return np.stack([_g4b_board(h, w), rng.integers(0, 256, (h, w), np.uint8),
                     _g4b_board(h, w, angle=-0.3)], -1)


@pytest.mark.parametrize("fisheye", [False, True])
def test_undistort_on_the_card_equals_the_cpu_port(cuda, fisheye):
    from rustcv_tpu_torch.ops import calib

    frame = _g4b_frame()

    def fn(a):
        if fisheye:
            return calib.fisheye_undistort(a, _G4B_K, _G4B_DIST[:4] * 0.5, _G4B_K * 0.8)
        return calib.undistort(a, _G4B_K, _G4B_DIST)

    kernels.reset_launch_counts()
    got = fn(torch.from_numpy(frame).to(cuda))
    assert got.is_cuda and not any(kernels.launch_counts().values())
    assert torch.equal(got.cpu(), fn(torch.from_numpy(frame)))
    assert fn(frame).is_cuda  # a numpy frame goes to the card


def test_imgproc_undistort_on_a_cuda_mat(cuda):
    from rustcv_tpu_torch import imgproc as ip

    frame = _g4b_frame()
    out = ip.undistort(Mat.from_device(torch.from_numpy(frame).to(cuda)), _G4B_K, _G4B_DIST)
    assert out.is_on_device and out.device().is_cuda
    host = ip.undistort(Mat.from_array(frame, device="cpu"), _G4B_K, _G4B_DIST)
    assert not host.is_on_device and np.array_equal(out.to_numpy(), host.to_numpy())


def test_sb_likelihood_on_the_card_is_full_float32(cuda):
    """Within 1e-5 of the float64 oracle with both TF32 flags on: the
    convolution runs inside ``full_f32``, which restores the flags."""
    from rustcv_tpu_torch.ops import chessboard_sb

    img = np.random.default_rng(3).uniform(0, 1, (120, 160))
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        got = chessboard_sb._likelihood(torch.as_tensor(img, dtype=torch.float32, device=cuda))
        assert got.is_cuda
        assert np.abs(got.cpu().numpy() - chessboard_sb._likelihood_numpy(img)).max() < 1e-5
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


@pytest.mark.parametrize("sb", [False, True])
def test_board_refinement_runs_on_the_card_for_numpy_input(cuda, sb, monkeypatch):
    from rustcv_tpu_torch import imgproc as ip
    from rustcv_tpu_torch.ops import chessboard, chessboard_sb, features

    seen = []
    real = features.corner_sub_pix

    def spy(gray, pts, win=11, iters=10):
        seen.append(gray.device.type)
        return real(gray, pts, win, iters)

    monkeypatch.setattr(features, "corner_sub_pix", spy)
    board = _g4b_board()
    fn = chessboard_sb.find_chessboard_corners_sb if sb else chessboard.find_chessboard_corners
    found, corners = fn(board, (9, 6))
    assert found and seen and set(seen) == {"cuda"}
    f_cpu, c_cpu = fn(torch.from_numpy(board), (9, 6))
    assert f_cpu and np.abs(corners - c_cpu).max() <= 1e-3
    wrapper = ip.find_chessboard_corners_sb if sb else ip.find_chessboard_corners
    seen.clear()
    f_mat, c_mat = wrapper(Mat.from_device(torch.from_numpy(board[..., None]).to(cuda)), (9, 6))
    assert f_mat and set(seen) == {"cuda"} and np.abs(c_mat - c_cpu).max() <= 1e-3


def test_triangle_rasterize_and_normals_on_the_card(cuda):
    from rustcv_tpu_torch.ops import threed

    rng = np.random.default_rng(60)
    verts = np.concatenate([rng.uniform(-10, 330, (900, 2)), rng.uniform(0.2, 3, (900, 1))],
                           1).astype(np.float32)
    idx = rng.integers(0, 900, (600, 3)).astype(np.int32)
    cols = rng.uniform(0, 255, (900, 3)).astype(np.float32)
    c, d = threed.triangle_rasterize(*(torch.from_numpy(a).to(cuda) for a in (verts, idx, cols)),
                                     320, 240)
    assert c.is_cuda and d.is_cuda
    wc, wd = threed.triangle_rasterize(torch.from_numpy(verts), idx, cols, 320, 240)
    c, d, wc, wd = (t.cpu().numpy() for t in (c, d, wc, wd))
    cover, wcover = np.isfinite(d), np.isfinite(wd)
    assert (cover != wcover).sum() <= 0.001 * d.size
    both = cover & wcover
    np.testing.assert_allclose(d[both], wd[both], rtol=1e-5, atol=0)
    np.testing.assert_allclose(c[both], wc[both], rtol=1e-4, atol=1e-4)
    depth = (2.0 + 0.3 * np.sin(np.mgrid[0:60, 0:80][1] / 9.0)).astype(np.float32)
    pts = threed.depth_to_3d(depth, _G4B_K / 4 + np.diag([0, 0, 0.75]))
    n = threed.rgbd_normals(torch.from_numpy(pts).to(cuda))
    assert n.is_cuda and threed.rgbd_normals(pts).is_cuda
    np.testing.assert_allclose(n.cpu().numpy(), threed.rgbd_normals(torch.from_numpy(pts)).numpy(),
                               rtol=1e-5, atol=1e-6)


def test_stitch_device_composite_on_the_card(cuda):
    from rustcv_tpu_torch.ops import stitch
    from rustcv_tpu_torch.ops.sift import _blur

    rng = np.random.default_rng(11)
    img = _blur(rng.integers(0, 256, (140, 300)).astype(np.float64), 2.0)
    wide = ((img - img.min()) / (np.ptp(img) + 1e-9) * 255).astype(np.uint8)
    left, right = wide[10:130, 0:170].copy(), wide[10:130, 110:300].copy()
    got = stitch.stitch([torch.from_numpy(left).to(cuda), torch.from_numpy(right).to(cuda)])
    want = stitch.stitch([torch.from_numpy(left), torch.from_numpy(right)])
    assert isinstance(got, np.ndarray) and got.shape == want.shape
    assert np.abs(got.astype(int) - want).max() <= 1


# -- the cv2 facade (rustcv_tpu_torch.cv2) -------------------------------------


def _cv2_core_functions():
    import inspect

    import rustcv_tpu_torch.cv2 as P

    core = {"rustcv_tpu_torch.cv2", "rustcv_tpu_torch.cv2._classes",
            "rustcv_tpu_torch.cv2._util", "rustcv_tpu_torch.cv2._filestorage",
            "rustcv_tpu_torch.cv2._color_dispatch"}
    return sorted(n for n in dir(P) if not n.startswith("_")
                  and n not in ("builtins_max", "builtins_min")
                  and inspect.isfunction(getattr(P, n))
                  and getattr(P, n).__module__ in core)


def _cv2_plan(name, fn, tmp_path):
    """cv2_callcov's synthesized arguments, with a PNG of the port's own
    writing where the synthesizer takes Pillow's, and its fixed /tmp paths
    moved under ``tmp_path``."""
    from cv2_callcov import OVERRIDES, build_call, img_u8

    import rustcv_tpu_torch.cv2 as P

    png = str(tmp_path / "in.png")
    P.imwrite(png, img_u8())
    local = {"imread": ((png, 1), {}), "imreadWithMetadata": ((png, 1), {}),
             "haveImageReader": ((png,), {}), "imcount": ((png,), {}),
             "imreadmulti": ((png,), {}),
             "imdecode": ((np.fromfile(png, np.uint8), 1), {})}
    if name in local:
        return local[name]
    plan = build_call(fn, name, OVERRIDES)
    assert not isinstance(plan, str), plan
    args, kwargs = plan

    def move(v):
        return str(tmp_path / v.rsplit("/", 1)[1]) if isinstance(v, str) and v.startswith(
            "/tmp/rcv_callcov") else v

    return tuple(move(v) for v in args), {k: move(v) for k, v in kwargs.items()}


@pytest.mark.parametrize("name", _cv2_core_functions())
def test_cv2_numpy_on_the_card_equals_cpu_tensors(cuda, name, tmp_path):
    """Every wrapper of the cv2 core with numpy images (which go to the card
    where the wrapper hands them to a Mat or a device op) against the same
    call with CPU tensors: the same exception class, or results equal
    within the CPU tests' bars (tests/cv2_torch_parity.py)."""
    from cv2_torch_parity import BARS, CHECKS, port_args, same

    import rustcv_tpu_torch.cv2 as P

    fn = getattr(P, name)
    (tmp_path / "card").mkdir()
    (tmp_path / "cpu").mkdir()
    card_args = _cv2_plan(name, fn, tmp_path / "card")
    cpu_args = port_args(fn, *_cv2_plan(name, fn, tmp_path / "cpu"))
    outs = []
    for args, kwargs in (card_args, cpu_args):
        P.setRNGSeed(19)  # theRNG's state is global: the same stream for both runs
        try:
            outs.append((fn(*args, **kwargs), None))
        except Exception as e:  # noqa: BLE001 - the class is what is compared
            outs.append((None, e))
    (card, card_err), (cpu, cpu_err) = outs
    assert type(card_err).__name__ == type(cpu_err).__name__, (card_err, cpu_err)
    if card_err is not None or name in ("getTickCount", "getCPUTickCount"):
        return
    if name == "imencode" and bytes(cpu[1][:2]) == b"\xff\xd8":
        # JPEG: the card's encoder against the CPU's, coefficients within JPEG_TOL
        g, w = native.jpeg_entropy_decode(bytes(card[1])), native.jpeg_entropy_decode(bytes(cpu[1]))
        assert g[0] == w[0]
        for a, b in zip(g[1], w[1]):
            d = np.abs(np.asarray(a).astype(np.int64) - np.asarray(b).astype(np.int64))
            assert d.max() <= 1 and (d > 0).mean() < 5e-3, (d.max(), (d > 0).mean(), d.size)
        return
    if name in CHECKS:
        CHECKS[name](cpu, card, cpu_args[0], card_args[0])
        return
    same(cpu, card, BARS.get(name, (0, ""))[0])


def test_cv2_numpy_in_is_computed_on_the_card(cuda, monkeypatch):
    """A numpy image handed to a Mat is uploaded: the op sees a CUDA Mat,
    and the result comes back as numpy."""
    import rustcv_tpu_torch.cv2 as P
    from rustcv_tpu_torch import imgproc

    seen = []
    real = imgproc.gaussian_blur
    monkeypatch.setattr(imgproc, "gaussian_blur",
                        lambda mat, *a, **k: seen.append(mat.device().device) or real(mat, *a, **k))
    img = np.random.default_rng(3).integers(0, 256, (120, 160, 3), np.uint8)
    out = P.GaussianBlur(img, (5, 5), 0)
    assert seen and all(d.type == "cuda" for d in seen)
    assert isinstance(out, np.ndarray)
    np.testing.assert_array_equal(out, P.GaussianBlur(torch.from_numpy(img), (5, 5), 0))


@pytest.mark.parametrize("dev", ["numpy", "cuda tensor"])
def test_cv2_harris_routes_launch_k6_once_each(cuda, dev):
    """``cornerHarris`` launches the float32 form of K6 once, and
    ``goodFeaturesToTrack`` the int32 form once, on a 1080p gray frame."""
    import rustcv_tpu_torch.cv2 as P

    g = sim.synth_bgr(1920, 1080, 11)[..., 1].copy()
    x = g if dev == "numpy" else torch.from_numpy(g).to(cuda)
    kernels.reset_launch_counts()
    resp = P.cornerHarris(x, 2, 3, 0.04)
    counts = kernels.launch_counts()
    assert counts["harris_response_f32"] == 1 and counts["harris_response_i32"] == 0
    np.testing.assert_allclose(resp, P.cornerHarris(torch.from_numpy(g), 2, 3, 0.04),
                               rtol=2e-4, atol=1e-6)
    kernels.reset_launch_counts()
    pts = P.goodFeaturesToTrack(x, 500, 0.01, 10)
    counts = kernels.launch_counts()
    assert counts["harris_response_i32"] == 1 and counts["harris_response_f32"] == 0
    np.testing.assert_array_equal(pts, P.goodFeaturesToTrack(torch.from_numpy(g), 500, 0.01, 10))


def _cv2_later_functions():
    import rustcv_tpu_torch.cv2 as P
    from cv2_torch_parity import facade_get, later_callables

    return [n for n in later_callables(P) if not isinstance(facade_get(P, n), type)]


@pytest.mark.parametrize("name", _cv2_later_functions())
def test_cv2_later_numpy_on_the_card_equals_cpu_tensors(cuda, name, tmp_path):
    """Every function of the rest of the facade (item 7b) with numpy images
    (which go to the card where the wrapper hands them to a Mat or a device
    op) against the same call with CPU tensors: the same exception class,
    or results equal within the CPU tests' bars."""
    from cv2_torch_parity import BARS, CHECKS, facade_get, later_plan, port_args, same

    import rustcv_tpu_torch.cv2 as P

    fn = facade_get(P, name)
    (tmp_path / "card").mkdir()
    (tmp_path / "cpu").mkdir()
    card_args = later_plan(name, fn, tmp_path / "card", P)
    cpu_args = port_args(fn, *later_plan(name, fn, tmp_path / "cpu", P))
    outs = []
    level = P.utils.logging.getLogLevel()
    for args, kwargs in (card_args, cpu_args):
        P.utils.logging.setLogLevel(level)  # global state: both runs start from the same
        try:
            outs.append((fn(*args, **kwargs), None))
        except Exception as e:  # noqa: BLE001 - the class is what is compared
            outs.append((None, e))
    (card, card_err), (cpu, cpu_err) = outs
    assert type(card_err).__name__ == type(cpu_err).__name__, (card_err, cpu_err)
    if card_err is not None:
        return
    if name in ("detail.computeImageFeatures", "detail.computeImageFeatures2"):
        for c, p in zip(card if isinstance(card, list) else [card],
                        cpu if isinstance(cpu, list) else [cpu]):
            assert (c.img_idx, c.img_size) == (p.img_idx, p.img_size)
            np.testing.assert_array_equal([k.pt for k in c.keypoints], [k.pt for k in p.keypoints])
            same(p.descriptors, c.descriptors, 0)
        return
    if name in CHECKS:
        CHECKS[name](cpu, card, cpu_args[0], card_args[0])
        return
    if name == "goodFeaturesToTrackWithQuality":
        np.testing.assert_array_equal(card[0], cpu[0])
        np.testing.assert_allclose(card[1], cpu[1], rtol=2e-4, atol=1e-6)  # HARRIS_TOL
        return
    same(cpu, card, BARS.get(name, (0, ""))[0])
    for i, (c, p) in enumerate(zip(*(a[0] for a in (card_args, cpu_args)))):
        if isinstance(c, np.ndarray):  # arguments written in place
            same(p.numpy() if isinstance(p, torch.Tensor) else p, c, 0, f"argument {i}")


@pytest.mark.parametrize("dev", ["numpy", "cuda tensor"])
def test_cv2_later_k6_routes(cuda, dev):
    """``GFTTDetector.detect`` moves K6 int32's launch count by one;
    ``goodFeaturesToTrackWithQuality(useHarrisDetector=True)`` moves each
    K6 form by one, on a 1080p gray frame; the results equal the CPU's."""
    import rustcv_tpu_torch.cv2 as P

    g = sim.synth_bgr(1920, 1080, 11)[..., 1].copy()
    x = g if dev == "numpy" else torch.from_numpy(g).to(cuda)
    kernels.reset_launch_counts()
    kps = P.GFTTDetector_create(500, 0.01, 10).detect(x)
    counts = kernels.launch_counts()
    assert counts["harris_response_i32"] == 1 and counts["harris_response_f32"] == 0
    want = P.GFTTDetector_create(500, 0.01, 10).detect(torch.from_numpy(g))
    assert [k.pt for k in kps] == [k.pt for k in want] and len(kps) > 0
    kernels.reset_launch_counts()
    pts, q = P.goodFeaturesToTrackWithQuality(x, 500, 0.01, 10, useHarrisDetector=True)
    counts = kernels.launch_counts()
    assert counts["harris_response_i32"] == 1 and counts["harris_response_f32"] == 1
    wpts, wq = P.goodFeaturesToTrackWithQuality(torch.from_numpy(g), 500, 0.01, 10,
                                                useHarrisDetector=True)
    np.testing.assert_array_equal(pts, wpts)
    np.testing.assert_allclose(q, wq, rtol=2e-4, atol=1e-6)


def test_cv2_later_on_cuda_tensors_equals_cpu_tensors(cuda):
    """The 7b wrappers that reach a Mat or a device op give on a CUDA tensor
    what they give on the CPU tensor; ``addText`` and ``thresholdWithMask``
    write into a CUDA tensor where it lives."""
    import rustcv_tpu_torch.cv2 as P

    img = sim.synth_bgr(640, 360, 5)
    gray = np.ascontiguousarray(img[..., 1])
    rng = np.random.default_rng(8)
    tex = np.clip(gray + rng.normal(0, 12, gray.shape), 0, 255).astype(np.uint8)
    tex2 = np.roll(tex, (1, 2), (0, 1))
    pts = P.goodFeaturesToTrack(torch.from_numpy(tex), 200, 0.01, 5)
    K = np.array([[500.0, 0, 320], [0, 500.0, 180], [0, 0, 1]])
    D = np.array([0.05, -0.01, 0.002, -0.0004])
    mask = np.zeros(gray.shape, np.uint8)
    mask[40:300, 60:500] = 1
    arrays = {"f": img, "g": gray, "t": tex, "t2": tex2,
              "b": ((gray > 128) * 255).astype(np.uint8)}
    calls = {
        "GFTTDetector": lambda a: [k.pt for k in P.GFTTDetector_create(200, 0.01, 5).detect(
            a["f"])],
        "goodFeaturesToTrackWithQuality": lambda a: P.goodFeaturesToTrackWithQuality(
            a["g"], 200, 0.01, 5)[0],
        "FarnebackOpticalFlow": lambda a: P.FarnebackOpticalFlow_create().calc(
            a["t"], a["t2"], None),
        "SparsePyrLKOpticalFlow": lambda a: P.SparsePyrLKOpticalFlow_create().calc(
            a["t"], a["t2"], pts, None)[:2],
        "fisheye.undistortImage": lambda a: P.fisheye.undistortImage(a["f"], K, D),
        "checkChessboard": lambda a: P.checkChessboard(a["g"], (7, 5)),
        "connectedComponentsWithAlgorithm": lambda a: P.connectedComponentsWithAlgorithm(
            a["b"], 8, 4, 0),
        "filter2Dp": lambda a: P.filter2Dp(a["f"], np.ones((3, 3), np.float32) / 9),
        "find4QuadCornerSubpix": lambda a: P.find4QuadCornerSubpix(a["t"], pts[:20], (5, 5)),
    }
    from cv2_torch_parity import same

    for name, call in calls.items():
        got = call({k: torch.from_numpy(v).to(cuda) for k, v in arrays.items()})
        want = call({k: torch.from_numpy(v) for k, v in arrays.items()})
        if name in ("FarnebackOpticalFlow", "SparsePyrLKOpticalFlow", "find4QuadCornerSubpix"):
            same(want, got, 1e-3, name)  # the flow and sub-pixel bars: 1e-3 px
        else:
            same(want, got, 0, name)
    t = torch.from_numpy(img.copy()).to(cuda)
    ptr = t.data_ptr()
    P.addText(t, "7b", (20, 300), "DejaVu Sans", 30, (255, 0, 255))
    host = img.copy()
    P.addText(host, "7b", (20, 300), "DejaVu Sans", 30, (255, 0, 255))
    assert t.is_cuda and t.data_ptr() == ptr
    np.testing.assert_array_equal(t.cpu().numpy(), host)
    dst = torch.from_numpy(gray.copy()).to(cuda)
    ptr = dst.data_ptr()
    P.thresholdWithMask(torch.from_numpy(tex).to(cuda), dst, mask, 127, 255, P.THRESH_BINARY)
    want = gray.copy()
    P.thresholdWithMask(torch.from_numpy(tex), want, mask, 127, 255, P.THRESH_BINARY)
    assert dst.is_cuda and dst.data_ptr() == ptr
    np.testing.assert_array_equal(dst.cpu().numpy(), want)


def test_cv2_on_cuda_tensors_equals_cpu_tensors(cuda):
    """The port's cv2 on a CUDA tensor equals it on the CPU tensor, and a
    draw on a CUDA tensor stays there."""
    import rustcv_tpu_torch.cv2 as P

    img = sim.synth_bgr(640, 360, 5)
    gray = np.ascontiguousarray(img[..., 2])
    calls = {
        "GaussianBlur": lambda f, g: P.GaussianBlur(f, (7, 7), 1.5),
        "Sobel": lambda f, g: P.Sobel(g, P.CV_16S, 1, 1, ksize=5),
        "threshold otsu": lambda f, g: P.threshold(g, 0, 255, P.THRESH_BINARY | P.THRESH_OTSU),
        "cvtColor HSV2BGR": lambda f, g: P.cvtColor(f, P.COLOR_HSV2BGR),
        "morphologyEx": lambda f, g: P.morphologyEx(g, P.MORPH_GRADIENT, np.ones((5, 5), np.uint8)),
        "medianBlur": lambda f, g: P.medianBlur(f, 5),
        "equalizeHist": lambda f, g: P.equalizeHist(g),
        "filter2D": lambda f, g: P.filter2D(f, -1, np.ones((3, 3), np.float32) / 9),
        "connectedComponents": lambda f, g: P.connectedComponentsWithStats(
            P.threshold(g, 128, 255, 0)[1]),
        "MOG2": lambda f, g: [P.createBackgroundSubtractorMOG2().apply(f) for _ in range(3)],
    }
    for name, call in calls.items():
        got = call(torch.from_numpy(img).to(cuda), torch.from_numpy(gray).to(cuda))
        want = call(torch.from_numpy(img), torch.from_numpy(gray))
        from cv2_torch_parity import same

        same(want, got, 0, name)
    t = torch.from_numpy(img.copy()).to(cuda)
    ptr = t.data_ptr()
    P.rectangle(t, (10, 10), (200, 100), (0, 255, 0), 3)
    P.putText(t, "cv2", (20, 300), 0, 2.0, (255, 0, 255))
    host = img.copy()
    P.rectangle(host, (10, 10), (200, 100), (0, 255, 0), 3)
    P.putText(host, "cv2", (20, 300), 0, 2.0, (255, 0, 255))
    assert t.is_cuda and t.data_ptr() == ptr
    np.testing.assert_array_equal(t.cpu().numpy(), host)


_WEBP = Path(__file__).resolve().parent / "data" / "webp"
_WEBP_MANIFEST = json.loads((_WEBP / "manifest.json").read_text())


@pytest.mark.parametrize("name", sorted(_WEBP_MANIFEST))
def test_webp_fixture_read_onto_the_card(cuda, name):
    """Item 8c: each WebP fixture read by ``imreadmulti`` and ``imread``
    onto the card equals the CPU read and the reference's hashes."""
    import hashlib

    from rustcv_tpu_torch import imgcodecs

    m = _WEBP_MANIFEST[name]
    path = str(_WEBP / name)
    on_card = imgcodecs.imreadmulti(path, device=cuda)
    cpu = [x.to_numpy() for x in imgcodecs.imreadmulti(path, device="cpu")]
    assert len(on_card) == len(cpu) == m["n_frames"] == imgcodecs.imcount(path)
    for x, c, digest in zip(on_card, cpu, m["frames"]):
        assert x.device().is_cuda
        np.testing.assert_array_equal(x.to_numpy(), c)
        assert hashlib.sha256(np.ascontiguousarray(c).tobytes()).hexdigest() == digest
    first = imgcodecs.imread(path, device=cuda)
    assert first.device().is_cuda
    np.testing.assert_array_equal(first.to_numpy(), cpu[0])


@pytest.mark.parametrize("form", ["bgr", "bgra", "gray", "animation"])
def test_webp_written_from_the_card(cuda, form):
    """Item 8c-ii: a WebP written from CUDA Mats (the YUV planes made on the
    card by exact integer arithmetic) is the same bytes as the one written
    from host Mats of the same pixels, and reads back at their size."""
    import torch

    from rustcv_tpu_torch import imgcodecs
    from rustcv_tpu_torch.core import Mat

    rng = np.random.default_rng(5)
    y, x = np.mgrid[0:181, 0:321]
    base = np.stack([x * 255 // 320, y * 255 // 180, (x + y) % 256], -1).astype(np.uint8)
    base = np.clip(base + rng.integers(-9, 10, base.shape) * (x > 160)[..., None], 0,
                   255).astype(np.uint8)
    if form == "animation":
        frames = [np.roll(base, 9 * i, axis=0) for i in range(4)]
        host = imgcodecs.encode_frames("webp", [Mat.from_array(f, device="cpu") for f in frames])
        card = imgcodecs.encode_frames("webp", [Mat.from_device(torch.from_numpy(f).to(cuda))
                                                for f in frames])
    else:
        a = {"bgr": base, "gray": base[..., :1].copy(),
             "bgra": np.dstack([base, ((x // 7 + y // 5) % 4 * 85).astype(np.uint8)])}[form]
        host = imgcodecs.imencode(".webp", Mat.from_array(a, device="cpu"))
        card = imgcodecs.imencode(".webp", Mat.from_device(torch.from_numpy(a).to(cuda)))
    assert card == host
    back = imgcodecs.imdecode(card, device="cpu").to_numpy()
    assert back.shape == (181, 321, 3)


_APNG = Path(__file__).resolve().parent / "data" / "apng"
_APNG_MANIFEST = json.loads((_APNG / "manifest.json").read_text())


def _sha(a) -> str:
    import hashlib

    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


@pytest.mark.parametrize("name", sorted(_APNG_MANIFEST))
def test_apng_fixture_read_onto_the_card(cuda, name):
    """Item 8d-i: each animated PNG fixture read by ``imreadmulti`` (where
    the reference reads every frame) and ``imread`` onto the card equals the
    CPU read and the reference's hashes; ``imcount`` its count."""
    from rustcv_tpu_torch import imgcodecs

    m = _APNG_MANIFEST[name]
    path = str(_APNG / name)
    assert imgcodecs.imcount(path) == m["n_frames"]
    first = imgcodecs.imread(path, device=cuda)
    assert first.device().is_cuda and _sha(first.to_numpy()) == m["sha256"][0]
    if m["read_error"] is not None:
        return
    on_card = imgcodecs.imreadmulti(path, device=cuda)
    cpu = [x.to_numpy() for x in imgcodecs.imreadmulti(path, device="cpu")]
    assert len(on_card) == len(cpu) == len(m["sha256"])
    for x, c, digest in zip(on_card, cpu, m["sha256"]):
        assert x.device().is_cuda
        np.testing.assert_array_equal(x.to_numpy(), c)
        assert _sha(c) == digest


@pytest.mark.parametrize("form", ["bgr", "bgra", "gray"])
def test_apng_written_from_the_card(cuda, form):
    """Item 8d-i: an animated PNG written from CUDA Mats (the frames'
    comparisons on the card) is the same bytes as the one written from host
    Mats, and reads back to the frames written."""
    from rustcv_tpu_torch import imgcodecs

    rng = np.random.default_rng(8)
    base = rng.integers(0, 256, (90, 160, 4)).astype(np.uint8)
    frames = []
    for i in range(5):
        f = base.copy()
        f[10 + 5 * i:40 + 5 * i, 20 * i:30 + 20 * i] = rng.integers(0, 256, 4)
        frames.append({"bgr": f[..., :3], "bgra": f, "gray": f[..., :1]}[form].copy())
    frames.insert(2, frames[1].copy())
    host = imgcodecs.encode_frames("png", [Mat.from_array(f, device="cpu") for f in frames],
                                   duration=[10, 20, 30, 40, 50, 60], loop=2)
    card = imgcodecs.encode_frames("png", [Mat.from_device(torch.from_numpy(f).to(cuda))
                                           for f in frames], duration=[10, 20, 30, 40, 50, 60],
                                   loop=2)
    assert card == host
    back = imgcodecs.decode_frames(card)
    keep = [f for i, f in enumerate(frames) if i != 2]
    assert len(back) == len(keep) == 5
    for b, f in zip(back, keep):
        want = np.repeat(f, 3, 2) if form == "gray" else f[..., :3]
        if form == "bgra":  # the reference hands Pillow a[..., ::-1]: A, R, G, B
            want = f[..., ::-1][..., :3][..., ::-1]
        np.testing.assert_array_equal(b, want)


@pytest.mark.parametrize("name", ["gradient_noise_128x96", "many_colours_641x361",
                                  "colours_256_160x120", "noise_1920x1080"])
def test_quantize_on_the_card(cuda, name):
    """Part A of item 8d-i: Pillow's median cut of a CUDA frame (the
    histogram and the mapping on the card) is Pillow's (the committed
    hashes) and the CPU's."""
    import chip_smoke
    from rustcv_tpu_torch.imgcodecs import quantize

    ref = json.loads((Path(__file__).resolve().parent / "data" / "gif"
                      / "quant_refs.json").read_text())[name]
    frame = chip_smoke.quant_frames()[name]
    idx, pal = quantize.quantize(torch.from_numpy(frame).to(cuda))
    cidx, cpal = quantize.quantize(frame)
    assert np.array_equal(idx, cidx) and np.array_equal(pal, cpal)
    assert (len(pal), _sha(pal), _sha(idx)) == (ref["entries"], ref["palette_sha256"],
                                               ref["index_sha256"])


@pytest.mark.parametrize("mode,shape,depth", [
    ("RGB", (1080, 1920, 3), 8), ("RGBA", (37, 41, 4), 8), ("L", (1080, 1920), 8),
    ("LA", (9, 1, 2), 8), ("1", (1080, 1917), 1), ("I;16", (23, 7), 16)])
def test_png_filters_on_the_card(cuda, mode, shape, depth):
    """Item 8d-ii-a: Pillow's row filters run on a CUDA tensor, the CPU's
    bytes, and no kernel of the port's launches."""
    from rustcv_tpu_torch.imgcodecs import png_filter

    rng = np.random.default_rng(len(shape) + shape[0])
    top = {1: 2, 8: 256, 16: 65536}[depth]
    a = torch.from_numpy(rng.integers(0, top, shape).astype(np.int32))
    a = a.bool() if depth == 1 else a.to(torch.uint8) if depth == 8 else a
    kernels.reset_launch_counts()
    on_card = png_filter.filter_rows(a.to(cuda), depth)
    assert on_card.is_cuda and torch.equal(on_card.cpu(), png_filter.filter_rows(a, depth))
    assert not any(kernels.launch_counts().values())


@functools.lru_cache(maxsize=1)
def _png_cases():
    import chip_smoke

    return chip_smoke.png_write_frames()


@pytest.mark.parametrize("name", sorted(json.loads(
    (Path(__file__).resolve().parent / "data" / "png" / "write_refs.json").read_text())))
def test_png_written_from_the_card(cuda, name):
    """Item 8d-ii-a: each phase-3za case written from CUDA tensors (and, for
    u8 frames, CUDA Mats) is the CPU's bytes, with Pillow's chunks,
    controls and image data before zlib, at most 1.02x its size."""
    import chip_smoke

    ref = json.loads((Path(__file__).resolve().parent / "data" / "png"
                      / "write_refs.json").read_text())[name]
    frames, kw = _png_cases()[name]
    host = chip_smoke.png_write(frames, kw)
    assert chip_smoke.png_write([torch.from_numpy(f).to(cuda) for f in frames], kw) == host
    if all(f.dtype == np.uint8 for f in frames):
        assert chip_smoke.png_mat_write(frames, kw, "cuda") == host
    got = chip_smoke.png_summary(host)
    assert {k: got[k] for k in ("chunks", "controls", "frames_sha256")} == \
        {k: ref[k] for k in ("chunks", "controls", "frames_sha256")}
    assert got["bytes"] <= chip_smoke.PNG_SIZE_RATIO * ref["bytes"]


_JPEG = Path(__file__).resolve().parent / "data" / "jpeg"
_JPEG_MANIFEST = json.loads((_JPEG / "manifest.json").read_text())


@pytest.mark.parametrize("name", sorted(_JPEG_MANIFEST))
def test_jpeg_form_fixture_read_onto_the_card(cuda, name):
    """Item 8d-ii-b: each JPEG fixture (CMYK and YCCK, smoothed progressive,
    lossless, arithmetic-coded) read by ``imread`` and ``imdecode`` onto the
    card equals the CPU read and the reference's hash, and one the
    reference refuses raises CameraError on both; no kernel launches."""
    from rustcv_tpu_torch import imgcodecs
    from rustcv_tpu_torch.core import CameraError

    m = _JPEG_MANIFEST[name]
    path = str(_JPEG / name)
    data = (_JPEG / name).read_bytes()
    kernels.reset_launch_counts()
    if m["entry"]["imread"] != "read":
        for device in (cuda, "cpu"):
            with pytest.raises(CameraError):
                imgcodecs.imread(path, device=device)
            with pytest.raises(CameraError):
                imgcodecs.imdecode(data, device=device)
        return
    cpu = imgcodecs.imread(path, device="cpu").to_numpy()
    assert list(cpu.shape) == m["shape"] and _sha(cpu) == m["bgr_sha256"]
    for mat in (imgcodecs.imread(path, device=cuda), imgcodecs.imdecode(data, device=cuda)):
        assert mat.device().is_cuda
        np.testing.assert_array_equal(mat.to_numpy(), cpu)
    assert not any(kernels.launch_counts().values())


_TIFF = Path(__file__).resolve().parent / "data" / "tiff"
_TIFF_MANIFEST = json.loads((_TIFF / "manifest.json").read_text())


@pytest.mark.parametrize("name", sorted(_TIFF_MANIFEST))
def test_tiff_jpeg_ycbcr_fixture_read_onto_the_card(cuda, name):
    """Item 8d-ii-c-i: each TIFF fixture of JPEG compression or the YCbCr
    photometric read by ``imread``, ``imdecode`` and ``imreadmulti`` onto
    the card equals the CPU read and the reference's page hashes, with its
    page count; one the reference refuses raises CameraError on both, and
    old-style JPEG ``not_ported``; no kernel launches."""
    from rustcv_tpu_torch import imgcodecs
    from rustcv_tpu_torch.core import CameraError

    m = _TIFF_MANIFEST[name]
    path = str(_TIFF / name)
    data = (_TIFF / name).read_bytes()
    kernels.reset_launch_counts()
    if m["form"] == "not_ported":
        for device in (cuda, "cpu"):
            with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 8"):
                imgcodecs.imread(path, device=device)
        return
    assert imgcodecs.imcount(path) == m["count"]
    if "error" in m["pages"][-1]:
        for device in (cuda, "cpu"):
            with pytest.raises(CameraError):
                imgcodecs.imreadmulti(path, device=device)
        return
    cpu = [mat.to_numpy() for mat in imgcodecs.imreadmulti(path, device="cpu")]
    assert [(list(c.shape), _sha(c)) for c in cpu] == [
        (p["shape"], p["bgr_sha256"]) for p in m["pages"]]
    for got in (imgcodecs.imreadmulti(path, device=cuda), [imgcodecs.imread(path, device=cuda)],
                [imgcodecs.imdecode(data, device=cuda)]):
        for mat, c in zip(got, cpu):
            assert mat.device().is_cuda
            np.testing.assert_array_equal(mat.to_numpy(), c)
    assert not any(kernels.launch_counts().values())
