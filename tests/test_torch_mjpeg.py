"""The port's hybrid MJPEG decode (BASELINE config 2) on the CPU against the
JAX package's, on identical JFIF bytes: the port's encoder makes the
simulated frames, and the JAX simulation is given the same encoder.

Every integer stage is bit-exact: the entropy decoders' arrays, the
unpacks, the upsamplers, the colour conversion on the same planes, the
block-packing policy. The decoded frames and the engine ticks agree with
the JAX hybrid path within max |diff| <= 1 on < 0.5 % of bytes (the
float32 IDCT may round a tie the other way). Against the float64 oracle
``decode_jpeg_numpy`` a chroma tie that flips moves B by up to 1.772 after
upsampling, so there the bound is max |diff| <= 2 on < 1 %: the JAX
package's own decode is at 2 on 0.52 % of 64×48 bytes here."""

import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import rustcv_tpu.capture.simulation as jax_sim
import rustcv_tpu.core as jax_core
from rustcv_tpu import native as jax_native
from rustcv_tpu.capture import SimulationDriver as JaxDriver
from rustcv_tpu.ops import jpeg_tpu as J
from rustcv_tpu.runtime import MultiStreamEngine as JaxEngine
from rustcv_tpu_torch import core, native
from rustcv_tpu_torch.capture import SimulationDriver
from rustcv_tpu_torch.capture import simulation as sim
from rustcv_tpu_torch.core import CameraError, PixelFormat
from rustcv_tpu_torch.ops import jpeg_encode, jpeg_tpu as P, kernels, resize
from rustcv_tpu_torch.runtime import MultiStreamEngine

torch.set_num_threads(2)

CLOSE = (1, 5e-3)  # max |diff|, share of bytes: against the JAX hybrid path
ORACLE = (2, 1e-2)  # against the float64 oracle (module docstring)


def _close(got, want, bound=CLOSE):
    d = np.abs(np.asarray(got).astype(np.int64) - np.asarray(want).astype(np.int64))
    assert d.shape == np.asarray(want).shape
    assert d.max() <= bound[0] and (d > 0).mean() < bound[1], (d.max(), (d > 0).mean())


def _jfif(w, h, seq, quality=90, sub="4:2:0"):
    return jpeg_encode.encode_jpeg(sim.synth_bgr(w, h, seq), quality, sub)


@pytest.fixture(scope="module")
def coders():
    assert native.available(), native.build_error()
    if not jax_native.available():
        pytest.skip(f"the reference's native library is unavailable: {jax_native.build_error()}")


@pytest.fixture()
def same_bytes(monkeypatch, coders):
    """The JAX simulation encodes MJPEG with the port's encoder."""
    monkeypatch.setitem(jax_sim._ENCODERS, jax_core.PixelFormat.MJPEG, sim.encode_mjpeg)


def _cfg(w, h, pkg=core):
    return pkg.SimpleConfig(width=w, height=h, fps=30, pixel_format=pkg.PixelFormat.MJPEG)


def _port(w, h, n, **kw):
    return MultiStreamEngine(SimulationDriver(device_count=n, paced=False), n, _cfg(w, h),
                             mjpeg_backend="hybrid", device="cpu", **kw)


def _jax(w, h, n, **kw):
    return JaxEngine(JaxDriver(device_count=n, paced=False), n, _cfg(w, h, jax_core),
                     mjpeg_backend="hybrid", **kw)


def _fetch(res):
    out = {k: res.numpy(k) for k in ("bgr", "filtered") if k in res.outputs}
    out["seqs"] = np.asarray(res.sequences)
    return out


def _ticks(eng, k, **kw):
    return [_fetch(eng.tick(block=True, **kw)) for _ in range(k)]


def _assert_close_ticks(got, want):
    assert len(got) == len(want)
    for p, j in zip(got, want):
        assert set(p) == set(j)
        np.testing.assert_array_equal(p["seqs"], j["seqs"])
        for key in set(j) - {"seqs"}:
            _close(p[key], j[key])


# -- the host entropy decoder's arrays ----------------------------------------

FRAMES = [(64, 48, 0, "4:2:0"), (160, 120, 3, "4:2:0"), (96, 64, 1, "4:2:2"),
          (40, 24, 2, "4:4:4"), (130, 50, 5, "4:2:0")]


@pytest.mark.parametrize("w,h,seq,sub", FRAMES)
def test_entropy_info_and_packed_arrays_are_the_references(coders, w, h, seq, sub):
    data = _jfif(w, h, seq, sub=sub)
    assert native.jpeg_entropy_info(data) == jax_native.jpeg_entropy_info(data)
    _, dense, _ = native.jpeg_entropy_decode(data)
    total = sum(c.size for c in dense)
    nnz = int(sum((c != 0).sum() for c in dense))
    got, want = native.jpeg_entropy_decode_packed(data, nnz + 7), \
        jax_native.jpeg_entropy_decode_packed(data, nnz + 7)
    assert got[0] == want[0] and got[3] == want[3] == nnz
    for a, b in zip(got[1:3] + tuple(got[4]), want[1:3] + tuple(want[4])):
        np.testing.assert_array_equal(a, b)
    assert native.jpeg_entropy_decode_packed(data, nnz - 1) is None
    assert jax_native.jpeg_entropy_decode_packed(data, nnz - 1) is None
    # the flat scatter-add gives the dense grids, in both packages
    flat = np.concatenate([c.reshape(-1) for c in dense])
    np.testing.assert_array_equal(
        P.unpack_coeffs(torch.from_numpy(got[1]), torch.from_numpy(got[2]), total).numpy(), flat)
    np.testing.assert_array_equal(np.asarray(J.unpack_coeffs(got[1], got[2], total)), flat)


@pytest.mark.parametrize("k", [2, 4, 6, 8])
@pytest.mark.parametrize("w,h,seq,sub", FRAMES)
def test_blockpacked_arrays_and_unpack_are_the_references(coders, w, h, seq, sub, k):
    data = _jfif(w, h, seq, sub=sub)
    _, dense, _ = native.jpeg_entropy_decode(data)
    blocks = np.concatenate([c.reshape(-1, 64) for c in dense])
    busy = int(((blocks != 0).sum(1) > k).sum())
    cap = busy + 5
    got = native.jpeg_entropy_decode_blockpacked(data, k, cap)
    want = jax_native.jpeg_entropy_decode_blockpacked(data, k, cap)
    assert got[0] == want[0] and got[5] == want[5] == busy
    for a, b in zip(got[1:5] + tuple(got[6]), want[1:5] + tuple(want[6])):
        np.testing.assert_array_equal(a, b)
    ours = P.unpack_block_coeffs(*(torch.from_numpy(a) for a in got[1:5])).numpy()
    np.testing.assert_array_equal(ours, blocks)
    np.testing.assert_array_equal(ours, np.asarray(J.unpack_block_coeffs(*got[1:5])))
    if busy:
        assert native.jpeg_entropy_decode_blockpacked(data, k, busy - 1) is None
        assert jax_native.jpeg_entropy_decode_blockpacked(data, k, busy - 1) is None


def test_blockpacked_writes_into_given_buffers(coders):
    data = _jfif(64, 48, 1)
    nblocks = sum(bh * bw for bh, bw in native.jpeg_entropy_info(data)["blocks"])
    bufs = (np.full((nblocks, 4), 9, np.uint8), np.full((nblocks, 4), 9, np.int16),
            np.full(40, 9, np.int32), np.full((40, 64), 9, np.int16))
    r = native.jpeg_entropy_decode_blockpacked(data, 4, 30, *bufs)
    assert all(a is b for a, b in zip(r[1:5], bufs))
    assert (bufs[2][r[5]:] == nblocks).all() and (bufs[3][r[5]:] == 0).all()
    with pytest.raises(ValueError, match="geometry or subsampling"):
        native.jpeg_entropy_decode_blockpacked(data, 4, 30, bufs[0][1:], bufs[1][1:],
                                               bufs[2], bufs[3])


def test_batched_unpack_with_colliding_zero_slots():
    """Seeded packed rows where a block's real DC sits in slot 0 and its
    unused (0, 0) slots point at index 0 too: the scatter-add keeps the DC
    (an assigning scatter would race), batched and per item, and equals
    JAX's one-hot reduce."""
    rng = np.random.default_rng(0)
    n, nblocks, k, cap = 3, 50, 6, 8
    idx = np.zeros((n, nblocks, k), np.uint8)
    val = np.zeros((n, nblocks, k), np.int16)
    for i in range(n):
        for b in range(nblocks):
            m = rng.integers(0, k + 1)
            pos = np.sort(rng.choice(64, m, replace=False))
            idx[i, b, :m] = pos
            val[i, b, :m] = rng.integers(1, 1000, m) * rng.choice([-1, 1], m)
    ids = np.full((n, cap), nblocks, np.int32)
    rows = np.zeros((n, cap, 64), np.int16)
    for i in range(n):
        chosen = rng.choice(nblocks, 3, replace=False)
        ids[i, :3] = chosen
        rows[i, :3] = rng.integers(-500, 500, (3, 64))
    got = P.unpack_block_coeffs(*map(torch.from_numpy, (idx, val, ids, rows))).numpy()
    for i in range(n):
        want = np.asarray(J.unpack_block_coeffs(idx[i], val[i], ids[i], rows[i]))
        np.testing.assert_array_equal(got[i], want)
        assert (got[i][idx[i, :, 0] == 0, 0] != 0).any()  # real DCs at index 0 survive
        np.testing.assert_array_equal(got[i, ids[i, :3]], rows[i, :3])


def test_choose_block_packing_is_the_references():
    rng = np.random.default_rng(1)
    for size, hi in ((10, 64), (5000, 10), (300_000, 20), (48960, 9), (7, 3)):
        nnzb = rng.integers(0, hi, size) * (rng.random(size) < 0.6)
        assert P.choose_block_packing(nnzb) == J.choose_block_packing(nnzb)


# -- the device stages ----------------------------------------------------------


@pytest.mark.parametrize("shape", [(3, 8, 16), (16, 24), (2, 1, 1), (1, 5, 9)])
def test_upsamplers_are_bit_exact(shape):
    c = np.random.default_rng(sum(shape)).integers(0, 256, shape).astype(np.int32)
    t = torch.from_numpy(c)
    for fh, fv in ((2, 2), (2, 1), (1, 1), (3, 1), (1, 2), (4, 4)):
        np.testing.assert_array_equal(P.upsample(t, fh, fv).numpy(),
                                      np.asarray(J.upsample(c, fh, fv)), err_msg=str((fh, fv)))
    np.testing.assert_array_equal(P.upsample_h2v2_fancy(t).numpy(),
                                  np.asarray(J.upsample_h2v2_fancy(c)))
    np.testing.assert_array_equal(P.upsample_h2v1_fancy(t).numpy(),
                                  np.asarray(J.upsample_h2v1_fancy(c)))


def test_colour_conversion_is_bit_exact():
    rng = np.random.default_rng(2)
    y, cb, cr = (rng.integers(0, 256, (2, 33, 47)).astype(np.int32) for _ in range(3))
    # every (cb, cr) pair once, at one luma each
    grid = np.stack(np.meshgrid(np.arange(256), np.arange(256)), 0).reshape(2, 256, 256)
    for planes in ((y, cb, cr), (rng.integers(0, 256, (256, 256)), grid[0], grid[1])):
        got = P.ycbcr_to_bgr_planes(*map(torch.from_numpy, planes))
        want = J.ycbcr_to_bgr_planes(*planes)
        for a, b in zip(got, want):
            assert a.dtype == torch.uint8
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(P.ycbcr_to_bgr(*map(torch.from_numpy, planes)).numpy(),
                                      np.asarray(J.ycbcr_to_bgr(*planes)))


@pytest.mark.parametrize("w,h,seq,sub", FRAMES)
def test_dequant_idct_is_close_to_the_references(coders, w, h, seq, sub):
    _, dense, qts = native.jpeg_entropy_decode(_jfif(w, h, seq, sub=sub))
    batch = np.stack([dense[0], dense[0][::-1]])  # a batch dim, two items
    got = P.dequant_idct_plane(torch.from_numpy(batch), torch.from_numpy(qts[0].astype(np.int32)))
    assert got.dtype == torch.int32 and got.shape == (2, dense[0].shape[0] * 8, dense[0].shape[1] * 8)
    for i in range(2):
        _close(got[i].numpy(), np.asarray(J.dequant_idct_plane(batch[i], qts[0].astype(np.int32))))


@pytest.mark.parametrize("w,h,seq,sub", FRAMES)
def test_decoded_frame_is_close_to_jax_and_the_oracle(coders, w, h, seq, sub):
    data = _jfif(w, h, seq, sub=sub)
    oracle = P.decode_jpeg_numpy(data)
    np.testing.assert_array_equal(oracle, J.decode_jpeg_numpy(data))
    got = P.decode_jpeg_tpu(data, device="cpu").numpy()
    assert got.shape == (h, w, 3) and got.dtype == np.uint8
    _close(got, np.asarray(J.decode_jpeg_tpu(data)))
    _close(got, oracle, ORACLE)


def test_gray_jpeg_decodes_to_three_equal_channels(coders):
    data = jpeg_encode.encode_jpeg(sim.synth_bgr(48, 32, 1)[..., 1].copy(), 80)
    got = P.decode_jpeg_tpu(data, device="cpu").numpy()
    assert got.shape == (32, 48, 3) and (got == got[..., :1]).all()
    _close(got, P.decode_jpeg_numpy(data), ORACLE)


def test_simulated_frames_come_from_the_ports_encoder_without_pil(coders):
    bgr = sim.synth_bgr(64, 48, 5)
    raw = sim.synth_raw(64, 48, PixelFormat.MJPEG, 5)
    assert bytes(raw) == bytes(sim.encode_mjpeg(bgr)) == _jfif(64, 48, 5)
    info, coeffs, _ = native.jpeg_entropy_decode(raw)
    assert (info["width"], info["height"], info["ncomp"], info["h_samp"]) == (64, 48, 3, [2, 1, 1])
    loss = np.abs(P.decode_jpeg_numpy(raw).astype(int) - bgr)
    assert np.median(loss) <= 1 and loss.mean() < 10  # q90 4:2:0 codec loss


# -- the engine ---------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(),
    dict(resize_to=(32, 24)),
    dict(resize_to=(30, 20)),  # an output width that is not a multiple of 4
    dict(filter="blur_sobel", overlay=True),
    dict(filter="sobel_mag", resize_to=(32, 24)),
    dict(filter="gaussian", overlay=True, resize_to=(40, 30)),
], ids=["plain", "resize", "resize_odd", "blur_sobel_overlay", "sobel_resize", "gaussian"])
def test_engine_ticks_are_close_to_jax(jax_cpu, same_bytes, kw):
    rects = np.array([[4, 4, 20, 10], [-3, 8, 50, 30]], np.int32)
    colors = np.array([[0, 255, 0], [9, 99, 199]], np.uint8)
    over = dict(rects=rects, rect_colors=colors) if kw.get("overlay") else {}
    port = _port(64, 48, 2, **kw)
    got = _ticks(port, 3, **over)
    assert port.spec.mjpeg_packed and port.spec.coeff_geometry == ((6, 8), (3, 4), (3, 4))
    _assert_close_ticks(got, _ticks(_jax(64, 48, 2, **kw), 3, **over))
    w, h = kw.get("resize_to", (64, 48))
    assert got[0]["bgr"].shape == (2, h, w, 3) and got[2]["seqs"].tolist() == [2, 2]
    port.close()


def test_engine_tick_is_close_to_the_oracle(coders):
    port = _port(64, 48, 3)
    for t, res in enumerate(_ticks(port, 2)):
        want = P.decode_jpeg_numpy(sim.synth_raw(64, 48, PixelFormat.MJPEG, t))
        for i in range(3):
            _close(res["bgr"][i], want, ORACLE)
    small = _port(160, 120, 2, resize_to=(64, 48))
    got = _ticks(small, 1)[0]["bgr"]
    want = resize.resize_bilinear(
        torch.from_numpy(P.decode_jpeg_numpy(sim.synth_raw(160, 120, PixelFormat.MJPEG, 0))),
        64, 48).numpy()
    for i in range(2):
        _close(got[i], want, ORACLE)


def test_blur_sobel_on_mjpeg_reads_the_decoded_gray(coders):
    """The gray filters take the luma of the decoded packed rows, so
    blur_sobel on MJPEG is K1's route, held here by its plain version."""
    eng = _port(64, 48, 2, filter="blur_sobel", stencil_impl="pallas")
    kernels.reset_launch_counts()
    res = eng.tick(block=True)
    gray = torch.from_numpy(res.numpy("bgr")).to(torch.int32)
    luma = ((77 * gray[..., 2] + 150 * gray[..., 1] + 29 * gray[..., 0] + 128) >> 8).to(torch.uint8)
    assert torch.equal(res.outputs["filtered"], kernels.stencil.blur_sobel_mag_plain(luma))
    assert sum(kernels.launch_counts().values()) == 0  # the CPU runs the plain version


def test_forced_dense_tick_equals_the_packed_program(jax_cpu, same_bytes):
    """Capacity 0 sends every busy block over it: the tick runs the dense
    program on the dense grids and must equal the packed program's tick of
    the same frames, in both packages."""
    packed = _port(128, 96, 2)
    want = _ticks(packed, 2)
    dense = _port(128, 96, 2)
    _ticks(dense, 1)
    dense._dense_cap = 0
    got = _ticks(dense, 1)[0]
    for key in ("bgr", "seqs"):
        np.testing.assert_array_equal(got[key], want[1][key])
    ref = _jax(128, 96, 2)
    _ticks(ref, 1)
    ref._dense_cap = 0
    _assert_close_ticks([got], _ticks(ref, 1))


def test_one_stream_over_capacity_runs_the_batch_dense(monkeypatch, coders):
    """One stream over capacity: the packed streams' grids are unpacked on
    the host and the whole tick runs dense, equal to an all-packed tick."""
    eng = _port(128, 96, 3)
    _ticks(eng, 1)
    orig = native.jpeg_entropy_decode_blockpacked
    lock, calls = threading.Lock(), []

    def over_once(data, k, cap, **kw):
        with lock:
            calls.append(1)
            first = len(calls) == 2
        return None if first else orig(data, k, cap, **kw)

    monkeypatch.setattr(native, "jpeg_entropy_decode_blockpacked", over_once)
    kind, slot, seqs = eng.gather_hybrid()
    assert kind == "dense" and seqs.tolist() == [1, 1, 1]
    monkeypatch.setattr(native, "jpeg_entropy_decode_blockpacked", orig)
    mixed = _fetch(eng.tick(block=True, pregathered=(kind, slot, seqs)))
    clean = _port(128, 96, 3)
    want = _ticks(clean, 2)[1]
    for key in ("bgr", "seqs"):
        np.testing.assert_array_equal(mixed[key], want[key])


def _corrupt(src):
    def next_frame():
        f = src.next_frame()
        d = np.array(f.data)
        d[30:] = 0xFF  # trash the scan: a DecodeError inside the gather
        return SimpleNamespace(sequence=f.sequence, data=d)
    return SimpleNamespace(next_frame=next_frame, resolved_config=src.resolved_config,
                           stop=src.stop)


def test_corrupt_frame_and_dead_source_are_contained(jax_cpu, same_bytes):
    port, ref = _port(128, 96, 2), _jax(128, 96, 2)
    first = _ticks(port, 1)[0]
    _assert_close_ticks([first], _ticks(ref, 1))
    for eng in (port, ref):
        eng._sources[1] = _corrupt(eng._sources[1])
    got, want = _ticks(port, 1)[0], _ticks(ref, 1)[0]
    _assert_close_ticks([got], [want])
    assert got["seqs"].tolist() == [1, -1] and port.stream_errors.tolist() == [0, 1]
    np.testing.assert_array_equal(got["bgr"][1], first["bgr"][1])  # its last good frame

    def dead():
        raise CameraError("device unplugged")

    port._sources[1] = SimpleNamespace(next_frame=dead, stop=lambda: None)
    got = _ticks(port, 1)[0]
    assert got["seqs"].tolist() == [2, -1] and port.stream_errors.tolist() == [0, 2]
    np.testing.assert_array_equal(got["bgr"][1], first["bgr"][1])
    port.close()


def test_subsampling_switch_is_contained(jax_cpu, same_bytes):
    """A stream that switches to 4:2:2 mid-run no longer fits the staging
    sized by the first frame: that stream degrades, the batch goes on."""
    port, ref = _port(128, 96, 2), _jax(128, 96, 2)
    first = _ticks(port, 1)[0]
    _ticks(ref, 1)
    for eng in (port, ref):
        src = eng._sources[1]

        def next_frame(src=src):
            f = src.next_frame()
            data = jpeg_encode.encode_jpeg(sim.synth_bgr(128, 96, f.sequence), 88, "4:2:2")
            return SimpleNamespace(sequence=f.sequence, data=np.frombuffer(data, np.uint8))

        eng._sources[1] = SimpleNamespace(next_frame=next_frame, stop=src.stop)
    got, want = _ticks(port, 1)[0], _ticks(ref, 1)[0]
    assert got["seqs"].tolist() == want["seqs"].tolist() == [1, -1]
    assert port.stream_errors[1] == ref.stream_errors[1] == 1
    np.testing.assert_array_equal(got["bgr"][1], first["bgr"][1])
    _close(got["bgr"], want["bgr"])
    port.close()


def test_prefetching_run_matches_sequential_ticks(coders):
    eng = _port(64, 48, 3, resize_to=(32, 24))
    seen = []
    tick = eng.tick

    def recorded(*args, **kwargs):
        res = tick(*args, **kwargs)
        seen.append(_fetch(res))
        return res

    eng.tick = recorded
    stats = eng.run(6, warmup=0, measure_latency=False)
    assert (stats.frames, stats.dropped_frames) == (18, 0) and stats.host_gather_ms > 0
    want = _ticks(_port(64, 48, 3, resize_to=(32, 24)), 6)
    for p, j in zip(seen, want):
        for key in ("bgr", "seqs"):
            np.testing.assert_array_equal(p[key], j[key])
    eng.close()


def test_hybrid_state_round_trips(jax_cpu, same_bytes):
    port = _port(64, 48, 2, resize_to=(32, 24))
    _ticks(port, 2)
    state = port.export_state()
    assert state == _jax(64, 48, 2, resize_to=(32, 24)).export_state() | {"tick_index": 2}
    again = MultiStreamEngine.from_state(state, device="cpu", mjpeg_backend="hybrid")
    assert again.export_state() == state and again._mjpeg_hybrid
    _assert_close_ticks(_ticks(again, 1), _ticks(JaxEngine(
        JaxDriver(device_count=2, paced=False), 2, _cfg(64, 48, jax_core),
        mjpeg_backend="hybrid", resize_to=(32, 24)), 1))
