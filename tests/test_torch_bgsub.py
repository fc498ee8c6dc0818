"""The port's background subtractors (``rustcv_tpu_torch.ops.bgsub``,
``knn_bgsub``) and their ``imgproc`` factories, against ``rustcv_tpu``
(JAX on the CPU) and its float64 numpy oracles on the same seeded frames.

Tolerances, the reference's own (``tests/test_bgsub.py``,
``test_knn_bgsub.py``):
- MOG2: masks equal to the oracle's and to JAX's on these frames (the
  card is held to 99.99 % of pixels in ``chip_smoke.py``: a pixel on the
  float32 match gate can flip), model state within 1e-4;
- KNN: masks exact (a float32 compare of small-integer sums), samples
  within 1e-5;
- shadows: the reference's 127/255/0 shares.

On a tensor or a device Mat, ``apply`` returns a tensor on that device;
on a host Mat (run on its target device, the CPU here) or a numpy frame
(run on the card) it returns numpy (the reference always downloads:
ROADMAP Queue 3, "Deviations kept on purpose")."""

import numpy as np
import pytest
import torch

from rustcv_tpu.ops import bgsub as JB
from rustcv_tpu.ops import knn_bgsub as JK
from rustcv_tpu_torch import imgproc as port_ip
from rustcv_tpu_torch.core import Mat
from rustcv_tpu_torch.ops import bgsub as PB
from rustcv_tpu_torch.ops import knn_bgsub as PK

torch.set_num_threads(2)


def _np(state):
    return tuple(s.numpy() for s in state)


def _host(a):
    """A host Mat on the CPU: ``apply`` runs there and returns numpy."""
    return Mat.from_array(np.ascontiguousarray(a), device="cpu")


def _gray_clip(seed, n=8, h=12, w=16):
    rng = np.random.default_rng(seed)
    frames = []
    for t in range(n):
        f = (100 + rng.normal(0, 3, (h, w))).clip(0, 255).astype(np.uint8)
        if t >= 5:
            f[4:8, 6:10] = 220  # an object appears
        frames.append(f)
    return frames


def _color_clip(seed, n=5, h=12, w=16):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h, w, 3), np.uint8)
    frames = []
    for t in range(n):
        f = (base.astype(int) + rng.integers(-2, 3, base.shape)).clip(0, 255).astype(np.uint8)
        if t == n - 1:
            f[3:6, 4:8] = [255, 0, 0]
        frames.append(f)
    return frames


@pytest.mark.parametrize("clip", ["gray", "color"])
def test_mog2_matches_jax_and_oracle(jax_cpu, clip):
    frames = _gray_clip(0) if clip == "gray" else _color_clip(4)
    shape = frames[0].shape
    sp = PB.mog2_init(shape, device="cpu")
    sj = JB.mog2_init(shape)
    sn = tuple(np.asarray(s) for s in sj)
    for t, f in enumerate(frames):
        sp, fgp = PB.mog2_step(sp, torch.from_numpy(f))
        sj, fgj = JB.mog2_step(sj, f)
        sn, fgn = JB.mog2_step_numpy(sn, f)
        assert np.array_equal(fgp.numpy(), fgn), f"frame {t}"
        assert np.array_equal(fgp.numpy(), np.asarray(fgj)), f"frame {t}"
        for a, b, c in zip(_np(sp), sn, sj):
            np.testing.assert_allclose(a, b, atol=1e-4)
            np.testing.assert_allclose(a, np.asarray(c), atol=1e-4)


def test_mog2_numpy_oracle_is_the_references():
    frames = _gray_clip(7, n=4, h=6, w=8)
    s1 = s2 = tuple(np.asarray(s) for s in (np.zeros((4, 6, 8)), np.zeros((4, 6, 8)),
                                             np.full((4, 6, 8), 225.0)))
    for f in frames:
        s1, m1 = PB.mog2_step_numpy(s1, f)
        s2, m2 = JB.mog2_step_numpy(s2, f)
        assert np.array_equal(m1, m2)
        assert all(np.array_equal(a, b) for a, b in zip(s1, s2))


def test_mog2_clip_loop(jax_cpu):
    """The counterpart of the reference's ``test_scan_compatible``: a clip
    is a Python loop of steps on the device, no host read in between;
    the masks equal the reference's ``lax.scan``."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    clip = rng.integers(90, 110, (6, 8, 10), np.uint8)
    clip[4:, 2:5, 3:7] = 240
    _, want = jax.lax.scan(JB.mog2_step, JB.mog2_init((8, 10)), jnp.asarray(clip))
    state, masks = PB.mog2_init((8, 10), device="cpu"), []
    for f in torch.from_numpy(clip):
        state, fg = PB.mog2_step(state, f)
        masks.append(fg)
    got = torch.stack(masks).numpy()
    assert got.shape == (6, 8, 10) and got[5, 3, 4]
    assert np.array_equal(got, np.asarray(want))


def test_mog2_behaviour(jax_cpu):
    """The reference's behavioural cases on the port's subtractor: a static
    scene goes background, a mover is foreground, a stopped object is
    absorbed, a flickering pixel learns both modes."""
    rng = np.random.default_rng(1)
    base = rng.integers(0, 256, (24, 32), np.uint8)
    sub = PB.BackgroundSubtractorMOG2()
    for _ in range(20):
        fg = sub.apply(_host((base.astype(int) + rng.integers(-2, 3, base.shape)).clip(0, 255)
                             .astype(np.uint8)))
    assert isinstance(fg, np.ndarray) and fg.mean() < 0.01
    assert np.abs(sub.background.astype(int) - base.astype(int)).mean() < 4

    base = np.random.default_rng(2).integers(40, 120, (24, 32), np.uint8)
    sub = PB.BackgroundSubtractorMOG2(alpha=0.05)
    for _ in range(30):
        sub.apply(_host(base))
    frame = base.copy()
    frame[10:16, 12:20] = 250
    fg = sub.apply(_host(frame))
    assert fg[10:16, 12:20].mean() > 0.95
    fg[10:16, 12:20] = False
    assert fg.mean() < 0.02

    base = np.full((16, 16), 60, np.uint8)
    sub = PB.BackgroundSubtractorMOG2(alpha=0.08)
    for _ in range(20):
        sub.apply(_host(base))
    frame = base.copy()
    frame[4:12, 4:12] = 200
    flagged = [sub.apply(_host(frame))[6, 6] for _ in range(80)]
    assert flagged[0] and not flagged[-1]

    sub = PB.BackgroundSubtractorMOG2(alpha=0.05)
    rng = np.random.default_rng(3)
    for _ in range(120):
        last = sub.apply(torch.full((8, 8), (50, 180)[rng.integers(0, 2)], dtype=torch.uint8))
    assert last.float().mean() < 0.05
    with pytest.raises(RuntimeError, match="apply"):
        PB.BackgroundSubtractorMOG2().background
    with pytest.raises(ValueError, match="shape"):
        sub.apply(torch.zeros((4, 4), dtype=torch.uint8))


def test_shadows_match_the_reference(jax_cpu):
    rng = np.random.default_rng(3)
    bg = rng.integers(90, 200, (40, 50, 3)).astype(np.uint8)
    port = PB.BackgroundSubtractorMOG2(detect_shadows=True)
    ref = JB.BackgroundSubtractorMOG2(detect_shadows=True)
    for _ in range(30):
        noisy = np.clip(bg.astype(float) + rng.normal(0, 2, bg.shape), 0, 255).astype(np.uint8)
        assert np.array_equal(port.apply(_host(noisy)), ref.apply(noisy))
    frame = bg.astype(float).copy()
    frame[10:20, 10:20] *= 0.6          # photometric shadow
    frame[25:35, 30:42] = [200, 30, 30]  # a real object (chroma)
    frame = np.clip(frame, 0, 255).astype(np.uint8)
    out = port.apply(_host(frame))
    assert np.array_equal(out, ref.apply(frame))
    assert (out[12:18, 12:18] == 127).mean() > 0.7
    assert (out[27:33, 32:40] == 255).mean() > 0.7
    assert (out[2:8, 2:8] == 0).mean() > 0.9
    assert np.array_equal(port.background, ref.background)
    # gray frames: the brightness ratio alone
    g = bg[..., 0]
    port, ref = (PB.BackgroundSubtractorMOG2(detect_shadows=True),
                 JB.BackgroundSubtractorMOG2(detect_shadows=True))
    for f in (g, g, (g * 0.7).astype(np.uint8)):
        assert np.array_equal(port.apply(_host(f)), ref.apply(f))


def test_apply_returns_a_tensor_for_a_tensor_or_device_mat(jax_cpu):
    """The deviation kept on purpose: a tensor frame (or a device Mat)
    gives a tensor mask on its device; a host Mat gives numpy (as a numpy
    frame does: it goes to the card, absent here)."""
    frames = _gray_clip(9)
    for shadows in (False, True):
        t_sub = PB.BackgroundSubtractorMOG2(detect_shadows=shadows)
        m_sub = port_ip.create_background_subtractor_mog2(detect_shadows=shadows)
        n_sub = PB.BackgroundSubtractorMOG2(detect_shadows=shadows)
        for f in frames:
            a = t_sub.apply(torch.from_numpy(f))
            b = m_sub.apply(Mat.from_device(torch.from_numpy(f[..., None].copy())))
            c = n_sub.apply(_host(f))
            assert isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)
            assert isinstance(c, np.ndarray)
            assert np.array_equal(a.numpy(), c) and np.array_equal(b.numpy(), c)
        assert t_sub._state[0].device.type == "cpu"
    k_sub = port_ip.create_background_subtractor_knn()
    for f in frames:
        m = k_sub.apply(torch.from_numpy(f))
        assert isinstance(m, torch.Tensor) and m.dtype == torch.uint8
    host = port_ip.create_background_subtractor_knn()
    assert isinstance(host.apply(_host(frames[0])), np.ndarray)


def _knn_clip(n=24, size=(40, 56), seed=2):
    rng = np.random.default_rng(seed)
    bg = rng.integers(40, 90, size).astype(np.uint8)
    frames = []
    for t in range(n):
        f = np.clip(bg + rng.integers(-3, 4, size).astype(np.int16), 0, 255).astype(np.uint8)
        if t >= 10:
            x = 6 + 2 * (t - 10)
            f[14:26, x:x + 8] = 230  # mover
        frames.append(f)
    return frames


@pytest.mark.parametrize("color", [False, True])
def test_knn_matches_jax_and_oracle(jax_cpu, color):
    frames = _knn_clip(n=16)
    if color:
        frames = [np.stack([f, f // 2, 255 - f], -1) for f in frames]
    sp = PK.knn_init(torch.from_numpy(frames[0]))
    sj = JK.knn_init(frames[0])
    sn = JK.knn_init_numpy(frames[0])
    sn2 = PK.knn_init_numpy(frames[0])
    for f in frames:
        sp, fgp = PK.knn_step(sp, torch.from_numpy(f))
        sj, fgj = JK.knn_step(sj, f)
        sn, fgn = JK.knn_step_numpy(sn, f)
        sn2, fgn2 = PK.knn_step_numpy(sn2, f)
        assert np.array_equal(fgp.numpy(), fgn) and np.array_equal(fgp.numpy(), np.asarray(fgj))
        assert np.array_equal(fgn2, fgn)
    assert sp.clock.dtype == torch.int32 and sp.clock.ndim == 0 and int(sp.clock) == 16
    np.testing.assert_allclose(sp.samples.numpy(), sn["samples"], atol=1e-5)
    np.testing.assert_allclose(sp.samples.numpy(), np.asarray(sj.samples), atol=1e-5)
    assert np.array_equal(sp.fg_run.numpy(), np.asarray(sj.fg_run))


def test_knn_absorbs_scene_change_and_update_period(jax_cpu):
    a = np.full((24, 32), 60, np.uint8)
    b = np.full((24, 32), 200, np.uint8)
    st = PK.knn_init(torch.from_numpy(a))
    for _ in range(8):
        st, _ = PK.knn_step(st, torch.from_numpy(a))
    p = PK.KNNParams(n_fg_max=5)
    for _ in range(5):
        st, fg = PK.knn_step(st, torch.from_numpy(b), p)
        assert bool(fg.all())
    for _ in range(8):
        st, fg = PK.knn_step(st, torch.from_numpy(b), p)
    assert not bool(fg.any())
    # every second frame updates, as the reference's clock
    frames = _knn_clip(n=14, seed=4)
    p = PK.KNNParams(update_period=2)
    sp, sj = PK.knn_init(torch.from_numpy(frames[0]), 3), JK.knn_init(frames[0], 3)
    for f in frames:
        sp, fgp = PK.knn_step(sp, torch.from_numpy(f), p)
        sj, fgj = JK.knn_step(sj, f, JK.KNNParams(update_period=2))
        assert np.array_equal(fgp.numpy(), np.asarray(fgj))
    assert np.array_equal(sp.samples.numpy(), np.asarray(sj.samples))


def test_knn_object_api_color(jax_cpu):
    rng = np.random.default_rng(5)
    port = port_ip.create_background_subtractor_knn()
    ref = JK.BackgroundSubtractorKNN()
    bg = rng.integers(0, 120, (24, 32, 3)).astype(np.uint8)
    for _ in range(8):
        m = port.apply(_host(bg))
        assert np.array_equal(m, ref.apply(bg))
    assert m.dtype == np.uint8 and m.shape == (24, 32) and m.mean() < 5
    moved = bg.copy()
    moved[6:18, 10:20] = (250, 250, 250)
    m2 = port.apply(_host(moved))
    assert np.array_equal(m2, ref.apply(moved)) and m2[8:16, 12:18].min() == 255
    np.testing.assert_allclose(port.background(), ref.background(), atol=1e-5)
    with pytest.raises(RuntimeError, match="apply"):
        PK.BackgroundSubtractorKNN().background()
