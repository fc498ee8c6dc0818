"""The port's trackers (``rustcv_tpu_torch.ops.tracker`` MOSSE, ``kcf``,
``csrt``, and the copies ``mil`` and ``dsst_scale``), against
``rustcv_tpu`` (JAX on the CPU) and its float64 oracles on the same seeded
scenes.

Tolerances, the reference's own (``tests/test_tracker.py``,
``test_kcf.py``, ``test_csrt.py``, ``test_mil.py``,
``test_dsst_scale.py``):
- the tensor twins: centres and ``ok`` equal to the oracle's and to JAX's
  at every step, the response peak (PSR for MOSSE) within 5e-3;
- the host backends, MIL and DSST: exact (the same float64 code);
- a bank of 2 equals two lone trackers (the counterpart of the
  reference's ``test_vmap_bank``): a bank is a leading batch axis of the
  state."""

import numpy as np
import pytest
import torch

from rustcv_tpu.ops import csrt as JC
from rustcv_tpu.ops import dsst_scale as JD
from rustcv_tpu.ops import golden as G
from rustcv_tpu.ops import kcf as JK
from rustcv_tpu.ops import mil as JM
from rustcv_tpu.ops import tracker as JT
from rustcv_tpu_torch.core import Mat
from rustcv_tpu_torch.ops import csrt as PC
from rustcv_tpu_torch.ops import dsst_scale as PD
from rustcv_tpu_torch.ops import golden as PG
from rustcv_tpu_torch.ops import kcf as PK
from rustcv_tpu_torch.ops import mil as PM
from rustcv_tpu_torch.ops import tracker as PT

torch.set_num_threads(2)


def _scene(n_frames=12, size=(120, 160), start=(40, 50), vel=(2, 3), seed=3, target=32):
    """A textured square moving at a constant integer velocity over a noisy
    background (the reference's scene) → (frames u8 [T, H, W], centres)."""
    h, w = size
    t2 = target // 2
    rng = np.random.default_rng(seed)
    bg = rng.integers(20, 60, (h, w)).astype(np.uint8)
    tex = rng.integers(120, 255, (target, target)).astype(np.uint8)
    frames, centers = [], []
    cy, cx = start
    for _ in range(n_frames):
        f = bg.copy()
        y0, x0 = cy - t2, cx - t2
        ys = slice(max(y0, 0), min(y0 + target, h))
        xs = slice(max(x0, 0), min(x0 + target, w))
        f[ys, xs] = tex[ys.start - y0:ys.stop - y0, xs.start - x0:xs.stop - x0]
        frames.append(f)
        centers.append((cy, cx))
        cy, cx = cy + vel[0], cx + vel[1]
    return np.stack(frames), centers


# name → (port module, reference module, oracle init, oracle step, half box,
#         step kwargs)
TRACKERS = {
    "mosse": (PT, JT, G.mosse_init, G.mosse_step, 32, {}),
    "kcf": (PK, JK, JK.kcf_init, JK.kcf_step, 16, {}),
    "csrt": (PC, JC, JC.csrt_init, JC.csrt_step, 16, {"target": (32, 32)}),
}


@pytest.mark.parametrize("name", sorted(TRACKERS))
def test_twin_matches_jax_and_oracle(jax_cpu, name):
    pmod, jmod, oinit, ostep, half, kw = TRACKERS[name]
    frames, centers = _scene()
    cy, cx = centers[0]
    bbox = (cx - half, cy - half, 2 * half, 2 * half)
    gst, jst = oinit(frames[0], bbox), jmod.init(frames[0], bbox)
    pst = pmod.init(torch.from_numpy(frames[0]), bbox)
    for t in range(1, len(frames)):
        gst, gok, gscore = ostep(gst, frames[t])
        jst, jok, jscore = jmod.step(jst, frames[t], **kw)
        pst, pok, pscore = pmod.step(pst, torch.from_numpy(frames[t]), **kw)
        assert pok.shape == (1,) and bool(pok[0]) == gok == bool(jok)
        assert pst.center[0].tolist() == list(gst["center"]) == np.asarray(jst.center).tolist()
        assert abs(float(pscore[0]) - gscore) < 5e-3, t
        assert abs(float(pscore[0]) - float(jscore)) < 5e-3, t
    # the state's fields keep the reference's names, with a bank axis of 1
    for field, want in zip(pst._fields, jst):
        assert field in jmod.__dict__[type(jst).__name__]._fields
        got = getattr(pst, field)
        assert tuple(got.shape) == (1,) + tuple(np.shape(want))


def test_mosse_init_filters_agree(jax_cpu):
    frames, centers = _scene()
    cy, cx = centers[0]
    bbox = (cx - 32, cy - 32, 64, 64)
    p = PT.init(torch.from_numpy(frames[0]), bbox)
    j = JT.init(frames[0], bbox)
    g = G.mosse_init(frames[0], bbox)
    w2 = g["A"].shape[1]
    a = (p.a_re[0] + 1j * p.a_im[0]).numpy()
    np.testing.assert_allclose(a[:, :w2], g["A"], rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(p.b[0].numpy()[:, :w2], g["B"], rtol=2e-3, atol=2e-3)
    scale = np.abs(np.asarray(j.a_re)).max()
    assert np.abs(p.a_re[0].numpy() - np.asarray(j.a_re)).max() < 1e-4 * scale


@pytest.mark.parametrize("name", sorted(TRACKERS))
def test_failure_freezes_the_state(jax_cpu, name):
    pmod, _, _, _, half, kw = TRACKERS[name]
    frames, centers = _scene(n_frames=4)
    cy, cx = centers[0]
    st = pmod.init(torch.from_numpy(frames[0]), (cx - half, cy - half, 2 * half, 2 * half))
    st, ok, _ = pmod.step(st, torch.from_numpy(frames[1]), **kw)
    assert bool(ok[0])
    st2, ok2, _ = pmod.step(st, torch.full_like(torch.from_numpy(frames[0]), 37), **kw)
    assert not bool(ok2[0])
    assert torch.equal(st2.center, st.center)
    assert all(torch.equal(a, b) for a, b in zip(st2, st))


@pytest.mark.parametrize("name", sorted(TRACKERS))
def test_bank_of_two_equals_two_lone_trackers(jax_cpu, name):
    """The counterpart of the reference's ``test_vmap_bank``: two targets of
    one size in one bank, each on its own frames, step as one batch and
    equal two lone trackers; one shared frame works too."""
    pmod, _, _, _, half, kw = TRACKERS[name]
    f1, c1 = _scene(seed=3)
    f2, c2 = _scene(seed=4, start=(60, 80), vel=(-2, 1))
    b1 = (c1[0][1] - half, c1[0][0] - half, 2 * half, 2 * half)
    b2 = (c2[0][1] - half, c2[0][0] - half, 2 * half, 2 * half)
    s1 = pmod.init(torch.from_numpy(f1[0]), b1)
    s2 = pmod.init(torch.from_numpy(f2[0]), b2)
    bank = type(s1)(*[torch.cat([a, b]) for a, b in zip(s1, s2)])
    for t in range(1, 5):
        bank, ok, score = pmod.step(bank, torch.from_numpy(np.stack([f1[t], f2[t]])), **kw)
        s1, ok1, sc1 = pmod.step(s1, torch.from_numpy(f1[t]), **kw)
        s2, ok2, sc2 = pmod.step(s2, torch.from_numpy(f2[t]), **kw)
        assert bool(ok[0]) and bool(ok[1]) and bool(ok1[0]) and bool(ok2[0])
        assert torch.equal(bank.center, torch.cat([s1.center, s2.center]))
        np.testing.assert_allclose(score.numpy(), torch.cat([sc1, sc2]).numpy(), atol=1e-5)
    assert abs(int(bank.center[0, 0]) - c1[4][0]) <= 1
    assert abs(int(bank.center[1, 1]) - c2[4][1]) <= 1
    # one frame, two boxes on it: init takes both, step reads the one frame
    both = pmod.init(torch.from_numpy(f1[0]), [b1, b1])
    lone = pmod.init(torch.from_numpy(f1[0]), b1)
    both, ok, _ = pmod.step(both, torch.from_numpy(f1[1]), **kw)
    lone, _, _ = pmod.step(lone, torch.from_numpy(f1[1]), **kw)
    assert torch.equal(both.center, lone.center.expand(2, 2))
    with pytest.raises(ValueError, match="one size"):
        pmod.init(torch.from_numpy(f1[0]), [b1, (0, 0, 2 * half + 2, 2 * half)])


@pytest.mark.parametrize("backend", ["host", "device"])
@pytest.mark.parametrize("name", sorted(TRACKERS))
def test_object_api_both_backends(jax_cpu, name, backend):
    pmod, jmod, _, _, half, _ = TRACKERS[name]
    cls = {"mosse": "TrackerMOSSE", "kcf": "TrackerKCF", "csrt": "TrackerCSRT"}[name]
    frames, centers = _scene()
    cy, cx = centers[0]
    bbox = (cx - half, cy - half, 2 * half, 2 * half)
    port = getattr(pmod, cls)(backend=backend)
    ref = getattr(jmod, cls)(backend=backend)
    port.init(Mat.from_array(frames[0], device="cpu"), bbox)  # a host Mat: runs on the CPU
    ref.init(frames[0], bbox)
    for k in range(1, len(frames)):
        got, want = port.update(frames[k] if backend == "host" else torch.from_numpy(frames[k])), \
            ref.update(frames[k])
        assert got == want
        ok, (x, y, w, h) = got
        assert ok and (w, h) == (2 * half, 2 * half)
        assert abs((y + h // 2) - centers[k][0]) <= 1 and abs((x + w // 2) - centers[k][1]) <= 1
    score = "last_psr" if name == "mosse" else "last_response"
    tol = 0.0 if backend == "host" else 5e-3
    assert abs(getattr(port, score) - getattr(ref, score)) <= tol
    if backend == "device":
        assert port._state.center.device.type == "cpu"


def test_bgr_mats_and_tensors(jax_cpu):
    """A BGR Mat (host or CPU-tensor) or a BGR tensor converts by the exact
    luma, as the reference's ``_gray``."""
    frames, centers = _scene()
    bgr = np.stack([frames, frames // 2, 255 - frames], -1)
    cy, cx = centers[0]
    bbox = (cx - 16, cy - 16, 32, 32)
    ref = JK.TrackerKCF()
    ref.init(bgr[0], bbox)
    want = [ref.update(bgr[t]) for t in (1, 2)]
    for wrap in (lambda a: Mat.from_array(a, device="cpu"),
                 lambda a: Mat.from_device(torch.from_numpy(a.copy())),
                 lambda a: torch.from_numpy(a.copy())):
        t = PK.TrackerKCF()
        t.init(wrap(bgr[0]), bbox)
        assert [t.update(wrap(bgr[k])) for k in (1, 2)] == want
    np.testing.assert_array_equal(PG.bgr_to_gray(bgr[0]), G.bgr_to_gray(bgr[0]))
    with pytest.raises(RuntimeError, match="init"):
        PT.TrackerMOSSE().update(frames[0])
    with pytest.raises(ValueError):
        PT.TrackerMOSSE(backend="gpu")


@pytest.mark.parametrize("name", sorted(TRACKERS))
def test_host_oracles_are_the_references(name):
    _, jmod, _, _, half, _ = TRACKERS[name]
    pmod = TRACKERS[name][0]
    frames, centers = _scene(n_frames=5)
    cy, cx = centers[0]
    bbox = (cx - half, cy - half, 2 * half, 2 * half)
    if name == "mosse":
        pi, ps, ji, js = PG.mosse_init, PG.mosse_step, G.mosse_init, G.mosse_step
    else:
        pi, ps = getattr(pmod, f"{name}_init"), getattr(pmod, f"{name}_step")
        ji, js = getattr(jmod, f"{name}_init"), getattr(jmod, f"{name}_step")
    a, b = pi(frames[0], bbox), ji(frames[0], bbox)
    blank = np.full_like(frames[0], 37)
    for f in list(frames[1:]) + [blank]:
        a, oka, sa = ps(a, f)
        b, okb, sb = js(b, f)
        assert (oka, sa) == (okb, sb) and a["center"] == b["center"]
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
    with pytest.raises(ValueError):
        pi(frames[0], (10, 10, 3, 3))
    with pytest.raises(ValueError):
        pmod.init(torch.from_numpy(frames[0]), (10, 10, 3, 3))


def test_csrt_orientation_bins_are_the_oracles():
    """The exact orientation binning on every half-integer gradient of u8
    pixels equals the float64 oracle's ⌊(atan2 mod π)·8/π⌋."""
    g = torch.arange(-255, 256, dtype=torch.float32) * 0.5
    gy, gx = torch.meshgrid(g, g, indexing="ij")
    th = np.arctan2(gy.numpy().astype(np.float64), gx.numpy().astype(np.float64)) % np.pi
    want = np.minimum((th * (8 / np.pi)).astype(np.int64), 7)
    want = np.where(gy.numpy() == 0, 0, want)  # θ = π mod π = 0
    assert np.array_equal(PC._orient_bins(gx, gy).numpy(), want)


def test_csrt_features_and_mask_match_the_oracle():
    rng = np.random.default_rng(0)
    for _ in range(3):
        patch = rng.integers(0, 256, (60, 60)).astype(np.uint8)
        patch[10:30, 10:30] = patch[10, 10]
        np.testing.assert_allclose(PC._features(torch.from_numpy(patch)[None])[0].numpy(),
                                   JC._features_np(patch), atol=5e-7)
    patch = np.full((80, 80), 40, np.uint8)
    patch[24:56, 24:56] = 200
    patch[30:50, 10:22] = 45
    for p in (patch, np.full((80, 80), 90, np.uint8)):
        fg, bg = PC._hists(torch.from_numpy(p)[None], 32, 32)
        gfg, gbg = JC._hists_np(p, 32, 32)
        np.testing.assert_allclose(fg[0].numpy(), gfg, rtol=1e-6)
        m = PC._mask(torch.from_numpy(p)[None], 32, 32, fg, bg)[0].numpy()
        assert np.array_equal(m, JC._mask_np(p, 32, 32, gfg, gbg))


def _mil_scene(n_frames=8, fade=0.0):
    h, w = 120, 160
    rng = np.random.default_rng(3)
    bg = rng.integers(20, 60, (h, w)).astype(np.uint8)
    tex = rng.integers(120, 255, (32, 32)).astype(np.uint8)
    frames, centers = [], []
    cy, cx = 40, 50
    for t in range(n_frames):
        f = bg.copy()
        f[cy - 16:cy + 16, cx - 16:cx + 16] = np.clip(tex * (1.0 - fade * t), 0, 255)
        frames.append(f)
        centers.append((cy, cx))
        cy, cx = cy + 2, cx + 3
    return frames, centers


@pytest.mark.parametrize("fade", [0.0, 0.04])
def test_mil_is_the_references(fade):
    frames, centers = _mil_scene(fade=fade)
    cy, cx = centers[0]
    port, ref = PM.TrackerMIL(), JM.TrackerMIL()
    port.init(frames[0], (cx - 16, cy - 16, 32, 32))
    ref.init(frames[0], (cx - 16, cy - 16, 32, 32))
    for t in range(1, len(frames)):
        got = port.update(frames[t])
        assert got == ref.update(frames[t])
        _, (x, y, _, _) = got
        assert abs(x + 16 - centers[t][1]) <= 4 and abs(y + 16 - centers[t][0]) <= 4


@pytest.mark.parametrize("growth", [1.03, 0.97, 1.0])
def test_dsst_is_the_references(growth):
    rng = np.random.default_rng(3)
    tex = rng.integers(40, 255, (64, 64)).astype(np.uint8)
    frames, sizes = [], []
    for i in range(6):
        side = int(round(32 * growth ** i))
        patch = PG.resize_bilinear(np.stack([tex] * 3, -1), side, side)[..., 0]
        f = np.full((140, 180), 30, np.uint8)
        f[70 - side // 2:70 - side // 2 + side, 90 - side // 2:90 - side // 2 + side] = patch
        frames.append(f)
        sizes.append(side)
    port = PD.ScaleEstimator(frames[0], (90, 70), (sizes[0], sizes[0]))
    ref = JD.ScaleEstimator(frames[0], (90, 70), (sizes[0], sizes[0]))
    for f, side in zip(frames[1:], sizes[1:]):
        assert port.update(f, (90, 70)) == ref.update(f, (90, 70))
        assert abs(port.scale - side / sizes[0]) / (side / sizes[0]) < 0.08
    assert port.size == ref.size
