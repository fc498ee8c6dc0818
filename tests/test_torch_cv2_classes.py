"""The stateful classes of the port's cv2 facade against the reference's, over
sequences: the background subtractors (MOG2, KNN) over 8 frames, the Kalman
filter's predict/correct, the trackers' init/update, the brute-force
matcher, the feature detectors, CLAHE, stereo, the photo factories, and
``VideoCapture`` over the simulation driver and over a file from
``VideoWriter``.

Each scenario runs twice: on ``rustcv_tpu.cv2`` with numpy frames, and on
``rustcv_tpu_torch.cv2`` with the same frames as CPU tensors (refusing
implicit numpy conversions, as tensors on the card do). Results are equal
unless a bar is stated beside the scenario."""
import numpy as np
import pytest
import torch

import rustcv_tpu.cv2 as R
import rustcv_tpu_torch.cv2 as P
from cv2_torch_parity import as_on_the_card, same

H, W, N = 48, 64, 8


def _frames(n=N, h=H, w=W):
    """A textured background with a bright square moving 2 px a frame."""
    rng = np.random.default_rng(11)
    bg = np.clip(rng.normal(90, 25, (h, w, 3)), 0, 255).astype(np.uint8)
    out = []
    for i in range(n):
        f = bg.copy()
        y, x = 14 + i, 10 + 2 * i
        f[y:y + 14, x:x + 14] = (230, 200, 40)
        f[y + 4:y + 8, x + 3:x + 9] = (20, 60, 250)
        out.append(f)
    return out


def both(scenario, monkeypatch, bar=0):
    """``scenario(cv2, img)`` on the reference with numpy images and on the
    port with CPU tensors; the results held equal (or within ``bar``)."""
    ref = scenario(R, lambda a: a)
    with as_on_the_card(monkeypatch):
        port = scenario(P, lambda a: torch.from_numpy(np.ascontiguousarray(a)))
    same(ref, port, bar)
    return ref, port


@pytest.mark.parametrize("shadows", [True, False])
def test_mog2_over_eight_frames(shadows, monkeypatch):
    def run(cv, img):
        bs = cv.createBackgroundSubtractorMOG2(detectShadows=shadows)
        masks = [bs.apply(img(f)) for f in _frames()]
        return masks, bs.getBackgroundImage()

    (masks, _), _ = both(run, monkeypatch)
    assert masks[-1].any()  # the square is foreground


def test_knn_over_eight_frames(monkeypatch):
    def run(cv, img):
        bs = cv.createBackgroundSubtractorKNN()
        return [bs.apply(img(f)) for f in _frames()]

    masks, _ = both(run, monkeypatch)
    assert masks[-1].max() == 255


def test_kalman_predict_correct(monkeypatch):
    def run(cv, img):
        kf = cv.KalmanFilter(4, 2)
        kf.transitionMatrix = np.array([[1, 0, 1, 0], [0, 1, 0, 1], [0, 0, 1, 0], [0, 0, 0, 1]],
                                       np.float32)
        kf.measurementMatrix = np.eye(2, 4, dtype=np.float32)
        kf.processNoiseCov = np.eye(4, dtype=np.float32) * 1e-3
        kf.measurementNoiseCov = np.eye(2, dtype=np.float32) * 0.1
        out = []
        for t in range(12):
            out.append(kf.predict())
            out.append(kf.correct(np.array([[2.0 * t], [0.5 * t + np.sin(t)]], np.float32)))
        out += [kf.statePost, kf.errorCovPost, kf.statePre, kf.errorCovPre]
        return out

    both(run, monkeypatch)


@pytest.mark.parametrize("tracker", ["TrackerMOSSE_create", "TrackerKCF_create",
                                     "TrackerCSRT_create", "TrackerMIL_create"])
def test_tracker_init_update(tracker, monkeypatch):
    def run(cv, img):
        frames = _frames()
        t = getattr(cv, tracker)()
        t.init(img(frames[0]), (8, 12, 18, 18))
        return [t.update(img(f)) for f in frames[1:]]

    both(run, monkeypatch)


@pytest.mark.parametrize("norm,cross", [("NORM_HAMMING", False), ("NORM_HAMMING", True),
                                        ("NORM_L2", False), ("NORM_L1", True)])
def test_bfmatcher(norm, cross, monkeypatch):
    rng = np.random.default_rng(5)
    if norm == "NORM_HAMMING":
        q, t = (rng.integers(0, 256, (n, 32), dtype=np.uint8) for n in (20, 25))
    else:
        q, t = (rng.random((n, 16)).astype(np.float32) for n in (20, 25))

    def run(cv, img):
        m = cv.BFMatcher(getattr(cv, norm), crossCheck=cross)
        return m.match(q, t), m.knnMatch(q, t, k=3)

    both(run, monkeypatch)


DETECTORS = ["ORB_create", "SIFT_create", "AKAZE_create", "FastFeatureDetector_create"]


def _detect(detector, frames):
    def run(cv, img):
        d = getattr(cv, detector)()
        if detector.startswith("Fast"):
            return d.detect(img(frames[0]))
        kps, desc = d.detectAndCompute(img(frames[0]), None)
        kps2, desc2 = d.detectAndCompute(img(frames[1]), None)
        matches = cv.BFMatcher(cv.NORM_HAMMING if desc.dtype == np.uint8 else cv.NORM_L2,
                               crossCheck=True).match(desc, desc2) if len(kps) and len(kps2) else []
        return kps, desc, matches
    return run


@pytest.mark.parametrize("detector", DETECTORS)
def test_feature_detectors_on_host_mats_equal_the_reference(detector):
    """A host Mat takes the same host path in both facades: equal."""
    import rustcv_tpu.core as jax_core
    from rustcv_tpu_torch.core import Mat

    frames = _frames(2, 96, 128)
    ref = _detect(detector, frames)(R, lambda a: jax_core.Mat.from_array(a))
    port = _detect(detector, frames)(P, lambda a: Mat.from_array(a, device="cpu"))
    same(ref, port, 0)


def _pts(kps):
    return np.array([kp.pt for kp in kps], np.float64).reshape(-1, 2)


@pytest.mark.parametrize("detector", DETECTORS)
def test_feature_detectors_on_tensors_within_the_references_bars(detector, monkeypatch):
    """A tensor takes the device path (float32), the reference's numpy
    image the host path: FAST exact; ORB positions, descriptors and matches
    exact, angles within 1e-3 rad (tests/test_orb.py); SIFT counts within
    max(3, 15 %) (tests/test_sift.py); AKAZE over 90 % of the keypoints
    shared within 1e-3 px (tests/test_akaze.py)."""
    frames = _frames(2, 96, 128)
    ref = _detect(detector, frames)(R, lambda a: a)
    with as_on_the_card(monkeypatch):
        port = _detect(detector, frames)(P, torch.from_numpy)
    if detector.startswith("Fast"):
        same(ref, port, 0)
        return
    (rk, rd, rm), (pk, pd, pm) = ref, port
    if detector == "ORB_create":
        np.testing.assert_array_equal(_pts(pk), _pts(rk))
        ang = np.array([k.angle for k in pk]) - np.array([k.angle for k in rk])
        assert np.abs((ang + 180) % 360 - 180).max() <= np.degrees(1e-3)
        same(rd, pd, 0)
        same(rm, pm, 0)
    elif detector == "SIFT_create":
        assert abs(len(pk) - len(rk)) <= max(3, 0.15 * len(rk)), (len(pk), len(rk))
        assert pd.dtype == rd.dtype and pd.shape[1:] == rd.shape[1:]
    else:
        a, b = _pts(pk), _pts(rk)
        d = np.abs(a[:, None, :] - b[None, :, :]).max(-1) if len(a) and len(b) else np.zeros((0, 0))
        shared = (d.min(0) <= 1e-3).mean() if d.size else 1.0
        assert shared > 0.9, shared
    assert len(rk) > 0


def test_orb_detect_and_compute_over_eight_frames(monkeypatch):
    """ORB over the clip: positions and descriptors equal, angles within
    1e-3 rad (as above)."""
    frames = _frames(N, 96, 128)
    ref = [R.ORB_create().detectAndCompute(f, None) for f in frames]
    with as_on_the_card(monkeypatch):
        orb = P.ORB_create()
        port = [orb.detectAndCompute(torch.from_numpy(f), None) for f in frames]
    for (rk, rd), (pk, pd) in zip(ref, port):
        np.testing.assert_array_equal(_pts(pk), _pts(rk))
        ang = np.array([k.angle for k in pk]) - np.array([k.angle for k in rk])
        assert np.abs((ang + 180) % 360 - 180).max(initial=0) <= np.degrees(1e-3)
        same(rd, pd, 0)


def test_clahe(monkeypatch):
    g = np.ascontiguousarray(_frames(1)[0][..., 1])

    def run(cv, img):
        c = cv.createCLAHE(clipLimit=4.0, tileGridSize=(4, 4))
        c.setClipLimit(3.0)
        return c.apply(img(g)), c.getClipLimit(), c.getTilesGridSize()

    both(run, monkeypatch)


@pytest.mark.parametrize("matcher", ["StereoBM_create", "StereoSGBM_create"])
def test_stereo(matcher, monkeypatch):
    rng = np.random.default_rng(2)
    right = np.clip(rng.normal(128, 40, (40, 96)), 0, 255).astype(np.uint8)
    left = np.roll(right, 6, axis=1)

    def run(cv, img):
        return getattr(cv, matcher)(16, 7).compute(img(left), img(right))

    both(run, monkeypatch)


def _exposures():
    base = _frames(1, 128, 160)[0].astype(np.float64)
    return [np.clip(base * s, 0, 255).astype(np.uint8) for s in (0.5, 1.0, 1.8)]


def _photo(cv, img):
    stack = _exposures()
    times = np.array([1 / 60, 1 / 30, 1 / 15], np.float32)
    imgs = [img(s) for s in stack]
    deb = cv.createMergeDebevec().process(stack, times)
    mtb = cv.createAlignMTB()
    return (cv.createMergeMertens().process(imgs), deb,
            cv.createMergeRobertson().process(imgs, times),
            cv.createCalibrateDebevec(samples=30).process(stack, times),
            mtb.calculateShift(stack[0], stack[1]), mtb.process(imgs),
            mtb.shiftMat(stack[2], (2, -1)), mtb.computeBitmaps(stack[1]),
            cv.createTonemap(2.2).process(deb), cv.createTonemapReinhard().process(deb),
            cv.createTonemapDrago().process(deb))


def test_photo_factories_on_host_mats_equal_the_reference():
    import rustcv_tpu.core as jax_core
    from rustcv_tpu_torch.core import Mat

    same(_photo(R, jax_core.Mat.from_array), _photo(P, lambda a: Mat.from_array(a, device="cpu")), 0)


def test_photo_factories_on_tensors(monkeypatch):
    """On tensors Mertens takes the device twin (float32): it stays as close
    to the float64 fusion as the reference's own device twin does (a few
    saturated pixels of this stack are ill-conditioned: 0.13 off in JAX,
    0.10 in the port); the rest equal the reference."""
    import jax.numpy as jnp
    import rustcv_tpu.core as jax_core
    import rustcv_tpu.imgproc as jax_ip

    ref = _photo(R, lambda a: a)
    with as_on_the_card(monkeypatch):
        port = _photo(P, torch.from_numpy)
    same(ref[1:], port[1:], 0)
    jax_dev = np.asarray(jax_ip.merge_mertens([jax_core.Mat.from_device(jnp.asarray(a))
                                               for a in _exposures()]))
    assert port[0].dtype == ref[0].dtype and port[0].shape == ref[0].shape
    assert np.abs(port[0] - ref[0]).max() <= np.abs(jax_dev - ref[0]).max()


def test_videowriter_then_videocapture(tmp_path, monkeypatch):
    """The port writes the frames (CPU tensors, encoded on the CPU), the
    reference the same frames (numpy, Pillow): both files read back in
    both facades to the same frames (the port's host JPEG decode is
    libjpeg's), within 0.5 dB PSNR of each other's encode (the encoder's
    tolerance, tests/test_torch_codecs_host.py)."""
    frames = _frames()
    paths = {}
    for name, cv, img in (("port", P, torch.from_numpy), ("ref", R, lambda a: a)):
        paths[name] = str(tmp_path / f"{name}.avi")
        w = cv.VideoWriter(paths[name], cv.VideoWriter_fourcc(*"MJPG"), 30, (W, H))
        assert w.isOpened()
        for f in frames:
            w.write(img(f))
        w.release()

    def read(cv, path):
        cap = cv.VideoCapture(path)
        try:
            assert cap.isOpened()
            size = (cap.get(cv.CAP_PROP_FRAME_WIDTH), cap.get(cv.CAP_PROP_FRAME_HEIGHT))
            out = []
            for _ in range(N):
                ok, f = cap.read()
                assert ok
                out.append(f)
            return size, out
        finally:
            cap.release()

    decoded = {}
    for name, path in paths.items():
        ref = read(R, path)
        port = read(P, path)
        same(ref, port, 0)
        assert ref[0] == (float(W), float(H))
        decoded[name] = ref[1]

    def psnr(a, b):
        return 10 * np.log10(255.0 ** 2 / np.mean((a.astype(float) - b.astype(float)) ** 2))

    for f, p, r in zip(frames, decoded["port"], decoded["ref"]):
        assert psnr(p, f) >= psnr(r, f) - 0.5


def test_videocapture_over_the_simulation_driver():
    """``VideoCapture(0)`` opens the simulation driver in both facades (no
    camera here): frames of the negotiated size, decoded into host arrays."""
    caps = [R.VideoCapture(0), P.VideoCapture(0)]
    try:
        assert [c.isOpened() for c in caps] == [True, True]
        sizes = [(c.get(R.CAP_PROP_FRAME_WIDTH), c.get(R.CAP_PROP_FRAME_HEIGHT)) for c in caps]
        assert sizes[0] == sizes[1]
        for _ in range(2):
            (ok_r, fr), (ok_p, fp) = (c.read() for c in caps)
            assert ok_r and ok_p
            assert type(fp) is np.ndarray and fp.shape == fr.shape == (sizes[0][1], sizes[0][0], 3)
            assert fp.dtype == fr.dtype == np.uint8
        assert caps[1].set(P.CAP_PROP_FRAME_WIDTH, 320) is caps[0].set(R.CAP_PROP_FRAME_WIDTH, 320)
        assert caps[1].get(P.CAP_PROP_FRAME_WIDTH) == caps[0].get(R.CAP_PROP_FRAME_WIDTH)
    finally:
        for c in caps:
            c.release()


def test_small_value_classes(monkeypatch):
    def run(cv, img):
        rr = cv.RotatedRect((20.0, 10.0), (8.0, 4.0), 30.0)
        u = cv.UMat(img(_frames(1)[0]))
        tm = cv.TickMeter()
        tm.start()
        tm.stop()
        return (rr.points(), rr.boundingRect(), u.get(), tm.getCounter(),
                cv.KeyPoint(1, 2, 3).pt, cv.DMatch(1, 2, 0.5).distance,
                sorted([cv.DMatch(0, 0, 2.0), cv.DMatch(0, 1, 1.0)])[0].distance)

    both(run, monkeypatch)
