"""The PyTorch port imports and ticks (the headline, configs 4 and 6
through the zoo, config 6 with its JPEG payloads, the host-staged path,
config 2's hybrid MJPEG decode, NV12 and Bayer frames,
``convert_on_device``, ``run_chained``, ``warm_buckets`` and
``set_resolution``), and its OpenCV-style facade imports and runs the
README loop with ``put_text`` (``prelude``, ``imgproc``, ``highgui``,
``imgcodecs``, ``videoio``), the text overlay, the host codecs and the
PNG dump, the host MJPEG decode and ``mjpeg_backend="host"``, its
``parallel`` (a one-rank mesh engine, the band stencil) and ``utils``
layers and top-level names, and its capture backends (the V4L2 driver,
the native ring behind a ``Camera``), the colour, filter, resize and
corner ops with their ``imgproc`` wrappers and ``RUSTCV_DECODE=xla_fused``,
the second block of ops (arithmetic, histograms, warps, thinning and
diffusion, blending, ``core_ops`` and the host modules) with theirs, and
the features and flow of group 2 (corner responses, FAST, BRIEF/ORB,
SIFT, AKAZE, HOG, LK, Farnebäck, DIS, TV-L1, template matching, the
DFT/DCT, phase correlation, ECC, and the ``canny_cv``, ``color_cv2`` and
``decolor`` copies) with theirs, and group 3 and the segmentation head
of group 4 (the background subtractors, Kalman banks, the trackers,
mean-shift filtering, components, contours, distance transforms, blobs,
k-means, watershed, SLIC, the Voronoi seam) with theirs, and group 4a
(Hough, stereo BM/SGBM, NL-means, the domain-transform and guided filters,
Poisson editing, inpainting, HDR, cascades, and the host modules
``poisson_cv``, ``lsd``, ``scissors``, ``viz``, ``qr``, ``colorchecker``,
``mser`` and ``grabcut`` over the native ``mser.cpp`` and ``maxflow.cpp``)
with theirs, and group 4b, the geometry chain (``calib``, ``calib_ext``,
the chessboard, SB and circle-grid detectors, ArUco, ``threed``, RGB-D
odometry and stitching) with theirs, and the whole cv2 facade
(``rustcv_tpu_torch.cv2``, its core and its later modules and submodules
``aruco``, ``detail``, ``dnn`` and ``fisheye``) on CPU tensors, with jax,
Pillow and the JAX
package ``rustcv_tpu`` absent. The formats of item 8a (every PNG depth and Adam7,
BMP RLE, ASCII PNM, PFM, progressive JPEG), their metadata and Latin-1
text run the same way, and so do the WebP reads of item 8c (a lossy, a
lossless and an animated fixture of ``tests/data/webp``). The font data's
generator (``tools/make_text_data.py``) is no module of the package.

A GPU machine that runs the port need have neither jax nor Pillow, and the
port imports nothing of the JAX package: its core types and its C++ coder
are its own. A subprocess blocks all three imports and runs small CPU
ticks."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

_SCRIPT = textwrap.dedent(
    """
    import sys
    sys.modules["jax"] = None
    sys.modules["PIL"] = None
    sys.modules["rustcv_tpu"] = None
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import rustcv_tpu_torch
    from rustcv_tpu_torch.core import PixelFormat, SimpleConfig
    from rustcv_tpu_torch.capture import SimulationDriver
    from rustcv_tpu_torch.runtime import MultiStreamEngine
    import rustcv_tpu_torch.ops.kernels
    import rustcv_tpu_torch.ops.jpeg_encode
    import rustcv_tpu_torch.ops.resize
    import rustcv_tpu_torch.probes.mosaic_shuffle
    import rustcv_tpu_torch.probes.host_gather_ab
    import rustcv_tpu_torch.probes.chain_profile
    import rustcv_tpu_torch.probes.template_rounding
    from rustcv_tpu_torch import native

    eng = MultiStreamEngine(
        SimulationDriver(device_count=2, paced=False), 2,
        SimpleConfig(width=64, height=48, fps=60, pixel_format=PixelFormat.YUYV),
        filter="blur_sobel", overlay=True, device_sim=True, device="cpu",
    )
    res = eng.tick(rects=np.array([[4, 4, 20, 10]] * 2, np.int32),
                   rect_colors=np.array([[0, 255, 0]] * 2, np.uint8), block=True)
    assert res.numpy("bgr").shape == (2, 48, 64, 3)
    assert res.numpy("filtered").shape == (2, 48, 64)
    import dataclasses
    from rustcv_tpu_torch.models import get_model
    model = dataclasses.replace(get_model("config4_harris_1080p"), width=64, height=48)
    for filt in ("harris", "harris_points", "canny"):
        res = model.engine(device="cpu", filter=filt).tick(block=True)
        assert res.outputs["_sync"].numel() == 1
    model = dataclasses.replace(get_model("config6_transcode"), width=64, height=48,
                                n_streams=2, resize_to=(32, 24))
    eng = model.engine(device="cpu")
    res = eng.tick(block=True)
    for i, payload in enumerate(eng.encode_payloads(res)):
        info, coeffs, qts = native.jpeg_entropy_decode(payload)
        assert (info["width"], info["height"]) == (32, 24)
        assert (coeffs[0].reshape(-1, 64) == res.outputs["enc_y"][i].numpy()).all()
    eng.close()
    # the host-staged path and config 2 (hybrid MJPEG: frames from the
    # port's encoder, entropy-decoded by the port's coder)
    eng = MultiStreamEngine(
        SimulationDriver(device_count=2, paced=False, n_unique_frames=2), 2,
        SimpleConfig(width=64, height=48, fps=60, pixel_format=PixelFormat.YUYV),
        filter="blur_sobel", overlay=True, device_sim=False, device="cpu",
    )
    stats = eng.run(3, warmup=1, measure_latency=False)
    assert stats.frames == 6 and stats.dropped_frames == 0 and stats.host_gather_ms > 0
    eng.close()
    model = dataclasses.replace(get_model("config2_mjpeg_resize"), width=64, height=48,
                                n_streams=2, resize_to=(32, 24))
    eng = model.engine(device="cpu")
    res = eng.tick(block=True)
    assert res.numpy("bgr").shape == (2, 24, 32, 3) and eng.spec.mjpeg_packed
    from rustcv_tpu_torch.ops.jpeg_tpu import decode_jpeg_numpy
    from rustcv_tpu_torch.capture.simulation import synth_raw
    assert decode_jpeg_numpy(synth_raw(64, 48, PixelFormat.MJPEG, 0)).shape == (48, 64, 3)
    eng.close()
    # every other wire format (device-sim NV12, a host-staged Bayer sensor),
    # convert_on_device, run_chained, warm_buckets and set_resolution
    from rustcv_tpu_torch.ops import decode
    from rustcv_tpu_torch.runtime import buckets
    assert buckets.bucket_for(1900, 1000) == (1920, 1080)
    for fmt, device_sim in ((PixelFormat.NV12, True), (PixelFormat.BAYER_RGGB, False)):
        eng = MultiStreamEngine(
            SimulationDriver(device_count=2, paced=False), 2,
            SimpleConfig(width=64, height=48, fps=60, pixel_format=fmt),
            filter="blur_sobel", overlay=True, device_sim=device_sim, device="cpu",
        )
        assert eng.tick(block=True).numpy("bgr").shape == (2, 48, 64, 3)
        assert eng.warm_buckets(buckets=[(64, 48), (160, 120)]) == 2
        eng.set_resolution(160, 120)
        assert eng.tick(block=True).numpy("filtered").shape == (2, 120, 160)
        if device_sim:
            stats = eng.run_chained(4, chain=2)
            assert stats.ticks == 4 and eng.export_state()["sequences"] == [8, 8]
        eng.close()
    source = SimulationDriver(paced=False).open_simple(
        "sim:0", SimpleConfig(width=64, height=48, pixel_format=PixelFormat.UYVY))[0]
    source.start()
    raw = torch.from_numpy(source.next_frame().data.reshape(-1))
    assert decode.convert_on_device(raw, PixelFormat.UYVY, 64, 48).shape == (48, 64, 3)
    bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "PIL", "rustcv_tpu")
           if sys.modules[m] is not None]
    assert not bad, bad
    print("OK")
    """
)

_FACADE_SCRIPT = textwrap.dedent(
    """
    import sys
    sys.modules["jax"] = None
    sys.modules["PIL"] = None
    sys.modules["rustcv_tpu"] = None
    import torch
    torch.set_num_threads(1)
    from rustcv_tpu_torch.prelude import Camera, Mat, PixelFormat, SimpleConfig, TickMeter, VideoCapture, VideoWriter
    from rustcv_tpu_torch import highgui, imgcodecs, imgproc, videoio
    from rustcv_tpu_torch.imgproc import Point, Rect, Scalar
    from rustcv_tpu_torch.capture import SimulationDriver
    assert not torch.cuda.is_initialized()

    # The README loop: the host decode, then the device decode on the CPU,
    # each reading 3 frames until Esc.
    for kwargs, mat in (({}, Mat(device="cpu")), ({"decode_on_device": True, "device": "cpu"}, Mat(device="cpu"))):
        cap = VideoCapture(0, SimulationDriver(paced=False), **kwargs)
        try:
            assert cap.set_resolution(1280, 720)
            tm, shown = TickMeter(), 0
            while cap.read(mat):
                tm.start()
                imgproc.rectangle(mat, Rect(60, 60, 200, 150), Scalar(0, 255, 0), 2)
                imgproc.put_text(mat, f"FPS: {tm.get_fps():.1f}", Point(10, 30), 1.0,
                                 Scalar(0, 255, 255))
                tm.stop()
                highgui.imshow("demo", mat)
                shown += 1
                if shown == 3:
                    highgui.push_key(highgui.KEY_ESC)
                if highgui.wait_key(1) == highgui.KEY_ESC:
                    break
        finally:
            cap.release()
        assert shown == 3 and tm.get_counter() == 3 and mat.shape == (720, 1280, 3)
        assert (highgui.get_window_frame("demo")[60, 60:260] == (0, 255, 0)).all()
    assert imgcodecs.imdecode(imgcodecs.imencode(".jpg", mat), device="cpu").shape == (720, 1280, 3)
    assert (imgcodecs.imdecode(imgcodecs.imencode(".png", mat), device="cpu").to_numpy()
            == mat.to_numpy()).all()
    import os, tempfile
    from rustcv_tpu_torch.ops import text
    from rustcv_tpu_torch.imgcodecs import host
    with tempfile.TemporaryDirectory() as d:
        os.environ["RUSTCV_TPU_DISPLAY_DIR"] = d
        highgui.imshow("demo", mat)
        del os.environ["RUSTCV_TPU_DISPLAY_DIR"]
        back = imgcodecs.imread(os.path.join(d, "demo.png"), device="cpu")
        assert (back.to_numpy() == mat.to_numpy()).all()
        for ext in ("bmp", "ppm"):
            assert imgcodecs.imwrite(os.path.join(d, "x." + ext), mat)
    assert text.rasterize("FPS: 42.0", 1.0)[0].shape == (24, 128)
    from rustcv_tpu_torch.core import PixelFormat
    from rustcv_tpu_torch.runtime import MultiStreamEngine
    eng = MultiStreamEngine(SimulationDriver(device_count=2, paced=False), 2,
                            SimpleConfig(width=64, height=48, fps=30, pixel_format=PixelFormat.MJPEG),
                            mjpeg_backend="host", device="cpu")
    assert eng.tick(block=True, text=["a", "b"]).numpy("bgr").shape == (2, 48, 64, 3)
    eng.close()
    assert isinstance(videoio.create_driver("simulation"), SimulationDriver)
    bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "PIL", "rustcv_tpu")
           if sys.modules[m] is not None]
    assert not bad, bad
    print("OK")
    """
)


_PARALLEL_SCRIPT = textwrap.dedent(
    """
    import sys, tempfile
    sys.modules["jax"] = None
    sys.modules["PIL"] = None
    sys.modules["rustcv_tpu"] = None
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import rustcv_tpu_torch
    from rustcv_tpu_torch import Mat, TickMeter, __version__
    assert __version__ == "0.2.0" and Mat is rustcv_tpu_torch.core.Mat and TickMeter().get_counter() == 0
    from rustcv_tpu_torch import parallel, utils
    import rustcv_tpu_torch.parallel.launch, rustcv_tpu_torch.parallel.rehearse_2d
    import rustcv_tpu_torch.probes.engine_ab, rustcv_tpu_torch.probes.mesh_fleet
    from rustcv_tpu_torch.capture import SimulationDriver
    from rustcv_tpu_torch.core import PixelFormat, SimpleConfig
    from rustcv_tpu_torch.runtime import MultiStreamEngine
    mesh = parallel.stream_mesh("cpu")
    eng = MultiStreamEngine(
        SimulationDriver(device_count=2, paced=False), 2,
        SimpleConfig(width=64, height=48, fps=60, pixel_format=PixelFormat.YUYV),
        filter="blur_sobel", overlay=True, device_sim=True, mesh=mesh, device="cpu")
    with tempfile.TemporaryDirectory() as d, utils.profile_trace(d) as path:
        res = eng.tick(block=True)
    assert parallel.gather_streams(res.outputs["filtered"], mesh).shape == (2, 48, 64)
    gray = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (1, 48, 64), np.uint8))
    rows = parallel.stream_mesh("cpu", axis="rows")
    assert parallel.blur_sobel_mag_spatial(gray, rows).shape == (1, 48, 64)
    mask = np.ones((2, 4, 4), bool)
    assert int(parallel.corner_counts_psum(parallel.shard_batch(mask, mesh), mesh)) == 32
    eng.close()
    stats = utils.CaptureStats()
    stats.record(0, 1.0)
    assert utils.get_logger().name == "rustcv_tpu_torch" and stats.report()["frames"] == 1
    bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "PIL", "rustcv_tpu")
           if sys.modules[m] is not None]
    assert not bad, bad
    print("OK")
    """
)


_SLICE_SCRIPT = textwrap.dedent(
    """
    import os, sys
    sys.modules["jax"] = None
    sys.modules["PIL"] = None
    sys.modules["rustcv_tpu"] = None
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from rustcv_tpu_torch import imgproc, native, videoio
    from rustcv_tpu_torch.capture import Camera, SimulationDriver
    from rustcv_tpu_torch.capture.native_source import NativeSimulationSource
    from rustcv_tpu_torch.capture.v4l2 import V4L2Driver, enumerate_modes, list_video_devices
    from rustcv_tpu_torch.core import CameraError, Mat, PixelFormat, ResolvedConfig, SimpleConfig
    from rustcv_tpu_torch.ops import color, features, filters, resize
    from rustcv_tpu_torch.runtime import MultiStreamEngine

    assert isinstance(videoio.create_driver("v4l2"), V4L2Driver)
    try:
        enumerate_modes("/dev/video255")
        raise AssertionError("no error")
    except CameraError:
        pass
    if not list_video_devices():
        assert videoio.default_backend() == "simulation"
    src = NativeSimulationSource(ResolvedConfig(64, 48, 120, PixelFormat.YUYV, 3), paced=False)
    cam = Camera(src, None)
    mat = Mat(device="cpu")
    cam.read_decoded(mat)
    assert mat.shape == (48, 64, 3) and cam.read_decoded_device("cpu").shape == (48, 64, 3)
    cam.close()
    src.close()
    img = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (24, 35, 3), np.uint8))
    for fn in (color.bgr_to_hsv, color.bgr_to_lab, color.bgr_to_ycrcb, filters.pyr_up,
               lambda x: filters.median_u8(x, 5), lambda x: filters.stack_blur_u8(x, 5),
               lambda x: resize.resize_bicubic(x, 17, 9), lambda x: resize.resize_area(x, 7, 8)):
        assert fn(img).dtype == torch.uint8
    gray = color.bgr_to_gray(img)
    assert features.corner_sub_pix(gray, [[17.0, 12.0]], win=5).shape == (1, 2)
    m = Mat.from_array(img.numpy(), device="cpu")
    for out in (imgproc.cvt_hsv(m), imgproc.resize(m, 9, 7, "cubic"), imgproc.median_blur(m, 5),
                imgproc.gaussian_blur(m, 3), imgproc.morphology_ex(m, "open")):
        assert isinstance(out, Mat)
    assert imgproc.integral(m).shape == (25, 36) and imgproc.moments(m)["m00"] > 0
    os.environ["RUSTCV_DECODE"] = "xla_fused"
    eng = MultiStreamEngine(
        SimulationDriver(device_count=2, paced=False), 2,
        SimpleConfig(width=64, height=48, fps=60, pixel_format=PixelFormat.YUYV),
        filter="blur_sobel", overlay=True, device_sim=True, device="cpu")
    assert eng.tick(block=True).numpy("bgr").shape == (2, 48, 64, 3)
    eng.close()
    bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "PIL", "rustcv_tpu")
           if sys.modules[m] is not None]
    assert not bad, bad
    print("OK")
    """
)


_BLOCK2_SCRIPT = textwrap.dedent(
    """
    import importlib, sys
    sys.modules["jax"] = None
    sys.modules["PIL"] = None
    sys.modules["rustcv_tpu"] = None
    import numpy as np
    import torch
    torch.set_num_threads(1)
    for mod in ("arith", "hist", "warp", "morphx", "blend", "core_ops", "barcode", "draw_cv",
                "emd", "epipolar", "geometry", "knn_index", "octree", "resize_cv", "shape",
                "subdiv", "tsdf"):
        importlib.import_module("rustcv_tpu_torch.ops." + mod)
    from rustcv_tpu_torch import imgproc
    from rustcv_tpu_torch.core import Mat

    img = np.random.default_rng(0).integers(0, 256, (24, 35, 3), np.uint8)
    for m in (Mat.from_array(img, device="cpu"), Mat.from_device(torch.from_numpy(img))):
        g = imgproc.cvt_gray(m)
        outs = [imgproc.add(m, m), imgproc.add_weighted(m, 0.3, m, 0.7), imgproc.normalize(m),
                imgproc.lut(m, np.arange(256)[::-1]), imgproc.apply_color_map(g),
                imgproc.equalize_hist(g), imgproc.clahe(g, 40, (4, 4)),
                imgproc.warp_affine(m, imgproc.get_rotation_matrix_2d((17, 12), 30), (35, 24)),
                imgproc.warp_perspective(m, np.eye(3), (35, 24)),
                imgproc.warp_polar(m, (17, 12), 10.0, (20, 30)), imgproc.thinning(g),
                imgproc.anisotropic_diffusion(m, niters=2), imgproc.flip(m, 1)]
        assert all(isinstance(o, Mat) and o.is_on_device == m.is_on_device for o in outs)
        assert imgproc.calc_hist(m).sum() == 24 * 35
        assert imgproc.norm(m, "l1") > 0 and imgproc.count_non_zero(g) > 0
    t = torch.from_numpy(img).float()
    assert imgproc.magnitude(t[..., 0], t[..., 1]).shape == (24, 35)
    assert imgproc.multi_band_blend(img, img, np.ones((24, 35)), 3).shape == (24, 35, 3)
    assert imgproc.RNG(7).randu((2, 3), 0, 10, np.int32).shape == (2, 3)
    assert imgproc.detect_barcodes(
        importlib.import_module("rustcv_tpu_torch.ops.barcode").draw_barcode(
            imgproc.encode_ean13("400638133393"))) == ["4006381333931"]
    bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "PIL", "rustcv_tpu")
           if sys.modules[m] is not None]
    assert not bad, bad
    print("OK")
    """
)


_GROUP2_SCRIPT = textwrap.dedent(
    """
    import importlib, sys
    sys.modules["jax"] = None
    sys.modules["PIL"] = None
    sys.modules["rustcv_tpu"] = None
    import numpy as np
    import torch
    torch.set_num_threads(1)
    for mod in ("transform", "registration", "template", "corner", "fast", "brief", "optflow",
                "farneback", "disflow", "varref", "tvl1", "ecc", "hog", "sift", "akaze",
                "asift", "rotwarp", "canny_cv", "color_cv2", "decolor", "tensors"):
        importlib.import_module("rustcv_tpu_torch.ops." + mod)
    from rustcv_tpu_torch import imgproc
    from rustcv_tpu_torch.core import Mat

    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (48, 64), np.uint8)
    shifted = np.roll(img, (1, 2), (0, 1))
    for mk in (lambda a: Mat.from_array(a, device="cpu"),
               lambda a: Mat.from_device(torch.from_numpy(a))):
        m, m2 = mk(img), mk(shifted)
        assert imgproc.fast_corners(m, max_corners=16).shape[1] == 2
        pts, ang, desc, valid = imgproc.orb_features(m, max_keypoints=16)
        assert desc.dtype == np.uint32 and desc.shape == (16, 8)
        nxt, st = imgproc.calc_optical_flow_pyr_lk(m, m2, [[32.0, 24.0]], win=9, levels=1)
        assert nxt.shape == (1, 2)
        assert imgproc.calc_optical_flow_farneback(m, m2).shape == (48, 64, 2)
        assert imgproc.calc_optical_flow_dis(m, m2, refine=True).shape == (48, 64, 2)
        assert imgproc.match_template(m, mk(img[8:16, 8:20])).shape == (41, 53)
        assert imgproc.hog_descriptor(m).shape == (5, 7, 36)
        assert abs(imgproc.phase_correlate(m, m2, window=False)[0][0] - 2) < 1e-3
        assert imgproc.denoise_tvl1([m, m2], niters=2).shape[:2] == (48, 64)
    t = torch.from_numpy(img)
    assert imgproc.dct(t).shape == (48, 64) and imgproc.spatial_gradient(t)[0].dtype == torch.int32
    rho, warp = imgproc.find_transform_ecc(t, torch.from_numpy(shifted), "translation",
                                           iterations=5, backend="device")
    assert warp.shape == (2, 3)
    assert imgproc.decolor(rng.integers(0, 256, (24, 32, 3), np.uint8))[0].shape == (24, 32)
    bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "PIL", "rustcv_tpu")
           if sys.modules[m] is not None]
    assert not bad, bad
    print("OK")
    """
)


_GROUP3_SCRIPT = textwrap.dedent(
    """
    import importlib, sys
    sys.modules["jax"] = None
    sys.modules["PIL"] = None
    sys.modules["rustcv_tpu"] = None
    import numpy as np
    import torch
    torch.set_num_threads(1)
    for mod in ("bgsub", "knn_bgsub", "kalman", "tracker", "kcf", "csrt", "mil", "dsst_scale",
                "meanshift_filter", "ccl", "blob", "kmeans", "watershed", "slic", "blend"):
        importlib.import_module("rustcv_tpu_torch.ops." + mod)
    from rustcv_tpu_torch import imgproc
    from rustcv_tpu_torch.core import Mat
    from rustcv_tpu_torch.ops import csrt, kalman, kcf, mil, tracker

    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (48, 64), np.uint8)
    bgr = rng.integers(0, 256, (48, 64, 3), np.uint8)
    for sub in (imgproc.create_background_subtractor_mog2(detect_shadows=True),
                imgproc.create_background_subtractor_knn()):
        assert sub.apply(Mat.from_array(bgr, device="cpu")).shape == (48, 64)
        assert sub.apply(torch.from_numpy(bgr)).shape == (48, 64)
    for mod in (tracker, kcf, csrt):
        st = mod.init(torch.from_numpy(img), [(10, 10, 16, 16), (30, 20, 16, 16)])
        st, ok, score = mod.step(st, torch.from_numpy(img))
        assert ok.shape == (2,) and bool(ok.all())
    t = mil.TrackerMIL()
    t.init(img, (10, 10, 16, 16))
    assert t.update(img)[1][2:] == (16, 16)
    xs, xf, pf = kalman.filter_scan(torch.zeros(3, 2), torch.eye(2).repeat(3, 1, 1),
                                    torch.ones(4, 3, 1), torch.eye(2), torch.eye(1, 2),
                                    torch.eye(2), torch.eye(1))
    assert xs.shape == (4, 3, 2)
    mask = (img > 128).astype(np.uint8)
    for mk in (lambda a: Mat.from_array(a, device="cpu"),
               lambda a: Mat.from_device(torch.from_numpy(a))):
        n, lab = imgproc.connected_components(mk(mask))
        assert lab.shape == (48, 64) and n == lab.max()
        assert len(imgproc.find_contours(mk(mask))) == n
        assert imgproc.distance_transform(mk(mask)).dtype == np.int32
        assert imgproc.pyr_mean_shift_filtering(mk(bgr[:16, :16].copy()), sp=2,
                                                max_iter=1).shape == (16, 16, 3)
        assert imgproc.kmeans_quantize(mk(bgr), k=4)[1].shape == (4, 3)
        markers = np.zeros((48, 64), np.int32)
        markers[5, 5], markers[40, 60] = 1, 2
        assert set(np.unique(imgproc.watershed(mk(img), markers))) <= {-1, 1, 2}
    assert imgproc.detect_blobs(Mat.from_array(img, device="cpu")).shape[1] == 3
    assert imgproc.slic_superpixels(torch.from_numpy(bgr), region_size=16)[0].shape == (48, 64)
    assert imgproc.voronoi_seam(mask, 1 - mask)[0].dtype == bool
    bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "PIL", "rustcv_tpu")
           if sys.modules[m] is not None]
    assert not bad, bad
    print("OK")
    """
)


_GROUP4A_SCRIPT = textwrap.dedent(
    """
    import importlib, sys
    sys.modules["jax"] = None
    sys.modules["PIL"] = None
    sys.modules["rustcv_tpu"] = None
    import numpy as np
    import torch
    torch.set_num_threads(1)
    for mod in ("hough", "ghough", "stereo", "sgbm", "nlmeans", "dtfilter", "poisson",
                "inpaint", "hdr", "cascade", "poisson_cv", "lsd", "scissors", "viz", "qr",
                "colorchecker", "mser", "grabcut"):
        importlib.import_module("rustcv_tpu_torch.ops." + mod)
    from rustcv_tpu_torch import imgproc, native
    from rustcv_tpu_torch.core import Mat
    from rustcv_tpu_torch.ops import cascade, ghough, qr

    rng = np.random.default_rng(0)
    gray = rng.integers(0, 256, (48, 64), np.uint8)
    gray[10:30, 20:44] = 230
    bgr = np.repeat(gray[..., None], 3, -1).copy()
    mask = np.zeros((48, 64), bool)
    mask[20:26, 10:50] = True
    for mk in (lambda a: Mat.from_array(a, device="cpu"),
               lambda a: Mat.from_device(torch.from_numpy(a.copy()))):
        edges = imgproc.canny(mk(bgr))
        assert imgproc.hough_lines(edges, threshold=10).shape[1] == 2
        assert imgproc.hough_lines_p(edges, threshold=10).shape[1] == 4
        assert imgproc.hough_circles(mk(gray), min_radius=5, max_radius=12).shape[1] == 3
        d, v = imgproc.stereo_bm(mk(gray), mk(gray), 16, 9)
        assert d.shape == v.shape == (48, 64)
        d, v = imgproc.stereo_sgbm(mk(gray), mk(gray), num_disparities=16, num_dirs=4)
        assert d.dtype == np.float32
        assert imgproc.fast_nl_means_denoising(mk(gray), 10.0, 3, 7).shape == (48, 64, 1)
        assert imgproc.fast_nl_means_denoising_colored(mk(bgr), 10, 10, 3, 7).shape == (48, 64, 3)
        assert imgproc.guided_filter(mk(gray), mk(bgr), 4).shape == (48, 64, 3)
        for name in ("edge_preserving_filter", "detail_enhance", "stylization"):
            assert getattr(imgproc, name)(mk(bgr)).shape == (48, 64, 3)
        assert imgproc.pencil_sketch(mk(bgr))[0].shape == (48, 64, 1)
        out = imgproc.seamless_clone(mk(bgr[:16, :16].copy()), mk(bgr), np.ones((16, 16), bool),
                                     (32, 24))
        assert out.shape == (48, 64, 3)
        assert imgproc.inpaint(mk(bgr), mask, method="diffusion").shape == (48, 64, 3)
        assert imgproc.merge_mertens([mk(bgr), mk(bgr // 2)]).dtype == np.float32
        assert imgproc.fast_nl_means_denoising_multi([mk(gray)] * 3, 1, 3, 10.0, 3, 7).shape == (48, 64)
    assert imgproc.inpaint(Mat.from_array(bgr, device="cpu"), mask).shape == (48, 64, 3)
    assert imgproc.color_change(Mat.from_array(bgr, device="cpu"), mask).shape == (48, 64, 3)
    table = ghough.build_r_table(gray[5:37, 10:42])
    assert ghough.ghough_accumulate(torch.from_numpy(gray), table).dtype == torch.int32
    pos = rng.integers(90, 130, (6, 24, 24)).astype(np.uint8)
    neg = rng.integers(0, 256, (12, 24, 24)).astype(np.uint8)
    model = cascade.train_cascade(pos, neg, n_stages=1, n_stumps=2, stride=8)
    assert cascade.score_windows_device(torch.from_numpy(gray), model)[0].shape == (25, 41)
    code = qr.draw(qr.encode("ok", 1, "L", 0), 4)
    assert imgproc.qr_detect_and_decode(Mat.from_array(code, device="cpu"))[0] == "ok"
    assert len(native.mser_triples(gray, 5, 20, 2000, 0.25, 0.2)) >= 0
    assert len(imgproc.detect_mser_regions(gray)[0]) >= 1
    assert imgproc.detect_line_segments(gray, length_threshold=10).shape[1] == 4
    assert set(np.unique(imgproc.grab_cut(Mat.from_array(bgr, device="cpu"),
                                          rect=(16, 8, 32, 24), iter_count=1))) <= {0, 2, 3}
    z = np.zeros((4, 5), np.int64)
    assert native.maxflow_grid(z, z, z, z, z, z)[1].shape == (4, 5)
    assert imgproc.draw_marker(bgr, (20, 20), (0, 255, 0)).shape == (48, 64, 3)
    bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "PIL", "rustcv_tpu")
           if sys.modules[m] is not None]
    assert not bad, bad
    print("OK")
    """
)


_GROUP4B_SCRIPT = textwrap.dedent(
    """
    import importlib, os, sys, tempfile
    sys.modules["jax"] = None
    sys.modules["PIL"] = None
    sys.modules["rustcv_tpu"] = None
    import numpy as np
    import torch
    torch.set_num_threads(1)
    for mod in ("calib", "calib_ext", "chessboard", "chessboard_sb", "circles_grid", "threed",
                "aruco", "odometry", "stitch"):
        importlib.import_module("rustcv_tpu_torch.ops." + mod)
    from rustcv_tpu_torch import imgproc
    from rustcv_tpu_torch.core import Mat
    from rustcv_tpu_torch.ops import aruco, calib, chessboard, chessboard_sb, stitch, threed

    k = np.array([[60.0, 0, 32], [0, 60.0, 24], [0, 0, 1]])
    dist = np.array([-0.1, 0.01, 0.0, 0.0, 0.0])
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (48, 64, 3), np.uint8)
    for m in (Mat.from_array(img, device="cpu"), Mat.from_device(torch.from_numpy(img.copy()))):
        out = imgproc.undistort(m, k, dist)
        assert out.shape == (48, 64, 3) and out.is_on_device == m.is_on_device
    assert calib.fisheye_undistort(torch.from_numpy(img), k, dist[:4]).shape == (48, 64, 3)
    obj = np.stack(np.meshgrid(np.arange(4.0), np.arange(3.0)), -1).reshape(-1, 2) * 0.1
    obj = np.concatenate([obj, np.zeros((12, 1))], 1)
    px = calib.project_points(obj, np.array([0.1, -0.1, 0.0]), np.array([0.0, 0.0, 1.0]), k)
    rv, tv = imgproc.solve_pnp(obj, px, k)
    assert np.abs(tv - [0.0, 0.0, 1.0]).max() < 1e-6
    board = np.kron((np.indices((7, 10)).sum(0) % 2) * 160.0 + 40, np.ones((20, 20)))
    board = np.pad(board, 20, constant_values=200.0)
    for _ in range(2):  # two 3x3 box blurs: the SB likelihood needs soft edges
        p = np.pad(board, 1, mode="edge")
        board = sum(p[dy:dy + 180, dx:dx + 240] for dy in range(3) for dx in range(3)) / 9.0
    board = board.astype(np.uint8)
    for fn in (chessboard.find_chessboard_corners, chessboard_sb.find_chessboard_corners_sb):
        found, corners = fn(torch.from_numpy(board), (9, 6))
        assert found and corners.shape == (54, 2)
    assert imgproc.find_chessboard_corners(Mat.from_array(board, device="cpu"), (9, 6))[0]
    dic = aruco.Dictionary.generate(8, 4, seed=7)
    scene = np.full((96, 96), 200, np.uint8)
    scene[24:72, 24:72] = aruco.draw_marker(dic, 3, 8)
    assert list(imgproc.detect_aruco_markers(Mat.from_array(scene, device="cpu"), dic)[1]) == [3]
    assert imgproc.find_circles_grid(np.full((60, 80), 220, np.uint8), (3, 2))[0] is False
    depth = np.full((24, 32), 2.0, np.float32)
    pts = imgproc.depth_to_3d(depth, k)
    assert imgproc.rgbd_normals(torch.from_numpy(pts)).shape == (24, 32, 3)
    verts = np.array([[2, 2, 1], [30, 3, 1], [10, 20, 1]], np.float32)
    color, zbuf = threed.triangle_rasterize(torch.from_numpy(verts), np.array([[0, 1, 2]]),
                                            verts * 50, 32, 24)
    assert bool(torch.isfinite(zbuf).any())
    assert imgproc.rgbd_odometry(depth.astype(np.float64), depth.astype(np.float64), k,
                                 levels=1, iters=1)[0] in (True, False)
    with tempfile.TemporaryDirectory() as d:
        imgproc.save_point_cloud(os.path.join(d, "c.ply"), pts.reshape(-1, 3)[:5])
        assert imgproc.load_point_cloud(os.path.join(d, "c.ply")).shape == (5, 3)
    try:
        stitch.stitch([img[..., 0], img[..., 1]])
    except stitch.StitchError:
        pass
    bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "PIL", "rustcv_tpu")
           if sys.modules[m] is not None]
    assert not bad, bad
    print("OK")
    """
)


_CV2_SCRIPT = textwrap.dedent(
    """
    import os
    import sys
    import tempfile
    sys.modules["jax"] = None
    sys.modules["PIL"] = None
    sys.modules["rustcv_tpu"] = None
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import rustcv_tpu_torch.cv2 as cv2
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
    t = torch.from_numpy(img.copy())
    gray = cv2.cvtColor(t, cv2.COLOR_BGR2GRAY)
    assert gray.shape == (48, 64) and isinstance(gray, np.ndarray)
    g = torch.from_numpy(gray)
    assert cv2.GaussianBlur(t, (5, 5), 0).shape == (48, 64, 3)
    assert cv2.Canny(g, 50, 150).dtype == np.uint8
    assert cv2.cornerHarris(g, 2, 3, 0.04).dtype == np.float32
    assert cv2.goodFeaturesToTrack(g, 20, 0.01, 5).shape[1:] == (1, 2)
    canvas = img.copy()
    cv2.rectangle(canvas, (2, 2), (30, 20), (0, 255, 0), 2)
    assert (canvas[2, 2:30] == (0, 255, 0)).all()
    ok, buf = cv2.imencode(".png", t)
    assert ok and (cv2.imdecode(buf, 1) == img).all()
    ok, buf = cv2.imencode(".jpg", t)
    assert ok and cv2.imdecode(buf, 1).shape == img.shape
    fs = cv2.FileStorage(".json", cv2.FILE_STORAGE_WRITE | cv2.FILE_STORAGE_MEMORY)
    fs.write("m", np.eye(3, dtype=np.float32))
    text = fs.releaseAndGetString()
    back = cv2.FileStorage(text, cv2.FILE_STORAGE_READ | cv2.FILE_STORAGE_MEMORY)
    assert (back.getNode("m").mat() == np.eye(3)).all()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "c.avi")
        w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 30, (64, 48))
        for _ in range(2):
            w.write(t)
        w.release()
        cap = cv2.VideoCapture(path)
        assert cap.isOpened() and cap.get(cv2.CAP_PROP_FRAME_WIDTH) == 64
        ok, frame = cap.read()
        cap.release()
        assert ok and frame.shape == (48, 64, 3)
    assert "torch" in cv2.getBuildInformation()
    assert cv2.aruco.__name__ == "rustcv_tpu_torch.cv2.aruco"  # item 7b is ported
    bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "PIL", "rustcv_tpu")
           if sys.modules[m] is not None]
    assert not bad, bad
    print("OK")
    """
)


_CV2_LATER_SCRIPT = textwrap.dedent(
    """
    import os
    import sys
    import tempfile
    sys.modules["jax"] = None
    sys.modules["PIL"] = None
    sys.modules["rustcv_tpu"] = None
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import rustcv_tpu_torch.cv2 as cv2
    from rustcv_tpu_torch.cv2 import aruco, detail, dnn, fisheye
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
    t = torch.from_numpy(img.copy())
    g = torch.from_numpy(cv2.cvtColor(img, cv2.COLOR_BGR2GRAY))
    kps = cv2.GFTTDetector_create(20, 0.01, 3).detect(g)
    assert kps and all(isinstance(k, cv2.KeyPoint) for k in kps)
    pts, q = cv2.goodFeaturesToTrackWithQuality(g, 20, 0.01, 3, useHarrisDetector=True)
    assert len(pts) == len(q) and q.dtype == np.float32
    flow = cv2.FarnebackOpticalFlow_create().calc(g, torch.roll(g, 1, 1), None)
    assert flow.shape == (48, 64, 2) and isinstance(flow, np.ndarray)
    K = np.array([[40.0, 0, 32], [0, 40.0, 24], [0, 0, 1]])
    assert fisheye.undistortImage(t, K, np.zeros(4)).shape == (48, 64, 3)
    assert dnn.blobFromImage(t, 1 / 255, (32, 32), swapRB=True).shape == (1, 3, 32, 32)
    d = aruco.getPredefinedDictionary(cv2.aruco.DICT_4X4_50)
    page = np.full((96, 96), 255, np.uint8)
    page[16:80, 16:80] = aruco.generateImageMarker(d, 3, 64)
    corners, ids, _ = aruco.ArucoDetector(d).detectMarkers(page)
    assert ids is not None and ids.ravel().tolist() == [3]
    blender = detail.FeatherBlender()
    blender.prepare((0, 0, 64, 48))
    blender.feed(img, np.full((48, 64), 255, np.uint8), (0, 0))
    out, mask = blender.blend()
    assert out.dtype == np.int16 and mask.shape == (48, 64)
    canvas = img.copy()
    cv2.addText(canvas, "7b", (2, 20), "DejaVu", 14, (0, 255, 0))
    assert (canvas != img).any()
    ok, buf = cv2.imencodemulti(".tiff", [img, img[::-1]])
    ok2, pages = cv2.imdecodemulti(buf)
    assert ok and ok2 and len(pages) == 2 and np.array_equal(pages[1], img[::-1])
    path = os.path.join(tempfile.mkdtemp(), "a.webp")  # a WebP write (item 8c-ii)
    assert cv2.imwritemulti(path, [img]) and cv2.imcount(path) == 1
    assert cv2.imread(path).shape == img.shape
    bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "PIL", "rustcv_tpu")
           if sys.modules[m] is not None]
    assert not bad, bad
    print("OK")
    """
)


def test_cv2_later_modules_run_without_jax_or_pil():
    """The rest of the facade (item 7b) imports and runs on CPU tensors with
    jax, Pillow and the JAX package blocked: its submodules ``aruco``,
    ``detail``, ``dnn`` and ``fisheye``, the GFTT and Farnebäck objects,
    ``goodFeaturesToTrackWithQuality`` on both Harris routes, ``addText``,
    a multi-page TIFF encoded and decoded (item 8b), and a WebP written
    (item 8c-ii)."""
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-c", _CV2_LATER_SCRIPT], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")


def test_cv2_facade_runs_without_jax_or_pil():
    """``import rustcv_tpu_torch.cv2`` and a cv2 user's calls on CPU tensors
    (colour, blur, edges, both Harris routes, a draw on a numpy image, PNG
    and JPEG codecs, FileStorage, an AVI written and read back)."""
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-c", _CV2_SCRIPT], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")

def test_group4b_geometry_runs_without_jax_or_pil():
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-c", _GROUP4B_SCRIPT], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")


def test_group4a_runs_without_jax_or_pil():
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-c", _GROUP4A_SCRIPT], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")


def test_group3_and_segmentation_run_without_jax_or_pil():
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-c", _GROUP3_SCRIPT], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")


def test_features_and_flow_run_without_jax_or_pil():
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-c", _GROUP2_SCRIPT], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")

def test_second_block_of_ops_runs_without_jax_or_pil():
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCK2_SCRIPT], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")


def test_slice_ops_and_capture_backends_run_without_jax_or_pil():
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-c", _SLICE_SCRIPT], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")


def test_port_imports_and_ticks_without_jax_or_pil():
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")


def test_facade_imports_and_runs_without_jax_or_pil():
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-c", _FACADE_SCRIPT], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")


def test_parallel_and_utils_run_without_jax_or_pil():
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-c", _PARALLEL_SCRIPT], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")


def test_package_import_is_light():
    """``import rustcv_tpu_torch`` alone loads neither torch nor jax, nor do
    the capture layer (the V4L2 driver and the native ring source too),
    ``videoio``, ``highgui``, ``imgcodecs`` and the top-level
    ``__version__``, ``Mat`` and ``TickMeter``."""
    script = (
        "import sys; sys.modules['jax'] = None; import rustcv_tpu_torch; "
        "import rustcv_tpu_torch.capture, rustcv_tpu_torch.videoio, rustcv_tpu_torch.prelude; "
        "import rustcv_tpu_torch.highgui, rustcv_tpu_torch.imgcodecs; "
        "import rustcv_tpu_torch.capture.v4l2, rustcv_tpu_torch.capture.native_source; "
        "from rustcv_tpu_torch import Mat, TickMeter, __version__; "
        "assert 'torch' not in sys.modules, 'torch imported'; print('OK')"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr


def test_font_data_generator_is_not_a_module_of_the_port():
    """``tools/make_text_data.py`` needs Pillow with raqm; nothing of
    ``rustcv_tpu_torch`` reaches it, and the package ships its output."""
    import importlib.util

    assert (REPO / "tools" / "make_text_data.py").is_file()
    assert (REPO / "rustcv_tpu_torch" / "assets" / "dejavusans_text.npz").is_file()
    for name in ("rustcv_tpu_torch.make_text_data", "rustcv_tpu_torch.assets.make_text_data",
                 "rustcv_tpu_torch.tools.make_text_data"):
        try:
            spec = importlib.util.find_spec(name)
        except ModuleNotFoundError:
            spec = None
        assert spec is None, name
    assert not list((REPO / "rustcv_tpu_torch").rglob("make_text_data*"))


_FORMATS_SCRIPT = textwrap.dedent(
    """
    import json, sys
    sys.modules["jax"] = None
    sys.modules["PIL"] = None
    sys.modules["rustcv_tpu"] = None
    from pathlib import Path
    import numpy as np
    from rustcv_tpu_torch import imgcodecs
    from rustcv_tpu_torch.imgcodecs import exif
    from rustcv_tpu_torch.ops import decode, text
    d = Path(sys.argv[1])
    want = json.loads((d / "want.json").read_text())
    for name in want["images"]:
        got = imgcodecs.imread(str(d / name), device="cpu").to_numpy()
        assert np.array_equal(got, np.load(d / (name + ".npy"))), name
    rgb = decode.decode_mjpeg_host_rgb((d / "progressive.jpg").read_bytes())
    assert np.array_equal(rgb, np.load(d / "progressive.jpg.npy")[..., ::-1])
    for name, meta in want["metadata"].items():
        assert list(exif.metadata((d / name).read_bytes()).items()) == [tuple(kv) for kv in meta]
        assert imgcodecs.imread_with_metadata(str(d / name), device="cpu")[1] == dict(meta)
    for (s, scale), digest in want["masks"]:
        import hashlib
        assert hashlib.sha256(text.rasterize(s, scale)[0].tobytes()).hexdigest() == digest, s
    bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "PIL", "rustcv_tpu")
           if sys.modules[m] is not None]
    assert not bad, bad
    print("OK")
    """
)


_MULTIPAGE_SCRIPT = textwrap.dedent(
    """
    import json, sys
    sys.modules["jax"] = None
    sys.modules["PIL"] = None
    sys.modules["rustcv_tpu"] = None
    from pathlib import Path
    import numpy as np
    import rustcv_tpu_torch.cv2 as cv2
    from rustcv_tpu_torch import imgcodecs
    from rustcv_tpu_torch.core import Mat
    from rustcv_tpu_torch.imgcodecs import exif
    d = Path(sys.argv[1])
    want = json.loads((d / "want.json").read_text())
    for name, n in want["counts"].items():
        path = str(d / name)
        assert imgcodecs.imcount(path) == n, name
        got = [m.to_numpy() for m in imgcodecs.imreadmulti(path, device="cpu")]
        truth = np.load(d / (name + ".npy"))
        assert len(got) == n and all(np.array_equal(g, t) for g, t in zip(got, truth)), name
        assert exif.metadata((d / name).read_bytes()) == want["metadata"][name], name
    rng = np.random.default_rng(1)
    frames = [rng.integers(0, 256, (20, 30, 3), np.uint8) for _ in range(2)]
    for ext in (".tiff", ".gif"):
        path = str(d / ("out" + ext))
        assert imgcodecs.imwritemulti(path, [Mat.from_array(f, device="cpu") for f in frames])
        back = [m.to_numpy() for m in imgcodecs.imreadmulti(path, device="cpu")]
        assert len(back) == 2 and (ext == ".gif" or np.array_equal(back[0], frames[0]))
    anim = cv2.Animation(3)
    anim.frames, anim.durations = frames, [40, 60]
    ok, buf = cv2.imencodeanimation(".gif", anim)
    ok2, back = cv2.imdecodeanimation(buf)
    assert ok and ok2 and back.durations == [40, 60] and back.loop_count == 3
    ok, buf = cv2.imencodeanimation(".webp", anim)  # an animated WebP (item 8c-ii)
    ok2, back = cv2.imdecodeanimation(buf)
    assert ok and ok2 and back.durations == [40, 60] and back.loop_count == 3
    bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "PIL", "rustcv_tpu")
           if sys.modules[m] is not None]
    assert not bad, bad
    print("OK")
    """
)


def test_tiff_and_gif_run_without_jax_or_pil(tmp_path):
    """Item 8b's codecs (``imgcodecs.tiff``, ``imgcodecs.gif``, the median
    cut, the LZW loops) run with jax, Pillow and the JAX package blocked:
    ``imcount``, ``imreadmulti`` and the metadata of a Pillow-written LZW
    TIFF with predictor 2 and an animated GIF equal what Pillow and the
    reference read (made here); ``imwritemulti`` to TIFF and GIF and cv2's
    animation calls run, an animated WebP among them (item 8c-ii)."""
    import io
    import json

    import numpy as np
    from PIL import Image, ImageSequence

    from rustcv_tpu import imgcodecs as jax_codecs

    rng = np.random.default_rng(0)
    pal = rng.integers(0, 256, (30, 3), np.uint8)
    frames = [Image.fromarray(pal[rng.integers(0, 30, (17, 23))]) for _ in range(3)]
    files = {}
    buf = io.BytesIO()
    frames[0].save(buf, "TIFF", save_all=True, append_images=frames[1:], compression="tiff_lzw",
                   tiffinfo={317: 2})
    files["pages.tif"] = buf.getvalue()
    buf = io.BytesIO()
    frames[0].save(buf, "GIF", save_all=True, append_images=frames[1:], duration=[30, 40, 50],
                   loop=1)
    files["anim.gif"] = buf.getvalue()
    want = {"counts": {}, "metadata": {}}
    for name, data in files.items():
        (tmp_path / name).write_bytes(data)
        im = Image.open(io.BytesIO(data))
        truth = [np.asarray(f.convert("RGB"))[..., ::-1] for f in ImageSequence.Iterator(im)]
        np.save(tmp_path / (name + ".npy"), np.stack(truth))
        want["counts"][name] = len(truth)
        want["metadata"][name] = jax_codecs.imread_with_metadata(str(tmp_path / name))[1]
    (tmp_path / "want.json").write_text(json.dumps(want))
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", _MULTIPAGE_SCRIPT, str(tmp_path)], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")


def test_formats_metadata_and_text_run_without_jax_or_pil(tmp_path):
    """``imgcodecs`` (a 16-bit Adam7 PNG, an RLE8 BMP, an ASCII PGM, a PFM
    and a progressive JPEG), ``imgcodecs.exif`` (a JPEG's and a PNG's EXIF),
    ``ops.decode.decode_mjpeg_host_rgb`` and ``ops.text`` (Latin-1 at pixel
    sizes 3 and 150) run with jax, Pillow and the JAX package blocked; the
    files and what Pillow reads of them are made here, with Pillow."""
    import hashlib
    import io
    import json
    import struct
    import zlib

    import numpy as np
    from PIL import Image

    from rustcv_tpu.ops import text as ref_text

    rng = np.random.default_rng(0)

    def chunk(k, b):
        return struct.pack(">I", len(b)) + k + b + struct.pack(">I", zlib.crc32(k + b))

    s16 = rng.integers(0, 65536, (9, 13, 3)).astype(">u2")
    rows = []
    for x0, y0, dx, dy in ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
                           (1, 0, 2, 2), (0, 1, 1, 2)):
        sub = s16[y0::dy, x0::dx]
        rows += [b"\x00" + r.tobytes() for r in sub] if sub.size else []
    files = {
        "adam7.png": b"".join([b"\x89PNG\r\n\x1a\n",
                               chunk(b"IHDR", struct.pack(">IIBBBBB", 13, 9, 16, 2, 0, 0, 1)),
                               chunk(b"IDAT", zlib.compress(b"".join(rows))), chunk(b"IEND", b"")]),
        "gray.pgm": b"P2\n# c\n3 2\n1000\n0 256 1000\n999 1 500\n",
        "float.pfm": b"Pf\n3 2\n-1.0\n" + np.array([1.5, 300, -2, 7.9, 0, 255], "<f4").tobytes(),
    }
    pal = bytes(rng.integers(0, 256, 64).astype(np.uint8))
    body = bytes([3, 1, 0, 4, 5, 6, 7, 8, 0, 0]) * 3 + b"\x00\x01"
    hdr = struct.pack("<IiiHHIIiiII", 40, 7, 3, 1, 8, 1, 0, 0, 0, 16, 0)
    off = 14 + 40 + len(pal)
    files["rle8.bmp"] = b"BM" + struct.pack("<IHHI", off + len(body), 0, 0, off) + hdr + pal + body
    a = rng.integers(0, 256, (17, 23, 3), np.uint8)
    ex = Image.Exif()
    ex[0x010F], ex[0x0112], ex[0x011A] = "maker", 6, 72.0
    for name, fmt, kw in (("progressive.jpg", "JPEG", {"progressive": True, "quality": 80}),
                          ("exif.jpg", "JPEG", {"exif": ex}), ("exif.png", "PNG", {"exif": ex})):
        buf = io.BytesIO()
        Image.fromarray(a).save(buf, fmt, **kw)
        files[name] = buf.getvalue()
    for name, data in files.items():
        (tmp_path / name).write_bytes(data)
        np.save(tmp_path / (name + ".npy"),
                np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))[..., ::-1])
    want = {"images": sorted(files), "metadata": {}, "masks": []}
    for name in ("exif.jpg", "exif.png"):
        with Image.open(tmp_path / name) as img:
            meta = {str(k): str(v) for k, v in img.info.items() if isinstance(v, (str, int, float))}
            meta.update({f"exif:{k}": str(v) for k, v in img.getexif().items()})
        want["metadata"][name] = list(meta.items())
    for s, scale in (("héllo wörld", 0.15), ("ÆØÅ\xadfi «½»", 7.5)):
        want["masks"].append(((s, scale), hashlib.sha256(
            ref_text.rasterize(s, scale)[0].tobytes()).hexdigest()))
    (tmp_path / "want.json").write_text(json.dumps(want))
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-c", _FORMATS_SCRIPT, str(tmp_path)], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")


_WEBP_SCRIPT = textwrap.dedent(
    """
    import hashlib, json, sys
    sys.modules["jax"] = None
    sys.modules["PIL"] = None
    sys.modules["rustcv_tpu"] = None
    from pathlib import Path
    import numpy as np
    import rustcv_tpu_torch.cv2 as cv2
    from rustcv_tpu_torch import imgcodecs
    d = Path(sys.argv[1])
    manifest = json.loads((d / "manifest.json").read_text())
    for name in ("lossy_normal_seg4_part3.webp", "lossless_m6.webp", "anim_blend_dispose.webp"):
        m, path = manifest[name], str(d / name)
        got = [x.to_numpy() for x in imgcodecs.imreadmulti(path, device="cpu")]
        assert imgcodecs.imcount(path) == len(got) == m["n_frames"], name
        assert [hashlib.sha256(g.tobytes()).hexdigest() for g in got] == m["frames"], name
        assert imgcodecs.imread_with_metadata(path, device="cpu")[1] == m["metadata"], name
        ok, anim = cv2.imreadanimation(path)
        assert ok and anim.durations == m["durations"] and anim.loop_count == m["loop"], name
    import torch
    img = torch.from_numpy(np.arange(4 * 6 * 3, dtype=np.uint8).reshape(4, 6, 3))
    ok, buf = cv2.imencode(".webp", img)  # the writes of item 8c-ii, on a CPU tensor
    assert ok and cv2.imdecode(buf).shape == (4, 6, 3)
    anim = cv2.Animation(2)
    anim.frames, anim.durations = [img, img.flip(0)], [30, 40]
    ok, buf = cv2.imencodeanimation(".webp", anim)
    ok2, back = cv2.imdecodeanimation(buf)
    assert ok and ok2 and back.durations == [30, 40] and back.loop_count == 2
    bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "PIL", "rustcv_tpu")
           if sys.modules[m] is not None]
    assert not bad, bad
    print("OK")
    """
)


def test_webp_reads_run_without_jax_or_pil():
    """Item 8c's reads (``imgcodecs.webp`` over ``native/vp8.cpp`` and
    ``native/vp8l.cpp``) run with jax, Pillow and the JAX package blocked: a
    lossy, a lossless and an animated fixture of ``tests/data/webp`` read
    to the reference's hashes, counts, durations, loop and metadata in its
    manifest; a still and an animation written (item 8c-ii, the VP8 and
    ALPH coders of ``native/vp8enc.cpp`` and ``native/vp8lenc.cpp``) read
    back; no module of the port loads libwebp or Pillow."""
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", _WEBP_SCRIPT, str(REPO / "tests" / "data" / "webp")],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")
    for src in (REPO / "rustcv_tpu_torch").rglob("*.py"):  # no library of Pillow's wheel
        text = src.read_text()
        assert "pillow.libs" not in text and "libwebp-" not in text and "libwebp.so" not in text, src
