"""The stateful classes of the rest of the port's cv2 facade (ROADMAP Queue 1
item 7b) against the reference's, over sequences: the DIS, Farnebäck and
sparse LK flow objects over 4 frames, the variational refinement, the GFTT
and blob detectors, MSER and the line-segment detector, the generalized
Hough pair, ``Subdiv2D`` and ``Octree``, ``flann_Index`` and ``ANNIndex``,
the ``aruco`` detector on markers its own ``generateImageMarker`` drew and
the ChArUco board, the ``detail`` matcher, estimator, compensators, seam
finders, blenders and timelapser on two crops, ``Stitcher`` on two 160×120
crops, the QR encoder read back by the detector, and the 3-d containers.

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

H, W, N = 96, 128, 4


def _texture(h, w, seed=5):
    rng = np.random.default_rng(seed)
    small = rng.integers(0, 256, (h // 4 + 2, w // 4 + 2, 3)).astype(np.float64)
    big = small.repeat(4, 0).repeat(4, 1)[:h + 6, :w + 6]
    k = np.ones(5) / 5
    for ax in (0, 1):
        big = np.apply_along_axis(lambda v: np.convolve(v, k, "same"), ax, big)
    return np.clip(big, 0, 255).astype(np.uint8)


def _frames(n=N, h=H, w=W):
    """A smooth texture panning 1 px right and down per frame, with a bright
    square moving 3 px a frame."""
    base = _texture(h + 2 * n, w + 2 * n)
    out = []
    for i in range(n):
        f = base[n - i:n - i + h, n - i:n - i + w].copy()
        y, x = 30 + i, 20 + 3 * i
        f[y:y + 16, x:x + 16] = (230, 200, 40)
        out.append(np.ascontiguousarray(f))
    return out


def _grays(n=N):
    return [np.ascontiguousarray(f[..., 1]) for f in _frames(n)]


def both(scenario, monkeypatch, bar=0):
    """``scenario(cv2, img)`` on the reference with numpy images and on the
    port with CPU tensors; the results held equal (or within ``bar``)."""
    ref = scenario(R, lambda a: a)
    with as_on_the_card(monkeypatch):
        port = scenario(P, lambda a: torch.from_numpy(np.ascontiguousarray(a)))
    same(ref, port, bar)
    return ref, port


def _flow_within(got, want):
    """The flow bar (tests/test_torch_flow.py): 99 % of |Δ| under 1e-3 px,
    all under 0.05 px."""
    assert got.shape == want.shape and got.dtype == want.dtype
    d = np.abs(got.astype(np.float64) - want)
    assert np.quantile(d, 0.99) < 1e-3 and d.max() < 0.05, (np.quantile(d, 0.99), d.max())


@pytest.mark.parametrize("preset", [0, 1, 2])
def test_dis_over_four_frames(preset, monkeypatch):
    g = _grays()

    def run(cv, img):
        dis = cv.DISOpticalFlow_create(preset)
        flows = [dis.calc(img(a), img(b), None) for a, b in zip(g, g[1:])]
        return flows, dis.getFinestScale()

    (flows, _), _ = both(run, monkeypatch)
    assert np.abs(flows[0]).max() > 0.1  # it moved


def test_variational_refinement(monkeypatch):
    g = _grays(2)
    init = np.full((H, W, 2), 0.5, np.float32)

    def run(cv, img):
        vr = cv.VariationalRefinement_create()
        u, v = vr.calcUV(img(g[0]), img(g[1]), init[..., 0].copy(), init[..., 1].copy())
        return vr.calc(img(g[0]), img(g[1]), init.copy()), u, v

    both(run, monkeypatch)


def test_farneback_over_four_frames(monkeypatch):
    """On a tensor the device twin (float32) against the reference's numpy
    oracle: the flow bar."""
    g = _grays()

    def run(cv, img):
        fb = cv.FarnebackOpticalFlow_create(numLevels=3)
        return [fb.calc(img(a), img(b), None) for a, b in zip(g, g[1:])]

    ref = run(R, lambda a: a)
    with as_on_the_card(monkeypatch):
        port = run(P, torch.from_numpy)
    for a, b in zip(port, ref):
        _flow_within(a, b)


def test_sparse_lk_and_gftt_over_four_frames(monkeypatch):
    g = _grays()

    def run(cv, img):
        gftt = cv.GFTTDetector_create(40, 0.01, 5)
        kps = [gftt.detect(img(x)) for x in g]
        pts = cv.KeyPoint_convert(kps[0]).reshape(-1, 1, 2)
        lk = cv.SparsePyrLKOpticalFlow_create((15, 15), 2)
        tracks = []
        for a, b in zip(g, g[1:]):
            nxt, st, err = lk.calc(img(a), img(b), pts, None)
            tracks.append((nxt, st))
            pts = nxt
        return kps, tracks

    (kps, tracks), _ = both(run, monkeypatch, bar=1e-3)  # LK's bar: 1e-3 px, status exact
    assert len(kps[0]) > 10 and tracks[0][1].sum() > 5


def test_gftt_with_harris_on_a_bgr_frame(monkeypatch):
    f = _frames(1)[0]

    def run(cv, img):
        return cv.GFTTDetector_create(30, 0.02, 4, 3, True, 0.05).detect(img(f))

    kps, _ = both(run, monkeypatch)
    assert len(kps) > 5


def _blobs():
    g = np.full((H, W), 200, np.uint8)
    for (y, x, r) in ((30, 30, 7), (60, 90, 9), (70, 40, 7)):
        yy, xx = np.ogrid[:H, :W]
        g[(yy - y) ** 2 + (xx - x) ** 2 <= r * r] = 30
    return g


def test_blob_mser_and_lsd(monkeypatch):
    b = _blobs()
    f = _frames(1)[0]

    def run(cv, img):
        params = cv.SimpleBlobDetector_Params()
        params.minArea = 20
        blobs = cv.SimpleBlobDetector_create(params).detect(img(b))
        mser = cv.MSER_create(5, 30, 2000)
        regions, boxes = mser.detectRegions(img(b))
        kps = mser.detect(img(b))
        lsd = cv.createLineSegmentDetector()
        lines = lsd.detect(img(f))
        canvas = img(f.copy())
        lsd.drawSegments(canvas, lines[0]) if lines[0] is not None else None
        return blobs, regions, boxes, kps, lines, canvas

    (blobs, regions, *_), _ = both(run, monkeypatch)
    assert len(blobs) == 3 and len(regions) >= 3


def test_generalized_hough(monkeypatch):
    g = np.full((H, W), 20, np.uint8)
    g[30:60, 40:80] = 220
    templ = np.full((40, 50), 20, np.uint8)
    templ[5:35, 5:45] = 220

    def run(cv, img):
        out = []
        for make in (cv.createGeneralizedHoughBallard, cv.createGeneralizedHoughGuil):
            gh = make()
            gh.setTemplate(img(templ))
            gh.setVotesThreshold(20)
            out.append(gh.detect(img(g)))
        return out

    (ballard, _guil), _ = both(run, monkeypatch)
    assert ballard[0] is not None


def test_subdiv_and_octree(monkeypatch):
    rng = np.random.default_rng(4)
    pts = rng.uniform(2, 60, (24, 2)).round(2)
    cloud = rng.uniform(-1, 1, (50, 3))

    def run(cv, img):
        sd = cv.Subdiv2D((0, 0, 64, 64))
        sd.insert([tuple(p) for p in pts[:20]])
        for p in pts[20:]:
            sd.insert(tuple(p))
        facets = sd.getVoronoiFacetList([])
        o = cv.Octree_createWithDepth(4, 2.0, (-1, -1, -1))
        ins = [o.insertPoint(p) for p in cloud[:10]]
        o2 = cv.Octree.fromPointCloud(cloud)
        return (sd.getTriangleList(), sd.getEdgeList(), sd.findNearest((30.0, 31.0)), facets,
                ins, o.isPointInBounds((0.5, 0.5, 0.5)), o.isPointInBounds((3.0, 0, 0)),
                o.deletePoint(cloud[0]), o.empty(), o2.empty())

    both(run, monkeypatch)


def test_flann_and_ann_indexes(monkeypatch):
    rng = np.random.default_rng(6)
    data = rng.normal(size=(200, 8)).astype(np.float32)
    q = rng.normal(size=(5, 8)).astype(np.float32)

    def run(cv, img):
        idx = cv.flann_Index(data, {"algorithm": 1, "trees": 4})
        knn = idx.knnSearch(q, 3)
        rad = idx.radiusSearch(q[0], 6.0, 10)
        out = [knn, rad]
        for dist in range(5):
            ann = cv.ANNIndex_create(8, dist)
            ann.addItems(data)
            ann.build(4)
            out.append((ann.knnSearch(q, 4), ann.getItemNumber(), ann.getTreeNumber()))
        fm = cv.FlannBasedMatcher_create()
        out.append([(m.queryIdx, m.trainIdx, m.distance) for m in fm.match(q, data)])
        return out

    both(run, monkeypatch)


def _marker_page(cv):
    """Markers 0, 3, 7 and 11 of DICT_4X4_50 drawn by the facade's own
    ``generateImageMarker`` on a white page."""
    d = cv.aruco.getPredefinedDictionary(cv.aruco.DICT_4X4_50)
    page = np.full((240, 320), 255, np.uint8)
    for i, (y, x) in zip((0, 3, 7, 11), ((20, 20), (20, 180), (130, 40), (140, 200))):
        page[y:y + 72, x:x + 72] = cv.aruco.generateImageMarker(d, i, 72)
    return d, page


def test_aruco_detector_on_its_own_markers(monkeypatch):
    K = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]])

    def run(cv, img):
        d, page = _marker_page(cv)
        det = cv.aruco.ArucoDetector(d, cv.aruco.DetectorParameters())
        corners, ids, rej = det.detectMarkers(img(page))
        bgr = np.repeat(page[..., None], 3, axis=2)
        c2, ids2, _ = det.detectMarkers(img(bgr))
        canvas = img(bgr.copy())
        cv.aruco.drawDetectedMarkers(canvas, corners, ids)
        rv, tv, _ = cv.aruco.estimatePoseSingleMarkers(corners, 0.05, K, np.zeros(5))
        board = cv.aruco.GridBoard((2, 2), 0.05, 0.01, d)
        n, brv, btv = cv.aruco.estimatePoseBoard(corners, ids, board, K, np.zeros(5))
        return corners, ids, c2, ids2, canvas, rv, tv, n, board.generateImage((200, 200), None, 10)

    (corners, ids, *_), _ = both(run, monkeypatch)
    assert sorted(ids.ravel().tolist()) == [0, 3, 7, 11]


def test_charuco_detector_refines_on_the_calls_device(monkeypatch):
    def run(cv, img):
        d = cv.aruco.getPredefinedDictionary(0)
        board = cv.aruco.CharucoBoard((5, 4), 0.04, 0.03, d)
        page = np.full((220, 280), 255, np.uint8)
        page[10:210, 15:265] = board.generateImage((250, 200))
        cc, ci, mc, mi = cv.aruco.CharucoDetector(board).detectBoard(img(page))
        n, cc2, ci2 = cv.aruco.interpolateCornersCharuco(mc, mi, img(page), board)
        canvas = img(np.repeat(page[..., None], 3, axis=2))
        cv.aruco.drawDetectedCornersCharuco(canvas, cc2, ci2)
        return cc, ci, n, cc2, ci2, canvas, board.getChessboardCorners()

    (cc, ci, n, *_), _ = both(run, monkeypatch, bar=1e-3)  # cornerSubPix's bar, px
    assert n > 4


def _crops():
    """Two 160×120 crops of one scene, 60 px apart horizontally."""
    scene = _texture(120, 220, seed=9)[:120, :220]
    return np.ascontiguousarray(scene[:, :160]), np.ascontiguousarray(scene[:, 60:220])


def test_detail_pipeline_on_two_crops(monkeypatch):
    a, b = _crops()

    def run(cv, img):
        det = cv.detail
        finder = cv.ORB_create(300)
        feats = det.computeImageFeatures(finder, [img(a), img(b)])
        matcher = det.BestOf2NearestMatcher(False, 0.8)
        pairs = matcher.apply2(feats)
        ok, cams = det.HomographyBasedEstimator().apply(feats, pairs, None)
        corners = [(0, 0), (60, 0)]
        masks = [np.full((120, 160), 255, np.uint8) for _ in range(2)]
        comp = det.ExposureCompensator.createDefault(det.ExposureCompensator.GAIN)
        comp.feed(corners, [img(a), img(b)], masks)
        b2 = b.copy()
        comp.apply(1, corners[1], b2, masks[1])
        seams = det.SeamFinder.createDefault(det.SeamFinder.VORONOI_SEAM).find(
            [img(a), img(b)], corners, [m.copy() for m in masks])
        out = [pairs[1].num_inliers, ok, [c.K() for c in cams], comp.getMatGains(), b2, seams]
        for blender in (det.FeatherBlender(0.05), det.MultiBandBlender(0, 3)):
            blender.prepare(corners, [(160, 120), (160, 120)])
            for im, m, c in zip((a, b), seams, corners):
                blender.feed(img(im), m, c)
            out.append(blender.blend())
        tl = det.Timelapser.createDefault(det.Timelapser.CROP)
        tl.initialize(corners, [(160, 120), (160, 120)])
        tl.process(img(b), masks[1], corners[1])
        out.append(tl.getDst())
        pyr = det.createLaplacePyr(img(a), 3)
        out += [pyr, det.restoreImageFromLaplacePyr(pyr), det.createWeightMap(masks[0], 0.1)]
        return out

    (inliers, *_), _ = both(run, monkeypatch)
    assert inliers > 10


def test_stitcher_on_two_crops(monkeypatch):
    a, b = _crops()

    def run(cv, img):
        st = cv.Stitcher_create(cv.Stitcher.PANORAMA)
        return st.stitch([img(a), img(b)]), st.stitch([img(a)])

    ((status, pano), _), _ = both(run, monkeypatch)
    assert status == 0 and pano.shape[1] > 160


def test_qr_encoder_read_back(monkeypatch):
    def run(cv, img):
        params = cv.QRCodeEncoder_Params()
        params.correction_level = 1
        code = cv.QRCodeEncoder_create(params).encode("rustcv 7b")
        page = np.full((200, 200), 255, np.uint8)
        big = np.kron(code, np.ones((5, 5), np.uint8))  # 255 marks a dark module
        page[30:30 + big.shape[0], 30:30 + big.shape[1]] = 255 - big
        text, pts, _ = cv.QRCodeDetector().detectAndDecode(img(page))
        return code, text, pts

    (code, text, _), _ = both(run, monkeypatch)
    assert text == "rustcv 7b"


def test_3d_containers_and_warpers(monkeypatch):
    K = np.array([[60.0, 0, 32], [0, 60.0, 24], [0, 0, 1]])
    yy, xx = np.mgrid[:48, :64]
    depth = (1.5 + 0.002 * xx + 0.001 * yy).astype(np.float64)
    moved = depth + 0.01
    f = _frames(1, 48, 64)[0]

    def run(cv, img):
        odo = cv.Odometry()
        odo.setCameraMatrix(K)
        vol = cv.Volume(resolution=32, voxelSize=0.1, K=K)
        vol.integrate(depth, np.eye(4))
        pts = cv.depthTo3d(depth.astype(np.float32), K)
        normals = cv.RgbdNormals_create(48, 64, 5, K).apply(pts)
        warper = cv.PyRotationWarper("cylindrical", 50.0)
        sc = cv.segmentation_IntelligentScissorsMB()
        sc.applyImage(img(f))
        sc.buildMap((10, 10))
        return (odo.compute(depth, moved), float(np.abs(vol.tsdf.tsdf).sum()), normals,
                warper.warp(img(f), K.astype(np.float32), np.eye(3, dtype=np.float32)),
                sc.getContour((40, 30)), cv.WarperCreator().create(30.0).warp(img(f), K, np.eye(3)))

    both(run, monkeypatch)


def test_colorchecker_and_barcode_objects(monkeypatch):
    f = _frames(1)[0]

    def run(cv, img):
        det = cv.mcc_CCheckerDetector.create()
        found = det.process(img(f), cv.mcc.MCC24)
        bc = cv.barcode_BarcodeDetector()
        patches = np.random.default_rng(3).uniform(0.1, 0.9, (24, 3))
        model = cv.ccm_ColorCorrectionModel(patches)
        return (found, det.getListColorChecker(), bc.detectAndDecode(img(f)),
                bc.detect(img(f)), bc.detectAndDecodeMulti(img(f)), model.run(),
                model.infer(patches.reshape(4, 6, 3)))

    both(run, monkeypatch)
