"""cv2.detail — the stitching pipeline's exposed internals, over
rustcv_tpu_torch.ops.blend and the facade's matcher, homography and
distance transform (the port of ``rustcv_tpu.cv2.detail``; host code, as
the reference's).

The stage contracts (features → pairwise match → rotation estimation →
exposure compensation → seam finding → blending) follow cv2.detail's
dataflow; tests/test_torch_cv2_later_classes.py holds the compensators,
seam finders and blenders against the reference's on two crops.
Reference behaviors: the Brown-Lowe pipeline the reference's stitch
example uses.
"""
from __future__ import annotations

import numpy as np

from ._classes import BFMatcher, DMatch, KeyPoint
from ._device import _a, _copyto
from ._device import bind as _bind


def _gray(a):
    a = _a(a)
    if a.ndim == 3:
        from . import cvtColor
        from . import _constants as _C

        return cvtColor(a, _C.COLOR_BGR2GRAY)
    return a


# ---------------------------------------------------------------- structs

class ImageFeatures:
    def __init__(self, img_idx=0, img_size=(0, 0), keypoints=None,
                 descriptors=None):
        self.img_idx = int(img_idx)
        self.img_size = tuple(img_size)
        self.keypoints = keypoints or []
        self.descriptors = descriptors

    def getKeypoints(self):
        return self.keypoints


class MatchesInfo:
    def __init__(self):
        self.src_img_idx = -1
        self.dst_img_idx = -1
        self.matches = []
        self.inliers_mask = np.zeros(0, np.uint8)
        self.num_inliers = 0
        self.H = None
        self.confidence = 0.0

    def getMatches(self):
        return self.matches

    def getInliers(self):
        return self.inliers_mask


class CameraParams:
    def __init__(self, focal=1.0, aspect=1.0, ppx=0.0, ppy=0.0, R=None,
                 t=None):
        self.focal = float(focal)
        self.aspect = float(aspect)
        self.ppx = float(ppx)
        self.ppy = float(ppy)
        self.R = np.eye(3, dtype=np.float32) if R is None else R
        self.t = np.zeros((3, 1), np.float64) if t is None else t

    def K(self):
        return np.array([[self.focal, 0, self.ppx],
                         [0, self.focal * self.aspect, self.ppy],
                         [0, 0, 1]], np.float64)


# --------------------------------------------------------------- features

def computeImageFeatures(featuresFinder, images, masks=None):
    return [computeImageFeatures2(featuresFinder, img, None, i)
            for i, img in enumerate(images)]


def computeImageFeatures2(featuresFinder, image, mask=None, _idx=0):
    kps, desc = featuresFinder.detectAndCompute(_gray(image), mask)
    a = _a(image)
    return ImageFeatures(_idx, (a.shape[1], a.shape[0]), list(kps), desc)


# --------------------------------------------------------------- matching

class FeaturesMatcher:
    def apply(self, features1, features2):
        raise NotImplementedError

    def apply2(self, features):
        out = []
        n = len(features)
        for i in range(n):
            for j in range(n):
                if i == j:
                    mi = MatchesInfo()
                    mi.src_img_idx = mi.dst_img_idx = i
                    out.append(mi)
                else:
                    mi = self.apply(features[i], features[j])
                    mi.src_img_idx, mi.dst_img_idx = i, j
                    out.append(mi)
        return out

    def collectGarbage(self):
        pass


class BestOf2NearestMatcher(FeaturesMatcher):
    """Lowe-ratio 2-NN matching + RANSAC homography, cv2.detail's
    confidence formula (inliers / (8 + 0.3 matches))."""

    def __init__(self, try_use_gpu=False, match_conf=0.65,
                 num_matches_thresh1=6, num_matches_thresh2=6,
                 matches_confindece_thresh=3.0):
        self._ratio = float(match_conf)
        self._thresh = int(num_matches_thresh1)

    def apply(self, features1, features2):
        from . import _constants as _C
        from ._classes import findHomography

        mi = MatchesInfo()
        d1, d2 = features1.descriptors, features2.descriptors
        if d1 is None or d2 is None or len(d1) < 2 or len(d2) < 2:
            return mi
        bf = BFMatcher(_C.NORM_L2)
        knn = bf.knnMatch(_a(d1, np.float32),
                          _a(d2, np.float32), k=2)
        good = [m for m, s in (p for p in knn if len(p) == 2)
                if m.distance < self._ratio * s.distance]
        mi.matches = good
        if len(good) < self._thresh:
            return mi
        src = np.float32([features1.keypoints[m.queryIdx].pt
                          for m in good])
        dst = np.float32([features2.keypoints[m.trainIdx].pt
                          for m in good])
        H, mask = findHomography(src.reshape(-1, 1, 2),
                                 dst.reshape(-1, 1, 2), _C.RANSAC, 3.0)
        if H is None:
            return mi
        mi.H = H
        mi.inliers_mask = _a(mask, np.uint8).ravel()
        mi.num_inliers = int(mi.inliers_mask.sum())
        mi.confidence = mi.num_inliers / (8 + 0.3 * len(good))
        return mi

    @staticmethod
    def create(*a, **k):
        return BestOf2NearestMatcher(*a, **k)


class AffineBestOf2NearestMatcher(BestOf2NearestMatcher):
    def apply(self, features1, features2):
        from . import _constants as _C
        from ._classes import estimateAffinePartial2D

        mi = super().apply(features1, features2)
        if mi.num_inliers:
            src = np.float32([features1.keypoints[m.queryIdx].pt
                              for m in mi.matches])
            dst = np.float32([features2.keypoints[m.trainIdx].pt
                              for m in mi.matches])
            A, mask = estimateAffinePartial2D(src, dst)
            if A is not None:
                mi.H = np.vstack([A, [0, 0, 1]])
                mi.inliers_mask = _a(mask, np.uint8).ravel()
                mi.num_inliers = int(mi.inliers_mask.sum())
        return mi


class BestOf2NearestRangeMatcher(BestOf2NearestMatcher):
    def __init__(self, range_width=5, *a, **k):
        super().__init__(*a, **k)
        self._range = int(range_width)


# -------------------------------------------------------------- estimation

def focalsFromHomography(H, f0=None, f1=None):
    """Classic Szeliski-Shum focal extraction from a rotation-induced
    homography → (f0, f0_ok, f1, f1_ok)."""
    h = _a(H, np.float64).ravel()
    d1 = h[6] * h[7]
    d2 = (h[7] - h[6]) * (h[7] + h[6])
    v1 = -(h[0] * h[1] + h[3] * h[4]) / d1 if d1 != 0 else -1
    v2 = (h[0] * h[0] + h[3] * h[3] - h[1] * h[1] - h[4] * h[4]) / d2 \
        if d2 != 0 else -1
    f1_ok = False
    f1v = 0.0
    if v1 < v2:
        v1, v2 = v2, v1
    if v1 > 0 and v2 > 0:
        f1v = np.sqrt(v1 if abs(d1) > abs(d2) else v2)
        f1_ok = True
    elif v1 > 0:
        f1v = np.sqrt(v1)
        f1_ok = True
    d1 = h[0] * h[3] + h[1] * h[4]
    d2 = h[0] * h[0] + h[1] * h[1] - h[3] * h[3] - h[4] * h[4]
    v1 = -h[2] * h[5] / d1 if d1 != 0 else -1
    v2 = (h[5] * h[5] - h[2] * h[2]) / d2 if d2 != 0 else -1
    f0_ok = False
    f0v = 0.0
    if v1 < v2:
        v1, v2 = v2, v1
    if v1 > 0 and v2 > 0:
        f0v = np.sqrt(v1 if abs(d1) > abs(d2) else v2)
        f0_ok = True
    elif v1 > 0:
        f0v = np.sqrt(v1)
        f0_ok = True
    return f0v, f0_ok, f1v, f1_ok


class Estimator:
    def apply(self, features, pairwise_matches, cameras=None):
        raise NotImplementedError


class HomographyBasedEstimator(Estimator):
    """Focals from pairwise homographies + rotations chained from the
    first image (cv2.detail role)."""

    def apply(self, features, pairwise_matches, cameras=None):
        n = len(features)
        focals = []
        for mi in pairwise_matches:
            if mi.H is not None and mi.src_img_idx != mi.dst_img_idx:
                f0, ok0, f1, ok1 = focalsFromHomography(mi.H)
                if ok0 and ok1:
                    focals.append(np.sqrt(f0 * f1))
        f = float(np.median(focals)) if focals else \
            float(max(features[0].img_size))
        cams = []
        for i in range(n):
            w, h = features[i].img_size
            cams.append(CameraParams(f, 1.0, w * 0.5, h * 0.5))
        # chain rotations along 0 -> i using available pairwise H
        Hs = {(mi.src_img_idx, mi.dst_img_idx): mi.H
              for mi in pairwise_matches if mi.H is not None}
        for i in range(1, n):
            if (0, i) in Hs:
                K0, Ki = cams[0].K(), cams[i].K()
                R = np.linalg.inv(Ki) @ Hs[(0, i)] @ K0
                u, _, vt = np.linalg.svd(R)
                cams[i].R = (u @ vt).astype(np.float32)
        return True, cams


class AffineBasedEstimator(HomographyBasedEstimator):
    pass


class BundleAdjusterBase(Estimator):
    def setConfThresh(self, v):
        self._conf = float(v)

    def apply(self, features, pairwise_matches, cameras):
        return True, cameras  # refinement no-op (NoBundleAdjuster role)


class NoBundleAdjuster(BundleAdjusterBase):
    pass


class BundleAdjusterRay(BundleAdjusterBase):
    pass


class BundleAdjusterReproj(BundleAdjusterBase):
    pass


class BundleAdjusterAffine(BundleAdjusterBase):
    pass


class BundleAdjusterAffinePartial(BundleAdjusterBase):
    pass


def waveCorrect(rmats, kind=0):
    """Straighten the camera-up vectors (wave correction role): rotate
    all R so the mean x-axis is horizontal."""
    if not rmats:
        return rmats
    xs = np.mean([R[:, 0] for R in _a(rmats, np.float64)], axis=0)
    up = np.array([0.0, 1.0, 0.0])
    z = np.cross(xs, up)
    nz = np.linalg.norm(z)
    if nz < 1e-9:
        return rmats
    z /= nz
    y = np.cross(z, xs / np.linalg.norm(xs))
    B = np.stack([xs / np.linalg.norm(xs), y, z], axis=1)
    u, _, vt = np.linalg.svd(B)
    G = (u @ vt).T
    return [_a(G @ _a(R, np.float64), np.float32)
            for R in rmats]


def leaveBiggestComponent(features, pairwise_matches, conf_threshold):
    """Keep indices of the largest match-connected component."""
    n = len(features)
    parent = list(range(n))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for mi in pairwise_matches:
        if mi.confidence >= conf_threshold and mi.src_img_idx >= 0 \
                and mi.src_img_idx != mi.dst_img_idx:
            parent[find(mi.src_img_idx)] = find(mi.dst_img_idx)
    from collections import Counter

    roots = [find(i) for i in range(n)]
    big = Counter(roots).most_common(1)[0][0]
    return _a([i for i in range(n) if roots[i] == big], np.int32)


def matchesGraphAsString(paths, pairwise_matches, conf_threshold):
    lines = ["graph matches_graph{"]
    for mi in pairwise_matches:
        if mi.confidence >= conf_threshold and mi.src_img_idx >= 0 \
                and mi.src_img_idx < mi.dst_img_idx:
            lines.append(
                f'"{paths[mi.src_img_idx]}" -- "{paths[mi.dst_img_idx]}"'
                f"[label=\"Nm={len(mi.matches)}, "
                f"Ni={mi.num_inliers}, C={mi.confidence:.5f}\"];")
    lines.append("}")
    return "\n".join(lines)


def overlapRoi(tl1, tl2, sz1, sz2):
    x0 = max(tl1[0], tl2[0])
    y0 = max(tl1[1], tl2[1])
    x1 = min(tl1[0] + sz1[0], tl2[0] + sz2[0])
    y1 = min(tl1[1] + sz1[1], tl2[1] + sz2[1])
    if x1 <= x0 or y1 <= y0:
        return False, (0, 0, 0, 0)
    return True, (x0, y0, x1 - x0, y1 - y0)


def resultRoi(corners, sizes):
    x0 = min(c[0] for c in corners)
    y0 = min(c[1] for c in corners)
    x1 = max(c[0] + s[0] for c, s in zip(corners, sizes))
    y1 = max(c[1] + s[1] for c, s in zip(corners, sizes))
    return (x0, y0, x1 - x0, y1 - y0)


def resultTl(corners):
    return (min(c[0] for c in corners), min(c[1] for c in corners))


def selectRandomSubset(count, size, seed=0):
    rng = np.random.RandomState(seed)
    return sorted(rng.choice(size, min(count, size),
                             replace=False).tolist())


def stitchingLogLevel():
    return 0


# ------------------------------------------------------------ compensation

class ExposureCompensator:
    NO = 0
    GAIN = 1
    GAIN_BLOCKS = 2
    CHANNELS = 3
    CHANNELS_BLOCKS = 4

    @staticmethod
    def createDefault(type):
        return {0: NoExposureCompensator, 1: GainCompensator,
                2: BlocksGainCompensator, 3: ChannelsCompensator,
                4: BlocksChannelsCompensator}[int(type)]()

    def feed(self, corners, images, masks):
        pass

    def apply(self, index, corner, image, mask):
        return image


class NoExposureCompensator(ExposureCompensator):
    pass


class GainCompensator(ExposureCompensator):
    """Brown-Lowe global gains over overlap means (ops/blend.py)."""

    def __init__(self, nr_feeds=1):
        self._gains = None

    def feed(self, corners, images, masks):
        from ..ops.blend import gain_compensation

        imgs = [_a(i) for i in images]
        ms = [_a(m) if not isinstance(m, tuple) else
              _a(m[0]) for m in masks]
        sizes = [(m.shape[1], m.shape[0]) for m in ms]
        x0, y0, w, h = resultRoi(corners, sizes)
        # gain_compensation wants shared-frame images/masks
        shared_i, shared_m = [], []
        for img, m, c in zip(imgs, ms, corners):
            fi = np.zeros((h, w) + img.shape[2:], img.dtype)
            fm = np.zeros((h, w), bool)
            cx, cy = c[0] - x0, c[1] - y0
            fi[cy:cy + m.shape[0], cx:cx + m.shape[1]] = img
            fm[cy:cy + m.shape[0], cx:cx + m.shape[1]] = m > 0
            shared_i.append(fi)
            shared_m.append(fm)
        self._gains = gain_compensation(shared_i, shared_m)

    def apply(self, index, corner, image, mask):
        if self._gains is None:
            return image
        g = float(self._gains[index])
        a = _a(image)
        out = np.clip(_a(a, np.float64) * g, 0, 255)
        _copyto(image, out.astype(a.dtype))
        return image

    def getMatGains(self, umv=None):
        return [_a([[g]], np.float64) for g in
                (self._gains if self._gains is not None else [])]


class ChannelsCompensator(GainCompensator):
    pass


class BlocksCompensator(GainCompensator):
    pass


class BlocksGainCompensator(GainCompensator):
    def __init__(self, bl_width=32, bl_height=32, nr_feeds=1):
        super().__init__(nr_feeds)


class BlocksChannelsCompensator(GainCompensator):
    pass


# ------------------------------------------------------------ seam finding

class SeamFinder:
    NO = 0
    VORONOI_SEAM = 1
    DP_SEAM = 2

    @staticmethod
    def createDefault(type):
        return {0: NoSeamFinder, 1: VoronoiSeamFinder,
                2: DpSeamFinder}[int(type)]()

    def find(self, src, corners, masks):
        return masks


class NoSeamFinder(SeamFinder):
    pass


class PairwiseSeamFinder(SeamFinder):
    pass


class VoronoiSeamFinder(PairwiseSeamFinder):
    """Distance-transform seams in every pairwise overlap
    (ops/blend.voronoi_seam), resolved in global coordinates."""

    def find(self, src, corners, masks):
        from ..ops.blend import voronoi_seam

        n = len(src)
        out = [_a(m).copy() for m in masks]
        for i in range(n):
            for j in range(i + 1, n):
                szi = (out[i].shape[1], out[i].shape[0])
                szj = (out[j].shape[1], out[j].shape[0])
                ok, roi = overlapRoi(corners[i], corners[j], szi, szj)
                if not ok:
                    continue
                x0, y0, w, h = roi
                gi = np.zeros((h, w), np.uint8)
                gj = np.zeros((h, w), np.uint8)
                six, siy = x0 - corners[i][0], y0 - corners[i][1]
                sjx, sjy = x0 - corners[j][0], y0 - corners[j][1]
                gi[:] = out[i][siy:siy + h, six:six + w]
                gj[:] = out[j][sjy:sjy + h, sjx:sjx + w]
                mi, mj = voronoi_seam(gi > 0, gj > 0)
                out[i][siy:siy + h, six:six + w] = \
                    np.where(mi, gi, 0)
                out[j][sjy:sjy + h, sjx:sjx + w] = \
                    np.where(mj, gj, 0)
        return out


class DpSeamFinder(VoronoiSeamFinder):
    """DP seam role — resolved with the same distance-transform seams
    (documented approximation; identical contract)."""

    def __init__(self, costFunc=0):
        pass


class GraphCutSeamFinder(VoronoiSeamFinder):
    """Graph-cut seam role — same contract, distance-transform seams
    (no copied maxflow implementation)."""

    def __init__(self, cost_type=0, terminal_cost=10000.0,
                 bad_region_penalty=1000.0):
        pass


# ---------------------------------------------------------------- blending

class Blender:
    NO = 0
    FEATHER = 1
    MULTI_BAND = 2

    @staticmethod
    def createDefault(type, try_gpu=False):
        return {0: Blender, 1: FeatherBlender,
                2: MultiBandBlender}[int(type)]()

    def prepare(self, corners_or_roi, sizes=None):
        if sizes is None:
            x0, y0, w, h = corners_or_roi
        else:
            x0, y0, w, h = resultRoi(corners_or_roi, sizes)
        self._tl = (x0, y0)
        self._acc = np.zeros((h, w, 3), np.float64)
        self._wsum = np.zeros((h, w), np.float64)

    def _weight(self, mask):
        return (_a(mask) > 0).astype(np.float64)

    def feed(self, img, mask, tl):
        a = _a(img, np.float64)
        if a.ndim == 2:
            a = a[..., None].repeat(3, -1)
        w = self._weight(mask)
        x0 = tl[0] - self._tl[0]
        y0 = tl[1] - self._tl[1]
        h, wd = w.shape
        self._acc[y0:y0 + h, x0:x0 + wd] += a[..., :3] * w[..., None]
        self._wsum[y0:y0 + h, x0:x0 + wd] += w

    def blend(self, dst=None, dst_mask=None):
        w = np.maximum(self._wsum, 1e-9)
        out = (self._acc / w[..., None])
        mask = (self._wsum > 0).astype(np.uint8) * 255
        return np.clip(out, 0, 255).astype(np.int16), mask


class FeatherBlender(Blender):
    """Distance-to-border feathering weights."""

    def __init__(self, sharpness=0.02):
        self._sharp = float(sharpness)

    def _weight(self, mask):
        from . import distanceTransform
        from . import _constants as _C

        m = (_a(mask) > 0).astype(np.uint8)
        d = _a(distanceTransform(m, _C.DIST_L1, 3), np.float64)
        return np.minimum(d * self._sharp, 1.0) * (m > 0)


class MultiBandBlender(Blender):
    """Laplacian-pyramid blending: the canvas-level two-source case
    delegates to ops/blend.multi_band_blend_numpy per feed pair."""

    def __init__(self, try_gpu=0, num_bands=5, weight_type=None):
        self._bands = int(num_bands)
        self._feeds = []

    def prepare(self, corners_or_roi, sizes=None):
        super().prepare(corners_or_roi, sizes)
        self._feeds = []

    def setNumBands(self, n):
        self._bands = int(n)

    def numBands(self):
        return self._bands

    def feed(self, img, mask, tl):
        self._feeds.append((_a(img), _a(mask), tl))

    def blend(self, dst=None, dst_mask=None):
        from ..ops.blend import multi_band_blend_numpy

        h, w = self._wsum.shape
        canvas = None
        cmask = np.zeros((h, w), bool)
        for img, mask, tl in self._feeds:
            a = _a(img, np.float64)
            if a.ndim == 2:
                a = a[..., None].repeat(3, -1)
            full = np.zeros((h, w, 3), np.float64)
            fm = np.zeros((h, w), bool)
            x0, y0 = tl[0] - self._tl[0], tl[1] - self._tl[1]
            mh, mw = _a(mask).shape
            full[y0:y0 + mh, x0:x0 + mw] = a[..., :3]
            fm[y0:y0 + mh, x0:x0 + mw] = _a(mask) > 0
            if canvas is None:
                canvas, cmask = full, fm
            else:
                from ..ops.blend import voronoi_seam

                s1, _s2 = voronoi_seam(cmask, fm)
                keep1 = (s1 | (cmask & ~fm)) & cmask
                blended = multi_band_blend_numpy(
                    np.clip(canvas, 0, 255).astype(np.uint8),
                    np.clip(full, 0, 255).astype(np.uint8),
                    keep1.astype(np.float64), n_bands=self._bands)
                new = _a(blended, np.float64)
                both = cmask | fm
                canvas = np.where(both[..., None], new, 0.0)
                cmask = both
        if canvas is None:
            canvas = np.zeros((h, w, 3))
        return (np.clip(canvas, 0, 255).astype(np.int16),
                (cmask * 255).astype(np.uint8))


# --------------------------------------------------------------- timelapse

class Timelapser:
    AS_IS = 0
    CROP = 1

    @staticmethod
    def createDefault(type):
        return TimelapserCrop() if int(type) == 1 else Timelapser()

    def initialize(self, corners, sizes):
        x0, y0, w, h = resultRoi(corners, sizes)
        self._tl = (x0, y0)
        self._frame = np.zeros((h, w, 3), np.uint8)

    def process(self, img, mask, tl):
        a = _a(img)
        if a.ndim == 2:
            a = a[..., None].repeat(3, -1)
        x0, y0 = tl[0] - self._tl[0], tl[1] - self._tl[1]
        self._frame[:] = 0
        self._frame[y0:y0 + a.shape[0], x0:x0 + a.shape[1]] = \
            np.clip(a[..., :3], 0, 255).astype(np.uint8)

    def getDst(self):
        return self._frame


class TimelapserCrop(Timelapser):
    pass


# ----------------------------------------------------- pyramid utilities

def createLaplacePyr(img, num_levels):
    from ..ops.blend import _blur5, _down, _up

    a = _a(img, np.float64)
    pyr = []
    cur = a
    for _ in range(int(num_levels)):
        nxt = _down(_blur5(cur))
        pyr.append(cur - _up(nxt, cur.shape))
        cur = nxt
    pyr.append(cur)
    return [p.astype(np.float32) for p in pyr]


def restoreImageFromLaplacePyr(pyr):
    from ..ops.blend import _up

    cur = _a(pyr[-1], np.float64)
    for lvl in reversed(pyr[:-1]):
        cur = _a(lvl, np.float64) + _up(cur, _a(lvl).shape)
    return cur.astype(np.float32)


def createWeightMap(mask, sharpness=0.02, weight=None):
    from . import distanceTransform
    from . import _constants as _C

    m = (_a(mask) > 0).astype(np.uint8)
    d = _a(distanceTransform(m, _C.DIST_L1, 3), np.float64)
    return (np.minimum(d * float(sharpness), 1.0) * (m > 0)).astype(
        np.float32)


def normalizeUsingWeightMap(weight, src):
    w = _a(weight, np.float64)
    a = _a(src, np.float64)
    if a.ndim == 3:
        w = w[..., None]
    return (a / np.maximum(w, 1e-9)).astype(np.float32)


_bind(globals())
