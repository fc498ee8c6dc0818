"""cv2.aruco-compatible submodule over ops/aruco.py (the port of
``rustcv_tpu.cv2.aruco``). Marker detection, drawing and pose are host
code, as the reference's; the ChArUco corner refinement
(``interpolateCornersCharuco``, ``CharucoDetector.detectBoard``) runs on
the call's device (a numpy image goes to the card).

Dictionaries are self-generated (ops/aruco.Dictionary.generate — no
OpenCV data copied), so marker BITS differ from OpenCV's stock
dictionaries: markers drawn with this module are detected by this module
(and vice versa), but an OpenCV-printed DICT_4X4_50 sheet needs its
dictionary imported via ``Dictionary(bits)``.
"""
from __future__ import annotations

import numpy as np

from ..core.mat import Mat
from ..ops import aruco as _ar
from . import _constants as _C
from ._constants import *  # noqa: F401,F403 - DICT_* ids
from ._device import _a, _hwc, _t
from ._device import bind as _bind

_DICT_SPECS = {}
for _n in (50, 100, 250, 1000):
    for _bits in (4, 5, 6, 7):
        _DICT_SPECS[f"DICT_{_bits}X{_bits}_{_n}"] = (_bits, _n)


class Dictionary:
    def __init__(self, inner):
        self._d = inner


_cache = {}


def getPredefinedDictionary(dict_id):
    """Map a cv2 DICT_* id to a deterministically generated dictionary
    of the same marker size and capacity."""
    name = None
    for n in _DICT_SPECS:
        if getattr(_C, n, None) == dict_id:
            name = n
            break
    if name is None:
        raise ValueError(f"unknown aruco dictionary id {dict_id}")
    if name not in _cache:
        bits, count = _DICT_SPECS[name]
        _cache[name] = Dictionary(_ar.Dictionary.generate(
            n=count, bits=bits, seed=dict_id))
    return _cache[name]


class DetectorParameters:
    def __init__(self):
        pass


class RefineParameters:
    def __init__(self, *a, **k):
        pass


class ArucoDetector:
    def __init__(self, dictionary, detectorParams=None,
                 refineParams=None):
        self._dict = dictionary

    def detectMarkers(self, image):
        arr = image.to_numpy() if isinstance(image, Mat) else \
            _a(image)
        if arr.ndim == 3:
            arr = arr[..., 0] if arr.shape[2] == 1 else \
                _a(_hwc(arr)[..., :3].mean(-1), np.uint8)
        corners, ids = _ar.detect_markers(arr, self._dict._d)
        cs = tuple(_a(c, np.float32).reshape(1, 4, 2)
                   for c in corners)
        ids_arr = None if len(ids) == 0 else \
            _a(ids, np.int32).reshape(-1, 1)
        return cs, ids_arr, ()


def detectMarkers(image, dictionary, parameters=None):
    return ArucoDetector(dictionary).detectMarkers(image)


def generateImageMarker(dictionary, id, sidePixels, img=None,
                        borderBits=1):
    """sidePixels is the full marker side (cv2 semantics); drawn at the
    largest integer cell size that fits, then nearest-upsampled to
    exactly sidePixels like cv2's generateImageMarker."""
    cells = dictionary._d.bits + 2
    cell_px = max(1, int(sidePixels) // cells)
    out = _a(_ar.draw_marker(dictionary._d, int(id), cell_px),
                     np.uint8)
    if out.shape[0] != int(sidePixels):
        idx = (np.arange(int(sidePixels)) * out.shape[0]
               // int(sidePixels))
        out = out[np.ix_(idx, idx)]
    return out


def drawDetectedMarkers(image, corners, ids=None,
                        borderColor=(0, 255, 0)):
    from . import polylines as _polylines
    for i, c in enumerate(corners):
        pts = _a(c, np.float32).reshape(4, 2).astype(np.int32)
        _polylines(image, [pts], True, borderColor, 1)
    return image


def estimatePoseSingleMarkers(corners, markerLength, cameraMatrix,
                              distCoeffs):
    # ops.estimate_pose_single_markers iterates the marker list itself
    # (r5 call-coverage fix: the old wrapper double-iterated, feeding
    # single corner ROWS to the ops layer)
    rvecs, tvecs = _ar.estimate_pose_single_markers(
        [_a(c, np.float64).reshape(4, 2) for c in corners],
        float(markerLength), _a(cameraMatrix),
        np.zeros(5) if distCoeffs is None
        else _a(distCoeffs, np.float64).ravel())
    return (_a(rvecs).reshape(-1, 1, 3),
            _a(tvecs).reshape(-1, 1, 3), None)


# ------------------------------------------------------------- boards

class Board:
    """cv2.aruco.Board role: generic marker board (object points +
    dictionary + ids)."""

    def __init__(self, objPoints, dictionary, ids):
        self.objPoints = [_a(p, np.float32).reshape(4, 3)
                          for p in objPoints]
        self.dictionary = dictionary
        self.ids = _a(ids, np.int32).ravel()

    def getObjPoints(self):
        return self.objPoints

    def getIds(self):
        return self.ids

    def getDictionary(self):
        return self.dictionary

    def matchImagePoints(self, detectedCorners, detectedIds,
                         objPoints=None, imgPoints=None):
        obj, img = [], []
        id_list = list(self.ids)
        for c, i in zip(detectedCorners, _a(detectedIds).ravel()):
            if int(i) in id_list:
                obj.append(self.objPoints[id_list.index(int(i))])
                img.append(_a(c, np.float32).reshape(4, 2))
        if not obj:
            return np.zeros((0, 1, 3), np.float32), \
                np.zeros((0, 1, 2), np.float32)
        return (np.concatenate(obj).reshape(-1, 1, 3),
                np.concatenate(img).reshape(-1, 1, 2))


class GridBoard(Board):
    """cv2.aruco.GridBoard over ops/aruco.GridBoard."""

    def __init__(self, size, markerLength, markerSeparation, dictionary,
                 ids=None):
        self._gb = _ar.GridBoard((int(size[0]), int(size[1])),
                                 float(markerLength),
                                 float(markerSeparation), dictionary._d)
        obj = [self._gb.marker_object_corners(int(i))
               for i in self._gb.ids]
        super().__init__(obj, dictionary, self._gb.ids)

    def generateImage(self, outSize, img=None, marginSize=0,
                      borderBits=1):
        base = self._gb.draw(cell_px=8)
        out = _resize_nn(base, (int(outSize[0]) - 2 * marginSize,
                                int(outSize[1]) - 2 * marginSize))
        if marginSize:
            canvas = np.full((int(outSize[1]), int(outSize[0])), 255,
                             np.uint8)
            canvas[marginSize:marginSize + out.shape[0],
                   marginSize:marginSize + out.shape[1]] = out
            return canvas
        return out

    def getGridSize(self):
        return self._gb.size

    def getMarkerLength(self):
        return self._gb.marker_length

    def getMarkerSeparation(self):
        return self._gb.marker_separation


class CharucoBoard(Board):
    """cv2.aruco.CharucoBoard over ops/aruco.CharucoBoard."""

    def __init__(self, size, squareLength, markerLength, dictionary,
                 ids=None):
        self._cb = _ar.CharucoBoard((int(size[0]), int(size[1])),
                                    float(squareLength),
                                    float(markerLength), dictionary._d)
        mids = list(range(len(self._cb.marker_cells)))
        obj = [self._cb.marker_object_corners(i) for i in mids]
        super().__init__(obj, dictionary, _a(mids, np.int32))

    def generateImage(self, outSize, img=None, marginSize=0,
                      borderBits=1):
        base = self._cb.draw(square_px=32)
        return _resize_nn(base, (int(outSize[0]), int(outSize[1])))

    def getChessboardSize(self):
        return self._cb.size

    def getSquareLength(self):
        return self._cb.square_length

    def getMarkerLength(self):
        return self._cb.marker_length

    def getChessboardCorners(self):
        return _a(self._cb.chessboard_corners(), np.float32)


def _resize_nn(img, wh):
    w, h = int(wh[0]), int(wh[1])
    yi = (np.arange(h) * img.shape[0] // h)
    xi = (np.arange(w) * img.shape[1] // w)
    return img[np.ix_(yi, xi)]


class CharucoParameters:
    def __init__(self):
        self.cameraMatrix = None
        self.distCoeffs = None
        self.minMarkers = 2
        self.tryRefineMarkers = False


class CharucoDetector:
    """cv2.aruco.CharucoDetector: marker detection + homography-based
    inner-corner interpolation (ops/aruco.interpolate_corners_charuco)."""

    def __init__(self, board, charucoParameters=None,
                 detectorParams=None, refineParams=None):
        self._board = board
        self._det = ArucoDetector(board.getDictionary())

    def getBoard(self):
        return self._board

    def detectBoard(self, image, charucoCorners=None, charucoIds=None,
                    markerCorners=None, markerIds=None):
        corners, ids, _ = self._det.detectMarkers(image)
        if ids is None:
            return None, None, corners, ids
        arr = image.to_numpy() if isinstance(image, Mat) else \
            _a(image)
        if arr.ndim == 3:
            arr = arr[..., 0]
        cc, ci = _ar.interpolate_corners_charuco(
            [_a(c, np.float64).reshape(4, 2) for c in corners],
            _a(ids).ravel(), _t(arr), self._board._cb)
        if len(cc) == 0:
            return None, None, corners, ids
        return (_a(cc, np.float32).reshape(-1, 1, 2),
                _a(ci, np.int32).reshape(-1, 1), corners, ids)

    def detectDiamonds(self, image, *a, **k):
        raise NotImplementedError(
            "charuco diamonds are out of scope; use detectBoard")


def estimatePoseBoard(corners, ids, board, cameraMatrix, distCoeffs,
                      rvec=None, tvec=None):
    if isinstance(board, GridBoard):
        n, rv, tv = _ar.estimate_pose_board(
            [_a(c, np.float64).reshape(4, 2) for c in corners],
            _a(ids).ravel(), board._gb,
            _a(cameraMatrix, np.float64),
            np.zeros(5) if distCoeffs is None
            else _a(distCoeffs, np.float64).ravel())
        if n == 0:
            return 0, None, None
        return n, _a(rv).reshape(3, 1), _a(tv).reshape(3, 1)
    obj, img = board.matchImagePoints(corners, ids)
    if len(obj) == 0:
        return 0, None, None
    from ..ops import calib as _calib

    rv, tv = _calib.solve_pnp(
        obj.reshape(-1, 3), img.reshape(-1, 2),
        _a(cameraMatrix, np.float64),
        np.zeros(5) if distCoeffs is None
        else _a(distCoeffs, np.float64).ravel())
    return len(obj) // 4, _a(rv).reshape(3, 1), \
        _a(tv).reshape(3, 1)


def interpolateCornersCharuco(markerCorners, markerIds, image, board,
                              charucoCorners=None, charucoIds=None,
                              cameraMatrix=None, distCoeffs=None,
                              minMarkers=2):
    arr = image.to_numpy() if isinstance(image, Mat) else \
        _a(image)
    if arr.ndim == 3:
        arr = arr[..., 0]
    cc, ci = _ar.interpolate_corners_charuco(
        [_a(c, np.float64).reshape(4, 2) for c in markerCorners],
        _a(markerIds).ravel(), _t(arr), board._cb)
    return (len(cc), _a(cc, np.float32).reshape(-1, 1, 2),
            _a(ci, np.int32).reshape(-1, 1))


def drawDetectedCornersCharuco(image, charucoCorners, charucoIds=None,
                               cornerColor=(255, 0, 0)):
    from . import circle as _circle

    for p in _a(charucoCorners, np.float32).reshape(-1, 2):
        _circle(image, (int(round(p[0])), int(round(p[1]))), 3,
                cornerColor, 1)
    return image


_bind(globals())
