"""cv2.barcode — EAN-13 detection/decoding over rustcv_tpu_torch.ops.barcode
(the port of ``rustcv_tpu.cv2.barcode``; host code, as the reference's)."""
from __future__ import annotations

from ._device import _a
from ._device import bind as _bind
from ..ops import barcode as _bc


class BarcodeDetector:
    """cv2.barcode.BarcodeDetector role (EAN-13; the reference scope of
    ops/barcode.py)."""

    def __init__(self, prototxt_path="", model_path=""):
        pass

    def detectAndDecode(self, img, points=None):
        res = _bc.detect_and_decode(_a(img))
        if not res:
            return "", "", None
        return res[0], "EAN_13", None

    def detectAndDecodeWithType(self, img, points=None):
        return self.detectAndDecode(img, points)

    def detectAndDecodeMulti(self, img, points=None):
        res = _bc.detect_and_decode(_a(img))
        if not res:
            return False, [], None, []
        return True, res, None, ["EAN_13"] * len(res)

    def decode(self, img, points):
        return self.detectAndDecode(img)[:1]

    def detect(self, img, points=None):
        ok = bool(_bc.detect_and_decode(_a(img)))
        return ok, None


_bind(globals())
