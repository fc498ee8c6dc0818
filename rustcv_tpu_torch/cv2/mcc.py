"""cv2.mcc namespace — ColorChecker detection over ops/colorchecker."""
from ._extras import mcc_CCheckerDetector as CCheckerDetector  # noqa: F401

MCC24 = 0
SG140 = 1
VINYL18 = 2


class DetectorParameters:
    def __init__(self):
        self.adaptiveThreshWinSizeMin = 23
        self.adaptiveThreshWinSizeMax = 153
        self.adaptiveThreshWinSizeStep = 16

    @staticmethod
    def create():
        return DetectorParameters()
