"""cv2.segmentation namespace."""
from ._extras_seg import IntelligentScissorsMB  # noqa: F401
