"""IntelligentScissorsMB under its cv2.segmentation name."""
from ._algos import segmentation_IntelligentScissorsMB as \
    IntelligentScissorsMB  # noqa: F401
