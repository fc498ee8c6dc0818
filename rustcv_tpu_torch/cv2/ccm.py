"""cv2.ccm namespace — color-correction matrices over ops/colorchecker."""
from ._extras import ccm_ColorCorrectionModel as ColorCorrectionModel  # noqa: F401,E501

COLORCHECKER_MACBETH = 0
COLORCHECKER_VINYL = 1
COLORCHECKER_DIGITAL_SG = 2
CCM_3x3 = 0
CCM_4x3 = 1
COLOR_SPACE_SRGB = 0
LINEARIZATION_IDENTITY = 0
LINEARIZATION_GAMMA = 1
