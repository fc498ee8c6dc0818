"""Core types of the port: the reference's own ``rustcv_tpu.core`` objects
(numpy-only), so configs, pixel formats, errors and frames are one
vocabulary for both packages."""

from rustcv_tpu.core import *  # noqa: F401,F403
from rustcv_tpu.core import __all__  # noqa: F401
