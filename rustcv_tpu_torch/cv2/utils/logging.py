"""cv2.utils.logging role over the stdlib logger (the port of
``rustcv_tpu.cv2.utils.logging``)."""
import logging as _pylog

LOG_LEVEL_SILENT = 0
LOG_LEVEL_FATAL = 1
LOG_LEVEL_ERROR = 2
LOG_LEVEL_WARNING = 3
LOG_LEVEL_INFO = 4
LOG_LEVEL_DEBUG = 5
LOG_LEVEL_VERBOSE = 6

_level = [LOG_LEVEL_WARNING]
_logger = _pylog.getLogger("rustcv_tpu_torch.cv2")


def setLogLevel(level):
    prev = _level[0]
    _level[0] = int(level)
    _logger.setLevel({0: _pylog.CRITICAL + 10, 1: _pylog.CRITICAL,
                      2: _pylog.ERROR, 3: _pylog.WARNING,
                      4: _pylog.INFO, 5: _pylog.DEBUG,
                      6: _pylog.DEBUG}.get(int(level), _pylog.WARNING))
    return prev


def getLogLevel():
    return _level[0]
