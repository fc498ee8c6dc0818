"""Utilities: tracing, profiling, capture statistics."""

from .trace import CaptureStats, StageTimer, get_logger, profile_trace

__all__ = ["CaptureStats", "StageTimer", "get_logger", "profile_trace"]
