"""Runtime of the port: the batched multi-stream engine and its pipeline."""

from .engine import EngineStats, MultiStreamEngine, TickResult
from .pipeline import PipelineSpec, get_pipeline

__all__ = ["EngineStats", "MultiStreamEngine", "PipelineSpec", "TickResult", "get_pipeline"]
