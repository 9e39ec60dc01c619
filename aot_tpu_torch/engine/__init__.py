"""Temporal engines: the memory state machine driving AOT."""

from aot_tpu_torch.engine.engine import VOSEngine
from aot_tpu_torch.engine.infer import VOSInferEngine, build_infer_engine
from aot_tpu_torch.engine.state import EngineState

__all__ = ["EngineState", "VOSEngine", "VOSInferEngine", "build_infer_engine"]
