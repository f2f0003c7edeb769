"""The port's DataFrame engine."""

from sparkdl_tpu_torch.engine.dataframe import DataFrame, EngineConfig

__all__ = ["DataFrame", "EngineConfig"]
