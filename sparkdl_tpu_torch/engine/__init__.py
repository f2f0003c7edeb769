"""The port's DataFrame engine."""

from sparkdl_tpu_torch.engine.dataframe import (
    DataFrame, EngineConfig, sql, table,
)

__all__ = ["DataFrame", "EngineConfig", "sql", "table"]
