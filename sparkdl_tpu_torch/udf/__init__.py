"""Model-as-UDF registry (the SQL-serving layer).

A port of ``sparkdl_tpu.udf``: a named UDF is a column operator on the
port's DataFrame, either a plain row function or a ModelFunction applied
batch-wise on the card, invoked by
``DataFrame.selectExpr("my_udf(image) as preds")`` or
``sql("SELECT my_udf(image) FROM view")``.
"""

from sparkdl_tpu_torch.udf.registry import (
    ColumnUDF,
    UDFRegistry,
    registerImageUDF,
    registerKerasImageUDF,
    registerTensorUDF,
    registerUDF,
    udf_registry,
)

__all__ = [
    "ColumnUDF",
    "UDFRegistry",
    "registerImageUDF",
    "registerKerasImageUDF",
    "registerTensorUDF",
    "registerUDF",
    "udf_registry",
]
