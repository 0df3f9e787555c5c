"""Dtype names: the port's own copy of ``paddle_tpu/core/dtypes.py``, on
torch dtypes."""

import numpy as np
import torch

__all__ = ["convert_dtype", "dtype_name"]

_STR_TO_DTYPE = {
    "float32": torch.float32, "fp32": torch.float32,
    "float64": torch.float64, "double": torch.float64, "fp64": torch.float64,
    "float16": torch.float16, "fp16": torch.float16, "half": torch.float16,
    "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
    "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
    "int64": torch.int64, "uint8": torch.uint8, "bool": torch.bool,
}


def convert_dtype(dtype):
    """A dtype name, numpy dtype or torch dtype as a torch dtype."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        key = dtype.lower()
        if key not in _STR_TO_DTYPE:
            raise ValueError(f"Unknown dtype string: {dtype!r}")
        return _STR_TO_DTYPE[key]
    return _STR_TO_DTYPE[np.dtype(dtype).name]


def dtype_name(dtype):
    """'float32', 'int64', ...: the name both packages print."""
    return str(convert_dtype(dtype)).removeprefix("torch.")
