"""Convert the JAX package's network parameters into the port's.

The reference keeps per-block lists of per-stage dicts of arrays (DW
``f`` (Hf, Wf, C), PW ``w`` (Ci, Co), biases (C,)); the port keeps the
same structure and layouts, so nothing is transposed.  Leaves may be numpy
arrays or anything ``numpy.asarray`` accepts (a JAX array converts on the
host); this module imports neither JAX nor the reference package.
"""
from __future__ import annotations

import numpy as np
import torch

_DTYPES = {"float32": torch.float32, "float16": torch.float16,
           "bfloat16": torch.bfloat16}


def tensor_from_numpy(a, device="cuda") -> torch.Tensor:
    """One leaf as a tensor of the same dtype.  bf16 arrays (which numpy
    holds through ml_dtypes) travel through fp32, which is exact."""
    arr = np.asarray(a)
    name = arr.dtype.name
    if name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    if name not in _DTYPES:
        raise ValueError(f"unsupported parameter dtype {name}")
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def params_from_numpy(jax_params, device="cuda") -> list:
    """Reference network params (blocks -> stages -> {name: array}) as the
    port's (the same structure, tensors on ``device``)."""
    return [[{k: tensor_from_numpy(v, device) for k, v in stage.items()}
             for stage in block] for block in jax_params]
