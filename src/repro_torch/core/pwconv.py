"""PWConv as a framework op: every dense projection of the LM stack
(``models/layers.py::linear``) routes through :func:`pointwise`, so the
paper's output-stationary GEMM kernel (``csrc/pwconv.cu``) runs every
Linear on the card.  Counterpart of ``repro/core/pwconv.py``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.policy import (  # noqa: F401  (re-export)
    DEFAULT_POLICY,
    KernelPolicy,
    resolve_impl,
)


def pointwise(x: torch.Tensor, w: torch.Tensor,
              bias: Optional[torch.Tensor] = None, *,
              activation: Optional[str] = None,
              policy: KernelPolicy = DEFAULT_POLICY) -> torch.Tensor:
    """Pointwise conv (1x1) / GEMM over the trailing axis, fp32 accumulate.
    x (..., Ci) must be contiguous on the card."""
    return ops.pwconv(x, w, bias, activation=activation, impl=policy.impl,
                      block_g=policy.block_g, block_co=policy.block_co,
                      block_ci=policy.block_ci)
