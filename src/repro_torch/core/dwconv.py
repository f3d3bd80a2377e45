"""DWConv as a framework op.  Counterpart of ``repro/core/dwconv.py``:

* :func:`depthwise2d` — NHWC spatial DWConv (the CNN bodies);
* :func:`depthwise1d_causal` — causal sequence DWConv (the conv
  pre-activation of the xLSTM blocks and the Mamba heads), the
  ``dwconv1d`` kernel on the card, with :func:`depthwise1d_step` for
  decode (the plain one-row step, as in the reference, which launches no
  kernel) and :func:`conv_tail`, the state a prefill hands to decode.

Under a model axis the channels are split (the paper's DWConv across
ranks): each rank calls these on its contiguous block of D/tp channels
with its block of the filter, and its conv state is that block's; the
conv needs no collective.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.pwconv import DEFAULT_POLICY, KernelPolicy
from repro_torch.kernels import ops, ref


def depthwise2d(x: torch.Tensor, f: torch.Tensor, *, stride: int = 1,
                padding: str = "same",
                policy: KernelPolicy = DEFAULT_POLICY) -> torch.Tensor:
    """x (B, H, W, C) * f (Hf, Wf, C) -> (B, Ho, Wo, C)."""
    return ops.dwconv2d(x, f, stride=stride, padding=padding,
                        impl=policy.impl)


def depthwise1d_causal(x: torch.Tensor, f: torch.Tensor, *,
                       policy: KernelPolicy = DEFAULT_POLICY) -> torch.Tensor:
    """x (B, L, D) * f (K, D) -> (B, L, D), causal; both contiguous on the
    card, f in x's dtype.  Differentiable: under autograd the backward is
    the ``dwconv1d`` backward kernels on the card."""
    return ops.dwconv1d_causal(x, f, impl=policy.impl)


def depthwise1d_step(state: torch.Tensor, x_t: torch.Tensor,
                     f: torch.Tensor) -> tuple:
    """Single-token decode step; state (B, K-1, D) of past inputs."""
    return ref.dwconv1d_step_ref(state, x_t, f)


def init_conv_state(batch: int, k: int, d: int, dtype=torch.float32,
                    device="cuda") -> torch.Tensor:
    return torch.zeros((batch, max(k - 1, 1), d), dtype=dtype, device=device)


def conv_tail(x_pre: torch.Tensor, kc: int) -> torch.Tensor:
    """The last K-1 pre-conv inputs (fp32), left-padded when L < K-1: the
    conv state a decode step continues from."""
    tail = x_pre[:, -(kc - 1):, :].float()
    pad = (kc - 1) - tail.shape[1]
    if pad > 0:
        tail = F.pad(tail, (0, 0, pad, 0))
    return tail
