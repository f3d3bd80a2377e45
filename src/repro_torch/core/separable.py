"""Depthwise-separable convolution blocks — the paper's own workload.

Counterpart of ``repro/core/separable.py``: the MobileNetV1 block (DW 3x3
+ folded-BN bias + ReLU6, then PW + ReLU6) and the MobileNetV2 inverted
residual (PW-expand + DW + PW-project), built from the paper's two ops,
with BatchNorm folded into the filters and biases (inference form).

Thin shims over the chain API (``core/chain.py``): each builds a
``SeparableSpec``, adapts the legacy parameter dict to per-stage params and
calls ``chain.execute``, so the planner decides what fuses (3-stage ->
2-stage -> unfused by shared-memory feasibility), not a user boolean.  On
the card a MobileNetV2 inverted residual is one ``separable_fused`` launch.

    params = init_separable(torch.Generator().manual_seed(0), 32, 64)
    y = separable_block(params, x)          # x (B, H, W, 32) on the card
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import chain
from repro_torch.core.network import require_device
from repro_torch.kernels.policy import DEFAULT_POLICY, KernelPolicy


def _normal(generator: torch.Generator, shape, scale: float, dtype, device):
    """Draws made on the CPU from ``generator``, then moved, so a seed
    gives the same weights on every device."""
    t = torch.randn(shape, generator=generator) * scale
    return t.to(device=device, dtype=dtype)


def init_separable(generator: torch.Generator, c_in: int, c_out: int,
                   hf: int = 3, wf: int = 3, *,
                   dtype: torch.dtype = torch.float32, device="cuda") -> dict:
    """The reference's initialisation: normal filters scaled by
    1/sqrt(hf*wf) and 1/sqrt(c_in), zero biases; on the card unless
    ``device`` says otherwise."""
    device = require_device(device)
    return {
        "dw_filter": _normal(generator, (hf, wf, c_in),
                             1.0 / math.sqrt(hf * wf), dtype, device),
        "dw_bias": torch.zeros(c_in, dtype=dtype, device=device),
        "pw_weight": _normal(generator, (c_in, c_out), 1.0 / math.sqrt(c_in),
                             dtype, device),
        "pw_bias": torch.zeros(c_out, dtype=dtype, device=device),
    }


def separable_block(params: dict, x: torch.Tensor, *, stride: int = 1,
                    activation: str = "relu6",
                    policy: KernelPolicy = DEFAULT_POLICY) -> torch.Tensor:
    """MobileNetV1 depthwise-separable block (inference, BN folded):
    DW(+bias, act) -> PW(+bias, act) through ``chain.execute``.  The
    planner fuses the pair into one kernel pass whenever it fits a CTA
    (``KernelPolicy(fused=False)`` forces the unfused composition)."""
    hf, wf = params["dw_filter"].shape[:2]
    spec = chain.SeparableSpec(stages=(
        chain.DW(stride=stride, activation=activation, hf=hf, wf=wf,
                 bias=True),
        chain.PW(params["pw_weight"].shape[-1], activation=activation,
                 bias=True),
    ))
    stage_params = (
        {"f": params["dw_filter"], "b": params["dw_bias"]},
        {"w": params["pw_weight"], "b": params["pw_bias"]},
    )
    return chain.execute(spec, stage_params, x, policy=policy)


def init_inverted_residual(generator: torch.Generator, c_in: int,
                           c_out: int, expand: int = 6, hf: int = 3, *,
                           dtype: torch.dtype = torch.float32,
                           device="cuda") -> dict:
    """The reference's initialisation: normal weights scaled by
    1/sqrt(fan-in) (1/hf for the DW filter); on the card unless
    ``device`` says otherwise."""
    device = require_device(device)
    c_mid = c_in * expand
    return {
        "expand_w": _normal(generator, (c_in, c_mid), 1.0 / math.sqrt(c_in),
                            dtype, device),
        "dw_filter": _normal(generator, (hf, hf, c_mid), 1.0 / hf, dtype,
                             device),
        "project_w": _normal(generator, (c_mid, c_out),
                             1.0 / math.sqrt(c_mid), dtype, device),
    }


def inverted_residual(params: dict, x: torch.Tensor, *, stride: int = 1,
                      policy: KernelPolicy = DEFAULT_POLICY) -> torch.Tensor:
    """MobileNetV2 inverted-residual block (PW-expand -> DW -> PW-project)
    through ``chain.execute``: one fused kernel pass (the expansion
    computed on the fly per row slab, the residual folded into the store)
    whenever the 3-stage tile fits a CTA, degrading to expand + fused
    DW->project, then fully unfused."""
    hf, wf = params["dw_filter"].shape[:2]
    c_mid = params["expand_w"].shape[-1]
    c_out = params["project_w"].shape[-1]
    spec = chain.SeparableSpec(stages=(
        chain.PW(c_mid, activation="relu6"),
        chain.DW(stride=stride, activation="relu6", hf=hf, wf=wf),
        chain.PW(c_out),
    ), residual="auto")
    stage_params = (
        {"w": params["expand_w"]},
        {"f": params["dw_filter"]},
        {"w": params["project_w"]},
    )
    return chain.execute(spec, stage_params, x, policy=policy)
