"""Plain PyTorch versions of the ops the kernels compute.

Counterpart of ``repro/kernels/ref.py`` (``dwconv2d_ref`` :24,
``pwconv_ref`` :141, ``separable_fused_ref`` :158, ``conv2d_ref`` :201,
``fused_mbconv_ref`` :224, ``se_ref`` :258, ``dw_se_ref`` :281,
``dwconv1d_causal_ref`` :76, ``dwconv1d_step_ref`` :92, and the paper's
loop oracles ``dwconv2d_loops_ref`` :47 and ``matmul_rtra_ref`` :314,
which only the tests call), with the same
rounding
points: every operand is upcast to fp32 explicitly (bf16 and fp16 products
never run in the narrow type), the fused intermediates stay fp32, and the
result is cast back to ``x.dtype`` once at the end.  Layouts are the
reference's: NHWC activations, DW filter (Hf, Wf, C), PW weight (Ci, Co).

These are the CPU path of the port, the oracle the CPU tests hold the
kernels' wrappers to, and the yardstick ``chip_smoke.py`` compares the
kernels against on the card.  Nothing on the main path calls them when the
tensors lie on a card.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.epilogue import apply_epilogue


def pad_same(x: torch.Tensor, hf: int, wf: int, stride: int) -> torch.Tensor:
    """Explicit SAME zero padding of an NHWC tensor, odd row and column at
    the bottom/right (``repro/kernels/ops.py:33-46``; ``F.conv2d``'s
    ``padding="same"`` differs and rejects stride > 1)."""
    return zero_pad(x, same_pads(x.shape[1], x.shape[2], hf, wf, stride))


def same_pads(hi: int, wi: int, hf: int, wf: int,
              stride: int) -> tuple[int, int, int, int]:
    """(top, left, bottom, right) zero rows and columns of SAME padding."""
    ph = max((-(-hi // stride) - 1) * stride + hf - hi, 0)
    pw = max((-(-wi // stride) - 1) * stride + wf - wi, 0)
    return ph // 2, pw // 2, ph - ph // 2, pw - pw // 2


def pads(hi: int, wi: int, hf: int, wf: int, stride: int,
         padding: str) -> Optional[tuple[int, int, int, int]]:
    """The (top, left, bottom, right) zero padding that a kernel which pads
    as it reads applies for ``padding`` ("same"), or None ("valid")."""
    if padding.lower() == "same":
        return same_pads(hi, wi, hf, wf, stride)
    if padding.lower() != "valid":
        raise ValueError(padding)
    return None


def zero_pad(x: torch.Tensor, pad: Optional[tuple]) -> torch.Tensor:
    """``x`` (NHWC) zero-padded by ``pad`` = (top, left, bottom, right),
    or ``x`` itself for None: what a kernel that pads as it reads sees."""
    if pad is None or not any(pad):
        return x
    top, left, bottom, right = pad
    return F.pad(x, (0, 0, left, right, top, bottom))


def apply_padding(x: torch.Tensor, hf: int, wf: int, stride: int,
                  padding: str) -> torch.Tensor:
    """``x`` padded for ``padding`` ("same" or "valid") so that a VALID
    conv of it gives the padded conv's output."""
    if padding.lower() == "same":
        return pad_same(x, hf, wf, stride)
    if padding.lower() != "valid":
        raise ValueError(padding)
    return x


def _dw_fp32(x: torch.Tensor, f: torch.Tensor, stride: int,
             padding: str) -> torch.Tensor:
    """fp32 depthwise conv, NHWC in and out."""
    hf, wf, c = f.shape
    xp = apply_padding(x.float(), hf, wf, stride, padding)
    y = F.conv2d(xp.permute(0, 3, 1, 2), f.float().permute(2, 0, 1)[:, None],
                 stride=stride, groups=c)
    return y.permute(0, 2, 3, 1).contiguous()


def dwconv2d_ref(x: torch.Tensor, f: torch.Tensor, *, stride: int = 1,
                 padding: str = "valid") -> torch.Tensor:
    """Depthwise conv. x: (B, Hi, Wi, C); f: (Hf, Wf, C) -> (B, Ho, Wo, C)."""
    if x.ndim != 4 or f.ndim != 3 or x.shape[-1] != f.shape[-1]:
        raise ValueError(f"dwconv2d shapes {tuple(x.shape)} {tuple(f.shape)}")
    return _dw_fp32(x, f, stride, padding).to(x.dtype)


def dwconv1d_causal_ref(x: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv. x: (B, L, D); f: (K, D) -> (B, L, D).

    out[b, l, d] = sum_k x[b, l - (K-1) + k, d] * f[k, d] (zero left pad),
    fp32 accumulation, one cast to ``x.dtype`` at the end."""
    if x.ndim != 3 or f.ndim != 2 or x.shape[-1] != f.shape[-1]:
        raise ValueError(f"dwconv1d shapes {tuple(x.shape)} {tuple(f.shape)}")
    k, length = f.shape[0], x.shape[1]
    acc = acc_dtype(x.dtype)
    xp = F.pad(x.to(acc), (0, 0, k - 1, 0))
    out = torch.zeros(x.shape, dtype=acc, device=x.device)
    for i in range(k):  # K is tiny (3..5): unrolled shifts
        out = out + xp[:, i:i + length, :] * f[i].to(acc)
    return out.to(x.dtype)


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The accumulation type of the plain versions: fp32, or fp64 for fp64
    operands (``torch.autograd.gradcheck``'s)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def dwconv1d_step_ref(state: torch.Tensor, x_t: torch.Tensor,
                      f: torch.Tensor) -> tuple:
    """One decode step. state: (B, K-1, D) past inputs; x_t: (B, D).

    Returns (new_state, y_t), y_t the causal conv output at this position
    in ``x_t.dtype``."""
    k = f.shape[0]
    window = torch.cat([state, x_t[:, None, :]], dim=1)  # (B, K, D)
    y = (window.float() * f.float()).sum(dim=1)          # contiguous (B, D)
    return (window[:, 1:, :] if k > 1 else state), y.to(x_t.dtype)


def dwconv2d_loops_ref(x: np.ndarray, f: np.ndarray, *,
                       stride: int = 1) -> np.ndarray:
    """The paper's Alg. 1 (the unoptimized five-nested-loop MAC), VALID
    padding, numpy, accumulated in float64: deliberately literal, the
    oracle of the oracle ``dwconv2d_ref``."""
    b, hi, wi, c = x.shape
    hf, wf, _ = f.shape
    ho = (hi - hf) // stride + 1
    wo = (wi - wf) // stride + 1
    out = np.zeros((b, ho, wo, c), dtype=np.float64)
    for bb in range(b):
        for l in range(ho):
            for k in range(wo):
                for i in range(c):
                    for n in range(hf):
                        for m in range(wf):
                            out[bb, l, k, i] += (
                                x[bb, l * stride + n, k * stride + m, i]
                                * f[n, m, i])
    return out.astype(x.dtype)


def matmul_rtra_ref(a: torch.Tensor, b: torch.Tensor, *,
                    block_k: int = 128) -> torch.Tensor:
    """The paper's Alg. 5 loop structure (A-stationary, k outermost): the
    BLAS/RTRA baseline, ``a @ b`` with the fp32 output tile read and
    written again at every ``block_k`` step of the reduction (the traffic
    flaw the paper's RTRD kernel removes).  A second oracle of
    ``pwconv_ref``, and the shape of ``intensity.pwconv_traffic_rtra``."""
    g, ci = a.shape
    if b.shape[0] != ci:
        raise ValueError(f"matmul_rtra_ref shapes {tuple(a.shape)} "
                         f"{tuple(b.shape)}")
    nk = max(1, -(-ci // block_k))
    out = torch.zeros((g, b.shape[1]), dtype=torch.float32, device=a.device)
    for k in range(nk):
        ks = slice(k * block_k, min((k + 1) * block_k, ci))
        out = out + a[:, ks].float() @ b[ks].float()
    return out.to(a.dtype)


def pwconv_ref(x: torch.Tensor, w: torch.Tensor, *,
               bias: Optional[torch.Tensor] = None,
               activation: Optional[str] = None) -> torch.Tensor:
    """Pointwise conv / GEMM. x: (..., Ci); w: (Ci, Co) -> (..., Co), fp32
    accumulation, bias and activation in fp32, one cast at the end."""
    y = torch.matmul(x.float(), w.float())
    y = apply_epilogue(y, None if bias is None else bias.float(), activation)
    return y.to(x.dtype)


def separable_fused_ref(
    x: torch.Tensor,
    dw_f: torch.Tensor,
    pw_w: torch.Tensor,
    dw_bias: Optional[torch.Tensor] = None,
    pw_bias: Optional[torch.Tensor] = None,
    residual: Optional[torch.Tensor] = None,
    *,
    expand_w: Optional[torch.Tensor] = None,
    expand_activation: Optional[str] = "relu6",
    stride: int = 1,
    padding: str = "valid",
    dw_activation: Optional[str] = "relu6",
    activation: Optional[str] = None,
) -> torch.Tensor:
    """The fused [PW-expand ->] DW -> PW block with fp32 intermediates:
    the expanded tensor and the DW output stay fp32 into the next product
    (the unfused composition rounds them to the activation dtype)."""
    y = x.float()
    if expand_w is not None:
        y = apply_epilogue(torch.matmul(y, expand_w.float()), None,
                           expand_activation)
    y = _dw_fp32(y, dw_f, stride, padding)
    if dw_bias is not None:
        y = y + dw_bias.float()
    y = apply_epilogue(y, None, dw_activation)
    out = torch.matmul(y, pw_w.float())
    out = apply_epilogue(out, None if pw_bias is None else pw_bias.float(),
                         activation)
    if residual is not None:
        out = out + residual.float()
    return out.to(x.dtype)


def _conv_fp32(x: torch.Tensor, f: torch.Tensor, stride: int,
               padding: str) -> torch.Tensor:
    """fp32 dense conv, NHWC in and out; f (Hf, Wf, Ci, Co)."""
    xp = apply_padding(x.float(), f.shape[0], f.shape[1], stride, padding)
    y = F.conv2d(xp.permute(0, 3, 1, 2), f.float().permute(3, 2, 0, 1),
                 stride=stride)
    return y.permute(0, 2, 3, 1).contiguous()


def conv2d_ref(x: torch.Tensor, f: torch.Tensor,
               bias: Optional[torch.Tensor] = None, *, stride: int = 1,
               padding: str = "valid",
               activation: Optional[str] = None) -> torch.Tensor:
    """Dense conv (the FusedMB stage). x (B, Hi, Wi, Ci); f (Hf, Wf, Ci, Co)
    -> (B, Ho, Wo, Co), fp32 accumulation, one cast at the end."""
    if x.ndim != 4 or f.ndim != 4 or x.shape[-1] != f.shape[2]:
        raise ValueError(f"conv2d shapes {tuple(x.shape)} {tuple(f.shape)}")
    y = apply_epilogue(_conv_fp32(x, f, stride, padding),
                       None if bias is None else bias.float(), activation)
    return y.to(x.dtype)


def fused_mbconv_ref(
    x: torch.Tensor,
    mb_f: torch.Tensor,
    pw_w: torch.Tensor,
    mb_bias: Optional[torch.Tensor] = None,
    pw_bias: Optional[torch.Tensor] = None,
    residual: Optional[torch.Tensor] = None,
    *,
    stride: int = 1,
    padding: str = "valid",
    mb_activation: Optional[str] = "relu6",
    activation: Optional[str] = None,
) -> torch.Tensor:
    """The fused-MBConv block: dense conv -> act -> PW-project, the conv
    output kept fp32 into the GEMM."""
    y = apply_epilogue(_conv_fp32(x, mb_f, stride, padding),
                       None if mb_bias is None else mb_bias.float(),
                       mb_activation)
    out = torch.matmul(y, pw_w.float())
    out = apply_epilogue(out, None if pw_bias is None else pw_bias.float(),
                         activation)
    if residual is not None:
        out = out + residual.float()
    return out.to(x.dtype)


def _se_gate(y: torch.Tensor, w1, b1, w2, b2, activation) -> torch.Tensor:
    """sigmoid(act(mean(y) @ w1 + b1) @ w2 + b2), (B, C), all fp32."""
    pooled = y.mean(dim=(1, 2))
    hid = apply_epilogue(torch.matmul(pooled, w1.float()), b1.float(),
                         activation)
    return torch.sigmoid(torch.matmul(hid, w2.float()) + b2.float())


def se_ref(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
           w2: torch.Tensor, b2: torch.Tensor, *,
           activation: str = "relu") -> torch.Tensor:
    """Squeeze-excite: global average pool -> FC-reduce (``activation``) ->
    FC-expand -> sigmoid -> channel scale.  x (B, H, W, C); w1 (C, Cse);
    w2 (Cse, C); fp32 inside."""
    xf = x.float()
    gate = _se_gate(xf, w1, b1, w2, b2, activation)
    return (xf * gate[:, None, None, :]).to(x.dtype)


def dw_se_ref(
    x: torch.Tensor,
    dw_f: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    dw_bias: Optional[torch.Tensor] = None,
    *,
    stride: int = 1,
    padding: str = "valid",
    dw_activation: Optional[str] = "relu6",
    se_activation: str = "relu",
) -> torch.Tensor:
    """The DW + SE-epilogue pass: the DW output stays fp32 into the pool,
    both gate FCs and the scale (the unfused composition rounds it to the
    activation dtype in between)."""
    y = _dw_fp32(x, dw_f, stride, padding)
    if dw_bias is not None:
        y = y + dw_bias.float()
    y = apply_epilogue(y, None, dw_activation)
    gate = _se_gate(y, w1, b1, w2, b2, se_activation)
    return (y * gate[:, None, None, :]).to(x.dtype)
