"""Lower a ChainPlan onto kernels: the execute half of spec -> plan -> run.

Counterpart of ``repro/kernels/lowering.py``:

* ``fused3`` -> ``separable_fused`` with ``expand_w`` (one pass for the
  whole inverted residual);
* ``fused2`` -> ``separable_fused`` (DW -> PW in one pass);
* ``fusedmb`` -> ``fused_mbconv`` (dense conv -> PW-project in one pass);
* ``dw_se`` -> ``dw_se`` (DW with the squeeze-excite gate as its epilogue:
  a pooling pass and a scaling pass over many CTAs an image);
* ``pw`` / ``dw`` -> the standalone ``pwconv`` / ``dwconv2d`` kernels;
* ``se`` -> an fp32 mean, the two gate FCs as two ``pwconv`` launches at
  ``G = B`` rows, and the sigmoid scale in PyTorch (the reference composes
  it the same way around its ``pwconv``);
* ``mb`` -> the plain dense conv (``ref.conv2d_ref``) on every impl, as
  the reference runs XLA's conv there: no kernel, no launch counter;
* with ``impl="torch"`` every segment runs its plain version
  (``kernels/ref.py``), fused segments with the same fp32 intermediates.

Every segment runs at exactly the blocks its ``ChainSegment.plan`` carries.
The dtype policy is applied here, once per chain: operands are cast to the
stream dtype, the LAST kernel stores at the policy's ``out`` dtype (unless
the residual is a separate add), and a ``dw`` segment's kernel stores at
the stream dtype with its bias and activation applied after it, in the
stream dtype — which is where bf16 rounding differs between the fused and
unfused plans, exactly as in the reference.

Each kernel pass, its plain version included, runs inside a kernel span
(``kernels/spans.py``), as the kernel wrappers mark theirs: the static
verifier's trace audit (``analysis/trace_audit.py``) counts the passes
and tells in-kernel ops from the glue between them.

Before each segment dispatches, its fault-injection point is checked
(:data:`_INJECT`, ``runtime/faultinject.py``).  A failure the runtime's
whitelist recognizes (``runtime/failures.classify``) is re-raised tagged
with its segment, so that the ladder knows which rung to quarantine; any
other exception propagates untouched.  Nothing here catches a failure to
run something else in its place: that is the ladder's job, and only under
``KernelPolicy(on_failure="degrade")``.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.blocking import ChainPlan
from repro_torch.kernels.dwconv2d import dwconv2d
from repro_torch.kernels.epilogue import apply_epilogue
from repro_torch.kernels.fused_mbconv import fused_mbconv
from repro_torch.kernels.policy import DEFAULT_POLICY, KernelPolicy
from repro_torch.kernels.pwconv import pwconv
from repro_torch.kernels.se_epilogue import dw_se
from repro_torch.kernels.spans import span
from repro_torch.kernels.separable_fused import separable_fused
from repro_torch.runtime import failures, faultinject

#: Per-stage parameter leaves, the reference's layouts: PW ``{"w": (Ci,
#: Co)[, "b": (Co,)]}``, DW ``{"f": (Hf, Wf, C)[, "b": (C,)]}``, SE
#: ``{"w1": (C, Cse), "b1": (Cse,), "w2": (Cse, C), "b2": (C,)}``, FusedMB
#: ``{"f": (Hf, Wf, Ci, C)[, "b": (C,)]}``.
PARAM_KEYS = {"pw": ("w", "b"), "dw": ("f", "b"),
              "se": ("w1", "b1", "w2", "b2"), "mb": ("f", "b")}

#: Fault-injection point per segment kind, checked before each dispatch;
#: fused2 and fused3 share one point because they share the kernel, as do
#: fusedmb/mb and dw_se/se.
_INJECT = {"fused3": "lowering:separable_fused",
           "fused2": "lowering:separable_fused",
           "fusedmb": "lowering:fused_mbconv",
           "mb": "lowering:fused_mbconv",
           "dw_se": "lowering:se_epilogue",
           "se": "lowering:se_epilogue",
           "pw": "lowering:pwconv",
           "dw": "lowering:dwconv2d"}


def _cast(a, dtype):
    return None if a is None else a.to(dtype)


def _run_fused(seg, stages, params, y, res, *, impl, stream_dtype,
               out_dtype):
    if seg.kind == "fused3":
        i_ex, i_dw, i_pw = seg.stages
        expand_w = params[i_ex]["w"].to(stream_dtype)
        expand_act = stages[i_ex].activation
    else:
        i_dw, i_pw = seg.stages
        expand_w, expand_act = None, None
    d, proj = stages[i_dw], stages[i_pw]
    dw_f = params[i_dw]["f"].to(stream_dtype)
    dw_b = _cast(params[i_dw].get("b"), stream_dtype)
    pw_w = params[i_pw]["w"].to(stream_dtype)
    pw_b = _cast(params[i_pw].get("b"), stream_dtype)
    if impl == "torch":
        with span("separable_fused"):
            return ref.separable_fused_ref(
                y, dw_f, pw_w, dw_b, pw_b, res, expand_w=expand_w,
                expand_activation=expand_act, stride=d.stride,
                padding=d.padding, dw_activation=d.activation,
                activation=proj.activation).to(out_dtype)
    # the kernel pads as it reads: no padded copy of y is made
    pad = ref.pads(y.shape[1], y.shape[2], d.hf, d.wf, d.stride,
                   d.padding)
    p = seg.plan
    return separable_fused(
        y, dw_f, pw_w, dw_b, pw_b, res, expand_w=expand_w,
        expand_activation=expand_act, stride=d.stride,
        dw_activation=d.activation, activation=proj.activation, pad=pad,
        slab_h=p.slab_h, block_c=p.block_c, block_co=p.block_co,
        cluster=p.cluster, out_dtype=out_dtype)


def _run_fused_mb(seg, stages, params, y, res, *, impl, stream_dtype,
                  out_dtype):
    i_mb, i_pw = seg.stages
    mb, proj = stages[i_mb], stages[i_pw]
    mb_f = params[i_mb]["f"].to(stream_dtype)
    mb_b = _cast(params[i_mb].get("b"), stream_dtype)
    pw_w = params[i_pw]["w"].to(stream_dtype)
    pw_b = _cast(params[i_pw].get("b"), stream_dtype)
    kw = dict(stride=mb.stride, mb_activation=mb.activation,
              activation=proj.activation)
    if impl == "torch":
        with span("fused_mbconv"):
            return ref.fused_mbconv_ref(y, mb_f, pw_w, mb_b, pw_b, res,
                                        padding=mb.padding, **kw
                                        ).to(out_dtype)
    # the kernel pads as it reads: no padded copy of y is made
    pad = ref.pads(y.shape[1], y.shape[2], mb.hf, mb.wf, mb.stride,
                   mb.padding)
    p = seg.plan
    return fused_mbconv(y, mb_f, pw_w, mb_b, pw_b, res, pad=pad,
                        slab_h=p.slab_h, tile_w=p.tile_w,
                        block_c=p.block_c, block_co=p.block_co,
                        cluster=p.cluster, out_dtype=out_dtype, **kw)


def _se_params(p, stream_dtype):
    return tuple(p[k].to(stream_dtype) for k in PARAM_KEYS["se"])


def _run_dw_se(seg, stages, params, y, *, impl, stream_dtype, out_dtype):
    i_dw, i_se = seg.stages
    d, se = stages[i_dw], stages[i_se]
    dw_f = params[i_dw]["f"].to(stream_dtype)
    dw_b = _cast(params[i_dw].get("b"), stream_dtype)
    gate = _se_params(params[i_se], stream_dtype)
    kw = dict(stride=d.stride, dw_activation=d.activation,
              se_activation=se.activation)
    if impl == "torch":
        with span("dw_se"):
            return ref.dw_se_ref(y, dw_f, *gate, dw_b, padding=d.padding,
                                 **kw).to(out_dtype)
    # the kernel pads as it reads: no padded copy of y is made
    p = seg.plan
    return dw_se(y, dw_f, *gate, dw_b,
                 pad=ref.pads(y.shape[1], y.shape[2], d.hf, d.wf, d.stride,
                              d.padding),
                 slab_h=p.slab_h, tile_w=p.tile_w, block_c=p.block_c,
                 out_dtype=out_dtype, **kw)


def _run_se(st, p, y, *, impl, stream_dtype, out_dtype):
    """Standalone SE: pool in fp32, the two FCs as ``pwconv`` at G = B
    rows (stored at the stream width), then the sigmoid scale."""
    w1, b1, w2, b2 = _se_params(p, stream_dtype)
    pooled = y.float().mean(dim=(1, 2)).to(stream_dtype)
    fc = _plain_pwconv if impl == "torch" else pwconv
    hid = fc(pooled, w1, bias=b1, activation=st.activation)
    pre = fc(hid, w2, bias=b2)
    gate = torch.sigmoid(pre.float()).to(stream_dtype)
    return (y * gate[:, None, None, :]).to(out_dtype)


def _run_mb(st, p, y, *, stream_dtype, out_dtype):
    """Standalone dense conv: the plain ``F.conv2d`` on every impl."""
    return ref.conv2d_ref(y, p["f"].to(stream_dtype),
                          _cast(p.get("b"), stream_dtype), stride=st.stride,
                          padding=st.padding,
                          activation=st.activation).to(out_dtype)


def _plain_pwconv(x, w, bias=None, activation=None):
    """``pwconv``'s plain version as the lowering calls it: one kernel
    pass's span."""
    with span("pwconv"):
        return ref.pwconv_ref(x, w, bias=bias, activation=activation)


def _run_pw(seg, st, p, y, policy, *, impl, stream_dtype, out_dtype):
    w = p["w"].to(stream_dtype)
    b = _cast(p.get("b"), stream_dtype)
    if impl == "torch":
        with span("pwconv"):
            return ref.pwconv_ref(y, w, bias=b,
                                  activation=st.activation).to(out_dtype)
    lead = y.shape[:-1]
    out = pwconv(y.reshape(-1, y.shape[-1]), w, b, activation=st.activation,
                 variant=seg.plan.variant,
                 block_g=policy.block_g or seg.plan.block_g,
                 block_co=policy.block_co or seg.plan.block_co,
                 block_ci=policy.block_ci or seg.plan.block_c,
                 out_dtype=out_dtype)
    return out.reshape(*lead, w.shape[1])


def _run_dw(seg, st, p, y, *, impl, stream_dtype):
    f = p["f"].to(stream_dtype)
    if impl == "torch":
        with span("dwconv2d"):
            y = ref.dwconv2d_ref(y, f, stride=st.stride, padding=st.padding)
    else:
        # the kernel pads as it reads: no padded copy of y is made
        q = seg.plan
        y = dwconv2d(y, f, stride=st.stride,
                     pad=ref.pads(y.shape[1], y.shape[2], st.hf, st.wf,
                                  st.stride, st.padding),
                     block_c=q.block_c, slab_h=q.slab_h, tile_w=q.tile_w)
    return apply_epilogue(y, _cast(p.get("b"), stream_dtype), st.activation)


def _run_segment(seg, stages, params, y, seg_res, policy, *, impl,
                 stream_dtype, out_dtype, last):
    """One segment's kernel pass (its plain version with ``impl="torch"``),
    after its fault-injection point."""
    faultinject.check(_INJECT[seg.kind])
    i = seg.stages[0]
    kw = dict(impl=impl, stream_dtype=stream_dtype)
    if seg.kind in ("fused3", "fused2"):
        return _run_fused(seg, stages, params, y, seg_res,
                          out_dtype=out_dtype, **kw)
    if seg.kind == "fusedmb":
        return _run_fused_mb(seg, stages, params, y, seg_res,
                             out_dtype=out_dtype, **kw)
    if seg.kind == "dw_se":
        return _run_dw_se(seg, stages, params, y, out_dtype=out_dtype, **kw)
    if seg.kind == "pw":
        return _run_pw(seg, stages[i], params[i], y, policy,
                       out_dtype=out_dtype, **kw)
    if seg.kind == "se":
        return _run_se(stages[i], params[i], y, out_dtype=out_dtype, **kw)
    if seg.kind == "mb":
        return _run_mb(stages[i], params[i], y, stream_dtype=stream_dtype,
                       out_dtype=out_dtype)
    y = _run_dw(seg, stages[i], params[i], y, **kw)  # "dw"
    return y.to(out_dtype) if last else y


def lower(spec, chain_plan: ChainPlan,
          policy: KernelPolicy = DEFAULT_POLICY,
          ) -> Callable[[Sequence[dict], torch.Tensor], torch.Tensor]:
    """Map a planned chain onto kernels; returns ``run(params, x)``.

    ``params`` is a sequence of per-stage dicts aligned with
    ``spec.stages`` (:data:`PARAM_KEYS`).  The residual is the chain input,
    folded into the final fused kernel when ``chain_plan.residual_fused``,
    else added as a separate op.
    """
    stages = spec.stages
    segments = chain_plan.segments
    dp = policy.dtype_policy

    def run(params: Sequence[dict], x: torch.Tensor) -> torch.Tensor:
        if len(params) != len(stages):
            raise ValueError(f"{len(params)} param dicts for "
                             f"{len(stages)} stages")
        impl = policy.resolved(x.device)
        sdt = dp.stream_dtype(x.dtype)
        odt = dp.out_dtype(x.dtype)
        y = x.to(sdt)
        res = y if chain_plan.residual else None
        sep_res = chain_plan.residual and not chain_plan.residual_fused
        for si, seg in enumerate(segments):
            last = si == len(segments) - 1
            k_out = odt if (last and not sep_res) else sdt
            seg_res = res if (chain_plan.residual_fused and last) else None
            try:
                y = _run_segment(seg, stages, params, y, seg_res, policy,
                                 impl=impl, stream_dtype=sdt, out_dtype=k_out,
                                 last=last)
            except Exception as e:
                # tag a recognized failure with the segment that raised it
                # (the ladder keys its quarantine decision on this); any
                # other exception propagates untouched
                f = failures.classify(e, segment_kind=seg.kind,
                                      segment_index=si,
                                      stage_indices=seg.stages)
                if f is None or f is e:
                    raise
                raise f from e
        if sep_res:
            y = (y + res).to(odt)
        return y

    return run
