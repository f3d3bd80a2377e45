"""The port's kernel modules on the CPU, held against the JAX package.

Each wrapper (``repro_torch.kernels.{dwconv2d,pwconv,separable_fused,
fused_mbconv,se_epilogue}``) takes its plain version for a CPU tensor; the
same seeded numpy inputs go through the reference's Pallas kernels in
interpret mode where they run on this jax (``dwconv2d_pallas``,
``pwconv_pallas``, ``dw_se_pallas``) and through its ``kernels/ref.py``
oracles (``separable_fused_pallas`` and ``fused_mbconv_pallas`` need
``pl.unblocked``, which the installed jax lacks, so those blocks are held
against ``ref.separable_fused_ref`` and ``ref.fused_mbconv_ref``, as the
reference's own CPU tests do).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_parity import (as_f32, assert_match, rand, to_jax,  # noqa: E402
                           to_torch)
from repro.kernels import epilogue as jepi  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.dwconv2d import dwconv2d_pallas  # noqa: E402
from repro.kernels.pwconv import pwconv_pallas  # noqa: E402
from repro.kernels.se_epilogue import dw_se_pallas  # noqa: E402
from repro_torch.kernels import dwconv2d, ops, pwconv, ref  # noqa: E402
from repro_torch.kernels import fused_mbconv as fmb  # noqa: E402
from repro_torch.kernels import se_epilogue  # noqa: E402
from repro_torch.kernels import separable_fused as sf  # noqa: E402
from repro_torch.kernels.epilogue import ACTIVATIONS, apply_epilogue  # noqa: E402

DTYPES = ("float32", "bfloat16")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("act", (None,) + ACTIVATIONS)
def test_epilogue_matches_reference(act, dtype):
    rng = np.random.default_rng(0)
    y, b = rand(rng, (5, 7), 3.0), rand(rng, (7,))
    got = apply_epilogue(to_torch(y, dtype), to_torch(b, dtype), act)
    want = jepi.apply_epilogue(to_jax(y, dtype), to_jax(b, dtype), act)
    assert_match(got, want, dtype)


@pytest.mark.parametrize("hw,stride,hf", [((9, 11), 1, 3), ((112, 112), 2, 3),
                                          ((7, 8), 2, 5), ((5, 6), 3, 3)])
def test_pad_same_matches_reference(hw, stride, hf):
    x = np.arange(2 * hw[0] * hw[1] * 3, dtype=np.float32).reshape(
        2, *hw, 3)
    got = ref.pad_same(torch.from_numpy(x), hf, hf, stride)
    want = jops.pad_same(jnp.asarray(x), hf, hf, stride)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


DW_CASES = [(2, 9, 11, 12, 1, 3), (1, 8, 8, 20, 2, 3), (2, 7, 9, 6, 2, 5),
            (1, 10, 10, 5, 1, 3)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,h,w,c,stride,hf", DW_CASES)
def test_dwconv2d_cpu_path_matches_reference(b, h, w, c, stride, hf, dtype):
    rng = np.random.default_rng(1)
    x, f = rand(rng, (b, h, w, c)), rand(rng, (hf, hf, c), 1 / hf)
    xt = ref.pad_same(to_torch(x, dtype), hf, hf, stride)
    got = dwconv2d.dwconv2d(xt, to_torch(f, dtype), stride=stride)
    xj = jops.pad_same(to_jax(x, dtype), hf, hf, stride)
    pallas = dwconv2d_pallas(xj, to_jax(f, dtype), stride=stride,
                             interpret=True)
    oracle = jref.dwconv2d_ref(to_jax(x, dtype), to_jax(f, dtype),
                               stride=stride, padding="same")
    assert got.dtype == xt.dtype
    assert_match(got, pallas, dtype)
    assert_match(got, oracle, dtype)


def test_dwconv2d_out_dtype_widens_once():
    rng = np.random.default_rng(2)
    x, f = rand(rng, (1, 6, 6, 8)), rand(rng, (3, 3, 8))
    got = dwconv2d.dwconv2d(to_torch(x, "bfloat16"), to_torch(f, "bfloat16"),
                            out_dtype=torch.float32)
    want = dwconv2d_pallas(to_jax(x, "bfloat16"), to_jax(f, "bfloat16"),
                           interpret=True, out_dtype="float32")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,h,w,c,stride,hf", [
    (2, 9, 11, 12, 1, 3), (1, 12, 10, 8, 2, 5), (2, 13, 17, 6, 1, 9),
    (1, 20, 15, 5, 2, 9), (1, 14, 12, 7, 1, 11), (2, 23, 21, 4, 2, 11)])
def test_dwconv2d_pads_like_reference(b, h, w, c, stride, hf, dtype):
    """The wrapper on the unpadded input with SAME pads (as the lowering
    calls the kernel, which pads as it reads), at filters the kernel runs
    compiled (3x3, 5x5) and on its runtime-K path (9x9, 11x11), against the
    reference's ``impl="xla"`` op and ``dwconv2d_pallas`` in interpret
    mode."""
    rng = np.random.default_rng(12)
    x, f = rand(rng, (b, h, w, c)), rand(rng, (hf, hf, c), 1 / hf)
    pad = ref.same_pads(h, w, hf, hf, stride)
    got = dwconv2d.dwconv2d(to_torch(x, dtype), to_torch(f, dtype),
                            stride=stride, pad=pad)
    oracle = jops.dwconv2d(to_jax(x, dtype), to_jax(f, dtype), stride=stride,
                           padding="same", impl="xla")
    pallas = dwconv2d_pallas(jops.pad_same(to_jax(x, dtype), hf, hf, stride),
                             to_jax(f, dtype), stride=stride, interpret=True)
    assert_match(got, oracle, dtype)
    assert_match(got, pallas, dtype)
    assert_match(ops.dwconv2d(to_torch(x, dtype), to_torch(f, dtype),
                              stride=stride), oracle, dtype)


PW_CASES = [(37, 20, 50, "relu6", True), (64, 130, 70, "gelu", True),
            (5, 8, 3, "silu", False), (16, 33, 17, None, True),
            (9, 16, 24, "relu", True)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("g,ci,co,act,has_bias", PW_CASES)
def test_pwconv_cpu_path_matches_reference(g, ci, co, act, has_bias, dtype):
    rng = np.random.default_rng(3)
    x, w = rand(rng, (g, ci)), rand(rng, (ci, co), ci ** -0.5)
    b = rand(rng, (co,), 0.5) if has_bias else None
    got = pwconv.pwconv(to_torch(x, dtype), to_torch(w, dtype),
                        to_torch(b, dtype), activation=act)
    pallas = pwconv_pallas(to_jax(x, dtype), to_jax(w, dtype),
                           to_jax(b, dtype), activation=act, interpret=True)
    oracle = jref.pwconv_ref(to_jax(x, dtype), to_jax(w, dtype),
                             bias=to_jax(b, dtype), activation=act)
    assert_match(got, pallas, dtype)
    assert_match(got, oracle, dtype)


# (b, h, w, ci, c, co, stride, expand, residual, dw_act, act)
FUSED_CASES = [
    (2, 9, 9, 12, 12, 20, 1, False, False, "relu6", "relu6"),
    (1, 11, 7, 10, 10, 6, 2, False, False, "relu", "gelu"),
    (2, 8, 8, 16, 16, 16, 1, False, True, "silu", None),
    (2, 8, 8, 8, 48, 8, 1, True, True, "relu6", None),
    (1, 9, 9, 6, 36, 10, 2, True, False, "gelu", "relu"),
    (2, 7, 7, 5, 30, 5, 1, True, True, "silu", "silu"),
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize(
    "b,h,w,ci,c,co,stride,expand,residual,dw_act,act", FUSED_CASES)
def test_separable_fused_cpu_path_matches_reference(
        b, h, w, ci, c, co, stride, expand, residual, dw_act, act, dtype):
    rng = np.random.default_rng(4)
    x = rand(rng, (b, h, w, ci))
    ew = rand(rng, (ci, c), ci ** -0.5) if expand else None
    f, dwb = rand(rng, (3, 3, c), 1 / 3), rand(rng, (c,), 0.5)
    pw, pwb = rand(rng, (c, co), c ** -0.5), rand(rng, (co,), 0.5)
    res = x if residual else None
    kw = dict(stride=stride, dw_activation=dw_act, activation=act,
              expand_activation="relu6")
    t = lambda a: to_torch(a, dtype)  # noqa: E731
    j = lambda a: to_jax(a, dtype)  # noqa: E731
    got = sf.separable_fused(
        ref.pad_same(t(x), 3, 3, stride), t(f), t(pw), t(dwb), t(pwb),
        t(res), expand_w=t(ew), **kw)
    want = jref.separable_fused_ref(
        j(x), j(f), j(pw), j(dwb), j(pwb), j(res), expand_w=j(ew),
        padding="same", **kw)
    assert_match(got, want, dtype)
    via_ops = ops.separable_fused(t(x), t(f), t(pw), t(dwb), t(pwb), t(res),
                                  expand_w=t(ew), **kw)
    assert_match(via_ops, want, dtype)


def test_separable_fused_keeps_fp32_intermediates():
    """bf16 fused output rounds once: it sits closer to the fp32 answer
    than the unfused composition, which rounds the DW output to bf16."""
    rng = np.random.default_rng(5)
    x, f = rand(rng, (1, 8, 8, 64)), rand(rng, (3, 3, 64), 1 / 3)
    pw = rand(rng, (64, 32), 1 / 8)
    exact = sf.separable_fused(ref.pad_same(to_torch(x), 3, 3, 1),
                               to_torch(f), to_torch(pw))
    xb = ref.pad_same(to_torch(x, "bfloat16"), 3, 3, 1)
    fused = sf.separable_fused(xb, to_torch(f, "bfloat16"),
                               to_torch(pw, "bfloat16"))
    dw = apply_epilogue(dwconv2d.dwconv2d(xb, to_torch(f, "bfloat16")),
                        None, "relu6")
    unfused = pwconv.pwconv(dw.reshape(-1, 64), to_torch(pw, "bfloat16"))
    e_f = np.abs(as_f32(fused) - as_f32(exact)).max()
    e_u = np.abs(as_f32(unfused).reshape(exact.shape) - as_f32(exact)).max()
    assert e_f <= e_u


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("stride,k,padding,act", [
    (1, 3, "same", "relu6"), (2, 3, "same", None), (1, 5, "same", "silu"),
    (2, 5, "valid", "relu")])
def test_conv2d_ref_matches_reference(stride, k, padding, act, dtype):
    rng = np.random.default_rng(6)
    x = rand(rng, (2, 11, 9, 6))
    f, b = rand(rng, (k, k, 6, 10), (k * k * 6) ** -0.5), rand(rng, (10,))
    got = ref.conv2d_ref(to_torch(x, dtype), to_torch(f, dtype),
                         to_torch(b, dtype), stride=stride, padding=padding,
                         activation=act)
    want = jref.conv2d_ref(to_jax(x, dtype), to_jax(f, dtype),
                           to_jax(b, dtype), stride=stride, padding=padding,
                           activation=act)
    assert got.dtype == to_torch(x, dtype).dtype
    assert_match(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,h,w,c,c_se,act", [(2, 5, 7, 12, 3, "relu"),
                                              (1, 4, 4, 20, 5, "silu"),
                                              (3, 1, 1, 8, 1, "relu6")])
def test_se_ref_matches_reference(b, h, w, c, c_se, act, dtype):
    rng = np.random.default_rng(7)
    x = rand(rng, (b, h, w, c))
    w1, b1 = rand(rng, (c, c_se), c ** -0.5), rand(rng, (c_se,), 0.5)
    w2, b2 = rand(rng, (c_se, c), c_se ** -0.5), rand(rng, (c,), 0.5)
    args = (x, w1, b1, w2, b2)
    got = ref.se_ref(*(to_torch(a, dtype) for a in args), activation=act)
    want = jref.se_ref(*(to_jax(a, dtype) for a in args), activation=act)
    assert_match(got, want, dtype)


# (b, h, w, ci, c, co, stride, k, residual, mb_act, act)
FUSED_MB_CASES = [
    (2, 9, 9, 4, 24, 6, 2, 3, False, "relu6", None),
    (2, 8, 8, 6, 36, 6, 1, 3, True, "relu6", None),
    (1, 10, 7, 5, 20, 70, 1, 5, False, "silu", "relu"),
    (2, 7, 9, 3, 10, 3, 1, 5, True, "gelu", "silu"),
    (1, 11, 11, 8, 16, 12, 2, 5, False, "relu", "relu6"),
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,h,w,ci,c,co,stride,k,residual,mb_act,act",
                         FUSED_MB_CASES)
def test_fused_mbconv_cpu_path_matches_reference(
        b, h, w, ci, c, co, stride, k, residual, mb_act, act, dtype):
    rng = np.random.default_rng(8)
    x = rand(rng, (b, h, w, ci))
    f, fb = rand(rng, (k, k, ci, c), (k * k * ci) ** -0.5), rand(rng, (c,))
    pw, pwb = rand(rng, (c, co), c ** -0.5), rand(rng, (co,), 0.5)
    res = x if residual else None
    t = lambda a: to_torch(a, dtype)  # noqa: E731
    j = lambda a: to_jax(a, dtype)  # noqa: E731
    kw = dict(stride=stride, mb_activation=mb_act, activation=act)
    got = fmb.fused_mbconv(ref.pad_same(t(x), k, k, stride), t(f), t(pw),
                           t(fb), t(pwb), t(res), **kw)
    want = jref.fused_mbconv_ref(j(x), j(f), j(pw), j(fb), j(pwb), j(res),
                                 padding="same", **kw)
    assert got.dtype == t(x).dtype
    assert_match(got, want, dtype)
    via_ref = ref.fused_mbconv_ref(t(x), t(f), t(pw), t(fb), t(pwb), t(res),
                                   padding="same", **kw)
    assert_match(via_ref, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,h,w,ci,c,co,stride,k,residual", [
    (2, 10, 9, 6, 24, 8, 2, 3, False), (1, 8, 8, 4, 12, 4, 1, 3, True),
    (1, 13, 11, 3, 16, 10, 2, 9, False), (2, 9, 9, 5, 10, 5, 1, 11, True)])
def test_fused_mbconv_pads_like_reference(b, h, w, ci, c, co, stride, k,
                                          residual, dtype):
    """The wrapper on the unpadded input with SAME pads (the kernel pads as
    it reads), at 3x3 and at 9x9 and 11x11, against the reference's
    ``fused_mbconv_ref`` with SAME padding."""
    rng = np.random.default_rng(13)
    x = rand(rng, (b, h, w, ci))
    f, fb = rand(rng, (k, k, ci, c), (k * k * ci) ** -0.5), rand(rng, (c,))
    pw, pwb = rand(rng, (c, co), c ** -0.5), rand(rng, (co,), 0.5)
    res = x if residual else None
    t = lambda a: to_torch(a, dtype)  # noqa: E731
    j = lambda a: to_jax(a, dtype)  # noqa: E731
    kw = dict(stride=stride, mb_activation="relu6", activation="relu")
    got = fmb.fused_mbconv(t(x), t(f), t(pw), t(fb), t(pwb), t(res),
                           pad=ref.same_pads(h, w, k, k, stride), **kw)
    want = jref.fused_mbconv_ref(j(x), j(f), j(pw), j(fb), j(pwb), j(res),
                                 padding="same", **kw)
    assert got.dtype == t(x).dtype
    assert_match(got, want, dtype)


# (b, h, w, c, c_se, stride, k, dw_bias, dw_act, se_act)
DW_SE_CASES = [
    (2, 9, 9, 12, 3, 2, 3, True, "relu", "relu"),
    (1, 8, 8, 20, 5, 1, 3, False, "relu6", "relu"),
    (2, 7, 9, 18, 6, 2, 5, True, "relu", "silu"),
    (1, 6, 6, 7, 1, 1, 5, True, "silu", "relu6"),
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,h,w,c,c_se,stride,k,dw_bias,dw_act,se_act",
                         DW_SE_CASES)
def test_dw_se_cpu_path_matches_reference(b, h, w, c, c_se, stride, k,
                                          dw_bias, dw_act, se_act, dtype):
    rng = np.random.default_rng(9)
    x, f = rand(rng, (b, h, w, c)), rand(rng, (k, k, c), 1 / k)
    w1, b1 = rand(rng, (c, c_se), c ** -0.5), rand(rng, (c_se,), 0.5)
    w2, b2 = rand(rng, (c_se, c), c_se ** -0.5), rand(rng, (c,), 0.5)
    db = rand(rng, (c,), 0.5) if dw_bias else None
    gate = (w1, b1, w2, b2)
    kw = dict(stride=stride, dw_activation=dw_act, se_activation=se_act)
    got = se_epilogue.dw_se(
        to_torch(x, dtype), to_torch(f, dtype),
        *(to_torch(a, dtype) for a in gate), to_torch(db, dtype),
        pad=ref.same_pads(h, w, k, k, stride), **kw)
    pallas = dw_se_pallas(
        jops.pad_same(to_jax(x, dtype), k, k, stride), to_jax(f, dtype),
        *(to_jax(a, dtype) for a in gate), to_jax(db, dtype),
        interpret=True, **kw)
    oracle = jref.dw_se_ref(to_jax(x, dtype), to_jax(f, dtype),
                            *(to_jax(a, dtype) for a in gate),
                            to_jax(db, dtype), padding="same", **kw)
    assert got.dtype == to_torch(x, dtype).dtype
    assert_match(got, pallas, dtype)
    assert_match(got, oracle, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("pad,stride,k", [((1, 1, 2, 2), 2, 5),
                                          ((2, 0, 1, 3), 2, 3),
                                          ((0, 2, 3, 1), 1, 5)])
def test_dw_se_pads_as_it_reads(pad, stride, k, dtype):
    """The wrapper on the unpadded input with an asymmetric ``pad`` (SAME's
    at stride 2 on an even input, then two explicit ones) equals
    ``dw_se_pallas`` on the input zero-padded first."""
    rng = np.random.default_rng(12)
    c, c_se = 12, 3
    x, f = rand(rng, (2, 8, 10, c)), rand(rng, (k, k, c), 1 / k)
    gate = (rand(rng, (c, c_se), c ** -0.5), rand(rng, (c_se,), 0.5),
            rand(rng, (c_se, c), c_se ** -0.5), rand(rng, (c,), 0.5))
    db = rand(rng, (c,), 0.5)
    top, left, bottom, right = pad
    xp = np.pad(x, ((0, 0), (top, bottom), (left, right), (0, 0)))
    kw = dict(stride=stride, dw_activation="relu6", se_activation="relu")
    got = se_epilogue.dw_se(to_torch(x, dtype), to_torch(f, dtype),
                            *(to_torch(a, dtype) for a in gate),
                            to_torch(db, dtype), pad=pad, **kw)
    want = dw_se_pallas(to_jax(xp, dtype), to_jax(f, dtype),
                        *(to_jax(a, dtype) for a in gate), to_jax(db, dtype),
                        interpret=True, **kw)
    assert got.shape == want.shape
    assert_match(got, want, dtype)


def test_dw_se_out_dtype_widens_once():
    rng = np.random.default_rng(10)
    x, f = rand(rng, (2, 6, 6, 8)), rand(rng, (3, 3, 8), 1 / 3)
    gate = (rand(rng, (8, 2)), rand(rng, (2,)), rand(rng, (2, 8)),
            rand(rng, (8,)))
    got = se_epilogue.dw_se(to_torch(x, "bfloat16"), to_torch(f, "bfloat16"),
                            *(to_torch(a, "bfloat16") for a in gate),
                            out_dtype=torch.float32)
    want = dw_se_pallas(to_jax(x, "bfloat16"), to_jax(f, "bfloat16"),
                        *(to_jax(a, "bfloat16") for a in gate),
                        interpret=True, out_dtype="float32")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_fused_blocks_keep_fp32_intermediates():
    """bf16 fused-MBConv and DW + SE outputs round once: each is the bf16
    value nearest the exact answer for its bf16 operands, so it sits at
    least as close to that answer as the unfused composition, which rounds
    the conv or DW output to bf16 in between."""
    rng = np.random.default_rng(11)
    x = rand(rng, (2, 8, 8, 16))
    f4, pw = rand(rng, (3, 3, 16, 64), 1 / 12), rand(rng, (64, 16), 1 / 8)
    f3 = rand(rng, (3, 3, 16), 1 / 3)
    gate = [to_torch(a, "bfloat16") for a in (
        rand(rng, (16, 4), 0.25), rand(rng, (4,), 0.1),
        rand(rng, (4, 16), 0.5), rand(rng, (16,), 0.1))]
    xb = ref.pad_same(to_torch(x, "bfloat16"), 3, 3, 1)
    f4b, pwb = to_torch(f4, "bfloat16"), to_torch(pw, "bfloat16")
    f3b = to_torch(f3, "bfloat16")
    f32 = lambda ts: [t.float() for t in ts]  # noqa: E731
    cases = [
        (fmb.fused_mbconv(*f32((xb, f4b, pwb))),
         fmb.fused_mbconv(xb, f4b, pwb),
         pwconv.pwconv(ref.conv2d_ref(xb, f4b, activation="relu6")
                       .reshape(-1, 64), pwb).reshape(2, 8, 8, 16)),
        (se_epilogue.dw_se(*f32([xb, f3b] + gate)),
         se_epilogue.dw_se(xb, f3b, *gate),
         ref.se_ref(apply_epilogue(dwconv2d.dwconv2d(xb, f3b), None,
                                   "relu6"), *gate)),
    ]
    for exact, fused, unfused in cases:
        e_f = np.abs(as_f32(fused) - as_f32(exact)).max()
        e_u = np.abs(as_f32(unfused) - as_f32(exact)).max()
        assert 0 < e_u and e_f <= e_u


def test_wrappers_refuse_other_devices():
    x = torch.empty((1, 4, 4, 4), device="meta")
    f = torch.empty((3, 3, 4), device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        dwconv2d.dwconv2d(x, f)
    with pytest.raises(ValueError, match="CUDA tensors"):
        pwconv.pwconv(x.reshape(16, 4), f.reshape(9, 4)[:4])
    with pytest.raises(ValueError, match="CUDA tensors"):
        sf.separable_fused(x, f, torch.empty((4, 4), device="meta"))


def test_new_wrappers_refuse_other_devices():
    m = lambda *shape: torch.empty(shape, device="meta")  # noqa: E731
    with pytest.raises(ValueError, match="CUDA tensors"):
        fmb.fused_mbconv(m(1, 4, 4, 4), m(3, 3, 4, 8), m(8, 4))
    with pytest.raises(ValueError, match="CUDA tensors"):
        se_epilogue.dw_se(m(1, 4, 4, 4), m(3, 3, 4), m(4, 2), m(2), m(2, 4),
                          m(4))


def test_new_wrappers_check_shapes():
    z = torch.zeros
    with pytest.raises(ValueError, match="fused_mbconv shapes"):
        fmb.fused_mbconv(z(1, 6, 6, 4), z(3, 3, 5, 8), z(8, 4))
    with pytest.raises(ValueError, match="residual"):
        fmb.fused_mbconv(z(1, 6, 6, 4), z(3, 3, 4, 8), z(8, 4),
                         residual=z(1, 6, 6, 4))
    with pytest.raises(ValueError, match="dw_se shapes"):
        se_epilogue.dw_se(z(1, 6, 6, 4), z(3, 3, 4), z(4, 2), z(2),
                          z(4, 2), z(4))


def test_impl_cuda_on_cpu_tensor_raises():
    x = torch.zeros((1, 4, 4, 4))
    with pytest.raises(ValueError, match="impl='cuda'"):
        ops.dwconv2d(x, torch.zeros((3, 3, 4)), impl="cuda")
