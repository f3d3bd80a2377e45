"""The port's kernel modules on the CPU, held against the JAX package.

Each wrapper (``repro_torch.kernels.{dwconv2d,pwconv,separable_fused}``)
takes its plain version for a CPU tensor; the same seeded numpy inputs go
through the reference's Pallas kernels in interpret mode where they run on
this jax (``dwconv2d_pallas``, ``pwconv_pallas``) and through its
``kernels/ref.py`` oracles (``separable_fused_pallas`` needs
``pl.unblocked``, which the installed jax lacks, so the fused block is held
against ``ref.separable_fused_ref``, as the reference's own CPU tests do).
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
from repro_torch.kernels import dwconv2d, ops, pwconv, ref  # noqa: E402
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


def test_wrappers_refuse_other_devices():
    x = torch.empty((1, 4, 4, 4), device="meta")
    f = torch.empty((3, 3, 4), device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        dwconv2d.dwconv2d(x, f)
    with pytest.raises(ValueError, match="CUDA tensors"):
        pwconv.pwconv(x.reshape(16, 4), f.reshape(9, 4)[:4])
    with pytest.raises(ValueError, match="CUDA tensors"):
        sf.separable_fused(x, f, torch.empty((4, 4), device="meta"))


def test_impl_cuda_on_cpu_tensor_raises():
    x = torch.zeros((1, 4, 4, 4))
    with pytest.raises(ValueError, match="impl='cuda'"):
        ops.dwconv2d(x, torch.zeros((3, 3, 4)), impl="cuda")
