"""The paper's block shims (``repro_torch/core/separable.py``) and the
oracles (``ops.pad_same``, ``ref.dwconv2d_loops_ref``,
``ref.matmul_rtra_ref``) against the JAX package's, on the CPU, with inputs
made from a numpy seed; and the two oracles against the plain versions
they check."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_parity import FP32_TOL, as_f32, rand  # noqa: E402
from repro.core import separable as jsep  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import separable  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.policy import KernelPolicy  # noqa: E402

RNG = np.random.default_rng(23)


def _close(got, want):
    np.testing.assert_allclose(as_f32(got), as_f32(want), rtol=FP32_TOL,
                               atol=FP32_TOL)


def _separable_params(c_in, c_out, hf):
    return {"dw_filter": rand(RNG, (hf, hf, c_in), 1 / hf),
            "dw_bias": rand(RNG, (c_in,), 0.1),
            "pw_weight": rand(RNG, (c_in, c_out), c_in ** -0.5),
            "pw_bias": rand(RNG, (c_out,), 0.1)}


def _inverted_params(c_in, c_out, expand, hf):
    c_mid = c_in * expand
    return {"expand_w": rand(RNG, (c_in, c_mid), c_in ** -0.5),
            "dw_filter": rand(RNG, (hf, hf, c_mid), 1 / hf),
            "project_w": rand(RNG, (c_mid, c_out), c_mid ** -0.5)}


@pytest.mark.parametrize("fused", (None, False))
@pytest.mark.parametrize("c_in,c_out,stride,hf,act", [
    (16, 32, 1, 3, "relu6"), (24, 16, 2, 3, "relu6"), (8, 12, 1, 5, "relu"),
    (12, 12, 2, 5, None)])
def test_separable_block_matches_reference(c_in, c_out, stride, hf, act,
                                           fused):
    p = _separable_params(c_in, c_out, hf)
    x = rand(RNG, (2, 11, 13, c_in))
    want = jsep.separable_block({k: jnp.asarray(v) for k, v in p.items()},
                                jnp.asarray(x), stride=stride, activation=act)
    got = separable.separable_block(
        convert.dict_from_numpy(p, "cpu"), torch.from_numpy(x),
        stride=stride, activation=act, policy=KernelPolicy(fused=fused))
    _close(got, want)


@pytest.mark.parametrize("fused", (None, False))
@pytest.mark.parametrize("c_in,c_out,expand,stride,hf", [
    (8, 8, 6, 1, 3), (8, 16, 4, 2, 3), (12, 12, 3, 1, 5), (16, 24, 6, 2, 5)])
def test_inverted_residual_matches_reference(c_in, c_out, expand, stride, hf,
                                             fused):
    """Residual where the shapes allow (stride 1, c_in == c_out)."""
    p = _inverted_params(c_in, c_out, expand, hf)
    x = rand(RNG, (2, 10, 9, c_in))
    want = jsep.inverted_residual({k: jnp.asarray(v) for k, v in p.items()},
                                  jnp.asarray(x), stride=stride)
    got = separable.inverted_residual(
        convert.dict_from_numpy(p, "cpu"), torch.from_numpy(x),
        stride=stride, policy=KernelPolicy(fused=fused))
    _close(got, want)


def test_init_shapes_match_reference_and_default_to_the_card():
    import jax
    gen = torch.Generator().manual_seed(0)
    for init, jinit, args in (
            (separable.init_separable, jsep.init_separable, (16, 32, 5, 3)),
            (separable.init_inverted_residual, jsep.init_inverted_residual,
             (8, 16, 4, 5))):
        got = init(gen, *args, device="cpu")
        want = jinit(jax.random.PRNGKey(0), *args)
        assert {k: tuple(v.shape) for k, v in got.items()} == {
            k: tuple(v.shape) for k, v in want.items()}
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                init(gen, *args)


@pytest.mark.parametrize("h,w,hf,wf,stride", [
    (7, 9, 3, 3, 1), (8, 8, 3, 3, 2), (9, 6, 5, 5, 2), (5, 11, 5, 3, 3),
    (6, 6, 1, 1, 1)])
def test_pad_same_matches_reference(h, w, hf, wf, stride):
    x = rand(RNG, (2, h, w, 3))
    got = ops.pad_same(torch.from_numpy(x), hf, wf, stride)
    want = jops.pad_same(jnp.asarray(x), hf, wf, stride)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape,hf,stride", [
    ((1, 7, 7, 3), 3, 1), ((2, 9, 8, 4), 3, 2), ((1, 11, 10, 2), 5, 2),
    ((1, 6, 6, 5), 1, 1)])
def test_dwconv2d_loops_ref_matches_reference_and_dwconv2d_ref(shape, hf,
                                                               stride):
    """The paper's Alg. 1: the reference's loops bit for bit, and the
    plain version (VALID) within fp32 summation order."""
    x = rand(RNG, shape)
    f = rand(RNG, (hf, hf, shape[-1]), 1 / hf)
    got = ref.dwconv2d_loops_ref(x, f, stride=stride)
    np.testing.assert_array_equal(
        got, jref.dwconv2d_loops_ref(x, f, stride=stride))
    _close(ref.dwconv2d_ref(torch.from_numpy(x), torch.from_numpy(f),
                            stride=stride, padding="valid"), got)


@pytest.mark.parametrize("g,ci,co,block_k", [
    (5, 7, 3, 128), (16, 300, 24, 128), (9, 256, 17, 64), (3, 33, 8, 8)])
def test_matmul_rtra_ref_matches_reference_and_pwconv_ref(g, ci, co,
                                                          block_k):
    """The paper's Alg. 5 (A-stationary, k outermost): the reference's
    result, and ``pwconv_ref``'s, within fp32 summation order."""
    a, b = rand(RNG, (g, ci)), rand(RNG, (ci, co), ci ** -0.5)
    got = ref.matmul_rtra_ref(torch.from_numpy(a), torch.from_numpy(b),
                              block_k=block_k)
    _close(got, jref.matmul_rtra_ref(jnp.asarray(a), jnp.asarray(b),
                                     block_k=block_k))
    _close(got, ref.pwconv_ref(torch.from_numpy(a), torch.from_numpy(b)))
    assert got.dtype == torch.float32
