"""The slice as a whole on the CPU: the port's ``execute_network`` against
the JAX package's on the same converted weights and inputs.

Weights are seeded numpy draws laid into the reference's parameter
structure, biases included and nonzero (the reference's ``init_chain``
zero-inits them, which would hide a bias bug).  The reference runs its
plain XLA path with the runtime ladder off
(``KernelPolicy(impl="xla", on_failure="raise")``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import (BF16_REL_TOL, assert_match, rand,  # noqa: E402
                           rel_err, to_jax, to_torch)
from repro.core import chain as jchain  # noqa: E402
from repro.core import network as jnet  # noqa: E402
from repro.kernels.policy import DtypePolicy as JDtypePolicy  # noqa: E402
from repro.kernels.policy import KernelPolicy as JKernelPolicy  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import chain, network  # noqa: E402
from repro_torch.kernels.policy import DtypePolicy, KernelPolicy  # noqa: E402


def _numpy_params(jspec, seed=0):
    """The reference's parameter structure filled with seeded draws."""
    rng = np.random.default_rng(seed)
    out = []
    for block in jnet.init_network(jax.random.PRNGKey(seed), jspec):
        stages = []
        for st in block:
            d = {}
            for k, v in st.items():
                scale = {"w": v.shape[0] ** -0.5, "f": 1 / 3}.get(k, 0.1)
                d[k] = rand(rng, v.shape, scale)
            stages.append(d)
        out.append(stages)
    return out


def _jax_params(np_params, dtype):
    return [[{k: to_jax(v, dtype) for k, v in st.items()} for st in b]
            for b in np_params]


@pytest.mark.parametrize("fused", (None, False))
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("arch", ("v1", "v2"))
def test_execute_network_matches_reference(arch, dtype, fused):
    jspec = getattr(jnet, f"mobilenet_{arch}_spec")(0.25)
    spec = getattr(network, f"mobilenet_{arch}_spec")(0.25)
    np_params = _numpy_params(jspec)
    x = rand(np.random.default_rng(1), (2, 32, 32, spec.c_in))
    stream = None if dtype == "float32" else dtype
    jpol = JKernelPolicy(impl="xla", on_failure="raise", fused=fused,
                         dtype_policy=JDtypePolicy(stream=stream))
    want = jnet.execute_network(jspec, _jax_params(np_params, dtype),
                                to_jax(x), policy=jpol)
    params = convert.params_from_numpy(np_params, "cpu")
    if dtype == "bfloat16":
        params = network.cast_network_params(params, torch.bfloat16)
    got = network.execute_network(
        spec, params, to_torch(x),
        policy=KernelPolicy(fused=fused,
                            dtype_policy=DtypePolicy(stream=stream)))
    assert str(got.dtype) == f"torch.{dtype}"
    assert_match(got, want, dtype, bf16_tol=BF16_REL_TOL)
    if dtype == "bfloat16":
        exact = network.execute_network(
            spec, convert.params_from_numpy(np_params, "cpu"), to_torch(x),
            policy=KernelPolicy(fused=fused))
        assert rel_err(got, exact) <= BF16_REL_TOL


def test_out_pin_widens_only_the_last_block():
    jspec = jnet.mobilenet_v2_spec(0.25)
    spec = network.mobilenet_v2_spec(0.25)
    dp = DtypePolicy(stream="bfloat16", out="float32")
    plan = network.plan_network(spec, (1, 16, 16, 8),
                                policy=KernelPolicy(dtype_policy=dp))
    jplan = jnet.plan_network(
        jspec, (1, 16, 16, 8),
        policy=JKernelPolicy(on_failure="raise",
                             dtype_policy=JDtypePolicy("bfloat16",
                                                       "float32")))
    assert plan.block_dtypes == jplan.block_dtypes
    params = convert.params_from_numpy(_numpy_params(jspec), "cpu")
    y = network.execute_network(spec, params, torch.zeros((1, 16, 16, 8)),
                                policy=KernelPolicy(dtype_policy=dp))
    assert y.dtype == torch.float32


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_biased_inverted_residual_chain_matches_reference(dtype):
    """A V2-shaped chain with DW and projection biases (the MobileNet
    specs have none there) through the fused3 path and its unfused plan."""
    stages = (dict(features=48, activation="relu6"),
              dict(stride=1, activation="gelu", bias=True),
              dict(features=8, activation="silu", bias=True))
    jspec = jchain.SeparableSpec(stages=(
        jchain.PW(**stages[0]), jchain.DW(**stages[1]),
        jchain.PW(**stages[2])), residual="auto")
    spec = chain.SeparableSpec(stages=(
        chain.PW(**stages[0]), chain.DW(**stages[1]),
        chain.PW(**stages[2])), residual="auto")
    rng = np.random.default_rng(2)
    p = [{"w": rand(rng, (8, 48), 8 ** -0.5)},
         {"f": rand(rng, (3, 3, 48), 1 / 3), "b": rand(rng, (48,), 0.1)},
         {"w": rand(rng, (48, 8), 48 ** -0.5), "b": rand(rng, (8,), 0.1)}]
    x = rand(rng, (2, 9, 9, 8))
    for fused in (None, False):
        want = jchain.execute(
            jspec, [{k: to_jax(v, dtype) for k, v in d.items()} for d in p],
            to_jax(x, dtype),
            policy=JKernelPolicy(impl="xla", on_failure="raise",
                                 fused=fused))
        cp = chain.plan(spec, x.shape, policy=KernelPolicy(fused=fused))
        assert [s.kind for s in cp.segments] == (
            ["fused3"] if fused is None else ["pw", "dw", "pw"])
        got = chain.execute(
            spec, [{k: to_torch(v, dtype) for k, v in d.items()} for d in p],
            to_torch(x, dtype), policy=KernelPolicy(fused=fused))
        assert_match(got, want, dtype)


def test_network_plan_is_memoized_per_problem(monkeypatch):
    spec = network.mobilenet_v1_spec(0.25)
    params = network.init_network(spec, seed=3, device="cpu")
    calls = []
    real = network.plan_network
    monkeypatch.setattr(network, "plan_network",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    network.clear_network_cache()
    x = torch.randn((1, 16, 16, spec.c_in))
    y1 = network.execute_network(spec, params, x)
    y2 = network.execute_network(spec, params, x)
    network.execute_network(spec, params, torch.randn((2, 16, 16, spec.c_in)))
    assert len(calls) == 2
    torch.testing.assert_close(y1, y2, rtol=0, atol=0)


def test_network_module_forward_is_execute_network():
    spec = network.mobilenet_v2_spec(0.25)
    params = network.init_network(spec, seed=4, device="cpu")
    mod = network.NetworkModule(spec, params)
    x = torch.randn((1, 16, 16, spec.c_in))
    torch.testing.assert_close(mod(x), network.execute_network(spec, params,
                                                               x),
                               rtol=0, atol=0)
    assert all(not p.requires_grad for p in mod.parameters())
    assert sum(p.numel() for p in mod.parameters()) == sum(
        v.numel() for b in params for st in b for v in st.values())


def test_init_network_is_seeded_and_device_neutral():
    spec = network.mobilenet_v1_spec(0.25)
    a = network.init_network(spec, seed=5, device="cpu")
    b = network.init_network(spec, seed=5, device="cpu")
    for ba, bb in zip(a, b):
        for sa, sb in zip(ba, bb):
            for k in sa:
                torch.testing.assert_close(sa[k], sb[k], rtol=0, atol=0)
    assert float(a[0][0]["b"].abs().max()) == 0.0  # biases start at zero


def test_convert_keeps_layouts_and_bf16():
    w = (np.arange(12, dtype=np.float32).reshape(3, 4) - 6) / 8
    t = convert.tensor_from_numpy(np.asarray(jnp.asarray(w, jnp.bfloat16)),
                                  "cpu")
    assert t.dtype == torch.bfloat16 and t.shape == (3, 4)
    np.testing.assert_array_equal(t.float().numpy(), w)
