"""The slice as a whole on the CPU: the port's ``execute_network`` against
the JAX package's on the same converted weights and inputs.

Weights are seeded numpy draws laid into the reference's parameter
structure, biases included and nonzero (the reference's ``init_chain``
zero-inits them, which would hide a bias bug); filters are scaled by their
fan-in.  The reference runs its
plain XLA path with the runtime ladder off
(``KernelPolicy(impl="xla", on_failure="raise")``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import (BF16_REL_TOL, SPECS, assert_match,  # noqa: E402
                           rand, rel_err, to_jax, to_torch)
from repro.core import chain as jchain  # noqa: E402
from repro.core import network as jnet  # noqa: E402
from repro.kernels.policy import DtypePolicy as JDtypePolicy  # noqa: E402
from repro.kernels.policy import KernelPolicy as JKernelPolicy  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import chain, network  # noqa: E402
from repro_torch.kernels.policy import DtypePolicy, KernelPolicy  # noqa: E402

#: The fused segment kind each network's default plan must hold at the
#: test size (so that the test runs the new kernels' paths).
FUSED_KIND = {"v1": "fused2", "v2": "fused3", "mnasnet": "dw_se",
              "lite0": "fusedmb"}


def _scale(name, shape):
    if name in ("w", "w1", "w2"):
        return shape[0] ** -0.5
    if name == "f":
        return float(np.prod(shape[:-1])) ** -0.5 if len(shape) == 4 else 1 / 3
    return 0.1


def _numpy_params(jspec, seed=0):
    """The reference's parameter structure filled with seeded draws."""
    rng = np.random.default_rng(seed)
    out = []
    for block in jnet.init_network(jax.random.PRNGKey(seed), jspec):
        stages = []
        for st in block:
            d = {}
            for k, v in st.items():
                d[k] = rand(rng, v.shape, _scale(k, v.shape))
            stages.append(d)
        out.append(stages)
    return out


def _jax_params(np_params, dtype):
    return [[{k: to_jax(v, dtype) for k, v in st.items()} for st in b]
            for b in np_params]


@pytest.mark.parametrize("fused", (None, False))
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("arch", tuple(SPECS))
def test_execute_network_matches_reference(arch, dtype, fused):
    jspec = getattr(jnet, SPECS[arch])(0.25)
    spec = getattr(network, SPECS[arch])(0.25)
    np_params = _numpy_params(jspec)
    x = rand(np.random.default_rng(1), (2, 32, 32, spec.c_in))
    hist = network.plan_network(spec, x.shape, policy=KernelPolicy(
        fused=fused)).segment_histogram()
    assert (FUSED_KIND[arch] in hist) == (fused is None)
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
    if dtype == "float32":
        assert rel_err(got, want) <= 2e-5
    else:
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


# (builder, c_in, c_out, stride, k, biased): chains with the biases the
# network specs leave out (FusedMB conv bias, DW bias before the SE gate)
NEW_CHAINS = [("fused_mbconv_spec", 8, 8, 1, 3, True),
              ("fused_mbconv_spec", 6, 12, 2, 5, False),
              ("mbconv_se_spec", 8, 8, 1, 3, True),
              ("mbconv_se_spec", 8, 16, 2, 5, False)]


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("builder,c_in,c_out,stride,k,biased", NEW_CHAINS)
def test_new_chains_match_reference(builder, c_in, c_out, stride, k, biased,
                                    dtype):
    """The MBConv-SE and fused-MBConv chains, biased where the spec allows,
    through their fused segment and the fused=False plan."""
    def build(mod):
        spec = getattr(mod, builder)(c_in, c_out, stride=stride, hf=k)
        if not biased:
            return spec
        stages = list(spec.stages)
        stages[0 if builder == "fused_mbconv_spec" else 1] = (
            dataclasses.replace(stages[0 if builder == "fused_mbconv_spec"
                                       else 1], bias=True))
        return dataclasses.replace(spec, stages=tuple(stages))

    jspec, spec = build(jchain), build(chain)
    rng = np.random.default_rng(3)
    p = [{k2: rand(rng, v.shape, _scale(k2, v.shape)) for k2, v in d.items()}
         for d in jchain.init_chain(jax.random.PRNGKey(0), jspec, c_in)]
    for d in p:
        for k2 in d:
            if k2.startswith("b"):
                d[k2] = rand(rng, d[k2].shape, 0.3)
    x = rand(rng, (2, 9, 9, c_in))
    fused_kind = "fusedmb" if builder == "fused_mbconv_spec" else "dw_se"
    for fused in (None, False):
        want = jchain.execute(
            jspec, [{k2: to_jax(v, dtype) for k2, v in d.items()} for d in p],
            to_jax(x, dtype),
            policy=JKernelPolicy(impl="xla", on_failure="raise",
                                 fused=fused))
        cp = chain.plan(spec, x.shape, policy=KernelPolicy(fused=fused))
        kinds = [s.kind for s in cp.segments]
        assert (fused_kind in kinds) == (fused is None)
        got = chain.execute(
            spec, [{k2: to_torch(v, dtype) for k2, v in d.items()}
                   for d in p],
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


def test_convert_carries_fused_mb_and_se_leaves_unchanged():
    """The 4-D FusedMB filter and the SE leaves cross over with the
    reference's layouts and values, and the port's chains accept them."""
    for name in ("efficientnet_lite0_spec", "mnasnet_a1_spec"):
        jspec = getattr(jnet, name)(0.25)
        np_params = _numpy_params(jspec, seed=6)
        params = convert.params_from_numpy(np_params, "cpu")
        seen = set()
        for jb, b, spec in zip(np_params, params, jspec.blocks):
            for js, st, stage in zip(jb, b, spec.stages):
                assert set(st) == set(js)
                for k, v in js.items():
                    assert tuple(st[k].shape) == v.shape
                    np.testing.assert_array_equal(st[k].numpy(), v)
                seen.add((type(stage).__name__, tuple(sorted(js))))
        assert (("FusedMB", ("f",)) in seen) or (
            ("SE", ("b1", "b2", "w1", "w2")) in seen)
    lite = network.efficientnet_lite0_spec(0.25)
    mine = network.init_network(lite, seed=0, device="cpu")
    assert mine[1][0]["f"].shape == (3, 3, 8, 48)
    mnas = network.mnasnet_a1_spec(0.25)
    se = network.init_network(mnas, seed=0, device="cpu")[3][2]
    assert {k: tuple(v.shape) for k, v in se.items()} == {
        "w1": (24, 2), "b1": (2,), "w2": (2, 24), "b2": (24,)}


def test_convert_keeps_layouts_and_bf16():
    w = (np.arange(12, dtype=np.float32).reshape(3, 4) - 6) / 8
    t = convert.tensor_from_numpy(np.asarray(jnp.asarray(w, jnp.bfloat16)),
                                  "cpu")
    assert t.dtype == torch.bfloat16 and t.shape == (3, 4)
    np.testing.assert_array_equal(t.float().numpy(), w)
