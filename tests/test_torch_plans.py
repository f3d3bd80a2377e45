"""The port's planner against the JAX package's: the same segment kinds at
every MobileNet V1/V2 block, and the Hopper tile planner's own contract."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import network as jnet  # noqa: E402
from repro.kernels.policy import DtypePolicy as JDtypePolicy  # noqa: E402
from repro.kernels.policy import KernelPolicy as JKernelPolicy  # noqa: E402
from repro_torch.core import network  # noqa: E402
from repro_torch.kernels import blocking  # noqa: E402
from repro_torch.kernels.policy import DtypePolicy, KernelPolicy  # noqa: E402


def _kinds(nplan):
    return [tuple(s.kind for s in p.segments) for p in nplan.plans]


@pytest.mark.parametrize("fused", (None, False))
@pytest.mark.parametrize("stream", (None, "bfloat16"))
@pytest.mark.parametrize("batch", (1, 8))
@pytest.mark.parametrize("arch", ("v1", "v2"))
def test_segment_kinds_match_reference(arch, batch, stream, fused):
    jspec = getattr(jnet, f"mobilenet_{arch}_spec")()
    spec = getattr(network, f"mobilenet_{arch}_spec")()
    shape = (batch, 112, 112, spec.c_in)
    jplan = jnet.plan_network(
        jspec, shape, dtype=jnp.float32,
        policy=JKernelPolicy(fused=fused, on_failure="raise",
                             dtype_policy=JDtypePolicy(stream=stream)))
    plan = network.plan_network(
        spec, shape, dtype=torch.float32,
        policy=KernelPolicy(fused=fused,
                            dtype_policy=DtypePolicy(stream=stream)))
    assert _kinds(plan) == _kinds(jplan)
    assert [p.residual for p in plan.plans] == [p.residual
                                                for p in jplan.plans]
    assert [p.residual_fused for p in plan.plans] == [
        p.residual_fused for p in jplan.plans]
    assert plan.block_shapes == jplan.block_shapes
    assert plan.block_dtypes == jplan.block_dtypes
    assert plan.out_shape == jplan.out_shape
    want = {("v1", None): {"fused2": 13}, ("v1", False): {"dw": 13, "pw": 13},
            ("v2", None): {"fused2": 1, "fused3": 16},
            ("v2", False): {"dw": 17, "pw": 33}}[(arch, fused)]
    assert plan.segment_histogram() == want


@pytest.mark.parametrize("width", (0.25, 0.5, 1.0, 1.4))
def test_specs_match_reference(width):
    for arch in ("v1", "v2"):
        jspec = getattr(jnet, f"mobilenet_{arch}_spec")(width)
        spec = getattr(network, f"mobilenet_{arch}_spec")(width)
        assert spec.c_in == jspec.c_in and spec.name == jspec.name
        assert spec.out_channels() == jspec.out_channels()
        for b, jb in zip(spec.blocks, jspec.blocks, strict=True):
            assert b.residual == jb.residual
            assert [type(s).__name__ for s in b.stages] == [
                type(s).__name__ for s in jb.stages]
            for s, js in zip(b.stages, jb.stages):
                for k in ("features", "activation", "bias", "stride", "hf",
                          "wf", "padding"):
                    assert getattr(s, k, None) == getattr(js, k, None)


def test_make_divisible_matches_reference():
    for v in range(1, 400, 7):
        assert network.make_divisible(v * 0.35) == jnet.make_divisible(
            v * 0.35)


@pytest.mark.parametrize("ho,wo", [(112, 112), (7, 7), (14, 3), (1, 1),
                                   (5, 13)])
def test_tile_candidates_descend_to_one_pixel(ho, wo):
    cands = blocking.tile_candidates(ho, wo)
    assert cands[-1] == (1, 1)
    px = [sh * tw for sh, tw in cands]
    assert px == sorted(px, reverse=True) and px[0] <= 64
    assert all(sh <= ho and tw <= wo for sh, tw in cands)


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_fused_plans_fit_one_cta(dtype):
    for net in (network.mobilenet_v1_spec(), network.mobilenet_v2_spec()):
        nplan = network.plan_network(net, (8, 112, 112, net.c_in),
                                     policy=KernelPolicy())
        for p in nplan.plans:
            seg = p.segments[0].plan
            assert 0 < seg.smem_bytes <= blocking.DEFAULT_SMEM_BUDGET
            assert seg.slab_h * seg.tile_w <= blocking.FUSED_MAX_PIXELS
            assert 1 <= seg.block_co <= blocking.FUSED_MAX_CO


def test_fused_plan_has_width_tile_and_halo():
    p = blocking.plan_separable(112, 112, 32, 64)
    assert (p.slab_h, p.tile_w) == (8, 8) and p.n_slabs == 14
    assert p.halo_rows == 2
    assert p.smem_bytes == blocking.fused_smem_bytes(
        8, 8, p.block_c, 64)


def test_planner_degrades_and_returns_none_only_when_nothing_fits():
    # a raw window of 16384 channels does not fit even a 1x1 tile
    assert blocking.plan_separable3(7, 7, 16384, 32, 32) is None
    assert blocking.plan_separable(7, 7, 16384, 32) is not None
    tiny = blocking.plan_separable(56, 56, 128, 128, smem_budget=2048)
    assert tiny is not None and tiny.smem_bytes <= 2048
    assert tiny.block_c < 32  # the chunk gives way before the tile does
    smaller = blocking.plan_separable(56, 56, 128, 128, smem_budget=600)
    assert smaller.slab_h * smaller.tile_w < 64
    assert blocking.plan_separable(56, 56, 128, 128, smem_budget=64) is None


def test_tiny_budget_degrades_chain_like_reference():
    from repro_torch.core import chain
    spec = chain.inverted_residual_spec(16, 16)
    cp = chain.plan(spec, (1, 8, 8, 16),
                    policy=KernelPolicy(smem_budget=600))
    assert [s.kind for s in cp.segments] == ["pw", "fused2"]
    assert cp.residual and cp.residual_fused
    cp = chain.plan(spec, (1, 8, 8, 16), policy=KernelPolicy(smem_budget=64))
    assert [s.kind for s in cp.segments] == ["pw", "dw", "pw"]
    assert cp.residual and not cp.residual_fused


@pytest.mark.parametrize("kind,item", [("fusedmb", "B5"), ("mb", "B5"),
                                       ("dw_se", "B6"), ("se", "B6")])
def test_later_segment_kinds_raise_naming_their_roadmap_item(kind, item):
    from repro_torch.core import chain
    from repro_torch.kernels import lowering
    seg = blocking.ChainSegment(kind, (0,), blocking.plan_pwconv(1, 8, 8))
    cp = blocking.ChainPlan(segments=(seg,), residual=False,
                            residual_fused=False, dtype_bytes=4,
                            smem_budget=blocking.DEFAULT_SMEM_BUDGET)
    with pytest.raises(NotImplementedError, match=item):
        lowering.lower(chain.SeparableSpec(stages=(chain.PW(8),)), cp)
