"""The port's planner against the JAX package's: the same segment kinds at
every MobileNet V1/V2, MnasNet-A1 and EfficientNet-Lite0 block, the same
degradations, and the Hopper tile and cluster planner's own contract."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_parity import SPECS  # noqa: E402
from repro.core import chain as jchain  # noqa: E402
from repro.core import network as jnet  # noqa: E402
from repro.kernels.policy import DtypePolicy as JDtypePolicy  # noqa: E402
from repro.kernels.policy import KernelPolicy as JKernelPolicy  # noqa: E402
from repro_torch.core import chain, network  # noqa: E402
from repro_torch.kernels import blocking  # noqa: E402
from repro_torch.kernels.policy import DtypePolicy, KernelPolicy  # noqa: E402



def _kinds(nplan):
    return [tuple(s.kind for s in p.segments) for p in nplan.plans]


@pytest.mark.parametrize("fused", (None, False))
@pytest.mark.parametrize("stream", (None, "bfloat16"))
@pytest.mark.parametrize("batch", (1, 8))
@pytest.mark.parametrize("arch", tuple(SPECS))
def test_segment_kinds_match_reference(arch, batch, stream, fused):
    jspec = getattr(jnet, SPECS[arch])()
    spec = getattr(network, SPECS[arch])()
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
            ("v2", False): {"dw": 17, "pw": 33},
            ("mnasnet", None): {"fused2": 1, "fused3": 7, "pw": 16,
                                "dw_se": 8},
            ("mnasnet", False): {"dw": 16, "pw": 31, "se": 8},
            ("lite0", None): {"fused2": 1, "fusedmb": 4, "fused3": 11},
            ("lite0", False): {"dw": 12, "pw": 27, "mb": 4}}[(arch, fused)]
    assert plan.segment_histogram() == want
    assert jplan.segment_histogram() == want


@pytest.mark.parametrize("width", (0.25, 0.5, 1.0, 1.4))
def test_specs_match_reference(width):
    for arch in SPECS:
        jspec = getattr(jnet, SPECS[arch])(width)
        spec = getattr(network, SPECS[arch])(width)
        assert spec.c_in == jspec.c_in and spec.name == jspec.name
        assert spec.out_channels() == jspec.out_channels()
        for b, jb in zip(spec.blocks, jspec.blocks, strict=True):
            assert b.residual == jb.residual
            assert [type(s).__name__ for s in b.stages] == [
                type(s).__name__ for s in jb.stages]
            for s, js in zip(b.stages, jb.stages):
                for k in ("features", "activation", "bias", "stride", "hf",
                          "wf", "padding", "reduce"):
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
    for arch in SPECS:
        net = getattr(network, SPECS[arch])()
        nplan = network.plan_network(net, (8, 112, 112, net.c_in),
                                     dtype=dtype, policy=KernelPolicy())
        for p in nplan.plans:
            for s in p.segments:
                seg = s.plan
                if s.kind == "pw":
                    continue
                assert 0 < seg.smem_bytes <= blocking.DEFAULT_SMEM_BUDGET
                if s.kind == "dw_se":
                    assert seg.cluster in blocking.DW_SE_CLUSTERS
                    continue
                if s.kind == "fusedmb":
                    assert seg.slab_h * seg.tile_w <= blocking.FUSED_MAX_PIXELS
                    assert 1 <= seg.block_co <= blocking.FUSED_MAX_CO
                    continue
                # separable_fused: full-width slabs, a C-splitting cluster
                assert seg.slab_h * seg.tile_w <= blocking.SEP_MAX_PIXELS
                assert 8 <= seg.block_co <= blocking.SEP_MAX_PANEL
                assert seg.block_co % 8 == 0
                assert 1 <= seg.cluster <= blocking.SEP_MAX_CLUSTER
                assert 1 <= seg.block_c <= seg.block_g


def test_fused_plan_has_width_tile_and_halo():
    """A slab spans the full output width, its rows balanced over the
    image; slabs of more than one per image carry the window's halo rows;
    the planner's count of shared memory is the layout rule's."""
    p = blocking.plan_separable(112, 112, 32, 64)
    assert p.tile_w == 112 and p.n_slabs == -(-112 // p.slab_h)
    assert p.slab_h * 112 <= blocking.SEP_MAX_PIXELS
    assert p.halo_rows == (2 if p.n_slabs > 1 else 0)
    assert p.smem_bytes == blocking.separable_smem_bytes(
        ci=0, c_slice=p.block_g, cb=p.block_c, panel=p.block_co,
        cluster=p.cluster, slab_h=p.slab_h, wo=112, hi=114, wi=114)
    whole = blocking.plan_separable3(7, 7, 192, 1152, 192, hf=5, wf=5,
                                     batch=8, hi=7, wi=7)
    m = blocking.separable_macs(8, 7, 7, 7, 7, 192, 1152, 192, stride=1,
                                hf=5, wf=5, slab_h=whole.slab_h, pad_t=2,
                                pad_l=2)
    assert m["expand"] <= blocking.SEP_MAX_EXPAND * m["expand_min"]
    assert whole.ctas >= blocking.SEP_MIN_CTAS


def test_planner_degrades_and_returns_none_only_when_nothing_fits():
    # a raw window of 16384 channels does not fit even one output row
    assert blocking.plan_separable3(7, 7, 16384, 32, 32) is None
    assert blocking.plan_separable(7, 7, 16384, 32) is not None
    full = blocking.plan_separable(56, 56, 128, 128)
    last = full
    for budget in (60_000, 20_000, 8000):
        p = blocking.plan_separable(56, 56, 128, 128, smem_budget=budget)
        assert p is not None and p.smem_bytes <= budget
        assert p.smem_bytes <= last.smem_bytes
        last = p
    # at the smallest budget the slab, chunk and panel have all given way
    assert last.slab_h < full.slab_h or last.block_c < full.block_c
    assert last.block_co < full.block_co
    assert blocking.plan_separable(56, 56, 128, 128, smem_budget=4000) is None


def test_tiny_budget_degrades_chain_like_reference():
    from repro_torch.core import chain
    spec = chain.inverted_residual_spec(16, 16)
    cp = chain.plan(spec, (1, 8, 8, 16),
                    policy=KernelPolicy(smem_budget=1500))
    assert [s.kind for s in cp.segments] == ["pw", "fused2"]
    assert cp.residual and cp.residual_fused
    cp = chain.plan(spec, (1, 8, 8, 16), policy=KernelPolicy(smem_budget=64))
    assert [s.kind for s in cp.segments] == ["pw", "dw", "pw"]
    assert cp.residual and not cp.residual_fused


def test_mnasnet_dw_se_clusters_at_112():
    """Every MnasNet SE block at 112x112 fits a cluster: the smallest that
    holds its fp32 DW output slice, by the kernel's own model."""
    net = network.mnasnet_a1_spec()
    for dtype in (torch.float32, torch.bfloat16):
        nplan = network.plan_network(net, (1, 112, 112, net.c_in),
                                     dtype=dtype)
        segs = [s.plan for p in nplan.plans for s in p.segments
                if s.kind == "dw_se"]
        assert [s.cluster for s in segs] == [1, 2, 2, 2, 4, 1, 1, 1]
        assert [s.block_g for s in segs] == [6, 10, 10, 20, 28, 28, 40, 40]
        for s in segs:
            assert s.smem_bytes == blocking.dw_se_smem_bytes(
                s.slab_h, s.slab_h, s.block_c * s.cluster, s.block_g,
                s.cluster)


@pytest.mark.parametrize("budget,want", [
    (232_448, 1), (120_000, 2), (70_000, 4), (40_000, 8), (20_000, None)])
def test_dw_se_plan_takes_the_smallest_cluster_that_fits(budget, want):
    p = blocking.plan_dw_se(30, 30, 28, 28, 72, 6, 3, 3, smem_budget=budget)
    if want is None:
        assert p is None
        return
    assert p.cluster == want and p.block_c == -(-72 // want)
    assert p.smem_bytes <= budget
    assert p.smem_bytes == blocking.dw_se_smem_bytes(28, 28, 72, 6, want)


def test_fused_mb_plan_fits_and_degrades():
    p = blocking.plan_fused_mb(56, 56, 16, 96, 24, stride=2)
    assert (p.slab_h, p.tile_w, p.block_c, p.block_co) == (8, 8, 64, 24)
    assert p.smem_bytes == blocking.fused_mb_smem_bytes(
        8, 8, 64, 24, ci=16, stride=2)
    tiny = blocking.plan_fused_mb(56, 56, 16, 96, 24, stride=2,
                                  smem_budget=6000)
    assert tiny is not None and tiny.smem_bytes <= 6000
    assert tiny.block_c < 32
    assert blocking.plan_fused_mb(56, 56, 16, 96, 24, stride=2,
                                  smem_budget=600) is None


def _jkinds(cp):
    return [s.kind for s in cp.segments]


def test_dw_se_degrades_to_dw_and_se_like_reference():
    """An SE block whose DW output fits neither one TPU core's VMEM nor a
    cluster of 8 CTAs plans dw + se in both packages."""
    spec = chain.mbconv_se_spec(16, 16, expand=6)
    jspec = jchain.mbconv_se_spec(16, 16, expand=6)
    shape = (1, 112, 112, 16)
    cp = chain.plan(spec, shape)
    jcp = jchain.plan(jspec, shape, policy=JKernelPolicy(on_failure="raise"))
    assert _jkinds(cp) == _jkinds(jcp) == ["pw", "dw", "se", "pw"]
    assert cp.residual == jcp.residual and not cp.residual_fused
    assert cp.n_kernel_passes == jcp.n_kernel_passes == 6
    small = chain.plan(spec, (1, 14, 14, 16))
    assert _jkinds(small) == ["pw", "dw_se", "pw"]
    starved = chain.plan(spec, (1, 14, 14, 16),
                         policy=KernelPolicy(smem_budget=1024))
    assert _jkinds(starved) == ["pw", "dw", "se", "pw"]


def test_fused_mb_degrades_to_mb_and_pw_like_reference():
    spec = chain.fused_mbconv_spec(256, 256, expand=2)
    jspec = jchain.fused_mbconv_spec(256, 256, expand=2)
    jcp = jchain.plan(jspec, (1, 8, 2048, 256),
                      policy=JKernelPolicy(on_failure="raise"))
    cp = chain.plan(spec, (1, 8, 2048, 256),
                    policy=KernelPolicy(smem_budget=8192))
    assert _jkinds(cp) == _jkinds(jcp) == ["mb", "pw"]
    assert cp.residual and not cp.residual_fused
    assert cp.segments[0].plan.smem_bytes == 0
    cp = chain.plan(spec, (1, 8, 64, 256))
    assert _jkinds(cp) == ["fusedmb"] and cp.residual_fused


def test_fused_false_unfuses_the_new_kinds_like_reference():
    pol, jpol = KernelPolicy(fused=False), JKernelPolicy(
        fused=False, on_failure="raise")
    for name, shape in (("mbconv_se_spec", (1, 14, 14, 16)),
                        ("fused_mbconv_spec", (1, 14, 14, 16))):
        spec = getattr(chain, name)(16, 16)
        jspec = getattr(jchain, name)(16, 16)
        assert _jkinds(chain.plan(spec, shape, policy=pol)) == _jkinds(
            jchain.plan(jspec, shape, policy=jpol))


def test_stage_validation():
    with pytest.raises(ValueError, match="reduce"):
        chain.SE(0)
    with pytest.raises(ValueError, match="unknown activation"):
        chain.SE(4, activation="sigmoid")
    with pytest.raises(ValueError):
        chain.FusedMB(8, padding="full")
    spec = chain.fused_mbconv_spec(8, 16, stride=2)
    assert spec.out_channels(8) == 16 and spec.stride_product() == 2
    assert not spec.residual_active(8)
    assert chain.fused_mbconv_spec(8, 8).residual_active(8)
    assert chain.mbconv_se_spec(10, 10, expand=3).stages[2].reduce == 2
