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


@pytest.mark.parametrize("res", (112, 224, 320, 448))
@pytest.mark.parametrize("fused", (None, False))
@pytest.mark.parametrize("stream", (None, "bfloat16"))
@pytest.mark.parametrize("batch", (1, 8))
@pytest.mark.parametrize("arch", tuple(SPECS))
def test_segment_kinds_match_reference(arch, batch, stream, fused, res):
    """The same segments as the reference's planner at every block, at the
    body inputs of 224 to 896 pixel images; the histogram of section 4 of
    PERF.md at 112."""
    jspec = getattr(jnet, SPECS[arch])()
    spec = getattr(network, SPECS[arch])()
    shape = (batch, res, res, spec.c_in)
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
    if res != 112:
        return
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
def test_dwconv2d_tiles_fit_and_cover(ho, wo):
    """Every ``dwconv2d`` tile, at each filter (compiled and runtime-K),
    stride and type: whole runs of columns, at most 256 threads, its staged
    input within the tile budget and equal to the layout rule, and channel
    groups of whole vectors (one channel where C is ragged)."""
    for c, dtype in ((32, torch.float32), (72, torch.bfloat16),
                     (61, torch.float32), (1024, torch.bfloat16)):
        for k, stride in ((3, 1), (5, 2), (7, 1), (9, 2), (11, 1)):
            p = blocking.plan_dwconv2d(0, 0, ho, wo, c, k, k, stride=stride,
                                       dtype=dtype)
            vec = p.block_g
            assert vec == (16 // dtype.itemsize if c % (16 // dtype.itemsize)
                           == 0 else 1)
            assert p.variant == ("vector" if vec > 1 else "scalar")
            assert p.tile_w % blocking.DW_RUN == 0
            assert p.tile_w <= max(blocking.DW_RUN, -(-wo // 4) * 4)
            assert 1 <= p.slab_h <= ho and p.block_c % vec == 0
            assert blocking.dw_threads(p.slab_h, p.tile_w, p.block_c,
                                       vec) <= blocking.DW_THREADS
            assert p.smem_bytes == blocking.dwconv2d_smem_bytes(
                p.slab_h, p.tile_w, p.block_c, k, k, stride, dtype)
            assert p.smem_bytes <= blocking.DW_TILE_SMEM
            assert p.n_slabs == -(-ho // p.slab_h)
            assert p.ctas == p.n_slabs * -(-wo // p.tile_w) * -(
                -c // p.block_c)


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
                    # dwconv2d's tiles, two passes of ``ctas`` CTAs
                    assert seg.tile_w % blocking.DW_RUN == 0
                    assert blocking.dw_threads(
                        seg.slab_h, seg.tile_w, seg.block_c,
                        seg.block_g) <= blocking.DW_THREADS
                    assert seg.ctas >= blocking.SEP_MIN_CTAS
                    assert seg.workspace_bytes > 0
                    continue
                if s.kind == "fusedmb":
                    # full-width slabs, a C-splitting cluster
                    assert seg.slab_h * seg.tile_w <= blocking.SEP_MAX_PIXELS
                    assert seg.block_co % 8 == 0 and seg.block_co >= 8
                    assert 1 <= seg.cluster <= blocking.SEP_MAX_CLUSTER
                    assert 1 <= seg.block_c <= min(seg.block_g,
                                                   blocking.FUSED_MAX_CB)
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


#: MnasNet-A1's SE blocks at a 112 body input: (h, c, c_se, k, stride) of
#: blocks 3, 4-5, 10, 11, 12 and 13-14; the input halves and doubles with
#: the body input.
MNASNET_SE_BLOCKS = ((56, 72, 6, 5, 2), (28, 120, 10, 5, 1),
                     (14, 480, 20, 3, 1), (14, 672, 28, 3, 1),
                     (14, 672, 28, 5, 2), (7, 960, 40, 5, 1))


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("batch", (1, 8))
@pytest.mark.parametrize("res", (112, 224))
def test_mnasnet_dw_se_plans(res, batch, dtype):
    """Every MnasNet SE block's ``dw_se`` plan in the network's plan: its
    tiles cover Ho x Wo x C exactly, with at least SEP_MIN_CTAS CTAs a
    pass at batch 8; the CTAs, the workspace and each pass's shared memory
    are ``blocking``'s model of them."""
    net = network.mnasnet_a1_spec()
    nplan = network.plan_network(net, (batch, res, res, net.c_in),
                                 dtype=dtype)
    segs = [s.plan for p in nplan.plans for s in p.segments
            if s.kind == "dw_se"]
    shapes = [MNASNET_SE_BLOCKS[i] for i in (0, 1, 1, 2, 3, 4, 5, 5)]
    assert len(segs) == len(shapes) == 8
    for seg, (h, c, c_se, k, s) in zip(segs, shapes):
        h = h * res // 112
        ho = wo = -(-h // s)
        vec = 16 // dtype.itemsize
        assert seg.block_g == vec and seg.block_c % vec == 0
        rows, cols = -(-ho // seg.slab_h), -(-wo // seg.tile_w)
        groups = -(-c // seg.block_c)
        # the tiles cover the output once: the last row, column and
        # channel group of tiles each reach past the edge by less than one
        assert (rows - 1) * seg.slab_h < ho <= rows * seg.slab_h
        assert (cols - 1) * seg.tile_w < wo <= cols * seg.tile_w
        assert (groups - 1) * seg.block_c < c <= groups * seg.block_c
        assert seg.n_slabs == rows
        assert seg.ctas == batch * rows * cols * groups
        # every SM has work at batch 8; batch 1 keeps 48 threads a tile
        assert seg.ctas >= (blocking.SEP_MIN_CTAS if batch == 8 else 21)
        # a share of the reduce FC per CTA
        ctas = rows * cols * groups
        assert seg.workspace_bytes == blocking.dw_se_workspace_bytes(
            batch, ctas, c_se) == 4 * batch * ctas * c_se
        tile = (seg.slab_h, seg.tile_w, seg.block_c, k, k, s)
        assert seg.smem_bytes == blocking.dw_se_smem_bytes(1, *tile, c_se,
                                                           dtype)
        assert blocking.dwconv2d_smem_bytes(*tile, dtype) <= \
            blocking.DW_TILE_SMEM
        for pass_ in (1, 2):
            assert blocking.dwconv2d_smem_bytes(*tile, dtype) < \
                blocking.dw_se_smem_bytes(pass_, *tile, c_se, dtype) <= \
                blocking.DEFAULT_SMEM_BUDGET


def test_fused_mb_plan_fits_and_degrades():
    """Lite0's block A at batch 8: full-width slabs, the slice in one
    chunk and enough CTAs for the card, its shared memory the layout
    rule's; a
    shrinking budget gives way chunk, panel and slab first and ends in
    narrower tiles, then None."""
    for dtype in (torch.float32, torch.bfloat16):
        p = blocking.plan_fused_mb(56, 56, 16, 96, 24, stride=2, dtype=dtype,
                                   batch=8)
        assert p.tile_w == 56 and p.block_co == 24
        assert p.ctas >= blocking.SEP_MIN_CTAS and p.block_c == p.block_g
        assert p.block_g == blocking.separable_slice(96, p.cluster)
        assert p.ctas == 8 * p.n_slabs * p.cluster
        assert p.smem_bytes == blocking.fused_mb_smem_bytes(
            ci=16, c_slice=p.block_g, cb=p.block_c, panel=p.block_co,
            slab_h=p.slab_h, tile_w=56, stride=2,
            tc=dtype == torch.bfloat16)
    tiny = blocking.plan_fused_mb(56, 56, 16, 96, 24, stride=2,
                                  smem_budget=12_000)
    assert tiny is not None and tiny.smem_bytes <= 12_000
    assert tiny.tile_w < 56 and tiny.block_c < 96
    assert blocking.plan_fused_mb(56, 56, 16, 96, 24, stride=2,
                                  smem_budget=600) is None


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_fused_mb_plans_fill_the_card(dtype):
    """Lite0's four fused-MBConv blocks, at batch 8 and 1: a launch puts at
    least 64 CTAs on the card, each computing its whole slice in one
    chunk."""
    for batch in (8, 1):
        for ho, wo, ci, c, co, s in ((56, 56, 16, 96, 24, 2),
                                     (56, 56, 24, 144, 24, 1),
                                     (28, 28, 24, 144, 40, 2),
                                     (28, 28, 40, 240, 40, 1)):
            p = blocking.plan_fused_mb(ho, wo, ci, c, co, stride=s,
                                       dtype=dtype, batch=batch)
            assert p.ctas >= blocking.SEP_MIN_CTAS, (batch, ho, c, p)
            assert p.tile_w == wo and p.block_c == p.block_g


def _jkinds(cp):
    return [s.kind for s in cp.segments]


@pytest.mark.parametrize("batch", (1, 8))
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_plan_dw_se_agrees_with_reference(dtype, batch):
    """Over MnasNet's SE blocks at body inputs of 112 to 560 and some
    widths around them, the port plans ``dw_se`` exactly where the
    reference does, with a tile that fits, and at batch 8 with at least
    SEP_MIN_CTAS CTAs a pass."""
    from repro.kernels import blocking as jblocking
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    planned = 0
    for res in (112, 224, 320, 448, 560):
        for h, c, c_se, k, s in MNASNET_SE_BLOCKS:
            h = h * res // 112
            ho = wo = -(-h // s)
            hiu = wiu = (ho - 1) * s + k
            jp = jblocking.plan_dw_se(hiu, wiu, ho, wo, c, c_se, k, k,
                                      dtype=jdt)
            p = blocking.plan_dw_se(hiu, wiu, ho, wo, c, c_se, k, k,
                                    stride=s, dtype=tdt, batch=batch)
            assert (p is None) == (jp is None), (res, h, c)
            if p is None:
                continue
            planned += 1
            assert p.smem_bytes <= blocking.DEFAULT_SMEM_BUDGET
            if batch == 8:
                assert p.ctas >= blocking.SEP_MIN_CTAS
    assert planned > 12


def test_dw_se_degrades_to_dw_and_se_like_reference():
    """An SE block whose DW output does not fit one TPU core's VMEM plans
    dw + se in both packages; so does one whose smallest ``dw_se`` tile
    does not fit a starved shared-memory budget."""
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
                         policy=KernelPolicy(smem_budget=256))
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
