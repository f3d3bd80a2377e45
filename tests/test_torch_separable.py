"""The ``separable_fused`` planner and wrapper of the port on the CPU.

The plans of the four CNN bodies at 112x112: each fused launch's CTA count
and its expand / DW / project multiply-adds, the expand's excess over its
minimum (every input pixel expanded once) and the CTA floor at batch 8, the
segment histograms and launch counts, and the shared-memory model against
the layout rule.  The wrapper's own zero padding (``pad``) against the JAX
reference's SAME padding, on the seeded inputs of ``_torch_parity``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import SPECS, assert_match, rand, to_jax, to_torch  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import network  # noqa: E402
from repro_torch.kernels import blocking, ref  # noqa: E402
from repro_torch.kernels import separable_fused as sf  # noqa: E402
from repro_torch.kernels.policy import KernelPolicy  # noqa: E402
from repro_torch.mobilenet_inference import expected_launches  # noqa: E402

DTYPES = (torch.float32, torch.bfloat16)

#: The redesign's two targets at batch 8: the expand's multiply-adds over a
#: net's fused3 blocks at most this multiple of the minimum, and at least
#: this many CTAs in every separable_fused launch.
MAX_EXPAND_EXCESS = 1.8
MIN_CTAS_BATCH8 = 64


def _fused_launches(arch, batch, dtype):
    """(plan, macs) of every fused2 / fused3 launch of one forward."""
    net = getattr(network, SPECS[arch])()
    nplan = network.plan_network(net, (batch, 112, 112, net.c_in),
                                 dtype=dtype, policy=KernelPolicy())
    out = []
    for p, shape, blk in zip(nplan.plans, nplan.block_shapes, net.blocks,
                             strict=True):
        for s in p.segments:
            if s.kind not in ("fused2", "fused3"):
                continue
            st = [blk.stages[i] for i in s.stages]
            d, proj = st[-2], st[-1]
            b, h, w, ci = shape
            c = st[0].features if s.kind == "fused3" else ci
            ho, wo = d.out_dims(h, w)
            top, left, _, _ = ref.same_pads(h, w, d.hf, d.wf, d.stride)
            macs = blocking.separable_macs(
                b, ho, wo, h, w, ci if s.kind == "fused3" else 0, c,
                proj.features, stride=d.stride, hf=d.hf, wf=d.wf,
                slab_h=s.plan.slab_h, pad_t=top, pad_l=left)
            out.append((s.kind, s.plan, macs,
                        (ho, wo, c, d.hf, proj.features)))
    return out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", tuple(SPECS))
def test_expand_runs_once_and_the_grid_fills_the_card(arch, dtype):
    launches = _fused_launches(arch, 8, dtype)
    assert launches
    for kind, plan, macs, (ho, wo, c, k, co) in launches:
        assert plan.ctas >= MIN_CTAS_BATCH8, (kind, plan)
        assert plan.ctas == 8 * plan.n_slabs * plan.cluster
        assert macs["dw"] == 8 * ho * wo * c * k * k
        assert macs["pw"] == 8 * ho * wo * c * co
    f3 = [m for k, _, m, _ in launches if k == "fused3"]
    if f3:
        ratio = sum(m["expand"] for m in f3) / sum(m["expand_min"] for m in f3)
        assert 1.0 <= ratio <= MAX_EXPAND_EXCESS


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", tuple(SPECS))
def test_plans_cover_the_image_and_the_channels(arch, dtype):
    """Every batch-1 and batch-8 plan: the slabs tile the output rows, the
    cluster's slices tile C, each slab holds at most SEP_MAX_PIXELS
    pixels."""
    for batch in (1, 8):
        for _, plan, _, (ho, wo, c, _, _) in _fused_launches(arch, batch,
                                                             dtype):
            assert (plan.n_slabs - 1) * plan.slab_h < ho
            assert plan.n_slabs * plan.slab_h >= ho
            assert plan.tile_w == wo
            assert plan.slab_h * wo <= blocking.SEP_MAX_PIXELS or (
                plan.slab_h == 1)
            cs = blocking.separable_slice(c, plan.cluster)
            assert cs == plan.block_g
            assert (plan.cluster - 1) * cs < c <= plan.cluster * cs


@pytest.mark.parametrize("arch", tuple(SPECS))
def test_fused_launch_counts_are_the_segment_counts(arch):
    net = getattr(network, SPECS[arch])()
    for batch in (1, 8):
        for dtype in DTYPES:
            nplan = network.plan_network(net, (batch, 112, 112, net.c_in),
                                         dtype=dtype, policy=KernelPolicy())
            hist = nplan.segment_histogram()
            want = expected_launches(hist)
            assert want["separable_fused2"] == hist.get("fused2", 0)
            assert want["separable_fused3"] == hist.get("fused3", 0)
            assert len(_fused_launches(arch, batch, dtype)) == (
                hist.get("fused2", 0) + hist.get("fused3", 0))


@pytest.mark.parametrize("slab_h,stride,hf,pad_t", [
    (14, 1, 5, 2), (4, 1, 3, 1), (7, 2, 3, 0), (1, 1, 3, 1), (3, 2, 5, 1)])
def test_expand_macs_count_each_slabs_real_window(slab_h, stride, hf, pad_t):
    """separable_macs against a pixel-by-pixel count of the input pixels
    that each slab's window reads."""
    hi = wi = 14
    ho = wo = -(-hi // stride)
    pad_l = pad_t
    m = blocking.separable_macs(2, ho, wo, hi, wi, 3, 5, 7, stride=stride,
                                hf=hf, wf=hf, slab_h=slab_h, pad_t=pad_t,
                                pad_l=pad_l)
    count = 0
    for oh0 in range(0, ho, slab_h):
        sh = min(slab_h, ho - oh0)
        rows = {oh0 * stride - pad_t + r for r in range((sh - 1) * stride + hf)}
        cols = {q - pad_l for q in range((wo - 1) * stride + hf)}
        count += len(rows & set(range(hi))) * len(cols & set(range(wi)))
    assert m["expand"] == 2 * count * 3 * 5
    assert m["expand_min"] == 2 * hi * wi * 3 * 5
    assert m["dw"] == 2 * ho * wo * 5 * hf * hf
    assert m["pw"] == 2 * ho * wo * 5 * 7


@pytest.mark.parametrize("tc", (False, True))
@pytest.mark.parametrize("expand", (False, True))
def test_smem_model_is_the_layout_rule(expand, tc):
    """separable_smem_bytes against the layout written out by hand for one
    geometry: 14x14 output, 5x5 taps, Ci 112 -> a 96-channel slice in
    chunks of 40, a 64-wide panel, a cluster of 8."""
    kw = dict(ci=112 if expand else 0, c_slice=96, cb=40, panel=64,
              cluster=8, slab_h=14, wo=14, hi=14, wi=14, hf=5, wf=5,
              stride=1, tc=tc)
    xe = 40 * 18 * 18 * 4 + 25 * 40 * 4 + 40 * 4   # window, taps, bias
    if tc:
        dw = 2 * (208 * (96 + 8) * 2)           # hi + lo, 208 pixel rows
        a = xe + ((208 * (112 + 8) * 2 + 112 * (40 + 8) * 2) if expand else 0)
        b = 96 * (64 + 8) * 2 + 64 * 4 + 208 * 64 * 4  # panel, bias, partial
    else:
        dw = 96 * 200 * 4                       # 200 = 196 rounded to 8
        a = xe + ((112 * 200 * 4 + 112 * 40 * 4) if expand else 0)
        b = 96 * 64 * 4 + 64 * 4 + 200 * 64 * 4
    dw += 196 * 4                               # window index per pixel
    assert blocking.separable_smem_bytes(**kw) == dw + max(a, b)
    # the cluster size does not enter: a cluster of one sums its own tile
    assert blocking.separable_smem_bytes(**{**kw, "cluster": 1}) == (
        dw + max(a, b))


@pytest.mark.parametrize("budget", (400_000, 100_000, 30_000, 9000))
def test_planned_smem_is_the_model_and_within_budget(budget):
    for args in ((14, 14, 112, 672, 112, 5), (56, 56, 24, 144, 24, 3),
                 (7, 7, 0, 1024, 1024, 3), (28, 28, 0, 256, 512, 3)):
        ho, wo, ci, c, co, k = args
        for dtype in DTYPES:
            p = blocking.plan_separable_fused(
                ho, wo, ci, c, co, hf=k, wf=k, dtype=dtype,
                smem_budget=min(budget, blocking.DEFAULT_SMEM_BUDGET),
                batch=8, hi=ho, wi=wo)
            if p is None:
                continue
            assert p.smem_bytes <= budget
            assert p.smem_bytes == blocking.separable_smem_bytes(
                ci=ci, c_slice=p.block_g, cb=p.block_c, panel=p.block_co,
                cluster=p.cluster, slab_h=p.slab_h, wo=wo, hi=ho, wi=wo,
                hf=k, wf=k, tc=dtype == torch.bfloat16)


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("b,h,w,ci,c,co,stride,k,residual", [
    (2, 9, 11, 4, 12, 8, 1, 3, False), (1, 10, 10, 6, 18, 6, 1, 5, True),
    (2, 8, 7, 5, 10, 12, 2, 3, False), (1, 9, 9, 8, 8, 8, 2, 5, False)])
def test_wrapper_pads_like_the_reference(b, h, w, ci, c, co, stride, k,
                                         residual, dtype):
    """``pad`` = SAME pads of the unpadded input gives the reference's
    SAME block; the same on the pre-padded input with no ``pad``."""
    rng = np.random.default_rng(11)
    x = rand(rng, (b, h, w, ci))
    ew = rand(rng, (ci, c), ci ** -0.5) if ci != c else None
    f, dwb = rand(rng, (k, k, c), 1 / k), rand(rng, (c,), 0.5)
    pw, pwb = rand(rng, (c, co), c ** -0.5), rand(rng, (co,), 0.5)
    res = x if residual else None
    kw = dict(stride=stride, dw_activation="relu6", activation=None,
              expand_activation="relu6")
    t = lambda a: to_torch(a, dtype)  # noqa: E731
    j = lambda a: to_jax(a, dtype)  # noqa: E731
    got = sf.separable_fused(t(x), t(f), t(pw), t(dwb), t(pwb), t(res),
                             expand_w=t(ew),
                             pad=ref.same_pads(h, w, k, k, stride), **kw)
    want = jref.separable_fused_ref(j(x), j(f), j(pw), j(dwb), j(pwb),
                                    j(res), expand_w=j(ew), padding="same",
                                    **kw)
    assert_match(got, want, dtype)
    pre = sf.separable_fused(ref.pad_same(t(x), k, k, stride), t(f), t(pw),
                             t(dwb), t(pwb), t(res), expand_w=t(ew), **kw)
    assert torch.equal(pre, got)


def test_wrapper_refuses_a_negative_pad():
    z = torch.zeros
    with pytest.raises(ValueError, match="negative pad"):
        sf.separable_fused(z(1, 6, 6, 4), z(3, 3, 4), z(4, 4),
                           pad=(0, -1, 0, 0))


@pytest.mark.parametrize("hw,k,stride", [((14, 14), 5, 1), ((14, 14), 3, 2),
                                         ((112, 112), 3, 2), ((7, 8), 5, 2)])
def test_same_pads_match_pad_same(hw, k, stride):
    x = torch.arange(hw[0] * hw[1], dtype=torch.float32).reshape(1, *hw, 1)
    top, left, bottom, right = ref.same_pads(*hw, k, k, stride)
    padded = ref.pad_same(x, k, k, stride)
    assert padded.shape[1:3] == (hw[0] + top + bottom, hw[1] + left + right)
    assert torch.equal(padded[0, top:top + hw[0], left:left + hw[1]], x[0])
