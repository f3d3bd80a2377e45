"""The CUDA kernels on the card against their plain versions, at small odd
shapes that exercise the masked edges.  Marked ``cuda``: they skip where
there is no CUDA device.  Run them on a GPU host with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py -q
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import network  # noqa: E402
from repro_torch.kernels import (blocking, dwconv2d, ops, pwconv,  # noqa: E402
                                 ref, se_epilogue)
from repro_torch.kernels import fused_mbconv as fmb  # noqa: E402
from repro_torch.kernels import separable_fused as sf  # noqa: E402
from repro_torch.kernels.policy import KernelPolicy  # noqa: E402
from repro_torch.mobilenet_inference import (ARCHS,  # noqa: E402
                                             expected_launches,
                                             launch_counts, rel_err,
                                             reset_launch_counts)

pytestmark = pytest.mark.cuda


def _replay_kernels(fn, names=None):
    """The port's kernels one call of ``fn`` (a call that replays a CUDA
    graph) ran, by launch counter (``names``, by default the CNN bodies'),
    counted in a profiler trace."""
    from repro_torch.measure import device_profile
    ran = device_profile(fn, reps=2)[1]
    return {k: ran.get(k, 0) for k in (names or launch_counts())}


def _twice(counts):
    """The launches a capture makes: its warm-up's and its recording's."""
    return {k: 2 * n for k, n in counts.items()}

TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2, torch.float16: 2e-3}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda", 0)


def _r(shape, dev, dtype, scale=1.0, seed=0):
    g = torch.Generator().manual_seed(seed + sum(shape))
    return (torch.randn(shape, generator=g) * scale).to(dev, dtype)


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("b,h,w,c,stride,hf,vec", [
    (2, 9, 11, 12, 1, 3, 4), (1, 8, 8, 20, 2, 3, 4), (2, 7, 9, 6, 2, 5, 1),
    (1, 10, 10, 5, 1, 3, 1), (1, 12, 12, 8, 1, 7, 4),
    (2, 56, 56, 72, 2, 5, 4), (1, 14, 14, 480, 1, 5, 4),
    (2, 13, 17, 24, 1, 9, 4), (1, 20, 15, 40, 2, 9, 4),
    (2, 12, 12, 16, 1, 11, 4), (1, 23, 21, 13, 2, 11, 1),
    (1, 9, 9, 16, 3, 3, 4), (1, 10, 12, 8, 1, 2, 4)])
def test_dwconv2d_kernel(dev, b, h, w, c, stride, hf, vec, dtype):
    """The planned tile on unpadded input with SAME pads, and on input
    padded first (pad 0); 3x3-7x7 at strides 1 and 2 take the compiled
    paths, 9x9, 11x11, 2x2 and stride 3 the runtime-K path; ``vec`` 1 is a
    C that is not a whole number of 16-byte vectors."""
    x = _r((b, h, w, c), dev, dtype)
    f = _r((hf, hf, c), dev, dtype, 1 / hf)
    pad = ref.same_pads(h, w, hf, hf, stride)
    want = dwconv2d.dwconv2d_plain(x, f, stride=stride, pad=pad)
    got = dwconv2d.dwconv2d(x, f, stride=stride, pad=pad)
    plan = blocking.plan_dwconv2d(0, 0, *want.shape[1:3], c, hf, hf,
                                  stride=stride, dtype=dtype)
    v = 16 // x.element_size()
    assert plan.variant == ("vector" if vec > 1 and c % v == 0 else "scalar")
    assert rel_err(got, want) <= TOL[dtype]
    xp = ref.pad_same(x, hf, hf, stride)
    assert torch.equal(dwconv2d.dwconv2d(xp, f, stride=stride), got)


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("tile", [(1, 4, None), (3, 8, None), (5, 4, 8),
                                  (2, 16, 16)])
def test_dwconv2d_kernel_at_forced_tiles(dev, tile, dtype):
    """Tiles the planner would not pick, ragged at every edge of the
    output, and a channel group smaller than C."""
    x = _r((2, 19, 23, 48), dev, dtype)
    f = _r((3, 3, 48), dev, dtype, 1 / 3)
    pad = ref.same_pads(19, 23, 3, 3, 2)
    th, tw, cg = tile
    got = dwconv2d.dwconv2d(x, f, stride=2, pad=pad, slab_h=th, tile_w=tw,
                            block_c=cg)
    want = dwconv2d.dwconv2d_plain(x, f, stride=2, pad=pad)
    assert rel_err(got, want) <= TOL[dtype]


def test_dwconv2d_smem_model_matches_the_kernel(dev):
    for dtype in (torch.float32, torch.bfloat16):
        for ho, wo, c, k, s in ((112, 112, 32, 3, 1), (56, 56, 64, 3, 2),
                                (28, 28, 72, 5, 2), (7, 7, 1024, 3, 1),
                                (14, 14, 61, 11, 2)):
            p = blocking.plan_dwconv2d(0, 0, ho, wo, c, k, k, stride=s,
                                       dtype=dtype)
            assert dwconv2d.smem_bytes(p.slab_h, p.tile_w, p.block_c, k, k,
                                       s, dtype) == p.smem_bytes


#: (stream, store) pairs of pwconv's card tests.
PW_IO = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
         (torch.bfloat16, torch.float32), (torch.float16, torch.float16)]
#: Each variant at each of its compiled tiles, on shapes with ragged G, Ci
#: off the K step and Co from 3 to 3072 (``tc`` needs Ci, Co multiples of
#: 8 and 16-bit operands; ``stream`` tiles whose sums do not fit a thread
#: are refused, and the test then expects the refusal).
PW_CASES = (
    [("simt", t, s) for t in blocking.PW_TILES["simt"] for s in (
        (37, 20, 50, "relu6"), (300, 130, 70, "gelu"), (5, 8, 3, "silu"),
        (65, 36, 3072, None))]
    + [("tc", t, s) for t in blocking.PW_TILES["tc"] for s in (
        (300, 136, 200, "relu6"), (65, 72, 8, "gelu"), (17, 520, 3072, None),
        (1, 8, 16, "silu"))]
    + [("stream", (bg, bco, None), s)
       for bg, bco in ((1, 32), (8, 64), (16, 64), (4, 128), (8, 256))
       for s in ((7, 130, 50, "relu6"), (8, 130, 3072, "gelu"),
                 (15, 1000, 8, None), (16, 70, 3, "silu"))])


def _pw_operands(dev, g, ci, co, dtype):
    x = _r((g, ci), dev, dtype)
    w = _r((ci, co), dev, dtype, ci ** -0.5)
    return x, w, _r((co,), dev, dtype, 0.5)


@pytest.mark.parametrize("variant,tile,shape,io", [
    (v, t, s, io) for v, t, s in PW_CASES for io in PW_IO
    if not (v == "tc" and io[0] == torch.float32)])
def test_pwconv_kernel(dev, variant, tile, shape, io):
    """fp32 is not a ``tc`` case: test_pwconv_tc_refuses_fp32."""
    dtype, odt = io
    g, ci, co, act = shape
    x, w, b = _pw_operands(dev, g, ci, co, dtype)
    bci = tile[2] or -(-ci // 4)
    why = blocking.pwconv_tile_error(
        variant, tile[0], tile[1], bci, ci=ci,
        vector=blocking.pw_vector(co, dtype))
    kw = dict(activation=act, variant=variant, block_g=tile[0],
              block_co=tile[1], block_ci=bci, out_dtype=odt)
    if why is not None:
        with pytest.raises(ValueError):
            pwconv.pwconv(x, w, b, **kw)
        return
    before = dict(pwconv.launches_by_variant)
    got = pwconv.pwconv(x, w, b, **kw)
    want = pwconv.pwconv_plain(x, w, b, activation=act, out_dtype=odt)
    assert got.dtype == odt and got.shape == (g, co)
    assert pwconv.launches_by_variant[variant] == before[variant] + 1
    assert rel_err(got, want) <= TOL[dtype]


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("g", (1, 7, 8, 15, 16, 17, 63, 64, 65, 300))
@pytest.mark.parametrize("ci,co", [(130, 3), (130, 8), (520, 50),
                                   (200, 3072)])
def test_pwconv_kernel_planned_at_ragged_shapes(dev, g, ci, co, dtype):
    """The planner's own variant and tile at every G around the stream
    threshold and the 64-row tiles."""
    x, w, b = _pw_operands(dev, g, ci, co, dtype)
    plan = blocking.plan_pwconv(g, ci, co, dtype=dtype)
    before = dict(pwconv.launches_by_variant)
    got = pwconv.pwconv(x, w, b, activation="relu6")
    want = pwconv.pwconv_plain(x, w, b, activation="relu6")
    assert pwconv.launches_by_variant[plan.variant] == (
        before[plan.variant] + 1)
    assert rel_err(got, want) <= TOL[dtype]


def test_pwconv_tc_refuses_fp32(dev):
    x, w, b = _pw_operands(dev, 64, 64, 64, torch.float32)
    with pytest.raises(ValueError, match="16-bit"):
        pwconv.pwconv(x, w, b, variant="tc")


@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float32))
def test_pwconv_unaligned_bases_take_the_element_paths(dev, dtype):
    """A base off a 16-byte boundary: ``tc`` gives way to ``simt`` and
    ``stream`` reads w element by element, decided before the launch."""
    g, ci, co = 300, 64, 64
    xs = _r((g * ci + 1,), dev, dtype)[1:].view(g, ci)
    ws = _r((ci * co + 1,), dev, dtype, ci ** -0.5)[1:].view(ci, co)
    before = dict(pwconv.launches_by_variant)
    got = pwconv.pwconv(xs, ws)
    want_variant = "simt"
    assert pwconv.launches_by_variant[want_variant] == (
        before[want_variant] + 1)
    assert rel_err(got, pwconv.pwconv_plain(xs, ws)) <= TOL[dtype]
    got = pwconv.pwconv(xs[:8], ws)
    assert rel_err(got, pwconv.pwconv_plain(xs[:8], ws)) <= TOL[dtype]


def test_pwconv_stream_repeats_bit_for_bit(dev):
    x, w, b = _pw_operands(dev, 8, 1536, 3072, torch.float32)
    first = pwconv.pwconv(x, w, b)
    for _ in range(3):
        assert torch.equal(pwconv.pwconv(x, w, b), first)


@pytest.mark.parametrize("variant", blocking.PW_VARIANTS)
def test_pwconv_smem_model_matches_the_kernel(dev, variant):
    for bg, bco, bci in blocking.PW_TILES[variant]:
        for k in ((bci,) if bci else (1, 96, 192, 300)):
            for ci in (8, 64, 130, 256, 3072):
                assert pwconv.smem_bytes(variant, bg, bco, k, ci) == (
                    blocking.pwconv_smem_bytes(variant, bg, bco, k, ci))


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize(
    "b,h,w,ci,c,co,stride,expand,residual,dw_act,act,blocks", [
        (2, 9, 9, 12, 12, 20, 1, False, False, "relu6", "relu6", None),
        (1, 11, 7, 10, 10, 70, 2, False, False, "relu", "gelu", (3, 4, 16, 3)),
        (2, 8, 8, 16, 16, 16, 1, False, True, "silu", None, (1, 1, 8, 1)),
        (2, 8, 8, 8, 48, 8, 1, True, True, "relu6", None, None),
        (1, 9, 9, 6, 36, 10, 2, True, False, "gelu", "relu", (2, 5, 8, 4)),
        (2, 7, 7, 5, 30, 5, 1, True, True, "silu", "silu", (7, 30, 8, 1)),
        (1, 13, 5, 9, 41, 27, 1, True, False, None, "relu6", (4, 3, 24, 5)),
        (2, 10, 12, 7, 7, 33, 2, False, False, "relu", None, (2, 2, 8, 7)),
        (1, 6, 9, 33, 33, 33, 1, False, True, "gelu", "silu", (2, 8, 16, 2)),
    ])
def test_separable_fused_kernel(dev, b, h, w, ci, c, co, stride, expand,
                                residual, dw_act, act, blocks, dtype):
    """Ragged C, Co and image edges, every activation, forced slabs,
    chunks, panels and clusters; the kernel pads as it reads."""
    x_raw = _r((b, h, w, ci), dev, dtype)
    x = ref.pad_same(x_raw, 3, 3, stride)
    ew = _r((ci, c), dev, dtype, ci ** -0.5) if expand else None
    f, dwb = _r((3, 3, c), dev, dtype, 1 / 3), _r((c,), dev, dtype, 0.5)
    pw, pwb = _r((c, co), dev, dtype, c ** -0.5), _r((co,), dev, dtype, 0.5)
    res = x_raw if residual else None
    kw = dict(expand_w=ew, stride=stride, dw_activation=dw_act,
              activation=act)
    bl = {}
    if blocks is not None:
        bl = dict(slab_h=blocks[0], block_c=blocks[1], block_co=blocks[2],
                  cluster=blocks[3])
    want = sf.separable_fused_plain(x, f, pw, dwb, pwb, res, **kw)
    got = sf.separable_fused(x, f, pw, dwb, pwb, res, **kw, **bl)
    assert rel_err(got, want) <= TOL[dtype]
    padded = sf.separable_fused(x_raw, f, pw, dwb, pwb, res, **kw, **bl,
                                pad=ref.same_pads(h, w, 3, 3, stride))
    assert rel_err(padded, want) <= TOL[dtype]


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("b,h,w,ci,c,co,stride,residual,k", [
    (2, 14, 14, 112, 672, 112, 1, True, 5),
    (2, 14, 14, 112, 672, 192, 2, False, 5),
    (1, 9, 11, 10, 30, 10, 1, True, 5), (2, 7, 7, 12, 12, 20, 1, False, 5),
    (1, 9, 9, 8, 24, 8, 1, True, 7), (1, 10, 10, 12, 12, 16, 2, False, 7)])
def test_separable_fused_kernel_5x5(dev, b, h, w, ci, c, co, stride,
                                    residual, k, dtype):
    """5x5 taps (held in registers) and 7x7 (read per pixel)."""
    x_raw = _r((b, h, w, ci), dev, dtype)
    x = ref.pad_same(x_raw, k, k, stride)
    ew = _r((ci, c), dev, dtype, ci ** -0.5) if ci != c else None
    f, dwb = _r((k, k, c), dev, dtype, 1 / k), _r((c,), dev, dtype, 0.5)
    pw, pwb = _r((c, co), dev, dtype, c ** -0.5), _r((co,), dev, dtype, 0.5)
    res = x_raw if residual else None
    kw = dict(expand_w=ew, stride=stride, dw_activation="relu6",
              activation=None if ew is not None else "relu")
    got = sf.separable_fused(x_raw, f, pw, dwb, pwb, res, **kw,
                             pad=ref.same_pads(h, w, k, k, stride))
    want = sf.separable_fused_plain(x, f, pw, dwb, pwb, res, **kw)
    assert rel_err(got, want) <= TOL[dtype]


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("cluster", (1, 2, 3, 4, 5, 8))
@pytest.mark.parametrize("expand", (False, True))
def test_separable_fused_at_each_cluster_size(dev, cluster, expand, dtype):
    """C split over every cluster size, the last slice ragged (C = 44)."""
    b, h, w, ci, c, co, k = 2, 7, 9, 12, 44, 20, 3
    x_raw = _r((b, h, w, ci if expand else c), dev, dtype)
    x = ref.pad_same(x_raw, k, k, 1)
    ew = _r((ci, c), dev, dtype, ci ** -0.5) if expand else None
    f, pw = _r((k, k, c), dev, dtype, 1 / 3), _r((c, co), dev, dtype, 0.2)
    kw = dict(expand_w=ew, dw_activation="relu6", activation=None)
    got = sf.separable_fused(x_raw, f, pw, None, None, None, **kw,
                             pad=ref.same_pads(h, w, k, k, 1), slab_h=3,
                             block_c=5, block_co=16, cluster=cluster)
    want = sf.separable_fused_plain(x, f, pw, None, None, None, **kw)
    assert rel_err(got, want) <= TOL[dtype]


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_separable_fused_repeats_bit_for_bit(dev, dtype):
    """The cluster's partial tiles are summed in rank order: two runs give
    the same bits."""
    x = _r((8, 7, 7, 192), dev, dtype)
    ew = _r((192, 1152), dev, dtype, 192 ** -0.5)
    f, pw = _r((5, 5, 1152), dev, dtype, 0.2), _r((1152, 192), dev, dtype,
                                                  1152 ** -0.5)
    kw = dict(expand_w=ew, pad=(2, 2, 2, 2), dw_activation="relu6")
    plan = blocking.plan_separable3(7, 7, 192, 1152, 192, hf=5, wf=5,
                                    dtype=dtype, batch=8, hi=7, wi=7)
    assert plan.cluster > 1
    a = sf.separable_fused(x, f, pw, residual=x, **kw)
    b = sf.separable_fused(x, f, pw, residual=x, **kw)
    assert torch.equal(a, b)


def test_separable_fused_rounds_once_on_the_card(dev):
    """bf16 fused output rounds once (the project's A operand is split hi +
    lo, not rounded): it is no farther from the fp32 answer than the bf16
    ``dwconv2d`` + ``pwconv`` composition, which rounds the DW output."""
    for c, co in ((64, 32), (576, 160)):
        x = _r((2, 14, 14, c), dev, torch.float32)
        f = _r((3, 3, c), dev, torch.float32, 1 / 3)
        pw = _r((c, co), dev, torch.float32, c ** -0.5)
        xp = ref.pad_same(x, 3, 3, 1)
        exact = sf.separable_fused_plain(xp, f, pw)
        xb, fb, pwb = (t.to(torch.bfloat16) for t in (xp, f, pw))
        fused = sf.separable_fused(xb, fb, pwb)
        dw = torch.clamp(dwconv2d.dwconv2d(xb, fb), 0, 6)
        unfused = pwconv.pwconv(dw.reshape(-1, c), pwb).reshape(exact.shape)
        e_f = (fused.float() - exact).abs().max()
        e_u = (unfused.float() - exact).abs().max()
        assert e_f <= e_u


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16,
                                   torch.float16))
def test_separable_fused_smem_model_matches_the_kernel(dev, dtype):
    """The planner's shared-memory model against the kernel's own layout
    at every fused block of the four bodies, batch 1 and 8."""
    for arch, build in ARCHS.items():
        spec = build(1.0)
        for batch in (1, 8):
            nplan = network.plan_network(
                spec, (batch, 112, 112, spec.c_in), dtype=dtype,
                policy=KernelPolicy())
            for p, shape, blk in zip(nplan.plans, nplan.block_shapes,
                                     spec.blocks):
                for s in p.segments:
                    if s.kind not in ("fused2", "fused3"):
                        continue
                    d = blk.stages[s.stages[-2]]
                    _, h, w, ci = shape
                    q = s.plan
                    assert q.smem_bytes == sf.smem_bytes(
                        ci if s.kind == "fused3" else 0, q.block_g,
                        q.block_c, q.block_co, q.cluster, q.slab_h,
                        q.tile_w, h, w, d.hf, d.wf, d.stride,
                        s.kind == "fused3", dtype), (arch, s)


# (b, h, w, ci, c, co, stride, k, residual, blocks): Lite0's four
# fused-MBConv blocks at batch 2 and block D at batch 1, then ragged C and Co,
# several Co panels and chunks, 5x5 taps, a Ci that is not a whole 16-byte
# vector, and forced blocks (slab_h, tile_w, block_c, cluster): narrow tiles
# ragged at the right edge, clusters of 1-8.
FUSED_MB_CASES = [
    (2, 112, 112, 16, 96, 24, 2, 3, False, None),
    (2, 56, 56, 24, 144, 24, 1, 3, True, None),
    (2, 56, 56, 24, 144, 40, 2, 3, False, None),
    (2, 28, 28, 40, 240, 40, 1, 3, True, None),
    (1, 28, 28, 40, 240, 40, 1, 3, True, None),
    (1, 9, 11, 5, 37, 70, 1, 3, False, None),
    (2, 8, 8, 6, 30, 6, 1, 5, True, (3, 3, 7, 2)),
    (1, 10, 10, 3, 130, 129, 2, 5, False, (1, 2, 8, 8)),
    (2, 14, 14, 24, 200, 300, 1, 3, False, (2, 14, 16, 1)),
    (1, 12, 20, 8, 64, 16, 2, 3, True, None),
]


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("b,h,w,ci,c,co,stride,k,residual,blocks",
                         FUSED_MB_CASES)
def test_fused_mbconv_kernel(dev, b, h, w, ci, c, co, stride, k, residual,
                             blocks, dtype):
    x = _r((b, h, w, ci), dev, dtype)
    f = _r((k, k, ci, c), dev, dtype, (k * k * ci) ** -0.5)
    fb = _r((c,), dev, dtype, 0.5)
    pw, pwb = _r((c, co), dev, dtype, c ** -0.5), _r((co,), dev, dtype, 0.5)
    ho, wo = -(-h // stride), -(-w // stride)
    res = _r((b, ho, wo, co), dev, dtype) if residual else None
    kw = dict(stride=stride, mb_activation="relu6",
              activation=None if residual else "silu")
    pad = ref.same_pads(h, w, k, k, stride)
    if blocks is not None:
        kw.update(slab_h=blocks[0], tile_w=blocks[1], block_c=blocks[2],
                  cluster=blocks[3])
    got = fmb.fused_mbconv(x, f, pw, fb, pwb, res, pad=pad, **kw)
    for key in ("slab_h", "tile_w", "block_c", "cluster"):
        kw.pop(key, None)
    want = fmb.fused_mbconv_plain(x, f, pw, fb, pwb, res, pad=pad, **kw)
    assert rel_err(got, want) <= TOL[dtype]


def test_fused_mbconv_smem_model_matches_kernel(dev):
    """The planner's shared-memory model against the kernel's own layout
    at Lite0's blocks (batch 1 and 8, both layouts) and at tiles the
    planner takes when the budget shrinks."""
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for batch in (1, 8):
            for ho, wo, ci, c, co, s in ((56, 56, 16, 96, 24, 2),
                                         (56, 56, 24, 144, 24, 1),
                                         (28, 28, 24, 144, 40, 2),
                                         (28, 28, 40, 240, 40, 1)):
                for budget in (blocking.DEFAULT_SMEM_BUDGET, 40_000):
                    p = blocking.plan_fused_mb(ho, wo, ci, c, co, stride=s,
                                               dtype=dtype, batch=batch,
                                               smem_budget=budget)
                    assert fmb.smem_bytes(
                        ci, p.block_g, p.block_c, p.block_co, p.slab_h,
                        p.tile_w, 3, 3, s, dtype) == p.smem_bytes


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_fused_mbconv_repeats_bit_for_bit(dev, dtype):
    """The cluster's partial projections are summed in rank order: two runs
    give the same bits."""
    x = _r((8, 28, 28, 40), dev, dtype)
    f = _r((3, 3, 40, 240), dev, dtype, 1 / 19)
    pw = _r((240, 40), dev, dtype, 240 ** -0.5)
    plan = blocking.plan_fused_mb(28, 28, 40, 240, 40, dtype=dtype, batch=8)
    assert plan.cluster > 1
    kw = dict(pad=(1, 1, 1, 1), residual=x)
    assert torch.equal(fmb.fused_mbconv(x, f, pw, **kw),
                       fmb.fused_mbconv(x, f, pw, **kw))


def test_fused_mbconv_rounds_once_on_the_card(dev):
    """bf16 fused-MBConv output rounds once (the project's A operand is the
    fp32 conv output split hi + lo): it is no farther from the fp32 answer
    for its bf16 operands than the bf16 composition of the dense conv and
    ``pwconv``, which rounds the conv output to bf16 in between."""
    for ci, c, co in ((16, 96, 24), (40, 240, 40)):
        x = _r((2, 14, 14, ci), dev, torch.bfloat16)
        f = _r((3, 3, ci, c), dev, torch.bfloat16, (9 * ci) ** -0.5)
        pw = _r((c, co), dev, torch.bfloat16, c ** -0.5)
        pad = (1, 1, 1, 1)
        exact = fmb.fused_mbconv_plain(x.float(), f.float(), pw.float(),
                                       pad=pad)
        xb, fb, pwb = x, f, pw
        fused = fmb.fused_mbconv(xb, fb, pwb, pad=pad)
        conv = ref.conv2d_ref(xb, fb, padding="same", activation="relu6")
        unfused = pwconv.pwconv(conv.reshape(-1, c), pwb).reshape(
            exact.shape)
        e_f = (fused.float() - exact).abs().max()
        e_u = (unfused.float() - exact).abs().max()
        assert e_f <= e_u


# (b, h, w, c, c_se, stride, k): MnasNet's SE blocks 3, 4, 10, 11, 12, 13
# at batch 2, then ragged C and C_se, and filters other than 3x3 and 5x5
DW_SE_CASES = [
    (2, 56, 56, 72, 6, 2, 5), (2, 28, 28, 120, 10, 1, 5),
    (2, 14, 14, 480, 20, 1, 3), (2, 14, 14, 672, 28, 1, 3),
    (2, 14, 14, 672, 28, 2, 5), (2, 7, 7, 960, 40, 1, 5),
    (3, 9, 11, 37, 5, 2, 3), (1, 5, 6, 13, 1, 1, 5), (2, 12, 10, 20, 4, 2, 7),
    (1, 9, 9, 8, 2, 1, 1),
]


def _dw_se_operands(dev, b, h, w, c, c_se, k, dtype):
    x = _r((b, h, w, c), dev, dtype)
    f, db = _r((k, k, c), dev, dtype, 1 / k), _r((c,), dev, dtype, 0.5)
    gate = (_r((c, c_se), dev, dtype, c ** -0.5), _r((c_se,), dev, dtype),
            _r((c_se, c), dev, dtype, c_se ** -0.5), _r((c,), dev, dtype))
    return x, f, db, gate


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("b,h,w,c,c_se,stride,k", DW_SE_CASES)
def test_dw_se_kernel(dev, b, h, w, c, c_se, stride, k, dtype):
    """The planned tile on the unpadded input with SAME's pads, and on the
    input padded first (pad 0): the same bits."""
    x, f, db, gate = _dw_se_operands(dev, b, h, w, c, c_se, k, dtype)
    pad = ref.same_pads(h, w, k, k, stride)
    got = se_epilogue.dw_se(x, f, *gate, db, stride=stride, pad=pad)
    want = se_epilogue.dw_se_plain(x, f, *gate, db, stride=stride, pad=pad)
    assert rel_err(got, want) <= TOL[dtype]
    xp = ref.pad_same(x, k, k, stride)
    assert torch.equal(se_epilogue.dw_se(xp, f, *gate, db, stride=stride),
                       got)


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("tile", [(1, 4, "vec"), (1, 4, None), (3, 8, 8),
                                  (5, 16, "vec"), (2, 12, 16)])
def test_dw_se_kernel_at_forced_tiles(dev, tile, dtype):
    """Tiles the planner would not pick: one row of one channel vector (a
    tile per run, many shares of the reduce FC an image), one row of the
    planner's channels, and tiles ragged at every edge of the output;
    C = 44 leaves the last channel group part idle."""
    x, f, db, gate = _dw_se_operands(dev, 2, 19, 23, 44, 5, 3, dtype)
    pad = ref.same_pads(19, 23, 3, 3, 2)
    th, tw, cg = tile
    cg = 16 // x.element_size() if cg == "vec" else cg
    got = se_epilogue.dw_se(x, f, *gate, db, stride=2, pad=pad, slab_h=th,
                            tile_w=tw, block_c=cg)
    want = se_epilogue.dw_se_plain(x, f, *gate, db, stride=2, pad=pad)
    assert rel_err(got, want) <= TOL[dtype]


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("b,h,w,c,c_se,stride,k", [
    (2, 28, 28, 672, 28, 1, 3), (2, 160, 160, 72, 6, 2, 5)])
def test_dw_se_kernel_at_big_shapes(dev, b, h, w, c, c_se, stride, k, dtype):
    """MnasNet's block 11 at a 224 input and block 3 at 320 (where one
    cluster an image could not hold the DW output): the planned tile
    holds the plain version, and two calls give the same bits."""
    x, f, db, gate = _dw_se_operands(dev, b, h, w, c, c_se, k, dtype)
    pad = ref.same_pads(h, w, k, k, stride)
    got = se_epilogue.dw_se(x, f, *gate, db, stride=stride, pad=pad)
    want = se_epilogue.dw_se_plain(x, f, *gate, db, stride=stride, pad=pad)
    assert rel_err(got, want) <= TOL[dtype]
    assert torch.equal(
        se_epilogue.dw_se(x, f, *gate, db, stride=stride, pad=pad), got)


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_dw_se_graph_replay_equals_eager(dev, dtype):
    """No float atomics and no state kept between calls: a CUDA graph of
    three calls, replayed twice, gives the eager call's bits each time, at
    batch 1 and 8."""
    for b in (1, 8):
        x, f, db, gate = _dw_se_operands(dev, b, 28, 28, 120, 10, 5,
                                         dtype)
        pad = ref.same_pads(28, 28, 5, 5, 1)
        eager = se_epilogue.dw_se(x, f, *gate, db, pad=pad)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            se_epilogue.dw_se(x, f, *gate, db, pad=pad)
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outs = [se_epilogue.dw_se(x, f, *gate, db, pad=pad)
                    for _ in range(3)]
        for _ in range(2):
            for o in outs:
                o.zero_()
            graph.replay()
            torch.cuda.synchronize(dev)
            for o in outs:
                assert torch.equal(o, eager)
        assert torch.equal(se_epilogue.dw_se(x, f, *gate, db, pad=pad),
                           eager)


def test_dw_se_smem_model_matches_the_kernel(dev):
    """Each pass's shared memory, as the planner models it, is the
    kernel's own count."""
    for dtype in (torch.float32, torch.bfloat16):
        for ho, c, c_se, k, s in ((28, 72, 6, 5, 2), (28, 120, 10, 5, 1),
                                  (14, 672, 28, 3, 1), (7, 960, 40, 5, 1),
                                  (9, 37, 5, 7, 2)):
            for b in (1, 8):
                p = blocking.plan_dw_se_tile(ho, ho, c, c_se, k, k,
                                             stride=s, dtype=dtype, batch=b)
                args = (p.slab_h, p.tile_w, p.block_c, k, k, s, c_se)
                for pass_ in (1, 2):
                    assert se_epilogue.smem_bytes(pass_, *args, dtype) == \
                        blocking.dw_se_smem_bytes(pass_, *args, dtype)
                assert p.smem_bytes == blocking.dw_se_smem_bytes(1, *args,
                                                                 dtype)


@pytest.mark.parametrize("budget", [64, 1500, 232_448])
def test_ops_separable_fused_degrades_by_budget(dev, budget):
    x = _r((1, 8, 8, 16), dev, torch.float32)
    ew = _r((16, 96), dev, torch.float32, 0.25)
    f, pw = _r((3, 3, 96), dev, torch.float32, 1 / 3), \
        _r((96, 16), dev, torch.float32, 0.1)
    got = ops.separable_fused(x, f, pw, residual=x, expand_w=ew,
                              smem_budget=budget)
    want = ops.separable_fused(x, f, pw, residual=x, expand_w=ew,
                               impl="torch")
    assert rel_err(got, want) <= 1e-5


@pytest.mark.parametrize("fused", (None, False))
@pytest.mark.parametrize("arch", tuple(ARCHS))
def test_network_launches_the_planned_kernels(dev, arch, fused):
    spec = ARCHS[arch](0.5)
    params = network.init_network(spec, seed=0, device=dev)
    x = _r((2, 32, 32, spec.c_in), dev, torch.float32)
    pol = KernelPolicy(fused=fused)
    plan = network.plan_network(spec, x.shape, policy=pol)
    network.clear_network_cache()
    reset_launch_counts()
    y = network.execute_network(spec, params, x, policy=pol)
    torch.cuda.synchronize(dev)
    planned = expected_launches(plan.segment_histogram())
    assert launch_counts() == _twice(planned)
    assert _replay_kernels(lambda: network.execute_network(
        spec, params, x, policy=pol)) == planned
    want = network.execute_network(
        spec, params, x, policy=KernelPolicy(impl="torch", fused=fused))
    assert rel_err(y, want) <= 1e-4


#: Launches one forward makes at width 1.0 and 112x112, by network and plan.
NETWORK_LAUNCHES = {
    ("mnasnet", None): {"separable_fused2": 1, "separable_fused3": 7,
                        "pwconv": 16, "dw_se": 8},
    ("mnasnet", False): {"dwconv2d": 16, "pwconv": 47},
    ("lite0", None): {"separable_fused2": 1, "fused_mbconv": 4,
                      "separable_fused3": 11},
    ("lite0", False): {"dwconv2d": 12, "pwconv": 27},
}


def test_mnasnet_at_224_runs_eight_dw_se(dev):
    """MnasNet-A1 at a 224 body input plans the reference's segments: 8
    ``dw_se``, each one launch of its two passes."""
    spec = ARCHS["mnasnet"]()
    params = network.init_network(spec, seed=2, device=dev)
    x = _r((1, 224, 224, spec.c_in), dev, torch.float32)
    network.clear_network_cache()
    reset_launch_counts()
    y = network.execute_network(spec, params, x)
    torch.cuda.synchronize(dev)
    want = dict.fromkeys(launch_counts(), 0)
    want.update(NETWORK_LAUNCHES[("mnasnet", None)])
    assert launch_counts() == _twice(want)
    assert _replay_kernels(lambda: network.execute_network(
        spec, params, x)) == want
    assert want["dw_se"] == 8
    ref_y = network.execute_network(spec, params, x,
                                    policy=KernelPolicy(impl="torch"))
    assert rel_err(y, ref_y) <= 1e-4


@pytest.mark.parametrize("fused", (None, False))
@pytest.mark.parametrize("arch", ("mnasnet", "lite0"))
def test_network_launch_counts_at_full_width(dev, arch, fused):
    spec = ARCHS[arch]()
    params = network.init_network(spec, seed=1, device=dev)
    x = _r((1, 112, 112, spec.c_in), dev, torch.float32)
    pol = KernelPolicy(fused=fused)
    network.clear_network_cache()
    reset_launch_counts()
    y = network.execute_network(spec, params, x, policy=pol)
    torch.cuda.synchronize(dev)
    want = dict.fromkeys(launch_counts(), 0)
    want.update(NETWORK_LAUNCHES[(arch, fused)])
    assert launch_counts() == _twice(want)
    assert _replay_kernels(lambda: network.execute_network(
        spec, params, x, policy=pol)) == want
    ref_y = network.execute_network(
        spec, params, x, policy=KernelPolicy(impl="torch", fused=fused))
    assert rel_err(y, ref_y) <= 1e-4


def test_kernel_refuses_an_uncompiled_dtype_pair(dev):
    x = _r((1, 6, 6, 8), dev, torch.float32)
    with pytest.raises(ValueError, match="no kernel for stream"):
        dwconv2d.dwconv2d(x, _r((3, 3, 8), dev, torch.float32),
                          out_dtype=torch.bfloat16)


# ---------------------------------------------------------------------------
# The xLSTM serving slice: dwconv1d, pwconv at its Linear shapes, the path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("b,l,d,k,rows", [
    (8, 512, 1536, 4, 8), (8, 512, 768, 4, 8), (2, 1000, 1000, 4, 7),
    (2, 37, 1002, 4, 8), (1, 50, 20, 3, 3), (2, 64, 48, 5, 16),
    (3, 1, 64, 4, 8), (3, 2, 64, 4, 8), (2, 9, 24, 1, 4), (2, 19, 16, 7, 5),
    (1, 30, 13, 2, 8)])
def test_dwconv1d_kernel(dev, b, l, d, k, rows, dtype):
    """Vector and scalar channels, ragged runs, L < K-1, exact K = 2..5 and
    the runtime-K loop (K = 1 and 7)."""
    from repro_torch.kernels import dwconv1d
    x = _r((b, l, d), dev, dtype)
    f = _r((k, d), dev, dtype, k ** -0.5)
    got = dwconv1d.dwconv1d_causal(x, f, rows=rows)
    want = dwconv1d.dwconv1d_causal_plain(x, f)
    assert got.dtype == dtype and got.shape == x.shape
    assert rel_err(got, want) <= TOL[dtype]


def test_dwconv1d_kernel_checks_operands(dev):
    from repro_torch.kernels import dwconv1d
    x = _r((2, 8, 16), dev, torch.float32)
    with pytest.raises(ValueError, match="x is torch.float32 but f"):
        dwconv1d.dwconv1d_causal(x, _r((4, 16), dev, torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        dwconv1d.dwconv1d_causal(x.transpose(0, 1), _r((4, 16), dev,
                                                       torch.float32))
    before = dwconv1d.launches
    dwconv1d.dwconv1d_causal(x, _r((4, 16), dev, torch.float32))
    assert dwconv1d.launches == before + 1


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("g,ci,co,act", [(8, 768, 3072, None),
                                         (1024, 768, 1024, "silu"),
                                         (8, 1536, 1536, None),
                                         (1, 1536, 8, None)])
def test_pwconv_kernel_at_xlstm_shapes(dev, g, ci, co, act, dtype):
    x = _r((g, ci), dev, dtype)
    w = _r((ci, co), dev, dtype, ci ** -0.5)
    got = pwconv.pwconv(x, w, activation=act)
    want = pwconv.pwconv_plain(x, w, activation=act)
    assert rel_err(got, want) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_xlstm_serving_launches_and_matches_the_plain_path(dev, dtype):
    import dataclasses

    from repro_torch.configs import xlstm_125m
    from repro_torch.launch import serve
    from repro_torch.models.transformer import init_params
    from repro_torch.serve import serve_step as S
    cfg = dataclasses.replace(xlstm_125m.smoke_config(), dtype=dtype)
    model = init_params(cfg, seed=0, device=dev)
    toks = torch.randint(0, cfg.vocab_size, (2, 21),
                         generator=torch.Generator().manual_seed(0)).to(dev)
    plain = KernelPolicy(impl="torch")
    tol = 1e-4 if dtype == "float32" else 5e-2
    serve.reset_launch_counts()
    logits, cache = S.prefill(model, toks, max_len=32)
    torch.cuda.synchronize(dev)
    assert serve.launch_counts() == serve.expected_launches(cfg, "prefill")
    ref_logits, ref_cache = S.prefill(model, toks, max_len=32, policy=plain)
    assert rel_err(logits, ref_logits) <= tol
    nxt = logits.argmax(-1)[:, None]
    serve.reset_launch_counts()
    logits, _ = S.decode_step(model, cache, nxt)
    torch.cuda.synchronize(dev)
    assert serve.launch_counts() == serve.expected_launches(cfg, "decode")
    ref_logits, _ = S.decode_step(model, ref_cache, nxt, policy=plain)
    assert rel_err(logits, ref_logits) <= tol


def test_serve_launcher_on_the_card(dev, capsys):
    from repro_torch.launch import serve
    assert serve.main(["--arch", "xlstm-125m", "--smoke", "--batch", "2",
                       "--prompt-len", "9", "--gen", "4"]) == 0
    out = capsys.readouterr().out
    assert "on cuda" in out and "'dwconv1d': 4" in out


# ---------------------------------------------------------------------------
# The captured calls: execute_network's CUDA graph, the captured serving
# steps, each against the eager path
# ---------------------------------------------------------------------------


def _small_net(arch, dtype, dev, seed=0):
    spec = ARCHS[arch](0.5)
    params = network.init_network(spec, seed=seed, device=dev)
    if dtype == torch.bfloat16:
        params = network.cast_network_params(params, dtype)
    x = _r((2, 32, 32, spec.c_in), dev, torch.float32, seed=seed)
    return spec, params, x


def _eager(spec, params, x, pol):
    plan = network.plan_network(spec, x.shape, policy=pol)
    with torch.inference_mode():
        return network.build_network_fn(spec, plan, pol)(params, x)


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("fused", (None, False))
@pytest.mark.parametrize("arch", tuple(ARCHS))
def test_network_graph_equals_eager(dev, arch, fused, dtype):
    """The replayed graph gives the eager runner's bits, at its capture and
    at a later call on another input.  The wrappers count two forwards in
    the capturing call (its warm-up and its recording), none in a replay
    and one in an eager forward; the graph recorded one forward, and a
    replay runs one forward's kernels (profiler trace)."""
    from repro_torch.kernels.policy import BF16_STREAM, NATIVE
    spec, params, x = _small_net(arch, dtype, dev)
    pol = KernelPolicy(fused=fused, dtype_policy=BF16_STREAM
                       if dtype == torch.bfloat16 else NATIVE)
    plan = network.plan_network(spec, x.shape, policy=pol)
    want = expected_launches(plan.segment_histogram())
    network.clear_network_cache()
    counts = []
    outs = []
    for inp in (x, x, x.flip(1)):
        reset_launch_counts()
        outs.append(network.execute_network(spec, params, inp, policy=pol))
        torch.cuda.synchronize(dev)
        counts.append(launch_counts())
        reset_launch_counts()
        outs.append(_eager(spec, params, inp, pol))
        torch.cuda.synchronize(dev)
        counts.append(launch_counts())
    zero = dict.fromkeys(want, 0)
    assert counts == [_twice(want), want, zero, want, zero, want]
    _, graph = network.execute_network_graph(spec, params, x, policy=pol)
    assert {k: graph.launches.get(k, 0) for k in want} == want
    assert _replay_kernels(lambda: network.execute_network(
        spec, params, x, policy=pol)) == want
    for graph_y, eager_y in zip(outs[::2], outs[1::2]):
        assert torch.equal(graph_y, eager_y)
    assert outs[0].data_ptr() != outs[2].data_ptr()
    assert not torch.equal(outs[0], outs[4])
    network.clear_network_cache()


def test_network_graph_per_param_set_and_in_place_updates(dev):
    """A second param set gets its own graph and its own output; a weight
    updated in place is read by the next replay."""
    spec, p1, x = _small_net("v2", torch.float32, dev)
    _, p2, _ = _small_net("v2", torch.float32, dev, seed=1)
    pol = KernelPolicy()
    network.clear_network_cache()
    y1 = network.execute_network(spec, p1, x)
    y2 = network.execute_network(spec, p2, x)
    assert len(network._NETWORK_CACHE) == 2
    assert torch.equal(y1, _eager(spec, p1, x, pol))
    assert torch.equal(y2, _eager(spec, p2, x, pol))
    assert not torch.equal(y1, y2)
    assert torch.equal(network.execute_network(spec, p1, x), y1)
    with torch.inference_mode():
        p1[3][0]["w"].mul_(1.5)
    y3 = network.execute_network(spec, p1, x)
    assert len(network._NETWORK_CACHE) == 2
    assert not torch.equal(y3, y1)
    assert torch.equal(y3, _eager(spec, p1, x, pol))
    network.clear_network_cache()


def test_network_call_inside_an_outer_capture(dev):
    """Called while a capture is under way, execute_network runs its eager
    runner, which the outer graph records and replays."""
    spec, params, x = _small_net("mnasnet", torch.float32, dev)
    network.clear_network_cache()
    want = network.execute_network(spec, params, x)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        network.execute_network(spec, params, x)
    torch.cuda.current_stream(dev).wait_stream(side)
    outer = torch.cuda.CUDAGraph()
    with torch.cuda.graph(outer):
        got = network.execute_network(spec, params, x)
    with torch.inference_mode():
        got.zero_()
    outer.replay()
    torch.cuda.synchronize(dev)
    assert torch.equal(got, want)
    del outer
    network.clear_network_cache()


def test_clear_network_cache_returns_the_pools_memory(dev):
    spec, params, x = _small_net("v2", torch.float32, dev)
    x = _r((8, 112, 112, spec.c_in), dev, torch.float32)
    network.clear_network_cache()
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated(dev)
    reserved = torch.cuda.memory_reserved(dev)
    y = network.execute_network(spec, params, x)
    torch.cuda.synchronize(dev)
    held = torch.cuda.memory_allocated(dev) - before - y.nbytes
    assert held > x.nbytes         # the input buffer and the graph's pool
    del y
    torch.cuda.empty_cache()
    assert torch.cuda.memory_reserved(dev) > reserved   # the pool is kept
    network.clear_network_cache()
    assert torch.cuda.memory_allocated(dev) == before
    assert torch.cuda.memory_reserved(dev) <= reserved


def test_failed_capture_memoizes_nothing(dev, monkeypatch):
    """A capture that fails raises, runs nothing eagerly in its place and
    leaves no memo entry; the next call captures afresh."""
    from repro_torch import graphs
    spec, params, x = _small_net("v1", torch.float32, dev)
    network.clear_network_cache()
    real = graphs.capture

    def fails(fn, device=None):
        raise RuntimeError("capture failed")
    monkeypatch.setattr(graphs, "capture", fails)
    with pytest.raises(RuntimeError, match="capture failed"):
        network.execute_network(spec, params, x)
    assert not network._NETWORK_CACHE
    monkeypatch.setattr(graphs, "capture", real)
    y = network.execute_network(spec, params, x)
    assert len(network._NETWORK_CACHE) == 1
    assert torch.equal(y, _eager(spec, params, x, KernelPolicy()))
    network.clear_network_cache()


#: A pwconv problem whose ``simt`` grid needs more than 65535 CTAs in y:
#: a launch the driver refuses for its configuration (the context
#: survives it).
BAD_PW_CO = 65535 * 128 + 1


def _invalid_pwconv_launch(dev):
    x = torch.ones((1, 1), device=dev)
    w = torch.ones((1, BAD_PW_CO), device=dev)
    return pwconv.pwconv(x, w, variant="simt")


def test_captured_forward_recaptures_after_a_quarantine_write(dev, tmp_path):
    """Under ``on_failure="degrade"`` an injected fused-kernel fault fails
    the first call's warm-up; the call recovers block by block, eagerly,
    and writes the bans; the next call re-plans around them and captures a
    new graph, which launches the unfused kernels and gives the eager
    runner's bits."""
    from repro_torch.runtime import faultinject, quarantine, telemetry
    spec, params, x = _small_net("v2", torch.float32, dev)
    pol = KernelPolicy(on_failure="degrade",
                       tune_cache=str(tmp_path / "tune.json"))
    network.clear_network_cache()
    telemetry.reset_runtime_telemetry()
    want = _eager(spec, params, x, KernelPolicy())
    faultinject.arm("lowering:separable_fused", times=faultinject.PERSISTENT)
    try:
        with pytest.warns(RuntimeWarning, match="runtime ladder"):
            y1, g1 = network.execute_network_graph(spec, params, x,
                                                   policy=pol)
        rep = telemetry.runtime_report()
        assert g1 is None and not network._NETWORK_CACHE
        assert rep["fallbacks"] == rep["injected_fallbacks"] == sum(
            faultinject.fired_counts().values()) > 0
        assert rel_err(y1, want) <= 1e-4
        q = quarantine.Quarantine.load(quarantine.quarantine_path(pol))
        assert {b for k in q.entries for b in q.banned(k)} == {"fused2",
                                                               "fused3"}
        plan = network.plan_network(spec, x.shape, policy=pol)
        hist = plan.segment_histogram()
        assert set(hist) == {"pw", "dw"}
        telemetry.reset_runtime_telemetry()
        reset_launch_counts()
        y2, g2 = network.execute_network_graph(spec, params, x, policy=pol)
        torch.cuda.synchronize(dev)
        assert g2 is not None and len(network._NETWORK_CACHE) == 1
        assert launch_counts() == _twice(expected_launches(hist))
        assert telemetry.fallback_count() == 0
        assert torch.equal(y2, _eager(spec, params, x, pol))
        assert rel_err(y2, want) <= 1e-4
        assert torch.equal(network.execute_network(spec, params, x,
                                                   policy=pol), y2)
    finally:
        faultinject.disarm_all()
        quarantine.clear_memo()
        network.clear_network_cache()


def test_launch_error_in_a_tuning_capture_folds_to_inf(dev, tmp_path,
                                                       monkeypatch):
    """Under ``on_failure="degrade"``, a candidate whose capture makes a
    launch the driver refuses reaches the tuner as the launch error itself
    (not the capture's "invalidated" error) and loses at its first attempt
    with an infinite time, listed in the entry's ``failed``; the
    candidates after it capture and time as before, and a capture and
    ``empty_cache`` after the tune work.  Under the default ``"raise"``
    the same refusal raises and writes no cache."""
    import warnings
    from repro_torch import graphs
    from repro_torch.core import chain
    from repro_torch.kernels import _build, autotune, lowering
    spec = chain.SeparableSpec((chain.PW(64),))
    params = chain.init_chain(torch.Generator().manual_seed(0), spec, 32,
                              device=dev)
    x = _r((2, 16, 16, 32), dev, torch.float32)
    pol = KernelPolicy(autotune=True, tune_cache=str(tmp_path / "t.json"),
                       on_failure="degrade")
    base = chain.plan(spec, x.shape, policy=KernelPolicy())
    real = lowering.lower
    bad = []

    def lower(spec_, cp, policy=None):
        run = real(spec_, cp, policy)
        if cp == base or bad:
            return run
        bad.append(cp)

        def refused(p, y):
            if torch.cuda.is_current_stream_capturing():
                _invalid_pwconv_launch(dev)
            return run(p, y)
        return refused
    monkeypatch.setattr(lowering, "lower", lower)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        r = autotune.autotune_chain(spec, params, x, policy=pol,
                                    base_plan=base)
    assert len(bad) == 1 and len(r.failed) == 1
    assert "KernelLaunchError" in r.failed[0]["error"]
    # the default policy folds nothing
    bad.clear()
    raising = KernelPolicy(autotune=True,
                           tune_cache=str(tmp_path / "raise.json"))
    with pytest.raises(_build.KernelLaunchError) as info:
        autotune.autotune_chain(spec, params, x, policy=raising,
                                base_plan=base)
    assert any("nothing was written" in n for n in info.value.__notes__)
    assert not (tmp_path / "raise.json").exists()
    torch.cuda.synchronize(dev)
    assert "pwconv kernel launch failed: CUDA error" in r.failed[0]["error"]
    assert r.measured_us < float("inf")
    assert len(r.measured) == r.n_measured - 1 >= 1
    entry = autotune.TuneCache.load(pol.tune_cache).get(r.key)
    assert entry["failed"] == list(r.failed)
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    monkeypatch.setattr(lowering, "lower", real)
    y = real(spec, r.plan, KernelPolicy())(params, x)
    g = graphs.capture(lambda: real(spec, r.plan, KernelPolicy())(params, x),
                       dev)
    torch.cuda.synchronize(dev)
    assert torch.equal(g.output, y)


def test_real_launch_error_is_a_lowering_failure_and_the_context_lives(dev):
    """A launch the driver refuses raises ``KernelLaunchError`` with a
    launch-configuration code, which the runtime classifies as a
    ``LoweringFailure``; inside a capture the same error, not the
    capture's, propagates; the kernel then launches and matches its plain
    version."""
    from repro_torch import graphs
    from repro_torch.kernels import _build
    from repro_torch.runtime import failures
    with pytest.raises(_build.KernelLaunchError) as info:
        _invalid_pwconv_launch(dev)
    assert info.value.code in failures.LOWERING_CODES
    assert isinstance(failures.classify(info.value),
                      failures.LoweringFailure)
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(_build.KernelLaunchError):
        graphs.record(graph, lambda: _invalid_pwconv_launch(dev), dev)
    assert not torch.cuda.is_current_stream_capturing()
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    x, w, b = _pw_operands(dev, 300, 64, 96, torch.float32)
    got = pwconv.pwconv(x, w, b, activation="relu6")
    want = pwconv.pwconv_plain(x, w, b, activation="relu6")
    assert rel_err(got, want) <= TOL[torch.float32]
    g = graphs.capture(lambda: pwconv.pwconv(x, w, b, activation="relu6"),
                       dev)
    assert torch.equal(g.output, got)


def test_real_launch_error_in_an_unfused_network_raises_under_degrade(
        dev, tmp_path):
    """A network whose ``pw`` segment the driver refuses (more than 65535
    CTAs in y at any ``stream`` tile): under ``on_failure="degrade"`` no
    kernel rung is left below ``pwconv`` and only an injected fault may
    reach the plain version, so the ``LoweringFailure`` raises with
    nothing quarantined, memoized or recovered.  The refusal fails only
    itself: the next network, whose ``pw`` segments launch the same
    library, captures its graph with no fallback and gives the eager
    runner's bits, and ``pwconv`` matches its plain version."""
    import os
    import warnings
    from repro_torch.core import chain
    from repro_torch.runtime import failures, quarantine, telemetry
    net = network.NetworkSpec(name="refused-pw", c_in=1, blocks=(
        chain.SeparableSpec((chain.PW(65535 * 256 + 1),)),))
    params = network.init_network(net, seed=0, device=dev)
    pol = KernelPolicy(fused=False, on_failure="degrade",
                       tune_cache=str(tmp_path / "tune.json"))
    network.clear_network_cache()
    telemetry.reset_runtime_telemetry()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        with pytest.raises(failures.LoweringFailure) as info:
            network.execute_network(net, params,
                                    torch.ones((1, 1, 1, 1), device=dev),
                                    policy=pol)
    assert info.value.segment_kind == "pw" and not info.value.injected
    assert info.value.original.code in failures.LOWERING_CODES
    assert not os.path.exists(quarantine.quarantine_path(pol))
    assert not network._NETWORK_CACHE
    assert telemetry.runtime_report()["recoveries"] == 0
    del params
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    spec, params, x = _small_net("v1", torch.float32, dev)
    telemetry.reset_runtime_telemetry()
    y, graph = network.execute_network_graph(spec, params, x, policy=pol)
    assert graph is not None and telemetry.fallback_count() == 0
    assert torch.equal(y, _eager(spec, params, x, pol))
    network.clear_network_cache()
    xp, w, b = _pw_operands(dev, 300, 64, 96, torch.float32)
    assert rel_err(pwconv.pwconv(xp, w, b, activation="relu6"),
                   pwconv.pwconv_plain(xp, w, b, activation="relu6")
                   ) <= TOL[torch.float32]


def test_record_survives_an_invalidated_capture(dev):
    """A captured function that invalidates the capture (a sync while
    capturing): ``graphs.record`` lets the function's own error out, with
    the capture's as a note, leaves the stream out of capture mode and
    restored; the allocator, ``empty_cache`` and a new capture then work
    without releasing the failed graph's pool."""
    from repro_torch import graphs
    a = torch.ones(1000, device=dev)

    def syncs():
        b = a * 2
        torch.cuda.synchronize(dev)
        return b
    before = torch.cuda.current_stream(dev)
    with pytest.raises(RuntimeError, match="not permitted") as info:
        graphs.record(torch.cuda.CUDAGraph(), syncs, dev)
    assert any("capture was abandoned" in n for n in info.value.__notes__)
    assert not torch.cuda.is_current_stream_capturing()
    assert torch.cuda.current_stream(dev) == before
    torch.cuda.empty_cache()
    assert float(torch.ones(10 ** 6, device=dev).sum()) == 10 ** 6
    g = graphs.capture(lambda: a * 3, dev)
    torch.cuda.synchronize(dev)
    assert float(g.output.sum()) == 3000.0
    torch.cuda.empty_cache()


#: A tuning candidate's block against its plain version: the kernel
#: tolerances of ``chip_smoke.py`` (summation order in fp32; one bf16
#: rounding of a kernel's output in bf16).
BLOCK_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


@pytest.mark.parametrize("fused", (None, False))
@pytest.mark.parametrize("arch", tuple(ARCHS))
def test_every_tuning_candidate_launches_and_matches(dev, arch, fused):
    """Every candidate the autotuner may measure, for every segment of the
    four bodies at 112x112, batch 1 and 8, fp32 and bf16, launches on its
    block's real input and matches the block's plain version."""
    import dataclasses
    from repro_torch.kernels import autotune, lowering
    from repro_torch.kernels.policy import BF16_STREAM, NATIVE
    net = ARCHS[arch](1.0)
    params32 = network.init_network(net, seed=0, device=dev)
    checked = 0
    for batch in (1, 8):
        x = _r((batch, 112, 112, net.c_in), dev, torch.float32)
        for dtype in (torch.float32, torch.bfloat16):
            bf16 = dtype == torch.bfloat16
            params = (network.cast_network_params(params32, dtype) if bf16
                      else params32)
            pol = KernelPolicy(fused=fused,
                               dtype_policy=BF16_STREAM if bf16 else NATIVE)
            nplan = network.plan_network(net, x.shape, policy=pol)
            policies = network.resolve_block_policies(net, pol)
            y = x
            with torch.inference_mode():
                for spec, cp, p, bpol in zip(net.blocks, nplan.plans, params,
                                             policies):
                    want = lowering.lower(spec, cp, dataclasses.replace(
                        bpol, impl="torch"))(p, y)
                    geoms = autotune._segment_geoms(spec.stages, cp, y.shape)
                    for si, geom in enumerate(geoms):
                        for cand in autotune.segment_candidates(
                                geom, cp.segments[si].plan, dtype,
                                cp.smem_budget)[1:]:
                            got = lowering.lower(
                                spec, autotune._with_segment_plan(
                                    cp, si, cand), bpol)(p, y)
                            torch.cuda.synchronize(dev)
                            assert rel_err(got, want) <= BLOCK_TOL[dtype], (
                                si, geom, cand)
                            checked += 1
                    y = lowering.lower(spec, cp, bpol)(p, y)
    assert checked > 0


def test_tune_network_then_replay_measures_nothing(dev, tmp_path,
                                                   monkeypatch):
    """``tune_network`` measures on the card and persists; a second one on
    the file loaded again measures and launches nothing; the tuned graph
    path captures two forwards (no measurement) and gives the tuned eager
    runner's bits."""
    from repro_torch import graphs
    from repro_torch.kernels import autotune
    spec, params, x = _small_net("mnasnet", torch.float32, dev)
    pol = KernelPolicy(autotune=True, tune_cache=str(tmp_path / "t.json"))
    r = network.tune_network(spec, params, x, policy=pol)
    assert not r.cache_hit and r.n_measured > 0
    assert all(t > 0 for _, _, t in r.measured)

    def boom(*a, **k):
        raise AssertionError("a replay must not measure")
    monkeypatch.setattr(autotune, "measure_run", boom)
    graphs.reset()
    r2 = network.tune_network(spec, params, x, policy=pol)
    assert r2.cache_hit and r2.n_measured == 0 and r2.plan == r.plan
    assert not any(graphs.snapshot().values())
    network.clear_network_cache()
    reset_launch_counts()
    y = network.execute_network(spec, params, x, policy=pol)
    torch.cuda.synchronize(dev)
    assert launch_counts() == _twice(expected_launches(
        r.plan.segment_histogram()))
    with torch.inference_mode():
        y_eager = network.build_network_fn(spec, r.plan, pol)(params, x)
    assert torch.equal(y, y_eager)
    network.clear_network_cache()


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_captured_prefill_and_decode_match_eager(dev, dtype):
    """The captured prefill and 32 captured greedy decode steps against the
    eager ones, call by call: the same bits and the same tokens.  Each
    capture counts two calls' launches (warm-up and recording), a replay
    none, and a replay runs one call's kernels (profiler trace).  The
    captured step is first handed the prefill's cache (copied in), then its
    own."""
    import dataclasses

    from repro_torch.configs import xlstm_125m
    from repro_torch.launch import serve
    from repro_torch.models.transformer import init_params
    from repro_torch.serve import serve_step as S
    from repro_torch.serve.sampler import greedy
    cfg = dataclasses.replace(xlstm_125m.smoke_config(), dtype=dtype)
    model = init_params(cfg, seed=0, device=dev)
    toks = torch.randint(0, cfg.vocab_size, (2, 21),
                         generator=torch.Generator().manual_seed(0)).to(dev)
    serve.reset_launch_counts()
    pre = S.capture_prefill(model, 2, 21, max_len=64)
    torch.cuda.synchronize(dev)
    want = serve.expected_launches(cfg, "prefill")
    assert serve.launch_counts() == _twice(want)
    serve.reset_launch_counts()
    step = S.capture_decode_step(model, 2, 64)
    torch.cuda.synchronize(dev)
    want_step = serve.expected_launches(cfg, "decode")
    assert serve.launch_counts() == _twice(want_step)
    zero = dict.fromkeys(want, 0)
    with torch.inference_mode():
        assert _replay_kernels(lambda: pre(toks), want) == want
        serve.reset_launch_counts()
        logits, cache = pre(toks)
        torch.cuda.synchronize(dev)
        assert serve.launch_counts() == zero
        ref_logits, ref_cache = S.prefill(model, toks, max_len=64)
    assert torch.equal(logits, ref_logits)
    for a, b in zip(cache["layers"], ref_cache["layers"]):
        assert all(torch.equal(a[k], b[k]) for k in a)
    own = cache
    tok = ref_tok = greedy(logits)[:, None]
    with torch.inference_mode():
        for _ in range(32):
            serve.reset_launch_counts()
            logits, own = step(own, tok)
            torch.cuda.synchronize(dev)
            assert serve.launch_counts() == zero
            ref_logits, ref_cache = S.decode_step(model, ref_cache, ref_tok)
            assert torch.equal(logits, ref_logits)
            tok, ref_tok = greedy(logits)[:, None], greedy(ref_logits)[:, None]
            assert torch.equal(tok, ref_tok)
    assert own is step.cache
    assert torch.equal(own["pos"], ref_cache["pos"])
    for a, b in zip(own["layers"], ref_cache["layers"]):
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert _replay_kernels(lambda: step(step.cache, tok),
                           want_step) == want_step


# ---------------------------------------------------------------------------
# hymba-1.5b serving: the kernels at its shapes, the smoke model's captured
# prefill and decode steps, the in-place ring write, the launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("g,ci,co,act", [(2 * 1664, 1600, 6400, None),
                                         (2 * 1664, 3200, 132, None),
                                         (2 * 1664, 100, 3200, None),
                                         (2 * 1664, 1600, 5504, "silu"),
                                         (8, 1600, 6400, None),
                                         (8, 3200, 132, None),
                                         (8, 100, 3200, None)])
def test_pwconv_kernel_at_hymba_shapes(dev, g, ci, co, act, dtype):
    """The Linears of a hymba layer (w_in, w_bcdt, w_dt, the MLP's gate)
    at a prefill's and a decode step's G, at the variant the planner picks
    (w_bcdt and w_dt are simt in bf16: 132 and 100 are not multiples of
    8)."""
    x = _r((g, ci), dev, dtype)
    w = _r((ci, co), dev, dtype, ci ** -0.5)
    variant = blocking.pw_variant(g, ci, co, dtype)
    before = pwconv.launches_by_variant[variant]
    got = pwconv.pwconv(x, w, activation=act)
    assert pwconv.launches_by_variant[variant] == before + 1
    assert rel_err(got, pwconv.pwconv_plain(x, w, activation=act)) <= TOL[
        dtype]


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_dwconv1d_kernel_at_hymba_shape(dev, dtype):
    from repro_torch.kernels import dwconv1d
    x = _r((2, 1664, 3200), dev, dtype)
    f = _r((4, 3200), dev, dtype, 0.5)
    assert rel_err(dwconv1d.dwconv1d_causal(x, f),
                   dwconv1d.dwconv1d_causal_plain(x, f)) <= TOL[dtype]


def _hymba_smoke(dev, dtype):
    import dataclasses

    from repro_torch.configs import hymba_1_5b
    from repro_torch.models.transformer import init_params
    cfg = dataclasses.replace(hymba_1_5b.smoke_config(), dtype=dtype)
    return init_params(cfg, seed=0, device=dev)


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_hymba_captured_prefill_and_decode_match_eager(dev, dtype):
    """The smoke model at a 100-token prompt (108 positions: blockwise
    attention, the 40-slot ring) and 24 greedy steps, captured against
    eager, call by call: the same bits and tokens; launches as counted
    (two calls in a capture, none in a replay, one call's kernels in a
    replay's trace); the eager calls within 1e-4 (fp32) / 5e-2 (bf16) of
    the plain path."""
    from repro_torch.launch import serve
    from repro_torch.serve import serve_step as S
    from repro_torch.serve.sampler import greedy
    model = _hymba_smoke(dev, dtype)
    cfg = model.cfg
    toks = torch.randint(0, cfg.vocab_size, (2, 100),
                         generator=torch.Generator().manual_seed(0)).to(dev)
    plain = KernelPolicy(impl="torch")
    tol = 1e-4 if dtype == "float32" else 5e-2
    serve.reset_launch_counts()
    pre = S.capture_prefill(model, 2, 100, max_len=160)
    torch.cuda.synchronize(dev)
    want = serve.expected_launches(cfg, "prefill")
    assert want == {"dwconv1d": 2, "pwconv": 22}
    assert serve.launch_counts() == _twice(want)
    serve.reset_launch_counts()
    step = S.capture_decode_step(model, 2, 160)
    torch.cuda.synchronize(dev)
    want_step = serve.expected_launches(cfg, "decode")
    assert serve.launch_counts() == _twice(want_step)
    zero = dict.fromkeys(want, 0)
    with torch.inference_mode():
        assert _replay_kernels(lambda: pre(toks), want) == want
        serve.reset_launch_counts()
        logits, cache = pre(toks)
        torch.cuda.synchronize(dev)
        assert serve.launch_counts() == zero
        serve.reset_launch_counts()
        ref_logits, ref_cache = S.prefill(model, toks, max_len=160)
        torch.cuda.synchronize(dev)
        assert serve.launch_counts() == want
        plain_logits, _ = S.prefill(model, toks, max_len=160, policy=plain)
    assert rel_err(ref_logits, plain_logits) <= tol
    assert torch.equal(logits, ref_logits)
    assert cache["layers"][0]["k"].shape[1] == 40
    for a, b in zip(cache["layers"], ref_cache["layers"]):
        assert torch.equal(a["k"], b["k"]) and torch.equal(a["v"], b["v"])
        assert all(torch.equal(a["mamba"][k], b["mamba"][k])
                   for k in ("h", "conv"))
    own = cache
    tok = ref_tok = greedy(logits)[:, None]
    with torch.inference_mode():
        for _ in range(24):
            serve.reset_launch_counts()
            logits, own = step(own, tok)
            torch.cuda.synchronize(dev)
            assert serve.launch_counts() == zero
            plain_logits, _ = S.decode_step(model, ref_cache, ref_tok,
                                            policy=plain)
            ref_logits, ref_cache = S.decode_step(model, ref_cache, ref_tok)
            assert torch.equal(logits, ref_logits)
            assert rel_err(ref_logits, plain_logits) <= tol
            tok, ref_tok = greedy(logits)[:, None], greedy(ref_logits)[:, None]
            assert torch.equal(tok, ref_tok)
    assert torch.equal(own["pos"], ref_cache["pos"])
    for a, b in zip(own["layers"], ref_cache["layers"]):
        assert torch.equal(a["k"], b["k"]) and torch.equal(a["v"], b["v"])
    assert _replay_kernels(lambda: step(step.cache, tok),
                           want_step) == want_step


def test_hymba_in_place_ring_write_matches_functional_decode_step(dev):
    """decode_step_into (each K/V slot scattered in place at a slot
    computed on the device) against the functional decode_step (the
    reference's one-hot select) over steps that wrap the ring, bit for
    bit, the static cache's tensors at their addresses."""
    from repro_torch import graphs
    from repro_torch.serve import serve_step as S
    model = _hymba_smoke(dev, "bfloat16")
    toks = torch.randint(0, 128, (3, 30),
                         generator=torch.Generator().manual_seed(1)).to(dev)
    with torch.inference_mode():
        logits, ref = S.prefill(model, toks, max_len=160)
        cache = S.init_cache(model.cfg, 3, 160, dev)
        graphs.copy_tree_(cache, ref)
        ks = [layer["k"].data_ptr() for layer in cache["layers"]]
        out = torch.empty_like(logits)
        tok = logits.argmax(-1)[:, None]
        for _ in range(20):                    # positions 38..57: wraps 40
            want, ref = S.decode_step(model, ref, tok)
            got, _ = S.decode_step_into(model, cache, tok, out)
            assert torch.equal(got, want)
            tok = want.argmax(-1)[:, None]
    for a, b in zip(cache["layers"], ref["layers"]):
        assert torch.equal(a["k"], b["k"]) and torch.equal(a["v"], b["v"])
    assert ks == [layer["k"].data_ptr() for layer in cache["layers"]]


def test_hymba_serve_launcher_on_the_card(dev, capsys):
    from repro_torch.launch import serve
    assert serve.main(["--arch", "hymba-1.5b", "--smoke", "--batch", "2",
                       "--prompt-len", "40", "--gen", "4",
                       "--max-len", "60"]) == 0
    out = capsys.readouterr().out
    assert "on cuda" in out and "'dwconv1d': 2" in out
    assert "'pwconv': 22" in out


# ---------------------------------------------------------------------------
# attention-MLP serving (dense, VLM, MoE): the kernel at qwen3-1.7b's
# shapes, each new arch's smoke model captured against eager, the MoE
# dispatch with no host sync, the int8 cache against its plain path
# ---------------------------------------------------------------------------

ATTN_MLP_ARCHS = ("smollm-360m", "qwen3-1.7b", "internvl2-1b",
                  "command-r-35b", "qwen1.5-110b", "qwen3-moe-235b-a22b",
                  "llama4-maverick-400b-a17b")


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("g,ci,co,act", [(2 * 512, 2048, 2048, None),
                                         (2 * 512, 2048, 1024, None),
                                         (2 * 512, 2048, 6144, "silu"),
                                         (2 * 512, 6144, 2048, None),
                                         (8, 2048, 6144, "silu"),
                                         (1, 6144, 2048, None)])
def test_pwconv_kernel_at_qwen3_shapes(dev, g, ci, co, act, dtype):
    """qwen3-1.7b's Linears (q/o, k/v, gate, down) at a prefill's and a
    decode step's G, at the variant the planner picks."""
    x = _r((g, ci), dev, dtype)
    w = _r((ci, co), dev, dtype, ci ** -0.5)
    variant = blocking.pw_variant(g, ci, co, dtype)
    before = pwconv.launches_by_variant[variant]
    got = pwconv.pwconv(x, w, activation=act)
    assert pwconv.launches_by_variant[variant] == before + 1
    assert rel_err(got, pwconv.pwconv_plain(x, w, activation=act)) <= TOL[
        dtype]


def _attn_mlp_smoke(dev, arch, dtype, **kw):
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.models.transformer import init_params
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype, **kw)
    return init_params(cfg, seed=0, device=dev)


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("arch", ATTN_MLP_ARCHS)
def test_attn_mlp_captured_prefill_and_decode_match_eager(dev, arch, dtype):
    """Each new arch's smoke model at a 100-token prompt (blockwise
    attention; with its frontend embeddings where it has them; llama4's
    sliding-window layers on 32-slot rings) and 24 greedy steps, captured
    against eager, call by call: the same bits and tokens; launches as
    counted (two calls in a capture, none in a replay, one call's kernels
    in a replay's trace); the eager calls within 1e-4 (fp32) / 5e-2 (bf16)
    of the plain path; the profiled replays step past ``max_len``, which
    writes nothing."""
    from repro_torch.launch import serve
    from repro_torch.serve import serve_step as S
    from repro_torch.serve.sampler import greedy
    model = _attn_mlp_smoke(dev, arch, dtype)
    cfg = model.cfg
    toks = torch.randint(0, cfg.vocab_size, (2, 100),
                         generator=torch.Generator().manual_seed(0)).to(dev)
    frontend = serve.frontend_stub(cfg, 2, dev)
    if frontend is not None:
        frontend.normal_(generator=torch.Generator(dev).manual_seed(1))
    flen = cfg.fusion_tokens
    max_len = flen + 100 + 24
    plain = KernelPolicy(impl="torch")
    tol = 1e-4 if dtype == "float32" else 5e-2
    serve.reset_launch_counts()
    pre = S.capture_prefill(model, 2, 100, max_len=max_len,
                            frontend_len=flen)
    torch.cuda.synchronize(dev)
    want = serve.expected_launches(cfg, "prefill")
    assert serve.launch_counts() == _twice(want)
    serve.reset_launch_counts()
    step = S.capture_decode_step(model, 2, max_len)
    torch.cuda.synchronize(dev)
    want_step = serve.expected_launches(cfg, "decode")
    assert serve.launch_counts() == _twice(want_step)
    zero = dict.fromkeys(want, 0)
    with torch.inference_mode():
        assert _replay_kernels(lambda: pre(toks, frontend), want) == want
        serve.reset_launch_counts()
        logits, cache = pre(toks, frontend)
        torch.cuda.synchronize(dev)
        assert serve.launch_counts() == zero
        serve.reset_launch_counts()
        ref_logits, ref_cache = S.prefill(model, toks, max_len=max_len,
                                          frontend=frontend)
        torch.cuda.synchronize(dev)
        assert serve.launch_counts() == want
        plain_logits, _ = S.prefill(model, toks, max_len=max_len,
                                    frontend=frontend, policy=plain)
    assert rel_err(ref_logits, plain_logits) <= tol
    assert torch.equal(logits, ref_logits)
    for a, b in zip(cache["layers"], ref_cache["layers"], strict=True):
        assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
    own = cache
    tok = ref_tok = greedy(logits)[:, None]
    with torch.inference_mode():
        for _ in range(24):
            serve.reset_launch_counts()
            logits, own = step(own, tok)
            torch.cuda.synchronize(dev)
            assert serve.launch_counts() == zero
            plain_logits, _ = S.decode_step(model, ref_cache, ref_tok,
                                            policy=plain)
            ref_logits, ref_cache = S.decode_step(model, ref_cache, ref_tok)
            assert torch.equal(logits, ref_logits)
            assert rel_err(ref_logits, plain_logits) <= tol
            tok, ref_tok = greedy(logits)[:, None], greedy(ref_logits)[:, None]
            assert torch.equal(tok, ref_tok)
    for a, b in zip(own["layers"], ref_cache["layers"], strict=True):
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert _replay_kernels(lambda: step(step.cache, tok),
                           want_step) == want_step


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_moe_dispatch_captures_with_no_host_sync(dev, dtype):
    """``moe_forward`` (a router skewed to one expert at a capacity that
    drops its copies, a shared expert) runs
    under ``torch.cuda.set_sync_debug_mode("error")``, which raises at any
    host sync; captured, its replay equals the eager call's bits, and its
    output the dense oracle's on tokens with no drop."""
    import dataclasses

    from repro_torch import graphs
    from repro_torch.configs.base import MoEConfig
    from repro_torch.models import moe
    cfg = MoEConfig(n_experts=8, top_k=2, d_ff_expert=64, n_shared=1,
                    capacity_factor=1.0)
    p = moe.MoE(32, cfg, 48, generator=torch.Generator().manual_seed(0),
                dtype=dtype, device=dev)
    p.router["w"][:, 0] += 2.0        # positive inputs crowd expert 0
    x = _r((4, 25, 32), dev, dtype).abs()
    static = x.clone()
    with torch.inference_mode():
        torch.cuda.set_sync_debug_mode("error")
        try:
            y, aux = moe.moe_forward(p, x, cfg)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        captured = graphs.capture(lambda: moe.moe_forward(p, static, cfg),
                                  dev)
        yg, auxg = captured.replay()
    assert torch.equal(yg, y) and torch.equal(auxg["drop_frac"],
                                              aux["drop_frac"])
    assert float(aux["drop_frac"]) > 0
    nodrop = dataclasses.replace(cfg, capacity_factor=8.0)
    y8, aux8 = moe.moe_forward(p, x, nodrop)
    ref, _ = moe.moe_dense_ref(p, x, nodrop)
    assert float(aux8["drop_frac"]) == 0.0
    assert rel_err(y8, ref) <= (1e-5 if dtype == torch.float32 else 1e-2)


@pytest.mark.parametrize("arch", ("qwen3-1.7b", "llama4-maverick-400b-a17b"))
def test_int8_decode_matches_its_plain_path(dev, arch):
    """bf16 weights with the int8 cache: the captured prefill and 20 decode
    steps equal the eager ones bit for bit and stay within 5e-2 of the
    plain path (int8 cache too) call by call; the cache is int8 with fp32
    scales, the prefilled scales positive."""
    from repro_torch.launch import serve
    from repro_torch.serve import serve_step as S
    from repro_torch.serve.sampler import greedy
    model = _attn_mlp_smoke(dev, arch, "bfloat16", kv_quant=True)
    cfg = model.cfg
    toks = torch.randint(0, cfg.vocab_size, (3, 40),
                         generator=torch.Generator().manual_seed(2)).to(dev)
    frontend = serve.frontend_stub(cfg, 3, dev)
    max_len = cfg.fusion_tokens + 40 + 20
    plain = KernelPolicy(impl="torch")
    pre = S.capture_prefill(model, 3, 40, max_len=max_len,
                            frontend_len=cfg.fusion_tokens)
    step = S.capture_decode_step(model, 3, max_len)
    with torch.inference_mode():
        logits, cache = pre(toks, frontend)
        ref_logits, ref_cache = S.prefill(model, toks, max_len=max_len,
                                          frontend=frontend)
        plain_logits, plain_cache = S.prefill(
            model, toks, max_len=max_len, frontend=frontend, policy=plain)
        assert torch.equal(logits, ref_logits)
        assert rel_err(logits, plain_logits) <= 5e-2
        layer = cache["layers"][0]
        assert layer["k"].dtype == torch.int8
        assert layer["k_scale"].dtype == torch.float32
        assert bool((layer["k_scale"][:, :cfg.fusion_tokens + 40] > 0).all())
        tok = greedy(plain_logits)[:, None]
        for _ in range(20):
            gl, _ = step(plain_cache, tok)
            el, _ = S.decode_step(model, plain_cache, tok)
            pl, plain_cache = S.decode_step(model, plain_cache, tok,
                                            policy=plain)
            assert torch.equal(gl, el)
            assert rel_err(gl, pl) <= 5e-2
            tok = greedy(pl)[:, None]


def test_attn_mlp_serve_launcher_on_the_card(dev, capsys):
    from repro_torch.launch import serve
    assert serve.main(["--arch", "internvl2-1b", "--smoke", "--batch", "2",
                       "--prompt-len", "40", "--gen", "4",
                       "--max-len", "60"]) == 0
    out = capsys.readouterr().out
    assert "on cuda" in out and "'pwconv': 14" in out


# ---------------------------------------------------------------------------
# the static verifier against the libraries' own launches, and the shims
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused", (None, False))
@pytest.mark.parametrize("arch", tuple(ARCHS))
def test_launch_dims_match_the_models(dev, arch, fused):
    """Every launch of the body's plans (batch 1 and 8, fp32 and bf16,
    112x112) and of every ladder candidate of their segments: the
    library's ``<kernel>_launch_dims``, the function its launch calls,
    gives the gridspec model's grid, block, cluster and shared memory."""
    from repro_torch.analysis import planlint
    from repro_torch.kernels import autotune, gridspec
    from repro_torch.kernels.policy import BF16_STREAM, NATIVE
    net = ARCHS[arch](1.0)
    seen = {}
    for batch in (1, 8):
        for dp in (NATIVE, BF16_STREAM):
            pol = KernelPolicy(fused=fused, dtype_policy=dp)
            nplan = network.plan_network(net, (batch, 112, 112, net.c_in),
                                         policy=pol, device=dev)
            sdt = dp.stream_dtype(torch.float32)
            for spec, cp, shape in zip(net.blocks, nplan.plans,
                                       nplan.block_shapes):
                for geom, seg in zip(planlint.walk_segments(spec, cp, shape),
                                     cp.segments):
                    for cand in autotune.segment_candidates(
                            geom, seg.plan, sdt, cp.smem_budget):
                        for m in gridspec.segment_models(geom, cand, sdt):
                            seen.setdefault((m.library, m.library_args), m)
    bad = [(m.name, m.library_args, m.dims(), gridspec.library_dims(m))
           for m in seen.values() if gridspec.library_dims(m) != m.dims()]
    assert seen and not bad, bad[:5]


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16,
                                   torch.float16))
def test_launch_dims_at_odd_shapes(dev, dtype):
    """Each kernel's model at odd shapes (a stream split of 3, a scalar
    depthwise channel group, a partial cluster, narrow tiles) against its
    library, and the launch itself runs and matches its plain version."""
    from repro_torch.kernels import gridspec
    models = [
        gridspec.pwconv_model(g=5, ci=300, co=72, variant="stream", bg=8,
                              bco=32, bci=100, dtype=dtype),
        gridspec.pwconv_model(g=77, ci=24, co=40, variant="simt", bg=64,
                              bco=64, bci=8, dtype=dtype),
        gridspec.dwconv2d_model(b=2, hi=9, wi=11, c=13, ho=9, wo=11, hf=3,
                                wf=3, stride=1, tile_h=3, tile_w=8, cg=13,
                                vec=1, dtype=dtype),
        *gridspec.dw_se_models(b=2, hi=14, wi=14, c=40, ho=7, wo=7, hf=5,
                               wf=5, stride=2, tile_h=2, tile_w=4, cg=16,
                               vec=8 if dtype != torch.float32 else 4,
                               c_se=10, dtype=dtype),
        gridspec.separable_fused_model(
            b=2, hi=13, wi=11, ci=12, c=72, co=40, ho=13, wo=11, hf=3, wf=3,
            stride=1, slab_h=5, cb=9, cs=blocking.separable_slice(72, 8),
            panel=24, cluster=8, expand=True, dtype=dtype),
        gridspec.fused_mbconv_model(
            b=2, hi=14, wi=14, ci=16, c=48, co=24, ho=7, wo=7, hf=3, wf=3,
            stride=2, slab_h=3, tile_w=4, cb=16, cs=16, panel=24, cluster=3,
            dtype=dtype),
    ]
    if dtype != torch.float32:
        models.append(gridspec.pwconv_model(g=300, ci=64, co=192,
                                            variant="tc", bg=128, bco=64,
                                            bci=64, dtype=dtype))
    for m in models:
        assert gridspec.library_dims(m) == m.dims(), m.name
    x = _r((5, 300), dev, dtype)
    w = _r((300, 72), dev, dtype, 300 ** -0.5)
    got = pwconv.pwconv(x, w, variant="stream", block_g=8, block_co=32,
                        block_ci=100)
    assert rel_err(got, pwconv.pwconv_plain(x, w)) <= TOL[dtype] * 10


def test_lc201_predicts_a_refused_launch(dev):
    """The verifier's LC201 on a ``simt`` grid of 65,536 CTAs in y, and the
    CUDA driver's refusal of the same launch."""
    from repro_torch.analysis import launch_check
    from repro_torch.kernels import _build, gridspec
    co = 65535 * 128 + 1
    p = blocking.plan_pwconv(1, 1, co, variant="simt")
    m = gridspec.pwconv_model(g=1, ci=1, co=co, variant="simt",
                              bg=p.block_g, bco=p.block_co, bci=p.block_c,
                              dtype=torch.float32)
    assert {d.rule for d in launch_check.lint_model(m)
            if d.severity == "error"} == {"LC201"}
    assert gridspec.library_dims(m) == m.dims()
    with pytest.raises(_build.KernelLaunchError):
        pwconv.pwconv(torch.ones((1, 1), device=dev),
                      torch.ones((1, co), device=dev), variant="simt")
    torch.cuda.synchronize(dev)


@pytest.mark.parametrize("arch", ("v2", "mnasnet"))
def test_verify_and_trace_audit_on_the_card(dev, arch):
    """``verify=True`` gives the default's bits; the trace audit on the
    card (JX301 from the launch counters) finds nothing."""
    from repro_torch import analysis
    net = ARCHS[arch](1.0)
    params = network.init_network(net, seed=0, device=dev)
    x = _r((2, 56, 56, net.c_in), dev, torch.float32)
    a = network.execute_network(net, params, x)
    b = network.execute_network(net, params, x,
                                policy=KernelPolicy(verify=True))
    network.clear_network_cache()
    assert torch.equal(a, b)
    nplan = network.plan_network(net, x.shape, device=dev)
    rep = analysis.analyze_network(net, nplan, device=dev)
    assert rep.ok and not [d for d in rep.diagnostics
                           if d.rule.startswith("JX")], rep.format()


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_block_shims_on_the_card(dev, dtype):
    from repro_torch.core import separable
    gen = torch.Generator().manual_seed(4)
    for init, call, c_in, c_out, stride in (
            (separable.init_separable, separable.separable_block, 32, 64, 2),
            (separable.init_inverted_residual, separable.inverted_residual,
             24, 24, 1)):
        p = {k: v.to(dtype) for k, v in
             init(gen, c_in, c_out, device=dev).items()}
        x = _r((2, 28, 28, c_in), dev, dtype)
        got = call(p, x, stride=stride)
        want = call(p, x, stride=stride, policy=KernelPolicy(impl="torch"))
        assert rel_err(got, want) <= TOL[dtype] * 10


# ---------------------------------------------------------------------------
# Whisper serving and training on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant,g,dtype", [
    ("stream", 8, torch.float32), ("stream", 8, torch.bfloat16),
    ("tc", 96, torch.bfloat16), ("simt", 96, torch.float32)])
@pytest.mark.parametrize("act,bias", [(None, False), ("silu", True),
                                      ("relu6", True)])
def test_pwconv_function_gradients_kernel_vs_plain(dev, variant, g, dtype,
                                                   act, bias):
    """The ``pwconv`` autograd Function on the card: its forward and the
    backward's recomputed pre-activation launch the kernel (of the
    variant the shape plans), and dx, dw, db equal the plain path's within
    the kernel tolerance, in the operands' dtypes."""
    from repro_torch.core.pwconv import pointwise
    from repro_torch.kernels.policy import KernelPolicy
    x0 = _r((g, 64), dev, dtype)
    w0 = _r((64, 48), dev, dtype, 64 ** -0.5)
    b0 = _r((48,), dev, dtype, 0.1) if bias else None
    gy = _r((g, 48), dev, dtype, seed=3)
    grads = {}
    for impl in ("auto", "torch"):
        x, w = (t.clone().requires_grad_(True) for t in (x0, w0))
        b = b0.clone().requires_grad_(True) if bias else None
        before = dict(pwconv.launches_by_variant)
        y = pointwise(x, w, b, activation=act,
                      policy=KernelPolicy(impl=impl))
        y.backward(gy)
        torch.cuda.synchronize(dev)
        ran = {k: pwconv.launches_by_variant[k] - before[k] for k in before}
        want = (1 + (act is not None)) if impl == "auto" else 0
        assert ran == {k: want if k == variant else 0 for k in ran}, ran
        grads[impl] = [t.grad for t in (x, w, b) if t is not None]
    for got, ref_ in zip(grads["auto"], grads["torch"], strict=True):
        assert got.dtype == dtype
        assert rel_err(got, ref_) <= TOL[dtype] * 10


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_whisper_captured_prefill_and_decode_match_eager(dev, dtype):
    """whisper-small's smoke model (24 frames; the encoder and the cross
    attention blockwise at ``attn_chunk`` 16, keys padded) captured against
    eager, call by call: the same bits (logits, self-attention cache, the
    encoder's K/V), launches as counted, the eager calls within 1e-4 /
    5e-2 of the plain path, and the captured decode step never writing the
    encoder's K/V."""
    import dataclasses
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import serve
    from repro_torch.models.transformer import init_params
    from repro_torch.serve import serve_step as S
    from repro_torch.serve.sampler import greedy
    cfg = dataclasses.replace(get_config("whisper-small", smoke=True),
                              dtype=dtype, attn_chunk=16)
    model = init_params(cfg, seed=0, device=dev)
    toks = torch.randint(0, cfg.vocab_size, (2, 20),
                         generator=torch.Generator().manual_seed(0)).to(dev)
    frames = serve.frontend_stub(cfg, 2, dev, seed=0)
    max_len, plain = 40, KernelPolicy(impl="torch")
    tol = 1e-4 if dtype == "float32" else 5e-2
    serve.reset_launch_counts()
    pre = S.capture_prefill(model, 2, 20, max_len=max_len,
                            frontend_len=serve.frontend_len(cfg))
    torch.cuda.synchronize(dev)
    want = serve.expected_launches(cfg, "prefill")
    assert serve.launch_counts() == _twice(want)
    serve.reset_launch_counts()
    step = S.capture_decode_step(model, 2, max_len)
    want_step = serve.expected_launches(cfg, "decode")
    assert serve.launch_counts() == _twice(want_step)
    with torch.inference_mode():
        logits, cache = pre(toks, frames)
        ref_logits, ref_cache = S.prefill(model, toks, max_len=max_len,
                                          frontend=frames)
        plain_logits, _ = S.prefill(model, toks, max_len=max_len,
                                    frontend=frames, policy=plain)
    assert torch.equal(logits, ref_logits)
    assert rel_err(ref_logits, plain_logits) <= tol
    for k in ("enc_k", "enc_v"):
        assert torch.equal(cache[k], ref_cache[k])
    own, tok = cache, greedy(logits)[:, None]
    with torch.inference_mode():
        for i in range(12):
            logits, own = step(own, tok)
            if i == 0:
                enc = [own[k].clone() for k in ("enc_k", "enc_v")]
            ref_logits, ref_cache = S.decode_step(model, ref_cache, tok)
            plain_logits, _ = S.decode_step(model, ref_cache, tok,
                                            policy=plain)
            assert torch.equal(logits, ref_logits)
            tok = greedy(logits)[:, None]
    assert all(torch.equal(own[k], e) for k, e in zip(("enc_k", "enc_v"),
                                                      enc))
    for a, b in zip(own["layers"], ref_cache["layers"], strict=True):
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert _replay_kernels(lambda: step(step.cache, tok),
                           want_step) == want_step


def test_smollm_train_step_kernel_vs_plain(dev):
    """One smollm train step at its smoke config, fp32, deterministic: the
    kernel path's loss, gradients and updated parameters against the plain
    path's, and the step's ``pwconv`` launches as counted."""
    import dataclasses
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig, DataIterator
    from repro_torch.launch.serve import reset_launch_counts
    from repro_torch.launch.train import (expected_train_launches,
                                          train_launch_counts)
    from repro_torch.models.transformer import init_params
    from repro_torch.train import train_step as TS
    cfg = dataclasses.replace(get_config("smollm-360m", smoke=True),
                              attn_chunk=16)
    batch = next(DataIterator(DataConfig(cfg.vocab_size, 40, 4, seed=0),
                              prefetch=0))
    out = {}
    for impl in ("auto", "torch"):
        model = init_params(cfg, seed=0, device=dev)
        tcfg = TS.TrainConfig()
        step = TS.make_train_step(model, tcfg, KernelPolicy(impl=impl))
        state = TS.init_train_state(model, tcfg)
        _, _, grads = TS.accumulate_grads(model, state["params"], batch, 1,
                                          KernelPolicy(impl=impl))
        reset_launch_counts()
        new, m = step(state, batch)
        torch.cuda.synchronize(dev)
        assert train_launch_counts() == (
            expected_train_launches(cfg) if impl == "auto" else
            dict.fromkeys(expected_train_launches(cfg), 0))
        out[impl] = (float(m["loss"]), grads, new["params"])
    (lk, gk, pk), (lp, gp, pp) = out["auto"], out["torch"]
    assert abs(lk - lp) <= 1e-5 * abs(lp)
    for k in gp:
        assert rel_err(gk[k], gp[k]) <= 1e-4, k
        assert rel_err(pk[k], pp[k]) <= 1e-4, k


def test_train_launcher_on_the_card(dev, tmp_path):
    """``launch.train`` on the card by default, in a process of its own
    (it turns deterministic algorithms on for its process)."""
    import os
    import pathlib
    import subprocess
    import sys
    src = pathlib.Path(__file__).resolve().parents[1] / "src"
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "whisper-small", "--smoke", "--steps", "3", "--seq-len", "16",
         "--global-batch", "2", "--ckpt-dir", str(tmp_path)],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": str(src)})
    assert out.returncode == 0, out.stderr
    assert "[train] done: 3 steps" in out.stdout
    assert "on cuda" in out.stdout


# ---------------------------------------------------------------------------
# xLSTM and hymba training on the card: dwconv1d's backward kernel
# ---------------------------------------------------------------------------

#: The backward kernel against its plain version: dx and df relative to
#: each one's largest magnitude (df sums B*L products in another order).
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2, torch.float16: 1e-2}


@pytest.mark.parametrize("dtype", list(BWD_TOL))
@pytest.mark.parametrize("b,l,d,k", [
    (2, 37, 72, 4), (1, 2, 33, 5), (2, 19, 40, 1), (2, 50, 70, 7),
    (3, 64, 264, 3), (2, 45, 130, 2), (8, 256, 1536, 4), (4, 640, 3200, 4),
    (2, 640, 1600, 4), (2, 640, 800, 4)])
def test_dwconv1d_bwd_kernels_match_plain(dev, b, l, d, k, dtype):
    """dx and df of the backward's one launch against
    ``dwconv1d_causal_bwd_plain``: exact-K and runtime-K taps (K = 1, 7),
    L < K - 1, odd and misaligned widths (a vector of 1), several CTAs
    along the rows and the channels, xLSTM's and hymba's training shapes
    and hymba's channel blocks at tp 2 and 4 (clusters of 8 and 16); one
    launch a call (no second pass), df in f's dtype, and the launch the
    library configures equal to ``bwd_dims``."""
    from repro_torch.kernels import dwconv1d
    x, dy = _r((b, l, d), dev, dtype), _r((b, l, d), dev, dtype, seed=1)
    f = _r((k, d), dev, dtype, k ** -0.5)
    before = dwconv1d.bwd_launches
    dx, df = dwconv1d.dwconv1d_causal_bwd(x, f, dy)
    torch.cuda.synchronize(dev)
    assert dwconv1d.bwd_launches == before + 1
    assert not hasattr(dwconv1d, "reduce_launches")
    assert dwconv1d.bwd_launch_dims(b, l, d, k, dtype) == dwconv1d.bwd_dims(
        b, l, d, k, dtype)
    want = dwconv1d.dwconv1d_causal_bwd_plain(x, f, dy)
    for got, ref_ in zip((dx, df), want, strict=True):
        assert got.dtype == dtype and got.shape == ref_.shape
        assert bool(torch.isfinite(got.float()).all())
        assert rel_err(got, ref_) <= BWD_TOL[dtype], rel_err(got, ref_)


@pytest.mark.parametrize("shape", ((8, 256, 1536), (2, 640, 800)))
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_dwconv1d_bwd_is_bit_identical_and_replays(dev, dtype, shape):
    """df (and dx) have the same bits at every call, and a CUDA graph of
    the Function's whole backward (``torch.autograd.grad`` through
    ``DwConv1dFn``) replays the eager call's bits: at the mLSTM's shape
    and at hymba's tp-4 channel block (clusters of 16 CTAs)."""
    from repro_torch.kernels import dwconv1d
    x0 = _r(shape, dev, dtype)
    f0 = _r((4, shape[-1]), dev, dtype, 0.5)
    dy = _r(shape, dev, dtype, seed=2)
    first = dwconv1d.dwconv1d_causal_bwd(x0, f0, dy)
    second = dwconv1d.dwconv1d_causal_bwd(x0, f0, dy)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    x, f = x0.clone().requires_grad_(True), f0.clone().requires_grad_(True)

    def backward():
        y = dwconv1d.DwConv1dFn.apply(x, f, "auto")
        return torch.autograd.grad(y, (x, f), dy)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        backward()
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = backward()
    for t in replayed:
        t.zero_()
    graph.replay()
    torch.cuda.synchronize(dev)
    assert all(torch.equal(a, b) for a, b in zip(first, replayed))


@pytest.mark.parametrize("arch", ("xlstm-125m", "hymba-1.5b"))
def test_recurrent_gradients_kernel_vs_plain(dev, arch):
    """The xLSTM and hymba smoke configs (32 tokens: xLSTM's sLSTM loop
    chunk-checkpointed; hymba's flash backward with window and sink at
    ``attn_chunk`` 16), fp32: the kernel path's loss and every gradient
    against the plain path's, and the launches of one loss and backward
    as ``expected_train_launches`` counts them."""
    import dataclasses
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig, DataIterator
    from repro_torch.launch.serve import reset_launch_counts
    from repro_torch.launch.train import (expected_train_launches,
                                          train_launch_counts)
    from repro_torch.models.layers import trainable_
    from repro_torch.models.transformer import init_params
    from repro_torch.train import train_step as TS
    cfg = dataclasses.replace(get_config(arch, smoke=True), attn_chunk=16)
    batch = next(DataIterator(DataConfig(cfg.vocab_size, 32, 2, seed=0),
                              prefetch=0))
    model = trainable_(init_params(cfg, seed=0, device=dev))
    params = {n: p.detach() for n, p in model.named_parameters()}
    out = {}
    for impl in ("auto", "torch"):
        reset_launch_counts()
        loss, _, grads = TS.accumulate_grads(model, params, batch, 1,
                                             KernelPolicy(impl=impl))
        torch.cuda.synchronize(dev)
        want = expected_train_launches(cfg)
        assert train_launch_counts() == (
            want if impl == "auto" else dict.fromkeys(want, 0))
        out[impl] = (float(loss), grads)
    (lk, gk), (lp, gp) = out["auto"], out["torch"]
    assert abs(lk - lp) <= 1e-5 * abs(lp)
    top = max(float(g.abs().max()) for g in gp.values())
    for k in gp:
        scale = max(float(gp[k].abs().max()), 1e-6 * top)
        assert float((gk[k] - gp[k]).abs().max()) <= 1e-4 * scale, k


@pytest.mark.parametrize("arch", ("xlstm-125m", "hymba-1.5b"))
def test_recurrent_train_launcher_on_the_card(dev, arch, tmp_path):
    """``launch.train`` trains xLSTM and hymba on the card, in a process of
    its own with deterministic algorithms on (no op of the recurrent path
    refuses them), the launches a step as expected."""
    import os
    import pathlib
    import subprocess
    import sys
    src = pathlib.Path(__file__).resolve().parents[1] / "src"
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
         "--smoke", "--steps", "3", "--seq-len", "32", "--global-batch", "2",
         "--ckpt-dir", str(tmp_path)],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": str(src)})
    assert out.returncode == 0, out.stderr
    assert "[train] done: 3 steps" in out.stdout and "on cuda" in out.stdout
    line = next(s for s in out.stdout.splitlines() if "launches a step" in s)
    got, want = line.split("launches a step ")[1].split(" (expected ")
    assert got == want.rstrip(")"), line


# ---------------------------------------------------------------------------
# The captured train step: one CUDA graph of loss, backward, compression
# and AdamW
# ---------------------------------------------------------------------------

#: Graph against eager in a process of its own: deterministic algorithms
#: and cuBLAS's workspace are set before cuBLAS starts
#: (``launch.train.deterministic_card``).
_GRAPH_VS_EAGER = """
import sys, torch
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import DataConfig, DataIterator
from repro_torch.launch.serve import frontend_stub
from repro_torch.launch.train import (deterministic_card,
                                      expected_train_launches)
from repro_torch.models.transformer import init_params
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.compress import CompressionConfig
from repro_torch.train import train_step as TS
arch, mb, kind = sys.argv[1], int(sys.argv[2]), sys.argv[3]
deterministic_card()
dev = torch.device("cuda", 0)
cfg = get_config(arch, smoke=True)
model = init_params(cfg, seed=0, device=dev)
tcfg = TS.TrainConfig(optimizer=AdamWConfig(lr=1e-2, warmup_steps=2,
                                            total_steps=100),
                      microbatches=mb,
                      compression=CompressionConfig(kind=kind,
                                                    topk_frac=0.1))
state = TS.init_train_state(model, tcfg)
eager = TS.make_train_step(model, tcfg, seed=3)
step = TS.capture_train_step(model, tcfg, 4, 32, seed=3)
want = {k: n * mb for k, n in expected_train_launches(cfg).items()}
got = {k: step.captured.launches.get(k, 0) for k in want}
assert got == want, (got, want)
it = DataIterator(DataConfig(cfg.vocab_size, 32, 4, seed=1), prefetch=0)
frames = frontend_stub(cfg, 4, dev, seed=0)
cstate = state

def leaves(t, p=""):
    for k, v in t.items():
        yield from (leaves(v, p + k + "/") if isinstance(v, dict)
                    else [(p + k, v)])
for i in range(3):
    b = next(it)
    if cfg.encdec is not None:
        b["frontend"] = frames
    state, em = eager(state, b)
    cstate, cm = step(cstate, b)
    torch.cuda.synchronize(dev)
    assert cstate is step.state
    got, ref = dict(leaves(cstate)), dict(leaves(state))
    bad = [k for k in ref if not torch.equal(got[k], ref[k])]
    bad += [k for k in em if not torch.equal(cm[k], em[k])]
    assert not bad, (i, bad[:5])
print("graph == eager", arch, mb, kind)
"""


@pytest.mark.parametrize("arch,mb,kind", [
    ("smollm-360m", 1, "none"), ("qwen3-moe-235b-a22b", 1, "none"),
    ("whisper-small", 1, "none"), ("xlstm-125m", 1, "none"),
    ("hymba-1.5b", 1, "none"), ("smollm-360m", 2, "topk"),
    ("smollm-360m", 1, "int8")])
def test_captured_train_step_equals_eager(dev, arch, mb, kind):
    """``capture_train_step`` of each trainable family's smoke config (4 x
    32 tokens; microbatches and compression on smollm) against
    ``make_train_step``'s step from the same state on the same batches,
    deterministic: after each of 3 steps the parameters, moments, step,
    error and metrics bit for bit, int8's noise included; the graph's
    recorded launches are ``expected_train_launches``."""
    import os
    import pathlib
    import subprocess
    import sys
    src = pathlib.Path(__file__).resolve().parents[1] / "src"
    out = subprocess.run(
        [sys.executable, "-c", _GRAPH_VS_EAGER, arch, str(mb), kind],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": str(src)})
    assert out.returncode == 0, out.stderr[-4000:]
    assert "graph == eager" in out.stdout


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_dwconv1d_function_backward_replays_from_a_capture(dev, dtype):
    """``DwConv1dFn``'s forward and backward (``torch.autograd.grad``)
    captured by ``graphs.capture``, as the train step captures them: one
    launch of each of the two kernels recorded, and a replay gives the
    eager call's dx and df bit for bit."""
    from repro_torch import graphs
    from repro_torch.kernels import dwconv1d
    x = _r((2, 640, 3200), dev, dtype).requires_grad_(True)
    f = _r((4, 3200), dev, dtype, 0.5).requires_grad_(True)
    dy = _r((2, 640, 3200), dev, dtype, seed=3)

    def backward():
        y = dwconv1d.DwConv1dFn.apply(x, f, "auto")
        return torch.autograd.grad(y, (x, f), dy)
    want = backward()
    cap = graphs.capture(backward, dev)
    assert cap.launches == {"dwconv1d": 1, "dwconv1d_bwd": 1}
    for t in cap.output:
        t.zero_()
    cap.replay()
    torch.cuda.synchronize(dev)
    assert all(torch.equal(a, b) for a, b in zip(cap.output, want))


def test_failing_train_step_capture_raises(dev, monkeypatch):
    """A train step that fails inside its capture raises the step's own
    error through ``graphs.record`` (no eager step runs in its place), and
    the stream captures again afterwards."""
    from repro_torch import graphs
    from repro_torch.configs.registry import get_config
    from repro_torch.models.transformer import init_params
    from repro_torch.train import train_step as TS
    real = TS.adamw.apply_updates_

    def fails_in_capture(*a, **k):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("step failed inside the capture")
        return real(*a, **k)
    monkeypatch.setattr(TS.adamw, "apply_updates_", fails_in_capture)
    model = init_params(get_config("smollm-360m", smoke=True), seed=0,
                        device=dev)
    with pytest.raises(RuntimeError, match="inside the capture"):
        TS.capture_train_step(model, TS.TrainConfig(), 2, 16)
    buf = torch.zeros(4, device=dev)
    cap = graphs.capture(lambda: buf.add_(1), dev)
    cap.replay()
    torch.cuda.synchronize(dev)
    assert float(buf[0]) == 3.0


# ---------------------------------------------------------------------------
# Sharded serving on the one card: world 1 under NCCL, gloo ranks sharing it
# ---------------------------------------------------------------------------


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_world1_nccl_graphs_equal_the_unsharded_graphs(dev, monkeypatch):
    """qwen3-1.7b smoke, bf16: the captured prefill and three decode steps
    under the rules of a world of one rank under NCCL (every block the
    whole tensor, every one-rank collective the identity) bit for bit the
    unsharded graphs', and no collective recorded."""
    import dataclasses

    import torch.distributed as dist
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.dryrun import make_rules
    from repro_torch.launch.mesh import init_world, make_host_mesh
    from repro_torch.launch.serve import collective_counts
    from repro_torch.models.transformer import init_params
    from repro_torch.serve import serve_step as S
    from repro_torch.serve.sampler import greedy
    from repro_torch.sharding.rules import use_rules
    for k, v in dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
                     RANK="0", WORLD_SIZE="1", LOCAL_RANK="0").items():
        monkeypatch.setenv(k, v)
    cfg = get_config("qwen3-1.7b", smoke=True)
    model = init_params(dataclasses.replace(cfg, dtype="bfloat16"),
                        device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (2, 12),
                            generator=torch.Generator().manual_seed(1)).to(dev)

    def run():
        pre = S.capture_prefill(model, 2, 12, max_len=16)
        step = S.capture_decode_step(model, 2, 16)
        logits, cache = pre(prompts)
        outs = [logits]
        for _ in range(3):
            logits, cache = step(cache, greedy(logits)[:, None])
            outs.append(logits)
        recorded = collective_counts(step.captured.launches)
        return outs, recorded

    with torch.inference_mode():
        want, _ = run()
        init_world("nccl", "cuda")
        try:
            with use_rules(make_rules(make_host_mesh(1), mode="serve",
                                      multi_pod=False)):
                got, recorded = run()
        finally:
            dist.destroy_process_group()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert not any(recorded.values())


def test_two_gloo_ranks_on_the_card_serve_as_one_rank(dev):
    """``launch.serve --model-parallel 2 --backend gloo`` as two ranks on
    the one card (eager, collectives via host copies): rank 0's tokens are
    one rank's."""
    import os
    import pathlib
    import subprocess
    import sys
    root = pathlib.Path(__file__).resolve().parents[1]
    env = {**os.environ, "PYTHONPATH": str(root / "src")}
    args = ["-m", "repro_torch.launch.serve", "--arch", "qwen3-1.7b",
            "--smoke", "--batch", "2", "--prompt-len", "12", "--gen", "4",
            "--max-len", "32"]
    two = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", *args, "--model-parallel", "2",
         "--backend", "gloo"],
        capture_output=True, text=True, timeout=300, env=env, cwd=root)
    one = subprocess.run([sys.executable, *args], capture_output=True,
                         text=True, timeout=300, env=env, cwd=root)
    assert two.returncode == 0 and one.returncode == 0, two.stderr[-3000:]
    assert "collectives gloo via host copies" in two.stdout

    def tokens(out):
        return next(l for l in out.splitlines() if "sample tokens" in l)
    assert tokens(two.stdout) == tokens(one.stdout)



# ---------------------------------------------------------------------------
# Sharded serving across cards: NCCL collectives captured in CUDA graphs
# ---------------------------------------------------------------------------

_ONE_RANK_SERVE: dict = {}


def _serve_run(arch: str, launch=(), extra=(), timeout_s: float = 600):
    """``launch.serve`` of ``arch`` (smoke, fp32) under the ``launch``
    prefix, with ``extra`` arguments: (return code, stdout, stderr)."""
    import os
    import pathlib
    import subprocess
    import sys
    root = pathlib.Path(__file__).resolve().parents[1]
    env = {**os.environ, "PYTHONPATH": str(root / "src")}
    run = subprocess.run(
        [sys.executable, *launch, "-m", "repro_torch.launch.serve", "--arch",
         arch, "--smoke", "--batch", "4", "--prompt-len", "12", "--gen", "4",
         "--max-len", "32", *extra],
        capture_output=True, text=True, timeout=timeout_s, env=env, cwd=root)
    return run.returncode, run.stdout, run.stderr


@pytest.mark.parametrize("arch,ranks,model", [
    ("qwen3-1.7b", 2, 2), ("qwen3-1.7b", 4, 4), ("qwen3-1.7b", 4, 2),
    ("qwen3-moe-235b-a22b", 2, 2), ("qwen3-moe-235b-a22b", 4, 4),
    ("hymba-1.5b", 2, 2), ("hymba-1.5b", 4, 4), ("xlstm-125m", 2, 2)])
def test_nccl_ranks_across_cards_serve_as_one_rank(dev, arch, ranks, model):
    """``launch.serve --model-parallel model`` as ``ranks`` NCCL ranks, one
    a card (the batch split over the rest): the prefill and the decode step
    captured as CUDA graphs with their collectives inside (the MoE's
    ``all_to_all_single`` among them; hymba's Mamba branch and the xLSTM
    over their channels and heads, ``dwconv1d`` on each rank's block), and
    rank 0's tokens one rank's.  Skips on a host with fewer cards than
    ranks."""
    import ast
    import re

    from repro_torch.kernels import _build
    if torch.cuda.device_count() < ranks:
        pytest.skip(f"needs {ranks} CUDA devices, one a NCCL rank")
    _build.build(["pwconv", "dwconv1d"])  # once, before the ranks start
    if arch not in _ONE_RANK_SERVE:
        _ONE_RANK_SERVE[arch] = _serve_run(arch)
    rc, one, err = _ONE_RANK_SERVE[arch]
    assert rc == 0, err[-3000:]
    rc, out, err = _serve_run(
        arch, ["-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", str(ranks)],
        ["--model-parallel", str(model)])
    assert rc == 0, err[-3000:]
    assert (f"mesh {{'data': {ranks // model}, 'model': {model}}} over "
            f"{ranks} rank(s), backend nccl, collectives nccl") in out, out
    assert "captured prefill and decode step as CUDA graphs" in out

    def tokens(text):
        return next(l for l in text.splitlines() if "sample tokens" in l)
    assert tokens(out) == tokens(one)
    line = next(l for l in out.splitlines() if "[serve] collectives" in l)
    prefill, step = (ast.literal_eval(d) for d in re.findall(r"\{[^}]*\}",
                                                             line))
    assert step["all_reduce"] > 0 and prefill["all_reduce"] > 0
    if "moe" in arch:
        assert step["all_to_all"] > 0 and prefill["all_to_all"] > 0


# ---------------------------------------------------------------------------
# Sharded training across cards: the captured step with NCCL inside
# ---------------------------------------------------------------------------

_ONE_CARD_TRAIN: dict = {}


def _train_run(arch: str, launch=(), extra=(), timeout_s: float = 900):
    """``launch.train`` of ``arch`` (smoke, 3 steps, 8 x 32, its own
    checkpoint directory) under the ``launch`` prefix with ``extra``
    arguments: (return code, stdout, stderr)."""
    import os
    import pathlib
    import subprocess
    import sys
    import tempfile
    root = pathlib.Path(__file__).resolve().parents[1]
    env = {**os.environ, "PYTHONPATH": str(root / "src")}
    with tempfile.TemporaryDirectory(dir=root / "build") as ckpt:
        run = subprocess.run(
            [sys.executable, *launch, "-m", "repro_torch.launch.train",
             "--arch", arch, "--smoke", "--steps", "3", "--seq-len", "32",
             "--global-batch", "8", "--ckpt-dir", ckpt, *extra],
            capture_output=True, text=True, timeout=timeout_s, env=env,
            cwd=root)
    return run.returncode, run.stdout, run.stderr


def _train_losses(stdout: str) -> list:
    line = next(l for l in stdout.splitlines()
                if l.startswith("[train] losses "))
    return [float(x) for x in line[len("[train] losses "):].strip(
        "[]").split(",")]


@pytest.mark.parametrize("arch,ranks,model", [
    ("qwen3-1.7b", 4, 1), ("qwen3-1.7b", 4, 2), ("qwen3-1.7b", 4, 4),
    ("smollm-360m", 4, 2), ("qwen3-1.7b", 2, 2),
    ("qwen3-moe-235b-a22b", 4, 2),
    ("hymba-1.5b", 2, 2), ("hymba-1.5b", 4, 2),
    ("xlstm-125m", 2, 2), ("xlstm-125m", 4, 2)])
def test_nccl_train_across_cards(dev, arch, ranks, model):
    """``launch.train --model-parallel model`` as ``ranks`` NCCL ranks, one
    a card: FSDP and ZeRO-1 over the rest, the whole sharded step captured
    as one CUDA graph with its collectives (FSDP's reduce-scatters among
    them); hymba's Mamba branch and the xLSTM's blocks with ``dwconv1d``
    and its backward on the rank's channel block.  The dense and
    recurrent models' losses match the one-card captured step's within
    2e-5; the MoE's (each shard routes its own tokens with its own
    capacity) those of the same mesh as gloo ranks on the CPU within
    1e-4.  Skips on a host with fewer cards than ranks."""
    import ast
    import re

    import numpy as np

    from repro_torch.kernels import _build
    if torch.cuda.device_count() < ranks:
        pytest.skip(f"needs {ranks} CUDA devices, one a NCCL rank")
    _build.build(["pwconv", "dwconv1d"])  # once, before the ranks start
    torchrun = ["-m", "torch.distributed.run", "--standalone",
                "--nproc-per-node", str(ranks)]
    moe = "moe" in arch
    key = (arch, ranks, model) if moe else arch
    if key not in _ONE_CARD_TRAIN:
        _ONE_CARD_TRAIN[key] = (
            _train_run(arch, torchrun, ["--model-parallel", str(model),
                                        "--device", "cpu", "--backend",
                                        "gloo"]) if moe else _train_run(arch))
    rc, one, err = _ONE_CARD_TRAIN[key]
    assert rc == 0, err[-3000:]
    rc, out, err = _train_run(arch, torchrun,
                              ["--model-parallel", str(model)])
    assert rc == 0, err[-3000:]
    assert (f"mesh {{'data': {ranks // model}, 'model': {model}}} over "
            f"{ranks} rank(s), backend nccl, collectives nccl") in out, out
    assert "the step captured as one CUDA graph" in out
    np.testing.assert_allclose(_train_losses(out), _train_losses(one),
                               rtol=1e-4 if moe else 2e-5)
    line = next(l for l in out.splitlines()
                if l.startswith("[train] collectives a step"))
    counts = ast.literal_eval(re.search(r"\{[^}]*\}", line).group(0))
    assert counts["all_reduce"] > 0
    if ranks // model > 1:
        assert counts["reduce_scatter"] > 0
    if moe:
        assert counts["all_to_all"] > 0
