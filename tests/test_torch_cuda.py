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

TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2, torch.float16: 2e-3}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _r(shape, dev, dtype, scale=1.0, seed=0):
    g = torch.Generator().manual_seed(seed + sum(shape))
    return (torch.randn(shape, generator=g) * scale).to(dev, dtype)


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("b,h,w,c,stride,hf,vec", [
    (2, 9, 11, 12, 1, 3, 4), (1, 8, 8, 20, 2, 3, 4), (2, 7, 9, 6, 2, 5, 1),
    (1, 10, 10, 5, 1, 3, 1), (1, 12, 12, 8, 1, 7, 4),
    (2, 56, 56, 72, 2, 5, 4), (1, 14, 14, 480, 1, 5, 4)])
def test_dwconv2d_kernel(dev, b, h, w, c, stride, hf, vec, dtype):
    x = ref.pad_same(_r((b, h, w, c), dev, dtype), hf, hf, stride)
    f = _r((hf, hf, c), dev, dtype, 1 / hf)
    got = dwconv2d.dwconv2d(x, f, stride=stride, block_c=vec)
    want = dwconv2d.dwconv2d_plain(x, f, stride=stride)
    assert rel_err(got, want) <= TOL[dtype]


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
    "b,h,w,ci,c,co,stride,expand,residual,dw_act,act,tile", [
        (2, 9, 9, 12, 12, 20, 1, False, False, "relu6", "relu6", None),
        (1, 11, 7, 10, 10, 70, 2, False, False, "relu", "gelu", (3, 2, 4)),
        (2, 8, 8, 16, 16, 16, 1, False, True, "silu", None, (1, 1, 1)),
        (2, 8, 8, 8, 48, 8, 1, True, True, "relu6", None, None),
        (1, 9, 9, 6, 36, 10, 2, True, False, "gelu", "relu", (2, 5, 7)),
        (2, 7, 7, 5, 30, 5, 1, True, True, "silu", "silu", (7, 7, 30)),
    ])
def test_separable_fused_kernel(dev, b, h, w, ci, c, co, stride, expand,
                                residual, dw_act, act, tile, dtype):
    x_raw = _r((b, h, w, ci), dev, dtype)
    x = ref.pad_same(x_raw, 3, 3, stride)
    ew = _r((ci, c), dev, dtype, ci ** -0.5) if expand else None
    f, dwb = _r((3, 3, c), dev, dtype, 1 / 3), _r((c,), dev, dtype, 0.5)
    pw, pwb = _r((c, co), dev, dtype, c ** -0.5), _r((co,), dev, dtype, 0.5)
    res = x_raw if residual else None
    kw = dict(expand_w=ew, stride=stride, dw_activation=dw_act,
              activation=act)
    blocks = {}
    if tile is not None:
        blocks = dict(slab_h=tile[0], tile_w=tile[1], block_c=tile[2],
                      block_co=min(co, 64))
    got = sf.separable_fused(x, f, pw, dwb, pwb, res, **kw, **blocks)
    want = sf.separable_fused_plain(x, f, pw, dwb, pwb, res, **kw)
    assert rel_err(got, want) <= TOL[dtype]


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
    got = sf.separable_fused(x, f, pw, dwb, pwb, res, **kw)
    want = sf.separable_fused_plain(x, f, pw, dwb, pwb, res, **kw)
    assert rel_err(got, want) <= TOL[dtype]


# (b, h, w, ci, c, co, stride, k, residual, tile): Lite0's four fused-MBConv
# blocks at batch 2, then ragged C and Co, several Co panels, 5x5 taps and
# forced small tiles.
FUSED_MB_CASES = [
    (2, 112, 112, 16, 96, 24, 2, 3, False, None),
    (2, 56, 56, 24, 144, 24, 1, 3, True, None),
    (2, 56, 56, 24, 144, 40, 2, 3, False, None),
    (2, 28, 28, 40, 240, 40, 1, 3, True, None),
    (1, 9, 11, 5, 37, 70, 1, 3, False, None),
    (2, 8, 8, 6, 30, 6, 1, 5, True, (3, 2, 7)),
    (1, 10, 10, 3, 130, 129, 2, 5, False, (1, 1, 1)),
]


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("b,h,w,ci,c,co,stride,k,residual,tile",
                         FUSED_MB_CASES)
def test_fused_mbconv_kernel(dev, b, h, w, ci, c, co, stride, k, residual,
                             tile, dtype):
    x_raw = _r((b, h, w, ci), dev, dtype)
    x = ref.pad_same(x_raw, k, k, stride)
    f = _r((k, k, ci, c), dev, dtype, (k * k * ci) ** -0.5)
    fb = _r((c,), dev, dtype, 0.5)
    pw, pwb = _r((c, co), dev, dtype, c ** -0.5), _r((co,), dev, dtype, 0.5)
    res = x_raw if residual else None
    kw = dict(stride=stride, mb_activation="relu6",
              activation=None if residual else "silu")
    blocks = {}
    if tile is not None:
        blocks = dict(slab_h=tile[0], tile_w=tile[1], block_c=tile[2],
                      block_co=min(co, 64))
    got = fmb.fused_mbconv(x, f, pw, fb, pwb, res, **kw, **blocks)
    want = fmb.fused_mbconv_plain(x, f, pw, fb, pwb, res, **kw)
    assert rel_err(got, want) <= TOL[dtype]


def test_fused_mbconv_smem_model_matches_kernel(dev):
    for ci, k, stride, sh, tw, cb, cob in [(16, 3, 2, 8, 8, 64, 24),
                                           (40, 3, 1, 8, 8, 64, 40),
                                           (5, 5, 1, 3, 2, 7, 6),
                                           (3, 5, 2, 1, 1, 1, 64)]:
        assert fmb.smem_bytes(ci, k, k, stride, sh, tw, cb, cob) == \
            blocking.fused_mb_smem_bytes(sh, tw, cb, cob, ci=ci, hf=k, wf=k,
                                         stride=stride)


# (b, h, w, c, c_se, stride, k): MnasNet's SE blocks 3, 4, 10, 11, 12, 13
# at batch 2, then ragged C and C_se, and filters other than 3x3 and 5x5
DW_SE_CASES = [
    (2, 56, 56, 72, 6, 2, 5), (2, 28, 28, 120, 10, 1, 5),
    (2, 14, 14, 480, 20, 1, 3), (2, 14, 14, 672, 28, 1, 3),
    (2, 14, 14, 672, 28, 2, 5), (2, 7, 7, 960, 40, 1, 5),
    (3, 9, 11, 37, 5, 2, 3), (1, 5, 6, 13, 1, 1, 5), (2, 12, 10, 20, 4, 2, 7),
    (1, 9, 9, 8, 2, 1, 1),
]


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("b,h,w,c,c_se,stride,k", DW_SE_CASES)
def test_dw_se_kernel(dev, b, h, w, c, c_se, stride, k, dtype):
    x = ref.pad_same(_r((b, h, w, c), dev, dtype), k, k, stride)
    f, db = _r((k, k, c), dev, dtype, 1 / k), _r((c,), dev, dtype, 0.5)
    gate = (_r((c, c_se), dev, dtype, c ** -0.5), _r((c_se,), dev, dtype),
            _r((c_se, c), dev, dtype, c_se ** -0.5), _r((c,), dev, dtype))
    got = se_epilogue.dw_se(x, f, *gate, db, stride=stride)
    want = se_epilogue.dw_se_plain(x, f, *gate, db, stride=stride)
    assert rel_err(got, want) <= TOL[dtype]


@pytest.mark.parametrize("cluster", blocking.DW_SE_CLUSTERS)
@pytest.mark.parametrize("c", (72, 61, 5))
def test_dw_se_kernel_at_each_cluster_size(dev, cluster, c):
    """Each cluster size, forced through the budget the planner sizes it
    by; with C=5 some CTAs of a cluster of 8 own no channel."""
    ho = wo = 28
    need = blocking.dw_se_smem_bytes(ho, wo, c, 6, cluster)
    plan = blocking.plan_dw_se(30, 30, ho, wo, c, 6, smem_budget=need)
    assert plan.cluster == cluster
    x = ref.pad_same(_r((2, ho, wo, c), dev, torch.float32), 3, 3, 1)
    f = _r((3, 3, c), dev, torch.float32, 1 / 3)
    gate = (_r((c, 6), dev, torch.float32, c ** -0.5),
            _r((6,), dev, torch.float32), _r((6, c), dev, torch.float32),
            _r((c,), dev, torch.float32))
    got = se_epilogue.dw_se(x, f, *gate, cluster=cluster)
    want = se_epilogue.dw_se_plain(x, f, *gate)
    assert rel_err(got, want) <= TOL[torch.float32]
    assert se_epilogue.smem_bytes(ho, wo, c, 6, cluster) == need


@pytest.mark.parametrize("budget", [64, 600, 232_448])
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
    reset_launch_counts()
    y = network.execute_network(spec, params, x, policy=pol)
    torch.cuda.synchronize(dev)
    assert launch_counts() == expected_launches(plan.segment_histogram())
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


@pytest.mark.parametrize("fused", (None, False))
@pytest.mark.parametrize("arch", ("mnasnet", "lite0"))
def test_network_launch_counts_at_full_width(dev, arch, fused):
    spec = ARCHS[arch]()
    params = network.init_network(spec, seed=1, device=dev)
    x = _r((1, 112, 112, spec.c_in), dev, torch.float32)
    pol = KernelPolicy(fused=fused)
    reset_launch_counts()
    y = network.execute_network(spec, params, x, policy=pol)
    torch.cuda.synchronize(dev)
    want = dict.fromkeys(launch_counts(), 0)
    want.update(NETWORK_LAUNCHES[(arch, fused)])
    assert launch_counts() == want
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
