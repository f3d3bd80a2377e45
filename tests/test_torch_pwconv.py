"""The port's ``pwconv`` on the CPU: the planner's choice of variant and tile
at every Linear of xlstm-125m and every ``pw`` segment of the four CNN
bodies, the tile tables and the shared-memory budget, the lowering's
hand-off of the variant, and the plain path held against the reference's
``pwconv_pallas`` in interpret mode at one shape per variant."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import SPECS, assert_match, rand, to_jax, to_torch  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.pwconv import pwconv_pallas  # noqa: E402
from repro_torch.core import chain, network  # noqa: E402
from repro_torch.kernels import blocking, lowering, pwconv  # noqa: E402
from repro_torch.kernels.policy import (BF16_STREAM, KernelPolicy,  # noqa: E402
                                        DtypePolicy)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _xlstm_linears(monkeypatch):
    """(Ci, Co) of every Linear of the full xlstm-125m, in layer order,
    without allocating its weights."""
    from torch import nn

    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer, xlstm
    shapes = []

    def fake_linear(generator, d_in, d_out, **kw):
        shapes.append((d_in, d_out))
        return nn.ParameterDict({"w": nn.Parameter(torch.empty(0))})

    monkeypatch.setattr(xlstm, "init_linear", fake_linear)
    monkeypatch.setattr(transformer, "init_embedding",
                        lambda *a, **k: nn.ParameterDict())
    cfg = get_config("xlstm-125m")
    transformer.init_params(cfg, seed=0, device="cpu")
    return cfg, shapes


def test_xlstm_125m_linears_are_the_expected_shapes(monkeypatch):
    cfg, shapes = _xlstm_linears(monkeypatch)
    mlstm = [(768, 3072), (1536, 1536), (1536, 1536), (1536, 1536),
             (1536, 8), (1536, 768)]
    slstm = [(768, 3072), (768, 1024), (768, 1024), (1024, 768)]
    assert shapes == (mlstm + slstm) * (cfg.n_layers // 2)
    assert len(shapes) == 60


@pytest.mark.parametrize("dtype", tuple(DTYPES))
@pytest.mark.parametrize("g", (1, 8, 16))
def test_xlstm_decode_linears_plan_stream(monkeypatch, g, dtype):
    _, shapes = _xlstm_linears(monkeypatch)
    for ci, co in shapes:
        p = blocking.plan_pwconv(g, ci, co, dtype=DTYPES[dtype])
        assert p.variant == "stream", (ci, co)
        assert p.block_g >= min(g, 8) and p.cluster * p.block_c >= ci
        assert 1 <= p.cluster <= blocking.PW_STREAM_MAX_CLUSTER
        # two CTAs for every SM wherever 128 Ci rows a CTA allow it
        ctas = -(-co // p.block_co) * -(-g // p.block_g) * p.cluster
        assert (ctas >= 2 * blocking.SMS or p.cluster == 8
                or -(-ci // (2 * p.cluster)) < 128)
        assert p.block_c >= 128 or p.cluster == 1


@pytest.mark.parametrize("dtype,want", (("float32", "simt"),
                                        ("bfloat16", "tc")))
def test_xlstm_prefill_linears_plan_tc_in_bf16_simt_in_fp32(monkeypatch,
                                                            dtype, want):
    _, shapes = _xlstm_linears(monkeypatch)
    for ci, co in shapes:
        p = blocking.plan_pwconv(4096, ci, co, dtype=DTYPES[dtype])
        assert p.variant == want, (ci, co)
        assert (p.block_g, p.block_co, p.block_c) in blocking.PW_TILES[want]


def _expected_variant(g, ci, co, dtype):
    if g <= blocking.PW_STREAM_MAX_G[dtype]:
        return "stream"
    if dtype == torch.bfloat16 and ci % 8 == 0 and co % 8 == 0:
        return "tc"
    return "simt"


@pytest.mark.parametrize("fused", (None, False))
@pytest.mark.parametrize("dtype", tuple(DTYPES))
@pytest.mark.parametrize("batch", (1, 8))
@pytest.mark.parametrize("arch", tuple(SPECS))
def test_cnn_pw_segments_plan_the_expected_variant(monkeypatch, arch, batch,
                                                   dtype, fused):
    """Every product the chain planner sizes (``pw`` segments and the FCs
    of a standalone ``se``) gets the variant its shape calls for."""
    seen = []
    real = blocking.plan_pwconv

    def spy(g, ci, co, **kw):
        p = real(g, ci, co, **kw)
        seen.append((g, ci, co, kw["dtype"], p))
        return p

    monkeypatch.setattr(blocking, "plan_pwconv", spy)
    spec = getattr(network, SPECS[arch])()
    stream = None if dtype == "float32" else "bfloat16"
    network.plan_network(
        spec, (batch, 112, 112, spec.c_in), dtype=torch.float32,
        policy=KernelPolicy(fused=fused,
                            dtype_policy=DtypePolicy(stream=stream)))
    for g, ci, co, dt, p in seen:
        assert dt == DTYPES[dtype]
        assert p.variant == _expected_variant(g, ci, co, dt), (g, ci, co)
        assert 0 < p.smem_bytes <= blocking.DEFAULT_SMEM_BUDGET
    if fused is False or arch == "mnasnet":
        big = [p.variant for g, _, _, dt, p in seen
               if g > blocking.PW_STREAM_MAX_G[dt]]
        assert big and set(big) == {"simt" if dtype == "float32" else "tc"}


@pytest.mark.parametrize("g,ci,co", [(37, 20, 50), (300, 20, 64),
                                     (300, 64, 50), (4096, 12, 3072)])
def test_unaligned_16bit_shapes_plan_simt(g, ci, co):
    for dt in (torch.bfloat16, torch.float16):
        assert blocking.plan_pwconv(g, ci, co, dtype=dt).variant == "simt"
    assert blocking.plan_pwconv(g, 64, 64, dtype=torch.bfloat16,
                                aligned=False).variant == "simt"


GRID = [(g, ci, co) for g in (1, 3, 8, 16, 17, 49, 300, 1568, 4096, 25088,
                              100352)
        for ci, co in ((32, 64), (72, 6), (512, 512), (768, 3072),
                       (1536, 8), (20, 50), (1024, 1024), (3072, 768))]


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16,
                                   torch.float16))
def test_every_planned_tile_is_compiled_and_fits(dtype):
    for g, ci, co in GRID:
        p = blocking.plan_pwconv(g, ci, co, dtype=dtype)
        vec = blocking.pw_vector(co, dtype)
        assert blocking.pwconv_tile_error(
            p.variant, p.block_g, p.block_co, p.block_c, ci=ci,
            vector=vec) is None, (g, ci, co, p)
        assert p.smem_bytes == blocking.pwconv_smem_bytes(
            p.variant, p.block_g, p.block_co, p.block_c, ci)
        assert 0 < p.smem_bytes <= blocking.DEFAULT_SMEM_BUDGET


@pytest.mark.parametrize("variant", blocking.PW_VARIANTS)
def test_every_compiled_tile_fits_one_cta(variant):
    for bg, bco, bci in blocking.PW_TILES[variant]:
        bci = bci or 4096 // blocking.PW_STREAM_MAX_CLUSTER
        assert 0 < blocking.pwconv_smem_bytes(variant, bg, bco, bci,
                                              4096) <= (
            blocking.DEFAULT_SMEM_BUDGET)


def test_stream_fills_the_card_at_the_decode_shapes():
    p = blocking.plan_pwconv(8, 768, 3072, dtype=torch.float32)
    assert (p.block_g, p.block_co, p.block_c, p.cluster) == (8, 64, 192, 4)
    p = blocking.plan_pwconv(8, 1536, 1536, dtype=torch.float32)
    assert (p.block_co, p.block_c, p.cluster) == (64, 192, 8)
    p = blocking.plan_pwconv(1, 1536, 8, dtype=torch.bfloat16)
    assert (p.block_g, p.block_co, p.cluster, p.block_c) == (1, 32, 8, 192)
    # fp32 streams up to G = 64 rows, 16 to a CTA
    p = blocking.plan_pwconv(49, 1024, 1024, dtype=torch.float32)
    assert (p.variant, p.block_g) == ("stream", 16)
    assert blocking.plan_pwconv(49, 1024, 1024,
                                dtype=torch.bfloat16).variant == "tc"
    # bf16 reads 8 columns a thread: 8 rows of G at most in one CTA
    p = blocking.plan_pwconv(16, 768, 3072, dtype=torch.bfloat16)
    assert p.block_g == 8
    # Co rows that are not whole 16-byte vectors read one element a thread
    p = blocking.plan_pwconv(8, 72, 6, dtype=torch.float32)
    assert p.block_co == 32 and blocking.pw_vector(6, torch.float32) == 1


def test_tc_and_simt_take_smaller_tiles_to_fill_the_card():
    assert blocking.plan_pwconv(4096, 768, 3072,
                                dtype=torch.bfloat16).block_g == 128
    p = blocking.plan_pwconv(1568, 512, 512, dtype=torch.bfloat16)
    assert (p.block_g, p.block_co) == (64, 64)
    p = blocking.plan_pwconv(100, 1024, 1024, dtype=torch.float32)
    assert (p.variant, p.block_g, p.block_co) == ("simt", 64, 64)


@pytest.mark.parametrize("variant,tile,vector", [
    ("tc", (128, 128, 32), 8), ("tc", (256, 128, 64), 8),
    ("simt", (128, 128, 16), 4), ("simt", (32, 64, 8), 4),
    ("stream", (3, 64, 96), 4), ("stream", (16, 64, 96), 8),
    ("stream", (8, 64, 10), 4), ("stream", (8, 64, 96), 1),
    ("stream", (8, 512, 96), 8), ("nope", (8, 64, 96), 4)])
def test_override_outside_the_table_is_refused(variant, tile, vector):
    assert blocking.pwconv_tile_error(variant, *tile, ci=768,
                                      vector=vector) is not None


@pytest.mark.parametrize("variant,tile,vector", [
    ("tc", (64, 128, 64), 8), ("simt", (64, 64, 8), 4),
    ("stream", (16, 64, 96), 4), ("stream", (8, 32, 768), 1),
    ("stream", (4, 256, 100), 8)])
def test_override_inside_the_table_is_taken(variant, tile, vector):
    assert blocking.pwconv_tile_error(variant, *tile, ci=768,
                                      vector=vector) is None


def test_unknown_variant_raises():
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="unknown variant"):
        pwconv.pwconv(x, torch.zeros(8, 8), variant="wgmma")
    with pytest.raises(ValueError, match="unknown pwconv variant"):
        blocking.plan_pwconv(4, 8, 8, variant="wgmma")


def test_lowering_passes_the_plans_variant(monkeypatch):
    """The ``pw`` segments hand their planned variant and tile to the
    kernel wrapper (forced onto the kernel path; on CPU tensors every
    wrapper computes its plain version)."""
    calls = []

    def spy(x, w, b=None, **kw):
        calls.append((x.shape[0], kw))
        return pwconv.pwconv_plain(x, w, b, activation=kw["activation"],
                                   out_dtype=kw["out_dtype"])

    monkeypatch.setattr(lowering, "pwconv", spy)
    monkeypatch.setattr(KernelPolicy, "resolved", lambda self, d: "cuda")
    spec = chain.inverted_residual_spec(16, 16)
    for batch, dp in ((1, BF16_STREAM), (8, DtypePolicy())):
        pol = KernelPolicy(fused=False, dtype_policy=dp)
        shape = (batch, 3, 3, 16)
        cp = chain.plan(spec, shape, policy=pol)
        params = chain.init_chain(torch.Generator().manual_seed(0), spec, 16,
                                  torch.float32, torch.device("cpu"))
        calls.clear()
        lowering.lower(spec, cp, pol)(params, torch.randn(shape))
        segs = [s for s in cp.segments if s.kind == "pw"]
        assert len(calls) == len(segs) == 2
        for (g, kw), s in zip(calls, segs):
            assert kw["variant"] == s.plan.variant
            assert (kw["block_g"], kw["block_co"], kw["block_ci"]) == (
                s.plan.block_g, s.plan.block_co, s.plan.block_c)
            assert s.plan.variant == ("stream" if g <= 16 else "simt")


def test_launch_counters_reset_together():
    from repro_torch import graphs
    from repro_torch.launch import serve
    from repro_torch.mobilenet_inference import reset_launch_counts
    for reset in (graphs.reset, reset_launch_counts,
                  serve.reset_launch_counts):
        pwconv.launches = 5
        pwconv.launches_by_variant["tc"] = 3
        reset()
        assert pwconv.launches == 0
        assert set(pwconv.launches_by_variant) == set(blocking.PW_VARIANTS)
        assert not any(pwconv.launches_by_variant.values())


# one shape per variant: stream (decode gate FC with bias), simt / tc
# (a CNN layer), simt (16-bit rows TMA cannot describe)
PARITY = [(8, 1536, 8, None, True), (300, 128, 256, "relu6", True),
          (37, 20, 50, "gelu", True), (1, 768, 64, "silu", False)]


@pytest.mark.parametrize("dtype", tuple(DTYPES))
@pytest.mark.parametrize("g,ci,co,act,has_bias", PARITY)
def test_pwconv_plain_path_matches_pallas_per_variant(g, ci, co, act,
                                                      has_bias, dtype):
    rng = np.random.default_rng(14)
    x, w = rand(rng, (g, ci)), rand(rng, (ci, co), ci ** -0.5)
    b = rand(rng, (co,), 0.5) if has_bias else None
    got = pwconv.pwconv(to_torch(x, dtype), to_torch(w, dtype),
                        to_torch(b, dtype), activation=act)
    pallas = pwconv_pallas(to_jax(x, dtype), to_jax(w, dtype),
                           to_jax(b, dtype), activation=act, interpret=True)
    oracle = jref.pwconv_ref(to_jax(x, dtype), to_jax(w, dtype),
                             bias=to_jax(b, dtype), activation=act)
    assert got.dtype == DTYPES[dtype]
    assert_match(got, pallas, dtype)
    assert_match(got, oracle, dtype)


def test_pwconv_plain_path_widens_bf16_once():
    rng = np.random.default_rng(15)
    x, w = rand(rng, (300, 128)), rand(rng, (128, 256), 128 ** -0.5)
    b = rand(rng, (256,), 0.5)
    got = pwconv.pwconv(to_torch(x, "bfloat16"), to_torch(w, "bfloat16"),
                        to_torch(b, "bfloat16"), activation="relu6",
                        out_dtype=torch.float32)
    want = pwconv_pallas(to_jax(x, "bfloat16"), to_jax(w, "bfloat16"),
                         to_jax(b, "bfloat16"), activation="relu6",
                         interpret=True, out_dtype="float32")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
