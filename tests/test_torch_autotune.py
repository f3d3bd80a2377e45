"""The port's measured autotuner (``repro_torch/kernels/autotune.py``) on
the CPU, where every candidate runs the plain versions: the reference's
``tests/test_autotune.py`` cases mirrored on the port (cache round trip,
``plan`` consulting the cache, serialization of every ``BlockPlan`` field,
winner parity, key sensitivity, corrupted files and entries), the ladders
the tuner draws from, the rules of the port (a candidate failure raises
and writes nothing — only under ``on_failure="degrade"`` do the classified
ones fold, ``tests/test_torch_runtime.py`` — no measurement inside a
capture, stale entries dropped
with a warning), ``tune_network`` and its replay, and parity with the JAX
package: the stage signatures and a tuned network's output and segments.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from _torch_parity import SPECS, rand, rel_err, to_jax, to_torch  # noqa: E402
from repro.core import network as jnet  # noqa: E402
from repro.kernels import autotune as jautotune  # noqa: E402
from repro.kernels.policy import KernelPolicy as JKernelPolicy  # noqa: E402
from repro_torch import convert, graphs, mobilenet_inference  # noqa: E402
from repro_torch.core import chain, network  # noqa: E402
from repro_torch.kernels import autotune, blocking, lowering  # noqa: E402
from repro_torch.kernels.diskstore import VersionedJsonStore  # noqa: E402
from repro_torch.kernels.policy import (BF16_STREAM, DtypePolicy,  # noqa: E402
                                        KernelPolicy)

RNG = np.random.default_rng(7)

#: A tiny inverted residual keeps each tune to a fraction of a second.
CI_, CO_, EXPAND, RES = 8, 8, 4, 8
CPU = torch.device("cpu")


def _problem(dtype=torch.float32, res=RES, ci=CI_, co=CO_, batch=1):
    spec = chain.inverted_residual_spec(ci, co, expand=EXPAND, stride=1)
    params = chain.init_chain(torch.Generator().manual_seed(3), spec, ci,
                              dtype=dtype, device="cpu")
    x = torch.from_numpy(RNG.normal(size=(batch, res, res, ci)).astype(
        np.float32)).to(dtype)
    return spec, params, x


def _policy(tmp_path, **kw):
    kw.setdefault("autotune", True)
    kw.setdefault("tune_cache", str(tmp_path / "tune.json"))
    return KernelPolicy(**kw)


def _analytic(spec, x, pol):
    return chain.plan(spec, x.shape, dtype=x.dtype,
                      policy=dataclasses.replace(pol, autotune=False))


def _entries(pol):
    with open(pol.tune_cache) as f:
        return json.load(f)["entries"]


# ---------------------------------------------------------------------------
# cache round trip
# ---------------------------------------------------------------------------

def test_tune_write_reload_hit_no_remeasure(tmp_path, monkeypatch):
    """The first execute measures and persists; a fresh load of the file
    replays the winner with zero measurement and the same bits."""
    spec, params, x = _problem()
    pol = _policy(tmp_path)
    y1 = chain.execute(spec, params, x, policy=pol)
    with open(pol.tune_cache) as f:
        raw = json.load(f)
    assert raw["version"] == autotune.CACHE_VERSION
    (entry,) = raw["entries"].values()
    assert entry["n_measured"] >= 1 and entry["measured_us"] > 0

    def boom(*a, **k):
        raise AssertionError("a cache hit must not measure")
    monkeypatch.setattr(autotune, "measure_run", boom)
    r = autotune.autotune_chain(spec, params, x, policy=pol,
                                base_plan=_analytic(spec, x, pol))
    assert r.cache_hit and r.n_measured == 0 and r.measured == ()
    y2 = chain.execute(spec, params, x, policy=pol)
    assert torch.equal(y1, y2)


def test_plan_consults_cache(tmp_path):
    """``chain.plan`` with autotune returns the cached winner; on a miss it
    answers analytically."""
    spec, params, x = _problem()
    pol = _policy(tmp_path)
    analytic = _analytic(spec, x, pol)
    assert chain.plan(spec, x.shape, dtype=x.dtype, policy=pol,
                      device=CPU) == analytic
    r = autotune.autotune_chain(spec, params, x, policy=pol,
                                base_plan=analytic)
    assert not r.cache_hit
    assert chain.plan(spec, x.shape, dtype=x.dtype, policy=pol,
                      device=CPU) == r.plan
    assert chain.resolve_plan(spec, params, x, policy=pol) == r.plan
    assert chain.resolve_plan(spec, params, x, policy=pol,
                              chain_plan=analytic) is analytic


def test_autotune_off_never_reads_the_cache(tmp_path, monkeypatch):
    """The default policy plans analytically even beside a tuned file."""
    spec, params, x = _problem()
    pol = _policy(tmp_path)
    chain.execute(spec, params, x, policy=pol)

    def boom(*a, **k):
        raise AssertionError("autotune=False consulted the cache")
    monkeypatch.setattr(autotune.TuneCache, "load", boom)
    off = dataclasses.replace(pol, autotune=False)
    assert chain.plan(spec, x.shape, policy=off) == _analytic(spec, x, pol)
    chain.execute(spec, params, x, policy=off)


@pytest.mark.parametrize("spec,shape,fused", [
    (chain.inverted_residual_spec(16, 16, expand=6), (1, 14, 14, 16), None),
    (chain.inverted_residual_spec(16, 16, expand=6), (1, 14, 14, 16), False),
    (chain.mbconv_se_spec(16, 24, expand=3, stride=2, hf=5),
     (2, 28, 28, 16), None),
    (chain.fused_mbconv_spec(16, 24, stride=2), (2, 28, 28, 16), None),
    (chain.separable_block_spec(64), (1, 7, 7, 32), False),
])
def test_chain_plan_serialization_round_trip(spec, shape, fused):
    """Every BlockPlan field round-trips exactly, ``variant`` included, so
    the frozen plan compares equal."""
    cp = chain.plan(spec, shape, policy=KernelPolicy(fused=fused))
    d = autotune.serialize_chain_plan(cp)
    json.dumps(d)
    back = autotune.deserialize_chain_plan(json.loads(json.dumps(d)))
    assert back == cp
    assert [s.plan.variant for s in back.segments] == [
        s.plan.variant for s in cp.segments]


def test_deserialize_rejects_a_malformed_plan():
    spec = chain.inverted_residual_spec(16, 16, expand=6)
    d = autotune.serialize_chain_plan(chain.plan(spec, (1, 14, 14, 16)))
    d["segments"][0]["plan"]["bogus"] = 1
    with pytest.raises(ValueError):
        autotune.deserialize_chain_plan(d)


# ---------------------------------------------------------------------------
# measured winner parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_measured_plan_parity_with_analytic(tmp_path, dtype):
    """Whatever candidate wins, its output is the analytic plan's."""
    spec, params, x = _problem(dtype=dtype)
    pol = _policy(tmp_path)
    y_tuned = chain.execute(spec, params, x, policy=pol)
    y_analytic = chain.execute(spec, params, x,
                               policy=dataclasses.replace(pol,
                                                          autotune=False))
    tol = 1e-5 if dtype == torch.float32 else 5e-2
    assert rel_err(y_tuned, y_analytic) <= tol


def test_multi_segment_chain_tunes_and_matches(tmp_path):
    """Coordinate descent over a pw + dw + pw chain (``fused=False``):
    every segment contributes candidates, and the output holds."""
    spec, params, x = _problem()
    pol = _policy(tmp_path, fused=False)
    y = chain.execute(spec, params, x, policy=pol)
    y_ref = chain.execute(spec, params, x,
                          policy=dataclasses.replace(pol, autotune=False))
    assert rel_err(y, y_ref) <= 1e-5
    (entry,) = _entries(pol).values()
    assert [s["kind"] for s in entry["plan"]["segments"]] == [
        "pw", "dw", "pw"]
    assert entry["n_measured"] > autotune.MAX_SEGMENT_CANDIDATES


# ---------------------------------------------------------------------------
# cache-key sensitivity
# ---------------------------------------------------------------------------

def test_problem_key_changes_with_shape_dtype_budget_fusion_and_impl():
    spec, _, _ = _problem()
    pol = KernelPolicy(autotune=True)
    key = lambda shape=(1, 8, 8, 8), dt=torch.float32, p=pol: (  # noqa: E731
        autotune.problem_key(spec, shape, dt, p, CPU))
    base = key()
    assert key() == base
    assert key((1, 16, 16, 8)) != base
    assert key((2, 8, 8, 8)) != base
    assert key(dt=torch.bfloat16) != base
    assert key(p=dataclasses.replace(pol, smem_budget=1 << 16)) != base
    assert key(p=dataclasses.replace(pol, fused=False)) != base
    assert key(p=dataclasses.replace(pol, impl="torch")) == base  # auto=torch
    other = chain.inverted_residual_spec(CI_, CO_, expand=EXPAND, stride=2)
    assert autotune.problem_key(other, (1, 8, 8, 8), torch.float32, pol,
                                CPU) != base


def test_problem_key_changes_with_dtype_policy():
    """A bf16-streamed winner is another problem than a native one, and
    the ``out`` pin is another again; an explicit native policy is the
    default."""
    spec, _, _ = _problem()
    pol = KernelPolicy(autotune=True)
    base = autotune.problem_key(spec, (1, 8, 8, 8), torch.float32, pol, CPU)
    keys = {autotune.problem_key(
        spec, (1, 8, 8, 8), torch.float32,
        dataclasses.replace(pol, dtype_policy=dp), CPU)
        for dp in (DtypePolicy(stream="bfloat16"),
                   DtypePolicy(stream="bfloat16", out="float32"))}
    assert len(keys) == 2 and base not in keys
    assert autotune.problem_key(
        spec, (1, 8, 8, 8), torch.float32,
        dataclasses.replace(pol, dtype_policy=DtypePolicy()), CPU) == base


@pytest.mark.parametrize("override", ("block_g", "block_co", "block_ci"))
def test_problem_key_changes_with_tile_overrides(override):
    """The lowering lets the policy's pwconv tile override the plan, so a
    winner measured under an override is another problem."""
    spec, _, _ = _problem()
    pol = KernelPolicy(autotune=True)
    base = autotune.problem_key(spec, (1, 8, 8, 8), torch.float32, pol, CPU)
    over = dataclasses.replace(pol, **{override: 64})
    sig = autotune.problem_signature(spec, (1, 8, 8, 8), torch.float32, over,
                                     CPU)
    assert sig[override] == 64
    assert autotune.problem_key(spec, (1, 8, 8, 8), torch.float32, over,
                                CPU) != base


def test_problem_key_changes_with_device(monkeypatch):
    """A winner measured on one card never replays on another."""
    spec, _, _ = _problem()
    pol = KernelPolicy(autotune=True)
    base = autotune.problem_key(spec, (1, 8, 8, 8), torch.float32, pol, CPU)
    monkeypatch.setattr(autotune, "device_identity", lambda d: {
        "device": "NVIDIA H100 80GB HBM3", "capability": [9, 0]})
    h100 = autotune.problem_key(spec, (1, 8, 8, 8), torch.float32, pol, CPU)
    monkeypatch.setattr(autotune, "device_identity", lambda d: {
        "device": "NVIDIA A100-SXM4-80GB", "capability": [8, 0]})
    a100 = autotune.problem_key(spec, (1, 8, 8, 8), torch.float32, pol, CPU)
    assert len({base, h100, a100}) == 3


def test_fingerprint_names_the_kernels_only_where_they_run():
    pol = KernelPolicy()
    fp = autotune.backend_fingerprint(pol, CPU)
    assert fp["impl"] == "torch" and fp["kernels"] is None
    assert fp["torch"] == torch.__version__
    assert len(autotune.kernels_digest()) == 16


def test_bf16_streamed_entry_does_not_replay_on_native(tmp_path):
    spec, params, x = _problem()
    pol_bf = _policy(tmp_path, dtype_policy=BF16_STREAM)
    chain.execute(spec, params, x, policy=pol_bf)
    (entry,) = _entries(pol_bf).values()
    assert entry["signature"]["dtype_policy"] == {"stream": "bfloat16",
                                                  "out": None}
    assert entry["plan"]["dtype_bytes"] == 2  # budgeted at the stream width
    pol = _policy(tmp_path)
    assert autotune.lookup_cached_plan(
        spec, x.shape, x.dtype, pol, base_plan=_analytic(spec, x, pol),
        device=CPU) is None


def test_distinct_problems_get_distinct_entries(tmp_path):
    spec, params, x8 = _problem()
    _, _, x12 = _problem(res=12)
    pol = _policy(tmp_path)
    chain.execute(spec, params, x8, policy=pol)
    chain.execute(spec, params, x12, policy=pol)
    assert len(_entries(pol)) == 2


# ---------------------------------------------------------------------------
# corrupted and stale caches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("garbage", [
    "not json at all {{{",
    '{"version": 999, "entries": "nope"}',
    '[]',
    '',
])
def test_corrupted_cache_file_recovers(tmp_path, garbage):
    """A trashed file neither crashes nor poisons the result: the tuner
    measures from the analytic plan and writes a valid file again."""
    spec, params, x = _problem()
    pol = _policy(tmp_path)
    with open(pol.tune_cache, "w") as f:
        f.write(garbage)
    y = chain.execute(spec, params, x, policy=pol)
    y_ref = chain.execute(spec, params, x,
                          policy=dataclasses.replace(pol, autotune=False))
    assert rel_err(y, y_ref) <= 1e-5
    with open(pol.tune_cache) as f:
        raw = json.load(f)
    assert raw["version"] == autotune.CACHE_VERSION and raw["entries"]


def test_corrupted_entry_retunes(tmp_path):
    spec, params, x = _problem()
    pol = _policy(tmp_path)
    key = autotune.problem_key(spec, x.shape, x.dtype, pol, CPU)
    cache = autotune.TuneCache(pol.tune_cache)
    cache.put(key, {"plan": {"segments": "garbage"}})
    cache.save()
    y = chain.execute(spec, params, x, policy=pol)
    assert y.shape == (1, RES, RES, CO_)
    (entry,) = _entries(pol).values()
    assert entry["n_measured"] >= 1


def test_lookup_cached_plan_miss_returns_none(tmp_path):
    spec, _, x = _problem()
    pol = _policy(tmp_path)
    assert autotune.lookup_cached_plan(
        spec, x.shape, x.dtype, pol, base_plan=_analytic(spec, x, pol),
        device=CPU) is None


@pytest.mark.parametrize("edit", ("slab_h", "smem_bytes", "kind"))
def test_hand_edited_infeasible_entry_is_dropped(tmp_path, edit):
    """An entry whose plan is not one of its segment's candidates (or
    whose segments are not the chain's) is dropped with a warning naming
    the cache path, and ``plan`` answers analytically."""
    spec, params, x = _problem()
    pol = _policy(tmp_path)
    chain.execute(spec, params, x, policy=pol)
    with open(pol.tune_cache) as f:
        raw = json.load(f)
    (entry,) = raw["entries"].values()
    seg = entry["plan"]["segments"][0]
    if edit == "kind":
        seg["kind"] = "fused2"
    else:
        seg["plan"][edit] = 10 ** 6
    with open(pol.tune_cache, "w") as f:
        json.dump(raw, f)
    analytic = _analytic(spec, x, pol)
    with pytest.warns(UserWarning, match=str(pol.tune_cache)):
        got = autotune.lookup_cached_plan(spec, x.shape, x.dtype, pol,
                                          base_plan=analytic, device=CPU)
    assert got is None
    with pytest.warns(UserWarning, match="dropping tune-cache entry"):
        assert chain.plan(spec, x.shape, policy=pol, device=CPU) == analytic


def test_diskstore_merges_on_write_and_gates_the_version(tmp_path):
    path = str(tmp_path / "sub" / "store.json")
    a, b = VersionedJsonStore.load(path), VersionedJsonStore.load(path)
    a.put("a", {"v": 1})
    a.save()
    b.put("b", {"v": 2})
    b.save()
    assert set(VersionedJsonStore.load(path).entries) == {"a", "b"}

    class V2(VersionedJsonStore):
        version = 2
    assert V2.load(path).entries == {}
    with open(path, "w") as f:
        f.write("{")
    with pytest.warns(UserWarning, match=path):
        assert VersionedJsonStore.load(path).entries == {}


# ---------------------------------------------------------------------------
# the ladders
# ---------------------------------------------------------------------------

def _kernel_accepts(kind, geom, p, dtype, budget):
    """The kernel wrappers' and launchers' conditions on a plan, and its
    shared memory by the kernel's model."""
    if kind in ("fused2", "fused3", "fusedmb"):
        cs, n = p.block_g, p.cluster
        assert 1 <= n <= 8 and cs * n >= geom.c and cs * (n - 1) < geom.c
        assert 1 <= p.block_c <= cs and p.block_co >= 8
        assert p.block_co % 8 == 0 and p.smem_bytes <= budget
        tc = dtype == torch.bfloat16
        if kind == "fusedmb":
            assert p.smem_bytes == blocking.fused_mb_smem_bytes(
                ci=geom.ci, c_slice=cs, cb=p.block_c, panel=p.block_co,
                slab_h=p.slab_h, tile_w=p.tile_w, hf=geom.hf, wf=geom.wf,
                stride=geom.stride, tc=tc)
        else:
            assert p.smem_bytes == blocking.separable_smem_bytes(
                ci=geom.ci if kind == "fused3" else 0, c_slice=cs,
                cb=p.block_c, panel=p.block_co, cluster=n, slab_h=p.slab_h,
                wo=geom.wo, hi=geom.hi, wi=geom.wi, hf=geom.hf, wf=geom.wf,
                stride=geom.stride, tc=tc)
    elif kind in ("dw", "dw_se"):
        vec = p.block_g
        assert p.block_c % vec == 0 and p.tile_w % blocking.DW_RUN == 0
        assert blocking.dw_threads(p.slab_h, p.tile_w, p.block_c,
                                   vec) <= blocking.DW_THREADS
        tile = blocking.dwconv2d_smem_bytes(p.slab_h, p.tile_w, p.block_c,
                                            geom.hf, geom.wf, geom.stride,
                                            dtype)
        assert tile <= blocking.DW_TILE_SMEM
        if kind == "dw_se":
            for pass_ in (1, 2):
                assert blocking.dw_se_smem_bytes(
                    pass_, p.slab_h, p.tile_w, p.block_c, geom.hf, geom.wf,
                    geom.stride, geom.g, dtype) <= budget
    elif kind == "pw":
        vec = blocking.pw_vector(geom.co, dtype)
        assert blocking.pwconv_tile_error(p.variant, p.block_g, p.block_co,
                                          p.block_c, ci=geom.ci,
                                          vector=vec) is None
        if p.variant == "tc":
            assert dtype != torch.float32
            assert geom.ci % 8 == 0 and geom.co % 8 == 0
        if p.variant == "stream":
            assert geom.g <= blocking.PW_STREAM_LADDER_MAX_G
        assert p.smem_bytes <= blocking.DEFAULT_SMEM_BUDGET


@pytest.mark.parametrize("fused", (None, False))
@pytest.mark.parametrize("arch", tuple(SPECS))
def test_ladders_feasible_capped_and_analytic_first(arch, fused):
    """Every segment of the four bodies at 112x112, batch 1 and 8, fp32
    and bf16: at most MAX_SEGMENT_CANDIDATES candidates, the analytic plan
    first, no repeats, each a plan its kernel launches; fused kinds and
    ``dw`` / ``dw_se`` / ``pw`` have more than one."""
    net = getattr(network, SPECS[arch])(1.0)
    kinds_with_more = set()
    for batch in (1, 8):
        for dt, dp in (("float32", None), ("bfloat16", "bfloat16")):
            pol = KernelPolicy(fused=fused, dtype_policy=DtypePolicy(
                stream=dp))
            nplan = network.plan_network(net, (batch, 112, 112, net.c_in),
                                         policy=pol, device=CPU)
            sdt = getattr(torch, dt)
            for spec, cp, shape in zip(net.blocks, nplan.plans,
                                       nplan.block_shapes):
                for geom, seg in zip(autotune._segment_geoms(
                        spec.stages, cp, shape), cp.segments):
                    assert geom.kind == seg.kind
                    cands = autotune.segment_candidates(
                        geom, seg.plan, sdt, cp.smem_budget)
                    assert cands[0] == seg.plan
                    assert len(cands) <= autotune.MAX_SEGMENT_CANDIDATES
                    assert len(set(cands)) == len(cands)
                    if len(cands) > 1:
                        kinds_with_more.add(seg.kind)
                    for p in cands:
                        _kernel_accepts(seg.kind, geom, p, sdt,
                                        cp.smem_budget)
    hist = nplan.segment_histogram()
    assert kinds_with_more == set(hist) - {"se", "mb"}


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_ladders_start_with_the_planners_plan(dtype):
    """Each kind's ladder is its planner's search: its first plan is the
    plan the planner returns."""
    assert blocking.separable_fused_ladder(
        14, 14, 96, 576, 160, stride=2, dtype=dtype, batch=8, hi=28,
        wi=28)[0] == blocking.plan_separable3(
        14, 14, 96, 576, 160, stride=2, dtype=dtype, batch=8, hi=28, wi=28)
    assert blocking.fused_mb_ladder(
        28, 28, 24, 144, 40, stride=2, dtype=dtype,
        batch=8)[0] == blocking.plan_fused_mb(28, 28, 24, 144, 40, stride=2,
                                              dtype=dtype, batch=8)
    assert blocking.dwconv2d_ladder(
        28, 28, 72, 5, 5, stride=2, dtype=dtype)[0] == blocking.plan_dwconv2d(
        0, 0, 28, 28, 72, 5, 5, stride=2, dtype=dtype)
    assert blocking.dw_se_ladder(
        14, 14, 480, 20, dtype=dtype,
        batch=8)[0] == blocking.plan_dw_se_tile(14, 14, 480, 20,
                                                dtype=dtype, batch=8)
    for g in (8, 49, 392, 25088):
        lad = blocking.pwconv_ladder(g, 960, 160, dtype=dtype)
        assert lad[0] == blocking.plan_pwconv(g, 960, 160, dtype=dtype)
        assert ("stream" in {p.variant for p in lad}) == (
            g <= blocking.PW_STREAM_LADDER_MAX_G)
        assert ("tc" in {p.variant for p in lad}) == (dtype != torch.float32)


# ---------------------------------------------------------------------------
# the port's rules
# ---------------------------------------------------------------------------

def test_candidate_failure_propagates_and_writes_no_cache(tmp_path,
                                                          monkeypatch):
    """A candidate failure that the runtime's whitelist does not
    recognize (a plain ``RuntimeError``: a bug, not a refused launch) is
    never folded into an infinite time: it raises, naming the segment,
    and the cache file is never written."""
    spec, params, x = _problem()
    pol = _policy(tmp_path, fused=False)
    analytic = _analytic(spec, x, pol)
    real = lowering.lower

    def lower(spec_, cp, policy=None):
        if cp != analytic:
            raise RuntimeError("injected launch failure")
        return real(spec_, cp, policy)
    monkeypatch.setattr(lowering, "lower", lower)
    with pytest.raises(RuntimeError, match="injected") as info:
        chain.execute(spec, params, x, policy=pol)
    assert any("segment 0 (pw)" in n for n in info.value.__notes__)
    assert not os.path.exists(pol.tune_cache)


def _mock_capture(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)


def test_tuning_inside_a_capture_raises(tmp_path, monkeypatch):
    spec, params, x = _problem()
    pol = _policy(tmp_path)
    base = _analytic(spec, x, pol)
    net = network.mobilenet_v2_spec(0.25)
    nparams = network.init_network(net, seed=0, device="cpu")
    nx = torch.randn(1, 16, 16, net.c_in)
    _mock_capture(monkeypatch)
    with pytest.raises(RuntimeError, match="capture"):
        autotune.autotune_chain(spec, params, x, policy=pol, base_plan=base)
    with pytest.raises(RuntimeError, match="capture"):
        network.tune_network(net, nparams, nx, policy=pol)
    assert not os.path.exists(pol.tune_cache)


# ---------------------------------------------------------------------------
# tune_network
# ---------------------------------------------------------------------------

def test_tune_network_then_replay(tmp_path, monkeypatch):
    """A network tune persists one network entry beside the block entries;
    a second tune (and ``plan_network``) replays it with zero measurement
    and no launch, and ``execute_network`` runs the tuned plan, its output
    that of the eager runner of that plan."""
    net = network.mnasnet_a1_spec(0.25)
    params = network.init_network(net, seed=0, device="cpu")
    x = torch.randn(2, 32, 32, net.c_in,
                    generator=torch.Generator().manual_seed(1))
    pol = _policy(tmp_path)
    r = network.tune_network(net, params, x, policy=pol)
    assert not r.cache_hit and r.n_measured == len(r.measured) > 0
    assert r.plan.key == r.key and r.key.startswith("net:")
    assert r.measured_us > 0 and r.analytic_us > 0
    entries = _entries(pol)
    assert r.key in entries and len(entries) > 1  # and the blocks' entries

    def boom(*a, **k):
        raise AssertionError("a replay must not measure")
    monkeypatch.setattr(autotune, "measure_run", boom)
    before = graphs.snapshot()
    r2 = network.tune_network(net, params, x, policy=pol)
    assert r2.cache_hit and r2.n_measured == 0 and r2.plan == r.plan
    assert graphs.delta(before, graphs.snapshot()) == dict.fromkeys(
        before, 0)
    assert network.plan_network(net, x.shape, policy=pol,
                                device=CPU) == r.plan
    network.clear_network_cache()
    y = network.execute_network(net, params, x, policy=pol)
    with torch.inference_mode():
        y_eager = network.build_network_fn(net, r.plan, pol)(params, x)
    assert torch.equal(y, y_eager)
    network.clear_network_cache()


def test_stale_network_entry_is_dropped(tmp_path):
    net = network.mobilenet_v1_spec(0.25)
    params = network.init_network(net, seed=0, device="cpu")
    x = torch.randn(1, 16, 16, net.c_in)
    pol = _policy(tmp_path)
    r = network.tune_network(net, params, x, policy=pol)
    with open(pol.tune_cache) as f:
        raw = json.load(f)
    raw["entries"][r.key]["network_plan"]["plans"][3]["segments"][0][
        "plan"]["cluster"] = 3
    with open(pol.tune_cache, "w") as f:
        json.dump(raw, f)
    analytic = network.plan_network(
        net, x.shape, policy=dataclasses.replace(pol, autotune=False))
    with pytest.warns(UserWarning, match="block 3"):
        got = network.plan_network(net, x.shape, policy=pol, device=CPU)
    # the per-block entries still answer where the network entry does not
    assert got.plans == r.plan.plans
    assert [p.segments[0].kind for p in got.plans] == [
        p.segments[0].kind for p in analytic.plans]


def test_mobilenet_inference_tunes_then_replays(tmp_path, capsys):
    """``--autotune --tune-cache``: the first run tunes, the second replays
    with zero measurements."""
    path = str(tmp_path / "cli.json")
    argv = ["--arch", "v2", "--batch", "2", "--res", "16", "--device", "cpu",
            "--autotune", "--tune-cache", path]
    assert mobilenet_inference.main(argv) == 0
    first = capsys.readouterr().out
    assert "autotune cache miss" in first
    assert mobilenet_inference.main(argv) == 0
    second = capsys.readouterr().out
    assert "autotune cache hit, 0 plans measured" in second
    assert os.path.exists(path)


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

def test_stage_signature_matches_reference():
    """Every stage of the four bodies signs as the reference's does."""
    for name in SPECS.values():
        stages = [s for b in getattr(network, name)(1.0).blocks
                  for s in b.stages]
        jstages = [s for b in getattr(jnet, name)(1.0).blocks
                   for s in b.stages]
        assert len(stages) == len(jstages)
        for s, js in zip(stages, jstages):
            assert autotune._stage_signature(s) == \
                jautotune._stage_signature(js)


def _numpy_params(jspec, seed=0):
    """The reference's parameter structure filled with seeded draws,
    biases nonzero, filters scaled by their fan-in."""
    rng = np.random.default_rng(seed)

    def scale(k, shape):
        if k in ("w", "w1", "w2"):
            return shape[0] ** -0.5
        if k == "f":
            return float(np.prod(shape[:-1])) ** -0.5
        return 0.1
    return [[{k: rand(rng, v.shape, scale(k, v.shape)) for k, v in st.items()}
             for st in block]
            for block in jnet.init_network(jax.random.PRNGKey(seed), jspec)]


@pytest.mark.parametrize("arch", tuple(SPECS))
def test_tuned_network_matches_reference(tmp_path, arch):
    """A small tuned body on the CPU: its output within 2e-5 of the
    reference's plain XLA path on the same weights, its segment kinds the
    reference's plan."""
    jspec = getattr(jnet, SPECS[arch])(0.25)
    spec = getattr(network, SPECS[arch])(0.25)
    np_params = _numpy_params(jspec)
    x = rand(np.random.default_rng(1), (2, 32, 32, spec.c_in))
    jpol = JKernelPolicy(impl="xla", on_failure="raise")
    want = jnet.execute_network(
        jspec, [[{k: to_jax(v) for k, v in st.items()} for st in b]
                for b in np_params], to_jax(x), policy=jpol)
    params = convert.params_from_numpy(np_params, "cpu")
    pol = _policy(tmp_path)
    r = network.tune_network(spec, params, to_torch(x), policy=pol)
    got = network.execute_network(spec, params, to_torch(x), policy=pol)
    assert rel_err(got, want) <= 2e-5
    jplan = jnet.plan_network(jspec, x.shape, policy=jpol)
    assert [[s.kind for s in p.segments] for p in r.plan.plans] == [
        [s.kind for s in p.segments] for p in jplan.plans]
    network.clear_network_cache()
