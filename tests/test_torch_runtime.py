"""The port's runtime ladder on the CPU: the failure taxonomy and its
whitelist, the fault-injection harness, the ladder's rung mapping, the
persistent quarantine, the tuner's retries and folding, the planner's and
the lookups' consults, the chain and network ladder matrices, raise mode,
the numeric guard, the plain rung, a fresh process, the network memo
(written only after a first call succeeded) and the default policy's
blindness to the quarantine; then the ladder held against the JAX
package's on the same faults, bodies and weights.

The cases follow ``tests/test_runtime.py`` one by one wherever they apply
to the port.  Every ladder test opts in with ``on_failure="degrade"``: the
port's default is ``"raise"``.  On the CPU every impl runs the plain
versions, so what is exercised here is the ladder's control flow; the
kernels' own failures are exercised on the card (``test_torch_cuda.py``,
``chip_smoke.py``).
"""
import dataclasses
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import FP32_TOL, SPECS, rand, rel_err, to_jax  # noqa: E402
from repro.core import network as jnet  # noqa: E402
from repro.kernels.policy import KernelPolicy as JKernelPolicy  # noqa: E402
from repro.runtime import faultinject as jfaultinject  # noqa: E402
from repro.runtime import quarantine as jquarantine  # noqa: E402
from repro.runtime import telemetry as jtelemetry  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import chain, network  # noqa: E402
from repro_torch.kernels import _build, autotune, lowering, pwconv  # noqa: E402
from repro_torch.kernels.diskstore import VersionedJsonStore  # noqa: E402
from repro_torch.kernels.policy import DtypePolicy, KernelPolicy  # noqa: E402
from repro_torch.runtime import (executor, failures, faultinject,  # noqa: E402
                                 ladder, quarantine, telemetry)

BF16_REL_TOL = 5e-2


def _reset():
    for fi in (faultinject, jfaultinject):
        fi.disarm_all()
    for tm in (telemetry, jtelemetry):
        tm.reset_runtime_telemetry()
    for q in (quarantine, jquarantine):
        q.clear_memo()
    network.clear_network_cache()
    jnet.clear_network_cache()


@pytest.fixture(autouse=True)
def _clean_runtime():
    _reset()
    yield
    _reset()


def _pol(tmp_path, **kw):
    """A ladder policy pinning the tune cache (and so the quarantine store)
    inside the test's tmp dir."""
    kw.setdefault("on_failure", "degrade")
    return KernelPolicy(tune_cache=str(tmp_path / "tune.json"), **kw)


def _ir_spec():
    return chain.inverted_residual_spec(c_in=8, c_out=8, expand=2)


def _chain_data(spec):
    params = chain.init_chain(torch.Generator().manual_seed(0), spec, 8,
                              device="cpu")
    x = torch.randn((1, 8, 8, 8), generator=torch.Generator().manual_seed(1))
    return params, x


def _tiny_net():
    return network.NetworkSpec(name="tiny3", c_in=8, blocks=(
        chain.separable_block_spec(16),
        chain.inverted_residual_spec(16, 16, expand=2),
        chain.separable_block_spec(8, stride=2),
    ))


def _net_data(net):
    params = network.init_network(net, seed=0, device="cpu")
    x = torch.randn((1, 16, 16, 8), generator=torch.Generator().manual_seed(1))
    return params, x


def _oracle_chain(spec, params, x, pol):
    with faultinject.suppressed():
        return chain.execute(
            spec, params, x,
            policy=dataclasses.replace(pol, impl="torch", on_failure="raise",
                                       numeric_guard=False,
                                       dtype_policy=DtypePolicy())).float()


def _ban(pol, spec, shape, dtype, *bans):
    """Pre-seed the policy's quarantine store with bans for this problem."""
    qp = quarantine.quarantine_path(pol)
    q = quarantine.Quarantine.load(qp)
    key = autotune.problem_key(spec, shape, dtype, pol)
    for b in bans:
        q.add_failure(key, signature={}, ban=b,
                      failure={"kind": "test", "message": "seeded",
                               "injected": True})
    q.save()
    return key


def _rel(got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / (want.abs().max() + 1e-30))


# ---------------------------------------------------------------------------
# failures.classify: the whitelist taxonomy
# ---------------------------------------------------------------------------

def test_classify_whitelist():
    assert failures.classify(ValueError("same")) is None
    assert failures.classify(TypeError("x")) is None
    assert failures.classify(AssertionError("x")) is None
    # the reference wraps these; the port's whitelist does not
    assert failures.classify(RuntimeError("Mosaic lowering failed")) is None
    assert failures.classify(NotImplementedError("no rule")) is None
    assert failures.classify(MemoryError()) is None
    f = failures.classify(failures.InjectedFault("x",
                                                 point="lowering:pwconv"))
    assert isinstance(f, failures.LoweringFailure) and f.injected
    f = failures.classify(failures.InjectedFault("x",
                                                 point="compile:chain"))
    assert isinstance(f, failures.CompileFailure) and f.injected
    for code in (1, 9, 209):
        f = failures.classify(_build.KernelLaunchError(
            "pwconv kernel launch failed", kernel="pwconv", code=code))
        assert isinstance(f, failures.LoweringFailure) and not f.injected
    f = failures.classify(_build.KernelLaunchError("x", kernel="k", code=2))
    assert isinstance(f, failures.CompileFailure)
    f = failures.classify(torch.cuda.OutOfMemoryError("out of memory"))
    assert isinstance(f, failures.CompileFailure)


def test_classify_tags_and_passthrough():
    e = _build.KernelLaunchError("dw_se kernel launch failed: CUDA error 9",
                                 kernel="dw_se", code=9)
    f = failures.classify(e, segment_kind="fused3", segment_index=0,
                          stage_indices=(0, 1, 2))
    assert (f.segment_kind, f.segment_index, f.stage_indices) == \
        ("fused3", 0, (0, 1, 2))
    assert f.original is e
    # passthrough: an already-tagged failure keeps its tags
    g = failures.classify(f, segment_kind="pw", segment_index=9)
    assert g is f and g.segment_kind == "fused3"
    d = f.describe()
    assert d["kind"] == "lowering" and d["segment_kind"] == "fused3"
    assert d["original"] == "KernelLaunchError"


def test_tile_error_never_classified():
    """The port's counterpart of the reference's plan-verification error:
    a tile the kernel is not compiled for is a caller's bug (ValueError),
    never a degradable failure."""
    with pytest.raises(ValueError, match="unknown variant") as info:
        pwconv.pwconv(torch.randn(4, 8), torch.randn(8, 16), variant="wide")
    assert failures.classify(info.value) is None


def _nvcc_missing_error(monkeypatch, tmp_path):
    with monkeypatch.context() as m:
        m.delenv("CUDA_HOME", raising=False)
        m.delenv("CUDA_PATH", raising=False)
        m.setattr(_build.shutil, "which", lambda name: None)
        m.setattr(_build.os.path, "isfile", lambda path: False)
        with pytest.raises(RuntimeError, match="nvcc not found") as info:
            _build.nvcc()
    return info.value


def _build_error(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="nvcc failed") as info:
        _build.build(["pwconv"])
    return info.value


def _shape_mismatch_error(monkeypatch, tmp_path):
    with pytest.raises(RuntimeError) as info:
        torch.mm(torch.ones(2, 3), torch.ones(4, 5))
    return info.value


@pytest.mark.parametrize("make", (_shape_mismatch_error, _nvcc_missing_error,
                                  _build_error),
                         ids=("torch-shape-mismatch", "nvcc-not-found",
                              "build-failed"))
def test_classify_never_wraps_torch_or_build_errors(make, monkeypatch,
                                                    tmp_path):
    assert failures.classify(make(monkeypatch, tmp_path)) is None


@pytest.mark.parametrize("code", sorted(failures.STICKY_CODES))
def test_classify_never_wraps_a_sticky_code(code):
    e = _build.KernelLaunchError(f"k kernel launch failed: CUDA error {code}",
                                 kernel="k", code=code)
    assert failures.classify(e) is None
    assert failures.classify(e) is None  # the note is added once
    notes = [n for n in e.__notes__ if "CUDA context is lost" in n]
    assert len(notes) == 1


def test_code_table_is_disjoint_and_named():
    sets = (failures.LOWERING_CODES, failures.COMPILE_CODES,
            failures.STICKY_CODES)
    assert sum(map(len, sets)) == len(set().union(*sets))
    assert set().union(*sets) == set(failures.CUDA_ERRORS)
    assert all(n.startswith("cudaError") for n in failures.CUDA_ERRORS.values())


def test_launch_error_keeps_the_message():
    class Lib:
        @staticmethod
        def pwconv_error_string(code):
            return b"invalid configuration argument"
    with pytest.raises(_build.KernelLaunchError) as info:
        _build.check(Lib, "pwconv", 9)
    assert str(info.value) == ("pwconv kernel launch failed: CUDA error 9 "
                               "(invalid configuration argument)")
    assert info.value.code == 9 and info.value.kernel == "pwconv"
    assert isinstance(info.value, RuntimeError)


# ---------------------------------------------------------------------------
# faultinject: determinism, suppression, CLI spec parsing
# ---------------------------------------------------------------------------

def test_arm_unknown_point_raises():
    with pytest.raises(ValueError, match="unknown injection point"):
        faultinject.arm("lowering:nope")


def test_catalog_is_the_reference_catalog():
    assert set(faultinject.INJECTION_POINTS) == set(
        jfaultinject.INJECTION_POINTS)


def test_times_and_fired_counts():
    faultinject.arm("compile:chain", times=2)
    for _ in range(2):
        with pytest.raises(failures.InjectedFault):
            faultinject.check("compile:chain")
    faultinject.check("compile:chain")  # exhausted: no-op
    assert faultinject.fired_counts()["compile:chain"] == 2
    assert faultinject.armed_points() == ()


def test_suppressed_blocks_firing():
    faultinject.arm("compile:chain", times=faultinject.PERSISTENT)
    with faultinject.suppressed():
        faultinject.check("compile:chain")
    with pytest.raises(failures.InjectedFault):
        faultinject.check("compile:chain")


def test_arm_from_spec():
    pts = faultinject.arm_from_spec(
        "lowering:pwconv, compile:network:3 ,numeric:chain")
    assert pts == ("lowering:pwconv", "compile:network", "numeric:chain")
    assert faultinject._faults["compile:network"].times == 3
    assert faultinject._faults["lowering:pwconv"].times == \
        faultinject.PERSISTENT


def test_injected_context_disarms():
    with faultinject.injected("compile:chain"):
        assert "compile:chain" in faultinject.armed_points()
    assert faultinject.armed_points() == ()


def test_poison_copies_and_counts():
    y = torch.ones(2, 3)
    assert faultinject.poison("numeric:chain", y) is y  # disarmed
    faultinject.arm("numeric:chain", times=1)
    p = faultinject.poison("numeric:chain", y)
    assert p is not y and torch.isnan(p).sum() == 1 and torch.isfinite(y).all()
    assert faultinject.poison("numeric:chain", y) is y  # exhausted


# ---------------------------------------------------------------------------
# ladder semantics
# ---------------------------------------------------------------------------

def test_ladder_rung_mapping(tmp_path):
    pol = _pol(tmp_path)
    spec = _ir_spec()
    cp = chain.plan(spec, (1, 8, 8, 8), policy=pol)
    assert ladder.plan_rung(cp) == "fused3"
    f3 = failures.LoweringFailure("x", segment_kind="fused3")
    pw = failures.LoweringFailure("x", segment_kind="pw")
    untagged = failures.CompileFailure("x")
    assert ladder.ban_for_failure(f3) == "fused3"
    assert ladder.ban_for_failure(pw) == "unfused"
    assert ladder.ban_for_failure(untagged, cp) == "fused3"
    assert ladder.ban_for_failure(
        failures.LoweringFailure("x", segment_kind="fusedmb")) == "fusedmb"
    assert ladder.ban_for_failure(
        failures.LoweringFailure("x", segment_kind="dw_se")) == "dw_se"
    assert ladder.ban_for_failure(
        failures.LoweringFailure("x", segment_kind="se")) == "unfused"
    assert ladder.ban_for_failure(
        failures.LoweringFailure("x", segment_kind="mb")) == "unfused"
    assert ladder.next_rung("fused3", {"fused3"}) == "fusedmb"
    assert ladder.next_rung("fusedmb", {"fusedmb"}) == "fused2"
    assert ladder.next_rung("fused2", {"fused3", "fused2"}) == "dw_se"
    assert ladder.next_rung("dw_se", {"dw_se"}) == "unfused"
    assert ladder.next_rung("unfused", {"unfused"}) == "ref"


# ---------------------------------------------------------------------------
# the stores: warn-on-corrupt load, merge-on-write save, version gate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("store", (autotune.TuneCache, quarantine.Quarantine),
                         ids=("tune-cache", "quarantine"))
def test_corrupt_store_warns_and_recovers(tmp_path, store):
    path = str(tmp_path / "store.json")
    with open(path, "w") as f:
        f.write("{not json")
    with pytest.warns(UserWarning, match="could not read"):
        s = store.load(path)
    assert s.entries == {}
    s.put("k", {"v": 1})
    s.save()  # must not warn or raise: save re-reads with warn=False
    assert store.load(path).get("k") == {"v": 1}


def test_merge_on_write_preserves_concurrent_entries(tmp_path):
    path = str(tmp_path / "quarantine.json")
    a = quarantine.Quarantine.load(path)
    b = quarantine.Quarantine.load(path)
    a.add_failure("ka", signature={}, ban="fused3", failure={})
    a.save()
    b.add_failure("kb", signature={}, ban="unfused",
                  failure={"injected": True})
    b.save()  # must union with a's entry, not clobber the file
    c = quarantine.Quarantine.load(path)
    assert c.banned("ka") == {"fused3"} and c.banned("kb") == {"unfused"}


def test_version_gate_reads_other_version_as_empty(tmp_path):
    path = str(tmp_path / "store.json")

    class V9(VersionedJsonStore):
        version = 9

    s = V9(path)
    s.put("k", {"v": 1})
    s.save()
    assert quarantine.Quarantine.load(path).entries == {}
    assert V9.load(path).get("k") == {"v": 1}


def test_quarantine_store_roundtrip(tmp_path):
    path = str(tmp_path / "quarantine.json")
    q = quarantine.Quarantine.load(path)
    q.add_failure("k1", signature={"s": 1}, ban="fused3",
                  failure={"kind": "lowering"})
    q.add_failure("k1", signature={"s": 1}, ban="unfused",
                  failure={"kind": "compile", "injected": True})
    with pytest.raises(ValueError, match="cannot be banned"):
        q.add_failure("k1", signature={}, ban="ref", failure={})
    q.save()
    q2 = quarantine.Quarantine.load(path)
    assert q2.banned("k1") == frozenset({"fused3", "unfused"})
    assert q2.banned("missing") == frozenset()
    assert len(q2.entries["k1"]["failures"]) == 2


def test_quarantine_path_rules(tmp_path, monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_QUARANTINE", raising=False)
    assert quarantine.quarantine_path(KernelPolicy()) == str(
        _build.BUILD_DIR / "quarantine.json")
    monkeypatch.setenv("REPRO_TORCH_QUARANTINE", str(tmp_path / "q.json"))
    assert quarantine.quarantine_path(KernelPolicy()) == str(
        tmp_path / "q.json")
    pinned = KernelPolicy(tune_cache=str(tmp_path / "d" / "t.json"))
    assert quarantine.quarantine_path(pinned) == str(
        tmp_path / "d" / "quarantine.json")


# ---------------------------------------------------------------------------
# measure_run: one attempt, no retry
# ---------------------------------------------------------------------------

def test_measure_run_classified_failure_is_not_retried():
    """The reference retries a classified failure; the port does not: a
    refused launch is deterministic for a plan, so the candidate loses at
    its first attempt (folded by the tuner under ``"degrade"`` only)."""
    calls = []

    def run(p, x):
        calls.append(1)
        raise failures.InjectedFault("always", point="lowering:pwconv")

    with warnings.catch_warnings():
        warnings.simplefilter("error")  # no retry warning either
        with pytest.raises(failures.InjectedFault, match="always"):
            autotune.measure_run(run, None, torch.ones(4))
    assert len(calls) == 1


def test_measure_run_unrecognized_propagates_immediately():
    calls = []

    def run(p, x):
        calls.append(1)
        raise AssertionError("a genuine bug")

    with pytest.raises(AssertionError, match="genuine bug"):
        autotune.measure_run(run, None, torch.ones(4))
    assert len(calls) == 1


def test_measure_run_sticky_error_propagates_immediately(tmp_path,
                                                         monkeypatch):
    """Where the reference discards a straggler sample (the port times
    graph replays on the card), the port's case is the sticky code: the
    context is gone, so it propagates at once, and even under
    ``"degrade"`` the tuner raises it, noting that the context is lost,
    instead of folding it into an infinite time."""
    calls = []

    def run(p, x):
        calls.append(1)
        raise _build.KernelLaunchError("illegal address", kernel="k",
                                       code=700)

    with pytest.raises(_build.KernelLaunchError):
        autotune.measure_run(run, None, torch.ones(4))
    assert len(calls) == 1
    spec = chain.SeparableSpec((chain.PW(16),))
    params, x = _chain_data(spec)
    pol = _pol(tmp_path, autotune=True)
    base = chain.plan(spec, x.shape,
                      policy=dataclasses.replace(pol, autotune=False))
    monkeypatch.setattr(autotune, "measure_run",
                        lambda r, p, xx, **kw: run(p, xx))
    with pytest.raises(_build.KernelLaunchError) as info:
        autotune.autotune_chain(spec, params, x, policy=pol, base_plan=base)
    assert len(calls) == 2
    assert any("context is lost" in n for n in info.value.__notes__)
    assert not os.path.exists(pol.tune_cache)


# ---------------------------------------------------------------------------
# autotune_chain: failed candidates folded, all-fail unpersisted
# ---------------------------------------------------------------------------

def test_autotune_folds_failed_candidate(tmp_path, monkeypatch):
    spec = chain.SeparableSpec((chain.PW(16),))
    params, x = _chain_data(spec)
    pol = _pol(tmp_path, autotune=True)
    base = chain.plan(spec, x.shape,
                      policy=dataclasses.replace(pol, autotune=False))
    calls = {"n": 0}

    def fake_measure(run, p, xx, **kw):
        calls["n"] += 1
        if calls["n"] == 2:  # the first non-base candidate dies
            raise torch.cuda.OutOfMemoryError("candidate died")
        return 1.0

    monkeypatch.setattr(autotune, "measure_run", fake_measure)
    r = autotune.autotune_chain(spec, params, x, policy=pol, base_plan=base)
    assert not r.cache_hit and r.plan == base
    assert calls["n"] >= 2 and r.n_measured == calls["n"]
    entry = autotune.TuneCache.load(pol.tune_cache).get(r.key)
    assert entry is not None
    fc = entry["failed"]
    assert len(fc) == 1 and "candidate died" in fc[0]["error"]
    assert list(r.failed) == fc


def test_autotune_all_fail_returns_base_unpersisted(tmp_path, monkeypatch):
    spec = chain.SeparableSpec((chain.PW(16),))
    params, x = _chain_data(spec)
    pol = _pol(tmp_path, autotune=True)
    base = chain.plan(spec, x.shape,
                      policy=dataclasses.replace(pol, autotune=False))

    def fake_measure(run, p, xx, **kw):
        raise torch.cuda.OutOfMemoryError("the device is full")

    monkeypatch.setattr(autotune, "measure_run", fake_measure)
    with pytest.warns(UserWarning, match="every candidate failed"):
        r = autotune.autotune_chain(spec, params, x, policy=pol,
                                    base_plan=base)
    assert r.plan == base and r.measured_us == float("inf")
    assert autotune.TuneCache.load(pol.tune_cache).get(r.key) is None


@pytest.mark.parametrize("error", (
    lambda: torch.cuda.OutOfMemoryError("candidate died"),
    lambda: _build.KernelLaunchError("pwconv kernel launch failed: CUDA "
                                     "error 9", kernel="pwconv", code=9),
    lambda: failures.InjectedFault("candidate died",
                                   point="lowering:pwconv")),
    ids=("out-of-memory", "refused-launch", "injected"))
def test_default_policy_raises_a_classified_candidate_failure(
        tmp_path, monkeypatch, error):
    """Under the default ``on_failure="raise"`` the tuner folds nothing:
    a candidate failure the whitelist recognizes raises, as any other,
    and no cache is written."""
    spec = chain.SeparableSpec((chain.PW(16),))
    params, x = _chain_data(spec)
    pol = _pol(tmp_path, autotune=True, on_failure="raise")
    base = chain.plan(spec, x.shape,
                      policy=dataclasses.replace(pol, autotune=False))
    calls = {"n": 0}

    def fake_measure(run, p, xx, **kw):
        calls["n"] += 1
        if calls["n"] == 2:  # the first non-base candidate dies
            raise error()
        return 1.0

    monkeypatch.setattr(autotune, "measure_run", fake_measure)
    with pytest.raises(Exception) as info:
        autotune.autotune_chain(spec, params, x, policy=pol, base_plan=base)
    assert failures.classify(info.value) is not None
    assert any("nothing was written" in n for n in info.value.__notes__)
    assert calls["n"] == 2
    assert not os.path.exists(pol.tune_cache)
    assert not os.path.exists(quarantine.quarantine_path(pol))


def test_lookup_cached_plan_drops_quarantined_winner(tmp_path):
    spec = _ir_spec()
    shape = (1, 8, 8, 8)
    pol = _pol(tmp_path, autotune=True)
    base = chain.plan(spec, shape,
                      policy=dataclasses.replace(pol, autotune=False,
                                                 on_failure="raise"))
    key = autotune.problem_key(spec, shape, torch.float32, pol)
    cache = autotune.TuneCache.load(pol.tune_cache)
    cache.put(key, {"signature": {}, "plan":
                    autotune.serialize_chain_plan(base),
                    "measured_us": 1.0, "analytic_us": 1.0})
    cache.save()
    assert autotune.lookup_cached_plan(spec, shape, torch.float32, pol,
                                       base_plan=base) is not None
    _ban(pol, spec, shape, torch.float32, "fused3")
    with pytest.warns(UserWarning, match="quarantined rungs"):
        assert autotune.lookup_cached_plan(spec, shape, torch.float32, pol,
                                           base_plan=base) is None
    # raise-mode callers (the port's default) keep the tuned winner
    assert autotune.lookup_cached_plan(
        spec, shape, torch.float32,
        dataclasses.replace(pol, on_failure="raise"),
        base_plan=base) is not None


def test_network_entry_with_a_quarantined_rung_is_dropped(tmp_path):
    net = _tiny_net()
    params, x = _net_data(net)
    pol = _pol(tmp_path, autotune=True)
    r = network.tune_network(net, params, x, policy=pol, repeats=1)
    assert not r.cache_hit and r.failed == ()
    entry = autotune.TuneCache.load(pol.tune_cache).get(r.key)
    assert entry["failed"] == []
    assert [s.kind for s in r.plan.plans[1].segments] == ["fused3"]
    policies = network.resolve_block_policies(net, pol)
    problems, _ = network._block_problems(net, x.shape, x.dtype, policies)
    _ban(policies[1], net.blocks[1], problems[1][0], torch.float32, "fused3")
    raise_pol = dataclasses.replace(pol, on_failure="raise")
    assert network.plan_network(net, x.shape, policy=raise_pol) == r.plan
    with pytest.warns(UserWarning, match=r"blocks \[1\] use quarantined"):
        nplan = network.plan_network(net, x.shape, policy=pol)
    assert "fused3" not in {s.kind for s in nplan.plans[1].segments}


# ---------------------------------------------------------------------------
# plan(): the quarantine steers the analytic walk
# ---------------------------------------------------------------------------

def test_plan_consults_quarantine(tmp_path):
    spec = _ir_spec()
    shape = (1, 8, 8, 8)
    pol = _pol(tmp_path)
    assert [s.kind for s in chain.plan(spec, shape, policy=pol).segments] \
        == ["fused3"]
    _ban(pol, spec, shape, torch.float32, "fused3")
    kinds = [s.kind for s in chain.plan(spec, shape, policy=pol).segments]
    assert "fused3" not in kinds and "fused2" in kinds
    # raise-mode planning is quarantine-blind (the ladder opt-out)
    kinds = [s.kind for s in chain.plan(
        spec, shape,
        policy=dataclasses.replace(pol, on_failure="raise")).segments]
    assert kinds == ["fused3"]
    assert telemetry.runtime_report()["quarantine_hits"] > 0


# ---------------------------------------------------------------------------
# the ladder matrix: every rung x {fp32, bf16} x {chain, network}
# ---------------------------------------------------------------------------

#: (case name, points to arm {point: times}, rung the recovery lands on)
_MATRIX = [
    ("fused-transient", {"lowering:separable_fused": 1}, "fused2"),
    ("fused-persistent",
     {"lowering:separable_fused": faultinject.PERSISTENT}, "unfused"),
    ("all-lowering",
     {p: faultinject.PERSISTENT for p in
      ("lowering:separable_fused", "lowering:pwconv",
       "lowering:dwconv2d")}, "ref"),
    ("compile-transient", {"compile:chain": 1}, None),
]


@pytest.mark.parametrize("dname", ["fp32", "bf16"])
@pytest.mark.parametrize("case,points,_rung",
                         _MATRIX, ids=[c[0] for c in _MATRIX])
def test_ladder_matrix_chain(tmp_path, case, points, _rung, dname):
    spec = _ir_spec()
    params, x = _chain_data(spec)
    dp = DtypePolicy(stream="bfloat16") if dname == "bf16" else DtypePolicy()
    pol = _pol(tmp_path, dtype_policy=dp, numeric_guard=True)
    oracle = _oracle_chain(spec, params, x, pol)
    for p, t in points.items():
        faultinject.arm(p, times=t)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        y = chain.execute(spec, params, x, policy=pol)
    if dname == "fp32" and case == "all-lowering":
        # every rung failed -> the plain rung IS the oracle: bitwise
        assert torch.equal(y.float(), oracle)
    else:
        tol = BF16_REL_TOL if dname == "bf16" else 1e-5
        assert _rel(y, oracle) < tol, (case, dname)
    rep = telemetry.runtime_report()
    assert rep["fallbacks"] > 0
    assert rep["fallbacks"] == rep["injected_fallbacks"]
    assert rep["fallbacks"] == sum(faultinject.fired_counts().values())
    assert rep["recoveries"] >= 1
    if _rung is not None:
        rungs = [e["rung"] for e in rep["events"] if e["event"] == "recovery"]
        assert rungs[-1] == _rung


@pytest.mark.parametrize("dname", ["fp32", "bf16"])
@pytest.mark.parametrize("case,points,_rung",
                         _MATRIX, ids=[c[0] for c in _MATRIX])
def test_ladder_matrix_network(tmp_path, case, points, _rung, dname):
    net = _tiny_net()
    params, x = _net_data(net)
    dp = DtypePolicy(stream="bfloat16") if dname == "bf16" else DtypePolicy()
    pol = _pol(tmp_path, dtype_policy=dp, numeric_guard=True)
    if case == "compile-transient":
        points = {"compile:network": 1}
    with faultinject.suppressed():
        oracle = x
        for spec, p in zip(net.blocks, params):
            oracle = chain.execute(
                spec, p, oracle,
                policy=dataclasses.replace(pol, on_failure="raise",
                                           numeric_guard=False,
                                           dtype_policy=DtypePolicy()))
    for p, t in points.items():
        faultinject.arm(p, times=t)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        y = network.execute_network(net, params, x, policy=pol)
    if dname == "fp32" and case == "all-lowering":
        assert torch.equal(y.float(), oracle)
    else:
        tol = BF16_REL_TOL if dname == "bf16" else 1e-5
        assert _rel(y, oracle) < tol, (case, dname)
    rep = telemetry.runtime_report()
    assert rep["fallbacks"] > 0
    assert rep["fallbacks"] == rep["injected_fallbacks"]
    assert rep["fallbacks"] == sum(faultinject.fired_counts().values())
    assert not network._NETWORK_CACHE  # a recovery is never memoized


# ---------------------------------------------------------------------------
# on_failure="raise" (the port's default): the taxonomy error propagates
# ---------------------------------------------------------------------------

def test_raise_mode_propagates_tagged_failure(tmp_path):
    spec = _ir_spec()
    params, x = _chain_data(spec)
    pol = KernelPolicy(tune_cache=str(tmp_path / "tune.json"))
    assert pol.on_failure == "raise" and KernelPolicy().on_failure == "raise"
    faultinject.arm("lowering:separable_fused", times=1)
    with pytest.raises(failures.LoweringFailure) as ei:
        chain.execute(spec, params, x, policy=pol)
    e = ei.value
    assert e.segment_kind == "fused3" and e.injected
    assert isinstance(e.original, failures.InjectedFault)
    assert telemetry.fallback_count() == 0  # no ladder in raise mode
    assert not os.path.exists(quarantine.quarantine_path(pol))


def test_on_failure_is_validated():
    with pytest.raises(ValueError, match="on_failure"):
        KernelPolicy(on_failure="ignore")


def test_numeric_guard_raise_mode(tmp_path):
    spec = _ir_spec()
    params, x = _chain_data(spec)
    pol = _pol(tmp_path, on_failure="raise", numeric_guard=True)
    faultinject.arm("numeric:chain", times=1)
    with pytest.raises(failures.NumericalFailure, match="non-finite"):
        chain.execute(spec, params, x, policy=pol)


def test_numeric_guard_degrade_recovers(tmp_path):
    spec = _ir_spec()
    params, x = _chain_data(spec)
    pol = _pol(tmp_path, numeric_guard=True)
    oracle = _oracle_chain(spec, params, x, pol)
    faultinject.arm("numeric:chain", times=1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        y = chain.execute(spec, params, x, policy=pol)
    assert torch.isfinite(y).all()
    assert _rel(y, oracle) < 1e-5
    rep = telemetry.runtime_report()
    assert rep["numeric_trips"] == 1 and rep["fallbacks"] == 1
    assert rep["injected_fallbacks"] == 1  # the poison is marked injected


# ---------------------------------------------------------------------------
# quarantine: pre-seeded bans honoured with zero retries
# ---------------------------------------------------------------------------

def test_unfused_ban_executes_ref_with_zero_fallbacks(tmp_path):
    spec = _ir_spec()
    params, x = _chain_data(spec)
    pol = _pol(tmp_path)
    oracle = _oracle_chain(spec, params, x, pol)
    _ban(pol, spec, x.shape, x.dtype, "unfused")
    faultinject.arm("lowering:separable_fused", times=faultinject.PERSISTENT)
    y = chain.execute(spec, params, x, policy=pol)  # suppressed: no fire
    assert torch.equal(y.float(), oracle)
    rep = telemetry.runtime_report()
    assert rep["fallbacks"] == 0 and rep["quarantine_hits"] > 0
    assert faultinject.fired_counts()["lowering:separable_fused"] == 0


def test_supplied_banned_plan_ignored_with_warning(tmp_path):
    spec = _ir_spec()
    params, x = _chain_data(spec)
    pol = _pol(tmp_path)
    cp_fused = chain.plan(spec, x.shape,
                          policy=dataclasses.replace(pol,
                                                     on_failure="raise"))
    assert ladder.plan_rung(cp_fused) == "fused3"
    oracle = _oracle_chain(spec, params, x, pol)
    _ban(pol, spec, x.shape, x.dtype, "fused3")
    with pytest.warns(RuntimeWarning, match="ignoring supplied chain_plan"):
        y = chain.execute(spec, params, x, policy=pol, chain_plan=cp_fused)
    assert _rel(y, oracle) < 1e-5
    assert telemetry.fallback_count() == 0


def test_quarantine_survives_into_fresh_process(tmp_path):
    spec = _ir_spec()
    params, x = _chain_data(spec)
    pol = _pol(tmp_path)
    faultinject.arm("lowering:separable_fused", times=1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        chain.execute(spec, params, x, policy=pol)
    assert telemetry.fallback_count() == 1
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = f"""
import sys
sys.path.insert(0, {os.path.join(root, "src")!r})
import torch
from repro_torch.core import chain
from repro_torch.kernels.policy import KernelPolicy
from repro_torch.runtime import telemetry
spec = chain.inverted_residual_spec(c_in=8, c_out=8, expand=2)
params = chain.init_chain(torch.Generator().manual_seed(0), spec, 8,
                          device="cpu")
x = torch.randn((1, 8, 8, 8), generator=torch.Generator().manual_seed(1))
pol = KernelPolicy(tune_cache={pol.tune_cache!r}, on_failure="degrade")
y = chain.execute(spec, params, x, policy=pol)
rep = telemetry.runtime_report()
assert rep["fallbacks"] == 0, rep       # zero retries in the new process
assert rep["quarantine_hits"] > 0, rep  # ...because the ban was honoured
cp = chain.plan(spec, x.shape, policy=pol)
assert all(s.kind != "fused3" for s in cp.segments), cp
blind = chain.plan(spec, x.shape, policy=KernelPolicy(tune_cache=pol.tune_cache))
assert [s.kind for s in blind.segments] == ["fused3"], blind
print("CHILD_OK")
"""
    r = subprocess.run([sys.executable, "-c", script],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "CHILD_OK" in r.stdout


# ---------------------------------------------------------------------------
# network engine integration
# ---------------------------------------------------------------------------

def test_network_steady_state_after_transient_fault(tmp_path):
    net = _tiny_net()
    params, x = _net_data(net)
    pol = _pol(tmp_path)
    faultinject.arm("lowering:separable_fused", times=1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        y1 = network.execute_network(net, params, x, policy=pol)
    assert telemetry.fallback_count() == 1
    assert not network._NETWORK_CACHE
    faultinject.disarm_all()
    telemetry.reset_runtime_telemetry()
    # the failed plan was NOT memoized: this call re-plans and runs clean
    y2 = network.execute_network(net, params, x, policy=pol)
    assert telemetry.fallback_count() == 0
    assert torch.equal(y1, y2)
    assert len(network._NETWORK_CACHE) == 1
    # and now it IS memoized: a third call records nothing
    network.execute_network(net, params, x, policy=pol)
    assert telemetry.fallback_count() == 0


def test_network_unfused_ban_forces_plain_block(tmp_path):
    net = _tiny_net()
    params, x = _net_data(net)
    pol = _pol(tmp_path)
    with faultinject.suppressed():
        oracle = x
        for spec, p in zip(net.blocks, params):
            oracle = chain.execute(
                spec, p, oracle,
                policy=dataclasses.replace(pol, on_failure="raise"))
    policies = network.resolve_block_policies(net, pol, None)
    problems, _ = network._block_problems(net, x.shape, x.dtype, policies)
    (shape1, dt1) = problems[1]
    _ban(policies[1], net.blocks[1], shape1, getattr(torch, dt1),
         "fused3", "unfused")
    nplan = network.plan_network(net, x.shape, policy=pol)
    assert network.plain_blocks(net, nplan, pol) == (False, True, False)
    assert network.plain_blocks(
        net, nplan, dataclasses.replace(pol, on_failure="raise")) == \
        (False, False, False)
    # the plain block runs with injection suppressed: no fire, no fallback
    faultinject.arm("lowering:pwconv", times=faultinject.PERSISTENT)
    y = network.execute_network(net, params, x, policy=pol)
    assert _rel(y, oracle) < 1e-5
    assert telemetry.fallback_count() == 0
    assert faultinject.fired_counts()["lowering:pwconv"] == 0


def test_numeric_network_guard_drops_the_memo(tmp_path):
    net = _tiny_net()
    params, x = _net_data(net)
    pol = _pol(tmp_path, on_failure="degrade", numeric_guard=True)
    faultinject.arm("numeric:network", times=1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        y = network.execute_network(net, params, x, policy=pol)
    assert torch.isfinite(y).all()
    rep = telemetry.runtime_report()
    assert rep["numeric_trips"] == rep["injected_fallbacks"] == 1
    assert not network._NETWORK_CACHE
    assert not os.path.exists(quarantine.quarantine_path(pol))


# ---------------------------------------------------------------------------
# C3: the network memo is written only after a first call succeeded
# ---------------------------------------------------------------------------

def test_failed_first_call_is_not_memoized_under_raise():
    net = _tiny_net()
    params, x = _net_data(net)
    faultinject.arm("compile:network", times=1)
    with pytest.raises(failures.InjectedFault):
        network.execute_network(net, params, x)
    assert not network._NETWORK_CACHE
    y = network.execute_network(net, params, x)
    assert torch.isfinite(y).all() and len(network._NETWORK_CACHE) == 1


def test_next_call_replans_after_a_failure_under_degrade(tmp_path,
                                                         monkeypatch):
    net = _tiny_net()
    params, x = _net_data(net)
    pol = _pol(tmp_path)
    calls = []
    real = network.plan_network
    monkeypatch.setattr(network, "plan_network",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    faultinject.arm("compile:network", times=1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        y1 = network.execute_network(net, params, x, policy=pol)
    assert len(calls) == 1 and not network._NETWORK_CACHE
    y2 = network.execute_network(net, params, x, policy=pol)
    assert len(calls) == 2 and len(network._NETWORK_CACHE) == 1
    network.execute_network(net, params, x, policy=pol)
    assert len(calls) == 2
    assert torch.equal(y1, y2)


# ---------------------------------------------------------------------------
# the default policy never reads the quarantine
# ---------------------------------------------------------------------------

def test_default_policy_never_reads_the_quarantine(tmp_path, monkeypatch):
    net = network.mnasnet_a1_spec(0.5)
    params = network.init_network(net, seed=0, device="cpu")
    x = torch.randn((1, 32, 32, net.c_in))
    monkeypatch.setenv("REPRO_TORCH_QUARANTINE",
                       str(tmp_path / "quarantine.json"))
    default, degrade = KernelPolicy(), KernelPolicy(on_failure="degrade")
    before = network.plan_network(net, x.shape, policy=default)
    y0 = network.execute_network(net, params, x)
    network.clear_network_cache()
    # a file banning every rung of every block
    q = quarantine.Quarantine.load(quarantine.quarantine_path(default))
    for spec, pol, (shape, dt) in zip(
            net.blocks, network.resolve_block_policies(net, default),
            network._block_problems(
                net, x.shape, x.dtype,
                network.resolve_block_policies(net, default))[0]):
        key = autotune.problem_key(spec, shape, getattr(torch, dt), pol)
        for b in quarantine.BANNABLE:
            q.add_failure(key, signature={}, ban=b,
                          failure={"injected": True})
    q.save()
    quarantine.clear_memo()
    # the same file does steer a degrade plan ...
    banned = network.plan_network(net, x.shape, policy=degrade)
    assert banned.segment_histogram() != before.segment_histogram()
    assert all(network.plain_blocks(net, banned, degrade))
    # ... while the default policy never opens it
    def refuse(*a, **k):
        raise AssertionError("the default policy read the quarantine")
    monkeypatch.setattr(quarantine, "load", refuse)
    monkeypatch.setattr(quarantine.Quarantine, "load", refuse)
    hits = telemetry.runtime_report()["quarantine_hits"]
    assert network.plan_network(net, x.shape, policy=default) == before
    assert torch.equal(network.execute_network(net, params, x), y0)
    assert telemetry.runtime_report()["quarantine_hits"] == hits


# ---------------------------------------------------------------------------
# real failures: kernel rungs only, never the plain version
# ---------------------------------------------------------------------------

def _refused(*a, **k):
    """A segment whose kernel the driver refuses (on the CPU the lowering
    runs the plain versions, so the refusal is raised in their place)."""
    raise _build.KernelLaunchError("kernel launch failed: CUDA error 9 "
                                   "(invalid configuration argument)",
                                   kernel="k", code=9)


def test_real_failure_of_a_standalone_kernel_raises_under_degrade(
        tmp_path, monkeypatch):
    """A refused ``pwconv`` launch in an unfused chain and network: no
    kernel rung is left, so the LoweringFailure raises, nothing is
    quarantined and nothing runs plain."""
    monkeypatch.setattr(lowering, "_run_pw", _refused)
    pol = _pol(tmp_path, fused=False)
    spec = _ir_spec()
    params, x = _chain_data(spec)
    with pytest.raises(failures.LoweringFailure) as info:
        chain.execute(spec, params, x, policy=pol)
    assert info.value.segment_kind == "pw" and not info.value.injected
    assert any("no kernel rung is left" in n for n in info.value.__notes__)
    net = _tiny_net()
    params, x = _net_data(net)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        with pytest.raises(failures.LoweringFailure):
            network.execute_network(net, params, x, policy=pol)
    assert not network._NETWORK_CACHE
    assert not os.path.exists(quarantine.quarantine_path(pol))
    assert telemetry.runtime_report()["recoveries"] == 0


def test_real_fused_failure_degrades_to_the_standalone_kernels(
        tmp_path, monkeypatch):
    """A refused fused launch bans the fused rungs it reaches and recovers
    on the standalone kernels: a kernel rung, never the plain one."""
    pol = _pol(tmp_path)
    spec = _ir_spec()
    params, x = _chain_data(spec)
    oracle = _oracle_chain(spec, params, x, pol)
    monkeypatch.setattr(lowering, "_run_fused", _refused)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        y = chain.execute(spec, params, x, policy=pol)
    assert _rel(y, oracle) < 1e-5
    rep = telemetry.runtime_report()
    assert rep["fallbacks"] == 2 and rep["injected_fallbacks"] == 0
    rungs = [e["rung"] for e in rep["events"] if e["event"] == "recovery"]
    assert rungs == ["unfused"]
    q = quarantine.Quarantine.load(quarantine.quarantine_path(pol))
    assert q.banned(autotune.problem_key(spec, x.shape, x.dtype, pol)) == \
        {"fused3", "fused2"}


@pytest.mark.parametrize("scope", ("chain", "network"))
def test_non_finite_input_quarantines_nothing(tmp_path, scope):
    """A numeric-guard trip whose input was already non-finite blames no
    kernel: it raises, no ban is written and the memo is kept."""
    pol = _pol(tmp_path, numeric_guard=True)
    if scope == "chain":
        spec = _ir_spec()
        params, x = _chain_data(spec)
        run = lambda xx: chain.execute(spec, params, xx, policy=pol)  # noqa
    else:
        net = _tiny_net()
        params, x = _net_data(net)
        run = lambda xx: network.execute_network(net, params, xx,  # noqa
                                                 policy=pol)
    x[0, 0, 0, 0] = float("nan")
    with pytest.raises(failures.NumericalFailure) as info:
        run(x)
    assert any("input was already non-finite" in n
               for n in info.value.__notes__)
    assert not os.path.exists(quarantine.quarantine_path(pol))
    assert telemetry.fallback_count() == 0
    x[0, 0, 0, 0] = 0.0
    assert torch.isfinite(run(x)).all()


def test_fault_inject_cli_leaves_the_default_store_untouched(
        tmp_path, monkeypatch, capsys):
    """``--fault-inject`` without ``--tune-cache`` keeps its injected bans
    in a quarantine of its own, gone at exit."""
    from repro_torch import mobilenet_inference
    default = tmp_path / "default" / "quarantine.json"
    monkeypatch.setenv("REPRO_TORCH_QUARANTINE", str(default))
    assert mobilenet_inference.main(
        ["--arch", "v1", "--res", "16", "--batch", "1", "--device", "cpu",
         "--unfused", "--fault-inject", "lowering:pwconv:1"]) == 0
    out = capsys.readouterr().out
    assert "(removed at exit)" in out and "1 injected" in out
    assert not default.exists()
    assert not [p for p in _build.BUILD_DIR.glob("fault_inject_*")]


# ---------------------------------------------------------------------------
# parity with the JAX package's ladder on the same faults and weights
# ---------------------------------------------------------------------------

def _scale(name, shape):
    if name in ("w", "w1", "w2"):
        return shape[0] ** -0.5
    if name == "f":
        return float(np.prod(shape[:-1])) ** -0.5 if len(shape) == 4 else 1 / 3
    return 0.1


def _numpy_params(jspec, seed=0):
    """The reference's parameter structure filled with seeded draws, the
    biases nonzero."""
    rng = np.random.default_rng(seed)
    return [[{k: rand(rng, v.shape, _scale(k, v.shape)) for k, v in st.items()}
             for st in block]
            for block in jnet.init_network(jax.random.PRNGKey(seed), jspec)]


#: The reference names the whole-network rung after its one jitted call,
#: the port after its one CUDA graph.
_RUNG_NAMES = {"network-jit": "network-graph"}


def _fallbacks(events):
    return [(e["failure_kind"], _RUNG_NAMES.get(e["from_rung"],
                                                e["from_rung"]),
             e["to_rung"], e["injected"])
            for e in events if e["event"] == "fallback"]


def _block_bans(qmod, net, problems, policies, dtype_of):
    return [sorted(qmod.banned_kinds(spec, shape, dtype_of(dt), pol))
            for spec, (shape, dt), pol in zip(net.blocks, problems,
                                              policies)]


@pytest.mark.parametrize("arch,fused,point", (
    ("v1", None, "lowering:separable_fused"),
    ("v1", False, "lowering:pwconv"),
    ("v1", False, "lowering:dwconv2d"),
    ("v2", None, "lowering:separable_fused"),
    ("mnasnet", None, "lowering:se_epilogue"),
    ("lite0", None, "lowering:fused_mbconv"),
), ids=lambda v: str(v))
def test_ladder_parity_with_reference(tmp_path, arch, fused, point):
    jspec = getattr(jnet, SPECS[arch])(0.5)
    spec = getattr(network, SPECS[arch])(0.5)
    np_params = _numpy_params(jspec)
    x = rand(np.random.default_rng(1), (2, 32, 32, spec.c_in))
    jparams = [[{k: to_jax(v) for k, v in st.items()} for st in b]
               for b in np_params]
    params = convert.params_from_numpy(np_params, "cpu")
    jpol = JKernelPolicy(impl="xla", fused=fused, on_failure="degrade",
                         tune_cache=str(tmp_path / "ref" / "tune.json"))
    pol = KernelPolicy(fused=fused, on_failure="degrade",
                       tune_cache=str(tmp_path / "port" / "tune.json"))
    jfaultinject.arm(point, times=jfaultinject.PERSISTENT)
    faultinject.arm(point, times=faultinject.PERSISTENT)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        want1 = jnet.execute_network(jspec, jparams, to_jax(x), policy=jpol)
        got1 = network.execute_network(spec, params, torch.from_numpy(x),
                                       policy=pol)
    jrep, rep = jtelemetry.runtime_report(), telemetry.runtime_report()
    assert rep["fallbacks"] > 0
    assert _fallbacks(rep["events"]) == _fallbacks(jrep["events"])
    assert rep["recoveries"] == jrep["recoveries"]
    assert faultinject.fired_counts() == jfaultinject.fired_counts()
    assert rel_err(got1, want1) <= FP32_TOL
    # the same rungs banned for every block's problem
    jpolicies = jnet.resolve_block_policies(jspec, jpol, None)
    policies = network.resolve_block_policies(spec, pol, None)
    jproblems, _ = jnet._block_problems(jspec, x.shape, jnp.float32,
                                        jpolicies)
    problems, _ = network._block_problems(spec, x.shape, torch.float32,
                                          policies)
    bans = _block_bans(quarantine, spec, problems, policies,
                       lambda dt: getattr(torch, dt))
    assert any(bans)
    assert bans == _block_bans(jquarantine, jspec, jproblems, jpolicies,
                               jnp.dtype)
    # the next call re-plans around the bans to the same segment kinds
    jplan = jnet.plan_network(jspec, x.shape, policy=jpol)
    nplan = network.plan_network(spec, x.shape, policy=pol)
    assert [[s.kind for s in p.segments] for p in nplan.plans] == \
        [[s.kind for s in p.segments] for p in jplan.plans]
    assert network.plain_blocks(spec, nplan, pol) == tuple(
        "unfused" in b for b in bans)
    jtelemetry.reset_runtime_telemetry()
    telemetry.reset_runtime_telemetry()
    # the port's point stays armed: its plain rung runs with injection
    # suppressed inside the network's runner.  The reference's jitted
    # network does not suppress it there (an armed point would fail the
    # call again and recover block by block), so its point is disarmed.
    jfaultinject.disarm_all()
    want2 = jnet.execute_network(jspec, jparams, to_jax(x), policy=jpol)
    got2 = network.execute_network(spec, params, torch.from_numpy(x),
                                   policy=pol)
    assert telemetry.fallback_count() == jtelemetry.fallback_count() == 0
    assert rel_err(got2, want2) <= FP32_TOL
    assert rel_err(got2, got1) <= FP32_TOL


def test_chain_fault_parity_with_reference(tmp_path):
    """The counterpart of the reference's interpret-mode chain case: one
    transient fused fault on an inverted residual in both packages, the
    same fallback, the same ban, outputs within the fp32 tolerance."""
    from repro.core import chain as jchain
    jspec = jchain.inverted_residual_spec(c_in=8, c_out=8, expand=2)
    spec = _ir_spec()
    rng = np.random.default_rng(3)
    np_params = [{k: rand(rng, v.shape, _scale(k, v.shape))
                  for k, v in st.items()}
                 for st in jchain.init_chain(jax.random.PRNGKey(0), jspec, 8)]
    x = rand(rng, (1, 8, 8, 8))
    jpol = JKernelPolicy(impl="xla", tune_cache=str(tmp_path / "r" / "t.json"))
    pol = _pol(tmp_path / "p")
    for fi in (faultinject, jfaultinject):
        fi.arm("lowering:separable_fused", times=1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        want = jchain.execute(jspec, [{k: to_jax(v) for k, v in st.items()}
                                      for st in np_params], to_jax(x),
                              policy=jpol)
        got = chain.execute(spec, [{k: torch.from_numpy(v)
                                    for k, v in st.items()}
                                   for st in np_params],
                            torch.from_numpy(x), policy=pol)
    assert rel_err(got, want) <= FP32_TOL
    assert _fallbacks(telemetry.runtime_report()["events"]) == _fallbacks(
        jtelemetry.runtime_report()["events"]) == [
            ("lowering", "fused3", "fusedmb", True)]


def test_executor_is_the_routed_path(tmp_path, monkeypatch):
    """``execute`` and ``execute_network`` route through the executor under
    ``"degrade"`` or the numeric guard, and never under the default."""
    spec = _ir_spec()
    params, x = _chain_data(spec)
    net = _tiny_net()
    nparams, nx = _net_data(net)
    seen = []
    real_chain, real_net = executor.execute_chain, executor.run_network
    monkeypatch.setattr(executor, "execute_chain",
                        lambda *a, **k: seen.append("chain")
                        or real_chain(*a, **k))
    monkeypatch.setattr(executor, "run_network",
                        lambda *a, **k: seen.append("net")
                        or real_net(*a, **k))
    chain.execute(spec, params, x)
    network.execute_network(net, nparams, nx)
    assert seen == []
    chain.execute(spec, params, x, policy=_pol(tmp_path))
    chain.execute(spec, params, x,
                  policy=KernelPolicy(numeric_guard=True))
    network.execute_network(net, nparams, nx, policy=_pol(tmp_path))
    assert seen == ["chain", "chain", "net"]


def test_record_abandons_a_failed_capture(monkeypatch):
    """``graphs.record`` (every capture of the port goes through it): where
    the captured function raises, ending the capture fails too (on the card:
    "capture invalidated"); the function's own error propagates, carrying
    the other as a note, and the stream that was current is restored."""
    import contextlib
    from repro_torch import graphs
    prev, restored = object(), []

    class Ctx:
        def __enter__(self):
            return None

        def __exit__(self, *exc):
            if exc[0] is not None:
                raise RuntimeError("operation not permitted when stream is "
                                   "capturing: capture invalidated")

    class Graph:
        def pool(self):
            return (0, 1)

    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None:
                        prev)
    monkeypatch.setattr(torch.cuda, "graph", lambda g: Ctx())
    monkeypatch.setattr(torch.cuda, "set_stream", restored.append)
    dev = torch.device("cuda", 0)

    def launch():
        raise _build.KernelLaunchError("pwconv kernel launch failed: CUDA "
                                       "error 9", kernel="pwconv", code=9)
    with pytest.raises(_build.KernelLaunchError) as info:
        graphs.record(Graph(), launch, dev)
    assert any("capture was abandoned" in n for n in info.value.__notes__)
    assert restored == [prev]
    assert isinstance(failures.classify(info.value), failures.LoweringFailure)
    # a capture that ends cleanly returns what the function returned
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda g: contextlib.nullcontext())
    assert graphs.record(Graph(), lambda: "out", dev) == "out"
    assert restored == [prev]
