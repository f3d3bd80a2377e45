"""The port's static verifier (``repro_torch.analysis``,
``kernels/gridspec.py``) on the CPU: reports formatted as the JAX
package's; every rule (PL1xx, LC2xx, JX3xx) firing on a seeded corruption
of a clean plan, launch model or runner and silent on every clean plan of
MobileNet V1/V2, MnasNet-A1 and EfficientNet-Lite0 and on every ladder
candidate; PL112 as the reference gives it on the fields both schemas
share; ``KernelPolicy(verify=True)`` through ``chain.execute`` and
``execute_network``; the tune cache held to planlint; and the CLI."""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import SPECS  # noqa: E402
from repro.analysis import diagnostics as jdiag  # noqa: E402
from repro.analysis import planlint as jplanlint  # noqa: E402
from repro.core import network as jnet  # noqa: E402
from repro.kernels import blocking as jblocking  # noqa: E402
from repro_torch import analysis, mobilenet_inference  # noqa: E402
from repro_torch.analysis import (diagnostics, launch_check,  # noqa: E402
                                  planlint, trace_audit)
from repro_torch.analysis import __main__ as cli  # noqa: E402
from repro_torch.core import chain, network  # noqa: E402
from repro_torch.kernels import (autotune, blocking, dwconv2d,  # noqa: E402
                                 gridspec, lowering, spans)
from repro_torch.kernels.policy import DtypePolicy, KernelPolicy  # noqa: E402

CPU = torch.device("cpu")
BAD_NET_CO = 65535 * 256 + 1


def _plan(arch, batch=8, fused=None, stream=None, res=112):
    net = getattr(network, SPECS[arch])()
    pol = KernelPolicy(fused=fused, dtype_policy=DtypePolicy(stream=stream))
    return net, network.plan_network(net, (batch, res, res, net.c_in),
                                     policy=pol, device=CPU), pol


def _find(nplan, kind):
    """(block, segment index) of the first segment of ``kind``."""
    for bi, cp in enumerate(nplan.plans):
        for si, seg in enumerate(cp.segments):
            if seg.kind == kind:
                return bi, si
    raise LookupError(kind)


def _corrupt(cp, si, **fields):
    seg = cp.segments[si]
    return autotune._with_segment_plan(
        cp, si, dataclasses.replace(seg.plan, **fields))


def _errors(diags):
    return {d.rule for d in diags if d.severity == analysis.ERROR}


def _segment_case(arch, kind, fused=None):
    """A clean plan's block and segment of ``kind``, at batch 8 fp32."""
    net, nplan, _ = _plan(arch, fused=fused)
    bi, si = _find(nplan, kind)
    return net.blocks[bi], nplan.plans[bi], nplan.block_shapes[bi], si


# ---------------------------------------------------------------------------
# reports
# ---------------------------------------------------------------------------

def test_report_format_and_json_identical_to_reference():
    rng = np.random.default_rng(5)
    rules = ("PL101", "PL112", "PL121", "LC201", "JX302", "MC201")
    port, ref = diagnostics.Report(), jdiag.Report()
    for i in range(12):
        kw = dict(rule=str(rng.choice(rules)),
                  severity=str(rng.choice(diagnostics.SEVERITIES)),
                  message=f"message {i} {rng.integers(1000)}",
                  segment=str(rng.choice(["", f"block{i}/seg0/fused3"])),
                  geometry=str(rng.choice(["", f"grid=({i}, 2, 8)"])),
                  hint=str(rng.choice(["", "shrink the tile"])))
        port.extend([diagnostics.Diagnostic(**kw)])
        ref.extend([jdiag.Diagnostic(**kw)])
    assert port.format() == ref.format()
    assert port.format(max_lines=4) == ref.format(max_lines=4)
    assert port.summary() == ref.summary()
    assert port.to_json() == ref.to_json()
    assert port.rules() == ref.rules()
    assert port.rules("error") == ref.rules("error")
    assert port.ok == ref.ok
    assert [d.format() for d in port.diagnostics] == [
        d.format() for d in ref.diagnostics]


# ---------------------------------------------------------------------------
# clean plans and every ladder candidate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused", (None, False))
@pytest.mark.parametrize("stream", (None, "bfloat16"))
@pytest.mark.parametrize("batch", (1, 8))
@pytest.mark.parametrize("arch", tuple(SPECS))
def test_clean_plans_lint_clean(arch, batch, stream, fused):
    """Every pass, the trace audit included, gives no error and no warning
    on the four bodies' plans at 112x112."""
    net, nplan, pol = _plan(arch, batch, fused, stream)
    rep = analysis.analyze_network(net, nplan, policy=pol)
    assert rep.ok, rep.format()
    assert not rep.warnings, rep.format()
    assert not any(d.rule.startswith("JX") for d in rep.diagnostics)


@pytest.mark.parametrize("batch", (1, 8))
@pytest.mark.parametrize("arch", tuple(SPECS))
def test_every_ladder_candidate_lints_clean(arch, batch):
    """Every candidate the tuner draws for every segment of the four bodies
    (fp32 and bf16, default and fused=False): no planlint or launch error,
    so that no tuned winner is dropped at its replay."""
    n = 0
    for stream in (None, "bfloat16"):
        for fused in (None, False):
            net, nplan, pol = _plan(arch, batch, fused, stream)
            sdt = pol.dtype_policy.stream_dtype(torch.float32)
            for spec, cp, shape in zip(net.blocks, nplan.plans,
                                       nplan.block_shapes):
                geoms = planlint.walk_segments(spec, cp, shape)
                for si, (geom, seg) in enumerate(zip(geoms, cp.segments)):
                    for cand in autotune.segment_candidates(
                            geom, seg.plan, sdt, cp.smem_budget):
                        ccp = autotune._with_segment_plan(cp, si, cand)
                        diags = planlint.lint_chain(spec, ccp, shape,
                                                    dtype=sdt)
                        for m in gridspec.segment_models(geom, cand, sdt):
                            diags += launch_check.lint_model(m)
                        assert not _errors(diags), [
                            d.format() for d in diags]
                        n += 1
    assert n > 300


def test_models_carry_the_plans_claims():
    """A launch model's shared memory is its plan's claim (``dw_se``: the
    pooling pass's), and its CTAs the plan's count; ``dw_se`` and ``se``
    launch twice, ``mb`` never."""
    for arch, fused in (("v2", None), ("mnasnet", None), ("lite0", None),
                        ("v1", False), ("mnasnet", False)):
        net, nplan, pol = _plan(arch, fused=fused)
        for spec, cp, shape in zip(net.blocks, nplan.plans,
                                   nplan.block_shapes):
            for geom, seg in zip(planlint.walk_segments(spec, cp, shape),
                                 cp.segments):
                models = gridspec.segment_models(geom, seg.plan,
                                                 torch.float32)
                assert len(models) == {"dw_se": 2, "se": 2, "mb": 0}.get(
                    seg.kind, 1)
                if seg.kind in ("fused2", "fused3", "fusedmb", "dw_se"):
                    assert models[0].smem == seg.plan.smem_bytes
                    assert models[0].ctas == seg.plan.ctas
                elif seg.kind in ("dw", "pw"):
                    assert models[0].smem == seg.plan.smem_bytes


# ---------------------------------------------------------------------------
# each rule fires on a seeded corruption
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rule,arch,kind,fused,fields", [
    ("PL101", "v2", "fused3", None, {"smem_bytes": 240_000}),
    ("PL102", "v2", "fused3", None, {"smem_bytes": 1024}),
    ("PL110", "v2", "fused3", None, {"block_g": 1001}),
    ("PL110", "v1", "dw", False, {"block_c": 6}),
    ("PL111", "v2", "fused3", None, {"block_co": 7}),
    ("PL112", "v2", "fused3", None, {"n_slabs": 99}),
    ("PL112", "lite0", "fusedmb", None, {"halo_rows": 9}),
    ("PL112", "v1", "dw", False, {"tile_w": 6}),
    ("PL113", "v1", "pw", False, {"variant": "tc"}),
    ("PL113", "mnasnet", "pw", None, {"block_co": 100}),
    ("PL114", "mnasnet", "dw_se", None, {"workspace_bytes": 4}),
    ("PL114", "mnasnet", "se", False, {"block_g": 3}),
])
def test_field_rule_fires(rule, arch, kind, fused, fields):
    spec, cp, shape, si = _segment_case(arch, kind, fused)
    assert not _errors(planlint.lint_chain(spec, cp, shape))
    got = _errors(planlint.lint_chain(spec, _corrupt(cp, si, **fields),
                                      shape))
    assert rule in got, got


def _model(arch="v2", kind="fused3", fused=None):
    spec, cp, shape, si = _segment_case(arch, kind, fused)
    geom = planlint.walk_segments(spec, cp, shape)[si]
    return gridspec.segment_models(geom, cp.segments[si].plan,
                                   torch.float32)[0]


def _shifted(model, axis, by=1):
    """A model whose CTAs along ``axis`` compute the work of their
    neighbour ``by`` further back."""
    def work(x, y, z):
        idx = [x, y, z]
        idx[axis] = max(idx[axis] - by, 0)
        return model.work(*idx)
    return dataclasses.replace(model, work=work)


@pytest.mark.parametrize("case", ["PL103", "PL103-warning", "PL120-in",
                                  "PL120-out", "PL121", "PL122", "PL123",
                                  "PL121-info"])
def test_grid_rule_fires(case):
    m = _model()
    assert not planlint.check_grid(m)
    assert not planlint.check_smem_derived(m, blocking.DEFAULT_SMEM_BUDGET)
    if case == "PL103":
        got = planlint.check_smem_derived(
            dataclasses.replace(m, smem=gridspec.MAX_SMEM + 16), 2 ** 30)
        assert [(d.rule, d.severity) for d in got] == [("PL103", "error")]
        return
    if case == "PL103-warning":
        got = planlint.check_smem_derived(m, m.smem - 16)
        assert [(d.rule, d.severity) for d in got] == [("PL103", "warning")]
        return
    if case == "PL120-in":
        bad = dataclasses.replace(m, in_shape=(m.in_shape[0],
                                               m.in_shape[1] - 1,
                                               *m.in_shape[2:]))
    elif case == "PL120-out":
        bad = dataclasses.replace(m, grid=(m.grid[0], m.grid[1] + 1,
                                           m.grid[2]))
    elif case == "PL121":
        bad = dataclasses.replace(m, grid=(m.grid[0], m.grid[1] - 1,
                                           m.grid[2]))
    elif case == "PL122":
        bad = _shifted(m, axis=1)
    elif case == "PL123":
        bad = _shifted(m, axis=0)
    else:
        bad = gridspec.pwconv_model(g=64 * 250_000, ci=64, co=64,
                                    variant="simt", bg=64, bco=64, bci=8,
                                    dtype=torch.float32)
        assert bad.ctas > planlint.MAX_GRID_POINTS
        got = planlint.check_grid(bad)
        assert [(d.rule, d.severity) for d in got] == [("PL121", "info")]
        return
    rule = case.split("-")[0]
    assert rule in _errors(planlint.check_grid(bad))


def test_launch_rules_fire():
    m = _model()
    assert not _errors(launch_check.lint_model(m))

    def rules(**kw):
        return {(d.rule, d.severity) for d in launch_check.lint_model(
            dataclasses.replace(m, **kw))}

    assert ("LC201", "error") in rules(grid=(m.grid[0], 65536, 1))
    assert ("LC201", "error") in rules(grid=(2 ** 31, 1, 1), cluster=(1, 1, 1))
    assert ("LC202", "error") in rules(block=(2048, 1, 1))
    assert ("LC202", "info") in rules(block=(252, 1, 1))
    assert ("LC203", "error") in rules(cluster=(16, 1, 1),
                                       grid=(16, m.grid[1], m.grid[2]))
    assert ("LC203", "error") in rules(cluster=(3, 1, 1),
                                       grid=(4, m.grid[1], m.grid[2]))
    assert ("LC204", "error") in rules(smem=gridspec.MAX_SMEM + 1)
    tc = gridspec.pwconv_model(g=1024, ci=768, co=1024, variant="tc",
                               bg=128, bco=128, bci=64,
                               dtype=torch.bfloat16)
    assert not launch_check.lint_model(tc)
    bad_tc = dataclasses.replace(tc, tma=((100, (64, 128)), (2048, (64, 64))))
    assert ("LC205", "error") in {(d.rule, d.severity) for d in
                                  launch_check.lint_model(bad_tc)}
    # hymba's bf16 w_bcdt (3200 -> 132) runs on simt: an info, no error
    p = blocking.plan_pwconv(8 * 1664, 3200, 132, dtype=torch.bfloat16)
    assert p.variant == "simt"
    hymba = gridspec.pwconv_model(g=8 * 1664, ci=3200, co=132, variant="simt",
                                  bg=p.block_g, bco=p.block_co,
                                  bci=p.block_c, dtype=torch.bfloat16)
    got = launch_check.lint_model(hymba)
    assert [(d.rule, d.severity) for d in got] == [("LC205", "info")]


def test_refused_stream_launch_is_lc201():
    """The ``pwconv`` ``stream`` launch of 16,776,961 channels that the
    CUDA driver refused (its grid asks for 524,281 CTAs in y)."""
    net = network.NetworkSpec(name="refused-pw", c_in=1, blocks=(
        chain.SeparableSpec((chain.PW(BAD_NET_CO),)),))
    pol = KernelPolicy(fused=False)
    rep = analysis.analyze_network(net, network.plan_network(
        net, (1, 1, 1, 1), policy=pol, device=CPU), policy=pol, trace=False)
    assert rep.rules("error") == ["LC201"]
    (d,) = rep.errors
    assert "524281 CTAs in grid y" in d.message


def _runner(spec, cp, pol, wrap):
    run = lowering.lower(spec, cp, pol)
    return lambda params, x: wrap(run, params, x)


@pytest.mark.parametrize("rule", ["JX301", "JX302", "JX310", "JX311"])
def test_trace_rule_fires(rule):
    """A clean fully fused chain's trace passes every audit; a runner
    corrupted in one way fails the one rule."""
    spec = chain.inverted_residual_spec(16, 16, expand=4)
    shape = (1, 12, 12, 16)
    pol = KernelPolicy()
    cp = chain.plan(spec, shape, policy=pol, device=CPU)
    assert cp.fully_fused
    params = chain.init_chain(torch.Generator().manual_seed(0), spec, 16,
                              device=CPU)
    x = torch.randn(shape)

    def audit(run):
        trace = trace_audit.trace_call(run, params, x)
        diags = trace_audit.audit_passes(
            trace, trace_audit.expected_kernel_passes(cp), cp.fully_fused)
        diags += trace_audit.audit_casts(trace, {"float32"})
        diags += trace_audit.audit_accumulation(trace)
        return _errors(diags)

    assert not audit(lowering.lower(spec, cp, pol))
    wraps = {
        "JX301": lambda run, p, x: run(p, run(p, x)),
        "JX302": lambda run, p, x: run(p, x) * 2.0,
        "JX310": lambda run, p, x: run(p, x).half().float(),
    }
    if rule == "JX311":
        def narrow(run, p, x):
            y = run(p, x)
            with spans.span("pwconv"):
                return y + (y.bfloat16() @ p[0]["w"].bfloat16()).float()[
                    ..., :16]
        wraps[rule] = narrow
    got = audit(_runner(spec, cp, pol, wraps[rule]))
    assert rule in got, got


def test_kernel_wrappers_mark_spans_on_the_plain_branch():
    trace = trace_audit.Trace()
    x, f = torch.randn(1, 6, 6, 4), torch.randn(3, 3, 4)
    with spans.listening(trace):
        dwconv2d.dwconv2d(x, f)
        with spans.span("outer"):
            dwconv2d.dwconv2d(x, f)
    assert trace.passes == 2 and trace.depth == 0


def test_trace_counts_plan_passes_of_unfused_chains():
    """JX301 is silent where a plan has standalone ``se`` (two FCs), ``mb``
    (no kernel) and a separate residual add."""
    for arch in ("mnasnet", "lite0"):
        net, nplan, pol = _plan(arch, batch=1, fused=False)
        rep = analysis.analyze_network(net, nplan, policy=pol)
        assert not any(d.rule.startswith("JX") for d in rep.diagnostics)
    spec = chain.SeparableSpec((chain.FusedMB(24, stride=1), chain.PW(16)),
                               residual=True)
    pol = KernelPolicy(fused=False)
    cp = chain.plan(spec, (1, 8, 8, 16), policy=pol, device=CPU)
    assert [s.kind for s in cp.segments] == ["mb", "pw"]
    assert trace_audit.expected_kernel_passes(cp) == 1
    assert analysis.analyze_chain(spec, cp, (1, 8, 8, 16), policy=pol).ok


# ---------------------------------------------------------------------------
# PL112 as the reference gives it
# ---------------------------------------------------------------------------

def _mirror(cp):
    return jblocking.ChainPlan(
        segments=tuple(jblocking.ChainSegment(s.kind, s.stages,
                                              jblocking.BlockPlan(
            block_c=s.plan.block_c, block_co=s.plan.block_co,
            slab_h=s.plan.slab_h, n_slabs=s.plan.n_slabs,
            halo_rows=s.plan.halo_rows, vmem_bytes=s.plan.smem_bytes,
            dtype_bytes=s.plan.dtype_bytes, block_g=s.plan.block_g))
            for s in cp.segments),
        residual=cp.residual, residual_fused=cp.residual_fused,
        dtype_bytes=cp.dtype_bytes, vmem_budget=cp.smem_budget)


@pytest.mark.parametrize("field", ("n_slabs", "halo_rows", "slab_h"))
@pytest.mark.parametrize("arch,block", [("v2", 1), ("v2", 3), ("v1", 0),
                                        ("lite0", 1)])
def test_shared_field_corruption_is_pl112_in_both(arch, block, field):
    net, nplan, _ = _plan(arch)
    jspec = getattr(jnet, SPECS[arch])().blocks[block]
    spec, cp, shape = (net.blocks[block], nplan.plans[block],
                       nplan.block_shapes[block])
    seg = cp.segments[0].plan
    bad = {"n_slabs": seg.n_slabs + 1, "halo_rows": seg.halo_rows + 3,
           "slab_h": shape[1] * 4}[field]
    port = _corrupt(cp, 0, **{field: bad})
    ref = _mirror(port)
    assert "PL112" in _errors(planlint.lint_chain(spec, port, shape))
    assert "PL112" in _errors(jplanlint.lint_chain(jspec, ref, shape))


# ---------------------------------------------------------------------------
# verify=True, the tune cache, the CLIs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("on_failure", ("raise", "degrade"))
def test_verify_raises_through_execute_and_changes_nothing(tmp_path,
                                                           on_failure):
    """Under either ``on_failure`` a bad plan raises (it never degrades:
    nothing is quarantined), and a clean one runs as without verify."""
    spec = chain.inverted_residual_spec(16, 16, expand=4)
    params = chain.init_chain(torch.Generator().manual_seed(1), spec, 16,
                              device=CPU)
    x = torch.randn(2, 12, 12, 16)
    on = KernelPolicy(verify=True, on_failure=on_failure,
                      tune_cache=str(tmp_path / "t.json"))
    cp = chain.plan(spec, x.shape, policy=on, device=CPU)
    assert cp == chain.plan(spec, x.shape, device=CPU)
    assert torch.equal(chain.execute(spec, params, x, policy=on),
                       chain.execute(spec, params, x))
    bad = _corrupt(cp, 0, n_slabs=cp.segments[0].plan.n_slabs + 1)
    with pytest.raises(analysis.PlanVerificationError, match="PL112") as e:
        chain.execute(spec, params, x, policy=on, chain_plan=bad)
    assert e.value.report.rules("error") == ["PL112"]
    assert not list(tmp_path.iterdir())
    chain.execute(spec, params, x, chain_plan=bad)  # unverified, it runs


def test_verify_raises_through_execute_network_and_changes_nothing():
    net = network.mobilenet_v2_spec(0.5)
    params = network.init_network(net, device=CPU)
    x = torch.randn(1, 32, 32, net.c_in)
    on = KernelPolicy(verify=True)
    nplan = network.plan_network(net, x.shape, policy=on, device=CPU)
    assert nplan == network.plan_network(net, x.shape, device=CPU)
    assert torch.equal(network.execute_network(net, params, x, policy=on),
                       network.execute_network(net, params, x))
    cp = nplan.plans[2]
    bad = dataclasses.replace(nplan, plans=nplan.plans[:2] + (_corrupt(
        cp, 0, block_co=7),) + nplan.plans[3:])
    with pytest.raises(analysis.PlanVerificationError, match="PL111"):
        network.execute_network(net, params, x, policy=on, network_plan=bad)
    network.clear_network_cache()


def test_verify_raises_at_plan_time_on_a_shrunken_kernel_limit(monkeypatch):
    """A planner whose claim goes over the kernel's limit (PL101) raises
    from ``plan`` under verify=True and never degrades."""
    spec = chain.inverted_residual_spec(16, 16, expand=4)
    monkeypatch.setattr(autotune, "_smem_limit", lambda kind, budget: 1024)
    monkeypatch.setattr(planlint, "_smem_limit", lambda kind, budget: 1024)
    with pytest.raises(analysis.PlanVerificationError, match="PL101"):
        chain.plan(spec, (1, 12, 12, 16), device=CPU,
                   policy=KernelPolicy(verify=True, on_failure="degrade"))


def test_dirty_tune_cache_entries_are_dropped(tmp_path):
    """A replayed entry that fails planlint is dropped with a warning
    naming its rule, per chain and per network, and the caller re-plans."""
    spec = chain.inverted_residual_spec(8, 8, expand=4)
    params = chain.init_chain(torch.Generator().manual_seed(3), spec, 8,
                              device=CPU)
    x = torch.randn(1, 8, 8, 8)
    pol = KernelPolicy(autotune=True, tune_cache=str(tmp_path / "t.json"))
    chain.execute(spec, params, x, policy=pol)
    with open(pol.tune_cache) as f:
        raw = json.load(f)
    (entry,) = raw["entries"].values()
    entry["plan"]["segments"][0]["plan"]["halo_rows"] += 5
    with open(pol.tune_cache, "w") as f:
        json.dump(raw, f)
    analytic = chain.plan(spec, x.shape, device=CPU,
                          policy=dataclasses.replace(pol, autotune=False))
    with pytest.warns(UserWarning, match=r"failed planlint \(PL112\)"):
        assert chain.plan(spec, x.shape, policy=pol, device=CPU) == analytic

    net = network.mobilenet_v1_spec(0.25)
    nparams = network.init_network(net, seed=0, device=CPU)
    nx = torch.randn(1, 16, 16, net.c_in)
    npol = KernelPolicy(autotune=True, tune_cache=str(tmp_path / "n.json"))
    r = network.tune_network(net, nparams, nx, policy=npol)
    with open(npol.tune_cache) as f:
        raw = json.load(f)
    raw["entries"][r.key]["network_plan"]["plans"][3]["segments"][0][
        "plan"]["block_co"] = 7
    with open(npol.tune_cache, "w") as f:
        json.dump(raw, f)
    with pytest.warns(UserWarning, match=r"block 3: it failed planlint"):
        network.plan_network(net, nx.shape, policy=npol, device=CPU)


def test_cli_sweep_writes_sorted_json(tmp_path):
    path = tmp_path / "report" / "planlint.json"
    assert cli.main(["--no-trace", "--json", str(path), "--batch", "1",
                     "--res", "112"]) == 0
    text = path.read_text()
    report = json.loads(text)
    assert text == json.dumps(report, indent=2, sort_keys=True) + "\n"
    assert report["ok"] and report["summary"].startswith("0 error(s)")


def test_rt401_only_under_degrade(tmp_path, monkeypatch):
    """A quarantined problem is reported (RT401) under
    ``on_failure="degrade"`` (the CLI's ``--degrade``); the default policy
    reads no quarantine."""
    from repro_torch.runtime import quarantine
    monkeypatch.setenv("REPRO_TORCH_QUARANTINE", str(tmp_path / "q.json"))
    spec, shape = chain.separable_block_spec(32), (1, 8, 8, 32)
    degrade = KernelPolicy(on_failure="degrade")
    store = quarantine.load(quarantine.quarantine_path(degrade))
    store.add_failure(autotune.problem_key(spec, shape, torch.float32,
                                           degrade, CPU),
                      signature={}, ban="fused2",
                      failure={"error": "injected"})
    store.save()
    d = cli.quarantine_diagnostic(spec, shape, torch.float32, degrade, "x")
    assert d.rule == "RT401" and "fused2" in d.message
    assert cli.quarantine_diagnostic(spec, shape, torch.float32,
                                     KernelPolicy(), "x") is None
    quarantine.clear_memo()


def test_mobilenet_inference_verify_and_modeled_hbm(capsys):
    assert mobilenet_inference.main(["--device", "cpu", "--res", "16",
                                     "--arch", "v1", "--verify"]) == 0
    out = capsys.readouterr().out
    assert "planlint 0 error(s)" in out
    assert "modeled HBM:" in out and "per-block unfused" in out
