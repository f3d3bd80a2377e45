"""The captured-call layer on the CPU: the launch-counter registry, the
capture's counter bookkeeping (with PyTorch's CUDA graph API stood in for,
since there is no card here), the profiler's kernel names mapped to the
counters, ``execute_network``'s memo key, and the
static-buffer decode step that ``capture_decode_step`` captures, held
against the JAX package's ``decode_step`` on seeded numpy inputs (fp32
1e-4, as ``tests/test_torch_lm.py`` holds the functional step).  The
captures themselves run in ``tests/test_torch_cuda.py`` on the card."""
import contextlib
import dataclasses

import numpy as np
import pytest
import _torch_threads  # noqa: F401,E402

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import xlstm_125m as jcfg_mod  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve import serve_step as JS  # noqa: E402
from repro_torch import convert, graphs  # noqa: E402
from repro_torch.configs import xlstm_125m as tcfg_mod  # noqa: E402
from repro_torch.core import network  # noqa: E402
from repro_torch.kernels import (dwconv1d, pwconv,  # noqa: E402
                                 separable_fused)
from repro_torch.kernels.policy import KernelPolicy  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch import measure  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch import mobilenet_inference  # noqa: E402
from repro_torch.serve import sampler  # noqa: E402
from repro_torch.serve import serve_step as TS  # noqa: E402

#: fp32 logits against the reference (tests/test_ssm_xlstm.py's own).
LOGITS_TOL = 1e-4


@pytest.fixture
def counters():
    """Every launch counter zeroed, and put back as it was afterwards."""
    saved = graphs.snapshot()
    graphs.reset()
    yield
    graphs.restore(saved)


def test_registry_covers_every_wrapper_counter(counters):
    names = set(graphs.snapshot())
    assert names == {"dwconv2d", "pwconv", "pwconv.stream", "pwconv.tc",
                     "pwconv.simt", "separable_fused2", "separable_fused3",
                     "fused_mbconv", "dw_se", "dwconv1d", "dwconv1d_bwd",
                     "all_reduce", "all_gather", "all_to_all",
                     "reduce_scatter"}
    assert not any(graphs.snapshot().values())
    assert set(mobilenet_inference.launch_counts()) == set(
        mobilenet_inference.KERNEL_SEGMENTS)
    assert set(serve.launch_counts()) == {"dwconv1d", "pwconv"}


def test_registry_snapshot_delta_add_restore(counters):
    """Snapshot, delta and restore; the counters only move where a wrapper
    launches (the registry has no way to add to them)."""
    assert not hasattr(graphs, "add")
    before = graphs.snapshot()
    pwconv.launches += 3
    pwconv.launches_by_variant["stream"] += 3
    separable_fused.launches["fused3"] += 2
    dwconv1d.launches += 1
    after = graphs.snapshot()
    one = graphs.delta(before, after)
    assert one == {**dict.fromkeys(before, 0), "pwconv": 3,
                   "pwconv.stream": 3, "separable_fused3": 2, "dwconv1d": 1}
    assert pwconv.launches == 3 and separable_fused.launches["fused3"] == 2
    assert pwconv.launches_by_variant["stream"] == 3
    graphs.restore(before)
    assert graphs.snapshot() == before
    pwconv.launches = 5
    mobilenet_inference.reset_launch_counts()
    assert pwconv.launches == 0
    dwconv1d.launches = 2
    serve.reset_launch_counts()
    assert serve.launch_counts() == {"dwconv1d": 0, "pwconv": 0}


class _FakeGraph:
    """Stands in for ``torch.cuda.CUDAGraph``: a replay launches nothing
    through the wrappers, as a real one does."""
    replays = 0

    def replay(self):
        self.replays += 1


class _FakeStream:
    def wait_stream(self, other):
        pass


@pytest.fixture
def fake_cuda(monkeypatch):
    """PyTorch's CUDA stream and graph API replaced by stand-ins that run
    the function on the host, so that the capture's bookkeeping can be
    held here."""
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None:
                        _FakeStream())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None:
                        _FakeStream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda g: contextlib.nullcontext())


def _one_call():
    """What one call of a captured function launches through the
    wrappers."""
    pwconv.launches += 2
    pwconv.launches_by_variant["simt"] += 2
    dwconv1d.launches += 1
    return "out"


@pytest.mark.parametrize("start", (0, 7))
def test_capture_leaves_exactly_one_calls_launches(counters, fake_cuda,
                                                   start):
    """The warm-up and the capture each run the function through the
    wrappers, and the counters keep both calls; the graph records exactly
    one call's launches, and a replay, which runs no wrapper, moves no
    counter."""
    pwconv.launches = start
    captured = graphs.capture(_one_call, torch.device("cuda", 0))
    assert captured.output == "out"
    assert captured.graph.replays == 1
    assert captured.launches == {"pwconv": 2, "pwconv.simt": 2,
                                 "dwconv1d": 1}
    assert pwconv.launches == start + 4 and dwconv1d.launches == 2
    assert pwconv.launches_by_variant["simt"] == 4
    counts = graphs.snapshot()
    assert captured.replay() == "out"
    assert captured.graph.replays == 2
    assert graphs.snapshot() == counts
    assert captured.capture_s >= 0


def test_capture_restores_the_counters_when_it_fails(counters, fake_cuda):
    """A capture that fails raises and touches no counter: they hold the
    launches the wrappers made, the warm-up's and the failed
    recording's."""
    calls = []

    def fails_in_capture():
        _one_call()
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("capture failed")
    with pytest.raises(RuntimeError, match="capture failed"):
        graphs.capture(fails_in_capture, torch.device("cuda", 0))
    assert pwconv.launches == 4 and dwconv1d.launches == 2
    assert len(calls) == 2


def test_capture_refuses_the_cpu():
    with pytest.raises(ValueError, match="on the card"):
        graphs.capture(lambda: None, torch.device("cpu"))


def test_network_memo_is_keyed_by_the_param_tensors():
    """Two param sets give two memo entries, each its own output; the same
    tensors give the same entry; clear_network_cache empties the memo."""
    spec = network.mobilenet_v2_spec(0.25)
    p1 = network.init_network(spec, seed=0, device="cpu")
    p2 = network.init_network(spec, seed=1, device="cpu")
    x = torch.randn((1, 16, 16, spec.c_in),
                    generator=torch.Generator().manual_seed(0))
    network.clear_network_cache()
    y1 = network.execute_network(spec, p1, x)
    y2 = network.execute_network(spec, p2, x)
    assert len(network._NETWORK_CACHE) == 2
    assert not torch.equal(y1, y2)
    pol = KernelPolicy()
    plan = network.plan_network(spec, x.shape)
    for params, y in ((p1, y1), (p2, y2)):
        assert torch.equal(network.build_network_fn(spec, plan, pol)(
            params, x), y)
    assert torch.equal(network.execute_network(spec, p1, x), y1)
    assert len(network._NETWORK_CACHE) == 2
    y, graph = network.execute_network_graph(spec, p1, x)
    assert graph is None and torch.equal(y, y1)            # no graph here
    network.clear_network_cache()
    assert not network._NETWORK_CACHE


def test_network_memo_sees_weights_updated_in_place():
    spec = network.mobilenet_v1_spec(0.25)
    params = network.init_network(spec, seed=2, device="cpu")
    x = torch.randn((1, 16, 16, spec.c_in),
                    generator=torch.Generator().manual_seed(1))
    network.clear_network_cache()
    y = network.execute_network(spec, params, x)
    params[-1][1]["w"].mul_(2.0)
    y2 = network.execute_network(spec, params, x)
    assert len(network._NETWORK_CACHE) == 1
    assert not torch.equal(y, y2)
    network.clear_network_cache()


def _reference_lm():
    """(reference config, params) and the port model carrying the same
    weights, fp32, every all-zero leaf (norm scales, biases) replaced by
    seeded noise so that it counts."""
    jcfg = dataclasses.replace(jcfg_mod.smoke_config(), dtype="float32")
    rng = np.random.default_rng(0)

    def leaf(a):
        a = np.asarray(a)
        if np.any(a):
            return a
        return (rng.standard_normal(a.shape) * 0.1).astype(a.dtype)
    jp = jax.tree_util.tree_map(leaf, JT.init_params(
        jcfg, jax.random.PRNGKey(0)))
    model = convert.lm_params_from_numpy(jp, tcfg_mod.smoke_config(),
                                         device="cpu")
    return jcfg, jax.tree_util.tree_map(jnp.asarray, jp), model


def test_static_decode_step_matches_reference_over_greedy_steps():
    """The body ``capture_decode_step`` captures, on the CPU: from the
    prefill's cache, 8 greedy steps on one static cache and one logits
    buffer (every tensor written in place at its own address).  Each
    step's logits match the reference's ``decode_step`` from its own cache
    within 1e-4, and the tokens equal the functional step's."""
    jcfg, jp, model = _reference_lm()
    prompts = np.random.default_rng(3).integers(0, 128, (2, 7))
    lj, cj = JS.prefill(jcfg, jp, jnp.asarray(prompts, jnp.int32),
                        max_len=32)
    lt, ct = TS.prefill(model, torch.from_numpy(prompts), max_len=32)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=LOGITS_TOL,
                               atol=LOGITS_TOL)
    cache = TS.init_cache(model.cfg, 2, 32, "cpu")
    graphs.copy_tree_(cache, ct)
    addresses = [t.data_ptr() for layer in cache["layers"]
                 for t in layer.values()] + [cache["pos"].data_ptr()]
    logits = torch.empty((2, model.cfg.vocab_size))
    tokens = torch.empty((2, 1), dtype=torch.int64)
    first = sampler.greedy(lt)[:, None]
    func_toks, _ = sampler.generate(
        lambda c, t: TS.decode_step(model, c, t), ct, first, 8)
    tok_j = jnp.asarray(first.numpy(), jnp.int32)
    tokens.copy_(first)
    for i in range(8):
        out, same = TS.decode_step_into(model, cache, tokens, logits)
        assert out is logits and same is cache
        lj, cj = JS.decode_step(jcfg, jp, cj, tok_j)
        np.testing.assert_allclose(logits.numpy(), np.asarray(lj),
                                   rtol=LOGITS_TOL, atol=LOGITS_TOL)
        tokens.copy_(sampler.greedy(logits)[:, None])
        assert tokens[:, 0].tolist() == func_toks[:, i].tolist()
        tok_j = jnp.asarray(tokens.numpy(), jnp.int32)
    assert cache["pos"].tolist() == [7 + 8] * 2
    assert addresses == [t.data_ptr() for layer in cache["layers"]
                         for t in layer.values()] + [cache["pos"].data_ptr()]


def test_copy_cache_writes_every_state_in_place():
    cfg = tcfg_mod.smoke_config()
    model = TT.init_params(cfg, seed=1, device="cpu")
    _, src = TS.prefill(model, torch.randint(0, 128, (3, 5)), max_len=16)
    dst = TS.init_cache(cfg, 3, 16, "cpu")
    kept = [t for layer in dst["layers"] for t in layer.values()]
    assert graphs.copy_tree_(dst, src) is dst
    for layer, ref in zip(dst["layers"], src["layers"]):
        assert set(layer) == set(ref)
        for k, v in layer.items():
            assert torch.equal(v, ref[k]) and v.data_ptr() != ref[k].data_ptr()
    assert kept == [t for layer in dst["layers"] for t in layer.values()]
    assert dst["pos"].tolist() == [5, 5, 5]


@pytest.mark.parametrize("capture", ("prefill", "decode"))
def test_captured_steps_raise_on_the_cpu(capture):
    model = TT.init_params(tcfg_mod.smoke_config(), seed=0, device="cpu")
    with pytest.raises(ValueError, match="on the card"):
        if capture == "prefill":
            TS.capture_prefill(model, 2, 5)
        else:
            TS.capture_decode_step(model, 2, 16)


def test_run_network_on_the_cpu_reports_one_path():
    """On the CPU ``execute_network`` is the eager runner: both timings run
    it, nothing is captured and no device number is reported; the network
    cache is cleared afterwards."""
    r = mobilenet_inference.run_network(network.mobilenet_v1_spec(0.25),
                                        res=16, device="cpu")
    assert r["graph_equals_eager"] and r["rel_err"] == 0.0
    assert r["first_call_launches"] == r["eager_launches"]
    assert r["later_call_launches"] == r["eager_launches"]
    assert not any(r["first_call_launches"].values())
    assert r["replay_launches"] is None
    assert r["replay_pwconv_variants"] is None
    assert r["capture_s"] is None and r["peak_bytes"] is None
    assert r["reserved_bytes"] is None and r["held_bytes"] is None
    assert r["busy"] is None and r["device_ms"] == {}
    assert not network._NETWORK_CACHE


@pytest.mark.parametrize("kernel,counters", [
    ("void sep_fused_kernel<float, true, 3>(float const*, float const*)",
     ("separable_fused3",)),
    ("void sep_fused_kernel<__nv_bfloat16, false, 5>(__nv_bfloat16 const*)",
     ("separable_fused2",)),
    ("_Z16sep_fused_kernelIfLb1ELi3EEvPKT_", ("separable_fused3",)),
    ("_Z16sep_fused_kernelI13__nv_bfloat16Lb0ELi5EEvPKT_",
     ("separable_fused2",)),
    ("void pw_stream_kernel<float, float>(float const*)",
     ("pwconv", "pwconv.stream")),
    ("void pw_tc_kernel<__nv_bfloat16, 128>(CUtensorMap)",
     ("pwconv", "pwconv.tc")),
    ("void pw_simt_kernel<float, float, 64, 64>(float const*)",
     ("pwconv", "pwconv.simt")),
    ("void dw2d_kernel<float, float, 3, 1>(float const*)", ("dwconv2d",)),
    ("void fused_mb_kernel<float>(float const*)", ("fused_mbconv",)),
    ("void dw_se_pool_kernel<float, 4, 3, 1>(float const*)", ()),
    ("void dw_se_scale_kernel<float, float, 4, 3, 1>(float const*)",
     ("dw_se",)),
    ("void dw1d_kernel<float, float, 4>(float const*)", ("dwconv1d",)),
    ("void at::native::vectorized_elementwise_kernel<4>(int)", ()),
])
def test_profiler_kernel_names_map_to_the_launch_counters(kernel, counters):
    """A kernel instance in a profiler trace counts for the counters its
    wrapper moves where it launches it: one instance a launch, ``dw_se``'s
    two passes counted once by the second, ``separable_fused``'s stage
    count read off its EXPAND template argument."""
    assert measure._counters_of(kernel) == counters
    assert set(counters) <= set(graphs.snapshot())


def test_profiler_kernel_names_refuse_an_unknown_stage_count():
    with pytest.raises(ValueError, match="stage count"):
        measure._counters_of("sep_fused_kernel")
