"""The port's traffic models (``repro_torch/core/intensity.py``,
``chain.chain_traffic``, ``intensity.network_traffic``) against the JAX
package's, number for number: the paper's equations and every per-segment
model over a seeded grid of integer arguments, and the chain and network
models of MobileNet V1/V2, MnasNet-A1 and EfficientNet-Lite0 at the port's
plans mirrored field by field into the reference's schema.  Also the
paper's claims of ``tests/test_intensity.py``, on the port's copy."""
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import SPECS  # noqa: E402
from repro.core import chain as jchain  # noqa: E402
from repro.core import intensity as jit  # noqa: E402
from repro.core import network as jnet  # noqa: E402
from repro.kernels import blocking as jblocking  # noqa: E402
from repro_torch.core import chain, network  # noqa: E402
from repro_torch.core import intensity as it  # noqa: E402
from repro_torch.kernels.policy import DtypePolicy, KernelPolicy  # noqa: E402

#: Every model of the module but the network sum (tested below).
MODELS = sorted(name for name, fn in inspect.getmembers(
    it, inspect.isfunction)
    if fn.__module__ == it.__name__ and name != "network_traffic")

#: Integer ranges of the models' arguments (filters of at most 7 taps,
#: inputs at least 8 wide, so every VALID geometry has an output).
RANGES = {"hf": (1, 8), "wf": (1, 8), "stride": (1, 4), "p": (1, 9),
          "hi": (8, 80), "wi": (8, 80), "h": (8, 80), "w": (8, 80),
          "n_slabs": (1, 12), "n_co_panels": (1, 5), "h_ob": (1, 9),
          "w_ob": (1, 9), "l1_bytes": (1024, 65537)}


def _args(fn, rng):
    kw = {}
    for name in inspect.signature(fn).parameters:
        if name == "dtype_bytes":
            kw[name] = int(rng.choice([2, 4]))
        else:
            lo, hi = RANGES.get(name, (1, 300))
            kw[name] = int(rng.integers(lo, hi))
    return kw


def _num(v):
    return (v.flops, v.bytes_hbm) if isinstance(v, (it.Traffic,
                                                     jit.Traffic)) else v


def test_every_reference_model_has_its_counterpart():
    ref = sorted(name for name, fn in inspect.getmembers(
        jit, inspect.isfunction) if fn.__module__ == jit.__name__)
    assert sorted(MODELS + ["network_traffic"]) == ref


@pytest.mark.parametrize("name", MODELS)
def test_model_equals_reference(name):
    """The same number at the same arguments, over 40 seeded draws (and at
    each optional argument's default)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    fn, ref = getattr(it, name), getattr(jit, name)
    if all(p.default is not p.empty
           for p in inspect.signature(fn).parameters.values()):
        assert _num(fn()) == _num(ref())
    for _ in range(40):
        kw = _args(fn, rng)
        assert _num(fn(**kw)) == _num(ref(**kw)), kw


def test_paper_claims():
    """tests/test_intensity.py's claims, on the port's copy."""
    assert it.t_tf_dw() == pytest.approx(1 / 8)
    assert all(it.t_tf_dw(w) < 1 / 6 for w in (1, 2, 4, 8, 64))
    assert it.t_ours_dw_asymptotic(3, 3) == 9 / 22
    assert it.t_ours_dw_asymptotic(5, 5) == pytest.approx(25 / 54)
    assert abs(it.t_ours_dw(3, 3, 2, 2, 112, 112)
               - it.t_ours_dw_asymptotic(3, 3)) < 1e-3
    assert it.t_ours_dw_asymptotic(3, 3) / it.t_tf_dw(4) > 2.4
    r = it.t_rtrd_pw(ci=4096) / it.t_rtra_pw(co=4096)
    assert 1.45 < r < 1.55
    assert it.t_rtra_pw(8, 8, 4, co=10**9) == pytest.approx(4 / 3, rel=1e-6)
    assert it.t_rtrd_pw(8, 8, 4, ci=10**9) == pytest.approx(2.0, rel=1e-6)
    rtrd = it.pwconv_traffic_rtrd(12544, 64, 128, 256, 256, 256)
    rtra = it.pwconv_traffic_rtra(12544, 64, 128, 256, 256, 256)
    assert rtrd.bytes_hbm < rtra.bytes_hbm
    assert rtrd.intensity > rtra.intensity
    assert it.dwconv2d_traffic(1, 112, 112, 32, 3, 3, 1).bytes_hbm == 4 * (
        112 * 112 * 32 + 3 * 3 * 32 + 110 * 110 * 32)
    unf = it.separable_traffic_unfused(1, 114, 114, 32, 64, 3, 3, 1)
    fus = it.separable_traffic_fused(1, 114, 114, 32, 64, 3, 3, 1,
                                     block_co=64)
    assert unf.bytes_hbm - fus.bytes_hbm >= 4 * 2 * 112 * 112 * 32
    assert unf.flops == fus.flops
    halo = it.separable_slab_halo_bytes(1, 1506, 32, 3, 1, -(-1504 // 8))
    assert halo > 0
    assert it.separable_slab_halo_bytes(1, 1506, 32, 3, 1, 1) == 0
    assert it.separable_slab_halo_bytes(1, 1506, 32, 3, 3, 188) == 0
    prev = None
    ours = it.dwconv2d_traffic(1, 56, 56, 128, 3, 3, 1)
    for p in (1, 2, 4, 8):
        tf = it.dwconv2d_traffic_rowpar(1, 56, 56, 128, 3, 3, 1, p=p)
        assert tf.bytes_hbm >= ours.bytes_hbm
        assert prev is None or tf.bytes_hbm >= prev
        prev = tf.bytes_hbm


def _mirror(cp):
    """The port's ChainPlan in the reference's schema, field by field (the
    port's ``smem_bytes`` in ``vmem_bytes``, which the model does not
    read)."""
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


@pytest.mark.parametrize("fused", (None, False))
@pytest.mark.parametrize("stream", (None, "bfloat16"))
@pytest.mark.parametrize("batch", (1, 8))
@pytest.mark.parametrize("arch", tuple(SPECS))
def test_chain_and_network_traffic_equal_reference(arch, batch, stream,
                                                    fused):
    """Each block's ``chain_traffic`` and the body's ``network_traffic``
    (also re-costed at a uniform width) equal the reference functions at
    the mirrored plans, 112x112."""
    net = getattr(network, SPECS[arch])()
    jspec = getattr(jnet, SPECS[arch])()
    nplan = network.plan_network(
        net, (batch, 112, 112, net.c_in), device="cpu",
        policy=KernelPolicy(fused=fused,
                            dtype_policy=DtypePolicy(stream=stream)))
    mirrored = jnet.NetworkPlan(
        plans=tuple(_mirror(p) for p in nplan.plans),
        block_shapes=nplan.block_shapes, block_dtypes=nplan.block_dtypes,
        out_shape=nplan.out_shape, key=nplan.key)
    for spec, jblock, cp, jcp, shape in zip(net.blocks, jspec.blocks,
                                            nplan.plans, mirrored.plans,
                                            nplan.block_shapes):
        got = chain.chain_traffic(spec, cp, shape)
        want = jchain.chain_traffic(jblock, jcp, shape)
        assert (got.flops, got.bytes_hbm) == (want.flops, want.bytes_hbm)
    for nb in (None, 2):
        got = it.network_traffic(net, nplan, dtype_bytes=nb)
        want = jit.network_traffic(jspec, mirrored, dtype_bytes=nb)
        assert (got.flops, got.bytes_hbm) == (want.flops, want.bytes_hbm)
    if stream:  # bf16 streaming halves the streamed bytes, not the work
        fp32 = it.network_traffic(net, nplan, dtype_bytes=4)
        bf16 = it.network_traffic(net, nplan)
        assert bf16.flops == fp32.flops
        assert bf16.bytes_hbm == pytest.approx(fp32.bytes_hbm / 2)
