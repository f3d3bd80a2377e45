"""The port's sharding rules against the reference's: ``param_specs``,
``zero1_specs``, ``batch_pspecs`` and ``cache_pspecs`` leaf by leaf for
every registry id at full size (meta tensors on the port's side,
``jax.eval_shape`` on the reference's), on abstract meshes that give only
their shape (the reference's ``_FakeMesh``), in train and serve mode, with
``serve_weight_fsdp`` and without the experts' extra axis; then the
counterparts of ``tests/test_sharding_roofline.py:40-92`` and the blocks
of ``local_block``."""
import functools
import os

import jax
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401,E402

from repro.configs import base as jbase
from repro.configs import registry as jregistry
from repro.models import transformer as JT
from repro.serve import serve_step as JS
from repro.sharding import rules as JR
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as tregistry
from repro_torch.launch import dryrun as tdryrun
from repro_torch.launch.mesh import Mesh
from repro_torch.models import transformer as TT
from repro_torch.serve import serve_step as TS
from repro_torch.sharding import rules as R


def _reference_make_rules():
    """``repro.launch.dryrun.make_rules``: its module forces 512 host
    devices into ``XLA_FLAGS`` when imported, which is put back here so
    that no later subprocess of this worker inherits it."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import make_rules
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return make_rules


class _FakeMesh:
    def __init__(self, shape):
        self.shape = shape


MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "4x2": {"data": 4, "model": 2},
          "1x4": {"data": 1, "model": 4}}
#: (mode, serve_weight_fsdp, the experts' extra axis kept).
MODES = {"train": ("train", False, True), "serve": ("serve", False, True),
         "serve_fsdp": ("serve", True, True),
         "serve_no_expert_axis": ("serve", False, False)}
ARCHS = tregistry.ARCH_IDS


def _rules(mesh: str, mode: str):
    """(reference rules, port rules) on the abstract mesh."""
    shape = MESHES[mesh]
    kind, fsdp, expert_axis = MODES[mode]
    kw = dict(mode=kind, multi_pod="pod" in shape, serve_weight_fsdp=fsdp)
    jr = _reference_make_rules()(_FakeMesh(shape), **kw)
    tr = tdryrun.make_rules(Mesh(tuple(shape), tuple(shape.values())), **kw)
    if not expert_axis:
        import dataclasses
        jr = dataclasses.replace(jr, expert_fsdp_axis=None)
        tr = dataclasses.replace(tr, expert_fsdp_axis=None)
    return jr, tr


@functools.lru_cache(maxsize=None)
def _reference_shapes(arch: str):
    cfg = jregistry.get_config(arch)
    return jax.eval_shape(lambda: JT.init_params(cfg, jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def _port_model(arch: str):
    return TT.build_model(tregistry.get_config(arch), torch.Generator(),
                          "meta")


class _Leaf:
    def __init__(self, spec):
        self.spec = spec


def _as_port(tree, shapes, stacked: bool = False):
    """A reference spec tree as ``convert.lm_leaves`` input: each stacked
    leaf (``blocks_v*``, ``enc_blocks``) an array over its groups of the
    spec without its leading entry."""
    out = {}
    for k, v in tree.items():
        st = stacked or k.startswith("blocks_v") or k == "enc_blocks"
        if isinstance(v, dict):
            out[k] = _as_port(v, shapes[k], st)
        elif st:
            arr = np.empty(shapes[k].shape[0], dtype=object)
            for g in range(arr.shape[0]):
                arr[g] = _Leaf(tuple(v)[1:])
            out[k] = arr
        else:
            out[k] = _Leaf(tuple(v))
    return out


def _reference_specs(arch: str, specs):
    shapes = _reference_shapes(arch)
    period = len(_port_model(arch).pattern)
    leaves = convert.lm_leaves(_as_port(specs, shapes), period)
    return {k: v.spec for k, v in leaves.items()}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_reference(arch, mesh, mode):
    jr, tr = _rules(mesh, mode)
    want = _reference_specs(arch, JR.param_specs(_reference_shapes(arch),
                                                 jr))
    got = R.param_specs(_port_model(arch), tr)
    assert set(got) == set(want)
    bad = {k: (got[k], want[k]) for k in got if tuple(got[k]) != want[k]}
    assert not bad, list(bad.items())[:5]


@pytest.mark.parametrize("mode", ("train", "serve_fsdp"))
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_zero1_specs_equal_the_reference(arch, mesh, mode):
    """The reference's ``zero1_specs`` upgrades one leaf at a time; on its
    stacked layout it may pick the layers' axis, which a port parameter
    (one layer) does not have, so it is run here on the port's layout:
    each of its leaves and param specs with the stacked entries dropped."""
    jr, tr = _rules(mesh, mode)
    specs = _reference_specs(arch, JR.param_specs(_reference_shapes(arch),
                                                  jr))
    model = _port_model(arch)
    shapes = {n: jax.ShapeDtypeStruct(tuple(p.shape), np.float32)
              for n, p in model.named_parameters()}
    want = JR.zero1_specs(shapes, {n: jax.sharding.PartitionSpec(*s)
                                   for n, s in specs.items()}, jr)
    want = {n: tuple(s) for n, s in want.items()}
    got = R.zero1_specs(model, R.param_specs(model, tr), tr)
    bad = {k: (got[k], want[k]) for k in got if tuple(got[k]) != want[k]}
    assert not bad, list(bad.items())[:5]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_pspecs_equal_the_reference(arch, mesh):
    jr, tr = _rules(mesh, "train")
    jcfg, tcfg = jregistry.get_config(arch), tregistry.get_config(arch)
    for shape in tbase.SHAPES:
        want = JR.batch_pspecs(jbase.input_specs(jcfg, shape), jr)
        got = R.batch_pspecs(tbase.input_specs(tcfg, shape), tr)
        assert set(got) == set(want)
        assert all(tuple(got[k]) == tuple(want[k]) for k in got), shape


@functools.lru_cache(maxsize=None)
def _caches(arch: str):
    """The reference's and the port's whole decode caches at decode_32k
    (batch 128, 32k slots), as shapes."""
    meta = tbase.SHAPES["decode_32k"]
    b, s = meta["global_batch"], meta["seq_len"]
    return (JS.cache_specs(jregistry.get_config(arch), b, s),
            TS.cache_specs(tregistry.get_config(arch), b, s))


def _spec_tuples(tree):
    if isinstance(tree, dict):
        return {k: _spec_tuples(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_spec_tuples(v) for v in tree]
    return tuple(tree)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_pspecs_equal_the_reference(arch, mesh):
    jr, tr = _rules(mesh, "serve")
    jc, tc = _caches(arch)
    want = jax.tree_util.tree_map(
        tuple, JR.cache_pspecs(jc, jr),
        is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
    got = _spec_tuples(R.cache_pspecs(tc, tr))
    assert got["pos"] == want["pos"]
    period = len(_port_model(arch).pattern)
    for i, layer in enumerate(got["layers"]):
        ref = jax.tree_util.tree_map(
            lambda s: s[1:], want[f"v{i % period}"],
            is_leaf=lambda s: isinstance(s, tuple))
        assert layer == ref, i
    for name in ("enc_k", "enc_v"):
        assert got.get(name) == want.get(name)


# ---------------------------------------------------------------------------
# tests/test_sharding_roofline.py:40-92, ported
# ---------------------------------------------------------------------------


def _port_rules(fsdp="data"):
    return R.ShardingRules(mesh=Mesh(("data", "model"), (16, 16)),
                           batch_axes=("data",), model_axis="model",
                           fsdp_axis=fsdp)


@pytest.mark.parametrize("arch", ("qwen3-1.7b", "qwen3-moe-235b-a22b",
                                  "command-r-35b"))
def test_param_specs_shard_every_big_tensor(arch):
    model = _port_model(arch)
    specs = R.param_specs(model, _port_rules())
    for name, p in model.named_parameters():
        if p.numel() >= 1 << 20:  # every >=1M-element tensor is sharded
            assert any(a is not None for a in specs[name]), (name, p.shape)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ("qwen3-moe-235b-a22b", "hymba-1.5b",
                                  "command-r-35b"))
def test_param_specs_divisibility(arch, mesh):
    """Specs never shard a non-divisible dim."""
    _, tr = _rules(mesh, "train")
    model = _port_model(arch)
    for name, spec in R.param_specs(model, tr).items():
        shape = model.get_parameter(name).shape
        R.local_shape(shape, spec, tr.mesh)      # raises where one is not


def test_zero1_upgrades_unsharded_dims():
    model = TT.build_model(tregistry.get_config("smollm-360m", smoke=True),
                           torch.Generator(), "meta")
    rules = R.ShardingRules(mesh=Mesh(("data", "model"), (2, 1)),
                            batch_axes=("data",), model_axis=None,
                            fsdp_axis="data")
    specs = R.param_specs(model, rules)
    z = R.zero1_specs(model, specs, rules)
    before = sum("data" in s for s in specs.values())
    after = sum("data" in s for s in z.values())
    assert after > before


def test_shard_act_noop_without_context():
    x = torch.zeros((4, 8, 16))
    assert R.shard_act(x, "btd") is x


def test_shard_act_takes_this_ranks_block():
    """With a context, the block of the rank at the mesh's coordinates:
    an abstract mesh's are all 0."""
    mesh = Mesh(("data", "model"), (2, 2))
    x = torch.arange(4 * 8 * 16.).reshape(4, 8, 16)
    with R.use_rules(R.ShardingRules(mesh=mesh, fsdp_axis=None)):
        assert torch.equal(R.shard_act(x, "btd"), x[:2])
        assert torch.equal(R.shard_act(x, "logits"), x[:2, :, :8])
        assert R.shard_act(x, "tokens").shape == (2, 8, 16)


@pytest.mark.parametrize("spec", [R.P("model", None), R.P(None, "data"),
                                  R.P(("data", "model"), None),
                                  R.P(None, None)],
                         ids=str)
def test_local_blocks_tile_the_tensor(spec):
    """Every rank's block, placed by its coordinates, gives the tensor
    back; each is a copy that holds no reference to the tensor."""
    mesh = Mesh(("data", "model"), (2, 4))
    t = torch.arange(16 * 8.).reshape(16, 8)
    out = torch.full_like(t, -1.0)
    for d in range(2):
        for m in range(4):
            block = R.local_block(t, spec, mesh, {"data": d, "model": m})
            assert block.is_contiguous()
            assert block is t or block.untyped_storage().data_ptr() != (
                t.untyped_storage().data_ptr())
            rows, cols = block.shape
            idx = {"model": m, "data": d}
            r0 = (d * 4 + m if spec[0] == ("data", "model")
                  else idx.get(spec[0], 0)) * rows
            c0 = idx.get(spec[1], 0) * cols
            out[r0:r0 + rows, c0:c0 + cols] = block
    assert torch.equal(out, t)


def test_spec_equals_the_partition_spec():
    P = jax.sharding.PartitionSpec
    for entries in ((("data",), None), (("pod", "data"), "model"),
                    (None, "model", None)):
        assert tuple(R.Spec(*entries)) == tuple(P(*entries))
