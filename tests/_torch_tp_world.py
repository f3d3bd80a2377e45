"""The port's sharded serving for ``tests/test_torch_tp_serve.py`` and
``tests/test_torch_tp_recurrent.py``, and its sharded training for
``tests/test_torch_tp_train.py``: one world of gloo ranks on the CPU
for a mesh shape, each rank running every case of a dict of
``_torch_tp_cases`` (``--cases``, default ``CASES``) on that mesh with the
weights and prompts the reference's oracle wrote (``_torch_tp_oracle.py``),
writing its results to ``<dir>/port_<case>_r<rank>.npz``.

A training case (``TRAIN_CASES``, the train rules) writes its loss and
metrics, the gradients gathered whole, the parameters and moments after
the sharded AdamW on the reference's gradients, and one
``make_train_step`` step's metrics; a bf16 case its sharded loss and
gradients beside the port's own one-rank ones; a step's collectives and
the widths of its ``dwconv1d`` calls, forward and backward.  The (1, 2)
and (2, 1) meshes of ``RECURRENT_TRAIN_CASES`` write and restore the
recurrent models' checkpoints (:func:`run_recurrent_ckpt`).  The (2, 2)
and (4, 1) worlds of the training suite also run the elastic checkpoints
(``elastic_*``: a one-rank checkpoint restored under (2, 2) and saved
again; that one restored under (4, 1)) and, under (2, 2), ``train_loop``
with a fault injected at step 2 against the clean run.

    PYTHONPATH=src python tests/_torch_tp_world.py --data 1 --model 2 \\
        [--cases RECURRENT_CASES] DIR

(``--data 4 --model 1,2,4``: the meshes (4, 1), (2, 2) and (1, 4) in turn,
in one world of four ranks.)

Besides the logits, each rank writes its cache's block shapes against the
layout's (``serve_step.cache_layout``), the collectives of the prefill and
of a decode step (and, for the recurrent cases, of a second prompt length),
the widths of the ``dwconv1d`` calls it made, and whether its drawn blocks
are the unsharded draw's and put back together give it.

The ranks are ``torch.multiprocessing`` processes (spawned) that join
through ``repro_torch.launch.mesh.init_world`` (gloo over
``tcp://127.0.0.1``, every collective under a timeout); a rank that fails
or outlives the deadline makes the world exit non-zero."""
from __future__ import annotations

import argparse
import dataclasses
import os
import socket
import sys
import time

import numpy as np
import torch
import torch.multiprocessing as mp

import _torch_tp_cases as C

#: Seconds a world may take, and a collective may wait.
DEADLINE_S = 200
TIMEOUT_S = 60


def _tensors(tree, prefix=""):
    """``{dotted path: tensor}`` of a tree of dicts and lists."""
    if isinstance(tree, (dict, list)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        out = {}
        for k, v in items:
            out.update(_tensors(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


def _shapes(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, f"{prefix}{k}."))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_shapes(v, f"{prefix}{i}."))
        return out
    return {prefix[:-1]: tuple(tree.shape)}


#: The collectives a serving case counts, in this order (a serving step
#: runs no ``reduce_scatter``).
SERVE_OPS = ("all_reduce", "all_gather", "all_to_all")


def _serve_counts() -> np.ndarray:
    from repro_torch.launch.serve import collective_counts
    counts = collective_counts()
    return np.array([counts[k] for k in SERVE_OPS])


#: The prompt length of the recurrent cases' second run, whose
#: collectives a prefill and a decode step must equal the first's.
OTHER_PROMPT = 9


def _steps(S, model, cache, fed, ml):
    out = []
    for tok in fed:
        logits, cache = S.decode_step(model, cache, tok, max_len=ml)
        out.append(logits)
    return out


def run_case(name: str, case: dict, rules, in_dir: str, rank: int,
             recurrent: bool) -> None:
    from repro_torch import convert, graphs
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serve import serve_step as S
    from repro_torch.sharding.rules import (gather_block, local_block,
                                            local_shape, param_specs,
                                            use_rules)
    z = np.load(os.path.join(in_dir, f"{name}.npz"))
    cfg = C.config(get_config(case["arch"], smoke=True), case)
    params = C.unflatten({k[len("param."):]: z[k] for k in z.files
                          if k.startswith("param.")})
    tokens = torch.from_numpy(z["tokens"]).long()
    frontend = (torch.from_numpy(z["frontend"]) if "frontend" in z.files
                else None)
    ml = case["max_len"]
    # the whole cache's shapes, and this rank's blocks of them
    whole = S.cache_specs(cfg, C.BATCH, ml)
    specs = S.cache_layout(whole, rules)
    want = {}
    for k, shape in _shapes(whole).items():
        spec = specs
        for key in k.split("."):
            spec = spec[int(key)] if isinstance(spec, list) else spec[key]
        want[k] = local_shape(shape, spec, rules.mesh)
    out = {}
    widths = []
    real_dwconv1d = ops.dwconv1d_causal

    def recording_dwconv1d(x, f, **kw):
        widths.append((x.shape[-1], x.is_contiguous()))
        return real_dwconv1d(x, f, **kw)
    ops.dwconv1d_causal = recording_dwconv1d
    with use_rules(rules), torch.inference_mode():
        model = convert.lm_params_from_numpy(params, cfg, device="cpu")
        graphs.reset()
        if cfg.kv_quant:
            logits, cache = S.prefill_by_stepping(model, tokens, max_len=ml)
        else:
            logits, cache = S.prefill(model, tokens, max_len=ml,
                                      frontend=frontend)
        out["prefill_collectives"] = _serve_counts()
        got = _shapes(cache)
        out["cache_names"] = np.array(sorted(got))
        out["cache_shapes"] = np.array([str(got[k]) for k in sorted(got)])
        out["want_shapes"] = np.array([str(want[k]) for k in sorted(got)])
        fed = [torch.from_numpy(tok).long() for tok in z["fed"]]
        graphs.reset()
        logits_all = [logits] + _steps(S, model, cache, fed, ml)
        out["step_collectives"] = _serve_counts() / len(z["fed"])
        out["logits"] = torch.stack(logits_all).numpy()
        out["dwconv1d_widths"] = np.array(widths, dtype=np.int64).reshape(
            -1, 2)
        if recurrent:
            graphs.reset()
            _, cache = S.prefill(model, tokens[:, :OTHER_PROMPT], max_len=ml,
                                 frontend=frontend)
            out["other_prefill_collectives"] = _serve_counts()
            graphs.reset()
            _steps(S, model, cache, fed, ml)
            out["other_step_collectives"] = _serve_counts() / len(fed)
        if cfg.moe is not None:
            _, _, aux = T.hidden_states(model, tokens, frontend=frontend)
            out["aux_loss"] = aux["aux_loss"].numpy()
            out["drop_frac"] = aux["drop_frac"].numpy()
        # weights in blocks: each rank's drawn blocks are the blocks of
        # the unsharded draw
        drawn = T.init_params(cfg, seed=7, device="cpu")
    ops.dwconv1d_causal = real_dwconv1d
    whole_model = T.init_params(cfg, seed=7, device="cpu")
    pspecs = param_specs(whole_model, rules)
    parts = T.param_parts(whole_model)
    out["blocks_equal"] = np.array(all(
        torch.equal(p, local_block(whole_model.get_parameter(n), pspecs[n],
                                   rules.mesh, parts=parts.get(n, 1)))
        for n, p in drawn.named_parameters()))
    # the blocks put back together (collectives over the mesh's groups:
    # every rank gathers every leaf)
    out["gathered_equal"] = np.array(all([
        torch.equal(gather_block(p, pspecs[n], rules.mesh,
                                 parts=parts.get(n, 1)),
                    whole_model.get_parameter(n))
        for n, p in drawn.named_parameters()]))
    np.savez(os.path.join(in_dir, f"port_{name}_r{rank}.npz"), **out)


def _train_model(cfg, params, rules):
    """The reference's weights ``params`` as the rank's blocks under
    ``rules`` (None: whole), or without them the port's own draw from
    ``C.SEED``, trainable."""
    from repro_torch import convert
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import trainable_
    if not params:
        return trainable_(T.init_params(cfg, seed=C.SEED, device="cpu",
                                        rules=rules))
    return trainable_(convert.lm_params_from_numpy(params, cfg, device="cpu",
                                                   rules=rules))


def _tcfg(microbatches: int = 1, compression: str = "none"):
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.compress import CompressionConfig
    from repro_torch.train.train_step import TrainConfig
    return TrainConfig(optimizer=AdamWConfig(**C.ADAMW),
                       microbatches=microbatches,
                       compression=CompressionConfig(
                           kind=compression, topk_frac=C.TOPK_FRAC))


def _gathered(tree: dict, layout, moment: bool = False) -> dict:
    """The rank's blocks of ``tree`` (parameters, gradients, or with
    ``moment`` the moments) put back whole, fused projections part by
    part."""
    return {k: layout.whole(k, v, moment).float().numpy()
            for k, v in tree.items()}


def _recording_dwconv1d(widths: dict):
    """Wraps the plain ``dwconv1d`` forward and backward (what the CPU
    runs where the card launches the kernels) so that each call appends
    (channels, contiguous operands) to ``widths["fwd"]`` / ``["bwd"]``;
    returns a function that puts them back."""
    from repro_torch.kernels import dwconv1d as K
    fwd, bwd = K.dwconv1d_causal_plain, K.dwconv1d_causal_bwd_plain

    def rec_fwd(x, f):
        widths["fwd"].append((x.shape[-1], x.is_contiguous()))
        return fwd(x, f)

    def rec_bwd(x, f, dy):
        widths["bwd"].append((dy.shape[-1], x.is_contiguous()
                              and dy.is_contiguous()))
        return bwd(x, f, dy)
    K.dwconv1d_causal_plain, K.dwconv1d_causal_bwd_plain = rec_fwd, rec_bwd

    def restore():
        K.dwconv1d_causal_plain, K.dwconv1d_causal_bwd_plain = fwd, bwd
    return restore


#: The collectives a training step counts, in this order.
TRAIN_OPS = ("all_reduce", "all_gather", "all_to_all", "reduce_scatter")


def _port_leaves(z, prefix: str, period: int) -> dict:
    """The reference's arrays under ``prefix`` (its tree's dotted paths)
    by the port's parameter names."""
    from repro_torch import convert
    tree = C.unflatten({k[len(prefix):]: z[k] for k in z.files
                        if k.startswith(prefix)})
    return convert.lm_leaves(tree, period)


def run_train_case(name: str, case: dict, rules, in_dir: str,
                   rank: int) -> None:
    """A training case: see the module's docstring."""
    from repro_torch import graphs
    from repro_torch.configs.registry import get_config
    from repro_torch.optim import adamw
    from repro_torch.sharding.rules import use_rules
    from repro_torch.train import train_step as TS
    z = np.load(os.path.join(in_dir, f"{name}.npz"))
    cfg = C.config(get_config(case["arch"], smoke=True), case)
    params = C.unflatten({k[len("param."):]: z[k] for k in z.files
                          if k.startswith("param.")})
    batch = {k: torch.from_numpy(z[k]).long() for k in ("tokens", "labels")}
    if "frontend" in z.files:
        batch["frontend"] = torch.from_numpy(z["frontend"]).to(
            cfg.torch_dtype)
    mb = case.get("microbatches", 1)
    tcfg = _tcfg(mb, case.get("compression", "none"))
    out = {}
    with use_rules(rules):
        model = _train_model(cfg, params, rules)
        layout = TS.state_layout(model)
        state = TS.init_train_state(model, tcfg)
        if case.get("step_only"):
            new, sm = TS.make_train_step(model, tcfg)(state, batch)
            out.update({f"step.{k}": v.float().numpy()
                        for k, v in sm.items()})
            for part, tag in (("params", "param"), ("err", "err")):
                out.update({f"step.{tag}.{k}": v for k, v in _gathered(
                    new[part], layout).items()})
            np.savez(os.path.join(in_dir, f"port_{name}_r{rank}.npz"), **out)
            return
        graphs.reset()
        loss, metrics, grads = TS.accumulate_grads(
            model, state["params"], batch, mb, layout=layout)
        counts = graphs.snapshot()
        out["grad_collectives"] = np.array([counts[k] for k in TRAIN_OPS])
        if case.get("seq_parallel"):
            # the same gradients' collectives without sequence parallelism
            with use_rules(dataclasses.replace(rules, seq_axis=None)):
                graphs.reset()
                TS.accumulate_grads(model, state["params"], batch, mb,
                                    layout=layout)
                counts = graphs.snapshot()
            out["whole_grad_collectives"] = np.array(
                [counts[k] for k in TRAIN_OPS])
        out["loss"] = loss.float().numpy()
        out.update({f"metric.{k}": v.float().numpy()
                    for k, v in metrics.items()})
        whole = _gathered(grads, layout)
        out.update({f"grad.{k}": v for k, v in whole.items()})
        if case.get("oracle", True) and not case.get("grads_only"):
            # the sharded AdamW on the reference's gradients
            ref = _port_leaves(z, "grad.", len(model.pattern))
            g = {n: layout.block(n, torch.from_numpy(np.asarray(a)))
                 for n, a in ref.items()}
            acfg = tcfg.optimizer
            new_p, new_opt, am = adamw.apply_updates(
                state["params"], g,
                adamw.init_state(state["params"], acfg, layout), acfg,
                layout)
            for part, tree in (("param", new_p), ("mu", new_opt["mu"]),
                               ("nu", new_opt["nu"])):
                out.update({f"adam.{part}.{k}": v for k, v in _gathered(
                    tree, layout, part != "param").items()})
            out.update({f"adam.{k}": v.numpy() for k, v in am.items()})
            step = TS.make_train_step(model, tcfg)
            widths = {"fwd": [], "bwd": []}
            restore = _recording_dwconv1d(widths)
            graphs.reset()
            try:
                _, sm = step(state, batch)
            finally:
                restore()
            counts = graphs.snapshot()
            out["step_collectives"] = np.array([counts[k]
                                                for k in TRAIN_OPS])
            for k, v in widths.items():
                out[f"dwconv1d_{k}_widths"] = np.array(
                    v, dtype=np.int64).reshape(-1, 2)
            out.update({f"step.{k}": v.float().numpy()
                        for k, v in sm.items()})
    if not case.get("oracle", True) and rank == 0:
        # the port's own one-rank step on the same weights and batch
        one = _train_model(cfg, params, None)
        state = TS.init_train_state(one, tcfg)
        loss, _, grads = TS.accumulate_grads(one, state["params"], batch, mb)
        out["one.loss"] = loss.float().numpy()
        out.update({f"one.grad.{k}": v.float().numpy()
                    for k, v in grads.items()})
    np.savez(os.path.join(in_dir, f"port_{name}_r{rank}.npz"), **out)


def run_seq_serve(name: str, case: dict, host, in_dir: str,
                  rank: int) -> None:
    """A serving case under sequence parallelism (``sp_serve``): the
    port's own weights (``C.SEED``) and the case's prompt, a prefill and
    ``C.STEPS`` greedy decode steps under the serving rules without and
    with ``seq_parallel``: the logits, every cache leaf (its bytes) and
    the prefill's collectives of each."""
    from repro_torch import graphs
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.dryrun import make_rules
    from repro_torch.models import transformer as T
    from repro_torch.serve import serve_step as S
    from repro_torch.sharding.rules import use_rules
    cfg = C.config(get_config(case["arch"], smoke=True), case)
    tokens, frontend = C.inputs(cfg, case)
    tokens = torch.from_numpy(tokens).long()
    frontend = None if frontend is None else torch.from_numpy(frontend)
    ml = case["max_len"]
    out = {}
    for tag, sp in (("whole", False), ("sp", True)):
        rules = make_rules(host, mode="serve", multi_pod=False,
                           seq_parallel=sp)
        with use_rules(rules), torch.inference_mode():
            model = T.init_params(cfg, seed=C.SEED, device="cpu")
            graphs.reset()
            logits, cache = S.prefill(model, tokens, max_len=ml,
                                      frontend=frontend)
            counts = graphs.snapshot()
            out[f"{tag}.prefill_collectives"] = np.array(
                [counts[k] for k in TRAIN_OPS])
            out.update({f"{tag}.cache.{k}": v.float().numpy()
                        for k, v in _tensors(cache).items()})
            steps = [logits]
            for _ in range(C.STEPS):
                tok = logits.argmax(-1)[:, None].int()
                logits, cache = S.decode_step(model, cache, tok, max_len=ml)
                steps.append(logits)
            out[f"{tag}.logits"] = torch.stack(steps).numpy()
    np.savez(os.path.join(in_dir, f"port_{name}_r{rank}.npz"), **out)


#: The compressors' key and the models whose whole gradients
#: :func:`run_compress_blocks` cuts into blocks.
COMPRESS_KEY = 1_000_003 * 7 + 3
COMPRESS_ARCHS = {"qwen3-1.7b": {}, "hymba-1.5b": C._HYMBA}


def compress_layout(arch: str, rules):
    """The config, whole shapes, train-state layout (None without
    ``rules``) and the reference's stacks of the layers
    (``transformer.param_stacks``) of ``arch`` at its widths, from a model
    made on the meta device."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import layers
    from repro_torch.models import transformer as T
    from repro_torch.train import train_step as TS
    cfg = C.config(get_config(arch, smoke=True),
                   {"widths": COMPRESS_ARCHS[arch]})
    with layers.param_hook(None):
        meta = T.LMModel(cfg, generator=torch.Generator(), device="meta")
    shapes = {n: tuple(p.shape) for n, p in meta.named_parameters()}
    layout = None if rules is None else TS.state_layout(meta, rules)
    return cfg, shapes, layout, T.param_stacks(meta)


def run_compress_blocks(rules, in_dir: str, rank: int) -> None:
    """Each of ``COMPRESS_ARCHS``' whole gradients and errors
    (``C.compress_inputs``) cut into the rank's blocks and compressed
    under the layout, top-k and int8 (key ``COMPRESS_KEY``): the
    compressed gradients and new errors gathered whole, whether the new
    error is the residual bit for bit on the rank's blocks (and, for
    top-k, whether the two sum back to the input), and whether
    ``compress_`` gives ``compress``'s bits."""
    from repro_torch.models import transformer as T
    from repro_torch.optim import compress as K
    mesh = rules.mesh
    shape = (mesh.shape["data"], mesh.shape["model"])
    out = {}
    for arch in COMPRESS_ARCHS:
        cfg, shapes, layout, stacks = compress_layout(arch, rules)
        whole = C.compress_inputs(shapes, len(T.model_pattern(cfg)))
        g = {n: layout.block(n, torch.from_numpy(a))
             for n, a in whole["grad"].items()}
        e = {n: layout.block(n, torch.from_numpy(a))
             for n, a in whole["err"].items()}
        for kind in ("topk", "int8"):
            cfg = K.CompressionConfig(kind=kind, topk_frac=C.TOPK_FRAC)
            kw = dict(layout=layout, key=COMPRESS_KEY, stacks=stacks)
            c, e_new = K.compress(g, e, cfg, **kw)
            e_in = {n: t.clone() for n, t in e.items()}
            c_ = K.compress_(g, e_in, cfg, **kw)
            tag = f"{arch}.{kind}"
            out[f"{tag}.residual"] = np.array(all(
                torch.equal(e_new[n], g[n].float() + e[n] - c[n])
                for n in g))
            out[f"{tag}.sums_back"] = np.array(all(
                torch.equal(c[n] + e_new[n], g[n].float() + e[n])
                for n in g))
            out[f"{tag}.in_place"] = np.array(all(
                torch.equal(c[n], c_[n]) and torch.equal(e_new[n], e_in[n])
                for n in g))
            for n in g:
                out[f"{tag}.c.{n}"] = layout.whole(n, c[n]).numpy()
                out[f"{tag}.e.{n}"] = layout.whole(n, e_new[n]).numpy()
    np.savez(os.path.join(in_dir, f"port_compress_{shape[0]}x{shape[1]}"
                                  f"_r{rank}.npz"), **out)


#: The elastic checkpoints' and the recovery's model and data.
ELASTIC_ARCH = "qwen3-1.7b"
RECOVERY_STEPS = 4


def _elastic_model(rules):
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import trainable_
    cfg = C.config(get_config(ELASTIC_ARCH, smoke=True), {})
    return trainable_(T.init_params(cfg, seed=5, device="cpu", rules=rules))


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def run_elastic(rules, in_dir: str, rank: int) -> None:
    """Under (2, 2): the one-rank checkpoint (``elastic_one``) restored,
    every leaf gathered against the stored arrays, and saved again
    (``elastic_22``); the loop with a fault at step 2 against the clean
    run.  Under (4, 1): ``elastic_22`` restored and gathered."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.sharding.rules import use_rules
    from repro_torch.train import train_step as TS
    from repro_torch.train.checkpoint import Checkpointer, whole_leaves
    from repro_torch.train.trainer import (FaultInjector, LoopConfig,
                                           train_loop)
    mesh = rules.mesh
    shape = (mesh.shape["data"], mesh.shape["model"])
    out = {}
    with use_rules(rules):
        model = _elastic_model(rules)
        layout = TS.state_layout(model)
        template = TS.init_train_state(model, _tcfg())
        src = "elastic_one" if shape == (2, 2) else "elastic_22"
        ck = Checkpointer(os.path.join(in_dir, src), layout=layout)
        state, step, _ = ck.restore(template)
        with np.load(os.path.join(in_dir, src, f"step_{step:09d}",
                                  "arrays.npz")) as f:
            stored = {k: f[k] for k in f.files}
        equal = True
        for k, whole in whole_leaves(state, layout):
            a = whole.view(torch.int16) if whole.dtype == torch.bfloat16 \
                else whole
            equal &= np.array_equal(a.numpy(), stored[k])
        out["restored_equal"] = np.array(equal)
        out["step"] = np.array(step)
        if shape == (2, 2):
            Checkpointer(os.path.join(in_dir, "elastic_22"),
                         layout=layout).save(step, state)
            dcfg = DataConfig(vocab_size=model.cfg.vocab_size, seq_len=16,
                              global_batch=8, seed=3)
            finals = []
            for fail in (None, {2: "device"}):
                fresh = _elastic_model(rules)
                run_dir = os.path.join(in_dir, f"loop_{bool(fail)}")
                final, info = train_loop(
                    TS.make_train_step(fresh, _tcfg()),
                    TS.init_train_state(fresh, _tcfg()), dcfg,
                    LoopConfig(total_steps=RECOVERY_STEPS, ckpt_every=2,
                               log_every=100), run_dir,
                    fault_injector=FaultInjector(fail), layout=layout,
                    log=lambda _: None)
                finals.append((final, info))
            (clean, ci), (faulty, fi) = finals
            out["recovery_failures"] = np.array(fi["failures"])
            out["recovery_equal"] = np.array(all(
                torch.equal(a, b) for a, b in zip(
                    _leaves(clean).values(), _leaves(faulty).values())))
            out["recovery_losses"] = np.array(
                [[h["loss"] for h in i["history"]] for i in (ci, fi)])
    np.savez(os.path.join(in_dir, f"port_elastic_{shape[0]}x{shape[1]}"
                                  f"_r{rank}.npz"), **out)


#: The recurrent checkpoints' models (at their cases' widths) and seed.
CKPT_ARCHS = {"hymba-1.5b": C._HYMBA, "xlstm-125m": C._XLSTM}
CKPT_SEED, CKPT_STEP = 5, 3


def ckpt_state(cfg, rules):
    """A train state of ``cfg``'s model drawn from ``CKPT_SEED`` under
    ``rules`` (None: one rank), with top-k compression's error, its
    moments and error set from the parameters (``mu = p / 2 + 1``, ``nu =
    p * p``, ``err = 3 p - 1``: any wrong cut of one shows against its
    parameter) and its step ``CKPT_STEP``."""
    from repro_torch.models import transformer as T
    from repro_torch.sharding.rules import use_rules
    from repro_torch.train import train_step as TS
    with use_rules(rules):
        model = T.init_params(cfg, seed=CKPT_SEED, device="cpu", rules=rules)
        layout = TS.state_layout(model)
        state = TS.init_train_state(model, _tcfg(compression="topk"))
    for n, p in state["params"].items():
        b = p if layout is None else layout.zero1_block(n, p)
        state["opt"]["mu"][n] = b / 2 + 1
        state["opt"]["nu"][n] = b * b
        state["err"][n] = 3 * p.float() - 1
    state["opt"]["step"].fill_(CKPT_STEP)
    return state, layout


def ckpt_config(arch: str):
    from repro_torch.configs.registry import get_config
    return C.config(get_config(arch, smoke=True), {"widths": CKPT_ARCHS[arch]})


def run_recurrent_ckpt(rules, in_dir: str, rank: int) -> None:
    """Under (1, 2): each of ``CKPT_ARCHS``' states saved (its fused
    projections split part by part over "model").  Under (2, 1): restored,
    every leaf of the rank's blocks against the state drawn under (2, 1)
    itself, bit for bit."""
    from repro_torch.train.checkpoint import Checkpointer, _flatten
    mesh = rules.mesh
    shape = (mesh.shape["data"], mesh.shape["model"])
    out = {}
    for arch in CKPT_ARCHS:
        state, layout = ckpt_state(ckpt_config(arch), rules)
        ck = Checkpointer(os.path.join(in_dir, f"ckpt_{arch}"), layout=layout)
        if shape == (1, 2):
            ck.save(CKPT_STEP, state)
            continue
        restored, step, _ = ck.restore(state)
        got, want = _flatten(restored), _flatten(state)
        out[f"{arch}.step"] = np.array(step)
        out[f"{arch}.equal"] = np.array(sorted(
            k for k in want if not torch.equal(got[k], want[k])) or [""])
    if out:
        np.savez(os.path.join(in_dir, f"port_ckpt_{shape[0]}x{shape[1]}"
                                      f"_r{rank}.npz"), **out)


def worker(rank: int, world: int, models: list, port: int,
           in_dir: str, suite: str) -> None:
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    import torch.distributed as dist
    from repro_torch.launch.dryrun import make_rules
    from repro_torch.launch.mesh import init_world, make_host_mesh
    init_world("gloo", "cpu", timeout_s=TIMEOUT_S)
    try:
        for model in models:
            host = make_host_mesh(model=model)
            rules = make_rules(host, mode="serve", multi_pod=False)
            mesh = (world // model, model)
            for name, case in C.SUITES[suite].items():
                if case["mesh"] != mesh:
                    continue
                if case.get("sp_serve"):
                    run_seq_serve(name, case, host, in_dir, rank)
                elif suite not in C.TRAIN_SUITES:
                    run_case(name, case, rules, in_dir, rank,
                             recurrent=suite != "CASES")
                elif case.get("serve"):
                    run_case(name, case, make_rules(
                        host, mode="serve", multi_pod=False,
                        serve_weight_fsdp=True), in_dir, rank,
                        recurrent=False)
                else:
                    run_train_case(name, case, make_rules(
                        host, mode="train", multi_pod=False,
                        seq_parallel=bool(case.get("seq_parallel"))),
                        in_dir, rank)
            if suite == "TRAIN_CASES" and mesh in ((2, 2), (4, 1)):
                run_elastic(make_rules(host, mode="train", multi_pod=False),
                            in_dir, rank)
            if suite == "COMPRESS_CASES":
                run_compress_blocks(make_rules(host, mode="train",
                                               multi_pod=False), in_dir, rank)
            if suite == "RECURRENT_TRAIN_CASES" and mesh in ((1, 2), (2, 1)):
                run_recurrent_ckpt(make_rules(host, mode="train",
                                              multi_pod=False), in_dir, rank)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", type=int, required=True)
    ap.add_argument("--model", required=True,
                    help="the model axis' size; several, comma-separated, "
                    "run one mesh each in turn over the same world")
    ap.add_argument("--cases", default="CASES", choices=sorted(C.SUITES))
    ap.add_argument("dir")
    args = ap.parse_args(argv)
    models = [int(m) for m in args.model.split(",")]
    world = args.data * models[0]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.start_processes(worker, args=(world, models, port,
                                           args.dir, args.cases),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + DEADLINE_S
    while not ctx.join(timeout=5):       # raises where a rank failed
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            print(f"world {args.data}x{args.model} outlived {DEADLINE_S} s",
                  file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
