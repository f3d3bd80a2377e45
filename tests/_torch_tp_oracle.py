"""The reference's sharded serving for ``tests/test_torch_tp_serve.py``
and ``tests/test_torch_tp_recurrent.py``, and its sharded training for
``tests/test_torch_tp_train.py``: every case of a dict of
``_torch_tp_cases`` (``--cases``, default ``CASES``) on its mesh of
forced host devices, written to ``<dir>/<case>.npz``.

    XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \\
        PYTHONPATH=src python tests/_torch_tp_oracle.py DIR \\
        [--cases RECURRENT_CASES] [CASE ...]

The mesh is built here, not by ``repro.launch.mesh.make_host_mesh``:
``repro.launch.dryrun`` (whose ``make_rules`` the reference's serving
launcher uses) forces 512 host devices when it is imported, so the devices
are listed first and the mesh takes the case's own.  The weights are the
reference's ``init_params``, each all-zero leaf (norm scales, biases)
replaced by seeded noise; they are written beside the results for the port
to load.  The prefill and the decode steps are the reference's, jitted
under the rules (``use_rules``) with the parameters placed by
``param_specs``; the int8 cache's prefill is its stepping oracle and every
step of that case runs op by op (compiled, XLA's CPU drops the bf16
rounding of ``int8 * scale`` the reference's ops make, which the port
keeps).

A training case (``TRAIN_CASES``) runs under ``make_rules(mode="train")``
with the parameters placed by ``param_specs``, the batch by
``batch_pspecs`` and AdamW's moments by ``zero1_specs``, as the
reference's launcher places them: the jitted ``value_and_grad`` of
``loss_fn`` (summed over the microbatches in fp32 and divided, as the
reference's step does), its gradients gathered whole; ``apply_updates``
jitted on those gradients from zeroed moments (the parameters and
moments after it, gathered); and one jitted, donated ``make_train_step``
on the whole batch (its loss and norms).  A case's ``oracle_mesh`` runs
it on that mesh; its ``whole_grads`` add the one-device gradients.  A case with ``serve`` is a
serving case under ``serve_weight_fsdp``; one with ``oracle=False`` gets
only its batch (the port draws its own weights)."""
from __future__ import annotations

import os
import sys

import jax
import numpy as np

DEVICES = jax.devices()

import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import _torch_tp_cases as C  # noqa: E402
from repro.configs.registry import get_config  # noqa: E402
from repro.launch.dryrun import make_rules  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim import adamw as JO  # noqa: E402
from repro.serve import serve_step as JS  # noqa: E402
from repro.sharding.rules import (batch_pspecs, named,  # noqa: E402
                                  param_specs, use_rules, zero1_specs)
from repro.train import train_step as JTS  # noqa: E402


def perturbed(tree, seed: int):
    rng = np.random.default_rng(seed)

    def leaf(a):
        a = np.asarray(a)
        if np.any(a.astype(np.float32)):
            return a
        return (rng.standard_normal(a.shape) * 0.1).astype(a.dtype)
    return jax.tree_util.tree_map(leaf, tree)


def run(name: str, case: dict, out_dir: str) -> None:
    import dataclasses
    cfg = C.config(get_config(case["arch"], smoke=True), case)
    stepping = cfg.kv_quant
    if stepping:
        cfg = dataclasses.replace(cfg, scan_layers=False)
    params = perturbed(JT.init_params(cfg, jax.random.PRNGKey(C.SEED)),
                       C.SEED)
    tokens, frontend = C.inputs(cfg, case)
    dp, tp = case["mesh"]
    mesh = Mesh(np.array(DEVICES[:dp * tp]).reshape(dp, tp),
                ("data", "model"))
    rules = make_rules(mesh, mode="serve", multi_pod=False,
                       serve_weight_fsdp=bool(case.get("serve")))
    ml = case["max_len"]
    fj = None if frontend is None else jnp.asarray(frontend)
    with use_rules(rules), mesh:
        p = jax.device_put(jax.tree_util.tree_map(jnp.asarray, params),
                           named(mesh, param_specs(params, rules)))
        tj = jnp.asarray(tokens)
        if stepping:
            def step(c, t):
                return JS.decode_step(cfg, p, c, t)
            cache = JS.init_cache(cfg, C.BATCH, ml)
            for i in range(tokens.shape[1]):
                logits, cache = step(cache, tj[:, i:i + 1])
        else:
            logits, cache = jax.jit(lambda p, t: JS.prefill(
                cfg, p, t, max_len=ml, frontend=fj))(p, tj)
            step = jax.jit(lambda c, t: JS.decode_step(cfg, p, c, t))
        outs, fed = [np.asarray(logits)], []
        for _ in range(C.STEPS):
            tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
            logits, cache = step(cache, tok)
            outs.append(np.asarray(logits))
            fed.append(np.asarray(tok))
        aux = {}
        if cfg.moe is not None:
            _, _, a = jax.jit(lambda p, t: JT.hidden_states(
                cfg, p, t, frontend=fj))(p, tj)
            aux = {"aux_loss": np.asarray(a["aux_loss"]),
                   "drop_frac": np.asarray(a["drop_frac"])}
    np.savez(os.path.join(out_dir, f"{name}.npz"),
             tokens=tokens, logits=np.stack(outs), fed=np.stack(fed),
             **({} if frontend is None else {"frontend": frontend}),
             **{f"aux.{k}": v for k, v in aux.items()},
             **{f"param.{k}": v for k, v in C.flatten(params).items()})


def run_train(name: str, case: dict, out_dir: str) -> None:
    """A training case (see the module's docstring)."""
    if case.get("serve"):
        return run(name, case, out_dir)
    cfg = C.config(get_config(case["arch"], smoke=True), case)
    batch = C.train_batch(cfg, case)
    out = {"tokens": batch["tokens"], "labels": batch["labels"]}
    if case.get("oracle", True):
        params = perturbed(JT.init_params(cfg, jax.random.PRNGKey(C.SEED)),
                           C.SEED)
        out.update({f"param.{k}": v for k, v in C.flatten(params).items()})
        out.update(_train_oracle(cfg, case, params, batch))
    np.savez(os.path.join(out_dir, f"{name}.npz"), **out)


def _train_oracle(cfg, case: dict, params, batch: dict) -> dict:
    dp, tp = case.get("oracle_mesh", case["mesh"])
    mb = case.get("microbatches", 1)
    mesh = Mesh(np.array(DEVICES[:dp * tp]).reshape(dp, tp),
                ("data", "model"))
    rules = make_rules(mesh, mode="train", multi_pod=False)
    acfg = JO.AdamWConfig(**C.ADAMW)
    out = {}
    with use_rules(rules), mesh:
        pspecs = param_specs(params, rules)
        zspecs = zero1_specs(params, pspecs, rules)
        ospecs = {"mu": zspecs, "nu": zspecs,
                  "step": jax.sharding.PartitionSpec()}

        def placed(tree, specs):
            return jax.device_put(jax.tree_util.tree_map(jnp.asarray, tree),
                                  named(mesh, specs))

        def shard_batch(b):
            return placed(b, batch_pspecs(b, rules))
        p = placed(params, pspecs)
        vg = jax.jit(jax.value_and_grad(
            lambda p, b: JT.loss_fn(cfg, p, b), has_aux=True))
        size = C.batch_shape(case)[0] // mb
        loss_sum, grads = 0.0, None
        for i in range(mb):
            part = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
            (loss, metrics), g = vg(p, shard_batch(part))
            g = jax.tree_util.tree_map(
                lambda a: np.asarray(a, np.float32) if mb > 1
                else np.asarray(a), g)
            loss_sum += float(loss)
            grads = g if grads is None else jax.tree_util.tree_map(
                np.add, grads, g)
        if mb > 1:
            grads = jax.tree_util.tree_map(lambda a: a / mb, grads)
        out["loss"] = np.float32(loss_sum / mb)
        out.update({f"metric.{k}": np.asarray(v) for k, v in metrics.items()})
        out.update({f"grad.{k}": v for k, v in C.flatten(grads).items()})
        opt = placed(JO.init_state(params, acfg), ospecs)
        new_p, new_opt, am = jax.jit(
            lambda p, g, o: JO.apply_updates(p, g, o, acfg))(
                p, placed(grads, pspecs), opt)
        for part, tree in (("param", new_p), ("mu", new_opt["mu"]),
                           ("nu", new_opt["nu"])):
            out.update({f"adam.{part}.{k}": v
                        for k, v in C.flatten(tree).items()})
        out.update({f"adam.{k}": np.asarray(v) for k, v in am.items()})
        tcfg = JTS.TrainConfig(optimizer=acfg, microbatches=mb)
        step = jax.jit(JTS.make_train_step(cfg, tcfg), donate_argnums=(0,))
        state = {"params": placed(params, pspecs),
                 "opt": placed(JO.init_state(params, acfg), ospecs)}
        _, sm = step(state, shard_batch(batch))
        out.update({f"step.{k}": np.asarray(v) for k, v in sm.items()})
    if case.get("whole_grads"):
        _, g = jax.jit(jax.value_and_grad(
            lambda p, b: JT.loss_fn(cfg, p, b), has_aux=True))(
                jax.tree_util.tree_map(jnp.asarray, params),
                {k: jnp.asarray(v) for k, v in batch.items()})
        out.update({f"whole.grad.{k}": v
                    for k, v in C.flatten(g).items()})
    return out


def main(argv) -> int:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--cases", default="CASES", choices=sorted(C.SUITES))
    ap.add_argument("dir")
    ap.add_argument("names", nargs="*")
    args = ap.parse_args(argv)
    cases = C.SUITES[args.cases]
    fn = run_train if args.cases in C.TRAIN_SUITES else run
    for name in args.names or list(cases):
        fn(name, cases[name], args.dir)
        print(f"[oracle] {name}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
