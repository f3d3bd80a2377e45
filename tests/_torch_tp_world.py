"""The port's sharded serving for ``tests/test_torch_tp_serve.py`` and
``tests/test_torch_tp_recurrent.py``: one world of gloo ranks on the CPU
for a mesh shape, each rank running every case of a dict of
``_torch_tp_cases`` (``--cases``, default ``CASES``) on that mesh with the
weights and prompts the reference's oracle wrote (``_torch_tp_oracle.py``),
writing its results to ``<dir>/port_<case>_r<rank>.npz``.

    PYTHONPATH=src python tests/_torch_tp_world.py --data 1 --model 2 \\
        [--cases RECURRENT_CASES] DIR

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
    from repro_torch.launch.serve import collective_counts
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
        out["prefill_collectives"] = np.array(
            list(collective_counts().values()))
        got = _shapes(cache)
        out["cache_names"] = np.array(sorted(got))
        out["cache_shapes"] = np.array([str(got[k]) for k in sorted(got)])
        out["want_shapes"] = np.array([str(want[k]) for k in sorted(got)])
        fed = [torch.from_numpy(tok).long() for tok in z["fed"]]
        graphs.reset()
        logits_all = [logits] + _steps(S, model, cache, fed, ml)
        out["step_collectives"] = np.array(
            list(collective_counts().values())) / len(z["fed"])
        out["logits"] = torch.stack(logits_all).numpy()
        out["dwconv1d_widths"] = np.array(widths, dtype=np.int64).reshape(
            -1, 2)
        if recurrent:
            graphs.reset()
            _, cache = S.prefill(model, tokens[:, :OTHER_PROMPT], max_len=ml,
                                 frontend=frontend)
            out["other_prefill_collectives"] = np.array(
                list(collective_counts().values()))
            graphs.reset()
            _steps(S, model, cache, fed, ml)
            out["other_step_collectives"] = np.array(
                list(collective_counts().values())) / len(fed)
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


def worker(rank: int, world: int, model: int, port: int,
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
        rules = make_rules(make_host_mesh(model=model), mode="serve",
                           multi_pod=False)
        mesh = (world // model, model)
        for name, case in C.SUITES[suite].items():
            if case["mesh"] == mesh:
                run_case(name, case, rules, in_dir, rank,
                         recurrent=suite != "CASES")
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", type=int, required=True)
    ap.add_argument("--model", type=int, required=True)
    ap.add_argument("--cases", default="CASES", choices=sorted(C.SUITES))
    ap.add_argument("dir")
    args = ap.parse_args(argv)
    world = args.data * args.model
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.start_processes(worker, args=(world, args.model, port,
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
