"""Serving launcher: batched prefill, then greedy (or sampled) decode, on
a host mesh.  Counterpart of ``repro/launch/serve.py``: the mesh is
``make_host_mesh(model=--model-parallel)`` over the ranks of the launch and
the rules ``dryrun.make_rules(mesh, mode="serve")``.

    python -m repro_torch.launch.serve --arch <id> \\
        [--smoke] [--batch 4] [--prompt-len 32] [--gen 32] \\
        [--max-len 256] [--temperature 0] [--seed 0] [--device cuda] \\
        [--seq-parallel]

Several ranks run under ``torchrun``, which sets the world in the
environment; ``--model-parallel N`` (default 1) splits the model over N of
them and the batch over the rest:

    python -m torch.distributed.run --nproc-per-node W \\
        -m repro_torch.launch.serve --arch <id> --model-parallel N ...

The backend (``--backend``) is NCCL on cards, one rank a card on
``cuda:LOCAL_RANK`` (a world larger than the cards raises), and gloo with
``--device cpu``.  ``--backend gloo`` on cards runs several ranks on one
card (NCCL refuses two ranks on one device); its collectives go through
host copies and it runs eager, as gloo cannot be captured.  The group's
set-up and every collective wait at most ``mesh.DEFAULT_TIMEOUT_S``
seconds, so a lost rank fails the launch (``torchrun`` then stops the
others and exits non-zero).  Every family serves sharded: the
attention-MLP transformers, hymba (its Mamba branch over channels), xLSTM
(over heads) and whisper (its encoder by head, the cross attention's cache
by frame); a recurrent width that does not split whole over the model
axis raises (``transformer.check_mesh``).  ``--seq-parallel`` is the
reference's ``make_rules(seq_parallel=True)``: the prefill holds its
residual stream as each rank's block of the sequence over "model" where
the prompt (with its prefix) divides, and leaves the same caches and
states; a decode step (one position) is unchanged.

``<id>`` is any of ``configs.registry.ARCH_IDS`` (every reference
architecture).  ``--max-len`` bounds the attention caches and counts the
prefix: the meta tokens and a frontend's embeddings (a sliding-window
cache is a ring of window + meta slots once it exceeds that).  An
architecture with ``fusion_tokens`` (internvl2-1b's 256 patch embeddings,
llama4's 64 fusion embeddings) gets a zero frontend stub of that many
embeddings, as the reference's launcher gives it.  An encoder-decoder
(whisper-small) gets encoder frames (B, 1500, d) drawn from ``--seed``
(the reference's launcher gives zeros, which with ``enc_pos`` would test
little); they are no prefix, and the prefill runs the encoder.  Every
rank draws the same frames from the seed on the host and hands the whole
batch to the prefill, which keeps its rows.

Weights are random, drawn from ``--seed``.  On the card the prefill and the
decode step are CUDA graphs (``serve_step.capture_prefill`` and
``capture_decode_step``, as the reference jits them); sampling runs
outside the graph.  It prints the capture time, the prefill time (a warm
replay: the capture is reported on its own), ms per token and the decode
rate, the kernel launches of the prefill and of one decode step (on the
card those each graph recorded, as a replay runs no wrapper), and the
first generated tokens.  ``--device cpu`` runs the eager steps on the plain
PyTorch versions; without a card it raises.  Rank 0 prints, besides, the
mesh, the backend and how its collectives move tensors, and the
collectives the prefill and a decode step ran (or each graph recorded).
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch import graphs
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.core.network import require_device
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.dryrun import make_rules
from repro_torch.models import transformer as T
from repro_torch.serve import serve_step as S
from repro_torch.serve.sampler import generate, greedy
from repro_torch.sharding import collectives
from repro_torch.sharding.rules import use_rules

#: Kernel launches of one layer, by variant: ``pwconv`` runs every Linear
#: (hymba: q, k, v, o; the Mamba heads' in, bcdt, dt, out; the MLP's gate,
#: up, down; ``attn_mlp``: q, k, v, o, gate, up, down; a MoE layer,
#: ``attn_moe``: q, k, v, o, its router and experts being plain products;
#: ``dec``: the self-attention's q, k, v, o, the cross attention's q, k, v,
#: o (a decode step: q and o, its K/V being cached) and the MLP's three),
#: ``dwconv1d`` the conv pre-activation over a sequence (a decode step
#: takes the plain one-row step instead).
LAYER_LAUNCHES = {
    "prefill": {"mlstm": {"dwconv1d": 1, "pwconv": 6},
                "slstm": {"dwconv1d": 1, "pwconv": 4},
                "hymba": {"dwconv1d": 1, "pwconv": 11},
                "attn_mlp": {"dwconv1d": 0, "pwconv": 7},
                "attn_moe": {"dwconv1d": 0, "pwconv": 4},
                "dec": {"dwconv1d": 0, "pwconv": 11}},
    "decode": {"mlstm": {"dwconv1d": 0, "pwconv": 6},
               "slstm": {"dwconv1d": 0, "pwconv": 4},
               "hymba": {"dwconv1d": 0, "pwconv": 11},
               "attn_mlp": {"dwconv1d": 0, "pwconv": 7},
               "attn_moe": {"dwconv1d": 0, "pwconv": 4},
               "dec": {"dwconv1d": 0, "pwconv": 9}},
}
#: A MoE layer's shared expert, an MLP: gate, up, down.
SHARED_EXPERT_LAUNCHES = {"dwconv1d": 0, "pwconv": 3}


def launch_counts(counts: Optional[dict] = None) -> dict:
    """The launch counters of the kernels the LM stack runs, of ``counts``
    (a graph's recorded launches) or of the process."""
    counts = graphs.snapshot() if counts is None else counts
    return {name: counts.get(name, 0) for name in ("dwconv1d", "pwconv")}


def reset_launch_counts() -> None:
    graphs.reset()


def collective_counts(counts: Optional[dict] = None) -> dict:
    """The collectives' counters, of ``counts`` (a graph's recorded
    launches) or of the process."""
    counts = graphs.snapshot() if counts is None else counts
    return {name: counts.get(name, 0) for name in collectives.launches}


def expected_launches(cfg: ModelConfig, phase: str) -> dict:
    """Launches of one prefill (``phase="prefill"``, an encoder-decoder's
    encoder included) or one decode step (``"decode"``) on the card, by
    kernel."""
    pattern = T.model_pattern(cfg)
    out = {"dwconv1d": 0, "pwconv": 0}
    variants = [pattern[i % len(pattern)] for i in range(cfg.n_layers)]
    if cfg.encdec is not None and phase == "prefill":
        variants += [T.ENC_VARIANT] * cfg.encdec.n_enc_layers
    for variant in variants:
        counts = [LAYER_LAUNCHES[phase][
            "attn_moe" if variant.use_moe else variant.kind]]
        if variant.use_moe and cfg.moe.n_shared:
            counts.append(SHARED_EXPERT_LAUNCHES)
        for c in counts:
            for name, n in c.items():
                out[name] += n
    return out


def frontend_len(cfg: ModelConfig) -> int:
    """Rows of a config's stubbed frontend: an encoder-decoder's encoder
    frames, else its ``fusion_tokens`` (0: none)."""
    if cfg.encdec is not None:
        return cfg.encdec.enc_seq
    return cfg.fusion_tokens


def frontend_stub(cfg: ModelConfig, batch: int, device,
                  seed: int = 0) -> Optional[torch.Tensor]:
    """The stubbed frontend's input, else None (``repro/launch/
    serve.py:44-50``): zero modality embeddings (B, fusion_tokens, d), or
    an encoder-decoder's encoder frames (B, S_enc, d), N(0, 1) drawn from
    ``seed`` by a host generator in fp32 and cast."""
    if cfg.encdec is not None:
        frames = torch.randn((batch, cfg.encdec.enc_seq, cfg.d_model),
                             generator=torch.Generator().manual_seed(seed))
        return frames.to(device=device, dtype=cfg.torch_dtype)
    if not cfg.fusion_tokens:
        return None
    return torch.zeros((batch, cfg.fusion_tokens, cfg.d_model),
                       dtype=cfg.torch_dtype, device=device)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _setup(args):
    """(device, rules, backend or None) of this rank: the process group
    under ``torchrun``, or where a model axis above 1 or a backend is asked
    for; the host mesh and the serving rules over it."""
    launched = "WORLD_SIZE" in os.environ        # under torchrun
    if args.model_parallel > 1 and not launched:
        raise ValueError(
            f"--model-parallel {args.model_parallel} needs a world of ranks:"
            f" launch them with python -m torch.distributed.run "
            f"--nproc-per-node W -m repro_torch.launch.serve ...")
    backend = None
    if launched or args.backend:
        backend = args.backend or ("gloo" if torch.device(args.device).type
                                   == "cpu" else "nccl")
        dev = mesh_lib.init_world(backend, args.device)
    else:
        dev = require_device(args.device)
    mesh = mesh_lib.make_host_mesh(model=args.model_parallel)
    return dev, make_rules(mesh, mode="serve", multi_pod=False,
                           seq_parallel=args.seq_parallel), backend


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="default: nccl on cards, gloo with --device cpu")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seq-parallel", action="store_true",
                    help="hold the prefill's residual stream as each rank's "
                         "block of the sequence over the model axis")
    args = ap.parse_args(argv)

    dev, rules, backend = _setup(args)
    try:
        with use_rules(rules):
            return _serve(args, dev, rules, backend)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _peaks(dev: torch.device) -> str:
    """Each rank's peak device memory so far (GiB; every rank takes
    part), or a note on the CPU."""
    if dev.type != "cuda":
        return "not measured on the CPU"
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    peaks = [peak]
    if dist.is_initialized():
        peaks = [None] * dist.get_world_size()
        dist.all_gather_object(peaks, peak)
    return ", ".join(f"{p:.2f}" for p in peaks) + " GiB"


def _serve(args, dev: torch.device, rules, backend: Optional[str]) -> int:
    cfg = get_config(args.arch, smoke=args.smoke)
    model = T.init_params(cfg, seed=args.seed, device=dev)
    prompts = torch.randint(
        0, cfg.vocab_size, (args.batch, args.prompt_len),
        generator=torch.Generator().manual_seed(args.seed + 1)).to(dev)
    sampler = torch.Generator(device=dev).manual_seed(2)
    frontend = frontend_stub(cfg, args.batch, dev, seed=args.seed)
    # gloo cannot be captured: its ranks run the eager steps
    use_graphs = dev.type == "cuda" and backend in (None, "nccl")

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    with torch.inference_mode():
        if use_graphs:
            t0 = time.perf_counter()
            prefill = S.capture_prefill(
                model, args.batch, args.prompt_len, max_len=args.max_len,
                frontend_len=frontend_len(cfg))
            t_capture = time.perf_counter() - t0
        else:
            def prefill(t, f):
                return S.prefill(model, t, max_len=args.max_len, frontend=f)

            def step(c, t):
                return S.decode_step(model, c, t, max_len=args.max_len)
        reset_launch_counts()
        _sync(dev)
        t0 = time.perf_counter()
        logits, cache = prefill(prompts, frontend)
        _sync(dev)
        t_prefill = time.perf_counter() - t0
        prefill_counts = graphs.snapshot()
        peaks = _peaks(dev)
        if use_graphs:      # captured after the prefill: its peak is apart
            t0 = time.perf_counter()
            step = S.capture_decode_step(model, args.batch, args.max_len)
            t_capture += time.perf_counter() - t0

        first = greedy(logits)[:, None]
        reset_launch_counts()
        t0 = time.perf_counter()
        toks, cache = generate(step, cache, first, args.gen, sampler,
                               temperature=args.temperature)
        _sync(dev)
        t_gen = time.perf_counter() - t0
        step_counts = {k: v / max(args.gen, 1)
                       for k, v in graphs.snapshot().items()}

    if dist.is_initialized() and dist.get_rank() != 0:
        return 0
    tps = args.batch * args.gen / t_gen
    launches = "kernel launches"
    if use_graphs:
        print(f"[serve] captured prefill and decode step as CUDA graphs in "
              f"{t_capture * 1e3:.1f} ms (capture and instantiate: prefill "
              f"{prefill.captured.capture_s * 1e3:.1f} ms, decode step "
              f"{step.captured.capture_s * 1e3:.1f} ms)")
        # a replay runs no wrapper: count what each capture recorded
        launches = "kernel launches each graph recorded"
        prefill_counts, step_counts = (g.captured.launches
                                       for g in (prefill, step))
    mesh = rules.mesh
    group = next((mesh.group(a) for a in mesh.axis_names
                  if mesh.shape[a] > 1), None)
    print(f"[serve] mesh {mesh.shape} over "
          f"{dist.get_world_size() if dist.is_initialized() else 1} rank(s)"
          f", backend {backend or 'none (one process)'}, collectives "
          f"{collectives.transport(group, dev)}")
    print(f"[serve] {cfg.name} on {dev}: prefill {args.batch}x"
          f"{args.prompt_len} in {t_prefill * 1e3:.1f} ms; generated "
          f"{args.gen} tok/seq in {t_gen * 1e3:.1f} ms = "
          f"{t_gen * 1e3 / max(args.gen, 1):.3f} ms/token, {tps:.1f} tok/s")
    print(f"[serve] peak device memory by rank through the prefill "
          f"(weights, its capture and a replay): {peaks}")
    print(f"[serve] {launches}: prefill {launch_counts(prefill_counts)}, "
          f"per decode step {launch_counts(step_counts)}")
    print(f"[serve] collectives: prefill "
          f"{collective_counts(prefill_counts)}, per decode step "
          f"{collective_counts(step_counts)}")
    print("[serve] sample tokens:", toks[0, :16].tolist())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
