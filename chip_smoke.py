#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--out DIR]

From the root of a checkout it:

1. prints the card (``nvidia-smi`` name and power limit) and the torch,
   CUDA and nvcc versions; turns TF32 off for matmul and cuDNN (cuDNN's
   fp32 convolutions default to TF32, which would spoil the plain DW
   yardstick) and bf16 products' reduced-precision reduction off;
2. builds every kernel from ``src/repro_torch/csrc`` (one nvcc per source,
   all at once) and prints the build seconds and ptxas' register report;
3. holds each kernel against its plain PyTorch version on the card at
   main-path shapes (3x3 and 5x5 taps, ``dwconv2d`` also at 9x9 and 11x11,
   ``separable_fused`` at every stage size of V2 and Lite0 including the
   7x7 blocks at batch 1 and 8, with the CTA count of each launch;
   ``fused_mbconv`` at Lite0's four blocks; ``dw_se`` at MnasNet's six
   SE block shapes and blocks 3 and 11 at a 224 input, with the CTAs of
   each pass, two calls bit for bit and a CUDA-graph replay against the
   eager call; the xLSTM and hymba conv and Linear shapes; ``dwconv1d``'s
   backward kernels at xLSTM's and hymba's training shapes, two calls bit
   for bit and a CUDA-graph replay of both launches, beside cuDNN's
   backward of the same conv), in fp32 and bf16, each kernel's planned shared memory (each ``dw_se`` pass's)
   against its own count, and times the kernel and PyTorch library calls
   for the same function, each replayed from a CUDA graph of 20 calls (2
   for hymba's prefill Linears) and as events around one eager call, and
   the plain version;
4. drives the CNN path, ``execute_network`` (one CUDA graph a forward,
   captured at its first call) and its eager runner (``build_network_fn``)
   on MobileNet V1 and V2, MnasNet-A1 and EfficientNet-Lite0 at width 1.0
   and 112x112, batch 1 and 8, fp32 and bf16 streaming, under the default
   plan and ``fused=False``, and MnasNet-A1 at 224x224 (batch 8, default
   plan): for each run it zeroes the launch counters around each call and
   checks that the wrappers launched two forwards' kernels in the graph
   path's first call (its warm-up and its capture), none in a later call
   (a replay runs no wrapper) and one forward's in an eager call; counts
   the kernels a replay ran in a profiler trace and checks they are one
   forward's; checks that the graph's output has the eager runner's bits,
   holds the output against the fp32 plain path (run eagerly), times both
   paths, prints their busy shares, each forward's own peak memory, the
   card memory the graph's first call reserved and what the graph held
   until the cache was cleared, the capture time, the CTA count of each
   ``separable_fused`` launch, the CTA count and cluster of each
   ``fused_mbconv`` launch and the CTAs a pass of each ``dw_se`` launch,
   and clears the network cache;
5. drives the tuning path, the measured autotuner (``tune_network``), on
   the same four bodies at 112x112, batch 1 and 8, fp32 and bf16, default
   plan, each into a fresh tune cache under ``build/`` (never the user's):
   it counts the tune's launches (the five kernels of the default plans
   must each be launched), checks that a second ``tune_network`` on the
   file loaded again is a hit that measures and launches nothing, holds
   every chain plan the tuner measured, on its block's input, against the
   block's plain version, then runs ``execute_network`` at the tuned plan
   and at the analytic one in turns (the tuned first call captures two
   forwards and measures nothing; its output has the tuned eager runner's
   bits and is held against the fp32 plain path) and prints each run's
   plans measured, tune seconds, the segments whose plan changed and in
   which fields, the blocks' measured winners against their analytic
   plans, and both paths' graph ms and device ms;
5b. static verification, traffic models and shims (:func:`run_static`,
   run after phase 7 so that phase 7's profiled traces come as early in
   the process as before):
   the static verifier (``repro_torch.analysis``) finds no error in any
   plan the main path and the tuning phase ran (the tuned winners too)
   nor in any ladder candidate of their segments; every launch model of
   those (``kernels/gridspec.py``) equals its library's own
   ``<kernel>_launch_dims``; the trace audit on the card is silent;
   ``KernelPolicy(verify=True)`` gives the default's plan, launches and
   bits; it prints the modeled device-memory MB of a forward
   (``core/intensity.py``) of each body at batch 8 beside the graph
   path's device ms, and runs ``separable_block`` and
   ``inverted_residual`` through the kernels against their plain path;
6. drives the runtime ladder, an opt-in
   (``KernelPolicy(on_failure="degrade")``; the default raises), with the
   quarantine pinned in a temporary directory (:func:`run_runtime`): the
   four bodies at 112x112, batch 1 and 8, fp32 and bf16, give the same
   plan, launches and bits under both policies with no fallback and no
   quarantine file (graph ms of both in turns at batch 1); then, per
   injected fault (:data:`RECOVERY_ROWS`, batch 8, fp32 and bf16), the
   first call recovers within tolerance of the plain path with every
   fallback injected and counted, the file holds the bans, and the next
   call re-plans and captures a graph that launches the kernel of every
   segment not at the plain rung and equals the eager runner; then a real
   launch the driver refuses (``pwconv``), eagerly and inside a capture,
   classifies as a ``LoweringFailure``, after which the kernel launches and
   matches its plain version (each refused launch predicted by the static
   verifier's LC201 before it is made); the code table against
   ``driver_types.h``;
7. drives the serving path, xlstm-125m at full width cut to 4 of its 12
   layers (a ``reduced`` note) on random weights
   from a seed: ``prefill`` of batch 1 and 8 prompts of 512 tokens, then
   32 greedy decode steps, in fp32 and bf16, through the captured prefill
   and decode step (``capture_prefill``, ``capture_decode_step``) and
   through the eager ones.  Around each capture and each call it zeroes
   the counters and checks the launches (4 ``dwconv1d`` + 20 ``pwconv``
   per prefill, 0 + 20 per decode step: twice in a capture, none in a
   replay, once in an eager call), and counts the kernels of a profiled
   replay of each graph in the trace; it holds every call's logits against
   the fp32 plain path (``impl="torch"`` on the card; each decode step from
   the plain path's cache and token) and the graph path's against the
   eager path's bits, reports the error of the graph path run on its own
   cache, holds ``prefill`` against ``prefill_by_stepping`` at a 64-token
   prompt, and prints the capture times, each path's prefill (host clock
   around a warm call) and decode (CUDA events, median of 10) with their
   busy shares, and each path's own peak memory;
8. drives the hymba serving path, hymba-1.5b at full width cut to 4 of
   its 32 layers (printed as a ``reduced`` note; random from a seed): ``prefill`` of batch 1 and 8 prompts of 1536
   tokens (1664 positions with the 128 meta tokens: blockwise attention,
   a sliding window that excludes keys, the 1152-slot ring cache), then 32
   greedy decode steps, fp32 and bf16, through the captured prefill and
   decode step and the eager ones (8 ``dwconv1d`` + 88 ``pwconv`` a
   prefill, 0 + 88 a decode step, counted as in 7, and ``pwconv``'s
   launches by variant equal to each Linear's ``blocking.pw_variant``);
   the graph path's logits and caches bit for bit the eager path's, each
   call within FP32_REL_TOL (fp32) or BF16_REL_TOL (bf16) of the plain
   path of its dtype from the same inputs, ``prefill`` against
   ``prefill_by_stepping`` at a 64-token prompt; it prints the same
   numbers as 7 and the device ms of one layer's prefill and of its
   attention core, selective scan and Linears at batch 8.  It runs in a
   process of its own (the script with ``--hymba-only``), whose profiler
   has taken no trace before;
8b. drives the attention-MLP serving path (:func:`run_attn_mlp`), in a
   process of its own (``--attn-mlp-only``), every model random from seed
   0 drawn on the card: qwen3-1.7b at full width and depth (28 layers,
   1.72B parameters), fp32 and bf16, batch 1 and 8, 512-token prompts and
   32 greedy steps (196 ``pwconv`` a prefill and a decode step, by
   variant each Linear's ``pw_variant``, printed by shape), ``prefill``
   against ``prefill_by_stepping`` at a 64-token prompt, and bf16 with the
   int8 KV cache at batch 8 against its plain path and beside the bf16
   cache (the logits' gap, ms per token); smollm-360m and internvl2-1b
   (its 256 frontend embeddings) at full width and depth, bf16, batch 8;
   command-r-35b, qwen1.5-110b and qwen3-moe-235b-a22b at full width cut
   to 2, 1 and 2 layers (printed as ``reduced`` notes), bf16, batch 8,
   qwen3-moe's drop fraction and its MoE block against ``moe_dense_ref``
   where no copy was dropped (bf16 and fp32 weights); llama4-maverick at
   its smoke config.  Each run as in 8: launches counted, the graph path
   bit for bit the eager path, each call against the plain path, a
   profiled replay of each graph; and one layer's prefill broken down
   (CUDA events) for qwen3-1.7b and qwen3-moe (the MoE dispatch's
   plain-op share);
9. drives whisper-small's serving path uncut (:func:`run_whisper`, a
   process of its own): 12 encoder and 12 decoder layers, frames from
   seed 0, a 32-token prompt and 64 greedy steps, caches of 448
   positions, bf16 at batch 1 and 8 and fp32 at batch 1, each run as in
   8 (216 ``pwconv`` a prefill, 108 a decode step, by variant), the
   captured decode step never writing the encoder's K/V; the encoder's
   own time beside the prefill's;
10. trains on one card (:func:`run_training`, a process of its own,
   deterministic): step-1 gradients of the kernel path against the plain
   path (smollm and xlstm cut to 2 layers, hymba to 1, whisper-small
   uncut, fp32); then the captured train step (one CUDA graph of loss,
   backward, compression and AdamW, the state updated in place) against
   the eager step, from one state on the same batches, in turns, every
   tensor of the state and every metric bit for bit after each step, the
   graph's recorded launches and a profiled replay's
   ``expected_train_launches``: the fault-tolerant loop on smollm-360m
   uncut (bf16, 8 x 256, 20 steps, 480 ``pwconv`` a step) with the eager
   step beside the graph, then through the graph with a fault at step
   15, ending with the clean graph run's state and the clean eager run's
   bit for bit; xlstm-125m cut to 4 layers the same way (3 steps, a
   fault at step 2; ``dwconv1d`` forward, remat and its two backward
   kernels in every step); hymba-1.5b at full width cut to 4 layers (a
   ``reduced`` note;
   2 x 512 tokens and the 128 meta tokens, 6 steps) and its selective
   scan's forward and backward device ms in one layer; 3 steps each of
   whisper-small uncut with its frames, qwen3-moe at full width cut to 1
   layer (a ``reduced`` note; its eager steps before the graph's, which
   is held to their fingerprints and, at the end, to their state copied
   to the host) and smollm at 2 layers with 2 microbatches, top-k
   and int8 compression; per model the graph's and the eager step's ms,
   tokens/s, own peaks, busy shares and device events, the capture's
   seconds; and ``train_e2e`` for 60 steps, its loss falling;
11. serves sharded on the one card (:func:`run_sharded`, a process of its
   own, ``--sharded-only``): qwen3-1.7b at full width and depth, bf16,
   8 x 512 + 8 greedy steps as CUDA graphs, unsharded and under the rules
   of a world of one rank under NCCL, bit for bit (the one-device code
   under an NCCL group: a one-rank mesh shards nothing and launches no
   collective), and one NCCL ``all_gather`` captured and replayed; NCCL
   collectives captured with more than one rank need several cards
   (``test_nccl_ranks_across_cards_serve_as_one_rank`` in
   ``tests/test_torch_cuda.py``);
   then two gloo ranks on the one
   card (collectives through the host, eager): qwen3-1.7b fp32 at tensor
   parallelism 2 against the unsharded path, with each local width's
   ``pwconv`` variant, and qwen3-moe at its published widths cut to 1
   layer (a ``reduced`` note), expert-parallel at tp 2, the kernels
   against the plain versions on the same ranks in bf16 and fp32, with
   the copies that the bf16 rounding sends to another expert counted;
   then hymba-1.5b, xlstm-125m and whisper-small at their published
   widths cut in depth (a ``reduced`` note), fp32, tp 2, each against the
   unsharded path, with the collectives and launches of a prefill and a
   step, ``dwconv1d`` on each rank's channel block (hymba's 1600 of 3200
   channels held against its plain version);
12. trains sharded on the one card (:func:`run_sharded_training`, a
   process of its own, ``--sharded-train-only``): qwen3-1.7b at full
   width cut to 2 layers, bf16, the captured step under the train rules
   of a world of one rank under NCCL against the eager step, bit for bit;
   then two gloo ranks: smollm-360m at full width cut to 2 layers under
   (data 2, model 1) (FSDP, ZeRO-1, data parallelism) and qwen3-1.7b cut
   to 2 layers under (1, 2), fp32, step 1's loss and gathered gradients
   against the one-rank eager step, 3 steps each with their ms,
   collectives and ``pwconv`` launches by rank; one ``pwconv`` launch at
   a local training width against its plain version; qwen3-moe's smoke
   config under (1, 2), kernels against the plain versions; part 1's
   checkpoint restored under (1, 2) and by one rank, bit for bit
   (``reduced`` notes name the cuts); NCCL across cards is
   ``test_nccl_train_across_cards``;
13. prints the kernels it launched, one JSON line of per-kernel numbers
   (``launches``: the wrappers' counts on the main paths; beside them
   ``replay_launches``: the kernels the profiled graph replays ran), the
   card again, and as its last line ``{"ok": true, "device": ...}``.

Any failed check raises, and the script exits non-zero before the last
line.  It needs one CUDA device and imports nothing of JAX or of the JAX
package.  With ``--out DIR`` the full results also go to
``DIR/chip_smoke.json``.
"""
import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import time
import warnings

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

#: Relative-to-max tolerances of a kernel against its plain version on the
#: same inputs.  fp32: the same products summed in another order than
#: cuDNN / cuBLAS / the plain path sum them.  bf16: both sides store bf16,
#: so they may differ by one bf16 rounding of the output.
KERNEL_TOL = {"float32": 1e-4, "bfloat16": 1e-2}

#: Published H100 SXM peaks (NVIDIA data sheet): device memory rate, fp32
#: outside the tensor cores, dense bf16.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}

#: Launches one forward makes, by plan: the segment counts the reference
#: planner gives these bodies at 112x112, and MnasNet-A1 at 224x224 (a
#: standalone ``se`` segment launches ``pwconv`` twice; ``mb`` is the plain
#: ``F.conv2d``).
EXPECTED_LAUNCHES = {
    ("v1", None): {"separable_fused2": 13},
    ("v1", False): {"dwconv2d": 13, "pwconv": 13},
    ("v2", None): {"separable_fused2": 1, "separable_fused3": 16},
    ("v2", False): {"dwconv2d": 17, "pwconv": 33},
    ("mnasnet", None): {"separable_fused2": 1, "separable_fused3": 7,
                        "pwconv": 16, "dw_se": 8},
    ("mnasnet", False): {"dwconv2d": 16, "pwconv": 47},
    ("lite0", None): {"separable_fused2": 1, "fused_mbconv": 4,
                      "separable_fused3": 11},
    ("lite0", False): {"dwconv2d": 12, "pwconv": 27},
}

SOURCES = {
    "dwconv2d": ("src/repro_torch/csrc/dwconv2d.cu",
                 "src/repro/kernels/dwconv2d.py:87"),
    "pwconv": ("src/repro_torch/csrc/pwconv.cu",
               "src/repro/kernels/pwconv.py:122"),
    "separable_fused2": ("src/repro_torch/csrc/separable_fused.cuh",
                         "src/repro/kernels/separable_fused.py:254"),
    "separable_fused3": ("src/repro_torch/csrc/separable_fused.cuh",
                         "src/repro/kernels/separable_fused.py:254"),
    "fused_mbconv": ("src/repro_torch/csrc/fused_mbconv.cu",
                     "src/repro/kernels/fused_mbconv.py:193"),
    "dw_se": ("src/repro_torch/csrc/dw_se.cu",
              "src/repro/kernels/se_epilogue.py:143"),
    "dwconv1d": ("src/repro_torch/csrc/dwconv1d.cu",
                 "src/repro/kernels/dwconv1d.py:51"),
    # the backward has no TPU kernel: the reference differentiates its XLA
    # oracle of the op (src/repro/kernels/ref.py:76)
    "dwconv1d_bwd": ("src/repro_torch/csrc/dwconv1d.cu",
                     "src/repro/kernels/dwconv1d.py:51"),
}

#: The serving phase: prompt length, greedy decode steps, the prompt of the
#: prefill_by_stepping oracle, and the bf16 tolerance of the reference's
#: network gate.
PROMPT_LEN, GEN_STEPS, STEPPING_PROMPT = 512, 32, 64
#: The hymba serving phase: prompt length (the 128 meta tokens come on
#: top), greedy decode steps, and the prefill_by_stepping oracle's prompt.
HYMBA_PROMPT, HYMBA_GEN, HYMBA_STEPPING = 1536, 32, 64
#: hymba's depth in that phase, cut so that the script stays within its
#: budget with the whisper and training phases (the whole model took about
#: 220 s of 707, 16 layers 100 s of 817, 8 layers 67 s of about 820, 4
#: layers 41 s of 730; cut to 4 again beside phase 12, after a run on a
#: slow host reached the training phase at 917 s); widths, window, meta
#: tokens and prompt as published.
HYMBA_LAYERS = 4
HYMBA_NOTE = ("reduced: hymba-1.5b n_layers 32 -> 4 (the script's time, "
              "with the whisper and training phases); widths as published")
#: xlstm-125m's depth in the serving phase and in the training loop, cut
#: so that the whole script keeps a margin under 1200 s on a slow host:
#: uncut, the script took 854-875 s on one H100 and 1070 s on another
#: whose every phase ran 1.1-1.5x slower (xLSTM serving 164 s, its
#: training loop 103 s there); cut from 6 to 4 beside phase 12; each
#: [mLSTM, sLSTM] pair stays whole.
XLSTM_LAYERS = 4
XLSTM_NOTE = ("reduced: xlstm-125m n_layers 12 -> 4 (the script's time); "
              "widths as published")
BF16_REL_TOL = 5e-2
#: fp32 kernels against the fp32 plain path (summation order).
FP32_REL_TOL = 1e-4


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def bwd_registers(lib_path, dtype, k: int, vec: bool) -> int:
    """Registers a thread of ``dw1d_bwd_kernel`` at ``dtype``, K (its exact
    path for 2..5, the runtime one otherwise) and the vector path, from
    ptxas' report beside the built library (-1 where it is not found)."""
    name = {"torch.float32": "f", "torch.bfloat16": "13__nv_bfloat16",
            "torch.float16": "6__half"}[str(dtype)]
    kt = k if 2 <= k <= 5 else 0
    want = f"dw1d_bwd_kernelI{name}Li{kt}ELb{int(vec)}E"
    log = lib_path.with_suffix(".log")
    entry = None
    for line in (log.read_text() if log.exists() else "").splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and entry and want in entry:
            return int(m.group(1))
    return -1


def _versions(torch, build) -> str:
    nv = subprocess.run([build.nvcc(), "--version"], capture_output=True,
                        text=True, check=True).stdout.strip().splitlines()
    return (f"python {sys.version.split()[0]}, torch {torch.__version__}, "
            f"torch CUDA {torch.version.cuda}, nvcc: {nv[-1]}")


class KernelChecks:
    """Each kernel against its plain version at main-path shapes."""

    def __init__(self, torch, dev):
        from repro_torch.kernels import ref
        from repro_torch.measure import graph_ms, rel_err, time_ms
        self.torch, self.dev = torch, dev
        self.pad_same, self.rel_err, self.time_ms = ref.pad_same, rel_err, time_ms
        self.graph_ms = graph_ms
        self.gen = torch.Generator().manual_seed(0)
        self.results = []

    def rand(self, shape, dtype, scale=1.0):
        t = self.torch.randn(shape, generator=self.gen) * scale
        return t.to(device=self.dev, dtype=dtype)

    def measure(self, name, label, dtype, kern, plain, library, ops, nbytes,
                launches=1, extra=None, graph_launches=20):
        """``launches``: calls timed between one pair of events (a run of
        many for a microsecond kernel); ``graph_launches``: calls a timed
        CUDA graph holds; ``extra``: more fields to keep."""
        torch = self.torch
        got, want = kern(), plain()
        torch.cuda.synchronize(self.dev)
        dname = str(dtype).replace("torch.", "")
        abs_err = float((got.float() - want.float()).abs().max())
        rel = self.rel_err(got, want)
        finite = bool(torch.isfinite(got.float()).all())
        kw = dict(reps=20, warmup=3, launches=launches)
        eager_ms = self.time_ms(kern, self.dev, **kw)
        plain_ms = self.time_ms(plain, self.dev, **kw)
        library_eager_ms = self.time_ms(library, self.dev, **kw)
        # the device's pace: a CUDA graph of 20 launches replayed
        ms = self.graph_ms(kern, self.dev, launches=graph_launches)
        library_ms = self.graph_ms(library, self.dev,
                                   launches=graph_launches)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_OPS[dname] * 1e3
        r = {"name": name, "shape": label, "dtype": dname,
             "max_abs_err": abs_err, "max_rel_err": rel,
             "tol": KERNEL_TOL[dname], "ms": ms, "plain_ms": plain_ms,
             "library_ms": library_ms, "bound_ms": max(t_bytes, t_ops),
             "bound_by": "bytes" if t_bytes >= t_ops else "operations",
             "eager_ms": eager_ms, "library_eager_ms": library_eager_ms,
             "bytes": nbytes, "ops": ops, **(extra or {})}
        print(f"  {name:17s} {label:44s} {dname:8s} rel err {rel:.2e} "
              f"(tol {r['tol']:g}) kernel {ms:.4f} ms (eager {eager_ms:.4f}), "
              f"plain {plain_ms:.4f} ms, library {library_ms:.4f} ms (eager "
              f"{library_eager_ms:.4f}), bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']})"
              + "".join(f", {k} {v:.4f}" if isinstance(v, float)
                        else f", {k} {v}" for k, v in (extra or {}).items()),
              flush=True)
        if not (finite and rel <= r["tol"]):
            raise AssertionError(f"{name} {label} {dname}: rel err {rel} "
                                 f"> {r['tol']} (finite={finite})")
        self.results.append(r)

    def dwconv2d(self, b, h, w, c, stride, dtype, k=3):
        """One shape as the main path runs it: x unpadded, the kernel
        applying the SAME padding itself, at the planner's tile; its shared
        memory against the kernel's own count."""
        import torch.nn.functional as F
        from repro_torch.kernels import blocking, dwconv2d, ref
        x_raw = self.rand((b, h, w, c), dtype)
        x = self.pad_same(x_raw, k, k, stride)
        pad = ref.same_pads(h, w, k, k, stride)
        f = self.rand((k, k, c), dtype, 1 / k)
        ho, wo = -(-h // stride), -(-w // stride)
        plan = blocking.plan_dwconv2d(h, w, ho, wo, c, k, k, stride=stride,
                                      dtype=dtype)
        self.same_smem(plan.smem_bytes, dwconv2d.smem_bytes(
            plan.slab_h, plan.tile_w, plan.block_c, k, k, stride, dtype))
        xc = x.permute(0, 3, 1, 2)
        fc = f.permute(2, 0, 1)[:, None].contiguous()
        self.measure(
            "dwconv2d", f"{b}x{h}x{w}x{c} k{k} s{stride} tile {plan.slab_h}x"
            f"{plan.tile_w}x{plan.block_c} {plan.variant}"
            + (" compiled" if blocking.dw_compiled(k, k, stride)
               else " runtime-K"), dtype,
            lambda: dwconv2d.dwconv2d(x_raw, f, stride=stride, pad=pad),
            lambda: dwconv2d.dwconv2d_plain(x, f, stride=stride),
            lambda: F.conv2d(xc, fc, stride=stride, groups=c),
            2 * b * ho * wo * c * k * k,
            (x_raw.numel() + f.numel() + b * ho * wo * c) * x.element_size())

    def pwconv(self, g, ci, co, dtype, act="relu6", launches=20):
        """One shape: the planner's variant and tile, its shared memory
        against the kernel's own count, times over runs of 20 launches
        (eager, and replayed from a CUDA graph, which leaves out the host's
        launch overhead), and for ``stream`` also with L2 cold (a run
        rotating over copies of w that together exceed the 50 MB L2, as
        decode streams its weights)."""
        torch = self.torch
        from repro_torch.kernels import blocking, pwconv
        from repro_torch.measure import graph_ms
        x = self.rand((g, ci), dtype)
        w = self.rand((ci, co), dtype, ci ** -0.5)
        bias = self.rand((co,), dtype, 0.1)
        plan = blocking.plan_pwconv(g, ci, co, dtype=dtype)
        self.same_smem(plan.smem_bytes, pwconv.smem_bytes(
            plan.variant, plan.block_g, plan.block_co, plan.block_c, ci))
        extra = {"variant": plan.variant,
                 "tile": [plan.block_g, plan.block_co, plan.block_c,
                          plan.cluster]}
        if plan.variant == "stream":
            copies = [w] + [w.clone() for _ in range(
                max(5, -(-64 * 2 ** 20 // (w.numel() * w.element_size()))))]
            turn = iter(range(10 ** 9))
            cold = lambda: pwconv.pwconv(  # noqa: E731
                x, copies[next(turn) % len(copies)], bias, activation=act)
            extra["cold_ms"] = self.time_ms(cold, self.dev, reps=20,
                                            warmup=3, launches=len(copies))
            extra["cold_graph_ms"] = graph_ms(cold, self.dev,
                                              launches=len(copies))
        before = pwconv.launches_by_variant[plan.variant]
        pwconv.pwconv(x, w, bias, activation=act)
        if pwconv.launches_by_variant[plan.variant] != before + 1:
            raise AssertionError(f"pwconv G={g} {ci}->{co}: the launch was "
                                 f"not counted as {plan.variant}")
        self.measure(
            "pwconv", f"G={g} {ci}->{co} {act or 'no act'} {plan.variant}",
            dtype,
            lambda: pwconv.pwconv(x, w, bias, activation=act),
            lambda: pwconv.pwconv_plain(x, w, bias, activation=act),
            lambda: torch.addmm(bias, x, w),
            2 * g * ci * co,
            (x.numel() + w.numel() + co + g * co) * x.element_size(),
            launches=launches, extra=extra, graph_launches=launches)

    def dwconv1d(self, b, length, d, k, dtype, rows=None):
        import torch.nn.functional as F
        from repro_torch.kernels import dwconv1d
        x = self.rand((b, length, d), dtype)
        f = self.rand((k, d), dtype, k ** -0.5)
        rows = rows or dwconv1d.ROWS
        xt, ft = x.transpose(1, 2), f.T[:, None, :]
        self.measure(
            "dwconv1d", f"{b}x{length}x{d} k{k} vec "
            f"{dwconv1d.vector_width(x, f)} rows {rows}", dtype,
            lambda: dwconv1d.dwconv1d_causal(x, f, rows=rows),
            lambda: dwconv1d.dwconv1d_causal_plain(x, f),
            lambda: F.conv1d(xt, ft, groups=d, padding=k - 1)[..., :length],
            2 * b * length * d * k,
            (2 * x.numel() + f.numel()) * x.element_size())

    def dwconv1d_bwd(self, b, length, d, k, dtype):
        """``dwconv1d``'s backward at a training shape: dx and df of its one
        launch against ``dwconv1d_causal_bwd_plain`` (and the library's,
        as a check of the yardstick), two calls bit for bit (df
        deterministic) and a CUDA-graph replay against the eager call, the
        library's launch (``dwconv1d_bwd_launch_dims``) equal to
        ``bwd_dims``; times (CUDA graphs of 20 calls) beside the plain
        backward and the library's (cuDNN's backward of the same grouped
        conv, dx and df in one ``convolution_backward`` call) and one
        elementwise ``torch.add(x, dy, out=)`` that moves the same bytes
        (x and dy read, one (B, L, D) tensor written: the card's pace for
        this traffic at this size); the kernel's registers a thread
        (ptxas) and its CTAs and cluster.  Bound: the bytes (x, dy, f
        read, dx, df written) and 4BLDK operations."""
        torch = self.torch
        import torch.nn.functional as F
        from repro_torch.kernels import _build, dwconv1d
        x = self.rand((b, length, d), dtype)
        f = self.rand((k, d), dtype, k ** -0.5)
        dy = self.rand((b, length, d), dtype)
        dname = str(dtype).replace("torch.", "")
        vec = dwconv1d.vector_width(x, f, dy)
        label = f"{b}x{length}x{d} k{k} vec {vec}"

        def bwd():
            return dwconv1d.dwconv1d_causal_bwd(x, f, dy)
        before = dwconv1d.bwd_launches
        got, again = bwd(), bwd()
        one_launch = dwconv1d.bwd_launches == before + 2
        side = torch.cuda.Stream(self.dev)
        side.wait_stream(torch.cuda.current_stream(self.dev))
        with torch.cuda.stream(side):
            bwd()
        torch.cuda.current_stream(self.dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            replayed = bwd()
        for t in replayed:
            t.zero_()
        graph.replay()
        want = dwconv1d.dwconv1d_causal_bwd_plain(x, f, dy)
        xt = F.pad(x, (0, 0, k - 1, 0)).transpose(1, 2).contiguous()
        gt = dy.transpose(1, 2).contiguous()
        wt = f.T[:, None, :].contiguous()

        def library():
            return torch.ops.aten.convolution_backward(
                gt, xt, wt, None, [1], [0], [1], False, [0], d,
                [True, True, False])
        lib_dx, lib_df = library()[:2]
        torch.cuda.synchronize(self.dev)
        del graph
        repeats = all(torch.equal(a, c) for a, c in zip(got, again))
        replays = all(torch.equal(a, c) for a, c in zip(got, replayed))
        abs_err = max(float((g.float() - w.float()).abs().max())
                      for g, w in zip(got, want))
        rel = max(self.rel_err(g, w) for g, w in zip(got, want))
        lib_rel = max(self.rel_err(lib_dx[..., k - 1:].transpose(1, 2),
                                   want[0]),
                      self.rel_err(lib_df[:, 0].T, want[1]))
        finite = all(bool(torch.isfinite(g.float()).all()) for g in got)
        tol = KERNEL_TOL[dname]
        dims = dwconv1d.bwd_launch_dims(b, length, d, k, dtype)
        dims_equal = dims == dwconv1d.bwd_dims(b, length, d, k, dtype)
        grid, _, cluster, _ = dims
        regs = bwd_registers(_build.library_path("dwconv1d"), dtype, k,
                             vec > 1)
        ms = self.graph_ms(bwd, self.dev)
        plain_ms = self.time_ms(
            lambda: dwconv1d.dwconv1d_causal_bwd_plain(x, f, dy), self.dev,
            reps=20, warmup=3)
        library_ms = self.graph_ms(library, self.dev)
        out = torch.empty_like(x)
        same_bytes_ms = self.graph_ms(lambda: torch.add(x, dy, out=out),
                                      self.dev)
        es = x.element_size()
        nbytes = (3 * x.numel() + 2 * f.numel()) * es
        ops = 4 * b * length * d * k
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_OPS[dname] * 1e3
        row = {
            "name": "dwconv1d_bwd", "shape": label, "dtype": dname,
            "max_abs_err": abs_err, "max_rel_err": rel, "tol": tol,
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops, "same_bytes_add_ms": same_bytes_ms,
            "registers": regs,
            "ctas": grid[0] * grid[1] * grid[2], "cluster": cluster[0],
            "one_launch": one_launch, "launch_dims_equal": dims_equal,
            "repeats_bit_for_bit": repeats, "graph_replay_equal": replays,
            "library_rel_err": lib_rel}
        print(f"  {'dwconv1d backward':17s} {label:44s} {dname:8s} rel err "
              f"{rel:.2e} (tol {tol:g}; library {lib_rel:.2e}); one launch "
              f"{ms:.4f} ms ({row['bound_ms'] / ms:.0%} of the bound "
              f"{row['bound_ms']:.4f} ms, {row['bound_by']}), plain "
              f"{plain_ms:.4f} ms, library {library_ms:.4f} ms, an add of "
              f"the same bytes {same_bytes_ms:.4f} ms; {regs} "
              f"registers, {row['ctas']} CTAs in clusters of {cluster[0]}; "
              f"two calls equal {repeats}, graph replay equal {replays}",
              flush=True)
        if not (finite and rel <= tol and repeats and replays and one_launch
                and dims_equal):
            raise AssertionError(f"dwconv1d backward {label} {dname}: rel "
                                 f"err {rel} > {tol} (finite={finite}), two "
                                 f"calls equal {repeats}, graph replay "
                                 f"equal {replays}, one launch a call "
                                 f"{one_launch}, launch dims {dims} vs the "
                                 f"model's {dims_equal}")
        self.results.append(row)

    def fused(self, b, h, w, ci, c, co, stride, residual, dtype, k=3):
        """One block as the main path runs it: x unpadded, the kernel
        applying the SAME padding itself, at the planner's slab, cluster,
        chunk and panel; its shared memory against the kernel's own count;
        the CTA count printed.  The library yardstick composes the same
        function: matmul, depthwise conv + bias, relu6, matmul + bias,
        activation, residual add."""
        torch = self.torch
        import torch.nn.functional as F
        from repro_torch.kernels import blocking, ref, separable_fused
        expand = ci != c
        x = self.rand((b, h, w, ci), dtype)
        pad = ref.same_pads(h, w, k, k, stride)
        xp = self.pad_same(x, k, k, stride)
        ew = self.rand((ci, c), dtype, ci ** -0.5) if expand else None
        f = self.rand((k, k, c), dtype, 1 / k)
        dwb = self.rand((c,), dtype, 0.1)
        pw = self.rand((c, co), dtype, c ** -0.5)
        pwb = self.rand((co,), dtype, 0.1)
        res = x if residual else None
        ho, wo = -(-h // stride), -(-w // stride)
        plan = blocking.plan_separable_fused(
            ho, wo, ci if expand else 0, c, co, stride=stride, hf=k, wf=k,
            dtype=dtype, batch=b, hi=h, wi=w)
        self.same_smem(plan.smem_bytes, separable_fused.smem_bytes(
            ci if expand else 0, plan.block_g, plan.block_c, plan.block_co,
            plan.cluster, plan.slab_h, wo, h, w, k, k, stride, expand,
            dtype))
        act = None if expand else "relu6"
        kw = dict(expand_w=ew, stride=stride, dw_activation="relu6",
                  activation=act)
        fc = f.permute(2, 0, 1)[:, None].contiguous()

        def library():
            y = torch.matmul(xp, ew).clamp_(0, 6) if expand else xp
            y = F.conv2d(y.permute(0, 3, 1, 2), fc, dwb, stride=stride,
                         groups=c).clamp_(0, 6)
            y = torch.matmul(y.permute(0, 2, 3, 1), pw).add_(pwb)
            if act:
                y = y.clamp_(0, 6)
            return y.add_(res) if residual else y

        ops = 2 * b * ho * wo * c * (k * k + co)
        if expand:
            ops += 2 * b * h * w * ci * c
        nbytes = (x.numel() + f.numel() + c + pw.numel() + co
                  + (ew.numel() if expand else 0)
                  + (res.numel() if residual else 0) + b * ho * wo * co)
        name = "separable_fused3" if expand else "separable_fused2"
        label = (f"{b}x{h}x{w}x{ci}" + (f"(x{c})" if expand else "")
                 + f"->{co} k{k} s{stride}" + (" +res" if residual else "")
                 + f" slab {plan.slab_h} cl {plan.cluster} cb "
                 f"{plan.block_c} np {plan.block_co}")
        blocks = dict(slab_h=plan.slab_h, block_c=plan.block_c,
                      block_co=plan.block_co, cluster=plan.cluster)
        self.measure(
            name, label, dtype,
            lambda: separable_fused.separable_fused(
                x, f, pw, dwb, pwb, res, pad=pad, **blocks, **kw),
            lambda: separable_fused.separable_fused_plain(
                xp, f, pw, dwb, pwb, res, **kw),
            library, ops, nbytes * x.element_size(),
            extra={"ctas": plan.ctas})

    @staticmethod
    def same_smem(planned, kernel):
        if kernel != planned:
            raise AssertionError(f"planner models {planned} B of shared "
                                 f"memory, the kernel {kernel}")

    def fused_mb(self, b, h, w, ci, c, co, stride, residual, dtype, k=3):
        """One block as the main path runs it: x unpadded, the kernel
        applying the SAME padding itself, at the planner's slab, cluster,
        chunk and panel; its shared memory against the kernel's own count;
        the CTA count and cluster printed.  The library yardstick composes
        the same function: ``F.conv2d`` + bias, relu6, ``addmm`` + bias,
        the residual add."""
        torch = self.torch
        import torch.nn.functional as F
        from repro_torch.kernels import blocking, fused_mbconv, ref
        x_raw = self.rand((b, h, w, ci), dtype)
        x = self.pad_same(x_raw, k, k, stride)
        pad = ref.same_pads(h, w, k, k, stride)
        f = self.rand((k, k, ci, c), dtype, (k * k * ci) ** -0.5)
        fb = self.rand((c,), dtype, 0.1)
        pw = self.rand((c, co), dtype, c ** -0.5)
        pwb = self.rand((co,), dtype, 0.1)
        res = x_raw if residual else None
        ho, wo = -(-h // stride), -(-w // stride)
        plan = blocking.plan_fused_mb(ho, wo, ci, c, co, stride=stride,
                                      hf=k, wf=k, dtype=dtype, batch=b)
        self.same_smem(plan.smem_bytes, fused_mbconv.smem_bytes(
            ci, plan.block_g, plan.block_c, plan.block_co, plan.slab_h,
            plan.tile_w, k, k, stride, dtype))
        kw = dict(stride=stride, mb_activation="relu6", activation=None)
        blocks = dict(slab_h=plan.slab_h, tile_w=plan.tile_w,
                      block_c=plan.block_c, block_co=plan.block_co,
                      cluster=plan.cluster)
        xc = x.permute(0, 3, 1, 2)
        fc = f.permute(3, 2, 0, 1).contiguous()

        def library():
            y = F.conv2d(xc, fc, fb, stride=stride).clamp_(0, 6)
            y = torch.addmm(pwb, y.permute(0, 2, 3, 1).reshape(-1, c), pw)
            return y.view(res.shape).add_(res) if residual else y

        ops = 2 * b * ho * wo * c * (k * k * ci + co)
        nbytes = (x_raw.numel() + f.numel() + c + pw.numel() + co
                  + (res.numel() if residual else 0) + b * ho * wo * co)
        self.measure(
            "fused_mbconv",
            f"{b}x{h}x{w}x{ci}(x{c})->{co} k{k} s{stride}"
            + (" +res" if residual else "")
            + f" slab {plan.slab_h} cl {plan.cluster} cb {plan.block_c}",
            dtype,
            lambda: fused_mbconv.fused_mbconv(x_raw, f, pw, fb, pwb, res,
                                              pad=pad, **blocks, **kw),
            lambda: fused_mbconv.fused_mbconv_plain(x, f, pw, fb, pwb, res,
                                                    **kw),
            library, ops, nbytes * x.element_size(),
            extra={"ctas": plan.ctas, "cluster": plan.cluster})

    def dw_se(self, b, h, w, c, c_se, stride, dtype, k=3):
        """One SE block as the main path runs it: x unpadded, the kernel
        applying the SAME padding itself, at the planner's tile; each
        pass's shared memory against the kernel's own count and the CTAs a
        pass printed; two calls give the same bits, and a CUDA graph of
        the call replays them."""
        torch = self.torch
        import torch.nn.functional as F
        from repro_torch.kernels import blocking, ref, se_epilogue
        x_raw = self.rand((b, h, w, c), dtype)
        x = self.pad_same(x_raw, k, k, stride)
        pad = ref.same_pads(h, w, k, k, stride)
        f = self.rand((k, k, c), dtype, 1 / k)
        w1, b1, w2, b2 = gate = (self.rand((c, c_se), dtype, c ** -0.5),
                                 self.rand((c_se,), dtype, 0.1),
                                 self.rand((c_se, c), dtype, c_se ** -0.5),
                                 self.rand((c,), dtype, 0.1))
        ho, wo = -(-h // stride), -(-w // stride)
        plan = blocking.plan_dw_se_tile(ho, wo, c, c_se, k, k, stride=stride,
                                        dtype=dtype, batch=b)
        tile = (plan.slab_h, plan.tile_w, plan.block_c)
        for pass_ in (1, 2):
            args = (pass_, *tile, k, k, stride, c_se, dtype)
            self.same_smem(blocking.dw_se_smem_bytes(*args),
                           se_epilogue.smem_bytes(*args))
        kw = dict(stride=stride, dw_activation="relu", se_activation="relu")
        call = lambda: se_epilogue.dw_se(x_raw, f, *gate, pad=pad,  # noqa: E731
                                         **kw)
        first, second = call(), call()
        graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream(self.dev)
        side.wait_stream(torch.cuda.current_stream(self.dev))
        with torch.cuda.stream(side):
            call()
        torch.cuda.current_stream(self.dev).wait_stream(side)
        with torch.cuda.graph(graph):
            replayed = call()
        replayed.zero_()
        graph.replay()
        torch.cuda.synchronize(self.dev)
        repeats = bool(torch.equal(first, second))
        replays = bool(torch.equal(first, replayed))
        del graph
        if not (repeats and replays):
            raise AssertionError(f"dw_se {b}x{h}x{w}x{c}: two calls equal "
                                 f"{repeats}, graph replay equal {replays}")
        xc = x.permute(0, 3, 1, 2)
        fc = f.permute(2, 0, 1)[:, None].contiguous()

        def library():
            y = F.conv2d(xc, fc, stride=stride, groups=c).relu_()
            hid = torch.addmm(b1, y.mean(dim=(2, 3)), w1).relu_()
            gate = torch.sigmoid(torch.addmm(b2, hid, w2))
            return y * gate[:, :, None, None]

        npix = b * ho * wo * c
        ops = 2 * npix * k * k + 2 * npix + 4 * b * c * c_se
        nbytes = (x_raw.numel() + f.numel() + 2 * c * c_se + c_se + c + npix)
        self.measure(
            "dw_se", f"{b}x{h}x{w}x{c} k{k} s{stride} Cse {c_se} tile "
            f"{plan.slab_h}x{plan.tile_w}x{plan.block_c}", dtype, call,
            lambda: se_epilogue.dw_se_plain(x, f, *gate, **kw),
            library, ops, nbytes * x.element_size(),
            extra={"ctas_per_pass": plan.ctas,
                   "repeats_bit_for_bit": repeats,
                   "graph_replay_equal": replays})


def pct(x):
    """A busy share, or "not profiled" where the profiler saw no device
    time."""
    return "not profiled" if x is None else f"{x:.0%}"


def run_networks(torch, dev):
    """The main path: execute_network (one CUDA graph a forward) and its
    eager runner on V1, V2, MnasNet-A1 and Lite0 at 112x112, every plan,
    dtype and batch; then MnasNet-A1 at 224x224, batch 8, default plan,
    fp32 and bf16.  The wrappers' counters must move by two forwards in the
    graph path's first call (its warm-up and its capture), by none in a
    later call (a replay runs no wrapper) and by one forward in an eager
    call; the kernels one replay ran are counted in a profiler trace and
    must be one forward's.  Returns the runs, the wrappers' launches by
    kernel, the kernels the profiled replays ran, and ``pwconv``'s
    launches by variant."""
    from repro_torch.mobilenet_inference import (ARCHS, KERNEL_SEGMENTS,
                                                 expected_launches,
                                                 run_network)
    totals = dict.fromkeys(KERNEL_SEGMENTS, 0)
    replayed = dict.fromkeys(KERNEL_SEGMENTS, 0)
    variants = {}
    runs = []

    def one(arch, res, fused, batch, dtype):
        r = run_network(ARCHS[arch](1.0), res=res, batch=batch, dtype=dtype,
                        fused=fused, device=dev)
        want = dict.fromkeys(KERNEL_SEGMENTS, 0)
        want.update(EXPECTED_LAUNCHES[(arch, fused)])
        plan_counts = expected_launches(r["histogram"])
        plan_name = "default" if fused is None else "fused=False"
        label = f"{arch} {res}x{res} {plan_name} batch {batch} {dtype}"
        print(f"  {label}: graph {r['ms']:.3f} ms/forward (busy "
              f"{pct(r['busy'])}, own peak {r['peak_bytes'] / 2**20:.1f} MiB,"
              f" reserved {r['reserved_bytes'] / 2**20:.1f} MiB, held "
              f"{r['held_bytes'] / 2**20:.1f} MiB), eager "
              f"{r['eager_ms']:.3f} ms/forward (busy {pct(r['eager_busy'])}, "
              f"own peak {r['eager_peak_bytes'] / 2**20:.1f} MiB); captured "
              f"in {r['capture_s'] * 1e3:.1f} ms; graph equals eager: "
              f"{r['graph_equals_eager']}; rel err {r['rel_err']:.2e} (tol "
              f"{r['tol']:g}), launches {r['eager_launches']} (eager), "
              f"{r['replay_launches']} (a replay, profiler)", flush=True)
        if fused is None:
            print(f"    separable_fused CTAs per launch: {r['fused_ctas']}; "
                  f"fused_mbconv (CTAs, cluster) per launch: "
                  f"{r['fused_mbconv_ctas_cluster']}; dw_se CTAs a pass per "
                  f"launch: {r['dw_se_ctas']}", flush=True)
        for name, pre in (("graph", ""), ("eager", "eager_")):
            dms = r[pre + "device_ms"]
            print(f"    {name} device {sum(dms.values()):.3f} ms/forward: "
                  + ", ".join(f"{k} {v:.3f}" for k, v in sorted(dms.items())),
                  flush=True)
        print(f"    pwconv by variant {r['pwconv_variants']} (eager), "
              f"{r['replay_pwconv_variants']} (a replay); traces retaken "
              f"for lost records {r['profile_retries']}", flush=True)
        check_variants(label, r["pwconv_variants"],
                       r["eager_launches"]["pwconv"], dtype)
        check_variants(label + " replay", r["replay_pwconv_variants"],
                       r["replay_launches"]["pwconv"], dtype)
        for k, v in r["pwconv_variants"].items():
            variants[k] = variants.get(k, 0) + v
        twice = {k: 2 * n for k, n in want.items()}
        if (r["first_call_launches"] != twice
                or any(r["later_call_launches"].values())
                or r["eager_launches"] != want
                or r["replay_launches"] != want or plan_counts != want):
            raise AssertionError(
                f"{label}: launches {r['first_call_launches']} (capturing "
                f"call), {r['later_call_launches']} (later call), "
                f"{r['eager_launches']} (eager), {r['replay_launches']} (a "
                f"replay, profiler), plan {plan_counts}, expected {want} a "
                f"forward")
        if not r["graph_equals_eager"]:
            raise AssertionError(f"{label}: the graph's output is not the "
                                 f"eager runner's (rel "
                                 f"{r['graph_vs_eager_rel_err']:.2e})")
        if not (r["finite_and_shaped"] and r["rel_err"] <= r["tol"]):
            raise AssertionError(f"{label}: rel err {r['rel_err']} > "
                                 f"{r['tol']} or bad output")
        for k in totals:
            totals[k] += (r["first_call_launches"][k]
                          + r["later_call_launches"][k]
                          + r["eager_launches"][k])
            replayed[k] += r["replay_launches"][k]
        runs.append({"arch": arch, "res": res, "plan": plan_name,
                     "batch": batch, "dtype": dtype,
                     **{k: r[k] for k in (
                         "ms", "eager_ms", "busy", "eager_busy",
                         "peak_bytes", "eager_peak_bytes", "reserved_bytes",
                         "held_bytes", "profile_retries", "capture_s",
                         "device_ms",
                         "eager_device_ms", "rel_err", "graph_equals_eager",
                         "first_call_launches", "later_call_launches",
                         "eager_launches", "replay_launches",
                         "pwconv_variants", "replay_pwconv_variants",
                         "dw_se_ctas", "out_shape", "fused_ctas",
                         "fused_mbconv_ctas_cluster")}})

    for arch in ARCHS:
        for fused in (None, False):
            for batch in (1, 8):
                for dtype in ("fp32", "bf16"):
                    one(arch, 112, fused, batch, dtype)
    for dtype in ("fp32", "bf16"):
        one("mnasnet", 224, None, 8, dtype)
    return runs, totals, replayed, variants


def check_variants(label, got, total, dtype, phase=None):
    """``pwconv``'s launches by variant in one counted call: every one
    counted once; a decode step streams every Linear; otherwise no fp32
    product reaches the tensor cores and no bf16 one (G > 16, rows TMA can
    describe, as every CNN and xLSTM width is) stays on the CUDA cores."""
    if sum(got.values()) != total:
        raise AssertionError(f"{label}: pwconv launches {total}, by variant "
                             f"{got}")
    if phase == "decode":
        bad = total - got["stream"]
    elif dtype in ("fp32", "float32"):
        bad = got["tc"]
    else:
        bad = got["simt"]
    if bad:
        raise AssertionError(f"{label} {phase or ''}: pwconv by variant "
                             f"{got}")


#: The kernels the four bodies' default plans launch, which the tuning
#: phase must launch (``dwconv2d`` runs only the ``fused=False`` plans).
TUNED_KERNELS = ("separable_fused2", "separable_fused3", "fused_mbconv",
                 "dw_se", "pwconv")
#: The tuning phase's input resolution (the body input of a 224 image).
TUNE_RES = 112


def _plan_changes(analytic, tuned):
    """``block.segment (kind): field old->new, ...`` for every segment whose
    tuned plan differs from the analytic one."""
    import dataclasses
    out = []
    for bi, (a, t) in enumerate(zip(analytic.plans, tuned.plans)):
        for si, (sa, st) in enumerate(zip(a.segments, t.segments)):
            diff = [f"{f.name} {getattr(sa.plan, f.name)}->"
                    f"{getattr(st.plan, f.name)}"
                    for f in dataclasses.fields(sa.plan)
                    if getattr(sa.plan, f.name) != getattr(st.plan, f.name)]
            if diff:
                out.append(f"{bi}.{si} ({sa.kind}): {', '.join(diff)}")
    return out


def run_tuning(torch, dev):
    """The measured autotuner on the four bodies at 112x112, batch 1 and 8,
    fp32 and bf16, default plan, each into a fresh tune cache in a
    temporary directory under ``build/``: ``tune_network`` (its launches
    counted: this path's own window), then a second ``tune_network`` on the
    file loaded again, which must be a cache hit that measures nothing and
    launches nothing; every chain plan the tuner measured runs once more on
    its block's input and is held against the block's plain version
    (KERNEL_TOL); then ``execute_network`` at the tuned plan
    (``autotune=True``) and at the analytic one, in turns (tuned,
    analytic, analytic, tuned, tuned, analytic): the first tuned call must
    capture exactly two forwards (no measurement), the tuned graph's output
    must be the tuned eager runner's bits and within FP32_REL_TOL /
    BF16_REL_TOL of the fp32 plain path; each path's graph ms (CUDA
    events, median of 10, three readings) and the device ms of a profiled
    replay.  Every tune must fold no candidate's failure: its result's and
    every cache entry's ``failed`` list is empty.  Returns the runs, the
    launches of the tunes by kernel, and each run's tuned network plan as
    ``(label, net, plan, policy)`` for :func:`run_static`."""
    import dataclasses
    import shutil
    import tempfile
    from repro_torch import graphs
    from repro_torch.core import network
    from repro_torch.kernels import autotune, lowering
    from repro_torch.kernels.policy import BF16_STREAM, NATIVE, KernelPolicy
    from repro_torch.measure import device_profile, rel_err, time_ms
    from repro_torch.mobilenet_inference import (ARCHS, KERNEL_SEGMENTS,
                                                 expected_launches)
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tune_",
                           dir=os.path.join(HERE, "build"))
    launched = dict.fromkeys(KERNEL_SEGMENTS, 0)
    runs = []

    def one(arch, batch, dtype):
        net = ARCHS[arch](1.0)
        label = f"{arch} {TUNE_RES}x{TUNE_RES} batch {batch} {dtype}"
        bf16 = dtype == "bf16"
        params32 = network.init_network(net, seed=0, device=dev)
        params = (network.cast_network_params(params32, torch.bfloat16)
                  if bf16 else params32)
        x = torch.randn((batch, TUNE_RES, TUNE_RES, net.c_in),
                        generator=torch.Generator().manual_seed(1)).to(dev)
        pol = KernelPolicy(dtype_policy=BF16_STREAM if bf16 else NATIVE,
                           autotune=True, tune_cache=os.path.join(
                               tmp, f"{arch}_{batch}_{dtype}.json"))
        analytic = dataclasses.replace(pol, autotune=False, tune_cache=None)
        # the tune, counted
        graphs.reset()
        t0 = time.perf_counter()
        r = network.tune_network(net, params, x, policy=pol)
        torch.cuda.synchronize(dev)
        tune_s = time.perf_counter() - t0
        counts = graphs.snapshot()
        for k in launched:
            launched[k] += counts[k]
        if r.cache_hit or not r.n_measured:
            raise AssertionError(f"{label}: the first tune into a fresh "
                                 f"cache was a hit ({r.n_measured} measured)")
        # no candidate failed: the tuner folded nothing into an infinite time
        entries = autotune.TuneCache.load(pol.tune_cache).entries
        folded = {k: e.get("failed") for k, e in entries.items()
                  if e.get("failed") != []}
        if r.failed or folded:
            raise AssertionError(f"{label}: the tune folded failures "
                                 f"{list(r.failed)[:3]} (entries {folded})")
        # the replay, on the file loaded again
        graphs.reset()
        r2 = network.tune_network(net, params, x, policy=pol)
        moved = {k: n for k, n in graphs.snapshot().items() if n}
        if not r2.cache_hit or r2.n_measured or moved or r2.plan != r.plan:
            raise AssertionError(
                f"{label}: the second tune_network was not a hit that "
                f"measured nothing (hit {r2.cache_hit}, {r2.n_measured} "
                f"measured, launches {moved}, same plan "
                f"{r2.plan == r.plan})")
        # every measured chain plan on its block against the plain version
        policies = network.resolve_block_policies(net, pol)
        by_block = {}
        for bi, cp, _ in r.measured:
            by_block.setdefault(bi, []).append(cp)
        tol = KERNEL_TOL["bfloat16" if bf16 else "float32"]
        worst, checked = 0.0, 0
        y = x
        with torch.inference_mode():
            for bi, (spec, p, bpol) in enumerate(zip(net.blocks, params,
                                                     policies)):
                want = lowering.lower(spec, r.plan.plans[bi],
                                      dataclasses.replace(bpol, impl="torch",
                                                          autotune=False)
                                      )(p, y)
                for cp in by_block.get(bi, ()):
                    err = rel_err(lowering.lower(spec, cp, bpol)(p, y), want)
                    checked += 1
                    worst = max(worst, err)
                    if not err <= tol:
                        raise AssertionError(
                            f"{label} block {bi}: measured plan {cp} is "
                            f"{err:.2e} from the plain version (tol {tol})")
                y = lowering.lower(spec, r.plan.plans[bi], bpol)(p, y)
        # the tuned and the analytic graph path, in turns
        network.clear_network_cache()
        nplan = network.plan_network(net, x.shape, dtype=x.dtype,
                                     policy=analytic, device=dev)
        want = {k: 2 * n for k, n in expected_launches(
            r.plan.segment_histogram()).items()}
        graphs.reset()
        y_tuned, _ = network.execute_network_graph(net, params, x,
                                                   policy=pol)
        counts = {k: graphs.snapshot()[k] for k in KERNEL_SEGMENTS}
        if counts != want:
            raise AssertionError(f"{label}: the tuned graph's first call "
                                 f"launched {counts}, not two forwards' "
                                 f"{want}")
        with torch.inference_mode():
            y_eager = network.build_network_fn(net, r.plan, pol)(params, x)
            plain = KernelPolicy(impl="torch")
            ref = network.build_network_fn(
                net, network.plan_network(net, x.shape, policy=plain),
                plain)(params32, x)
        forward = {name: (lambda q=q: network.execute_network(
            net, params, x, policy=q)) for name, q in (("tuned", pol),
                                                       ("analytic", analytic))}
        ms = {"tuned": [], "analytic": []}
        for name in ("tuned", "analytic", "analytic", "tuned", "tuned",
                     "analytic"):
            ms[name].append(time_ms(forward[name], dev))
        device_ms = {name: sum(device_profile(fn, reps=2)[0].values())
                     for name, fn in forward.items()}
        err = rel_err(y_tuned, ref)
        rel_tol = BF16_REL_TOL if bf16 else FP32_REL_TOL
        network.clear_network_cache()
        changes = _plan_changes(nplan, r.plan)
        run = {"arch": arch, "batch": batch, "dtype": dtype,
               "n_measured": r.n_measured, "tune_s": tune_s,
               "measured_us": r.measured_us, "analytic_us": r.analytic_us,
               "candidates_checked": checked, "candidate_worst_rel": worst,
               "graph_ms": ms, "device_ms": device_ms,
               "graph_equals_eager": bool(torch.equal(y_tuned, y_eager)),
               "rel_err": err, "changes": changes}
        print(f"  {label}: {r.n_measured} plans measured in {tune_s:.1f} s; "
              f"sum of block winners {r.measured_us:.1f} us against "
              f"analytic {r.analytic_us:.1f} us; {checked} measured plans "
              f"within {worst:.2e} of the plain version; graph ms tuned "
              f"{'/'.join(f'{v:.4f}' for v in ms['tuned'])}, analytic "
              f"{'/'.join(f'{v:.4f}' for v in ms['analytic'])}; device ms "
              f"tuned {device_ms['tuned']:.4f}, analytic "
              f"{device_ms['analytic']:.4f}; rel err {err:.2e} (tol "
              f"{rel_tol:g}); {len(changes)} segments changed plan",
              flush=True)
        for c in changes:
            print(f"    {c}", flush=True)
        if not run["graph_equals_eager"]:
            raise AssertionError(f"{label}: the tuned graph's output is not "
                                 "the tuned eager runner's")
        if not (bool(torch.isfinite(y_tuned.float()).all())
                and tuple(y_tuned.shape) == r.plan.out_shape
                and err <= rel_tol):
            raise AssertionError(f"{label}: tuned rel err {err} > {rel_tol} "
                                 "or bad output")
        runs.append(run)
        tuned.append((label, net, r.plan, analytic))

    tuned = []
    try:
        for arch in ARCHS:
            for batch in (1, 8):
                for dtype in ("fp32", "bf16"):
                    one(arch, batch, dtype)
    finally:
        shutil.rmtree(tmp)
    for k in TUNED_KERNELS:
        if not launched[k]:
            raise AssertionError(f"kernel {k} was launched no time by the "
                                 f"tunes: {launched}")
    return runs, launched, tuned


def run_static(torch, dev, runs, tuned):
    """Static verification, traffic models and shims:

    1. ``analysis.analyze_network`` (static passes) on every plan the main
       path and the tuning phase run (four bodies at 112x112, batch 1 and
       8, fp32 and bf16, default and ``fused=False``; MnasNet-A1 at
       224x224 batch 8; every tuned winner) and on every ladder candidate
       of their segments (``autotune.segment_candidates``): no error;
    2. every launch model of those plans and candidates
       (``gridspec.segment_models``) equal to its library's own
       ``<kernel>_launch_dims`` (the function its launch calls): grid,
       block, cluster and shared memory;
    3. the trace audit run on the card (JX301 counted from the launch
       counters) on the four bodies at batch 1, fp32, default plan;
    4. ``execute_network`` under ``KernelPolicy(verify=True)`` against the
       default on the four bodies at batch 8, fp32 and bf16: the same plan,
       launches (the graph's first call) and output bits;
    5. the modeled device-memory MB of a forward (``core/intensity``,
       ``mobilenet_inference.modeled_traffic``) of each body at batch 8 in
       both dtypes, beside the graph path's device ms from the main-path
       phase and the resulting modeled GB/s (no bar);
    6. the block shims ``separable_block`` (V1's 56x56x128 block) and
       ``inverted_residual`` (V2's 56x56x24 expand-6 block with its
       residual), batch 8, fp32 and bf16, through the kernels (one
       ``separable_fused`` launch each) against their plain path
       (KERNEL_TOL)."""
    import dataclasses
    from repro_torch import analysis, graphs
    from repro_torch.analysis import launch_check, planlint
    from repro_torch.core import network, separable
    from repro_torch.kernels import autotune, gridspec
    from repro_torch.kernels.policy import (BF16_STREAM, DTYPES, NATIVE,
                                            KernelPolicy)
    from repro_torch.measure import rel_err
    from repro_torch.mobilenet_inference import (ARCHS, KERNEL_SEGMENTS,
                                                 modeled_traffic)
    plans = []
    for arch in ARCHS:
        net = ARCHS[arch](1.0)
        for fused in (None, False):
            for batch in (1, 8):
                for dtype in ("fp32", "bf16"):
                    pol = KernelPolicy(fused=fused, dtype_policy=(
                        BF16_STREAM if dtype == "bf16" else NATIVE))
                    plans.append((
                        f"{arch} 112x112 {'default' if fused is None else 'fused=False'}"
                        f" batch {batch} {dtype}", net,
                        network.plan_network(net, (batch, 112, 112, net.c_in),
                                             policy=pol, device=dev), pol))
    net = ARCHS["mnasnet"](1.0)
    for dtype in ("fp32", "bf16"):
        pol = KernelPolicy(dtype_policy=BF16_STREAM if dtype == "bf16"
                           else NATIVE)
        plans.append((f"mnasnet 224x224 default batch 8 {dtype}", net,
                      network.plan_network(net, (8, 224, 224, net.c_in),
                                           policy=pol, device=dev), pol))
    plans += [(f"tuned {label}", n, p, q) for label, n, p, q in tuned]
    # 1. the plans and every ladder candidate of their segments
    models, n_cands, errors, infos = {}, 0, [], 0
    for label, net, nplan, pol in plans:
        rep = analysis.analyze_network(net, nplan, policy=pol, trace=False)
        errors += [f"{label}: {d.format()}" for d in rep.errors]
        infos += sum(d.severity == "info" for d in rep.diagnostics)
        for spec, cp, shape, dt, bpol in zip(
                net.blocks, nplan.plans, nplan.block_shapes,
                nplan.block_dtypes, network.resolve_block_policies(net, pol)):
            sdt = bpol.dtype_policy.stream_dtype(DTYPES[dt])
            geoms = planlint.walk_segments(spec, cp, shape)
            for si, (geom, seg) in enumerate(zip(geoms, cp.segments)):
                for cand in autotune.segment_candidates(
                        geom, seg.plan, sdt, cp.smem_budget):
                    for m in gridspec.segment_models(geom, cand, sdt):
                        models.setdefault((m.library, m.library_args), m)
                    if cand == seg.plan:
                        continue
                    n_cands += 1
                    ccp = autotune._with_segment_plan(cp, si, cand)
                    diags = planlint.lint_chain(spec, ccp, shape, dtype=sdt)
                    for m in gridspec.segment_models(geom, cand, sdt):
                        diags += launch_check.lint_model(m)
                    errors += [f"{label} candidate {cand}: {d.format()}"
                               for d in diags if d.severity == "error"]
    # 2. every launch model against its library's own launch
    mismatches = []
    for (lib, args), m in models.items():
        got = gridspec.library_dims(m)
        if got != m.dims():
            mismatches.append(f"{m.name}{args}: model {m.dims()}, library "
                              f"{got}")
    print(f"  static passes: {len(plans)} network plans "
          f"({sum(p.n_blocks for _, _, p, _ in plans)} chains) and "
          f"{n_cands} ladder candidates linted, {len(errors)} errors, "
          f"{infos} info diagnostics on the plans; {len(models)} distinct "
          f"launch models against their libraries' <kernel>_launch_dims: "
          f"{len(mismatches)} mismatches", flush=True)
    if errors or mismatches:
        raise AssertionError(f"static verification: errors {errors[:5]}, "
                             f"launch-dims mismatches {mismatches[:5]}")
    # 3. the trace audit on the card
    for arch in ARCHS:
        net = ARCHS[arch](1.0)
        nplan = network.plan_network(net, (1, 112, 112, net.c_in),
                                     device=dev)
        rep = analysis.analyze_network(net, nplan, device=dev)
        jx = [d.format() for d in rep.diagnostics if d.rule.startswith("JX")]
        if jx or not rep.ok:
            raise AssertionError(f"{arch}: the trace audit on the card: "
                                 f"{jx or rep.format()}")
    print(f"  trace audit on the card (JX301 from the launch counters): "
          f"{', '.join(ARCHS)} at batch 1, no JX diagnostic", flush=True)
    # 4. verify=True against the default
    verified = []
    for arch in ARCHS:
        net = ARCHS[arch](1.0)
        params32 = network.init_network(net, seed=0, device=dev)
        x = torch.randn((8, 112, 112, net.c_in),
                        generator=torch.Generator().manual_seed(1)).to(dev)
        for dtype in ("fp32", "bf16"):
            bf16 = dtype == "bf16"
            params = (network.cast_network_params(params32, torch.bfloat16)
                      if bf16 else params32)
            base = KernelPolicy(dtype_policy=BF16_STREAM if bf16 else NATIVE)
            got = {}
            for name, q in (("default", base),
                            ("verify", dataclasses.replace(base,
                                                           verify=True))):
                network.clear_network_cache()
                graphs.reset()
                y, _ = network.execute_network_graph(net, params, x, policy=q)
                torch.cuda.synchronize(dev)
                counts = graphs.snapshot()
                got[name] = (network.plan_network(net, x.shape,
                                                  dtype=x.dtype, policy=q,
                                                  device=dev).plans,
                             {k: counts[k] for k in KERNEL_SEGMENTS}, y)
            network.clear_network_cache()
            same = (got["default"][0] == got["verify"][0]
                    and got["default"][1] == got["verify"][1]
                    and bool(torch.equal(got["default"][2],
                                         got["verify"][2])))
            verified.append({"arch": arch, "dtype": dtype, "same": same,
                             "launches": got["verify"][1]})
            if not same:
                raise AssertionError(f"{arch} batch 8 {dtype}: verify=True "
                                     "changed the plan, the launches or the "
                                     "bits")
    print(f"  verify=True: the same plan, launches and bits as the default "
          f"on {len(verified)} runs ({', '.join(ARCHS)} at batch 8, fp32 and "
          f"bf16)", flush=True)
    # 5. the modeled device-memory traffic beside the measured device time
    traffic = []
    for arch in ARCHS:
        net = ARCHS[arch](1.0)
        for dtype in ("fp32", "bf16"):
            pol = KernelPolicy(dtype_policy=BF16_STREAM if dtype == "bf16"
                               else NATIVE)
            nplan = network.plan_network(net, (8, 112, 112, net.c_in),
                                         policy=pol, device=dev)
            t = modeled_traffic(net, nplan, pol)
            run = next(r for r in runs if r["arch"] == arch
                       and r["res"] == 112 and r["plan"] == "default"
                       and r["batch"] == 8 and r["dtype"] == dtype)
            ms = sum(run["device_ms"].values())
            gbs = t["bytes"] / (ms * 1e-3) / 1e9 if ms else None
            traffic.append({"arch": arch, "dtype": dtype,
                            "modeled_mb": t["bytes"] / 1e6,
                            "fp32_fused_mb": t["fp32_fused_bytes"] / 1e6,
                            "unfused_mb": t["unfused_bytes"] / 1e6,
                            "intensity": t["intensity"],
                            "device_ms": ms, "modeled_gb_s": gbs})
            print(f"  modeled HBM {arch} 112x112 batch 8 {dtype}: "
                  f"{t['bytes'] / 1e6:.2f} MB a forward (fp32 fused "
                  f"{t['fp32_fused_bytes'] / 1e6:.2f}, per-block unfused "
                  f"{t['unfused_bytes'] / 1e6:.2f}; AI {t['intensity']:.1f} "
                  f"FLOPs/B), graph path device {ms:.4f} ms -> modeled "
                  + (f"{gbs:.1f} GB/s" if gbs else "not measured"),
                  flush=True)
    # 6. the block shims on the card
    shims = []
    gen = torch.Generator().manual_seed(2)
    for name, init, call, c_in, c_out, counter in (
            ("separable_block", separable.init_separable,
             separable.separable_block, 128, 128, "separable_fused2"),
            ("inverted_residual", separable.init_inverted_residual,
             separable.inverted_residual, 24, 24, "separable_fused3")):
        p32 = init(gen, c_in, c_out, device=dev)
        x32 = torch.randn((8, 56, 56, c_in), generator=gen).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            p = {k: v.to(dtype) for k, v in p32.items()}
            x = x32.to(dtype)
            graphs.reset()
            y = call(p, x)
            torch.cuda.synchronize(dev)
            launched = graphs.snapshot()[counter]
            want = call(p, x, policy=KernelPolicy(impl="torch"))
            dname = str(dtype).removeprefix("torch.")
            err = rel_err(y, want)
            shims.append({"shim": name, "dtype": dname, "rel_err": err,
                          "launches": launched})
            print(f"  {name} 8x56x56x{c_in}->{c_out} {dname}: {counter} "
                  f"launched {launched}x, rel err {err:.2e} against the "
                  f"plain path (tol {KERNEL_TOL[dname]:g})", flush=True)
            if (launched != 1 or not err <= KERNEL_TOL[dname]
                    or not bool(torch.isfinite(y.float()).all())):
                raise AssertionError(f"{name} {dname}: {launched} launches, "
                                     f"rel err {err}")
    return {"plans": len(plans), "candidates": n_cands,
            "launch_models": len(models), "mismatches": len(mismatches),
            "info": infos, "verify": verified, "traffic": traffic,
            "shims": shims}


#: The runtime phase's recovery rows: (body, fused, point armed, times,
#: numeric guard, the rungs the quarantine must then ban).  The lowering
#: points stay armed (persistent) through both calls; the whole-network
#: points fire once.
RECOVERY_ROWS = (
    ("v2", None, "lowering:separable_fused", -1, False, {"fused2", "fused3"}),
    ("mnasnet", None, "lowering:se_epilogue", -1, False, {"dw_se", "unfused"}),
    ("lite0", None, "lowering:fused_mbconv", -1, False, {"fusedmb", "unfused"}),
    ("v1", False, "lowering:pwconv", -1, False, {"unfused"}),
    ("v1", False, "lowering:dwconv2d", -1, False, {"unfused"}),
    ("v2", None, "compile:network", 1, False, set()),
    ("v1", None, "numeric:network", 1, True, set()),
)
#: A ``pwconv`` problem whose ``simt`` grid needs more than 65535 CTAs in
#: y: a launch the driver refuses for its configuration.
BAD_PW_CO = 65535 * 128 + 1
#: A one-block network whose ``pw`` segment (G = 1, the ``stream`` variant,
#: at most 256 columns a CTA) needs more than 65535 CTAs in y.
BAD_NET_CO = 65535 * 256 + 1


def _check_code_table(build, failures) -> str:
    """Every code of ``runtime/failures.CUDA_ERRORS`` against the toolkit's
    ``driver_types.h``: the path checked."""
    header = os.path.join(os.path.dirname(os.path.dirname(
        os.path.realpath(build.nvcc()))), "include", "driver_types.h")
    with open(header) as fh:
        table = {name: int(code) for name, code in re.findall(
            r"\b(cudaError\w+)\s*=\s*(\d+)", fh.read())}
    wrong = {code: name for code, name in failures.CUDA_ERRORS.items()
             if table.get(name) != code}
    if wrong:
        raise AssertionError(f"runtime/failures.CUDA_ERRORS disagrees with "
                             f"{header}: {wrong}")
    return header


def run_runtime(torch, dev):
    """The runtime ladder, an opt-in (``KernelPolicy(on_failure="degrade")``;
    the default raises).  The quarantine and tune cache are pinned in a
    temporary directory under ``build/``.

    1. Steady state: V1, V2, MnasNet-A1 and Lite0 at 112x112, batch 1 and 8,
       fp32 and bf16, under the default policy and under ``"degrade"``:
       the same plan, the same launches in the graph's first call (two
       forwards) and the same output bits, no fallback and no quarantine
       file; at batch 1 both graphs' ms per forward in turns.
    2. Recovery (:data:`RECOVERY_ROWS`, batch 8, fp32 and bf16,
       ``mobilenet_inference.run_recovery``): the first call recovers
       within FP32_REL_TOL / BF16_REL_TOL of the fp32 plain path, every
       fallback injected and as many as the points fired, the quarantine
       file holds the row's bans; the next call re-plans and captures a
       graph that launches the kernel of every segment not at the plain
       rung (two forwards) and gives the eager runner's bits; its ms per
       forward.
    3. A real launch error: ``pwconv`` at a grid the driver refuses, eagerly
       and inside a capture: a ``KernelLaunchError`` with a
       launch-configuration code, classified as a ``LoweringFailure``.
       Under ``"degrade"`` the same refusal in a ``fused=False`` network
       raises that ``LoweringFailure``, with nothing quarantined, memoized
       or recovered: no kernel rung is left below ``pwconv``, and only an
       injected fault may reach the plain version.  Then the same kernel
       launches and matches its plain version, eagerly and from a graph;
       the code table against ``driver_types.h``.

    A fallback not injected, or a sticky error, fails the run."""
    import dataclasses
    import tempfile
    from repro_torch import graphs
    from repro_torch.core import chain, network
    from repro_torch.kernels import _build, pwconv
    from repro_torch.kernels.policy import BF16_STREAM, NATIVE, KernelPolicy
    from repro_torch.measure import rel_err, time_ms
    from repro_torch.mobilenet_inference import (ARCHS, KERNEL_SEGMENTS,
                                                 expected_launches,
                                                 recovery_ok, run_recovery)
    from repro_torch.runtime import failures, faultinject, quarantine, telemetry
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    out = {"steady": [], "recovery": []}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_runtime_",
                                     dir=os.path.join(HERE, "build")) as tmp:
        for arch in ARCHS:
            net = ARCHS[arch](1.0)
            params32 = network.init_network(net, seed=0, device=dev)
            for batch in (1, 8):
                x = torch.randn((batch, 112, 112, net.c_in),
                                generator=torch.Generator().manual_seed(1)
                                ).to(dev)
                for dtype in ("fp32", "bf16"):
                    bf16 = dtype == "bf16"
                    params = (network.cast_network_params(params32,
                                                          torch.bfloat16)
                              if bf16 else params32)
                    raise_pol = KernelPolicy(
                        dtype_policy=BF16_STREAM if bf16 else NATIVE)
                    degrade = dataclasses.replace(
                        raise_pol, on_failure="degrade",
                        tune_cache=os.path.join(tmp, "steady", "tune.json"))
                    label = f"{arch} 112x112 batch {batch} {dtype}"
                    plans = {name: network.plan_network(
                        net, x.shape, dtype=x.dtype, policy=q, device=dev)
                        for name, q in (("raise", raise_pol),
                                        ("degrade", degrade))}
                    want = {k: 2 * n for k, n in expected_launches(
                        plans["raise"].segment_histogram()).items()}
                    network.clear_network_cache()
                    telemetry.reset_runtime_telemetry()
                    got, launched = {}, {}
                    for name, q in (("raise", raise_pol),
                                    ("degrade", degrade)):
                        graphs.reset()
                        got[name], _ = network.execute_network_graph(
                            net, params, x, policy=q)
                        torch.cuda.synchronize(dev)
                        counts = graphs.snapshot()
                        launched[name] = {k: counts[k]
                                          for k in KERNEL_SEGMENTS}
                    ms = {"raise": [], "degrade": []}
                    if batch == 1:
                        fwd = {name: (lambda q=q: network.execute_network(
                            net, params, x, policy=q))
                            for name, q in (("raise", raise_pol),
                                            ("degrade", degrade))}
                        for name in ("raise", "degrade", "degrade", "raise",
                                     "raise", "degrade"):
                            ms[name].append(time_ms(fwd[name], dev))
                    network.clear_network_cache()
                    fallbacks = telemetry.fallback_count()
                    qfile = os.path.exists(quarantine.quarantine_path(
                        degrade))
                    same = (plans["raise"].plans == plans["degrade"].plans
                            and launched["raise"] == launched["degrade"]
                            == want
                            and bool(torch.equal(got["raise"],
                                                 got["degrade"])))
                    print(f"  steady {label}: same plan, launches and bits "
                          f"{same}; {fallbacks} fallbacks, "
                          f"{'a' if qfile else 'no'} quarantine file"
                          + (f"; graph ms raise "
                             f"{'/'.join(f'{v:.4f}' for v in ms['raise'])}, "
                             f"degrade "
                             f"{'/'.join(f'{v:.4f}' for v in ms['degrade'])}"
                             f" (ratio of medians "
                             f"{statistics.median(ms['degrade']) / statistics.median(ms['raise']):.3f})"
                             if ms["raise"] else ""), flush=True)
                    if not same or fallbacks or qfile:
                        raise AssertionError(
                            f"steady {label}: launches {launched} (want "
                            f"{want}), same plan "
                            f"{plans['raise'].plans == plans['degrade'].plans}"
                            f", {fallbacks} fallbacks, quarantine file "
                            f"{qfile}")
                    out["steady"].append({"arch": arch, "batch": batch,
                                          "dtype": dtype, "graph_ms": ms,
                                          "launches": launched["raise"]})
        for i, (arch, fused, point, times, guard, bans) in enumerate(
                RECOVERY_ROWS):
            for dtype in ("fp32", "bf16"):
                label = (f"{arch} 112x112{' fused=False' if fused is False else ''}"
                         f" batch 8 {dtype}, {point} armed"
                         f"{' (persistent)' if times < 0 else f' ({times}x)'}")
                faultinject.disarm_all()
                faultinject.arm(point, times=times)
                try:
                    with warnings.catch_warnings():
                        warnings.simplefilter("ignore", RuntimeWarning)
                        r = run_recovery(
                            ARCHS[arch](1.0), res=112, batch=8, dtype=dtype,
                            fused=fused, device=dev, numeric_guard=guard,
                            tune_cache=os.path.join(tmp, f"row{i}_{dtype}",
                                                    "tune.json"))
                finally:
                    faultinject.disarm_all()
                rep = r["report"]
                banned = {b for v in r["bans"].values() for b in v}
                histo = {k: v for k, v in sorted(r["histogram"].items())}
                print(f"  recovery {label}: first call {r['first_s'] * 1e3:.1f}"
                      f" ms ({sum(r['fired'].values())} faults fired, "
                      f"{rep['fallbacks']} fallbacks, "
                      f"{rep['injected_fallbacks']} injected, "
                      f"{rep['recoveries']} recoveries; bans "
                      f"{sorted(banned)} over {len(r['bans'])} problems in "
                      f"the file; rel err {r['first_rel_err']:.2e}); next "
                      f"call re-planned and captured in "
                      f"{r['second_s'] * 1e3:.1f} ms (capture "
                      f"{(r['capture_s'] or 0) * 1e3:.1f} ms, "
                      f"{r['replan_report']['quarantine_hits']} quarantine "
                      f"hits, {r['replan_report']['fallbacks']} fallbacks, "
                      f"plan {histo} with {r['plain_blocks']} blocks at the "
                      f"plain rung, launches {r['second_launches']}, graph "
                      f"equals eager {r['graph_equals_eager']}, rel err "
                      f"{r['rel_err']:.2e} (tol {r['tol']:g})); new graph "
                      f"{r['ms']:.4f} ms/forward", flush=True)
                if not (recovery_ok(r, True) and banned == bans
                        and rep["fallbacks"] > 0):
                    seen = {k: r[k] for k in (
                        "first_rel_err", "rel_err", "fired",
                        "graph_equals_eager", "second_captured",
                        "second_launches", "want_launches",
                        "eager_launches")}
                    seen["report"] = {k: v for k, v in rep.items()
                                      if k != "events"}
                    raise AssertionError(
                        f"recovery {label}: {seen}, bans {sorted(banned)} "
                        f"(want {sorted(bans)})")
                out["recovery"].append({
                    "arch": arch, "fused": fused, "point": point,
                    "dtype": dtype, "bans": sorted(banned),
                    **{k: r[k] for k in (
                        "first_s", "first_rel_err", "fired", "histogram",
                        "plain_blocks", "second_s", "capture_s",
                        "second_launches", "rel_err", "ms")},
                    "fallbacks": rep["fallbacks"],
                    "recoveries": rep["recoveries"]})
    # a real launch error, eagerly and inside a capture; the static
    # verifier predicts it (LC201) before it is made
    from repro_torch import analysis
    from repro_torch.analysis import launch_check
    from repro_torch.kernels import blocking, gridspec
    bad = blocking.plan_pwconv(1, 1, BAD_PW_CO, variant="simt")
    lc = launch_check.lint_model(gridspec.pwconv_model(
        g=1, ci=1, co=BAD_PW_CO, variant="simt", bg=bad.block_g,
        bco=bad.block_co, bci=bad.block_c, dtype=torch.float32))
    if "LC201" not in {d.rule for d in lc if d.severity == "error"}:
        raise AssertionError(f"the static verifier did not predict the "
                             f"refused pwconv launch: {lc}")
    print(f"  predicted before the launch: "
          f"{next(d for d in lc if d.rule == 'LC201').format()}", flush=True)
    x1 = torch.ones((1, 1), device=dev)
    w1 = torch.ones((1, BAD_PW_CO), device=dev)
    errors = []
    try:
        pwconv.pwconv(x1, w1, variant="simt")
    except _build.KernelLaunchError as e:
        errors.append(e)
    graph = torch.cuda.CUDAGraph()
    try:
        graphs.record(graph, lambda: pwconv.pwconv(x1, w1, variant="simt"),
                      dev)
    except _build.KernelLaunchError as e:
        errors.append(e)
    del graph
    if len(errors) != 2 or torch.cuda.is_current_stream_capturing():
        raise AssertionError(f"the invalid pwconv launch raised "
                             f"{len(errors)} KernelLaunchErrors of 2 (eager, "
                             "in a capture)")
    kinds = [failures.classify(e) for e in errors]
    if not all(isinstance(k, failures.LoweringFailure) for k in kinds):
        raise AssertionError(f"the launch errors {errors} classified as "
                             f"{kinds}")
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    # under degrade, a real refused launch of a standalone kernel raises
    refused = network.NetworkSpec(name="refused-pw", c_in=1, blocks=(
        chain.SeparableSpec((chain.PW(BAD_NET_CO),)),))
    rparams = network.init_network(refused, seed=0, device=dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_refused_",
                                     dir=os.path.join(HERE, "build")) as tmp:
        rpol = KernelPolicy(fused=False, on_failure="degrade",
                            tune_cache=os.path.join(tmp, "tune.json"))
        lrep = analysis.analyze_network(refused, network.plan_network(
            refused, (1, 1, 1, 1), policy=rpol, device=dev), policy=rpol,
            trace=False)
        if "LC201" not in lrep.rules("error"):
            raise AssertionError(f"the static verifier did not predict the "
                                 f"refused network launch: {lrep.format()}")
        print(f"  predicted before the launch: "
              f"{next(d for d in lrep.errors if d.rule == 'LC201').format()}",
              flush=True)
        network.clear_network_cache()
        telemetry.reset_runtime_telemetry()
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                network.execute_network(refused, rparams,
                                        torch.ones((1, 1, 1, 1), device=dev),
                                        policy=rpol)
            net_error = None
        except failures.LoweringFailure as e:
            net_error = e
        rqfile = os.path.exists(quarantine.quarantine_path(rpol))
    rmemo = len(network._NETWORK_CACHE)
    rrep = telemetry.runtime_report()
    network.clear_network_cache()
    del rparams
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    print(f"  launch error under degrade: a fused=False network whose pw "
          f"segment ({BAD_NET_CO} channels) the driver refuses raised "
          f"{type(net_error).__name__} (CUDA error "
          f"{getattr(getattr(net_error, 'original', None), 'code', None)}, "
          f"segment {getattr(net_error, 'segment_kind', None)}, injected "
          f"{getattr(net_error, 'injected', None)}); "
          f"{'a' if rqfile else 'no'} quarantine file, {rmemo} memoized "
          f"plans, {rrep['recoveries']} recoveries", flush=True)
    if (net_error is None or net_error.injected
            or net_error.segment_kind != "pw" or rqfile or rmemo
            or rrep["recoveries"]):
        raise AssertionError(
            f"a real refused pwconv launch under degrade: raised "
            f"{net_error!r}, quarantine file {rqfile}, {rmemo} memoized, "
            f"{rrep['recoveries']} recoveries (want a LoweringFailure and "
            "none of these)")
    gen = torch.Generator().manual_seed(0)
    xa = torch.randn((8 * 56 * 56, 128), generator=gen).to(dev)
    wa = (torch.randn((128, 256), generator=gen) / 128 ** 0.5).to(dev)
    ba = torch.randn((256,), generator=gen).to(dev)
    got = pwconv.pwconv(xa, wa, ba, activation="relu6")
    want = pwconv.pwconv_plain(xa, wa, ba, activation="relu6")
    replayed = graphs.capture(lambda: pwconv.pwconv(xa, wa, ba,
                                                    activation="relu6"), dev)
    torch.cuda.synchronize(dev)
    err = rel_err(got, want)
    header = _check_code_table(_build, failures)
    ok = err <= KERNEL_TOL["float32"] and torch.equal(replayed.output, got)
    print(f"  launch error: {errors[0]} (code {errors[0].code}, "
          f"{failures.CUDA_ERRORS.get(errors[0].code)}) -> "
          f"{kinds[0].kind}, and the same inside a capture -> {kinds[1].kind}"
          f" ({errors[1]}); then pwconv {8 * 56 * 56}x128x256 within "
          f"{err:.2e} of its plain version (tol {KERNEL_TOL['float32']:g}), "
          f"a graph of it gives its bits {torch.equal(replayed.output, got)}"
          f"; code table vs {header}: all {len(failures.CUDA_ERRORS)} match",
          flush=True)
    if not ok:
        raise AssertionError(f"pwconv after the launch error: rel err {err}")
    out["launch_error"] = {"code": errors[0].code, "message": str(errors[0]),
                           "capture_message": str(errors[1]),
                           "degrade_network_raised": str(net_error),
                           "after_rel_err": err, "header": header}
    return out


def run_serving(torch, dev):
    """The serving path: xlstm-125m at full width cut to XLSTM_LAYERS,
    prefill + greedy decode,
    batch 1 and 8, fp32 and bf16, through the captured prefill and decode
    step (CUDA graphs) and through the eager ones.  Every call of either
    path is held against the plain path's call on the same inputs: fp32
    within FP32_REL_TOL; bf16 within BF16_REL_TOL of the bf16 plain path
    (random-init xLSTM does not hold the fp32 plain path to 5e-2 in bf16: a
    512-token prefill at batch 1 differs from it by about that much;
    PERF.md), the error against the fp32 plain path reported beside it.
    The graph path's output must have the eager path's bits, call by
    call.  The wrappers' counters must move by two calls in each capture
    (its warm-up and its recording), by none in a replay and by one call in
    an eager call; the kernels a replay ran are counted in a profiler trace
    and must be one call's.  Returns the runs, the wrappers' launches by
    kernel, the kernels the profiled replays ran, the prefill-vs-stepping
    errors, and ``pwconv``'s launches by variant."""
    import dataclasses
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import pwconv
    from repro_torch.kernels.policy import KernelPolicy
    from repro_torch.launch.serve import (expected_launches, launch_counts,
                                          reset_launch_counts)
    from repro_torch.measure import profile_calls, rel_err, time_ms
    from repro_torch.models.transformer import init_params
    from repro_torch.serve import serve_step as S
    from repro_torch.serve.sampler import greedy

    t0 = time.perf_counter()
    print(f"  {XLSTM_NOTE}", flush=True)
    cfg16 = dataclasses.replace(get_config("xlstm-125m"),
                                n_layers=XLSTM_LAYERS)
    cfg32 = dataclasses.replace(cfg16, dtype="float32")
    models = {"fp32": init_params(cfg32, seed=0, device=dev),
              "bf16": init_params(cfg16, seed=0, device=dev)}
    n = sum(p.numel() for p in models["fp32"].parameters())
    print(f"  random weights from seed 0, {n / 1e6:.1f}M parameters, fp32 "
          f"and bf16, in {time.perf_counter() - t0:.1f} s", flush=True)
    plain = KernelPolicy(impl="torch")
    want = {"prefill": expected_launches(cfg32, "prefill"),
            "decode": expected_launches(cfg32, "decode")}
    max_len = PROMPT_LEN + GEN_STEPS
    totals = dict.fromkeys(want["prefill"], 0)
    replayed = dict.fromkeys(want["prefill"], 0)
    variants = {}
    seen = {}
    lost = []

    def check_by(label, phase, dtype, by, total):
        """Every decode step's ``pwconv`` launch ``stream``, every
        prefill's the dtype's wide variant (``tc`` in bf16, ``simt`` in
        fp32)."""
        check_variants(label, by, total, dtype, phase)
        if phase == "prefill" and by[
                "tc" if dtype == "bf16" else "simt"] != total:
            raise AssertionError(f"{label} prefill: pwconv by variant {by}")

    def counted(label, phase, fn, calls=1):
        """fn() with the counters zeroed just before and read just after;
        they must have moved by ``calls`` calls of ``phase``: 1 for an
        eager call, 2 for a capture (its warm-up and its recording), 0 for
        a replay."""
        dtype = label.split()[0]
        reset_launch_counts()
        out = fn()
        torch.cuda.synchronize(dev)
        got = launch_counts()
        if got != {k: calls * n for k, n in want[phase].items()}:
            raise AssertionError(f"{label} {phase}: launches {got}, "
                                 f"expected {calls} x {want[phase]}")
        by = dict(pwconv.launches_by_variant)
        check_by(label, phase, dtype, by, got["pwconv"])
        if calls == 1:
            seen[(label, phase)] = by
        for k in totals:
            totals[k] += got[k]
        for k, v in by.items():
            variants[k] = variants.get(k, 0) + v
        return out

    def replay_profile(label, phase, fn, reps):
        """Device ms by kernel of ``fn()``, a call that replays a graph, and
        a check of the kernels the replay ran, counted in the profiler's
        trace: one call's, ``pwconv``'s by variant as :func:`counted`
        holds them (a trace short of them is taken again,
        :func:`profile_calls`)."""
        ms, ran, retries = profile_calls(fn, want[phase], reps=reps)
        if retries:
            lost.append({"call": f"{label} {phase}", "retries": retries})
        got = {k: ran.get(k, 0) for k in want[phase]}
        if got != want[phase]:
            raise AssertionError(f"{label} {phase}: a replay ran {got} "
                                 f"(profiler), expected {want[phase]}")
        by = {v: ran.get(f"pwconv.{v}", 0) for v in pwconv.launches_by_variant}
        check_by(label + " replay", phase, label.split()[0], by, got["pwconv"])
        seen[(label + " replay", phase)] = by
        for k in replayed:
            replayed[k] += got[k]
        return ms

    def lead(prompts):
        """The fp32 plain path, free-running greedy: its logits, and the
        (cache, token) each decode step started from."""
        m = models["fp32"]
        reset_launch_counts()
        logits, cache = S.prefill(m, prompts, max_len=max_len, policy=plain)
        outs, steps = [logits], []
        for _ in range(GEN_STEPS):
            tok = greedy(logits)[:, None]
            steps.append((cache, tok))
            logits, cache = S.decode_step(m, cache, tok, policy=plain)
            outs.append(logits)
        if any(launch_counts().values()):
            raise AssertionError(f"the plain path launched {launch_counts()}")
        return outs, steps

    def follow(label, prompts, steps, prefill, step, calls=None):
        """``prefill``, then each decode ``step`` from the fp32 plain path's
        cache and token (held call by call, the error does not compound
        along the sequence), each call counted as ``calls`` calls (0 for a
        replay) unless ``calls`` is None.  Returns the logits and the ms of
        the prefill (host clock, ending in a synchronize)."""
        def call(lbl, phase, fn):
            return fn() if calls is None else counted(lbl, phase, fn, calls)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        logits, _ = call(label, "prefill", lambda: prefill(prompts))
        torch.cuda.synchronize(dev)
        prefill_ms = (time.perf_counter() - t0) * 1e3
        outs = [logits]
        for cache, tok in steps:
            outs.append(call(label, "decode", lambda: step(cache, tok))[0])
        return outs, prefill_ms

    def free_run(prefill, step, prompts, steps):
        """A path on its own cache, fed the plain path's tokens."""
        logits, cache = prefill(prompts)
        outs = [logits]
        for _, tok in steps:
            logits, cache = step(cache, tok)
            outs.append(logits)
        return outs

    def errors(got, ref):
        e = [rel_err(a, b) for a, b in zip(got, ref)]
        return {"prefill": e[0], "decode": max(e[1:]), "max": max(e)}

    def own_peak(before):
        return torch.cuda.max_memory_allocated(dev) - before

    runs = []
    with torch.inference_mode():
        for batch in (1, 8):
            prompts = torch.randint(
                0, cfg32.vocab_size, (batch, PROMPT_LEN),
                generator=torch.Generator().manual_seed(batch)).to(dev)
            ref, steps = lead(prompts)
            for dtype in ("fp32", "bf16"):
                m = models[dtype]
                tag = f"{dtype} batch {batch}"
                eager = (lambda p, m=m: S.prefill(m, p, max_len=max_len),
                         lambda c, t, m=m: S.decode_step(m, c, t))
                # graph path: capture, then every call; memory above what
                # was allocated before the capture
                torch.cuda.synchronize(dev)
                torch.cuda.reset_peak_memory_stats(dev)
                before = torch.cuda.memory_allocated(dev)
                pre = counted(tag + " capture", "prefill",
                              lambda: S.capture_prefill(
                                  m, batch, PROMPT_LEN, max_len=max_len), 2)
                dec = counted(tag + " capture", "decode",
                              lambda: S.capture_decode_step(m, batch,
                                                            max_len), 2)
                got, prefill_ms = follow(tag + " graph", prompts, steps, pre,
                                         dec, calls=0)
                peak = own_peak(before)
                torch.cuda.reset_peak_memory_stats(dev)
                before = torch.cuda.memory_allocated(dev)
                got_eager, eager_prefill_ms = follow(tag + " eager", prompts,
                                                     steps, *eager, calls=1)
                eager_peak = own_peak(before)
                same = [bool(torch.equal(a, b))
                        for a, b in zip(got, got_eager)]
                finite = all(bool(torch.isfinite(o).all()) and tuple(
                    o.shape) == (batch, cfg32.vocab_size) for o in got)
                err = errors(got, ref)
                if dtype == "bf16":
                    gated = errors(got, follow(
                        tag + " plain", prompts, steps,
                        lambda p: S.prefill(m, p, max_len=max_len,
                                            policy=plain),
                        lambda c, t: S.decode_step(m, c, t, policy=plain))[0])
                    chained = errors(free_run(pre, dec, prompts, steps), ref)
                else:
                    gated, chained = err, None
                # timing: the graph and the eager path in turns; decode on
                # the graph's own cache (replay only)
                cache, tok = steps[-1]
                dec(cache, tok)
                own = dec.cache
                steady = lambda: dec(own, tok)  # noqa: E731
                eager_step = lambda: eager[1](cache, tok)  # noqa: E731
                decode_ms = time_ms(steady, dev, reps=10, warmup=2)
                eager_decode_ms = time_ms(eager_step, dev, reps=10, warmup=2)
                # a prefill is ~10^5 device events: one profiled call each
                dev_pre = replay_profile(tag, "prefill",
                                         lambda: pre(prompts), reps=1)
                dev_pre_eager = profile_calls(lambda: eager[0](prompts),
                                              want["prefill"], reps=1)[0]
                dev_dec = replay_profile(tag, "decode", steady, reps=5)
                dev_dec_eager = profile_calls(eager_step, want["decode"])[0]
                tol = FP32_REL_TOL if dtype == "fp32" else BF16_REL_TOL

                def busy(dms, ms):
                    return sum(dms.values()) / ms if dms else None
                r = {"batch": batch, "dtype": dtype,
                     "prefill_ms": prefill_ms,
                     "eager_prefill_ms": eager_prefill_ms,
                     "decode_ms": decode_ms,
                     "eager_decode_ms": eager_decode_ms,
                     "tokens_per_s": batch * 1e3 / decode_ms,
                     "eager_tokens_per_s": batch * 1e3 / eager_decode_ms,
                     "prefill_capture_s": pre.captured.capture_s,
                     "decode_capture_s": dec.captured.capture_s,
                     "peak_bytes": peak, "eager_peak_bytes": eager_peak,
                     "prefill_device_ms": dev_pre,
                     "eager_prefill_device_ms": dev_pre_eager,
                     "decode_device_ms": dev_dec,
                     "eager_decode_device_ms": dev_dec_eager,
                     "prefill_busy": busy(dev_pre, prefill_ms),
                     # the same kernels, profiled without the graph (a
                     # check on what the profiler sees inside a replay)
                     "prefill_busy_by_eager_device_ms": busy(dev_pre_eager,
                                                             prefill_ms),
                     "eager_prefill_busy": busy(dev_pre_eager,
                                                eager_prefill_ms),
                     "decode_busy": busy(dev_dec, decode_ms),
                     "eager_decode_busy": busy(dev_dec_eager,
                                               eager_decode_ms),
                     "graph_equals_eager": all(same),
                     "graph_vs_eager": errors(got, got_eager),
                     "rel_err_vs_fp32_plain": err,
                     "rel_err_gated": gated, "tol": tol,
                     "rel_err_on_own_cache": chained,
                     "reduced": XLSTM_NOTE}
                runs.append(r)

                print(f"  xlstm-125m batch {batch} {dtype}: captured prefill "
                      f"in {r['prefill_capture_s'] * 1e3:.0f} ms, decode step "
                      f"in {r['decode_capture_s'] * 1e3:.1f} ms; own peak "
                      f"{peak / 2**20:.0f} MiB (eager {eager_peak / 2**20:.0f}"
                      f" MiB)", flush=True)
                print(f"    graph: prefill {batch}x{PROMPT_LEN} "
                      f"{prefill_ms:.1f} ms (busy {pct(r['prefill_busy'])}; "
                      f"{pct(r['prefill_busy_by_eager_device_ms'])} by the "
                      f"eager path's device ms), decode "
                      f"{decode_ms:.3f} ms/token (busy "
                      f"{pct(r['decode_busy'])}), {r['tokens_per_s']:.1f} "
                      f"tokens/s", flush=True)
                print(f"    eager: prefill {eager_prefill_ms:.1f} ms (busy "
                      f"{pct(r['eager_prefill_busy'])}), decode "
                      f"{eager_decode_ms:.3f} ms/token (busy "
                      f"{pct(r['eager_decode_busy'])}), "
                      f"{r['eager_tokens_per_s']:.1f} tokens/s", flush=True)
                print(f"    graph equals eager, call by call: {all(same)} "
                      f"(rel {r['graph_vs_eager']['max']:.2e})", flush=True)
                print(f"    pwconv by variant: prefill "
                      f"{seen[(tag + ' eager', 'prefill')]} (eager), "
                      f"{seen[(tag + ' replay', 'prefill')]} (a replay, "
                      f"profiler), a decode step "
                      f"{seen[(tag + ' eager', 'decode')]} (eager), "
                      f"{seen[(tag + ' replay', 'decode')]} (a replay)",
                      flush=True)
                print(f"    vs {dtype} plain path, each call from the same "
                      f"inputs: prefill {gated['prefill']:.2e}, decode steps "
                      f"{gated['decode']:.2e} (tol {tol:g})", flush=True)
                if dtype == "bf16":
                    print(f"    vs fp32 plain path (not gated): each call "
                          f"from the same inputs: prefill "
                          f"{err['prefill']:.2e}, decode steps "
                          f"{err['decode']:.2e}; on its own cache: decode "
                          f"steps {chained['decode']:.2e}", flush=True)
                for name, dp, dd in (("graph", dev_pre, dev_dec),
                                     ("eager", dev_pre_eager,
                                      dev_dec_eager)):
                    print(f"    {name} device ms per prefill: " + (", ".join(
                        f"{k} {v:.2f}" for k, v in sorted(dp.items()))
                        or "not profiled") + "; per decode step: "
                        + ", ".join(f"{k} {v:.3f}"
                                    for k, v in sorted(dd.items())),
                        flush=True)
                if not (finite and gated["max"] <= tol):
                    raise AssertionError(
                        f"xlstm-125m batch {batch} {dtype}: rel err {gated} "
                        f"> {tol} or bad logits (finite and shaped: "
                        f"{finite})")
                if not all(same):
                    raise AssertionError(
                        f"xlstm-125m batch {batch} {dtype}: the graph path "
                        f"differs from the eager path at calls "
                        f"{[i for i, ok in enumerate(same) if not ok]}")
                del pre, dec, own, steady
                torch.cuda.empty_cache()
            del ref, steps

        prompts = torch.randint(
            0, cfg32.vocab_size, (8, STEPPING_PROMPT),
            generator=torch.Generator().manual_seed(64)).to(dev)
        m = models["fp32"]
        lp, cp = S.prefill(m, prompts, max_len=max_len)
        ls, cs = S.prefill_by_stepping(m, prompts, max_len=max_len)
        tok = greedy(lp)[:, None]
        e_pre = rel_err(lp, ls)
        e_next = rel_err(S.decode_step(m, cp, tok)[0],
                         S.decode_step(m, cs, tok)[0])
        print(f"  prefill vs prefill_by_stepping, fp32 8x{STEPPING_PROMPT}: "
              f"rel err {e_pre:.2e}, next decode step {e_next:.2e} (tol "
              f"{FP32_REL_TOL:g})", flush=True)
        if not max(e_pre, e_next) <= FP32_REL_TOL:
            raise AssertionError(f"prefill vs prefill_by_stepping: {e_pre}, "
                                 f"{e_next}")
    return (runs, totals, replayed, {"prefill": e_pre, "next_step": e_next,
                                     "profiles_retried": lost}, variants)


def pw_variants_of(model, g: int) -> dict:
    """``pwconv``'s launches by variant in one pass of ``model``'s layers
    over G rows: each Linear at the variant ``blocking.pw_variant`` picks
    for its shape (operands 16-byte aligned, as the allocator leaves
    them); a MoE router is a plain fp32 product."""
    from repro_torch.kernels import blocking
    by = dict.fromkeys(blocking.PW_VARIANTS, 0)
    for block in model.blocks:
        for name, p in block.named_parameters():
            if name.rsplit(".", 1)[-1] == "w" and "router" not in name:
                by[blocking.pw_variant(g, *p.shape, p.dtype)] += 1
    return by


def _trees_equal(torch, a, b) -> bool:
    if isinstance(a, dict):
        return set(a) == set(b) and all(_trees_equal(torch, a[k], b[k])
                                        for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_trees_equal(torch, x, y)
                                        for x, y in zip(a, b))
    return bool(torch.equal(a, b))


def hymba_breakdown(torch, dev, model, batch):
    """Device ms (CUDA events, median of 3) of one hymba layer's prefill
    at full width and of its plain parts on the same inputs: the layer,
    its attention core (blockwise, window and sink), its selective scan,
    and its 11 Linears at their shapes (the ``pwconv`` kernel)."""
    from repro_torch.core.pwconv import pointwise
    from repro_torch.measure import time_ms
    from repro_torch.models import attention as A
    from repro_torch.models import ssm
    from repro_torch.models.transformer import layer_forward
    cfg = model.cfg
    s = cfg.meta_tokens + HYMBA_PROMPT
    gen = torch.Generator().manual_seed(7)

    def r(*shape, dtype=cfg.torch_dtype, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev, dtype)
    x = r(batch, s, cfg.d_model, scale=0.5)
    pos = torch.arange(s, device=dev)[None].expand(batch, s)
    block = model.blocks[0]
    hd, di, n = cfg.head_dim, cfg.d_model * cfg.ssm.expand, cfg.ssm.d_state
    q = r(batch, s, cfg.n_heads, hd)
    k, v = r(batch, s, cfg.n_kv_heads, hd), r(batch, s, cfg.n_kv_heads, hd)
    u = r(batch, s, di, dtype=torch.float32)
    dt = torch.rand((batch, s, di), generator=gen).to(dev) * 0.1
    bc = r(batch, s, n, dtype=torch.float32)
    a = -torch.exp(block.mamba.a_log)
    linears = [p for name, p in block.named_parameters()
               if name.rsplit(".", 1)[-1] == "w"]
    xs = {ci: r(batch * s, ci) for ci in {w.shape[0] for w in linears}}
    kw = dict(reps=3, warmup=1)
    return {
        "layer_ms": time_ms(lambda: layer_forward(
            block, x, cfg, model.variant(0), positions=pos), dev, **kw),
        "attention_core_ms": time_ms(lambda: A.blockwise_attention(
            q, k, v, window=cfg.sliding_window, sink=cfg.meta_tokens,
            chunk=cfg.attn_chunk), dev, **kw),
        "selective_scan_ms": time_ms(lambda: ssm.selective_scan(
            u, dt, a, bc, bc, block.mamba.d_skip, chunk=cfg.ssm.chunk),
            dev, **kw),
        "linears_ms": time_ms(lambda: [pointwise(xs[w.shape[0]], w)
                                       for w in linears], dev, **kw)}


class LMServe:
    """One LM serving run after another on the card, each checked the same
    way (:meth:`run`), with the launches the wrappers counted, the kernels
    the profiled replays ran, ``pwconv``'s launches by variant and the
    profiles retaken kept across runs."""

    def __init__(self, torch, dev):
        from repro_torch.kernels.policy import KernelPolicy
        self.torch, self.dev = torch, dev
        self.plain = KernelPolicy(impl="torch")
        self.totals = {"dwconv1d": 0, "pwconv": 0}
        self.replayed = dict(self.totals)
        self.variants, self.lost = {}, []

    def counted(self, label, want, fn, calls, by_want):
        """fn() with the counters zeroed just before and read just after:
        ``calls`` calls' launches (2 for a capture, 1 for an eager call, 0
        for a replay), ``pwconv``'s by variant as ``by_want`` says for one
        call."""
        from repro_torch.kernels import pwconv
        from repro_torch.launch.serve import launch_counts, reset_launch_counts
        reset_launch_counts()
        out = fn()
        self.torch.cuda.synchronize(self.dev)
        got = launch_counts()
        by = dict(pwconv.launches_by_variant)
        if (got != {k: calls * n for k, n in want.items()}
                or by != {k: calls * n for k, n in by_want.items()}):
            raise AssertionError(f"{label}: launches {got}, pwconv by "
                                 f"variant {by}; expected {calls} x {want}, "
                                 f"by variant {by_want}")
        for k in self.totals:
            self.totals[k] += got[k]
        for k, v in by.items():
            self.variants[k] = self.variants.get(k, 0) + v
        return out

    def replay_profile(self, label, want, fn, reps, by_want):
        """Device ms by kernel of ``fn()``, a call that replays a graph, and
        the device events it ran; the port's kernels it ran, counted in
        the trace, must be one call's, ``pwconv``'s by variant too.  A
        trace of thousands of events loses records now and then: up to
        five are taken."""
        from repro_torch.measure import profile_calls
        ms, ran, retries = profile_calls(fn, want, reps=reps, tries=5)
        if retries:
            self.lost.append({"call": label, "retries": retries})
        got = {k: ran.get(k, 0) for k in want}
        by = {v: ran.get(f"pwconv.{v}", 0) for v in by_want}
        if got != want or by != by_want:
            raise AssertionError(f"{label}: a replay ran {got}, pwconv by "
                                 f"variant {by} (profiler); expected {want}"
                                 f", {by_want}")
        for k in self.replayed:
            self.replayed[k] += got[k]
        return ms, ran.get("device_events")

    def run(self, m, prompts, tag, *, gen, frontend=None, tokens=None,
            max_len=None, by_want=None):
        """``m`` serving ``prompts`` (B, S) [with the frontend's embeddings]:
        the captured prefill and decode step and the eager ones, launches
        counted (each Linear's ``pw_variant``), the graph path's logits and
        caches bit for bit the eager path's, every call held against the
        plain path of its dtype from the same inputs (fp32 within
        FP32_REL_TOL, bf16 within BF16_REL_TOL; a MoE model's decode steps
        by their median), ``gen`` decode steps in lockstep, each from the
        plain path's cache, taking ``tokens[t]`` if given, else the plain
        path's greedy token; the graph's and the eager decode step timed
        (CUDA events, median of 10), a profiled replay of each graph
        running one call's kernels.  Returns the record, the graph path's
        logits call by call, and the plain path's (``"logits"``) with the
        tokens its steps took (``"tokens"``).  ``max_len`` defaults to the
        prefix, the prompt and ``gen``; ``by_want`` to each Linear's
        ``pw_variant`` at the prefill's and decode's rows.  An
        encoder-decoder's ``frontend`` is its frames (no prefix); its
        encoder's K/V in the captured decode step's cache must keep their
        bits and addresses over the timed and profiled replays (the graph
        never writes them)."""
        torch, dev = self.torch, self.dev
        from repro_torch.launch.serve import expected_launches, frontend_len
        from repro_torch.measure import rel_err, time_ms
        from repro_torch.serve import serve_step as S
        from repro_torch.serve.sampler import greedy
        counted, replay_profile, plain = (self.counted, self.replay_profile,
                                          self.plain)
        cfg = m.cfg
        batch, prompt_len = prompts.shape
        prefix = (0 if cfg.encdec is not None
                  else cfg.meta_tokens + cfg.fusion_tokens)
        max_len = max_len or prefix + prompt_len + gen
        want = {ph: expected_launches(cfg, ph) for ph in ("prefill",
                                                          "decode")}
        by_want = by_want or {
            "prefill": pw_variants_of(m, batch * (prefix + prompt_len)),
            "decode": pw_variants_of(m, batch)}
        label = f"{cfg.name} batch {batch} {tag}"
        if gen < 16:
            raise ValueError("the decode timing takes 15 steps")
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        pre = counted(label + " prefill capture", want["prefill"],
                      lambda: S.capture_prefill(
                          m, batch, prompt_len, max_len=max_len,
                          frontend_len=0 if frontend is None
                          else frontend_len(cfg)), 2, by_want["prefill"])
        dec = counted(label + " decode capture", want["decode"],
                      lambda: S.capture_decode_step(m, batch, max_len), 2,
                      by_want["decode"])
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        g_logits, g_cache = counted(label + " graph prefill",
                                    want["prefill"],
                                    lambda: pre(prompts, frontend), 0,
                                    by_want["prefill"])
        prefill_ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated(dev) - before
        t0 = time.perf_counter()
        e_logits, e_cache = counted(
            label + " eager prefill", want["prefill"],
            lambda: S.prefill(m, prompts, max_len=max_len, frontend=frontend),
            1, by_want["prefill"])
        eager_prefill_ms = (time.perf_counter() - t0) * 1e3
        p_logits, p_cache = counted(
            label + " plain prefill", want["prefill"],
            lambda: S.prefill(m, prompts, max_len=max_len, frontend=frontend,
                              policy=plain), 0,
            dict.fromkeys(by_want["prefill"], 0))
        same = [bool(torch.equal(g_logits, e_logits))
                and _trees_equal(torch, g_cache, e_cache)]
        errs = [rel_err(g_logits, p_logits)]
        shaped = [tuple(g_logits.shape) == (batch, cfg.vocab_size)
                  and bool(torch.isfinite(g_logits).all())]
        slots = [layer["k"].shape[1] for layer in g_cache["layers"]]
        del g_cache, e_cache
        graph_logits, taken, logits = [g_logits], [], p_logits
        plain_logits = [p_logits]
        for t in range(gen):
            tok = tokens[t] if tokens is not None else greedy(logits)[:, None]
            taken.append(tok)
            gl = counted(label + " graph decode", want["decode"],
                         lambda: dec(p_cache, tok), 0, by_want["decode"])[0]
            el = counted(label + " eager decode", want["decode"],
                         lambda: S.decode_step(m, p_cache, tok), 1,
                         by_want["decode"])[0]
            logits, p_cache = S.decode_step(m, p_cache, tok, policy=plain)
            plain_logits.append(logits)
            same.append(bool(torch.equal(gl, el)))
            errs.append(rel_err(gl, logits))
            shaped.append(bool(torch.isfinite(gl).all()))
            graph_logits.append(gl)
        # timing: the graph's decode step on its own cache (replay only)
        # and the eager one on the same cache, rewound to the first decode
        # position before each run of at most 15 steps (the cache has
        # room for ``gen`` >= 16 more tokens; no ring past the window)
        steady = lambda: dec(dec.cache, tok)  # noqa: E731
        eager_step = lambda: S.decode_step(m, dec.cache, tok)  # noqa: E731

        def rewind():
            dec.cache["pos"].fill_(prefix + prompt_len)
        rewind()
        enc = {k: (dec.cache[k].data_ptr(), dec.cache[k].clone())
               for k in ("enc_k", "enc_v") if k in dec.cache}
        decode_ms = time_ms(steady, dev, reps=10, warmup=2)
        rewind()
        eager_decode_ms = time_ms(eager_step, dev, reps=10, warmup=2)
        dev_pre, events_pre = replay_profile(
            label + " prefill replay", want["prefill"],
            lambda: pre(prompts, frontend), 1, by_want["prefill"])
        rewind()
        dev_dec, events_dec = replay_profile(
            label + " decode replay", want["decode"], steady, 2,
            by_want["decode"])
        enc_read_only = all(dec.cache[k].data_ptr() == ptr
                            and bool(torch.equal(dec.cache[k], before))
                            for k, (ptr, before) in enc.items())
        del enc
        tol = FP32_REL_TOL if cfg.dtype == "float32" else BF16_REL_TOL
        # a MoE decode step's logits against the plain path: where the
        # kernel's and the plain product's roundings reorder a token's
        # router near a tie, its top-k differs and so does its row; the
        # MoE block itself is held to moe_dense_ref (:func:`moe_oracle`),
        # so the steps' median is gated and the worst one reported
        gated = (statistics.median(errs[1:]) if cfg.moe is not None
                 else max(errs[1:]))
        r = {"arch": cfg.name, "layers": cfg.n_layers, "batch": batch,
             "dtype": cfg.dtype, "kv_quant": cfg.kv_quant,
             "positions": prefix + prompt_len,
             "cache_slots": sorted(set(slots)),
             "prefill_ms": prefill_ms, "eager_prefill_ms": eager_prefill_ms,
             "decode_ms": decode_ms, "eager_decode_ms": eager_decode_ms,
             "tokens_per_s": batch * 1e3 / decode_ms,
             "prefill_capture_s": pre.captured.capture_s,
             "decode_capture_s": dec.captured.capture_s,
             "peak_bytes": peak, "prefill_device_ms": dev_pre,
             "decode_device_ms": dev_dec,
             "prefill_device_events": events_pre,
             "decode_device_events": events_dec,
             "prefill_busy": sum(dev_pre.values()) / prefill_ms
             if dev_pre else None,
             "decode_busy": sum(dev_dec.values()) / decode_ms
             if dev_dec else None,
             "graph_equals_eager": all(same), "rel_err_prefill": errs[0],
             "encoder_cache_read_only": enc_read_only if cfg.encdec
             is not None else None,
             "rel_err_decode": max(errs[1:]),
             "rel_err_decode_median": statistics.median(errs[1:]),
             "decode_steps_over_tol": sum(e > tol for e in errs[1:]),
             "tol": tol, "pwconv_variants": by_want}
        print(f"    {label}: {prefix + prompt_len} positions, "
              f"caches of {sorted(set(slots))} slots; capture prefill "
              f"{r['prefill_capture_s'] * 1e3:.0f} ms, decode "
              f"{r['decode_capture_s'] * 1e3:.1f} ms; own peak "
              f"{peak / 2**20:.0f} MiB", flush=True)
        print(f"      graph: prefill {prefill_ms:.1f} ms (busy "
              f"{pct(r['prefill_busy'])}), decode {decode_ms:.3f} ms/token "
              f"(busy {pct(r['decode_busy'])}), {r['tokens_per_s']:.1f} "
              f"tokens/s; eager: prefill {eager_prefill_ms:.1f} ms, decode "
              f"{eager_decode_ms:.3f} ms/token", flush=True)
        print(f"      graph equals eager (logits and caches), call by call: "
              f"{all(same)}; vs {cfg.dtype} plain path: prefill "
              f"{errs[0]:.2e}, decode steps {max(errs[1:]):.2e} (median "
              f"{r['rel_err_decode_median']:.2e}, "
              f"{r['decode_steps_over_tol']} of {gen} over the tol "
              f"{tol:g}" + (", the median gated: MoE routing" if cfg.moe
                            is not None else "")
              + "); device ms a prefill " + ", ".join(
                  f"{k} {v:.2f}" for k, v in sorted(dev_pre.items()))
              + "; a decode step " + ", ".join(
                  f"{k} {v:.3f}" for k, v in sorted(dev_dec.items()))
              + f"; device events a replay: prefill {events_pre}, decode "
              f"step {events_dec}", flush=True)
        if not (all(shaped) and max(errs[0], gated) <= tol):
            raise AssertionError(f"{label}: rel err {errs} > {tol} or bad "
                                 "logits")
        if not all(same):
            raise AssertionError(
                f"{label}: the graph path differs from the eager path at "
                f"calls {[i for i, ok in enumerate(same) if not ok]}")
        if not enc_read_only:
            raise AssertionError(f"{label}: the captured decode step wrote "
                                 "the encoder's K/V")
        del pre, dec, steady, eager_step, p_cache
        torch.cuda.empty_cache()
        return r, graph_logits, {"tokens": taken, "logits": plain_logits}


def run_hymba(torch, dev):
    """The hymba serving path: hymba-1.5b at full width cut to
    :data:`HYMBA_LAYERS` layers (random from seed 0), a 1536-token prompt (1664 positions with the 128 meta
    tokens: blockwise attention, a window that excludes keys, the
    1152-slot ring cache), then 32 greedy decode steps; batch 1 and 8,
    fp32 and bf16 (the bf16 weights cast from the fp32 draw), each run
    checked as :meth:`LMServe.run` checks it (two bf16 Linears have widths
    TMA cannot describe: ``simt``); bf16 takes the fp32 plain path's
    tokens, and its error against the fp32 plain path is reported, not
    gated.  Returns the runs, the wrappers' launches, the profiled
    replays' kernels, the prefill-vs-stepping errors, ``pwconv``'s
    launches by variant and the per-layer breakdowns."""
    import dataclasses
    from repro_torch.configs.registry import get_config
    from repro_torch.measure import rel_err
    from repro_torch.models.transformer import cast_params, init_params
    from repro_torch.serve import serve_step as S
    from repro_torch.serve.sampler import greedy

    t0 = time.perf_counter()
    print(f"    {HYMBA_NOTE}", flush=True)
    cfg16 = dataclasses.replace(get_config("hymba-1.5b"),
                                n_layers=HYMBA_LAYERS)
    cfg32 = dataclasses.replace(cfg16, dtype="float32")
    m32 = init_params(cfg32, seed=0, device=dev)
    models = {"fp32": m32, "bf16": cast_params(m32, cfg16)}
    n = sum(p.numel() for p in m32.parameters())
    print(f"  random weights from seed 0, {n / 1e9:.3f}B parameters, fp32 "
          f"(bf16 cast from it), in {time.perf_counter() - t0:.1f} s",
          flush=True)
    srv = LMServe(torch, dev)
    ring = cfg32.sliding_window + cfg32.meta_tokens
    runs, breakdown = [], {}
    with torch.inference_mode():
        for batch in (1, 8):
            prompts = torch.randint(
                0, cfg32.vocab_size, (batch, HYMBA_PROMPT),
                generator=torch.Generator().manual_seed(100 + batch)).to(dev)
            r32, _, lead = srv.run(models["fp32"], prompts, "fp32",
                                   gen=HYMBA_GEN)
            r16, logits16, _ = srv.run(models["bf16"], prompts, "bf16",
                                       gen=HYMBA_GEN, tokens=lead["tokens"])
            vs = [rel_err(a, b) for a, b in zip(logits16, lead["logits"],
                                                strict=True)]
            r16["rel_err_vs_fp32_plain"] = {"prefill": vs[0],
                                            "decode": max(vs[1:])}
            print(f"      bf16 vs the fp32 plain path (not gated, bf16 "
                  f"plain cache): prefill {vs[0]:.2e}, decode steps "
                  f"{max(vs[1:]):.2e}", flush=True)
            for r in (r32, r16):
                if r["cache_slots"] != [ring]:
                    raise AssertionError(f"hymba {r['dtype']} batch {batch}:"
                                         f" caches of {r['cache_slots']} "
                                         f"slots, not the {ring}-slot ring")
            runs += [r32, r16]
            del lead, logits16
            if batch == 8:
                for dtype, m in models.items():
                    breakdown[dtype] = hymba_breakdown(torch, dev, m, batch)
                    print(f"    one layer's prefill at batch 8, {dtype} "
                          "(CUDA events):" + ", ".join(
                              f" {k} {v:.2f}"
                              for k, v in breakdown[dtype].items()),
                          flush=True)

        prompts = torch.randint(
            0, cfg32.vocab_size, (1, HYMBA_STEPPING),
            generator=torch.Generator().manual_seed(64)).to(dev)
        max_len = cfg32.meta_tokens + HYMBA_PROMPT + HYMBA_GEN
        lp, cp = S.prefill(m32, prompts, max_len=max_len)
        ls, cs = S.prefill_by_stepping(m32, prompts, max_len=max_len)
        tok = greedy(lp)[:, None]
        e_pre = rel_err(lp, ls)
        e_next = rel_err(S.decode_step(m32, cp, tok)[0],
                         S.decode_step(m32, cs, tok)[0])
        print(f"  hymba prefill vs prefill_by_stepping, fp32 1x"
              f"{HYMBA_STEPPING} (+{cfg32.meta_tokens} meta tokens primed): "
              f"rel err {e_pre:.2e}, next decode step {e_next:.2e} (tol "
              f"{FP32_REL_TOL:g})", flush=True)
        if not max(e_pre, e_next) <= FP32_REL_TOL:
            raise AssertionError(f"hymba prefill vs prefill_by_stepping: "
                                 f"{e_pre}, {e_next}")
    del models, m32
    torch.cuda.empty_cache()
    return (runs, srv.totals, srv.replayed,
            {"prefill": e_pre, "next_step": e_next,
             "profiles_retried": srv.lost, "reduced": HYMBA_NOTE},
            srv.variants, breakdown)


def run_hymba_phase():
    """:func:`run_hymba` in a process of its own (this script with
    ``--hymba-only``), its results read back from a JSON file under
    ``build/``.  A hymba replay's trace holds about 4000 device records a
    decode step; in a process that had taken the CNN and xLSTM phases'
    hundreds of traces, every retake of such a trace lost records
    (PERF.md, section 6); in a fresh one a retake recovers them.  A
    failure of the phase raises here."""
    out = os.path.join(HERE, "build", "chip_smoke_hymba.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    sys.stdout.flush()
    subprocess.run([sys.executable, os.path.abspath(__file__),
                    "--hymba-only", out], check=True)
    with open(out) as fh:
        return json.load(fh)


#: The attention-MLP serving phase (:func:`run_attn_mlp`): prompt length,
#: greedy steps, the prefill_by_stepping oracle's prompt, llama4's smoke
#: run, and the depth each full-width config is cut to (the run's time:
#: drawing and moving 30-110 B weights; qwen1.5-110b does not fit one card)
#: with why.
ATTN_PROMPT, ATTN_GEN, ATTN_STEPPING = 512, 32, 64
LLAMA4_SMOKE_PROMPT, LLAMA4_SMOKE_MAX_LEN = 40, 80
DEPTH_CUTS = {
    "command-r-35b": (2, "35 B parameters at 40 layers: the run's time"),
    "qwen1.5-110b": (1, "111 B parameters at 80 layers do not fit one "
                        "80 GB card, and the run's time"),
    "qwen3-moe-235b-a22b": (2, "2.49 B parameters a layer, 235 B at 94 "
                               "layers: one card and the run's time"),
}
#: llama4-maverick's full width waits for the four-chip work: one MoE
#: layer holds 16.1 B expert parameters (32 GB in bf16).
LLAMA4_NOTE = ("llama4-maverick-400b-a17b at its smoke config only: one "
               "full-width MoE layer holds 16.1 B expert parameters (32 GB "
               "in bf16); its full width waits for the four-chip work")


def lm_linears(model) -> list:
    """(name, weight) of every Linear of layer 0 that runs on ``pwconv``
    (a MoE router is a plain fp32 product)."""
    return [(n[:-2], p) for n, p in model.blocks[0].named_parameters()
            if n.endswith(".w") and "router" not in n]


def lm_breakdown(torch, dev, model, batch, prompt_len):
    """Device ms (CUDA events, median of 3) of layer 0's prefill at full
    width and of its parts on the same inputs: the attention core (dense
    below ``attn_chunk``), the Linears on ``pwconv`` and, for a MoE layer,
    ``moe_forward`` and its expert products alone (three ``bmm``s on the
    capacity buffers, fp32 operands), the rest of it being the router and
    the dispatch's plain ops."""
    from repro_torch.core.pwconv import pointwise
    from repro_torch.measure import time_ms
    from repro_torch.models import attention as A
    from repro_torch.models import moe
    from repro_torch.models.transformer import layer_forward
    cfg = model.cfg
    s = prompt_len + cfg.fusion_tokens
    gen = torch.Generator().manual_seed(7)

    def r(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(
            dev, cfg.torch_dtype)
    x = r(batch, s, cfg.d_model, scale=0.5)
    pos = torch.arange(s, device=dev)[None].expand(batch, s)
    q = r(batch, s, cfg.n_heads, cfg.head_dim)
    k, v = (r(batch, s, cfg.n_kv_heads, cfg.head_dim) for _ in range(2))
    block = model.blocks[0]
    linears = [w for _, w in lm_linears(model)]
    xs = {ci: r(batch * s, ci) for ci in {w.shape[0] for w in linears}}
    kw = dict(reps=3, warmup=1)
    out = {"layer_ms": time_ms(lambda: layer_forward(
               block, x, cfg, model.variant(0), positions=pos), dev, **kw),
           "attention_core_ms": time_ms(lambda: A.dense_attention(
               q, k, v, causal=True) if s <= cfg.attn_chunk else
               A.blockwise_attention(q, k, v, chunk=cfg.attn_chunk), dev,
               **kw),
           "linears_ms": time_ms(lambda: [pointwise(xs[w.shape[0]], w)
                                          for w in linears], dev, **kw)}
    if model.variant(0).use_moe:
        p, e = block.moe, cfg.moe.n_experts
        cap = moe._capacity(batch * s * cfg.moe.top_k, e,
                            cfg.moe.capacity_factor)
        eb = r(e, cap, cfg.d_model)

        def experts():
            g = torch.bmm(eb.float(), p.w_gate_e.float())
            u = torch.bmm(eb.float(), p.w_up_e.float())
            h = (torch.nn.functional.silu(g) * u).to(eb.dtype)
            return torch.bmm(h.float(), p.w_down_e.float())
        out["moe_ms"] = time_ms(lambda: moe.moe_forward(p, x, cfg.moe), dev,
                                **kw)
        out["moe_experts_ms"] = time_ms(experts, dev, **kw)
        out["moe_dispatch_share"] = 1 - out["moe_experts_ms"] / out["moe_ms"]
    return out


def run_attn_mlp(torch, dev):
    """The attention-MLP serving path (dense, VLM and MoE transformers):
    qwen3-1.7b at full width and depth (1.72 B parameters, random from a
    seed drawn on the card), fp32 and bf16, batch 1 and 8, a 512-token
    prompt and 32 greedy steps; qwen3-1.7b bf16 with the int8 KV cache at
    batch 8; smollm-360m and internvl2-1b (its 256 frontend embeddings) at
    full width and depth, bf16, batch 8; command-r-35b, qwen1.5-110b and
    qwen3-moe-235b-a22b at full width, cut in depth (:data:`DEPTH_CUTS`),
    bf16, batch 8; llama4-maverick at its smoke config (:data:`LLAMA4_NOTE`).

    Each run goes through the captured prefill and decode step and through
    the eager ones: launches counted as in :func:`run_serving` (and
    ``pwconv``'s by variant as each Linear's ``pw_variant``), the graph
    path's logits and caches bit for bit the eager path's, every call held
    against the plain path of its dtype from the same inputs (fp32 within
    FP32_REL_TOL, bf16 and int8 within BF16_REL_TOL), the decode steps in
    lockstep from the plain path's cache and the fp32 plain path's greedy
    token (bf16's error against fp32 reported, not gated), a profiled
    replay of each graph running one call's kernels.  qwen3-1.7b's prefill
    is also held against ``prefill_by_stepping`` at a 64-token prompt, and
    qwen3-moe's MoE layer against ``moe_dense_ref`` where no copy was
    dropped.  Returns the runs, the wrappers' launches, the profiled
    replays' kernels, ``pwconv``'s launches by variant and the checks."""
    import dataclasses
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import blocking
    from repro_torch.measure import rel_err
    from repro_torch.models.transformer import (cast_params, hidden_states,
                                                init_params)
    from repro_torch.serve import serve_step as S
    from repro_torch.serve.sampler import greedy

    srv = LMServe(torch, dev)
    runs, checks = [], {}

    def serve(m, prompts, tag, *, gen=ATTN_GEN, **kw):
        return srv.run(m, prompts, tag, gen=gen, **kw)

    def draw(cfg):
        t0 = time.perf_counter()
        m = init_params(cfg, generator=torch.Generator(dev).manual_seed(0),
                        device=dev)
        n = sum(p.numel() for p in m.parameters())
        print(f"  {cfg.name}: {cfg.n_layers} layers, random weights from "
              f"seed 0 drawn on the card, {n / 1e9:.3f}B parameters, "
              f"{cfg.dtype}, in {time.perf_counter() - t0:.1f} s",
              flush=True)
        return m

    with torch.inference_mode():
        # qwen3-1.7b at full width and depth
        cfg16 = get_config("qwen3-1.7b")
        m32 = draw(dataclasses.replace(cfg16, dtype="float32"))
        models = {"fp32": m32, "bf16": cast_params(m32, cfg16)}
        shapes = {}
        for name, w in lm_linears(m32):
            ci, co = w.shape
            shapes[name] = {f"{ph} G={g} {dt}": blocking.pw_variant(
                g, ci, co, torch.float32 if dt == "fp32" else torch.bfloat16)
                for ph, g in (("prefill", 8 * ATTN_PROMPT), ("decode", 8))
                for dt in ("fp32", "bf16")}
            print(f"    pwconv {name} {ci}->{co}: " + ", ".join(
                f"{k} {v}" for k, v in shapes[name].items()), flush=True)
        checks["qwen3_pwconv_variants"] = shapes
        bf16_b8 = None
        for batch in (1, 8):
            prompts = torch.randint(
                0, cfg16.vocab_size, (batch, ATTN_PROMPT),
                generator=torch.Generator().manual_seed(200 + batch)).to(dev)
            r32, _, lead32 = serve(models["fp32"], prompts, "fp32")
            runs.append(r32)
            r16, logits16, _ = serve(models["bf16"], prompts, "bf16",
                                     tokens=lead32["tokens"])
            r16["rel_err_vs_fp32_plain_prefill"] = rel_err(
                logits16[0], lead32["logits"][0])
            print(f"      bf16 prefill vs the fp32 plain path (not gated): "
                  f"{r16['rel_err_vs_fp32_plain_prefill']:.2e}", flush=True)
            runs.append(r16)
            if batch == 8:
                bf16_b8 = (prompts, lead32["tokens"], logits16, r16)
                checks["qwen3_breakdown"] = {
                    dt: lm_breakdown(torch, dev, models[dt], 8, ATTN_PROMPT)
                    for dt in ("fp32", "bf16")}
                print("    qwen3-1.7b layer 0's prefill at batch 8 (CUDA "
                      "events): " + "; ".join(
                          f"{dt} " + ", ".join(f"{k} {v:.3f}"
                                               for k, v in b.items())
                          for dt, b in checks["qwen3_breakdown"].items()),
                      flush=True)
            del lead32
        # prefill against prefill_by_stepping, fp32 1x64
        prompts = torch.randint(
            0, cfg16.vocab_size, (1, ATTN_STEPPING),
            generator=torch.Generator().manual_seed(64)).to(dev)
        lp, cp = S.prefill(m32, prompts, max_len=ATTN_STEPPING + 1)
        ls, cs = S.prefill_by_stepping(m32, prompts,
                                       max_len=ATTN_STEPPING + 1)
        tok = greedy(lp)[:, None]
        e_pre = rel_err(lp, ls)
        e_next = rel_err(S.decode_step(m32, cp, tok)[0],
                         S.decode_step(m32, cs, tok)[0])
        checks["qwen3_prefill_vs_stepping"] = {"prefill": e_pre,
                                               "next_step": e_next}
        print(f"    qwen3-1.7b prefill vs prefill_by_stepping, fp32 1x"
              f"{ATTN_STEPPING}: rel err {e_pre:.2e}, next decode step "
              f"{e_next:.2e} (tol {FP32_REL_TOL:g})", flush=True)
        if not max(e_pre, e_next) <= FP32_REL_TOL:
            raise AssertionError(f"qwen3-1.7b prefill vs prefill_by_stepping:"
                                 f" {e_pre}, {e_next}")
        # the int8 KV cache: bf16 weights, batch 8, the same prompts and
        # tokens as the bf16 run
        prompts, tokens, logits16, r16 = bf16_b8
        m8 = cast_params(m32, dataclasses.replace(cfg16, kv_quant=True))
        del models, m32
        torch.cuda.empty_cache()
        r8, logits8, _ = serve(m8, prompts, "bf16 int8 cache", tokens=tokens)
        gap = [rel_err(a, b) for a, b in zip(logits8, logits16)]
        r8["rel_err_vs_bf16_cache"] = {"prefill": gap[0],
                                       "decode": max(gap[1:])}
        runs.append(r8)
        print(f"    int8 cache against the bf16 cache (graph logits, the "
              f"same tokens): prefill {gap[0]:.2e}, decode steps "
              f"{max(gap[1:]):.2e}; ms per token int8 {r8['decode_ms']:.3f}"
              f", bf16 {r16['decode_ms']:.3f}", flush=True)
        del m8, logits8, logits16, bf16_b8
        torch.cuda.empty_cache()

        # smollm-360m and internvl2-1b at full width and depth, bf16, batch 8
        for arch in ("smollm-360m", "internvl2-1b"):
            m = draw(get_config(arch))
            prompts = torch.randint(
                0, m.cfg.vocab_size, (8, ATTN_PROMPT),
                generator=torch.Generator().manual_seed(300)).to(dev)
            frontend = None
            if m.cfg.fusion_tokens:
                frontend = (torch.randn(
                    (8, m.cfg.fusion_tokens, m.cfg.d_model),
                    generator=torch.Generator().manual_seed(301)) * 0.5).to(
                        dev, m.cfg.torch_dtype)
            runs.append(serve(m, prompts, "bf16", frontend=frontend)[0])
            del m
            torch.cuda.empty_cache()

        # full width, depth cut
        reduced = []
        for arch in ("command-r-35b", "qwen1.5-110b", "qwen3-moe-235b-a22b"):
            full = get_config(arch)
            layers, why = DEPTH_CUTS[arch]
            note = (f"reduced: {arch} n_layers {full.n_layers} -> {layers} "
                    f"({why}); widths as published")
            print(f"    {note}", flush=True)
            reduced.append(note)
            m = draw(dataclasses.replace(full, n_layers=layers))
            prompts = torch.randint(
                0, m.cfg.vocab_size, (8, ATTN_PROMPT),
                generator=torch.Generator().manual_seed(400)).to(dev)
            if m.cfg.moe is not None:
                _, _, aux = hidden_states(m, prompts)
                checks["moe_prefill"] = {k: float(v) for k, v in aux.items()}
                checks["moe_oracle"] = moe_oracle(torch, dev, m)
                checks["moe_breakdown"] = lm_breakdown(torch, dev, m, 8,
                                                       ATTN_PROMPT)
                print(f"    {arch} prefill 8x{ATTN_PROMPT}: drop fraction "
                      f"{checks['moe_prefill']['drop_frac']:.4e}, aux loss "
                      f"{checks['moe_prefill']['aux_loss']:.4f}; layer 0 "
                      f"(CUDA events): " + ", ".join(
                          f"{k} {v:.3f}" for k, v in
                          checks["moe_breakdown"].items()), flush=True)
            runs.append(serve(m, prompts, "bf16")[0])
            del m
            torch.cuda.empty_cache()
        checks["reduced"] = reduced

        # llama4-maverick at its smoke config
        print(f"    {LLAMA4_NOTE}", flush=True)
        m = draw(get_config("llama4-maverick-400b-a17b", smoke=True))
        prompts = torch.randint(
            0, m.cfg.vocab_size, (8, LLAMA4_SMOKE_PROMPT),
            generator=torch.Generator().manual_seed(500)).to(dev)
        frontend = (torch.randn((8, m.cfg.fusion_tokens, m.cfg.d_model),
                                generator=torch.Generator().manual_seed(501))
                    * 0.5).to(dev, m.cfg.torch_dtype)
        r = serve(m, prompts, m.cfg.dtype, frontend=frontend,
                  gen=LLAMA4_SMOKE_MAX_LEN - LLAMA4_SMOKE_PROMPT
                  - m.cfg.fusion_tokens)[0]
        if r["cache_slots"] != [m.cfg.sliding_window, LLAMA4_SMOKE_MAX_LEN]:
            raise AssertionError(f"llama4 smoke: caches of {r['cache_slots']}"
                                 " slots, not the window's ring and the "
                                 "global layer's whole sequence")
        runs.append(r)
        del m
        torch.cuda.empty_cache()
    checks["profiles_retried"] = srv.lost
    return runs, srv.totals, srv.replayed, srv.variants, checks


def moe_oracle(torch, dev, model):
    """Layer 0's MoE block (``moe_forward``) against ``moe_dense_ref`` on
    the card, on seeded inputs of a batch-8 decode step (8 tokens) and a
    batch-1 512-token prefill, in bf16 (within BF16_REL_TOL) and with the
    block's weights in fp32 (within FP32_REL_TOL), each where no copy was
    dropped; at least one input of each dtype must drop nothing."""
    from repro_torch.measure import rel_err
    from repro_torch.models import moe
    cfg = model.cfg.moe
    p16 = model.blocks[0].moe
    p32 = moe.MoE(model.cfg.d_model, cfg, model.cfg.d_ff,
                  generator=torch.Generator(), dtype=torch.float32,
                  device="meta").to_empty(device=dev)
    for a, b in zip(p32.parameters(), p16.parameters(), strict=True):
        a.copy_(b)
    gen = torch.Generator().manual_seed(9)
    out = {}
    for dt, p, tol in (("bf16", p16, BF16_REL_TOL),
                       ("fp32", p32, FP32_REL_TOL)):
        compared = 0
        for shape in ((8, 1), (1, ATTN_PROMPT)):
            x = (torch.randn((*shape, model.cfg.d_model), generator=gen)
                 * 0.5).to(dev, p.w_gate_e.dtype)
            y, aux = moe.moe_forward(p, x, cfg)
            ref, _ = moe.moe_dense_ref(p, x, cfg)
            drop = float(aux["drop_frac"])
            e = rel_err(y, ref) if drop == 0 else None
            out[f"{dt} {shape[0]}x{shape[1]}"] = {"drop_frac": drop,
                                                  "rel_err": e, "tol": tol}
            print(f"    moe_forward vs moe_dense_ref, {dt} {shape[0]}x"
                  f"{shape[1]}: drop fraction {drop:.4e}, rel err "
                  + (f"{e:.2e} (tol {tol:g})" if e is not None else
                     "not compared (copies dropped)"), flush=True)
            if e is not None:
                compared += 1
                if not e <= tol:
                    raise AssertionError(f"moe_forward vs moe_dense_ref {dt}"
                                         f" {shape}: {e} > {tol}")
        if not compared:
            raise AssertionError(f"moe_forward vs moe_dense_ref {dt}: every "
                                 "input dropped copies")
    del p32
    torch.cuda.empty_cache()
    return out


def run_attn_mlp_phase():
    """:func:`run_attn_mlp` in a process of its own (this script with
    ``--attn-mlp-only``), as :func:`run_hymba_phase`, so that its profiled
    replays come in a process whose profiler has taken no trace before.  A
    failure of the phase raises here."""
    out = os.path.join(HERE, "build", "chip_smoke_attn_mlp.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    sys.stdout.flush()
    subprocess.run([sys.executable, os.path.abspath(__file__),
                    "--attn-mlp-only", out], check=True)
    with open(out) as fh:
        return json.load(fh)


#: Phase 9, whisper-small serving: prompt, greedy steps, the caches'
#: length (the decoder's context), the frames' seed.
WHISPER_PROMPT, WHISPER_GEN, WHISPER_MAX_LEN = 32, 64, 448
WHISPER_FRAMES = 1500


def whisper_pw_variants(model, batch: int, prompt_len: int) -> dict:
    """``pwconv``'s launches by variant in one whisper prefill and one
    decode step: the encoder's Linears and each cross attention's K/V
    projections over the B x 1500 frames, the rest over the B x S prompt
    (a decode step: over B rows, without the cross attention's K/V)."""
    from repro_torch.kernels import blocking
    enc_g = batch * model.cfg.encdec.enc_seq
    out = {ph: dict.fromkeys(blocking.PW_VARIANTS, 0)
           for ph in ("prefill", "decode")}

    def add(ph, g, w):
        out[ph][blocking.pw_variant(g, *w.shape, w.dtype)] += 1
    for block in model.enc_blocks:
        for name, p in block.named_parameters():
            if name.endswith(".w"):
                add("prefill", enc_g, p)
    for block in model.blocks:
        for name, p in block.named_parameters():
            if not name.endswith(".w"):
                continue
            if name in ("cross.w_k.w", "cross.w_v.w"):
                add("prefill", enc_g, p)
                continue
            add("prefill", batch * prompt_len, p)
            add("decode", batch, p)
    return out


def run_whisper(torch, dev):
    """Phase 9, whisper-small serving uncut (12 encoder and 12 decoder
    layers, d 768, 1500 encoder frames; random weights from seed 0 drawn
    on the card, bf16 cast from the fp32 draw): frames from seed 0
    (``launch.serve.frontend_stub``), a 32-token prompt, 64 greedy steps,
    caches of 448 positions; bf16 at batch 1 and 8, fp32 at batch 1.  Each
    run is :meth:`LMServe.run`'s: the captured prefill (encoder and
    decoder, the frames a static buffer) and decode step against the eager
    ones bit for bit, every call against the plain path (``impl="torch"``),
    216 ``pwconv`` a prefill and 108 a decode step (each Linear's
    ``pw_variant``: the cross attention's K/V are cached, so a step
    projects its query alone), the encoder's K/V written by the prefill
    and never by a replayed decode step.  Also the encoder's own device ms
    (CUDA events, eager) beside the prefill's.  Returns the runs, the
    wrappers' launches, the profiled replays' kernels and ``pwconv``'s
    launches by variant."""
    import dataclasses
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import frontend_stub
    from repro_torch.measure import graph_ms
    from repro_torch.models.transformer import (cast_params, init_params,
                                                run_encoder)
    srv = LMServe(torch, dev)
    runs = []
    with torch.inference_mode():
        cfg16 = get_config("whisper-small")
        t0 = time.perf_counter()
        m32 = init_params(dataclasses.replace(cfg16, dtype="float32"),
                          generator=torch.Generator(dev).manual_seed(0),
                          device=dev)
        n = sum(p.numel() for p in m32.parameters())
        print(f"  whisper-small: {cfg16.encdec.n_enc_layers} encoder + "
              f"{cfg16.n_layers} decoder layers, {n / 1e6:.1f}M random "
              f"parameters from seed 0 drawn on the card in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        models = {"float32": m32, "bfloat16": cast_params(m32, cfg16)}
        for dtype, batch in (("bfloat16", 1), ("bfloat16", 8),
                             ("float32", 1)):
            m = models[dtype]
            frames = frontend_stub(m.cfg, batch, dev, seed=0)
            prompts = torch.randint(
                0, m.cfg.vocab_size, (batch, WHISPER_PROMPT),
                generator=torch.Generator().manual_seed(600 + batch)).to(dev)
            r, _, _ = srv.run(m, prompts, dtype, gen=WHISPER_GEN,
                              frontend=frames, max_len=WHISPER_MAX_LEN,
                              by_want=whisper_pw_variants(m, batch,
                                                          WHISPER_PROMPT))
            r["encoder_ms"] = graph_ms(lambda: run_encoder(m, frames), dev,
                                       launches=1, reps=3)
            pre = sum(r["prefill_device_ms"].values()) if r[
                "prefill_device_ms"] else None
            r["encoder_share"] = r["encoder_ms"] / pre if pre else None
            r["enc_kv_mib"] = 2 * m.cfg.n_layers * batch * (
                m.cfg.encdec.enc_seq * m.cfg.d_model
                * torch.empty((), dtype=m.cfg.torch_dtype).element_size()
            ) / 2**20
            print(f"      encoder (a CUDA graph's replay) "
                  f"{r['encoder_ms']:.2f} ms = {pct(r['encoder_share'])} of "
                  f"the prefill's device time; the encoder's K/V in the cache "
                  f"{r['enc_kv_mib']:.1f} MiB", flush=True)
            runs.append(r)
        del models, m32
        torch.cuda.empty_cache()
    return runs, srv.totals, srv.replayed, srv.variants


def run_whisper_phase():
    """:func:`run_whisper` in a process of its own (``--whisper-only``), as
    :func:`run_hymba_phase`.  A failure of the phase raises here."""
    out = os.path.join(HERE, "build", "chip_smoke_whisper.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    sys.stdout.flush()
    subprocess.run([sys.executable, os.path.abspath(__file__),
                    "--whisper-only", out], check=True)
    with open(out) as fh:
        return json.load(fh)


#: The whole script's time budget on one H100, in seconds: the paths
#: before phase 11 took 730-790 s, and phase 11 (sharded serving) may add
#: about 60.  Printed against the run's total; the limit that fails a run
#: is the caller's.
TIME_BUDGET_S = 900

#: Phase 10, training: smollm-360m's batch, sequence, steps, checkpoint
#: period and the step the fault is injected at; the learning rate.
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_CKPT, TRAIN_FAULT = 8, 256, 20, \
    10, 15
TRAIN_LR = 1e-3
#: xlstm-125m (at XLSTM_LAYERS) in the same loop (8 x 256 tokens): steps,
#: checkpoint period, the step the fault is injected at.  Fewer than
#: smollm's: an eager step takes seconds on the host (the sLSTM loop's ~20
#: small launches a time step, run forward, again in the remat, in the chunk
#: checkpoint's recompute and backward), and the clean run takes the eager
#: step beside the graph.  The fault comes at the step after a checkpoint,
#: so the recovery reloads the state from disk and reruns no step it had
#: taken.
XLSTM_STEPS, XLSTM_CKPT, XLSTM_FAULT = 3, 2, 2
#: hymba-1.5b at full width, its depth cut for the script's time: layers,
#: batch, tokens (the 128 meta tokens come on top), steps.
HYMBA_TRAIN_LAYERS, HYMBA_TRAIN_BATCH, HYMBA_TRAIN_SEQ, HYMBA_TRAIN_STEPS = \
    4, 2, 512, 6
HYMBA_TRAIN_NOTE = ("reduced: hymba-1.5b n_layers 32 -> 4 for the training "
                    "run (the script's time); widths, window and meta "
                    "tokens as published")
#: Steps the graph and the eager step take side by side, compared after
#: each, where no loop runs (whisper, qwen3-moe, smollm's variants).
COMPARE_STEPS = 3
#: whisper-small uncut, in its own dtype: batch and tokens (the 1500
#: encoder frames come on top).
WHISPER_TRAIN_BATCH, WHISPER_TRAIN_SEQ = 2, 64
#: qwen3-moe at full width for the graph-against-eager check, cut to one
#: layer (3.7 B parameters), bf16 moments, the eager steps run before the
#: graph's (:func:`run_training`'s ``compare_in_sequence``); batch, tokens.
MOE_TRAIN_LAYERS, MOE_TRAIN_BATCH, MOE_TRAIN_SEQ = 1, 2, 256
MOE_TRAIN_NOTE = ("reduced: qwen3-moe-235b-a22b n_layers 94 -> 1 for the "
                  "training check, moments in bf16: the functional eager "
                  "step holds its input and its output state, 2 x 37 GB "
                  "with fp32 moments, and so does not fit the 80 GB card "
                  "with its gradients and AdamW's fp32 temporaries (nor at "
                  "phase 8b's 2 layers); widths as published")
#: smollm-360m at full width cut to 2 layers, 8 x 256: the step's options
#: the loop does not take (microbatches, compression).
SMOLLM_VARIANTS = ((2, "none"), (1, "topk"), (1, "int8"))
#: train_e2e's steps on the card (its own 4 x 128 batch).
E2E_STEPS = 60


def grad_errors(got: dict, want: dict) -> dict:
    """Each gradient's largest difference over its largest magnitude; a
    gradient below 1e-6 of the largest of all (zero in exact arithmetic,
    as a cross attention's key bias) over that largest instead."""
    top = max(float(w.abs().max()) for w in want.values())
    out = {}
    for name, g in got.items():
        w = want[name].float()
        scale = float(w.abs().max())
        scale = top if scale < 1e-6 * top else scale
        out[name] = float((g.float() - w).abs().max()) / scale
    return out


def state_leaves(tree, prefix=""):
    """(path, tensor) of every tensor of a train state or metrics dict."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from state_leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def fingerprints(torch, tree) -> dict:
    """Each tensor's bits as two int64 sums (mod 2**64), taken on its
    device in chunks: the bits as integers, and the same weighted by
    their position mod 8191 plus one.  Equal tensors give equal pairs;
    one differing element always changes the weighted sum."""
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    out = {}
    for k, v in state_leaves(tree):
        bits = v.detach().reshape(-1).view(ints[v.element_size()])
        plain = weighted = 0
        for i in range(0, bits.numel(), 1 << 26):
            c = bits[i:i + (1 << 26)].to(torch.int64)
            pos = torch.arange(i, i + c.numel(), device=c.device) % 8191 + 1
            plain += int(c.sum())
            weighted += int((c * pos).sum())
        out[k] = (str(v.dtype), tuple(v.shape), plain, weighted)
    return out


def differing(torch, got: dict, want: dict) -> list:
    """The paths whose tensors differ in a bit (or in dtype), or that one
    side lacks."""
    got, want = dict(state_leaves(got)), dict(state_leaves(want))
    bad = sorted(set(got) ^ set(want))
    return bad + [k for k in sorted(set(got) & set(want))
                  if got[k].dtype != want[k].dtype
                  or not torch.equal(got[k], want[k])]


def run_training(torch, dev):
    """Phase 10, training on one card, deterministic
    (``torch.use_deterministic_algorithms(True)``, the process started
    with ``CUBLAS_WORKSPACE_CONFIG``):

    * step-1 gradients, the kernel path against the plain path
      (``impl="torch"``), fp32, every gradient within FP32_REL_TOL of its
      largest magnitude, and the step's launches as
      ``launch.train.expected_train_launches`` counts them: smollm-360m at
      full width cut to 2 layers (8 x 256), xlstm-125m cut to 2 layers
      (one mLSTM, one sLSTM; 8 x 256), hymba-1.5b cut to 1 layer (2 x 512
      tokens and the 128 meta tokens), whisper-small uncut (2 x 64 tokens
      and 1500 frames);
    * the captured train step (``train_step.capture_train_step``: one
      CUDA graph of loss, backward, compression and AdamW, the state
      updated in place) against the eager step (``make_train_step``):
      both from the same state on the same batches, in turns (graph,
      eager), the parameters, moments, step, error and metrics bit for
      bit after every step, and the graph's recorded launches
      ``expected_train_launches`` (times the microbatches): smollm-360m
      and xlstm-125m cut to 4 layers (bf16, 8 x 256), hymba-1.5b at full
      width cut to 4 layers (2 x 512 + 128 meta tokens), whisper-small
      uncut with its frames, qwen3-moe at full width cut (:data:`MOE_TRAIN_NOTE`),
      smollm-360m cut to 2 layers with 2 microbatches, with top-k and
      with int8 compression;
    * the fault-tolerant loop through the captured step (AdamW, fp32
      moments): smollm-360m for 20 steps (checkpoints every 10) and
      xlstm-125m for 3 (every 2), each clean, with the eager step beside
      the graph at every step (the clean eager run), then again with a
      fault (step 15, step 2); hymba's 6 steps clean: the loss finite and
      falling, and the run with the fault ending with the clean graph
      run's state and the clean eager run's, bit for bit;
    * for each model: ms a step for the graph and the eager step (host
      clock, median, taken in turns), trained tokens/s, the capture's
      seconds, each step's own peak memory (the capture's: warm-up,
      recording and first replay; a replay's; an eager step's), busy
      share and device events a step of each (profiler), hymba's
      selective scan in one layer (device ms forward and backward, own
      peak);
    * ``train_e2e`` (the port's ``examples/train_e2e.py``) for
      :data:`E2E_STEPS` steps through its captured step: the mean loss of
      the last 10 steps below the first 10's.

    Returns the records, the wrappers' launches, and the kernels the
    profiled steps ran (by launch counter)."""
    import dataclasses
    import shutil
    import torch.nn.functional as F
    from repro_torch import graphs, train_e2e
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig, DataIterator
    from repro_torch.kernels.policy import KernelPolicy
    from repro_torch.launch.serve import frontend_stub
    from repro_torch.launch.train import (TRAIN_COUNTERS,
                                          deterministic_card,
                                          expected_train_launches)
    from repro_torch.measure import device_profile, profile_calls
    from repro_torch.models.layers import trainable_
    from repro_torch.models.ssm import selective_scan
    from repro_torch.models.transformer import init_params
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.compress import CompressionConfig
    from repro_torch.train.train_step import (TrainConfig, accumulate_grads,
                                              bind_params_,
                                              capture_train_step,
                                              init_train_state,
                                              make_train_step)
    from repro_torch.train.trainer import (FaultInjector, LoopConfig,
                                           train_loop)
    deterministic_card()
    plain = KernelPolicy(impl="torch")
    totals = dict.fromkeys(TRAIN_COUNTERS, 0)
    profiled = dict.fromkeys(TRAIN_COUNTERS, 0)
    out = {}

    def counted(fn, want=None, label=""):
        """``fn()``'s wrapper launches (a snapshot before and after), held
        to ``want`` and added to the totals."""
        before = graphs.snapshot()
        r = fn()
        torch.cuda.synchronize(dev)
        moved = graphs.delta(before, graphs.snapshot())
        got = {k: moved[k] for k in TRAIN_COUNTERS}
        if want is not None and got != want:
            raise AssertionError(f"{label}: launches {got}, expected {want}")
        for k in totals:
            totals[k] += got[k]
        return r, got

    def draw(cfg):
        return trainable_(init_params(
            cfg, generator=torch.Generator(dev).manual_seed(0), device=dev))

    def data(cfg, seq, batch):
        dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                          global_batch=batch, seed=0)
        return dcfg, next(DataIterator(dcfg, prefetch=0))

    def gated_grads(label, m, batch):
        params = {n: p.detach() for n, p in m.named_parameters()}
        want = expected_train_launches(m.cfg)
        (lk, _, gk), got = counted(
            lambda: accumulate_grads(m, params, batch), want, label)
        lp, _, gp = accumulate_grads(m, params, batch, policy=plain)
        errs = grad_errors(gk, gp)
        worst = max(errs, key=errs.get)
        r = {"loss": float(lk), "plain_loss": float(lp),
             "max_grad_rel_err": errs[worst], "worst": worst,
             "tol": FP32_REL_TOL, "launches": got}
        print(f"    {label}: loss {r['loss']:.6f} (plain {r['plain_loss']:.6f})"
              f", gradients kernel vs plain: worst {errs[worst]:.2e} at "
              f"{worst} (tol {FP32_REL_TOL:g}); launches {got} (forward, "
              "remat, backward)", flush=True)
        if not (np_isfinite(r["loss"]) and errs[worst] <= FP32_REL_TOL):
            raise AssertionError(f"{label}: {r}")
        return r

    def own_peak(fn):
        """(``fn()``, ms on the host clock, synced, and the bytes it
        allocated at its peak above what was allocated before it)."""
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - t0) * 1e3
        return r, ms, torch.cuda.max_memory_allocated(dev) - before

    def tcfg_of(steps, mb=1, kind="none", moments="float32"):
        return TrainConfig(
            optimizer=AdamWConfig(lr=TRAIN_LR, warmup_steps=max(2, steps // 4),
                                  total_steps=steps, moments_dtype=moments),
            microbatches=mb, compression=CompressionConfig(kind=kind))

    class Pair:
        """The captured step of ``m`` and its eager step from one state:
        :meth:`step` takes the graph's step and then the eager step on the
        same batch (each on its own state, timed and its own peak taken),
        and records every path where the two differ.  With ``capture``
        false the graph is captured later (:meth:`capture`), after the
        eager steps (:func:`compare_in_sequence`)."""

        def __init__(self, label, m, tcfg, batch, seq, capture=True):
            self.label, self.tcfg = label, tcfg
            self.mb = tcfg.microbatches
            self.want = {k: n * self.mb
                         for k, n in expected_train_launches(m.cfg).items()}
            self.state0 = init_train_state(m, tcfg)
            self.eager = make_train_step(m, tcfg)
            self.shadow = self.state0
            self.times = {"graph": [], "eager": []}
            self.peaks = {"graph": [], "eager": []}
            self.mismatch = []
            self.frames = None
            self.in_turns, self.eager_trace = True, None
            if capture:
                self.capture(m, batch, seq)

        def capture(self, m, batch, seq):
            (self.cap, cap_ms, self.capture_peak), got = counted(
                lambda: own_peak(lambda: capture_train_step(m, self.tcfg,
                                                            batch, seq)),
                {k: 2 * n for k, n in self.want.items()},
                f"{self.label} capture (warm-up and recording)")
            self.capture_wall_ms = cap_ms
            rec = {k: self.cap.captured.launches.get(k, 0) for k in self.want}
            if rec != self.want:
                raise AssertionError(f"{self.label}: the graph recorded "
                                     f"{rec}, expected {self.want}")

        def step(self, state, batch):
            if self.frames is not None:
                batch = dict(batch, frontend=self.frames)
            (new, mg), gms, gpk = own_peak(lambda: self.cap(state, batch))
            ((self.shadow, me), ems, epk), _ = counted(
                lambda: own_peak(lambda: self.eager(self.shadow, batch)),
                self.want, f"{self.label} eager step")
            for k, v in (("graph", gms), ("eager", ems)):
                self.times[k].append(v)
            self.peaks["graph"].append(gpk)
            self.peaks["eager"].append(epk)
            bad = differing(torch, new, self.shadow) + [
                f"metrics/{k}" for k in differing(torch, mg, me)]
            if bad:
                self.mismatch.append({"step": int(self.cap.step),
                                      "paths": bad[:8], "n": len(bad)})
            return new, mg

        def summary(self, tokens, batch, profile=True, eager_profile=True):
            """Timings, memory and (``profile``) one profiled step of each:
            the graph's replay (its kernels held to the launches it
            recorded) and (``eager_profile``) the eager step; without the
            latter the eager step's busy share is the graph's device ms
            over the eager ms (the same kernels)."""
            g = statistics.median(self.times["graph"])
            e = statistics.median(self.times["eager"])
            r = {"graph_ms": g, "eager_ms": e, "speedup": e / g,
                 "graph_tokens_per_s": tokens * 1e3 / g,
                 "eager_tokens_per_s": tokens * 1e3 / e,
                 "graph_ms_all": self.times["graph"],
                 "eager_ms_all": self.times["eager"],
                 "capture_s": self.cap.captured.capture_s,
                 "capture_wall_ms": self.capture_wall_ms,
                 "capture_own_peak_bytes": self.capture_peak,
                 "replay_own_peak_bytes": max(self.peaks["graph"]),
                 "eager_own_peak_bytes": max(self.peaks["eager"]),
                 "graph_launches": self.want, "microbatches": self.mb,
                 "steps_compared": len(self.times["graph"]),
                 "in_turns": self.in_turns,
                 "bit_equal": not self.mismatch,
                 "mismatch": self.mismatch}
            if profile:
                if self.frames is not None:
                    batch = dict(batch, frontend=self.frames)
                state = self.cap.state
                gdev, gran, retakes = profile_calls(
                    lambda: self.cap(state, batch), self.want, reps=1,
                    tries=3)
                ran = {k: gran.get(k, 0) for k in self.want}
                if ran != self.want:
                    raise AssertionError(f"{self.label}: a replay ran {ran} "
                                         f"(profiler), expected {self.want}")
                if self.eager_trace is not None:
                    edev, eran = self.eager_trace
                elif eager_profile:
                    edev, eran = device_profile(
                        lambda: self.eager(self.shadow, batch), reps=1,
                        warmup=False)
                else:
                    edev, eran = gdev, {}
                for k in profiled:
                    profiled[k] += gran.get(k, 0) + eran.get(k, 0)
                r.update({
                    "graph_device_ms": sum(gdev.values()),
                    "graph_device_ms_by_kernel": gdev,
                    "graph_busy": sum(gdev.values()) / g if gdev else None,
                    "graph_device_events": gran.get("device_events"),
                    "graph_profiled_launches": ran,
                    "graph_profile_retakes": retakes,
                    "eager_device_ms": sum(edev.values()),
                    "eager_busy": sum(edev.values()) / e if edev else None,
                    "eager_device_events": eran.get("device_events"),
                    "eager_profiled": (eager_profile
                                       or self.eager_trace is not None)})
            print(f"    {self.label}: graph {g:.1f} ms a step, eager "
                  f"{e:.1f} ms (median of {len(self.times['graph'])}, "
                  + ("in turns" if self.in_turns else "the eager steps "
                     "first") + f"; {e / g:.2f}x), {r['graph_tokens_per_s']:.0f} / "
                  f"{r['eager_tokens_per_s']:.0f} trained tokens/s; capture "
                  f"{r['capture_s']:.2f} s ({self.capture_wall_ms / 1e3:.1f}"
                  f" s with the warm-up and first replay); own peak: capture "
                  f"{self.capture_peak / 2**30:.2f} GiB, replay "
                  f"{r['replay_own_peak_bytes'] / 2**20:.1f} MiB, eager step "
                  f"{r['eager_own_peak_bytes'] / 2**30:.2f} GiB; graph "
                  f"launches {self.want} (= expected_train_launches x "
                  f"{self.mb})" + (
                      f"; device ms graph {r['graph_device_ms']:.1f} (busy "
                      f"{pct(r['graph_busy'])}, {r['graph_device_events']} "
                      f"device events), eager {r['eager_device_ms']:.1f} "
                      f"(busy {pct(r['eager_busy'])}, "
                      + (f"{r['eager_device_events']} device events)"
                         if eager_profile else "the graph's device ms: not "
                         "profiled, its trace takes tens of seconds)")
                      if profile else "")
                  + f"; bit for bit after every step: {r['bit_equal']}",
                  flush=True)
            if self.mismatch:
                raise AssertionError(f"{self.label}: graph and eager steps "
                                     f"differ: {self.mismatch}")
            return r

    def compare(label, m, tcfg, dcfg, frames=None, profile=True):
        """:data:`COMPARE_STEPS` steps of the graph and the eager step on
        the data steps 0, 1, ... of ``dcfg``."""
        tokens = dcfg.global_batch * dcfg.seq_len
        pair = Pair(label, m, tcfg, dcfg.global_batch, dcfg.seq_len)
        pair.frames = frames
        it = DataIterator(dcfg, prefetch=0)
        # only the first step reads the first state: let it go after it
        state, pair.state0 = pair.state0, None
        for _ in range(COMPARE_STEPS):
            batch = next(it)
            state, _ = pair.step(state, batch)
        r = pair.summary(tokens, batch, profile)
        del pair
        torch.cuda.empty_cache()
        return r

    def compare_in_sequence(label, m, tcfg, dcfg):
        """:func:`compare` for a model whose graph and eager step do not
        fit the card side by side (the functional eager step holds its
        input and its output state): the eager step's
        :data:`COMPARE_STEPS` steps first, each state's leaf fingerprints
        and the metrics kept, the last state copied to the host and one
        more eager step profiled; the eager state freed, the model given
        back its first weights (from a host copy: the eager step binds its
        state's parameters to the model), the graph captured and run from
        the same state on the same batches, held
        to the fingerprints and metrics after each step and to the host
        copy, bit for bit, at the end."""
        tokens = dcfg.global_batch * dcfg.seq_len
        pair = Pair(label, m, tcfg, dcfg.global_batch, dcfg.seq_len,
                    capture=False)
        pair.in_turns, pair.state0 = False, None   # the card holds 3 states
        it = DataIterator(dcfg, prefetch=0)
        batches = [next(it) for _ in range(COMPARE_STEPS)]
        first = {n: p.detach().cpu() for n, p in m.named_parameters()}
        marks = []
        for batch in batches:
            ((pair.shadow, me), ms, pk), _ = counted(
                lambda: own_peak(lambda: pair.eager(pair.shadow, batch)),
                pair.want, f"{label} eager step")
            pair.times["eager"].append(ms)
            pair.peaks["eager"].append(pk)
            marks.append((fingerprints(torch, pair.shadow),
                          {k: v.cpu() for k, v in me.items()}))
        edev, eran = device_profile(lambda: pair.eager(pair.shadow, batch),
                                    reps=1, warmup=False)
        pair.eager_trace = edev, eran
        last = {k: v.cpu() for k, v in state_leaves(pair.shadow)}
        pair.shadow = None
        bind_params_(m, {n: t.to(dev) for n, t in first.items()})
        del first
        torch.cuda.empty_cache()
        pair.capture(m, dcfg.global_batch, dcfg.seq_len)
        state = pair.cap.state
        for i, batch in enumerate(batches):
            (state, mg), ms, pk = own_peak(lambda: pair.cap(state, batch))
            pair.times["graph"].append(ms)
            pair.peaks["graph"].append(pk)
            fp, me = marks[i]
            got = fingerprints(torch, state)
            bad = sorted(k for k in set(fp) | set(got)
                         if fp.get(k) != got.get(k)) + [
                f"metrics/{k}" for k in me if not torch.equal(mg[k].cpu(),
                                                              me[k])]
            if i == len(batches) - 1:
                bad += [f"{k} (the host copy)" for k, v in state_leaves(state)
                        if not torch.equal(v.cpu(), last[k])]
            if bad:
                pair.mismatch.append({"step": i + 1, "paths": bad[:8],
                                      "n": len(bad)})
        del last
        r = pair.summary(tokens, batches[-1])
        del pair
        torch.cuda.empty_cache()
        return r

    def loop_runs(name, m, dcfg, steps, ckpt_every, fault=None,
                  eager_profile=True):
        """The loop through the captured step: clean, with the eager step
        beside the graph at every step (:class:`Pair`; its eager side is
        the clean eager run), then (``fault``) again through the graph
        alone with a fault injected at that step."""
        n = sum(p.numel() for p in m.parameters())
        tcfg = tcfg_of(steps)
        tokens = dcfg.global_batch * dcfg.seq_len
        pair = Pair(name, m, tcfg, dcfg.global_batch, dcfg.seq_len)
        loop = LoopConfig(total_steps=steps, ckpt_every=ckpt_every,
                          log_every=5, keep_ckpts=1)
        runs = []
        for f in (None, fault) if fault else (None,):
            ckpt = os.path.join(HERE, "build", "chip_smoke_ckpt",
                                f"{name}_fault_{f}")
            shutil.rmtree(ckpt, ignore_errors=True)
            times = []

            def graph_only(state, batch):
                (r, ms, _) = own_peak(lambda: pair.cap(state, batch))
                times.append(ms)
                return r
            t0 = time.perf_counter()
            final, info = train_loop(
                pair.step if f is None else graph_only, pair.state0, dcfg,
                loop, ckpt,
                fault_injector=FaultInjector({f: "sim-device-loss"})
                if f else None,
                log=lambda line: print("      " + line, flush=True))
            wall = time.perf_counter() - t0
            shutil.rmtree(ckpt, ignore_errors=True)
            hist = info["history"]
            losses = [h["loss"] for h in hist]
            runs.append({"fault_at": f, "steps": len(hist),
                         "failures": info["failures"], "losses": losses,
                         "seconds": wall, "stragglers": info["stragglers"],
                         "graph_ms": statistics.median(
                             times or pair.times["graph"]),
                         # the clean run's final state, kept past the
                         # fault run, which overwrites the graph's buffers
                         "final": {k: v.clone() for k, v in
                                   state_leaves(final)}})
            print(f"    {name} ({n / 1e6:.1f}M parameters, "
                  f"{m.cfg.dtype}) {dcfg.global_batch}x{dcfg.seq_len}, "
                  f"{len(hist)} steps through the graph"
                  + (f", fault at step {f}" if f else
                     " with the eager step beside it")
                  + f": loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
                  f"{info['failures']} failures; {wall:.1f} s with "
                  "checkpoints", flush=True)
        clean = runs[0]
        q = max(1, steps // 4)
        head = statistics.mean(clean["losses"][:q])
        tail = statistics.mean(clean["losses"][-q:])
        falling = tail < head
        finite = all(np_isfinite(x) for x in clean["losses"])
        eager_final = dict(state_leaves(pair.shadow))
        same = same_eager = None
        if fault:
            faulty = runs[1]["final"]
            same = runs[1]["failures"] == 1 and all(
                torch.equal(clean["final"][k], faulty[k]) for k in faulty)
            same_eager = all(torch.equal(eager_final[k], faulty[k])
                             for k in faulty)
        for r in runs:
            del r["final"]
        print(f"    {name}: loss finite {finite}, falling {falling} (mean of "
              f"the first {q} {head:.4f}, last {q} {tail:.4f}); the clean "
              f"graph run equals the eager step at every step: "
              f"{not pair.mismatch}"
              + (f"; the run with the fault at step {fault} ends with the "
                 f"clean graph run's state bit for bit: {same}, and with the "
                 f"clean eager run's: {same_eager}" if fault else ""),
              flush=True)
        if not (finite and falling and clean["failures"] == 0
                and same is not False and same_eager is not False):
            raise AssertionError(f"{name} training: finite {finite}, "
                                 f"falling {falling}, clean failures "
                                 f"{clean['failures']}, bit-exact recovery "
                                 f"{same} / {same_eager}")
        _, first = data(m.cfg, dcfg.seq_len, dcfg.global_batch)
        r = pair.summary(tokens, first, eager_profile=eager_profile)
        del pair
        torch.cuda.empty_cache()
        return {"parameters": n, "runs": runs, "bit_exact_recovery": same,
                "bit_exact_vs_eager": same_eager, **r}

    def scan_profile(m, batch, length):
        """hymba's selective scan at one layer's training shape (the first
        layer's ``a_log``, fp32 inputs from a seed): device ms of the
        forward under autograd and of its backward (profiler)."""
        mm = m.blocks[0].mamba
        di, n = mm.a_log.shape
        g = torch.Generator(dev).manual_seed(1)

        def rnd(*shape):
            return torch.randn(shape, generator=g, device=dev)
        ins = [rnd(batch, length, di), F.softplus(rnd(batch, length, di) - 4),
               -torch.exp(mm.a_log.detach()), rnd(batch, length, n),
               rnd(batch, length, n), mm.d_skip.detach().clone()]
        ins = [t.requires_grad_(True) for t in ins]
        fwd = lambda: selective_scan(*ins, chunk=m.cfg.ssm.chunk)  # noqa: E731
        gy = rnd(batch, length, di)
        # the layer's own peak: one forward under autograd and its backward
        _, _, peak = own_peak(lambda: torch.autograd.grad(fwd()[0], ins, gy))
        y, _ = fwd()
        fwd_ms, _ = device_profile(fwd, reps=3)
        bwd_ms, ran = device_profile(lambda: torch.autograd.grad(
            y, ins, gy, retain_graph=True), reps=3)
        r = {"shape": [batch, length, di, n], "chunk": m.cfg.ssm.chunk,
             "forward_device_ms": sum(fwd_ms.values()),
             "backward_device_ms": sum(bwd_ms.values()),
             "backward_device_events": ran.get("device_events"),
             "own_peak_bytes": peak}
        print(f"    hymba's selective scan, one layer ({batch}x{length}, "
              f"d_inner {di}, N {n}, chunk {r['chunk']}, fp32): forward "
              f"{r['forward_device_ms']:.2f} device ms under autograd, "
              f"backward {r['backward_device_ms']:.2f} device ms "
              f"({r['backward_device_events']} device events); own peak of "
              f"a forward and its backward {peak / 2**20:.0f} MiB",
              flush=True)
        return r

    seconds = out["seconds"] = {}
    t_part = [time.perf_counter()]

    def lap(label):
        now = time.perf_counter()
        seconds[label] = now - t_part[0]
        t_part[0] = now
        print(f"    ({label}: {seconds[label]:.1f} s)", flush=True)

    # step-1 gradients, kernel against plain, fp32, depth cut
    cfg = get_config("smollm-360m")
    xcfg = get_config("xlstm-125m")
    hcfg = get_config("hymba-1.5b")
    for label, c, layers, seq, batch in (
            ("smollm-360m", cfg, 2, TRAIN_SEQ, TRAIN_BATCH),
            ("xlstm-125m", xcfg, 2, TRAIN_SEQ, TRAIN_BATCH),
            ("hymba-1.5b", hcfg, 1, HYMBA_TRAIN_SEQ, HYMBA_TRAIN_BATCH)):
        cut = dataclasses.replace(c, n_layers=layers, dtype="float32")
        note = (f"reduced: {label} n_layers {c.n_layers} -> {layers} and "
                "fp32 for the step-1 gradient check only (the kernel-vs-"
                "plain oracle); widths as published")
        print(f"    {note}", flush=True)
        m = draw(cut)
        _, first = data(cut, seq, batch)
        out[f"{label}_step1_grads"] = dict(gated_grads(
            f"{label} ({layers} layers, fp32) step 1, {batch}x{seq}", m,
            first), reduced=note)
        del m
        torch.cuda.empty_cache()
        lap(f"{label} step-1 gradients")

    # the loops through the captured step: smollm-360m uncut and
    # xlstm-125m at XLSTM_LAYERS, bf16, each with a fault run; hymba at 4
    # layers
    # (the eager xLSTM step is not profiled: the trace of its 192 k sLSTM
    # loop launches takes tens of seconds of the script's budget)
    for label, c, steps, ckpt_every, fault in (
            ("smollm-360m", cfg, TRAIN_STEPS, TRAIN_CKPT, TRAIN_FAULT),
            ("xlstm-125m", dataclasses.replace(xcfg, n_layers=XLSTM_LAYERS),
             XLSTM_STEPS, XLSTM_CKPT, XLSTM_FAULT)):
        if c.n_layers != get_config(label).n_layers:
            print(f"    {XLSTM_NOTE}", flush=True)
        m = draw(c)
        dcfg, _ = data(c, TRAIN_SEQ, TRAIN_BATCH)
        out[label] = loop_runs(label, m, dcfg, steps, ckpt_every, fault,
                               eager_profile=label != "xlstm-125m")
        if c.n_layers != get_config(label).n_layers:
            out[label]["reduced"] = XLSTM_NOTE
        del m
        torch.cuda.empty_cache()
        lap(f"{label} training")
    print(f"    {HYMBA_TRAIN_NOTE}", flush=True)
    hcut = dataclasses.replace(hcfg, n_layers=HYMBA_TRAIN_LAYERS)
    m = draw(hcut)
    dcfg, _ = data(hcut, HYMBA_TRAIN_SEQ, HYMBA_TRAIN_BATCH)
    out["hymba-1.5b"] = dict(loop_runs(
        "hymba-1.5b", m, dcfg, HYMBA_TRAIN_STEPS, HYMBA_TRAIN_STEPS),
        reduced=HYMBA_TRAIN_NOTE, scan=scan_profile(
            m, HYMBA_TRAIN_BATCH, HYMBA_TRAIN_SEQ + hcfg.meta_tokens))
    del m
    torch.cuda.empty_cache()
    lap("hymba-1.5b training and scan")

    # whisper-small uncut: a step-1 gradient check in fp32, then the graph
    # against the eager step in its own dtype, with its frames
    wcfg = get_config("whisper-small")
    wm = draw(dataclasses.replace(wcfg, dtype="float32"))
    dcfg, wb = data(wcfg, WHISPER_TRAIN_SEQ, WHISPER_TRAIN_BATCH)
    wb["frontend"] = frontend_stub(wm.cfg, WHISPER_TRAIN_BATCH, dev, seed=0)
    out["whisper_step"] = gated_grads(
        f"whisper-small (12+12 layers, fp32) step 1, {WHISPER_TRAIN_BATCH}x"
        f"{WHISPER_TRAIN_SEQ} tokens, {wcfg.encdec.enc_seq} frames", wm, wb)
    del wm, wb
    wm = draw(wcfg)
    out["whisper-small"] = compare(
        f"whisper-small ({wcfg.dtype}, {WHISPER_TRAIN_BATCH}x"
        f"{WHISPER_TRAIN_SEQ} + {wcfg.encdec.enc_seq} frames)", wm,
        tcfg_of(COMPARE_STEPS), dcfg, frames=frontend_stub(
            wcfg, WHISPER_TRAIN_BATCH, dev, seed=0))
    del wm
    torch.cuda.empty_cache()
    lap("whisper-small")

    # qwen3-moe at full width, cut
    print(f"    {MOE_TRAIN_NOTE}", flush=True)
    qcfg = get_config("qwen3-moe-235b-a22b")
    qcut = dataclasses.replace(qcfg, n_layers=MOE_TRAIN_LAYERS)
    m = draw(qcut)
    dcfg, _ = data(qcut, MOE_TRAIN_SEQ, MOE_TRAIN_BATCH)
    out["qwen3-moe"] = dict(compare_in_sequence(
        f"qwen3-moe ({MOE_TRAIN_LAYERS} layer, "
        f"{sum(p.numel() for p in m.parameters()) / 1e9:.2f}B parameters, "
        f"{qcfg.dtype}, bf16 moments, {MOE_TRAIN_BATCH}x{MOE_TRAIN_SEQ})", m,
        tcfg_of(COMPARE_STEPS, moments="bfloat16"), dcfg),
        reduced=MOE_TRAIN_NOTE)
    del m
    torch.cuda.empty_cache()
    lap("qwen3-moe")

    # smollm-360m at 2 layers: microbatches and the compressors
    scut = dataclasses.replace(cfg, n_layers=2)
    dcfg, _ = data(scut, TRAIN_SEQ, TRAIN_BATCH)
    out["smollm_variants"] = {}
    for mb, kind in SMOLLM_VARIANTS:
        m = draw(scut)
        out["smollm_variants"][f"mb{mb}_{kind}"] = compare(
            f"smollm-360m (2 layers, {cfg.dtype}) {TRAIN_BATCH}x{TRAIN_SEQ},"
            f" microbatches {mb}, compression {kind}", m,
            tcfg_of(COMPARE_STEPS, mb, kind), dcfg, profile=False)
        del m
        torch.cuda.empty_cache()
    lap("smollm-360m variants")

    # train_e2e: the port's examples/train_e2e.py, through its graph
    e2e_dir = os.path.join(HERE, "build", "chip_smoke_e2e")
    shutil.rmtree(e2e_dir, ignore_errors=True)
    hist_path = os.path.join(e2e_dir, "history.json")
    train_e2e.main(["--steps", str(E2E_STEPS), "--ckpt-dir",
                    os.path.join(e2e_dir, "ckpt"), "--out", hist_path])
    with open(hist_path) as fh:
        hist = json.load(fh)
    shutil.rmtree(e2e_dir, ignore_errors=True)
    losses = [h["loss"] for h in hist]
    first10, last10 = statistics.mean(losses[:10]), statistics.mean(
        losses[-10:])
    out["train_e2e"] = {"steps": len(hist), "first10": first10,
                        "last10": last10,
                        "ms_per_step": statistics.median(
                            h["time_s"] for h in hist) * 1e3}
    print(f"    train_e2e ({train_e2e.CONFIG_100M.name}, 4x128, "
          f"{len(hist)} steps through its graph): first10 {first10:.4f}, "
          f"last10 {last10:.4f}, {out['train_e2e']['ms_per_step']:.1f} ms a "
          "step (median, host clock)", flush=True)
    if not (len(hist) == E2E_STEPS and last10 < first10):
        raise AssertionError(f"train_e2e: {out['train_e2e']}")
    torch.cuda.empty_cache()
    lap("train_e2e")
    return out, totals, profiled


def np_isfinite(x: float) -> bool:
    return x == x and abs(x) != float("inf")


def run_training_phase():
    """:func:`run_training` in a process of its own (``--train-only``),
    started with ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` so that cuBLAS is
    deterministic from its first call.  A failure of the phase raises
    here."""
    out = os.path.join(HERE, "build", "chip_smoke_train.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    sys.stdout.flush()
    subprocess.run([sys.executable, os.path.abspath(__file__),
                    "--train-only", out], check=True,
                   env={**os.environ, "CUBLAS_WORKSPACE_CONFIG": ":4096:8"})
    with open(out) as fh:
        return json.load(fh)


# ---------------------------------------------------------------------------
# Phase 11: sharded serving on the one card
# ---------------------------------------------------------------------------

#: Part 1: qwen3-1.7b at full width and depth, bf16, batch 8, a 512-token
#: prompt and 8 greedy steps as CUDA graphs, world 1 under NCCL.
SHARD_BATCH, SHARD_PROMPT, SHARD_GEN = 8, 512, 8
#: Parts 2 and 3: two gloo ranks on the one card, batch 2, a 64-token
#: prompt, 4 greedy steps, eager.
TP_BATCH, TP_PROMPT, TP_GEN = 2, 64, 4
MOE_TP_NOTE = ("reduced: qwen3-moe-235b-a22b n_layers 94 -> 1 (phase 11's "
               "time, and two ranks' blocks on one card); widths as "
               "published")
#: Part 3 in bf16: the share of routed copies that the kernels' rounding
#: may send to another expert than the plain run's (near-ties of the
#: router); a few copies of the 2176 a run routes.
MOE_MOVED_MAX_FRAC = 0.01
#: A gloo rank waits at most this long at set-up or in a collective.
TP_TIMEOUT_S = 300
#: Parts 4-6: hymba, xLSTM and whisper at their published widths, cut in
#: depth (the two ranks' blocks and the unsharded oracle on one card, and
#: the script's time), fp32, tp 2, as parts 2 and 3 run.
RECURRENT_TP = {
    "hymba-1.5b": {"n_layers": 2},
    "xlstm-125m": {"n_layers": 4},
    "whisper-small": {"n_layers": 2, "n_enc_layers": 2},
}
RECURRENT_TP_NOTE = ("reduced: hymba-1.5b n_layers 32 -> 2, xlstm-125m 12 -> "
                     "4, whisper-small 12 + 12 -> 2 + 2 (phase 11's time); "
                     "widths, meta tokens and 1500 frames as published")


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_env(rank: int, world: int, port: int) -> None:
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))


def _greedy_run(torch, prefill, step, prompts, gen, tokens=None):
    """A prefill and ``gen`` greedy steps (``tokens`` fed instead of the
    greedy ones where given): (logits of each call, tokens fed, ms of the
    prefill, ms per step), timed with the host clock around synchronized
    calls."""
    from repro_torch.serve.sampler import greedy
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(prompts)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    outs, fed = [logits], []
    t0 = time.perf_counter()
    for i in range(gen):
        tok = greedy(logits)[:, None] if tokens is None else tokens[i]
        fed.append(tok)
        logits, cache = step(cache, tok)
        outs.append(logits)
    torch.cuda.synchronize()
    return outs, fed, prefill_ms, (time.perf_counter() - t0) * 1e3 / gen


def _tp_recurrent(torch, dev, rules, arch: str, rank: int) -> dict:
    """One of parts 4-6 on a gloo rank: ``arch`` at its published widths
    cut to :data:`RECURRENT_TP`'s depth, fp32, served at tp 2 (a prefill of
    TP_BATCH x TP_PROMPT tokens, TP_GEN greedy steps, eager) with the
    collectives and kernel launches of the prefill and of a step, this
    rank's first ``dwconv1d`` call (its channel block) held against the
    plain version, and on rank 0 the logits against the unsharded path."""
    import dataclasses
    import torch.distributed as dist
    from repro_torch import graphs
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import dwconv1d as dw1d
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import (collective_counts, frontend_stub,
                                          launch_counts)
    from repro_torch.measure import rel_err
    from repro_torch.models.transformer import init_params
    from repro_torch.serve import serve_step as S
    from repro_torch.sharding.rules import use_rules

    cut = dict(RECURRENT_TP[arch])
    cfg = get_config(arch)
    if "n_enc_layers" in cut:
        cut["encdec"] = dataclasses.replace(
            cfg.encdec, n_enc_layers=cut.pop("n_enc_layers"))
    cfg = dataclasses.replace(cfg, dtype="float32", **cut)
    ml = cfg.meta_tokens + TP_PROMPT + TP_GEN
    prompts = torch.randint(
        0, cfg.vocab_size, (TP_BATCH, TP_PROMPT),
        generator=torch.Generator().manual_seed(564)).to(dev)
    frames = frontend_stub(cfg, TP_BATCH, dev, seed=0)
    first = []
    real = ops.dwconv1d_causal

    def recording(x, f, **kw):
        if not first:
            first.append((x.clone(), f.clone(), x.is_contiguous()))
        return real(x, f, **kw)
    counted = {}

    def prefill(m, t):
        graphs.reset()
        out = S.prefill(m, t, max_len=ml, frontend=frames)
        counted["prefill"] = graphs.snapshot()
        graphs.reset()
        return out
    r = {}
    ops.dwconv1d_causal = recording
    try:
        with use_rules(rules):
            m = init_params(cfg, generator=torch.Generator(dev).manual_seed(0),
                            device=dev)
            outs, fed, pre_ms, step_ms = _greedy_run(
                torch, lambda t: prefill(m, t),
                lambda c, t: S.decode_step(m, c, t, max_len=ml), prompts,
                TP_GEN)
            step = {k: v / TP_GEN for k, v in graphs.snapshot().items()}
            del m
    finally:
        ops.dwconv1d_causal = real
    r.update(prefill_ms=pre_ms, decode_ms_per_step=step_ms,
             launches={"prefill": launch_counts(counted["prefill"]),
                       "decode": launch_counts(step)},
             collectives={"prefill": collective_counts(counted["prefill"]),
                          "decode": collective_counts(step)})
    if first:       # launches made to compare count in no main path
        x, f, contiguous = first[0]
        r["dwconv1d_check"] = {
            "shape": list(x.shape), "contiguous": contiguous,
            "rel_err": rel_err(dw1d.dwconv1d_causal(x, f),
                               dw1d.dwconv1d_causal_plain(x, f))}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, r["launches"]["prefill"]["dwconv1d"])
    r["dwconv1d_launches_by_rank"] = every
    if rank == 0:
        torch.cuda.empty_cache()
        ref = init_params(cfg, generator=torch.Generator(dev).manual_seed(0),
                          device=dev)
        want = _greedy_run(
            torch, lambda t: S.prefill(ref, t, max_len=ml, frontend=frames),
            lambda c, t: S.decode_step(ref, c, t), prompts, TP_GEN,
            tokens=fed)[0]
        r["rel_err_vs_unsharded"] = max(rel_err(a, b)
                                        for a, b in zip(outs, want))
        del ref, want
    torch.cuda.empty_cache()
    return r


def _tp_rank(rank: int, world: int, port: int, out: str) -> None:
    """One of phase 11's gloo ranks on the one card (parts 2 and 3)."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from repro_torch import graphs
    from repro_torch.configs.registry import get_config
    from repro_torch.core.pwconv import KernelPolicy
    from repro_torch.kernels import blocking, pwconv
    from repro_torch.launch.dryrun import make_rules
    from repro_torch.launch.mesh import init_world, make_host_mesh
    from repro_torch.launch.serve import collective_counts
    from repro_torch.measure import rel_err
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.transformer import hidden_states, init_params
    from repro_torch.serve import serve_step as S
    from repro_torch.sharding import collectives
    from repro_torch.sharding.rules import use_rules

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    _rank_env(rank, world, port)
    dev = init_world("gloo", "cuda", timeout_s=TP_TIMEOUT_S)
    rules = make_rules(make_host_mesh(model=world), mode="serve",
                       multi_pod=False)
    res = {"device": str(dev), "transport": collectives.transport(
        rules.mesh.group("model"), dev)}
    ml = TP_PROMPT + TP_GEN
    try:
        with torch.inference_mode():
            # part 2: qwen3-1.7b fp32 at tp 2 against the unsharded path
            cfg = dataclasses.replace(get_config("qwen3-1.7b"),
                                      dtype="float32")
            prompts = torch.randint(
                0, cfg.vocab_size, (TP_BATCH, TP_PROMPT),
                generator=torch.Generator().manual_seed(264)).to(dev)
            with use_rules(rules):
                m = init_params(cfg, generator=torch.Generator(
                    dev).manual_seed(0), device=dev)
                widths = {}
                for name, p in m.named_parameters():
                    if name.startswith("blocks.0.") and name.endswith(".w"):
                        ci, co = p.shape
                        widths[name[len("blocks.0."):-2]] = {
                            "ci": ci, "co": co, **{
                                ph: blocking.pw_variant(g, ci, co, p.dtype)
                                for ph, g in (
                                    ("prefill", TP_BATCH * TP_PROMPT),
                                    ("decode", TP_BATCH))}}
                graphs.reset()
                outs, fed, pre_ms, step_ms = _greedy_run(
                    torch, lambda t: S.prefill(m, t, max_len=ml),
                    lambda c, t: S.decode_step(m, c, t, max_len=ml),
                    prompts, TP_GEN)
                counts = graphs.snapshot()
                res["qwen3"] = {
                    "prefill_ms": pre_ms, "decode_ms_per_step": step_ms,
                    "local_widths": widths,
                    "pwconv_by_variant": dict(pwconv.launches_by_variant),
                    "pwconv": counts["pwconv"],
                    "collectives": collective_counts(counts)}
                del m
            if rank == 0:
                torch.cuda.empty_cache()
                ref = init_params(cfg, generator=torch.Generator(
                    dev).manual_seed(0), device=dev)
                want = _greedy_run(
                    torch, lambda t: S.prefill(ref, t, max_len=ml),
                    lambda c, t: S.decode_step(ref, c, t), prompts, TP_GEN,
                    tokens=fed)[0]
                res["qwen3"]["rel_err_vs_unsharded"] = max(
                    rel_err(a, b) for a, b in zip(outs, want))
                del ref, want
            del outs
            torch.cuda.empty_cache()
            # part 3: qwen3-moe, 1 layer, EP at tp 2, kernels against the
            # same ranks on the plain versions: bf16, then fp32.  The
            # router's top-k ids of every call are recorded, so that the
            # copies sent to another expert are counted, not inferred
            res["moe"] = {}
            routed = []
            real_topk = moe_mod.router_topk

            def recording_topk(logits, top_k, norm_topk):
                out = real_topk(logits, top_k, norm_topk)
                routed.append(out[1].clone())
                return out
            moe_mod.router_topk = recording_topk
            for dtype in ("bfloat16", "float32"):
                cfg = dataclasses.replace(get_config("qwen3-moe-235b-a22b"),
                                          n_layers=1, dtype=dtype)
                prompts = torch.randint(
                    0, cfg.vocab_size, (TP_BATCH, TP_PROMPT),
                    generator=torch.Generator().manual_seed(364)).to(dev)
                with use_rules(rules):
                    m = init_params(cfg, generator=torch.Generator(
                        dev).manual_seed(0), device=dev)
                    runs, fed, ids = {}, None, {}
                    for tag, pol in (("kernels", KernelPolicy()),
                                     ("plain", KernelPolicy(impl="torch"))):
                        graphs.reset()
                        routed.clear()
                        outs, fed, pre_ms, step_ms = _greedy_run(
                            torch, lambda t: S.prefill(m, t, max_len=ml,
                                                       policy=pol),
                            lambda c, t: S.decode_step(m, c, t, max_len=ml,
                                                       policy=pol),
                            prompts, TP_GEN, tokens=fed)
                        counts = graphs.snapshot()
                        aux = hidden_states(m, prompts, policy=pol)[2]
                        runs[tag] = (outs, {
                            "prefill_ms": pre_ms,
                            "decode_ms_per_step": step_ms,
                            "pwconv": counts["pwconv"],
                            "collectives": collective_counts(counts),
                            "drop_frac": float(aux["drop_frac"]),
                            "aux_loss": float(aux["aux_loss"])})
                        ids[tag] = list(routed)
                    r = {tag: v[1] for tag, v in runs.items()}
                    # per call (prefill, the steps, then the aux call): the
                    # copies routed, and those whose expert is not among
                    # the plain run's top-k for their token, over the ranks
                    moved = [[a.numel(), int((~(a[:, :, None] == b[:, None, :])
                                               .any(-1)).sum())]
                             for a, b in zip(ids["kernels"], ids["plain"])]
                    every = [None] * world
                    dist.all_gather_object(every, moved)
                    r["copies_by_call"], r["moved_copies_by_call"] = (
                        [sum(rk[i][j] for rk in every)
                         for i in range(len(moved))] for j in (0, 1))
                    r["rel_err_by_call"] = [
                        rel_err(a, b) for a, b in zip(runs["kernels"][0],
                                                      runs["plain"][0])]
                    res["moe"][dtype] = r
                    del m, runs, ids
                    torch.cuda.empty_cache()
            moe_mod.router_topk = real_topk
            # parts 4-6: hymba, xLSTM and whisper against the unsharded
            # path, the paper's depthwise conv on each rank's channels
            res["recurrent"] = {arch: _tp_recurrent(torch, dev, rules, arch,
                                                    rank)
                                for arch in RECURRENT_TP}
        if rank == 0:
            with open(out, "w") as fh:
                json.dump(res, fh)
    finally:
        dist.destroy_process_group()


def run_sharded(torch, dev):
    """Phase 11, sharded serving on one card (NCCL across cards needs a
    machine with several):

    1. qwen3-1.7b at full width and depth, bf16, batch 8, a 512-token
       prompt and 8 greedy steps through the captured prefill and decode
       step, unsharded and then under the rules of a world of one rank
       under NCCL (``init_world("nccl")``, the host mesh (1, 1) with its
       process groups): the logits and tokens bit for bit the unsharded
       graph's, and the collectives each capture recorded (none).  This
       is the one-device code under an NCCL group: a one-rank mesh gives
       every rank the whole tensor and a one-rank collective returns its
       input, so it shows that the launcher's NCCL set-up and the rules
       leave the captured path as it was, not the sharded code.  Then one
       NCCL ``all_gather`` captured in a CUDA graph and replayed.
       Collectives captured with more than one rank run only across
       cards (``test_nccl_ranks_across_cards_serve_as_one_rank``);
    2. and 3. in two gloo ranks on the one card (:func:`_tp_rank`,
       eager, collectives staged through the host): qwen3-1.7b at full
       width, fp32, tp 2, against the unsharded fp32 path within
       FP32_REL_TOL (rank 0), with the ``pwconv`` variants of the local
       widths; qwen3-moe at its published widths cut to 1 layer,
       expert-parallel at tp 2, the kernels against the plain versions on
       the same ranks, with the router's top-k ids of every call
       recorded: bf16, the copies sent to another expert at most
       MOE_MOVED_MAX_FRAC of those routed, every call past BF16_REL_TOL
       one where a copy moved, and the calls' median within it; fp32, no
       copy moved, every call within FP32_REL_TOL and ``drop_frac``
       equal;
    4.-6. on the same ranks (:func:`_tp_recurrent`): hymba-1.5b, xlstm-125m
       and whisper-small at their published widths cut in depth
       (:data:`RECURRENT_TP`), fp32, tp 2, rank 0 within FP32_REL_TOL of
       the unsharded path, every rank's prefill launching ``dwconv1d`` once
       a recurrent layer on its channel block (hymba's 1600 of 3200; the
       first call held against the plain version within KERNEL_TOL), the
       ms and collectives of a prefill and of a step."""
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.dryrun import make_rules
    from repro_torch.launch.mesh import init_world, make_host_mesh
    from repro_torch.launch.serve import collective_counts
    from repro_torch.models.transformer import init_params
    from repro_torch.serve import serve_step as S
    from repro_torch.sharding.rules import use_rules

    from repro_torch.kernels import _build
    # built before anything is timed, and before the ranks start
    _build.build(["pwconv", "dwconv1d"])
    res = {}
    _rank_env(0, 1, _free_port())
    init_world("nccl", "cuda", timeout_s=TP_TIMEOUT_S)
    try:
        rules = make_rules(make_host_mesh(model=1), mode="serve",
                           multi_pod=False)
        cfg = get_config("qwen3-1.7b")
        ml = SHARD_PROMPT + SHARD_GEN
        with torch.inference_mode():
            m = init_params(cfg, generator=torch.Generator(dev).manual_seed(0),
                            device=dev)
            prompts = torch.randint(
                0, cfg.vocab_size, (SHARD_BATCH, SHARD_PROMPT),
                generator=torch.Generator().manual_seed(208)).to(dev)

            def graph_run():
                t0 = time.perf_counter()
                pre = S.capture_prefill(m, SHARD_BATCH, SHARD_PROMPT,
                                        max_len=ml)
                step = S.capture_decode_step(m, SHARD_BATCH, ml)
                capture_s = time.perf_counter() - t0
                outs, fed, pre_ms, step_ms = _greedy_run(
                    torch, pre, step, prompts, SHARD_GEN)
                return outs, fed, {
                    "capture_s": capture_s, "prefill_ms": pre_ms,
                    "decode_ms_per_token": step_ms,
                    "recorded_collectives": {
                        "prefill": collective_counts(pre.captured.launches),
                        "decode": collective_counts(
                            step.captured.launches)},
                    "recorded_pwconv": [g.captured.launches.get("pwconv", 0)
                                        for g in (pre, step)]}
            plain = graph_run()
            with use_rules(rules):
                shard = graph_run()
            bits = (all(torch.equal(a, b) for a, b in zip(plain[0], shard[0]))
                    and all(torch.equal(a, b)
                            for a, b in zip(plain[1], shard[1])))
            res["world1_nccl"] = {"unsharded": plain[2], "sharded": shard[2],
                                  "bits_equal": bits,
                                  "mesh": rules.mesh.shape}
            del m, plain, shard
            # NCCL in a CUDA graph: the communicator built by a first call,
            # then one out-of-place all_gather (a one-rank in-place
            # all_reduce launches nothing) captured, its output zeroed and
            # the graph replayed
            x = torch.arange(1024.0, device=dev)
            y = torch.empty_like(x)
            dist.all_gather_into_tensor(y, x)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                dist.all_gather_into_tensor(y, x)
            y.zero_()
            graph.replay()
            torch.cuda.synchronize()
            res["world1_nccl"]["captured_nccl_ok"] = torch.equal(y, x)
    finally:
        dist.destroy_process_group()
    w = res["world1_nccl"]
    print(f"    part 1, world 1 under NCCL, qwen3-1.7b bf16 {SHARD_BATCH}x"
          f"{SHARD_PROMPT} + {SHARD_GEN} greedy steps as CUDA graphs: logits"
          f" and tokens bit for bit the unsharded graph's: {w['bits_equal']};"
          f" capture {w['sharded']['capture_s']:.2f} s (unsharded "
          f"{w['unsharded']['capture_s']:.2f} s), prefill "
          f"{w['sharded']['prefill_ms']:.2f} ms, "
          f"{w['sharded']['decode_ms_per_token']:.3f} ms/token (unsharded "
          f"{w['unsharded']['decode_ms_per_token']:.3f}); collectives the "
          f"captures recorded: {w['sharded']['recorded_collectives']}; "
          f"pwconv recorded {w['sharded']['recorded_pwconv']}; an NCCL "
          f"all_gather captured and replayed: {w['captured_nccl_ok']}",
          flush=True)
    if not (w["bits_equal"] and w["captured_nccl_ok"]):
        raise AssertionError(f"phase 11 part 1: {w}")

    torch.cuda.empty_cache()
    out = os.path.join(HERE, "build", "chip_smoke_tp.json")
    port = _free_port()
    t0 = time.perf_counter()
    ctx = mp.start_processes(_tp_rank, args=(2, port, out), nprocs=2,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + 2 * TP_TIMEOUT_S
    while not ctx.join(timeout=5):       # raises where a rank failed
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise AssertionError("phase 11's gloo ranks outlived "
                                 f"{2 * TP_TIMEOUT_S} s")
    with open(out) as fh:
        tp = json.load(fh)
    tp["world_s"] = time.perf_counter() - t0
    res["gloo_tp2"] = tp
    q = tp["qwen3"]
    print(f"    part 2, two gloo ranks on {tp['device']} (collectives "
          f"{tp['transport']}, eager), qwen3-1.7b fp32 tp 2 {TP_BATCH}x"
          f"{TP_PROMPT} + {TP_GEN} steps: rank 0 prefill "
          f"{q['prefill_ms']:.1f} ms, {q['decode_ms_per_step']:.1f} ms a "
          f"step; logits against the unsharded fp32 path "
          f"{q['rel_err_vs_unsharded']:.2e} (tol {FP32_REL_TOL:g}); "
          f"collectives {q['collectives']}; pwconv {q['pwconv']} launches "
          f"by variant {q['pwconv_by_variant']}", flush=True)
    for name, wd in q["local_widths"].items():
        print(f"      pwconv {name} local {wd['ci']}->{wd['co']}: prefill "
              f"G={TP_BATCH * TP_PROMPT} {wd['prefill']}, decode "
              f"G={TP_BATCH} {wd['decode']}", flush=True)
    print(f"    part 3, {MOE_TP_NOTE}; EP at tp 2, the kernels against the "
          f"plain versions on the same ranks ({tp['world_s']:.0f} s for the "
          f"world):", flush=True)
    for dtype, r in tp["moe"].items():
        k = r["kernels"]
        print(f"      {dtype}: rel err by call (prefill, {TP_GEN} steps) "
              + ", ".join(f"{e:.2e}" for e in r["rel_err_by_call"])
              + "; copies sent to another expert by call (then the aux "
              "call), of those routed, over both ranks "
              + ", ".join(f"{m}/{n}" for m, n in zip(
                  r["moved_copies_by_call"], r["copies_by_call"]))
              + f"; drop_frac {k['drop_frac']} / {r['plain']['drop_frac']};"
              f" aux_loss {k['aux_loss']:.6f} / {r['plain']['aux_loss']:.6f};"
              f" collectives {k['collectives']}; pwconv {k['pwconv']}; rank "
              f"0 prefill {k['prefill_ms']:.1f} ms, "
              f"{k['decode_ms_per_step']:.1f} ms a step", flush=True)
    bf, f32 = tp["moe"]["bfloat16"], tp["moe"]["float32"]
    # bf16: a copy that the kernels' rounding sends to another expert (a
    # near-tie of the router) changes its token's output and may move a
    # capacity drop.  So the copies that moved are counted: at most
    # MOE_MOVED_MAX_FRAC of those routed, every call past tol is one where
    # a copy moved, and the calls' median is within tol.  fp32: no copy
    # moves, so the same drops, and every call within tol.
    n_calls = len(bf["rel_err_by_call"])
    if not (q["rel_err_vs_unsharded"] <= FP32_REL_TOL
            and statistics.median(bf["rel_err_by_call"]) <= BF16_REL_TOL
            and all(e <= BF16_REL_TOL or moved > 0 for e, moved in zip(
                bf["rel_err_by_call"], bf["moved_copies_by_call"]))
            and sum(bf["moved_copies_by_call"])
            <= MOE_MOVED_MAX_FRAC * sum(bf["copies_by_call"])
            and max(f32["rel_err_by_call"]) <= FP32_REL_TOL
            and not any(f32["moved_copies_by_call"])
            and len(bf["moved_copies_by_call"]) == n_calls + 1
            and f32["kernels"]["drop_frac"] == f32["plain"]["drop_frac"]
            and q["pwconv"] > 0 and bf["kernels"]["pwconv"] > 0
            and bf["kernels"]["collectives"]["all_to_all"] > 0):
        raise AssertionError(f"phase 11 parts 2-3: {tp}")
    bad = []
    for arch, r in tp["recurrent"].items():
        lc, cc = r["launches"], r["collectives"]
        print(f"    part {4 + list(RECURRENT_TP).index(arch)}, {arch} fp32 "
              f"tp 2 {TP_BATCH}x{TP_PROMPT} + {TP_GEN} steps: rank 0 "
              f"prefill {r['prefill_ms']:.1f} ms, "
              f"{r['decode_ms_per_step']:.1f} ms a step; logits against the "
              f"unsharded fp32 path {r['rel_err_vs_unsharded']:.2e} (tol "
              f"{FP32_REL_TOL:g}); collectives a prefill {cc['prefill']}, a "
              f"step {cc['decode']}; launches a prefill {lc['prefill']}, a "
              f"step {lc['decode']}; dwconv1d a prefill by rank "
              f"{r['dwconv1d_launches_by_rank']}", flush=True)
        check = r.get("dwconv1d_check")
        if check:
            print(f"      dwconv1d on rank 0's channel block "
                  f"{check['shape']} (contiguous {check['contiguous']}): "
                  f"kernel against plain {check['rel_err']:.2e} (tol "
                  f"{KERNEL_TOL['float32']:g})", flush=True)
        n_conv = RECURRENT_TP[arch]["n_layers"] if arch != "whisper-small" \
            else 0
        d_local = {"hymba-1.5b": 1600, "xlstm-125m": 768}.get(arch)
        if not (r["rel_err_vs_unsharded"] <= FP32_REL_TOL
                and lc["prefill"]["pwconv"] > 0
                and r["dwconv1d_launches_by_rank"] == [n_conv] * 2
                and cc["decode"]["all_reduce"] > 0
                and (check is None if d_local is None else (
                    check["shape"][-1] == d_local and check["contiguous"]
                    and check["rel_err"] <= KERNEL_TOL["float32"]))):
            bad.append(arch)
    if bad:
        raise AssertionError(f"phase 11 parts 4-6 {bad}: {tp['recurrent']}")
    res["reduced"] = [MOE_TP_NOTE, RECURRENT_TP_NOTE]
    rec = tp["recurrent"].values()
    res["pwconv_launches"] = (
        sum(w[k]["recorded_pwconv"][0] + w[k]["recorded_pwconv"][1]
            for k in ("unsharded", "sharded"))
        + q["pwconv"] + bf["kernels"]["pwconv"]
        + f32["kernels"]["pwconv"]
        + sum(round(r["launches"][ph]["pwconv"] * (1 if ph == "prefill"
                                                   else TP_GEN))
              for r in rec for ph in ("prefill", "decode")))
    res["dwconv1d_launches"] = sum(r["launches"]["prefill"]["dwconv1d"]
                                   for r in rec)
    return res


def run_sharded_phase():
    """:func:`run_sharded` in a process of its own (``--sharded-only``), as
    phases 8-10 run: a failure raises here."""
    out = os.path.join(HERE, "build", "chip_smoke_sharded.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    sys.stdout.flush()
    subprocess.run([sys.executable, os.path.abspath(__file__),
                    "--sharded-only", out], check=True)
    with open(out) as fh:
        return json.load(fh)


# ---------------------------------------------------------------------------
# Phase 12: sharded training on the one card
# ---------------------------------------------------------------------------

#: Part 1: smollm-360m at full width, fp32, its depth cut, under (data 2,
#: model 1): FSDP, ZeRO-1 and data parallelism, a global batch of
#: SHARD_TRAIN_BATCH x SHARD_TRAIN_SEQ (half a rank), SHARD_TRAIN_STEPS
#: steps.  Part 2: qwen3-1.7b at full width, QWEN_TP_TRAIN_LAYERS layers,
#: under (1, 2) on half that batch.
SHARD_TRAIN_BATCH, SHARD_TRAIN_SEQ, SHARD_TRAIN_STEPS = 4, 256, 3
SMOLLM_TP_TRAIN_LAYERS, QWEN_TP_TRAIN_LAYERS = 2, 2
SHARD_TRAIN_NOTE = ("reduced: smollm-360m n_layers 32 -> 2 and qwen3-1.7b "
                    "28 -> 2 for phase 12 (its time, and two ranks' blocks "
                    "beside a one-rank oracle on one card); widths as "
                    "published")
#: Part 3: qwen3-moe's smoke config under (1, 2), batch x tokens.
MOE_SHARD_TRAIN_BATCH, MOE_SHARD_TRAIN_SEQ = 4, 64
#: World 1 under NCCL: qwen3-1.7b at full width, its depth cut, bf16, the
#: captured step against the eager step, COMPARE_STEPS steps.
WORLD1_TRAIN_LAYERS, WORLD1_TRAIN_BATCH = 2, 4
#: Bounds of parts 1 and 2 against the one-rank eager step: the loss
#: (relative) and each gathered gradient (of its largest magnitude).
SHARD_LOSS_RTOL, SHARD_GRAD_TOL = 2e-5, 1e-4


def _shard_step_case(torch, dev, rules, cfg, batch, *, rank, steps,
                     policy=None, oracle=True) -> dict:
    """One sharded training case on this gloo rank: step 1's loss and
    gradients (gathered whole), then ``steps`` sharded steps timed, each
    with its collectives and ``pwconv`` launches; rank 0 holds step 1
    against the one-rank eager step on the same weights and whole batch
    (``oracle``).  Returns the results and the final state."""
    from repro_torch import graphs
    from repro_torch.core.pwconv import DEFAULT_POLICY
    from repro_torch.launch.serve import collective_counts
    from repro_torch.launch.train import expected_train_launches
    from repro_torch.models.layers import trainable_
    from repro_torch.models.transformer import init_params
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.sharding.rules import gather_block, use_rules
    from repro_torch.train import train_step as TS
    policy = policy or DEFAULT_POLICY
    tcfg = TS.TrainConfig(optimizer=AdamWConfig(lr=TRAIN_LR))
    res = {}
    with use_rules(rules):
        model = trainable_(init_params(cfg, generator=torch.Generator(
            dev).manual_seed(0), device=dev))
        layout = TS.state_layout(model)
        state = TS.init_train_state(model, tcfg)
        graphs.reset()
        loss, _, grads = TS.accumulate_grads(model, state["params"], batch,
                                             policy=policy, layout=layout)
        res["step1_pwconv"] = graphs.snapshot()["pwconv"]
        whole = {n: gather_block(g, layout.params[n], rules.mesh)
                 for n, g in grads.items()}
        res["loss"] = float(loss)
        del grads
        step = TS.make_train_step(model, tcfg, policy)
        res["steps"] = []
        for _ in range(steps):
            graphs.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            counts = graphs.snapshot()
            res["steps"].append({
                "ms": (time.perf_counter() - t0) * 1e3,
                "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                "pwconv": counts["pwconv"],
                "collectives": collective_counts(counts)})
        res["expected_pwconv"] = expected_train_launches(cfg)["pwconv"]
        res["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    if oracle and rank == 0:
        del model
        torch.cuda.empty_cache()
        one = trainable_(init_params(cfg, generator=torch.Generator(
            dev).manual_seed(0), device=dev))
        ostate = TS.init_train_state(one, tcfg)
        oloss, _, ograds = TS.accumulate_grads(one, ostate["params"], batch,
                                               policy=policy)
        res["one_rank_loss"] = float(oloss)
        res["loss_rel_err"] = abs(float(loss) / float(oloss) - 1)
        res["grad_err"] = max(grad_errors(whole, ograds).values())
        del one, ostate, ograds
    elif not oracle:
        res["whole_grads"] = whole
    torch.cuda.empty_cache()
    return res, state, layout


def _train_rank(rank: int, world: int, port: int, out: str,
                ckpt_dir: str) -> None:
    """Phase 12's gloo ranks on the one card (parts 1-4)."""
    import dataclasses
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs.registry import get_config
    from repro_torch.core.pwconv import KernelPolicy
    from repro_torch.data.pipeline import DataConfig, _batch_np
    from repro_torch.kernels import pwconv
    from repro_torch.launch.dryrun import make_rules
    from repro_torch.launch.mesh import init_world, make_host_mesh
    from repro_torch.launch.train import deterministic_card
    from repro_torch.measure import rel_err
    from repro_torch.models.transformer import build_model
    from repro_torch.sharding.rules import gather_block, use_rules
    from repro_torch.train import train_step as TS
    from repro_torch.train.checkpoint import Checkpointer, _flatten

    deterministic_card()
    _rank_env(rank, world, port)
    dev = init_world("gloo", "cuda", timeout_s=TP_TIMEOUT_S)
    torch.cuda.reset_peak_memory_stats(dev)

    def batch_of(cfg, b, s):
        np_batch = _batch_np(DataConfig(vocab_size=cfg.vocab_size, seq_len=s,
                                        global_batch=b, seed=12), 0)
        return {k: torch.from_numpy(v).to(dev) for k, v in np_batch.items()}

    dp2 = make_rules(make_host_mesh(model=1), mode="train", multi_pod=False)
    tp2 = make_rules(make_host_mesh(model=2), mode="train", multi_pod=False)
    res = {"device": str(dev)}
    try:
        # part 1: smollm-360m, (2, 1): FSDP + ZeRO-1 + DP
        cfg = dataclasses.replace(get_config("smollm-360m"), dtype="float32",
                                  n_layers=SMOLLM_TP_TRAIN_LAYERS)
        t0 = time.perf_counter()
        res["smollm"], state, layout = _shard_step_case(
            torch, dev, dp2, cfg, batch_of(cfg, SHARD_TRAIN_BATCH,
                                           SHARD_TRAIN_SEQ),
            rank=rank, steps=SHARD_TRAIN_STEPS)
        # part 4's checkpoint: part 1's state, written under (2, 1)
        with use_rules(dp2):
            Checkpointer(ckpt_dir, layout=layout).save(SHARD_TRAIN_STEPS,
                                                       state)
        del state
        res["smollm"]["s"] = time.perf_counter() - t0
        # part 2: qwen3-1.7b, (1, 2): tensor parallelism, heads whole
        cfg = dataclasses.replace(get_config("qwen3-1.7b"), dtype="float32",
                                  n_layers=QWEN_TP_TRAIN_LAYERS)
        t0 = time.perf_counter()
        res["qwen3"], state, _ = _shard_step_case(
            torch, dev, tp2, cfg, batch_of(cfg, SHARD_TRAIN_BATCH // 2,
                                           SHARD_TRAIN_SEQ),
            rank=rank, steps=SHARD_TRAIN_STEPS)
        del state
        res["qwen3"]["s"] = time.perf_counter() - t0
        if rank == 0:
            # one pwconv launch at a local training width: q's 2048 -> 1024
            # columns at tp 2, a rank's G = 512 rows
            g = SHARD_TRAIN_BATCH // 2 * SHARD_TRAIN_SEQ
            x = torch.randn((g, 2048), device=dev)
            w = torch.randn((2048, 1024), device=dev) * 2048 ** -0.5
            res["pwconv_local"] = {
                "shape": [g, 2048, 1024], "rel_err": rel_err(
                    pwconv.pwconv(x, w), pwconv.pwconv_plain(x, w))}
        torch.cuda.empty_cache()
        # part 3: qwen3-moe smoke, (1, 2): the kernels against the plain
        # versions on the same two ranks
        cfg = dataclasses.replace(get_config("qwen3-moe-235b-a22b",
                                             smoke=True), dtype="float32")
        batch = batch_of(cfg, MOE_SHARD_TRAIN_BATCH, MOE_SHARD_TRAIN_SEQ)
        runs = {}
        for tag, pol in (("kernels", KernelPolicy()),
                         ("plain", KernelPolicy(impl="torch"))):
            runs[tag], _, _ = _shard_step_case(
                torch, dev, tp2, cfg, batch, rank=rank, steps=1, policy=pol,
                oracle=False)
        k, p = runs["kernels"], runs["plain"]
        res["moe"] = {"loss_rel_err": abs(k["loss"] / p["loss"] - 1),
                      "grad_err": max(grad_errors(
                          k.pop("whole_grads"), p.pop("whole_grads")).values()),
                      "kernels": k, "plain": p}
        # part 4: part 1's checkpoint restored under (1, 2) and one rank
        cfg = dataclasses.replace(get_config("smollm-360m"), dtype="float32",
                                  n_layers=SMOLLM_TP_TRAIN_LAYERS)
        tcfg = TS.TrainConfig()
        with use_rules(tp2):
            model = build_model(cfg, torch.Generator(), "meta",
                                tp2).to_empty(device=dev)
            tlayout = TS.state_layout(model)
            template = TS.init_train_state(model, tcfg)
            ck = Checkpointer(ckpt_dir, layout=tlayout)
            restored, step, _ = ck.restore(template)
            name = f"step_{step:09d}"
            with np.load(os.path.join(ckpt_dir, name, "arrays.npz")) as z:
                stored = {key: z[key] for key in z.files}
            specs = _flatten(tlayout.state_specs(restored))
            equal = all(np.array_equal(
                gather_block(v, specs[key], tp2.mesh).cpu().numpy(),
                stored[key]) for key, v in _flatten(restored).items())
            del model, template, restored
        one_equal = None
        if rank == 0:
            whole = build_model(cfg, torch.Generator(), "meta",
                                None).to_empty(device=dev)
            template = TS.init_train_state(whole, tcfg)
            restored, _, _ = Checkpointer(ckpt_dir).restore(template)
            one_equal = all(np.array_equal(v.cpu().numpy(), stored[key])
                            for key, v in _flatten(restored).items())
            del whole, template, restored
        res["elastic"] = {"step": step, "leaves": len(stored),
                          "tp2_equal": equal, "one_rank_equal": one_equal}
        every = [None] * world
        dist.all_gather_object(every, {
            "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
            "smollm_pwconv": [s["pwconv"] for s in res["smollm"]["steps"]],
            "qwen3_pwconv": [s["pwconv"] for s in res["qwen3"]["steps"]],
            "moe_pwconv": res["moe"]["kernels"]["steps"][0]["pwconv"],
            "tp2_equal": equal})
        res["by_rank"] = every
        if rank == 0:
            with open(out, "w") as fh:
                json.dump(res, fh)
    finally:
        dist.destroy_process_group()


def run_sharded_training(torch, dev):
    """Phase 12, sharded training on one card (NCCL across cards needs a
    machine with several: ``test_nccl_train_across_cards``):

    0. world 1 under NCCL (``init_world("nccl")``, the train rules of the
       host mesh (1, 1)): qwen3-1.7b at full width cut to
       WORLD1_TRAIN_LAYERS layers, bf16, WORLD1_TRAIN_BATCH x
       SHARD_TRAIN_SEQ, the captured step (``capture_train_step``, one
       CUDA graph) against the eager step from the same weights on the
       same batches, every leaf of the state and every metric bit for bit
       after each of COMPARE_STEPS steps (deterministic algorithms on).
       A one-rank mesh is the one-device code: it shows the launcher's
       NCCL set-up and the rules leave the captured step as it was;
    1.-4. in two gloo ranks on the one card (:func:`_train_rank`, eager,
       collectives staged through the host): smollm-360m at full width
       (SMOLLM_TP_TRAIN_LAYERS layers), fp32, under (data 2, model 1)
       (FSDP, ZeRO-1, data parallelism), and qwen3-1.7b at full width
       (QWEN_TP_TRAIN_LAYERS layers, its 16 / 8 heads whole over 2) under
       (1, 2): step 1's loss within SHARD_LOSS_RTOL and its gathered
       gradients within SHARD_GRAD_TOL of the one-rank eager step on the
       same weights and whole batch (rank 0), then SHARD_TRAIN_STEPS
       steps with their ms, collectives and ``pwconv`` launches by rank
       against ``expected_train_launches``; one ``pwconv`` launch at a
       local training width against its plain version; qwen3-moe's smoke
       config under (1, 2), the kernels against the plain versions on the
       same ranks (the unsharded MoE is no oracle: each shard routes its
       own tokens with its own capacity); part 1's checkpoint, written
       under (2, 1), restored under (1, 2) and by one rank, every leaf
       bit for bit."""
    import dataclasses
    import shutil

    import torch.distributed as dist
    import torch.multiprocessing as mp
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig, _batch_np
    from repro_torch.kernels import _build
    from repro_torch.launch.dryrun import make_rules
    from repro_torch.launch.mesh import init_world, make_host_mesh
    from repro_torch.launch.serve import collective_counts
    from repro_torch.launch.train import (deterministic_card,
                                          expected_train_launches)
    from repro_torch.models.transformer import init_params
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.sharding.rules import use_rules
    from repro_torch.train import train_step as TS

    deterministic_card()
    # built before anything is timed, and before the ranks start
    _build.build(["pwconv"])
    res = {}
    t0 = time.perf_counter()
    _rank_env(0, 1, _free_port())
    init_world("nccl", "cuda", timeout_s=TP_TIMEOUT_S)
    try:
        rules = make_rules(make_host_mesh(model=1), mode="train",
                           multi_pod=False)
        cfg = dataclasses.replace(get_config("qwen3-1.7b"),
                                  n_layers=WORLD1_TRAIN_LAYERS)
        tcfg = TS.TrainConfig(optimizer=AdamWConfig(lr=TRAIN_LR))
        batches = [{k: torch.from_numpy(v).to(dev) for k, v in _batch_np(
            DataConfig(vocab_size=cfg.vocab_size, seq_len=SHARD_TRAIN_SEQ,
                       global_batch=WORLD1_TRAIN_BATCH, seed=13),
            s).items()} for s in range(COMPARE_STEPS)]
        with use_rules(rules):
            gm = init_params(cfg, generator=torch.Generator(dev).manual_seed(
                0), device=dev)
            em = init_params(cfg, generator=torch.Generator(dev).manual_seed(
                0), device=dev)
            graph = TS.capture_train_step(gm, tcfg, WORLD1_TRAIN_BATCH,
                                          SHARD_TRAIN_SEQ)
            eager = TS.make_train_step(em, tcfg)
            estate = TS.init_train_state(em, tcfg)
            gstate = graph.state
            bad, ms = [], {"graph": [], "eager": []}
            for s, batch in enumerate(batches):
                for tag in ("graph", "eager"):
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    if tag == "graph":
                        gstate, gm_ = graph(gstate, batch)
                    else:
                        estate, em_ = eager(estate, batch)
                    torch.cuda.synchronize()
                    ms[tag].append((time.perf_counter() - t1) * 1e3)
                bad += [f"step {s + 1} {k}" for k in differing(
                    torch, {"state": gstate, "m": gm_},
                    {"state": estate, "m": em_})]
            res["world1_nccl"] = {
                "bits_equal": not bad, "differing": bad[:8],
                "graph_ms": ms["graph"], "eager_ms": ms["eager"],
                "capture_s": graph.captured.capture_s,
                "recorded_pwconv": graph.captured.launches.get("pwconv", 0),
                "recorded_collectives": collective_counts(
                    graph.captured.launches),
                "expected_pwconv": expected_train_launches(cfg)["pwconv"],
                "mesh": rules.mesh.shape}
            del gm, em, graph, eager, estate, gstate
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    res["world1_nccl"]["s"] = time.perf_counter() - t0
    w = res["world1_nccl"]
    print(f"    world 1 under NCCL, qwen3-1.7b bf16 {WORLD1_TRAIN_LAYERS} "
          f"layers {WORLD1_TRAIN_BATCH}x{SHARD_TRAIN_SEQ}: the captured "
          f"sharded step against the eager step, {COMPARE_STEPS} steps, "
          f"every leaf and metric bit for bit: {w['bits_equal']} "
          f"{w['differing']}; graph "
          + ", ".join(f"{x:.1f}" for x in w["graph_ms"]) + " ms, eager "
          + ", ".join(f"{x:.1f}" for x in w["eager_ms"])
          + f" ms; capture {w['capture_s']:.2f} s; recorded pwconv "
          f"{w['recorded_pwconv']} (expected {w['expected_pwconv']}), "
          f"collectives {w['recorded_collectives']} ({w['s']:.0f} s)",
          flush=True)
    if not (w["bits_equal"] and w["recorded_pwconv"]
            == w["expected_pwconv"]):
        raise AssertionError(f"phase 12 world 1: {w}")

    out = os.path.join(HERE, "build", "chip_smoke_shard_train.json")
    ckpt_dir = os.path.join(HERE, "build", "chip_smoke_shard_ckpt")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    port = _free_port()
    t0 = time.perf_counter()
    ctx = mp.start_processes(_train_rank, args=(2, port, out, ckpt_dir),
                             nprocs=2, join=False, start_method="spawn")
    deadline = time.monotonic() + 2 * TP_TIMEOUT_S
    while not ctx.join(timeout=5):       # raises where a rank failed
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise AssertionError("phase 12's gloo ranks outlived "
                                 f"{2 * TP_TIMEOUT_S} s")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    with open(out) as fh:
        tr = json.load(fh)
    tr["world_s"] = time.perf_counter() - t0
    res["gloo"] = tr
    bad = []
    for part, key, mesh in ((1, "smollm", "(data 2, model 1)"),
                            (2, "qwen3", "(data 1, model 2)")):
        r = tr[key]
        pw = [rk[f"{key}_pwconv"] for rk in tr["by_rank"]]
        print(f"    part {part}, two gloo ranks on {tr['device']}, {key} "
              f"fp32 {mesh}: step 1 loss {r['loss']:.6f} against one rank "
              f"{r['one_rank_loss']:.6f} (rel {r['loss_rel_err']:.2e}, tol "
              f"{SHARD_LOSS_RTOL:g}); gradients gathered "
              f"{r['grad_err']:.2e} (tol {SHARD_GRAD_TOL:g}); steps "
              + ", ".join(f"{s['ms']:.0f}" for s in r["steps"])
              + f" ms, losses "
              + ", ".join(f"{s['loss']:.4f}" for s in r["steps"])
              + f"; collectives a step {r['steps'][-1]['collectives']}; "
              f"pwconv a step by rank {pw} (expected "
              f"{r['expected_pwconv']}); peak {r['peak_gib']:.2f} GiB "
              f"(rank 0, {r['s']:.0f} s)", flush=True)
        if not (r["loss_rel_err"] <= SHARD_LOSS_RTOL
                and r["grad_err"] <= SHARD_GRAD_TOL
                and all(n == [r["expected_pwconv"]] * SHARD_TRAIN_STEPS
                        for n in pw)
                and all(np_isfinite(s["loss"]) for s in r["steps"])):
            bad.append(key)
    pl = tr["pwconv_local"]
    m = tr["moe"]
    e = tr["elastic"]
    print(f"    pwconv at a local training width {pl['shape']} fp32 "
          f"against plain: {pl['rel_err']:.2e} (tol "
          f"{KERNEL_TOL['float32']:g})", flush=True)
    print(f"    part 3, qwen3-moe smoke fp32 (data 1, model 2), the kernels "
          f"against the plain versions on the same ranks: loss rel "
          f"{m['loss_rel_err']:.2e}, gradients {m['grad_err']:.2e} (tol "
          f"{FP32_REL_TOL:g}); collectives a step "
          f"{m['kernels']['steps'][0]['collectives']}; pwconv by rank "
          f"{[rk['moe_pwconv'] for rk in tr['by_rank']]} (expected "
          f"{m['kernels']['expected_pwconv']})", flush=True)
    print(f"    part 4, part 1's checkpoint (step {e['step']}, "
          f"{e['leaves']} leaves) restored under (1, 2) bit for bit: "
          f"{[rk['tp2_equal'] for rk in tr['by_rank']]}, by one rank: "
          f"{e['one_rank_equal']}; peak device memory by rank "
          f"{[round(rk['peak_gib'], 2) for rk in tr['by_rank']]} GiB "
          f"({tr['world_s']:.0f} s for the world)", flush=True)
    if not (pl["rel_err"] <= KERNEL_TOL["float32"]
            and m["loss_rel_err"] <= FP32_REL_TOL
            and m["grad_err"] <= FP32_REL_TOL
            and all(rk["moe_pwconv"] == m["kernels"]["expected_pwconv"]
                    for rk in tr["by_rank"])
            and all(rk["tp2_equal"] for rk in tr["by_rank"])
            and e["one_rank_equal"]):
        bad.append("parts 3-4")
    if bad:
        raise AssertionError(f"phase 12 {bad}: {tr}")
    res["reduced"] = [SHARD_TRAIN_NOTE]
    res["pwconv_launches"] = (
        w["recorded_pwconv"]
        + sum(sum(rk[f"{k}_pwconv"]) for rk in tr["by_rank"]
              for k in ("smollm", "qwen3"))
        + sum(rk["moe_pwconv"] for rk in tr["by_rank"]))
    return res


def run_sharded_training_phase():
    """:func:`run_sharded_training` in a process of its own
    (``--sharded-train-only``), started with ``CUBLAS_WORKSPACE_CONFIG``
    as phase 10 is: a failure raises here."""
    out = os.path.join(HERE, "build", "chip_smoke_sharded_train.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    sys.stdout.flush()
    subprocess.run([sys.executable, os.path.abspath(__file__),
                    "--sharded-train-only", out], check=True,
                   env={**os.environ, "CUBLAS_WORKSPACE_CONFIG": ":4096:8"})
    with open(out) as fh:
        return json.load(fh)


def main() -> int:
    ap = argparse.ArgumentParser(description="Smoke run of the port on one "
                                             "NVIDIA GPU.")
    ap.add_argument("--out", help="directory for chip_smoke.json")
    ap.add_argument("--hymba-only", metavar="JSON", help=argparse.SUPPRESS)
    ap.add_argument("--attn-mlp-only", metavar="JSON",
                    help=argparse.SUPPRESS)
    ap.add_argument("--whisper-only", metavar="JSON", help=argparse.SUPPRESS)
    ap.add_argument("--train-only", metavar="JSON", help=argparse.SUPPRESS)
    ap.add_argument("--sharded-only", metavar="JSON", help=argparse.SUPPRESS)
    ap.add_argument("--sharded-train-only", metavar="JSON",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    if args.hymba_only:
        # phase 8 in a process of its own (see run_hymba_phase)
        with open(args.hymba_only, "w") as fh:
            json.dump(run_hymba(torch, dev), fh)
        return 0
    if args.attn_mlp_only:
        # phase 8b in a process of its own (see run_attn_mlp_phase)
        with open(args.attn_mlp_only, "w") as fh:
            json.dump(run_attn_mlp(torch, dev), fh)
        return 0
    if args.whisper_only:
        # phase 9 in a process of its own (see run_whisper_phase)
        with open(args.whisper_only, "w") as fh:
            json.dump(run_whisper(torch, dev), fh)
        return 0
    if args.train_only:
        # phase 10 in a process of its own (see run_training_phase)
        with open(args.train_only, "w") as fh:
            json.dump(run_training(torch, dev), fh)
        return 0
    if args.sharded_only:
        # phase 11 in a process of its own (see run_sharded_phase)
        with open(args.sharded_only, "w") as fh:
            json.dump(run_sharded(torch, dev), fh)
        return 0
    if args.sharded_train_only:
        # phase 12 in a process of its own (see run_sharded_training_phase)
        with open(args.sharded_train_only, "w") as fh:
            json.dump(run_sharded_training(torch, dev), fh)
        return 0
    card = card_line()
    print(card)
    print(_versions(torch, _build))
    print("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False; bf16 products reduce "
          "in fp32: allow_bf16_reduced_precision_reduction = False")

    t0 = time.perf_counter()
    paths = _build.build()
    print(f"built {', '.join(paths)} in {time.perf_counter() - t0:.1f} s")
    for name, p in paths.items():
        log = p.with_suffix(".log")
        text = log.read_text() if log.exists() else ""
        regs = [int(w) for w in re.findall(r"Used (\d+) registers", text)]
        spills = sum(int(w) for w in re.findall(r"(\d+) bytes spill stores",
                                                text))
        print(f"  ptxas {name}: {len(regs)} kernels, at most "
              f"{max(regs, default=0)} registers, {spills} bytes of spill "
              "stores in all")

    phase_s = {"build": time.perf_counter() - t0}

    def took(name):
        phase_s[name] = time.perf_counter() - t_phase
        print(f"  ({phase_s[name]:.0f} s)", flush=True)
        return phase_s[name]

    t_phase = time.perf_counter()
    print("kernels vs plain versions:")
    kc = KernelChecks(torch, dev)
    for dtype in (torch.float32, torch.bfloat16):
        kc.dwconv2d(8, 112, 112, 32, 1, dtype)
        kc.dwconv2d(8, 112, 112, 64, 2, dtype)
        kc.dwconv2d(8, 56, 56, 72, 2, dtype, k=5)
        kc.pwconv(8 * 56 * 56, 128, 256, dtype)
        kc.fused(8, 56, 56, 128, 128, 128, 1, False, dtype)
        kc.fused(8, 28, 28, 256, 256, 512, 2, False, dtype)
        kc.fused(8, 56, 56, 24, 144, 24, 1, True, dtype)
        kc.fused(8, 14, 14, 96, 576, 160, 2, False, dtype)
        kc.fused(8, 14, 14, 112, 672, 112, 1, True, dtype, k=5)
        # Lite0's 7x7 k5 block, V2's 7x7 block at batch 1 and 8, Lite0's
        # 14x14 k5 block at batch 1
        kc.fused(8, 7, 7, 192, 1152, 192, 1, True, dtype, k=5)
        kc.fused(1, 7, 7, 192, 1152, 192, 1, True, dtype, k=5)
        kc.fused(8, 7, 7, 160, 960, 160, 1, True, dtype)
        kc.fused(1, 7, 7, 160, 960, 160, 1, True, dtype)
        kc.fused(8, 7, 7, 1024, 1024, 1024, 1, False, dtype)
        # dwconv2d beyond 7x7: the runtime-K path, strides 1 and 2
        for k in (9, 11):
            for stride in (1, 2):
                kc.dwconv2d(8, 56, 56, 72, stride, dtype, k=k)
        # Lite0's four fused-MBConv blocks at batch 8, the last at batch 1
        kc.fused_mb(8, 112, 112, 16, 96, 24, 2, False, dtype)
        kc.fused_mb(8, 56, 56, 24, 144, 24, 1, True, dtype)
        kc.fused_mb(8, 56, 56, 24, 144, 40, 2, False, dtype)
        kc.fused_mb(8, 28, 28, 40, 240, 40, 1, True, dtype)
        kc.fused_mb(1, 28, 28, 40, 240, 40, 1, True, dtype)
        # MnasNet's six SE block shapes at batch 8 (blocks 3, 4-5, 10, 11,
        # 12, 13-14), then blocks 3 and 11 at a 224 input
        kc.dw_se(8, 56, 56, 72, 6, 2, dtype, k=5)
        kc.dw_se(8, 28, 28, 120, 10, 1, dtype, k=5)
        kc.dw_se(8, 14, 14, 480, 20, 1, dtype)
        kc.dw_se(8, 14, 14, 672, 28, 1, dtype)
        kc.dw_se(8, 14, 14, 672, 28, 2, dtype, k=5)
        kc.dw_se(8, 7, 7, 960, 40, 1, dtype, k=5)
        kc.dw_se(8, 112, 112, 72, 6, 2, dtype, k=5)
        kc.dw_se(8, 28, 28, 672, 28, 1, dtype)
        for b, length, d, k, rows in (
                (8, 512, 1536, 4, None), (8, 512, 768, 4, None),
                (2, 1000, 1000, 4, 7), (2, 1000, 1002, 4, None),
                (8, 512, 1536, 3, None), (8, 512, 1536, 5, None),
                (8, 1, 1536, 4, None), (8, 2, 768, 4, None)):
            kc.dwconv1d(b, length, d, k, dtype, rows)
        kc.pwconv(4096, 768, 3072, dtype, act=None)
        kc.pwconv(4096, 1536, 1536, dtype, act=None)
        kc.pwconv(1024, 768, 1024, dtype, act="silu")
        kc.pwconv(8, 768, 3072, dtype, act=None)
        # the main path's extremes: V1 block 1 at batch 8, a 14x14 stage at
        # batch 8, V1 block 13 at batch 1, decode at batch 1, the mLSTM gate
        # projection with its bias
        kc.pwconv(8 * 112 * 112, 32, 64, dtype)
        kc.pwconv(8 * 14 * 14, 512, 512, dtype)
        kc.pwconv(49, 1024, 1024, dtype)
        kc.pwconv(1, 768, 3072, dtype, act=None)
        kc.pwconv(8, 1536, 8, dtype, act=None)
        # hymba-1.5b: the Mamba conv and Linears at a batch-8 prefill of
        # 1664 positions (w_in, w_bcdt, w_dt, the MLP's gate), decode's w_in
        g = 8 * (128 + HYMBA_PROMPT)
        kc.dwconv1d(8, 128 + HYMBA_PROMPT, 3200, 4, dtype)
        # dwconv1d's backward at the training shapes: xLSTM's 8 x 256 at
        # the mLSTM's d_inner 1536 and the sLSTM's d_model 768, hymba's
        # 512 tokens + 128 meta at batch 4 and at phase 10's batch, and at
        # phase 10's batch on a rank's channel block at tp 2 and 4
        kc.dwconv1d_bwd(TRAIN_BATCH, TRAIN_SEQ, 1536, 4, dtype)
        kc.dwconv1d_bwd(TRAIN_BATCH, TRAIN_SEQ, 768, 4, dtype)
        kc.dwconv1d_bwd(4, 640, 3200, 4, dtype)
        for d_bwd in (3200, 1600, 800):
            kc.dwconv1d_bwd(HYMBA_TRAIN_BATCH, HYMBA_TRAIN_SEQ + 128, d_bwd,
                            4, dtype)
        for ci, co, act in ((1600, 6400, None), (3200, 132, None),
                            (100, 3200, None), (1600, 5504, "silu")):
            kc.pwconv(g, ci, co, dtype, act=act, launches=2)
        kc.pwconv(8, 1600, 6400, dtype, act=None)
        # hymba under a model axis: the Mamba conv on a rank's channel
        # block at tp 2 and 4, and the Linears' local widths (w_bcdt's 66
        # and 33 columns, w_dt's 50 and 25 rows) in a prefill and a step
        for d_local in (1600, 800):
            kc.dwconv1d(8, 128 + HYMBA_PROMPT, d_local, 4, dtype)
        for rows in (g, 8):
            for ci, co in ((3200, 66), (3200, 33), (50, 3200), (25, 3200)):
                kc.pwconv(rows, ci, co, dtype, act=None,
                          launches=2 if rows == g else 20)
        # qwen3-1.7b: a batch-8 512-token prefill's q/o, k/v and the MLP's
        # gate, and decode's gate and q at batch 8
        for ci, co, act in ((2048, 2048, None), (2048, 1024, None),
                            (2048, 6144, "silu")):
            kc.pwconv(8 * ATTN_PROMPT, ci, co, dtype, act=act, launches=5)
        kc.pwconv(8, 2048, 6144, dtype, act="silu")
        kc.pwconv(8, 2048, 2048, dtype, act=None)
        # whisper-small: a batch-8 prefill's encoder (1500 frames) q/k/v/o
        # with their biases and the MLP's gate, and decode's gate at batch 8
        g = 8 * WHISPER_FRAMES
        kc.pwconv(g, 768, 768, dtype, act=None, launches=5)
        kc.pwconv(g, 768, 3072, dtype, act="silu", launches=5)
        kc.pwconv(8, 768, 3072, dtype, act="silu")
        # smollm-360m training: a step's 8 x 256 rows, q/o and the gate
        for ci, co, act in ((960, 960, None), (960, 2560, "silu")):
            kc.pwconv(TRAIN_BATCH * TRAIN_SEQ, ci, co, dtype, act=act,
                      launches=5)
    took("kernel checks")

    t_phase = time.perf_counter()
    print("main path: execute_network, MobileNet V1/V2, MnasNet-A1 and "
          "EfficientNet-Lite0 at width 1.0, 112x112:")
    runs, launches, replayed, variants = run_networks(torch, dev)
    took("CNN main path")
    t_phase = time.perf_counter()
    print("tuning path: tune_network on V1/V2/MnasNet-A1/Lite0 at 112x112, "
          "default plan, then the tuned against the analytic graph path:")
    tuning, tune_launches, tuned = run_tuning(torch, dev)
    tuning_s = took("tuning")
    print(f"  launches of the tunes: {tune_launches}")
    t_phase = time.perf_counter()
    print("runtime ladder (an opt-in): the default policy's steady state "
          "against on_failure='degrade', recovery and re-capture after "
          "injected faults, a real launch error:")
    runtime = run_runtime(torch, dev)
    runtime_s = took("runtime ladder")
    t_phase = time.perf_counter()
    print("serving path: xlstm-125m at full width, cut in depth, prefill + "
          "greedy decode:")
    serving, serve_launches, serve_replayed, stepping, serve_variants = \
        run_serving(torch, dev)
    took("xlstm serving")
    # after the profiled serving phase: its decode traces lost records
    # when this phase ran before it (PERF.md, section 6)
    t_phase = time.perf_counter()
    print("static verification, traffic models and shims:")
    static = run_static(torch, dev, runs, tuned)
    static_s = took("static verification")
    t_phase = time.perf_counter()
    print(f"serving path: hymba-1.5b at full width, {HYMBA_LAYERS} of 32 "
          "layers, prefill + greedy decode:")
    (hymba, hymba_launches, hymba_replayed, hymba_stepping, hymba_variants,
     hymba_breakdowns) = run_hymba_phase()
    took("hymba serving")
    t_phase = time.perf_counter()
    print("serving path: attention-MLP transformers (dense, VLM, MoE), "
          "prefill + greedy decode:")
    attn, attn_launches, attn_replayed, attn_variants, attn_checks = \
        run_attn_mlp_phase()
    attn_s = took("attention-MLP serving")
    t_phase = time.perf_counter()
    print("serving path: whisper-small at full width (encoder-decoder), "
          "prefill + greedy decode:")
    whisper, whisper_launches, whisper_replayed, whisper_variants = \
        run_whisper_phase()
    whisper_s = took("whisper serving")
    t_phase = time.perf_counter()
    print("training path on one card, the captured step against the eager "
          "step: smollm-360m and whisper-small at full width, xlstm-125m "
          f"({XLSTM_LAYERS} layers), hymba-1.5b at full width "
          f"({HYMBA_TRAIN_LAYERS} layers), qwen3-moe "
          "cut, smollm-360m's variants, train_e2e:")
    torch.cuda.empty_cache()    # the child's qwen3-moe check needs the card
    training, train_launches, train_profiled = run_training_phase()
    train_s = took("training")
    # dwconv1d's kernels run on the LM paths only; its backward's in
    # training alone: what the profiled train steps (graph replays and
    # eager steps) ran stands for their replay count
    for name in ("dwconv1d", "dwconv1d_bwd"):
        launches[name] = replayed[name] = 0
    replayed["dwconv1d_bwd"] = train_profiled["dwconv1d_bwd"]
    for name, n in train_launches.items():
        launches[name] += n
    t_phase = time.perf_counter()
    print("sharded serving on the one card: qwen3-1.7b world 1 under NCCL "
          "as CUDA graphs; qwen3-1.7b tp 2, qwen3-moe EP tp 2, hymba-1.5b, "
          "xlstm-125m and whisper-small tp 2 as two gloo ranks:")
    torch.cuda.empty_cache()
    sharded = run_sharded_phase()
    sharded_s = took("sharded serving")
    launches["pwconv"] += sharded["pwconv_launches"]
    launches["dwconv1d"] += sharded["dwconv1d_launches"]
    t_phase = time.perf_counter()
    print("sharded training on the one card: qwen3-1.7b's captured step "
          "under world-1 NCCL rules against the eager step; smollm-360m "
          "FSDP + ZeRO-1 + DP, qwen3-1.7b tp 2, qwen3-moe EP and an elastic "
          "checkpoint as two gloo ranks:")
    torch.cuda.empty_cache()
    shard_train = run_sharded_training_phase()
    shard_train_s = took("sharded training")
    launches["pwconv"] += shard_train["pwconv_launches"]
    for got, ran, by in ((serve_launches, serve_replayed, serve_variants),
                         (hymba_launches, hymba_replayed, hymba_variants),
                         (attn_launches, attn_replayed, attn_variants),
                         (whisper_launches, whisper_replayed,
                          whisper_variants)):
        for name, n in got.items():
            launches[name] += n
            replayed[name] += ran[name]
        for name, n in by.items():
            variants[name] = variants.get(name, 0) + n
    for name in launches:
        if launches[name] == 0 or replayed[name] == 0:
            raise AssertionError(f"kernel {name} was launched {launches[name]}"
                                 f" times on the main paths and ran "
                                 f"{replayed[name]} times in their profiled "
                                 "graph replays")
    print(f"pwconv launches by variant on the main paths: {variants}")
    for name in ("stream", "tc", "simt"):
        if not variants.get(name):
            raise AssertionError(f"pwconv variant {name} was never launched "
                                 "on the main paths")

    kernels = []
    for name, (source, replaces) in SOURCES.items():
        first = next(r for r in kc.results
                     if r["name"] == name and r["dtype"] == "float32")
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "replay_launches": replayed[name],
                        **{k: first[k] for k in (
                            "max_abs_err", "ms", "plain_ms", "bound_ms",
                            "bound_by", "library_ms", "shape", "dtype",
                            "max_rel_err")}})
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as fh:
            json.dump({"card": card, "kernel_checks": kc.results,
                       "networks": runs, "tuning": tuning,
                       "tuning_launches": tune_launches,
                       "tuning_seconds": tuning_s, "static": static,
                       "static_seconds": static_s, "runtime": runtime,
                       "runtime_seconds": runtime_s, "serving": serving,
                       "prefill_vs_stepping": stepping, "hymba": hymba,
                       "hymba_prefill_vs_stepping": hymba_stepping,
                       "hymba_layer_breakdown": hymba_breakdowns,
                       "attn_mlp": attn, "attn_mlp_checks": attn_checks,
                       "attn_mlp_seconds": attn_s, "whisper": whisper,
                       "whisper_seconds": whisper_s, "training": training,
                       "training_seconds": train_s,
                       "sharded": sharded, "sharded_seconds": sharded_s,
                       "sharded_training": shard_train,
                       "sharded_training_seconds": shard_train_s,
                       "phase_seconds": phase_s,
                       "launches": launches,
                       "replay_launches": replayed,
                       "pwconv_variants": variants,
                       "seconds": time.perf_counter() - t_start}, fh,
                      indent=1)
    total = time.perf_counter() - t_start
    print("seconds by phase: " + ", ".join(f"{k} {v:.1f}"
                                           for k, v in phase_s.items())
          + f"; total {total:.0f} s against a budget of {TIME_BUDGET_S} s "
          f"({'within' if total <= TIME_BUDGET_S else 'over'})")
    print(f"kernels launched and checked: {', '.join(SOURCES)} "
          f"({total:.0f} s)")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
