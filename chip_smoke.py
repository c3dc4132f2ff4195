#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

Phases, each of which must pass or the script exits non-zero:

1. build the CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, in parallel) and print the build time;
2. hold every kernel against its plain PyTorch version on the card, at the
   main path's shapes and a ragged block, over every variant and, for the
   stencil and diff-norm kernels, every partial mode (l∞ max|r|, l2 Σr²,
   l1 Σ|r|), with the tolerance stated beside each check (bf16 attention
   element by element as well, under the bar its tensor-core arithmetic
   allows); the stencil kernels' outputs and partials must be bitwise equal
   across two calls and carry a NaN (#5 too, in l1, at the PageRank path's
   vectors), and a face slab swept by the halo
   kernel must be bitwise the block's face; count the tensor-core
   instructions in the flash library's SASS;
3. time each kernel, its plain version, the nearest single PyTorch call and
   the least time the card could take (#6 at phase 7's and phase 15's
   prefill shapes; CUDA events over 20 CUDA-graph replays,
   so host launch overhead is left out; the eager per-call time is kept
   beside it), and the two shard-block sweeps also over six shards' worth
   of rotating inputs, more than the 50 MB L2, as the runtime finds them,
   and #5 at the PageRank shard block (4096 f64, l1, one partial);
4. ``solve_single`` at n = 185, f64 (the paper's larger grid), for the four
   detection modes with the hybrid sweep, Jacobi, and the unfused baseline,
   in l∞, and PFAIT with the hybrid sweep in l1: each run must converge
   with the exact residual of its result, in its norm, under ε̃;
5. the stacked 1-D shard runtime at n = 150, f64, p = 6: blocking must
   follow the synchronous reference trajectory, and non-blocking
   (heterogeneous Jacobi shards, in l∞ and in l1, and hybrid) and
   recursive doubling (p = 2) must detect with no false detection; each
   blocking run's detection must be consistent with its exact trace;
6. the mesh shard runtime at n = 150, f64, on the paper's (3, 2) process
   grid and a (2, 2, 2) mesh: blocking must follow the synchronous
   reference trajectory (in l∞ and in l1), comm overlap must be bitwise
   equal to no overlap under heterogeneous knobs, and non-blocking hybrid,
   recursive doubling and NFAIS2 must detect with no false detection;
7. serve qwen2-1.5b at full width (bf16, seed-initialised weights): batch 4,
   2048-token prompts, 64 new tokens through ``launch.serve.serve``; every
   layer's prefill attention must launch the flash kernel, every logit must
   be finite; then, at the same width, the prefill's logits with the kernel
   must match the same model's prefill with the plain attention, and a
   prefill over S − 1 tokens plus one decode step must match the prefill
   over S tokens, in f32 and in bf16 (where the bar is read against two
   plain evaluations and a faulty one in the same run);
8. PageRank at n = 16384 (a 2 GiB f64 operator placed on the card once),
   p = 4 row blocks, ε̃ = 1e-9 in l1, through ``runtime.api.run_shard``:
   blocking, non-blocking PFAIT with heterogeneous knobs, recursive doubling
   and NFAIS2 must converge with the exact residual (f64 on the card, and
   the host's ``PageRankProblem.exact_residual``) under ε̃, blocking must
   follow the synchronous reference trajectory and its detection must be
   consistent with that exact trace (``core.termination``); the 1-D p = 6
   hetero Jacobi case of phase 5, run again through ``run_shard`` with a
   recorded trace, must be bitwise phase 5's run; every recorded trace
   must validate;
9. one shard per process over ``torch.distributed``, in spawned local
   worlds on the one card: a gloo world of 6 ranks sharing ``cuda:0``
   (phase 5's 1-D p = 6 runs but the p = 2 one, phase 6's (3, 2) blocking,
   hetero, hetero overlap and NFAIS2 runs, a (3, 2) hetero hybrid run and
   ``make_sharded_solver`` on a (3, 2) group at n = 150), a gloo world of 4
   (phase 8's four PageRank runs, each rank holding only its row block of
   P, and 1-D rdoubling at p = 4, n = 152) and an NCCL world of 1 (the 1-D
   p = 1 runtime, and ``make_sharded_solver`` on (1, 1) at n = 185 as phase
   4's PFAIT hybrid run): every run must equal its stacked twin (same
   iterations, detection and verifications, x bitwise, the trace bitwise
   at l∞ and within p·2^-24 relative at l1), every rank must report the
   same outcome, and #1-#5 must launch inside the worlds (the ranks' own
   counters; a world that reports none fails the phase); ms per step and
   the host-staged bytes per step are printed beside the stacked twin's;
10. require that every (stencil kernel, block shape, dtype) the main paths
   launched, in this process and inside the worlds, was held against its
   plain version in phase 2; after phase 16, rank the stencil kernels by
   launches x (device ms - bound ms) over those triples, each timed at its
   shape in its type; at the end print one JSON line of per-kernel
   numbers, the card's name and power limit, and last ``{"ok": true,
   "device": {...}}``;
11. the detection service, run after phase 9 (phase 10's checks, which
   cover its launches, come after phase 13): a seeded open-loop load of 64
   tenants (Poisson, 2 a tick) over convdiff at n = 150 (Jacobi #1 and
   hybrid #2 lanes, f32), PageRank at n = 4096 (#5 over each bucket) and
   mlfixed at n = 1024 through ``launch.serve.serve_detection`` on the
   card, each signature's lanes one CUDA graph: every tenant must be
   served with no timeout and no false detection; each packed verdict must
   be bitwise ``batched_monitor``'s on the card on the tenant's series;
   ``compile_count`` must equal the distinct signatures and the warm hits
   follow the rule; the counted launches must be those of the buckets'
   replays; each family's ε̃ grid must sit ≥ 3× above its residual floor
   after the PFAIT margin, the larger of the f32 series' floor and the f64
   residual of the f32 states it stalls at (both measured here); one served
   tenant per family at the load's least ε̃ must pass the oracle rule on
   its f64 residual at its detect step; one chunk per family replayed
   from its graph must be bitwise the same chunk run eagerly, across a
   refill; one tenant per family rerun on the CPU must take the same
   verdict.  Prints ticks, time to detection and queue wait percentiles,
   tenants/s, ms per tick, lane-steps/s per family and the device's busy
   share over ticks 10–13 from ``torch.profiler``;
12. asynchronous data-parallel training through ``runtime.api.run_train``:
   ridge least squares at n = 1024 over 262144 rows (a 2 GiB f64 design,
   512 MiB a worker), p = 4, 8 minibatches of 8192 rows, cond 10, l2,
   ε̃ = 1e-8 — (a) blocking, (b) non-blocking PFAIT K = 2 with
   heterogeneous steps, delays and lags, (c) recursive doubling, (d)
   NFAIS2, (e) logistic at 65536 rows, and (a) at p = 1; (b) again in a
   gloo world of 4 ranks sharing the card and (a) at p = 1 in an NCCL world
   of 1, each rank reading its own rows.  Every run must converge with the
   exact lifted residual of its replicas (``exact_train_residual``, host
   numpy) under ε̃; (a) must follow ``reference_trace`` round for round
   and its detection be consistent with its exact trace; each world
   must equal its stacked twin (X bitwise, the l2 trace within p·2^-24);
   #5 must launch once a round and verification (a launch over the [p, n]
   replica stack, or one a rank).  Prints the host build and
   ``safe_gamma`` times, rounds and ms per round, and a profile of 8
   rounds of (b);
13. the elastic driver through ``runtime.api.run_elastic``: convdiff at
   n = 150 over 6 slots (PFAIT K = 2, Jacobi, inner 2, halo delay 1, lag 1,
   segments of 40 rounds, a checkpoint every 2) with worker 1 crashing in
   segment 3 and rejoining after 8, and PageRank at n = 16384 over 4 slots
   (l1, ε̃ = 1e-9, segments of 5) with worker 2 crashing in segment 2 and
   rejoining after 6: each must restart once after stalling, pass through
   6 → 5 → 6 and 4 → 2 → 4 shards, converge with the exact residual of its
   result under ε̃ and write a valid trace; the convdiff restart must roll
   iterations back.  Prints the recovery accounting, the walls of saves
   and restores and ms per segment;
14. dense-LM training through ``launch.train.train``: (a) qwen2-1.5b at full
   width (28 layers, d_model 1536, vocab 151936 padded to 152064, bf16,
   seed 0), TRAIN_4K's 4096 tokens a sequence at batch 4 (its global batch
   of 256 cut to 4), remat "block", PFAIT K = 2 on the loss: one warm-up
   step and 4 timed ones, the first loss within 1.0 of ln 151936, every
   loss and grad_norm finite, the last loss below the first; then one
   2-microbatch step whose loss must be the whole batch's within rtol
   1e-3, and finite parameters.  Prints ms per step, tokens/s, the
   model-FLOP share of the bf16 peak, peak memory, the device's busy share
   and top kernels and operators over the timed steps (``torch.profiler``),
   the synchronising CUDA calls inside one step (sync debug mode) and the
   plain attention's share of a step.  (b) reduced qwen2 runs to loss 3.8:
   sync and PFAIT K = 4 must fire, PFAIT exactly 4 steps after sync; sync,
   PFAIT K = 3 and NFAIS2 K = 3 must fire where a host replay of the
   detection rule on the run's loss series fires; a 30-step run
   checkpointed every 10 steps must resume to 40, and a monitor state
   restored from a checkpoint must be bitwise the saved one.  (c) a
   reduced f32 state's 3 steps on the card must give the CPU's losses and
   grad norms within rtol 1e-4;
15. the other model families, bf16, seed-0 weights: (a) hymba-1.5b at full
   width (32 layers, d_model 1600, 25/5 heads of 64, window 2048, 50 SSD
   heads of 64, N = 16) through ``launch.serve.serve`` at batch 4,
   4096-token prompts, 64 new tokens: #6 once a layer in the prefill at
   window 2048, finite logits; then, on the same weights in f32, the
   prefill's logits with the kernel against the plain attention (phase 7's
   1e-4 of the largest) and a prefill over S − 128 plus 128 decode steps
   against the prefill over S (the JAX bar); (b) musicgen-medium at full
   width (48 layers, MHA 24 heads of 64, the audio frontend stub) at batch
   4, 2048-frame prompts: #6 once a layer, the same kernel check and one
   decode step; (c) mamba2-130m at full width (24 layers, attention-free)
   at batch 4, 4096-token prompts with (a)'s decode check, then trained
   through ``launch.train.train`` at TRAIN_4K (batch 4 × 4096): one warm-up
   and 4 timed steps, every loss and grad_norm finite, the first loss
   within 1.0 of ln V, finite parameters; (d) llama4-maverick at full width
   cut to one unit (a dense and a MoE layer, ≈ 37 GB) through
   ``launch.serve.generate`` at batch 2, 512-token prompts: #6 twice a
   prefill, finite logits, and the MoE layer's share of a prefill; (e)
   every family, reduced and in f32, on the card against the CPU: the
   prefill's logits and 3 train steps' losses and grad norms within rtol
   1e-4.  Then every #6 shape a main path launched must be in
   ``FLASH_CASES``;
16. the event engine (``core/async_engine.py``) and its protocols, the
   problems' blocks on the card and every sweep a kernel launch: (a)
   Tables 4–5 at the paper's smaller grid, convdiff n = 150, ρ = 0.93, the
   hybrid sweep, l∞, the stable platform, seed 0: PFAIT at ε̃/10 and NFAIS2
   and NFAIS5 at ε̃ on p = 50 (blocks 15×30×150), PFAIT on p = 150, each
   under a ``TraceRecorder`` scored by ``detection_report``: every run
   must terminate with r* < ε̃ and no false detection, give the JAX
   engine's sweeps, k_max, k_min, reductions, virtual times and message
   counts at the same seed (``EVENT_JAX``; only a detection moved by an
   f32 rounding at ε may depart, reported with its distance to ε), and
   launch #2 once a sweep; (b) reduced, each run on the card and again on
   the CPU: convdiff n = 24, p = 8 under every protocol, hybrid and
   Jacobi, l∞ and l2, PageRank n = 256, p = 4 in l1 and the ML problem
   n = 16, p = 4 under every protocol, and every spec of
   ``scenario_registry()`` under PFAIT: equal events, counters and
   verdicts, x within 1e-12, residuals within rtol 1e-6 (l∞) or 1e-5
   (l2, l1) plus the f64 floor of a residual near convergence; (c) phase
   8's recorded traces through the port's ``fit_cost_model`` and
   ``replay``: each validates, its predicted wall printed beside the
   measured one.  Prints walls, sweeps/s, device→host syncs and launches
   per run, and the PFAIT/NFAIS2 ratios of virtual wtime and k_max.  #1,
   #2 and #5 must launch, #2 once per hybrid sweep of the phase; then
   phase 10's shape check and ``rank`` table cover this phase too;
17. the model's parallel layout, in a spawned world of two gloo ranks
   sharing ``cuda:0`` (``make_host_mesh(model_axis=2)``, every collective
   staged through host memory): (a) qwen2-1.5b at full width, tensor
   parallel at tp 2, phase 7's prompts (batch 4 × 2048) and 8 decode
   steps, the gathered logits against the tp = 1 twin (run here first) at
   ``BF16_MODEL_BAR`` × the JAX bar, #6 28 times a rank at its per-rank
   shape; (b) its training at tp 2, batch 1 × 4096, 2 steps with the f32
   reduction of the TP partial sums and 2 with ``tp_reduce_bf16``, from
   the same seed-0 state: the first loss within rtol 1e-3 of the tp = 1
   loss, the bf16-reduce loss within 5e-3 of the f32 one, everything
   finite, no launch of #1–#6; (c) phase 15(d)'s cut llama4-maverick,
   expert parallel (64 experts a rank, the only ones it draws), batch 2 ×
   512: at ample capacity nothing drops and the logits hold to phase
   15(d)'s tp = 1 prefill at the same bar; at capacity factor 1.0 the
   dropped share, the ``all_to_all`` bytes and ms and the MoE layer's
   share of the prefill are printed.  Prints prefill ms, decode ms a step,
   ms a training step, staged bytes and blocked seconds per rank; every
   #6 shape a rank launched must be in ``FLASH_CASES``;
18. the rest of the parallel layout, the tp = 1 twins first in this
   process, then a spawned world of two gloo ranks on ``cuda:0``: (a)
   hymba-1.5b at full width, the SSM mixer and the attention at tp 2,
   batch 1 × 4096 (past its 2048 window) and 8 decode steps, in bf16 and
   again on the same weights in f32: the f32 gathered logits within 1e-4
   of the largest of the f32 twin's, the bf16 ones no further from the f32
   twin than 1.5 × the bf16 twin's own error (two one-device bf16
   evaluations of hymba part by more than ``BF16_MODEL_BAR`` × the JAX
   bar, and the line prints both readings), #6 32 times a rank and dtype
   at its per-rank shape; (b) mamba2-130m trained at tp 2, batch 1 × 4096,
   2 steps: the first loss within rtol 1e-3 of the twin's; (c) qwen2-1.5b
   trained with dense FSDP on a (2, 1) mesh, global batch 2 × 4096, 2
   steps: the first loss within rtol 1e-3 of the twin's, then a sharded
   checkpoint (every rank gathers, rank 0 writes JAX's layout) restored
   into a fresh model and state, whose step 3 must equal the carried
   step 3 to the bit; (b) and (c) finite and launching none of #1–#6; (d)
   (a)'s prefill and (c)'s step on a dry rank of the same layout here
   (``meta``): the payload bytes of each collective kind equal rank 0's
   live counter, and (c)'s FLOPs a ``FlopCounterMode`` count of rank 0's
   live step.  Prints ms per prefill, decode step and training step,
   payload bytes and seconds by collective kind, staged bytes and blocked
   seconds, each rank's parameter and moment bytes against the fsdp-off
   reckoning, the peaks, the save and restore walls, and the dry peak
   estimate beside the measured step peak.

19. the paper's solver cell (``launch/dryrun.py:lower_solver_cell``: the
   1-D shard runtime's convdiff solve at n = 1024, f32, PFAIT at ε̃ 1e-4,
   margin 10, K = 4, the non-blocking reduction, 4 inner sweeps): (a) at
   the cell's blocks (one of 256 and one of 512 shards, held against the
   plain versions in phase 2) the work #1 (sweep and residual) and #5
   report at a launch equals what their ``meta`` paths report, and #1 and
   #5 are timed at the 256-shard block; (b) the solve at its own size,
   stacked, p = 256 (b drawn on the card from a seeded generator), a few
   outer iterations under ``launch.hlo_analysis.trace_program``: the
   kernels' reported work over p must equal a dry rank's kernel work over
   the same iterations exactly, every value finite and the exact residual
   below b's; then ms per outer iteration from two more runs, and the
   launches a shard makes an iteration (host-bound); (c)
   ``lower_solver_cell`` on both meshes, each record printed; (d)
   ``examples/torch/quickstart.py`` on the card: the CPU's outer counts
   (sync 59, pfait 72, nfais2 66, nfais5 70), every row under ε̃.

Phases 4 to 9 and 11 to 19 are the main paths.  The kernels' launch counters are
set to 0 just before each of them and read just after; every kernel of a
path must show launches there (phase 9's and phase 12's in the counters
their ranks report; phase 11's graph replays add the launches their
capture recorded).  Phase 14 and phase 15's mamba2-130m runs are the main
paths that must launch none of the six: training runs the plain attention
under autograd, as the JAX model does (its ``Model._ctx`` passes
``use_kernel=False``), and the flash kernel has no backward, so a launch
there would put a kernel without a backward on an autograd path; mamba2
has no attention.  Needs
CUDA: without a card, or without the repository's ``src/`` beside it, the
script exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
from collections import Counter
import statistics
from typing import NamedTuple
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
EPS_TILDE = 1e-6
INF = float("inf")
SOLVER_N = 185                        # the paper's larger grid (EXPERIMENTS.md)
SHARD_N = 150                         # the paper's smaller grid
HBM_BYTES_PER_S = 3.35e12            # H100 SXM data sheet
PEAK_F64_FLOPS = 34e12               # H100 SXM data sheet, f64 outside the tensor cores
PEAK_F32_FLOPS = 67e12               # H100 SXM data sheet, f32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12             # H100 SXM data sheet, dense bf16 on the tensor cores
# the serving path: qwen2-1.5b at full width (28 layers, 12 q / 2 kv heads of
# 128), batch 4, 2048-token prompts, 64 new tokens
SERVE_ARCH, SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = "qwen2-1.5b", 4, 2048, 64
# flash attention cases (BH, BN, S, H, causal, window, dtype): the serving
# path's prefill shape (B·N·P = 4·2·6 rows, B·N = 8 kv rows), a ragged S, a
# window, the non-causal case and H = 64, in bf16 and f32; then phase 15's
# prefill shapes: hymba-1.5b (4·5·5 rows of 64 over 4·5 kv rows, S 4096,
# window 2048), musicgen-medium (MHA, 4·24 rows of 64, S 2048) and the cut
# llama4-maverick (2·8·5 rows of 128 over 2·8 kv rows, S 512); then phase
# 17's per-rank prefill shapes at tp 2: qwen2-1.5b's rank holds 1 of the 2
# kv slots with its 6 q heads (4·1·6 rows over 4·1 kv rows), the cut
# llama4's 4 of 8 slots with 5 q heads each (2·4·5 rows over 2·4); then
# phase 18's hymba-1.5b rank at tp 2, in bf16 and in f32.  main() fails if
# a main path launches
# #6 at a shape not listed here
SERVE_FLASH = (48, 8, 2048, 128, True, 0, "bf16")
HYMBA_FLASH = (100, 20, 4096, 64, True, 2048, "bf16")
MUSICGEN_FLASH = (96, 96, 2048, 64, True, 0, "bf16")
LLAMA4_FLASH = (80, 16, 512, 128, True, 0, "bf16")
TP_FLASH = (24, 4, 2048, 128, True, 0, "bf16")
EP_FLASH = (40, 8, 512, 128, True, 0, "bf16")
# phase 18's: hymba-1.5b's rank at tp 2 holds 3 of the 6 kv groups (5 padded
# to 6) with their 5 q heads each, at batch 1 (1·3·5 rows over 1·3 kv rows)
HYMBA_TP_FLASH = (15, 3, 4096, 64, True, 2048, "bf16")
HYMBA_TP_FLASH_F32 = HYMBA_TP_FLASH[:-1] + ("f32",)
FLASH_CASES = [SERVE_FLASH, (48, 8, 2048, 128, True, 0, "f32"),
               (48, 8, 1000, 128, True, 0, "bf16"), (48, 8, 1000, 128, True, 0, "f32"),
               (48, 8, 2048, 128, True, 256, "bf16"), (48, 8, 1000, 128, False, 0, "bf16"),
               (48, 8, 1000, 128, False, 0, "f32"), (48, 8, 2048, 64, True, 0, "bf16"),
               (48, 8, 1000, 64, True, 256, "f32"),
               HYMBA_FLASH, MUSICGEN_FLASH, LLAMA4_FLASH, TP_FLASH, EP_FLASH, HYMBA_TP_FLASH,
               HYMBA_TP_FLASH_F32]

# the PageRank path: n = 16384 nodes (a 2 GiB f64 operator), p = 4 row
# blocks of 4096, ε̃ = 1e-9 in l1, and the heterogeneous knobs of run (b)
PAGERANK_N, PAGERANK_P, PAGERANK_EPS = 16384, 4, 1e-9
PAGERANK_KNOBS = dict(inner_sweeps=(1, 2, 1, 3), halo_delay=(0, 1, 0, 2),
                      contrib_lag=(0, 1, 0, 1))
# #5's 1-D shapes on the main paths: a PageRank shard's block (one partial,
# split over a cluster), a ragged block and the whole state; the block of
# one of 2 shards (the elastic path after its crash); and the training
# path's replica of a rank (its stacks are TRAIN_STACKS, below)
PAGERANK_VECTORS = (4096, 4095, 16384, 8192, 1024)
# the PageRank problem and its dense operator on the host, drawn by phase 8
# and run again by phase 13
_PAGERANK_HOST: dict = {}
# f64 unit roundoff: two f64 evaluations of Σ|d·P x + v − x| in different
# summation orders may part by a few units of it times Σ(d·P|x| + v + |x|)
F64_UNIT = 2.0 ** -53

# shapes the main path gives the kernels: the 185³ single-device grid, the
# 25×150×150 block of one of 6 shards, the 30×150×150 block of one of 5
# (the elastic path after its crash), the 75×150×150 block of one of 2 and
# the whole 150³ grid of one at n = 150 (also a convdiff lane of the
# detection service, in f32), the 38×152×152 block of one of 4 at
# n = 152, make_sharded_solver's 50×75×150 block of the (3, 2) mesh, a
# ragged block, the event engine's (phase 16): the blocks of p = 50 and
# p = 150 at n = 150, and at n = 24 the block of p = 8 and the whole grid
# (its exact residual), and the paper's solver cell's (phase 19): one of 256
# and one of 512 shards at n = 1024.  main() fails if a main path launches
# #1-#4 at a block shape not listed here (or in HALO_SHAPES for #3/#4)
SHAPES = {"main": (185, 185, 185), "shard": (25, 150, 150), "p5": (30, 150, 150),
          "p2": (75, 150, 150), "p1": (150, 150, 150), "p4": (38, 152, 152),
          "mesh32": (50, 75, 150), "ragged": (13, 37, 19),
          "ev50": (15, 30, 150), "ev150": (10, 15, 150), "ev8": (6, 12, 24),
          "ev1": (24, 24, 24), "cell256": (4, 1024, 1024), "cell512": (2, 1024, 1024)}
# and the halo kernels': the blocks of the (3, 2) and (2, 2, 2) meshes at
# n = 150, the 1-D shard block, the 185³ grid, the ragged block and the
# (3, 2) mesh's two overlap face slabs.  The halo Jacobi sweep splits a
# tile over a cluster at the mesh blocks, the shard block and the x slab,
# and keeps one CTA per tile at 185³, the ragged block and the y slab
HALO_SHAPES = {"mesh32": (50, 75, 150), "mesh222": (75, 75, 75), "shard": (25, 150, 150),
               "main": (185, 185, 185), "ragged": (13, 37, 19), "slab": (1, 75, 150),
               "slab_y": (50, 1, 150)}
# stated tolerances, relative to the largest magnitude of the plain result:
# f64 blocks differ by FMA contraction only; f32 sums differ by summation
# order (at most ~150 sequential adds per thread, then a tree)
TOL = {("block", "f64"): 1e-12, ("block", "f32"): 1e-5, ("block", "bf16"): 1e-5,
       ("max", "f64"): 1e-6, ("max", "f32"): 1e-5, ("max", "bf16"): 1e-6,
       ("sum", "f64"): 2e-5, ("sum", "f32"): 2e-5, ("sum", "bf16"): 2e-5,
       # attention outputs, as tests/test_kernels.py:83: f32 summation order,
       # one bf16 rounding of the output
       ("attn", "f32"): 2e-5, ("attn", "bf16"): 3e-2}
# bf16 attention outputs are also held element by element, under
# ``flash_attention.ref.bf16_output_bar``: the kernel rounds each softmax
# weight p to bf16 (unit roundoff 2^-8) for its P·V product, with l summed
# from the f32 p, which moves its f32 output by at most 2^-8·Σp|v|/l, the
# plain version applied to |v|; then both sides round once to bf16, one
# step, below 2^-7·|want|, with 2^-7·rms(want) for f32 summation order near
# zero.  So |Δ| ≤ 2^-7·(|want| + rms(want)) + 2^-8·ref(q, k, |v|), the last
# term in f64 from the same inputs.
# a bf16 evaluation of the serving model against another: the largest
# share of the JAX bar (tests/test_models.py:88-91) that the flash kernel
# vs the plain attention, and prefill(S − 1) + decode vs prefill(S), may
# reach.  It lies between the drift of two plain evaluations (block_kv 512
# and 256 against 1024: 1.195 and 1.113 on the H100) and a plain
# evaluation that drops kv tile 0 for the last 64 rows (16.44); both are
# read again in every run, and the run fails if the bar leaves that gap
BF16_MODEL_BAR = 3.0


# the detection service path (phase 11): the service's knobs, and an
# open-loop load of 64 tenants arriving as a Poisson stream of 2 a tick
# (seed 0), round-robin over the families, each family's tenants alternating
# over its variants.  Sizes users run: convdiff at the paper's smaller grid
# (150³, a 13.5 MB f32 lane), PageRank at n = 4096 (a 64 MiB f32 operator a
# lane), mlfixed at n = 1024 over 3072 rows.  Each ε̃ grid sits ≥ 3× above
# the family's floor after the PFAIT margin (min(grid) / 10 ≥ 3 × floor),
# the larger of its f32 and f64 floors, which the phase measures and checks
# in every run
SERVICE_CFG = dict(lanes=2, chunk=16, max_staleness=8, max_steps=4096)
SERVICE_TENANTS, SERVICE_RATE, SERVICE_SEED = 64, 2.0, 0
SERVICE_MODES = ("pfait", "nfais5", "nfais2", "sync")
SERVICE_FAMILIES = (
    ("convdiff", ({"n": 150, "p": 4, "rho": 0.9, "sweep": "jacobi"},
                  {"n": 150, "p": 4, "rho": 0.9, "sweep": "hybrid"}), (1e-3, 1e-4)),
    ("pagerank", ({"n": 4096, "p": 4},), (1e-3, 1e-4, 1e-5)),
    ("mlfixed", ({"n": 1024, "p": 4, "m_rows": 3072, "task": "lstsq", "cond": 10.0},
                 {"n": 1024, "p": 4, "m_rows": 3072, "task": "logistic", "cond": 10.0}),
     (1e-3, 1e-4)),
)
SERVICE_KERNELS = ("fused_sweep_residual", "fused_rbgs_sweep_residual", "diff_norm_partials")
# #5's shape on that path: one launch over a PageRank bucket's lanes
SERVICE_PAGERANK_LANES = (SERVICE_CFG["lanes"], 4096)
# the ticks the profiler records (first tick, count): arrivals still come
# and every family's buckets run
SERVICE_PROFILE = (10, 4)
# the floors: seeds and steps each variant runs with no detection
FLOOR_SEEDS, FLOOR_STEPS = (0, 1), 2048
# a tenant's series on the card against its CPU rerun: rtol 2e-5 (sums) or
# 1e-5 (max), plus twice the family's f32 floor and four f32 units of the
# tenant's first residual (the scale of its terms): below those the two
# paths' roundings differ
SERVICE_RTOL = {"convdiff": 1e-5, "pagerank": 2e-5, "mlfixed": 2e-5}


class SmokeFailure(RuntimeError):
    pass


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def _time_ms(fn, calls: int = 10, reps: int = 20):
    """``(device_ms, call_ms)`` per call of ``fn``, or of a list of calls
    taken in turn (rotating inputs: each call finds its inputs as the
    others left the L2).

    ``device_ms`` is the device's time alone: ``calls`` calls are captured
    in a CUDA graph, and the median of ``reps`` timed replays (CUDA events)
    is divided by ``calls``.  ``call_ms`` is the time per call when the host
    issues them back to back, launch overhead included — what a Python
    loop pays."""
    import torch

    fns = list(fn) if isinstance(fn, (list, tuple)) else [fn]
    for _ in range(3):
        for f in fns:
            f()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for c in range(calls):
        fns[c % len(fns)]()
    ev[1].record()
    torch.cuda.synchronize()
    call_ms = ev[0].elapsed_time(ev[1]) / calls
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for c in range(calls):
            fns[c % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    evs = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        graph.replay()
        e.record()
        evs.append((s, e))
    torch.cuda.synchronize()
    device_ms = statistics.median(s.elapsed_time(e) for s, e in evs) / calls
    del graph
    torch.cuda.empty_cache()
    return device_ms, call_ms


class Checker:
    """Holds each kernel against its plain version, raising on the first
    output beyond its tolerance; keeps the largest absolute error per
    (kernel, output) and the largest relative one per kernel."""

    def __init__(self):
        self.abs_err = {}
        self.rel_err = {}
        self.of_tol = {}   # largest error as a share of its tolerance
        self.of_bar = {}   # bf16 attention: worst element's share of its own bar

    def __call__(self, kernel: str, what: str, kind: str, dt: str, got, want, bar=None):
        g, w = got.double(), want.double()
        _require(bool(g.isfinite().all()), f"{kernel} {what}: non-finite output")
        err = float((g - w).abs().max())
        scale = max(float(w.abs().max()), 1e-30)
        tol = TOL[(kind, dt)]
        out = "partials" if kind in ("max", "sum") else "block"
        self.abs_err[kernel, out] = max(self.abs_err.get((kernel, out), 0.0), err)
        self.rel_err[kernel] = max(self.rel_err.get(kernel, 0.0), err / scale)
        self.of_tol[kernel] = max(self.of_tol.get(kernel, 0.0), err / (tol * scale))
        _require(err <= tol * scale,
                 f"{kernel} {what}: max|Δ| {err:.3e} > {tol:g} × {scale:.3e}")
        if bar is not None:
            share = _bar_share(g, w, bar)
            self.of_bar[kernel] = max(self.of_bar.get(kernel, 0.0), share)
            _require(share <= 1.0, f"{kernel} {what}: worst element at {share:.3f} of "
                     f"|Δ| ≤ 2^-7·(|want| + rms(want)) + 2^-8·ref(q, k, |v|)")


def _bar_share(got, want, bar) -> float:
    """The worst element's share of an element-wise bar on |got − want|."""
    return float(((got.double() - want.double()).abs() / bar).max())


# the partial modes: max|r| (l∞), Σr² (l2), Σ|r| (l1), and the reduction
# each is held as
ORDS = {INF: "max", 2.0: "sum", 1.0: "sum"}


def _ord_tag(ord_) -> str:
    return {INF: "linf", 2.0: "l2", 1.0: "l1"}[ord_]


def check_kernels(st, dev, check: Checker) -> None:
    import torch

    from repro_torch.kernels.jacobi3d import jacobi3d as jk
    from repro_torch.kernels.jacobi3d import ref as jref
    from repro_torch.kernels.residual_norm import ref as rref
    from repro_torch.kernels.residual_norm import residual_norm as rk

    gen = torch.Generator(device=dev).manual_seed(0)

    def rand(shape, dtype):
        return torch.rand(shape, generator=gen, device=dev, dtype=dtype) * 2 - 1

    def same_twice(kernel, tag, call):
        """The kernel's output and partials bitwise equal across two calls."""
        got = call()
        again = call()
        _require(all(torch.equal(u, v) for u, v in zip(got, again)),
                 f"{kernel} {tag}: two calls on the same inputs differ")
        return got

    dtypes = {"f64": torch.float64, "f32": torch.float32}
    n_cases = 0
    for sname, (bx, by, bz) in SHAPES.items():
        a, c = rand((bx, by, bz), torch.float64), rand((bx, by, bz), torch.float64)
        for ord_ in ORDS:
            same_twice("diff_norm_partials", sname,
                       lambda: (rk.diff_norm_partials(a, c, ord=ord_),))
        for dt, dtype in dtypes.items():
            g = rand((bx + 2, by + 2, bz + 2), dtype)
            g2 = rand((bx + 4, by + 4, bz + 2), dtype)
            b = rand((bx, by, bz), dtype)
            for ord_, red in ORDS.items():
                for op in ("sweep", "residual"):
                    tag = f"{sname} {dt} op={op} {_ord_tag(ord_)}"
                    got = same_twice("fused_sweep_residual", tag, lambda: jk.fused_sweep_residual(
                        g, b, st.coefs, op=op, ord=ord_))
                    want = jref.fused_sweep_residual_ref(g, b, st.coefs, op=op, ord=ord_)
                    check("fused_sweep_residual", tag + " block", "block", dt, got[0], want[0])
                    check("fused_sweep_residual", tag + " partials", red, dt, got[1], want[1])
                    n_cases += 1
                for ox, oy in ((0, 0), (3, 5), (0, 1)):
                    tag = f"{sname} {dt} phase=({ox},{oy}) {_ord_tag(ord_)}"
                    got = same_twice("fused_rbgs_sweep_residual", tag,
                                     lambda: jk.fused_rbgs_sweep_residual(g2, b, st.coefs,
                                                                          ox + oy, ord=ord_))
                    want = jref.fused_rbgs_sweep_residual_ref(g2, b, st.coefs, ox + oy,
                                                              ord=ord_)
                    check("fused_rbgs_sweep_residual", tag + " block", "block", dt,
                          got[0], want[0])
                    check("fused_rbgs_sweep_residual", tag + " partials", red, dt,
                          got[1], want[1])
                    n_cases += 1
        for dt, dtype in (*dtypes.items(), ("bf16", torch.bfloat16)):
            a, c = rand((bx, by, bz), dtype), rand((bx, by, bz), dtype)
            for ord_, red in ORDS.items():
                check("diff_norm_partials", f"{sname} {dt} {_ord_tag(ord_)}", red, dt,
                      rk.diff_norm_partials(a, c, ord=ord_),
                      rref.diff_norm_partials_ref(a, c, ord=ord_))
                n_cases += 1
    for sname, (bx, by, bz) in HALO_SHAPES.items():
        for dt, dtype in dtypes.items():
            x, b = rand((bx, by, bz), dtype), rand((bx, by, bz), dtype)
            h = [rand(s, dtype) for s in ((by, bz), (by, bz), (bx, bz), (bx, bz),
                                           (bx, by), (bx, by))]
            for ord_, red in ORDS.items():
                for op in ("sweep", "residual"):
                    tag = f"{sname} {dt} op={op} {_ord_tag(ord_)}"
                    got = same_twice("fused_sweep_residual_halo", tag,
                                     lambda: jk.fused_sweep_residual_halo(
                                         x, h, b, st.coefs, op=op, ord=ord_))
                    want = jref.fused_sweep_residual_halo_ref(x, h, b, st.coefs, op=op,
                                                              ord=ord_)
                    check("fused_sweep_residual_halo", tag + " block", "block", dt,
                          got[0], want[0])
                    check("fused_sweep_residual_halo", tag + " partials", red, dt,
                          got[1], want[1])
                    n_cases += 1
                for oxyz in (0, 1, 5):
                    tag = f"{sname} {dt} oxyz={oxyz} {_ord_tag(ord_)}"
                    got = same_twice("fused_rbgs_sweep_residual_halo", tag,
                                     lambda: jk.fused_rbgs_sweep_residual_halo(
                                         x, h, b, st.coefs, oxyz, ord=ord_))
                    want = jref.fused_rbgs_sweep_residual_halo_ref(x, h, b, st.coefs, oxyz,
                                                                   ord=ord_)
                    check("fused_rbgs_sweep_residual_halo", tag + " block", "block", dt,
                          got[0], want[0])
                    check("fused_rbgs_sweep_residual_halo", tag + " partials", red, dt,
                          got[1], want[1])
                    n_cases += 1
            del x, b, h
    check_nan_and_slabs(st, dev, rand)
    # f64 update differences near 1e-13 must survive the cast to f32
    a = 1.0 + rand(SHAPES["shard"], torch.float64)
    c = a + 1e-13 * rand(SHAPES["shard"], torch.float64)
    for ord_, red in ORDS.items():
        got = rk.diff_norm_partials(a, c, ord=ord_)
        _require(bool((got > 0).all()), "diff_norm_partials: tiny f64 differences lost")
        check("diff_norm_partials", f"tiny-f64 {_ord_tag(ord_)}", red, "f64", got,
              rref.diff_norm_partials_ref(a, c, ord=ord_))
        n_cases += 1
    # the PageRank path's vectors: state-sized differences of ≈ 1e-13
    for n in PAGERANK_VECTORS:
        for dt, dtype in (*dtypes.items(), ("bf16", torch.bfloat16)):
            a = (rand((n,), torch.float64) / n).to(dtype)
            c = a + (rand((n,), torch.float64) * 1e-13 if dt == "f64" else rand((n,), dtype))
            for ord_, red in ORDS.items():
                tag = f"{n} {dt} {_ord_tag(ord_)}"
                got = same_twice("diff_norm_partials", tag,
                                 lambda: (rk.diff_norm_partials(a, c, ord=ord_),))[0]
                check("diff_norm_partials", tag, red, dt, got,
                      rref.diff_norm_partials_ref(a, c, ord=ord_))
                n_cases += 1
        a = rand((n,), torch.float64)
        c = a.clone()
        c[n // 3] = float("nan")
        _require(bool(rk.diff_norm_partials(a, c, ord=1.0).isnan().all()),
                 f"diff_norm_partials {n} f64: a NaN does not reach the l1 partial")
    # the training path's [p, n] f64 replica stacks, a partial per replica
    # (block n), update differences of a round near convergence
    for rows, n in TRAIN_STACKS:
        a = rand((rows, n), torch.float64)
        c = a + rand((rows, n), torch.float64) * 1e-9
        for ord_, red in ORDS.items():
            tag = f"{rows}x{n} block {n} f64 {_ord_tag(ord_)}"
            got = same_twice("diff_norm_partials", tag,
                             lambda: (rk.diff_norm_partials(a, c, block=n, ord=ord_),))[0]
            _require(tuple(got.shape) == (rows,),
                     f"diff_norm_partials {tag}: {tuple(got.shape)}")
            check("diff_norm_partials", tag, red, "f64", got,
                  rref.diff_norm_partials_ref(a, c, block=n, ord=ord_))
            n_cases += 1
    # the service path's PageRank lanes: [lanes, n] f32 states, a partial per
    # lane (block n), differences of a step near convergence
    lanes, n = SERVICE_PAGERANK_LANES
    a = (rand((lanes, n), torch.float64) / n).float()
    c = a + rand((lanes, n), torch.float32) * 1e-6
    for ord_, red in ORDS.items():
        tag = f"{lanes}x{n} block {n} f32 {_ord_tag(ord_)}"
        got = same_twice("diff_norm_partials", tag,
                         lambda: (rk.diff_norm_partials(a, c, block=n, ord=ord_),))[0]
        _require(tuple(got.shape) == (lanes,), f"diff_norm_partials {tag}: {tuple(got.shape)}")
        check("diff_norm_partials", tag, red, "f32", got,
              rref.diff_norm_partials_ref(a, c, block=n, ord=ord_))
        n_cases += 1
    torch.cuda.synchronize()
    print(f"kernels vs plain: {n_cases} cases within tolerance, each in the three partial "
          f"modes (l∞ max|r|, l2 Σr², l1 Σ|r|); every stencil kernel's output and partials "
          f"and diff_norm_partials' partials bitwise equal across two calls at every shape, "
          f"variant, phase and mode; a NaN in the block reaches the l∞ partial of #1-#4 at "
          f"{', '.join(NAN_SHAPES)} and #5's l1 partial at the 1-D vectors "
          f"{', '.join(map(str, PAGERANK_VECTORS))}; #5 at the training replica stacks "
          f"{', '.join('x'.join(map(str, t)) for t in TRAIN_STACKS)} f64, a partial per "
          f"replica; #5 at the service's PageRank lanes "
          f"{'x'.join(map(str, SERVICE_PAGERANK_LANES))} f32, a partial per lane; the halo "
          f"sweep's six face slabs bitwise the block's "
          f"faces at {'x'.join(map(str, HALO_SHAPES['mesh32']))}")
    for k, v in check.rel_err.items():
        print(f"  {k}: max relative error {v:.2e}; worst case at {check.of_tol[k]:.3f} "
              f"of its tolerance (tolerances: blocks f64 1e-12, f32 1e-5; max "
              f"partials 1e-6/1e-5; sum partials 2e-5); max abs error of the block "
              f"{check.abs_err.get((k, 'block'), 0.0):.3e}")


NAN_SHAPES = ("main", "shard", "ragged", "mesh222")


def check_nan_and_slabs(st, dev, rand) -> None:
    """A NaN in the block reaches the l∞ partials of the tiles whose input
    residual it touches, as in the plain version, in #1-#4 (split and
    unsplit grids); a thickness-1 face slab swept by #3 is bitwise that
    face of the block's sweep at the (3, 2) mesh block, where the grid
    splits (the comm overlap's premise)."""
    import torch

    from repro_torch.kernels.jacobi3d import jacobi3d as jk
    from repro_torch.kernels.jacobi3d import ref as jref

    f64 = torch.float64

    def nan_reaches(kernel, got, want, name):
        got, want = got[1].isnan(), want[1].isnan()
        _require(bool(want.any()) and torch.equal(got, want),
                 f"{kernel} {name}: a NaN does not reach the partials as in the plain version")

    for name in NAN_SHAPES:
        bx, by, bz = shape = {**SHAPES, **HALO_SHAPES}[name]
        i, j, z = bx // 2, by // 2, bz // 2
        b = rand(shape, f64)
        g, g2 = rand((bx + 2, by + 2, bz + 2), f64), rand((bx + 4, by + 4, bz + 2), f64)
        g[i + 1, j + 1, z + 1] = float("nan")
        g2[i + 2, j + 2, z + 1] = float("nan")
        nan_reaches("fused_sweep_residual", jk.fused_sweep_residual(g, b, st.coefs),
                    jref.fused_sweep_residual_ref(g, b, st.coefs), name)
        nan_reaches("fused_rbgs_sweep_residual", jk.fused_rbgs_sweep_residual(g2, b, st.coefs, 0),
                    jref.fused_rbgs_sweep_residual_ref(g2, b, st.coefs, 0), name)
        x = rand(shape, f64)
        h = [rand(s, f64) for s in ((by, bz), (by, bz), (bx, bz), (bx, bz), (bx, by), (bx, by))]
        x[i, j, z] = float("nan")
        nan_reaches("fused_sweep_residual_halo", jk.fused_sweep_residual_halo(x, h, b, st.coefs),
                    jref.fused_sweep_residual_halo_ref(x, h, b, st.coefs), name)
        nan_reaches("fused_rbgs_sweep_residual_halo",
                    jk.fused_rbgs_sweep_residual_halo(x, h, b, st.coefs, 1),
                    jref.fused_rbgs_sweep_residual_halo_ref(x, h, b, st.coefs, 1), name)
        del g, g2, x, h, b
    shape = HALO_SHAPES["mesh32"]
    x, b = rand(shape, f64), rand(shape, f64)
    h = [rand(s, f64) for s in ((shape[1], shape[2]),) * 2 + ((shape[0], shape[2]),) * 2
         + ((shape[0], shape[1]),) * 2]
    full, _ = jk.fused_sweep_residual_halo(x, h, b, st.coefs)
    for d in range(3):
        for idx in (0, shape[d] - 1):
            sg = []
            for e in range(3):
                if e == d:
                    sg += [h[2 * d] if idx == 0 else x.select(d, idx - 1),
                           x.select(d, idx + 1) if idx == 0 else h[2 * d + 1]]
                else:
                    pos = d if d < e else d - 1
                    sg += [h[2 * e].narrow(pos, idx, 1), h[2 * e + 1].narrow(pos, idx, 1)]
            slab, _ = jk.fused_sweep_residual_halo(
                x.narrow(d, idx, 1).contiguous(), sg, b.narrow(d, idx, 1).contiguous(),
                st.coefs)
            _require(torch.equal(slab, full.narrow(d, idx, 1)),
                     f"halo sweep: face slab (axis {d}, index {idx}) is not bitwise the "
                     f"block's face")


def _flash_ref_and_bar(q, k, v, causal, window, bf16):
    """``flash_attention_ref`` and, for bf16, ``bf16_output_bar`` over
    slices of the kv rows (and their q rows), so that no slice holds more
    than 2^28 scores: at hymba's shape the whole f64 bar would hold 13 GB a
    tensor."""
    import torch

    from repro_torch.kernels.flash_attention.ref import bf16_output_bar, flash_attention_ref

    BH, S, _ = q.shape
    BN, Skv, _ = k.shape
    rep = BH // BN
    per = max(1, (1 << 28) // (rep * S * Skv))
    wants, bars = [], []
    for n0 in range(0, BN, per):
        n1 = min(BN, n0 + per)
        qs, ks, vs = q[n0 * rep:n1 * rep], k[n0:n1], v[n0:n1]
        wants.append(flash_attention_ref(qs, ks, vs, causal=causal, window=window))
        if bf16:
            bars.append(bf16_output_bar(wants[-1], qs, ks, vs, causal=causal, window=window))
    return torch.cat(wants), (torch.cat(bars) if bf16 else None)


def check_flash(dev, check: Checker) -> None:
    """#6 against its plain version (``flash_attention_ref``) on the card."""
    import torch

    from repro_torch.kernels.flash_attention import flash_attention as fk
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    gen = torch.Generator(device=dev).manual_seed(2)
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    for case in FLASH_CASES:
        BH, BN, S, H, causal, window, dt = case
        q, k, v = (torch.randn((n, S, H), generator=gen, device=dev).to(dtypes[dt])
                   for n in (BH, BN, BN))
        tag = f"{BH}x{S}x{H} kv {BN} {dt} causal={causal} window={window}"
        want, bar = _flash_ref_and_bar(q, k, v, causal, window, dt == "bf16")
        check("flash_attention_flat", tag, "attn", dt,
              fk.flash_attention_flat(q, k, v, causal=causal, window=window), want, bar)
        if case == SERVE_FLASH:
            # the bars' power: the plain version with kv tile 0 dropped for
            # the last row (and part of it for the 63 rows before)
            bad = flash_attention_ref(q, k, v, causal=causal, window=S - 64).double()
            w = want.double()
            faulty = (_bar_share(bad, w, bar),
                      float((bad - w).abs().max()) / (TOL["attn", dt] * float(w.abs().max())))
        del q, k, v, want, bar
    torch.cuda.synchronize()
    k = "flash_attention_flat"
    print(f"flash attention vs plain: {len(FLASH_CASES)} cases within tolerance (f32 2e-5, "
          f"bf16 3e-2 of the largest magnitude); max relative error {check.rel_err[k]:.2e}, "
          f"worst case at {check.of_tol[k]:.3f} of its tolerance; max abs error "
          f"{check.abs_err[k, 'block']:.3e}; bf16 cases element by element: worst element at "
          f"{check.of_bar[k]:.3f} of |Δ| ≤ 2^-7·(|want| + rms(want)) + 2^-8·ref(q, k, |v|)")
    print(f"a plain output with one kv tile dropped for the last rows, at the path's shape: "
          f"{faulty[0]:.3f} of the element-wise bar, {faulty[1]:.3f} of the 3e-2 bar")
    _require(faulty[0] > 1.0, "the element-wise bf16 bar does not catch a dropped kv tile")


def tensor_core_sass():
    """Counts of ``HGMMA`` (wgmma) and ``HMMA`` (mma.sync) instructions in
    the built flash library's SASS, from ``cuobjdump -sass``; None where the
    toolkit has no ``cuobjdump``."""
    import shutil

    from repro_torch.kernels import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    out = subprocess.run([tool, "-sass", str(_build._lib_path("flash_attention"))],
                         capture_output=True, text=True, timeout=300, check=True).stdout
    lines = out.splitlines()
    return {op: sum(op in ln for ln in lines) for op in ("HGMMA", "HMMA")}


def flash_band(S: int, window: int) -> int:
    """The (q, kv) pairs inside the causal band, or the causal window band:
    Σ_q min(q + 1, window)."""
    if not window or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def time_flash(dev) -> dict:
    """#6 at each main-path prefill shape of ``FLASH_TIMED`` (bf16,
    causal), beside its plain version and ``F.scaled_dot_product_attention``
    on the ``[B, N·P, S, H]`` layout (with a window, SDPA takes the band as
    a boolean mask).  The plain version runs 2 calls a replay at the shapes
    past 2048 (its f32 scores take 6.7 GB at hymba's).  Returns the rows by
    case."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention as fk
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    rows = {}
    gen = torch.Generator(device=dev).manual_seed(3)
    for case, B in FLASH_TIMED:
        BH, BN, S, H, causal, window, _ = case
        NP = BH // B
        q, k, v = (torch.randn((n, S, H), generator=gen, device=dev).to(torch.bfloat16)
                   for n in (BH, BN, BN))
        qs, ks, vs = q.view(B, NP, S, H), k.view(B, BN // B, S, H), v.view(B, BN // B, S, H)
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())     # q, k, v in, o out
        flops = 4 * H * BH * flash_band(S, window)               # the causal (window) band
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_BF16_FLOPS
        ms, call_ms = _time_ms(lambda: fk.flash_attention_flat(q, k, v, window=window))
        big = dict(calls=2, reps=5) if S > 2048 else {}
        plain_ms, _ = _time_ms(lambda: flash_attention_ref(q, k, v, window=window), **big)
        if window:
            pos = torch.arange(S, device=dev)
            band = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
            library = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qs, ks, vs, attn_mask=band, enable_gqa=True)
        else:
            library = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qs, ks, vs, is_causal=True, enable_gqa=True)
        library_ms, _ = _time_ms(library)
        rows[case] = row = dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                                library_ms=library_ms, bound_ms=1e3 * max(t_bytes, t_ops),
                                bound_by="bytes" if t_bytes >= t_ops else "operations")
        print(f"time flash_attention_flat at {BH}x{S}x{H} kv {BN} bf16 causal window={window}: "
              f"kernel {ms:.4f} ms (eager call {call_ms:.4f} ms), plain {plain_ms:.4f} ms, "
              f"library (SDPA{', boolean band mask' if window else ''}) {library_ms:.4f} ms, "
              f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}; {flops / 1e9:.2f} GFLOP, "
              f"{nbytes / 1e6:.2f} MB)")
        del q, k, v, qs, ks, vs
        torch.cuda.empty_cache()
    return rows


HALO_KERNELS = ("fused_sweep_residual_halo", "fused_rbgs_sweep_residual_halo")


def _stencil_case(k, shape, st, rand, size=8):
    """A stencil kernel at a block shape, l∞, on random inputs from
    ``rand`` (f64, or f32 with ``size=4``, the bytes of an element):
    ``(kernel call, plain call, ghosted block for the library call, bytes,
    flops)``.  Bytes count each input read once and each output written
    once: the block (or the ghosted block) and the rhs in, the new block
    and the partials out, the six face planes for the halo kernels (#1's
    from ``jacobi3d.work``, the formula its wrapper reports)."""
    from repro_torch.kernels.jacobi3d import jacobi3d as jk
    from repro_torch.kernels.jacobi3d import ops as jops
    from repro_torch.kernels.jacobi3d import ref as jref
    from repro_torch.solvers.fixed_point import ghosted6

    bx, by, bz = shape
    cells = bx * by * bz
    x, b = rand(shape), rand(shape)
    _, _, nx, ny = jref.tile_grid(bx, by, jref.DEFAULT_TILE)
    flops = 18 * cells if k in ("fused_sweep_residual", "fused_sweep_residual_halo") \
        else 25 * cells
    if k in HALO_KERNELS:
        h = [rand(s) for s in ((by, bz), (by, bz), (bx, bz), (bx, bz), (bx, by), (bx, by))]
        nbytes = size * (3 * cells + sum(p.numel() for p in h)) + 4 * nx * ny
        if k == "fused_sweep_residual_halo":
            kern = lambda: jk.fused_sweep_residual_halo(x, h, b, st.coefs)  # noqa: E731
            plain = lambda: jref.fused_sweep_residual_halo_ref(x, h, b, st.coefs)  # noqa: E731
        else:
            kern = lambda: jk.fused_rbgs_sweep_residual_halo(x, h, b, st.coefs, 1)  # noqa: E731
            plain = lambda: jref.fused_rbgs_sweep_residual_halo_ref(  # noqa: E731
                x, h, b, st.coefs, 1)
        return kern, plain, ghosted6(x, h), nbytes, flops
    ghosts = (rand((by, bz)), rand((by, bz)), rand((bx, bz)), rand((bx, bz)))
    g = jops.ghost_pad1(x, ghosts)
    if k == "fused_sweep_residual":
        kern = lambda: jk.fused_sweep_residual(g, b, st.coefs)  # noqa: E731
        plain = lambda: jref.fused_sweep_residual_ref(g, b, st.coefs)  # noqa: E731
        flops, nbytes = jk.work(shape, size)
    else:
        g2 = jops.ghost_pad2(x, ghosts)
        kern = lambda: jk.fused_rbgs_sweep_residual(g2, b, st.coefs, 0)  # noqa: E731
        plain = lambda: jref.fused_rbgs_sweep_residual_ref(g2, b, st.coefs, 0)  # noqa: E731
        nbytes = size * (g2.numel() + 2 * cells) + 4 * nx * ny
    return kern, plain, g, nbytes, flops


def _bound(nbytes, flops, peak=None):
    """The least time (ms) the card could take, and which of bytes and
    operations sets it (operations at ``peak``, f64 by default)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / (peak or PEAK_F64_FLOPS)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _work_bound(work, peak=None):
    """``_bound`` of a wrapper's ``work(...)``, (operations, bytes)."""
    flops, nbytes = work
    return _bound(nbytes, flops, peak)


def _shape_str(shape) -> str:
    return "x".join(map(str, shape))


def time_kernels(st, dev) -> dict:
    """Per-kernel times (f64, l∞) keyed by (kernel, block shape): the
    stencils at every main-path shape, #5 at its two; and keyed by
    (kernel, shape, "cold") the two shard-block sweeps over six shards'
    worth of rotating inputs."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.jacobi3d import jacobi3d as jk
    from repro_torch.kernels.jacobi3d import ops as jops
    from repro_torch.kernels.residual_norm import ref as rref
    from repro_torch.kernels.residual_norm import residual_norm as rk

    gen = torch.Generator(device=dev).manual_seed(1)
    f64 = torch.float64

    def rand(shape):
        return torch.rand(shape, generator=gen, device=dev, dtype=f64) * 2 - 1

    # the nearest single PyTorch call for the stencils: the off-diagonal
    # apply alone as a 3-D convolution (it computes less than the kernels)
    w = torch.zeros((1, 1, 3, 3, 3), dtype=f64, device=dev)
    w[0, 0, 0, 1, 1], w[0, 0, 2, 1, 1] = st.xm, st.xp
    w[0, 0, 1, 0, 1], w[0, 0, 1, 2, 1] = st.ym, st.yp
    w[0, 0, 1, 1, 0], w[0, 0, 1, 1, 2] = st.zm, st.zp
    out = {}

    def record(k, shape, fns, bound, mode=""):
        kern, plain, lib = fns
        (ms, call_ms), (plain_ms, _), (library_ms, _) = map(_time_ms, (kern, plain, lib))
        print(f"time {k} at {_shape_str(shape)} f64{mode}: kernel {ms:.4f} ms (eager "
              f"call {call_ms:.4f} ms), plain {plain_ms:.4f} ms, library "
              f"{library_ms:.4f} ms, bound {bound[0]:.{'4f' if bound[0] >= 1e-4 else '3e'}} ms "
              f"({bound[1]})")
        out[k, shape] = dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                             library_ms=library_ms, bound_ms=bound[0], bound_by=bound[1])

    def stencil(k, shape):
        kern, plain, gin, nbytes, flops = _stencil_case(k, shape, st, rand)
        # the library call: the off-diagonal apply as a convolution of the
        # ghosted block, its assembly left out
        gin = gin[None, None]
        record(k, shape, (kern, plain, lambda: F.conv3d(gin, w)), _bound(nbytes, flops))

    for name in ("main", "mesh32", "mesh222"):
        shape = HALO_SHAPES[name]
        for k in HALO_KERNELS:
            stencil(k, shape)
        # what the halo kernel saves: assembling the ghosted block first
        # (ghost_pad1, the 1-D path's assembly) and sweeping it with #1
        bx, by, bz = shape
        x, b = rand(shape), rand(shape)
        h = [rand(s) for s in ((by, bz), (by, bz), (bx, bz), (bx, bz))]
        pad_ms, pad_call_ms = _time_ms(
            lambda: jk.fused_sweep_residual(jops.ghost_pad1(x, h), b, st.coefs))
        print(f"time ghost_pad1 + fused_sweep_residual at {_shape_str(shape)} f64: "
              f"{pad_ms:.4f} ms (eager call {pad_call_ms:.4f} ms)")
        del x, b, h
    for name in ("slab", "slab_y"):   # the (3, 2) mesh's overlap face slabs
        stencil("fused_sweep_residual_halo", HALO_SHAPES[name])
    for name in ("main", "shard", "p2"):
        for k in ("fused_sweep_residual", "fused_rbgs_sweep_residual"):
            if (k, name) != ("fused_rbgs_sweep_residual", "p2"):   # hybrid runs at p = 6
                stencil(k, SHAPES[name])
    for name in ("main", "shard", "p2"):
        shape = SHAPES[name]
        cells = shape[0] * shape[1] * shape[2]
        x, b = rand(shape), rand(shape)
        record("diff_norm_partials", shape, (
            lambda: rk.diff_norm_partials(x, b), lambda: rref.diff_norm_partials_ref(x, b),
            lambda: torch.dist(x, b, INF)), _work_bound(rk.work(cells, 8)))
        del x, b
    # the PageRank path's block: one shard's 4096 f64 in l1, one partial
    n = PAGERANK_N // PAGERANK_P
    x, b = rand((n,)), rand((n,))
    record("diff_norm_partials", (n,), (
        lambda: rk.diff_norm_partials(x, b, ord=1.0),
        lambda: rref.diff_norm_partials_ref(x, b, ord=1.0), lambda: torch.dist(x, b, 1)),
        _work_bound(rk.work(n, 8)), mode=" l1 (one partial)")
    del x, b
    # the elastic path's PageRank block after its crash (one of 2 shards,
    # 8192 f64, l1), and the training path's replica stack (a partial per
    # replica, l2)
    n = PAGERANK_N // 2
    x, b = rand((n,)), rand((n,))
    record("diff_norm_partials", (n,), (
        lambda: rk.diff_norm_partials(x, b, ord=1.0),
        lambda: rref.diff_norm_partials_ref(x, b, ord=1.0), lambda: torch.dist(x, b, 1)),
        _work_bound(rk.work(n, 8)), mode=" l1 (one partial)")
    rows, n = TRAIN_STACKS[0]
    x, b = rand((rows, n)), rand((rows, n))
    record("diff_norm_partials", (rows, n), (
        lambda: rk.diff_norm_partials(x, b, block=n, ord=2.0),
        lambda: rref.diff_norm_partials_ref(x, b, block=n, ord=2.0),
        lambda: torch.linalg.vector_norm(x - b, dim=1)),
        _work_bound(rk.work(rows * n, 8, block=n)), mode=" l2 (a partial per row)")
    del x, b
    # the runtime sweeps its six shards in turn, so each finds its block
    # gone from the L2: six shards' worth of inputs (> 50 MB), taken in turn
    for k, shape in (("fused_sweep_residual_halo", HALO_SHAPES["mesh32"]),
                     ("fused_rbgs_sweep_residual", SHAPES["shard"])):
        cases = [_stencil_case(k, shape, st, rand) for _ in range(6)]
        nbytes = cases[0][3]
        ms, call_ms = _time_ms([c[0] for c in cases], calls=12)
        warm = out[k, shape]["ms"]
        print(f"time {k} at {_shape_str(shape)} f64, six shards' inputs in turn "
              f"({6 * nbytes / 1e6:.1f} MB): kernel {ms:.4f} ms (eager call {call_ms:.4f} "
              f"ms); one warm input {warm:.4f} ms")
        out[k, shape, "cold"] = dict(ms=ms, call_ms=call_ms)
        del cases
        torch.cuda.empty_cache()
    return out


def rank_launches(st, dev, shape_launches, times) -> list:
    """The stencil kernels' main-path launches by (kernel, block shape,
    dtype), each priced at its shape's device time less its bound in its
    own type (f32 at 4 bytes an element and the f32 peak), largest first.
    A triple no timing above covered (those cover f64) is timed here
    (device time only).  Residual-only passes of the Jacobi kernels are
    priced at the sweep's numbers (they write no block, so this over-prices
    them a little)."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(4)
    dtypes = {"f64": (torch.float64, 8, PEAK_F64_FLOPS), "f32": (torch.float32, 4, PEAK_F32_FLOPS)}

    rows = []
    for (k, shape, dt), n in shape_launches.items():
        dtype, size, peak = dtypes[dt]
        t = times.get((k, shape)) if dt == "f64" else None
        if t is None:
            def rand(s, dtype=dtype):
                return torch.rand(s, generator=gen, device=dev, dtype=dtype) * 2 - 1

            kern, _, _, nbytes, flops = _stencil_case(k, shape, st, rand, size)
            ms, _ = _time_ms(kern)
            bound_ms, _ = _bound(nbytes, flops, peak)
            t = dict(ms=ms, bound_ms=bound_ms)
        rows.append(dict(kernel=k, shape=_shape_str(shape), dtype=dt, launches=n, ms=t["ms"],
                         bound_ms=t["bound_ms"], loss_ms=n * (t["ms"] - t["bound_ms"])))
    rows.sort(key=lambda r: -r["loss_ms"])
    print("rank by launches x (device ms - bound ms) over the main paths (device ms at each "
          "block shape, in the launches' own type):")
    for r in rows:
        print(f"  {r['kernel']:32s} {r['shape']:>12s} {r['dtype']}  launches {r['launches']:6d}  "
              f"device {r['ms']:.4f} ms  bound {r['bound_ms']:.4f} ms  loss {r['loss_ms']:.1f} ms")
    return rows


def _counters():
    from repro_torch.kernels.flash_attention import flash_attention as fk
    from repro_torch.kernels.jacobi3d import jacobi3d as jk
    from repro_torch.kernels.residual_norm import residual_norm as rk

    return jk, rk, fk


def _launches():
    return {k: v for mod in _counters() for k, v in mod.LAUNCHES.items()}


def _reset_launches():
    for mod in _counters():
        mod.reset_launches()


class Run(NamedTuple):
    """One main-path run: its result, wall time and the kernel launches it
    made, and the norm order it detected in."""

    name: str
    st: object
    b: object
    r: object
    wall: float
    used: dict
    ord: float = INF


def _run(label, fn, st, b, ord=INF) -> Run:
    import torch

    before = _launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    used = {k: v - before[k] for k, v in _launches().items()}
    return Run(label, st, b, r, wall, used, ord)


def eps_tilde(ord, n) -> float:
    """The target ε̃ of a run: 1e-6 in l∞, and in l1 ε̃·n³, the l1 norm of a
    residual of ε̃ in every cell (at n = 185: 6.33; at n = 150: 3.375)."""
    return EPS_TILDE if ord == INF else EPS_TILDE * n ** 3


def solver_cells(st) -> list:
    """Phase 4's runs: ``(label, SolverConfig, ord)``."""
    from repro_torch.core import detection
    from repro_torch.solvers.fixed_point import SolverConfig

    n = SOLVER_N
    runs = [(m, "hybrid", True, INF) for m in ("sync", "pfait", "nfais2", "nfais5")]
    runs += [("pfait", "jacobi", True, INF), ("pfait", "hybrid", False, INF),
             ("pfait", "hybrid", True, 1.0)]
    cells = []
    for mode, sweep, fuse, ord in runs:
        mon = detection.for_mode(mode, eps_tilde=eps_tilde(ord, n), margin=10.0,
                                 staleness=0 if mode == "sync" else 4,
                                 persistence=4, ord=ord)
        cfg = SolverConfig(stencil=st, monitor=mon, inner_sweeps=2, max_outer=50_000,
                           sweep=sweep, use_kernel=True, fuse_residual=fuse)
        label = f"{mode}/{sweep}/{'fused' if fuse else 'unfused'}" + (" l1" if ord == 1 else "")
        cells.append((label, cfg, ord))
    return cells


def _stencil(n):
    from repro_torch.solvers.convdiff import Stencil

    return Stencil.for_contraction(n, nu=1.0, a=(1.0, 1.0, 1.0), rho=0.95)


def _rhs(n, dev):
    import torch

    from repro_torch.solvers.convdiff import make_rhs

    return torch.as_tensor(make_rhs(n, seed=0), device=dev)


def run_solver(dev) -> list:
    """Phase 4: ``solve_single`` at n = 185, f64, quickstart settings."""
    from repro_torch.solvers.fixed_point import solve_single

    st, b = _stencil(SOLVER_N), _rhs(SOLVER_N, dev)
    return [_run(label, lambda: solve_single(cfg, b, device=dev), st, b, ord)
            for label, cfg, ord in solver_cells(st)]


# the trace length of the 1-D p = 6 hetero Jacobi run, which the PageRank
# path runs again through ``runtime.api.run_shard`` with ``record_trace``
# (whose default length this is)
API_TRACE_LEN = 512
# heterogeneous per-shard knobs of the 6-shard runs, 1-D and mesh
MESH_KNOBS = dict(inner_sweeps=(1, 2, 1, 3, 1, 2), halo_delay=(0, 1, 0, 2, 0, 1),
                  contrib_lag=(0, 1, 0, 1, 0, 0))


def shard_cells() -> list:
    """Phase 5's runs: ``(name, p, ShardRuntimeConfig)``."""
    from repro_torch.core import detection
    from repro_torch.runtime import shard_runtime as sr

    mon = detection.for_mode("pfait", eps_tilde=EPS_TILDE, margin=10.0, ord=INF)
    mon1 = detection.for_mode("pfait", eps_tilde=eps_tilde(1.0, SHARD_N), margin=10.0,
                              ord=1.0)
    return [
        ("blocking/jacobi p=6", 6, sr.ShardRuntimeConfig(
            monitor=mon, reduction="blocking", max_outer=5000, trace_len=5000)),
        ("nonblocking/jacobi p=6 hetero", 6, sr.ShardRuntimeConfig(
            monitor=mon, reduction="nonblocking", max_outer=5000, trace_len=API_TRACE_LEN,
            **MESH_KNOBS)),
        ("nonblocking/hybrid p=6", 6, sr.ShardRuntimeConfig(
            monitor=mon, reduction="nonblocking", sweep="hybrid", max_outer=5000)),
        ("rdoubling/jacobi p=2", 2, sr.ShardRuntimeConfig(
            monitor=mon, reduction="rdoubling", max_outer=5000)),
        ("nonblocking/jacobi p=6 hetero l1", 6, sr.ShardRuntimeConfig(
            monitor=mon1, reduction="nonblocking", max_outer=5000, **MESH_KNOBS)),
    ]


def _run_cells(cells, dev) -> list:
    """Stacked runs of ``(name, p, ShardRuntimeConfig)`` cells at n = 150."""
    import torch

    from repro_torch.runtime import shard_runtime as sr

    n = SHARD_N
    st, b = _stencil(n), _rhs(n, dev)
    x0 = torch.zeros_like(b)
    return [_run(name, lambda: sr.make_convdiff_runtime(cfg, p, st, n, device=dev)(x0, b),
                 st, b, cfg.monitor.ord) for name, p, cfg in cells]


def run_shards(dev) -> list:
    """Phase 5: the stacked shard runtime at n = 150, f64, p = 6 (and p = 2)."""
    return _run_cells(shard_cells(), dev)


def mesh_cells() -> list:
    """Phase 6's runs: ``(name, mesh, ShardRuntimeConfig)``."""
    from repro_torch.core import detection
    from repro_torch.runtime import shard_runtime as sr

    mon = detection.for_mode("pfait", eps_tilde=EPS_TILDE, margin=10.0, ord=INF)
    mon1 = detection.for_mode("pfait", eps_tilde=eps_tilde(1.0, SHARD_N), margin=10.0,
                              ord=1.0)
    nfais2 = detection.for_mode("nfais2", eps_tilde=EPS_TILDE, margin=10.0, ord=INF)
    return [
        ("(a) mesh (3,2) blocking/jacobi", (3, 2), sr.ShardRuntimeConfig(
            monitor=mon, reduction="blocking", max_outer=5000, trace_len=5000)),
        ("(b) mesh (3,2) nonblocking/jacobi hetero", (3, 2), sr.ShardRuntimeConfig(
            monitor=mon, max_outer=5000, trace_len=5000, **MESH_KNOBS)),
        ("(b) mesh (3,2) nonblocking/jacobi hetero overlap", (3, 2), sr.ShardRuntimeConfig(
            monitor=mon, max_outer=5000, trace_len=5000, overlap=True, **MESH_KNOBS)),
        ("(c) mesh (2,2,2) nonblocking/hybrid delay", (2, 2, 2), sr.ShardRuntimeConfig(
            monitor=mon, sweep="hybrid", max_outer=5000,
            halo_delay=(0, 1, 0, 2, 0, 1, 0, 1))),
        ("(d) mesh (2,2,2) rdoubling/jacobi", (2, 2, 2), sr.ShardRuntimeConfig(
            monitor=mon, reduction="rdoubling", max_outer=5000)),
        ("(e) mesh (3,2) nfais2/jacobi", (3, 2), sr.ShardRuntimeConfig(
            monitor=nfais2, max_outer=5000)),
        ("(f) mesh (3,2) blocking/jacobi l1", (3, 2), sr.ShardRuntimeConfig(
            monitor=mon1, reduction="blocking", max_outer=5000, trace_len=5000)),
    ]


def run_mesh(dev) -> list:
    """Phase 6: the mesh shard runtime at n = 150, f64."""
    return _run_cells(mesh_cells(), dev)


def run_serve(dev) -> dict:
    """Phase 7: ``serve`` at full width on the card."""
    from repro_torch.launch.serve import serve

    return serve(SERVE_ARCH, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT,
                 max_new=SERVE_NEW, use_reduced=False, seed=0, device=dev)


def pagerank_cells() -> list:
    """Phase 8's runs: ``(name, RuntimeConfig)``."""
    from repro_torch.core import detection
    from repro_torch.runtime import api

    eps = PAGERANK_EPS
    sync = detection.MonitorConfig(mode="sync", eps=eps, staleness=0, ord=1.0)

    def mon(mode):
        return detection.for_mode(mode, eps_tilde=eps, margin=10.0, staleness=4,
                                  persistence=4, ord=1.0)

    return [
        ("(a) blocking/sync", api.RuntimeConfig(
            monitor=sync, reduction="blocking", max_outer=1000, record_trace=True)),
        ("(b) nonblocking/pfait K=4 hetero", api.RuntimeConfig(
            monitor=mon("pfait"), reduction="nonblocking", max_outer=1000,
            record_trace=True, **PAGERANK_KNOBS)),
        ("(c) rdoubling/pfait", api.RuntimeConfig(
            monitor=mon("pfait"), reduction="rdoubling", max_outer=1000, record_trace=True)),
        ("(d) nonblocking/nfais2", api.RuntimeConfig(
            monitor=mon("nfais2"), reduction="nonblocking", max_outer=1000,
            record_trace=True)),
    ]


class PageRankRun(NamedTuple):
    """One PageRank run through ``runtime.api.run_shard``: its report and
    the kernel launches of its two runs (build and timed)."""

    name: str
    rep: object
    cfg: object
    used: dict


def run_pagerank(dev) -> dict:
    """Phase 8: PageRank at n = 16384, p = 4, f64, l1, through
    ``runtime.api.run_shard`` (the operator placed on the card once), and
    the 1-D p = 6 hetero Jacobi case of phase 5 through the same API."""
    import torch

    from repro_torch.core import detection
    from repro_torch.runtime import api
    from repro_torch.solvers.convdiff import Stencil, make_rhs
    from repro_torch.solvers.pagerank import PageRankProblem

    n, p, eps = PAGERANK_N, PAGERANK_P, PAGERANK_EPS
    t0 = time.perf_counter()
    prob = PageRankProblem(n=n, p=p, seed=0)
    t1 = time.perf_counter()
    P_host = prob.to_dense()
    t2 = time.perf_counter()
    P = torch.as_tensor(P_host, device=dev)
    torch.cuda.synchronize()
    _PAGERANK_HOST.update(prob=prob, P_host=P_host)   # phase 13 runs it again
    print(f"pagerank n = {n}, p = {p}, seed 0: graph draw {t1 - t0:.2f} s, to_dense "
          f"{t2 - t1:.2f} s, placed on the card in {time.perf_counter() - t2:.2f} s "
          f"({P_host.nbytes / 2**30:.1f} GiB f64)")
    x0 = torch.full((n,), 1.0 / n, dtype=torch.float64, device=dev)
    cells = pagerank_cells()
    runs = []
    for name, cfg in cells:
        before = _launches()
        rep = api.run_shard("pagerank", cfg, p, n, x0, P, damping=prob.d, device=dev)
        runs.append(PageRankRun(name, rep, cfg,
                                {k: v - before[k] for k, v in _launches().items()}))
    # phase 5's 1-D p = 6 hetero Jacobi case, through the API
    cn = SHARD_N
    st = Stencil.for_contraction(cn, nu=1.0, a=(1.0, 1.0, 1.0), rho=0.95)
    b = torch.as_tensor(make_rhs(cn, seed=0), device=dev)
    cmon = detection.for_mode("pfait", eps_tilde=EPS_TILDE, margin=10.0, ord=INF)
    ccfg = api.RuntimeConfig(monitor=cmon, reduction="nonblocking", max_outer=5000,
                             record_trace=True, **MESH_KNOBS)
    convdiff = api.run_shard("convdiff", ccfg, 6, cn, torch.zeros_like(b), b, stencil=st,
                             device=dev)
    return dict(prob=prob, P_host=P_host, P=P, runs=runs, convdiff=convdiff)


def verify_pagerank(out, shard_runs) -> None:
    """Every PageRank run converged with r* < ε̃ (l1, f64 on the card, equal
    to the host's ``PageRankProblem.exact_residual`` up to the f64 rounding
    of the residual), run (a) follows the synchronous reference trajectory
    and its detection is consistent with its exact trace; the convdiff API
    run is bitwise phase 5's run; every recorded trace validates.  Prints
    ms per step beside the step's matvec bound."""
    import numpy as np
    import torch

    from repro_torch.core import termination
    from repro_torch.core.trace import validate_trace
    from repro_torch.runtime import shard_runtime as sr

    prob, P, eps = out["prob"], out["P"], PAGERANK_EPS
    n, p, d, v = prob.n, prob.p, prob.d, prob.v
    nb = n // p
    for run in out["runs"]:
        rep = run.rep
        x = rep.x
        r_card = float((d * (P @ x) + v - x).abs().sum())
        scale = float((d * (P @ x.abs()) + v + x.abs()).sum())
        r_host = prob.exact_residual([x.cpu().numpy()])
        bar = 4 * F64_UNIT * scale
        scfg = run.cfg.to_shard_config()
        inner = float(np.broadcast_to(scfg.inner_sweeps, (p,)).sum())
        # rows of P swept a step: every shard's inner sweeps, the blocking
        # exact pass, and NFAIS2's exact verifications spread over the run
        passes = inner / p + (scfg.reduction == "blocking") + \
            rep.raw.verifications / max(rep.outer_iters, 1)
        bound_ms = 1e3 * passes * 8 * n * n / HBM_BYTES_PER_S
        step_ms = 1e3 * dict(rep.wall_segments)["run"] / rep.outer_iters
        print(f"pagerank {run.name}: converged={rep.converged} outer={rep.outer_iters} "
              f"verifications={rep.raw.verifications} detected={rep.detected_residual:.3e} "
              f"exact r* card {r_card:.6e} host {r_host:.6e} (|Δ| {abs(r_card - r_host):.2e}, "
              f"rel {abs(r_card - r_host) / r_host:.2e}; bar 4u·Σ(d·P|x| + v + |x|) = "
              f"{bar:.2e}; l1, ε̃ {eps:g}); {step_ms:.4f} ms/step against a matvec bound "
              f"of {bound_ms:.4f} ms ({passes:g} passes over {8 * n * n / 2**30:.0f} GiB a "
              f"step; {bound_ms / step_ms:.1%}); wall build {dict(rep.wall_segments)['build']:.3f}"
              f" s, run {dict(rep.wall_segments)['run']:.3f} s; launches {json.dumps(run.used)}")
        _require(rep.converged, f"pagerank {run.name}: did not converge")
        _require(r_host < eps and r_card < eps,
                 f"pagerank {run.name}: false detection, r* {r_host:.3e} >= ε̃")
        _require(abs(r_card - r_host) <= bar, f"pagerank {run.name}: r* on the card "
                 f"{r_card:.6e} departs from the host's {r_host:.6e}")
        _require(validate_trace(rep.trace), f"pagerank {run.name}: trace fails validate()")
    # where a step's time goes: one shard's sweep matvec alone, and the
    # device's busy share over a blocking and a heterogeneous run
    x = torch.full((n,), 1.0 / n, dtype=P.dtype, device=P.device)
    mv_ms, mv_call_ms = _time_ms(lambda: P[:nb] @ x)
    print(f"time torch.mv (cuBLAS) at {nb}x{n} f64, one shard's sweep matvec: {mv_ms:.4f} ms "
          f"(eager call {mv_call_ms:.4f} ms), bound {1e3 * 8 * nb * n / HBM_BYTES_PER_S:.4f} ms "
          f"(bytes)")
    for run in out["runs"][:2]:
        rerun = sr.make_runtime("pagerank", run.cfg.to_shard_config(), p, n, damping=d,
                                device=P.device)
        profile_window(f"pagerank {run.name}, one run of {run.rep.outer_iters} steps",
                       lambda: rerun(x, P))
    a = out["runs"][0].rep
    T = a.outer_iters
    ref = sr.pagerank_reference_trace(P, n, T, damping=d, ord=1.0).double()
    got = a.raw.trace[:T].double()
    err = float(((got - ref).abs() / ref.abs()).max())
    trace = a.raw.trace[:T].tolist()
    consistent = termination.detection_consistent(a.detect_step, trace, eps)
    print(f"pagerank (a): trace vs synchronous reference over {T} steps, max rel {err:.3e} "
          f"(tolerance 5e-5); oracle step {termination.oracle_detect_step(trace, eps)}, "
          f"detected at {a.detect_step}, consistent: {consistent}")
    _require(err <= 5e-5, f"pagerank (a): trace departs from the reference ({err:.3e})")
    _require(consistent, "pagerank (a): detection inconsistent with its exact trace")
    del ref, got
    c, c0 = out["convdiff"], shard_runs[1].r
    same = (c.outer_iters == c0.outer_iters and torch.equal(c.x, c0.x)
            and torch.equal(c.raw.trace, c0.trace))
    print(f"convdiff through run_shard, 1-D p = 6 hetero Jacobi: outer {c.outer_iters} / "
          f"{c0.outer_iters}, x and trace bitwise phase 5's: {same}; wall build "
          f"{dict(c.wall_segments)['build']:.3f} s, run {dict(c.wall_segments)['run']:.3f} s "
          f"({1e3 * dict(c.wall_segments)['run'] / c.outer_iters:.3f} ms/step)")
    _require(same, "convdiff run_shard is not bitwise phase 5's make_convdiff_runtime run")
    _require(validate_trace(c.trace), "convdiff run_shard: trace fails validate()")
    del out["P"], P
    torch.cuda.empty_cache()


# the distributed path: the stacked runs that each world repeats one shard
# per rank, by name (phases 5, 6 and 8), and the runs this phase adds
DIST_SHARD_RUNS = ("blocking/jacobi p=6", "nonblocking/jacobi p=6 hetero",
                   "nonblocking/hybrid p=6", "nonblocking/jacobi p=6 hetero l1")
DIST_MESH_RUNS = ("(a) mesh (3,2) blocking/jacobi", "(b) mesh (3,2) nonblocking/jacobi hetero",
                  "(b) mesh (3,2) nonblocking/jacobi hetero overlap",
                  "(e) mesh (3,2) nfais2/jacobi")
DIST_SOLVER_RUN = "pfait/hybrid/fused"     # phase 4's, again on a (1, 1) NCCL group
DIST_N4 = 152                              # 1-D p = 4 needs 4 | n
DIST_KERNELS = ("fused_sweep_residual", "fused_rbgs_sweep_residual",
                "fused_sweep_residual_halo", "fused_rbgs_sweep_residual_halo",
                "diff_norm_partials")


class DistRun(NamedTuple):
    """The distributed path: per world its ranks' reports and wall, the
    stacked twins this phase ran itself, and the launches made inside the
    worlds (every rank, every case), also by (stencil kernel, block shape)."""

    worlds: dict
    twins: list
    world_launches: dict
    world_shapes: Counter


def dist_cells():
    """``(stacked twins to run here, worlds)``: a twin is ``(name, p,
    ShardRuntimeConfig or SolverConfig, n)``; a world is ``(label, k,
    backend, [Case])``, each case named after its stacked twin."""
    import dataclasses as dc

    from repro_torch.core import detection
    from repro_torch.launch.worlds import Case, Inputs
    from repro_torch.runtime import shard_runtime as sr

    cd, cd4 = Inputs("convdiff", SHARD_N, rho=0.95), Inputs("convdiff", DIST_N4, rho=0.95)
    mon = detection.for_mode("pfait", eps_tilde=EPS_TILDE, margin=10.0, ord=INF)
    st = _stencil(SHARD_N)
    solver = dict((label, cfg) for label, cfg, _ in solver_cells(_stencil(SOLVER_N)))
    hybrid = dc.replace(solver[DIST_SOLVER_RUN], stencil=st)
    twins = [
        ("(g) mesh (3,2) nonblocking/hybrid hetero", (3, 2), sr.ShardRuntimeConfig(
            monitor=mon, sweep="hybrid", max_outer=5000, trace_len=5000, **MESH_KNOBS),
         SHARD_N),
        ("make_sharded_solver (3,2) hybrid fused", (3, 2), hybrid, SHARD_N),
        ("rdoubling/jacobi p=4 n=152", 4, sr.ShardRuntimeConfig(
            monitor=mon, reduction="rdoubling", max_outer=5000, trace_len=5000), DIST_N4),
        ("nonblocking/jacobi p=1", 1, sr.ShardRuntimeConfig(
            monitor=mon, max_outer=5000, trace_len=5000), SHARD_N),
    ]
    own = {name: (p, cfg) for name, p, cfg, _ in twins}
    shard = {name: (p, cfg) for name, p, cfg in shard_cells() + mesh_cells()}
    six = [Case(name, "runtime", shard[name][1], _shape(shard[name][0]), cd)
           for name in DIST_SHARD_RUNS + DIST_MESH_RUNS]
    six += [Case(twins[0][0], "runtime", twins[0][2], (3, 2), cd),
            Case(twins[1][0], "solver", hybrid, (3, 2), cd)]
    four = [Case(name, "api", cfg, (PAGERANK_P,),
                 Inputs("pagerank", PAGERANK_N, p=PAGERANK_P))
            for name, cfg in pagerank_cells()]
    four.append(Case(twins[2][0], "runtime", own[twins[2][0]][1], (4,), cd4))
    one = [Case(twins[3][0], "runtime", own[twins[3][0]][1], (1,), cd),
           Case(DIST_SOLVER_RUN, "solver", solver[DIST_SOLVER_RUN], (1, 1),
                Inputs("convdiff", SOLVER_N, rho=0.95))]
    worlds = [("gloo x6", 6, "gloo", six), ("gloo x4", 4, "gloo", four),
              ("nccl x1", 1, "nccl", one)]
    return twins, worlds


def _shape(p):
    return tuple(p) if isinstance(p, tuple) else (p,)


def run_distributed(dev) -> DistRun:
    """Phase 9: one shard per process over ``torch.distributed``, in spawned
    worlds on the one card (gloo ranks share ``cuda:0`` and stage through
    host memory; NCCL at world size 1), each run held later to its stacked
    twin.  The twins this phase adds run here first, stacked."""
    import tempfile

    import torch

    from repro_torch.launch.mesh import spawn_world
    from repro_torch.launch.worlds import run_cases
    from repro_torch.runtime import shard_runtime as sr
    from repro_torch.solvers.fixed_point import SolverConfig, make_sharded_solver

    twin_cells, worlds = dist_cells()
    twins = []
    for name, p, cfg, n in twin_cells:
        st, b = _stencil(n), _rhs(n, dev)
        x0 = torch.zeros_like(b)
        if isinstance(cfg, SolverConfig):
            fn = lambda: make_sharded_solver(cfg, p, device=dev)(x0, b)  # noqa: E731
        else:
            fn = lambda: sr.make_convdiff_runtime(cfg, p, st, n, device=dev)(x0, b)  # noqa: E731
        twins.append(_run(name, fn, st, b, cfg.monitor.ord))
    out, inside, shapes = {}, Counter(), Counter()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as store:
        for label, k, backend, cases in worlds:
            t0 = time.perf_counter()
            ranks = spawn_world(run_cases, k, store, args=(backend, cases, None),
                                timeout=600)
            out[label] = dict(ranks=ranks, cases=cases, wall=time.perf_counter() - t0,
                              k=k, backend=backend)
            for r in ranks:
                for c in r["cases"]:
                    inside.update(c["launches"])
                    shapes.update(c["launch_shapes"])
    return DistRun(out, twins, dict(inside), shapes)


def verify_distributed(dist_run: DistRun, runs: dict, card: str) -> None:
    """Every distributed run equals its stacked twin (same iterations,
    detection and verifications, ``x`` bitwise, the trace bitwise at l∞
    and within p·2^-24 relative at l1/l2, since the group sums the lanes in
    another order), every rank reports the same outcome, and the ms per
    step and host-staged bytes per step are printed beside the twin's."""
    import numpy as np

    twin = {run.name: (run.r, run.wall, run.ord) for run in
            runs["solve_single"] + runs["1-D shard runtime"] + runs["mesh shard runtime"]
            + dist_run.twins}
    for run in runs["pagerank shard runtime"]["runs"]:
        twin[run.name] = (run.rep.raw, dict(run.rep.wall_segments)["run"], 1.0)
    print(f"distributed path on {card}: ranks that share one card time the transport's "
          "host cost (gloo stages every face and lane through host memory), not a "
          "multi-GPU run")
    for label, w in dist_run.worlds.items():
        print(f"world {label} ({w['backend']}, {w['k']} ranks): {w['wall']:.1f} s, spawn "
              "and every rank's inputs included")
        for i, case in enumerate(w["cases"]):
            got = [r["cases"][i] for r in w["ranks"]]
            g = got[0]
            want, wall, ord_ = twin[case.name]
            tag = f"{label} {case.name}"
            _require(g["name"] == case.name and g["converged"], f"{tag}: did not converge")
            for c in got[1:]:
                _require(all(c[key] == g[key] for key in (
                    "outer_iters", "converged", "residual", "verifications", "x_digest"))
                    and (g["trace"] is None or np.array_equal(c["trace"], g["trace"])),
                    f"{tag}: rank {c['rank']} disagrees with rank 0")
            same = (g["outer_iters"] == want.outer_iters
                    and g["converged"] == bool(want.converged)
                    and g["verifications"] == int(getattr(want, "verifications", 0))
                    and np.array_equal(g["x"], want.x.cpu().numpy()))
            gap, bar = 0.0, w["k"] * 2.0 ** -24
            if g["trace"] is not None:
                t, ref = g["trace"], want.trace.cpu().numpy()
                fin = np.isfinite(ref)
                same = same and np.array_equal(np.isfinite(t), fin)
                gap = float(np.max(np.abs(t[fin] - ref[fin]) / np.abs(ref[fin]), initial=0.0))
            rgap = abs(g["residual"] - float(want.residual)) / abs(float(want.residual))
            gap = max(gap, rgap)
            ok = same and (gap == 0.0 if ord_ == INF else gap <= bar)
            steps = max(g["outer_iters"], 1)
            per_step = steps * g["runs"] * len(got)   # per rank and step
            staged = sum(c["staged_bytes"] for c in got) / (steps * g["runs"])
            staged_ms = 1e3 * sum(c["staged_s"] for c in got) / per_step
            wait_ms = 1e3 * sum(c["wait_s"] for c in got) / per_step
            print(f"  {case.name}: outer {g['outer_iters']} / stacked {want.outer_iters}, "
                  f"verifications {g['verifications']}, x bitwise and iterations equal: "
                  f"{same}; trace and residual {_ord_tag(ord_)}: largest relative gap "
                  f"{gap:.3e} (bar {'0' if ord_ == INF else f'{bar:.3e}'}); "
                  f"{1e3 * g['wall_s'] / steps:.4f} ms/step against stacked "
                  f"{1e3 * wall / max(want.outer_iters, 1):.4f}; host-staged "
                  f"{staged:.0f} B/step (all ranks); a rank's step: staging "
                  f"{staged_ms:.4f} ms (its stream synchronisations included), blocked "
                  f"in transfers {wait_ms:.4f} ms (mean over ranks); ranks agree")
            _require(ok, f"{tag}: departs from its stacked twin")
    print(f"main-path launches inside the worlds: {json.dumps(dist_run.world_launches)}")


# ---------------------------------------------------------------------------
# phase 11: the detection service
# ---------------------------------------------------------------------------


def service_requests() -> list:
    """The phase's open-loop load, drawn as ``bench_serve.poisson_requests``
    draws it: Poisson arrivals (exponential inter-arrivals floored to
    ticks), families round-robin, seeded modes, seeds, ε̃, K and m; each
    family's tenants alternate over its variants."""
    import numpy as np

    from repro_torch.launch.serve import TenantSpec

    rng = np.random.default_rng(SERVICE_SEED)
    arrivals = np.floor(np.cumsum(rng.exponential(1.0 / SERVICE_RATE, SERVICE_TENANTS)))
    reqs = []
    for i in range(SERVICE_TENANTS):
        family, variants, grid = SERVICE_FAMILIES[i % len(SERVICE_FAMILIES)]
        mode = SERVICE_MODES[int(rng.integers(0, len(SERVICE_MODES)))]
        spec = TenantSpec(
            tenant=f"t{i:04d}", family=family,
            problem=variants[(i // len(SERVICE_FAMILIES)) % len(variants)],
            seed=int(rng.integers(0, 8)),
            eps_tilde=float(grid[int(rng.integers(0, len(grid)))]),
            mode=mode, staleness=int(rng.integers(0, 5)),
            persistence=int(rng.choice((2, 4))))
        reqs.append((spec, int(arrivals[i])))
    return reqs


class ServiceRun(NamedTuple):
    """The service path's run: its report and requests, the wall time of
    ``serve_detection`` (problem construction included), where the ticks'
    wall went (``DetectionService.wall_breakdown``), and over the profiled
    window of ticks their wall time, the device time of kernels and of
    copies the profiler saw, and the top rows."""

    rep: object
    reqs: list
    wall: float
    breakdown: dict
    window_s: float
    kernel_s: float
    copy_s: float
    top: list


def run_service(dev) -> ServiceRun:
    """Phase 11: the load through ``serve_detection`` on the card, with
    ``torch.profiler`` active over ``SERVICE_PROFILE`` ticks (it reads the
    device's busy share over them; a window, since a kernel a monitor
    operation makes the whole run's trace slow to read)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch.launch.serve import ServeConfig, serve_detection

    reqs = service_requests()
    start, ticks = SERVICE_PROFILE
    walls, service, stepping = [], [], [0.0]

    def on_tick(svc):
        walls.append(svc.wall_s)
        service[:] = [svc]
        t0 = time.perf_counter()
        prof.step()
        stepping[0] += time.perf_counter() - t0

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=start - 1, warmup=1, active=ticks, repeat=1)) as prof:
        t0 = time.perf_counter()
        rep = serve_detection(reqs, ServeConfig(**SERVICE_CFG), device=dev, on_tick=on_tick)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device rows only; the schedule's step annotations repeat their kernels
    rows = sorted(((getattr(e, "device_time_total", 0.0), e.count, e.key)
                   for e in prof.key_averages()
                   if getattr(e, "device_type", None) == DeviceType.CUDA
                   and not e.key.startswith("ProfilerStep")), reverse=True)
    copies = sum(r[0] for r in rows if r[2].startswith(("Memcpy", "Memset"))) / 1e6
    window = walls[start + ticks - 1] - walls[start - 1]
    breakdown = {**service[0].wall_breakdown(), "profiler steps": stepping[0]}
    return ServiceRun(rep, reqs, wall, breakdown, window,
                      sum(r[0] for r in rows) / 1e6 - copies, copies, rows[:8])


def _service_ord(family) -> float:
    return INF if family == "convdiff" else (1.0 if family == "pagerank" else 2.0)


def _lane_buffers(probs, dev):
    """Stacked lane buffers of ``probs`` (X, operands) on ``dev``."""
    import numpy as np
    import torch

    X = torch.as_tensor(np.stack([p.lane_x0() for p in probs]), device=dev)
    ops = {k: torch.as_tensor(np.stack([np.asarray(p.lane_operands()[k], np.float32)
                                        for p in probs]), device=dev)
           for k in probs[0].lane_operands()}
    return X, ops


def _exact_sigma(prob, x) -> float:
    """The σ-applied residual of one f32 lane state ``x`` in f64 on the
    host: PageRank's and mlfixed's ``exact_residual``, and for convdiff the
    plain sweep's input-state residual in f64."""
    import torch

    from repro_torch.launch.serve import _sigma_np
    from repro_torch.solvers.convdiff import ConvDiffProblem

    x = x.detach().to("cpu", torch.float64)
    if not isinstance(prob, ConvDiffProblem):
        return float(prob.exact_residual([x.numpy()]))
    _, c = prob.update_with_residual_batched(x[None])
    return float(_sigma_np(c.numpy(), float(prob.ord))[0])


def service_floors(dev) -> dict:
    """Each family's residual floor on the card: every variant at the
    phase's size runs ``FLOOR_STEPS`` lane steps from its lane x0 (seeds
    ``FLOOR_SEEDS``, no detection: ε = −1).  The f32 floor is the largest σ
    value over the last quarter of the steps, where the residual has
    stopped falling; the f64 floor is the largest f64 residual of the final
    f32 states (``_exact_sigma``), which the f32 series cannot see below
    its own rounding.  Returns ``{family: (f32 floor, f64 floor, [first σ
    values])}``."""
    import torch

    from repro_torch.core import detection
    from repro_torch.launch.serve import _sigma_np, make_serve_problem

    out = {}
    for family, variants, _ in SERVICE_FAMILIES:
        floor, exact, first = 0.0, 0.0, []
        for kw in variants:
            probs = [make_serve_problem(family, seed=s, **kw) for s in FLOOR_SEEDS]
            X, ops = _lane_buffers(probs, dev)
            L, p0 = len(probs), probs[0]
            state = detection.init_lanes(L, 1, dev)
            eps = torch.full((L,), -1.0, device=dev)
            K = torch.zeros(L, dtype=torch.int32, device=dev)
            m = torch.ones(L, dtype=torch.int32, device=dev)
            run = detection.make_lane_runner(
                "pfait", lambda Xc, o, p0=p0: p0.update_with_residual_batched(Xc, **o),
                SERVICE_CFG["chunk"], ord=float(p0.ord))
            cs = [run(X, ops, state, eps, eps, K, m)[2].clone()
                  for _ in range(FLOOR_STEPS // SERVICE_CFG["chunk"])]
            ser = _sigma_np(torch.cat(cs, dim=1).cpu().numpy(), float(p0.ord))
            floor = max(floor, float(ser[:, 3 * FLOOR_STEPS // 4:].max()))
            exact = max(exact, *(_exact_sigma(p, X[i]) for i, p in enumerate(probs)))
            first += ser[:, 0].tolist()
            del X, ops, run, cs
        out[family] = (floor, exact, first)
    torch.cuda.empty_cache()
    return out


def check_exact_at_detection(rep, specs, dev) -> None:
    """One served tenant per family at the family's least ε̃ in the load
    (the one with the fewest steps), replayed alone on the card to its
    detect step k: the f64 residual of its state there (``_exact_sigma`` of
    X_k, the state whose residual check k recorded) must pass the service's
    oracle rule, below ``oracle_factor`` × ε̃, as its f32 series did."""
    import numpy as np
    import torch

    from repro_torch.launch.serve import ServeConfig, _sigma_np, make_serve_problem

    factor = ServeConfig(**SERVICE_CFG).oracle_factor
    for family, _, _ in SERVICE_FAMILIES:
        ts = [t for t in rep.tenants if t.family == family and t.status == "served"]
        least = min(t.eps_tilde for t in ts)
        t = min((t for t in ts if t.eps_tilde == least), key=lambda t: (t.steps, t.tenant))
        spec = specs[t.tenant]
        prob = make_serve_problem(family, seed=spec.seed, **dict(spec.problem))
        X = torch.as_tensor(prob.lane_x0()[None], device=dev)
        ops = {k: torch.as_tensor(np.asarray(v, np.float32)[None], device=dev)
               for k, v in prob.lane_operands().items()}
        for _ in range(t.detect_step):
            X, _ = prob.update_with_residual_batched(X, **ops)
        exact = _exact_sigma(prob, X[0])
        f32 = float(_sigma_np(t.series, float(prob.ord))[t.detect_step])
        print(f"service {family} {t.tenant} ({t.mode}, K {_lane_K(spec)}, ε̃ {t.eps_tilde:g}, "
              f"the load's least): at its detect step {t.detect_step} the f64 residual "
              f"{exact:.3e} = {exact / t.eps_tilde:.3f} ε̃ (its f32 series {f32:.3e}); "
              f"below {factor:g} ε̃: {exact < factor * t.eps_tilde}")
        _require(exact < factor * t.eps_tilde,
                 f"service {family} {t.tenant}: its f64 residual at detection fails the "
                 f"oracle rule")


def _lane_K(spec) -> int:
    return 0 if spec.mode == "sync" else int(spec.staleness)


def _thresholds(t) -> set:
    import numpy as np

    from repro_torch.core import detection

    return {float(np.float32(detection.for_mode(t.mode, t.eps_tilde).eps)),
            float(np.float32(t.eps_tilde))}


def check_service_verdicts(rep, specs, dev) -> int:
    """Every served tenant's (detect step, detected residual) is bitwise
    what ``detection.batched_monitor`` gives on the card on its recorded
    series: one grid per (mode, norm), the tenants' series as its seeds
    (padded with +inf after their end: a verdict, once fired, stays)."""
    import numpy as np
    import torch

    from repro_torch.core import detection

    groups = {}
    for t in rep.tenants:
        groups.setdefault((t.mode, _service_ord(t.family)), []).append(t)
    for (mode, ord_), ts in groups.items():
        T = max(len(t.series) for t in ts)
        cs = np.full((len(ts), T), np.inf, np.float32)
        for i, t in enumerate(ts):
            cs[i, :len(t.series)] = t.series
        pairs = sorted({(detection.for_mode(mode, t.eps_tilde).eps, t.eps_tilde) for t in ts})
        Ks = sorted({_lane_K(specs[t.tenant]) for t in ts})
        Ms = sorted({specs[t.tenant].persistence for t in ts})
        v = detection.batched_monitor(mode, torch.as_tensor(cs, device=dev),
                                      [e for e, _ in pairs], Ks, Ms, ord=ord_,
                                      eps_tilde=[e for _, e in pairs])
        for i, t in enumerate(ts):
            cell = (i, pairs.index((detection.for_mode(mode, t.eps_tilde).eps, t.eps_tilde)),
                    Ks.index(_lane_K(specs[t.tenant])), Ms.index(specs[t.tenant].persistence))
            got = np.float32(v.detected_residual[cell].item())
            _require(bool(v.converged[cell]) and int(v.detect_step[cell]) == t.detect_step
                     and got.tobytes() == np.float32(t.detected_residual).tobytes(),
                     f"service {t.tenant}: the packed verdict ({t.detect_step}, "
                     f"{t.detected_residual!r}) is not batched_monitor's on the card "
                     f"({int(v.detect_step[cell])}, {float(got)!r})")
    return len(groups)


def check_replay_vs_eager(dev) -> None:
    """One chunk of a two-lane bucket per family, replayed from its CUDA
    graph, is bitwise the same chunk run eagerly on a copy of its buffers;
    then lane 1 is refilled in place (another seed) in both, a second chunk
    runs, and again the two agree bitwise, with lane 0 carried through the
    refill bitwise."""
    import numpy as np
    import torch

    from repro_torch.core import detection
    from repro_torch.launch.serve import make_serve_problem

    chunk, ring = SERVICE_CFG["chunk"], SERVICE_CFG["max_staleness"] + 1
    for family, variants, grid in SERVICE_FAMILIES:
        kw = variants[-1]
        probs = [make_serve_problem(family, seed=s, **kw) for s in (0, 1, 2)]
        p0 = probs[0]

        def step(Xc, o, p0=p0):
            return p0.update_with_residual_batched(Xc, **o)

        X, ops = _lane_buffers(probs[:2], dev)
        state = detection.init_lanes(2, ring, dev)
        X2, ops2 = X.clone(), {k: v.clone() for k, v in ops.items()}
        state2 = detection.LaneState(*(t.clone() for t in state))
        f32 = dict(dtype=torch.float32, device=dev)
        eps = torch.tensor([grid[0] / 10, grid[-1]], **f32)
        epst = torch.tensor([grid[0], grid[-1]], **f32)
        K = torch.tensor([2, 0], dtype=torch.int32, device=dev)
        m = torch.tensor([2, 4], dtype=torch.int32, device=dev)
        run = detection.make_lane_runner("nfais5", step, chunk, ord=float(p0.ord))
        same = []
        for r in range(2):
            cg = run(X, ops, state, eps, epst, K, m)[2]
            ce = run.run_eager(X2, ops2, state2, eps, epst, K, m)[2]
            same.append(torch.equal(cg, ce) and torch.equal(X, X2)
                        and all(torch.equal(a, b) for a, b in zip(state, state2)))
            if r == 0:
                lane0 = (X[0].clone(), [t[0].clone() for t in state])
                for XX, OO, SS in ((X, ops, state), (X2, ops2, state2)):
                    XX[1].copy_(torch.as_tensor(probs[2].lane_x0()))
                    for k, v in probs[2].lane_operands().items():
                        OO[k][1].copy_(torch.as_tensor(np.asarray(v, np.float32)))
                    for dst, src in zip(SS, detection.reset_lanes(SS, [False, True])):
                        dst.copy_(src)
                same.append(torch.equal(X[0], lane0[0])
                            and all(torch.equal(t[0], v) for t, v in zip(state, lane0[1])))
        print(f"service {family} {kw}: a chunk replayed from its CUDA graph vs run eagerly, "
              f"twice with lane 1 refilled in place between: bitwise {all(same)}")
        _require(all(same), f"service {family}: graph replay is not bitwise the eager chunk")
        del X, ops, X2, ops2, run
    torch.cuda.empty_cache()


def check_cpu_rerun(rep, specs, floors) -> None:
    """One tenant per family, rerun alone through ``serve_detection`` on the
    CPU (the plain versions): the same status and detect step, and the
    series within ``SERVICE_RTOL`` plus twice the family's f32 floor and
    four f32 units of the tenant's first residual.  The tenant is the one
    with the fewest steps whose thresholds sit further from its series, at
    every check up to its detection, than that bar: for it, equal verdicts
    are what the precision predicts."""
    import numpy as np

    from repro_torch.launch.serve import ServeConfig, _sigma_np, serve_detection

    for family, _, _ in SERVICE_FAMILIES:
        rtol, ord_ = SERVICE_RTOL[family], _service_ord(family)

        def bar(t, sig):
            return rtol * np.abs(sig) + 2 * floors[family][0] + 4 * 2.0 ** -24 * sig[0]

        def clear(t):
            sig = _sigma_np(t.series, ord_)
            end = t.detect_step + 1
            return all(np.all(np.abs(sig[:end] - thr) > bar(t, sig)[:end])
                       for thr in _thresholds(t))

        cands = sorted((t for t in rep.tenants if t.family == family and clear(t)),
                       key=lambda t: (t.steps, t.tenant))
        _require(bool(cands), f"service {family}: no tenant keeps its thresholds clear of "
                              f"the rounding bar")
        t = cands[0]
        t0 = time.perf_counter()
        (c,) = serve_detection([(specs[t.tenant], 0)], ServeConfig(**SERVICE_CFG),
                               device="cpu").tenants
        cpu_s = time.perf_counter() - t0
        card, cpu = _sigma_np(t.series, ord_), _sigma_np(c.series, ord_)
        ok_len = len(card) == len(cpu)
        gap = np.abs(card - cpu) if ok_len else np.array([np.inf])
        within = ok_len and bool(np.all(gap <= bar(t, cpu)))
        rel = float(np.max(gap / np.abs(cpu))) if ok_len else float("inf")
        print(f"service {family} {t.tenant} ({t.mode}, ε̃ {t.eps_tilde:g}, "
              f"{len(cands)} of its tenants clear of the bar) rerun on the CPU in "
              f"{cpu_s:.1f} s: status {c.status} / card {t.status}, detect step "
              f"{c.detect_step} / {t.detect_step}; series max|Δ| {gap.max():.3e}, max rel "
              f"{rel:.3e}, within rtol {rtol:g} + 2·floor + 4·2^-24·r0: {within}")
        _require(c.status == t.status and c.detect_step == t.detect_step,
                 f"service {family} {t.tenant}: the CPU rerun's verdict differs from the card's")
        _require(within, f"service {family} {t.tenant}: the CPU series departs from the card's")


def check_service_launches(rep, specs, used) -> dict:
    """The launches the path counted are the ones its chunks made: per
    bucket, one warm-up step before its capture plus ``chunk`` steps for
    each tick it was busy (a tenant occupies its lane from its admit tick to
    the tick before its done tick), times each step's launches (a stencil
    kernel per lane for convdiff, one #5 launch for a PageRank bucket)."""
    busy, per_step = {}, {}
    lanes = SERVICE_CFG["lanes"]
    for t in rep.tenants:
        busy.setdefault(t.signature, set()).update(range(t.admit_tick, t.done_tick))
        spec = specs[t.tenant]
        if t.family == "convdiff":
            k = ("fused_sweep_residual" if spec.problem["sweep"] == "jacobi"
                 else "fused_rbgs_sweep_residual")
            per_step[t.signature] = (k, lanes)
        elif t.family == "pagerank":
            per_step[t.signature] = ("diff_norm_partials", 1)
    want = dict.fromkeys(SERVICE_KERNELS, 0)
    for sig, (k, n) in per_step.items():
        want[k] += n * (1 + SERVICE_CFG["chunk"] * len(busy[sig]))
    got = {k: used[k] for k in SERVICE_KERNELS}
    print(f"service launches: counted {json.dumps(got)}, from the buckets' busy ticks "
          f"{json.dumps(want)}")
    _require(got == want, "service: the launch counters do not count the graph replays")
    return want


def verify_service(run: ServiceRun, used: dict, dev) -> None:
    """Phase 11's checks and numbers (see the module docstring)."""
    from repro_torch.launch.serve import ServeConfig, signature_key, signature_of

    rep, cfg = run.rep, ServeConfig(**SERVICE_CFG)
    specs = {spec.tenant: spec for spec, _ in run.reqs}
    sigs = {signature_key(signature_of(spec, cfg)) for spec in specs.values()}
    modes = {spec.mode for spec in specs.values()}
    first = {}
    for t in rep.tenants:
        first[t.signature] = min(first.get(t.signature, t.admit_tick), t.admit_tick)
    cold = sum(t.admit_tick == first[t.signature] for t in rep.tenants)
    tp = rep.throughput
    print(f"service: {len(specs)} tenants ({', '.join(sorted(modes))}), {rep.served} served, "
          f"{rep.rejected} rejected, {rep.shed} shed, {rep.timeouts} timeouts, "
          f"{rep.false_detections} false detections (oracle-scored); {rep.ticks} ticks; "
          f"ttd ticks {rep.ttd_ticks}, queue-wait ticks {rep.queue_wait_ticks}; "
          f"{tp['tenants_per_s']:.3f} tenants/s over {rep.wall_s:.3f} s of ticks "
          f"({tp['ms_per_tick']:.3f} ms per tick); lane-steps/s "
          + ", ".join(f"{f} {tp['lane_steps_per_s/' + f]:.1f}" for f, _, _ in SERVICE_FAMILIES)
          + f"; serve_detection {run.wall:.2f} s with problem construction; compile_count "
          f"{rep.compile_count} for {len(sigs)} signatures, warm hits {rep.warm_hits} "
          f"(tenants − compile_count {len(specs) - rep.compile_count}; admitted at a bucket's "
          f"creation {cold})")
    start, ticks = SERVICE_PROFILE
    b = dict(run.breakdown)
    steps = b.pop("profiler steps")
    print("service ticks' wall: " + ", ".join(f"{k} {v:.3f} s" for k, v in b.items())
          + f" (of {rep.wall_s:.3f} s); outside the ticks {run.wall - rep.wall_s:.3f} s: "
          f"the profiler's steps {steps:.3f} s, the rest submission (the seeded problems "
          f"built on the host) and the report")
    print(f"profile service, ticks {start}–{start + ticks - 1}: kernels {run.kernel_s:.4f} s and "
          f"copies {run.copy_s:.4f} s over {run.window_s:.4f} s of ticks (device busy "
          f"{100 * (run.kernel_s + run.copy_s) / run.window_s:.1f}%, kernels alone "
          f"{100 * run.kernel_s / run.window_s:.1f}%); top rows by device time:")
    for dev_us, count, key in run.top:
        print(f"  {dev_us / 1e3:9.3f} ms  {count:6d}×  {key[:90]}")
    print(f"service card: {nvidia_smi()}")
    _require(rep.served == len(specs) and not (rep.timeouts or rep.rejected or rep.shed),
             "service: not every tenant was served")
    _require(rep.false_detections == 0, "service: a false detection")
    _require(modes == set(SERVICE_MODES), "service: the load lacks a mode")
    _require(rep.compile_count == len(sigs), "service: compile_count is not the number of "
                                             "distinct signatures")
    _require(rep.warm_hits == rep.served - cold, "service: warm hits do not follow the rule "
                                                 "(every admission into a live bucket)")
    # in this load each bucket's creation admits one tenant, so every other
    # admission is a warm hit
    _require(rep.warm_hits == len(specs) - rep.compile_count,
             "service: warm hits are not tenants − compile_count")
    check_service_launches(rep, specs, used)
    t0 = time.perf_counter()
    groups = check_service_verdicts(rep, specs, dev)
    print(f"service: every packed verdict bitwise batched_monitor's on the card on the "
          f"tenant's recorded series ({groups} (mode, norm) grids, "
          f"{time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    floors = service_floors(dev)
    print(f"service floors measured in {time.perf_counter() - t0:.1f} s")
    for family, _, grid in SERVICE_FAMILIES:
        floor, exact, r0 = floors[family]
        eps, worst = min(grid) / 10.0, max(floor, exact)
        print(f"service floors {family}: f32 {floor:.3e} (largest σ over the last "
              f"{FLOOR_STEPS // 4} of {FLOOR_STEPS} steps, seeds {FLOOR_SEEDS}, every "
              f"variant; first residual {min(r0):.3f}–{max(r0):.3f}), f64 {exact:.3e} (the "
              f"final f32 states' exact residual); the grid's least ε after the PFAIT "
              f"margin {eps:g} = {eps / worst if worst else float('inf'):.1f} × the larger")
        _require(eps >= 3 * worst, f"service {family}: the ε̃ grid is not 3× above the "
                                   f"larger floor after the margin")
    check_exact_at_detection(rep, specs, dev)
    t0 = time.perf_counter()
    check_replay_vs_eager(dev)
    print(f"service replay vs eager checked in {time.perf_counter() - t0:.1f} s")
    check_cpu_rerun(rep, specs, floors)


def warm_serve(dev) -> None:
    """A short serve at the same width and prompt length before the main
    paths (its launches are not counted), so the counted serve run is warm;
    prints the cold first prefill."""
    from repro_torch.launch.serve import serve

    out = serve(SERVE_ARCH, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT, max_new=2,
                use_reduced=False, seed=0, device=dev)
    print(f"serve warm-up (cold start): prefill {1e3 * out['prefill_s']:.3f} ms, "
          f"decode {1e3 * out['decode_s']:.3f} ms for 1 step")


def _jax_bar(got, want) -> float:
    """The JAX contract's bar for two computations of the same logits
    (``tests/test_models.py:88-91``): the worst element's share of
    5e-2 + 1e-2·|want| (≤ 1 passes)."""
    return float(((got - want).abs() / (5e-2 + 1e-2 * want.abs())).max())


def _maxdiff(a, b) -> float:
    return float((a - b).abs().max())


def verify_serve(out, used, dev) -> None:
    """The serve run's shape, health and launches; then the kernel inside
    the model at full width.

    f32 (the bf16 weights cast to f32, every op in f32): prefill logits
    with #6 against the plain attention, max|Δ| ≤ 1e-4 × max|logit|
    (summation order through 28 layers), and prefill(S−1) + one decode vs
    prefill(S) at the JAX bar.  bf16: two plain evaluations of this model
    (block_kv 512 and 256 against 1024) drift apart by more than the JAX
    bar, so the kernel vs the plain attention, and the decode path vs the
    kernel's prefill, are held at ``BF16_MODEL_BAR`` times it, which must
    lie above both plain drifts and below a plain evaluation that drops kv
    tile 0 for the last 64 rows of every layer; and both bf16 paths must
    be as accurate as the plain attention against the f32 plain prefill,
    max|Δ| ≤ 1.5 × max|plain − f32|."""
    import copy

    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.serve import make_prompts
    from repro_torch.models import layers as L
    from repro_torch.models.model import Model
    from repro_torch.models.transformer import forward

    cfg = get_arch(SERVE_ARCH)
    steps = out["steps"]
    print(f"serve {SERVE_ARCH} full width (bf16, {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}), batch {SERVE_BATCH}, prompt {SERVE_PROMPT}, max_new {SERVE_NEW}: "
          f"tokens {out['tokens'].shape}, steps {steps}, stopped_by {out['stopped_by']}, "
          f"prefill {1e3 * out['prefill_s']:.3f} ms, decode {1e3 * out['decode_s'] / steps:.3f} "
          f"ms/step, {out['tok_per_s']:.1f} tok/s over the whole run "
          f"({SERVE_BATCH * steps / out['decode_s']:.1f} tok/s in the decode loop), "
          f"flash launches {used['flash_attention_flat']}")
    _require(used["flash_attention_flat"] == cfg.num_layers,
             f"serve: {used['flash_attention_flat']} flash launches, want one per layer "
             f"({cfg.num_layers}) in the one prefill")
    _require(out["logits_finite"], "serve: NaN or inf in the logits")
    _require(out["tokens"].shape == (SERVE_BATCH, SERVE_NEW),
             f"serve: tokens {out['tokens'].shape}")
    _require(out["stopped_by"] in ("budget", "detector"), f"serve: {out['stopped_by']}")

    S = SERVE_PROMPT
    prompts = torch.as_tensor(make_prompts(cfg.vocab_size, SERVE_BATCH, S, 0),
                              device=dev).long()
    m16 = Model(cfg, device=dev)
    p16 = m16.init(torch.Generator(device=dev).manual_seed(0))
    m32 = Model(dataclasses.replace(cfg, dtype="float32"), device=dev)
    p32 = copy.deepcopy(p16).float()
    # plain-attention evaluations: the reference, two of its block sizes,
    # and a faulty one that drops kv tile 0 for the last 64 rows
    plains = {"plain": {}, "plain512": {"block_kv": 512}, "plain256": {"block_kv": 256},
              "faulty": {"window": S - 64}}
    logits = {}
    with torch.inference_mode():
        for tag, m, p in (("bf16", m16, p16), ("f32", m32, p32)):
            prefill, decode = m.make_prefill(), m.make_decode_step()
            logits[tag, "kernel"], _ = prefill(p, prompts)
            for name, knobs in plains.items():
                if tag == "f32" and name != "plain":
                    continue
                x, head, _, _ = forward(p, prompts, m.plan, m._ctx("prefill")._replace(
                    use_kernel=False, **knobs))
                logits[tag, name] = L.lm_head(x[:, -1:], head)
                del x
            _, cache = prefill(p, prompts[:, :S - 1], max_len=S)
            logits[tag, "decode"], _ = decode(p, cache, prompts[:, S - 1:], S - 1)
            del cache
    for v in logits.values():
        _require(bool(v.isfinite().all()), "in-model check: non-finite logits")
    ref = logits["f32", "plain"]
    scale = float(ref.abs().max())
    f32_kernel = _maxdiff(logits["f32", "kernel"], ref)
    f32_decode = _jax_bar(logits["f32", "decode"], logits["f32", "kernel"])
    err = {k: _maxdiff(logits["bf16", k], ref) for k in ("kernel", "plain", "decode")}
    # bf16 pairs: JAX-bar share and rms(Δ)/rms(want)
    pairs = {"kernel vs plain": ("kernel", "plain"), "decode vs prefill": ("decode", "kernel"),
             "plain block 512 vs 1024": ("plain512", "plain"),
             "plain block 256 vs 1024": ("plain256", "plain"),
             "faulty vs plain": ("faulty", "plain")}
    bar, rel = {}, {}
    for name, (a, b) in pairs.items():
        got, want = logits["bf16", a], logits["bf16", b]
        bar[name] = _jax_bar(got, want)
        rel[name] = float((got - want).square().mean().sqrt() / want.square().mean().sqrt())
    drift = max(bar["plain block 512 vs 1024"], bar["plain block 256 vs 1024"])
    print(f"in-model, f32: prefill logits flash kernel vs plain attention max|Δ| "
          f"{f32_kernel:.3e} over logits up to {scale:.3e} ({f32_kernel / scale:.2e} of the "
          f"largest; tolerance 1e-4); prefill over {S - 1} + one decode vs prefill over {S}: "
          f"worst element at {f32_decode:.4f} of the JAX bar (atol 5e-2 + rtol 1e-2)")
    print(f"in-model, bf16 against the f32 plain prefill: max|Δ| kernel {err['kernel']:.3e}, "
          f"plain {err['plain']:.3e}, prefill over {S - 1} + decode {err['decode']:.3e}; "
          f"ratios to plain {err['kernel'] / err['plain']:.3f} / "
          f"{err['decode'] / err['plain']:.3f} (tolerance 1.5)")
    print(f"in-model, bf16 pairs, worst element's share of the JAX bar (gated at "
          f"{BF16_MODEL_BAR:g}: kernel and decode at most, plain drifts at most, faulty above) "
          f"and rms(Δ)/rms(want): " + "; ".join(
              f"{name} {bar[name]:.3f}, {rel[name]:.3e}" for name in pairs))
    profile_serve(m16, p16, prompts)
    del p16, p32, logits, ref
    torch.cuda.empty_cache()
    _require(f32_kernel <= 1e-4 * scale, "f32 in-model: flash kernel departs from the plain "
             "attention")
    _require(f32_decode <= 1.0, "f32 in-model: decode departs from prefill (JAX bar)")
    _require(err["kernel"] <= 1.5 * err["plain"], "bf16 in-model: the flash kernel is less "
             "accurate than the plain attention")
    _require(err["decode"] <= 1.5 * err["plain"], "bf16 in-model: decode is less accurate "
             "than the plain prefill")
    _require(drift <= BF16_MODEL_BAR < bar["faulty vs plain"], "bf16 in-model: the bar "
             "does not lie between the plain drift and the faulty evaluation")
    _require(bar["kernel vs plain"] <= BF16_MODEL_BAR, "bf16 in-model: the flash kernel "
             "departs from the plain attention past the bar")
    _require(bar["decode vs prefill"] <= BF16_MODEL_BAR, "bf16 in-model: decode departs "
             "from prefill past the bar")


def profile_window(name, fn) -> None:
    """Device time by kernel and the device's busy share over one call of
    ``fn``, from ``torch.profiler`` (diagnostic only: a profiler that
    cannot trace the card prints so and the run goes on)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    # kernels only: an aten op's device time repeats its kernels'
    rows = sorted(((getattr(e, "device_time_total", 0.0), e.count, e.key)
                   for e in prof.key_averages()
                   if getattr(e, "device_type", None) == DeviceType.CUDA), reverse=True)
    if not rows:
        print(f"profile {name}: wall {wall_us / 1e3:.3f} ms; the profiler saw no kernels")
        return
    busy = sum(r[0] for r in rows)   # one stream: the kernels do not overlap
    print(f"profile {name}: wall {wall_us / 1e3:.3f} ms, kernels {busy / 1e3:.3f} ms "
          f"(device busy {100 * busy / wall_us:.1f}%); top kernels by device time:")
    for dev_us, count, key in rows[:10]:
        print(f"  {dev_us / 1e3:9.3f} ms  {count:6d}×  {key[:90]}")


def profile_serve(m, params, prompts) -> None:
    """``profile_window`` over one warm prefill and 4 decode steps."""
    import torch

    S = prompts.shape[1]
    prefill, decode = m.make_prefill(), m.make_decode_step()

    state = {}

    def run_prefill():
        state["logits"], state["cache"] = prefill(params, prompts, max_len=S + 4)

    def run_decode():
        tok = state["logits"][:, -1].argmax(dim=-1)
        for i in range(4):
            logits, state["cache"] = decode(params, state["cache"], tok[:, None], S + i)
            tok = logits[:, -1].argmax(dim=-1)

    with torch.inference_mode():
        profile_window("prefill (warm)", run_prefill)
        profile_window("4 decode steps", run_decode)
    state.clear()


def exact_residual(st, x, b, ord=INF):
    """The exact residual of a global state in the run's norm, through the
    residual kernel: max|b − A x| (l∞) or Σ|b − A x| (l1)."""
    from repro_torch.kernels.jacobi3d import ops as jops
    from repro_torch.solvers.fixed_point import _zero_ghosts, ghosted

    return float(jops.residual_contribution(st, ghosted(x, _zero_ghosts(x)), b, ord=ord))


def _check_trace(run: Run) -> None:
    """A blocking run follows the synchronous reference trajectory in its
    norm, and its detection is consistent with that exact trace
    (``core.termination``)."""
    from repro_torch.core import termination
    from repro_torch.runtime import shard_runtime as sr

    T = run.r.outer_iters
    ref = sr.convdiff_reference_trace(run.st, run.b, T, ord=run.ord)
    err = float(((run.r.trace[:T].double() - ref.double()).abs() / ref.double().abs()).max())
    trace, target = run.r.trace[:T].tolist(), eps_tilde(run.ord, run.b.shape[0])
    consistent = termination.detection_consistent(T - 1, trace, target)
    print(f"{run.name}: trace vs synchronous reference ({_ord_tag(run.ord)}) over {T} steps, "
          f"max rel {err:.3e} (tolerance 5e-5); oracle step "
          f"{termination.oracle_detect_step(trace, target)}, detected at {T - 1}, "
          f"consistent: {consistent}")
    _require(err <= 5e-5, f"{run.name}: trace departs from the reference ({err:.3e})")
    _require(consistent, f"{run.name}: detection inconsistent with its exact trace")


def verify_runs(solver_runs, shard_runs, mesh_runs, dist_twins=()) -> None:
    """r* < ε̃ for every run, in its norm (no false detection), the
    distributed path's stacked twins included; blocking follows the
    synchronous reference trajectory; comm overlap is bitwise no overlap."""
    import torch

    from repro_torch.solvers import jacobi
    from repro_torch.solvers.fixed_point import _zero_ghosts, ghosted

    # the exact residual through the kernel against the plain version: l∞
    # exact up to the f32 cast, l1 up to f32 summation order
    for run, tol in ((solver_runs[0], 1e-6), (solver_runs[-1], 1e-5)):
        r = jacobi.residual_block(run.st, ghosted(run.r.x, _zero_ghosts(run.r.x)), run.b).abs()
        plain = float(r.max() if run.ord == INF else r.sum())
        kern = exact_residual(run.st, run.r.x, run.b, run.ord)
        _require(abs(kern - plain) <= tol * plain,
                 f"exact {_ord_tag(run.ord)} residual: kernel {kern:.6e} vs plain {plain:.6e}")
    for run in solver_runs + shard_runs + mesh_runs + list(dist_twins):
        r = run.r
        r_star = exact_residual(run.st, r.x, run.b, run.ord)
        target = eps_tilde(run.ord, run.b.shape[0])
        print(f"run {run.name}: converged={r.converged} outer={r.outer_iters} "
              f"detected={float(r.residual):.3e} exact r*={r_star:.3e} ({_ord_tag(run.ord)}, "
              f"ε̃ {target:g}) wall={run.wall:.3f} s launches={json.dumps(run.used)}")
        _require(r.converged, f"{run.name}: did not converge")
        _require(r_star < target, f"{run.name}: false detection, r* {r_star:.3e} >= ε̃")
    for run in (shard_runs[0], mesh_runs[0], mesh_runs[-1]):
        _check_trace(run)
    r0, r1 = (run.r for run in mesh_runs[1:3])
    wall0, wall1 = (run.wall for run in mesh_runs[1:3])
    same = (r0.outer_iters == r1.outer_iters and torch.equal(r0.x, r1.x)
            and torch.equal(r0.trace, r1.trace))
    print(f"overlap vs no overlap, (3,2) hetero: outer {r1.outer_iters} / {r0.outer_iters}, "
          f"x and trace bitwise equal: {same}; wall {wall1:.3f} / {wall0:.3f} s")
    _require(same, "comm overlap is not bitwise equal to no overlap")
    r1d, wall1d = shard_runs[1].r, shard_runs[1].wall
    print(f"wall, same knobs at n = {SHARD_N}: mesh (3,2) {wall0:.3f} s for "
          f"{r0.outer_iters} steps ({1e3 * wall0 / r0.outer_iters:.3f} ms/step) vs 1-D p = 6 "
          f"{wall1d:.3f} s for {r1d.outer_iters} steps "
          f"({1e3 * wall1d / r1d.outer_iters:.3f} ms/step)")


# ---------------------------------------------------------------------------
# phase 12: asynchronous data-parallel training
# ---------------------------------------------------------------------------

# ridge least squares at n = 1024 over 262144 rows (a 2 GiB f64 design,
# 512 MiB a worker at p = 4), cond 10, 8 minibatches of 8192 rows a worker;
# inner steps a multiple of TRAIN_NB, so each round's map is fixed and the
# residual can reach ε̃; l2, ε̃ = 1e-8, margin 10.  Logistic at 65536 rows
TRAIN_N, TRAIN_M, TRAIN_P, TRAIN_NB, TRAIN_COND = 1024, 262144, 4, 8, 10.0
TRAIN_EPS, TRAIN_LOGISTIC_M = 1e-8, 65536
TRAIN_KNOBS = dict(inner_sweeps=(8, 16, 8, 16), halo_delay=(0, 1, 0, 2),
                   contrib_lag=(0, 1, 0, 1))
# #5's shapes on that path: the [p, n] replica stacks at block n (one
# partial per replica; p = 1 is the NCCL world's twin) and a rank's replica
TRAIN_STACKS = ((TRAIN_P, TRAIN_N), (1, TRAIN_N))
TRAIN_PROFILE_ROUNDS = 8
# the trace recorded by each run (run (a)'s is held to reference_trace)
TRAIN_TRACE_LEN = 4096


class TrainPath(NamedTuple):
    """The training path: the problems, their step sizes and host build
    times, the stacked runs (name → (RunReport, p, RuntimeConfig, launches
    of its two runs)), the worlds' rank reports, and the launches made
    inside them."""

    probs: dict
    gammas: dict
    times: dict
    runs: dict
    worlds: dict
    world_launches: dict
    world_shapes: Counter


def train_cells(gammas) -> list:
    """Phase 12's stacked runs: ``(name, task, p, RuntimeConfig)``; the
    worlds repeat (b) on gloo ×4 and (a) at p = 1 on NCCL ×1."""
    from repro_torch.core import detection
    from repro_torch.runtime import api

    def mon(mode="pfait"):
        return detection.for_mode(mode, eps_tilde=TRAIN_EPS, margin=10.0, staleness=2,
                                  persistence=4, ord=2.0)

    def cfg(task, p, **kw):
        return api.RuntimeConfig(num_batches=TRAIN_NB, gamma=gammas[task, p],
                                 max_outer=5000, trace_len=TRAIN_TRACE_LEN, **kw)

    p = TRAIN_P
    return [
        ("(a) blocking", "lstsq", p, cfg("lstsq", p, monitor=mon(), reduction="blocking",
                                         inner_sweeps=8)),
        ("(b) nonblocking pfait K=2 hetero", "lstsq", p, cfg(
            "lstsq", p, monitor=mon(), reduction="nonblocking", **TRAIN_KNOBS)),
        ("(c) rdoubling", "lstsq", p, cfg("lstsq", p, monitor=mon(), reduction="rdoubling",
                                          inner_sweeps=8)),
        ("(d) nonblocking nfais2", "lstsq", p, cfg("lstsq", p, monitor=mon("nfais2"),
                                                   reduction="nonblocking", inner_sweeps=8)),
        ("(e) logistic nonblocking", "logistic", p, cfg(
            "logistic", p, monitor=mon(), reduction="nonblocking", inner_sweeps=8)),
        ("(a) blocking p=1", "lstsq", 1, cfg("lstsq", 1, monitor=mon(), reduction="blocking",
                                             inner_sweeps=8)),
    ]


def run_training(dev) -> TrainPath:
    """Phase 12: ``runtime.api.run_train`` at full size on the card, and
    the worlds that repeat (b) and (a) one replica per rank."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch.launch.mesh import spawn_world
    from repro_torch.launch.worlds import Case, run_cases, save_train_inputs
    from repro_torch.runtime import api
    from repro_torch.runtime.train_async import init_replicas, safe_gamma
    from repro_torch.solvers.mlfixed import MLFixedPointProblem

    probs, gammas, times, placed = {}, {}, {}, {}
    for task, m in (("lstsq", TRAIN_M), ("logistic", TRAIN_LOGISTIC_M)):
        t0 = time.perf_counter()
        probs[task] = prob = MLFixedPointProblem(n=TRAIN_N, p=TRAIN_P, m_rows=m, task=task,
                                                 cond=TRAIN_COND, seed=0)
        times["build", task] = time.perf_counter() - t0
        t0 = time.perf_counter()
        placed[task] = (torch.as_tensor(prob.A, device=dev), torch.as_tensor(prob.y, device=dev))
        torch.cuda.synchronize()
        times["place", task] = time.perf_counter() - t0
        for p in (TRAIN_P, 1) if task == "lstsq" else (TRAIN_P,):
            t0 = time.perf_counter()
            gammas[task, p] = safe_gamma(prob, p, TRAIN_NB, device=dev)
            times["safe_gamma", task, p] = time.perf_counter() - t0
    runs = {}
    cells = train_cells(gammas)
    for name, task, p, cfg in cells:
        A, y = placed[task]
        before = _launches()
        rep = api.run_train(probs[task], cfg, p, init_replicas(probs[task], p), A, y,
                            device=dev)
        runs[name] = (rep, p, cfg, {k: v - before[k] for k, v in _launches().items()})
    # a few rounds of (b) under the profiler
    from repro_torch.runtime.train_async import make_train_runtime

    bcfg = dict((name, cfg) for name, _, _, cfg in cells)["(b) nonblocking pfait K=2 hetero"]
    A, y = placed["lstsq"]
    X0 = torch.zeros((TRAIN_P, TRAIN_N), dtype=torch.float64, device=dev)
    short = dataclasses.replace(bcfg.to_train_config(), max_rounds=TRAIN_PROFILE_ROUNDS)
    prof_run = make_train_runtime(probs["lstsq"], short, TRAIN_P, device=dev)
    prof_run(X0, A, y)
    profile_window(f"train (b), {TRAIN_PROFILE_ROUNDS} rounds", lambda: prof_run(X0, A, y))
    del placed
    torch.cuda.empty_cache()
    # the worlds: ranks map the saved design and read their own rows
    worlds, inside = {}, Counter()
    (ROOT / "build").mkdir(exist_ok=True)
    by_name = {name: cfg for name, _, _, cfg in cells}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as store:
        t0 = time.perf_counter()
        data = save_train_inputs(probs["lstsq"], str(Path(store) / "lstsq"))
        times["save"] = time.perf_counter() - t0
        for label, k, backend, name in (
                ("gloo x4", TRAIN_P, "gloo", "(b) nonblocking pfait K=2 hetero"),
                ("nccl x1", 1, "nccl", "(a) blocking p=1")):
            t0 = time.perf_counter()
            ranks = spawn_world(run_cases, k, store, args=(
                backend, [Case(name, "train", by_name[name], (k,), data)], None),
                timeout=600)
            worlds[label] = dict(ranks=ranks, name=name, k=k, backend=backend,
                                 wall=time.perf_counter() - t0)
            for r in ranks:
                for c in r["cases"]:
                    inside.update(c["launches"])
    return TrainPath(probs, gammas, times, runs, worlds, dict(inside), Counter())


def verify_train(out: TrainPath, card: str) -> None:
    """Every run converged with the exact lifted residual of its replicas
    under ε̃ (no false detection); (a) follows ``reference_trace`` round for
    round and its detection is consistent with it; each world equals its
    stacked twin (X bitwise, the l2 trace within p·2^-24); #5 launched once
    a round (stacked: one launch over the replica stack; a rank: one over
    its replica), plus one a verification."""
    import numpy as np

    from repro_torch.core import termination
    from repro_torch.runtime.train_async import exact_train_residual, reference_trace

    t = out.times
    for task, prob in out.probs.items():
        print(f"train problem {task}: n = {prob.n}, m = {prob.m} ({prob.A.nbytes / 2**30:.2f} "
              f"GiB f64 design), cond {TRAIN_COND:g}, seed 0: host build {t['build', task]:.2f} "
              f"s, placed on the card in {t['place', task]:.2f} s; safe_gamma on the card "
              + ", ".join(f"p = {p}: γ = {g:.6e} in {t['safe_gamma', tk, p]:.2f} s"
                          for (tk, p), g in out.gammas.items() if tk == task))
    for name, (rep, p, cfg, used) in out.runs.items():
        task = "logistic" if "logistic" in name else "lstsq"
        prob, raw = out.probs[task], rep.raw
        t0 = time.perf_counter()
        r_star = exact_train_residual(prob, raw.x.cpu().numpy(), cfg.inner_sweeps,
                                      out.gammas[task, p], ord=2.0, num_batches=TRAIN_NB)
        r_s = time.perf_counter() - t0
        run_s = dict(rep.wall_segments)["run"]
        launches = used.get("diff_norm_partials", 0)
        want = 2 * (raw.rounds + raw.verifications)   # build run and timed run
        print(f"train {name} (p = {p}): converged={rep.converged} rounds={raw.rounds} "
              f"verifications={raw.verifications} detected={rep.detected_residual:.3e} exact "
              f"r* {r_star:.3e} (l2, ε̃ {TRAIN_EPS:g}; host {r_s:.2f} s) loss "
              f"{float(raw.loss):.12e}; {1e3 * run_s / raw.rounds:.4f} ms/round (run "
              f"{run_s:.3f} s, build {dict(rep.wall_segments)['build']:.3f} s); #5 launches "
              f"{launches} over two runs (want {want}); launches {json.dumps(used)}")
        _require(rep.converged, f"train {name}: did not converge")
        _require(r_star < TRAIN_EPS, f"train {name}: false detection, r* {r_star:.3e} >= ε̃")
        _require(launches == want, f"train {name}: #5 launched {launches} times, not {want}")
    rep = out.runs["(a) blocking"][0]
    T = rep.outer_iters
    t0 = time.perf_counter()
    _, ref = reference_trace(out.probs["lstsq"], TRAIN_P, 8, TRAIN_NB,
                             out.gammas["lstsq", TRAIN_P], rounds=T + 1, ord=2.0)
    ref_s = time.perf_counter() - t0
    trace = rep.raw.trace[:T].double().cpu().numpy()
    # the blocking lane of round k evaluates the replicas that round k
    # produced, which are the reference's state k + 1
    err = float(np.max(np.abs(trace - ref[1:]) / np.abs(ref[1:])))
    # the blocking lane is the exact lifted residual: its own trace is the
    # exact trace the oracle rule reads (as phase 8's blocking run)
    consistent = termination.detection_consistent(rep.detect_step, trace.tolist(), TRAIN_EPS)
    print(f"train (a): trace[k] vs reference_trace[k + 1] over its {T} rounds (host numpy, "
          f"{ref_s:.1f} s), max rel {err:.3e} (tolerance 5e-5); oracle round "
          f"{termination.oracle_detect_step(trace.tolist(), TRAIN_EPS)} on its exact trace, "
          f"detected at {rep.detect_step}, consistent: {consistent}")
    _require(err <= 5e-5, f"train (a): trace departs from reference_trace ({err:.3e})")
    _require(consistent, "train (a): detection inconsistent with its exact trace")
    print(f"train worlds on {card}: ranks that share one card; the design saved for the "
          f"ranks in {out.times['save']:.2f} s")
    for label, w in out.worlds.items():
        twin = out.runs[w["name"]][0].raw
        got = [r["cases"][0] for r in w["ranks"]]
        g = got[0]
        bar = w["k"] * 2.0 ** -24
        fin = np.isfinite(twin.trace.cpu().numpy())
        gap = float(np.max(np.abs(g["trace"][fin] - twin.trace.cpu().numpy()[fin])
                           / np.abs(twin.trace.cpu().numpy()[fin]), initial=0.0))
        same = (all(c["x_digest"] == g["x_digest"] for c in got)
                and g["outer_iters"] == twin.rounds and g["converged"]
                and g["verifications"] == twin.verifications
                and np.array_equal(g["x"], twin.x.cpu().numpy())
                and np.array_equal(np.isfinite(g["trace"]), fin))
        per_rank = [c["launches"].get("diff_norm_partials", 0) for c in got]
        want = 2 * (twin.rounds + twin.verifications)
        print(f"  world {label} ({w['backend']}, {w['k']} ranks, {w['wall']:.1f} s with spawn "
              f"and reading the rows) {w['name']}: rounds {g['outer_iters']} / stacked "
              f"{twin.rounds}, X bitwise and rounds equal, ranks agree: {same}; l2 trace "
              f"largest relative gap {gap:.3e} (bar {bar:.3e}); "
              f"{1e3 * g['wall_s'] / max(g['outer_iters'], 1):.4f} ms/round; #5 per rank "
              f"{per_rank} (want {want} each); host-staged "
              f"{sum(c['staged_bytes'] for c in got) / (2 * max(g['outer_iters'], 1)):.0f} "
              f"B/round (all ranks)")
        _require(same and gap <= bar, f"train world {label}: departs from its stacked twin")
        _require(all(n == want for n in per_rank), f"train world {label}: #5 launched "
                 f"{per_rank} times, not {want} per rank")


# ---------------------------------------------------------------------------
# phase 13: the elastic driver
# ---------------------------------------------------------------------------

# convdiff at n = 150 over 6 slots, Jacobi, PFAIT K = 2 non-blocking, inner
# 2, halo delay 1, lag 1, l∞, ε̃ = 1e-6: worker 1 crashes in segment 3 and
# rejoins after segment 8.  The stencil contracts at ρ 0.98 (not phase 5's
# 0.95) so that the solve outlives the rejoin: at 0.95 it converges at about
# 170 rounds, inside segment 8 on 5 shards
ELASTIC_N, ELASTIC_SLOTS, ELASTIC_RHO = 150, 6, 0.98
ELASTIC_PLAN = dict(crash_at={1: 3}, join_at={1: 8})
ELASTIC_KNOBS = dict(segment_len=40, ckpt_every=2)
# PageRank at n = 16384 over 4 slots, l1, ε̃ = 1e-9: worker 2 crashes in
# segment 2 and rejoins after segment 6.  The solve takes about 30 rounds,
# so segments are 5 rounds long, short enough that it outlives the rejoin
ELASTIC_PR_SLOTS, ELASTIC_PR_PLAN = 4, dict(crash_at={2: 2}, join_at={2: 6})
ELASTIC_PR_KNOBS = dict(segment_len=5, ckpt_every=2)
# the shard counts each run must pass through
ELASTIC_HISTORY = {"convdiff": [6, 5, 6], "pagerank": [4, 2, 4]}


def run_elastic_driver(dev) -> dict:
    """Phase 13: ``runtime.api.run_elastic`` through a crash, a shrink and a
    regrow, for convdiff at n = 150 and PageRank at n = 16384."""
    import tempfile

    import torch

    from repro_torch.core import detection
    from repro_torch.runtime import api
    from repro_torch.runtime.elastic import FaultPlan
    from repro_torch.solvers.convdiff import Stencil
    from repro_torch.solvers.pagerank import PageRankProblem

    out = {}
    (ROOT / "build").mkdir(exist_ok=True)
    n = ELASTIC_N
    st = Stencil.for_contraction(n, nu=1.0, a=(1.0, 1.0, 1.0), rho=ELASTIC_RHO)
    b = _rhs(n, dev)
    cfg = api.RuntimeConfig(
        monitor=detection.for_mode("pfait", eps_tilde=EPS_TILDE, margin=10.0, staleness=2,
                                   persistence=4, ord=INF),
        reduction="nonblocking", inner_sweeps=2, halo_delay=1, contrib_lag=1,
        record_trace=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as ckpt:
        before = _launches()
        rep = api.run_elastic("convdiff", cfg, n, torch.zeros_like(b), b,
                              FaultPlan(**ELASTIC_PLAN), ckpt, stencil=st,
                              slots=ELASTIC_SLOTS, device=dev, **ELASTIC_KNOBS)
        out["convdiff"] = dict(rep=rep, st=st, b=b, eps=EPS_TILDE,
                               used={k: v - before[k] for k, v in _launches().items()})
    if "prob" not in _PAGERANK_HOST:
        prob = PageRankProblem(n=PAGERANK_N, p=PAGERANK_P, seed=0)
        _PAGERANK_HOST.update(prob=prob, P_host=prob.to_dense())
    prob = _PAGERANK_HOST["prob"]
    P = torch.as_tensor(_PAGERANK_HOST["P_host"], device=dev)
    pcfg = api.RuntimeConfig(
        monitor=detection.for_mode("pfait", eps_tilde=PAGERANK_EPS, margin=10.0,
                                   staleness=2, persistence=4, ord=1.0),
        reduction="nonblocking", record_trace=True)
    x0 = torch.full((PAGERANK_N,), 1.0 / PAGERANK_N, dtype=torch.float64, device=dev)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as ckpt:
        before = _launches()
        rep = api.run_elastic("pagerank", pcfg, PAGERANK_N, x0, P,
                              FaultPlan(**ELASTIC_PR_PLAN), ckpt, damping=prob.d,
                              slots=ELASTIC_PR_SLOTS, device=dev, **ELASTIC_PR_KNOBS)
        out["pagerank"] = dict(rep=rep, prob=prob, P=P, eps=PAGERANK_EPS,
                               used={k: v - before[k] for k, v in _launches().items()})
    return out


def verify_elastic(out: dict) -> None:
    """Each run restarted once, stalled at least a segment, went through
    its shard counts (``ELASTIC_HISTORY``) back to every slot, converged
    with the exact residual of its result under ε̃ (PageRank's on the card
    and on the host, within phase 8's f64 bar), and its trace validates;
    convdiff rolled iterations back.  Prints the recovery accounting."""
    import statistics as stats

    from repro_torch.core.trace import validate_trace

    for family, o in out.items():
        rep, raw = o["rep"], o["rep"].raw
        slots = ELASTIC_SLOTS if family == "convdiff" else ELASTIC_PR_SLOTS
        if family == "convdiff":
            r_star = exact_residual(o["st"], rep.x, o["b"], INF)
            extra = f"exact r* {r_star:.3e} (l∞)"
            ok = r_star < o["eps"]
        else:
            prob, P, x = o["prob"], o["P"], rep.x
            d, v = prob.d, prob.v
            r_card = float((d * (P @ x) + v - x).abs().sum())
            scale = float((d * (P @ x.abs()) + v + x.abs()).sum())
            r_star = prob.exact_residual([x.cpu().numpy()])
            bar = 4 * F64_UNIT * scale
            extra = (f"exact r* card {r_card:.6e} host {r_star:.6e} (|Δ| "
                     f"{abs(r_card - r_star):.2e}, bar {bar:.2e}; l1)")
            ok = r_star < o["eps"] and r_card < o["eps"] and abs(r_card - r_star) <= bar
        walls = raw.segment_walls
        history = [p for _, p in raw.mesh_history]
        print(f"elastic {family}: converged={rep.converged} outer={raw.outer_iters} "
              f"segments {raw.segments_run} (run {len(walls)}, stalled {raw.stall_segments}) "
              f"restarts {raw.restarts} lost iterations {raw.lost_iters} detection latency "
              f"{raw.detect_latency} segments, checkpoint saves {raw.checkpoint_saves}; shard "
              f"counts {raw.mesh_history}, members {raw.members_final}; detected "
              f"{rep.detected_residual:.3e}, {extra}, ε̃ {o['eps']:g}; "
              f"{1e3 * stats.mean(walls):.3f} ms a segment (median "
              f"{1e3 * stats.median(walls):.3f}, first {1e3 * walls[0]:.3f}), saves "
              f"{1e3 * raw.save_s:.3f} ms (host snapshots) + {1e3 * raw.flush_s:.3f} ms "
              f"waiting for writes, restore {1e3 * raw.restore_s:.3f} ms; wall "
              f"{rep.wall_s:.3f} s; launches {json.dumps(o['used'])}")
        print(f"  events: {raw.events}")
        _require(rep.converged, f"elastic {family}: did not converge")
        _require(ok, f"elastic {family}: false detection or r* off its bar")
        _require(raw.restarts == 1 and raw.stall_segments >= 1,
                 f"elastic {family}: {raw.restarts} restarts, {raw.stall_segments} stalls")
        _require(history == ELASTIC_HISTORY[family], f"elastic {family}: shard counts "
                 f"{history}, not {ELASTIC_HISTORY[family]}")
        _require(raw.members_final == tuple(range(slots)),
                 f"elastic {family}: members {raw.members_final}")
        _require(family != "convdiff" or raw.lost_iters > 0,
                 "elastic convdiff: the restart rolled nothing back")
        _require(validate_trace(rep.trace), f"elastic {family}: trace fails validate()")
    del out["pagerank"]["P"]


# ---------------------------------------------------------------------------
# phase 14: dense-LM training
# ---------------------------------------------------------------------------

# the LM training path: qwen2-1.5b at full width through launch.train.train,
# TRAIN_4K's 4096 tokens a sequence at batch 4 (TRAIN_4K's global batch of
# 256 cut to 4 for one card's step time; nothing else is cut), bf16, seed 0,
# remat "block", PFAIT K = 2 on the loss; one warm-up step and 4 timed steps
LM_ARCH, LM_BATCH, LM_STEPS, LM_K = "qwen2-1.5b", 4, 5, 2
PEAK_BF16_FLOPS = 989e12              # H100 SXM data sheet, dense bf16
# the reduced runs: JAX's tests/test_system.py and test_train_loop.py settings
LM_TARGET = 3.8
LM_SMALL = dict(batch=4, seq=64, use_reduced=True, margin=1.0, log_every=1000)
# a reduced f32 state's 3 steps on the card against the CPU: loss and
# grad_norm within rtol 1e-4 (summation order in every product and norm,
# through two Adam updates)
LM_CPU_RTOL = 1e-4
LM_CPU_STEPS = 3


class LMTrainRun(NamedTuple):
    """Phase 14's results: the full-width run and its probes, the reduced
    runs, the ring check and the card-against-CPU steps."""

    full: dict                  # launch.train.train's return at full width
    metrics: list               # every full-width step's (loss, grad_norm) on the host
    step_ms: list               # CUDA-event span of each step (0 = warm-up)
    span_ms: float              # start of step 1 to the end of the last step
    busy_ms: float              # kernel time the profiler saw over the timed steps
    syncs: list                 # synchronising CUDA calls inside one timed step
    peak_bytes: int
    mb_loss: tuple              # (loss of the whole batch, of 2 microbatches)
    attn_ms: tuple              # one layer's plain attention: forward, backward
    small: dict                 # reduced runs by name
    ring_equal: bool
    cpu: tuple                  # ([(loss, gnorm)] on the card, on the CPU)


class _StepProbe:
    """Wraps the step function ``launch.train.train`` builds: CUDA events
    around each step, the profiler advanced after it, the metrics kept, and
    the synchronising CUDA calls inside step ``sync_step`` recorded
    (``torch.cuda.set_sync_debug_mode("warn")``)."""

    def __init__(self, prof, sync_step: int):
        self.prof, self.sync_step = prof, sync_step
        self.events, self.metrics, self.syncs = [], [], []

    def wrap(self, step):
        import traceback
        import warnings

        import torch

        def seen(message, category, filename, lineno, file=None, line=None):
            if "synchronizing CUDA operation" in str(message):
                # where in the repository the call came from
                frames = [f for f in traceback.extract_stack()[:-1] if "/src/" in f.filename]
                self.syncs.append(" <- ".join(f"{Path(f.filename).name}:{f.lineno}"
                                              for f in reversed(frames[-3:])) or
                                  f"{filename}:{lineno}")

        def probed(state, batch):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            if len(self.events) == self.sync_step:
                with warnings.catch_warnings():
                    warnings.simplefilter("always")
                    warnings.showwarning = seen
                    torch.cuda.set_sync_debug_mode("warn")
                    try:
                        out = step(state, batch)
                    finally:
                        torch.cuda.set_sync_debug_mode("default")
            else:
                out = step(state, batch)
            end.record()
            self.events.append((start, end))
            self.metrics.append(out[1])
            self.prof.step()
            return out

        return probed


def _profile_rows(prof, top: int = 8):
    """``(busy_us, kernels, ops)`` of a profile: the summed device time of
    its kernels, memory copies and fills (one stream: they do not overlap),
    and the top kernels, and the top operators by the device time of the
    kernels each launched, as (ms, count, name).  Read from the raw trace
    events: building the profiler's event tree for the thousands of
    launches of a training step takes a minute."""
    from torch.autograd import DeviceType

    events = list(prof.profiler.kineto_results.events())
    # the operators that launched each kernel, by correlation id
    op_of = {e.correlation_id(): e.name() for e in events
             if e.device_type() == DeviceType.CPU and e.name().startswith("aten::")}
    kernels, ops = Counter(), Counter()
    k_count, o_count = Counter(), Counter()
    for e in events:
        # the schedule's ProfilerStep ranges appear on the device too: they
        # are annotations, not device work
        if e.device_type() != DeviceType.CUDA or e.is_user_annotation() \
                or e.name().startswith("ProfilerStep"):
            continue
        us = e.duration_ns() / 1e3
        kernels[e.name()] += us
        k_count[e.name()] += 1
        op = op_of.get(e.linked_correlation_id())
        if op is not None:
            ops[op] += us
            o_count[op] += 1
    busy = sum(kernels.values())
    return busy, [(t / 1e3, k_count[k], k) for k, t in kernels.most_common(top)], \
        [(t / 1e3, o_count[k], k) for k, t in ops.most_common(top)]


def _lm_flops(cfg, batch: int, seq: int) -> float:
    """Model FLOPs of one training step (PaLM's count): 6·N·tokens over the
    parameters that enter a product (the layers' matrices and the LM head),
    plus the attention's 12·L·H·d_head·S a token."""
    from repro_torch.models.layers import ceil_to

    d, hd = cfg.d_model, cfg.resolved_head_dim
    attn = d * hd * (2 * cfg.num_heads + 2 * cfg.num_kv_heads)
    mlp = (3 if cfg.gated_mlp else 2) * d * cfg.d_ff
    n = cfg.num_layers * (attn + mlp) + ceil_to(cfg.vocab_size, 256) * d
    tokens = batch * seq
    return 6.0 * n * tokens + 12.0 * cfg.num_layers * cfg.num_heads * hd * seq * tokens


def _time_attention(dev, cfg, batch: int, seq: int):
    """(forward ms, backward ms) of one layer's plain attention
    (``attention_fwd`` under autograd) at the step's shapes, CUDA events
    over 3 calls after a warm-up."""
    import torch

    from repro_torch.models.attention import attention_fwd, plan_attention

    ap = plan_attention(cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim, 1)
    g = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16).requires_grad_()

    q = rand(batch, seq, ap.slots, ap.q_per_slot, ap.head_dim)
    k, v = rand(batch, seq, ap.slots, ap.head_dim), rand(batch, seq, ap.slots, ap.head_dim)
    ct = torch.randn(q.shape, generator=g, device=dev).to(torch.bfloat16)
    fwd = bwd = 0.0
    for rep in range(4):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        out = attention_fwd(q, k, v, causal=True)
        ev[1].record()
        out.backward(ct)
        ev[2].record()
        torch.cuda.synchronize()
        if rep:
            fwd += ev[0].elapsed_time(ev[1]) / 3
            bwd += ev[1].elapsed_time(ev[2]) / 3
        del out
        q.grad = k.grad = v.grad = None
    return fwd, bwd


def run_lm_train(dev) -> LMTrainRun:
    """Phase 14: dense-LM training through ``launch.train.train``: (a) at
    full width, timed and profiled, then one 2-microbatch step; (b) the
    reduced runs to the target loss and through a checkpoint; (c) a
    reduced f32 state's steps on the card and on the CPU."""
    import gc
    import math
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch import interop
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs.base import TRAIN_4K, reduced
    from repro_torch.configs.registry import get_arch
    from repro_torch.core import detection
    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.launch.train import train
    from repro_torch.models import model as model_mod
    from repro_torch.optim import AdamW, constant_schedule, cosine_schedule

    card = nvidia_smi()
    seq = TRAIN_4K.seq_len
    cfg = get_arch(LM_ARCH)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    print(f"lm train: {torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB allocated before "
          f"the phase [{card}]")

    # (a) full width: 1 warm-up + 4 timed steps, the timed ones profiled
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   schedule=schedule(wait=0, warmup=1, active=LM_STEPS - 1, repeat=1))
    probe = _StepProbe(prof, sync_step=LM_STEPS - 1)
    built = model_mod.Model.make_train_step

    def probed_build(self, *args, **kw):
        step, mon = built(self, *args, **kw)
        return probe.wrap(step), mon

    model_mod.Model.make_train_step = probed_build
    t0 = time.perf_counter()
    try:
        with prof:
            full = train(LM_ARCH, steps=LM_STEPS, batch=LM_BATCH, seq=seq, use_reduced=False,
                         monitor_mode="pfait", staleness=LM_K, seed=0, log_every=1,
                         device=dev)
            torch.cuda.synchronize()
    finally:
        model_mod.Model.make_train_step = built
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    step_ms = [s.elapsed_time(e) for s, e in probe.events]
    span_ms = probe.events[1][0].elapsed_time(probe.events[-1][1])
    metrics = [(float(m["loss"]), float(m["grad_norm"])) for m in probe.metrics]
    t1 = time.perf_counter()
    busy_us, kernels, ops = _profile_rows(prof)
    t_table = time.perf_counter() - t1
    timed = LM_STEPS - 1
    tokens = LM_BATCH * seq
    flops = _lm_flops(cfg, LM_BATCH, seq)
    print(f"lm train (a) full width: {LM_ARCH} {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, batch {LM_BATCH} × {seq}, bf16, remat block, PFAIT K = {LM_K}: "
          f"train() {wall:.3f} s for {LM_STEPS} steps; warm-up step {step_ms[0]:.3f} ms, timed "
          f"steps {', '.join(f'{t:.3f}' for t in step_ms[1:])} ms; {span_ms / timed:.3f} ms a "
          f"step over steps 1–{timed} ({tokens * timed / (span_ms / 1e3):.1f} tokens/s); model "
          f"FLOPs {flops:.4e} a step, {100 * flops / (span_ms / timed / 1e3) / PEAK_BF16_FLOPS:.2f}% "
          f"of the bf16 dense peak; peak memory {peak / 2**30:.2f} GiB; device busy "
          f"{100 * busy_us / 1e3 / span_ms:.1f}% ({busy_us / 1e3:.3f} ms of kernels over "
          f"{span_ms:.3f} ms); {len(probe.syncs)} synchronising CUDA calls inside step "
          f"{LM_STEPS - 1} [{card}]")
    for site, n in Counter(probe.syncs).most_common(8):
        print(f"  synchronising call: {n}× at {site}")
    print("  losses " + ", ".join(f"{l:.4f}" for l, _ in metrics) + "; grad norms "
          + ", ".join(f"{g:.4f}" for _, g in metrics) + f"; ln(vocab) {math.log(cfg.vocab_size):.4f}")
    print(f"profile lm train, top kernels by device time over the timed steps ({t_table:.1f} s "
          f"to tabulate) [{card}]:")
    for t, c, k in kernels:
        print(f"  {t:9.3f} ms  {c:6d}×  {k[:90]}")
    print(f"profile lm train, top operators by the device time of their kernels [{card}]:")
    for t, c, k in ops:
        print(f"  {t:9.3f} ms  {c:6d}×  {k[:90]}")
    del prof

    # one 2-microbatch step from the trained state, against the loss of the
    # whole batch on the same parameters (what a 1-microbatch step reports)
    t1 = time.perf_counter()
    model = model_mod.Model(cfg, device=dev)
    state = full["state"]
    host = synth_batch(DataConfig(seed=0, vocab_size=cfg.vocab_size), LM_STEPS, LM_BATCH, seq)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    with torch.no_grad():
        loss1 = float(model.loss_fn(state.params, batch)[0])
    opt = AdamW(cosine_schedule(3e-3, max(LM_STEPS // 20, 1), LM_STEPS))
    step2, _ = model.make_train_step(opt, monitor=full["monitor"], microbatches=2)
    state, met = step2(state, batch)
    mb_loss = (loss1, float(met["loss"]))
    finite = bool(torch.stack([torch.isfinite(p).all() for p in state.params.parameters()]).all())
    _require(finite, "lm train (a): a parameter is not finite after the 2-microbatch step")
    _require(math.isfinite(float(met["grad_norm"])) and float(met["grad_norm"]) > 0,
             "lm train (a): the 2-microbatch step's grad_norm is not finite and positive")
    print(f"lm train (a) 2 microbatches: loss {mb_loss[1]:.6f} against the whole batch's "
          f"{mb_loss[0]:.6f} (rel {abs(mb_loss[1] - mb_loss[0]) / abs(mb_loss[0]):.3e}, bar "
          f"1e-3); grad_norm {float(met['grad_norm']):.4f}; parameters finite; "
          f"{time.perf_counter() - t1:.1f} s")
    full = dict(full, state=None)
    del state, model, met, batch, step2
    gc.collect()
    torch.cuda.empty_cache()
    attn_ms = _time_attention(dev, cfg, LM_BATCH, seq)
    attn_step = cfg.num_layers * (2 * attn_ms[0] + attn_ms[1])
    print(f"lm train: one layer's plain attention at {LM_BATCH} × {seq}: forward "
          f"{attn_ms[0]:.3f} ms, backward {attn_ms[1]:.3f} ms; × {cfg.num_layers} layers × "
          f"(forward, recompute, backward) = {attn_step:.3f} ms, "
          f"{100 * attn_step / (span_ms / timed):.1f}% of a timed step [{card}]")
    gc.collect()
    torch.cuda.empty_cache()

    # (b) reduced runs on the card: the target, PFAIT = sync + K, replay,
    # a checkpointed run resumed
    t1 = time.perf_counter()
    small = {}
    common = dict(LM_SMALL, target_loss=LM_TARGET, device=dev)
    small["sync K=0 seed 1"] = train(LM_ARCH, steps=150, monitor_mode="sync", seed=1, **common)
    small["pfait K=4 seed 1"] = train(LM_ARCH, steps=150, monitor_mode="pfait", staleness=4,
                                      seed=1, **common)
    for mode, k in (("sync", 0), ("pfait", 3), ("nfais2", 3)):
        small[f"{mode} K={k}"] = train(LM_ARCH, steps=120, monitor_mode=mode, staleness=k,
                                       **common)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        ck = dict(LM_SMALL, ckpt_dir=d, ckpt_every=10, seed=2, device=dev)
        small["ckpt 30"] = train(LM_ARCH, steps=30, **ck)
        small["ckpt resume 40"] = train(LM_ARCH, steps=40, **ck)
    for name, r in small.items():
        print(f"lm train (b) {name}: state at step {r['steps_run']}, stop at "
              f"{r['stop_step']}, {len(r['losses'])} losses read in {r['wall_s']:.3f} s (host "
              f"clock), last {r['losses'][-1]:.4f}")

    # the monitor ring through a checkpoint on the card, bitwise
    rcfg = reduced(cfg)
    m = model_mod.Model(rcfg, device=dev)
    opt = AdamW(constant_schedule(1e-3))
    mon = detection.for_mode("pfait", eps_tilde=LM_TARGET, staleness=3, persistence=4, ord=1.0)
    fn, _ = m.make_train_step(opt, monitor=mon)
    st = m.init_train_state(torch.Generator(device=dev).manual_seed(0), opt, monitor=mon)
    dc = DataConfig(seed=0, vocab_size=rcfg.vocab_size)
    for i in range(6):
        st, _ = fn(st, {k: torch.from_numpy(v).to(dev) for k, v in synth_batch(dc, i, 2, 32).items()})
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        ckpt = Checkpointer(d)
        ckpt.save(interop.train_state_tree(st), 6)
        ckpt.wait()
        tree, _ = ckpt.restore(like=interop.train_state_tree(st), device=dev)
    back = interop.train_state_from(tree, m)
    ring_equal = bool(torch.isfinite(st.monitor.ring).all()) and all(
        a.dtype == b.dtype and a.device == b.device and torch.equal(a, b)
        for a, b in zip(back.monitor, st.monitor)) and torch.equal(back.step, st.step)
    print(f"lm train (b) monitor ring through a checkpoint: {st.monitor.ring.tolist()} "
          f"restored bitwise: {ring_equal}; (b) took {time.perf_counter() - t1:.1f} s")

    # (c) the same reduced f32 state on the card and on the CPU
    fcfg = reduced(cfg, dtype="float32")
    on = {}
    for where in ("cpu", dev):
        mm = model_mod.Model(fcfg, device=where)
        opt = AdamW(cosine_schedule(3e-3, 1, LM_CPU_STEPS))
        if where == "cpu":
            s0 = mm.init_train_state(torch.Generator().manual_seed(0), opt)
            tree0 = interop.train_state_tree(s0)
        else:
            s0 = interop.train_state_from(tree0, mm)
        fn, _ = mm.make_train_step(opt)
        series = []
        for i in range(LM_CPU_STEPS):
            b = {k: torch.from_numpy(v).to(where)
                 for k, v in synth_batch(DataConfig(vocab_size=fcfg.vocab_size), i, 4, 64).items()}
            s0, met = fn(s0, b)
            series.append((float(met["loss"]), float(met["grad_norm"])))
        on[str(where)] = series
    cpu = (on[str(dev)], on["cpu"])
    print("lm train (c) reduced f32, card against CPU: " + "; ".join(
        f"step {i} loss {a[0]:.7f} / {b[0]:.7f}, grad_norm {a[1]:.7f} / {b[1]:.7f}"
        for i, (a, b) in enumerate(zip(*cpu))))
    return LMTrainRun(full=full, metrics=metrics, step_ms=step_ms, span_ms=span_ms,
                      busy_ms=busy_us / 1e3, syncs=probe.syncs, peak_bytes=peak,
                      mb_loss=mb_loss, attn_ms=attn_ms, small=small, ring_equal=ring_equal,
                      cpu=cpu)


def _replay_fire_step(losses, eps, K, mode, m=4):
    """Host replay of ``core/detection.step`` on a recorded loss series
    (``tests/test_train_loop.py:21-38``): the step the monitor must fire
    at, the visible value K steps stale."""
    persist = 0
    for k in range(len(losses)):
        vis = losses[k - K] if k >= K else INF
        below = vis < eps
        if mode in ("sync", "pfait"):
            if below:
                return k
        else:
            persist = persist + 1 if below else 0
            if persist >= m:
                return k
    return None


def verify_lm_train(out: LMTrainRun) -> None:
    import math

    from repro_torch.configs.registry import get_arch

    vocab = get_arch(LM_ARCH).vocab_size
    ln_vocab = math.log(vocab)
    losses = [l for l, _ in out.metrics]
    _require(len(out.metrics) == LM_STEPS, "lm train (a): not every step reported metrics")
    _require(all(math.isfinite(l) and math.isfinite(g) and g > 0 for l, g in out.metrics),
             f"lm train (a): a loss or grad_norm is not finite and positive: {out.metrics}")
    _require(abs(losses[0] - ln_vocab) <= 1.0,
             f"lm train (a): first loss {losses[0]:.4f} not within 1.0 of ln {vocab}")
    _require(losses[-1] < losses[0], f"lm train (a): the loss did not fall: {losses}")
    _require(out.full["losses"] == losses[:len(out.full["losses"])],
             "lm train (a): the losses train() read are not the steps' own")
    _require(out.full["steps_run"] == LM_STEPS, "lm train (a): wrong step count")
    _require(abs(out.mb_loss[1] - out.mb_loss[0]) <= 1e-3 * abs(out.mb_loss[0]),
             f"lm train (a): 2 microbatches' loss {out.mb_loss[1]} is not the whole batch's "
             f"{out.mb_loss[0]} within rtol 1e-3")
    small = out.small
    sync, pfait = small["sync K=0 seed 1"], small["pfait K=4 seed 1"]
    _require(sync["stop_step"] is not None and pfait["stop_step"] is not None,
             "lm train (b): sync or pfait K = 4 never fired")
    _require(pfait["stop_step"] == sync["stop_step"] + 4,
             f"lm train (b): pfait fired at {pfait['stop_step']}, not sync's "
             f"{sync['stop_step']} + 4")
    for mode, k in (("sync", 0), ("pfait", 3), ("nfais2", 3)):
        r = small[f"{mode} K={k}"]
        want = _replay_fire_step(r["losses"], LM_TARGET, k, mode, r["monitor"].persistence)
        _require(r["stop_step"] is not None and r["stop_step"] == want,
                 f"lm train (b): {mode} K={k} fired at {r['stop_step']}, the host replay at "
                 f"{want}")
    _require(small["ckpt 30"]["steps_run"] == 30 and small["ckpt resume 40"]["steps_run"] == 40,
             "lm train (b): the checkpointed run did not resume to 40 steps")
    _require(out.ring_equal, "lm train (b): the restored monitor state is not bitwise the saved")
    for i, (a, b) in enumerate(zip(*out.cpu)):
        for what, x, y in (("loss", a[0], b[0]), ("grad_norm", a[1], b[1])):
            _require(abs(x - y) <= LM_CPU_RTOL * abs(y),
                     f"lm train (c): step {i} {what} {x} on the card, {y} on the CPU")
    print(f"lm train: checks passed — first loss {losses[0]:.4f} (ln {vocab} = {ln_vocab:.4f}), "
          f"last {losses[-1]:.4f}; sync fired at {sync['stop_step']}, pfait K = 4 at "
          f"{pfait['stop_step']}; fire steps equal the host replay; resumed 30 → 40; ring "
          f"bitwise; card within rtol {LM_CPU_RTOL:g} of the CPU")


# ---------------------------------------------------------------------------
# phase 15: the other model families
# ---------------------------------------------------------------------------

# (a) hymba-1.5b (hybrid, window 2048: the slice's main path), (b)
# musicgen-medium (audio frontend) and (c) mamba2-130m (attention-free) at
# full width through launch.serve.serve, bf16, seed-0 weights: (batch,
# prompt length, new tokens).  Nothing is cut; prompts past hymba's window
# make #6 skip tiles
FAMILY_SERVE = {"hymba-1.5b": (4, 4096, 64), "musicgen-medium": (4, 2048, 64),
                "mamba2-130m": (4, 4096, 64)}
# the decode checks: a prefill over S − n positions plus n decode steps fed
# the prompt's last n positions against the prefill over S; with an SSM,
# S − n must be a multiple of the SSD chunk (128), as JAX asserts
FAMILY_DECODE = {"hymba-1.5b": 128, "musicgen-medium": 1, "mamba2-130m": 128}
# (d) llama4-maverick at full width with its depth cut to one unit of its
# scan period (a dense layer, then a MoE layer of 128 experts), ≈ 37 GB in
# bf16, through launch.serve.generate at batch 2, 512-token prompts
MOE_ARCH, MOE_LAYERS, MOE_BATCH, MOE_PROMPT, MOE_NEW = \
    "llama4-maverick-400b-a17b", 2, 2, 512, 8
# (c) mamba2-130m training through launch.train.train at TRAIN_4K's 4096
# tokens a sequence, batch 4 (its global batch of 256 cut for one card's
# step time), PFAIT K = 2 on the loss: one warm-up step, 4 timed
SSM_TRAIN_BATCH = 4
# the #6 shape each served family must launch at, once a layer
FAMILY_FLASH = {"hymba-1.5b": HYMBA_FLASH, "musicgen-medium": MUSICGEN_FLASH,
                MOE_ARCH: LLAMA4_FLASH}
# the main paths' prefill shapes phase 3 times, each with its batch (the
# SDPA layout [B, N·P, S, H]): phase 7's, phase 15's, phase 17's and 18's
FLASH_TIMED = ((SERVE_FLASH, SERVE_BATCH),
               *((case, FAMILY_SERVE[arch][0]) for arch, case in FAMILY_FLASH.items()
                 if arch != MOE_ARCH),
               (LLAMA4_FLASH, MOE_BATCH), (TP_FLASH, SERVE_BATCH), (EP_FLASH, MOE_BATCH),
               (HYMBA_TP_FLASH, 1))
# (e) every family, reduced and in f32, on the card against the CPU
FAMILY_ARCHS = ("grok-1-314b", "llama4-maverick-400b-a17b", "mamba2-130m", "hymba-1.5b",
                "musicgen-medium", "llava-next-34b")
FAMILY_CPU_RTOL = 1e-4


def _flash_key(case) -> tuple:
    """A ``FLASH_CASES`` entry as the key ``flash_attention.LAUNCH_SHAPES``
    counts a launch under (Sq = Skv)."""
    BH, BN, S, H, causal, window, dt = case
    return (BH, BN, S, S, H, causal, window, dt)


def _family_prompts(cfg, batch, S, dev):
    """The serve path's prompts (``make_prompts``: token ids, or a
    frontend's normal embeddings) on ``dev``."""
    import torch

    from repro_torch.launch.serve import make_prompts

    F = cfg.frontend_dim if cfg.frontend else 0
    return torch.as_tensor(make_prompts(cfg.vocab_size, batch, S, 0, F), device=dev)


def _serve_family(arch: str, dev, card: str) -> dict:
    """``serve`` of ``arch`` at full width: one short serve first (its
    launches are not counted), then the counted serve.  #6 must launch once
    a layer in the one prefill (none for an attention-free model), #1–#5
    never; the logits must be finite."""
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.flash_attention import flash_attention as fk
    from repro_torch.launch.serve import serve

    cfg = get_arch(arch)
    batch, S, new = FAMILY_SERVE[arch]
    serve(arch, batch=batch, prompt_len=S, max_new=2, use_reduced=False, seed=0, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_launches()
    out = serve(arch, batch=batch, prompt_len=S, max_new=new, use_reduced=False, seed=0,
                device=dev)
    torch.cuda.synchronize()
    used, shapes = _launches(), Counter(fk.LAUNCH_SHAPES)
    steps = out["steps"]
    want = cfg.num_layers if cfg.has_attention else 0
    print(f"families: serve {arch} full width (bf16, {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}), batch {batch}, prompt {S}, max_new {new}: tokens "
          f"{out['tokens'].shape}, steps {steps}, stopped_by {out['stopped_by']}, prefill "
          f"{1e3 * out['prefill_s']:.3f} ms, decode {1e3 * out['decode_s'] / steps:.3f} ms/step "
          f"({batch * steps / out['decode_s']:.1f} tok/s in the decode loop), peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; launches "
          f"{json.dumps(used)}; #6 shapes {dict(shapes)} [{card}]")
    _require(used["flash_attention_flat"] == want,
             f"families {arch}: {used['flash_attention_flat']} flash launches, want {want} "
             f"(one a layer in the prefill)")
    key = _flash_key(FAMILY_FLASH[arch]) if want else None
    _require(not want or shapes == {key: want},
             f"families {arch}: #6 launched at {dict(shapes)}, want {key} only")
    _require(sum(used.values()) == want, f"families {arch}: a stencil kernel launched: {used}")
    _require(out["logits_finite"], f"families {arch}: NaN or inf in the logits")
    _require(out["tokens"].shape[0] == batch and 1 <= out["tokens"].shape[1] <= new
             and out["stopped_by"] in ("budget", "detector"), f"families {arch}: {out}")
    return dict(out=out, used=used, shapes=shapes)


def _in_model_f32(arch: str, dev) -> dict:
    """The serve run's weights in f32 (the bf16 draw cast, every op in
    f32): the prefill logits with #6 against the plain attention, max|Δ| ≤
    1e-4 × max|logit| (phase 7's bar), and a prefill over S − n plus n
    decode steps fed the prompt's last n positions against the prefill
    over S at the JAX bar (``FAMILY_DECODE``)."""
    import dataclasses as dc

    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.models import layers as L
    from repro_torch.models.model import Model
    from repro_torch.models.transformer import forward

    cfg = get_arch(arch)
    batch, S, _ = FAMILY_SERVE[arch]
    n = FAMILY_DECODE[arch]
    params = Model(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(0)).float()
    m = Model(dc.replace(cfg, dtype="float32"), device=dev)
    prompts = _family_prompts(cfg, batch, S, dev)
    prefill, decode = m.make_prefill(), m.make_decode_step()
    res = {}
    with torch.inference_mode():
        kern, _ = prefill(params, prompts)
        if cfg.has_attention:
            x, head, _, _ = forward(params, prompts, m.plan,
                                    m._ctx("prefill")._replace(use_kernel=False))
            plain = L.lm_head(x[:, -1:], head)
            del x
            res["kernel"] = (_maxdiff(kern, plain), float(plain.abs().max()))
        _, cache = prefill(params, prompts[:, :S - n], max_len=S)
        for i in range(S - n, S):
            logits, cache = decode(params, cache, prompts[:, i:i + 1], i)
        res["decode"] = _jax_bar(logits, kern)
        res["finite"] = bool(kern.isfinite().all()) and bool(logits.isfinite().all())
    del params, cache
    torch.cuda.empty_cache()
    line = f"families: {arch} in-model, f32:"
    if "kernel" in res:
        err, scale = res["kernel"]
        line += (f" prefill logits flash kernel vs plain attention max|Δ| {err:.3e} over "
                 f"logits up to {scale:.3e} ({err / scale:.2e} of the largest; tolerance 1e-4);")
    print(f"{line} prefill over {S - n} + {n} decode steps vs prefill over {S}: worst "
          f"element at {res['decode']:.4f} of the JAX bar (atol 5e-2 + rtol 1e-2)")
    _require(res["finite"], f"families {arch}: non-finite f32 logits")
    if "kernel" in res:
        _require(res["kernel"][0] <= 1e-4 * res["kernel"][1],
                 f"families {arch}: f32 in-model, the flash kernel departs from the plain "
                 f"attention")
    _require(res["decode"] <= 1.0, f"families {arch}: f32 decode departs from prefill")
    return res


def _train_ssm(dev, card: str) -> dict:
    """(c) mamba2-130m trained at full width through ``train``, timed with
    phase 14's probe: every loss and grad_norm finite, the first loss
    within 1.0 of ln V, finite parameters, no kernel launched."""
    import math

    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch.configs.base import TRAIN_4K
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.train import train
    from repro_torch.models import model as model_mod

    arch, seq = "mamba2-130m", TRAIN_4K.seq_len
    cfg = get_arch(arch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   schedule=schedule(wait=0, warmup=1, active=LM_STEPS - 1, repeat=1))
    probe = _StepProbe(prof, sync_step=LM_STEPS - 1)
    built = model_mod.Model.make_train_step

    def probed_build(self, *args, **kw):
        step, mon = built(self, *args, **kw)
        return probe.wrap(step), mon

    model_mod.Model.make_train_step = probed_build
    _reset_launches()
    try:
        with prof:
            out = train(arch, steps=LM_STEPS, batch=SSM_TRAIN_BATCH, seq=seq,
                        use_reduced=False, monitor_mode="pfait", staleness=LM_K, seed=0,
                        log_every=1, device=dev)
            torch.cuda.synchronize()
    finally:
        model_mod.Model.make_train_step = built
    used = _launches()
    peak = torch.cuda.max_memory_allocated(dev)
    metrics = [(float(m["loss"]), float(m["grad_norm"])) for m in probe.metrics]
    step_ms = [a.elapsed_time(b) for a, b in probe.events]
    span_ms = probe.events[1][0].elapsed_time(probe.events[-1][1])
    busy_us, kernels, _ = _profile_rows(prof, top=6)
    finite = bool(torch.stack([torch.isfinite(p).all()
                               for p in out["state"].params.parameters()]).all())
    timed = LM_STEPS - 1
    ln_v = math.log(cfg.vocab_size)
    print(f"families: train {arch} full width ({cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"SSD chunk 128), batch {SSM_TRAIN_BATCH} × {seq}, bf16, remat block, PFAIT K = "
          f"{LM_K}: warm-up step {step_ms[0]:.3f} ms, timed steps "
          f"{', '.join(f'{t:.3f}' for t in step_ms[1:])} ms; {span_ms / timed:.3f} ms a step "
          f"({SSM_TRAIN_BATCH * seq * timed / (span_ms / 1e3):.1f} tokens/s); peak memory "
          f"{peak / 2**30:.2f} GiB; device busy {100 * busy_us / 1e3 / span_ms:.1f}%; "
          f"{len(probe.syncs)} synchronising CUDA calls inside step {LM_STEPS - 1}; losses "
          + ", ".join(f"{l:.4f}" for l, _ in metrics) + "; grad norms "
          + ", ".join(f"{g:.4f}" for _, g in metrics) + f"; ln(vocab) {ln_v:.4f}; launches "
          f"{json.dumps(used)} [{card}]")
    for t, c, k in kernels:
        print(f"  {t:9.3f} ms  {c:6d}×  {k[:90]}")
    _require(not any(used.values()), f"families: mamba2 training launched a kernel: {used}")
    _require(len(metrics) == LM_STEPS and all(math.isfinite(l) and math.isfinite(g) and g > 0
                                              for l, g in metrics),
             f"families: mamba2 training, a loss or grad_norm is not finite: {metrics}")
    _require(abs(metrics[0][0] - ln_v) <= 1.0,
             f"families: mamba2 first loss {metrics[0][0]:.4f} not within 1.0 of ln V")
    _require(finite, "families: a mamba2 parameter is not finite after training")
    del out, prof, probe
    torch.cuda.empty_cache()
    return dict(metrics=metrics, step_ms=step_ms, span_ms=span_ms, peak=peak)


def _serve_moe(dev, card: str) -> dict:
    """(d) the cut llama4-maverick through ``generate``: one short run
    first (uncounted), then the counted one; #6 twice a prefill, finite
    logits; then the MoE sub-layer's share of a prefill (CUDA events, 3
    calls each after the runs above)."""
    import dataclasses as dc

    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.flash_attention import flash_attention as fk
    from repro_torch.launch.serve import generate
    from repro_torch.models.model import Model
    from repro_torch.models.transformer import _ffn_sublayer

    cfg = dc.replace(get_arch(MOE_ARCH), num_layers=MOE_LAYERS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    m = Model(cfg, device=dev)
    t0 = time.perf_counter()
    params = m.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    nbytes = sum(p.numel() * p.element_size() for p in params.parameters())
    prompts = _family_prompts(cfg, MOE_BATCH, MOE_PROMPT, dev)
    generate(m, params, prompts, 2)
    torch.cuda.synchronize()
    _reset_launches()
    out = generate(m, params, prompts, MOE_NEW)
    torch.cuda.synchronize()
    used, shapes = _launches(), Counter(fk.LAUNCH_SHAPES)
    prefill = m.make_prefill()
    ctx = m._ctx("prefill")
    h = torch.randn((MOE_BATCH, MOE_PROMPT, cfg.d_model), generator=torch.Generator(
        device=dev).manual_seed(1), device=dev).to(torch.bfloat16)

    def events(fn, reps=3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        with torch.inference_mode():
            fn()
            ev[0].record()
            for _ in range(reps):
                fn()
            ev[1].record()
        torch.cuda.synchronize()
        return ev[0].elapsed_time(ev[1]) / reps

    prefill_ms = events(lambda: prefill(params, prompts))
    moe_ms = events(lambda: _ffn_sublayer(params.layers[1], h, ctx))
    # phase 17(c)'s tp = 1 twin: the last position's logits of this prefill
    twin = prefill(params, prompts)[0].float().cpu()
    plan = m.plan.moe
    flops = 2 * MOE_BATCH * MOE_PROMPT * cfg.d_model * plan.d_ff_virtual \
        * plan.virtual_experts * (3 if cfg.gated_mlp else 2)
    steps = out["steps"]
    print(f"families: serve {MOE_ARCH} full width cut to {MOE_LAYERS} layers (a dense and a "
          f"MoE layer, {plan.num_experts} experts of {cfg.d_ff}, top-{plan.top_k}, shared "
          f"expert; {nbytes / 1e9:.2f} GB of bf16 parameters drawn in {t_init:.1f} s), batch "
          f"{MOE_BATCH}, prompt {MOE_PROMPT}, max_new {MOE_NEW}: tokens {out['tokens'].shape}, "
          f"steps {steps}, prefill {1e3 * out['prefill_s']:.3f} ms in the run, "
          f"{prefill_ms:.3f} ms warm (CUDA events), decode {1e3 * out['decode_s'] / steps:.3f} "
          f"ms/step; the MoE sub-layer (dense one-hot reference, every expert on every token, "
          f"{flops:.3e} FLOPs) {moe_ms:.3f} ms, {100 * moe_ms / prefill_ms:.1f}% of the prefill, "
          f"{flops / (moe_ms / 1e3) / 1e12:.1f} TFLOP/s; peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; launches {json.dumps(used)}; "
          f"#6 shapes {dict(shapes)} [{card}]")
    _require(used["flash_attention_flat"] == MOE_LAYERS and sum(used.values()) == MOE_LAYERS
             and shapes == {_flash_key(FAMILY_FLASH[MOE_ARCH]): MOE_LAYERS},
             f"families {MOE_ARCH}: launches {used} at {dict(shapes)}, want #6 once a layer "
             f"in the prefill at {_flash_key(FAMILY_FLASH[MOE_ARCH])}")
    _require(out["logits_finite"], f"families {MOE_ARCH}: NaN or inf in the logits")
    del params, h
    torch.cuda.empty_cache()
    return dict(out=out, used=used, shapes=shapes, moe_ms=moe_ms, prefill_ms=prefill_ms,
                twin=twin)


def _card_vs_cpu(dev) -> list:
    """(e) every family, reduced and in f32, from one CPU-drawn state: the
    prefill's logits and 3 train steps' losses and grad norms on the card
    against the CPU, within rtol 1e-4 (phase 14(c)'s bar; the logits
    against the largest)."""
    import torch

    from repro_torch import interop
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.models.model import Model
    from repro_torch.optim import AdamW, cosine_schedule

    rows = []
    for arch in FAMILY_ARCHS:
        cfg = reduced(get_arch(arch), dtype="float32")
        F = cfg.frontend_dim if cfg.frontend else 0
        on = {}
        for where in ("cpu", dev):
            mm = Model(cfg, device=where)
            opt = AdamW(cosine_schedule(3e-3, 1, LM_CPU_STEPS))
            if where == "cpu":
                s0 = mm.init_train_state(torch.Generator().manual_seed(0), opt)
                tree0 = interop.train_state_tree(s0)
            else:
                s0 = interop.train_state_from(tree0, mm)
            logits, _ = mm.make_prefill()(s0.params, _family_prompts(cfg, 2, 64, where))
            fn, _ = mm.make_train_step(opt)
            series = []
            for i in range(LM_CPU_STEPS):
                b = {k: torch.from_numpy(v).to(where) for k, v in synth_batch(
                    DataConfig(vocab_size=cfg.vocab_size, frontend_dim=F), i, 4, 64).items()}
                s0, met = fn(s0, b)
                series.append((float(met["loss"]), float(met["grad_norm"])))
            on[str(where)] = (logits.cpu(), series)
        (lg, card), (lc, cpu) = on[str(dev)], on["cpu"]
        err = _maxdiff(lg, lc) / float(lc.abs().max())
        worst = max(abs(a - b) / abs(b) for x, y in zip(card, cpu) for a, b in zip(x, y))
        rows.append((arch, err, worst))
        print(f"families (e) {arch} reduced f32, card against CPU: prefill logits max|Δ| "
              f"{err:.2e} of the largest; 3 steps' losses and grad norms within {worst:.2e} "
              f"relative (losses {', '.join(f'{a[0]:.6f}' for a in card)})")
        _require(err <= FAMILY_CPU_RTOL and worst <= FAMILY_CPU_RTOL,
                 f"families (e) {arch}: the card departs from the CPU")
    return rows


def run_families(dev) -> dict:
    """Phase 15: (a) hymba-1.5b, (b) musicgen-medium and (c) mamba2-130m
    served at full width, each with its f32 in-model checks, (c) trained at
    full width, (d) the cut llama4-maverick served, (e) every family on
    the card against the CPU.  Each counted run sets the launch counters
    to 0 just before it and reads them just after."""
    import gc

    import torch

    card = nvidia_smi()
    t0 = time.perf_counter()
    out = {}
    for arch in FAMILY_SERVE:
        out[arch] = _serve_family(arch, dev, card)
        gc.collect()
        torch.cuda.empty_cache()
        out[arch]["f32"] = _in_model_f32(arch, dev)
    out["train"] = _train_ssm(dev, card)
    gc.collect()
    out[MOE_ARCH] = _serve_moe(dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    out["cpu"] = _card_vs_cpu(dev)
    print(f"families: phase 15 took {time.perf_counter() - t0:.1f} s [{card}]")
    return out


# phase 16: the event engine (core/async_engine.py) and its protocols, with
# the problems' blocks on the card and every sweep a kernel launch.  (a)
# Tables 4-5 at the paper's smaller grid, n = 150, as the JAX package's
# benchmarks/common.py:run_cell sets them up (rho 0.93, the hybrid sweep,
# l∞, stable_platform(), seed 0, max_iters 60000): PFAIT at ε̃/10 and the
# snapshot protocols at ε̃ on p = 50 (the paper's smallest, 48, does not
# divide 150), and PFAIT on p = 150
EVENT_RHO, EVENT_MAX_ITERS = 0.93, 60000
EVENT_RUNS = (("pfait", EPS_TILDE / 10, 50), ("nfais2", EPS_TILDE, 50),
              ("nfais5", EPS_TILDE, 50), ("pfait", EPS_TILDE / 10, 150))
# the JAX package's event engine on the same runs (host numpy f64;
# ``tests/_jax_event_reference.py`` prints them).  A run's counters and
# virtual times do not depend on the device, so the port must give them
# unless a comparison with ε flips by an f32 rounding of the residual
EVENT_JAX = {
    ("pfait", 50): dict(sweeps=9162, k_max=199, k_min=171, reductions=12,
                        wtime=0.20193031267451034, detect_time=0.19231917431460707,
                        msg_counts={"data": 31153}, msg_bytes={"data": 857142000},
                        detected_residual=2.485364447579741e-08),
    ("nfais2", 50): dict(sweeps=8486, k_max=183, k_min=156, reductions=2,
                         wtime=0.18701095898103, detect_time=0.17837981376044892,
                         msg_counts={"data": 28854, "snap2": 340},
                         msg_bytes={"data": 793926000, "snap2": 9360000},
                         detected_residual=2.601644215616261e-07),
    ("nfais5", 50): dict(sweeps=9125, k_max=198, k_min=168, reductions=2,
                         wtime=0.20148166159342515, detect_time=0.19192030895681614,
                         msg_counts={"data": 31026, "snap5": 340, "confirm5": 340},
                         msg_bytes={"data": 853614000, "snap5": 5440, "confirm5": 340},
                         detected_residual=5.2285875185020814e-08),
    ("pfait", 150): dict(sweeps=29483, k_max=217, k_min=182, reductions=10,
                         wtime=0.2176697458415222, detect_time=0.20510314578348643,
                         msg_counts={"data": 108130}, msg_bytes={"data": 1627836000},
                         detected_residual=1.895349477365471e-08),
}
EVENT_KERNELS = ("fused_sweep_residual", "fused_rbgs_sweep_residual", "diff_norm_partials")
# (b) the card against the CPU, reduced, all at seed 0: convdiff n = 24, p = 8
# (blocks 6×12×24, below one (4, 8) tile column: phase 2 holds them), every
# protocol × {hybrid, Jacobi} × {l∞, l2}; PageRank n = 256, p = 4, l1; the ML
# problem n = 16, p = 4 (lstsq, l2); every spec of scenario_registry() under
# PFAIT on the convdiff case.  Bars: x within 1e-12 of its largest element;
# r*, the detected and the detection instant's residuals within rtol 1e-6
# (l∞, one f32 rounding) or 1e-5 (l2, l1: an f32 sum), plus the f64 floor
# of a residual near convergence, 16·2^-53·S a cell (√N and N times that
# at l2 and l1; S the scale of the residual's terms), where the kernel's
# and the plain version's f64 orders part
EVENT_SMALL = dict(convdiff=(dict(n=24, p=8, rho=0.9), 1e-6),
                   pagerank=(dict(n=256, p=4, ord=1.0), 1e-9),
                   mlfixed=(dict(n=16, p=4, m_rows=64), 1e-6))
EVENT_RTOL = {INF: 1e-6, 2.0: 1e-5, 1.0: 1e-5}


class EventRun(NamedTuple):
    """One event-engine run: its result and recorder, the final blocks (on
    the host), setup and run walls, device→host reads and launches."""

    res: object
    rec: object
    x: list
    setup_s: float
    run_s: float
    syncs: int
    used: dict


def _event_run(prob, cfg, proto, record_sends=True, stride=0) -> EventRun:
    import torch

    from repro_torch.core.async_engine import AsyncEngine
    from repro_torch.core.reliability import TraceRecorder

    cuda = torch.cuda.is_available()
    before = _launches()
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec = TraceRecorder(residual_stride=stride, record_sends=record_sends)
    eng = AsyncEngine(prob, cfg, proto, recorder=rec)
    if cuda:
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    res = eng.run()
    if cuda:
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    x = [xi.cpu().numpy() for xi in eng.x]
    return EventRun(res, rec, x, t1 - t0, t2 - t1, prob.syncs,
                    {k: v - before[k] for k, v in _launches().items()})


def _event_cfg(platform="stable", scenario=None, fifo=False, max_iters=EVENT_MAX_ITERS):
    """Seed 0 on ``platform``'s preset, or on the platform of the
    ``scenario_registry()`` spec named ``scenario`` with its effects."""
    from repro_torch.core.async_engine import PLATFORMS
    from repro_torch.core.scenarios import scenario_registry

    if scenario is not None:
        spec = scenario_registry()[scenario]
        platform, scenario = spec.platform, spec.scenario
    return dataclasses.replace(PLATFORMS[platform](), seed=0, max_iters=max_iters,
                               fifo=fifo, scenario=scenario)


def _protocol(name, eps, ord):
    from repro_torch.core.protocols import PROTOCOLS

    return PROTOCOLS[name](eps, ord=ord)


def run_events_large(dev) -> list:
    """(a): the four n = 150 runs on the card, each under a ``TraceRecorder``
    and scored by ``detection_report``; returns ``[(key, eps, EventRun,
    report)]``."""
    from repro_torch.core.reliability import detection_report
    from repro_torch.solvers.convdiff import ConvDiffProblem

    out = []
    for proto, eps, p in EVENT_RUNS:
        prob = ConvDiffProblem(n=SHARD_N, p=p, rho=EVENT_RHO, seed=0, sweep="hybrid",
                               ord=INF, device=dev)
        run = _event_run(prob, _event_cfg(), _protocol(proto, eps, prob.ord),
                         record_sends=False)
        out.append(((proto, p), eps, run, detection_report(run.rec, eps)))
    return out


def verify_events_large(large, card: str) -> None:
    """(a)'s checks: every run terminates with r* < ε̃, its counters and
    virtual times are JAX's (``EVENT_JAX``), #2 launched once a sweep;
    prints each run's numbers and the PFAIT/NFAIS2 ratios."""
    by = {}
    for key, eps, run, rep in large:
        res, want = run.res, EVENT_JAX[key]
        got = dict(sweeps=len(run.rec.sweep_events()), k_max=res.k_max, k_min=res.k_min,
                   reductions=res.reductions, wtime=res.wtime, detect_time=res.detect_time,
                   msg_counts=res.msg_counts, msg_bytes=res.msg_bytes)
        by[key] = got
        sweeps = got["sweeps"]
        u = run.used
        print(f"events (a) {key[0]} p = {key[1]} (blocks {SHARD_N // _grid(key[1])[0]}×"
              f"{SHARD_N // _grid(key[1])[1]}×{SHARD_N}), ε {eps:g}: terminated "
              f"{res.terminated}, k_max {res.k_max}, k_min {res.k_min}, virtual wtime "
              f"{res.wtime!r} s, reductions {res.reductions}, sweeps {sweeps}; wall "
              f"{run.run_s:.3f} s (setup {run.setup_s:.3f} s), {sweeps / run.run_s:.1f} "
              f"sweeps/s, {1e3 * run.run_s / sweeps:.4f} ms a sweep, {run.syncs} syncs; "
              f"launches #1 {u['fused_sweep_residual']}, #2 {u['fused_rbgs_sweep_residual']}, "
              f"#5 {u['diff_norm_partials']}; r* {res.r_star:.4e}, detected "
              f"{res.detected_residual:.4e}; oracle: false detection {rep.false_detection}, "
              f"true at detect {rep.true_at_detect:.4e} (overshoot {rep.overshoot:.3f} of ε) "
              f"[{card}]")
        _require(res.terminated, f"events (a) {key}: did not terminate")
        _require(res.r_star < EPS_TILDE, f"events (a) {key}: r* {res.r_star:.3e} >= ε̃ "
                                         f"{EPS_TILDE:g} (false detection)")
        _require(not rep.false_detection, f"events (a) {key}: the oracle finds a false "
                                          f"detection")
        _require(u["fused_rbgs_sweep_residual"] == sweeps,
                 f"events (a) {key}: #2 launched {u['fused_rbgs_sweep_residual']} times "
                 f"for {sweeps} hybrid sweeps")
        same = all(got[k] == want[k] for k in got)
        if not same:
            # the one allowed departure: a detection moved by an f32 rounding
            # of the residual at a comparison with ε
            dist = {w: abs(r - eps) / eps for w, r in (("port", res.detected_residual),
                                                       ("JAX", want["detected_residual"]))}
            print(f"events (a) {key}: counters depart from JAX's engine: port {got}, JAX "
                  f"{ {k: want[k] for k in got} }; detected residuals' distance to ε: "
                  f"{dist}")
            _require(min(dist.values()) <= EVENT_RTOL[INF],
                     f"events (a) {key}: counters depart from JAX's with no detection "
                     f"near ε")
        else:
            print(f"events (a) {key}: sweeps, k_max, k_min, reductions, wtime, detect_time "
                  f"and message counts and bytes equal JAX's engine")
    (pf, n2, n5) = (by[proto, p] for proto, _, p in EVENT_RUNS[:3])
    print(f"events (a) p = {EVENT_RUNS[0][2]}, the paper's structure: PFAIT/NFAIS2 wtime "
          f"{pf['wtime'] / n2['wtime']:.4f}, k_max {pf['k_max'] / n2['k_max']:.4f}; "
          f"PFAIT/NFAIS5 wtime {pf['wtime'] / n5['wtime']:.4f}, k_max "
          f"{pf['k_max'] / n5['k_max']:.4f}")


def _grid(p):
    from repro_torch.solvers.partition import process_grid

    return process_grid(p)


def _f64_floor(family, prob, x, ord) -> float:
    """The f64 floor of ``prob``'s residual at the state ``x`` (host
    numpy) in the norm ``ord``: 16·2^-53·S a cell, √N or N times that."""
    import numpy as np

    a = np.abs(np.concatenate([np.ravel(v) for v in x]))
    if family == "convdiff":
        st = prob.st
        off = sum(abs(c) for c in st.coefs[1:])
        scale = float(np.abs(prob.b_global).max() + (abs(st.diag) + off) * a.max())
    elif family == "pagerank":
        scale = float((prob.d * (prob.to_dense() @ a)).max() + prob.v + a.max())
    else:
        scale = prob.gamma * float((np.abs(prob.H) @ a + np.abs(prob.c)).max())
    cell = 16 * F64_UNIT * scale
    return {INF: cell, 2.0: a.size ** 0.5 * cell, 1.0: a.size * cell}[float(ord)]


def _event_small_cases() -> list:
    """(b)'s runs: ``(label, family, problem kwargs, protocol, ε, config
    kwargs)``."""
    from repro_torch.core.protocols import PROTOCOLS
    from repro_torch.core.scenarios import scenario_registry

    cases = []
    base, eps = EVENT_SMALL["convdiff"]
    for proto in PROTOCOLS:
        for sweep in ("hybrid", "jacobi"):
            for ord in (INF, 2.0):
                cases.append((f"convdiff {proto} {sweep} {_ord_tag(ord)}", "convdiff",
                              dict(base, sweep=sweep, ord=ord), proto, eps,
                              dict(fifo=proto == "exact_snapshot")))
    for family in ("pagerank", "mlfixed"):
        kw, feps = EVENT_SMALL[family]
        for proto in PROTOCOLS:
            cases.append((f"{family} {proto}", family, kw, proto, feps,
                          dict(fifo=proto == "exact_snapshot")))
    for name in scenario_registry():
        cases.append((f"convdiff pfait scenario {name}", "convdiff", dict(base), "pfait", eps,
                      dict(scenario=name)))
    return cases


def _near(got, want, rtol, floor) -> bool:
    if want in (INF, 0.0):
        return got == want
    return abs(got - want) <= rtol * abs(want) + floor


def _small_problem(family, kw, where):
    from repro_torch.solvers.convdiff import ConvDiffProblem
    from repro_torch.solvers.mlfixed import MLFixedPointProblem
    from repro_torch.solvers.pagerank import PageRankProblem

    make = dict(convdiff=ConvDiffProblem, pagerank=PageRankProblem,
                mlfixed=MLFixedPointProblem)[family]
    return make(seed=0, device=where, **kw)


def _small_run(case, where) -> EventRun:
    _, family, kw, proto, eps, ckw = case
    prob = _small_problem(family, kw, where)
    return _event_run(prob, _event_cfg(**ckw), _protocol(proto, eps, prob.ord), stride=25)


def _small_run_on_cpu(case) -> EventRun:
    """One of (b)'s CPU runs, in a worker process (one thread)."""
    import torch

    torch.set_num_threads(1)
    return _small_run(case, "cpu")


def run_events_small(dev) -> list:
    """(b): each case on the card here while a pool of spawned CPU
    processes runs it again on the CPU; returns ``[(label, family, ord,
    floor, card EventRun, cpu EventRun)]``."""
    import multiprocessing
    import os

    cases = _event_small_cases()
    procs = max(1, min(len(cases), (os.cpu_count() or 2) - 2))
    with multiprocessing.get_context("spawn").Pool(procs) as pool:
        pending = pool.map_async(_small_run_on_cpu, cases)
        cards = [_small_run(case, dev) for case in cases]
        cpus = pending.get(timeout=600)
    out = []
    for case, card, cpu in zip(cases, cards, cpus):
        label, family, kw = case[:3]
        prob = _small_problem(family, kw, "cpu")
        floor = _f64_floor(family, prob, cpu.x, prob.ord)
        out.append((label, family, prob.ord, floor, card, cpu))
    return out


def verify_events_small(small) -> dict:
    """(b)'s checks: the card equals the CPU on events, counters and
    verdicts, x and the residuals within the bars.  Returns the worst
    relative departures."""
    import numpy as np

    worst = dict(x=0.0, r=0.0)
    for label, family, ord, floor, card, cpu in small:
        a, b = card.res, cpu.res
        _require(card.rec.sweep_events() == cpu.rec.sweep_events(),
                 f"events (b) {label}: sweep events differ on the card "
                 f"(detected {a.detected_residual!r} / {b.detected_residual!r})")
        _require([e for e in card.rec.events if e[0] != "detect"]
                 == [e for e in cpu.rec.events if e[0] != "detect"],
                 f"events (b) {label}: send or membership events differ on the card")
        for f in ("terminated", "detect_time", "wtime", "k_max", "k_min", "msg_counts",
                  "msg_bytes", "reductions", "msg_dropped"):
            _require(getattr(a, f) == getattr(b, f),
                     f"events (b) {label}: {f} {getattr(a, f)} on the card, {getattr(b, f)} "
                     f"on the CPU")
        scale = max(max(float(np.abs(v).max()) for v in cpu.x), 1e-300)
        dx = max(float(np.abs(u - v).max()) for u, v in zip(card.x, cpu.x)) / scale
        pairs = [("r*", a.r_star, b.r_star), ("detected", a.detected_residual,
                                               b.detected_residual)]
        for f in ("true_at_detect", "certified_at_detect", "active_at_detect"):
            u, v = getattr(card.rec, f), getattr(cpu.rec, f)
            _require((u is None) == (v is None), f"events (b) {label}: {f} present on one side")
            if v is not None:
                pairs.append((f, u, v))
        pairs += [(f"sample t={t:.4f}", u, v) for (t, u), (_, v)
                  in zip(card.rec.residual_samples, cpu.rec.residual_samples)]
        _require(len(card.rec.residual_samples) == len(cpu.rec.residual_samples),
                 f"events (b) {label}: residual samples differ in number")
        for what, u, v in pairs:
            _require(_near(u, v, EVENT_RTOL[float(ord)], floor),
                     f"events (b) {label}: {what} {u!r} on the card, {v!r} on the CPU "
                     f"(bar rtol {EVENT_RTOL[float(ord)]:g} + {floor:.2e})")
            if v not in (INF, 0.0):
                worst["r"] = max(worst["r"], abs(u - v) / abs(v))
        _require(dx <= 1e-12, f"events (b) {label}: x departs by {dx:.2e} of its largest")
        worst["x"] = max(worst["x"], dx)
        u = card.used
        print(f"events (b) {label}: terminated {a.terminated}, k_max {a.k_max}, k_min "
              f"{a.k_min}, reductions {a.reductions}, sweeps {len(card.rec.sweep_events())}; "
              f"x within {dx:.2e}, r* {a.r_star:.6e} / {b.r_star:.6e}; card {card.run_s:.3f} s "
              f"({card.syncs} syncs; #1 {u['fused_sweep_residual']}, #2 "
              f"{u['fused_rbgs_sweep_residual']}, #5 {u['diff_norm_partials']}), CPU "
              f"{cpu.run_s:.3f} s")
    print(f"events (b): {len(small)} runs equal on the card and on the CPU in events, "
          f"counters and verdicts; x within {worst['x']:.2e}, residuals within "
          f"{worst['r']:.2e} relative")
    return worst


def replay_card_traces(traces) -> None:
    """(c): phase 8's recorded ``repro-trace/1`` traces through the port's
    ``fit_cost_model`` and ``replay``: each validates, and its predicted
    wall is printed beside the measured one."""
    from repro_torch.core.trace import Trace, validate_trace
    from repro_torch.sim.calibrate import fit_cost_model
    from repro_torch.sim.replay import WhatIf, replay

    for name, text in traces:
        tr = Trace.loads(text)
        _require(validate_trace(tr), f"events (c) {name}: the trace fails validate()")
        cost, report = fit_cost_model(tr)
        v = replay(tr, cost)
        wide = replay(tr, cost, WhatIf(p=2 * tr.p))
        print(f"events (c) phase 8 {name}: measured wall {tr.meta['wall_s']:.4f} s over "
              f"{tr.meta['outer_iters']} steps; self-replay predicts {v.predicted_wall_s:.4f} s "
              f"(detect step {v.predicted_detect_step}, approximate {v.approximate}); sweep "
              f"{1e3 * cost.sweep_s:.4f} ms, hop {1e3 * cost.hop_s:.4f} ms (defaulted "
              f"{report['defaulted']}); at p = {2 * tr.p} it predicts "
              f"{wide.predicted_wall_s:.4f} s")


def run_events(dev, traces) -> dict:
    """Phase 16: (a) the n = 150 runs, (b) the reduced runs on the card
    and on the CPU, (c) the replay of phase 8's traces."""
    card = nvidia_smi()
    t0 = time.perf_counter()
    large = run_events_large(dev)
    t1 = time.perf_counter()
    small = run_events_small(dev)
    t2 = time.perf_counter()
    print(f"events: (a) {t1 - t0:.1f} s, (b) {t2 - t1:.1f} s [{card}]")
    hybrid = sum(len(r.rec.sweep_events()) for _, _, r, _ in large) + sum(
        len(c.rec.sweep_events()) for label, fam, _, _, c, _ in small
        if fam == "convdiff" and " jacobi " not in f" {label} ")
    return dict(large=large, small=small, traces=traces, hybrid_sweeps=hybrid, card=card,
                seconds=time.perf_counter() - t0)


def verify_events(out, used) -> None:
    """Phase 16's checks, after its launches were read."""
    verify_events_large(out["large"], out["card"])
    verify_events_small(out["small"])
    replay_card_traces(out["traces"])
    _require(used["fused_rbgs_sweep_residual"] == out["hybrid_sweeps"],
             f"events: #2 launched {used['fused_rbgs_sweep_residual']} times for "
             f"{out['hybrid_sweeps']} hybrid sweeps on the card")
    print(f"events: phase 16 took {out['seconds']:.1f} s; #2 launched once a hybrid sweep "
          f"({out['hybrid_sweeps']})")


# ---------------------------------------------------------------------------
# phase 17: the model's parallel layout, two gloo ranks sharing the card
# ---------------------------------------------------------------------------

# two ranks on the one H100 over gloo (NCCL refuses two ranks on one
# device), each tensor a collective moves staged through host memory.
# (a) qwen2-1.5b at full width on a make_host_mesh(model_axis=2) mesh:
# phase 7's prompts (batch 4 × 2048), the prefill padded for 8 decode steps
# fed the same seeded tokens as the tp = 1 twin; (b) one training step's
# worth at full width with TRAIN_4K's sequence length, batch 1 (the global
# 256 cut for one card's step time), 2 steps with the f32 reduction and 2
# with the bf16 one, each from the seed-0 state; (c) phase 15(d)'s cut
# llama4-maverick (a dense and a MoE layer) at batch 2 × 512, 64 experts a
# rank: at capacity factor Ev (C = tokens a rank × kr, nothing drops)
# against phase 15(d)'s tp = 1 prefill, then at factor 1.0
TP_RANKS = 2
TP_DECODE = 8
TP_TRAIN_BATCH, TP_TRAIN_STEPS = 1, 2
# the first TP training loss against the tp = 1 loss on the same weights and
# batch, and the bf16-reduce loss against the f32-reduce one (JAX's bar,
# tests/test_perf_variants.py:63-73)
TP_LOSS_RTOL, TP_BF16_LOSS_ATOL = 1e-3, 5e-3


def _tokens_for_decode(cfg, steps, batch):
    """The seeded tokens every decode step of (a) feeds, twin and ranks alike."""
    import numpy as np

    return np.random.default_rng(5).integers(3, cfg.vocab_size, (steps, batch, 1))


def _tp_batch(cfg, mesh=None):
    """(b)'s batch: ``synth_batch`` of step 0 at 1 × 4096 (the rank's rows)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import device_batches

    shape = ShapeConfig("tp_train", seq_len=4096, global_batch=TP_TRAIN_BATCH, kind="train")
    data = device_batches(cfg, shape, mesh=mesh, seed=0,
                          device=None if mesh is not None else "cuda")
    try:
        return [next(data)[1] for _ in range(TP_TRAIN_STEPS)]
    finally:
        data.close()


def tp_twins(dev) -> dict:
    """The tp = 1 twins of (a) and (b), in this process: qwen2-1.5b at full
    width from seed 0, the kernel prefill of phase 7's prompts and 8
    decode steps from its cache (last-position logits, on the host), and
    the loss of (b)'s first batch."""
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.serve import make_prompts
    from repro_torch.models.model import Model

    cfg = get_arch(SERVE_ARCH)
    m = Model(cfg, device=dev)
    params = m.init(torch.Generator(device=dev).manual_seed(0))
    prompts = torch.as_tensor(make_prompts(cfg.vocab_size, SERVE_BATCH, SERVE_PROMPT, 0),
                              device=dev).long()
    toks = torch.as_tensor(_tokens_for_decode(cfg, TP_DECODE, SERVE_BATCH), device=dev)
    logits, cache = m.make_prefill()(params, prompts, max_len=SERVE_PROMPT + TP_DECODE)
    decode, steps = m.make_decode_step(), []
    for i in range(TP_DECODE):
        out, cache = decode(params, cache, toks[i], SERVE_PROMPT + i)
        steps.append(out.float().cpu())
    with torch.no_grad():
        loss = float(m.loss_fn(params, _tp_batch(cfg)[0])[0])
    del params, cache
    torch.cuda.empty_cache()
    return dict(prefill=logits.float().cpu(), decode=torch.stack(steps), loss=loss)


def _mesh_snapshot(mesh) -> dict:
    return dict(staged_bytes=mesh.staged_bytes, staged_s=mesh.staged_s, wait_s=mesh.wait_s,
                moved_bytes=dict(mesh.moved_bytes), moved_s=dict(mesh.moved_s))


def _mesh_since(mesh, before) -> dict:
    now = _mesh_snapshot(mesh)
    out = {k: now[k] - before[k] for k in ("staged_bytes", "staged_s", "wait_s")}
    for k in ("moved_bytes", "moved_s"):
        out[k] = {c: v - before[k].get(c, 0) for c, v in now[k].items()}
    return out


def _rank_counted(mesh, fn):
    """``fn()`` with the launch counters from 0 just before it and read just
    after; returns (its result, launches, #6 shapes, the mesh's counters
    over the call, host seconds)."""
    import torch

    from repro_torch.kernels.flash_attention import flash_attention as fk

    torch.cuda.synchronize()
    _reset_launches()
    before = _mesh_snapshot(mesh)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, _launches(), dict(fk.LAUNCH_SHAPES), _mesh_since(mesh, before), wall


def _rank_serve(mesh, dev) -> dict:
    """(a) on this rank: a warm prefill (uncounted), the counted prefill and
    8 decode steps; the gathered logits go back to the parent."""
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.serve import make_prompts
    from repro_torch.models.model import Model

    cfg = get_arch(SERVE_ARCH)
    m = Model(cfg, mesh=mesh)
    params = m.init(torch.Generator(device=dev).manual_seed(0))
    prompts = torch.as_tensor(make_prompts(cfg.vocab_size, SERVE_BATCH, SERVE_PROMPT, 0),
                              device=dev).long()
    toks = torch.as_tensor(_tokens_for_decode(cfg, TP_DECODE, SERVE_BATCH), device=dev)
    prefill, decode = m.make_prefill(), m.make_decode_step()
    prefill(params, prompts)
    max_len = SERVE_PROMPT + TP_DECODE
    (logits, cache), used, shapes, moved, wall = _rank_counted(
        mesh, lambda: prefill(params, prompts, max_len=max_len))

    def steps():
        nonlocal cache
        outs = []
        for i in range(TP_DECODE):
            out, cache = decode(params, cache, toks[i], SERVE_PROMPT + i)
            outs.append(out.float().cpu())
        return torch.stack(outs).numpy()

    dec, dused, _, dmoved, dwall = _rank_counted(mesh, steps)
    nbytes = sum(p.numel() * p.element_size() for p in params.parameters())
    del params, cache
    torch.cuda.empty_cache()
    # numpy, not tensors: a tensor crosses the result queue by a file
    # descriptor that dies with the rank
    return dict(prefill=logits.float().cpu().numpy(), decode=dec, used=used, shapes=shapes,
                moved=moved, prefill_ms=1e3 * wall, decode_used=dused, decode_moved=dmoved,
                decode_ms=1e3 * dwall / TP_DECODE, param_bytes=nbytes)


def _rank_train(mesh, dev) -> dict:
    """(b) on this rank: 2 steps from the seed-0 state with the f32
    reduction of the TP partial sums, then 2 with the bf16 one."""
    import torch

    from repro_torch.configs.base import ParallelConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.model import Model
    from repro_torch.optim import AdamW, cosine_schedule

    cfg = get_arch(LM_ARCH)
    batches = _tp_batch(cfg, mesh)
    out = {}
    for tag, bf16 in (("f32", False), ("bf16", True)):
        m = Model(cfg, mesh=mesh, parallel=ParallelConfig(fsdp=False, tp_reduce_bf16=bf16))
        opt = AdamW(cosine_schedule(3e-3, 1, 200))
        state = m.init_train_state(torch.Generator(device=dev).manual_seed(0), opt)
        step_fn, _ = m.make_train_step(opt)
        rec = []
        for b in batches:
            (state, met), used, _, moved, wall = _rank_counted(mesh, lambda: step_fn(state, b))
            rec.append(dict(loss=float(met["loss"]), grad_norm=float(met["grad_norm"]),
                            used=used, moved=moved, ms=1e3 * wall))
        finite = all(bool(torch.isfinite(p).all()) for p in state.params.parameters())
        out[tag] = dict(steps=rec, params_finite=finite)
        del state, step_fn
        torch.cuda.empty_cache()
    return out


def _rank_moe(mesh, dev) -> dict:
    """(c) on this rank: the cut llama4 with only this rank's 64 experts
    drawn into memory, a prefill at ample capacity (counted), then one at
    capacity factor 1.0 with its dropped entries recorded, and the MoE
    sub-layer's share of a prefill."""
    import dataclasses as dc

    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.models.model import Model
    from repro_torch.models.transformer import _ffn_sublayer

    cfg = dc.replace(get_arch(MOE_ARCH), num_layers=MOE_LAYERS)
    ample = Model(cfg, mesh=mesh, capacity_factor=float(cfg.num_experts))
    t0 = time.perf_counter()
    params = ample.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    nbytes = sum(p.numel() * p.element_size() for p in params.parameters())
    prompts = _family_prompts(cfg, MOE_BATCH, MOE_PROMPT, dev)
    prefill = ample.make_prefill()

    def drops():
        got = [int(sum(int(t) for t in col)) for col in zip(*mesh.moe_drops)]
        mesh.moe_drops = None
        return got

    mesh.moe_drops = []
    (logits, _), used, shapes, moved, wall = _rank_counted(mesh, lambda: prefill(params, prompts))
    ample_dropped, _ = drops()
    tight = Model(cfg, mesh=mesh, capacity_factor=1.0)
    tprefill, ctx = tight.make_prefill(), tight._ctx("prefill")
    mesh.moe_drops = []
    (tlogits, _), _, _, tmoved, twall = _rank_counted(mesh, lambda: tprefill(params, prompts))
    dropped, routed = drops()
    h = torch.randn((MOE_BATCH, MOE_PROMPT, cfg.d_model), generator=torch.Generator(
        device=dev).manual_seed(1), device=dev).to(torch.bfloat16)
    with torch.inference_mode():
        _, _, _, mmoved, mwall = _rank_counted(mesh, lambda: _ffn_sublayer(params.layers[1], h,
                                                                         ctx))
    peak = torch.cuda.max_memory_allocated(dev)
    del params, h
    torch.cuda.empty_cache()
    return dict(logits=logits.float().cpu().numpy(), tight_logits=tlogits.float().cpu().numpy(),
                used=used,
                shapes=shapes, moved=moved, prefill_ms=1e3 * wall, tight_moved=tmoved,
                tight_ms=1e3 * twall, dropped=dropped, routed=routed, moe_ms=1e3 * mwall,
                ample_dropped=ample_dropped,
                moe_moved=mmoved, param_bytes=nbytes, init_s=t_init, peak=peak,
                capacity=(ample.plan.moe.capacity(MOE_BATCH * MOE_PROMPT // TP_RANKS),
                          tight.plan.moe.capacity(MOE_BATCH * MOE_PROMPT // TP_RANKS)))


def parallel_rank(rank: int, k: int, store) -> dict:
    """One rank of phase 17's world: (a), (b) and (c) on a
    ``make_host_mesh(model_axis=2)`` mesh over gloo, on ``cuda:0``."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", store=store, rank=rank, world_size=k)
    mesh = make_host_mesh(model_axis=k, device=dev)
    t0 = time.perf_counter()
    out = dict(serve=_rank_serve(mesh, dev))
    t1 = time.perf_counter()
    out["train"] = _rank_train(mesh, dev)
    t2 = time.perf_counter()
    out["moe"] = _rank_moe(mesh, dev)
    out["walls"] = (t1 - t0, t2 - t1, time.perf_counter() - t2)
    out["mesh"] = (list(mesh.axis_names), list(mesh.shape.values()), list(mesh.coords))
    return out


def run_parallel(dev, moe_twin) -> dict:
    """Phase 17: the tp = 1 twins of (a) and (b) here (the card's memory
    freed after), then a spawned gloo world of 2 ranks on the card."""
    import tempfile

    import torch

    from repro_torch.launch.mesh import spawn_world

    t0 = time.perf_counter()
    twins = tp_twins(dev)
    t1 = time.perf_counter()
    torch.cuda.empty_cache()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as store:
        ranks = spawn_world(parallel_rank, TP_RANKS, store, timeout=900)
    return dict(twins=twins, moe_twin=moe_twin, ranks=ranks, card=nvidia_smi(),
                twin_s=t1 - t0, world_s=time.perf_counter() - t1)


def _bytes_str(moved) -> str:
    return ", ".join(f"{k} {v / 1e6:.1f} MB in {1e3 * moved['moved_s'].get(k, 0.0):.1f} ms"
                     for k, v in sorted(moved["moved_bytes"].items()) if v)


def verify_parallel(out) -> dict:
    """Phase 17's checks and lines; returns the ranks' launches and #6
    shapes for the script's totals."""
    import numpy as np
    import torch

    from repro_torch.configs.registry import get_arch

    card, twins, ranks = out["card"], out["twins"], out["ranks"]
    launches, shapes = Counter(), Counter()
    layers = get_arch(SERVE_ARCH).num_layers
    for r, rank in enumerate(ranks):
        _require(list(rank["mesh"][:2]) == [["data", "model"], [1, TP_RANKS]],
                 f"parallel: rank {r} sits on {rank['mesh']}")
        sv = rank["serve"]
        pre = _jax_bar(torch.from_numpy(sv["prefill"]), twins["prefill"])
        dec = max(_jax_bar(torch.from_numpy(sv["decode"][i]), twins["decode"][i])
                  for i in range(TP_DECODE))
        print(f"parallel (a) rank {r}: qwen2-1.5b full width at tp {TP_RANKS} "
              f"({sv['param_bytes'] / 1e9:.2f} GB of bf16 parameters a rank), batch "
              f"{SERVE_BATCH}, prompt {SERVE_PROMPT}: prefill {sv['prefill_ms']:.3f} ms, "
              f"decode {sv['decode_ms']:.3f} ms/step over {TP_DECODE} steps; gathered logits "
              f"vs the tp = 1 twin at {pre:.3f} (prefill) and {dec:.3f} (worst decode step) "
              f"of the JAX bar (gate {BF16_MODEL_BAR:g}); prefill staged "
              f"{sv['moved']['staged_bytes'] / 1e6:.1f} MB in "
              f"{1e3 * sv['moved']['staged_s']:.1f} ms, blocked {1e3 * sv['moved']['wait_s']:.1f} "
              f"ms ({_bytes_str(sv['moved'])}); decode staged "
              f"{sv['decode_moved']['staged_bytes'] / 1e6:.2f} MB, blocked "
              f"{1e3 * sv['decode_moved']['wait_s']:.1f} ms; launches {json.dumps(sv['used'])}, "
              f"#6 shapes {sv['shapes']} [{card}]")
        _require(pre <= BF16_MODEL_BAR and dec <= BF16_MODEL_BAR,
                 f"parallel (a) rank {r}: TP logits depart from the tp = 1 twin past the bar")
        _require(sv["used"]["flash_attention_flat"] == layers
                 and sv["shapes"] == {_flash_key(TP_FLASH): layers},
                 f"parallel (a) rank {r}: #6 launched {sv['used']['flash_attention_flat']} "
                 f"times at {sv['shapes']}, want {layers} at {_flash_key(TP_FLASH)}")
        _require(not any(sv["decode_used"].values()), f"parallel (a) rank {r}: decode "
                 f"launched {sv['decode_used']}")
        launches.update(sv["used"])
        shapes.update(sv["shapes"])

        tr = rank["train"]
        f32, b16 = tr["f32"]["steps"], tr["bf16"]["steps"]
        gap = abs(f32[0]["loss"] - twins["loss"]) / abs(twins["loss"])
        bgap = abs(b16[0]["loss"] - f32[0]["loss"])
        ar = [s["moved"]["moved_bytes"].get("all_reduce", 0) for s in (f32[0], b16[0])]
        st = [s["moved"]["staged_bytes"] for s in (f32[0], b16[0])]
        print(f"parallel (b) rank {r}: qwen2-1.5b training at tp {TP_RANKS}, batch "
              f"{TP_TRAIN_BATCH} x 4096: f32-reduce losses {[s['loss'] for s in f32]}, grad "
              f"norms {[round(s['grad_norm'], 4) for s in f32]}, ms/step "
              f"{[round(s['ms'], 1) for s in f32]}; bf16-reduce losses "
              f"{[s['loss'] for s in b16]}, ms/step {[round(s['ms'], 1) for s in b16]}; first "
              f"loss vs the tp = 1 loss {twins['loss']!r}: rtol {gap:.2e} (gate "
              f"{TP_LOSS_RTOL:g}); bf16 vs f32 reduce {bgap:.2e} (gate {TP_BF16_LOSS_ATOL:g}); "
              f"all-reduce payload a step {ar[0] / 1e6:.1f} MB (f32 partials) and "
              f"{ar[1] / 1e6:.1f} MB (bf16), ratio {ar[1] / ar[0]:.3f} (reckoned 0.6: the "
              f"forward and recomputed down-projection sums halve, the backward sums of the "
              f"bf16 activation gradients do not); staged {st[0] / 1e6:.1f} and "
              f"{st[1] / 1e6:.1f} MB, blocked {1e3 * f32[0]['moved']['wait_s']:.1f} and "
              f"{1e3 * b16[0]['moved']['wait_s']:.1f} ms [{card}]")
        for tag, steps in (("f32", f32), ("bf16", b16)):
            _require(all(math.isfinite(s["loss"]) and math.isfinite(s["grad_norm"])
                         for s in steps) and tr[tag]["params_finite"],
                     f"parallel (b) rank {r}: a non-finite loss, grad norm or parameter")
            _require(not any(v for s in steps for v in s["used"].values()),
                     f"parallel (b) rank {r}: the training path launched a kernel")
        _require(gap <= TP_LOSS_RTOL, f"parallel (b) rank {r}: first loss parts from tp = 1")
        _require(bgap <= TP_BF16_LOSS_ATOL, f"parallel (b) rank {r}: bf16 reduce parts from f32")

        mo = rank["moe"]
        mbar = _jax_bar(torch.from_numpy(mo["logits"]), out["moe_twin"])
        a2a = mo["tight_moved"]["moved_bytes"].get("all_to_all", 0)
        a2a_ms = 1e3 * mo["tight_moved"]["moved_s"].get("all_to_all", 0.0)
        print(f"parallel (c) rank {r}: {MOE_ARCH} cut to {MOE_LAYERS} layers at tp {TP_RANKS} "
              f"({mo['param_bytes'] / 1e9:.2f} GB a rank, drawn in {mo['init_s']:.1f} s; peak "
              f"{mo['peak'] / 2**30:.2f} GiB), batch {MOE_BATCH}, prompt {MOE_PROMPT}: ample "
              f"capacity (C {mo['capacity'][0]}) prefill {mo['prefill_ms']:.3f} ms, logits vs "
              f"the tp = 1 reference at {mbar:.3f} of the JAX bar (gate {BF16_MODEL_BAR:g}), "
              f"all_to_all {mo['moved']['moved_bytes'].get('all_to_all', 0) / 1e6:.1f} MB; "
              f"capacity factor 1.0 (C {mo['capacity'][1]}): prefill {mo['tight_ms']:.3f} ms, "
              f"dropped {mo['dropped']} of {mo['routed']} (token, slot) entries "
              f"({100 * mo['dropped'] / max(mo['routed'], 1):.2f}%), all_to_all {a2a / 1e6:.2f} "
              f"MB in {a2a_ms:.1f} ms; the MoE sub-layer {mo['moe_ms']:.3f} ms, "
              f"{100 * mo['moe_ms'] / mo['tight_ms']:.1f}% of the prefill; launches "
              f"{json.dumps(mo['used'])}, #6 shapes {mo['shapes']} [{card}]")
        _require(mbar <= BF16_MODEL_BAR, f"parallel (c) rank {r}: EP logits depart from the "
                 f"tp = 1 reference past the bar")
        _require(mo["ample_dropped"] == 0, f"parallel (c) rank {r}: {mo['ample_dropped']} "
                 f"entries dropped at ample capacity")
        _require(bool(np.isfinite(mo["tight_logits"]).all()), f"parallel (c) rank {r}: NaN or "
                 f"inf in the capacity-1.0 logits")
        _require(mo["used"]["flash_attention_flat"] == MOE_LAYERS
                 and mo["shapes"] == {_flash_key(EP_FLASH): MOE_LAYERS},
                 f"parallel (c) rank {r}: #6 launched at {mo['shapes']}")
        launches.update(mo["used"])
        shapes.update(mo["shapes"])
    walls = [round(w, 1) for w in ranks[0]["walls"]]
    print(f"parallel: phase 17 took {out['twin_s']:.1f} s for the twins and "
          f"{out['world_s']:.1f} s for the world of {TP_RANKS} (rank 0: (a) {walls[0]} s, (b) "
          f"{walls[1]} s, (c) {walls[2]} s) [{card}]")
    return dict(launches=dict(launches), shapes=shapes)


# ---------------------------------------------------------------------------
# phase 18: the rest of the layout (the SSM mixer under TP, dense FSDP with
# sharded checkpoints) and the dry run against the live run
# ---------------------------------------------------------------------------

# two gloo ranks on the card again.  (a) hymba-1.5b at full width, tp 2, on a
# make_host_mesh(model_axis=2) mesh: batch 1 × 4096 (phase 15's 4 rows cut to
# 1, to keep the staged all-reduces near 2.5 GB a rank), past its 2048
# window, and 8 decode steps; (b) mamba2-130m trained at tp 2, batch 1 ×
# 4096 (TRAIN_4K's length, its global batch of 256 cut to 1), 2 steps; (c)
# qwen2-1.5b trained with FSDP on a (2, 1) mesh, global batch 2 × 4096 (one
# row a rank), 2 steps, a sharded checkpoint, step 3 carried on and step 3
# from the restore; (d) (a)'s prefill and (c)'s step on a dry rank of the
# same layout, in this process
LAYOUT_ARCH, LAYOUT_BATCH, LAYOUT_PROMPT, LAYOUT_DECODE = "hymba-1.5b", 1, 4096, 8
SSM_TP_ARCH, LAYOUT_SEQ, LAYOUT_STEPS = "mamba2-130m", 4096, 2
FSDP_MESH, FSDP_BATCH = (2, 1), 2
# the dry peak estimate against the measured peak of a training step
PEAK_RATIO = (0.8, 1.25)


def _layout_batches(cfg, global_batch, n, mesh=None):
    """``synth_batch`` of steps 0 … n−1 at ``global_batch`` × 4096 on the
    card (a mesh's rank: its rows)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import device_batches

    shape = ShapeConfig("layout", seq_len=LAYOUT_SEQ, global_batch=global_batch, kind="train")
    data = device_batches(cfg, shape, mesh=mesh, seed=0,
                          device=None if mesh is not None else "cuda")
    try:
        return [next(data)[1] for _ in range(n)]
    finally:
        data.close()


def _layout_opt():
    from repro_torch.optim import AdamW, cosine_schedule

    return AdamW(cosine_schedule(3e-3, 1, 200))


def _serve_twice(m, params, prompts):
    """(last-position logits of the kernel prefill of ``prompts``, the
    logits of 8 decode steps after it fed the seeded tokens), on the host."""
    import torch

    toks = torch.as_tensor(_tokens_for_decode(m.cfg, LAYOUT_DECODE, LAYOUT_BATCH),
                           device=prompts.device)
    logits, cache = m.make_prefill()(params, prompts, max_len=LAYOUT_PROMPT + LAYOUT_DECODE)
    decode, steps = m.make_decode_step(), []
    for i in range(LAYOUT_DECODE):
        out, cache = decode(params, cache, toks[i], LAYOUT_PROMPT + i)
        steps.append(out.float().cpu())
    return logits.float().cpu(), torch.stack(steps)


def layout_twins(dev) -> dict:
    """The tp = 1 twins of (a), (b) and (c), in this process: (a) hymba-1.5b
    on the global draw a tp-2 rank keeps its blocks of (seed 0; the kv
    groups padded 5 → 6, the padded group's q heads all padding, so the
    twin drops it), its kernel prefill of 1 × 4096 and 8 decode steps in
    bf16 and on the same weights in f32, and the bf16 prefill with the
    plain attention (a second one-device bf16 evaluation); (b)
    mamba2-130m's first loss (24 SSD heads, no padding at tp 2); (c)
    qwen2-1.5b's first training step on the global batch of 2 rows."""
    import torch

    import dataclasses as dc

    from repro_torch.configs.registry import get_arch
    from repro_torch.models import layers as L
    from repro_torch.models.model import Model
    from repro_torch.models.transformer import Transformer, forward, make_plan

    cfg = get_arch(LAYOUT_ARCH)
    m = Model(cfg, device=dev)
    params = m.empty_params()
    drawn = dict(Transformer(make_plan(cfg, TP_RANKS), dev).init_(
        torch.Generator(device=dev).manual_seed(0)).named_parameters())
    with torch.no_grad():
        for n, p in params.named_parameters():
            p.copy_(drawn[n][tuple(slice(0, k) for k in p.shape)])
    del drawn
    prompts = _family_prompts(cfg, LAYOUT_BATCH, LAYOUT_PROMPT, dev).long()
    twins = {"bf16": _serve_twice(m, params, prompts)}
    with torch.inference_mode():   # a second bf16 evaluation: the plain attention
        x, head, _, _ = forward(params, prompts, m.plan,
                                m._ctx("prefill")._replace(use_kernel=False))
        twins["plain"] = L.lm_head(x[:, -1:], head).cpu()
        del x
    mf = Model(dc.replace(cfg, dtype="float32"), device=dev)
    twins["f32"] = _serve_twice(mf, params.float(), prompts)
    del params

    scfg = get_arch(SSM_TP_ARCH)
    sm = Model(scfg, device=dev)
    sparams = sm.init(torch.Generator(device=dev).manual_seed(0))
    with torch.no_grad():
        twins["ssm_loss"] = float(sm.loss_fn(sparams, _layout_batches(scfg, 1, 1)[0])[0])
    del sparams

    qcfg = get_arch(LM_ARCH)
    qm = Model(qcfg, device=dev)
    opt = _layout_opt()
    state = qm.init_train_state(torch.Generator(device=dev).manual_seed(0), opt)
    _, met = qm.make_train_step(opt)[0](state, _layout_batches(qcfg, FSDP_BATCH, 1)[0])
    twins["fsdp_loss"], twins["fsdp_gnorm"] = float(met["loss"]), float(met["grad_norm"])
    del state, met
    torch.cuda.empty_cache()
    return twins


def _rank_layout_serve(m, params, prompts, dev) -> dict:
    """One dtype of (a) on this rank: the counted prefill of 1 × 4096 and
    the 8 decode steps, with their launches and collectives."""
    import torch

    mesh = m.mesh
    toks = torch.as_tensor(_tokens_for_decode(m.cfg, LAYOUT_DECODE, LAYOUT_BATCH), device=dev)
    prefill, decode = m.make_prefill(), m.make_decode_step()
    max_len = LAYOUT_PROMPT + LAYOUT_DECODE
    (logits, cache), used, shapes, moved, wall = _rank_counted(
        mesh, lambda: prefill(params, prompts, max_len=max_len))

    def steps():
        nonlocal cache
        outs = []
        for i in range(LAYOUT_DECODE):
            out, cache = decode(params, cache, toks[i], LAYOUT_PROMPT + i)
            outs.append(out.float().cpu())
        return torch.stack(outs).numpy()

    dec, dused, _, dmoved, dwall = _rank_counted(mesh, steps)
    del cache
    return dict(prefill=logits.float().cpu().numpy(), decode=dec, used=used, shapes=shapes,
                moved=moved, prefill_ms=1e3 * wall, decode_used=dused, decode_moved=dmoved,
                decode_ms=1e3 * dwall / LAYOUT_DECODE)


def _rank_hymba(mesh, dev) -> dict:
    """(a) on this rank: a short warm prefill (uncounted), then the counted
    prefill and 8 decode steps in bf16, and again on the same weights in
    f32."""
    import dataclasses as dc

    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.models.model import Model

    cfg = get_arch(LAYOUT_ARCH)
    m = Model(cfg, mesh=mesh)
    params = m.init(torch.Generator(device=dev).manual_seed(0))
    prompts = _family_prompts(cfg, LAYOUT_BATCH, LAYOUT_PROMPT, dev).long()
    m.make_prefill()(params, prompts[:, :256])
    out = _rank_layout_serve(m, params, prompts, dev)
    out["param_bytes"] = sum(p.numel() * p.element_size() for p in params.parameters())
    out["f32"] = _rank_layout_serve(Model(dc.replace(cfg, dtype="float32"), mesh=mesh),
                             params.float(), prompts, dev)
    del params
    torch.cuda.empty_cache()
    return out


def _rank_ssm_train(mesh, dev) -> dict:
    """(b) on this rank: mamba2-130m at tp 2, 2 steps from the seed-0 state."""
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.models.model import Model

    cfg = get_arch(SSM_TP_ARCH)
    m = Model(cfg, mesh=mesh)
    opt = _layout_opt()
    state = m.init_train_state(torch.Generator(device=dev).manual_seed(0), opt)
    step_fn, _ = m.make_train_step(opt)
    rec = []
    for b in _layout_batches(cfg, 1, LAYOUT_STEPS, mesh):
        (state, met), used, _, moved, wall = _rank_counted(mesh, lambda: step_fn(state, b))
        rec.append(dict(loss=float(met["loss"]), grad_norm=float(met["grad_norm"]), used=used,
                        moved=moved, ms=1e3 * wall))
    finite = all(bool(torch.isfinite(p).all()) for p in state.params.parameters())
    del state, step_fn
    torch.cuda.empty_cache()
    return dict(steps=rec, params_finite=finite)


def _state_bytes(state) -> tuple:
    params = sum(p.numel() * p.element_size() for p in state.params.parameters())
    moments = sum(t.numel() * t.element_size() for d in (state.opt.m, state.opt.v)
                  for t in d.values())
    return params, moments


def _rank_fsdp(mesh, dev, ckpt_dir) -> dict:
    """(c) on this rank: qwen2-1.5b with FSDP over ``data`` (its weights
    stored as this rank's half), 2 steps (the first under
    ``FlopCounterMode``, the count (d) holds the dry rank to), a sharded
    checkpoint (every rank gathers, rank 0 writes), step 3 carried on, then
    a fresh ``Model`` and state restored from the checkpoint and its step 3,
    which must equal the carried one to the bit."""
    import torch
    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch import interop
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.model import Model

    cfg = get_arch(LM_ARCH)
    m = Model(cfg, mesh=mesh)
    opt = _layout_opt()
    state = m.init_train_state(torch.Generator(device=dev).manual_seed(0), opt)
    whole = sum(math.prod(s) for s in m.param_shapes().values()) * 2   # bf16, fsdp off
    pbytes, mbytes = _state_bytes(state)
    step_fn, _ = m.make_train_step(opt)
    batches = _layout_batches(cfg, FSDP_BATCH, 3, mesh)
    rec, flops = [], None
    for i, b in enumerate(batches[:LAYOUT_STEPS]):
        if i == 1:
            torch.cuda.reset_peak_memory_stats(dev)
        fc = FlopCounterMode(display=False) if i == 0 else None
        with fc if fc is not None else contextlib.nullcontext():
            (state, met), used, _, moved, wall = _rank_counted(mesh, lambda: step_fn(state, b))
        if fc is not None:
            flops = fc.get_total_flops()
        rec.append(dict(loss=float(met["loss"]), grad_norm=float(met["grad_norm"]), used=used,
                        moved=moved, ms=1e3 * wall))
    step_peak = torch.cuda.max_memory_allocated(dev)
    writer = mesh.rank == 0
    t0 = time.perf_counter()
    tree = interop.train_state_tree(state, m, keep=writer)
    if writer:
        ck = Checkpointer(ckpt_dir)
        ck.save(tree, LAYOUT_STEPS + 1)
        del tree
        ck.wait()
    dist.barrier()
    save_s = time.perf_counter() - t0
    state, met3 = step_fn(state, batches[2])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m2 = Model(cfg, mesh=mesh)
    like = m2.train_state_of(m2.empty_params(), opt)
    tree, tag = Checkpointer(ckpt_dir).restore(like=interop.train_state_tree(like),
                                               device="cpu")
    del like
    restored = interop.train_state_from(tree, m2)
    del tree
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    step2, _ = m2.make_train_step(opt)
    restored, met3b = step2(restored, batches[2])
    same = dict(
        loss=float(met3["loss"]) == float(met3b["loss"]),
        grad_norm=float(met3["grad_norm"]) == float(met3b["grad_norm"]),
        params=all(torch.equal(a, b) for a, b in zip(state.params.parameters(),
                                                     restored.params.parameters())),
        moments=all(torch.equal(state.opt.m[n], restored.opt.m[n])
                    and torch.equal(state.opt.v[n], restored.opt.v[n]) for n in state.opt.m))
    gap = max(abs(float(a) - float(b)) / max(abs(float(a)), 1e-30)
              for a, b in ((met3["loss"], met3b["loss"]),
                           (met3["grad_norm"], met3b["grad_norm"])))
    finite = all(bool(torch.isfinite(p).all()) for p in state.params.parameters())
    peak = torch.cuda.max_memory_allocated(dev)
    del state, restored, step_fn, step2
    torch.cuda.empty_cache()
    return dict(steps=rec, flops=flops, step3=(float(met3["loss"]), float(met3["grad_norm"])),
                step3_restored=(float(met3b["loss"]), float(met3b["grad_norm"])), same=same,
                gap=gap, tag=tag, save_s=save_s, restore_s=restore_s, params_finite=finite,
                param_bytes=pbytes, moment_bytes=mbytes, whole_param_bytes=whole,
                step_peak=step_peak, peak=peak)


def layout_rank(rank: int, k: int, store, ckpt_dir: str) -> dict:
    """One rank of phase 18's world: (a) and (b) on a
    ``make_host_mesh(model_axis=2)`` mesh, (c) on a (2, 1) mesh, over gloo
    on ``cuda:0``."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh, make_model_mesh

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", store=store, rank=rank, world_size=k)
    tp = make_host_mesh(model_axis=k, device=dev)
    t0 = time.perf_counter()
    out = dict(serve=_rank_hymba(tp, dev))
    t1 = time.perf_counter()
    out["ssm"] = _rank_ssm_train(tp, dev)
    t2 = time.perf_counter()
    dp = make_model_mesh(FSDP_MESH, ("data", "model"), device=dev)
    out["fsdp"] = _rank_fsdp(dp, dev, ckpt_dir)
    out["walls"] = (t1 - t0, t2 - t1, time.perf_counter() - t2)
    out["mesh"] = (list(tp.shape.values()), list(dp.shape.values()), list(dp.coords))
    return out


def dry_counts() -> dict:
    """(d): (a)'s prefill and (c)'s training step on rank 0 of a dry rank
    of the same layout (``meta``, no process group), counted by
    ``hlo_analysis.trace_program``: the payload bytes of each collective
    kind, the FLOPs, and for (c) ``launch/dryrun.py``'s memory reckoning."""
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import dryrun, hlo_analysis
    from repro_torch.launch.mesh import dry_rank, make_model_mesh
    from repro_torch.models.model import Model

    out = {}
    mesh = dry_rank(make_model_mesh((1, TP_RANKS), ("data", "model")))
    m = Model(get_arch(LAYOUT_ARCH), mesh=mesh)
    prefill = m.make_prefill()
    prompts = torch.zeros((LAYOUT_BATCH, LAYOUT_PROMPT), dtype=torch.long, device="meta")
    t0 = time.perf_counter()
    tr = hlo_analysis.trace_program(
        lambda p, x: prefill(p, x, max_len=LAYOUT_PROMPT + LAYOUT_DECODE), m.empty_params(),
        prompts, mesh=mesh)
    out["serve"] = dict(moved=dict(mesh.moved_bytes), flops=tr.stats.flops,
                        wire=tr.stats.total_wire_bytes, s=time.perf_counter() - t0)

    mesh = dry_rank(make_model_mesh(FSDP_MESH, ("data", "model")))
    m = Model(get_arch(LM_ARCH), mesh=mesh)
    opt = _layout_opt()
    state = m.train_state_of(m.empty_params(), opt)
    batch = {k: torch.zeros((FSDP_BATCH // FSDP_MESH[0], LAYOUT_SEQ), dtype=torch.int32,
                            device="meta") for k in ("inputs", "labels")}
    t0 = time.perf_counter()
    tr = hlo_analysis.trace_program(m.make_train_step(opt)[0], state, batch, mesh=mesh)
    arg, outb, alias = dryrun._nbytes((state, batch)), dryrun._nbytes(tr.out), \
        dryrun._nbytes(state)
    out["fsdp"] = dict(moved=dict(mesh.moved_bytes), flops=tr.stats.flops,
                       wire=tr.stats.total_wire_bytes, temp=tr.temp_bytes,
                       peak=arg + outb + tr.temp_bytes - alias, s=time.perf_counter() - t0)
    return out


def run_layouts(dev) -> dict:
    """Phase 18: the tp = 1 twins here, a spawned gloo world of 2 ranks on
    the card, then (d)'s dry rank here."""
    import tempfile

    import torch

    from repro_torch.launch.mesh import spawn_world

    t0 = time.perf_counter()
    twins = layout_twins(dev)
    t1 = time.perf_counter()
    torch.cuda.empty_cache()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as store, \
            tempfile.TemporaryDirectory(dir=ROOT / "build") as ckpt:
        ranks = spawn_world(layout_rank, TP_RANKS, store, args=(ckpt,), timeout=900)
    t2 = time.perf_counter()
    dry = dry_counts()
    return dict(twins=twins, ranks=ranks, dry=dry, card=nvidia_smi(), twin_s=t1 - t0,
                world_s=t2 - t1, dry_s=time.perf_counter() - t2)


def _nonzero(moved: dict) -> dict:
    return {k: v for k, v in moved.items() if v}


def verify_layouts(out) -> dict:
    """Phase 18's checks and lines; returns the ranks' launches and #6
    shapes for the script's totals."""
    import numpy as np
    import torch

    from repro_torch.configs.registry import get_arch

    card, twins, ranks, dry = out["card"], out["twins"], out["ranks"], out["dry"]
    launches, shapes = Counter(), Counter()
    layers = get_arch(LAYOUT_ARCH).num_layers
    fails = []

    def need(ok, what):   # every line is printed before the phase fails
        if not ok:
            fails.append(what)

    (tb_pre, tb_dec), (tf_pre, tf_dec) = twins["bf16"], twins["f32"]
    drift = _jax_bar(tb_pre, twins["plain"])
    twin_err = (_maxdiff(tb_pre, tf_pre), _maxdiff(tb_dec, tf_dec))
    for r, rank in enumerate(ranks):
        need(list(rank["mesh"][:2]) == [[1, TP_RANKS], list(FSDP_MESH)],
             f"layouts: rank {r} sits on {rank['mesh']}")
        sv, sf = rank["serve"], rank["serve"]["f32"]
        rb_pre, rb_dec = torch.from_numpy(sv["prefill"]), torch.from_numpy(sv["decode"])
        rf_pre, rf_dec = torch.from_numpy(sf["prefill"]), torch.from_numpy(sf["decode"])
        pre = _jax_bar(rb_pre, tb_pre)
        dec = max(_jax_bar(rb_dec[i], tb_dec[i]) for i in range(LAYOUT_DECODE))
        f32_err = max(_maxdiff(rf_pre, tf_pre) / float(tf_pre.abs().max()),
                      _maxdiff(rf_dec, tf_dec) / float(tf_dec.abs().max()))
        tp_err = (_maxdiff(rb_pre, tf_pre), _maxdiff(rb_dec, tf_dec))
        print(f"layouts (a) rank {r}: {LAYOUT_ARCH} full width at tp {TP_RANKS} ({layers} "
              f"layers, 25 SSD heads and 3 kv groups a rank, {sv['param_bytes'] / 1e9:.2f} GB "
              f"of bf16 parameters), batch {LAYOUT_BATCH}, prompt {LAYOUT_PROMPT} (window "
              f"2048): prefill {sv['prefill_ms']:.3f} ms, decode {sv['decode_ms']:.3f} ms/step "
              f"over {LAYOUT_DECODE} steps (f32: {sf['prefill_ms']:.3f} / "
              f"{sf['decode_ms']:.3f} ms); f32 gathered logits vs the f32 tp = 1 twin max|Δ| "
              f"{f32_err:.2e} of the largest (gate 1e-4); bf16 error vs the f32 twin "
              f"{tp_err[0]:.4f} (prefill) / {tp_err[1]:.4f} (decode) against the bf16 twin's "
              f"{twin_err[0]:.4f} / {twin_err[1]:.4f} (gate 1.5x); bf16 vs the bf16 twin at "
              f"{pre:.3f} (prefill) and {dec:.3f} (worst decode step) of the JAX bar, two "
              f"one-device bf16 prefills (kernel, plain attention) at {drift:.3f} of it "
              f"(BF16_MODEL_BAR {BF16_MODEL_BAR:g}); prefill staged "
              f"{sv['moved']['staged_bytes'] / 1e6:.1f} MB in "
              f"{1e3 * sv['moved']['staged_s']:.1f} ms, blocked "
              f"{1e3 * sv['moved']['wait_s']:.1f} ms ({_bytes_str(sv['moved'])}); decode "
              f"staged {sv['decode_moved']['staged_bytes'] / 1e6:.2f} MB, blocked "
              f"{1e3 * sv['decode_moved']['wait_s']:.1f} ms ({_bytes_str(sv['decode_moved'])}); "
              f"launches {json.dumps(sv['used'])} and f32 {json.dumps(sf['used'])}, #6 shapes "
              f"{sv['shapes']} and {sf['shapes']} [{card}]")
        need(f32_err <= 1e-4, f"layouts (a) rank {r}: f32 TP logits depart from the f32 twin")
        need(all(t <= 1.5 * w for t, w in zip(tp_err, twin_err)),
             f"layouts (a) rank {r}: bf16 TP logits less accurate than the bf16 twin's")
        for got, case in ((sv, HYMBA_TP_FLASH), (sf, HYMBA_TP_FLASH_F32)):
            need(got["used"]["flash_attention_flat"] == layers
                 and got["shapes"] == {_flash_key(case): layers},
                 f"layouts (a) rank {r}: #6 launched {got['used']['flash_attention_flat']} "
                 f"times at {got['shapes']}, want {layers} at {_flash_key(case)}")
            need(not any(v for k, v in got["used"].items() if k != "flash_attention_flat")
                 and not any(got["decode_used"].values()),
                 f"layouts (a) rank {r}: stray launches {got['used']} / {got['decode_used']}")
            launches.update(got["used"])
            shapes.update(got["shapes"])

        ss = rank["ssm"]["steps"]
        sgap = abs(ss[0]["loss"] - twins["ssm_loss"]) / abs(twins["ssm_loss"])
        print(f"layouts (b) rank {r}: {SSM_TP_ARCH} training at tp {TP_RANKS} (12 SSD heads "
              f"a rank), batch 1 x {LAYOUT_SEQ}: losses {[s['loss'] for s in ss]}, grad norms "
              f"{[round(s['grad_norm'], 4) for s in ss]}, ms/step "
              f"{[round(s['ms'], 1) for s in ss]}; first loss vs the tp = 1 loss "
              f"{twins['ssm_loss']!r}: rtol {sgap:.2e} (gate {TP_LOSS_RTOL:g}); a step staged "
              f"{ss[1]['moved']['staged_bytes'] / 1e6:.1f} MB, blocked "
              f"{1e3 * ss[1]['moved']['wait_s']:.1f} ms ({_bytes_str(ss[1]['moved'])}) [{card}]")
        need(all(math.isfinite(s["loss"]) and math.isfinite(s["grad_norm"]) for s in ss)
                 and rank["ssm"]["params_finite"],
                 f"layouts (b) rank {r}: a non-finite loss, grad norm or parameter")
        need(not any(v for s in ss for v in s["used"].values()),
                 f"layouts (b) rank {r}: SSM training launched a kernel")
        need(sgap <= TP_LOSS_RTOL, f"layouts (b) rank {r}: first loss parts from tp = 1")

        fs = rank["fsdp"]
        st = fs["steps"]
        fgap = abs(st[0]["loss"] - twins["fsdp_loss"]) / abs(twins["fsdp_loss"])
        ggap = abs(st[0]["grad_norm"] - twins["fsdp_gnorm"]) / abs(twins["fsdp_gnorm"])
        print(f"layouts (c) rank {r}: {LM_ARCH} FSDP training on a {FSDP_MESH} mesh, global "
              f"batch {FSDP_BATCH} x {LAYOUT_SEQ} (one row a rank): losses "
              f"{[s['loss'] for s in st]}, grad norms {[round(s['grad_norm'], 4) for s in st]}, "
              f"ms/step {[round(s['ms'], 1) for s in st]} (step 1 under FlopCounterMode); first "
              f"loss vs the tp = 1 loss {twins['fsdp_loss']!r}: rtol {fgap:.2e} (gate "
              f"{TP_LOSS_RTOL:g}), first grad norm gap {ggap:.2e}; a step staged "
              f"{st[1]['moved']['staged_bytes'] / 1e6:.1f} MB, blocked "
              f"{1e3 * st[1]['moved']['wait_s']:.1f} ms ({_bytes_str(st[1]['moved'])}); "
              f"parameters {fs['param_bytes'] / 1e9:.3f} GB and moments "
              f"{fs['moment_bytes'] / 1e9:.3f} GB a rank against "
              f"{fs['whole_param_bytes'] / 1e9:.3f} and {2 * fs['whole_param_bytes'] / 1e9:.3f} "
              f"GB with fsdp off (each moment in its parameter's bf16; ratio "
              f"{fs['param_bytes'] / fs['whole_param_bytes']:.3f}); max_memory_allocated "
              f"{fs['peak'] / 2**30:.2f} GiB (step 2 alone {fs['step_peak'] / 2**30:.2f} GiB); "
              f"checkpoint of step {fs['tag']}: save {fs['save_s']:.1f} s, restore "
              f"{fs['restore_s']:.1f} s; step 3 carried on {fs['step3']} and from the restore "
              f"{fs['step3_restored']}, bitwise {fs['same']} [{card}]")
        need(all(math.isfinite(s["loss"]) and math.isfinite(s["grad_norm"]) for s in st)
                 and fs["params_finite"],
                 f"layouts (c) rank {r}: a non-finite loss, grad norm or parameter")
        need(not any(v for s in st for v in s["used"].values()),
                 f"layouts (c) rank {r}: FSDP training launched a kernel")
        need(fgap <= TP_LOSS_RTOL, f"layouts (c) rank {r}: first loss parts from tp = 1")
        need(all(fs["same"].values()), f"layouts (c) rank {r}: step 3 from the restored "
                 f"checkpoint is not step 3 carried on ({fs['same']}, gap {fs['gap']:.2e})")
        need(st[0]["moved"]["moved_bytes"].get("all_gather", 0) > 0
                 and st[0]["moved"]["moved_bytes"].get("reduce_scatter", 0) > 0,
                 f"layouts (c) rank {r}: no FSDP gather / scatter in a step")

    r0 = ranks[0]
    for tag, live, flops in (("(a) prefill", r0["serve"]["moved"]["moved_bytes"], None),
                             ("(c) step", r0["fsdp"]["steps"][0]["moved"]["moved_bytes"],
                              r0["fsdp"]["flops"])):
        d = dry["serve" if tag.startswith("(a)") else "fsdp"]
        print(f"layouts (d) {tag}: dry payload by kind {_nonzero(d['moved'])} against rank 0's "
              f"live {_nonzero(live)}; dry {d['flops'] / 1e12:.4f} TFLOP"
              + (f" against FlopCounterMode's {flops / 1e12:.4f} on the live step" if flops
                 else "") + f"; wire {d['wire'] / 2**20:.1f} MiB; dry pass {d['s']:.1f} s")
        need(_nonzero(d["moved"]) == _nonzero(live),
                 f"layouts (d) {tag}: dry collective bytes differ from the live ones")
        need(flops is None or d["flops"] == flops,
                 f"layouts (d) {tag}: dry FLOPs {d['flops']} != live {flops}")
    ratio = dry["fsdp"]["peak"] / r0["fsdp"]["step_peak"]
    print(f"layouts (d): dry peak_estimate_bytes {dry['fsdp']['peak'] / 2**30:.2f} GiB (temp "
          f"{dry['fsdp']['temp'] / 2**30:.2f}) against (c)'s measured step peak "
          f"{r0['fsdp']['step_peak'] / 2**30:.2f} GiB: ratio {ratio:.3f} (reckoned "
          f"{PEAK_RATIO[0]}–{PEAK_RATIO[1]}) [{card}]")
    walls = [round(w, 1) for w in r0["walls"]]
    print(f"layouts: phase 18 took {out['twin_s']:.1f} s for the twins, {out['world_s']:.1f} s "
          f"for the world of {TP_RANKS} (rank 0: (a) {walls[0]} s, (b) {walls[1]} s, (c) "
          f"{walls[2]} s) and {out['dry_s']:.1f} s for the dry rank [{card}]")
    _require(not fails, "; ".join(fails))
    return dict(launches=dict(launches), shapes=shapes)


# phase 19: the paper's solver cell, JAX's ``lower_solver_cell``: the 1-D
# shard runtime's convdiff solve at n = 1024 (f32) over p = 256 shards (the
# 16×16 pod; 512 for 2×16×16).  (b) runs CELL_OUTER counted outer
# iterations, then CELL_TIMED for the ms an iteration (their difference)
CELL_N, CELL_P = 1024, 256
CELL_OUTER = 3
CELL_TIMED = (2, 6)
CELL_KERNELS = ("fused_sweep_residual", "diff_norm_partials")
# the CPU's table of examples/torch/quickstart.py (and of the JAX example)
QUICKSTART_OUTER = {"sync": 59, "pfait": 72, "nfais2": 66, "nfais5": 70}


def _reported(fn):
    """The work (operations, bytes) ``fn`` reports to a counting mode, and
    its result."""
    from repro_torch.kernels import _build

    sink = [0.0, 0.0]
    _build.WORK_SINKS.append(sink)
    try:
        out = fn()
    finally:
        _build.WORK_SINKS.remove(sink)
    return tuple(sink), out


def check_cell_work(st, dev) -> dict:
    """(a): at each cell block, #1 (both ops) and #5 report at a launch
    the work their meta paths report; #1's sweep and #5 timed at the
    256-shard block, f32, against their plain versions and bounds."""
    import torch

    from repro_torch.kernels.jacobi3d import jacobi3d as jk
    from repro_torch.kernels.jacobi3d import ref as jref
    from repro_torch.kernels.residual_norm import ref as rref
    from repro_torch.kernels.residual_norm import residual_norm as rk

    gen = torch.Generator(device=dev).manual_seed(19)
    f32 = torch.float32
    times = {}
    for name in ("cell256", "cell512"):
        bx, by, bz = shape = SHAPES[name]
        g = torch.rand((bx + 2, by + 2, bz + 2), generator=gen, device=dev, dtype=f32)
        b = torch.rand(shape, generator=gen, device=dev, dtype=f32)
        gm, bm = (torch.empty_like(t, device="meta") for t in (g, b))
        for op in ("sweep", "residual"):
            card, _ = _reported(lambda: jk.fused_sweep_residual(g, b, st.coefs, op=op))
            meta, _ = _reported(lambda: jk.fused_sweep_residual(gm, bm, st.coefs, op=op))
            _require(card == meta == jk.work(shape, 4, op),
                     f"fused_sweep_residual {name} op={op}: reported {card} on the card, "
                     f"{meta} on meta")
        x = torch.rand(shape, generator=gen, device=dev, dtype=f32)
        card, _ = _reported(lambda: rk.diff_norm_partials(x, b, ord=2.0))
        meta, _ = _reported(lambda: rk.diff_norm_partials(
            torch.empty_like(x, device="meta"), bm, ord=2.0))
        _require(card == meta == rk.work(x.numel(), 4),
                 f"diff_norm_partials {name}: reported {card} on the card, {meta} on meta")
        if name == "cell256":
            # the library calls as phase 3's: the off-diagonal apply as a
            # convolution of the ghosted block, and torch.dist
            w = torch.zeros((1, 1, 3, 3, 3), dtype=f32, device=dev)
            w[0, 0, 0, 1, 1], w[0, 0, 2, 1, 1] = st.xm, st.xp
            w[0, 0, 1, 0, 1], w[0, 0, 1, 2, 1] = st.ym, st.yp
            w[0, 0, 1, 1, 0], w[0, 0, 1, 1, 2] = st.zm, st.zp
            for k, kern, plain, lib, work in (
                    ("fused_sweep_residual", lambda: jk.fused_sweep_residual(g, b, st.coefs),
                     lambda: jref.fused_sweep_residual_ref(g, b, st.coefs),
                     lambda: torch.nn.functional.conv3d(g[None, None], w), jk.work(shape, 4)),
                    ("diff_norm_partials", lambda: rk.diff_norm_partials(x, b, ord=2.0),
                     lambda: rref.diff_norm_partials_ref(x, b, ord=2.0),
                     lambda: torch.dist(x, b, 2), rk.work(x.numel(), 4))):
                (ms, call_ms), (plain_ms, _), (lib_ms, _) = map(_time_ms, (kern, plain, lib))
                bound_ms, by_ = _work_bound(work, PEAK_F32_FLOPS)
                times[k] = dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms, bound_ms=bound_ms)
                print(f"cell (a) time {k} at {_shape_str(shape)} f32: kernel {ms:.4f} ms (eager "
                      f"call {call_ms:.4f} ms), plain {plain_ms:.4f} ms, library "
                      f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({by_}; {work[0] / 1e6:.1f} "
                      f"Mop, {work[1] / 1e6:.2f} MB; warm L2 between replays)")
        del g, b, x
    torch.cuda.empty_cache()
    print("cell (a): #1 (sweep, residual) and #5 report the same work at a launch as on "
          f"meta at {', '.join(_shape_str(SHAPES[k]) for k in ('cell256', 'cell512'))} f32; "
          "held against their plain versions there in phase 2")
    return times


class _OpCount:
    """Counts the aten ops (views left out) a call dispatches: on a dry
    rank each is a launch the card would make."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        counter = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if not func.is_view:
                    counter.n += 1
                return func(*args, **(kwargs or {}))

        self.n, self.mode = 0, Mode()


def _dry_cell(outer: int):
    """A dry rank's run of the cell at ``outer`` outer iterations: (kernel
    work reported, aten ops dispatched, traced)."""
    import torch

    from repro_torch.launch import dryrun, hlo_analysis
    from repro_torch.launch.mesh import dry_shard_group

    group = dry_shard_group(CELL_P, 0)
    run = dryrun.solver_cell(group, CELL_N, max_outer=outer)
    x0 = torch.zeros((CELL_N // CELL_P, CELL_N, CELL_N), device="meta")
    ops = _OpCount()
    with ops.mode:
        work, traced = _reported(lambda: hlo_analysis.trace_program(
            run, x0, torch.zeros_like(x0), mesh=group))
    return work, ops.n, traced


def run_cell(dev) -> dict:
    """(b): the cell's solve at its own size on the card, stacked: the
    counted run, then the two timed ones, the counters set to 0 just
    before the first and read just after the last; then the exact residual
    of the counted run's result (a launch at the whole grid, outside the
    counted window)."""
    import torch

    from repro_torch.kernels.jacobi3d import jacobi3d as jk
    from repro_torch.kernels.jacobi3d import ops as jops
    from repro_torch.launch import dryrun, hlo_analysis
    from repro_torch.solvers.convdiff import Stencil
    from repro_torch.solvers.fixed_point import _zero_ghosts, ghosted

    n, p = CELL_N, CELL_P
    t_start = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    b = torch.rand((n, n, n), generator=gen, device=dev, dtype=torch.float32) * 2 - 1
    x0 = torch.zeros_like(b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_launches()
    run = dryrun.solver_cell(p, n, max_outer=CELL_OUTER, device=dev)
    work, traced = _reported(lambda: hlo_analysis.trace_program(run, x0, b))
    res = traced.out
    del traced
    walls = {}
    for outer in CELL_TIMED:
        timed = dryrun.solver_cell(p, n, max_outer=outer, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = timed(x0, b)
        torch.cuda.synchronize()
        walls[outer] = time.perf_counter() - t0
        _require(out.outer_iters == outer, f"cell (b): {out.outer_iters} outer iterations "
                                           f"at max_outer {outer}")
        del out
    used, shapes = _launches(), Counter(jk.LAUNCH_SHAPES)
    peak = torch.cuda.max_memory_allocated(dev)
    finite = bool(res.x.isfinite().all())
    st = Stencil.for_contraction(n, 1.0, (1.0, 1.0, 1.0), rho=0.95)   # the cell's
    r_x = float(jops.residual_contribution(st, ghosted(res.x, _zero_ghosts(res.x)), b, ord=INF))
    r_0 = float(b.abs().amax())   # the residual of x0 = 0
    del res, x0, b
    torch.cuda.empty_cache()
    return dict(work=work, finite=finite, r_x=r_x, r_0=r_0, walls=walls, used=used,
                shapes=shapes, peak=peak, seconds=time.perf_counter() - t_start)


def verify_cell(out, times) -> dict:
    """(b)'s checks against a dry rank, (c) the dry records, (d) the
    quickstart example on the card."""
    from repro_torch.launch import dryrun

    card = nvidia_smi()
    n, p, K = CELL_N, CELL_P, CELL_OUTER
    dry, _, _ = _dry_cell(K)
    per_shard = tuple(v / p for v in out["work"])
    print(f"cell (b): stacked n = {n}, p = {p}, f32, {K} outer iterations under trace_program: "
          f"kernels reported {out['work'][0]:.6e} operations and {out['work'][1]:.6e} bytes, "
          f"over p {per_shard[0]:.6e} / {per_shard[1]:.6e}; a dry rank's kernels "
          f"{dry[0]:.6e} / {dry[1]:.6e}; finite {out['finite']}; exact l∞ residual "
          f"{out['r_x']:.6e} against b's {out['r_0']:.6e} [{card}]")
    _require(per_shard == dry, "cell (b): the card's kernel work over p is not a dry rank's")
    _require(out["finite"], "cell (b): a non-finite value in the solve")
    _require(out["r_x"] < out["r_0"], "cell (b): the residual did not fall")
    outers = K + sum(CELL_TIMED)
    want = {"fused_sweep_residual": 4 * p * outers, "diff_norm_partials": p * outers}
    got = {k: out["used"][k] for k in want}
    _require(got == want and not any(v for k, v in out["used"].items() if k not in want),
             f"cell (b): launches {out['used']}, want {want}")
    (_, ops1, _), (_, ops2, _) = _dry_cell(1), _dry_cell(2)
    a, b_ = CELL_TIMED
    ms = 1e3 * (out["walls"][b_] - out["walls"][a]) / (b_ - a)
    kernel_ms = p * (4 * times["fused_sweep_residual"]["ms"] + times["diff_norm_partials"]["ms"])
    print(f"cell (b): {ms:.3f} ms per outer iteration (runs of {a} and {b_}: "
          f"{out['walls'][a]:.3f} / {out['walls'][b_]:.3f} s), host-bound: a shard dispatches "
          f"{ops2 - ops1} aten ops (views left out) and 5 kernel launches an iteration, "
          f"{p * (ops2 - ops1 + 5)} over the {p} shards; the kernels' device time an "
          f"iteration {kernel_ms:.3f} ms; launches {json.dumps(got)}; max_memory_allocated "
          f"{out['peak'] / 2**30:.2f} GiB; (b) took {out['seconds']:.1f} s [{card}]")
    for multi in (False, True):
        rec = dryrun.lower_solver_cell(multi)
        print(f"cell (c) lower_solver_cell {rec['mesh']}: {json.dumps(rec)}")
        _require(rec["collectives"]["counts"] == {"collective-permute": 40002.0,
                                                  "all-reduce": 20000.0},
                 f"cell (c) {rec['mesh']}: collectives {rec['collectives']['counts']}")
    t0 = time.perf_counter()
    ex = subprocess.run([sys.executable, str(ROOT / "examples" / "torch" / "quickstart.py")],
                        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                        capture_output=True, text=True, timeout=600, cwd=ROOT)
    rows = {line.split()[0]: line.split() for line in ex.stdout.splitlines()
            if line.split() and line.split()[0] in QUICKSTART_OUTER}
    print(f"cell (d) examples/torch/quickstart.py on the card ({time.perf_counter() - t0:.1f} "
          f"s, rc {ex.returncode}):")
    for line in ex.stdout.splitlines():
        if line.strip():
            print("  " + line)
    _require(ex.returncode == 0, f"cell (d): quickstart failed: {ex.stderr[-2000:]}")
    got = {m: int(r[2]) for m, r in rows.items()}
    _require(got == QUICKSTART_OUTER and all(r[-1] == "yes" for r in rows.values()),
             f"cell (d): quickstart's outer counts {got}, want {QUICKSTART_OUTER}")
    return out["used"]


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


KERNELS = {
    "fused_sweep_residual": ("src/repro_torch/csrc/jacobi3d.cu",
                             "src/repro/kernels/jacobi3d/jacobi3d.py:453"),
    "fused_rbgs_sweep_residual": ("src/repro_torch/csrc/jacobi3d.cu",
                                  "src/repro/kernels/jacobi3d/jacobi3d.py:131"),
    "diff_norm_partials": ("src/repro_torch/csrc/residual_norm.cu",
                           "src/repro/kernels/residual_norm/residual_norm.py:34"),
    "fused_sweep_residual_halo": ("src/repro_torch/csrc/jacobi3d_halo.cu",
                                  "src/repro/kernels/jacobi3d/jacobi3d.py:368"),
    "fused_rbgs_sweep_residual_halo": ("src/repro_torch/csrc/jacobi3d_halo.cu",
                                       "src/repro/kernels/jacobi3d/jacobi3d.py:412"),
    "flash_attention_flat": ("src/repro_torch/csrc/flash_attention.cu",
                             "src/repro/kernels/flash_attention/flash_attention.py:90"),
}
# the main paths (phases 4–9 and 11–13) and the kernels each must launch
PATHS = (
    ("solve_single", run_solver, ("fused_sweep_residual", "fused_rbgs_sweep_residual")),
    ("1-D shard runtime", run_shards,
     ("fused_sweep_residual", "fused_rbgs_sweep_residual", "diff_norm_partials")),
    ("mesh shard runtime", run_mesh,
     ("fused_sweep_residual_halo", "fused_rbgs_sweep_residual_halo")),
    ("serve", run_serve, ("flash_attention_flat",)),
    ("pagerank shard runtime", run_pagerank, ("diff_norm_partials", "fused_sweep_residual")),
    # the stacked twins run in this process; the kernels are required of
    # the launches inside the worlds
    ("distributed shard runtime", run_distributed, DIST_KERNELS),
    ("detection service", run_service, SERVICE_KERNELS),
    # the training path's worlds report their own launches, like phase 9's
    ("training runtime", run_training, ("diff_norm_partials",)),
    ("elastic driver", run_elastic_driver, ("fused_sweep_residual", "diff_norm_partials")),
)


def _require_held(shape_launches, where: str) -> None:
    """Every (stencil kernel, block shape, dtype) launched was held against
    its plain version in phase 2 (each shape of ``SHAPES`` / ``HALO_SHAPES``
    in f64 and in f32)."""
    checked = {(k, shape, dt) for k, _, _ in shape_launches
               for shape in (HALO_SHAPES if "halo" in k else SHAPES).values()
               for dt in ("f64", "f32")}
    unchecked = sorted(f"{k} {_shape_str(s)} {dt}" for k, s, dt in shape_launches
                       if (k, s, dt) not in checked)
    _require(not unchecked, f"main-path launches at shapes never held against the "
                            f"plain version: {unchecked}")
    print(f"every (stencil kernel, block shape, dtype) the main paths launched {where} "
          f"({len(shape_launches)} triples) was held against its plain version in phase 2")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.solvers.convdiff import Stencil

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    t_start = t0 = time.perf_counter()
    logs = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s ({len(logs)} sources compiled)")
    for line in "\n".join(logs).splitlines():
        if "registers" in line or "spill" in line:
            print("ptxas:", line.strip())

    st = Stencil.for_contraction(SOLVER_N, nu=1.0, a=(1.0, 1.0, 1.0), rho=0.95)
    check = Checker()
    check_kernels(st, dev, check)
    check_flash(dev, check)
    sass = tensor_core_sass()
    if sass is None:
        print("flash library SASS: no cuobjdump in the toolkit, tensor-core instructions "
              "could not be counted")
    else:
        print(f"flash library SASS: {sass['HGMMA']} HGMMA (wgmma) and {sass['HMMA']} HMMA "
              f"(mma.sync) instructions")
        _require(sass["HGMMA"] > 0, "the flash library has no wgmma instruction")
    times = time_kernels(st, dev)
    flash_time = time_flash(dev)
    print(nvidia_smi())  # the card and power limit the times were taken at

    # the main paths: launch counters from 0 just before each, read just after
    from repro_torch.kernels.jacobi3d import jacobi3d as jk

    from repro_torch.kernels.flash_attention import flash_attention as fk

    runs, used_by, launches = {}, {}, dict.fromkeys(KERNELS, 0)
    shape_launches = Counter()   # (stencil kernel, block shape) -> main-path launches
    flash_shapes = Counter()     # #6's (BH, BN, Sq, Skv, H, causal, window, dtype) -> launches
    warm_serve(dev)
    for path, fn, kernels in PATHS:
        _reset_launches()
        runs[path] = fn(dev)
        torch.cuda.synchronize()
        used_by[path] = used = _launches()
        print(f"main-path launches, {path}:", json.dumps(used))
        shape_launches.update(jk.LAUNCH_SHAPES)
        flash_shapes.update(fk.LAUNCH_SHAPES)
        need = used
        if hasattr(runs[path], "world_launches"):
            # required of the ranks' own launches, not of the stacked twins
            need = runs[path].world_launches
            _require(bool(need), f"the {path} worlds reported no launch counters")
            for k in launches:
                launches[k] += need.get(k, 0)
            shape_launches.update(runs[path].world_shapes)
        for k in kernels:
            _require(need.get(k, 0) > 0, f"{k}: not launched on the {path} path")
        for k in launches:
            launches[k] += used[k]
    _require_held(shape_launches, "in this process and inside the worlds")
    verify_runs(*(runs[path] for path, _, _ in PATHS[:3]), runs["distributed shard runtime"].twins)
    verify_serve(runs["serve"], used_by["serve"], dev)
    verify_distributed(runs["distributed shard runtime"], runs, nvidia_smi())
    verify_pagerank(runs["pagerank shard runtime"], runs["1-D shard runtime"])
    verify_service(runs["detection service"], used_by["detection service"], dev)
    verify_train(runs["training runtime"], nvidia_smi())
    verify_elastic(runs["elastic driver"])
    # phase 16 replays phase 8's recorded traces
    pagerank_traces = [(run.name, run.rep.trace.dumps())
                       for run in runs["pagerank shard runtime"]["runs"]]
    runs.clear()   # the card's memory goes to the full-width training step

    # phase 14, the dense-LM training path, launches none of the kernels:
    # its attention is the plain version under autograd
    _reset_launches()
    lm = run_lm_train(dev)
    torch.cuda.synchronize()
    used = _launches()
    print("main-path launches, LM training:", json.dumps(used))
    _require(not any(used.values()), f"the LM training path launched a kernel: {used}")
    verify_lm_train(lm)
    del lm

    # phase 15, the other model families: each counted run sets the
    # counters to 0 just before it and reads them just after
    fam = run_families(dev)
    for key in (*FAMILY_SERVE, MOE_ARCH):
        for k in launches:
            launches[k] += fam[key]["used"][k]
        flash_shapes.update(fam[key]["shapes"])
    # phase 2 held #6 at every shape of FLASH_CASES
    held = {_flash_key(case) for case in FLASH_CASES}
    unheld = sorted(map(str, set(flash_shapes) - held))
    _require(not unheld, f"#6 launched on a main path at shapes never held against the "
                         f"plain version: {unheld}")
    print(f"every #6 shape the main paths launched ({len(flash_shapes)}: "
          f"{dict(flash_shapes)}) was held against its plain version in phase 2")

    # phase 16, the event engine: the counters set to 0 just before it
    _reset_launches()
    events = run_events(dev, pagerank_traces)
    torch.cuda.synchronize()
    used = _launches()
    print("main-path launches, event engine:", json.dumps(used))
    for k in EVENT_KERNELS:
        _require(used[k] > 0, f"{k}: not launched on the event engine path")
    for k in launches:
        launches[k] += used[k]
    _require_held(jk.LAUNCH_SHAPES, "on the event engine path")
    shape_launches.update(jk.LAUNCH_SHAPES)
    verify_events(events, used)
    rank_launches(st, dev, shape_launches, times)

    # phase 17, the parallel layout: the twins here, then a world of two
    # gloo ranks on the card, each setting its counters to 0 just before
    # each counted run and reading them just after
    par = verify_parallel(run_parallel(dev, fam[MOE_ARCH]["twin"]))
    for k in launches:
        launches[k] += par["launches"].get(k, 0)
    unheld = sorted(map(str, set(par["shapes"]) - held))
    _require(not unheld, f"#6 launched on the parallel path at shapes never held against "
                         f"the plain version: {unheld}")
    print(f"every #6 shape the parallel path launched ({dict(par['shapes'])}) was held against "
          f"its plain version in phase 2")

    # phase 18, the rest of the layout: the twins here, a world of two gloo
    # ranks on the card (counters set to 0 just before each counted run and
    # read just after), then the dry rank here
    lay = verify_layouts(run_layouts(dev))
    for k in launches:
        launches[k] += lay["launches"].get(k, 0)
    unheld = sorted(map(str, set(lay["shapes"]) - held))
    _require(not unheld, f"#6 launched on the layout path at shapes never held against "
                         f"the plain version: {unheld}")
    print(f"every #6 shape the layout path launched ({dict(lay['shapes'])}) was held against "
          f"its plain version in phase 2")

    # phase 19, the paper's solver cell: (a) the reported work at a launch,
    # then (b)'s runs with the counters set to 0 just before and read just
    # after, (c) the dry records and (d) the quickstart example
    t0 = time.perf_counter()
    cell_times = check_cell_work(st, dev)
    cell = run_cell(dev)
    print("main-path launches, solver cell:", json.dumps(cell["used"]))
    for k in CELL_KERNELS:
        _require(cell["used"][k] > 0, f"{k}: not launched on the solver cell's path")
    for k in launches:
        launches[k] += cell["used"][k]
    _require_held(cell["shapes"], "on the solver cell's path")
    verify_cell(cell, cell_times)
    print(f"cell: phase 19 took {time.perf_counter() - t0:.1f} s [{nvidia_smi()}]")

    rows = []
    for k, (source, replaces) in KERNELS.items():
        if k == "flash_attention_flat":
            t, shape, out = flash_time[SERVE_FLASH], "48x2048x128 kv 8 bf16 causal", "block"
        elif k == "diff_norm_partials":
            # its main-path shape, the 1-D shard block; 185³ is on a "time" line
            t, shape, out = times[k, SHAPES["shard"]], "25x150x150 f64", "partials"
        else:
            # the swept block's error; the other shapes' times are on the
            # "time ..." and "rank" lines above
            t, shape, out = times[k, SHAPES["main"]], "185x185x185 f64", "block"
        rows.append(dict(
            name=k, route="cuda", source=source, replaces=replaces,
            launches=launches[k], max_abs_err=check.abs_err[k, out],
            max_abs_err_of=out, ms=t["ms"], plain_ms=t["plain_ms"],
            bound_ms=t["bound_ms"], bound_by=t["bound_by"],
            library_ms=t["library_ms"], shape=shape))
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s from the build to here")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
