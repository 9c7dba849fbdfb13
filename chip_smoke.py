#!/usr/bin/env python3
"""Drive the repro_torch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught; each prints its
seconds and its host Green's function assemblies, which the whole run
shares by plan, ``_GreenMemo``):
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build the CUDA kernels from src/repro_torch/kernels/csrc with nvcc
     (one process per source, all started together);
  3. every kernel against its plain PyTorch version on the card: float32
     and float64, forward / inverse / pruned pad_to / kept bins, radix 2
     and 4, batch 1 and 13, every N = 2, 4, ..., 4096 (each pass radix of
     the register core) with all three epilogues (the Green plane on
     every bin, the rfft half spectrum and start 1 with an odd k; the
     twiddle tables on every bin and the DCT-I/DCT-II/DST-II windows),
     inputs at an address that is not 16-byte aligned (read in place, the
     kernel launched), ragged and
     batched scale shapes (B in {1, 3} on aligned and ragged planes),
     twiddle_pack on a strided half-spectrum window at the
     (E,E),(O,O),(E,O) 384^3 path's shape; the Stockham kernel's long
     rows at N in {8192, 16384, 32768, 65536} (one pass on a thread-block
     cluster of N / 4096 blocks) and 131072 and 2^20 (two passes; 2^20 in
     float32 only, at batch 1): forward, inverse, pruned pad_to, kept
     bins, the Green epilogue at start 0 and 1 (grows dividing the rows),
     the DCT-I/DCT-II/DST-II twiddle windows, batch 1 and 13, radix 2 and
     4, and one row of 2^24 points; float64 rows of 16384, 65536
     (cluster) and 131072 points (two passes) against torch.fft.fft;
  4. the main path: PoissonSolver.solve on the "cuda" engine, CELL, CHAT2,
     float32, for (U,U,U) and (P,P,P) at 256^3, (U,P,U) at 128^3 (its
     host Green assembly at 256^3 costs 10 s), (U,U,U) at 128^3 with B=2, semi-unbounded (U,E),(U,U),(U,U) at 256^3 and
     (U,U),(U,U),(O,U) at 128^3, the wall-bounded (E,E),(O,O),(E,O)
     at 384^3, and the elongated LONG_UUU (U,U,U) 4096x64x64 and
     LONG_SEMI (U,E),(U,U),(U,U) 2048x64x64, whose x direction needs an
     8192-point FFT (on a cluster), LONG_XL_UUU (U,U,U) 32768x16x16 (a
     65536-point forward on a 16-block cluster) and LONG_XXL_UUU (U,U,U)
     65536x16x16 (a 131072-point forward in two passes), each against the
     "torch" (cuFFT)
     engine on the card, with the launch counts of all five kernels, and
     of the cluster and two-pass calls, read around each solve;
  5. the analytic checks: NODE (U,U,U) HEJ4 n=64 float64 Gaussian blob
     (spectral_scale), and NODE (U,E),(U,U),(U,U) HEJ4 n=64 float64 blob
     and its even image (the DCT-I on fft_stockham_twiddle);
  6. Biot-Savart (lap(u) = curl(w), the vortex-method path), CELL, CHAT2,
     float32 at 256^3, "cuda" against "torch" within 1e-5 relative with
     exact launch counts: BS_TUBE (the paper's vortex tube BCs, the
     sequential per-component pipeline on fft_stockham and
     fft_stockham_twiddle) and BS_UUU (all nine BC pairs unbounded, the
     batched 3-wide pipeline with spectral_scale for the Green multiply);
     BS_TUBE_NODE_HEJ4, the tube at NODE n=64 HEJ4 float64 against its
     analytic velocity;
  7. the runtime on the card: a get_solver hit (same instance, same bits),
     verify="residual" on (P,P,P) 256^3 float32 with a smooth analytic
     field, an armed inf fault at the Green stage tripping the guard and
     walking one rung (engine:cuda->torch), an armed cuda.* build
     fault degrading to "torch", and a real (not injected) launch
     failure raising SolveError with no rung taken.  These are the only
     phases where a
     degradation is expected: every other solve asserts no degradation
     and no retry;
  7b. ABFT on the card ("cuda" engine, float32, 256^3): (U,U,U) and
     (E,E),(O,E),(P,P) clean under verify="abft" (the bits of
     verify=None) and "abft-stages" (within 1e-5), no integrity record,
     exact launches of both modes (the checked stages' one-row reference
     rows, the Green multiply on spectral_scale), each mode's median
     solve time beside verify=None and a profile; green_checksum at the
     spectral block's shape; a count=1 flip at each of fwd.0-2, green
     and bwd.0-2 under "abft-stages", each detected, attributed and
     recomputed to within 1e-5 of the clean checked run; the two-phase
     guard (count=2 at fwd.1 under "abft": two firings, solve.linearity,
     then the recompute); a persistent flip at green raising SolveError
     at verify.abft@green after the rungs engine, relayout, doubling;
  7c. every main-path solve of phases 4 and 6 (Biot-Savart included)
     timed on both engines, the device memory a solve allocates above
     what is resident, and a torch.profiler breakdown of its device time
     by kernel with the idle share that leaves (marked INCOMPLETE where
     the profiler saw fewer Stockham kernels than the solve's Stockham
     calls: profiles taken after phases 8-8d lose device events), the
     long rows' cluster, column and row kernels counted (a profiled solve
     shows a column pass exactly where it runs a two-pass call);
  8. the pencil-distributed solve (DistributedPoissonSolver over a
     DeviceMesh, CELL, CHAT2, float32 unless marked): DIST1_UUU, (U,U,U)
     at 256^3 on a one-rank NCCL mesh (1, 1) -- the switches' relayouts
     and the kernels on the pencil at full size; a one-rank axis issues
     no collective, which the collective census and the profiler (no NCCL
     kernel) check -- under a2a, pipelined:2, fused and overlap:2, and
     comm="auto" with the default guided search (2 of the 12 candidates
     timed, the CPU's shortlist), and DIST1_SEMI, (U,E),(U,U),(U,U) at
     128^3 under a2a and overlap:2, each within 1e-5 relative of the
     single-process "cuda" solve, and DIST1_NODE, NODE (U,U,U) n=64
     float64 (the Green multiply on spectral_scale) under a2a and
     overlap:2 within 1e-10, with exact launch counts and no degradation;
     DIST1_UUU under verify="abft-stages" (a2a and overlap:2: clean,
     the wire checks of both axes recorded, no collective issued) and
     verify="abft" on "cuda" (the checked branch) and on "torch" (the
     sandwich), with exact launches;
     each strategy's median solve_local beside the single-process solve,
     the memory a solve_local allocates above what is resident, its
     aten::copy_ count (and one switch's alone) and a profiled solve_local
     with its idle share; then DIST4_GLOO, four gloo ranks on the one card
     (NCCL refuses two ranks on one device; gloo stages CUDA tensors
     through the host, so its times are no communication figure), mesh
     (2, 2): (U,U,U) 128^3 under the four strategies and comm="auto" both
     ways, brute (12 candidates) and guided (at most a fifth of them, the
     CPU's shortlist), every rank choosing the same winner, each search's
     wall time and the guided winner's regret after a head-to-head
     re-timing (printed, not held: gloo's times are closer than their
     spread), NODE (E,E),(O,E),(P,P) n=64 float64 (the uneven 65-point
     split, within 1e-10) under a2a and overlap:2, a pod batch of two
     fields on mesh (2, 1, 2), launch counts summed over the ranks;
     search_plan on (U,U,U) at PLAN_N^3 over the meshes (2, 2), (1, 4)
     and (4, 1), both order policies and radix 4 and 2 (144 points, the
     shortlist timed, the radix-2 kernels inside solves): one winner on
     every rank, every timed point's launches exact, a second call
     replayed from the cache; and the slab meshes' collective census,
     only the non-unit axis's two switches, with the predicted bytes;
     DIST4_GLOO_ABFT, the assertions of the reference's distributed SDC
     script on the four ranks, engine "torch", 128^3: (P,P,P) under a2a
     and (U,P,U) under pipelined:2 with verify="abft" (clean bits, a
     fwd.0 flip localized and repaired bit-exact, a wire flip caught by
     the sandwich), a wire flip attributed to the wire under
     "abft-stages", a persistent green flip raising SolveError;
  8b. the solve server (repro_torch.serve, float32, "cuda" engine unless
     marked): PoissonServer(max_batch=8, max_delay_ms=4) serves 8 tenant
     threads x 4 requests over four keys, (U,U,U) and (P,P,P) at 256^3,
     semi-unbounded (U,E),(U,U),(U,U) at 128^3 and (E,E),(O,O),(E,O) at
     192^3 (library rfft, twiddle_pack, spectral_scale), every response
     the bits of an individual solve of the same solver; one batch per
     key at ranks 1, 2, 4 (3 rows padded) and 8, each launching exactly
     the key's EXPECTED pattern (the counts do not depend on B: a
     coalesced batch is one solve on the device), recorded for phase 9;
     a "torch"-engine batch of 8 against individual solves (printed);
     for (U,U,U) + (P,P,P) at 256^3 and 128^3 the throughput of a
     coalescing server and of one with max_batch=1, both warm, taking
     the same 8-tenant bursts in alternated rounds (the median and the
     range of the rounds' ratios), each tenant's
     p50/p95/p99, occupancy, padded rows, the pool's estimate beside
     torch.cuda.memory_allocated, and each rank's batch time split by
     CUDA events into the host-to-device copy, the solve and the
     device-to-host copy (printed, not held); one fault-armed request of
     four co-batched taking engine:cuda->torch once, seen by every
     tenant, every answer within 1e-5 relative, the warm plan clean
     after; the reference's serve soak (tests/test_abft.py) on a
     one-rank NCCL mesh, (P,P,P) 256^3, a2a, verify="abft", engine
     "torch"; the launcher (python -m repro_torch.launch.serve --n 128
     --tenants 8 --requests 4 --max-batch 8 --seq, float64) as a
     process of its own, exit 0, deviation 0.000e+00, its payload read;
  8c. the solve launcher (repro_torch.launch.solve main, float64, NODE
     unless marked, "cuda" engine unless marked, --repeats 5 --steps 5):
     one rank on a (1, 1) NCCL mesh at n=256, --bcs unb (and the same on
     engine "torch"), per and mix, --layout cell --bcs unb --batch 2 and
     --comm auto (the guided search times the CPU's shortlist), and
     --bcs unb at n=64, each run's launches held to its EXPECTED pattern
     once per solve (plus the search's timed solves), its ms/solve, E_inf
     and plan-cache counters printed, the runs of one plan sharing its
     host Green assembly; per and mix E_inf < 1e-10, unb
     within 1e-12 of the "torch" engine's and below n=64's; four gloo
     ranks on the card (--p1 2 --p2 2 --comm pipelined, n=64 unb) within
     1e-10 of the one-rank E_inf, launches summed over the ranks; the
     survivable loop as a process of its own on four gloo ranks (n=64
     per, --steps 6 --ckpt --ckpt-every 2 --verify nan) under the
     reference's device-loss spec at step 3: the (1x2) surviving mesh,
     E_inf < 1e-5, the chaos report's keys, the launches of its 20
     rank-solves; the spawned ranks of both runs record their kernel
     calls for phase 9, which must be the launches they counted; a
     checkpoint of tensors on the card restored bit-equal,
     a flip at ckpt.leaf.0 raising CheckpointError naming leaf 0;
  8d. serving on a mesh (repro_torch.serve on four gloo ranks spawned on
     the card, mesh (2, 2): rank 0 runs every PoissonServer, ranks 1-3
     follow each one, engine "cuda", overlap:2): (U,U,U) and (P,P,P)
     float32 at DIST4_GLOO's 128^3, one batch at ranks 1, 2, 4 and 8, and
     NODE (E,E),(O,E),(P,P) n=64 float64 (the uneven split) at ranks 1
     and 4, every row bit-exact against the same row served alone and
     within 1e-5 relative (1e-10) of the single-process "torch" solve;
     every rank entering the same solves, each with its key's per-rank
     B=1 launches; the share of each batch spent in the header and batch
     broadcast; the reference gate's traffic (bench_serve.py: 8 tenants
     x 12 requests over (U,U,U) and (P,P,P) at 64^3, max_batch 8, 4 ms)
     coalesced and sequential in alternated rounds, req/s, their ratio
     and each tenant's p50/p95/p99; the reference's serve soak at n=16
     (engine "torch", verify="abft"); every follower leaving each
     server's stop; the ranks' kernel calls recorded for phase 9;
  8e. LM training (repro_torch.launch.train, no kernel of this script:
     the models' products are cuBLAS calls through torch.einsum/bmm):
     qwen3-0.6b at its full config (28 layers, d_model 1024, vocab
     151936, bfloat16 compute, float32 master weights), batch 4 x seq
     2048, 8 steps uninterrupted, then 4 steps with one checkpoint and
     --fail-at 4 and a relaunch that resumes from it: every loss finite,
     step 0 within 2 nats of ln(vocab), the first run's losses and the
     resumed run's last loss within 1e-3 relative of the uninterrupted
     run's (deterministic algorithms off); the median ms/step, tokens/s,
     peak max_memory_allocated, model TFLOP/s (6 N T + 12 L B S^2 H dh)
     and a profiled step's device time by kernel with its idle share;
     the other five families at full width and a cut depth
     (LM_FAMILIES: moonshot-v1-16b-a3b 2 layers, mamba2-2.7b 2 layers,
     recurrentgemma-9b one (rec, rec, attn) group, whisper-medium whole,
     paligemma-3b 4 layers, starcoder2-7b 2 layers at 8192 tokens so
     that its 4096 window masks), a few steps each on one batch: losses
     finite, step 0 within 2 nats of ln(vocab) (for the gemma-style
     recurrentgemma-9b and paligemma-3b, whose tied sqrt(d)-scaled
     embedding dominates the residual stream at initialisation, between
     ln(vocab) - 2 and the embedding-only model's loss + 2), the last
     below the first; and the ten smoke configs in float32 from the same
     parameters, the card's forward logits and one train step (loss,
     grad_norm, new parameters) within 1e-4 relative of the host CPU's;
  8f. LM serving (repro_torch.models.transformer prefill and decode_step;
     no kernel of this script): qwen3-0.6b at its full config, eight
     requests of 2048 prompt tokens prefilled into caches of 2176 slots,
     then 32 greedy decode steps: the prefill logits against forward on
     the prompt (one code path: a smoke check), each layer's cached
     keys and values against attention(return_kv=True) on the layer's
     input (1e-4) with the slots past the prompt zero, and every decode
     step's logits against forward's
     position on the prompt + the tokens decode consumed (relative max
     error 2e-2, the reference test's), every logit finite; the warm
     prefill's ms and tokens/s, decode ms/step and tokens/s over the 128
     steps, the KV cache's and the peak max_memory_allocated GiB, and a
     profiled decode step's device time by kind with its idle share; the
     other nine configs at full width and a cut depth
     (LM_SERVE_FAMILIES, the MoE ones at capacity factor E / k, so that
     no token is dropped and moe_drop is 0): a short prompt (starcoder2's
     4200 tokens over its 4096 window, so the rolling buffer runs;
     whisper's 1500 frames and paligemma's 256 image tokens as the
     frontend) prefilled and 8 decode steps, each position held against
     forward (2e-2; the MoE configs in their bfloat16 with at most 10% of
     the positions past it, each after a router top-k flip against
     forward and printed with forward's top-k logit margin, the median
     within 1e-2, and again in float32, every position held); the ten
     smoke configs in float32, prefill and two decode steps on the card
     against the host CPU (logits and every cache leaf, 1e-4); and four gloo ranks spawned on the card, mesh (1, 4):
     ring attention at qwen3-0.6b's attention width, seq 4096 (each rank
     a quarter of the queries, the KV blocks passed rank to rank + 1)
     against the whole attention on one process, and the
     expert-parallel MoE (moonshot-v1-16b-a3b's layer at full width, 16
     experts a rank) against _moe_local on each rank's tokens, float32,
     1e-4, its drop the blocks' mean, and the same from a module holding
     only the rank's 16 experts (1e-4 of the first); then the same four
     ranks serve from sharded states (train_step.shard_params_ by the
     training layout rule: each rank's block of every parameter over
     "data", and over "model" its own experts and its blocks of the
     attention heads, the MLP's d_ff, the vocabulary, the SSM's d_model
     and the RG-LRU's d_rnn; prefill and decode_step on the mesh, each
     block's "data" blocks gathered whole for its step, one all-gather
     a block, the "model" blocks run tensor-parallel, one all-reduce a
     region (the RG-LRU's gates one reduce-scatter, the SSM's output one
     all-gather), each rank's caches its rows and kv heads, the logits
     gathered whole): qwen3-0.6b at full
     width cut to 4 layers, float32, 4 x 512 prompts and 4 greedy decode
     steps on mesh (2, 2), on (4, 1) (FSDP alone) and on (1, 4) (tensor
     parallelism alone), and moonshot-v1-16b-a3b at full width cut to 1
     layer, 32 own experts a rank, capacity factor E / k, 4 x 256
     prompts and 2 decode steps on (2, 2), mamba2-2.7b at full width
     cut to 2 layers, 4 x 256 and 2 steps on (1, 4) and (2, 2), and
     recurrentgemma-9b cut to 3 layers (one (rec, rec, attn) group),
     2 x 256 and 2 steps on (1, 4), each rank's rows of every
     call's logits, and its rows and kv heads of the last caches, within
     1e-4 of the same model served whole on one process on the card (run
     first and fed the same tokens), the ranks on one "data" coordinate
     bit-equal in the logits, the parameter bytes a rank within 0.0005
     GiB of the prediction from the reference's layout
     (LM_SHARD_PREDICTED_GIB) and the cache bytes a rank exactly its
     share of the one process's; printed: those bytes against whole, the
     prefill ms and decode ms a step, and the shares of each taken by
     the all-gathers over "data" (fsdp_timing), the all-reduces, the
     all-gathers and the reduce-scatters over "model" (tp_timing),
     timed with the card synchronised around each;
  8g. LM training on a mesh (repro_torch.training.train_step_fn(mesh=);
     no kernel of this script), four gloo ranks spawned on the card,
     float32 compute, TF32 off, after a memory reckoning per rank and
     for the four against the card, every state held by the training
     layout rule (train_step.shard_state_: the rank's block of every
     parameter and both moments over "data", FSDP, and over "model" its
     own experts and its tensor-parallel blocks of the attention heads,
     the MLP's d_ff and the vocabulary; the "data" blocks gathered per
     block where used, their gradients reduce-scattered, the "model"
     blocks run Megatron-style, one all-reduce a region each way, the
     ring's attention blocks gathered whole over "model"): qwen3-0.6b
     at full width cut to 4 layers with attn_ring, global batch 4 x
     2048, a step on mesh (2, 2), a checkpoint saved whole from rank
     0, a restore onto mesh (4, 1) as each rank's blocks and a third
     step, another checkpoint, a restore onto (1, 4) and a third step,
     against three one-process steps on the same batches; the same model
     without attn_ring, a fresh state cut on (1, 4) and on (2, 2), a
     step each on the first batch (the tensor-parallel leg, its
     all-reduces timed), against the same one-process step;
     mamba2-2.7b cut to 2 layers (float64 compute: its decay's
     gradient is at float32's noise floor, LM_TM_REC) and
     recurrentgemma-9b cut to 3, full width, global batch 2 x 512, a
     fresh state cut on (1, 4) (the
     SSM's d_model, the RG-LRU's d_rnn over "model") and a step each,
     against one process's step (its state freed before the ranks
     spawn), the state a rank within 0.0005 GiB of
     LM_TM_REC_PREDICTED_GIB;
     moonshot-v1-16b-a3b at full width cut to 1 layer, each rank
     holding its own 32 of the 64 experts and its blocks of the
     attention heads and the vocabulary, d_model split over "data",
     capacity factor E / k, global batch 2 x 1024, a step on mesh
     (2, 2), against one process holding all 64 (run first and freed
     before the ranks spawn).  Each batch's second half masks its last
     256 positions.  Held: losses within 1e-5 relative, the first
     step's reduced gradients (a rank's blocks against the matching
     slices) within 1e-4 of each leaf's largest, the dense model's last
     parameters (and the tensor-parallel leg's after its step)
     within 2e-5 |p| + 2e-6, the tensor-parallel leg's state bytes a
     rank within 0.0005 GiB of the prediction from the reference's
     layout (LM_TM_TP_PREDICTED_GIB), the ranks on one "data"
     coordinate bit-equal (but their blocks over "model"), the gathered
     parameters bit-equal on every rank; printed: the state's bytes a
     rank against whole, ms a step on the mesh and on one process, the
     seconds of the FSDP all-gathers and reduce-scatters over "data"
     and of the tensor-parallel collectives over "model" (the regions'
     all-reduces, the all-gathers: the ring's of the attention's blocks,
     the ring's and the MoE's outputs' and their gradients', and the
     reduce-scatters of the ring's blocks' gradients), each with its
     share of the step, the gloo gradient reduction's share, each
     rank's peak memory_allocated, the checkpoints' save and restore
     seconds;
  8h. the dry run (repro_torch.launch.dryrun, cells, flops_probe,
     hlo_stats, mesh; DistributedPoissonSolver.lower): the CLI in
     subprocesses on fake ranks (a "fake" process group, fake tensors
     on the card's device type, nothing allocated or launched) for
     qwen3-0.6b, mamba2-2.7b and recurrentgemma-9b decode_32k on the
     256-rank mesh, flups-poisson on the 256- and 512-rank meshes and
     moonshot-v1-16b-a3b train_4k on 256, each record's status, FLOPs,
     collective bytes, argument and temp GB and dominant roofline term
     printed, every one "ok", the decode cells' argument bytes a rank
     exactly the reference layout's; the
     flups-poisson cell's solver at n=256 (NODE (U,U,U) CHAT2, an
     in-block batch of 2, float32) on a one-rank NCCL mesh, engine
     "cuda" within 1e-5 relative of engine "torch" with exact launches
     (DRY_POISSON), which the same cell's dry run on a fake (1, 1) mesh
     counts as kernel calls; the median of REPS event-timed solves
     beside that dry run's t_compute_s and t_memory_s; and a bf16 matmul
     rate, a device-to-device copy rate and flops_probe's count of
     phase 8e's step at its measured ms, each beside the data sheet's
     figure (launch.mesh), printed and not held;
  9. every kernel call of the recorded solves (the distributed, the
     served and the launched ones, the spawned ranks' and search_plan's
     radix-2 calls among them) replayed at its shape
     against the plain version, and times with CUDA events (medians after
     warm-up; a kernel call is timed from a start event the device reaches
     only after the host has queued the call, and a kernel under 0.1 ms
     per call, with its plain version and library call, as 50
     back-to-back calls between one event pair over rotating input sets):
     each kernel's time per solve at its
     path's shapes beside its plain version, one equivalent PyTorch call
     where there is one, and its bound, also spectral_scale at the SYM384
     shape and the cluster calls of LONG_UUU and LONG_SEMI.
The last two lines are the kernels' JSON record (with each kernel's
launches in every distributed run, ``dist_launches``, every served
batch, ``serve_launches``, the mesh-served ones summed over the ranks and
solves, and every launcher run, ``launch_launches``)
and the device JSON.
The script imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import collections
import contextlib
import datetime
import gc
import json
import math
import pickle
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# device-memory rate (bytes/s) and non-tensor peak rates (flop/s) of the
# card, from NVIDIA's data sheets; the SXM part unless the name says other
_HBM = {"H100 PCIe": 2.0e12, "H100 NVL": 3.9e12, "H200": 4.8e12}
_PEAK_F32 = {"H100 PCIe": 51e12, "H100 NVL": 60e12}
_PEAK_F64 = {"H100 PCIe": 26e12, "H100 NVL": 30e12}

REPLACES = {
    "fft_stockham": "src/repro/kernels/fft_stockham.py:202",
    "fft_stockham_scale": "src/repro/kernels/fft_stockham.py:260",
    "spectral_scale": "src/repro/kernels/spectral_scale.py:46",
    "twiddle_pack": "src/repro/kernels/twiddle_pack.py:32",
    "fft_stockham_twiddle": "src/repro/kernels/fft_stockham.py:231",
}
SOURCES = {
    "fft_stockham": "src/repro_torch/kernels/csrc/fft_stockham.cu",
    "fft_stockham_scale": "src/repro_torch/kernels/csrc/fft_stockham.cu",
    "spectral_scale": "src/repro_torch/kernels/csrc/spectral_scale.cu",
    "twiddle_pack": "src/repro_torch/kernels/csrc/twiddle_pack.cu",
    "fft_stockham_twiddle": "src/repro_torch/kernels/csrc/fft_stockham.cu",
}
# cells per direction of the lead cases, timed repetitions per measurement
N = 256
REPS = 15
# launches per solve of each run, worked out from its plan (kernels not
# named launch 0 times).  DFT CELL directions: a pruned forward (1), the
# last one fused with the Green multiply (fft_stockham_scale), a pruned
# parity-split inverse (2).  A semi-unbounded CELL direction of n cells:
# the fused DCT-II / DST-II of length 2n (extension 4n, a power of two)
# and the Stockham irfft of its DCT-III / DST-III.  (E,E),(O,O),(E,O) at
# 384: two twiddle_packs after the library rfft of length 768, DCT-IV on
# the library FFT of length 192, the Green multiply on a real field.
# NODE: unpruned n+1-point DFT directions (1 each way), the Green
# multiply apart; the semi-even DCT-I (extension 4n) fused both ways.
EXPECTED = {
    "UUU": {"fft_stockham": 8, "fft_stockham_scale": 1},
    "UPU": {"fft_stockham": 7, "fft_stockham_scale": 1},
    "PPP": {"fft_stockham": 5, "fft_stockham_scale": 1},
    "UUU_B2": {"fft_stockham": 8, "fft_stockham_scale": 1},
    "SEMI_E": {"fft_stockham": 6, "fft_stockham_scale": 1,
               "fft_stockham_twiddle": 1},
    "SEMI_O": {"fft_stockham": 6, "fft_stockham_scale": 1,
               "fft_stockham_twiddle": 1},
    "SYM384": {"spectral_scale": 1, "twiddle_pack": 2},
    "LONG_UUU": {"fft_stockham": 8, "fft_stockham_scale": 1},
    "LONG_SEMI": {"fft_stockham": 6, "fft_stockham_scale": 1,
                  "fft_stockham_twiddle": 1},
    "LONG_XL_UUU": {"fft_stockham": 8, "fft_stockham_scale": 1},
    "LONG_XXL_UUU": {"fft_stockham": 8, "fft_stockham_scale": 1},
    "NODE_UUU": {"fft_stockham": 6, "spectral_scale": 1},
    "NODE_SEMI_E": {"fft_stockham": 4, "spectral_scale": 1,
                    "fft_stockham_twiddle": 2},
    # Biot-Savart runs the natural-layout stages (no FFT x Green fusion:
    # the curl sits between the last forward FFT and the Green multiply).
    # BS_TUBE, three sequential components: each forward is its z
    # DCT-II / DST-II (fused, 2n-point extension) and two pruned DFTs (1
    # each); each velocity backward is two pruned parity-split DFT
    # inverses (2 each) and the z DCT-III / DST-III (1 Stockham irfft):
    # 3 x 2 + 3 x 5 = 21 and 3.  Its Green multiply is a plain torch
    # multiply, as the reference's.  BS_UUU, one 3-wide pipeline: 3
    # pruned forwards, one Green multiply, 3 x 2 inverses
    "BS_TUBE": {"fft_stockham": 21, "fft_stockham_twiddle": 3},
    "BS_UUU": {"fft_stockham": 9, "spectral_scale": 1},
    # the tube at NODE: unpruned DFTs (1 each way), DST-I on its 64-point
    # rfft, DCT-I fused: forwards 3 x 2 DFTs + 2 DST-I, backwards 3 x 2
    # DFTs + 1 DST-I = 15; DCT-I 1 forward + 2 backward = 3
    "BS_TUBE_NODE_HEJ4": {"fft_stockham": 15, "fft_stockham_twiddle": 3},
    # the runtime phase's clean (P,P,P) 256^3 solves: the PPP pattern
    "GET_SOLVER": {"fft_stockham": 5, "fft_stockham_scale": 1},
    "VERIFY_PPP": {"fft_stockham": 5, "fft_stockham_scale": 1},
    # ABFT, clean solves at 256^3.  verify="abft" runs the verify-off
    # kernels (the sandwich is three dot products).  verify="abft-stages"
    # checks every stage: each transform's one-row reference row is one
    # more call of its kernel (a parity-split pruned inverse: 2), and the
    # last forward FFT is not fused, so the Green multiply moves from
    # fft_stockham_scale to spectral_scale.  (U,U,U): 3 x (1 + 1)
    # forwards + 3 x (2 + 2) inverses = 18.  (E,E),(O,E),(P,P): the
    # DCT-II twiddle and the DCT-IV / periodic FFTs twice each
    "ABFT_UUU/abft": {"fft_stockham": 8, "fft_stockham_scale": 1},
    "ABFT_UUU/abft-stages": {"fft_stockham": 18, "spectral_scale": 1},
    "ABFT_EOP/abft": {"fft_stockham": 4, "fft_stockham_scale": 1,
                      "fft_stockham_twiddle": 1},
    "ABFT_EOP/abft-stages": {"fft_stockham": 10, "spectral_scale": 1,
                             "fft_stockham_twiddle": 2},
    # the distributed phase runs the same kernels on each rank's pencil:
    # the single-process counts per rank, except that overlap:2 runs the
    # transform after each switch once per chunk (the last forward one
    # excepted: it is fused with the Green multiply on the whole block).
    # (U,U,U): forwards 1 + 2, backwards 2 + 2 x 2 + 2 x 2 = 13
    "DIST1_UUU/a2a:1": {"fft_stockham": 8, "fft_stockham_scale": 1},
    "DIST1_UUU/pipelined:2": {"fft_stockham": 8, "fft_stockham_scale": 1},
    "DIST1_UUU/fused:1": {"fft_stockham": 8, "fft_stockham_scale": 1},
    "DIST1_UUU/overlap:2": {"fft_stockham": 13, "fft_stockham_scale": 1},
    "DIST1_SEMI/a2a:1": {"fft_stockham": 6, "fft_stockham_scale": 1,
                         "fft_stockham_twiddle": 1},
    "DIST1_SEMI/overlap:2": {"fft_stockham": 10, "fft_stockham_scale": 1,
                             "fft_stockham_twiddle": 1},
    # NODE: the NODE_UUU counts; under overlap:2 the last forward FFT is
    # not fused (the Green multiply runs apart), so four of the six
    # transforms run once per chunk
    "DIST1_NODE/a2a:1": {"fft_stockham": 6, "spectral_scale": 1},
    "DIST1_NODE/overlap:2": {"fft_stockham": 10, "spectral_scale": 1},
    # the checked distributed solve: ABFT_UUU/abft-stages on the pencil;
    # under overlap:2 the four chunked stages' transforms and their
    # reference rows once per chunk, 3 + 5 x 2 = 13 calls doubled, 4 more
    # for the unfused last forward and its row.  verify="abft" on the
    # "cuda" engine runs the checked pipeline (no sandwich weight); on
    # "torch" the sandwich, with no hand kernel
    "DIST1_UUU/abft-stages/a2a:1": {"fft_stockham": 18, "spectral_scale": 1},
    "DIST1_UUU/abft-stages/overlap:2": {"fft_stockham": 30,
                                        "spectral_scale": 1},
    "DIST1_UUU/abft/cuda": {"fft_stockham": 18, "spectral_scale": 1},
    "DIST1_UUU/abft/torch": {},
    # four gloo ranks: summed over the ranks, each the one-rank count
    "DIST4_GLOO_UUU/a2a:1": {"fft_stockham": 32, "fft_stockham_scale": 4},
    "DIST4_GLOO_UUU/pipelined:2": {"fft_stockham": 32,
                                   "fft_stockham_scale": 4},
    "DIST4_GLOO_UUU/fused:1": {"fft_stockham": 32, "fft_stockham_scale": 4},
    "DIST4_GLOO_UUU/overlap:2": {"fft_stockham": 52, "fft_stockham_scale": 4},
    "DIST4_GLOO_POD/a2a:1": {"fft_stockham": 32, "fft_stockham_scale": 4},
    # NODE (E,E),(O,E),(P,P) n=64, per rank the single-process plan's 2
    # Stockham, 1 FFT x Green (the periodic r2c) and 3 twiddle launches
    # (the r2r kinds on power-of-two extensions); overlap:2 runs the three
    # transforms its chunked stages carry (forward d1, backward d1 and d0)
    # once per chunk
    "DIST4_GLOO_NODE/a2a:1": {"fft_stockham": 8, "fft_stockham_scale": 4,
                              "fft_stockham_twiddle": 12},
    "DIST4_GLOO_NODE/overlap:2": {"fft_stockham": 12,
                                  "fft_stockham_scale": 4,
                                  "fft_stockham_twiddle": 20},
    # the solve launcher (float64, NODE unless marked, a one-rank mesh
    # under a2a), per solve: (U,U,U) the NODE_UUU pattern; (P,P,P) the
    # periodic r2c fused with the Green multiply and four more DFTs, the
    # PPP pattern; (E,E),(O,E),(P,P) one rank's DIST4_GLOO_NODE/a2a:1;
    # CELL (U,U,U) with B=2 the UUU pattern; the "torch" engine none
    "LAUNCH_UNB": {"fft_stockham": 6, "spectral_scale": 1},
    "LAUNCH_UNB_TORCH": {},
    "LAUNCH_PER": {"fft_stockham": 5, "fft_stockham_scale": 1},
    "LAUNCH_MIX": {"fft_stockham": 2, "fft_stockham_scale": 1,
                   "fft_stockham_twiddle": 3},
    "LAUNCH_CELL_B2": {"fft_stockham": 8, "fft_stockham_scale": 1},
    "LAUNCH_UNB_SMALL": {"fft_stockham": 6, "spectral_scale": 1},
    # the dry run's flups-poisson cell at n=256 on a one-rank mesh (phase
    # 8h): NODE (U,U,U), the in-block batch of 2 in one pipeline
    "DRY_POISSON": {"fft_stockham": 6, "spectral_scale": 1},
}
# of those, the calls whose rows run on a thread-block cluster (8192 to
# 65536 points): the pruned 8192-point forward of LONG_UUU's x direction;
# LONG_SEMI's fused DCT-II on the 8192-point extension and the inverse of
# its DCT-III; LONG_XL_UUU's pruned 65536-point forward (a 16-block
# cluster) and the two 32768-point halves of its parity-split inverse;
# LONG_XXL_UUU's 65536-point inverse halves; and the calls whose rows take
# two passes (above 65536 points): LONG_XXL_UUU's pruned 131072-point
# forward
EXPECTED_CLUSTER = {
    "LONG_UUU": {"fft_stockham": 1},
    "LONG_SEMI": {"fft_stockham": 1, "fft_stockham_twiddle": 1},
    "LONG_XL_UUU": {"fft_stockham": 3},
    "LONG_XXL_UUU": {"fft_stockham": 2},
}
EXPECTED_TWO_PASS = {"LONG_XXL_UUU": {"fft_stockham": 1}}


def uuu_launches(label: str, ranks: int = 1) -> dict:
    """Launches per distributed (U,U,U) CELL solve under one comm or plan
    label (``strategy:n_chunks...``), summed over ``ranks``: the
    DIST1_UUU counts above, whatever the fold, order policy, radix and
    mesh; ``overlap:nc`` runs the transform after each switch once per
    chunk, 3 + 5 nc."""
    strategy, nc = label.split("|")[0].split(":")[:2]
    fft = 3 + 5 * int(nc) if strategy == "overlap" else 8
    return {"fft_stockham": fft * ranks, "fft_stockham_scale": ranks}


def node_uuu_launches(label: str) -> dict:
    """Launches of one NODE (U,U,U) local pipeline under a comm label:
    the NODE_UUU counts, except that ``overlap:nc`` runs four of the six
    transforms once per chunk, 2 + 4 nc (DIST1_NODE/overlap:2)."""
    strategy, nc = label.split("|")[0].split(":")[:2]
    fft = 2 + 4 * int(nc) if strategy == "overlap" else 6
    return {"fft_stockham": fft, "spectral_scale": 1}


# the run whose launches, shapes and times each kernel's record reports
TIMED_ON = {"fft_stockham": "UUU", "fft_stockham_scale": "UUU",
            "spectral_scale": "NODE_UUU", "twiddle_pack": "SYM384",
            "fft_stockham_twiddle": "SEMI_E"}
# further runs whose calls are timed and printed (not in the record): the
# other spectral_scale shapes (the checked (U,U,U) solve's among them),
# the cluster calls, and the checked stages' one-row reference rows
ALSO_TIMED = {"spectral_scale": ("SYM384", "BS_UUU", "ABFT_UUU/abft-stages"),
              "fft_stockham": ("LONG_UUU", "LONG_SEMI", "LONG_XL_UUU",
                               "LONG_XXL_UUU", "ABFT_UUU/abft-stages"),
              "fft_stockham_twiddle": ("LONG_SEMI", "ABFT_EOP/abft-stages")}
# a kernel under SHORT_MS per call is timed as LOOP back-to-back calls
SHORT_MS = 0.1
LOOP = 50
# device sleep (clock cycles, about 1 ms) ahead of each timed kernel call
AHEAD_CYCLES = 2_000_000
# relative E_inf of the NODE semi-even HEJ4 n=64 float64 case on the
# reference, repro.core.solver.PoissonSolver(engine="xla") on the CPU
# (the validation case of tests/test_validation.py); the port is held to
# 1.5 times it
SEMI_E_REF_EINF = 2.7204477288238545e-3
# absolute L_inf velocity error of the vortex tube at NODE n=64, HEJ4,
# spectral derivatives, float64 on the reference,
# repro.core.biot_savart.BiotSavartSolver (engine="xla") on the CPU
# (``linf(64, HEJ4, 0, NODE)`` of tests/test_biot_savart.py); the port is
# held to 1.5 times it
BS_TUBE_REF_LINF = 3.2254603631041157e-3


KERNELS = ("fft_stockham", "fft_stockham_scale", "spectral_scale",
           "twiddle_pack", "fft_stockham_twiddle")


def _describe(kname, x, a, kw):
    """A kernel call's descriptor: the kernel, x's shape, strides, offset
    and dtype, the other tensor arguments' shapes and the scalar
    arguments -- what a replay needs."""
    import torch
    args = tuple(("t", tuple(v.shape)) if torch.is_tensor(v)
                 else ("v", v) for v in a)
    return (kname, (tuple(x.shape), x.stride(), x.storage_offset(),
                    x.dtype), args, tuple(sorted(kw.items())))


@contextlib.contextmanager
def _recorded(run, calls):
    """Every kernel call through ``repro_torch.kernels.ops`` inside the
    block is recorded as ``calls[(run, descriptor)] += 1``."""
    from repro_torch.kernels import ops
    saved = {k: getattr(ops, k) for k in KERNELS}

    def recording(kname):
        def call(x, *a, **kw):
            key = (run, _describe(kname, x, a, kw))
            calls[key] = calls.get(key, 0) + 1
            return saved[kname](x, *a, **kw)
        return call
    for k in KERNELS:
        setattr(ops, k, recording(k))
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(ops, k, v)


# the environment by which the solve launcher's spawned ranks learn where
# to write their kernel calls and the run they are recorded under
RANK_CALLS_DIR = "CHIP_SMOKE_RANK_CALLS_DIR"
RANK_CALLS_RUN = "CHIP_SMOKE_RANK_CALLS_RUN"


def _launch_rank(rank, args, backend, devices, d):
    """A rank spawned by the solve launcher, in place of its
    ``_rank_main``: that rank with every kernel call recorded
    (``_recorded``) under ``$CHIP_SMOKE_RANK_CALLS_RUN`` and written to
    ``$CHIP_SMOKE_RANK_CALLS_DIR/calls<rank>.pkl`` for phase 9."""
    import os
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch.solve import _rank_main
    calls = {}
    with _recorded(os.environ[RANK_CALLS_RUN], calls):
        res = _rank_main(rank, args, backend, devices, d)
    with open(os.path.join(os.environ[RANK_CALLS_DIR], f"calls{rank}.pkl"),
              "wb") as fh:
        pickle.dump(calls, fh)
    return res


# the distributed phase: the one-rank mesh's backend, how the four gloo
# ranks start, the process groups' timeout, the comm strategies run, and
# search_plan's grid, timed points and solves per timed point.  Of the
# 144 points at 128^3 the cost model prunes 64 and ranks every radix-2
# point behind the 40 live radix-4 ones (the default shortlist, 14, times
# none), so k = 48 also times the first 8 radix-2 points
DIST_BACKEND = "nccl"
DIST_START = "spawn"
GROUP_TIMEOUT_S = 300
DIST_STRATEGIES = ("a2a:1", "pipelined:2", "fused:1", "overlap:2")
PLAN_N = 128
PLAN_K = 48
PLAN_REPS = 2


def _dist4_rank(rank, world, d):
    """One of the four gloo ranks of DIST4_GLOO on the one card: (U,U,U)
    under every strategy and comm="auto" (brute and guided, re-timed head
    to head), the NODE uneven split in float64 and the pod batch, each
    against the parent's single-process solve; then search_plan over the
    three meshes of four ranks and the slab meshes' collective census.
    Writes its launch counts, kernel calls, errors, searches and times to
    ``<d>/rank<rank>.pkl``."""
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.core.bc import BCType, DataLayout
    from repro_torch.core.comm import (cfg_label, collective_census,
                                       label_to_cfg)
    from repro_torch.distributed import pencil
    from repro_torch.distributed.pencil import DistributedPoissonSolver
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.plan import PlanPoint, predict_bytes, search_plan

    d = Path(d)
    with open(d / "params.json") as fh:
        prm = json.load(fh)
    dev = torch.device(prm["device"])
    cuda = dev.type == "cuda"
    if cuda:
        # every rank on the one card
        dev = torch.device("cuda", dev.index or 0)
        torch.cuda.set_device(dev)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    dist.init_process_group(
        "gloo", init_method=f"file://{d}/gloo", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))

    def load(key, dtype=None):
        t = torch.from_numpy(np.load(d / f"{key}.npy"))
        return t.to(dev) if dtype is None else t.to(dev, dtype)

    out = {"runs": {}, "calls": {}}

    def counted(run, fn, want):
        with _recorded(run, out["calls"]):
            sync()
            reset_launches()
            u = fn()
            sync()
        rel = ((u - want).abs().max() / want.abs().max()).item()
        if not torch.isfinite(u).all() or u.shape != want.shape:
            raise AssertionError(f"{run}: rank {rank} output {u.shape}")
        out["runs"][run] = {"counts": {k: v for k, v in LAUNCHES.items()
                                       if v}, "rel": rel}
        return u

    def median_ms(fn):
        fn()
        ts = []
        for _ in range(prm["reps"]):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            ts.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(ts)

    U = (BCType.UNB, BCType.UNB)
    E, O, P = BCType.EVEN, BCType.ODD, (BCType.PER, BCType.PER)
    n4 = prm["n4"]
    f4, u4, g4 = load("f4"), load("u4"), np.load(d / "g4.npy")
    mesh = init_device_mesh(dev.type, (2, 2), mesh_dim_names=("data", "model"))
    kw = dict(mesh=mesh, device=dev)
    for lbl in prm["strategies"]:
        run = f"DIST4_GLOO_UUU/{lbl}"
        ds = DistributedPoissonSolver((n4,) * 3, 1.0, (U, U, U),
                                      comm=label_to_cfg(lbl),
                                      _green_cache=g4, **kw)
        counted(run, lambda: ds.solve(f4), u4)
        if ds.stats["degradations"] or ds.stats["retries"]:
            raise AssertionError(f"{run}: {ds.stats}")
        x = ds.shard_input(f4)
        out["runs"][run]["ms"] = median_ms(lambda: ds.solve_local(x))
    # comm="auto" both ways: the whole candidate grid ("brute") and the
    # cost model's shortlist ("guided", the default); the expected
    # launches follow the winner
    out["expected"] = {}
    searches = {}
    for how in ("brute", "guided"):
        sync()
        t0 = time.perf_counter()
        ds = DistributedPoissonSolver((n4,) * 3, 1.0, (U, U, U), comm="auto",
                                      autotune_search=how, _green_cache=g4,
                                      **kw)
        sync()
        wall = time.perf_counter() - t0
        run = f"DIST4_GLOO_UUU/auto:{how}"
        out["expected"][run] = cfg_label(ds.comm)
        counted(run, lambda: ds.solve(f4), u4)
        searches[how] = ds
        out[how] = {"wall_s": wall, "winner": cfg_label(ds.comm),
                    "timed": dict(ds.autotune_results),
                    "shortlist": ds.autotune_census.get("shortlist"),
                    "rel": out["runs"][run]["rel"]}
    # the guided winner against the brute one, re-timed head to head in
    # turns (the reference oracle's protocol); each sample agreed (MAX)
    bw, gw = out["brute"]["winner"], out["guided"]["winner"]
    best = {bw: math.inf, gw: math.inf}
    if bw != gw:
        dg = searches["guided"]
        time_cfg = dg.comm_time_fn(reps=3)
        for r in range(8):
            for lbl in ((bw, gw) if r % 2 == 0 else (gw, bw)):
                t = dg._agree([time_cfg(label_to_cfg(lbl))])[0]
                best[lbl] = min(best[lbl], t)
    out["head_to_head"] = best
    del searches
    # the node-centered uneven split: 65 points over 2 ranks a direction
    fn, un, gn = load("fn"), load("un"), np.load(d / "gn.npy")
    for lbl in ("a2a:1", "overlap:2"):
        run = f"DIST4_GLOO_NODE/{lbl}"
        ds = DistributedPoissonSolver(
            (64,) * 3, 1.0, ((E, E), (O, E), P), DataLayout.NODE,
            comm=label_to_cfg(lbl), dtype=torch.float64, _green_cache=gn,
            **kw)
        counted(run, lambda: ds.solve(fn), un)
        if out["runs"][run]["rel"] > 1e-10:
            raise AssertionError(f"{run}: {out['runs'][run]['rel']:.3e}")
    # the pod batch: two fields over the "pod" axis of a (2, 1, 2) mesh
    mesh3 = init_device_mesh(dev.type, (2, 1, 2),
                             mesh_dim_names=("pod", "data", "model"))
    ds = DistributedPoissonSolver((n4,) * 3, 1.0, (U, U, U), mesh=mesh3,
                                  batch_axis="pod", device=dev,
                                  _green_cache=g4)
    counted("DIST4_GLOO_POD/a2a:1", lambda: ds.solve(torch.stack(
        [f4, 2.0 * f4])), torch.stack([u4, 2.0 * u4]))
    # search_plan over mesh_shapes_for(4) = (2, 2), (1, 4), (4, 1), both
    # order policies and radix 4 and 2 on the "cuda" engine; each timed
    # solve's launches read around it, by plan point
    points = {}
    real_solve = pencil.DistributedPoissonSolver.solve

    def solve_counted(self, f, verify=None):
        sync()
        reset_launches()
        u = real_solve(self, f, verify)
        sync()
        a1, a2 = self.axes
        lbl = PlanPoint(self.comm.strategy, self.comm.n_chunks,
                        self.comm.fold, self.comm.chunk_axis,
                        self._ctor["order_policy"], self.plan.doubling,
                        self.relayout, self.engine.max_radix,
                        (self._size[a1], self._size[a2])).label()
        got = {k: v for k, v in LAUNCHES.items() if v}
        if points.setdefault(lbl, got) != got:
            raise AssertionError(f"search_plan {lbl}: launches {got}, then "
                                 f"{points[lbl]}")
        return u

    plan_kw = dict(device=dev, cache_path=str(d / "plans.json"),
                   k=prm["plan_k"], reps=prm["plan_reps"])
    n_sp = prm["n_plan"]
    census = {}
    pencil.DistributedPoissonSolver.solve = solve_counted
    try:
        with _recorded("DIST4_GLOO_PLAN", out["calls"]):
            sync()
            t0 = time.perf_counter()
            dec = search_plan((n_sp,) * 3, 1.0, (U, U, U), census=census,
                              **plan_kw)
            sync()
            wall = time.perf_counter() - t0
    finally:
        pencil.DistributedPoissonSolver.solve = real_solve
    t0 = time.perf_counter()
    dec2 = search_plan((n_sp,) * 3, 1.0, (U, U, U), **plan_kw)
    if census["failed"] or set(points) != set(census["timed"]):
        raise AssertionError(f"search_plan: failed {census['failed']}, "
                             f"timed {sorted(census['timed'])}, counted "
                             f"{sorted(points)}")
    out["plan"] = {"wall_s": wall, "again_s": time.perf_counter() - t0,
                   "space": census["space"],
                   "pruned": len(census["pruned_padding"]),
                   "shortlist": census["shortlist"],
                   "timed": census["timed"], "winner": dec.point.label(),
                   "seconds": dec.seconds, "points": points,
                   "again": [dec.cached, dec2.cached, dec2.point == dec.point]}
    # the slab meshes: only the non-unit axis's two switches are issued,
    # with the bytes the predictor names
    out["slabs"] = {}
    for ms in ((1, 4), (4, 1)):
        slab = init_device_mesh(dev.type, ms, mesh_dim_names=("data",
                                                             "model"))
        ds = DistributedPoissonSolver((n4,) * 3, 1.0, (U, U, U), mesh=slab,
                                      device=dev, _green_cache=g4)
        x = ds.shard_input(f4)
        with collective_census() as c:
            ds.solve_local(x)
        got = [e["bytes"] for e in c.per_collective]
        want = predict_bytes(ds.plan, ms[0], ms[1], ds.dtype, ds.comm)
        if got != want or len(got) != 2:
            raise AssertionError(f"slab mesh {ms}: census {got}, predicted "
                                 f"{want}")
        out["slabs"][f"{ms[0]}x{ms[1]}"] = got
    out["abft"] = _dist4_abft(rank, dev, f4, n4)
    for run, res in out["runs"].items():
        if res["rel"] > 1e-5:
            raise AssertionError(f"{run}: rank {rank} relative max |diff| "
                                 f"{res['rel']:.3e} > 1e-5")
    with open(d / f"rank{rank}.pkl", "wb") as fh:
        pickle.dump(out, fh)
    dist.barrier()
    dist.destroy_process_group()


def _dist4_abft(rank, dev, f, n):
    """The assertions of the reference's distributed SDC script
    (``tests/test_abft.py``) on the four gloo ranks, mesh (2, 2), float32,
    engine "torch" (the script's "xla"): (P,P,P) under a2a and (U,P,U)
    under pipelined:2 with verify="abft" -- the clean guard gives the
    verify-off bits, a count=2 flip at fwd.0 is localized and repaired to
    those bits, a wire flip trips the sandwich and the re-dispatch comes
    back clean -- then under "abft-stages" a wire flip attributed to the
    wire, and a persistent flip at green raising SolveError.  Raises on
    the first failed assertion; returns what it saw."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.core.bc import BCType
    from repro_torch.core.comm import CommConfig
    from repro_torch.distributed.pencil import DistributedPoissonSolver
    from repro_torch.runtime import SolveError, faults
    t0 = time.perf_counter()
    mesh = init_device_mesh(dev.type, (2, 2),
                            mesh_dim_names=("data", "model"))
    P, U = (BCType.PER, BCType.PER), (BCType.UNB, BCType.UNB)
    kw = dict(mesh=mesh, engine="torch", device=dev)
    seen = {}

    def check(what, ok, detail):
        if not ok:
            raise AssertionError(f"DIST4_GLOO_ABFT {what}: rank {rank}: "
                                 f"{detail}")

    for tag, bcs, comm in (("PPP/a2a:1", (P, P, P), CommConfig("a2a")),
                           ("UPU/pipelined:2", (U, P, U),
                            CommConfig("pipelined", 2))):
        s = DistributedPoissonSolver((n,) * 3, 1.0, bcs, comm=comm,
                                     verify="abft", **kw)
        want = s.solve(f)
        off = DistributedPoissonSolver((n,) * 3, 1.0, bcs, comm=comm,
                                       _green_cache=s._green_raw, **kw)
        check(f"{tag} clean", torch.equal(want, off.solve(f))
              and not s.stats.get("integrity"), s.stats)
        with faults.FaultPlan([dict(kind="flip", stage="fwd.0",
                                    count=2)]) as plan:
            got = s.solve(f)
        recs = s.stats["integrity"]
        check(f"{tag} fwd.0", len(plan.log) == 2
              and recs[0]["stage"] == "solve.linearity"
              and recs[0]["action"] == "localize"
              and any(r["stage"].split("#")[0] == "fwd.0"
                      and r["action"] == "recompute" for r in recs[1:])
              and torch.equal(got, want) and not s.stats["degradations"],
              (plan.log, recs, s.stats["degradations"]))
        stages = [(r["stage"], r["action"]) for r in recs]
        s.stats["integrity"] = []
        with faults.FaultPlan([dict(kind="flip", stage="comm.wire.*",
                                    count=1)]) as plan:
            got = s.solve(f)
        check(f"{tag} wire", plan.log and any(
            r["stage"] == "solve.linearity" for r in s.stats["integrity"])
            and torch.equal(got, want), (plan.log, s.stats["integrity"]))
        seen[tag] = {"fwd.0": stages, "wire": [
            (r["stage"], r["action"]) for r in s.stats["integrity"]]}
    s = DistributedPoissonSolver((n,) * 3, 1.0, (P, P, P),
                                 comm=CommConfig("a2a"),
                                 verify="abft-stages", **kw)
    want = s.solve(f)
    scale = want.abs().max().item()
    with faults.FaultPlan([dict(kind="flip", stage="comm.wire.*",
                                count=1)]) as plan:
        got = s.solve(f)
    wire = [r for r in s.stats["integrity"] if r["kind"] == "wire"]
    err = (got - want).abs().max().item()
    check("abft-stages wire", plan.log and wire
          and all(r["stage"].startswith("wire.") for r in wire)
          and err <= 1e-5 * scale, (plan.log, s.stats["integrity"], err))
    seen["stages/wire"] = [(r["stage"], r["kind"], r["action"])
                           for r in s.stats["integrity"]]
    s = DistributedPoissonSolver((n,) * 3, 1.0, (P, P, P),
                                 comm=CommConfig("a2a"),
                                 verify="abft-stages",
                                 _green_cache=s._green_raw, **kw)
    try:
        with faults.FaultPlan([dict(kind="flip", stage="green",
                                    count=-1)]):
            s.solve(f)
        raised = None
    except SolveError as e:
        raised = e
    check("persistent green", raised is not None
          and raised.stage == "verify.abft@green", repr(raised))
    seen["persistent"] = [raised.stage,
                          [r["action"] for r in raised.degradations]]
    seen["wall_s"] = time.perf_counter() - t0
    return seen


# the serve phase: each traffic key's cells per direction (and the
# launch pattern of EXPECTED it runs), the grids the coalescing numbers
# are taken at with each tenant's requests per burst and the rounds of
# bursts per server, the launcher's grid, and the one-batch sizes whose
# launches are counted with the rank each pads to
SERVE_N = {"UUU": N, "PPP": N, "SEMI": N // 2, "SYM": 192}
SERVE_PATTERN = {"UUU": "UUU", "PPP": "PPP", "SEMI": "SEMI_E",
                 "SYM": "SYM384"}
SERVE_ROUNDS = {N: (4, 3), N // 2: (16, 3)}
SERVE_LAUNCHER_N = N // 2
SERVE_BATCHES = {1: 1, 2: 2, 3: 4, 8: 8}


def _serve_phase(dev, smi, run_counted):
    """Phase 8b: the solve server (``repro_torch.serve``) on the card, as
    the module docstring lists it.  ``run_counted(run, fn)`` runs
    ``fn()`` with the launch counts set to 0 just before and read just
    after, held to ``EXPECTED[run]``, each kernel call recorded for
    phase 9.  Raises on the first failed check; returns each counted
    run's launches."""
    import os
    import tempfile
    from concurrent.futures import ThreadPoolExecutor
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.core.bc import BCType
    from repro_torch.core.comm import CommConfig
    from repro_torch.core.solver import clear_solver_cache, get_solver
    from repro_torch.runtime import faults
    from repro_torch.serve import PlanSpec, PoissonServer
    from repro_torch.serve.pool import _green_bytes

    t0 = time.perf_counter()
    U, P = (BCType.UNB, BCType.UNB), (BCType.PER, BCType.PER)
    E, O = BCType.EVEN, BCType.ODD
    bcs = {"UUU": (U, U, U), "PPP": (P, P, P),
           "SEMI": ((BCType.UNB, E), U, U), "SYM": ((E, E), (O, O), (E, O))}
    rng = np.random.default_rng(8)
    mem0 = torch.cuda.memory_allocated()
    clear_solver_cache()

    # -- 1. traffic at full width, float32, engine "cuda" -----------------
    specs, fields, indiv = {}, {}, {}
    for key, n in SERVE_N.items():
        spec = specs[key] = PlanSpec((n,) * 3, bcs[key], device=dev)
        solver = get_solver((n,) * 3, 1.0, bcs[key], device=dev)
        if spec.build() is not solver:
            raise AssertionError(f"SERVE_{key}: PlanSpec.build missed the "
                                 "get_solver cache")
        fields[key] = [rng.standard_normal((n,) * 3, dtype=np.float32)
                       for _ in range(8)]
        # the individual solves every served response is held to
        indiv[key] = [solver.solve(f).cpu().numpy() for f in fields[key]]

    def bitexact(key, i, r):
        if not np.array_equal(r.u, indiv[key][i]):
            raise AssertionError(
                f"SERVE_{key}: field {i} served at batch {r.batch_size} "
                f"(rank {r.padded_to}) differs from its individual solve by "
                f"{np.abs(r.u - indiv[key][i]).max():.3e}")

    served = {}
    for key, spec in specs.items():
        for b, rank in SERVE_BATCHES.items():
            run = f"SERVE_{key}/B{b}"
            EXPECTED[run] = EXPECTED[SERVE_PATTERN[key]]
            srv = PoissonServer(max_batch=8, max_delay_ms=60_000)

            def one_batch(srv=srv, spec=spec, fs=fields[key][:b]):
                """b requests, one flush (full at 8, else the drain)."""
                srv.start()
                futs = [srv.submit(f, spec, tenant=f"w{i}")
                        for i, f in enumerate(fs)]
                srv.stop(drain=True)
                return [fut.result() for fut in futs]
            res, counts = run_counted(run, one_batch)
            st = srv.server_stats()
            got = {(r.batch_size, r.padded_to) for r in res}
            if st["batches"] != 1 or got != {(b, rank)}:
                raise AssertionError(f"{run}: {st['batches']} batches, "
                                     f"(batch, rank) {got}")
            for i, r in enumerate(res):
                bitexact(key, i, r)
            served[run] = {k: v for k, v in counts.items() if v}
        print(f"SERVE_{key} n={SERVE_N[key]} float32 cuda: one batch at "
              f"each rank {sorted(SERVE_BATCHES.values())} launches "
              f"{served[run]} (the {SERVE_PATTERN[key]} pattern, the same "
              "at every rank); every row the bits of its individual solve")

    # eight tenant threads, four requests each in a burst, two tenants a
    # key; the main thread reads every future
    keys = list(specs)

    def client(t):
        key = keys[t % len(keys)]
        lo = (t // len(keys)) * 4
        return [(key, i, srv.submit(fields[key][i], specs[key],
                                    tenant=f"t{t}"))
                for i in range(lo, lo + 4)]
    with PoissonServer(max_batch=8, max_delay_ms=4) as srv, \
            ThreadPoolExecutor(8) as ex:
        subs = [ex.submit(client, t) for t in range(8)]
        out = [(key, i, fut.result(timeout=600)) for s in subs
               for key, i, fut in s.result()]
        stats = srv.server_stats()
    sizes = collections.defaultdict(set)
    for key, i, r in out:
        bitexact(key, i, r)
        if r.degradations or r.integrity:
            raise AssertionError(f"SERVE_{key}: records {r.degradations} "
                                 f"{r.integrity}")
        sizes[key].add((r.batch_size, r.padded_to))
    print(f"SERVE traffic (8 tenants x 4 requests, max_batch 8, 4 ms): "
          f"{stats['completed']} served in {stats['batches']} batches "
          f"(full {stats['full_flushes']}, deadline "
          f"{stats['deadline_flushes']}, drain {stats['drain_flushes']}), "
          f"padded rows {stats['padded_rhs']}; (batch, rank) per key "
          + "; ".join(f"{k} {sorted(v)}" for k, v in sizes.items())
          + "; every response the bits of its individual solve")
    # the "torch" engine (cuFFT): a batch of 8 against individual solves,
    # printed (cuFFT may plan another batch count differently)
    for key in ("UUU", "PPP"):
        n = N // 2
        spec = PlanSpec((n,) * 3, bcs[key], engine="torch", device=dev)
        fs = [rng.standard_normal((n,) * 3, dtype=np.float32)
              for _ in range(8)]
        with PoissonServer(max_batch=8, max_delay_ms=60_000) as srv:
            futs = [srv.submit(f, spec) for f in fs]
        dev_ = max(float(np.abs(fut.result().u - spec.build().solve(f)
                                .cpu().numpy()).max())
                   for f, fut in zip(fs, futs))
        print(f"SERVE_TORCH_{key} n={n} float32 torch engine: a batch of 8 "
              f"against individual solves, max |dev| {dev_:.3e} ("
              + ("bit-exact" if dev_ == 0.0 else "NOT bit-exact") + ")")

    # -- 2. numbers: coalescing, percentiles, the copy split, the pool ----
    # a coalescing server and a sequential one (max_batch=1), both warm at
    # every rank, take the same bursts in alternated rounds (C S, S C,
    # ...), so a drift of the host's speed falls on both alike
    for n, (requests, rounds) in SERVE_ROUNDS.items():
        nspecs = [PlanSpec((n,) * 3, bcs[k], device=dev)
                  for k in ("UUU", "PPP")]
        fs = [rng.standard_normal((n,) * 3, dtype=np.float32)
              for _ in range(8)]

        def burst(srv, nspecs=nspecs, fs=fs, requests=requests):
            """8 tenant threads, the keys alternating, each submitting its
            requests at once and reading their futures: the wall from
            the first submit to the last answer."""
            def client(t):
                futs = [srv.submit(fs[(t + i) % 8], nspecs[t % 2],
                                   tenant=f"t{t}") for i in range(requests)]
                return [fut.result(timeout=600) for fut in futs]
            with ThreadPoolExecutor(8) as ex:
                t1 = time.perf_counter()
                list(ex.map(client, range(8)))
                return time.perf_counter() - t1

        with PoissonServer(max_batch=8, max_delay_ms=4) as co, \
                PoissonServer(max_batch=1, max_delay_ms=4) as seq:
            srvs = {"coalesced": co, "sequential": seq}
            for srv in srvs.values():
                for spec in nspecs:
                    for b in srv.batch_ranks:
                        for fut in [srv.submit(f, spec, tenant="_warm")
                                    for f in fs[:b]]:
                            fut.result(timeout=600)
            warm = co.server_stats()
            walls = {how: [] for how in srvs}
            for r in range(rounds):
                for how in (list(srvs) if r % 2 == 0 else list(srvs)[::-1]):
                    walls[how].append(burst(srvs[how]))
            st = co.server_stats()
            tstats = {how: srv.tenant_stats() for how, srv in srvs.items()}
            mem = torch.cuda.memory_allocated()
        per = 8 * requests
        med = {how: statistics.median(w) for how, w in walls.items()}
        ratios = [s_ / c_ for c_, s_ in zip(walls["coalesced"],
                                            walls["sequential"])]
        batches = st["batches"] - warm["batches"]
        print(f"SERVE_NUMBERS n={n} float32 cuda, (U,U,U) + (P,P,P), 8 "
              f"tenants x {requests} requests a burst, {rounds} bursts a "
              f"server in alternated rounds ({per * rounds} requests "
              f"each): coalesced {per / med['coalesced']:.2f} req/s "
              f"(median wall {med['coalesced']:.4f} s), sequential "
              f"{per / med['sequential']:.2f} req/s (median wall "
              f"{med['sequential']:.4f} s), coalescing speedup "
              f"{med['sequential'] / med['coalesced']:.3f}x (the rounds' "
              f"ratios {min(ratios):.3f} to {max(ratios):.3f}, median "
              f"{statistics.median(ratios):.3f}); mean occupancy "
              f"{(st['completed'] - warm['completed']) / batches:.3f}, "
              f"padded rows {st['padded_rhs'] - warm['padded_rhs']}, "
              f"batches {batches}; card: {smi}")
        for how, w in walls.items():
            print(f"  {how} walls s: " + " ".join(f"{x:.4f}" for x in w))
        for how, ts in tstats.items():
            print(f"  {how} p50/p95/p99 ms per tenant: " + "; ".join(
                f"{t} {s['p50_ms']:.2f}/{s['p95_ms']:.2f}/{s['p99_ms']:.2f}"
                for t, s in sorted(ts.items()) if t != "_warm"))
        green = sum(_green_bytes(s.build()) for s in nspecs)
        print(f"  pool estimate {st['pool']['total_bytes'] / 2 ** 30:.3f} "
              f"GiB ({st['pool']['size']} plans; their device Green copies "
              f"{green / 2 ** 30:.3f} GiB, the rest three float64 fields "
              f"per served rank); torch.cuda.memory_allocated "
              f"{mem / 2 ** 30:.3f} GiB, {(mem - mem0) / 2 ** 30:.3f} GiB "
              "above the phase's start")
        del fs
        fb = rng.standard_normal((8,) + (n,) * 3, dtype=np.float32)
        for spec, key in zip(nspecs, ("UUU", "PPP")):
            solver = spec.build()
            parts = []
            for rank in (1, 2, 4, 8):
                reps = []
                for _ in range(3):
                    h0 = time.perf_counter()
                    hb = np.stack(list(fb[:rank]), axis=0)
                    h_ms = (time.perf_counter() - h0) * 1e3
                    ev = [torch.cuda.Event(enable_timing=True)
                          for _ in range(4)]
                    ev[0].record()
                    x = torch.from_numpy(hb).to(dev)
                    ev[1].record()
                    u = solver.solve(x)
                    ev[2].record()
                    u.cpu()
                    ev[3].record()
                    ev[3].synchronize()
                    reps.append([h_ms] + [ev[i].elapsed_time(ev[i + 1])
                                          for i in range(3)])
                    del x, u
                h_ms, h2d, sol, d2h = (statistics.median(c)
                                       for c in zip(*reps))
                tot = h2d + sol + d2h
                # what one batch allocates above what is resident, beside
                # the pool's workspace estimate for the rank
                torch.cuda.synchronize()
                resident = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                solver.solve(torch.from_numpy(hb).to(dev)).cpu()
                peak = torch.cuda.max_memory_allocated() - resident
                parts.append(f"rank {rank}: H2D {h2d:.3f} + solve {sol:.3f}"
                             f" + D2H {d2h:.3f} ms (copies "
                             f"{(h2d + d2h) / tot:.1%} of {tot:.3f} ms; "
                             f"host np.stack {h_ms:.3f} ms; peak "
                             f"{peak / 2 ** 30:.3f} GiB above resident, "
                             f"estimated {3 * hb.size * 8 / 2 ** 30:.3f})")
            print(f"  {key} n={n} batch split (CUDA events, median of 3): "
                  + "; ".join(parts))
        del fb

    # -- 3. fault isolation: one armed request of four co-batched ---------
    spec, fs = specs["PPP"], fields["PPP"][:4]
    plan = faults.FaultPlan([{"kind": "error", "stage": "solve.dispatch",
                              "count": 1}])
    with PoissonServer(max_batch=4, max_delay_ms=50) as srv:
        r0 = srv.solve(fs[0], spec, tenant="before")
        futs = [srv.submit(f, spec, tenant=f"f{i}",
                           fault_plan=plan if i == 2 else None)
                for i, f in enumerate(fs)]
        res = [fut.result(timeout=600) for fut in futs]
        r1 = srv.solve(fs[0], spec, tenant="after")
        tstats = srv.tenant_stats()
    acts = [[d["action"] for d in r.degradations] for r in res]
    rel = max(float(np.abs(r.u - indiv["PPP"][i]).max()
                    / np.abs(indiv["PPP"][i]).max())
              for i, r in enumerate(res))
    if (len(plan.log) != 1 or [r.batch_size for r in res] != [4] * 4
            or acts != [["engine:cuda->torch"]] * 4
            or any(len(tstats[f"f{i}"]["degradations"]) != 1
                   for i in range(4))
            or rel > 1e-5 or r0.degradations or r1.degradations
            or not np.array_equal(r0.u, r1.u)
            or spec.build()._cfg["engine"] != "cuda"):
        raise AssertionError(f"SERVE fault isolation: fired {plan.log}, "
                             f"batches {[r.batch_size for r in res]}, "
                             f"actions {acts}, rel {rel:.3e}, before "
                             f"{r0.degradations}, after {r1.degradations}")
    bitexact("PPP", 0, r0)
    print(f"SERVE fault isolation (P,P,P) n={SERVE_N['PPP']}: one of 4 "
          f"co-batched requests armed (error at solve.dispatch): the batch "
          f"took {acts[0]} once, every tenant saw that one record, every "
          f"answer within {rel:.3e} relative of the clean cuda solve; the "
          "next clean request on the warm plan: no record, the same bits")

    # -- 4. the reference's serve soak on a one-rank mesh -----------------
    tmp = tempfile.TemporaryDirectory()
    dist.init_process_group(
        DIST_BACKEND, init_method=f"file://{tmp.name}/serve", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    mesh = init_device_mesh(dev.type, (1, 1),
                            mesh_dim_names=("data", "model"))
    n = SERVE_N["PPP"]
    # engine "torch": the distributed sandwich's weight comes from its
    # autograd (on "cuda" verify="abft" runs the checked pipeline alone)
    soak = PlanSpec((n,) * 3, bcs["PPP"], engine="torch", device=dev,
                    mesh=mesh, solver_kw=(("comm", CommConfig("a2a")),))
    fs = fields["PPP"][:4]
    t1 = time.perf_counter()
    with PoissonServer(max_batch=4, max_delay_ms=1.0, verify="abft") as srv:
        base = [srv.solve(f, soak, tenant="warm") for f in fs]
        if any(r.integrity or r.degradations for r in base):
            raise AssertionError(f"SERVE soak baseline: "
                                 f"{[r.integrity for r in base]}")
        plan = faults.FaultPlan([dict(kind="flip", stage="fwd.0", count=2)])
        bad = srv.submit(fs[0], soak, tenant="chaos",
                         fault_plan=plan).result(timeout=600)
        stages = [r["stage"] for r in bad.integrity]
        if (not stages or stages[0] != "solve.linearity"
                or not any(s.split("#")[0] == "fwd.0" for s in stages)
                or not np.array_equal(bad.u, base[0].u)):
            raise AssertionError(f"SERVE soak chaos: {bad.integrity}, "
                                 f"bits {np.array_equal(bad.u, base[0].u)}")
        for t in range(6):
            for i, f in enumerate(fs):
                r = srv.solve(f, soak, tenant=f"t{t}")
                if (r.integrity or r.degradations
                        or not np.array_equal(r.u, base[i].u)):
                    raise AssertionError(f"SERVE soak t{t} field {i}: "
                                         f"{r.integrity} {r.degradations}")
    rel = max(float(np.abs(r.u - indiv["PPP"][i]).max()
                    / np.abs(indiv["PPP"][i]).max())
              for i, r in enumerate(base))
    if rel > 1e-5:
        raise AssertionError(f"SERVE soak: {rel:.3e} from the cuda solve")
    print(f"SERVE soak (P,P,P) n={n} float32, one-rank {DIST_BACKEND} mesh "
          f"(1, 1), a2a, verify='abft', engine torch: the flip-armed tenant "
          f"localized {[(r['stage'], r['action']) for r in bad.integrity]} "
          f"and repaired to the baseline bits; 6 tenants x 4 fields after "
          f"it bit-exact, no integrity or degradation record; baseline "
          f"within {rel:.3e} of the single-process cuda solve; "
          f"{time.perf_counter() - t1:.1f} s")
    dist.destroy_process_group()
    tmp.cleanup()
    clear_solver_cache()

    # -- 5. the launcher, a process of its own, float64 fields -----------
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "serve.json")
        cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--n",
               str(SERVE_LAUNCHER_N), "--tenants", "8", "--requests", "4",
               "--max-batch", "8", "--seq", "--json", path]
        t1 = time.perf_counter()
        p = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                           env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                           timeout=600)
        if (p.returncode != 0 or "max |dev| vs per-request solves: "
                "0.000e+00" not in p.stdout):
            raise AssertionError(f"launcher: exit {p.returncode}\n"
                                 f"{p.stdout[-3000:]}\n{p.stderr[-3000:]}")
        with open(path) as fh:
            payload = json.load(fh)
    if (payload["max_abs_dev_vs_individual"] != 0.0
            or "coalescing_speedup" not in payload
            or payload["server"]["completed"]
            != payload["server"]["admitted"]):
        raise AssertionError(f"launcher payload: {payload}")
    print(f"SERVE launcher ({' '.join(cmd[1:3])} --n {SERVE_LAUNCHER_N} ... "
          f"--seq), exit 0 in {time.perf_counter() - t1:.1f} s, payload "
          "read back:")
    for line in p.stdout.splitlines():
        print(f"  {line}")
    print(f"serve phase: {time.perf_counter() - t0:.1f} s")
    return served


# the launcher phase: the full-width grid, the smaller one-rank grid the
# error must fall from, the repeats and steps of every one-rank run, the
# four-rank runs' grid and repeats, and the device loss the survivable
# loop takes (the reference's own spec, tests/test_faults.py)
LAUNCH_N = N
LAUNCH_SMALL_N = 64
LAUNCH_REPS = ["--repeats", "5", "--steps", "5"]
LAUNCH_RANK_REPS = ["--repeats", "2"]
LAUNCH_FAULTS = '[{"kind": "device_loss", "stage": "driver", "step": 3}]'
CHAOS_KEYS = {"steps", "final_mesh", "device_losses", "err_inf",
              "fault_log", "retries", "degradations", "integrity"}
# the survivable loop's child process: the launcher with its report hook
# writing rank 0's record beside the checkpoints, and its spawned ranks
# recording their kernel calls (``_launch_rank``)
_LOSS_SCRIPT = r"""
import json, sys
import chip_smoke
from repro_torch.launch import solve
def keep(rec):
    with open(sys.argv[1], "w") as fh:
        json.dump({k: rec[k] for k in ("err", "backend", "devices",
                                       "launches", "final_mesh")}, fh)
solve.report = keep
solve._rank_main = chip_smoke._launch_rank
solve.main(sys.argv[2:])
"""


def _launch_phase(dev, smi, run_counted, calls):
    """Phase 8c: the solve launcher (``repro_torch.launch.solve``) and the
    checkpoints on the card, as the module docstring lists them.
    ``run_counted(run, fn, expected)`` runs ``fn()`` with the launch counts
    set to 0 just before and read just after, held to ``expected(fn())``,
    each kernel call recorded for phase 9; the kernel calls of the
    launcher's spawned ranks are recorded there (``_launch_rank``) and
    merged into ``calls``.  The one-rank runs of one plan share its host
    Green assembly where the run shares them (``_GreenMemo``): the NODE
    (U,U,U) 256^3 runs differ only in engine and comm, on which the
    Green's function does not depend.  Raises on the first failed check;
    returns each run's launches (summed over its ranks)."""
    import os
    import tempfile
    import torch
    from repro_torch.ckpt import checkpoint as ck
    from repro_torch.core.bc import BCType, DataLayout
    from repro_torch.core.comm import cfg_label
    from repro_torch.core.green import GreenKind
    from repro_torch.core.solver import make_plan
    from repro_torch.distributed import pencil
    from repro_torch.launch import solve as launcher
    from repro_torch.plan import guided_comm_candidates
    from repro_torch.runtime import faults

    t0 = time.perf_counter()
    records = []
    launched = {}
    hook, launcher.report = launcher.report, records.append

    def merge_rank_calls(td, run, got):
        """Merge the calls the spawned ranks wrote to ``td`` into
        ``calls``; they must be the launches the ranks counted."""
        n = {}
        for name in sorted(os.listdir(td)):
            # written by this run's own ranks (_launch_rank)
            with open(os.path.join(td, name), "rb") as fh:
                for key, c in pickle.load(fh).items():
                    calls[key] = calls.get(key, 0) + c
                    n[key[1][0]] = n.get(key[1][0], 0) + c
        if n != got:
            raise AssertionError(f"{run}: the ranks recorded kernel calls "
                                 f"{n}, counted launches {got}")

    def times(pattern, k):
        return {name: v * k for name, v in pattern.items() if v}

    def launch(run, argv, expected=None):
        """``main(argv)`` on the card, one rank, in this process; its
        launches held to ``expected(record)``, by default the run's
        EXPECTED pattern once per solve."""
        def fn():
            launcher.main(argv)
            return records[-1]
        rec, counts = run_counted(
            run, fn, expected or (lambda r: times(EXPECTED[run],
                                                  r["solves"])))
        got = {k: v for k, v in counts.items() if v}
        if {k: v for k, v in rec["launches"].items() if v} != got \
                or not math.isfinite(rec["err"]):
            raise AssertionError(f"{run}: record {rec['launches']}, "
                                 f"counted {got}, E_inf {rec['err']}")
        launched[run] = got
        print(f"  {run}: {' '.join(argv)}: {rec['ms']:.3f} ms/solve, E_inf "
              f"{rec['err']:.3e}, plan-cache {rec['cache']['hits']} hits / "
              f"{rec['cache']['misses']} misses, {rec['backend']} on "
              f"{rec['devices'][0]}; launches {got} over {rec['solves']} "
              f"solves; card: {smi}")
        return rec

    try:
        # -- 1. one rank at full width -----------------------------------
        n = str(LAUNCH_N)
        rec = {}
        for run, argv in (
                ("LAUNCH_UNB", ["--bcs", "unb"]),
                ("LAUNCH_UNB_TORCH", ["--bcs", "unb", "--engine", "torch"]),
                ("LAUNCH_PER", ["--bcs", "per"]),
                ("LAUNCH_MIX", ["--bcs", "mix"]),
                ("LAUNCH_CELL_B2", ["--bcs", "unb", "--layout", "cell",
                                    "--batch", "2"])):
            rec[run] = launch(run, ["--n", n] + argv + LAUNCH_REPS)
        # comm="auto": the guided search times the CPU's shortlist, one
        # warm-up and three local solves each, before the solves
        U = (BCType.UNB, BCType.UNB)
        short = [cfg_label(c) for c in guided_comm_candidates(
            make_plan((LAUNCH_N,) * 3, 1.0, (U, U, U), DataLayout.NODE,
                      GreenKind.CHAT2), 1, 1, torch.float64,
            folds=("pack", "unpack"))]

        def auto_expected(r):
            if sorted(r["autotune"]) != sorted(short):
                raise AssertionError(f"LAUNCH_AUTO: timed "
                                     f"{sorted(r['autotune'])}, the CPU's "
                                     f"shortlist {short}")
            total = collections.Counter(
                times(node_uuu_launches(r["comm"]), r["solves"]))
            for lbl in short:
                total.update(times(node_uuu_launches(lbl), 4))
            return dict(total)
        rec["LAUNCH_AUTO"] = launch(
            "LAUNCH_AUTO", ["--n", n, "--bcs", "unb", "--comm", "auto"]
            + LAUNCH_REPS, auto_expected)
        print(f"  LAUNCH_AUTO: the guided search timed {short} and chose "
              f"{rec['LAUNCH_AUTO']['comm']}")
        small = launch("LAUNCH_UNB_SMALL", ["--n", str(LAUNCH_SMALL_N),
                                            "--bcs", "unb"] + LAUNCH_REPS)
        for run in ("LAUNCH_PER", "LAUNCH_MIX"):
            if rec[run]["err"] >= 1e-10:
                raise AssertionError(f"{run}: E_inf {rec[run]['err']}")
        e_c, e_t = rec["LAUNCH_UNB"]["err"], rec["LAUNCH_UNB_TORCH"]["err"]
        if abs(e_c - e_t) > 1e-12 or not e_c < small["err"]:
            raise AssertionError(f"LAUNCH_UNB: E_inf {e_c} on cuda, {e_t} "
                                 f"on torch, {small['err']} at n="
                                 f"{LAUNCH_SMALL_N}")
        print(f"  LAUNCH (U,U,U) E_inf: cuda {e_c:.6e}, torch {e_t:.6e} "
              f"(|diff| {abs(e_c - e_t):.1e}); n={LAUNCH_SMALL_N} "
              f"{small['err']:.6e}")

        # -- 2. four gloo ranks on the one card ----------------------------
        t1 = time.perf_counter()
        argv = ["--n", str(LAUNCH_SMALL_N), "--p1", "2", "--p2", "2",
                "--bcs", "unb", "--comm", "pipelined"] + LAUNCH_RANK_REPS
        with tempfile.TemporaryDirectory() as td:
            # the ranks inherit this environment when they are spawned
            os.environ.update({RANK_CALLS_RUN: "LAUNCH_RANKS4",
                               RANK_CALLS_DIR: td})
            rank_main = launcher._rank_main
            launcher._rank_main = _launch_rank
            try:
                launcher.main(argv)
            finally:
                launcher._rank_main = rank_main
                for k in (RANK_CALLS_RUN, RANK_CALLS_DIR):
                    os.environ.pop(k)
            r4 = records[-1]
            got = {k: v for k, v in r4["launches"].items() if v}
            merge_rank_calls(td, "LAUNCH_RANKS4", got)
        want = times(EXPECTED["LAUNCH_UNB"], 4 * r4["solves"])
        if (r4["backend"] != "gloo" or len(r4["devices"]) != 4
                or got != want or abs(r4["err"] - small["err"]) > 1e-10):
            raise AssertionError(f"LAUNCH_RANKS4: {r4['backend']} on "
                                 f"{r4['devices']}, launches {got} (want "
                                 f"{want}), E_inf {r4['err']} against "
                                 f"{small['err']}")
        launched["LAUNCH_RANKS4"] = got
        print(f"  LAUNCH_RANKS4: {' '.join(argv)}: {r4['backend']} ranks on "
              f"{sorted(set(r4['devices']))}, {r4['ms']:.3f} ms/solve "
              f"(host-staged by gloo), E_inf {r4['err']:.6e} (|diff| "
              f"{abs(r4['err'] - small['err']):.1e} from one rank), "
              f"launches over the ranks {got}, in "
              f"{time.perf_counter() - t1:.1f} s")

        # -- 3. the survivable loop: a device loss on four gloo ranks ------
        t1 = time.perf_counter()
        with tempfile.TemporaryDirectory() as td:
            out, chaos = os.path.join(td, "rec.json"), \
                os.path.join(td, "chaos.json")
            rank_calls = os.path.join(td, "calls")
            os.mkdir(rank_calls)
            argv = ["--n", str(LAUNCH_SMALL_N), "--p1", "2", "--p2", "2",
                    "--bcs", "per", "--steps", "6", "--ckpt",
                    os.path.join(td, "ck"), "--ckpt-every", "2",
                    "--verify", "nan"]
            env = dict(os.environ,
                       PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                                   str(ROOT)]),
                       REPRO_FAULTS=LAUNCH_FAULTS, REPRO_CHAOS_LOG=chaos,
                       **{RANK_CALLS_DIR: rank_calls,
                          RANK_CALLS_RUN: "LAUNCH_LOSS"})
            p = subprocess.run([sys.executable, "-c", _LOSS_SCRIPT, out]
                               + argv, capture_output=True, text=True,
                               cwd=ROOT, env=env, timeout=600)
            if (p.returncode != 0
                    or "device loss at step 3" not in p.stdout
                    or "(1x2) surviving mesh" not in p.stdout):
                raise AssertionError(f"LAUNCH_LOSS: exit {p.returncode}\n"
                                     f"{p.stdout[-3000:]}\n"
                                     f"{p.stderr[-3000:]}")
            with open(out) as fh:
                rl = json.load(fh)
            with open(chaos) as fh:
                report = json.load(fh)
            got = {k: v for k, v in rl["launches"].items() if v}
            merge_rank_calls(rank_calls, "LAUNCH_LOSS", got)
        # steps 0-2 on the four ranks, then (rolled back to the step-1
        # checkpoint) steps 2-5 on the two survivors
        want = times(EXPECTED["LAUNCH_PER"], 3 * 4 + 4 * 2)
        if (rl["err"] >= 1e-5 or set(report) != CHAOS_KEYS or got != want
                or report["final_mesh"] != [1, 2]
                or report["device_losses"] != 1):
            raise AssertionError(f"LAUNCH_LOSS: E_inf {rl['err']}, "
                                 f"launches {got} (want {want}), report "
                                 f"{report}")
        launched["LAUNCH_LOSS"] = got
        print(f"  LAUNCH_LOSS: {' '.join(argv[:-6])} --ckpt <tmp> "
              f"--ckpt-every 2 --verify nan, REPRO_FAULTS "
              f"{LAUNCH_FAULTS}: exit 0 in {time.perf_counter() - t1:.1f} "
              f"s, E_inf {rl['err']:.3e}, launches over the ranks {got}, "
              f"chaos report keys {sorted(report)}:")
        for line in p.stdout.splitlines():
            print(f"    {line}")

        # -- 4. a checkpoint of tensors on the card ------------------------
        g = torch.Generator(device=dev).manual_seed(4)
        tree = {"u": torch.randn((65,) * 3, generator=g, device=dev,
                                 dtype=torch.float64),
                "w": [torch.randn(1000, generator=g, device=dev), None]}
        with tempfile.TemporaryDirectory() as td:
            ck.save(td, 7, tree)
            like = {"u": torch.zeros_like(tree["u"]),
                    "w": [torch.zeros_like(tree["w"][0]), None]}
            back = ck.restore(td, ck.latest_step(td), like)
            pairs = [(back["u"], tree["u"]), (back["w"][0], tree["w"][0])]
            if not all(a.device == b.device and torch.equal(a, b)
                       for a, b in pairs):
                raise AssertionError("LAUNCH_CKPT: the card's tensors did "
                                     "not restore bit-equal")
            try:
                with faults.FaultPlan([dict(kind="flip",
                                            stage="ckpt.leaf.0")]):
                    ck.restore(td, 7, like)
                raise AssertionError("LAUNCH_CKPT: a flipped leaf restored")
            except ck.CheckpointError as e:
                if e.leaf != 0:
                    raise AssertionError(f"LAUNCH_CKPT: flip named leaf "
                                         f"{e.leaf}") from e
        print(f"  LAUNCH_CKPT: a tree of {len(pairs)} tensors on "
              f"{back['u'].device} restored bit-equal; a flip at "
              "ckpt.leaf.0 raised CheckpointError(leaf=0)")
    finally:
        launcher.report = hook
    print(f"launch phase: {time.perf_counter() - t0:.1f} s")
    return launched


# the mesh serve phase: the DFT keys' grid (DIST4_GLOO's), the NODE key's
# (the uneven 65-point split), the batch ranks each key is served at, the
# gate's grid, tenants, requests a tenant and alternated rounds a server
# kind (the reference's bench_serve.py traffic), and the soak's grid
SERVE_MESH_N = N // 2
SERVE_MESH_NODE_N = 64
SERVE_MESH_RANKS = {"UUU": (1, 2, 4, 8), "PPP": (1, 2, 4, 8),
                    "NODE": (1, 4)}
SERVE_MESH_GATE = {"n": 64, "tenants": 8, "requests": 12, "rounds": 2}
SERVE_MESH_SOAK_N = 16


def _serve_mesh_tag(bcs, n, engine) -> str:
    """The mesh phase's name of a served key: its BCs, its grid and, off
    the "cuda" engine, the engine."""
    from repro_torch.core.bc import BCType
    name = ("UUU" if bcs == ((BCType.UNB, BCType.UNB),) * 3
            else "PPP" if bcs == ((BCType.PER, BCType.PER),) * 3 else "NODE")
    return f"{name}{n}" + ("" if engine == "cuda" else f"_{engine}")


def _serve_mesh_rank(rank, world, d):
    """One of the four gloo ranks of phase 8d on the one card, mesh
    (2, 2): rank 0 runs every server of the phase, ranks 1-3 ``follow``
    each.  Every rank logs each distributed solve it enters (its key,
    batch rank and launches, the counts set to 0 just before and read
    just after) and records its kernel calls; rank 0 also times each
    batch's broadcast.  Writes what it found to ``<d>/rank<rank>.pkl``."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.distributed import pencil
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.serve import follow

    d = Path(d)
    with open(d / "params.json") as fh:
        prm = json.load(fh)
    dev = torch.device(prm["device"])
    cuda = dev.type == "cuda"
    if cuda:
        dev = torch.device("cuda", dev.index or 0)
        torch.cuda.set_device(dev)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    dist.init_process_group(
        "gloo", init_method=f"file://{d}/gloo", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    mesh = init_device_mesh(dev.type, (2, 2), mesh_dim_names=("data", "model"))
    out = {"log": [], "calls": {}}
    real_solve = pencil.DistributedPoissonSolver.solve

    def solve_logged(self, f, verify=None):
        c = self._ctor
        tag = _serve_mesh_tag(c["bcs"], c["shape"][0], c["engine_obj"].name)
        run = f"SERVE_MESH_{tag}/B{f.shape[0]}"
        with _recorded(run, out["calls"]):
            sync()
            reset_launches()
            u = real_solve(self, f, verify)
            sync()
            counts = {k: v for k, v in LAUNCHES.items() if v}
        out["log"].append((run, counts))
        return u
    pencil.DistributedPoissonSolver.solve = solve_logged
    if rank != 0:
        out["follow"] = [follow(mesh, device=dev)
                         for _ in range(prm["servers"])]
    else:
        out.update(_serve_mesh_leader(prm, d, dev, mesh))
    with open(d / f"rank{rank}.pkl", "wb") as fh:
        pickle.dump(out, fh)
    dist.barrier()
    dist.destroy_process_group()


def _serve_mesh_leader(prm, d, dev, mesh):
    """Rank 0 of phase 8d: every server of the phase, in the order the
    followers follow them; returns what the parent checks and prints."""
    import numpy as np
    import torch
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.core.bc import BCType, DataLayout
    from repro_torch.core.comm import CommConfig
    from repro_torch.runtime import faults
    from repro_torch.serve import PlanSpec, PoissonServer, percentile
    from repro_torch.serve import server as srv_mod

    U, P = (BCType.UNB, BCType.UNB), (BCType.PER, BCType.PER)
    E, O = BCType.EVEN, BCType.ODD
    ov2 = (("comm", CommConfig("overlap", 2)),)
    n, nn = prm["n"], prm["node_n"]
    specs = {
        "UUU": PlanSpec((n,) * 3, (U, U, U), mesh=mesh, device=dev,
                        solver_kw=ov2),
        "PPP": PlanSpec((n,) * 3, (P, P, P), mesh=mesh, device=dev,
                        solver_kw=ov2),
        "NODE": PlanSpec((nn,) * 3, ((E, E), (O, E), P),
                         layout=DataLayout.NODE, mesh=mesh, device=dev,
                         solver_kw=ov2 + (("dtype", torch.float64),))}
    out = {"keys": {}, "sends": [], "batches": []}
    # the header and batch broadcast, and the whole batch, timed on the
    # host around each call (the sentinel's broadcasts not counted)
    send, on_mesh = srv_mod._send_batch, PoissonServer._solve_on_mesh

    def send_timed(group, src, header, x):
        t0 = time.perf_counter()
        send(group, src, header, x)
        if x is not None:
            out["sends"].append((x.shape[0], time.perf_counter() - t0))

    def on_mesh_timed(self, key, spec, fb, plan, verify):
        t0 = time.perf_counter()
        res = on_mesh(self, key, spec, fb, plan, verify)
        out["batches"].append((
            fb.shape[0], _serve_mesh_tag(spec.bcs, spec.shape[0], spec.engine),
            time.perf_counter() - t0))
        return res
    srv_mod._send_batch = send_timed
    PoissonServer._solve_on_mesh = on_mesh_timed

    # -- 1. one batch a key at each rank, then every field alone --------
    t0 = time.perf_counter()
    fields = {k: np.load(d / f"f_{k}.npy") for k in specs}
    served = {}
    for key, spec in specs.items():
        for b in prm["ranks"][key]:
            srv = PoissonServer(max_batch=8, max_delay_ms=60_000).start()
            futs = [srv.submit(f, spec, tenant=f"w{i}")
                    for i, f in enumerate(fields[key][:b])]
            srv.stop(drain=True)
            served[key, b] = [fu.result() for fu in futs]
            if srv.server_stats()["batches"] != 1:
                raise AssertionError(f"SERVE_MESH_{key}/B{b}: "
                                     f"{srv.server_stats()['batches']} "
                                     "batches")
    with PoissonServer(max_batch=1, max_delay_ms=1.0) as srv:
        alone = {k: [srv.solve(f, spec, tenant="alone")
                     for f in fields[k][:max(prm["ranks"][k])]]
                 for k, spec in specs.items()}
    for key in specs:
        want = np.load(d / f"u_{key}.npy")
        tol = 1e-10 if key == "NODE" else 1e-5
        rel, bits = 0.0, True
        for b in prm["ranks"][key]:
            for i, r in enumerate(served[key, b]):
                if (r.batch_size, r.padded_to) != (b, b) or r.degradations:
                    raise AssertionError(f"SERVE_MESH_{key}/B{b}: row {i} "
                                         f"({r.batch_size}, {r.padded_to}) "
                                         f"{r.degradations}")
                bits &= bool(np.array_equal(r.u, alone[key][i].u))
                rel = max(rel, float(np.abs(r.u - want[i]).max()
                                     / np.abs(want[i]).max()))
        if not bits or rel > tol:
            raise AssertionError(f"SERVE_MESH_{key}: bit-exact against the "
                                 f"rows served alone {bits}, relative "
                                 f"{rel:.3e} from the single-process torch "
                                 f"solve (tolerance {tol:.0e})")
        out["keys"][key] = {"rel": rel, "ranks": prm["ranks"][key]}
    out["keys_s"] = time.perf_counter() - t0

    # -- 2. the reference gate's traffic, coalesced and sequential -------
    g = prm["gate"]
    gate = [PlanSpec((g["n"],) * 3, bcs, mesh=mesh, device=dev,
                     solver_kw=ov2) for bcs in ((U, U, U), (P, P, P))]
    rng = np.random.default_rng(12)
    gfs = [rng.standard_normal((g["n"],) * 3, dtype=np.float32)
           for _ in range(8)]
    t0 = time.perf_counter()
    with PoissonServer(max_batch=8, max_delay_ms=4) as srv:
        for spec in gate:                      # warm: every key and rank
            for b in srv.batch_ranks:
                for fu in [srv.submit(f, spec, tenant="_warm")
                           for f in gfs[:b]]:
                    fu.result(timeout=600)
    walls = {"coalesced": [], "sequential": []}
    lat = {how: collections.defaultdict(list) for how in walls}

    def burst(how):
        with PoissonServer(max_batch=8 if how == "coalesced" else 1,
                           max_delay_ms=4) as srv:
            def client(t):
                futs = [srv.submit(gfs[(t + i) % 8], gate[t % 2],
                                   tenant=f"t{t}")
                        for i in range(g["requests"])]
                return [fu.result(timeout=600) for fu in futs]
            with ThreadPoolExecutor(g["tenants"]) as ex:
                t1 = time.perf_counter()
                res = list(ex.map(client, range(g["tenants"])))
                walls[how].append(time.perf_counter() - t1)
        for t, rs in enumerate(res):
            lat[how][f"t{t}"] += [r.total_s for r in rs]
    for r in range(g["rounds"]):
        for how in (("coalesced", "sequential") if r % 2 == 0
                    else ("sequential", "coalesced")):
            burst(how)
    out["gate"] = {
        "walls": walls, "gate_s": time.perf_counter() - t0,
        "pct": {how: {t: [percentile(v, q) * 1e3 for q in (50, 95, 99)]
                      for t, v in sorted(ts.items())}
                for how, ts in lat.items()}}

    # -- 3. the reference's serve soak on the mesh -----------------------
    t0 = time.perf_counter()
    ns = prm["soak_n"]
    soak = PlanSpec((ns,) * 3, (P, P, P), engine="torch", mesh=mesh,
                    device=dev, solver_kw=(("comm", CommConfig("a2a")),))
    sf = np.load(d / "f_SOAK.npy")
    with PoissonServer(max_batch=4, max_delay_ms=1.0, verify="abft") as srv:
        base = [srv.solve(f, soak, tenant="warm") for f in sf]
        if any(r.integrity or r.degradations for r in base):
            raise AssertionError(f"SERVE_MESH soak baseline: "
                                 f"{[r.integrity for r in base]}")
        plan = faults.FaultPlan([dict(kind="flip", stage="fwd.0", count=2)])
        bad = srv.submit(sf[0], soak, tenant="chaos",
                         fault_plan=plan).result(timeout=600)
        stages = [r["stage"] for r in bad.integrity]
        if (len(plan.log) != 2 or not stages
                or stages[0] != "solve.linearity"
                or not any(s.split("#")[0] == "fwd.0" for s in stages)
                or not np.array_equal(bad.u, base[0].u)):
            raise AssertionError(f"SERVE_MESH soak chaos: {plan.log} "
                                 f"{bad.integrity}")
        for t in range(6):
            for i, f in enumerate(sf):
                r = srv.solve(f, soak, tenant=f"t{t}")
                if (r.integrity or r.degradations
                        or not np.array_equal(r.u, base[i].u)):
                    raise AssertionError(f"SERVE_MESH soak t{t} field {i}: "
                                         f"{r.integrity} {r.degradations}")
    want = np.load(d / "u_SOAK.npy")
    out["soak"] = {"stages": [(r["stage"], r["action"])
                              for r in bad.integrity],
                   "rel": max(float(np.abs(r.u - w).max() / np.abs(w).max())
                              for r, w in zip(base, want)),
                   "soak_s": time.perf_counter() - t0}
    srv_mod._send_batch, PoissonServer._solve_on_mesh = send, on_mesh
    return out


def _serve_mesh_phase(dev, smi, calls):
    """Phase 8d: serving on a mesh of four gloo ranks on the one card, as
    the module docstring lists it.  The parent draws the fields and
    solves each on one process ("torch" engine: cuFFT) for the ranks to
    hold their rows to, spawns the ranks, checks that every rank entered
    the same solves with each key's launch pattern, merges the ranks'
    kernel calls into ``calls`` for phase 9 and prints the numbers.
    Raises on the first failed check; returns each run's launches summed
    over the ranks and solves."""
    import tempfile
    import numpy as np
    import torch
    import torch.multiprocessing as mp
    from repro_torch.core.bc import BCType, DataLayout
    from repro_torch.core.solver import PoissonSolver

    t0 = time.perf_counter()
    U, P = (BCType.UNB, BCType.UNB), (BCType.PER, BCType.PER)
    E, O = BCType.EVEN, BCType.ODD
    n, nn, ns = SERVE_MESH_N, SERVE_MESH_NODE_N, SERVE_MESH_SOAK_N
    rng = np.random.default_rng(22)
    cases = {"UUU": ((n,) * 3, (U, U, U), DataLayout.CELL, np.float32, 8),
             "PPP": ((n,) * 3, (P, P, P), DataLayout.CELL, np.float32, 8),
             "NODE": ((nn,) * 3, ((E, E), (O, E), P), DataLayout.NODE,
                      np.float64, 4),
             "SOAK": ((ns,) * 3, (P, P, P), DataLayout.CELL, np.float32, 4)}
    tmp = tempfile.TemporaryDirectory()
    d = Path(tmp.name)
    for key, (shape, bcs, layout, dt, k) in cases.items():
        sp = PoissonSolver(shape, 1.0, bcs, layout=layout, engine="torch",
                           device=dev)
        fs = rng.standard_normal((k,) + tuple(sp.input_shape)).astype(dt)
        np.save(d / f"f_{key}.npy", fs)
        x = torch.from_numpy(fs).to(dev)
        if dt == np.float32:
            x = x.float()
        np.save(d / f"u_{key}.npy", sp.solve(x).cpu().numpy())
        del sp, x
    rounds = SERVE_MESH_GATE["rounds"]
    servers = sum(len(r) for r in SERVE_MESH_RANKS.values()) + 1 + 1 \
        + 2 * rounds + 1
    with open(d / "params.json", "w") as fh:
        json.dump({"device": str(dev), "n": n, "node_n": nn, "soak_n": ns,
                   "ranks": SERVE_MESH_RANKS, "gate": SERVE_MESH_GATE,
                   "servers": servers}, fh)
    t_ref = time.perf_counter() - t0
    t1 = time.perf_counter()
    mp.start_processes(_serve_mesh_rank, args=(4, str(d)), nprocs=4,
                       start_method=DIST_START)
    ranks = []
    for r in range(4):
        # written by this phase's own ranks just above
        with open(d / f"rank{r}.pkl", "rb") as fh:
            ranks.append(pickle.load(fh))
    tmp.cleanup()
    t_ranks = time.perf_counter() - t1
    lead = ranks[0]

    # every rank entered the same solves, each at its key's launches
    runs = [r for r, _ in lead["log"]]
    if any([r for r, _ in res["log"]] != runs for res in ranks):
        raise AssertionError("SERVE_MESH: the ranks entered different "
                             "solves: " + "; ".join(
                                 f"rank {i} {len(res['log'])}"
                                 for i, res in enumerate(ranks)))
    for i, res in enumerate(ranks[1:], 1):
        if len(res["follow"]) != servers or any(
                f["failed"] for f in res["follow"]):
            raise AssertionError(f"SERVE_MESH: rank {i} followed "
                                 f"{res['follow']}")
    node = {k: v // 4 for k, v in
            EXPECTED["DIST4_GLOO_NODE/overlap:2"].items()}
    pattern = {f"UUU{n}": uuu_launches("overlap:2"),
               f"UUU{SERVE_MESH_GATE['n']}": uuu_launches("overlap:2"),
               f"NODE{nn}": node, f"PPP{ns}_torch": {}}
    first = {}
    totals = collections.defaultdict(collections.Counter)
    for res in ranks:
        for run, counts in res["log"]:
            tag = run.split("_", 2)[2].split("/")[0]
            want = pattern.get(tag) or first.setdefault(tag, counts)
            if counts != want:
                raise AssertionError(f"{run}: launches {counts}, the key's "
                                     f"B=1 count {want}")
            totals[run].update(counts)
        for key, c in res["calls"].items():
            calls[key] = calls.get(key, 0) + c
    if not first.get(f"PPP{n}", {}).get("fft_stockham_scale"):
        raise AssertionError(f"SERVE_MESH PPP: launches {first}")
    launched = {run: dict(c) for run, c in totals.items() if c}
    solves = collections.Counter(runs)

    # the broadcast's share of each batch (one broadcast a batch)
    if len(lead["sends"]) != len(lead["batches"]):
        raise AssertionError(f"SERVE_MESH: {len(lead['sends'])} broadcasts "
                             f"for {len(lead['batches'])} batches")
    shares = [s / b for (_, _, b), (_, s) in zip(lead["batches"],
                                                 lead["sends"])]
    for key, res in lead["keys"].items():
        tag = f"{key}{nn if key == 'NODE' else n}"
        print(f"SERVE_MESH_{key} n={nn if key == 'NODE' else n} "
              f"{'float64' if key == 'NODE' else 'float32'} cuda overlap:2 on "
              f"4 gloo ranks, mesh (2, 2): one batch at each rank "
              f"{list(res['ranks'])}, every row bit-exact against the same "
              f"row served alone, relative max |diff| {res['rel']:.3e} from "
              f"the single-process torch solve; launches per rank and solve "
              f"{pattern.get(tag) or first[tag]} at every rank; card: {smi}")
    for (rank, tag, b_s), s in zip(lead["batches"], shares):
        if tag in (f"UUU{n}", f"PPP{n}") and rank == 8:
            print(f"  SERVE_MESH rank-8 {tag} batch: {b_s * 1e3:.1f} ms, of "
                  f"which the header and batch broadcast {s * b_s * 1e3:.1f} "
                  f"ms ({s:.1%}); card: {smi}")
    gt = lead["gate"]
    g = SERVE_MESH_GATE
    per_burst = g["tenants"] * g["requests"]
    med = {how: statistics.median(w) for how, w in gt["walls"].items()}
    ratios = [s_ / c_ for c_, s_ in zip(gt["walls"]["coalesced"],
                                        gt["walls"]["sequential"])]
    g_sh = [s for (rank, tag, _), s in zip(lead["batches"], shares)
            if tag[3:] == str(g["n"]) and rank == 8]
    print(f"SERVE_MESH_GATE n={g['n']} float32 cuda overlap:2, (U,U,U) + "
          f"(P,P,P), {g['tenants']} tenants x {g['requests']} requests a "
          f"burst, {g['rounds']} bursts a server kind in alternated rounds: "
          f"coalesced {per_burst / med['coalesced']:.2f} req/s (median wall "
          f"{med['coalesced']:.4f} s), sequential "
          f"{per_burst / med['sequential']:.2f} req/s (median wall "
          f"{med['sequential']:.4f} s), coalescing "
          f"{med['sequential'] / med['coalesced']:.3f}x (the rounds' ratios "
          + " ".join(f"{x:.3f}" for x in ratios)
          + f"); rank-8 batches {len(g_sh)}, the broadcast's share median "
          f"{statistics.median(g_sh) if g_sh else float('nan'):.1%}; "
          f"card: {smi}")
    for how, ts in gt["pct"].items():
        print(f"  {how} p50/p95/p99 ms per tenant: " + "; ".join(
            f"{t} {a:.1f}/{b:.1f}/{c:.1f}" for t, (a, b, c) in ts.items()))
    so = lead["soak"]
    if so["rel"] > 1e-5:
        raise AssertionError(f"SERVE_MESH soak: {so['rel']:.3e} from the "
                             "single-process torch solve")
    print(f"SERVE_MESH soak (P,P,P) n={ns} float32, a2a, verify='abft', "
          f"engine torch, mesh (2, 2): the flip-armed tenant localized "
          f"{so['stages']} and repaired to the baseline bits; 6 tenants x 4 "
          f"fields bit-exact, no record; baseline within {so['rel']:.3e} of "
          f"the single-process torch solve; {so['soak_s']:.1f} s; card: "
          f"{smi}")
    print(f"  SERVE_MESH: {len(runs)} distributed solves entered by every "
          f"rank ({', '.join(f'{r} x{c}' for r, c in sorted(solves.items()))}"
          f"); every follower left each of the {servers} servers' stop; "
          f"references {t_ref:.1f} s, ranks {t_ranks:.1f} s (keys "
          f"{lead['keys_s']:.1f} s, gate {gt['gate_s']:.1f} s); card: "
          f"{smi}")
    print(f"serve mesh phase: {time.perf_counter() - t0:.1f} s; card: {smi}")
    return launched


# the LM training phase (8e): qwen3-0.6b at its full config through the
# train launcher, the other families at full width and a cut depth, and
# the card against the host CPU on the ten smoke configs
LM_ARCH = "qwen3-0.6b"
LM_BATCH, LM_SEQ, LM_STEPS, LM_FAIL = 4, 2048, 8, 4
# (arch, config overrides, batch, seq, the cut as printed)
LM_FAMILIES = (
    ("moonshot-v1-16b-a3b", {"n_layers": 2}, 2, 2048, "48 -> 2 layers"),
    ("mamba2-2.7b", {"n_layers": 2}, 2, 2048, "64 -> 2 layers"),
    ("recurrentgemma-9b", {"n_layers": 3}, 1, 2048,
     "38 -> 3 layers, one (rec, rec, attn) group"),
    ("whisper-medium", {}, 2, 448, "none: 24 + 24 layers, 1500 frames"),
    ("paligemma-3b", {"n_layers": 4}, 2, 1024,
     "18 -> 4 layers, 256 image tokens"),
    ("starcoder2-7b", {"n_layers": 2, "attn_block": 1024}, 1, 8192,
     "32 -> 2 layers; 8192 tokens so that the 4096 window masks, in "
     "1024-query blocks"),
)
LM_FAMILY_STEPS = 4
LM_CARD_TOL = 1e-4
# dense bf16 tensor-core rate of the H100 SXM, NVIDIA's data sheet
LM_PEAK_BF16 = 989e12


def _lm_flops(model, cfg, batch, seq):
    """Model FLOPs of one train step: 6 N T + 12 L B S^2 H dh, N the
    parameters that enter a matmul (every tensor of rank >= 2; a tied
    embedding once, as the output projection), T = B S tokens, and the
    full S x S attention square the port computes (forward 4 L B S^2 H
    dh, backward twice that); remat's recomputation not counted."""
    n = sum(p.numel() for p in model.parameters() if p.ndim >= 2)
    if not cfg.tie_embeddings:
        n -= model.embed.numel()       # the embedding is a gather
    attn = 12 * cfg.n_layers * batch * seq ** 2 * cfg.n_heads * cfg.d_head
    return 6 * n * batch * seq + attn, n


def _device_breakdown(prof):
    """{device event name: [ms, count]} of a torch.profiler run."""
    from torch.autograd import DeviceType
    agg = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            a = agg.setdefault(e.name, [0.0, 0])
            a[0] += e.time_range.elapsed_us() / 1e3
            a[1] += 1
    return agg


def _lm_groups(agg):
    """Device ms by kind of kernel (by its name)."""
    kinds = (("matmul", ("gemm", "xmma", "cutlass", "sm90", "cublas",
                         "ampere", "nvjet")),
             ("softmax", ("softmax",)),
             ("reduction", ("reduce", "norm", "sum")),
             ("copy/index", ("copy", "cat", "index", "gather", "scatter",
                             "memcpy", "memset")),
             ("elementwise", ("elementwise", "vectorized", "unrolled")))
    out = collections.Counter()
    for name, (ms, _) in agg.items():
        low = name.lower()
        kind = next((k for k, keys in kinds if any(w in low for w in keys)),
                    "other")
        out[kind] += ms
    return out


def _lm_phase(dev, smi):
    """Phase 8e: LM training on the card.  Raises on the first failed
    check; prints the numbers."""
    import dataclasses
    import tempfile

    import torch
    from repro_torch.configs import LM_ARCHS, get_config, get_smoke
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.launch import train
    from repro_torch.models import convert
    from repro_torch.models import transformer as tf
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train_step as ts

    t0 = time.perf_counter()
    gib = lambda b: b / 2 ** 30
    gc.collect()
    torch.cuda.empty_cache()
    resident = gib(torch.cuda.memory_allocated())
    print(f"LM phase: {resident:.3f} GiB "
          f"resident from the earlier phases; deterministic algorithms "
          f"{'on' if torch.are_deterministic_algorithms_enabled() else 'off'}")

    def check_losses(label, losses, vocab, high=None):
        """Finite; step 0 within 2 nats of ln(vocab), or with ``high``
        between ln(vocab) - 2 and ``high`` + 2."""
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{label}: a loss is not finite: {losses}")
        lo, hi = math.log(vocab) - 2.0, (high or math.log(vocab)) + 2.0
        if not lo <= losses[0] <= hi:
            raise AssertionError(f"{label}: step 0 loss {losses[0]:.4f} is "
                                 f"not within [{lo:.4f}, {hi:.4f}]")

    def embedding_only_loss(model, cfg, batch):
        """The loss of the same parameters with every block skipped: the
        final norm of the embedded inputs against the tied embedding.  A
        gemma-style model (tied, sqrt(d)-scaled embedding) starts near
        it, not near ln(vocab): the scaled embedding dominates the
        residual stream, and each position's logit of its own input
        token is about sqrt(d) |e| ~ 0.018 d."""
        with torch.no_grad():
            x, _ = tf._embed_in(model.embed, cfg, batch["inputs"],
                                batch.get("frontend"))
            logits = tf._logits(model, cfg, x, getattr(
                model, tf._head(cfg)))[:, -batch["labels"].shape[1]:]
            gold = logits.gather(-1, batch["labels"][..., None].long())
            return float((logits.logsumexp(-1) - gold[..., 0]).mean())

    # -- 1. qwen3-0.6b at its full config, through the launcher ----------
    cfg = get_config(LM_ARCH)
    argv = ["--arch", LM_ARCH, "--steps", str(LM_STEPS), "--batch",
            str(LM_BATCH), "--seq", str(LM_SEQ), "--log-every", "1",
            "--device", str(dev)]
    torch.cuda.reset_peak_memory_stats()
    state = train.main(argv)                           # uninterrupted
    peak_gib = gib(torch.cuda.max_memory_allocated())
    straight = state.record
    flops, n_mm = _lm_flops(state.params, cfg, LM_BATCH, LM_SEQ)
    del state
    with tempfile.TemporaryDirectory() as d:
        ckpt = ["--ckpt-dir", d, "--ckpt-every", str(LM_FAIL)]
        try:
            train.main(argv + ckpt + ["--fail-at", str(LM_FAIL)])
            raise AssertionError("--fail-at did not stop the run")
        except SystemExit as e:
            failed, first = str(e), e.record
        ck_bytes = sum(p.stat().st_size for p in Path(d).rglob("*")
                       if p.is_file())
        # the relaunch saves no second checkpoint
        state = train.main(argv + ["--ckpt-dir", d, "--ckpt-every",
                                   str(10 * LM_STEPS)])
    resumed = state.record
    if first["steps"] != list(range(LM_FAIL)) or \
            resumed["steps"] != list(range(LM_FAIL, LM_STEPS)) or \
            resumed["start"] != LM_FAIL:
        raise AssertionError(f"LM resume: steps {first['steps']} then "
                             f"{resumed['steps']}")
    check_losses("LM_TRAIN", straight["loss"], cfg.vocab)
    check_losses("LM_TRAIN first run", first["loss"], cfg.vocab)
    if not all(math.isfinite(x) for x in resumed["loss"]):
        raise AssertionError(f"LM resume: {resumed['loss']}")
    last, want = resumed["loss"][-1], straight["loss"][-1]
    resume_err = abs(last - want) / abs(want)
    first_err = max(abs(a - b) / abs(b) for a, b in
                    zip(first["loss"], straight["loss"]))
    # tolerance: 1e-3 relative.  Deterministic algorithms are off; cuBLAS
    # and the kernels this step runs are deterministic for one shape on
    # one card, but an atomically accumulated backward (an index_add or
    # an embedding's scatter) may sum in another order
    if resume_err > 1e-3 or first_err > 1e-3:
        raise AssertionError(f"LM resume: last loss {last} against "
                             f"{want} uninterrupted ({resume_err:.2e}); "
                             f"the first run's against the straight one "
                             f"{first_err:.2e}")
    warm = straight["seconds"][2:]
    ms = statistics.median(warm) * 1e3
    tokens = LM_BATCH * LM_SEQ
    print(f"LM_TRAIN {LM_ARCH}: full config ({cfg.n_layers} layers, d_model {cfg.d_model}, vocab "
          f"{cfg.vocab}, {cfg.n_params()} parameters, {cfg.compute_dtype} "
          f"compute, {cfg.param_dtype} master), batch {LM_BATCH} x seq "
          f"{LM_SEQ}, {LM_STEPS} steps: losses "
          f"{[round(x, 4) for x in straight['loss']]}; step 0 "
          f"{straight['loss'][0]:.4f} against ln(V) "
          f"{math.log(cfg.vocab):.4f}; median {ms:.1f} ms/step over steps "
          f"2-{LM_STEPS - 1} (host clock, each step ending in the loss's "
          f"read), {tokens / ms * 1e3:.0f} tokens/s, peak "
          f"max_memory_allocated {peak_gib:.3f} GiB ({resident:.3f} of it "
          f"resident from the earlier phases); model "
          f"{flops / 1e12:.2f} TFLOP/step = 6 N T + 12 L B S^2 H dh (N = "
          f"{n_mm} matmul parameters, T = {tokens}), "
          f"{flops / ms / 1e9:.1f} TFLOP/s, "
          f"{flops / ms / 1e9 / (LM_PEAK_BF16 / 1e12):.1%} of the H100 SXM "
          f"data sheet's {LM_PEAK_BF16 / 1e12:.0f} TFLOP/s dense bf16; "
          f"card: {smi}")
    print(f"LM_TRAIN resume: '{failed}'; one checkpoint of "
          f"{ck_bytes / 1e9:.3f} GB saved in "
          f"{sum(first['save_seconds']):.2f} s, restored in "
          f"{resumed['restore_seconds']:.2f} s (each with its conversion "
          f"from or to the card's modules); the relaunch ran "
          f"steps {resumed['steps'][0]}-{resumed['steps'][-1]}, last loss "
          f"{last:.6f} against {want:.6f} uninterrupted (relative "
          f"{resume_err:.2e}, tolerance 1e-3; the first run's losses "
          f"against the uninterrupted ones {first_err:.2e}); deterministic "
          f"algorithms off")

    # one profiled step of the resumed state
    step_fn = ts.train_step_fn(cfg, adam=opt.AdamWConfig(
        lr=3e-4, total_steps=LM_STEPS, warmup=min(20, LM_STEPS // 10 + 1)))
    batch = synthetic_batch(cfg, LM_STEPS, LM_BATCH, LM_SEQ, device=dev)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, m = step_fn(state, batch)
        float(m["loss"])
    agg = _device_breakdown(prof)
    busy = sum(v[0] for v in agg.values())
    if busy <= 0:
        print("LM_TRAIN profile: device time not measured (the "
              "profiler saw no device activity)")
    else:
        rows = sorted(((v[0], v[1], k) for k, v in agg.items()),
                      reverse=True)
        groups = "; ".join(f"{k} {v:.1f} ms" for k, v in
                           _lm_groups(agg).most_common())
        top = "; ".join(f"{t:.1f} ms x{c} {k[:70]}"
                        for t, c, k in rows[:8])
        print(f"LM_TRAIN profile of one step: device busy {busy:.1f} "
              f"ms of the median {ms:.1f} ms step (idle share "
              f"{max(0.0, 1 - busy / ms):.1%}); by kind: {groups}; "
              f"top: {top}")
    del state, step_fn, batch
    torch.cuda.empty_cache()

    # -- 2. the other families at full width, a cut depth ----------------
    for arch, over, b, s, cut in LM_FAMILIES:
        fcfg = dataclasses.replace(get_config(arch), **over)
        adam = opt.AdamWConfig(lr=1e-3, warmup=0, total_steps=LM_FAMILY_STEPS)
        torch.cuda.reset_peak_memory_stats()
        state = ts.make_train_state(torch.Generator(dev).manual_seed(0),
                                    fcfg, adam=adam)
        step_fn = ts.train_step_fn(fcfg, adam=adam)
        batch = synthetic_batch(fcfg, 0, b, s, device=dev)
        gemma = fcfg.scale_embed and fcfg.tie_embeddings
        skip = embedding_only_loss(state.params, fcfg, batch) if gemma \
            else None
        losses, secs, drops = [], [], []
        for _ in range(LM_FAMILY_STEPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, m = step_fn(state, batch)
            losses.append(float(m["loss"]))
            secs.append(time.perf_counter() - t)
            drops.append(float(m["moe_drop"]))
        check_losses(f"LM_FAMILY {arch}", losses, fcfg.vocab, skip)
        if not losses[-1] < losses[0]:
            raise AssertionError(f"LM_FAMILY {arch}: the loss did not fall "
                                 f"on its fixed batch: {losses}")
        extra = (f", moe_drop {[round(x, 4) for x in drops]}"
                 if fcfg.family == "moe" else "")
        print(f"LM_FAMILY {arch} ({fcfg.family}; cut: {cut}; d_model "
              f"{fcfg.d_model}, {fcfg.n_params()} parameters), batch {b} x "
              f"seq {s}, {LM_FAMILY_STEPS} steps on one batch: losses "
              f"{[round(x, 4) for x in losses]} (ln V "
              f"{math.log(fcfg.vocab):.4f}"
              + (f"; the embedding-only model's {skip:.4f}" if gemma else "")
              + f"){extra}; median "
              f"{statistics.median(secs[1:]) * 1e3:.1f} ms/step over steps "
              f"1-{LM_FAMILY_STEPS - 1}, peak "
              f"{gib(torch.cuda.max_memory_allocated()):.3f} GiB ("
              f"{resident:.3f} of it resident from the earlier phases)")
        del state, step_fn, batch
        torch.cuda.empty_cache()

    # -- 3. the card against the host CPU, the ten smoke configs, f32 ----
    host = torch.device("cpu")
    worst = {}
    for arch in LM_ARCHS:
        scfg = dataclasses.replace(get_smoke(arch), compute_dtype="float32")
        tree = convert.to_reference(
            tf.init_params(torch.Generator().manual_seed(0), scfg))
        cpu_state = ts.TrainState(convert.from_reference(tree, scfg, host),
                                  None, None)
        card_state = ts.TrainState(convert.from_reference(tree, scfg, dev),
                                   None, None)
        for st_ in (cpu_state, card_state):
            st_.opt_state = opt.init_opt_state(
                dict(st_.params.named_parameters()))
        batch = synthetic_batch(scfg, 0, 2, 32)
        card_batch = {k: v.to(dev) for k, v in batch.items()}
        with torch.no_grad():
            want, waux = cpu_state.params(batch["inputs"],
                                          batch.get("frontend"))
            got, gaux = card_state.params(card_batch["inputs"],
                                          card_batch.get("frontend"))
        rel = lambda g, w: float((g.detach().cpu().double() - w.double())
                                 .abs().max() / w.double().abs().max())
        errs = {"logits": rel(got, want),
                "moe_drop": abs(float(gaux["moe_drop"]) -
                                float(waux["moe_drop"]))}
        step = ts.train_step_fn(scfg, adam=opt.AdamWConfig(
            lr=1e-3, warmup=0, total_steps=10))
        cpu_state, cm = step(cpu_state, batch)
        card_state, gm = step(card_state, card_batch)
        errs["loss"] = rel(gm["loss"], cm["loss"])
        errs["grad_norm"] = rel(gm["grad_norm"], cm["grad_norm"])
        wp = dict(cpu_state.params.named_parameters())
        norm_err = max(
            float((p.detach().cpu().double() - wp[n].detach().double())
                  .norm() / wp[n].detach().double().norm().clamp_min(1e-30))
            for n, p in card_state.params.named_parameters())
        errs["params"] = norm_err
        bad = {k: v for k, v in errs.items() if v > LM_CARD_TOL}
        if bad:
            raise AssertionError(f"LM_CARD_VS_CPU {arch}: beyond "
                                 f"{LM_CARD_TOL:.0e}: {bad}")
        for k, v in errs.items():
            worst[k] = max(worst.get(k, 0.0), v)
        print(f"LM_CARD_VS_CPU {arch} (smoke, float32): "
              + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    print(f"LM_CARD_VS_CPU: ten smoke configs within {LM_CARD_TOL:.0e} "
          f"(logits, loss, grad_norm: max relative; params: norm-wise "
          f"relative after one step; moe_drop: absolute); worst "
          + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()))
    print(f"LM phase: {time.perf_counter() - t0:.1f} s; card: {smi}")
    return ms


# the LM serving phase (8f): qwen3-0.6b at its full config through prefill
# and greedy decode_step, the other nine configs at full width and a cut
# depth, the ten smoke configs on the card against the host CPU, and ring
# attention and the expert-parallel MoE on four gloo ranks
LM_SERVE_BATCH, LM_SERVE_PROMPT, LM_SERVE_STEPS = 8, 2048, 32
LM_SERVE_TOL = 2e-2
# (arch, config overrides, batch, prompt tokens, the cut as printed);
# mamba2's prompt and forward stay within one 256-token chunk,
# starcoder2's prompt passes its 4096 window.  The MoE configs run with a
# capacity factor of E / k, so that no token is dropped (a decode step's
# few tokens and a forward's many would get different capacities), in
# their bfloat16 and again in float32.  In bfloat16 the prefill's, the
# decode's and the forward's sequence lengths round the residual stream
# differently, by a few ulps, which can flip a router's near-tie and so
# change a token's experts: there, as tests/test_torch_models.py holds
# the MoE configs against the reference, at most LM_SERVE_MOE_STRAY of
# the positions may pass LM_SERVE_TOL, the median position stays within
# 1e-2, and every position past the tolerance follows a top-k flip
# against forward, at it or earlier in its row (each printed with
# forward's router logit margin between its k-th and (k+1)-th expert
# there, beside how far the two runs' router logits lie apart).  In
# float32 every position is held.
LM_SERVE_FAMILIES = (
    ("glm4-9b", {"n_layers": 2}, 2, 64, "40 -> 2 layers"),
    ("minitron-8b", {"n_layers": 2}, 2, 64, "32 -> 2 layers"),
    ("qwen3-moe-235b-a22b", {"n_layers": 1}, 2, 64, "94 -> 1 layer"),
    ("moonshot-v1-16b-a3b", {"n_layers": 2}, 2, 64, "48 -> 2 layers"),
    ("mamba2-2.7b", {"n_layers": 2}, 2, 248, "64 -> 2 layers"),
    ("recurrentgemma-9b", {"n_layers": 3}, 1, 64,
     "38 -> 3 layers, one (rec, rec, attn) group"),
    ("whisper-medium", {}, 2, 64, "none: 24 + 24 layers, 1500 frames"),
    ("paligemma-3b", {"n_layers": 4}, 2, 64,
     "18 -> 4 layers, 256 image tokens"),
    ("starcoder2-7b", {"n_layers": 2, "attn_block": 1024}, 1, 4200,
     "32 -> 2 layers; a 4200-token prompt over the 4096 window, so the "
     "rolling buffer runs"),
)
LM_SERVE_FAMILY_STEPS = 8
LM_SERVE_MOE_STRAY = 0.1
# the mesh part: ring attention at qwen3-0.6b's width (batch, sequence)
# and one moonshot-v1-16b-a3b MoE layer at full width (batch, sequence),
# float32, on four gloo ranks, mesh (1, 4)
LM_MESH_RING = (1, 4096)
LM_MESH_MOE = (2, 2048)
# the sharded serving legs on the same four ranks: (arch, config
# overrides, global batch, prompt tokens, decode steps, the cut as
# printed, the meshes); float32 compute, the MoE at a capacity factor of
# E / k (a rank routes its data shard's tokens, one process all of
# them).  Each leg's seed makes its weights on every rank and on the
# one process that serves the model whole.  The parameters are cut by
# the training layout rule (train_step.shard_params_ by "train": FSDP
# over "data", the attention heads, the MLP's d_ff, the vocabulary, the
# own experts, the SSM's d_model and the RG-LRU's d_rnn over "model"), so
# (1, 4) is tensor parallelism alone, (4, 1) FSDP alone and (2, 2) both
LM_SHARD_LEGS = (
    ("qwen3-0.6b", {"n_layers": 4}, 4, 512, 4, "28 -> 4 layers",
     ((2, 2), (4, 1), (1, 4))),
    ("moonshot-v1-16b-a3b", {"n_layers": 1}, 4, 256, 2, "48 -> 1 layer",
     ((2, 2),)),
    ("mamba2-2.7b", {"n_layers": 2}, 4, 256, 2, "64 -> 2 layers",
     ((1, 4), (2, 2))),
    ("recurrentgemma-9b", {"n_layers": 3}, 2, 256, 2,
     "38 -> 3 layers, one (rec, rec, attn) group", ((1, 4),)),
)
LM_SHARD_SEEDS = (84, 85, 86, 87)
# the parameters a rank holds, GiB (float32), predicted from the
# reference's layout (param_specs' local shapes) before the first run,
# held to LM_SHARD_GIB_TOL; and the share of the one process's caches a
# rank holds (its rows of the batch, its kv heads), exactly
LM_SHARD_PREDICTED_GIB = {(0, (2, 2)): 0.2035, (0, (4, 1)): 0.204,
                          (0, (1, 4)): 0.2035, (1, (2, 2)): 1.157,
                          (2, (1, 4)): 0.1950, (2, (2, 2)): 0.2194,
                          (3, (1, 4)): 1.5939}
# (the SSM's and the RG-LRU's caches, and recurrentgemma's single kv
# head's, are whole over "model")
LM_SHARD_CACHE_SHARE = {(0, (2, 2)): 1 / 4, (0, (4, 1)): 1 / 4,
                        (0, (1, 4)): 1 / 4, (1, (2, 2)): 1 / 4,
                        (2, (1, 4)): 1, (2, (2, 2)): 1 / 2, (3, (1, 4)): 1}
LM_SHARD_GIB_TOL = 5e-4


def _rel(got, want) -> float:
    """max |got - want| / max |want|, over the whole tensors."""
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max().clamp_min(1e-30))


def _lm_shard_cfg(leg):
    """A sharded serving leg's config: float32 compute, an MoE at a
    capacity factor of E / k."""
    import dataclasses
    from repro_torch.configs import get_config
    arch, over = LM_SHARD_LEGS[leg][:2]
    cfg = dataclasses.replace(get_config(arch), compute_dtype="float32",
                              **over)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    return cfg


def _lm_shard_whole(leg, dev):
    """Leg ``leg`` served whole on one process: the prompt, prefill and
    its decode steps, each step fed the greedy token of the call before.
    Returns {"prompt", "tokens" (each step's input), "logits" (each
    call's), "caches" (after the last step, {dotted name: tensor}),
    "prefill_ms", "decode_ms"}, on the card."""
    import torch
    from repro_torch.models import convert
    from repro_torch.models import transformer as tf
    cfg = _lm_shard_cfg(leg)
    b, p, n = LM_SHARD_LEGS[leg][2:5]
    gen = torch.Generator(dev).manual_seed(LM_SHARD_SEEDS[leg])
    model = tf.init_params(gen, cfg)
    prompt = torch.randint(0, cfg.vocab, (b, p), generator=gen, device=dev)
    sync = torch.cuda.synchronize
    sync()
    t = time.perf_counter()
    logits, caches = tf.prefill(model, prompt, max_len=p + n)
    sync()
    prefill_ms = (time.perf_counter() - t) * 1e3
    out = {"prompt": prompt, "tokens": [], "logits": [logits]}
    t = time.perf_counter()
    for j in range(n):
        tok = out["logits"][-1][:, -1:].argmax(dim=-1)
        lg, caches = tf.decode_step(model, tok, caches, p + j)
        out["tokens"].append(tok)
        out["logits"].append(lg)
    sync()
    out["decode_ms"] = (time.perf_counter() - t) * 1e3 / n
    out["prefill_ms"] = prefill_ms
    out["caches"] = convert._dotted(caches)
    del model
    return out


def _lm_shard_leg(leg, mesh, ref, dev, sync):
    """Leg ``leg`` served on ``mesh`` from this rank's blocks
    (``shard_params_`` by ``"train"``), fed the one process's tokens
    (``ref``), with the collectives over "data" (``fsdp_timing``) and
    over "model" (``tp_timing``) timed.  Returns the leg's record: its
    errors against ``ref`` on the rank's rows (and kv heads of the
    caches), the logits' checksum, the held and whole parameter and cache
    bytes, ms of prefill and of the decode steps with the ms of their
    "data" gathers, "model" all-reduces and "model" gathers, and how many
    greedy tokens agree with ``ref``'s."""
    import torch
    from repro_torch.models import convert
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import DATA_AXES, mesh_coord, mesh_sizes
    from repro_torch.training import train_step as ts
    cfg = _lm_shard_cfg(leg)
    b, p, n = LM_SHARD_LEGS[leg][2:5]
    model = ts.shard_params_(tf.init_params(torch.Generator(dev).manual_seed(
        LM_SHARD_SEEDS[leg]), cfg), mesh, "train")
    idx, count = mesh_coord(mesh, DATA_AXES)
    rows = slice(idx * (b // count), (idx + 1) * (b // count))
    tp, mr = mesh_sizes(mesh)["model"], mesh.get_local_rank("model")
    kv = cfg.n_kv // tp if cfg.n_kv % tp == 0 else cfg.n_kv

    def block(name, t):
        """The rank's block of the one process's cache leaf ``name``: its
        rows, and its kv heads where they divide over "model"."""
        t = t[rows]
        if name.rsplit(".", 1)[-1] in ("k", "v", "xk", "xv"):
            t = t[:, :, mr * kv:(mr + 1) * kv] if kv < cfg.n_kv else t
        return t

    held = tf.held_axes(model, mesh)
    rec = {"data": idx, "held_bytes": sum(
        q.numel() * q.element_size() for q in model.parameters()),
        "whole_bytes": 4 * sum(math.prod(s) for s in
                               convert.logical_shapes(cfg).values()),
        "blocks": len(held),
        "tp_blocks": sum("model" in a and not convert.expert_weight(k)
                         for k, a in held.items()),
        "recurrent_blocks": sum(
            "model" in a and bool({"ssm", "rec"} & set(convert.ref_path(k)[0]))
            for k, a in held.items()),
        "data_blocks": sum("data" in a for a in held.values())}
    keys = ("ms", "data_ms", "reduce_ms", "gather_ms", "scatter_ms")
    for key in keys:
        rec["decode_" + key] = []
    got = []
    with tf.fsdp_timing() as fs, tf.tp_timing() as tps:
        def call(fn):
            was = (fs["gather"], tps["all_reduce"], tps["gather"],
                   tps["reduce_scatter"])
            sync()
            t = time.perf_counter()
            out = fn()
            sync()
            now = (fs["gather"], tps["all_reduce"], tps["gather"],
                   tps["reduce_scatter"])
            return out, [(time.perf_counter() - t) * 1e3] + [
                (b - a) * 1e3 for a, b in zip(was, now)]
        (logits, caches), times = call(lambda: tf.prefill(
            model, ref["prompt"][rows], mesh=mesh, max_len=p + n))
        for key, v in zip(keys, times):
            rec["prefill_" + key] = v
        got.append(logits)
        for j in range(n):
            (lg, caches), times = call(lambda: tf.decode_step(
                model, ref["tokens"][j][rows], caches, p + j, mesh=mesh))
            for key, v in zip(keys, times):
                rec["decode_" + key].append(v)
            got.append(lg)
    rec["logit_err"] = max(_rel(g, w[rows]) for g, w in
                           zip(got, ref["logits"], strict=True))
    rec["finite"] = all(bool(torch.isfinite(g).all()) for g in got)
    mine = convert._dotted(caches)
    rec["same_keys"] = set(mine) == set(ref["caches"])
    rec["cache_err"] = max(_rel(mine[k], block(k, w))
                           for k, w in ref["caches"].items())
    rec["cache_bytes"] = sum(t.numel() * t.element_size()
                             for t in mine.values())
    rec["whole_cache_bytes"] = sum(t.numel() * t.element_size()
                                   for t in ref["caches"].values())
    rec["argmax_agree"] = sum(
        int((g[:, -1:].argmax(dim=-1) == t[rows]).sum())
        for g, t in zip(got, ref["tokens"]))
    rec["sum"] = _lm_tm_checksum({str(j): g for j, g in enumerate(got)})
    del model, caches, got
    return rec


def _lm_mesh_rank(rank, world, d, refs):
    """One of phase 8f's four gloo ranks on the one card, mesh (1, 4):
    ring attention on the rank's sequence block and the expert-parallel
    MoE on its token block, each beside the single-process path on the
    same inputs (the whole attention; ``_moe_local`` on the block); then
    each sharded serving leg (``LM_SHARD_LEGS``) on each of its meshes
    against the one process's ``refs`` (shared by CUDA IPC).  Writes
    ``<d>/rank<rank>.json``."""
    sys.path.insert(0, str(ROOT / "src"))
    import dataclasses
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_config
    from repro_torch.models import attention as attn
    from repro_torch.models import moe

    with open(Path(d) / "params.json") as fh:
        prm = json.load(fh)
    dev = torch.device(prm["device"])
    sync = lambda: None
    if dev.type == "cuda":
        dev = torch.device("cuda", dev.index or 0)
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        sync = torch.cuda.synchronize
    dist.init_process_group(
        "gloo", init_method=f"file://{d}/gloo", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    mesh = init_device_mesh(dev.type, (1, world),
                            mesh_dim_names=("data", "model"))
    r = mesh.get_local_rank("model")
    out = {}

    def timed(fn):
        sync()
        t = time.perf_counter()
        res = fn()
        sync()
        return res, (time.perf_counter() - t) * 1e3

    with torch.no_grad():
        cfg = dataclasses.replace(get_config("qwen3-0.6b"),
                                  compute_dtype="float32")
        gen = torch.Generator(dev).manual_seed(81)
        p = attn.init_attn(gen, cfg)
        b, s = prm["ring"]
        x = torch.randn((b, s, cfg.d_model), generator=gen, device=dev)
        pos = torch.arange(s, device=dev).expand(b, s)
        full, out["single_ms"] = timed(lambda: attn.attention(p, cfg, x,
                                                              pos))
        blk = slice(r * s // world, (r + 1) * s // world)
        got, out["ring_ms"] = timed(lambda: attn.attention_ring(
            p, cfg, x[:, blk].contiguous(), mesh))
        out["ring_err"] = _rel(got, full[:, blk])
        out["ring_finite"] = bool(torch.isfinite(got).all())
        del full, got, x, p

        mcfg = dataclasses.replace(get_config("moonshot-v1-16b-a3b"),
                                   compute_dtype="float32")
        m = moe.init_moe(torch.Generator(dev).manual_seed(82), mcfg)
        b, s = prm["moe"]
        x = torch.randn((b, s, mcfg.d_model), device=dev,
                        generator=torch.Generator(dev).manual_seed(83))
        x = x[:, r * s // world:(r + 1) * s // world].contiguous()
        (got, drop), out["ep_ms"] = timed(lambda: moe.moe_block(
            m, mcfg, x, None, mesh))
        (want, wdrop), out["local_ms"] = timed(lambda: moe._moe_local(
            m, mcfg, x))
        out["moe_err"] = _rel(got, want)
        out["moe_finite"] = bool(torch.isfinite(got).all())
        # the same from a module holding only this rank's experts
        own, e_loc = torch.nn.Module(), mcfg.moe.n_experts // world
        own.router = m.router
        for name in ("w_in", "w_gate", "w_out"):
            if hasattr(m, name):
                setattr(own, name, torch.nn.Parameter(
                    getattr(m, name)[r * e_loc:(r + 1) * e_loc],
                    requires_grad=False))
        out["own_err"] = _rel(moe.moe_block(own, mcfg, x, None, mesh)[0],
                              got)
        out["ep_drop"], out["local_drop"] = float(drop), float(wdrop)
    del m, own, x, got, want
    gc.collect()

    # serving from sharded states
    out["shard"] = {}
    for leg, spec in enumerate(LM_SHARD_LEGS):
        for shape in spec[6]:
            smesh = init_device_mesh(dev.type, shape,
                                     mesh_dim_names=("data", "model"))
            out["shard"][f"{leg}/{shape}"] = _lm_shard_leg(
                leg, smesh, refs[leg], dev, sync)
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    with open(Path(d) / f"rank{rank}.json", "w") as fh:
        json.dump(out, fh)
    # the shared references go back before the producer frees them
    refs.clear()
    gc.collect()
    dist.barrier()
    dist.destroy_process_group()


def _lm_shard_report(ranks, whole, smi):
    """Holds and prints the sharded serving legs of phase 8f: ``ranks``
    the four ranks' records (``_lm_mesh_rank``), ``whole`` each leg's
    one-process run (``_lm_shard_whole``).  Raises on the first failed
    check."""
    for leg, spec in enumerate(LM_SHARD_LEGS):
        arch, _, b, p, n, cut, shapes = spec
        w = whole[leg]
        for shape in shapes:
            res = [r["shard"][f"{leg}/{shape}"] for r in ranks]
            want_gib = LM_SHARD_PREDICTED_GIB[leg, shape]
            share = LM_SHARD_CACHE_SHARE[leg, shape]
            for r, rec in enumerate(res):
                peer = next(q for q in res if q["data"] == rec["data"])
                if not (rec["finite"] and rec["same_keys"]
                        and rec["blocks"] > 0
                        and (rec["tp_blocks"] > 0) == (shape[1] > 1)
                        and (rec["recurrent_blocks"] > 0) == (
                            shape[1] > 1 and arch.startswith(
                                ("mamba2", "recurrentgemma")))
                        and (rec["data_blocks"] > 0) == (shape[0] > 1)) \
                        or rec["logit_err"] > LM_CARD_TOL \
                        or rec["cache_err"] > LM_CARD_TOL \
                        or rec["sum"] != peer["sum"] \
                        or abs(rec["held_bytes"] / 2 ** 30 - want_gib) > \
                        LM_SHARD_GIB_TOL \
                        or rec["cache_bytes"] != \
                        rec["whole_cache_bytes"] * share:
                    raise AssertionError(f"LM_SERVE_SHARDED {arch} {shape} "
                                         f"rank {r}: {rec}")
            top = lambda k: max(rec[k] for rec in res)
            # each call's times from its slowest rank, so that the
            # collectives' shares are of one rank's call
            slow = [max(res, key=lambda rec: rec["decode_ms"][j])
                    for j in range(n)]
            col = lambda k: [rec[k][j] for j, rec in enumerate(slow)]
            dec, dgat = col("decode_ms"), col("decode_data_ms")
            dred, dmod = col("decode_reduce_ms"), col("decode_gather_ms")
            dsc = col("decode_scatter_ms")
            first = max(res, key=lambda rec: rec["prefill_ms"])
            pre = first["prefill_ms"]
            pct = lambda x, t: f"{x / t:.1%}"
            rnd = lambda xs: [round(x, 1) for x in xs]
            print(f"LM_SERVE_SHARDED {arch} ({cut}, full width, float32"
                  + (", capacity factor E / k" if "moonshot" in arch else "")
                  + f"), {b} x {p} prompts and {n} greedy decode steps on "
                  f"mesh {shape} (\"data\", \"model\"), four gloo ranks, "
                  f"each holding its blocks by the training layout rule "
                  f"({res[0]['tp_blocks']} tensor-parallel leaves over "
                  f"\"model\", {res[0]['recurrent_blocks']} of them in the "
                  f"SSM or RG-LRU layers, {res[0]['data_blocks']} over "
                  f"\"data\"): "
                  f"parameters {top('held_bytes') / 2 ** 30:.4f} GiB a rank "
                  f"(the largest; predicted {want_gib} GiB) against "
                  f"{res[0]['whole_bytes'] / 2 ** 30:.3f} GiB whole; caches "
                  f"{top('cache_bytes') / 1e6:.2f} MB a rank against "
                  f"{res[0]['whole_cache_bytes'] / 1e6:.2f} MB whole "
                  f"(predicted {share:g} of it); every call's logits within "
                  f"{top('logit_err'):.2e} and the rank's rows and kv heads "
                  f"of the last caches within {top('cache_err'):.2e} of the "
                  f"model served whole on one process (tolerance "
                  f"{LM_CARD_TOL:.0e}), greedy tokens agreeing "
                  f"{min(rec['argmax_agree'] for rec in res)} of "
                  f"{n * b // shape[0]} a rank, ranks on one \"data\" "
                  f"coordinate bit-equal in the logits; prefill {pre:.1f} ms "
                  f"(\"data\" all-gathers {first['prefill_data_ms']:.1f} ms, "
                  f"{pct(first['prefill_data_ms'], pre)}; \"model\" "
                  f"all-reduces {first['prefill_reduce_ms']:.1f} ms, "
                  f"{pct(first['prefill_reduce_ms'], pre)}; \"model\" "
                  f"all-gathers {first['prefill_gather_ms']:.1f} ms, "
                  f"{pct(first['prefill_gather_ms'], pre)}; \"model\" "
                  f"reduce-scatters {first['prefill_scatter_ms']:.1f} ms, "
                  f"{pct(first['prefill_scatter_ms'], pre)}) against "
                  f"{w['prefill_ms']:.1f} ms whole; decode ms a step "
                  f"{rnd(dec)} (\"data\" all-gathers {rnd(dgat)} ms, "
                  f"{pct(sum(dgat), sum(dec))}; \"model\" all-reduces "
                  f"{rnd(dred)} ms, {pct(sum(dred), sum(dec))}; \"model\" "
                  f"all-gathers {rnd(dmod)} ms, {pct(sum(dmod), sum(dec))}; "
                  f"\"model\" reduce-scatters {rnd(dsc)} ms, "
                  f"{pct(sum(dsc), sum(dec))}) "
                  f"against {w['decode_ms']:.2f} ms whole (each call's "
                  f"slowest rank; gloo through the host, timed with the "
                  f"card synchronised around each collective); card: "
                  f"{smi}")


def _lm_serve_phase(dev, smi):
    """Phase 8f: LM serving on the card, as the module docstring lists
    it.  Raises on the first failed check; prints the numbers."""
    import dataclasses
    import tempfile

    import torch
    import torch.multiprocessing as mp
    from repro_torch.configs import LM_ARCHS, get_config, get_smoke
    from repro_torch.models import attention as attn
    from repro_torch.models import convert
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tf

    t0 = time.perf_counter()
    gib = lambda b: b / 2 ** 30
    sync = torch.cuda.synchronize
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resident = gib(torch.cuda.memory_allocated())

    def hold(label, got, want, tol=LM_SERVE_TOL):
        """Finite, and max |got - want| <= tol max |want|."""
        if not torch.isfinite(got).all() or not torch.isfinite(want).all():
            raise AssertionError(f"{label}: a logit is not finite")
        err = _rel(got, want)
        if err > tol:
            raise AssertionError(f"{label}: relative max error {err:.3e} "
                                 f"beyond {tol:.0e}")
        return err

    def cache_gib(caches):
        return gib(sum(t.numel() * t.element_size()
                       for t in convert._dotted(caches).values()))

    # -- 1. qwen3-0.6b at its full config: 8 x 2048 prompts, 128 steps ----
    cfg = get_config(LM_ARCH)
    b, s, n = LM_SERVE_BATCH, LM_SERVE_PROMPT, LM_SERVE_STEPS
    gen = torch.Generator(dev).manual_seed(80)
    model = tf.init_params(gen, cfg)
    prompt = torch.randint(0, cfg.vocab, (b, s), generator=gen, device=dev)
    prefill_ms = []
    for _ in range(2):                     # the second one is timed warm
        logits = caches = None
        sync()
        t = time.perf_counter()
        logits, caches = tf.prefill(model, prompt, max_len=s + n)
        sync()
        prefill_ms.append((time.perf_counter() - t) * 1e3)
    with torch.no_grad():
        want, _ = tf.forward(model, prompt)
    err_prefill = max(hold(f"LM_SERVE prefill row {i}", logits[i], want[i])
                      for i in range(b))
    del want
    # each layer's cached keys and values against attention(return_kv)
    # on that layer's input, the layers walked one by one; the slots past
    # the prompt zero
    err_kv, pad_nonzero = 0.0, 0
    with torch.no_grad():
        x = tf._embed(model.embed, cfg, prompt)
        positions = torch.arange(s, device=dev).expand(b, s)
        for blk, c in zip(model.layers, caches["layers"], strict=True):
            _, (k_want, v_want) = attn.attention(
                blk.attn, cfg, blk.ln1(x), positions, return_kv=True)
            err_kv = max(err_kv, _rel(c["sa"]["k"][:, :s], k_want),
                         _rel(c["sa"]["v"][:, :s], v_want))
            pad_nonzero += int(c["sa"]["k"][:, s:].count_nonzero()
                               + c["sa"]["v"][:, s:].count_nonzero())
            x, _, _ = blk(x, positions)
        del x, k_want, v_want
    if err_kv > LM_CARD_TOL or pad_nonzero:
        raise AssertionError(f"LM_SERVE prefill caches: keys/values "
                             f"{err_kv:.3e} from attention(return_kv) "
                             f"(tolerance {LM_CARD_TOL:.0e}), {pad_nonzero} "
                             f"nonzero entries past the prompt")
    tok = logits[:, -1:].argmax(dim=-1)
    del logits
    steps, toks = [], [tok]
    sync()
    t = time.perf_counter()
    for j in range(n):
        lg, caches = tf.decode_step(model, tok, caches, s + j)
        tok = lg[:, -1:].argmax(dim=-1)
        steps.append(lg[:, 0])
        toks.append(tok)
    sync()
    decode_ms = (time.perf_counter() - t) * 1e3 / n
    c_gib = cache_gib(caches)
    seq = torch.cat([prompt] + toks[:-1], dim=1)     # what decode consumed
    with torch.no_grad():
        want, _ = tf.forward(model, seq)
    errs = [hold(f"LM_SERVE decode step {j + 1}", steps[j], want[:, s + j])
            for j in range(n)]
    del want
    peak = gib(torch.cuda.max_memory_allocated())
    print(f"LM_SERVE {LM_ARCH}: full config ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, vocab {cfg.vocab}, {cfg.compute_dtype} compute, "
          f"{cfg.param_dtype} weights), {b} requests x {s} prompt tokens "
          f"prefilled into caches of {s + n} slots, then {n} greedy "
          f"decode steps: prefill {prefill_ms[1]:.1f} ms "
          f"({b * s / prefill_ms[1] * 1e3:.0f} tokens/s; first call "
          f"{prefill_ms[0]:.1f} ms), decode {decode_ms:.2f} ms/step "
          f"({b / decode_ms * 1e3:.0f} tokens/s; host clock over the "
          f"{n} steps, no sync between them), KV cache {c_gib:.3f} GiB, "
          f"peak max_memory_allocated {peak:.3f} GiB ({resident:.3f} of it "
          f"resident from the earlier phases); prefill logits against "
          f"forward on the prompt {err_prefill:.2e} (one code path: a "
          f"smoke check), each layer's cached keys and values against "
          f"attention(return_kv) on its input {err_kv:.2e} (tolerance "
          f"{LM_CARD_TOL:.0e}), the {n} slots past the prompt all zero; "
          f"decode against "
          f"forward's positions on the prompt + generated tokens: step 1 "
          f"{errs[0]:.2e}, step {n} {errs[-1]:.2e}, worst of {n} "
          f"{max(errs):.2e} (relative max error, tolerance "
          f"{LM_SERVE_TOL:.0e}); every logit finite; card: {smi}")

    # one profiled decode step: step n again (the same token into the same
    # slot writes the same keys and values)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tf.decode_step(model, toks[-2], caches, s + n - 1)
        sync()
    agg = _device_breakdown(prof)
    busy = sum(v[0] for v in agg.values())
    if busy <= 0:
        print("LM_SERVE profile: device time not measured (the profiler "
              "saw no device activity)")
    else:
        groups = "; ".join(f"{k} {v:.2f} ms" for k, v in
                           _lm_groups(agg).most_common())
        rows = sorted(((v[0], v[1], k) for k, v in agg.items()),
                      reverse=True)
        top = "; ".join(f"{t:.2f} ms x{c} {k[:70]}" for t, c, k in rows[:8])
        print(f"LM_SERVE profile of one decode step: device busy "
              f"{busy:.2f} ms of the {decode_ms:.2f} ms/step (idle share "
              f"{max(0.0, 1 - busy / decode_ms):.1%}); "
              f"{sum(v[1] for v in agg.values())} kernels; by kind: "
              f"{groups}; top: {top}; card: {smi}")
    del model, caches, steps, toks, prompt, seq, prof
    gc.collect()
    torch.cuda.empty_cache()

    # -- 2. the other nine configs at full width, a cut depth ---------------
    def serve(fcfg, b, p):
        """Prefill p tokens (and the frontend), decode k more, and run
        forward on all of them.  Returns each position's max |serve -
        forward| over forward's max |logit| (b, P), whether every logit
        is finite, forward's moe_drop, the wall seconds of prefill and
        decode, the caches' GiB and, for a MoE config, each MoE layer's
        router logits (L, b, P, E) in the serving run and in forward."""
        gen = torch.Generator(dev).manual_seed(0)
        model = tf.init_params(gen, fcfg)
        k = LM_SERVE_FAMILY_STEPS
        tokens = torch.randint(0, fcfg.vocab, (b, p + k), generator=gen,
                               device=dev)
        frontend = (torch.randn((b, fcfg.n_frontend_tokens, fcfg.d_model),
                                generator=gen, device=dev)
                    if fcfg.n_frontend_tokens else None)
        prefix = fcfg.n_frontend_tokens if fcfg.family == "vlm" else 0
        routers = []
        route = moe_mod._route

        def spy(pm, m, xf):                 # the router's logits, as _route
            routers.append((xf.float() @ pm.router).float())
            return route(pm, m, xf)

        moe_mod._route = spy
        try:
            sync()
            t = time.perf_counter()
            logits, caches = tf.prefill(model, tokens[:, :p], frontend,
                                        max_len=p + prefix + k)
            steps = [logits]
            for j in range(k):
                lg, caches = tf.decode_step(
                    model, tokens[:, p + j:p + j + 1], caches, p + prefix + j)
                steps.append(lg)
            sync()
            wall = time.perf_counter() - t
            n_serve = len(routers)
            with torch.no_grad():
                full, aux = tf.forward(model, tokens, frontend)
        finally:
            moe_mod._route = route
        got = torch.cat(steps, dim=1)
        finite = bool(torch.isfinite(got).all() and torch.isfinite(full).all())
        err = ((got - full).abs().amax(dim=-1)
               / full.abs().max().clamp_min(1e-30))
        router = None
        if fcfg.moe is not None:
            n_l = n_serve // (k + 1)
            serve_r = [torch.cat([routers[l].reshape(b, p + prefix, -1)]
                                 + [routers[n_l * (j + 1) + l][:, None]
                                    for j in range(k)], dim=1)
                       for l in range(n_l)]
            fwd_r = [r.reshape(b, p + prefix + k, -1)
                     for r in routers[n_serve:]]
            router = torch.stack(serve_r), torch.stack(fwd_r)
        c = cache_gib(caches)
        del model, caches, logits, steps, full, got, tokens, frontend
        torch.cuda.empty_cache()
        return err, finite, float(aux["moe_drop"]), wall, c, router

    def flips(router, top_k):
        """Where the serving run's top-k experts differ from forward's in
        some MoE layer (b, P), forward's margin between its k-th and
        (k+1)-th router logit, least over the layers (b, P), and the
        largest router logit difference between the runs (b, P): a flip
        needs the difference to reach the margin."""
        serve_r, fwd_r = router

        def top(lg):
            order = torch.sort(torch.softmax(lg, dim=-1), dim=-1,
                               descending=True, stable=True)
            return order.indices[..., :top_k].sort(dim=-1).values

        flip = (top(serve_r) != top(fwd_r)).any(dim=-1).any(dim=0)
        f_val = fwd_r.sort(dim=-1, descending=True).values
        margin = (f_val[..., top_k - 1] - f_val[..., top_k]).amin(dim=0)
        delta = (serve_r - fwd_r).abs().amax(dim=-1).amax(dim=0)
        return flip, margin, delta

    failed = []                  # each config's line prints before a raise
    for arch, over, b, p, cut in LM_SERVE_FAMILIES:
        base = dataclasses.replace(get_config(arch), **over)
        runs = [base]
        if base.moe is not None:
            base = dataclasses.replace(base, moe=dataclasses.replace(
                base.moe, capacity_factor=base.moe.n_experts
                / base.moe.top_k))
            runs = [base, dataclasses.replace(base, compute_dtype="float32")]
        for fcfg in runs:
            torch.cuda.reset_peak_memory_stats()
            err, finite, drop, wall, c, router = serve(fcfg, b, p)
            prefix = fcfg.n_frontend_tokens if fcfg.family == "vlm" else 0
            n_pre = p + prefix
            e_pre = float(err[:, :n_pre].max())
            e_dec = float(err[:, n_pre:].max())
            stray = err > LM_SERVE_TOL
            ok = finite and drop == 0
            extra = ""
            if router is not None and fcfg.compute_dtype != "float32":
                # bfloat16: a stray position must follow a router flip
                flip, margin, delta = flips(router, fcfg.moe.top_k)
                seen = flip.cummax(dim=1).values   # at it or before, its row
                share = float(stray.float().mean())
                med = float(err.median())
                ok = ok and share <= LM_SERVE_MOE_STRAY and med <= 1e-2 \
                    and bool(seen[stray].all())
                where = stray.nonzero().tolist()
                extra = (f"; {fcfg.compute_dtype}, capacity factor "
                         f"{fcfg.moe.capacity_factor:g} = E / k, moe_drop "
                         f"{drop:g}; positions beyond {LM_SERVE_TOL:.0e}: "
                         f"{int(stray.sum())} of {stray.numel()} ({share:.1%};"
                         f" at most {LM_SERVE_MOE_STRAY:.0%}), median "
                         f"{med:.2e}; top-k flips against forward at "
                         f"{int(flip.sum())} positions")
                at = lambda i, j: ("here" if bool(flip[i, j]) else
                                   "earlier in the row" if bool(seen[i, j])
                                   else "NONE")
                extra += "".join(
                    f"; stray row {i} pos {j}: {float(err[i, j]):.2e}, flip "
                    f"{at(i, j)}, forward's top-k logit margin "
                    f"{float(margin[i, j]):.2e}, router logits apart "
                    f"{float(delta[i, j]):.2e}" for i, j in where[:8])
            else:
                ok = ok and not bool(stray.any())
                if router is not None:
                    extra = (f"; {fcfg.compute_dtype}, capacity factor "
                             f"{fcfg.moe.capacity_factor:g} = E / k, "
                             f"moe_drop {drop:g}")
            if not ok:
                failed.append(f"{arch} {fcfg.compute_dtype} (finite {finite},"
                              f" moe_drop {drop})")
            print(f"LM_SERVE_FAMILY {arch} ({fcfg.family}; cut: {cut}; "
                  f"d_model {fcfg.d_model}), batch {b}, prompt {p}"
                  + (f" + {prefix} prefix" if prefix else "")
                  + f", {LM_SERVE_FAMILY_STEPS} decode steps in "
                  f"{wall * 1e3:.1f} ms with the prefill; prefill against "
                  f"forward {e_pre:.2e}, decode worst {e_dec:.2e}; caches "
                  f"{c * 1024:.1f} MiB, peak "
                  f"{gib(torch.cuda.max_memory_allocated()):.3f} GiB{extra}")
    if failed:
        raise AssertionError(f"LM_SERVE_FAMILY: beyond {LM_SERVE_TOL:.0e} "
                             f"or not finite or dropping: {failed}")

    # -- 3. the card against the host CPU, the ten smoke configs, f32 -------
    host = torch.device("cpu")
    worst = collections.Counter()
    for arch in LM_ARCHS:
        scfg = dataclasses.replace(get_smoke(arch), compute_dtype="float32")
        tree = convert.to_reference(
            tf.init_params(torch.Generator().manual_seed(0), scfg))
        rng = torch.Generator().manual_seed(1)
        tokens = torch.randint(0, scfg.vocab, (2, 18), generator=rng)
        frontend = (torch.randn((2, scfg.n_frontend_tokens, scfg.d_model),
                                generator=rng)
                    if scfg.n_frontend_tokens else None)
        prefix = scfg.n_frontend_tokens if scfg.family == "vlm" else 0
        res = []                              # the host's, the card's
        for where in (host, dev):
            model = convert.from_reference(tree, scfg, where)
            fr = None if frontend is None else frontend.to(where)
            lg, caches = tf.prefill(model, tokens[:, :16].to(where), fr,
                                    max_len=20 + prefix)
            out = [lg.cpu()]
            for j in range(2):
                lg, caches = tf.decode_step(
                    model, tokens[:, 16 + j:17 + j].to(where), caches,
                    16 + prefix + j)
                out.append(lg.cpu())
            res.append((out, convert._flat(
                convert.caches_to_reference(caches))))
        (want_lg, want), (got_lg, got) = res
        errs = {"prefill": _rel(got_lg[0], want_lg[0]),
                "decode": max(_rel(g, w) for g, w in
                              zip(got_lg[1:], want_lg[1:])),
                "caches": max(_rel(torch.from_numpy(got[k]),
                                   torch.from_numpy(want[k]))
                              for k in want)}
        bad = {k: v for k, v in errs.items() if v > LM_CARD_TOL}
        if bad or set(got) != set(want):
            raise AssertionError(f"LM_SERVE_CARD_VS_CPU {arch}: beyond "
                                 f"{LM_CARD_TOL:.0e}: {bad}")
        for k, v in errs.items():
            worst[k] = max(worst[k], v)
    print(f"LM_SERVE_CARD_VS_CPU: ten smoke configs, float32, prefill of "
          f"16 tokens and two decode steps: the card within "
          f"{LM_CARD_TOL:.0e} of the host CPU (relative max error; worst "
          + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()) + ")")

    # -- 4. ring attention and the expert-parallel MoE on four ranks -------
    gc.collect()
    torch.cuda.empty_cache()
    # the sharded serving legs' models served whole on this process
    whole = [_lm_shard_whole(leg, dev) for leg in range(len(LM_SHARD_LEGS))]
    refs = [{k: v for k, v in w.items() if not k.endswith("_ms")}
            for w in whole]
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d:
        with open(Path(d) / "params.json", "w") as fh:
            json.dump({"device": str(dev), "ring": LM_MESH_RING,
                       "moe": LM_MESH_MOE}, fh)
        t1 = time.perf_counter()
        mp.start_processes(_lm_mesh_rank, args=(4, d, refs), nprocs=4,
                           start_method=DIST_START)
        del refs
        torch.cuda.ipc_collect()
        ranks = []
        for r in range(4):
            # written by this phase's own ranks just above
            with open(Path(d) / f"rank{r}.json") as fh:
                ranks.append(json.load(fh))
    t_ranks = time.perf_counter() - t1
    for r, res in enumerate(ranks):
        if not (res["ring_finite"] and res["moe_finite"]) or \
                res["ring_err"] > LM_CARD_TOL or \
                res["moe_err"] > LM_CARD_TOL or \
                res["own_err"] > LM_CARD_TOL:
            raise AssertionError(f"LM_SERVE_MESH rank {r}: {res}")
    local = statistics.mean(res["local_drop"] for res in ranks)
    if any(abs(res["ep_drop"] - local) > 1e-6 for res in ranks):
        raise AssertionError(f"LM_SERVE_MESH: the expert-parallel drop "
                             f"{[res['ep_drop'] for res in ranks]} against "
                             f"the blocks' mean {local}")
    top = lambda k: max(res[k] for res in ranks)
    n_exp = get_config("moonshot-v1-16b-a3b").moe.n_experts
    print(f"LM_SERVE_MESH four gloo ranks on the one card, mesh (1, 4), "
          f"float32: ring attention (qwen3-0.6b's attention, batch "
          f"{LM_MESH_RING[0]} x seq {LM_MESH_RING[1]}, each rank's 1/4 of "
          f"the queries, the KV blocks passed rank to rank + 1 through the "
          f"host) within {top('ring_err'):.2e} of the whole attention on "
          f"one process; the expert-parallel MoE (moonshot-v1-16b-a3b's "
          f"layer, {n_exp} experts, {n_exp // 4} a rank, batch "
          f"{LM_MESH_MOE[0]} x seq "
          f"{LM_MESH_MOE[1]} split over the ranks, two a2a switches) within "
          f"{top('moe_err'):.2e} of _moe_local on each rank's tokens, "
          f"drop {ranks[0]['ep_drop']:.4f} = the blocks' mean (tolerance "
          f"{LM_CARD_TOL:.0e}), and within {top('own_err'):.2e} of that "
          f"from a module holding only the rank's {n_exp // 4} experts' "
          f"weights; wall ms ring {top('ring_ms'):.1f} / whole "
          f"{top('single_ms'):.1f}, expert-parallel {top('ep_ms'):.1f} "
          f"/ local {top('local_ms'):.1f} (gloo stages through the host: "
          f"no communication figure); ranks {t_ranks:.1f} s; card: {smi}")
    _lm_shard_report(ranks, whole, smi)
    del whole
    print(f"LM serve phase: {time.perf_counter() - t0:.1f} s; card: {smi}")


# the LM training-on-a-mesh phase (8g): four gloo ranks on the one card,
# float32 compute, TF32 off, every state held by the training layout
# rule (train_step.shard_state_: FSDP over "data"; the MoE's own experts
# and the tensor-parallel blocks over "model").  (arch, config
# overrides, global batch, seq, the cut as printed); the dense model
# takes LM_TM_DENSE_STEPS steps on each mesh, a checkpoint between two
# meshes; the MoE model, at a capacity factor
# of E / k, takes LM_TM_MOE_STEPS steps on its mesh.  The second half of
# each batch drops its last LM_TM_MASKED positions from the mask, so that
# the shards' masks differ (the loss is over the global mask sum)
LM_TM_DENSE = ("qwen3-0.6b", {"n_layers": 4, "attn_ring": True}, 4, 2048,
               "28 -> 4 layers")
LM_TM_DENSE_MESHES = ((2, 2), (4, 1), (1, 4))
# the dense steps on each mesh, in order
LM_TM_DENSE_STEPS = (1, 1, 1)
LM_TM_MOE = ("moonshot-v1-16b-a3b", {"n_layers": 1}, 2, 1024,
             "48 -> 1 layer")
LM_TM_MOE_MESH = (2, 2)
LM_TM_MOE_STEPS = 1
# the tensor-parallel leg: the dense model without attn_ring, a fresh
# state cut by the layout rule on each mesh, LM_TM_TP_STEPS steps on the
# dense leg's first batches (the one process's run of the dense model
# serves both legs: the ring changes none of its numbers), with its
# tensor-parallel all-reduces timed (transformer.tp_timing)
LM_TM_TP_MESHES = ((1, 4), (2, 2))
LM_TM_TP_STEPS = 1
# the state a rank of the tensor-parallel leg holds (parameters and two
# moments, float32), predicted from the reference's layout (its
# state_specs' local shapes) before the first run: GiB a mesh, held to
# half of its last digit.  (The CPU test test_held_shapes_match_state_specs
# in tests/test_torch_train_tp.py holds the port's rule against
# state_specs leaf by leaf; this figure does not come from the port.)
LM_TM_TP_PREDICTED_GIB = {(1, 4): 0.611, (2, 2): 0.611}
# the recurrent tensor-parallel legs: (arch, config overrides, global
# batch, seq, the cut as printed), a fresh state each, cut by the layout
# rule on LM_TM_REC_MESH (the SSM's d_model, the RG-LRU's d_rnn, the
# MLP's d_ff, the heads and the vocabulary over "model"), a step on its
# first batch against the one process's; the state a rank predicted as
# LM_TM_TP_PREDICTED_GIB is.  mamba2 computes in float64 (its parameters
# and its SSD scan float32; its logits and loss float64): its decay's
# gradient (a_log, 80 leaves a layer summed over every position) is at
# float32's noise floor at full width, the one process's float32
# gradient 1.1e-4 of its largest off float64's and any other order of a
# sum (the row-parallel projection, the vocab-parallel head and loss) as
# far off again, where float64 holds the reorderings to 1e-9
# (tools/probe_ssm_grad_conditioning.py)
LM_TM_REC = (("mamba2-2.7b", {"n_layers": 2, "compute_dtype": "float64"},
              2, 512, "64 -> 2 layers"),
             ("recurrentgemma-9b", {"n_layers": 3}, 2, 512,
              "38 -> 3 layers"))
LM_TM_REC_MESH = (1, 4)
LM_TM_REC_PREDICTED_GIB = {"mamba2-2.7b": 0.585, "recurrentgemma-9b": 4.782}
LM_TM_MASKED = 256
LM_TM_SEEDS = {"dense": 91, "moe": 92, "batch": 93, "mamba2-2.7b": 94,
               "recurrentgemma-9b": 95}
# held: each loss within LM_TM_LOSS_TOL relative of the one process's;
# each leaf of the first step's reduced gradient (a rank's block against
# the matching slice) within LM_TM_GRAD_TOL of the leaf's largest value;
# the dense parameters after the last step elementwise within
# LM_TM_RTOL |p| + LM_TM_ATOL, the reference elastic test's bound (with
# warmup=100 the four steps' learning rates sum to 3e-5: the bound holds
# each update's direction wherever the gradient is more than rounding);
# the ranks on one "data" coordinate bit-equal (but their blocks over
# "model"), the gathered parameters bit-equal on every rank; the
# tensor-parallel leg's parameters after its steps as the dense ones
LM_TM_LOSS_TOL = 1e-5
LM_TM_GRAD_TOL = 1e-4
LM_TM_RTOL, LM_TM_ATOL = 2e-5, 2e-6
# per rank, the float32 logits' bytes (its block of the vocabulary)
# times this many in the reckoning: the logits and their gradient
# (train_step._MaskedNLL writes the gradient into one buffer, chunk by
# chunk)
LM_TM_LOGIT_COPIES = 2


def _lm_tm_rec_cfgs():
    """The recurrent tensor-parallel legs' configs (``LM_TM_REC``),
    float32 compute unless the leg says otherwise."""
    import dataclasses
    from repro_torch.configs import get_config
    return [dataclasses.replace(get_config(arch),
                                **{"compute_dtype": "float32", **over})
            for arch, over, *_ in LM_TM_REC]


def _lm_tm_cfgs():
    """The phase's two configs, float32 compute."""
    import dataclasses
    from repro_torch.configs import get_config
    arch, over = LM_TM_DENSE[:2]
    dense = dataclasses.replace(get_config(arch), compute_dtype="float32",
                                **over)
    arch, over = LM_TM_MOE[:2]
    moe = dataclasses.replace(get_config(arch), compute_dtype="float32",
                              **over)
    moe = dataclasses.replace(moe, moe=dataclasses.replace(
        moe.moe, capacity_factor=moe.moe.n_experts / moe.moe.top_k))
    return dense, moe


def _lm_tm_batches(cfg, n, batch, seq, dev):
    from repro_torch.data.pipeline import synthetic_batch
    out = []
    for i in range(n):
        b = synthetic_batch(cfg, i, batch, seq, seed=LM_TM_SEEDS["batch"],
                            device=dev)
        b["mask"][batch // 2:, seq - LM_TM_MASKED:] = 0.0
        out.append(b)
    return out


def _lm_tm_checksum(named, skip=()) -> int:
    """An integer of every bit of the tensors ``named`` ({name: tensor},
    but ``skip``): each leaf's float32 words as integers, weighted by
    their position."""
    import torch
    total, chunk = 0, 1 << 24
    for name, p in named.items():
        if name in skip:
            continue
        w = p.detach().reshape(-1).view(torch.int32)
        for i in range(0, w.numel(), chunk):
            c = w[i:i + chunk].to(torch.int64)
            idx = torch.arange(i, i + c.numel(), device=c.device) % 65521
            total += int((c * (idx + 1)).sum())
    return total


# elements of a leaf ``_lm_tm_whole_checksum`` makes whole at once
LM_TM_WHOLE_SLICE = 1 << 26


def _lm_tm_whole_checksum(model, cfg, mesh) -> int:
    """``_lm_tm_checksum`` of the model's parameters gathered whole
    (``convert._whole``), a leaf at a time; a leaf of more than
    ``LM_TM_WHOLE_SLICE`` elements whole, a slice at a time along a
    dimension no axis splits (four ranks' whole copies of
    recurrentgemma-9b's 3.9 GiB embedding, with gloo's staging of each,
    would not fit beside their states), each slice's checksum at its own
    positions.  Every rank calls it."""
    import torch
    import torch.distributed as dist
    from repro_torch.models import convert
    from repro_torch.models import transformer as tf
    held = tf.held_axes(model, mesh)
    total = 0
    for name, p in model.named_parameters():
        t, axes = p.detach(), held.get(name, {})
        free = [j for j in range(t.ndim) if j not in axes.values()]
        whole = t.numel() * math.prod(
            dist.get_world_size(mesh.get_group(a)) for a in axes)
        if whole <= LM_TM_WHOLE_SLICE or not free:
            total += _lm_tm_checksum(convert._whole({name: t}, cfg, mesh))
            continue
        j = max(free, key=lambda d: t.shape[d])
        rows = max(1, t.shape[j] * LM_TM_WHOLE_SLICE // whole)
        for i in range(0, t.shape[j], rows):
            part = t.narrow(j, i, min(rows, t.shape[j] - i)).contiguous()
            for axis, k in axes.items():
                group = mesh.get_group(axis)
                parts = [torch.empty_like(part)
                         for _ in range(dist.get_world_size(group))]
                dist.all_gather(parts, part, group=group)
                part = torch.cat(parts, dim=k)
            total += _lm_tm_checksum({name: part})
    return total


def _lm_tm_state_bytes(state) -> int:
    """Bytes of the state a rank holds: parameters, both moments and the
    error feedback."""
    trees = [dict(state.params.named_parameters()), state.opt_state["m"],
             state.opt_state["v"], state.err_fb or {}]
    return sum(t.numel() * t.element_size() for tree in trees
               for t in tree.values())


def _lm_tm_leaf_diff(got, want, rtol=None, atol=None):
    """(max |got - want|, max |want|) of a leaf on the card against one
    on the host, a slice of rows at a time (a 1.3 GB leaf in float64
    would not fit beside four ranks' states); with ``rtol`` and ``atol``
    also the largest ``|got - want| / (atol + rtol |want|)``."""
    import torch
    got, want = got.detach().reshape(got.shape[0], -1), \
        want.reshape(want.shape[0], -1)
    rows = max(1, (1 << 24) // max(1, got.shape[1]))
    diff = top = excess = 0.0
    for i in range(0, got.shape[0], rows):
        w = want[i:i + rows].to(got.device, torch.float64)
        d = (got[i:i + rows].double() - w).abs()
        diff = max(diff, float(d.max()))
        top = max(top, float(w.abs().max()))
        if rtol is not None:
            excess = max(excess, float((d / (atol + rtol * w.abs())).max()))
    return (diff, top) if rtol is None else (diff, top, excess)


def _lm_tm_grad_check(model, mesh, want, out):
    """An ``on_grads`` hook for the first mesh step: its reduced
    gradients against the one process's ``want`` ({name: tensor}),
    ``out`` given (largest error of a leaf relative to the leaf's largest
    value, that leaf, the check's ms).  A rank's block of a leaf (its
    "data" block, its own experts) is held against the matching slice."""
    from repro_torch.models import transformer as tf

    def check(grads):
        t = time.perf_counter()
        held = tf.held_axes(model, mesh)
        worst = (0.0, "")
        for n, g in grads.items():
            w = want[n]
            for axis, k in held.get(n, {}).items():
                size = g.shape[k]
                w = w.narrow(k, mesh.get_local_rank(axis) * size, size)
            diff, _ = _lm_tm_leaf_diff(g, w)
            # no temporary of the leaf's size (four ranks check at once)
            top = max(float(want[n].max()), -float(want[n].min()))
            worst = max(worst, (diff / max(top, 1e-30), n))
        out.extend(worst + ((time.perf_counter() - t) * 1e3,))
    return check


def _lm_train_mesh_rank(rank, world, d, refs):
    """One of phase 8g's four gloo ranks on the one card: the dense model
    on LM_TM_DENSE_MESHES from a sharded state, a checkpoint between two
    meshes, then the MoE model on LM_TM_MOE_MESH, against the one
    process's ``refs`` (its first gradients and the dense model's last
    parameters, on the card, shared by CUDA IPC).  Writes
    ``<d>/rank<rank>.json``."""
    import os
    sys.path.insert(0, str(ROOT / "src"))
    # four ranks' states share the card: segments that grow in place
    # leave less of it reserved and unused between the two models
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    import dataclasses

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.ckpt import checkpoint as ck
    from repro_torch.models import convert
    from repro_torch.models import transformer as tf
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train_step as ts

    d = Path(d)
    with open(d / "params.json") as fh:
        prm = json.load(fh)
    dev = torch.device(prm["device"])
    sync = lambda: None
    if dev.type == "cuda":
        dev = torch.device("cuda", dev.index or 0)
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        sync = torch.cuda.synchronize
    peak = lambda: (torch.cuda.max_memory_allocated() / 2 ** 30
                    if dev.type == "cuda" else 0.0)
    dist.init_process_group(
        "gloo", init_method=f"file://{d}/gloo", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    names = ("data", "model")
    dense, moe_cfg = _lm_tm_cfgs()
    out = {}

    def leg(state, cfg, mesh, batches, rec, on_grads=None):
        """Steps on ``batches`` from ``state`` on ``mesh``; records each
        step's loss, ms, reduction ms, the ms of its FSDP collectives over
        "data" and of its tensor-parallel ones over "model" (the regions'
        all-reduces, the all-gathers, the reduce-scatters), checksum of
        the held
        parameters (but the blocks over "model", which differ over the
        axis) and "data" coordinate, then the held state's bytes, the
        peak memory_allocated of the steps and the gathered parameters'
        checksum."""
        rec["held_bytes"].append(_lm_tm_state_bytes(state))
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        for i, b in enumerate(batches):
            step = ts.train_step_fn(cfg, mesh=mesh,
                                    on_grads=on_grads if i == 0 else None)
            sync()
            t = time.perf_counter()
            with tf.fsdp_timing() as fsdp_s, tf.tp_timing() as tp_s:
                state, m = step(state, ts.data_shard(b, mesh))
            rec["loss"].append(float(m["loss"]))
            rec["ms"].append((time.perf_counter() - t) * 1e3)
            rec["grad_reduce_ms"].append(float(m["grad_reduce_s"]) * 1e3)
            for k, secs in fsdp_s.items():
                rec[k + "_ms"].append(secs * 1e3)
            for k, secs in tp_s.items():
                rec["tp_" + k + "_ms"].append(secs * 1e3)
            rec["sum"].append(_lm_tm_checksum(
                dict(state.params.named_parameters()),
                ts.model_blocks(state.params, mesh)))
            rec["data"].append(mesh.get_local_rank("data"))
        rec["peak_gib"].append(peak())
        rec["whole_sum"].append(_lm_tm_whole_checksum(state.params, cfg,
                                                      mesh))
        return state

    def record():
        return {k: [] for k in ("loss", "ms", "grad_reduce_ms", "gather_ms",
                                "reduce_scatter_ms", "tp_all_reduce_ms",
                                "tp_gather_ms", "tp_reduce_scatter_ms",
                                "sum", "data", "held_bytes", "peak_gib",
                                "whole_sum")}

    def param_diff(state, mesh, want):
        """(largest |p - want| over the leaves, its largest share of the
        bound LM_TM_RTOL |p| + LM_TM_ATOL), a rank's blocks on ``mesh``
        against the matching slices of ``want`` (whole leaves on the
        card)."""
        held = tf.held_axes(state.params, mesh)
        worst = diff = 0.0
        for n, p in state.params.named_parameters():
            w = want[n]
            for axis, k in held.get(n, {}).items():
                w = w.narrow(k, mesh.get_local_rank(axis) * p.shape[k],
                             p.shape[k])
            d_n, _, excess = _lm_tm_leaf_diff(p, w, LM_TM_RTOL, LM_TM_ATOL)
            worst, diff = max(worst, excess), max(diff, d_n)
        return diff, worst

    # -- the dense model: a leg a mesh, a checkpoint between two ---------
    gb, seq = LM_TM_DENSE[2:4]
    batches = _lm_tm_batches(dense, sum(LM_TM_DENSE_STEPS), gb, seq, dev)
    meshes = [init_device_mesh(dev.type, shape, mesh_dim_names=names)
              for shape in LM_TM_DENSE_MESHES]
    state = ts.shard_state_(ts.make_train_state(
        torch.Generator(dev).manual_seed(LM_TM_SEEDS["dense"]), dense),
        meshes[0])
    out["dense_grad"] = []
    rec = out["dense"] = record()
    out["save_s"], out["restore_s"] = [], []
    first = 0
    for i, (mesh, n) in enumerate(zip(meshes, LM_TM_DENSE_STEPS)):
        if i:
            sync()
            t = time.perf_counter()
            ck.save(d / "ckpt", first, convert.to_reference(
                state, meshes[i - 1]), mesh=meshes[i - 1])
            out["save_s"].append(time.perf_counter() - t)
            del state
            gc.collect()
            t = time.perf_counter()
            tree = ck.restore(d / "ckpt", first, ts.held_like(dense, mesh),
                              mesh=mesh, specs=ts.held_specs(
                                  dense, dict(zip(names, mesh.shape))))
            state = convert.from_reference(tree, dense, dev)
            sync()
            out["restore_s"].append(time.perf_counter() - t)
            del tree
        state = leg(state, dense, mesh, batches[first:first + n], rec,
                    _lm_tm_grad_check(state.params, mesh,
                                      refs["dense_grads"], out["dense_grad"])
                    if i == 0 else None)
        first += n
    out["dense_param_diff"], out["dense_param_excess"] = param_diff(
        state, mesh, refs["dense_params"])
    del state
    batches = batches[:LM_TM_TP_STEPS]
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # -- the tensor-parallel leg: the dense model off the ring -------------
    tp_cfg = dataclasses.replace(dense, attn_ring=False)
    out["tp"] = {}
    for shape in LM_TM_TP_MESHES:
        mesh = init_device_mesh(dev.type, shape, mesh_dim_names=names)
        state = ts.shard_state_(ts.make_train_state(
            torch.Generator(dev).manual_seed(LM_TM_SEEDS["dense"]), tp_cfg),
            mesh)
        key = "x".join(map(str, shape))
        rec = out["tp"][key] = record()
        rec["grad"] = []
        rec["blocks"] = len(ts.model_blocks(state.params, mesh))
        state = leg(state, tp_cfg, mesh, batches, rec,
                    _lm_tm_grad_check(state.params, mesh,
                                      refs["dense_grads"], rec["grad"]))
        rec["param_diff"], rec["param_excess"] = param_diff(
            state, mesh, refs["tp_params"])
        del state
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    del batches

    # -- the recurrent tensor-parallel legs --------------------------------
    # cut before the moments are made: four whole states would not fit
    for i, cfg in enumerate(_lm_tm_rec_cfgs()):
        arch, _, gb, seq, _ = LM_TM_REC[i]
        mesh = init_device_mesh(dev.type, LM_TM_REC_MESH,
                                mesh_dim_names=names)
        model = ts.shard_params_(tf.init_params(torch.Generator(
            dev).manual_seed(LM_TM_SEEDS[arch]), cfg), mesh, "train")
        state = ts.TrainState(
            model, opt.init_opt_state(dict(model.named_parameters())), None)
        rec = out["tp"][arch] = record()
        rec["grad"] = []
        rec["blocks"] = len(ts.model_blocks(model, mesh))
        rec["recurrent_blocks"] = sum(
            bool({"ssm", "rec"} & set(convert.ref_path(n)[0]))
            for n in ts.model_blocks(model, mesh))
        state = leg(state, cfg, mesh, _lm_tm_batches(cfg, 1, gb, seq, dev),
                    rec, _lm_tm_grad_check(model, mesh, refs[arch + "/grads"],
                                           rec["grad"]))
        rec["param_diff"], rec["param_excess"] = param_diff(
            state, mesh, refs[arch + "/params"])
        del state, model
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    # -- the MoE model, each rank holding its blocks ------------------------
    gb, seq = LM_TM_MOE[2:4]
    batches = _lm_tm_batches(moe_cfg, LM_TM_MOE_STEPS, gb, seq, dev)
    mesh_m = init_device_mesh(dev.type, LM_TM_MOE_MESH, mesh_dim_names=names)
    # cut before the moments are made: four whole states would not fit
    model = ts.shard_params_(tf.init_params(torch.Generator(dev).manual_seed(
        LM_TM_SEEDS["moe"]), moe_cfg), mesh_m, "train")
    named = dict(model.named_parameters())
    state = ts.TrainState(model, opt.init_opt_state(named), None)
    out["moe_rows"] = sorted({named[n].shape[0]
                              for n in ts.model_blocks(model, mesh_m)
                              if convert.expert_weight(n)})
    out["moe_grad"] = []
    rec = out["moe"] = record()
    state = leg(state, moe_cfg, mesh_m, batches, rec,
                _lm_tm_grad_check(model, mesh_m, refs["moe_grads"],
                                  out["moe_grad"]))
    with open(d / f"rank{rank}.json", "w") as fh:
        json.dump(out, fh)
    # the shared references go back before the producer frees them
    del state, model, named
    refs.clear()
    gc.collect()
    dist.barrier()
    dist.destroy_process_group()


def _lm_tm_reference(cfg, batches, gen, keep_after=()):
    """The one-process run, a step on each batch.  Returns (losses, ms
    per step, peak GiB, the first step's gradients, ``{k: the parameters
    after step k}`` for each ``k`` of ``keep_after``), the last two on
    the card, and frees the state."""
    import torch
    from repro_torch.training import train_step as ts
    torch.cuda.reset_peak_memory_stats()
    state = ts.make_train_state(gen, cfg)
    grads = {}

    def keep(g):
        grads.update({n: t.clone() for n, t in g.items()})
    losses, ms, params = [], [], {}
    for i, b in enumerate(batches):
        step = ts.train_step_fn(cfg, on_grads=keep if i == 0 else None)
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        ms.append((time.perf_counter() - t) * 1e3)
        if i + 1 in keep_after:
            params[i + 1] = {n: p.detach().clone()
                             for n, p in state.params.named_parameters()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    return losses, ms, peak, grads, params


def _lm_tm_held(cfg, shape):
    """(parameters a rank holds on a mesh of ``shape`` by the training
    layout rule, the largest group of weights one all-gather over
    "data" makes whole: a block's or a top-level leaf's, its blocks over
    "model" staying blocks)."""
    import torch
    from repro_torch.models import transformer as tf
    from repro_torch.training import train_step as ts
    sizes = dict(zip(("data", "model"), shape))
    held = ts.held_shapes(cfg, sizes)
    with torch.device("meta"):
        model = tf.Transformer(cfg)

    def block(n):
        """The module a forward calls with ``n`` among its weights (the
        first below the layer containers), or ``n`` at the top."""
        parts = n.split(".")
        for i in range(1, len(parts)):
            if not isinstance(model.get_submodule(".".join(parts[:i])),
                              (torch.nn.ModuleList, torch.nn.ModuleDict)):
                return ".".join(parts[:i])
        return n
    groups = collections.Counter()
    for n, s in held.items():
        if "data" in tf.block_axes(n, s, cfg, sizes):
            groups[block(n)] += math.prod(s) * sizes["data"]
    return (sum(math.prod(s) for s in held.values()),
            max(groups.values(), default=0))


def _lm_train_mesh_phase(dev, smi):
    """Phase 8g: LM training on a mesh of four gloo ranks on the one card,
    as the module docstring lists it.  Raises on the first failed check;
    prints the numbers."""
    import tempfile

    import torch
    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    gib = lambda b: b / 2 ** 30
    gc.collect()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    card = torch.cuda.get_device_properties(dev).total_memory
    dense, moe_cfg = _lm_tm_cfgs()
    rec_cfgs = _lm_tm_rec_cfgs()

    # the memory reckoning, before anything is spawned: a rank's blocks x
    # 16 B (weights, gradients, two moments), the largest whole weight
    # group and its gradient x 8 B, its float32 logits; at least the
    # state made whole before it is cut (the dense model's 12 B a
    # parameter, the MoE's and the recurrent legs' weights 4 B)
    n_dense = dense.n_params()
    n_moe = moe_cfg.n_params()
    gb, seq = LM_TM_DENSE[2:4]
    gb_m, seq_m = LM_TM_MOE[2:4]
    lines, worst = [], 0
    for part, cfg, shape, batch, s in (
            [("dense", dense, m, gb, seq) for m in LM_TM_DENSE_MESHES]
            + [("tp", dense, m, gb, seq) for m in LM_TM_TP_MESHES]
            + [("rec", c, LM_TM_REC_MESH, leg[2], leg[3])
               for c, leg in zip(rec_cfgs, LM_TM_REC)]
            + [("moe", moe_cfg, LM_TM_MOE_MESH, gb_m, seq_m)]):
        held, group = _lm_tm_held(cfg, shape)
        vocab = (cfg.vocab // shape[1] if cfg.vocab % shape[1] == 0
                 else cfg.vocab)
        act = LM_TM_LOGIT_COPIES * batch // shape[0] * s * vocab * 4
        per = max(16 * held + 8 * group + act,
                  (4 if part in ("moe", "rec") else 12) * cfg.n_params())
        worst = max(worst, per)
        lines.append(f"{part} {shape}: {held} parameters held x 16 B "
                     f"{gib(16 * held):.2f} GiB + a gathered group of "
                     f"{group} x 8 B {gib(8 * group):.2f} GiB + logits "
                     f"{gib(act):.2f} GiB = {gib(per):.2f} GiB")
    # kept here for the ranks: the one process's first gradients of every
    # model, the dense model's parameters after the tensor-parallel leg's
    # steps and after the last, and each recurrent leg's after its step,
    # float32
    kept = 4 * (3 * n_dense + n_moe
                + sum(2 * c.n_params() for c in rec_cfgs))
    print(f"LM_TRAIN_MESH reckoning a rank (sharded states): dense "
          f"{LM_TM_DENSE[0]} ({LM_TM_DENSE[4]}, {n_dense} parameters), "
          f"MoE {LM_TM_MOE[0]} ({LM_TM_MOE[4]}, {n_moe} parameters): "
          f"{'; '.join(lines)}; four ranks {gib(4 * worst):.2f} GiB + "
          f"{gib(resident):.2f} GiB resident here + {gib(kept):.2f} GiB of "
          f"the one process's gradients and parameters kept for the ranks, "
          f"against the card's {gib(card):.2f} GiB; card: {smi}")
    if 4 * worst + resident + kept > card:
        raise AssertionError("LM_TRAIN_MESH: the reckoning does not fit")

    with tempfile.TemporaryDirectory() as d:
        d = Path(d)
        # the one-process runs first, each freed before the next
        ref = {}
        gen = torch.Generator(dev).manual_seed(LM_TM_SEEDS["dense"])
        ref["dense"] = _lm_tm_reference(
            dense, _lm_tm_batches(dense, sum(LM_TM_DENSE_STEPS), gb, seq,
                                  dev), gen,
            (LM_TM_TP_STEPS, sum(LM_TM_DENSE_STEPS)))
        # the one process keeps all of the MoE's experts
        gen = torch.Generator(dev).manual_seed(LM_TM_SEEDS["moe"])
        ref["moe"] = _lm_tm_reference(
            moe_cfg, _lm_tm_batches(moe_cfg, LM_TM_MOE_STEPS, gb_m, seq_m,
                                    dev), gen)
        refs = {"dense_grads": ref["dense"][3],
                "dense_params": ref["dense"][4][sum(LM_TM_DENSE_STEPS)],
                "tp_params": ref["dense"][4][LM_TM_TP_STEPS],
                "moe_grads": ref["moe"][3]}
        for cfg, (arch, _, b, s, _) in zip(rec_cfgs, LM_TM_REC):
            ref[arch] = _lm_tm_reference(
                cfg, _lm_tm_batches(cfg, 1, b, s, dev),
                torch.Generator(dev).manual_seed(LM_TM_SEEDS[arch]), (1,))
            refs[arch + "/grads"], refs[arch + "/params"] = \
                ref[arch][3], ref[arch][4][1]
        with open(d / "params.json", "w") as fh:
            json.dump({"device": str(dev)}, fh)
        t1 = time.perf_counter()
        mp.start_processes(_lm_train_mesh_rank, args=(4, str(d), refs),
                           nprocs=4, start_method=DIST_START)
        t_ranks = time.perf_counter() - t1
        del refs
        torch.cuda.ipc_collect()
        ranks = []
        for r in range(4):
            # written by this phase's own ranks just above
            with open(d / f"rank{r}.json") as fh:
                ranks.append(json.load(fh))

    for part in ("dense", "moe"):
        want = ref[part][0]
        for r, res in enumerate(ranks):
            rec = res[part]
            got = rec["loss"]
            errs = [abs(g - w) / abs(w) for g, w in zip(got, want)]
            if len(got) != len(want) or max(errs) > LM_TM_LOSS_TOL or \
                    not all(math.isfinite(g) for g in got):
                raise AssertionError(f"LM_TRAIN_MESH {part} rank {r}: losses "
                                     f"{got} against {want}")
            if res[f"{part}_grad"][0] > LM_TM_GRAD_TOL:
                raise AssertionError(f"LM_TRAIN_MESH {part} rank {r}: the "
                                     f"first step's gradient of "
                                     f"{res[f'{part}_grad'][1]} "
                                     f"{res[f'{part}_grad'][0]:.2e} off")
            for i, (s, c) in enumerate(zip(rec["sum"], rec["data"])):
                peer = next(p[part] for p in ranks if p[part]["data"][i] == c)
                if s != peer["sum"][i]:
                    raise AssertionError(
                        f"LM_TRAIN_MESH {part} rank {r} step {i}: its "
                        f"blocks differ from those of its \"data\" "
                        f"coordinate's ranks")
            if rec["whole_sum"] != ranks[0][part]["whole_sum"]:
                raise AssertionError(f"LM_TRAIN_MESH {part} rank {r}: its "
                                     f"gathered parameters differ from "
                                     f"rank 0's")
    for r, res in enumerate(ranks):
        if res["dense_param_excess"] > 1.0:
            raise AssertionError(f"LM_TRAIN_MESH dense rank {r}: the last "
                                 f"parameters {res['dense_param_diff']:.2e} "
                                 f"off, {res['dense_param_excess']:.2f} x "
                                 f"the bound")
        if res["moe_rows"] != [moe_cfg.moe.n_experts // LM_TM_MOE_MESH[1]]:
            raise AssertionError(f"LM_TRAIN_MESH moe rank {r}: expert rows "
                                 f"{res['moe_rows']}")
    top = lambda k: max(res[k] for res in ranks)
    for part, spec, meshes, cfg in (
            ("dense", LM_TM_DENSE,
             " then ".join(f"{m} x{n}" for m, n in
                           zip(LM_TM_DENSE_MESHES, LM_TM_DENSE_STEPS)),
             dense),
            ("moe", LM_TM_MOE, str(LM_TM_MOE_MESH), moe_cfg)):
        col = lambda k: [max(res[part][k][i] for res in ranks)
                         for i in range(len(ranks[0][part][k]))]
        ms, red = col("ms"), col("grad_reduce_ms")
        fsdp = [a + b for a, b in zip(col("gather_ms"),
                                      col("reduce_scatter_ms"))]
        tp = [a + b + c for a, b, c in zip(col("tp_all_reduce_ms"),
                                           col("tp_gather_ms"),
                                           col("tp_reduce_scatter_ms"))]
        losses, ref_ms, ref_peak = ref[part][:3]
        whole = 12 * cfg.n_params()
        print(f"LM_TRAIN_MESH {part} {spec[0]} ({spec[4]}, full width), "
              f"float32, global batch {spec[2]} x seq {spec[3]}, mesh "
              f"{meshes}, sharded states: losses "
              f"{[round(x, 6) for x in ranks[0][part]['loss']]} within "
              f"{max(abs(g - w) / abs(w) for g, w in zip(ranks[0][part]['loss'], losses)):.2e}"
              f" of the one process's {[round(x, 6) for x in losses]} "
              f"(tolerance {LM_TM_LOSS_TOL:.0e}); the first step's reduced "
              f"gradients within {top(part + '_grad')[0]:.2e} of the one "
              f"process's (worst leaf {max(r[part + '_grad'] for r in ranks)[1]},"
              f" tolerance {LM_TM_GRAD_TOL:.0e}); ranks on one \"data\" "
              f"coordinate bit-equal, the gathered parameters bit-equal "
              f"on every rank; state held a rank (parameters, two moments) "
              f"{[round(gib(b), 3) for b in ranks[0][part]['held_bytes']]} "
              f"GiB a mesh against {gib(whole):.3f} GiB whole; ms a step on "
              f"the mesh {[round(x, 1) for x in ms]} (the slowest rank; the "
              f"first with its gradient check) against one process "
              f"{[round(x, 1) for x in ref_ms]} (the first keeping its "
              f"gradients); the check took "
              f"{max(r[part + '_grad'][2] for r in ranks):.1f} ms of the "
              f"first mesh step; the FSDP all-gathers over \"data\" "
              f"{[round(x, 1) for x in col('gather_ms')]} ms and "
              f"reduce-scatters "
              f"{[round(x, 1) for x in col('reduce_scatter_ms')]} ms (gloo, "
              f"host-staged, timed with the card synchronised around "
              f"each), together "
              f"{[f'{a / b:.1%}' for a, b in zip(fsdp, ms)]} of the step; "
              f"the tensor-parallel collectives over \"model\": "
              f"all-reduces {[round(x, 1) for x in col('tp_all_reduce_ms')]}"
              f" ms, all-gathers (the ring's attention blocks, the ring's "
              f"and the MoE's outputs and their gradients) "
              f"{[round(x, 1) for x in col('tp_gather_ms')]} ms and "
              f"reduce-scatters of the ring's blocks' gradients "
              f"{[round(x, 1) for x in col('tp_reduce_scatter_ms')]} ms "
              f"(timed alike), together "
              f"{[f'{a / b:.1%}' for a, b in zip(tp, ms)]} of the step; "
              f"the gradient reduction after the backward "
              f"{[round(x, 1) for x in red]} ms, "
              f"{[f'{a / b:.1%}' for a, b in zip(red, ms)]}; peak "
              f"memory_allocated of a rank's steps "
              f"{[round(x, 3) for x in col('peak_gib')]} GiB a mesh (the "
              f"largest rank), one process {ref_peak:.3f} GiB; card: {smi}")
    print(f"LM_TRAIN_MESH checkpoints: saved on "
          f"{' and '.join(map(str, LM_TM_DENSE_MESHES[:-1]))} in "
          f"{[round(max(r['save_s'][i] for r in ranks), 2) for i in range(len(ranks[0]['save_s']))]}"
          f" s (gathered, written once by rank 0), restored onto "
          f"{' and '.join(map(str, LM_TM_DENSE_MESHES[1:]))} as each "
          f"rank's blocks in "
          f"{[round(max(r['restore_s'][i] for r in ranks), 2) for i in range(len(ranks[0]['restore_s']))]}"
          f" s; the last parameters within {top('dense_param_diff'):.2e} "
          f"of the one process's ({top('dense_param_excess'):.3f} x the "
          f"bound {LM_TM_RTOL:.0e} |p| + {LM_TM_ATOL:.0e}); the MoE ranks "
          f"hold {ranks[0]['moe_rows'][0]} experts each; ranks "
          f"{t_ranks:.1f} s")
    _lm_tm_tp_report(ranks, ref, dense, rec_cfgs, smi)
    print(f"LM train mesh phase: {time.perf_counter() - t0:.1f} s; card: "
          f"{smi}")


def _lm_tm_tp_report(ranks, ref, cfg, rec_cfgs, smi):
    """Phase 8g's tensor-parallel legs: the dense model's on each of
    LM_TM_TP_MESHES and each recurrent leg's (LM_TM_REC), their checks
    against the one process (``ref``, ``_lm_tm_reference``'s of each
    model by part) and a line each.  Raises on the first failed
    check."""
    gib = lambda b: b / 2 ** 30
    legs = [(LM_TM_DENSE[0], f"{LM_TM_DENSE[4]}, full width, attn_ring "
             f"off, float32", LM_TM_DENSE[2:4], shape,
             "x".join(map(str, shape)),
             LM_TM_TP_PREDICTED_GIB[shape], ref["dense"], LM_TM_TP_STEPS,
             cfg, "heads, d_ff, vocabulary")
            for shape in LM_TM_TP_MESHES]
    legs += [(arch, f"{cut}, full width, {c.compute_dtype} compute",
              (b, s), LM_TM_REC_MESH, arch,
              LM_TM_REC_PREDICTED_GIB[arch], ref[arch], 1, c,
              "SSM d_model" if c.family == "ssm"
              else "RG-LRU d_rnn, heads, d_ff, vocabulary")
             for c, (arch, _, b, s, cut) in zip(rec_cfgs, LM_TM_REC)]
    for arch, cut, (b, s), shape, key, predicted, one, steps, c, what \
            in legs:
        losses, ref_ms, ref_peak = one[0][:steps], one[1], one[2]
        res = [r["tp"][key] for r in ranks]
        for r, rec in enumerate(res):
            errs = [abs(g - w) / abs(w) for g, w in zip(rec["loss"], losses)]
            if len(rec["loss"]) != len(losses) or \
                    not all(math.isfinite(g) for g in rec["loss"]) or \
                    max(errs) > LM_TM_LOSS_TOL:
                raise AssertionError(f"LM_TRAIN_TP {key} rank {r}: losses "
                                     f"{rec['loss']} against {losses}")
            if rec["grad"][0] > LM_TM_GRAD_TOL:
                raise AssertionError(f"LM_TRAIN_TP {key} rank {r}: the first "
                                     f"step's gradient of {rec['grad'][1]} "
                                     f"{rec['grad'][0]:.2e} off")
            if rec["param_excess"] > 1.0:
                raise AssertionError(f"LM_TRAIN_TP {key} rank {r}: the "
                                     f"parameters {rec['param_diff']:.2e} "
                                     f"off, {rec['param_excess']:.2f} x the "
                                     f"bound")
            if len(rec["held_bytes"]) != 1 or \
                    abs(gib(rec["held_bytes"][0]) - predicted) > 5e-4 or \
                    not rec["blocks"] or \
                    rec.get("recurrent_blocks", 1) == 0:
                raise AssertionError(f"LM_TRAIN_TP {key} rank {r}: state "
                                     f"{rec['held_bytes']} B, predicted "
                                     f"{predicted} GiB; {rec['blocks']} "
                                     f"blocks, {rec.get('recurrent_blocks')}"
                                     f" of them recurrent")
            for i, (crd, peer) in enumerate(zip(rec["data"], rec["sum"])):
                first = next(p for p in res if p["data"][i] == crd)
                if peer != first["sum"][i]:
                    raise AssertionError(f"LM_TRAIN_TP {key} rank {r} step "
                                         f"{i}: its whole leaves differ "
                                         f"from its \"data\" coordinate's")
            if rec["whole_sum"] != res[0]["whole_sum"]:
                raise AssertionError(f"LM_TRAIN_TP {key} rank {r}: its "
                                     f"gathered parameters differ")
        col = lambda k: [max(rec[k][i] for rec in res)
                         for i in range(len(res[0][k]))]
        ms, ar = col("ms"), col("tp_all_reduce_ms")
        tp = [a + g + rs for a, g, rs in zip(ar, col("tp_gather_ms"),
                                             col("tp_reduce_scatter_ms"))]
        recurrent = ("" if "recurrent_blocks" not in res[0] else
                     f", {res[0]['recurrent_blocks']} of them in the "
                     f"SSM or RG-LRU layers")
        print(f"LM_TRAIN_TP {arch} ({cut}), global batch {b} x "
              f"seq {s}, mesh {shape} (\"data\", \"model\"), "
              f"{res[0]['blocks']} leaves held as blocks over \"model\" "
              f"({what}{recurrent}): state a rank (parameters, two moments)"
              f" {gib(res[0]['held_bytes'][0]):.6f} GiB against the "
              f"prediction {predicted:.3f} GiB (the reference layout's), "
              f"whole {gib(12 * c.n_params()):.3f} GiB; losses "
              f"{[round(x, 6) for x in res[0]['loss']]} within "
              f"{max(abs(g - w) / abs(w) for g, w in zip(res[0]['loss'], losses)):.2e}"
              f" of the one process's (tolerance {LM_TM_LOSS_TOL:.0e}); "
              f"the first step's gradient blocks within "
              f"{max(rec['grad'][0] for rec in res):.2e} (worst leaf "
              f"{max(rec['grad'] for rec in res)[1]}, tolerance "
              f"{LM_TM_GRAD_TOL:.0e}); the parameters after {steps} "
              f"step{'s' if steps > 1 else ''} within "
              f"{max(rec['param_diff'] for rec in res):.2e} "
              f"({max(rec['param_excess'] for rec in res):.3f} x the bound "
              f"{LM_TM_RTOL:.0e} |p| + {LM_TM_ATOL:.0e}); ms a step "
              f"{[round(x, 1) for x in ms]} (the slowest rank; the first "
              f"with its gradient check, {max(rec['grad'][2] for rec in res):.1f}"
              f" ms) against one process "
              f"{[round(x, 1) for x in ref_ms[:steps]]}; the "
              f"tensor-parallel collectives over \"model\" (all-reduces "
              f"{[round(x, 1) for x in ar]} ms, all-gathers "
              f"{[round(x, 1) for x in col('tp_gather_ms')]} ms, "
              f"reduce-scatters "
              f"{[round(x, 1) for x in col('tp_reduce_scatter_ms')]} ms; "
              f"gloo, host-staged, the card synchronised around each) "
              f"{[f'{a / t:.1%}' for a, t in zip(tp, ms)]} of the step; "
              f"the FSDP gathers and reduce-scatters "
              f"{[round(a + g, 1) for a, g in zip(col('gather_ms'), col('reduce_scatter_ms'))]}"
              f" ms; the gradient reduction "
              f"{[round(x, 1) for x in col('grad_reduce_ms')]} ms; peak "
              f"memory_allocated {max(col('peak_gib')):.3f} GiB (the "
              f"largest rank), one process {ref_peak:.3f} GiB; card: {smi}")


# the dry-run phase (8h): the CLI's cells on fake ranks, and the
# flups-poisson cell's solver at DRY_N on the card
DRY_CELLS = (
    ("decode", ["--arch", "qwen3-0.6b", "--shape", "decode_32k",
                "--mesh", "single"]),
    ("poisson", ["--arch", "flups-poisson", "--mesh", "both"]),
    ("moe", ["--arch", "moonshot-v1-16b-a3b", "--shape", "train_4k",
             "--mesh", "single"]),
    ("ssm", ["--arch", "mamba2-2.7b", "--shape", "decode_32k",
             "--mesh", "single"]),
    ("hybrid", ["--arch", "recurrentgemma-9b", "--shape", "decode_32k",
                "--mesh", "single"]),
)
# the cells whose arguments a rank holds must be exactly the reference
# layout's bytes: the decode cells (parameters by the training layout
# rule, the caches by cache_specs)
DRY_EXACT = ("decode", "ssm", "hybrid")
DRY_N = 256
DRY_TIMEOUT_S = 240
# the measured rates: a bf16 matmul of this size cubed, a copy this long
DRY_MATMUL_N = 8192
DRY_COPY_BYTES = 2 ** 30
# the flups-poisson cell at DRY_N on a fake (1, 1) mesh, engine "cuda"
_DRY_ONE_RANK = r"""
import json
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
from repro_torch.core.comm import CommConfig
from repro_torch.launch.dryrun import run_cell
from repro_torch.launch.mesh import make_local_mesh
rec = run_cell("flups-poisson", "solve", make_local_mesh(1, 1), CommConfig(),
               extra_cfg={"n": %d, "engine": "cuda"})
print("RESULT " + json.dumps(rec))
"""


def _dryrun_phase(dev, smi, run_counted, lm_ms):
    """Phase 8h: the dry run.  Raises on the first failed check; prints
    the numbers (the measured rates are printed, not held)."""
    import dataclasses
    import os
    import tempfile

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import ShapeSpec
    from repro_torch.configs.flups_poisson import CONFIG
    from repro_torch.core.comm import CommConfig
    from repro_torch.distributed.pencil import DistributedPoissonSolver
    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch.cells import build_cell
    from repro_torch.launch.flops_probe import measure

    t0 = time.perf_counter()
    out_dir = tempfile.TemporaryDirectory()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    procs = {tag: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *argv,
         "--out", out_dir.name, "--tag", tag], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for tag, argv in DRY_CELLS}
    procs["one_rank"] = subprocess.Popen(
        [sys.executable, "-c", _DRY_ONE_RANK % DRY_N], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    # -- (b) the flups-poisson cell's solver on a one-rank NCCL mesh ------
    tmp = tempfile.TemporaryDirectory()
    dist.init_process_group(
        DIST_BACKEND, init_method=f"file://{tmp.name}/dryrun", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    mesh = init_device_mesh(dev.type, (1, 1),
                            mesh_dim_names=("data", "model"))
    cfg = dataclasses.replace(CONFIG, n=DRY_N)
    kw = dict(layout=cfg.layout, green_kind=cfg.green, mesh=mesh,
              comm=CommConfig(cfg.comm, cfg.comm_chunks),
              dtype=torch.float32, device=dev, doubling=cfg.doubling,
              relayout=cfg.relayout)
    t1 = time.perf_counter()
    sc = DistributedPoissonSolver((DRY_N,) * 3, 1.0, cfg.bcs, engine="cuda",
                                  **kw)
    st = DistributedPoissonSolver((DRY_N,) * 3, 1.0, cfg.bcs,
                                  engine="torch", _green_cache=sc._green_raw,
                                  **kw)
    green_s = time.perf_counter() - t1
    gen = torch.Generator(device=dev).manual_seed(8)
    f = torch.randn((cfg.batch,) + tuple(sc.input_shape), generator=gen,
                    device=dev)
    x = sc.shard_input(f)
    y, counts = run_counted("DRY_POISSON", lambda: sc.solve_local(x))
    want = st.solve_local(x)
    torch.cuda.synchronize()
    rel = ((y - want).abs().max() / want.abs().max()).item()
    if not torch.isfinite(y).all() or y.shape != want.shape or rel > 1e-5:
        raise AssertionError(f"DRY_POISSON: cuda vs torch {rel:.3e} "
                             f"(shape {tuple(y.shape)})")
    times = []
    for _ in range(REPS + 2):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        sc.solve_local(x)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    solve_ms = statistics.median(times[2:])
    del sc, st, f, x, y, want
    dist.destroy_process_group()
    tmp.cleanup()

    # -- (c) measured rates beside the data sheet's -----------------------
    def event_ms(fn, reps=10):
        fn()
        ts = []
        for _ in range(reps):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            fn()
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b))
        return statistics.median(ts)

    m = DRY_MATMUL_N
    ma = torch.randn((m, m), device=dev, dtype=torch.bfloat16)
    mb = torch.randn((m, m), device=dev, dtype=torch.bfloat16)
    mm_rate = 2 * m ** 3 / (event_ms(lambda: ma @ mb) / 1e3)
    del ma, mb
    src = torch.empty(DRY_COPY_BYTES, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    copy_rate = 2 * src.numel() / (event_ms(lambda: dst.copy_(src)) / 1e3)
    del src, dst
    torch.cuda.empty_cache()
    # phase 8e's step (qwen3-0.6b, batch LM_BATCH x LM_SEQ, one process)
    step = build_cell(LM_ARCH, ShapeSpec("phase_8e", LM_SEQ, LM_BATCH,
                                         "train"), None, device=dev.type)
    with step.mode:
        counted = measure(step.fn, *step.args)
    step_flops = counted.flops + counted.fft_flops
    remat = step.args[0].params.cfg.remat
    del step, counted

    # -- (a) the CLI's records --------------------------------------------
    recs, one = [], None
    for tag, p in procs.items():
        try:
            stdout, stderr = p.communicate(timeout=max(
                1.0, DRY_TIMEOUT_S - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            for q in procs.values():
                q.kill()
                q.communicate()
            raise AssertionError(f"DRY {tag}: no result within "
                                 f"{DRY_TIMEOUT_S} s")
        if p.returncode != 0:
            raise AssertionError(f"DRY {tag}: exit {p.returncode}\n"
                                 f"{stdout[-1500:]}\n{stderr[-3000:]}")
        if tag == "one_rank":
            one = json.loads(stdout.split("RESULT ", 1)[1])
            continue
        with open(os.path.join(out_dir.name, tag + ".jsonl")) as fh:
            recs += [(tag, json.loads(line)) for line in fh if line.strip()]
    out_dir.cleanup()
    if len(recs) != 6:
        raise AssertionError(f"DRY: {len(recs)} records, expected 6")
    for tag, r in recs:
        where = dict(r.get("mesh", []))
        label = f"{r['arch']}/{r['shape']} on {tuple(where.values())}"
        if r["status"] != "ok":
            raise AssertionError(f"DRY {label}: {r.get('error')}\n"
                                 f"{r.get('trace', '')}")
        mem, cost, rf = r["memory"], r["cost"], r["roofline"]
        if tag in DRY_EXACT and mem["argument_size_in_bytes"] != \
                mem["spec_argument_size_in_bytes"]:
            raise AssertionError(f"DRY {label}: a rank holds "
                                 f"{mem['argument_size_in_bytes']} B of "
                                 f"arguments, the reference's layout "
                                 f"{mem['spec_argument_size_in_bytes']} B")
        print(f"DRY {label}: ok, n_chips {r['n_chips']}, "
              f"{cost['flops']:.4e} FLOP/rank, collectives "
              f"{cost['coll_bytes'] / 1e9:.4f} GB/rank in "
              f"{int(cost['coll_count'])}, arguments "
              f"{mem['argument_size_in_bytes'] / 1e9:.3f} GB/rank held "
              f"({mem['spec_argument_size_in_bytes'] / 1e9:.3f} in the "
              f"reference's layout), temp "
              f"{mem['temp_size_in_bytes'] / 1e9:.3f} GB/rank; roofline "
              f"compute {rf['t_compute_s']:.4e} s, memory "
              f"{rf['t_memory_s']:.4e} s, collective "
              f"{rf['t_collective_s']:.4e} s: {rf['dominant']}; traced in "
              f"{r['t_lower_s']} s")
    launched = {k: v for k, v in counts.items() if v}
    if one["kernels"] != launched:
        raise AssertionError(f"DRY_POISSON: the dry run counts kernel calls "
                             f"{one['kernels']}, the card launched {counts}")
    rf = one["roofline"]
    bound_ms = max(rf["t_compute_s"], rf["t_memory_s"]) * 1e3
    print(f"DRY_POISSON flups-poisson n={DRY_N} NODE (U,U,U) CHAT2, in-block "
          f"batch {cfg.batch}, float32, one-rank {DIST_BACKEND} mesh (1, 1): "
          f"engine cuda within {rel:.3e} of engine torch; launches "
          f"{launched} (the dry run's kernel calls {one['kernels']}); "
          f"median of {REPS} event-timed "
          f"solve_local {solve_ms:.3f} ms against the dry run's "
          f"t_compute_s {rf['t_compute_s'] * 1e3:.4f} ms and t_memory_s "
          f"{rf['t_memory_s'] * 1e3:.4f} ms (the larger "
          f"{bound_ms / solve_ms:.1%} of the solve); host Green assembly {green_s:.1f} s; card: {smi}")
    print(f"DRY rates: bf16 matmul {m}^3 {mm_rate / 1e12:.1f} TFLOP/s "
          f"against PEAK_FLOPS_BF16 {lmesh.PEAK_FLOPS_BF16 / 1e12:.0f} "
          f"({mm_rate / lmesh.PEAK_FLOPS_BF16:.1%}); device-to-device copy "
          f"of {DRY_COPY_BYTES / 2 ** 30:g} GiB {copy_rate / 1e12:.3f} TB/s "
          f"(read + write) against "
          f"HBM_BW {lmesh.HBM_BW / 1e12:.2f} "
          f"({copy_rate / lmesh.HBM_BW:.1%}); NVLINK_BW and INTER_NODE_BW "
          f"not measured (one card); card: {smi}")
    print(f"DRY step: flops_probe counts phase 8e's {LM_ARCH} step "
          f"(batch {LM_BATCH} x seq {LM_SEQ}, remat {remat!r}: its "
          f"recomputed forward counted) at "
          f"{step_flops / 1e12:.3f} TFLOP; at the measured "
          f"{lm_ms:.1f} ms/step that is {step_flops / lm_ms / 1e9:.1f} "
          f"TFLOP/s, {step_flops / lm_ms * 1e3 / lmesh.PEAK_FLOPS_BF16:.1%}"
          f" of PEAK_FLOPS_BF16; card: {smi}")
    print(f"dry-run phase: {time.perf_counter() - t0:.1f} s; card: {smi}")


# the bytes of host Green's functions the run keeps for sharing
GREEN_KEEP_BYTES = 16 * 2 ** 30


class _GreenMemo:
    """The run's host Green's function assemblies, shared by plan: once
    installed, ``solver.build_green`` and the names ``pencil`` and
    ``biot_savart`` import it under are this memo, so that a phase that
    builds a plan an earlier phase built takes its array (phase 6's
    BS_UUU phase 4's (U,U,U) 256^3 plan, the dry run's flups-poisson cell
    the launcher's NODE (U,U,U) 256^3 one).  The array depends on the
    plan alone; no consumer writes into it.  At most
    ``GREEN_KEEP_BYTES`` are kept, the least recently used dropped
    first.  Spawned ranks build their own."""

    def __init__(self):
        self.kept = collections.OrderedDict()
        self.made = self.shared = 0
        self.seconds = 0.0
        self._mark = (0, 0, 0.0)
        self.build = None

    def install(self):
        from repro_torch.core import biot_savart, solver
        from repro_torch.distributed import pencil
        self.build = solver.build_green
        for mod in (solver, pencil, biot_savart):
            mod.build_green = self

    def __call__(self, plan):
        g = self.kept.get(plan)
        if g is not None:
            self.kept.move_to_end(plan)
            self.shared += 1
            return g
        t = time.perf_counter()
        g = self.build(plan)
        self.seconds += time.perf_counter() - t
        self.made += 1
        self.kept[plan] = g
        while len(self.kept) > 1 and sum(
                a.nbytes for a in self.kept.values()) > GREEN_KEEP_BYTES:
            self.kept.popitem(last=False)
        return g

    def report(self) -> str:
        """The assemblies made and shared since the last report, as a
        phase line's tail ("" where there were none)."""
        made, shared, secs = (self.made - self._mark[0],
                              self.shared - self._mark[1],
                              self.seconds - self._mark[2])
        self._mark = (self.made, self.shared, self.seconds)
        if not made and not shared:
            return ""
        return (f" (host Green assemblies: {made} made in {secs:.1f} s, "
                f"{shared} shared)")


def _rate(table, name, default):
    for key, v in table.items():
        if key in name:
            return v
    return default


def main() -> int:
    t_start = time.perf_counter()
    clock = [t_start, None]
    greens = _GreenMemo()

    def phase(name):
        """Prints the seconds of the phase before, with its host Green
        assemblies, on a line of its own, and starts phase ``name``'s
        (None: the last has ended)."""
        now = time.perf_counter()
        if clock[1] is not None:
            print(f"phase {clock[1]}: {now - clock[0]:.1f} s"
                  f"{greens.report()}")
        clock[:] = [now, name]
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke.py: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: torch finds no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.core import transforms
    from repro_torch.core.bc import BCType, DataLayout
    from repro_torch.core.green import GreenKind
    from repro_torch.core.solver import PoissonSolver
    from repro_torch.kernels import (LAUNCHES, TWO_PASS, _build, ops, ref,
                                     reset_launches)
    from repro_torch.kernels._build import CLUSTER
    from repro_torch.kernels.fft_stockham import (ONE_PASS_N, fft_stockham,
                                                  fft_stockham_scale,
                                                  fft_stockham_twiddle, path)
    from repro_torch.kernels.spectral_scale import spectral_scale
    from repro_torch.kernels.twiddle_pack import twiddle_pack
    greens.install()
    wrappers = {"fft_stockham": fft_stockham,
                "fft_stockham_scale": fft_stockham_scale,
                "spectral_scale": spectral_scale,
                "twiddle_pack": twiddle_pack,
                "fft_stockham_twiddle": fft_stockham_twiddle}

    dev = torch.device("cuda")
    sync = torch.cuda.synchronize

    # -- 1. the card ------------------------------------------------------
    phase("1")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    hbm = _rate(_HBM, name, 3.35e12)
    peak = {torch.float32: _rate(_PEAK_F32, name, 67e12),
            torch.float64: _rate(_PEAK_F64, name, 34e12)}
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}; bound rates: HBM "
          f"{hbm / 1e12} TB/s, fp32 {peak[torch.float32] / 1e12} TFLOP/s, "
          f"fp64 {peak[torch.float64] / 1e12} TFLOP/s")

    # -- 2. build -----------------------------------------------------------
    phase("2")
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    print(f"build: {lib_path.name} in {time.perf_counter() - t0:.2f} s")
    # ptxas's registers and spills of each kernel instantiation, under
    # its demangled name where c++filt is there to demangle it
    cxxfilt = shutil.which("c++filt")
    for line in "\n".join(_build.BUILD_LOG).splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
            if cxxfilt:
                fn = subprocess.run([cxxfilt, fn], capture_output=True,
                                    text=True).stdout.strip()
                m = re.search(r"(\w+<[^()]*>)\(", fn)
                fn = m.group(1) if m else fn
            print(f"  {fn}:")
        elif "registers" in line or "spill" in line or line.startswith("=="):
            print(f"  {line.strip()}")

    gen = torch.Generator(device="cpu").manual_seed(0)

    def randn(shape, dtype):
        """Seeded standard normals on the card (complex: both parts)."""
        if dtype.is_complex:
            rdt = torch.float64 if dtype == torch.complex128 else \
                torch.float32
            re = torch.randn(shape, generator=gen, dtype=rdt)
            im = torch.randn(shape, generator=gen, dtype=rdt)
            return torch.complex(re, im).to(dev)
        return torch.randn(shape, generator=gen, dtype=dtype).to(dev)

    errs = {k: 0.0 for k in LAUNCHES}

    def hold(kname, got, want, rtol, atol):
        """Kernel result against the plain version, |d| <= atol+rtol|w|."""
        sync()
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"{kname}: {tuple(got.shape)} {got.dtype} "
                                 f"vs {tuple(want.shape)} {want.dtype}")
        d = (got - want).abs()
        if not torch.isfinite(got).all():
            raise AssertionError(f"{kname}: non-finite output")
        bad = d > atol + rtol * want.abs()
        if bad.any():
            raise AssertionError(f"{kname}: max |err| {d.max().item():.3e} "
                                 f"beyond atol {atol:.1e} + rtol {rtol:.0e}")
        errs[kname] = max(errs[kname], d.max().item())
        return d.max().item()

    def fft_tol(dtype, n):
        if dtype in (torch.float64, torch.complex128):
            return 1e-10, 1e-10 * math.sqrt(n)
        return 1e-4, 1e-3 * math.sqrt(n)

    def scale_tol(dtype):
        if dtype in (torch.float64, torch.complex128):
            return 1e-10, 1e-12
        return 2e-6, 1e-6

    # -- 3. kernels against their plain versions -------------------------
    phase("3")
    t0 = time.perf_counter()
    checks = 0
    for rdt, cdt in ((torch.float32, torch.complex64),
                     (torch.float64, torch.complex128)):
        # every one-pass length, each pass radix the register core takes
        for n in [2 ** e for e in range(1, 13)]:
            rtol, atol = fft_tol(rdt, n)
            for radix in (2, 4):
                for batch in (1, 13):
                    cases = [
                        dict(x=randn((batch, n), cdt)),
                        dict(x=randn((batch, n), cdt), inverse=True),
                        dict(x=randn((batch, n // 2), cdt), pad_to=n),
                        dict(x=randn((batch, n // 2), rdt), pad_to=n,
                             keep=n // 2 + 1),
                        dict(x=randn((batch, n), rdt), keep=n // 2 + 1),
                        dict(x=randn((batch, n), cdt), inverse=True,
                             keep=max(1, n // 2)),
                    ]
                    for kw in cases:
                        x = kw.pop("x")
                        hold("fft_stockham",
                             fft_stockham(x, max_radix=radix, **kw),
                             ref.fft_stockham(x, max_radix=radix, **kw),
                             rtol, atol)
                        checks += 1
                    # the Green epilogue: every bin, the rfft half
                    # spectrum, and start 1 with an odd k
                    for pad, rows, grows, start, k in (
                            (None, 2 * batch, batch, 0, n),
                            (n, 2 * batch, batch, 0, n // 2 + 1),
                            (None, batch, 1, 1, n - 1),
                            (n, batch, batch, 1, n // 2 + 1)):
                        if start + k > n:
                            continue
                        x = randn((rows, n // 2 if pad else n), cdt)
                        g = randn((grows, k), rdt)
                        hold("fft_stockham_scale",
                             fft_stockham_scale(x, g, start=start,
                                                pad_to=pad, max_radix=radix),
                             ref.fft_stockham_scale(x, g, start=start,
                                                    pad_to=pad,
                                                    max_radix=radix),
                             rtol, atol)
                        checks += 1
                    # the twiddle epilogue: every bin, the DCT-II [0, N/2),
                    # DCT-I [0, N/2+1), DST-II [1, N/2+1) windows and one
                    # past the Nyquist bin (start 1, odd k)
                    for start, k in ((0, n), (0, n // 2), (0, n // 2 + 1),
                                     (1, n // 2), (1, n // 2 + 1)):
                        if start + k > n:
                            continue
                        a, b = randn((k,), rdt), randn((k,), rdt)
                        for pad in (None, n):
                            x = randn((batch, n // 2 if pad else n), rdt)
                            kw = dict(start=start, pad_to=pad,
                                      max_radix=radix)
                            hold("fft_stockham_twiddle",
                                 fft_stockham_twiddle(x, a, b, **kw),
                                 ref.fft_stockham_twiddle(x, a, b, **kw),
                                 rtol, atol)
                            checks += 1
        # inputs whose base address is not 16-byte aligned (contiguous
        # views one element into a buffer; a complex128 element is 16
        # bytes, so only its float64 view can be): the kernel reads them
        # in place, and the call launches it
        for dt, n, kw in ((cdt, 4096, {}), (cdt, 512, dict(pad_to=1024)),
                          (rdt, 4096, dict(keep=2049)),
                          (rdt, 512, dict(pad_to=1024, keep=513))):
            x = randn((13 * n + 1,), dt)[1:].view(13, n)
            before = LAUNCHES["fft_stockham"]
            got = fft_stockham(x, **kw)
            launched = LAUNCHES["fft_stockham"] - before
            if (x.element_size() < 16 and x.data_ptr() % 16 == 0
                    or launched != 1):
                raise AssertionError(f"misaligned {dt} N={n}: address "
                                     f"{x.data_ptr() % 16} mod 16, "
                                     f"launches {launched}")
            hold("fft_stockham", got, ref.fft_stockham(x, **kw),
                 *fft_tol(rdt, kw.get("pad_to", n)))
            checks += 1
        x = randn((13 * 1024 + 1,), rdt)[1:].view(13, 1024)
        a, b = randn((513,), rdt), randn((513,), rdt)
        hold("fft_stockham_twiddle", fft_stockham_twiddle(x, a, b),
             ref.fft_stockham_twiddle(x, a, b), *fft_tol(rdt, 1024))
        checks += 1
        # the short rows (2 to 128 points) on row counts that are no
        # multiple of a row-block's rows and span many persistent blocks:
        # every mode, the Green plane of the main path (a row each) and a
        # shared one, the DCT-II and DST-II windows, radix 2, and inputs
        # one element off 16-byte alignment (complex64 and real)
        t_s, checks_s = time.perf_counter(), checks
        for n in (2, 4, 8, 16, 32, 64, 128):
            rtol, atol = fft_tol(rdt, n)
            h = max(n // 2, 1)
            for rows in (257, 30001):
                cases = [
                    dict(x=randn((rows, n), cdt)),
                    dict(x=randn((rows, n), cdt), inverse=True),
                    dict(x=randn((rows, h), cdt), pad_to=n),
                    dict(x=randn((rows, n), cdt), inverse=True, keep=h),
                    dict(x=randn((rows, h), rdt), pad_to=n, keep=h + 1),
                    dict(x=randn((rows, n), rdt), keep=h + 1),
                    dict(x=randn((rows, n), cdt), max_radix=2),
                    dict(x=randn((rows * h + 1,), rdt)[1:].view(rows, h),
                         pad_to=n, keep=h + 1),
                ]
                if rdt == torch.float32:
                    cases.append(dict(x=randn((rows * n + 1,), cdt)[1:]
                                      .view(rows, n)))
                for kw in cases:
                    x = kw.pop("x")
                    hold("fft_stockham", fft_stockham(x, **kw),
                         ref.fft_stockham(x, **kw), rtol, atol)
                    checks += 1
                for pad, grows, start, k in ((n, rows, 0, h + 1),
                                             (None, 1, 1, n - 1)):
                    if k < 1:
                        continue
                    x = randn((rows, n // 2 if pad else n), cdt)
                    g = randn((grows, k), rdt)
                    hold("fft_stockham_scale",
                         fft_stockham_scale(x, g, start=start, pad_to=pad),
                         ref.fft_stockham_scale(x, g, start=start,
                                                pad_to=pad), rtol, atol)
                    checks += 1
                for pad, start, k in ((n, 0, h), (None, 1, h)):
                    a, b = randn((k,), rdt), randn((k,), rdt)
                    x = randn((rows, n // 2 if pad else n), rdt)
                    hold("fft_stockham_twiddle",
                         fft_stockham_twiddle(x, a, b, start=start,
                                              pad_to=pad),
                         ref.fft_stockham_twiddle(x, a, b, start=start,
                                                  pad_to=pad), rtol, atol)
                    checks += 1
        print(f"  short rows {rdt}: {checks - checks_s} checks (2 to 128 "
              f"points, 257 and 30001 rows) in "
              f"{time.perf_counter() - t_s:.2f} s")
        # rows above ONE_PASS_N points: on a cluster up to 65536, in two
        # passes above (2^20 in float32 at batch 1); the largest error per
        # length, against the spectrum's largest value, and the path each
        # call took
        for n in (8192, 16384, 32768, 65536, 2 ** 17, 2 ** 20):
            if n == 2 ** 20 and rdt == torch.float64:
                continue
            batches = (1,) if n == 2 ** 20 else (1, 13)
            b = batches[-1]
            rtol, atol = fft_tol(rdt, n)
            worst = [0.0, 0.0]
            t_n = time.perf_counter()
            reset_launches()

            def hold2(kname, got, want):
                d = hold(kname, got, want, rtol, atol)
                if d >= worst[0]:
                    worst[:] = [d, want.abs().max().item()]
            for radix in (2, 4):
                for batch in batches:
                    cases = [
                        dict(x=randn((batch, n), cdt)),
                        dict(x=randn((batch, n), cdt), inverse=True),
                        dict(x=randn((batch, n // 2), cdt), pad_to=n),
                        dict(x=randn((batch, n // 2), rdt), pad_to=n,
                             keep=n // 2 + 1),
                        dict(x=randn((batch, n), rdt), keep=n // 2 + 1),
                        dict(x=randn((batch, n), cdt), inverse=True,
                             keep=n // 2),
                    ]
                    for kw in cases:
                        x = kw.pop("x")
                        hold2("fft_stockham",
                              fft_stockham(x, max_radix=radix, **kw),
                              ref.fft_stockham(x, max_radix=radix, **kw))
                        checks += 1
                for pad, rows, grows, start, k in (
                        (None, 2 * b, b, 0, n), (n, 2 * b, b, 0, n // 2 + 1),
                        (None, b, 1, 1, n - 1),
                        (n, b, b, 1, n // 2 + 1)):
                    x = randn((rows, n // 2 if pad else n), cdt)
                    g = randn((grows, k), rdt)
                    hold2("fft_stockham_scale",
                          fft_stockham_scale(x, g, start=start, pad_to=pad,
                                             max_radix=radix),
                          ref.fft_stockham_scale(x, g, start=start,
                                                 pad_to=pad,
                                                 max_radix=radix))
                    checks += 1
                for start, k in ((0, n // 2), (0, n // 2 + 1), (1, n // 2),
                                 (1, n // 2 + 1)):
                    ta, tb = randn((k,), rdt), randn((k,), rdt)
                    for pad in (None, n):
                        for batch in batches:
                            x = randn((batch, n // 2 if pad else n), rdt)
                            kw = dict(start=start, pad_to=pad,
                                      max_radix=radix)
                            hold2("fft_stockham_twiddle",
                                  fft_stockham_twiddle(x, ta, tb, **kw),
                                  ref.fft_stockham_twiddle(x, ta, tb, **kw))
                            checks += 1
            took = {"cluster": sum(CLUSTER.values()),
                    "two_pass": sum(TWO_PASS.values())}
            if took[path(n)] != sum(LAUNCHES.values()):
                raise AssertionError(f"N={n}: {dict(LAUNCHES)} launches, "
                                     f"{took} by tier; {path(n)} expected")
            print(f"  {path(n)} {rdt} N={n}: max |err| {worst[0]:.3e} "
                  f"against a largest |value| {worst[1]:.3e}; "
                  f"{took[path(n)]} calls, all {path(n)}, in "
                  f"{time.perf_counter() - t_n:.2f} s")
        # the longest row the kernel takes: 4096-point column FFTs, one or
        # two columns per block
        x = randn((1, 2 ** 24), cdt)
        d = hold("fft_stockham", fft_stockham(x), ref.fft_stockham(x),
                 *fft_tol(rdt, 2 ** 24))
        print(f"  {path(2 ** 24)} {rdt} N={2 ** 24}: max |err| {d:.3e}")
        checks += 1
        del x
        for shape in ((8, 128), (7, 130), (129, 384), (3, 16, 256),
                      (2, 129, 384), (1, 7, 130), (3, 7, 130),
                      (1, 129, 384), (3, 129, 384)):
            g = randn(shape[-2:], rdt)
            for dt in (rdt, cdt):
                x = randn(shape, dt)
                hold("spectral_scale", spectral_scale(x, g, 0.37),
                     ref.spectral_scale(x, g, 0.37), *scale_tol(rdt))
                checks += 1
        # contiguous, then the DCT-II / DST-II windows [0, 384) and
        # [1, 385) of the 385-bin half spectrum of the 384^3 path's
        # length-768 rfft, read in place at row pitch 385
        packs = [randn(shape, cdt) for shape in ((8, 128), (64, 257),
                                                 (5, 96))]
        half = randn((384 * 384, 385), cdt)
        packs += [half[:, :384], half[:, 1:]]
        for x in packs:
            a, b = randn((x.shape[1],), rdt), randn((x.shape[1],), rdt)
            hold("twiddle_pack", twiddle_pack(x, a, b),
                 ref.twiddle_pack(x, a, b), *scale_tol(rdt))
            checks += 1
        del half, packs
    # an absolute reference: the cluster and two-pass paths against cuFFT
    # in float64
    for n in (16384, 65536, 2 ** 17):
        x = randn((1, n), torch.complex128)
        d = hold("fft_stockham", fft_stockham(x), torch.fft.fft(x),
                 *fft_tol(torch.float64, n))
        print(f"  {path(n)} float64 N={n} against torch.fft.fft: max |err| "
              f"{d:.3e}")
        checks += 1
    print(f"phase 3, kernels vs plain versions: {checks} checks passed in "
          f"{time.perf_counter() - t0:.2f} s; max |err| "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))

    # -- 4. main path ---------------------------------------------------------
    phase("4")
    U = (BCType.UNB, BCType.UNB)
    P = (BCType.PER, BCType.PER)
    E, O = BCType.EVEN, BCType.ODD
    # case: (bcs, cells per direction (or per axis), batch)
    runs = {
        "UUU": ((U, U, U), N, None),
        "UPU": ((U, P, U), N // 2, None),
        "PPP": ((P, P, P), N, None),
        "UUU_B2": ((U, U, U), N // 2, 2),
        "SEMI_E": (((BCType.UNB, E), U, U), N, None),
        "SEMI_O": ((U, U, (O, BCType.UNB)), N // 2, None),
        "SYM384": (((E, E), (O, O), (E, O)), 384, None),
        # elongated domains: a free-space jet or wake (16.7 M cells, the
        # doubled volume of (U,U,U) 256^3) and a wall with free space
        # beside it, resolved finely wall-normal
        "LONG_UUU": ((U, U, U), (4096, 64, 64), None),
        "LONG_SEMI": (((BCType.UNB, E), U, U), (2048, 64, 64), None),
        # longer jets and wakes: x directions of 32768 and 65536 cells,
        # whose pruned forwards take 65536 points (a 16-block cluster) and
        # 131072 points (two passes)
        "LONG_XL_UUU": ((U, U, U), (32768, 16, 16), None),
        "LONG_XXL_UUU": ((U, U, U), (65536, 16, 16), None),
    }
    rng = np.random.default_rng(0)
    solvers = {}
    launches = {}
    # (run, call descriptor) -> calls per solve; a descriptor holds the
    # kernel, x's shape, strides, offset and dtype, the other tensor
    # arguments' shapes and the scalar arguments: what a replay needs
    calls = {}

    def run_counted(run, fn, expected=None):
        """``fn()`` with the launch counts set to 0 just before and read
        just after, each kernel call recorded under ``run``; the counts
        must be EXPECTED[run] exactly (``expected(fn())`` where given: the
        totals of a run of several solves, worked out from what it
        returned), and the cluster and two-pass calls among them
        EXPECTED_CLUSTER[run] and EXPECTED_TWO_PASS[run] (none where the
        run has no entry)."""
        with _recorded(run, calls):
            sync()
            reset_launches()
            out = fn()
            sync()
            counts = dict(LAUNCHES)
            clu = {k: v for k, v in CLUSTER.items() if v}
            two = {k: v for k, v in TWO_PASS.items() if v}
        got = {k: v for k, v in counts.items() if v}
        want = EXPECTED[run] if expected is None else expected(out)
        if got != want:
            raise AssertionError(f"{run}: launches {got}, expected {want}")
        if clu != EXPECTED_CLUSTER.get(run, {}):
            raise AssertionError(f"{run}: cluster calls {clu}, expected "
                                 f"{EXPECTED_CLUSTER.get(run, {})}")
        if two != EXPECTED_TWO_PASS.get(run, {}):
            raise AssertionError(f"{run}: two-pass calls {two}, expected "
                                 f"{EXPECTED_TWO_PASS.get(run, {})}")
        for k, r in TIMED_ON.items():
            if r == run:
                launches[k] = counts[k]
        return out, counts

    def clean(run, *solvers):
        """No retry and no degradation behind a main-path solve: the
        ladder's torch.fft rung must never hide a kernel."""
        for s in solvers:
            if s.stats["degradations"] or s.stats["retries"]:
                raise AssertionError(f"{run}: degradations "
                                     f"{s.stats['degradations']}, retries "
                                     f"{s.stats['retries']}")

    def close(what, u, want, rtol=1e-5):
        """``u`` against ``want``: shape, dtype, finite, within ``rtol`` of
        max |want| relative (the cuda engine's float32 output against the
        torch engine's, a distributed solve against the single-process
        one)."""
        sync()
        if u.shape != want.shape or u.dtype != want.dtype:
            raise AssertionError(f"{what}: output {tuple(u.shape)} {u.dtype}"
                                 f", expected {tuple(want.shape)} "
                                 f"{want.dtype}")
        if not torch.isfinite(u).all():
            raise AssertionError(f"{what}: non-finite solution")
        rel = ((u - want).abs().max() / want.abs().max()).item()
        if rel > rtol:
            raise AssertionError(f"{what}: relative max |diff| {rel:.3e} > "
                                 f"{rtol}")
        return rel

    for case, (bcs, nn, batch) in runs.items():
        t0 = time.perf_counter()
        grid = nn if isinstance(nn, tuple) else (nn,) * 3
        sc = PoissonSolver(grid, 1.0, bcs, engine="cuda", device=dev)
        st = PoissonSolver(grid, 1.0, bcs, engine="torch", device=dev,
                           green=sc._green_nat)
        t_plan = time.perf_counter() - t0
        shape = ((batch,) if batch else ()) + sc.input_shape
        f = torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev)
        u, counts = run_counted(case, lambda: sc.solve(f))
        ut = st.solve(f)
        clean(case, sc, st)
        rel = close(f"{case} cuda vs torch engine", u, ut)
        tag = (f"{case} " + ("x".join(map(str, nn)) if isinstance(nn, tuple)
                             else f"n={nn}")
               + (f" B={batch}" if batch else ""))
        # the directions whose (power-of-two) FFT is longer than one
        # block takes, and the kernel's tier for each
        long_dirs = []
        for d, p in enumerate(sc.plan.dirs):
            nf = (p.n_fft if p.kind is None
                  else transforms.fft_length(p.kind, p.n_fft))
            if transforms._pow2(nf) and nf > ONE_PASS_N:
                long_dirs.append(f"direction {d} ({p.category}, {nf} "
                                 f"points, {path(nf)})")
        print(f"main path {tag}: plan+green {t_plan:.2f} s, launches "
              f"{ {k: v for k, v in counts.items() if v} }, cluster "
              f"{EXPECTED_CLUSTER.get(case, {})}, two-pass "
              f"{EXPECTED_TWO_PASS.get(case, {})} for "
              f"{', '.join(long_dirs) or 'no direction'}, max|u| "
              f"{ut.abs().max().item():.4e}, cuda vs torch engine relative "
              f"max |diff| {rel:.3e}")
        solvers[tag] = (sc, st, f)

    # -- 5. analytic checks (NODE, HEJ4, float64) -----------------------------
    phase("5")
    from scipy.special import erf
    na, L = 64, 1.0
    xs = np.meshgrid(*([np.arange(na + 1) * (L / na)] * 3), indexing="ij")

    def blob_potential(c, s):
        """lap(u) = exp(-|x-c|^2 / (2 s^2)) in free space:
        u = -Q erf(r / (sqrt(2) s)) / (4 pi r), Q = (2 pi)^(3/2) s^3."""
        r = np.sqrt(sum((x - ci) ** 2 for x, ci in zip(xs, c)))
        q = (2.0 * np.pi) ** 1.5 * s ** 3
        rs = np.where(r > 1e-12, r, 1.0)
        u = -q * erf(rs / (np.sqrt(2.0) * s)) / (4.0 * np.pi * rs)
        return np.where(r > 1e-12, u,
                        -q * 2.0 / (np.sqrt(2.0 * np.pi) * s) / (4 * np.pi))

    def analytic(run, bcs, c, s, images, bound):
        rhs = np.exp(-sum((x - ci) ** 2 for x, ci in zip(xs, c))
                     / (2.0 * s * s))
        uref = blob_potential(c, s)
        for ci, sign in images:
            uref = uref + sign * blob_potential(ci, s)
        sq = PoissonSolver((na,) * 3, L, bcs, layout=DataLayout.NODE,
                           green_kind=GreenKind.HEJ4, engine="cuda",
                           device=dev)
        uq, counts = run_counted(run, lambda: sq.solve(rhs))
        clean(run, sq)
        e_inf = np.abs(uq.cpu().numpy() - uref).max() / np.abs(uref).max()
        if not e_inf <= bound:
            raise AssertionError(f"{run} HEJ4 Gaussian: relative E_inf "
                                 f"{e_inf:.4e} > {bound:.4e}")
        print(f"analytic {run} HEJ4 n={na} float64: relative E_inf "
              f"{e_inf:.4e} (bound {bound:.4e}), launches "
              f"{ {k: v for k, v in counts.items() if v} }")

    # the quickstart blob (s = 0.1, the reference's quickstart bound), and
    # the paper's semi-unbounded case: blob s = L/10 at the centre, even
    # end at x = L, exact solution with the image at 2L - 0.5
    analytic("NODE_UUU", (U, U, U), (0.5, 0.5, 0.5), 0.1, (), 2e-2)
    analytic("NODE_SEMI_E", ((BCType.UNB, E), U, U), (0.5, 0.5, 0.5), 0.1,
             (((2.0 * L - 0.5, 0.5, 0.5), 1.0),), 1.5 * SEMI_E_REF_EINF)

    # -- 6. Biot-Savart -------------------------------------------------------
    phase("6")
    from scipy.special import expn
    from repro_torch.core.biot_savart import BiotSavartSolver
    # vorticity BCs bcs[c][d]: the paper's vortex tube (x, y unbounded; z
    # odd for w_x, w_y and even for w_z), and all nine pairs unbounded
    tube = [[U, U, (O, O)], [U, U, (O, O)], [U, U, (E, E)]]
    bs_runs = {"BS_TUBE": (tube, False), "BS_UUU": ([[U, U, U]] * 3, True)}
    for case, (bcs, batched) in bs_runs.items():
        t0 = time.perf_counter()
        bc = BiotSavartSolver((N,) * 3, 1.0, bcs, engine="cuda", device=dev)
        bt = BiotSavartSolver((N,) * 3, 1.0, bcs, engine="torch",
                              device=dev, greens=bc.greens)
        t_plan = time.perf_counter() - t0
        if bc.batched != batched:
            raise AssertionError(f"{case}: batched {bc.batched}")
        f = torch.from_numpy(rng.standard_normal(bc.input_shape).astype(
            np.float32)).to(dev)
        u, counts = run_counted(case, lambda: bc.solve(f))
        rel = close(f"{case} cuda vs torch engine", u, bt.solve(f))
        n_green = len({id(g) for g in bc.greens})
        tag = f"{case} n={N}"
        print(f"biot-savart {tag} ({'batched' if batched else 'sequential'}"
              f"): plan+green {t_plan:.2f} s ({n_green} Green's function"
              f"{'s' if n_green > 1 else ''} in use), launches "
              f"{ {k: v for k, v in counts.items() if v} }, cuda vs torch "
              f"engine relative max |diff| {rel:.3e}")
        solvers[tag] = (bc, bt, f)

    def tube_fields(n, length=1.0):
        """The vortex tube at NODE (tests/test_biot_savart.py): radius
        0.3 L about the z axis through the centre, compact vorticity -w_z
        and its exact azimuthal velocity."""
        rad, e21 = 0.3 * length, expn(2, 1.0)
        x1 = np.arange(n + 1) * (length / n)
        x, y, _ = np.meshgrid(x1, x1, x1, indexing="ij")
        dx, dy = x - 0.5 * length, y - 0.5 * length
        r = np.hypot(dx, dy)
        s2 = (r / rad) ** 2
        inside = s2 < 0.999999
        s2c = np.where(inside, s2, 0.0)
        wz = np.where(inside, (1.0 / (2.0 * np.pi)) * (2.0 / rad ** 2) / e21
                      * np.exp(-1.0 / (1.0 - s2c)), 0.0)
        rs = np.where(r > 1e-12, r, 1.0)
        with np.errstate(over="ignore"):
            arg = 1.0 / np.where(inside, 1.0 - s2c, 1.0)
        bracket = np.where(inside, 1.0 - (1.0 - s2c) * expn(2, arg) / e21,
                           1.0)
        ut = np.where(r > 1e-12, bracket / (2.0 * np.pi * rs), 0.0)
        ux = np.where(r > 1e-12, -dy / rs * ut, 0.0)
        uy = np.where(r > 1e-12, dx / rs * ut, 0.0)
        zero = np.zeros_like(wz)
        return np.stack([zero, zero, -wz]), np.stack([ux, uy, zero])

    f_t, u_exact = tube_fields(na, L)
    sq = BiotSavartSolver((na,) * 3, L, tube, layout=DataLayout.NODE,
                          green_kind=GreenKind.HEJ4, engine="cuda",
                          device=dev)
    uq, counts = run_counted("BS_TUBE_NODE_HEJ4", lambda: sq.solve(f_t))
    linf = np.abs(uq.cpu().numpy() - u_exact).max()
    if not linf <= 1.5 * BS_TUBE_REF_LINF:
        raise AssertionError(f"BS_TUBE_NODE_HEJ4: L_inf {linf:.4e} > "
                             f"{1.5 * BS_TUBE_REF_LINF:.4e}")
    print(f"analytic BS_TUBE_NODE_HEJ4 n={na} float64: velocity L_inf "
          f"{linf:.4e} (reference {BS_TUBE_REF_LINF:.4e}, bound "
          f"{1.5 * BS_TUBE_REF_LINF:.4e}), launches "
          f"{ {k: v for k, v in counts.items() if v} }")
    del sq, uq

    # -- 7. the runtime: plan cache, health guard, degradation ladder --------
    phase("7")
    from repro_torch.core.solver import (clear_solver_cache, get_solver,
                                         solver_cache_info)
    from repro_torch.runtime import faults
    clear_solver_cache()
    ppp = (P, P, P)
    g1 = get_solver((N,) * 3, 1.0, ppp, device=dev)
    g2 = get_solver((N,) * 3, 1.0, ppp, device=dev)
    info = solver_cache_info()
    if g2 is not g1 or info["hits"] != 1 or info["misses"] != 1:
        raise AssertionError(f"get_solver: same instance {g2 is g1}, "
                             f"cache {info}")
    # a smooth periodic field: u = sin(2 pi x) sin(4 pi y) cos(2 pi z)
    xc = (np.arange(N) + 0.5) / N
    xg, yg, zg = np.meshgrid(xc, xc, xc, indexing="ij", sparse=True)
    sol = np.sin(2 * np.pi * xg) * np.sin(4 * np.pi * yg) * \
        np.cos(2 * np.pi * zg)
    rhs = torch.from_numpy((-24.0 * np.pi ** 2 * sol).astype(
        np.float32)).to(dev)
    u1, _ = run_counted("GET_SOLVER", lambda: g1.solve(rhs))
    u2 = g2.solve(rhs)
    clean("GET_SOLVER", g1)
    if not torch.equal(u1, u2):
        raise AssertionError("get_solver: a second solve changed the bits")
    e_sol = np.abs(u1.cpu().numpy() - sol).max() / np.abs(sol).max()
    if not e_sol < 1e-5:
        raise AssertionError(f"(P,P,P) sine field: relative E_inf {e_sol}")
    gv = get_solver((N,) * 3, 1.0, ppp, device=dev, verify="residual")
    uv, _ = run_counted("VERIFY_PPP", lambda: gv.solve(rhs))
    clean("VERIFY_PPP", gv)
    if not torch.equal(uv, u1):
        raise AssertionError("verify='residual' changed the solution")
    res = gv.stats["last_residual"]
    print(f"runtime: get_solver hit (cache {solver_cache_info()}), the same "
          f"bits on a second solve; (P,P,P) n={N} sine field relative "
          f"E_inf {e_sol:.3e}; verify='residual' passed, last_residual "
          f"{res:.4e}")
    # an inf written into the Green stage's input on the cuda engine: the
    # guard trips and the ladder walks one rung, to the torch engine
    sf = PoissonSolver((N,) * 3, 1.0, ppp, engine="cuda", device=dev,
                       verify="residual")
    with faults.FaultPlan([dict(kind="inf", stage="green")]) as plan:
        uf = sf.solve(rhs)
    trail = [d["action"] for d in sf.stats["degradations"]]
    rel = ((uf - u1).abs().max() / u1.abs().max()).item()
    if (not plan.log or trail != ["engine:cuda->torch"]
            or sf.stats["verify_failures"] != 1 or rel > 1e-5):
        raise AssertionError(f"inf at green: fired {plan.log}, trail "
                             f"{trail}, stats {sf.stats}, rel {rel:.3e}")
    print(f"runtime: inf at 'green' fired {len(plan.log)}x, tripped at "
          f"{sf.stats['degradations'][0]['stage']}, trail {trail}, "
          f"within {rel:.3e} of the clean cuda solve")
    # every hand-kernel fail point armed for good (a kernel that cannot
    # be built): the solve degrades to torch.fft and equals its solve
    sl = PoissonSolver((N,) * 3, 1.0, ppp, engine="cuda", device=dev)
    with faults.FaultPlan([dict(kind="pallas_lowering", stage="cuda.*",
                                count=-1)]) as plan:
        ul = sl.solve(rhs)
    trail = [d["action"] for d in sl.stats["degradations"]]
    want = PoissonSolver((N,) * 3, 1.0, ppp, engine="torch", device=dev,
                         green=sl._green_nat).solve(rhs)
    if (trail != ["engine:cuda->torch"] or sl._cfg["engine"] != "torch"
            or not torch.equal(ul, want)):
        raise AssertionError(f"cuda.* fault: trail {trail}, config "
                             f"{sl._cfg}, equal {torch.equal(ul, want)}")
    print(f"runtime: cuda.* build fault fired at {plan.log[0]['stage']}, "
          f"trail {trail}, equal to the torch engine's solve")
    # a kernel that really fails to launch, with no fault armed: the solve
    # raises SolveError and never gives way to torch.fft
    from repro_torch.kernels import ops
    from repro_torch.runtime import SolveError
    sr = PoissonSolver((32,) * 3, 1.0, ppp, engine="cuda", device=dev)
    real_scale = ops.fft_stockham_scale

    def failing_scale(*a, **kw):
        raise RuntimeError("fft_stockham_scale: launch failed")

    ops.fft_stockham_scale = failing_scale
    try:
        sr.solve(torch.ones(sr.input_shape, device=dev))
        raised = None
    except SolveError as e:
        raised = e
    finally:
        ops.fft_stockham_scale = real_scale
    if (raised is None or raised.degradations or sr.stats["degradations"]
            or sr._cfg["engine"] != "cuda"):
        raise AssertionError(f"real launch failure: raised {raised!r}, "
                             f"stats {sr.stats}, config {sr._cfg}")
    print(f"runtime: a real launch failure raised SolveError at stage "
          f"{raised.stage!r}, no rung taken")
    del g1, g2, gv, sf, sl, sr, u1, u2, uv, uf, ul, want, rhs
    clear_solver_cache()

    # -- timing helpers (phases 8 and 9) -------------------------------------
    def time_ms(fn, ahead=False):
        """Median of REPS event-timed calls after 3 warm-up calls.  With
        ``ahead`` the device sleeps about a millisecond before each start
        event, so the host has queued the call when the event fires: the
        time is the call's device time, without the host's launch gap
        (kernel replays).  Without it that gap counts (whole solves)."""
        for _ in range(3):
            fn()
        sync()
        ts = []
        for _ in range(REPS):
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            if ahead:
                torch.cuda._sleep(AHEAD_CYCLES)
            s.record()
            fn()
            e.record()
            e.synchronize()
            ts.append(s.elapsed_time(e))
        return statistics.median(ts)

    def loop_ms(fns):
        """Device time per call of LOOP back-to-back calls between one
        event pair, taking the closures ``fns`` (one per input set) in
        turn and keeping their last outputs alive, so that no call finds
        its operands or its output buffer in L2 from the call before.  The
        device sleeps while the host queues the calls; if it woke before
        they were all queued, the sleep doubles and the loop runs again."""
        kept = collections.deque(maxlen=len(fns))
        for f in fns:
            kept.append(f())
        sync()
        cycles = 20_000_000
        while True:
            torch.cuda._sleep(cycles)
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            for i in range(LOOP):
                kept.append(fns[i % len(fns)]())
            e.record()
            woke = s.query()
            e.synchronize()
            if not woke or cycles >= 320_000_000:
                return s.elapsed_time(e) / LOOP
            cycles *= 2

    def where_the_time_goes(label, fn, solve_ms):
        """Device time by kernel over one profiled solve, and the idle
        share of the (unprofiled, event-timed) solve it leaves; returns
        {device event name: [ms, count]}, None when the profiler saw no
        device activity."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        ffts = ("fft_stockham", "fft_stockham_scale", "fft_stockham_twiddle")
        launched = -sum(LAUNCHES[k] for k in ffts)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            sync()
        launched += sum(LAUNCHES[k] for k in ffts)
        # device-side events only (kernels, copies): the CPU ops that
        # launched them carry the same device time again
        agg = {}
        n_copy = 0
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                a = agg.setdefault(e.name, [0.0, 0])
                a[0] += e.time_range.elapsed_us() / 1e3
                a[1] += 1
            elif e.name == "aten::copy_":
                n_copy += 1
        rows = sorted(((ms, c, k) for k, (ms, c) in agg.items()),
                      reverse=True)
        busy = sum(r[0] for r in rows)
        if busy <= 0:
            print(f"  {label}: device time not measured (the profiler saw "
                  "no device activity)")
            return None
        top = "; ".join(f"{ms:.3f} ms x{c} {k[:60]}"
                        for ms, c, k in rows[:6] if ms > 0)
        # the Stockham kernels' instantiations (one per row length) summed,
        # and how many of them ran the short tier, and the long rows'
        # cluster and column passes
        stock = ("stockham_kernel", "short_kernel", "cluster_kernel",
                 "column_kernel", "row_kernel")
        fft = [(ms, c) for ms, c, k in rows if any(s in k for s in stock)]
        tiers = ", ".join(f"{s} x{sum(c for _, c, k in rows if s in k)}"
                          for s in stock[1:])
        # a Stockham call launches one kernel (two when it takes two
        # passes): fewer kernel events than calls is a profile that lost
        # events, whose times are not the solve's
        seen = sum(c for _, c in fft)
        whole = ("" if seen >= launched else
                 f"INCOMPLETE profile, {seen} of {launched} Stockham calls "
                 "seen: ")
        print(f"  {label}: {whole}device busy {busy:.3f} ms of "
              f"{solve_ms:.3f} ms (idle share "
              f"{max(0.0, 1 - busy / solve_ms):.1%}); Stockham kernels "
              f"{sum(ms for ms, _ in fft):.3f} ms x{seen} ({tiers}); "
              f"aten::copy_ x{n_copy}; {top}")
        return agg

    # -- 7b. ABFT: checked stages and the Freivalds sandwich ---------------
    phase("7b")
    t0 = time.perf_counter()
    sp_uuu, _, f_uuu = solvers[f"UUU n={N}"]
    s_eop = PoissonSolver((N,) * 3, 1.0, ((E, E), (O, E), P),
                          engine="cuda", device=dev)
    f_eop = torch.from_numpy(rng.standard_normal(s_eop.input_shape).astype(
        np.float32)).to(dev)
    abft_ms = {}
    for case, s, f in (("UUU", sp_uuu, f_uuu), ("EOP", s_eop, f_eop)):
        u_off = s.solve(f)
        t1 = time.perf_counter()
        s._lite_pair(f.shape, f.dtype)       # the plan-time weight w
        sync()
        t_w = time.perf_counter() - t1
        u_ab, c_ab = run_counted(f"ABFT_{case}/abft",
                                 lambda: s.solve(f, verify="abft"))
        if not torch.equal(u_ab, u_off):
            raise AssertionError(f"ABFT_{case}: verify='abft' changed the "
                                 "bits of verify=None")
        u_st, c_st = run_counted(f"ABFT_{case}/abft-stages",
                                 lambda: s.solve(f, verify="abft-stages"))
        rel = close(f"ABFT_{case} abft-stages against verify=None", u_st,
                    u_off)
        clean(f"ABFT_{case}", s)
        if s.stats.get("integrity") or s.stats["verify_failures"]:
            raise AssertionError(f"ABFT_{case} clean: {s.stats}")
        t_off = time_ms(lambda: s.solve(f))
        t_ab = time_ms(lambda: s.solve(f, verify="abft"))
        t_st = time_ms(lambda: s.solve(f, verify="abft-stages"))
        abft_ms[case] = (t_off, t_ab, t_st)
        if s.stats.get("integrity") or s.stats["verify_failures"]:
            raise AssertionError(f"ABFT_{case} timed solves: {s.stats}")
        print(f"ABFT_{case} n={N} float32 cuda: w = S^T r built in "
              f"{t_w:.2f} s; verify='abft' the bits of verify=None, "
              f"launches { {k: v for k, v in c_ab.items() if v} }; "
              f"'abft-stages' within {rel:.3e}, launches "
              f"{ {k: v for k, v in c_st.items() if v} }; no integrity "
              f"record; median of {REPS} solves: off {t_off:.3f} ms, abft "
              f"{t_ab:.3f} ms ({t_ab - t_off:+.3f} ms, "
              f"{(t_ab / t_off - 1):+.1%}), abft-stages {t_st:.3f} ms "
              f"({t_st - t_off:+.3f} ms, {(t_st / t_off - 1):+.1%}); card: "
              f"{smi}")
    where_the_time_goes("ABFT_UUU abft-stages",
                        lambda: sp_uuu.solve(f_uuu, verify="abft-stages"),
                        abft_ms["UUU"][2])
    where_the_time_goes("ABFT_UUU abft",
                        lambda: sp_uuu.solve(f_uuu, verify="abft"),
                        abft_ms["UUU"][1])
    # the Green invariant's reference side at the spectral block's shape,
    # against the product block summed
    g_sp = sp_uuu._green_as(torch.float32)
    fh = randn(tuple(g_sp.shape), torch.complex64)
    got, want = ops.green_checksum(fh, g_sp), (fh * g_sp).sum()
    gc_rel = (abs(got - want) / (fh.abs() * g_sp).sum()).item()
    t_gc = time_ms(lambda: ops.green_checksum(fh, g_sp), ahead=True)
    t_gp = time_ms(lambda: (fh * g_sp).sum(), ahead=True)
    nb = fh.numel() * fh.element_size() + g_sp.numel() * 4
    print(f"green_checksum at {tuple(fh.shape)} complex64: {t_gc:.4f} ms "
          f"(product-then-sum {t_gp:.4f} ms; bytes bound "
          f"{1e3 * nb / hbm:.4f} ms for {nb / 2 ** 20:.1f} MiB), "
          f"relative difference {gc_rel:.2e}")
    if gc_rel > 1e-5:
        raise AssertionError(f"green_checksum: {gc_rel:.3e}")
    del fh, g_sp
    # the detection matrix: one flip (count=1) per stage under
    # "abft-stages", each detected, attributed to its stage and repaired
    # to the clean checked run, with no degradation
    want = sp_uuu.solve(f_uuu, verify="abft-stages")
    scale = want.abs().max().item()
    found = []
    for st in ("fwd.0", "fwd.1", "fwd.2", "green", "bwd.0", "bwd.1",
               "bwd.2"):
        n0 = len(sp_uuu.stats.get("integrity", []))
        with faults.FaultPlan([dict(kind="flip", stage=st,
                                    count=1)]) as plan:
            got = sp_uuu.solve(f_uuu, verify="abft-stages")
        recs = sp_uuu.stats["integrity"][n0:]
        err = (got - want).abs().max().item()
        if (len(plan.log) != 1 or not recs
                or any(r["stage"].split("#")[0] != st
                       or r["action"] != "recompute" for r in recs)
                or err > 1e-5 * scale):
            raise AssertionError(f"ABFT flip at {st}: fired {plan.log}, "
                                 f"records {recs}, err {err:.3e}")
        found.append(f"{st} {recs[0]['mismatch']:.2e}")
    clean("ABFT detection matrix", sp_uuu)
    print(f"ABFT_UUU detection matrix (count=1 flips, abft-stages): each "
          f"detected, attributed and recomputed, within 1e-5 of the clean "
          f"checked run; mismatch at the flip: {', '.join(found)}")
    # the two-phase guard: count=2 at fwd.1 under "abft" trips the
    # sandwich (hit 1); the checked re-dispatch localizes it (hit 2)
    n0 = len(sp_uuu.stats["integrity"])
    vf = sp_uuu.stats["verify_failures"]
    with faults.FaultPlan([dict(kind="flip", stage="fwd.1",
                                count=2)]) as plan:
        got = sp_uuu.solve(f_uuu, verify="abft")
    recs = sp_uuu.stats["integrity"][n0:]
    err = (got - want).abs().max().item()
    if (len(plan.log) != 2 or recs[0]["stage"] != "solve.linearity"
            or recs[0]["action"] != "localize"
            or not any(r["stage"].split("#")[0] == "fwd.1"
                       and r["action"] == "recompute" for r in recs[1:])
            or sp_uuu.stats["verify_failures"] != vf + 1
            or err > 1e-5 * scale):
        raise AssertionError(f"ABFT two-phase: fired {plan.log}, records "
                             f"{recs}, err {err:.3e}")
    clean("ABFT two-phase", sp_uuu)
    print(f"ABFT_UUU two-phase guard: plan.log {len(plan.log)}, records "
          f"{[(r['stage'], r['action']) for r in recs]}, sandwich mismatch "
          f"{recs[0]['mismatch']:.3e} (tol {recs[0]['tol']:.1e})")
    # persistent corruption: count=-1 at green survives every recompute
    # and every rung
    sp = PoissonSolver((N,) * 3, 1.0, (U, U, U), engine="cuda", device=dev,
                       green=sp_uuu._green_nat, verify="abft-stages")
    with faults.FaultPlan([dict(kind="flip", stage="green", count=-1)]):
        try:
            sp.solve(f_uuu)
            raised = None
        except SolveError as e:
            raised = e
    trail = [] if raised is None else [d["action"]
                                       for d in raised.degradations]
    if (raised is None or raised.stage != "verify.abft@green"
            or trail != ["engine:cuda->torch",
                         "relayout:scheduled->baseline",
                         "doubling:deferred->upfront"]):
        raise AssertionError(f"ABFT persistent: raised {raised!r}, trail "
                             f"{trail}")
    print(f"ABFT_UUU persistent flip at green: SolveError at "
          f"{raised.stage!r}, trail {trail}")
    del sp, s_eop, f_eop, want, got, u_off, u_ab, u_st
    clear_solver_cache()
    print(f"ABFT phase: {time.perf_counter() - t0:.1f} s")

    # -- 7c. whole solves: times, memory and profiles ------------------------
    phase("7c")
    # here, before the distributed, serve and launcher phases: profiles
    # taken after them lose most device events
    for tag, (sc, st, f) in solvers.items():
        t_c = time_ms(lambda: sc.solve(f))
        t_t = time_ms(lambda: st.solve(f))
        # what one solve allocates above the resident solvers, Green
        # planes and inputs of every case
        sync()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        sc.solve(f)
        sync()
        mem = (torch.cuda.max_memory_allocated() - resident) / 2 ** 30
        print(f"solve {tag} float32: cuda engine {t_c:.3f} ms, torch "
              f"engine (cuFFT) {t_t:.3f} ms, cuda-engine solve memory "
              f"{mem:.3f} GiB above {resident / 2 ** 30:.3f} GiB resident")
        agg = where_the_time_goes(f"{tag} cuda engine", lambda: sc.solve(f),
                                  t_c)
        # a column pass (and its scratch) only where a row takes two
        # passes
        case = tag.split()[0]
        if agg and (any("column_kernel" in k for k in agg)
                    != bool(EXPECTED_TWO_PASS.get(case))):
            raise AssertionError(f"{tag}: column passes "
                                 f"{[k for k in agg if 'column' in k]}, "
                                 f"two-pass calls expected "
                                 f"{EXPECTED_TWO_PASS.get(case, {})}")
        where_the_time_goes(f"{tag} torch engine", lambda: st.solve(f), t_t)

    # -- 8. the distributed solve --------------------------------------------
    phase("8")
    # DIST1: a one-rank NCCL mesh, the whole distributed pipeline (pack,
    # collective, unpack, the kernels on every pencil) at full size
    import tempfile
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.core.comm import (cfg_label, collective_census,
                                       label_to_cfg)
    from repro_torch.core.engine import relayout
    from repro_torch.core.solver import make_plan
    from repro_torch.distributed.pencil import DistributedPoissonSolver
    from repro_torch.plan import guided_comm_candidates, mesh_shapes_for
    t0 = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    dist.init_process_group(
        DIST_BACKEND, init_method=f"file://{tmp.name}/one_rank", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    mesh1 = init_device_mesh(dev.type, (1, 1),
                             mesh_dim_names=("data", "model"))
    dist_launches = {}

    def copies(fn):
        """aten::copy_ calls the host issues in ``fn()``."""
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            fn()
            sync()
        return sum(e.name == "aten::copy_" for e in prof.events())

    semi = ((BCType.UNB, E), U, U)
    sp_semi = PoissonSolver((N // 2,) * 3, 1.0, semi, engine="cuda",
                            device=dev)
    f_semi = torch.from_numpy(rng.standard_normal(
        sp_semi.input_shape).astype(np.float32)).to(dev)
    # NODE (U,U,U) float64: the Green multiply apart (spectral_scale)
    sp_node = PoissonSolver((64,) * 3, 1.0, (U, U, U),
                            layout=DataLayout.NODE, engine="cuda",
                            device=dev)
    f_node = torch.from_numpy(rng.standard_normal(sp_node.input_shape)).to(
        dev)
    sp_uuu, _, f_uuu = solvers[f"UUU n={N}"]
    # case: (bcs, cells, layout, single-process solver, field, strategies,
    # relative tolerance)
    dist1 = {"DIST1_UUU": ((U, U, U), N, DataLayout.CELL, sp_uuu, f_uuu,
                           DIST_STRATEGIES, 1e-5),
             "DIST1_SEMI": (semi, N // 2, DataLayout.CELL, sp_semi, f_semi,
                            ("a2a:1", "overlap:2"), 1e-5),
             "DIST1_NODE": ((U, U, U), 64, DataLayout.NODE, sp_node, f_node,
                            ("a2a:1", "overlap:2"), 1e-10)}
    nat = (0, 1, 2)
    for case, (bcs, nn, layout, sp, f, labels, rtol) in dist1.items():
        u_sp = sp.solve(f)
        t_sp = time_ms(lambda: sp.solve(f))
        print(f"{case} {layout.name} n={nn} {f.dtype}, one-rank "
              f"{DIST_BACKEND} mesh (1, 1); "
              f"single-process cuda solve {t_sp:.3f} ms, aten::copy_ "
              f"x{copies(lambda: sp.solve(f))} per solve; card: {smi}")
        where_the_time_goes(f"{case} single-process", lambda: sp.solve(f),
                            t_sp)
        for lbl in labels:
            run = f"{case}/{lbl}"
            ds = DistributedPoissonSolver(
                (nn,) * 3, 1.0, bcs, layout, mesh=mesh1,
                comm=label_to_cfg(lbl), dtype=f.dtype, device=dev,
                _green_cache=sp._green_nat)
            u, counts = run_counted(run, lambda: ds.solve(f))
            clean(run, ds)
            rel = close(f"{run} against the single-process solve", u, u_sp,
                        rtol)
            dist_launches[run] = {k: v for k, v in counts.items() if v}
            x = ds.shard_input(f)
            t_loc = time_ms(lambda: ds.solve_local(x))
            sync()
            resident = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            ds.solve_local(x)
            sync()
            mem = (torch.cuda.max_memory_allocated() - resident) / 2 ** 30
            # the first forward switch alone, at its shape: the copies the
            # strategy itself makes
            d0 = ds.plan.order[0]
            lay = ds.schedule.layouts.fwd
            y0 = ds.schedule.fwd_last(relayout(x, nat, lay[0]), d0)
            strat = ds._strategy(ds.comm)
            n_sw = copies(lambda: strat.switch(
                y0, "data", 0, 2, valid_extent=ds._S[d0],
                permute=tuple(lay[0].index(d) for d in lay[1])))
            print(f"  {run}: launches {dist_launches[run]}, relative max "
                  f"|diff| {rel:.3e} from the single-process solve; "
                  f"solve_local {t_loc:.3f} ms against {t_sp:.3f} ms "
                  f"single-process ({t_loc - t_sp:+.3f} ms for the "
                  f"switches); memory {mem:.3f} GiB above "
                  f"{resident / 2 ** 30:.3f} GiB resident; aten::copy_ "
                  f"x{copies(lambda: ds.solve_local(x))} per solve_local, "
                  f"x{n_sw} in one switch alone")
            agg = where_the_time_goes(f"{run} solve_local",
                                      lambda: ds.solve_local(x), t_loc)
            # a one-rank mesh issues no collective: none in the census and
            # no NCCL kernel in the profile
            with collective_census() as cc:
                ds.solve_local(x)
            nccl = sorted(k for k in (agg or {}) if "nccl" in k.lower())
            if cc.per_collective or nccl:
                raise AssertionError(f"{run}: the one-rank mesh issued "
                                     f"{len(cc.per_collective)} collectives"
                                     f"; profiled {nccl}")
            print(f"  {run}: collectives issued 0 (census); NCCL kernels "
                  + ("0 (profiler)" if agg is not None
                     else "not measured (no device events)"))
            del ds, x, y0, u
        if case == "DIST1_UUU":
            # comm="auto" with the default search: the cost model's
            # shortlist of the 12 candidates, timed; the same labels as
            # the CPU computes for the plan
            sync()
            t0a = time.perf_counter()
            ds = DistributedPoissonSolver(
                (nn,) * 3, 1.0, bcs, layout, mesh=mesh1, comm="auto",
                dtype=f.dtype, device=dev, _green_cache=sp._green_nat)
            sync()
            t_auto = time.perf_counter() - t0a
            run = f"{case}/auto:guided"
            EXPECTED[run] = uuu_launches(cfg_label(ds.comm))
            u, counts = run_counted(run, lambda: ds.solve(f))
            clean(run, ds)
            rel = close(f"{run} against the single-process solve", u, u_sp,
                        rtol)
            dist_launches[run] = {k: v for k, v in counts.items() if v}
            want = [cfg_label(c) for c in guided_comm_candidates(
                make_plan((nn,) * 3, 1.0, bcs, layout, GreenKind.CHAT2),
                1, 1, f.dtype, folds=("pack", "unpack"))]
            cen = ds.autotune_census
            if (cen["space"] != 12 or cen["shortlist"] != want
                    or sorted(ds.autotune_results) != sorted(want)):
                raise AssertionError(f"{run}: census {cen}, on the CPU "
                                     f"{want}")
            print(f"  {run}: the guided search timed "
                  f"{len(ds.autotune_results)} of {cen['space']} candidates "
                  f"(the CPU's shortlist {want}: "
                  + ", ".join(f"{k} {v * 1e3:.3f} ms" for k, v in
                              sorted(ds.autotune_results.items()))
                  + f") in {t_auto:.2f} s and chose {cfg_label(ds.comm)}; "
                  f"launches {dist_launches[run]}, relative max |diff| "
                  f"{rel:.3e} from the single-process solve")
            del ds, u
    # ABFT on the one-rank mesh: the checked pipeline (every switch with
    # its wire check, over one-rank axes no collective), and
    # verify="abft" on both engines
    u_ref = sp_uuu.solve(f_uuu)
    for lbl in ("a2a:1", "overlap:2"):
        run = f"DIST1_UUU/abft-stages/{lbl}"
        ds = DistributedPoissonSolver(
            (N,) * 3, 1.0, (U, U, U), mesh=mesh1, comm=label_to_cfg(lbl),
            device=dev, verify="abft-stages",
            _green_cache=sp_uuu._green_nat)
        with collective_census() as cc:
            u, counts = run_counted(run, lambda: ds.solve(f_uuu))
        clean(run, ds)
        rel = close(f"{run} against the single-process solve", u, u_ref)
        names = ds.abft_jit_for()[1]
        wires = sorted({n.split("#")[0] for n in names
                        if n.startswith("wire.")})
        if (wires != ["wire.data", "wire.model"] or cc.per_collective
                or ds.stats.get("integrity")):
            raise AssertionError(f"{run}: wire checks {wires}, census "
                                 f"{cc.per_collective}, records "
                                 f"{ds.stats.get('integrity')}")
        dist_launches[run] = {k: v for k, v in counts.items() if v}
        t_st = time_ms(lambda: ds.solve(f_uuu))
        print(f"  {run}: launches {dist_launches[run]}, relative max "
              f"|diff| {rel:.3e}; {len(names)} checks, "
              f"{sum(n.startswith('wire.') for n in names)} of them wire "
              f"({', '.join(wires)}), collectives issued 0 (census); solve "
              f"{t_st:.3f} ms")
        del ds, u
    for eng in ("cuda", "torch"):
        run = f"DIST1_UUU/abft/{eng}"
        ds = DistributedPoissonSolver(
            (N,) * 3, 1.0, (U, U, U), mesh=mesh1, engine=eng, device=dev,
            verify="abft", _green_cache=sp_uuu._green_nat)
        branch = "checked" if ds._lite_pair() is None else "sandwich"
        if branch != {"cuda": "checked", "torch": "sandwich"}[eng]:
            raise AssertionError(f"{run}: the {branch} branch")
        u, counts = run_counted(run, lambda: ds.solve(f_uuu))
        clean(run, ds)
        rel = close(f"{run} against the single-process solve", u, u_ref)
        if ds.stats.get("integrity") or ds.stats["verify_failures"]:
            raise AssertionError(f"{run}: {ds.stats}")
        dist_launches[run] = {k: v for k, v in counts.items() if v}
        t_ab = time_ms(lambda: ds.solve(f_uuu))
        print(f"  {run}: the {branch} branch ran; launches "
              f"{dist_launches[run]}, relative max |diff| {rel:.3e}; solve "
              f"{t_ab:.3f} ms")
        del ds, u
    dist.destroy_process_group()
    del sp_semi, f_semi, sp_node, f_node, u_sp, u_ref

    # DIST4: four gloo ranks on the one card (NCCL refuses two ranks on one
    # device); gloo stages CUDA tensors through the host, so these runs
    # prove the exchange on the card and are not a communication figure
    n4 = N // 2
    s4 = PoissonSolver((n4,) * 3, 1.0, (U, U, U), engine="cuda", device=dev)
    f4 = rng.standard_normal(s4.input_shape).astype(np.float32)
    node_bcs = ((E, E), (O, E), P)
    sn = PoissonSolver((64,) * 3, 1.0, node_bcs, layout=DataLayout.NODE,
                       engine="cuda", device=dev)
    fn = rng.standard_normal(sn.input_shape)
    d4 = Path(tmp.name)
    for key, arr in (("f4", f4), ("g4", s4._green_nat), ("fn", fn),
                     ("gn", sn._green_nat),
                     ("u4", s4.solve(torch.from_numpy(f4).to(dev)).cpu()),
                     ("un", sn.solve(torch.from_numpy(fn).to(dev)).cpu())):
        np.save(d4 / f"{key}.npy", np.asarray(arr))
    with open(d4 / "params.json", "w") as fh:
        json.dump({"device": str(dev), "n4": n4, "reps": REPS,
                   "strategies": DIST_STRATEGIES, "n_plan": PLAN_N,
                   "plan_k": PLAN_K, "plan_reps": PLAN_REPS}, fh)
    del s4, sn
    print(f"DIST4_GLOO: 4 gloo ranks on one card, spawning "
          f"({time.perf_counter() - t0:.1f} s into the phase)")
    mp.start_processes(_dist4_rank, args=(4, str(d4)), nprocs=4,
                       start_method=DIST_START)
    ranks = []
    for r in range(4):
        # written by this script's own ranks just above
        with open(d4 / f"rank{r}.pkl", "rb") as fh:
            ranks.append(pickle.load(fh))
    tmp.cleanup()
    for run, lbl in ranks[0]["expected"].items():
        EXPECTED[run] = uuu_launches(lbl, 4)
    for run in ranks[0]["runs"]:
        total = collections.Counter()
        for res in ranks:
            total.update(res["runs"][run]["counts"])
        got = {k: v for k, v in total.items() if v}
        if got != EXPECTED[run]:
            raise AssertionError(f"{run}: launches summed over the ranks "
                                 f"{got}, expected {EXPECTED[run]}")
        dist_launches[run] = got
        rel = max(res["runs"][run]["rel"] for res in ranks)
        ms = max(res["runs"][run].get("ms", 0.0) for res in ranks)
        print(f"  {run}: launches over the 4 ranks {got}, relative max "
              f"|diff| {rel:.3e} from the single-process solve"
              + (f"; solve_local {ms:.3f} ms (host-staged by gloo, not a "
                 "communication figure)" if ms else ""))
    for how in ("brute", "guided"):
        winners = {res[how]["winner"] for res in ranks}
        if len(winners) != 1:
            raise AssertionError(f"DIST4 comm='auto' ({how}): ranks chose "
                                 f"{winners}")
        res = ranks[0][how]
        print(f"  DIST4_GLOO_UUU comm='auto' ({how}, {len(res['timed'])} "
              f"candidates timed in {max(r[how]['wall_s'] for r in ranks):.2f}"
              f" s): every rank chose {res['winner']}, relative max |diff| "
              f"{max(r[how]['rel'] for r in ranks):.3e}; agreed times "
              "(host-staged) "
              + ", ".join(f"{k} {v * 1e3:.2f} ms"
                          for k, v in sorted(res["timed"].items(),
                                             key=lambda kv: kv[1])))
    n_b, n_g = (len(ranks[0][h]["timed"]) for h in ("brute", "guided"))
    want = [cfg_label(c) for c in guided_comm_candidates(
        make_plan((n4,) * 3, 1.0, (U, U, U), DataLayout.CELL,
                  GreenKind.CHAT2), 2, 2, torch.float32,
        folds=("pack", "unpack"))]
    if 5 * n_g > n_b or any(r["guided"]["shortlist"] != want
                            for r in ranks):
        raise AssertionError(f"DIST4 guided: timed {n_g} of {n_b}, "
                             f"shortlist {ranks[0]['guided']['shortlist']}, "
                             f"on the CPU {want}")
    best = ranks[0]["head_to_head"]
    bw, gw = ranks[0]["brute"]["winner"], ranks[0]["guided"]["winner"]
    print(f"  DIST4_GLOO_UUU guided shortlist {want} (the CPU's, on every "
          f"rank), timed {n_g} of {n_b}; "
          + (f"head to head (8 turns, best of 3, agreed): guided {gw} "
             f"{best[gw] * 1e3:.3f} ms, brute {bw} {best[bw] * 1e3:.3f} ms, "
             f"regret {best[gw] / best[bw]:.3f} (host-staged: printed, not "
             "held)" if bw != gw else "the same winner, regret 1"))
    plans = [res["plan"] for res in ranks]
    pl = plans[0]
    n_r2 = sum("|r=2" in lbl for lbl in pl["timed"])
    if (len({p["winner"] for p in plans}) != 1 or not n_r2
            or any(p["again"] != [False, True, True] for p in plans)):
        raise AssertionError(f"search_plan: winners "
                             f"{[p['winner'] for p in plans]}, replays "
                             f"{[p['again'] for p in plans]}, radix-2 "
                             f"points timed {n_r2}")
    for lbl in pl["timed"]:
        total = collections.Counter()
        for p in plans:
            total.update(p["points"][lbl])
        got = {k: v for k, v in total.items() if v}
        if got != uuu_launches(lbl, 4):
            raise AssertionError(f"search_plan {lbl}: launches summed over "
                                 f"the ranks {got}, expected "
                                 f"{uuu_launches(lbl, 4)}")
        dist_launches[f"DIST4_GLOO_PLAN/{lbl}"] = got
    print(f"  DIST4_GLOO_PLAN search_plan (U,U,U) n={PLAN_N} float32, "
          f"engine cuda, meshes {mesh_shapes_for(4)}, both order policies, "
          f"radix 4 and 2: space {pl['space']}, {pl['pruned']} pruned for "
          f"padding, k={PLAN_K}: {len(pl['timed'])} timed ({n_r2} of them "
          f"radix 2; best of {PLAN_REPS} solves each) in "
          f"{max(p['wall_s'] for p in plans):.2f} s; every rank chose "
          f"{pl['winner']} "
          f"({pl['seconds'] * 1e3:.3f} ms); a second call replayed it from "
          f"the cache in {max(p['again_s'] for p in plans):.3f} s; every "
          "timed point's launches exact")
    print("    timed (agreed, host-staged): " + ", ".join(
        f"{k} {v * 1e3:.2f} ms" for k, v in sorted(pl["timed"].items(),
                                                   key=lambda kv: kv[1])))
    print("  slab meshes' census (send bytes per collective, as predicted): "
          + "; ".join(f"{k}: {v}" for k, v in ranks[0]["slabs"].items()))
    ab = ranks[0]["abft"]
    if any(res["abft"]["persistent"] != ab["persistent"] for res in ranks):
        raise AssertionError("DIST4_GLOO_ABFT: the ranks' escalations "
                             "differ")
    print(f"  DIST4_GLOO_ABFT (reference SDC script, mesh (2, 2), n={n4} "
          f"float32, engine torch) passed on every rank in "
          f"{max(r['abft']['wall_s'] for r in ranks):.1f} s: "
          + "; ".join(f"{k}: {v}" for k, v in ab.items() if k != "wall_s"))
    for res in ranks:
        for key, c in res["calls"].items():
            calls[key] = calls.get(key, 0) + c
    print(f"distributed phase: {len(dist_launches)} runs in "
          f"{time.perf_counter() - t0:.1f} s")

    # -- 8b. the solve server -------------------------------------------------
    phase("8b")
    serve_launches = _serve_phase(dev, smi, run_counted)

    # -- 8c. the solve launcher and checkpoints -------------------------------
    phase("8c")
    launch_launches = _launch_phase(dev, smi, run_counted, calls)

    # -- 8d. serving on a mesh of four ranks ----------------------------------
    phase("8d")
    serve_launches.update(_serve_mesh_phase(dev, smi, calls))

    # the LM phases need the card: the solve phases' solvers, Green planes
    # and fields leave it (phase 9 replays from the recorded descriptors)
    solvers.clear()
    dist1.clear()
    del sc, st, f, ut, sp, sp_uuu, f_uuu, bc, bt
    clear_solver_cache()

    # -- 8e. LM training ------------------------------------------------------
    phase("8e")
    lm_ms = _lm_phase(dev, smi)

    # -- 8f. LM serving -------------------------------------------------------
    phase("8f")
    _lm_serve_phase(dev, smi)

    # -- 8g. LM training on a mesh of four ranks ------------------------------
    phase("8g")
    _lm_train_mesh_phase(dev, smi)

    # -- 8h. the dry run ------------------------------------------------------
    phase("8h")
    _dryrun_phase(dev, smi, run_counted, lm_ms)

    # -- 9. replays and times -------------------------------------------------
    phase("9")
    def nbytes(t):
        return t.numel() * t.element_size()

    gen_dev = torch.Generator(device=dev).manual_seed(9)

    def drandn(shape, dtype):
        """Seeded standard normals drawn on the card (complex: both
        parts): the replays' inputs run to hundreds of MB, which the
        host's generator takes seconds to draw."""
        if dtype.is_complex:
            rdt = torch.float64 if dtype == torch.complex128 else \
                torch.float32
            return torch.complex(*(torch.randn(shape, generator=gen_dev,
                                               device=dev, dtype=rdt)
                                   for _ in range(2)))
        return torch.randn(shape, generator=gen_dev, device=dev, dtype=dtype)

    def fresh(shape, stride, offset, dtype):
        """Seeded normals laid out as the recorded argument was (a window
        of a wider tensor keeps its strides and offset)."""
        span = offset + sum((n - 1) * st for n, st in zip(shape, stride)) + 1
        return drandn((span,), dtype).as_strided(shape, stride, offset)

    def library_call(kname, x, targs, kw, nf):
        """One PyTorch call computing the same function, or None."""
        if kname == "fft_stockham":
            fn = (torch.fft.ifft if kw.get("inverse")
                  else torch.fft.rfft if not x.is_complex()
                  else torch.fft.fft)
            return lambda: fn(x, n=nf)
        if kname == "spectral_scale":
            return lambda: torch.mul(x, targs[0])
        if kname == "twiddle_pack":
            ab = torch.stack(targs, dim=-1)
            return lambda: torch.linalg.vecdot(torch.view_as_real(x), ab)
        return None      # no single call computes FFT x Green or twiddle

    per = {k: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, by_bytes=0.0,
                   by_ops=0.0) for k in LAUNCHES}
    lib_none = set()
    by_desc = {}
    for (run, desc), count in calls.items():
        by_desc.setdefault(desc, {})[run] = count
    t0 = time.perf_counter()
    for (kname, xd, args, kw), counts in by_desc.items():
        kw = dict(kw)
        x = fresh(*xd)
        rdt = x.real.dtype if x.is_complex() else x.dtype
        targs = [drandn(v, rdt) if kind == "t" else v for kind, v in args]
        kern = lambda: wrappers[kname](x, *targs, **kw)   # noqa: E731
        plain = lambda: getattr(ref, kname)(x, *targs, **kw)  # noqa: E731
        out = kern()
        ins = nbytes(x) + sum(nbytes(v) for v in targs if torch.is_tensor(v))
        byts = ins + nbytes(out)
        if kname in ("spectral_scale", "twiddle_pack"):
            hold(kname, out, plain(), *scale_tol(rdt))
            # a * re + b * im: 3 per value; the scale: 1 per component
            flops = out.numel() * (3 if kname == "twiddle_pack" else
                                   2 if out.is_complex() else 1)
            nf = x.shape[-1]
        else:
            nf = kw.get("pad_to") or x.shape[-1]
            hold(kname, out, plain(), *fft_tol(rdt, nf))
            flops = x.shape[0] * 5 * nf * math.log2(nf)
        count = counts.get(TIMED_ON[kname])
        also = [r for r in ALSO_TIMED.get(kname, ()) if r in counts
                and (kname == "spectral_scale" or nf > ONE_PASS_N
                     or x.shape[0] == 1)]
        if count is None and not also:
            continue
        library = library_call(kname, x, targs, kw, nf)
        t_k = time_ms(kern, ahead=True)
        t_p = time_ms(plain, ahead=True)
        t_l = time_ms(library, ahead=True) if library is not None else None
        how = "median of single calls"
        if t_k < SHORT_MS:
            # fresh input sets that together exceed twice the L2 cache
            sets = [(x, targs)] + [
                (fresh(*xd), [drandn(v, rdt) if kind == "t" else v
                              for kind, v in args])
                for _ in range(min(15, math.ceil(100e6 / byts)))]

            def over(fn):
                return [lambda xx=xx, tt=tt: fn(xx, *tt, **kw)
                        for xx, tt in sets]
            t_k = loop_ms(over(wrappers[kname]))
            t_p = loop_ms(over(getattr(ref, kname)))
            if library is not None:
                t_l = loop_ms([library_call(kname, xx, tt, kw, nf)
                               for xx, tt in sets])
            how = f"{LOOP} calls in a row over {len(sets)} input sets"
            del sets
        b_bytes = byts / hbm * 1e3
        b_ops = flops / peak[rdt] * 1e3
        runs_of = ", ".join(f"x{c} per {r}" for r, c in counts.items()
                            if r == TIMED_ON[kname] or r in also)
        print(f"  {kname} ({runs_of} solve"
              f"{'' if nf <= ONE_PASS_N else '; ' + path(nf)}): x "
              f"{tuple(x.shape)} stride {x.stride()} {x.dtype} {kw} -> "
              f"kernel {t_k:.4f} ms, plain {t_p:.4f} ms, library "
              f"{'n/a' if t_l is None else f'{t_l:.4f} ms'}, bound "
              f"{max(b_bytes, b_ops):.4f} ms ({byts / 1e6:.1f} MB; "
              f"{max(b_bytes, b_ops) / t_k:.0%} of it); {how}")
        if count is None:
            continue
        p = per[kname]
        p["ms"] += count * t_k
        p["plain_ms"] += count * t_p
        p["by_bytes"] += count * b_bytes
        p["by_ops"] += count * b_ops
        if t_l is None:
            lib_none.add(kname)
        else:
            p["library_ms"] += count * t_l
    n_r2 = sum(dict(kw).get("max_radix") == 2 for _, _, _, kw in by_desc)
    print(f"replays: {len(by_desc)} kernel calls of the recorded solves "
          f"({n_r2} of them radix 2, from search_plan's solves) held "
          f"against their plain versions and timed in "
          f"{time.perf_counter() - t0:.2f} s")

    kernels = []
    for kname in LAUNCHES:
        p = per[kname]
        bound = max(p["by_bytes"], p["by_ops"])
        kernels.append({
            "name": kname, "route": "cuda", "source": SOURCES[kname],
            "replaces": REPLACES[kname], "launches": launches[kname],
            "max_abs_err": errs[kname], "ms": p["ms"],
            "plain_ms": p["plain_ms"], "bound_ms": bound,
            "bound_by": ("bytes" if p["by_bytes"] >= p["by_ops"]
                         else "operations"),
            "library_ms": None if kname in lib_none else p["library_ms"],
            "dist_launches": {r: c[kname] for r, c in dist_launches.items()
                              if kname in c},
            "serve_launches": {r: c[kname] for r, c in serve_launches.items()
                               if kname in c},
            "launch_launches": {r: c[kname]
                                for r, c in launch_launches.items()
                                if kname in c}})
    phase(None)
    print(f"host Green assemblies of the run: {greens.made} made in "
          f"{greens.seconds:.1f} s, {greens.shared} shared by plan")
    print(f"chip_smoke.py: every phase passed in "
          f"{time.perf_counter() - t_start:.1f} s")
    print(f"card: {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
