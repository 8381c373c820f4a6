#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (trainingjob_operator_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each printing one JSON line (any failed check raises, and the
script exits non-zero):

1. device: the card's name and power limit (the ``nvidia-smi`` line is
   printed as it is), then the build of every kernel under ``csrc/`` into
   the package's ``_build/`` (set-up time, ``build_s``), which every later
   process phase but 10a finds there.
2. kernel_checks: each kernel against its plain PyTorch version on the
   card at the serving and training paths' full-width shapes, with the
   tolerance, the kernel's time, the plain version's time, the one-call
   PyTorch yardstick's time (timed only; the port never calls it) and the
   bound.  The flash forward's output (``FWD_TOL``) and the backward
   kernels' gradients (dQ, dK/dV, ``BWD_TOL``) are held to about one bf16
   step, an atol that is a fraction of the reference's RMS and a relative
   L2 limit; the backward must give bit-identical results on a second
   run.  RMSNorm runs at Llama-2-7B's rows and at the 124M trainer's
   [8192, 768] in float32 and bf16 (``RMS_CASES``), timed over a rotation
   of input copies twice the size of the card's L2, so that every call
   reads its input from device memory.  Two cases are unmasked (``causal=False``, B1 T4096 H32 D128,
   MHA and GQA 32/8): a ring block before the diagonal, timed against
   SDPA with ``is_causal=False`` and bound with T^2 visible pairs.  The
   decode attention runs at the serving cell's cache slice, full and at a
   ragged half fill, and at ``generate``'s one row (``DECODE_CASES``,
   ``DECODE_TOL``), timed over a rotation of layer slices.  The grouped
   expert products of the routed MLP run at the routed serving cell's
   decode step and chunk at Mixtral-8x7B's widths (``MOE_EXPERT_CASES``,
   ``MOE_EXPERT_TOL``); their yardstick is the cuBLAS loop over the
   experts with the counts already on the host.
2a. train_124m_f32: the trainer's step at the 124M config in float32
   (``LLAMA_DTYPE=float32``: head dim 64, so attention takes the f32-FMA
   kernels), seq 1024, batch 8, remat "none", TF32 off for cuBLAS and
   cuDNN, 8 steps on one batch: the loss falls; the first F32_PLAIN_STEPS
   losses equal, within F32_PLAIN_RTOL, a run whose attention goes
   through the plain version (patched in this script only); launches as
   ``train_launches`` counts them, none on the tensor cores; no input of
   an f32-FMA kernel is copied first (``fma_operand``).  Step time
   (median of steps 2-8), tokens/s, peak memory, the idle share, the
   kernels a step and the three flash kernels' device ms a step.
3. tiny_equivalence: the tiny config in fp32 through the kernels; every
   request of a DecodeService run must get exactly the tokens ``generate``
   gives for its prompt.
4. tiny_train_equivalence: the tiny config in fp32 trains 5 steps of the
   trainer's step (``llama_elastic.make_step_fn``: AdamW, accum 2), with
   remat "none", "full", "attn" and "dots", once through the kernels on
   the card and once through the plain versions on the CPU from the same
   parameters and tokens: losses agree to 1e-4 relative at every step,
   the first step's gradients (before any update) to rtol = atol = 1e-4.
   Launches per microbatch of a model of L layers (``train_launches``):
   flash forward L (2 L under "full" and "dots", whose backward re-runs
   it), dQ and dK/dV L, RMSNorm 2 L + 1 (4 L + 1 under every remat).
4a. tiny_moe_equivalence: the MoE tiny config in fp32 at a dropless
   capacity (capacity_factor = n_experts / experts_per_token): every
   request of a MoE DecodeService run gets ``moe_decode.generate``'s
   tokens, and 5 steps of the MoE trainer's step (``moe.loss_fn``, accum
   1) under each remat policy on the card equal the CPU's, as in phase 4.
5. serve_7b: DecodeService on a seeded random-init Llama-2-7B (bf16, 16
   of its 32 layers: the depth cut that keeps the script inside half its
   limit); zero stale-KV violations, every request finished, RMSNorm
   launched 33 times per decode step and per prefill chunk and the decode
   attention once per layer and decode step.
6. generate_7b: a 512-token prompt and 32 greedy steps; the tensor-core
   flash forward is launched once per layer by the prefill, the decode
   attention once per layer and decode step.
7. train_7b_width: the trainer's step (``llama_elastic.make_step_fn``) at
   Llama-2-7B widths, 8 of its 32 layers (f32 masters and AdamW state for
   all 32 need about 108 GB), bf16 compute, seq 4096, global batch 2 with
   accum 2, remat "none": 8 steps on one repeated batch; losses finite
   and the last below the first; per step 16 launches each of the flash
   forward, dQ and dK/dV and 34 of RMSNorm (the formula of phase 4), every
   flash forward, dQ and dK/dV launch on the tensor-core kernels.
8. remat_7b_width: phase 7 under remat "attn" (16 flash forwards a step:
   its (out, lse) are kept) and "dots" (32: the backward re-runs it), 66
   RMSNorms a step each; losses within REMAT_LOSS_RTOL of phase 7's; step
   time, tokens/s, peak memory and a step profile of each.
9. sharded_7b_width: phase 7 through the multi-process path at world 1:
   ``rendezvous.initialize_distributed`` forms a process group of one on
   NCCL, ``mesh_spec_from_rendezvous`` / ``make_mesh`` build the mesh,
   and the sharded init and step run with every collective launched over
   it (``mesh_collectives``: per layer and microbatch 7 all-gathers, 7
   reduce-scatters and 11 all-reduces); its 8 losses equal phase 7's
   within SHARDED_LOSS_RTOL (bit for bit expected); step time, tokens/s,
   peak memory and their gap to phase 7.
9a. ring_7b_width: ring attention at Llama-2-7B width (H 32, D 128,
   bf16; MHA and GQA 32/8), B 1 and a 16,384-token sequence as sp = 4
   virtual ranks of 4,096 tokens, played in turn in this process: each
   rank's per-block forwards over the KV blocks the ring brings it
   (``parallel/ringattention.py`` ``ring_blocks``; causal on the
   diagonal, unmasked before it, later blocks skipped), the f32 merge,
   and the per-block dQ and dK/dV with the merged LSE and delta.  Out,
   LSE, dQ, dK and dV against the whole-sequence kernels at T = 16,384
   within the flash tolerances; 10 forward, 10 dQ and 10 dK/dV launches
   a case, all tensor-core; the ring's summed kernel time against the
   whole-sequence kernels', and the merge's.
9b. sp_7b_width: phase 9's step with ``sequence_parallel=True`` on the
   sp = 1 mesh of an NCCL group of one: the ring's autograd Function and
   operator, its shifts at size 1 and the remat policy's save; the 8
   losses equal phase 9's within SHARDED_LOSS_RTOL (one causal block and
   a merge of one: bit for bit expected), no ``p2p`` shift, launches as
   ``train_launches`` says; step time and peak against phase 9's.
10. resume_124m: the trainer's entry point (``python -m
   ...workloads.llama_elastic``) at the 124M config (dim 768, 8 layers,
   12 heads of 64, vocab 32000; seq 1024, batch 8), as its own processes
   on one temporary checkpoint directory: an uninterrupted run of 12
   steps; a run given SIGTERM after step 4, which must exit 143 with its
   step committed; a restart from the resume image; a restart with
   ``TRAININGJOB_CKPT_FAULT=resume_image`` (the image is corrupt, the step
   directory restores) and one with ``=corrupt_latest`` (the previous
   committed step restores), each training on.  Every run's per-step
   losses come from its telemetry records, and the losses after each
   resume equal the first run's at the same steps, bit for bit.  Then
   ``generate`` on the checkpoint gives the greedy tokens of the saved
   parameters.  Prints each run's ``recovery_timing`` (restore_s,
   first_step_s) and ``ckpt_stall``.
10a. kernel_cache_restart_124m: the restart as a fresh container sees
   it: a copy of the package without ``_build/`` (``PYTHONPATH`` and the
   working directory point at it), an empty
   ``TRAININGJOB_COMPILE_CACHE_DIR``, a copy of phase 10's committed step
   for each of three restarts to step CACHE_RESTART_STEPS (cold cache,
   overlapped; warm, overlapped; warm with
   ``TRAININGJOB_RESUME_OVERLAP=0``), and an ``nvcc`` shim on
   ``PATH`` that logs its calls.  Gates: the cold restart compiles every
   ``.cu`` once into the cache and its restore overlaps the build
   (``resume_phases_wall_s`` < ``restore_s + compile_s``); the warm ones
   compile nothing and load the cached library (``kernels: loaded
   ... (cache hit)``); ``resume_overlap`` 1, 1, 0; losses equal phase 10's
   uninterrupted run's bit for bit; launches as ``train_launches`` counts
   them.  Per restart: process start -> first step, ``restore_s``,
   ``compile_s``, ``resume_phases_wall_s``, ``first_step_s``, the
   ``kernels:`` line and the launches.
10b. jax_handoff_124m: a job the JAX package's worker
   committed, taken over: phase 10's committed step k written as the JAX
   trainer commits it (an orbax step's marker and the resume image: numpy
   leaves, optax's AdamW state named by its globals, the sha256 footer),
   with no JAX or optax here.  ``generate`` on it gives the greedy tokens
   of the same parameters; the trainer's entry point resumes it at step
   k (``resume: step k restored from the JAX package's resume image``,
   the resume record's fallback ``jax_image``) and trains HANDOFF_STEPS
   steps whose losses equal phase 10's uninterrupted run's bit for bit,
   launches as ``train_launches``; its port steps sit beside the JAX
   step.  Prints the image's size, write and read split (read, sha256,
   unpickle, conversion), ``restore_s`` and process start -> first step.
11. telemetry: a 6-step 124M run with telemetry, the step profiler and
   the span trace on: one record per step, ``hbm_bytes`` on every second,
   ``ckpt_ms`` on the record after the save, a ``torch.profiler`` Chrome
   trace with device kernels, and the trainer's spans.
12. cross_width_resume: the trainer's entry point on the tiny config in
   fp32 as two processes on the machine's CPU (gloo) to step 2, whose two
   shards a one-process card run (a group of one on NCCL) resumes and
   trains to step 6; its losses equal an uninterrupted card run's within
   CROSS_LOSS_RTOL, and its resume record says the image was missing.

13. resize_7b_width: the live rung at phase 9's width, in process: the
   trainer's loop on phase 9's parameters and batch in an NCCL group of
   one; after step 4 the phase publishes generation 1 (world [0], the
   same coordinator address), and ``llama_elastic.resize_cycle`` destroys
   and forms the group again, rebuilds the mesh and the step, keeps the
   state on the card (``fallback=0``, ``moved_mb=0``, no checkpoint read)
   and resumes; the 8 losses equal phase 9's within SHARDED_LOSS_RTOL,
   the peak within RESIZE_PEAK_GIB of phase 9's; the resize's timings,
   the step time before and after, the first step after.
14. resize_ladder_124m: the trainer's entry point at phase 10's settings
   (but LADDER_STEPS = 6 steps) with a coordinator and the resize
   channel, the parent publishing
   generation 1 after the first ``step`` line: rung ``live`` (rc 0);
   fault ``barrier``: ``checkpoint`` (rc 143), then a restart born into
   generation 1 resumes; ``barrier,persist``: ``checkpoint`` then
   ``restart_all`` (rc 143), then a restart resumes from the previous
   committed step; every run's losses equal phase 10's uninterrupted
   run's within SHARDED_LOSS_RTOL; the downtime of each rung on the
   parent's clock.
15. serve_moe_width, generate_moe_width: phases 5 and 6 on a seeded
   random-init Mixtral-8x7B (vocab 32000, dim 4096, 32/8 heads, ffn 14336,
   8 experts, top 2, capacity_factor 1.25, bf16), 16 of its 32 layers
   (23.48e9 parameters, 43.7 GiB; all 32 need 93.4 GB): the same gates
   (every flash launch of the prefill on the tensor cores at GQA 32/8),
   and generate raises the prefill's capacity warning.
16. train_moe_width: the MoE trainer's step at Mixtral-8x7B widths, 2 of
   32 layers (f32 masters, gradients and moments: 50.6 GB), seq 4096,
   global batch 2, remat "none", 8 steps on one batch: the loss falls;
   per step L launches each of the tensor-core flash forward, dQ and
   dK/dV and 2 L + 1 RMSNorms; step time, tokens/s, peak memory, a step
   profile and its split into expert GEMMs, dispatch/combine, the other
   GEMMs, the kernels and the rest (``gemm_split``).
16a. sharded_moe_width: phase 16 through the multi-process path at world
   1, as phase 9 (a group of one on NCCL, the mesh of
   ``mesh_spec_from_rendezvous(expert_parallel=1)``, the MoE sharding
   rules, the sharded init and the mesh step; ``moe_mesh_collectives``:
   per layer 8 all-gathers, 8 reduce-scatters and 16 all-reduces); its 8
   losses equal phase 16's within SHARDED_LOSS_RTOL; step time, peak
   memory and their gap to phase 16.
17. moe_resume: the MoE trainer's entry point (``python -m
   ...workloads.moe_pretrain``, MOE_CONFIG=tiny) as processes, on one
   card and with a coordinator at world 1 (a group of one on NCCL, the
   mesh path, a sharded checkpoint), each on its own checkpoint
   directory: uninterrupted, SIGTERM after step 4 (exit 143, the step
   committed), a restart whose losses equal the same path's
   uninterrupted run's bit for bit; then the ``generate`` main with
   GEN_FAMILY=moe on each checkpoint (the sharded one too) and ``serve``
   on the single-card one.
18. bert_base (after sp_7b_width): BERT-base (12 layers, vocab 30522,
   bf16) on one card, the trainer's step at seq 128 and global batch 256
   (the BERT paper's phase-1 pretraining shape), 8 steps on one batch:
   the loss falls; step time (median of steps 2-8), tokens/s, peak
   memory, the idle share (``profile_steps``) and a device-time split
   (``op_split``) into dense GEMMs, attention (its two batched products
   and the work on the scores), LayerNorm/GELU, the f32 logits and
   cross-entropy, AdamW and the rest; beside it the
   tiny fp32 config's losses on the card and on the CPU within
   TINY_TRAJ_RTOL.
19. resnet50: ResNet-50 at 224 px, global batch 128, bf16, the trainer's
   SGD step (lr RESNET_LR), 8 steps on one batch: the loss falls and the
   running statistics stay finite; step time, images/s, peak memory, the
   idle share and a split into convolutions, batch norm/relu work on the
   activations, pads and pools, SGD, the head and the rest; the tiny fp32
   trajectory, card against CPU.
20. mnist_resume, bert_resume, resnet_resume (after moe_resume): the
   kill-and-resume contract of the JAX mains of configs 1, 4 and 3
   (``workload_resumes``): each entry point as processes on the card, an
   uninterrupted run beside one killed (exit -9) once its step-20 (MNIST,
   at JAX's defaults: hidden 256, batch 128, 60 steps) or step-10 (BERT
   and ResNet, tiny, 20 steps) save has committed; the restart resumes
   there, its loss lines equal the uninterrupted run's and its last
   checkpoint equals that run's bit for bit; BERT also with a
   coordinator at world 1 (NCCL, the sharded checkpoint).  MNIST's
   restart runs alone and reports its process start -> first step
   seconds, split into imports, CUDA init, set-up, restore and the first
   step.  These workloads reach no TPU kernel in the reference: every
   phase of 18-20 must launch none of the port's kernels.

Each phase line carries ``elapsed_s``, the script's seconds so far.
Then the ``kernels`` line, one entry per hand-written kernel: RMSNorm,
the tensor-core (wgmma) and f32-FMA kernels of the flash forward, dQ and
dK/dV, the decode attention and the grouped expert products, with their
launches on the paths driven
(the 7B phases 5-9b and 13, the 124M trainer of phases 10-11 (10a and 10b
too) and 14 and the Mixtral-width phases 15-16a run the bf16 tensor-core
kernels, the 124M float32 trainer of phase 2a, the tiny fp32 phases 3-4a
and 12 and the tiny MoE trainer of phase 17 (head dim 16) the f32-FMA
ones; a trainer process reports its launches when it returns) and, last,
``{"ok": true, "device": {...}}``.  Exits non-zero
without printing a result when CUDA is unavailable or the package is not
beside this script.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import itertools
import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

#: The checkout this script sits in (the trainer runs from it).
ROOT = Path(__file__).resolve().parent

#: Published H100 SXM peaks (NVIDIA data sheet; dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}

EPS = 1e-5
#: (rtol, atol) of the RMSNorm kernel vs its plain version on the card:
#: bf16 outputs may be one bf16 rounding apart; f32 differs only in
#: summation order.
OUT_TOL = {"bfloat16": (2e-2, 2e-2), "float32": (1e-4, 1e-4)}
#: (rtol, atol as a fraction of the reference's RMS) of the flash forward's
#: output against the plain forward, and beside it the relative L2 limit
#: FWD_L2_RTOL.  The f32-FMA kernel rounds its f32 sums once, to the input
#: dtype, as the plain version does: under bf16 the two may sit one bf16
#: step apart (at most 2^-7 relative), and the atol covers only entries
#: near 0.  An output entry is about sqrt(e / n) for n visible keys (0.026
#: at n = 4096), so an absolute 2e-2 would let a wrong late query tile pass.
#:
#: The tensor-core kernels ("bfloat16_wgmma": csrc/flash_fwd_wgmma.cu,
#: csrc/flash_bwd_dq_wgmma.cu, csrc/flash_bwd_dkv_wgmma.cu) also round P
#: (forward; dz in dQ; P and dz in dK/dV) to bf16 before the products that
#: take it, as FlashAttention-2/3 and SDPA's flash kernels do.  Rounding to
#: nearest bf16 leaves a relative
#: error uniform within half a step, 2^-8 .. 2^-9 of the value: over
#: mantissas spread evenly in log, an RMS of 2^-7 sqrt(0.541 / 12) = 1.7e-3.
#: Each output entry sums many such rounded terms with random signs, so it
#: carries an absolute error of about 1.7e-3 x the RMS of its row (the row's
#: scale, not the tensor's: under a causal mask an early row of O or dQ or
#: a first KV row of dK/dV is far above the tensor's RMS).  Hence:
#: - atol = 2e-2 x the RMS of each row (over D): the largest of 2^24
#:   Gaussian errors is about 5.8 sigma = 1e-2 x the row's RMS, doubled;
#: - rtol stays 1e-2: the final cast may still put the two one bf16 step
#:   apart;
#: - relative L2 5e-3: the 1.7e-3 of P's rounding and up to 1.7e-3 more
#:   from the two final casts, sqrt(2) x 1.7e-3 = 2.4e-3, doubled.
FWD_TOL = {"bfloat16": (1e-2, 1e-3), "float32": (1e-4, 1e-4),
           "bfloat16_wgmma": (1e-2, 2e-2)}
FWD_L2_RTOL = {"bfloat16": 1e-3, "float32": 1e-5, "bfloat16_wgmma": 5e-3}
LSE_ATOL = {"bfloat16": 1e-3, "float32": 1e-4}
#: Limits whose atol is a fraction of each row's RMS, not the tensor's.
ROW_ATOL = ("bfloat16_wgmma",)
#: (rtol, atol as a fraction of the reference's RMS) of the flash backward
#: kernels against the plain backward.  Both round f32 sums of the same
#: products, in another order, to the input dtype, so under bf16 they may
#: sit one bf16 step apart (at most 2^-7 relative); the atol only covers
#: entries near 0.  Beside it the whole tensor's relative L2 error is held
#: to BWD_L2_RTOL.
#: The tensor-core dQ and dK/dV kernels ("bfloat16_wgmma") round dz (dQ:
#: before dz . k) and p and dz (dK/dV: before p^T . dO and dz^T . q) to
#: bf16.  dQ sums its rounded dz . k terms over the keys as dK sums its
#: dz^T . q terms over the queries, each term carrying the same 1.7e-3
#: relative RMS error, so FWD_TOL's reasoning gives both the limits of the
#: tensor-core forward.
BWD_TOL = {"bfloat16": (1e-2, 1e-3), "float32": (1e-4, 1e-4),
           "bfloat16_wgmma": FWD_TOL["bfloat16_wgmma"]}
BWD_L2_RTOL = {"bfloat16": 1e-3, "float32": 1e-5,
               "bfloat16_wgmma": FWD_L2_RTOL["bfloat16_wgmma"]}
#: Floor of dQ's atol, as a fraction of the tensor's RMS.  The first query
#: row of a causal head sees one key, so its dz = p (dp - delta) with delta
#: = p dp is 0 in exact arithmetic and, on both sides, the f32 noise of two
#: sums of the same products (an RMS near 2e-7, against 0.02-0.05 for the
#: next row).  A per-row atol would hold that noise to noise, so dQ's is
#: never below BWD_TOL["bfloat16"]'s atol, what a kernel whose only error is
#: the order of its f32 sums is held to.  Only such degenerate rows reach
#: the floor.  It floors a per-row atol only (ROW_ATOL, the tensor-core
#: route): a tensor-wide atol, as the f32-FMA route's 1e-4 x RMS, stays as
#: BWD_TOL gives it.
DQ_ATOL_FLOOR_RMS = BWD_TOL["bfloat16"][1]


#: Wall clock at the start of the script: each phase line carries the
#: seconds since (``elapsed_s``).
START = time.perf_counter()


def emit(obj) -> None:
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.perf_counter() - START}
    print(json.dumps(obj), flush=True)


def time_ms(fn, iters: int) -> float:
    """Device time per call: ``iters`` calls captured in one CUDA graph and
    replayed between two CUDA events, so the host's launch cost is left
    out (eager calls of small kernels are bound by it; see
    ``eager_ms``)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def eager_ms(fn, iters: int) -> float:
    """Time per call of ``iters`` eager calls between two CUDA events:
    the device time, or the host's issue time where that is longer."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, iters: int) -> float:
    """Host time per call, in us, of ``iters`` eager calls issued back to
    back: the Python and launch cost, which does not wait for the device
    while its queue holds the calls."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return us


def bound(bytes_moved: float, ops: float, dtype: str):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_violation(got, want, rtol, atol) -> float:
    """max(|got - want| - (atol + rtol |want|)); <= 0 is within tolerance."""
    g, w = got.float(), want.float()
    return float(((g - w).abs() - (atol + rtol * w.abs())).max())


#: (rows, d, dtype) of the RMSNorm checks.  At d = 4096 (Llama-2-7B): a
#: serve tick's 4 slots, 16 rows, a 2048-token prefill and the training
#: step's microbatch of 4096 tokens.  At d = 768 (the 124M config): the
#: trainer's 8 x 1024 tokens, at float32 (train_124m_f32) and bf16 (the
#: trainer processes of resume_124m and after).
RMS_CASES = [(4, 4096, "bfloat16"), (4, 4096, "float32"),
             (16, 4096, "bfloat16"), (16, 4096, "float32"),
             (2048, 4096, "bfloat16"), (2048, 4096, "float32"),
             (4096, 4096, "bfloat16"), (8192, 768, "float32"),
             (8192, 768, "bfloat16")]


def copies_for(nbytes: int, l2_bytes: int) -> int:
    """Copies of an input of ``nbytes`` that together hold twice the L2
    cache of ``l2_bytes``."""
    return max(2, math.ceil(2 * l2_bytes / nbytes))


def rotating(fn, xs):
    """``fn`` applied to the next of the inputs ``xs`` at each call."""
    turn = itertools.cycle(range(len(xs)))
    return lambda: fn(xs[next(turn)])


def check_rmsnorm(torch, F, fused):
    """The kernel against its plain version at RMS_CASES.  Every timed call
    (kernel, plain version, ``F.rms_norm``) takes the next of n copies of
    the input that together hold twice the L2 cache, so no call finds its
    input in L2; at least 200 (50 for the larger shapes) calls, and a
    whole number of turns of the rotation.  ``l2_ms`` and
    ``library_l2_ms`` replay one input, which stays in L2 where it fits,
    as a serve tick's freshly written hidden state does (and as earlier
    runs timed every case)."""
    cases = []
    dev = torch.device("cuda")
    l2_bytes = torch.cuda.get_device_properties(dev).L2_cache_size
    gen = torch.Generator(device=dev).manual_seed(0)
    for rows, d, dname in RMS_CASES:
        dtype = getattr(torch, dname)
        x = torch.randn(rows, d, generator=gen, device=dev).to(dtype)
        scale = 1.0 + 0.5 * torch.randn(d, generator=gen, device=dev)
        got = fused.rmsnorm_kernel(x, scale, EPS)
        want = fused.rmsnorm_reference(x, scale, EPS)
        torch.cuda.synchronize()
        rtol, atol = OUT_TOL[dname]
        err = float((got.float() - want.float()).abs().max())
        if max_violation(got, want, rtol, atol) > 0:
            raise AssertionError(f"rmsnorm [{rows}, {d}] {dname}: "
                                 f"max abs err {err} over tolerance")
        n_copies = copies_for(x.numel() * x.element_size(), l2_bytes)
        xs = x.expand(n_copies, rows, d).contiguous()
        base = 200 if rows * d < 2048 * 4096 else 50
        iters = n_copies * math.ceil(base / n_copies)
        scale_x = scale.to(dtype)
        esize = x.element_size()
        t_bound, by = bound(2 * rows * d * esize + d * 4, 4 * rows * d,
                            "float32")

        def timed(fn, timer=time_ms):
            return timer(rotating(fn, xs), iters)
        cases.append({
            "shape": [rows, d], "dtype": dname,
            "plan": fused.rmsnorm_plan(rows, d, esize),
            "max_abs_err": err, "rtol": rtol, "atol": atol,
            "rotation": n_copies, "l2_bytes": l2_bytes, "iters": iters,
            "ms": timed(lambda a: fused.rmsnorm_kernel(a, scale, EPS)),
            "eager_ms": timed(lambda a: fused.rmsnorm_kernel(a, scale, EPS),
                              eager_ms),
            "plain_ms": timed(
                lambda a: fused.rmsnorm_reference(a, scale, EPS)),
            "library_ms": timed(lambda a: F.rms_norm(a, (d,), scale_x, EPS)),
            "l2_ms": time_ms(lambda: fused.rmsnorm_kernel(x, scale, EPS),
                             base),
            "library_l2_ms": time_ms(
                lambda: F.rms_norm(x, (d,), scale_x, EPS), base),
            "bound_ms": t_bound, "bound_by": by})
        del x, xs, got, want
        torch.cuda.empty_cache()
    return cases


def visible_pairs(T: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask leaves visible: the work that counts."""
    if not causal:
        return T * T
    if not window:
        return T * (T + 1) // 2
    return sum(min(i + 1, window) for i in range(T))


FLASH_CASES = [
    # (B, T, Hq, Hkv, D, causal, window, dtype)
    (1, 512, 32, 32, 128, True, 0, "bfloat16"),
    (1, 1000, 32, 32, 128, True, 0, "bfloat16"),
    (1, 2048, 32, 32, 128, True, 0, "bfloat16"),
    (1, 2048, 32, 8, 128, True, 0, "bfloat16"),
    (1, 2048, 32, 32, 128, True, 256, "bfloat16"),
    (1, 1000, 32, 32, 16, True, 0, "float32"),
    # The training path's microbatch (train_7b_width).
    (1, 4096, 32, 32, 128, True, 0, "bfloat16"),
    # base_124m's head dim.
    (4, 1024, 12, 12, 64, True, 0, "bfloat16"),
    # Mixtral-8x7B's GQA 32/8: the MoE training path (train_moe_width) and
    # the generate prefill (generate_moe_width).
    (1, 4096, 32, 8, 128, True, 0, "bfloat16"),
    (1, 512, 32, 8, 128, True, 0, "bfloat16"),
    # A ring block of Llama-2-7B attention (ring_7b_width): an earlier KV
    # block runs the kernels unmasked, MHA and GQA 32/8.
    (1, 4096, 32, 32, 128, False, 0, "bfloat16"),
    (1, 4096, 32, 8, 128, False, 0, "bfloat16"),
    # float32 runs take the f32-FMA kernels at every head dim: the 124M
    # trainer at LLAMA_DTYPE=float32 (train_124m_f32), GQA 32/8 at head dim
    # 128, and a window.
    (8, 1024, 12, 12, 64, True, 0, "float32"),
    (1, 2048, 32, 8, 128, True, 0, "float32"),
    (1, 2048, 32, 32, 128, True, 256, "float32"),
    # bf16 at head dims 16 and 32 (the tiny config's) also takes them.
    (1, 1000, 32, 32, 16, True, 0, "bfloat16"),
    (1, 1000, 32, 32, 32, True, 0, "bfloat16"),
]
#: FLASH_CASES entry of the training path's attention shape.
TRAIN_FLASH_CASE = 6


#: FLASH_CASES entry of the f32-FMA kernels' main path (train_124m_f32).
FMA_FLASH_CASE = 12


def flash_iters(T: int) -> int:
    return 5 if T >= 4096 else 20 if T >= 1000 else 50


def rates(ops: float, ms: float, bound_ms: float) -> dict:
    """Achieved TFLOP/s and the share of the bound a kernel time reaches."""
    return {"tflops": ops / ms / 1e9, "bound_share": bound_ms / ms}


def launched(torch, fn, key: str, kernel: str):
    """Run ``fn`` once from zeroed counters; raise unless it launched the
    kernel ``key`` once, on the tensor-core route where ``kernel`` is
    "wgmma" (a kernel with one route passes any other name)."""
    from trainingjob_operator_tpu_torch import ops

    ops.reset_launch_counts()
    result = fn()
    counts = ops.launch_counts()
    tc = counts.get(f"{key}_wgmma", 0)
    if counts[key] != 1 or tc != (kernel == "wgmma"):
        raise AssertionError(f"{key}: launches {counts}, expected one "
                             f"{kernel} launch")
    return result


def check_flash(torch, F, flash):
    cases = []
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    for B, T, H, Hkv, D, causal, window, dname in FLASH_CASES:
        dtype = getattr(torch, dname)
        q = torch.randn(B, T, H, D, generator=gen, device=dev).to(dtype)
        k = torch.randn(B, T, Hkv, D, generator=gen, device=dev).to(dtype)
        v = torch.randn(B, T, Hkv, D, generator=gen, device=dev).to(dtype)
        scale = D ** -0.5
        kernel = flash.fwd_plan(q, k, v)["kernel"]
        out, lse = launched(torch, lambda: flash.flash_kernel_with_lse(
            q, k, v, causal=causal, scale=scale, window=window),
            "flash_attention_fwd", kernel)
        want, want_lse = flash.flash_reference_with_lse(
            q, k, v, causal=causal, scale=scale, window=window)
        torch.cuda.synchronize()
        out_err = fwd_check(torch, out, want, limits(dname, kernel))
        lse_err = float((lse - want_lse).abs().max())
        tag = f"flash B={B} T={T} H={H}/{Hkv} D={D} w={window} {dname}"
        if not out_err["ok"]:
            raise AssertionError(f"{tag}: out {out_err}")
        if lse_err > LSE_ATOL[dname] or not torch.isfinite(lse).all():
            raise AssertionError(f"{tag}: lse max abs err {lse_err}")
        iters = flash_iters(T)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa = sdpa_fn(torch, F, T, H, Hkv, causal, window, scale)

        def library():
            return sdpa(qt, kt, vt)
        esize = q.element_size()
        bytes_moved = (2 * B * H * T * D + 2 * B * Hkv * T * D) * esize \
            + B * H * T * 4
        ops = 4 * B * H * D * visible_pairs(T, causal, window)
        t_bound, by = bound(bytes_moved, ops, dname)
        ms = time_ms(lambda: flash.flash_kernel_with_lse(
            q, k, v, causal=causal, scale=scale, window=window), iters)
        cases.append({
            "B": B, "T": T, "Hq": H, "Hkv": Hkv, "D": D, "causal": causal,
            "window": window, "dtype": dname, "kernel": kernel,
            "max_abs_err": out_err["max_abs_err"], "out": out_err,
            "lse_max_abs_err": lse_err, "lse_atol": LSE_ATOL[dname],
            "ms": ms, **rates(ops, ms, t_bound),
            "eager_ms": eager_ms(lambda: flash.flash_kernel_with_lse(
                q, k, v, causal=causal, scale=scale, window=window), iters),
            "plain_ms": time_ms(lambda: flash.flash_reference_with_lse(
                q, k, v, causal=causal, scale=scale, window=window),
                3),
            "library_ms": time_ms(library, iters),
            "bound_ms": t_bound, "bound_by": by})
        del q, k, v, out, lse, want, want_lse
        torch.cuda.empty_cache()
    return cases


def sdpa_fn(torch, F, T, H, Hkv, causal, window, scale):
    """The one-call PyTorch yardstick for a flash case: SDPA over [B, H, T,
    D] with the same mask (a boolean band for a window)."""
    mask = None
    if window:
        rows = torch.arange(T, device="cuda")[:, None]
        cols = torch.arange(T, device="cuda")[None, :]
        mask = (cols <= rows) & (cols > rows - window)

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, is_causal=causal and not window,
            scale=scale, enable_gqa=H != Hkv)
    return sdpa


def limits(dname: str, kernel: str) -> str:
    """Key of the tolerance tables for a kernel route (``fwd_plan`` /
    ``dkv_plan``'s "fma" or "wgmma") and dtype."""
    return f"{dname}_wgmma" if kernel == "wgmma" else dname


def grad_check(torch, got, want, key, atol_floor_rms: float = 0.0) -> dict:
    """How far a backward kernel's gradient lies from the plain one, at
    BWD_TOL and BWD_L2_RTOL (dQ: with DQ_ATOL_FLOOR_RMS as
    ``atol_floor_rms``, which binds on the per-row limits only);
    ``tol_used`` > 1 or ``ok`` false fails."""
    return close_check(torch, got, want, *BWD_TOL[key], BWD_L2_RTOL[key],
                       per_row=key in ROW_ATOL,
                       atol_floor_rms=atol_floor_rms)


def fwd_check(torch, got, want, key) -> dict:
    """How far the flash forward's output lies from the plain one, at
    FWD_TOL and FWD_L2_RTOL (as ``grad_check``)."""
    return close_check(torch, got, want, *FWD_TOL[key], FWD_L2_RTOL[key],
                       per_row=key in ROW_ATOL)


def close_check(torch, got, want, rtol, atol_rms, l2_rtol,
                per_row: bool = False, atol_floor_rms: float = 0.0) -> dict:
    """|got - want| <= atol + rtol |want| elementwise, with atol =
    ``atol_rms`` x the RMS of ``want`` (where ``per_row``: of each row over
    the last dim, but at least ``atol_floor_rms`` x the tensor's RMS; the
    floor leaves a tensor-wide atol as it is), and the relative L2 error
    at most ``l2_rtol``.  Reports max|want|, the RMS, the share of the
    elementwise tolerance used and the L2 error; ``ok`` is the verdict."""
    g, w = got.float(), want.float()
    rms = float(w.square().mean().sqrt())
    if per_row:
        atol = (atol_rms * w.square().mean(-1, keepdim=True).sqrt()
                ).clamp_min(atol_floor_rms * rms)
    else:
        atol, atol_floor_rms = atol_rms * rms, 0.0
    diff = (g - w).abs()
    rel_l2 = float((g - w).norm() / w.norm())
    # Where want is exactly 0 in a row of zeros, only an exact 0 passes.
    tol_used = float((diff / (atol + rtol * w.abs()).clamp_min(1e-30)).max())
    return {"max_abs_err": float(diff.max()),
            "want_max_abs": float(w.abs().max()), "want_rms": rms,
            "rtol": rtol, "atol_rms": atol_rms,
            "atol_rms_of": "row" if per_row else "tensor",
            "atol_floor_rms": atol_floor_rms,
            "tol_used": tol_used, "rel_l2_err": rel_l2,
            "rel_l2_rtol": l2_rtol,
            "ok": bool(torch.isfinite(g).all()) and tol_used <= 1.0
            and rel_l2 <= l2_rtol}


def check_flash_bwd(torch, F, flash):
    """dQ and dK/dV kernels against the plain backward at FLASH_CASES, from
    the forward kernel's out and LSE and a random dO, at BWD_TOL.  Bounds:
    dQ does 6 D flops per visible pair (z, dp, dq) and dK/dV 8 D (z, dp,
    dk, dv); each
    reads q, k, v, dO, lse and delta once and writes its gradients once.
    The library yardstick is SDPA's backward, dq, dk and dv in one call,
    isolated from its forward: the forward runs once, untimed, and its
    retained graph is differentiated again in each timed call (eager,
    between CUDA events)."""
    dq_cases, dkv_cases = [], []
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    for B, T, H, Hkv, D, causal, window, dname in FLASH_CASES:
        dtype = getattr(torch, dname)
        q = torch.randn(B, T, H, D, generator=gen, device=dev).to(dtype)
        k = torch.randn(B, T, Hkv, D, generator=gen, device=dev).to(dtype)
        v = torch.randn(B, T, Hkv, D, generator=gen, device=dev).to(dtype)
        do = torch.randn(B, T, H, D, generator=gen, device=dev).to(dtype)
        opts = dict(causal=causal, scale=D ** -0.5, window=window)
        out, lse = flash.flash_kernel_with_lse(q, k, v, **opts)
        delta = flash.flash_delta(do, out)
        args = (q, k, v, do, lse, delta)
        kernel = flash.dkv_plan(q, k, v, do)["kernel"]
        dq_kernel = flash.dq_plan(q, k, v, do)["kernel"]
        dq = launched(torch, lambda: flash.flash_bwd_dq_kernel(*args, **opts),
                      "flash_attention_bwd_dq", dq_kernel)
        dk, dv = launched(
            torch, lambda: flash.flash_bwd_dkv_kernel(*args, **opts),
            "flash_attention_bwd_dkv", kernel)
        want_dq = flash.flash_bwd_dq_reference(*args, **opts)
        want_dk, want_dv = flash.flash_bwd_dkv_reference(*args, **opts)
        deterministic_dq = torch.equal(
            dq, flash.flash_bwd_dq_kernel(*args, **opts))
        deterministic_dkv = all(torch.equal(a, b) for a, b in zip(
            (dk, dv), flash.flash_bwd_dkv_kernel(*args, **opts)))
        torch.cuda.synchronize()
        tag = f"flash bwd B={B} T={T} H={H}/{Hkv} D={D} w={window} {dname}"
        errs = {}
        for name, got, want, key, floor in (
                ("dq", dq, want_dq, limits(dname, dq_kernel),
                 DQ_ATOL_FLOOR_RMS),
                ("dk", dk, want_dk, limits(dname, kernel), 0.0),
                ("dv", dv, want_dv, limits(dname, kernel), 0.0)):
            errs[name] = grad_check(torch, got, want, key, floor)
            if not errs[name]["ok"]:
                raise AssertionError(f"{tag}: {name} {errs[name]}")
        if not (deterministic_dq and deterministic_dkv):
            raise AssertionError(f"{tag}: a second run differs "
                                 f"(dq {deterministic_dq}, dk/dv "
                                 f"{deterministic_dkv})")
        iters = flash_iters(T)
        qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_(True)
                      for x in (q, k, v))
        lib_out = sdpa_fn(torch, F, T, H, Hkv, causal, window,
                          opts["scale"])(qt, kt, vt)
        lib_do = do.transpose(1, 2)
        library_ms = eager_ms(lambda: torch.autograd.grad(
            lib_out, (qt, kt, vt), lib_do, retain_graph=True), iters)
        del lib_out
        esize = q.element_size()
        pairs = B * H * visible_pairs(T, causal, window)
        q_bytes = B * H * T * D * esize
        kv_bytes = B * Hkv * T * D * esize
        stat_bytes = 2 * B * H * T * 4
        common = {"B": B, "T": T, "Hq": H, "Hkv": Hkv, "D": D,
                  "causal": causal, "window": window, "dtype": dname,
                  "deterministic": True, "library_ms": library_ms}
        t_bound, by = bound(3 * q_bytes + 2 * kv_bytes + stat_bytes,
                            6 * D * pairs, dname)
        ms = time_ms(lambda: flash.flash_bwd_dq_kernel(*args, **opts), iters)
        dq_cases.append({
            **common, "kernel": dq_kernel,
            "max_abs_err": errs["dq"]["max_abs_err"], "dq": errs["dq"],
            "ms": ms, **rates(6 * D * pairs, ms, t_bound),
            "eager_ms": eager_ms(
                lambda: flash.flash_bwd_dq_kernel(*args, **opts), iters),
            "plain_ms": time_ms(
                lambda: flash.flash_bwd_dq_reference(*args, **opts), 3),
            "bound_ms": t_bound, "bound_by": by})
        t_bound, by = bound(2 * q_bytes + 4 * kv_bytes + stat_bytes,
                            8 * D * pairs, dname)
        ms = time_ms(lambda: flash.flash_bwd_dkv_kernel(*args, **opts),
                     iters)
        dkv_cases.append({
            **common, "kernel": kernel,
            "max_abs_err": max(errs["dk"]["max_abs_err"],
                               errs["dv"]["max_abs_err"]),
            "dk": errs["dk"], "dv": errs["dv"],
            "ms": ms, **rates(8 * D * pairs, ms, t_bound),
            "eager_ms": eager_ms(
                lambda: flash.flash_bwd_dkv_kernel(*args, **opts), iters),
            "plain_ms": time_ms(
                lambda: flash.flash_bwd_dkv_reference(*args, **opts), 3),
            "bound_ms": t_bound, "bound_by": by})
        del q, k, v, do, out, lse, delta, dq, dk, dv, want_dq, want_dk
        del want_dv, qt, kt, vt, lib_do
        torch.cuda.empty_cache()
    return dq_cases, dkv_cases


#: (rtol, atol) of the decode attention against its plain version.  Both
#: compute in f32 from the same inputs (bf16 widens exactly) and differ in
#: summation order and exp2's last bits, about 1e-6 of the output: f32
#: within 1e-4 relative, and 1e-5 absolute where the output is near 0
#: (its terms reach max|v|); a bf16 output may then round one bf16 step
#: apart, at most 2^-7 of its magnitude.
DECODE_TOL = {"float32": (1e-4, 1e-5), "bfloat16": (2 ** -7, 1e-5)}
#: (B, S, Hkv, group, Dh, fill, dtype) of the decode attention's checks:
#: the serving cell's slice (Mistral-7B: 32 slots of 2048, GQA 32/8) with
#: every slot visible ("full": ts = S - 1) and at a ragged half fill
#: ("half": ts drawn from 0 .. S - 1, mean about S / 2), and
#: ``generate``'s one row at position 512 (an int t: 3 splits of the 513
#: visible slots).
DECODE_CASES = [(32, 2048, 8, 4, 128, "full", "bfloat16"),
                (32, 2048, 8, 4, 128, "half", "bfloat16"),
                (1, 2048, 8, 4, 128, 512, "bfloat16")]
#: Layer slices the timed calls rotate through, so no call finds the
#: previous one's cache in L2 (a decode step reads each layer's once).
DECODE_LAYERS = 4


def check_decode_attention(torch, F, da):
    """The decode attention kernel against its plain version at
    DECODE_CASES within DECODE_TOL, and timed over a rotation of
    DECODE_LAYERS cache slices.  Bound: the visible positions' keys and
    values, q and the output once each, against 4 flops a query head,
    position and head-dim element (scores and P.V).  The yardstick is one
    ``F.scaled_dot_product_attention`` call over the same slice (GQA, a
    boolean mask of the visible slots), which the port never calls.
    ``host_us`` and ``plain_host_us``: the host's time a call of the
    kernel's wrapper and of the plain version (``host_us``)."""
    cases = []
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(9)
    for B, S, Hkv, group, D, fill, dname in DECODE_CASES:
        dtype = getattr(torch, dname)
        shape = (DECODE_LAYERS, B, S, Hkv, D)
        ks = torch.randn(shape, generator=gen, device=dev).to(dtype)
        vs = torch.randn(shape, generator=gen, device=dev).to(dtype)
        q = torch.randn(B, 1, Hkv * group, D, generator=gen,
                        device=dev).to(dtype)
        if fill == "full":
            t = torch.full((B,), S - 1, dtype=torch.long, device=dev)
        elif fill == "half":
            t = torch.randint(0, S, (B,), generator=gen, device=dev)
        else:
            t = fill
        nvis = (t + 1).clamp(max=S).sum().item() if isinstance(
            t, torch.Tensor) else B * min(t + 1, S)
        got = launched(torch, lambda: da.decode_attention_kernel(
            q, ks[0], vs[0], t, group), "decode_attention", "cuda")
        want = da.attend_cache_reference(q, ks[0], vs[0], t, group)
        torch.cuda.synchronize()
        rtol, atol = DECODE_TOL[dname]
        err = float((got.float() - want).abs().max())
        tag = f"decode attention B={B} S={S} {Hkv}x{group} D={D} {fill}"
        if (max_violation(got, want, rtol, atol) > 0
                or not torch.isfinite(got).all()):
            raise AssertionError(f"{tag}: max abs err {err} over tolerance")
        turn = itertools.cycle(range(DECODE_LAYERS))

        def rotated(fn):
            def call():
                i = next(turn)
                return fn(ks[i], vs[i])
            return call
        slots = torch.arange(S, device=dev)
        tt = t.view(B, 1, 1, 1) if isinstance(t, torch.Tensor) else t
        mask = slots.view(1, 1, 1, S) <= tt
        qt = q.transpose(1, 2)

        def library(k, v):
            return F.scaled_dot_product_attention(
                qt, k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask,
                enable_gqa=group > 1)
        esize = q.element_size()
        bytes_moved = (2 * nvis * Hkv * D + 2 * B * Hkv * group * D) * esize
        ops = 4 * nvis * Hkv * group * D
        t_bound, by = bound(bytes_moved, ops, dname)
        iters = 20 * DECODE_LAYERS
        ms = time_ms(rotated(lambda k, v: da.decode_attention_kernel(
            q, k, v, t, group)), iters)
        cases.append({
            "B": B, "S": S, "Hkv": Hkv, "group": group, "D": D,
            "fill": fill, "dtype": dname, "visible": int(nvis),
            "plan": da.decode_attention_plan(B, Hkv, S, D, group, dtype,
                                             da.visible_slots(t, S)),
            "max_abs_err": err, "rtol": rtol, "atol": atol,
            "ms": ms, **rates(ops, ms, t_bound),
            "eager_ms": eager_ms(rotated(
                lambda k, v: da.decode_attention_kernel(q, k, v, t, group)),
                iters),
            "plain_ms": time_ms(rotated(
                lambda k, v: da.attend_cache_reference(
                    q, k, v, t, group).to(dtype)), DECODE_LAYERS),
            "host_us": host_us(rotated(
                lambda k, v: da.decode_attention_kernel(q, k, v, t, group)),
                iters),
            "plain_host_us": host_us(rotated(
                lambda k, v: da.attend_cache_reference(
                    q, k, v, t, group).to(dtype)), DECODE_LAYERS),
            "library_ms": time_ms(rotated(library), iters),
            "bound_ms": t_bound, "bound_by": by})
        del ks, vs, q, got, want, mask
        torch.cuda.empty_cache()
    return cases


#: (rtol, atol as a share of the reference's RMS) of the grouped expert
#: products against their plain version: both sum f32 products of the same
#: bf16 operands in another order and round at the same points (the
#: products, silu, the gated product, the output), so an output may land
#: one bf16 step apart.
MOE_EXPERT_TOL = (2 ** -7, 2 ** -9)
#: (N rows, k, E, D, F, padded rows, name) of the grouped expert products'
#: checks: the routed serving cell's decode step (32 slots) and chunk (256
#: rows) at Mixtral-8x7B's widths, each row's k experts drawn at random,
#: and a prompt's last chunk, whose padding rows (the same token) all choose
#: one pair of experts (3 and 5): here 128 of them, so two experts hold
#: about 160 rows each.
MOE_EXPERT_CASES = [(32, 2, 8, 4096, 14336, 0, "decode"),
                    (256, 2, 8, 4096, 14336, 0, "chunk"),
                    (256, 2, 8, 4096, 14336, 128, "last chunk")]


def check_moe_experts(torch, F, me):
    """The grouped expert kernels (gate/up, then down) against their plain
    version at MOE_EXPERT_CASES within MOE_EXPERT_TOL, timed.  Bound: the
    reached experts' three matrices and the pairs' rows in and out, once
    each (``benchmark/flops_moe.py``'s count), against 6 D F flops a pair.
    ``plain_ms``: the plain version, which reads the counts to the host;
    ``library_ms``: the same cuBLAS loop over the experts with the counts
    already on the host, captured in a CUDA graph (the port calls
    neither on the card)."""
    cases = []
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    for N, k, E, D, Fd, pad, name in MOE_EXPERT_CASES:
        dtype = torch.bfloat16
        ws = [(torch.randn(E, a, b, generator=gen, device=dev) * a ** -0.5)
              .to(dtype) for a, b in ((D, Fd), (D, Fd), (Fd, D))]
        x = torch.randn(N, D, generator=gen, device=dev).to(dtype)
        pick = torch.rand(N, E, generator=gen, device=dev).argsort(dim=-1)
        pick[N - pad:, 0], pick[N - pad:, 1] = 3, 5
        pairs = pick[:, :k].reshape(-1)
        order = torch.argsort(pairs, stable=True)
        counts = torch.bincount(pairs, minlength=E)
        ends = torch.cumsum(counts, 0)
        xs = x[order // k].contiguous()
        args = (xs, ends, order, *ws)
        got = launched(torch, lambda: me.grouped_experts_kernel(*args),
                       "moe_experts_gate_up", "cuda")
        want = me.grouped_experts_reference(*args)
        torch.cuda.synchronize()
        rtol, atol_rms = MOE_EXPERT_TOL
        atol = atol_rms * float(want.float().pow(2).mean().sqrt())
        err = float((got.float() - want.float()).abs().max())
        tag = f"moe experts {name} N={N} k={k} E={E} D={D} F={Fd}"
        if (max_violation(got, want, rtol, atol) > 0
                or not torch.isfinite(got).all()):
            raise AssertionError(f"{tag}: max abs err {err} over tolerance")
        if not torch.equal(got, me.grouped_experts_kernel(*args)):
            raise AssertionError(f"{tag}: a second run differs")
        host_ends = [0] + ends.tolist()
        w_gate, w_up, w_down = ws

        def library():
            y = xs.new_empty((N * k, D))
            for e in range(E):
                a, b = host_ends[e], host_ends[e + 1]
                if b > a:
                    xe = xs[a:b]
                    y[order[a:b]] = (F.silu(xe @ w_gate[e])
                                     * (xe @ w_up[e])) @ w_down[e]
            return y
        reached = int((counts > 0).sum())
        bytes_moved = reached * 3 * D * Fd * 2 + N * k * 2 * D * 2
        ops = N * k * 6 * D * Fd
        t_bound, by = bound(bytes_moved, ops, "bfloat16")
        iters = 20
        ms = time_ms(lambda: me.grouped_experts_kernel(*args), iters)
        cases.append({
            "case": name, "N": N, "k": k, "E": E, "D": D, "F": Fd,
            "pad": pad,
            "dtype": "bfloat16", "reached": reached,
            "rows_max": int(counts.max()),
            "plan": me.moe_experts_plan(N, k, E, D, Fd, dtype),
            "max_abs_err": err, "rtol": rtol, "atol": atol,
            "ms": ms, **rates(ops, ms, t_bound),
            "eager_ms": eager_ms(lambda: me.grouped_experts_kernel(*args),
                                 iters),
            "plain_ms": eager_ms(lambda: me.grouped_experts_reference(*args),
                                 5),
            "host_us": host_us(lambda: me.grouped_experts_kernel(*args),
                               iters),
            "library_ms": time_ms(library, iters),
            "bound_ms": t_bound, "bound_by": by})
        del ws, w_gate, w_up, w_down, x, xs, got, want, args
        torch.cuda.empty_cache()
    return cases


def train_launches(L: int, remat: str, micro_steps: int,
                   tensor_cores: bool = False):
    """Kernel launches of ``micro_steps`` microbatch steps of an L-layer
    model (phase 4's formula); with ``tensor_cores`` (bf16 at head dim 64
    or 128) every flash forward, dQ and dK/dV launch is a tensor-core
    one.  Each layer launches one flash forward, dQ and dK/dV and two
    RMSNorms, plus the final RMSNorm.  Every remat policy re-runs a
    layer's two RMSNorms in the backward; "full" and "dots" re-run its
    flash forward too, while "attn" saves the forward's (out, lse)
    (tests/test_torch_remat.py).  Training never reaches the decode
    attention or the grouped expert kernels."""
    fwd = micro_steps * (2 if remat in ("full", "dots") else 1) * L
    return {"rmsnorm_fwd":
                micro_steps * ((2 if remat == "none" else 4) * L + 1),
            "flash_attention_fwd": fwd,
            "flash_attention_bwd_dq": micro_steps * L,
            "flash_attention_bwd_dkv": micro_steps * L,
            "flash_attention_fwd_wgmma": fwd if tensor_cores else 0,
            "flash_attention_bwd_dq_wgmma":
                micro_steps * L if tensor_cores else 0,
            "flash_attention_bwd_dkv_wgmma":
                micro_steps * L if tensor_cores else 0,
            "decode_attention": 0, "moe_experts_gate_up": 0,
            "moe_experts_down": 0}


def tiny_train_equivalence(torch, llama, llama_elastic, train):
    """fp32 tiny config, 5 steps of the trainer's step
    (``llama_elastic.make_step_fn``: accum 2, AdamW) through the kernels on
    the card and through the plain versions on the CPU."""
    base = llama.LlamaConfig.tiny()
    cfg = llama.LlamaConfig(**{**base.__dict__, "dtype": "float32"})
    init = llama.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                             master=True)
    return train_equivalence(torch, cfg, init, llama_elastic, train,
                             accum=2, what="tiny train")


def train_equivalence(torch, cfg, init, llama_elastic, train, *, accum,
                      what, loss_fn=None):
    """5 steps of the trainer's step (``llama_elastic.make_step_fn`` with
    ``loss_fn``) from the CPU parameters ``init``, under each remat policy,
    on the card and on the CPU: losses within 1e-4 relative, the first
    step's gradients at rtol = atol = 1e-4, launches by
    ``train_launches``."""
    from trainingjob_operator_tpu_torch import ops

    steps = 5
    batches = [torch.randint(0, cfg.vocab_size, (4, 65),
                             generator=torch.Generator().manual_seed(10 + i))
               for i in range(steps)]
    result = {}
    for remat in ("none", "full", "attn", "dots"):
        runs = {}
        for where in ("cpu", "cuda"):
            params = train.trainable_copy(init, where)
            step_fn = llama_elastic.make_step_fn(params, cfg, accum=accum,
                                                 lr=3e-4, remat=remat,
                                                 loss_fn=loss_fn)
            ops.reset_launch_counts()
            losses, first_grads = [], None
            for i, tokens in enumerate(batches):
                losses.append(float(step_fn(tokens.to(where))))
                if i == 0:
                    # The step leaves its gradients in the leaves' .grad,
                    # and the AdamW update does not clear them.
                    first_grads = [p.grad.detach().cpu().clone()
                                   for p in train.tree_leaves(params)]
            runs[where] = (losses, first_grads, ops.launch_counts())
        (cpu_l, cpu_g, cpu_n), (gpu_l, gpu_g, gpu_n) = runs["cpu"], \
            runs["cuda"]
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(gpu_l, cpu_l))
        grad_viol = max(max_violation(a, b, 1e-4, 1e-4)
                        for a, b in zip(gpu_g, cpu_g))
        grad_err = max(float((a - b).abs().max())
                       for a, b in zip(gpu_g, cpu_g))
        expected = train_launches(cfg.n_layers, remat, steps * accum)
        if loss_rel > 1e-4 or not all(map(math.isfinite, gpu_l)):
            raise AssertionError(f"{what} remat={remat}: losses "
                                 f"{gpu_l} vs {cpu_l}")
        if grad_viol > 0:
            raise AssertionError(f"{what} remat={remat}: step-1 "
                                 f"gradients differ by {grad_err}")
        if gpu_n != expected or any(cpu_n.values()):
            raise AssertionError(f"{what} remat={remat}: launches "
                                 f"{gpu_n} (cpu {cpu_n}), expected "
                                 f"{expected}")
        result[remat] = {"losses_cuda": gpu_l, "losses_cpu": cpu_l,
                         "loss_max_rel_err": loss_rel,
                         "grad_max_abs_err": grad_err, "launches": gpu_n}
    return {"steps": steps, "accum": accum, "loss_rtol": 1e-4,
            "grad_rtol": 1e-4, "grad_atol": 1e-4, **result}


def mesh_collectives(L: int, micro_steps: int, weights: int = 7,
                     sums: int = 4):
    """Collective launches of ``micro_steps`` microbatch steps of an
    L-layer model on a mesh under remat "none" (``parallel/
    collectives.py``).  A microbatch all-gathers each layer's ``weights``
    weights over fsdp, and tok_embed and lm_head over fsdp and tp;
    reduce-scatters the gradients of those ``weights`` L + 2 over fsdp;
    and all-reduces, a layer, ``sums`` times over a model axis and the
    gradients of the ``weights`` weights over dp, and once the loss over
    dp and fsdp, tok_embed's and lm_head's gradients over dp and those of
    the three norm scales over dp and fsdp.  Llama: 7 weights, and over tp
    the products of wo and w_down (forward) and the gradients of the two
    tp inputs (backward).  MoE (``moe_mesh_collectives``): 8 weights (the
    router too), and 8 sums."""
    return {"all_gather": micro_steps * (weights * L + 4),
            "reduce_scatter": micro_steps * (weights * L + 2),
            "all_reduce": micro_steps * ((weights + sums) * L + 10),
            "p2p": 0}


def moe_mesh_collectives(L: int, micro_steps: int):
    """``mesh_collectives`` of the MoE family: a layer sums wo's product
    and the gradient of its input over tp, and the experts' output and the
    gradients of their input and of the gates over tp and ep (one
    all-reduce per axis): 1 + 1 + 3 x 2 = 8."""
    return mesh_collectives(L, micro_steps, weights=8, sums=8)


def train_7b_width(torch, llama, llama_elastic, remat=None, mesh=None,
                   sequence_parallel=False):
    """The trainer's step at Llama-2-7B widths, 8 layers (see the module
    docstring), under ``remat`` (default: the trainer's default at 8
    layers, "none"), on ``mesh`` where given (its collectives counted),
    with ring attention where ``sequence_parallel``."""
    from trainingjob_operator_tpu_torch import ops
    from trainingjob_operator_tpu_torch.parallel import collectives
    from trainingjob_operator_tpu_torch.workloads import train

    dev = torch.device("cuda")
    cfg = dataclasses.replace(llama.LlamaConfig.llama2_7b(), n_layers=8)
    seq, batch, accum, steps, lr = 4096, 2, 2, 8, 3e-4
    remat = remat or train.default_remat(cfg.n_layers)
    t0 = time.perf_counter()
    params = llama.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev, master=True,
        mesh=mesh)
    for leaf in train.tree_leaves(params):
        leaf.requires_grad_(True)
    step_fn = llama_elastic.make_step_fn(params, cfg, accum=accum, lr=lr,
                                         remat=remat, mesh=mesh,
                                         sequence_parallel=sequence_parallel)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq + 1),
                           generator=gen, device=dev)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    collectives.reset_collective_counts()
    losses, step_s = [], []
    for _ in range(steps):
        t = time.perf_counter()
        losses.append(float(step_fn(tokens)))
        step_s.append(time.perf_counter() - t)
    counts = ops.launch_counts()
    sent = collectives.collective_counts()
    if mesh is not None:
        want = {k: n * steps for k, n in
                mesh_collectives(cfg.n_layers, accum).items()}
        if remat != "none" or sent != want:
            raise AssertionError(f"7B-width train on a mesh: collectives "
                                 f"{sent}, expected {want}")
    elif any(sent.values()):
        raise AssertionError(f"7B-width train: collectives {sent} without "
                             f"a mesh")
    peak = torch.cuda.max_memory_allocated()
    per_step = train_launches(cfg.n_layers, remat, accum, tensor_cores=True)
    if counts != {k: n * steps for k, n in per_step.items()}:
        raise AssertionError(f"7B-width train remat={remat}: launches "
                             f"{counts}, expected {per_step} per step x "
                             f"{steps}")
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"7B-width train remat={remat}: losses "
                             f"{losses}")
    steady = sorted(step_s[1:])[len(step_s[1:]) // 2]
    return {"n_layers": cfg.n_layers, "n_params": llama.num_params(cfg),
            "seq": seq, "global_batch": batch, "accum": accum,
            "remat": remat, "lr": lr, "init_s": init_s, "losses": losses,
            "step_s": step_s, "step_s_median": steady,
            "tokens_per_s": batch * seq / steady,
            "peak_mem_gib": peak / 2 ** 30,
            "launches_per_step": per_step, "launches": counts,
            "collectives": sent,
            "step_profile": profile_steps(torch, lambda: step_fn(tokens),
                                          n=2)}


#: Relative agreement of the 7B-width losses under remat "attn" and "dots"
#: with those under "none" (same parameters, same batch).  A policy changes
#: only what the backward keeps or recomputes, and the recompute runs the
#: same kernels on the same inputs, so the losses are expected bit for bit;
#: 1e-3 is one bf16 rounding of an activation, the most a recompute in
#: another order could move a loss, and is what the check allows.
REMAT_LOSS_RTOL = 1e-3


def remat_7b_width(torch, llama, llama_elastic, none):
    """``train_7b_width`` under remat "attn" and "dots", each against the
    "none" run ``none``: losses within REMAT_LOSS_RTOL, launches by
    ``train_launches`` (every flash launch on the tensor cores)."""
    out = {"loss_rtol": REMAT_LOSS_RTOL,
           "none": {k: none[k] for k in ("step_s_median", "tokens_per_s",
                                         "peak_mem_gib", "losses")}}
    for remat in ("attn", "dots"):
        torch.cuda.empty_cache()
        run = train_7b_width(torch, llama, llama_elastic, remat=remat)
        rel = max(abs(a - b) / abs(b)
                  for a, b in zip(run["losses"], none["losses"]))
        if not rel <= REMAT_LOSS_RTOL:
            raise AssertionError(f"7B-width remat={remat}: losses "
                                 f"{run['losses']} vs none "
                                 f"{none['losses']}")
        run["loss_max_rel_err_vs_none"] = rel
        run["losses_equal_none"] = run["losses"] == none["losses"]
        out[remat] = run
    return out


#: Relative agreement of the mesh path's 7B-width losses at world 1 with
#: the single-card path's: the same kernels on the same numbers, with
#: collectives over one rank (copies, and sums of one term) in between, so
#: the losses are expected bit for bit.
SHARDED_LOSS_RTOL = 1e-6


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def on_group_of_one(torch, run, plain, what, vs="single_card", **mesh_args):
    """``run(mesh)`` through the multi-process path at world 1: the
    process group formed by ``rendezvous.initialize_distributed`` on NCCL,
    the mesh of ``mesh_spec_from_rendezvous(**mesh_args)``, every
    collective launched over the group of one.  Its losses against the
    run ``plain`` (named ``vs``: the single-card run by default) within
    SHARDED_LOSS_RTOL; the step time and peak memory against it."""
    import torch.distributed as dist

    from trainingjob_operator_tpu_torch.parallel import mesh as pmesh
    from trainingjob_operator_tpu_torch.workloads import rendezvous

    rdv = rendezvous.Rendezvous(
        num_processes=1, process_id=0,
        coordinator_address=f"127.0.0.1:{free_port()}")
    t0 = time.perf_counter()
    device = rendezvous.initialize_distributed(rdv, torch.device("cuda"))
    try:
        mesh = pmesh.make_mesh(
            pmesh.mesh_spec_from_rendezvous(rdv, **mesh_args), device.type)
        group_s = time.perf_counter() - t0
        out = run(mesh)
    finally:
        dist.destroy_process_group()
    rel = max(abs(a - b) / abs(b)
              for a, b in zip(out["losses"], plain["losses"]))
    if not rel <= SHARDED_LOSS_RTOL:
        raise AssertionError(f"{what} on a mesh: losses {out['losses']} "
                             f"vs {vs} {plain['losses']}")
    return {**out, "backend": "nccl", "world": 1, "mesh": mesh.sizes,
            "group_s": group_s, "loss_rtol": SHARDED_LOSS_RTOL,
            f"loss_max_rel_err_vs_{vs}": rel,
            f"losses_equal_{vs}": out["losses"] == plain["losses"],
            f"step_s_ratio_vs_{vs}":
                out["step_s_median"] / plain["step_s_median"],
            f"peak_mem_gib_minus_{vs}":
                out["peak_mem_gib"] - plain["peak_mem_gib"]}


def sharded_7b_width(torch, llama, llama_elastic, plain):
    """``train_7b_width`` through the multi-process path at world 1
    (``on_group_of_one``): the sharded init and step on the mesh."""
    return on_group_of_one(
        torch, lambda mesh: train_7b_width(torch, llama, llama_elastic,
                                           mesh=mesh),
        plain, "7B-width train")


def sp_7b_width(torch, llama, llama_elastic, sharded):
    """``sharded_7b_width``'s step with ``sequence_parallel=True`` on the
    sp = 1 mesh of a group of one: attention through the ring's autograd
    Function and operator, its shifts at size 1 (none) and the remat
    policy's save; losses against ``sharded``'s within SHARDED_LOSS_RTOL
    (one causal block and a merge of one: bit for bit expected), no shift,
    the launches of ``train_launches``."""
    out = on_group_of_one(
        torch, lambda mesh: train_7b_width(torch, llama, llama_elastic,
                                           mesh=mesh, sequence_parallel=True),
        sharded, "7B-width sp train", vs="sharded", sequence_parallel=1)
    if out["collectives"]["p2p"] != 0 or out["mesh"].get("sp") != 1:
        raise AssertionError(f"7B-width sp train: mesh {out['mesh']}, "
                             f"collectives {out['collectives']}")
    return out


#: Ring attention at Llama-2-7B width: (Hq, Hkv) cases, the sequence, and
#: the virtual ranks it is split over.
RING_CASES = [(32, 32), (32, 8)]
RING_T, RING_SP = 16384, 4


def ring_7b_width(torch, flash):
    """The 4-rank ring of a 16,384-token sequence (Llama-2-7B attention, H
    32, D 128, bf16, B 1; MHA and GQA 32/8), its ranks played in turn in
    this process: for each virtual rank the ring's per-block forward over
    the KV blocks the ring brings it (``ringattention.ring_blocks``), the
    merge, and the per-block backward with the merged lse and delta, dK
    and dV summed at their block's rank.  Out, LSE, dQ, dK and dV against
    the whole-sequence kernels at T = 16,384 under the flash tolerances
    (FWD_TOL, LSE_ATOL, BWD_TOL; dQ with DQ_ATOL_FLOOR_RMS); launches 10
    forward, 10 dQ and 10 dK/dV, all tensor-core; the ring's summed
    kernel time against the whole-sequence kernels', and the merge's."""
    from trainingjob_operator_tpu_torch import ops
    from trainingjob_operator_tpu_torch.parallel import ringattention as ring

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    T, sp, D = RING_T, RING_SP, 128
    tl = T // sp
    scale = D ** -0.5
    cases = []
    for H, Hkv in RING_CASES:
        q, k, v, do = (torch.randn(1, T, h, D, generator=gen, device=dev)
                       .to(torch.bfloat16) for h in (H, Hkv, Hkv, H))
        opts = dict(causal=True, scale=scale, window=0)
        out, lse = flash.flash_kernel_with_lse(q, k, v, **opts)
        delta = flash.flash_delta(do, out)
        args = (q, k, v, do, lse, delta)
        want = {"out": out, "lse": lse,
                "dq": flash.flash_bwd_dq_kernel(*args, **opts)}
        want["dk"], want["dv"] = flash.flash_bwd_dkv_kernel(*args, **opts)

        def block(x, r):
            return x[:, r * tl:(r + 1) * tl]
        plan = [ring.ring_blocks(r, sp, causal=True) for r in range(sp)]

        def forwards():
            return [[ring.block_forward(block(q, r), block(k, src),
                                        block(v, src), diagonal=diag,
                                        scale=scale)
                     for _, src, diag in plan[r]] for r in range(sp)]

        def merges(parts):
            return [ring.merge_blocks(p) for p in parts]

        def backwards(merged):
            grads = []
            for r, (o, l) in enumerate(merged):
                d = flash.flash_delta(block(do, r), o)
                grads.append([(src, ring.block_backward(
                    block(q, r), block(k, src), block(v, src),
                    block(do, r), l, d, diagonal=diag, scale=scale))
                    for _, src, diag in plan[r]])
            return grads

        ops.reset_launch_counts()
        parts = forwards()
        merged = merges(parts)
        grads = backwards(merged)
        counts = ops.launch_counts()
        torch.cuda.synchronize()
        pairs = sum(len(p) for p in plan)
        want_counts = {"flash_attention_fwd": pairs,
                       "flash_attention_fwd_wgmma": pairs,
                       "flash_attention_bwd_dq": pairs,
                       "flash_attention_bwd_dq_wgmma": pairs,
                       "flash_attention_bwd_dkv": pairs,
                       "flash_attention_bwd_dkv_wgmma": pairs}
        if pairs != 10 or any(counts[key] != n
                              for key, n in want_counts.items()):
            raise AssertionError(f"ring {H}/{Hkv}: launches {counts}, "
                                 f"expected {want_counts}")
        dq = torch.cat([sum(g.float() for _, (g, _, _) in grads[r])
                        for r in range(sp)], dim=1)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=dev)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=dev)
        for r in range(sp):
            for src, (_, bk, bv) in grads[r]:
                block(dk, src).add_(bk)
                block(dv, src).add_(bv)
        got = {"out": torch.cat([o for o, _ in merged], dim=1),
               "lse": torch.cat([l for _, l in merged], dim=2),
               "dq": dq.to(q.dtype), "dk": dk.to(k.dtype),
               "dv": dv.to(v.dtype)}
        errs = {"out": fwd_check(torch, got["out"], want["out"],
                                 "bfloat16_wgmma")}
        for name, floor in (("dq", DQ_ATOL_FLOOR_RMS), ("dk", 0.0),
                            ("dv", 0.0)):
            errs[name] = grad_check(torch, got[name], want[name],
                                    "bfloat16_wgmma", floor)
        lse_err = float((got["lse"] - want["lse"]).abs().max())
        tag = f"ring T={T} sp={sp} H={H}/{Hkv}"
        for name, err in errs.items():
            if not err["ok"]:
                raise AssertionError(f"{tag}: {name} {err}")
        if not lse_err <= LSE_ATOL["bfloat16"]:
            raise AssertionError(f"{tag}: lse max abs err {lse_err}")
        whole_fwd = time_ms(lambda: flash.flash_kernel_with_lse(
            q, k, v, **opts), 3)
        whole_dq = time_ms(lambda: flash.flash_bwd_dq_kernel(*args, **opts),
                           3)
        whole_dkv = time_ms(
            lambda: flash.flash_bwd_dkv_kernel(*args, **opts), 3)
        ring_fwd = time_ms(forwards, 2)
        merge_ms = time_ms(lambda: merges(parts), 2)
        ring_bwd = time_ms(lambda: backwards(merged), 2)
        cases.append({
            "T": T, "sp": sp, "block_T": tl, "Hq": H, "Hkv": Hkv, "D": D,
            "dtype": "bfloat16", "visible_blocks": pairs,
            "launches": counts, "errors": errs, "lse_max_abs_err": lse_err,
            "whole_fwd_ms": whole_fwd, "whole_bwd_ms": whole_dq + whole_dkv,
            "whole_dq_ms": whole_dq, "whole_dkv_ms": whole_dkv,
            "ring_fwd_ms": ring_fwd, "ring_merge_ms": merge_ms,
            "ring_bwd_ms": ring_bwd,
            "ring_kernels_ms_over_whole":
                (ring_fwd + ring_bwd) / (whole_fwd + whole_dq + whole_dkv)})
        del q, k, v, do, out, lse, delta, args, want, parts, merged, grads
        del got, dq, dk, dv
        torch.cuda.empty_cache()
    launches = {key: sum(c["launches"][key] for c in cases)
                for key in cases[0]["launches"]}
    return {"cases": cases, "launches": launches}


def sharded_moe_width(torch, moe, llama_elastic, train, plain):
    """``train_moe_width`` through the multi-process path at world 1
    (``on_group_of_one``, the mesh of ``expert_parallel=1``): the MoE
    sharding rules, the sharded init and the mesh step, whose experts'
    sums run over tp and ep."""
    return on_group_of_one(
        torch, lambda mesh: train_moe_width(torch, moe, llama_elastic, train,
                                            mesh=mesh),
        plain, "MoE-width train", expert_parallel=1)


def trainer_code(module: str = "llama_elastic") -> str:
    """Runs a trainer's entry point (``python -m ...<module>``) in its own
    process and, when ``main`` returns, prints the process's kernel
    launches (a preempted trainer leaves by ``os._exit`` and prints
    none)."""
    return (
        "import json, runpy, sys\n"
        "from trainingjob_operator_tpu_torch import ops\n"
        "try:\n"
        "    runpy.run_module("
        f"'trainingjob_operator_tpu_torch.workloads.{module}', "
        "run_name='__main__')\n"
        "except SystemExit as exc:\n"
        "    rc = exc.code\n"
        "print('launches ' + json.dumps(ops.launch_counts()), flush=True)\n"
        "sys.exit(rc)\n")


#: The Llama trainer's (``llama_elastic``) process code.
TRAINER = trainer_code()


class LineSink:
    """A telemetry sink: a TCP server on localhost that keeps every JSON
    line it is sent (the trainer's ``TelemetryEmitter`` records)."""

    def __init__(self):
        import socketserver
        import threading

        records = self.records = []
        lock = self.lock = threading.Lock()

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                for raw in self.rfile:
                    try:
                        rec = json.loads(raw)
                    except ValueError:
                        continue
                    with lock:
                        records.append(rec)

        self.server = socketserver.ThreadingTCPServer(("127.0.0.1", 0),
                                                      Handler)
        self.server.daemon_threads = True
        self.address = f"127.0.0.1:{self.server.server_address[1]}"
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()

    def steps(self, job: str, timeout: float = 10.0):
        """The step records of ``job`` (call after its process ended:
        what it sent is read once the count stays put for half a
        second)."""
        t0, seen, since = time.time(), -1, time.time()
        while time.time() - t0 < timeout:
            with self.lock:
                got = [r for r in self.records
                       if r.get("job") == f"smoke/{job}" and "step" in r]
            if len(got) != seen:
                seen, since = len(got), time.time()
            elif time.time() - since > 0.5:
                break
            time.sleep(0.05)
        return sorted(got, key=lambda r: r["step"])

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=5)


def run_trainer(env, timeout: float, sigterm_after: str = "",
                code: str = TRAINER, cwd=ROOT, stamps=None):
    """(exit code, output lines, launches or None, seconds) of one trainer
    process (``code``: ``trainer_code``'s) started in ``cwd``; SIGTERM
    once a line starts with ``sigterm_after``; killed after ``timeout``
    seconds.  ``stamps``, a list, gets each line's seconds since the
    process was started."""
    import signal
    import threading

    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=cwd,
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    timer = threading.Timer(timeout, proc.kill)
    timer.start()
    lines = []
    try:
        for line in proc.stdout:
            if stamps is not None:
                stamps.append(time.perf_counter() - t0)
            lines.append(line.rstrip("\n"))
            if sigterm_after and line.startswith(sigterm_after):
                proc.send_signal(signal.SIGTERM)
                sigterm_after = ""
        rc = proc.wait()
    finally:
        timer.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return rc, lines, trainer_launches(lines), time.perf_counter() - t0


def trainer_launches(lines):
    """The launches a trainer process printed (``trainer_code``), or None
    (a preempted trainer prints none)."""
    launches = None
    for line in lines:
        if line.startswith("launches "):
            launches = json.loads(line[len("launches "):])
    return launches


@contextlib.contextmanager
def trainer_beside(env, code: str = TRAINER):
    """One trainer process started beside the caller's work (a phase's
    reference run on its own checkpoint directory, so that it overlaps
    the runs it is compared with): yields ``join(timeout)``, which waits
    for it (killed after ``timeout`` seconds) and returns ``run_trainer``'s
    (exit code, output lines, launches or None, seconds).  Leaving the
    block kills the process if it still runs."""
    t0 = time.perf_counter()
    with tempfile.TemporaryFile("w+") as out:
        proc = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                                env=env, stdout=out,
                                stderr=subprocess.STDOUT, text=True)

        def join(timeout: float):
            try:
                rc = proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                proc.kill()
                rc = proc.wait()
            out.seek(0)
            lines = out.read().splitlines()
            return rc, lines, trainer_launches(lines), \
                time.perf_counter() - t0

        try:
            yield join
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def run_trainers(envs, timeout: float, args=()):
    """(exit codes, output lines, launches) of one trainer process per env
    in ``envs``, all started together (the ranks of one job); killed
    after ``timeout`` seconds."""
    t0 = time.perf_counter()
    procs = []
    try:
        for env in envs:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", TRAINER, *args], cwd=ROOT, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        outs = []
        for proc in procs:
            left = max(timeout - (time.perf_counter() - t0), 1.0)
            try:
                outs.append(proc.communicate(timeout=left)[0])
            except subprocess.TimeoutExpired:
                proc.kill()
                outs.append(proc.communicate()[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    lines = [out.splitlines() for out in outs]
    launches = [json.loads(ln[len("launches "):]) for out in lines
                for ln in out if ln.startswith("launches ")]
    return [p.returncode for p in procs], lines, launches


def line_fields(lines, prefix: str) -> dict:
    """The ``key=value`` fields of the last line that starts with
    ``prefix``."""
    found = [ln for ln in lines if ln.startswith(prefix)]
    if not found:
        return {}
    return dict(f.split("=", 1) for f in found[-1].split() if "=" in f)


def expect(ok: bool, what: str, lines) -> None:
    if not ok:
        tail = "\n".join(lines[-30:])
        raise AssertionError(f"{what}; output ended:\n{tail}")


#: resume_124m: steps of the uninterrupted run, the checkpoint cadence, and
#: the line after which the preempted run gets SIGTERM.
RESUME_STEPS, RESUME_CKPT_EVERY = 12, 2
SIGTERM_AFTER = "step 4/"
#: Where resume_124m copies the preempted run's checkpoint directory, under
#: the phases' work directory.
COMMITTED_COPY = "committed"
#: Steps of kernel_cache_restart_124m's restarts: from the committed step
#: (4 or 5) on, 3-4 steps and 2 saves each.
CACHE_RESTART_STEPS = 8


def resume_124m(torch, llama, decode, train, sink, workdir):
    """The trainer's entry point at the 124M config, as its own processes
    on one checkpoint directory: preempted by SIGTERM (beside it, an
    uninterrupted run on another directory), restarted, then restarted
    under each fault injection; then ``generate`` on the checkpoint.  Per-step losses come from the telemetry records
    (the loss as the trainer read it, not rounded)."""
    import os

    from trainingjob_operator_tpu_torch.workloads import generate

    N = RESUME_STEPS
    runs, launches = {}, []

    def env_of(job, ckpt, steps, **extra):
        env = dict(os.environ)
        env.update({"LLAMA_CONFIG": "124m", "LLAMA_SEQ": "1024",
                    "LLAMA_BATCH": "8", "LLAMA_STEPS": str(steps),
                    "LLAMA_CKPT_EVERY": str(RESUME_CKPT_EVERY),
                    "TRAININGJOB_CHECKPOINT_DIR": ckpt,
                    "TRAININGJOB_TELEMETRY_ADDR": sink.address,
                    "TRAININGJOB_NAMESPACE": "smoke",
                    "TRAININGJOB_NAME": job}, **extra)
        return env

    def run(job, ckpt, steps, sigterm_after="", **extra):
        stamps = []
        out = record(job, *run_trainer(env_of(job, ckpt, steps, **extra),
                                       300, sigterm_after, stamps=stamps))
        first = [t for t, ln in zip(stamps, out[1])
                 if ln.endswith("(first after resume)")]
        if first:
            runs[job]["process_to_first_step_s"] = first[0]
        return out

    def record(job, rc, lines, counts, secs):
        if counts is not None:
            launches.append(counts)
        recs = sink.steps(job)
        runs[job] = {"rc": rc, "wall_s": secs,
                     "recovery": line_fields(lines, "recovery_timing init_s"),
                     "first_step_s": float(line_fields(
                         lines, "recovery_timing first_step_s").get(
                             "first_step_s", "nan")),
                     "ckpt_stall": line_fields(lines, "ckpt_stall "),
                     "resumed": [ln for ln in lines
                                 if ln.startswith("resume")],
                     "losses": {r["step"] + 1: r["loss"] for r in recs},
                     "step_ms": [r["ms"] for r in recs]}
        return rc, lines

    ckpt = os.path.join(workdir, "resume")
    plain = os.path.join(workdir, "plain")
    # The uninterrupted run, on its own directory, beside the preempted one.
    with trainer_beside(env_of("uninterrupted", plain, N)) as uninterrupted:
        rc, lines = run("preempted", ckpt, N, sigterm_after=SIGTERM_AFTER)
        rc_plain, lines_plain = record("uninterrupted", *uninterrupted(300))
    expect(rc_plain == 0 and sorted(runs["uninterrupted"]["losses"])
           == list(range(1, N + 1)), "uninterrupted run", lines_plain)
    want = runs["uninterrupted"]["losses"]
    expect(rc == 143 and lines[-1]
           == "preemption checkpoint committed; exiting 143",
           f"preempted run exited {rc}", lines)
    k = train.committed_steps(os.path.join(ckpt, "llama"))[0]
    expect(k >= 4, f"preempted run committed step {k}", lines)
    # The committed step as a restart finds it, for
    # kernel_cache_restart_124m.
    shutil.copytree(ckpt, os.path.join(workdir, COMMITTED_COPY))

    def check_resumed(job, lines, step, last, first=None):
        """Resumed at ``step`` and trained to ``last``, with the losses of
        ``first`` at the same steps where given."""
        got = runs[job]["losses"]
        expect(f"resumed at step {step} (width 1)" in lines,
               f"{job}: no resume at step {step}", lines)
        expect(any(ln.startswith(f"step {step + 1}/{last} loss ")
                   and ln.endswith("(first after resume)") for ln in lines),
               f"{job}: no first step after resume", lines)
        expect(sorted(got) == list(range(step + 1, last + 1)),
               f"{job}: steps {sorted(got)}", lines)
        expect(first is None or all(got[i] == first[i] for i in got),
               f"{job}: losses {got} differ from {first}", lines)

    rc, lines = run("restarted", ckpt, N)
    expect(rc == 0, "restarted run", lines)
    expect(f"resume: step {k} restored from resume image" in lines,
           "restarted run did not take the resume image", lines)
    check_resumed("restarted", lines, k, N, want)

    rc, lines = run("fault_resume_image", ckpt, N + 2,
                    TRAININGJOB_CKPT_FAULT="resume_image")
    expect(rc == 0 and "resume: image fallback reason=corrupt (sha256 "
           "mismatch); using the step directories" in lines,
           "resume_image fault", lines)
    check_resumed("fault_resume_image", lines, N, N + 2)
    steps_now = train.committed_steps(os.path.join(ckpt, "llama"))
    expect(steps_now[0] == N + 2 and len(steps_now) == 2,
           f"committed steps {steps_now}", lines)
    prev = steps_now[1]

    rc, lines = run("fault_corrupt_latest", ckpt, N + 2,
                    TRAININGJOB_CKPT_FAULT="corrupt_latest",
                    TRAININGJOB_RESUME_OVERLAP="0")
    expect(rc == 0 and f"resume: restored previous committed step {prev} "
           f"(latest {N + 2} unreadable)" in lines
           and any("reason=corrupt_latest" in ln for ln in lines),
           "corrupt_latest fault", lines)
    check_resumed("fault_corrupt_latest", lines, prev, N + 2,
                  {**want, **runs["fault_resume_image"]["losses"]})

    # generate on the checkpoint, against the same parameters read here.
    cfg = llama.LlamaConfig.base_124m()
    saved = torch.load(os.path.join(ckpt, "llama", str(N + 2), "params.pt"),
                       weights_only=True)
    params = train._onto(llama.init_params(cfg, torch.Generator(
        device="cuda").manual_seed(0), "cuda"), saved)
    prompt = [1, 450, 4996, 17354, 1701, 29916]
    rc, out, gen_launches = run_main(
        torch, generate.main, LLAMA_CONFIG="124m", GEN_STEPS="24",
        GEN_PROMPT=",".join(map(str, prompt)),
        TRAININGJOB_CHECKPOINT_DIR=ckpt)
    want_tokens = decode.generate(params, torch.tensor([prompt],
                                                       device="cuda"),
                                  cfg, steps=24)[0].tolist()
    expect(rc == 0 and f"sampling from checkpoint at step {N + 2}" in out
           and f"tokens: {','.join(map(str, want_tokens))}" in out,
           f"generate from the checkpoint: {want_tokens}", out)
    expect(gen_launches["flash_attention_fwd"]
           == gen_launches["flash_attention_fwd_wgmma"] == cfg.n_layers,
           f"generate launches {gen_launches}", out)
    launches.append(gen_launches)
    return {"config": "124m", "seq": 1024, "global_batch": 8,
            "steps": N, "ckpt_every": RESUME_CKPT_EVERY,
            "preempted_at_committed_step": k,
            "fault_corrupt_latest_restored": prev, "runs": runs,
            "bit_identical_after_resume": True,
            "generate_tokens": want_tokens,
            "launches": {key: sum(c[key] for c in launches)
                         for key in launches[0]}}


#: kernel_cache_restart_124m's restarts, in order: (name, the restart's
#: TRAININGJOB_RESUME_OVERLAP).  The first finds the cache empty.
CACHE_RESTARTS = (("cold", "1"), ("warm", "1"), ("warm_serial", "0"))


def kernel_cache_restart_124m(sink, workdir, resumed, want, nvcc: str):
    """The 124M trainer's restart as a fresh container sees it: a copy of
    the package without ``_build/`` (``PYTHONPATH`` and the working
    directory point at it), an empty job kernel cache
    (``TRAININGJOB_COMPILE_CACHE_DIR``) and, for each restart of
    ``CACHE_RESTARTS``, a fresh copy of resume_124m's committed step.  An
    ``nvcc`` shim on ``PATH`` logs every call before running ``nvcc``.
    Gates: the cold restart builds into the cache (every ``.cu`` compiled
    once, one link) and overlaps the build with the restore
    (``resume_phases_wall_s`` < ``restore_s + compile_s``); the warm ones
    compile nothing and load the cached library; ``resume_overlap`` is 1,
    1, 0; the losses equal the uninterrupted run's bit for bit; the
    launches are ``train_launches``'."""
    import os

    work = Path(workdir)
    pkg_root = work / "fresh_container"
    shutil.copytree(ROOT / "trainingjob_operator_tpu_torch",
                    pkg_root / "trainingjob_operator_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    cache = work / "kernel_cache"
    cache.mkdir()
    shim = work / "nvcc_shim"
    shim.mkdir()
    calls = work / "nvcc_calls.log"
    calls.touch()
    (shim / "nvcc").write_text(f'#!/bin/sh\necho "$*" >> "{calls}"\n'
                               f'exec "{nvcc}" "$@"\n')
    (shim / "nvcc").chmod(0o755)
    n_sources = len(list((pkg_root / "trainingjob_operator_tpu_torch"
                          / "csrc").glob("*.cu")))
    k, N = resumed["preempted_at_committed_step"], CACHE_RESTART_STEPS
    runs, launches = {}, []
    for name, overlap in CACHE_RESTARTS:
        ckpt = work / f"cache_{name}"
        shutil.copytree(work / COMMITTED_COPY, ckpt)
        env = dict(os.environ)
        env.update({"LLAMA_CONFIG": "124m", "LLAMA_SEQ": "1024",
                    "LLAMA_BATCH": "8", "LLAMA_STEPS": str(N),
                    "LLAMA_CKPT_EVERY": str(RESUME_CKPT_EVERY),
                    "TRAININGJOB_CHECKPOINT_DIR": str(ckpt),
                    "TRAININGJOB_COMPILE_CACHE_DIR": str(cache),
                    "TRAININGJOB_RESUME_OVERLAP": overlap,
                    "TRAININGJOB_TELEMETRY_ADDR": sink.address,
                    "TRAININGJOB_NAMESPACE": "smoke",
                    "TRAININGJOB_NAME": f"cache_{name}",
                    "PYTHONPATH": str(pkg_root),
                    "PATH": f"{shim}{os.pathsep}{env.get('PATH', '')}"})
        seen = len(calls.read_text().splitlines())
        stamps = []
        rc, lines, counts, secs = run_trainer(env, 600, cwd=pkg_root,
                                              stamps=stamps)
        nvcc_calls = calls.read_text().splitlines()[seen:]
        expect(rc == 0, f"{name} restart exited {rc}", lines)
        first = [i for i, ln in enumerate(lines)
                 if ln.endswith("(first after resume)")]
        expect(len(first) == 1 and f"resumed at step {k} (width 1)" in lines,
               f"{name}: no resume at step {k}", lines)
        got = {r["step"] + 1: r["loss"] for r in sink.steps(f"cache_{name}")}
        expect(sorted(got) == list(range(k + 1, N + 1))
               and all(got[i] == want[i] for i in got),
               f"{name}: losses {got} differ from {want}", lines)
        loaded = [ln for ln in lines if ln.startswith("kernels: loaded ")]
        expect(len(loaded) == 1 and loaded[0].startswith(
            f"kernels: loaded {cache}{os.sep}libtj_kernels_"),
            f"{name}: the library did not load from the cache", lines)
        compiles = [c for c in nvcc_calls if " -c " in f" {c} "]
        links = [c for c in nvcc_calls if " -shared " in f" {c} "]
        if name == "cold":
            expect(loaded[0].endswith(" s)") and "(built in " in loaded[0]
                   and len(compiles) == n_sources and len(links) == 1,
                   f"cold: not one build into the cache ({nvcc_calls})",
                   lines)
        else:
            expect(loaded[0].endswith("(cache hit)") and not compiles
                   and not links,
                   f"{name}: nvcc ran ({nvcc_calls})", lines)
        timing = line_fields(lines, "recovery_timing init_s")
        expect(timing.get("resume_overlap") == overlap,
               f"{name}: resume_overlap {timing.get('resume_overlap')}",
               lines)
        resume = [r for r in sink.records
                  if r.get("job") == f"smoke/cache_{name}"
                  and "resume_restore_ms" in r]
        expect(len(resume) == 1 and resume[0]["resume_overlapped"]
               == (overlap == "1"), f"{name}: resume record {resume}", lines)
        restore_s = float(timing["restore_s"])
        compile_s = float(timing["compile_s"])
        wall_s = float(timing["resume_phases_wall_s"])
        if name == "cold":
            expect(wall_s < restore_s + compile_s,
                   f"cold: no overlap ({timing})", lines)
        expect(counts == train_launches(8, "none", N - k,
                                        tensor_cores=True),
               f"{name}: launches {counts}", lines)
        launches.append(counts)
        runs[name] = {
            "rc": rc, "wall_s": secs,
            "process_to_first_step_s": stamps[first[0]],
            "restore_s": restore_s, "compile_s": compile_s,
            "resume_phases_wall_s": wall_s,
            "restore_ms": resume[0]["resume_restore_ms"],
            "compile_ms": resume[0]["resume_compile_ms"],
            "resume_overlap": int(overlap),
            "first_step_s": float(line_fields(
                lines, "recovery_timing first_step_s")["first_step_s"]),
            "recovery": timing, "kernels": loaded[0],
            "nvcc_calls": len(nvcc_calls), "nvcc_compiles": len(compiles),
            "launches": counts}
    expect(not (pkg_root / "trainingjob_operator_tpu_torch"
                / "_build").exists(),
           "the library landed in the package copy", [])
    return {"config": "124m", "seq": 1024, "global_batch": 8,
            "resumed_at": k, "steps": N, "cache_dir_files": sorted(
                p.name for p in cache.iterdir()),
            "runs": runs, "bit_identical_after_resume": True,
            "launches": {key: sum(c[key] for c in launches)
                         for key in launches[0]}}


#: jax_handoff_124m: steps the trainer takes after the handed-off step.
HANDOFF_STEPS = 3


def jax_handoff_124m(torch, llama, decode, train, sink, workdir, resumed,
                     want):
    """A job the JAX package's worker committed, taken over by the port:
    resume_124m's committed step k (the port's seeded init and k steps)
    written as the JAX trainer commits it (an orbax step directory's
    marker and the resume image: numpy leaves, optax's AdamW chain state
    by its globals, the sha256 footer; ``jax_state.write_image``), with no
    JAX here.  ``generate`` on it samples the greedy tokens of the same
    parameters; the trainer's entry point resumes it at step k and trains
    HANDOFF_STEPS steps whose losses equal the uninterrupted run's (which
    the port's own restarts from step k equal) bit for bit, with the
    launches ``train_launches`` counts."""
    import os

    from trainingjob_operator_tpu_torch.workloads import generate, jax_state

    k = resumed["preempted_at_committed_step"]
    committed = Path(workdir) / COMMITTED_COPY / "llama" / str(k)
    params = torch.load(committed / "params.pt", weights_only=True)
    opt_state = torch.load(committed / "opt_state.pt", weights_only=True)
    ckpt = Path(workdir) / "jax_handoff"
    path = ckpt / "llama"
    (path / str(k) / "default").mkdir(parents=True)
    # Orbax's commit marker; the port reads only its presence.
    (path / str(k) / jax_state.ORBAX_MARKER).write_text("{}")
    t0 = time.perf_counter()
    jax_state.write_image(str(path), k,
                          jax_state.adamw_tree(params, opt_state, k))
    write_s = time.perf_counter() - t0
    image_bytes = (path / jax_state.IMAGE).stat().st_size

    # generate on the JAX job's directory, against the same parameters.
    cfg = llama.LlamaConfig.base_124m()
    same = train._onto(llama.init_params(cfg, torch.Generator(
        device="cuda").manual_seed(0), "cuda"), params)
    del params, opt_state
    prompt = [1, 450, 4996, 17354, 1701, 29916]
    t0 = time.perf_counter()
    rc, out, gen_launches = run_main(
        torch, generate.main, LLAMA_CONFIG="124m", GEN_STEPS="24",
        GEN_PROMPT=",".join(map(str, prompt)),
        TRAININGJOB_CHECKPOINT_DIR=str(ckpt))
    generate_s = time.perf_counter() - t0
    want_tokens = decode.generate(same, torch.tensor([prompt],
                                                     device="cuda"),
                                  cfg, steps=24)[0].tolist()
    del same
    expect(rc == 0 and f"resume: step {k} restored from the JAX package's "
           "resume image" in out
           and f"sampling from checkpoint at step {k}" in out
           and f"tokens: {','.join(map(str, want_tokens))}" in out,
           f"generate from the JAX job: {want_tokens}", out)
    expect(gen_launches["flash_attention_fwd"]
           == gen_launches["flash_attention_fwd_wgmma"] == cfg.n_layers,
           f"generate launches {gen_launches}", out)
    torch.cuda.empty_cache()

    env = dict(os.environ)
    # One save, at the last step: a 1.5 GB step directory and image each.
    env.update({"LLAMA_CONFIG": "124m", "LLAMA_SEQ": "1024",
                "LLAMA_BATCH": "8", "LLAMA_STEPS": str(k + HANDOFF_STEPS),
                "LLAMA_CKPT_EVERY": str(k + HANDOFF_STEPS),
                "TRAININGJOB_CHECKPOINT_DIR": str(ckpt),
                "TRAININGJOB_TELEMETRY_ADDR": sink.address,
                "TRAININGJOB_NAMESPACE": "smoke",
                "TRAININGJOB_NAME": "jax_handoff"})
    stamps = []
    rc, lines, counts, secs = run_trainer(env, 300, stamps=stamps)
    expect(rc == 0, f"handoff trainer exited {rc}", lines)
    expect(f"resume: step {k} restored from the JAX package's resume image"
           in lines and f"resumed at step {k} (width 1)" in lines,
           f"no resume at the JAX job's step {k}", lines)
    got = {r["step"] + 1: r["loss"] for r in sink.steps("jax_handoff")}
    expect(sorted(got) == list(range(k + 1, k + HANDOFF_STEPS + 1))
           and all(got[i] == want[i] for i in got),
           f"handoff losses {got} differ from {want}", lines)
    expect(counts == train_launches(8, "none", HANDOFF_STEPS,
                                    tensor_cores=True),
           f"handoff launches {counts}", lines)
    resume = [r for r in sink.records if r.get("job") == "smoke/jax_handoff"
              and "resume_restore_ms" in r]
    expect(len(resume) == 1 and resume[0].get("resume_fallback")
           == "jax_image", f"handoff resume record {resume}", lines)
    expect(train.committed_steps(str(path))[0] == k + HANDOFF_STEPS
           and (path / str(k) / jax_state.ORBAX_MARKER).exists(),
           "the port's steps beside the JAX step", lines)
    first = [i for i, ln in enumerate(lines)
             if ln.endswith("(first after resume)")]
    image = line_fields(lines, "resume: jax image ")
    return {"config": "124m", "seq": 1024, "global_batch": 8,
            "handed_off_at": k, "steps": HANDOFF_STEPS,
            "image_bytes": image_bytes, "image_write_s": write_s,
            "generate_s": generate_s, "image_read": image, "convert_s": float(image["convert_s"]),
            "recovery": line_fields(lines, "recovery_timing init_s"),
            "restore_s": float(line_fields(
                lines, "recovery_timing init_s")["restore_s"]),
            "first_step_s": float(line_fields(
                lines, "recovery_timing first_step_s")["first_step_s"]),
            "process_to_first_step_s": stamps[first[0]],
            "trainer_wall_s": secs, "losses": got,
            "bit_identical_after_resume": True,
            "generate_tokens": want_tokens,
            "launches": {key: counts[key] + gen_launches[key]
                         for key in counts}}


def telemetry(sink, workdir):
    """A short trainer run with telemetry, the step profiler and the
    workload trace on: a record per step, ``hbm_bytes`` every second step,
    ``ckpt_ms`` on the record after each save, a Chrome trace of steps 2
    and 3, and the span trace."""
    import os

    env = dict(os.environ)
    steps = 6
    env.update({"LLAMA_CONFIG": "124m", "LLAMA_SEQ": "1024",
                "LLAMA_BATCH": "8", "LLAMA_STEPS": str(steps),
                "LLAMA_CKPT_EVERY": "3",
                "TRAININGJOB_CHECKPOINT_DIR": os.path.join(workdir, "tel"),
                "TRAININGJOB_TELEMETRY_ADDR": sink.address,
                "TRAININGJOB_NAMESPACE": "smoke",
                "TRAININGJOB_NAME": "telemetry",
                "TRAININGJOB_HBM_SAMPLE_STEPS": "2",
                "TRAININGJOB_PROFILE_DIR": os.path.join(workdir, "prof"),
                "TRAININGJOB_PROFILE_STEPS": "2:4",
                "TRAININGJOB_TRACE_CONTEXT":
                    "0123456789abcdef0123456789abcdef:0123456789abcdef",
                "TRAININGJOB_TRACE_DIR": os.path.join(workdir, "trace")})
    rc, lines, counts, secs = run_trainer(env, 300)
    expect(rc == 0 and counts is not None, "telemetry run", lines)
    recs = sink.steps("telemetry")
    expect([r["step"] for r in recs] == list(range(steps)),
           f"telemetry steps {[r['step'] for r in recs]}", lines)
    hbm = {r["step"]: r.get("hbm_bytes") for r in recs}
    ckpt = {r["step"]: r.get("ckpt_ms") for r in recs}
    expect(all((hbm[i] is not None and hbm[i] > 0) == (i % 2 == 0)
               for i in hbm), f"hbm_bytes {hbm}", lines)
    expect([i for i in ckpt if ckpt[i] is not None] == [3],
           f"ckpt_ms {ckpt}", lines)
    expect(all(r["tokens"] == 8 * 1024 and r["flops"] > 0
               and r["rtype"] == "worker" for r in recs),
           f"record fields {recs[0]}", lines)
    prof = [f for f in os.listdir(os.path.join(workdir, "prof"))
            if f.endswith(".json")]
    expect(len(prof) == 1, f"profile files {prof}", lines)
    with open(os.path.join(workdir, "prof", prof[0])) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    expect(len(kernels) > 0, "no device kernels in the profile", lines)
    traces = os.listdir(os.path.join(workdir, "trace"))
    with open(os.path.join(workdir, "trace", traces[0])) as f:
        span_events = json.load(f)["traceEvents"]
    spans = [e["name"] for e in span_events]
    expect({"train.run", "train.compile", "train.step",
            "train.checkpoint"} <= set(spans), f"spans {set(spans)}", lines)
    return {"steps": steps, "records": recs, "wall_s": secs,
            "profile_events": len(events), "profile_kernels": len(kernels),
            "spans": {n: spans.count(n) for n in sorted(set(spans))},
            "span_ms": {n: [e["dur"] / 1e3 for e in span_events
                            if e["name"] == n] for n in sorted(set(spans))},
            "launches": counts}


#: cross_width_resume: the steps of the two-process CPU run (its last
#: step saves), and of the card runs.
CROSS_SAVED, CROSS_STEPS = 2, 6
#: Relative agreement of the resumed card run's losses with the
#: uninterrupted card run's: the state at step 2 comes from the CPU, whose
#: fp32 sums run in another order than the card's.
CROSS_LOSS_RTOL = 1e-4


def cross_width_resume(sink, workdir):
    """The trainer's entry point on the tiny config in fp32 across widths:
    two processes on the machine's CPU (gloo) train to step 2 and save it
    as two shards; one process on the card (a group of one on NCCL)
    resumes from them and trains to step 6; its losses equal those of an
    uninterrupted one-process card run (started beside the others) within
    CROSS_LOSS_RTOL."""
    import os

    def envs(job, ckpt, world, steps):
        env = dict(os.environ)
        env.update({"LLAMA_CONFIG": "tiny", "LLAMA_DTYPE": "float32",
                    "LLAMA_SEQ": "64", "LLAMA_BATCH": "4",
                    "LLAMA_ACCUM": "2", "LLAMA_STEPS": str(steps),
                    "LLAMA_CKPT_EVERY": str(CROSS_SAVED),
                    "TRAININGJOB_CHECKPOINT_DIR": ckpt,
                    "TRAININGJOB_TELEMETRY_ADDR": sink.address,
                    "TRAININGJOB_NAMESPACE": "smoke",
                    "TRAININGJOB_NAME": job,
                    "TRAININGJOB_ELASTIC_REPLICAS": str(world),
                    "TRAININGJOB_COORDINATOR_ADDRESS":
                        f"127.0.0.1:{free_port()}",
                    "TRAININGJOB_NUM_PROCESSES": str(world),
                    "OMP_NUM_THREADS": "2"})
        return [{**env, "TRAININGJOB_PROCESS_ID": str(r)}
                for r in range(world)]

    ckpt = os.path.join(workdir, "cross")
    runs, card_launches = {}, []

    def record(job, world, device, rcs, lines, launches, wall_s):
        expect(rcs == [0] * world, f"{job} exited {rcs}",
               [ln for out in lines for ln in out])
        if device == "cuda":
            card_launches.extend(launches)
        recs = sink.steps(job)
        runs[job] = {"world": world, "wall_s": wall_s, "device": device,
                     "losses": {r["step"] + 1: r["loss"] for r in recs},
                     "resumed": [ln for ln in lines[0]
                                 if ln.startswith("resume")],
                     "recovery": line_fields(lines[0],
                                             "recovery_timing init_s")}

    # The uninterrupted card run, on its own directory, beside the others.
    with trainer_beside(envs("cross_plain", os.path.join(
            workdir, "cross_plain"), 1, CROSS_STEPS)[0]) as plain:
        for job, world, steps, args in (
                ("cross_cpu", 2, CROSS_SAVED, ("--device", "cpu")),
                ("cross_resumed", 1, CROSS_STEPS, ())):
            t0 = time.perf_counter()
            rcs, lines, launches = run_trainers(envs(job, ckpt, world,
                                                     steps), 300, args)
            record(job, world, "cpu" if args else "cuda", rcs, lines,
                   launches, time.perf_counter() - t0)
            if job == "cross_cpu":
                shards = sorted(os.listdir(os.path.join(
                    ckpt, "llama", str(CROSS_SAVED))))
                expect(shards == ["shard-0.pt", "shard-1.pt"],
                       f"step {CROSS_SAVED} holds {shards}", lines[0])
            else:
                expect(f"resumed at step {CROSS_SAVED} (width 1)"
                       in lines[0], "no resume at the saved step", lines[0])
        rc, lines, counts, secs = plain(300)
        record("cross_plain", 1, "cuda", [rc], [lines],
               [counts] if counts is not None else [], secs)
    got, want = runs["cross_resumed"]["losses"], runs["cross_plain"]["losses"]
    steps_after = list(range(CROSS_SAVED + 1, CROSS_STEPS + 1))
    expect(sorted(got) == steps_after
           and sorted(want) == list(range(1, CROSS_STEPS + 1)),
           f"steps {sorted(got)} and {sorted(want)}", [])
    rel = max(abs(got[i] - want[i]) / abs(want[i]) for i in steps_after)
    expect(rel <= CROSS_LOSS_RTOL, f"resumed losses {got} vs {want}", [])
    with sink.lock:
        resumes = [r for r in sink.records
                   if r.get("job") == "smoke/cross_resumed"
                   and "resume_restore_ms" in r]
    expect(len(resumes) == 1
           and resumes[0].get("resume_fallback") == "missing",
           f"resume records {resumes}", [])
    expected = {k: sum(train_launches(2, "none", steps * 2)[k]
                       for steps in (CROSS_STEPS - CROSS_SAVED, CROSS_STEPS))
                for k in card_launches[0]}
    launches = {k: sum(c[k] for c in card_launches) for k in card_launches[0]}
    expect(launches == expected, f"launches {launches}, expected {expected}",
           [])
    return {"config": "tiny", "dtype": "float32", "seq": 64,
            "global_batch": 4, "accum": 2, "saved_at": CROSS_SAVED,
            "steps": CROSS_STEPS, "loss_rtol": CROSS_LOSS_RTOL,
            "loss_max_rel_err": rel, "resume_record": resumes[0],
            "runs": runs, "launches": launches}


#: resize_7b_width: the step after which the phase publishes generation 1,
#: and how far the peak may stray from sharded_7b_width's (a second copy
#: of the 8-layer state would add about 8 GiB).
RESIZE_PUBLISH_AFTER = 4
RESIZE_PEAK_GIB = 0.5


def publish_generation(rdv_dir: str, doc: dict) -> None:
    """The controller's atomic publish of ``generation.json``."""
    import os

    os.makedirs(rdv_dir, exist_ok=True)
    tmp = os.path.join(rdv_dir, ".generation.tmp")
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(doc, fh)
    os.replace(tmp, os.path.join(rdv_dir, "generation.json"))


def resize_7b_width(torch, llama, llama_elastic, sharded, workdir):
    """The live rung at 7B width (8 layers), in process: the trainer's
    loop (``train.run_elastic_loop``) on ``sharded_7b_width``'s parameters
    and batch, on the mesh path in an NCCL group of one.  After step 4 the
    phase publishes generation 1 (world [0], one process, the same
    coordinator address); the loop leaves at that step boundary and
    ``llama_elastic.resize_cycle`` destroys and forms the group again,
    rebuilds the mesh and the step, keeps the state on the card and
    resumes.  Gates: rung ``live``, ``fallback=0``, ``moved_mb=0``, no
    checkpoint read; the 8 losses equal ``sharded``'s within
    SHARDED_LOSS_RTOL; the peak within RESIZE_PEAK_GIB of ``sharded``'s;
    launches and collectives of 8 steps."""
    import os

    import torch.distributed as dist

    from trainingjob_operator_tpu_torch import ops
    from trainingjob_operator_tpu_torch.obs.trace import Tracer
    from trainingjob_operator_tpu_torch.parallel import collectives
    from trainingjob_operator_tpu_torch.parallel import mesh as pmesh
    from trainingjob_operator_tpu_torch.workloads import rendezvous, train

    cfg = dataclasses.replace(llama.LlamaConfig.llama2_7b(), n_layers=8)
    seq, batch, accum, steps, lr = 4096, 2, 2, 8, 3e-4
    address = f"127.0.0.1:{free_port()}"
    rdv = rendezvous.Rendezvous(num_processes=1, process_id=0,
                                coordinator_address=address)
    rdv_dir = os.path.join(workdir, "rdv7b")
    device = rendezvous.initialize_distributed(rdv, torch.device("cuda"))
    losses, step_s, stamps = [], [], []
    reads = []
    real_reads = {name: getattr(train, name)
                  for name in ("_step_pieces", "_load_resume_image")}

    def counted(name):
        def read(*a, **k):
            reads.append(name)
            return real_reads[name](*a, **k)
        return read

    def step_of(params, opt_state, mesh):
        step = llama_elastic.make_step_fn(params, cfg, accum=accum, lr=lr,
                                          remat="none", opt_state=opt_state,
                                          mesh=mesh)

        def step_fn(tokens):
            t = time.perf_counter()
            loss = step(tokens)
            losses.append(float(loss))
            step_s.append(time.perf_counter() - t)
            stamps.append(time.perf_counter())
            if len(losses) == RESIZE_PUBLISH_AFTER:
                publish_generation(rdv_dir, {
                    "generation": 1, "world": [0], "num_processes": 1,
                    "coordinator": address})
            return loss
        return step_fn

    out = io.StringIO()
    try:
        mesh = pmesh.make_mesh(pmesh.mesh_spec_from_rendezvous(rdv),
                               device.type)
        params = llama.init_params(
            cfg, torch.Generator(device=device).manual_seed(0), device,
            master=True, mesh=mesh)
        for leaf in train.tree_leaves(params):
            leaf.requires_grad_(True)
        opt_state = train.AdamW(params, lr).state
        gen = torch.Generator(device=device).manual_seed(3)
        host_tokens = torch.randint(0, cfg.vocab_size, (batch, seq + 1),
                                    generator=gen, device=device).cpu()
        ts = llama_elastic.TrainState(
            rdv=rdv, device=device, mesh=mesh, world=[0], params=params,
            opt_state=opt_state,
            state=train.CheckpointState("", {"params": params,
                                             "opt_state": opt_state,
                                             "step": 0}))
        del params, opt_state
        width = {"step_fn": step_of(ts.params, ts.opt_state, ts.mesh)}

        def rebuild(ts):
            width["step_fn"] = step_of(ts.params, ts.opt_state, ts.mesh)

        watcher = rendezvous.GenerationWatcher(
            path=os.path.join(rdv_dir, "generation.json"), birth=0,
            interval=0.0)
        tracer = Tracer(enabled=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        collectives.reset_collective_counts()
        for name in real_reads:
            setattr(train, name, counted(name))
        with contextlib.redirect_stdout(out):
            while True:
                train.run_elastic_loop(
                    step_fn=width["step_fn"], batch_at=lambda i: host_tokens,
                    state=ts.state, params=ts.params,
                    opt_state=ts.opt_state, steps=steps,
                    start_step=ts.start_step, ckpt_every=steps,
                    device=ts.device, resize_watch=watcher, tracer=tracer)
                if watcher.pending is None:
                    break
                width.clear()
                t_cycle = time.perf_counter()
                rc = llama_elastic.resize_cycle(
                    ts, watcher, cfg=cfg, lr=lr, tp=1, rebuild=rebuild,
                    tracer=tracer)
                cycle_s = time.perf_counter() - t_cycle
                if rc is not None:
                    raise AssertionError(f"resize degraded: {ts.last_resize}")
        counts = ops.launch_counts()
        sent = collectives.collective_counts()
        peak = torch.cuda.max_memory_allocated()
        group_after = (dist.is_initialized(), dist.get_world_size())
    finally:
        for name, fn in real_reads.items():
            setattr(train, name, fn)
        if dist.is_initialized():
            dist.destroy_process_group()
    lines = out.getvalue().splitlines()
    timing = line_fields(lines, "resize_timing ")
    rungs = [ln for ln in lines if ln.startswith("resize_rung ")]
    expect(rungs == ["resize_rung generation=1 rung=live phase=-"]
           and timing.get("fallback") == "0"
           and float(timing.get("moved_mb", "nan")) == 0.0
           and ts.last_resize.get("moved_mb") == 0.0,
           f"7B-width resize: rungs {rungs}, timing {timing}", lines)
    expect(f"resized in place: mesh {ts.mesh.sizes}, resuming at step "
           f"{RESIZE_PUBLISH_AFTER}" in lines and not reads
           and group_after == (True, 1),
           f"7B-width resize: checkpoint reads {reads}, group "
           f"{group_after}", lines)
    spans = [sp["name"] for tr in reversed(tracer.traces())
             for sp in tr["spans"] if sp["name"].startswith("resize.")]
    expect(spans == ["resize.rendezvous", "resize.requod",
                     "resize.reshard", "resize.compile"],
           f"resize spans {spans}", lines)
    want = sharded["losses"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, want))
    expect(len(losses) == steps and rel <= SHARDED_LOSS_RTOL,
           f"7B-width resize: losses {losses} vs sharded {want}", lines)
    per_step = train_launches(cfg.n_layers, "none", accum, tensor_cores=True)
    coll = mesh_collectives(cfg.n_layers, accum)
    expect(counts == {k: n * steps for k, n in per_step.items()}
           and sent == {k: n * steps for k, n in coll.items()},
           f"7B-width resize: launches {counts}, collectives {sent}", lines)
    peak_gib = peak / 2 ** 30
    expect(abs(peak_gib - sharded["peak_mem_gib"]) <= RESIZE_PEAK_GIB,
           f"7B-width resize: peak {peak_gib} GiB vs sharded "
           f"{sharded['peak_mem_gib']}", lines)
    k = RESIZE_PUBLISH_AFTER

    def median(xs):
        return sorted(xs)[len(xs) // 2]
    return {"n_layers": cfg.n_layers, "seq": seq, "global_batch": batch,
            "accum": accum, "remat": "none", "backend": "nccl",
            "coordinator": address, "published_after_step": k,
            "resize_timing": {key: float(v) for key, v in timing.items()
                              if key != "generation"},
            "resize_phase_ms": ts.last_resize.get("phase_ms"),
            "resize_cycle_s": cycle_s, "rungs": rungs, "spans": spans,
            "checkpoint_reads": len(reads), "losses": losses,
            "loss_rtol": SHARDED_LOSS_RTOL,
            "loss_max_rel_err_vs_sharded": rel,
            "losses_equal_sharded": losses == want,
            "step_s": step_s,
            "step_s_median_before": median(step_s[1:k]),
            "step_s_median_after": median(step_s[k + 1:]),
            "first_step_after_resize_s": step_s[k],
            "downtime_s": stamps[k] - stamps[k - 1],
            "peak_mem_gib": peak_gib,
            "peak_mem_gib_minus_sharded": peak_gib - sharded["peak_mem_gib"],
            "launches": counts, "collectives": sent}


def run_resizing_trainer(env, timeout: float, rdv_dir: str, doc: dict):
    """One trainer process, as ``run_trainer``, with the parent playing the
    controller: it publishes ``doc`` once the trainer prints its first
    ``step`` line.  Returns (exit code, lines, each line's arrival time on
    the parent's clock, launches or None)."""
    import re
    import threading

    proc = subprocess.Popen([sys.executable, "-c", TRAINER], cwd=ROOT,
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    timer = threading.Timer(timeout, proc.kill)
    timer.start()
    lines, stamps, published = [], [], doc is None
    try:
        for line in proc.stdout:
            lines.append(line.rstrip("\n"))
            stamps.append(time.perf_counter())
            if not published and re.match(r"step \d+/", line):
                publish_generation(rdv_dir, doc)
                published = True
        rc = proc.wait()
    finally:
        timer.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    launches = None
    for line in lines:
        if line.startswith("launches "):
            launches = json.loads(line[len("launches "):])
    return rc, lines, stamps, launches


#: Steps of resize_ladder_124m's runs (resume_124m runs RESUME_STEPS): the
#: generation is published after step 2's line, the resize lands at step
#: 3, and every rung's run and restart trains on to this step.
LADDER_STEPS = 6


def resize_ladder_124m(sink, workdir, uninterrupted):
    """The trainer's entry point at the 124M config (``resume_124m``'s
    settings) with a coordinator (an NCCL group of one), the resize
    channel and poll 0, as separate processes; the parent publishes
    generation 1 after the first ``step`` line.  No fault: rung ``live``,
    rc 0.  ``barrier``: rung ``checkpoint``, rc 143, and a restart born
    into generation 1 resumes.  ``barrier,persist``: ``checkpoint`` then
    ``restart_all``, rc 143, and a restart resumes from the previous
    committed step.  Every run's losses equal ``uninterrupted``'s (the
    ``resume_124m`` run) within SHARDED_LOSS_RTOL.  Downtime on the
    parent's clock: from the ``observed at step`` line to the first step
    after it (of the same process, or of the restart)."""
    import os
    import re

    from trainingjob_operator_tpu_torch.workloads import train

    N = LADDER_STEPS
    runs, launches = {}, []

    def env_of(job, ckpt, rdv_dir, **extra):
        env = dict(os.environ)
        env.update({"LLAMA_CONFIG": "124m", "LLAMA_SEQ": "1024",
                    "LLAMA_BATCH": "8", "LLAMA_STEPS": str(N),
                    "LLAMA_CKPT_EVERY": str(RESUME_CKPT_EVERY),
                    "TRAININGJOB_CHECKPOINT_DIR": ckpt,
                    "TRAININGJOB_TELEMETRY_ADDR": sink.address,
                    "TRAININGJOB_NAMESPACE": "smoke",
                    "TRAININGJOB_NAME": job,
                    "TRAININGJOB_COORDINATOR_ADDRESS":
                        f"127.0.0.1:{free_port()}",
                    "TRAININGJOB_RESIZE_DIR": rdv_dir,
                    "TRAININGJOB_RESIZE_POLL_S": "0"}, **extra)
        return env

    def run(job, ckpt, rdv_dir, doc, **extra):
        rc, lines, stamps, counts = run_resizing_trainer(
            env_of(job, ckpt, rdv_dir, **extra), 300, rdv_dir, doc)
        if counts is not None:
            launches.append(counts)
        got = {r["step"] + 1: r["loss"] for r in sink.steps(job)}
        rel = max((abs(got[i] - uninterrupted[i]) / abs(uninterrupted[i])
                   for i in got), default=float("nan"))
        expect(bool(got) and rel <= SHARDED_LOSS_RTOL,
               f"{job}: losses {got} vs {uninterrupted}", lines)
        runs[job] = {"rc": rc, "losses": got, "loss_max_rel_err": rel,
                     "losses_equal_uninterrupted":
                         all(got[i] == uninterrupted[i] for i in got),
                     "rungs": [ln for ln in lines
                               if ln.startswith("resize_rung ")],
                     "resize_timing": line_fields(lines, "resize_timing "),
                     "first_step_s": float(line_fields(
                         lines, "recovery_timing first_step_s").get(
                             "first_step_s", "nan"))}
        return rc, lines, stamps

    def at(lines, stamps, pattern):
        for line, t in zip(lines, stamps):
            m = re.search(pattern, line)
            if m:
                return m, t
        expect(False, f"no line matches {pattern!r}", lines)

    def rungs_of(job):
        return [re.search(r"rung=(\w+)", ln).group(1)
                for ln in runs[job]["rungs"]]

    doc = {"generation": 1, "world": [0], "num_processes": 1}
    downtime = {}
    # restart_all leaves without waiting for a background save in flight
    # (as JAX does), so its run saves on the step loop: the step before
    # the resize is then committed, and the restart resumes from it.
    for rung, fault, want_rc, want_rungs, snapshot in (
            ("live", "", 0, ["live"], "1"),
            ("checkpoint", "barrier", 143, ["checkpoint"], "1"),
            ("restart_all", "barrier,persist", 143,
             ["checkpoint", "restart_all"], "0")):
        job = f"ladder_{rung}"
        ckpt = os.path.join(workdir, job)
        rdv_dir = os.path.join(workdir, f"{job}_rdv")
        rc, lines, stamps = run(job, ckpt, rdv_dir, doc,
                                TRAININGJOB_RESIZE_FAULT=fault,
                                TRAININGJOB_CKPT_SNAPSHOT=snapshot)
        expect(rc == want_rc and rungs_of(job) == want_rungs,
               f"{job}: exit {rc}, rungs {runs[job]['rungs']}", lines)
        m, t_seen = at(lines, stamps, r"observed at step (\d+)")
        k = int(m.group(1))
        if rung == "live":
            expect(f"resized in place: mesh {{'dp': 1, 'pp': 1, 'fsdp': 1, "
                   f"'tp': 1, 'sp': 1}}, resuming at step {k}" in lines
                   and runs[job]["resize_timing"].get("fallback") == "0"
                   and sorted(runs[job]["losses"]) == list(range(1, N + 1)),
                   f"{job}: no live resize", lines)
            _, t_first = at(lines, stamps, rf"^step {k + 1}/{N} loss .*"
                                           r"\(first after resume\)")
            downtime[rung] = t_first - t_seen
            continue
        committed = train.committed_steps(os.path.join(ckpt, "llama"))
        want_step = k if rung == "checkpoint" else max(
            s for s in committed if s < k)
        expect(committed[0] == want_step,
               f"{job}: committed {committed}, observed at {k}", lines)
        # The operator's restart: born into generation 1, it ignores the
        # doc that sent its predecessor away.
        restart = f"{job}_restart"
        rc2, lines2, stamps2 = run(restart, ckpt, rdv_dir, None,
                                   TRAININGJOB_RENDEZVOUS_GENERATION="1",
                                   TRAININGJOB_CKPT_SNAPSHOT=snapshot)
        expect(rc2 == 0 and f"resumed at step {want_step} (width 1)" in lines2
               and not runs[restart]["rungs"]
               and sorted(runs[restart]["losses"])
               == list(range(want_step + 1, N + 1)),
               f"{restart}: exit {rc2}", lines2)
        _, t_first = at(lines2, stamps2, rf"^step {want_step + 1}/{N} loss "
                                         r".*\(first after resume\)")
        downtime[rung] = t_first - t_seen
        runs[job]["resumed_at"] = want_step
    return {"config": "124m", "seq": 1024, "global_batch": 8, "steps": N,
            "ckpt_every": RESUME_CKPT_EVERY, "backend": "nccl", "world": 1,
            "loss_rtol": SHARDED_LOSS_RTOL, "downtime_s": downtime,
            "runs": runs,
            "launches": {key: sum(c[key] for c in launches)
                         for key in launches[0]}}


def tiny_equivalence(torch, llama, decode, serve):
    """fp32 tiny config through the kernels: serve == generate, per
    request."""
    dev = torch.device("cuda")
    base = llama.LlamaConfig.tiny()
    cfg = llama.LlamaConfig(**{**base.__dict__, "dtype": "float32"})
    params = llama.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    return serve_equals_generate(torch, serve, decode, params, cfg,
                                 "llama")


def serve_equals_generate(torch, serve, decode, params, cfg, family):
    """A DecodeService run of 12 requests (3 slots, chunk 4) on the card:
    every request gets exactly ``decode.generate``'s tokens for its
    prompt, no stale KV, RMSNorm and the flash forward launched."""
    from trainingjob_operator_tpu_torch import ops

    dev = torch.device("cuda")
    svc = serve.DecodeService(params, cfg, slots=3, prefill_chunk=4,
                              family=family, device=dev)
    traffic = serve.synthetic_traffic(12, seed=3, rate=1.5,
                                      vocab=cfg.vocab_size,
                                      prompt_lens=(3, 10),
                                      out_tokens=(2, 12))
    ops.reset_launch_counts()
    result = serve.run_traffic(svc, traffic)
    mismatched = 0
    for req in result["completed"]:
        want = decode.generate(params, torch.tensor([req.prompt],
                                                    device=dev), cfg,
                               steps=req.max_new_tokens)[0].tolist()
        mismatched += req.tokens != want
    counts = ops.launch_counts()
    stats = result["stats"]
    if len(result["completed"]) != 12 or mismatched:
        raise AssertionError(f"tiny {family}: {mismatched} of "
                             f"{len(result['completed'])} requests differ "
                             f"from generate")
    if stats["stale_kv_violations"]:
        raise AssertionError(f"tiny {family}: stale KV")
    if not (counts["rmsnorm_fwd"] and counts["flash_attention_fwd"]):
        raise AssertionError(f"tiny {family} run skipped a kernel: "
                             f"{counts}")
    return {"requests": 12, "serve_equals_generate": True,
            "stale_kv_violations": 0, "launches": counts}


def serve_7b(torch, serve, params, cfg, family="llama"):
    """DecodeService on ``params`` of the ``family`` (4 slots, max_len
    1024, chunk 16, 8 requests): every request finished, no stale KV,
    RMSNorm 2 L + 1 times a call and no flash launch; a profiled decode
    tick."""
    from trainingjob_operator_tpu_torch import ops

    dev = torch.device("cuda")
    svc = serve.DecodeService(params, cfg, slots=4, max_len=1024,
                              prefill_chunk=16, family=family, device=dev)
    svc.warmup()
    traffic = serve.synthetic_traffic(8, seed=0, rate=0.5,
                                      vocab=cfg.vocab_size,
                                      prompt_lens=(16, 64),
                                      out_tokens=(16, 32))
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    result = serve.run_traffic(svc, traffic)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    s = result["stats"]
    per_call = 2 * cfg.n_layers + 1
    expected = per_call * (svc.decode_calls + svc.prefill_calls)
    if s["stale_kv_violations"] != 0:
        raise AssertionError(f"{family} serve: {s['stale_kv_violations']} "
                             f"stale-KV violations")
    if s["completed_total"] != len(traffic) or s["submitted"] != len(traffic):
        raise AssertionError(f"{family} serve finished "
                             f"{s['completed_total']} of {len(traffic)} "
                             f"requests")
    if counts["rmsnorm_fwd"] != expected:
        raise AssertionError(f"{family} serve: {counts['rmsnorm_fwd']} "
                             f"rmsnorm launches, expected {expected}")
    if counts["flash_attention_fwd"] != 0:
        raise AssertionError(f"{family} serve launched the flash kernel")
    if counts["decode_attention"] != cfg.n_layers * svc.decode_calls:
        raise AssertionError(f"{family} serve: {counts['decode_attention']} "
                             f"decode attention launches, expected "
                             f"{cfg.n_layers * svc.decode_calls}")
    routed = cfg.n_layers * (svc.decode_calls + svc.prefill_calls) * (
        family == "moe")
    if not (counts["moe_experts_gate_up"] == counts["moe_experts_down"]
            == routed):
        raise AssertionError(f"{family} serve: expert launches {counts}, "
                             f"expected {routed} of each")
    # A decode tick with every slot at a position inside the cache.
    tokens = torch.arange(1, len(svc.slots) + 1, device=dev)
    ts = torch.arange(len(svc.slots), device=dev) * 100 + 100
    tick = profile_steps(torch, lambda: svc.model.serve_step(
        svc.params, svc.cache, tokens, ts, cfg))
    return {
        "tick": tick,
        "requests": len(traffic), "completed": s["completed_total"],
        "stale_kv_violations": 0, "tokens_total": s["tokens_total"],
        "decode_steps": svc.decode_calls, "prefill_chunks": svc.prefill_calls,
        "wall_s": s["wall_s"],
        "tokens_per_s": s["aggregate_tokens_per_sec"],
        "ttft_ms_p50": s["ttft_ms_p50"],
        "token_latency_ms_p50": s["token_latency_ms_p50"],
        "token_latency_ms_p99": s["token_latency_ms_p99"],
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "launches": counts}


def profile_steps(torch, step, n: int = 5, pick=None):
    """Where one call of ``step`` spends its time: ``n`` calls timed on the
    host clock, then the same under ``torch.profiler`` for device time by
    kernel.  The idle share is 1 - device time / unprofiled wall time.
    ``pick`` (label -> substring of a kernel's name) adds the device ms a
    call of the kernels each label names."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def steps():
        for _ in range(n):
            step()
        torch.cuda.synchronize()

    steps()
    t0 = time.perf_counter()
    steps()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        steps()
    # Device-side events only: the aten:: host events carry their
    # kernels' device time too and would count it twice.
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:8]
    picked = {label: sum(e.self_device_time_total for e in kernels
                         if part in e.key) / 1e3 / n
              for label, part in (pick or {}).items()}
    return {
        "wall_ms": wall_ms, "device_ms": device_ms,
        "idle_share": 1.0 - device_ms / wall_ms if device_ms else None,
        "kernels_per_step": sum(e.count for e in kernels) / n,
        "top": [{"name": e.key[:60], "ms": e.self_device_time_total / 1e3 / n,
                 "calls": e.count / n} for e in top],
        **({"picked_ms": picked} if pick else {})}


def generate_7b(torch, decode, params, cfg):
    """``decode.generate`` (``models/decode.py`` or ``moe_decode.py``) of
    32 greedy tokens after a 512-token prompt: the prefill's L flash
    launches all on the tensor cores, 2 L + 1 RMSNorms a token, the same
    tokens twice; the prefill and decode-step profiles."""
    from trainingjob_operator_tpu_torch import ops

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    prompt = torch.randint(1, cfg.vocab_size, (1, 512), generator=gen,
                           device=dev)
    steps = 32

    def timed(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = decode.generate(params, prompt, cfg, steps=n)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    timed(1)                       # first call of this shape: warm-up
    _, prefill_s = timed(1)        # prefill + the first pick
    ops.reset_launch_counts()
    tokens, total_s = timed(steps)
    counts = ops.launch_counts()
    if not (counts["flash_attention_fwd"]
            == counts["flash_attention_fwd_wgmma"] == cfg.n_layers):
        raise AssertionError(f"generate: flash launches {counts}, "
                             f"expected {cfg.n_layers}, all on the tensor "
                             f"cores")
    if counts["rmsnorm_fwd"] != (2 * cfg.n_layers + 1) * steps:
        raise AssertionError(f"generate: {counts['rmsnorm_fwd']} rmsnorm "
                             f"launches")
    if counts["decode_attention"] != cfg.n_layers * (steps - 1):
        raise AssertionError(f"generate: {counts['decode_attention']} "
                             f"decode attention launches")
    if tuple(tokens.shape) != (1, steps) or not bool(
            ((tokens >= 0) & (tokens < cfg.vocab_size)).all()):
        raise AssertionError(f"generate: bad tokens {tokens.tolist()}")
    again, _ = timed(steps)
    if not torch.equal(again, tokens):
        raise AssertionError("greedy generate is not deterministic")
    _, cache = decode.prefill(params, prompt, cfg, 512 + steps)
    last = tokens[:, -1]
    return {"prompt_len": 512, "steps": steps, "prefill_ms":
            prefill_s * 1e3, "total_ms": total_s * 1e3,
            "per_token_ms": (total_s - prefill_s) / (steps - 1) * 1e3,
            "launches": counts,
            "prefill_profile": profile_steps(
                torch, lambda: decode.prefill(params, prompt, cfg,
                                              512 + steps), n=3),
            "decode_step_profile": profile_steps(
                torch, lambda: decode.decode_step(params, cache, last, 512,
                                                  cfg))}


def tiny_moe_equivalence(torch, moe, moe_decode, serve, llama_elastic,
                         train):
    """The MoE tiny config in fp32 at a dropless capacity (capacity_factor
    = n_experts / experts_per_token, so the whole-prompt prefill drops
    nothing) through the kernels: every request of a MoE DecodeService run
    gets exactly ``moe_decode.generate``'s tokens; then the trainer's step
    with ``moe.loss_fn`` (accum 1, the MoE trainer's) under every remat
    policy on the card equals the CPU's (``train_equivalence``)."""
    dev = torch.device("cuda")
    base = moe.MoEConfig.tiny()
    cfg = dataclasses.replace(
        base, dtype="float32",
        capacity_factor=base.n_experts / base.experts_per_token)
    params = moe.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    served = serve_equals_generate(torch, serve, moe_decode, params, cfg,
                                   "moe")
    init = moe.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                           master=True)
    trained = train_equivalence(torch, cfg, init, llama_elastic, train,
                                accum=1, what="tiny MoE train",
                                loss_fn=moe.loss_fn)
    return {"capacity_factor": cfg.capacity_factor, "serve": served,
            "train": trained}


def gemm_split(torch, step, classify, n: int = 2):
    """Device ms a call of ``step`` spends by class, from one
    ``torch.profiler`` window of ``n`` calls with input shapes: each
    matrix product's kernels (``aten::mm``/``bmm``/``addmm``, host and
    autograd alike) under ``classify(op, shapes)``, the flash and RMSNorm
    kernels by name, and the rest (elementwise work, reductions, copies)
    as ``other``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    split = {}

    def add(key, us):
        split[key] = split.get(key, 0.0) + us / 1e3 / n

    total = 0.0
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name in (
                "aten::mm", "aten::bmm", "aten::addmm"):
            add(classify(e.name, e.input_shapes), e.self_device_time_total)
        elif e.device_type == DeviceType.CUDA:
            total += e.self_device_time_total / 1e3 / n
            for key in ("flash", "rmsnorm"):
                if key in e.name:
                    add(key, e.self_device_time_total)
    split["other"] = total - sum(split.values())
    return {"device_ms": total, "ms": split,
            "share": {k: v / total for k, v in split.items()} if total
            else {}}


def train_moe_width(torch, moe, llama_elastic, train, mesh=None):
    """The MoE trainer's step (``llama_elastic.make_step_fn`` with
    ``moe.loss_fn``) at Mixtral-8x7B widths, 2 of its 32 layers (f32
    masters, gradients and AdamW moments of 3.16e9 parameters: 50.6 GB),
    bf16 compute, seq 4096, global batch 2, remat "none": 8 steps on one
    repeated batch; the loss falls, every flash forward, dQ and dK/dV
    launch on the tensor cores (L a step each) and 2 L + 1 RMSNorms a
    step; step time, tokens/s, peak memory, a step profile and, without a
    ``mesh``, its split into expert GEMMs, dispatch/combine, dense GEMMs,
    kernels and other work (``gemm_split``).  On ``mesh`` where given,
    its collectives counted (``moe_mesh_collectives``)."""
    from trainingjob_operator_tpu_torch import ops
    from trainingjob_operator_tpu_torch.parallel import collectives

    dev = torch.device("cuda")
    cfg = dataclasses.replace(moe.MoEConfig.mixtral_8x7b(), n_layers=2)
    seq, batch, steps, lr, remat = 4096, 2, 8, 3e-4, "none"
    t0 = time.perf_counter()
    params = moe.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev, master=True,
        mesh=mesh)
    for leaf in train.tree_leaves(params):
        leaf.requires_grad_(True)
    step_fn = llama_elastic.make_step_fn(params, cfg, accum=1, lr=lr,
                                         remat=remat, mesh=mesh,
                                         loss_fn=moe.loss_fn)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq + 1),
                           generator=gen, device=dev)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    collectives.reset_collective_counts()
    losses, step_s = [], []
    for _ in range(steps):
        t = time.perf_counter()
        losses.append(float(step_fn(tokens)))
        step_s.append(time.perf_counter() - t)
    counts = ops.launch_counts()
    sent = collectives.collective_counts()
    want = {k: 0 for k in sent}
    if mesh is not None:
        want = {k: n * steps for k, n in
                moe_mesh_collectives(cfg.n_layers, 1).items()}
    if sent != want:
        raise AssertionError(f"MoE-width train: collectives {sent}, "
                             f"expected {want}")
    peak = torch.cuda.max_memory_allocated()
    per_step = train_launches(cfg.n_layers, remat, 1, tensor_cores=True)
    if counts != {k: n * steps for k, n in per_step.items()}:
        raise AssertionError(f"MoE-width train: launches {counts}, "
                             f"expected {per_step} per step x {steps}")
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"MoE-width train: losses {losses}")
    steady = sorted(step_s[1:])[len(step_s[1:]) // 2]

    def classify(op, shapes):
        if op != "aten::bmm":
            return "dense_gemm"
        dims = {d for shape in shapes for d in (shape or ())}
        return "expert_gemm" if cfg.ffn_dim in dims else "dispatch_combine"

    out = {"n_layers": cfg.n_layers, "n_params": moe.num_params(cfg),
           "active_params": moe.active_params(cfg),
           "capacity": moe.expert_capacity(cfg, seq), "seq": seq,
           "global_batch": batch, "remat": remat, "lr": lr,
           "init_s": init_s, "losses": losses, "step_s": step_s,
           "step_s_median": steady, "tokens_per_s": batch * seq / steady,
           "peak_mem_gib": peak / 2 ** 30,
           "launches_per_step": per_step, "launches": counts,
           "collectives": sent,
           "step_profile": profile_steps(torch, lambda: step_fn(tokens),
                                         n=2)}
    if mesh is None:
        out["step_split"] = gemm_split(torch, lambda: step_fn(tokens),
                                       classify)
    return out


@contextlib.contextmanager
def environ(**values):
    """``os.environ`` with ``values`` set, restored on exit."""
    import os

    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def run_main(torch, main, **env):
    """(exit code, output lines, launches) of an entry point's ``main``
    run in this process under ``env``."""
    from trainingjob_operator_tpu_torch import ops

    buf = io.StringIO()
    ops.reset_launch_counts()
    with environ(**env), contextlib.redirect_stdout(buf), \
            warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        rc = main([])
    torch.cuda.synchronize()
    return rc, buf.getvalue().splitlines(), ops.launch_counts()


#: moe_resume: steps of the uninterrupted run (a tiny step takes
#: milliseconds: the SIGTERM after step 4 must land well before the end).
MOE_RESUME_STEPS = 40


def moe_resume(torch, moe, moe_decode, train, sink, workdir):
    """The MoE trainer's entry point (``python -m ...moe_pretrain``) at
    MOE_CONFIG=tiny (bf16, seq 128, batch 8), as processes on the card,
    on two paths: one card (no coordinator, the single-process checkpoint
    format) and a coordinator at world 1 (a group of one on NCCL, the mesh
    path and the sharded format).  On each: a run given SIGTERM after step
    4, which must exit 143 with its step committed (beside it, an
    uninterrupted run of the same path on another directory); a restart,
    whose losses (from the telemetry records) equal the uninterrupted
    run's bit for bit; then the ``generate`` main with GEN_FAMILY=moe on
    its checkpoint (and ``serve`` on the single-card one)."""
    import os

    from trainingjob_operator_tpu_torch.workloads import generate
    from trainingjob_operator_tpu_torch.workloads import serve as serve_mod

    N = MOE_RESUME_STEPS
    code = trainer_code("moe_pretrain")
    runs, launches = {}, []
    cfg = moe.MoEConfig.tiny()
    prompt = [1, 45, 96, 17, 29]

    def env_of(job, ckpt, mesh):
        env = dict(os.environ)
        env.update({"MOE_CONFIG": "tiny", "MOE_STEPS": str(N),
                    "MOE_CKPT_EVERY": str(RESUME_CKPT_EVERY),
                    "TRAININGJOB_CHECKPOINT_DIR": ckpt,
                    "TRAININGJOB_TELEMETRY_ADDR": sink.address,
                    "TRAININGJOB_NAMESPACE": "smoke",
                    "TRAININGJOB_NAME": job})
        if mesh:
            env.update({"TRAININGJOB_COORDINATOR_ADDRESS":
                        f"127.0.0.1:{free_port()}",
                        "TRAININGJOB_NUM_PROCESSES": "1"})
        return env

    def run(job, ckpt, mesh, sigterm_after=""):
        return record(job, *run_trainer(env_of(job, ckpt, mesh), 300,
                                        sigterm_after, code))

    def record(job, rc, lines, counts, secs):
        if counts is not None:
            launches.append(counts)
        recs = sink.steps(job)
        runs[job] = {"rc": rc, "wall_s": secs,
                     "first_step_s": float(line_fields(
                         lines, "recovery_timing first_step_s").get(
                             "first_step_s", "nan")),
                     "losses": {r["step"] + 1: r["loss"] for r in recs}}
        return rc, lines

    def preempted(path, ckpt, rc, lines):
        expect(rc == 143 and lines[-1]
               == "preemption checkpoint committed; exiting 143",
               f"MoE {path} preempted run exited {rc}", lines)
        k = train.committed_steps(os.path.join(ckpt, "moe"))[0]
        expect(4 <= k < N, f"MoE {path} preempted run committed step {k}",
               lines)
        return k

    def restarted(path, job, ckpt, mesh, k, want):
        rc, lines = run(job, ckpt, mesh)
        got = runs[job]["losses"]
        expect(rc == 0 and f"resumed at step {k} (width 1)" in lines,
               f"MoE {path} restart did not resume", lines)
        expect(sorted(got) == list(range(k + 1, N + 1))
               and all(got[i] == want[i] for i in got),
               f"MoE {path} restart: losses {got} differ from {want}",
               lines)

    def generated(path, ckpt, saved):
        params = train._onto(moe.init_params(cfg, None, "cuda"), saved)
        rc, out, counts = run_main(
            torch, generate.main, GEN_FAMILY="moe", GEN_STEPS="16",
            GEN_PROMPT=",".join(map(str, prompt)),
            TRAININGJOB_CHECKPOINT_DIR=ckpt)
        launches.append(counts)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            want_tokens = moe_decode.generate(
                params, torch.tensor([prompt], device="cuda"), cfg,
                steps=16)[0].tolist()
        expect(rc == 0 and f"sampling from checkpoint at step {N}" in out
               and f"tokens: {','.join(map(str, want_tokens))}" in out,
               f"MoE {path} generate from the checkpoint: {want_tokens}",
               out)
        return want_tokens

    ckpt = os.path.join(workdir, "moe_resume")
    mesh_ckpt = os.path.join(workdir, "moe_mesh_resume")
    # The uninterrupted runs, on their own directories, beside the
    # preempted ones.
    with trainer_beside(env_of("moe_uninterrupted",
                               os.path.join(workdir, "moe_plain"), False),
                        code) as uninterrupted, \
            trainer_beside(env_of("moe_mesh_uninterrupted",
                                  os.path.join(workdir, "moe_mesh_plain"),
                                  True), code) as mesh_uninterrupted:
        rc, lines = run("moe_preempted", ckpt, False,
                        sigterm_after=SIGTERM_AFTER)
        mesh_rc, mesh_lines = run("moe_mesh_preempted", mesh_ckpt, True,
                                  sigterm_after=SIGTERM_AFTER)
        plain = {job: record(job, *join(300)) for job, join in (
            ("moe_uninterrupted", uninterrupted),
            ("moe_mesh_uninterrupted", mesh_uninterrupted))}
    for job, (rc_plain, lines_plain) in plain.items():
        expect(rc_plain == 0 and sorted(runs[job]["losses"])
               == list(range(1, N + 1)), f"MoE {job} run", lines_plain)
    expect("mesh {'dp': 1, 'pp': 1, 'fsdp': 1, 'tp': 1, 'sp': 1, 'ep': 1}"
           in " ".join(plain["moe_mesh_uninterrupted"][1]),
           "MoE coordinator run: no mesh line",
           plain["moe_mesh_uninterrupted"][1])
    k = preempted("single-card", ckpt, rc, lines)
    mesh_k = preempted("coordinator", mesh_ckpt, mesh_rc, mesh_lines)
    restarted("single-card", "moe_restarted", ckpt, False, k,
              runs["moe_uninterrupted"]["losses"])
    restarted("coordinator", "moe_mesh_restarted", mesh_ckpt, True, mesh_k,
              runs["moe_mesh_uninterrupted"]["losses"])

    saved = torch.load(os.path.join(ckpt, "moe", str(N), "params.pt"),
                       weights_only=True)
    want_tokens = generated("single-card", ckpt, saved)
    rc, out, counts = run_main(
        torch, serve_mod.main, GEN_FAMILY="moe",
        TRAININGJOB_SERVE_REQUESTS="8", TRAININGJOB_CHECKPOINT_DIR=ckpt)
    launches.append(counts)
    done = line_fields(out, "serve done:")
    expect(rc == 0 and f"serving the checkpoint at step {N}" in out
           and "serve: family=moe " in " ".join(out)
           and done.get("completed") == "8"
           and done.get("stale_kv_violations") == "0",
           "MoE serve from the checkpoint", out)
    step_dir = os.path.join(mesh_ckpt, "moe", str(N))
    expect(os.listdir(step_dir) == ["shard-0.pt"],
           f"MoE coordinator checkpoint holds {os.listdir(step_dir)}", [])
    shard = torch.load(os.path.join(step_dir, "shard-0.pt"),
                       weights_only=True)
    mesh_tokens = generated("coordinator", mesh_ckpt,
                            shard["value"]["params"])
    single, meshed = (runs[job]["losses"] for job in (
        "moe_uninterrupted", "moe_mesh_uninterrupted"))
    return {"config": "tiny", "steps": N, "ckpt_every": RESUME_CKPT_EVERY,
            "preempted_at_committed_step": k,
            "mesh_preempted_at_committed_step": mesh_k, "runs": runs,
            "bit_identical_after_resume": True,
            "mesh_losses_equal_single_card": meshed == single,
            "mesh_loss_max_rel_err_vs_single_card": max(
                abs(meshed[i] - single[i]) / abs(single[i]) for i in single),
            "generate_tokens": want_tokens,
            "mesh_generate_tokens": mesh_tokens, "serve_done": done,
            "launches": {key: sum(c[key] for c in launches)
                         for key in launches[0]}}


# -- the three workloads of config 1, 3 and 4 ---------------------------------

#: bert_base: BERT-base (12 layers, bf16) at the BERT paper's phase-1
#: pretraining shape, seq 128 and global batch 256, on one repeated batch.
BERT_SEQ, BERT_BATCH, BERT_STEPS, BERT_LR = 128, 256, 8, 1e-4
#: resnet50: ResNet-50 at ImageNet resolution, global batch 128, bf16,
#: the trainer's SGD (momentum 0.9) on one repeated batch, at lr 0.01:
#: at the trainer's 0.1 the loss on one repeated batch overshoots within
#: a few steps and climbs back, and the step's time does not depend on
#: the rate.
RESNET_IMAGE, RESNET_BATCH, RESNET_STEPS, RESNET_LR = 224, 128, 8, 0.01
#: Tiny fp32 trajectories, the card against the CPU (TF32 off for cuBLAS
#: and cuDNN: main sets it), relative.
TINY_TRAJ_RTOL = 1e-4
#: Steps of the tiny trajectories.
TINY_TRAJ_STEPS = 4


def op_split(torch, step, classify, ranges, n: int = 2):
    """Device ms a call of ``step`` spends by class, from one
    ``torch.profiler`` window of ``n`` calls with input shapes: all the
    kernels under a ``record_function`` range of ``ranges`` (name ->
    class), and each other op's own kernels (host and autograd calls
    alike) under ``classify(names, shapes)`` (the op's name and those of
    the ops it runs inside, innermost first; its input shapes), where
    that gives a class; the rest as ``other``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    split = {}

    def add(key, us):
        split[key] = split.get(key, 0.0) + us / 1e3 / n

    total = 0.0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            total += e.self_device_time_total / 1e3 / n
            continue
        names, parent = [e.name], e.cpu_parent
        while parent is not None:
            names.append(parent.name)
            parent = parent.cpu_parent
        if e.name in ranges:
            add(ranges[e.name], e.device_time_total)
        elif not any(name in ranges for name in names[1:]):
            key = classify(names, [tuple(x) for x in e.input_shapes
                                   if isinstance(x, (list, tuple))])
            if key and e.self_device_time_total:
                add(key, e.self_device_time_total)
    split["other"] = total - sum(split.values())
    return {"device_ms": total, "ms": split,
            "share": {k: v / total for k, v in split.items()} if total
            else {}}


def _ranged(opt, name: str):
    """``opt.step`` run under ``record_function(name)``, for ``op_split``
    to find the optimizer's kernels."""
    from torch.profiler import record_function

    real = opt.step

    def step(params, grads):
        with record_function(name):
            real(params, grads)

    opt.step = step


def no_launches(what: str, counts) -> dict:
    """The workloads of configs 1, 3 and 4 reach no TPU kernel in the
    reference, so their paths launch none of the port's: ``counts`` must
    be all zero."""
    if any(counts.values()):
        raise AssertionError(f"{what}: kernel launches {counts}")
    return dict(counts)


def tiny_trajectory(torch, run) -> dict:
    """``run(device)`` (TINY_TRAJ_STEPS losses of a tiny fp32 config from
    the same parameters and batches) on the card and on the CPU: within
    TINY_TRAJ_RTOL of each other at every step."""
    card, cpu = run("cuda"), run("cpu")
    rel = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
    if not rel <= TINY_TRAJ_RTOL:
        raise AssertionError(f"tiny trajectory: card {card} vs cpu {cpu}")
    return {"card": card, "cpu": cpu, "max_rel_err": rel,
            "rtol": TINY_TRAJ_RTOL}


def width_steps(torch, step, steps: int) -> dict:
    """``steps`` calls of ``step`` (each returns the loss) from zeroed
    launch counters: the losses, each step's seconds (synchronised), the
    median of steps 2 on, the peak memory and the launches."""
    from trainingjob_operator_tpu_torch import ops

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    losses, step_s = [], []
    for _ in range(steps):
        t = time.perf_counter()
        losses.append(float(step()))
        step_s.append(time.perf_counter() - t)
    counts = ops.launch_counts()
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"losses {losses}")
    steady = sorted(step_s[1:])[len(step_s[1:]) // 2]
    return {"losses": losses, "step_s": step_s, "step_s_median": steady,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "launches": counts}


#: Steps of train_124m_f32 held against the same steps with attention
#: through the plain PyTorch version, and the relative limit: both run the
#: same f32 GEMMs (TF32 off) on the same numbers, and the flash kernels
#: differ from the plain attention only in the order of f32 sums.
F32_PLAIN_STEPS = 3
F32_PLAIN_RTOL = 1e-5
#: Device kernels of the f32-FMA flash route, by a part of their names.
FMA_KERNEL_NAMES = {"flash_attention_fwd": "flash_fwd_kernel",
                    "flash_attention_bwd_dq": "flash_bwd_dq_kernel",
                    "flash_attention_bwd_dkv": "flash_bwd_dkv_kernel"}


@contextlib.contextmanager
def plain_attention(llama, flash):
    """The model's attention through the plain PyTorch version (autograd
    through its einsums), for this script's reference runs only."""
    real = llama.flash_attention

    def plain(q, k, v, *, causal=True, scale=None, window=0):
        return flash.flash_reference_with_lse(q, k, v, causal=causal,
                                              scale=scale, window=window)[0]
    llama.flash_attention = plain
    try:
        yield
    finally:
        llama.flash_attention = real


@contextlib.contextmanager
def counted_copies(flash):
    """Count the inputs the f32-FMA wrappers copy first (``fma_operand``
    returning a copy) while the block runs."""
    real = flash.fma_operand
    made = [0]

    def operand(t):
        out = real(t)
        made[0] += out is not t
        return out
    flash.fma_operand = operand
    try:
        yield made
    finally:
        flash.fma_operand = real


def train_124m_f32(torch, llama, llama_elastic, train, flash):
    """The 124M trainer's step (``llama_elastic.make_step_fn``) at float32
    (``LLAMA_CONFIG=124m LLAMA_DTYPE=float32``): head dim 64, so every
    flash launch takes the f32-FMA kernels.  Seq 1024, batch 8, remat
    "none", 8 steps on one batch, TF32 off for cuBLAS and cuDNN.  Gates:
    the loss falls; the first F32_PLAIN_STEPS losses equal, within
    F32_PLAIN_RTOL, those of a run from the same parameters whose
    attention goes through the plain version (``plain_attention``);
    launches as ``train_launches`` counts them, none on the tensor
    cores; no copy of a kernel's input (``counted_copies``).  Step time
    (median of steps 2-8), tokens/s, peak memory, the idle share and the
    flash kernels' device ms a step."""
    dev = torch.device("cuda")
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.backends.cudnn.allow_tf32):
        raise AssertionError("train_124m_f32 needs TF32 off")
    cfg = dataclasses.replace(llama.LlamaConfig.base_124m(),
                              dtype="float32")
    seq, batch, steps, lr = 1024, 8, 8, 3e-4
    init = llama.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             dev, master=True)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq + 1),
                           generator=torch.Generator(device=dev)
                           .manual_seed(3), device=dev)

    def step_fn():
        params = train.trainable_copy(init, dev)
        return llama_elastic.make_step_fn(params, cfg, accum=1, lr=lr,
                                          remat="none")

    with plain_attention(llama, flash):
        plain_fn = step_fn()
        plain = width_steps(torch, lambda: plain_fn(tokens), F32_PLAIN_STEPS)
    del plain_fn
    torch.cuda.empty_cache()
    kernel_fn = step_fn()
    with counted_copies(flash) as copies:
        run = width_steps(torch, lambda: kernel_fn(tokens), steps)
    if copies[0]:
        raise AssertionError(f"124M f32 train: {copies[0]} kernel inputs "
                             f"copied first")
    rel = max(abs(a - b) / abs(b) for a, b in
              zip(run["losses"][:F32_PLAIN_STEPS], plain["losses"]))
    if not rel <= F32_PLAIN_RTOL:
        raise AssertionError(f"124M f32 train: losses {run['losses']} vs "
                             f"plain attention {plain['losses']}")
    per_step = train_launches(cfg.n_layers, "none", 1)
    if run["launches"] != {k: n * steps for k, n in per_step.items()}:
        raise AssertionError(f"124M f32 train: launches {run['launches']}, "
                             f"expected {per_step} per step x {steps}")
    if any(plain["launches"][key] for key in FMA_KERNEL_NAMES):
        raise AssertionError(f"124M f32 train: the plain-attention run "
                             f"launched {plain['launches']}")
    profile = profile_steps(torch, lambda: kernel_fn(tokens), n=2,
                            pick=FMA_KERNEL_NAMES)
    return {"n_layers": cfg.n_layers, "n_params": llama.num_params(cfg),
            "dtype": cfg.dtype, "head_dim": cfg.head_dim, "seq": seq,
            "global_batch": batch, "remat": "none", "lr": lr,
            "allow_tf32": {"cuda.matmul": False, "cudnn": False},
            **run, "tokens_per_s": batch * seq / run["step_s_median"],
            "plain_attention_losses": plain["losses"],
            "plain_loss_max_rel_err": rel, "plain_loss_rtol": F32_PLAIN_RTOL,
            "launches_per_step": per_step, "fma_operand_copies": copies[0],
            "step_profile": profile,
            "flash_ms_per_step": profile["picked_ms"]}


def bert_base(torch, bert, bert_pretrain, train):
    """BERT-base (vocab 30522, dim 768, 12 layers, 12 heads, ffn 3072) in
    bf16 on one card, the trainer's step (``bert_pretrain.make_step``:
    AdamW b2 0.999, weight decay 0.01) at seq 128 and global batch 256,
    8 steps on one repeated batch: the loss falls, no kernel of the port
    is launched; step time, tokens/s, peak memory, a step profile (idle
    share) and its split into dense GEMMs, attention (the two batched
    products and all the work on the [B, H, T, T] scores), LayerNorm and
    GELU, the f32 logits and cross-entropy, AdamW and the rest.
    Beside it, the tiny fp32 config's trajectory on the card and on the
    CPU."""
    dev = torch.device("cuda")
    cfg = bert.BertConfig.base()
    t0 = time.perf_counter()
    params = bert.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                              dev)
    for leaf in train.tree_leaves(params):
        leaf.requires_grad_(True)
    step = bert_pretrain.make_step(params, cfg, lr=BERT_LR)
    _ranged(step.opt, "adamw")
    batch = {k: v.to(dev) for k, v in bert_pretrain.batch_at(
        0, BERT_BATCH, BERT_SEQ, cfg.vocab_size).items()}
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    out = width_steps(torch, lambda: step(batch), BERT_STEPS)
    no_launches("bert_base", out["launches"])

    def classify(names, shapes):
        op = names[0]
        if op in ("aten::mm", "aten::addmm"):
            return "gemm"
        if op == "aten::bmm" or any(
                len(x) == 4 and x[-2:] == (BERT_SEQ, BERT_SEQ)
                for x in shapes):
            # The two batched products and all the [B, H, T, T] work: the
            # scale, the mask, the f32 softmax and its casts.
            return "attention"
        if any("layer_norm" in name or "gelu" in name for name in names):
            return "layernorm_gelu"
        if any(cfg.vocab_size in x for x in shapes):
            # The f32 logits: their cast, mlm_bias, the cross-entropy.
            return "logits_ce"
        return None

    def tiny(where):
        c = dataclasses.replace(bert.BertConfig.tiny(), dtype="float32")
        p = bert.init_params(c, torch.Generator().manual_seed(0), where)
        for leaf in train.tree_leaves(p):
            leaf.requires_grad_(True)
        s = bert_pretrain.make_step(p, c, lr=1e-3)
        return [float(s({k: v.to(where) for k, v in bert_pretrain.batch_at(
            i, 8, 64, c.vocab_size).items()})) for i in range(TINY_TRAJ_STEPS)]

    tokens = BERT_BATCH * BERT_SEQ
    return {"n_layers": cfg.n_layers, "n_params": bert.num_params(cfg),
            "dtype": cfg.dtype, "seq": BERT_SEQ, "global_batch": BERT_BATCH,
            "lr": BERT_LR, "init_s": init_s, **out,
            "tokens_per_s": tokens / out["step_s_median"],
            "model_tflops_per_s": 6.0 * bert.num_params(cfg) * tokens
            / out["step_s_median"] / 1e12,
            "step_profile": profile_steps(torch, lambda: step(batch), n=2),
            "step_split": op_split(torch, lambda: step(batch), classify,
                                   {"adamw": "adamw"}),
            "tiny_fp32_trajectory": tiny_trajectory(torch, tiny)}


def resnet50(torch, resnet, resnet_dp, train):
    """ResNet-50 ([3, 4, 6, 3], width 64, 1000 classes) in bf16 on one
    card, the trainer's step (``resnet_dp.make_step``: SGD, momentum 0.9,
    ``channels_last`` images; lr RESNET_LR) at 224 px and global batch
    128, 8 steps on one repeated batch, cuDNN's deterministic
    convolutions as in the trainer: the loss falls, the running
    statistics stay finite, no kernel of the port is launched; step time,
    images/s, peak memory, a step profile (idle share) and its split into
    convolutions, batch norm with relu and the other work on activations,
    pads and pools, SGD, the head and the rest.  Beside it, the tiny
    fp32 config's trajectory on the card and on the CPU."""
    dev = torch.device("cuda")
    cfg = resnet.ResNetConfig.resnet50()
    # As the trainer runs (a resume must equal an uninterrupted run).
    resnet_dp.deterministic_convolutions()
    t0 = time.perf_counter()
    params, stats = resnet.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    for leaf in train.tree_leaves(params):
        leaf.requires_grad_(True)
    step = resnet_dp.make_step(params, stats, cfg, lr=RESNET_LR,
                               channels_last=True)
    _ranged(step.opt, "sgd")
    images, labels = resnet_dp.batch_at(0, RESNET_BATCH, RESNET_IMAGE,
                                        cfg.num_classes)
    images, labels = images.to(dev), labels.to(dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    out = width_steps(torch, lambda: step(images, labels), RESNET_STEPS)
    no_launches("resnet50", out["launches"])
    finite = all(bool(torch.isfinite(x).all())
                 for x in train.tree_leaves(stats))
    if not finite:
        raise AssertionError("resnet50: running statistics not finite")

    def classify(names, shapes):
        if any("convolution" in name for name in names):
            return "conv"
        if any("pad" in name or "max_pool" in name for name in names):
            return "pad_pool"
        if names[0] in ("aten::mm", "aten::addmm"):
            return "head_gemm"
        if any(len(x) == 4 for x in shapes):
            # Batch norm's f32 work on the activations, relu, the
            # residual adds and the casts.
            return "bn_relu_elementwise"
        return None

    def tiny(where):
        c = dataclasses.replace(resnet.ResNetConfig.tiny(), dtype="float32")
        p, s = resnet.init_params(c, torch.Generator().manual_seed(0), where)
        for leaf in train.tree_leaves(p):
            leaf.requires_grad_(True)
        st = resnet_dp.make_step(p, s, c, lr=RESNET_LR,
                                 channels_last=where == "cuda")
        out = []
        for i in range(TINY_TRAJ_STEPS):
            x, y = resnet_dp.batch_at(i, 8, 64, c.num_classes)
            out.append(float(st(x.to(where), y.to(where))))
        return out

    return {"stage_sizes": list(cfg.stage_sizes),
            "n_params": resnet.num_params(cfg), "dtype": cfg.dtype,
            "image": RESNET_IMAGE, "global_batch": RESNET_BATCH,
            "lr": RESNET_LR, "init_s": init_s, **out,
            "imgs_per_s": RESNET_BATCH / out["step_s_median"],
            "stats_finite": finite,
            "step_profile": profile_steps(
                torch, lambda: step(images, labels), n=2),
            "step_split": op_split(torch, lambda: step(images, labels),
                                   classify, {"sgd": "sgd"}),
            "tiny_fp32_trajectory": tiny_trajectory(torch, tiny)}


#: The kill-and-resume runs: each workload's steps, and the step whose
#: committed save the killed run dies after (``TRAININGJOB_KILL_AT_STEP``).
MNIST_STEPS, MNIST_KILL_AT = 60, 20
WORKLOAD_STEPS, WORKLOAD_KILL_AT = 20, 10
#: BERT's tiny config holds 64 positions: the trainer's default BERT_SEQ
#: of 128 does not fit it (in JAX either).
TINY_BERT_SEQ = 64


def _saved(torch, ckpt, step: int, sharded: bool = False):
    """The items of committed step ``step`` under ``ckpt``: a sharded
    format's one shard's value, or the single-process format's files."""
    import os

    d = os.path.join(ckpt, str(step))
    if sharded:
        return torch.load(os.path.join(d, "shard-0.pt"),
                          weights_only=True)["value"]
    return {n[:-3]: torch.load(os.path.join(d, n), weights_only=True)
            for n in sorted(os.listdir(d)) if n.endswith(".pt")}


def _same_state(torch, a, b) -> bool:
    """Whether two checkpoint trees are bit-identical."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and set(a) == set(b)
                and all(_same_state(torch, a[k], b[k]) for k in a))
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and torch.equal(a, b)
    return a == b


def workload_resumes(torch, workdir):
    """The kill-and-resume contract of the JAX mains of configs 1, 3 and 4
    (they checkpoint every 20 or 10 steps and install no SIGTERM handler):
    each entry point (``python -m ...workloads.mnist`` at JAX's defaults,
    ``bert_pretrain`` and ``resnet_dp`` tiny) as processes on the card.
    Per path, an uninterrupted run and a run killed (SIGKILL, exit -9)
    once its save of step MNIST_KILL_AT / WORKLOAD_KILL_AT has committed,
    all started together; then each killed run's restart
    (``TRAININGJOB_REPLICA_RESTARTCOUNT=1``), BERT's and ResNet's
    together, MNIST's alone (its start-to-first-step time is the recovery
    figure of config 1).  The restart resumes at the committed step, its
    loss lines equal the uninterrupted run's, and its last checkpoint
    (parameters, optimizer state and, for ResNet, the statistics) equals
    the uninterrupted run's bit for bit.  BERT runs twice: on one card,
    and with a coordinator at world 1 (a group of one on NCCL, the mesh
    path, a sharded checkpoint).  Returns the three phases' results."""
    import os

    bert_code = trainer_code("bert_pretrain")
    codes = {"mnist": trainer_code("mnist"), "bert": bert_code,
             "bert_mesh": bert_code, "resnet": trainer_code("resnet_dp")}
    envs = {"mnist": {"MNIST_STEPS": str(MNIST_STEPS)},
            "bert": {"BERT_CONFIG": "tiny", "BERT_SEQ": str(TINY_BERT_SEQ),
                     "BERT_STEPS": str(WORKLOAD_STEPS)},
            "bert_mesh": {"BERT_CONFIG": "tiny",
                          "BERT_SEQ": str(TINY_BERT_SEQ),
                          "BERT_STEPS": str(WORKLOAD_STEPS)},
            "resnet": {"RESNET_CONFIG": "tiny",
                       "RESNET_STEPS": str(WORKLOAD_STEPS)}}
    kill_at = {"mnist": MNIST_KILL_AT}
    steps = {"mnist": MNIST_STEPS}

    def env_of(path, ckpt, **extra):
        env = dict(os.environ)
        env.update({**envs[path], "TRAININGJOB_CHECKPOINT_DIR": ckpt,
                    **extra})
        if path == "bert_mesh":
            env.update({"TRAININGJOB_COORDINATOR_ADDRESS":
                        f"127.0.0.1:{free_port()}",
                        "TRAININGJOB_NUM_PROCESSES": "1"})
        return env

    def ckpt(path, run):
        return os.path.join(workdir, f"{path}_{run}")

    runs, launches = {}, {}

    def record(path, run, rc, lines, counts, secs):
        runs.setdefault(path, {})[run] = {"rc": rc, "wall_s": secs}
        if counts is not None:
            launches.setdefault(path, []).append(counts)
        return rc, lines

    t0 = time.perf_counter()
    out = {}
    with contextlib.ExitStack() as stack:
        joins = {}
        for path in codes:
            k = kill_at.get(path, WORKLOAD_KILL_AT)
            joins[(path, "uninterrupted")] = stack.enter_context(
                trainer_beside(env_of(path, ckpt(path, "whole")),
                               codes[path]))
            joins[(path, "killed")] = stack.enter_context(trainer_beside(
                env_of(path, ckpt(path, "kill"),
                       TRAININGJOB_KILL_AT_STEP=str(k)), codes[path]))
        for (path, run), join in joins.items():
            out[(path, run)] = record(path, run, *join(600))
    first_wave_s = time.perf_counter() - t0
    for path in codes:
        k = kill_at.get(path, WORKLOAD_KILL_AT)
        n = steps.get(path, WORKLOAD_STEPS)
        rc, lines = out[(path, "uninterrupted")]
        expect(rc == 0 and any(ln.startswith(f"step {n}/{n} loss")
                               for ln in lines),
               f"{path} uninterrupted run exited {rc}", lines)
        rc, lines = out[(path, "killed")]
        expect(rc == -9 and f"killed at step {k}" in lines
               and not any(ln.startswith(f"step {n}/{n}") for ln in lines),
               f"{path} killed run exited {rc}", lines)

    def restart(path):
        return run_trainer(env_of(path, ckpt(path, "kill"),
                                  TRAININGJOB_REPLICA_RESTARTCOUNT="1"),
                           600, code=codes[path])

    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        joins = {path: stack.enter_context(trainer_beside(
            env_of(path, ckpt(path, "kill"),
                   TRAININGJOB_REPLICA_RESTARTCOUNT="1"), codes[path]))
            for path in ("bert", "bert_mesh", "resnet")}
        for path, join in joins.items():
            out[(path, "restarted")] = record(path, "restarted", *join(600))
    second_wave_s = time.perf_counter() - t0
    out[("mnist", "restarted")] = record("mnist", "restarted",
                                         *restart("mnist"))

    def loss_lines(lines):
        return [ln for ln in lines if ln.startswith("step ")
                and " loss " in ln]

    results = {}
    for path in codes:
        k = kill_at.get(path, WORKLOAD_KILL_AT)
        n = steps.get(path, WORKLOAD_STEPS)
        rc, lines = out[(path, "restarted")]
        whole = loss_lines(out[(path, "uninterrupted")][1])
        after = loss_lines(lines)
        expect(rc == 0 and after == [ln for ln in whole
                                     if int(ln.split()[1].split("/")[0]) > k]
               and after, f"{path} restart: loss lines {after} vs {whole}",
               lines)
        if path == "mnist":
            done = line_fields(lines, "done:")
            expect(done.get("steps") == str(n - k)
                   and done.get("restart_count") == "1",
                   f"mnist restart's done line {done}", lines)
            where = ("worker", "0")
        elif path == "resnet":
            expect(f"resumed at step {k}" in lines
                   and line_fields(lines, "done:").get("restart_count")
                   == "1", "resnet restart did not resume", lines)
            where = ("worker", "0")
        else:
            expect(f"resumed at step {k}" in lines,
                   f"{path} restart did not resume", lines)
            where = ("bert",)
        sharded = path == "bert_mesh"
        a, b = (_saved(torch, os.path.join(ckpt(path, run), *where), n,
                       sharded) for run in ("whole", "kill"))
        expect(_same_state(torch, a, b),
               f"{path}: the restart's step {n} differs from the "
               f"uninterrupted run's", lines)
        if path == "mnist":
            first = float(whole[0].split()[-1])
            last = float(whole[-1].split()[-1])
            expect(last < first, f"mnist: loss {first} -> {last}", whole)
        counts = launches.get(path, [])
        expect(len(counts) == 2, f"{path}: launches of {len(counts)} runs",
               lines)
        total = {key: sum(c[key] for c in counts) for key in counts[0]}
        no_launches(path, total)
        results[path] = {"steps": n, "killed_after_committed_step": k,
                         "runs": runs[path], "loss_lines": whole,
                         "restart_loss_lines": after,
                         "bit_identical_after_resume": True,
                         "launches": total,
                         "first_wave_s": first_wave_s}
        if path != "mnist":
            results[path]["restart_wave_s"] = second_wave_s
    timing = line_fields(out[("mnist", "restarted")][1], "recovery_timing")
    split = {key: float(timing[key]) for key in
             ("imports_s", "init_s", "setup_s", "restore_s", "first_step_s",
              "main_to_first_step_s") if key in timing}
    split["process_start_to_first_step_s"] = (
        split.get("imports_s", float("nan"))
        + split.get("main_to_first_step_s", float("nan")))
    results["mnist"]["restart_timing"] = split
    results["mnist"]["config"] = {"hidden": 256, "batch": 128, "lr": 1e-3}
    results["bert"]["mesh"] = results.pop("bert_mesh")
    results["bert"]["mesh"]["backend"] = "nccl"
    for path in ("bert", "resnet"):
        results[path]["config"] = "tiny"
    results["bert"]["launches"] = {
        key: results["bert"]["launches"][key]
        + results["bert"]["mesh"]["launches"][key]
        for key in results["bert"]["launches"]}
    return results


def tiny_train_runs(tiny_train):
    """The per-policy results of ``tiny_train_equivalence``."""
    return [v for v in tiny_train.values()
            if isinstance(v, dict) and "launches" in v]


def summary(name, route, source, replaces, cases, main_case, launches):
    row = dict(main_case)
    return {
        "name": name, "route": route, "source": source,
        "replaces": replaces, "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": row["library_ms"],
        "main_case": {k: v for k, v in row.items()
                      if k not in ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms")},
        "cases": cases}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    import torch.nn.functional as F

    from trainingjob_operator_tpu_torch import ops
    from trainingjob_operator_tpu_torch.models import (
        bert,
        decode,
        llama,
        moe,
        moe_decode,
        resnet,
    )
    from trainingjob_operator_tpu_torch.ops import _build, fused
    from trainingjob_operator_tpu_torch.ops import decode_attention as da
    from trainingjob_operator_tpu_torch.ops import moe_experts as me
    from trainingjob_operator_tpu_torch.workloads import (
        bert_pretrain,
        llama_elastic,
        resnet_dp,
        serve,
        train,
    )

    flash = sys.modules["trainingjob_operator_tpu_torch.ops.flash_attention"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    lib_path = _build.found["path"]
    ptxas = [line.strip() for line in
             (lib_path.parent / f"{_build.source_tag()}.log").read_text()
             .splitlines() if "registers" in line or "Compiling entry" in
             line or "spill" in line]
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "toolkit": _build.toolkit(),
          "build_s": build_s, "build": _build.found["how"],
          "library": lib_path.name, "ptxas": ptxas})

    rms_cases = check_rmsnorm(torch, F, fused)
    flash_cases = check_flash(torch, F, flash)
    dq_cases, dkv_cases = check_flash_bwd(torch, F, flash)
    decode_cases = check_decode_attention(torch, F, da)
    expert_cases = check_moe_experts(torch, F, me)
    emit({"phase": "kernel_checks", "device": name, "nvidia_smi": smi,
          "rmsnorm_fwd": rms_cases, "flash_attention_fwd": flash_cases,
          "flash_attention_bwd_dq": dq_cases,
          "flash_attention_bwd_dkv": dkv_cases,
          "decode_attention": decode_cases, "moe_experts": expert_cases})
    trained_f32 = train_124m_f32(torch, llama, llama_elastic, train, flash)
    emit({"phase": "train_124m_f32", "device": name, "nvidia_smi": smi,
          **trained_f32})
    torch.cuda.empty_cache()

    tiny = tiny_equivalence(torch, llama, decode, serve)
    emit({"phase": "tiny_equivalence", **tiny})
    tiny_train = tiny_train_equivalence(torch, llama, llama_elastic, train)
    emit({"phase": "tiny_train_equivalence", **tiny_train})
    tiny_moe = tiny_moe_equivalence(torch, moe, moe_decode, serve,
                                    llama_elastic, train)
    emit({"phase": "tiny_moe_equivalence", **tiny_moe})

    # Llama-2-7B widths, 16 of 32 layers (the depth cut that keeps the
    # script inside half its limit once the MoE phases run too).
    cfg = dataclasses.replace(llama.LlamaConfig.llama2_7b(), n_layers=16)
    t0 = time.perf_counter()
    params = llama.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    served = serve_7b(torch, serve, params, cfg)
    emit({"phase": "serve_7b", "device": name, "nvidia_smi": smi,
          "init_s": init_s, "n_layers": cfg.n_layers,
          "n_params": llama.num_params(cfg), **served})
    generated = generate_7b(torch, decode, params, cfg)
    emit({"phase": "generate_7b", "device": name, "nvidia_smi": smi,
          "n_layers": cfg.n_layers, **generated})
    del params
    torch.cuda.empty_cache()

    # Mixtral-8x7B widths, 16 of 32 layers: 23.48e9 parameters, 43.7 GiB
    # in bf16 (all 32 layers: 93.4 GB).
    moe_cfg = dataclasses.replace(moe.MoEConfig.mixtral_8x7b(), n_layers=16)
    t0 = time.perf_counter()
    params = moe.init_params(
        moe_cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    moe_served = serve_7b(torch, serve, params, moe_cfg, family="moe")
    emit({"phase": "serve_moe_width", "device": name, "nvidia_smi": smi,
          "init_s": init_s, "n_layers": moe_cfg.n_layers,
          "n_params": moe.num_params(moe_cfg), **moe_served})
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always", RuntimeWarning)
        moe_generated = generate_7b(torch, moe_decode, params, moe_cfg)
    capacity = [str(w.message) for w in caught
                if issubclass(w.category, RuntimeWarning)
                and "prefill may drop tokens" in str(w.message)]
    if not capacity:
        raise AssertionError("MoE generate: no capacity warning")
    emit({"phase": "generate_moe_width", "device": name, "nvidia_smi": smi,
          "n_layers": moe_cfg.n_layers, "capacity_warning": capacity[0],
          **moe_generated})
    del params
    torch.cuda.empty_cache()
    moe_trained = train_moe_width(torch, moe, llama_elastic, train)
    emit({"phase": "train_moe_width", "device": name, "nvidia_smi": smi,
          **moe_trained})
    torch.cuda.empty_cache()
    moe_sharded = sharded_moe_width(torch, moe, llama_elastic, train,
                                    moe_trained)
    emit({"phase": "sharded_moe_width", "device": name, "nvidia_smi": smi,
          **moe_sharded})
    torch.cuda.empty_cache()
    trained = train_7b_width(torch, llama, llama_elastic)
    emit({"phase": "train_7b_width", "device": name, "nvidia_smi": smi,
          **trained})
    remat = remat_7b_width(torch, llama, llama_elastic, trained)
    emit({"phase": "remat_7b_width", "device": name, "nvidia_smi": smi,
          **remat})
    torch.cuda.empty_cache()
    sharded = sharded_7b_width(torch, llama, llama_elastic, trained)
    emit({"phase": "sharded_7b_width", "device": name, "nvidia_smi": smi,
          **sharded})
    torch.cuda.empty_cache()
    ringed = ring_7b_width(torch, flash)
    emit({"phase": "ring_7b_width", "device": name, "nvidia_smi": smi,
          **ringed})
    torch.cuda.empty_cache()
    sp_run = sp_7b_width(torch, llama, llama_elastic, sharded)
    emit({"phase": "sp_7b_width", "device": name, "nvidia_smi": smi,
          **sp_run})
    torch.cuda.empty_cache()
    bert_run = bert_base(torch, bert, bert_pretrain, train)
    emit({"phase": "bert_base", "device": name, "nvidia_smi": smi,
          **bert_run})
    torch.cuda.empty_cache()
    resnet_run = resnet50(torch, resnet, resnet_dp, train)
    emit({"phase": "resnet50", "device": name, "nvidia_smi": smi,
          **resnet_run})
    torch.cuda.empty_cache()

    sink = LineSink()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        resumed = resume_124m(torch, llama, decode, train, sink, workdir)
        emit({"phase": "resume_124m", "device": name, "nvidia_smi": smi,
              **resumed})
        restarts = kernel_cache_restart_124m(
            sink, workdir, resumed, resumed["runs"]["uninterrupted"]["losses"],
            _build._nvcc())
        emit({"phase": "kernel_cache_restart_124m", "device": name,
              "nvidia_smi": smi, **restarts})
        handoff = jax_handoff_124m(
            torch, llama, decode, train, sink, workdir, resumed,
            resumed["runs"]["uninterrupted"]["losses"])
        emit({"phase": "jax_handoff_124m", "device": name,
              "nvidia_smi": smi, **handoff})
        shutil.rmtree(workdir, ignore_errors=True)
        workdir = tempfile.mkdtemp(prefix="chip_smoke_")
        tel = telemetry(sink, workdir)
        emit({"phase": "telemetry", "device": name, "nvidia_smi": smi,
              **tel})
        cross = cross_width_resume(sink, workdir)
        emit({"phase": "cross_width_resume", "device": name,
              "nvidia_smi": smi, **cross})
        torch.cuda.empty_cache()
        resized = resize_7b_width(torch, llama, llama_elastic, sharded,
                                  workdir)
        emit({"phase": "resize_7b_width", "device": name,
              "nvidia_smi": smi, **resized})
        torch.cuda.empty_cache()
        ladder = resize_ladder_124m(
            sink, workdir, resumed["runs"]["uninterrupted"]["losses"])
        emit({"phase": "resize_ladder_124m", "device": name,
              "nvidia_smi": smi, **ladder})
        moe_resumed = moe_resume(torch, moe, moe_decode, train, sink,
                                 workdir)
        emit({"phase": "moe_resume", "device": name, "nvidia_smi": smi,
              **moe_resumed})
        resumes = workload_resumes(torch, workdir)
        for phase in ("mnist", "bert", "resnet"):
            emit({"phase": f"{phase}_resume", "device": name,
                  "nvidia_smi": smi, **resumes[phase]})
    finally:
        sink.close()
        shutil.rmtree(workdir, ignore_errors=True)

    # Launches on every path driven (each from zeroed counters): the 7B
    # paths and the bf16 124M trainer run the tensor-core kernels, the
    # 124M trainer at float32 and the tiny configs the f32-FMA kernels.
    paths = [trained_f32, served, generated, trained, remat["attn"],
             remat["dots"],
             sharded, ringed, sp_run, resumed, restarts, handoff, tel, cross,
             resized,
             ladder,
             tiny,
             *tiny_train_runs(tiny_train), tiny_moe["serve"],
             *tiny_train_runs(tiny_moe["train"]), moe_served, moe_generated,
             moe_trained, moe_sharded, moe_resumed, bert_run, resnet_run,
             *resumes.values()]
    launches = {k: sum(p["launches"][k] for p in paths)
                for k in ops.launch_counts()}
    fma = {key: launches[key] - launches[f"{key}_wgmma"]
           for key in ("flash_attention_fwd", "flash_attention_bwd_dq",
                       "flash_attention_bwd_dkv")}
    src = "trainingjob_operator_tpu_torch/csrc/"
    tpu = "trainingjob_operator_tpu/ops/"

    def of(cases, kernel):
        return [c for c in cases if c["kernel"] == kernel]
    emit({"kernels": [
        summary("rmsnorm_fwd", "cuda", src + "rmsnorm.cu",
                tpu + "fused.py:18", rms_cases, rms_cases[0],
                launches["rmsnorm_fwd"]),
        summary("flash_attention_fwd_wgmma", "cuda",
                src + "flash_fwd_wgmma.cu", tpu + "flash_attention.py:40",
                of(flash_cases, "wgmma"), flash_cases[TRAIN_FLASH_CASE],
                launches["flash_attention_fwd_wgmma"]),
        summary("flash_attention_fwd_fma", "cuda", src + "flash_fwd.cu",
                tpu + "flash_attention.py:40", of(flash_cases, "fma"),
                flash_cases[FMA_FLASH_CASE], fma["flash_attention_fwd"]),
        summary("flash_attention_bwd_dq_wgmma", "cuda",
                src + "flash_bwd_dq_wgmma.cu",
                tpu + "flash_attention.py:170", of(dq_cases, "wgmma"),
                dq_cases[TRAIN_FLASH_CASE],
                launches["flash_attention_bwd_dq_wgmma"]),
        summary("flash_attention_bwd_dq_fma", "cuda", src + "flash_bwd.cu",
                tpu + "flash_attention.py:170", of(dq_cases, "fma"),
                dq_cases[FMA_FLASH_CASE], fma["flash_attention_bwd_dq"]),
        summary("flash_attention_bwd_dkv_wgmma", "cuda",
                src + "flash_bwd_dkv_wgmma.cu",
                tpu + "flash_attention.py:219", of(dkv_cases, "wgmma"),
                dkv_cases[TRAIN_FLASH_CASE],
                launches["flash_attention_bwd_dkv_wgmma"]),
        summary("flash_attention_bwd_dkv_fma", "cuda", src + "flash_bwd.cu",
                tpu + "flash_attention.py:219", of(dkv_cases, "fma"),
                dkv_cases[FMA_FLASH_CASE], fma["flash_attention_bwd_dkv"]),
        summary("decode_attention", "cuda", src + "decode_attention.cu",
                "none (plain XLA: trainingjob_operator_tpu/models/"
                "decode.py:86)", decode_cases, decode_cases[0],
                launches["decode_attention"]),
        summary("moe_experts", "cuda", src + "moe_experts.cu",
                "none (jnp.take of the chosen experts' weights: "
                "trainingjob_operator_tpu/models/moe_decode.py)",
                expert_cases, expert_cases[0],
                launches["moe_experts_gate_up"]),
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
