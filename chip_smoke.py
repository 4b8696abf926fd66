"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0) on failure:

1. Build the CUDA kernels from ``open_universe_tpu_torch/csrc`` (one nvcc per
   source, all at once), log each kernel instantiation's registers, shared
   memory and spills as ptxas reports them, and print the card's name and
   power limit.  TF32 is off for the library's convs and matmuls.
2. Hold the fused ConvBlock kernel against its plain PyTorch version on the
   card at all ten widths of the UNIVERSE++ 16 and 24 kHz presets
   (C = 32..768) on both routes of ``conv_block_tc.cu`` (bf16 on the tensor
   cores; f32 as 3xTF32 on the tensor cores, on each core the width has,
   wgmma and mma.sync, the table's and the other forced): at the length the
   main path gives the width, T = 1, T = 5 (below a tile) and T = 1004 (a
   partial last tile on every route), FiLM and cond on and off.  One line
   per (C, dtype).
2b. The same for the kernel's rows entry (``fused_conv_chain_rows``, the
   JAX package's API, which no ConvBlock calls) on lane-packed rows
   (B, T/P, P*C), P = max(1, 128 // C), at T = P, 5P, 1004 and the main
   path's length.
3. Run the main path at full width: ``universepp(16000)`` with seeded random
   weights, weight norm folded, ``enhance`` on 2 x 2 s at 16 kHz, 8 steps,
   float32, once through the kernel and once through the unfused chain, on
   the same noise.  Both must agree, and the kernel run must launch the
   f32 route 94 times, every launch through the main entry
   (``fused_conv_chain``).  Then the same ``enhance`` with bf16 networks
   must launch the bf16 route 94 times.  The launches are counted by
   (entry, route, C, T, FiLM, cond).  The f32 run also launches the
   rate-change kernel
   (``rate_change_tc.cu``) 72 times, 4 down and 4 up blocks in each of the 8
   score passes and the conditioner, the score network's 64 with the
   low-pass; the bf16 run launches it 0 times.
3c. The 24 kHz model: a reference-layout checkpoint of the seeded
   ``universepp(24000)`` with ``config/model/universepp_24k.yaml``'s model
   node beside it, loaded by ``load_model`` through the port's registry
   (EMA applied, folded); ``enhance`` of 2 x 2 s at 24 kHz, 8 steps, f32,
   through the kernel and the unfused chain on the same noise: they agree
   within 1e-4, with 94 launches at C = 48..768 and 72 rate-change
   launches (64 low-passed); one 2 s request
   served over HTTP (94 and 72 launches).  One f32 ``enhance`` at batch
   128 counted by core must run wgmma at C = 48..384 and mma.sync at 768.
   Then the kernel, its plain version and the unfused chain alone in bf16
   and f32 at each of its shapes at batch 128, as in phase 4.
3e. The rate-change kernel (``ops/kernels/rate_change.py``) against its
   plain version (TF32 off, within 1e-4 of max|plain|) at each rate-change
   shape of phases 3 and 3c at batch 128, and at each shape of an f32
   ``enhance`` of a 1 s bucket at the server's batches 1, 2 and 16; at each
   the kernel on every core the shape has (``rate_change.rate_cores``), its
   plain version and the ``PReLUConv`` module it replaces (cuDNN at
   PyTorch's default TF32, as the server ran it) timed alone, weighted by
   launches per ``enhance``, beside its bound (bytes at 3.35 TB/s, products
   at 3xTF32's 495 / 3 TFLOP/s).  The batch sweep that sets the source's
   row thresholds: every 2 s shape with both cores at batch 1 (and a 1 s
   clip), 2, 4, 8, 16 and 64, each core's device ms a launch from a CUDA
   graph of 20, beside the table's choice.  Then one traced f32
   ``enhance`` at batch 128 x 2 s of UNIVERSE++ and of plain UNIVERSE, with
   the rate-change kernel and with the module (PyTorch's default TF32, as
   the benchmark runs): device events, busy time and traced wall per call.
4. Time ``enhance`` in bench.py's setting (bf16 networks, batch 128 x 2 s,
   8 steps, every block through the main entry) with the kernel and with
   the unfused chain, and the same ``enhance`` with f32 networks (the
   server's default) both ways; then time the kernel (and its f32 route),
   its plain version and the unfused chain alone at each (C, T, FiLM, cond)
   that phase 3 launched, weight each by its launches, and give each
   shape's TFLOP/s and bound share (f32 at the 3xTF32 rate, 495 / 3 TFLOP/s;
   the CUDA cores' 67 TFLOP/s bound of the earlier f32 kernel is printed
   beside it once).  The f32 route runs on the core its table gives the
   shape (``conv_block.core_launches`` counts it) and is timed on each of
   its cores, each core's output within the f32 gate of the plain version's;
   ``[cores]`` lines give each width's ms per enhance on the table's core
   and on mma.sync beside the 3xTF32 bound.  One f32 ``enhance`` at batch
   128 counted by core must run wgmma at C = 32..256 and mma.sync at 512.
4b. Time bf16 ``enhance`` on 2 s clips at batch 1 and 16; then the main
   entry, its plain version and the unfused chain alone at each shape of
   phase 3 with C < 128 (those the JAX package packs at these batches) at
   batch 1 and 16, weighted by launches, the f32 route on each core as in
   phase 4.  Then, at each width with both f32 cores
   (C = 32, 128, 256) at its 2 s length, both cores alone at batch 1, 2,
   4, 8 and 16: where the table's threshold (MIN_ROWS) falls against the
   measured crossing.
5. Trace one ``enhance`` each way in the batch-128 setting with
   ``torch.profiler``: device time by kernel group and under a few PyTorch
   ops, device busy time and idle share; then one ``enhance`` at batch 1.
6. Serve: write a reference-layout checkpoint of the seeded model (weight
   norm unfolded, an EMA shadow that differs from the raw weights, the
   model node of ``config/model/default.yaml``), ``load_model`` it onto the
   card, start the HTTP server (max batch 16, 50 ms window, 1 s buckets,
   2 s warm-up grid), and check: a lone 2 s request equals ``enhance`` of
   its bucket-padded batch with the service generator's state; 12
   concurrent requests (13 clips, one stereo) all answer 200 with their
   shape; ``/stats`` counts every clip; every launch on the main entry.
   Then 5
   lone 2 s requests give the serving latency.
7. The enhance CLI (``bin/enhance.py``'s ``main`` in this process, default
   device, ``--batch-size 8``, 8 steps, f32) on phase 6's checkpoint, whose
   snake signal-decoupling layer is loaded, and a tree of 16 kHz mono WAVs
   of 2, 3.5 and 7 s, a stereo 44.1 kHz FLAC, a 24 kHz WAV in a subfolder
   and (where libmpg123 and libmp3lame load) an MP3.  Four runs: bucketed
   (94 launches per batch), ``--use_aux_signal true`` (14 per batch),
   ``--chunk-seconds 2`` on the 7 s file, and ``--ensemble 4
   --ensemble_stat median --warm_start 3`` (64 per batch).  Each writes
   every file with its rate, length, channels and container, finite,
   through the main entry, and each run's lossless files, every bucket and
   every channel, equal the CLI's batches (or chunks) recomputed by
   ``enhance`` with the kernels off on a generator seeded as the CLI seeds
   it, cut and resampled as the CLI writes them (<= 1e-4 + 1/32767, the
   16-bit rounding).  The CLI's realtime factor,
   bucketed and chunked, is logged beside the card's name and power limit.

3d. Step 0 of training's slice: an f16 ``enhance`` (no kernel route) and a
   C = 40 ConvBlock (no kernel width) run the unfused chain on the card:
   no launch, equal to the chain with the kernels off.
7b. cuDNN TF32: the server's lone 2 s request (``enhance`` at batch 1) and
   a CLI batch (batch 8) under PyTorch's default (cuDNN TF32 on) with the
   kernel, against the unfused chain with TF32 off; logged against the
   entry points' bound 1e-4 + 1/32767.
8. Training.  (a) The training entry point
   (``open_universe_tpu_torch.train``'s ``main``, then ``Trainer.fit``)
   at full width: the ``universepp_vb_16k`` experiment, batch 40 x 2 s
   crops of 80 synthetic 2.5 s pairs, f32, PyTorch's TF32 defaults,
   ``TRAIN_STEPS`` steps and a checkpoint at the last: losses finite,
   every optimised tensor moved (one whose gradient stays below Adam's
   epsilon may not), the signal-decoupling layer did not, every ConvBlock
   parameter has a gradient, and no fused-kernel launch happened in the
   steps (the kernel has no backward); step times, peak memory, and one
   step's losses with cuDNN TF32 on against off.  (b) One step at a narrow
   width on the card against the same step on the CPU, same weights and
   draws, TF32 off, with the bounds of ``phase_train_step_vs_cpu``.
   (c) ``load_model`` on (a)'s checkpoint and ``enhance`` through the
   kernel against the unfused chain (<= 1e-4, 94 launches).
9. Validation, test and resume.  The training entry point at full width
   (batch 40 x 2 s, f32, PyTorch's TF32 defaults), 4 steps, validating and
   writing a checkpoint every 2, then ``test=true``, on synthetic pairs (12
   val clips of 1.3-6.1 s at batch 1, 8 test clips): the val/* rows of
   ``metrics.jsonl``, index, best and last.json, test_summary.json; each
   validation launches the f32 route 5 * 24 per val clip plus 94 per
   enhanced clip (the first 4), through the main entry, the test 94 per
   clip; one validation through the kernel against the same with the
   kernels off (TF32 off: score bins <= 1e-4 relative, each enhanced clip
   <= 1e-4 of its max|ref|), and one on the longest clip traced with
   ``torch.profiler``; then
   the run resumed from the step-2 checkpoint holds its state bit for bit
   and trains to step 4, validating at 4 only.  Logs a validation's wall
   seconds: the model's passes and the host metrics (PESQ).
10. The plain UNIVERSE (MDN losses; the generic score path, no EDM).  (a)
   The training entry point at full width: the ``universe_original_vb_16k``
   experiment, batch 40 x 2 s crops of 80 synthetic 2.5 s pairs, f32,
   PyTorch's TF32 defaults, ``ORIG_STEPS`` steps, a checkpoint at the
   middle step and the last: the score, signal and latent losses finite,
   0 fused-kernel launches in the steps; step times, peak memory.  (b) One
   score-only step at a narrow width on the card against the CPU, same
   weights and draws, TF32 off (losses <= 1e-5 relative, gradients <= 1e-3
   of each tensor's largest).  (c) Its validation at the last step (4
   val clips of 1.3-3.1 s at batch 1) and test (2 clips): launches by the
   formula counted from the model's ConvBlocks (5 x 24 x 4 + 94 x 4, 94
   per test clip), the main entry; one validation through the kernel against
   the kernels off (score bins <= 1e-4 relative, clips <= 1e-4 of
   max|ref|); a run resumed from the middle checkpoint restores its state
   (the MDN loss modules included) bit for bit.  (d) ``load_model`` on the
   last checkpoint (no loss modules): ``enhance`` of 2 x 2 s through the
   kernel against the unfused chain, f32 (<= 1e-4 of max|ref|) and bf16,
   94 launches each; audio-s/s at batch 128 x 2 s, bf16 and f32, kernel
   and unfused (median of 3).  (e) Narrow models with a CompressedMagSTFT
   as the model's transform and as both networks' precoding: ``enhance``
   on the card (cuFFT, the overlap-add ``istft``) against the CPU, <= 1e-4
   of max|ref|.

11. LoRA fine-tuning.  (a) The training entry point with
   ``experiment=universepp_lora_finetune`` on phase 8a's full-width
   checkpoint (``model.losses.phonemeloss=null``; rank 16, 8 sampler steps
   with gradients in the last 2, the frozen MPD/MRD loss), batch 4 x 2 s
   crops of 16 synthetic pairs, f32, PyTorch's TF32 defaults, 6 steps, a
   checkpoint every 3, a validation at 6 (3 clips), then the test (2
   clips): losses finite, 0 fused-kernel launches in the steps, the
   validation and the test (adapters attached), frozen weights equal the
   base checkpoint's bit for bit, the adapters moved; step times, peak
   memory; (c) a run resumed from step 3 restores its state bit for bit.
   (b) One LoRA step at a narrow width on the card against the CPU (same
   weights, adapters and draws, TF32 off): losses <= 1e-4 relative,
   gradients <= 1e-2 of each tensor's largest plus 1e-6 of the largest.
   (d) ``load_model`` on the fine-tuned checkpoint (a UniverseLoRA):
   ``enhance`` of 2 x 2 s launches 0; ``merge_lora``'s model launches 94
   through the main entry in f32 and bf16 and equals the adapters' (f32 <=
   1e-4 of max|ref|); audio-s/s at batch 128 x 2 s, merged against
   adapters, bf16 and f32; one file through the enhance CLI (0 launches).
   (e) UNIVERSE++ with a MultiResL1SpecLoss aux loss whose warm-up (0,
   0.5, 1) its 3 full-width steps (batch 8) cross, 0 launches; one narrow
   step at aux weight 0.5 against the CPU with 8b's bounds.
12. Training at scale.  (a) The UNIVERSE++ GAN step at full width
   (``universepp_vb_16k``, batch 40 x 2 s of synthetic tones, PyTorch's
   TF32 defaults, cuDNN deterministic) in four arms: f32, bf16
   (``training.compute_dtype``), f32 + remat, bf16 + remat: the median of 4
   step times after the first, the peak memory, 0 launches, every
   parameter, gradient, AdamW moment and EMA shadow float32; remat against
   no remat on the first step (same weights, batch, draws): losses <= 1e-6
   relative, updated parameters <= 1e-5 of each tensor's largest; bf16
   against f32: losses within 0.1 (|f32| + 1).  The plain UNIVERSE in f32
   and bf16 at batch 40.  (b) Gradient accumulation: two narrow
   micro-batches and their update on the card against the CPU with 8b's
   bounds; ``accumulate_grad_batches=4`` at batch 10 x 2 s at full width,
   time and peak per update.  (c) Data parallelism: 2 gloo processes, both
   on cuda:0, 2 narrow GAN and 2 plain-UNIVERSE steps against one process
   on the global batch (the ranks equal bit for bit; losses <= 1e-6
   relative; gradients and parameters as ``compare_ddp`` says); then the
   training entry point under ``torchrun --standalone --nproc_per_node 1``
   (NCCL; this script in its ``--torchrun-train`` mode) at full width,
   bf16 and ``accumulate_grad_batches=2``, 4 steps at batch 40, a checkpoint
   at step 3 (mid-accumulation) and 4, a validation at 4 (its score bins
   on the bf16 route, 5 x 24 per clip, its enhance on the f32 one, 94 per
   clip); the resume from step 3 restores every state bit for bit, the
   accumulators included, and takes step 4; the step-4 checkpoint's
   ``enhance`` as 8c (94 launches, <= 1e-4).  (d) ``bin.parity`` on phase
   8a's checkpoint over 4 synthetic 2 s pairs (the report, 94 launches) and
   ``bin.resample`` (its own process) on phase 7's tree.

13. The phoneme losses and LPS on the port's wav2vec2 (``nn/wav2vec2.py``;
   no hand kernel: cuDNN, cuBLAS, ``scaled_dot_product_attention``).  (a)
   ``LV60_ESPEAK`` (the published widths of wav2vec2-lv-60-espeak-cv-ft,
   315.8M parameters) with seeded random weights, written as a Hugging Face
   directory and read by ``load_pretrained``: logits of 2 x 2 s on the card
   against the CPU (TF32 off <= 1e-4, cuDNN TF32 on <= 5e-2, of max(1,
   max|CPU|)); ``PhonemeCTCLoss`` forward and backward at batch 4 x 2 s
   (median of 5 after 2, CUDA events), the forward alone, peak memory.
   (b) Phase 11a's LoRA run with the recipe's ``PhonemeCTCLoss`` on (13a's
   directory): losses finite, train/ and val/phonemeloss logged, 0
   launches in the steps and the validation, the checkpoint's keys phase
   11a's; step times and peak memory beside phase 11a's; one traced step
   with the loss and one without it.  (c) 11b with a tiny random
   wav2vec2: the narrow step on the card against the CPU, 11b's bounds.
   (d) ``Metrics(["lps"])`` and ``EvalMetrics(lps=True)`` on 13a's
   directory as the default id's snapshot in a Hugging Face cache, over
   two enhanced clips (finite values; the strings' lengths logged).

14. Tensor parallelism (``parallel/tp.py``): two gloo processes on cuda:0
   as a dp = 1, tp = 2 mesh and one process alone, each 4 UNIVERSE++ GAN
   steps at full width (bf16 + remat, batch 16 x 2 s, fixed draws, TF32
   off, cuDNN deterministic) through the trainer: the ranks agree bit for
   bit, step 1's losses equal the one process's, the later losses within
   1e-6 relative, gradients, parameters and EMA within 12c's bounds; each
   rank holds about half of the parameters', gradients', moments' and
   shadows' bytes; 0 launches in the steps; the tp checkpoint has the one
   process's keys and shapes, and ``load_model`` + ``enhance`` on it as 8c
   (94 launches, <= 1e-4 of the kernels off).  The sharded leaf count and
   bytes, each process's peak memory and the step times (gloo through the
   host: a correctness run) are logged.  Then the entry point as one NCCL
   process under torchrun with ``trainer.mesh_tp=2`` exits non-zero
   naming the mismatch.

The last two lines are a JSON object with one entry per kernel (per-enhance
sums; each shape's numbers are on the log lines of phases 3c, 3e, 4 and 4b; the
CLI's launches per run of phase 7; phase 10's to 14's launches per path) and
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits non-zero
and prints no result.
"""
from __future__ import annotations

import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import wave

import numpy as np
import torch

from benchmark.common.trace import kernel_group, union_length

FS = 16000
CLIP_S = 2.0
DEVICE = "cuda"
BUCKET_S = 1.0  # the server's length buckets
N_STEPS = 8
TIMING_BATCH = 128
SERVE_BATCH = 16
CROSSOVER_BATCHES = (1, 2, 4, 8, 16)  # phase 4b's rows sweep of the f32 cores
ENTRY = "fused_conv_chain"  # the one entry ConvBlock.forward calls
SOURCES = ("conv_block_tc", "rate_change_tc")
# ConvBlock width -> length on a 2 s clip: 16 kHz (universepp(16000)) and
# 24 kHz (config/model/universepp_24k.yaml)
WIDTH_LENGTHS = {32: 32160, 64: 16080, 128: 4020, 256: 1005, 512: 201}
WIDTH_LENGTHS_24K = {48: 48240, 96: 24120, 192: 8040, 384: 1608, 768: 201}
PARTIAL_T = 1004  # leaves a partial last time tile on every route and width
F32, BF16 = "f32_tensor_cores_3xtf32", "bf16_tensor_cores"  # conv_block.ROUTES' names
# ConvBlocks per enhance with 8 steps: 10 per score pass, 14 in the conditioner
COND_BLOCKS, SCORE_BLOCKS = 14, 10
PATH_LAUNCHES = SCORE_BLOCKS * N_STEPS + COND_BLOCKS
# rate changes per f32 enhance: 4 down and 4 up blocks in each score pass and
# in the conditioner; UNIVERSE++ low-passes the score network's
RATE_LAUNCHES, RATE_LOW_PASSED = 8 * (N_STEPS + 1), 8 * N_STEPS
SERVE_BATCHES = (1, 2, 16)  # the server's rows per call, up to max_batch 16
PEAK_BYTES_PER_S = 3.35e12
# f32 runs as three TF32 products per product: a third of the 495 TFLOP/s
PEAK_FLOPS = {torch.float32: 495e12 / 3, torch.bfloat16: 989e12}
CUDA_CORE_F32_FLOPS = 67e12  # the bound of the earlier CUDA-core f32 kernel
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# phase 8: the training entry point at the universepp_vb_16k experiment's
# batch (40 x 2 s crops) on TRAIN_PAIRS synthetic pairs of TRAIN_PAIR_S
TRAIN_STEPS = 6
TRAIN_BATCH = 40
TRAIN_PAIRS, TRAIN_PAIR_S = 80, 2.5
TRAIN_OVERRIDES = []  # full width
# phase 9: validation, test and resume of the entry point at full width:
# VAL_PAIRS clips of 1.3-6.1 s (batch 1, as the val loader batches), 8 test
# clips, VAL_TRAIN_PAIRS training pairs for the steps
VAL_STEPS, VAL_EVERY = 4, 2
VAL_PAIRS, TEST_PAIRS, VAL_TRAIN_PAIRS = 12, 8, 40
N_BINS, MAX_ENH = 5, 4  # validation's score-loss bins, enhanced batches
VAL_KEYS = ("val/score", "val/score_0.00-0.20", "val/score_0.20-0.40", "val/score_0.40-0.60",
            "val/score_0.60-0.80", "val/score_0.80-1.00", "val/pesq", "val/lsd")
# phase 8b: one step on the card against the CPU at a narrow width
NARROW_OVERRIDES = ["model.score_model.n_channels=8", "model.score_model.noise_cond_dim=64",
                    "model.condition_model.n_mels=20",
                    "model.losses.multi_period_discriminator.discriminator_channel_mult=0.125",
                    "model.losses.multi_resolution_discriminator.discriminator_channel_mult=0.25"]
NARROW_T = 8000
# phase 10: the plain UNIVERSE (MDN losses) through the training entry point
# at full width, batch TRAIN_BATCH x 2 s crops; ORIG_VAL_PAIRS val clips of
# 1.3-3.1 s at batch 1, ORIG_TEST_PAIRS test clips
ORIG = "universe_original_vb_16k"
ORIG_STEPS = 6
ORIG_VAL_PAIRS, ORIG_TEST_PAIRS = 4, 2
ORIG_OVERRIDES = []  # full width
# 10b: one step on the card against the CPU at a narrow width (the MDN
# LayerNorms follow the crop: audio_len = NARROW_T / FS)
NARROW_ORIG_OVERRIDES = ["model.score_model.n_channels=8", "model.score_model.noise_cond_dim=64",
                         "model.condition_model.n_mels=20",
                         f"datamodule.datasets.vb-train-16k.audio_len={NARROW_T / FS}"]

# PyTorch ops whose device time (children included) says which layer issues
# the copies, casts and pads
PROFILE_OPS = ("aten::convolution", "aten::contiguous", "aten::_to_copy",
               "aten::constant_pad_nd", "aten::where", "aten::gru")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of fn() over iters runs, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def chain_inputs(b, t, c, dtype, film, cond, seed=0):
    """Folded chain weights in the kernel's layout and inputs, on the card."""
    g = torch.Generator().manual_seed(seed)

    def rand(*shape, scale=1.0):
        return ((torch.rand(shape, generator=g) * 2 - 1) * scale).to(DEVICE, dtype)

    weights = []
    for k in (5, 3, 3):
        slope = (torch.rand(1, generator=g) * 0.5).to(DEVICE)  # float32
        weights += [rand(k, c, c, scale=1 / math.sqrt(k * c)), rand(c, scale=0.5),
                    slope]
    h = rand(b, t, c)
    nc = rand(b, 2 * c) if film else None
    ic = rand(b, t, c) if cond else None
    return h, weights, nc, ic


def ptxas_summary(text: str) -> list:
    """One line per compiled kernel from ``nvcc -Xptxas=-v``: its name and
    width, registers, shared memory and spills."""
    out, name, spill = [], None, ""
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            raw = m.group(1)
            kernel = re.search(r"\d+(conv_block\w*?_kernel\w*?)I", raw)
            prec = re.search(r"\d(F32|Bf16)E", raw)
            width = re.search(r"Li(\d+)E", raw)
            name = (f"{kernel.group(1)}<{prec.group(1) if prec else 'F32'}, "
                    f"C={width.group(1)}>" if kernel and width else raw)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spill = f"spill stores {m.group(1)} B, spill loads {m.group(2)} B"
            continue
        m = re.search(r"Used (\d+) registers(.*)", line)
        if m and name:
            out.append(dict(kernel=name, registers=int(m.group(1)),
                            text=f"{name}: {m.group(1)} registers{m.group(2)}; {spill}",
                            spills=bool(re.search(r"spill (stores|loads) [1-9]", spill))))
            name, spill = None, ""
    return out


def phase_build():
    """Returns the build's seconds and ptxas's summary by source."""
    from open_universe_tpu_torch.ops.kernels import build

    t0 = time.perf_counter()
    build.build(*SOURCES)
    build_s = time.perf_counter() - t0
    log(f"[build] {', '.join(SOURCES)} built in {build_s:.1f} s (one nvcc each, at once)")
    summary = {}
    for source in SOURCES:
        summary[source] = ptxas_summary(build.build_log(source))
        for k in summary[source]:
            log(f"[build] {k['text']}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"[device] {card_line()} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    return build_s, summary


def by_entry(counts) -> dict:
    """Launches by entry name, from counts keyed by (entry, route, C, T,
    FiLM, cond)."""
    out = {}
    for (entry, *_), n in counts.items():
        out[entry] = out.get(entry, 0) + n
    return out


def by_route(counts) -> dict:
    out = {}
    for (_, route, *_), n in counts.items():
        out[route] = out.get(route, 0) + n
    return out


def by_shape(counts) -> dict:
    """Launches by (C, T, FiLM, cond)."""
    out = {}
    for (_, _, *shape), n in counts.items():
        out[tuple(shape)] = out.get(tuple(shape), 0) + n
    return out


def pack(x, c):
    """(B, T, C) -> lane-packed rows (B, T/P, P*C)."""
    return None if x is None else x.reshape(x.shape[0], -1, c * max(1, 128 // c))


def check_lengths(c: int, rows: bool) -> list:
    """(T, FiLM, cond) cases of one width: the main path's length both ways,
    one row (T = P), a length below every tile and one that leaves a partial
    last tile."""
    p = max(1, 128 // c) if rows else 1
    t_main = {**WIDTH_LENGTHS, **WIDTH_LENGTHS_24K}[c]
    return [(t_main, True, True), (t_main, False, False), (p, True, True),
            (5 * p, True, False), (PARTIAL_T, False, True)]


def gate(what, got, ref, dtype) -> tuple:
    """(max|got - ref|, that over max|ref|) of the larger of v and cond_out;
    raises where either is off the dtype's bound (TOL) of max|ref|."""
    worst_err, worst_rel = 0.0, 0.0
    for name, a, r in zip(("v", "cond_out"), got, ref):
        if a.shape != r.shape:
            raise AssertionError(f"{what}: shape {tuple(a.shape)} != {tuple(r.shape)}")
        err = (a.float() - r.float()).abs().max().item()
        scale = r.float().abs().max().item()
        if not (math.isfinite(err) and err <= TOL[dtype] * scale):
            log(f"{what} {name}: max|d|={err:.3e} max|ref|={scale:.3e} FAIL")
            raise AssertionError(f"{what}: the kernel disagrees with its plain version "
                                 f"({name}, {dtype})")
        worst_err, worst_rel = max(worst_err, err), max(worst_rel, err / scale)
    return worst_err, worst_rel


def phase_kernel_vs_plain(rows: bool = False):
    """Both routes at every width against the plain version, the f32 route
    on each core the width has (the table's through the entry, the other
    forced); returns the largest max|kernel - plain| by route, for the
    unpacked entry or (rows=True) the rows entry."""
    from open_universe_tpu_torch.ops.kernels import conv_block

    tag = "rows" if rows else "kernel"
    entry = "fused_conv_chain_rows" if rows else "fused_conv_chain"
    worst = {}
    for c in conv_block.WIDTHS:
        p = max(1, 128 // c)
        for dtype in (torch.float32, torch.bfloat16):
            route = conv_block.ROUTES[dtype][0]
            err_c, rel_c = 0.0, 0.0
            cases = check_lengths(c, rows)
            cores = conv_block.width_cores(dtype, c)
            for t, film, cond in cases:
                h, weights, nc, ic = chain_inputs(2, t, c, dtype, film, cond, seed=c + t)
                if rows:
                    got = conv_block.fused_conv_chain_rows(
                        pack(h, c), p, c, *weights, noise_cond=nc, input_cond_rows=pack(ic, c))
                    torch.cuda.synchronize()
                    ref = conv_block.fused_conv_chain_rows_reference(
                        pack(h, c), p, c, *weights, noise_cond=nc, input_cond_rows=pack(ic, c))
                else:
                    got = conv_block.fused_conv_chain(h, *weights, noise_cond=nc,
                                                      input_cond=ic)
                    torch.cuda.synchronize()
                    ref = conv_block.fused_conv_chain_reference(h, *weights, noise_cond=nc,
                                                                input_cond=ic)
                runs = {conv_block.chain_core(dtype, 2 * t, c): got}
                for core in set(cores) - set(runs):
                    v, co = conv_block._launch(entry, h, weights, nc, ic, core=core)
                    runs[core] = (v.reshape(ref[0].shape), co.reshape(ref[1].shape))
                for core, out in runs.items():
                    err, rel = gate(f"[{tag}] C={c} T={t} film={film:d} cond={cond:d} "
                                    f"{route} {core}", out, ref, dtype)
                    err_c, rel_c = max(err_c, err), max(rel_c, rel)
            log(f"[{tag}] C={c:3d} {route:23s} {'/'.join(cores):14s} "
                f"T={[t for t, *_ in cases]}: worst max|d| {err_c:.3e} = {rel_c:.2e} "
                f"max|ref| (bound {TOL[dtype]:g}) ok")
            worst[route] = max(worst.get(route, 0.0), err_c)
    return worst


def noise_draws(model, b, t, seed):
    """The sampler's N_STEPS standard-normal draws for a (b, t) input."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    shape = (b, t + model.tot_ds - t % model.tot_ds, 1)
    return [torch.randn(shape, generator=g, device=DEVICE) for _ in range(N_STEPS)]


def core_counts() -> dict:
    """The chain's launches since the last ``counted_enhance`` by core and
    width, "core C" -> n."""
    from open_universe_tpu_torch.ops.kernels import conv_block

    return {f"{core} {c}": n for (core, c), n in sorted(conv_block.core_launches.items())}


def counted_enhance(model, mix, noise, dtype=None):
    """enhance with the kernels on; its output and the chain launches it
    made (``rate_change.launches`` and ``conv_block.core_launches`` count
    from 0 too)."""
    from open_universe_tpu_torch.ops.kernels import conv_block, rate_change

    conv_block.launches.clear()
    conv_block.core_launches.clear()
    rate_change.launches.clear()
    rate_change.core_launches.clear()
    out = model.enhance(mix, n_steps=N_STEPS, noise=noise, compute_dtype=dtype)
    torch.cuda.synchronize()
    return out, dict(conv_block.launches)


def unfused_enhance(model, mix, noise, dtype=None):
    from open_universe_tpu_torch.ops import kernels

    kernels.enable(False)
    try:
        out = model.enhance(mix, n_steps=N_STEPS, noise=noise, compute_dtype=dtype)
    finally:
        kernels.enable(True)
    torch.cuda.synchronize()
    return out


def low_passed(rate_counts) -> int:
    return sum(n for k, n in rate_counts.items() if k[-1])


def check_path(tag, counts, widths, route, out, t):
    """A main-path run of ``counted_enhance``: its output's shape and values,
    and its launches: one per ConvBlock, all on ``route`` through the main
    entry, at every width of the model; the rate-change kernel RATE_LAUNCHES
    times in f32, never in bf16.  Returns the rate-change launches."""
    from open_universe_tpu_torch.ops.kernels import rate_change

    launches, rate = sum(counts.values()), dict(rate_change.launches)
    log(f"[{tag}] enhance -> {tuple(out.shape)}: {launches} launches {by_entry(counts)} "
        f"{by_route(counts)}, {sum(rate.values())} rate-change launches "
        f"({low_passed(rate)} low-passed), max|out| = {out.float().abs().max().item():.3e}")
    for (entry, r, c, t_c, film, cond), n in sorted(counts.items()):
        log(f"[{tag}]   {entry:22s} {r} C={c:3d} T={t_c:5d} film={film:d} cond={cond:d}: "
            f"{n} launches")
    log(f"[{tag}]   cores: {core_counts()}")
    log(f"[{tag}]   rate-change cores: " + ", ".join(
        f"{core} {d} r={r} Cin={cin}: {n}"
        for (core, d, r, cin), n in sorted(rate_change.core_launches.items())))
    if tuple(out.shape) != (out.shape[0], t) or not torch.isfinite(out).all():
        raise AssertionError(f"{tag}: enhance output has the wrong shape or is not finite")
    if launches != PATH_LAUNCHES:
        raise AssertionError(f"{tag}: expected {PATH_LAUNCHES} kernel launches, counted {launches}")
    if {k[2] for k in counts} != set(widths) or set(by_route(counts)) != {route} \
            or set(by_entry(counts)) != {ENTRY}:
        raise AssertionError(f"{tag}: kernel launched as {sorted(counts)}")
    if sum(rate.values()) != (RATE_LAUNCHES if route == F32 else 0):
        raise AssertionError(f"{tag}: rate-change kernel launched as {rate}")
    return rate


def phase_main_path():
    """Full-width enhance through the kernel (f32, then bf16) and through the
    unfused chain; returns the model and each kernel run's launch counts."""
    from open_universe_tpu_torch.models.presets import universepp
    from open_universe_tpu_torch.utils.convert import fold_weight_norm

    model = fold_weight_norm(universepp(FS, device=DEVICE, seed=0))
    t = int(CLIP_S * FS)
    g = torch.Generator(device=DEVICE).manual_seed(1)
    mix = torch.randn(2, t, generator=g, device=DEVICE) * 0.05
    noise = noise_draws(model, 2, t, seed=2)

    out_k, counts = counted_enhance(model, mix, noise)
    rate = check_path("main", counts, WIDTH_LENGTHS, F32, out_k, t)
    if low_passed(rate) != RATE_LOW_PASSED:
        raise AssertionError(f"main: {low_passed(rate)} rate changes low-passed, not "
                             f"{RATE_LOW_PASSED}")
    diff = (out_k - unfused_enhance(model, mix, noise)).abs().max().item()
    log(f"[main] f32: max|kernels - unfused| = {diff:.3e} (bound 1e-4; both kernels "
        f"against the modules, TF32 off)")
    if not diff <= 1e-4:
        raise AssertionError(f"kernel path and unfused chain differ by {diff}")

    out_b, counts_bf16 = counted_enhance(model, mix, noise, torch.bfloat16)
    check_path("main bf16", counts_bf16, WIDTH_LENGTHS, BF16, out_b, t)
    diff_bf16 = (out_b - unfused_enhance(model, mix, noise, torch.bfloat16)).abs().max().item()
    log(f"[main bf16] max|kernel - unfused| = {diff_bf16:.3e} (no bound: bf16 "
        f"networks round at other points in the unfused chain)")
    return model, counts, counts_bf16, dict(f32=diff, bf16=diff_bf16), rate


def phase_24k():
    """The 24 kHz model: a reference-layout checkpoint of universepp(24000)
    with config/model/universepp_24k.yaml beside it, loaded by load_model
    through the registry; enhance both ways at f32; one 2 s request served
    over HTTP; then each launched shape alone at batch 128 in bf16."""
    from open_universe_tpu_torch.bin.serve import make_server
    from open_universe_tpu_torch.inference.model_loader import load_model
    from open_universe_tpu_torch.ops.kernels import conv_block, rate_change

    with tempfile.TemporaryDirectory() as tmp:
        model = load_model(write_checkpoint(tmp, 24000, "universepp_24k.yaml"),
                           device=DEVICE)
    fs = int(model.fs)
    t = int(CLIP_S * fs)
    g = torch.Generator(device=DEVICE).manual_seed(11)
    mix = torch.randn(2, t, generator=g, device=DEVICE) * 0.05
    noise = noise_draws(model, 2, t, seed=12)
    out_k, counts = counted_enhance(model, mix, noise)
    rate = check_path("24k", counts, WIDTH_LENGTHS_24K, F32, out_k, t)
    if low_passed(rate) != RATE_LOW_PASSED:
        raise AssertionError(f"24k: {low_passed(rate)} rate changes low-passed")
    diff = (out_k - unfused_enhance(model, mix, noise)).abs().max().item()
    log(f"[24k] universepp_24k.yaml checkpoint via load_model, fs {fs}, tot_ds "
        f"{model.tot_ds}: max|kernel - unfused| = {diff:.3e} (bound 1e-4)")
    if not diff <= 1e-4:
        raise AssertionError(f"24 kHz kernel path and unfused chain differ by {diff}")
    del mix, noise, out_k
    mix = torch.randn(TIMING_BATCH, t, generator=g, device=DEVICE) * 0.05
    cores = check_batch_cores("24k", model, mix, noise_draws(model, TIMING_BATCH, t, seed=14),
                              (48, 96, 192, 384))
    del mix

    server, service = make_server(model, model_name="universepp-24k-seeded", port=0,
                                  max_batch=SERVE_BATCH, batch_window_ms=50.0,
                                  bucket_seconds=BUCKET_S)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        conv_block.launches.clear()
        rate_change.launches.clear()
        x = (0.05 * np.random.default_rng(13).standard_normal(t)).astype(np.float32)
        t0 = time.perf_counter()
        status, body = post(f"http://127.0.0.1:{server.server_address[1]}", wav_bytes(x, fs))
        served_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        served = dict(conv_block.launches)
        served_rate = sum(rate_change.launches.values())
    finally:
        server.shutdown()
        service.close()
    out = wav_decode(body) if status == 200 else None
    log(f"[24k] one 2 s request served: status {status}, {served_ms:.1f} ms, launches "
        f"{by_entry(served)} {by_route(served)}, {served_rate} rate-change launches")
    if out is None or out.shape != (1, t) or not np.isfinite(out).all():
        raise AssertionError(f"24 kHz request answered {status}: {body[:200]}")
    if sum(served.values()) != PATH_LAUNCHES or set(by_route(served)) != {F32}:
        raise AssertionError(f"24 kHz request launched the kernel as {served}")
    if served_rate != RATE_LAUNCHES:
        raise AssertionError(f"24 kHz request: {served_rate} rate-change launches")
    del model, server, service
    return dict(kernel_vs_unfused=diff, launches=by_entry(counts), batch128_cores=cores,
                rate_change_launches=sum(rate.values()), served_ms=served_ms,
                served_launches=by_entry(served), served_rate_change_launches=served_rate), \
        time_shapes(by_shape(counts), TIMING_BATCH, tag="24k"), rate


def rate_module(direction, cin, cout, r, aa, seed):
    """A folded rate-change PReLUConv on the card (slope 0.2, a nonzero
    bias) and the rate-change kernel's arguments for it."""
    from open_universe_tpu_torch.nn.blocks import PReLUConv
    from open_universe_tpu_torch.nn.layers import init_weights

    conv = PReLUConv(cin, cout, r, stride=r, use_transpose=direction == "up", antialiasing=aa)
    init_weights(conv, seed)
    with torch.no_grad():
        conv.prelu.weight.fill_(0.2)
        if conv.manual_bias:
            conv.bias.uniform_(-0.5, 0.5, generator=torch.Generator().manual_seed(seed))
    conv = conv.to(DEVICE).eval()
    return conv, (conv.conv.weight, conv.bias if conv.manual_bias else conv.conv.bias,
                  conv.prelu.weight, r, direction,
                  conv.low_pass_filter.weights if aa else None)


def rate_shapes(tag, rate_counts, batch):
    """The rate-change kernel at each (direction, Cin, Cout, r, T, low-pass)
    of rate_counts (one enhance's launches) at this batch: on each core the
    shape has, against its plain version (TF32 off, within TOL of
    max|plain|), then each core, the plain version and the PReLUConv module
    alone (cuDNN at PyTorch's default TF32), with its bound; one dict per
    shape (``ms`` the table's core), and their sums per enhance (``ms`` on
    the table's cores, ``<core>_ms`` at the shapes that have that core)."""
    from open_universe_tpu_torch.ops.kernels import rate_change

    shapes = []
    for (direction, _, cin, cout, r, t, aa), n in sorted(rate_counts.items()):
        conv, args = rate_module(direction, cin, cout, r, aa, seed=cin + r)
        g = torch.Generator(device=DEVICE).manual_seed(t + batch)
        x = torch.randn(batch, t, cin, generator=g, device=DEVICE)
        table = rate_change.rate_core(direction, r, cin, rate_change.gemm_rows(direction, batch, t, r))
        by_core, err, scale = {}, 0.0, 1.0
        with torch.no_grad():
            ref = rate_change.rate_change_reference(x, *args)
            for core in rate_change.rate_cores(direction, r, cin):
                got = rate_change.rate_change(x, *args, core=core)
                e, scale = (got - ref).abs().max().item(), ref.abs().max().item()
                if not (got.is_contiguous() and math.isfinite(e) and e <= TOL[torch.float32] * scale):
                    raise AssertionError(f"[{tag}] rate change {direction} {cin}->{cout} r={r} "
                                         f"T={t} B={batch} aa={aa:d} {core}: max|d| {e:.3e} of "
                                         f"max|ref| {scale:.3e}")
                err = max(err, e)
                by_core[core] = cuda_ms(lambda: rate_change.rate_change(x, *args, core=core), 20)
            ms = by_core[table]
            plain_ms = cuda_ms(lambda: rate_change.rate_change_reference(x, *args), 3)
            tf32_flags(True)
            try:
                module_ms = cuda_ms(lambda: conv(x), 10)
            finally:
                tf32_flags(False)
        moved = (x.numel() + ref.numel() + 2 * args[0].numel() + cout) * 4
        t_bytes = moved / PEAK_BYTES_PER_S * 1e3
        t_ops = 2.0 * batch * t * cin * cout * (r if direction == "up" else 1) \
            / PEAK_FLOPS[torch.float32] * 1e3
        bound = max(t_bytes, t_ops)
        shapes.append(dict(direction=direction, Cin=cin, Cout=cout, r=r, T=t, low_pass=aa,
                           launches=n, max_abs_err=err, max_rel_err=err / scale, ms=ms,
                           core=table, ms_by_core=by_core, plain_ms=plain_ms,
                           module_ms=module_ms, bytes_ms=t_bytes, ops_ms=t_ops,
                           bound_share=bound / ms))
        log(f"[{tag}] {direction:4s} {cin:3d}->{cout:3d} r={r} T={t:5d} aa={aa:d} B={batch} "
            f"x{n}: max|d| {err / scale:.2e} max|ref|; kernel {ms:.4f} ms on {table} "
            f"({bound / ms:.3f} of bound {bound:.4f} ms by "
            f"{'bytes' if t_bytes >= t_ops else 'operations'}; "
            + ", ".join(f"{c} {v:.4f} ({bound / v:.3f})" for c, v in by_core.items())
            + f"), plain {plain_ms:.4f}, module {module_ms:.4f}")
        del conv, args, x, got, ref
    total = {k: sum(s[k] * s["launches"] for s in shapes)
             for k in ("ms", "plain_ms", "module_ms")}
    total["bound_ms"] = sum(max(s["bytes_ms"], s["ops_ms"]) * s["launches"] for s in shapes)
    for core in ("mma_sync", "wgmma"):
        has = [s for s in shapes if core in s["ms_by_core"]]
        total[f"{core}_ms"] = sum(s["ms_by_core"][core] * s["launches"] for s in has)
        total[f"{core}_launches"] = sum(s["launches"] for s in has)
    total["table_launches"] = {core: sum(s["launches"] for s in shapes if s["core"] == core)
                               for core in ("mma_sync", "wgmma")}
    total["max_abs_err"] = max(s["max_abs_err"] for s in shapes)
    total["max_rel_err"] = max(s["max_rel_err"] for s in shapes)
    log(f"[{tag}] per enhance at batch {batch}: kernel {total['ms']:.3f} ms on the table's "
        f"cores {total['table_launches']}, module {total['module_ms']:.3f} ms, plain "
        f"{total['plain_ms']:.3f} ms, bound {total['bound_ms']:.3f} ms; mma.sync "
        f"{total['mma_sync_ms']:.3f} ms ({total['mma_sync_launches']} launches), wgmma "
        f"{total['wgmma_ms']:.3f} ms ({total['wgmma_launches']} launches)")
    return shapes, total


def graph_ms(fn, n: int = 20) -> float:
    """Device ms of one fn() from a CUDA graph of n calls (the best of three
    replays), after an eager warm-up: small launches without the host's
    launch gaps."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    best = math.inf
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / n)
    return best


RATE_SWEEP_BATCHES = (1, 2, 4, 8, 16, 64)


def rate_sweep(rate_counts):
    """Both cores' device ms a launch at each 2 s shape of rate_counts that
    has both, at batch 1 of a 1 s clip and RATE_SWEEP_BATCHES of the 2 s
    clip, beside the table's core: the sweep that sets RateWgTile's
    MIN_ROWS.  Rows where the table's core is slower than the other by more
    than 5 % are listed under "slower"."""
    from open_universe_tpu_torch.ops.kernels import rate_change

    rows, slower = [], []
    for (direction, _, cin, cout, r, t, aa) in sorted(rate_counts):
        if rate_change.rate_cores(direction, r, cin) != ("mma_sync", "wgmma"):
            continue
        _, args = rate_module(direction, cin, cout, r, aa, seed=cin + r)
        for batch, tt in [(1, t // 2)] + [(b, t) for b in RATE_SWEEP_BATCHES]:
            x = torch.randn(batch, tt, cin, device=DEVICE)
            gemm_rows = rate_change.gemm_rows(direction, batch, tt, r)
            with torch.no_grad():
                ms = {core: graph_ms(lambda: rate_change.rate_change(x, *args, core=core))
                      for core in ("mma_sync", "wgmma")}
            table = rate_change.rate_core(direction, r, cin, gemm_rows)
            row = dict(direction=direction, Cin=cin, r=r, low_pass=aa, B=batch, T=tt,
                       rows=gemm_rows, table=table, **{f"{c}_ms": v for c, v in ms.items()})
            rows.append(row)
            other = min(ms.values())
            if ms[table] > 1.05 * other:
                slower.append(row)
            log(f"[rate sweep] {direction:4s} {cin:3d} r={r} aa={aa:d} B={batch:3d} T={tt:5d} "
                f"rows {gemm_rows:8d}: mma.sync {ms['mma_sync']:.4f} ms, wgmma "
                f"{ms['wgmma']:.4f} ms (wgmma/mma.sync {ms['wgmma'] / ms['mma_sync']:.2f}); "
                f"table {table}")
            del x
        del args
    log(f"[rate sweep] {len(rows)} points, the table's core slower by > 5 % at {len(slower)}")
    return dict(points=rows, slower=slower)


def phase_rate_change(model, rate16, rate24):
    """3e: the rate-change kernel against its plain version and timed beside
    the module it replaces at each shape of phases 3 (16 kHz) and 3c (24
    kHz) at batch 128 and of a 1 s bucket at the server's batches; then
    traced f32 enhances at batch 128 with the kernel and with the module."""
    from open_universe_tpu_torch.models.presets import universe_original
    from open_universe_tpu_torch.ops.kernels import rate_change
    from open_universe_tpu_torch.utils.convert import fold_weight_norm

    result = {"batch128_16k": rate_shapes("rate 16k", rate16, TIMING_BATCH)[1],
              "batch128_24k": rate_shapes("rate 24k", rate24, TIMING_BATCH)[1],
              "sweep": rate_sweep({**rate16, **rate24})}
    t = int(BUCKET_S * FS)
    g = torch.Generator(device=DEVICE).manual_seed(21)
    mix = torch.randn(1, t, generator=g, device=DEVICE) * 0.05
    counted_enhance(model, mix, noise_draws(model, 1, t, seed=22))
    bucket = dict(rate_change.launches)
    if sum(bucket.values()) != RATE_LAUNCHES:
        raise AssertionError(f"1 s bucket: rate-change launches {bucket}")
    for batch in SERVE_BATCHES:
        result[f"bucket1s_batch{batch}"] = rate_shapes(f"rate 1s B{batch}", bucket, batch)[1]

    # one enhance each way at batch 128 x 2 s in f32 with PyTorch's default
    # TF32, as the benchmark's cells run it; "module": takes() refuses all
    t = int(CLIP_S * FS)
    g = torch.Generator(device=DEVICE).manual_seed(23)
    mix = torch.randn(TIMING_BATCH, t, generator=g, device=DEVICE) * 0.05
    takes = rate_change.takes
    profiles = {}
    tf32_flags(True)
    try:
        for name, net in (("universepp", model),
                          ("universe_original",
                           fold_weight_norm(universe_original(FS, device=DEVICE, seed=0)).eval())):
            noise = noise_draws(net, TIMING_BATCH, t, seed=24)
            for arm in ("kernel", "module"):
                if arm == "module":
                    rate_change.takes = lambda *a: False
                try:
                    def run():
                        net.enhance(mix, n_steps=N_STEPS, noise=noise)
                    run()  # warm-up
                    torch.cuda.synchronize()
                    rate_change.launches.clear()
                    prof = device_profile(f"[rate profile] {name} {arm}", run)
                    prof["rate_change_launches"] = sum(rate_change.launches.values())
                finally:
                    rate_change.takes = takes
                want = RATE_LAUNCHES if arm == "kernel" else 0
                if prof["rate_change_launches"] != want:
                    raise AssertionError(f"{name} {arm}: {prof['rate_change_launches']} "
                                         f"rate-change launches, not {want}")
                profiles[f"{name}_{arm}"] = prof
            del net, noise
    finally:
        tf32_flags(False)
    for name in ("universepp", "universe_original"):
        k, m = profiles[f"{name}_kernel"], profiles[f"{name}_module"]
        log(f"[rate profile] {name} f32 batch {TIMING_BATCH}: device events per call "
            f"{m['device_kernels']} -> {k['device_kernels']}, busy {m['device_busy_ms']:.1f} "
            f"-> {k['device_busy_ms']:.1f} ms, traced wall {m['traced_wall_ms']:.1f} -> "
            f"{k['traced_wall_ms']:.1f} ms (module -> kernel)")
    result["profiles"] = profiles
    return result


def timed_enhance(model, mix, noise, fused: bool, dtype=torch.bfloat16, runs: int = 5):
    """Median wall time of enhance with dtype networks (None: float32) over
    ``runs`` runs after 2 warm-ups."""
    from open_universe_tpu_torch.ops import kernels

    kernels.enable(fused)
    try:
        times = []
        for i in range(runs + 2):  # 2 warm-up runs, then the timed ones
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.enhance(mix, n_steps=N_STEPS, compute_dtype=dtype, noise=noise)
            torch.cuda.synchronize()
            if i >= 2:
                times.append(time.perf_counter() - t0)
    finally:
        kernels.enable(True)
    times.sort()
    return times[len(times) // 2]


def chain_bound(batch, t, c, dtype, tensors):
    """(bytes ms, operations ms): each input read once, v and cond_out
    written once, over 3.35 TB/s; 22 B T C^2 FLOPs over the dtype's peak."""
    moved = sum(x.numel() * x.element_size() for x in tensors if x is not None) \
        + 2 * batch * t * c * torch.finfo(dtype).bits // 8
    return moved / PEAK_BYTES_PER_S * 1e3, 22.0 * batch * t * c * c / PEAK_FLOPS[dtype] * 1e3


def time_shapes(shape_counts, batch, tag="timing"):
    """The kernel's main entry, its plain version and the unfused chain at
    each (C, T, FiLM, cond) of shape_counts at this batch, in bf16 and in f32
    (3xTF32); one dict per shape with its launches, bounds, TFLOP/s and
    bound share (bf16 keys bare, f32 keys f32_*).  f32 runs on the core the
    table gives the shape (f32_core), and is timed on each core the width
    has (f32_mma_sync_ms, f32_wgmma_ms: None where it lacks that core), each
    core's output held to the f32 gate against the plain version's."""
    from open_universe_tpu_torch.nn.blocks import ConvBlock
    from open_universe_tpu_torch.nn.layers import init_weights
    from open_universe_tpu_torch.ops import kernels
    from open_universe_tpu_torch.ops.kernels import conv_block
    from open_universe_tpu_torch.utils.convert import fold_weight_norm

    shapes = []
    for (c, t_c, film, cond), n in sorted(shape_counts.items()):
        block = fold_weight_norm(init_weights(ConvBlock(c, weight_norm=True))).to(DEVICE)
        flops = 22.0 * batch * t_c * c * c
        shape = dict(C=c, T=t_c, film=film, cond=cond, launches=n)
        for dtype, key in ((torch.bfloat16, ""), (torch.float32, "f32_")):
            h, weights, nc, ic = chain_inputs(batch, t_c, c, dtype, film, cond)

            def kernel():
                return conv_block.fused_conv_chain(h, *weights, noise_cond=nc, input_cond=ic)

            def plain():
                return conv_block.fused_conv_chain_reference(h, *weights, noise_cond=nc,
                                                             input_cond=ic)

            def unfused():
                block(h, noise_cond=nc, input_cond=ic)

            ms, plain_ms = cuda_ms(kernel, 10), cuda_ms(plain, 3 if key else 5)
            if key:
                core = conv_block.chain_core(dtype, batch * t_c, c)
                want = plain()
                gate(f"[{tag}] C={c} T={t_c} B={batch} f32 {core}", kernel(), want, dtype)
                on = dict.fromkeys(conv_block.CORES)
                on[core] = ms
                for other in set(conv_block.width_cores(dtype, c)) - {core}:
                    def forced():
                        return conv_block._launch(ENTRY, h, weights, nc, ic, core=other)

                    gate(f"[{tag}] C={c} T={t_c} B={batch} f32 {other}", forced(), want, dtype)
                    on[other] = cuda_ms(forced, 10)
                del want
                shape.update(f32_core=core, f32_mma_sync_ms=on["mma_sync"],
                             f32_wgmma_ms=on["wgmma"])
            kernels.enable(False)
            try:
                with torch.no_grad():
                    unfused_ms = cuda_ms(unfused, 5 if key else 10)
            finally:
                kernels.enable(True)
            t_bytes, t_ops = chain_bound(batch, t_c, c, dtype, [h, nc, ic, *weights])
            bound = max(t_bytes, t_ops)
            shape.update({f"{key}ms": ms, f"{key}plain_ms": plain_ms,
                          f"{key}unfused_ms": unfused_ms, f"{key}bytes_ms": t_bytes,
                          f"{key}ops_ms": t_ops, f"{key}tflops": flops / ms / 1e9,
                          f"{key}bound_share": bound / ms})
            log(f"[{tag}] C={c:3d} T={t_c:5d} film={film:d} cond={cond:d} B={batch} x{n} "
                f"{str(dtype)[6:]}: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s, "
                f"{bound / ms:.3f} of bound {bound:.4f} ms by "
                f"{'bytes' if t_bytes >= t_ops else 'operations'}), plain {plain_ms:.4f}, "
                f"unfused chain {unfused_ms:.4f}"
                + (f"; {shape['f32_core']} core; mma.sync "
                   f"{shape['f32_mma_sync_ms'] or float('nan'):.4f}, "
                   f"wgmma {shape['f32_wgmma_ms'] or float('nan'):.4f}" if key else ""))
            del h, weights, nc, ic
        shapes.append(shape)
        del block
    return shapes


def log_cores(tag, shapes):
    """One line per width of ``time_shapes``' f32 numbers: ms per enhance
    (each shape alone, times its launches) on the table's core and on
    mma.sync where the width has it, beside the 3xTF32 bound."""
    for c in sorted({s["C"] for s in shapes}):
        w = [s for s in shapes if s["C"] == c]
        bound = sum(max(s["f32_bytes_ms"], s["f32_ops_ms"]) * s["launches"] for s in w)
        ms = sum(s["f32_ms"] * s["launches"] for s in w)
        mma = None if any(s["f32_mma_sync_ms"] is None for s in w) else \
            sum(s["f32_mma_sync_ms"] * s["launches"] for s in w)
        log(f"[cores] f32 per enhance, {tag}, C={c:3d} x{sum(s['launches'] for s in w)}: "
            f"{'/'.join(sorted({s['f32_core'] for s in w}))} {ms:.2f} ms, mma.sync "
            f"{'(none at this width)' if mma is None else f'{mma:.2f} ms'}, 3xTF32 bound "
            f"{bound:.2f} ms ({bound / ms:.2f} of it)")


def check_batch_cores(tag, model, mix, noise, wgmma_widths):
    """One f32 ``enhance`` of the batch counted by core: every width in
    ``wgmma_widths`` on wgmma, the others on mma.sync, one launch per
    ConvBlock.  Returns the counts, "core C" -> launches."""
    _, counts = counted_enhance(model, mix, noise)
    cores = core_counts()
    log(f"[{tag}] f32 enhance batch {mix.shape[0]}: cores {cores}")
    want = {f"{'wgmma' if c in wgmma_widths else 'mma_sync'} {c}"
            for c in {k[2] for k in counts}}
    if set(cores) != want or sum(cores.values()) != PATH_LAUNCHES:
        raise AssertionError(f"{tag}: batch {mix.shape[0]} ran the cores {cores}, not {want}")
    return cores


def phase_timing(model, shape_counts):
    """End-to-end audio-s/s both ways, then each launched shape alone."""
    batch = TIMING_BATCH
    t = int(CLIP_S * FS)
    g = torch.Generator(device=DEVICE).manual_seed(3)
    mix = torch.randn(batch, t, generator=g, device=DEVICE) * 0.05
    noise = noise_draws(model, batch, t, seed=4)
    audio_s = batch * CLIP_S
    rates = {}
    for dtype, fused in ((torch.bfloat16, True), (torch.bfloat16, False),
                         (torch.bfloat16, False), (torch.bfloat16, True),
                         (None, True), (None, False)):
        s = timed_enhance(model, mix, noise, fused, dtype)
        key = ("" if dtype else "f32_") + ("kernel" if fused else "unfused")
        rates.setdefault(key, []).append(audio_s / s)
        log(f"[timing] enhance batch {batch} x {CLIP_S} s {'bf16' if dtype else 'f32'}, "
            f"{'kernel' if fused else 'unfused'}: median {s:.4f} s -> "
            f"{audio_s / s:.2f} audio-s/s")
    check_batch_cores("timing", model, mix, noise, (32, 64, 128, 256))

    return rates, time_shapes(shape_counts, batch), mix, noise


def phase_small_batch(model, small_shapes):
    """bf16 enhance at batch 1 and SERVE_BATCH, twice each; then the main
    entry alone at each of small_shapes at batch 1 and SERVE_BATCH (the
    second's shapes are returned, the first's logged)."""
    t = int(CLIP_S * FS)
    rates, inputs = {}, {}
    for batch in (1, SERVE_BATCH, SERVE_BATCH, 1):
        if batch not in inputs:
            g = torch.Generator(device=DEVICE).manual_seed(5)
            inputs[batch] = (torch.randn(batch, t, generator=g, device=DEVICE) * 0.05,
                             noise_draws(model, batch, t, seed=6))
        s = timed_enhance(model, *inputs[batch], True)
        rates.setdefault(f"batch{batch}", []).append(dict(
            audio_s_per_s=batch * CLIP_S / s, latency_ms=s * 1e3))
        log(f"[small] enhance batch {batch} x {CLIP_S} s bf16: median "
            f"{s * 1e3:.2f} ms -> {batch * CLIP_S / s:.2f} audio-s/s")

    time_shapes(small_shapes, 1, tag="small b1")
    return rates, time_shapes(small_shapes, SERVE_BATCH, tag=f"small b{SERVE_BATCH}"), inputs[1]


def phase_crossover():
    """Both f32 cores alone at each width that has both, at its 2 s length
    with FiLM and cond, at each of CROSSOVER_BATCHES: the table's core
    beside the faster one.  Returns "C<c> B<batch>" -> rows, the table's
    core and ms on each core."""
    from open_universe_tpu_torch.ops.kernels import conv_block

    out = {}
    for c in conv_block.WIDTHS:
        if conv_block.width_cores(torch.float32, c) != conv_block.CORES:
            continue
        t = {**WIDTH_LENGTHS, **WIDTH_LENGTHS_24K}[c]
        for batch in CROSSOVER_BATCHES:
            h, weights, nc, ic = chain_inputs(batch, t, c, torch.float32, True, True)
            ms = {core: cuda_ms(lambda: conv_block._launch(ENTRY, h, weights, nc, ic,
                                                           core=core), 10)
                  for core in conv_block.CORES}
            table = conv_block.chain_core(torch.float32, batch * t, c)
            faster = min(ms, key=ms.get)
            out[f"C{c} B{batch}"] = dict(rows=batch * t, table=table, **ms)
            log(f"[crossover] C={c:3d} T={t:5d} B={batch:2d} ({batch * t} rows): mma.sync "
                f"{ms['mma_sync']:.4f} ms, wgmma {ms['wgmma']:.4f} ms; table {table}"
                + ("" if table == faster else f", {faster} faster by "
                   f"{ms[table] / ms[faster] - 1:.1%}"))
            del h, weights, nc, ic
    return out


def model_config(name: str) -> dict:
    """The model node of config/model/<name> with its
    ${model.score_model.*} references written out."""
    import yaml

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "config", "model", name)
    with open(path) as f:
        node = yaml.safe_load(f)
    ref = re.compile(r"^\$\{model\.score_model\.(\w+)\}$")
    cond = node["condition_model"]
    for k, v in cond.items():
        m = ref.match(v) if isinstance(v, str) else None
        if m:
            cond[k] = node["score_model"][m.group(1)]
    return node


def write_checkpoint(directory: str, fs: int = FS, config: str = "default.yaml") -> str:
    """A reference-layout Lightning checkpoint of universepp(fs, seed=0),
    with config/model/<config>'s model node beside it as config.yaml:
    weight norm unfolded, the score model under the EDM ``_edm_model.``
    prefix, raw weights at half the EMA shadow, which holds the seeded
    weights; the signal-decoupling layer, which the reference never
    optimises, equal in both."""
    import yaml

    from open_universe_tpu_torch.inference.model_loader import ordered_param_names
    from open_universe_tpu_torch.models.presets import universepp

    shadow_sd = {re.sub(r"^score_model\.", "_edm_model.", k): v.detach().cpu().clone()
                 for k, v in universepp(fs, device="cpu", seed=0).state_dict().items()}
    names = ordered_param_names(
        shadow_sd, ["_edm_model", "condition_model", "signal_decoupling_layer"])
    raw_sd = {k: v * 0.5 if k in names and not k.startswith("signal_decoupling_layer.")
              else v for k, v in shadow_sd.items()}
    path = os.path.join(directory, "weights.ckpt")
    torch.save({"state_dict": raw_sd,
                "ema": {"shadow_params": [shadow_sd[n] for n in names],
                        "decay": 0.999, "num_updates": 1000}}, path)
    with open(os.path.join(directory, "config.yaml"), "w") as f:
        yaml.safe_dump({"model": model_config(config)}, f)
    return path


def wav_bytes(x: np.ndarray, fs: int = FS) -> bytes:
    from open_universe_tpu_torch.data.audio import save_audio

    with tempfile.NamedTemporaryFile(suffix=".wav") as f:
        save_audio(f.name, x, fs)
        return open(f.name, "rb").read()


def wav_decode(body: bytes) -> np.ndarray:
    """(channels, T) float32, as the server's load_audio reads it."""
    with wave.open(io.BytesIO(body)) as w:
        n, ch = w.getnframes(), w.getnchannels()
        data = np.frombuffer(w.readframes(n), np.int16).reshape(n, ch).T
    return data.astype(np.float32) / 32768.0


def post(url: str, body: bytes):
    req = urllib.request.Request(url + "/enhance", data=body)
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def get_json(url: str):
    with urllib.request.urlopen(url, timeout=60) as r:
        return json.loads(r.read())


def phase_serving():
    """The serving path end to end on the card; returns its numbers and the
    launches by entry counted over the served requests (the main one only)."""
    from open_universe_tpu_torch.bin.serve import make_server
    from open_universe_tpu_torch.inference.model_loader import load_model
    from open_universe_tpu_torch.models.presets import universepp
    from open_universe_tpu_torch.ops.kernels import conv_block
    from open_universe_tpu_torch.utils.convert import fold_weight_norm

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        model = load_model(write_checkpoint(tmp), device=DEVICE)
        log(f"[serve] checkpoint written and loaded in {time.perf_counter() - t0:.1f} s")
    want = fold_weight_norm(universepp(FS, device=DEVICE, seed=0)).state_dict()
    got = model.state_dict()
    ema_err = max((got[k].float() - v.float()).abs().max().item() for k, v in want.items())
    log(f"[serve] loaded weights vs the EMA shadow, folded: max|d| = {ema_err:.3e}")
    if set(got) != set(want) or not ema_err <= 1e-5:
        raise AssertionError("load_model did not apply the EMA shadow")
    del want

    server, service = make_server(model, model_name="universepp-16k-seeded",
                                  port=0, max_batch=SERVE_BATCH, batch_window_ms=50.0,
                                  bucket_seconds=BUCKET_S)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        t0 = time.perf_counter()
        n_warm = service.precompile(CLIP_S)
        warm_s = time.perf_counter() - t0
        log(f"[serve] warm-up: {n_warm} (bucket, rows) shapes in {warm_s:.1f} s")
        rng = np.random.default_rng(7)

        def clip(seconds, channels=1):
            x = 0.05 * rng.standard_normal((channels, int(seconds * FS)))
            x += 0.1 * np.sin(2 * np.pi * 220 * np.arange(x.shape[1]) / FS)
            return (x[0] if channels == 1 else x).astype(np.float32)

        conv_block.launches.clear()
        state = service.generator.get_state()
        first = wav_bytes(clip(CLIP_S))
        status, body = post(url, first)
        if status != 200:
            raise AssertionError(f"first request answered {status}: {body[:200]}")
        first_out = wav_decode(body)

        t = int(CLIP_S * FS)
        bodies = ([wav_bytes(clip(CLIP_S)) for _ in range(8)]
                  + [wav_bytes(clip(CLIP_S / 2)) for _ in range(3)]
                  + [wav_bytes(clip(CLIP_S, channels=2))])
        shapes = [(1, t)] * 8 + [(1, t // 2)] * 3 + [(2, t)]
        results = [None] * len(bodies)
        go = threading.Barrier(len(bodies))

        def send(i):
            go.wait()
            results[i] = post(url, bodies[i])

        t0 = time.perf_counter()
        threads = [threading.Thread(target=send, args=(i,)) for i in range(len(bodies))]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        burst_s = time.perf_counter() - t0
        for (status, body), shape in zip(results, shapes):
            if status != 200:
                raise AssertionError(f"concurrent request answered {status}: {body[:200]}")
            out = wav_decode(body)
            if out.shape != shape or not np.isfinite(out).all():
                raise AssertionError(f"response shape {out.shape}, expected {shape}")
        stats = get_json(url + "/stats")
        log(f"[serve] 12 concurrent requests (13 clips) in {burst_s:.3f} s; stats {stats}")
        if stats["clips"] != 14 or stats["errors"]:
            raise AssertionError(f"/stats counts {stats['clips']} clips, expected 14")

        latencies = []
        for _ in range(5):
            body = wav_bytes(clip(CLIP_S))
            t0 = time.perf_counter()
            status, _ = post(url, body)
            latencies.append(time.perf_counter() - t0)
            if status != 200:
                raise AssertionError(f"timed request answered {status}")
        stats = get_json(url + "/stats")
        torch.cuda.synchronize()
        entries = by_entry(conv_block.launches)
        latencies.sort()
        log(f"[serve] 5 lone 2 s requests: median latency "
            f"{latencies[2] * 1e3:.1f} ms (all {[round(x * 1e3, 1) for x in latencies]}); "
            f"device_realtime_factor {stats['device_realtime_factor']:.2f}; "
            f"launches by entry while serving {entries}")
        if set(entries) != {ENTRY}:
            raise AssertionError(f"served requests launched the kernel as {entries}")

        # the first response against enhance of its bucket-padded batch with
        # the generator state the service started from
        from open_universe_tpu_torch.data.audio import load_audio

        with tempfile.NamedTemporaryFile(suffix=".wav") as f:
            f.write(first)
            f.flush()
            sent, _ = load_audio(f.name)
        g = torch.Generator(device=DEVICE)
        g.set_state(state)
        direct = model.enhance(torch.from_numpy(sent).to(DEVICE), generator=g)
        direct = direct.float().cpu().numpy()
        diff = float(np.abs(first_out - direct).max())
        log(f"[serve] first response vs direct enhance: max|d| = {diff:.3e} "
            f"(bound 1e-4 + 1/32767)")
        if not diff <= 1e-4 + 1.0 / 32767:
            raise AssertionError(f"served result differs from enhance by {diff}")
    finally:
        server.shutdown()
        service.close()
    return dict(warmup_shapes=n_warm, warmup_s=warm_s, burst_s=burst_s,
                median_latency_ms=latencies[2] * 1e3,
                latencies_ms=[x * 1e3 for x in latencies],
                device_realtime_factor=stats["device_realtime_factor"],
                mean_batch=stats["mean_batch"], first_vs_direct=diff,
                ema_err=ema_err), entries


# phase 7's input tree: (relative path, rate, channels, seconds)
CLI_FILES = [("a.wav", 16000, 1, 2.0), ("b.wav", 16000, 1, 3.5), ("c.wav", 16000, 1, 7.0),
             ("d.flac", 44100, 2, 3.0), ("sub/e.wav", 24000, 1, 2.5)]
CLI_MP3 = ("f.mp3", 16000, 1, 1.5)
CLI_BATCH = 8
CLI_SEED = 1028282  # the CLI's default --seed
CLI_LINE = re.compile(r"enhanced (\d+) files \(([\d.]+)s audio\) in ([\d.]+)s "
                      r"\(([\d.]+)x realtime\)")


def mp3_libraries() -> bool:
    import ctypes

    try:
        ctypes.CDLL("libmpg123.so.0")
        ctypes.CDLL("libmp3lame.so.0")
    except OSError:
        return False
    return True


def write_tree(root: str, files) -> None:
    from open_universe_tpu_torch.data.audio import save_audio

    rng = np.random.default_rng(17)
    for name, fs, ch, seconds in files:
        t = int(fs * seconds)
        x = (0.1 * np.sin(2 * np.pi * 220 * np.arange(t) / fs)
             + 0.05 * rng.standard_normal((ch, t))).astype(np.float32)
        path = os.path.join(root, name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        save_audio(path, x[0] if ch == 1 else x, fs)


def run_cli(tag, src, dst, ckpt, *extra):
    """``bin/enhance.py``'s main in this process on the default device, f32,
    8 steps; returns its launches (counted from 0), its realtime-factor line
    and the call's wall seconds (model load included)."""
    import contextlib

    from open_universe_tpu_torch.bin import enhance as cli
    from open_universe_tpu_torch.ops.kernels import conv_block

    err = io.StringIO()
    conv_block.launches.clear()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = cli.main([src, dst, "--model", ckpt, "--batch-size", str(CLI_BATCH),
                       "--n_steps", str(N_STEPS), *extra])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(conv_block.launches)
    m = CLI_LINE.search(err.getvalue())
    log(f"[cli {tag}] rc {rc}, {wall:.2f} s with the model load; "
        f"{m.group(0) if m else 'no realtime line'}; launches {by_entry(counts)}")
    if rc != 0 or m is None:
        raise AssertionError(f"cli {tag}: exit {rc}: {err.getvalue()[-2000:]}")
    return counts, dict(files=int(m.group(1)), audio_s=float(m.group(2)),
                        enhance_s=float(m.group(3)), realtime=float(m.group(4)),
                        wall_s=wall)


def check_outputs(tag, out_root, files):
    """Every file written with its rate, length, channels and container, and
    finite; returns the outputs by name."""
    from open_universe_tpu_torch.data.audio import load_audio

    outs = {}
    for name, fs, ch, seconds in files:
        y, got_fs = load_audio(os.path.join(out_root, name))
        lossy = name.endswith(".mp3")  # the encoder pads its frames
        if (got_fs != fs or y.shape[0] != ch or not np.isfinite(y).all()
                or (y.shape[1] < int(fs * seconds) if lossy else
                    y.shape[1] != int(fs * seconds))):
            raise AssertionError(f"cli {tag}: {name} came back as {y.shape} at {got_fs} Hz")
        outs[name] = y
    return outs


def cli_kwargs(model, *flags):
    """The ``enhance`` arguments the CLI passes for these flags, from the
    CLI's own parse (its defaults come from the model's config)."""
    import argparse

    from open_universe_tpu_torch.inference.signature_to_parser import (
        parse_with_enhance_args,
    )

    parser = argparse.ArgumentParser()
    parser.add_argument("--model")
    _, _, kwargs = parse_with_enhance_args(
        parser, ["--n_steps", str(N_STEPS), *flags], lambda *_, **__: model)
    return kwargs


def unfused_cli(model, src, files, *flags, chunk=None):
    """What the CLI writes for ``flags``, recomputed with the kernels off:
    its batches (or, with ``chunk`` seconds, its files in chunks) in its
    order through ``enhance`` on one generator seeded as the CLI seeds it,
    each file's channels cut to length and resampled to the file's rate as
    the CLI writes them.  Returns {name: (channels, T)} of the lossless
    files."""
    from pathlib import Path

    from open_universe_tpu_torch.bin import enhance as cli
    from open_universe_tpu_torch.data.audio import load_audio, resample_audio
    from open_universe_tpu_torch.inference.chunked import make_chunked_enhancer
    from open_universe_tpu_torch.ops import kernels

    kwargs = cli_kwargs(model, *flags)
    audio = {}
    for name, *_ in files:
        x, fs = load_audio(os.path.join(src, name))
        audio[name] = resample_audio(x, fs, FS)
    g = torch.Generator(device=DEVICE).manual_seed(CLI_SEED)
    rows = {}
    kernels.enable(False)
    try:
        if chunk is not None:
            enhancer = make_chunked_enhancer(model, chunk_seconds=chunk,
                                             max_batch=CLI_BATCH, **kwargs)
            for name in sorted(audio):
                for ch, x in enumerate(audio[name]):
                    rows[name, ch] = enhancer(x, generator=g)
        else:
            paths = [Path(src, name) for name in audio]
            for bucket_len, group in cli._bucket(paths, FS, CLI_BATCH, FS):
                names = [str(p.relative_to(src)) for p, _ in group]
                batch = np.zeros((len(group), bucket_len), np.float32)
                for i, (name, (_, ch)) in enumerate(zip(names, group)):
                    batch[i, :audio[name].shape[1]] = audio[name][ch]
                out = model.enhance(torch.from_numpy(batch).to(DEVICE), generator=g,
                                    **kwargs).float().cpu().numpy()
                for i, (name, (_, ch)) in enumerate(zip(names, group)):
                    rows[name, ch] = out[i, :audio[name].shape[1]]
    finally:
        kernels.enable(True)
    return {name: resample_audio(np.stack([rows[name, c] for c in range(ch)]), FS, fs)
            for name, fs, ch, _ in files if not name.endswith(".mp3")}


def against_unfused(tag, outs, expected) -> float:
    """The CLI's written files (kernels on) against ``unfused_cli``: within
    1e-4 plus the 16-bit rounding of the written file."""
    diff = max(float(np.abs(outs[name] - y).max()) for name, y in expected.items())
    log(f"[cli {tag}] written vs enhance with the kernels off, {sorted(expected)}: "
        f"max|d| = {diff:.3e} (bound 1e-4 + 1/32767)")
    if not diff <= 1e-4 + 1.0 / 32767:
        raise AssertionError(f"cli {tag}: output differs from the unfused enhance by {diff}")
    return diff


def phase_cli():
    """The enhance CLI on the card (``bin/enhance.py``): bucketed, with
    ``--use_aux_signal``, chunked, and with an ensemble and a warm start.
    Each run's written files are held against the same batches recomputed
    with the kernels off.  Returns its numbers and launches by run."""
    from pathlib import Path

    from open_universe_tpu_torch.bin import enhance as cli
    from open_universe_tpu_torch.inference.model_loader import load_model

    files = CLI_FILES + ([CLI_MP3] if mp3_libraries() else [])
    log(f"[cli] MP3 {'exercised' if len(files) > len(CLI_FILES) else 'not exercised: '
                     'libmpg123 or libmp3lame does not load'}; inputs {files}")
    result, launches = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = write_checkpoint(tmp)
        src = os.path.join(tmp, "in")
        write_tree(src, files)
        model = load_model(ckpt, device=DEVICE)
        # one batch of 1-3 rows per 1 s bucket
        n_batches = len(cli._bucket([Path(src, name) for name, *_ in files], FS,
                                    CLI_BATCH, FS))

        def run(tag, per_batch, *flags, inputs=files, path=src, chunk=None):
            out = os.path.join(tmp, tag)
            os.makedirs(out)
            counts, result[tag] = run_cli(tag, path, out, ckpt, *flags,
                                          *(["--chunk-seconds", str(chunk)] if chunk else []))
            outs = check_outputs(tag, out, inputs)
            launches[tag] = by_entry(counts)
            if ((per_batch and sum(counts.values()) != per_batch * n_batches)
                    or set(launches[tag]) != {ENTRY} or set(by_route(counts)) != {F32}):
                raise AssertionError(f"cli {tag}: {n_batches} batches launched the "
                                     f"kernel as {counts}")
            result[tag]["vs_unfused"] = against_unfused(
                tag, outs, unfused_cli(model, src, inputs, *flags, chunk=chunk))

        run("bucketed", PATH_LAUNCHES)
        # the aux signal through the snake layer: deterministic, 14 blocks
        run("aux", 14, "--use_aux_signal", "true")
        # the 7 s file in 2 s chunks, 5 rows in one call
        run("chunked", None, inputs=[f for f in files if f[0] == "c.wav"],
            path=os.path.join(src, "c.wav"), chunk=2)
        # an ensemble of 4 with a warm start at step 3: 4-12 rows a batch
        run("ensemble", 10 * (N_STEPS - 3) + 14, "--ensemble", "4",
            "--ensemble_stat", "median", "--warm_start", "3")
        del model
    log(f"[cli] {card_line()}: realtime factor bucketed "
        f"{result['bucketed']['realtime']}x, chunked {result['chunked']['realtime']}x, "
        f"ensemble {result['ensemble']['realtime']}x (f32, batch {CLI_BATCH}, "
        f"{N_STEPS} steps)")
    return result, launches


def device_profile(prefix, fn) -> dict:
    """Trace fn() with torch.profiler: its wall time, device time by kernel
    group (the benchmark's, ``benchmark/common/trace.py``) and under
    PROFILE_OPS, device busy time and idle share, logged after ``prefix``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        raise RuntimeError("torch.profiler recorded no device time")
    groups, other = {}, {}
    for e in events:
        group, ms = kernel_group(e.name), (e.time_range.end - e.time_range.start) / 1e3
        groups[group] = groups.get(group, 0.0) + ms
        if group == "other":
            other[e.name] = other.get(e.name, 0.0) + ms
    busy = union_length((e.time_range.start, e.time_range.end) for e in events) / 1e3
    ops = {row.key: row.device_time_total / 1e3
           for row in prof.key_averages() if row.key in PROFILE_OPS}
    log(f"{prefix}: traced wall {wall_ms:.1f} ms, device busy {busy:.1f} ms, idle share "
        f"{1.0 - busy / wall_ms:.3f}, {len(events)} device kernels")
    for group, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"{prefix}   {group:24s} {ms:9.2f} ms")
    for name, ms in sorted(other.items(), key=lambda kv: -kv[1])[:3]:
        log(f"{prefix}   other: {name[:90]} {ms:.2f} ms")
    for op, ms in ops.items():
        log(f"{prefix}   op {op} (with children) {ms:.2f} ms")
    return dict(traced_wall_ms=wall_ms, device_busy_ms=busy, idle_share=1.0 - busy / wall_ms,
                device_kernels=len(events), groups_ms=groups, ops_ms=ops)


def phase_profile(model, mix, noise, runs=(("kernel", True), ("unfused", False))):
    """One traced enhance per (name, kernels on) run: device time by kernel
    group and op, device busy time and idle share."""
    from open_universe_tpu_torch.ops import kernels

    result = {}
    for name, fused in runs:
        kernels.enable(fused)
        try:
            result[name] = device_profile(f"[profile] {name}", lambda: model.enhance(
                mix, n_steps=N_STEPS, compute_dtype=torch.bfloat16, noise=noise))
        finally:
            kernels.enable(True)
    return result


def phase_step0(model):
    """The fused path refuses what the kernel refuses: an f16 enhance and a
    C = 40 block run the unfused chain on the card (no launch, no error) and
    equal it with the kernels off."""
    from open_universe_tpu_torch.nn.blocks import ConvBlock
    from open_universe_tpu_torch.nn.layers import init_weights
    from open_universe_tpu_torch.ops import kernels
    from open_universe_tpu_torch.ops.kernels import conv_block
    from open_universe_tpu_torch.utils.convert import fold_weight_norm

    t = int(CLIP_S * FS)
    g = torch.Generator(device=DEVICE).manual_seed(11)
    mix = torch.randn(2, t, generator=g, device=DEVICE) * 0.05
    noise = noise_draws(model, 2, t, seed=12)
    out, counts = counted_enhance(model, mix, noise, torch.float16)
    diff16 = (out - unfused_enhance(model, mix, noise, torch.float16)).abs().max().item()
    log(f"[step0] f16 enhance: {sum(counts.values())} launches, max|fused path - unfused| = "
        f"{diff16:.3e}, finite {bool(torch.isfinite(out).all())}")
    if counts or not diff16 == 0.0 or not torch.isfinite(out).all():
        raise AssertionError("an f16 enhance must run the unfused chain")

    block = fold_weight_norm(init_weights(ConvBlock(40), seed=1)).to(DEVICE)
    h = torch.randn(2, 1000, 40, generator=g, device=DEVICE)
    nc = torch.randn(2, 80, generator=g, device=DEVICE)
    conv_block.launches.clear()
    with torch.no_grad():
        got = block(h, noise_cond=nc)
        kernels.enable(False)
        try:
            want = block(h, noise_cond=nc)
        finally:
            kernels.enable(True)
    diff40 = max((a - b).abs().max().item() for a, b in zip(got, want))
    n40 = sum(conv_block.launches.values())
    log(f"[step0] C=40 block: {n40} launches, max|d| vs unfused = {diff40:.3e}")
    if n40 or not diff40 == 0.0:
        raise AssertionError("a C=40 block must run the unfused chain")
    return {"f16_enhance": {"launches": 0, "max_abs_diff": diff16},
            "c40_block": {"launches": 0, "max_abs_diff": diff40}}


def tf32_flags(on: bool) -> None:
    """PyTorch's defaults (cuDNN TF32 on, matmul TF32 off), or both off."""
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = False


def phase_tf32_inference():
    """The server's lone 2 s request (enhance at batch 1, what phase 6 holds
    the server to) and a CLI batch (--batch-size 8 of 2 s files) under
    PyTorch's default cuDNN TF32, kernel on, against the unfused chain with
    TF32 off, on phase 6's checkpoint."""
    from open_universe_tpu_torch.inference.model_loader import load_model

    with tempfile.TemporaryDirectory() as tmp:
        model = load_model(write_checkpoint(tmp), device=DEVICE)
    out = {}
    t = int(CLIP_S * FS)
    for tag, batch in (("served_request", 1), ("cli_batch", 8)):
        g = torch.Generator(device=DEVICE).manual_seed(21)
        mix = torch.randn(batch, t, generator=g, device=DEVICE) * 0.05
        noise = noise_draws(model, batch, t, seed=22)
        tf32_flags(True)
        try:
            on, _ = counted_enhance(model, mix, noise)
        finally:
            tf32_flags(False)
        diff = (on - unfused_enhance(model, mix, noise)).abs().max().item()
        out[tag] = diff
        log(f"[tf32] {tag} (batch {batch}): cuDNN TF32 on + kernel vs TF32 off + unfused: "
            f"max|d| = {diff:.3e} (the entry points' bound 1e-4 + 1/32767 = "
            f"{1e-4 + 1 / 32767:.3e}: {'holds' if diff <= 1e-4 + 1 / 32767 else 'BROKEN'})")
    return out


def write_pairs(root: str, n: int, seconds, seed: int = 0, split: str = "train") -> None:
    """n paired 16 kHz WAVs in the NoisyDataset layout
    (<root>/<split>/{noisy,clean}/*.wav): a clean harmonic tone in noise,
    each ``seconds`` long (one length, or one per pair)."""
    from open_universe_tpu_torch.data.audio import save_audio

    rng = np.random.default_rng(seed)
    for d in ("noisy", "clean"):
        os.makedirs(os.path.join(root, split, d), exist_ok=True)
    for i, sec in enumerate(np.broadcast_to(seconds, (n,))):
        t = np.arange(int(sec * FS)) / FS
        f0 = rng.uniform(100, 300)
        clean = 0.1 * np.sin(2 * np.pi * f0 * t) * (1 + 0.5 * np.sin(2 * np.pi * 3 * t))
        clean += 0.01 * rng.standard_normal(t.shape)
        noisy = clean + 0.05 * rng.standard_normal(t.shape)
        save_audio(os.path.join(root, split, "clean", f"p{i:03d}.wav"), clean[None], FS)
        save_audio(os.path.join(root, split, "noisy", f"p{i:03d}.wav"), noisy[None], FS)


def config_dir() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "config")


def phase_training():
    """8a: the training entry point at full width (universepp_vb_16k, batch
    40 x 2 s, f32, PyTorch's TF32 defaults) for TRAIN_STEPS steps on
    synthetic pairs; its checks; the losses of one step with cuDNN TF32 on
    against off.  Returns its numbers and the checkpoint it wrote."""
    import glob

    from open_universe_tpu_torch.nn.blocks import ConvBlock
    from open_universe_tpu_torch.ops.kernels import conv_block
    from open_universe_tpu_torch.train.__main__ import main as train_main

    tmp = tempfile.mkdtemp()
    data = os.path.join(tmp, "data")
    t0 = time.perf_counter()
    write_pairs(data, TRAIN_PAIRS, TRAIN_PAIR_S)
    log(f"[train] {TRAIN_PAIRS} pairs of {TRAIN_PAIR_S} s written in "
        f"{time.perf_counter() - t0:.1f} s")
    tf32_flags(True)
    try:
        trainer = train_main([
            "experiment=universepp_vb_16k", f"device={DEVICE}", "train=false",
            f"datamodule.datasets.vb-train-16k.audio_path={data}",
            f"datamodule.train.dl_opts.batch_size={TRAIN_BATCH}",
            f"trainer.max_steps={TRAIN_STEPS}", "trainer.val_check_interval=1000000",
            f"trainer.checkpoint_every={TRAIN_STEPS}", "trainer.log_every=1",
            f"path.exp_root={tmp}/exp", *TRAIN_OVERRIDES])
        model = trainer.model
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        conv_block.launches.clear()
        t0 = time.perf_counter()
        trainer.fit()
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = sum(conv_block.launches.values())
    finally:
        tf32_flags(False)
    (run_dir,) = glob.glob(os.path.join(tmp, "exp", "universepp_vb_16k", "*"))
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    n_params = {k: sum(p.numel() for p in getattr(model, k).parameters())
                for k in model.model_param_keys() + model.disc_param_keys()}
    for row in rows:
        log(f"[train] step {row['step']}: loss_gen {row['train/loss_gen']:.4f} "
            f"(score {row['train/score']:.4f}, mel {row['train/signal_mel']:.4f}) "
            f"loss_disc {row['train/loss_disc']:.4f}, {row['perf/step_time_s']:.3f} s, "
            f"peak {row.get('perf/peak_mem_gib', float('nan')):.2f} GiB")
    if len(rows) != TRAIN_STEPS or not all(
            np.isfinite(v) for row in rows for k, v in row.items() if k.startswith("train/")):
        raise AssertionError(f"training losses: {rows}")
    moved, still = {}, {}
    for key in model.model_param_keys() + model.disc_param_keys():
        ps = [(n, p) for n, p in model.named_parameters() if n.startswith(key + ".")]
        moved[key] = sum(not torch.equal(p.detach(), before[n]) for n, p in ps) / len(ps)
        still.update({n: (float(p.grad.abs().max()), float(p.detach().abs().min()))
                      for n, p in ps if torch.equal(p.detach(), before[n])})
    # AdamW moves an element by lr g / (|g| + 1e-8) a step: an element whose
    # float32 spacing exceeds the sum of the warmup's first learning rates
    # cannot move, nor, in a few steps, one whose gradient stays below
    # Adam's epsilon (a PReLU slope whose inputs are almost all positive)
    lr_sum = sum(trainer.step_fn.lr_gen(i) for i in range(TRAIN_STEPS))
    stuck = {n: v for n, v in still.items() if not n.startswith("signal_")}
    log(f"[train] share of tensors moved by group: {moved}; params {n_params}")
    log(f"[train] optimized tensors that did not move (last max|grad|, min|p|): {stuck}; "
        f"the generator's learning rates sum to {lr_sum:.3e}")
    if moved.get("signal_decoupling_layer", 0.0) != 0.0 or any(
            not moved[k] > 0.0 for k in model.optimized_param_keys() + model.disc_param_keys()
    ) or any(g >= 1e-8 and np.spacing(np.float32(p)) <= 2 * lr_sum
             for g, p in stuck.values()):
        raise AssertionError(f"the wrong parameters moved: {moved}, {stuck}")
    blocks = [m for m in model.modules() if isinstance(m, ConvBlock)]
    no_grad = [n for b in blocks for n, p in b.named_parameters()
               if p.grad is None or not p.grad.abs().max() > 0]
    log(f"[train] {len(blocks)} ConvBlocks, every parameter with a gradient: "
        f"{not no_grad}; fused-kernel launches during the steps: {launches}")
    if no_grad or launches:
        raise AssertionError(f"ConvBlock gradients missing {no_grad[:5]}, launches {launches}")
    times = [row["perf/step_time_s"] for row in rows]
    result = {"steps": TRAIN_STEPS, "batch": TRAIN_BATCH, "crop_s": 2.0,
              "first_step_s": times[0], "median_step_s": float(np.median(times[1:])),
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
              "fit_s": fit_s, "params": n_params, "launches": launches,
              "losses": {k: [row[k] for row in rows]
                         for k in ("train/loss_gen", "train/loss_disc")}}
    log(f"[train] {card_line()}: first step {times[0]:.3f} s, median after it "
        f"{result['median_step_s']:.3f} s, peak {result['peak_mem_gib']:.2f} GiB "
        f"(batch {TRAIN_BATCH} x 2 s, f32, cuDNN TF32 on)")
    result["tf32_losses"] = tf32_losses(model, trainer.dm)
    (ckpt,) = glob.glob(os.path.join(run_dir, "checkpoints", "*.ckpt"))
    del trainer, model, before
    torch.cuda.empty_cache()
    return result, ckpt


@torch.no_grad()
def tf32_losses(model, dm):
    """One step's losses (no update) on one training batch with fixed
    draws, cuDNN TF32 on against off: the largest relative difference."""
    batch = next(iter(dm.train_dataloader()))
    mix, target = (torch.from_numpy(batch[k]).to(DEVICE) for k in ("noisy", "clean"))
    (mix, target, orig), *_ = model.normalize_batch((mix, target, target))
    g = torch.Generator(device=DEVICE).manual_seed(31)
    u = torch.rand(mix.shape[0], generator=g, device=DEVICE)
    z = torch.randn(target.shape, generator=g, device=DEVICE)
    losses = []
    for on in (True, False):
        tf32_flags(on)
        out = model.generator_forward(mix, target, orig, u=u, z=z)
        l_disc, dm_ = model.discriminator_losses(out["y_est"], orig)
        _, gm = model.generator_losses(out, orig, True)
        losses.append({k: float(v) for k, v in {**dm_, **gm}.items()})
    tf32_flags(False)
    rel = {k: abs(losses[0][k] - v) / max(abs(v), 1e-12) for k, v in losses[1].items()}
    worst = max(rel, key=rel.get)
    log(f"[tf32] one step's losses at full width, cuDNN TF32 on vs off: worst relative "
        f"{rel[worst]:.3e} ({worst}); loss_gen {losses[0]['train/loss_gen']:.6f} vs "
        f"{losses[1]['train/loss_gen']:.6f}")
    return {"max_rel": rel[worst], "worst": worst, "on": losses[0], "off": losses[1]}


def phase_train_step_vs_cpu(extra=(), at_step=0, name="train-vs-cpu", grad_floor=0.0,
                            calls=1):
    """8b: one GAN step at a narrow width (NARROW_OVERRIDES, plus ``extra``;
    12b: ``calls`` calls with ``accumulate_grad_batches`` = calls, each on
    its own draws, the gradients compared being the accumulated mean the
    update applied;
    taken as step ``at_step``, which sets the aux loss's warm-up weight; 11e
    adds ``grad_floor`` of each group's largest gradient to every tensor's
    gradient bound, and counts elements below 100 times it as small) on the card and
    on the CPU from the same weights, batch and draws (sigma's uniform draws
    and the score's noise), TF32 off.  Bounds: losses relative <= 1e-5;
    every tensor's gradient <= 1e-2 of its largest, a one-element PReLU
    slope (one sum over the batch, which can cancel) <= 5e-2: the mel loss
    is an L1, whose gradient's sign flips where the two sides' mel values
    round apart, and that reaches the conditioner and the MRD; every
    parameter's change <= 1e-3 of its tensor's largest plus float32's
    spacing, save elements whose gradient is below 1e-2 of their tensor's
    largest or 1e-7, whose AdamW step is about +-lr whatever their gradient's
    size: those are counted and held to 1 % of the elements."""
    import copy

    from open_universe_tpu_torch.configs.registry import instantiate_trainable
    from open_universe_tpu_torch.configs.resolve import compose
    from open_universe_tpu_torch.nn.layers import init_weights
    from open_universe_tpu_torch.train.trainer import make_gan_step

    cfg = compose(config_dir(), ["experiment=universepp_vb_16k", *NARROW_OVERRIDES, *extra])
    base = init_weights(instantiate_trainable(cfg["model"]), seed=3)
    rng = np.random.default_rng(4)
    clean = (0.05 * rng.standard_normal((2, NARROW_T, 1))).astype(np.float32)
    batch = {"clean": clean,
             "noisy": clean + (0.02 * rng.standard_normal(clean.shape)).astype(np.float32)}
    draws = [{"u": rng.uniform(size=2).astype(np.float32),
              "z": rng.standard_normal(clean.shape).astype(np.float32)} for _ in range(calls)]
    runs = {}
    for tag, device, tf32 in (("cpu", "cpu", False), ("card", DEVICE, False),
                              ("card_tf32", DEVICE, True)):
        model = copy.deepcopy(base).to(device)
        step = make_gan_step(model, cfg["trainer"]["max_steps"])
        step.step = at_step
        tf32_flags(tf32)
        try:
            for d in draws:
                m = step({k: torch.from_numpy(v).to(device) for k, v in batch.items()},
                         draws={k: torch.from_numpy(v).to(device) for k, v in d.items()})
        finally:
            tf32_flags(False)
        if step.gen_updates != 1:
            raise AssertionError(f"{name}: {calls} calls made {step.gen_updates} updates")
        runs[tag] = ({k: float(v) for k, v in m.items()},
                     {n: (p.detach().cpu(), p.grad.cpu()) for n, p in model.named_parameters()})
    p0 = dict(base.named_parameters())
    (m_cpu, cpu), (m_card, card) = runs["cpu"], runs["card"]
    loss_rel = {k: abs(m_card[k] - v) / max(abs(v), 1e-12)
                for k, v in m_cpu.items() if k.startswith("train/")}
    grad_rel, delta_rel, small, failed = {}, {}, 0, []
    top = {}
    for n, (_, g_cpu) in cpu.items():
        top[n.split(".")[0]] = max(top.get(n.split(".")[0], 0.0), g_cpu.abs().max().item())
    for n, (p_cpu, g_cpu) in cpu.items():
        p_card, g_card = card[n]
        scale = g_cpu.abs().max().item()
        grad_rel[n] = (g_card - g_cpu).abs().max().item() / max(scale, 1e-30)
        floor = grad_floor * top[n.split(".")[0]] / max(scale, 1e-30)
        if not grad_rel[n] <= (5e-2 if g_cpu.numel() == 1 else 1e-2) + floor:
            failed.append(f"gradient of {n}: {grad_rel[n]:.3e}")
        d_cpu, d_card = p_cpu - p0[n].detach(), p_card - p0[n].detach()
        if not d_cpu.abs().max() > 0:
            continue
        bound = 1e-3 * d_cpu.abs().max() + 2 * torch.finfo(torch.float32).eps * (
            p0[n].detach().abs() + d_cpu.abs())
        bad = (d_card - d_cpu).abs() > bound
        tiny = ((g_cpu.abs() < 1e-2 * scale) | (g_cpu.abs() < 1e-7)
                | (g_cpu.abs() < 1e2 * grad_floor * top[n.split(".")[0]]))
        small += int((bad & tiny).sum())
        if (bad & ~tiny).any():
            failed.append(f"update of {n}")
        delta_rel[n] = ((d_card - d_cpu).abs() * ~tiny).max().item() / d_cpu.abs().max().item()
    tf32_rel = max(abs(runs["card_tf32"][0][k] - v) / max(abs(v), 1e-12)
                   for k, v in m_card.items() if k.startswith("train/"))
    n_el = sum(p.numel() for p in base.parameters())

    def summary(rel):
        by = {}
        for n, r in rel.items():
            by.setdefault(n.split(".")[0], []).append(r)
        return {g: {"max": max(v), "median": float(np.median(v)),
                    "over_1e-3": sum(r > 1e-3 for r in v), "n": len(v)} for g, v in by.items()}

    worst_g = sorted(grad_rel.items(), key=lambda kv: -kv[1])[:8]
    worst_d = sorted(delta_rel.items(), key=lambda kv: -kv[1])[:8]
    log(f"[{name}] narrow step ({NARROW_OVERRIDES}, batch 2 x {NARROW_T}), TF32 off: "
        f"losses max rel {max(loss_rel.values()):.3e} ({max(loss_rel, key=loss_rel.get)})")
    log(f"[{name}] gradients, max|d| / max|g_cpu| per tensor by group: "
        f"{summary(grad_rel)}; worst {worst_g}")
    log(f"[{name}] updates, per tensor (small-gradient elements aside, {small} "
        f"of {n_el} past 1e-3): {summary(delta_rel)}; worst {worst_d}")
    log(f"[{name}] card TF32 on vs off: losses max rel {tf32_rel:.3e}")
    if not max(loss_rel.values()) <= 1e-5 or small > 1e-2 * n_el or failed:
        raise AssertionError(f"card vs CPU step beyond its bounds: losses "
                             f"{max(loss_rel.values())}, small {small}, {failed[:8]}")
    return {"loss_rel": max(loss_rel.values()), "grad_rel": summary(grad_rel),
            "update_rel": summary(delta_rel), "small_gradient_elements": small,
            "elements": n_el, "tf32_loss_rel": tf32_rel}


def phase_trained_checkpoint(ckpt: str):
    """8c: load_model on the trainer's checkpoint (EMA applied, weight norm
    folded) and enhance on the card through the kernel against the unfused
    chain: <= 1e-4, 94 launches."""
    from open_universe_tpu_torch.inference.model_loader import load_model

    model = load_model(ckpt, device=DEVICE)
    t = int(CLIP_S * FS)
    g = torch.Generator(device=DEVICE).manual_seed(41)
    mix = torch.randn(2, t, generator=g, device=DEVICE) * 0.05
    noise = noise_draws(model, 2, t, seed=42)
    out, counts = counted_enhance(model, mix, noise)
    check_path("trained", counts, WIDTH_LENGTHS, F32, out, t)
    diff = (out - unfused_enhance(model, mix, noise)).abs().max().item()
    log(f"[trained] load_model({os.path.basename(ckpt)}) -> enhance on the card: "
        f"max|kernel - unfused| = {diff:.3e} (bound 1e-4)")
    if not diff <= 1e-4:
        raise AssertionError(f"trained checkpoint: kernel and unfused differ by {diff}")
    return {"launches": by_entry(counts), "max_abs_diff": diff}


def validation_launches(n_val: int) -> int:
    """Fused-kernel launches of one validation over n_val batch-1 clips: the
    conditioner and score network in each of N_BINS score losses per clip,
    and one enhance (PATH_LAUNCHES) on each of the first MAX_ENH."""
    return N_BINS * (COND_BLOCKS + SCORE_BLOCKS) * n_val + PATH_LAUNCHES * min(n_val, MAX_ENH)


def check_launches(tag, counts, want):
    """All of ``want`` launches on the f32 route, through the main entry."""
    n = sum(counts.values())
    log(f"[{tag}] {n} launches {by_entry(counts)} {by_route(counts)} (expected {want})")
    if n != want or set(by_route(counts)) != {F32} or set(by_entry(counts)) != {ENTRY}:
        raise AssertionError(f"{tag}: launched {by_entry(counts)} {by_route(counts)}, "
                             f"expected {want} on {F32} through {ENTRY}")


class EstRecorder:
    """An enh_losses entry that keeps the enhanced batches it is given and
    scores them with the metric it wraps."""

    def __init__(self, inner):
        self.inner, self.est = inner, []

    def __call__(self, est, ref):
        self.est.append(est.detach().clone())
        return self.inner(est, ref)


def _tensors(obj):
    """The tensors of a nested state, in order, with their paths."""
    if isinstance(obj, torch.Tensor):
        yield "", obj
    elif isinstance(obj, dict):
        for k in obj:
            for p, t in _tensors(obj[k]):
                yield f"/{k}{p}", t
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            for p, t in _tensors(v):
                yield f"/{i}{p}", t


def same_state(a, b) -> list:
    """Paths where two nested states differ (tensors bit for bit, the rest
    by ==)."""
    ta, tb = dict(_tensors(a)), dict(_tensors(b))
    bad = sorted(set(ta) ^ set(tb))
    bad += [p for p in ta if p in tb and not (ta[p].shape == tb[p].shape and torch.equal(
        ta[p].cpu(), tb[p].cpu()))]
    return bad


def trainer_state(tr) -> dict:
    """What a checkpoint holds of a trainer, as ``Trainer.save`` lays it out."""
    from open_universe_tpu_torch.inference.model_loader import ordered_param_names

    from open_universe_tpu_torch.train.trainer import optimizers

    step = tr.step_fn
    sd = tr.model.state_dict()
    names = ordered_param_names(sd, tr.model.model_param_keys())
    opts = optimizers(step)
    return {"state_dict": sd, "global_step": step.step,
            "optimizer_states": [o.state_dict() for o, _, _ in opts],
            "updates": [getattr(step, count) for _, count, _ in opts],
            "grad_accumulators": [acc.state_dict() for _, _, acc in opts],
            "ema": [tr.ema.shadow[n] for n in names], "num_updates": tr.ema.num_updates}


def phase_validation():
    """9: the training entry point at full width (universepp_vb_16k, f32,
    batch 40 x 2 s, PyTorch's TF32 defaults) for VAL_STEPS steps, validating
    and writing a checkpoint every VAL_EVERY, then test=true; then resumed
    from the step-2 checkpoint to step 4.  Checks the val/* rows, index,
    best, last and test_summary.json, the launches of each validation
    (validation_launches, all f32, the main entry) and of the test, the
    restored state against the checkpoint, and one validation through the
    kernel against the same with the kernels off (TF32 off): score bins <=
    1e-4 relative, each enhanced clip <= 1e-4 of its max|ref|."""
    import glob
    import shutil

    from open_universe_tpu_torch.ops import kernels
    from open_universe_tpu_torch.ops.kernels import conv_block
    from open_universe_tpu_torch.train import trainer as ptrainer
    from open_universe_tpu_torch.train.__main__ import main as train_main

    tmp = tempfile.mkdtemp()
    data, exp = os.path.join(tmp, "data"), os.path.join(tmp, "exp")
    t0 = time.perf_counter()
    write_pairs(data, VAL_TRAIN_PAIRS, TRAIN_PAIR_S, seed=5)
    write_pairs(data, VAL_PAIRS, np.linspace(1.3, 6.1, VAL_PAIRS), seed=6, split="val")
    write_pairs(data, TEST_PAIRS, np.linspace(1.1, 4.6, TEST_PAIRS), seed=7, split="test")
    log(f"[val] {VAL_TRAIN_PAIRS} train pairs of {TRAIN_PAIR_S} s, {VAL_PAIRS} val pairs of "
        f"1.3-6.1 s, {TEST_PAIRS} test pairs written in {time.perf_counter() - t0:.1f} s")
    args = ["experiment=universepp_vb_16k", f"device={DEVICE}",
            f"datamodule.datasets.vb-train-16k.audio_path={data}",
            f"datamodule.train.dl_opts.batch_size={TRAIN_BATCH}",
            f"trainer.val_check_interval={VAL_EVERY}", f"trainer.checkpoint_every={VAL_EVERY}",
            "trainer.log_every=1", *TRAIN_OVERRIDES]

    # count each validation's and the test's launches and keep their times
    calls, real_validate, real_test = [], ptrainer.Trainer.validate, ptrainer.Trainer.test

    def counted(real, kind):
        def run(self, step=None, draws=None):
            conv_block.launches.clear()
            t0 = time.perf_counter()
            out = real(self, step, draws)
            torch.cuda.synchronize()
            calls.append({"kind": kind, "step": step, "launches": dict(conv_block.launches),
                          "wall_s": time.perf_counter() - t0,
                          "timing": dict(self.val_timing) if kind == "validate" else {}})
            return out
        return run

    ptrainer.Trainer.validate = counted(real_validate, "validate")
    ptrainer.Trainer.test = counted(real_test, "test")
    tf32_flags(True)
    try:
        t0 = time.perf_counter()
        trainer = train_main(args + [f"trainer.max_steps={VAL_STEPS}", "test=true",
                                     f"path.exp_root={exp}/first"])
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
    finally:
        tf32_flags(False)
        ptrainer.Trainer.validate, ptrainer.Trainer.test = real_validate, real_test
    (run_dir,) = glob.glob(os.path.join(exp, "first", "universepp_vb_16k", "*"))
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    val_rows = [r for r in rows if "val/score" in r]
    for r in val_rows:
        log(f"[val] step {r['step']}: " + ", ".join(f"{k} {r[k]:.4f}" for k in VAL_KEYS)
            + f"; wall {r['perf/val_wall_s']:.2f} s: model passes {r['perf/val_model_s']:.2f}"
            f" s (enhance {r['perf/val_enhance_s']:.2f} s), host metrics (PESQ, LSD's "
            f"copy) {r['perf/val_metrics_s']:.2f} s")
    if [r["step"] for r in val_rows] != list(range(VAL_EVERY, VAL_STEPS + 1, VAL_EVERY)) or any(
            not np.isfinite(r[k]) for r in val_rows for k in VAL_KEYS):
        raise AssertionError(f"validation rows: {val_rows}")
    ckpt_dir = os.path.join(run_dir, "checkpoints")
    meta = {}
    for name in ("index.json", "best.json", "last.json"):
        with open(os.path.join(ckpt_dir, name)) as f:
            meta[name] = json.load(f)
    with open(os.path.join(run_dir, "test_summary.json")) as f:
        summary = json.load(f)
    scored = {r["step"]: r["val/pesq"] for r in val_rows}
    log(f"[val] index {[(e['step'], e['metric'], e['value']) for e in meta['index.json']]}; "
        f"best step {meta['best.json']['step']}; last step {meta['last.json']['step']}; "
        f"test summary {summary}")
    if ([(e["step"], e["value"]) for e in meta["index.json"]] != sorted(scored.items())
            or meta["best.json"]["value"] != max(scored.values())
            or meta["last.json"]["step"] != VAL_STEPS or summary.get("number") != TEST_PAIRS
            or not all(np.isfinite(summary[k]) for k in ("pesq", "lsd"))):
        raise AssertionError(f"checkpoint metadata or test summary: {meta}, {summary}")
    want = validation_launches(VAL_PAIRS)
    for c in calls:
        check_launches(f"val {c['kind']} @{c['step']}", c["launches"],
                       want if c["kind"] == "validate" else PATH_LAUNCHES * TEST_PAIRS)
    if [c["kind"] for c in calls] != ["validate"] * (VAL_STEPS // VAL_EVERY) + ["test"]:
        raise AssertionError(f"validations and tests run: {[c['kind'] for c in calls]}")

    # one validation through the kernel against the same with the kernels
    # off: the same folded EMA copy (made anew per call from the same EMA)
    # and the same generator state (seeded per call), TF32 off
    recorder = EstRecorder(trainer.enh_losses["val/"])
    trainer.enh_losses = {"val/": recorder}
    kern = trainer.validate(VAL_STEPS)
    kernels.enable(False)
    try:
        plain = trainer.validate(VAL_STEPS)
    finally:
        kernels.enable(True)
    n_enh = len(recorder.est) // 2
    wave = max((a - b).abs().max().item() / b.abs().max().item()
               for a, b in zip(recorder.est[:n_enh], recorder.est[n_enh:]))
    score_rel = max(abs(kern[k] - plain[k]) / abs(plain[k]) for k in VAL_KEYS[:6])
    log("[val] kernel vs kernels off, one validation (TF32 off):")
    for k in VAL_KEYS:
        log(f"[val]   {k:22s} kernel {kern[k]:.6f}  off {plain[k]:.6f}  "
            f"|d| {abs(kern[k] - plain[k]):.3e}")
    log(f"[val] score bins max relative difference {score_rel:.3e} (bound 1e-4); enhanced "
        f"clips max|d| / max|ref| {wave:.3e} (bound 1e-4) over {n_enh} clips")
    if not (score_rel <= 1e-4 and wave <= 1e-4 and n_enh == min(VAL_PAIRS, MAX_ENH)):
        raise AssertionError(f"validation through the kernel and with it off differ: "
                             f"scores {score_rel}, waveforms {wave}")
    # where a validation's time goes: one traced (TF32 off) on its longest
    # clip (the trace of all 12 holds ~375k device kernels, whose reading
    # takes minutes)
    trainer.dm.datasets["val"].file_list = trainer.dm.datasets["val"].file_list[-1:]
    profiled = device_profile("[val] profile, one 6.1 s clip",
                              lambda: trainer.validate(VAL_STEPS))
    del trainer
    torch.cuda.empty_cache()

    # resume from step 2: the restored state is the checkpoint's, bit for bit
    ckpt2 = os.path.join(ckpt_dir, f"step_{VAL_EVERY:08d}.ckpt")
    tf32_flags(True)
    try:
        t0 = time.perf_counter()
        resumed = train_main(args + [f"trainer.max_steps={VAL_STEPS}", f"ckpt_path={ckpt2}",
                                     "train=false", f"path.exp_root={exp}/resumed"])
        saved = torch.load(ckpt2, map_location=DEVICE, weights_only=False)
        restored = trainer_state(resumed)
        bad = same_state(restored, {
            "state_dict": saved["state_dict"], "global_step": saved["global_step"],
            "optimizer_states": saved["optimizer_states"],
            "updates": [s["updates"] for s in saved["lr_schedulers"]],
            "ema": saved["ema"]["shadow_params"], "num_updates": saved["ema"]["num_updates"]})
        bad += [k for k in ("global_step", "num_updates")
                if restored[k] != (saved[k] if k == "global_step" else saved["ema"][k])]
        bad += [] if restored["updates"] == [s["updates"] for s in saved["lr_schedulers"]] \
            else ["updates"]
        del saved
        resumed.fit()
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
    finally:
        tf32_flags(False)
    (run2,) = glob.glob(os.path.join(exp, "resumed", "universepp_vb_16k", "*"))
    with open(os.path.join(run2, "metrics.jsonl")) as f:
        rows2 = [json.loads(line) for line in f]
    steps2 = [r["step"] for r in rows2 if "train/loss_gen" in r]
    vals2 = [r["step"] for r in rows2 if "val/score" in r]
    log(f"[val] resumed from {os.path.basename(ckpt2)}: restored state differs at {bad[:5]} "
        f"({len(bad)} paths); then steps {steps2}, validations at {vals2}, "
        f"step {resumed.step_fn.step}")
    if bad or steps2 != list(range(VAL_EVERY + 1, VAL_STEPS + 1)) or vals2 != [VAL_STEPS] \
            or not os.path.exists(os.path.join(run2, "checkpoints", f"step_{VAL_STEPS:08d}.ckpt")):
        raise AssertionError(f"resume: differs at {bad[:8]}, steps {steps2}, validations {vals2}")
    del resumed
    torch.cuda.empty_cache()
    shutil.rmtree(tmp, ignore_errors=True)

    vals = [c for c in calls if c["kind"] == "validate"]
    timing = {k: float(np.median([c["timing"][k] for c in vals])) for k in vals[0]["timing"]}
    log(f"[val] {card_line()}: a validation of {VAL_PAIRS} clips takes "
        f"{timing['perf/val_wall_s']:.2f} s (median of {len(vals)}): model passes "
        f"{timing['perf/val_model_s']:.2f} s (enhance {timing['perf/val_enhance_s']:.2f} s), "
        f"host metrics {timing['perf/val_metrics_s']:.2f} s; "
        f"the test of {TEST_PAIRS} clips {calls[-1]['wall_s']:.2f} s; the first run "
        f"{first_s:.1f} s, the resumed one {resume_s:.1f} s")
    return {"val_pairs": VAL_PAIRS, "test_pairs": TEST_PAIRS,
            "validation_launches": [by_entry(c["launches"]) for c in vals],
            "test_launches": by_entry(calls[-1]["launches"]),
            "expected_validation_launches": want, "timing": timing,
            "validation_wall_s": [c["wall_s"] for c in vals], "test_wall_s": calls[-1]["wall_s"],
            "kernel_vs_off": {"score_rel": score_rel, "wave_rel": wave,
                              "kernel": kern, "off": plain},
            "val_rows": val_rows, "test_summary": summary, "first_run_s": first_s,
            "resume_s": resume_s, "profile": profiled}


# ---------------------------------------------------------------- phase 10
def block_counts(model) -> tuple:
    """(score network, conditioner) ConvBlocks of a model."""
    from open_universe_tpu_torch.nn.blocks import ConvBlock

    return tuple(sum(isinstance(m, ConvBlock) for m in getattr(model, k).modules())
                 for k in ("score_model", "condition_model"))


def phase_original_training():
    """10a and 10c: the training entry point at full width
    (universe_original_vb_16k, batch 40 x 2 s, f32, PyTorch's TF32 defaults)
    for ORIG_STEPS steps on synthetic pairs, a checkpoint at the middle step
    and the last, a validation at the last, then the test.  Checks the
    losses (finite), the launches of the steps (0) and of the validation
    and test (by the formula, counted from the model's ConvBlocks, the main
    entry), one validation through the kernel against the same with the
    kernels off (TF32 off), and the state a run resumed from the middle
    checkpoint restores.  Returns its numbers and the last checkpoint."""
    import glob

    from open_universe_tpu_torch.ops import kernels
    from open_universe_tpu_torch.ops.kernels import conv_block
    from open_universe_tpu_torch.train.__main__ import main as train_main

    tmp = tempfile.mkdtemp()
    data, exp = os.path.join(tmp, "data"), os.path.join(tmp, "exp")
    t0 = time.perf_counter()
    write_pairs(data, TRAIN_PAIRS, TRAIN_PAIR_S, seed=8)
    write_pairs(data, ORIG_VAL_PAIRS, np.linspace(1.3, 3.1, ORIG_VAL_PAIRS), seed=9,
                split="val")
    write_pairs(data, ORIG_TEST_PAIRS, np.linspace(1.5, 2.5, ORIG_TEST_PAIRS), seed=10,
                split="test")
    log(f"[orig] {TRAIN_PAIRS} train pairs, {ORIG_VAL_PAIRS} val and {ORIG_TEST_PAIRS} test "
        f"pairs written in {time.perf_counter() - t0:.1f} s")
    half = ORIG_STEPS // 2
    args = [f"experiment={ORIG}", f"device={DEVICE}",
            f"datamodule.datasets.vb-train-16k.audio_path={data}",
            f"datamodule.train.dl_opts.batch_size={TRAIN_BATCH}",
            f"trainer.max_steps={ORIG_STEPS}", f"trainer.val_check_interval={ORIG_STEPS}",
            f"trainer.checkpoint_every={half}", "trainer.log_every=1", *ORIG_OVERRIDES]
    tf32_flags(True)
    try:
        with CountedEval() as counted:
            trainer = train_main(args + ["train=false", f"path.exp_root={exp}/first"])
            model = trainer.model
            conv_block.launches.clear()
            t0 = time.perf_counter()
            trainer.fit()
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 2**30
            trainer.test()
    finally:
        tf32_flags(False)
    calls, steps_launched = counted.calls, [counted.steps]
    (run_dir,) = glob.glob(os.path.join(exp, "first", ORIG, "*"))
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    train_rows = [r for r in rows if "train/loss" in r]
    for r in train_rows:
        log(f"[orig] step {r['step']}: loss {r['train/loss']:.4f} (score "
            f"{r['train/score']:.4f}, signal {r['train/signal']:.4f}, latent "
            f"{r['train/latent']:.4f}), grad norm {r['grad/norm']:.3f}, "
            f"{r['perf/step_time_s']:.3f} s, peak {r.get('perf/peak_mem_gib', float('nan')):.2f} GiB")
    losses = ("train/score", "train/signal", "train/latent")
    if len(train_rows) != ORIG_STEPS or not all(
            np.isfinite(r[k]) for r in train_rows for k in losses + ("train/loss",)):
        raise AssertionError(f"plain UNIVERSE training losses: {train_rows}")
    n_params = {k: sum(p.numel() for p in getattr(model, k).parameters())
                for k in model.model_param_keys() + model.loss_param_keys()}
    s_blocks, c_blocks = block_counts(model)
    n_steps = model.diff_kwargs["n_steps"]
    per_enhance = s_blocks * n_steps + c_blocks
    want_val = (N_BINS * (s_blocks + c_blocks) * ORIG_VAL_PAIRS
                + per_enhance * min(ORIG_VAL_PAIRS, MAX_ENH))
    log(f"[orig] {s_blocks} + {c_blocks} ConvBlocks (score network + conditioner); "
        f"fused-kernel launches during the {ORIG_STEPS} steps: {steps_launched[0]}")
    if steps_launched[0] or (s_blocks, c_blocks) != (SCORE_BLOCKS, COND_BLOCKS) or \
            want_val != validation_launches(ORIG_VAL_PAIRS) or per_enhance != PATH_LAUNCHES:
        raise AssertionError(f"steps launched {steps_launched[0]}; blocks {s_blocks}, {c_blocks}")
    if [c["kind"] for c in calls] != ["validate", "test"]:
        raise AssertionError(f"validations and tests run: {[c['kind'] for c in calls]}")
    check_launches("orig validate", calls[0]["launches"], want_val)
    check_launches("orig test", calls[1]["launches"], per_enhance * ORIG_TEST_PAIRS)
    val = [r for r in rows if "val/score" in r]
    with open(os.path.join(run_dir, "test_summary.json")) as f:
        summary = json.load(f)
    log(f"[orig] validation @{val[0]['step']}: "
        + ", ".join(f"{k} {val[0][k]:.4f}" for k in VAL_KEYS) + f"; test summary {summary}")
    if not all(np.isfinite(val[0][k]) for k in VAL_KEYS) or summary.get("number") != \
            ORIG_TEST_PAIRS:
        raise AssertionError(f"validation {val}, test {summary}")

    times = [r["perf/step_time_s"] for r in train_rows]
    result = {"steps": ORIG_STEPS, "batch": TRAIN_BATCH, "crop_s": 2.0,
              "first_step_s": times[0], "median_step_s": float(np.median(times[1:])),
              "peak_mem_gib": peak, "fit_s": fit_s, "params": n_params,
              "step_launches": steps_launched[0],
              "losses": {k: [r[k] for r in train_rows] for k in losses + ("train/loss",)},
              "validation_launches": by_entry(calls[0]["launches"]),
              "expected_validation_launches": want_val,
              "test_launches": by_entry(calls[1]["launches"]),
              "validation_timing": calls[0]["timing"], "test_summary": summary}
    log(f"[orig] {card_line()}: first step {times[0]:.3f} s, median after it "
        f"{result['median_step_s']:.3f} s, peak {peak:.2f} GiB (batch {TRAIN_BATCH} x 2 s, "
        f"f32, cuDNN TF32 on); params {n_params}")

    # one validation through the kernel against the same with the kernels off
    recorder = EstRecorder(trainer.enh_losses["val/"])
    trainer.enh_losses = {"val/": recorder}
    kern = trainer.validate(ORIG_STEPS)
    kernels.enable(False)
    try:
        plain = trainer.validate(ORIG_STEPS)
    finally:
        kernels.enable(True)
    n_enh = len(recorder.est) // 2
    wave = max((a - b).abs().max().item() / b.abs().max().item()
               for a, b in zip(recorder.est[:n_enh], recorder.est[n_enh:]))
    score_rel = max(abs(kern[k] - plain[k]) / abs(plain[k]) for k in VAL_KEYS[:6])
    log(f"[orig] validation, kernel vs kernels off (TF32 off): score bins max relative "
        f"difference {score_rel:.3e} (bound 1e-4); enhanced clips max|d| / max|ref| "
        f"{wave:.3e} (bound 1e-4) over {n_enh} clips")
    if not (score_rel <= 1e-4 and wave <= 1e-4 and n_enh == min(ORIG_VAL_PAIRS, MAX_ENH)):
        raise AssertionError(f"plain UNIVERSE validation through the kernel and with it off "
                             f"differ: scores {score_rel}, waveforms {wave}")
    result["kernel_vs_off"] = {"score_rel": score_rel, "wave_rel": wave}
    del trainer, model
    torch.cuda.empty_cache()

    # resume from the middle checkpoint: the restored state is its own
    ckpt_dir = os.path.join(run_dir, "checkpoints")
    ckpt_mid = os.path.join(ckpt_dir, f"step_{half:08d}.ckpt")
    resumed = train_main(args + [f"ckpt_path={ckpt_mid}", "train=false",
                                 f"path.exp_root={exp}/resumed"])
    saved = torch.load(ckpt_mid, map_location=DEVICE, weights_only=False)
    restored = trainer_state(resumed)
    bad = same_state(restored, {
        "state_dict": saved["state_dict"], "global_step": saved["global_step"],
        "optimizer_states": saved["optimizer_states"],
        "updates": [s["updates"] for s in saved["lr_schedulers"]],
        "ema": saved["ema"]["shadow_params"], "num_updates": saved["ema"]["num_updates"]})
    bad += [] if (restored["global_step"], restored["num_updates"], restored["updates"]) == (
        half, half, [half]) else ["counts"]
    loss_keys = [k for k in saved["state_dict"] if k.startswith("loss_")]
    log(f"[orig] resumed from {os.path.basename(ckpt_mid)}: {len(loss_keys)} MDN loss "
        f"tensors in it; restored state differs at {bad[:5]} ({len(bad)} paths)")
    if bad or not loss_keys:
        raise AssertionError(f"plain UNIVERSE resume differs at {bad[:8]}")
    del resumed, saved
    torch.cuda.empty_cache()
    (ckpt,) = [c for c in glob.glob(os.path.join(ckpt_dir, "*.ckpt"))
               if c.endswith(f"step_{ORIG_STEPS:08d}.ckpt")]
    return result, ckpt


def phase_original_step_vs_cpu():
    """10b: one score-only step at a narrow width (NARROW_ORIG_OVERRIDES) on
    the card and on the CPU from the same weights, batch and draws, TF32
    off.  Bounds: losses relative <= 1e-5; every tensor's gradient <= 1e-3
    of its largest (a one-element PReLU slope, one sum over the batch, 1e-2);
    every parameter's change as in 8b."""
    import copy

    from open_universe_tpu_torch.configs.registry import instantiate_trainable
    from open_universe_tpu_torch.configs.resolve import compose
    from open_universe_tpu_torch.nn.layers import init_weights
    from open_universe_tpu_torch.train.trainer import make_step

    cfg = compose(config_dir(), [f"experiment={ORIG}", *NARROW_ORIG_OVERRIDES])
    base = init_weights(instantiate_trainable(cfg["model"]), seed=3)
    rng = np.random.default_rng(5)
    clean = (0.05 * rng.standard_normal((2, NARROW_T, 1))).astype(np.float32)
    batch = {"clean": clean,
             "noisy": clean + (0.02 * rng.standard_normal(clean.shape)).astype(np.float32)}
    draws = {"u": rng.uniform(size=2).astype(np.float32),
             "z": rng.standard_normal(clean.shape).astype(np.float32)}
    runs = {}
    for tag, device in (("cpu", "cpu"), ("card", DEVICE)):
        model = copy.deepcopy(base).to(device)
        step = make_step(model, cfg["trainer"]["max_steps"])
        m = step({k: torch.from_numpy(v).to(device) for k, v in batch.items()},
                 draws={k: torch.from_numpy(v).to(device) for k, v in draws.items()})
        runs[tag] = ({k: float(v) for k, v in m.items()},
                     {n: (p.detach().cpu(), p.grad.cpu()) for n, p in model.named_parameters()})
    p0 = dict(base.named_parameters())
    (m_cpu, cpu), (m_card, card) = runs["cpu"], runs["card"]
    loss_rel = {k: abs(m_card[k] - v) / max(abs(v), 1e-12)
                for k, v in m_cpu.items() if k.startswith(("train/", "grad/"))}
    grad_rel, delta_rel, small, failed = {}, {}, 0, []
    for n, (p_cpu, g_cpu) in cpu.items():
        p_card, g_card = card[n]
        scale = g_cpu.abs().max().item()
        grad_rel[n] = (g_card - g_cpu).abs().max().item() / max(scale, 1e-30)
        if not grad_rel[n] <= (1e-2 if g_cpu.numel() == 1 else 1e-3):
            failed.append(f"gradient of {n}: {grad_rel[n]:.3e}")
        d_cpu, d_card = p_cpu - p0[n].detach(), p_card - p0[n].detach()
        if not d_cpu.abs().max() > 0:
            continue
        bound = 1e-3 * d_cpu.abs().max() + 2 * torch.finfo(torch.float32).eps * (
            p0[n].detach().abs() + d_cpu.abs())
        bad = (d_card - d_cpu).abs() > bound
        tiny = (g_cpu.abs() < 1e-2 * scale) | (g_cpu.abs() < 1e-7)
        small += int((bad & tiny).sum())
        if (bad & ~tiny).any():
            failed.append(f"update of {n}")
        delta_rel[n] = ((d_card - d_cpu).abs() * ~tiny).max().item() / d_cpu.abs().max().item()
    n_el = sum(p.numel() for p in base.parameters())
    by = {}
    for n, r in grad_rel.items():
        by.setdefault(n.split(".")[0], []).append(r)
    summary = {g: {"max": max(v), "median": float(np.median(v)), "n": len(v)}
               for g, v in by.items()}
    log(f"[orig-vs-cpu] narrow step ({NARROW_ORIG_OVERRIDES}, batch 2 x {NARROW_T}), TF32 "
        f"off: losses and norms max rel {max(loss_rel.values()):.3e} "
        f"({max(loss_rel, key=loss_rel.get)}); gradients max|d| / max|g_cpu| per tensor by "
        f"group {summary}; updates (small-gradient elements aside, {small} of {n_el} past "
        f"1e-3) worst {max(delta_rel.values()):.3e}")
    if not max(loss_rel.values()) <= 1e-5 or small > 1e-2 * n_el or failed:
        raise AssertionError(f"plain UNIVERSE card vs CPU step beyond its bounds: losses "
                             f"{loss_rel}, small {small}, {failed[:8]}")
    return {"loss_rel": max(loss_rel.values()), "grad_rel": summary,
            "update_rel_max": max(delta_rel.values()), "small_gradient_elements": small,
            "elements": n_el}


def phase_original_checkpoint(ckpt: str):
    """10d: load_model on the trained checkpoint (EMA applied); enhance of
    2 x 2 s through the kernel against the unfused chain, f32 (<= 1e-4 of
    max|ref|) and bf16, 94 launches each; then audio-s/s at batch 128 x 2 s,
    bf16 and f32, kernel and unfused (median of 3)."""
    from open_universe_tpu_torch.inference.model_loader import load_model

    model = load_model(ckpt, device=DEVICE)
    t = int(CLIP_S * FS)
    g = torch.Generator(device=DEVICE).manual_seed(51)
    mix = torch.randn(2, t, generator=g, device=DEVICE) * 0.05
    noise = noise_draws(model, 2, t, seed=52)
    out = {"type": type(model).__name__, "loss_modules": list(model.loss_param_keys())}
    for tag, dtype, route in (("f32", None, F32), ("bf16", torch.bfloat16, BF16)):
        o, counts = counted_enhance(model, mix, noise, dtype)
        check_path(f"orig {tag}", counts, WIDTH_LENGTHS, route, o, t)
        ref = unfused_enhance(model, mix, noise, dtype)
        rel = (o - ref).abs().max().item() / ref.abs().max().item()
        out[tag] = {"launches": by_entry(counts), "max_rel_diff": rel}
        log(f"[orig {tag}] trained {os.path.basename(ckpt)} via load_model ({out['type']}, "
            f"no loss modules: {not out['loss_modules']}): max|kernel - unfused| / max|ref| = "
            f"{rel:.3e}" + (" (bound 1e-4)" if dtype is None else " (no bound: bf16)"))
        if out["loss_modules"] or (dtype is None and not rel <= 1e-4):
            raise AssertionError(f"trained plain UNIVERSE {tag}: kernel vs unfused {rel}")
    mix = torch.randn(TIMING_BATCH, t, generator=g, device=DEVICE) * 0.05
    noise = noise_draws(model, TIMING_BATCH, t, seed=53)
    rates = {}
    for tag, dtype in (("bf16", torch.bfloat16), ("f32", None)):
        for fused in (True, False):
            s = timed_enhance(model, mix, noise, fused, dtype, runs=3)
            rates[f"{tag}_{'kernel' if fused else 'unfused'}"] = TIMING_BATCH * CLIP_S / s
    log(f"[orig] {card_line()}: trained plain UNIVERSE enhance at batch {TIMING_BATCH} x 2 s, "
        f"8 steps (the generic score path), audio-s/s: "
        + ", ".join(f"{k} {v:.1f}" for k, v in rates.items()))
    out["audio_s_per_s"] = rates
    del model, mix, noise
    torch.cuda.empty_cache()
    return out


# 10e: narrow models whose networks run on a CompressedMagSTFT (n_fft 6,
# hop 8: 8 channels, the conditioner's mel hop lines up with the frames)
STFT_NODE = {"_target_": "open_universe.layers.dyn_range_comp.CompressedMagSTFT",
             "stft_kwargs": {"n_fft": 6, "hop_length": 8, "window_name": "hann"},
             "spec_kwargs": {"transform_type": "exponent", "abs_exponent": 0.5,
                             "factor": 0.3}}


def stft_model_config(where: str) -> dict:
    """A narrow plain UNIVERSE with the transform as the model's
    ``transform`` or as both networks' ``precoding``."""
    net = {"rate_factors": [2, 2], "n_channels": 16, "use_weight_norm": False}
    pre = {"precoding": STFT_NODE} if where == "precoding" else {}
    cfg = {"_target_": "open_universe.networks.universe.Universe", "fs": FS,
           "normalization_norm": 2, "normalization_kwargs": {"ref": "both", "level_db": -26.0},
           "score_model": {"_target_": "open_universe.networks.universe.ScoreNetwork", **net,
                           "noise_cond_dim": 64, "input_channels": 8, "output_channels": 8,
                           **pre},
           "condition_model": {"_target_": "open_universe.networks.universe.ConditionerNetwork",
                               **net, "n_mels": 20, "input_channels": 8,
                               **({"output_channels": 8} if pre else {}), **pre}}
    if where == "transform":
        cfg["transform"] = STFT_NODE
    return cfg


def phase_transform_vs_cpu():
    """10e: enhance (2 x 2 s, 8 steps, f32, TF32 off) of a narrow model with
    a CompressedMagSTFT transform and of one with it as both networks'
    precoding, on the card (cuFFT's rfft and irfft, the overlap-add istft)
    against the CPU on the same weights and draws: <= 1e-4 of max|ref|."""
    import copy

    from open_universe_tpu_torch.configs.registry import instantiate
    from open_universe_tpu_torch.nn.layers import init_weights

    t = int(CLIP_S * FS)
    rng = np.random.default_rng(61)
    mix = torch.from_numpy((0.05 * rng.standard_normal((2, t))).astype(np.float32))
    out = {}
    for where in ("transform", "precoding"):
        base = init_weights(instantiate(stft_model_config(where)), seed=4).eval()
        padded = t + base.tot_ds - t % base.tot_ds
        shape = ((2, padded // 8 + 1, 8) if where == "transform" else (2, padded, 1))
        noise = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                 for _ in range(N_STEPS)]
        ref = base.enhance(mix, n_steps=N_STEPS, noise=noise)
        card = copy.deepcopy(base).to(DEVICE)
        got = card.enhance(mix.to(DEVICE), n_steps=N_STEPS,
                           noise=[z.to(DEVICE) for z in noise]).cpu()
        rel = (got - ref).abs().max().item() / ref.abs().max().item()
        out[where] = rel
        log(f"[stft] narrow plain UNIVERSE with a CompressedMagSTFT {where}: enhance on the "
            f"card vs the CPU, max|d| / max|ref| = {rel:.3e} (bound 1e-4); output "
            f"{tuple(got.shape)}")
        if got.shape != (2, t) or not torch.isfinite(got).all() or not rel <= 1e-4:
            raise AssertionError(f"CompressedMagSTFT {where}: card vs CPU {rel}")
    return out


# phase 11: LoRA fine-tuning of phase 8's full-width checkpoint through the
# entry point at the experiment's batch (4 x 2 s crops) on LORA_PAIRS pairs,
# a validation at the last step on LORA_VAL_PAIRS clips of 1.3-2.5 s (batch
# 1), a checkpoint every LORA_CKPT_EVERY steps, a test of LORA_TEST_PAIRS
LORA = "universepp_lora_finetune"
LORA_STEPS, LORA_CKPT_EVERY = 6, 3
LORA_PAIRS, LORA_VAL_PAIRS, LORA_TEST_PAIRS = 16, 3, 2
LORA_OVERRIDES = []  # full width
# 11e: UNIVERSE++ with a multi-resolution aux loss whose warm-up (weights 0,
# 0.5, 1) the AUX_STEPS steps cross, at batch AUX_BATCH
AUX_OVERRIDES = ["+model.losses.aux_loss._target_=open_universe_tpu.losses.MultiResL1SpecLoss",
                 "+model.losses.aux_loss.window_sz=[256,1024,2048]",
                 "+model.losses.aux_loss_schedule.start_step=0",
                 "+model.losses.aux_loss_schedule.warmup_steps=2"]
AUX_STEPS, AUX_BATCH = 3, 8
LORA_LOSSES = ("train/main_loss", "train/multires_l1", "train/mpd", "train/mrd",
               "train/mpd_fm", "train/mrd_fm")


class CountedEval:
    """Trainer.validate and Trainer.test wrapped to record, per call, the
    fused-kernel launches it made (counted from 0) and its timing; launches
    made outside them (the steps) add up in ``steps``, counted from 0 at
    entry."""

    def __init__(self):
        from open_universe_tpu_torch.ops.kernels import conv_block
        from open_universe_tpu_torch.train import trainer as ptrainer

        self.conv_block, self.cls = conv_block, ptrainer.Trainer
        self.calls, self.steps = [], 0

    def _wrap(self, real, kind):
        def run(trainer, step=None, draws=None):
            self.steps += sum(self.conv_block.launches.values())
            self.conv_block.launches.clear()
            out = real(trainer, step, draws)
            torch.cuda.synchronize()
            self.calls.append({"kind": kind, "launches": dict(self.conv_block.launches),
                               "timing": dict(trainer.val_timing) if kind == "validate" else {}})
            self.conv_block.launches.clear()
            return out
        return run

    def __enter__(self):
        self.conv_block.launches.clear()  # nothing from an earlier phase counts
        self.real = self.cls.validate, self.cls.test
        self.cls.validate = self._wrap(self.real[0], "validate")
        self.cls.test = self._wrap(self.real[1], "test")
        return self

    def __exit__(self, *exc):
        self.steps += sum(self.conv_block.launches.values())
        self.cls.validate, self.cls.test = self.real
        return False


def lora_base_name(model, name: str) -> str:
    """The base checkpoint's name of a UniverseLoRA parameter: ``model.`` off,
    and a wrapped layer's ``<path>.conv.<leaf>`` as ``<path>.<leaf>``."""
    from open_universe_tpu_torch.nn.lora import LoraLayer

    mod, _, leaf = name.rpartition(".")
    parent, _, last = mod.rpartition(".")
    wrapper = dict(model.named_modules()).get(parent)
    if isinstance(wrapper, LoraLayer) and wrapper.nest == last:
        name = f"{parent}.{leaf}"
    return name[len("model."):]


def phase_lora_training(base_ckpt: str):
    """11a and 11c: the training entry point with
    experiment=universepp_lora_finetune on phase 8's full-width checkpoint
    (f32, PyTorch's TF32 defaults, the phoneme loss off) for LORA_STEPS
    steps, a validation at the last, a checkpoint every LORA_CKPT_EVERY, then
    the test.  Checks: every loss finite; 0 fused-kernel launches in the
    steps, the validation and the test (adapters attached); every frozen
    parameter equal to the base checkpoint's bit for bit, the adapters
    moved; val/multires_l1 and the metrics finite; a run resumed from the
    middle checkpoint restores its state bit for bit.  Returns its numbers
    and the last checkpoint."""
    import glob

    from open_universe_tpu_torch.inference.model_loader import load_model, normalize_key
    from open_universe_tpu_torch.train.__main__ import main as train_main

    tmp = tempfile.mkdtemp()
    data, exp = os.path.join(tmp, "data"), os.path.join(tmp, "exp")
    write_pairs(data, LORA_PAIRS, TRAIN_PAIR_S, seed=12)
    write_pairs(data, LORA_VAL_PAIRS, np.linspace(1.3, 2.5, LORA_VAL_PAIRS), seed=13,
                split="val")
    write_pairs(data, LORA_TEST_PAIRS, np.linspace(1.5, 2.5, LORA_TEST_PAIRS), seed=14,
                split="test")
    args = [f"experiment={LORA}", f"device={DEVICE}", f"model.model={base_ckpt}",
            "model.losses.phonemeloss=null",
            f"datamodule.datasets.vb-train-16k.audio_path={data}",
            f"trainer.max_steps={LORA_STEPS}", f"trainer.val_check_interval={LORA_STEPS}",
            f"trainer.checkpoint_every={LORA_CKPT_EVERY}", "trainer.log_every=1",
            *LORA_OVERRIDES]
    torch.cuda.reset_peak_memory_stats()
    tf32_flags(True)
    try:
        with CountedEval() as counted:
            trainer = train_main(args + ["train=false", f"path.exp_root={exp}/first"])
            model = trainer.model
            init = {n: p.detach().clone() for n, p in model.named_parameters() if p.requires_grad}
            t0 = time.perf_counter()
            trainer.fit()
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 2**30
            trainer.test()
    finally:
        tf32_flags(False)
    (run_dir,) = glob.glob(os.path.join(exp, "first", LORA, "*"))
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    train_rows = [r for r in rows if "train/main_loss" in r]
    for r in train_rows:
        log(f"[lora] step {r['step']}: " + ", ".join(f"{k[6:]} {r[k]:.5f}" for k in LORA_LOSSES)
            + f", grad norm {r['grad/norm']:.3e}, {r['perf/step_time_s']:.3f} s, "
            f"peak {r.get('perf/peak_mem_gib', float('nan')):.2f} GiB")
    if len(train_rows) != LORA_STEPS or not all(
            np.isfinite(r[k]) for r in train_rows for k in LORA_LOSSES + ("grad/norm",)):
        raise AssertionError(f"LoRA training losses: {train_rows}")
    if [c["kind"] for c in counted.calls] != ["validate", "test"]:
        raise AssertionError(f"validations and tests run: {[c['kind'] for c in counted.calls]}")
    launched = {"steps": counted.steps, "validation": sum(counted.calls[0]["launches"].values()),
                "test": sum(counted.calls[1]["launches"].values())}
    log(f"[lora] fused-kernel launches (adapters attached): {launched}")
    if any(launched.values()):
        raise AssertionError(f"the kernel ran with LoRA adapters attached: {launched}")

    base_sd = load_model(base_ckpt, device=DEVICE, trainable=True).state_dict()
    n_train = {"adapters": 0, "biases and the rest": 0}
    frozen_bad, moved = [], {"adapters": 0, "biases and the rest": 0}
    for n, p in model.named_parameters():
        if p.requires_grad:
            grp = "adapters" if "lora_" in n else "biases and the rest"
            n_train[grp] += 1
            moved[grp] += not torch.equal(p.detach(), init[n])
        elif not torch.equal(p.detach(), base_sd[lora_base_name(model, n)]):
            frozen_bad.append(n)
    n_el = {"trainable": sum(p.numel() for p in model.parameters() if p.requires_grad),
            "frozen": sum(p.numel() for p in model.parameters() if not p.requires_grad)}
    log(f"[lora] tensors moved by group {moved} of {n_train}; elements {n_el}; frozen tensors "
        f"that differ from the base checkpoint's: {frozen_bad[:5]} ({len(frozen_bad)})")
    if frozen_bad or moved["adapters"] < n_train["adapters"] // 2:
        raise AssertionError(f"LoRA steps: frozen changed {frozen_bad[:8]}, moved {moved}")

    val = [r for r in rows if "val/multires_l1" in r]
    val_keys = ("val/main_loss", "val/multires_l1", "val/mpd", "val/mrd", "val/pesq", "val/lsd")
    with open(os.path.join(run_dir, "test_summary.json")) as f:
        summary = json.load(f)
    log(f"[lora] validation @{val[0]['step']} ({LORA_VAL_PAIRS} clips): "
        + ", ".join(f"{k} {val[0][k]:.4f}" for k in val_keys)
        + f"; {counted.calls[0]['timing']}; test summary {summary}")
    if not all(np.isfinite(val[0][k]) for k in val_keys) or summary.get("number") != \
            LORA_TEST_PAIRS:
        raise AssertionError(f"LoRA validation {val}, test {summary}")
    times = [r["perf/step_time_s"] for r in train_rows]
    result = {"steps": LORA_STEPS,
              "batch": trainer.config["datamodule"]["train"]["dl_opts"]["batch_size"],
              "crop_s": 2.0, "first_step_s": times[0],
              "median_step_s": float(np.median(times[1:])), "peak_mem_gib": peak,
              "fit_s": fit_s, "elements": n_el, "launches": launched,
              "losses": {k: [r[k] for r in train_rows] for k in LORA_LOSSES},
              "validation": {k: val[0][k] for k in val_keys},
              "validation_timing": counted.calls[0]["timing"], "test_summary": summary}
    log(f"[lora] {card_line()}: first step {times[0]:.3f} s, median after it "
        f"{result['median_step_s']:.3f} s, peak {peak:.2f} GiB (batch 4 x 2 s, f32, cuDNN "
        f"TF32 on, 8 sampler steps, gradients in the last 2)")
    del trainer, model, init, base_sd
    torch.cuda.empty_cache()

    # resume from the middle checkpoint: the restored state is its own
    ckpt_mid = os.path.join(run_dir, "checkpoints", f"step_{LORA_CKPT_EVERY:08d}.ckpt")
    resumed = train_main(args + [f"ckpt_path={ckpt_mid}", "train=false",
                                 f"path.exp_root={exp}/resumed"])
    saved = torch.load(ckpt_mid, map_location=DEVICE, weights_only=False)
    restored = trainer_state(resumed)
    bad = same_state(restored, {
        "state_dict": {normalize_key(k): v for k, v in saved["state_dict"].items()},
        "global_step": saved["global_step"], "optimizer_states": saved["optimizer_states"],
        "updates": [s["updates"] for s in saved["lr_schedulers"]],
        "ema": saved["ema"]["shadow_params"], "num_updates": saved["ema"]["num_updates"]})
    half = LORA_CKPT_EVERY
    bad += [] if (restored["global_step"], restored["num_updates"], restored["updates"]) == (
        half, half, [half]) else ["counts"]
    edm = sum(k.startswith("model._edm_model.") for k in saved["state_dict"])
    log(f"[lora] resumed from {os.path.basename(ckpt_mid)} ({edm} model._edm_model. keys): "
        f"restored state differs at {bad[:5]} ({len(bad)} paths)")
    if bad or not edm:
        raise AssertionError(f"LoRA resume differs at {bad[:8]}")
    del resumed, saved
    torch.cuda.empty_cache()
    return result, os.path.join(run_dir, "checkpoints", f"step_{LORA_STEPS:08d}.ckpt")


def phase_lora_step_vs_cpu(phoneme=("model.losses.phonemeloss=null",), name="lora-vs-cpu"):
    """11b: one LoRA fine-tuning step (the experiment's config: rank 16,
    alpha 4, 8 sampler steps with gradients in the last 2, the frozen
    discriminators' loss; ``phoneme``: the phoneme loss's overrides, off in
    11b, a tiny random wav2vec2 in 13c) on a narrow UNIVERSE++
    (NARROW_OVERRIDES) on the card and on the CPU, same weights, adapters
    and sampler draws, TF32 off.
    Bounds: losses relative <= 1e-4 (the sampler's last step cancels a
    sigma_max-scale start down to the signal, which amplifies float32's
    rounding); every trainable tensor's gradient <= 1e-2 of its largest
    (5e-2 for one element) plus 1e-6 of the largest trainable gradient (the
    losses are L1s on STFT magnitudes and feature maps, whose gradients
    flip sign where the two sides round apart; a few tensors' gradients
    cancel to ~1e-7 of the largest); every change as 8b's."""
    import copy

    from open_universe_tpu_torch.configs.registry import instantiate_trainable
    from open_universe_tpu_torch.configs.resolve import compose
    from open_universe_tpu_torch.models.universe_lora import UniverseLoRA
    from open_universe_tpu_torch.nn.layers import init_weights
    from open_universe_tpu_torch.train.trainer import make_train_step
    from open_universe_tpu_torch.utils.convert import fold_weight_norm

    cfg = compose(config_dir(), ["experiment=universepp_vb_16k", *NARROW_OVERRIDES])
    base = fold_weight_norm(init_weights(instantiate_trainable(cfg["model"]), seed=3))
    lcfg = compose(config_dir(), [f"experiment={LORA}", *phoneme])
    kw = {k: v for k, v in lcfg["model"].items() if k not in ("_target_", "model")}
    rng = np.random.default_rng(6)
    clean = (0.05 * rng.standard_normal((2, NARROW_T, 1))).astype(np.float32)
    batch = {"clean": clean,
             "noisy": clean + (0.02 * rng.standard_normal(clean.shape)).astype(np.float32)}
    padded = (2, NARROW_T + base.tot_ds - NARROW_T % base.tot_ds, 1)
    noise = [rng.standard_normal(padded).astype(np.float32) for _ in range(N_STEPS)]
    runs = {}
    for tag, device in (("cpu", "cpu"), ("card", DEVICE)):
        model = UniverseLoRA(model=copy.deepcopy(base).to(device), **kw)
        step = make_train_step(model, lcfg["trainer"]["max_steps"])
        p0 = {n: p.detach().cpu().clone() for n, p in model.named_parameters()
              if p.requires_grad}
        m = step({k: torch.from_numpy(v).to(device) for k, v in batch.items()},
                 draws={"noise": [torch.from_numpy(z).to(device) for z in noise]})
        runs[tag] = ({k: float(v) for k, v in m.items()}, p0,
                     {n: (p.detach().cpu(), p.grad.cpu()) for n, p in model.named_parameters()
                      if p.requires_grad})
    (m_cpu, p0, cpu), (m_card, _, card) = runs["cpu"], runs["card"]
    loss_rel = {k: abs(m_card[k] - v) / max(abs(v), 1e-12) for k, v in m_cpu.items()
                if k.startswith(("train/", "grad/"))}
    top = max(g.abs().max().item() for _, g in cpu.values())
    grad_rel, small, failed = {}, 0, []
    for n, (p_cpu, g_cpu) in cpu.items():
        p_card, g_card = card[n]
        scale = g_cpu.abs().max().item()
        err = (g_card - g_cpu).abs().max().item()
        grad_rel[n] = err / max(scale, 1e-30)
        if not err <= (5e-2 if g_cpu.numel() == 1 else 1e-2) * scale + 1e-6 * top:
            failed.append(f"gradient of {n}: {grad_rel[n]:.3e}")
        d_cpu, d_card = p_cpu - p0[n], p_card - p0[n]
        bound = 1e-3 * d_cpu.abs().max() + 2 * torch.finfo(torch.float32).eps * (
            p0[n].abs() + d_cpu.abs())
        bad = (d_card - d_cpu).abs() > bound
        tiny = (g_cpu.abs() < 1e-2 * scale) | (g_cpu.abs() < 1e-7) | (g_cpu.abs() < 1e-4 * top)
        small += int((bad & tiny).sum())
        if (bad & ~tiny).any():
            failed.append(f"update of {n}")
    n_el = sum(g.numel() for _, g in cpu.values())
    worst = sorted(grad_rel.items(), key=lambda kv: -kv[1])[:6]
    log(f"[{name}] narrow step ({NARROW_OVERRIDES}, batch 2 x {NARROW_T}, the "
        f"experiment's LoRA config), TF32 off: losses max rel {max(loss_rel.values()):.3e} "
        f"({max(loss_rel, key=loss_rel.get)}); {len(cpu)} trainable tensors, gradient "
        f"max|d| / max|g_cpu| median {float(np.median(list(grad_rel.values()))):.3e}, worst "
        f"{worst}; updates: {small} small-gradient elements of {n_el} past 1e-3")
    if not max(loss_rel.values()) <= 1e-4 or small > 1e-2 * n_el or failed:
        raise AssertionError(f"LoRA card vs CPU step beyond its bounds: losses {loss_rel}, "
                             f"small {small}, {failed[:8]}")
    return {"loss_rel": max(loss_rel.values()), "losses_rel": loss_rel,
            "trainable_tensors": len(cpu),
            "grad_rel_median": float(np.median(list(grad_rel.values()))),
            "grad_rel_worst": worst, "small_gradient_elements": small, "elements": n_el}


def phase_lora_checkpoint(ckpt: str):
    """11d: load_model on the fine-tuned checkpoint (a UniverseLoRA, EMA
    applied): enhance of 2 x 2 s launches 0; merge_lora's plain model
    launches 94 through the main entry (f32, then bf16) and equals the adapter
    model's enhance on the same noise (f32: <= 1e-4 of max|ref|; bf16 logged:
    the two round the weights at other points); audio-s/s at batch 128 x
    2 s, merged (kernel) against adapters (unfused), bf16 and f32 (median of
    3); one file through the enhance CLI.  The adapter model launches
    neither kernel."""
    from open_universe_tpu_torch.inference.model_loader import load_model
    from open_universe_tpu_torch.ops.kernels import rate_change

    model = load_model(ckpt, device=DEVICE)
    t = int(CLIP_S * FS)
    g = torch.Generator(device=DEVICE).manual_seed(71)
    mix = torch.randn(2, t, generator=g, device=DEVICE) * 0.05
    noise = noise_draws(model.model, 2, t, seed=72)
    out = {"type": type(model).__name__}
    adapter, counts = counted_enhance(model, mix, noise)
    rate = dict(rate_change.launches)
    log(f"[lora ckpt] load_model({os.path.basename(ckpt)}) -> {out['type']}: enhance of "
        f"2 x 2 s with the adapters: {sum(counts.values())} launches, "
        f"{sum(rate.values())} rate-change launches")
    if counts or rate or out["type"] != "UniverseLoRA":
        raise AssertionError(f"LoRA checkpoint: {out['type']}, launches {counts} {rate}")
    merged = model.merge_lora()
    for tag, dtype, route in (("f32", None, F32), ("bf16", torch.bfloat16, BF16)):
        o, counts = counted_enhance(merged, mix, noise, dtype)
        check_path(f"lora merged {tag}", counts, WIDTH_LENGTHS, route, o, t)
        ref = adapter if dtype is None else counted_enhance(model, mix, noise, dtype)[0]
        rel = (o - ref).abs().max().item() / ref.abs().max().item()
        out[tag] = {"launches": by_entry(counts), "max_rel_diff": rel}
        log(f"[lora ckpt {tag}] merge_lora (kernel) vs the adapters (unfused): max|d| / "
            f"max|ref| = {rel:.3e}" + (" (bound 1e-4)" if dtype is None else " (no bound: bf16)"))
        if dtype is None and not rel <= 1e-4:
            raise AssertionError(f"merge_lora's enhance differs from the adapters' by {rel}")
    mix_t = torch.randn(TIMING_BATCH, t, generator=g, device=DEVICE) * 0.05
    noise_t = noise_draws(model.model, TIMING_BATCH, t, seed=73)
    rates = {}
    for tag, dtype in (("bf16", torch.bfloat16), ("f32", None)):
        for name, m in (("merged_kernel", merged), ("adapters_unfused", model)):
            s = timed_enhance(m, mix_t, noise_t, True, dtype, runs=3)
            rates[f"{tag}_{name}"] = TIMING_BATCH * CLIP_S / s
    log(f"[lora ckpt] {card_line()}: enhance at batch {TIMING_BATCH} x 2 s, 8 steps, "
        f"audio-s/s: " + ", ".join(f"{k} {v:.1f}" for k, v in rates.items()))
    out["audio_s_per_s"] = rates
    del merged, mix_t, noise_t
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "in"), os.path.join(tmp, "out")
        write_tree(src, CLI_FILES[:1])
        counts, cli = run_cli("lora", src, dst, ckpt)
        check_outputs("lora", dst, CLI_FILES[:1])
    if counts:
        raise AssertionError(f"the enhance CLI on the LoRA checkpoint launched {counts}")
    out["cli"] = cli
    return out


def phase_aux_gan():
    """11e: UNIVERSE++ with a MultiResL1SpecLoss aux loss (windows 256, 1024,
    2048) on a warm-up the steps cross (start 0 over 2 steps): AUX_STEPS
    full-width GAN steps of universepp_vb_16k through the entry point at
    batch AUX_BATCH x 2 s (f32, PyTorch's TF32 defaults): the aux term and
    its weight per step (0, 0.5, 1), losses finite, 0 launches; then one
    narrow step at step 1 (weight 0.5) on the card against the CPU with 8b's
    bounds, plus 1e-6 of each group's largest gradient on each tensor's."""
    import glob

    from open_universe_tpu_torch.ops.kernels import conv_block
    from open_universe_tpu_torch.train.__main__ import main as train_main

    tmp = tempfile.mkdtemp()
    data = os.path.join(tmp, "data")
    write_pairs(data, AUX_BATCH, TRAIN_PAIR_S, seed=15)
    tf32_flags(True)
    try:
        trainer = train_main([
            "experiment=universepp_vb_16k", f"device={DEVICE}", "train=false",
            f"datamodule.datasets.vb-train-16k.audio_path={data}",
            f"datamodule.train.dl_opts.batch_size={AUX_BATCH}",
            f"trainer.max_steps={AUX_STEPS}", "trainer.val_check_interval=1000000",
            "trainer.log_every=1", f"path.exp_root={tmp}/exp", *TRAIN_OVERRIDES,
            *AUX_OVERRIDES])
        conv_block.launches.clear()
        trainer.fit()
        torch.cuda.synchronize()
        launches = sum(conv_block.launches.values())
    finally:
        tf32_flags(False)
    (run_dir,) = glob.glob(os.path.join(tmp, "exp", "universepp_vb_16k", "*"))
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    for r in rows:
        log(f"[aux] step {r['step']}: aux weight {r['train/aux_weight']:.2f}, aux term "
            f"{r['train/signal_aux']:.5f}, loss_gen {r['train/loss_gen']:.4f}, loss_disc "
            f"{r['train/loss_disc']:.4f}, {r['perf/step_time_s']:.3f} s")
    weights = [r["train/aux_weight"] for r in rows]
    aux = [r["train/signal_aux"] for r in rows]
    if weights != [0.0, 0.5, 1.0] or aux[0] != 0.0 or not all(a > 0 for a in aux[1:]) or \
            launches or not all(np.isfinite(v) for r in rows for k, v in r.items()
                                if k.startswith("train/")):
        raise AssertionError(f"aux-loss GAN steps: weights {weights}, aux {aux}, "
                             f"launches {launches}")
    del trainer
    torch.cuda.empty_cache()
    vs_cpu = phase_train_step_vs_cpu(extra=AUX_OVERRIDES, at_step=1, name="aux-vs-cpu",
                                     grad_floor=1e-6)
    return {"steps": AUX_STEPS, "batch": AUX_BATCH, "aux_weights": weights, "aux_terms": aux,
            "launches": launches, "step_s": [r["perf/step_time_s"] for r in rows],
            "card_vs_cpu": vs_cpu}



# ---------------------------------------------------------------- phase 12
# 12a: full-width steps per arm (SCALE_STEPS timed after the first), batch
# TRAIN_BATCH x 2 s; 12b: accumulation of ACCUM_K micro-batches of
# ACCUM_BATCH; 12c: DDP_WORLD gloo ranks on cuda:0 at a narrow width, and the
# entry point under torchrun (one NCCL process) at full width
SCALE_STEPS = 4
SCALE_ARMS = (("f32", []), ("bf16", ["model.training.compute_dtype=bf16"]),
              ("f32_remat", ["model.training.remat=true"]),
              ("bf16_remat", ["model.training.compute_dtype=bf16", "model.training.remat=true"]))
ACCUM_K, ACCUM_BATCH, ACCUM_UPDATES = 4, 10, 2
DDP_WORLD, DDP_BATCH, DDP_STEPS = 2, 4, 2
RUN_STEPS, RUN_CKPT, RUN_VAL_PAIRS = 4, 3, 4
RUN_OVERRIDES = ["model.training.compute_dtype=bf16",
                 "model.optimizer.accumulate_grad_batches=2"]
PARITY_PAIRS = 4


def synthetic_batch(b: int, t: int, seed: int, device=None) -> dict:
    """A (b, t, 1) batch of tones in noise, as ``write_pairs`` makes them."""
    rng = np.random.default_rng(seed)
    tt = np.arange(t) / FS
    f0 = rng.uniform(100, 300, size=(b, 1))
    clean = 0.1 * np.sin(2 * np.pi * f0 * tt) * (1 + 0.5 * np.sin(2 * np.pi * 3 * tt))
    clean = (clean + 0.01 * rng.standard_normal(clean.shape))[..., None].astype(np.float32)
    noisy = (clean + 0.05 * rng.standard_normal(clean.shape)).astype(np.float32)
    return {k: torch.from_numpy(v).to(device or DEVICE) for k, v in
            (("clean", clean), ("noisy", noisy))}


def float32_state(model, step) -> list:
    """Names of parameters, gradients, optimizer moments and EMA shadows that
    are not float32."""
    from open_universe_tpu_torch.train.trainer import optimizers

    bad = [n for n, p in model.named_parameters() if p.dtype != torch.float32
           or (p.grad is not None and p.grad.dtype != torch.float32)]
    bad += [f"{k} of {o.__class__.__name__}" for o, _, _ in optimizers(step)
            for st in o.state.values() for k, v in st.items()
            if torch.is_tensor(v) and v.dim() > 0 and v.dtype != torch.float32]
    return bad + [n for n, s in step.ema.shadow.items() if s.dtype != torch.float32]


def scale_arm(tag, experiment, overrides, batch, steps, seed=0, keep=False):
    """Build ``experiment`` at full width with ``overrides`` (weights from
    ``seed``), take 1 + ``steps`` steps on ``batch`` (the first on fixed
    draws, the rest drawn from a generator), each synchronised and timed;
    the first step's losses, the parameters after it (``keep``), the step
    times, the peak memory, the launches and the non-float32 state."""
    from open_universe_tpu_torch.configs.registry import instantiate_trainable
    from open_universe_tpu_torch.configs.resolve import compose
    from open_universe_tpu_torch.nn.layers import init_weights
    from open_universe_tpu_torch.ops.kernels import conv_block
    from open_universe_tpu_torch.train.trainer import make_step

    width = TRAIN_OVERRIDES if experiment == "universepp_vb_16k" else ORIG_OVERRIDES
    cfg = compose(config_dir(), [f"experiment={experiment}", *width, *overrides])
    model = init_weights(instantiate_trainable(cfg["model"]), seed=seed).to(DEVICE).train()
    step = make_step(model, cfg["trainer"]["max_steps"])
    b = batch["noisy"].shape[0]
    g = torch.Generator(device=DEVICE).manual_seed(seed + 1)
    first = {"u": torch.rand(b, generator=g, device=DEVICE),
             "z": torch.randn(batch["clean"].shape, generator=g, device=DEVICE)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    conv_block.launches.clear()
    times, losses, after = [], None, None
    for i in range(1 + steps):
        t0 = time.perf_counter()
        m = step(batch, generator=g, draws=first if i == 0 else None)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if i == 0:
            losses = {k: float(v) for k, v in m.items() if k.startswith("train/")}
            if keep:
                after = {n: p.detach().cpu().clone() for n, p in model.named_parameters()}
    out = {"first_step_s": times[0], "median_step_s": float(np.median(times[1:])),
           "step_s": times, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
           "launches": sum(conv_block.launches.values()), "first_losses": losses,
           "not_float32": float32_state(model, step)}
    log(f"[scale {tag}] {experiment} {overrides}: batch {b} x 2 s, first step "
        f"{times[0]:.3f} s, median after it {out['median_step_s']:.3f} s, peak "
        f"{out['peak_mem_gib']:.2f} GiB, launches {out['launches']}; loss "
        f"{losses.get('train/loss_gen', losses.get('train/loss'))}")
    if out["launches"] or out["not_float32"] or not all(np.isfinite(v) for v in losses.values()):
        raise AssertionError(f"scale {tag}: launches {out['launches']}, not float32 "
                             f"{out['not_float32'][:5]}, losses {losses}")
    del model, step
    torch.cuda.empty_cache()
    return out, after


def compare_updates(tag, a, b, la, lb, loss_tol, param_tol):
    """Losses (relative) and parameters after a step (of each tensor's
    largest) of two arms."""
    loss_rel = max(abs(la[k] - lb[k]) / max(abs(lb[k]), 1e-12) for k in lb)
    param_rel = max(((a[n] - p).abs().max() / max(p.abs().max(), 1e-30)).item()
                    for n, p in b.items()) if a is not None else None
    log(f"[scale {tag}] first step: losses max relative {loss_rel:.3e} (bound {loss_tol}); "
        f"parameters after it max|d| / max|p| {param_rel if param_rel is None else f'{param_rel:.3e}'}"
        f" (bound {param_tol})")
    if not loss_rel <= loss_tol or (param_rel is not None and not param_rel <= param_tol):
        raise AssertionError(f"scale {tag}: losses {loss_rel}, parameters {param_rel}")
    return {"loss_rel": loss_rel, "param_rel": param_rel}


def phase_scale():
    """12a: the UNIVERSE++ GAN step at full width (universepp_vb_16k, batch
    40 x 2 s, PyTorch's TF32 defaults, cuDNN deterministic) in four arms:
    f32, bf16, f32 + remat, bf16 + remat: the median step time after the
    first, the peak memory, 0 launches, every parameter, gradient, Adam
    moment and EMA shadow float32.  Remat against no remat on the first
    step (same weights, batch and draws): losses <= 1e-6 relative, the
    updated parameters <= 1e-5 of each tensor's largest.  bf16 against f32
    on the first step: losses within 0.1 (|f32| + 1).  Then the plain
    UNIVERSE (universe_original_vb_16k) in f32 and bf16 at batch 40."""
    batch = synthetic_batch(TRAIN_BATCH, int(CLIP_S * FS), seed=12)
    torch.backends.cudnn.deterministic = True
    tf32_flags(True)
    arms, kept = {}, {}
    try:
        for tag, ov in SCALE_ARMS:
            arms[tag], kept[tag] = scale_arm(tag, "universepp_vb_16k", ov, batch, SCALE_STEPS,
                                             keep=True)
        checks = {}
        for plain, remat in (("f32", "f32_remat"), ("bf16", "bf16_remat")):
            checks[remat] = compare_updates(f"{remat} vs {plain}", kept[remat], kept[plain],
                                            arms[remat]["first_losses"],
                                            arms[plain]["first_losses"], 1e-6, 1e-5)
        kept.clear()
        f32l, bf16l = arms["f32"]["first_losses"], arms["bf16"]["first_losses"]
        bf16_rel = max(abs(bf16l[k] - v) / (abs(v) + 1.0) for k, v in f32l.items())
        log(f"[scale bf16 vs f32] first step: losses max |d| / (|f32| + 1) {bf16_rel:.3e} "
            f"(bound 0.1)")
        if not bf16_rel <= 0.1:
            raise AssertionError(f"bf16 losses differ from f32 by {bf16_rel}")
        checks["bf16_vs_f32"] = bf16_rel
        orig = {}
        for tag, ov in (("orig_f32", []), ("orig_bf16", ["model.training.compute_dtype=bf16"])):
            orig[tag], _ = scale_arm(tag, ORIG, ov, batch, SCALE_STEPS, seed=1)
    finally:
        tf32_flags(False)
        torch.backends.cudnn.deterministic = False
    log(f"[scale] {card_line()}: median step s / peak GiB at batch {TRAIN_BATCH} x 2 s: "
        + ", ".join(f"{k} {v['median_step_s']:.3f} / {v['peak_mem_gib']:.2f}"
                    for k, v in {**arms, **orig}.items()))
    return {"batch": TRAIN_BATCH, "steps": 1 + SCALE_STEPS, "arms": arms, "checks": checks,
            "universe_original": orig}


def phase_accumulation(f32_arm):
    """12b: (narrow) two micro-batches then one update on the card against
    the CPU with 8b's bounds; (full width) accumulate_grad_batches=ACCUM_K
    at batch ACCUM_BATCH x 2 s, f32, ACCUM_UPDATES updates: the time and the
    peak memory per update against 12a's f32 arm at batch 40."""
    vs_cpu = phase_train_step_vs_cpu(extra=("model.optimizer.accumulate_grad_batches=2",),
                                     name="accum-vs-cpu", calls=2)
    batch = synthetic_batch(ACCUM_BATCH, int(CLIP_S * FS), seed=13)
    tf32_flags(True)
    try:
        out, _ = scale_arm("accum", "universepp_vb_16k",
                           [f"model.optimizer.accumulate_grad_batches={ACCUM_K}"], batch,
                           ACCUM_K * ACCUM_UPDATES - 1)
    finally:
        tf32_flags(False)
    calls = out["step_s"]
    per_update = [sum(calls[i:i + ACCUM_K]) for i in range(0, len(calls), ACCUM_K)]
    log(f"[accum] {card_line()}: {ACCUM_K} x batch {ACCUM_BATCH} per update: "
        f"{per_update} s per update (the first holds the first call), peak "
        f"{out['peak_mem_gib']:.2f} GiB, launches {out['launches']}; batch "
        f"{TRAIN_BATCH} in one step (12a f32): {f32_arm['median_step_s']:.3f} s, "
        f"{f32_arm['peak_mem_gib']:.2f} GiB")
    return {"card_vs_cpu": vs_cpu, "k": ACCUM_K, "micro_batch": ACCUM_BATCH,
            "update_s": per_update, "peak_mem_gib": out["peak_mem_gib"],
            "launches": out["launches"], "call_s": calls}


def ddp_jobs(device) -> dict:
    """DDP_STEPS steps of the narrow GAN step (NARROW_OVERRIDES) and of the
    narrow plain UNIVERSE (NARROW_ORIG_OVERRIDES) on a global batch of
    DDP_BATCH x NARROW_T with fixed draws, in this process's share of the
    job: the losses, step 1's (averaged) gradients, the parameters after."""
    from open_universe_tpu_torch.configs.registry import instantiate_trainable
    from open_universe_tpu_torch.configs.resolve import compose
    from open_universe_tpu_torch.nn.layers import init_weights
    from open_universe_tpu_torch.train.trainer import make_step

    out = {}
    for name, exp, ov in (("gan", "universepp_vb_16k", NARROW_OVERRIDES),
                          ("orig", ORIG, NARROW_ORIG_OVERRIDES)):
        cfg = compose(config_dir(), [f"experiment={exp}", *ov])
        model = init_weights(instantiate_trainable(cfg["model"]), seed=3).to(device).train()
        step = make_step(model, cfg["trainer"]["max_steps"])
        rng = np.random.default_rng(6)
        res = {"losses": []}
        for i in range(DDP_STEPS):
            batch = synthetic_batch(DDP_BATCH, NARROW_T, seed=20 + i, device=device)
            draws = {"u": torch.from_numpy(rng.uniform(size=DDP_BATCH).astype(np.float32)),
                     "z": torch.from_numpy(rng.standard_normal(
                         (DDP_BATCH, NARROW_T, 1)).astype(np.float32))}
            m = step(batch, draws={k: v.to(device) for k, v in draws.items()})
            res["losses"].append({k: float(v) for k, v in m.items() if k.startswith("train/")})
            if i == 0:
                res["grads"] = {n: p.grad.detach().cpu().clone()
                                for n, p in model.named_parameters() if p.grad is not None}
        res["params"] = {n: p.detach().cpu().clone() for n, p in model.named_parameters()}
        out[name] = res
    return out


def ddp_worker(rank: int, init: str, out_dir: str, device: str) -> None:
    """One gloo rank of 12c on ``device`` (every rank on cuda:0)."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{init}", world_size=DDP_WORLD,
                            rank=rank)
    try:
        tf32_flags(False)
        torch.backends.cudnn.deterministic = True
        torch.save(ddp_jobs(torch.device(device)), os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def compare_runs(tag, r0, one, rel, ema=False):
    """A run of ranks (``r0``, rank 0's result) against one process: losses
    <= 1e-6 relative; step 1's gradients <= ``rel`` of each tensor's
    largest (1e-4 for one element) plus 1e-7 of the largest; parameters
    (and EMA shadows) <= 1e-5 of each tensor's largest, elements whose
    gradient is below 1e-2 of their tensor's largest or 1e-7 aside (AdamW's
    +-lr), counted and held to 1 % of the elements."""
    loss_rel = max(abs(a[k] - v) / max(abs(v), 1e-12)
                   for a, b in zip(r0["losses"], one["losses"]) for k, v in b.items())
    top = max(g.abs().max().item() for g in one["grads"].values())
    grad_rel, failed, small, n_el = 0.0, [], 0, 0
    for n, g in one["grads"].items():
        scale = g.abs().max().item()
        err = (r0["grads"][n] - g).abs().max().item()
        grad_rel = max(grad_rel, err / max(scale, 1e-30))
        if not err <= max(rel, 1e-4 if g.numel() == 1 else rel) * scale + 1e-7 * top:
            failed.append(f"gradient of {n}: {err / max(scale, 1e-30):.3e}")
        pairs = [(r0["params"][n], one["params"][n])]
        if ema and n in one["ema"]:
            pairs.append((r0["ema"][n], one["ema"][n]))
        tiny = (g.abs() < 1e-2 * scale) | (g.abs() < 1e-7)
        for p, want in pairs:
            over = (p - want).abs() > 1e-5 * want.abs().max()
            if (over & ~tiny).any():
                failed.append(f"parameter {n}")
            small += int(over.sum())
            n_el += p.numel()
    log(f"[{tag}] losses max rel {loss_rel:.3e}; step 1 gradients max|d| / max|g| "
        f"{grad_rel:.3e}; small-gradient elements past 1e-5: {small} of {n_el}")
    if not loss_rel <= 1e-6 or failed or small > 1e-2 * n_el:
        raise AssertionError(f"{tag}: losses {loss_rel}, {failed[:5]}, small {small}")
    return {"loss_rel": loss_rel, "grad_rel": grad_rel, "small_gradient_elements": small}


def compare_ddp(name, ranks, one):
    """The ranks against each other (bit for bit) and against one process
    (``compare_runs``; gradients <= 1e-5 of each tensor's largest, 1e-4 for
    the GAN, whose mel and feature-matching L1s flip where the two runs
    round apart)."""
    r0, r1 = ranks
    bad = [n for n, p in r0["params"].items() if not torch.equal(p, r1["params"][n])]
    log(f"[ddp {name}] {DDP_WORLD} gloo ranks on cuda:0 vs one process, {DDP_STEPS} steps: "
        f"ranks differ at {len(bad)} tensors")
    if bad:
        raise AssertionError(f"ddp {name}: ranks {bad[:3]}")
    return compare_runs(f"ddp {name}", r0, one, 1e-4 if name == "gan" else 1e-5)


def torchrun(spec: dict, timeout: int = 600) -> dict:
    """This script under ``torchrun --standalone --nproc_per_node 1``
    (NCCL) in its ``--torchrun-train`` mode on ``spec``; its result."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    with open(path, "w") as f:
        json.dump(spec, f)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                           "--nproc_per_node", "1", os.path.abspath(__file__),
                           "--torchrun-train", path],
                          cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
                          text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        if line.startswith("["):
            log(line)
    if proc.returncode != 0:
        raise AssertionError(f"torchrun {spec['mode']}: exit {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
    with open(spec["out"]) as f:
        result = json.load(f)
    result["torchrun_wall_s"] = wall
    return result


def torchrun_child(spec_path: str) -> int:
    """The training entry point in one torchrun process: ``fit`` (counting
    the launches of the steps, the validation and the test), or a restore
    from ``ckpt`` held against the checkpoint bit for bit, then ``fit``."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from open_universe_tpu_torch.parallel import mesh
    from open_universe_tpu_torch.train.__main__ import main as train_main

    with open(spec_path) as f:
        spec = json.load(f)
    if not torch.cuda.is_available():  # a rehearsal on the CPU: nothing to wait for
        torch.cuda.synchronize = lambda *a: None
        torch.cuda.max_memory_allocated = lambda *a: 0
    tf32_flags(True)
    out = {"mode": spec["mode"]}
    if spec["mode"] == "fit":
        with CountedEval() as counted:
            t0 = time.perf_counter()
            trainer = train_main(spec["args"])
            torch.cuda.synchronize()
            out["fit_s"] = time.perf_counter() - t0
        calls = [{"kind": c["kind"], "routes": by_route(c["launches"]),
                  "entries": by_entry(c["launches"]), "timing": c["timing"]}
                 for c in counted.calls]
        out.update(steps_launches=counted.steps, calls=calls,
                   run_dir=str(trainer.output_dir), world=mesh.world_size(),
                   backend=torch.distributed.get_backend(),
                   not_float32=float32_state(trainer.model, trainer.step_fn),
                   peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    else:
        resumed = train_main(spec["args"] + [f"ckpt_path={spec['ckpt']}", "train=false"])
        saved = torch.load(spec["ckpt"], map_location=resumed.device, weights_only=False)
        restored = trainer_state(resumed)
        bad = same_state(restored, {
            "state_dict": saved["state_dict"], "global_step": saved["global_step"],
            "optimizer_states": saved["optimizer_states"],
            "updates": [s["updates"] for s in saved["lr_schedulers"]],
            "grad_accumulators": saved["grad_accumulators"],
            "ema": saved["ema"]["shadow_params"], "num_updates": saved["ema"]["num_updates"]})
        counts = {"global_step": restored["global_step"], "updates": restored["updates"],
                  "mini_steps": [a["mini_step"] for a in restored["grad_accumulators"]]}
        want = {"global_step": saved["global_step"],
                "updates": [s["updates"] for s in saved["lr_schedulers"]],
                "mini_steps": [a["mini_step"] for a in saved["grad_accumulators"]]}
        resumed.fit()
        out.update(bad=bad, counts=counts, want=want, step=resumed.step_fn.step,
                   updates=[resumed.step_fn.gen_updates, resumed.step_fn.disc_updates])
    if mesh.is_main():
        with open(spec["out"], "w") as f:
            json.dump(out, f)
    torch.distributed.destroy_process_group()
    return 0


def phase_data_parallel():
    """12c: (gloo) DDP_WORLD ranks on cuda:0 at a narrow width, 2 GAN and 2
    plain-UNIVERSE steps, against one process on the global batch
    (``compare_ddp``); (NCCL) the training entry point under torchrun, one
    process, at full width with bf16 and accumulate_grad_batches=2: 4
    steps at batch 40, a checkpoint at step 3 (mid-accumulation) and at 4,
    a validation at 4 (RUN_VAL_PAIRS clips; its score bins in bf16, its
    enhance in f32: 5 x 24 per clip on the bf16 route, 94 per enhanced clip
    on the f32 one); a resume from step 3 restores the state, the
    accumulator included, bit for bit, and takes step 4."""
    import glob
    import shutil

    tmp = tempfile.mkdtemp()
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=ddp_worker,
                         args=(r, os.path.join(tmp, "rendezvous"), tmp, DEVICE))
             for r in range(DDP_WORLD)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    try:
        tf32_flags(False)
        torch.backends.cudnn.deterministic = True
        one = ddp_jobs(torch.device(DEVICE))
    finally:
        torch.backends.cudnn.deterministic = False
        for p in procs:
            p.join(timeout=600)
            if p.is_alive():
                p.kill()
    if [p.exitcode for p in procs] != [0] * DDP_WORLD:
        raise AssertionError(f"ddp ranks exited {[p.exitcode for p in procs]}")
    ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
             for r in range(DDP_WORLD)]
    gloo = {name: compare_ddp(name, [r[name] for r in ranks], one[name])
            for name in ("gan", "orig")}
    gloo["wall_s"] = time.perf_counter() - t0

    data, exp = os.path.join(tmp, "data"), os.path.join(tmp, "exp")
    write_pairs(data, TRAIN_BATCH, TRAIN_PAIR_S, seed=18)
    write_pairs(data, RUN_VAL_PAIRS, np.linspace(1.3, 3.1, RUN_VAL_PAIRS), seed=19,
                split="val")
    args = ["experiment=universepp_vb_16k", f"device={DEVICE}",
            f"datamodule.datasets.vb-train-16k.audio_path={data}",
            f"datamodule.train.dl_opts.batch_size={TRAIN_BATCH}",
            f"trainer.max_steps={RUN_STEPS}", f"trainer.val_check_interval={RUN_STEPS}",
            f"trainer.checkpoint_every={RUN_CKPT}", "trainer.log_every=1", "trainer.mesh_dp=1",
            *TRAIN_OVERRIDES, *RUN_OVERRIDES]
    first = torchrun({"mode": "fit", "args": args + [f"path.exp_root={exp}/first"],
                      "out": os.path.join(tmp, "first.json")})
    (run_dir,) = glob.glob(os.path.join(exp, "first", "universepp_vb_16k", "*"))
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    train_rows = [r for r in rows if "train/loss_gen" in r]
    for r in train_rows:
        log(f"[torchrun] step {r['step']}: loss_gen {r['train/loss_gen']:.4f}, loss_disc "
            f"{r['train/loss_disc']:.4f}, {r['perf/step_time_s']:.3f} s, peak "
            f"{r.get('perf/peak_mem_gib', float('nan')):.2f} GiB")
    vals = [c for c in first["calls"] if c["kind"] == "validate"]
    routes = vals[0]["routes"] if vals else {}
    want = {BF16: N_BINS * (COND_BLOCKS + SCORE_BLOCKS) * RUN_VAL_PAIRS,
            F32: PATH_LAUNCHES * min(RUN_VAL_PAIRS, MAX_ENH)}
    ckpts = sorted(glob.glob(os.path.join(run_dir, "checkpoints", "*.ckpt")))
    log(f"[torchrun] {first['world']} process ({first['backend']}), {len(train_rows)} steps, "
        f"{len(vals)} validation: launches {routes} (expected {want}); steps launched "
        f"{first['steps_launches']}; checkpoints {[os.path.basename(c) for c in ckpts]}; "
        f"not float32 {first['not_float32'][:3]}; {first['torchrun_wall_s']:.1f} s")
    if (first["world"], first["backend"]) != (1, "nccl") or len(train_rows) != RUN_STEPS \
            or len(vals) != 1 or routes != want or set(vals[0]["entries"]) != {ENTRY} \
            or first["steps_launches"] \
            or first["not_float32"] or len(ckpts) != 2 or not all(
                np.isfinite(v) for r in train_rows for k, v in r.items() if k.startswith("train/")):
        raise AssertionError(f"torchrun run: {first}")
    resumed = torchrun({"mode": "resume", "args": args + [f"path.exp_root={exp}/resumed"],
                        "ckpt": ckpts[0], "out": os.path.join(tmp, "resumed.json")})
    log(f"[torchrun] resumed from {os.path.basename(ckpts[0])}: restored state differs at "
        f"{resumed['bad'][:5]} ({len(resumed['bad'])} paths); counts {resumed['counts']} "
        f"(the checkpoint's {resumed['want']}); then step {resumed['step']}, updates "
        f"{resumed['updates']}; {resumed['torchrun_wall_s']:.1f} s")
    if resumed["bad"] or resumed["counts"] != resumed["want"] or \
            resumed["want"]["mini_steps"] != [1, 1] or resumed["step"] != RUN_STEPS or \
            resumed["updates"] != [2, 2]:
        raise AssertionError(f"torchrun resume: {resumed}")
    trained = phase_trained_checkpoint(ckpts[-1])
    shutil.rmtree(tmp, ignore_errors=True)
    return {"gloo": gloo, "torchrun": {
        "steps": RUN_STEPS, "batch": TRAIN_BATCH, "overrides": RUN_OVERRIDES,
        "step_s": [r["perf/step_time_s"] for r in train_rows],
        "peak_mem_gib": first["peak_mem_gib"], "validation_launches": routes,
        "validation_entries": vals[0]["entries"],
        "validation_timing": vals[0]["timing"], "fit_s": first["fit_s"],
        "wall_s": first["torchrun_wall_s"], "resume_wall_s": resumed["torchrun_wall_s"],
        "resumed_mini_steps": resumed["want"]["mini_steps"],
        "trained_checkpoint_enhance": trained}}


def phase_parity_resample(ckpt: str):
    """12d: ``bin.parity`` (in this process, default device) on ``ckpt`` over
    PARITY_PAIRS synthetic 2 s noisy/clean pairs: the report written, every
    row finite, 94 launches (one batch); then ``bin.resample`` (its own
    process) on phase 7's tree of files: every wav at 16 kHz."""
    import shutil

    from open_universe_tpu_torch.bin import parity
    from open_universe_tpu_torch.data.audio import load_audio
    from open_universe_tpu_torch.ops.kernels import conv_block

    tmp = tempfile.mkdtemp()
    write_pairs(tmp, PARITY_PAIRS, CLIP_S, seed=22, split="test")
    out = os.path.join(tmp, "parity")
    conv_block.launches.clear()
    t0 = time.perf_counter()
    rc = parity.main(["--model", ckpt, "--noisy-dir", os.path.join(tmp, "test", "noisy"),
                      "--clean-dir", os.path.join(tmp, "test", "clean"), "--output", out,
                      "--metrics", "si-sdr", "lsd", "stoi-ext"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = by_entry(dict(conv_block.launches))
    with open(os.path.join(out, "parity_report.json")) as f:
        report = json.load(f)
    log(f"[parity] rc {rc}, {wall:.1f} s, launches {launches}; report "
        f"{[(r['metric'], r['ours'], r.get('delta')) for r in report['rows']]}, parity "
        f"{report['parity']}")
    if rc != 0 or report["n_files"] != PARITY_PAIRS or sum(launches.values()) != PATH_LAUNCHES \
            or not all(np.isfinite(r["ours"]) for r in report["rows"]):
        raise AssertionError(f"parity CLI: rc {rc}, launches {launches}, {report}")
    src, dst = os.path.join(tmp, "tree"), os.path.join(tmp, "resampled")
    write_tree(src, CLI_FILES)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "open_universe_tpu_torch.bin.resample", src,
                           dst, "--fs", str(FS), "--workers", "2"],
                          cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
                          text=True, timeout=300)
    wavs = [f for f in CLI_FILES if f[0].endswith(".wav")]
    got = {}
    for name, fs, _, seconds in wavs:
        x, fs_out = load_audio(os.path.join(dst, name))
        got[name] = (fs_out, x.shape[-1], math.ceil(int(fs * seconds) * FS / fs))
    log(f"[resample] rc {proc.returncode}, {time.perf_counter() - t0:.1f} s: (rate, length, "
        f"expected length) {got}")
    if proc.returncode != 0 or any(v[0] != FS or v[1] != v[2] for v in got.values()):
        raise AssertionError(f"resample CLI: {proc.returncode} {proc.stderr[-2000:]} {got}")
    shutil.rmtree(tmp, ignore_errors=True)
    return {"parity_launches": launches, "parity_report": report["rows"], "parity_wall_s": wall,
            "resampled": {k: list(v) for k, v in got.items()}}


# ---------------------------------------------------------------- phase 13
# 13a: the published wav2vec2-lv-60-espeak-cv-ft widths (LV60_ESPEAK) with
# seeded random weights, written as a Hugging Face checkpoint directory; the
# loss timed at PHONEME_BATCH x 2 s; 13b: phase 11a's LoRA run with the
# phoneme loss on; 13c: 11b with a tiny random wav2vec2 (PHONEME_TINY, the
# CPU tests' config); 13d: lps on 13a's directory
PHONEME_BATCH, PHONEME_RUNS, PHONEME_WARMUP = 4, 5, 2
PHONEME_TINY = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                    intermediate_size=64, conv_dim=(16, 16, 16), conv_stride=(5, 2, 2),
                    conv_kernel=(10, 3, 3), vocab_size=40, do_stable_layer_norm=True,
                    feat_extract_norm="layer", pad_token_id=0)
# card vs CPU logits, over max(1, max|CPU|): f32 throughout (TF32 off), and
# PyTorch's defaults (cuDNN's convs in TF32: a 10-bit mantissa)
PHONEME_LOGIT_TOL = {"tf32_off": 1e-4, "tf32_on": 5e-2}


def espeak_vocab(n: int) -> dict:
    """A vocab.json of n ids: the four special tokens, then p4 .. p<n-1>."""
    special = ["<pad>", "<s>", "</s>", "<unk>"]
    return {t: i for i, t in enumerate(special + [f"p{i}" for i in range(len(special), n)])}


def write_wav2vec2(directory: str, cfg, seed: int) -> str:
    """A seeded random Wav2Vec2ForCTC of cfg as a Hugging Face checkpoint
    directory (config.json, pytorch_model.bin, vocab.json)."""
    import dataclasses

    from open_universe_tpu_torch.nn.wav2vec2 import Wav2Vec2ForCTC

    torch.manual_seed(seed)
    with torch.device(DEVICE):
        model = Wav2Vec2ForCTC(cfg)
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump({**dataclasses.asdict(cfg), "model_type": "wav2vec2"}, f)
    with open(os.path.join(directory, "vocab.json"), "w") as f:
        json.dump(espeak_vocab(cfg.vocab_size), f)
    torch.save({k: v.cpu() for k, v in model.state_dict().items()},
               os.path.join(directory, "pytorch_model.bin"))
    del model
    torch.cuda.empty_cache()
    return directory


def w2v_flops(cfg, n: int) -> float:
    """FLOPs (2 per multiply-add) of one wav2vec2 forward on n samples: the
    conv stack, the projection, the positional conv, the encoder layers
    (q/k/v/out, the attention's two products, the FFN) and the head."""
    t, cin, flops = n, 1, 0.0
    for c, k, st in zip(cfg.conv_dim, cfg.conv_kernel, cfg.conv_stride):
        t = (t - k) // st + 1
        flops += 2 * k * cin * c * t
        cin = c
    d, f = cfg.hidden_size, cfg.intermediate_size
    flops += 2 * cin * d * t
    flops += 2 * cfg.num_conv_pos_embeddings * (d // cfg.num_conv_pos_embedding_groups) * d * t
    flops += cfg.num_hidden_layers * (8 * d * d * t + 4 * t * t * d + 4 * d * f * t)
    return flops + 2 * d * cfg.vocab_size * t


def phoneme_pairs(b: int, seed: int):
    """b (clean, noisy) rows of 2 s at 16 kHz: write_pairs' tones in noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(CLIP_S * FS)) / FS
    clean = np.stack([0.1 * np.sin(2 * np.pi * rng.uniform(100, 300) * t)
                      * (1 + 0.5 * np.sin(2 * np.pi * 3 * t)) for _ in range(b)])
    clean += 0.01 * rng.standard_normal(clean.shape)
    noisy = clean + 0.05 * rng.standard_normal(clean.shape)
    return clean.astype(np.float32), noisy.astype(np.float32)


def phase_phoneme_predictor():
    """13a: LV60_ESPEAK (~315M parameters) with seeded random weights,
    written as a Hugging Face directory and read back by ``load_pretrained``;
    the predictor's logits of a 2 x 2 s batch on the card against the CPU
    (PHONEME_LOGIT_TOL); ``PhonemeCTCLoss`` forward and backward at batch
    PHONEME_BATCH x 2 s under PyTorch's TF32 defaults, timed with CUDA
    events (the median of PHONEME_RUNS after PHONEME_WARMUP), and the
    predictor's forward alone; the peak memory of the loss.  Also writes the
    tiny random wav2vec2 of 13c."""
    import copy

    from open_universe_tpu_torch.losses.phoneme_loss import PhonemeCTCLoss, PhonemePredictor
    from open_universe_tpu_torch.nn.wav2vec2 import LV60_ESPEAK, Wav2Vec2Config, load_pretrained

    tmp = tempfile.mkdtemp()
    t0 = time.perf_counter()
    root = write_wav2vec2(os.path.join(tmp, "lv60"), LV60_ESPEAK, seed=131)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_model = load_pretrained(root)
    load_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in cpu_model.parameters())
    card_model = copy.deepcopy(cpu_model).to(DEVICE)
    clean, noisy = phoneme_pairs(PHONEME_BATCH, seed=132)
    x2 = torch.from_numpy(noisy[:2])
    with torch.no_grad():
        ref = PhonemePredictor(model=cpu_model)(x2)
        diffs = {}
        for tag, on in (("tf32_off", False), ("tf32_on", True)):
            tf32_flags(on)
            try:
                got = PhonemePredictor(model=card_model)(x2.to(DEVICE)).cpu()
            finally:
                tf32_flags(False)
            diffs[tag] = (got - ref).abs().max().item() / max(1.0, ref.abs().max().item())
    del cpu_model
    log(f"[phoneme] LV60_ESPEAK, {n_params / 1e6:.1f}M parameters, seeded random: written in "
        f"{write_s:.1f} s, load_pretrained {load_s:.1f} s; logits (2 x 2 s, {tuple(ref.shape)}, "
        f"max|CPU| {ref.abs().max().item():.3f}) card vs CPU, max|d| / max(1, max|CPU|): "
        + ", ".join(f"{k} {v:.3e} (bound {PHONEME_LOGIT_TOL[k]:.0e})" for k, v in diffs.items()))
    if not all(diffs[k] <= PHONEME_LOGIT_TOL[k] for k in diffs):
        raise AssertionError(f"wav2vec2 logits card vs CPU: {diffs}")

    loss = PhonemeCTCLoss(model=card_model)
    pred = loss.phoneme_predictor
    est, tgt = torch.from_numpy(noisy).to(DEVICE), torch.from_numpy(clean).to(DEVICE)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()

    def timed(fn):
        ms = []
        for _ in range(PHONEME_WARMUP + PHONEME_RUNS):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
        return float(np.median(ms[PHONEME_WARMUP:])), ms, out

    def loss_step():
        e = est.clone().requires_grad_(True)
        v = loss(e, tgt)
        v.backward()
        return v.item(), e.grad.abs().max().item()

    tf32_flags(True)
    try:
        loss_ms, loss_all, (value, gmax) = timed(loss_step)
        peak = torch.cuda.max_memory_allocated() / 2**30
        with torch.no_grad():
            fwd_ms, _, _ = timed(lambda: pred(est))
    finally:
        tf32_flags(False)
    flops = w2v_flops(LV60_ESPEAK, est.shape[1]) * PHONEME_BATCH
    result = {"parameters": n_params, "dir": root, "tiny_dir": None, "write_s": write_s,
              "load_s": load_s, "logits_rel": diffs, "batch": PHONEME_BATCH, "clip_s": CLIP_S,
              "loss_ms": loss_ms, "loss_ms_runs": loss_all, "forward_ms": fwd_ms,
              "forward_gflop": flops / 1e9, "forward_tflops": flops / fwd_ms / 1e9,
              "forward_bound_ms": flops / CUDA_CORE_F32_FLOPS * 1e3,
              "loss": value, "grad_max": gmax, "weights_gib": base, "peak_gib": peak}
    log(f"[phoneme] {card_line()}: PhonemeCTCLoss forward + backward at batch "
        f"{PHONEME_BATCH} x 2 s (cuDNN TF32 on, matmul TF32 off), median of {PHONEME_RUNS} "
        f"after {PHONEME_WARMUP}: {loss_ms:.2f} ms (runs {[round(m, 2) for m in loss_all]}); "
        f"predictor forward {fwd_ms:.2f} ms = {flops / 1e9:.1f} GFLOP at "
        f"{result['forward_tflops']:.1f} TFLOP/s (f32 CUDA-core bound "
        f"{result['forward_bound_ms']:.2f} ms); loss {value:.4f}, max|grad| {gmax:.3e}; "
        f"memory: weights {base:.2f} GiB, peak {peak:.2f} GiB")
    if not (np.isfinite(value) and np.isfinite(gmax) and gmax > 0):
        raise AssertionError(f"PhonemeCTCLoss at full width: loss {value}, max|grad| {gmax}")
    del loss, pred, card_model, est, tgt
    torch.cuda.empty_cache()
    result["tiny_dir"] = write_wav2vec2(os.path.join(tmp, "tiny"),
                                        Wav2Vec2Config(**PHONEME_TINY), seed=133)
    return result


def phase_phoneme_lora(base_ckpt: str, w2v_dir: str, plain: dict, plain_ckpt: str):
    """13b: phase 11a's LoRA run (the entry point with
    experiment=universepp_lora_finetune on phase 8a's checkpoint, batch 4 x
    2 s, LORA_STEPS steps, a validation at the last, f32, PyTorch's TF32
    defaults) with the recipe's PhonemeCTCLoss on, on 13a's wav2vec2
    (``+model.losses.phonemeloss.kwargs.checkpoint``).  Checks: every loss
    finite, train/ and val/phonemeloss logged; 0 fused-kernel launches in
    the steps and the validation; the checkpoint's keys equal phase 11a's
    (no wav2vec2 tensor).  Step times and peak memory beside phase 11a's
    (``plain``)."""
    import glob

    from open_universe_tpu_torch.train.__main__ import main as train_main

    tmp = tempfile.mkdtemp()
    data, exp = os.path.join(tmp, "data"), os.path.join(tmp, "exp")
    write_pairs(data, LORA_PAIRS, TRAIN_PAIR_S, seed=12)
    write_pairs(data, LORA_VAL_PAIRS, np.linspace(1.3, 2.5, LORA_VAL_PAIRS), seed=13,
                split="val")
    args = [f"experiment={LORA}", f"device={DEVICE}", f"model.model={base_ckpt}",
            f"+model.losses.phonemeloss.kwargs.checkpoint={w2v_dir}",
            f"datamodule.datasets.vb-train-16k.audio_path={data}",
            f"trainer.max_steps={LORA_STEPS}", f"trainer.val_check_interval={LORA_STEPS}",
            f"trainer.checkpoint_every={LORA_CKPT_EVERY}", "trainer.log_every=1",
            f"path.exp_root={exp}", "train=false", *LORA_OVERRIDES]
    torch.cuda.reset_peak_memory_stats()
    tf32_flags(True)
    try:
        with CountedEval() as counted:
            trainer = train_main(args)
            t0 = time.perf_counter()
            trainer.fit()
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 2**30
    finally:
        tf32_flags(False)
    (run_dir,) = glob.glob(os.path.join(exp, LORA, "*"))
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    train_rows = [r for r in rows if "train/main_loss" in r]
    keys = LORA_LOSSES + ("train/phonemeloss", "grad/norm")
    for r in train_rows:
        log(f"[phoneme lora] step {r['step']}: " + ", ".join(
            f"{k} {r[k]:.5f}" for k in keys[:2] + keys[-2:])
            + f", {r['perf/step_time_s']:.3f} s, peak "
            f"{r.get('perf/peak_mem_gib', float('nan')):.2f} GiB")
    val = [r for r in rows if "val/phonemeloss" in r]
    if len(train_rows) != LORA_STEPS or not all(np.isfinite(r[k]) for r in train_rows
                                                 for k in keys) or len(val) != 1 or \
            not np.isfinite(val[0]["val/phonemeloss"]):
        raise AssertionError(f"LoRA with the phoneme loss: {train_rows}, validation {val}")
    if [c["kind"] for c in counted.calls] != ["validate"]:
        raise AssertionError(f"validations run: {[c['kind'] for c in counted.calls]}")
    launched = {"steps": counted.steps, "validation": sum(counted.calls[0]["launches"].values())}
    last = os.path.join(run_dir, "checkpoints", f"step_{LORA_STEPS:08d}.ckpt")
    got, want = (set(torch.load(c, map_location="cpu", weights_only=False)["state_dict"])
                 for c in (last, plain_ckpt))
    times = [r["perf/step_time_s"] for r in train_rows]
    result = {"steps": LORA_STEPS, "first_step_s": times[0],
              "median_step_s": float(np.median(times[1:])), "peak_mem_gib": peak, "fit_s": fit_s,
              "launches": launched, "phonemeloss": [r["train/phonemeloss"] for r in train_rows],
              "val_phonemeloss": val[0]["val/phonemeloss"],
              "validation_timing": counted.calls[0]["timing"], "state_keys": len(got),
              "without": {k: plain[k] for k in ("first_step_s", "median_step_s", "peak_mem_gib")}}
    log(f"[phoneme lora] {card_line()}: with PhonemeCTCLoss (lv-60 widths, random weights): "
        f"first step {times[0]:.3f} s, median after it {result['median_step_s']:.3f} s, peak "
        f"{peak:.2f} GiB; phase 11a without it: {plain['first_step_s']:.3f} s, "
        f"{plain['median_step_s']:.3f} s, {plain['peak_mem_gib']:.2f} GiB; val/phonemeloss "
        f"{val[0]['val/phonemeloss']:.4f}, validation {counted.calls[0]['timing']}; fused-kernel "
        f"launches {launched}; checkpoint keys {len(got)}, phase 11a's {len(want)}, differ "
        f"{sorted(got ^ want)[:5]}")
    if any(launched.values()) or got != want:
        raise AssertionError(f"LoRA with the phoneme loss: launches {launched}, keys not in "
                             f"both {sorted(got ^ want)[:8]}")
    # one traced step with the phoneme loss and one without it (the same
    # model and batch, the loss taken out of losses_func), each after an
    # untraced one: device busy time and idle share
    clean, noisy = phoneme_pairs(trainer.config["datamodule"]["train"]["dl_opts"]["batch_size"],
                                 seed=135)
    batch = {"clean": torch.from_numpy(clean[..., None]).to(DEVICE),
             "noisy": torch.from_numpy(noisy[..., None]).to(DEVICE)}
    gen = torch.Generator(device=DEVICE).manual_seed(136)
    funcs = trainer.model.losses_func
    phoneme_loss = funcs["phonemeloss"]
    result["profile"] = {}
    tf32_flags(True)
    try:
        for tag in ("with", "without"):
            if tag == "without":
                del funcs["phonemeloss"]
            trainer.step_fn(batch, generator=gen)
            result["profile"][tag] = device_profile(
                f"[phoneme lora] step {tag} the phoneme loss",
                lambda: trainer.step_fn(batch, generator=gen))
    finally:
        tf32_flags(False)
        funcs["phonemeloss"] = phoneme_loss
    del trainer
    torch.cuda.empty_cache()
    return result


def phase_lps(w2v_dir: str, ckpt: str):
    """13d: ``Metrics(["lps"])`` and ``EvalMetrics(lps=True)`` resolve the
    default checkpoint id to 13a's directory as a snapshot of a Hugging Face
    cache (``$HF_HUB_CACHE``) and score two clips enhanced by phase 8a's
    checkpoint against their clean references on the card.  Random weights:
    the check is that the path runs (finite values); the phoneme strings'
    lengths and the values are logged."""
    from open_universe_tpu_torch import metrics as pmetrics
    from open_universe_tpu_torch.inference.model_loader import load_model
    from open_universe_tpu_torch.nn.wav2vec2 import DEFAULT_CHECKPOINT

    tmp = tempfile.mkdtemp()
    snaps = os.path.join(tmp, "models--" + DEFAULT_CHECKPOINT.replace("/", "--"), "snapshots")
    os.makedirs(snaps)
    os.symlink(w2v_dir, os.path.join(snaps, "random"))
    clean, noisy = phoneme_pairs(2, seed=134)
    model = load_model(ckpt, device=DEVICE)
    enh = model.enhance(torch.from_numpy(noisy).to(DEVICE)).cpu().numpy()
    del model
    old = os.environ.get("HF_HUB_CACHE")
    os.environ["HF_HUB_CACHE"] = tmp
    try:
        t0 = time.perf_counter()
        metric = pmetrics.Metrics(["lps"], device=DEVICE)
        rows = metric(FS, enh, clean)
        pred = metric._lps.phoneme_predictor
        lengths = [(len(pred(e)), len(pred(c))) for e, c in zip(enh, clean)]
        evaluated = pmetrics.EvalMetrics(lps=True, dnsmos=False, device=DEVICE)(
            enh[:, None], clean[:, None])
        wall = time.perf_counter() - t0
    finally:
        if old is None:
            os.environ.pop("HF_HUB_CACHE")
        else:
            os.environ["HF_HUB_CACHE"] = old
    values = [r.get("lps", float("nan")) for r in rows]
    log(f"[lps] {card_line()}: Metrics(['lps']) on 2 enhanced 2 s clips (lv-60 widths, random "
        f"weights, predictor on {pred.device}): {values}, phoneme strings (enhanced, clean) "
        f"{lengths} characters; EvalMetrics(lps=True): {evaluated.get('lps')} (mean of "
        f"Metrics' {float(np.mean(values)):.6f}); {wall:.1f} s")
    if not (np.isfinite(values).all() and np.isfinite(evaluated.get("lps", np.nan))):
        raise AssertionError(f"lps: Metrics {rows}, EvalMetrics {evaluated}")
    del metric, pred
    torch.cuda.empty_cache()
    return {"metrics": values, "eval_metrics": evaluated["lps"], "string_lengths": lengths,
            "wall_s": wall}


# 14: tensor parallelism (two gloo ranks on cuda:0, dp = 1, tp = 2)
TP_WORLD, TP_BATCH, TP_STEPS = 2, 16, 4
TP_OVERRIDES = ["model.training.compute_dtype=bf16", "model.training.remat=true"]


def tp_job(out_dir: str, device, width, batch_size) -> dict:
    """TP_STEPS UNIVERSE++ GAN steps (``universepp_vb_16k`` at ``width``,
    TRAIN_OVERRIDES by default, with TP_OVERRIDES) through a ``Trainer``
    built as the entry point builds it (weights from seed 3; under a tp
    mesh each rank keeps its slices of the parameters JAX's rule shards),
    on ``batch_size`` x 2 s synthetic batches with fixed draws, then its
    checkpoint: each step's metrics and time, step 1's gradients and the
    parameters and EMA after the last step (whole, on the host), what this
    process holds, its peak memory, the kernel launches of the steps and
    the checkpoint's path."""
    from open_universe_tpu_torch.configs.registry import instantiate_trainable
    from open_universe_tpu_torch.configs.resolve import compose
    from open_universe_tpu_torch.ops.kernels import conv_block
    from open_universe_tpu_torch.parallel import tp
    from open_universe_tpu_torch.train.trainer import Trainer, optimizers

    cuda = device.type == "cuda"
    cfg = compose(config_dir(), ["experiment=universepp_vb_16k", *width, *TP_OVERRIDES])
    model = instantiate_trainable(cfg["model"])
    tr = Trainer(model, None, out_dir, max_steps=cfg["trainer"]["max_steps"], seed=3,
                 device=device, config={k: v for k, v in cfg.items() if not k.startswith("_")})
    step, dims = tr.step_fn, tp.dims(model)

    def whole(tensors):
        return {n: v.detach().cpu() for n, v in tp.gather_state(tensors, dims).items()}

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    rng = np.random.default_rng(7)
    t = int(CLIP_S * FS)
    out = {"losses": [], "step_s": []}
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    conv_block.launches.clear()
    for i in range(TP_STEPS):
        batch = synthetic_batch(batch_size, t, seed=30 + i, device=device)
        draws = {"u": rng.uniform(size=batch_size),
                 "z": rng.standard_normal((batch_size, t, 1))}
        draws = {k: torch.from_numpy(v.astype(np.float32)).to(device) for k, v in draws.items()}
        t0 = time.perf_counter()
        m = step(batch, draws=draws, disc_frozen=i < model.disc_freeze_step)
        sync()
        out["step_s"].append(time.perf_counter() - t0)
        out["losses"].append({k: float(v) for k, v in m.items()})
        if i == 0:
            out["grads"] = whole({n: p.grad for n, p in model.named_parameters()
                                  if p.grad is not None})
    out["launches"] = sum(conv_block.launches.values())
    out["peak_mem_gib"] = torch.cuda.max_memory_allocated(device) / 2**30 if cuda else 0.0
    out["params"] = whole(dict(model.named_parameters()))
    out["ema"] = whole(step.ema.shadow)
    opts = optimizers(step)
    held = {"params": list(model.parameters()),
            "grads": [p.grad for p in model.parameters() if p.grad is not None],
            "moments": [v for o, _, _ in opts for st in o.state.values() for v in st.values()
                        if torch.is_tensor(v) and v.dim() > 0],
            "ema": list(step.ema.shadow.values())}
    out["held_bytes"] = {k: sum(v.numel() * v.element_size() for v in vs)
                         for k, vs in held.items()}
    out["sharded"] = dict(dims)
    out["ckpt"] = str(tr.save(TP_STEPS))
    return out


def tp_worker(rank: int, init: str, out_dir: str, device: str, width, batch_size) -> None:
    """One process of 14 on ``device``: a gloo rank of the dp = 1, tp = 2
    mesh, or (rank -1) the process alone; ``tp_job``'s arguments."""
    import torch.distributed as dist

    from open_universe_tpu_torch.parallel import mesh

    if rank >= 0:
        dist.init_process_group("gloo", init_method=f"file://{init}", world_size=TP_WORLD,
                                rank=rank)
        mesh.make_mesh(1, TP_WORLD)
    try:
        tf32_flags(False)
        torch.backends.cudnn.deterministic = True
        name = f"rank{rank}" if rank >= 0 else "alone"
        run_dir = os.path.join(out_dir, "tp" if rank >= 0 else "alone")
        torch.save(tp_job(run_dir, torch.device(device), width, batch_size),
                   os.path.join(out_dir, f"{name}.pt"))
    finally:
        if rank >= 0:
            dist.destroy_process_group()


def nccl_refusal() -> dict:
    """The training entry point as one NCCL process under torchrun with
    ``trainer.mesh_tp=2``: it must exit non-zero naming the mismatch."""
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1",
         "-m", "open_universe_tpu_torch.train", "experiment=universepp_vb_16k",
         f"device={DEVICE}", "trainer.mesh_tp=2"],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True,
        timeout=300)
    text = proc.stdout + proc.stderr
    named = "trainer.mesh_tp=2 needs 2 processes but the job has 1" in text
    log(f"[tp refusal] torchrun --nproc_per_node 1 with trainer.mesh_tp=2: exit "
        f"{proc.returncode}; names the mismatch: {named}")
    if proc.returncode == 0 or not named:
        raise AssertionError(f"tp refusal: exit {proc.returncode}: {text[-3000:]}")
    return {"exit": proc.returncode, "names_mismatch": named}


def phase_tensor_parallel():
    """14: two gloo ranks on cuda:0 (dp = 1, tp = 2) and one process alone
    (tp = 1), each TP_STEPS full-width GAN steps (bf16 + remat, batch
    TP_BATCH x 2 s, fixed draws, TF32 off, cuDNN deterministic) through the
    trainer: the ranks agree bit for bit; step 1's losses equal the one
    process's; every step's losses within 1e-6 relative; gradients,
    parameters and EMA as ``compare_runs`` says; each rank holds half of
    every sharded parameter, gradient, moment and shadow; 0 launches; the
    checkpoint of the tp ranks has the one process's keys and shapes, and
    ``load_model`` + ``enhance`` on it launch 94 (58 + 36) and match the
    kernels off (8c).  Then one NCCL process with trainer.mesh_tp=2 under
    torchrun refuses."""
    import shutil

    tmp = tempfile.mkdtemp()
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=tp_worker, args=(r, os.path.join(tmp, "rendezvous"), tmp,
                                                 DEVICE, TRAIN_OVERRIDES, TP_BATCH))
             for r in (0, 1, -1)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=900)
        if p.is_alive():
            p.kill()
    if [p.exitcode for p in procs] != [0] * 3:
        raise AssertionError(f"tp processes exited {[p.exitcode for p in procs]}")
    wall = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False) for r in (0, 1)]
    one = torch.load(os.path.join(tmp, "alone.pt"), weights_only=False)
    r0, r1 = ranks
    first = {k: v for k, v in one["losses"][0].items() if not k.startswith("grad/")}
    first_equal = all(r0["losses"][0][k] == v for k, v in first.items())
    ranks_differ = [n for n, p in r0["params"].items() if not torch.equal(p, r1["params"][n])]
    ranks_differ += [f"ema {n}" for n, s in r0["ema"].items() if not torch.equal(s, r1["ema"][n])]
    cmp = compare_runs("tp", r0, one, rel=1e-4, ema=True)
    shapes = [{p: tuple(t.shape) for p, t in _tensors(torch.load(
        r["ckpt"], map_location="cpu", weights_only=False))} for r in (r0, one)]
    half = {k: r0["held_bytes"][k] / one["held_bytes"][k] for k in one["held_bytes"]}
    sharded_bytes = sum(p.numel() * 4 for n, p in one["params"].items() if n in r0["sharded"])
    log(f"[tp] {card_line()}: {TP_WORLD} gloo ranks on one {DEVICE} device (dp 1, tp 2) "
        f"vs one process, {TP_STEPS} steps at batch {TP_BATCH} x 2 s, {TP_OVERRIDES}: step 1 "
        f"losses equal {first_equal}; ranks differ at {len(ranks_differ)} tensors; sharded "
        f"parameters {len(r0['sharded'])} of {len(one['params'])} ({sharded_bytes / 2**20:.1f} of "
        f"{sum(p.numel() * 4 for p in one['params'].values()) / 2**20:.1f} MiB whole); held "
        f"per rank / one process: " + ", ".join(
            f"{k} {r0['held_bytes'][k] / 2**20:.1f} / {one['held_bytes'][k] / 2**20:.1f} MiB"
            for k in one["held_bytes"]))
    log(f"[tp] peak memory: rank 0 {r0['peak_mem_gib']:.2f}, rank 1 {r1['peak_mem_gib']:.2f}, "
        f"one process {one['peak_mem_gib']:.2f} GiB; step s: rank 0 "
        f"{[round(s, 3) for s in r0['step_s']]}, one process "
        f"{[round(s, 3) for s in one['step_s']]} (gloo through the host: a correctness run); "
        f"launches in the steps {r0['launches']}, {r1['launches']}, {one['launches']}; "
        f"checkpoint keys and shapes equal: {shapes[0] == shapes[1]}; {wall:.1f} s")
    if not first_equal or ranks_differ or shapes[0] != shapes[1] or \
            r0["launches"] or r1["launches"] or one["launches"] or not r0["sharded"] or \
            not all(0.4 < v < 1.0 for k, v in half.items()):
        raise AssertionError(f"tp: first losses equal {first_equal}, ranks {ranks_differ[:3]}, "
                             f"shapes {shapes[0] == shapes[1]}, launches "
                             f"{[r0['launches'], r1['launches'], one['launches']]}, held {half}")
    trained = phase_trained_checkpoint(r0["ckpt"])
    refusal = nccl_refusal()
    shutil.rmtree(tmp, ignore_errors=True)
    return {"world": TP_WORLD, "dp": 1, "tp": TP_WORLD, "batch": TP_BATCH,
            "steps": TP_STEPS, "overrides": TP_OVERRIDES, "first_losses_equal": first_equal,
            **cmp, "sharded_parameters": len(r0["sharded"]),
            "parameters": len(one["params"]), "sharded_mib": sharded_bytes / 2**20,
            "held_mib": {f"rank{i}": {k: v / 2**20 for k, v in r["held_bytes"].items()}
                         for i, r in enumerate(ranks)},
            "held_mib_alone": {k: v / 2**20 for k, v in one["held_bytes"].items()},
            "peak_mem_gib": {"rank0": r0["peak_mem_gib"], "rank1": r1["peak_mem_gib"],
                             "alone": one["peak_mem_gib"]},
            "step_s": {"rank0": r0["step_s"], "rank1": r1["step_s"], "alone": one["step_s"]},
            "launches_per_step": [r0["launches"] / TP_STEPS, one["launches"] / TP_STEPS],
            "wall_s": wall, "trained_checkpoint_enhance": trained, "nccl_refusal": refusal}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import open_universe_tpu_torch  # noqa: F401  (fails outside the repo)

    t_start = time.perf_counter()
    phase_s, t_last = {}, [t_start]

    def lap(name):
        """The wall seconds of the phase that just ended."""
        now = time.perf_counter()
        phase_s[name], t_last[0] = now - t_last[0], now
        log(f"[time] {name}: {phase_s[name]:.1f} s")

    build_s, ptxas = phase_build()
    lap("1 build")
    worst = phase_kernel_vs_plain()
    worst_rows = phase_kernel_vs_plain(rows=True)
    lap("2 kernel vs plain")
    model, counts, counts_bf16, path_diff, rate16 = phase_main_path()
    lap("3 main path")
    step0 = phase_step0(model)
    lap("3d step 0")
    hz24, shapes_24k, rate24 = phase_24k()
    lap("3c 24 kHz")
    rate = phase_rate_change(model, rate16, rate24)
    lap("3e rate change")
    main_counts = {**counts, **counts_bf16}  # keys differ by route
    rates, shapes, mix, noise = phase_timing(model, by_shape(counts))
    lap("4 timing")
    small_rates, small_shapes, (mix1, noise1) = phase_small_batch(
        model, {k: n for k, n in by_shape(counts).items() if k[0] < 128})
    crossover = phase_crossover()
    lap("4b small batch")
    profiled = phase_profile(model, mix, noise)
    profiled_1 = phase_profile(model, mix1, noise1, runs=(("batch 1", True),))
    lap("5 profile")
    del model, mix, noise
    served, serve_entries = phase_serving()
    lap("6 serving")
    cli, cli_launches = phase_cli()
    lap("7 cli")
    tf32 = phase_tf32_inference()
    lap("7b tf32")
    training, ckpt = phase_training()
    lap("8a training")
    training["card_vs_cpu"] = phase_train_step_vs_cpu()
    lap("8b card vs cpu")
    trained = phase_trained_checkpoint(ckpt)
    lap("8c trained checkpoint")
    validation = phase_validation()
    lap("9 validation")
    original, orig_ckpt = phase_original_training()
    lap("10a/c plain UNIVERSE training, validation, resume")
    original["card_vs_cpu"] = phase_original_step_vs_cpu()
    lap("10b plain UNIVERSE card vs cpu")
    original["trained_checkpoint"] = phase_original_checkpoint(orig_ckpt)
    lap("10d plain UNIVERSE checkpoint")
    original["compressed_mag_stft_vs_cpu"] = phase_transform_vs_cpu()
    lap("10e CompressedMagSTFT")
    lora, lora_ckpt = phase_lora_training(ckpt)
    lap("11a/c LoRA fine-tuning, validation, test, resume")
    lora["card_vs_cpu"] = phase_lora_step_vs_cpu()
    lap("11b LoRA card vs cpu")
    lora["checkpoint"] = phase_lora_checkpoint(lora_ckpt)
    lap("11d LoRA checkpoint")
    lora["aux_gan"] = phase_aux_gan()
    lap("11e UNIVERSE++ aux loss")
    scale = phase_scale()
    lap("12a bf16 and remat")
    scale["accumulation"] = phase_accumulation(scale["arms"]["f32"])
    lap("12b accumulation")
    scale["data_parallel"] = phase_data_parallel()
    lap("12c data parallelism")
    scale["clis"] = phase_parity_resample(ckpt)
    lap("12d parity and resample CLIs")
    phoneme = phase_phoneme_predictor()
    lap("13a wav2vec2 predictor and loss")
    phoneme["lora"] = phase_phoneme_lora(ckpt, phoneme["dir"], lora, lora_ckpt)
    lap("13b LoRA with the phoneme loss")
    phoneme["card_vs_cpu"] = phase_lora_step_vs_cpu(
        phoneme=[f"+model.losses.phonemeloss.kwargs.checkpoint={phoneme['tiny_dir']}"],
        name="phoneme-vs-cpu")
    if "train/phonemeloss" not in phoneme["card_vs_cpu"]["losses_rel"]:
        raise AssertionError("13c: the narrow step logged no phoneme loss")
    lap("13c phoneme LoRA step card vs cpu")
    phoneme["lps"] = phase_lps(phoneme["dir"], ckpt)
    lap("13d lps")
    tensor_parallel = phase_tensor_parallel()
    lap("14 tensor parallelism")
    log(f"[done] {time.perf_counter() - t_start:.1f} s")

    def total(key, shapes=shapes):
        return sum(s[key] * s["launches"] for s in shapes)

    def sums(shapes, key=""):
        """Per-enhance sums over shapes timed alone, times their launches,
        of the bf16 (key "") or the f32 (key "f32_") route."""
        bytes_ms, ops_ms = total(f"{key}bytes_ms", shapes), total(f"{key}ops_ms", shapes)
        return {f"{key}ms": total(f"{key}ms", shapes),
                # mma.sync at the widths that have it (f32_mma_sync_widths)
                **({"f32_mma_sync_ms": sum(s["f32_mma_sync_ms"] * s["launches"]
                                           for s in shapes if s["f32_mma_sync_ms"] is not None),
                    "f32_mma_sync_widths": sorted({s["C"] for s in shapes
                                                   if s["f32_mma_sync_ms"] is not None}),
                    "f32_cores": sorted({f"{s['f32_core']} {s['C']}" for s in shapes})}
                   if key else {}),
                f"{key}plain_ms": total(f"{key}plain_ms", shapes),
                f"{key}bound_ms": sum(max(s[f"{key}bytes_ms"], s[f"{key}ops_ms"])
                                      * s["launches"] for s in shapes),
                f"{key}bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                f"{key}library_ms": None,
                f"{key}unfused_ms": total(f"{key}unfused_ms", shapes)}

    def cuda_core_bound(shapes):
        """The f32 bound at the CUDA cores' rate (the earlier f32 kernel's)."""
        return sum(max(s["f32_bytes_ms"], s["f32_ops_ms"] * PEAK_FLOPS[torch.float32]
                       / CUDA_CORE_F32_FLOPS) * s["launches"] for s in shapes)


    kernel_line = {"kernels": [{
        "name": "fused_conv_chain",
        "route": "cuda",
        "source": "open_universe_tpu_torch/csrc/conv_block_tc.cu",
        "replaces": "open_universe_tpu/ops/pallas/conv_block.py:180",
        # launches in phase 3's two runs (batch 2, f32 and bf16: every block
        # each time)
        "launches": sum(main_counts.values()),
        "max_abs_err": max(worst.values()),
        # per enhance of batch 128 x 2 s in bf16 (all 94 blocks, tensor-core
        # route): each (C, T, FiLM, cond) timed alone, times its launches in
        # phase 3; the f32_* keys are the 3xTF32 route at the same shapes
        **sums(shapes), **sums(shapes, "f32_"),
        "f32_cuda_core_bound_ms": cuda_core_bound(shapes),
        "routes": {BF16: "open_universe_tpu_torch/csrc/conv_block_tc.cu",
                   F32: "open_universe_tpu_torch/csrc/conv_block_tc.cu",
                   "launches": by_route(main_counts)},
        "max_abs_err_by_route": worst,
        "widths": list(WIDTH_LENGTHS) + list(WIDTH_LENGTHS_24K),
        "audio_s_per_s": rates,
        "main_path_kernel_vs_unfused": path_diff,
        "build_s": build_s,
        "phase_s": phase_s,
        "registers": {k["kernel"]: k["registers"] for ks in ptxas.values() for k in ks},
        "spills": [k["kernel"] for ks in ptxas.values() for k in ks if k["spills"]],
        # universepp_24k.yaml: enhance at f32 (phase 3c), shapes at batch 128
        # (each shape's numbers are on the [24k] lines above)
        "universepp_24k": {**hz24, **sums(shapes_24k), **sums(shapes_24k, "f32_"),
                           "f32_cuda_core_bound_ms": cuda_core_bound(shapes_24k)},
        "profile": profiled,
        # phase 4b: enhance at batch 1 and 16; per enhance of batch 16 x 2 s,
        # the shapes of C < 128 timed alone as above; both f32 cores alone
        # at batch 1..16 where a width has both
        "enhance_small_batch": small_rates,
        "batch16_small_widths": {**sums(small_shapes), **sums(small_shapes, "f32_"),
                                 "f32_cuda_core_bound_ms": cuda_core_bound(small_shapes)},
        "core_crossover": crossover,
        "profile_batch1": profiled_1,
        # phase 6: the server and the launches of its requests
        "serving": served,
        "serving_launches": serve_entries,
        # phase 7: the enhance CLI's runs and their launches
        "cli": cli,
        "cli_launches": cli_launches,
        # phase 3d: what the kernel refuses runs unfused; phase 7b: cuDNN TF32
        "step0": step0, "tf32_inference": tf32,
        # phase 8: the training entry point (no launch in its steps; the
        # kernel has no backward) and its checkpoint enhanced through the kernel
        "training": training, "trained_checkpoint_enhance": trained,
        # phase 9: validation and test of the entry point (launches per
        # validation and per test), kernel vs kernels off
        "validation": validation,
        # phase 10: the plain UNIVERSE (generic score path): training (no
        # launch in its steps), its validation and test (launches), its
        # trained checkpoint's enhance and audio-s/s,
        # the CompressedMagSTFT models against the CPU
        "universe_original": original,
        # phase 11: LoRA fine-tuning (no launch while adapters are attached:
        # steps, validation, test, the adapter model's enhance and CLI),
        # merge_lora's enhance through the kernel, UNIVERSE++ with the aux loss
        "lora": lora,
        # phase 12: training at scale (bf16, remat, accumulation: 0 launches
        # in the steps), data parallelism (gloo ranks, the entry point under
        # torchrun: its validation's launches by route, its checkpoint's
        # enhance), the parity and resample CLIs
        "scale": scale,
        # phase 13: the phoneme loss and lps on the port's wav2vec2 (lv-60
        # widths, random weights): the loss's time, LoRA with it (0
        # launches: adapters attached), a narrow step vs the CPU, lps
        "phoneme": phoneme,
        # phase 14: tensor parallelism (2 gloo ranks on cuda:0, dp 1 x tp 2,
        # against one process; 0 launches in the steps) and the tp run's
        # checkpoint enhanced through the kernel
        "tensor_parallel": tensor_parallel,
    }, {
        "name": "fused_conv_chain_rows",
        "route": "cuda",
        "source": "open_universe_tpu_torch/csrc/conv_block_tc.cu",
        "replaces": "open_universe_tpu/ops/pallas/conv_block.py:216",
        # the JAX package's rows API on the same kernel: phase 2b only; no
        # ConvBlock calls it (0 launches in phase 3)
        "launches": sum(n for k, n in main_counts.items() if k[0] != ENTRY),
        "max_abs_err": max(worst_rows.values()),
        "max_abs_err_by_route": worst_rows,
    }, {
        "name": "rate_change",
        "route": "cuda",
        "source": "open_universe_tpu_torch/csrc/rate_change_tc.cu",
        # port-only: the JAX package runs XLA's strided and transposed convs
        "replaces": None,
        # launches in phase 3's f32 enhance (batch 2 x 2 s; its bf16 run: 0)
        "launches": sum(rate16.values()),
        "low_passed": low_passed(rate16),
        # phase 3e, per enhance of batch 128 x 2 s at 16 kHz: each shape alone
        # times its launches (ms; plain_ms, the plain version; module_ms, the
        # PReLUConv it replaces at PyTorch's default TF32; bound_ms, bytes at
        # 3.35 TB/s or products at 495 / 3 TFLOP/s), and the largest error
        # against the plain version (TF32 off)
        **rate["batch128_16k"],
        "universepp_24k": rate["batch128_24k"],
        # the shapes of a 1 s bucket at the server's batches
        "serving": {k: v for k, v in rate.items() if k.startswith("bucket1s")},
        # the batch sweep of both cores (points where the table's is slower)
        "sweep_slower": rate["sweep"]["slower"],
        # one traced f32 enhance at batch 128, with the kernel and the module
        "enhance_profiles": rate["profiles"],
    }]}
    for tag, sh in (("batch 128, 16 kHz", shapes), ("batch 128, 24 kHz", shapes_24k),
                    ("C < 128, batch 16", small_shapes)):
        f32 = sums(sh, "f32_")
        log(f"[bounds] f32 per enhance, {tag}: kernel {total('f32_ms', sh):.2f} ms "
            f"({f32['f32_mma_sync_ms']:.2f} on mma.sync at C = {f32['f32_mma_sync_widths']}), "
            f"bound {f32['f32_bound_ms']:.2f} ms at 3xTF32 (495 / 3 TFLOP/s), "
            f"{cuda_core_bound(sh):.2f} ms at the CUDA cores' 67 TFLOP/s")
        log_cores(tag, sh)
    print(card_line(), flush=True)
    print(json.dumps(kernel_line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--torchrun-train":
        sys.exit(torchrun_child(sys.argv[2]))
    sys.exit(main())
