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
   cores; f32 as 3xTF32 on the tensor cores): at the length the main path gives
   the width, T = 1, T = 5 (below a tile) and T = 1004 (a partial last tile
   on every route), FiLM and cond on and off.  One line per (C, dtype).
2b. The same for the kernel's rows entry (``fused_conv_chain_rows``) on
   lane-packed rows (B, T/P, P*C), P = max(1, 128 // C), at T = P, 5P, 1004
   and the main path's length.
3. Run the main path at full width: ``universepp(16000)`` with seeded random
   weights, weight norm folded, ``enhance`` on 2 x 2 s at 16 kHz, 8 steps,
   float32, once through the kernel and once through the unfused chain, on
   the same noise.  Both must agree, and the kernel run must launch the
   f32 route 94 times: at this batch (<= 64) through the rows entry at
   C < 128 and through the unpacked entry at C >= 128.  Then the same
   ``enhance`` with bf16 networks must launch the bf16 route 94 times with
   the same split.  The launches are counted by (entry, route, C, T, FiLM,
   cond).
3c. The 24 kHz model: a reference-layout checkpoint of the seeded
   ``universepp(24000)`` with ``config/model/universepp_24k.yaml``'s model
   node beside it, loaded by ``load_model`` through the port's registry
   (EMA applied, folded); ``enhance`` of 2 x 2 s at 24 kHz, 8 steps, f32,
   through the kernel and the unfused chain on the same noise: they agree
   within 1e-4, with 94 launches at C = 48..768 (C = 48 on the rows
   entry); one 2 s request served over HTTP (94 launches).  Then the
   kernel, its plain version and the unfused chain alone in bf16 and f32
   at each of its shapes at batch 128.
4. Time ``enhance`` in bench.py's setting (bf16 networks, batch 128 x 2 s,
   8 steps, every block through the unpacked entry) with the kernel and with
   the unfused chain, and the same ``enhance`` with f32 networks (the
   server's default) both ways; then time the kernel (and its f32 route),
   its plain version and the unfused chain alone at each (C, T, FiLM, cond)
   that phase 3 launched, weight each by its launches, and give each
   shape's TFLOP/s and bound share (f32 at the 3xTF32 rate, 495 / 3 TFLOP/s;
   the CUDA cores' 67 TFLOP/s bound of the earlier f32 kernel is printed
   beside it once).
4b. Time bf16 ``enhance`` on 2 s clips at batch 1 and 16; then the rows
   entry, its plain version and the unfused chain alone at each rows shape
   of phase 3 at batch 16, weighted by launches.
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
   shape; ``/stats`` counts every clip; the rows entry launched.  Then 5
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
   through both entries, and each run's lossless files, every bucket and
   every channel, equal the CLI's batches (or chunks) recomputed by
   ``enhance`` with the kernels off on a generator seeded as the CLI seeds
   it, cut and resampled as the CLI writes them (<= 1e-4 + 1/32767, the
   16-bit rounding).  The CLI's realtime factor,
   bucketed and chunked, is logged beside the card's name and power limit.

The last two lines are a JSON object with one entry per kernel (per-enhance
sums; each shape's numbers are on the log lines of phases 3c, 4 and 4b; the
CLI's launches per run of phase 7) and
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

FS = 16000
CLIP_S = 2.0
DEVICE = "cuda"
BUCKET_S = 1.0  # the server's length buckets
N_STEPS = 8
TIMING_BATCH = 128
SERVE_BATCH = 16
SOURCES = ("conv_block_tc",)
# ConvBlock width -> length on a 2 s clip: 16 kHz (universepp(16000)) and
# 24 kHz (config/model/universepp_24k.yaml)
WIDTH_LENGTHS = {32: 32160, 64: 16080, 128: 4020, 256: 1005, 512: 201}
WIDTH_LENGTHS_24K = {48: 48240, 96: 24120, 192: 8040, 384: 1608, 768: 201}
PARTIAL_T = 1004  # leaves a partial last time tile on every route and width
F32, BF16 = "f32_tensor_cores_3xtf32", "bf16_tensor_cores"  # conv_block.ROUTES' names
# ConvBlocks per enhance with 8 steps: 10 per score pass, 14 in the conditioner
PATH_LAUNCHES = 10 * N_STEPS + 14
PEAK_BYTES_PER_S = 3.35e12
# f32 runs as three TF32 products per product: a third of the 495 TFLOP/s
PEAK_FLOPS = {torch.float32: 495e12 / 3, torch.bfloat16: 989e12}
CUDA_CORE_F32_FLOPS = 67e12  # the bound of the earlier CUDA-core f32 kernel
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}

# first matching substring of a device kernel's lower-cased name names its
# group; casts and contiguous copies are copy kernels, pads a fill and a copy
GROUPS = (
    ("fused ConvBlock kernel", ("conv_block_kernel", "conv_block_tc_kernel")),
    ("GRU", ("rnn", "gru")),
    ("FFT", ("fft",)),
    ("cuDNN / library conv", ("conv", "fprop", "implicit", "winograd", "cudnn")),
    ("GEMM", ("gemm", "cutlass", "nvjet")),
    ("reduction", ("reduce",)),
    ("copy / cast / pad", ("copy", "fill")),
    ("elementwise", ("elementwise",)),
)
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
            kernel = re.search(r"\d+(conv_block\w*?_kernel)I", raw)
            prec = re.search(r"\d(F32|Bf16)E", raw)
            width = re.search(r"Li(\d+)E", raw)
            name = (f"{kernel.group(1)}<{prec.group(1) if prec else ''}, C={width.group(1)}>"
                    if kernel and width else raw)
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


def by_shape(counts, entry=None) -> dict:
    """Launches by (C, T, FiLM, cond), of one entry or of all."""
    out = {}
    for (e, _, *shape), n in counts.items():
        if entry in (None, e):
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


def phase_kernel_vs_plain(rows: bool = False):
    """Both routes at every width against the plain version; returns the
    largest max|kernel - plain| by route, for the unpacked entry or
    (rows=True) the rows entry."""
    from open_universe_tpu_torch.ops.kernels import conv_block

    tag = "rows" if rows else "kernel"
    worst = {}
    for c in conv_block.WIDTHS:
        p = max(1, 128 // c)
        for dtype in (torch.float32, torch.bfloat16):
            route = conv_block.ROUTES[dtype][0]
            err_c, rel_c = 0.0, 0.0
            cases = check_lengths(c, rows)
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
                for name, a, r in zip(("v", "cond_out"), got, ref):
                    if a.shape != r.shape:
                        raise AssertionError(f"{tag}: shape {tuple(a.shape)} != {tuple(r.shape)}")
                    err = (a.float() - r.float()).abs().max().item()
                    scale = r.float().abs().max().item()
                    if not (math.isfinite(err) and err <= TOL[dtype] * scale):
                        log(f"[{tag}] C={c} T={t} film={film:d} cond={cond:d} {route} "
                            f"{name}: max|d|={err:.3e} max|ref|={scale:.3e} FAIL")
                        raise AssertionError(f"{tag} kernel disagrees with its plain "
                                             f"version at C={c} T={t} {dtype} ({name})")
                    err_c, rel_c = max(err_c, err), max(rel_c, err / scale)
            log(f"[{tag}] C={c:3d} {route:23s} T={[t for t, *_ in cases]}: worst "
                f"max|d| {err_c:.3e} = {rel_c:.2e} max|ref| (bound {TOL[dtype]:g}) ok")
            worst[route] = max(worst.get(route, 0.0), err_c)
    return worst


def noise_draws(model, b, t, seed):
    """The sampler's N_STEPS standard-normal draws for a (b, t) input."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    shape = (b, t + model.tot_ds - t % model.tot_ds, 1)
    return [torch.randn(shape, generator=g, device=DEVICE) for _ in range(N_STEPS)]


def counted_enhance(model, mix, noise, dtype=None):
    """enhance with the kernels on; its output and the launches it made."""
    from open_universe_tpu_torch.ops.kernels import conv_block

    conv_block.launches.clear()
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


def check_path(tag, counts, widths, route, out, t):
    """A main-path run: its output's shape and values, and its launches: one
    per ConvBlock, all on ``route``, at every width of the model, the rows
    entry exactly where P = 128 // C > 1 (this batch is <= 64)."""
    launches = sum(counts.values())
    log(f"[{tag}] enhance -> {tuple(out.shape)}: {launches} launches {by_entry(counts)} "
        f"{by_route(counts)}, max|out| = {out.float().abs().max().item():.3e}")
    for (entry, r, c, t_c, film, cond), n in sorted(counts.items()):
        log(f"[{tag}]   {entry:22s} {r} C={c:3d} T={t_c:5d} film={film:d} cond={cond:d}: "
            f"{n} launches")
    if tuple(out.shape) != (out.shape[0], t) or not torch.isfinite(out).all():
        raise AssertionError(f"{tag}: enhance output has the wrong shape or is not finite")
    if launches != PATH_LAUNCHES:
        raise AssertionError(f"{tag}: expected {PATH_LAUNCHES} kernel launches, counted {launches}")
    if {k[2] for k in counts} != set(widths) or set(by_route(counts)) != {route}:
        raise AssertionError(f"{tag}: kernel launched as {sorted(counts)}")
    wrong = [k for k in counts
             if (k[0] == "fused_conv_chain_rows") != (128 // k[2] > 1)]
    if wrong or len(by_entry(counts)) != 2:
        raise AssertionError(f"{tag}: launches split between the entries as {counts}")


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
    diff = (out_k - unfused_enhance(model, mix, noise)).abs().max().item()
    check_path("main", counts, WIDTH_LENGTHS, F32, out_k, t)
    log(f"[main] f32: max|kernel - unfused| = {diff:.3e} (bound 1e-4)")
    if not diff <= 1e-4:
        raise AssertionError(f"kernel path and unfused chain differ by {diff}")

    out_b, counts_bf16 = counted_enhance(model, mix, noise, torch.bfloat16)
    check_path("main bf16", counts_bf16, WIDTH_LENGTHS, BF16, out_b, t)
    diff_bf16 = (out_b - unfused_enhance(model, mix, noise, torch.bfloat16)).abs().max().item()
    log(f"[main bf16] max|kernel - unfused| = {diff_bf16:.3e} (no bound: bf16 "
        f"networks round at other points in the unfused chain)")
    return model, counts, counts_bf16, dict(f32=diff, bf16=diff_bf16)


def phase_24k():
    """The 24 kHz model: a reference-layout checkpoint of universepp(24000)
    with config/model/universepp_24k.yaml beside it, loaded by load_model
    through the registry; enhance both ways at f32; one 2 s request served
    over HTTP; then each launched shape alone at batch 128 in bf16."""
    from open_universe_tpu_torch.bin.serve import make_server
    from open_universe_tpu_torch.inference.model_loader import load_model
    from open_universe_tpu_torch.ops.kernels import conv_block

    with tempfile.TemporaryDirectory() as tmp:
        model = load_model(write_checkpoint(tmp, 24000, "universepp_24k.yaml"),
                           device=DEVICE)
    fs = int(model.fs)
    t = int(CLIP_S * fs)
    g = torch.Generator(device=DEVICE).manual_seed(11)
    mix = torch.randn(2, t, generator=g, device=DEVICE) * 0.05
    noise = noise_draws(model, 2, t, seed=12)
    out_k, counts = counted_enhance(model, mix, noise)
    diff = (out_k - unfused_enhance(model, mix, noise)).abs().max().item()
    check_path("24k", counts, WIDTH_LENGTHS_24K, F32, out_k, t)
    log(f"[24k] universepp_24k.yaml checkpoint via load_model, fs {fs}, tot_ds "
        f"{model.tot_ds}: max|kernel - unfused| = {diff:.3e} (bound 1e-4)")
    if not diff <= 1e-4:
        raise AssertionError(f"24 kHz kernel path and unfused chain differ by {diff}")
    del mix, noise, out_k

    server, service = make_server(model, model_name="universepp-24k-seeded", port=0,
                                  max_batch=SERVE_BATCH, batch_window_ms=50.0,
                                  bucket_seconds=BUCKET_S)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        conv_block.launches.clear()
        x = (0.05 * np.random.default_rng(13).standard_normal(t)).astype(np.float32)
        t0 = time.perf_counter()
        status, body = post(f"http://127.0.0.1:{server.server_address[1]}", wav_bytes(x, fs))
        served_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        served = dict(conv_block.launches)
    finally:
        server.shutdown()
        service.close()
    out = wav_decode(body) if status == 200 else None
    log(f"[24k] one 2 s request served: status {status}, {served_ms:.1f} ms, launches "
        f"{by_entry(served)} {by_route(served)}")
    if out is None or out.shape != (1, t) or not np.isfinite(out).all():
        raise AssertionError(f"24 kHz request answered {status}: {body[:200]}")
    if sum(served.values()) != PATH_LAUNCHES or set(by_route(served)) != {F32}:
        raise AssertionError(f"24 kHz request launched the kernel as {served}")
    del model, server, service
    return dict(kernel_vs_unfused=diff, launches=by_entry(counts),
                served_ms=served_ms, served_launches=by_entry(served)), \
        time_shapes(by_shape(counts), TIMING_BATCH, tag="24k")


def timed_enhance(model, mix, noise, fused: bool, dtype=torch.bfloat16):
    """Median wall time of enhance with dtype networks (None: float32) over
    5 runs after 2 warm-ups."""
    from open_universe_tpu_torch.ops import kernels

    kernels.enable(fused)
    try:
        times = []
        for i in range(7):  # 2 warm-up runs, then 5 timed
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


def time_shapes(shape_counts, batch, rows=False, tag=None):
    """The kernel entry, its plain version and the unfused chain alone at
    each (C, T, FiLM, cond) of shape_counts at this batch, in bf16 and in f32
    (3xTF32); one dict per shape with its launches, bounds, TFLOP/s and
    bound share (bf16 keys bare, f32 keys f32_*)."""
    from open_universe_tpu_torch.nn.blocks import ConvBlock
    from open_universe_tpu_torch.nn.layers import init_weights
    from open_universe_tpu_torch.ops import kernels
    from open_universe_tpu_torch.ops.kernels import conv_block
    from open_universe_tpu_torch.utils.convert import fold_weight_norm

    tag = tag or ("rows" if rows else "timing")
    shapes = []
    for (c, t_c, film, cond), n in sorted(shape_counts.items()):
        p = max(1, 128 // c)
        block = fold_weight_norm(init_weights(ConvBlock(c, weight_norm=True))).to(DEVICE)
        flops = 22.0 * batch * t_c * c * c
        shape = dict(C=c, T=t_c, film=film, cond=cond, launches=n)
        for dtype, key in ((torch.bfloat16, ""), (torch.float32, "f32_")):
            h, weights, nc, ic = chain_inputs(batch, t_c, c, dtype, film, cond)
            hr, icr = pack(h, c), pack(ic, c)
            if rows:
                def kernel():
                    conv_block.fused_conv_chain_rows(hr, p, c, *weights, noise_cond=nc,
                                                     input_cond_rows=icr)

                def plain():
                    conv_block.fused_conv_chain_rows_reference(
                        hr, p, c, *weights, noise_cond=nc, input_cond_rows=icr)
            else:
                def kernel():
                    conv_block.fused_conv_chain(h, *weights, noise_cond=nc, input_cond=ic)

                def plain():
                    conv_block.fused_conv_chain_reference(h, *weights, noise_cond=nc,
                                                          input_cond=ic)

            def unfused():
                block(h, noise_cond=nc, input_cond=ic)

            ms, plain_ms = cuda_ms(kernel, 10), cuda_ms(plain, 3 if key else 5)
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
                f"unfused chain {unfused_ms:.4f}")
            del h, weights, nc, ic, hr, icr
        shapes.append(shape)
        del block
    return shapes


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

    return rates, time_shapes(shape_counts, batch), mix, noise


def phase_small_batch(model, rows_shapes):
    """bf16 enhance at batch 1 and SERVE_BATCH, twice each; then the rows
    entry alone at each of its shapes in phase 3 at SERVE_BATCH."""
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

    return rates, time_shapes(rows_shapes, SERVE_BATCH, rows=True), inputs[1]


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
    launches by entry counted over the served requests."""
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
        if not entries.get("fused_conv_chain_rows"):
            raise AssertionError("the rows entry did not launch while serving")

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
        # one batch of 1-3 rows per 1 s bucket: the rows entry at C = 32, 64
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
                    or len(launches[tag]) != 2 or set(by_route(counts)) != {F32}):
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


def kernel_group(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def busy_ms(intervals) -> float:
    """Length of the union of (start, end) intervals, in us, as ms."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e3


def phase_profile(model, mix, noise, runs=(("kernel", True), ("unfused", False))):
    """One traced enhance per (name, kernels on) run: device time by kernel
    group and op, device busy time and idle share."""
    from torch.profiler import ProfilerActivity, profile

    from open_universe_tpu_torch.ops import kernels

    result = {}
    for name, fused in runs:
        kernels.enable(fused)
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                model.enhance(mix, n_steps=N_STEPS, compute_dtype=torch.bfloat16,
                              noise=noise)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
        finally:
            kernels.enable(True)
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if not events:
            raise RuntimeError("torch.profiler recorded no device time")
        groups = {}
        for e in events:
            group = kernel_group(e.name)
            groups[group] = groups.get(group, 0.0) + (
                e.time_range.end - e.time_range.start) / 1e3
        busy = busy_ms((e.time_range.start, e.time_range.end) for e in events)
        ops = {row.key: row.device_time_total / 1e3
               for row in prof.key_averages() if row.key in PROFILE_OPS}
        result[name] = dict(traced_wall_ms=wall_ms, device_busy_ms=busy,
                            idle_share=1.0 - busy / wall_ms,
                            device_kernels=len(events), groups_ms=groups,
                            ops_ms=ops)
        log(f"[profile] {name}: traced wall {wall_ms:.1f} ms, device busy "
            f"{busy:.1f} ms, idle share {1.0 - busy / wall_ms:.3f}, "
            f"{len(events)} device kernels")
        for group, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
            log(f"[profile] {name}   {group:24s} {ms:9.2f} ms")
        for op, ms in ops.items():
            log(f"[profile] {name}   op {op} (with children) {ms:.2f} ms")
    return result


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
    model, counts, counts_bf16, path_diff = phase_main_path()
    lap("3 main path")
    hz24, shapes_24k = phase_24k()
    lap("3c 24 kHz")
    main_counts = {**counts, **counts_bf16}  # keys differ by route
    entries = by_entry(main_counts)
    # at batch 128 every block takes the unpacked entry, at these shapes
    rates, shapes, mix, noise = phase_timing(model, by_shape(counts))
    lap("4 timing")
    small_rates, rows_shapes, (mix1, noise1) = phase_small_batch(
        model, by_shape(counts, "fused_conv_chain_rows"))
    lap("4b small batch")
    profiled = phase_profile(model, mix, noise)
    profiled_1 = phase_profile(model, mix1, noise1, runs=(("batch 1", True),))
    lap("5 profile")
    del model, mix, noise
    served, serve_entries = phase_serving()
    lap("6 serving")
    cli, cli_launches = phase_cli()
    lap("7 cli")
    log(f"[done] {time.perf_counter() - t_start:.1f} s")

    def cli_entry(entry):
        return {run: n.get(entry, 0) for run, n in cli_launches.items()}

    def total(key, shapes=shapes):
        return sum(s[key] * s["launches"] for s in shapes)

    def sums(shapes, key=""):
        """Per-enhance sums over shapes timed alone, times their launches,
        of the bf16 (key "") or the f32 (key "f32_") route."""
        bytes_ms, ops_ms = total(f"{key}bytes_ms", shapes), total(f"{key}ops_ms", shapes)
        return {f"{key}ms": total(f"{key}ms", shapes),
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

    def routes(entry):
        return {BF16: "open_universe_tpu_torch/csrc/conv_block_tc.cu",
                F32: "open_universe_tpu_torch/csrc/conv_block_tc.cu",
                "launches": by_route({k: n for k, n in main_counts.items()
                                      if k[0] == entry})}

    kernel_line = {"kernels": [{
        "name": "fused_conv_chain",
        "route": "cuda",
        "source": "open_universe_tpu_torch/csrc/conv_block_tc.cu",
        "replaces": "open_universe_tpu/ops/pallas/conv_block.py:180",
        # launches in phase 3's two runs (batch 2, f32 and bf16: the blocks
        # of C >= 128 each time)
        "launches": entries["fused_conv_chain"],
        "max_abs_err": max(worst.values()),
        # per enhance of batch 128 x 2 s in bf16 (all 94 blocks, tensor-core
        # route): each (C, T, FiLM, cond) timed alone, times its launches in
        # phase 3; the f32_* keys are the 3xTF32 route at the same shapes
        **sums(shapes), **sums(shapes, "f32_"),
        "f32_cuda_core_bound_ms": cuda_core_bound(shapes),
        "routes": routes("fused_conv_chain"),
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
        # launches by the enhance CLI's runs of phase 7
        "cli_launches": cli_entry("fused_conv_chain"),
    }, {
        "name": "fused_conv_chain_rows",
        "route": "cuda",
        "source": "open_universe_tpu_torch/csrc/conv_block_tc.cu",
        "replaces": "open_universe_tpu/ops/pallas/conv_block.py:216",
        # launches in phase 3's two runs (C = 32, 64)
        "launches": entries["fused_conv_chain_rows"],
        "max_abs_err": max(worst_rows.values()),
        # per enhance of batch 16 x 2 s in bf16 (the blocks of C < 128):
        # each (C, T, FiLM, cond) timed alone, times its launches in phase 3;
        # f32_* as above
        **sums(rows_shapes), **sums(rows_shapes, "f32_"),
        "f32_cuda_core_bound_ms": cuda_core_bound(rows_shapes),
        "routes": routes("fused_conv_chain_rows"),
        "max_abs_err_by_route": worst_rows,
        "launches_per_enhance": entries,
        "serving_launches": serve_entries,
        "enhance_small_batch": small_rates,
        "profile_batch1": profiled_1,
        "serving": served,
        "cli_launches": cli_entry("fused_conv_chain_rows"),
        "cli": cli,
    }]}
    for tag, sh in (("batch 128, 16 kHz", shapes), ("batch 128, 24 kHz", shapes_24k),
                    ("rows, batch 16", rows_shapes)):
        log(f"[bounds] f32 per enhance, {tag}: kernel {total('f32_ms', sh):.2f} ms, "
            f"bound {sums(sh, 'f32_')['f32_bound_ms']:.2f} ms at 3xTF32 (495 / 3 TFLOP/s), "
            f"{cuda_core_bound(sh):.2f} ms at the CUDA cores' 67 TFLOP/s")
    print(card_line(), flush=True)
    print(json.dumps(kernel_line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
