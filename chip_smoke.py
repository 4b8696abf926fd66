"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0) on failure:

1. Build the CUDA kernels from ``open_universe_tpu_torch/csrc`` and print
   the card's name and power limit.  TF32 is off for convs and matmuls.
2. Hold the fused ConvBlock kernel against its plain PyTorch version on the
   card, at every width of the UNIVERSE++ 16 kHz path (C = 32..512) and the
   lengths that path gives it, FiLM and cond on and off, float32 and bf16.
3. Run the main path at full width: ``universepp(16000)`` with seeded random
   weights, weight norm folded, ``enhance`` on 2 x 2 s at 16 kHz, 8 steps,
   float32, once through the kernel and once through the unfused chain, on
   the same noise.  The kernel run must launch the kernel 94 times and both
   must agree.  The launches are counted by (C, T, FiLM, cond).
4. Time ``enhance`` in bench.py's setting (bf16 networks, batch 128 x 2 s,
   8 steps) with the kernel and with the unfused chain; then time the
   kernel, its plain version and the unfused chain alone at each (C, T,
   FiLM, cond) that phase 3 launched, and weight each by its launches.
5. Trace one ``enhance`` each way in that setting with ``torch.profiler``:
   device time by kernel group and under a few PyTorch ops, device busy
   time and idle share.

The last two lines are a JSON object with one entry per kernel and
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits non-zero
and prints no result.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import torch

FS = 16000
CLIP_S = 2.0
N_STEPS = 8
TIMING_BATCH = 128
WIDTH_LENGTHS = {32: 32160, 64: 16080, 128: 4020, 256: 1005, 512: 201}
# ConvBlocks per enhance with 8 steps: 10 per score pass, 14 in the conditioner
PATH_LAUNCHES = 10 * N_STEPS + 14
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}

# first matching substring of a device kernel's lower-cased name names its
# group; casts and contiguous copies are copy kernels, pads a fill and a copy
GROUPS = (
    ("fused ConvBlock kernel", ("conv_block_kernel",)),
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
        return ((torch.rand(shape, generator=g) * 2 - 1) * scale).to("cuda", dtype)

    weights = []
    for k in (5, 3, 3):
        slope = (torch.rand(1, generator=g) * 0.5).to("cuda")  # float32
        weights += [rand(k, c, c, scale=1 / math.sqrt(k * c)), rand(c, scale=0.5),
                    slope]
    h = rand(b, t, c)
    nc = rand(b, 2 * c) if film else None
    ic = rand(b, t, c) if cond else None
    return h, weights, nc, ic


def phase_build():
    from open_universe_tpu_torch.ops.kernels import build

    t0 = time.perf_counter()
    build.build("conv_block")
    log(f"[build] conv_block built in {time.perf_counter() - t0:.1f} s")
    for line in build.build_log("conv_block").splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"[device] {card_line()} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")


def phase_kernel_vs_plain():
    """Returns the largest max|kernel - plain| over the cases."""
    from open_universe_tpu_torch.ops.kernels import conv_block

    worst = 0.0
    for c, t_main in WIDTH_LENGTHS.items():
        cases = [(t_main, True, True, torch.float32),
                 (t_main, False, False, torch.float32),
                 (t_main, True, False, torch.bfloat16),
                 (t_main, True, True, torch.bfloat16),
                 (5, True, True, torch.float32),       # shorter than a tile
                 (5, False, True, torch.bfloat16)]
        for t, film, cond, dtype in cases:
            h, weights, nc, ic = chain_inputs(2, t, c, dtype, film, cond, seed=c + t)
            got = conv_block.fused_conv_chain(h, *weights, noise_cond=nc,
                                              input_cond=ic)
            torch.cuda.synchronize()
            ref = conv_block.fused_conv_chain_reference(h, *weights, noise_cond=nc,
                                                        input_cond=ic)
            for name, a, r in zip(("v", "cond_out"), got, ref):
                err = (a.float() - r.float()).abs().max().item()
                scale = r.float().abs().max().item()
                ok = math.isfinite(err) and err <= TOL[dtype] * scale
                log(f"[kernel] C={c:3d} T={t:5d} film={film:d} cond={cond:d} "
                    f"{str(dtype)[6:]:8s} {name:8s} max|d|={err:.3e} "
                    f"max|ref|={scale:.3e} {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"kernel disagrees with its plain version "
                                         f"at C={c} T={t} {dtype} ({name})")
                worst = max(worst, err)
    return worst


def noise_draws(model, b, t, seed):
    """The sampler's N_STEPS standard-normal draws for a (b, t) input."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = (b, t + model.tot_ds - t % model.tot_ds, 1)
    return [torch.randn(shape, generator=g, device="cuda") for _ in range(N_STEPS)]


def phase_main_path():
    """Full-width enhance through the kernel and through the unfused chain."""
    from open_universe_tpu_torch.models.presets import universepp
    from open_universe_tpu_torch.ops import kernels
    from open_universe_tpu_torch.ops.kernels import conv_block
    from open_universe_tpu_torch.utils.convert import fold_weight_norm

    model = fold_weight_norm(universepp(FS, device="cuda", seed=0))
    t = int(CLIP_S * FS)
    g = torch.Generator(device="cuda").manual_seed(1)
    mix = torch.randn(2, t, generator=g, device="cuda") * 0.05
    noise = noise_draws(model, 2, t, seed=2)

    conv_block.launches = 0
    conv_block.launches_by_shape.clear()
    out_k = model.enhance(mix, n_steps=N_STEPS, noise=noise)
    torch.cuda.synchronize()
    launches = conv_block.launches
    by_shape = dict(conv_block.launches_by_shape)
    kernels.enable(False)
    try:
        out_u = model.enhance(mix, n_steps=N_STEPS, noise=noise)
    finally:
        kernels.enable(True)
    torch.cuda.synchronize()
    diff = (out_k - out_u).abs().max().item()
    log(f"[main] enhance (2, {t}) -> {tuple(out_k.shape)}: kernel launches "
        f"{launches}, max|kernel - unfused| = {diff:.3e}, "
        f"max|out| = {out_k.abs().max().item():.3e}")
    for (c, t_c, film, cond), n in sorted(by_shape.items()):
        log(f"[main]   C={c:3d} T={t_c:5d} film={film:d} cond={cond:d}: {n} launches")
    if tuple(out_k.shape) != (2, t) or not torch.isfinite(out_k).all():
        raise AssertionError("enhance output has the wrong shape or is not finite")
    if launches != PATH_LAUNCHES or sum(by_shape.values()) != launches:
        raise AssertionError(f"expected {PATH_LAUNCHES} kernel launches, counted "
                             f"{launches} ({sum(by_shape.values())} by shape)")
    if {c for c, *_ in by_shape} != set(WIDTH_LENGTHS):
        raise AssertionError(f"kernel launched at widths {sorted(by_shape)}")
    if not diff <= 1e-4:
        raise AssertionError(f"kernel path and unfused chain differ by {diff}")
    return model, launches, by_shape


def timed_enhance(model, mix, noise, fused: bool):
    from open_universe_tpu_torch.ops import kernels

    kernels.enable(fused)
    try:
        times = []
        for i in range(7):  # 2 warm-up runs, then 5 timed
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.enhance(mix, n_steps=N_STEPS, compute_dtype=torch.bfloat16,
                          noise=noise)
            torch.cuda.synchronize()
            if i >= 2:
                times.append(time.perf_counter() - t0)
    finally:
        kernels.enable(True)
    times.sort()
    return times[len(times) // 2]


def phase_timing(model, by_shape):
    """End-to-end audio-s/s both ways, then each launched shape alone."""
    from open_universe_tpu_torch.nn.blocks import ConvBlock
    from open_universe_tpu_torch.nn.layers import init_weights
    from open_universe_tpu_torch.ops import kernels
    from open_universe_tpu_torch.ops.kernels import conv_block
    from open_universe_tpu_torch.utils.convert import fold_weight_norm

    batch = TIMING_BATCH
    t = int(CLIP_S * FS)
    g = torch.Generator(device="cuda").manual_seed(3)
    mix = torch.randn(batch, t, generator=g, device="cuda") * 0.05
    noise = noise_draws(model, batch, t, seed=4)
    audio_s = batch * CLIP_S
    rates = {}
    for fused in (True, False, False, True):
        s = timed_enhance(model, mix, noise, fused)
        rates.setdefault(fused, []).append(audio_s / s)
        log(f"[timing] enhance batch {batch} x {CLIP_S} s bf16, "
            f"{'kernel' if fused else 'unfused'}: median {s:.4f} s -> "
            f"{audio_s / s:.2f} audio-s/s")

    dtype = torch.bfloat16
    shapes = []
    for (c, t_c, film, cond), n in sorted(by_shape.items()):
        h, weights, nc, ic = chain_inputs(batch, t_c, c, dtype, film, cond)
        block = fold_weight_norm(init_weights(ConvBlock(c, weight_norm=True))).to("cuda")
        ms = cuda_ms(lambda: conv_block.fused_conv_chain(
            h, *weights, noise_cond=nc, input_cond=ic), 10)
        plain_ms = cuda_ms(lambda: conv_block.fused_conv_chain_reference(
            h, *weights, noise_cond=nc, input_cond=ic), 5)
        kernels.enable(False)
        try:
            with torch.no_grad():
                unfused_ms = cuda_ms(lambda: block(h, noise_cond=nc, input_cond=ic), 10)
        finally:
            kernels.enable(True)
        flops = 22.0 * batch * t_c * c * c
        moved = sum(x.numel() * x.element_size() for x in [h, nc, ic, *weights]
                    if x is not None) + 2 * h.numel() * h.element_size()
        t_bytes = moved / PEAK_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[dtype] * 1e3
        shapes.append(dict(C=c, T=t_c, film=film, cond=cond, launches=n, ms=ms,
                           plain_ms=plain_ms, unfused_ms=unfused_ms,
                           bytes_ms=t_bytes, ops_ms=t_ops))
        log(f"[timing] C={c:3d} T={t_c:5d} film={film:d} cond={cond:d} B={batch} "
            f"bf16 x{n}: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), "
            f"plain {plain_ms:.4f} ms, unfused chain {unfused_ms:.4f} ms, bound "
            f"{max(t_bytes, t_ops):.4f} ms "
            f"({'bytes' if t_bytes >= t_ops else 'operations'})")
        del h, weights, nc, ic, block
    return rates, shapes, mix, noise


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


def phase_profile(model, mix, noise):
    """One traced enhance each way: device time by kernel group and op."""
    from torch.profiler import ProfilerActivity, profile

    from open_universe_tpu_torch.ops import kernels

    result = {}
    for fused in (True, False):
        name = "kernel" if fused else "unfused"
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
    phase_build()
    worst = phase_kernel_vs_plain()
    model, launches, by_shape = phase_main_path()
    rates, shapes, mix, noise = phase_timing(model, by_shape)
    profiled = phase_profile(model, mix, noise)
    log(f"[done] {time.perf_counter() - t_start:.1f} s")

    def total(key):
        return sum(s[key] * s["launches"] for s in shapes)

    kernel_line = {"kernels": [{
        "name": "fused_conv_chain",
        "route": "cuda",
        "source": "open_universe_tpu_torch/csrc/conv_block.cu",
        "replaces": "open_universe_tpu/ops/pallas/conv_block.py:180",
        "launches": launches,
        "max_abs_err": worst,
        # per enhance of batch 128 x 2 s in bf16: each (C, T, FiLM, cond)
        # timed alone, times its launches in phase 3
        "ms": total("ms"),
        "plain_ms": total("plain_ms"),
        "bound_ms": sum(max(s["bytes_ms"], s["ops_ms"]) * s["launches"]
                        for s in shapes),
        "bound_by": ("bytes" if total("bytes_ms") >= total("ops_ms")
                     else "operations"),
        "library_ms": None,
        "unfused_ms": total("unfused_ms"),
        "audio_s_per_s": {"kernel": rates[True], "unfused": rates[False]},
        "per_shape": shapes,
        "profile": profiled,
    }]}
    print(card_line(), flush=True)
    print(json.dumps(kernel_line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
