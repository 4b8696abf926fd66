"""Times other tile tables of the tensor-core kernel against the table in
``csrc/conv_block_tc.cu``, side by side on one card.

    python -m open_universe_tpu_torch.ops.kernels.tile_probe

A table gives each width C its ``Tile<C>``: rows per conv GEMM (BM), output
channels per warp tile (WN) and blocks per SM the registers are capped for.
Each table in ``TABLES`` is written into a copy of the source under
``_build/probe/`` and compiled with the package's flags, one ``nvcc`` per
table, all at once.  At every width, at its length on a 2 s clip of the 16
or 24 kHz preset, the bf16 chain with FiLM and cond runs at batch 128; each
table must give the source's output bit for bit (a table changes the tiling,
not the order of any sum) and is timed with CUDA events in turns: the
source, each table, the source again.  One line per width.
"""
from __future__ import annotations

import ctypes
import math
import re
import subprocess

import torch

from . import build, conv_block

BATCH = 128
# width -> length of a 2 s clip at that stage (16 kHz: C = 32, 64, ..;
# 24 kHz: C = 48, 96, ..)
LENGTHS = {32: 32160, 48: 48240, 64: 16080, 96: 24120, 128: 4020, 192: 8040,
           256: 1005, 384: 1608, 512: 201, 768: 201}
# the kernel's first table: one block per SM everywhere, wide warp tiles
FIRST = {32: (512, 32, 1), 48: (512, 48, 1), 64: (256, 32, 1), 96: (256, 48, 1),
         128: (256, 64, 1), 192: (128, 48, 1), 256: (128, 64, 1), 384: (64, 48, 1),
         512: (64, 64, 1), 768: (64, 48, 1)}
TABLES = {
    "first": FIRST,
    # narrower tiles where the source keeps wide ones
    "narrow": {32: (256, 32, 2), 384: (64, 32, 2), 512: (64, 32, 1), 768: (64, 32, 1)},
}


def table_source(table: dict) -> str:
    src = (build.CSRC_DIR / "conv_block_tc.cu").read_text()
    for c, (bm, wn, blocks) in table.items():
        src, n = re.subn(
            r"template <> struct Tile<%d> \{[^}]*\};" % c,
            "template <> struct Tile<%d> { static constexpr int BM = %d, WN = %d, "
            "BLOCKS = %d; };" % (c, bm, wn, blocks), src)
        if n != 1:
            raise ValueError(f"no Tile<{c}> in csrc/conv_block_tc.cu")
    return src


def compile_tables(tables: dict) -> dict:
    """name -> the C entry of that table's build."""
    out_dir = build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, table in tables.items():
        src = out_dir / f"{name}.cu"
        src.write_text(table_source(table))
        procs[name] = subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(out_dir / f"{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"tile table {name}: nvcc exit {proc.returncode}\n{log}")
        spills = re.findall(r"[1-9]\d* bytes spill (?:stores|loads)", log)
        print(f"[probe] table {name} built{'; SPILLS ' + str(spills) if spills else ''}",
              flush=True)
        fn = ctypes.CDLL(str(out_dir / f"{name}.so")).ou_conv_block_tc
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fns[name] = fn
    return fns


def chain_args(t: int, c: int, seed: int = 0):
    """bf16 h, weights (slopes float32), noise_cond and input_cond on the card."""
    g = torch.Generator().manual_seed(seed)

    def rand(*shape, scale=1.0):
        return ((torch.rand(shape, generator=g) * 2 - 1) * scale).to("cuda", torch.bfloat16)

    weights = []
    for k in (5, 3, 3):
        weights += [rand(k, c, c, scale=1 / math.sqrt(k * c)), rand(c, scale=0.5),
                    (torch.rand(1, generator=g) * 0.5).to("cuda")]
    return rand(BATCH, t, c), weights, rand(BATCH, 2 * c), rand(BATCH, t, c)


def run(fn, h, weights, nc, ic):
    b, t, c = h.shape
    ws = [conv_block.mma_weights(x) if i in (0, 3, 6) else x for i, x in enumerate(weights)]
    v, cond_out = torch.empty_like(h), torch.empty_like(h)
    err = fn(h.data_ptr(), *(x.data_ptr() for x in ws), nc.data_ptr(), ic.data_ptr(),
             v.data_ptr(), cond_out.data_ptr(), b, t, c,
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"launch failed: cudaError_t {err}")
    return v, cond_out


def time_ms(fn, iters: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("tile_probe needs a CUDA device")
    fns = {"source": conv_block._kernel_fn(torch.bfloat16), **compile_tables(TABLES)}
    for c, t in LENGTHS.items():
        h, weights, nc, ic = chain_args(t, c, seed=c)
        want = run(fns["source"], h, weights, nc, ic)
        flops = 22.0 * BATCH * t * c * c
        cells = []
        for name in [*fns, "source"]:
            got = run(fns[name], h, weights, nc, ic)
            same = all(torch.equal(a, b) for a, b in zip(got, want))
            ms = time_ms(lambda: run(fns[name], h, weights, nc, ic))
            tile = "" if name == "source" or c not in TABLES[name] else f" {TABLES[name][c]}"
            cells.append(f"{name}{tile} {ms:.4f} ms {flops / ms / 1e9:.0f} TFLOP/s"
                         f"{'' if same else ' DIFFERS'}")
            if not same:
                raise AssertionError(f"table {name} changes the output at C={c}")
        print(f"[probe] C={c:3d} T={t:5d} B={BATCH}: " + " | ".join(cells), flush=True)
        del h, weights, nc, ic, want


if __name__ == "__main__":
    main()
