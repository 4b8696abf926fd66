"""Times other tile tables of the tensor-core kernel against the table in
``csrc/conv_block_tc.cu``, side by side on one card.

    python -m open_universe_tpu_torch.ops.kernels.tile_probe [--dtype f32|bf16]
        [--against OTHER.cu]

A table gives each (precision, width C) its ``Tile<P, C>``: rows per conv
GEMM (BM), output channels per warp tile (WN) and blocks per SM the
registers are capped for.  Each table in ``TABLES`` with an entry of the
asked precision is written into a copy of the source under
``_build/probe/`` and compiled with the package's flags, one ``nvcc`` per
table, all at once; ``--against`` compiles another version of the source
as it is (an earlier commit's, say) beside them.  At every width, at its
length on a 2 s clip of the 16 or 24 kHz preset, the chain with FiLM and
cond runs at batch 128 in the asked dtype; each build must give the
source's output bit for bit (a table changes the tiling, not the order of
any sum) and is timed with CUDA events in turns: the source, each build,
the source again.  One line per width.
"""
from __future__ import annotations

import argparse
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
DTYPES = {"f32": (torch.float32, "F32"), "bf16": (torch.bfloat16, "Bf16")}
# name -> {(precision, C): (BM, WN, BLOCKS)}; widths a table leaves out keep
# the source's entry
TABLES = {
    # f32 (3xTF32): wider warp tiles in one block per SM
    "f32_wide": {("F32", c): t for c, t in {
        32: (512, 32, 1), 48: (512, 48, 1), 64: (256, 32, 1), 96: (256, 48, 1),
        128: (128, 32, 1), 192: (128, 48, 1), 256: (64, 64, 1)}.items()},
    # narrower warp tiles, more of them per block
    "f32_narrow": {("F32", c): t for c, t in {
        32: (256, 8, 2), 64: (128, 8, 2), 128: (64, 8, 2), 256: (64, 16, 1),
        384: (64, 24, 1), 512: (32, 32, 1), 768: (32, 48, 1)}.items()},
    # the source's tiles with the registers uncapped (one block per SM)
    "f32_one_block": {("F32", c): t for c, t in {
        32: (256, 16, 1), 48: (256, 24, 1), 64: (128, 16, 1), 96: (128, 24, 1),
        128: (64, 16, 1), 192: (64, 24, 1)}.items()},
}


def table_source(table: dict) -> str:
    src = (build.CSRC_DIR / "conv_block_tc.cu").read_text()
    for (prec, c), (bm, wn, blocks) in table.items():
        src, n = re.subn(
            r"template <> struct Tile<%s, %d> \{[^}]*\};" % (prec, c),
            "template <> struct Tile<%s, %d> { static constexpr int BM = %d, WN = %d, "
            "BLOCKS = %d; };" % (prec, c, bm, wn, blocks), src)
        if n != 1:
            raise ValueError(f"no Tile<{prec}, {c}> in csrc/conv_block_tc.cu")
    return src


def compile_sources(sources: dict, symbol: str) -> dict:
    """name -> source text: each compiled at once, one nvcc each; name ->
    its C entry ``symbol``."""
    out_dir = build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        src = out_dir / f"{name}.cu"
        src.write_text(text)
        procs[name] = subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(out_dir / f"{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"probe build {name}: nvcc exit {proc.returncode}\n{log}")
        spills = re.findall(r"[1-9]\d* bytes spill (?:stores|loads)", log)
        print(f"[probe] {name} built{'; SPILLS ' + str(spills) if spills else ''}",
              flush=True)
        fn = getattr(ctypes.CDLL(str(out_dir / f"{name}.so")), symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fns[name] = fn
    return fns


def chain_args(t: int, c: int, dtype, seed: int = 0):
    """h, weights (slopes float32), noise_cond and input_cond on the card."""
    g = torch.Generator().manual_seed(seed)

    def rand(*shape, scale=1.0):
        return ((torch.rand(shape, generator=g) * 2 - 1) * scale).to("cuda", dtype)

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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="f32")
    ap.add_argument("--against", help="another version of csrc/conv_block_tc.cu")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tile_probe needs a CUDA device")
    dtype, prec = DTYPES[args.dtype]
    tables = {name: t for name, t in TABLES.items() if any(p == prec for p, _ in t)}
    sources = {name: table_source(t) for name, t in tables.items()}
    if args.against:
        with open(args.against) as f:
            sources["against"] = f.read()
    symbol = conv_block.ROUTES[dtype][2]
    fns = {"source": conv_block._kernel_fn(dtype), **compile_sources(sources, symbol)}
    for c, t in LENGTHS.items():
        h, weights, nc, ic = chain_args(t, c, dtype, seed=c)
        want = run(fns["source"], h, weights, nc, ic)
        flops = 22.0 * BATCH * t * c * c
        cells = []
        for name in [*fns, "source"]:
            got = run(fns[name], h, weights, nc, ic)
            same = all(torch.equal(a, b) for a, b in zip(got, want))
            ms = time_ms(lambda: run(fns[name], h, weights, nc, ic))
            tile = tables.get(name, {}).get((prec, c))
            cells.append(f"{name}{' ' + str(tile) if tile else ''} {ms:.4f} ms "
                         f"{flops / ms / 1e9:.0f} TFLOP/s{'' if same else ' DIFFERS'}")
            if not same:
                raise AssertionError(f"{name} changes the {args.dtype} output at C={c}")
        print(f"[probe] {args.dtype} C={c:3d} T={t:5d} B={BATCH}: " + " | ".join(cells),
              flush=True)
        del h, weights, nc, ic, want


if __name__ == "__main__":
    main()
