"""Times other tile tables of the tensor-core kernel against the tables in
``csrc/conv_block_tc.cu``, side by side on one card.

    python -m open_universe_tpu_torch.ops.kernels.tile_probe [--dtype f32|bf16]
        [--against OTHER.cu]

The source has two tables.  ``Tile<P, C>`` gives the mma.sync core of each
(precision, width C) its rows per conv GEMM (BM), output channels per warp
tile (WN) and blocks per SM the registers are capped for.  ``WgTile<C>``
gives the f32 route's wgmma core its rows per conv GEMM (BM), warpgroups
across the channels (NW), channels per wgmma (WI), k8 steps per weight stage
(KS), ring depth (STAGES), blocks per SM (BLOCKS) and the fewest rows B T a
launch needs to take it (MIN_ROWS); a width without one keeps mma.sync.
Each table in ``TABLES`` with an entry of the asked precision is written
into a copy of the source under ``_build/probe/`` and compiled with the
package's flags, one ``nvcc`` per table, all at once; ``--against`` compiles
another version of the source as it is (an earlier commit's, say) beside
them.  At every width, at its length on a 2 s clip of the 16 or 24 kHz
preset, the chain with FiLM and cond runs at batch 128 in the asked dtype,
on the core each build's table gives it; the source's f32 route runs on its
other core too where the width has both (``source:<core>``).  A build on the
source's core must give the source's output bit for bit (a table changes
the tiling, not the order of any sum); one on the other core must hold the
f32 gate, 1e-4 of max|plain|, against the plain version.  Each is timed with
CUDA events in turns: the source, each build, the source again.  One line
per width.
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
GATE = 1e-4  # the f32 gate, of max|plain|
# width -> length of a 2 s clip at that stage (16 kHz: C = 32, 64, ..;
# 24 kHz: C = 48, 96, ..)
LENGTHS = {32: 32160, 48: 48240, 64: 16080, 96: 24120, 128: 4020, 192: 8040,
           256: 1005, 384: 1608, 512: 201, 768: 201}
DTYPES = {"f32": (torch.float32, "F32"), "bf16": (torch.bfloat16, "Bf16")}
TILE_FIELDS = ("BM", "WN", "BLOCKS")
WG_FIELDS = ("BM", "NW", "WI", "KS", "STAGES", "BLOCKS", "MIN_ROWS")
# name -> {(precision, C): (BM, WN, BLOCKS)} for Tile, {("WgTile", C):
# (BM, NW, WI, KS, STAGES, BLOCKS, MIN_ROWS)} for WgTile (precision F32);
# entries a table leaves out keep the source's
TABLES = {
    # wgmma, four blocks per SM at the narrowest widths (shallower rings)
    "wg_four_blocks": {("WgTile", c): t for c, t in {
        32: (128, 1, 32, 2, 3, 4, 65536), 48: (128, 1, 48, 2, 2, 4, 0)}.items()},
    # wgmma, three blocks per SM at C = 64 (a shallower ring), 128-row
    # blocks at C = 96
    "wg_three_blocks": {("WgTile", c): t for c, t in {
        64: (128, 1, 64, 2, 2, 3, 0), 96: (128, 1, 96, 2, 4, 2, 0)}.items()},
    # wgmma, one k8 step per stage at the narrow widths, deeper rings
    "wg_ks1": {("WgTile", c): t for c, t in {
        32: (128, 1, 32, 1, 8, 3, 65536), 48: (128, 1, 48, 1, 6, 3, 0),
        64: (128, 1, 64, 1, 8, 2, 0), 96: (128, 1, 96, 1, 8, 2, 0)}.items()},
    # wgmma, 64-row blocks, two per SM, at the wide widths
    "wg_bm64": {("WgTile", c): t for c, t in {
        128: (64, 1, 128, 1, 8, 2, 12288), 192: (64, 2, 96, 1, 4, 2, 0),
        256: (64, 2, 128, 1, 2, 2, 6144)}.items()},
}


def table_source(table: dict) -> str:
    src = (build.CSRC_DIR / "conv_block_tc.cu").read_text()
    for (prec, c), values in table.items():
        if prec == "WgTile":
            head, fields = r"template <> struct WgTile<%d>" % c, WG_FIELDS
        else:
            head, fields = r"template <> struct Tile<%s, %d>" % (prec, c), TILE_FIELDS
        body = ", ".join(f"{k} = {v}" for k, v in zip(fields, values))
        src, n = re.subn(head + r" \{[^}]*\};",
                         head.replace("\\", "") + " { static constexpr int %s; };" % body, src)
        if n != 1:
            raise ValueError(f"no {head} in csrc/conv_block_tc.cu")
    return src


def compile_sources(sources: dict) -> dict:
    """name -> source text: each compiled at once, one nvcc each; name ->
    its library."""
    out_dir = build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        src = out_dir / f"{name}.cu"
        src.write_text(text)
        procs[name] = subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(out_dir / f"{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"probe build {name}: nvcc exit {proc.returncode}\n{log}")
        spills = re.findall(r"[1-9]\d* bytes spill (?:stores|loads)", log)
        print(f"[probe] {name} built{'; SPILLS ' + str(spills) if spills else ''}",
              flush=True)
        libs[name] = ctypes.CDLL(str(out_dir / f"{name}.so"))
    return libs


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
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in float32
    torch.backends.cudnn.allow_tf32 = False
    wanted = (prec, "WgTile") if dtype == torch.float32 else (prec,)
    tables = {name: t for name, t in TABLES.items() if any(p in wanted for p, _ in t)}
    sources = {name: table_source(t) for name, t in tables.items()}
    if args.against:
        with open(args.against) as f:
            sources["against"] = f.read()
    libs = {"source": build.load(conv_block.ROUTES[dtype][1]), **compile_sources(sources)}
    for c, t in LENGTHS.items():
        h, weights, nc, ic = chain_args(t, c, dtype, seed=c)
        rows = BATCH * t
        core = {name: conv_block.chain_core(dtype, rows, c, lib) for name, lib in libs.items()}
        runs = {name: (conv_block.entry_fn(lib, dtype), core[name])
                for name, lib in libs.items()}
        for other in set(conv_block.width_cores(dtype, c)) - {core["source"]}:
            runs[f"source:{other}"] = (runs["source"][0], other)
        want = conv_block.run_kernel(*runs["source"], h, weights, nc, ic)
        plain = None
        flops = 22.0 * BATCH * t * c * c
        cells = []
        for name in [*runs, "source"]:
            fn, on = runs[name]
            got = conv_block.run_kernel(fn, on, h, weights, nc, ic)
            if on == core["source"]:
                ok, how = all(torch.equal(a, b) for a, b in zip(got, want)), "DIFFERS"
            else:
                if plain is None:
                    plain = conv_block.fused_conv_chain_reference(h, *weights, noise_cond=nc,
                                                                  input_cond=ic)
                rel = max(((a.float() - p.float()).abs().max() / p.float().abs().max()).item()
                          for a, p in zip(got, plain))
                ok, how = rel <= GATE, f"OFF THE GATE ({rel:.2e})"
            ms = time_ms(lambda: conv_block.run_kernel(fn, on, h, weights, nc, ic))
            tile = tables.get(name, {}).get((prec, c)) or tables.get(name, {}).get(("WgTile", c))
            cells.append(f"{name}{' ' + str(tile) if tile else ''} [{on}] {ms:.4f} ms "
                         f"{flops / ms / 1e9:.0f} TFLOP/s{'' if ok else ' ' + how}")
            if not ok:
                raise AssertionError(f"{name} changes the {args.dtype} output at C={c}: {how}")
        print(f"[probe] {args.dtype} C={c:3d} T={t:5d} B={BATCH}: " + " | ".join(cells),
              flush=True)
        del h, weights, nc, ic, want, plain


if __name__ == "__main__":
    main()
