"""Fused UNIVERSE ConvBlock conv chain: CUDA kernels, wrapper, plain version.

The chain (JAX: ``ops/pallas/conv_block.py``, our ``nn/blocks.py``)

    cond_out = conv5(prelu1(h)) + b5
    c        = film((cond_out [+ input_cond]) * sqrt(1/2), noise_cond)
    v        = (h + conv3b(prelu3(conv3a(prelu2(c))))) * sqrt(1/2)

runs in one kernel launch on a CUDA tensor, and as
``fused_conv_chain_reference`` on a CPU tensor.  Both take folded weights in
the JAX layout (K, Cin, Cout) and h's dtype, the three PReLU slopes in
float32 (as the JAX kernel takes them), h in (B, T, C), and return
(v, cond_out).  One source, ``csrc/conv_block_tc.cu``, runs the chain on the
tensor cores at the widths ``WIDTHS`` (every ConvBlock width of the
UNIVERSE++ 16 and 24 kHz presets), in two routes, one per dtype: bfloat16 on
``mma.sync.m16n8k16``, float32 as 3xTF32 (each product split into TF32
halves, a_hi b_hi + a_hi b_lo + a_lo b_hi summed in float32, which holds
float32's 1e-4 gate where one TF32 pass does not).  The float32 route has two
cores: ``wgmma`` (warpgroup products, the weights staged in shared memory
once per block by TMA's bulk copy) and ``mma_sync`` (per-warp
``mma.sync.m16n8k8`` with the weights read from L2); the source's table
(``WgTile``) gives each launch its core from C and the rows B T it covers
(``chain_core``): C = 48, 64, 96, 192 and 384 have only wgmma, 512 and 768
only mma_sync, 32, 128 and 256 both (``width_cores``).  The weights go in the layout of the dtype and core
(``mma_weights``, made once per weight tensor and layout; float32 split into
hi and lo there).  Neither route nor core stands in for another: a kernel
that does not build or launch raises.

``fused_conv_chain_rows`` is the same chain on the JAX package's lane-packed
rows (B, T/P, P*C), P = max(1, 128 // C).  Row r, lane p*C + c holds sample
r*P + p, channel c: the same contiguous bytes as (B, T, C), so it launches
the same kernel on a view.  The TPU kernel's block-Toeplitz weight packing
only fills the TPU's 128 lanes and has no counterpart here.

``launches`` counts each launch by (entry, route, C, T, with FiLM, with
cond), route one of ``ROUTES``' names; ``core_launches`` counts it again by
(core, C), core one of ``CORES``; ``clear()`` sets every count to 0.  The
plain version is no launch.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import build

SQRT_HALF = 1.0 / math.sqrt(2.0)
WIDTHS = (32, 48, 64, 96, 128, 192, 256, 384, 512, 768)
# dtype -> (route name, source in csrc/, C function)
ROUTES = {torch.float32: ("f32_tensor_cores_3xtf32", "conv_block_tc", "ou_conv_block_tc_f32"),
          torch.bfloat16: ("bf16_tensor_cores", "conv_block_tc", "ou_conv_block_tc")}

# the C entries' core numbers
CORES = ("mma_sync", "wgmma")

launches: collections.Counter = collections.Counter()
core_launches: collections.Counter = collections.Counter()


def entry_fn(lib: ctypes.CDLL, dtype):
    """The C entry of ``dtype``'s route in a built source, its argument types
    set (the float32 entry takes a core number last)."""
    fn = getattr(lib, ROUTES[dtype][2])
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
                       + [ctypes.c_int] * (dtype == torch.float32))
    return fn


def _kernel_fn(dtype):
    """The C entry of ``dtype``'s route, its library built and loaded."""
    return entry_fn(build.load(ROUTES[dtype][1]), dtype)


@functools.lru_cache(maxsize=None)
def _wgmma_min_rows(c: int, lib: Optional[ctypes.CDLL] = None) -> int:
    """The source's ``WgTile<c>::MIN_ROWS``, -1 where width c has no wgmma
    core (``lib``: another build of the source)."""
    fn = (lib or build.load(ROUTES[torch.float32][1])).ou_conv_block_tc_f32_min_rows
    fn.restype, fn.argtypes = ctypes.c_int, [ctypes.c_int]
    return fn(c)


def width_cores(dtype, c: int, lib: Optional[ctypes.CDLL] = None) -> Tuple[str, ...]:
    """The cores ``dtype``'s route has at width ``c``: bfloat16 mma_sync;
    float32 wgmma at the widths of the source's ``WgTile``, and mma_sync
    where that has no entry or a MIN_ROWS above 0."""
    if dtype != torch.float32:
        return ("mma_sync",)
    least = _wgmma_min_rows(c, lib)
    return tuple(core for core, has in zip(CORES, (least != 0, least >= 0)) if has)


def chain_core(dtype, rows: int, c: int, lib: Optional[ctypes.CDLL] = None) -> str:
    """The core the source's table gives a launch of ``rows`` = B T rows at
    width ``c`` in ``dtype``'s route: wgmma from the width's MIN_ROWS up."""
    if dtype != torch.float32:
        return "mma_sync"
    return "wgmma" if 0 <= _wgmma_min_rows(c, lib) <= rows else "mma_sync"


def mma_weights_layout(w: torch.Tensor) -> torch.Tensor:
    """(K, Cin, Cout) -> the tensor-core kernel's fragment order
    (K, Cin/16, Cout/16, 32, 8): for tap k, 16-row block kb of Cin and
    16-column block nb of Cout, lane 4g + q holds at position 4h + 2kh + e the
    value w[k, 16kb + 8kh + 2q + e, 16nb + 8h + g]: the B fragments of
    mma.m16n8k16 for the two n8 tiles h = 0, 1, in one 16-byte load."""
    k, cin, cout = w.shape
    x = w.reshape(k, cin // 16, 2, 4, 2, cout // 16, 2, 8)  # k kb kh q e nb h g
    x = x.permute(0, 1, 5, 7, 3, 6, 2, 4).contiguous()      # k kb nb g q h kh e
    return x.reshape(k, cin // 16, cout // 16, 32, 8)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32`` rounds: the float32 bit pattern
    with its 13 low mantissa bits zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) with hi = tf32(x) and lo = tf32(x - hi): hi + lo keeps ~22
    significant bits of x, the 3xTF32 kernel's split."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def mma_weights_tf32_layout(w: torch.Tensor) -> torch.Tensor:
    """float32 (K, Cin, Cout) -> the 3xTF32 kernel's fragment order
    (K, Cin/8, Cout/8, 32, 4): for tap k, 8-row block kb of Cin and n8 tile
    nb of Cout, lane 4g + q holds hi and then lo of w[k, 8kb + q, 8nb + g]
    and w[k, 8kb + q + 4, 8nb + g] (mma.m16n8k8's TF32 B fragment b0, b1) at
    positions 2 part + kh: one 16-byte load per lane."""
    k, cin, cout = w.shape
    x = torch.stack(tf32_split(w), -1)                         # k cin cout part
    x = x.reshape(k, cin // 8, 2, 4, cout // 8, 8, 2)          # k kb kh q nb g part
    x = x.permute(0, 1, 4, 5, 3, 6, 2).contiguous()            # k kb nb g q part kh
    return x.reshape(k, cin // 8, cout // 8, 32, 4)


def wgmma_weights_tf32_layout(w: torch.Tensor) -> torch.Tensor:
    """float32 (K, Cin, Cout) -> the wgmma core's weight stream
    (K, Cin/8, 2, Cout/8, 2, 8, 4): for tap k and 8-row block kb of Cin (one
    k8 step, 64 Cout contiguous bytes, a stage of the kernel's ring), part
    0 holds hi and part 1 lo of w[k, 8kb + 4kh + kk, 8j + r] at (j, kh, r,
    kk): wgmma's no-swizzle K-major B tile, core matrices of 8 output x 4
    input channels."""
    k, cin, cout = w.shape
    x = torch.stack(tf32_split(w), 0)                          # part k cin cout
    x = x.reshape(2, k, cin // 8, 2, 4, cout // 8, 8)          # part k kb kh kk j r
    x = x.permute(1, 2, 0, 5, 3, 6, 4).contiguous()            # k kb part j kh r kk
    return x


_MMA_LAYOUTS = {torch.bfloat16: mma_weights_layout, torch.float32: mma_weights_tf32_layout}
# the f32 route's weight layout by core
_F32_LAYOUTS = {"mma_sync": mma_weights_tf32_layout, "wgmma": wgmma_weights_tf32_layout}


def mma_weights(w: torch.Tensor, layout=None) -> torch.Tensor:
    """The fragment-ordered weights ``layout(w)``, by default those of w's
    dtype (``mma_weights_layout`` for bfloat16, ``mma_weights_tf32_layout``
    for float32), made once per weight tensor and layout (kept on the
    tensor: at C = 32, 128 and 256, where small batches take the
    mma_sync core and large ones wgmma, a float32 weight may hold both
    layouts, each 8 bytes a weight) and made anew when the tensor is written (its version moves) or
    moved (its data pointer).  A tensor made under ``torch.inference_mode``
    has no version to follow and gets a fresh copy on every call."""
    layout = layout or _MMA_LAYOUTS[w.dtype]
    if w.is_inference():
        return layout(w)
    key = (w.data_ptr(), w._version)
    cache = getattr(w, "_mma_weights", None)
    if cache is None:
        cache = w._mma_weights = {}
    cached = cache.get(layout)
    if cached is None or cached[0] != key:
        cached = cache[layout] = (key, layout(w))
    return cached[1]


def _check(h, weights, noise_cond, input_cond):
    if h.dim() != 3:
        raise ValueError(f"h must be (B, T, C), got shape {tuple(h.shape)}")
    b, t, c = h.shape
    if h.dtype not in ROUTES:
        raise TypeError(f"fused_conv_chain takes float32 or bfloat16, not {h.dtype}")
    if c not in WIDTHS:
        raise ValueError(f"fused_conv_chain has no kernel for C={c}; widths {WIDTHS}")
    if t < 1 or not 1 <= b <= 65535:
        raise ValueError(f"fused_conv_chain needs T >= 1 and 1 <= B <= 65535, got {b, t}")
    shapes = {"w5": (5, c, c), "b5": (c,), "a1": None, "w3a": (3, c, c),
              "b3a": (c,), "a2": None, "w3b": (3, c, c), "b3b": (c,), "a3": None,
              "noise_cond": (b, 2 * c), "input_cond": (b, t, c)}
    named = dict(zip(shapes, weights + (noise_cond, input_cond)))
    named["h"] = h
    for name, x in named.items():
        if x is None:
            continue
        want = shapes.get(name)
        if name in ("a1", "a2", "a3"):
            if x.numel() != 1:
                raise ValueError(f"{name}: one PReLU slope expected, got {x.numel()}")
        elif want is not None and tuple(x.shape) != want:
            raise ValueError(f"{name}: expected shape {want}, got {tuple(x.shape)}")
        if x.device != h.device:
            raise ValueError(f"{name} is on {x.device}, h on {h.device}")
        want_dtype = torch.float32 if name in ("a1", "a2", "a3") else h.dtype
        if x.dtype != want_dtype:
            raise TypeError(f"{name} is {x.dtype}, expected {want_dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name in ("h", "input_cond", "w5", "w3a", "w3b") and x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def fused_conv_chain(
    h: torch.Tensor,
    w5: torch.Tensor, b5: torch.Tensor, a1: torch.Tensor,
    w3a: torch.Tensor, b3a: torch.Tensor, a2: torch.Tensor,
    w3b: torch.Tensor, b3b: torch.Tensor, a3: torch.Tensor,
    noise_cond: Optional[torch.Tensor] = None,
    input_cond: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused conv5 -> (cond/FiLM) -> conv3 -> conv3 -> residual.

    h: (B, T, C); w5: (5, C, C); w3a/w3b: (3, C, C); biases (C,); a1..a3
    single float32 PReLU slopes; noise_cond: (B, 2C) FiLM source;
    input_cond: (B, T, C) additive signal conditioning.  Every tensor is
    contiguous and on h's device, and all but the slopes have h's dtype
    (float32 or bfloat16).  Returns (v, cond_out).
    A CPU tensor runs the plain version; a CUDA tensor launches its dtype's
    kernel (bf16 or 3xTF32 on the tensor cores) or raises.
    """
    weights = (w5, b5, a1, w3a, b3a, a2, w3b, b3b, a3)
    if h.device.type == "cpu":
        return fused_conv_chain_reference(h, *weights, noise_cond=noise_cond,
                                          input_cond=input_cond)
    return _launch("fused_conv_chain", h, weights, noise_cond, input_cond)


def run_kernel(fn, core, h, weights, noise_cond, input_cond):
    """Launch the C entry ``fn`` (of h's dtype) on ``core`` with checked
    operands, the weights laid out for that core; (v, cond_out)."""
    b, t, c = h.shape
    f32 = h.dtype == torch.float32
    layout = _F32_LAYOUTS[core] if f32 else None
    weights = tuple(mma_weights(x, layout) if i in (0, 3, 6) else x
                    for i, x in enumerate(weights))
    v = torch.empty_like(h)
    cond_out = torch.empty_like(h)
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = fn(h.data_ptr(), *(x.data_ptr() for x in weights),
                 noise_cond.data_ptr() if noise_cond is not None else None,
                 input_cond.data_ptr() if input_cond is not None else None,
                 v.data_ptr(), cond_out.data_ptr(), b, t, c, stream,
                 *((CORES.index(core),) if f32 else ()))
    if err != 0:
        raise RuntimeError(f"conv_block kernel ({ROUTES[h.dtype][0]}, {core}) launch "
                           f"failed: cudaError_t {err}")
    return v, cond_out


def _launch(entry, h, weights, noise_cond, input_cond, core=None):
    """Check the operands of a CUDA call, launch the kernel of h's dtype on
    h (B, T, C), on the table's core or on ``core``, and count the launch
    under ``entry`` and its route, and under its core."""
    if h.device.type != "cuda":
        raise ValueError(f"{entry} runs on cpu or cuda, not {h.device}")
    weights = tuple(weights)
    _check(h, weights, noise_cond, input_cond)
    b, t, c = h.shape
    if core is None:
        core = chain_core(h.dtype, b * t, c)
    elif core not in width_cores(h.dtype, c):
        raise RuntimeError(f"{ROUTES[h.dtype][0]} has no {core} core at C={c}; it has "
                           f"{width_cores(h.dtype, c)}")
    v, cond_out = run_kernel(_kernel_fn(h.dtype), core, h, weights, noise_cond, input_cond)
    route = ROUTES[h.dtype][0]
    launches[(entry, route, c, t, noise_cond is not None, input_cond is not None)] += 1
    core_launches[(core, c)] += 1
    return v, cond_out


def _rows_view(h_rows, p, c, input_cond_rows):
    """The (B, T, C) views of lane-packed rows (B, T/P, P*C)."""
    if h_rows.dim() != 3:
        raise ValueError(f"h_rows must be (B, T/P, P*C), got {tuple(h_rows.shape)}")
    b, rows, lanes = h_rows.shape
    if p != max(1, 128 // c):
        raise ValueError(f"pack factor {p} for C={c}; the packed layout has "
                         f"P = max(1, 128 // C) = {max(1, 128 // c)}")
    if lanes != p * c:
        raise ValueError(f"h_rows has {lanes} lanes, not P*C = {p * c}")
    for name, x in (("h_rows", h_rows), ("input_cond_rows", input_cond_rows)):
        if x is None:
            continue
        if tuple(x.shape) != (b, rows, lanes):
            raise ValueError(f"{name}: expected shape {(b, rows, lanes)}, "
                             f"got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    ic = None if input_cond_rows is None else input_cond_rows.view(b, rows * p, c)
    return h_rows.view(b, rows * p, c), ic


def fused_conv_chain_rows(
    h_rows: torch.Tensor, p: int, c: int,
    w5: torch.Tensor, b5: torch.Tensor, a1: torch.Tensor,
    w3a: torch.Tensor, b3a: torch.Tensor, a2: torch.Tensor,
    w3b: torch.Tensor, b3b: torch.Tensor, a3: torch.Tensor,
    noise_cond: Optional[torch.Tensor] = None,
    input_cond_rows: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``fused_conv_chain`` on lane-packed rows: h_rows and input_cond_rows
    (B, T/P, P*C) with P = max(1, 128 // C), contiguous; the weights, slopes
    and noise_cond (B, 2C) as ``fused_conv_chain`` takes them.  Returns
    (v_rows, cond_out_rows), packed the same way.

    Unlike the JAX entry, which returns None when the rows do not tile its
    TPU grid, this one always computes: the kernel takes any T >= 1.  A CPU
    tensor runs ``fused_conv_chain_rows_reference``; a CUDA tensor launches
    the kernel or raises.
    """
    weights = (w5, b5, a1, w3a, b3a, a2, w3b, b3b, a3)
    h, ic = _rows_view(h_rows, p, c, input_cond_rows)
    if h.device.type == "cpu":
        return fused_conv_chain_rows_reference(
            h_rows, p, c, *weights, noise_cond=noise_cond,
            input_cond_rows=input_cond_rows)
    v, cond_out = _launch("fused_conv_chain_rows", h, weights, noise_cond, ic)
    return v.view(h_rows.shape), cond_out.view(h_rows.shape)


def fused_conv_chain_rows_reference(
    h_rows: torch.Tensor, p: int, c: int,
    w5: torch.Tensor, b5: torch.Tensor, a1: torch.Tensor,
    w3a: torch.Tensor, b3a: torch.Tensor, a2: torch.Tensor,
    w3b: torch.Tensor, b3b: torch.Tensor, a3: torch.Tensor,
    noise_cond: Optional[torch.Tensor] = None,
    input_cond_rows: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``fused_conv_chain_rows``: unpack the rows to
    (B, T, C), run ``fused_conv_chain_reference``, pack again."""
    b, rows, lanes = h_rows.shape
    ic = None if input_cond_rows is None else input_cond_rows.reshape(b, rows * p, c)
    v, cond_out = fused_conv_chain_reference(
        h_rows.reshape(b, rows * p, c), w5, b5, a1, w3a, b3a, a2, w3b, b3b, a3,
        noise_cond=noise_cond, input_cond=ic)
    return v.reshape(b, rows, lanes), cond_out.reshape(b, rows, lanes)


def fused_conv_chain_reference(
    h: torch.Tensor,
    w5: torch.Tensor, b5: torch.Tensor, a1: torch.Tensor,
    w3a: torch.Tensor, b3a: torch.Tensor, a2: torch.Tensor,
    w3b: torch.Tensor, b3b: torch.Tensor, a3: torch.Tensor,
    noise_cond: Optional[torch.Tensor] = None,
    input_cond: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, with its rounding points: sums in
    float32, values rounded to h's dtype after FiLM, after each PReLU
    product (slope in float32) and after conv3a."""
    dtype = h.dtype
    f32 = torch.float32

    def rnd(x):
        return x.to(dtype).to(f32)

    def prelu(x, a):
        return torch.where(x >= 0, x, rnd(a.reshape(()).to(f32) * x))

    def conv(x, w, bias):
        y = F.conv1d(x.transpose(1, 2), w.to(f32).permute(2, 1, 0),
                     bias.to(f32), padding=w.shape[0] // 2)
        return y.transpose(1, 2)

    hf = h.to(f32)
    cond_out = conv(prelu(hf, a1), w5, b5)
    c = cond_out
    if input_cond is not None:
        c = (c + input_cond.to(f32)) * SQRT_HALF
    if noise_cond is not None:
        n = h.shape[-1]
        nc = noise_cond.to(f32)[:, None, :]
        c = nc[..., :n] * c + nc[..., n:]
    c = prelu(rnd(c), a2)
    c = prelu(rnd(conv(c, w3a, b3a)), a3)
    v = (hf + conv(c, w3b, b3b)) * SQRT_HALF
    return v.to(dtype), cond_out.to(dtype)
