"""The ConvBlock rate change: CUDA kernel, wrapper, plain version.

A ConvBlock's rate change (``nn/blocks.py::PReLUConv`` with kernel = stride
= r, no padding) is

    down: PReLU -> [low-pass] -> strided conv          (B, T, Cin) -> (B, ceil(T/r), Cout)
    up:   PReLU -> transposed conv -> [low-pass] -> bias  (B, T, Cin) -> (B, T r, Cout)

with UNIVERSE++'s 'same' (2r + 1)-tap binomial low-pass in the score
network's blocks.  On the port's (B, T, C) layout each conv is a plain GEMM
on a block view of the rows: down (B, T/r, r Cin) @ (r Cin, Cout), up
(B, T, Cin) @ (Cin, r Cout), whose output is (B, T r, Cout) as it stands.
``rate_change`` runs it in one launch of ``csrc/rate_change_tc.cu`` on a
CUDA float32 tensor (3xTF32 on the tensor cores, the low-pass an exact
float32 FIR inside the same kernel), and as ``rate_change_reference``, the
same block-view math in PyTorch, on a CPU tensor.  The kernel has two cores:
``wgmma`` (warpgroup products over the whole output width, the weights
staged by TMA's bulk copy) at the shapes of the source's table
(``RateWgTile``), and ``mma_sync`` (``mma.sync.m16n8k8``) at the others and
below a shape's row threshold (every shape has ``mma_sync``, which takes any
Cin); ``rate_core`` gives a launch's core from its direction, r, Cin and
GEMM rows, ``rate_cores`` the cores a shape has.  Both take the conv's
weight in PyTorch's layout (down ``Conv1d`` (Cout, Cin, r), up
``ConvTranspose1d`` (Cin, Cout, r)), its bias (the module's manual bias
where it low-passes), the single PReLU slope and the low-pass taps or None.

``launches`` counts each launch by (direction, route, Cin, Cout, r, T,
antialiased), ``core_launches`` again by (core, direction, r, Cin);
``clear()`` sets every count to 0.  The plain version is no launch.
``conv_block.launches`` counts the chain kernel alone.
"""
from __future__ import annotations

import collections
import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import build
from .conv_block import (CORES, WIDTHS, mma_weights, mma_weights_tf32_layout,
                         wgmma_weights_tf32_layout)

RATES = (2, 3, 4, 5, 8)
DIRECTIONS = ("down", "up")
ROUTE = "f32_tensor_cores_3xtf32"
SOURCE, SYMBOL = "rate_change_tc", "ou_rate_change_f32"

launches: collections.Counter = collections.Counter()
core_launches: collections.Counter = collections.Counter()


def _kernel_fn():
    fn = getattr(build.load(SOURCE), SYMBOL)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
                       + [ctypes.c_int])
    return fn


@functools.lru_cache(maxsize=None)
def _wgmma_min_rows(direction: str, r: int, cin: int,
                    lib: Optional[ctypes.CDLL] = None) -> int:
    """The source's ``RateWgTile<up, r, cin>::MIN_ROWS``, -1 where the shape
    has no wgmma core (``lib``: another build of the source)."""
    fn = (lib or build.load(SOURCE)).ou_rate_change_f32_min_rows
    fn.restype, fn.argtypes = ctypes.c_int, [ctypes.c_int] * 3
    return fn(int(direction == "up"), r, cin)


def rate_cores(direction: str, r: int, cin: int,
               lib: Optional[ctypes.CDLL] = None) -> Tuple[str, ...]:
    """The cores the kernel has for a shape: mma_sync at every shape, wgmma
    too where the source's table has an entry."""
    return CORES if _wgmma_min_rows(direction, r, cin, lib) > 0 else ("mma_sync",)


def gemm_rows(direction: str, b: int, t: int, r: int) -> int:
    """The rows of a launch's GEMM: B ceil(T/r) down, B T up."""
    return b * -(-t // r) if direction == "down" else b * t


def rate_core(direction: str, r: int, cin: int, rows: int,
              lib: Optional[ctypes.CDLL] = None) -> str:
    """The core the source's table gives a launch of ``rows`` GEMM rows
    (``gemm_rows``): wgmma from the shape's MIN_ROWS up."""
    return "wgmma" if 0 < _wgmma_min_rows(direction, r, cin, lib) <= rows else "mma_sync"


def takes(direction: str, x: torch.Tensor, w: torch.Tensor, r: int) -> bool:
    """Whether the kernel takes this rate change: a float32 (B, T, Cin) CUDA
    tensor, r in ``RATES`` and a ConvBlock's widths (Cout = 2 Cin down,
    Cin = 2 Cout up), both in ``WIDTHS``."""
    if x.device.type != "cuda" or x.dtype != torch.float32 or x.dim() != 3:
        return False
    if direction not in DIRECTIONS or r not in RATES or w.dim() != 3:
        return False
    cin, cout = (w.shape[1], w.shape[0]) if direction == "down" else w.shape[:2]
    b, t, c = x.shape
    double = cout == 2 * cin if direction == "down" else cin == 2 * cout
    return (c == cin and double and cin in WIDTHS and cout in WIDTHS
            and w.shape[2] == r and b >= 1 and t >= 1)


def gemm_weights(w: torch.Tensor, direction: str) -> torch.Tensor:
    """The block view's (K, N) weight matrix, rows in the block view's order:
    down (r Cin, Cout), row k Cin + ci = w[:, ci, k]; up (Cin, r Cout),
    column k Cout + co = w[:, co, k]."""
    if direction == "down":
        return w.permute(2, 1, 0).reshape(-1, w.shape[0])
    return w.permute(0, 2, 1).reshape(w.shape[0], -1)


def kernel_weights(w: torch.Tensor, direction: str, core: str = "mma_sync") -> torch.Tensor:
    """``gemm_weights`` in the kernel's order for ``core``, split into hi and
    lo.  The kernel's chunk rows hold each row's samples in channel groups
    of 8, so a down block's reduction runs over (ci / 8, k, ci % 8); the
    wgmma core orders an up block's columns (co / 8, k, co % 8), so that a
    block holds every output sample of its channels.  mma_sync takes the
    fragment order (``conv_block.mma_weights_tf32_layout``), wgmma the
    K-major stream (``conv_block.wgmma_weights_tf32_layout``).  Cached on the
    weight tensor by ``conv_block.mma_weights``, per layout."""
    return mma_weights(w, _LAYOUTS[(direction, core)])


def kernel_matrix(w: torch.Tensor, direction: str, core: str = "mma_sync") -> torch.Tensor:
    """``gemm_weights`` with its rows (down) or columns (up, wgmma) in the
    kernel's order for ``core``."""
    m = gemm_weights(w.detach(), direction)
    if direction == "down":
        cout, cin, r = w.shape
        return m.reshape(r, cin // 8, 8, cout).permute(1, 0, 2, 3).reshape(-1, cout)
    if core == "wgmma":
        cin, cout, r = w.shape
        return m.reshape(cin, r, cout // 8, 8).permute(0, 2, 1, 3).reshape(cin, -1)
    return m


def _layout(direction, core):
    split = {"mma_sync": mma_weights_tf32_layout, "wgmma": wgmma_weights_tf32_layout}[core]

    def layout(w: torch.Tensor) -> torch.Tensor:
        return split(kernel_matrix(w, direction, core)[None].contiguous())
    return layout


_LAYOUTS = {(d, core): _layout(d, core) for d in DIRECTIONS for core in CORES}


def _prelu(x: torch.Tensor, slope: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, slope.reshape(()).to(x.dtype) * x)


def _low_pass(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """The 'same' FIR along time with zero padding: y[t] = sum_d taps[d]
    x[t + d - (len(taps) - 1) / 2], x (B, T, C), as a sum of shifted slices
    (float32, no TF32)."""
    k, t = taps.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, (k - 1) // 2, k - 1 - (k - 1) // 2))
    return sum(taps[d].to(x.dtype) * xp[:, d:d + t] for d in range(k))


def rate_change_reference(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                          slope: torch.Tensor, r: int, direction: str,
                          taps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same block-view GEMM."""
    b, t, cin = x.shape
    x = _prelu(x, slope)
    if direction == "down":
        tb = -(-t // r)
        if tb * r != t:
            x = F.pad(x, (0, 0, 0, tb * r - t))
        if taps is not None:
            x = _low_pass(x, taps)
        y = x.reshape(b, tb, r * cin) @ gemm_weights(w, "down").to(x.dtype)
    else:
        y = (x @ gemm_weights(w, "up").to(x.dtype)).reshape(b, t * r, -1)
        if taps is not None:
            y = _low_pass(y, taps)
    return y + bias.to(y.dtype)


def _check(x, w, bias, slope, r, direction, taps):
    if not takes(direction, x, w, r):
        raise ValueError(
            f"rate_change has no kernel for {direction} r={r}, x {tuple(x.shape)} "
            f"{x.dtype}, weight {tuple(w.shape)}; rates {RATES}, widths {WIDTHS}, float32")
    cout = w.shape[0] if direction == "down" else w.shape[1]
    for name, t, shape in (("weight", w, None), ("bias", bias, (cout,)),
                           ("slope", slope, (1,)), ("taps", taps, (2 * r + 1,))):
        if t is None:  # no low-pass
            continue
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
        if t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 on {x.device}, "
                             f"got {t.dtype} on {t.device}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous and 16-byte aligned")


def launch_core(direction: str, r: int, cin: int, rows: int,
                core: Optional[str] = None) -> str:
    """The table's core for a launch of ``rows`` GEMM rows, or ``core`` if
    the shape has it; a core it lacks raises."""
    if core is None:
        return rate_core(direction, r, cin, rows)
    if core not in rate_cores(direction, r, cin):
        raise RuntimeError(f"{ROUTE} has no {core} core for {direction} r={r} Cin={cin}; "
                           f"it has {rate_cores(direction, r, cin)}")
    return core


def rate_change(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                slope: torch.Tensor, r: int, direction: str,
                taps: Optional[torch.Tensor] = None, core: Optional[str] = None) -> torch.Tensor:
    """The rate change of x (B, T, Cin): ``direction`` "down" (w (Cout, Cin,
    r), output (B, ceil(T/r), Cout)) or "up" (w (Cin, Cout, r), output
    (B, T r, Cout)); bias (Cout,); one float32 PReLU slope; taps the
    2r + 1 low-pass taps or None.  A CPU tensor runs the plain version; a
    CUDA tensor launches the kernel, on the table's core or on ``core``
    (one of ``rate_cores``: tests and timing force either), or raises."""
    if x.device.type == "cpu":
        return rate_change_reference(x, w, bias, slope, r, direction, taps)
    if x.device.type != "cuda":
        raise ValueError(f"rate_change runs on cpu or cuda, not {x.device}")
    _check(x, w, bias, slope, r, direction, taps)
    b, t, cin = x.shape
    cout = w.shape[0] if direction == "down" else w.shape[1]
    core = launch_core(direction, r, cin, gemm_rows(direction, b, t, r), core)
    wk = kernel_weights(w, direction, core)
    shape = (b, -(-t // r), cout) if direction == "down" else (b, t * r, cout)
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _kernel_fn()(
            x.data_ptr(), wk.data_ptr(), bias.data_ptr(), slope.data_ptr(),
            None if taps is None else taps.data_ptr(),
            out.data_ptr(), b, t, cin, cout, r, int(direction == "up"), stream,
            CORES.index(core))
    if err != 0:
        raise RuntimeError(f"rate_change kernel ({ROUTE}, {core}) launch failed: "
                           f"cudaError_t {err}")
    launches[(direction, ROUTE, cin, cout, r, t, taps is not None)] += 1
    core_launches[(core, direction, r, cin)] += 1
    return out
