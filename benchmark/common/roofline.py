"""The yardstick's arithmetic: the chip's published peaks, the fused
ConvBlock chain's least time, and the model's FLOPs.

Peaks are NVIDIA's for one H100 SXM at its full 700 W, dense: 989 TFLOP/s
for bfloat16 and 495 TFLOP/s for float32 work on the tensor cores (TF32),
3.35 TB/s of HBM.  A float32 chain is counted once at the TF32 rate, however
many products its kernel spends on it, so any implementation of the same
work reads on the same scale.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Dict, Tuple

PEAK_FLOPS = {"float32": 495e12, "bfloat16": 989e12}
PEAK_BYTES_PER_S = 3.35e12
ITEM_BYTES = {"float32": 4, "bfloat16": 2}
# the kernel wrapper's route names (ops/kernels/conv_block.py ROUTES)
ROUTE_DTYPE = {"f32_tensor_cores_3xtf32": "float32", "bf16_tensor_cores": "bfloat16"}


def conv_block_work(b: int, t: int, c: int, film: bool, cond: bool,
                    dtype: str) -> Tuple[float, float]:
    """(FLOPs, bytes) of one chain: conv5, conv3, conv3 over (B, T, C) is
    2 (5 + 3 + 3) B T C^2 = 22 B T C^2 operations; the bytes read h (and
    input_cond), noise_cond, the 11 C^2 weights and 3 C biases once in the
    dtype and the three float32 slopes, and write v and cond_out once."""
    item = ITEM_BYTES[dtype]
    flops = 22.0 * b * t * c * c
    elems = b * t * c * (3 + int(cond)) + (2 * b * c if film else 0) + 11 * c * c + 3 * c
    return flops, elems * item + 3 * 4


def conv_block_bound_s(b: int, t: int, c: int, film: bool, cond: bool, dtype: str) -> float:
    """The least time of one chain: the larger of its FLOPs at the dtype's
    peak and its bytes at the HBM bandwidth."""
    flops, nbytes = conv_block_work(b, t, c, film, cond, dtype)
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S)


def launches_bound_s(launches: Dict[tuple, int], rows: int) -> float:
    """Summed least time of the launches of one call of ``rows`` rows,
    ``launches`` keyed as the wrapper counts them: (entry, route, C, T,
    FiLM, cond), T the unpacked length."""
    return sum(n * conv_block_bound_s(rows, t, c, film, cond, ROUTE_DTYPE[route])
               for (_, route, c, t, film, cond), n in launches.items())


def _network_flops(cfg_json: str, m: int, n_steps: int) -> float:
    """Counted FLOPs of one row padded to m * tot_ds samples: the
    conditioner once and the score network n_steps times, the only matrix
    and convolution work of ``enhance``."""
    import json

    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from ..reference.model import Reference

    model = Reference(json.loads(cfg_json)).to("meta")
    x = torch.zeros(1, m * model.tot_ds, 1, device="meta")
    sigma = torch.ones(1, device="meta")
    with FlopCounterMode(display=False) as cond_count:
        cond = model.condition_model(x)
    with FlopCounterMode(display=False) as score_count:
        model.score_model(x, sigma, cond)
    return float(cond_count.get_total_flops() + n_steps * score_count.get_total_flops())


_counted = lru_cache(maxsize=64)(_network_flops)


def model_flops(cfg: dict, rows: int, t: int, n_steps: int) -> float:
    """Matrix and convolution FLOPs of one ``enhance`` of (rows, t) samples.
    The sampler pads each row to m = floor(t / tot_ds) + 1 periods of the
    total downsampling, and every layer's length is then m times a fixed
    number, so the count is affine in m: it is counted on the meta device at
    m = 2 and 3, one row (every operation is per row), and extended
    (``benchmark/tests/test_bench_roofline.py`` checks it against a direct
    count)."""
    import json
    import math

    tot_ds = math.prod(cfg["score_model"]["rate_factors"])
    key = json.dumps(cfg, sort_keys=True)
    m = t // tot_ds + 1
    f2, f3 = _counted(key, 2, n_steps), _counted(key, 3, n_steps)
    return rows * (f2 + (m - 2) * (f3 - f2))
