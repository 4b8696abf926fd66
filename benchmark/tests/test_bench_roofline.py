"""The yardstick's arithmetic: the fused chain's bound at the main path's
shapes (PERF.md section 6: C = 32..512 at the lengths of a 2 s clip), and
the model FLOPs' extension from two counted lengths."""
import json
import math

import pytest

from benchmark.common import roofline

from .conftest import ROOT

# ConvBlock width -> its length on a 2 s clip at 16 kHz
WIDTH_LENGTHS = {32: 32160, 64: 16080, 128: 4020, 256: 1005, 512: 201}


def test_bound_of_a_byte_bound_and_an_operation_bound_shape():
    # C = 32: 3 B T C elements of h, v and cond_out dominate
    flops, nbytes = roofline.conv_block_work(128, 32160, 32, False, False, "bfloat16")
    assert flops == 22 * 128 * 32160 * 32 * 32
    assert nbytes == 2 * (3 * 128 * 32160 * 32 + 11 * 32 * 32 + 3 * 32) + 12
    assert roofline.conv_block_bound_s(128, 32160, 32, False, False, "bfloat16") == \
        pytest.approx(nbytes / 3.35e12)
    # C = 512: the FLOPs dominate; float32 work counts once at 495 TFLOP/s
    for dtype, peak in (("bfloat16", 989e12), ("float32", 495e12)):
        t = roofline.conv_block_bound_s(128, 201, 512, True, True, dtype)
        assert t == pytest.approx(22 * 128 * 201 * 512 ** 2 / peak)


def test_launches_bound_sums_the_wrappers_keys():
    keys = {("fused_conv_chain", "f32_tensor_cores_3xtf32", c, t, True, c != 512): 2
            for c, t in WIDTH_LENGTHS.items()}
    want = sum(2 * roofline.conv_block_bound_s(4, t, c, True, c != 512, "float32")
               for c, t in WIDTH_LENGTHS.items())
    assert roofline.launches_bound_s(keys, 4) == pytest.approx(want)


@pytest.mark.parametrize("name", ["universepp_16k", "universe_16k"])
def test_model_flops_extend_exactly(name):
    cfg = json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())["model"]
    m = 32000 // 160 + 1
    counted = roofline._network_flops(json.dumps(cfg, sort_keys=True), m, 8)
    assert roofline.model_flops(cfg, 1, 32000, 8) == counted
    # a batch-128 x 2 s call: ~18.7 TFLOP, mostly the 94 chains
    total = roofline.model_flops(cfg, 128, 32000, 8)
    chains = sum(22 * 128 * t * c * c * n for (c, t), n in zip(
        WIDTH_LENGTHS.items(), (18, 18, 18, 18, 22)))
    assert 18e12 < total < 19e12 and chains < total
    assert math.isclose(roofline.model_flops(cfg, 3, 32000, 8), 3 * counted / 128 * 128)
