"""The ConvBlock rate-change kernel module (``ops/kernels/rate_change.py``).

On the CPU: the wrapper's plain block-view version against the unfused
``PReLUConv`` it replaces, the kernel's reduction order and weight layouts,
the source table's rule for each launch's core, and the ConvBlock's dispatch
(the kernel's route forced onto the CPU's plain version, and today's path
under autograd, for LoRA, bf16 and the CPU).  The CUDA kernel builds and
runs only on the card: the tests marked ``card`` hold each of its cores
against the plain version there, at every rate-change shape of the
benchmark's cells, and count its launches and cores per ``enhance``
(``python -m pytest --noconftest -m card tests/test_torch_rate_change.py``).
"""
import collections
import contextlib
import math
import re

import numpy as np
import pytest
import torch

from open_universe_tpu_torch.configs.registry import instantiate
from open_universe_tpu_torch.models import presets
from open_universe_tpu_torch.nn.blocks import ConvBlock, PReLUConv
from open_universe_tpu_torch.nn.layers import init_weights
from open_universe_tpu_torch.nn.lora import LoraLayer
from open_universe_tpu_torch.ops import kernels
from open_universe_tpu_torch.ops.kernels import build, conv_block, rate_change
from open_universe_tpu_torch.utils.convert import fold_weight_norm

TOL = 2e-5       # plain block view against the module, float32 on the CPU
CARD_TOL = 1e-4  # 3xTF32 kernel against the plain version: the f32 gate, of max|plain|


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: these small tensors gain nothing from more, and
    more oversubscribe the cores the other test workers use."""
    try:
        from threadpoolctl import threadpool_limits
        blas = threadpool_limits(1)  # numpy's BLAS too
    except ImportError:
        blas = contextlib.nullcontext()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with blas:
        yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU build")
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in float32
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = allow


def _module(direction, cin, cout, r, aa, seed=0):
    """A folded rate-change PReLUConv with a nonzero bias and slope."""
    conv = PReLUConv(cin, cout, r, stride=r, use_transpose=direction == "up",
                     antialiasing=aa)
    init_weights(conv, seed)
    with torch.no_grad():
        conv.prelu.weight.fill_(0.2)
        if conv.manual_bias:
            conv.bias.uniform_(-0.5, 0.5, generator=torch.Generator().manual_seed(seed))
    return conv


def _args(conv, r, direction):
    return (conv.conv.weight, conv.bias if conv.manual_bias else conv.conv.bias,
            conv.prelu.weight, r, direction,
            conv.low_pass_filter.weights if conv.antialiasing else None)


def _x(b, t, c, seed=1, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(b, t, c, generator=g).to(device)


def _close(a, b, tol):
    err, scale = (a - b).abs().max().item(), b.abs().max().item()
    assert a.shape == b.shape and math.isfinite(err) and err <= tol * scale, (err, scale)
    return err / scale


# every rate with both directions, with and without the low-pass; down
# inputs with T a multiple of r and not
CASES = [(d, r, aa, t) for r in rate_change.RATES for aa in (False, True)
         for d, t in (("down", 6 * r), ("down", 6 * r + r // 2 + 1), ("up", 7))]


@pytest.mark.parametrize("direction,r,aa,t", CASES)
def test_plain_version_matches_the_module(direction, r, aa, t):
    """The block-view GEMM (with its shifted-slice low-pass) is the strided
    or transposed conv of ``PReLUConv.forward``, at two rows that differ."""
    cin, cout = (8, 16) if direction == "down" else (16, 8)
    conv = _module(direction, cin, cout, r, aa)
    x = _x(2, t, cin)
    with torch.no_grad():
        ref = conv(x)
        got = rate_change.rate_change(x, *_args(conv, r, direction))
        alone = rate_change.rate_change(x[1:], *_args(conv, r, direction))
    assert got.shape == ((2, -(-t // r), cout) if direction == "down" else (2, t * r, cout))
    _close(got, ref, TOL)
    torch.testing.assert_close(alone, got[1:], rtol=0, atol=0)


def test_kernel_reduction_order_and_weight_cache():
    """The kernel's down reduction runs over (ci / 8, k, ci % 8) on its
    chunk rows; its weights in that order give the block view's product,
    and the fragment-ordered copy is made once and again after a write."""
    r, cin, cout = 4, 16, 32
    conv = _module("down", cin, cout, r, False)
    w = conv.conv.weight
    x = _x(2, 5 * r, cin)
    rows = x.reshape(2, 5, r, cin // 8, 8).permute(0, 1, 3, 2, 4).reshape(2, 5, r * cin)
    kernel_order = rate_change.gemm_weights(w, "down").detach()
    kernel_order = kernel_order.reshape(r, cin // 8, 8, cout).permute(1, 0, 2, 3)
    torch.testing.assert_close(
        rows @ kernel_order.reshape(r * cin, cout),
        x.reshape(2, 5, r * cin) @ rate_change.gemm_weights(w, "down").detach())
    with torch.no_grad():
        first = rate_change.kernel_weights(w, "down")
        assert rate_change.kernel_weights(w, "down") is first
        assert first.shape == (1, r * cin // 8, cout // 8, 32, 4)
        np.testing.assert_array_equal(
            first.reshape(-1).numpy(),
            conv_block.mma_weights_tf32_layout(
                kernel_order.reshape(1, r * cin, cout).contiguous()).reshape(-1).numpy())
        w.mul_(2.0)
        again = rate_change.kernel_weights(w, "down")
    assert again is not first
    np.testing.assert_array_equal(again.numpy(), 2.0 * first.numpy())


# RateWgTile<up, r, cin> entries of the source: the shapes with a wgmma core
_WG_ENTRY = re.compile(r"struct RateWgTile<(true|false), (\d+), (\d+)> \{[^}]*MIN_ROWS = (\d+);")


def _wgmma_table():
    src = (build.CSRC_DIR / f"{rate_change.SOURCE}.cu").read_text()
    return {("up" if up == "true" else "down", int(r), int(cin)): int(least)
            for up, r, cin, least in _WG_ENTRY.findall(src)}


@pytest.mark.parametrize("direction", rate_change.DIRECTIONS)
def test_rate_cores_follow_the_table(monkeypatch, direction):
    """A launch's core comes from the source's RateWgTile, read through the
    built library (here the source's text stands in for it): a shape without
    an entry has only mma_sync, one with an entry both, wgmma from its
    MIN_ROWS (at least 1) GEMM rows up; forcing a core the shape lacks raises
    before any launch."""
    table = _wgmma_table()
    assert table and all(d in rate_change.DIRECTIONS and r in rate_change.RATES
                         and least >= 1 for (d, r, _), least in table.items())
    monkeypatch.setattr(rate_change, "_wgmma_min_rows",
                        lambda d, r, cin, lib=None: table.get((d, r, cin), -1))
    cins = [c for c in conv_block.WIDTHS
            if (2 * c if direction == "down" else c // 2) in conv_block.WIDTHS]
    for r in rate_change.RATES:
        for cin in cins:
            least = table.get((direction, r, cin), -1)
            cores = rate_change.rate_cores(direction, r, cin)
            assert cores == (("mma_sync",) if least < 0 else conv_block.CORES)
            for rows in (1, max(least - 1, 1), max(least, 1), 128 * 32160):
                core = rate_change.rate_core(direction, r, cin, rows)
                assert core in cores
                assert (core == "wgmma") == (1 <= least <= rows)
                assert rate_change.launch_core(direction, r, cin, rows) == core
            for core in conv_block.CORES:
                if core in cores:
                    assert rate_change.launch_core(direction, r, cin, 1, core) == core
                else:
                    with pytest.raises(RuntimeError, match=f"no {core} core"):
                        rate_change.launch_core(direction, r, cin, 1, core)


@pytest.mark.parametrize("direction", rate_change.DIRECTIONS)
def test_wgmma_weights_hold_the_kernel_order(direction):
    """The wgmma core's weights are the block view's matrix in the kernel's
    order (down rows (ci / 8, k, ci % 8); up columns (co / 8, k, co % 8), so
    that an n8 tile is one output sample of 8 channels and a block's columns
    hold every sample of its channels), split into hi and lo in wgmma's
    K-major stream; each layout is cached apart on the weight tensor."""
    r, cin, cout = (3, 16, 32) if direction == "down" else (3, 32, 16)
    w = _module(direction, cin, cout, r, False).conv.weight
    with torch.no_grad():
        got = rate_change.kernel_weights(w, direction, "wgmma")
        assert rate_change.kernel_weights(w, direction, "wgmma") is got
        assert rate_change.kernel_weights(w, direction, "mma_sync") is not got
        m = rate_change.gemm_weights(w, direction)
        k, n = m.shape
        # (1, K/8, part, N/8, kh, n % 8, kk) -> (K, N), hi + lo
        back = got.reshape(k // 8, 2, n // 8, 2, 8, 4).permute(1, 0, 3, 5, 2, 4).reshape(2, k, n)
        assert torch.equal(back[0], conv_block.tf32_round(back[0]))
        want = rate_change.kernel_matrix(w, direction, "wgmma")
        torch.testing.assert_close(back[0] + back[1], want, rtol=0, atol=1e-6 * want.abs().max())
        if direction == "up":  # column (co / 8, k, co % 8) is sample k of channel co
            for co, kk in ((0, 0), (9, 2), (15, 1)):
                col = ((co // 8) * r + kk) * 8 + co % 8
                torch.testing.assert_close(want[:, col], w.detach()[:, co, kk])
        else:
            torch.testing.assert_close(want, rate_change.kernel_matrix(w, direction, "mma_sync"))


class _OnCard:
    """A CPU tensor's shape and type, on the card: lets the dispatch rules
    route a CPU tensor to the wrapper, which then runs its plain version."""

    def __init__(self, x):
        self.shape, self.dtype, self.dim = x.shape, x.dtype, x.dim
        self.device = torch.device("cuda")


def _block(direction, aa=True, c=32, r=4):
    block = ConvBlock(c, r, direction, antialiasing=aa, weight_norm=True)
    init_weights(block, 2)
    return fold_weight_norm(block)


@pytest.mark.parametrize("case", ["kernel", "autograd", "lora", "bf16", "cpu"])
def test_convblock_dispatch(monkeypatch, case):
    """An eligible block sends its rate change to the wrapper (here forced
    onto the CPU, whose plain version gives the module's result); under
    autograd, for a LoRA-wrapped conv, for bf16 and on the CPU it runs the
    module, with no call of the wrapper.  Neither counter moves: the plain
    version is no launch."""
    calls, force = [], {"on": False}
    real_takes, real_rate = rate_change.takes, rate_change.rate_change
    monkeypatch.setattr(rate_change, "takes", lambda d, x, w, r: real_takes(
        d, _OnCard(x) if force["on"] else x, w, r))
    monkeypatch.setattr(rate_change, "rate_change", lambda x, *a: calls.append(
        (a[-2], a[-1] is not None)) or real_rate(x, *a))
    rate_change.launches.clear()
    conv_block.launches.clear()
    for direction in ("down", "up"):
        block = _block(direction)
        if case == "lora":
            rc = block.rate_change_conv
            rc.conv = LoraLayer(rc.conv, 4, None, torch.Generator().manual_seed(0))
        h = _x(2, 64 if direction == "down" else 16, block.in_channels, seed=3)
        if case == "bf16":
            block, h = block.to(torch.bfloat16), h.to(torch.bfloat16)
        with torch.no_grad():
            module = block(h)  # the rate change by the module, on the CPU
        force["on"] = case != "cpu"
        if case == "autograd":
            with kernels.inference_scope():  # the parameters need gradients
                out = block(h)
        else:
            with torch.no_grad():
                out = block(h)
        force["on"] = False
        for a, b in zip(out, module):
            _close(a.float(), b.float(), TOL if case == "kernel" else 0.0)
    assert calls == ([("down", True), ("up", True)] if case == "kernel" else [])
    assert not rate_change.launches and not conv_block.launches


_NET = dict(fb_kernel_size=3, rate_factors=[2, 4], n_channels=32,
            extra_conv_block=True, use_weight_norm=True, seq_model="gru")
CFG = {
    "_target_": "open_universe.networks.universe.UniverseGAN",
    "fs": 16000, "normalization_norm": 2,
    "normalization_kwargs": {"ref": "both", "level_db": -26.0},
    "edm": {"noise": 0.25},
    "score_model": {"_target_": "open_universe.networks.universe.ScoreNetwork", **_NET,
                    "n_rff": 4, "noise_cond_dim": 16, "use_antialiasing": True,
                    "time_embedding": "simple"},
    "condition_model": {"_target_": "open_universe.networks.universe.ConditionerNetwork",
                        **_NET, "n_mels": 8, "n_mel_oversample": 4,
                        "encoder_gru_residual": True, "use_antialiasing": False},
    "diffusion": {"schedule": "geometric", "sigma_min": 0.0005, "sigma_max": 5.0,
                  "n_steps": 8, "epsilon": 1.3},
    "losses": {"use_signal_decoupling": True, "signal_decoupling_act": "snake"},
}


def test_enhance_routes_every_rate_change(monkeypatch):
    """One ``enhance`` of a narrow UNIVERSE++ (two rate factors) sends each
    rate change to the wrapper: 2 x 2 per score pass, all low-passed, and 2
    x 2 in the conditioner, none; the result is the module path's."""
    model = fold_weight_norm(init_weights(instantiate(CFG), seed=1)).eval()
    mix = _x(1, 1200, 1, seed=4)[..., 0] * 0.1
    calls = []
    real_takes, real_rate = rate_change.takes, rate_change.rate_change
    monkeypatch.setattr(rate_change, "takes",
                        lambda d, x, w, r: real_takes(d, _OnCard(x), w, r))
    monkeypatch.setattr(rate_change, "rate_change",
                        lambda x, *a: calls.append(a[-1] is not None) or real_rate(x, *a))

    def enhance():
        return model.enhance(mix, n_steps=2, generator=torch.Generator().manual_seed(3))

    routed = enhance()
    assert len(calls) == 2 * 4 + 4 and sum(calls) == 2 * 4
    monkeypatch.setattr(rate_change, "takes", real_takes)
    _close(routed, enhance(), 1e-4)


# -------------------------------------------------------------------- card
# (direction, Cin, Cout, r, T at 2 s) of the 16 kHz blocks, then the 24 kHz
SHAPES_16K = [("down", 32, 64, 2, 32000), ("down", 64, 128, 4, 16000),
              ("down", 128, 256, 4, 4000), ("down", 256, 512, 5, 1000),
              ("up", 512, 256, 5, 200), ("up", 256, 128, 4, 1000),
              ("up", 128, 64, 4, 4000), ("up", 64, 32, 2, 16000)]
SHAPES_24K = [("down", 48, 96, 2, 48000), ("down", 96, 192, 3, 24000),
              ("down", 192, 384, 5, 8000), ("down", 384, 768, 8, 1600),
              ("up", 768, 384, 8, 200), ("up", 384, 192, 5, 1600),
              ("up", 192, 96, 3, 8000), ("up", 96, 48, 2, 24000)]
CARD_CASES = ([(s, aa, b) for s in SHAPES_16K for aa in (False, True) for b in (2, 128)]
              + [(s, aa, 2) for s in SHAPES_24K for aa in (False, True)]
              + [(s, aa, 128) for s in SHAPES_24K if s[3] >= 3 for aa in (False, True)]
              + [(("down", 64, 128, 4, 1001), True, 2), (("down", 32, 64, 2, 77), False, 3),
                 (("up", 512, 256, 5, 7), True, 3), (("up", 64, 32, 2, 129), True, 2)])


@pytest.mark.card
@pytest.mark.parametrize("core", conv_block.CORES)
@pytest.mark.parametrize("shape,aa,b", CARD_CASES)
def test_kernel_matches_plain_version_on_card(card, shape, aa, b, core):
    """The kernel on ``core`` against its plain version on the card, within
    the 3xTF32 float32 gate, rows that differ, contiguous outputs, one
    counted launch under its key and its core; where the source's table
    gives the shape no such core, forcing it raises and launches nothing."""
    direction, cin, cout, r, t = shape
    conv = _module(direction, cin, cout, r, aa, seed=cin + r).to(card)
    x = _x(b, t, cin, seed=t + b, device=card)
    rate_change.launches.clear()
    rate_change.core_launches.clear()
    if core not in rate_change.rate_cores(direction, r, cin):
        with pytest.raises(RuntimeError, match=f"no {core} core"):
            rate_change.rate_change(x, *_args(conv, r, direction), core=core)
        assert not rate_change.launches and not rate_change.core_launches
        return
    with torch.no_grad():
        got = rate_change.rate_change(x, *_args(conv, r, direction), core=core)
        torch.cuda.synchronize()
        ref = rate_change.rate_change_reference(x, *_args(conv, r, direction))
    assert got.is_contiguous()
    rel = _close(got, ref, CARD_TOL)
    print(f"[rate_change] {direction} {cin}->{cout} r={r} T={t} B={b} aa={aa:d} {core}: "
          f"max|d| = {rel:.2e} max|ref|")
    assert dict(rate_change.launches) == {
        (direction, rate_change.ROUTE, cin, cout, r, t, aa): 1}
    assert dict(rate_change.core_launches) == {(core, direction, r, cin): 1}


@pytest.mark.card
@pytest.mark.parametrize("preset,aa", [("universe_original", 0), ("universepp", 64)])
def test_enhance_launches_on_card(card, preset, aa):
    """One f32 ``enhance`` at batch 2 x 2 s makes 72 rate-change launches:
    8 score passes and the conditioner, 4 down and 4 up each; UNIVERSE++
    low-passes the 64 of its score network; each launch runs the core the
    source's table gives its shape and rows."""
    model = fold_weight_norm(getattr(presets, preset)(device=card, seed=0)).eval()
    mix = _x(2, 32000, 1, seed=5, device=card)[..., 0] * 0.1
    rate_change.launches.clear()
    rate_change.core_launches.clear()
    out = model.enhance(mix, n_steps=8, generator=torch.Generator(card).manual_seed(0))
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    n = sum(rate_change.launches.values())
    low_passed = sum(v for k, v in rate_change.launches.items() if k[-1])
    want = collections.Counter()
    for (direction, _, cin, _, r, t, _), k in rate_change.launches.items():
        rows = rate_change.gemm_rows(direction, 2, t, r)
        want[(rate_change.rate_core(direction, r, cin, rows), direction, r, cin)] += k
    print(f"[rate_change] {preset} enhance: {n} launches, {low_passed} low-passed, "
          f"cores {dict(rate_change.core_launches)}")
    assert (n, low_passed) == (72, aa)
    assert rate_change.core_launches == want
