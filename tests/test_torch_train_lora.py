"""LoRA fine-tuning through the port's training entry point, end to end on
the CPU: ``python -m open_universe_tpu_torch.train
experiment=universepp_lora_finetune model.model=<ckpt>
model.losses.phonemeloss=null device=cpu`` on a narrow UNIVERSE++
checkpoint that the port's own trainer wrote.  It trains 2 steps (only the
adapters and biases move), validates through ``_validate_enhancement``
(``val/multires_l1`` and the metrics, the fused chain's wrappers never
called), and writes reference-layout checkpoints that ``load_model`` reads
as a ``UniverseLoRA`` (and ``merge_lora`` folds), that the enhance CLI
runs, that the JAX package's ``load_model`` (its ``convert_state_dict``, on
a JAX ``UniverseLoRA`` built on the same base) reads into the port's
weights exactly, and that a resumed run restores bit for bit.  The recipe
as shipped, with its ``PhonemeCTCLoss`` on a tiny random wav2vec2, trains
and validates too.
"""
import json

import numpy as np
import pytest
from threadpoolctl import threadpool_limits
import torch

from open_universe_tpu_torch.bin import enhance as port_enhance
from open_universe_tpu_torch.data.audio import load_audio, save_audio
from open_universe_tpu_torch.inference.model_loader import (
    load_model, normalize_key, ordered_param_names,
)
from open_universe_tpu_torch.models.universe_lora import UniverseLoRA
from open_universe_tpu_torch.nn import lora as plora
from open_universe_tpu_torch.ops.kernels import conv_block
from open_universe_tpu_torch.train.__main__ import main as train_main
from open_universe_tpu_torch.utils.convert import from_jax_params
from test_torch_universe_original import _assert_same
from test_torch_validate import NARROW, write_splits

FS = 16000
LORA = ["experiment=universepp_lora_finetune", "device=cpu", "model.losses.phonemeloss=null",
        "model.diffusion.n_steps=2", "model.lora_rank=2",
        "datamodule.datasets.vb-train-16k.audio_len=0.05",
        "datamodule.train.dl_opts.batch_size=2", "trainer.log_every=1",
        "trainer.val_check_interval=2", "trainer.checkpoint_every=1",
        "model.validation.max_enh_batches=1"]


def _has_lora(module):
    return any(isinstance(m, plora.LoraLayer) for m in module.modules())


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):  # numpy's BLAS too
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A narrow UNIVERSE++ checkpoint from the port's trainer (1 step), then
    the fine-tuning entry point on it (2 steps, a validation at 2)."""
    tmp = tmp_path_factory.mktemp("lora")
    data = tmp / "data"
    write_splits(data, train=(2000,) * 4, val=(4000,), test=(3000,))
    torch.manual_seed(0)
    train_main(NARROW + [
        "device=cpu", f"datamodule.datasets.vb-train-16k.audio_path={data}",
        "trainer.max_steps=1", "trainer.val_check_interval=100", "trainer.log_every=1",
        f"path.exp_root={tmp / 'base'}"])
    (base_ckpt,) = (tmp / "base").glob("universepp_vb_16k/*/checkpoints/step_00000001.ckpt")
    calls = []
    real = conv_block.fused_conv_chain
    conv_block.fused_conv_chain = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        args = LORA + [f"model.model={base_ckpt}",
                       f"datamodule.datasets.vb-train-16k.audio_path={data}"]
        tr = train_main(args + ["trainer.max_steps=2", f"path.exp_root={tmp / 'exp'}"])
    finally:
        conv_block.fused_conv_chain = real
    (run_dir,) = (tmp / "exp" / "universepp_lora_finetune").iterdir()
    return {"tmp": tmp, "data": data, "args": args, "base_ckpt": base_ckpt,
            "tr": tr, "run_dir": run_dir, "calls": calls}


def test_fine_tuning_trains_adapters_and_validates(runs):
    """Two steps: every loss finite; only the adapters and biases move (the
    frozen weights equal the base checkpoint's EMA weights bit for bit); a
    validation with val/multires_l1, the discriminators' terms, val/pesq
    and val/lsd; no call of the fused chain's wrapper (adapters attached
    in the steps, the sampler's no-grad steps and the validation)."""
    tr, run_dir = runs["tr"], runs["run_dir"]
    model = tr.model
    assert isinstance(model, UniverseLoRA) and _has_lora(model)
    assert not runs["calls"]
    rows = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    train_rows = [r for r in rows if "train/main_loss" in r]
    assert [r["step"] for r in train_rows] == [1, 2]
    keys = ("train/main_loss", "train/multires_l1", "train/mpd", "train/mrd", "train/mpd_fm",
            "train/mrd_fm", "grad/norm")
    assert all(np.isfinite(r[k]) for r in train_rows for k in keys)
    val = [r for r in rows if "val/multires_l1" in r]
    assert [r["step"] for r in val] == [2]
    assert all(np.isfinite(val[0][k]) for k in ("val/main_loss", "val/multires_l1", "val/mpd",
                                                 "val/pesq", "val/lsd"))
    best = json.loads((run_dir / "checkpoints" / "best.json").read_text())
    assert best["metric"] == "val/multires_l1" and best["step"] == 2

    base_sd = load_model(runs["base_ckpt"], device="cpu", trainable=True).state_dict()
    nests = {path: m.nest for path, m in model.named_modules()
             if isinstance(m, plora.LoraLayer)}

    def base_name(name):
        """model.<path>.conv.<leaf> of a wrapped layer is <path>.<leaf>."""
        mod, _, leaf = name.rpartition(".")
        parent, _, last = mod.rpartition(".")
        if nests.get(parent) == last:
            name = f"{parent}.{leaf}"
        return name[len("model."):]

    frozen = [(n, p) for n, p in model.named_parameters() if not p.requires_grad]
    assert frozen and all(torch.equal(p.detach(), base_sd[base_name(n)]) for n, p in frozen)
    # the conv adapters' A starts at zero: the steps moved it
    assert any(p.detach().abs().max() > 0 for n, p in model.named_parameters()
               if n.endswith("lora_weight_a"))


def test_checkpoint_loads_merges_runs_the_cli_and_jax_reads_it(runs, tmp_path):
    """The last checkpoint: the reference layout (``model._edm_model.``, the
    adapters' leaves, the kept discriminators, one optimizer, the EMA shadow
    of every ``model.`` parameter); ``load_model`` gives a UniverseLoRA with
    the EMA weights; its enhance equals merge_lora's (<= 1e-4); the enhance
    CLI writes a finite file; the JAX package's load_model reads the same
    checkpoint into the same weights, bit for bit."""
    ckpt = runs["run_dir"] / "checkpoints" / "step_00000002.ckpt"
    saved = torch.load(ckpt, map_location="cpu", weights_only=False)
    sd = saved["state_dict"]
    assert any(k.startswith("model._edm_model.") and "lora_weight_a" in k for k in sd)
    assert any(k.startswith("model.condition_model.") and ".conv.conv." in k for k in sd)
    assert any(k.startswith("model.loss_mpd.") for k in sd)
    assert not any(k.startswith("model.score_model.") for k in sd)
    assert len(saved["optimizer_states"]) == len(saved["lr_schedulers"]) == 1
    assert saved["ema"]["num_updates"] == 2
    names = ordered_param_names(sd, ["model"])
    assert len(names) == len(saved["ema"]["shadow_params"])

    model = load_model(ckpt, device="cpu")
    assert isinstance(model, UniverseLoRA) and _has_lora(model)
    loaded = model.state_dict()
    for n, s in zip(names, saved["ema"]["shadow_params"]):
        torch.testing.assert_close(loaded[normalize_key(n)], s, rtol=0, atol=0)
    mix = torch.from_numpy((0.05 * np.random.default_rng(1).standard_normal((1, 1600)))
                           .astype(np.float32))
    g = torch.Generator().manual_seed(4)
    noise = [torch.randn((1, 1760, 1), generator=g) for _ in range(2)]
    out = model.enhance(mix, n_steps=2, noise=noise)
    merged = model.merge_lora().enhance(mix, n_steps=2, noise=noise)
    assert out.shape == (1, 1600) and torch.isfinite(out).all()
    assert (out - merged).abs().max().item() <= 1e-4

    src, dst = tmp_path / "in", tmp_path / "out"
    src.mkdir()
    save_audio(src / "a.wav", mix.numpy(), FS)
    port_enhance.main([str(src), str(dst), "--model", str(ckpt), "--device", "cpu",
                       "--n_steps", "2", "--batch-size", "1"])
    y, fs = load_audio(dst / "a.wav")
    assert fs == FS and y.shape == (1, 1600) and np.isfinite(y).all() and np.abs(y).max() > 0

    pytest.importorskip("jax")
    from open_universe_tpu.inference.model_loader import load_model as jax_load_model
    from open_universe_tpu.models.universe_lora import UniverseLoRA as JLoRA

    jm, jp = jax_load_model(str(ckpt))
    assert isinstance(jm, JLoRA)
    import jax

    # the JAX tree in the port's layout is the port's model, bit for bit
    check = load_model(ckpt, device="cpu")
    for p in check.parameters():
        p.data.zero_()
    assert from_jax_params(check, jax.tree_util.tree_map(np.asarray, jp)) == []
    for k, v in check.state_dict().items():
        assert torch.equal(v, loaded[k]), k


def test_resume_restores_bit_for_bit(runs):
    """A run resumed from the step-1 checkpoint holds its model (adapters,
    the kept discriminators), optimizer, update count, EMA and step."""
    ckpts = sorted((runs["run_dir"] / "checkpoints").glob("*.ckpt"))
    assert [c.name for c in ckpts] == ["step_00000001.ckpt", "step_00000002.ckpt"]
    first = torch.load(ckpts[0], map_location="cpu", weights_only=False)
    tmp = runs["tmp"]
    tr = train_main(runs["args"] + ["trainer.max_steps=2", "train=false",
                                    f"ckpt_path={ckpts[0]}", f"path.exp_root={tmp / 'resumed'}"])
    step = tr.step_fn
    assert (step.step, step.updates, tr.ema.num_updates) == (1, 1, 1)
    _assert_same(tr.model.state_dict(),
                 {normalize_key(k): v for k, v in first["state_dict"].items()})
    _assert_same(step.opt.state_dict(), first["optimizer_states"][0])
    names = ordered_param_names(first["state_dict"], ["model"])
    _assert_same([tr.ema.shadow[normalize_key(n)] for n in names],
                 first["ema"]["shadow_params"])


def test_fine_tuning_with_the_phoneme_loss_as_shipped(runs, tmp_path):
    """The recipe as shipped, its ``PhonemeCTCLoss`` on: the entry point with
    ``+model.losses.phonemeloss.kwargs.checkpoint=<dir>`` (a tiny random
    wav2vec2 that ``transformers``' ``save_pretrained`` wrote) trains a step
    and validates with ``train/phonemeloss`` and ``val/phonemeloss``
    finite, and writes a checkpoint with the keys of a run without the
    loss (no wav2vec2 tensor) that ``load_model`` reads."""
    transformers = pytest.importorskip("transformers")
    from test_torch_phoneme import TINY

    torch.manual_seed(0)
    transformers.Wav2Vec2ForCTC(transformers.Wav2Vec2Config(**TINY)).save_pretrained(
        tmp_path / "w2v")
    args = [a for a in runs["args"] if a != "model.losses.phonemeloss=null"]
    train_main(args + [f"+model.losses.phonemeloss.kwargs.checkpoint={tmp_path / 'w2v'}",
                       "trainer.max_steps=1", "trainer.val_check_interval=1",
                       f"path.exp_root={tmp_path / 'exp'}"])
    (run_dir,) = (tmp_path / "exp" / "universepp_lora_finetune").iterdir()
    rows = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    assert all(np.isfinite(r[k]) for r in rows for k in r
               if k.endswith(("phonemeloss", "main_loss")))
    assert [k for r in rows for k in r if k.endswith("phonemeloss")] == \
        ["train/phonemeloss", "val/phonemeloss"]
    (ckpt,) = (run_dir / "checkpoints").glob("*.ckpt")
    keys = set(torch.load(ckpt, map_location="cpu", weights_only=False)["state_dict"])
    plain = runs["run_dir"] / "checkpoints" / "step_00000001.ckpt"
    assert keys == set(torch.load(plain, map_location="cpu", weights_only=False)["state_dict"])
    assert isinstance(load_model(ckpt, device="cpu"), UniverseLoRA)


def test_24k_fine_tuning_composes_and_trains(tmp_path):
    """``experiment=universepp_24k_lora_finetune`` on a narrow 24 kHz
    UNIVERSE++ checkpoint (the port's trainer, 1 step): one fine-tuning step
    with finite losses, and its checkpoint loads as a 24 kHz UniverseLoRA."""
    from scipy.io import wavfile

    rng = np.random.default_rng(3)
    for d in ("noisy", "clean"):
        (tmp_path / "data" / "train" / d).mkdir(parents=True)
    for i in range(4):
        c = rng.standard_normal(3000) * 0.05
        for d, x in (("clean", c), ("noisy", c + rng.standard_normal(3000) * 0.02)):
            wavfile.write(tmp_path / "data" / "train" / d / f"f{i}.wav", 24000,
                          (x * 32767).astype(np.int16))
    data = [f"datamodule.datasets.vb-train-24k.audio_path={tmp_path / 'data'}",
            "datamodule.datasets.vb-train-24k.audio_len=0.05",
            "datamodule.train.dl_opts.batch_size=2", "trainer.max_steps=1",
            "trainer.val_check_interval=100", "trainer.log_every=1", "device=cpu"]
    narrow = [o for o in NARROW if not o.startswith(("experiment=", "datamodule."))]
    train_main(["experiment=universepp_vb_24k", *narrow, *data,
                f"path.exp_root={tmp_path / 'base'}"])
    (base,) = (tmp_path / "base").glob("universepp_vb_24k/*/checkpoints/*.ckpt")
    tr = train_main(["experiment=universepp_24k_lora_finetune", f"model.model={base}",
                     "model.losses.phonemeloss=null", "model.diffusion.n_steps=2",
                     "model.lora_rank=2", *data, f"path.exp_root={tmp_path / 'exp'}"])
    assert isinstance(tr.model, UniverseLoRA) and tr.model.fs == 24000
    (run_dir,) = (tmp_path / "exp" / "universepp_24k_lora_finetune").iterdir()
    (row,) = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    assert all(np.isfinite(row[k]) for k in ("train/main_loss", "train/multires_l1", "train/mpd"))
    (ckpt,) = (run_dir / "checkpoints").glob("*.ckpt")
    model = load_model(ckpt, device="cpu")
    assert isinstance(model, UniverseLoRA) and model.fs == 24000 and _has_lora(model)
