"""The plain UNIVERSE's training entry point end to end in the PyTorch port,
on the CPU: ``python -m open_universe_tpu_torch.train
experiment=universe_original_vb_16k`` at a narrow width (4 channels, 16
mels, 800-sample crops) trains 2 steps, validates, tests and writes
reference-layout checkpoints without importing JAX; ``load_model``, the
enhance CLI and the HTTP server read the last one; a run resumed from the
first restores the model (MDN loss modules included), the optimizer, its
update count, EMA and the step bit for bit.
"""
import json
import os
import subprocess
import sys
import threading
import urllib.request
from pathlib import Path

import numpy as np
import torch

from open_universe_tpu_torch.bin import enhance as port_enhance
from open_universe_tpu_torch.bin.serve import make_server
from open_universe_tpu_torch.data.audio import load_audio, save_audio
from open_universe_tpu_torch.inference.model_loader import load_model, ordered_param_names
from open_universe_tpu_torch.models.universe import Universe
from open_universe_tpu_torch.train.__main__ import main as train_main
from test_torch_universe_original import _assert_same
from test_torch_validate import write_splits

ROOT = Path(__file__).resolve().parents[1]
FS = 16000
NARROW = ["experiment=universe_original_vb_16k", "device=cpu",
          "model.score_model.n_channels=4", "model.score_model.noise_cond_dim=32",
          "model.condition_model.n_mels=16", "model.diffusion.n_steps=2",
          "datamodule.datasets.vb-train-16k.audio_len=0.05",
          "datamodule.train.dl_opts.batch_size=2", "trainer.log_every=1",
          "trainer.val_check_interval=2", "trainer.checkpoint_every=1"]


def test_entry_point_trains_and_its_checkpoint_loads_enhances_serves_and_resumes(tmp_path):
    data = tmp_path / "data"
    write_splits(data, train=(2000,) * 4, val=(4000,), test=(4000, 3000))
    overrides = NARROW + [f"datamodule.datasets.vb-train-16k.audio_path={data}",
                          "trainer.max_steps=2", "test=true",
                          f"path.exp_root={tmp_path / 'exp'}"]
    code = (
        "import runpy, sys\n"
        f"sys.argv = ['train'] + {overrides!r}\n"
        "runpy.run_module('open_universe_tpu_torch.train', run_name='__main__')\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'open_universe_tpu' or m.startswith('open_universe_tpu.')]\n"
        "assert not bad, bad\n")
    # one intra-op thread: the test workers share the cores
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    (run_dir,) = (tmp_path / "exp" / "universe_original_vb_16k").iterdir()
    ckpts = sorted((run_dir / "checkpoints").glob("*.ckpt"))
    assert [c.name for c in ckpts] == ["step_00000001.ckpt", "step_00000002.ckpt"]
    rows = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    train_rows = [r for r in rows if "train/loss" in r]
    assert [r["step"] for r in train_rows] == [1, 2]
    assert all(np.isfinite(r[k]) for r in train_rows
               for k in ("train/loss", "train/score", "train/signal", "train/latent",
                         "grad/norm", "grad/clipped_norm"))
    val = [r for r in rows if "val/score" in r]
    assert [r["step"] for r in val] == [2] and np.isfinite(val[0]["val/pesq"])
    summary = json.loads((run_dir / "test_summary.json").read_text())
    assert summary["number"] == 2 and np.isfinite(summary["pesq"])

    # load_model: the EMA shadows as the weights, no loss module
    saved = torch.load(ckpts[-1], map_location="cpu", weights_only=False)
    sd = saved["state_dict"]
    assert any(k.startswith("loss_signal.layer_norm.") for k in sd)
    assert any(k.startswith("loss_latent.conv.") for k in sd)
    assert len(saved["optimizer_states"]) == len(saved["lr_schedulers"]) == 1
    assert saved["lr_schedulers"][0]["updates"] == 2 and saved["ema"]["num_updates"] == 2
    names = ordered_param_names(sd, ["score_model", "condition_model"])
    model = load_model(ckpts[-1], device="cpu")
    assert type(model) is Universe and not model.loss_param_keys()
    loaded = model.state_dict()
    for name, s in zip(names, saved["ema"]["shadow_params"]):
        torch.testing.assert_close(loaded[name], s, rtol=0, atol=0)

    # the enhance CLI
    src, dst = tmp_path / "in", tmp_path / "out"
    src.mkdir()
    x = (0.05 * np.random.default_rng(0).standard_normal((1, 5000))).astype(np.float32)
    save_audio(src / "a.wav", x, FS)
    port_enhance.main([str(src), str(dst), "--model", str(ckpts[-1]), "--device", "cpu",
                       "--n_steps", "2", "--batch-size", "1"])
    y, fs = load_audio(dst / "a.wav")
    assert fs == FS and y.shape == (1, 5000) and np.isfinite(y).all() and np.abs(y).max() > 0

    # the server
    srv, service = make_server(model, model_name="original", port=0, max_batch=2,
                               batch_window_ms=10.0, bucket_seconds=0.5,
                               max_clip_seconds=1.0, enhance_kwargs={"n_steps": 2})
    th = threading.Thread(target=srv.serve_forever, kwargs={"poll_interval": 0.05},
                          daemon=True)
    th.start()
    try:
        wav = src / "a.wav"
        req = urllib.request.Request(f"http://127.0.0.1:{srv.server_address[1]}/enhance",
                                     data=wav.read_bytes(),
                                     headers={"Content-Type": "audio/wav"})
        with urllib.request.urlopen(req, timeout=120) as r:
            assert r.status == 200
            (dst / "served.wav").write_bytes(r.read())
    finally:
        srv.shutdown()
        service.close()
    y, _ = load_audio(dst / "served.wav")
    assert y.shape == (1, 5000) and np.isfinite(y).all()

    # resume from step 1: the restored state is the checkpoint's, bit for bit
    first = torch.load(ckpts[0], map_location="cpu", weights_only=False)
    tr = train_main(NARROW + [f"datamodule.datasets.vb-train-16k.audio_path={data}",
                              "trainer.max_steps=2", "train=false", f"ckpt_path={ckpts[0]}",
                              f"path.exp_root={tmp_path / 'resumed'}"])
    step = tr.step_fn
    assert (step.step, step.updates, tr.ema.num_updates) == (1, 1, 1)
    _assert_same(tr.model.state_dict(), first["state_dict"])
    _assert_same(step.opt.state_dict(), first["optimizer_states"][0])
    _assert_same([tr.ema.shadow[n] for n in names], first["ema"]["shadow_params"])
