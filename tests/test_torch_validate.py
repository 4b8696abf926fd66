"""Validation, test and resume of UNIVERSE++ training in the PyTorch port
against the JAX package's ``Trainer``, at a narrow width on the CPU.

The module fixture builds both trainers on the same config, data and
numpy-drawn weights (``from_jax_params``; an EMA shadow apart from the raw
weights), runs JAX's ``validate`` and ``test`` once (their jitted functions
compile once, for one 2 s bucket) and the port's with JAX's draws handed
over (sigma's uniform draws and the score's noise of each bin, the
sampler's noise of each ``enhance``).  Tolerances: the binned score losses
and LSD <= 1e-4 relative (the port validates on folded weights through the
fused chain's plain version, JAX unfolded and unfused), PESQ <= 1e-3
absolute (its delay search is discrete); one bin's loss alone <= 1e-5
relative; the folded-EMA validation against the unfolded one <= 1e-5.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from threadpoolctl import threadpool_limits

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from open_universe_tpu.configs import registry as jregistry  # noqa: E402
from open_universe_tpu.configs.resolve import compose as jax_compose  # noqa: E402
from open_universe_tpu.parallel.mesh import make_mesh  # noqa: E402
from open_universe_tpu.train import trainer as jtrainer  # noqa: E402
from open_universe_tpu_torch.configs import registry as pregistry  # noqa: E402
from open_universe_tpu_torch.configs.resolve import compose as port_compose  # noqa: E402
from open_universe_tpu_torch.ops.kernels import conv_block  # noqa: E402
from open_universe_tpu_torch.train import trainer as ptrainer  # noqa: E402
from open_universe_tpu_torch.utils.convert import from_jax_params  # noqa: E402
from test_torch_enhance import _jax_draws  # noqa: E402
from test_torch_train import draw_params  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FS = 16000
N_STEPS = 4
VAL_LENGTHS = (20800, 28800)  # 1.3 and 1.8 s: one 2 s bucket
TEST_LENGTHS = (19200, 27200)  # 1.2 and 1.7 s
T_PADDED = 32160  # the 2 s bucket plus Universe.pad's full period
REL_TOL, PESQ_TOL = 1e-4, 1e-3
_D = "model.losses.multi_period_discriminator."
_R = "model.losses.multi_resolution_discriminator."
NARROW = ["experiment=universepp_vb_16k",
          "model.score_model.n_channels=4", "model.score_model.noise_cond_dim=32",
          "model.condition_model.n_mels=16", f"{_D}mpd_reshapes=[2,3]",
          f"{_D}discriminator_channel_mult=0.25", f"{_R}discriminator_channel_mult=0.25",
          f"{_R}resolutions=[[128,30,75],[256,60,150],[64,12,30]]",
          f"model.diffusion.n_steps={N_STEPS}",
          "datamodule.datasets.vb-train-16k.audio_len=0.05",
          "datamodule.train.dl_opts.batch_size=2"]


def write_splits(root, train=(2000,) * 4, val=VAL_LENGTHS, test=TEST_LENGTHS, seed=0):
    """Paired 16 kHz WAVs in the NoisyDataset layout: a modulated tone in
    noise, one pair per length and split."""
    from scipy.io import wavfile

    rng = np.random.default_rng(seed)
    for split, lengths in (("train", train), ("val", val), ("test", test)):
        for d in ("noisy", "clean"):
            (root / split / d).mkdir(parents=True, exist_ok=True)
        for i, n in enumerate(lengths):
            t = np.arange(n) / FS
            c = 0.1 * np.sin(2 * np.pi * (180 + 40 * i) * t) * (1 + 0.5 * np.sin(2 * np.pi * 3 * t))
            c = c + 0.005 * rng.standard_normal(n)
            for d, x in (("clean", c), ("noisy", c + 0.03 * rng.standard_normal(n))):
                wavfile.write(root / split / d / f"f{i:02d}.wav", FS,
                              (x * 32767).astype(np.int16))


def overrides(data, *extra):
    return NARROW + [f"datamodule.datasets.vb-train-16k.audio_path={data}", *extra]


def jax_val_draws(n_val, n_enh, shape=(1, T_PADDED, 1)):
    """JAX ``Trainer.validate``'s draws in the order the port takes them:
    per batch, for each of the 5 bins, split the key and take (u, z) from
    compute_losses' (k_sigma, k_noise); then the enhance's from a split."""
    key = jax.random.key(jtrainer.VAL_SEED)
    draws = []
    for bi in range(n_val):
        for _ in range(5):
            key, sub = jax.random.split(key)
            k_sigma, k_noise = jax.random.split(sub)
            draws.append({"u": np.asarray(jax.random.uniform(k_sigma, (shape[0],))),
                          "z": np.asarray(jax.random.normal(k_noise, shape))})
        if bi < n_enh:
            key, sub = jax.random.split(key)
            draws.append({"noise": _jax_draws(sub, shape, N_STEPS)})
    return draws


def jax_test_draws(n_test, shape=(1, T_PADDED, 1)):
    key = jax.random.key(jtrainer.VAL_SEED)
    draws = []
    for _ in range(n_test):
        key, sub = jax.random.split(key)
        draws.append({"noise": _jax_draws(sub, shape, N_STEPS)})
    return draws


def port_trainer(cfg, run_dir, params=None, shadow=None, **kw):
    """The port's Trainer on ``cfg``; with ``params`` (a JAX param tree) as
    its weights and ``shadow`` as its EMA shadow."""
    model = pregistry.instantiate_trainable(cfg["model"])
    dm = pregistry.instantiate(cfg["datamodule"])
    tr = ptrainer.Trainer(model, dm, run_dir, device="cpu", seed=cfg.get("seed", 0),
                          config={k: v for k, v in cfg.items() if not k.startswith("_")}, **kw)
    if params is not None:
        assert from_jax_params(tr.model, params) == []
        twin = pregistry.instantiate_trainable(cfg["model"])
        from_jax_params(twin, {**params, **shadow})
        own = dict(twin.named_parameters())
        with torch.no_grad():
            for n, s in tr.ema.shadow.items():
                s.copy_(own[n])
    return tr


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for torch and for numpy's BLAS (validation's
    P.862): more oversubscribe the cores the other test workers use."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's validate and test, and the port's on JAX's draws."""
    tmp = tmp_path_factory.mktemp("validate")
    write_splits(tmp / "data")
    ov = overrides(tmp / "data")
    jcfg, pcfg = jax_compose(ROOT / "config", ov), port_compose(ROOT / "config", ov)
    jm = jregistry.instantiate(jcfg["model"])
    params = jax.tree_util.tree_map(np.asarray, draw_params(jm, seed=5))
    jm.init = lambda key: params  # the numpy weights, without JAX's eager init
    with pytest.MonkeyPatch.context() as mp:
        # validate and test read the weights and the EMA shadow only: the
        # optimizers' eager init (~2600 ops, each compiled) is skipped
        mp.setattr(jtrainer, "init_train_state",
                   lambda model, p, tx, **kw: {"params": p, "step": jnp.zeros((), jnp.int32)})
        jt = jtrainer.Trainer(jm, jregistry.instantiate(jcfg["datamodule"]), tmp / "jax",
                              max_steps=10, mesh=make_mesh(dp=1), seed=0)
    rng = np.random.default_rng(6)
    shadow = {k: jax.tree_util.tree_map(
        lambda v: (v * (1.0 + 0.05 * rng.standard_normal(v.shape))).astype(np.float32),
        params[k]) for k in jm.model_param_keys()}
    jt.state["ema"] = {"shadow": shadow, "num_updates": jnp.zeros((), jnp.int32)}
    jax_val = jt.validate(2)
    jax_pr_cum = np.asarray(jt.pr_cum)
    jax_test = jt.test(4)

    pt = port_trainer(pcfg, tmp / "port", params, shadow)
    n_enh = min(len(VAL_LENGTHS), pt.model.val_kwargs.get("max_enh_batches", 4))
    port_val = pt.validate(2, draws=iter(jax_val_draws(len(VAL_LENGTHS), n_enh)))
    port_test = pt.test(4, draws=iter(jax_test_draws(len(TEST_LENGTHS))))
    return dict(tmp=tmp, cfg=pcfg, jm=jm, jt=jt, pt=pt, params=params, shadow=shadow,
                jax_val=jax_val, jax_pr_cum=jax_pr_cum, jax_test=jax_test,
                port_val=port_val, port_test=port_test, n_enh=n_enh)


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


# ------------------------------------------------------------ model parts
@pytest.mark.parametrize("bin_index", range(5))
def test_compute_losses_matches_jax_in_each_bin(runs, bin_index, record_property):
    """One time bin's score loss (``compute_losses(train=False)``) on a
    normalised, padded val batch with JAX's draws: <= 1e-5 relative, on the
    raw (unfolded) weights both sides."""
    jm, pt = runs["jm"], runs["pt"]
    batch = next(iter(pt.dm.val_dataloader()))
    mix, target = (torch.from_numpy(batch[k]) for k in ("noisy", "clean"))
    (mix, target), *_ = pt.model.normalize_batch((mix, target))
    mix, _ = pt.model.pad(mix)
    target, _ = pt.model.pad(target)
    lo, hi = bin_index / 5, (bin_index + 1) / 5
    key = jax.random.key(100 + bin_index)
    want = float(_jax_loss(jm)(runs["params"], key, jnp.asarray(mix.numpy()),
                               jnp.asarray(target.numpy()), lo, hi))
    k_sigma, k_noise = jax.random.split(key)
    with torch.no_grad():
        got = float(pt.model.compute_losses(
            mix, target, train=False, t_min=lo, t_max=hi,
            u=np.asarray(jax.random.uniform(k_sigma, (1,))),
            z=np.asarray(jax.random.normal(k_noise, tuple(target.shape)))))
    record_property("rel_diff", float(_rel(got, want)))
    assert _rel(got, want) <= 1e-5
    # train=True: a UNIVERSE++ has no MDN losses (JAX's UniverseGAN
    # overrides init_losses), so the tuple is (score, score, 0, 0, time)
    want_t = [np.asarray(v) for v in _jax_loss(jm, train=True)(
        runs["params"], key, jnp.asarray(mix.numpy()), jnp.asarray(target.numpy()), lo, hi)]
    with torch.no_grad():
        got_t = pt.model.compute_losses(
            mix, target, train=True, t_min=lo, t_max=hi,
            u=np.asarray(jax.random.uniform(k_sigma, (1,))),
            z=np.asarray(jax.random.normal(k_noise, tuple(target.shape))))
    for a, b in zip(got_t[:2], want_t[:2]):
        assert _rel(float(a), float(b)) <= 1e-5
    assert float(got_t[2]) == float(want_t[2]) == 0.0
    assert float(got_t[3]) == float(want_t[3]) == 0.0
    np.testing.assert_allclose(got_t[4].numpy(), want_t[4], atol=1e-6, rtol=0)


_LOSS = {}


def _jax_loss(jm, train=False):
    if train not in _LOSS:
        _LOSS[train] = jax.jit(lambda p, k, m, t, lo, hi: jm.compute_losses(
            p, k, m, t, train=train, time_sampling="time_uniform", t_min=lo, t_max=hi))
    return _LOSS[train]


def test_adaptive_sample_sigma_matches_jax(runs, record_property):
    """``adaptive`` time sampling with a validation histogram, JAX's
    uniforms injected (dice from the first half of the key's split, the
    position in the bin from the second): <= 1e-6; all mass in the last
    bin keeps every time in [0.8, 1]; the GAN step passes the trainer's
    histogram through."""
    jm, model = runs["jm"], runs["pt"].model
    bins = np.linspace(0.0, 1.0, 6).astype(np.float32)
    worst = 0.0
    for pr_cum in (np.array([0.0, 0.1, 0.15, 0.5, 0.9, 1.0 + 1e-5], np.float32),
                   np.array([0.0, 0.0, 0.0, 0.0, 0.0, 1.0 + 1e-5], np.float32)):
        key = jax.random.key(7)
        sigma_j, time_j = jm.sample_sigma(key, 64, "adaptive", pr_cum=jnp.asarray(pr_cum),
                                          bins=jnp.asarray(bins))
        k1, k2 = jax.random.split(key)
        sigma_p, time_p = model.sample_sigma(
            64, "adaptive", u=np.asarray(jax.random.uniform(k2, (64,))),
            dice=np.asarray(jax.random.uniform(k1, (64,))),
            pr_cum=torch.from_numpy(pr_cum), bins=torch.from_numpy(bins))
        worst = max(worst, float(np.max(np.abs(time_p.numpy() - np.asarray(time_j)))),
                    float(np.max(np.abs(sigma_p.numpy() - np.asarray(sigma_j))
                                 / np.asarray(sigma_j))))
    record_property("max_diff", worst)
    assert worst <= 1e-6
    assert float(time_p.min()) >= 0.8
    # without a histogram, adaptive is uniform time
    u = torch.rand(8, generator=torch.Generator().manual_seed(0))
    assert torch.equal(model.sample_sigma(8, "adaptive", u=u)[1], u)
    # the trainer's histogram reaches the step's sigma
    model.train_kwargs["time_sampling"] = "adaptive"
    try:
        out = model.generator_forward(
            *(torch.zeros(2, 800, 1) + 0.01,) * 3, u=torch.full((2,), 0.5),
            pr_cum=torch.from_numpy(pr_cum), bins=torch.from_numpy(bins),
            dice=torch.full((2,), 0.3))
    finally:
        model.train_kwargs["time_sampling"] = runs["cfg"]["model"]["training"]["time_sampling"]
    np.testing.assert_allclose(out["time"].detach().numpy(), [0.9, 0.9], rtol=1e-6)


# ----------------------------------------------------------- validate, test
def test_validate_matches_jax(runs, record_property):
    """``Trainer.validate``: the same keys as JAX's; val/score* and val/lsd
    <= 1e-4 relative, val/pesq <= 1e-3; the same adaptive histogram."""
    got, want = runs["port_val"], runs["jax_val"]
    assert set(got) == set(want)
    assert {"val/score", "val/lsd", "val/pesq"} <= set(got) and len(got) == 8
    diffs = {}
    for k, w in want.items():
        d = abs(got[k] - float(w)) if k == "val/pesq" else _rel(got[k], float(w))
        diffs[k] = d
        assert d <= (PESQ_TOL if k == "val/pesq" else REL_TOL), (k, got[k], w)
    record_property("diffs", {k: float(v) for k, v in diffs.items()})
    np.testing.assert_allclose(runs["pt"].pr_cum.numpy(), runs["jax_pr_cum"], rtol=REL_TOL)
    timing = runs["pt"].val_timing
    assert timing["perf/val_wall_s"] >= timing["perf/val_model_s"] > 0


def test_test_matches_jax(runs, record_property):
    """``Trainer.test``: the same per-file JSON and summary as JAX's, LSD
    <= 1e-4 relative, PESQ <= 1e-3."""
    worst = {}
    for name in ("test_results.json", "test_summary.json"):
        got = json.loads((runs["tmp"] / "port" / name).read_text())
        want = json.loads((runs["tmp"] / "jax" / name).read_text())
        rows = got.items() if name == "test_results.json" else [("summary", got)]
        assert set(got) == set(want)
        for key, row in rows:
            ref = want if key == "summary" else want[key]
            assert set(row) == set(ref)
            for k, v in row.items():
                if isinstance(v, float) and k != "number":
                    d = abs(v - ref[k]) if k == "pesq" else _rel(v, ref[k])
                    worst[k] = max(worst.get(k, 0.0), float(d))
                    assert d <= (PESQ_TOL if k == "pesq" else REL_TOL), (key, k)
                else:
                    assert v == ref[k]
    assert runs["port_test"]["number"] == len(TEST_LENGTHS)
    assert set(runs["port_test"]) == set(runs["jax_test"])
    record_property("max_diff", worst)


def test_folded_ema_validation_equals_unfolded(runs, monkeypatch, record_property):
    """Validation on its folded EMA copy (every ConvBlock through the fused
    chain's wrappers, which on the CPU run the plain versions) against the
    same validation with weight norm left unfolded (the unfused chain):
    every metric <= 1e-5 relative.  The wrappers are called 5 * 24 times a
    val batch plus (14 + 10 n_steps) per enhanced batch."""
    pt, n_val = runs["pt"], len(VAL_LENGTHS)
    calls = []
    for name in ("fused_conv_chain", "fused_conv_chain_rows"):
        real = getattr(conv_block, name)
        monkeypatch.setattr(conv_block, name,
                            lambda *a, _r=real, _n=name, **k: calls.append(_n) or _r(*a, **k))
    draws = jax_val_draws(n_val, runs["n_enh"])
    folded = pt.validate(2, draws=iter(draws))
    assert len(calls) == 5 * 24 * n_val + (14 + 10 * N_STEPS) * runs["n_enh"]
    assert set(calls) == {"fused_conv_chain"}
    calls.clear()
    monkeypatch.setattr(ptrainer, "fold_weight_norm", lambda m: m)
    unfolded = pt.validate(2, draws=iter(draws))
    assert not calls
    rel = {k: _rel(v, unfolded[k]) for k, v in folded.items()}
    record_property("rel_diff", {k: float(v) for k, v in rel.items()})
    assert max(rel.values()) <= 1e-5, rel
    assert folded == runs["port_val"]


# ------------------------------------------------------- fit, save, resume
@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    """The port's fit: 4 steps, validation and a checkpoint every 2, one val
    clip; val/score picks the best checkpoint (mode min); one clip's audio
    is written at each validation."""
    tmp = tmp_path_factory.mktemp("fit")
    write_splits(tmp / "data", val=(17600,), test=(16000,))
    cfg = port_compose(ROOT / "config", overrides(tmp / "data"))
    cfg["model"]["validation"].update(main_loss="val/score", main_loss_mode="min",
                                      num_tb_samples=1)
    tr = port_trainer(cfg, tmp / "run", max_steps=4, val_check_interval=2,
                      checkpoint_every=2, log_every=1)
    tr.fit()
    return dict(tmp=tmp, cfg=cfg, trainer=tr)


def _rows(run_dir):
    return [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]


def test_index_and_best_name_the_best_checkpoint(fitted):
    """index.json lists each checkpoint with the newest validation's
    val/score, best.json the least of them, last.json the last one; with
    main_loss_mode max best.json names the greatest."""
    run = fitted["tmp"] / "run"
    ckpt_dir = run / "checkpoints"
    val = {r["step"]: r["val/score"] for r in _rows(run) if "val/score" in r}
    assert sorted(val) == [2, 4]
    index = json.loads((ckpt_dir / "index.json").read_text())
    assert [(e["step"], e["metric"], e["value"]) for e in index] == [
        (2, "val/score", val[2]), (4, "val/score", val[4])]
    assert all(Path(e["path"]).exists() for e in index)
    best = json.loads((ckpt_dir / "best.json").read_text())
    assert best["value"] == min(val.values())
    assert json.loads((ckpt_dir / "last.json").read_text())["step"] == 4
    tr = fitted["trainer"]
    tr.model.val_kwargs["main_loss_mode"] = "max"
    try:
        tr._commit_last_json(4, Path(index[1]["path"]), val[4])
    finally:
        tr.model.val_kwargs["main_loss_mode"] = "min"
    assert json.loads((ckpt_dir / "best.json").read_text())["value"] == max(val.values())
    assert {"perf/val_wall_s", "perf/val_model_s", "perf/val_enhance_s",
            "perf/val_metrics_s"} <= set(next(r for r in _rows(run) if "val/score" in r))


def test_validation_writes_loudness_matched_audio(fitted):
    """With validation.num_tb_samples the first val batch's mix and target
    are written once and its enhanced clip at every validation, as 16-bit
    WAVs at the model's rate, each scaled to the mix's loudness."""
    from open_universe_tpu_torch.data.audio import load_audio
    from open_universe_tpu_torch.metrics.loudness import loudness

    audio = fitted["tmp"] / "run" / "audio"
    assert sorted(p.name for p in audio.iterdir()) == [
        "enh_0_step_00000002.wav", "enh_0_step_00000004.wav", "mix_0.wav", "target_0.wav"]
    loud = {}
    for p in audio.iterdir():
        x, fs = load_audio(p)
        assert fs == FS and x.shape == (1, 17600 + 14400) and np.isfinite(x).all()
        loud[p.stem] = loudness(x[0], FS)
    batch = next(iter(fitted["trainer"].dm.val_dataloader()))
    mix_loud = loudness(batch["noisy"][0, :, 0], FS)
    for name in ("target_0", "enh_0_step_00000004"):
        assert abs(loud[name] - mix_loud) < 0.1, (name, loud[name], mix_loud)


def _state(tr):
    step = tr.step_fn
    return {"params": {k: v.clone() for k, v in tr.model.state_dict().items()},
            "opt": [o.state_dict() for o in (step.opt_gen, step.opt_disc)],
            "updates": (step.gen_updates, step.disc_updates, step.step),
            "ema": ({k: v.clone() for k, v in tr.ema.shadow.items()}, tr.ema.num_updates)}


def _assert_same(a, b, path=""):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), path
    elif isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}/{i}")
    else:
        assert a == b, path


def test_resume_restores_every_state_bit_for_bit(fitted):
    """A fresh trainer restored from the run dir (through last.json) holds
    the saved weights, both optimizers' states, their update counts (the
    schedule), the EMA shadow and num_updates, and the step, bit for bit;
    fitting on from step 4 to 6 validates at 6 only; the .ckpt still loads
    with load_model."""
    from open_universe_tpu_torch.inference.model_loader import load_model

    tr, tmp = fitted["trainer"], fitted["tmp"]
    saved = _state(tr)
    assert saved["updates"] == (4, 4, 4) and saved["ema"][1] == 4
    fresh = port_trainer(fitted["cfg"], tmp / "resumed", max_steps=6, val_check_interval=2,
                         checkpoint_every=2, log_every=1)
    assert fresh.restore(tmp / "run") == 4
    _assert_same(_state(fresh), saved)
    fresh.fit()
    rows = _rows(tmp / "resumed")
    assert [r["step"] for r in rows if "val/score" in r] == [6]
    assert [r["step"] for r in rows if "train/loss_gen" in r] == [5, 6]
    assert fresh.step_fn.step == 6 and fresh.ema.num_updates == 6
    ckpt = tmp / "run" / "checkpoints" / "step_00000004.ckpt"
    model = load_model(ckpt, device="cpu")
    assert not hasattr(model, "loss_mpd")


def test_train_entry_point_validates_tests_and_resumes(tmp_path):
    """``python -m open_universe_tpu_torch.train ... test=true`` on the CPU
    writes val rows in metrics.jsonl, index/best/last.json and the test
    JSONs; ``ckpt_path=<run dir>`` resumes it; neither run imports jax."""
    write_splits(tmp_path / "data", val=(16000,), test=(16000,))
    base = overrides(tmp_path / "data", "device=cpu", "trainer.val_check_interval=2",
                     "trainer.checkpoint_every=2", "trainer.log_every=1",
                     f"path.exp_root={tmp_path / 'exp'}", "test=true")
    # one intra-op thread: the test workers share the cores
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")

    def run(args):
        code = ("import runpy, sys\n"
                f"sys.argv = ['train'] + {args!r}\n"
                "runpy.run_module('open_universe_tpu_torch.train', run_name='__main__')\n"
                "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
                "       or m == 'open_universe_tpu' or m.startswith('open_universe_tpu.')]\n"
                "assert not bad, bad\n")
        out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr[-3000:]

    run(base + ["trainer.max_steps=2"])
    (first,) = (tmp_path / "exp" / "universepp_vb_16k").iterdir()
    rows = _rows(first)
    assert [r["step"] for r in rows if "val/score" in r] == [2]
    assert {"val/pesq", "val/lsd"} <= set(rows[-2]) and "test/pesq" in rows[-1]
    for name in ("checkpoints/index.json", "checkpoints/best.json",
                 "checkpoints/last.json", "test_results.json", "test_summary.json"):
        assert (first / name).exists(), name
    assert json.loads((first / "checkpoints" / "best.json").read_text())["metric"] == "val/pesq"
    run(base + ["trainer.max_steps=4", f"ckpt_path={first}"])
    (second,) = [d for d in (tmp_path / "exp" / "universepp_vb_16k").iterdir() if d != first]
    rows = _rows(second)
    assert [r["step"] for r in rows if "train/loss_gen" in r] == [3, 4]
    assert [r["step"] for r in rows if "val/score" in r] == [4]
    assert (second / "checkpoints" / "step_00000004.ckpt").exists()
