"""Data parallelism of the PyTorch port (``parallel/mesh.py``) on the CPU:
two gloo processes (``torch.multiprocessing``, spawned once for the module,
a ``file://`` rendezvous in ``tmp_path``) against one port process on the
global batch, and against the JAX package's step on ``make_mesh(dp=2)``.

Each process loads the whole global batch (4 rows) and the draws made for
it, takes its 2 rows, and averages every gradient over the ranks before
clipping.  Two steps of the UNIVERSE++ GAN step, the plain UNIVERSE's
score-only step and the LoRA step (the sampler's noise drawn for the
global batch).  Bounds: the losses (the ranks' means) within 1e-6
relative of the one process's; the averaged gradients of step 1 within
1e-5 of each tensor's largest value (1e-4 for a one-element PReLU slope,
one sum over the batch that can cancel) plus float32's epsilon, 1e-7, of
the step's largest gradient (a tensor whose gradient cancels to ~1e-6 of
it shows the summation order).  The GAN and LoRA objectives hold L1s (the
mel and feature-matching losses; the multi-resolution STFT loss), whose
gradients flip sign where the two runs, batched differently, round apart:
their gradients are held to 1e-4 of each tensor's largest, the bound
``test_torch_train.py`` holds the GAN step to against JAX, and LoRA's floor
is 1e-6 of the largest, as ``test_torch_lora.py``'s; the parameters and EMA shadows after step 2 within 1e-5 of
each tensor's largest value (an element whose gradient is below 1e-2 of its tensor's
largest or below 1e-7 may flip AdamW's +-lr on float32's summation order:
counted and held to 2 lr per update, as ``test_torch_accumulate.py``
does).  The plain UNIVERSE on the ranks against JAX's ``dp=2`` step: the
losses within 1e-5 relative, the gradients within 1e-5 of each tensor's
largest (1e-4 for a one-element PReLU slope, one sum over the batch), the
parameters after 2 steps as above.  ``finite_or_skip`` with the
non-finite row on one rank only skips on both, as JAX's global-batch flag
does.  ``trainer.mesh_dp`` x ``mesh_tp`` must cover the job (``init_from_env``).
The training entry point under ``torchrun --standalone --nproc_per_node 2``
(gloo, ``device=cpu``, ``trainer.mesh_dp=2``, bf16, accumulation) trains a
tiny UNIVERSE++ on 2 steps, and rank 0 alone names the run, logs, validates
and writes the checkpoint.
"""
import copy
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import optax  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from open_universe_tpu_torch.configs import registry as pregistry  # noqa: E402
from open_universe_tpu_torch.models.universe import finite_or_skip  # noqa: E402
from open_universe_tpu_torch.parallel import mesh  # noqa: E402
from open_universe_tpu_torch.train import trainer as ptrainer  # noqa: E402
from open_universe_tpu_torch.utils.convert import from_jax_params  # noqa: E402
from test_torch_accumulate import check_against, narrow_gan_config  # noqa: E402
from test_torch_lora import N_STEPS, T as LORA_T, _port_base, _port_lora  # noqa: E402
from test_torch_train import MAX_STEPS, _capture, _flat, _port_layout, _rel  # noqa: E402
from test_torch_train import draw_params  # noqa: E402
from test_torch_universe_original import config as orig_config  # noqa: E402
from test_torch_universe_original import loss_draws  # noqa: E402

WORLD, GB, T, STEPS = 2, 4, 800, 2
LORA_PAD = (GB, LORA_T + 160 - LORA_T % 160, 1)
ROOT = Path(__file__).resolve().parents[1]


def _start_entry_point(tmp):
    """``torchrun`` of the training entry point on 2 CPU processes (started
    first, read last)."""
    from open_universe_tpu_torch.data.audio import save_audio

    rng = np.random.default_rng(22)
    for split, n in (("train", 4), ("val", 2)):
        for kind in ("noisy", "clean"):
            (tmp / "data" / split / kind).mkdir(parents=True)
        for i in range(n):
            clean = (0.1 * np.sin(np.arange(2400) * 0.05)
                     + 0.01 * rng.standard_normal(2400)).astype(np.float32)
            save_audio(tmp / "data" / split / "clean" / f"p{i}.wav", clean, 16000)
            save_audio(tmp / "data" / split / "noisy" / f"p{i}.wav",
                       clean + 0.05 * rng.standard_normal(2400).astype(np.float32), 16000)
    d = "model.losses.multi_period_discriminator."
    r = "model.losses.multi_resolution_discriminator."
    overrides = [
        "experiment=universepp_vb_16k", "device=cpu", "trainer.mesh_dp=2",
        "model.training.compute_dtype=bf16", "model.optimizer.accumulate_grad_batches=2",
        "model.score_model.n_channels=4", "model.score_model.noise_cond_dim=32",
        "model.condition_model.n_mels=16", f"{d}mpd_reshapes=[2,3]",
        f"{d}discriminator_channel_mult=0.25", f"{r}discriminator_channel_mult=0.25",
        f"{r}resolutions=[[128,30,75],[256,60,150],[64,12,30]]", "model.diffusion.n_steps=2",
        f"datamodule.datasets.vb-train-16k.audio_path={tmp / 'data'}",
        "datamodule.datasets.vb-train-16k.audio_len=0.05",
        "datamodule.train.dl_opts.batch_size=4", "trainer.max_steps=2",
        "trainer.val_check_interval=2", "trainer.checkpoint_every=2",
        "trainer.log_every=1", "+trainer.profile_steps=[1,2]", f"path.exp_root={tmp / 'exp'}"]
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
         str(WORLD), "-m", "open_universe_tpu_torch.train", *overrides],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _inputs():
    """Weights (numpy, in JAX's trees), 2 global batches and every step's
    draws for the whole batch."""
    from open_universe_tpu.configs import registry as jregistry

    rng = np.random.default_rng(21)
    gan_cfg = narrow_gan_config()
    gan_cfg["losses"]["disc_freeze_step"] = 0
    gan_cfg["optimizer"].pop("accumulate_grad_batches")
    jcfg, pcfg = orig_config()
    batches = []
    for _ in range(STEPS):
        clean = (rng.standard_normal((GB, T, 1)) * 0.05).astype(np.float32)
        batches.append({"clean": clean, "noisy": clean + (
            rng.standard_normal((GB, T, 1)) * 0.02).astype(np.float32)})
    keys = [jax.random.key(60 + i) for i in range(STEPS)]
    return {
        "gan_cfg": gan_cfg, "orig_jcfg": jcfg, "orig_cfg": pcfg, "batches": batches,
        "gan_params": jax.tree_util.tree_map(
            np.asarray, draw_params(jregistry.instantiate(gan_cfg), seed=3)),
        "orig_params": jax.tree_util.tree_map(
            np.asarray, draw_params(jregistry.instantiate(jcfg), seed=7)),
        "gan_draws": [{"u": rng.uniform(size=GB).astype(np.float32),
                       "z": rng.standard_normal((GB, T, 1)).astype(np.float32)}
                      for _ in range(STEPS)],
        "orig_keys": [np.asarray(jax.random.key_data(k)) for k in keys],
        "orig_draws": [loss_draws(k, (GB, T, 1)) for k in keys],
        "lora_draws": [[rng.standard_normal(LORA_PAD).astype(np.float32)
                        for _ in range(N_STEPS)] for _ in range(STEPS)],
        "est": np.concatenate([rng.standard_normal((GB - 1, 3, 5)),
                               np.full((1, 3, 5), np.nan)]).astype(np.float32),
    }


def _steps(model, step, inp, draws):
    out = {"losses": [], "grads": None}
    for i in range(STEPS):
        m = step({k: torch.from_numpy(v) for k, v in inp["batches"][i].items()},
                 draws=draws[i])
        out["losses"].append({k: float(v) for k, v in m.items()})
        if i == 0:
            out["grads"] = {n: p.grad.clone() for n, p in model.named_parameters()
                            if p.grad is not None}
    out["params"] = {n: p.detach().clone() for n, p in model.named_parameters()}
    out["ema"] = {n: s.clone() for n, s in step.ema.shadow.items()}
    return out


def _t(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def run_jobs(inp):
    """The three families' two steps, in this process's share of the data
    parallel job (all of it without a process group), and finite_or_skip
    on this rank's rows of an estimate whose last row is NaN."""
    torch.manual_seed(0)
    out = {}
    model = pregistry.instantiate_trainable(copy.deepcopy(inp["gan_cfg"]))
    assert from_jax_params(model, inp["gan_params"]) == []
    out["gan"] = _steps(model, ptrainer.make_gan_step(model, MAX_STEPS), inp,
                        [_t(d) for d in inp["gan_draws"]])
    model = pregistry.instantiate_trainable(copy.deepcopy(inp["orig_cfg"]))
    assert from_jax_params(model, inp["orig_params"]) == []
    out["orig"] = _steps(model, ptrainer.make_step(model, MAX_STEPS), inp,
                         [_t(d) for d in inp["orig_draws"]])
    lora = _port_lora(_port_base(), 1, use_hifigan_loss=False)
    out["lora"] = _steps(lora, ptrainer.make_train_step(lora, 100), inp,
                         [{"noise": [torch.from_numpy(z) for z in d]}
                          for d in inp["lora_draws"]])
    rows = mesh.local_rows(GB) or slice(None)
    est = torch.from_numpy(inp["est"])[rows].requires_grad_(True)
    term, raw = finite_or_skip(lambda e: torch.mean(e * e), est,
                               across_ranks=mesh.world_size() > 1)
    term.backward()
    alone, _ = finite_or_skip(lambda e: torch.mean(e * e), est.detach())
    out["skip"] = {"term": float(term.detach()), "raw": float(raw), "grad": est.grad.clone(),
                   "alone": float(alone)}
    return out


def _worker(rank, init, tmp):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}", world_size=WORLD,
                            rank=rank)
    try:
        assert mesh.world_size() == WORLD and mesh.local_rows(GB) == slice(2 * rank,
                                                                           2 * rank + 2)
        torch.save(run_jobs(torch.load(tmp / "inputs.pt", weights_only=False)),
                   tmp / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _jax_dp2(inp):
    """Two steps of JAX's make_train_step for the plain UNIVERSE, the batch
    sharded over make_mesh(dp=2); step 1's gradients captured."""
    from open_universe_tpu.configs import registry as jregistry
    from open_universe_tpu.nn.module import buffer_mask
    from open_universe_tpu.parallel.mesh import make_mesh, shard_batch, shard_params
    from open_universe_tpu.train import optim as joptim
    from open_universe_tpu.train.steps import init_train_state, make_train_step
    from open_universe_tpu.train.trainer import _build_schedule

    jcfg, params = inp["orig_jcfg"], inp["orig_params"]
    jm = jregistry.instantiate(jcfg)
    opt = jcfg["optimizer"]
    tx = optax.chain(_capture(), joptim.adamw(
        _build_schedule(jcfg["scheduler"], opt["lr"], MAX_STEPS), betas=tuple(opt["betas"]),
        weight_decay=opt["weight_decay"], weight_decay_exclude=opt["weight_decay_exclude"],
        params=params, trainable_mask=buffer_mask(jm, params)))
    clipper = joptim.make_clipper({"max_norm": jcfg["grad_clipper"]["max_norm"]})
    m2 = make_mesh(dp=WORLD, tp=1)
    state = shard_params(m2, init_train_state(jm, params, tx, clipper=clipper))
    step = jax.jit(make_train_step(jm, tx, clipper=clipper))
    metrics = []
    for i in range(STEPS):
        key = jax.random.wrap_key_data(inp["orig_keys"][i])
        state, m = step(state, shard_batch(m2, inp["batches"][i]), key)
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            grads = _flat(jax.tree_util.tree_map(np.asarray, state["opt_state"][0]))
    return {"metrics": metrics, "grads": grads,
            "params": _flat(jax.tree_util.tree_map(np.asarray, state["params"])),
            "ema": _flat(jax.tree_util.tree_map(np.asarray, state["ema"]["shadow"]))}


@pytest.fixture(scope="module")
def ddp(tmp_path_factory):
    """The 2-rank job (spawned first), meanwhile the one-process run and
    JAX's dp=2 run."""
    tmp = tmp_path_factory.mktemp("ddp")
    entry = _start_entry_point(tmp_path_factory.mktemp("entry"))
    inp = _inputs()
    torch.save(inp, tmp / "inputs.pt")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_worker, args=(r, tmp / "rendezvous", tmp))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        single = run_jobs(inp)
        jax_run = _jax_dp2(inp)
    finally:
        torch.set_num_threads(n)
        for p in procs:
            p.join(timeout=600)
            if p.is_alive():
                p.kill()
        try:
            entry_log, _ = entry.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            entry.kill()
            entry_log, _ = entry.communicate()
    assert [p.exitcode for p in procs] == [0] * WORLD
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return {"single": single, "ranks": ranks, "jax": jax_run, "inp": inp,
            "entry": (entry.returncode, entry_log, Path(entry.args[-1].partition("=")[2]))}


def _check_grads(got, want, record_property, tag, floor=1e-7, rel=1e-5):
    """Per tensor max|d| <= ``rel`` (1e-4 for one element) of its largest,
    plus ``floor`` of the largest gradient of the step."""
    assert set(got) == set(want)
    top = max(np.abs(g).max() for g in want.values())
    worst = 0.0
    for n, g in want.items():
        scale = np.abs(g).max()
        err = np.abs(got[n] - g).max()
        worst = max(worst, err / max(scale, 1e-30))
        assert err <= max(1e-4 if g.size == 1 else rel, rel) * scale + floor * top, (
            tag, n, err, scale)
    record_property(f"{tag}_grad_rel_max", float(worst))


def _losses_close(got, want, tol):
    for a, b in zip(got, want):
        for k, v in b.items():
            if k.startswith("train/"):
                assert _rel(a[k], v) <= tol or a[k] == v, (k, a[k], v)


@pytest.mark.parametrize("family", ["gan", "orig", "lora"])
def test_two_ranks_equal_one_process(ddp, family, record_property):
    """The ranks agree with each other bit for bit (same averaged
    gradients, same updates), and with one process on the global batch:
    losses within 1e-6 relative, step 1's gradients within 1e-5 of each
    tensor's largest, parameters and EMA after step 2 as the module says."""
    one = ddp["single"][family]
    r0, r1 = (r[family] for r in ddp["ranks"])
    assert r0["losses"] == r1["losses"]
    for n, p in r0["params"].items():
        assert torch.equal(p, r1["params"][n]), n
    _losses_close(r0["losses"], one["losses"], 1e-6)
    _check_grads({n: g.numpy() for n, g in r0["grads"].items()},
                 {n: g.numpy() for n, g in one["grads"].items()}, record_property, family,
                 floor=1e-6 if family == "lora" else 1e-7,
                 rel=1e-5 if family == "orig" else 1e-4)

    class _Model:  # check_against's view of the ranks' result
        def named_parameters(self):
            return r0["params"].items()

    class _Ema:
        shadow = r0["ema"]

    lr = {"gan": 2e-4, "orig": ddp["inp"]["orig_cfg"]["optimizer"]["lr"], "lora": 1e-3}[family]
    check_against(_Model(), {n: p.numpy() for n, p in one["params"].items()},
                  {n: s.numpy() for n, s in one["ema"].items()},
                  {n: g.numpy() for n, g in one["grads"].items()}, _Ema(), 2 * lr,
                  record_property, family)


def test_two_ranks_equal_jax_dp2(ddp, record_property):
    """The plain UNIVERSE's 2-rank step against JAX's step on
    make_mesh(dp=2): losses within 1e-5 relative, step 1's gradients per
    tensor within 1e-5 of its largest (1e-4 for a one-element PReLU slope),
    parameters and EMA after step 2 as the module says."""
    r0, want = ddp["ranks"][0]["orig"], ddp["jax"]
    _losses_close(r0["losses"], want["metrics"], 1e-5)
    model = pregistry.instantiate_trainable(copy.deepcopy(ddp["inp"]["orig_cfg"]))
    params = dict(model.named_parameters())  # JAX's tree also holds the buffers
    grads = {n: g for n, g in _port_layout(model, want["grads"]).items() if n in params}
    _check_grads({n: g.numpy() for n, g in r0["grads"].items()}, grads, record_property,
                 "jax_dp2")

    class _Model:
        def named_parameters(self):
            return r0["params"].items()

    class _Ema:
        shadow = r0["ema"]

    check_against(_Model(), _port_layout(model, want["params"]),
                  _port_layout(model, want["ema"]), grads, _Ema(),
                  2 * ddp["inp"]["orig_cfg"]["optimizer"]["lr"], record_property, "jax_dp2")


def test_finite_or_skip_on_one_rank_skips_on_all(ddp):
    """The estimate's NaN row is rank 1's: both ranks skip the term (0, no
    gradient into the estimate), as JAX's flag of the global batch and one
    process on it do; rank 0's own rows alone would not have skipped."""
    from open_universe_tpu.models.universe import finite_or_skip as jax_skip

    want, _ = jax_skip(lambda e: (e * e).mean(), ddp["inp"]["est"])
    assert float(want) == 0.0 == ddp["single"]["skip"]["term"]
    for r in ddp["ranks"]:
        assert r["skip"]["term"] == 0.0 and not r["skip"]["grad"].any()
    assert ddp["ranks"][0]["skip"]["alone"] > 0.0
    assert np.isnan(ddp["ranks"][1]["skip"]["raw"])


def test_entry_point_under_torchrun(ddp):
    """Two gloo processes of ``python -m open_universe_tpu_torch.train``:
    one run directory, each step logged once, the validation at step 2,
    one checkpoint with both accumulators emptied by the second call, and
    each rank's ``torch.profiler`` trace of step 2 (``profile_steps``)."""
    rc, out, exp = ddp["entry"]
    assert rc == 0, out[-3000:]
    assert "rank 1 of 2" in out and "rank 0 of 2" in out
    (run,) = (exp / "universepp_vb_16k").iterdir()
    rows = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows if "train/loss_gen" in r] == [1, 2]
    assert [r["step"] for r in rows if "val/score" in r] == [2]
    (ckpt,) = (run / "checkpoints").glob("*.ckpt")
    saved = torch.load(ckpt, map_location="cpu", weights_only=False)
    assert saved["global_step"] == 2
    assert [a["mini_step"] for a in saved["grad_accumulators"]] == [0, 0]
    assert [s["updates"] for s in saved["lr_schedulers"]] == [1, 1]
    assert json.loads((run / "checkpoints" / "last.json").read_text())["step"] == 2
    for rank in range(WORLD):
        trace = json.loads((run / "profile" / f"trace_rank{rank}.json").read_text())
        assert trace["traceEvents"]


def test_init_from_env_checks_the_mesh(monkeypatch):
    """One process (no torchrun environment): the mesh must cover the job,
    mesh_dp x mesh_tp = 1, so mesh_dp = 2 raises, and so does mesh_tp = 2
    (a tp = 2 mesh needs 2 processes; ``test_torch_tp.py`` trains on one),
    naming the mismatch; no rows are taken and nothing is sharded."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert mesh.init_from_env("cpu", None, 1) == torch.device("cpu")
    assert mesh.init_from_env("cpu", 1, 1) == torch.device("cpu")
    with pytest.raises(ValueError, match="mesh_dp=2"):
        mesh.init_from_env("cpu", 2, 1)
    with pytest.raises(ValueError, match="mesh_tp=2 needs 2 processes but the job has 1"):
        mesh.init_from_env("cpu", None, 2)
    assert mesh.local_rows(GB) is None and mesh.world_size() == 1 and mesh.tp_size() == 1
