"""Tensor parallelism of the PyTorch port (``parallel/tp.py``, the ``tp``
axis of ``parallel/mesh.py``) on the CPU, against the JAX package's
``param_sharding``/``shard_params`` and its dp x tp step.

- Placement: for the tiny UNIVERSE++ with its discriminators, the
  parameters the port shards at tp = 2 (``tp_min_shard`` 8) are, through
  ``utils/convert.py``'s layouts, exactly the leaves JAX's ``shard_params``
  shards on ``make_mesh(dp=1, tp=2)``, with the same shard shapes; nothing
  is sharded at tp = 1.
- Two gloo ranks (dp = 1, tp = 2; ``torch.multiprocessing``, spawned once
  for the module, a ``file://`` rendezvous in ``tmp_path``) against one
  process: two UNIVERSE++ GAN, plain UNIVERSE and LoRA steps on the same
  weights, batch and draws.  Each rank holds 1/2 of every sharded
  parameter, gradient, AdamW moment and EMA shadow.  Step 1's losses bit
  for bit, step 1's gradients (gathered) element for element, the
  gradient norms within 1e-6 relative (the shards' squares are summed in
  another order), the parameters and EMA shadows after step 2 within
  ``test_torch_ddp.py``'s bounds.
- Four gloo ranks (dp = 2, tp = 2) against JAX's step on
  ``make_mesh(dp=2, tp=2)`` with ``tp_min_shard=8``, the plain UNIVERSE (as
  ``test_torch_ddp.py::test_two_ranks_equal_jax_dp2``): losses within 1e-5
  relative (JAX's own dp x tp test holds its step to 2e-5), ``grad/norm``
  within 2e-4 relative (the bound of that test), the parameters and EMA
  after step 2 within ``test_torch_ddp.py``'s bounds.
- The training entry point under ``torchrun --standalone
  --nproc_per_node 2`` (gloo, ``device=cpu``, ``trainer.mesh_tp=2``,
  ``accumulate_grad_batches=2``; at the default ``tp_min_shard`` of 128
  the tiny model shards 8 parameters) trains the tiny UNIVERSE++ 2 steps, validates and tests on rank 0 and writes a
  checkpoint at each step: the checkpoint holds a one-process run's keys
  and shapes, ``load_model`` reads it, and the run resumed from step 1 at
  tp = 2 (``torchrun`` again) and at tp = 1 (one process) reaches the same
  step-3 loss.
"""
import copy
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import optax  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from open_universe_tpu_torch.configs import registry as pregistry  # noqa: E402
from open_universe_tpu_torch.parallel import mesh, tp  # noqa: E402
from open_universe_tpu_torch.train import trainer as ptrainer  # noqa: E402
from open_universe_tpu_torch.utils.convert import from_jax_params, jax_layout  # noqa: E402
from test_torch_accumulate import check_against  # noqa: E402
from test_torch_ddp import STEPS, _check_grads, _inputs, _losses_close, _t  # noqa: E402
from test_torch_lora import _port_base, _port_lora  # noqa: E402
from test_torch_train import MAX_STEPS, _capture, _flat, _port_layout, _rel  # noqa: E402
from test_torch_train import draw_params, gan_config  # noqa: E402
from test_torch_validate import write_splits  # noqa: E402

MIN_LAST = 8
ROOT = Path(__file__).resolve().parents[1]


def _start_entry_point(tmp, data, *args):
    """``torchrun`` of the training entry point on 2 CPU processes at
    tp = 2 (started, not waited for)."""
    d = "model.losses.multi_period_discriminator."
    r = "model.losses.multi_resolution_discriminator."
    overrides = [
        "experiment=universepp_vb_16k", "device=cpu", "trainer.mesh_tp=2",
        "model.optimizer.accumulate_grad_batches=2",
        "model.score_model.n_channels=4", "model.score_model.noise_cond_dim=32",
        "model.condition_model.n_mels=16", f"{d}mpd_reshapes=[2,3]",
        f"{d}discriminator_channel_mult=0.25", f"{r}discriminator_channel_mult=0.25",
        f"{r}resolutions=[[128,30,75],[256,60,150],[64,12,30]]", "model.diffusion.n_steps=2",
        f"datamodule.datasets.vb-train-16k.audio_path={data}",
        "datamodule.datasets.vb-train-16k.audio_len=0.05",
        "datamodule.train.dl_opts.batch_size=4", "trainer.checkpoint_every=1",
        "trainer.log_every=1", f"path.exp_root={tmp}", *args]
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
         "2", "-m", "open_universe_tpu_torch.train", *overrides],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _wait(proc, timeout=600):
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
    assert proc.returncode == 0, out[-4000:]
    return out


def _gathered(model, tensors):
    """``{parameter name: tensor}`` with this rank's shards gathered whole
    (every tp rank calls it)."""
    return {n: v.detach().clone() for n, v in tp.gather_state(tensors, tp.dims(model)).items()}


def _steps(model, step, inp, draws):
    """STEPS steps: each step's metrics, step 1's gradients, the
    parameters and EMA shadows after, all whole; and what this rank holds."""
    out = {"losses": []}
    for i in range(STEPS):
        m = step({k: torch.from_numpy(v) for k, v in inp["batches"][i].items()},
                 draws=draws[i])
        out["losses"].append({k: float(v) for k, v in m.items()})
        if i == 0:
            out["grads"] = _gathered(model, {n: p.grad for n, p in model.named_parameters()
                                             if p.grad is not None})
    out["params"] = _gathered(model, dict(model.named_parameters()))
    out["ema"] = _gathered(model, step.ema.shadow)
    opts = ptrainer.optimizers(step)
    out["held"] = {
        "params": {n: tuple(p.shape) for n, p in model.named_parameters()},
        "grads": {n: tuple(p.grad.shape) for n, p in model.named_parameters()
                  if p.grad is not None},
        "moments": {n: tuple(o.state[p]["exp_avg"].shape) for o, _, _ in opts
                    for n, p in model.named_parameters() if p in o.state},
        "ema": {n: tuple(s.shape) for n, s in step.ema.shadow.items()},
        "dims": tp.dims(model)}
    return out


def run_tp(inp):
    """The three families' two steps, their parameters sharded over this
    process's tp axis (none without a process group)."""
    torch.manual_seed(0)
    out = {}
    model = pregistry.instantiate_trainable(copy.deepcopy(inp["gan_cfg"]))
    assert from_jax_params(model, inp["gan_params"]) == []
    tp.shard_(model, MIN_LAST)
    out["gan"] = _steps(model, ptrainer.make_gan_step(model, MAX_STEPS), inp,
                        [_t(d) for d in inp["gan_draws"]])
    model = pregistry.instantiate_trainable(copy.deepcopy(inp["orig_cfg"]))
    assert from_jax_params(model, inp["orig_params"]) == []
    tp.shard_(model, MIN_LAST)
    out["orig"] = _steps(model, ptrainer.make_step(model, MAX_STEPS), inp,
                         [_t(d) for d in inp["orig_draws"]])
    lora = _port_lora(_port_base(), 1, use_hifigan_loss=False)
    tp.shard_(lora, MIN_LAST)
    out["lora"] = _steps(lora, ptrainer.make_train_step(lora, 100), inp,
                         [{"noise": [torch.from_numpy(z) for z in d]}
                          for d in inp["lora_draws"]])
    return out


def run_mesh(inp):
    """The plain UNIVERSE's two steps on this rank's share of a dp x tp job."""
    model = pregistry.instantiate_trainable(copy.deepcopy(inp["orig_cfg"]))
    assert from_jax_params(model, inp["orig_params"]) == []
    tp.shard_(model, MIN_LAST)
    return _steps(model, ptrainer.make_step(model, MAX_STEPS), inp,
                  [_t(d) for d in inp["orig_draws"]])


JOBS = {"tp2": (2, 1, 2, run_tp), "dp2_tp2": (4, 2, 2, run_mesh)}


def _worker(rank, job, init, tmp):
    """One rank of ``job``; the tp = 2 ranks then resume the entry point's
    run at tp = 2 from the arguments the parent writes once it has ended."""
    from open_universe_tpu_torch.train.__main__ import main as train_main

    world, dp, tpn, fn = JOBS[job]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}", world_size=world,
                            rank=rank)
    try:
        mesh.make_mesh(dp, tpn)
        assert (mesh.dp_rank(), mesh.tp_rank()) == divmod(rank, tpn)
        torch.save(fn(torch.load(tmp / "inputs.pt", weights_only=False)),
                   tmp / f"{job}_rank{rank}.pt")
        if job == "tp2":
            t0 = time.time()
            while not (tmp / "resume.json").exists() and time.time() - t0 < 600:
                time.sleep(0.2)
            args = json.loads((tmp / "resume.json").read_text())
            if args:
                train_main(args)
    finally:
        dist.destroy_process_group()


def _jax_mesh(inp):
    """Two steps of JAX's make_train_step for the plain UNIVERSE on
    make_mesh(dp=2, tp=2), the state placed by shard_params(min_last=8);
    step 1's gradients captured."""
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
    m4 = make_mesh(dp=2, tp=2)
    state = shard_params(m4, jax.jit(lambda p: init_train_state(jm, p, tx, clipper=clipper))(
        params), min_last=MIN_LAST)
    step = jax.jit(make_train_step(jm, tx, clipper=clipper))
    metrics = []
    for i in range(STEPS):
        key = jax.random.wrap_key_data(inp["orig_keys"][i])
        state, m = step(state, shard_batch(m4, inp["batches"][i]), key)
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            grads = _flat(jax.tree_util.tree_map(np.asarray, state["opt_state"][0]))
    return {"metrics": metrics, "grads": grads,
            "params": _flat(jax.tree_util.tree_map(np.asarray, state["params"])),
            "ema": _flat(jax.tree_util.tree_map(np.asarray, state["ema"]["shadow"]))}


def _spawn(job, tmp):
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_worker, args=(r, job, tmp / f"rendezvous_{job}", tmp))
             for r in range(JOBS[job][0])]
    for p in procs:
        p.start()
    return procs


def _join(procs, job, tmp):
    for p in procs:
        p.join(timeout=600)
        if p.is_alive():
            p.kill()
    assert [p.exitcode for p in procs] == [0] * len(procs), job
    return [torch.load(tmp / f"{job}_rank{r}.pt", weights_only=False)
            for r in range(len(procs))]


def _metrics(run_root):
    (run,) = (run_root / "universepp_vb_16k").iterdir()
    rows = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    return run, rows


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The entry point at tp = 2 (started first), the 2- and 4-rank jobs,
    meanwhile one process and JAX's dp x tp step; then the resumes."""
    from open_universe_tpu_torch.train.__main__ import main as train_main

    tmp = tmp_path_factory.mktemp("tp")
    write_splits(tmp / "data", train=(2000,) * 4, val=(2400,), test=(2400,))
    fit = _start_entry_point(tmp / "fit", tmp / "data", "trainer.max_steps=2",
                             "trainer.val_check_interval=2", "test=true")
    inp = _inputs()
    torch.save(inp, tmp / "inputs.pt")
    procs = {job: _spawn(job, tmp) for job in JOBS}
    # JAX's compile (the longest part) beside this process's steps
    jax_run = {}
    jax_thread = threading.Thread(target=lambda: jax_run.update(_jax_mesh(inp)))
    jax_thread.start()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        single = run_tp(inp)
        fit_log = _wait(fit)
        run, _ = _metrics(tmp / "fit")
        args = fit.args[fit.args.index("open_universe_tpu_torch.train") + 1:]
        resume_args = [o for o in args if not o.startswith(
            ("trainer.mesh_tp", "path.exp_root", "trainer.max_steps", "trainer.val_check",
             "test="))] + ["trainer.max_steps=3", "trainer.val_check_interval=100",
                           f"ckpt_path={run / 'checkpoints' / 'step_00000001.ckpt'}"]
        # the tp = 2 ranks resume at tp = 2 (the entry point's main in each)
        (tmp / "resume.json").write_text(json.dumps(
            resume_args + ["trainer.mesh_tp=2", f"path.exp_root={tmp / 'tp2'}"]))
        train_main(resume_args + ["trainer.mesh_tp=1", f"path.exp_root={tmp / 'tp1'}"])
    finally:
        torch.set_num_threads(n)
        if fit.poll() is None:
            fit.kill()
        jax_thread.join()
        if not (tmp / "resume.json").exists():
            (tmp / "resume.json").write_text("[]")
        ranks = {job: _join(p, job, tmp) for job, p in procs.items()}
    assert jax_run, "JAX's step did not run"
    return {"single": single, "ranks": ranks, "jax": jax_run, "inp": inp, "tmp": tmp,
            "fit_log": fit_log}


# ------------------------------------------------------------------ placement
def _leaves(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        yield from (_leaves(v, path) if isinstance(v, dict) else [(path, v)])


def _jax_placement(params, tpn):
    """{leaf path: shard shape} of the leaves JAX's shard_params shards on
    make_mesh(dp=1, tp=tpn), and every leaf's path."""
    from open_universe_tpu.parallel.mesh import make_mesh, shard_params

    placed = dict(_leaves(shard_params(make_mesh(dp=1, tp=tpn), params, min_last=MIN_LAST)))
    return ({k: tuple(v.sharding.shard_shape(v.shape)) for k, v in placed.items()
             if not v.sharding.is_fully_replicated}, set(placed))


def test_placement_is_jax_param_sharding():
    """The tiny UNIVERSE++ with its discriminators at tp = 2: the port
    shards exactly the parameters JAX shards, each shard in JAX's layout of
    JAX's shard shape; a transposed conv on its dim 1 (JAX's last axis, its
    Cout), every other matrix on its dim 0; no weight_g (1-D in JAX); the
    leaves JAX also shards that the port holds as buffers are constants.
    At tp = 1 nothing is sharded."""
    from open_universe_tpu.configs import registry as jregistry
    from open_universe_tpu.nn.module import buffer_mask
    from open_universe_tpu_torch.nn.layers import ConvTranspose1d

    cfg = gan_config()
    jm = jregistry.instantiate(cfg)
    params = draw_params(jm)
    model = pregistry.instantiate_trainable(copy.deepcopy(cfg))
    want, jax_leaves = _jax_placement(params, 2)
    got = tp.placement(model, 2, MIN_LAST)
    assert got and tp.placement(model, 1, MIN_LAST) == {}
    modules = dict(model.named_modules())
    names = dict(model.named_parameters())
    assert set(names) <= jax_leaves
    buffers = {k for k, v in _flat(buffer_mask(jm, params)).items() if not v}
    assert set(got) == set(want) - buffers, (set(got) ^ (set(want) - buffers))
    assert not (set(want) & buffers) & set(names)
    for name, dim in got.items():
        mod, _, leaf = name.rpartition(".")
        shard = list(names[name].shape)
        shard[dim] //= 2
        assert jax_layout(modules[mod], leaf, shard)[0] == want[name], name
    transposed = [n for n in got if isinstance(modules[n.rpartition(".")[0]], ConvTranspose1d)]
    assert transposed and all(got[n] == 1 for n in transposed), transposed
    assert all(d == 0 for n, d in got.items() if n not in transposed and names[n].dim() > 1
               and not n.endswith(("lora_weight_b", "lora_linear_b")))
    gains = [n for n, p in names.items() if n.endswith("weight_g") and p.shape[0] >= MIN_LAST]
    assert gains and not set(gains) & set(got) and not set(gains) & set(want)


# ------------------------------------------------------------------ tp = 2
@pytest.mark.parametrize("family", ["gan", "orig", "lora"])
def test_two_tp_ranks_equal_one_process(runs, family, record_property):
    """dp = 1, tp = 2: each rank holds half of every sharded parameter,
    gradient, AdamW moment and EMA shadow; the ranks agree with each other
    and with one process: step 1's losses bit for bit, step 1's gradients
    element for element, the gradient norms within 1e-6 relative, the
    parameters and EMA after step 2 within test_torch_ddp's bounds."""
    one = runs["single"][family]
    r0, r1 = (r[family] for r in runs["ranks"]["tp2"])
    held, whole = r0["held"], one["held"]
    assert held["dims"] and not whole["dims"]
    for kind in ("params", "grads", "moments", "ema"):
        assert set(held[kind]) == set(whole[kind]), kind
        for n, shape in whole[kind].items():
            want = list(shape)
            if n in held["dims"]:
                want[held["dims"][n]] //= 2
            assert held[kind][n] == tuple(want), (kind, n)
    assert r0["losses"] == r1["losses"]
    first = {k: v for k, v in one["losses"][0].items() if not k.startswith("grad/")}
    assert {k: r0["losses"][0][k] for k in first} == first
    for a, b in zip(r0["losses"], one["losses"]):
        for k, v in b.items():
            if k.startswith("grad/"):
                assert _rel(a[k], v) <= 1e-6, (k, a[k], v)
    assert set(r0["grads"]) == set(one["grads"])
    for n, g in one["grads"].items():
        assert torch.equal(r0["grads"][n], g), n
    for n, p in r0["params"].items():
        assert torch.equal(p, r1["params"][n]), n

    class _Model:
        def named_parameters(self):
            return r0["params"].items()

    class _Ema:
        shadow = r0["ema"]

    lr = {"gan": 2e-4, "orig": runs["inp"]["orig_cfg"]["optimizer"]["lr"], "lora": 1e-3}[family]
    check_against(_Model(), {n: p.numpy() for n, p in one["params"].items()},
                  {n: s.numpy() for n, s in one["ema"].items()},
                  {n: g.numpy() for n, g in one["grads"].items()}, _Ema(), 2 * lr,
                  record_property, f"tp2_{family}")


# ------------------------------------------------------------------ dp x tp
def test_dp2_tp2_equals_jax(runs, record_property):
    """The plain UNIVERSE on 4 ranks (dp = 2, tp = 2) against JAX's step on
    make_mesh(dp=2, tp=2), tp_min_shard 8: losses within 1e-5 relative,
    grad/norm within 2e-4 relative, step 1's gradients per tensor within
    1e-5 of its largest (1e-4 for a one-element slope), the parameters and
    EMA after step 2 within test_torch_ddp's bounds; the two tp ranks of a
    dp group agree bit for bit."""
    ranks, want = runs["ranks"]["dp2_tp2"], runs["jax"]
    r0 = ranks[0]
    assert r0["held"]["dims"]
    for r in ranks[1:]:
        assert r["losses"] == r0["losses"]
        for n, p in r["params"].items():
            assert torch.equal(p, r0["params"][n]), n
    _losses_close(r0["losses"], want["metrics"], 1e-5)
    for a, b in zip(r0["losses"], want["metrics"]):
        assert _rel(a["grad/norm"], b["grad/norm"]) <= 2e-4, (a["grad/norm"], b["grad/norm"])
    record_property("grad_norm_rel", [_rel(a["grad/norm"], b["grad/norm"])
                                      for a, b in zip(r0["losses"], want["metrics"])])
    model = pregistry.instantiate_trainable(copy.deepcopy(runs["inp"]["orig_cfg"]))
    params = dict(model.named_parameters())
    grads = {n: g for n, g in _port_layout(model, want["grads"]).items() if n in params}
    _check_grads({n: g.numpy() for n, g in r0["grads"].items()}, grads, record_property,
                 "jax_dp2_tp2")

    class _Model:
        def named_parameters(self):
            return r0["params"].items()

    class _Ema:
        shadow = r0["ema"]

    check_against(_Model(), _port_layout(model, want["params"]),
                  _port_layout(model, want["ema"]), grads, _Ema(),
                  2 * runs["inp"]["orig_cfg"]["optimizer"]["lr"], record_property,
                  "jax_dp2_tp2")


# ------------------------------------------------------------------ the entry point
def _shapes(obj, prefix=""):
    if torch.is_tensor(obj):
        return {prefix: tuple(obj.shape)}
    if isinstance(obj, dict):
        items = obj.items()
    elif isinstance(obj, (list, tuple)):
        items = enumerate(obj)
    else:
        return {}
    out = {}
    for k, v in items:
        out.update(_shapes(v, f"{prefix}/{k}"))
    return out


def test_entry_point_checkpoint_loads_and_resumes_at_any_tp(runs):
    """torchrun, 2 processes at tp = 2: each step logged once, a validation
    and the test on rank 0; its checkpoints hold full tensors (keys and
    shapes of the one-process run's, mid-accumulation too); ``load_model``
    reads one; resumed from step 1 (its loader and generator restart from
    the seed) at tp = 2 and at tp = 1 the run reaches the same step-2 and
    step-3 losses."""
    from open_universe_tpu_torch.inference.model_loader import load_model
    from open_universe_tpu_torch.models.universe import Universe

    tmp = runs["tmp"]
    assert "rank 1 of 2" in runs["fit_log"]
    run, rows = _metrics(tmp / "fit")
    assert [r["step"] for r in rows if "train/loss_gen" in r] == [1, 2]
    assert [r["step"] for r in rows if "val/score" in r] == [2]
    assert json.loads((run / "test_summary.json").read_text())
    first = torch.load(run / "checkpoints" / "step_00000001.ckpt", map_location="cpu",
                       weights_only=False)
    assert [a["mini_step"] for a in first["grad_accumulators"]] == [1, 1]
    run1, rows1 = _metrics(tmp / "tp1")
    run2, rows2 = _metrics(tmp / "tp2")
    one, tp2 = (torch.load(r / "checkpoints" / "step_00000003.ckpt", map_location="cpu",
                           weights_only=False) for r in (run1, run2))
    assert [a["mini_step"] for a in tp2["grad_accumulators"]] == [1, 1]
    assert _shapes(tp2) == _shapes(one) and len(_shapes(one)) > len(_shapes(first))
    assert all(_shapes(one)[k] == v for k, v in _shapes(first).items())
    model = load_model(str(run / "checkpoints" / "step_00000002.ckpt"), device="cpu")
    assert isinstance(model, Universe) and all(
        torch.isfinite(p).all() for p in model.parameters())
    loss = {name: {r["step"]: r["train/loss_gen"] for r in rs if "train/loss_gen" in r}
            for name, rs in (("fit", rows), ("tp1", rows1), ("tp2", rows2))}
    assert set(loss["tp1"]) == set(loss["tp2"]) == {2, 3}, loss
    assert _rel(loss["tp2"][2], loss["tp1"][2]) <= 1e-6, loss
    assert _rel(loss["tp2"][3], loss["tp1"][3]) <= 1e-6, loss
