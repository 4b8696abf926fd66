"""Training entry point of the port (the JAX package's root ``train.py``).

    python -m open_universe_tpu_torch.train experiment=universepp_vb_16k \\
        [key=value ...] [device=cpu]
    torchrun --nproc_per_node <N> -m open_universe_tpu_torch.train \\
        experiment=universe_original_vb_16k [key=value ...] [device=cpu]

Composes ``config/`` (defaults, the experiment overlay, dotlist overrides,
``${...}`` interpolations), seeds numpy, ``random`` and torch, builds the
datamodule and the model (UNIVERSE++, the plain UNIVERSE of
``experiment=universe_original_vb_16k``, or the LoRA fine-tune of a
checkpoint of ``experiment=universepp_lora_finetune model.model=<.ckpt>``,
whose ``PhonemeCTCLoss`` reads the wav2vec2 espeak checkpoint from the local
Hugging Face cache or ``+model.losses.phonemeloss.kwargs.checkpoint=<dir>``,
or is dropped with ``model.losses.phonemeloss=null``) with its losses, and
fits (validating every ``trainer.val_check_interval`` steps), resuming from ``ckpt_path=<.ckpt or
run dir>`` when given; with ``test=true`` it then evaluates the test split
(``test_results.json``, ``test_summary.json``; with ``train=false`` on the
checkpoint ``ckpt_path`` names).  The run directory is
``<path.exp_root>/<experiment>/<datetime>[_overrides]``; its checkpoints
load with ``inference/model_loader.py::load_model``.  It runs on CUDA unless
``device=cpu`` (or another device) is given, and raises without a GPU.

Under ``torchrun`` every process joins the job's process group
(``parallel/mesh.py``: NCCL, one card per process, ``cuda:<LOCAL_RANK>``;
gloo with ``device=cpu``) and trains data-parallel on its rows of the
configured batch, which is the global batch.  ``trainer.mesh_tp`` > 1
lays the processes out as JAX's (dp, tp) mesh (``trainer.mesh_dp``
defaults to the number of processes over ``mesh_tp``; dp x tp must be the
number of processes) and stores the wide weights (JAX's rule: a last JAX
axis of 128 or more), their gradients, moments and EMA shadows as tp
shards (``parallel/tp.py``).  Rank 0 names the run directory, validates,
tests and writes the checkpoints.  ``model.training.compute_dtype=bf16``,
``model.training.remat=true`` and
``model.optimizer.accumulate_grad_batches=<k>`` set mixed precision,
recomputation and gradient accumulation.
"""
import argparse
import datetime
import logging
import random
import sys
from pathlib import Path

log = logging.getLogger("open_universe_tpu_torch.train")


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("overrides", nargs="*",
                        help="group=choice, a.b=value, or device=<torch device>")
    parser.add_argument("--config-dir",
                        default=str(Path(__file__).resolve().parents[2] / "config"))
    args = parser.parse_args(argv)
    device = None
    overrides = []
    for ov in args.overrides:
        if ov.startswith("device="):
            device = ov.partition("=")[2]
        else:
            overrides.append(ov)

    import numpy as np
    import torch

    from ..configs.registry import instantiate, instantiate_trainable
    from ..configs.resolve import compose
    from ..parallel import mesh
    from .trainer import Trainer

    cfg = compose(args.config_dir, overrides)
    tcfg = cfg.get("trainer", {})
    device = mesh.init_from_env(device, tcfg.get("mesh_dp"), tcfg.get("mesh_tp", 1))
    experiment = cfg.get("_choices_", {}).get("experiment", "default")
    seed = cfg.get("seed", 0)
    np.random.seed(seed)
    random.seed(seed)
    torch.manual_seed(seed)

    dm = instantiate(cfg["datamodule"])
    model = instantiate_trainable(cfg["model"])

    ov_tag = "_".join(o.replace("/", ".") for o in overrides
                      if not o.startswith("experiment="))[:128]
    run_name = datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    if ov_tag:
        run_name += "_" + ov_tag
    run_name = mesh.broadcast_object(run_name)
    run_dir = Path(cfg.get("path", {}).get("exp_root", "exp")) / experiment / run_name
    log.info("run dir: %s, device %s", run_dir, device)

    trainer = Trainer(
        model, dm, run_dir,
        max_steps=tcfg.get("max_steps", 600000),
        val_check_interval=tcfg.get("val_check_interval", 5000),
        checkpoint_every=tcfg.get("checkpoint_every"),
        log_every=tcfg.get("log_every", 25),
        max_val_batches=tcfg.get("max_val_batches"),
        seed=seed, device=device, profile_steps=tcfg.get("profile_steps"),
        config={k: v for k, v in cfg.items() if not k.startswith("_")})
    if cfg.get("train", True):
        trainer.fit(resume_from=cfg.get("ckpt_path"))
    elif cfg.get("ckpt_path"):
        trainer.restore(cfg["ckpt_path"])
    if cfg.get("test", False):
        trainer.test()  # rank 0's; the tp ranks gather the weights with it
        mesh.barrier()
    return trainer


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    main()
