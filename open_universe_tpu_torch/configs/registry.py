"""``_target_`` -> class map for configs (the port's own copy of the JAX
package's ``configs/registry.py``: the model, data and metric targets).

Both the reference's ``open_universe.`` names (so published ``config.yaml``
files load unchanged) and ``open_universe_tpu.`` names resolve.  A factory
takes the node's keys and builds its own children.  A target the port lacks
raises ``KeyError`` with its name.  ``instantiate`` builds a model for
inference, without its training nodes; ``instantiate_trainable`` builds a
model for the trainer, with them: a UNIVERSE or UNIVERSE++ with its loss
modules (the MDN losses, or the discriminators and the auxiliary loss
``losses.aux_loss``), or a ``UniverseLoRA`` that fine-tunes a checkpoint.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

_REGISTRY: Dict[str, Callable] = {}
_META = ("_target_", "_recursive_", "_convert_", "_partial_")
# keys of a Universe config that only training reads
_TRAINING_ONLY = ("losses", "training", "validation", "optimizer", "scheduler",
                  "grad_clipper", "with_noise_target", "detach_cond")


def register(name: str):
    def deco(fn):
        for prefix in ("open_universe.", "open_universe_tpu."):
            _REGISTRY[prefix + name] = fn
        return fn
    return deco


def instantiate(cfg: Any):
    """Build a config node: a dict with ``_target_`` goes to its factory;
    anything else is returned as it is."""
    if not (isinstance(cfg, dict) and "_target_" in cfg):
        return cfg
    target = cfg["_target_"]
    fn = _REGISTRY.get(target)
    if fn is None:
        known = sorted({k.split(".", 1)[1] for k in _REGISTRY})
        raise KeyError(f"the port has no class for _target_={target!r}; "
                       f"it has {known}")
    return fn(**{k: v for k, v in cfg.items() if k not in _META})


@register("networks.universe.ScoreNetwork")
def build_score_network(**kw):
    from ..models.score import ScoreNetwork

    return ScoreNetwork(precoding=instantiate(kw.pop("precoding", None)), **kw)


@register("networks.universe.ConditionerNetwork")
def build_conditioner_network(**kw):
    from ..models.condition import ConditionerNetwork

    return ConditionerNetwork(precoding=instantiate(kw.pop("precoding", None)),
                              **kw)


def _universe_kwargs(kw: dict, train: bool = False) -> dict:
    """The model's arguments.  The training-only keys are dropped, unless
    ``train``, after the check the JAX package makes of them: the score loss
    is MSE."""
    losses = kw.get("losses") or {}
    sl = losses.get("score_loss")
    if sl and sl.get("_target_", "").rsplit(".", 1)[-1] != "MSELoss":
        raise NotImplementedError(f"score_loss {sl} not supported (MSE only)")
    out = {k: v for k, v in kw.items() if train or k not in _TRAINING_ONLY}
    if train:
        out["losses"] = {k: v for k, v in losses.items()
                         if k not in ("score_loss", "aux_loss")}
        if losses.get("aux_loss"):
            out["losses"]["aux_loss_module"] = instantiate(losses["aux_loss"])
    out["score_model"] = instantiate(kw.get("score_model"))
    out["condition_model"] = instantiate(kw.get("condition_model"))
    if kw.get("transform"):
        out["transform"] = instantiate(kw["transform"])
    return out


@register("networks.universe.Universe")
def build_universe(train: bool = False, **kw):
    from ..models.universe import Universe

    return Universe(**_universe_kwargs(kw, train=train))


@register("networks.universe.UniverseGAN")
def build_universe_gan(train: bool = False, **kw):
    from ..models.universe_gan import UniverseGAN

    losses = kw.get("losses") or {}
    return UniverseGAN(
        use_signal_decoupling=bool(losses.get("use_signal_decoupling", False)),
        signal_decoupling_act=losses.get("signal_decoupling_act"),
        **_universe_kwargs(kw, train=train))


@register("networks.universe.UniverseLoRA")
def build_universe_lora(train: bool = False, **kw):
    """``model`` is the checkpoint to fine-tune; the loss nodes are built
    inside ``UniverseLoRA``, and left out (with the other training nodes)
    unless ``train``."""
    from ..models.universe_lora import UniverseLoRA

    if not train:
        kw = {k: v for k, v in kw.items() if k not in _TRAINING_ONLY}
    return UniverseLoRA(**kw)


def instantiate_trainable(cfg: dict):
    """The model of a training config with its training nodes (losses,
    training, validation, optimizer, scheduler, grad_clipper): a UNIVERSE or
    UNIVERSE++ with its loss modules, or a UniverseLoRA.  The rest of the
    enhancement family has no config target (as in the JAX package)."""
    target = cfg.get("_target_", "") if isinstance(cfg, dict) else ""
    fn = _REGISTRY.get(target)
    if fn not in (build_universe, build_universe_gan, build_universe_lora):
        raise NotImplementedError(f"the port trains Universe, UniverseGAN and UniverseLoRA "
                                  f"only, not {target!r}")
    return fn(train=True, **{k: v for k, v in cfg.items() if k not in _META})


@register("layers.dyn_range_comp.IdentityTransform")
def build_identity_transform(**kw):
    from ..models.transforms import IdentityTransform

    return IdentityTransform()


@register("layers.dyn_range_comp.CompressedMagSTFT")
def build_compressed_mag_stft(**kw):
    from ..models.transforms import CompressedMagSTFT

    return CompressedMagSTFT(**kw)


@register("layers.dyn_range_comp.CompressedMagSTFTPadded")
def build_compressed_mag_stft_padded(**kw):
    from ..models.transforms import CompressedMagSTFTPadded

    return CompressedMagSTFTPadded(**kw)


@register("losses.MultiResL1SpecLoss")
def build_multires_loss(**kw):
    from ..losses.multires_stft import MultiResL1SpecLoss

    return MultiResL1SpecLoss(**kw)


@register("losses.MultiLoss")
def build_multi_loss(**kw):
    from ..losses.combine import MultiLoss

    return MultiLoss({k: (v[0], instantiate(v[1])) for k, v in kw["losses"].items()})


@register("losses.PhonemeCTCLoss")
def build_phoneme_ctc_loss(**kw):
    from ..losses.phoneme_loss import PhonemeCTCLoss

    return PhonemeCTCLoss(**kw)


@register("losses.PhonemeLoss")
def build_phoneme_loss(**kw):
    from ..losses.phoneme_loss import PhonemeLoss

    return PhonemeLoss(**kw)


@register("losses.PhonemeEmbeddingLoss")
def build_phoneme_embedding_loss(**kw):
    from ..losses.phoneme_loss import PhonemeEmbeddingLoss

    return PhonemeEmbeddingLoss(**kw)


@register("metrics.EvalMetrics")
def build_eval_metrics(**kw):
    from ..metrics.eval import EvalMetrics

    return EvalMetrics(**kw)


@register("datasets.NoisyDataset")
def build_noisy_dataset(**kw):
    from ..data.dataset import NoisyDataset

    return NoisyDataset(**kw)


@register("datasets.DataModule")
def build_datamodule(**kw):
    from ..data.dataset import DataModule

    return DataModule(**kw)
