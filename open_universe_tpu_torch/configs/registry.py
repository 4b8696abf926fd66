"""``_target_`` -> class map for model configs (the port's own copy of the
JAX package's ``configs/registry.py``, model targets only).

Both the reference's ``open_universe.`` names (so published ``config.yaml``
files load unchanged) and ``open_universe_tpu.`` names resolve.  A factory
takes the node's keys and builds its own children.  A target the port lacks
raises ``KeyError`` with its name.
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


def _universe_kwargs(kw: dict) -> dict:
    """The sampler's arguments.  The training-only keys are dropped after
    the check the JAX package makes of them: the score loss is MSE."""
    losses = kw.get("losses") or {}
    sl = losses.get("score_loss")
    if sl and sl.get("_target_", "").rsplit(".", 1)[-1] != "MSELoss":
        raise NotImplementedError(f"score_loss {sl} not supported (MSE only)")
    out = {k: v for k, v in kw.items() if k not in _TRAINING_ONLY}
    out["score_model"] = instantiate(kw.get("score_model"))
    out["condition_model"] = instantiate(kw.get("condition_model"))
    if kw.get("transform"):
        out["transform"] = instantiate(kw["transform"])
    return out


@register("networks.universe.Universe")
def build_universe(**kw):
    from ..models.universe import Universe

    return Universe(**_universe_kwargs(kw))


@register("networks.universe.UniverseGAN")
def build_universe_gan(**kw):
    from ..models.universe_gan import UniverseGAN

    losses = kw.get("losses") or {}
    return UniverseGAN(
        use_signal_decoupling=bool(losses.get("use_signal_decoupling", False)),
        signal_decoupling_act=losses.get("signal_decoupling_act"),
        **_universe_kwargs(kw))


@register("layers.dyn_range_comp.IdentityTransform")
def build_identity_transform(**kw):
    from ..models.universe import IdentityTransform

    return IdentityTransform()
