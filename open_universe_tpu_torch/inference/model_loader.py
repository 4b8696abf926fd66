"""Model loading from a reference-layout Lightning checkpoint or the HF hub
(JAX package ``inference/model_loader.py`` and
``inference/torch_convert.py``).

A model spec is a local ``*.ckpt`` (its config found at ``./config.yaml``,
``../.hydra/config.yaml`` or ``./hparams.yaml``) or an HF repo
``repo[:revision]`` hosting ``weights.ckpt`` and ``config.yaml``.  The
port's modules carry the reference's ``state_dict`` names and PyTorch
layouts, so the weights go in with ``load_state_dict``; the EDM checkpoints'
``_edm_model.`` prefix maps onto ``score_model.``.  With ``load_ema`` the
checkpoint's EMA shadow replaces the weights, and with ``fold_wn`` weight
norm is folded.

Not ported: the JAX package's Orbax Trainer run directories (export one
with its ``bin/export_torch.py`` first).  Like the JAX loader, this one does
not resolve ``${...}`` interpolations in the config.
"""
from __future__ import annotations

import logging
import re
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch
import yaml
from torch import nn

from ..configs.registry import instantiate
from ..utils.convert import fold_weight_norm
from ..utils.device import resolve_device

log = logging.getLogger(__name__)

DEFAULT_MODEL = "line-corporation/open-universe:plusplus"

# buffers the reference saves and the port recomputes (never loaded)
_BUFFER_PATTERNS = (
    re.compile(r"\.low_pass_filter\.weights$"),
    re.compile(r"\.aa\.weights$"),
    re.compile(r"\.mel_spec\."),
    re.compile(r"\.upsample\.kernel$"),
    re.compile(r"\.downsample\.kernel$"),
    re.compile(r"(^|\.)stft_window$"),
    re.compile(r"st_convs\.\d+\.0\.weights$"),
)
# a buffer that is loaded (drawn at init), but is no parameter
_SIGMA_FREQ = re.compile(r"sigma_block\.freq$")
_EDM_PREFIX = re.compile(r"(^|\.)_edm_model\.")


def is_buffer_key(key: str) -> bool:
    return bool(_SIGMA_FREQ.search(key)) or any(p.search(key) for p in _BUFFER_PATTERNS)


def normalize_key(key: str) -> str:
    """The port's name for a reference key: ``_edm_model.`` is the score
    model."""
    return _EDM_PREFIX.sub(r"\1score_model.", key)


def ckpt_to_config_path(ckpt_path: Path) -> Path:
    """The reference's config discovery rule (model_loader.py:33-48)."""
    ckpt_path = Path(ckpt_path)
    for cand in (ckpt_path.parent / "config.yaml",
                 ckpt_path.parent.parent / ".hydra" / "config.yaml",
                 ckpt_path.parent / "hparams.yaml"):
        if cand.exists():
            return cand
    raise FileNotFoundError(f"no config.yaml found next to {ckpt_path}")


def _download_hf(repo: str, revision: Optional[str]) -> Tuple[Path, Path]:
    try:
        from huggingface_hub import hf_hub_download
    except ImportError as e:
        raise RuntimeError("huggingface_hub is required for hub models") from e
    ckpt = hf_hub_download(repo_id=repo, filename="weights.ckpt", revision=revision)
    cfg = hf_hub_download(repo_id=repo, filename="config.yaml", revision=revision)
    return Path(ckpt), Path(cfg)


def ordered_param_names(state_dict: Dict[str, Any],
                        submodules: Sequence[str]) -> List[str]:
    """Parameter names in ``model_parameters()`` order, the order of an EMA
    shadow list (reference universe.py:130-133): each submodule's keys in
    state_dict order, buffers left out."""
    names: List[str] = []
    for sub in submodules:
        prefix = sub + "."
        names += [k for k in state_dict
                  if k.startswith(prefix) and not is_buffer_key(k)]
    return names


def _ema_subs(model: nn.Module, state_dict: Dict[str, Any]) -> List[str]:
    subs = list(model.model_param_keys())
    if any(k.startswith("_edm_model.") for k in state_dict):
        subs = ["_edm_model" if s == "score_model" else s for s in subs]
    return subs


@torch.no_grad()
def load_state(model: nn.Module, state_dict: Dict[str, Any],
               shadow_params: Optional[Sequence[Any]] = None) -> List[str]:
    """Write a reference ``state_dict`` into ``model``; with
    ``shadow_params`` (an EMA shadow list) the shadows replace the model's
    parameters.  Every parameter and persistent buffer of ``model`` must be
    in the checkpoint.  Returns the checkpoint keys the port has no place
    for (recomputed buffers, the GAN losses' modules, layers not ported)."""
    own = model.state_dict()
    sd, skipped = {}, []
    for key, value in state_dict.items():
        name = normalize_key(key)
        if name in own:
            sd[name] = value
        else:
            skipped.append(key)
    if shadow_params is not None:
        names = ordered_param_names(state_dict, _ema_subs(model, state_dict))
        if len(names) != len(shadow_params):
            raise ValueError(f"EMA shadow has {len(shadow_params)} tensors but the "
                             f"checkpoint has {len(names)} parameters in "
                             f"{_ema_subs(model, state_dict)}")
        for key, value in zip(names, shadow_params):
            name = normalize_key(key)
            if name in own:
                sd[name] = value
            elif isinstance(getattr(model, name.split(".", 1)[0], None), nn.Module):
                raise KeyError(f"the port has no parameter {name!r} for EMA key {key!r}")
    model.load_state_dict(sd, strict=True)
    return skipped


def load_model(name_or_path: Union[str, Path], load_ema: bool = True,
               fold_wn: bool = True, device=None) -> nn.Module:
    """Load a model from a local ``.ckpt`` or the HF hub onto ``device``
    (CUDA unless given another), in eval mode; run it with
    ``model.enhance(mix, ...)``."""
    device = resolve_device(device)
    p = Path(name_or_path)
    if p.is_dir():
        raise NotImplementedError(
            f"{p} is a directory: Orbax Trainer runs are not ported; export one "
            "to a .ckpt with the JAX package's bin/export_torch.py")
    if p.exists() and p.suffix == ".ckpt":
        ckpt_path, cfg_path = p, ckpt_to_config_path(p)
    else:
        repo, _, rev = str(name_or_path).partition(":")
        ckpt_path, cfg_path = _download_hf(repo, rev or None)

    with open(cfg_path) as f:
        config = yaml.safe_load(f)
    model = instantiate(config.get("model", config))
    if not isinstance(model, nn.Module):
        raise TypeError(f"{cfg_path} does not describe a model")

    ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    state_dict = ckpt.get("state_dict", ckpt)
    ema = ckpt.get("ema") if isinstance(ckpt, dict) else None
    shadow = None
    if load_ema and ema is not None and "shadow_params" in ema:
        log.info("loading EMA shadow parameters")
        shadow = ema["shadow_params"]
    elif load_ema:
        log.warning("EMA weights requested but not found in checkpoint")
    skipped = load_state(model, state_dict, shadow)
    if skipped:
        log.info("skipped %d checkpoint keys the port has no place for: %s...",
                 len(skipped), skipped[:5])
    if fold_wn:
        fold_weight_norm(model)
    return model.to(device).eval()
