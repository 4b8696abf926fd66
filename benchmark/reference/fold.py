"""The loader's arithmetic, worked out again: the checkpoint's EMA shadow
replaces its parameters, then every weight-norm pair (g, v) becomes the
weight g v / ||v||, the norm over every axis but the first."""
from __future__ import annotations

from typing import Dict, Sequence

import torch

from .model import Reference


def fold(cfg: dict, state: Dict[str, torch.Tensor],
         shadow: Sequence[torch.Tensor]) -> Reference:
    """The folded reference model (float32, on the state's device) of a
    reference-layout checkpoint: ``state`` its ``state_dict``, ``shadow``
    its ``ema.shadow_params``."""
    spec = Reference(cfg, weight_norm=True)
    subs = spec.ema_subs()
    params = {n for n, _ in spec.named_parameters()}
    alias = {s: "score_model" if s == "_edm_model" else s for s in subs}
    ema_keys = [k for s in subs for k in state
                if k.startswith(s + ".") and alias[s] + k[len(s):] in params]
    if len(ema_keys) != len(shadow):
        raise ValueError(f"EMA shadow has {len(shadow)} tensors for {len(ema_keys)} parameters")
    merged = {}
    for k, v in state.items():
        s = k.split(".", 1)[0]
        merged[alias.get(s, s) + k[len(s):]] = v
    for k, v in zip(ema_keys, shadow):
        s = k.split(".", 1)[0]
        merged[alias[s] + k[len(s):]] = v
    folded = {}
    for k, v in merged.items():
        if k.endswith(".weight_v"):
            continue
        if k.endswith(".weight_g"):
            base = k[: -len("_g")]
            w = merged[base + "_v"].float()
            norm = torch.sqrt(torch.sum(w * w, dim=tuple(range(1, w.dim())), keepdim=True))
            folded[base] = v.float() * w / torch.clamp(norm, min=1e-12)
        else:
            folded[k] = v.float()
    model = Reference(cfg, weight_norm=False)
    own = model.state_dict()
    missing = [k for k in own if k not in folded]
    if missing:
        raise KeyError(f"checkpoint lacks {missing[:5]}")
    device = next(iter(state.values())).device
    model.load_state_dict({k: folded[k] for k in own}, strict=True)
    return model.to(device).eval()
