"""Seeded weights in the published checkpoint's layout, made on the device.

Every tensor of the configuration's networks (names and shapes from the
plain reference built with weight norm) is drawn from one ``torch.Generator``
on the run's device in two large calls: one uniform draw for all of them,
one normal draw for the random Fourier frequencies.  Bounds follow the
published initialisation (uniform in +-1/sqrt(fan_in), the GRU's in
+-1/sqrt(hidden)); a weight-norm gain is its direction's norm times a
factor in [0.75, 1.25], so that folding changes the weight; PReLU slopes lie
in [0.2, 0.3].  The checkpoint holds these draws as its EMA shadow and half
of them as its raw weights, so a loader that skips the EMA serves another
model.
"""
from __future__ import annotations

import os
import re
from typing import Dict, List, Tuple

import torch
import yaml

from ..reference.layers import GRU, PReLU, Snake, Weighted
from ..reference.model import Reference, SigmaBlock, SimpleTimeEmbedding

RFF_SCALE = 16.0  # SigmaBlock's published frequency scale


def _kinds(spec: Reference) -> Dict[str, Tuple[str, float]]:
    """name -> (kind, bound) for every tensor of the checkpoint."""
    out = {}
    for mname, m in spec.named_modules():
        pre = mname + "." if mname else ""
        if isinstance(m, Weighted):
            b = m.fan_in ** -0.5
            for n, _ in m.named_parameters(recurse=False):
                out[pre + n] = ("gain" if n == "weight_g" else "uniform", b)
        elif isinstance(m, GRU):
            for n, _ in m.named_parameters(recurse=False):
                out[pre + n] = ("uniform", m.hidden ** -0.5)
        elif isinstance(m, PReLU):
            out[pre + "weight"] = ("slope", 0.05)
        elif isinstance(m, Snake):
            out[pre + "alpha"] = ("uniform", 0.5)
        elif isinstance(m, SimpleTimeEmbedding):
            out[pre + "weight"] = out[pre + "bias"] = ("uniform", 1.0)
        elif isinstance(m, SigmaBlock):
            out[pre + "freq"] = ("normal", RFF_SCALE)
        for n, _ in m.named_parameters(recurse=False):
            out.setdefault(pre + n, ("uniform", 0.1))  # the low-pass convs' separate bias
    return out


def draw(cfg: dict, seed: int, device) -> Tuple[Dict[str, torch.Tensor], List[torch.Tensor]]:
    """(state_dict, EMA shadow list) of a reference-layout checkpoint: the
    score model under ``_edm_model.`` when the model has EDM, as the
    published UNIVERSE++ checkpoints store it."""
    spec = Reference(cfg, weight_norm=True).to("meta")
    shapes = dict(spec.state_dict())
    kinds = _kinds(spec)
    g = torch.Generator(device=device).manual_seed(seed)
    sizes = [shapes[n].numel() for n in shapes]
    flat_u = torch.rand(sum(sizes), generator=g, device=device) * 2.0 - 1.0
    n_normal = sum(s for n, s in zip(shapes, sizes) if kinds[n][0] == "normal")
    flat_n = torch.randn(max(n_normal, 1), generator=g, device=device)
    params, off, off_n = {}, 0, 0
    for (name, shape), size in zip(shapes.items(), sizes):
        kind, bound = kinds[name]
        u = flat_u[off: off + size].view(shape.shape)
        off += size
        if kind == "normal":
            params[name] = flat_n[off_n: off_n + size].view(shape.shape) * bound
            off_n += size
        elif kind == "slope":
            params[name] = 0.25 + bound * u
        elif kind == "gain":
            params[name] = 1.0 + 0.25 * u  # scaled by the norm of v below
        else:
            params[name] = bound * u
    for name in shapes:
        if kinds[name][0] == "gain":
            v = params[name[: -len("_g")] + "_v"]
            params[name] = params[name] * torch.sqrt(
                torch.sum(v * v, dim=tuple(range(1, v.dim())), keepdim=True))
    subs = spec.ema_subs()
    prefix = {"score_model": subs[0]}
    ordered = {}
    for sub in ("score_model",) + tuple(s for s in subs[1:]):
        for name in shapes:
            if name.startswith(sub + "."):
                ordered[prefix.get(sub, sub) + name[len(sub):]] = params[name]
    param_names = {n for n, _ in spec.named_parameters()}
    shadow = [v for k, v in ordered.items()
              if re.sub(r"^_edm_model\.", "score_model.", k) in param_names]
    state = {k: (v * 0.5 if re.sub(r"^_edm_model\.", "score_model.", k) in param_names else v)
             for k, v in ordered.items()}
    return state, shadow


def write_checkpoint(directory: str, cfg: dict, state, shadow) -> str:
    """``weights.ckpt`` (state_dict and EMA shadow, on the host) and the
    model node as ``config.yaml`` beside it; the checkpoint's path."""
    path = os.path.join(directory, "weights.ckpt")
    torch.save({"state_dict": {k: v.cpu() for k, v in state.items()},
                "ema": {"shadow_params": [v.cpu() for v in shadow], "decay": 0.999,
                        "num_updates": 1000}}, path)
    with open(os.path.join(directory, "config.yaml"), "w") as f:
        yaml.safe_dump({"model": cfg}, f)
    return path
