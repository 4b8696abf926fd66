"""Carrying weights over from the JAX package.

``from_jax_params`` writes a JAX param tree (nested dicts, numpy leaves) into
a port model.  The two trees share their names (the reference ``state_dict``
names); the leaves differ in layout, by these rules (the JAX package's
``inference/torch_convert.py``, in the other direction):

    Conv1d           (K, Cin/g, Cout)   -> (Cout, Cin/g, K)
    ConvTranspose1d  flipped (K, Cin, Cout) -> (Cin, Cout, K)
    Conv2d           (KH, KW, Cin, Cout) -> (Cout, Cin, KH, KW)
    Linear, GRU mats                    -> transposed
    weight_g (N,)                       -> (N, 1, 1) conv, (N, 1, 1, 1)
                                           Conv2d, (N, 1) linear

The GAN's discriminators (``loss_mpd``, ``loss_mrd``) are Conv2d trees and
carry over like the generator; so do the plain UNIVERSE's MDN losses
(``loss_signal``, ``loss_latent``: a LayerNorm, whose leaves keep their
layout, and a PReLUConv).  A transform has no parameters.  A LoRA tree
(JAX ``nn/lora.py``) carries over onto the port's ``LoraLayer`` modules of
the same names: its ``conv``/``linear``-nested base leaves by the rules
above, its ``lora_*`` leaves as they are (both sides hold them in torch
layout), and a ``UniverseLoRA``'s ``{"model": ...}`` root, with the kept
discriminators, onto its ``model``.

``jax_layout`` gives a port leaf's JAX shape and the port's axis that holds
JAX's last one (``parallel/tp.py`` places the tensor-parallel shards by it).
``fold_weight_norm`` replaces every (weight_g, weight_v) pair by its weight,
as the inference loader does.  ``from_flax_wav2vec2`` carries a Flax
``FlaxWav2Vec2ForCTC`` tree over to the port's ``nn/wav2vec2.py`` names.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..nn.layers import GRU, Conv1d, Conv2d, ConvTranspose1d, Linear, _Weighted


# the JAX axes a weight's torch axes hold, in torch order (a transposed
# conv's taps are also flipped); a weight_g is (N,) in JAX, (N, 1, ...) here
_WEIGHT_AXES = ((Conv1d, (2, 1, 0)), (ConvTranspose1d, (1, 2, 0)), (Conv2d, (3, 2, 0, 1)),
                (Linear, (1, 0)), (GRU, (1, 0)))


def _weight_axes(module: nn.Module, leaf: str):
    """(JAX axes in torch order, or None for a leaf both packages lay out
    alike; whether the leaf is a weight_g)."""
    for cls, axes in _WEIGHT_AXES:
        if isinstance(module, cls):
            if leaf in ("weight", "weight_v") or (cls is GRU and leaf.startswith("weight")):
                return axes, False
            if leaf == "weight_g" and cls is not GRU:
                return axes, True
    return None, False


def _to_port_layout(module: nn.Module, leaf: str, v: np.ndarray) -> np.ndarray:
    axes, gain = _weight_axes(module, leaf)
    if axes is None:
        return v
    if gain:
        return v.reshape((-1,) + (1,) * (len(axes) - 1))
    if isinstance(module, ConvTranspose1d):
        v = v[::-1]
    return v.transpose(*axes)


def jax_layout(module: nn.Module, leaf: str, shape) -> Tuple[Tuple[int, ...], Optional[int]]:
    """A port leaf's shape in the JAX package's layout, and the port's axis
    that holds JAX's last axis (None for a 1-D JAX leaf: a weight_g)."""
    shape = tuple(shape)
    axes, gain = _weight_axes(module, leaf)
    if axes is None:
        return shape, len(shape) - 1
    if gain:
        return (shape[0],), None
    jax_shape = [0] * len(axes)
    for port_dim, jax_dim in enumerate(axes):
        jax_shape[jax_dim] = shape[port_dim]
    return tuple(jax_shape), axes.index(len(axes) - 1)


def _leaves(tree: Dict[str, Any], prefix: str = ""):
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from _leaves(v, path)
        else:
            yield path, v


@torch.no_grad()
def from_jax_params(model: nn.Module, params: Dict[str, Any]) -> List[str]:
    """Copy a JAX param tree into ``model`` in place.

    Every parameter and persistent buffer of ``model`` must be in the tree,
    with the same weight-norm state (fold both sides or neither).  Returns
    the tree's paths that the model has no module for (parts not ported,
    or the discriminators of a GAN built for inference).
    """
    modules = dict(model.named_modules())
    state = model.state_dict(keep_vars=True)
    skipped, seen = [], set()
    for path, value in _leaves(params):
        mod_path, _, leaf = path.rpartition(".")
        module = modules.get(mod_path)
        if module is None:
            skipped.append(path)
            continue
        if path not in state:
            raise KeyError(f"{path}: the port's {type(module).__name__} has no "
                           f"{leaf!r} (is only one side folded?)")
        target = state[path]
        arr = _to_port_layout(module, leaf, np.asarray(value, np.float32))
        if tuple(arr.shape) != tuple(target.shape):
            raise ValueError(f"{path}: shape {arr.shape} does not fit "
                             f"{tuple(target.shape)}")
        target.copy_(torch.from_numpy(np.array(arr)))
        seen.add(path)
    missing = sorted(set(state) - seen)
    if missing:
        raise KeyError(f"the param tree has no value for {missing}")
    return skipped


def fold_weight_norm(model: nn.Module) -> nn.Module:
    """Fold every weight-normed layer of ``model`` in place."""
    for m in model.modules():
        if isinstance(m, _Weighted):
            m.fold_weight_norm()
    return model


def from_flax_wav2vec2(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A ``FlaxWav2Vec2ForCTC`` param tree (nested dicts, numpy leaves) as a
    state dict of the port's ``Wav2Vec2ForCTC`` (``transformers``' torch
    names): conv ``kernel`` (K, Cin, Cout) -> ``weight`` (Cout, Cin, K);
    Dense ``kernel`` (In, Out) -> ``weight`` (Out, In); LayerNorm ``scale``
    -> ``weight``; the positional conv's ``weight_v`` (Cout, Cin/g, K) and
    ``weight_g`` (1, 1, K) keep their layouts; ``masked_spec_embed`` (used
    only for masking in training) is dropped."""
    out = {}
    for path, value in _leaves(params):
        if path.endswith("masked_spec_embed"):
            continue
        v = np.array(value, np.float32)
        mod, _, leaf = path.rpartition(".")
        if leaf == "kernel":
            leaf, v = "weight", (v.transpose(2, 1, 0) if v.ndim == 3 else v.T)
        elif leaf == "scale":
            leaf = "weight"
        out[f"{mod}.{leaf}"] = torch.from_numpy(np.ascontiguousarray(v))
    return out
