"""Carrying weights over from the JAX package.

``from_jax_params`` writes a JAX param tree (nested dicts, numpy leaves) into
a port model.  The two trees share their names (the reference ``state_dict``
names); the leaves differ in layout, by these rules (the JAX package's
``inference/torch_convert.py``, in the other direction):

    Conv1d           (K, Cin/g, Cout)   -> (Cout, Cin/g, K)
    ConvTranspose1d  flipped (K, Cin, Cout) -> (Cin, Cout, K)
    Linear, GRU mats                    -> transposed
    weight_g (N,)                       -> (N, 1, 1) conv, (N, 1) linear

``fold_weight_norm`` replaces every (weight_g, weight_v) pair by its weight,
as the inference loader does.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch
from torch import nn

from ..nn.layers import GRU, Conv1d, ConvTranspose1d, Linear, _Weighted


def _to_port_layout(module: nn.Module, leaf: str, v: np.ndarray) -> np.ndarray:
    if isinstance(module, Conv1d):
        if leaf in ("weight", "weight_v"):
            return v.transpose(2, 1, 0)
        if leaf == "weight_g":
            return v.reshape(-1, 1, 1)
    elif isinstance(module, ConvTranspose1d):
        if leaf in ("weight", "weight_v"):
            return v[::-1].transpose(1, 2, 0)
        if leaf == "weight_g":
            return v.reshape(-1, 1, 1)
    elif isinstance(module, Linear):
        if leaf in ("weight", "weight_v"):
            return v.T
        if leaf == "weight_g":
            return v.reshape(-1, 1)
    elif isinstance(module, GRU) and leaf.startswith("weight"):
        return v.T
    return v


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
    such as the GAN discriminators).
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
