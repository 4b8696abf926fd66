"""Tensor parallelism over the mesh's ``tp`` axis (JAX package
``parallel/mesh.py``: ``param_sharding``, ``_tp_excluded``,
``shard_params``).

**Placement.**  JAX shards a leaf over ``tp`` on its last axis when tp > 1,
the leaf has two axes or more, and its last axis is at least ``min_last``
(the trainer's ``tp_min_shard``, 128) and divides by tp; a leaf under a
``layer_norm`` key stays replicated.  The rule reads JAX's layout, so
``placement`` applies it to each parameter's JAX shape
(``utils/convert.py::jax_layout``) and shards the port's axis that holds
JAX's last one: dim 0 of a conv, linear, 2-D conv or GRU matrix, dim 1 of
a transposed conv, the last dim of a leaf both packages lay out alike (a
LoRA factor); a ``weight_g`` is 1-D in JAX and never sharded.  Buffers
(filters, windows, mel banks) have no gradient, moment or shadow and stay
whole.  The trainer shards the model (``shard_``) before it builds its
step, so the optimizer's moments, the gradient accumulators and the EMA
shadows, which are made like their parameters, are shards too.

**Computation.**  A sharded parameter holds this rank's 1/tp slice along
its axis (``module.tp_dims`` names the parameter and the axis).  Where a
layer uses it (``_Weighted.effective_weight``, before weight norm, whose
norm may span the sharded axis; ``GRU.forward``, whose cuDNN call takes
whole gate matrices; a LoRA adapter's factors) ``weight`` gathers the full
tensor over the tp group with an autograd function whose backward keeps
this rank's slice of the full gradient.  Every tp rank runs the whole
forward and backward on its dp group's rows, so the full gradient is the
same on each and the slice is the shard's gradient.  This stores 1/tp of
the wide state per rank, the memory that tp frees in JAX; it does not split
the compute: each tp rank computes what a rank without tp computes.

The sharded gradients are averaged over the dp group, the replicated ones
over every rank (``mesh.all_mean_``); a clip norm sums the shards' squares
over the tp group once (``sum_squares``).  Checkpoints hold full tensors:
``gather_state``/``scatter_state`` for a state dict or the EMA shadow,
``gather_optimizer``/``scatter_optimizer`` for an optimizer's moments;
``unshard_`` makes a copy of the model whole again (validation and test).
Only ``all_gather`` runs between the tp ranks, which gloo takes on both
devices.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from . import mesh


def _tp_excluded(name: str) -> bool:
    """A leaf under a ``layer_norm`` key stays replicated (JAX's
    ``_tp_excluded``: an elementwise affine saves nothing when sharded)."""
    return "layer_norm" in name.split(".")


def placement(model: nn.Module, tp: int, min_last: int = 128) -> Dict[str, int]:
    """{parameter name: the port's axis to shard} for the parameters JAX
    shards over a ``tp``-way axis."""
    from ..utils.convert import jax_layout

    out = {}
    for mod_name, module in model.named_modules():
        for leaf, p in module.named_parameters(recurse=False):
            name = f"{mod_name}.{leaf}" if mod_name else leaf
            shape, dim = jax_layout(module, leaf, p.shape)
            # JAX's param_sharding rule, on the leaf's JAX shape
            if (tp > 1 and len(shape) >= 2 and shape[-1] >= min_last and shape[-1] % tp == 0
                    and not _tp_excluded(name)):
                out[name] = dim
    return out


def local(t: torch.Tensor, dim: int) -> torch.Tensor:
    """This tp rank's slice of a full tensor."""
    return t.chunk(mesh.tp_size(), dim)[mesh.tp_rank()]


def gather(t: torch.Tensor, dim: int) -> torch.Tensor:
    """The full tensor of the tp ranks' slices (every tp rank calls it)."""
    parts = [torch.empty_like(t) for _ in range(mesh.tp_size())]
    dist.all_gather(parts, t.contiguous(), group=mesh.tp_group())
    return torch.cat(parts, dim)


class _Gather(torch.autograd.Function):
    """Forward: the full tensor; backward: this rank's slice of its
    gradient (the same full gradient on every tp rank)."""

    @staticmethod
    def forward(ctx, shard: torch.Tensor, dim: int) -> torch.Tensor:
        ctx.dim = dim
        return gather(shard, dim)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return local(grad, ctx.dim).contiguous(), None


def weight(module: nn.Module, name: str) -> torch.Tensor:
    """``module``'s parameter ``name``, gathered whole if it is sharded."""
    p = getattr(module, name)
    dims = getattr(module, "tp_dims", None)
    if not dims or name not in dims:
        return p
    return _Gather.apply(p, dims[name])


def full_shape(module: nn.Module, name: str) -> torch.Size:
    """The shape of ``module``'s parameter ``name`` when whole."""
    shape = list(getattr(module, name).shape)
    dims = getattr(module, "tp_dims", None)
    if dims and name in dims:
        shape[dims[name]] *= mesh.tp_size()
    return torch.Size(shape)


def _owners(model: nn.Module):
    """(module, parameter leaf, full name, axis) of every sharded parameter."""
    for mod_name, module in model.named_modules():
        for leaf, dim in (getattr(module, "tp_dims", None) or {}).items():
            yield module, leaf, f"{mod_name}.{leaf}" if mod_name else leaf, dim


def dims(model: nn.Module) -> Dict[str, int]:
    """{full parameter name: axis} of ``model``'s sharded parameters."""
    return {name: dim for _, _, name, dim in _owners(model)}


def param_dims(model: nn.Module) -> Dict[int, int]:
    """{id(parameter): axis} of ``model``'s sharded parameters."""
    return {id(getattr(m, leaf)): dim for m, leaf, _, dim in _owners(model)}


@torch.no_grad()
def shard_(model: nn.Module, min_last: int = 128) -> None:
    """Replace the parameters JAX shards over the mesh's tp axis by this
    rank's slices, in place.  Nothing changes with tp = 1."""
    tp = mesh.tp_size()
    modules = dict(model.named_modules())
    for name, dim in placement(model, tp, min_last).items():
        mod_name, _, leaf = name.rpartition(".")
        module = modules[mod_name]
        p = getattr(module, leaf)
        shard = local(p.detach(), dim).clone(memory_format=torch.contiguous_format)
        setattr(module, leaf, nn.Parameter(shard, requires_grad=p.requires_grad))
        if getattr(module, "tp_dims", None) is None:
            module.tp_dims = {}
        module.tp_dims[leaf] = dim


@torch.no_grad()
def unshard_(model: nn.Module) -> nn.Module:
    """Make every sharded parameter of ``model`` whole again, in place
    (every tp rank calls it)."""
    for module, leaf, _, dim in list(_owners(model)):
        p = getattr(module, leaf)
        setattr(module, leaf, nn.Parameter(gather(p.detach(), dim),
                                           requires_grad=p.requires_grad))
    for module in model.modules():
        if getattr(module, "tp_dims", None) is not None:
            del module.tp_dims
    return model


def gather_state(state: Mapping[str, torch.Tensor], dims: Mapping[str, int]
                 ) -> Dict[str, torch.Tensor]:
    """``state`` with the tensors named in ``dims`` gathered whole."""
    return {k: gather(v, dims[k]) if k in dims else v for k, v in state.items()}


def scatter_state(state: Mapping[str, torch.Tensor], dims: Mapping[str, int]
                  ) -> Dict[str, torch.Tensor]:
    """``state`` with the tensors named in ``dims`` cut to this rank's
    slices."""
    return {k: local(v, dims[k]) if k in dims else v for k, v in state.items()}


def _optimizer_dims(opt: torch.optim.Optimizer, pdims: Mapping[int, int]) -> Dict[int, int]:
    params = [p for g in opt.param_groups for p in g["params"]]
    return {i: pdims[id(p)] for i, p in enumerate(params) if id(p) in pdims}


def _moments(st: dict, dim: Optional[int], fn) -> dict:
    if dim is None:
        return st
    return {k: fn(v, dim) if torch.is_tensor(v) and v.dim() > 0 else v for k, v in st.items()}


def gather_optimizer(opt: torch.optim.Optimizer, pdims: Mapping[int, int]) -> dict:
    """``opt.state_dict()`` with the sharded parameters' moments whole."""
    sd = opt.state_dict()
    idims = _optimizer_dims(opt, pdims)
    return {**sd, "state": {i: _moments(st, idims.get(i), gather)
                            for i, st in sd["state"].items()}}


def scatter_optimizer(opt: torch.optim.Optimizer, sd: dict, pdims: Mapping[int, int]) -> dict:
    """A full optimizer state dict cut to this rank's slices."""
    idims = _optimizer_dims(opt, pdims)
    return {**sd, "state": {i: _moments(st, idims.get(int(i)), local)
                            for i, st in sd["state"].items()}}


def sum_squares(grads: Sequence[torch.Tensor], sharded: Sequence[bool]) -> torch.Tensor:
    """The sum of squares of the whole gradients: each replicated one once,
    the shards' summed over the tp group."""
    rep = sum(torch.sum(g.float() * g.float()) for g, s in zip(grads, sharded) if not s)
    part = sum(torch.sum(g.float() * g.float()) for g, s in zip(grads, sharded) if s)
    if torch.is_tensor(part):
        part = part.clone()
        dist.all_reduce(part, group=mesh.tp_group())
    return rep + part
