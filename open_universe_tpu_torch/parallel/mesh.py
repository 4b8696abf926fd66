"""Data and tensor parallelism with ``torch.distributed`` (JAX package
``parallel/mesh.py``).

The reference trains with Lightning DDP over NCCL; the JAX package shards
the batch over a ``dp`` mesh axis and lets GSPMD sum the gradients, and
with ``tp`` > 1 also shards the wide weights over a ``tp`` axis.  Here
every process of a ``torchrun`` job (``init_from_env``: NCCL on CUDA, one
card per process, ``cuda:<LOCAL_RANK>``; gloo on the CPU) loads the same
**global** batch from the same loader, as JAX's ``shard_batch`` does
(Lightning's batch size is per device).  ``make_mesh`` lays the W
processes out as JAX's ``make_mesh`` lays out its devices, a (dp, tp) grid
with rank r = d * tp + t, and makes a process group for each dp row and each
tp column.  A step takes its dp group's rows (``local_rows``) after the
random draws are made for the whole batch, so the job computes what one
process computes on the global batch:

- every gradient is averaged (``all_mean_``, one collective per group
  and backward) before it is clipped: a replicated parameter's over every
  rank, a tp-sharded one's (``parallel/tp.py``) over its dp group, since
  the tp ranks hold different slices;
- a decision JAX takes on a global-batch value is taken on all ranks
  together: ``any_rank`` for the MDN losses' non-finite skip, the losses
  averaged (``mean_scalars``) before ``nan_guard``'s check and the logs.

Every loss of the three families is a mean over equal-size shards, so the
averaged gradients are JAX's global ones.  Nothing falls back: a process
group that does not start, a mesh that does not cover the job, or a
collective that fails, raises.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..utils.device import resolve_device


def world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def is_main() -> bool:
    return rank() == 0


_LAYOUT: Dict[str, object] = {"tp": 1, "tp_group": None, "dp_group": None}


def make_mesh(dp: Optional[int] = None, tp: int = 1) -> None:
    """Lay the job's processes out as a (dp, tp) grid (JAX's ``make_mesh``:
    rank r = d * tp + t; ``dp`` defaults to world // tp) and make its
    process groups.  Every rank calls it with the same arguments; dp * tp
    must be the world size."""
    w, tp = world_size(), int(tp or 1)
    dp = max(w // tp, 1) if dp is None else int(dp)
    if dp * tp != w:
        raise ValueError(f"trainer.mesh_dp={dp} x trainer.mesh_tp={tp} needs {dp * tp} "
                         f"processes but the job has {w} (torchrun --nproc_per_node)")
    _LAYOUT.update(tp=tp, tp_group=None, dp_group=None)
    if tp == 1:
        return
    # every rank makes every group, in one order, as new_group requires
    for d in range(dp):
        g = dist.new_group(list(range(d * tp, (d + 1) * tp)))
        if rank() // tp == d:
            _LAYOUT["tp_group"] = g
    for t in range(tp):
        g = dist.new_group(list(range(t, w, tp)))
        if rank() % tp == t:
            _LAYOUT["dp_group"] = g


def tp_size() -> int:
    return int(_LAYOUT["tp"]) if world_size() > 1 else 1


def tp_rank() -> int:
    return rank() % tp_size()


def tp_group():
    return _LAYOUT["tp_group"]


def dp_size() -> int:
    return world_size() // tp_size()


def dp_rank() -> int:
    return rank() // tp_size()


def init_from_env(device=None, mesh_dp: Optional[int] = None, mesh_tp: Optional[int] = 1
                  ) -> torch.device:
    """Join the process group that ``torchrun`` describes in the environment
    (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``/``PORT``), if
    any, lay the job out as a (``mesh_dp``, ``mesh_tp``) mesh and return
    this process's device: ``cuda:<LOCAL_RANK>`` (NCCL) unless ``device``
    names the CPU (gloo).  ``mesh_dp`` defaults to the world size over
    ``mesh_tp``; the mesh must cover the job."""
    device = resolve_device(device)
    if "WORLD_SIZE" in os.environ:
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
            torch.cuda.set_device(device)
        if not dist.is_initialized():
            dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                    init_method="env://")
    make_mesh(mesh_dp, mesh_tp)
    return device


def local_rows(batch: int) -> Optional[slice]:
    """This rank's rows of a global batch of ``batch`` rows (its dp
    group's: the tp ranks of a group take the same rows), or None where
    one dp group takes them all."""
    n = dp_size()
    if n == 1:
        return None
    if batch % n:
        raise ValueError(f"the global batch {batch} does not split over {n} data-parallel "
                         "groups")
    per = batch // n
    return slice(dp_rank() * per, (dp_rank() + 1) * per)


def _mean_(ts: List[torch.Tensor], group, n: int) -> None:
    if not ts:
        return
    flat = torch.cat([t.reshape(-1) for t in ts])
    dist.all_reduce(flat, group=group)
    flat /= n
    off = 0
    for t in ts:
        k = t.numel()
        t.copy_(flat[off:off + k].view_as(t))
        off += k


def all_mean_(tensors: Sequence[Optional[torch.Tensor]],
              sharded: Optional[Sequence[bool]] = None) -> None:
    """Average ``tensors`` (None skipped) in place: those flagged in
    ``sharded`` (tp shards) over their dp group, the others over every
    rank, one collective each."""
    flags = list(sharded) if sharded is not None else [False] * len(tensors)
    pairs = [(t, s) for t, s in zip(tensors, flags) if t is not None]
    if world_size() == 1 or not pairs:
        return
    _mean_([t for t, s in pairs if not s], None, world_size())
    if dp_size() > 1:
        _mean_([t for t, s in pairs if s], _LAYOUT["dp_group"], dp_size())


def mean_scalars(values: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The scalars of ``values`` averaged over the ranks (one collective)."""
    if world_size() == 1 or not values:
        return values
    keys = list(values)
    devices = [v.device for v in values.values() if isinstance(v, torch.Tensor)]
    device = next((d for d in devices if d.type == "cuda"), torch.device("cpu"))
    stacked = torch.stack([torch.as_tensor(values[k]).detach().to(device, torch.float32)
                           .reshape(()) for k in keys])
    dist.all_reduce(stacked)
    stacked /= world_size()
    return dict(zip(keys, stacked.unbind()))


def any_rank(flag: torch.Tensor) -> torch.Tensor:
    """A boolean tensor that is true where ``flag`` is true on any rank."""
    if world_size() == 1:
        return flag
    out = flag.to(torch.int32)
    dist.all_reduce(out, op=dist.ReduceOp.MAX)
    return out.bool()


def barrier() -> None:
    if world_size() > 1:
        dist.barrier()


def broadcast_object(obj):
    """Rank 0's ``obj`` on every rank."""
    if world_size() == 1:
        return obj
    box: List = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]
