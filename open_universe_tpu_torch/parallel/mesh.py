"""Data parallelism with ``torch.distributed`` (JAX package
``parallel/mesh.py``).

The reference trains with Lightning DDP over NCCL; the JAX package shards
the batch over a ``dp`` mesh axis and lets GSPMD sum the gradients.  Here
every process of a ``torchrun`` job (``init_from_env``: NCCL on CUDA, one
card per process, ``cuda:<LOCAL_RANK>``; gloo on the CPU) holds the whole
model and loads the same **global** batch from the same loader, as JAX's
``shard_batch`` does (Lightning's batch size is per device).  A step then
takes its rank's rows (``local_rows``) after the random draws are made for
the whole batch, so W processes compute what one process computes on the
global batch:

- every gradient is averaged over the ranks (``all_mean_``, one collective
  per backward) before it is clipped;
- a decision JAX takes on a global-batch value is taken on all ranks
  together: ``any_rank`` for the MDN losses' non-finite skip, the losses
  averaged (``mean_scalars``) before ``nan_guard``'s check and the logs.

Every loss of the three families is a mean over equal-size shards, so the
averaged gradients are JAX's global ones.  Nothing falls back: a process
group that does not start, or a collective that fails, raises.  Tensor
parallelism (``trainer.mesh_tp`` > 1, the JAX package's ``tp`` axis) is not
ported.
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


def init_from_env(device=None, mesh_dp: Optional[int] = None, mesh_tp: Optional[int] = 1
                  ) -> torch.device:
    """Join the process group that ``torchrun`` describes in the environment
    (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``/``PORT``), if
    any, and return this process's device: ``cuda:<LOCAL_RANK>`` (NCCL)
    unless ``device`` names the CPU (gloo).  ``mesh_dp``, when set, must be
    the world size; ``mesh_tp`` > 1 raises."""
    if mesh_tp not in (None, 1):
        raise NotImplementedError(
            f"trainer.mesh_tp={mesh_tp}: tensor parallelism is not ported (ROADMAP queue 1 "
            "keeps the tp axis open); the port trains data-parallel only")
    device = resolve_device(device)
    if "WORLD_SIZE" in os.environ:
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
            torch.cuda.set_device(device)
        if not dist.is_initialized():
            dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                    init_method="env://")
    if mesh_dp is not None and int(mesh_dp) != world_size():
        raise ValueError(f"trainer.mesh_dp={mesh_dp} but the job has {world_size()} "
                         "processes (torchrun --nproc_per_node)")
    return device


def local_rows(batch: int) -> Optional[slice]:
    """This rank's rows of a global batch of ``batch`` rows, or None in one
    process."""
    w = world_size()
    if w == 1:
        return None
    if batch % w:
        raise ValueError(f"the global batch {batch} does not split over {w} processes")
    per = batch // w
    return slice(rank() * per, (rank() + 1) * per)


def all_mean_(tensors: Sequence[Optional[torch.Tensor]]) -> None:
    """Average ``tensors`` (None skipped) over the ranks in place, in one
    collective."""
    ts = [t for t in tensors if t is not None]
    if world_size() == 1 or not ts:
        return
    flat = torch.cat([t.reshape(-1) for t in ts])
    dist.all_reduce(flat)
    flat /= world_size()
    off = 0
    for t in ts:
        n = t.numel()
        t.copy_(flat[off:off + n].view_as(t))
        off += n


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
