"""Hand-written CUDA kernels for the hot compute paths.

Counterpart of the JAX package's ``ops/pallas``.  The kernels are ON by
default: an eligible call on a CUDA tensor launches the kernel, the same call
on a CPU tensor runs the kernel's plain PyTorch version.  ``enable(False)``
forces the unfused module chain everywhere.  The kernels have no backward, so
they engage only under ``inference_scope`` (entered by ``Universe.enhance``)
or while autograd is off (``torch.no_grad()``), and with autograd on only
where nothing they would compute needs a gradient (``ConvBlock._fused_eligible``).
"""
import torch

_STATE = {"enabled": True, "inference_depth": 0}


def enable(flag: bool = True) -> None:
    _STATE["enabled"] = bool(flag)


def enabled() -> bool:
    return _STATE["enabled"]


class inference_scope:
    """Marks the enclosed computation as inference-only."""

    def __enter__(self):
        _STATE["inference_depth"] += 1
        return self

    def __exit__(self, *exc):
        _STATE["inference_depth"] -= 1
        return False


def in_inference() -> bool:
    """True inside ``inference_scope`` or while autograd is off."""
    return _STATE["inference_depth"] > 0 or not torch.is_grad_enabled()
