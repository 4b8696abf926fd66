"""The program under test, as users run it: its kernels built (or reused
from its build directory inside the checkout), a checkpoint loaded through
its ``load_model``, which applies the EMA shadow and folds weight norm; and
the faults the tests plant underneath the timed path."""
from __future__ import annotations

import collections
import tempfile

import torch

from . import weights


def build_kernels(device: str) -> None:
    if device != "cuda":
        return
    from open_universe_tpu_torch.ops.kernels import build, conv_block

    build.build(*sorted({source for _, source, _ in conv_block.ROUTES.values()}))


def load(cfg: dict, state, shadow, device: str):
    """Write the drawn weights as a reference-layout checkpoint under TMPDIR
    and load it as a user does."""
    from open_universe_tpu_torch.inference.model_loader import load_model

    with tempfile.TemporaryDirectory() as d:
        return load_model(weights.write_checkpoint(d, cfg, state, shadow), device=device)


def launches() -> collections.Counter:
    """A copy of the kernel wrapper's launch counts."""
    from open_universe_tpu_torch.ops.kernels import conv_block

    return collections.Counter(conv_block.launches)


FAULTS = ("unchanged", "half_batch", "altered")


def plant(model, fault: str) -> None:
    """Break ``model.enhance`` underneath the timed path:
    unchanged     it returns its input, as a step that leaves its state;
    half_batch    it enhances the first half of the rows and gives the rest
                  their mean;
    altered       every answer has 1000 samples zeroed where it is made."""
    if fault not in FAULTS:
        raise ValueError(f"fault must be one of {FAULTS}")
    inner = model.enhance

    def broken(mix, *args, **kwargs):
        if fault == "unchanged":
            return torch.as_tensor(mix, device=next(model.parameters()).device).float()
        out = inner(mix, *args, **kwargs)
        if fault == "half_batch":
            keep = max(1, out.shape[0] // 2)
            out = out.clone()
            out[keep:] = out[:keep].mean(dim=0, keepdim=True)
        else:
            out = out.clone()
            mid = out.shape[1] // 2
            out[:, mid: mid + 1000] = 0
        return out

    model.enhance = broken
