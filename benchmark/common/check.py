"""The comparison that decides ``correct``: the plain reference, run in
float32 with TF32 off once the window has closed and the program's state is
freed, against what the timed path produced."""
from __future__ import annotations

import contextlib

import numpy as np
import torch


@contextlib.contextmanager
def full_float32():
    """TF32 off for cuBLAS and cuDNN, restored after."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def rel_err(got, want) -> float:
    """||got - want|| / ||want|| over one answer, in float64."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        return float("inf")
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def free_device():
    import gc

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
