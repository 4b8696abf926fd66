"""open-universe-tpu-torch: the PyTorch/CUDA port of open-universe-tpu.

UNIVERSE / UNIVERSE++ speech enhancement and UNIVERSE++ training in
PyTorch, with the JAX package's
Pallas kernel rewritten as a hand-written CUDA kernel for Hopper (sm_90a).
The port imports nothing of JAX or of ``open_universe_tpu``.  Entry points
run on CUDA unless the caller passes ``device="cpu"``.
"""
__version__ = "0.1.0"

_SUBMODULES = ("bin", "configs", "data", "inference", "models", "native", "nn",
               "ops", "train", "utils")


def __getattr__(name):
    if name in _SUBMODULES:
        import importlib

        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_SUBMODULES))
