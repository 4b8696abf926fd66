"""Builds the port's CUDA sources (``csrc/*.cu``) at first use.

Each source compiles with ``nvcc`` into a shared library with a plain C
interface, loaded with ``ctypes``; ``build`` starts one ``nvcc`` per source,
all at once.  Libraries go to ``_build/`` inside the package (git-ignored),
named by a hash of the source and the flags, so an edited source builds
anew and an unchanged one is reused.  A failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return path


def library_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(*names: str) -> List[Path]:
    """Compile each ``csrc/<name>.cu`` whose library does not exist, one
    ``nvcc`` per source, all running at once; the libraries' paths."""
    outs = [library_path(name) for name in names]
    todo = [(name, out) for name, out in zip(names, outs) if not out.exists()]
    if not todo:
        return outs
    compiler = nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = []
    for name, out in todo:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        with open(out.with_suffix(".log"), "w") as log:  # the child keeps its copy
            proc = subprocess.Popen(
                [compiler, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")],
                stdout=log, stderr=subprocess.STDOUT)
        running.append((name, out, tmp, proc))
    failed = []
    for name, out, tmp, proc in running:
        rc = proc.wait()
        if rc != 0:
            failed.append(f"kernel build failed: {name}: nvcc exit {rc}\n"
                          + out.with_suffix(".log").read_text())
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def build_log(name: str) -> str:
    """The compiler's output (registers, shared memory, spills)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = _LIBS[name] = ctypes.CDLL(str(build(name)[0]))
        return lib
