"""Native (C++) host-side components, loaded via ctypes (the PyTorch
port's own copy of the JAX package's ``native/``).

The FLAC codec of the audio IO (the reference reads FLAC through
torchaudio's C++ codecs, reference open_universe/bin/enhance.py:173-178) is
C++ with a plain C ABI, built on demand with the system toolchain and
loaded through ctypes.  It is file IO on the host and never touches the
device.  Every native entry point has a pure-Python fallback
(``data/codecs.py``), and tests assert the two agree sample-for-sample.

Build model: sources compile lazily into
``open_universe_tpu_torch/_build/<name>-<srchash>.so`` the first time they
are needed (``g++ -O2 -shared -fPIC``); the hash key makes stale binaries
impossible and concurrent builds race-free (build to a tmp file, atomic
rename).  Without a compiler, or when the build fails, the Python
fallbacks are used.
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

log = logging.getLogger(__name__)

_HERE = Path(__file__).parent
_BUILD = _HERE.parent / "_build"

_flac_lib = None
_flac_failed = False


def _build_shared(src: Path, name: str) -> Path:
    """Compile ``src`` into a content-addressed .so, reusing a prior build."""
    srchash = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    out = _BUILD / f"{name}-{srchash}.so"
    if out.exists():
        return out
    _BUILD.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
    os.close(fd)
    try:
        subprocess.run(
            ["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
             str(src), "-o", tmp],
            check=True, capture_output=True, text=True)
        os.replace(tmp, out)  # atomic: concurrent builds both succeed
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return out


def get_flac_lib() -> Optional[ctypes.CDLL]:
    """The native FLAC codec, or None if it cannot be built."""
    global _flac_lib, _flac_failed
    if _flac_failed:
        return None
    if _flac_lib is None:
        try:
            so = _build_shared(_HERE / "flac_native.cpp", "flac_native")
            lib = ctypes.CDLL(str(so))
            lib.ou_flac_decode.restype = ctypes.c_int
            lib.ou_flac_decode.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.c_char_p, ctypes.c_size_t]
            lib.ou_flac_encode.restype = ctypes.c_int
            lib.ou_flac_encode.argtypes = [
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
                ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_int32,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
                ctypes.POINTER(ctypes.c_size_t),
                ctypes.c_char_p, ctypes.c_size_t]
            lib.ou_free.restype = None
            lib.ou_free.argtypes = [ctypes.c_void_p]
            _flac_lib = lib
        except (subprocess.CalledProcessError, OSError, FileNotFoundError) as e:
            detail = getattr(e, "stderr", "") or str(e)
            log.warning("native FLAC unavailable, using Python fallback: %s",
                        str(detail)[:500])
            _flac_failed = True
            return None
    return _flac_lib


def flac_decode_native(data: bytes) -> Tuple[np.ndarray, int, int]:
    """Decode FLAC bytes -> (samples int32 (channels, T), rate, bps).

    Raises ValueError on malformed input.  The pure-Python parser rejects
    the same streams but surfaces mixed exception types internally
    (EOFError/KeyError/...); ``data.codecs.decode_flac`` normalizes both
    paths to ValueError — use that entry point for a decoder-independent
    contract.
    """
    lib = get_flac_lib()
    if lib is None:
        raise RuntimeError("native FLAC codec not available")
    out = ctypes.POINTER(ctypes.c_int32)()
    nch = ctypes.c_int32(0)
    nsamp = ctypes.c_int64(0)
    rate = ctypes.c_int32(0)
    bps = ctypes.c_int32(0)
    err = ctypes.create_string_buffer(512)
    rc = lib.ou_flac_decode(data, len(data), ctypes.byref(out),
                            ctypes.byref(nch), ctypes.byref(nsamp),
                            ctypes.byref(rate), ctypes.byref(bps),
                            err, len(err))
    if rc != 0:
        raise ValueError(err.value.decode(errors="replace"))
    try:
        n = nch.value * nsamp.value
        samples = np.ctypeslib.as_array(out, shape=(max(n, 1),))[:n]
        samples = samples.reshape(nch.value, nsamp.value).copy()
    finally:
        lib.ou_free(out)
    return samples, int(rate.value), int(bps.value)


_STEREO_MODES = {"independent": 0, "left_side": 1, "right_side": 2,
                 "mid_side": 3}


def flac_encode_native(samples: np.ndarray, fs: int, bps: int,
                       block_size: int, stereo_mode: str) -> bytes:
    """Encode planar int samples (channels, T) -> FLAC bytes."""
    lib = get_flac_lib()
    if lib is None:
        raise RuntimeError("native FLAC codec not available")
    samples = np.ascontiguousarray(samples, dtype=np.int32)
    nch, t = samples.shape
    out = ctypes.POINTER(ctypes.c_uint8)()
    outlen = ctypes.c_size_t(0)
    err = ctypes.create_string_buffer(512)
    rc = lib.ou_flac_encode(
        samples.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        nch, t, fs, bps, block_size, _STEREO_MODES[stereo_mode],
        ctypes.byref(out), ctypes.byref(outlen), err, len(err))
    if rc != 0:
        raise ValueError(err.value.decode(errors="replace"))
    try:
        data = ctypes.string_at(out, outlen.value)
    finally:
        lib.ou_free(out)
    return data
