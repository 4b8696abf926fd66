"""Audio file IO and CPU-side resampling (JAX package ``data/audio.py``).

WAV is read and written with scipy (PCM 8/16/32-bit and float on read,
16-bit PCM on write).  FLAC and MP3 need the JAX package's in-house codecs
(``data/codecs.py``), which are not ported yet: reading or writing them
raises and names the missing decoder or encoder.  Resampling is the
torchaudio-compatible windowed-sinc polyphase filter of ``nn/snake.py``.
"""
from __future__ import annotations

import math
from pathlib import Path
from typing import Tuple, Union

import numpy as np

from ..nn.snake import _sinc_kernel_np

_CODECS = {".flac": "FLAC", ".mp3": "MP3"}


def _no_codec(path: Path, what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{path.suffix} files need the {_CODECS[path.suffix.lower()]} {what} of "
        "data/codecs.py, which the PyTorch port does not have yet; send WAV")


def load_audio(path: Union[str, Path]) -> Tuple[np.ndarray, int]:
    """Returns (audio (channels, T) float32 in [-1, 1], sample_rate)."""
    path = Path(path)
    suffix = path.suffix.lower()
    if suffix in _CODECS:
        raise _no_codec(path, "decoder")
    if suffix != ".wav":
        raise ValueError(f"unsupported audio container {path.suffix!r}")
    from scipy.io import wavfile

    fs, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    data = data[None, :] if data.ndim == 1 else data.T
    return np.ascontiguousarray(data), int(fs)


def save_audio(path: Union[str, Path], audio: np.ndarray, fs: int):
    """audio: (channels, T) or (T,) float32, written as 16-bit PCM WAV."""
    path = Path(path)
    if path.suffix.lower() in _CODECS:
        raise _no_codec(path, "encoder")
    from scipy.io import wavfile

    audio = np.asarray(audio)
    if audio.ndim == 2:
        audio = audio.T  # scipy expects (T, C)
    pcm = np.clip(audio, -1.0, 1.0)
    wavfile.write(str(path), fs, (pcm * 32767.0).astype(np.int16))


def resample_audio(x: np.ndarray, orig_fs: int, new_fs: int) -> np.ndarray:
    """Polyphase sinc resample along the last axis."""
    if orig_fs == new_fs:
        return x
    kernel, width, orig, new = _sinc_kernel_np(orig_fs, new_fs)
    shape = x.shape
    xf = np.asarray(x, np.float32).reshape(-1, shape[-1])
    t = shape[-1]
    xp = np.pad(xf, ((0, 0), (width, width + orig)))
    n_frames = (xp.shape[-1] - kernel.shape[1]) // orig + 1
    idx = np.arange(kernel.shape[1])[None, :] + orig * np.arange(n_frames)[:, None]
    frames = xp[:, idx]  # (B, frames, taps)
    y = np.einsum("bft,pt->bfp", frames, kernel)  # (B, frames, phases)
    y = y.reshape(xf.shape[0], -1)
    target = int(math.ceil(new * t / orig))
    return y[:, :target].reshape(shape[:-1] + (target,)).astype(np.float32)
