"""Audio file IO and CPU-side resampling (JAX package ``data/audio.py``).

WAV is read and written with scipy (PCM 8/16/32-bit and float on read,
16-bit PCM on write), MP3 through ctypes libmpg123/libmp3lame and FLAC
through the port's own codec (``data/codecs.py``, native C++ with a Python
fallback); anything else (.ogg) needs the optional ``soundfile`` package.
``audio_info`` reads lengths, rates and channels from headers only.
Resampling is the torchaudio-compatible windowed-sinc polyphase filter of
``nn/snake.py``.
"""
from __future__ import annotations

import math
from pathlib import Path
from typing import Tuple, Union

import numpy as np

from ..nn.snake import _sinc_kernel_np

AUDIO_EXTS = (".wav", ".flac", ".mp3", ".ogg")


def load_audio(path: Union[str, Path]) -> Tuple[np.ndarray, int]:
    """Returns (audio (channels, T) float32 in [-1, 1], sample_rate)."""
    path = Path(path)
    if path.suffix.lower() == ".wav":
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
        if data.ndim == 1:
            data = data[None, :]
        else:
            data = data.T
        return np.ascontiguousarray(data), int(fs)
    if path.suffix.lower() == ".mp3":
        from .codecs import decode_mp3

        return decode_mp3(path)
    if path.suffix.lower() == ".flac":
        from .codecs import decode_flac

        return decode_flac(path)
    try:
        import soundfile as sf
    except ImportError as e:  # pragma: no cover
        raise RuntimeError(
            f"reading {path.suffix} requires the optional 'soundfile' package"
        ) from e
    data, fs = sf.read(path, dtype="float32", always_2d=True)
    return np.ascontiguousarray(data.T), int(fs)


def audio_duration(path: Union[str, Path]) -> Tuple[int, int]:
    """Returns (n_samples, sample_rate); see audio_info."""
    n, fs, _ = audio_info(path)
    return n, fs


def audio_info(path: Union[str, Path]) -> Tuple[int, int, int]:
    """Returns (n_samples, sample_rate, n_channels) from container headers
    only — no decode.  wav: RIFF fmt/data chunk walk; flac: STREAMINFO.
    mp3 (and anything else) falls back to a full decode (frame-header
    walking would misreport VBR streams without a Xing header)."""
    path = Path(path)
    suffix = path.suffix.lower()
    if suffix == ".wav":
        import struct

        with open(path, "rb") as f:
            riff = f.read(12)
            if len(riff) < 12 or riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
                raise ValueError(f"{path} is not a RIFF/WAVE file")
            fs = None
            block_align = None
            channels = 1
            while True:
                hdr = f.read(8)
                if len(hdr) < 8:
                    break
                cid, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
                if cid == b"fmt ":
                    fmt = f.read(size + (size & 1))
                    channels = struct.unpack("<H", fmt[2:4])[0] or 1
                    fs = struct.unpack("<I", fmt[4:8])[0]
                    block_align = struct.unpack("<H", fmt[12:14])[0]
                elif cid == b"data":
                    if fs is None or not block_align:
                        raise ValueError(f"{path}: data chunk before fmt")
                    return size // block_align, int(fs), int(channels)
                else:
                    f.seek(size + (size & 1), 1)
        raise ValueError(f"{path}: no data chunk found")
    if suffix == ".flac":
        with open(path, "rb") as f:
            if f.read(4) != b"fLaC":
                raise ValueError(f"{path} is not a FLAC file")
            while True:
                hdr = f.read(4)
                if len(hdr) < 4:
                    raise ValueError(f"{path}: missing STREAMINFO")
                last, btype = hdr[0] & 0x80, hdr[0] & 0x7F
                size = int.from_bytes(hdr[1:4], "big")
                body = f.read(size)
                if btype == 0:  # STREAMINFO
                    bits = int.from_bytes(body[10:18], "big")
                    fs = (bits >> 44) & 0xFFFFF
                    channels = ((bits >> 41) & 0x7) + 1
                    total = bits & ((1 << 36) - 1)
                    if total:
                        return int(total), int(fs), int(channels)
                    break  # unknown length: decode
                if last:
                    break
    audio, fs = load_audio(path)
    return int(audio.shape[-1]), int(fs), int(audio.shape[0])


def save_audio(path: Union[str, Path], audio: np.ndarray, fs: int):
    """audio: (channels, T) or (T,) float32. Container chosen by suffix."""
    path = Path(path)
    audio = np.asarray(audio)
    if path.suffix.lower() == ".mp3":
        from .codecs import encode_mp3

        encode_mp3(path, np.clip(audio, -1.0, 1.0), fs)
        return
    if path.suffix.lower() == ".flac":
        from .codecs import encode_flac

        encode_flac(path, np.clip(audio, -1.0, 1.0), fs)
        return
    from scipy.io import wavfile

    if audio.ndim == 2:
        audio = audio.T  # scipy expects (T, C)
    pcm = np.clip(audio, -1.0, 1.0)
    wavfile.write(str(path), fs, (pcm * 32767.0).astype(np.int16))


def resample_audio(x: np.ndarray, orig_fs: int, new_fs: int) -> np.ndarray:
    """Polyphase sinc resample along the last axis (numpy, float64 kernel)."""
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
