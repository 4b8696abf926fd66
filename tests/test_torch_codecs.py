"""The PyTorch port's audio codecs (``data/codecs.py``, ``native/``) and
container dispatch (``data/audio.py``) on the CPU, against the JAX
package's.

FLAC is lossless, so everything here is bit-exact: round trips through the
native and the Python codec, each decoding the other's stream, and files
written by the JAX package's codec decoded by the port's and the other way
round.  MP3 (ctypes libmpg123/libmp3lame, skipped where they do not load)
is lossy and held for rate, channels and length.  ``audio_info`` reads the
same length, rate and channels from headers as a full decode.
"""
import ctypes

import numpy as np
import pytest

from open_universe_tpu.data import audio as jax_audio
from open_universe_tpu_torch import native
from open_universe_tpu_torch.data import audio, codecs


def mp3_libraries() -> bool:
    """Whether libmpg123 and libmp3lame load here."""
    try:
        ctypes.CDLL("libmpg123.so.0")
        ctypes.CDLL("libmp3lame.so.0")
    except OSError:
        return False
    return True


def _tone(fs, seconds, channels=1, seed=0):
    t = np.arange(int(fs * seconds)) / fs
    rng = np.random.default_rng(seed)
    x = np.stack([0.5 * np.sin(2 * np.pi * (440 + 50 * c) * t)
                  + 0.01 * rng.standard_normal(len(t)) for c in range(channels)])
    return x.astype(np.float32)


def _quantize(x, bps=16):
    scale = float(1 << (bps - 1))
    return np.clip(np.round(x * scale), -scale, scale - 1) / scale


@pytest.fixture
def python_codec(monkeypatch):
    """Route encode_flac/decode_flac through the pure-Python fallback."""
    monkeypatch.setattr(native, "_flac_failed", True)


@pytest.mark.parametrize("codec", ["native", "python"])
@pytest.mark.parametrize("channels,mode,bps", [
    (1, "independent", 16), (2, "left_side", 16), (2, "mid_side", 16),
    (2, "right_side", 24), (2, "independent", 8),
])
def test_flac_round_trip_is_bit_exact(tmp_path, monkeypatch, codec, channels,
                                      mode, bps):
    if codec == "native":
        assert native.get_flac_lib() is not None, "the native codec did not build"
    else:
        monkeypatch.setattr(native, "_flac_failed", True)
    x = _tone(16000, 0.3, channels)
    path = tmp_path / "a.flac"
    codecs.encode_flac(path, x, 16000, bps=bps, stereo_mode=mode)
    y, fs = codecs.decode_flac(path)
    assert fs == 16000 and y.shape == x.shape
    np.testing.assert_array_equal(y, _quantize(x, bps).astype(np.float32))


@pytest.mark.parametrize("mode", ["independent", "mid_side"])
def test_native_and_python_decode_each_other(tmp_path, monkeypatch, mode):
    x = _tone(22050, 0.25, 2, seed=1)
    want = np.round(_quantize(x) * 32768).astype(np.int64)
    nat = native.flac_encode_native(want.astype(np.int32), 22050, 16, 4096, mode)
    py_path = tmp_path / "py.flac"
    with monkeypatch.context() as m:
        m.setattr(native, "_flac_failed", True)
        codecs.encode_flac(py_path, x, 22050, stereo_mode=mode)
    for blob in (nat, py_path.read_bytes()):
        samples, rate, bps = native.flac_decode_native(blob)
        py, py_rate = codecs._decode_flac_python(blob)
        assert rate == py_rate == 22050 and bps == 16
        np.testing.assert_array_equal(samples, want)
        np.testing.assert_array_equal(np.round(py * 32768).astype(np.int64), want)


@pytest.mark.parametrize("channels", [1, 2])
def test_flac_files_cross_between_the_packages(tmp_path, channels):
    """A file the JAX package writes decodes in the port to the same
    samples, and the other way round."""
    x = _tone(44100, 0.2, channels, seed=2)
    jax_audio.save_audio(tmp_path / "jax.flac", x, 44100)
    audio.save_audio(tmp_path / "port.flac", x, 44100)
    assert (tmp_path / "jax.flac").read_bytes() == (tmp_path / "port.flac").read_bytes()
    for name in ("jax.flac", "port.flac"):
        y_port, fs_port = audio.load_audio(tmp_path / name)
        y_jax, fs_jax = jax_audio.load_audio(tmp_path / name)
        assert fs_port == fs_jax == 44100
        np.testing.assert_array_equal(y_port, y_jax)
        np.testing.assert_array_equal(y_port, _quantize(x).reshape(y_port.shape))


def test_malformed_flac_raises_value_error(tmp_path, python_codec):
    (tmp_path / "bad.flac").write_bytes(b"fLaC" + bytes(64))
    with pytest.raises(ValueError):
        codecs.decode_flac(tmp_path / "bad.flac")


def test_mp3_round_trip(tmp_path):
    if not mp3_libraries():
        pytest.skip("libmpg123 or libmp3lame does not load here")
    x = _tone(16000, 0.5, 2, seed=3)
    audio.save_audio(tmp_path / "a.mp3", x, 16000)
    y, fs = audio.load_audio(tmp_path / "a.mp3")
    y_jax, fs_jax = jax_audio.load_audio(tmp_path / "a.mp3")
    assert fs == fs_jax == 16000 and y.shape[0] == 2 and y.shape[1] >= x.shape[1]
    np.testing.assert_array_equal(y, y_jax)
    assert audio.audio_info(tmp_path / "a.mp3") == (y.shape[1], 16000, 2)


@pytest.mark.parametrize("name,fs,channels", [
    ("a.wav", 16000, 1), ("b.wav", 24000, 2), ("c.flac", 44100, 2), ("d.flac", 8000, 1),
])
def test_audio_info_reads_headers(tmp_path, name, fs, channels):
    x = _tone(fs, 0.11, channels, seed=4)
    audio.save_audio(tmp_path / name, x, fs)
    y, got_fs = audio.load_audio(tmp_path / name)
    want = (y.shape[1], got_fs, y.shape[0])
    assert want == (x.shape[1], fs, channels)
    assert audio.audio_info(tmp_path / name) == want
    assert audio.audio_duration(tmp_path / name) == want[:2]
    assert jax_audio.audio_info(tmp_path / name) == want
