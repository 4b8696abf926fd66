"""Levenshtein phoneme similarity (JAX package ``metrics/lps.py``, reference
metrics/lps.py).

LPS = 1 - levenshtein(phonemes(est), phonemes(ref)) / len(phonemes(ref)),
the phonemes the CTC argmax decode of wav2vec2-lv-60-espeak-cv-ft (the
port's ``nn/wav2vec2.py``, read from a local checkpoint directory or the
local Hugging Face cache; nothing is downloaded).
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..data.audio import resample_audio
from ..nn.wav2vec2 import DEFAULT_CHECKPOINT, load_pretrained, resolve_checkpoint
from ..utils.device import resolve_device

WAV2VEC2_SR = 16000


class PhonemeDecoder:
    """CTC ids -> phoneme string, as ``transformers``'
    ``Wav2Vec2PhonemeCTCTokenizer(do_phonemize=False).batch_decode``: ids
    mapped through ``vocab.json`` (unknown ids to the unk token), repeats
    collapsed, the pad (blank) token and the word delimiter (if the
    tokenizer config names one) dropped, the rest, special tokens
    included, joined with spaces."""

    def __init__(self, vocab: Dict[str, int], pad_token: str = "<pad>",
                 unk_token: str = "<unk>", word_delimiter_token: Optional[str] = None):
        self.tokens = {i: t for t, i in vocab.items()}
        self.pad_token, self.unk_token = pad_token, unk_token
        self.word_delimiter_token = word_delimiter_token

    @classmethod
    def from_dir(cls, path: Path, pad_id: int) -> "PhonemeDecoder":
        if not (path / "vocab.json").is_file():
            raise FileNotFoundError(f"{path} has no vocab.json, which lps needs")
        vocab = json.loads((path / "vocab.json").read_text(encoding="utf-8"))
        cfg_path = path / "tokenizer_config.json"
        cfg = json.loads(cfg_path.read_text(encoding="utf-8")) if cfg_path.is_file() else {}

        def token(key, default):
            t = cfg.get(key, default)
            return t.get("content") if isinstance(t, dict) else t

        pad = next((t for t, i in vocab.items() if i == pad_id), "<pad>")
        return cls(vocab, token("pad_token", pad), token("unk_token", "<unk>"),
                   token("word_delimiter_token", None))

    def __call__(self, ids: Sequence[int]) -> str:
        toks = [self.tokens.get(int(i), self.unk_token) for i in ids]
        grouped = [t for j, t in enumerate(toks) if j == 0 or t != toks[j - 1]]
        drop = {self.pad_token, self.word_delimiter_token}
        return " ".join(t for t in grouped if t not in drop).strip()


class PhonemePredictor:
    """waveform (1-D, 16 kHz) -> phoneme string: the port's wav2vec2 CTC on
    the normalised waveform, argmax, ``PhonemeDecoder``.  Runs on the card
    unless ``device`` names another."""

    def __init__(self, checkpoint: str = DEFAULT_CHECKPOINT, device=None):
        path = resolve_checkpoint(checkpoint)
        self.device = resolve_device(device)
        self.model = load_pretrained(path).to(self.device)
        self.decoder = PhonemeDecoder.from_dir(path, self.model.config.pad_token_id)
        self.sr = WAV2VEC2_SR

    @torch.no_grad()
    def __call__(self, waveform) -> str:
        x = torch.as_tensor(np.asarray(waveform, np.float32), device=self.device).reshape(1, -1)
        x = (x - x.mean(-1, keepdim=True)) / torch.sqrt(x.var(-1, unbiased=False, keepdim=True)
                                                        + 1e-7)
        ids = self.model(x).argmax(-1)[0]
        return self.decoder(ids.cpu().tolist())


def levenshtein_distance(a: str, b: str) -> int:
    """Plain DP edit distance — fallback when python-Levenshtein is absent."""
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def _distance(a: str, b: str) -> int:
    try:
        from Levenshtein import distance
    except ImportError:
        return levenshtein_distance(a, b)
    return distance(a, b)


class LevenshteinPhonemeSimilarity:
    def __init__(self, sr: int = WAV2VEC2_SR, checkpoint: str = DEFAULT_CHECKPOINT,
                 predictor=None, device=None):
        """``predictor`` injects any waveform -> phoneme-string callable;
        the default is the wav2vec2 espeak CTC model on ``device`` (the
        card unless another is named)."""
        self.phoneme_predictor = predictor or PhonemePredictor(checkpoint, device=device)
        self.sr = sr

    def _maybe_resample(self, audio):
        pred_sr = getattr(self.phoneme_predictor, "sr", WAV2VEC2_SR)
        if self.sr != pred_sr:
            return resample_audio(np.asarray(audio), self.sr, pred_sr)
        return audio

    def __call__(self, sample, reference) -> float:
        sample = self._maybe_resample(sample)
        reference = self._maybe_resample(reference)
        sample_ph = self.phoneme_predictor(sample).replace(" ", "")
        ref_ph = self.phoneme_predictor(reference).replace(" ", "")
        return 1.0 - _distance(sample_ph, ref_ph) / len(ref_ph)
