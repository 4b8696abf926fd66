"""Phoneme-based perceptual losses (JAX package ``losses/phoneme_loss.py``,
reference losses/phoneme_loss.py).

A frozen wav2vec2 CTC model (the port's own, ``nn/wav2vec2.py``) gives
phoneme logits of the estimate and of the target; the gradient flows
through the model into the estimate, never into the target's logits or the
model.  The model is not a submodule of any training model: it stays out of
``state_dict``, EMA, the optimizer and checkpoints, as the JAX package keeps
the Flax model out of its param tree, and moves to its input's device on
first use.  Without ``model=`` the pretrained checkpoint is read from a
local directory or the local Hugging Face cache (``load_pretrained``).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from ..nn.snake import resample as _resample
from ..nn.wav2vec2 import DEFAULT_CHECKPOINT, load_pretrained

W2V_SR = 16000


class PhonemePredictor:
    """Frozen wav2vec2 CTC logits over a (B, T) or (B, T, C) waveform
    (channel 0), each row normalised to zero mean and unit (population)
    variance as the feature extractor does.

    ``model`` injects a ``nn/wav2vec2.py`` ``Wav2Vec2ForCTC`` (any size).
    The model is shared, not copied, by ``copy.deepcopy`` (a validation's
    copy of the training model holds the same frozen weights)."""

    def __init__(self, checkpoint: str = DEFAULT_CHECKPOINT, model=None):
        if model is None:
            model = load_pretrained(checkpoint)
        self.model = model.eval().requires_grad_(False)
        self.blank = self.model.config.pad_token_id
        self.sr = W2V_SR

    def __deepcopy__(self, memo):
        return self

    def __call__(self, waveform: torch.Tensor) -> torch.Tensor:
        if waveform.dim() == 3:
            waveform = waveform[:, :, 0]
        x = waveform.float()
        m = x.mean(-1, keepdim=True)
        v = x.var(-1, unbiased=False, keepdim=True)
        x = (x - m) / torch.sqrt(v + 1e-7)
        if self.model.lm_head.weight.device != x.device:
            self.model.to(x.device)
        return self.model(x)


def _maybe_resample(x: torch.Tensor, sr: int) -> torch.Tensor:
    if sr == W2V_SR:
        return x
    if x.dim() == 2:
        return _resample(x[:, :, None], sr, W2V_SR)[..., 0]
    return _resample(x, sr, W2V_SR)


def ctc_loss(logits: torch.Tensor, labels: torch.Tensor, label_lengths: torch.Tensor,
             blank: int) -> torch.Tensor:
    """The mean over rows of the CTC loss of (B, T, V) logits against
    blank-padded (B, S) labels, each divided by max(label length, 1), as a
    float32 scalar (JAX: ``optax.ctc_loss`` on unpadded logits).

    The log-softmax is float32, the CTC recursion float64: PyTorch's
    float32 ``ctc_loss`` backward is off a float64 reference by ~1e-4 of
    the largest gradient (optax's float32 one by ~1e-7); in float64 it is
    ~1e-7.  The recursion is over (T, S) per row, small beside the model."""
    b, t, _ = logits.shape
    logp = F.log_softmax(logits.float(), dim=-1).double().transpose(0, 1)
    label_lengths = label_lengths.to(device=logits.device, dtype=torch.long)
    loss = F.ctc_loss(logp, labels.to(device=logits.device, dtype=torch.long),
                      torch.full((b,), t, dtype=torch.long, device=logits.device),
                      label_lengths, blank=blank, reduction="none")
    return torch.mean(loss / label_lengths.clamp(min=1)).float()


class PhonemeEmbeddingLoss:
    """MSE between phoneme logits of estimate and target."""

    def __init__(self, checkpoint: str = DEFAULT_CHECKPOINT, sr: int = 16000,
                 loss: Optional[Callable] = None, model=None):
        self.sr = sr
        self.phoneme_predictor = PhonemePredictor(checkpoint, model=model)
        self.loss = loss or (lambda a, b: torch.mean(torch.square(a - b)))

    def __call__(self, input, target):
        li = self.phoneme_predictor(_maybe_resample(input, self.sr))
        with torch.no_grad():
            lt = self.phoneme_predictor(_maybe_resample(target, self.sr))
        return self.loss(li, lt)


class PhonemeLoss:
    """Frame-wise cross-entropy against the target's argmax phonemes."""

    def __init__(self, checkpoint: str = DEFAULT_CHECKPOINT, sr: int = 16000, model=None):
        self.sr = sr
        self.phoneme_predictor = PhonemePredictor(checkpoint, model=model)

    def __call__(self, input, target):
        li = self.phoneme_predictor(_maybe_resample(input, self.sr))
        with torch.no_grad():
            labels = self.phoneme_predictor(_maybe_resample(target, self.sr)).argmax(-1)
        nll = -torch.gather(F.log_softmax(li, dim=-1), -1, labels[..., None])
        return torch.mean(nll)


class PhonemeCTCLoss:
    """CTC loss on estimate logits vs the target's collapsed phoneme ids."""

    def __init__(self, checkpoint: str = DEFAULT_CHECKPOINT, sr: int = 16000, model=None):
        self.sr = sr
        self.phoneme_predictor = PhonemePredictor(checkpoint, model=model)
        self.blank = self.phoneme_predictor.blank

    @torch.no_grad()
    def _targets_to_ctc(self, target):
        """The target's argmax ids with repeats collapsed and blanks dropped,
        left-aligned in (B, max(max length, 1)) blank-padded labels, and
        their lengths."""
        ids = self.phoneme_predictor(_maybe_resample(target, self.sr)).argmax(-1)
        keep = torch.ones_like(ids, dtype=torch.bool)
        keep[:, 1:] = ids[:, 1:] != ids[:, :-1]
        keep &= ids != self.blank
        lengths = keep.sum(1)
        s = max(int(lengths.max()), 1)
        labels = torch.full((ids.shape[0], s), self.blank, dtype=torch.long, device=ids.device)
        rows, cols = keep.nonzero(as_tuple=True)
        labels[rows, keep.cumsum(1)[rows, cols] - 1] = ids[rows, cols]
        return labels, lengths

    def __call__(self, input, target):
        logits = self.phoneme_predictor(_maybe_resample(input, self.sr))
        labels, label_lengths = self._targets_to_ctc(target)
        return ctc_loss(logits, labels, label_lengths, self.blank)
