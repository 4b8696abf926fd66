"""Word error rate with wildcard support (reference metrics/wer.py; the
port's copy of the JAX package's ``metrics/wer.py``).

A wildcard token (e.g. "<ignore/>") absorbs any number of missing or extra
words at its location, useful for scoring ASR on partially-known transcripts.
Whisper-style text normalization is used when the optional
``whisper_normalizer`` package is available; otherwise a simple
lowercase+strip-punctuation normalizer is applied.
"""
from __future__ import annotations

import re
import string
from typing import Dict, List, Optional, Tuple

_PUNCT = re.compile("[" + re.escape(string.punctuation) + "]")


def _simple_clean(text: str) -> str:
    return _PUNCT.sub("", text.lower())


def _get_cleaner(style: str):
    if style == "whisper":
        try:
            from whisper_normalizer.english import EnglishTextNormalizer

            return EnglishTextNormalizer()
        except ImportError:
            return _simple_clean
    return _simple_clean


def normalize_sentence(sentence, wildcard: Optional[str] = None,
                       style: str = "whisper") -> List[Optional[str]]:
    """Lowercase, strip punctuation, split into words; wildcard -> None."""
    cleaner = _get_cleaner(style)
    if isinstance(sentence, list):
        sentence = " ".join(sentence)
    sentence = sentence.lower()
    if wildcard is not None:
        parts = [cleaner(p) for p in sentence.split(wildcard.lower())]
    else:
        parts = [cleaner(sentence)]
    words: List[Optional[str]] = []
    for part in parts:
        words += part.split()
        words.append(None)
    words.pop()
    return words


def word_edit_distance(sentence1, sentence2,
                       wildcard: Optional[str] = None) -> Tuple[int, int, int]:
    """Levenshtein word distance; wildcards match any number of words.

    Returns (distance, n_words_s1, n_words_s2), wildcards excluded from the
    word counts.
    """
    s1 = normalize_sentence(sentence1, wildcard=wildcard)
    s2 = normalize_sentence(sentence2, wildcard=wildcard)
    n1 = sum(w is not None for w in s1)
    n2 = sum(w is not None for w in s2)
    if not s1:
        return n2, n1, n2
    if not s2:
        return n1, n1, n2

    m, n = len(s1), len(s2)
    dist = [[0] * (n + 1) for _ in range(m + 1)]
    for i in range(1, m + 1):
        dist[i][0] = dist[i - 1][0] + (s1[i - 1] is not None)
    for j in range(1, n + 1):
        dist[0][j] = dist[0][j - 1] + (s2[j - 1] is not None)
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            if s1[i - 1] is None or s2[j - 1] is None:
                dist[i][j] = min(dist[i - 1][j], dist[i][j - 1])
            elif s1[i - 1] == s2[j - 1]:
                dist[i][j] = dist[i - 1][j - 1]
            else:
                dist[i][j] = 1 + min(dist[i - 1][j], dist[i][j - 1],
                                     dist[i - 1][j - 1])
    return dist[m][n], n1, n2


def wer(ref: List[str], hyp: List[str], wildcard: Optional[str] = None) -> float:
    """Corpus word error rate over paired (reference, hypothesis) sentences."""
    total_dist = 0
    total_words = 0
    for r, h in zip(ref, hyp):
        d, n_ref, _ = word_edit_distance(r, h, wildcard=wildcard)
        total_dist += d
        total_words += n_ref
    return total_dist / max(total_words, 1)
