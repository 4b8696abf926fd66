"""Data pipeline: paired clean/noisy folder dataset + bucketed loaders (the
port's own copy of the JAX package's ``data/dataset.py``, which is numpy
only; the reference's NoisyDataset/DataModule, datasets/static_dataset.py
and datamodule.py):

  * training batches have a fixed crop length, cut at random from each
    clip with a ``random.Random`` seeded per epoch (the same crops as the
    JAX package's for the same seed)
  * validation/test clips are padded up to 1 s length buckets
  * batches are numpy dicts {"noisy", "clean", "length", "key"} with
    (B, T, 1) channels-last waveforms; a background thread prefetches

The reference re-lists the noisy folder after computing the clean/noisy
intersection, silently overriding it (static_dataset.py:119) — we keep the
intersection (the fixed behavior) and log when the two differ.
"""
from __future__ import annotations

import logging
import math
import os
import queue
import random
import threading
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Union

import numpy as np

from .audio import AUDIO_EXTS, load_audio, resample_audio

log = logging.getLogger(__name__)


class NoisyDataset:
    def __init__(
        self,
        audio_path: Union[str, Path],
        audio_len: Optional[float] = 4.0,
        fs: int = 16000,
        split: Optional[str] = "train",
        noisy_folder: str = "noisy",
        clean_folder: Optional[str] = "clean",
    ):
        audio_path = Path(audio_path)
        if split is not None:
            audio_path = audio_path / split
        self.noisy_path = audio_path / noisy_folder
        if not self.noisy_path.exists():
            raise FileNotFoundError(f"{self.noisy_path} does not exist")

        noisy_files = sorted(
            f for f in os.listdir(self.noisy_path)
            if f.lower().endswith(AUDIO_EXTS))

        self.clean_path = audio_path / clean_folder if clean_folder else None
        self.clean_available = bool(self.clean_path and self.clean_path.exists())
        if self.clean_available:
            clean_files = set(os.listdir(self.clean_path))
            file_list = sorted(set(noisy_files) & clean_files)
            if not file_list:
                self.clean_available = False
                self.file_list = noisy_files
            else:
                if len(file_list) != len(noisy_files):
                    log.warning("%d noisy files lack a clean pair in %s",
                                len(noisy_files) - len(file_list), audio_path)
                self.file_list = file_list
        else:
            self.file_list = noisy_files

        self.audio_len = int(audio_len * fs) if audio_len is not None else None
        self.fs = fs
        self.split = split

    def __len__(self):
        return len(self.file_list)

    def _load(self, path: Path) -> np.ndarray:
        audio, fs = load_audio(path)
        if fs != self.fs:
            audio = resample_audio(audio, fs, self.fs)
        return audio  # (C, T)

    def __getitem__(self, idx: int, rng: Optional[random.Random] = None):
        name = self.file_list[idx]
        key = Path(name).stem
        noisy = self._load(self.noisy_path / name)
        clean = self._load(self.clean_path / name) if self.clean_available \
            else np.zeros_like(noisy)

        if self.split != "test" and self.audio_len is not None:
            ori = noisy.shape[-1]
            if ori < self.audio_len:
                rep = math.ceil(self.audio_len / ori)
                noisy = np.tile(noisy, rep)[..., : self.audio_len]
                clean = np.tile(clean, rep)[..., : self.audio_len]
            else:
                r = rng or random
                st = r.randint(0, ori - self.audio_len)
                noisy = noisy[..., st : st + self.audio_len]
                clean = clean[..., st : st + self.audio_len]
        return noisy, clean, key


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def collate(rows, bucket_quantum: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Zero-pad to the longest clip (optionally rounded up to a bucket)."""
    max_len = max(r[0].shape[-1] for r in rows)
    if bucket_quantum:
        max_len = _round_up(max_len, bucket_quantum)
    noisy = np.zeros((len(rows), max_len, 1), np.float32)
    clean = np.zeros((len(rows), max_len, 1), np.float32)
    lengths = np.zeros((len(rows),), np.int32)
    keys = []
    for i, (n, c, k) in enumerate(rows):
        t = n.shape[-1]
        noisy[i, :t, 0] = n[0]
        clean[i, :t, 0] = c[0]
        lengths[i] = t
        keys.append(k)
    return {"noisy": noisy, "clean": clean, "length": lengths, "key": keys}


class DataLoader:
    def __init__(self, dataset: NoisyDataset, batch_size: int = 1,
                 shuffle: bool = False, seed: int = 0, drop_last: bool = False,
                 bucket_quantum: Optional[int] = None, prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.bucket_quantum = bucket_quantum
        self.prefetch = prefetch
        self.epoch = 0

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _index_batches(self) -> List[List[int]]:
        idx = list(range(len(self.dataset)))
        if self.shuffle:
            random.Random(self.seed + self.epoch).shuffle(idx)
        batches = [idx[i : i + self.batch_size]
                   for i in range(0, len(idx), self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        return batches

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        rng = random.Random(self.seed * 7919 + self.epoch)
        batches = self._index_batches()
        self.epoch += 1

        stop = threading.Event()

        def _put(q, item) -> bool:
            # bounded put that gives up when the consumer abandoned the
            # iterator (validation breaks out at max_val_batches every pass;
            # a plain q.put would strand this thread + its batches forever)
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def produce(q: queue.Queue):
            try:
                for b in batches:
                    rows = [self.dataset.__getitem__(i, rng=rng) for i in b]
                    if not _put(q, (collate(rows, self.bucket_quantum), None)):
                        return
            except BaseException as e:  # propagate, don't truncate the epoch
                _put(q, (None, e))
            else:
                _put(q, (None, None))

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        t = threading.Thread(target=produce, args=(q,), daemon=True)
        t.start()
        try:
            while True:
                item, err = q.get()
                if err is not None:
                    raise err
                if item is None:
                    return
                yield item
        finally:
            stop.set()  # GeneratorExit from an abandoned iterator lands here


class DataModule:
    """train/val/test loaders from the reference's datamodule config shape."""

    def __init__(self, train, val, test, datasets):
        self.cfg = {"train": train, "val": val, "test": test}
        self.datasets_cfg = datasets
        self.datasets: Dict[str, NoisyDataset] = {}

    def setup(self, splits: Sequence[str] = ("train", "val", "test")):
        from ..configs.registry import instantiate

        for split in splits:
            name = self.cfg[split]["dataset"]
            self.datasets[split] = instantiate(self.datasets_cfg[name])

    def _loader(self, split: str) -> DataLoader:
        if split not in self.datasets:
            self.setup((split,))  # a split's folder is needed only when it is read
        opts = dict(self.cfg[split].get("dl_opts", {}))
        ds = self.datasets[split]
        bucket = None if split == "train" else ds.fs  # 1-second buckets
        return DataLoader(
            ds,
            batch_size=opts.get("batch_size", 1),
            shuffle=opts.get("shuffle", split == "train"),
            drop_last=split == "train",
            bucket_quantum=bucket,
        )

    def train_dataloader(self):
        return self._loader("train")

    def val_dataloader(self):
        return self._loader("val")

    def test_dataloader(self):
        return self._loader("test")
