"""Batch speech enhancement CLI (JAX package ``bin/enhance.py``; reference
bin/enhance.py).

    python -m open_universe_tpu_torch.bin.enhance input/ output/ \
        [--model line-corporation/open-universe:plusplus] [--device cuda|cpu] \
        [--n_steps 8 --epsilon 1.3 --ensemble N --warm_start K ...]

Enhances a file or a folder tree (structure preserved) of wav, flac, mp3
(and ogg with ``soundfile``) files, resampling to and from the model rate;
wav, flac and mp3 outputs keep their container, anything else is written as
wav.  Every channel of a file is one batch row, and a file is written once
all its channels are done.  Rows are grouped into length buckets of
``--bucket-seconds`` and enhanced ``--batch-size`` at a time; a bucket's
last batch is not padded to ``--batch-size`` rows, since no row's output
depends on the rows beside it.  ``--chunk-seconds`` instead enhances each
file in fixed chunks with overlap-add (``inference/chunked.py``).  Every
int, float, str and bool argument of ``model.enhance`` is a flag.  The
sampler noise comes from one ``torch.Generator`` on the device, seeded by
``--seed``, in batch order.  The model runs on CUDA unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..data.audio import (
    AUDIO_EXTS,
    audio_info,
    load_audio,
    resample_audio,
    save_audio,
)
from ..inference.model_loader import DEFAULT_MODEL, load_model
from ..inference.signature_to_parser import parse_with_enhance_args

DEFAULT_SEED = 1028282  # reference bin/enhance.py:112

_WRITABLE_EXTS = (".wav", ".mp3", ".flac")


def _out_suffix(out_path: Path) -> Path:
    """Keep the input container where it can be encoded (reference
    bin/enhance.py:192 writes with the original suffix); otherwise wav."""
    if out_path.suffix.lower() in _WRITABLE_EXTS:
        return out_path
    return out_path.with_suffix(".wav")


def find_files(input_path: Path):
    """(files, the root their output paths are relative to, is a tree)."""
    if input_path.is_dir():
        files = sorted(p for p in input_path.rglob("*")
                       if p.suffix.lower() in AUDIO_EXTS)
        return files, input_path, True
    return [input_path], input_path.parent, False


def _bucket(files, fs_model, batch_size, quantum):
    """Group (path, channel) rows into (bucket_len, [(path, ch), ...])
    batches of one padded length; a stereo file gives two rows.  Lengths
    come from headers (``audio_info``), not from a decode."""
    infos = []
    for p in files:
        n, fs, n_ch = audio_info(p)
        t_model = int(np.ceil(n * fs_model / fs))
        bucket = int(np.ceil(t_model / quantum)) * quantum
        for c in range(n_ch):
            infos.append((bucket, p, c))
    infos.sort(key=lambda x: (x[0], str(x[1]), x[2]))
    batches = []
    i = 0
    while i < len(infos):
        bucket = infos[i][0]
        group = []
        while (i < len(infos) and infos[i][0] == bucket
               and len(group) < batch_size):
            group.append((infos[i][1], infos[i][2]))
            i += 1
        batches.append((bucket, group))
    return batches


def _out_path(args, path: Path, rel_path: Path, dir_proc: bool) -> Path:
    if dir_proc:
        out_path = args.output / path.relative_to(rel_path)
    else:
        out_path = args.output / path.name if args.output.is_dir() else args.output
    out_path.parent.mkdir(exist_ok=True, parents=True)
    return _out_suffix(out_path)


def _write(out_path: Path, out: np.ndarray, fs: int, fs_model: int):
    """(channels, T) at the model rate -> the file, at its own rate."""
    if fs != fs_model:
        out = resample_audio(out, fs_model, fs)
    save_audio(out_path, out[0] if out.shape[0] == 1 else out, fs)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Enhance a file or a directory of audio files")
    parser.add_argument("input", type=Path)
    parser.add_argument("output", type=Path)
    parser.add_argument("--model", type=str, default=DEFAULT_MODEL)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("--seed", type=int, default=DEFAULT_SEED)
    parser.add_argument("--batch-size", type=int, default=8,
                        help="rows enhanced per call (per bucket)")
    parser.add_argument("--bucket-seconds", type=float, default=1.0,
                        help="length-bucket quantum for batching")
    parser.add_argument("--chunk-seconds", type=float, default=None,
                        help="enhance each file in fixed chunks of this many "
                        "seconds with 25%% overlap-add crossfade (for long "
                        "recordings)")
    args, model, enhance_kwargs = parse_with_enhance_args(
        parser, sys.argv[1:] if argv is None else argv, load_model)

    files, rel_path, dir_proc = find_files(args.input)
    if not files:
        print(f"no audio files found under {args.input}", file=sys.stderr)
        return 1
    device = next(model.parameters()).device
    generator = torch.Generator(device=device).manual_seed(args.seed)
    fs_model = model.fs
    n_done = 0
    total_audio = 0.0
    t0 = time.perf_counter()

    if args.chunk_seconds is not None:
        from ..inference.chunked import make_chunked_enhancer

        enhancer = make_chunked_enhancer(
            model, chunk_seconds=args.chunk_seconds, max_batch=args.batch_size,
            **enhance_kwargs)
        for path in files:
            audio, fs = load_audio(path)
            if fs != fs_model:
                audio = resample_audio(audio, fs, fs_model)
            # every channel is enhanced and the file keeps its channels
            out = np.stack([enhancer(ch, generator=generator) for ch in audio])
            total_audio += out.size / fs_model
            _write(_out_path(args, path, rel_path, dir_proc), out, fs, fs_model)
            n_done += 1
            print(f"[{n_done}/{len(files)}] {path.name}", file=sys.stderr)
    else:
        quantum = int(args.bucket_seconds * fs_model)
        # the channels of a file may be split across batches: keep its
        # enhanced channels until the last one is done
        pending, loaded = {}, {}

        def _load(path):
            if path not in loaded:
                audio, fs = load_audio(path)
                if fs != fs_model:
                    audio = resample_audio(audio, fs, fs_model)
                loaded[path] = (audio, fs)
            return loaded[path]

        for bucket_len, group in _bucket(files, fs_model, args.batch_size, quantum):
            batch = np.zeros((len(group), bucket_len), np.float32)
            for i, (path, ch) in enumerate(group):
                m = _load(path)[0][ch]
                batch[i, :len(m)] = m
            enh = model.enhance(torch.from_numpy(batch), generator=generator,
                                **enhance_kwargs).float().cpu().numpy()

            for i, (path, ch) in enumerate(group):
                audio, fs = _load(path)
                n_ch, length = audio.shape
                total_audio += length / fs_model
                slot = pending.setdefault(path, {})
                slot[ch] = enh[i, :length]
                if len(slot) < n_ch:
                    continue
                out = np.stack([slot[c] for c in range(n_ch)])
                del pending[path], loaded[path]
                _write(_out_path(args, path, rel_path, dir_proc), out, fs, fs_model)
                n_done += 1
            print(f"[{n_done}/{len(files)}] bucket {bucket_len / fs_model:.1f}s "
                  f"x{len(group)} rows", file=sys.stderr)
        if pending:
            raise RuntimeError(f"unwritten channels for {list(pending)}")

    dt = time.perf_counter() - t0
    # clip seconds, not padded bucket seconds, or the padding would inflate
    # the realtime factor
    print(f"enhanced {n_done} files ({total_audio:.2f}s audio) in {dt:.3f}s "
          f"({total_audio / max(dt, 1e-9):.2f}x realtime)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
