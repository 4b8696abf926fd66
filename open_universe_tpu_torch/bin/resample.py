"""Resample a folder tree of wav files (JAX package ``bin/resample.py``,
reference prepare/resample.py).

    python -m open_universe_tpu_torch.bin.resample in_dir out_dir --fs 16000

Every ``*.wav`` under ``in_dir`` is written under ``out_dir`` at the same
relative path, at ``--fs`` (``data/audio.py``'s polyphase sinc resampler;
a file already at ``--fs`` is copied through the codec), ``--workers``
files at a time.
"""
import argparse
import sys
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

from ..data.audio import load_audio, resample_audio, save_audio


def _one(job):
    src, dst, fs = job
    audio, in_fs = load_audio(src)
    if in_fs != fs:
        audio = resample_audio(audio, in_fs, fs)
    dst.parent.mkdir(parents=True, exist_ok=True)
    save_audio(dst, audio, fs)
    return dst


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("input", type=Path)
    parser.add_argument("output", type=Path)
    parser.add_argument("--fs", type=int, default=16000)
    parser.add_argument("--workers", type=int, default=8)
    args = parser.parse_args(argv)

    files = sorted(args.input.rglob("*.wav"))
    jobs = [(p, args.output / p.relative_to(args.input), args.fs) for p in files]
    with ProcessPoolExecutor(max_workers=args.workers) as ex:
        for i, _ in enumerate(ex.map(_one, jobs)):
            if (i + 1) % 500 == 0:
                print(f"[{i + 1}/{len(jobs)}]", file=sys.stderr)
    print(f"resampled {len(jobs)} files to {args.fs} Hz", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
