"""Metric evaluation CLI (reference bin/eval_metrics.py; the port's copy of
the JAX package's ``bin/eval_metrics.py``, on the CPU).

    python -m open_universe_tpu_torch.bin.eval_metrics enhanced/ --ref_path clean/ \
        --metrics pesq-wb si-sdr stoi-ext lsd

Incremental per-file JSON results (existing entries are skipped on rerun),
``.bak`` rotation, and a mean-summary JSON — formats identical to the
reference so bin.make_table can consume either.
"""
import argparse
import json
import os
import shutil
import sys
from collections import defaultdict
from pathlib import Path

import numpy as np

from ..data.audio import load_audio
from ..metrics import Metrics


def backup_file(path: Path):
    if path.exists():
        bak = Path(str(path) + ".bak")
        i = 0
        while bak.exists():
            bak = Path(str(path) + f".bak{i}")
            i += 1
        shutil.copy2(path, bak)


def summarize(results, ignore_inf=True):
    metrics = set()
    summary = defaultdict(float)
    denom = defaultdict(int)
    for res in results.values():
        for met, val in res.items():
            if isinstance(val, str):
                continue
            metrics.add(met)
            # quirk intentionally FIXED: the reference's condition
            # `ignore_inf or not isinf` (eval_metrics.py:67) is inverted —
            # with its default ignore_inf=True it INCLUDES inf values and one
            # inf file makes the whole mean inf/nan
            if not ignore_inf or not np.isinf(val):
                summary[met] += val
                denom[met] += 1
        summary["number"] += 1
    for met in metrics:
        summary[met] = summary[met] / max(denom[met], 1)
    out = dict(summary)
    if any(met.startswith("pesq") for met in metrics):
        # self-describing honesty flag: the in-house P.862 fallback is
        # rank-conformant but NOT absolute-MOS conformant (metrics/p862.py
        # conformance note; PARITY.md quantifies the bound) — downstream
        # tables must be able to tell which implementation scored this run
        from ..metrics.wrapper import pesq_available

        out["pesq_conformant"] = bool(pesq_available())
    return out


_AUDIO_EXTS = (".wav", ".flac", ".mp3")


def prepare(ref_path, deg_path, results_path):
    results = {}
    if results_path.exists():
        with open(results_path) as f:
            results = json.load(f)
    # the reference collects *.wav only and keys by bare stem
    # (reference bin/eval_metrics.py:86); we also accept the other containers
    # the enhance CLI can emit, keep nested trees (the enhance CLI preserves
    # input structure), and fall back to relative-path keys when two files
    # share a stem instead of dropping one
    by_rel = {}
    for ext in _AUDIO_EXTS:  # earlier extension wins for a stem+dir pair
        for p in sorted(deg_path.rglob(f"*{ext}")):
            rel = p.relative_to(deg_path).with_suffix("")
            if rel in by_rel:
                print(f"warning: duplicate containers for {rel}: keeping "
                      f"{by_rel[rel].name}, ignoring {p.name}",
                      file=sys.stderr)
                continue
            by_rel[rel] = p
    stem_counts = defaultdict(int)
    for rel in by_rel:
        stem_counts[rel.name] += 1
    paths = {}
    for rel, p in by_rel.items():
        label = rel.name if stem_counts[rel.name] == 1 else rel.as_posix()
        paths[label] = {"deg": p, "ref": None, "rel": rel}
    if ref_path is not None:
        for label, pd in paths.items():
            # prefer a reference in the same container as the degraded file;
            # try the mirrored subtree first, then flat by stem (the
            # reference's rule)
            exts = [pd["deg"].suffix] + [e for e in _AUDIO_EXTS
                                         if e != pd["deg"].suffix]
            bases = [pd["rel"].as_posix()]
            if pd["rel"].name != bases[0]:
                bases.append(pd["rel"].name)
            for base in bases:
                for ext in exts:
                    rp = ref_path / f"{base}{ext}"
                    if rp.exists():
                        pd["ref"] = rp
                        break
                if pd["ref"] is not None:
                    break
    missing = [lbl for lbl in results if lbl not in paths]
    if missing:
        raise ValueError(f"results reference missing files: {missing[:5]}")
    for lbl in paths:
        results.setdefault(lbl, {})
    return results, paths


def load_files(pd):
    deg, fs = load_audio(pd["deg"])
    if deg.shape[0] > 1:
        raise ValueError("expected mono data")
    ref = None
    if pd.get("ref") is not None:
        ref, fs_ref = load_audio(pd["ref"])
        if fs != fs_ref:
            raise ValueError("ref and deg must share a sampling frequency")
        ref = ref[0]
    return fs, deg[0], ref


def save_results(results, results_path, summary_path):
    backup_file(results_path)
    with open(results_path, "w") as f:
        json.dump(results, f, indent=2)
    backup_file(summary_path)
    with open(summary_path, "w") as f:
        json.dump(summarize(results), f, indent=2)


_worker_computer = None


def _worker_init(metric_names):
    """Runs once per worker process (spawn): one torch thread, then the
    per-process Metrics dispatcher."""
    global _worker_computer
    import torch

    torch.set_num_threads(1)
    _worker_computer = Metrics(metrics=metric_names)


def _worker_eval(task):
    label, pd, skip = task
    try:
        fs, deg, ref = load_files(pd)
        return label, _worker_computer(fs, deg, ref, skip_list=skip), None
    except Exception as e:  # report, don't kill the pool
        return label, None, f"{type(e).__name__}: {e}"


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Run evaluation on an enhanced speech folder")
    parser.add_argument("enhanced_path", type=Path)
    parser.add_argument("--ref_path", type=Path)
    parser.add_argument("--result_dir", type=Path)
    parser.add_argument("--metrics", nargs="+",
                        choices=Metrics.get_metric_names())
    parser.add_argument("--save-every", type=int, default=100)
    parser.add_argument(
        "--workers", type=int, default=1,
        help="parallel worker processes for the per-file metric computation "
        "(host-side CPU workload; the reference runs sequentially). "
        "Clamped to cpu_count and ~1 worker per 20 files — each process "
        "pays seconds of import startup before its first file")
    parser.add_argument("--force-workers", action="store_true",
                        help=argparse.SUPPRESS)  # tests: bypass the clamp
    args = parser.parse_args(argv)

    deg_path = args.enhanced_path
    ds_name = deg_path.stem
    result_dir = args.result_dir or deg_path.parent
    result_dir.mkdir(parents=True, exist_ok=True)
    if not os.access(result_dir, os.W_OK):
        raise PermissionError(f"{result_dir} is not writable")

    results_path = result_dir / f"{ds_name}.json"
    summary_path = result_dir / f"{ds_name}_summary.json"
    results, paths = prepare(args.ref_path, deg_path, results_path)

    n_workers = args.workers
    if n_workers > 1 and not args.force_workers:
        # each spawned worker pays seconds of imports, so a worker only pays
        # off with >~20 files to amortize over and a real core to run on —
        # clamp instead of honoring a counterproductive request
        import os as _os

        n_workers = max(1, min(n_workers, len(results) // 20,
                               _os.cpu_count() or 1))
        if n_workers < args.workers:
            print(f"note: clamping --workers {args.workers} -> {n_workers} "
                  f"({len(results)} files, {_os.cpu_count()} cpus); "
                  "per-process startup would dominate", file=sys.stderr)
    if n_workers > 1:
        # per-file metrics are independent: fan out over processes (spawn,
        # so no forked threads), stream results back for the same
        # incremental saves as the sequential path
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor, as_completed

        metric_names = args.metrics or Metrics.get_metric_names()
        # rerun fast path: fully-scored files skip audio decode entirely
        tasks = [(lbl, paths[lbl], set(results[lbl].keys()))
                 for lbl in sorted(results)
                 if Metrics.remaining(metric_names, results[lbl].keys())]
        with ProcessPoolExecutor(
                max_workers=n_workers, mp_context=mp.get_context("spawn"),
                initializer=_worker_init,
                initargs=(args.metrics,)) as ex:
            futures = [ex.submit(_worker_eval, t) for t in tasks]
            for n, fut in enumerate(as_completed(futures)):
                label, res, err = fut.result()
                if err is not None:
                    print(f"warning: metrics failed on {label}: {err}",
                          file=sys.stderr)
                else:
                    results[label].update(res)
                if (n + 1) % args.save_every == 0:
                    save_results(results, results_path, summary_path)
                    print(f"[{n + 1}/{len(results)}]", file=sys.stderr)
    else:
        computer = Metrics(metrics=args.metrics)
        metric_names = args.metrics or Metrics.get_metric_names()
        for n, label in enumerate(sorted(results)):
            skip = set(results[label].keys())
            if not Metrics.remaining(metric_names, skip):
                continue  # fully scored: skip the audio decode too
            try:
                fs, deg, ref = load_files(paths[label])
                results[label].update(computer(fs, deg, ref, skip_list=skip))
            except Exception as e:
                # one unusable file (too short / silent / corrupt) must not
                # abort the run; it stays absent from results so a rerun
                # after fixing it picks it up (incremental skip-list design)
                print(f"warning: metrics failed on {label}: {e}",
                      file=sys.stderr)
            if (n + 1) % args.save_every == 0:
                save_results(results, results_path, summary_path)
                print(f"[{n + 1}/{len(results)}]", file=sys.stderr)

    save_results(results, results_path, summary_path)
    print(json.dumps(summarize(results), indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
