"""Quality-parity harness against the reference's published results (JAX
package ``bin/parity.py``; reference README.md:101-115, made by
``bin.make_table`` on the VB-DEMAND 16 kHz test set).

    python -m open_universe_tpu_torch.bin.parity \\
        --model line-corporation/open-universe:plusplus \\
        --noisy-dir data/vb-demand-16k/test/noisy \\
        --clean-dir data/vb-demand-16k/test/clean \\
        --output exp/parity [--device cuda]

Loads the checkpoint (a local ``*.ckpt`` or a HF ``repo[:rev]``), enhances
the noisy tree with ``bin/enhance.py`` (on ``--device``, CUDA by default,
so the fused ConvBlock kernel runs), scores it against the clean tree with
``bin/eval_metrics.py``, and prints and saves (``parity_report.json``) a
delta table against the published row.  ``parity`` is true when at least
one metric was compared and every compared metric is at least as good as
the published one (higher or lower, by the metric).
"""
from __future__ import annotations

import argparse
import json
import logging
import sys
from pathlib import Path

log = logging.getLogger(__name__)

# Published VB-DEMAND 16 kHz test results (reference README.md:107-108;
# metric names as README.md:110-115).  Keys are the metric suite's names.
REFERENCE_RESULTS = {
    "plusplus": {  # the UNIVERSE++ row
        "si-sdr": 18.624,
        "pesq-wb": 3.017,
        "stoi-ext": 0.864,
        "lsd": 4.867,
        "lps": 0.937,
        "dnsmos-ovr": 3.200,
        "dnsmos-sig": 3.489,
        "dnsmos-bak": 4.040,
    },
    "original": {  # the UNIVERSE row
        "si-sdr": 17.600,
        "pesq-wb": 2.830,
        "stoi-ext": 0.844,
        "lsd": 6.318,
        "lps": 0.920,
        "dnsmos-ovr": 3.157,
        "dnsmos-sig": 3.457,
        "dnsmos-bak": 4.013,
    },
}

# metrics where higher is better (delta > 0 beats the reference)
_HIGHER_BETTER = {"si-sdr", "pesq-wb", "pesq-nb", "stoi", "stoi-ext", "lps",
                  "dnsmos-ovr", "dnsmos-sig", "dnsmos-bak", "sdr"}

DEFAULT_METRICS = ["pesq-wb", "si-sdr", "stoi-ext", "lsd"]


def build_report(summary: dict, baseline: dict, metrics) -> dict:
    rows = []
    for m in metrics:
        ours, ref = summary.get(m), baseline.get(m)
        row = {"metric": m, "ours": ours, "reference": ref}
        if ours is not None and ref is not None:
            delta = ours - ref
            row["delta"] = delta
            row["better"] = bool(delta >= 0) if m in _HIGHER_BETTER else bool(delta <= 0)
        rows.append(row)
    compared = [r for r in rows if "delta" in r]
    return {
        "n_files": summary.get("number"),
        "rows": rows,
        # an all-failed metric pass is no parity
        "parity": bool(compared) and all(r["better"] for r in compared),
        "n_compared": len(compared),
    }


def format_table(report: dict) -> str:
    lines = [f"{'metric':<12} {'ours':>10} {'reference':>10} {'delta':>9}  "]
    for r in report["rows"]:
        ours = "n/a" if r["ours"] is None else f"{r['ours']:.3f}"
        ref = "n/a" if r["reference"] is None else f"{r['reference']:.3f}"
        delta = f"{r['delta']:+.3f}" if "delta" in r else "n/a"
        mark = "" if "better" not in r else ("✓" if r["better"] else "✗")
        lines.append(f"{r['metric']:<12} {ours:>10} {ref:>10} {delta:>9} {mark}")
    return "\n".join(lines)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="enhance + evaluate + compare with the published results")
    parser.add_argument("--model", type=str, required=True,
                        help="local *.ckpt or HF repo[:revision]")
    parser.add_argument("--noisy-dir", type=Path, required=True)
    parser.add_argument("--clean-dir", type=Path, required=True)
    parser.add_argument("--output", type=Path, required=True,
                        help="run dir; the enhanced wavs and the reports go here")
    parser.add_argument("--metrics", nargs="+", default=DEFAULT_METRICS)
    parser.add_argument("--reference", choices=sorted(REFERENCE_RESULTS), default="plusplus",
                        help="published README row to compare against")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device of the enhancement (cuda, cpu)")
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--bucket-seconds", type=float, default=1.0)
    parser.add_argument("--n-steps", type=int, default=None,
                        help="diffusion steps (the model's default: 8)")
    parser.add_argument("--limit", type=int, default=None,
                        help="only the first N files (smoke runs)")
    parser.add_argument("--skip-enhance", action="store_true",
                        help="reuse an existing <output>/enhanced tree")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(message)s")
    args.output.mkdir(parents=True, exist_ok=True)
    enhanced_dir = args.output / "enhanced"

    noisy_dir = args.noisy_dir
    if args.limit is not None:
        # the first N files, as a subtree of symlinks
        from ..data.audio import AUDIO_EXTS

        subset = args.output / "noisy_subset"
        subset.mkdir(exist_ok=True)
        wavs = sorted(p for p in args.noisy_dir.rglob("*")
                      if p.suffix.lower() in AUDIO_EXTS)[: args.limit]
        for w in wavs:
            link = subset / w.name
            if not link.exists():
                link.symlink_to(w.resolve())
        noisy_dir = subset

    if not args.skip_enhance:
        from .enhance import main as enhance_main

        enh_args = [str(noisy_dir), str(enhanced_dir), "--model", args.model,
                    "--device", args.device, "--batch-size", str(args.batch_size),
                    "--bucket-seconds", str(args.bucket_seconds)]
        if args.n_steps is not None:
            enh_args += ["--n_steps", str(args.n_steps)]
        rc = enhance_main(enh_args)
        if rc != 0:
            log.error("enhancement failed (rc=%d)", rc)
            return rc

    from .eval_metrics import main as eval_main

    rc = eval_main([str(enhanced_dir), "--ref_path", str(args.clean_dir),
                    "--metrics", *args.metrics])
    if rc != 0:
        log.error("metric evaluation failed (rc=%d)", rc)
        return rc

    with open(args.output / "enhanced_summary.json") as f:
        summary = json.load(f)
    report = build_report(summary, REFERENCE_RESULTS[args.reference], args.metrics)
    report["model"] = args.model
    report["reference_row"] = args.reference
    report_path = args.output / "parity_report.json"
    with open(report_path, "w") as f:
        json.dump(report, f, indent=2)

    print(format_table(report))
    print(json.dumps({"parity": report["parity"], "report": str(report_path)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
