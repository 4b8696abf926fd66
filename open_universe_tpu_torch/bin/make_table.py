"""Assemble a results table from metric summary JSONs
(reference bin/make_table.py; the port's copy of the JAX package's
``bin/make_table.py``, self-contained table formatting).

    python -m open_universe_tpu_torch.bin.make_table --results a_summary.json
"""
import argparse
import json
import sys
from pathlib import Path


def get_metric(dic, name):
    for cand in (name.replace("-", "_"), name.replace("_", "-"), name):
        if cand in dic:
            return dic[cand]
    return None


def read_results(path, metrics):
    with open(path) as f:
        data = json.load(f)
    return [get_metric(data, m) for m in metrics]


def format_table(rows, headers, floatfmt=".3f"):
    def fmt(v):
        if isinstance(v, float):
            return format(v, floatfmt)
        return "" if v is None else str(v)

    cells = [[fmt(v) for v in row] for row in rows]
    widths = [max(len(h), *(len(r[i]) for r in cells)) if cells else len(h)
              for i, h in enumerate(headers)]
    lines = ["  ".join(h.ljust(w) for h, w in zip(headers, widths))]
    lines.append("  ".join("-" * w for w in widths))
    for row in cells:
        lines.append("  ".join(c.ljust(w) for c, w in zip(row, widths)))
    return "\n".join(lines)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-f", "--format", default="plain")
    parser.add_argument(
        "--metrics", "-m", nargs="+",
        default=["si-sdr", "pesq-wb", "stoi-ext", "lsd", "lps",
                 "OVRL", "SIG", "BAK"])
    parser.add_argument("--results", "-r", nargs="+", type=Path, required=True)
    parser.add_argument("--labels", "-l", nargs="+")
    args = parser.parse_args(argv)

    labels = args.labels or [str(p.parent) for p in args.results]
    if len(labels) != len(args.results):
        raise ValueError("number of labels must match number of results")

    headers = ["model"] + args.metrics
    rows = [[lbl] + read_results(path, args.metrics)
            for lbl, path in zip(labels, args.results)]
    print(format_table(rows, headers))
    if any(m.startswith("pesq") for m in args.metrics):
        flags = []
        for path in args.results:
            with open(path) as f:
                flags.append(json.load(f).get("pesq_conformant"))
        if any(fl is False for fl in flags):
            print("note: pesq columns were scored by the in-house P.862 "
                  "fallback (rank-conformant, absolute MOS not ITU-"
                  "conformant; see PARITY.md)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
