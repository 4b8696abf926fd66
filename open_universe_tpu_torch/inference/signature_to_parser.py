"""Reflect ``model.enhance`` keyword arguments into argparse flags (JAX
package ``inference/signature_to_parser.py``, reference
inference_utils/signature_to_parser.py).

Only int, float, str and bool arguments become flags (``n_steps``,
``epsilon``, ``fake_score_snr``, ``use_aux_signal``, ``keep_rms``,
``ensemble``, ``ensemble_stat``, ``warm_start``); ``target`` and the
torch-typed ones (``compute_dtype``, ``generator``, ``noise``) are left out.
"""
from __future__ import annotations

import argparse
import typing

_SKIP = {"mix", "target", "return", "compute_dtype", "generator", "noise"}


def add_enhance_arguments(model, parser: argparse.ArgumentParser):
    if not (hasattr(model, "enhance") and callable(model.enhance)):
        raise ValueError("model does not have an `enhance` method")
    hints = typing.get_type_hints(model.enhance)
    defaults = getattr(model, "diff_kwargs", {}) or {}

    group = parser.add_argument_group("enhance", "Arguments of enhance function")
    for key, hint in hints.items():
        if key in _SKIP:
            continue
        types = typing.get_args(hint)
        cast = types[0] if types else hint
        if cast not in (int, float, str, bool):
            continue
        if cast is bool:
            group.add_argument(f"--{key}", default=defaults.get(key),
                               type=lambda s: s.lower() in ("1", "true", "yes"))
        else:
            group.add_argument(f"--{key}", default=defaults.get(key), type=cast)
    return parser


def parse_with_enhance_args(parser: argparse.ArgumentParser, argv, load_model):
    """Two-stage CLI parse: parse the known flags (ignoring --help) to learn
    --model and --device, load the model with ``load_model(model,
    device=...)``, reflect its ``enhance`` arguments into the parser, then
    parse for real.  Returns (args, model, enhance_kwargs), the last holding
    the reflected flags the user set."""
    argv = list(argv)
    want_help = "-h" in argv or "--help" in argv
    pre, _ = parser.parse_known_args([a for a in argv if a not in ("-h", "--help")])
    model = load_model(pre.model, device=getattr(pre, "device", None))
    add_enhance_arguments(model, parser)
    if want_help:
        argv.append("--help")
    args = parser.parse_args(argv)
    groups = [g for g in parser._action_groups if g.title == "enhance"]
    enhance_kwargs = {}
    if groups:
        enhance_kwargs = {a.dest: getattr(args, a.dest)
                          for a in groups[0]._group_actions
                          if getattr(args, a.dest) is not None}
    return args, model, enhance_kwargs
