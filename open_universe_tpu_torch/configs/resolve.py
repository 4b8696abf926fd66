"""Minimal OmegaConf-style config machinery (the port's own copy of the JAX
package's ``configs/resolve.py``, which needs PyYAML only).

Supports what the reference's Hydra tree actually uses (SURVEY.md §2.15):
  * ``${a.b.c}`` absolute and ``${..sibling}`` relative interpolations
  * a defaults list (config.yaml) composing group files
    (datamodule/model/trainer/experiment)
  * ``# @package _global_`` experiment overlays merged at the root
  * dotlist command-line overrides (``model.fs=24000``)

No external dependency beyond PyYAML.
"""
from __future__ import annotations

import copy
import re
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

import yaml

_INTERP = re.compile(r"^\$\{([^}]+)\}$")
_INTERP_PART = re.compile(r"\$\{([^}]+)\}")


def load_yaml(path: Union[str, Path]) -> Dict[str, Any]:
    with open(path) as f:
        return yaml.safe_load(f) or {}


def _lookup(root, node_path: List[str], ref: str):
    """Resolve a reference like 'a.b.c' or '..sibling.x'."""
    if ref.startswith("."):
        # relative: each leading dot after the first goes up one level
        up = 0
        while ref.startswith("."):
            ref = ref[1:]
            up += 1
        base = node_path[: len(node_path) - (up - 1)] if up > 1 else list(node_path)
        parts = base + [p for p in ref.split(".") if p]
    else:
        parts = [p for p in ref.split(".") if p]
    cur = root
    for p in parts:
        if isinstance(cur, list):
            cur = cur[int(p)]
        else:
            cur = cur[p]
    return cur


def resolve_interpolations(cfg: Dict[str, Any], max_passes: int = 10):
    """Iteratively resolve ${...} references in-place on a deep copy."""
    cfg = copy.deepcopy(cfg)

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + [k]) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, path + [str(i)]) for i, v in enumerate(node)]
        if isinstance(node, str):
            m = _INTERP.match(node)
            if m:
                try:
                    return _lookup(cfg, path[:-1], m.group(1))
                except (KeyError, IndexError, TypeError):
                    return node
            if "${" in node:
                def sub(mm):
                    try:
                        return str(_lookup(cfg, path[:-1], mm.group(1)))
                    except (KeyError, IndexError, TypeError):
                        return mm.group(0)
                return _INTERP_PART.sub(sub, node)
        return node

    for _ in range(max_passes):
        new = walk(cfg, [])
        if new == cfg:
            break
        cfg = new
    return cfg


def merge(base: Dict[str, Any], overlay: Dict[str, Any]) -> Dict[str, Any]:
    """Deep merge overlay into base (overlay wins; dicts merge recursively)."""
    out = copy.deepcopy(base)
    for k, v in (overlay or {}).items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def apply_dotlist(cfg: Dict[str, Any], overrides: List[str]) -> Dict[str, Any]:
    """Dotlist overrides with hydra's strict semantics:

      ``key=value``     override an existing key (error if the path is new —
                        a silently-created key is how typos like
                        ``exp_dir=...`` go unnoticed for a whole run)
      ``+key=value``    add a new key (error if it already exists)
      ``++key=value``   add or override
      ``~key``          delete an existing key
    """
    cfg = copy.deepcopy(cfg)
    for ov in overrides:
        if ov.startswith("~"):
            key = ov[1:].partition("=")[0]
            parts = key.split(".")
            cur = cfg
            try:
                for p in parts[:-1]:
                    cur = cur[p]
                del cur[parts[-1]]
            except (KeyError, TypeError):
                raise ValueError(
                    f"cannot delete {key!r}: no such key") from None
            continue
        mode = "override"
        if ov.startswith("++"):
            mode, ov = "upsert", ov[2:]
        elif ov.startswith("+"):
            mode, ov = "add", ov[1:]
        if "=" not in ov:
            raise ValueError(f"override {ov!r} must be key=value")
        key, _, val = ov.partition("=")
        val = yaml.safe_load(val)
        cur = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            if isinstance(cur, dict) and p in cur and isinstance(cur[p], dict):
                cur = cur[p]
            elif mode == "override":
                raise KeyError(
                    f"override key {key!r} is not in the composed config "
                    f"(failed at {p!r}); use +{key}=... to add a new key")
            else:
                if not isinstance(cur, dict) or (
                        p in cur and not isinstance(cur[p], dict)):
                    raise KeyError(f"cannot add {key!r}: {p!r} is not a dict")
                cur = cur.setdefault(p, {})
        last = parts[-1]
        exists = isinstance(cur, dict) and last in cur
        if mode == "override" and not exists:
            raise KeyError(
                f"override key {key!r} is not in the composed config; "
                f"use +{key}=... to add a new key")
        if mode == "add" and exists:
            raise KeyError(
                f"+{key} already exists in the composed config; "
                f"use ++{key}=... to override it")
        cur[last] = val
    return cfg


def compose(config_dir: Union[str, Path], overrides: Optional[List[str]] = None,
            config_name: str = "config") -> Dict[str, Any]:
    """Hydra-style composition of the config tree.

    Group choices (e.g. ``experiment=universepp_vb_16k``) may appear in the
    overrides; remaining overrides are applied as a dotlist at the end.
    """
    config_dir = Path(config_dir)
    overrides = list(overrides or [])
    root = load_yaml(config_dir / f"{config_name}.yaml")
    defaults = root.pop("defaults", [])

    choices: Dict[str, str] = {}
    for d in defaults:
        if isinstance(d, dict):
            choices.update({k: v for k, v in d.items()})
    # group overrides (key matches a group dir)
    dot_overrides = []
    cli_group_choices = {}
    for ov in overrides:
        key, _, val = ov.partition("=")
        if "." not in key and (config_dir / key).is_dir():
            choices[key] = val
            cli_group_choices[key] = val
        else:
            dot_overrides.append(ov)

    order = [d if isinstance(d, str) else list(d.keys())[0] for d in defaults]

    # first pass: global overlays (experiments) may override group choices via
    # their own defaults list ("- override /model: xyz"); CLI choices win.
    cli_choices = cli_group_choices
    global_overlays = []
    for group in order:
        if group == "_self_":
            continue
        choice = choices.get(group)
        if choice is None or choice == "null":
            continue
        path = config_dir / group / f"{choice}.yaml"
        node = load_yaml(path)
        with open(path) as f:
            head = f.read(256)
        if "@package _global_" in head or group == "experiment":
            overlay_defaults = node.pop("defaults", [])
            for d in overlay_defaults:
                if isinstance(d, dict):
                    for k, v in d.items():
                        k = k.replace("override ", "").lstrip("/").strip()
                        if k != "_self_" and k not in cli_choices:
                            choices[k] = v
            global_overlays.append(node)

    cfg: Dict[str, Any] = {}
    for group in order:
        if group == "_self_":
            cfg = merge(cfg, root)
            continue
        choice = choices.get(group)
        if choice is None or choice == "null":
            continue
        path = config_dir / group / f"{choice}.yaml"
        with open(path) as f:
            head = f.read(256)
        if "@package _global_" in head or group == "experiment":
            continue  # handled as overlay below
        cfg = merge(cfg, {group: load_yaml(path)})

    for overlay in global_overlays:
        cfg = merge(cfg, overlay)

    cfg = apply_dotlist(cfg, dot_overrides)
    cfg["_choices_"] = choices
    return resolve_interpolations(cfg)
