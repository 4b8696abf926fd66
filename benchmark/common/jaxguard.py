"""The guard that no run reports after loading JAX or the JAX package:
module names are compared by their whole top-level name, so
``open_universe_tpu_torch`` (the port) passes and ``open_universe_tpu``
(the JAX package) does not."""
from __future__ import annotations

import sys
from typing import Iterable, List, Optional

BANNED = ("jax", "jaxlib", "flax", "open_universe_tpu")


def loaded(modules: Optional[Iterable[str]] = None) -> List[str]:
    """The banned top-level names among ``modules`` (default: those loaded)."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(n for n in names if n in BANNED)
