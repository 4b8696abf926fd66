"""Alias of the reference's ``open_universe.prepare.resample`` entry point:
``python -m open_universe_tpu_torch.prepare.resample`` runs
``bin/resample.py``."""
from ..bin.resample import *  # noqa: F401,F403
from ..bin.resample import main

if __name__ == "__main__":
    main()
