"""Clips per ``enhance`` call of the server's worker over the window (its
``stats``: clips over batches)."""


def read(run):
    if not run.stats or not run.stats.get("batches"):
        return None
    return run.stats["clips"] / run.stats["batches"]
