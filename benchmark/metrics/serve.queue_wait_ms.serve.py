"""Mean time a clip waited in the server's queue, from ``submit`` until the
worker took it, in the window: its ``stats`` queue_wait_seconds over
clips."""


def read(run):
    if not run.stats or not run.stats.get("clips") or "queue_wait_seconds" not in run.stats:
        return None
    return 1e3 * run.stats["queue_wait_seconds"] / run.stats["clips"]
