"""The server worker's wall time per ``enhance`` call, copy back included:
its ``stats["device_seconds"]`` (a host-clock time, despite the name) over
its batches, in the window."""


def read(run):
    if not run.stats or not run.stats.get("batches"):
        return None
    return 1e3 * run.stats["device_seconds"] / run.stats["batches"]
