"""95th percentile (nearest rank) of the latency of every request due in
the window, from its due time to its whole response; a request never
answered counts as infinitely late."""
import math


def read(run):
    if not run.latencies_s:
        return None
    lat = sorted(run.latencies_s)
    return 1e3 * lat[math.ceil(0.95 * len(lat)) - 1]
