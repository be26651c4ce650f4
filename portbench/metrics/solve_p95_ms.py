"""The 95th percentile (nearest rank) of every solve's latency in the
window, failed solves included (ms)."""

import math


def read(run):
    lat = sorted(run.latencies)
    if not lat:
        return None
    return lat[max(1, math.ceil(0.95 * len(lat))) - 1] * 1e3
