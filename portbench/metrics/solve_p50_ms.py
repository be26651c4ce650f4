"""entry: the median latency of every solve in the traced window, on the
harness's clock (ms)."""

import statistics


def read(run):
    lat = run.latencies
    return statistics.median(lat) * 1e3 if lat else None
