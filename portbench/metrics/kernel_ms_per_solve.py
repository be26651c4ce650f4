"""kernel: device milliseconds of the enumeration kernels (profiler
kernels named ``enum_chunk*``; CUDA events around each launch where the
profiler shows no device time) per solve."""


def read(run):
    if not run.launches_total or not run.kernel_s:
        return None
    return run.kernel_s * 1e3 / len(run.latencies)
