"""kernel wrappers: kernel launches (``kernels.LAUNCHES`` summed over
``kernels.FORMS``) per solve."""


def read(run):
    if not run.latencies:
        return None
    return run.launches_total / len(run.latencies)
