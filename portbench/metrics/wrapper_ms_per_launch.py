"""kernel wrappers: host milliseconds inside ``enum_run`` (staging, the
launch, the wait for the card and the top-K finalize) per launch."""


def read(run):
    if not run.launches_total:
        return None
    return run.span_s("wrapper") * 1e3 / run.launches_total
