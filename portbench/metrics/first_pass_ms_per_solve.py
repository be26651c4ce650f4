"""facade: host milliseconds in the facade's native first pass
(``native.native_enumerate``) per solve."""


def read(run):
    if not run.counts.get("first_pass_calls"):
        return None
    return run.span_s("first_pass") * 1e3 / len(run.latencies)
