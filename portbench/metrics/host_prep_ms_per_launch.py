"""enumerator: host milliseconds generating subtree roots
(``DeviceEnumerator._gen_roots``) and packing them
(``DeviceEnumerator._pack``) per kernel launch."""


def read(run):
    if not run.launches_total:
        return None
    return (run.span_s("gen_roots") + run.span_s("pack")) * 1e3 / \
        run.launches_total
