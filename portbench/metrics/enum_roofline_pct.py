"""kernel: the enumeration kernel's share of its roofline (%): the least
time the card could take for the launches' work (``_model.bound_s``:
operations at the element type's peak or bytes at HBM's, whichever is
larger) over their device time. It counts visited nodes, so a change
that walks fewer nodes for the same answer lowers it."""

from ._model import bound_s


def read(run):
    if not run.launches or not run.kernel_s:
        return None
    return 100.0 * sum(bound_s(ln) for ln in run.launches) / run.kernel_s
