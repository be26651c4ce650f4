"""facade: the C core's loop iterations per node it counts in the
facade's first pass (the recorder's ``first_pass.iters`` over
``first_pass.nodes``): the first pass's budget counts iterations, so a
tree of n nodes ends inside a budget b where n times this ratio is
under b."""


def read(run):
    snap = getattr(run, "program", None)
    if snap is None or not snap.counts.get("first_pass.nodes"):
        return None
    return snap.counts["first_pass.iters"] / snap.counts["first_pass.nodes"]
