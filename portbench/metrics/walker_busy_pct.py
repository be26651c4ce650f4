"""kernel: the share of the walkers' time in which they walked (%):
every walker's iterations over walkers times the longest walk, summed
over the recorder's launch records (``walk_steps`` over ``walkers`` x
``steps``)."""


def read(run):
    snap = getattr(run, "program", None)
    if snap is None or not snap.launches:
        return None
    room = sum(ln["walkers"] * ln["steps"] for ln in snap.launches)
    if not room:
        return None
    return 100.0 * sum(ln["walk_steps"] for ln in snap.launches) / room
