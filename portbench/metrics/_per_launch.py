"""Host milliseconds in the recorder's spans of one name per
``kernels.run`` span (one launch of the wrappers), or None where the
run recorded no launch or no such span."""


def ms_per_launch(run, name: str):
    snap = getattr(run, "program", None)
    if snap is None:
        return None
    runs, spans = snap.named("kernels.run"), snap.named(name)
    if not runs or not spans:
        return None
    return snap.seconds(name) * 1e3 / len(runs)
