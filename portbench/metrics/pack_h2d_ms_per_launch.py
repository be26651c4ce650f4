"""enumerator: host milliseconds in the copies of a launch's inputs to
the card (``enum.pack.h2d``, inside ``DeviceEnumerator._pack``) per
launch."""

from ._per_launch import ms_per_launch


def read(run):
    return ms_per_launch(run, "enum.pack.h2d")
