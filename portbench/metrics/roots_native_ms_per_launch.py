"""enumerator: host milliseconds in the native root expansion
(``enum.roots.native``, inside ``DeviceEnumerator._gen_roots``) per
launch."""

from ._per_launch import ms_per_launch


def read(run):
    return ms_per_launch(run, "enum.roots.native")
