"""The device's side of a traced run, read from ``torch.profiler``.

The profiler records the card's activity (kernels, copies, sets) and the
host's ``record_function`` ranges on one timeline. From it:

- ``window``: the ``portbench.window`` range, which the harness opens
  and closes around the measured window;
- ``busy_s``: the union of every device activity inside the window;
- ``kernel_s``: the device time of the enumeration kernels (names that
  hold ``enum_chunk``);
- ``device_ops``: device time by name, the ten largest;
- ``idle_gaps``: the ten longest stretches inside the window with nothing
  on the card, each named by the innermost ``portbench.<layer>`` range
  the host was in at the gap's middle.

Where the profiler shows no device activity at all, :func:`read` says
so (``device_events`` 0), and the caller falls back to the CUDA events
around each launch for the kernel time.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

__all__ = ["start", "read", "union", "gaps"]

KERNEL_MARK = "enum_chunk"


def start():
    """A running profiler of host ranges and the card's activity."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts, record_shapes=False, with_stack=False,
                   profile_memory=False)
    prof.__enter__()
    return prof


def _events(prof) -> Tuple[list, list]:
    """(device intervals, host ranges) as (name, start_us, end_us)."""
    from torch.autograd import DeviceType
    dev, host = [], []
    for e in prof.events():
        t0, t1 = float(e.time_range.start), float(e.time_range.end)
        if e.name.startswith("portbench."):
            # the record_function ranges show on the host and, as
            # annotations, on the device's timeline too: host only
            if e.device_type != DeviceType.CUDA:
                host.append((e.name[len("portbench."):], t0, t1))
        elif e.device_type == DeviceType.CUDA:
            dev.append((e.name, t0, t1))
    return dev, host


def union(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Merged, sorted intervals."""
    out: List[List[float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def gaps(busy: List[Tuple[float, float]], w0: float, w1: float):
    """The stretches of [w0, w1] that no interval of `busy` covers."""
    out, t = [], w0
    for a, b in busy:
        if a > t:
            out.append((t, min(a, w1)))
        t = max(t, b)
        if t >= w1:
            break
    if t < w1:
        out.append((t, w1))
    return [(a, b) for a, b in out if b > a]


def _label(host, t: float) -> str:
    inner = None
    for name, a, b in host:
        if name != "window" and a <= t <= b and \
                (inner is None or a >= inner[1]):
            inner = (name, a)
    return inner[0] if inner else "outside"


def read(prof) -> dict:
    """What the card did inside the ``portbench.window`` range."""
    dev, host = _events(prof)
    win = [(a, b) for name, a, b in host if name == "window"]
    if not win:
        raise RuntimeError("profiler: no portbench.window range recorded")
    w0, w1 = win[0]
    inside = [(n, max(a, w0), min(b, w1)) for n, a, b in dev
              if b > w0 and a < w1]
    busy = union([(a, b) for _, a, b in inside])
    by_name: dict = {}
    for n, a, b in inside:
        by_name[n] = by_name.get(n, 0.0) + (b - a) * 1e-6
    idle = sorted(gaps(busy, w0, w1), key=lambda g: g[0] - g[1])[:10]
    return {
        "device_events": len(inside),
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": sum(b - a for a, b in busy) * 1e-6,
        "kernel_s": sum(s for n, s in by_name.items() if KERNEL_MARK in n),
        "device_ops": sorted(([n, s] for n, s in by_name.items()),
                             key=lambda x: -x[1])[:10],
        "idle_gaps": [[_label(host, (a + b) / 2), (b - a) * 1e-6]
                      for a, b in idle],
    }
