"""The frozen roofline model of the enumeration kernel and the card's
published peaks, copied from the bring-up smoke (``chip_smoke.py``:
``op_count``, ``bound_ms``) so that later changes to the port cannot
move it.

Peaks: NVIDIA H100 SXM data sheet, dense, outside the tensor cores
(the walk uses none): 67 TFLOP/s float32, 34 TFLOP/s float64, HBM3
3.35 TB/s, all at the full 700 W power limit; the run prints the card's
own limit beside the metric.

Operations: per node the walk counts at level k, the bound test and the
zig-zag step (about 20) plus the update of the k center sums below it
(4k). A change that walks fewer nodes for the same answer lowers this
count and the metric with it.

Bytes: what one launch needs of its problem, read once, none of the
padding to the kernel's buckets: mu's strict triangle, r, the pruning
and the start centers over the m_real device levels, mu against the
fixed levels, and the roots inside the start radius (each one's partial
length and the coordinates it feeds the center sums); written once: the
result slots (a distance, a root index and m_real coordinates each) and
the counters (per-level nodes, solutions, two walk lengths).
"""

from __future__ import annotations

__all__ = ["PEAK_FLOPS", "HBM_BYTES_PER_S", "op_count", "launch_bytes",
           "bound_s"]

PEAK_FLOPS = {4: 67e12, 8: 34e12}     # by element size in bytes
HBM_BYTES_PER_S = 3.35e12


def op_count(nodes) -> float:
    return float(sum(int(n) * (4 * k + 20) for k, n in enumerate(nodes)))


def launch_bytes(ln: dict) -> float:
    mr, nf, elem = ln["m_real"], ln["nfix"], ln["elem"]
    floats = mr * (mr - 1) // 2 + 3 * mr + mr * nf + \
        ln["roots_live"] * (nf + 1)
    if ln["dual"]:
        floats += min(ln["slots"], ln["roots_live"]) * nf
    nbytes = floats * elem + ln["slots"] * ((mr + 1) * elem + 4) + \
        (mr + 1) * 8 + 2 * 8
    if ln["subsols"]:
        nbytes += mr * ((mr + 1) * elem + 4)
    return float(nbytes)


def bound_s(ln: dict) -> float:
    """The least time one launch could take on the card: the larger of
    its operations at the element type's peak and its bytes at HBM's."""
    return max(op_count(ln["nodes"][:ln["m_real"]]) / PEAK_FLOPS[ln["elem"]],
               launch_bytes(ln) / HBM_BYTES_PER_S)
