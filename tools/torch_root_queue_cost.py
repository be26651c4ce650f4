"""The host's cost of one launch's root queue on every window of a
benchmark cell, on the CPU: the expansion of the top of the tree
(``DeviceEnumerator._gen_roots``), and the sort, pad and write into the
kernel's layout (``DeviceEnumerator._pack``; on the CPU its copy is a
memcpy into a fresh tensor, on a card a copy from pinned memory that
this tool does not see).

Each window is taken as the facade hands it to the enumerator (the first
pass off, the launch replaced by a stop), then timed ``--reps`` times.
With ``--parent DIR``, a checkout whose ``enum_core.c`` still has the
expansion that copies each node's whole prefix (``enum_gen_roots`` with
caller-sized output buffers), the earlier pipeline is timed on the same
windows as it ran: that expansion, ``np.argsort``, the float64 pad and
``torch.as_tensor`` to the tree's dtype; and its rows, distances and
node counts are compared with this checkout's, bit for bit.

    python tools/torch_root_queue_cost.py [--cell <cell>] [--reps 5] \\
        [--parent DIR]

Prints one JSON line: per pipeline the median and quartiles over the
windows (each window's median over its repetitions) of the expansion,
the sort and write, and their sum, in ms; the rows, fixed levels and
bytes a launch; with ``--parent``, the windows whose expansion or queue
differs from the earlier one's.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


class _Stop(Exception):
    pass


def windows(cell_name: str) -> list:
    """(enumerator, enumerate's arguments) of every window of the cell,
    as the facade calls DeviceEnumerator.enumerate on the CPU."""
    from fplll_tpu_torch.enum import device as tdev
    from portbench.harness.registry import entry, load_cell

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        cell = load_cell(json.load(f), cell_name)
    ent = entry(cell.spec["entry"])(cell.config, cell.pool, cell.table)
    seen = []
    orig = tdev.DeviceEnumerator.enumerate

    def spy(self, *args, **kw):
        seen.append((self, args, kw))
        raise _Stop

    tdev.DeviceEnumerator.enumerate = spy
    try:
        for row in range(len(cell.table)):
            try:
                ent.solve(row)
            except _Stop:
                pass
            if len(seen) != row + 1:
                raise RuntimeError(f"window {row} took no device search")
    finally:
        tdev.DeviceEnumerator.enumerate = orig
    return seen


def parent_lib(parent: str) -> ctypes.CDLL:
    """The parent checkout's enum_core.c, built as the port builds its
    cores, into this checkout's build/ folder."""
    import numpy as np

    out = os.path.join(ROOT, "build", "root_queue_cost")
    os.makedirs(out, exist_ok=True)
    so = os.path.join(out, "enum_core_parent.so")
    src = os.path.join(parent, "fplll_tpu_torch", "native", "enum_core.c")
    subprocess.run(["cc", "-O3", "-march=native", "-shared", "-fPIC", "-o",
                    so, src, "-lm"], check=True)
    lib = ctypes.CDLL(so)
    dptr = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.enum_gen_roots.restype = ctypes.c_int
    lib.enum_gen_roots.argtypes = [
        ctypes.c_int, dptr, dptr, ctypes.c_void_p, dptr,
        ctypes.c_double, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_long, ctypes.c_long, ctypes.c_int,
        dptr, ctypes.c_void_p, dptr, dptr,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_long)]
    return lib


def parent_pipeline(lib, scratch: dict, enum, mut, rdiag, prune, cp0, A,
                    is_svp):
    """The earlier expansion and pack of one primal window: ((xs, pd, m,
    nodes), tensors, expansion s, pack s)."""
    import numpy as np
    import torch

    cap, nfix_max = 1 << 19, 24
    d = len(rdiag)
    t0 = time.perf_counter()
    if "x" not in scratch:
        scratch.update(x=np.empty((cap, nfix_max)), pd=np.empty(cap))
    nodes = np.zeros(d)
    m_real, count = ctypes.c_int(0), ctypes.c_long(0)
    rc = lib.enum_gen_roots(
        d, mut, rdiag, prune.ctypes.data_as(ctypes.c_void_p), cp0, A,
        int(is_svp), 0, enum.max_device_levels,
        enum.target_root_factor * enum.batch, cap, nfix_max, scratch["x"],
        None, scratch["pd"], nodes, ctypes.byref(m_real),
        ctypes.byref(count))
    if rc != 0:
        raise RuntimeError("the parent's expansion declined a window")
    R, m = count.value, m_real.value
    xs, pd = scratch["x"][:R, :d - m].copy(), scratch["pd"][:R].copy()
    t1 = time.perf_counter()
    order = np.argsort(pd)
    rx, rpd = xs[order], pd[order]
    tree = enum._pack_tree(mut, rdiag, prune, cp0, d, m)
    tree.pop("m")
    nfix_pad = tree.pop("nfix_pad")
    R_pad = max(1024, enum.pin_R)
    while R_pad < R:
        R_pad *= 2
    host = dict(tree, roots_x=np.zeros((R_pad, nfix_pad)),
                roots_pd=np.full(R_pad, np.inf))
    host["roots_x"][:R, :d - m] = rx
    host["roots_pd"][:R] = rpd
    out = {k: torch.as_tensor(np.ascontiguousarray(a), dtype=enum.dtype)
           for k, a in host.items()}
    t2 = time.perf_counter()
    return (xs, pd, m, nodes), out, t1 - t0, t2 - t1


def quartiles(v: list) -> list:
    q = statistics.quantiles(v, n=4)
    return [q[0], statistics.median(v), q[2]]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", default="svpchal80-bkz2.b60-windows")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--parent", default=None)
    args = ap.parse_args(argv)
    os.environ["FPLLL_TORCH_DEVICE"] = "cpu"
    os.environ["FPLLL_TPU_HYBRID_NODES"] = "0"    # no first pass
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    t_start = time.perf_counter()
    wins = windows(args.cell)
    lib = parent_lib(args.parent) if args.parent else None
    scratch: dict = {}
    new = {"expand_ms": [], "pack_ms": [], "total_ms": []}
    old = {"expand_ms": [], "pack_ms": [], "total_ms": []}
    rows, nfixes, nbytes = [], [], []
    expansion_differs, queue_differs = [], []
    for w, (enum, a, kw) in enumerate(wins):
        mut, rdiag, prune, cp0, maxdist, is_svp = a[:6]
        d = len(rdiag)
        mut = np.ascontiguousarray(mut, dtype=np.float64)
        rdiag = np.ascontiguousarray(rdiag, dtype=np.float64)
        prune = np.ascontiguousarray(prune, dtype=np.float64)
        cp0 = np.ascontiguousarray(cp0, dtype=np.float64)
        A = float(maxdist)
        te, tp = [], []
        for _ in range(args.reps):
            enum.nodes = np.zeros(d, dtype=np.int64)
            t0 = time.perf_counter()
            xs, als, pd, m = enum._gen_roots(mut, rdiag, prune, cp0, A, d,
                                             is_svp)
            t1 = time.perf_counter()
            out = enum._pack(mut, rdiag, prune, cp0, d, xs, pd, m)
            t2 = time.perf_counter()
            te.append(t1 - t0)
            tp.append(t2 - t1)
        rows.append(len(pd))
        nfixes.append(d - m)
        nbytes.append(sum(t.nbytes for t in out.values()
                          if isinstance(t, torch.Tensor)))
        e, p = statistics.median(te) * 1e3, statistics.median(tp) * 1e3
        new["expand_ms"].append(e)
        new["pack_ms"].append(p)
        new["total_ms"].append(e + p)
        if lib is None:
            continue
        te, tp = [], []
        for _ in range(args.reps):
            ref, ref_out, e_s, p_s = parent_pipeline(
                lib, scratch, enum, mut, rdiag, prune, cp0, A, is_svp)
            te.append(e_s)
            tp.append(p_s)
        e, p = statistics.median(te) * 1e3, statistics.median(tp) * 1e3
        old["expand_ms"].append(e)
        old["pack_ms"].append(p)
        old["total_ms"].append(e + p)
        if not (ref[2] == m and np.array_equal(ref[0], xs) and
                np.array_equal(ref[1], pd) and
                np.array_equal(ref[3].astype(np.int64), enum.nodes)):
            expansion_differs.append(w)
        # the earlier sort was not stable: rows of equal pd may differ
        if not all(torch.equal(ref_out[k], out[k]) for k in ref_out):
            queue_differs.append(w)
    res = {"cell": args.cell, "windows": len(wins), "reps": args.reps,
           "seconds": time.perf_counter() - t_start,
           "rows": quartiles(rows), "rows_min": min(rows),
           "rows_max": max(rows), "nfix": quartiles(nfixes),
           "bytes_per_launch": quartiles(nbytes),
           "new": {k: quartiles(v) for k, v in new.items()}}
    if lib is not None:
        res["parent"] = {k: quartiles(v) for k, v in old.items()}
        res["expansion_differs"] = expansion_differs
        res["queue_differs"] = queue_differs
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
