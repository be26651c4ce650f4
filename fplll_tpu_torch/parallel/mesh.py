"""Sharded enumeration over several devices, driven by one process.

The port of the JAX package's parallel/mesh.py, the distributed layer
the reference does not have (SURVEY.md §2 #16: enumlib's shared-memory
protocol, one atomic shrinking bound and a work queue of subtree roots,
enum-parallel/enumeration.h:68-146, 412-505).

The JAX mesh is single-controller, one process holding every device, and
so is this one. A mesh is an ordered list of shards, each a
``torch.device``. A device may repeat: shards that share a card run on
streams of their own, the counterpart of the XLA host-platform virtual
mesh (CPU shards run one after another).

- Subtree roots are sorted by partial distance and dealt round-robin
  over the shards. Every shard holds the whole queue, so that any shard
  can walk any root a steal gives it.
- A sweep launches the enumeration kernel (:func:`kernels.enum_launch`)
  once per shard over the next slice of its root range, each shard on
  its own stream, before it reads any result (:func:`kernels.enum_collect`).
  The kernel is persistent and cannot stop a walker inside a root, so a
  sweep ends where a launch ends.
- Between sweeps the host does what the JAX mesh's collectives did (pmin
  of the bound, psum of the work flag and the counters, all_gather of
  three ints per shard): it takes the least bound over the shards (search
  mode; count mode keeps its radius), advances the cursors, trims roots
  the bound has killed, applies the work-stealing plan and stops when no
  shard has work. A stale bound is correct but wasteful, as in enumlib.

With the port's recorder on (:mod:`fplll_tpu_torch.trace`), each sweep is
one ``mesh.sweep`` span and leaves one list of shard records in the
snapshot's ``sweeps``: per launching shard its shard, form, roots,
nodes, steps, launch_to_collect_ms on the host clock and whether it
stole after the sweep; on a card also its device, kernel_ms and start_s /
end_s, the CUDA events around its launch call placed on the host clock.
A shard that launched nothing in the sweep (drained earlier) and stole
after it has {shard, stole: True}. On distinct cards the interval is the
kernel's run; on streams of one card it also holds the time a kernel
waits for SMs that another stream's persistent grid holds.
"""

from __future__ import annotations

import contextlib
import time
from typing import List, Optional

import numpy as np

from .. import trace
from ..enum.device import DeviceEnumerator
from ..enum.kernels import MAX_LEVELS, _K_TOP, _form, enum_collect, enum_launch
from ..native import native_pack_roots
from ..torchsetup import resolve_device, torch

__all__ = ["make_enum_mesh", "ShardedEnumerator"]

# a victim is robbed only while it holds at least this many roots
STEAL_MIN_ROOTS = 64
# a shard's slice grows at most this many times from one sweep to the
# next
GROW = 4

class MeshDecline(ValueError):
    """The documented refusals of :func:`mesh_enumerate_trials`: more
    trials than shards, or a window taller than the kernel."""


class EnumMesh:
    """The shards of a sharded enumeration: `devices`, one torch.device
    per shard (a device may repeat), and `size`."""

    def __init__(self, devices):
        self.devices: List[torch.device] = list(devices)
        self.size = len(self.devices)
        self._streams = {}

    @contextlib.contextmanager
    def on(self, shard: int):
        """Shard `shard`'s device and its own stream as the current ones
        (a card's shard), or nothing (a CPU shard)."""
        dev = self.devices[shard]
        if dev.type != "cuda":
            yield
            return
        stream = self._streams.get(shard)
        if stream is None:
            stream = self._streams[shard] = torch.cuda.Stream(device=dev)
        with torch.cuda.device(dev), torch.cuda.stream(stream):
            yield


def _shard_device(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda":
        index = torch.cuda.current_device() if dev.index is None \
            else dev.index
        if index >= torch.cuda.device_count():
            raise ValueError(f"no card {dev}: {torch.cuda.device_count()} "
                             "visible")
        dev = torch.device("cuda", index)
    return dev


def make_enum_mesh(n_devices: Optional[int] = None,
                   devices=None) -> EnumMesh:
    """A mesh over `devices`, each resolved as an entry point resolves
    its device (cuda without a card raises); a device may repeat. By
    default every visible card, cuda:0 ... cuda:k-1, or, where
    FPLLL_TORCH_DEVICE=cpu asks for the CPU, `n_devices` CPU shards (one
    if None). `n_devices` keeps the first n."""
    if devices is None:
        dev = resolve_device(None)
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())] \
            if dev.type == "cuda" else [dev] * (n_devices or 1)
    devices = [_shard_device(d) for d in devices]
    if n_devices is not None:
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return EnumMesh(devices)


def _steal_plan(cursor, own_end, n_dead):
    """Deterministic work rebalancing at a sweep boundary (the analogue
    of enumlib's work stealing, enum-parallel/enumeration.h:460-505), on
    the per-shard vectors the JAX mesh all_gathers: a drained shard with
    dead lanes (a thief, ranked by index) claims the second half of the
    remaining root range of the shard at its rank in the richest-first
    order of remainders (ties by index), if that one holds at least
    STEAL_MIN_ROOTS roots. Returns (new cursors, new ends, stole), one
    entry per shard."""
    cursor = np.asarray(cursor, dtype=np.int64)
    own_end = np.asarray(own_end, dtype=np.int64)
    n = len(cursor)
    rem = np.maximum(own_end - cursor, 0)
    thief = (rem == 0) & (np.asarray(n_dead) > 0)
    n_thieves = int(thief.sum())
    t_rank = np.cumsum(thief) - 1
    vidx = np.argsort(-rem, kind="stable")      # richest first, ties by index
    rank = np.clip(t_rank, 0, n - 1)
    victim = vidx[rank]
    stole = thief & (t_rank >= 0) & (rem[vidx][rank] >= STEAL_MIN_ROOTS)
    split_of = cursor + (rem - rem // 2)
    new_cursor = np.where(stole, split_of[victim], cursor)
    new_end = np.where(stole, own_end[victim], own_end)
    vpos = np.empty(n, dtype=np.int64)
    vpos[vidx] = np.arange(n)
    robbed = (vpos < n_thieves) & (rem >= STEAL_MIN_ROOTS)
    new_end = np.where(robbed, split_of, new_end)
    return new_cursor, new_end, stole


class _Shard:
    """One shard's tree on its device, its root range, and what its
    launches returned: per-level nodes, solutions, its K best candidates
    (sorted) and, under findsubsols, its per-level records."""

    def __init__(self, tensors: dict, m: int, m_real: int, pd: np.ndarray,
                 cursor: int, end: int, take: int, A_cap: float = np.inf):
        self.t, self.m, self.m_real = tensors, m, m_real
        # the queue's partial distances in the tree's element type, which
        # the kernel compares with the bound
        self.pd = pd
        self.cursor, self.end = cursor, end
        self.take, self.A_cap = take, A_cap
        self.nodes = np.zeros(m, dtype=np.int64)
        self.sol_count = 0
        nfixp = tensors["roots_x"].shape[1]
        self.bd = np.zeros(0)
        self.bdev = np.zeros((0, m))
        self.broot = np.zeros((0, nfixp))
        self.ss = None

    def launch(self, lo: int, hi: int, A: float, **kw) -> dict:
        t = self.t
        return enum_launch(
            t["mut"], t["rdiag"], t["prune"], t["mut_fix"], t["cp0"],
            t["roots_x"][lo:hi], t["roots_pd"][lo:hi], min(A, self.A_cap),
            m=self.m, m_real=self.m_real, max_steps=1 << 30,
            roots_a=t["roots_a"][lo:hi] if "roots_a" in t else None, **kw)

    def absorb(self, out: dict, K: int) -> int:
        """Fold one launch's results in; returns its nodes on the real
        levels."""
        nodes = out["nodes"].cpu().numpy().astype(np.int64)
        self.nodes += nodes
        self.sol_count += int(out["sol_count"])
        bd = out["best_dist"].double().cpu().numpy()
        found = np.isfinite(bd)
        if found.any():
            self.bd = np.concatenate([self.bd, bd[found]])
            self.bdev = np.concatenate(
                [self.bdev, out["best_dev"].double().cpu().numpy()[found]])
            self.broot = np.concatenate(
                [self.broot, out["best_root"].double().cpu().numpy()[found]])
            keep = np.argsort(self.bd, kind="stable")[:K]
            self.bd, self.bdev, self.broot = (self.bd[keep], self.bdev[keep],
                                              self.broot[keep])
        if "subsol_dist" in out:
            self.ss = _min_records(self.ss, [
                out[k].double().cpu().numpy()
                for k in ("subsol_dist", "subsol_vec", "subsol_root")])
        return int(nodes[:self.m_real].sum())

    def trim(self, A: float) -> None:
        """Drop the roots at the end of the range that the bound A has
        killed (the kernel would drain them on its first pop)."""
        A = self.pd.dtype.type(min(A, self.A_cap))
        pd = self.pd[self.cursor:self.end]
        self.end = self.cursor + int(np.searchsorted(pd, A, side="right"))


def _min_records(a, b):
    """Per level, the strictly smaller of two sub-solution records
    (dist (m,), vec (m, m), root (m, nfix)); the first on ties."""
    if a is None:
        return b
    upd = b[0] < a[0]
    return [np.where(upd, b[0], a[0]), np.where(upd[:, None], b[1], a[1]),
            np.where(upd[:, None], b[2], a[2])]


def _sweeps(mesh: EnumMesh, shards: List[_Shard], A: float, *, batch: int,
            steps: int, steal: bool, count_mode: bool, **kw):
    """Run every shard's range to its end in sweeps (see the module
    docstring); shard i of `shards` runs on mesh shard i. Returns (the
    final bound, sweeps, steals)."""
    K = min(batch, _K_TOP)
    sweeps = steals = 0
    while True:
        busy = [i for i, s in enumerate(shards) if s.cursor < s.end]
        if not busy:
            return A, sweeps, steals
        with trace.span("mesh.sweep"):
            A, stole = _sweep(mesh, shards, busy, A, K, batch=batch,
                              steps=steps, steal=steal,
                              count_mode=count_mode, **kw)
        sweeps += 1
        steals += int(stole.sum())


def _sweep(mesh: EnumMesh, shards: List[_Shard], busy: List[int], A: float,
           K: int, *, batch: int, steps: int, steal: bool, count_mode: bool,
           **kw):
    """One sweep over the `busy` shards; returns (the new bound, which
    shards stole after it)."""
    tracing = trace.on()
    launched = []
    for i in busy:
        s = shards[i]
        lo, hi = s.cursor, min(s.end, s.cursor + s.take)
        with mesh.on(i):
            t0 = time.perf_counter() if tracing else 0.0
            h = s.launch(lo, hi, A, batch=batch, count_mode=count_mode, **kw)
        launched.append((i, lo, hi, h, t0))
    rec, walks = [], []
    for i, lo, hi, h, t0 in launched:
        s = shards[i]
        with mesh.on(i):
            out = enum_collect(h)
            walks.append(int(out["steps"]))
            nodes = s.absorb(out, K)
        s.cursor = hi
        if tracing:
            rec.append({"shard": i, "form": _form(s.t["mut"].dtype,
                                                  kw.get("dual", False),
                                                  kw.get("findsubsols", False)),
                        "roots": hi - lo, "nodes": nodes, "steps": walks[-1],
                        "launch_to_collect_ms":
                            (time.perf_counter() - t0) * 1e3})
            if h.get("raw", {}).get("launch") is not None:
                rec[-1]["launch"] = h["raw"]["launch"]
    # the next slices fill the sweep: it lasts as long as its longest
    # walk (at least `steps`), so a shard whose slice walked less takes
    # proportionally more roots, at least `batch` (one per lane of the
    # plain version) and at most GROW times as many
    horizon = max([steps] + walks)
    for (i, lo, hi, *_), w in zip(launched, walks):
        shards[i].take = int(max(batch, min(
            GROW * (hi - lo), (hi - lo) * horizon // max(w, 1))))
    if not count_mode:
        A = min([A] + [float(s.bd[0]) for s in shards if len(s.bd)])
        for s in shards:
            s.trim(A)
    stole = np.zeros(len(shards), dtype=bool)
    if steal:
        cur, end, stole = _steal_plan([s.cursor for s in shards],
                                      [s.end for s in shards],
                                      np.full(len(shards), batch))
        for s, c, e in zip(shards, cur, end):
            s.cursor, s.end = int(c), int(e)
    if tracing:
        for r in rec:
            r["stole"] = bool(stole[r["shard"]])
        idle = set(np.flatnonzero(stole)) - {r["shard"] for r in rec}
        trace.record_sweep(rec + [{"shard": int(i), "stole": True}
                                  for i in sorted(idle)])
    return A, stole


def _queue(roots_x, roots_pd, nfixp: int, dtype, roots_a=None,
           stripes: int = 1):
    """The root queue sorted by partial distance (native_pack_roots:
    stable, ties in expansion order), in the tree's element type, which
    the kernel compares with the bound: roots_x (and, for a dual tree,
    roots_a) padded to nfixp columns, and roots_pd; dealt round-robin
    into `stripes` stripes laid one after another. Returns the queue and
    its partial distances."""
    R = len(roots_pd)
    host = np.float32 if dtype == torch.float32 else np.float64
    queue = {"roots_x": np.empty((R, nfixp), host),
             "roots_pd": np.empty(R, host)}
    if roots_a is not None:
        queue["roots_a"] = np.empty((R, nfixp), host)
    native_pack_roots(roots_x, roots_a, roots_pd, queue["roots_x"],
                      queue.get("roots_a"), queue["roots_pd"])
    if stripes > 1:
        deal = np.concatenate([np.arange(i, R, stripes)
                               for i in range(stripes)])
        queue = {k: v[deal] for k, v in queue.items()}
    return queue, queue["roots_pd"]


def _tree_dtype(dtype, default):
    """The tree's element type: the JAX package's names (its dd32 pairs
    are the card's f64) or a torch dtype."""
    if dtype is None:
        return default
    if dtype in ("float64", "dd32", torch.float64):
        return torch.float64
    if dtype in ("float32", torch.float32):
        return torch.float32
    raise ValueError(f"tree dtype float32, float64 or dd32, not {dtype}")


def _put(mesh: EnumMesh, shard: int, arrays: dict, dtype) -> dict:
    """Host arrays as tensors on the shard's device, made on its
    stream."""
    with mesh.on(shard):
        return {k: torch.as_tensor(np.ascontiguousarray(v), dtype=dtype,
                                   device=mesh.devices[shard])
                for k, v in arrays.items()}


class ShardedEnumerator:
    """Enumeration over a mesh: the counterpart of the JAX package's
    ShardedEnumerator, taken by the facade whenever more than one card
    is visible (the analogue of enumlib registering itself as the
    default external enumerator, enumerate_ext.cpp:34-38).

    `batch_per_device` and `steps_per_sweep` keep the JAX signature. A
    JAX sweep was `steps_per_sweep` lockstep steps of `batch_per_device`
    lanes per device, in which a device whose lanes held cheap roots
    moved further down its queue. Here a sweep is one launch per shard
    over a slice of its range: `batch_per_device` roots in the first
    sweep; then each slice is scaled by the sweep's length over the
    shard's own walk (a sweep lasts as long as its longest walk, and at
    least `steps_per_sweep` steps: lockstep steps of the plain version,
    the longest walker walk of the kernel), at least `batch_per_device`
    roots and at most GROW times the shard's last slice. So shards with
    cheap roots run ahead and, once drained, steal. The root queue holds
    target_root_factor (32) times batch_per_device times the mesh size
    roots, as the JAX helper's does. `batch_per_device` is also the plain version's lane count on
    CPU shards. dtype None is f64, as in JAX; the JAX package's "dd32"
    is f64 too. Counts: `launches` (class-wide, one per sharded search
    over one root batch), `nodes` per level, and, for the last
    enumerate, `last_steals` and `sweeps`."""

    launches = 0

    def __init__(self, mesh: EnumMesh, batch_per_device: int = 512,
                 steps_per_sweep: int = 2048,
                 max_device_levels: int = MAX_LEVELS, dtype=None):
        self.mesh = mesh
        self.n_dev = mesh.size
        self.batch_per_device = batch_per_device
        self.sync_steps = steps_per_sweep
        self.max_device_levels = max_device_levels
        self.dtype = _tree_dtype(dtype, torch.float64)
        # as DeviceEnumerator: an f32 bound gets a relative slack of 1e-5;
        # the facade asks for f32 only for pruned searches
        # (device.tree_dtype), since the f32 walk's distances drift past
        # that slack on unpruned trees
        self.bound_slack = 1.0 + 1e-5 if self.dtype == torch.float32 else 1.0
        self.nodes = np.zeros(0, dtype=np.int64)
        self.last_steals = self.sweeps = 0

    def enumerate(self, mut: np.ndarray, rdiag: np.ndarray,
                  prune: Optional[np.ndarray], cp0: np.ndarray,
                  maxdist: float, is_svp: bool, evaluator,
                  count_mode: bool = False, dual: bool = False):
        """DeviceEnumerator.enumerate's contract over the mesh. Returns
        (final maxdist, per-level node counts)."""
        d = len(rdiag)
        self.nodes = np.zeros(d, dtype=np.int64)
        self.last_steals = self.sweeps = 0
        mut = np.asarray(mut, dtype=np.float64)
        rdiag = np.asarray(rdiag, dtype=np.float64)
        prune_arr = (np.ones(d) if prune is None or len(prune) == 0
                     else np.asarray(prune, dtype=np.float64))
        cp0 = np.asarray(cp0, dtype=np.float64)
        findsubsols = bool(evaluator.findsubsols)
        host_subsols = {} if findsubsols else None
        helper = DeviceEnumerator(batch=self.batch_per_device * self.n_dev,
                                  max_device_levels=self.max_device_levels,
                                  device=self.mesh.devices[0],
                                  dtype=self.dtype)
        helper.nodes = self.nodes
        self._helper = helper
        roots_x, roots_a, roots_pd, m_real = helper._gen_roots(
            mut, rdiag, prune_arr, cp0, float(maxdist), d, is_svp,
            dual=dual, subsols=host_subsols,
            hard_cap=getattr(self, "deep_hard_cap", 1 << 22))
        args = (mut, rdiag, prune_arr, cp0, float(maxdist), maxdist, d,
                is_svp, evaluator, count_mode, dual, findsubsols,
                host_subsols, roots_x, roots_a, roots_pd, m_real)
        if m_real > self.max_device_levels:
            # trees taller than the kernel run through the chunked deep
            # path, every bounded slice over the mesh: the helper's
            # launch hook is rebound to _mesh_launch, whose positional
            # contract is DeviceEnumerator._launch's
            helper._launch = self._mesh_launch
            return helper._deep_enumerate(*args), self.nodes
        return self._mesh_launch(*args), self.nodes

    def _mesh_launch(self, mut, rdiag, prune, cp0, A, maxdist_in, d,
                     is_svp, evaluator, count_mode, dual, findsubsols,
                     host_subsols, roots_x, roots_a, roots_pd,
                     m_real) -> float:
        """One sharded search over one root batch (the positional
        contract of DeviceEnumerator._launch, so that the deep-tree
        slicer can drive either); returns the updated maxdist in the
        caller's scale."""
        ShardedEnumerator.launches += 1
        n = self.n_dev
        nfix = d - m_real
        tree = self._helper._pack_tree(mut, rdiag, prune, cp0, d, m_real)
        m, nfixp = tree.pop("m"), tree.pop("nfix_pad")
        m_real = min(m_real, m)
        # deal the sorted roots round-robin so that cheap and dear roots
        # spread over the shards; shard i starts on its own stripe
        R = len(roots_pd)
        starts = np.cumsum([0] + [len(range(i, R, n)) for i in range(n)])
        queue, pd = _queue(roots_x, roots_pd, nfixp, self.dtype,
                           roots_a if dual else None, stripes=n)
        shards = [_Shard(_put(self.mesh, i, {**tree, **queue}, self.dtype),
                         m, m_real, pd, int(starts[i]), int(starts[i + 1]),
                         self.batch_per_device) for i in range(n)]
        _, sweeps, steals = _sweeps(
            self.mesh, shards, A * self.bound_slack,
            batch=self.batch_per_device, steps=self.sync_steps, steal=True,
            count_mode=bool(count_mode), is_svp=bool(is_svp),
            dual=bool(dual), findsubsols=findsubsols)
        self.sweeps += sweeps
        self.last_steals += steals
        # levels m_real..m-1 are virtual bucket padding: drop their
        # artifact counters
        self.nodes[:m_real] += sum(s.nodes for s in shards)[:m_real]
        if findsubsols:
            ss = None
            for s in shards:
                ss = _min_records(ss, s.ss) if s.ss is not None else ss
            if ss is None:     # no launch: only the host's records
                ss = [np.full(m, np.inf), np.zeros((m, m)),
                      np.zeros((m, nfixp))]
            DeviceEnumerator._report_subsols(
                evaluator, dict(zip(("subsol_dist", "subsol_vec",
                                     "subsol_root"),
                                    map(torch.from_numpy, ss))),
                host_subsols, m_real, nfix)
        if count_mode:
            evaluator.sol_count += sum(s.sol_count for s in shards)
            return maxdist_in
        best = sorted(((float(dist), np.concatenate([dev[:m_real],
                                                     root[:nfix]]))
                       for s in shards
                       for dist, dev, root in zip(s.bd, s.bdev, s.broot)),
                      key=lambda t: t[0])
        maxdist_out = maxdist_in
        for dist, full in best[:max(evaluator.max_sols * 4, 8)]:
            maxdist_out = evaluator.eval_sol(list(full), dist, maxdist_out)
        return maxdist_out


def mesh_enumerate_trials(mesh: EnumMesh, muts, rdiags, prunes, maxdists,
                          batch_per_device: int = 256,
                          sync_steps: int = 1024,
                          target_root_factor: int = 8, dtype=None):
    """Enumerate G rerandomized trials of ONE window, one trial per mesh
    shard, sharing the shrinking bound: the mesh layout of the grouped
    launch (enum/device._grouped_device_windows). The host takes the
    least bound over the trials between sweeps; there is no stealing,
    since the stripes are different problems. All trials MUST be bases of
    the same lattice, their distances on one scale (one bound, many
    walkers: enum-parallel/enumeration.h:412-505). Shards beyond G stay
    idle.

    muts (G, d, d) transposed-upper mu per trial, rdiags/prunes (G, d),
    maxdists (G,) in one common normalized scale. The trees run in f64,
    as the JAX package's default (dtype None, float64 or its "dd32"), or
    in f32 with the window path's 1e-5 bound slack (float32). Each sweep
    is sized from the longest walk of a walker in the last one, which the
    kernel's donation shortens as it spreads a root over idle walkers;
    the sizing reads only that walk. Raises
    MeshDecline (a ValueError) when G exceeds the mesh size or a window
    is taller than the kernel. Returns (dists, sols, nodes): dists[g] the
    best squared distance of trial g's own walk (inf if its shard found
    nothing; another trial may still have won), sols (G, d) the
    coordinate vectors, nodes (G,) per-trial node counts (root expansion
    and device walk). `batch_per_device` and `sync_steps` size the sweeps
    as in ShardedEnumerator."""
    muts = np.asarray(muts, dtype=np.float64)
    rdiags = np.asarray(rdiags, dtype=np.float64)
    prunes = np.asarray(prunes, dtype=np.float64)
    maxdists = np.asarray(maxdists, dtype=np.float64)
    G, d, _ = muts.shape
    if G > mesh.size:
        raise MeshDecline(f"{G} trials > {mesh.size} mesh shards; batch the "
                          "trials")
    dtype = _tree_dtype(dtype, torch.float64)
    slack = 1.0 + 1e-5 if dtype == torch.float32 else 1.0
    helper = DeviceEnumerator(batch=batch_per_device,
                              target_root_factor=target_root_factor,
                              device=mesh.devices[0], dtype=dtype)
    cp0 = np.zeros(d)
    host_nodes = np.zeros(G, dtype=np.int64)
    shards, nfixs = [], []
    for g in range(G):
        A_g = float(maxdists[g]) * slack
        helper.nodes = np.zeros(d, dtype=np.int64)
        rx, _, rpd, m_real = helper._gen_roots(muts[g], rdiags[g], prunes[g],
                                               cp0, A_g, d, True)
        if m_real > helper.max_device_levels:
            raise MeshDecline("window taller than the kernel; use "
                              "per-trial deep enumeration instead")
        host_nodes[g] = int(helper.nodes.sum())
        tree = helper._pack_tree(muts[g], rdiags[g], prunes[g], cp0, d,
                                 m_real)
        m, nfixp = tree.pop("m"), tree.pop("nfix_pad")
        queue, pd = _queue(rx, rpd, nfixp, dtype)
        shards.append(_Shard(_put(mesh, g, {**tree, **queue}, dtype), m,
                             min(m_real, m), pd, 0, len(rpd),
                             batch_per_device, A_cap=A_g))
        nfixs.append(d - m_real)
    ShardedEnumerator.launches += 1
    _sweeps(mesh, shards, max(s.A_cap for s in shards),
            batch=batch_per_device, steps=sync_steps, steal=False,
            count_mode=False, is_svp=True)
    dists = np.full(G, np.inf)
    sols = np.zeros((G, d))
    nodes = np.zeros(G, dtype=np.int64)
    for g, (s, nfix) in enumerate(zip(shards, nfixs)):
        nodes[g] = host_nodes[g] + int(s.nodes[:s.m_real].sum())
        if len(s.bd):
            dists[g] = s.bd[0]
            sols[g] = np.concatenate([s.bdev[0][:s.m_real],
                                      s.broot[0][:nfix]])
    return dists, sols, nodes
