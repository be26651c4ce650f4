"""Batched enumeration on the card (the scale-out axis).

The port of the JAX package's enum/tpu.py. The search tree is split at
a host-chosen level into many subtree roots (generalizing enumlib's two
"swirl" levels, enum-parallel/enumlib_dim.cpp:40-45); the CUDA kernel of
:mod:`fplll_tpu_torch.enum.kernels` walks them, one warp per subtree
walker, popping roots from an on-device queue and sharing one shrinking
bound (the design of enumlib's walkers, enumeration.h:68-146, 412-505).

Zig-zag sibling stepping, SVP symmetry breaking, pruning bounds
(partdistbounds[i] = pruning[i] * A) and the node-per-level counters
follow the reference contracts (enumerate_base.h:79-172), so this
backend is interchangeable with the host oracle behind
fplll_tpu_torch.enum.api.

Trees run in f64 where the answer must be exact (every unpruned search,
and the error-bounded evaluators of the proved SVP/CVP solvers) and in
f32 where the search is pruned, a heuristic by design (tree_dtype);
primal or with the dual recurrence, and report per-level sub-solutions
on request. The JAX package's TPU stand-in for f64 (compensated f32
pairs) has no role on the card. Trees taller than the kernel's height
run through the chunked deep-tree search.
"""

from __future__ import annotations

import math
import os
import threading
from typing import Optional, Tuple

import numpy as np

from .. import trace
from ..native import native_pack_roots
from ..torchsetup import resolve_device, torch
from .evaluator import EVALSTRATEGY_FIRST_N_SOLUTIONS, Evaluator
from .kernels import MAX_LEVELS, enum_run, enum_run_grouped

__all__ = ["DeviceEnumerator", "device_external_enumerator",
           "device_enumerate_windows", "register_device_backend",
           "gh_tree_estimate", "auto_batch", "tree_dtype"]

_F32 = torch.float32
_F64 = torch.float64


class DeviceEnumerator:
    """Host side of the batched kernel: splits the tree, generates the
    subtree roots, merges lane solutions into the evaluator."""

    def __init__(self, batch: int = 1024, max_device_levels: int = MAX_LEVELS,
                 target_root_factor: int = 32, device=None, dtype=_F32):
        self.batch = batch
        self.max_device_levels = max_device_levels
        self.target_root_factor = target_root_factor
        self.device = resolve_device(device)
        # launch-geometry floors (height, fixed levels, queue length); the
        # BKZ window path sets them so that every window of a tour has
        # one launch shape
        self.pin_m = self.pin_nfix = self.pin_R = 0
        # the tree runs in f64 (as the reference runs every tree, nr.h:41)
        # or in f32 (pruned searches: tree_dtype). An f32 bound gets a
        # relative slack of 1e-5, which keeps the rounding of a vector's
        # own distance from pruning it at the bound, but the f32 walk is
        # not exact: on unpruned d = 56 windows its distances sat from
        # -5.4e-4 to +1.5e-4 off the f64 norms (NVIDIA H100), so a vector
        # that much shorter than the answer can be pruned or ranked below
        # it (tests/test_torch_f32_drift.py)
        if dtype not in (_F32, _F64):
            raise ValueError(f"tree dtype float32 or float64, not {dtype}")
        self.dtype = dtype
        self.bound_slack = 1.0 + 1e-5 if dtype == _F32 else 1.0
        self.nodes: np.ndarray = np.zeros(0, dtype=np.int64)

    # -- host-side root generation (layered top-tree expansion) -------------
    @trace.spanned("enum.roots")
    def _gen_roots(self, mut: np.ndarray, rdiag: np.ndarray,
                   prune: np.ndarray, cp0: np.ndarray, A: float,
                   d: int, is_svp: bool, dual: bool = False,
                   subsols: Optional[dict] = None, start=None,
                   hard_cap: int = 1 << 22
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
        """Expand the top of the tree level by level until enough subtree
        roots exist. Returns (root_x (R, d-m), root_a (R, d-m), root_pd
        (R,), m); root_x column j holds the coordinate of level m+j and
        root_a what it feeds the center sums (x, or alpha for dual).
        Top-level node counts accumulate into self.nodes; when subsols is
        a dict, per-level best partials found during expansion are
        recorded into it as level -> (dist, x-tail).

        `start` = (xs, als, pd, height) resumes expansion from an
        existing frontier whose columns hold levels [height, d) (the
        chunked deep-tree path re-expands bounded slices this way). The
        frontier never grows past hard_cap rows: above the kernel height
        the caller chunks and recurses (_deep_enumerate)."""
        target = self.target_root_factor * self.batch
        if subsols is None and start is None and hard_cap >= (1 << 22):
            # native expansion (enum_core.c): same layout and node counts
            # as the level loop below, which runs past its capacity and
            # for what it does not cover (sub-solutions, a start frontier)
            from ..native import native_gen_roots
            with trace.span("enum.roots.native"):
                out = native_gen_roots(mut, rdiag, prune, cp0, A, is_svp,
                                       dual, self.max_device_levels, target)
            if out is not None:
                trace.count("enum.frontier.native")
                xs, als, pd, m, nodes = out
                self.nodes[:d] += nodes.astype(np.int64)[:d]
                return xs, als, pd, m
        if start is None:
            xs = np.zeros((1, 0))
            als = np.zeros((1, 0))
            pd = np.zeros(1)
            zero_prefix = np.array([is_svp])
            lvl = d - 1
        else:
            xs, als, pd, height = start
            xs = np.ascontiguousarray(xs, dtype=np.float64)
            als = np.ascontiguousarray(als, dtype=np.float64)
            pd = np.ascontiguousarray(pd, dtype=np.float64)
            zero_prefix = (np.all(xs == 0.0, axis=1) if is_svp
                           else np.zeros(len(pd), dtype=bool))
            lvl = height - 1
        while lvl >= 1:
            m_cand = lvl + 1
            if m_cand <= self.max_device_levels and \
                    (xs.shape[0] >= target or m_cand <= 2 or
                     xs.shape[0] >= hard_cap):
                break
            if m_cand > self.max_device_levels and \
                    xs.shape[0] >= hard_cap:
                break   # hard memory bound: the caller chunks and recurses
            acc = als if dual else xs
            c = cp0[lvl] - (acc @ mut[lvl, lvl + 1:d] if acc.shape[1] else 0.0)
            c = np.asarray(c, dtype=np.float64) + np.zeros(xs.shape[0])
            room = prune[lvl] * A - pd
            w = np.sqrt(np.maximum(room, 0.0) / rdiag[lvl])
            lo = np.ceil(c - w).astype(np.int64)
            hi = np.floor(c + w).astype(np.int64)
            lo = np.where(zero_prefix, np.maximum(lo, 0), lo)
            cnt = np.maximum(hi - lo + 1, 0)
            if m_cand > self.max_device_levels and \
                    int(cnt.sum()) >= hard_cap:
                break   # would blow the hard bound
            self.nodes[lvl] += int(cnt.sum())
            idx = np.repeat(np.arange(xs.shape[0]), cnt)
            offs = (np.arange(len(idx)) -
                    np.repeat(np.cumsum(cnt) - cnt, cnt)) if len(idx) else \
                np.zeros(0, dtype=np.int64)
            xv = (lo[idx] + offs).astype(np.float64)
            a = xv - c[idx]
            pd = pd[idx] + a * a * rdiag[lvl]
            xs = np.concatenate([xv[:, None], xs[idx]], axis=1)
            als = np.concatenate([a[:, None], als[idx]], axis=1)
            zero_prefix = zero_prefix[idx] & (xv == 0)
            if subsols is not None and len(pd):
                nz = pd > 0.0
                if nz.any():
                    i = int(np.argmin(np.where(nz, pd, np.inf)))
                    prev = subsols.get(lvl)
                    if prev is None or pd[i] < prev[0]:
                        subsols[lvl] = (float(pd[i]), xs[i].copy())
            lvl -= 1
        m = lvl + 1
        keep = pd <= A
        trace.count("enum.frontier.python")
        # each level was prepended at column 0, so columns are already in
        # ascending level order m..d-1
        return xs[keep], als[keep], pd[keep], m

    # -- main entry ----------------------------------------------------------
    def enumerate(self, mut: np.ndarray, rdiag: np.ndarray,
                  prune: Optional[np.ndarray], cp0: np.ndarray, maxdist: float,
                  is_svp: bool, evaluator: Evaluator,
                  count_mode: bool = False,
                  dual: bool = False) -> Tuple[float, np.ndarray]:
        """Search the full tree over levels [0, d). All quantities are in
        the normalized scale of the caller (2^-normexp, like the extenum
        contract); for dual the caller passes the already-transformed
        (mu, rdiag) and un-reverses solutions. Returns (final maxdist,
        per-level node counts)."""
        d = len(rdiag)
        mut = np.asarray(mut, dtype=np.float64)
        rdiag = np.asarray(rdiag, dtype=np.float64)
        prune = (np.ones(d) if prune is None or len(prune) == 0
                 else np.asarray(prune, dtype=np.float64))
        cp0 = np.asarray(cp0, dtype=np.float64)
        self.nodes = np.zeros(d, dtype=np.int64)
        A = float(maxdist)
        findsubsols = bool(evaluator.findsubsols)
        host_subsols: Optional[dict] = {} if findsubsols else None
        roots_x, roots_a, roots_pd, m_real = self._gen_roots(
            mut, rdiag, prune, cp0, A, d, is_svp, dual=dual,
            subsols=host_subsols,
            hard_cap=getattr(self, "deep_hard_cap", 1 << 22))
        args = (mut, rdiag, prune, cp0, A, maxdist, d, is_svp, evaluator,
                count_mode, dual, findsubsols, host_subsols, roots_x,
                roots_a, roots_pd, m_real)
        if m_real > self.max_device_levels:
            return self._deep_enumerate(*args), self.nodes
        return self._launch(*args), self.nodes

    def _deep_enumerate(self, mut, rdiag, prune, cp0, A, maxdist_in, d,
                        is_svp, evaluator, count_mode, dual, findsubsols,
                        host_subsols, xs, als, pd, height) -> float:
        """Chunked deep-tree search for trees taller than the kernel
        height (the reference's in-core ceiling is dim 256,
        fplll's configure.ac:161-168): the over-tall frontier is
        processed depth-first in bounded slices, each slice re-expanded
        under a hard cap until its remaining height fits the device, and
        the shrinking bound is carried across slice launches. Peak host
        memory is bounded by the cap's rows per pending level."""
        md = float(maxdist_in)
        CH = 2048
        cap = 1 << 16
        self._deep_slices = 0     # diagnostics: launches via this path
        stack = [(xs, als, pd, height)]
        while stack:
            fx, fa, fpd, lh = stack.pop()
            bound = A if count_mode else min(A, md)
            live = fpd <= bound
            fx, fa, fpd = fx[live], fa[live], fpd[live]
            for i in range(0, len(fpd), CH):
                cx, ca, cpd = fx[i:i + CH], fa[i:i + CH], fpd[i:i + CH]
                rx, ra, rpd, m2 = self._gen_roots(
                    mut, rdiag, prune, cp0, bound, d, is_svp, dual=dual,
                    subsols=host_subsols, start=(cx, ca, cpd, lh),
                    hard_cap=cap)
                if m2 > self.max_device_levels:
                    if m2 == lh:
                        # no forward progress: this chunk's next level
                        # alone would blow the cap, and re-pushing the
                        # same frontier would loop forever. Split the
                        # chunk, or (one root) raise the cap up to a hard
                        # memory ceiling.
                        if len(cpd) > 1:
                            h = len(cpd) // 2
                            stack.append((cx[:h], ca[:h], cpd[:h], lh))
                            stack.append((cx[h:], ca[h:], cpd[h:], lh))
                            continue
                        cap2 = cap
                        while m2 == lh and cap2 < (1 << 22):
                            cap2 *= 4
                            rx, ra, rpd, m2 = self._gen_roots(
                                mut, rdiag, prune, cp0, bound, d, is_svp,
                                dual=dual, subsols=host_subsols,
                                start=(cx, ca, cpd, lh), hard_cap=cap2)
                        if m2 == lh:
                            raise MemoryError(
                                "deep-tree chunk cannot advance: one "
                                "subtree root expands past the host "
                                "memory ceiling at a single level")
                    stack.append((rx, ra, rpd, m2))
                else:
                    self._deep_slices += 1
                    md = self._launch(mut, rdiag, prune, cp0, bound, md,
                                      d, is_svp, evaluator, count_mode,
                                      dual, findsubsols, host_subsols,
                                      rx, ra, rpd, m2)
        return md

    def _pack_tree(self, mut, rdiag, prune, cp0, d, m_real) -> dict:
        """The device levels of one tree padded to the kernel buckets, on
        the host in f64: mut (m, m), rdiag, prune, cp0 (m,) and mut_fix
        (m, nfix_pad), with the padded height m and nfix_pad."""
        nfix = d - m_real
        # pad the device tree height to a bucket; virtual levels admit
        # exactly x = 0 (center 0, the rdiag sentinel kills any sibling:
        # 1e300 in f64, 1e30 in f32 where it must stay representable)
        m = min(max(((m_real + 7) // 8) * 8, self.pin_m),
                self.max_device_levels)
        mut_pad = np.zeros((m, m))
        mut_pad[:m_real, :m_real] = mut[:m_real, :m_real]
        rdiag_pad = np.full(m, 1e30 if self.dtype == _F32 else 1e300)
        rdiag_pad[:m_real] = rdiag[:m_real]
        prune_pad = np.ones(m)
        prune_pad[:m_real] = prune[:m_real]
        cp0_pad = np.zeros(m)
        cp0_pad[:m_real] = cp0[:m_real]
        nfix_pad = 0
        while nfix_pad < nfix:
            nfix_pad = 8 if nfix_pad == 0 else nfix_pad * 2
        nfix_pad = max(nfix_pad, self.pin_nfix)
        mut_fix_pad = np.zeros((m, nfix_pad))
        if nfix:
            mut_fix_pad[:m_real, :nfix] = mut[:m_real, m_real:d]
        return {"mut": mut_pad, "rdiag": rdiag_pad, "prune": prune_pad,
                "mut_fix": mut_fix_pad, "cp0": cp0_pad, "m": m,
                "nfix_pad": nfix_pad}

    @trace.spanned("enum.pack")
    def _pack(self, mut, rdiag, prune, cp0, d, roots_x, roots_pd,
              m_real, roots_a=None) -> dict:
        """Sort one root batch and pad it to the kernel buckets, in this
        enumerator's dtype: the tree's arrays and the root queue (stably
        sorted by pd, native_pack_roots) are written into the device's
        staging buffer and copied to the device at once. Returns the
        tensors of enum_run (views of that copy, on this enumerator's
        device) with the padded height m and the real height m_real;
        roots_a (what the roots feed the center sums under dual) rides
        along when given."""
        tree = self._pack_tree(mut, rdiag, prune, cp0, d, m_real)
        m, nfix_pad = tree.pop("m"), tree.pop("nfix_pad")
        # root queue padded to a power-of-two bucket (>= one batch);
        # padding roots are dead (+inf)
        R_pad = max(1024, self.pin_R)
        while R_pad < len(roots_pd):
            R_pad *= 2
        shapes = {k: a.shape for k, a in tree.items()}
        shapes["roots_x"] = (R_pad, nfix_pad)
        if roots_a is not None:
            shapes["roots_a"] = (R_pad, nfix_pad)
        shapes["roots_pd"] = (R_pad,)
        stage = _staging(self.device)
        with stage.lock:
            host = stage.views(shapes, self.dtype)
            for k, a in tree.items():
                host[k][...] = a
            native_pack_roots(roots_x, roots_a, roots_pd, host["roots_x"],
                              host.get("roots_a"), host["roots_pd"])
            with trace.span("enum.pack.h2d"):
                out = stage.copy_in()
        out.update(m=m, m_real=min(m_real, m))
        return out

    def _launch(self, mut, rdiag, prune, cp0, A, maxdist_in, d, is_svp,
                evaluator, count_mode, dual, findsubsols, host_subsols,
                roots_x, roots_a, roots_pd, m_real) -> float:
        """Run the device search over one root batch (one launch), merge
        the results into the evaluator; returns the updated maxdist in the
        caller's scale."""
        nfix = d - m_real
        self._last_m_real = m_real      # diagnostics: device tree height
        state = enum_run(**self._pack(mut, rdiag, prune, cp0, d, roots_x,
                                      roots_pd, m_real,
                                      roots_a if dual else None),
                         A0=A * self.bound_slack, is_svp=bool(is_svp),
                         count_mode=bool(count_mode), max_steps=1 << 30,
                         batch=self.batch, dual=bool(dual),
                         findsubsols=findsubsols)
        # levels m_real..m-1 are virtual bucket padding: every lane walks
        # them once per root (x=0 only), so their counters are artifacts
        upto = min(m_real, d)
        self.nodes[:upto] += state["nodes"].cpu().numpy()[:upto]
        bd = state["best_dist"].double().cpu().numpy()
        bdev = state["best_dev"].double().cpu().numpy()
        broot = state["best_root"].double().cpu().numpy()
        found = np.isfinite(bd)
        best_overall = [
            (float(bd[i]),
             np.concatenate([bdev[i][:m_real], broot[i][:nfix]]))
            for i in np.where(found)[0]]
        best_overall.sort(key=lambda t: t[0])

        if findsubsols:
            self._report_subsols(evaluator, state, host_subsols, m_real, nfix)

        maxdist_out = maxdist_in
        if count_mode:
            evaluator.sol_count += int(state["sol_count"])
            return maxdist_out
        for dist, full in best_overall[:max(evaluator.max_sols * 4, 8)]:
            maxdist_out = evaluator.eval_sol(list(full), dist, maxdist_out)
        return maxdist_out

    @staticmethod
    def _report_subsols(evaluator, state, host_subsols, m_real: int,
                        nfix: int) -> None:
        """Merge the device's per-level best partials (levels < m_real)
        with the host expansion's records (levels >= m_real) into the
        evaluator (reference: enumerate_base.cpp:203-207
        process_subsolution)."""
        ss_dist = state["subsol_dist"].double().cpu().numpy()
        ss_vec = state["subsol_vec"].double().cpu().numpy()
        ss_root = state["subsol_root"].double().cpu().numpy()
        for lvl in range(m_real):
            dist = float(ss_dist[lvl])
            if not np.isfinite(dist) or dist <= 0.0:
                continue
            full = np.concatenate([ss_vec[lvl][:m_real], ss_root[lvl][:nfix]])
            if not np.any(full):
                continue  # level never improved on the initial r_kk record
            evaluator.eval_sub_sol(lvl, [float(v) for v in full], dist)
        if host_subsols:
            for lvl, (dist, tail) in sorted(host_subsols.items()):
                full = [0.0] * lvl + [float(v) for v in tail]
                evaluator.eval_sub_sol(lvl, full, dist)


class _Staging:
    """One device's staging of launch inputs: a host buffer (pinned for
    a card), made at the device's first launch and grown when a launch
    needs more, into which _pack writes the inputs as 256-byte-aligned
    segments of one element type; one copy then moves them into a fresh
    block of the device's caching allocator, so that a launch still in
    flight keeps its own inputs. The host buffer is written under `lock`,
    after the event recorded behind the last copy out of it."""

    def __init__(self, device: torch.device):
        self.device = device
        self.lock = threading.Lock()
        self.host = torch.empty(0, dtype=torch.uint8)
        self.copied = None          # the CUDA event behind the last copy
        self.layout = None

    def views(self, shapes: dict, dtype) -> dict:
        """NumPy views of the host buffer of the given shapes and dtype,
        once the last copy out of it has ended; grows it when too
        small."""
        size = np.dtype(_NUMPY[dtype]).itemsize
        offs, n = {}, 0
        for k, shape in shapes.items():
            offs[k] = n
            n += -(-math.prod(shape) * size // _ALIGN) * _ALIGN
        if self.copied is not None:
            self.copied.synchronize()
            self.copied = None
        if self.host.numel() < n:
            self.host = torch.empty(max(n, 2 * self.host.numel()),
                                    dtype=torch.uint8,
                                    pin_memory=self.device.type == "cuda")
            trace.count("enum.stage.grown")
        self.layout = (n, offs, shapes, dtype)
        flat = self.host.numpy()[:n].view(_NUMPY[dtype])
        return {k: flat[o // size:o // size + math.prod(shapes[k])]
                .reshape(shapes[k]) for k, o in offs.items()}

    def copy_in(self) -> dict:
        """The segments of the last views() copied to the device in one
        copy; tensors of the same shapes viewing the device's block."""
        n, offs, shapes, dtype = self.layout
        card = torch.empty(n, dtype=torch.uint8, device=self.device)
        card.copy_(self.host[:n], non_blocking=True)
        if self.device.type == "cuda":
            self.copied = torch.cuda.Event()
            self.copied.record(torch.cuda.current_stream(self.device))
        flat, size = card.view(dtype), np.dtype(_NUMPY[dtype]).itemsize
        return {k: flat.as_strided(shapes[k], _strides(shapes[k]), o // size)
                for k, o in offs.items()}


_ALIGN = 256
_NUMPY = {_F32: np.float32, _F64: np.float64}
_STAGING: dict = {}
_STAGING_LOCK = threading.Lock()


def _strides(shape) -> tuple:
    """Row-major strides of `shape`, in elements."""
    out, step = [], 1
    for dim in reversed(shape):
        out.append(step)
        step *= dim
    return tuple(reversed(out))


def _staging(device: torch.device) -> _Staging:
    with _STAGING_LOCK:
        st = _STAGING.get(device)
        if st is None:
            st = _STAGING[device] = _Staging(device)
        return st


# ---------------------------------------------------------------------------
# Backend adapter for the enumeration facade (the extenum seam)
# ---------------------------------------------------------------------------
# Below this dimension the native sequential core beats the batched
# kernel; the facade falls back to the host oracle under this size. The
# value is the JAX package's, kept for parity until re-measured on the
# card.
_MIN_TPU_DIM = int(os.environ.get("FPLLL_TPU_MIN_ENUM_DIM", 34))


def gh_tree_estimate(rdiag, prune, A) -> float:
    """Gaussian-heuristic estimate of the bound-passing node count
    (the same level-volume sum bkz_core.c:enum_tree_estimate prices
    windows with). Depth j of the DFS fixes the TOP j coordinates, so
    the j-level count uses the LAST j Gram-Schmidt norms and the bound
    prune[d-j]*A."""
    rdiag = np.asarray(rdiag, dtype=np.float64)
    d = len(rdiag)
    pr = np.ones(d) if prune is None else np.asarray(prune, np.float64)
    ks = np.arange(1, d + 1)
    logs = 0.5 * np.cumsum(np.log(rdiag[::-1]))
    lv = (ks / 2.0) * np.log(np.pi * pr[::-1] * A) - \
        np.array([math.lgamma(k / 2.0 + 1.0) for k in ks]) - logs
    with np.errstate(over="ignore"):
        return float(0.5 * np.exp(np.minimum(lv, 700)).sum())


def auto_batch(est_nodes: float) -> int:
    """Lane-batch table carried over from the JAX package (B=4096 for
    trees estimated above 3e8 nodes, else 1024), kept for parity until it
    is re-measured on the card. FPLLL_TPU_BATCH overrides both."""
    from ..threads import _BATCH_ENV_SET, get_batch
    if _BATCH_ENV_SET:
        return get_batch()
    return 4096 if est_nodes > 3e8 else 1024


def _visible_mesh(device):
    """A mesh of every visible card when `device` is a card and more
    than one is visible, else None: where the facade and the window path
    look for a mesh (tests replace it to get CPU shards)."""
    if device.type != "cuda" or torch.cuda.device_count() < 2:
        return None
    from ..parallel.mesh import make_enum_mesh
    return make_enum_mesh()


def unpruned(prune) -> bool:
    """Whether a search prunes nothing: no coefficients, or all ones."""
    return prune is None or bool(np.all(np.asarray(prune) == 1.0))


def gh_squared(rdiag) -> float:
    """The squared Gaussian-heuristic length of a window's lattice, from
    its squared Gram-Schmidt norms: the expected squared length of its
    shortest vector."""
    d = len(rdiag)
    return math.exp(float(np.mean(np.log(rdiag))) -
                    2.0 * (d / 2.0 * math.log(math.pi) -
                           math.lgamma(d / 2.0 + 1.0)) / d)


def skips_first_pass(device, rdiag, prune, maxdist, gh2, budget,
                     certified=False) -> bool:
    """Whether the facade sends a search straight to the card, without
    its budgeted native first pass. The pass pays off only when it
    finishes the tree (no launch) or hands the card a much tighter bound;
    it can do neither for a pruned (f32) search on a card whose radius is
    already within 1.25 of the window's squared Gaussian heuristic `gh2`
    and whose tree is estimated past 2.5 times the budget (the C tour's
    own escalation factor, bkz_core.c), so there the card walks the
    whole tree from the root instead of after a host walk it repeats.
    Everything else keeps the pass: a CPU device (its card is the plain
    version), unpruned and certified searches, large radii (CVP), and
    trees the budget may finish."""
    return (device.type == "cuda" and tree_dtype(prune, certified) is _F32
            and maxdist <= 1.25 * gh2
            and gh_tree_estimate(rdiag, prune, maxdist) > 2.5 * budget)


def tree_dtype(prune, certified: bool = False):
    """The element type of one search's tree, fixed by what its caller
    needs: f64 where the answer must be exact, an unpruned search or a
    `certified` one (an error-bounded evaluator), as the reference runs
    every tree (nr/nr.h:41); f32 with the 1e-5 bound slack for a pruned
    search, which is a heuristic by design and whose answer BKZ accepts
    in exact integers."""
    return _F64 if certified or unpruned(prune) else _F32


def _make_enumerator(est_nodes: float = 0.0, device=None, dtype=_F32):
    """The device enumerator for the facade: the sharded enumerator over
    every card when more than one is visible (the JAX package's rule and
    its switch: FPLLL_TPU_MESH=0 keeps one card), else the single-card
    DeviceEnumerator."""
    from ..threads import get_batch
    batch = auto_batch(est_nodes) if est_nodes > 0 else get_batch()
    device = resolve_device(device)
    mesh = _visible_mesh(device) \
        if os.environ.get("FPLLL_TPU_MESH", "1") != "0" else None
    if mesh is not None:
        from ..parallel.mesh import ShardedEnumerator
        return ShardedEnumerator(mesh,
                                 batch_per_device=max(128, batch // mesh.size),
                                 dtype=dtype)
    return DeviceEnumerator(batch=batch, device=device, dtype=dtype)


def _unreverse_dual(evaluator) -> None:
    """Dual solutions come out in dual (reversed) coordinate order
    (enumerate.cpp:154-157 reverse_by_swap); sub-solutions stay as they
    are."""
    for i, (sdist, sol) in enumerate(evaluator.solutions):
        evaluator.solutions[i] = (sdist, sol[::-1])


def device_external_enumerator(gso, evaluator, first, last, fmaxdist,
                               fmaxdistexpo, target_coord, subtree, pruning,
                               dual, device=None):
    """Facade adapter: returns (new maxdist in caller scale, node counts)
    or None to decline (reference seam: enumerate_ext.cpp:50-200).
    `device` as for every entry point (torchsetup.resolve_device)."""
    from .evaluator import (EVALSTRATEGY_BEST_N_SOLUTIONS, CallbackEvaluator,
                            ErrorBoundedEvaluator)

    if last == -1:
        last = gso.d
    d = last - first
    if len(subtree) or d < _MIN_TPU_DIM or d > 1024:
        return None
    if dual and len(target_coord):
        return None  # CVP for dual undefined (enumerate.cpp:73)
    count_mode = getattr(evaluator, "eval_mode", 0) == 1  # EVALMODE_COUNT
    if not count_mode and (evaluator.max_sols > 32 or
                           evaluator.strategy ==
                           EVALSTRATEGY_FIRST_N_SOLUTIONS):
        # the kernel keeps one best per lane; large solution lists and
        # first-N semantics need the host oracle's exact bookkeeping
        return None

    from .cpu import EnumerationDyn  # local import to avoid cycles

    device = resolve_device(device)
    mut, rdiag, normexp = gso.export_mu_r(first, last)
    if dual:
        # reversed/inverted transform (enumerate.cpp:98-121): the tree then
        # runs the alpha-accumulating dual recurrence in the kernel
        normexp = -normexp
        rd = np.asarray(rdiag, dtype=np.float64)
        mu = np.asarray(mut, dtype=np.float64)
        rdiag = (1.0 / (rd * 2.0 ** (-2 * normexp)))[::-1].copy()
        mut = np.triu(-(mu.T)[::-1, ::-1], 1)
    maxdist = math.ldexp(fmaxdist, fmaxdistexpo - normexp)
    evaluator.set_normexp(normexp)
    is_svp = len(target_coord) == 0
    cp0 = np.zeros(d)
    if not is_svp:
        for i in range(d):
            cp0[i] = float(target_coord[i + first])

    prune = np.asarray(pruning, dtype=np.float64) if len(pruning) else None
    total_nodes = np.zeros(d, dtype=np.int64)
    gh2 = gh_squared(rdiag)
    certified = isinstance(evaluator, ErrorBoundedEvaluator)

    # Budgeted native-first hybrid: a window whose whole tree fits a few
    # milliseconds of the sequential C core never pays the device launch
    # latency; a bigger tree escalates to the batched kernel with the
    # native pass's tightened bound and incumbent carried over (the
    # crossover policy replacing enumlib's dim<=10 fallback,
    # fplll/enum-parallel/enumlib.cpp:93-105). A tree predictably past
    # the crossover goes straight to the card (skips_first_pass). The
    # default budgets are the JAX package's (2M with a card, 64M for the
    # CPU's plain version), kept until re-measured on the card.
    default_budget = 2_000_000 if device.type == "cuda" else 64_000_000
    hybrid_budget = int(os.environ.get("FPLLL_TPU_HYBRID_NODES",
                                       str(default_budget)))
    first_pass = not count_mode and hybrid_budget > 0 and \
        not evaluator.findsubsols and evaluator.max_sols == 1 and \
        evaluator.strategy == EVALSTRATEGY_BEST_N_SOLUTIONS and \
        not isinstance(evaluator, CallbackEvaluator)
    if first_pass and skips_first_pass(device, rdiag, prune, maxdist, gh2,
                                       hybrid_budget, certified):
        trace.count("first_pass.skipped")
    elif first_pass:
        from ..native import native_enumerate
        with trace.span("facade.first_pass"):
            out = native_enumerate(mut, rdiag, prune,
                                   cp0 if not is_svp else None,
                                   maxdist, is_svp, dual, False,
                                   node_budget=hybrid_budget)
        if out is not None:
            new_max, best_dist, best_x, _sc, cnodes, visited = out
            trace.count("first_pass.iters", visited)
            trace.count("first_pass.nodes", int(np.sum(cnodes)))
            total_nodes[:d] += np.asarray(cnodes).astype(np.int64)
            if best_x is not None:
                new_max = evaluator.eval_sol([float(v) for v in best_x],
                                             best_dist, new_max)
            maxdist = min(maxdist, new_max)
            if visited < hybrid_budget:     # full tree explored
                if dual and not evaluator.empty():
                    _unreverse_dual(evaluator)
                return math.ldexp(maxdist, normexp - fmaxdistexpo), \
                    total_nodes

    # If the top of the tree is too wide (typically a CVP bound of
    # sum r_ii), tighten the radius with a budgeted host dive first.
    if not count_mode and not dual and evaluator.empty():
        top_width = 2.0 * math.sqrt(max(maxdist, 0.0) / rdiag[d - 1]) + 1.0
        if top_width > 64.0:
            dyn = EnumerationDyn(gso, evaluator)
            newmax = dyn.enumerate(first, last, fmaxdist, fmaxdistexpo,
                                   target_coord, (), pruning, False, False,
                                   node_budget=2_000_000)
            maxdist = math.ldexp(newmax, fmaxdistexpo - normexp)

    # Gaussian-heuristic iterative deepening: when the caller's bound is far
    # beyond the expected solution distance (standalone CVP bounds of
    # sum r_ii), search a GH-sized ball first and grow on failure. Retrying
    # up to the original bound preserves completeness.
    trial = maxdist
    if not count_mode and maxdist > 4.0 * gh2:
        trial = min(gh2 / 16.0, maxdist)
    # f64 for every unpruned search and every certified one (the
    # error-bounded evaluators of the proved solvers): the f32 walk's
    # distances drift past its 1e-5 slack on unpruned trees, and the
    # evaluator ranks candidates by them. Pruned searches (BKZ windows)
    # keep f32. The JAX package's TPU stand-in for f64, compensated f32
    # pairs, has no role here.
    dtype = tree_dtype(prune, certified)
    while True:
        enum = _make_enumerator(gh_tree_estimate(rdiag, prune, trial),
                                device=device, dtype=dtype)
        new_maxdist, nodes = enum.enumerate(mut, rdiag, prune, cp0, trial,
                                            is_svp, evaluator,
                                            count_mode=count_mode, dual=dual)
        total_nodes[:len(nodes)] += nodes
        found = (not evaluator.empty()) and \
            math.ldexp(evaluator.begin()[0], -normexp) <= trial * 1.0000001
        if count_mode or found or trial >= maxdist:
            break
        trial = min(trial * 2.5, maxdist)
    if dual and not evaluator.empty():
        _unreverse_dual(evaluator)
    return math.ldexp(min(new_maxdist, trial), normexp - fmaxdistexpo), \
        total_nodes


def _pack_grouped(muts, rdiags, prunes, maxdists, device, batch: int):
    """Root queues and padded, stacked tensors of G window problems for
    enum_run_grouped. Each trial's roots come from the native expansion;
    G is padded to a power of two with dummy problems (A0 = 0, never
    writing the shared bound) and the queue to a stable length, so launch
    geometry stays the same across windows. Returns (tensors,
    per-trial m_real, host expansion nodes) or None when the tree is
    taller than the kernel."""
    G, d, _ = muts.shape
    m = ((d + 7) // 8) * 8
    if m > MAX_LEVELS:
        return None
    factor = int(os.environ.get("FPLLL_TPU_GROUP_ROOT_FACTOR", "16"))
    slack = 1.0 + 1e-5                 # f32 bound slack (DeviceEnumerator)
    cp0 = np.zeros(d)
    per_group = []
    host_nodes = 0.0
    nfix_max, R_max = 1, 128
    for g in range(G):
        enum = DeviceEnumerator(batch=batch, target_root_factor=factor,
                                device=device)
        enum.nodes = np.zeros(d, dtype=np.int64)
        A_g = float(maxdists[g]) * slack
        rx, _, rpd, m_real = enum._gen_roots(
            np.asarray(muts[g], np.float64), np.asarray(rdiags[g],
                                                        np.float64),
            np.asarray(prunes[g], np.float64), cp0, A_g, d, True)
        per_group.append((rx, rpd, m_real, A_g))
        host_nodes += float(enum.nodes.sum())
        nfix_max = max(nfix_max, d - m_real)
        R_max = max(R_max, len(rpd))
    G_pad = 2
    while G_pad < G:
        G_pad *= 2
    nfixp = 8
    while nfixp < nfix_max:
        nfixp *= 2
    R_pad = 32768
    while R_pad < R_max:
        R_pad *= 2
    mut_all = np.zeros((G_pad, m, m), np.float32)
    rdiag_all = np.full((G_pad, m), 1e30, np.float32)
    prune_all = np.ones((G_pad, m), np.float32)
    mut_fix_all = np.zeros((G_pad, m, nfixp), np.float32)
    rx_all = np.zeros((G_pad, R_pad, nfixp), np.float32)
    # sentinel pd for padded queue slots and dummy problems: a bound-dead
    # root drains the queue on the first pop
    rpd_all = np.full((G_pad, R_pad), 1e30, np.float32)
    A0s = np.zeros(G_pad, np.float32)
    mrs = np.full(G_pad, 2, np.int32)
    for g, (rx, rpd, m_real, A_g) in enumerate(per_group):
        nfix = d - m_real
        mut_all[g, :m_real, :m_real] = muts[g][:m_real, :m_real]
        rdiag_all[g, :m_real] = rdiags[g][:m_real]
        prune_all[g, :m_real] = prunes[g][:m_real]
        if nfix:
            mut_fix_all[g, :m_real, :nfix] = muts[g][:m_real, m_real:d]
        native_pack_roots(rx, None, np.where(np.isfinite(rpd), rpd, 1e30),
                          rx_all[g], None, rpd_all[g])
        rpd_all[g, len(rpd):] = 1e30
        A0s[g] = A_g
        mrs[g] = m_real

    def dev(a, dtype=_F32):
        return torch.as_tensor(a, dtype=dtype, device=device)

    tensors = {"mut": dev(mut_all), "rdiag": dev(rdiag_all),
               "prune": dev(prune_all), "mut_fix": dev(mut_fix_all),
               "cp0": dev(np.zeros((G_pad, m), np.float32)),
               "roots_x": dev(rx_all), "roots_pd": dev(rpd_all),
               "A0": dev(A0s), "m_real": dev(mrs, torch.int32)}
    return tensors, [pg[2] for pg in per_group], host_nodes


def _grouped_device_windows(muts, rdiags, prunes, maxdists, device):
    """All G trials in ONE launch: each trial's root queue is generated on
    the host (native expansion), the per-trial problems are stacked, and
    the kernel walks every trial's tree with one shared shrinking bound
    (the many-walkers analogue of
    fplll/enum-parallel/enumeration.h:412-505).

    CONTRACT: the G problems must be rerandomized bases of the SAME
    lattice block (which is what the native BKZ retrial loop produces):
    a solution found by any trial prunes all the others, so the caller
    keeps only the best trial; trials bounded out by a better sibling
    report inf.

    The launch is f32: its trials must be pruned (tree_dtype), which
    rerandomized trials are; it raises on an unpruned one.

    Returns (dists, sols, total_nodes) or None to decline (trees taller
    than the kernel; the caller runs the per-trial loop)."""
    G, d, _ = muts.shape
    if any(unpruned(p) for p in prunes):
        raise ValueError("the grouped launch runs pruned trials only; an "
                         "unpruned tree runs in f64 (tree_dtype)")
    B = int(os.environ.get("FPLLL_TPU_GROUP_BATCH", "1024"))
    packed = _pack_grouped(muts, rdiags, prunes, maxdists, device, B)
    if packed is None:
        return None
    tensors, m_reals, total_nodes = packed
    out = enum_run_grouped(**tensors, G_real=G, batch=B)
    dist_g = out["dist"].double().cpu().numpy()
    dev_g = out["dev"].cpu().numpy()
    root_g = out["root"].cpu().numpy()
    nodes = float(out["nodes"].sum())
    dists = np.full(G, np.inf)
    sols = np.zeros((G, d))
    total_nodes += nodes
    for g in range(G):
        if not np.isfinite(dist_g[g]):
            continue
        m_real = m_reals[g]
        dists[g] = dist_g[g]
        sols[g, :d] = np.concatenate([dev_g[g][:m_real],
                                      root_g[g][:d - m_real]])
    return dists, sols, total_nodes


def _scale_exponents(rdiags: np.ndarray) -> np.ndarray:
    """e[g] such that 2^e[g] * rdiags[g] is trial g in trial 0's scale.

    The C tour normalizes each trial by a power of two of its own (the
    largest r_ii's, bkz_core.c:export_window), so two trials of one
    window can differ in scale by a factor of 4 or more. They are bases
    of one lattice with one determinant, so the ratio is exact:
    e = (log2 det_0 - log2 det_g) / d, an even integer."""
    logdet = np.log2(rdiags).sum(axis=1)
    e = (logdet[0] - logdet) / rdiags.shape[1]
    if np.abs(e - np.rint(e)).max() > 1e-3:
        raise ValueError("grouped window trials must be bases of one "
                         f"lattice; their determinants differ ({e})")
    return np.rint(e)


def device_enumerate_windows(muts, rdiags, prunes, maxdists, device=None):
    """Enumerate G window problems on the card — the escalation target of
    the native BKZ loop (bkz_core.c window_enum_c).

    muts: (G, m, m) transposed-upper mu, rdiags/prunes: (G, m), maxdists:
    (G,), each trial in its own normalized scale. Returns (dists, sols,
    total_nodes) in those scales, dists[g] = inf when trial g found
    nothing.

    G > 1 are rerandomized trials of one window (bkz_core.c
    grouped_trials_c): they run in one scale, in one kernel launch with
    one shared bound (where that launch declines, one per card of a
    mesh; FPLLL_TPU_GROUPED_LAUNCH=0 runs them one by one instead), and
    only the trial holding the shortest vector reports, since the caller
    keeps one trial and compares the distances it gets as if they shared
    a scale. The C tour rerandomizes pruned windows only; an unpruned
    group skips the f32 grouped launch. Mirrors the facade's policies:
    the tree's dtype from its pruning (tree_dtype: f64 for an unpruned
    window, such as every window of HKZ; f32 with its 1e-5 slack and
    exact-integer acceptance upstream for a pruned one), GH iterative
    deepening for bounds far past the Gaussian heuristic.
    """
    device = resolve_device(device)
    muts = np.asarray(muts, dtype=np.float64)
    rdiags = np.asarray(rdiags, dtype=np.float64)
    prunes = np.asarray(prunes, dtype=np.float64)
    maxdists = np.asarray(maxdists, dtype=np.float64)
    G = muts.shape[0]
    if G == 1:
        return _trial_windows(muts, rdiags, prunes, maxdists, device)
    scale = np.exp2(_scale_exponents(rdiags))
    rdiags, maxdists = rdiags * scale[:, None], maxdists * scale
    out = None
    if os.environ.get("FPLLL_TPU_GROUPED_LAUNCH", "1") != "0":
        if not any(unpruned(p) for p in prunes):
            out = _grouped_device_windows(muts, rdiags, prunes, maxdists,
                                          device)
        if out is None:
            out = _mesh_grouped_windows(muts, rdiags, prunes, maxdists,
                                        device)
    if out is None:
        out = _trial_windows(muts, rdiags, prunes, maxdists, device)
    dists, sols, total_nodes = out
    only = np.full(G, np.inf)
    if np.isfinite(dists).any():
        g = int(np.argmin(dists))
        only[g] = dists[g] / scale[g]
    return only, sols, total_nodes


def _mesh_grouped_windows(muts, rdiags, prunes, maxdists, device):
    """The G trials one per card of a mesh (parallel/mesh.py
    mesh_enumerate_trials, the bound shared between sweeps), where the
    grouped launch declined and a mesh of at least two cards, and no
    fewer than G, is visible; FPLLL_TPU_MESH_TRIALS=0 turns it off. Same contract as
    _grouped_device_windows. Returns (dists, sols, total_nodes) or None
    to decline. Unlike the JAX package, which warns once and falls back
    to the trial loop on any failure, only the mesh's documented
    refusal declines: any other error raises."""
    if os.environ.get("FPLLL_TPU_MESH_TRIALS", "1") == "0":
        return None
    mesh = _visible_mesh(device)
    if mesh is None or mesh.size < 2 or muts.shape[0] > mesh.size:
        return None
    from ..parallel.mesh import MeshDecline, mesh_enumerate_trials
    try:
        dists, sols, nodes = mesh_enumerate_trials(mesh, muts, rdiags,
                                                   prunes, maxdists)
    except MeshDecline:
        return None     # a window taller than the kernel: the trial loop
    return dists, sols, float(nodes.sum())


def _trial_windows(muts, rdiags, prunes, maxdists, device):
    """The G problems one by one, each through a DeviceEnumerator (or the
    mesh's ShardedEnumerator) with the BKZ window path's launch geometry,
    in the dtype its pruning asks for (tree_dtype)."""
    from .evaluator import FastEvaluator

    G, m, _ = muts.shape
    dists = np.full(G, np.inf)
    sols = np.zeros((G, m))
    total_nodes = 0.0
    cp0 = np.zeros(m)
    for g in range(G):
        ev = FastEvaluator(nr_solutions=1)
        enum = _make_enumerator(
            gh_tree_estimate(rdiags[g], prunes[g], float(maxdists[g])),
            device=device, dtype=tree_dtype(prunes[g]))
        if isinstance(enum, DeviceEnumerator):
            # root factor and geometry pins of the JAX package's window
            # path (tpu.py:1211-1219): one launch geometry per window size
            enum.target_root_factor = int(os.environ.get(
                "FPLLL_TPU_WINDOW_ROOT_FACTOR", "16"))
            enum.pin_m = min(((m + 7) // 8) * 8, enum.max_device_levels)
            enum.pin_nfix = 16
            enum.pin_R = 32768
        maxdist = float(maxdists[g])
        gh2 = math.exp(float(np.mean(np.log(rdiags[g]))) -
                       2.0 * (m / 2.0 * math.log(math.pi) -
                              math.lgamma(m / 2.0 + 1.0)) / m)
        trial = maxdist
        if maxdist > 4.0 * gh2:
            trial = min(gh2 / 16.0, maxdist)
        while True:
            _, nodes = enum.enumerate(muts[g], rdiags[g], prunes[g], cp0,
                                      trial, True, ev)
            total_nodes += float(np.asarray(nodes).sum())
            found = (not ev.empty()) and ev.begin()[0] <= trial * 1.0000001
            if found or trial >= maxdist:
                break
            trial = min(trial * 2.5, maxdist)
        if not ev.empty():
            d0, x = ev.begin()
            dists[g] = d0
            sols[g, :len(x)] = x
    return dists, sols, total_nodes


def register_device_backend() -> None:
    from .api import set_external_enumerator
    set_external_enumerator(device_external_enumerator)
