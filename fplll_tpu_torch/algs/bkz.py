"""BKZ / BKZ-2.0 / self-dual BKZ / slide reduction.

Re-design of fplll/bkz.{h,cpp}: the main loop with
max-loops/max-time/auto-abort termination (bkz.cpp:522-672), tours =
sliding SVP window + terminal HKZ (bkz.cpp:360-441), svp_reduction =
size-reduce -> {rerandomize -> preprocessing (recursive tours) ->
GH-clamped radius -> pruned enumeration -> postprocess-insert} until the
success-probability budget is spent (bkz.cpp:274-358), solution
insertion without dependencies including the tree-GCD generic case
(bkz.cpp:103-272), dual tours for SD-BKZ (bkz.cpp:443-463), slide
reduction with potential-based termination (bkz.cpp:465-520),
rerandomization (bkz.cpp:43-80), auto-abort on slope stagnation
(bkz.cpp:800-809) and the GSO-shape JSON dump (bkz.cpp:728-798).

Control flow is host-side (cheap); the enumeration inside svp_reduction
runs on the batched CUDA kernel through the facade, and the native C
tour hands device-sized windows to it through a ctypes callback.
"""

from __future__ import annotations

import functools
import math
import sys
import time
from typing import List, Optional

from ..defs import (BKZ_AUTO_ABORT, BKZ_BOUNDED_LLL, BKZ_DUMP_GSO, BKZ_GH_BND,
                    BKZ_MAX_LOOPS, BKZ_MAX_TIME, BKZ_NO_LLL, BKZ_SD_VARIANT,
                    BKZ_SLD_RED, BKZ_VERBOSE, FT_DEFAULT, FT_DOUBLE,
                    FT_LONG_DOUBLE, FT_MPFR, FloatType, GSO_ROW_EXPO,
                    HKZ_VERBOSE, LLL_DEF_DELTA, LLL_DEF_ETA, LLL_DEFAULT,
                    RED_BKZ_LOOPS_LIMIT, RED_BKZ_TIME_LIMIT, RED_SUCCESS,
                    RedStatus, get_red_status_str)
from ..nr.rng import RandGen
from ..nr.fctx import get_ctx
from ..core.gso import MatGSO, MatGSOInterface, adjust_radius_to_gh_bound
from ..enum.api import Enumeration, registered_enumerator
from ..enum.evaluator import FastEvaluator
from ..ops.intmat import IntMat
from ..torchsetup import resolve_device
from .bkz_param import BKZParam, PruningParams, Strategy
from .lll import LLLReduction
from .wrapper import Wrapper, zeros_first, zeros_last

__all__ = ["BKZReduction", "BKZAutoAbort", "bkz_reduction", "hkz_reduction"]


class BKZAutoAbort:
    """Stop when the GSO slope stops improving (bkz.h:87, bkz.cpp:800-809)."""

    def __init__(self, m: MatGSOInterface, num_rows: int, start_row: int = 0):
        self.m = m
        self.old_slope = float("-inf")
        self.no_dec = -1
        self.num_rows = num_rows
        self.start_row = start_row

    def test_abort(self, scale: float = 1.0, max_no_dec: int = 5) -> bool:
        new_slope = -self.m.get_current_slope(self.start_row, self.num_rows)
        if self.no_dec == -1 or new_slope < scale * self.old_slope:
            self.no_dec = 0
        else:
            self.no_dec += 1
        self.old_slope = min(self.old_slope, new_slope) \
            if self.old_slope != float("-inf") else new_slope
        return self.no_dec >= max_no_dec


class BKZReduction:
    def __init__(self, m: MatGSOInterface, lll_obj: LLLReduction,
                 param: BKZParam, device=None):
        # the device of every window this reduction sends to the kernel:
        # cuda unless the caller asks for the CPU (torchsetup)
        self.device = resolve_device(device)
        self._cb_error: Optional[BaseException] = None
        self.status = RED_SUCCESS
        self.nodes = 0
        self.param = param
        self.m = m
        self.lll_obj = lll_obj
        self.algorithm = ""
        self.cputime_start = 0.0
        num_rows = m.d
        while num_rows > 0 and m.b_row_is_zero(num_rows - 1):
            num_rows -= 1
        self.num_rows = num_rows
        self.delta = param.delta
        self.evaluator = FastEvaluator()
        self.sld_potential = None

    # -- rerandomization (bkz.cpp:43-80) -------------------------------------
    def rerandomize_block(self, min_row: int, max_row: int, density: int) -> None:
        if max_row - min_row < 2:
            return
        rng = RandGen.get()
        niter = 4 * (max_row - min_row)
        for _ in range(niter):
            a = rng.randrange(max_row - min_row - 1) + min_row
            b = a
            while b == a:
                b = rng.randrange(max_row - min_row - 1) + min_row
            self.m.move_row(b, a)
        self.m.row_op_begin(min_row, max_row)
        for a in range(min_row, max_row - 2):
            for _ in range(density):
                b = rng.randrange(max_row - (a + 1) - 1) + a + 1
                if rng.randrange(2):
                    self.m._row_addmul_exact(a, b, 1)
                else:
                    self.m._row_addmul_exact(a, b, -1)
        self.m.row_op_end(min_row, max_row)

    # -- strategy selection (bkz.cpp:82-98) ----------------------------------
    def get_pruning(self, kappa: int, block_size: int,
                    par: BKZParam) -> PruningParams:
        strat = par.strategies[block_size]
        v, e = self.m.get_r_exp(kappa, kappa)
        max_dist = self.m.ctx.to_float(v)
        root_det = self.m.ctx.to_float(
            self.m.get_root_det(kappa, kappa + block_size))
        gh_max_dist = adjust_radius_to_gh_bound(max_dist, e, block_size,
                                                root_det, 1.0)
        return strat.get_pruning(max_dist * 2.0 ** e, gh_max_dist * 2.0 ** e)

    # -- native sub-basis reduction fast path ---------------------------------
    def _native_sub_reduce(self, end: int,
                           size_red_only: bool) -> tuple[int, bool] | None:
        """Run the native fast LLL / size reduction on basis rows [0, end)
        of the shared GSO, then resynchronize the float state. Returns
        (native status, basis_changed) or None when inapplicable.
        basis_changed is an exact comparison, NOT the native swap counter:
        the BKZ/slide termination heuristics key off "did a window change
        anything", and a from-scratch engine can report internal swaps on
        input it ultimately returns unchanged."""
        import os
        m = self.m
        if os.environ.get("FPLLL_TPU_NATIVE_LLL", "1") != "1":
            return None
        if not isinstance(m, MatGSO) or m.enable_transform or \
                m.enable_int_gram or type(m.ctx).__name__ != "F64Ctx":
            return None
        # prefix-clean memo: LLL/size reduction holds on every prefix of
        # a reduced prefix (the conditions only involve earlier rows), so
        # if the basis is untouched since a successful native pass over a
        # prefix >= end, nothing can have changed — skip the call. The
        # recursion otherwise re-asks this ~100k times per block-60 tour.
        ver = m.b.version
        clean_lll = getattr(self, "_clean_lll", (-1, -1))
        clean_sr = getattr(self, "_clean_sr", (-1, -1))
        if clean_lll[1] == ver and end <= clean_lll[0]:
            return 0, False
        if size_red_only and clean_sr[1] == ver and end <= clean_sr[0]:
            return 0, False
        from ..native import native_lll_fast
        from ..ops.intmat import IntMat
        sub = IntMat(data=m.b.a[:end])  # view: native writes through
        out = native_lll_fast(sub, None, self.lll_obj.delta,
                              self.lll_obj.eta, size_red_only=size_red_only,
                              report_changed=True)
        if out is None:
            return None
        st, changed = out
        if changed:
            m.b.version += 1     # the native core wrote through the view
        if st == 0:
            ver2 = m.b.version
            rec = (end, ver2)
            if size_red_only:
                if clean_sr[1] == ver2:
                    rec = (max(end, clean_sr[0]), ver2)
                self._clean_sr = rec
            else:
                if clean_lll[1] == ver2:
                    rec = (max(end, clean_lll[0]), ver2)
                self._clean_lll = rec
                if getattr(self, "_clean_sr", (-1, -1))[1] != ver2 or \
                        self._clean_sr[0] < rec[0]:
                    self._clean_sr = rec   # LLL-reduced implies size-reduced
        if changed:
            # resync: every row's GSO state may reference the changed
            # prefix; one blocked-Cholesky full recompute (ops/blockgso
            # via update_gso) replaces `end` runs of the row recurrence
            for i in range(m.d):
                m.invalidate_gso_row(i, 0)
            for i in range(end):
                m.update_bf(i)
                m.invalidate_gram_row(i)
            m.update_gso()
        else:
            # the Python engines leave rows [0, end) GSO-valid as a side
            # effect; downstream radius/root-det reads rely on it
            for i in range(end):
                if not m.update_gso_row(i):
                    return None     # numerical trouble: use the Python path
        return st, changed

    # -- preprocessing (bkz.cpp:100-126) -------------------------------------
    def svp_preprocessing(self, kappa: int, block_size: int,
                          param: BKZParam) -> bool:
        clean = True
        lll_start = kappa if (param.flags & BKZ_BOUNDED_LLL) else 0
        native_out = None
        # the native engine is kept out of the dual/slide variant tours:
        # their potential/progress heuristics assume one LLL engine's
        # deterministic tie-breaking throughout
        if lll_start == 0 and kappa + block_size >= 16 and \
                not getattr(self, "_variant_tour", False):
            native_out = self._native_sub_reduce(kappa + block_size,
                                                 size_red_only=False)
        if native_out is not None and native_out[0] == 0:
            if native_out[1]:
                clean = False
        else:
            if not self.lll_obj.lll(lll_start, lll_start,
                                    kappa + block_size, 0):
                raise RuntimeError(get_red_status_str(self.lll_obj.status))
            if self.lll_obj.n_swaps > 0:
                clean = False
        for bs in param.strategies[block_size].preprocessing_block_sizes:
            prepar = BKZParam(int(bs), param.strategies, LLL_DEF_DELTA,
                              BKZ_GH_BND)
            dummy = [self.num_rows]
            clean &= self.tour(0, dummy, prepar, kappa, kappa + block_size)
        return clean

    # -- solution insertion (bkz.cpp:128-272) --------------------------------
    def svp_postprocessing(self, kappa: int, block_size: int,
                           solution: List[float], dual: bool = False) -> bool:
        sol = [int(round(x)) for x in solution]
        nz_vectors = sum(1 for x in sol if x != 0)
        i_vector = -1
        for i in range(block_size - 1, -1, -1):
            if sol[i] != 0 and i_vector == -1 and abs(sol[i]) == 1:
                i_vector = i
        pos = kappa + block_size - 1 if dual else kappa
        m = self.m
        if nz_vectors == 1:
            m.move_row(kappa + i_vector, pos)
        elif i_vector != -1:
            sol_i = sol[i_vector]
            if dual:
                sol_i = -sol_i
                m.row_op_begin(kappa, kappa + block_size)
            else:
                m.row_op_begin(kappa + i_vector, kappa + i_vector + 1)
            for i in range(block_size):
                if sol[i] != 0 and i != i_vector:
                    if dual:
                        m._row_addmul_exact(kappa + i, kappa + i_vector,
                                            sol_i * sol[i])
                    else:
                        m._row_addmul_exact(kappa + i_vector, kappa + i,
                                            sol_i * sol[i])
            if dual:
                m.row_op_end(kappa, kappa + block_size)
            else:
                m.row_op_end(kappa + i_vector, kappa + i_vector + 1)
            m.move_row(kappa + i_vector, pos)
        else:
            self.svp_postprocessing_generic(kappa, block_size, sol, dual)
        return False

    def svp_postprocessing_generic(self, kappa: int, block_size: int,
                                   solution: List[int], dual: bool) -> bool:
        """Tree-based GCD insertion (bkz.cpp:199-272)."""
        m = self.m
        x = list(solution)
        d = block_size
        for i in range(d):
            if x[i] < 0:
                x[i] = -x[i]
                m.negate_row(i + kappa)
        m.row_op_begin(kappa, kappa + d)
        off = 1
        while off < d:
            k = d - 1
            while k - off >= 0:
                if not (x[k] == 0 and x[k - off] == 0):
                    if x[k] < x[k - off]:
                        x[k], x[k - off] = x[k - off], x[k]
                        m.row_swap(kappa + k - off, kappa + k)
                    while x[k - off] != 0:
                        while x[k - off] <= x[k]:
                            x[k] = x[k] - x[k - off]
                            if dual:
                                m._row_addmul_exact(kappa + k, kappa + k - off, -1)
                            else:
                                m._row_addmul_exact(kappa + k - off, kappa + k, 1)
                        x[k], x[k - off] = x[k - off], x[k]
                        m.row_swap(kappa + k - off, kappa + k)
                k -= 2 * off
            off *= 2
        m.row_op_end(kappa, kappa + d)
        if not dual:
            m.move_row(kappa + d - 1, kappa)
        return False

    def _size_reduce_prefix(self, end: int) -> None:
        """Size-reduce basis rows [0, end): native core when the prefix is
        big enough to amortize the resync, Python engine otherwise."""
        out = self._native_sub_reduce(end, size_red_only=True) \
            if end >= 32 and not getattr(self, "_variant_tour", False) \
            else None
        if out is not None and out[0] == 0:
            return
        if not self.lll_obj.size_reduction(0, end, 0):
            raise RuntimeError(get_red_status_str(self.lll_obj.status))

    # -- one SVP window (bkz.cpp:274-358) ------------------------------------
    def svp_reduction(self, kappa: int, block_size: int, par: BKZParam,
                      dual: bool = False) -> bool:
        first = kappa + block_size - 1 if dual else kappa
        self._size_reduce_prefix(first + 1)
        ctx = self.m.ctx
        v, old_first_expo = self.m.get_r_exp(first, first)
        old_first = ctx.to_float(v)

        rerandomize = False
        remaining_probability = 1.0

        while remaining_probability > 1.0 - par.min_success_probability:
            if rerandomize:
                self.rerandomize_block(kappa + 1, kappa + block_size,
                                       par.rerandomization_density)
            self.svp_preprocessing(kappa, block_size, par)

            v, max_dist_expo = self.m.get_r_exp(first, first)
            max_dist = ctx.to_float(v)
            if dual:
                max_dist = 1.0 / max_dist
                max_dist_expo = -max_dist_expo
            max_dist *= self.delta

            if (par.flags & BKZ_GH_BND) and block_size > 30:
                root_det = ctx.to_float(
                    self.m.get_root_det(kappa, kappa + block_size))
                max_dist = adjust_radius_to_gh_bound(
                    max_dist, max_dist_expo, block_size, root_det,
                    par.gh_factor)

            pruning = self.get_pruning(kappa, block_size, par)

            self.evaluator.solutions.clear()
            self.evaluator.sol_count = 0
            enum_obj = Enumeration(self.m, self.evaluator,
                                   external=self._facade_enumerator())
            enum_obj.enumerate(kappa, kappa + block_size, max_dist,
                               max_dist_expo, pruning=pruning.coefficients,
                               dual=dual)
            self.nodes += enum_obj.get_nodes()

            if not self.evaluator.empty():
                _, sol = self.evaluator.begin()
                self.svp_postprocessing(kappa, block_size, sol, dual)
                rerandomize = False
            else:
                rerandomize = True
            remaining_probability *= (1.0 - pruning.expectation)

        self._size_reduce_prefix(first + 1)
        v, new_first_expo = self.m.get_r_exp(first, first)
        new_first = ctx.to_float(v) * 2.0 ** (new_first_expo - old_first_expo)
        return (old_first >= new_first) if dual else (old_first <= new_first)

    # -- native tour fast path (bkz_core.c) ----------------------------------
    def _native_tour(self, par: BKZParam, min_row: int,
                     max_row: int) -> bool | None:
        """Run one full plain tour (trunc_tour + terminal HKZ) in the
        native C engine over the limb basis, resynchronizing the Python
        GSO state afterwards. Returns the clean flag, or None when the
        native engine is inapplicable/unavailable (callers fall through
        to the Python engines)."""
        import os
        m = self.m
        if os.environ.get("FPLLL_TPU_NATIVE_BKZ", "1") != "1" or \
                os.environ.get("FPLLL_TPU_NATIVE_LLL", "1") != "1":
            return None
        if getattr(self, "_variant_tour", False):
            return None
        if not isinstance(m, MatGSO) or m.enable_transform or \
                m.enable_int_gram or type(m.ctx).__name__ != "F64Ctx":
            return None
        if par.flags & BKZ_BOUNDED_LLL:
            return None
        if par.block_size < 2 or max_row - min_row < 4 or max_row > m.d:
            return None
        from ..native import native_bkz_tour, pack_strategies
        pack = getattr(par, "_native_strat_pack", None)
        if pack is None or getattr(par, "_native_strat_src", None) \
                is not par.strategies:
            pack = pack_strategies(par.strategies)
            par._native_strat_pack = pack
            par._native_strat_src = par.strategies
        cb = getattr(self, "_native_enum_cb", None)
        if cb is None:
            cb = self._make_native_enum_cb()
            self._native_enum_cb = cb
        # crossover + device-eligibility policy: below _MIN_TPU_DIM the
        # sequential core always wins; above it, the C loop routes windows
        # whose GH tree estimate exceeds this budget straight to the
        # device (and batches escalation-worthy retrials into grouped
        # launches when k*est exceeds it). The defaults are the JAX
        # package's (60M estimated nodes with a device, 2e9 for the CPU's
        # plain version), kept until the crossover is re-measured on the
        # card.
        from ..enum.device import _MIN_TPU_DIM
        default_budget = 60_000_000 if self.device.type == "cuda" \
            else 2_000_000_000
        budget = int(os.environ.get("FPLLL_TPU_HYBRID_NODES",
                                    str(default_budget)))
        out = native_bkz_tour(
            m.b, pack, lll_delta=self.lll_obj.delta, lll_eta=self.lll_obj.eta,
            radius_delta=self.delta, block_size=par.block_size,
            flags=par.flags, gh_factor=par.gh_factor,
            min_succ=par.min_success_probability,
            density=par.rerandomization_density,
            hybrid_budget=budget, min_device_dim=_MIN_TPU_DIM,
            trial_batch_max=int(os.environ.get("FPLLL_TPU_TRIAL_BATCH", "8")),
            seed=RandGen.get().getrandbits(64),
            min_row=min_row, max_row=max_row, enum_cb=cb)
        err, self._cb_error = self._cb_error, None
        if err is not None:
            # the C tour aborted because a device window failed: fail the
            # run instead of letting the Python engines redo the tour
            raise err
        if out is None:
            return None
        status, nodes, n_swaps, clean, changed = out
        self.nodes += int(nodes)
        t = native_bkz_tour.last_timers
        self.dev_nodes = getattr(self, "dev_nodes", 0) + int(t["dev_nodes"])
        self.g_max = max(getattr(self, "g_max", 0), int(t["g_max"]))
        acc = getattr(self, "native_timers", None)
        if acc is None:
            acc = self.native_timers = {}
        for key in ("enum_s", "device_s", "lll_s", "misc_s", "babai_s",
                    "move_s"):
            acc[key] = acc.get(key, 0.0) + float(t[key])
        if changed:
            m.b.version += 1
            self._clean_lll = (-1, -1)
            self._clean_sr = (-1, -1)
            for i in range(m.d):
                m.invalidate_gso_row(i, 0)
            for i in range(m.d):
                m.update_bf(i)
                m.invalidate_gram_row(i)
            m.update_gso()
        if status != 0:
            return None     # python redoes the tour from the current basis
        return bool(clean)

    def _make_native_enum_cb(self):
        """Build the ctypes callback handing device-sized window
        enumerations from the C loop to the batched kernel. An exception
        cannot cross the C frames: it is stored, the callback returns -1
        (the C tour aborts) and _native_tour re-raises it."""
        import numpy as np

        from ..enum.device import device_enumerate_windows
        from ..native import ENUM_DEV_CB

        def cb(G, m_dim, mut_p, rdiag_p, prune_p, maxdist_p, sol_p, dist_p,
               nodes_p):
            try:
                mut = np.ctypeslib.as_array(mut_p, (G, m_dim, m_dim))
                rdiag = np.ctypeslib.as_array(rdiag_p, (G, m_dim))
                prune = np.ctypeslib.as_array(prune_p, (G, m_dim))
                maxd = np.ctypeslib.as_array(maxdist_p, (G,))
                dists, sols, nodes = device_enumerate_windows(
                    mut, rdiag, prune, maxd, device=self.device)
                np.ctypeslib.as_array(sol_p, (G, m_dim))[:] = sols
                np.ctypeslib.as_array(dist_p, (G,))[:] = dists
                nodes_p[0] = float(nodes)
                return 0
            except BaseException as e:  # noqa: BLE001 - re-raised after C
                self._cb_error = e
                return -1

        return ENUM_DEV_CB(cb)

    # -- tours (bkz.cpp:360-520) ---------------------------------------------
    def tour(self, loop: int, kappa_max: List[int], par: BKZParam,
             min_row: int, max_row: int) -> bool:
        clean = self._native_tour(par, min_row, max_row)
        if clean is None:
            clean = True
            clean &= self.trunc_tour(kappa_max, par, min_row, max_row)
            clean &= self.hkz(kappa_max, par,
                              max(max_row - par.block_size, 0), max_row)
        if par.flags & BKZ_VERBOSE:
            self.print_tour(loop, min_row, max_row)
        if par.flags & BKZ_DUMP_GSO:
            self.dump_gso(par.dump_gso_filename, True, "End of BKZ loop", loop,
                          time.time() - self.cputime_start)
        if self.m.enable_int_gram:
            self.m.symmetrize_g()
        return clean

    def trunc_tour(self, kappa_max: List[int], par: BKZParam, min_row: int,
                   max_row: int) -> bool:
        clean = True
        block_size = par.block_size
        for kappa in range(min_row, max_row - block_size):
            clean &= self.svp_reduction(kappa, block_size, par)
            if (par.flags & BKZ_VERBOSE) and kappa_max[0] < kappa and clean:
                print(f"Block [1-{kappa + 1:4}] BKZ-{par.block_size} reduced "
                      "for the first time", file=sys.stderr)
                kappa_max[0] = kappa
        return clean

    def trunc_dtour(self, par: BKZParam, min_row: int, max_row: int) -> bool:
        clean = True
        for kappa in range(max_row - par.block_size, min_row, -1):
            clean &= self.svp_reduction(kappa, par.block_size, par, dual=True)
        return clean

    def hkz(self, kappa_max: List[int], param: BKZParam, min_row: int,
            max_row: int) -> bool:
        clean = True
        for kappa in range(min_row, max_row - 1):
            block_size = max_row - kappa
            clean &= self.svp_reduction(kappa, block_size, param)
            if (param.flags & BKZ_VERBOSE) and kappa_max[0] < kappa and clean:
                print(f"Block [1-{kappa + 1:4}] BKZ-{param.block_size} reduced "
                      "for the first time", file=sys.stderr)
                kappa_max[0] = kappa
        # stall fix for fpylll issue 73 (bkz.cpp:435-438;
        # regression basis tests/lattices/stalling_93_53.txt)
        self.lll_obj.size_reduction(max_row - 1, max_row, max_row - 2)
        return clean

    def sd_tour(self, loop: int, par: BKZParam, min_row: int,
                max_row: int) -> bool:
        dummy = [self.num_rows]
        clean = True
        self._variant_tour = True
        try:
            clean &= self.trunc_dtour(par, min_row, max_row)
            clean &= self.trunc_tour(dummy, par, min_row, max_row)
        finally:
            self._variant_tour = False
        if par.flags & BKZ_VERBOSE:
            self.print_tour(loop, min_row, max_row)
        if par.flags & BKZ_DUMP_GSO:
            self.dump_gso(par.dump_gso_filename, True, "End of SD-BKZ loop",
                          loop, time.time() - self.cputime_start)
        return clean

    def slide_tour(self, loop: int, par: BKZParam, min_row: int,
                   max_row: int) -> bool:
        self._variant_tour = True
        try:
            return self._slide_tour(loop, par, min_row, max_row)
        finally:
            self._variant_tour = False

    def _slide_tour(self, loop: int, par: BKZParam, min_row: int,
                    max_row: int) -> bool:
        p = (max_row - min_row) // par.block_size
        if (max_row - min_row) % par.block_size:
            p += 1
        while True:
            clean = True
            for i in range(p):
                kappa = min_row + i * par.block_size
                block_size = min(max_row - kappa, par.block_size)
                clean &= self.svp_reduction(kappa, block_size, par)
            if par.flags & BKZ_BOUNDED_LLL:
                if not self.lll_obj.lll(min_row, min_row, max_row, 0):
                    raise RuntimeError(get_red_status_str(self.lll_obj.status))
                if self.lll_obj.n_swaps > 0:
                    clean = False
            if clean:
                break
        for i in range(p - 1):
            kappa = min_row + i * par.block_size + 1
            self.svp_reduction(kappa, par.block_size, par, dual=True)

        new_potential = self.m.get_slide_potential(min_row, max_row,
                                                   par.block_size)
        if par.flags & BKZ_VERBOSE:
            self.print_tour(loop, min_row, max_row)
        if par.flags & BKZ_DUMP_GSO:
            self.dump_gso(par.dump_gso_filename, True, "End of SLD loop", loop,
                          time.time() - self.cputime_start)
        if self.sld_potential is not None and \
                self.m.ctx.to_float(new_potential) >= \
                self.m.ctx.to_float(self.sld_potential):
            return True
        self.sld_potential = new_potential
        return False

    # -- main loop (bkz.cpp:522-672) -----------------------------------------
    def _facade_enumerator(self):
        """The facade's scale-out enumerator for this reduction's windows:
        the registered one, with this reduction's device bound in when it
        is the default device backend."""
        from ..enum.device import device_external_enumerator
        fn = registered_enumerator()
        if fn is device_external_enumerator:
            return functools.partial(fn, device=self.device)
        return fn

    def bkz(self) -> bool:
        param = self.param
        flags = param.flags
        final_status = RED_SUCCESS
        self.nodes = 0
        sd = bool(flags & BKZ_SD_VARIANT)
        sld = bool(flags & BKZ_SLD_RED)
        self.algorithm = "SD-BKZ" if sd else ("SLD" if sld else "BKZ")
        if sd and sld:
            raise ValueError("SD-BKZ and slide reduction are exclusive")
        if flags & BKZ_DUMP_GSO:
            self.dump_gso(param.dump_gso_filename, False, "Input", -1, 0.0)
        if param.block_size < 2:
            return self.set_status(RED_SUCCESS)

        auto_abort = BKZAutoAbort(self.m, self.num_rows)
        if sd and not (flags & (BKZ_MAX_LOOPS | BKZ_MAX_TIME | BKZ_AUTO_ABORT)):
            print("Warning: SD-BKZ requires a termination condition. "
                  "Turning auto abort on!", file=sys.stderr)
            flags |= BKZ_AUTO_ABORT

        if flags & BKZ_VERBOSE:
            print(f"Entering {self.algorithm}: block size {param.block_size}",
                  file=sys.stderr)
        self.cputime_start = time.time()

        for i in range(self.m.d):
            if i >= self.m.n_known_rows:
                self.m.discover_row()

        if sld:
            self.m.update_gso()
            self.sld_potential = self.m.get_slide_potential(
                0, self.num_rows, param.block_size)
        if sd:
            self.lll_obj.lll(0, 0, self.num_rows, 0)

        kappa_max = [-1]
        i = 0
        while True:
            if (flags & BKZ_MAX_LOOPS) and i >= param.max_loops:
                final_status = RED_BKZ_LOOPS_LIMIT
                break
            if (flags & BKZ_MAX_TIME) and \
                    time.time() - self.cputime_start >= param.max_time:
                final_status = RED_BKZ_TIME_LIMIT
                break
            if (flags & BKZ_AUTO_ABORT) and auto_abort.test_abort(
                    param.auto_abort_scale, param.auto_abort_max_no_dec):
                break
            if sd:
                clean = self.sd_tour(i, param, 0, self.num_rows)
            elif sld:
                clean = self.slide_tour(i, param, 0, self.num_rows)
            else:
                clean = self.tour(i, kappa_max, param, 0, self.num_rows)
            i += 1
            ckpt = getattr(param, "checkpoint_file", None)
            if ckpt and hasattr(self.m, "b"):
                from ..utils.checkpoint import save_checkpoint
                save_checkpoint(ckpt, self.m.b, getattr(self.m, "u", None),
                                {"loop": i, "nodes": self.nodes,
                                 "algorithm": self.algorithm,
                                 "elapsed": time.time() - self.cputime_start})
            if clean or param.block_size >= self.num_rows:
                break

        dummy = [self.num_rows]
        if sd:
            self.hkz(dummy, param, self.num_rows - param.block_size,
                     self.num_rows)
        if sld:
            p = self.num_rows // param.block_size
            if self.num_rows % param.block_size:
                p += 1
            for j in range(p):
                kappa = j * param.block_size + 1
                end = min(self.num_rows, kappa + param.block_size - 1)
                self.hkz(dummy, param, kappa, end)
        if flags & BKZ_DUMP_GSO:
            self.dump_gso(param.dump_gso_filename, True, "Output", -1,
                          time.time() - self.cputime_start)
        return self.set_status(final_status)

    # -- reporting (bkz.cpp:674-798) -----------------------------------------
    def print_tour(self, loop: int, min_row: int, max_row: int) -> None:
        v, e = self.m.get_r_exp(min_row, min_row)
        r0 = self.m.ctx.to_float(v) * 2.0 ** e
        print(f"End of {self.algorithm} loop {loop:4}, time = "
              f"{time.time() - self.cputime_start:9.3f}s, r_{min_row} = {r0}, "
              f"slope = {self.m.get_current_slope(min_row, max_row):9.6f}, "
              f"log2(nodes) = {math.log2(max(self.nodes, 1)):9.6f}",
              file=sys.stderr)

    def set_status(self, new_status: int) -> bool:
        self.status = new_status
        if self.param.flags & BKZ_VERBOSE:
            if new_status == RED_SUCCESS:
                print(f"End of {self.algorithm}: success", file=sys.stderr)
            else:
                print(f"End of {self.algorithm}: failure: "
                      f"{get_red_status_str(new_status)}", file=sys.stderr)
        return new_status == RED_SUCCESS

    def dump_gso(self, filename: str, append: bool, step: str, loop: int,
                 tm: float) -> None:
        """Write log-norms of the GSO to a JSON file (bkz.cpp:728-798)."""
        mode = "a" if append else "w"
        with open(filename, mode) as dump:
            if not append:
                dump.write("[\n")
            dump.write(" " * 8 + "{\n")
            dump.write(" " * 16 + f'"step": "{step}",\n')
            dump.write(" " * 16 + f'"loop": {loop},\n')
            dump.write(" " * 16 + f'"time": {tm},\n')
            norms = []
            for i in range(self.num_rows):
                self.m.update_gso_row(i)
                v, e = self.m.get_r_exp(i, i)
                norms.append(f"{math.log(self.m.ctx.to_float(v)) + e * math.log(2.0):.8g}")
            dump.write(" " * 16 + '"norms": [' + ", ".join(norms) + "]\n")
            dump.write(" " * 8 + "}")
            if step == "Output":
                dump.write("\n]")
            else:
                dump.write(",\n")


# ---------------------------------------------------------------------------
# Flat entry points (bkz.cpp:812-955)
# ---------------------------------------------------------------------------
def bkz_reduction_f(b: IntMat, param: BKZParam, sel_ft: FloatType,
                    lll_delta: float, u: Optional[IntMat] = None,
                    u_inv: Optional[IntMat] = None, precision: int = 0,
                    device=None) -> int:
    gso_flags = 0
    if b.nrows == 0 or b.ncols == 0:
        return RED_SUCCESS
    if sel_ft in (FT_DOUBLE, FT_LONG_DOUBLE):
        gso_flags |= GSO_ROW_EXPO
    ctx = get_ctx(sel_ft, precision)
    m_gso = MatGSO(b, u, u_inv, flags=gso_flags, ctx=ctx, device=device)
    lll_obj = LLLReduction(m_gso, lll_delta, LLL_DEF_ETA, LLL_DEFAULT)
    bkz_obj = BKZReduction(m_gso, lll_obj, param, device=device)
    bkz_obj.bkz()
    return bkz_obj.status


def bkz_reduction(b: IntMat, param: BKZParam | int,
                  u: Optional[IntMat] = None,
                  float_type: FloatType = FT_DEFAULT, precision: int = 0,
                  flags: int = 0, device=None) -> int:
    """Main BKZ entry (bkz.cpp:849-927). `param` may be a BKZParam or a
    block size (then `flags` applies). Device-sized windows run on
    `device` (cuda unless the caller asks for the CPU, torchsetup)."""
    device = resolve_device(device)
    if isinstance(param, int):
        param = BKZParam(param, None, flags=flags)
    if u is not None:
        u.resize(b.nrows, b.nrows)
        for i in range(b.nrows):
            for j in range(b.nrows):
                u.a[i, j] = 1 if i == j else 0
    lll_delta = param.delta if param.delta < 1 else LLL_DEF_DELTA
    sel_ft = float_type if float_type != FT_DEFAULT else FT_DOUBLE
    if sel_ft == FT_MPFR and precision == 0:
        raise ValueError("missing precision for BKZ with mpfr")

    if param.flags & BKZ_NO_LLL:
        zeros_last(b, u, None)
    else:
        wrapper = Wrapper(b, u, None, lll_delta, LLL_DEF_ETA, LLL_DEFAULT,
                          device=device)
        if not wrapper.lll():
            return wrapper.status
    status = bkz_reduction_f(b, param, sel_ft, lll_delta, u, None, precision,
                             device=device)
    zeros_first(b, u, None)
    return status


def hkz_reduction(b: IntMat, flags: int = 0,
                  float_type: FloatType = FT_DEFAULT, precision: int = 0,
                  device=None) -> int:
    """HKZ reduction = BKZ with block size d and delta 1 (bkz.cpp:946-955)."""
    param = BKZParam(max(b.nrows, 2), None)
    param.block_size = b.nrows
    param.delta = 1
    if flags & HKZ_VERBOSE:
        param.flags |= BKZ_VERBOSE
    return bkz_reduction(b, param, None, float_type, precision,
                         device=device)
