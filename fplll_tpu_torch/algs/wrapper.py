"""Precision-escalation LLL/HLLL driver ("the wrapper") and flat APIs.

Re-design of the reference Wrapper (fplll/wrapper.cpp):
fast<double> -> fast<dd-role> -> heuristic loop (doubling soft-float
precision) -> proved loop up to good_prec = l2_min_prec, then a final
proved pass (wrapper.cpp:281-359, escalation heuristics `little`
wrapper.cpp:73-94 with the dimension tables wrapper.cpp:26-43).

The TPU build's ladder is: f64 (hardware, GSO_ROW_EXPO) -> 106-bit
soft float (dd role) -> p-bit soft float doubling up to good_prec.
State carries over in the exact integer basis between rungs, exactly as
in the reference.
"""

from __future__ import annotations

import math
import os
import sys
from typing import Optional

from ..defs import (FT_DD, FT_DEFAULT, FT_DOUBLE, FT_DPE, FT_MPFR, FT_QD,
                    FloatType, GSO_INT_GRAM, GSO_OP_FORCE_LONG, GSO_ROW_EXPO,
                    LLL_DEF_DELTA, LLL_DEF_EPSILON, LLL_DEF_ETA, LLL_VERBOSE,
                    LLLMethod, LM_FAST, LM_HEURISTIC, LM_PROVED, LM_WRAPPER,
                    PREC_DD, PREC_DOUBLE, PREC_QD, RED_BABAI_FAILURE,
                    RED_GSO_FAILURE, RED_LLL_FAILURE, RED_SUCCESS,
                    LLL_METHOD_STR, FLOAT_TYPE_STR, IntType, ZT_MPZ)
from ..nr.fctx import F64Ctx, MPCtx, get_ctx, l2_min_prec
from ..core.gso import MatGSO
from ..ops.intmat import IntMat
from .lll import LLLReduction

__all__ = ["Wrapper", "lll_reduction", "zeros_first", "zeros_last"]

# dimension thresholds under which escalation jumps straight to the proved
# loop (reference tables wrapper.cpp:26-43)
_DIM_DOUBLE_MAX = [
    0, 26, 29.6, 28.1, 31.1, 32.6, 34.6, 34, 37.7, 38.8, 39.6, 41.8, 40.9,
    43.6, 44.2, 47, 46.8, 50.6, 49.1, 51.5, 52.5, 54.8, 54.6, 57.4, 57.6,
    59.9, 61.8, 62.3, 64.5, 67.1, 68.8, 68.3, 69.9, 73.1, 74, 76.1, 76.8,
    80.9, 81.8, 83, 85.3, 87.9, 89, 90.1, 89, 94.6, 94.8, 98.7, 99, 101.6,
    104.9, 106.8, 108.2, 107.4, 110, 112.7, 114.6, 118.1, 119.7, 121.8,
    122.9, 126.6, 128.6, 129, 133.6, 126.9, 135.9, 139.5, 135.2, 137.2,
    139.3, 142.8, 142.4, 142.5, 145.4]
_ETA_DEP = [1., 1., 1.0521, 1.1254, 1.2535, 1.3957, 1.6231, 1.8189, 2.1025,
            2.5117]


def _rotate_rows_front(m: Optional[IntMat], i: int, d: int) -> None:
    if m is not None and m.nrows:
        import numpy as np
        m.version += 1
        m.a[0:d] = np.concatenate([m.a[i:d], m.a[0:i]], axis=0)


def zeros_first(b: IntMat, u: Optional[IntMat] = None,
                u_inv_t: Optional[IntMat] = None) -> None:
    """Move trailing zero rows to the front (util.cpp:257-271)."""
    d = b.nrows
    i = d
    while i > 0 and b.row_is_zero(i - 1):
        i -= 1
    if 0 < i < d:
        for m in (b, u, u_inv_t):
            _rotate_rows_front(m, i, d)


def zeros_last(b: IntMat, u: Optional[IntMat] = None,
               u_inv_t: Optional[IntMat] = None) -> None:
    """Move leading zero rows to the end (util.cpp:273-287)."""
    d = b.nrows
    i = 0
    while i < d and b.row_is_zero(i):
        i += 1
    if 0 < i < d:
        for m in (b, u, u_inv_t):
            _rotate_rows_front(m, i, d)


class Wrapper:
    """Guaranteed-output LLL with automatic precision escalation
    (reference: wrapper.h:50)."""

    def __init__(self, b: IntMat, u: Optional[IntMat] = None,
                 u_inv: Optional[IntMat] = None, delta: float = LLL_DEF_DELTA,
                 eta: float = LLL_DEF_ETA, flags: int = 0, device=None):
        self.b, self.u, self.u_inv = b, u, u_inv
        self.delta, self.eta = delta, eta
        self.flags = flags
        self.device = device      # of the GSO's blocked recompute (MatGSO)
        self.status = RED_SUCCESS
        self.last_early_red = 0
        self.n, self.d = b.ncols, b.nrows
        self.max_exponent = b.get_max_exp() + int(
            math.ceil(0.5 * math.log2(max(1, self.d * self.n))))
        self.good_prec = l2_min_prec(self.d, delta, eta, LLL_DEF_EPSILON)

    # -- "is kappa small enough that more precision won't help" heuristic
    # (wrapper.cpp:73-94)
    def little(self, kappa: int, precision: int) -> bool:
        dm = min(max(int(self.delta * 100.0 - 25.0), 0), 74)
        em = min(max(int((self.eta - 0.5) * 20), 0), 9)
        p = max(1.0, precision / 53.0) * _ETA_DEP[em] * _DIM_DOUBLE_MAX[dm]
        return kappa < p

    def _call_lll(self, method: LLLMethod, ctx, precision: int) -> int:
        """Returns 0 on success, failing kappa on numerical failure, -1 on
        other errors (wrapper.cpp:100-151)."""
        if self.flags & LLL_VERBOSE:
            print(f"====== Wrapper: calling {LLL_METHOD_STR[method]}"
                  f"<{ctx.name}> method"
                  + (f" (precision={precision})" if precision else "")
                  + " ======", file=sys.stderr)
        gso_flags = 0
        if method == LM_PROVED:
            gso_flags |= GSO_INT_GRAM
        if method == LM_FAST:
            gso_flags |= GSO_ROW_EXPO
        if method != LM_PROVED and precision == 0:
            gso_flags |= GSO_OP_FORCE_LONG
        m = MatGSO(self.b, self.u, self.u_inv, flags=gso_flags, ctx=ctx,
                   device=self.device)
        lll = LLLReduction(m, self.delta, self.eta, self.flags)
        lll.last_early_red = self.last_early_red
        lll.lll()
        self.status = lll.status
        self.last_early_red = max(self.last_early_red, lll.last_early_red)
        if lll.status == RED_SUCCESS:
            return 0
        if lll.status in (RED_GSO_FAILURE, RED_BABAI_FAILURE):
            return lll.final_kappa
        return -1

    def increase_prec(self, precision: int) -> int:
        return min(precision * 2, self.good_prec)

    def heuristic_loop(self, precision: int) -> int:
        """Approximate gram at growing soft-float precision
        (wrapper.cpp:179-201: dpe when the precision fits a double
        mantissa, mpfr above)."""
        if precision <= PREC_DOUBLE:
            ctx = get_ctx(FT_DPE)
        else:
            # routed to the compiled dde/qde tiers when the precision fits
            ctx = get_ctx(FT_MPFR, precision)
        kappa = self._call_lll(LM_HEURISTIC, ctx, 0)
        if kappa == 0:
            return 0
        if precision < self.good_prec and not self.little(kappa, precision):
            return self.heuristic_loop(self.increase_prec(precision))
        return self.proved_loop(precision)

    def proved_loop(self, precision: int) -> int:
        """Exact gram at growing precision up to good_prec
        (wrapper.cpp:203-232: mpfr above dd, dpe when entries overflow
        the double exponent range, dd above double precision, else
        hardware double)."""
        if precision > PREC_DD:
            ctx = self._high_prec_ctx(precision)
        elif self.max_exponent * 2 > 1000:
            # entries overflow the double exponent range: the reference
            # drops to dpe here (wrapper.cpp:211-215); the compiled dde
            # tier keeps 106-bit precision WITH the unbounded exponent
            ctx = (get_ctx(FT_MPFR, precision) if precision > PREC_DOUBLE
                   else get_ctx(FT_DPE))
        elif precision > PREC_DOUBLE:
            ctx = get_ctx(FT_DD)
        else:
            ctx = F64Ctx()
        kappa = self._call_lll(LM_PROVED, ctx, 0)
        if kappa == 0:
            return 0
        if precision < self.good_prec:
            return self.proved_loop(self.increase_prec(precision))
        return -1

    def _high_prec_ctx(self, precision: int):
        """Context for proved passes above dd precision. The reference
        goes straight to mpfr (wrapper.cpp:206-210) because libqd is its
        optional fast tier only up to dd; here the compiled qd/qde
        (212-bit, qde with unbounded exponent) cover precisions up to
        PREC_QD-12 (a 12-bit guard for qd's few-ulp arithmetic), with
        the soft-float as the arbitrary-precision tail."""
        from ..nr.fctx import compiled_ctx
        if precision <= PREC_QD - 12:
            kind = "qd" if self.max_exponent * 2 <= 1000 else "qde"
            ctx = compiled_ctx(kind)
            if ctx is not None:
                return ctx
        return MPCtx(precision, FT_MPFR)

    def last_lll(self) -> int:
        """Final proved pass at good_prec (wrapper.cpp:237-273; the
        exponent bound is refreshed from the now-reduced basis before
        choosing dd, wrapper.cpp:265-269)."""
        self.max_exponent = self.b.get_max_exp() + int(
            math.ceil(0.5 * math.log2(max(1, self.d * self.n))))
        if self.good_prec <= PREC_DOUBLE:
            ctx = get_ctx(FT_DPE)
        elif self.good_prec <= PREC_DD:
            ctx = get_ctx(FT_DD) if self.max_exponent * 2 <= 1000 \
                else get_ctx(FT_MPFR, self.good_prec)   # dde tier
        else:
            ctx = self._high_prec_ctx(self.good_prec)
        return self._call_lll(LM_PROVED, ctx, self.good_prec)

    def _native_fast_rung(self) -> int | None:
        """Try the native multi-limb fast LLL first (the compiled engine of
        the first ladder rung). Returns 0 on success, nonzero to continue
        the ladder from the partially reduced basis, None if unavailable."""
        import os
        if os.environ.get("FPLLL_TPU_NATIVE_LLL", "1") != "1":
            return None
        if self.u_inv is not None or (self.flags & (LLL_VERBOSE | 2 | 4)):
            return None  # early-red/siegel/verbose stay on the python engine
        from ..native import native_lll_fast
        st = native_lll_fast(self.b, self.u, self.delta, self.eta)
        if st is None:
            return None
        self.status = st if st in (RED_SUCCESS, RED_GSO_FAILURE,
                                   RED_BABAI_FAILURE, RED_LLL_FAILURE) \
            else RED_LLL_FAILURE
        return 0 if st == RED_SUCCESS else 1

    def lll(self) -> bool:
        """The ladder (wrapper.cpp:281-359)."""
        if self.d == 0 or self.n == 0:
            return True
        kappa = self._native_fast_rung()
        if kappa is None:
            kappa = self._call_lll(LM_FAST, F64Ctx(), 0)
        lll_failure = kappa != 0
        last_prec = PREC_DOUBLE
        if lll_failure:
            # dd-role rung (the reference's long-double + dd rungs)
            kappa = self._call_lll(LM_FAST, get_ctx(FT_DD), 0)
            lll_failure = kappa != 0
            last_prec = PREC_DD
        if lll_failure:
            if self.little(kappa, last_prec):
                kappa = self.proved_loop(PREC_DOUBLE)
            else:
                kappa = self.heuristic_loop(2 * PREC_DOUBLE)
        kappa = self.last_lll()
        return kappa == 0


class HLLLWrapper:
    """HLLL precision ladder: fast f64 -> dd-role -> proved loop
    (wrapper.cpp:478-529)."""

    def __init__(self, b: IntMat, u: Optional[IntMat] = None,
                 u_inv: Optional[IntMat] = None, delta: float = LLL_DEF_DELTA,
                 eta: float = LLL_DEF_ETA, theta: float = 0.001,
                 c: float = 0.1, flags: int = 0):
        from ..nr.fctx import hlll_min_prec
        self.b, self.u, self.u_inv = b, u, u_inv
        self.delta, self.eta, self.theta, self.c = delta, eta, theta, c
        self.flags = flags
        self.status = RED_SUCCESS
        self.good_prec = hlll_min_prec(b.nrows, b.ncols, delta, eta, theta, c)

    def _call_hlll(self, method: LLLMethod, ctx, precision: int) -> bool:
        from ..defs import (HOUSEHOLDER_DEFAULT, HOUSEHOLDER_OP_FORCE_LONG,
                            HOUSEHOLDER_ROW_EXPO)
        from ..core.householder import MatHouseholder
        from .hlll import HLLLReduction
        hflags = HOUSEHOLDER_DEFAULT
        if method == LM_FAST:
            hflags |= HOUSEHOLDER_ROW_EXPO | HOUSEHOLDER_OP_FORCE_LONG
        m = MatHouseholder(self.b, self.u, self.u_inv, flags=hflags, ctx=ctx)
        h = HLLLReduction(m, self.delta, self.eta, self.theta, self.c,
                          self.flags)
        ok = h.hlll()
        self.status = h.get_status()
        return ok

    def increase_prec(self, precision: int) -> int:
        return min(precision * 2, self.good_prec)

    def _proved_ctx(self, precision: int):
        """Proved-rung context by precision: compiled dpe/dd/qd tiers,
        soft-float above (the reference uses mpfr for every HLLL proved
        pass, wrapper.cpp:440-466; the compiled tiers are this build's
        fast equivalents at 53/106/212 bits)."""
        from ..nr.fctx import compiled_ctx
        if precision <= PREC_DOUBLE:
            return get_ctx(FT_DPE)
        if precision <= PREC_DD:
            return get_ctx(FT_DD)
        if precision <= PREC_QD - 12:
            ctx = compiled_ctx("qd")
            if ctx is not None:
                return ctx
        return MPCtx(precision, FT_MPFR)

    def hlll_proved_loop(self, precision: int) -> bool:
        while True:
            if self._call_hlll(LM_PROVED, self._proved_ctx(precision),
                               precision):
                return True
            if precision >= self.good_prec:
                return False
            precision = self.increase_prec(precision)

    def last_hlll(self) -> bool:
        return self._call_hlll(LM_PROVED, self._proved_ctx(self.good_prec),
                               self.good_prec)

    def hlll(self) -> bool:
        if self.b.nrows == 0 or self.b.ncols == 0:
            return True
        complete = self._call_hlll(LM_FAST, F64Ctx(), 0)
        last_prec = PREC_DOUBLE
        if not complete:
            complete = self._call_hlll(LM_FAST, get_ctx(FT_DD), 0)
            last_prec = PREC_DD
        if not complete:
            complete = self.hlll_proved_loop(last_prec)
        return self.last_hlll()


def hlll_reduction(b: IntMat, u: Optional[IntMat] = None,
                   u_inv: Optional[IntMat] = None,
                   delta: float = LLL_DEF_DELTA, eta: float = LLL_DEF_ETA,
                   theta: float = 0.001, c: float = 0.1,
                   method: LLLMethod = LM_WRAPPER,
                   float_type: FloatType = FT_DEFAULT, precision: int = 0,
                   flags: int = 0, nolll: bool = False) -> int:
    """Flat HLLL API (wrapper.cpp:790-1005 hlll_reduction_z). With
    nolll=True only verifies reducedness (the fplll -a hlll -nolll path,
    wrapper.cpp:828-862)."""
    from ..defs import (HOUSEHOLDER_DEFAULT, HOUSEHOLDER_ROW_EXPO,
                        RED_HLLL_FAILURE)
    from ..core.householder import MatHouseholder
    from .hlll import HLLLReduction, is_hlll_reduced
    from ..nr.fctx import hlll_min_prec

    if b.nrows == 0 or b.ncols == 0:
        return RED_SUCCESS

    if nolll:
        ctx = get_ctx(float_type if float_type != FT_DEFAULT else FT_MPFR,
                      precision if precision else
                      hlll_min_prec(b.nrows, b.ncols, delta, eta, theta, c))
        m = MatHouseholder(b, None, None,
                           flags=HOUSEHOLDER_DEFAULT | HOUSEHOLDER_ROW_EXPO,
                           ctx=ctx)
        return is_hlll_reduced(m, delta, eta, theta)

    if method == LM_WRAPPER:
        if float_type != FT_DEFAULT:
            raise ValueError("wrapper method does not take a float type")
        w = HLLLWrapper(b, u, u_inv, delta, eta, theta, c, flags)
        w.hlll()
        zeros_first(b, u, u_inv)
        return w.status

    good_prec = hlll_min_prec(b.nrows, b.ncols, delta, eta, theta, c)
    sel_prec = precision if precision else \
        (good_prec if method == LM_PROVED else PREC_DOUBLE)
    sel_ft = float_type
    if sel_ft == FT_DEFAULT:
        if method == LM_FAST:
            sel_ft = FT_DOUBLE
        elif sel_prec <= PREC_DOUBLE:
            sel_ft = FT_DPE
        elif sel_prec <= PREC_DD:
            sel_ft = FT_DD
        elif sel_prec <= PREC_QD:
            sel_ft = FT_QD
        else:
            sel_ft = FT_MPFR
    ctx = get_ctx(sel_ft, sel_prec)
    from ..defs import (HOUSEHOLDER_OP_FORCE_LONG)
    hflags = 0
    if method == LM_FAST:
        hflags |= HOUSEHOLDER_ROW_EXPO | HOUSEHOLDER_OP_FORCE_LONG
    m = MatHouseholder(b, u, u_inv, flags=hflags, ctx=ctx)
    h = HLLLReduction(m, delta, eta, theta, c, flags)
    h.hlll()
    zeros_first(b, u, u_inv)
    return h.get_status()


def lll_reduction(b: IntMat, u: Optional[IntMat] = None,
                  u_inv: Optional[IntMat] = None, delta: float = LLL_DEF_DELTA,
                  eta: float = LLL_DEF_ETA,
                  method: LLLMethod = LM_WRAPPER,
                  float_type: FloatType = FT_DEFAULT, precision: int = 0,
                  flags: int = 0, int_type: IntType = ZT_MPZ) -> int:
    """Flat LLL API (reference: wrapper.cpp:580-734 lll_reduction_z and the
    macro-generated overloads wrapper.h:136-189). Returns a RedStatus."""
    if b.nrows == 0 or b.ncols == 0:
        return RED_SUCCESS

    if method == LM_WRAPPER:
        if float_type != FT_DEFAULT:
            raise ValueError("wrapper method does not take a float type")
        if precision != 0:
            raise ValueError("wrapper method does not take a precision")
        w = Wrapper(b, u, u_inv, delta, eta, flags)
        w.lll()
        zeros_first(b, u, u_inv)
        return w.status

    if method == LM_PROVED and (flags & 2):  # LLL_EARLY_RED
        raise ValueError("LLL method 'proved' with early reduction "
                         "is not implemented")

    good_prec = l2_min_prec(b.nrows, delta, eta, LLL_DEF_EPSILON)
    sel_prec = precision if precision != 0 else \
        (good_prec if method == LM_PROVED else PREC_DOUBLE)
    sel_ft = float_type
    if precision != 0:
        if sel_ft == FT_DEFAULT:
            sel_ft = FT_MPFR
        if sel_ft != FT_MPFR:
            raise ValueError("float type must be mpfr when a precision is "
                             "specified")
    if sel_ft == FT_DEFAULT:
        if method == LM_FAST:
            sel_ft = FT_DOUBLE
        elif sel_prec <= PREC_DOUBLE:
            sel_ft = FT_DPE
        elif sel_prec <= PREC_DD:
            sel_ft = FT_DD
        elif sel_prec <= PREC_QD:
            sel_ft = FT_QD
        else:
            sel_ft = FT_MPFR
    elif method == LM_FAST and sel_ft not in (FT_DOUBLE, FT_DD, FT_QD,
                                              FloatType.FT_LONG_DOUBLE):
        raise ValueError("'double'/'long double'/'dd'/'qd' required for fast")

    ctx = get_ctx(sel_ft, sel_prec)

    if method == LM_FAST and sel_ft == FT_DOUBLE and u_inv is None and \
            not (flags & (LLL_VERBOSE | 2 | 4)) and \
            os.environ.get("FPLLL_TPU_NATIVE_LLL", "1") == "1":
        from ..native import native_lll_fast
        st = native_lll_fast(b, u, delta, eta)
        if st == 0:
            zeros_first(b, u, u_inv)
            return RED_SUCCESS
        # nonzero/None: continue with the python engine from current state

    gso_flags = 0
    if method == LM_PROVED:
        gso_flags |= GSO_INT_GRAM
    if method == LM_FAST:
        gso_flags |= GSO_ROW_EXPO | GSO_OP_FORCE_LONG
    m = MatGSO(b, u, u_inv, flags=gso_flags, ctx=ctx)
    lll = LLLReduction(m, delta, eta, flags)
    lll.lll()
    zeros_first(b, u, u_inv)
    return lll.status
