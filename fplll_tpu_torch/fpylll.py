"""fpylll-shaped API veneer over fplll_tpu_torch.

The port's copy of the JAX package's fpylll.py. The reference library's
dominant consumer surface is fpylll (the Python bindings used by SageMath
and the strategizer; fplll's README.md:365-369). This module lets that
ecosystem's idioms run against the port with an import swap::

    from fplll_tpu_torch.fpylll import (FPLLL, IntegerMatrix, GSO, LLL,
                                        BKZ, SVP, CVP, Enumeration, Pruning)

    A = IntegerMatrix.random(60, "qary", k=30, bits=30)
    LLL.reduction(A)
    BKZ.reduction(A, BKZ.EasyParam(40, max_loops=4))
    v = SVP.shortest_vector(A)

Like fpylll it has no device argument: BKZ, SVP, CVP, device-sized
Enumeration trees and Pruning.run's analytic gradient run on cuda unless
FPLLL_TORCH_DEVICE=cpu asks for the CPU (torchsetup.resolve_device);
Pruning.svp_probability, LinearPruningParams and simulate are host code.

It is a thin mapping onto the port's own classes (IntMat, MatGSO,
LLLReduction, BKZReduction, ...), not a bug-for-bug clone of fpylll's
Cython layer: everything returns this package's native objects, and
only the call shapes that appear in fpylll's documented workflows are
covered.  Reference call-shape parity: fpylll's public API mirrors the
flat C++ entry points in fplll/wrapper.h:136-189,
bkz.h:357-427 and svpcvp.h, which the underlying functions here
reproduce.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

from . import defs as _d
from .algs.bkz import bkz_reduction as _bkz_reduction
from .algs.bkz_param import (BKZParam, PruningParams, Strategy,
                             load_strategies_json, strategy_full_path)
from .algs.lll import LLLReduction as _LLLReduction
from .algs.lll import is_lll_reduced as _is_lll_reduced
from .algs.svpcvp import closest_vector as _closest_vector
from .algs.svpcvp import shortest_vector as _shortest_vector
from .algs.svpcvp import shortest_vector_pruning as _shortest_vector_pruning
from .algs.wrapper import lll_reduction as _lll_reduction
from .core.gso import MatGSO, MatGSOGram
from .enum.api import Enumeration as _Enumeration
from .enum.evaluator import (EVALSTRATEGY_BEST_N_SOLUTIONS,
                             EVALSTRATEGY_FIRST_N_SOLUTIONS,
                             EVALSTRATEGY_OPPORTUNISTIC_N_SOLUTIONS,
                             FastEvaluator)
from .nr.fctx import MPCtx, float_ctx_from_name
from .nr.rng import RandGen
from .ops import gen as _gen
from .ops.intmat import IntMat
from .pruner.pruner import prune as _prune
from .pruner.pruner import svp_probability as _svp_probability
from .threads import get_threads, set_threads

__all__ = ["FPLLL", "IntegerMatrix", "GSO", "LLL", "BKZ", "SVP", "CVP",
           "Enumeration", "EnumerationError", "EvaluatorStrategy",
           "Pruning", "ReductionError", "load_strategies_json",
           "simulate"]


class ReductionError(RuntimeError):
    """Raised when a reduction returns a failure RedStatus."""


class EnumerationError(RuntimeError):
    """Raised when enumeration finds no vector within the bound."""


class EvaluatorStrategy:
    BEST_N_SOLUTIONS = EVALSTRATEGY_BEST_N_SOLUTIONS
    OPPORTUNISTIC_N_SOLUTIONS = EVALSTRATEGY_OPPORTUNISTIC_N_SOLUTIONS
    FIRST_N_SOLUTIONS = EVALSTRATEGY_FIRST_N_SOLUTIONS


# ---------------------------------------------------------------------------
class FPLLL:
    """Global knobs (fpylll.FPLLL)."""

    _precision = 0

    @staticmethod
    def set_random_seed(seed: int) -> None:
        RandGen.init_with_seed(seed)

    @staticmethod
    def set_precision(prec: int) -> int:
        old = FPLLL._precision
        FPLLL._precision = int(prec)
        return old

    @staticmethod
    def get_precision() -> int:
        return FPLLL._precision

    @staticmethod
    def set_threads(n: int = 1) -> int:
        return set_threads(n)

    @staticmethod
    def get_threads() -> int:
        return get_threads()


# ---------------------------------------------------------------------------
class IntegerMatrix(IntMat):
    """IntMat with fpylll's constructors (fpylll.IntegerMatrix)."""

    @classmethod
    def random(cls, d: int, algorithm: str, **kwds) -> "IntegerMatrix":
        """Seeded instance families; mirrors latticegen's generators
        (reference matrix.h:275-347; ops/gen.py)."""
        algorithm = algorithm.lower()
        if algorithm == "intrel":
            m = _gen.gen_intrel(d, kwds["bits"])
        elif algorithm == "simdioph":
            m = _gen.gen_simdioph(d, kwds["bits"], kwds["bits2"])
        elif algorithm == "uniform":
            m = _gen.gen_uniform(d, kwds["bits"])
        elif algorithm == "ntrulike":
            m = (_gen.gen_ntrulike(d, kwds["q"]) if "q" in kwds
                 else _gen.gen_ntrulike_bits(d, kwds["bits"]))
        elif algorithm == "ntrulike2":
            m = (_gen.gen_ntrulike2(d, kwds["q"]) if "q" in kwds
                 else _gen.gen_ntrulike2_bits(d, kwds["bits"]))
        elif algorithm == "qary":
            k = kwds["k"]
            m = (_gen.gen_qary(d, k, kwds["q"]) if "q" in kwds
                 else _gen.gen_qary_bits(d, k, kwds["bits"]))
        elif algorithm == "trg":
            m = _gen.gen_trg(d, kwds.get("alpha", 1.0))
        else:
            raise ValueError(f"unknown matrix family {algorithm!r}")
        return cls._adopt(m)

    @classmethod
    def from_matrix(cls, rows, nrows: int = 0, ncols: int = 0
                    ) -> "IntegerMatrix":
        if isinstance(rows, IntMat):
            return cls._adopt(rows.copy())
        return cls._adopt(IntMat.from_rows([list(r) for r in rows]))

    @classmethod
    def from_file(cls, path: str) -> "IntegerMatrix":
        from .ops.intmat import read_matrix
        return cls._adopt(read_matrix(path))

    @classmethod
    def identity(cls, n: int) -> "IntegerMatrix":
        return cls._adopt(IntMat.identity(n))

    @classmethod
    def _adopt(cls, m: IntMat) -> "IntegerMatrix":
        m.__class__ = cls
        return m

    def multiply_left(self, v: Sequence[int], start: int = 0) -> Tuple[int, ...]:
        """v * A (fpylll semantics: v indexes rows from `start`)."""
        return _multiply_left(self, v, start)

    def transpose(self) -> "IntegerMatrix":
        rows = [[int(self[i, j]) for i in range(self.nrows)]
                for j in range(self.ncols)]
        return type(self)._adopt(IntMat.from_rows(rows))

    def __copy__(self) -> "IntegerMatrix":
        return type(self)._adopt(self.copy())


def _multiply_left(B: IntMat, v: Sequence[int], start: int = 0
                   ) -> Tuple[int, ...]:
    out = [0] * B.ncols
    for i, c in enumerate(v):
        ci = int(round(c))
        if ci == 0:
            continue
        r = B.row(start + i)
        for j in range(B.ncols):
            out[j] += ci * int(r[j])
    return tuple(out)


_FT_BY_NAME = {None: "FT_DEFAULT", "": "FT_DEFAULT",
               "d": "FT_DOUBLE", "double": "FT_DOUBLE",
               "ld": "FT_LONG_DOUBLE", "long double": "FT_LONG_DOUBLE",
               "dpe": "FT_DPE", "dd": "FT_DD", "qd": "FT_QD",
               "mpfr": "FT_MPFR"}


def _ft_of(float_type: Optional[str]):
    """fpylll float-type spelling -> FloatType enum."""
    try:
        return getattr(_d, _FT_BY_NAME[None if float_type is None
                                       else float_type.lower()])
    except KeyError:
        raise ValueError(f"unknown float_type {float_type!r}; expected "
                         f"one of {sorted(k for k in _FT_BY_NAME if k)}")


def _ctx_for(float_type: Optional[str], precision: int = 0):
    if float_type in (None, "", "d", "double"):
        if precision and precision > 53:
            return MPCtx(precision)
        return None
    if float_type in ("mpfr", "mpf"):
        return MPCtx(precision or max(FPLLL.get_precision(), 53))
    return float_ctx_from_name(float_type)


# ---------------------------------------------------------------------------
class GSO:
    """fpylll.GSO: flags + the Mat factory."""

    DEFAULT = _d.GSO_DEFAULT
    INT_GRAM = _d.GSO_INT_GRAM
    ROW_EXPO = _d.GSO_ROW_EXPO
    OP_FORCE_LONG = _d.GSO_OP_FORCE_LONG

    @staticmethod
    def Mat(A: IntMat, U: Optional[IntMat] = None,
            UinvT: Optional[IntMat] = None, flags: int = 0,
            float_type: Optional[str] = None, update: bool = False,
            gram: bool = False):
        ctx = _ctx_for(float_type, FPLLL.get_precision())
        if gram:
            m = MatGSOGram(A, U, UinvT, flags | _d.GSO_INT_GRAM, ctx=ctx)
        else:
            m = MatGSO(A, U, UinvT, flags, ctx=ctx)
        if update:
            m.update_gso()
        return m


class LLL:
    DEFAULT = _d.LLL_DEFAULT
    VERBOSE = _d.LLL_VERBOSE
    EARLY_RED = _d.LLL_EARLY_RED
    SIEGEL = _d.LLL_SIEGEL

    Reduction = _LLLReduction

    _METHODS = {None: _d.LM_WRAPPER, "wrapper": _d.LM_WRAPPER,
                "proved": _d.LM_PROVED, "heuristic": _d.LM_HEURISTIC,
                "fast": _d.LM_FAST}

    @staticmethod
    def reduction(B: IntMat, U: Optional[IntMat] = None,
                  delta: float = _d.LLL_DEF_DELTA,
                  eta: float = _d.LLL_DEF_ETA,
                  method: Optional[str] = None,
                  float_type: Optional[str] = None,
                  precision: int = 0, flags: int = 0) -> IntMat:
        st = _lll_reduction(B, U, None, delta, eta, LLL._METHODS[method],
                            _ft_of(float_type), precision, flags)
        if st != _d.RED_SUCCESS:
            raise ReductionError(_d.RED_STATUS_STR[int(st)])
        return B

    @staticmethod
    def is_reduced(M, delta: float = _d.LLL_DEF_DELTA,
                   eta: float = _d.LLL_DEF_ETA) -> bool:
        if isinstance(M, IntMat):
            M = GSO.Mat(M, update=True)
        return _is_lll_reduced(M, delta, eta)


class BKZ:
    DEFAULT = _d.BKZ_DEFAULT
    VERBOSE = _d.BKZ_VERBOSE
    NO_LLL = _d.BKZ_NO_LLL
    MAX_LOOPS = _d.BKZ_MAX_LOOPS
    MAX_TIME = _d.BKZ_MAX_TIME
    BOUNDED_LLL = _d.BKZ_BOUNDED_LLL
    AUTO_ABORT = _d.BKZ_AUTO_ABORT
    DUMP_GSO = _d.BKZ_DUMP_GSO
    GH_BND = _d.BKZ_GH_BND
    SD_VARIANT = _d.BKZ_SD_VARIANT
    SLD_RED = _d.BKZ_SLD_RED

    DEFAULT_STRATEGY = strategy_full_path("default.json")
    DEFAULT_STRATEGY_PATH = DEFAULT_STRATEGY

    class Param(BKZParam):
        """BKZParam accepting fpylll's `strategies=<path or list>`."""

        def __init__(self, block_size: int, strategies=None, **kwds):
            if isinstance(strategies, str):
                strategies = load_strategies_json(
                    strategy_full_path(strategies))
            super().__init__(block_size, strategies, **kwds)

    @staticmethod
    def EasyParam(block_size: int, max_loops: int = 0, flags: int = 0,
                  **kwds) -> "BKZ.Param":
        flags |= _d.BKZ_GH_BND
        if max_loops:
            flags |= _d.BKZ_MAX_LOOPS
        else:
            flags |= _d.BKZ_AUTO_ABORT
        return BKZ.Param(block_size, strategies=BKZ.DEFAULT_STRATEGY,
                         max_loops=max_loops, flags=flags, **kwds)

    @staticmethod
    def reduction(B: IntMat, o: BKZParam, U: Optional[IntMat] = None,
                  float_type: Optional[str] = None,
                  precision: int = 0) -> IntMat:
        st = _bkz_reduction(B, o, U, _ft_of(float_type), precision)
        if st not in (_d.RED_SUCCESS, _d.RED_BKZ_LOOPS_LIMIT,
                      _d.RED_BKZ_TIME_LIMIT):
            raise ReductionError(_d.RED_STATUS_STR[int(st)])
        return B


class SVP:
    DEFAULT = _d.SVP_DEFAULT
    VERBOSE = _d.SVP_VERBOSE
    OVERRIDE_BND = _d.SVP_OVERRIDE_BND
    DUAL = _d.SVP_DUAL

    @staticmethod
    def shortest_vector(B: IntMat, method: str = "fast", flags: int = 0,
                        pruning: Optional[Sequence[float]] = None,
                        preprocess: bool = True) -> Tuple[int, ...]:
        """Returns the shortest VECTOR (canonical coordinates), fpylll
        semantics; B must be / will be LLL-reduced in place."""
        if preprocess:
            LLL.reduction(B)
        if pruning is not None and len(pruning):
            st, coeffs, _ = _shortest_vector_pruning(B, list(pruning),
                                                     flags)
        else:
            m = _d.SVPM_PROVED if method == "proved" else _d.SVPM_FAST
            st, coeffs = _shortest_vector(B, m, flags)
        if st != _d.RED_SUCCESS:
            raise EnumerationError(_d.RED_STATUS_STR[int(st)])
        return _multiply_left(B, coeffs)


class CVP:
    DEFAULT = _d.CVP_DEFAULT
    VERBOSE = _d.CVP_VERBOSE

    @staticmethod
    def closest_vector(B: IntMat, target: Sequence[int],
                       method: str = "fast", flags: int = 0
                       ) -> Tuple[int, ...]:
        m = _d.CVPM_PROVED if method == "proved" else _d.CVPM_FAST
        st, coeffs = _closest_vector(B, list(target), m, flags)
        if st != _d.RED_SUCCESS:
            raise EnumerationError(_d.RED_STATUS_STR[int(st)])
        return _multiply_left(B, coeffs)


# ---------------------------------------------------------------------------
class Enumeration:
    """fpylll.Enumeration: returns [(dist, coords), ...] instead of the
    evaluator-object protocol of fplll_tpu_torch.enum.api.Enumeration."""

    def __init__(self, M, nr_solutions: int = 1,
                 strategy: int = EvaluatorStrategy.BEST_N_SOLUTIONS,
                 sub_solutions: bool = False):
        self.M = M
        self._evaluator = FastEvaluator(nr_solutions, strategy,
                                        sub_solutions)
        self._enum = _Enumeration(M, self._evaluator)

    def enumerate(self, first: int, last: int, max_dist: float,
                  max_dist_expo: int = 0,
                  target: Optional[Sequence[float]] = None,
                  subtree: Sequence[float] = (),
                  pruning: Sequence[float] = (),
                  dual: bool = False, subtree_reset: bool = False
                  ) -> List[Tuple[float, Tuple[float, ...]]]:
        self._evaluator.solutions.clear()
        self._evaluator.sub_solutions.clear()
        self._evaluator.sol_count = 0
        self._last_expo = max_dist_expo
        self._enum.enumerate(first, last, max_dist, max_dist_expo,
                             target if target is not None else (),
                             subtree,
                             pruning if pruning is not None and
                             len(pruning) else (),
                             dual, subtree_reset)
        if self._evaluator.empty():
            raise EnumerationError("enumeration found no vector in bound")
        out = []
        for dist, coords in self._evaluator.solutions:
            caller_dist = math.ldexp(dist, -max_dist_expo)
            out.append((caller_dist, tuple(float(c) for c in coords)))
        return out

    @property
    def sub_solutions(self):
        """Per-level best partial vectors, distances on the same
        2^-max_dist_expo scale as enumerate()'s returned solutions."""
        ev = self._evaluator
        expo = getattr(self, "_last_expo", 0)
        return [(math.ldexp(dist, -expo), tuple(c))
                for dist, c in ev.sub_solutions if c]

    def get_nodes(self, level: int = -1) -> int:
        return self._enum.get_nodes(level)


class Pruning:
    CVP = _d.PRUNER_CVP
    START_FROM_INPUT = _d.PRUNER_START_FROM_INPUT
    GRADIENT = _d.PRUNER_GRADIENT
    NELDER_MEAD = _d.PRUNER_NELDER_MEAD
    VERBOSE = _d.PRUNER_VERBOSE
    HALF = _d.PRUNER_HALF
    SINGLE = _d.PRUNER_SINGLE
    ZEALOUS = _d.PRUNER_ZEALOUS

    EXPECTED_SOLUTIONS = _d.PRUNER_METRIC_EXPECTED_SOLUTIONS
    PROBABILITY_OF_SHORTEST = _d.PRUNER_METRIC_PROBABILITY_OF_SHORTEST

    LinearPruningParams = PruningParams.LinearPruningParams

    @staticmethod
    def run(radius: float, preproc_cost: float, r, target_prob: float,
            metric=None, flags: int = _d.PRUNER_ZEALOUS,
            pruning=None) -> PruningParams:
        if metric is None:
            metric = _d.PRUNER_METRIC_PROBABILITY_OF_SHORTEST
        import numpy as _np
        arr = _np.asarray(r, dtype=float)
        if arr.ndim == 2:
            # list of GSO profiles: the Pruner averages over them
            # (load_basis_shapes semantics, like fpylll)
            r = [list(row) for row in arr]
        else:
            r = list(arr)
        return _prune(radius, preproc_cost, r, target_prob,
                      metric, flags, pruning=pruning)

    @staticmethod
    def svp_probability(pruning) -> float:
        return _svp_probability(pruning)


def simulate(r, param) -> Tuple[List[float], int]:
    """fpylll.tools.bkz_simulator.simulate shape: predict the GSO
    profile of BKZ-param.block_size reduction.  `r` is a list of squared
    GSO norms, a GSO.Mat object, or an IntegerMatrix; returns
    (squared-norm profile, tours run).  Backed by the Chen-Nguyen
    simulator (fplll_tpu_torch.algs.simulator)."""
    from .algs.simulator import simulate as _sim

    if isinstance(r, IntMat):
        r = GSO.Mat(r, update=True)
    if hasattr(r, "get_r_exp"):
        prof = []
        for i in range(r.d):
            v, e = r.get_r_exp(i, i)
            prof.append(r.ctx.to_float(v) * 2.0 ** e)
        r = prof
    tours = getattr(param, "max_loops", 0) or 20
    return _sim(list(r), param.block_size, tours)
