"""Solution sinks ("evaluators") for the enumeration kernels.

Re-design of the reference hierarchy
(fplll/enum/evaluator.{h,cpp}: Evaluator evaluator.h:60,
FastEvaluator :168, CallbackEvaluator :222, ErrorBoundedEvaluator :267,
FastErrorBoundedEvaluator / ExactErrorBoundedEvaluator evaluator.cpp).

Solutions are kept in a sorted list (longest first, like the reference's
greater<FT> multimap); strategies BEST_N / OPPORTUNISTIC / FIRST_N
control how the enumeration bound shrinks. The error-bounded variants
certify results for the proved SVP solver — the TPU build verifies
candidates with *exact* integer arithmetic (we own an exact basis), which
subsumes the reference's certified-error bookkeeping.
"""

from __future__ import annotations

import bisect
import math
from typing import Callable, List, Optional, Sequence, Tuple

from ..ops.intmat import IntMat

__all__ = ["EvaluatorStrategy", "EVALSTRATEGY_BEST_N_SOLUTIONS",
           "EVALSTRATEGY_OPPORTUNISTIC_N_SOLUTIONS",
           "EVALSTRATEGY_FIRST_N_SOLUTIONS", "Evaluator", "FastEvaluator",
           "CallbackEvaluator", "ErrorBoundedEvaluator",
           "EVALMODE_SV", "EVALMODE_CV", "EVALMODE_COUNT", "EVALMODE_PRINT"]

EVALMODE_SV = 0
EVALMODE_CV = 0
EVALMODE_COUNT = 1
EVALMODE_PRINT = 2

EVALSTRATEGY_BEST_N_SOLUTIONS = 0
EVALSTRATEGY_OPPORTUNISTIC_N_SOLUTIONS = 1
EVALSTRATEGY_FIRST_N_SOLUTIONS = 2
EvaluatorStrategy = int


class Evaluator:
    """Base evaluator: stores solutions, shrinks the enumeration bound.

    Distances handed in by the enumerator are normalized by 2^-normexp;
    stored solution distances carry the normalization back (evaluator.h
    eval_sol / calc_enum_bound contracts).
    """

    def __init__(self, nr_solutions: int = 1,
                 strategy: EvaluatorStrategy = EVALSTRATEGY_BEST_N_SOLUTIONS,
                 find_subsolutions: bool = False):
        if nr_solutions <= 0:
            raise ValueError("nr_solutions must be strictly positive")
        if strategy not in (0, 1, 2):
            raise ValueError("invalid strategy")
        self.max_sols = nr_solutions
        self.strategy = strategy
        self.findsubsols = find_subsolutions
        self.normExp = 0
        self.sol_count = 0
        # list of (dist*2^normExp, coords) sorted ascending by dist
        self.solutions: List[Tuple[float, List[float]]] = []
        self.sub_solutions: List[Tuple[float, List[float]]] = []

    # -- iteration mirrors the reference's shortest-first reverse iter ------
    def __iter__(self):
        return iter(self.solutions)

    def __len__(self) -> int:
        return len(self.solutions)

    def empty(self) -> bool:
        return not self.solutions

    def size(self) -> int:
        return len(self.solutions)

    def begin(self) -> Tuple[float, List[float]]:
        """Shortest solution (reference begin() reverse-iterates)."""
        return self.solutions[0]

    def set_normexp(self, e: int) -> None:
        self.normExp = e

    def calc_enum_bound(self, dist: float) -> float:
        return math.ldexp(dist, -self.normExp)

    # -- interface used by the enumerator -----------------------------------
    def eval_sol(self, new_sol_coord: Sequence[float], new_partial_dist: float,
                 max_dist: float) -> float:
        """Process a solution; returns the (possibly shrunk) max_dist."""
        raise NotImplementedError

    def eval_sub_sol(self, offset: int, new_sub_sol_coord: Sequence[float],
                     sub_dist: float) -> None:
        dist = math.ldexp(sub_dist, self.normExp)
        while len(self.sub_solutions) <= offset:
            self.sub_solutions.append((math.inf, []))
        if not self.sub_solutions[offset][1] or dist < self.sub_solutions[offset][0]:
            self.sub_solutions[offset] = (dist, list(new_sub_sol_coord))

    # -- shared strategy logic (evaluator.h:122-160) -------------------------
    def process_sol(self, dist: float, coord: Sequence[float],
                    max_dist: float) -> float:
        self.sol_count += 1
        bisect.insort(self.solutions, (dist, list(coord)), key=lambda t: t[0])
        if self.strategy == EVALSTRATEGY_BEST_N_SOLUTIONS:
            if len(self.solutions) < self.max_sols:
                return max_dist
            if len(self.solutions) > self.max_sols:
                self.solutions.pop()  # drop longest
            return self.calc_enum_bound(self.solutions[-1][0])
        if self.strategy == EVALSTRATEGY_OPPORTUNISTIC_N_SOLUTIONS:
            new_max = self.calc_enum_bound(dist)
            if len(self.solutions) > self.max_sols:
                self.solutions.pop()
            return new_max
        # FIRST_N: no bound update; stop once max_sols found
        if len(self.solutions) >= self.max_sols:
            return -1.0  # signals the enumerator to stop
        return max_dist


class FastEvaluator(Evaluator):
    """Approximate evaluator: trusts float distances (evaluator.h:168)."""

    def eval_sol(self, new_sol_coord, new_partial_dist, max_dist):
        dist = math.ldexp(new_partial_dist, self.normExp)
        return self.process_sol(dist, new_sol_coord, max_dist)


class CallbackEvaluator(FastEvaluator):
    """Only accepts solutions satisfying a predicate (evaluator.h:222-261)."""

    def __init__(self, callback: Callable[[List[float]], bool],
                 nr_solutions: int = 1,
                 strategy: EvaluatorStrategy = EVALSTRATEGY_BEST_N_SOLUTIONS,
                 find_subsolutions: bool = False):
        super().__init__(nr_solutions, strategy, find_subsolutions)
        self.callback = callback

    def eval_sol(self, new_sol_coord, new_partial_dist, max_dist):
        if self.callback(list(new_sol_coord)):
            return super().eval_sol(new_sol_coord, new_partial_dist, max_dist)
        return max_dist


class ErrorBoundedEvaluator(Evaluator):
    """Certified evaluator for the proved SVP/CVP solvers
    (evaluator.h:267-373, evaluator.cpp:213-360).

    Recomputes each candidate's squared norm exactly over the integer
    basis (and target, for CVP), so accepted solutions are proved — the
    exact-arithmetic analogue of the reference's ExactErrorBoundedEvaluator.
    eval_mode COUNT/PRINT mirror the reference's counting/printing modes.
    """

    def __init__(self, b: IntMat, target: Optional[Sequence] = None,
                 eval_mode: int = EVALMODE_SV, nr_solutions: int = 1,
                 strategy: EvaluatorStrategy = EVALSTRATEGY_BEST_N_SOLUTIONS,
                 find_subsolutions: bool = False):
        super().__init__(nr_solutions, strategy, find_subsolutions)
        self.b = b
        self.target = list(target) if target is not None else None
        self.eval_mode = eval_mode
        self.input_error_defined = True
        self.last_partial_dist = 0.0

    def exact_norm_sq(self, coord: Sequence[float]):
        """Exact squared norm (or distance to target) of sum coord_i b_i."""
        n = self.b.ncols
        v = [0] * n
        for i, c in enumerate(coord):
            ci = int(round(c))
            if ci:
                row = self.b.a[i]
                for j in range(n):
                    v[j] += ci * int(row[j])
        if self.target is not None:
            num = 0
            den = 1
            for j in range(n):
                t = self.target[j]
                if isinstance(t, int):
                    num += (v[j] - t) ** 2
                else:
                    from fractions import Fraction
                    fr = (Fraction(v[j]) - Fraction(t)) ** 2
                    num = num * fr.denominator + fr.numerator * den
                    den *= fr.denominator
            return num if den == 1 else num / den
        return sum(x * x for x in v)

    def eval_sol(self, new_sol_coord, new_partial_dist, max_dist):
        self.last_partial_dist = new_partial_dist
        exact = self.exact_norm_sq(new_sol_coord)
        if exact == 0 and self.target is None:
            return max_dist  # SVP: the zero vector is not a solution
        if self.eval_mode == EVALMODE_COUNT:
            self.sol_count += 1
            return max_dist
        if self.eval_mode == EVALMODE_PRINT:
            print([int(round(c)) for c in new_sol_coord], float(exact))
            return max_dist
        dist = float(exact)
        return self.process_sol(dist, new_sol_coord, max_dist)
