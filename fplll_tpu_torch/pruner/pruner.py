"""Pruning-coefficient optimizer (GNR extreme pruning).

The port's copy of the JAX package's pruner/pruner.py. Re-design of
fplll/pruner/: the cost model
(level volumes via even-simplex polynomial integration, pruner_simplex.h
:28-46 and single_enum_cost_evec pruner_cost.cpp:8-67), success metrics
svp_probability / expected_solutions (pruner_prob.cpp), the repeated-
enum target function (pruner_cost.cpp:136-169), the coefficient
constraints `enforce` (pruner.h:1012-1053), descent + Nelder-Mead
optimizers (pruner_optimize*.cpp) and the flat wrappers prune() /
svp_probability() / run_pruner (pruner.cpp:32-188).

Tabulated constants (factorial / ball volumes, pruner.cpp:190-201 +
*.const files) are computed in log space at import. The descent takes
the analytic gradient of the log-cost from torch.autograd
(pruner/torchgrad.py) on the pruner's device where it applies, else the
reference's numerical log-gradient scheme (pruner_cost.cpp:115-134).
Everything else here is host code: cost, probability and expected
solutions run on the native C core (native/pruner_core.c).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np

from ..defs import (PRUNER_CVP, PRUNER_GRADIENT, PRUNER_HALF,
                    PRUNER_METRIC_EXPECTED_SOLUTIONS,
                    PRUNER_METRIC_PROBABILITY_OF_SHORTEST,
                    PRUNER_NELDER_MEAD, PRUNER_SINGLE,
                    PRUNER_START_FROM_INPUT, PRUNER_VERBOSE, PRUNER_ZEALOUS)

__all__ = ["Pruner", "prune", "svp_probability", "run_pruner"]


def _log_ball_vol(n: int) -> float:
    """log volume of the n-dim unit ball."""
    return (n / 2.0) * math.log(math.pi) - math.lgamma(n / 2.0 + 1.0)


_MAXD = 1024
with np.errstate(over="ignore"):
    # entries beyond ~170! overflow to inf, matching the reference's
    # double-typed tables (pruner.cpp:190-201)
    _TAB_BALL_VOL = np.exp([_log_ball_vol(i) for i in range(_MAXD)])
    _TAB_FACTORIAL = np.exp([math.lgamma(i + 1.0) for i in range(_MAXD)])


def _eval_poly(ld: int, p, x):
    acc = 0.0
    for i in range(ld, -1, -1):
        acc = acc * x + p[i]
    return acc


def _native_lib():
    from ..native import get_pruner_lib
    return get_pruner_lib()


def _relative_volume(rd: int, b) -> float:
    """Relative volume of the even cylinder-intersection body
    (pruner_simplex.h:28-46). Dispatches to the compiled core when the
    toolchain is available; the Python loop below is the oracle."""
    lib = _native_lib()
    if lib is not None:
        return float(lib.pruner_rel_vol(
            rd, np.ascontiguousarray(b[:rd], dtype=np.float64)))
    # Fallback oracle: x86 long double (64-bit mantissa) tames the
    # catastrophic cancellation the same way the native dd path does.
    one = np.longdouble(1.0)
    P = [np.longdouble(0.0)] * (rd + 2)
    P[0] = one
    ld = 0
    binv = one / np.longdouble(b[rd - 1])
    for i in range(rd - 1, -1, -1):
        for k in range(ld, -1, -1):
            P[k + 1] = P[k] / np.longdouble(k + 1.0)
        P[0] = np.longdouble(0.0)
        ld += 1
        P[0] = -_eval_poly(ld, P, np.longdouble(b[i]) * binv)
    res = float(P[0] * np.longdouble(_TAB_FACTORIAL[rd]))
    return -res if (rd % 2) else res


class Pruner:
    """Optimizer of pruning coefficients (reference: pruner.h:272).

    gso_r is the vector of squared Gram-Schmidt norms of the block (or a
    list of such vectors, averaged as in load_basis_shapes). `device` is
    where the analytic gradient runs, resolved only when the descent first
    asks for it (torchsetup.resolve_device: cuda unless the caller asks for
    the CPU); cost and probability queries never touch a device.
    """

    def __init__(self, enumeration_radius: float, preproc_cost: float,
                 gso_r, target: float = 0.9,
                 metric: int = PRUNER_METRIC_PROBABILITY_OF_SHORTEST,
                 flags: int = PRUNER_GRADIENT, device=None):
        self.device = device
        self.enumeration_radius = float(enumeration_radius)
        self.preproc_cost = float(preproc_cost)
        self.target = float(target)
        self.metric = metric
        self.flags = flags
        self.verbose = bool(flags & PRUNER_VERBOSE)
        # PRUNER_SINGLE selects the fixed-probability objective
        # (pruner.h:327-336); mutually exclusive with PRUNER_HALF
        self.opt_single = bool(flags & PRUNER_SINGLE)
        if self.opt_single and (flags & PRUNER_HALF):
            raise ValueError(
                "flags PRUNER_HALF and PRUNER_SINGLE are mutually exclusive")
        if metric == PRUNER_METRIC_PROBABILITY_OF_SHORTEST and \
                not (0.0 < self.target < 1.0):
            raise ValueError("invalid target for probability metric")
        # 0.5 for SVP symmetry; 1 for CVP (pruner.h:617)
        self.symmetry_factor = 1.0 if (flags & PRUNER_CVP) else 0.5
        self.shell_ratio = 0.995
        self.epsilon = 2.0 ** -7
        self.min_step = 2.0 ** -6

        if isinstance(gso_r[0], (list, tuple, np.ndarray)):
            shapes = [np.asarray(g, dtype=np.float64) for g in gso_r]
        else:
            shapes = [np.asarray(gso_r, dtype=np.float64)]
        self.n = len(shapes[0])
        self.d = self.n // 2
        self.min_pruning_coefficients = np.zeros(self.d)
        self._load_shapes(shapes)

    # -- shape loading (pruner_util.cpp:24-91) -------------------------------
    def _load_shape(self, gso_r: np.ndarray, reset_normalization: bool):
        n = self.n
        r = gso_r[::-1].astype(np.float64)
        logvol = float(np.sum(np.log(r)))
        if reset_normalization:
            self.normalization_factor = math.exp(logvol / (-n))
            self.normalized_radius = math.sqrt(
                self.enumeration_radius * self.normalization_factor)
        r = r * self.normalization_factor
        ipv = 1.0 / np.cumprod(np.sqrt(r))
        return r, ipv

    def _load_shapes(self, shapes):
        ipvs = []
        for k, g in enumerate(shapes):
            r, ipv = self._load_shape(g, k == 0)
            if k == 0:
                self.r = r
            ipvs.append(ipv)
        self.ipv = np.mean(ipvs, axis=0)

    def gaussian_heuristic(self) -> float:
        return math.exp(2.0 * _log_ball_vol(self.n) / (-self.n)) / \
            self.normalization_factor

    # -- half/full coefficient helpers --------------------------------------
    def _to_evec(self, b) -> np.ndarray:
        b = np.asarray(b, dtype=np.float64)
        if len(b) == self.d:
            return b
        lo, hi = b[0::2][:self.d], b[1::2][:self.d]
        return (lo + hi) / 2.0  # averaging role of lower/upper bounds

    def _full_cost(self, b) -> float:
        b = np.asarray(b, dtype=np.float64)
        if len(b) == self.d:
            return self._single_enum_cost_evec(b)
        return 0.5 * (self._single_enum_cost_evec(b[0::2][:self.d]) +
                      self._single_enum_cost_evec(b[1::2][:self.d]))

    # -- cost (pruner_cost.cpp:8-67) -----------------------------------------
    def _single_enum_cost_evec(self, b, detailed: Optional[list] = None) -> float:
        d, n = self.d, self.n
        lib = _native_lib()
        if lib is not None:
            det = np.zeros(2 * d) if detailed is not None else None
            total = float(lib.pruner_cost_evec(
                d, np.ascontiguousarray(b, dtype=np.float64),
                np.ascontiguousarray(self.ipv[:2 * d], dtype=np.float64),
                self.normalized_radius, self.symmetry_factor,
                det.ctypes.data if det is not None else None))
            if detailed is not None:
                detailed[:2 * d] = det.tolist()
            if not math.isfinite(total):
                raise OverflowError("NaN or inf in single_enum_cost")
            return total
        rv = np.zeros(2 * d)
        for i in range(d):
            rv_odd = _relative_volume(i + 1, b)
            rv[2 * i + 1] = rv_odd
        rv[0] = 1.0
        for i in range(1, d):
            rv[2 * i] = math.sqrt(rv[2 * i - 1] * rv[2 * i + 1])
        total = 0.0
        rp = self.normalized_radius
        for i in range(2 * d):
            tmp = rp * rv[i] * _TAB_BALL_VOL[i + 1] * \
                math.sqrt(b[i // 2] ** (1 + i)) * self.ipv[i]
            tmp *= self.symmetry_factor
            if detailed is not None:
                detailed[2 * d - (i + 1)] = tmp
            total += tmp
            rp *= self.normalized_radius
        if not math.isfinite(total):
            raise OverflowError("NaN or inf in single_enum_cost")
        return total

    def single_enum_cost(self, pr, detailed_cost: Optional[list] = None) -> float:
        b = np.asarray(pr, dtype=np.float64)
        if len(b) == self.n:  # full-length caller coefficients
            b = self._load_coefficients(pr)
        if detailed_cost is not None:
            while len(detailed_cost) < self.n:
                detailed_cost.append(0.0)
        if len(b) == self.d:
            return self._single_enum_cost_evec(b, detailed_cost)
        return 0.5 * (self._single_enum_cost_evec(b[0::2][:self.d],
                                                  detailed_cost) +
                      self._single_enum_cost_evec(b[1::2][:self.d],
                                                  detailed_cost))

    # -- success metrics (pruner_prob.cpp) -----------------------------------
    def _svp_probability_evec(self, b) -> float:
        d = self.d
        lib = _native_lib()
        if lib is not None:
            res = float(lib.pruner_svp_prob_evec(
                d, np.ascontiguousarray(b, dtype=np.float64),
                self.shell_ratio))
            if not math.isfinite(res):
                raise OverflowError("NaN or inf in svp_probability")
            return res
        dx = self.shell_ratio
        bmdb = np.minimum(np.asarray(b) / (dx * dx), 1.0)
        vol = _relative_volume(d, b)
        dxn = dx ** (2 * d)
        dvol = dxn * _relative_volume(d, bmdb) - vol
        res = dvol / (dxn - 1.0)
        if not math.isfinite(res):
            raise OverflowError("NaN or inf in svp_probability")
        return res

    def _measure_metric(self, b) -> float:
        """INTERNAL-order overload (reference pruner.h:776 takes vec&
        directly; the user-order one at pruner.h:578 reverses first).
        The optimizer passes hold internal-order vectors — coercing them
        again would double-reverse and feed a decreasing profile into
        the simplex recurrence."""
        if self.metric == PRUNER_METRIC_PROBABILITY_OF_SHORTEST:
            return self._svp_probability(b)
        return self._expected_solutions(b)

    def measure_metric(self, pr) -> float:
        return self._measure_metric(self._coerce(pr))

    def _coerce(self, pr) -> np.ndarray:
        b = np.asarray(pr, dtype=np.float64)
        if len(b) == self.n and self.n != self.d:
            b = self._load_coefficients(pr)
        return b

    def _svp_probability(self, b) -> float:
        b = np.asarray(b, dtype=np.float64)
        if len(b) == self.d:
            return self._svp_probability_evec(b)
        pl = self._svp_probability_evec(b[0::2][:self.d])
        pu = self._svp_probability_evec(b[1::2][:self.d])
        return (pl + pu) / 2.0

    def svp_probability(self, pr) -> float:
        return self._svp_probability(self._coerce(pr))

    def _expected_solutions_evec(self, b) -> float:
        d = self.d
        j = 2 * d - 1
        t = math.log(max(_relative_volume(d, b), 1e-300))
        t += math.log(_TAB_BALL_VOL[j + 1])
        t += (math.log(self.normalized_radius) + math.log(b[j // 2]) / 2.0) * (j + 1)
        t += math.log(self.ipv[j])
        t += math.log(self.symmetry_factor)
        return math.exp(t)

    def _expected_solutions(self, b) -> float:
        b = np.asarray(b, dtype=np.float64)
        if len(b) == self.d:
            return self._expected_solutions_evec(b)
        return 0.5 * (self._expected_solutions_evec(b[0::2][:self.d]) +
                      self._expected_solutions_evec(b[1::2][:self.d]))

    def expected_solutions(self, pr) -> float:
        return self._expected_solutions(self._coerce(pr))

    # -- target function (pruner_cost.cpp:136-198) ---------------------------
    def target_function(self, b) -> float:
        b = np.asarray(b, dtype=np.float64)
        if self.metric == PRUNER_METRIC_PROBABILITY_OF_SHORTEST:
            probability = min(self._svp_probability(b), 0.999999)
            probability = max(probability, 1e-12)
            trials = math.log(1.0 - self.target) / math.log(1.0 - probability)
        else:
            expected = max(self._expected_solutions(b), 1e-300)
            trials = self.target / expected
        trials = max(trials, 1.0)
        return self._full_cost(b) * trials + self.preproc_cost * (trials - 1.0)

    def repeated_enum_cost(self, pr) -> float:
        return self.target_function(self._coerce(pr))

    # -- constraints (pruner.h:1012-1053) ------------------------------------
    def enforce(self, b: np.ndarray, j: int = 0) -> bool:
        dn = len(b)
        c = 1 if dn == self.d else 2
        status = False
        if b[dn - 1] < 0.999 and j != dn - 1:
            status = True
            b[dn - 1] = 1.0
        for i in range(dn):
            status |= bool(b[i] > 1.0001)
            if b[i] > 1:
                b[i] = 1.0
            if i // c < self.d and b[i] <= self.min_pruning_coefficients[i // c]:
                b[i] = self.min_pruning_coefficients[i // c]
        for i in range(j, dn - 1):
            if b[i + 1] < b[i]:
                status |= bool(b[i + 1] + 1e-6 < b[i])
                b[i + 1] = b[i]
        for i in range(min(j - 1, dn - 2), -1, -1):
            if b[i + 1] < b[i]:
                status |= bool(b[i + 1] + 1e-6 < b[i])
                b[i] = b[i + 1]
        return status

    # -- coefficient IO (pruner_util.cpp:97-119) -----------------------------
    def _load_coefficients(self, pr, full: bool = True) -> np.ndarray:
        """User order -> internal reversed order (pruner_util.cpp:124-132).
        full=True keeps all n entries; full=False loads the evec (even
        positions of the reversed vector)."""
        pr = np.asarray(pr, dtype=np.float64)
        if len(pr) != self.n:
            return pr.copy()
        rev = pr[::-1].copy()
        # exactly d evec entries even when n is odd (reference
        # load_coefficients reads pr[n-1-2i] for i < d,
        # pruner_util.cpp:99-110)
        return rev if full else rev[0::2][:self.d].copy()

    def _save_coefficients(self, b) -> List[float]:
        pr = [0.0] * self.n
        b = np.asarray(b)
        if len(b) == self.d:
            for i in range(self.d):
                pr[self.n - 1 - 2 * i] = float(b[i])
                pr[self.n - 2 - 2 * i] = float(b[i])
        else:
            for i in range(self.n):
                pr[self.n - 1 - i] = float(b[i])
        pr[0] = 1.0
        return pr

    # -- optimizers -----------------------------------------------------------
    def _gradient(self, b: np.ndarray) -> np.ndarray:
        """log-target gradient: the torch.autograd gradient of the
        polynomial cost on the pruner's device when it applies (evec
        vector, moderate d — see pruner/torchgrad.py), else the
        reference's numerical epsilon scheme (pruner_cost.cpp:115-134);
        last coordinate pinned. FPLLL_TPU_PRUNER_JAXGRAD=0 (the JAX
        package's knob) selects the numerical scheme."""
        import os
        if os.environ.get("FPLLL_TPU_PRUNER_JAXGRAD", "1") == "1":
            from . import torchgrad
            g = torchgrad.gradient(self, b, device=self.device)
            if g is not None:
                return g
        dn = len(b)
        res = np.zeros(dn)
        for i in range(dn - 1):
            bm = b.copy()
            bm[i] *= (1.0 - self.epsilon)
            self.enforce(bm, i)
            X = self.target_function(bm)
            bp = b.copy()
            bp[i] *= (1.0 + self.epsilon)
            self.enforce(bp, i)
            Y = self.target_function(bp)
            res[i] = (math.log(max(X, 1e-300)) - math.log(max(Y, 1e-300))) \
                / self.epsilon
        return res

    def _gradient_descent_step(self, b: np.ndarray) -> int:
        cf = self.target_function(b)
        gradient = self._gradient(b)
        norm = float(np.linalg.norm(gradient))
        if norm <= 0.0:
            return 0
        gradient /= norm * len(b)
        step = self.min_step
        new_b = b.copy()
        improved = False
        while True:
            nb = new_b + step * gradient * new_b
            self.enforce(nb)
            new_cf = self.target_function(nb)
            if new_cf >= cf:
                break
            cf = new_cf
            new_b = nb
            improved = True
            step *= 2.0
        if improved:
            b[:] = new_b
            return 1
        return -1

    def _gradient_descent(self, b: np.ndarray) -> None:
        old_eps, old_step = self.epsilon, self.min_step
        trials = 0
        for _ in range(200):
            ret = self._gradient_descent_step(b)
            if ret == 0:
                break
            if ret < 0:
                self.epsilon *= 0.9
                self.min_step *= 0.9
                trials += 1
                if trials >= 5:
                    break
            else:
                trials = max(trials - 1, 0)
        self.epsilon, self.min_step = old_eps, old_step

    def _nelder_mead(self, b: np.ndarray) -> None:
        try:
            from scipy.optimize import minimize
        except ImportError:
            return

        def f(x):
            y = x.copy()
            self.enforce(y)
            return math.log(max(self.target_function(y), 1e-300))

        res = minimize(f, b, method="Nelder-Mead",
                       options={"maxiter": 200 * len(b), "fatol": 1e-6,
                                "xatol": 1e-6})
        y = res.x.copy()
        self.enforce(y)
        if self.target_function(y) < self.target_function(b):
            b[:] = y

    # -- internal-order cost helper (used by the local-adjust passes) ---------
    def _cost_detailed(self, b, detailed: list) -> float:
        """single_enum_cost over an INTERNAL-order vector (evec or full),
        filling `detailed` (n entries, user order) — the reference's
        single_enum_cost(vec&, vector<double>*) overload
        (pruner_cost.cpp:97-113: full vectors average the lower/upper
        evec costs; detailed keeps the upper call's values)."""
        b = np.asarray(b, dtype=np.float64)
        while len(detailed) < self.n:
            detailed.append(0.0)
        if len(b) == self.d:
            return self._single_enum_cost_evec(b, detailed)
        return 0.5 * (self._single_enum_cost_evec(b[0::2][:self.d],
                                                  detailed) +
                      self._single_enum_cost_evec(b[1::2][:self.d],
                                                  detailed))

    # -- greedy init (pruner_optimize_tc.cpp greedy) --------------------------
    def _greedy(self) -> np.ndarray:
        """Greedy pruning profile: walk the odd levels outward, shrinking
        each coefficient until the level's node count fits a parabolic
        width budget (pruner_optimize_tc.cpp:683-737)."""
        n, d = self.n, self.d
        self.min_pruning_coefficients[:] = 0.0
        b = np.ones(d)
        for j in range(1, 2 * d - 1, 2):
            i = j // 2
            if i > 1:
                b[i] = 1.0 if b[i - 1] > .9 else 1.1 * b[i - 1]
            goal_factor = 1.0 / (3.0 * n) + 4.0 * j * (n - j) / float(n) ** 3
            nodes = 1.0 + 1e10 * self.preproc_cost
            while nodes > goal_factor * self.preproc_cost and b[i] > .001:
                b[i] *= .98
                b[:i] = np.minimum(b[:i], b[i])
                nodes = _relative_volume((j + 1) // 2, b) \
                    * _TAB_BALL_VOL[j + 1] \
                    * (self.normalized_radius * math.sqrt(b[i])) ** (j + 1) \
                    * self.ipv[j] * self.symmetry_factor
        return b

    def _assign(self, pr, out: List[float]) -> None:
        if isinstance(pr, list):
            pr[:] = out

    # -- stage drivers (pruner_optimize.cpp / _tc.cpp) ------------------------
    def optimize_coefficients_preparation(self, pr) -> None:
        """Raw starting coefficients + min-coefficient floor
        (pruner_optimize_tc.cpp:11-60)."""
        if (self.flags & PRUNER_START_FROM_INPUT) and len(pr) == self.n:
            b = self._load_coefficients(pr, full=False)
        else:
            b = self._greedy()
        if self.flags & (PRUNER_GRADIENT | PRUNER_NELDER_MEAD):
            # lower bound for enforce(): greedy at 10x cheaper preproc
            self.preproc_cost *= .1
            saved_b = b.copy()
            self.min_pruning_coefficients = self._greedy()
            b = saved_b
            if not self.opt_single:
                # for fixed-prob optimization the floor must not already
                # overshoot the target probability
                pr_min = self._save_coefficients(
                    self.min_pruning_coefficients)
                if self._measure_metric(self.min_pruning_coefficients) \
                        > self.target:
                    self.min_pruning_coefficients[:] = 0.0
                    self.optimize_coefficients_decr_prob(pr_min)
                    self.min_pruning_coefficients = \
                        self._load_coefficients(pr_min, full=False)
            self.preproc_cost *= 10
        self._assign(pr, self._save_coefficients(b))

    def optimize_coefficients_evec_core(self, pr) -> None:
        """Gradient descent + Nelder-Mead under the b_{2i} = b_{2i+1}
        constraint (pruner_optimize_tc.cpp:73-115)."""
        b = self._load_coefficients(pr, full=False)
        if self.flags & PRUNER_GRADIENT:
            self._gradient_descent(b)
        if self.flags & PRUNER_NELDER_MEAD:
            self._nelder_mead(b)
        self._assign(pr, self._save_coefficients(b))

    def optimize_coefficients_full_core(self, pr) -> None:
        """Unconstrained (full-length) descent + Nelder-Mead
        (pruner_optimize_tc.cpp:130-180)."""
        b = self._load_coefficients(pr, full=True)
        if self.flags & PRUNER_GRADIENT:
            self._gradient_descent(b)
        if self.flags & PRUNER_NELDER_MEAD:
            self._nelder_mead(b)
        self._assign(pr, self._save_coefficients(b))

    def optimize_coefficients_evec(self, pr) -> None:
        self.optimize_coefficients_preparation(pr)
        self.optimize_coefficients_evec_core(pr)

    def optimize_coefficients_full(self, pr) -> None:
        self.optimize_coefficients_preparation(pr)
        self.optimize_coefficients_full_core(pr)

    # -- local-adjust heuristics (pruner_optimize_tc.cpp:183-457) -------------
    def optimize_coefficients_local_adjust_decr_single(self, pr) -> None:
        """Shrink the bottleneck coefficient toward its left neighbour
        while the repeated-enum cost improves
        (pruner_optimize_tc.cpp:186-278)."""
        n = self.n
        b = self._load_coefficients(pr, full=True)
        detailed = [0.0] * n
        slices = [10.0] * n
        thresholds = [3] * n
        lasti = -1
        consecutive_fails = 0
        improved_ratio = 0.995
        while True:
            old_cf = self.target_function(b)
            old_cfs = self._cost_detailed(b, detailed)
            # balance heuristic: stop once the single-enum cost is tiny
            # next to the repeated cost (BALANCE_HEURISTIC_PRUNER_OPTIMIZE)
            if old_cfs < math.sqrt(old_cf) / 10.0:
                break
            current_max, maxi = 0.0, 0
            for i in range(n):
                if i != (n - lasti - 1) and thresholds[n - i - 1] > 0 \
                        and detailed[i] > current_max:
                    current_max, maxi = detailed[i], i
            ind = n - maxi - 1
            if ind == 0:
                break
            old_b = b[ind]
            b[ind] = b[ind] - (b[ind] - b[ind - 1]) / slices[ind]
            new_cf = self.target_function(b)
            if new_cf >= old_cf * improved_ratio:
                b[ind] = old_b
                lasti = ind
                thresholds[lasti] -= 1
                consecutive_fails += 1
            else:
                if slices[ind] < 1024:
                    slices[ind] *= 1.05
                consecutive_fails = 0
            if consecutive_fails > 10:
                break
        self._assign(pr, self._save_coefficients(b))

    def optimize_coefficients_local_adjust_incr_prob(self, pr) -> None:
        """Raise coefficients below the bottleneck level to grow the
        success probability while the repeated cost tolerates it
        (pruner_optimize_tc.cpp:284-380)."""
        n = self.n
        b = self._load_coefficients(pr, full=True)
        detailed = [0.0] * n
        slices = [10.0] * n
        old_cf0 = self.target_function(b)
        tours = 0
        while True:
            tours += 1
            old_cf = self.target_function(b)
            old_cfs = self._cost_detailed(b, detailed)
            current_max, maxi = 0.0, 0
            for i in range(n):
                if detailed[i] > current_max:
                    current_max, maxi = detailed[i], i
            ind = n - maxi - 1
            if ind <= 1:
                break
            if old_cfs > math.sqrt(old_cf) / 10.0:
                break
            for i in range(ind, 0, -1):
                if b[i] <= b[i - 1]:
                    continue
                trials = 0
                while True:
                    old_cf = self.target_function(b)
                    old_b = b[i - 1]
                    b[i - 1] = b[i - 1] + (b[i] - b[i - 1]) / slices[i - 1]
                    new_cf = self.target_function(b)
                    if new_cf >= old_cf * 1.2:
                        b[i - 1] = old_b
                        break
                    if slices[i - 1] < 1024:
                        slices[i - 1] *= 1.2
                    trials += 1
                    if trials >= 10:
                        break
            new_cf = self.target_function(b)
            if new_cf > old_cf0 * 1.1 or tours > 4:
                break
        self._assign(pr, self._save_coefficients(b))

    def optimize_coefficients_local_adjust_smooth(self, pr) -> None:
        """Smooth discontinuities between consecutive coefficients
        (pruner_optimize_tc.cpp:385-414)."""
        n = self.n
        b = self._load_coefficients(pr, full=True)
        th = 1.0 / n
        for i in range(1, n - 1):
            lr = b[i] / b[i - 1] if b[i - 1] else 1.0
            rr = b[i + 1] / b[i] if b[i] else 1.0
            if lr and (rr / lr > 1.25 or rr / lr < 0.8):
                b[i] = math.sqrt(b[i - 1] * b[i + 1])
            if (b[i + 1] - b[i]) > th or (b[i] - b[i - 1]) > th:
                b[i] = (b[i - 1] + b[i + 1]) / 2.0
        self._assign(pr, self._save_coefficients(b))

    # -- probability-targeting passes (pruner_optimize_tp.cpp) ----------------
    _PROB_MINSTEP = 1e-4
    _PROB_MAXSTEP = 1e4

    def _prob_step_weights(self, b) -> np.ndarray:
        """Per-index step weights: inverse cumulative level cost
        (pruner_optimize_tp.cpp:33-49)."""
        n = self.n
        detailed = [0.0] * n
        self._cost_detailed(b, detailed)
        tail = np.cumsum(np.asarray(detailed)[::-1])[::-1]
        weight = 1.0 / np.maximum(tail, 1e-300)
        weight = np.maximum(weight, self._PROB_MINSTEP)
        return weight / weight.sum()

    def optimize_coefficients_incr_prob(self, pr) -> None:
        """Increase coefficients (weighted) until the metric reaches the
        target (pruner_optimize_tp.cpp:8-72)."""
        b = self._load_coefficients(pr, full=True)
        tours = 0
        while tours <= self._PROB_MAXSTEP:
            tours += 1
            if self._measure_metric(b) >= self.target:
                break
            weight = self._prob_step_weights(b)
            old_b = b.copy()
            b = np.minimum(b + weight, 1.0)
            self.enforce(b)
            if np.array_equal(b, old_b):
                break
        self._assign(pr, self._save_coefficients(b))

    def optimize_coefficients_decr_prob(self, pr) -> None:
        """Decrease coefficients (weighted) until the metric drops to the
        target (pruner_optimize_tp.cpp:74-140)."""
        b = self._load_coefficients(pr, full=True)
        tours = 0
        while tours <= self._PROB_MAXSTEP:
            tours += 1
            if self._measure_metric(b) <= self.target:
                break
            weight = self._prob_step_weights(b)
            old_b = b.copy()
            b = np.maximum(b - weight, self._PROB_MINSTEP)
            self.enforce(b)
            if np.array_equal(b, old_b):
                break
        self._assign(pr, self._save_coefficients(b))

    def optimize_coefficients_local_adjust_prob(self, pr) -> None:
        """Uniform +-MINSTEP nudges until the metric is within 5% of the
        target (pruner_optimize_tp.cpp:142-205)."""
        b = self._load_coefficients(pr, full=True)
        while True:
            ratio = self._measure_metric(b) / self.target
            if 0.95 < ratio < 1.05:
                break
            old_b = b.copy()
            if ratio < 1:
                b = np.minimum(b + self._PROB_MINSTEP, 1.0)
            else:
                b = np.maximum(b - self._PROB_MINSTEP, self._PROB_MINSTEP)
            self.enforce(b)
            if np.array_equal(b, old_b):
                break
        self._assign(pr, self._save_coefficients(b))

    # -- top-level drivers (pruner_optimize.cpp) ------------------------------
    _NUM_OPTIMIZATION_TOURS = 3

    def optimize_coefficients_cost_vary_prob(self, pr) -> None:
        """Minimize the repeated-enum cost, letting the success
        probability float (pruner_optimize.cpp:8-100)."""
        self.optimize_coefficients_preparation(pr)
        self.optimize_coefficients_evec_core(pr)
        b = self._load_coefficients(pr, full=True)
        best_b = b.copy()
        min_c = self.target_function(b)
        if not (self.flags & PRUNER_HALF):
            tours = 0
            while tours < 20:  # safety cap; reference loops unboundedly
                tours += 1
                b = self._load_coefficients(pr, full=True)
                old_c0 = self.target_function(b)
                self.optimize_coefficients_local_adjust_decr_single(pr)
                self.optimize_coefficients_local_adjust_incr_prob(pr)
                self.optimize_coefficients_local_adjust_smooth(pr)
                b = self._load_coefficients(pr, full=True)
                old_c1 = self.target_function(b)
                if old_c1 < min_c:
                    min_c, best_b = old_c1, b.copy()
                self.optimize_coefficients_full_core(pr)
                b = self._load_coefficients(pr, full=True)
                new_c = self.target_function(b)
                if new_c < min_c:
                    min_c, best_b = new_c, b.copy()
                if new_c / old_c0 > 0.995 and \
                        tours > self._NUM_OPTIMIZATION_TOURS:
                    break
            self._assign(pr, self._save_coefficients(best_b))

    def optimize_coefficients_cost_fixed_prob(self, pr) -> None:
        """Minimize the single-enum cost subject to hitting the target
        probability (pruner_optimize.cpp:102-146)."""
        self.optimize_coefficients_preparation(pr)
        self.optimize_coefficients_evec_core(pr)
        self.optimize_coefficients_local_adjust_smooth(pr)
        self.optimize_coefficients_full_core(pr)
        self.optimize_coefficients_local_adjust_smooth(pr)
        b = self._load_coefficients(pr, full=True)
        if self._measure_metric(b) <= self.target:
            self.optimize_coefficients_incr_prob(pr)
        else:
            self.optimize_coefficients_decr_prob(pr)
        self.optimize_coefficients_local_adjust_smooth(pr)
        self.optimize_coefficients_local_adjust_prob(pr)

    def optimize_coefficients(self, pr: List[float]) -> List[float]:
        """Main entry (pruner_optimize.cpp:149-160): returns the full-
        length coefficient vector (also written back into pr if given
        non-empty)."""
        work = list(pr) if len(pr) == self.n else [0.0] * self.n
        if self.opt_single:
            self.optimize_coefficients_cost_fixed_prob(work)
        else:
            self.optimize_coefficients_cost_vary_prob(work)
        self._assign(pr, work)
        return work


# ---------------------------------------------------------------------------
# Flat wrappers (reference: pruner/pruner.cpp:32-188)
# ---------------------------------------------------------------------------
def prune(enumeration_radius: float, preproc_cost: float, gso_r,
          target: float = 0.9,
          metric: int = PRUNER_METRIC_PROBABILITY_OF_SHORTEST,
          flags: int = PRUNER_GRADIENT, pruning=None, device=None):
    """Optimize pruning coefficients; fills/returns a PruningParams.
    The analytic gradient runs on `device` (Pruner)."""
    from ..algs.bkz_param import PruningParams
    pr = Pruner(enumeration_radius, preproc_cost, gso_r, target, metric, flags,
                device=device)
    out = pruning if pruning is not None else PruningParams()
    # the reference hands pruning.coefficients straight to the optimizer
    # (pruner.cpp:210) so PRUNER_START_FROM_INPUT sees the previous result
    coeffs = pr.optimize_coefficients(list(getattr(out, "coefficients", []) or []))
    out.coefficients = coeffs
    out.gh_factor = enumeration_radius / pr.gaussian_heuristic()
    out.expectation = pr.measure_metric(coeffs)
    out.metric = metric
    out.detailed_cost = []
    pr.single_enum_cost(coeffs, out.detailed_cost)
    return out


def svp_probability(pruning) -> float:
    """Success probability of a single pruned enumeration
    (pruner.cpp svp_probability wrapper)."""
    coefficients = getattr(pruning, "coefficients", pruning)
    b = np.asarray(coefficients, dtype=np.float64)
    p = Pruner.__new__(Pruner)
    p.n = len(b)
    p.d = p.n // 2
    p.shell_ratio = 0.995
    p.min_pruning_coefficients = np.zeros(p.d)
    if len(b) == p.d:
        return p._svp_probability_evec(b)
    rev = b[::-1]
    pl = p._svp_probability_evec(rev[0::2][:p.d])
    pu = p._svp_probability_evec(rev[1::2][:p.d])
    return (pl + pu) / 2.0


def run_pruner(b, sel_ft=None, precision: int = 0, prune_start: int = 0,
               prune_end: int = -1, prune_pre_nodes: float = 1e6,
               prune_min_prob: float = -1, gh_factor: float = 1.0):
    """CLI entry (`fplll -a pru`): computes the GSO of b then optimizes
    pruning coefficients for the block [prune_start, prune_end)
    (pruner.cpp:32-114 run_pruner_f)."""
    from ..core.gso import MatGSO
    from ..defs import GSO_ROW_EXPO, PRUNER_METRIC_EXPECTED_SOLUTIONS
    from ..nr.fctx import MPCtx
    import math as _m
    if prune_end == -1:
        prune_end = b.nrows

    def collect_r(ctx=None):
        m = MatGSO(b, flags=GSO_ROW_EXPO, **({"ctx": ctx} if ctx else {}))
        m.update_gso()
        out = []
        for i in range(prune_start, prune_end):
            v, e = m.get_r_exp(i, i)
            out.append(_m.ldexp(m.ctx.to_float(v), e))
        return out

    gso_r = collect_r()
    if min(gso_r) <= 0.0:
        # f64 cancellation on big-entry unreduced bases can produce
        # nonpositive r; escalate precision like the wrapper ladder does
        # (the reference's double path silently degrades here instead,
        # pruner.cpp:64-88)
        gso_r = collect_r(MPCtx(max(106, 10 + 2 * b.get_max_exp())))
    # radius: gh_factor * gaussian heuristic of the block
    n = len(gso_r)
    logvol = sum(_m.log(x) for x in gso_r)
    # GH radius^2 = (vol(L) / ball_vol(n))^(2/n); vol(L)^2 = prod r_i
    gh = _m.exp((logvol / n) - 2.0 * _log_ball_vol(n) / n)
    radius = gh_factor * gh
    if prune_min_prob > 0:
        target = prune_min_prob
        metric = PRUNER_METRIC_PROBABILITY_OF_SHORTEST
        flags = PRUNER_GRADIENT | PRUNER_NELDER_MEAD
    else:
        target = 1.0
        metric = PRUNER_METRIC_EXPECTED_SOLUTIONS
        flags = PRUNER_GRADIENT | PRUNER_NELDER_MEAD
    return prune(radius, prune_pre_nodes, gso_r, target, metric, flags)
