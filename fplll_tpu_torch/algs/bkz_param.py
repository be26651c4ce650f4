"""BKZ parameters, strategies and the JSON strategy loader.

Re-design of fplll/bkz_param.{h,cpp}: PruningParams /
Strategy / BKZParam (bkz_param.h:34-176), linear-pruning fallback
(bkz_param.cpp:11-37), closest-gh-factor strategy selection
(bkz_param.cpp:62-78) and the byte-compatible strategies JSON loader
(bkz_param.cpp:80-157).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import List

from ..defs import (BKZ_DEF_AUTO_ABORT_MAX_NO_DEC, BKZ_DEF_AUTO_ABORT_SCALE,
                    BKZ_DEF_GH_FACTOR, BKZ_DEF_MIN_SUCCESS_PROBABILITY,
                    BKZ_DEF_RERANDOMIZATION_DENSITY, BKZ_DEFAULT,
                    LLL_DEF_DELTA, PRUNER_METRIC_PROBABILITY_OF_SHORTEST)

__all__ = ["PruningParams", "Strategy", "BKZParam", "load_strategies_json",
           "default_strategy_path", "strategy_full_path"]


@dataclass
class PruningParams:
    """One pruning-coefficient set (bkz_param.h:34-66)."""

    gh_factor: float = 1.0
    coefficients: List[float] = field(default_factory=list)
    expectation: float = 1.0
    metric: int = PRUNER_METRIC_PROBABILITY_OF_SHORTEST
    detailed_cost: List[float] = field(default_factory=list)

    @staticmethod
    def LinearPruningParams(block_size: int, level: int) -> "PruningParams":
        """Linear pruning: flat 1.0 then linear descent over the last
        `level` indices (bkz_param.cpp:11-37)."""
        p = PruningParams()
        start_descent = block_size - level
        start_descent = min(max(start_descent, 1), block_size)
        p.coefficients = [1.0] * block_size
        for k in range(block_size - start_descent):
            p.coefficients[start_descent + k] = float(block_size - k - 1) / block_size
        p.gh_factor = 1.0
        from ..pruner.pruner import svp_probability
        p.expectation = svp_probability(p.coefficients)
        return p


@dataclass
class Strategy:
    """Per-block-size pruning sets + preprocessing blocks (bkz_param.h:34)."""

    block_size: int = 0
    pruning_parameters: List[PruningParams] = field(default_factory=list)
    preprocessing_block_sizes: List[int] = field(default_factory=list)

    @staticmethod
    def EmptyStrategy(block_size: int) -> "Strategy":
        return Strategy(block_size=block_size,
                        pruning_parameters=[PruningParams()])

    def get_pruning(self, radius: float, gh: float) -> PruningParams:
        """Pick the set whose gh_factor is closest to radius/gh
        (bkz_param.cpp:62-78)."""
        gh_factor = radius / gh
        best = self.pruning_parameters[0]
        closest = float("inf")
        for p in self.pruning_parameters:
            dd = abs(p.gh_factor - gh_factor)
            if dd < closest:
                closest = dd
                best = p
        return best


class BKZParam:
    """BKZ driver parameters (bkz_param.h:68-176)."""

    def __init__(self, block_size: int, strategies: List[Strategy] | None = None,
                 delta: float = LLL_DEF_DELTA, flags: int = BKZ_DEFAULT,
                 max_loops: int = 0, max_time: float = 0,
                 auto_abort_scale: float = BKZ_DEF_AUTO_ABORT_SCALE,
                 auto_abort_max_no_dec: int = BKZ_DEF_AUTO_ABORT_MAX_NO_DEC,
                 gh_factor: float = BKZ_DEF_GH_FACTOR,
                 min_success_probability: float = BKZ_DEF_MIN_SUCCESS_PROBABILITY,
                 rerandomization_density: int = BKZ_DEF_RERANDOMIZATION_DENSITY):
        self.block_size = block_size
        if not strategies:
            strategies = [Strategy.EmptyStrategy(b)
                          for b in range(block_size + 1)]
        self.strategies = strategies
        self.delta = delta
        self.flags = flags
        self.max_loops = max_loops
        self.max_time = max_time
        self.auto_abort_scale = auto_abort_scale
        self.auto_abort_max_no_dec = auto_abort_max_no_dec
        self.gh_factor = gh_factor
        self.dump_gso_filename = "gso.json"
        self.min_success_probability = min_success_probability
        self.rerandomization_density = rerandomization_density


def default_strategy_path() -> str:
    return os.environ.get("FPLLL_TPU_STRATEGY_PATH",
                          os.path.join(os.path.dirname(__file__), "..",
                                       "strategies"))


def default_strategy() -> str:
    return os.path.join(default_strategy_path(), "default.json")


def strategy_full_path(strategy_path: str) -> str:
    if os.path.isfile(strategy_path):
        return strategy_path
    path = os.path.join(default_strategy_path(), strategy_path)
    if os.path.isfile(path):
        return path
    return ""


def load_strategies_json(filename: str) -> List[Strategy]:
    """Load the fplll strategies JSON format (bkz_param.cpp:80-157)."""
    path = strategy_full_path(filename)
    if not path:
        raise IOError(f"Cannot open strategies file: {filename}")
    with open(path) as f:
        return strategies_from_json(json.load(f))


def strategies_from_json(js: list) -> List[Strategy]:
    """Strategies from the parsed fplll strategies JSON (a list with one
    object per block size)."""
    strategies: List[Strategy] = []
    for j_strat in js:
        block_size = int(j_strat["block_size"])
        while len(strategies) <= block_size:
            strategies.append(Strategy())
        strat = Strategy(block_size=block_size)
        for p in j_strat.get("preprocessing_block_sizes", []):
            strat.preprocessing_block_sizes.append(
                int(p if isinstance(p, (int, float)) else p["block_size"]))
        for j_prun in j_strat.get("pruning_parameters", []):
            pruning = PruningParams()
            pruning.gh_factor = float(j_prun[0])
            pruning.coefficients = [float(c) for c in j_prun[1]]
            pruning.expectation = float(j_prun[2])
            pruning.metric = PRUNER_METRIC_PROBABILITY_OF_SHORTEST
            strat.pruning_parameters.append(pruning)
        strategies[block_size] = strat

    for s in strategies:
        if not s.pruning_parameters:
            s.pruning_parameters.append(PruningParams())
    return strategies
