"""fpylll's BKZ-2.0 SVP oracle on one window: ``Enumeration(M).enumerate(
kappa, kappa + block, radius, 0, pruning=...)`` through the port's
fpylll veneer, as fpylll's BKZ2 ``svp_reduction`` calls it.

Set-up builds a ``GSO.Mat`` (float64, fpylll's default) of every pool
basis and updates it; a request is one row of the pool's ``win`` table
(basis, kappa, squared radius, pruning set of the configuration). The
answer is (squared length, coordinates) of the best vector, or None
when the port raises ``EnumerationError`` (no vector in the bound), a
valid answer. Anything else it raises, or a malformed answer, fails the
request.
"""

from __future__ import annotations

import math


class Entry:
    def __init__(self, config: dict, pool: dict, table: list):
        from fplll_tpu_torch.fpylll import (GSO, Enumeration,
                                            EnumerationError, IntegerMatrix)
        self._enum, self._empty = Enumeration, EnumerationError
        self.table = table
        self.beta = int(config["block_size"])
        self.prunings = [[float(c) for c in s["coefficients"]]
                         for s in config["pruning"]["sets"]]
        self.gsos = []
        for rows in pool["bases"]:
            m = GSO.Mat(IntegerMatrix.from_matrix(rows.tolist()))
            m.update_gso()
            self.gsos.append(m)

    def solve(self, row: int):
        req = self.table[row]
        k = int(req["kappa"])
        e = self._enum(self.gsos[int(req["basis"])])
        try:
            sols = e.enumerate(k, k + self.beta, float(req["radius"]), 0,
                               pruning=self.prunings[int(req["prune"])])
        except self._empty:
            return None
        if not sols:
            raise ValueError("enumerate returned an empty list")
        dist, coords = sols[0]
        if not math.isfinite(dist) or len(coords) != self.beta:
            raise ValueError(f"malformed answer: length {dist}, "
                             f"{len(coords)} coordinates")
        return float(dist), tuple(coords)
