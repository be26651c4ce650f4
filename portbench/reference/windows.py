"""The judge of pruned windows (cells whose ``judge`` is ``windows``).

A request is a row of the pool's window table: the basis, kappa, the
squared radius and the index of its pruning set among the
configuration's ``pruning.sets``. An answer is a vector of the
window, given by its coordinates on b_kappa .. b_{kappa+n-1}, with the
squared length the program reports, or nothing ("no vector in the
bound").

- ``bad_answers``: answers whose coordinates are not integers, or give
  the zero vector (limit 0);
- ``answer_err``: the largest of these two, over every answer:
  - ``dist_err``: the gap between the reported squared length and the
    true squared length of the answer's projected vector, relative to
    the true one;
  - ``missed_gap``: the share by which the reference's shortest vector
    of the pruning region P(B) lies below B, where B is the true squared
    length of the answer, or the radius for an empty answer. A pruned
    search that ends on w leaves nothing in P(|w|^2) shorter than w, so
    a sound run reads 0 but for the rounding of its tree.

  An answer is as wrong as the worse of the two: a length misreported,
  or a shorter vector missed. Both parts are returned beside it.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import enum as ref_enum
from . import gso as ref_gso

__all__ = ["judge", "control"]


class _Bases:
    """The reference's GSO of each pool basis, worked out once."""

    def __init__(self, bases: np.ndarray):
        self.bases = bases
        self._gso: Dict[int, tuple] = {}

    def block(self, b: int, first: int, last: int) -> tuple:
        if b not in self._gso:
            self._gso[b] = ref_gso.gso(self.bases[b])
        return ref_gso.window(*self._gso[b], first, last)


def _pruning(config: dict, req: dict) -> np.ndarray:
    """The coefficients of the request's pruning set."""
    return np.asarray(config["pruning"]["sets"][int(req["prune"])]
                      ["coefficients"], dtype=np.float64)


def judge(pool: dict, config: dict, table: List[dict],
          answered: Sequence[Tuple[int, Optional[tuple]]],
          device="cpu") -> Dict[str, float]:
    """Judge window answers: `answered` holds (row of `table`, answer),
    an answer being (squared length, coordinates) or None."""
    beta = config["block_size"]
    bases = _Bases(pool["bases"])
    bad, dist_err, missed = 0, 0.0, 0.0
    for row, ans in answered:
        req = table[row]
        k, radius = int(req["kappa"]), float(req["radius"])
        prune = _pruning(config, req)
        mu, r = bases.block(int(req["basis"]), k, k + beta)
        bound = radius
        if ans is not None:
            dist, coords = ans
            x = np.rint(np.asarray(coords, dtype=np.float64))
            if len(x) != beta or \
                    np.abs(np.asarray(coords) - x).max() > 1e-6 or \
                    not x.any():
                bad += 1
                continue
            true = ref_gso.projected_norm(mu, r, x)
            dist_err = max(dist_err, abs(float(dist) - true) / true)
            bound = true
        short, _, _ = ref_enum.shortest(mu, r, prune, bound, device=device)
        if short is not None:
            missed = max(missed, (bound - short) / bound)
    return {"bad_answers": float(bad), "answer_err": max(dist_err, missed),
            "dist_err": dist_err, "missed_gap": missed}


def control(pool: dict, config: dict, table: List[dict],
            rows: Sequence[int], dtype, device="cpu"):
    """The control: the reference's own pruned search in place of the
    program, computed in `dtype`, on the rows the program answered:
    (row, answer) pairs for :func:`judge`."""
    beta = config["block_size"]
    bases = _Bases(pool["bases"])
    out = []
    for row in rows:
        req = table[row]
        k = int(req["kappa"])
        mu, r = bases.block(int(req["basis"]), k, k + beta)
        length, x, _ = ref_enum.shortest(mu, r, _pruning(config, req),
                                         float(req["radius"]),
                                         dtype=dtype, device=device)
        out.append((row, None if x is None else (length, x)))
    return out
