"""The one request generator: a traffic file's parameters and a seed give
an endless sequence of rows of a pool's request table.

Every seed runs the same set of requests, in another order. The table's
rows are the cross product of two fields: ``rounds_over`` (the strata)
and ``spread_over``. A cycle uses every row once, in rounds: one round
holds one row of each stratum, and the rows of one round take the values
of ``spread_over`` as evenly as the counts allow (stratum s of round t
takes value P[(t + shift_s) mod n], P a permutation and the shifts the
strata's places in an order, both drawn from the seed for each cycle).
Each round is shuffled. So any stretch of whole rounds holds every
stratum once per round and every value of the other field about
equally often, and a window that ends inside a cycle saw nearly the
same mix as a whole cycle.
"""

from __future__ import annotations

import random
from typing import Dict, Iterator, List

import numpy as np

__all__ = ["request_table", "requests"]


def request_table(pool: Dict[str, np.ndarray], traffic: dict) -> List[dict]:
    """The rows of the table the traffic names: for table ``t`` every pool
    array ``t_<field>`` is a column, one entry per row."""
    pre = traffic["table"] + "_"
    cols = {k[len(pre):]: v for k, v in pool.items() if k.startswith(pre)}
    if not cols:
        raise ValueError(f"pool has no table {traffic['table']!r}")
    n = {len(v) for v in cols.values()}
    if len(n) != 1:
        raise ValueError(f"table {traffic['table']!r}: columns of lengths "
                         f"{sorted(n)}")
    return [{k: v[i].item() for k, v in cols.items()}
            for i in range(n.pop())]


def requests(table: List[dict], traffic: dict, seed: int) -> Iterator[int]:
    """Endless row indices of `table` for one seed."""
    rng = random.Random(int(seed))
    sk, vk = traffic["rounds_over"], traffic["spread_over"]
    index = {(row[sk], row[vk]): i for i, row in enumerate(table)}
    strata = sorted({row[sk] for row in table})
    values = sorted({row[vk] for row in table})
    if len(index) != len(table) or \
            len(index) != len(strata) * len(values):
        raise ValueError(f"the table is not the cross product of {sk!r} "
                         f"and {vk!r}, each pair once")
    n = len(values)
    while True:
        perm = rng.sample(values, n)
        order = rng.sample(strata, len(strata))
        shift = {s: j % n for j, s in enumerate(order)}
        for t in range(n):
            rnd = [index[(s, perm[(t + shift[s]) % n])] for s in strata]
            rng.shuffle(rnd)
            yield from rnd
