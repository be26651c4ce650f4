"""The measured window: a closed loop with one caller, the only load
the harness offers. Each request is sent when the one before it has
ended, as BKZ and a script calling SVP wait for each answer; a mix that
needs several callers or an open loop needs code of its own here.

The window opens before the first request and closes when the first
request that ends after `seconds` ends, so the rate counts all solves
over all the time they took, with no solve cut off and no idle tail.
"""

from __future__ import annotations

import sys
import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator, List

__all__ = ["Solve", "Window", "measure"]


@dataclass
class Solve:
    row: int                # the request's row of the pool's table
    start: float            # seconds since the window opened
    end: float
    ok: bool                # False: it raised, or its answer is malformed
    answer: Any = None

    @property
    def latency(self) -> float:
        return self.end - self.start


@dataclass
class Window:
    solves: List[Solve] = field(default_factory=list)
    elapsed: float = 0.0    # open to close, seconds


def measure(solve: Callable[[int], Any], rows: Iterator[int],
            seconds: float, clock: Callable[[], float] = time.perf_counter
            ) -> Window:
    """Run `solve` on `rows` one after another until one ends `seconds`
    after the window opened. A solve that raises counts as not ok, with
    its traceback on standard error, and the loop goes on."""
    win = Window()
    t0 = clock()
    while True:
        row = next(rows)
        s = clock() - t0
        try:
            ans, ok = solve(row), True
        except Exception:  # noqa: BLE001 - counted in `failed`, printed
            traceback.print_exc(file=sys.stderr)
            ans, ok = None, False
        e = clock() - t0
        win.solves.append(Solve(row, s, e, ok, ans))
        if e >= seconds:
            win.elapsed = e
            return win
