"""The measured window: the rate counts every solve over all the window's
time, the tail every solve's latency, and both move under a stall."""

import portbench_support  # noqa: F401
from portbench.harness.runner import RunView
from portbench.harness.window import measure
from portbench.metrics import solve_p95_ms, solves_per_s


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def run(durations, seconds, fail=()):
    clock = FakeClock()
    it = iter(range(10 ** 6))

    def solve(row):
        clock.t += durations[row % len(durations)]
        if row in fail:
            raise RuntimeError("planted failure")
        return row

    win = measure(solve, it, seconds, clock=clock)
    view = RunView(0.0, win.elapsed, [s.latency for s in win.solves],
                   [s.ok for s in win.solves])
    return win, view


def test_window_closes_on_the_first_solve_that_ends_after_its_length():
    win, view = run([0.3], 1.0)
    assert [round(s.end, 9) for s in win.solves] == [0.3, 0.6, 0.9, 1.2]
    assert abs(win.elapsed - 1.2) < 1e-9
    assert abs(solves_per_s.read(view) - 4 / 1.2) < 1e-12


def test_rate_and_tail_move_with_a_stall():
    _, steady = run([0.1], 10.0)
    # one solve in ten stalls for a second
    _, stalled = run([0.1] * 9 + [1.0], 10.0)
    assert abs(solves_per_s.read(steady) - 10.0) < 1e-6
    assert abs(solve_p95_ms.read(steady) - 100.0) < 1e-6
    assert solves_per_s.read(stalled) < 0.6 * solves_per_s.read(steady)
    assert abs(solve_p95_ms.read(stalled) - 1000.0) < 1e-6


def test_failed_solves_count_in_the_tail_not_in_the_rate():
    win, view = run([0.125], 1.0, fail={3})
    assert [s.ok for s in win.solves].count(False) == 1
    assert win.elapsed == 1.0
    assert solves_per_s.read(view) == 7.0
    assert len(view.latencies) == 8
