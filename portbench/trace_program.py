"""One traced run of one cell, as ``run.py --trace 1`` makes it, with the
port's own recorder (``fplll_tpu_torch.trace``) on over the window.

    python3 portbench/trace_program.py --workload <cell> --seed <n> \\
        --seconds <s>

The result line is ``run.py``'s, its per-layer metrics joined by those
that read the recorder (``harness/program.py``'s ``METRICS``); standard
error gains, per span name, its count and its host milliseconds per
solve and per launch. ``run.py`` itself does not turn the recorder on.
"""

import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def span_table(snap) -> list:
    """(name, count, ms per solve, ms per launch, self ms per launch,
    median self ms) of every span name, solves being
    ``facade.enumerate`` spans and launches ``kernels.run`` spans; self
    time is the span less its children."""
    solves = max(len(snap.named("facade.enumerate")), 1)
    launches = max(len(snap.named("kernels.run")), 1)
    child_ns: dict = {}
    for s in snap.spans:
        if s.parent is not None:
            child_ns[s.parent] = child_ns.get(s.parent, 0) + \
                s.end_ns - s.start_ns
    rows = []
    for name in sorted({s.name for s in snap.spans}):
        spans = snap.named(name)
        own = [(s.end_ns - s.start_ns - child_ns.get(s.id, 0)) * 1e-6
                for s in spans]
        ms = snap.seconds(name) * 1e3
        rows.append((name, len(spans), ms / solves, ms / launches,
                     sum(own) / launches, statistics.median(own)))
    return rows


def main(argv=None) -> int:
    sys.path.insert(0, ROOT)
    from portbench import run
    run._environment()
    from portbench.harness import program, runner

    cell = runner.run_cell

    def run_cell(*a, **k):
        with program.recorded() as views:
            out = cell(*a, **k)
        view = views[-1]
        out["metrics"].update(program.read_all(view))
        snap = view.program
        for name, n, per_solve, per_launch, own, med in span_table(snap):
            print(f"portbench: span {name} n {n} ms/solve {per_solve!r} "
                  f"ms/launch {per_launch!r} self ms/launch {own!r} "
                  f"self ms median {med!r}", file=sys.stderr)
        print(f"portbench: counts {snap.counts}", file=sys.stderr)
        if snap.launches:
            ms = [ln["kernel_ms"] for ln in snap.launches]
            print(f"portbench: launch records {len(ms)}, kernel ms median "
                  f"{statistics.median(ms)!r}", file=sys.stderr)
        return out

    runner.run_cell = run_cell
    args = list(sys.argv[1:] if argv is None else argv)
    return run.main(args + ["--trace", "1"])


if __name__ == "__main__":
    sys.exit(main())
