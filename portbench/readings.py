"""The readings a cell's limits are set from: the program's numbers over
many seeds, and the control's, in one process on the card.

    python3 portbench/readings.py --workload <cell> --seeds <n ...> \\
        --seconds <s> [--control-seeds <n ...>]

For each program seed: a window of `--seconds` at the cell's own load,
the run's sample of answers (as ``run.py`` draws it) and the cell's
judge. For each control seed: the same window's sampled requests
answered by the reference's own search in the control's dtype (the
cell file's ``control``), judged alike. It prints one JSON line per
reading and the largest program reading and smallest control reading of
each number. Not part of a benchmark run.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    os.environ["FPLLL_TORCH_DEVICE"] = args.device
    sys.path.insert(0, ROOT)
    import torch

    from portbench.harness.registry import entry, load_cell
    from portbench.harness.runner import _sample, _sync
    from portbench.harness.traffic import requests
    from portbench.harness.window import measure
    from portbench.reference import judge

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = load_cell(bench, args.workload)
    ent = entry(cell.spec["entry"])(cell.config, cell.pool, cell.table)
    for row in cell.traffic["warmup"]:
        ent.solve(row)
    _sync(args.device)
    cell_judge = judge.load(cell.spec["judge"])
    k = int(cell.spec["sample"])
    prog, ctrl, rows_of = [], [], {}
    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        win = measure(ent.solve, requests(cell.table, cell.traffic, seed),
                      args.seconds)
        picked = _sample(win, seed, k)
        answered = [(win.solves[i].row, win.solves[i].answer)
                    for i in picked]
        rows_of[seed] = [r for r, _ in answered]
        if seed in args.seeds:
            nums = cell_judge.judge(cell.pool, cell.config, cell.table,
                                    answered, device=args.device)
            nums["failed"] = float(sum(not s.ok for s in win.solves))
            prog.append(nums)
            print(json.dumps({"side": "program", "seed": seed,
                              "solves": len(win.solves), **nums}),
                  flush=True)
    dtype = judge.DTYPES[cell.spec["control"]["dtype"]]
    for seed in args.control_seeds:
        t0 = time.perf_counter()
        answered = cell_judge.control(cell.pool, cell.config, cell.table,
                                      rows_of[seed], dtype,
                                      device=args.device)
        nums = cell_judge.judge(cell.pool, cell.config, cell.table, answered,
                                device=args.device)
        ctrl.append(nums)
        print(json.dumps({"side": "control", "seed": seed,
                          "dtype": cell.spec["control"]["dtype"],
                          "seconds": time.perf_counter() - t0, **nums}),
              flush=True)
    summary = {"program_max": {n: max(p[n] for p in prog) for n in prog[0]}
               if prog else {},
               "control_min": {n: min(c[n] for c in ctrl) for n in ctrl[0]}
               if ctrl else {},
               "device": torch.cuda.get_device_name(0)
               if args.device == "cuda" else args.device}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
