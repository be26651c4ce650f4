"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout that holds BENCHMARK.json, portbench/ and
the port (fplll_tpu_torch/). It needs as many CUDA cards as the cell
asks for: without them it prints why on standard error, prints no
result and exits 2; it never falls back to the CPU. With --trace 0 the
result line holds the cell's end-to-end metrics, with --trace 1 its
per-layer metrics, read under the profiler and the benchmark's spans.
Every build and kernel cache stays inside the checkout (build/).
The last line of standard output is the result's JSON object; the last
lines of standard error give each number compared beside its limit.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _environment() -> None:
    """Caches inside the checkout at fixed paths; the port on the card;
    no library loading JAX by itself; one thread for the host's numeric
    libraries (the one caller's path is single-threaded, and idle pool
    threads only contend with it)."""
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    build = os.path.join(ROOT, "build")
    os.environ["FPLLL_TORCH_NATIVE_CACHE"] = os.path.join(build, "native")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["FPLLL_TORCH_DEVICE"] = "cuda"
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one run of one cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    work = [w for w in bench["workloads"] if w["name"] == args.workload]
    if not work:
        print(f"portbench: no workload {args.workload!r}", file=sys.stderr)
        return 2
    import torch
    marks = [("torch", time.perf_counter())]
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(work[0]["chips"]):
        print(f"portbench: {args.workload} needs {work[0]['chips']} CUDA "
              f"card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              "; no result", file=sys.stderr)
        return 2
    marks.append(("card check", time.perf_counter()))
    sys.path.insert(0, ROOT)
    from portbench.harness.runner import run_cell
    out = run_cell(bench, args.workload, args.seed, args.seconds,
                   bool(args.trace), "cuda", T_START, marks=marks)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
