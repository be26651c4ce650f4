"""`fplll` CLI — flag-compatible with the reference binary.

Mirrors fplll/main.{cpp,h}: actions lll/hkz/bkz/svp/
cvp/sdb/sld/hlll/pru (main.h:36-45), the option set (main.cpp:477-775),
and the output formats -of b/u/v/t with 'k' (sage/comma) variants
(main.cpp:49-92).

The port's copy of the JAX package's cli/main.py. Like the reference
binary it has no device flag: the actions that may reach the device (bkz,
sdb, sld, hkz, svp, cvp, and pru's analytic gradient) run on cuda unless
FPLLL_TORCH_DEVICE=cpu asks for the CPU (torchsetup.resolve_device).

    python -m fplll_tpu_torch.cli.main -a svp < basis.txt
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field

from ..defs import (BKZ_AUTO_ABORT, BKZ_BOUNDED_LLL, BKZ_DUMP_GSO, BKZ_GH_BND,
                    BKZ_MAX_LOOPS, BKZ_MAX_TIME, BKZ_NO_LLL, BKZ_SD_VARIANT,
                    BKZ_SLD_RED, BKZ_VERBOSE, CVPM_PROVED, FT_DEFAULT,
                    FloatType, HLLL_DEF_C, HLLL_DEF_THETA, LLL_DEF_DELTA,
                    LLL_DEF_ETA, LLL_EARLY_RED, LLL_SIEGEL, LLL_VERBOSE,
                    LLLMethod, LM_FAST, LM_HEURISTIC, LM_PROVED, LM_WRAPPER,
                    RED_SUCCESS, SVPM_PROVED, get_red_status_str)
from ..nr.fctx import _NAME2FT
from ..ops.intmat import (IntMat, format_matrix, format_vector, parse_matrix,
                          parse_vector)

ACTIONS = ("lll", "hkz", "bkz", "svp", "cvp", "sdb", "sld", "hlll", "pru")

HELP = """Usage: fplll [options] [file]
Actions (-a): lll (default) | hkz | bkz | svp | cvp | sdb | sld | hlll | pru
Options:
 -a <action>            lll|hkz|bkz|svp|cvp|sdb|sld|hlll|pru
 -m <method>            wrapper|proved|heuristic|fast (LLL)
 -z <int type>          mpz|long|double
 -f <float type>        double|long double|dpe|dd|qd|mpfr
 -p <precision>         precision (mpfr)
 -d/-delta <delta>      LLL delta (default 0.99)
 -e/-eta <eta>          LLL eta (default 0.51)
 -t/-theta <theta>      HLLL theta
 -c <c>                 HLLL c
 -l <lovasz|siegel>     0 = Lovasz (default), 1 = Siegel
 -y                     early reduction
 -b <block size>        BKZ block size
 -s <file>              BKZ strategies json
 -bkzmaxloops <n>       BKZ loop limit
 -bkzmaxtime <s>        BKZ time limit
 -bkzautoabort          BKZ auto abort
 -bkzghbound <f>        BKZ Gaussian-heuristic radius factor
 -bkzboundedlll         bounded LLL in BKZ preprocessing
 -bkzdumpgso <file>     dump GSO norms each loop
 -nolll                 skip initial LLL (bkz/svp/cvp/hlll verify)
 -of <format>           output: b u v t and bk/uk/vk (sage), c s (svp/cvp)
 -prustart/-pruend/-pruprenodes/-pruminprob   pruner options
 -v                     verbose"""


@dataclass
class Options:
    action: str = "lll"
    method: LLLMethod = LM_WRAPPER
    float_type: FloatType = FT_DEFAULT
    delta: float = LLL_DEF_DELTA
    eta: float = LLL_DEF_ETA
    theta: float = HLLL_DEF_THETA
    c: float = HLLL_DEF_C
    precision: int = 0
    early_red: bool = False
    siegel: bool = False
    no_lll: bool = False
    block_size: int = 0
    bkz_flags: int = 0
    bkz_max_loops: int = 0
    bkz_max_time: float = 0
    bkz_dump_gso_filename: str = ""
    bkz_gh_factor: float = 1.1
    bkz_strategy_file: str = ""
    prune_start: int = 0
    prune_end: int = -1
    prune_pre_nodes: float = 1e6
    prune_min_prob: float = -1
    verbose: bool = False
    input_file: str | None = None
    output_format: str | None = None


_METHODS = {"wrapper": LM_WRAPPER, "proved": LM_PROVED,
            "heuristic": LM_HEURISTIC, "fast": LM_FAST}


def _print_comma(m: IntMat) -> None:
    """Sage-style output (matrix.h print_comma)."""
    rows = [", ".join(str(int(x)) for x in row) for row in m.a]
    print("[[" + "],\n[".join(rows) + "]]")


def _emit_matrix(fmt_char_next: str, m: IntMat) -> bool:
    if fmt_char_next == "k":
        _print_comma(m)
        return True
    print(format_matrix(m))
    return False


def _emit(format_str: str, b, u, u_inv, status) -> None:
    i = 0
    while i < len(format_str):
        ch = format_str[i]
        nxt = format_str[i + 1] if i + 1 < len(format_str) else ""
        if ch == "b":
            if _emit_matrix(nxt, b):
                i += 1
        elif ch == "u" and u is not None:
            if _emit_matrix(nxt, u):
                i += 1
        elif ch == "v" and u_inv is not None:
            if _emit_matrix(nxt, u_inv):
                i += 1
        elif ch == "t":
            print(int(status))
        elif ch == " ":
            print()
        i += 1


def do_lll(o: Options, b: IntMat) -> int:
    from ..algs.wrapper import lll_reduction
    fmt = o.output_format or "b"
    flags = (LLL_VERBOSE if o.verbose else 0) | \
        (LLL_EARLY_RED if o.early_red else 0) | \
        (LLL_SIEGEL if o.siegel else 0)
    u = IntMat.identity(b.nrows) if ("u" in fmt or "v" in fmt) else None
    u_inv = IntMat.identity(b.nrows) if "v" in fmt else None
    status = lll_reduction(b, u, u_inv, o.delta, o.eta, o.method,
                           o.float_type, o.precision, flags)
    _emit(fmt, b, u, u_inv, status)
    if status != RED_SUCCESS:
        print(f"Failure: {get_red_status_str(status)}", file=sys.stderr)
    return status


def do_hlll(o: Options, b: IntMat) -> int:
    from ..algs.wrapper import hlll_reduction
    fmt = o.output_format or "b"
    flags = LLL_VERBOSE if o.verbose else 0
    u = IntMat.identity(b.nrows) if ("u" in fmt or "v" in fmt) else None
    status = hlll_reduction(b, u, None, o.delta, o.eta, o.theta, o.c,
                            o.method, o.float_type, o.precision, flags,
                            nolll=o.no_lll)
    _emit(fmt, b, u, None, status)
    if status != RED_SUCCESS:
        print(f"Failure: {get_red_status_str(status)}", file=sys.stderr)
    return status


def do_bkz(o: Options, b: IntMat, variant_flags: int = 0) -> int:
    from ..algs.bkz import bkz_reduction
    from ..algs.bkz_param import BKZParam, load_strategies_json
    if o.block_size <= 0:
        print("fplll: option -b is missing", file=sys.stderr)
        return 1
    fmt = o.output_format or "b"
    flags = o.bkz_flags | variant_flags
    if o.verbose:
        flags |= BKZ_VERBOSE
    if o.no_lll:
        flags |= BKZ_NO_LLL
    strategies = None
    if o.bkz_strategy_file:
        strategies = load_strategies_json(o.bkz_strategy_file)
        flags |= BKZ_GH_BND
    param = BKZParam(o.block_size, strategies, o.delta, flags,
                     o.bkz_max_loops, o.bkz_max_time,
                     gh_factor=o.bkz_gh_factor)
    if o.bkz_dump_gso_filename:
        param.dump_gso_filename = o.bkz_dump_gso_filename
    u = IntMat.identity(b.nrows) if "u" in fmt else None
    status = bkz_reduction(b, param, u, o.float_type, o.precision)
    _emit(fmt, b, u, None, status)
    if status != RED_SUCCESS:
        print(f"Failure: {get_red_status_str(status)}", file=sys.stderr)
    return status


def do_hkz(o: Options, b: IntMat) -> int:
    from ..algs.bkz import hkz_reduction
    fmt = o.output_format or "b"
    status = hkz_reduction(b, 1 if o.verbose else 0, o.float_type,
                           o.precision)
    _emit(fmt, b, None, None, status)
    return status


def do_svpcvp(o: Options, b: IntMat, target) -> int:
    from ..algs.svpcvp import closest_vector, shortest_vector
    from ..algs.wrapper import lll_reduction
    fmt = o.output_format or "s"
    with_coord = "c" in fmt
    u = IntMat.identity(b.nrows) if with_coord else None
    if not o.no_lll:
        status = lll_reduction(b, u)
        if status != RED_SUCCESS:
            print(f"LLL reduction failed: {get_red_status_str(status)}",
                  file=sys.stderr)
            return status
    if target is None:
        status, sol_coord = shortest_vector(b, SVPM_PROVED,
                                            1 if o.verbose else 0)
    else:
        status, sol_coord = closest_vector(b, target, CVPM_PROVED,
                                           1 if o.verbose else 0)
    if status != RED_SUCCESS:
        print(f"Failure: {get_red_status_str(status)}", file=sys.stderr)
        return status
    solution = [sum(c * int(b.a[i, j]) for i, c in enumerate(sol_coord))
                for j in range(b.ncols)]
    for i, ch in enumerate(fmt):
        if ch == "c":
            if o.no_lll or u is None:
                coords2 = sol_coord
            else:
                coords2 = [sum(c * int(u.a[i2, j]) for i2, c in
                               enumerate(sol_coord)) for j in range(u.ncols)]
            print(format_vector(coords2))
        elif ch == "s":
            print(format_vector(solution))
        elif ch == "t":
            print(int(status))
        elif ch == " ":
            print()
    return status


def do_pru(o: Options, b: IntMat) -> int:
    from ..pruner.pruner import run_pruner
    res = run_pruner(b, o.float_type, o.precision, o.prune_start,
                     o.prune_end, o.prune_pre_nodes, o.prune_min_prob,
                     o.bkz_gh_factor)
    print("# pruning coefficients:")
    print("[" + " ".join(f"{c:.6g}" for c in res.coefficients) + "]")
    print(f"# expectation: {res.expectation}")
    return 0


def parse_args(argv) -> Options | int:
    o = Options()
    i = 0
    a = list(argv)

    def need(n=1):
        nonlocal i
        if i + n >= len(a):
            print(f"fplll: option '{a[i]}' requires an argument",
                  file=sys.stderr)
            raise SystemExit(1)
        i += 1
        return a[i]

    while i < len(a):
        arg = a[i]
        if arg == "-a":
            o.action = need()
            if o.action not in ACTIONS:
                print(f"fplll: invalid action '{o.action}'", file=sys.stderr)
                return 1
        elif arg == "-b":
            o.block_size = int(need())
        elif arg == "-prustart":
            o.prune_start = int(need())
        elif arg == "-pruend":
            o.prune_end = int(need())
        elif arg == "-pruprenodes":
            o.prune_pre_nodes = float(need())
        elif arg == "-pruminprob":
            o.prune_min_prob = float(need())
        elif arg == "-bkzboundedlll":
            o.bkz_flags |= BKZ_BOUNDED_LLL
        elif arg == "-bkzmaxloops":
            o.bkz_max_loops = int(need())
            o.bkz_flags |= BKZ_MAX_LOOPS
        elif arg == "-bkzmaxtime":
            o.bkz_max_time = float(need())
            o.bkz_flags |= BKZ_MAX_TIME
        elif arg == "-bkzautoabort":
            o.bkz_flags |= BKZ_AUTO_ABORT
        elif arg == "-bkzdumpgso":
            o.bkz_dump_gso_filename = need()
            o.bkz_flags |= BKZ_DUMP_GSO
        elif arg in ("-c", "-r"):
            o.c = float(need())
        elif arg == "-bkzghbound":
            o.bkz_gh_factor = float(need())
            o.bkz_flags |= BKZ_GH_BND
        elif arg in ("-d", "-delta"):
            o.delta = float(need())
        elif arg in ("-e", "-eta"):
            o.eta = float(need())
        elif arg in ("-t", "-theta"):
            o.theta = float(need())
        elif arg == "-f":
            name = need()
            if name not in _NAME2FT:
                print(f"fplll: invalid float type '{name}'", file=sys.stderr)
                return 1
            o.float_type = _NAME2FT[name]
        elif arg == "-s":
            o.bkz_strategy_file = need()
        elif arg == "-l":
            o.siegel = bool(int(need()))
        elif arg == "-m":
            name = need()
            if name not in _METHODS:
                print(f"fplll: invalid method '{name}'", file=sys.stderr)
                return 1
            o.method = _METHODS[name]
        elif arg == "-nolll":
            o.no_lll = True
        elif arg == "-of":
            o.output_format = need()
        elif arg == "-p":
            o.precision = int(need())
        elif arg == "-v":
            o.verbose = True
        elif arg == "-y":
            o.early_red = True
        elif arg == "-z":
            need()  # int type: all integers are exact here; accepted for parity
        elif arg in ("-h", "--help"):
            print(HELP)
            return 0
        elif arg == "--version":
            print("fplll (fplll_tpu_torch) 1.0.0")
            return 0
        elif arg.startswith("-"):
            print(f"fplll: invalid option '{arg}'", file=sys.stderr)
            return 1
        else:
            o.input_file = arg
        i += 1
    return o


def main(argv=None) -> int:
    o = parse_args(sys.argv[1:] if argv is None else argv)
    if isinstance(o, int):
        return o
    text = open(o.input_file).read() if o.input_file else sys.stdin.read()
    b = parse_matrix(text)
    target = None
    if o.action == "cvp":
        # the target vector follows the matrix in the input
        close = text.rindex("]")
        # matrix consumed [[..]..]; the target is the last bracketed vector
        depth = 0
        pos = len(text)
        for idx in range(len(text) - 1, -1, -1):
            if text[idx] == "]":
                depth += 1
                if depth == 1:
                    pos = idx
            elif text[idx] == "[":
                depth -= 1
                if depth == 0:
                    target = parse_vector(text[idx:pos + 1])
                    break
    if o.action == "lll":
        return do_lll(o, b)
    if o.action == "hlll":
        return do_hlll(o, b)
    if o.action == "bkz":
        return do_bkz(o, b)
    if o.action == "sdb":
        return do_bkz(o, b, BKZ_SD_VARIANT)
    if o.action == "sld":
        return do_bkz(o, b, BKZ_SLD_RED)
    if o.action == "hkz":
        return do_hkz(o, b)
    if o.action == "svp":
        return do_svpcvp(o, b, None)
    if o.action == "cvp":
        return do_svpcvp(o, b, target)
    if o.action == "pru":
        return do_pru(o, b)
    return 1


if __name__ == "__main__":
    sys.exit(main())
