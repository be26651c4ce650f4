"""`latticegen` CLI — generates lattice instances to stdout.

Flag-compatible with the reference binary
(fplll/latticegen.cpp:56-240):

    latticegen [-randseed <int>|time] <method> <args...>
      r <d> <b>        gen_intrel
      s <d> <b> <b2>   gen_simdioph
      u <d> <b>        gen_uniform
      n <d> <b> <c>    gen_ntrulike  (c = 'b' bits or 'q' explicit modulus)
      N <d> <b> <c>    gen_ntrulike2
      q <d> <k> <b> <c> gen_qary
      t <d> <f>        gen_trg
      T <d>            gen_trg2 (diagonal read from stdin)

The port's copy of the JAX package's cli/latticegen.py; host code only:

    python -m fplll_tpu_torch.cli.latticegen -randseed 7 r 25 120
"""

from __future__ import annotations

import sys

from ..nr.rng import RandGen
from ..ops import gen
from ..ops.intmat import format_matrix

HELP = """Usage: latticegen [-randseed [<int>|time]] <method> <args...>
 r <d> <b> : gen_intrel
 s <d> <b> <b2> : gen_simdioph
 u <d> <b> : gen_uniform
 n <d> <b> <c> : gen_ntrulike
 N <d> <b> <c> : gen_ntrulike2
 q <d> <k> <b> <c>: gen_qary
 t <d> <f> : gen_trg
 T <d> : gen_trg2"""


def fatal(msg: str) -> "int":
    print(f"latticegen: {msg}\nTry 'latticegen --help' for more information",
          file=sys.stderr)
    return 1


def main(argv: list | None = None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    if not args or args[0] == "--help":
        print(HELP)
        return 0
    if args[0] == "--version":
        print("latticegen (fplll_tpu_torch) 1.0.0")
        return 0
    if args[0] == "-randseed":
        if len(args) < 2:
            return fatal("option '-randseed' requires an argument")
        if args[1] == "time":
            RandGen.init_with_time()
        else:
            RandGen.init_with_seed(int(args[1]))
        args = args[2:]
    if len(args) < 2:
        return fatal("you must specify a method and a dimension")

    method = args[0][0]
    d = int(args[1])
    rest = args[2:]

    try:
        if method == "r":
            m = gen.gen_intrel(d, int(rest[0]))
        elif method == "s":
            m = gen.gen_simdioph(d + 1, int(rest[0]), int(rest[1]))
        elif method == "u":
            m = gen.gen_uniform(d, int(rest[0]))
        elif method in ("n", "N"):
            kind = rest[1][0]
            f = gen.gen_ntrulike if method == "n" else gen.gen_ntrulike2
            fb = gen.gen_ntrulike_bits if method == "n" else gen.gen_ntrulike2_bits
            if kind == "b":
                m = fb(d, int(rest[0]))
            elif kind == "q":
                m = f(d, int(rest[0]))
            else:
                return fatal("parameter c must be 'b' or 'q'")
        elif method == "q":
            k, b, kind = int(rest[0]), rest[1], rest[2][0]
            if kind == "b":
                m = gen.gen_qary_bits(d, k, int(b))
            elif kind == "p":
                m = gen.gen_qary_prime(d, k, int(b))
            elif kind == "q":
                m = gen.gen_qary(d, k, int(b))
            else:
                return fatal("parameter c must be 'b', 'p' or 'q'")
        elif method == "t":
            m = gen.gen_trg(d, float(rest[0]))
        elif method == "T":
            w = [float(x) for x in sys.stdin.read().split()][:d]
            m = gen.gen_trg2(w)
        else:
            return fatal(f"invalid method '{method}'")
    except IndexError:
        return fatal(f"method '{method}' is missing arguments")

    print(format_matrix(m))
    return 0


if __name__ == "__main__":
    sys.exit(main())
