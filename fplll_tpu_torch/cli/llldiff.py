"""`llldiff` CLI — compare two reduced bases up to per-row sign.

Mirrors fplll/llldiff.cpp (used by make-check pipelines,
README.md:299-303): reads two matrices, reports whether they agree row
by row allowing a global sign flip per row. The port's copy of the JAX
package's cli/llldiff.py; host code only:

    python -m fplll_tpu_torch.cli.llldiff A.txt B.txt
"""

from __future__ import annotations

import sys

from ..ops.intmat import parse_matrix


def matrices_equal_up_to_sign(a, b) -> bool:
    if a.nrows != b.nrows or a.ncols != b.ncols:
        return False
    for i in range(a.nrows):
        ra = [int(x) for x in a.a[i]]
        rb = [int(x) for x in b.a[i]]
        if ra != rb and [-x for x in ra] != rb:
            return False
    return True


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if len(args) != 2:
        print("Usage: llldiff <file1> <file2>", file=sys.stderr)
        return 2
    try:
        a = parse_matrix(open(args[0]).read())
        b = parse_matrix(open(args[1]).read())
    except (IOError, ValueError) as e:
        print(f"llldiff: {e}", file=sys.stderr)
        return 2
    if matrices_equal_up_to_sign(a, b):
        print("Matrices are equal")
        return 0
    print("Matrices differ")
    return 1


if __name__ == "__main__":
    sys.exit(main())
