"""Exact integer matrices and vectors.

TPU-native re-think of the reference's ``ZZ_mat<ZT>`` / ``NumVect``
containers (fplll/nr/matrix.h:31-361, numvect.h:129).
The basis lives host-side as a numpy object array of Python ints
(arbitrary precision, the ZT_MPZ role); callers that stay below 2^53 can
export to int64/float64 device arrays for the jitted compute path.

Row operations are vectorized over columns via numpy object arithmetic;
the semantics (addmul_si_2exp, rotate, swap) mirror matrix.h:196-210 and
numvect.h so the GSO engine can maintain exact Gram data incrementally.
"""

from __future__ import annotations

import re
from typing import Iterable, List, Sequence

import numpy as np

__all__ = ["IntMat", "read_matrix", "parse_matrix", "format_matrix", "parse_vector",
           "format_vector"]


def _obj_array(rows: Sequence[Sequence[int]]) -> np.ndarray:
    r = len(rows)
    c = len(rows[0]) if r else 0
    a = np.empty((r, c), dtype=object)
    for i, row in enumerate(rows):
        if len(row) != c:
            raise ValueError("ragged matrix")
        for j, v in enumerate(row):
            a[i, j] = int(v)
    return a


class IntMat:
    """Row-major exact integer matrix (the ZZ_mat equivalent)."""

    def __init__(self, rows: int = 0, cols: int = 0, data: np.ndarray | None = None):
        # monotone mutation stamp: every in-place row operation bumps it,
        # so callers can memoize "prefix [0, e) is already reduced"
        self.version = 0
        if data is not None:
            assert data.dtype == object
            self.a = data
        else:
            self.a = np.full((rows, cols), 0, dtype=object)
            self.a[...] = [[0] * cols for _ in range(rows)] if rows else []
            if rows:
                for i in range(rows):
                    for j in range(cols):
                        self.a[i, j] = 0

    # -- construction ------------------------------------------------------
    @classmethod
    def from_rows(cls, rows: Sequence[Sequence[int]]) -> "IntMat":
        return cls(data=_obj_array(rows))

    @classmethod
    def zeros(cls, r: int, c: int) -> "IntMat":
        return cls.from_rows([[0] * c for _ in range(r)]) if r else cls(data=np.empty((0, c), dtype=object))

    @classmethod
    def identity(cls, n: int) -> "IntMat":
        m = cls.zeros(n, n)
        for i in range(n):
            m.a[i, i] = 1
        return m

    def copy(self) -> "IntMat":
        return type(self)(data=self.a.copy())   # preserves subclasses
        # (e.g. the fpylll-veneer IntegerMatrix)

    # -- shape -------------------------------------------------------------
    @property
    def nrows(self) -> int:
        return self.a.shape[0]

    @property
    def ncols(self) -> int:
        return self.a.shape[1]

    def get_rows(self) -> int:
        return self.nrows

    def get_cols(self) -> int:
        return self.ncols

    def resize(self, r: int, c: int) -> None:
        self.version += 1
        new = np.empty((r, c), dtype=object)
        for i in range(r):
            for j in range(c):
                new[i, j] = 0
        rr, cc = min(r, self.nrows), min(c, self.ncols)
        new[:rr, :cc] = self.a[:rr, :cc]
        self.a = new

    # -- element access ----------------------------------------------------
    def __getitem__(self, ij):
        return self.a[ij]

    def __setitem__(self, ij, v) -> None:
        self.version += 1
        if isinstance(v, (list, tuple, np.ndarray)):
            self.a[ij] = np.array([int(x) for x in v], dtype=object)
        else:
            self.a[ij] = int(v)

    def row(self, i: int) -> np.ndarray:
        return self.a[i]

    def to_pylist(self) -> List[List[int]]:
        return [[int(x) for x in row] for row in self.a]

    # -- row operations (reference: numvect.h / matrix.h) ------------------
    def row_add(self, i: int, j: int) -> None:
        self.version += 1
        self.a[i] = self.a[i] + self.a[j]

    def row_sub(self, i: int, j: int) -> None:
        self.version += 1
        self.a[i] = self.a[i] - self.a[j]

    def row_addmul(self, i: int, j: int, x: int) -> None:
        """b[i] += x * b[j] with exact integer x."""
        self.version += 1
        if x == 1:
            self.row_add(i, j)
        elif x == -1:
            self.row_sub(i, j)
        elif x != 0:
            self.a[i] = self.a[i] + self.a[j] * int(x)

    def row_addmul_2exp(self, i: int, j: int, x: int, expo: int) -> None:
        """b[i] += (x * 2^expo) * b[j] (reference: numvect.h addmul_2exp)."""
        self.row_addmul(i, j, int(x) << expo if expo >= 0 else int(x))

    def row_swap(self, i: int, j: int) -> None:
        self.version += 1
        self.a[[i, j]] = self.a[[j, i]]

    def rotate_right(self, first: int, last: int) -> None:
        """Row last -> first, rows [first,last) shift down (matrix.h:176)."""
        self.version += 1
        if first == last:
            return
        tmp = self.a[last].copy()
        self.a[first + 1 : last + 1] = self.a[first:last]
        self.a[first] = tmp

    def rotate_left(self, first: int, last: int) -> None:
        """Row first -> last, rows (first,last] shift up."""
        self.version += 1
        if first == last:
            return
        tmp = self.a[first].copy()
        self.a[first:last] = self.a[first + 1 : last + 1]
        self.a[last] = tmp

    def row_negate(self, i: int) -> None:
        self.version += 1
        self.a[i] = -self.a[i]

    # -- reductions --------------------------------------------------------
    def dot_rows(self, i: int, j: int, n: int | None = None) -> int:
        """Exact dot product of rows i and j over the first n columns."""
        ri = self.a[i] if n is None else self.a[i][:n]
        rj = self.a[j] if n is None else self.a[j][:n]
        return int(np.dot(ri, rj))

    def row_norm_sq(self, i: int) -> int:
        return self.dot_rows(i, i)

    def row_is_zero(self, i: int, n: int | None = None) -> bool:
        row = self.a[i] if n is None else self.a[i][:n]
        return all(x == 0 for x in row)

    def row_size_nz(self, i: int) -> int:
        """Index after the last nonzero entry of row i (numvect.h size_nz)."""
        row = self.a[i]
        for j in range(len(row) - 1, -1, -1):
            if row[j] != 0:
                return j + 1
        return 0

    def get_max_exp(self) -> int:
        """max bit-length over entries (matrix.h:203 get_max_exp)."""
        if self.nrows == 0 or self.ncols == 0:
            return 0
        # |.|max via numpy's C-level object dispatch, one bit_length call
        mx = int(np.abs(self.a).max())
        return mx.bit_length()

    def max_abs(self) -> int:
        mx = 0
        for row in self.a:
            for x in row:
                ax = -x if x < 0 else x
                if ax > mx:
                    mx = ax
        return mx

    # -- device export (the TPU path) --------------------------------------
    def to_f64_with_expo(self):
        """Per-row block-floating-point export: (f64 matrix, row exponents).

        Row i is scaled by 2^-row_expo[i] so that the largest magnitude
        entry has exponent 0; this is the GSO_ROW_EXPO representation
        (reference: gso.cpp:24-48 update_bf) and the natural TPU layout.
        """
        import math

        r, c = self.a.shape
        out = np.zeros((r, c), dtype=np.float64)
        row_expo = np.zeros(r, dtype=np.int64)
        for i in range(r):
            max_e = 0
            exps = []
            for j in range(c):
                x = int(self.a[i, j])
                if x == 0:
                    exps.append((0.0, 0))
                    continue
                m, e = math.frexp(x) if abs(x) < 2**1000 else (None, None)
                if m is None:
                    bl = x.bit_length()
                    sh = bl - 53
                    m = float(x >> sh) if x > 0 else -float((-x) >> sh)
                    m, e2 = math.frexp(m)
                    e = e2 + sh
                exps.append((m, e))
                max_e = max(max_e, e)
            row_expo[i] = max_e
            for j, (m, e) in enumerate(exps):
                out[i, j] = math.ldexp(m, e - max_e) if m != 0.0 else 0.0
        return out, row_expo

    def to_f64(self) -> np.ndarray:
        r, c = self.a.shape
        out = np.zeros((r, c), dtype=np.float64)
        for i in range(r):
            for j in range(c):
                out[i, j] = float(self.a[i, j])
        return out

    def to_i64(self) -> np.ndarray:
        """Exact export to int64; raises OverflowError if any entry is too big."""
        return self.a.astype(np.int64)

    # -- comparison / misc -------------------------------------------------
    def __eq__(self, other) -> bool:
        if not isinstance(other, IntMat):
            return NotImplemented
        return self.a.shape == other.a.shape and bool((self.a == other.a).all())

    def __repr__(self) -> str:
        return f"IntMat({self.nrows}x{self.ncols})"

    def __str__(self) -> str:
        return format_matrix(self)


# ---------------------------------------------------------------------------
# fplll text format ([[a b c][d e f]]) — reference: matrix.h read/print
# ---------------------------------------------------------------------------
_TOKEN = re.compile(r"-?\d+|\[|\]")


def parse_matrix(text: str) -> IntMat:
    tokens = _TOKEN.findall(text)
    if not tokens or tokens[0] != "[":
        raise ValueError("expected '[' at start of matrix")
    rows: List[List[int]] = []
    cur: List[int] | None = None
    depth = 0
    for t in tokens:
        if t == "[":
            depth += 1
            if depth == 2:
                cur = []
        elif t == "]":
            if depth == 2 and cur is not None:
                rows.append(cur)
                cur = None
            depth -= 1
            if depth == 0:
                break
        else:
            if cur is None:
                raise ValueError("number outside row brackets")
            cur.append(int(t))
    if not rows:
        raise ValueError("empty matrix")
    return IntMat.from_rows(rows)


def read_matrix(path: str) -> IntMat:
    with open(path) as f:
        return parse_matrix(f.read())


def format_matrix(m: IntMat) -> str:
    lines = ["[" + " ".join(str(int(x)) for x in row) + "]" for row in m.a]
    return "[" + "\n".join(lines) + "\n]"


def parse_vector(text: str) -> List[int]:
    tokens = _TOKEN.findall(text)
    return [int(t) for t in tokens if t not in "[]"]


def format_vector(v: Iterable[int]) -> str:
    return "[" + " ".join(str(int(x)) for x in v) + "]"
