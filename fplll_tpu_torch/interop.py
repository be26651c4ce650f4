"""Carrying the JAX package's state into the port.

This library holds no weights: the state a reduction starts from is the
integer basis and the BKZ strategy table. These two functions take them
in the forms the JAX package (``fplll_tpu``) keeps them, without
importing it, so that both packages can be given the same input.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np

from .algs.bkz_param import strategies_from_json
from .ops.intmat import IntMat

__all__ = ["basis_from_rows", "strategies_from_json"]


def basis_from_rows(rows: Union[Sequence[Sequence[int]], np.ndarray]
                    ) -> IntMat:
    """The port's IntMat of a basis given as a list of Python-int rows or
    as a 2-D numpy object array (the ``IntMat.a`` of either package).
    Entries are copied as exact Python ints."""
    if isinstance(rows, np.ndarray):
        if rows.ndim != 2:
            raise ValueError(f"basis must be 2-D, got shape {rows.shape}")
        rows = rows.tolist()
    return IntMat.from_rows(rows)
