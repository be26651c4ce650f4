"""The check that a run loaded neither JAX nor the JAX package.

The port's name, ``fplll_tpu_torch``, begins with the JAX package's,
``fplll_tpu``, so modules are compared by their whole top-level name,
the part before the first dot.
"""

from __future__ import annotations

import sys
from typing import Iterable, List

__all__ = ["FORBIDDEN", "forbidden_loaded", "top_level"]

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "fplll_tpu"})


def top_level(module: str) -> str:
    return module.split(".", 1)[0]


def forbidden_loaded(modules: Iterable[str] | None = None) -> List[str]:
    """The names in `modules` (default: sys.modules) whose top-level name
    is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if top_level(m) in FORBIDDEN)
