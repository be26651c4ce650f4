"""Checkpoint/resume for long reductions.

The port's copy of the JAX package's utils/checkpoint.py, in the same
file format. The reference has no checkpointing (SURVEY §5: runs persist
nothing but -bkzdumpgso JSON). For long BKZ runs the library persists the
exact integer basis (the complete algorithm state — GSO float state is
recomputed on load, exactly as the reference's precision ladder restarts
from the current basis, wrapper.cpp:281-359) plus driver progress
(loop counter, node counter, elapsed time).

Format: a single JSON file with big-int rows as decimal strings;
written atomically (tmp + rename) so an interrupted write never
corrupts the previous checkpoint.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, Optional, Tuple

from ..ops.intmat import IntMat

__all__ = ["save_checkpoint", "load_checkpoint"]

_FORMAT_VERSION = 1


def save_checkpoint(path: str, b: IntMat, u: Optional[IntMat] = None,
                    meta: Optional[Dict[str, Any]] = None) -> None:
    payload = {
        "format_version": _FORMAT_VERSION,
        "basis": [[str(int(x)) for x in row] for row in b.a],
        "u": [[str(int(x)) for x in row] for row in u.a] if u is not None
             else None,
        "meta": meta or {},
    }
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".ckpt-")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_checkpoint(path: str) -> Tuple[IntMat, Optional[IntMat],
                                        Dict[str, Any]]:
    with open(path) as f:
        payload = json.load(f)
    if payload.get("format_version") != _FORMAT_VERSION:
        raise ValueError("unsupported checkpoint format "
                         f"{payload.get('format_version')}")
    b = IntMat.from_rows([[int(x) for x in row] for row in payload["basis"]])
    u = None
    if payload.get("u") is not None:
        u = IntMat.from_rows([[int(x) for x in row] for row in payload["u"]])
    return b, u, payload.get("meta", {})
