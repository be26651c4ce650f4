"""Input pools: integer bases and request tables in ``data/<pool>.npz``,
with their provenance and digests in ``data/<pool>.json``."""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np

__all__ = ["digest", "load_pool"]


def digest(a: np.ndarray) -> str:
    """sha256 of an array's dtype, shape and bytes (C order)."""
    a = np.ascontiguousarray(a)
    h = hashlib.sha256(f"{a.dtype.str}{a.shape}".encode())
    h.update(a.tobytes())
    return h.hexdigest()


def load_pool(root: str, file: str) -> dict:
    """The arrays of ``data/<file>``, each checked against the digest its
    provenance file records; raises on a missing array or a mismatch."""
    path = os.path.join(root, "data", file)
    with open(path[:-len(".npz")] + ".json") as f:
        prov = json.load(f)
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    want = prov["digests"]
    if set(arrays) != set(want):
        raise ValueError(f"{file}: arrays {sorted(arrays)}, provenance "
                         f"lists {sorted(want)}")
    for k, a in arrays.items():
        if digest(a) != want[k]:
            raise ValueError(f"{file}: array {k!r} does not match its "
                             "recorded digest")
    return arrays
