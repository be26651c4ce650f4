"""The comparison that decides ``correct``.

A judge is a module of this folder, named by the cell's ``judge``: its
``judge(pool, config, table, answered, device)`` takes the requests a
run answered and what the program answered (or the control in its
place), works the truth out again from the loaded inputs with the
reference, and returns each number it compares; its ``control(pool,
config, table, rows, dtype, device)`` answers the same requests with
the reference's own search in a lower precision. The cell's file gives
each number's limit, and :func:`verdict` holds the numbers to them.
"""

from __future__ import annotations

import importlib
from typing import Dict

import torch

__all__ = ["load", "verdict", "DTYPES"]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def load(name: str):
    """The judge module ``reference/<name>.py``."""
    return importlib.import_module(f"portbench.reference.{name}")


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> dict:
    """Each number beside its limit, and whether every one keeps to it."""
    checks = {k: {"value": float(numbers[k]), "limit": float(limits[k])}
              for k in limits}
    return {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
            "checks": checks}
