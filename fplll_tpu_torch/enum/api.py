"""Enumeration facade with pluggable backends.

This is the port's reproduction of the reference's
external-enumerator seam (fplll/enum/enumerate.h:87-111
Enumeration facade; enum/enumerate_ext_api.h:52-93 plug-in ABI;
enumerate_ext.cpp:34-46 registration): the facade first offers the tree
search to the registered scale-out backend (the batched CUDA kernel from
fplll_tpu_torch.enum.device, or any user-registered enumerator), and falls
back to the sequential host oracle when the backend declines (tiny dims,
subtrees, the proved-CVP reset walk, large or first-N solution lists).
"""

from __future__ import annotations

import functools
from typing import Callable, List, Optional, Sequence

from ..torchsetup import resolve_device
from .cpu import EnumerationDyn
from .evaluator import Evaluator

__all__ = ["Enumeration", "set_external_enumerator", "get_external_enumerator",
           "registered_enumerator"]

# Registered scale-out enumerator. Signature mirrors the facade's
# enumerate(); it must return the new max_dist (caller scale) or None to
# decline, in which case the host oracle runs.
_external_enumerator: Optional[Callable] = None
_auto_register_tried = False


def _auto_register() -> None:
    """Lazily register the batched device kernel as the default backend
    (the analogue of enumlib being the compiled-in default extenum,
    reference: enumerate_ext.cpp:34-38)."""
    global _auto_register_tried
    if _auto_register_tried or _external_enumerator is not None:
        return
    _auto_register_tried = True
    # no blanket except: a broken device backend must fail the run, not
    # quietly leave every search on the host oracle
    from .device import register_device_backend
    register_device_backend()


def set_external_enumerator(fn: Optional[Callable]) -> None:
    """Register (or clear, with None) the scale-out enumerator
    (reference: enumerate_ext.cpp:41-46 set_external_enumerator)."""
    global _external_enumerator
    _external_enumerator = fn


def get_external_enumerator() -> Optional[Callable]:
    return _external_enumerator


def registered_enumerator() -> Optional[Callable]:
    """The scale-out enumerator the facade uses, registering the default
    device backend first if nothing was registered yet."""
    _auto_register()
    return _external_enumerator


class Enumeration:
    """Facade: tries the registered backend, falls back to the host DFS."""

    def __init__(self, gso, evaluator: Evaluator,
                 max_indices: Optional[List[int]] = None,
                 nr_threads: int = 0, backend: str | None = None,
                 external: Optional[Callable] = None, device=None):
        # `external`: this facade's scale-out enumerator in place of the
        # registered one (BKZ binds its device into the default backend);
        # `device`: the device of the default backend and of the host
        # oracle's CVP resets (torchsetup.resolve_device)
        self._external = external
        self._device = device
        self._gso = gso
        self._evaluator = evaluator
        self._max_indices = max_indices or []
        self._backend = backend
        self._nodes_total = 0
        self._nodes: List[int] = []
        self._dyn: Optional[EnumerationDyn] = None

    def get_nodes(self, level: int = -1) -> int:
        if level == -1:
            return self._nodes_total
        return self._nodes[level] if level < len(self._nodes) else 0

    def enumerate(self, first: int, last: int, fmaxdist: float,
                  fmaxdistexpo: int = 0,
                  target_coord: Sequence[float] = (),
                  subtree: Sequence[float] = (),
                  pruning: Sequence[float] = (),
                  dual: bool = False, subtree_reset: bool = False) -> float:
        ext = None
        if self._backend != "cpu":
            ext = self._external or registered_enumerator()
            if self._external is None and self._device is not None:
                from .device import device_external_enumerator
                if ext is device_external_enumerator:
                    ext = functools.partial(ext, device=self._device)
        use_external = (
            ext is not None
            and not self._max_indices          # reset path: host only
            and not subtree_reset
        )
        if use_external:
            res = ext(
                self._gso, self._evaluator, first, last, fmaxdist,
                fmaxdistexpo, target_coord, subtree, pruning, dual)
            if res is not None:
                new_maxdist, nodes = res
                self._nodes = list(nodes)
                self._nodes_total = int(sum(nodes))
                return new_maxdist
            if self._backend == "device":
                raise RuntimeError(
                    "device enumeration backend declined the job")
        # the proved-CVP resets go to the card unless this facade is
        # host-only
        reset_device = None
        if self._max_indices and self._backend != "cpu":
            reset_device = resolve_device(self._device)
        dyn = EnumerationDyn(self._gso, self._evaluator, self._max_indices,
                             device=reset_device)
        self._dyn = dyn
        out = dyn.enumerate(first, last, fmaxdist, fmaxdistexpo, target_coord,
                            subtree, pruning, dual, subtree_reset)
        self._nodes = list(dyn.nodes)
        self._nodes_total = dyn.get_nodes()
        return out
