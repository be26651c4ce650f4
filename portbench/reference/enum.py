"""The shortest vector inside a pruned enumeration region, in plain PyTorch.

A block with Gram-Schmidt data (mu, r) of height n, pruning coefficients
p (p[k] bounds level k, 1 at level 0) and a squared bound A define the
region P(A): the integer vectors x whose partial squared lengths

    l_k(x) = sum_{i >= k} r_i (x_i - c_i)^2,  c_i = -sum_{j > i} mu[j][i] x_j,

satisfy l_k(x) <= p[k] * A at every level k. :func:`shortest` walks the
whole region breadth first, level by level from the top, in chunks that
are pushed on a stack so that no frontier holds more than `chunk` rows,
and returns the shortest nonzero vector of P(A) and its length. Of each
pair +-x it keeps the one whose topmost nonzero coordinate is positive.

A pruned depth-first search with a bound that shrinks to each solution
it finds ends with an answer w such that P(|w|^2) holds no vector
shorter than w, whatever order it walked in. So `shortest(.., A =
|w|^2)` is the certificate of a pruned answer, and `shortest(.., A)` on
an empty answer shows whether the region held anything at all.

The walk computes in `dtype`: float64 for the reference; a lower
precision gives the control (the same search, rounded below what the
program states).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["shortest"]


def shortest(mu, r, prune, bound: float, *, dtype=torch.float64,
             device="cpu", chunk: int = 1 << 20
             ) -> Tuple[Optional[float], Optional[list], int]:
    """(length, coordinates, nodes): the shortest nonzero vector of P(bound)
    with its squared length computed in `dtype`, or (None, None, nodes)
    when the region holds none; nodes counts every vector of every level
    that the walk admitted."""
    n = len(r)
    mu_t = torch.as_tensor(mu, dtype=torch.float64).to(device=device,
                                                       dtype=dtype)
    r_t = torch.as_tensor(r, dtype=torch.float64).to(device=device,
                                                     dtype=dtype)
    lim = (torch.as_tensor(prune, dtype=torch.float64) * float(bound)).to(
        device=device, dtype=dtype)
    best_len, best_x, nodes = None, None, 0
    # each entry: (level k, coordinates (F, n) with x_k .. x_{n-1} fixed,
    # partial lengths (F,), whether every fixed coordinate is zero (F,))
    stack = [(n, torch.zeros((1, n), dtype=dtype, device=device),
              torch.zeros(1, dtype=dtype, device=device),
              torch.ones(1, dtype=torch.bool, device=device))]
    while stack:
        k, xs, pd, zero = stack.pop()
        lvl = k - 1
        c = -(xs @ mu_t[:, lvl])
        room = torch.clamp(lim[lvl] - pd, min=0)
        w = torch.sqrt(room / r_t[lvl])
        lo = torch.ceil(c - w)
        hi = torch.floor(c + w)
        lo = torch.where(zero, torch.clamp(lo, min=0), lo)
        cnt = torch.clamp(hi - lo + 1, min=0).to(torch.int64)
        total = int(cnt.sum())
        if total == 0:
            continue
        if total > chunk and len(cnt) > 1:
            # split the parents so that each part's children fit a chunk
            ends = torch.cumsum(cnt, 0)
            cut = torch.searchsorted(ends, torch.arange(
                chunk, total, chunk, device=device), right=True).tolist()
            bounds = sorted(set([0] + [i for i in cut if 0 < i < len(cnt)]
                                + [len(cnt)]))
            if len(bounds) == 2:    # one parent holds most: halve anyway
                bounds = [0, len(cnt) // 2, len(cnt)]
            for a, b in zip(bounds[:-1], bounds[1:]):
                stack.append((k, xs[a:b], pd[a:b], zero[a:b]))
            continue
        idx = torch.repeat_interleave(torch.arange(len(cnt), device=device),
                                      cnt)
        offs = torch.arange(total, device=device) - \
            torch.repeat_interleave(torch.cumsum(cnt, 0) - cnt, cnt)
        x = lo[idx] + offs.to(dtype)
        d = x - c[idx]
        pd_c = pd[idx] + d * d * r_t[lvl]
        keep = pd_c <= lim[lvl]
        xs_c = xs[idx][keep]
        xs_c[:, lvl] = x[keep]
        pd_c = pd_c[keep]
        zero_c = zero[idx][keep] & (x[keep] == 0)
        nodes += int(keep.sum())
        if lvl > 0:
            if len(pd_c):
                stack.append((lvl, xs_c, pd_c, zero_c))
            continue
        live = ~zero_c
        if not bool(live.any()):
            continue
        pd_l = pd_c[live]
        i = int(torch.argmin(pd_l))
        length = float(pd_l[i])
        if best_len is None or length < best_len:
            best_len = length
            best_x = [int(v) for v in xs_c[live][i].double().round().tolist()]
    return best_len, best_x, nodes
