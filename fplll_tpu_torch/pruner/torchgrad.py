"""Differentiable pruning-cost gradient: torch.autograd over the polynomial
cost (the port of the JAX package's pruner/jaxgrad.py, the SURVEY §7
replacement of the reference's numerical log-gradient,
fplll/pruner/pruner_cost.cpp:115-134).

The even-simplex relative-volume recurrence (pruner_simplex.h:28-46) runs
batched, one row per prefix volume (jaxgrad's vmap), with the masked
iteration count (`active = j < rd`) as a torch.where over the rows; for the
probability metric one more row carries the shell-shrunk profile of
svp_probability. Everything is f64 tensors on the pruner's device, and one
backward pass yields the whole gradient (the numerical scheme needs 2(d-1)
cost calls). The Horner loop keeps jaxgrad's order, high coefficient
first: the recurrence cancels catastrophically as d grows, which makes the
order of the operations, and whether a multiply-add is fused, visible in
the result.

For that reason the f64 gradient is trusted only up to _MAX_D; above it,
or whenever the gradient comes back non-finite, gradient() returns None
and the Pruner takes the numerical scheme, as with jaxgrad. A failure on
the device (an allocation, a launch) raises: it never turns into the
numerical scheme. The direction convention matches the numerical scheme
(g_i ~ -2 b_i dlog(target)/db_i, last coordinate pinned).
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np

from ..torchsetup import resolve_device, torch

_MAX_D = 30
_F64 = torch.float64


class _Clip(torch.autograd.Function):
    """x clipped to [lo, hi] (either may be None) with the gradient of
    jaxgrad's jnp.maximum / jnp.minimum / jnp.clip: the incoming gradient
    times 1 inside, 1/2 on a bound, 0 outside. A NaN gradient stays NaN
    (torch.clamp's backward would zero it), so gradient() returns None
    exactly where jaxgrad does."""

    @staticmethod
    def forward(ctx, x, lo, hi):
        w = torch.ones_like(x)
        if lo is not None:
            w = w * ((x > lo).to(x.dtype) + 0.5 * (x == lo).to(x.dtype))
            x = torch.clamp(x, min=lo)
        if hi is not None:
            w = w * ((x < hi).to(x.dtype) + 0.5 * (x == hi).to(x.dtype))
            x = torch.clamp(x, max=hi)
        ctx.save_for_backward(w)
        return x

    @staticmethod
    def backward(ctx, g):
        w, = ctx.saved_tensors
        return g * w, None, None


def _clip(x, lo=None, hi=None):
    return _Clip.apply(x, lo, hi)


@lru_cache(maxsize=None)
def _build(d: int, metric: int, symmetry_factor: float, shell_ratio: float,
           device: torch.device):
    """log_target(b, ipv, radius, target, preproc_cost) for one (d, metric,
    symmetry, shell ratio, device), its constant tables built once."""
    from .pruner import (_TAB_BALL_VOL, _TAB_FACTORIAL,
                         PRUNER_METRIC_PROBABILITY_OF_SHORTEST)

    prob_metric = metric == PRUNER_METRIC_PROBABILITY_OF_SHORTEST
    fact = torch.tensor([float(_TAB_FACTORIAL[i]) for i in range(d + 1)],
                        dtype=_F64, device=device)
    ballv = torch.tensor([float(_TAB_BALL_VOL[i]) for i in range(2 * d + 2)],
                         dtype=_F64, device=device)
    kinv = 1.0 / torch.arange(1.0, d + 2.0, dtype=_F64, device=device)
    # rows 0..d-1: the prefix volumes rd = 1..d of b; row d (probability
    # metric only): the full volume of the shell-shrunk profile
    rds = list(range(1, d + 1)) + ([d] if prob_metric else [])
    rd = torch.tensor(rds, device=device)
    rows = torch.arange(len(rds), device=device)
    P0 = torch.zeros(len(rds), d + 2, dtype=_F64, device=device)
    P0[:, 0] = 1.0
    zero_col = torch.zeros(len(rds), 1, dtype=_F64, device=device)
    active = [(j < rd)[:, None] for j in range(d)]
    at = [torch.clamp(rd - 1 - j, min=0) for j in range(d)]
    sign = torch.where(rd % 2 == 1, -1.0, 1.0).to(_F64)
    fact_rd = fact[rd]
    i2 = torch.arange(2 * d, device=device)
    expo = i2.to(_F64)
    half = i2 // 2
    dxn = shell_ratio ** (2 * d)

    def rel_vols(B):
        """Relative volume of the rd[r]-prefix body of row r of B."""
        binv = 1.0 / B[rows, rd - 1]
        P = P0
        for j in range(d):
            shifted = torch.cat([zero_col, P[:, :-1] * kinv], dim=1)
            x = B[rows, at[j]] * binv
            cols = shifted.unbind(1)
            # full-length Horner, high coefficient first (the first step,
            # 0 * x + c, is c): trailing zero coefficients add nothing.
            # One multiply-add per step, as XLA fuses jaxgrad's on the CPU:
            # the fused step brings the two ten times closer than a
            # separate multiply and add (tests/test_torch_pruner.py)
            acc = cols[d + 1]
            for c in range(d, -1, -1):
                acc = torch.addcmul(cols[c], acc, x)
            newP = torch.cat([(-acc)[:, None], shifted[:, 1:]], dim=1)
            P = torch.where(active[j], newP, P)
        return sign * P[:, 0] * fact_rd

    def cost_evec(b, odd, ipv, radius):
        even = torch.sqrt(_clip(odd[:-1] * odd[1:], 1e-300))
        rv = torch.stack([torch.cat([odd.new_ones(1), even]), odd],
                         dim=1).reshape(2 * d)
        tmp = (radius ** (expo + 1.0)) * rv * ballv[1:2 * d + 1] * \
            torch.sqrt(_clip(b[half], 1e-300) ** (1.0 + expo)) * \
            ipv * symmetry_factor
        return torch.sum(tmp)

    def exp_solutions(b, vol, ipv, radius):
        j = 2 * d - 1
        t = torch.log(_clip(vol, 1e-300))
        t = t + torch.log(ballv[j + 1])
        t = t + (math.log(radius) +
                 torch.log(_clip(b[j // 2], 1e-300)) / 2.0) * (j + 1)
        t = t + torch.log(ipv[j])
        t = t + float(np.log(symmetry_factor))
        return torch.exp(t)

    def log_target(b, ipv, radius, target, preproc_cost):
        if prob_metric:
            bmdb = _clip(b / (shell_ratio * shell_ratio), hi=1.0)
            vols = rel_vols(torch.cat([b.expand(d, d), bmdb[None]]))
            odd = vols[:d]
            dvol = dxn * vols[d] - vols[d - 1]
            p = _clip(dvol / (dxn - 1.0), 1e-12, 0.999999)
            trials = math.log1p(-target) / torch.log1p(-p)
        else:
            odd = rel_vols(b.expand(d, d))
            e = _clip(exp_solutions(b, odd[d - 1], ipv, radius), 1e-300)
            trials = target / e
        trials = _clip(trials, 1.0)
        cost = cost_evec(b, odd, ipv, radius)
        return torch.log(_clip(cost * trials + preproc_cost * (trials - 1.0),
                               1e-300))

    return log_target


def gradient(pruner, b, device=None) -> np.ndarray | None:
    """Analytic log-target gradient in the numerical scheme's convention,
    computed on `device` (torchsetup.resolve_device), or None where the
    analytic path does not apply (wrong length, too large d, non-finite
    result). Errors on the device propagate."""
    d = pruner.d
    if len(b) != d or d > _MAX_D:
        return None
    dev = resolve_device(device)
    log_target = _build(d, int(pruner.metric), float(pruner.symmetry_factor),
                        float(pruner.shell_ratio), dev)
    bn = np.asarray(b, dtype=np.float64)
    bt = torch.tensor(bn, dtype=_F64, device=dev, requires_grad=True)
    ipv = torch.tensor(np.asarray(pruner.ipv[:2 * d], dtype=np.float64),
                       dtype=_F64, device=dev)
    out = log_target(bt, ipv, float(pruner.normalized_radius),
                     float(pruner.target), float(pruner.preproc_cost))
    g, = torch.autograd.grad(out, bt)
    g = g.cpu().numpy()
    if not np.all(np.isfinite(g)):
        return None
    out = -2.0 * bn * g
    out[-1] = 0.0
    return out
