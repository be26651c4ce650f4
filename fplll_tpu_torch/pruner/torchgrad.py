"""Differentiable pruning-cost gradient (the port of the JAX package's
pruner/jaxgrad.py, the SURVEY §7 replacement of the reference's numerical
log-gradient, fplll/pruner/pruner_cost.cpp:115-134): the log-target of
the pruner's descent and its gradient with respect to the coefficients.

On the card it is one hand-written CUDA kernel, ``csrc/pruner_grad.cu``
(built with nvcc at first use into ``build/torch_kernels/``, launched
through ctypes): one launch computes the log-target and its whole
gradient, the forward recurrence and its adjoint. :func:`gradient` packs
b, ipv and the scalars into a pinned host buffer, copies them to its
device twin, launches once with the outputs in the twin and copies the
d + 1 outputs back into the pinned buffer, all on the current stream,
which it synchronizes once. The two buffers are made once per device and
reused by every call. ``LAUNCHES`` counts the launches.

The plain version, which CPU tensors take, is torch.autograd over the
polynomial cost: the even-simplex relative-volume recurrence
(pruner_simplex.h:28-46) runs batched, one row per prefix volume
(jaxgrad's vmap), with the masked iteration count (`active = j < rd`) as
a torch.where over the rows; for the probability metric one more row
carries the shell-shrunk profile of svp_probability. One backward pass
yields the whole gradient (the numerical scheme needs 2(d-1) cost calls).
Both keep jaxgrad's Horner order, high coefficient first, one fused
multiply-add per step: the recurrence cancels catastrophically as d
grows, which makes the order of the operations, and whether a
multiply-add is fused, visible in the result.

For that reason the f64 gradient is trusted only up to _MAX_D; above it,
or whenever the gradient comes back non-finite, gradient() returns None
and the Pruner takes the numerical scheme, as with jaxgrad. A failure on
the device (a build, an allocation, a launch) raises: it never turns into
the plain version or the numerical scheme. The direction convention
matches the numerical scheme (g_i ~ -2 b_i dlog(target)/db_i, last
coordinate pinned).
"""

from __future__ import annotations

import ctypes
import math
from functools import lru_cache
from typing import Optional

import numpy as np

from .. import cuda_build
from ..torchsetup import resolve_device, torch

_MAX_D = 30               # PRUNER_GRAD_MAX_D of the CUDA source
_F64 = torch.float64
_IN_MAX = 3 * _MAX_D + 5  # the packed input at _MAX_D (see pack)

# launches of pruner_grad_kernel, and nothing else
LAUNCHES = 0
_LIB: Optional[ctypes.CDLL] = None
BUILD_LOG = ""


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


def build_kernel() -> ctypes.CDLL:
    """Compile csrc/pruner_grad.cu for sm_90a (once per source change) and
    load it; BUILD_LOG holds nvcc's output. Raises on a missing toolkit or
    a failed build."""
    global _LIB, BUILD_LOG
    if _LIB is not None:
        return _LIB
    lib, BUILD_LOG = cuda_build.build("pruner_grad")
    lib.pruner_grad_launch.restype = ctypes.c_int
    lib.pruner_grad_launch.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int] * 2 + [ctypes.c_double] * 4 + [ctypes.c_void_p]
    lib.pruner_grad_smem_bytes.restype = ctypes.c_int
    lib.pruner_grad_smem_bytes.argtypes = [ctypes.c_int] * 2
    lib.pruner_grad_error_string.restype = ctypes.c_char_p
    lib.pruner_grad_error_string.argtypes = [ctypes.c_int]
    _LIB = lib
    return lib


def kernel_tables(d: int) -> np.ndarray:
    """The kernel's constant tables: fact[0..d], ballv[0..2d+1] and
    kinv[k] = 1 / (k + 1), k = 0..d, as the plain version builds them."""
    from .pruner import _TAB_BALL_VOL, _TAB_FACTORIAL

    return np.concatenate([
        [float(_TAB_FACTORIAL[i]) for i in range(d + 1)],
        [float(_TAB_BALL_VOL[i]) for i in range(2 * d + 2)],
        1.0 / np.arange(1.0, d + 2.0)])


@lru_cache(maxsize=None)
def _device_tables(d: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(kernel_tables(d)).to(device)


def _prob(metric: int) -> bool:
    from .pruner import PRUNER_METRIC_PROBABILITY_OF_SHORTEST
    return metric == PRUNER_METRIC_PROBABILITY_OF_SHORTEST


@lru_cache(maxsize=None)
def kernel_scalars(d: int, metric: int, symmetry_factor: float,
                   shell_ratio: float) -> tuple:
    """The kernel's scalar arguments after d: (prob, sf, dx2, dxn, log_sf),
    computed on the host as the plain version computes them."""
    return (int(_prob(metric)), symmetry_factor, shell_ratio * shell_ratio,
            shell_ratio ** (2 * d), float(np.log(symmetry_factor)))


def _scalars_in(radius: float, target: float, preproc_cost: float,
                metric: int) -> list:
    """The last five doubles of the kernel's input: radius, target,
    preproc_cost, then log1p(-target) for the probability metric (else 0)
    and log(radius) for the expected solutions (else 0), each taken only
    where the plain version takes it."""
    prob = _prob(metric)
    return [radius, target, preproc_cost,
            math.log1p(-target) if prob else 0.0,
            0.0 if prob else math.log(radius)]


def pack(b, ipv, radius: float, target: float, preproc_cost: float,
         metric: int) -> np.ndarray:
    """The kernel's per-call input: b, ipv[:2d] and _scalars_in; 3d + 5
    doubles."""
    return np.concatenate([np.asarray(b, dtype=np.float64),
                           np.asarray(ipv, dtype=np.float64),
                           _scalars_in(radius, target, preproc_cost, metric)])


def log_target_and_grad(inp: torch.Tensor, d: int, metric: int,
                        symmetry_factor: float,
                        shell_ratio: float) -> torch.Tensor:
    """[log-target, its gradient with respect to b] (d + 1 doubles on
    inp's device) for the packed input `inp` (see pack). On a CUDA tensor
    one launch of the kernel, which raises when it cannot build or launch;
    on a CPU tensor the plain version."""
    if inp.dtype != _F64 or tuple(inp.shape) != (3 * d + 5,) or \
            not inp.is_contiguous() or not 1 <= d <= _MAX_D:
        raise ValueError(f"inp: expected contiguous float64 ({3 * d + 5},) "
                         f"with 1 <= d <= {_MAX_D}, got {inp.dtype} "
                         f"{tuple(inp.shape)}, d = {d}")
    if inp.device.type == "cuda":
        return _launch(inp, d, kernel_scalars(d, metric, symmetry_factor,
                                              shell_ratio))
    return log_target_and_grad_plain(inp, d, metric, symmetry_factor,
                                     shell_ratio)


def log_target_and_grad_plain(inp: torch.Tensor, d: int, metric: int,
                              symmetry_factor: float,
                              shell_ratio: float) -> torch.Tensor:
    """The plain version of log_target_and_grad (torch.autograd) on inp's
    device: what CPU tensors take, and, on the card, the yardstick the
    kernel is held against."""
    log_target = _build(d, metric, symmetry_factor, shell_ratio, inp.device)
    b = inp[:d].clone().requires_grad_(True)
    radius, target, preproc_cost = inp[3 * d:3 * d + 3].tolist()
    with torch.enable_grad():
        out = log_target(b, inp[d:3 * d], radius, target, preproc_cost)
        g, = torch.autograd.grad(out, b)
    return torch.cat([out.detach().reshape(1), g])


def _launch(inp: torch.Tensor, d: int, scalars: tuple,
            out: torch.Tensor | None = None) -> torch.Tensor:
    """One launch on inp's device and current stream into `out` (d + 1
    doubles there, made when None); returns `out`."""
    global LAUNCHES
    lib = build_kernel()
    tab = _device_tables(d, inp.device)
    if out is None:
        out = torch.empty(d + 1, dtype=_F64, device=inp.device)
    err = lib.pruner_grad_launch(
        tab.data_ptr(), inp.data_ptr(), out.data_ptr(), d, *scalars,
        torch.cuda.current_stream(inp.device).cuda_stream)
    if err != 0:
        raise RuntimeError("pruner_grad_kernel launch failed: " +
                           lib.pruner_grad_error_string(err).decode())
    LAUNCHES += 1
    return out


class KernelLogTarget(torch.autograd.Function):
    """The log-target as a differentiable function of b: the forward is
    log_target_and_grad (one launch on the card), the backward scales the
    gradient it saved."""

    @staticmethod
    def forward(ctx, b, ipv, radius, target, preproc_cost, consts):
        inp = torch.cat([b.detach(), ipv, b.new_tensor(_scalars_in(
            radius, target, preproc_cost, consts[0]))])
        res = log_target_and_grad(inp, b.shape[0], *consts)
        ctx.save_for_backward(res[1:])
        return res[0]

    @staticmethod
    def backward(ctx, g):
        grad, = ctx.saved_tensors
        return g * grad, None, None, None, None, None


def log_target(b, ipv, radius: float, target: float, preproc_cost: float,
               metric: int, symmetry_factor: float, shell_ratio: float):
    """The pruning log-target of b (f64, d <= _MAX_D) through
    KernelLogTarget, differentiable in b."""
    return KernelLogTarget.apply(b, ipv, radius, target, preproc_cost,
                                 (metric, symmetry_factor, shell_ratio))


class _Staging:
    """gradient()'s buffers on one device: a pinned host buffer and its
    device twin, each the packed input at _MAX_D and then _MAX_D + 1
    outputs, made at a device's first gradient and reused by every
    call."""

    def __init__(self, device: torch.device):
        self.host = torch.empty(_IN_MAX + _MAX_D + 1, dtype=_F64,
                                pin_memory=True)
        self.card = torch.empty(_IN_MAX + _MAX_D + 1, dtype=_F64,
                                device=device)
        self.host_np = self.host.numpy()


@lru_cache(maxsize=None)
def _staging(device: torch.device) -> _Staging:
    return _Staging(device)


def _gradient_on_card(packed: np.ndarray, d: int, consts: tuple,
                      dev: torch.device) -> np.ndarray:
    """[log-target, gradient] of one launch through the device's staging
    buffers: the packed input copied to the card, the outputs written
    there and copied back, one stream synchronize. The previous call's
    synchronize makes the buffers free again."""
    st = _staging(dev)
    n_in, n_out = packed.shape[0], d + 1
    st.host_np[:n_in] = packed
    inp, out = st.card[:n_in], st.card[_IN_MAX:_IN_MAX + n_out]
    inp.copy_(st.host[:n_in], non_blocking=True)
    _launch(inp, d, kernel_scalars(d, *consts), out)
    st.host[_IN_MAX:_IN_MAX + n_out].copy_(out, non_blocking=True)
    torch.cuda.current_stream(dev).synchronize()
    return st.host_np[_IN_MAX:_IN_MAX + n_out].copy()


def gradient(pruner, b, device=None) -> np.ndarray | None:
    """Analytic log-target gradient in the numerical scheme's convention,
    computed on `device` (torchsetup.resolve_device): one launch of the
    kernel on the card, the plain version on the CPU; None where the
    analytic path does not apply (wrong length, too large d, non-finite
    result). Errors on the device, a failed build among them, raise."""
    d = pruner.d
    if len(b) != d or d > _MAX_D:
        return None
    dev = resolve_device(device)
    if dev.type == "cuda":
        build_kernel()       # before any device work: no toolkit, no call
    bn = np.asarray(b, dtype=np.float64)
    consts = (int(pruner.metric), float(pruner.symmetry_factor),
              float(pruner.shell_ratio))
    packed = pack(bn, pruner.ipv[:2 * d], float(pruner.normalized_radius),
                  float(pruner.target), float(pruner.preproc_cost),
                  consts[0])
    if dev.type == "cuda":
        res = _gradient_on_card(packed, d, consts, dev)
    else:
        res = log_target_and_grad(torch.from_numpy(packed), d,
                                  *consts).numpy()
    g = res[1:]
    if not np.all(np.isfinite(g)):
        return None
    out = -2.0 * bn * g
    out[-1] = 0.0
    return out
