"""Native host kernels, built on demand with the system toolchain.

enum_core.c implements the sequential KFP DFS in C (the role of the
reference's compiled enumerators); it is compiled to a shared object on
first use and loaded through ctypes. A failed build raises: the port
never falls back silently to the pure-Python engines.

The shared objects go to ``build/native/`` beside the package (override
with FPLLL_TORCH_NATIVE_CACHE), apart from the JAX package's cache, so
the two packages' builds never overwrite each other.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_LIB = None


def cache_dir() -> str:
    return os.environ.get(
        "FPLLL_TORCH_NATIVE_CACHE",
        os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                     "native"))


def _compile(src_name: str, so_name: str, extra_flags=()) -> str:
    """Compile one C source from this directory into the on-demand cache;
    returns the .so path or raises RuntimeError. Shared by every native
    component (the single build seam replacing the reference's autotools,
    fplll's configure.ac)."""
    src = os.path.join(_HERE, src_name)
    out_dir = cache_dir()
    os.makedirs(out_dir, exist_ok=True)
    so_path = os.path.join(out_dir, so_name)
    # staleness check covers every .c in the directory: bkz_core.c
    # #includes lll_core.c/enum_core.c, so its own mtime is not enough
    newest = max(os.path.getmtime(os.path.join(_HERE, f))
                 for f in os.listdir(_HERE) if f.endswith(".c"))
    if os.path.exists(so_path) and os.path.getmtime(so_path) >= newest:
        return so_path
    # build to a private name and rename: concurrent test workers may
    # race on the same cache, and a half-written .so must never be loaded
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = ["cc", "-O3", "-march=native", "-shared", "-fPIC",
           *extra_flags, "-o", tmp, src, "-lm"]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=120)
        if res.returncode != 0:
            cmd.remove("-march=native")
            res = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=120)
        if res.returncode != 0:
            raise RuntimeError(f"native build of {src_name} failed:\n"
                               f"{res.stderr[-4000:]}")
        os.replace(tmp, so_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so_path


class EnumResult(ctypes.Structure):
    _fields_ = [
        ("maxdist", ctypes.c_double),
        ("best_dist", ctypes.c_double),
        ("sol_count", ctypes.c_double),
        ("nodes_budget", ctypes.c_int64),
        ("visited", ctypes.c_int64),
        ("found", ctypes.c_int),
    ]


def _build() -> ctypes.CDLL:
    lib = ctypes.CDLL(_compile("enum_core.c", "enum_core.so"))
    lib.enum_run.restype = ctypes.c_int
    lib.enum_run.argtypes = [
        ctypes.c_int,
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),  # mut
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),  # rdiag
        ctypes.c_void_p,                                           # pruning
        ctypes.c_void_p,                                           # target
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),  # best_x
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),  # nodes
        ctypes.POINTER(EnumResult),
    ]
    dptr = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.enum_gen_roots.restype = ctypes.c_int
    lib.enum_gen_roots.argtypes = [
        ctypes.c_int, dptr, dptr, ctypes.c_void_p, dptr,
        ctypes.c_double, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_long, ctypes.c_long, ctypes.c_int,
        dptr, ctypes.c_void_p, dptr, dptr,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_long),
    ]
    return lib


def get_lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        _LIB = _build()
    return _LIB


def native_enumerate(mut: np.ndarray, rdiag: np.ndarray,
                     pruning: Optional[np.ndarray],
                     target: Optional[np.ndarray], maxdist: float,
                     is_svp: bool, dual: bool, count_mode: bool,
                     node_budget: int = 0):
    """Run the native DFS. Returns None when the core reports an error,
    else (new_maxdist, best_dist, best_x|None, sol_count, nodes, visited)."""
    lib = get_lib()
    d = len(rdiag)
    mut = np.ascontiguousarray(mut, dtype=np.float64)
    rdiag = np.ascontiguousarray(rdiag, dtype=np.float64)
    pr = None if pruning is None else \
        np.ascontiguousarray(pruning, dtype=np.float64)
    tg = None if target is None else \
        np.ascontiguousarray(target, dtype=np.float64)
    best_x = np.zeros(d, dtype=np.float64)
    nodes = np.zeros(d, dtype=np.float64)
    res = EnumResult()
    res.maxdist = float(maxdist)
    res.nodes_budget = int(node_budget)
    rc = lib.enum_run(
        d, mut, rdiag,
        pr.ctypes.data_as(ctypes.c_void_p) if pr is not None else None,
        tg.ctypes.data_as(ctypes.c_void_p) if tg is not None else None,
        int(is_svp), int(dual), int(count_mode), best_x, nodes,
        ctypes.byref(res))
    if rc != 0:
        return None
    return (res.maxdist, res.best_dist,
            best_x if res.found else None, res.sol_count, nodes, res.visited)


# Scratch buffers for the native root expansion (np.empty pages are only
# touched for rows actually produced).  ctypes releases the GIL for the
# duration of lib.enum_gen_roots, so concurrent host threads could race
# on the shared buffers — the lock is held across the C call.
_ROOTS_SCRATCH: dict = {}
_ROOTS_LOCK = __import__("threading").Lock()


def native_gen_roots(mut: np.ndarray, rdiag: np.ndarray,
                     pruning: Optional[np.ndarray], cp0: np.ndarray,
                     maxdist: float, is_svp: bool, dual: bool,
                     max_device_levels: int, target: int,
                     cap: int = 1 << 19, nfix_max: int = 24):
    """Native layered top-tree expansion (enum_core.c:enum_gen_roots).
    Returns (roots_x, roots_a, roots_pd, m_real, nodes_per_level) or None
    when over capacity (callers use the host expansion)."""
    lib = get_lib()
    d = len(rdiag)
    key = (cap, nfix_max, bool(dual))
    nodes = np.zeros(d, dtype=np.float64)
    mut = np.ascontiguousarray(mut, dtype=np.float64)
    rdiag = np.ascontiguousarray(rdiag, dtype=np.float64)
    cp0 = np.ascontiguousarray(cp0, dtype=np.float64)
    pr = None if pruning is None else \
        np.ascontiguousarray(pruning, dtype=np.float64)
    m_real = ctypes.c_int(0)
    count = ctypes.c_long(0)
    with _ROOTS_LOCK:
        bufs = _ROOTS_SCRATCH.get(key)
        if bufs is None:
            bufs = (np.empty((cap, nfix_max)),
                    np.empty((cap, nfix_max)) if dual else None,
                    np.empty(cap))
            _ROOTS_SCRATCH[key] = bufs
        out_x, out_a, out_pd = bufs
        rc = lib.enum_gen_roots(
            d, mut, rdiag,
            pr.ctypes.data_as(ctypes.c_void_p) if pr is not None else None,
            cp0, float(maxdist), int(is_svp), int(dual),
            int(max_device_levels), int(target), int(cap), int(nfix_max),
            out_x,
            out_a.ctypes.data_as(ctypes.c_void_p)
            if out_a is not None else None,
            out_pd, nodes, ctypes.byref(m_real), ctypes.byref(count))
        if rc != 0:
            return None
        R, m = int(count.value), int(m_real.value)
        nfix = d - m
        xs = out_x[:R, :nfix].copy()
        als = out_a[:R, :nfix].copy() if dual else xs
        pd_out = out_pd[:R].copy()
    return xs, als, pd_out, m, nodes


# ---------------------------------------------------------------------------
# lll_core: fast-method LLL over multi-limb integers
# ---------------------------------------------------------------------------
_LLL_LIB = None


def _build_lll() -> ctypes.CDLL:
    lib = ctypes.CDLL(_compile("lll_core.c", "lll_core.so"))
    lib.lll_fast.restype = ctypes.c_int
    lib.lll_fast.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS"),
        ctypes.c_void_p,
        ctypes.c_double, ctypes.c_double,
        ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_long),
    ]
    return lib


def get_lll_lib() -> ctypes.CDLL:
    global _LLL_LIB
    if _LLL_LIB is None:
        _LLL_LIB = _build_lll()
    return _LLL_LIB


def _ints_to_limbs(rows, L: int) -> np.ndarray:
    """Python ints -> little-endian two's-complement uint64 limb tensor."""
    d = len(rows)
    n = len(rows[0])
    # fast path: every entry fits int64 (the common BKZ-window case) —
    # one vectorized cast + sign fill instead of a per-limb Python loop
    try:
        arr = np.array([list(r) for r in rows], dtype=np.int64) \
            if not isinstance(rows, np.ndarray) else rows.astype(np.int64)
    except (OverflowError, TypeError):
        arr = None
    if arr is not None:
        out = np.zeros((d, n, L), dtype=np.uint64)
        out[:, :, 0] = arr.astype(np.uint64)
        if L > 1:
            out[:, :, 1:] = np.where((arr < 0)[:, :, None],
                                     np.uint64(0xFFFFFFFFFFFFFFFF),
                                     np.uint64(0))
        return out
    out = np.zeros((d, n, L), dtype=np.uint64)
    mod = 1 << (64 * L)
    mask = (1 << 64) - 1
    for i in range(d):
        for j in range(n):
            v = int(rows[i][j]) % mod
            for t in range(L):
                out[i, j, t] = v & mask
                v >>= 64
                if v == 0 and rows[i][j] >= 0:
                    break
            else:
                continue
    # negative values need full sign fill, redo generically (rare path)
    for i in range(d):
        for j in range(n):
            if int(rows[i][j]) < 0:
                v = int(rows[i][j]) % mod
                for t in range(L):
                    out[i, j, t] = (v >> (64 * t)) & mask
    return out


def _limbs_to_ints(a: np.ndarray):
    """Inverse of _ints_to_limbs."""
    d, n, L = a.shape
    # fast path: upper limbs are pure sign extension of limb 0
    low = a[:, :, 0].astype(np.int64)
    if L == 1 or bool(np.all(
            a[:, :, 1:] == np.where((low < 0)[:, :, None],
                                    np.uint64(0xFFFFFFFFFFFFFFFF),
                                    np.uint64(0)))):
        return low.tolist()      # C-level int64 -> PyLong conversion
    half = 1 << (64 * L - 1)
    mod = 1 << (64 * L)
    rows = []
    for i in range(d):
        row = []
        for j in range(n):
            v = 0
            for t in range(L - 1, -1, -1):
                v = (v << 64) | int(a[i, j, t])
            if v >= half:
                v -= mod
            row.append(v)
        rows.append(row)
    return rows


def _copy_back(mat, limbs) -> None:
    rows = _limbs_to_ints(limbs)
    mat.a[:, :] = np.array(rows, dtype=object)


def native_lll_fast(b, u=None, delta: float = 0.99, eta: float = 0.51,
                    kappa_end: int = -1, size_red_only: bool = False,
                    report_changed: bool = False):
    """Run the native fast LLL on an IntMat in place.

    Returns the RED_* status, or None when the native core is
    inapplicable to this basis (caller uses the Python engine).
    Status 13 (limb overflow) also means "retry in Python".
    With report_changed=True the return is (status, basis_changed), the
    change detected on the int64 limb tensors — the BKZ loop calls this
    on mostly-already-reduced prefixes (one call per window of every
    recursion level), and an unchanged run skips the limb-to-int
    conversion and the caller's GSO resync entirely.
    """
    lib = get_lll_lib()
    d, n = b.nrows, b.ncols
    if d < 2 or d > 500 or n > 4000:
        return None
    # one vectorized int64 view serves both the limb sizing and packing
    try:
        arr = b.a.astype(np.int64)
    except (OverflowError, TypeError):
        arr = None
    if arr is not None:
        maxbits = int(np.abs(arr).max()).bit_length() if arr.size else 0
    else:
        maxbits = b.get_max_exp()
    # limb width: measured round 4 — a tighter width (+62 headroom) only
    # bought ~6% on the babai row ops but overflowed on real BKZ window
    # inputs (babai coefficients reach 2^50+ against unreduced rows), so
    # the conservative width stays; the single-entry loop keeps the
    # retry structure should the policy change
    for L in (max(2, (maxbits + 130) // 64 + 2),):
        if L > 480:
            return None
        blimbs = _ints_to_limbs(arr if arr is not None else b.a, L)
        limbs0 = blimbs.copy()
        ulimbs = None
        if u is not None:
            ulimbs = _ints_to_limbs(u.a, L)
        n_swaps = ctypes.c_long(0)
        status = lib.lll_fast(
            d, n, L, blimbs,
            ulimbs.ctypes.data_as(ctypes.c_void_p)
            if ulimbs is not None else None,
            float(delta), float(eta), int(kappa_end), int(size_red_only),
            ctypes.byref(n_swaps))
        native_lll_fast.last_n_swaps = int(n_swaps.value)
        if status == 13 and L < max(2, (maxbits + 130) // 64 + 2):
            continue    # limb overflow at the tight width: widen and redo
        if status in (0, 2, 3, 4, 13):
            # partial progress (nonzero statuses) is still valid basis
            # state; copy back so the python escalation continues from it
            changed = not bool(np.array_equal(blimbs, limbs0))
            if changed:
                _copy_back(b, blimbs)
                if u is not None and ulimbs is not None:
                    _copy_back(u, ulimbs)
            st = int(status)
            return (st, changed) if report_changed else st
        return None
    return None


# ---------------------------------------------------------------------------
# bkz_core: native BKZ window orchestration (tours, preprocessing recursion,
# rerandomization, insertion) over the limb basis + f64 GSO state, with a
# Python callback for device-sized enumerations
# ---------------------------------------------------------------------------
_BKZ_LIB = None

# int cb(G, m, mut, rdiag, prune, maxdist, sol_out, dist_out, nodes_out)
ENUM_DEV_CB = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
    ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
    ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
    ctypes.POINTER(ctypes.c_double))


class BkzArgs(ctypes.Structure):
    """Mirror of bkz_core.c's bkz_args (field order/types must match)."""

    _fields_ = [
        ("d", ctypes.c_int), ("n", ctypes.c_int), ("L", ctypes.c_int),
        ("lll_delta", ctypes.c_double), ("lll_eta", ctypes.c_double),
        ("radius_delta", ctypes.c_double),
        ("block_size", ctypes.c_int), ("flags", ctypes.c_int),
        ("gh_factor", ctypes.c_double), ("min_succ", ctypes.c_double),
        ("density", ctypes.c_int),
        ("n_strat", ctypes.c_int),
        ("pre_off", ctypes.c_void_p), ("pre_len", ctypes.c_void_p),
        ("pre_data", ctypes.c_void_p),
        ("ps_off", ctypes.c_void_p), ("ps_cnt", ctypes.c_void_p),
        ("ps_gh", ctypes.c_void_p), ("ps_exp", ctypes.c_void_p),
        ("ps_coef_off", ctypes.c_void_p), ("ps_coef_len", ctypes.c_void_p),
        ("ps_coefs", ctypes.c_void_p),
        ("hybrid_budget", ctypes.c_longlong),
        ("min_device_dim", ctypes.c_int),
        ("trial_batch_max", ctypes.c_int),
        ("seed", ctypes.c_ulonglong),
        ("min_row", ctypes.c_int), ("max_row", ctypes.c_int),
        ("nodes_out", ctypes.c_double),
        ("n_swaps_out", ctypes.c_long),
        ("clean_out", ctypes.c_int),
        ("t_enum_out", ctypes.c_double),
        ("t_dev_out", ctypes.c_double),
        ("t_lll_out", ctypes.c_double),
        ("t_misc_out", ctypes.c_double),
        ("t_babai_out", ctypes.c_double),
        ("t_move_out", ctypes.c_double),
        ("dev_nodes_out", ctypes.c_double),
        ("g_max_out", ctypes.c_int),
    ]


def _build_bkz() -> ctypes.CDLL:
    lib = ctypes.CDLL(_compile("bkz_core.c", "bkz_core.so"))
    lib.bkz_tour_native.restype = ctypes.c_int
    lib.bkz_tour_native.argtypes = [ctypes.POINTER(BkzArgs),
                                    np.ctypeslib.ndpointer(
                                        np.uint64, flags="C_CONTIGUOUS"),
                                    ENUM_DEV_CB]
    return lib


def get_bkz_lib() -> ctypes.CDLL:
    global _BKZ_LIB
    if _BKZ_LIB is None:
        _BKZ_LIB = _build_bkz()
    return _BKZ_LIB


def pack_strategies(strategies) -> dict:
    """Flatten a list of Strategy objects (indexed by block size) into the
    packed arrays bkz_core.c reads (bkz_param.h:34-66 contract)."""
    n = len(strategies)
    pre_off = np.zeros(n, dtype=np.int32)
    pre_len = np.zeros(n, dtype=np.int32)
    ps_off = np.zeros(n, dtype=np.int32)
    ps_cnt = np.zeros(n, dtype=np.int32)
    pre_data: list = []
    ps_gh: list = []
    ps_exp: list = []
    ps_coef_off: list = []
    ps_coef_len: list = []
    ps_coefs: list = []
    for bs, strat in enumerate(strategies):
        pre_off[bs] = len(pre_data)
        chain = getattr(strat, "preprocessing_block_sizes", []) or []
        pre_data.extend(int(x) for x in chain)
        pre_len[bs] = len(chain)
        ps_off[bs] = len(ps_gh)
        sets = getattr(strat, "pruning_parameters", []) or []
        for p in sets:
            ps_gh.append(float(p.gh_factor))
            ps_exp.append(float(p.expectation))
            ps_coef_off.append(len(ps_coefs))
            ps_coef_len.append(len(p.coefficients))
            ps_coefs.extend(float(c) for c in p.coefficients)
        ps_cnt[bs] = len(sets)
    return {
        "n_strat": n,
        "pre_off": pre_off, "pre_len": pre_len,
        "pre_data": np.asarray(pre_data, dtype=np.int32),
        "ps_off": ps_off, "ps_cnt": ps_cnt,
        "ps_gh": np.asarray(ps_gh, dtype=np.float64),
        "ps_exp": np.asarray(ps_exp, dtype=np.float64),
        "ps_coef_off": np.asarray(ps_coef_off, dtype=np.int64),
        "ps_coef_len": np.asarray(ps_coef_len, dtype=np.int32),
        "ps_coefs": np.asarray(ps_coefs, dtype=np.float64),
    }


def native_bkz_tour(b, pack: dict, *, lll_delta: float, lll_eta: float,
                    radius_delta: float, block_size: int, flags: int,
                    gh_factor: float, min_succ: float, density: int,
                    hybrid_budget: int, min_device_dim: int,
                    trial_batch_max: int, seed: int, min_row: int,
                    max_row: int, enum_cb):
    """Run one native BKZ tour over rows [min_row, max_row) of IntMat b.

    Returns (status, nodes, n_swaps, clean, basis_changed) or None when
    the native core is inapplicable to this basis. Nonzero status means the
    tour did not complete natively: the basis holds valid partial
    progress (every native op is unimodular) and the caller re-runs the
    tour through the Python engines from that state.
    """
    lib = get_bkz_lib()
    d, n = b.nrows, b.ncols
    if d < 2 or d > 500 or n > 4000:
        return None
    try:
        arr = b.a.astype(np.int64)
    except (OverflowError, TypeError):
        arr = None
    if arr is not None:
        maxbits = int(np.abs(arr).max()).bit_length() if arr.size else 0
    else:
        maxbits = b.get_max_exp()
    # conservative width (see native_lll_fast): a mid-tour limb overflow
    # costs a full Python re-tour, which round-4 measurement showed is
    # ~35x worse than the ~6% the tighter width saves
    L = max(2, (maxbits + 130) // 64 + 2)
    if L > 480:
        return None
    blimbs = _ints_to_limbs(arr if arr is not None else b.a, L)
    limbs0 = blimbs.copy()

    a = BkzArgs()
    a.d, a.n, a.L = d, n, L
    a.lll_delta, a.lll_eta = float(lll_delta), float(lll_eta)
    a.radius_delta = float(radius_delta)
    a.block_size, a.flags = int(block_size), int(flags)
    a.gh_factor, a.min_succ = float(gh_factor), float(min_succ)
    a.density = int(density)
    a.n_strat = int(pack["n_strat"])
    # keep array refs alive for the duration of the call
    refs = [pack[k] for k in ("pre_off", "pre_len", "pre_data", "ps_off",
                              "ps_cnt", "ps_gh", "ps_exp", "ps_coef_off",
                              "ps_coef_len", "ps_coefs")]
    (a.pre_off, a.pre_len, a.pre_data, a.ps_off, a.ps_cnt, a.ps_gh, a.ps_exp,
     a.ps_coef_off, a.ps_coef_len, a.ps_coefs) = \
        [r.ctypes.data if r.size else None for r in refs]
    a.hybrid_budget = int(hybrid_budget)
    a.min_device_dim = int(min_device_dim)
    a.trial_batch_max = int(trial_batch_max)
    a.seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    a.min_row, a.max_row = int(min_row), int(max_row)

    cb = enum_cb if enum_cb is not None else ENUM_DEV_CB(0)
    status = lib.bkz_tour_native(ctypes.byref(a), blimbs, cb)
    del refs
    changed = not bool(np.array_equal(blimbs, limbs0))
    if changed:
        _copy_back(b, blimbs)
    native_bkz_tour.last_timers = {
        "enum_s": float(a.t_enum_out), "device_s": float(a.t_dev_out),
        "lll_s": float(a.t_lll_out), "misc_s": float(a.t_misc_out),
        "babai_s": float(a.t_babai_out), "move_s": float(a.t_move_out),
        "dev_nodes": float(a.dev_nodes_out), "g_max": int(a.g_max_out)}
    return (int(status), float(a.nodes_out), int(a.n_swaps_out),
            int(a.clean_out), changed)


# ---------------------------------------------------------------------------
# pruner_core: compiled cost/probability kernels for the pruning optimizer
# ---------------------------------------------------------------------------
_PRUNER_LIB = None


def _build_pruner() -> ctypes.CDLL:
    lib = ctypes.CDLL(_compile("pruner_core.c", "pruner_core.so"))
    dptr = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.pruner_rel_vol.restype = ctypes.c_double
    lib.pruner_rel_vol.argtypes = [ctypes.c_int, dptr]
    lib.pruner_cost_evec.restype = ctypes.c_double
    lib.pruner_cost_evec.argtypes = [ctypes.c_int, dptr, dptr,
                                     ctypes.c_double, ctypes.c_double,
                                     ctypes.c_void_p]
    lib.pruner_svp_prob_evec.restype = ctypes.c_double
    lib.pruner_svp_prob_evec.argtypes = [ctypes.c_int, dptr,
                                         ctypes.c_double]
    return lib


def get_pruner_lib() -> ctypes.CDLL:
    global _PRUNER_LIB
    if _PRUNER_LIB is None:
        _PRUNER_LIB = _build_pruner()
    return _PRUNER_LIB


# ---------------------------------------------------------------------------
# fpnum: compiled dpe/dd/qd scalar tower (CPython extension, built on demand)
# ---------------------------------------------------------------------------
_FPNUM = None
_FPNUM_TRIED = False


def _build_fpnum():
    import importlib.machinery
    import importlib.util
    import sysconfig

    so_path = _compile(
        "fpnum.c", "fpnum.so",
        extra_flags=(f"-I{sysconfig.get_path('include')}",
                     f"-I{np.get_include()}"))
    loader = importlib.machinery.ExtensionFileLoader("fpnum", so_path)
    spec = importlib.util.spec_from_file_location("fpnum", so_path,
                                                  loader=loader)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def get_fpnum():
    """The compiled scalar module, or None if the toolchain is missing."""
    global _FPNUM, _FPNUM_TRIED
    if not _FPNUM_TRIED:
        _FPNUM_TRIED = True
        if os.environ.get("FPLLL_TPU_COMPILED_FP", "1") == "1":
            _FPNUM = _build_fpnum()
    return _FPNUM
