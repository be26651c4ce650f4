"""Launch wrappers of the enumeration kernel and their plain versions.

The counterpart of the JAX package's enum/pallas_kernel.py. Its four
pallas_call sites share one kernel body (`_make_chunk_kernel`); here
that body is one hand-written CUDA kernel, ``csrc/enum_chunk.cu``, built
with nvcc at first use into ``build/torch_kernels/`` and loaded with
ctypes. Two wrappers launch it:

- :func:`enum_run` — one problem, the contract of `_enum_run_pallas`
  (itself a drop-in for `tpu._enum_run`): device-level tree of height m
  over a sorted root queue, returning per-level node counts, the K best
  lanes and the solution count; it is :func:`enum_launch` (the launch,
  no read of the device) followed by :func:`enum_collect` (the
  finalize), which the multi-card mesh calls apart;
- :func:`enum_run_grouped` — G problems (rerandomized bases of one
  window) in one launch with one shared shrinking bound, the contract of
  `_enum_run_pallas_grouped`.

A wrapper given CUDA tensors launches the kernel or raises; given CPU
tensors it runs the plain PyTorch version, a vectorized port of the
lockstep step of `tpu._make_step`/`_enum_run` (SVP/CVP, count and search
mode; enum_run also in f64, with the dual recurrence and with per-level
sub-solutions), with the Pallas kernel's barren-descend lookahead in
every form that the kernel runs with it (all but the two combined forms,
dual with sub-solutions). Nothing on the card's path calls the plain
version.

Once the root queues have drained, the kernel's idle walkers take the
top-level sibling ranges of busy ones (the Pallas kernel's top-sibling
donation). Counts then equal the plain version's to the tolerance of
tests/test_pallas_parity.py, and exactly where a launch donated nothing
or the walk is exact in f32 (tests/test_torch_donation.py). The wrappers
return the walk's counters: steps, root_steps (the longest work item),
walk_steps, donations and barren_skips.

Geometry: the kernel's walkers are groups of W threads (the source's
ENUM_WIDTH, a compile-time constant) on a persistent grid that the
launcher sizes from the card's occupancy (`grid=0`), so the card sets the
number of walkers. ``batch`` is no longer a lane count on the card: it
sizes the root queue (DeviceEnumerator's target_root_factor x batch) and
is the plain version's lane count. The per-walker outputs hold one slot
per (problem, walker), sized from the geometry the launcher reports.

Instances: "single" and "grouped" launch ``enum_chunk_kernel`` (f32
primal), "f64" ``enum_chunk_f64_kernel`` (f64 primal), "f32-dual" and
"f64-dual" ``enum_chunk_dual_kernel``, "f32-subsols" and "f64-subsols"
``enum_chunk_subsols_kernel`` of their element type, each with the
lookahead; the combined forms ("f32-dual-subsols", "f64-dual-subsols",
which no path of the port launches) ``enum_chunk_ext_kernel``, the
extended walk without it. :func:`_enum_run_extended` runs any tree of
enum_run on the extended instance instead, for the comparison of the two
designs; no path of the port calls it.

Counts: ``LAUNCHES`` counts kernel launches per form (``FORMS``) and
nothing else, ``PLAIN_RUNS`` the wrappers' runs of the plain version,
``GRIDS`` the launch geometries (grid, blocks per SM, SMs) per form,
``EXTENDED`` the comparison's launches and plain runs per form; node
counters are int64 (uint64 in the kernel), never f32.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Set, Tuple

from .. import cuda_build
from ..torchsetup import torch

__all__ = ["enum_run", "enum_launch", "enum_collect", "enum_run_grouped",
           "enum_run_plain", "enum_run_grouped_plain", "build_kernel",
           "LAUNCHES", "PLAIN_RUNS", "reset_launch_counts", "MAX_LEVELS",
           "GRIDS", "FORMS"]

MAX_LEVELS = 128          # ENUM_MAXM of the CUDA source
_K_TOP = 128              # walkers kept by the finalize (tpu._enum_run)

# the forms a wrapper launches: "single" (enum_run, f32 primal),
# "grouped" (enum_run_grouped) and enum_run's extended walks, named by
# element type and walk (see _form)
FORMS = ("single", "grouped", "f64", "f32-dual", "f64-dual", "f32-subsols",
         "f64-subsols", "f32-dual-subsols", "f64-dual-subsols")
LAUNCHES: Dict[str, int] = {form: 0 for form in FORMS}
# runs of the plain version through the wrappers (CPU tensors)
PLAIN_RUNS: Dict[str, int] = {form: 0 for form in FORMS}
# (grid, blocks per SM, SMs) of each launch geometry used, per form
GRIDS: Dict[str, Set[Tuple[int, int, int]]] = {form: set() for form in FORMS}
# trees sent to the extended instance by name (_enum_run_extended): its
# launches, and runs of its plain version (the walk without the
# lookahead), per form
EXTENDED: Dict[str, Dict[str, int]] = {
    "launches": {form: 0 for form in FORMS},
    "plain_runs": {form: 0 for form in FORMS}}
# the walks of the CUDA source (EnumWalk in csrc/enum_chunk.cu)
WALK_PRIMAL, WALK_DUAL, WALK_SUBSOLS, WALK_EXT = 0, 1, 2, 3


def _form(dtype, dual: bool, findsubsols: bool) -> str:
    """The LAUNCHES key of one enum_run call."""
    if dtype == torch.float32 and not dual and not findsubsols:
        return "single"
    return ("f64" if dtype == torch.float64 else "f32") + \
        ("-dual" if dual else "") + ("-subsols" if findsubsols else "")


def _walk(dual: bool, findsubsols: bool, ext: bool = False) -> int:
    """The walk a launch runs (enum_walk_of in the CUDA source): the
    extended one where the caller names it or where the tree is dual with
    sub-solutions."""
    if ext or (dual and findsubsols):
        return WALK_EXT
    return WALK_DUAL if dual else WALK_SUBSOLS if findsubsols else \
        WALK_PRIMAL


def reset_launch_counts() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0
        PLAIN_RUNS[key] = 0
        GRIDS[key].clear()
    for counts in EXTENDED.values():
        for key in counts:
            counts[key] = 0


# ---------------------------------------------------------------------------
# CUDA build and binding (plain C interface, ctypes)
# ---------------------------------------------------------------------------
class _EnumParams(ctypes.Structure):
    """Mirror of EnumParams in csrc/enum_chunk.cu (order and types)."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "mut", "rdiag", "prune", "mut_fix", "cp0", "roots_x", "roots_a",
        "roots_pd", "A0", "m_real", "cursor", "bound", "bdist", "bdev", "bri",
        "nodes", "sols", "steps", "root_steps", "walk_steps", "donations",
        "barren_skips", "aborted", "queue", "busy", "mailbox", "mail",
        "ss_dist", "ss_vec", "ss_root", "ss_lock")] + \
        [("max_steps", ctypes.c_longlong)] + \
        [(name, ctypes.c_int) for name in (
            "G", "G_real", "m", "nfixp", "R", "walkers", "is_svp",
            "count_mode", "dbl", "dual", "findsubsols", "ext")]


class _EnumGeometry(ctypes.Structure):
    """Mirror of EnumGeometry in csrc/enum_chunk.cu."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "grid", "threads", "width", "M", "blocks_per_sm", "sms", "smem",
        "walkers")]


_LIB: Optional[ctypes.CDLL] = None
BUILD_LOG = ""
_nvcc = cuda_build.nvcc


def build_kernel() -> ctypes.CDLL:
    """Compile csrc/enum_chunk.cu for sm_90a (once per source change, by
    cuda_build.build) and load it; BUILD_LOG holds the compiler's output
    (`-Xptxas -v`), kept beside the library for later processes. Raises on
    a missing toolkit or a failed build."""
    global _LIB, BUILD_LOG
    if _LIB is not None:
        return _LIB
    lib, BUILD_LOG = cuda_build.build("enum_chunk")
    _LIB = _bind(lib)
    return _LIB


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The C entry points' argument and result types on a build of
    csrc/enum_chunk.cu."""
    lib.enum_chunk_geometry.restype = ctypes.c_int
    lib.enum_chunk_geometry.argtypes = [ctypes.c_int] * 5 + [
        ctypes.POINTER(_EnumGeometry)]
    lib.enum_chunk_launch.restype = ctypes.c_int
    lib.enum_chunk_launch.argtypes = [ctypes.POINTER(_EnumParams),
                                      ctypes.c_int, ctypes.c_void_p]
    lib.enum_chunk_error_string.restype = ctypes.c_char_p
    lib.enum_chunk_error_string.argtypes = [ctypes.c_int]
    return lib


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or \
            t.device != device or not t.is_contiguous():
        raise ValueError(f"{name}: expected contiguous {dtype} {tuple(shape)} "
                         f"on {device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")


def _prepare(mut, rdiag, prune, mut_fix, cp0, roots_x, roots_pd, A0, m_real,
             *, G_real: int, walkers: int, is_svp: bool, count_mode: bool,
             max_steps: int, roots_a=None, dual: bool = False,
             findsubsols: bool = False, m_real_range=None,
             ext: bool = False):
    """Check the stacked inputs of G problems (float32 or float64, all
    alike), allocate the outputs (one slot per problem and walker, and
    the per-level sub-solution records) on their device and fill the
    kernel's parameter struct. `m_real_range` (least, largest m_real),
    when the caller knows it, spares the read of m_real from the
    device. `ext` runs the extended instance with dual and findsubsols
    as given."""
    G, m, _ = mut.shape
    R, nfixp = roots_x.shape[1], roots_x.shape[2]
    dev, ft = mut.device, mut.dtype
    i32 = torch.int32
    if ft not in (torch.float32, torch.float64):
        raise ValueError(f"mut: float32 or float64, got {ft}")
    if roots_a is None:
        roots_a = roots_x
    for t, name, shape in ((mut, "mut", (G, m, m)), (rdiag, "rdiag", (G, m)),
                           (prune, "prune", (G, m)),
                           (mut_fix, "mut_fix", (G, m, nfixp)),
                           (cp0, "cp0", (G, m)),
                           (roots_x, "roots_x", (G, R, nfixp)),
                           (roots_a, "roots_a", (G, R, nfixp)),
                           (roots_pd, "roots_pd", (G, R)), (A0, "A0", (G,))):
        _check(t, name, ft, shape, dev)
    _check(m_real, "m_real", i32, (G,), dev)
    if not 2 <= m <= MAX_LEVELS:
        raise ValueError(f"tree height {m} outside [2, {MAX_LEVELS}]")
    if m_real_range is None:
        mr = m_real.cpu()
        m_real_range = (int(mr.min()), int(mr.max()))
    if m_real_range[0] < 2 or m_real_range[1] > m:
        raise ValueError("m_real must lie in [2, m]")
    if not 1 <= G_real <= G or walkers < 1:
        raise ValueError(f"G_real {G_real} of G {G}, {walkers} walkers")
    GW = G * walkers
    out = {
        "cursor": torch.zeros(G, dtype=i32, device=dev),
        "bound": torch.full((1,), float("inf"), dtype=ft, device=dev),
        "bdist": torch.full((GW,), float("inf"), dtype=ft, device=dev),
        "bdev": torch.zeros((GW, m), dtype=ft, device=dev),
        "bri": torch.zeros(GW, dtype=i32, device=dev),
        "nodes": torch.zeros((G, m), dtype=torch.int64, device=dev),
        "sols": torch.zeros(G, dtype=torch.int64, device=dev),
        "steps": torch.zeros(1, dtype=torch.int64, device=dev),
        "root_steps": torch.zeros(1, dtype=torch.int64, device=dev),
        "walk_steps": torch.zeros(1, dtype=torch.int64, device=dev),
        "donations": torch.zeros(1, dtype=torch.int64, device=dev),
        "barren_skips": torch.zeros(1, dtype=torch.int64, device=dev),
        "aborted": torch.zeros(1, dtype=i32, device=dev),
        # the donation's requests, busy count and mailboxes: each mailbox's
        # sequence word starts at its index, its values are written before
        # they are read
        "queue": torch.zeros(1, dtype=torch.int64, device=dev),
        "busy": torch.zeros(1, dtype=i32, device=dev),
        "mailbox": torch.stack([torch.arange(walkers, dtype=i32, device=dev)]
                               + [torch.zeros(walkers, dtype=i32,
                                              device=dev)] * 3, dim=1),
        "mail": torch.empty((walkers, 2 * m + 1), dtype=ft, device=dev),
    }
    if findsubsols:
        # the records start at r_kk (evaluator.h:36-56); root -1: none
        out.update(ss_dist=rdiag.clone(),
                   ss_vec=torch.zeros((G, m, m), dtype=ft, device=dev),
                   ss_root=torch.full((G, m), -1, dtype=i32, device=dev),
                   ss_lock=torch.zeros((G, m), dtype=i32, device=dev))
    p = _EnumParams()
    for name, t in (("mut", mut), ("rdiag", rdiag), ("prune", prune),
                    ("mut_fix", mut_fix), ("cp0", cp0),
                    ("roots_x", roots_x), ("roots_a", roots_a),
                    ("roots_pd", roots_pd), ("A0", A0), ("m_real", m_real)):
        setattr(p, name, t.data_ptr())
    for name in ("cursor", "bound", "bdist", "bdev", "bri", "nodes", "sols",
                 "steps", "root_steps", "walk_steps", "donations",
                 "barren_skips", "aborted", "queue", "busy", "mailbox",
                 "mail", "ss_dist", "ss_vec", "ss_root", "ss_lock"):
        if name in out:
            setattr(p, name, out[name].data_ptr())
    p.max_steps = int(max_steps)
    p.G, p.G_real, p.m, p.nfixp, p.R = G, G_real, m, nfixp, R
    p.walkers = walkers
    p.is_svp, p.count_mode = int(is_svp), int(count_mode)
    p.dbl = int(ft == torch.float64)
    p.dual, p.findsubsols = int(dual), int(findsubsols)
    p.ext = int(ext)
    return p, out


def _raise(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"enum_chunk {what} failed: " +
                           lib.enum_chunk_error_string(rc).decode())


def _geometry(m: int, G_real: int, dtype, walk: int, grid: int = 0) -> dict:
    """The launcher's geometry for (m, G_real, element type, walk, grid)
    on the current CUDA device: grid 0 asks for blocks per SM times SMs
    (the persistent grid); it also gives threads per block, the walker
    width W, the height bucket M, blocks per SM, SMs, dynamic shared
    memory and walkers (grid * threads / W). `walk`: WALK_PRIMAL,
    WALK_DUAL, WALK_SUBSOLS or WALK_EXT (the extended instance), as
    _walk gives it."""
    lib = build_kernel()
    g = _EnumGeometry()
    _raise(lib, lib.enum_chunk_geometry(
        m, G_real, int(dtype == torch.float64), walk, grid,
        ctypes.byref(g)), "geometry")
    return {name: getattr(g, name) for name, _ in _EnumGeometry._fields_}


def _kernel_run(*args, G_real: int, grid: int, **kw) -> dict:
    """One launch over G stacked problems on the current CUDA stream, at
    the launcher's geometry (_geometry), whose walkers size the outputs.
    Returns the raw per-walker and per-problem outputs (on the card) and
    the geometry."""
    dev = args[0].device
    lib = build_kernel()
    with torch.cuda.device(dev):
        walk = _walk(kw.get("dual", False), kw.get("findsubsols", False),
                     kw.get("ext", False))
        geo = _geometry(args[0].shape[-1], G_real, args[0].dtype, walk, grid)
        p, out = _prepare(*args, G_real=G_real, walkers=geo["walkers"], **kw)
        stream = torch.cuda.current_stream(dev).cuda_stream
        _raise(lib, lib.enum_chunk_launch(ctypes.byref(p), geo["grid"],
                                          stream), "launch")
    out["geometry"] = geo
    return out


def _raise_if_aborted(out: dict, max_steps: int) -> None:
    if int(out["aborted"].item()):
        raise RuntimeError(f"enum_chunk: a walker walked more than "
                           f"{max_steps} nodes; raise max_steps")


def _walk_counters(out: dict) -> dict:
    """The walk's counters of one launch: steps (the longest walk of a
    walker), root_steps (the longest walk of one work item, a root or a
    donated sibling range), walk_steps (every walker's iterations, so
    that the walkers' busy share is walk_steps / (walkers x steps)),
    donations and barren_skips."""
    return {k: out[k][0] for k in ("steps", "root_steps", "walk_steps",
                                   "donations", "barren_skips")}


def _finalize_single(out: dict, roots_x, A0: float, *, count_mode: bool,
                     walkers: int, max_steps: int) -> dict:
    """The K = min(walkers, 128) best walkers and the problem's totals
    (the top-K finalize the JAX package ran as XLA after its Pallas
    call), and the sub-solution records with their roots' coordinates
    (zero where a level kept its initial record)."""
    _raise_if_aborted(out, max_steps)
    R, nfix = roots_x.shape
    K = min(walkers, _K_TOP)
    negd, idx = torch.topk(-out["bdist"], K)
    bound = torch.clamp(out["bound"][0], max=float(A0))
    res = {
        "nodes": out["nodes"][0],
        "best_dist": -negd,
        "best_dev": out["bdev"][idx],
        "best_root": roots_x[out["bri"][idx].long()],
        "sol_count": out["sols"][0],
        "A": float(A0) if count_mode else bound,
        "cursor": torch.clamp(out["cursor"][0], max=R),
        **_walk_counters(out),
        "geometry": out.get("geometry"),
    }
    if "ss_dist" in out:
        ri = out["ss_root"][0].long()
        res["subsol_dist"] = out["ss_dist"][0]
        res["subsol_vec"] = out["ss_vec"][0]
        res["subsol_root"] = torch.where(
            (ri >= 0)[:, None], roots_x[torch.clamp(ri, min=0)],
            torch.zeros((), dtype=roots_x.dtype, device=roots_x.device))
    return res


def _finalize_grouped(out: dict, roots_x, A0, *, walkers: int,
                      max_steps: int) -> dict:
    """Each problem's best walker, unpacked with its root."""
    _raise_if_aborted(out, max_steps)
    G = roots_x.shape[0]
    ar = torch.arange(G, device=roots_x.device)
    bd = out["bdist"].view(G, walkers)
    lane = torch.argmin(bd, dim=1)
    cols = ar * walkers + lane
    return {
        "dist": bd[ar, lane],
        "dev": out["bdev"][cols],
        "root": roots_x[ar, out["bri"][cols].long()],
        "nodes": out["nodes"].sum(dim=0),
        "A": torch.clamp(A0, max=out["bound"][0]),
        "bound": out["bound"][0],
        **_walk_counters(out),
        "geometry": out.get("geometry"),
    }


# ---------------------------------------------------------------------------
# public wrappers
# ---------------------------------------------------------------------------
def enum_run(mut, rdiag, prune, mut_fix, cp0, roots_x, roots_pd, A0: float,
             *, m: int, is_svp: bool, count_mode: bool,
             max_steps: int = 1 << 30, batch: int = 1024,
             m_real: Optional[int] = None, grid: int = 0, roots_a=None,
             dual: bool = False, findsubsols: bool = False) -> dict:
    """Enumerate one problem (the `_enum_run_pallas` contract, and the
    `tpu._enum_run` contract of its f64, dual and sub-solution trees).

    mut (m, m) is the transposed mu (mut = mu^T); rdiag/prune/cp0
    are (m,); mut_fix (m, nfix) couples device levels to the nfix fixed
    levels; roots_x (R, nfix) and roots_pd (R,) are the subtree roots,
    sorted by pd, padded with inf or 1e30. Levels m_real..m-1 are bucket
    padding (rdiag 1e30 in f32, 1e300 in f64). All tensors float32, or
    all float64, on one device: CUDA launches the kernel, CPU runs the
    plain version. `roots_a` (R, nfix), what each root feeds the center
    sums (alpha under `dual`, the dual recurrence; None: roots_x);
    `findsubsols` adds the per-level best partials subsol_dist (m,),
    subsol_vec (m, m) and subsol_root (m, nfix). Returns nodes (m,)
    int64, best_dist (K,), best_dev (K, m), best_root (K, nfix),
    sol_count, A, cursor, steps (the lockstep steps of the plain
    version; the longest walker walk of the kernel) and barren_skips;
    the kernel also returns root_steps (the longest walk of one work
    item, a root or a donated sibling range), walk_steps, donations and
    its geometry.

    `batch` is the plain version's lane count (the caller also sized the
    root queue from it); on the card the launch geometry sets the
    walkers: `grid` blocks (0: the persistent grid from occupancy) of
    walkers ENUM_WIDTH threads wide. K is min(batch, 128) on the CPU and
    min(walkers, 128) on the card.

    The composition of :func:`enum_launch` and :func:`enum_collect`."""
    return enum_collect(enum_launch(
        mut, rdiag, prune, mut_fix, cp0, roots_x, roots_pd, A0, m=m,
        is_svp=is_svp, count_mode=count_mode, max_steps=max_steps,
        batch=batch, m_real=m_real, grid=grid, roots_a=roots_a, dual=dual,
        findsubsols=findsubsols))


def enum_launch(mut, rdiag, prune, mut_fix, cp0, roots_x, roots_pd,
                A0: float, *, m: int, is_svp: bool, count_mode: bool,
                max_steps: int = 1 << 30, batch: int = 1024,
                m_real: Optional[int] = None, grid: int = 0, roots_a=None,
                dual: bool = False, findsubsols: bool = False) -> dict:
    """The first half of :func:`enum_run`, with its arguments. On CUDA
    tensors it launches the kernel on the current stream, with outputs
    allocated there, and returns without reading the device, so that a
    caller can launch on several streams or cards before it waits for
    any; on CPU tensors it runs the plain version. Pass what it returns
    to :func:`enum_collect` under the same device and stream."""
    return _launch(mut, rdiag, prune, mut_fix, cp0, roots_x, roots_pd, A0,
                   m=m, is_svp=is_svp, count_mode=count_mode,
                   max_steps=max_steps, batch=batch, m_real=m_real, grid=grid,
                   roots_a=roots_a, dual=dual, findsubsols=findsubsols,
                   ext=False)


def _enum_run_extended(mut, rdiag, prune, mut_fix, cp0, roots_x, roots_pd,
                       A0: float, *, dual: bool = False,
                       findsubsols: bool = False, **kw) -> dict:
    """:func:`enum_run` of any tree on the extended instance
    (enum_chunk_ext_kernel of its element type, dual and findsubsols as
    given: no lookahead, one block per SM at M = 64 in f64); on CPU
    tensors, the plain walk without the lookahead. For the comparison of
    the extended instance with the instance of the form (chip_smoke.py,
    the tests); no path of the port calls it, and it counts in EXTENDED,
    not in LAUNCHES."""
    kw = dict(dict(max_steps=1 << 30, batch=1024, m_real=None, grid=0,
                   roots_a=None), **kw)
    return enum_collect(_launch(mut, rdiag, prune, mut_fix, cp0, roots_x,
                                roots_pd, A0, dual=dual,
                                findsubsols=findsubsols, ext=True, **kw))


def _launch(mut, rdiag, prune, mut_fix, cp0, roots_x, roots_pd, A0: float,
            *, m: int, is_svp: bool, count_mode: bool, max_steps: int,
            batch: int, m_real: Optional[int], grid: int, roots_a,
            dual: bool, findsubsols: bool, ext: bool) -> dict:
    """enum_launch on the instance of its form, or on the extended
    instance (`ext`, counted in EXTENDED)."""
    dev = mut.device
    form = _form(mut.dtype, dual, findsubsols)
    if dev.type == "cpu":
        if ext:
            EXTENDED["plain_runs"][form] += 1
        else:
            PLAIN_RUNS[form] += 1
        return {"result": enum_run_plain(
            mut, rdiag, prune, mut_fix, cp0, roots_x, roots_pd, A0, m=m,
            is_svp=is_svp, count_mode=count_mode, max_steps=max_steps,
            batch=batch, roots_a=roots_a, dual=dual,
            findsubsols=findsubsols, extended=ext)}
    if dev.type != "cuda":
        raise ValueError(f"enum_run: unsupported device {dev}")
    mr = m if m_real is None else int(m_real)
    out = _kernel_run(
        mut[None], rdiag[None], prune[None], mut_fix[None], cp0[None],
        roots_x[None], roots_pd[None],
        torch.full((1,), float(A0), dtype=mut.dtype, device=dev),
        torch.full((1,), mr, dtype=torch.int32, device=dev),
        G_real=1, grid=grid, is_svp=is_svp,
        count_mode=count_mode, max_steps=max_steps,
        roots_a=None if roots_a is None else roots_a[None], dual=dual,
        findsubsols=findsubsols, m_real_range=(mr, mr), ext=ext)
    if ext:
        EXTENDED["launches"][form] += 1
    else:
        LAUNCHES[form] += 1
        geo = out["geometry"]
        GRIDS[form].add((geo["grid"], geo["blocks_per_sm"], geo["sms"]))
    return {"raw": out, "roots_x": roots_x, "A0": A0,
            "count_mode": count_mode, "max_steps": max_steps}


def enum_collect(launched: dict) -> dict:
    """The second half of :func:`enum_run`: the top-K finalize of a
    launch, which waits for the kernel (it reads the abort flag), or the
    plain version's result."""
    if "result" in launched:
        return launched["result"]
    out = launched["raw"]
    return _finalize_single(out, launched["roots_x"], launched["A0"],
                            count_mode=launched["count_mode"],
                            walkers=out["geometry"]["walkers"],
                            max_steps=launched["max_steps"])


def enum_run_grouped(mut, rdiag, prune, mut_fix, cp0, roots_x, roots_pd, A0,
                     m_real, *, G_real: int, batch: int = 1024,
                     is_svp: bool = True, max_steps: int = 1 << 30,
                     grid: int = 0) -> dict:
    """Enumerate G problems in one launch with one shared shrinking bound
    (the `_enum_run_pallas_grouped` contract, search mode).

    The G problems must be rerandomized bases of the same lattice block:
    a solution any of the first G_real problems finds bounds all of them.
    Problems G_real..G-1 are padding (A0 = 0) and never write the bound.
    Inputs are the per-problem arrays of :func:`enum_run` stacked on a
    leading G axis, with m_real (G,) int32. Returns dist (G,), dev (G, m),
    root (G, nfixp), nodes (m,) int64, A (G,), bound (the shared bound
    after the launch: the least distance a real problem found, inf if
    none), steps and, on the card, root_steps and the geometry. On the CPU
    the problems run one after another, carrying the shared bound the way
    the TPU grid carried it across cells, over `batch` lanes each; on the
    card `grid` sets the walkers as in :func:`enum_run`, and a
    walker whose problem's queue has drained moves on to another real
    problem (padding problems are never scheduled)."""
    dev = mut.device
    if dev.type == "cpu":
        PLAIN_RUNS["grouped"] += 1
        return enum_run_grouped_plain(mut, rdiag, prune, mut_fix, cp0,
                                       roots_x, roots_pd, A0, G_real=G_real,
                                       batch=batch, is_svp=is_svp,
                                       max_steps=max_steps)
    if dev.type != "cuda":
        raise ValueError(f"enum_run_grouped: unsupported device {dev}")
    out = _kernel_run(mut, rdiag, prune, mut_fix, cp0, roots_x, roots_pd,
                      A0, m_real, G_real=G_real, grid=grid,
                      is_svp=is_svp, count_mode=False, max_steps=max_steps)
    LAUNCHES["grouped"] += 1
    geo = out["geometry"]
    GRIDS["grouped"].add((geo["grid"], geo["blocks_per_sm"], geo["sms"]))
    return _finalize_grouped(out, roots_x, A0, walkers=geo["walkers"],
                             max_steps=max_steps)


# ---------------------------------------------------------------------------
# plain PyTorch versions (CPU tensors)
# ---------------------------------------------------------------------------
def _cround(x: torch.Tensor) -> torch.Tensor:
    """C round(): halves away from zero (the JAX package's _cround)."""
    half = torch.where(x >= 0, torch.tensor(0.5, dtype=x.dtype),
                       torch.tensor(-0.5, dtype=x.dtype))
    return torch.trunc(x + half)


def enum_run_plain(mut, rdiag, prune, mut_fix, cp0, roots_x, roots_pd, A0,
                    *, m: int, is_svp: bool, count_mode: bool,
                    max_steps: int, batch: int, roots_a=None,
                    dual: bool = False, findsubsols: bool = False,
                    extended: bool = False) -> dict:
    """Lockstep DFS over B lanes with a root work queue: the port of
    `tpu._make_step`/`_enum_run`, in the dtype of the inputs (float32 or
    float64). Per step every active lane does one bound test; passing
    lanes descend (subtracting x*mu, or alpha*mu for `dual`, from the
    center partial sums of the levels below), failing lanes ascend
    (restoring them) and step to the next zig-zag sibling. Finished lanes
    pop the next roots in order. `roots_a` (R, nfix) are the values a
    fresh root feeds the center sums (alpha for dual; None: roots_x);
    `roots_x` are the reported coordinates. `findsubsols` also returns
    the per-level best partials: subsol_dist (m,), subsol_vec (m, m) and
    subsol_root (m, nfix). Every form skips barren descends
    (barren_skips: how many), as the kernel's instance of that form
    does, but the combined forms (dual with sub-solutions), whose
    instance is the extended one; `extended` walks any tree without the
    lookahead, as the extended instance does."""
    dev, ft = mut.device, mut.dtype
    B, R, nfix = batch, roots_x.shape[0], roots_x.shape[1]
    if R == 0:
        raise ValueError("enum_run: empty root queue")
    if roots_a is None:
        roots_a = roots_x
    mut_t = mut.t().contiguous()            # mut_t[k, j] = mut[j, k]
    cols = torch.arange(m, device=dev)
    pd_cols = torch.arange(m + 1, device=dev)
    one = torch.tensor(1.0, dtype=ft, device=dev)
    zero = torch.tensor(0.0, dtype=ft, device=dev)
    inf = torch.tensor(float("inf"), dtype=ft, device=dev)
    top = m - 1

    def make_fresh(ra, rpd):
        """Lane state from root rows: cs = cp0 - sum_f ra_f * mut_fix_f,
        summed in f order, as the kernel sums it."""
        acc = torch.zeros((B, m), dtype=ft, device=dev)
        for f in range(nfix):
            acc = acc + ra[:, f:f + 1] * mut_fix[:, f][None, :]
        cs = cp0[None, :] - acc
        c0 = cs[:, top]
        x0 = _cround(c0)
        if is_svp:
            x0 = torch.where(rpd == 0, torch.clamp(x0, min=0.0), x0)
        d0 = torch.where(c0 >= x0, one, -one)
        x = torch.zeros((B, m), dtype=ft, device=dev)
        x[:, top] = x0
        dx = torch.ones((B, m), dtype=ft, device=dev)
        dx[:, top] = d0
        ddx = dx.clone()
        center = torch.zeros((B, m), dtype=ft, device=dev)
        center[:, top] = c0
        partdist = torch.zeros((B, m + 1), dtype=ft, device=dev)
        partdist[:, top] = rpd
        return x, dx, ddx, center, partdist, cs

    idx0 = torch.arange(B, device=dev)
    take = torch.clamp(idx0, 0, R - 1)
    rx0, ra0, rpd0 = roots_x[take], roots_a[take], roots_pd[take]
    A = torch.tensor(float(A0), dtype=ft, device=dev)
    active = (idx0 < R) & torch.isfinite(rpd0) & (rpd0 <= A)
    x, dx, ddx, center, partdist, cs = make_fresh(
        ra0, torch.where(active, rpd0, zero))
    k = torch.full((B,), top, dtype=torch.int64, device=dev)
    lane_root = rx0.clone()
    best_dist = torch.full((B,), float("inf"), dtype=ft, device=dev)
    best_dev = torch.zeros((B, m), dtype=ft, device=dev)
    best_root = torch.zeros((B, nfix), dtype=ft, device=dev)
    sol_count = torch.zeros(B, dtype=torch.int64, device=dev)
    nodes = torch.zeros(m, dtype=torch.int64, device=dev)
    if findsubsols:
        # the reference's initial records: r_kk (evaluator.h:36-56)
        subsol_dist = rdiag.clone()
        subsol_vec = torch.zeros((m, m), dtype=ft, device=dev)
        subsol_root = torch.zeros((m, nfix), dtype=ft, device=dev)
        upper = cols[None, :] >= cols[:, None]      # row = level
    cursor = torch.tensor(B, dtype=torch.int64, device=dev)
    cursor_host = B
    check_every = 1 if dev.type == "cpu" else 32
    steps = 0
    barren_skips = torch.zeros((), dtype=torch.int64, device=dev)
    # every form but the combined ones runs the Pallas kernel's
    # barren-descend lookahead, as the CUDA kernel's instance of that form
    # does (the combined forms run on the extended instance, which has
    # none). A barren node's sibling step takes the next lockstep step,
    # the one its failing child's test would have taken, so that the
    # steps at which a search's bound falls stay those of the walk
    # without it (tpu._enum_run's): a lane marked `pending` tests nothing
    # in that step, it only moves to the sibling
    lookahead = not extended and not (dual and findsubsols)
    pending = torch.zeros(B, dtype=torch.bool, device=dev)

    while steps < max_steps:
        if steps % check_every == 0:
            cursor_host = int(cursor)
            if not (bool(active.any()) or cursor_host < R):
                break
        steps += 1
        # ---- one lockstep step (tpu._make_step) -------------------------
        kc = torch.clamp(k, 0, top)
        at = kc[:, None]
        xk = x.gather(1, at)[:, 0]
        ck = center.gather(1, at)[:, 0]
        pdk = partdist.gather(1, at)[:, 0]
        rk, prk = rdiag[kc], prune[kc]
        alpha = xk - ck
        newdist = pdk + alpha * alpha * rk
        tested = active & ~pending
        ok = tested & (newdist <= prk * A)
        at_bottom = kc == 0
        nontrivial = newdist > 0 if is_svp else torch.ones_like(ok)
        sol_found = ok & at_bottom & nontrivial
        better = sol_found & (newdist < best_dist)
        best_dist = torch.where(better, newdist, best_dist)
        best_dev = torch.where(better[:, None], x, best_dev)
        best_root = torch.where(better[:, None], lane_root, best_root)
        sol_count = sol_count + sol_found.long()
        if not count_mode:
            A = torch.minimum(A, torch.where(sol_found, newdist, inf).min())
        nodes.index_add_(0, kc, ok.long())
        if findsubsols:
            # per level, the lane with the smallest passing nonzero
            # distance this step (x before the update), merged into the
            # records where strictly smaller
            improving = ok & (newdist > 0)
            cand = torch.where((cols[None, :] == at) & improving[:, None],
                               newdist[:, None], inf)
            ss_dist = cand.min(dim=0).values
            ss_lane = cand.argmin(dim=0)
            upd = ss_dist < subsol_dist
            subsol_dist = torch.where(upd, ss_dist, subsol_dist)
            subsol_vec = torch.where(upd[:, None],
                                     torch.where(upper, x[ss_lane], zero),
                                     subsol_vec)
            subsol_root = torch.where(upd[:, None], lane_root[ss_lane],
                                      subsol_root)

        descend = ok & ~at_bottom
        wk = alpha if dual else xk
        barren = torch.zeros_like(ok)
        if lookahead:
            # the barren-descend lookahead (pallas_kernel.py:349-366): a
            # passing node above level 1 whose nearest child already fails
            # the child's bound steps to its next sibling instead of
            # descending, skipping the descend's subtract and the ascend's
            # restore (the kernel's level 1 absorbs level 0 instead). The
            # child's center is what the descend would give it: w_k (x_k,
            # or alpha_k under dual) times mu[k][k-1] subtracted
            kdn = torch.clamp(kc - 1, min=0)
            c_child = cs.gather(1, kdn[:, None])[:, 0] - wk * mut_t[kc, kdn]
            x_first = _cround(c_child)
            if is_svp:
                x_first = torch.where(newdist == 0,
                                      torch.clamp(x_first, min=0.0), x_first)
            a_dn = x_first - c_child
            barren = descend & (kc >= 2) & (
                newdist + a_dn * a_dn * rdiag[kdn] > prune[kdn] * A)
            descend = descend & ~barren
            barren_skips = barren_skips + barren.sum()
        below_k = cols[None, :] < kc[:, None]
        cs = cs - torch.where(descend[:, None] & below_k,
                              wk[:, None] * mut_t[kc], zero)
        k_down = kc - 1
        c_new = cs.gather(1, torch.clamp(k_down, min=0)[:, None])[:, 0]
        x_new = _cround(c_new)
        d_init = torch.where(c_new >= x_new, one, -one)
        sel_down = descend[:, None] & (cols[None, :] == k_down[:, None])
        center = torch.where(sel_down, c_new[:, None], center)
        x = torch.where(sel_down, x_new[:, None], x)
        dx = torch.where(sel_down, d_init[:, None], dx)
        ddx = torch.where(sel_down, d_init[:, None], ddx)
        partdist = torch.where(
            descend[:, None] & (pd_cols[None, :] == k_down[:, None]),
            newdist[:, None], partdist)

        fail = tested & ~ok
        sib = (ok & at_bottom) | fail | pending
        pending = barren
        k_sib = torch.where(fail, kc + 1, kc)
        lane_done = fail & (k_sib >= m)
        do_sib = sib & ~lane_done
        ks = torch.clamp(k_sib, 0, top)
        atk = ks[:, None]
        asc = do_sib & fail
        xs = x.gather(1, atk)[:, 0]
        # dual: restore the alpha subtracted at descend time (the center
        # of level ks is unchanged since then)
        ws = xs - center.gather(1, atk)[:, 0] if dual else xs
        cs = cs + torch.where(asc[:, None] & (cols[None, :] < atk),
                              ws[:, None] * mut_t[ks], zero)
        pds = partdist.gather(1, atk)[:, 0]
        dxs = dx.gather(1, atk)[:, 0]
        ddxs = ddx.gather(1, atk)[:, 0]
        zero_pd = (pds == 0) & is_svp
        x_adv = torch.where(zero_pd, xs + 1, xs + dxs)
        ddx_adv = torch.where(zero_pd, ddxs, -ddxs)
        dx_adv = torch.where(zero_pd, dxs, ddx_adv - dxs)
        sel_s = do_sib[:, None] & (cols[None, :] == atk)
        x = torch.where(sel_s, x_adv[:, None], x)
        dx = torch.where(sel_s, dx_adv[:, None], dx)
        ddx = torch.where(sel_s, ddx_adv[:, None], ddx)
        k = torch.where(descend, k_down, torch.where(do_sib, k_sib, k))
        active = active & ~lane_done

        # ---- refill finished lanes from the root queue ------------------
        if cursor_host < R:
            needv = ~active
            rank = torch.cumsum(needv.long(), 0) - 1
            ridx = cursor + rank
            can = needv & (ridx < R)
            ridx_c = torch.clamp(ridx, 0, R - 1)
            rx, ra, rpd = roots_x[ridx_c], roots_a[ridx_c], roots_pd[ridx_c]
            live = can & torch.isfinite(rpd) & (rpd <= A)
            fx, fdx, fddx, fcenter, fpartdist, fcs = make_fresh(
                ra, torch.where(live, rpd, zero))
            sel = can[:, None]
            x = torch.where(sel, fx, x)
            dx = torch.where(sel, fdx, dx)
            ddx = torch.where(sel, fddx, ddx)
            center = torch.where(sel, fcenter, center)
            cs = torch.where(sel, fcs, cs)
            partdist = torch.where(sel, fpartdist, partdist)
            k = torch.where(can, torch.full_like(k, top), k)
            active = torch.where(can, live, active)
            lane_root = torch.where(sel, rx, lane_root)
            cursor = torch.clamp(cursor + needv.long().sum(), max=R)

    K = min(B, _K_TOP)
    negd, idx = torch.topk(-best_dist, K)
    out = {
        "nodes": nodes,
        "best_dist": -negd,
        "best_dev": best_dev[idx],
        "best_root": best_root[idx],
        "sol_count": sol_count.sum(),
        "A": A,
        "cursor": cursor,
        "steps": steps,
        "barren_skips": int(barren_skips),
    }
    if findsubsols:
        out.update(subsol_dist=subsol_dist, subsol_vec=subsol_vec,
                   subsol_root=subsol_root)
    return out


def enum_run_grouped_plain(mut, rdiag, prune, mut_fix, cp0, roots_x,
                            roots_pd, A0, *, G_real: int, batch: int,
                            is_svp: bool, max_steps: int) -> dict:
    """The G problems one after another; a real problem's final bound
    bounds every later one (the TPU grid's shared bound, carried across
    cells in order)."""
    G, m, _ = mut.shape
    shared = found = float("inf")
    dist, devs, roots, As = [], [], [], []
    nodes = torch.zeros(m, dtype=torch.int64, device=mut.device)
    steps = barren_skips = 0
    for g in range(G):
        A_g = min(float(A0[g]), shared)
        out = enum_run_plain(mut[g], rdiag[g], prune[g], mut_fix[g], cp0[g],
                              roots_x[g], roots_pd[g], A_g, m=m,
                              is_svp=is_svp, count_mode=False,
                              max_steps=max_steps, batch=batch)
        if g < G_real:
            shared = min(shared, float(out["A"]))
            found = min(found, float(out["best_dist"][0]))
        dist.append(out["best_dist"][0])
        devs.append(out["best_dev"][0])
        roots.append(out["best_root"][0])
        As.append(out["A"])
        nodes += out["nodes"]
        steps += out["steps"]
        barren_skips += out["barren_skips"]
    return {"dist": torch.stack(dist), "dev": torch.stack(devs),
            "root": torch.stack(roots), "nodes": nodes,
            "A": torch.stack(As),
            "bound": torch.tensor(found, dtype=torch.float32), "steps": steps,
            "barren_skips": barren_skips}
