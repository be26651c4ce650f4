"""fplll_tpu_torch — the PyTorch / CUDA port of fplll_tpu.

The same lattice-reduction library as the JAX package beside it (LLL,
HLLL, BKZ / BKZ-2.0, proved and pruned SVP, dual SVP, fast and proved
CVP), with the enumeration hot path on a hand-written CUDA kernel for
Hopper (``csrc/enum_chunk.cu``: f32 trees for BKZ windows, f64 trees for
the proved solvers, the dual recurrence and per-level sub-solutions) and
the host orchestration (exact-integer LLL, GSO, the native C cores)
carried over unchanged. With more than one card visible, the enumeration
facade shards its trees over every card from one process
(:mod:`fplll_tpu_torch.parallel.mesh`). The pruner takes its analytic gradient from
torch.autograd, and a full GSO recompute at d >= FPLLL_TPU_DEVICE_GSO_DIM
runs as an f64 Cholesky on the device. The user surfaces are the CLIs
(``python -m fplll_tpu_torch.cli.main``, ``.cli.latticegen``,
``.cli.llldiff``) and the fpylll veneer (:mod:`fplll_tpu_torch.fpylll`).

Entry points that may reach the device run on ``cuda`` unless the caller
asks for the CPU (``device='cpu'`` or ``FPLLL_TORCH_DEVICE=cpu``; the
CLIs and the veneer follow the variable), see
:mod:`fplll_tpu_torch.torchsetup`.
"""

from .defs import *  # noqa: F401,F403
from .ops.intmat import (IntMat, format_matrix, format_vector, parse_matrix,  # noqa: F401
                         parse_vector, read_matrix)
from .ops import gen  # noqa: F401
from .nr.rng import RandGen, RandGenInt  # noqa: F401
from .nr.fctx import (F64Ctx, MPCtx, get_ctx, float_ctx_from_name,  # noqa: F401
                      gso_min_prec, l2_min_prec, hlll_min_prec)
from .core.gso import MatGSO, MatGSOGram, adjust_radius_to_gh_bound  # noqa: F401
from .core.householder import MatHouseholder  # noqa: F401
from .algs.lll import LLLReduction, is_lll_reduced  # noqa: F401
from .algs.hlll import HLLLReduction, is_hlll_reduced  # noqa: F401
from .algs.wrapper import (Wrapper, lll_reduction, hlll_reduction,  # noqa: F401
                           zeros_first, zeros_last)
from .algs.bkz import (BKZReduction, BKZAutoAbort, bkz_reduction,  # noqa: F401
                       hkz_reduction)
from .algs.bkz_param import (BKZParam, PruningParams, Strategy,  # noqa: F401
                             load_strategies_json)
from .algs.svpcvp import (closest_vector, shortest_vector,  # noqa: F401
                          shortest_vector_pruning)
from .pruner.pruner import Pruner, prune, run_pruner, svp_probability  # noqa: F401
from .threads import get_threads, set_threads  # noqa: F401
from .torchsetup import resolve_device  # noqa: F401

__version__ = "1.0.0.dev0"
