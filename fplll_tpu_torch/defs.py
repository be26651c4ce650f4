"""Global enums, flags, status codes and default constants.

TPU-native re-design of the reference's cross-cutting definitions
(see fplll/defs.h:130-315 for the surface we mirror).
Values of the bitflags and enums are kept numerically identical so that
strategy files, CLIs and downstream users interoperate.
"""

from __future__ import annotations

import enum

# ---------------------------------------------------------------------------
# Numeric defaults (reference: defs.h:143-151, 255-260)
# ---------------------------------------------------------------------------
LLL_DEF_DELTA = 0.99
LLL_DEF_ETA = 0.51
LLL_DEF_EPSILON = 0.01
SIZE_RED_FAILURE_THRESH = 5

HLLL_DEF_THETA = 0.001
HLLL_DEF_C = 0.1

PREC_DOUBLE = 53
PREC_DD = 106
PREC_QD = 212

BKZ_DEF_AUTO_ABORT_SCALE = 1.0
BKZ_DEF_AUTO_ABORT_MAX_NO_DEC = 5
BKZ_DEF_GH_FACTOR = 1.1
BKZ_DEF_MIN_SUCCESS_PROBABILITY = 0.5
BKZ_DEF_RERANDOMIZATION_DENSITY = 3

# Maximum enumeration dimension for the single-tree (CPU-oracle) path and the
# batched TPU kernels (reference: configure.ac:161 uses 256).
FPLLL_MAX_ENUM_DIM = 256

# Entries with |x| < 2^(63 - OVERFLOW_GUARD_BITS) may use the i64 fast path
# (reference precedent: convert<long, mpz_t> with a 10-bit buffer,
# bkz.cpp:826-837).
OVERFLOW_GUARD_BITS = 10


# ---------------------------------------------------------------------------
# Status codes (reference: defs.h:153-184)
# ---------------------------------------------------------------------------
class RedStatus(enum.IntEnum):
    RED_SUCCESS = 0
    RED_GSO_FAILURE = 2
    RED_BABAI_FAILURE = 3
    RED_LLL_FAILURE = 4
    RED_ENUM_FAILURE = 5
    RED_BKZ_FAILURE = 6
    RED_BKZ_TIME_LIMIT = 7
    RED_BKZ_LOOPS_LIMIT = 8
    RED_HLLL_FAILURE = 9
    RED_HLLL_NORM_FAILURE = 10
    RED_HLLL_SR_FAILURE = 11
    RED_URL_ERR = 12
    RED_STATUS_MAX = 13


RED_SUCCESS = RedStatus.RED_SUCCESS
RED_GSO_FAILURE = RedStatus.RED_GSO_FAILURE
RED_BABAI_FAILURE = RedStatus.RED_BABAI_FAILURE
RED_LLL_FAILURE = RedStatus.RED_LLL_FAILURE
RED_ENUM_FAILURE = RedStatus.RED_ENUM_FAILURE
RED_BKZ_FAILURE = RedStatus.RED_BKZ_FAILURE
RED_BKZ_TIME_LIMIT = RedStatus.RED_BKZ_TIME_LIMIT
RED_BKZ_LOOPS_LIMIT = RedStatus.RED_BKZ_LOOPS_LIMIT
RED_HLLL_FAILURE = RedStatus.RED_HLLL_FAILURE
RED_HLLL_NORM_FAILURE = RedStatus.RED_HLLL_NORM_FAILURE
RED_HLLL_SR_FAILURE = RedStatus.RED_HLLL_SR_FAILURE

RED_STATUS_STR = [
    "success",
    "",
    "infinite number in GSO",
    "infinite loop in babai",
    "infinite loop in LLL",
    "error in SVP solver",
    "error in BKZ",
    "time limit exceeded in BKZ",
    "loops limit exceeded in BKZ",
    "error in HLLL",
    "increase of the norm",
    "error in weak size reduction",
    "see the fplll errors FAQ",
]


def get_red_status_str(status: int) -> str:
    if 0 <= status < len(RED_STATUS_STR):
        return RED_STATUS_STR[status]
    return "unknown error"


# ---------------------------------------------------------------------------
# Method / type enums (reference: defs.h:186-220)
# ---------------------------------------------------------------------------
class LLLMethod(enum.IntEnum):
    LM_WRAPPER = 0
    LM_PROVED = 1
    LM_HEURISTIC = 2
    LM_FAST = 3


LM_WRAPPER = LLLMethod.LM_WRAPPER
LM_PROVED = LLLMethod.LM_PROVED
LM_HEURISTIC = LLLMethod.LM_HEURISTIC
LM_FAST = LLLMethod.LM_FAST

LLL_METHOD_STR = ["wrapper", "proved", "heuristic", "fast"]
HLLL_METHOD_STR = ["wrapper", "proved", "", "fast"]


class IntType(enum.IntEnum):
    ZT_MPZ = 0     # arbitrary-precision (Python int backed)
    ZT_LONG = 1    # 64-bit fast path
    ZT_DOUBLE = 2  # double-as-integer


ZT_MPZ = IntType.ZT_MPZ
ZT_LONG = IntType.ZT_LONG
ZT_DOUBLE = IntType.ZT_DOUBLE

INT_TYPE_STR = ["mpz", "long", "double"]


class FloatType(enum.IntEnum):
    """Float backend selector.

    The TPU build maps the reference's six float backends
    (defs.h:208-218) onto dtype policies:

    - DOUBLE       -> numpy/JAX float64
    - LONG_DOUBLE  -> 64-bit-mantissa soft-float (mpmath prec=64)
    - DPE          -> 53-bit mantissa, unbounded exponent (mpmath prec=53)
    - DD           -> double-double; device path uses EFT kernels, host path
                      is a 106-bit soft-float
    - QD           -> 212-bit soft-float
    - MPFR         -> arbitrary precision soft-float (mpmath)
    """

    FT_DEFAULT = 0
    FT_DOUBLE = 1
    FT_LONG_DOUBLE = 2
    FT_DPE = 3
    FT_DD = 4
    FT_QD = 5
    FT_MPFR = 6


FT_DEFAULT = FloatType.FT_DEFAULT
FT_DOUBLE = FloatType.FT_DOUBLE
FT_LONG_DOUBLE = FloatType.FT_LONG_DOUBLE
FT_DPE = FloatType.FT_DPE
FT_DD = FloatType.FT_DD
FT_QD = FloatType.FT_QD
FT_MPFR = FloatType.FT_MPFR

FLOAT_TYPE_STR = ["", "double", "long double", "dpe", "dd", "qd", "mpfr"]


# ---------------------------------------------------------------------------
# Flags (reference: defs.h:222-315); numeric values preserved
# ---------------------------------------------------------------------------
LLL_VERBOSE = 1
LLL_EARLY_RED = 2
LLL_SIEGEL = 4
LLL_DEFAULT = 0


class SVPMethod(enum.IntEnum):
    SVPM_FAST = 0
    SVPM_PROVED = 2


SVPM_FAST = SVPMethod.SVPM_FAST
SVPM_PROVED = SVPMethod.SVPM_PROVED


class CVPMethod(enum.IntEnum):
    CVPM_FAST = 0
    CVPM_PROVED = 2


CVPM_FAST = CVPMethod.CVPM_FAST
CVPM_PROVED = CVPMethod.CVPM_PROVED

SVP_DEFAULT = 0
SVP_VERBOSE = 1
SVP_OVERRIDE_BND = 2
SVP_DUAL = 4

CVP_DEFAULT = SVP_DEFAULT
CVP_VERBOSE = SVP_VERBOSE

BKZ_DEFAULT = 0
BKZ_VERBOSE = 1
BKZ_NO_LLL = 2
BKZ_MAX_LOOPS = 4
BKZ_MAX_TIME = 8
BKZ_BOUNDED_LLL = 0x10
BKZ_AUTO_ABORT = 0x20
BKZ_DUMP_GSO = 0x40
BKZ_GH_BND = 0x80
BKZ_SD_VARIANT = 0x100
BKZ_SLD_RED = 0x200

HKZ_DEFAULT = 0
HKZ_VERBOSE = 1

# GSO flags (reference: gso_interface.h:26-32)
GSO_DEFAULT = 0
GSO_INT_GRAM = 1
GSO_ROW_EXPO = 2
GSO_OP_FORCE_LONG = 4

# Householder flags (reference: householder.h:26-32)
HOUSEHOLDER_DEFAULT = 0
HOUSEHOLDER_ROW_EXPO = 2
HOUSEHOLDER_OP_FORCE_LONG = 4


class PrunerMetric(enum.IntEnum):
    PRUNER_METRIC_PROBABILITY_OF_SHORTEST = 0
    PRUNER_METRIC_EXPECTED_SOLUTIONS = 1


PRUNER_METRIC_PROBABILITY_OF_SHORTEST = (
    PrunerMetric.PRUNER_METRIC_PROBABILITY_OF_SHORTEST
)
PRUNER_METRIC_EXPECTED_SOLUTIONS = PrunerMetric.PRUNER_METRIC_EXPECTED_SOLUTIONS

PRUNER_CVP = 0x1
PRUNER_START_FROM_INPUT = 0x2
PRUNER_GRADIENT = 0x4
PRUNER_NELDER_MEAD = 0x8
PRUNER_VERBOSE = 0x10
PRUNER_HALF = 0x20
PRUNER_SINGLE = 0x40
PRUNER_ZEALOUS = PRUNER_GRADIENT | PRUNER_NELDER_MEAD
