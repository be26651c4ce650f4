/* Fast-method LLL core over fixed-width multi-limb integers.
 *
 * Native engine for the wrapper's fast rung (the role of
 * fast_lll<double> in wrapper.cpp:100-151 + LLLReduction lll.cpp:44-224
 * + the MatGSO float state gso.cpp:24-234): exact basis rows are
 * little-endian two's-complement int64 limb vectors (so 1000s-of-bits
 * knapsack entries work without GMP), float state is double with
 * per-row exponent scaling (GSO_ROW_EXPO).
 *
 * On any overflow of the limb width or numerical failure the function
 * returns the corresponding RED_* status and the partially reduced
 * basis; the Python wrapper escalates exactly as it would after a
 * failed fast rung.
 */

#include <math.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define RED_SUCCESS 0
#define RED_GSO_FAILURE 2
#define RED_BABAI_FAILURE 3
#define RED_LLL_FAILURE 4
#define OVERFLOW_FAILURE 13

#define MAXD 512
#define SIZE_RED_FAILURE_THRESH 5

/* micro-profiling accumulators + clock (near-zero overhead; the BKZ TU
   exposes the totals through bkz_prof).  Thread-local so concurrent
   reductions of distinct objects (the reference's documented contract,
   README.md:309-311) do not race on the counters — ctypes releases the
   GIL across lll_fast/bkz_tour_native. */
static _Thread_local double g_t_ugr, g_t_red, g_t_bf, g_t_rowop;
static _Thread_local long g_babai_calls, g_babai_iters, g_rowops;
#include <time.h>
static double lll_now_s(void) {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (double)ts.tv_sec + 1e-9 * (double)ts.tv_nsec;
}

typedef unsigned __int128 u128;
typedef __int128 i128;

/* ---------------- multi-limb two's-complement vectors ---------------- */
/* numbers are L limbs of uint64, little endian, two's complement */

static inline int bn_is_neg(const uint64_t *a, int L) {
  return (int64_t)a[L - 1] < 0;
}

static int bn_addmul_si(uint64_t *dst, const uint64_t *src, int64_t x, int L) {
  /* dst += x * src modulo 2^(64L); two's complement semantics carry over.
     Returns 1 when the top limb stops being a pure sign extension (the
     caller keeps >= 2 headroom limbs, so this flags overflow). */
  i128 carry = 0;
  for (int i = 0; i < L; i++) {
    i128 cur = (i128)(uint64_t)dst[i] + (i128)x * (i128)(uint64_t)src[i] +
               carry;
    dst[i] = (uint64_t)cur;
    carry = cur >> 64; /* arithmetic shift preserves sign */
  }
  uint64_t top = dst[L - 1], sec = dst[L - 2];
  if (!((top == 0 && (int64_t)sec >= 0) ||
        (top == ~0ULL && (int64_t)sec < 0)))
    return 1;
  return 0;
}

static void bn_shl_limbs_small(uint64_t *a, int L, int bits) {
  /* a <<= bits, 0 <= bits < 64 */
  if (bits == 0) return;
  uint64_t carry = 0;
  for (int i = 0; i < L; i++) {
    uint64_t v = a[i];
    a[i] = (v << bits) | carry;
    carry = v >> (64 - bits);
  }
}

static int bn_addmul_si_2exp(uint64_t *dst, const uint64_t *src, int64_t x,
                             long expo, int L, uint64_t *tmp) {
  /* dst += (x * 2^expo) * src */
  if (x == 0) return 0;
  if (expo == 0) return bn_addmul_si(dst, src, x, L);
  long limb_sh = expo / 64;
  int bit_sh = (int)(expo % 64);
  if (limb_sh >= L - 2) return 1;
  int neg = bn_is_neg(src, L);
  uint64_t fill = neg ? ~0ULL : 0;
  /* the limbs shifted past the top must be pure sign fill, else the
     shifted value cannot be represented */
  for (int i = L - (int)limb_sh - 2; i < L; i++)
    if (i >= 0 && src[i] != fill) {
      /* allow the highest data limb to carry value only if it still
         sign-extends after the shift; be conservative: flag overflow */
      if (!(i == L - (int)limb_sh - 2 &&
            ((neg && (int64_t)src[i] < 0) ||
             (!neg && (int64_t)src[i] >= 0))))
        return 1;
    }
  for (int i = L - 1; i >= 0; i--) {
    long j = i - limb_sh;
    tmp[i] = (j >= 0) ? src[j] : 0;
  }
  /* sign-fill the vacated low side is zero (correct for shifts), and the
     top side retains sign because of the check above */
  bn_shl_limbs_small(tmp, L, bit_sh);
  return bn_addmul_si(dst, tmp, x, L);
}

static void bn_get_f_exp(const uint64_t *a, int L, double *f, long *e) {
  /* a = f * 2^e with 0.5 <= |f| < 1 (or f = 0) */
  int neg = bn_is_neg(a, L);
  uint64_t mag[MAXD];
  if (neg) {
    u128 c = 1;
    for (int i = 0; i < L; i++) {
      u128 s = (u128)(uint64_t)(~a[i]) + c;
      mag[i] = (uint64_t)s;
      c = s >> 64;
    }
  } else {
    memcpy(mag, a, (size_t)L * 8);
  }
  int top = L - 1;
  while (top >= 0 && mag[top] == 0) top--;
  if (top < 0) { *f = 0.0; *e = 0; return; }
  /* assemble the top ~96 bits into a double */
  double v = (double)mag[top];
  if (top >= 1) v = v * 1.0 + (double)mag[top - 1] / 18446744073709551616.0;
  int ex;
  double m = frexp(v, &ex);
  *e = (long)ex + 64L * top;
  *f = neg ? -m : m;
}

/* ------------------------- LLL state ---------------------------------- */

typedef struct {
  int d, n, L;
  uint64_t *b;      /* d rows, n cols, L limbs each */
  uint64_t *u;      /* optional transform, d x d x L */
  double *bf;       /* d x n scaled doubles */
  double *gf;       /* d x d gram (lazy, NAN = unknown) */
  double *mu, *r;   /* d x d */
  long *row_expo;
  int *valid;       /* gso_valid_cols */
  int n_known_rows;
  uint64_t *tmp;    /* L limbs scratch */
  uint64_t *rowtmp; /* (n + d) * L limbs: atomic row-update staging */
  int *lw;          /* per-row effective limb count (rows are stored
                       full-L sign-extended; ops only need the top).
                       Round-5 measurement: the conservative limb width
                       (L ~ 4 for 30-bit bases) made every babai row op
                       4x wider than the data — 53 of 83 in-tour LLL
                       seconds of a block-70 tour were limb arithmetic
                       on sign fill. */
  double delta, eta;
  long n_swaps;
  long version;     /* bumped on every exact basis write (BKZ memos) */
} lll_state;

static inline uint64_t *row(lll_state *S, int i) {
  return S->b + (size_t)i * S->n * S->L;
}
static inline uint64_t *urow(lll_state *S, int i) {
  return S->u ? S->u + (size_t)i * S->d * S->L : NULL;
}

static void update_bf(lll_state *S, int i) {
  long max_e = 0;
  double fs[4096];
  long es[4096];
  int any = 0;
  for (int j = 0; j < S->n; j++) {
    bn_get_f_exp(row(S, i) + (size_t)j * S->L, S->L, &fs[j], &es[j]);
    if (fs[j] != 0.0) {
      if (!any || es[j] > max_e) max_e = es[j];
      any = 1;
    }
  }
  if (!any) max_e = 0;
  S->row_expo[i] = max_e;
  if (S->lw) {
    /* effective limb count: |entry| < 2^max_e needs max_e+1 bits in
       two's complement */
    int w = (int)((max_e + 64) / 64);
    if (w < 1) w = 1;
    if (w > S->L) w = S->L;
    S->lw[i] = w;
  }
  for (int j = 0; j < S->n; j++)
    S->bf[(size_t)i * S->n + j] = fs[j] == 0.0 ? 0.0
                                               : ldexp(fs[j], es[j] - max_e);
}

static void invalidate_gram(lll_state *S, int i) {
  for (int j = 0; j < S->d; j++) {
    S->gf[(size_t)i * S->d + j] = NAN;
    S->gf[(size_t)j * S->d + i] = NAN;
  }
}

static double get_gram(lll_state *S, int i, int j) {
  double *g = &S->gf[(size_t)i * S->d + j];
  if (isnan(*g)) {
    const double *bi = S->bf + (size_t)i * S->n;
    const double *bj = S->bf + (size_t)j * S->n;
    double a0 = 0.0, a1 = 0.0, a2 = 0.0, a3 = 0.0;
    int t = 0;
    for (; t + 4 <= S->n; t += 4) {
      a0 += bi[t] * bj[t];
      a1 += bi[t + 1] * bj[t + 1];
      a2 += bi[t + 2] * bj[t + 2];
      a3 += bi[t + 3] * bj[t + 3];
    }
    for (; t < S->n; t++) a0 += bi[t] * bj[t];
    double acc = (a0 + a1) + (a2 + a3);
    *g = acc;
    S->gf[(size_t)j * S->d + i] = acc;
  }
  return *g;
}

static int update_gso_row(lll_state *S, int i, int last_j) {
  if (i >= S->n_known_rows) S->n_known_rows = i + 1;
  int j = S->valid[i] > 0 ? S->valid[i] : 0;
  double *mu_i = S->mu + (size_t)i * S->d;
  double *r_i = S->r + (size_t)i * S->d;
  for (; j <= last_j; j++) {
    double t = get_gram(S, i, j);
    const double *mu_j = S->mu + (size_t)j * S->d;
    /* 4-lane accumulation so the compiler can keep the subtractions in
       independent FMA chains (the strictly-sequential sum serialized on
       FP latency; this loop is the CGS recurrence hot spot,
       gso_interface.cpp:131-164). The changed summation order moves mu
       by <= a few ulp — the engines' A/B parity gates tolerate it
       (numpy's pairwise sums differ the same way). */
    {
      double a0 = 0.0, a1 = 0.0, a2 = 0.0, a3 = 0.0;
      int k = 0;
      for (; k + 4 <= j; k += 4) {
        a0 += mu_j[k] * r_i[k];
        a1 += mu_j[k + 1] * r_i[k + 1];
        a2 += mu_j[k + 2] * r_i[k + 2];
        a3 += mu_j[k + 3] * r_i[k + 3];
      }
      for (; k < j; k++) a0 += mu_j[k] * r_i[k];
      t -= (a0 + a1) + (a2 + a3);
    }
    r_i[j] = t;
    if (i > j) {
      double m = t / S->r[(size_t)j * S->d + j];
      mu_i[j] = m;
      if (!isfinite(m)) return 0;
    }
  }
  S->valid[i] = j;
  return 1;
}

static int row_addmul_we_impl(lll_state *S, int kappa, int j, double mu_rnd,
                              long expo);

static int row_addmul_we(lll_state *S, int kappa, int j, double mu_rnd,
                         long expo) {
  double t0 = lll_now_s();
  int rc = row_addmul_we_impl(S, kappa, j, mu_rnd, expo);
  g_t_rowop += lll_now_s() - t0;
  g_rowops++;
  return rc;
}

static int row_addmul_we_impl(lll_state *S, int kappa, int j, double mu_rnd,
                              long expo) {
  /* apply b[kappa] += (-mu_rnd * 2^expo) * b[j] exactly */
  double v = -mu_rnd;
  int fe;
  double fm = frexp(v, &fe);
  int64_t lx = (int64_t)ldexp(fm, 53); /* 53-bit mantissa */
  long e2 = (long)fe - 53 + expo;
  if (lx == 0) return 0;
  if (e2 < 0) {
    /* mu_rnd*2^expo is an integer by construction; negative e2 means
       trailing zero mantissa bits: shift lx down */
    while (e2 < 0 && (lx & 1) == 0) { lx >>= 1; e2++; }
    if (e2 < 0) { lx = (int64_t)llround(ldexp(v, (int)expo)); e2 = 0; }
  }
  /* stage into scratch and commit only after every column (and the
     transform row) passes the overflow check: a mid-row abort would
     leave a row that is no longer a lattice vector, and failed runs
     copy the partially reduced basis back to Python as valid state */
  {
    uint64_t *tb = S->rowtmp;
    uint64_t *tu = S->rowtmp + (size_t)S->n * S->L;
    memcpy(tb, row(S, kappa), (size_t)S->n * S->L * 8);
    for (int c = 0; c < S->n; c++)
      if (bn_addmul_si_2exp(tb + (size_t)c * S->L,
                            row(S, j) + (size_t)c * S->L, lx, e2, S->L,
                            S->tmp))
        return 1;
    if (S->u) {
      memcpy(tu, urow(S, kappa), (size_t)S->d * S->L * 8);
      for (int c = 0; c < S->d; c++)
        if (bn_addmul_si_2exp(tu + (size_t)c * S->L,
                              urow(S, j) + (size_t)c * S->L, lx, e2, S->L,
                              S->tmp))
          return 1;
      memcpy(urow(S, kappa), tu, (size_t)S->d * S->L * 8);
    }
    memcpy(row(S, kappa), tb, (size_t)S->n * S->L * 8);
  }
  S->version++;
  return 0;
}

typedef struct {
  int j;
  int64_t lx;
} red_op;

static int bn_addmul_fused(lll_state *S, int kappa, const red_op *ops,
                           int nops) {
  /* b_kappa += sum_t lx_t * b_{j_t} in ONE column pass: the L-limb
     accumulator stays in registers across all coefficients instead of a
     load/store + overflow check per (j, column) pair — the per-call
     row_addmul_we dominated BKZ's babai at ~5M calls per block-60 tour.
     Exact integer sums commute, so applying the whole reduction batch
     at once matches the sequential updates bit for bit. The overflow
     check runs once per column; the conservative limb headroom (the
     +130-bit sizing in native/__init__.py) keeps intermediate partial
     sums far from the wrap point. */
  int L = S->L, n = S->n;
  uint64_t acc[MAXD];
  /* stage all columns in rowtmp and commit in one pass afterwards, so a
     column overflow leaves the row untouched (atomicity: see
     row_addmul_we_impl).
     Arithmetic runs at the EFFECTIVE width of the involved rows (+1
     limb for the <= 53-bit coefficients and carries): rows are stored
     full-L sign-extended, so the first `width` limbs of any operand are
     its exact two's-complement value, and |result| < 2^(64*w + 60) fits
     width = w+1 limbs.  Only the sign fill beyond `width` is stored,
     not computed. */
  int w = S->lw ? S->lw[kappa] : L;
  if (S->lw)
    for (int t = 0; t < nops; t++)
      if (S->lw[ops[t].j] > w) w = S->lw[ops[t].j];
  int width = w + 1 > L ? L : w + 1;
  if (width == 2 && L > 2) {
    /* dominant case (entries fit one limb): the whole column value is
       a signed 128-bit scalar — one mul-add chain per (op, column),
       no limb loop, no carry bookkeeping */
    for (int c = 0; c < n; c++) {
      uint64_t *dst = row(S, kappa) + (size_t)c * L;
      i128 acc2 = (i128)((u128)dst[1] << 64 | dst[0]);
      for (int t = 0; t < nops; t++) {
        const uint64_t *src = row(S, ops[t].j) + (size_t)c * L;
        acc2 += (i128)ops[t].lx *
                (i128)(int64_t)src[0]; /* src fits 1 limb (lw <= 1) */
      }
      dst[0] = (uint64_t)acc2;
      dst[1] = (uint64_t)(acc2 >> 64);
      uint64_t fill = (int64_t)dst[1] < 0 ? ~0ULL : 0;
      for (int i = 2; i < L; i++) dst[i] = fill;
    }
    if (S->lw) S->lw[kappa] = 2;
    S->version++;
    return 0;
  }
  if (width < L) {
    /* the result provably fits `width` limbs: no overflow is possible,
       so updates go straight to the row (no staging traffic) */
    for (int c = 0; c < n; c++) {
      uint64_t *dst = row(S, kappa) + (size_t)c * L;
      memcpy(acc, dst, (size_t)width * 8);
      for (int t = 0; t < nops; t++) {
        const uint64_t *src = row(S, ops[t].j) + (size_t)c * L;
        i128 carry = 0;
        int64_t x = ops[t].lx;
        for (int i = 0; i < width; i++) {
          i128 cur = (i128)(uint64_t)acc[i] +
                     (i128)x * (i128)(uint64_t)src[i] + carry;
          acc[i] = (uint64_t)cur;
          carry = cur >> 64;
        }
      }
      memcpy(dst, acc, (size_t)width * 8);
      {
        uint64_t fill = (int64_t)acc[width - 1] < 0 ? ~0ULL : 0;
        for (int i = width; i < L; i++) dst[i] = fill;
      }
    }
    if (S->lw) S->lw[kappa] = width; /* upper bound; update_bf refines */
    S->version++;
    return 0;
  }
  /* full width: stage-then-commit for overflow atomicity */
  uint64_t *stage = S->rowtmp;
  for (int c = 0; c < n; c++) {
    const uint64_t *dst = row(S, kappa) + (size_t)c * L;
    memcpy(acc, dst, (size_t)L * 8);
    for (int t = 0; t < nops; t++) {
      const uint64_t *src = row(S, ops[t].j) + (size_t)c * L;
      i128 carry = 0;
      int64_t x = ops[t].lx;
      for (int i = 0; i < L; i++) {
        i128 cur = (i128)(uint64_t)acc[i] +
                   (i128)x * (i128)(uint64_t)src[i] + carry;
        acc[i] = (uint64_t)cur;
        carry = cur >> 64;
      }
    }
    {
      uint64_t top = acc[L - 1], sec = acc[L - 2];
      if (!((top == 0 && (int64_t)sec >= 0) ||
            (top == ~0ULL && (int64_t)sec < 0)))
        return 1;
    }
    memcpy(stage + (size_t)c * L, acc, (size_t)L * 8);
  }
  memcpy(row(S, kappa), stage, (size_t)n * L * 8);
  if (S->lw) S->lw[kappa] = L;
  S->version++;
  return 0;
}

static int babai(lll_state *S, int kappa, int min_col, int *status) {
  long max_expo = 0;
  int have_max = 0;
  double babai_mu[MAXD];
  long babai_expo[MAXD];
  g_babai_calls++;
  for (int iter = 0;; iter++) {
    g_babai_iters++;
    double tu0 = lll_now_s();
    int ugr_ok = update_gso_row(S, kappa, kappa - 1);
    g_t_ugr += lll_now_s() - tu0;
    if (!ugr_ok) { *status = RED_GSO_FAILURE; return 0; }
    int loop_needed = 0;
    for (int j = kappa - 1; j >= min_col; j--) {
      double v = S->mu[(size_t)kappa * S->d + j];
      long e = S->row_expo[kappa] - S->row_expo[j];
      /* e == 0 on almost every pair of a reduced window: skip the libm
         ldexp (it dominated block-70 BKZ tours at ~1e9 calls) */
      double t = e == 0 ? fabs(v)
                        : fabs(ldexp(v, e < 1024 ? (int)e : 1024));
      if (!(t <= S->eta)) { loop_needed = 1; break; }
    }
    if (!loop_needed) break;
    if (iter >= 2) {
      long nm = -100000;
      for (int j = min_col; j < kappa; j++) {
        double v = S->mu[(size_t)kappa * S->d + j];
        if (v == 0.0) continue;
        int fe; frexp(v, &fe);
        long tot = fe + (S->row_expo[kappa] - S->row_expo[j]);
        if (tot > nm) nm = tot;
      }
      if (have_max && nm > max_expo - SIZE_RED_FAILURE_THRESH) {
        *status = RED_BABAI_FAILURE;
        return 0;
      }
      max_expo = nm;
      have_max = 1;
    }
    double tr0 = lll_now_s();
    red_op ops[MAXD];
    int nops = 0;
    for (int j = min_col; j < kappa; j++) {
      babai_mu[j] = S->mu[(size_t)kappa * S->d + j];
      babai_expo[j] = S->row_expo[kappa] - S->row_expo[j];
    }
    for (int j = kappa - 1; j >= min_col; j--) {
      double v = babai_mu[j];
      long e = babai_expo[j];
      double mu_rnd;
      if (v == 0.0) continue;
      if (e == 0) {
        /* common case: same row scale — rnd_we is a plain rint, and
           the frexp/ldexp pair (libm) is the expensive part of this
           loop at BKZ's ~1e7 babai calls per tour */
        mu_rnd = fabs(v) >= 9007199254740992.0 ? v : rint(v);
      } else {
        int fe; frexp(v, &fe);
        if (fe + e >= 53) mu_rnd = v;
        else mu_rnd = ldexp(rint(ldexp(v, (int)e)), (int)-e);
      }
      if (mu_rnd == 0.0) continue;
      for (int k = min_col; k < j; k++)
        babai_mu[k] -= mu_rnd * S->mu[(size_t)j * S->d + k];
      /* int64-coefficient reductions with no scale shift batch into one
         fused column pass below; shifted/huge coefficients (rare) and
         transform-tracked runs keep the per-row path */
      if (!S->u) {
        int fe2;
        double fm = frexp(-mu_rnd, &fe2);
        int64_t lx = (int64_t)ldexp(fm, 53);
        long e2 = (long)fe2 - 53 + e;
        if (lx != 0) {
          while (e2 < 0 && (lx & 1) == 0) { lx >>= 1; e2++; }
          if (e2 < 0) { lx = (int64_t)llround(ldexp(-mu_rnd, (int)e)); e2 = 0; }
        }
        if (lx == 0) continue;
        if (e2 == 0) {
          ops[nops].j = j;
          ops[nops].lx = lx;
          nops++;
          continue;
        }
      }
      if (row_addmul_we(S, kappa, j, mu_rnd, e)) { *status = OVERFLOW_FAILURE; return 0; }
    }
    if (nops) {
      double tf0 = lll_now_s();
      int ofl = bn_addmul_fused(S, kappa, ops, nops);
      g_t_rowop += lll_now_s() - tf0;
      g_rowops += nops;
      if (ofl) { *status = OVERFLOW_FAILURE; return 0; }
    }
    g_t_red += lll_now_s() - tr0;
    /* refresh float state of row kappa */
    double tb0 = lll_now_s();
    update_bf(S, kappa);
    invalidate_gram(S, kappa);
    S->valid[kappa] = 0;
    g_t_bf += lll_now_s() - tb0;
  }
  return 1;
}

static void rot_rows_right(double *a, int stride, int first, int last,
                           double *tmp) {
  memcpy(tmp, a + (size_t)last * stride, (size_t)stride * 8);
  memmove(a + (size_t)(first + 1) * stride, a + (size_t)first * stride,
          (size_t)(last - first) * stride * 8);
  memcpy(a + (size_t)first * stride, tmp, (size_t)stride * 8);
}

static void move_row(lll_state *S, int old_r, int new_r, double *dtmp,
                     uint64_t *btmp) {
  /* only new_r < old_r used by this fast LLL (insertions) */
  for (int i = new_r; i < S->n_known_rows; i++)
    if (S->valid[i] > new_r) S->valid[i] = new_r;
  {
    int v = S->valid[old_r];
    memmove(S->valid + new_r + 1, S->valid + new_r,
            (size_t)(old_r - new_r) * sizeof(int));
    S->valid[new_r] = v;
  }
  {
    long e = S->row_expo[old_r];
    memmove(S->row_expo + new_r + 1, S->row_expo + new_r,
            (size_t)(old_r - new_r) * sizeof(long));
    S->row_expo[new_r] = e;
  }
  if (S->lw) {
    int w = S->lw[old_r];
    memmove(S->lw + new_r + 1, S->lw + new_r,
            (size_t)(old_r - new_r) * sizeof(int));
    S->lw[new_r] = w;
  }
  rot_rows_right(S->mu, S->d, new_r, old_r, dtmp);
  rot_rows_right(S->r, S->d, new_r, old_r, dtmp);
  rot_rows_right(S->bf, S->n, new_r, old_r, dtmp);
  /* gram: rotate rows and columns */
  rot_rows_right(S->gf, S->d, new_r, old_r, dtmp);
  for (int i = 0; i < S->d; i++) {
    double *g = S->gf + (size_t)i * S->d;
    double t = g[old_r];
    memmove(g + new_r + 1, g + new_r, (size_t)(old_r - new_r) * 8);
    g[new_r] = t;
  }
  /* basis rows */
  size_t bs = (size_t)S->n * S->L;
  memcpy(btmp, row(S, old_r), bs * 8);
  memmove(row(S, new_r + 1), row(S, new_r),
          (size_t)(old_r - new_r) * bs * 8);
  memcpy(row(S, new_r), btmp, bs * 8);
  if (S->u) {
    size_t us = (size_t)S->d * S->L;
    memcpy(btmp, urow(S, old_r), us * 8);
    memmove(urow(S, new_r + 1), urow(S, new_r),
            (size_t)(old_r - new_r) * us * 8);
    memcpy(urow(S, new_r), btmp, us * 8);
  }
}

/* exported: returns RED_* status; OVERFLOW_FAILURE means "retry in python".
   kappa_end <= d bounds the reduced prefix (rows beyond stay untouched);
   size_red_only runs only the lazy size reduction (LLL size_reduction
   semantics, lll.h:96-107) without Lovasz swaps. */
int lll_fast(int d, int n, int L, uint64_t *bdata, uint64_t *udata,
             double delta, double eta, int kappa_end, int size_red_only,
             long *n_swaps_out) {
  if (d < 1 || d > MAXD || n > 4096 || L > MAXD) return OVERFLOW_FAILURE;
  if (kappa_end <= 0 || kappa_end > d) kappa_end = d;
  lll_state S;
  memset(&S, 0, sizeof(S));
  S.d = d; S.n = n; S.L = L;
  S.b = bdata; S.u = udata;
  S.delta = delta; S.eta = eta;
  S.bf = malloc((size_t)d * n * 8);
  S.gf = malloc((size_t)d * d * 8);
  S.mu = calloc((size_t)d * d, 8);
  S.r = calloc((size_t)d * d, 8);
  S.row_expo = calloc((size_t)d, sizeof(long));
  S.valid = calloc((size_t)d, sizeof(int));
  S.tmp = malloc((size_t)L * 8);
  S.rowtmp = malloc((size_t)(n + d) * L * 8);
  S.lw = malloc((size_t)d * sizeof(int)); /* NULL tolerated: full-L ops */
  double *dtmp = malloc((size_t)(n > d ? n : d) * 8);
  uint64_t *btmp = malloc((size_t)(n > d ? n : d) * L * 8);
  int status = RED_SUCCESS;
  if (!S.bf || !S.gf || !S.mu || !S.r || !S.row_expo || !S.valid || !S.tmp ||
      !S.rowtmp || !dtmp || !btmp) { status = OVERFLOW_FAILURE; goto done; }
  for (int i = 0; i < d; i++) update_bf(&S, i);
  for (int i = 0; i < (int)((size_t)d * d); i++) S.gf[i] = NAN;
  S.n_known_rows = 0;

  if (size_red_only) {
    for (int k = 0; k < kappa_end; k++) {
      if (k > 0 && !babai(&S, k, 0, &status)) goto done;
      if (!update_gso_row(&S, k, k)) { status = RED_GSO_FAILURE; goto done; }
    }
    goto done;
  }
  {
    int kappa = 1, kappa_max = 0;
    if (!update_gso_row(&S, 0, 0)) { status = RED_GSO_FAILURE; goto done; }
    double lovasz[MAXD + 1];
    long iter = 0, max_iter = (long)d * d * 4000L + 100000L;
    while (kappa < kappa_end && iter++ < max_iter) {
      if (kappa > kappa_max) kappa_max = kappa;
      if (!babai(&S, kappa, 0, &status)) goto done;
      if (!update_gso_row(&S, kappa, kappa)) { status = RED_GSO_FAILURE; goto done; }
      lovasz[0] = get_gram(&S, kappa, kappa);
      for (int i = 1; i <= kappa; i++)
        lovasz[i] = lovasz[i - 1] - S.mu[(size_t)kappa * S.d + (i - 1)] *
                                        S.r[(size_t)kappa * S.d + (i - 1)];
      double t = S.r[(size_t)(kappa - 1) * S.d + (kappa - 1)] * delta;
      t = ldexp(t, (int)(2 * (S.row_expo[kappa - 1] - S.row_expo[kappa])));
      if (t > lovasz[kappa - 1]) {
        S.n_swaps++;
        int old_k = kappa;
        kappa--;
        while (kappa > 0) {
          double tt = S.r[(size_t)(kappa - 1) * S.d + (kappa - 1)] * delta;
          tt = ldexp(tt, (int)(2 * (S.row_expo[kappa - 1] - S.row_expo[old_k])));
          if (tt < lovasz[kappa - 1]) break;
          kappa--;
        }
        if (lovasz[kappa] > 0) {
          move_row(&S, old_k, kappa, dtmp, btmp);
        } else {
          status = RED_LLL_FAILURE; /* zero rows: fall back to python */
          goto done;
        }
      }
      S.r[(size_t)kappa * S.d + kappa] = lovasz[kappa];
      if (S.valid[kappa] == kappa) S.valid[kappa] = kappa + 1;
      kappa++;
    }
    if (kappa < kappa_end) status = RED_LLL_FAILURE;
  }

done:
  if (n_swaps_out) *n_swaps_out = S.n_swaps;
  free(S.bf); free(S.gf); free(S.mu); free(S.r); free(S.row_expo);
  free(S.valid); free(S.tmp); free(S.rowtmp); free(S.lw);
  free(dtmp); free(btmp);
  return status;
}
