/* Native BKZ window orchestration over the limb basis + f64 GSO state.
 *
 * Round-3 profiling showed the block-60 BKZ tour spending ~90% of its
 * wall-clock in host-Python control flow between enumerations: per-window
 * export_mu_r, the lazy-GSO bookkeeping, the ~100k preprocessing re-asks
 * of the recursion, and evaluator plumbing.  This engine moves the whole
 * per-window loop of the reference driver — size-reduce prefix, recursive
 * preprocessing, rerandomization, GH-clamped radius, pruning-set
 * selection, enumeration, solution insertion — into C over the shared
 * lll_state (multi-limb exact basis + double GSO with row exponents),
 * calling back into Python only when a window's tree escalates past the
 * sequential-core budget to the batched device kernel.
 *
 * Control flow mirrors fplll/bkz.cpp:
 *   tour/trunc_tour/hkz           bkz.cpp:360-441
 *   svp_reduction retrial loop    bkz.cpp:274-358
 *   svp_preprocessing recursion   bkz.cpp:100-126
 *   rerandomize_block             bkz.cpp:43-80
 *   solution insertion (3 cases)  bkz.cpp:128-272
 *   strategy selection            bkz_param.cpp:62-78
 *   GH radius clamp               gso_interface.cpp:257-275
 * but the data layout (limb rows, scaled-double GSO, packed strategy
 * tables) and the device-escalation seam are this framework's own.
 */

#include "lll_core.c"
#undef MAXD
#include "enum_core.c"
#undef MAXD

#include <stdio.h>
#include <time.h>

static double now_s(void) {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (double)ts.tv_sec + 1e-9 * (double)ts.tv_nsec;
}

#define BKZ_MAXD 512
#define BKZF_GH_BND 0x80

#ifndef M_PI
#define M_PI 3.14159265358979323846
#endif

/* Device-escalation callback: G independent window problems (trial
 * batching), each m-dimensional; mut is G*m*m row-major with
 * mut[g][i*m+j] = mu(j,i) (transposed upper), rdiag/prune G*m, maxdist G.
 * On return dist_out[g] is the solution distance (INFINITY = none) and
 * sol_out[g*m..] the coordinates.  nodes_out accumulates device nodes.
 * Returns 0 on success, nonzero to abort the native tour (the Python
 * driver then redoes the tour from the current, still-valid basis). */
typedef int (*enum_dev_cb)(int G, int m, const double *mut,
                           const double *rdiag, const double *prune,
                           const double *maxdist, double *sol_out,
                           double *dist_out, double *nodes_out);

typedef struct {
  int d, n, L;
  double lll_delta, lll_eta; /* Lovasz / size-reduction parameters */
  double radius_delta;       /* BKZParam.delta scaling the window radius */
  int block_size, flags;
  double gh_factor, min_succ;
  int density;
  /* packed strategies, indexed by block size (bkz_param.h:34-66) */
  int n_strat;
  const int32_t *pre_off, *pre_len, *pre_data;
  const int32_t *ps_off, *ps_cnt;
  const double *ps_gh, *ps_exp;
  const int64_t *ps_coef_off;
  const int32_t *ps_coef_len;
  const double *ps_coefs;
  /* enumeration control */
  long long hybrid_budget; /* sequential-core budget before escalation */
  int min_device_dim;      /* below this never escalate (facade parity) */
  int trial_batch_max;     /* max grouped rerandomized trials per launch */
  unsigned long long seed;
  int min_row, max_row;
  /* outputs */
  double nodes_out;
  long n_swaps_out;
  int clean_out;
  /* phase timers (seconds; filled when profiling is cheap enough to
     leave on — one clock_gettime pair per phase call) */
  double t_enum_out;   /* sequential C enumeration */
  double t_dev_out;    /* device callback (incl. python) */
  double t_lll_out;    /* in-state LLL / size reduction */
  double t_misc_out;   /* export + radius + insertion bookkeeping */
  double t_babai_out;  /* share of t_lll: lazy size reduction */
  double t_move_out;   /* share of t_lll: row moves/swaps */
  double dev_nodes_out; /* share of nodes_out enumerated by the device */
  int g_max_out;        /* largest grouped-trial launch this tour */
} bkz_args;

typedef struct {
  lll_state S;
  bkz_args *a;
  enum_dev_cb cb;
  long clean_lll_end, clean_lll_ver; /* prefix-clean memos */
  long clean_sr_end, clean_sr_ver;
  int clean_px, sr_px; /* rows [0, px) reduced AND untouched since: the
                          L2 / size-reduction sweeps restart there
                          instead of row 1 (the conditions only involve
                          earlier rows, so an untouched reduced prefix
                          stays reduced) */
  uint64_t rng;
  double nodes;
  int status; /* sticky RED_* / OVERFLOW / -2 cb error */
  long fault_after, windows_done; /* test-only fault injection knob */
  double *dtmp;
  uint64_t *btmp;
  /* shared scratch for window exports (no recursion while live) */
  double *mut_s, *rdiag_s, *prune_s, *amax_s, *sol_s, *dist_s;
} bkz_ctx;

typedef struct {
  int block_size, flags;
  double gh_factor, min_succ;
  int density;
} bkz_par;

/* ---------------- deterministic RNG (splitmix64) ---------------------- */
static uint64_t sm64(uint64_t *s) {
  uint64_t z = (*s += 0x9E3779B97F4A7C15ULL);
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
  return z ^ (z >> 31);
}
static long rnd_below(bkz_ctx *B, long nmax) {
  return nmax <= 1 ? 0 : (long)(sm64(&B->rng) % (uint64_t)nmax);
}

/* ---------------- exact row operations with GSO bookkeeping ----------- */
static void px_touch(bkz_ctx *B, int t) {
  if (t < B->clean_px) B->clean_px = t;
  if (t < B->sr_px) B->sr_px = t;
}

static void mark_changed(bkz_ctx *B, int t) {
  lll_state *S = &B->S;
  px_touch(B, t);
  update_bf(S, t);
  invalidate_gram(S, t);
  S->valid[t] = 0;
  for (int j = t + 1; j < S->d; j++)
    if (S->valid[j] > t) S->valid[j] = t;
  S->version++;
}

static int row_addmul_exact(bkz_ctx *B, int i, int j, long x) {
  lll_state *S = &B->S;
  int L = S->L;
  if (!x) return 1;
  /* stage-then-commit (atomicity: see lll_core row_addmul_we_impl) — an
     overflow must leave row i a valid lattice vector, because the tour
     copies the partially reduced basis back to Python on failure.
     Arithmetic runs at the rows' effective width (see bn_addmul_fused);
     coefficients past 2^53 (never produced by insertion/rerandomize)
     fall back to full width. */
  int width = L;
  if (S->lw && (x < (1L << 53) && x > -(1L << 53))) {
    int w = S->lw[i] > S->lw[j] ? S->lw[i] : S->lw[j];
    width = w + 1 > L ? L : w + 1;
  }
  if (width < L) {
    /* provably no overflow: update the row in place */
    for (int c = 0; c < S->n; c++) {
      uint64_t *dc = row(S, i) + (size_t)c * L;
      const uint64_t *sc = row(S, j) + (size_t)c * L;
      i128 carry = 0;
      for (int t = 0; t < width; t++) {
        i128 cur = (i128)(uint64_t)dc[t] +
                   (i128)x * (i128)(uint64_t)sc[t] + carry;
        dc[t] = (uint64_t)cur;
        carry = cur >> 64;
      }
      uint64_t fill = (int64_t)dc[width - 1] < 0 ? ~0ULL : 0;
      for (int t = width; t < L; t++) dc[t] = fill;
    }
    mark_changed(B, i); /* update_bf refreshes lw[i] */
    return 1;
  }
  uint64_t *tb = S->rowtmp;
  memcpy(tb, row(S, i), (size_t)S->n * L * 8);
  for (int c = 0; c < S->n; c++) {
    uint64_t *dc = tb + (size_t)c * L;
    const uint64_t *sc = row(S, j) + (size_t)c * L;
    i128 carry = 0;
    for (int t = 0; t < L; t++) {
      i128 cur = (i128)(uint64_t)dc[t] + (i128)x * (i128)(uint64_t)sc[t] +
                 carry;
      dc[t] = (uint64_t)cur;
      carry = cur >> 64;
    }
    {
      uint64_t top = dc[L - 1], sec = dc[L - 2];
      if (!((top == 0 && (int64_t)sec >= 0) ||
            (top == ~0ULL && (int64_t)sec < 0))) {
        B->status = OVERFLOW_FAILURE;
        return 0;
      }
    }
  }
  memcpy(row(S, i), tb, (size_t)S->n * L * 8);
  mark_changed(B, i); /* update_bf refreshes lw[i] */
  return 1;
}

static void bn_neg(uint64_t *v, int L) {
  u128 c = 1;
  for (int i = 0; i < L; i++) {
    u128 s = (u128)(uint64_t)(~v[i]) + c;
    v[i] = (uint64_t)s;
    c = s >> 64;
  }
}

static void negate_row(bkz_ctx *B, int i) {
  lll_state *S = &B->S;
  for (int c = 0; c < S->n; c++) bn_neg(row(S, i) + (size_t)c * S->L, S->L);
  mark_changed(B, i);
}

static void row_swap_bkz(bkz_ctx *B, int i, int j) {
  lll_state *S = &B->S;
  if (i == j) return;
  if (i > j) { int t = i; i = j; j = t; }
  size_t bs = (size_t)S->n * S->L;
  memcpy(B->btmp, row(S, i), bs * 8);
  memcpy(row(S, i), row(S, j), bs * 8);
  memcpy(row(S, j), B->btmp, bs * 8);
  mark_changed(B, i); /* caps every later row's validity to <= i */
  mark_changed(B, j);
}

static void rot_rows_left(double *m, int stride, int first, int last,
                          double *tmp) {
  memcpy(tmp, m + (size_t)first * stride, (size_t)stride * 8);
  memmove(m + (size_t)first * stride, m + (size_t)(first + 1) * stride,
          (size_t)(last - first) * stride * 8);
  memcpy(m + (size_t)last * stride, tmp, (size_t)stride * 8);
}

static void move_row_bkz(bkz_ctx *B, int old_r, int new_r) {
  lll_state *S = &B->S;
  if (old_r == new_r) return;
  double t0 = now_s();
  px_touch(B, new_r < old_r ? new_r : old_r);
  if (new_r < old_r) { /* down-move: insertion (lll_core move_row) */
    move_row(S, old_r, new_r, B->dtmp, B->btmp);
    S->version++;
    B->a->t_move_out += now_s() - t0;
    return;
  }
  /* up-move: row old_r goes later; rows (old_r, new_r] shift down one.
     mu/r columns < old_r are untouched by the permutation. */
  for (int i = old_r; i < S->d; i++)
    if (S->valid[i] > old_r) S->valid[i] = old_r;
  {
    int v = S->valid[old_r];
    memmove(S->valid + old_r, S->valid + old_r + 1,
            (size_t)(new_r - old_r) * sizeof(int));
    S->valid[new_r] = v;
  }
  {
    long e = S->row_expo[old_r];
    memmove(S->row_expo + old_r, S->row_expo + old_r + 1,
            (size_t)(new_r - old_r) * sizeof(long));
    S->row_expo[new_r] = e;
  }
  if (S->lw) {
    int w = S->lw[old_r];
    memmove(S->lw + old_r, S->lw + old_r + 1,
            (size_t)(new_r - old_r) * sizeof(int));
    S->lw[new_r] = w;
  }
  rot_rows_left(S->mu, S->d, old_r, new_r, B->dtmp);
  rot_rows_left(S->r, S->d, old_r, new_r, B->dtmp);
  rot_rows_left(S->bf, S->n, old_r, new_r, B->dtmp);
  rot_rows_left(S->gf, S->d, old_r, new_r, B->dtmp);
  for (int i = 0; i < S->d; i++) {
    double *g = S->gf + (size_t)i * S->d;
    double t = g[old_r];
    memmove(g + old_r, g + old_r + 1, (size_t)(new_r - old_r) * 8);
    g[new_r] = t;
  }
  {
    size_t bsz = (size_t)S->n * S->L;
    memcpy(B->btmp, row(S, old_r), bsz * 8);
    memmove(row(S, old_r), row(S, old_r + 1),
            (size_t)(new_r - old_r) * bsz * 8);
    memcpy(row(S, new_r), B->btmp, bsz * 8);
  }
  S->version++;
  B->a->t_move_out += now_s() - t0;
}

static int babai_bkz(bkz_ctx *B, int kappa, int min_col) {
  lll_state *S = &B->S;
  long v0 = S->version;
  int status = RED_SUCCESS;
  double t0 = now_s();
  int ok = babai(S, kappa, min_col, &status);
  B->a->t_babai_out += now_s() - t0;
  if (S->version != v0) { /* row kappa written: later cols stale */
    px_touch(B, kappa);
    for (int j = kappa + 1; j < S->d; j++)
      if (S->valid[j] > kappa) S->valid[j] = kappa;
  }
  if (!ok) {
    B->status = status ? status : RED_BABAI_FAILURE;
    return 0;
  }
  return 1;
}

/* ---------------- in-state LLL / size reduction ------------------------ */
/* The L2 loop of lll_core.c:lll_fast over the persistent state, with the
   prefix-clean memo: LLL holds on every prefix of a reduced prefix, so a
   repeat ask on an untouched basis is O(1) (replaces the Python-side memo
   of algs/bkz.py:140-147 that the recursion hit ~100k times per tour). */
static int lll_in_state_impl(bkz_ctx *B, int kappa_end, int size_red_only);

static int lll_in_state(bkz_ctx *B, int kappa_end, int size_red_only) {
  double t0 = now_s();
  int rc = lll_in_state_impl(B, kappa_end, size_red_only);
  B->a->t_lll_out += now_s() - t0;
  return rc;
}

static int lll_in_state_impl(bkz_ctx *B, int kappa_end, int size_red_only) {
  lll_state *S = &B->S;
  if (kappa_end > S->d) kappa_end = S->d;
  if (B->clean_lll_ver == S->version && kappa_end <= B->clean_lll_end)
    return 1;
  if (size_red_only && B->clean_sr_ver == S->version &&
      kappa_end <= B->clean_sr_end)
    return 1;
  if (kappa_end >= 1 && !update_gso_row(S, 0, 0)) {
    B->status = RED_GSO_FAILURE;
    return 0;
  }
  if (size_red_only) {
    int k0 = B->sr_px > 1 ? B->sr_px : 1;
    for (int k = k0; k < kappa_end; k++) {
      if (!babai_bkz(B, k, 0)) return 0;
      if (!update_gso_row(S, k, k)) {
        B->status = RED_GSO_FAILURE;
        return 0;
      }
    }
    if (kappa_end > B->sr_px) B->sr_px = kappa_end;
    long v = S->version;
    if (!(B->clean_sr_ver == v && B->clean_sr_end >= kappa_end)) {
      B->clean_sr_end =
          (B->clean_sr_ver == v && B->clean_sr_end > kappa_end)
              ? B->clean_sr_end
              : kappa_end;
      B->clean_sr_ver = v;
    }
    return 1;
  }
  {
    int kappa = B->clean_px > 1 ? B->clean_px : 1;
    double lovasz[BKZ_MAXD + 1];
    long iter = 0, max_iter = (long)S->d * S->d * 4000L + 100000L;
    while (kappa < kappa_end && iter++ < max_iter) {
      if (!babai_bkz(B, kappa, 0)) return 0;
      if (!update_gso_row(S, kappa, kappa)) {
        B->status = RED_GSO_FAILURE;
        return 0;
      }
      lovasz[0] = get_gram(S, kappa, kappa);
      for (int i = 1; i <= kappa; i++)
        lovasz[i] = lovasz[i - 1] - S->mu[(size_t)kappa * S->d + (i - 1)] *
                                        S->r[(size_t)kappa * S->d + (i - 1)];
      double t = S->r[(size_t)(kappa - 1) * S->d + (kappa - 1)] * S->delta;
      t = ldexp(t, (int)(2 * (S->row_expo[kappa - 1] - S->row_expo[kappa])));
      if (t > lovasz[kappa - 1]) {
        S->n_swaps++;
        int old_k = kappa;
        kappa--;
        while (kappa > 0) {
          double tt = S->r[(size_t)(kappa - 1) * S->d + (kappa - 1)] * S->delta;
          tt = ldexp(tt,
                     (int)(2 * (S->row_expo[kappa - 1] - S->row_expo[old_k])));
          if (tt < lovasz[kappa - 1]) break;
          kappa--;
        }
        if (lovasz[kappa] > 0) {
          move_row_bkz(B, old_k, kappa);
        } else {
          B->status = RED_LLL_FAILURE; /* zero row: python handles */
          return 0;
        }
      }
      S->r[(size_t)kappa * S->d + kappa] = lovasz[kappa];
      if (S->valid[kappa] == kappa) S->valid[kappa] = kappa + 1;
      kappa++;
    }
    if (kappa < kappa_end) {
      B->status = RED_LLL_FAILURE;
      return 0;
    }
  }
  if (kappa_end > B->clean_px) B->clean_px = kappa_end;
  if (kappa_end > B->sr_px) B->sr_px = kappa_end; /* LLL implies SR */
  {
    long v = S->version;
    B->clean_lll_end = (B->clean_lll_ver == v && B->clean_lll_end > kappa_end)
                           ? B->clean_lll_end
                           : kappa_end;
    B->clean_lll_ver = v;
    if (B->clean_sr_ver != v || B->clean_sr_end < B->clean_lll_end) {
      B->clean_sr_ver = v; /* LLL-reduced implies size-reduced */
      B->clean_sr_end = B->clean_lll_end;
    }
  }
  return 1;
}

/* ---------------- rerandomization (bkz.cpp:43-80) ---------------------- */
static int rerandomize_block_c(bkz_ctx *B, int min_row, int max_row,
                               int density) {
  if (max_row - min_row < 2) return 1;
  long niter = 4L * (max_row - min_row);
  for (long it = 0; it < niter; it++) {
    int a1 = (int)rnd_below(B, max_row - min_row - 1) + min_row;
    int b1 = a1;
    while (b1 == a1) b1 = (int)rnd_below(B, max_row - min_row - 1) + min_row;
    move_row_bkz(B, b1, a1);
  }
  for (int a1 = min_row; a1 < max_row - 2; a1++)
    for (int t = 0; t < density; t++) {
      int b1 = (int)rnd_below(B, max_row - (a1 + 1) - 1) + a1 + 1;
      if (!row_addmul_exact(B, a1, b1, rnd_below(B, 2) ? 1 : -1)) return 0;
    }
  return 1;
}

/* ---------------- solution insertion (bkz.cpp:128-272) ----------------- */
/* Returns 1 = solution inserted, 0 = degenerate solution skipped (treat
   as not found), -1 = failure (overflow). */
static int svp_postprocessing_c(bkz_ctx *B, int kappa, int bs,
                                const double *solution) {
  long sol[BKZ_MAXD];
  int nz = 0, i_vector = -1;
  for (int i = 0; i < bs; i++) {
    sol[i] = lround(solution[i]);
    if (sol[i]) nz++;
  }
  for (int i = bs - 1; i >= 0; i--)
    if (sol[i] != 0 && i_vector == -1 && labs(sol[i]) == 1) i_vector = i;
  if (nz == 0 || (nz == 1 && i_vector == -1)) {
    /* all-zero, or a single nonzero with |coef| > 1 (possible from
       lround of f32 device output): the reference only debug-asserts
       here (bkz.cpp:136) — a negative i_vector would index row
       kappa - 1 out of bounds.  Treat as not found. */
    return 0;
  }
  if (nz == 1) {
    move_row_bkz(B, kappa + i_vector, kappa);
  } else if (i_vector != -1) {
    long sol_i = sol[i_vector];
    for (int i = 0; i < bs; i++)
      if (sol[i] != 0 && i != i_vector)
        if (!row_addmul_exact(B, kappa + i_vector, kappa + i, sol_i * sol[i]))
          return -1;
    move_row_bkz(B, kappa + i_vector, kappa);
  } else {
    /* tree-based GCD insertion (bkz.cpp:199-272) */
    long x[BKZ_MAXD];
    for (int i = 0; i < bs; i++) {
      x[i] = sol[i];
      if (x[i] < 0) {
        x[i] = -x[i];
        negate_row(B, i + kappa);
      }
    }
    int off = 1;
    while (off < bs) {
      int k = bs - 1;
      while (k - off >= 0) {
        if (!(x[k] == 0 && x[k - off] == 0)) {
          if (x[k] < x[k - off]) {
            long t = x[k];
            x[k] = x[k - off];
            x[k - off] = t;
            row_swap_bkz(B, kappa + k - off, kappa + k);
          }
          while (x[k - off] != 0) {
            while (x[k - off] <= x[k]) {
              x[k] -= x[k - off];
              if (!row_addmul_exact(B, kappa + k - off, kappa + k, 1))
                return -1;
            }
            {
              long t = x[k];
              x[k] = x[k - off];
              x[k - off] = t;
            }
            row_swap_bkz(B, kappa + k - off, kappa + k);
          }
        }
        k -= 2 * off;
      }
      off *= 2;
    }
    move_row_bkz(B, kappa + bs - 1, kappa);
  }
  return 1;
}

/* ---------------- window export + enumeration -------------------------- */
/* Export true mu^T / scaled rdiag for the window (export_mu_r contract,
   core/gso.py:476; normalization by 2^-normexp as enumerate_ext.cpp:67). */
static int export_window(bkz_ctx *B, int kappa, int bs, double *mut,
                         double *rdiag_s, double *log_rd_out) {
  lll_state *S = &B->S;
  long normexp = 0;
  int have = 0;
  for (int i = kappa; i < kappa + bs; i++) {
    double rii = S->r[(size_t)i * S->d + i];
    if (!(rii > 0.0) || !isfinite(rii)) {
      B->status = RED_GSO_FAILURE;
      return 0;
    }
    int ex;
    frexp(rii, &ex);
    long cur = 2 * S->row_expo[i] + (ex - 1);
    if (!have || cur > normexp) normexp = cur;
    have = 1;
  }
  normexp += normexp & 1;
  double log_rd = 0.0;
  for (int i = 0; i < bs; i++) {
    double rii = S->r[(size_t)(kappa + i) * S->d + (kappa + i)];
    rdiag_s[i] = ldexp(rii, (int)(2 * S->row_expo[kappa + i] - normexp));
    log_rd += log(rdiag_s[i]);
  }
  *log_rd_out = log_rd / bs;
  memset(mut, 0, (size_t)bs * bs * 8);
  for (int a = 0; a < bs; a++)
    for (int b1 = a + 1; b1 < bs; b1++)
      mut[(size_t)a * bs + b1] =
          ldexp(S->mu[(size_t)(kappa + b1) * S->d + (kappa + a)],
                (int)(S->row_expo[kappa + b1] - S->row_expo[kappa + a]));
  return 1;
}

/* Strategy lookup (bkz_param.cpp:62-78): pick the pruning set whose
   gh_factor is closest to radius/gh; empty/missing sets = unpruned. */
static void select_pruning(bkz_ctx *B, int bs, double ratio,
                           const double **coefs, int *ncoef, double *expect) {
  const bkz_args *a = B->a;
  *coefs = NULL;
  *ncoef = 0;
  *expect = 1.0;
  if (bs >= a->n_strat || a->ps_cnt[bs] <= 0) return;
  int base = a->ps_off[bs], cnt = a->ps_cnt[bs];
  int best = base;
  double closest = INFINITY;
  for (int s = base; s < base + cnt; s++) {
    double dd = fabs(a->ps_gh[s] - ratio);
    if (dd < closest) {
      closest = dd;
      best = s;
    }
  }
  if (a->ps_coef_len[best] >= bs) {
    *coefs = a->ps_coefs + a->ps_coef_off[best];
    *ncoef = bs;
  }
  *expect = a->ps_exp[best];
}

/* Gaussian-heuristic estimate of the bound-passing node count of a
   pruned enumeration tree (the level-volume sum the pruner's cost model
   integrates, pruner_cost.cpp:8-67, collapsed to the GH ball volumes).
   Used to price windows against the measured device-launch overhead
   BEFORE enumerating, instead of burning a budgeted C pass first.

   Depth-j of the DFS fixes the TOP j coordinates (levels bs-1 down to
   bs-j), so the j-level count divides the j-ball volume by the product
   of the LAST j Gram-Schmidt norms and is bounded by prune[bs-j]*A —
   the round-4 version accumulated from rdiag[0] (the LARGEST norms of
   a reduced basis), underestimating block-60/70 windows by 5-6 orders
   of magnitude and silently routing every production window to the
   sequential core. */
static double enum_tree_estimate(int bs, const double *rdiag,
                                 const double *prune, double A) {
  double logs = 0.0, tot = 0.0;
  for (int j = 1; j <= bs; j++) {
    logs += 0.5 * log(rdiag[bs - j]);
    double pj = prune ? prune[bs - j] : 1.0;
    double lv = (j / 2.0) * log(M_PI * pj * A) - lgamma(j / 2.0 + 1.0) - logs;
    tot += 0.5 * exp(lv);
  }
  return tot;
}

/* One window enumeration: sequential C core for trees under the device
   crossover, direct device launch for trees the GH estimate prices
   above it (the measured-crossover policy of enum/tpu.py:713-746 moved
   next to the data, minus the wasted budget pass). */
static int window_enum_c(bkz_ctx *B, int bs, const double *mut,
                         const double *rdiag, const double *prune,
                         double maxdist, double *sol, double *dist_out) {
  double nodes_lvl[BKZ_MAXD];
  double bx[BKZ_MAXD];
  memset(nodes_lvl, 0, (size_t)bs * 8);
  enum_result er;
  memset(&er, 0, sizeof(er));
  er.maxdist = maxdist;
  int dev_ok = B->cb && bs >= B->a->min_device_dim &&
               B->a->hybrid_budget > 0;
  if (dev_ok &&
      enum_tree_estimate(bs, rdiag, prune, maxdist) >
          (double)B->a->hybrid_budget) {
    /* predictably past the crossover: go straight to the device */
    double A = maxdist, ddist = INFINITY, dnodes = 0.0;
    double t0 = now_s();
    int rc0;
    for (int i = 0; i < bs; i++) B->prune_s[i] = prune ? prune[i] : 1.0;
    rc0 = B->cb(1, bs, mut, rdiag, B->prune_s, &A, B->sol_s, &ddist,
                &dnodes);
    B->a->t_dev_out += now_s() - t0;
    if (rc0) {
      B->status = -2;
      return -1;
    }
    B->nodes += dnodes;
    B->a->dev_nodes_out += dnodes;
    if (isfinite(ddist)) {
      memcpy(sol, B->sol_s, (size_t)bs * 8);
      *dist_out = ddist;
      return 1;
    }
    return 0;
  }
  /* under the crossover: the C core with a generous safety budget (the
     estimate can be off; a genuinely huge tree still escalates) */
  long long budget = dev_ok ? 16 * B->a->hybrid_budget : 0;
  er.nodes_budget = budget;
  {
    double t0 = now_s();
    int rc0 = enum_run(bs, mut, rdiag, prune, NULL, 1, 0, 0, bx,
                       nodes_lvl, &er);
    B->a->t_enum_out += now_s() - t0;
    if (rc0) {
      B->status = RED_LLL_FAILURE;
      return -1;
    }
  }
  for (int i = 0; i < bs; i++) B->nodes += nodes_lvl[i];
  int complete = !budget || er.visited < budget;
  if (complete) {
    if (er.found) {
      memcpy(sol, bx, (size_t)bs * 8);
      *dist_out = er.best_dist;
      return 1;
    }
    return 0;
  }
  /* escalate: device search with the tightened bound; the budget pass's
     incumbent stays valid if the device finds nothing better */
  {
    double A = er.maxdist;
    double ddist = INFINITY, dnodes = 0.0;
    double t0 = now_s();
    int rc;
    for (int i = 0; i < bs; i++) B->prune_s[i] = prune ? prune[i] : 1.0;
    rc = B->cb(1, bs, mut, rdiag, B->prune_s, &A, B->sol_s, &ddist,
               &dnodes);
    B->a->t_dev_out += now_s() - t0;
    if (rc != 0) {
      B->status = -2;
      return -1;
    }
    B->nodes += dnodes;
    B->a->dev_nodes_out += dnodes;
    if (isfinite(ddist) && (!er.found || ddist <= er.best_dist)) {
      memcpy(sol, B->sol_s, (size_t)bs * 8);
      *dist_out = ddist;
      return 1;
    }
    if (er.found) {
      memcpy(sol, bx, (size_t)bs * 8);
      *dist_out = er.best_dist;
      return 1;
    }
  }
  return 0;
}

/* ---------------- svp_reduction + tours (bkz.cpp:274-441) -------------- */
static int tour_c(bkz_ctx *B, const bkz_par *par, int min_row, int max_row);

/* Restore basis rows [0, nr) from a limb snapshot; only rows that
   actually differ get the (GSO-invalidating) change bookkeeping, so a
   restore that touches just the window keeps the reduced prefix memos
   alive. */
static void restore_rows_c(bkz_ctx *B, const uint64_t *save, int nr) {
  lll_state *S = &B->S;
  size_t rowsz = (size_t)S->n * S->L;
  for (int t = 0; t < nr; t++) {
    uint64_t *dst = row(S, t);
    const uint64_t *src = save + (size_t)t * rowsz;
    if (memcmp(dst, src, rowsz * 8) != 0) {
      memcpy(dst, src, rowsz * 8);
      mark_changed(B, t);
    }
  }
}

static int svp_preprocessing_c(bkz_ctx *B, int kappa, int bs,
                               const bkz_par *par);

/* Grouped rerandomized trials: ONE device launch enumerating k
 * independent retrials of the window.  The reference's retrial loop
 * (bkz.cpp:274-358) runs trials strictly sequentially because each
 * rerandomization mutates the basis; but the trials are independent by
 * construction, and the expected trial count to spend the success
 * budget is known up front (remaining * (1-p)^k <= 1 - min_success).
 * Generating all k rerandomized+preprocessed variants first and
 * enumerating them as a G=k callback amortizes the device launch
 * overhead k-fold and drops the device crossover accordingly — the
 * lockstep analogue of enumlib's many subtree walkers sharing one
 * search (fplll/enum-parallel/enumeration.h:412-505).
 *
 * Returns 0 = done (remaining/rerandomize updated, best trial's basis
 * rolled in and its solution inserted), 1 = declined (caller runs the
 * sequential trial), -1 = failure. */
static int grouped_trials_c(bkz_ctx *B, int kappa, int bs,
                            const bkz_par *par, int k, double *remaining,
                            int *rerandomize, int include_current) {
  lll_state *S = &B->S;
  int nr = kappa + bs;
  size_t rowsz = (size_t)S->n * S->L;
  size_t savesz = (size_t)nr * rowsz;
  double expect_g[64];
  if (k > 64) k = 64;
  if ((double)savesz * 8.0 * (double)(k + 1) > 5.12e8) return 1;
  /* per-trial exports live OUTSIDE the shared window scratch: the
     preprocessing recursion between trials re-enters window_enum_c and
     would clobber mut_s/prune_s slots */
  size_t per = (size_t)bs * bs + 3 * (size_t)bs + 2;
  double *gm = malloc((size_t)k * per * 8);
  uint64_t *snap = malloc(savesz * 8 * (size_t)(k + 1));
  if (!gm || !snap) {
    free(gm);
    free(snap);
    return 1;
  }
  double *g_mut = gm;                       /* k * bs * bs */
  double *g_rd = g_mut + (size_t)k * bs * bs; /* k * bs */
  double *g_pr = g_rd + (size_t)k * bs;       /* k * bs */
  double *g_sol = g_pr + (size_t)k * bs;      /* k * bs */
  double *g_amax = g_sol + (size_t)k * bs;    /* k */
  double *g_dist = g_amax + k;                /* k */
  uint64_t *trials = snap + savesz;
  memcpy(snap, S->b, savesz * 8);
  for (int g = 0; g < k; g++) {
    if (!(include_current && g == 0)) {
      /* include_current: trial 0 is the already-preprocessed state the
         caller was about to enumerate alone — fold it into the launch */
      if (!rerandomize_block_c(B, kappa + 1, kappa + bs, par->density))
        goto fail;
      if (svp_preprocessing_c(B, kappa, bs, par) < 0) goto fail;
    }
    for (int i = kappa; i < kappa + bs; i++)
      if (!update_gso_row(S, i, i)) {
        B->status = RED_GSO_FAILURE;
        goto fail;
      }
    {
      double log_rd;
      double *rd = g_rd + (size_t)g * bs;
      if (!export_window(B, kappa, bs, g_mut + (size_t)g * bs * bs, rd,
                         &log_rd))
        goto fail;
      double maxdist = B->a->radius_delta * rd[0];
      double tgh = exp(lgamma(bs / 2.0 + 1.0) * 2.0 / bs) / M_PI;
      if ((par->flags & BKZF_GH_BND) && bs > 30) {
        double f = tgh * par->gh_factor * exp(log_rd);
        if (f < maxdist) maxdist = f;
      }
      double gh1 = tgh * exp(log_rd);
      if (rd[0] < gh1) gh1 = rd[0];
      const double *coefs;
      int ncoef;
      double expect;
      select_pruning(B, bs, rd[0] / gh1, &coefs, &ncoef, &expect);
      double *pr = g_pr + (size_t)g * bs;
      for (int i = 0; i < bs; i++) pr[i] = ncoef ? coefs[i] : 1.0;
      g_amax[g] = maxdist;
      expect_g[g] = expect;
    }
    memcpy(trials + (size_t)g * savesz, S->b, savesz * 8);
    if (g < k - 1) restore_rows_c(B, snap, nr);
  }
  {
    double dnodes = 0.0;
    for (int g = 0; g < k; g++) g_dist[g] = INFINITY;
    double t0 = now_s();
    int rc = B->cb(k, bs, g_mut, g_rd, g_pr, g_amax, g_sol, g_dist,
                   &dnodes);
    B->a->t_dev_out += now_s() - t0;
    if (rc) {
      B->status = -2;
      goto fail;
    }
    B->nodes += dnodes;
    B->a->dev_nodes_out += dnodes;
    if (k > B->a->g_max_out) B->a->g_max_out = k;
    int gb = -1;
    for (int g = 0; g < k; g++)
      if (isfinite(g_dist[g]) && (gb < 0 || g_dist[g] < g_dist[gb]))
        gb = g;
    if (gb >= 0) {
      /* roll the winning trial's rerandomization+preprocessing into the
         basis and insert its solution; losing trials are discarded */
      if (gb != k - 1) restore_rows_c(B, trials + (size_t)gb * savesz, nr);
      int ins = svp_postprocessing_c(B, kappa, bs,
                                     g_sol + (size_t)gb * bs);
      if (ins < 0) goto fail;
      *rerandomize = ins ? 0 : 1;
    } else {
      *rerandomize = 1; /* the last trial's rerandomization stays, as in
                           the sequential loop */
    }
    for (int g = 0; g < k; g++) *remaining *= (1.0 - expect_g[g]);
  }
  free(gm);
  free(snap);
  return 0;
fail:
  free(gm);
  free(snap);
  return -1;
}

static int svp_preprocessing_c(bkz_ctx *B, int kappa, int bs,
                               const bkz_par *par) {
  if (!lll_in_state(B, kappa + bs, 0)) return -1;
  if (bs < B->a->n_strat) {
    const bkz_args *a = B->a;
    int off = a->pre_off[bs], len = a->pre_len[bs];
    for (int t = 0; t < len; t++) {
      bkz_par prepar = {a->pre_data[off + t], BKZF_GH_BND, 1.1, 0.5, 3};
      if (tour_c(B, &prepar, kappa, kappa + bs) < 0) return -1;
    }
  }
  return 0;
}

static int svp_reduction_c(bkz_ctx *B, int kappa, int bs,
                           const bkz_par *par) {
  lll_state *S = &B->S;
  int first = kappa;
  if (bs > BKZ_MAXD || kappa + bs > S->d) {
    B->status = RED_LLL_FAILURE;
    return -1;
  }
  if (B->fault_after > 0 && ++B->windows_done >= B->fault_after) {
    /* test-only fault injection (FPLLL_TPU_BKZ_FAULT): abort the native
       tour mid-way with the basis holding valid partial progress, so the
       Python redo path can be exercised deterministically */
    B->status = RED_LLL_FAILURE;
    return -1;
  }
  if (!lll_in_state(B, first + 1, 1)) return -1;
  if (!update_gso_row(S, first, first)) {
    B->status = RED_GSO_FAILURE;
    return -1;
  }
  double old_first = S->r[(size_t)first * S->d + first];
  long old_e = 2 * S->row_expo[first];
  int rerandomize = 0;
  double remaining = 1.0;
  double last_est = -1.0, last_expect = 1.0;
  while (remaining > 1.0 - par->min_succ) {
    if (rerandomize) {
      /* retrial: if the remaining trials would each price past the
         device crossover as a group, launch them all at once */
      if (B->cb && bs >= B->a->min_device_dim && B->a->hybrid_budget > 0 &&
          B->a->trial_batch_max >= 2 && last_est > 0.0 &&
          last_expect > 1e-9 && last_expect < 0.999) {
        double lg = log(1.0 - last_expect);
        double tgt = 1.0 - par->min_succ;
        int k = (int)ceil(log(tgt / remaining) / lg);
        if (k < 1) k = 1;
        if (k > B->a->trial_batch_max) k = B->a->trial_batch_max;
        /* speculate only up to the trials expected BEFORE the first
           success (~1/2p): a success re-prices the window (improved
           basis -> higher expect, cheaper preprocessing), so trials
           budgeted past it usually never run sequentially — each
           speculative trial costs a full host preprocessing pass */
        {
          int kcap = (int)ceil(0.5 / last_expect);
          if (kcap < 2) kcap = 2;
          if (k > kcap) k = kcap;
        }
        if (getenv("FPLLL_TPU_BKZ_DEBUG"))
          fprintf(stderr,
                  "[bkz grouped?] kappa=%d bs=%d k=%d est=%.3g expect=%.3g "
                  "remaining=%.3g budget=%lld\n",
                  kappa, bs, k, last_est, last_expect, remaining,
                  B->a->hybrid_budget);
        if (k >= 2 &&
            (double)k * last_est > 2.5 * (double)B->a->hybrid_budget) {
          /* grouped launches only pay off on genuinely large unions:
             mid-size unions run at launch-overhead-dominated rates that
             barely beat the sequential core (round-5 measurement) */
          int grc = grouped_trials_c(B, kappa, bs, par, k, &remaining,
                                     &rerandomize, 0);
          if (grc < 0) return -1;
          if (grc == 0) continue;
        }
      }
      if (!rerandomize_block_c(B, kappa + 1, kappa + bs, par->density))
        return -1;
    }
    if (svp_preprocessing_c(B, kappa, bs, par) < 0) return -1;
    for (int i = kappa; i < kappa + bs; i++)
      if (!update_gso_row(S, i, i)) {
        B->status = RED_GSO_FAILURE;
        return -1;
      }
    double log_rd;
    if (!export_window(B, kappa, bs, B->mut_s, B->rdiag_s, &log_rd))
      return -1;
    double maxdist = B->a->radius_delta * B->rdiag_s[0];
    double tgh = exp(lgamma(bs / 2.0 + 1.0) * 2.0 / bs) / M_PI;
    if ((par->flags & BKZF_GH_BND) && bs > 30) {
      double f = tgh * par->gh_factor * exp(log_rd);
      if (f < maxdist) maxdist = f;
    }
    /* pruning-set selection: ratio of r_kk to the GH-clamped radius at
       gh factor 1.0 (bkz.cpp:82-98 via Strategy::get_pruning) */
    double gh1 = tgh * exp(log_rd);
    if (B->rdiag_s[0] < gh1) gh1 = B->rdiag_s[0];
    const double *coefs;
    int ncoef;
    double expect;
    select_pruning(B, bs, B->rdiag_s[0] / gh1, &coefs, &ncoef, &expect);
    last_est = enum_tree_estimate(bs, B->rdiag_s, ncoef ? coefs : NULL,
                                  maxdist);
    last_expect = expect;
    /* a device-worthy window expecting several trials launches them ALL
       together, with the current (already preprocessed) state as trial
       0 — a standalone first launch would pay the overhead twice */
    if (B->cb && bs >= B->a->min_device_dim && B->a->hybrid_budget > 0 &&
        B->a->trial_batch_max >= 2 && expect > 1e-9 && expect < 0.999 &&
        last_est > (double)B->a->hybrid_budget) {
      double lg = log(1.0 - expect);
      int k = (int)ceil(log((1.0 - par->min_succ) / remaining) / lg);
      if (k > B->a->trial_batch_max) k = B->a->trial_batch_max;
      {
        int kcap = (int)ceil(0.5 / expect); /* see the retrial cap */
        if (kcap < 2) kcap = 2;
        if (k > kcap) k = kcap;
      }
      if (k >= 2 &&
          (double)k * last_est > 2.5 * (double)B->a->hybrid_budget) {
        int grc = grouped_trials_c(B, kappa, bs, par, k, &remaining,
                                   &rerandomize, 1);
        if (grc < 0) return -1;
        if (grc == 0) continue;
      }
    }
    {
      double sol[BKZ_MAXD], dist;
      int found = window_enum_c(B, bs, B->mut_s, B->rdiag_s,
                                ncoef ? coefs : NULL, maxdist, sol, &dist);
      if (found < 0) return -1;
      if (found) {
        int ins = svp_postprocessing_c(B, kappa, bs, sol);
        if (ins < 0) return -1;
        rerandomize = ins ? 0 : 1;
      } else {
        rerandomize = 1;
      }
    }
    remaining *= (1.0 - expect);
  }
  if (!lll_in_state(B, first + 1, 1)) return -1;
  if (!update_gso_row(S, first, first)) {
    B->status = RED_GSO_FAILURE;
    return -1;
  }
  {
    double nf = ldexp(S->r[(size_t)first * S->d + first],
                      (int)(2 * S->row_expo[first] - old_e));
    return old_first <= nf ? 1 : 0;
  }
}

static int tour_c(bkz_ctx *B, const bkz_par *par, int min_row, int max_row) {
  int clean = 1;
  for (int kappa = min_row; kappa < max_row - par->block_size; kappa++) {
    int c = svp_reduction_c(B, kappa, par->block_size, par);
    if (c < 0) return -1;
    clean &= c;
  }
  {
    int hkz_start = max_row - par->block_size;
    if (hkz_start < 0) hkz_start = 0;
    for (int kappa = hkz_start; kappa < max_row - 1; kappa++) {
      int c = svp_reduction_c(B, kappa, max_row - kappa, par);
      if (c < 0) return -1;
      clean &= c;
    }
  }
  /* stall fix (bkz.cpp:435-438; fpylll issue 73): size-reduce the last
     row against its predecessor only */
  if (max_row >= 2)
    if (!babai_bkz(B, max_row - 1, max_row - 2)) return -1;
  return clean;
}

/* expose lll_core's babai micro-profile: [t_update_gso_row, t_redloop,
   t_bf_refresh, calls, iters] */
void bkz_prof(double *out) {
  out[0] = g_t_ugr;
  out[1] = g_t_red;
  out[2] = g_t_bf;
  out[3] = (double)g_babai_calls;
  out[4] = (double)g_babai_iters;
  out[5] = g_t_rowop;
  out[6] = (double)g_rowops;
}

/* ---------------- entry ------------------------------------------------ */
int bkz_tour_native(bkz_args *a, uint64_t *bdata, enum_dev_cb cb) {
  if (a->d < 1 || a->d > BKZ_MAXD || a->n > 4096 || a->L > BKZ_MAXD)
    return OVERFLOW_FAILURE;
  bkz_ctx B;
  memset(&B, 0, sizeof(B));
  lll_state *S = &B.S;
  B.a = a;
  B.cb = cb;
  B.rng = a->seed ? a->seed : 0x6a09e667f3bcc909ULL;
  B.clean_lll_ver = B.clean_sr_ver = -1;
  S->d = a->d;
  S->n = a->n;
  S->L = a->L;
  S->b = bdata;
  S->u = NULL;
  S->delta = a->lll_delta;
  S->eta = a->lll_eta;
  int d = a->d, n = a->n, L = a->L;
  int mx = n > d ? n : d;
  S->bf = malloc((size_t)d * n * 8);
  S->gf = malloc((size_t)d * d * 8);
  S->mu = calloc((size_t)d * d, 8);
  S->r = calloc((size_t)d * d, 8);
  S->row_expo = calloc((size_t)d, sizeof(long));
  S->valid = calloc((size_t)d, sizeof(int));
  S->tmp = malloc((size_t)L * 8);
  S->rowtmp = malloc((size_t)(n + d) * L * 8);
  S->lw = malloc((size_t)d * sizeof(int)); /* NULL tolerated */
  B.dtmp = malloc((size_t)mx * 8);
  B.btmp = malloc((size_t)mx * L * 8);
  int gmax = a->trial_batch_max > 0 ? a->trial_batch_max : 1;
  B.mut_s = malloc((size_t)gmax * d * d * 8);
  B.rdiag_s = malloc((size_t)gmax * d * 8);
  B.prune_s = malloc((size_t)gmax * d * 8);
  B.amax_s = malloc((size_t)gmax * 8);
  B.sol_s = malloc((size_t)gmax * d * 8);
  B.dist_s = malloc((size_t)gmax * 8);
  int status = RED_SUCCESS;
  if (!S->bf || !S->gf || !S->mu || !S->r || !S->row_expo || !S->valid ||
      !S->tmp || !S->rowtmp || !B.dtmp || !B.btmp || !B.mut_s ||
      !B.rdiag_s || !B.prune_s || !B.amax_s || !B.sol_s || !B.dist_s) {
    status = OVERFLOW_FAILURE;
    goto done;
  }
  for (int i = 0; i < d; i++) update_bf(S, i);
  for (size_t i = 0; i < (size_t)d * d; i++) S->gf[i] = NAN;
  S->n_known_rows = d;
  a->t_enum_out = a->t_dev_out = a->t_lll_out = a->t_misc_out = 0.0;
  a->t_babai_out = a->t_move_out = 0.0;
  a->dev_nodes_out = 0.0;
  a->g_max_out = 0;
  {
    const char *fe = getenv("FPLLL_TPU_BKZ_FAULT");
    B.fault_after = fe ? atol(fe) : 0;
  }
  double t_start = now_s();
  {
    bkz_par par = {a->block_size, a->flags, a->gh_factor, a->min_succ,
                   a->density};
    int c = tour_c(&B, &par, a->min_row, a->max_row);
    if (c < 0)
      status = B.status ? B.status : RED_LLL_FAILURE;
    else
      a->clean_out = c;
  }
done:
  a->t_misc_out = (now_s() - t_start) - a->t_enum_out - a->t_dev_out -
                  a->t_lll_out;
  a->nodes_out = B.nodes;
  a->n_swaps_out = S->n_swaps;
  free(S->bf);
  free(S->gf);
  free(S->mu);
  free(S->r);
  free(S->row_expo);
  free(S->valid);
  free(S->tmp);
  free(S->rowtmp);
  free(S->lw);
  free(B.dtmp);
  free(B.btmp);
  free(B.mut_s);
  free(B.rdiag_s);
  free(B.prune_s);
  free(B.amax_s);
  free(B.sol_s);
  free(B.dist_s);
  return status;
}
