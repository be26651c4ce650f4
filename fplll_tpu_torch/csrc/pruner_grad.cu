/*
 * pruner_grad.cu - the pruner's analytic gradient on the card, for Hopper
 * (sm_90a), bound with ctypes through a plain C interface.
 *
 * Replaces: fplll_tpu/pruner/jaxgrad.py:_build (29), the jax.grad of the
 * pruning log-target that XLA compiles into one device program, and which
 * the port's plain version (pruner/torchgrad.py) runs eagerly as a
 * torch.autograd graph of several thousand small kernels. One launch of
 * pruner_grad_kernel computes, for one (d, metric, symmetry factor, shell
 * ratio) and one b, ipv, radius, target and preprocessing cost:
 *   - the even-simplex relative volume of every prefix rd = 1..d of b
 *     (pruner_simplex.h:28-46 of the reference), and for the probability
 *     metric that of the whole shell-shrunk profile min(b / dx^2, 1);
 *   - cost_evec's 2d terms, svp_prob or exp_solutions, the trials, the
 *     clips and the log of the total cost: the log-target;
 *   - its gradient with respect to b, by the adjoint written out by hand.
 * out[0] is the log-target, out[1..d] the gradient.
 *
 * Parity: a step of row r (rd = r + 1 steps, the prefix volume of
 * b[0..rd-1]; row d is the shell-shrunk profile, rd = d) shifts the row's
 * polynomial P up by one, scales it by 1 / (c + 1), and evaluates the
 * shifted polynomial at x = b[i] * (1 / b[rd-1]) by Horner, high
 * coefficient first, each step one fused multiply-add: the order and the
 * fusion of jaxgrad's scan and of torchgrad's addcmul. The recurrence
 * cancels catastrophically as d grows, so any other order of these
 * operations moves the result far beyond the rounding of one operation.
 * Every other operation rounds on its own (-fmad=false), in the order
 * torch.autograd takes it in the plain version, so the kernel and the
 * plain version differ only where a sum is taken in another order.
 *
 * Layout: one block of 96 threads. Warp 0 runs the recurrence, one lane
 * per row (d rows, d + 1 with the probability metric, at most 31 lanes),
 * with the row's d + 2 <= 32 coefficients, the factors 1 / (k + 1) and,
 * going backward, the coefficients' adjoints in registers: a step is
 * straight-line code over constant register indices, nothing goes to
 * local memory, and a Horner position is one fma instruction that serves
 * every row at once. Every row's step j has the same degree, so the lanes
 * stay converged: forward, every lane runs every step and a row keeps its
 * value after its step rd - 1; backward, a row starts at its step rd - 1.
 * The steps run in bands of PG_BAND that share one length of code
 * (below), one loop body per band: a copy of the code per step ran slower
 * on the card, its code fetched anew at every launch. Meanwhile warps 1
 * and 2 compute the parts of the cost terms that need no volume (the pow
 * calls, one term a thread). The scalar chain (the log, the
 * trials, the probability or the expected solutions) runs in one thread,
 * the 2d cost terms and their adjoints one thread each, then warp 0 runs
 * every row backwards over its steps from a tape of the Horner
 * intermediates a_k in shared memory laid out [step][k][lane]: the 31
 * lanes read and write consecutive doubles, two wavefronts and no bank
 * conflict. Step j keeps a_0..a_{j+1}, d (d + 3) / 2 x 32 doubles: 127 KB
 * at d = 30, 150 KB with everything else, of the 227 KB a block can
 * address. The per-row contributions to dlog/db are summed in a fixed
 * order by one thread per coordinate: no atomics, the same bits on every
 * call. The clips have jnp.maximum / minimum / clip's gradient (1 inside,
 * 1/2 on a bound, 0 outside) and keep a NaN, so a non-finite input gives
 * a non-finite gradient where jaxgrad's does.
 *
 * The short Horner. At step j only coefficients 1..j + 1 of the shifted
 * polynomial can be nonzero: those above are +0, and the top one is
 * 1 / (j + 1)!, never zero. The full-length Horner (the plain version's)
 * starts at coefficient d + 1; for finite x, fma(+0, x, +0) is +0, so its
 * intermediates above j + 1 are +0 and it reaches fma(+0, x, c_{j+1}) =
 * c_{j+1} exactly as the short one does, which starts there; for a
 * non-finite x both give NaN from that position down. The backward
 * reads only coefficients' adjoints up to j (those above never reach the
 * volume), and its gx sum adds ga_k * (+0) for the k the short one skips:
 * ga_k = ga_0 x^k can overflow there when |x| > 1, and -0 + +0 is +0, so
 * a step whose |x| exceeds 1 (or is NaN), whose ga_0 is not finite, or
 * whose short gx sum is zero runs those trailing terms as the full length
 * does. The two are then the same bits (tests/test_torch_pruner_kernel.py
 * builds this source with PRUNER_GRAD_FULL_HORNER and compares).
 *
 * What bounds it: not the 0.26 M f64 operations at d = 30 (7.8 ns at the
 * card's f64 rate), nor the bytes (a few KB), but one warp's dependent
 * chains and the instructions issued between their links: at d = 30 the
 * longest row runs 540 dependent multiply-adds forward and a ga chain of
 * 510 multiplies backward (its bands' positions), each link at the f64
 * unit's dependent latency, with the shift, the tape's loads and stores
 * and the gp updates issued by the same warp in between; then the scalar
 * chain (log1p, log, exp) in one thread and seven barriers. Built with
 * PRUNER_GRAD_PROFILE (chip_smoke.py's breakdown; never the library the
 * package loads), pruner_grad_launch_clocked also reports the SM clock at
 * each phase boundary. No tensor cores: a matrix form of the recurrence
 * would reorder its cancelling sums, which parity forbids. No cluster and
 * no second SM: the rows are independent, but the longest row is the
 * critical path, and one warp already runs all rows side by side. The
 * launch and the two copies around it set the wrapper's time.
 */

#include <cuda_runtime.h>
#include <math.h>

#define PRUNER_GRAD_MAX_D 30  /* d + 2 coefficients in one lane's registers */
#define PG_COEF (PRUNER_GRAD_MAX_D + 2)
#define PG_THREADS 96
#define PG_BAND 4  /* steps that share one length of code (see below) */
#define PG_BANDS ((PRUNER_GRAD_MAX_D + PG_BAND - 1) / PG_BAND)

/* PRUNER_GRAD_FULL_HORNER (a test build only): every Horner over all d + 2
   coefficients (from acc = 0, one multiply-add each, as jaxgrad's scan)
   and its adjoint over all of them; its tape, d (d + 2) x 32 doubles,
   outgrows a block at d = 30 */
#ifdef PRUNER_GRAD_FULL_HORNER
#define PG_FULL 1
#else
#define PG_FULL 0
#endif

/* The kernel's arguments. tab: fact[0..d], ballv[0..2d+1], kinv[0..d]
   (1 / (k + 1)), uploaded once per (d, metric, symmetry, shell ratio);
   in: b[0..d-1], ipv[0..2d-1], radius, target, preproc_cost,
   log1p(-target), log(radius), one host-to-device copy per call; out:
   the log-target and its d partial derivatives. sf, dx2 (shell_ratio^2),
   dxn (shell_ratio^(2d)) and log_sf (log sf) are computed on the host as
   the plain version computes them. */
struct PrunerGradParams {
  const double *tab;
  const double *in;
  double *out;
  int d;
  int prob;  /* probability-of-shortest metric (else expected solutions) */
  double sf, dx2, dxn, log_sf;
#ifdef PRUNER_GRAD_PROFILE
  long long *clocks;  /* PG_CLOCKS phase-boundary SM clocks, or null */
#endif
};

/* Shared memory of a launch, in doubles, and the offsets of its arrays. */
struct PgLayout {
  int rows;
  int tape, b, bm, wbm, kinv, vols, gvol, gB, term, sc, clk, total;
};

/* term arrays, each 2d long, in this order from PgLayout::term */
enum { T_RV, T_RP, T_M, T_WM, T_SQ, T_PW, T_L2, T_TMP, T_GRV, T_GB, T_EV,
       T_WEV, T_COUNT };
/* scalars of the chain, from PgLayout::sc */
enum { S_GCOST, S_GODD, S_GVD, S_GBLAST, S_VALUE,
       /* the expected-solutions chain's logs that need no volume */
       S_LBALL, S_MB, S_WMB, S_LMB, S_LIPV, S_COUNT };
/* the phase boundaries whose SM clock a PRUNER_GRAD_PROFILE launch can
   report: the start,
   after the profiles, warp 0's forward, warp 1's pow calls (warp 2's
   end in the next), the second barrier, the terms, the scalar chain, the
   terms' adjoint, the volumes' adjoints, warp 0's backward, the barrier
   after it, the end */
#define PG_CLOCKS 12
#ifdef PRUNER_GRAD_PROFILE
#define PG_PROFILE 1
#else
#define PG_PROFILE 0
#endif

/* first tape slot of step j (a slot is 32 doubles, one per lane): step j
   keeps a_0..a_{j+1}, the full build a_0..a_{d+1} */
__host__ __device__ inline int pg_tape_step(int j, int d) {
  return PG_FULL ? j * (d + 2) : j * (j + 3) / 2;
}

__host__ __device__ inline PgLayout pg_layout(int d, int prob) {
  PgLayout L;
  L.rows = d + (prob ? 1 : 0);
  int o = 0;
  /* the tape, then 32 slots that a band's last positions may read */
  L.tape = o; o += 32 * (pg_tape_step(d, d) + 32);
  L.b = o; o += d;
  L.bm = o; o += d;
  L.wbm = o; o += d;
  L.kinv = o; o += d + 1;
  L.vols = o; o += L.rows;
  L.gvol = o; o += L.rows;
  /* [row][i]: row r's dlog/db[i]; a step's lanes write 32 r + r - j and
     a coordinate's threads read 32 r + i, both without bank conflicts */
  L.gB = o; o += 32 * L.rows;
  L.term = o; o += T_COUNT * 2 * d;
  L.sc = o; o += S_COUNT;
  L.clk = o; o += PG_PROFILE ? PG_CLOCKS : 0;
  L.total = o;
  return L;
}

#ifdef __CUDACC__
__device__ __forceinline__ double *pg_smem() {
  extern __shared__ __align__(16) double pg_shared[];
  return pg_shared;
}
#else
void *dynamic_smem(); /* the host emulation's per-block buffer */
inline double *pg_smem() { return static_cast<double *>(dynamic_smem()); }
#endif
#if defined(__CUDACC__) && defined(PRUNER_GRAD_PROFILE)
/* the SM's clock at phase boundary `slot`, written by thread `tid` once
   its warp has converged (every thread of that warp calls it) */
#define PG_STAMP(slot, tid)                                        \
  do {                                                             \
    __syncwarp();                                                  \
    if (threadIdx.x == (tid))                                      \
      reinterpret_cast<long long *>(sm + L.clk)[slot] = clock64(); \
  } while (0)
#else
#define PG_STAMP(slot, tid) do { } while (0)
#endif

/* after a run of shared-memory loads into registers: ptxas would sink
   each load to just before its use and the warp would wait out its
   latency at every use; no load moves below a fence, so the run's
   latency is paid once */
__device__ __forceinline__ void pg_loads_issued() {
#ifdef __CUDACC__
  __threadfence_block();
#endif
}

namespace {

/* max(x, lo) with the plain version's gradient weight (torchgrad._Clip):
   1 above lo, 1/2 on it, 0 below; a NaN stays NaN, with weight 0 */
__device__ __forceinline__ double clip_lo(double x, double lo, double *w) {
  *w = x > lo ? 1.0 : (x == lo ? 0.5 : 0.0);
  return x < lo ? lo : x;
}

__device__ __forceinline__ double clip_hi(double x, double hi, double *w) {
  *w = x < hi ? 1.0 : (x == hi ? 0.5 : 0.0);
  return x > hi ? hi : x;
}

/* one lane's row: its profile (b, or the shrunk one for row d), its
   number of steps (0: no row) and 1 / B[rd-1] */
struct PgRow {
  const double *B;
  int rd;
  double binv;
};

/* The steps run in bands of PG_BAND: every step of a band runs the
   positions its last step needs, as straight-line code with constant
   register indices, so the code is one loop body per band and holds no
   branch per position. A step's positions above its own run on +0
   coefficients (forward: no bit changes, see the header, and nothing is
   stored) or add -0.0 (backward: x + -0.0 is x for every x, -0, NaN and
   the infinities included). The full build runs every step at the full
   length. */

/* forward step of the lane's row over positions NPOS-1..0: P <- the
   shifted, scaled polynomial with P[0] = -(its value at x), the
   Horner's a_0..a_top on the tape slab `ta` */
template <int NPOS, int TOP0>  /* TOP0 <= top: a known floor */
__device__ __forceinline__ void forward_step(double (&P)[PG_COEF],
                                             const double (&kv)[PG_COEF - 1],
                                             double x, double *ta, int top) {
  double acc = 0.0;
#pragma unroll
  for (int k = NPOS - 1; k >= 1; --k) {
    P[k] = P[k - 1] * kv[k - 1];  /* the shift, top first */
    acc = fma(acc, x, P[k]);
    if (k <= TOP0 || k <= top) ta[32 * k] = acc;
  }
  acc = fma(acc, x, 0.0);
  ta[0] = acc;
  P[0] = -acc;
}

/* the forward steps j of band BAND (and of the bands after it). Every
   lane runs every step, so that the warp never diverges: a row's value,
   P[0] after its step rd - 1, is kept in p0, and the steps after it run on
   junk and store into tape slots (step >= rd) that no one reads. */
template <int BAND>
__device__ __forceinline__ void forward_band(double (&P)[PG_COEF],
                                             double &p0,
                                             const double (&kv)[PG_COEF - 1],
                                             const PgRow &row, double *tape,
                                             int d) {
  constexpr int j1 = PG_FULL ? PRUNER_GRAD_MAX_D : (BAND + 1) * PG_BAND;
  constexpr int npos = PG_FULL || j1 + 1 > PG_COEF ? PG_COEF : j1 + 1;
  int j = PG_FULL ? 0 : BAND * PG_BAND;
  double bj = row.B[row.rd - 1 - j];  /* b[i] of step j, read a step ahead
                                         (in shared memory for any lane) */
#pragma unroll 1
  for (; j < j1 && j < d; ++j) {
    const double bn = row.B[row.rd - 2 - j];
    forward_step<npos, PG_FULL ? 0 : BAND * PG_BAND + 1>(
        P, kv, bj * row.binv, tape + 32 * pg_tape_step(j, d),
        PG_FULL ? d + 1 : j + 1);
    if (j == row.rd - 1) p0 = P[0];
    bj = bn;
  }
  if constexpr (!PG_FULL && BAND + 1 < PG_BANDS)
    forward_band<BAND + 1>(P, p0, kv, row, tape, d);
}

/* the end of a backward step, taken a step later (see backward_step) */
struct PgStepEnd {
  double gx, x, Bi, ga0;
  int j;
};

/* the first step's predecessor: an end that changes nothing read (it
   stores to the row's coordinate rd, which no sum reads) */
__device__ __forceinline__ PgStepEnd pg_no_step_end() {
  return PgStepEnd{1.0, 0.0, 0.0, 0.0, -1};
}

/* step e.j's end: the full length's trailing terms of its gx where they
   can change it, then gbinv and the row's dlog/db[rd-1-j] to gB */
__device__ __forceinline__ void finish_step(const PgStepEnd &e,
                                            double &gbinv, const PgRow &row,
                                            double *gB, int d) {
  double gx = e.gx;
  /* ga_k * (+0) for k = j + 1..d (see the header), ga_k again by the same
     multiplications */
  if (!PG_FULL && (!(fabs(e.x) <= 1.0 && isfinite(e.ga0)) || gx == 0.0)) {
    double ga = e.ga0;
#pragma unroll 1
    for (int k = 0; k <= d; ++k) {
      if (k > e.j) gx = gx + ga * 0.0;
      ga = ga * e.x;
    }
  }
  gbinv = e.j == row.rd - 1 ? gx * e.Bi : gbinv + gx * e.Bi;
  double g = gx * row.binv;
  if (e.j == 0) g = g + -gbinv * (row.binv * row.binv);
  gB[row.rd - 1 - e.j] = g;
}

/* backward step j of the lane's row over positions 0..Q-1, those above
   `last` masked: gp (the adjoint of P after step j) becomes that of P
   before it (the coefficients' adjoints above j stay junk that no later
   step reads). The step's end waits in `end` and is taken while the next
   step's tape loads are in flight, off the chains. */
template <int Q, int LAST0>  /* LAST0 <= last: a known floor */
__device__ __forceinline__ void backward_step(double (&gp)[PG_COEF],
                                              double &gbinv, PgStepEnd &end,
                                              const double (&kv)[PG_COEF - 1],
                                              const PgRow &row,
                                              const double *ta, double *gB,
                                              double Bi, int j, int d) {
  const int last = PG_FULL ? d : j;
  const double x = Bi * row.binv;
  double a[Q];  /* the step's tape, a_1..a_Q */
#pragma unroll
  for (int k = 0; k < Q; ++k) a[k] = ta[32 * (k + 1)];
  pg_loads_issued();
  finish_step(end, gbinv, row, gB, d);  /* step j + 1's */
  const double ga0 = -gp[0];  /* d acc */
  double ga = ga0, gx = 0.0;  /* ga_k = ga_{k-1} x, unmasked: the chain */
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    const double t = ga * a[k];
    if (k > 0) gp[k - 1] = (gp[k] + ga) * kv[k - 1];
    gx = k == 0 ? t : gx + (k <= LAST0 || k <= last ? t : -0.0);
    ga = ga * x;
  }
  end = PgStepEnd{gx, x, Bi, ga0, j};
}

/* the backward steps j of band BAND (and of the bands before it) */
template <int BAND>
__device__ __forceinline__ void backward_band(double (&gp)[PG_COEF],
                                              double &gbinv, PgStepEnd &end,
                                              const double (&kv)[PG_COEF - 1],
                                              const PgRow &row,
                                              const double *tape, double *gB,
                                              int d) {
  constexpr int j1 = PG_FULL ? PRUNER_GRAD_MAX_D : (BAND + 1) * PG_BAND;
  constexpr int q = PG_FULL || j1 > PG_COEF - 1 ? PG_COEF - 1 : j1;
  int j = (j1 < d ? j1 : d) - 1;
  double bj = row.B[row.rd - 1 - j];  /* read a step ahead, as forward */
#pragma unroll 1
  for (; j >= (PG_FULL ? 0 : BAND * PG_BAND); --j) {
    const double bn = row.B[row.rd - j];
    if (j < row.rd)
      backward_step<q, PG_FULL ? 0 : BAND * PG_BAND>(
          gp, gbinv, end, kv, row, tape + 32 * pg_tape_step(j, d), gB, bj,
          j, d);
    bj = bn;
  }
  if constexpr (!PG_FULL && BAND > 0)
    backward_band<BAND - 1>(gp, gbinv, end, kv, row, tape, gB, d);
}

}  // namespace

__global__ void __launch_bounds__(PG_THREADS)
    pruner_grad_kernel(PrunerGradParams P) {
  const int d = P.d, tid = threadIdx.x;
  const PgLayout L = pg_layout(d, P.prob);
  double *sm = pg_smem();
  const double *fact = P.tab, *ballv = P.tab + d + 1;
  const double *ipv = P.in + d;
  const double radius = P.in[3 * d], target = P.in[3 * d + 1],
               preproc = P.in[3 * d + 2], log1p_target = P.in[3 * d + 3],
               log_radius = P.in[3 * d + 4];
  double *term = sm + L.term, *sc = sm + L.sc;
  const double *kinv = sm + L.kinv;
  const int n2 = 2 * d;
  PG_STAMP(0, 0);

  // -- the profiles ------------------------------------------------------
  if (tid < d) {
    const double bi = P.in[tid];
    sm[L.b + tid] = bi;
    if (P.prob) {
      double w;
      sm[L.bm + tid] = clip_hi(bi / P.dx2, 1.0, &w);
      sm[L.wbm + tid] = w;
    }
  }
  if (tid <= d) sm[L.kinv + tid] = P.tab[3 * d + 3 + tid];
  __syncthreads();
  PG_STAMP(1, 0);

  // -- forward: warp 0, one lane per row; warps 1-2: the pow calls ------
  const int lane = tid & 31;
  PgRow row;
  row.rd = lane < d ? lane + 1 : (P.prob && lane == d ? d : 0);
  row.B = sm + (lane < d ? L.b : L.bm);
  row.binv = row.rd > 0 ? 1.0 / row.B[row.rd - 1] : 0.0;
  const double sign = (row.rd & 1) ? -1.0 : 1.0;
  double *tape = sm + L.tape + lane;
  double kv[PG_COEF - 1];  /* warp 0: kinv in registers */
  if (tid < 32) {
#pragma unroll
    for (int k = 0; k < PG_COEF - 1; ++k) kv[k] = k <= d ? kinv[k] : 0.0;
    double Pc[PG_COEF];
    Pc[0] = 1.0;
#pragma unroll
    for (int k = 1; k < PG_COEF; ++k) Pc[k] = 0.0;
    double p0 = 0.0;
    forward_band<0>(Pc, p0, kv, row, tape, d);
    if (row.rd > 0) sm[L.vols + lane] = sign * p0 * fact[row.rd];
    PG_STAMP(2, 0);
  } else {
    for (int i = tid - 32; i < n2; i += PG_THREADS - 32) {
      double wm;
      const double m = clip_lo(sm[L.b + i / 2], 1e-300, &wm);
      term[T_RP * n2 + i] = pow(radius, (double)i + 1.0);
      term[T_M * n2 + i] = m;
      term[T_WM * n2 + i] = wm;
      term[T_SQ * n2 + i] = sqrt(pow(m, 1.0 + (double)i));
      term[T_PW * n2 + i] = pow(m, (double)i);
    }
    if (tid == PG_THREADS - 1 && !P.prob) {
      double wmb;
      const double mb = clip_lo(sm[L.b + d - 1], 1e-300, &wmb);
      sc[S_LBALL] = log(ballv[n2]);
      sc[S_MB] = mb;
      sc[S_WMB] = wmb;
      sc[S_LMB] = log(mb);
      sc[S_LIPV] = log(ipv[n2 - 1]);
    }
    PG_STAMP(3, 32);
  }
  __syncthreads();
  PG_STAMP(4, 0);

  // -- cost_evec's terms, one thread each ---------------------------------
  const double *vols = sm + L.vols;
  if (tid < n2) {
    const int i = tid;
    double rv;
    if (i == 0) {
      rv = 1.0;
    } else if (i & 1) {
      rv = vols[(i - 1) / 2];
    } else {
      const int e = i / 2 - 1;
      double w;
      rv = sqrt(clip_lo(vols[e] * vols[e + 1], 1e-300, &w));
      term[T_EV * n2 + e] = rv;
      term[T_WEV * n2 + e] = w;
    }
    const double L2 = term[T_RP * n2 + i] * rv * ballv[i + 1];
    term[T_RV * n2 + i] = rv;
    term[T_L2 * n2 + i] = L2;
    term[T_TMP * n2 + i] = L2 * term[T_SQ * n2 + i] * ipv[i] * P.sf;
  }
  __syncthreads();
  PG_STAMP(5, 0);

  // -- the scalar chain and its adjoint, one thread ------------------------
  if (tid == 0) {
    double t[2 * PRUNER_GRAD_MAX_D];
#pragma unroll
    for (int i = 0; i < 2 * PRUNER_GRAD_MAX_D; ++i)
      t[i] = term[T_TMP * n2 + (i < n2 ? i : 0)];
    pg_loads_issued();
    double cost = 0.0;  /* in order; + -0.0 beyond n2 changes no bit */
#pragma unroll
    for (int i = 0; i < 2 * PRUNER_GRAD_MAX_D; ++i)
      cost += i < n2 ? t[i] : -0.0;
    double trials_raw, g_odd = 0.0, g_vd = 0.0, g_blast = 0.0;
    /* the metric's forward; its adjoint below needs these */
    double p = 0.0, wp = 0.0, rl1 = 0.0, vc = 0.0, wv = 0.0, mb = 0.0,
           wmb = 0.0, e = 0.0, we = 0.0, rec = 0.0;
    if (P.prob) {
      const double dvol = P.dxn * vols[d] - vols[d - 1];
      double wlo, whi;
      p = clip_lo(dvol / (P.dxn - 1.0), 1e-12, &wlo);
      p = clip_hi(p, 0.999999, &whi);
      wp = wlo * whi;
      rl1 = 1.0 / log1p(-p);
      trials_raw = rl1 * log1p_target;
    } else {
      vc = clip_lo(vols[d - 1], 1e-300, &wv);
      double t = log(vc);
      t = t + sc[S_LBALL];
      mb = sc[S_MB];
      wmb = sc[S_WMB];
      t = t + (log_radius + sc[S_LMB] / 2.0) * (double)n2;
      t = t + sc[S_LIPV];
      t = t + P.log_sf;
      e = exp(t);
      rec = 1.0 / clip_lo(e, 1e-300, &we);
      trials_raw = rec * target;
    }
    double wt, wy;
    const double trials = clip_lo(trials_raw, 1.0, &wt);
    const double yc =
        clip_lo(cost * trials + preproc * (trials - 1.0), 1e-300, &wy);
    sc[S_VALUE] = log(yc);
    const double g_y = (1.0 / yc) * wy;
    const double g_traw = (g_y * cost + g_y * preproc) * wt;
    if (P.prob) {
      const double g_l1 = -(g_traw * log1p_target) * (rl1 * rl1);
      const double g_p = -(g_l1 / (-p + 1.0));
      const double g_dvol = g_p * wp / (P.dxn - 1.0);
      g_vd = g_dvol * P.dxn;
      g_odd = -g_dvol;
    } else {
      const double g_e = -(g_traw * target) * (rec * rec) * we;
      const double g_t = g_e * e;
      g_odd = g_t / vc * wv;
      g_blast = g_t * (double)n2 / 2.0 / mb * wmb;
    }
    sc[S_GCOST] = g_y * trials;
    sc[S_GODD] = g_odd;
    sc[S_GVD] = g_vd;
    sc[S_GBLAST] = g_blast;
  }
  __syncthreads();
  PG_STAMP(6, 0);

  // -- the terms' adjoint, one thread each ---------------------------------
  if (tid < n2) {
    const int i = tid;
    const double g3 = sc[S_GCOST] * P.sf * ipv[i];
    const double sq = term[T_SQ * n2 + i];
    const double g_sq = g3 * term[T_L2 * n2 + i];
    term[T_GRV * n2 + i] = g3 * sq * ballv[i + 1] * term[T_RP * n2 + i];
    const double g_pw = g_sq / (2.0 * sq);
    term[T_GB * n2 + i] = g_pw * ((1.0 + (double)i) * term[T_PW * n2 + i]) *
                          term[T_WM * n2 + i];
  }
  __syncthreads();
  PG_STAMP(7, 0);

  // -- the volumes' adjoints, one thread each ------------------------------
  if (tid < d) {
    const int k = tid;
    const double *grv = term + T_GRV * n2, *ev = term + T_EV * n2,
                 *wev = term + T_WEV * n2;
    double g = grv[2 * k + 1];
    if (k + 1 < d)  /* even[k] = sqrt(odd[k] odd[k+1]) */
      g = g + grv[2 * k + 2] / (2.0 * ev[k]) * wev[k] * vols[k + 1];
    if (k > 0)      /* even[k-1] = sqrt(odd[k-1] odd[k]) */
      g = g + grv[2 * k] / (2.0 * ev[k - 1]) * wev[k - 1] * vols[k - 1];
    if (k == d - 1) g = g + sc[S_GODD];
    sm[L.gvol + k] = g;
  }
  if (P.prob && tid == 0) sm[L.gvol + d] = sc[S_GVD];
  __syncthreads();
  PG_STAMP(8, 0);

  // -- backward: warp 0, one lane per row, its steps in reverse ------------
  if (tid < 32) {
    double gp[PG_COEF];
    gp[0] = sm[L.gvol + lane] * fact[row.rd] * sign;
#pragma unroll
    for (int k = 1; k < PG_COEF; ++k) gp[k] = 0.0;
    double gbinv = 0.0;
    PgStepEnd end = pg_no_step_end();
    double *gB = sm + L.gB + 32 * lane;
    backward_band<PG_FULL ? 0 : PG_BANDS - 1>(gp, gbinv, end, kv, row, tape,
                                              gB, d);
    if (row.rd > 0) finish_step(end, gbinv, row, gB, d);  /* step 0's */
    PG_STAMP(9, 0);
  }
  __syncthreads();
  PG_STAMP(10, 0);

  // -- dlog/db, one thread per coordinate, rows in order ------------------
  if (tid < d) {
    const int i = tid;
    const double *gB = sm + L.gB + i;  /* row r's dlog/db[i] at [32 r] */
    const double g0 = gB[32 * i];  /* rows r < i do not reach b[i] */
    double v[PRUNER_GRAD_MAX_D];  /* v[rr]: row rr's, for rr in (i, d) */
#pragma unroll
    for (int rr = 1; rr < PRUNER_GRAD_MAX_D; ++rr)
      v[rr] = gB[32 * (rr > i && rr < d ? rr : i)];
    pg_loads_issued();
    double g = g0;
#pragma unroll
    for (int rr = 1; rr < PRUNER_GRAD_MAX_D; ++rr)
      g = g + (rr > i && rr < d ? v[rr] : -0.0);
    if (P.prob) g = g + gB[32 * d] * sm[L.wbm + i] / P.dx2;
    g = g + (term[T_GB * n2 + 2 * i] + term[T_GB * n2 + 2 * i + 1]);
    if (i == d - 1) g = g + sc[S_GBLAST];
    P.out[1 + i] = g;
  }
  PG_STAMP(11, 0);
  if (tid == 0) {
    P.out[0] = sc[S_VALUE];
#ifdef PRUNER_GRAD_PROFILE
    if (P.clocks)
      for (int k = 0; k < PG_CLOCKS; ++k)
        P.clocks[k] = reinterpret_cast<const long long *>(sm + L.clk)[k];
#endif
  }
}

/* dynamic shared memory of a launch, in bytes */
extern "C" int pruner_grad_smem_bytes(int d, int prob) {
  return (int)(pg_layout(d, prob).total * sizeof(double));
}

/* threads of a launch's one block */
extern "C" int pruner_grad_threads() { return PG_THREADS; }

#ifdef __CUDACC__
/* host launcher (nvcc only; tests/pruner_grad_host/ compiles the device
   code above with a host C++ compiler to check it without a card) */
static int pg_launch(const PrunerGradParams &P, void *stream) {
  static int attr_set = 0;  /* the largest layout, set once per process */
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        pruner_grad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        pruner_grad_smem_bytes(PRUNER_GRAD_MAX_D, 1));
    if (e != cudaSuccess) return (int)e;
    attr_set = 1;
  }
  pruner_grad_kernel<<<1, PG_THREADS, pruner_grad_smem_bytes(P.d, P.prob),
                       (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}

extern "C" int pruner_grad_launch(const double *tab, const double *in,
                                  double *out, int d, int prob, double sf,
                                  double dx2, double dxn, double log_sf,
                                  void *stream) {
  if (d < 1 || d > PRUNER_GRAD_MAX_D) return (int)cudaErrorInvalidValue;
#ifdef PRUNER_GRAD_PROFILE
  PrunerGradParams P{tab, in, out, d, prob, sf, dx2, dxn, log_sf, nullptr};
#else
  PrunerGradParams P{tab, in, out, d, prob, sf, dx2, dxn, log_sf};
#endif
  return pg_launch(P, stream);
}

#ifdef PRUNER_GRAD_PROFILE
/* the same launch, also writing the SM's clock at the PG_CLOCKS phase
   boundaries to clocks[0..PG_CLOCKS-1] (chip_smoke.py's breakdown) */
extern "C" int pruner_grad_launch_clocked(const double *tab,
                                          const double *in, double *out,
                                          int d, int prob, double sf,
                                          double dx2, double dxn,
                                          double log_sf, long long *clocks,
                                          void *stream) {
  if (d < 1 || d > PRUNER_GRAD_MAX_D) return (int)cudaErrorInvalidValue;
  PrunerGradParams P{tab, in, out, d, prob, sf, dx2, dxn, log_sf, clocks};
  return pg_launch(P, stream);
}
#endif  /* PRUNER_GRAD_PROFILE */

extern "C" const char *pruner_grad_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

#endif  /* __CUDACC__ */
