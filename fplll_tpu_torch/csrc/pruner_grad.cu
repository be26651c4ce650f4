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
 * Layout: one block; one warp per recurrence row (d rows, d + 1 with the
 * probability metric, at most 31 warps), lane c holding coefficient P[c]
 * of the row's polynomial (d + 2 <= 32 coefficients at d <= 30). A step
 * of row r (rd = r + 1 steps, the prefix volume of b[0..rd-1]) shifts P
 * up by one with a shuffle, scales it by 1 / (c + 1), and evaluates the
 * shifted polynomial at x = b[i] * (1 / b[rd-1]) by Horner, high
 * coefficient first, each step one fused multiply-add: the order and the
 * fusion of jaxgrad's scan and of torchgrad's addcmul. The recurrence
 * cancels catastrophically as d grows, so any other order of these
 * operations moves the result far beyond the rounding of one operation.
 * Every other operation rounds on its own (-fmad=false), in the order
 * torch.autograd takes it in the plain version, so the kernel and the
 * plain version differ only where a sum is taken in another order.
 * The masked steps of the vmapped form are the identity with a zero
 * derivative, so row r runs exactly rd steps.
 *
 * The adjoint: the scalar chain (the log, the trials, the probability or
 * the expected solutions) in one thread after a barrier, the 2d cost
 * terms one thread each, then every row backwards over its steps from a
 * tape of the Horner intermediates a_k (lane k keeps a_k of each step),
 * held in shared memory: the rows' steps d(d+1)/2 (+ d) times 32 doubles,
 * 127 KB at d = 30, with everything else 142 KB of the 227 KB a block can
 * address. The per-row contributions to dlog/db are summed in a fixed
 * order by one thread per coordinate: no atomics, the same bits on every
 * call. The clips have jnp.maximum / minimum / clip's gradient (1 inside,
 * 1/2 on a bound, 0 outside) and keep a NaN, so a non-finite input gives
 * a non-finite gradient where jaxgrad's does.
 *
 * What bounds it: not the 0.26 M f64 operations at d = 30 (7.8 ns at the
 * card's f64 rate), nor the bytes (a few KB), but the dependent chain:
 * each row's rd steps of d + 2 Horner multiply-adds run one after the
 * other, about twice as many dependent operations backwards, with a
 * shuffle before each. The rows run in parallel, so the longest row (rd
 * = d) sets the time: about 3 d (d + 2) dependent f64 operations. The
 * launch and the two copies around it set the wrapper's time.
 */

#include <cuda_runtime.h>
#include <math.h>

#define PRUNER_GRAD_MAX_D 30  /* d + 2 coefficients in one warp's lanes */
#define PG_FULL 0xffffffffu

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
};

/* Shared memory of a launch, in doubles, and the offsets of its arrays. */
struct PgLayout {
  int rows, steps;
  int tape, xs, b, bm, wbm, vols, gvol, gB, term, sc, total;
};

/* term arrays, each 2d long, in this order from PgLayout::term */
enum { T_RV, T_RP, T_M, T_WM, T_SQ, T_L2, T_TMP, T_GRV, T_GB, T_EV, T_WEV,
       T_COUNT };
/* scalars of the chain, from PgLayout::sc */
enum { S_GCOST, S_GODD, S_GVD, S_GBLAST, S_VALUE, S_COUNT };

__host__ __device__ inline PgLayout pg_layout(int d, int prob) {
  PgLayout L;
  L.rows = d + (prob ? 1 : 0);
  L.steps = d * (d + 1) / 2 + (prob ? d : 0);
  int o = 0;
  L.tape = o; o += 32 * L.steps;
  L.xs = o; o += L.steps;
  L.b = o; o += d;
  L.bm = o; o += d;
  L.wbm = o; o += d;
  L.vols = o; o += L.rows;
  L.gvol = o; o += L.rows;
  L.gB = o; o += L.rows * d;
  L.term = o; o += T_COUNT * 2 * d;
  L.sc = o; o += S_COUNT;
  L.total = o;
  return L;
}

/* first step of row r in the tape: rows 0..d-1 run r + 1 steps, row d
   (the shell-shrunk profile) d */
__device__ __forceinline__ int pg_row_offset(int r) {
  return r * (r + 1) / 2;
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

/* the rows' profile: b for the prefix rows, the shrunk one for row d */
__device__ __forceinline__ const double *row_profile(const double *sm,
                                                     const PgLayout &L,
                                                     int r, int d) {
  return sm + (r < d ? L.b : L.bm);
}

}  // namespace

__global__ void __launch_bounds__(32 * (PRUNER_GRAD_MAX_D + 1))
    pruner_grad_kernel(PrunerGradParams P) {
  const int d = P.d, tid = threadIdx.x, lane = tid & 31, r = tid >> 5;
  const PgLayout L = pg_layout(d, P.prob);
  double *sm = pg_smem();
  const double *fact = P.tab, *ballv = P.tab + d + 1,
               *kinv = P.tab + 3 * d + 3;
  const double *ipv = P.in + d;
  const double radius = P.in[3 * d], target = P.in[3 * d + 1],
               preproc = P.in[3 * d + 2], log1p_target = P.in[3 * d + 3],
               log_radius = P.in[3 * d + 4];
  double *term = sm + L.term, *sc = sm + L.sc;
  const int n2 = 2 * d;

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
  __syncthreads();

  // -- forward: one warp per row -----------------------------------------
  const int rd = r < d ? r + 1 : d;
  const double *B = row_profile(sm, L, r, d);
  double *tape = sm + L.tape + 32 * pg_row_offset(r);
  double *xs = sm + L.xs + pg_row_offset(r);
  const double binv = 1.0 / B[rd - 1];
  const double sign = (rd & 1) ? -1.0 : 1.0;
  {
    double p = lane == 0 ? 1.0 : 0.0;
    for (int j = 0; j < rd; ++j) {
      const double up = __shfl_sync(PG_FULL, p, lane > 0 ? lane - 1 : 0, 32);
      const double s = (lane >= 1 && lane <= d + 1) ? up * kinv[lane - 1]
                                                    : 0.0;
      const double x = B[rd - 1 - j] * binv;
      double acc = __shfl_sync(PG_FULL, s, d + 1, 32);
      double mine = s;  /* a_{d+1} = s[d+1] on lane d + 1 */
      for (int k = d; k >= 0; --k) {
        acc = fma(acc, x, __shfl_sync(PG_FULL, s, k, 32));
        if (lane == k) mine = acc;
      }
      tape[32 * j + lane] = mine;
      if (lane == 0) xs[j] = x;
      p = lane == 0 ? -acc : s;
    }
    if (lane == 0) sm[L.vols + r] = sign * p * fact[rd];
  }
  __syncthreads();

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
    const double Rp = pow(radius, (double)i + 1.0);
    double wm;
    const double m = clip_lo(sm[L.b + i / 2], 1e-300, &wm);
    const double sq = sqrt(pow(m, 1.0 + (double)i));
    const double L2 = Rp * rv * ballv[i + 1];
    term[T_RV * n2 + i] = rv;
    term[T_RP * n2 + i] = Rp;
    term[T_M * n2 + i] = m;
    term[T_WM * n2 + i] = wm;
    term[T_SQ * n2 + i] = sq;
    term[T_L2 * n2 + i] = L2;
    term[T_TMP * n2 + i] = L2 * sq * ipv[i] * P.sf;
  }
  __syncthreads();

  // -- the scalar chain and its adjoint, one thread ------------------------
  if (tid == 0) {
    double cost = 0.0;
    for (int i = 0; i < n2; ++i) cost += term[T_TMP * n2 + i];
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
      t = t + log(ballv[n2]);
      mb = clip_lo(sm[L.b + d - 1], 1e-300, &wmb);
      t = t + (log_radius + log(mb) / 2.0) * (double)n2;
      t = t + log(ipv[n2 - 1]);
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

  // -- the terms' adjoint, one thread each ---------------------------------
  if (tid < n2) {
    const int i = tid;
    const double g3 = sc[S_GCOST] * P.sf * ipv[i];
    const double sq = term[T_SQ * n2 + i];
    const double g_sq = g3 * term[T_L2 * n2 + i];
    term[T_GRV * n2 + i] = g3 * sq * ballv[i + 1] * term[T_RP * n2 + i];
    const double g_pw = g_sq / (2.0 * sq);
    const double m = term[T_M * n2 + i];
    term[T_GB * n2 + i] = g_pw * ((1.0 + (double)i) * pow(m, (double)i)) *
                          term[T_WM * n2 + i];
  }
  __syncthreads();

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

  // -- backward: one warp per row, its steps in reverse --------------------
  {
    double *gB = sm + L.gB + r * d;
    double gp = lane == 0 ? sm[L.gvol + r] * fact[rd] * sign : 0.0;
    double gbinv = 0.0;
    for (int j = rd - 1; j >= 0; --j) {
      const double x = xs[j], a = tape[32 * j + lane];
      double ga = -__shfl_sync(PG_FULL, gp, 0, 32);  /* d acc */
      double gs = lane >= 1 ? gp : 0.0;
      double gx = 0.0;
      for (int k = 0; k <= d; ++k) {
        const double an = __shfl_sync(PG_FULL, a, k + 1, 32);
        if (lane == k) gs = gs + ga;
        gx = k == 0 ? ga * an : gx + ga * an;
        ga = ga * x;
      }
      if (lane == d + 1) gs = gs + ga;
      const double gsn = __shfl_sync(PG_FULL, gs, lane < 31 ? lane + 1 : 31,
                                     32);
      gp = lane <= d ? gsn * kinv[lane] : 0.0;
      const int i = rd - 1 - j;
      gbinv = j == rd - 1 ? gx * B[i] : gbinv + gx * B[i];
      if (lane == 0) gB[i] = gx * binv;
    }
    if (lane == 0) gB[rd - 1] = gB[rd - 1] + -gbinv * (binv * binv);
  }
  __syncthreads();

  // -- dlog/db, one thread per coordinate, rows in order ------------------
  if (tid < d) {
    const int i = tid;
    const double *gB = sm + L.gB;
    double g = gB[i * d + i];  /* rows r < i do not reach b[i] */
    for (int rr = i + 1; rr < d; ++rr) g = g + gB[rr * d + i];
    if (P.prob) g = g + gB[d * d + i] * sm[L.wbm + i] / P.dx2;
    g = g + (term[T_GB * n2 + 2 * i] + term[T_GB * n2 + 2 * i + 1]);
    if (i == d - 1) g = g + sc[S_GBLAST];
    P.out[1 + i] = g;
  }
  if (tid == 0) P.out[0] = sc[S_VALUE];
}

/* dynamic shared memory of a launch, in bytes */
extern "C" int pruner_grad_smem_bytes(int d, int prob) {
  return (int)(pg_layout(d, prob).total * sizeof(double));
}

#ifdef __CUDACC__
/* host launcher (nvcc only; tests/pruner_grad_host/ compiles the device
   code above with a host C++ compiler to check it without a card) */
extern "C" int pruner_grad_launch(const double *tab, const double *in,
                                  double *out, int d, int prob, double sf,
                                  double dx2, double dxn, double log_sf,
                                  void *stream) {
  if (d < 1 || d > PRUNER_GRAD_MAX_D) return (int)cudaErrorInvalidValue;
  static int attr_set = 0;  /* the largest layout, set once per process */
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        pruner_grad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        pruner_grad_smem_bytes(PRUNER_GRAD_MAX_D, 1));
    if (e != cudaSuccess) return (int)e;
    attr_set = 1;
  }
  PrunerGradParams P{tab, in, out, d, prob, sf, dx2, dxn, log_sf};
  const PgLayout L = pg_layout(d, prob);
  pruner_grad_kernel<<<1, 32 * L.rows, pruner_grad_smem_bytes(d, prob),
                       (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}

extern "C" const char *pruner_grad_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
#endif  /* __CUDACC__ */
