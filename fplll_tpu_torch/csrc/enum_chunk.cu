/*
 * enum_chunk.cu - the enumeration kernel of the PyTorch port, for Hopper
 * (sm_90a), bound with ctypes through a plain C interface.
 *
 * Replaces: fplll_tpu/enum/pallas_kernel.py:_make_chunk_kernel, the one
 * Pallas kernel body behind all four pallas_call sites (_chunk_call_rq,
 * _chunk_call_rq_grouped and the single-tile and lane-tiled forms of
 * _chunk_call). One launch enumerates G >= 1 SVP/CVP problems to the end:
 *   - G = 1 with a root queue is the _chunk_call_rq form;
 *   - G > 1 is the grouped-trial form: one shared shrinking bound, which
 *     only the first G_real problems write (padding problems have A0 = 0
 *     and drain their queue on the first pop);
 *   - a queue holding a single zero-length root (nfix = 0) is the
 *     _chunk_call form; the lane-tile split that VMEM forced on the TPU
 *     has no counterpart here.
 *
 * What it computes (the contract of the JAX package's tpu._make_step /
 * _enum_run, f32 primal): each lane pops a subtree root with atomicAdd on
 * its problem's cursor and walks the subtree depth-first, one node per
 * iteration - bound test pd + (x - c)^2 r <= prune * A, center partial
 * sums subtracted on descend and restored on ascend, zig-zag siblings
 * around the rounded center, SVP symmetry breaking (x >= 0 and x + 1
 * siblings under an all-zero prefix), per-level node counters, the best
 * leaf per lane. A lane at level 1 absorbs the whole level-0 sibling
 * range analytically (pallas_kernel.py:254-304) and then repeats the
 * stepwise walk's cs[0] subtract/restore round trip, so count-mode node
 * counts equal the plain version's exactly. Roots are sorted by partial
 * distance: the first root over the bound drains the queue.
 *
 * Left out, as they change only how work is scheduled: the barren-descend
 * lookahead and the in-kernel top-sibling donation of the TPU kernel.
 *
 * Parity rules: rounding is trunc(x +- 0.5) (the JAX package's _cround),
 * every multiply-add goes through __fmul_rn/__fadd_rn (and the build
 * passes -fmad=false) so nothing is contracted to an FMA, rdiag = 1e30 on
 * virtual levels and pd = 1e30 on padded roots are honoured as data.
 *
 * What bounds it on this card: each node costs a bound test plus O(k)
 * center-sum updates on per-lane arrays (x, cs, pd, the level counters)
 * that live in local memory, so a lane is latency-bound on dependent
 * local-memory loads, and lanes of one warp diverge across descend,
 * ascend and leaf paths. The f32 work per node (about 4k flops at level
 * k) is far below the card's f32 rate and the input bytes are a few MB,
 * so neither roofline bound is near. The design keeps mu, rdiag and
 * prune in shared memory with a padded row stride (lanes at different
 * levels read different banks), keeps the bound as one global float
 * updated with atomicMin on its bit pattern (a stale read only wastes
 * work, as on the TPU), and adds the per-lane counters into uint64
 * globals once, at the end. Only B lanes per problem are resident, which
 * leaves most of the card idle; more lanes and warp-cooperative walks are
 * later work.
 */

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define ENUM_MAXM 128

struct EnumParams {
  const float *mut;      /* (G, m, m) transposed mu: mut[j][k] = mu_kj, j<k */
  const float *rdiag;    /* (G, m) */
  const float *prune;    /* (G, m) */
  const float *mut_fix;  /* (G, m, nfixp) mu of device levels vs fixed levels */
  const float *cp0;      /* (G, m) center partial sums of the target */
  const float *roots_x;  /* (G, R, nfixp) fixed coordinates of each root */
  const float *roots_pd; /* (G, R) root partial distances, ascending */
  const float *A0;       /* (G,) per-problem bound */
  const int *m_real;     /* (G,) number of real (non-padding) levels */
  int *cursor;           /* (G,) root queue cursors, start at 0 */
  int *bound;            /* (1,) shared bound, f32 bit pattern */
  float *bdist;          /* (G*B,) best distance per lane */
  float *bdev;           /* (G*B, m) device coordinates of that best */
  int *bri;              /* (G*B,) root index of that best */
  unsigned long long *nodes; /* (G, m) node counters */
  unsigned long long *sols;  /* (G,) solution counters */
  unsigned long long *steps; /* (1,) longest lane walk, in iterations */
  int *aborted;          /* (1,) set when a lane passed max_steps */
  long long max_steps;
  int G, G_real, m, nfixp, R, B, is_svp, count_mode;
};

namespace {

__device__ __forceinline__ float f_add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float f_sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float f_mul(float a, float b) { return __fmul_rn(a, b); }

/* C round(): halves away from zero, the expression of _cround */
__device__ __forceinline__ float cround(float x) {
  return truncf(f_add(x, x >= 0.f ? 0.5f : -0.5f));
}

/* next sibling: the stateless zig-zag around the rounded center
   (pallas_kernel.py:395-409); under an all-zero SVP prefix only x + 1 */
__device__ __forceinline__ float next_sibling(float x, float c, float pd,
                                              bool svp) {
  if (svp && pd == 0.f) return f_add(x, 1.f);
  const float cr = cround(c);
  const float d0 = (c >= cr) ? 1.f : -1.f;
  const float p = f_sub(x, cr);
  return f_add(cr, f_add(-p, (f_mul(p, d0) <= 0.f) ? d0 : 0.f));
}

__device__ __forceinline__ float load_bound(const int *bits) {
  return __int_as_float(*(volatile const int *)bits);
}

__device__ __forceinline__ bool leaf_ok(float v, float c0, float nd, float r0,
                                        float bound0) {
  const float a = f_sub(v, c0);
  return f_add(nd, f_mul(f_mul(a, a), r0)) <= bound0;
}

}  // namespace

__global__ void __launch_bounds__(64) enum_chunk_kernel(EnumParams P) {
  extern __shared__ float smem[];
  const int m = P.m, ld = m + 1, nfix = P.nfixp;
  const int bpp = P.B / blockDim.x;
  const int g = blockIdx.x / bpp;
  const int lane = (blockIdx.x - g * bpp) * blockDim.x + threadIdx.x;
  const size_t gl = (size_t)g * P.B + lane;

  /* s_mu[k * ld + j] = mut[j][k] for j < k: the column a descend from level
     k subtracts, contiguous in j; the odd stride spreads lanes at
     different levels over different banks */
  float *s_mu = smem;
  float *s_r = s_mu + m * ld;
  float *s_p = s_r + m;
  const float *mut = P.mut + (size_t)g * m * m;
  for (int i = threadIdx.x; i < m * m; i += blockDim.x) {
    const int j = i / m, k = i - j * m;
    s_mu[k * ld + j] = (j < k) ? mut[i] : 0.f;
  }
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    s_r[i] = P.rdiag[(size_t)g * m + i];
    s_p[i] = P.prune[(size_t)g * m + i];
  }
  __syncthreads();

  const int mr = P.m_real[g];
  const bool svp = P.is_svp != 0, count_mode = P.count_mode != 0;
  const bool writes_bound = !count_mode && g < P.G_real;
  const float A0 = P.A0[g];
  const float *mf = P.mut_fix + (size_t)g * m * nfix;
  const float *cp0 = P.cp0 + (size_t)g * m;
  const float *roots_pd = P.roots_pd + (size_t)g * P.R;
  const float *roots_x = P.roots_x + (size_t)g * P.R * nfix;
  float *bdev = P.bdev + gl * m;

  float x[ENUM_MAXM], cs[ENUM_MAXM], pd[ENUM_MAXM];
  unsigned long long cnt[ENUM_MAXM];
  for (int j = 0; j < mr; j++) cnt[j] = 0ull;
  unsigned long long sols = 0ull, iters = 0ull;
  float bdist = INFINITY;
  int bri = 0;
  bool aborted = false;
  float A = count_mode ? A0 : fminf(A0, load_bound(P.bound));

  for (;;) {
    const int ridx = atomicAdd(P.cursor + g, 1);
    if (ridx >= P.R) break;
    const float rpd = roots_pd[ridx];
    if (!count_mode) A = fminf(A, load_bound(P.bound));
    if (!(rpd <= A)) {
      atomicMax(P.cursor + g, P.R);
      break;
    }
    /* fresh lane: cs = cp0 - sum_f root_f * mut_fix[:, f], summed in f
       order (the plain version sums in the same order) */
    const float *root = roots_x + (size_t)ridx * nfix;
    for (int j = 0; j < mr; j++) {
      float acc = 0.f;
      for (int f = 0; f < nfix; f++)
        acc = f_add(acc, f_mul(root[f], mf[(size_t)j * nfix + f]));
      cs[j] = f_sub(cp0[j], acc);
    }
    int k = mr - 1;
    float x0 = cround(cs[k]);
    if (svp && rpd == 0.f) x0 = fmaxf(x0, 0.f);
    x[k] = x0;
    pd[k] = rpd;

    for (;;) {
      if (++iters > (unsigned long long)P.max_steps) {
        aborted = true;
        break;
      }
      if (!count_mode && (iters & 31ull) == 0ull)
        A = fminf(A, load_bound(P.bound));
      const float alpha = f_sub(x[k], cs[k]);
      const float nd = f_add(pd[k], f_mul(f_mul(alpha, alpha), s_r[k]));
      if (nd <= f_mul(s_p[k], A)) {
        cnt[k]++;
        if (k == 1) {
          /* the whole level-0 sibling range [lo, hi] at once */
          const float t = f_mul(x[1], s_mu[ld]);
          const float c0 = f_sub(cs[0], t);
          const float r0 = s_r[0];
          const float bound0 = f_mul(s_p[0], A);
          const float w = __fsqrt_rn(
              __fdiv_rn(fmaxf(f_sub(bound0, nd), 0.f), r0));
          float lo = ceilf(f_sub(c0, w)), hi = floorf(f_add(c0, w));
          /* one endpoint correction each way: the count then equals the
             stepwise walk's per-leaf bound tests */
          if (leaf_ok(f_add(hi, 1.f), c0, nd, r0, bound0)) hi = f_add(hi, 1.f);
          if (!leaf_ok(hi, c0, nd, r0, bound0)) hi = f_sub(hi, 1.f);
          if (leaf_ok(f_sub(lo, 1.f), c0, nd, r0, bound0)) lo = f_sub(lo, 1.f);
          if (!leaf_ok(lo, c0, nd, r0, bound0)) lo = f_add(lo, 1.f);
          const bool trivial = svp && nd == 0.f;
          if (trivial) lo = fmaxf(lo, 0.f);
          const float n = fmaxf(f_add(f_sub(hi, lo), 1.f), 0.f);
          cnt[0] += (unsigned long long)n;
          sols += (unsigned long long)(trivial ? fmaxf(f_sub(n, 1.f), 0.f) : n);
          const bool have = trivial ? (hi >= 1.f) : (n > 0.f);
          if (have) {
            const float xb = trivial ? 1.f : fminf(fmaxf(cround(c0), lo), hi);
            const float ab = f_sub(xb, c0);
            const float db = f_add(nd, f_mul(f_mul(ab, ab), r0));
            if (db < bdist) {
              bdist = db;
              bri = ridx;
              bdev[0] = xb;
              for (int j = 1; j < mr; j++) bdev[j] = x[j];
            }
            if (!count_mode && db < A) {
              A = db;
              if (writes_bound) atomicMin(P.bound, __float_as_int(db));
            }
          }
          /* the stepwise walk descends to level 0 and restores on the way
             back up; repeat that round trip so later centers round alike */
          cs[0] = f_add(c0, t);
          x[1] = next_sibling(x[1], cs[1], pd[1], svp);
        } else {
          const float xv = x[k];
          const float *col = s_mu + k * ld;
          for (int j = 0; j < k; j++) cs[j] = f_sub(cs[j], f_mul(xv, col[j]));
          --k;
          pd[k] = nd;
          x[k] = cround(cs[k]);
        }
      } else {
        if (++k >= mr) break;
        const float xv = x[k];
        const float *col = s_mu + k * ld;
        for (int j = 0; j < k; j++) cs[j] = f_add(cs[j], f_mul(xv, col[j]));
        x[k] = next_sibling(xv, cs[k], pd[k], svp);
      }
    }
    if (aborted) break;
  }

  P.bdist[gl] = bdist;
  P.bri[gl] = bri;
  for (int j = 0; j < mr; j++)
    if (cnt[j]) atomicAdd(P.nodes + (size_t)g * m + j, cnt[j]);
  if (sols) atomicAdd(P.sols + g, sols);
  atomicMax(P.steps, iters);
  if (aborted) atomicExch(P.aborted, 1);
}

#ifdef __CUDACC__
/* host launcher (nvcc only; tests/enum_chunk_host/ compiles the device
   code above with a host C++ compiler to check it without a card) */
extern "C" int enum_chunk_launch(const EnumParams *hp, int threads,
                                 void *stream) {
  const EnumParams P = *hp;
  if (P.m < 2 || P.m > ENUM_MAXM || threads < 1 || threads > 64 ||
      P.B % threads != 0 || P.G < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(P.m * (P.m + 1) + 2 * P.m) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        enum_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = P.G * (P.B / threads);
  enum_chunk_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}

extern "C" const char *enum_chunk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
#endif  /* __CUDACC__ */
