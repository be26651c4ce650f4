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
 *     only the first G_real problems write; problems G_real..G-1 are
 *     padding and are never scheduled;
 *   - a queue holding a single zero-length root (nfix = 0) is the
 *     _chunk_call form; the lane-tile split that VMEM forced on the TPU
 *     has no counterpart here.
 *
 * The same body, templated on the element type and on the walk it
 * compiles (EnumWalk), also replaces the JAX package's XLA-jitted tree of
 * the proved solvers (tpu.py:_make_step / _enum_run in f64, with the
 * dual recurrence and per-level sub-solutions), one instance per form:
 *   - enum_chunk_f64_kernel<M, W>, the primal f64 walk (every unpruned or
 *     certified search: HKZ's windows, the proved SVP/CVP, unpruned
 *     FastEvaluator trees);
 *   - enum_chunk_dual_kernel<T, M, W>, T float or double, the dual walk
 *     (the f32-dual windows of SD-BKZ and slide, the f64 dual SVP): a
 *     descend subtracts alpha_k = x_k - c_k instead of x_k, and an ascend
 *     restores it with the parent's x and center;
 *   - enum_chunk_subsols_kernel<T, M, W>, the primal walk with the
 *     sub-solution records (find_subsols): each problem keeps one record
 *     per level (the passing node with the smallest nonzero partial
 *     distance, its coordinates from that level up and its root), lowered
 *     under a per-(problem, level) lock; level 0's candidate comes out of
 *     the absorbed leaf range;
 *   - enum_chunk_ext_kernel<T, M, W>, the extended walk, with dual and
 *     findsubsols as runtime flags and no lookahead: the two combined
 *     forms (dual with sub-solutions, which no path of the port
 *     launches) and whatever a caller sends there by name
 *     (EnumParams.ext), to compare it with the instances above.
 * Each instance compiles only the state of its walk: no sub-solution
 * record outside the sub-solution walk, no dual subtraction outside the
 * dual one. All but the extended instance have the barren-descend
 * lookahead.
 *
 * What it computes (the contract of the JAX package's tpu._make_step /
 * _enum_run): each walker pops a subtree root with atomicAdd
 * on its problem's cursor and walks the subtree depth-first, one node per
 * iteration - bound test pd + (x - c)^2 r <= prune * A, center partial
 * sums subtracted on descend and restored on ascend, zig-zag siblings
 * around the rounded center, SVP symmetry breaking (x >= 0 and x + 1
 * siblings under an all-zero prefix), per-level node counters, the best
 * leaf per walker and problem. A walker at level 1 absorbs the whole
 * level-0 sibling range analytically (pallas_kernel.py:254-304) and then
 * repeats the stepwise walk's cs[0] subtract/restore round trip. Roots
 * are sorted by partial distance: the first root over the bound drains
 * the queue.
 *
 * The two other parts of the TPU kernel's body:
 *   - the barren-descend lookahead (pallas_kernel.py:349-366), in every
 *     instance but the extended one, as on the TPU: a passing node above
 *     level 1 computes its nearest child's center (w_k mu[k][k-1]
 *     subtracted, w_k = x_k, or alpha_k under dual) and first x (the
 *     child's own first bound test); where that fails, the node steps to
 *     its next sibling in the same iteration instead of descending, which
 *     skips the descend's subtract and the ascend's restore of the center
 *     sums below it (barren_skips counts them). A skipped child would
 *     have offered no sub-solution record: it fails its own first bound
 *     test. The plain version's forms do the same, the combined ones
 *     excepted;
 *   - top-sibling donation (pallas_kernel.py:546-674), in every instance:
 *     once every queue has drained, an idle walker takes a ticket (the
 *     request queue) and waits in its ticket's mailbox; a busy walker that
 *     sees a request in its 32-iteration check, and still owns a level
 *     above its own, claims the ticket and hands over the sibling range
 *     of the topmost such level jstar: its problem and root, its path
 *     x[l] and centers c_l for l >= jstar and pd[jstar]; then caps its own
 *     ascent at jstar. The adoptee continues the zig-zag from the donor's
 *     x[jstar] (x + 1 under an all-zero SVP prefix), stops ascending above
 *     jstar, and can donate onward. It derives its center sums below
 *     jstar as a fresh descent along the path would: the root's sums, then
 *     w_l mu[l][j] subtracted for l = m_real - 1 down to jstar + 1 (w_l =
 *     x_l, or x_l - c_l under dual). Termination: busy counts the walkers
 *     that hold work; a walker counts itself before it pops a root, a
 *     donor counts its adoptee once its claim succeeds (its own count
 *     keeps busy above 0 until then), and a walker uncounts itself when
 *     it goes idle or passes the step cap. The walker that brings busy to
 *     0 holds the last work: no walker holds work and none can donate, so
 *     it sets every mailbox's sequence word to ENUM_DONE and the idle
 *     walkers, each polling only its own mailbox, leave; the step cap
 *     releases them the same way. No walker waits on one that has not
 *     started, so blocks need not all be resident. A mailbox is reused a
 *     round later only after its reader freed it, and a released one is
 *     never written again (both by compare-and-swap on its sequence).
 *
 * Parity contract (tests/test_pallas_parity.py:164-175, as the JAX
 * package holds its own Pallas kernel against XLA): an adoptee re-derives
 * the sums that the stepwise walk carried through its round trips, and a
 * skipped descend skips a round trip, and fl(fl(a - t) + t) == a is not
 * guaranteed, so counts may differ from the plain version's at ULP level
 * in marginal bound tests: equal solution counts, the best distance to
 * 1e-4, total nodes to 1%, levels above 200 nodes to 2%. A launch that
 * donates nothing gives the plain version's counts exactly (the plain
 * version skips the same descends); so does every launch on a tree whose
 * walk is exact in f32 (tests/test_torch_donation.py: every width, grid,
 * instance and height bucket).
 *
 * Parity rules: rounding is trunc(x +- 0.5) (the JAX package's _cround),
 * every multiply-add goes through __fmul_rn/__fadd_rn (and the build
 * passes -fmad=false) so nothing is contracted to an FMA, rdiag = 1e30 on
 * virtual levels and pd = 1e30 on padded roots are honoured as data.
 *
 * What bounds it on this card: latency. A walk is a chain of dependent
 * steps (bound test, then a descend or an ascend that moves O(k) center
 * sums, then the next bound test); the f32 work per node (about 4k flops
 * at level k) is far below the card's f32 rate and the input bytes are a
 * few MB, so neither roofline bound is near. The kernel's time is the
 * longest walk times the time of one step, so the design shortens the
 * step and spreads the walks:
 *   - one walker is a group of W = ENUM_WIDTH threads (32: measured
 *     fastest of 8, 16 and 32 on the card, PERF.md section 6; narrower
 *     groups share a warp and their walks diverge; the host emulation in
 *     tests/ builds the source at every W with -DENUM_WIDTH).
 *     Thread t of the group owns levels t, t + W, t + 2W, ... below the
 *     height bucket M (32, 64 or 128, a template parameter), and keeps
 *     cs, x, pd and the node counters of those levels in registers
 *     (arrays of M / W entries indexed only by unrolled constants and
 *     written by selects, so the owner's update does not split the warp).
 *     A descend or an ascend is one mul and one add per owned level,
 *     neighbouring threads reading neighbouring mu entries of one
 *     shared-memory row. Every thread of the group also holds the walk's
 *     scalars: level k, its x, center and partial distance, the parent
 *     level's three (the next ascend's sibling), and the center of level
 *     k - 1 before x_k is subtracted with mu[k][k-1] (the next descend's
 *     center), so a step needs a shuffle only to refill them from their
 *     owners, after the step has been taken. All threads run the bound
 *     test, the zig-zag step and the leaf-range absorption on the same
 *     values, so control flow is uniform within a walker. Each cs[j] goes
 *     through the same operations in the same order as in a one-thread
 *     walk, so a root's walk is bit-identical at every W and every grid,
 *     and so is a count where nothing is donated;
 *   - the grid is persistent: the launcher sizes it from the occupancy of
 *     the instance (blocks per SM times SMs), and walkers pop roots until
 *     every real problem's queue has drained, moving on to the next real
 *     problem when theirs is empty, and then take donated sibling ranges,
 *     so the card, not the root batch, sets the number of walkers;
 *   - mu, rdiag and prune of all real problems sit in shared memory where
 *     they fit (17 KB per problem at m = 64; row stride m + 1), else they
 *     are read from global memory (the SMEM template parameter, so that no
 *     pointer can be either); the bound is one global float, lowered with
 *     atomicMin on its bit pattern and re-read every 4 iterations
 *     through a load issued 4 iterations earlier (a stale read only
 *     wastes work, as on the TPU; a re-read every 32 iterations let
 *     that waste vary from launch to launch once idle walkers took
 *     donated ranges); the step cap is checked every 32 iterations;
 *     counters go to uint64 globals once per walker and problem.
 * Without the donation one root's walk would set the launch's time (the
 * rest of the card idle); the kernel records the longest walk of a
 * walker, of one work item (a root or a donated range), the iterations
 * of all walkers (their busy share) and the donations, and chip_smoke.py
 * prints them with the time per step at a grid of one block. A step is
 * a stream of a few dozen mostly
 * dependent instructions; computing both moves before the bound test
 * picks one, to drop the branches, issues more instructions and was
 * slower. No stack frame is needed: the walker state is registers only
 * (`-Xptxas -v`, printed by chip_smoke.py phase 1).
 *
 * The f64, dual and sub-solution instances. Their time is bounded the
 * same way: the longest work item's walk (root_steps) times the time of
 * one step, which in f64 is a chain of dependent f64 operations (about
 * 4.2 ns each on an H100, by chip_smoke.py's FMA probe) against 4 cycles
 * for f32. A chain that long is hidden only by other walkers' chains, so
 * the design is about walkers per SM. The extended instance asks ptxas
 * for one block per SM and compiles the dual recurrence and the
 * sub-solution records into every tree: 142 registers at M = 64 in f64,
 * one block of 8 walkers per SM, 2 warps per SM sub-partition, 44% of
 * the register file idle. Each of the other instances compiles only its
 * walk's state and has the lookahead, and its launch bounds ask ptxas
 * for the most blocks per SM it meets with no stack frame and no spills
 * (chip_smoke.py phase 1 asserts none and prints the blocks per SM the
 * occupancy calculator gives; tools/torch_f64_instance_ab.py and
 * tools/torch_walk_instance_ab.py build the source at other bounds and
 * time each), as measured on an H100 with nvcc 12.9:
 *   - f64 primal and f64 dual: ENUM_F64_MIN_BLOCKS, two, at M <= 64
 *     (124 / 128 registers at M = 32 / 64, 16 warps per SM); three capped
 *     the primal instance at 80 registers with a stack frame and spills;
 *   - f64 sub-solutions: ENUM_SUBSOLS_F64_MIN_BLOCKS, two, at M <= 64
 *     (124 / 128; one block took 144 at M = 64; three spilled);
 *   - f32 dual: no minimum, as the f32 primal instances (64 / 80 / 100
 *     registers, 4 / 3 / 2 blocks at M = 32 / 64 / 128; a minimum of one
 *     or two gave 87-111 registers, three spilled at M = 128);
 *   - f32 sub-solutions: ENUM_SUBSOLS_F32_MIN_BLOCKS, three, at M <= 64
 *     (80 registers), two at M = 128 (111); four spilled.
 * Shared memory does not limit that: one f64 problem takes 9 KB at
 * M = 32 and 34 KB at M = 64; at M = 128 it takes 134 KB, so that bucket
 * runs one f64 block per SM whatever the registers, and its launch
 * bounds ask for one.
 */

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define ENUM_MAXM 128
#define ENUM_THREADS 256   /* threads per block, every instance */
#ifndef ENUM_WIDTH
#define ENUM_WIDTH 32      /* threads per walker */
#endif
#define ENUM_SMEM_MAX 232448  /* dynamic shared memory a block may hold */
#ifndef ENUM_F64_MIN_BLOCKS
#define ENUM_F64_MIN_BLOCKS 2 /* resident blocks per SM the f64 primal
                                 instance asks ptxas for at M <= 64 */
#endif
#ifndef ENUM_DUAL_F32_MIN_BLOCKS
#define ENUM_DUAL_F32_MIN_BLOCKS 0 /* the f32 dual instance's (0: as the
                                      f32 primal instances, none) */
#endif
#ifndef ENUM_SUBSOLS_F64_MIN_BLOCKS
#define ENUM_SUBSOLS_F64_MIN_BLOCKS 2 /* the f64 sub-solution instance's
                                         at M <= 64 */
#endif
#ifndef ENUM_SUBSOLS_F32_MIN_BLOCKS
#define ENUM_SUBSOLS_F32_MIN_BLOCKS 3 /* the f32 sub-solution instance's
                                         at M <= 64 (2 at M = 128) */
#endif
#define ENUM_DONE (-1)        /* a mailbox's sequence word once the launch
                                 has no work left to donate */

/* the walk an instance compiles (enum_chunk_walk's WALK) */
enum EnumWalk {
  ENUM_PRIMAL = 0,  /* primal recurrence, with the lookahead */
  ENUM_DUAL = 1,    /* dual recurrence, with the lookahead */
  ENUM_SUBSOLS = 2, /* primal, sub-solution records, with the lookahead */
  ENUM_EXT = 3      /* dual and records as runtime flags, no lookahead */
};

/* Element type T of the floating-point arrays: float, or double when dbl
   is set. Pointers to them are untyped here and cast in the kernel. */
struct EnumParams {
  const void *mut;       /* (G, m, m) transposed mu: mut[j][k] = mu_kj, j<k */
  const void *rdiag;     /* (G, m) */
  const void *prune;     /* (G, m) */
  const void *mut_fix;   /* (G, m, nfixp) mu of device levels vs fixed levels */
  const void *cp0;       /* (G, m) center partial sums of the target */
  const void *roots_x;   /* (G, R, nfixp) fixed coordinates of each root */
  const void *roots_a;   /* (G, R, nfixp) what a root feeds the center sums:
                            roots_x, or alpha for dual */
  const void *roots_pd;  /* (G, R) root partial distances, ascending */
  const void *A0;        /* (G,) per-problem bound */
  const int *m_real;     /* (G,) number of real (non-padding) levels */
  int *cursor;           /* (G,) root queue cursors, start at 0 */
  void *bound;           /* (1,) shared bound, the bit pattern of T (int or
                            long long; positive values order alike) */
  void *bdist;           /* (G*walkers,) best distance per problem and
                            walker, +inf until the walker finds one */
  void *bdev;            /* (G*walkers, m) device coordinates of that best */
  int *bri;              /* (G*walkers,) root index of that best */
  unsigned long long *nodes;      /* (G, m) node counters */
  unsigned long long *sols;       /* (G,) solution counters */
  unsigned long long *steps;      /* (1,) longest walk of a walker */
  unsigned long long *root_steps; /* (1,) longest walk of one work item (a
                                     root or a donated sibling range) */
  unsigned long long *walk_steps; /* (1,) iterations of all walkers */
  unsigned long long *donations;  /* (1,) sibling ranges donated */
  unsigned long long *barren_skips; /* (1,) descends the lookahead skipped */
  int *aborted;          /* (1,) set when a walker passed max_steps (the
                            cap is checked every 32 iterations) */
  /* the donation (see the header): requests are tickets, tickets issued
     << 32 | tickets served, both from 0; busy counts the walkers that
     hold work, from 0; ticket c uses mailbox c % walkers, whose int words
     are (sequence, problem, root index, level jstar), the sequence
     starting at the mailbox's index (ENUM_DONE once no work is left),
     and whose T values are the donor's x and centers of levels jstar..
     (2 m) and pd[jstar] */
  unsigned long long *queue;      /* (1,) */
  int *busy;             /* (1,) */
  int *mailbox;          /* (walkers, 4) */
  void *mail;            /* (walkers, 2 m + 1) */
  /* per-level sub-solution records of each problem (findsubsols): the
     smallest nonzero partial distance of a passing node at that level,
     its coordinates from that level up and its root; the caller
     initialises ss_dist to rdiag (the reference's records start at
     r_kk) and ss_lock to 0 */
  void *ss_dist;         /* (G, m) */
  void *ss_vec;          /* (G, m, m) row k: levels k..m-1, zero below */
  int *ss_root;          /* (G, m) */
  int *ss_lock;          /* (G, m) */
  long long max_steps;
  int G, G_real, m, nfixp, R, walkers, is_svp, count_mode;
  int dbl, dual, findsubsols;
  int ext;               /* run the extended instance with dual and
                            findsubsols as given (a comparison with the
                            instance of the form; the launcher takes it
                            for dual with sub-solutions in any case) */
};

/* launch geometry of one instance, as the launcher chooses it */
struct EnumGeometry {
  int grid, threads, width, M, blocks_per_sm, sms, smem, walkers;
};

/* floats of one problem's mu (row stride m + 1), rdiag and prune */
__host__ __device__ inline int enum_problem_floats(int m) {
  return m * (m + 1) + 2 * m;
}

/* dynamic shared memory of a launch: all real problems, or none when
   they do not fit (then the kernel reads them from global memory); elem
   is the size of T */
__host__ __device__ inline int enum_smem_bytes(int m, int G_real,
                                               int elem = 4) {
  const long long b = (long long)G_real * enum_problem_floats(m) * elem;
  return b <= ENUM_SMEM_MAX ? (int)b : 0;
}

#ifdef __CUDACC__
__device__ __forceinline__ void *dynamic_smem() {
  extern __shared__ __align__(16) unsigned char enum_smem[];
  return enum_smem;
}
/* a waiting lock taker gives the issue slots to the lock's holder */
__device__ __forceinline__ void spin_pause() { __nanosleep(32); }
/* an idle walker polls its own mailbox with a backoff up to 1 us */
__device__ __forceinline__ void idle_pause(unsigned &ns) {
  __nanosleep(ns);
  if (ns < 1024u) ns *= 2u;
}
#else
void *dynamic_smem(); /* the host emulation's per-block buffer */
void spin_pause();    /* the host emulation lets another walker run */
void idle_pause(unsigned &ns);
#endif

namespace {

__device__ __forceinline__ float f_add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float f_sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float f_mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float f_div(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float f_sqrt(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ float f_trunc(float a) { return truncf(a); }
__device__ __forceinline__ float f_ceil(float a) { return ceilf(a); }
__device__ __forceinline__ float f_floor(float a) { return floorf(a); }
__device__ __forceinline__ float f_max(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ float f_min(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double f_add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double f_sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double f_mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double f_div(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ double f_sqrt(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ double f_trunc(double a) { return trunc(a); }
__device__ __forceinline__ double f_ceil(double a) { return ceil(a); }
__device__ __forceinline__ double f_floor(double a) { return floor(a); }
__device__ __forceinline__ double f_max(double a, double b) { return fmax(a, b); }
__device__ __forceinline__ double f_min(double a, double b) { return fmin(a, b); }

/* the shared bound as the bit pattern of T, lowered with atomicMin (a
   distance is never negative, so its bits order like the value) */
template <typename T> __device__ __forceinline__ T load_bound(const void *bits);
template <> __device__ __forceinline__ float load_bound<float>(const void *bits) {
  return __int_as_float(*(volatile const int *)bits);
}
template <> __device__ __forceinline__ double load_bound<double>(const void *bits) {
  return __longlong_as_double(*(volatile const long long *)bits);
}
__device__ __forceinline__ void lower_bound(void *bits, float v) {
  atomicMin((int *)bits, __float_as_int(v));
}
__device__ __forceinline__ void lower_bound(void *bits, double v) {
  atomicMin((long long *)bits, __double_as_longlong(v));
}

/* C round(): halves away from zero, the expression of _cround */
template <typename T>
__device__ __forceinline__ T cround(T x) {
  return f_trunc(f_add(x, x >= T(0) ? T(0.5) : T(-0.5)));
}

/* next sibling: the stateless zig-zag around the rounded center
   (pallas_kernel.py:395-409); under an all-zero SVP prefix only x + 1 */
template <typename T>
__device__ __forceinline__ T next_sibling(T x, T c, T pd, bool svp) {
  if (svp && pd == T(0)) return f_add(x, T(1));
  const T cr = cround(c);
  const T d0 = (c >= cr) ? T(1) : T(-1);
  const T p = f_sub(x, cr);
  return f_add(cr, f_add(-p, (f_mul(p, d0) <= T(0)) ? d0 : T(0)));
}

template <typename T>
__device__ __forceinline__ T leaf_dist(T v, T c0, T nd, T r0) {
  const T a = f_sub(v, c0);
  return f_add(nd, f_mul(f_mul(a, a), r0));
}

/* leaf_dist(v, ...) <= bound0, spelled as its own expression: the f32
   instances of BKZ-2.0 then compile to the registers they had before the
   element type became a template parameter */
template <typename T>
__device__ __forceinline__ bool leaf_ok(T v, T c0, T nd, T r0, T bound0) {
  const T a = f_sub(v, c0);
  return f_add(nd, f_mul(f_mul(a, a), r0)) <= bound0;
}

/* a word another walker writes: read past the L1 cache */
template <typename V>
__device__ __forceinline__ V vload(const V *p) {
  return *(volatile const V *)p;
}

/* a[slot], and a[slot] = v in the owner only, with constant indices and
   selects, so that the per-thread level arrays stay in registers and the
   owner's update does not split the warp */
template <int S, typename T>
__device__ __forceinline__ T pick(const T (&a)[S], int slot) {
  T v = a[0];
#pragma unroll
  for (int i = 1; i < S; i++) v = i == slot ? a[i] : v;
  return v;
}

template <int S, typename T>
__device__ __forceinline__ void put(T (&a)[S], bool owner, int slot, T v) {
#pragma unroll
  for (int i = 0; i < S; i++) a[i] = owner && i == slot ? v : a[i];
}

}  // namespace

/* sub-solutions: offer (dist, x_lvl, the walker's coordinates above lvl)
   to problem g's record of level lvl. The records only fall, so the
   unlocked read only filters; lane 0 takes the level's lock and re-checks,
   and the owners write the coordinates before the lock is released.
   Uniform within the walker: every decision is broadcast. x_one is the
   coordinate of level 1 when lvl = 0 (a walker absorbing level 0 has not
   stored it in x). */
template <typename T, int S, int W>
__device__ __forceinline__ void offer_subsol(const EnumParams &P, int g, int t,
                                             unsigned gmask, int ridx, int lvl,
                                             T dist, T x_lvl, T x_one,
                                             const T (&x)[S]) {
  const int m = P.m;
  T *ss_dist = (T *)P.ss_dist + (size_t)g * m;
  int *lock = P.ss_lock + (size_t)g * m + lvl;
  int win = 0;
  if (t == 0 && dist < *(volatile T *)(ss_dist + lvl)) {
    while (atomicCAS(lock, 0, 1) != 0) spin_pause();
    __threadfence();
    win = dist < *(volatile T *)(ss_dist + lvl);
    if (!win) atomicExch(lock, 0);
  }
  if (!__shfl_sync(gmask, win, 0, W)) return;
  T *row = (T *)P.ss_vec + ((size_t)g * m + lvl) * m;
#pragma unroll
  for (int i = 0; i < S; i++) {
    const int j = t + W * i;
    if (j < m)
      row[j] = j < lvl ? T(0) : j == lvl ? x_lvl
             : j == lvl + 1 && lvl == 0 ? x_one : x[i];
  }
  __threadfence();
  __shfl_sync(gmask, 0, 0, W);  /* every owner has written */
  if (t == 0) {
    *(volatile T *)(ss_dist + lvl) = dist;
    P.ss_root[(size_t)g * m + lvl] = ridx;
    __threadfence();
    atomicExch(lock, 0);
  }
}

/* every mailbox's sequence word to ENUM_DONE, by the W threads of a
   walker: idle walkers leave, and no donation can be published or a
   mailbox freed after it */
__device__ __forceinline__ void release_mailboxes(const EnumParams &P, int t,
                                                  int W) {
  for (int e = t; e < P.walkers; e += W)
    atomicExch(P.mailbox + 4 * e, ENUM_DONE);
}

/* The walk of one launch. T: the element type. SMEM: mu, rdiag and
   prune of the real problems sit in shared memory (enum_smem_bytes > 0),
   else they are read from global memory. WALK: what the instance
   compiles (EnumWalk): the primal recurrence, the dual one, the primal
   one with the sub-solution records, each with the barren-descend
   lookahead, or the extended walk, with the dual recurrence and the
   records as runtime flags (P.dual, P.findsubsols) and no lookahead.

   A walker's work items are roots popped from the queues and, once every
   queue has drained, top-level sibling ranges donated by busy walkers
   (see the header). Its registers cover levels k..top-1 of the item:
   top = m_real for a root, jstar + 1 for a range donated at level jstar,
   and a donor lowers its own top to the level it gave away. */
template <typename T, int M, int W, bool SMEM, int WALK>
__device__ __forceinline__ void enum_chunk_walk(const EnumParams &P) {
  static_assert(M % W == 0 && W >= 8 && W <= 32 && (W & (W - 1)) == 0,
                "walker width: 8, 16 or 32 threads");
  constexpr int S = M / W;  /* levels each thread owns */
  const int m = P.m, ld = m + 1, nfix = P.nfixp, R = P.R;
  const int t = threadIdx.x & (W - 1);
  const unsigned gmask =
      W == 32 ? 0xffffffffu
              : ((1u << W) - 1u) << (threadIdx.x & 31 & ~(W - 1));
  const int walker = (int)((blockIdx.x * blockDim.x + threadIdx.x) / W);
  const bool svp = P.is_svp != 0, count_mode = P.count_mode != 0;
  constexpr bool EXT = WALK == ENUM_EXT;
  constexpr bool RECORDS = WALK == ENUM_SUBSOLS || EXT;
  const bool dual = WALK == ENUM_DUAL || (EXT && P.dual != 0);
  const bool subsols = WALK == ENUM_SUBSOLS || (EXT && P.findsubsols != 0);
  const int pf = enum_problem_floats(m);

  /* s_mu[k * ld + j] = mut[j][k] for j < k: the row a descend from level
     k subtracts, contiguous in j; then rdiag and prune */
  T *smem = static_cast<T *>(dynamic_smem());
  if (SMEM) {
    for (int g = 0; g < P.G_real; g++) {
      T *s_mu = smem + g * pf;
      const T *mut = (const T *)P.mut + (size_t)g * m * m;
      for (int i = threadIdx.x; i < m * m; i += blockDim.x) {
        const int j = i / m, k = i - j * m;
        s_mu[k * ld + j] = (j < k) ? mut[i] : T(0);
      }
      for (int i = threadIdx.x; i < m; i += blockDim.x) {
        s_mu[m * ld + i] = ((const T *)P.rdiag)[(size_t)g * m + i];
        s_mu[m * ld + m + i] = ((const T *)P.prune)[(size_t)g * m + i];
      }
    }
    __syncthreads();
  }

  /* the shared bound, read by one thread and broadcast to the group */
  auto group_bound = [&]() {
    T b = T(0);
    if (t == 0) b = load_bound<T>(P.bound);
    return __shfl_sync(gmask, b, 0, W);
  };

  T cs[S] = {}, x[S] = {}, pd[S] = {};
  unsigned long long cnt[S];
#pragma unroll
  for (int i = 0; i < S; i++) cnt[i] = 0ull;
  unsigned long long iters = 0ull, longest_item = 0ull, sols = 0ull;
  unsigned donated = 0u, barren = 0u;
  bool aborted = false;

  /* the problem g of the current work item: mu[k][j], rdiag[k] and
     prune[k] as shared-memory offsets in one instance and global pointers
     in the other, never a pointer that could be either (that would make
     every shared load convert a generic address); this walker's counters,
     best and bound of g, flushed when the walker moves to another
     problem */
  int g = -1, so = 0, mr = 0;
  const T *g_mut = nullptr, *g_r = nullptr, *g_p = nullptr;
  const T *mf = nullptr, *cp0 = nullptr, *roots_a = nullptr;
  T *bdev = nullptr;
  size_t slot_gw = 0;
  T A = T(0), bdist = T(INFINITY);
  auto mu = [&](int k, int j) {
    return SMEM ? smem[so + k * ld + j] : g_mut[(size_t)j * m + k];
  };
  auto rdiag = [&](int k) { return SMEM ? smem[so + m * ld + k] : g_r[k]; };
  auto prune = [&](int k) {
    return SMEM ? smem[so + m * ld + m + k] : g_p[k];
  };
  auto flush = [&]() {
    if (g < 0) return;
#pragma unroll
    for (int i = 0; i < S; i++) {
      const int j = t + W * i;
      if (j < mr && cnt[i]) atomicAdd(P.nodes + (size_t)g * m + j, cnt[i]);
      cnt[i] = 0ull;
    }
    if (t == 0 && sols) atomicAdd(P.sols + g, sols);
    sols = 0ull;
  };
  auto select = [&](int gn) {
    if (gn == g) return;
    flush();
    g = gn;
    so = g * pf;
    g_mut = (const T *)P.mut + (size_t)g * m * m;
    g_r = (const T *)P.rdiag + (size_t)g * m;
    g_p = (const T *)P.prune + (size_t)g * m;
    mr = P.m_real[g];
    mf = (const T *)P.mut_fix + (size_t)g * m * nfix;
    cp0 = (const T *)P.cp0 + (size_t)g * m;
    roots_a = (const T *)P.roots_a + (size_t)g * R * nfix;
    slot_gw = (size_t)g * P.walkers + walker;
    bdev = (T *)P.bdev + slot_gw * m;
    T b = T(0);
    if (t == 0) b = ((const T *)P.bdist)[slot_gw];
    bdist = __shfl_sync(gmask, b, 0, W);
    const T A0 = ((const T *)P.A0)[g];
    A = count_mode ? A0 : f_min(A0, group_bound());
  };
  /* a fresh root's center sums: cs = cp0 - sum_f root_f * mut_fix[:, f],
     summed in f order (the plain version sums in the same order) */
  auto root_sums = [&](int ridx) {
    const T *root = roots_a + (size_t)ridx * nfix;
#pragma unroll
    for (int i = 0; i < S; i++) {
      const int j = t + W * i;
      if (j < mr) {
        T acc = T(0);
        for (int f = 0; f < nfix; f++)
          acc = f_add(acc, f_mul(root[f], mf[(size_t)j * nfix + f]));
        cs[i] = f_sub(cp0[j], acc);
      }
    }
  };

  if (t == 0) atomicAdd(P.busy, 1);  /* busy before it pops a root */
  int q = 0;
  for (;;) {
    /* the next work item: a root of the next real problem whose queue
       has not drained, else a donated sibling range */
    int ridx = 0, k, top;
    T xk, ck, pdk;
    if (q < P.G_real) {
      const int gq = (walker + q) % P.G_real;
      if (t == 0) ridx = atomicAdd(P.cursor + gq, 1);
      ridx = __shfl_sync(gmask, ridx, 0, W);
      if (ridx >= R) {
        q++;
        continue;
      }
      select(gq);
      const T rpd = ((const T *)P.roots_pd)[(size_t)g * R + ridx];
      if (!count_mode) A = f_min(A, group_bound());
      if (!(rpd <= A)) {
        if (t == 0) atomicMax(P.cursor + g, R);
        q++;
        continue;
      }
      root_sums(ridx);
      k = mr - 1;
      top = mr;
      ck = __shfl_sync(gmask, pick(cs, k / W), k & (W - 1), W);
      xk = cround(ck);
      if (svp && rpd == T(0)) xk = f_max(xk, T(0));
      pdk = rpd;
    } else {
      /* idle: take a ticket and stop counting as busy. The walker that
         brings busy to 0 holds the last work: it releases every mailbox
         (ENUM_DONE) and leaves; the others poll their ticket's mailbox
         until a donor fills it or it is released */
      int c = 0, last = 0;
      if (t == 0) {
        c = (int)(atomicAdd(P.queue, 1ull << 32) >> 32);
        __threadfence();
        last = atomicAdd(P.busy, -1) == 1;
      }
      if (__shfl_sync(gmask, last, 0, W)) {
        release_mailboxes(P, t, W);
        break;
      }
      int got = 0;
      if (t == 0) {
        const int *seq = P.mailbox + 4 * (c % P.walkers);
        unsigned ns = 64u;
        for (;;) {
          const int sv = vload(seq);
          if (sv == c + 1 || sv == ENUM_DONE) {
            got = sv != ENUM_DONE;
            break;
          }
          idle_pause(ns);
        }
        __threadfence();
      }
      if (!__shfl_sync(gmask, got, 0, W)) break;
      c = __shfl_sync(gmask, c, 0, W);
      const int e = c % P.walkers;
      const int *info = P.mailbox + 4 * e;
      const T *mb = (const T *)P.mail + (size_t)e * (2 * m + 1);
      select(vload(info + 1));
      if (!count_mode) A = f_min(A, group_bound());
      ridx = vload(info + 2);
      const int jstar = vload(info + 3);
      /* the donor's path and centers from jstar up, each thread its own
         levels, and what their descends subtracted (w_l = x_l, or alpha_l
         = x_l - c_l under dual) */
      T wl[S];
#pragma unroll
      for (int i = 0; i < S; i++) {
        const int j = t + W * i;
        wl[i] = T(0);
        if (j >= jstar && j < mr) {
          x[i] = vload(mb + j);
          pd[i] = vload(mb + m + j);  /* the center, until the sums below */
          wl[i] = dual ? f_sub(x[i], pd[i]) : x[i];
        }
      }
      /* the center sums of rows below jstar as a fresh descent along the
         donor's path computes them: the root's sums, then w_l mu[l][j]
         subtracted for l = mr - 1 down to jstar + 1; rows from jstar up
         are the donor's */
      root_sums(ridx);
      for (int l = mr - 1; l > jstar; l--) {
        const T w = __shfl_sync(gmask, pick(wl, l / W), l & (W - 1), W);
#pragma unroll
        for (int i = 0; i < S; i++) {
          const int j = t + W * i;
          const T v = f_sub(cs[i], f_mul(w, mu(l, min(j, m - 1))));
          if (j < l) cs[i] = v;
        }
      }
#pragma unroll
      for (int i = 0; i < S; i++) {
        const int j = t + W * i;
        if (j >= jstar && j < mr) cs[i] = pd[i];
      }
      k = jstar;
      top = jstar + 1;
      const int own = jstar & (W - 1), s = jstar / W;
      ck = __shfl_sync(gmask, pick(cs, s), own, W);
      pdk = vload(mb + 2 * m);
      /* the zig-zag successor of the donor's x at jstar (x + 1 under an
         all-zero SVP prefix) */
      xk = next_sibling(__shfl_sync(gmask, pick(x, s), own, W), ck, pdk, svp);
      /* every thread has read the mailbox: free it for the ticket one
         round later, unless the launch released it meanwhile */
      __threadfence();
      __shfl_sync(gmask, 0, 0, W);
      if (t == 0) atomicCAS(P.mailbox + 4 * e, c + 1, c + P.walkers);
    }

    /* the walker's registers, the same in every thread of the group:
       level k and its x, center and partial distance; the center of
       level k - 1 before x_k is subtracted (cn) and mu[k][k-1] (mkn),
       which give the next descend's center without a shuffle; the parent
       level k + 1's x, center and partial distance, which give the next
       ascend's sibling without one. The owners' copies in x, cs and pd
       trail them by one shuffle, off the chain of dependent steps. */
    T rk = rdiag(k), pk = prune(k);
    T cn = __shfl_sync(gmask, pick(cs, (k - 1) / W), (k - 1) & (W - 1), W);
    T mkn = mu(k, k - 1);
    T xp = T(0), cp = T(0), pdp = T(0);  /* no ascend above the item */
    const unsigned long long iters0 = iters;
    /* search mode: the shared bound as thread 0 loaded it four iterations
       ago; taking it then and issuing the next load keeps the load's
       latency off the walk's chain */
    T bnext = A;

    for (;;) {
      if (!count_mode && ((iters + 1ull) & 3ull) == 0ull) {
        A = f_min(A, __shfl_sync(gmask, bnext, 0, W));
        if (t == 0) bnext = load_bound<T>(P.bound);
      }
      /* every 32 iterations: the step cap and a request for work,
         answered with the sibling range of the top level this walker
         still owns */
      if ((++iters & 31ull) == 0ull) {
        if (iters > (unsigned long long)P.max_steps) {
          /* stop: no more work to give, and every idle walker leaves */
          aborted = true;
          if (t == 0) {
            atomicExch(P.aborted, 1);
            atomicAdd(P.busy, -1);
          }
          release_mailboxes(P, t, W);
          break;
        }
        if (top - 1 > k) {
          /* one claim per check: a request waits (tickets issued above
             served) and the CAS takes the next one. The adoptee counts as
             busy from the claim on (the donor's own count keeps busy above
             0 until then) */
          int h = -1;
          if (t == 0) {
            const unsigned long long qv = vload(P.queue);
            if ((unsigned)qv < (unsigned)(qv >> 32) &&
                atomicCAS(P.queue, qv, qv + 1ull) == qv) {
              h = (int)(unsigned)qv;
              atomicAdd(P.busy, 1);
              /* the mailbox is free once its last reader released it */
              const int *seq = P.mailbox + 4 * (h % P.walkers);
              int sv;
              while ((sv = vload(seq)) != h && sv != ENUM_DONE) spin_pause();
              if (sv == ENUM_DONE) {
                atomicAdd(P.busy, -1);
                h = -1;
              }
            }
          }
          h = __shfl_sync(gmask, h, 0, W);
          if (h >= 0) {
            const int e = h % P.walkers, jstar = top - 1;
            int *info = P.mailbox + 4 * e;
            T *mb = (T *)P.mail + (size_t)e * (2 * m + 1);
#pragma unroll
            for (int i = 0; i < S; i++) {
              const int j = t + W * i;
              if (j >= jstar && j < mr) {
                mb[j] = x[i];
                mb[m + j] = cs[i];
                if (j == jstar) mb[2 * m] = pd[i];
              }
            }
            if (t == 0) {
              info[1] = g;
              info[2] = ridx;
              info[3] = jstar;
            }
            __threadfence();
            __shfl_sync(gmask, 0, 0, W);  /* every owner has written */
            int sent = 0;
            if (t == 0) {
              sent = atomicCAS(info, h, h + 1) == h;
              if (!sent) atomicAdd(P.busy, -1);  /* released meanwhile */
            }
            if (__shfl_sync(gmask, sent, 0, W)) {
              top = jstar;
              donated++;
            }
          }
        }
      }
      const T alpha = f_sub(xk, ck);
      const T nd = f_add(pdk, f_mul(f_mul(alpha, alpha), rk));
      if (nd <= f_mul(pk, A)) {
        put(cnt, t == (k & (W - 1)), k / W, pick(cnt, k / W) + 1ull);
        if constexpr (RECORDS)
          if (subsols && nd > T(0))
            offer_subsol<T, S, W>(P, g, t, gmask, ridx, k, nd, xk, xk, x);
        /* what a descend from level k subtracts: x_k, or alpha_k */
        const T wk = dual ? alpha : xk;
        if (k == 1) {
          /* the whole level-0 sibling range [lo, hi] at once */
          const T tt = f_mul(wk, mkn);
          const T c0 = f_sub(cn, tt);
          const T r0 = rdiag(0);
          const T bound0 = f_mul(prune(0), A);
          const T w = f_sqrt(f_div(f_max(f_sub(bound0, nd), T(0)), r0));
          T lo = f_ceil(f_sub(c0, w)), hi = f_floor(f_add(c0, w));
          /* one endpoint correction each way: the count then equals the
             stepwise walk's per-leaf bound tests */
          if (leaf_ok(f_add(hi, T(1)), c0, nd, r0, bound0)) hi = f_add(hi, T(1));
          if (!leaf_ok(hi, c0, nd, r0, bound0)) hi = f_sub(hi, T(1));
          if (leaf_ok(f_sub(lo, T(1)), c0, nd, r0, bound0)) lo = f_sub(lo, T(1));
          if (!leaf_ok(lo, c0, nd, r0, bound0)) lo = f_add(lo, T(1));
          const bool trivial = svp && nd == T(0);
          if (trivial) lo = f_max(lo, T(0));
          const T n = f_max(f_add(f_sub(hi, lo), T(1)), T(0));
          cnt[0] += t == 0 ? (unsigned long long)n : 0ull;
          sols += (unsigned long long)(trivial ? f_max(f_sub(n, T(1)), T(0)) : n);
          const bool have = trivial ? (hi >= T(1)) : (n > T(0));
          if (have) {
            const T xb = trivial ? T(1) : f_min(f_max(cround(c0), lo), hi);
            const T ab = f_sub(xb, c0);
            const T db = f_add(nd, f_mul(f_mul(ab, ab), r0));
            if constexpr (RECORDS) if (subsols) {
              /* level 0's record: the passing leaf with the smallest
                 nonzero distance; past a leaf on its center, the
                 nearer neighbour (on a tie, the one the zig-zag
                 visits first) */
              T xs = xb, ds = db;
              if (!(db > T(0))) {
                const T d0 = (c0 >= xb) ? T(1) : T(-1);
                const T xa = f_add(xb, d0), xo = f_sub(xb, d0);
                const bool ina = xa >= lo && xa <= hi;
                const bool ino = xo >= lo && xo <= hi;
                const T da = leaf_dist(xa, c0, nd, r0);
                const T dz = leaf_dist(xo, c0, nd, r0);
                xs = ina && (!ino || da <= dz) ? xa : xo;
                ds = ina && (!ino || da <= dz) ? da : ino ? dz : T(0);
              }
              if (ds > T(0))
                offer_subsol<T, S, W>(P, g, t, gmask, ridx, 0, ds, xs, xk, x);
            }
            if (db < bdist) {
              bdist = db;
#pragma unroll
              for (int i = 0; i < S; i++) {
                const int j = t + W * i;
                if (j < mr) bdev[j] = j == 0 ? xb : j == 1 ? xk : x[i];
              }
              if (t == 0) {
                ((T *)P.bdist)[slot_gw] = db;
                P.bri[slot_gw] = ridx;
              }
            }
            if (!count_mode && db < A) {
              A = db;
              if (t == 0) lower_bound(P.bound, db);
            }
          }
          /* the stepwise walk descends to level 0 and restores on the
             way back up; repeat that round trip so later centers round
             alike */
          cn = f_add(c0, tt);
          cs[0] = t == 0 ? cn : cs[0];
          xk = next_sibling(xk, ck, pdk, svp);
        } else {
          /* the child's center: the owner's cs[k-1] after a descend */
          const T cc = f_sub(cn, f_mul(wk, mkn));
          /* the barren-descend lookahead (every walk but the extended
             one): the child's step would test its nearest integer
             first; where that fails the child's bound, step to the next
             sibling now, skipping the descend and its restore. A skipped
             child offers no sub-solution record: it fails its own first
             bound test */
          bool skip = false;
          if constexpr (!EXT) {
            T xf = cround(cc);
            if (svp && nd == T(0)) xf = f_max(xf, T(0));
            const T af = f_sub(xf, cc);
            skip = f_add(nd, f_mul(f_mul(af, af), rdiag(k - 1))) >
                   f_mul(prune(k - 1), A);
          }
          if (skip) {
            barren++;
            xk = next_sibling(xk, ck, pdk, svp);
          } else {
            /* descend: the owners subtract w_k mu[k][j] from cs[j], j < k */
#pragma unroll
            for (int i = 0; i < S; i++) {
              const int j = t + W * i;
              const T v = f_sub(cs[i], f_mul(wk, mu(k, min(j, m - 1))));
              if (j < k) cs[i] = v;
            }
            put(x, t == (k & (W - 1)), k / W, xk);
            put(pd, t == (k & (W - 1)), k / W, pdk);
            xp = xk;
            cp = ck;
            pdp = pdk;
            --k;
            ck = cc;
            xk = cround(ck);
            pdk = nd;
            rk = rdiag(k);
            pk = prune(k);
            cn = __shfl_sync(gmask, pick(cs, (k - 1) / W), (k - 1) & (W - 1), W);
            mkn = mu(k, k - 1);
          }
        }
      } else {
        /* ascend: the owners restore cs[j], j < k + 1, with what the
           descend from level k + 1 subtracted; the item ends at top */
        if (++k >= top) break;
        const T wp = dual ? f_sub(xp, cp) : xp;
#pragma unroll
        for (int i = 0; i < S; i++) {
          const int j = t + W * i;
          const T v = f_add(cs[i], f_mul(wp, mu(k, min(j, m - 1))));
          if (j < k) cs[i] = v;
        }
        mkn = mu(k, k - 1);
        cn = f_add(ck, f_mul(wp, mkn));  /* = the owner's restored cs[k-1] */
        xk = next_sibling(xp, cp, pdp, svp);
        ck = cp;
        pdk = pdp;
        rk = rdiag(k);
        pk = prune(k);
        if (k + 1 < top) {
          const int own = (k + 1) & (W - 1), s = (k + 1) / W;
          xp = __shfl_sync(gmask, pick(x, s), own, W);
          pdp = __shfl_sync(gmask, pick(pd, s), own, W);
          cp = __shfl_sync(gmask, pick(cs, s), own, W);
        }
      }
    }
    if (iters - iters0 > longest_item) longest_item = iters - iters0;
    if (aborted) break;
  }

  flush();
  if (t == 0) {
    atomicMax(P.steps, iters);
    atomicMax(P.root_steps, longest_item);
    atomicAdd(P.walk_steps, iters);
    if (donated) atomicAdd(P.donations, (unsigned long long)donated);
    if (barren) atomicAdd(P.barren_skips, (unsigned long long)barren);
  }
}

/* the f32 primal instances of BKZ-2.0 */
template <int M, int W, bool SMEM>
__global__ void __launch_bounds__(ENUM_THREADS) enum_chunk_kernel(EnumParams P) {
  enum_chunk_walk<float, M, W, SMEM, ENUM_PRIMAL>(P);
}

/* the f64 primal walk (the plain f64 form), one problem in shared
   memory (the grouped launch takes pruned f32 trials only), with the
   barren-descend lookahead; ENUM_F64_MIN_BLOCKS blocks per SM at M <= 64,
   one at M = 128, where shared memory allows no more (the header) */
template <int M, int W>
__global__ void __launch_bounds__(ENUM_THREADS,
                                  M <= 64 ? ENUM_F64_MIN_BLOCKS : 1)
enum_chunk_f64_kernel(EnumParams P) {
  enum_chunk_walk<double, M, W, true, ENUM_PRIMAL>(P);
}

/* resident blocks per SM that an instance of the walk over T at height
   bucket M asks ptxas for (0: none asked, as the f32 primal instances) */
template <typename T, int M>
constexpr int enum_dual_min_blocks() {
  return sizeof(T) == 8 ? (M <= 64 ? ENUM_F64_MIN_BLOCKS : 1)
                        : ENUM_DUAL_F32_MIN_BLOCKS;
}
template <typename T, int M>
constexpr int enum_subsols_min_blocks() {
  return sizeof(T) == 8 ? (M <= 64 ? ENUM_SUBSOLS_F64_MIN_BLOCKS : 1)
                        : (M <= 64 ? ENUM_SUBSOLS_F32_MIN_BLOCKS : 2);
}

/* the dual walk (the f32-dual and f64-dual forms), one problem in shared
   memory, with the barren-descend lookahead */
template <typename T, int M, int W>
__global__ void __launch_bounds__(ENUM_THREADS,
                                  (enum_dual_min_blocks<T, M>()))
enum_chunk_dual_kernel(EnumParams P) {
  enum_chunk_walk<T, M, W, true, ENUM_DUAL>(P);
}

/* the primal walk with the sub-solution records (the f32-subsols and
   f64-subsols forms), one problem in shared memory, with the
   barren-descend lookahead */
template <typename T, int M, int W>
__global__ void __launch_bounds__(ENUM_THREADS,
                                  (enum_subsols_min_blocks<T, M>()))
enum_chunk_subsols_kernel(EnumParams P) {
  enum_chunk_walk<T, M, W, true, ENUM_SUBSOLS>(P);
}

/* the extended walk, one problem in shared memory; at least one block
   per SM, so that ptxas keeps its larger state in registers (with the
   primal instances' bounds the float M = 128 instance spilled). It runs
   what EnumParams.ext names (a comparison with the instances above) and
   the two combined forms, dual with sub-solutions, which no path of the
   port launches */
template <typename T, int M, int W>
__global__ void __launch_bounds__(ENUM_THREADS, 1)
enum_chunk_ext_kernel(EnumParams P) {
  enum_chunk_walk<T, M, W, true, ENUM_EXT>(P);
}

typedef void (*EnumKernel)(EnumParams);

/* the walk of a launch (EnumWalk): the extended one where the caller
   names it (P.ext) or where it is dual with sub-solutions */
__host__ __device__ inline int enum_walk_of(const EnumParams &P) {
  if (P.ext || (P.dual && P.findsubsols)) return ENUM_EXT;
  return P.dual ? ENUM_DUAL : P.findsubsols ? ENUM_SUBSOLS : ENUM_PRIMAL;
}

/* the instance for a launch over G_real problems of height m of element
   type double (dbl) or float, of walk `walk` (nullptr if none): the f32
   primal instances of BKZ; the f64 primal instance; the dual, the
   sub-solution and the extended instances of the element type. All but
   the f32 primal instances hold one problem in shared memory. */
static EnumKernel enum_instance(int m, int G_real, int dbl, int walk) {
#define ENUM_INSTANCES(MM) \
  {enum_chunk_kernel<MM, ENUM_WIDTH, false>, \
   enum_chunk_kernel<MM, ENUM_WIDTH, true>}
  static const EnumKernel table[3][2] = {
      ENUM_INSTANCES(32), ENUM_INSTANCES(64), ENUM_INSTANCES(128)};
#undef ENUM_INSTANCES
  static const EnumKernel f64_table[3] = {
      enum_chunk_f64_kernel<32, ENUM_WIDTH>,
      enum_chunk_f64_kernel<64, ENUM_WIDTH>,
      enum_chunk_f64_kernel<128, ENUM_WIDTH>};
#define ENUM_WALK_INSTANCES(KERNEL, TT) \
  {KERNEL<TT, 32, ENUM_WIDTH>, KERNEL<TT, 64, ENUM_WIDTH>, \
   KERNEL<TT, 128, ENUM_WIDTH>}
#define ENUM_WALK_TABLE(KERNEL) \
  {ENUM_WALK_INSTANCES(KERNEL, float), ENUM_WALK_INSTANCES(KERNEL, double)}
  static const EnumKernel walk_table[3][2][3] = {
      ENUM_WALK_TABLE(enum_chunk_dual_kernel),
      ENUM_WALK_TABLE(enum_chunk_subsols_kernel),
      ENUM_WALK_TABLE(enum_chunk_ext_kernel)};
#undef ENUM_WALK_TABLE
#undef ENUM_WALK_INSTANCES
  const int b = m <= 32 ? 0 : m <= 64 ? 1 : 2;
  if (m < 2 || m > ENUM_MAXM || G_real < 1) return nullptr;
  if (walk < ENUM_PRIMAL || walk > ENUM_EXT) return nullptr;
  if (dbl || walk != ENUM_PRIMAL) {
    if (G_real != 1 || enum_smem_bytes(m, 1, dbl ? 8 : 4) == 0) return nullptr;
    if (walk == ENUM_PRIMAL) return f64_table[b];
    return walk_table[walk - 1][dbl ? 1 : 0][b];
  }
  return table[b][enum_smem_bytes(m, G_real) > 0];
}

#ifdef __CUDACC__
/* host launcher (nvcc only; tests/enum_chunk_host/ compiles the device
   code above with a host C++ compiler to check it without a card) */

static int enum_bucket(int m) { return m <= 32 ? 32 : m <= 64 ? 64 : 128; }

/* The geometry of a launch over problems of height m with G_real real
   problems, of element type double (dbl) or float, of walk `walk`
   (EnumWalk): grid 0 means blocks per SM (from the occupancy of the
   instance with its dynamic shared memory) times the SMs of the current
   device. */
extern "C" int enum_chunk_geometry(int m, int G_real, int dbl, int walk,
                                   int grid, EnumGeometry *out) {
  const EnumKernel fn = enum_instance(m, G_real, dbl, walk);
  if (!fn || G_real < 1 || grid < 0) return (int)cudaErrorInvalidValue;
  const int smem = enum_smem_bytes(m, G_real, dbl ? 8 : 4);
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, bps = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&bps, fn, ENUM_THREADS,
                                                    smem);
  if (e != cudaSuccess) return (int)e;
  if (bps < 1) return (int)cudaErrorInvalidConfiguration;
  out->grid = grid ? grid : bps * sms;
  out->threads = ENUM_THREADS;
  out->width = ENUM_WIDTH;
  out->M = enum_bucket(m);
  out->blocks_per_sm = bps;
  out->sms = sms;
  out->smem = smem;
  out->walkers = out->grid * (ENUM_THREADS / ENUM_WIDTH);
  return 0;
}

extern "C" int enum_chunk_launch(const EnumParams *hp, int grid,
                                 void *stream) {
  EnumParams P = *hp;
  if (P.G < 1 || P.G_real < 1 || P.G_real > P.G || P.R < 1 || P.nfixp < 0)
    return (int)cudaErrorInvalidValue;
  const int walk = enum_walk_of(P);
  EnumGeometry geo;
  const int e = enum_chunk_geometry(P.m, P.G_real, P.dbl, walk, grid, &geo);
  if (e != 0) return e;
  if (P.walkers != geo.walkers) return (int)cudaErrorInvalidValue;
  void *args[] = {&P};
  const cudaError_t le = cudaLaunchKernel(
      (const void *)enum_instance(P.m, P.G_real, P.dbl, walk), dim3(geo.grid),
      dim3(geo.threads), args, (size_t)geo.smem, (cudaStream_t)stream);
  if (le != cudaSuccess) return (int)le;
  return (int)cudaGetLastError();
}

extern "C" const char *enum_chunk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
#endif  /* __CUDACC__ */
