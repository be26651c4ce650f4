/* Sequential Kannan–Fincke–Pohst enumeration core.
 *
 * Native implementation of the host oracle's DFS loop (the role of the
 * reference's enumerate_base.cpp:152-247 iterative loop): plain-double
 * tree arithmetic, zig-zag sibling stepping with SVP symmetry breaking,
 * per-level pruning bounds, best-1 bound shrinking or count-only mode,
 * optional CVP targets and dual partial-sum updates, node budget.
 *
 * Built with the baked-in toolchain at first use (see native/__init__.py)
 * and called through ctypes; the pure-Python oracle remains the fallback
 * and the semantic reference.
 */

#include <math.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define MAXD 1024

typedef struct {
  double maxdist;        /* in/out: updated bound (best-1 mode) */
  double best_dist;      /* out: best solution distance */
  double sol_count;      /* out: number of bottom hits (count mode) */
  int64_t nodes_budget;  /* in: 0 = unlimited */
  int64_t visited;       /* out: loop iterations */
  int found;             /* out: 1 if best_x valid */
} enum_result;

/* returns 0 on success, -1 on bad input */
int enum_run(int d,
             const double *mut,        /* d*d row-major, mut[i*d+j]=mu(j,i) */
             const double *rdiag,      /* d */
             const double *pruning,    /* d or NULL */
             const double *target,     /* d (center partsums) or NULL */
             int is_svp,               /* break symmetry + skip zero vector */
             int dual,                 /* dual partial-sum updates */
             int count_mode,           /* don't shrink the bound */
             double *best_x,           /* out: d coords */
             double *nodes_per_level,  /* out: d counters (accumulated) */
             enum_result *res) {
  /* center partial sums cache, packed at stride d+1: the fixed
     MAXD-stride layout put every row 8KB apart, blowing the L1/L2
     working set ~100x at BKZ window sizes (d ~ 40-70) — in-tour
     enumeration ran at half the standalone rate because of it.
     Heap-allocated per call (only (d+1)^2 doubles) so concurrent
     enumerations in different host threads do not share state — the
     reference's documented thread-safety contract is "distinct objects
     may be reduced on different threads" (README.md:309-311), and
     ctypes releases the GIL across this call. */
  double *cps_buf;
#define cps(i, j) cps_buf[(size_t)(i) * (size_t)(d + 1) + (size_t)(j)]
  double x[MAXD], dx[MAXD], ddx[MAXD], center[MAXD], alpha[MAXD];
  double partdist[MAXD + 1], bounds[MAXD];
  int cpb[MAXD + 1];
  double maxdist = res->maxdist;
  int k, i, j;

  if (d < 1 || d > MAXD) return -1;
  cps_buf = malloc((size_t)(d + 1) * (size_t)(d + 1) * 8);
  if (!cps_buf) return -1;

  for (i = 0; i < d; i++) {
    double c = target ? target[i] : 0.0;
    cps(i, d) = c;
    cpb[i + 1] = d - 1;
    x[i] = 0.0; dx[i] = 0.0; ddx[i] = 0.0; center[i] = 0.0; alpha[i] = 0.0;
    partdist[i] = 0.0;
  }
  cpb[0] = 0;
  partdist[d] = 0.0;

  /* initial descent (prepare_enumeration, enumerate.cpp:160-213) */
  {
    double newdist = 0.0;
    int svp = is_svp;
    for (k = d - 1; k >= 0 && newdist <= maxdist; --k) {
      double newcenter = target ? target[k] : 0.0;
      for (j = k + 1; j < d; ++j)
        newcenter -= (dual ? alpha[j] : x[j]) * mut[k * d + j];
      x[k] = round(newcenter);
      center[k] = newcenter;
      partdist[k] = newdist;
      dx[k] = ddx[k] = (newcenter >= x[k]) ? 1.0 : -1.0;
      alpha[k] = x[k] - newcenter;
      newdist += alpha[k] * alpha[k] * rdiag[k];
    }
    if (svp) { x[0] = 1.0; }
    k = k + 1;
  }

  for (i = 0; i < d; i++)
    bounds[i] = (pruning ? pruning[i] : 1.0) * maxdist;

  /* rebuild lazy center-partsum cache for the main loop */
  for (i = 0; i < d; i++) {
    cps(i, d) = target ? target[i] : 0.0;
    cpb[i + 1] = d - 1;
  }
  cpb[0] = 0;
  partdist[d] = 0.0;
  for (i = k + 1; i < d; i++) nodes_per_level[i] -= 1.0;
  k = d - 1;

  res->found = 0;
  res->best_dist = INFINITY;
  res->sol_count = 0.0;
  res->visited = 0;

  while (1) {
    double alphak, newdist;
    if (res->nodes_budget && res->visited >= res->nodes_budget) break;
    res->visited++;
    alphak = x[k] - center[k];
    newdist = partdist[k] + alphak * alphak * rdiag[k];
    if (newdist <= bounds[k]) {
      nodes_per_level[k] += 1.0;
      alpha[k] = alphak;
      k -= 1;
      if (k < 0) {
        /* bottom: solution */
        if (newdist > 0.0 || !is_svp) {
          res->sol_count += 1.0;
          if (newdist < res->best_dist) {
            res->best_dist = newdist;
            memcpy(best_x, x, (size_t)d * sizeof(double));
            res->found = 1;
            if (!count_mode) {
              maxdist = newdist;
              for (i = 0; i < d; i++)
                bounds[i] = (pruning ? pruning[i] : 1.0) * maxdist;
            }
          }
        }
        /* next_pos_up from k=-1 */
        k = 0;
        goto sibling;
      }
      /* descend: refresh lazy partial sums */
      if (dual) {
        for (j = cpb[k + 1]; j > k; --j)
          cps(k, j) = cps(k, j + 1) - alpha[j] * mut[k * d + j];
      } else {
        for (j = cpb[k + 1]; j > k; --j)
          cps(k, j) = cps(k, j + 1) - x[j] * mut[k * d + j];
      }
      if (cpb[k + 1] > cpb[k]) cpb[k] = cpb[k + 1];
      cpb[k + 1] = k + 1;
      center[k] = cps(k, k + 1);
      partdist[k] = newdist;
      x[k] = round(center[k]);
      dx[k] = ddx[k] = (center[k] >= x[k]) ? 1.0 : -1.0;
      continue;
    }
    /* bound fail: ascend */
    k += 1;
    if (k >= d) break;
  sibling:
    if (partdist[k] != 0.0) {
      x[k] += dx[k];
      ddx[k] = -ddx[k];
      dx[k] = ddx[k] - dx[k];
    } else {
      if (k >= d) break;
      if (is_svp) {
        x[k] += 1.0;
      } else {
        x[k] += dx[k];
        ddx[k] = -ddx[k];
        dx[k] = ddx[k] - dx[k];
      }
    }
  }

  res->maxdist = maxdist;
  free(cps_buf);
  return 0;
}
#undef cps

/* ------------------------------------------------------------------ */
/* Layered top-of-tree expansion producing subtree roots for the      */
/* batched device kernel (native version of the level loop of         */
/* DeviceEnumerator._gen_roots, enum/device.py; the role of enumlib's */
/* swirlys queue construction, enum-parallel/enumeration.h:311-380).  */
/* Exactly like the host expansion, dead chains (pd > A) are carried  */
/* through the levels (their intervals collapse to <= 1 child) and    */
/* filtered only at the end, so node counters agree with the Python   */
/* path to the last node.                                             */
/*                                                                    */
/* Each node is one record: its coordinate, its alpha (dual), its     */
/* partial distance, its zero-prefix flag and the index of its        */
/* parent. No node copies its parent's prefix: each parent of a level */
/* reads its prefix along its chain of parents into a row of scratch, */
/* and its center is summed from that row in the order and with the   */
/* expressions a copied prefix was summed with. The records of every  */
/* level live in scratch that is shared by all calls and only grows.  */
/* It is not thread-safe: the Python side holds one lock around every */
/* call below (native/__init__.py:_ROOTS_LOCK).                       */
/* ------------------------------------------------------------------ */

static struct {
  double *x, *al, *pd;   /* per node: coordinate, alpha, partial distance */
  int32_t *par;          /* per node: its parent's index (-1: the root) */
  unsigned char *zp;     /* per node: every coordinate above it is zero */
  size_t ncap, alcap;
  double *c, *lo;        /* per parent of the level being expanded: its */
  long *cnt;             /* center, first child and number of children */
  size_t pcap;
  double *pre;           /* and its prefix, a row of nfix */
  size_t precap;
  int32_t *keep;         /* the kept frontier of the last expansion */
  size_t kcap;
  uint64_t *key[2];      /* the sort's keys, permutation and digit counts */
  int32_t *perm[2];
  size_t scap;
  uint32_t hist[6][1 << 11];
  long rows;             /* kept frontier rows of the last expansion */
  int nfix;              /* and their fixed levels */
} rs;

#define RS_GROW(ptr, n)                                          \
  do {                                                           \
    void *q_ = realloc((ptr), (size_t)(n) * sizeof *(ptr));      \
    if (!q_) return -1;                                          \
    (ptr) = q_;                                                  \
  } while (0)

static size_t rs_cap(size_t old, size_t need) {
  size_t c = old ? old : 4096;
  while (c < need) c *= 2;
  return c;
}

static int rs_nodes(size_t need, int dual) {
  if (need > rs.ncap) {
    size_t c = rs_cap(rs.ncap, need);
    RS_GROW(rs.x, c);
    RS_GROW(rs.pd, c);
    RS_GROW(rs.par, c);
    RS_GROW(rs.zp, c);
    rs.ncap = c;
  }
  if (dual && rs.alcap < rs.ncap) {
    RS_GROW(rs.al, rs.ncap);
    rs.alcap = rs.ncap;
  }
  return 0;
}

static int rs_parents(size_t need) {
  if (need > rs.pcap) {
    size_t c = rs_cap(rs.pcap, need);
    RS_GROW(rs.c, c);
    RS_GROW(rs.lo, c);
    RS_GROW(rs.cnt, c);
    rs.pcap = c;
  }
  return 0;
}

static int rs_prefixes(size_t need) {
  if (need > rs.precap) {
    size_t c = rs_cap(rs.precap, need);
    RS_GROW(rs.pre, c);
    rs.precap = c;
  }
  return 0;
}

static int rs_rows(size_t need) {
  if (need > rs.kcap) {
    size_t c = rs_cap(rs.kcap, need);
    RS_GROW(rs.keep, c);
    rs.kcap = c;
  }
  return 0;
}

static int rs_sorting(size_t need) {
  if (need > rs.scap) {
    size_t c = rs_cap(rs.scap, need);
    RS_GROW(rs.key[0], c);
    RS_GROW(rs.key[1], c);
    RS_GROW(rs.perm[0], c);
    RS_GROW(rs.perm[1], c);
    rs.scap = c;
  }
  return 0;
}

/* Expand the top of the tree into the scratch (enum_roots_take writes
   the kept frontier out). Row r of the frontier holds the coordinates of
   levels m_real .. d-1 and its partial distance; rows are kept in
   expansion order where pd <= A.
   Returns 0 on success, 1 when the expansion cannot fit `cap` rows a
   level or `nfix_max` fixed levels while the device ceiling is still
   exceeded (the caller falls back to the host expansion), -1 on bad
   input or when memory runs out. */
int enum_gen_roots(int d,
                   const double *mut,   /* d*d, mut[i*d+j]=mu(j,i) */
                   const double *rdiag, /* d */
                   const double *prune, /* d or NULL */
                   const double *cp0,   /* d center partsums (zeros: SVP) */
                   double A, int is_svp, int dual, int max_device_levels,
                   long target, long cap, int nfix_max,
                   double *nodes_per_level, /* d, accumulated */
                   int *m_real_out, long *count_out) {
  rs.rows = 0;
  rs.nfix = 0;
  if (d < 2 || cap < 1) return -1;
  if (rs_nodes(1, dual)) return -1;
  /* node 0 is the root above level d-1: it fixes nothing */
  rs.x[0] = 0.0;
  rs.pd[0] = 0.0;
  rs.par[0] = -1;
  rs.zp[0] = (unsigned char)(is_svp != 0);
  if (dual) rs.al[0] = 0.0;
  size_t first = 0, used = 1; /* the current level: nodes [first, first+R) */
  long R = 1;
  int lvl = d - 1, nfix = 0;
  while (lvl >= 1) {
    int m_cand = lvl + 1;
    if (m_cand <= max_device_levels &&
        (R >= target || m_cand <= 2 || R >= cap))
      break;
    if (d - lvl > nfix_max) {
      /* out of fixed-coordinate room: stop if the device can take the
         tree from here, else hand the whole job back to the host */
      if (m_cand <= max_device_levels) break;
      return 1;
    }
    if (rs_parents((size_t)R) || rs_prefixes((size_t)R * (nfix + 1)))
      return -1;
    {
      double bnd = (prune ? prune[lvl] : 1.0) * A;
      const double *acc = dual ? rs.al : rs.x;
      long total = 0;
      /* pre-pass: size the whole level BEFORE materializing any child.
         A level either expands completely or not at all — an earlier
         mid-level "settle" dropped the unprocessed parents' subtrees,
         making device enumeration silently incomplete (missed shortest
         vectors). The host expansion's cnt.sum() pre-check is the
         model.
         Each parent's prefix, level lvl+1 first, is read along its
         chain of parents into a row of its own (walks of one length, so
         that the walks of several parents overlap); then each center is
         summed exactly as over a prefix copied into the node: the same
         loop, which the compiler vectorizes the same way, so the same
         products are fused or not. */
      for (long r0 = 0; r0 < R; r0++) {
        int32_t q = (int32_t)(first + (size_t)r0);
        double *pre = rs.pre + (size_t)r0 * nfix;
        for (int j = 0; j < nfix; j++) {
          pre[j] = acc[q];
          q = rs.par[q];
        }
      }
      for (long r0 = 0; r0 < R; r0++) {
        const double *pre = rs.pre + (size_t)r0 * nfix;
        double c = cp0[lvl];
        for (int j = 0; j < nfix; j++)
          c -= pre[j] * mut[(size_t)lvl * d + (lvl + 1 + j)];
        rs.c[r0] = c;
      }
      for (long r0 = 0; r0 < R; r0++) {
        size_t p = first + (size_t)r0;
        double c = rs.c[r0], pd0 = rs.pd[p];
        double room = bnd - pd0;
        double w = room > 0.0 ? sqrt(room / rdiag[lvl]) : 0.0;
        double lo = ceil(c - w), hi = floor(c + w);
        if (rs.zp[p] && lo < 0.0) lo = 0.0;
        long cnt = hi >= lo ? (long)(hi - lo) + 1 : 0;
        rs.lo[r0] = lo;
        rs.cnt[r0] = cnt;
        total += cnt;
      }
      if (total > cap) {
        if (m_cand <= max_device_levels) break; /* frontier is complete
                                                   at this height */
        return 1; /* too tall for the device, too wide for the cap */
      }
      if (used + (size_t)total > (size_t)INT32_MAX ||
          rs_nodes(used + (size_t)total, dual))
        return -1;
      size_t n = used;
      for (long r0 = 0; r0 < R; r0++) {
        size_t p = first + (size_t)r0;
        double c = rs.c[r0], pd0 = rs.pd[p];
        unsigned char zp0 = rs.zp[p];
        long cnt = rs.cnt[r0];
        nodes_per_level[lvl] += (double)cnt;
        for (long t = 0; t < cnt; t++, n++) {
          double xv = rs.lo[r0] + (double)t;
          double al = xv - c;
          double pdc = pd0 + al * al * rdiag[lvl];
          rs.x[n] = xv;
          if (dual) rs.al[n] = al;
          rs.pd[n] = pdc;
          rs.zp[n] = zp0 && xv == 0.0;
          rs.par[n] = (int32_t)p;
        }
      }
      first = used;
      used = n;
      R = total;
    }
    nfix++;
    lvl--;
    if (R == 0) break; /* bound prunes everything above the device tree */
  }
  *m_real_out = lvl + 1;
  if (rs_rows((size_t)R)) return -1;
  {
    long keep = 0;
    for (long r0 = 0; r0 < R; r0++) {
      size_t p = first + (size_t)r0;
      if (rs.pd[p] > A) continue; /* final filter (the keep mask) */
      rs.keep[keep++] = (int32_t)p;
    }
    rs.rows = keep;
    rs.nfix = nfix;
    *count_out = keep;
  }
  return 0;
}

/* The kept frontier of the last enum_gen_roots, in expansion order:
   out_x (and out_a under dual) rows*nfix row-major, column j the
   coordinate (alpha) of level m_real + j, read along the row's chain of
   parents; out_pd rows. */
void enum_roots_take(double *out_x, double *out_a, double *out_pd) {
  const long rows = rs.rows;
  const int nfix = rs.nfix;
  for (long i = 0; i < rows; i++) {
    double *ox = out_x + (size_t)i * nfix;
    double *oa = out_a ? out_a + (size_t)i * nfix : NULL;
    int32_t q = rs.keep[i];
    out_pd[i] = rs.pd[q];
    for (int j = 0; j < nfix; j++) {
      ox[j] = rs.x[q];
      if (oa) oa[j] = rs.al[q];
      q = rs.par[q];
    }
  }
}

/* The order-preserving bits of a double: unsigned comparison of the
   results orders the values (-0.0 as +0.0). */
static inline uint64_t rs_bits(double v) {
  uint64_t u;
  v += 0.0;
  memcpy(&u, &v, sizeof u);
  return (u >> 63) ? ~u : u | ((uint64_t)1 << 63);
}

/* Stable order of R partial distances, ties by index: an LSD radix sort
   of the order-preserving bits of each double with the row's index
   riding along, 11 bits a pass, passes whose digit every key shares
   skipped. Returns the permutation (in the scratch) or NULL when memory
   runs out. */
static const int32_t *rs_order(long R, const double *pd) {
  enum { BITS = 11, BUCKETS = 1 << BITS, PASSES = 6 };
  uint32_t (*hist)[BUCKETS] = rs.hist;
  if (rs_sorting((size_t)(R > 0 ? R : 1))) return NULL;
  uint64_t *k0 = rs.key[0], *k1 = rs.key[1];
  int32_t *p0 = rs.perm[0], *p1 = rs.perm[1];
  memset(rs.hist, 0, sizeof rs.hist);
  for (long i = 0; i < R; i++) {
    uint64_t k = rs_bits(pd[i]);
    k0[i] = k;
    p0[i] = (int32_t)i;
    for (int s = 0; s < PASSES; s++)
      hist[s][(k >> (s * BITS)) & (BUCKETS - 1)]++;
  }
  for (int s = 0; s < PASSES; s++) {
    uint32_t *h = hist[s];
    int shift = s * BITS, skip = 0;
    for (int b = 0; b < BUCKETS; b++)
      if (h[b]) {
        skip = h[b] == (uint32_t)R;
        break;
      }
    if (skip) continue;
    uint32_t sum = 0;
    for (int b = 0; b < BUCKETS; b++) {
      uint32_t t = h[b];
      h[b] = sum;
      sum += t;
    }
    for (long i = 0; i < R; i++) {
      uint32_t at = h[(k0[i] >> shift) & (BUCKETS - 1)]++;
      k1[at] = k0[i];
      p1[at] = p0[i];
    }
    uint64_t *tk = k0;
    k0 = k1;
    k1 = tk;
    int32_t *tp = p0;
    p0 = p1;
    p1 = tp;
  }
  return p0;
}

#define RS_PACK(T)                                                        \
  do {                                                                    \
    T *ox = (T *)out_x, *oa = (T *)out_a, *op = (T *)out_pd;              \
    for (long i = 0; i < R; i++) {                                        \
      size_t src = (size_t)order[i] * nfix, dst = (size_t)i * nfix_pad;   \
      for (int j = 0; j < nfix; j++) ox[dst + j] = (T)x[src + j];         \
      for (int j = nfix; j < nfix_pad; j++) ox[dst + j] = 0;              \
      if (oa) {                                                           \
        for (int j = 0; j < nfix; j++) oa[dst + j] = (T)a[src + j];       \
        for (int j = nfix; j < nfix_pad; j++) oa[dst + j] = 0;            \
      }                                                                   \
      op[i] = (T)pd[order[i]];                                            \
    }                                                                     \
    size_t tail = (size_t)(R_pad - R) * nfix_pad * sizeof(T);             \
    memset(ox + (size_t)R * nfix_pad, 0, tail);                           \
    if (oa) memset(oa + (size_t)R * nfix_pad, 0, tail);                   \
    for (long i = R; i < R_pad; i++) op[i] = (T)INFINITY;                 \
  } while (0)

/* One launch's root queue in the kernel's layout: the R frontier rows
   (x, and a under dual; row-major R*nfix float64) sorted by pd, stably,
   written as out_x (and out_a) R_pad*nfix_pad and out_pd R_pad of the
   kernel's element type (f32: float, else double), pad columns and pad
   rows zero, pad distances +inf. Returns 0, or -1 on bad sizes or when
   memory runs out. Uses the shared scratch (the caller holds the
   lock). */
int enum_roots_pack(long R, int nfix, const double *x, const double *a,
                    const double *pd, long R_pad, int nfix_pad, int f32,
                    void *out_x, void *out_a, void *out_pd) {
  if (R < 0 || nfix < 0 || R > R_pad || nfix > nfix_pad ||
      R > (long)INT32_MAX)
    return -1;
  const int32_t *order = rs_order(R, pd);
  if (!order) return -1;
  if (f32)
    RS_PACK(float);
  else
    RS_PACK(double);
  return 0;
}
#undef RS_PACK
#undef RS_GROW
