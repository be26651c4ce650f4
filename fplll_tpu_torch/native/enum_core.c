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
/* batched device kernel (native version of TPUEnumerator._gen_roots, */
/* enum/tpu.py; the role of enumlib's swirlys queue construction,     */
/* enum-parallel/enumeration.h:311-380). Row layout matches the       */
/* Python expansion: out_x[r*nfix + j] holds the coordinate of level  */
/* m_real + j (ascending). Exactly like the host expansion, dead      */
/* chains (pd > A) are carried through the levels (their intervals    */
/* collapse to <= 1 child) and filtered only at copy-out, so node     */
/* counters agree with the Python path to the last node.              */
/*                                                                    */
/* Returns 0 on success, 1 when the expansion cannot fit the caller's */
/* capacity / nfix_max while the device ceiling is still exceeded     */
/* (caller falls back to the host expansion), -1 on bad input.        */
int enum_gen_roots(int d,
                   const double *mut,   /* d*d, mut[i*d+j]=mu(j,i) */
                   const double *rdiag, /* d */
                   const double *prune, /* d or NULL */
                   const double *cp0,   /* d center partsums (zeros: SVP) */
                   double A, int is_svp, int dual, int max_device_levels,
                   long target, long cap, int nfix_max,
                   double *out_x,  /* cap*nfix_max (nfix cols used) */
                   double *out_a,  /* cap*nfix_max or NULL (primal) */
                   double *out_pd, /* cap */
                   double *nodes_per_level, /* d, accumulated */
                   int *m_real_out, long *count_out) {
  if (d < 2 || cap < 1) return -1;
  size_t stride = (size_t)nfix_max;
  double *bx = malloc((size_t)cap * stride * 8 * 2);
  double *ba = dual ? malloc((size_t)cap * stride * 8 * 2) : NULL;
  double *bpd = malloc((size_t)cap * 8 * 2);
  unsigned char *bzp = malloc((size_t)cap * 2);
  /* per-level interval scratch for the count-then-materialize pre-pass */
  double *bc = malloc((size_t)cap * 8);
  double *blo = malloc((size_t)cap * 8);
  long *bcnt = malloc((size_t)cap * sizeof(long));
  if (!bx || !bpd || !bzp || (dual && !ba) || !bc || !blo || !bcnt) {
    free(bx); free(ba); free(bpd); free(bzp);
    free(bc); free(blo); free(bcnt);
    return -1;
  }
  double *x_in = bx, *x_out = bx + (size_t)cap * stride;
  double *a_in = ba, *a_out = ba ? ba + (size_t)cap * stride : NULL;
  double *pd_in = bpd, *pd_out = bpd + cap;
  unsigned char *zp_in = bzp, *zp_out = bzp + cap;
  long R = 1;
  pd_in[0] = 0.0;
  zp_in[0] = (unsigned char)(is_svp != 0);
  int lvl = d - 1, nfix = 0, rc = 0;
  while (lvl >= 1) {
    int m_cand = lvl + 1;
    if (m_cand <= max_device_levels &&
        (R >= target || m_cand <= 2 || R >= cap))
      break;
    if (d - lvl > nfix_max) {
      /* out of fixed-coordinate room: stop if the device can take the
         tree from here, else hand the whole job back to the host */
      if (m_cand <= max_device_levels) break;
      rc = 1;
      goto out;
    }
    {
      double bnd = (prune ? prune[lvl] : 1.0) * A;
      long Rn = 0, total = 0;
      /* pre-pass: size the whole level BEFORE materializing any child.
         A level either expands completely or not at all — an earlier
         mid-level "settle" dropped the unprocessed parents' subtrees,
         making device enumeration silently incomplete (missed shortest
         vectors).  The host oracle's cnt.sum() pre-check is the model
         (enum/tpu.py:_gen_roots). */
      for (long r0 = 0; r0 < R; r0++) {
        const double *acc = dual ? a_in + (size_t)r0 * stride
                                 : x_in + (size_t)r0 * stride;
        double c = cp0[lvl];
        for (int j = 0; j < nfix; j++)
          c -= acc[j] * mut[(size_t)lvl * d + (lvl + 1 + j)];
        double pd0 = pd_in[r0];
        double room = bnd - pd0;
        double w = room > 0.0 ? sqrt(room / rdiag[lvl]) : 0.0;
        double lo = ceil(c - w), hi = floor(c + w);
        if (zp_in[r0] && lo < 0.0) lo = 0.0;
        long cnt = hi >= lo ? (long)(hi - lo) + 1 : 0;
        bc[r0] = c;
        blo[r0] = lo;
        bcnt[r0] = cnt;
        total += cnt;
      }
      if (total > cap) {
        if (m_cand <= max_device_levels) break; /* frontier is complete
                                                   at this height */
        rc = 1; /* too tall for the device, too wide for the cap */
        goto out;
      }
      for (long r0 = 0; r0 < R; r0++) {
        double c = bc[r0], pd0 = pd_in[r0];
        long cnt = bcnt[r0];
        nodes_per_level[lvl] += (double)cnt;
        for (long t = 0; t < cnt; t++) {
          double xv = blo[r0] + (double)t;
          double al = xv - c;
          double pdc = pd0 + al * al * rdiag[lvl];
          double *xd = x_out + (size_t)Rn * stride;
          xd[0] = xv;
          memcpy(xd + 1, x_in + (size_t)r0 * stride, (size_t)nfix * 8);
          if (dual) {
            double *ad = a_out + (size_t)Rn * stride;
            ad[0] = al;
            memcpy(ad + 1, a_in + (size_t)r0 * stride, (size_t)nfix * 8);
          }
          pd_out[Rn] = pdc;
          zp_out[Rn] = zp_in[r0] && xv == 0.0;
          Rn++;
        }
      }
      R = Rn;
    }
    {
      double *t;
      unsigned char *tz;
      t = x_in; x_in = x_out; x_out = t;
      if (dual) { t = a_in; a_in = a_out; a_out = t; }
      t = pd_in; pd_in = pd_out; pd_out = t;
      tz = zp_in; zp_in = zp_out; zp_out = tz;
    }
    nfix++;
    lvl--;
    if (R == 0) break; /* bound prunes everything above the device tree */
  }
  *m_real_out = lvl + 1;
  {
    long keep = 0;
    for (long r0 = 0; r0 < R; r0++) {
      if (pd_in[r0] > A) continue; /* final filter (enum/tpu.py keep mask) */
      memcpy(out_x + (size_t)keep * nfix_max, x_in + (size_t)r0 * stride,
             (size_t)nfix * 8);
      if (out_a && dual)
        memcpy(out_a + (size_t)keep * nfix_max, a_in + (size_t)r0 * stride,
               (size_t)nfix * 8);
      out_pd[keep] = pd_in[r0];
      keep++;
    }
    *count_out = keep;
  }
out:
  free(bx);
  free(ba);
  free(bpd);
  free(bzp);
  free(bc);
  free(blo);
  free(bcnt);
  return rc;
}
