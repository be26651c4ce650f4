/* fpnum: compiled host scalar tower for the precision ladder.
 *
 * One Python extension type `fpnum` with three kinds:
 *   - dpe: 53-bit mantissa + unbounded int64 exponent (the role of the
 *     reference's vendored dpe_t, fplll/nr/dpe.h:22);
 *   - dd : double-double, ~106-bit mantissa, double exponent range (the
 *     role of libqd's dd_real, fplll/nr/nr_FP_dd.inl);
 *   - qd : quad-double, ~212-bit mantissa (nr_FP_qd.inl).
 *
 * The arithmetic uses error-free transforms (TwoSum/TwoProd via FMA) and
 * expansion distillation; it is a fresh implementation, not a port of
 * libqd (same published algorithms: Dekker/Knuth EFTs, Hida-Li-Bailey
 * expansions, Ogita-Rump-Oishi distillation).
 *
 * These types plug into the GSO/Householder/LLL engines through the
 * float-context protocol (fplll_tpu/nr/fctx.py) as the compiled
 * replacements for the mpmath soft-float at 53/106/212 bits.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#define NPY_NO_DEPRECATED_API NPY_1_7_API_VERSION
#include <numpy/arrayobject.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

/* ------------------------------------------------------------------ */
/* error-free transforms                                              */
/* ------------------------------------------------------------------ */
static inline double two_sum(double a, double b, double *err)
{
    double s = a + b;
    double bb = s - a;
    *err = (a - (s - bb)) + (b - bb);
    return s;
}

static inline double quick_two_sum(double a, double b, double *err)
{
    double s = a + b;
    *err = b - (s - a);
    return s;
}

static inline double two_prod(double a, double b, double *err)
{
    double p = a * b;
    *err = fma(a, b, -p);
    return p;
}

/* ------------------------------------------------------------------ */
/* dd core                                                            */
/* ------------------------------------------------------------------ */
typedef struct { double hi, lo; } dd_t;

static inline dd_t dd_mk(double hi, double lo)
{
    dd_t r; r.hi = quick_two_sum(hi, lo, &r.lo); return r;
}

static inline dd_t dd_from_d(double d) { dd_t r = {d, 0.0}; return r; }

static dd_t dd_add(dd_t a, dd_t b)
{
    double s1, s2, t1, t2;
    s1 = two_sum(a.hi, b.hi, &s2);
    t1 = two_sum(a.lo, b.lo, &t2);
    s2 += t1;
    s1 = quick_two_sum(s1, s2, &s2);
    s2 += t2;
    s1 = quick_two_sum(s1, s2, &s2);
    dd_t r = {s1, s2}; return r;
}

static inline dd_t dd_neg(dd_t a) { dd_t r = {-a.hi, -a.lo}; return r; }
static inline dd_t dd_sub(dd_t a, dd_t b) { return dd_add(a, dd_neg(b)); }

static dd_t dd_mul(dd_t a, dd_t b)
{
    double p1, p2;
    p1 = two_prod(a.hi, b.hi, &p2);
    p2 += a.hi * b.lo + a.lo * b.hi;
    p1 = quick_two_sum(p1, p2, &p2);
    dd_t r = {p1, p2}; return r;
}

static inline dd_t dd_mul_d(dd_t a, double b)
{
    double p1, p2;
    p1 = two_prod(a.hi, b, &p2);
    p2 += a.lo * b;
    p1 = quick_two_sum(p1, p2, &p2);
    dd_t r = {p1, p2}; return r;
}

static dd_t dd_div(dd_t a, dd_t b)
{
    double q1, q2, q3;
    dd_t r;
    q1 = a.hi / b.hi;
    if (!isfinite(q1)) { dd_t z = {q1, 0.0}; return z; }
    r = dd_sub(a, dd_mul_d(b, q1));
    q2 = r.hi / b.hi;
    r = dd_sub(r, dd_mul_d(b, q2));
    q3 = r.hi / b.hi;
    q1 = quick_two_sum(q1, q2, &q2);
    return dd_add(dd_mk(q1, q2), dd_from_d(q3));
}

static dd_t dd_sqrt(dd_t a)
{
    if (a.hi == 0.0 && a.lo == 0.0) return dd_from_d(0.0);
    if (a.hi < 0.0) return dd_from_d(NAN);
    double x0 = sqrt(a.hi);
    /* one Newton step in dd: s = x0 + (a - x0^2) / (2 x0) */
    double e;
    double p = two_prod(x0, x0, &e);
    dd_t x0sq = {p, e};
    dd_t diff = dd_sub(a, x0sq);
    dd_t corr = dd_mul_d(diff, 0.5 / x0);
    return dd_add(dd_from_d(x0), corr);
}

static dd_t dd_nint(dd_t a)
{
    double hi = rint(a.hi), lo = 0.0;
    if (hi == a.hi) {
        lo = rint(a.lo);
        double e;
        hi = quick_two_sum(hi, lo, &e);
        dd_t r = {hi, e}; return r;
    }
    if (fabs(hi - a.hi) == 0.5) {
        /* a.hi is a half-integer; lo decides the direction */
        if (hi > a.hi && a.lo < 0.0) hi -= 1.0;
        else if (hi < a.hi && a.lo > 0.0) hi += 1.0;
    }
    dd_t r = {hi, 0.0}; return r;
}

static inline dd_t dd_ldexp(dd_t a, long e)
{
    dd_t r = {ldexp(a.hi, (int)e), ldexp(a.lo, (int)e)}; return r;
}

static inline int dd_cmp(dd_t a, dd_t b)
{
    if (a.hi < b.hi) return -1;
    if (a.hi > b.hi) return 1;
    if (a.lo < b.lo) return -1;
    if (a.lo > b.lo) return 1;
    return 0;
}

/* ------------------------------------------------------------------ */
/* qd core: expansions of 4 doubles, distillation-based               */
/* ------------------------------------------------------------------ */
typedef struct { double x[4]; } qd_t;

static inline qd_t qd_from_d(double d)
{
    qd_t r = {{d, 0.0, 0.0, 0.0}}; return r;
}

/* renormalize 5 doubles into a 4-term nonoverlapping expansion */
static void renorm5(double c0, double c1, double c2, double c3, double c4,
                    qd_t *out)
{
    double s0, s1, s2 = 0.0, s3 = 0.0;
    if (!isfinite(c0)) {
        out->x[0] = c0; out->x[1] = out->x[2] = out->x[3] = 0.0;
        return;
    }
    s0 = quick_two_sum(c3, c4, &c4);
    s0 = quick_two_sum(c2, s0, &c3);
    s0 = quick_two_sum(c1, s0, &c2);
    c0 = quick_two_sum(c0, s0, &c1);
    s0 = c0; s1 = c1;
    s0 = quick_two_sum(c0, c1, &s1);
    if (s1 != 0.0) {
        s1 = quick_two_sum(s1, c2, &s2);
        if (s2 != 0.0) {
            s2 = quick_two_sum(s2, c3, &s3);
            if (s3 != 0.0) s3 += c4; else s2 += c4;
        } else {
            s1 = quick_two_sum(s1, c3, &s2);
            if (s2 != 0.0) s2 = quick_two_sum(s2, c4, &s3);
            else s1 = quick_two_sum(s1, c4, &s2);
        }
    } else {
        s0 = quick_two_sum(s0, c2, &s1);
        if (s1 != 0.0) {
            s1 = quick_two_sum(s1, c3, &s2);
            if (s2 != 0.0) s2 = quick_two_sum(s2, c4, &s3);
            else s1 = quick_two_sum(s1, c4, &s2);
        } else {
            s0 = quick_two_sum(s0, c3, &s1);
            if (s1 != 0.0) s1 = quick_two_sum(s1, c4, &s2);
            else s0 = quick_two_sum(s0, c4, &s1);
        }
    }
    out->x[0] = s0; out->x[1] = s1; out->x[2] = s2; out->x[3] = s3;
}

/* distill n (<=16) doubles into a qd: K=4 VecSum sweeps (SumK-style,
 * Ogita-Rump-Oishi) then renorm. Input should be roughly ordered by
 * decreasing magnitude for best accuracy. */
static qd_t qd_distill(double *t, int n)
{
    int k, i;
    for (k = 0; k < 4 && k < n - 1; k++)
        for (i = n - 2; i >= k; i--)
            t[i] = two_sum(t[i], t[i + 1], &t[i + 1]);
    {
        double tail = 0.0;
        for (i = 4; i < n; i++) tail += t[i];
        qd_t r;
        renorm5(n > 0 ? t[0] : 0.0, n > 1 ? t[1] : 0.0,
                n > 2 ? t[2] : 0.0, n > 3 ? t[3] : 0.0, tail, &r);
        return r;
    }
}

static qd_t qd_add(qd_t a, qd_t b)
{
    /* merge the two (decreasing) expansions by magnitude, then distill */
    double t[8];
    int i = 0, j = 0, k = 0;
    while (i < 4 && j < 4)
        t[k++] = (fabs(a.x[i]) >= fabs(b.x[j])) ? a.x[i++] : b.x[j++];
    while (i < 4) t[k++] = a.x[i++];
    while (j < 4) t[k++] = b.x[j++];
    return qd_distill(t, 8);
}

static inline qd_t qd_neg(qd_t a)
{
    qd_t r = {{-a.x[0], -a.x[1], -a.x[2], -a.x[3]}}; return r;
}

static inline qd_t qd_sub(qd_t a, qd_t b) { return qd_add(a, qd_neg(b)); }

static qd_t qd_mul(qd_t a, qd_t b)
{
    /* partial products by order with EFT errors; order-3 errors and
     * order-4 products are below 2^-212 relative and are dropped. */
    double t[16];
    int n = 0;
    double e;
    t[n++] = two_prod(a.x[0], b.x[0], &e); t[n++] = e;          /* order 0 */
    t[n++] = two_prod(a.x[0], b.x[1], &e); t[n++] = e;          /* order 1 */
    t[n++] = two_prod(a.x[1], b.x[0], &e); t[n++] = e;
    t[n++] = two_prod(a.x[0], b.x[2], &e); t[n++] = e;          /* order 2 */
    t[n++] = two_prod(a.x[1], b.x[1], &e); t[n++] = e;
    t[n++] = two_prod(a.x[2], b.x[0], &e); t[n++] = e;
    t[n++] = a.x[0] * b.x[3];                                   /* order 3 */
    t[n++] = a.x[1] * b.x[2];
    t[n++] = a.x[2] * b.x[1];
    t[n++] = a.x[3] * b.x[0];
    return qd_distill(t, n);
}

static qd_t qd_mul_d(qd_t a, double b)
{
    double t[8];
    int n = 0;
    double e;
    t[n++] = two_prod(a.x[0], b, &e); t[n++] = e;
    t[n++] = two_prod(a.x[1], b, &e); t[n++] = e;
    t[n++] = two_prod(a.x[2], b, &e); t[n++] = e;
    t[n++] = a.x[3] * b;
    return qd_distill(t, n);
}

static qd_t qd_div(qd_t a, qd_t b)
{
    double q0, q1, q2, q3, q4;
    qd_t r;
    q0 = a.x[0] / b.x[0];
    if (!isfinite(q0)) return qd_from_d(q0);
    r = qd_sub(a, qd_mul_d(b, q0));
    q1 = r.x[0] / b.x[0];
    r = qd_sub(r, qd_mul_d(b, q1));
    q2 = r.x[0] / b.x[0];
    r = qd_sub(r, qd_mul_d(b, q2));
    q3 = r.x[0] / b.x[0];
    r = qd_sub(r, qd_mul_d(b, q3));
    q4 = r.x[0] / b.x[0];
    {
        qd_t out;
        renorm5(q0, q1, q2, q3, q4, &out);
        return out;
    }
}

static qd_t qd_sqrt(qd_t a)
{
    if (a.x[0] == 0.0 && a.x[1] == 0.0) return qd_from_d(0.0);
    if (a.x[0] < 0.0) return qd_from_d(NAN);
    /* Newton on s = 0.5*(s + a/s), two steps from the double seed:
       53 -> 106 -> 212 bits. */
    qd_t s = qd_from_d(sqrt(a.x[0]));
    int it;
    for (it = 0; it < 2; it++)
        s = qd_mul_d(qd_add(s, qd_div(a, s)), 0.5);
    return s;
}

static qd_t qd_nint(qd_t a)
{
    double r0 = rint(a.x[0]), r1 = 0.0, r2 = 0.0, r3 = 0.0;
    if (r0 == a.x[0]) {
        r1 = rint(a.x[1]);
        if (r1 == a.x[1]) {
            r2 = rint(a.x[2]);
            if (r2 == a.x[2]) {
                r3 = rint(a.x[3]);
            } else if (fabs(r2 - a.x[2]) == 0.5) {
                if (r2 > a.x[2] && a.x[3] < 0.0) r2 -= 1.0;
                else if (r2 < a.x[2] && a.x[3] > 0.0) r2 += 1.0;
            }
        } else if (fabs(r1 - a.x[1]) == 0.5) {
            if (r1 > a.x[1] && a.x[2] < 0.0) r1 -= 1.0;
            else if (r1 < a.x[1] && a.x[2] > 0.0) r1 += 1.0;
        }
    } else if (fabs(r0 - a.x[0]) == 0.5) {
        if (r0 > a.x[0] && a.x[1] < 0.0) r0 -= 1.0;
        else if (r0 < a.x[0] && a.x[1] > 0.0) r0 += 1.0;
    }
    {
        qd_t out;
        renorm5(r0, r1, r2, r3, 0.0, &out);
        return out;
    }
}

static inline qd_t qd_ldexp(qd_t a, long e)
{
    qd_t r = {{ldexp(a.x[0], (int)e), ldexp(a.x[1], (int)e),
               ldexp(a.x[2], (int)e), ldexp(a.x[3], (int)e)}};
    return r;
}

static inline int qd_cmp(qd_t a, qd_t b)
{
    int i;
    for (i = 0; i < 4; i++) {
        if (a.x[i] < b.x[i]) return -1;
        if (a.x[i] > b.x[i]) return 1;
    }
    return 0;
}

/* ------------------------------------------------------------------ */
/* dpe core: double mantissa in [0.5, 1) + int64 exponent             */
/* ------------------------------------------------------------------ */
typedef struct { double m; int64_t e; } dpe_t;

static inline dpe_t dpe_norm(double m, int64_t e)
{
    dpe_t r;
    int k;
    if (m == 0.0 || !isfinite(m)) { r.m = m; r.e = 0; return r; }
    r.m = frexp(m, &k);
    r.e = e + k;
    return r;
}

static inline dpe_t dpe_from_d(double d) { return dpe_norm(d, 0); }

static dpe_t dpe_add(dpe_t a, dpe_t b)
{
    if (a.m == 0.0) return b;
    if (b.m == 0.0) return a;
    if (!isfinite(a.m) || !isfinite(b.m))
        return dpe_norm(a.m + b.m, 0);
    if (a.e - b.e > 55) return a;
    if (b.e - a.e > 55) return b;
    if (a.e >= b.e)
        return dpe_norm(a.m + ldexp(b.m, (int)(b.e - a.e)), a.e);
    return dpe_norm(b.m + ldexp(a.m, (int)(a.e - b.e)), b.e);
}

static inline dpe_t dpe_neg(dpe_t a) { dpe_t r = {-a.m, a.e}; return r; }
static inline dpe_t dpe_sub(dpe_t a, dpe_t b) { return dpe_add(a, dpe_neg(b)); }

static inline dpe_t dpe_mul(dpe_t a, dpe_t b)
{
    return dpe_norm(a.m * b.m, a.e + b.e);
}

static inline dpe_t dpe_div(dpe_t a, dpe_t b)
{
    if (b.m == 0.0) { dpe_t r = {a.m / b.m, 0}; return r; }
    return dpe_norm(a.m / b.m, a.e - b.e);
}

static dpe_t dpe_sqrt(dpe_t a)
{
    double m = a.m;
    int64_t e = a.e;
    if (m < 0.0) { dpe_t r = {NAN, 0}; return r; }
    if (m == 0.0) { dpe_t r = {0.0, 0}; return r; }
    if (e & 1) { m *= 2.0; e -= 1; }
    return dpe_norm(sqrt(m), e / 2);
}

static dpe_t dpe_nint(dpe_t a)
{
    if (!isfinite(a.m) || a.m == 0.0) return a;
    if (a.e > 53) return a;          /* already an integer */
    if (a.e < -1) { dpe_t r = {0.0, 0}; return r; }
    return dpe_from_d(rint(ldexp(a.m, (int)a.e)));
}

static inline dpe_t dpe_ldexp(dpe_t a, long e)
{
    dpe_t r = a;
    if (r.m != 0.0 && isfinite(r.m)) r.e += e;
    return r;
}

static int dpe_cmp(dpe_t a, dpe_t b)
{
    /* finite normalized values: compare by sign, then exponent, then m */
    if (!isfinite(a.m) || !isfinite(b.m)) {
        double x = a.m, y = b.m;
        if (x < y) return -1;
        if (x > y) return 1;
        return 0;
    }
    int sa = (a.m > 0.0) - (a.m < 0.0);
    int sb = (b.m > 0.0) - (b.m < 0.0);
    if (sa != sb) return sa < sb ? -1 : 1;
    if (sa == 0) return 0;
    if (a.e != b.e) {
        int c = a.e < b.e ? -1 : 1;
        return sa > 0 ? c : -c;
    }
    if (a.m < b.m) return -1;
    if (a.m > b.m) return 1;
    return 0;
}

static inline double dpe_to_d(dpe_t a)
{
    if (a.m == 0.0 || !isfinite(a.m)) return a.m;
    if (a.e > 1100) return a.m > 0 ? INFINITY : -INFINITY;
    if (a.e < -1100) return a.m > 0 ? 0.0 : -0.0;
    return ldexp(a.m, (int)a.e);
}

/* ------------------------------------------------------------------ */
/* dde/qde cores: dd/qd mantissa + unbounded int64 exponent.           */
/* The "mpfr role" tiers: ~106/~212-bit mantissa with dpe-style        */
/* exponent range, so huge-entry bases (3000-bit knapsacks) that       */
/* overflow the double exponent range still reduce at high precision   */
/* (the reference serves this with mpfr, nr/nr_FP_mpfr.inl).           */
/* Mantissa normalized so hi is in [0.5, 1).                           */
/* ------------------------------------------------------------------ */
typedef struct { dd_t m; int64_t e; } dde_t;
typedef struct { qd_t m; int64_t e; } qde_t;

static dde_t dde_norm(dd_t m, int64_t e)
{
    dde_t r; int k;
    if (m.hi == 0.0 || !isfinite(m.hi)) { r.m = m; r.e = 0; return r; }
    frexp(m.hi, &k);
    r.m = dd_ldexp(m, -k);
    r.e = e + k;
    return r;
}

static qde_t qde_norm(qd_t m, int64_t e)
{
    qde_t r; int k;
    if (m.x[0] == 0.0 || !isfinite(m.x[0])) { r.m = m; r.e = 0; return r; }
    frexp(m.x[0], &k);
    r.m = qd_ldexp(m, -k);
    r.e = e + k;
    return r;
}

static inline dde_t dde_from_d(double d) { return dde_norm(dd_from_d(d), 0); }
static inline qde_t qde_from_d(double d) { return qde_norm(qd_from_d(d), 0); }

static dde_t dde_add(dde_t a, dde_t b)
{
    int64_t de;
    if (a.m.hi == 0.0) return b;
    if (b.m.hi == 0.0) return a;
    if (!isfinite(a.m.hi) || !isfinite(b.m.hi))
        return dde_norm(dd_add(a.m, b.m), 0);
    de = a.e - b.e;
    if (de > 110) return a;
    if (de < -110) return b;
    if (de >= 0)
        return dde_norm(dd_add(a.m, dd_ldexp(b.m, (long)-de)), a.e);
    return dde_norm(dd_add(b.m, dd_ldexp(a.m, (long)de)), b.e);
}

static inline dde_t dde_neg(dde_t a) { dde_t r = {dd_neg(a.m), a.e}; return r; }
static inline dde_t dde_sub(dde_t a, dde_t b) { return dde_add(a, dde_neg(b)); }
static inline dde_t dde_mul(dde_t a, dde_t b)
{
    return dde_norm(dd_mul(a.m, b.m), a.e + b.e);
}
static inline dde_t dde_div(dde_t a, dde_t b)
{
    if (b.m.hi == 0.0) return dde_norm(dd_div(a.m, b.m), 0);
    return dde_norm(dd_div(a.m, b.m), a.e - b.e);
}

static dde_t dde_sqrt(dde_t a)
{
    dd_t m; int64_t e;
    if (a.m.hi < 0.0) { dde_t r = {{NAN, 0.0}, 0}; return r; }
    if (a.m.hi == 0.0 || !isfinite(a.m.hi)) return a;
    m = a.m; e = a.e;
    if (e & 1) { m = dd_ldexp(m, -1); e += 1; }
    return dde_norm(dd_sqrt(m), e / 2);
}

static dde_t dde_nint(dde_t a)
{
    if (a.m.hi == 0.0 || !isfinite(a.m.hi)) return a;
    if (a.e > 110) return a;               /* already an integer */
    if (a.e < -1) { dde_t r = {{0.0, 0.0}, 0}; return r; }
    return dde_norm(dd_nint(dd_ldexp(a.m, (long)a.e)), 0);
}

static inline dde_t dde_ldexp(dde_t a, long e)
{
    dde_t r = a;
    if (r.m.hi != 0.0 && isfinite(r.m.hi)) r.e += e;
    return r;
}

static int dde_cmp(dde_t a, dde_t b)
{
    int sa, sb;
    if (!isfinite(a.m.hi) || !isfinite(b.m.hi)) {
        if (a.m.hi < b.m.hi) return -1;
        if (a.m.hi > b.m.hi) return 1;
        return 0;
    }
    sa = (a.m.hi > 0.0) - (a.m.hi < 0.0);
    sb = (b.m.hi > 0.0) - (b.m.hi < 0.0);
    if (sa != sb) return sa < sb ? -1 : 1;
    if (sa == 0) return 0;
    if (a.e != b.e) {
        int c = a.e < b.e ? -1 : 1;
        return sa > 0 ? c : -c;
    }
    return dd_cmp(a.m, b.m);
}

static inline double dde_to_d(dde_t a)
{
    if (a.m.hi == 0.0 || !isfinite(a.m.hi)) return a.m.hi;
    if (a.e > 1100) return a.m.hi > 0 ? INFINITY : -INFINITY;
    if (a.e < -1100) return a.m.hi > 0 ? 0.0 : -0.0;
    return ldexp(a.m.hi + a.m.lo, (int)a.e);
}

static qde_t qde_add(qde_t a, qde_t b)
{
    int64_t de;
    if (a.m.x[0] == 0.0) return b;
    if (b.m.x[0] == 0.0) return a;
    if (!isfinite(a.m.x[0]) || !isfinite(b.m.x[0]))
        return qde_norm(qd_add(a.m, b.m), 0);
    de = a.e - b.e;
    if (de > 220) return a;
    if (de < -220) return b;
    if (de >= 0)
        return qde_norm(qd_add(a.m, qd_ldexp(b.m, (long)-de)), a.e);
    return qde_norm(qd_add(b.m, qd_ldexp(a.m, (long)de)), b.e);
}

static inline qde_t qde_neg(qde_t a) { qde_t r = {qd_neg(a.m), a.e}; return r; }
static inline qde_t qde_sub(qde_t a, qde_t b) { return qde_add(a, qde_neg(b)); }
static inline qde_t qde_mul(qde_t a, qde_t b)
{
    return qde_norm(qd_mul(a.m, b.m), a.e + b.e);
}
static inline qde_t qde_div(qde_t a, qde_t b)
{
    if (b.m.x[0] == 0.0) return qde_norm(qd_div(a.m, b.m), 0);
    return qde_norm(qd_div(a.m, b.m), a.e - b.e);
}

static qde_t qde_sqrt(qde_t a)
{
    qd_t m; int64_t e;
    if (a.m.x[0] < 0.0) return qde_norm(qd_from_d(NAN), 0);
    if (a.m.x[0] == 0.0 || !isfinite(a.m.x[0])) return a;
    m = a.m; e = a.e;
    if (e & 1) { m = qd_ldexp(m, -1); e += 1; }
    return qde_norm(qd_sqrt(m), e / 2);
}

static qde_t qde_nint(qde_t a)
{
    if (a.m.x[0] == 0.0 || !isfinite(a.m.x[0])) return a;
    if (a.e > 220) return a;
    if (a.e < -1) return qde_norm(qd_from_d(0.0), 0);
    return qde_norm(qd_nint(qd_ldexp(a.m, (long)a.e)), 0);
}

static inline qde_t qde_ldexp(qde_t a, long e)
{
    qde_t r = a;
    if (r.m.x[0] != 0.0 && isfinite(r.m.x[0])) r.e += e;
    return r;
}

static int qde_cmp(qde_t a, qde_t b)
{
    int sa, sb;
    if (!isfinite(a.m.x[0]) || !isfinite(b.m.x[0])) {
        if (a.m.x[0] < b.m.x[0]) return -1;
        if (a.m.x[0] > b.m.x[0]) return 1;
        return 0;
    }
    sa = (a.m.x[0] > 0.0) - (a.m.x[0] < 0.0);
    sb = (b.m.x[0] > 0.0) - (b.m.x[0] < 0.0);
    if (sa != sb) return sa < sb ? -1 : 1;
    if (sa == 0) return 0;
    if (a.e != b.e) {
        int c = a.e < b.e ? -1 : 1;
        return sa > 0 ? c : -c;
    }
    return qd_cmp(a.m, b.m);
}

static inline double qde_to_d(qde_t a)
{
    if (a.m.x[0] == 0.0 || !isfinite(a.m.x[0])) return a.m.x[0];
    if (a.e > 1100) return a.m.x[0] > 0 ? INFINITY : -INFINITY;
    if (a.e < -1100) return a.m.x[0] > 0 ? 0.0 : -0.0;
    return ldexp(a.m.x[0] + a.m.x[1], (int)a.e);
}

/* ------------------------------------------------------------------ */
/* the Python object: tagged union                                     */
/* ------------------------------------------------------------------ */
enum { KIND_DPE = 0, KIND_DD = 1, KIND_QD = 2, KIND_DDE = 3, KIND_QDE = 4 };

/* generic value: one struct covering all five kinds, so every op site
 * dispatches once through the fpv_* helpers below */
typedef union {
    dpe_t dpe;
    dd_t dd;
    qd_t qd;
    dde_t dde;
    qde_t qde;
} fpu;

typedef struct {
    PyObject_HEAD
    int kind;
    fpu v;
} FpNum;

static PyTypeObject FpNumType;   /* forward */

static FpNum *fp_alloc(int kind)
{
    FpNum *r = PyObject_New(FpNum, &FpNumType);
    if (r) { r->kind = kind; memset(&r->v, 0, sizeof(r->v)); }
    return r;
}

typedef struct { int kind; fpu v; } fpv;

static FpNum *fp_from_v(fpv x)
{
    FpNum *r = fp_alloc(x.kind);
    if (r) r->v = x.v;
    return r;
}

static inline fpv fpv_of(const FpNum *f)
{
    fpv r; r.kind = f->kind; r.v = f->v; return r;
}

static FpNum *fp_from_dpe(dpe_t x)
{
    FpNum *r = fp_alloc(KIND_DPE);
    if (r) r->v.dpe = x;
    return r;
}

static FpNum *fp_from_dd(dd_t x)
{
    FpNum *r = fp_alloc(KIND_DD);
    if (r) r->v.dd = x;
    return r;
}

static FpNum *fp_from_qd(qd_t x)
{
    FpNum *r = fp_alloc(KIND_QD);
    if (r) r->v.qd = x;
    return r;
}

/* ---- generic op dispatch ---- */
#define FPV_BIN(name, op)                                                   \
static fpv fpv_##name(fpv a, fpv b)                                         \
{                                                                           \
    fpv r; r.kind = a.kind;                                                 \
    switch (a.kind) {                                                       \
    case KIND_DPE: r.v.dpe = dpe_##op(a.v.dpe, b.v.dpe); break;             \
    case KIND_DD:  r.v.dd  = dd_##op(a.v.dd, b.v.dd); break;                \
    case KIND_QD:  r.v.qd  = qd_##op(a.v.qd, b.v.qd); break;                \
    case KIND_DDE: r.v.dde = dde_##op(a.v.dde, b.v.dde); break;             \
    default:       r.v.qde = qde_##op(a.v.qde, b.v.qde); break;             \
    }                                                                       \
    return r;                                                               \
}

FPV_BIN(add, add)
FPV_BIN(sub, sub)
FPV_BIN(mul, mul)
FPV_BIN(div, div)

#define FPV_UN(name, op)                                                    \
static fpv fpv_##name(fpv a)                                                \
{                                                                           \
    fpv r; r.kind = a.kind;                                                 \
    switch (a.kind) {                                                       \
    case KIND_DPE: r.v.dpe = dpe_##op(a.v.dpe); break;                      \
    case KIND_DD:  r.v.dd  = dd_##op(a.v.dd); break;                        \
    case KIND_QD:  r.v.qd  = qd_##op(a.v.qd); break;                        \
    case KIND_DDE: r.v.dde = dde_##op(a.v.dde); break;                      \
    default:       r.v.qde = qde_##op(a.v.qde); break;                      \
    }                                                                       \
    return r;                                                               \
}

FPV_UN(neg, neg)
FPV_UN(sqrt, sqrt)
FPV_UN(nint, nint)

static fpv fpv_ldexp(fpv a, long e)
{
    fpv r; r.kind = a.kind;
    switch (a.kind) {
    case KIND_DPE: r.v.dpe = dpe_ldexp(a.v.dpe, e); break;
    case KIND_DD:  r.v.dd  = dd_ldexp(a.v.dd, e); break;
    case KIND_QD:  r.v.qd  = qd_ldexp(a.v.qd, e); break;
    case KIND_DDE: r.v.dde = dde_ldexp(a.v.dde, e); break;
    default:       r.v.qde = qde_ldexp(a.v.qde, e); break;
    }
    return r;
}

static int fpv_cmp(fpv a, fpv b)
{
    switch (a.kind) {
    case KIND_DPE: return dpe_cmp(a.v.dpe, b.v.dpe);
    case KIND_DD:  return dd_cmp(a.v.dd, b.v.dd);
    case KIND_QD:  return qd_cmp(a.v.qd, b.v.qd);
    case KIND_DDE: return dde_cmp(a.v.dde, b.v.dde);
    default:       return qde_cmp(a.v.qde, b.v.qde);
    }
}

static double fpv_lead(fpv a)  /* leading double component */
{
    switch (a.kind) {
    case KIND_DPE: return a.v.dpe.m;
    case KIND_DD:  return a.v.dd.hi;
    case KIND_QD:  return a.v.qd.x[0];
    case KIND_DDE: return a.v.dde.m.hi;
    default:       return a.v.qde.m.x[0];
    }
}

static inline int fpv_iszero(fpv a) { return fpv_lead(a) == 0.0; }
static inline int fpv_isfinite(fpv a) { return isfinite(fpv_lead(a)); }
static inline int fpv_isnan(fpv a) { return isnan(fpv_lead(a)); }
static inline int fpv_sign(fpv a)
{
    double l = fpv_lead(a);
    return (l > 0.0) - (l < 0.0);
}

static double fpv_to_d(fpv a)
{
    switch (a.kind) {
    case KIND_DPE: return dpe_to_d(a.v.dpe);
    case KIND_DD:  return a.v.dd.hi + a.v.dd.lo;
    case KIND_QD:  return a.v.qd.x[0] + a.v.qd.x[1];
    case KIND_DDE: return dde_to_d(a.v.dde);
    default:       return qde_to_d(a.v.qde);
    }
}

/* frexp-style exponent: 2^(e-1) <= |x| < 2^e (FP_NR::exponent) */
static int64_t fpv_exponent(fpv a)
{
    double l; int e;
    if (fpv_iszero(a) || !fpv_isfinite(a)) return 0;
    switch (a.kind) {
    case KIND_DPE: return a.v.dpe.e;
    case KIND_DDE: return a.v.dde.e;
    case KIND_QDE: return a.v.qde.e;
    default: break;
    }
    l = fpv_lead(a);
    frexp(l, &e);
    return e;
}

static fpv fpv_from_d(int kind, double d)
{
    fpv r; r.kind = kind;
    switch (kind) {
    case KIND_DPE: r.v.dpe = dpe_from_d(d); break;
    case KIND_DD:  r.v.dd  = dd_from_d(d); break;
    case KIND_QD:  r.v.qd  = qd_from_d(d); break;
    case KIND_DDE: r.v.dde = dde_from_d(d); break;
    default:       r.v.qde = qde_from_d(d); break;
    }
    return r;
}

static FpNum *fp_make(int kind, dpe_t dp, dd_t dd, qd_t qd)
{
    switch (kind) {
    case KIND_DPE: return fp_from_dpe(dp);
    case KIND_DD:  return fp_from_dd(dd);
    default:       return fp_from_qd(qd);
    }
}

/* sign of a PyLong that is known to overflow a C long */
static int pylong_overflow_sign(PyObject *o)
{
    int ovf = 0;
    (void)PyLong_AsLongAndOverflow(o, &ovf);
    return ovf;   /* +1 or -1; a value that fits never reaches here */
}

/* exact conversion of a PyLong into <=nc leading double components */
static int pylong_components(PyObject *o, double *c, int nc)
{
    PyObject *cur = o;
    int i;
    Py_INCREF(cur);
    for (i = 0; i < nc; i++) c[i] = 0.0;
    for (i = 0; i < nc; i++) {
        double d = PyLong_AsDouble(cur);
        if (d == -1.0 && PyErr_Occurred()) {
            PyErr_Clear();
            /* overflow: sign decides the infinity */
            int neg = pylong_overflow_sign(cur) < 0;
            c[0] = neg ? -INFINITY : INFINITY;
            for (i = 1; i < nc; i++) c[i] = 0.0;
            Py_DECREF(cur);
            return 0;
        }
        c[i] = d;
        if (d == 0.0) break;
        {
            PyObject *di = PyLong_FromDouble(d);
            PyObject *nxt;
            if (!di) { Py_DECREF(cur); return -1; }
            nxt = PyNumber_Subtract(cur, di);
            Py_DECREF(di);
            Py_DECREF(cur);
            if (!nxt) return -1;
            cur = nxt;
        }
    }
    Py_DECREF(cur);
    return 0;
}

/* rounded (mantissa, exp2) split of a PyLong too large for a double:
 * |o| = top * 2^sh with top holding the leading `keep` bits (plus the
 * floor-truncation of the rest; <= 1 ulp at `keep` bits).  keep <= 960
 * so PyLong_AsDouble of the shifted value cannot overflow. */
static int pylong_top_shift(PyObject *o, int keep, double c[], int nc,
                            long *sh_out)
{
    PyObject *bl, *shL, *shifted;
    long nbits, sh;
    int rc;
    bl = PyObject_CallMethod(o, "bit_length", NULL);
    if (!bl) return -1;
    nbits = PyLong_AsLong(bl);
    Py_DECREF(bl);
    sh = nbits - keep;
    if (sh < 0) sh = 0;
    if (sh == 0) {
        *sh_out = 0;
        return pylong_components(o, c, nc);
    }
    shL = PyLong_FromLong(sh);
    if (!shL) return -1;
    shifted = PyNumber_Rshift(o, shL);
    Py_DECREF(shL);
    if (!shifted) return -1;
    rc = pylong_components(shifted, c, nc);
    Py_DECREF(shifted);
    *sh_out = sh;
    return rc;
}

/* coerce a Python object (fpnum of the same kind / float / int) into a
 * generic value. returns 0 ok, 1 not convertible, -1 error. */
static int coerce_v(PyObject *o, int kind, fpv *out)
{
    out->kind = kind;
    if (Py_TYPE(o) == &FpNumType) {
        FpNum *f = (FpNum *)o;
        if (f->kind != kind) return 1;  /* no silent cross-kind mixing */
        out->v = f->v;
        return 0;
    }
    if (PyFloat_Check(o)) {
        *out = fpv_from_d(kind, PyFloat_AS_DOUBLE(o));
        return 0;
    }
    if (PyLong_Check(o)) {
        double c[5];
        long sh = 0;
        /* small ints: the exact double path */
        double d = PyLong_AsDouble(o);
        if (!(d == -1.0 && PyErr_Occurred())) {
            switch (kind) {
            case KIND_DPE: out->v.dpe = dpe_from_d(d); return 0;
            case KIND_DD:
                if (pylong_components(o, c, 2) < 0) return -1;
                out->v.dd = dd_mk(c[0], c[1]);
                return 0;
            case KIND_QD:
                if (pylong_components(o, c, 4) < 0) return -1;
                renorm5(c[0], c[1], c[2], c[3], 0.0, &out->v.qd);
                return 0;
            case KIND_DDE:
                if (pylong_components(o, c, 3) < 0) return -1;
                out->v.dde = dde_norm(dd_add(dd_mk(c[0], c[1]),
                                             dd_from_d(c[2])), 0);
                return 0;
            default:
                if (pylong_components(o, c, 5) < 0) return -1;
                {
                    qd_t m;
                    renorm5(c[0], c[1], c[2], c[3], c[4], &m);
                    out->v.qde = qde_norm(m, 0);
                }
                return 0;
            }
        }
        PyErr_Clear();
        /* big ints: exponent-carrying kinds take the top bits + shift;
         * dd/qd saturate to the sign infinity (their double exponent
         * range cannot hold the value) */
        switch (kind) {
        case KIND_DPE:
            if (pylong_top_shift(o, 54, c, 1, &sh) < 0) return -1;
            out->v.dpe = dpe_norm(c[0], sh);
            return 0;
        case KIND_DDE:
            if (pylong_top_shift(o, 160, c, 3, &sh) < 0) return -1;
            out->v.dde = dde_norm(dd_add(dd_mk(c[0], c[1]),
                                         dd_from_d(c[2])), sh);
            return 0;
        case KIND_QDE:
            if (pylong_top_shift(o, 280, c, 5, &sh) < 0) return -1;
            {
                qd_t m;
                renorm5(c[0], c[1], c[2], c[3], c[4], &m);
                out->v.qde = qde_norm(m, sh);
            }
            return 0;
        default:
            *out = fpv_from_d(kind, pylong_overflow_sign(o) < 0
                              ? -INFINITY : INFINITY);
            return 0;
        }
    }
    return 1;
}

/* legacy 3-kind coercion shim for the scalar constructors */
static int coerce(PyObject *o, int kind, dpe_t *dp, dd_t *dd, qd_t *qd)
{
    fpv t;
    int rc = coerce_v(o, kind, &t);
    if (rc != 0) return rc;
    switch (kind) {
    case KIND_DPE: *dp = t.v.dpe; break;
    case KIND_DD:  *dd = t.v.dd; break;
    default:       *qd = t.v.qd; break;
    }
    return 0;
}

/* ---------------- number protocol ---------------- */
#define BINOP(name, op)                                                     \
static PyObject *fp_##name(PyObject *a, PyObject *b)                        \
{                                                                           \
    int kind = (Py_TYPE(a) == &FpNumType) ? ((FpNum *)a)->kind              \
                                          : ((FpNum *)b)->kind;             \
    fpv va, vb;                                                             \
    int ra = coerce_v(a, kind, &va);                                        \
    int rb = ra ? ra : coerce_v(b, kind, &vb);                              \
    if (ra < 0 || rb < 0) return NULL;                                      \
    if (ra > 0 || rb > 0) Py_RETURN_NOTIMPLEMENTED;                         \
    return (PyObject *)fp_from_v(fpv_##op(va, vb));                         \
}

BINOP(nb_add, add)
BINOP(nb_sub, sub)
BINOP(nb_mul, mul)
BINOP(nb_div, div)

static PyObject *fp_nb_neg(PyObject *a)
{
    return (PyObject *)fp_from_v(fpv_neg(fpv_of((FpNum *)a)));
}

static PyObject *fp_nb_pos(PyObject *a) { Py_INCREF(a); return a; }

static PyObject *fp_nb_abs(PyObject *a)
{
    if (fpv_sign(fpv_of((FpNum *)a)) < 0) return fp_nb_neg(a);
    Py_INCREF(a); return a;
}

static double fp_to_double(FpNum *f) { return fpv_to_d(fpv_of(f)); }

static PyObject *fp_nb_float(PyObject *a)
{
    return PyFloat_FromDouble(fp_to_double((FpNum *)a));
}

static int fp_nb_bool(PyObject *a)
{
    return !fpv_iszero(fpv_of((FpNum *)a));
}

static PyObject *fp_richcompare(PyObject *a, PyObject *b, int op)
{
    int kind = (Py_TYPE(a) == &FpNumType) ? ((FpNum *)a)->kind
                                          : ((FpNum *)b)->kind;
    fpv va, vb;
    int ra = coerce_v(a, kind, &va);
    int rb = ra ? ra : coerce_v(b, kind, &vb);
    int c, nan;
    if (ra < 0 || rb < 0) return NULL;
    if (ra > 0 || rb > 0) Py_RETURN_NOTIMPLEMENTED;
    c = fpv_cmp(va, vb);
    nan = fpv_isnan(va) || fpv_isnan(vb);
    if (nan) {
        if (op == Py_NE) Py_RETURN_TRUE;
        Py_RETURN_FALSE;
    }
    switch (op) {
    case Py_LT: return PyBool_FromLong(c < 0);
    case Py_LE: return PyBool_FromLong(c <= 0);
    case Py_EQ: return PyBool_FromLong(c == 0);
    case Py_NE: return PyBool_FromLong(c != 0);
    case Py_GT: return PyBool_FromLong(c > 0);
    default:    return PyBool_FromLong(c >= 0);
    }
}

/* ---------------- methods ---------------- */
static PyObject *fp_sqrt(PyObject *self, PyObject *noargs)
{
    (void)noargs;
    return (PyObject *)fp_from_v(fpv_sqrt(fpv_of((FpNum *)self)));
}

static PyObject *fp_nint(PyObject *self, PyObject *noargs)
{
    (void)noargs;
    return (PyObject *)fp_from_v(fpv_nint(fpv_of((FpNum *)self)));
}

static PyObject *fp_ldexp_m(PyObject *self, PyObject *arg)
{
    long e = PyLong_AsLong(arg);
    if (e == -1 && PyErr_Occurred()) return NULL;
    return (PyObject *)fp_from_v(fpv_ldexp(fpv_of((FpNum *)self), e));
}

/* frexp-style exponent: 2^(e-1) <= |x| < 2^e (FP_NR::exponent) */
static PyObject *fp_exponent(PyObject *self, PyObject *noargs)
{
    (void)noargs;
    return PyLong_FromLongLong(
        (long long)fpv_exponent(fpv_of((FpNum *)self)));
}

static PyObject *fp_isfinite(PyObject *self, PyObject *noargs)
{
    (void)noargs;
    return PyBool_FromLong(fpv_isfinite(fpv_of((FpNum *)self)));
}

/* (components, exponent_offset): exact doubles summing to the value
 * times 2^offset. Used by the Python side for exact value*2^e -> int
 * extraction. */
static PyObject *fp_parts(PyObject *self, PyObject *noargs)
{
    FpNum *f = (FpNum *)self;
    (void)noargs;
    switch (f->kind) {
    case KIND_DPE:
        return Py_BuildValue("(d)L", f->v.dpe.m, (long long)f->v.dpe.e);
    case KIND_DD:
        return Py_BuildValue("(dd)L", f->v.dd.hi, f->v.dd.lo, 0LL);
    case KIND_QD:
        return Py_BuildValue("(dddd)L", f->v.qd.x[0], f->v.qd.x[1],
                             f->v.qd.x[2], f->v.qd.x[3], 0LL);
    case KIND_DDE:
        return Py_BuildValue("(dd)L", f->v.dde.m.hi, f->v.dde.m.lo,
                             (long long)f->v.dde.e);
    default:
        return Py_BuildValue("(dddd)L", f->v.qde.m.x[0], f->v.qde.m.x[1],
                             f->v.qde.m.x[2], f->v.qde.m.x[3],
                             (long long)f->v.qde.e);
    }
}

static PyObject *fp_repr(PyObject *self)
{
    FpNum *f = (FpNum *)self;
    static const char *names[] = {"dpe", "dd", "qd", "dde", "qde"};
    if (f->kind == KIND_DPE)
        return PyUnicode_FromFormat("%s(%R*2^%lld)", names[f->kind],
                                    PyFloat_FromDouble(f->v.dpe.m),
                                    (long long)f->v.dpe.e);
    if (f->kind == KIND_DDE || f->kind == KIND_QDE)
        return PyUnicode_FromFormat("%s(%R*2^%lld)", names[f->kind],
                                    PyFloat_FromDouble(fpv_lead(fpv_of(f))),
                                    (long long)(f->kind == KIND_DDE
                                                ? f->v.dde.e : f->v.qde.e));
    return PyUnicode_FromFormat("%s(%R)", names[f->kind],
                                PyFloat_FromDouble(fp_to_double(f)));
}

/* exact nearest-int (ties to even) of value * 2^e as a PyLong — the
 * compiled equivalent of comps_to_int_mul_2exp (fctx.py), used to turn
 * rounded mu values into exact row-operation multipliers
 * (FP_NR::rnd_we + row_addmul_we, gso.cpp:236-262). */
static PyObject *fp_to_int_2exp(PyObject *self, PyObject *arg)
{
    FpNum *f = (FpNum *)self;
    long e = PyLong_AsLong(arg);
    double comps[4];
    long long off = 0, mants[4], shs[4], min_sh = 0;
    int nc, i, nt = 0;
    PyObject *acc = NULL, *tmp, *t;
    if (e == -1 && PyErr_Occurred()) return NULL;
    switch (f->kind) {
    case KIND_DPE:
        comps[0] = f->v.dpe.m; off = f->v.dpe.e; nc = 1; break;
    case KIND_DD:
        comps[0] = f->v.dd.hi; comps[1] = f->v.dd.lo; nc = 2; break;
    case KIND_QD:
        for (i = 0; i < 4; i++) comps[i] = f->v.qd.x[i];
        nc = 4; break;
    case KIND_DDE:
        comps[0] = f->v.dde.m.hi; comps[1] = f->v.dde.m.lo;
        off = f->v.dde.e; nc = 2; break;
    default:
        for (i = 0; i < 4; i++) comps[i] = f->v.qde.m.x[i];
        off = f->v.qde.e; nc = 4; break;
    }
    for (i = 0; i < nc; i++) {
        double m; int fe;
        if (comps[i] == 0.0 || !isfinite(comps[i])) continue;
        m = frexp(comps[i], &fe);
        mants[nt] = (long long)(m * 9007199254740992.0);  /* m * 2^53 */
        shs[nt] = (long long)fe - 53 + off + e;
        if (nt == 0 || shs[nt] < min_sh) min_sh = shs[nt];
        nt++;
    }
    if (nt == 0) return PyLong_FromLong(0);
    acc = PyLong_FromLong(0);
    if (!acc) return NULL;
    for (i = 0; i < nt; i++) {
        t = PyLong_FromLongLong(mants[i]);
        if (!t) goto fail;
        if (shs[i] != min_sh) {
            PyObject *sh = PyLong_FromLongLong(shs[i] - min_sh);
            if (!sh) { Py_DECREF(t); goto fail; }
            tmp = PyNumber_Lshift(t, sh);
            Py_DECREF(sh);
            Py_DECREF(t);
            if (!tmp) goto fail;
            t = tmp;
        }
        tmp = PyNumber_Add(acc, t);
        Py_DECREF(t);
        Py_DECREF(acc);
        if (!tmp) return NULL;
        acc = tmp;
    }
    if (min_sh >= 0) {
        PyObject *sh = PyLong_FromLongLong(min_sh);
        if (!sh) goto fail;
        tmp = PyNumber_Lshift(acc, sh);
        Py_DECREF(sh);
        Py_DECREF(acc);
        return tmp;
    }
    {
        /* round acc / 2^-min_sh to nearest, ties to even */
        int neg = 0;
        PyObject *a = acc, *sh2, *divmod_t, *q, *r, *half, *bl, *zero, *one2;
        long nbits;
        zero = PyLong_FromLong(0);
        if (!zero) { Py_DECREF(acc); return NULL; }
        if (PyObject_RichCompareBool(acc, zero, Py_LT) == 1) {
            neg = 1;
            a = PyNumber_Negative(acc);
            Py_DECREF(acc);
            if (!a) { Py_DECREF(zero); return NULL; }
        }
        Py_DECREF(zero);
        bl = PyObject_CallMethod(a, "bit_length", NULL);
        if (!bl) { Py_DECREF(a); return NULL; }
        nbits = PyLong_AsLong(bl);
        Py_DECREF(bl);
        if (-min_sh > nbits + 1) { Py_DECREF(a); return PyLong_FromLong(0); }
        one2 = PyLong_FromLong(1);
        tmp = PyLong_FromLongLong(-min_sh);
        sh2 = (one2 && tmp) ? PyNumber_Lshift(one2, tmp) : NULL;
        Py_XDECREF(tmp);
        if (!sh2) { Py_XDECREF(one2); Py_DECREF(a); return NULL; }
        divmod_t = PyNumber_Divmod(a, sh2);
        Py_DECREF(a);
        Py_DECREF(sh2);
        if (!divmod_t) { Py_DECREF(one2); return NULL; }
        q = PyTuple_GET_ITEM(divmod_t, 0);
        r = PyTuple_GET_ITEM(divmod_t, 1);
        Py_INCREF(q);
        tmp = PyLong_FromLongLong(-min_sh - 1);
        half = tmp ? PyNumber_Lshift(one2, tmp) : NULL;
        Py_XDECREF(tmp);
        Py_DECREF(one2);
        if (!half) { Py_DECREF(q); Py_DECREF(divmod_t); return NULL; }
        {
            int cmp = PyObject_RichCompareBool(r, half, Py_GT);
            int tie = cmp == 0 &&
                PyObject_RichCompareBool(r, half, Py_EQ) == 1;
            int odd = 0;
            if (tie) {
                PyObject *one = PyLong_FromLong(1);
                PyObject *andv = PyNumber_And(q, one);
                Py_DECREF(one);
                if (andv) {
                    odd = PyObject_IsTrue(andv);
                    Py_DECREF(andv);
                }
            }
            if (cmp == 1 || (tie && odd)) {
                PyObject *one = PyLong_FromLong(1);
                tmp = PyNumber_Add(q, one);
                Py_DECREF(one);
                Py_DECREF(q);
                if (!tmp) { Py_DECREF(half); Py_DECREF(divmod_t); return NULL; }
                q = tmp;
            }
        }
        Py_DECREF(half);
        Py_DECREF(divmod_t);
        if (neg) {
            tmp = PyNumber_Negative(q);
            Py_DECREF(q);
            return tmp;
        }
        return q;
    }
fail:
    Py_XDECREF(acc);
    return NULL;
}

static PyMethodDef fp_methods[] = {
    {"sqrt", fp_sqrt, METH_NOARGS, "square root"},
    {"nint", fp_nint, METH_NOARGS, "round to nearest integer, ties even"},
    {"ldexp", fp_ldexp_m, METH_O, "multiply by 2^e"},
    {"exponent", fp_exponent, METH_NOARGS, "frexp exponent"},
    {"is_finite", fp_isfinite, METH_NOARGS, "finiteness"},
    {"parts", fp_parts, METH_NOARGS, "(components, exp2) exact decomposition"},
    {"to_int_2exp", fp_to_int_2exp, METH_O,
     "exact nearest-int (ties even) of value * 2^e"},
    {NULL, NULL, 0, NULL},
};

static PyNumberMethods fp_as_number = {
    .nb_add = fp_nb_add,
    .nb_subtract = fp_nb_sub,
    .nb_multiply = fp_nb_mul,
    .nb_true_divide = fp_nb_div,
    .nb_negative = fp_nb_neg,
    .nb_positive = fp_nb_pos,
    .nb_absolute = fp_nb_abs,
    .nb_bool = fp_nb_bool,
    .nb_float = fp_nb_float,
};

static PyTypeObject FpNumType = {
    PyVarObject_HEAD_INIT(NULL, 0)
    .tp_name = "fpnum.fpnum",
    .tp_basicsize = sizeof(FpNum),
    .tp_flags = Py_TPFLAGS_DEFAULT,
    .tp_repr = fp_repr,
    .tp_as_number = &fp_as_number,
    .tp_richcompare = fp_richcompare,
    .tp_methods = fp_methods,
    .tp_doc = "compiled dpe/dd/qd scalar",
};

/* ---------------- module-level constructors & kernels -------------- */
static PyObject *make_kind(PyObject *arg, int kind)
{
    fpv v;
    int r = coerce_v(arg, kind, &v);
    if (r < 0) return NULL;
    if (r > 0) {
        /* cross-kind conversion goes through double (explicit constructor
         * only; arithmetic never mixes kinds silently) */
        if (Py_TYPE(arg) == &FpNumType) {
            double d = fp_to_double((FpNum *)arg);
            return (PyObject *)fp_from_v(fpv_from_d(kind, d));
        }
        PyErr_SetString(PyExc_TypeError, "expected float, int or fpnum");
        return NULL;
    }
    return (PyObject *)fp_from_v(v);
}

static PyObject *mod_dpe(PyObject *m, PyObject *a) { (void)m; return make_kind(a, KIND_DPE); }
static PyObject *mod_dd(PyObject *m, PyObject *a) { (void)m; return make_kind(a, KIND_DD); }
static PyObject *mod_qd(PyObject *m, PyObject *a) { (void)m; return make_kind(a, KIND_QD); }
static PyObject *mod_dde(PyObject *m, PyObject *a) { (void)m; return make_kind(a, KIND_DDE); }
static PyObject *mod_qde(PyObject *m, PyObject *a) { (void)m; return make_kind(a, KIND_QDE); }

/* dpe from (mantissa float, exponent int) without double-range limits */
static PyObject *mod_dpe_me(PyObject *m, PyObject *args)
{
    double mant;
    long long e;
    (void)m;
    if (!PyArg_ParseTuple(args, "dL", &mant, &e)) return NULL;
    return (PyObject *)fp_from_dpe(dpe_norm(mant, e));
}

/* dd/qd from exact double components */
static PyObject *mod_dd_pair(PyObject *m, PyObject *args)
{
    double hi, lo = 0.0;
    (void)m;
    if (!PyArg_ParseTuple(args, "d|d", &hi, &lo)) return NULL;
    return (PyObject *)fp_from_dd(dd_mk(hi, lo));
}

static PyObject *mod_qd_comp(PyObject *m, PyObject *args)
{
    double c0, c1 = 0.0, c2 = 0.0, c3 = 0.0;
    qd_t r;
    (void)m;
    if (!PyArg_ParseTuple(args, "d|ddd", &c0, &c1, &c2, &c3)) return NULL;
    renorm5(c0, c1, c2, c3, 0.0, &r);
    return (PyObject *)fp_from_qd(r);
}

/* sequential dot product over two sequences of fpnum/float/int */
static PyObject *mod_dot(PyObject *m, PyObject *args)
{
    PyObject *ua, *va, *uf = NULL, *vf = NULL, *out = NULL;
    Py_ssize_t n, i;
    int kind = -1;
    fpv acc;
    (void)m;
    if (!PyArg_ParseTuple(args, "OO", &ua, &va)) return NULL;
    uf = PySequence_Fast(ua, "dot: first arg not a sequence");
    if (!uf) goto fail;
    vf = PySequence_Fast(va, "dot: second arg not a sequence");
    if (!vf) goto fail;
    n = PySequence_Fast_GET_SIZE(uf);
    if (PySequence_Fast_GET_SIZE(vf) < n) n = PySequence_Fast_GET_SIZE(vf);
    for (i = 0; i < n; i++) {
        PyObject *x = PySequence_Fast_GET_ITEM(uf, i);
        PyObject *y = PySequence_Fast_GET_ITEM(vf, i);
        fpv vx, vy;
        if (kind < 0) {
            if (Py_TYPE(x) == &FpNumType) kind = ((FpNum *)x)->kind;
            else if (Py_TYPE(y) == &FpNumType) kind = ((FpNum *)y)->kind;
            else kind = KIND_DD;
            acc = fpv_from_d(kind, 0.0);
        }
        if (coerce_v(x, kind, &vx) != 0 || coerce_v(y, kind, &vy) != 0) {
            PyErr_SetString(PyExc_TypeError, "dot: unsupported element");
            goto fail;
        }
        acc = fpv_add(acc, fpv_mul(vx, vy));
    }
    if (kind < 0) acc = fpv_from_d(KIND_DD, 0.0);
    out = (PyObject *)fp_from_v(acc);
fail:
    Py_XDECREF(uf);
    Py_XDECREF(vf);
    return out;
}

/* ------------------------------------------------------------------ */
/* engine kernels over numpy object arrays                             */
/*                                                                     */
/* These move the GSO/LLL inner loops of the compiled-scalar contexts  */
/* into C: one Python call per ROW instead of per scalar (the role the */
/* templated engines play in the reference, gso_interface.cpp:131-164, */
/* lll.cpp:166-224).                                                   */
/* ------------------------------------------------------------------ */

static int check_obj_arr(PyObject *o, int ndim, const char *name)
{
    if (!PyArray_Check(o) ||
        PyArray_TYPE((PyArrayObject *)o) != NPY_OBJECT ||
        PyArray_NDIM((PyArrayObject *)o) != ndim) {
        PyErr_Format(PyExc_TypeError, "%s: expected %d-d object ndarray",
                     name, ndim);
        return -1;
    }
    return 0;
}

/* borrow element [i,j] of a 2-d object array, coerced to kind */
static inline int get2v(PyArrayObject *a, npy_intp i, npy_intp j, int kind,
                        fpv *out)
{
    PyObject *o = *(PyObject **)PyArray_GETPTR2(a, i, j);
    int rc = o ? coerce_v(o, kind, out) : 1;
    if (rc != 0) {
        if (rc > 0)
            PyErr_SetString(PyExc_TypeError, "unsupported array element");
        return -1;
    }
    return 0;
}

static inline int get1v(PyArrayObject *a, npy_intp i, int kind, fpv *out)
{
    PyObject *o = *(PyObject **)PyArray_GETPTR1(a, i);
    int rc = o ? coerce_v(o, kind, out) : 1;
    if (rc != 0) {
        if (rc > 0)
            PyErr_SetString(PyExc_TypeError, "unsupported array element");
        return -1;
    }
    return 0;
}

/* store a new FpNum built from v into [i,j] (steals nothing, replaces) */
static inline int set2v(PyArrayObject *a, npy_intp i, npy_intp j, fpv v)
{
    PyObject **p = (PyObject **)PyArray_GETPTR2(a, i, j);
    PyObject *n = (PyObject *)fp_from_v(v);
    if (!n) return -1;
    Py_XDECREF(*p);
    *p = n;
    return 0;
}

static inline int set1v(PyArrayObject *a, npy_intp i, fpv v)
{
    PyObject **p = (PyObject **)PyArray_GETPTR1(a, i);
    PyObject *n = (PyObject *)fp_from_v(v);
    if (!n) return -1;
    Py_XDECREF(*p);
    *p = n;
    return 0;
}

/* gso_row_update(mu, r, grow, i, j0, last_j, kind) -> n_valid_cols
 *
 * One row of the classical CGS recurrence entirely in C
 * (gso_interface.cpp:131-164):
 *   r(i,j) = grow[j] - sum_{k<j} mu(j,k) r(i,k);  mu(i,j) = r(i,j)/r(j,j)
 * grow elements may be PyLong (exact int Gram), PyFloat or fpnum.
 * Returns the first failing column index (nonfinite mu) or last_j+1. */
static PyObject *mod_gso_row_update(PyObject *mod, PyObject *args)
{
    PyObject *muo, *ro, *growo;
    int i, j0, last_j, kind;
    PyArrayObject *mu, *r, *grow;
    npy_intp j, k;
    (void)mod;
    if (!PyArg_ParseTuple(args, "OOOiiii", &muo, &ro, &growo, &i, &j0,
                          &last_j, &kind))
        return NULL;
    if (check_obj_arr(muo, 2, "mu") || check_obj_arr(ro, 2, "r") ||
        check_obj_arr(growo, 1, "grow"))
        return NULL;
    mu = (PyArrayObject *)muo;
    r = (PyArrayObject *)ro;
    grow = (PyArrayObject *)growo;
    for (j = j0; j <= last_j; j++) {
        fpv t, a, b;
        if (get1v(grow, j, kind, &t)) return NULL;
        if (j > 0) {
            fpv acc = fpv_from_d(kind, 0.0);
            for (k = 0; k < j; k++) {
                if (get2v(mu, j, k, kind, &a) ||
                    get2v(r, i, k, kind, &b))
                    return NULL;
                acc = fpv_add(acc, fpv_mul(a, b));
            }
            t = fpv_sub(t, acc);
        }
        if (set2v(r, i, j, t)) return NULL;
        if (i > j) {
            fpv rjj, mij;
            if (get2v(r, j, j, kind, &rjj)) return NULL;
            mij = fpv_div(t, rjj);
            if (fpv_iszero(t) && fpv_iszero(rjj))
                mij = fpv_from_d(kind, NAN);
            if (set2v(mu, i, j, mij)) return NULL;
            if (!fpv_isfinite(mij))
                return PyLong_FromLong((long)j);
        }
    }
    return PyLong_FromLong((long)(last_j + 1));
}

/* babai_pass(mu, bmu, expo_diff|None, start, end, prec, kind)
 *   -> [(j, mu_rnd fpnum), ...] in descending j
 *
 * One pass of the lazy size reduction's rounding loop (lll.cpp:196-224):
 * mu_rnd = rnd_we(bmu[j], e_j); bmu[k] -= mu_rnd * mu[j,k] for k < j.
 * bmu is updated in place; the caller applies the exact row operations
 * b[i] -= mu_rnd * 2^e_j * b[j]. */
static PyObject *mod_babai_pass(PyObject *mod, PyObject *args)
{
    PyObject *muo, *bmuo, *expoo;
    int start, end, prec, kind;
    PyArrayObject *mu, *bmu;
    npy_int64 *expo = NULL;
    PyObject *out;
    npy_intp j, k;
    (void)mod;
    if (!PyArg_ParseTuple(args, "OOOiiii", &muo, &bmuo, &expoo, &start,
                          &end, &prec, &kind))
        return NULL;
    if (check_obj_arr(muo, 2, "mu") || check_obj_arr(bmuo, 1, "bmu"))
        return NULL;
    mu = (PyArrayObject *)muo;
    bmu = (PyArrayObject *)bmuo;
    if (expoo != Py_None) {
        if (!PyArray_Check(expoo) ||
            PyArray_TYPE((PyArrayObject *)expoo) != NPY_INT64 ||
            !PyArray_IS_C_CONTIGUOUS((PyArrayObject *)expoo)) {
            PyErr_SetString(PyExc_TypeError,
                            "expo: expected contiguous int64 ndarray");
            return NULL;
        }
        expo = (npy_int64 *)PyArray_DATA((PyArrayObject *)expoo);
    }
    out = PyList_New(0);
    if (!out) return NULL;
    for (j = end - 1; j >= start; j--) {
        fpv v, mu_rnd;
        long e = expo ? (long)expo[j] : 0;
        if (get1v(bmu, j, kind, &v)) goto fail;
        if (fpv_iszero(v)) continue;
        /* rnd_we (nr_FP_d.inl:226-233): already integral at this scale? */
        if (fpv_exponent(v) + e >= prec)
            mu_rnd = v;
        else
            mu_rnd = fpv_ldexp(fpv_nint(fpv_ldexp(v, e)), -e);
        if (fpv_iszero(mu_rnd)) continue;
        for (k = start; k < j; k++) {
            fpv mjk, bk;
            if (get2v(mu, j, k, kind, &mjk) || get1v(bmu, k, kind, &bk))
                goto fail;
            if (set1v(bmu, k, fpv_sub(bk, fpv_mul(mu_rnd, mjk))))
                goto fail;
        }
        {
            PyObject *pair = Py_BuildValue("(lN)", (long)j,
                                           (PyObject *)fp_from_v(mu_rnd));
            if (!pair || PyList_Append(out, pair) < 0) {
                Py_XDECREF(pair);
                goto fail;
            }
            Py_DECREF(pair);
        }
    }
    return out;
fail:
    Py_DECREF(out);
    return NULL;
}

/* mu_row_stats(mu, row, expo_diff|None, start, end, kind)
 *   -> (finite, max_abs, max_exp)
 * max |mu(row,j) * 2^e_j| over [start, end) plus the max true exponent
 * (get_max_mu_exp, gso_interface.cpp:86) and a finiteness flag. */
static PyObject *mod_mu_row_stats(PyObject *mod, PyObject *args)
{
    PyObject *muo, *expoo;
    int row, start, end, kind;
    PyArrayObject *mu;
    npy_int64 *expo = NULL;
    double max_abs = 0.0;
    long long max_exp = 0;
    int have_exp = 0, finite = 1;
    npy_intp j;
    (void)mod;
    if (!PyArg_ParseTuple(args, "OiOiii", &muo, &row, &expoo, &start, &end,
                          &kind))
        return NULL;
    if (check_obj_arr(muo, 2, "mu")) return NULL;
    mu = (PyArrayObject *)muo;
    if (expoo != Py_None) {
        if (!PyArray_Check(expoo) ||
            PyArray_TYPE((PyArrayObject *)expoo) != NPY_INT64 ||
            !PyArray_IS_C_CONTIGUOUS((PyArrayObject *)expoo)) {
            PyErr_SetString(PyExc_TypeError,
                            "expo: expected contiguous int64 ndarray");
            return NULL;
        }
        expo = (npy_int64 *)PyArray_DATA((PyArrayObject *)expoo);
    }
    for (j = start; j < end; j++) {
        fpv v;
        long e = expo ? (long)expo[j] : 0;
        double t;
        if (get2v(mu, row, j, kind, &v)) return NULL;
        if (!fpv_isfinite(v)) { finite = 0; continue; }
        if (!fpv_iszero(v)) {
            long long ex = (long long)fpv_exponent(v) + e;
            if (!have_exp || ex > max_exp) { max_exp = ex; have_exp = 1; }
        }
        t = fabs(fpv_to_d(fpv_ldexp(v, e)));
        if (isnan(t)) finite = 0;
        else if (t > max_abs) max_abs = t;
    }
    return Py_BuildValue("(idL)", finite, max_abs, max_exp);
}

/* bf_row_from_ints(row, n, kind, use_expo) -> (object ndarray, max_e)
 *
 * Vectorized update_bf (gso.cpp:24-48): converts a row of PyLong basis
 * entries to kind scalars; with use_expo the row is scaled by 2^-max_e
 * from 53-bit (mantissa, exponent) splits and max_e returned. */
static PyObject *mod_bf_row_from_ints(PyObject *mod, PyObject *args)
{
    PyObject *rowo;
    int n, kind, use_expo;
    PyArrayObject *row, *out;
    npy_intp len, j;
    long long max_e = 0;
    int have_e = 0;
    dpe_t *tmp = NULL;
    (void)mod;
    if (!PyArg_ParseTuple(args, "Oiii", &rowo, &n, &kind, &use_expo))
        return NULL;
    if (check_obj_arr(rowo, 1, "row")) return NULL;
    row = (PyArrayObject *)rowo;
    len = PyArray_DIM(row, 0);
    if (n > len) n = (int)len;
    {
        npy_intp dims[1] = {len};
        out = (PyArrayObject *)PyArray_SimpleNew(1, dims, NPY_OBJECT);
        if (!out) return NULL;
    }
    if (use_expo) {
        tmp = (dpe_t *)PyMem_Malloc(sizeof(dpe_t) * (n > 0 ? n : 1));
        if (!tmp) { Py_DECREF(out); return PyErr_NoMemory(); }
        for (j = 0; j < n; j++) {
            fpv v;
            if (get1v(row, j, KIND_DPE, &v)) goto fail;
            tmp[j] = v.v.dpe;
            if (tmp[j].m != 0.0) {
                if (!have_e || tmp[j].e > max_e) { max_e = tmp[j].e; have_e = 1; }
            }
        }
        for (j = 0; j < n; j++) {
            fpv s = fpv_ldexp(fpv_from_d(kind, tmp[j].m),
                              (long)(tmp[j].e - max_e));
            if (tmp[j].m == 0.0) s = fpv_from_d(kind, 0.0);
            if (set1v(out, j, s)) goto fail;
        }
        PyMem_Free(tmp);
        tmp = NULL;
    } else {
        for (j = 0; j < n; j++) {
            fpv v;
            if (get1v(row, j, kind, &v)) goto fail;
            if (set1v(out, j, v)) goto fail;
        }
    }
    for (j = n; j < len; j++)
        if (set1v(out, j, fpv_from_d(kind, 0.0))) goto fail;
    return Py_BuildValue("(NL)", (PyObject *)out, max_e);
fail:
    if (tmp) PyMem_Free(tmp);
    Py_DECREF(out);
    return NULL;
}

/* gram_row_fill(gf, bf, i, last_j, n, kind) -> None
 *
 * Lazy float-Gram cache fill for one row (gso.cpp get_gram semantics):
 * any entry gf[i,j], j <= last_j, that is a NaN marker (or non-finite
 * fpnum) is recomputed as dot(bf[i,:n], bf[j,:n]) and mirrored. */
static PyObject *mod_gram_row_fill(PyObject *mod, PyObject *args)
{
    PyObject *gfo, *bfo;
    int i, last_j, n, kind;
    PyArrayObject *gf, *bf;
    npy_intp j, k;
    (void)mod;
    if (!PyArg_ParseTuple(args, "OOiiii", &gfo, &bfo, &i, &last_j, &n,
                          &kind))
        return NULL;
    if (check_obj_arr(gfo, 2, "gf") || check_obj_arr(bfo, 2, "bf"))
        return NULL;
    gf = (PyArrayObject *)gfo;
    bf = (PyArrayObject *)bfo;
    for (j = 0; j <= last_j; j++) {
        PyObject *o = *(PyObject **)PyArray_GETPTR2(gf, i, j);
        int need;
        fpv acc, a, b;
        if (o && Py_TYPE(o) == &FpNumType)
            need = !fpv_isfinite(fpv_of((FpNum *)o));
        else if (o && PyFloat_Check(o))
            need = isnan(PyFloat_AS_DOUBLE(o));
        else
            need = 1;
        if (!need) continue;
        acc = fpv_from_d(kind, 0.0);
        for (k = 0; k < n; k++) {
            if (get2v(bf, i, k, kind, &a) || get2v(bf, j, k, kind, &b))
                return NULL;
            acc = fpv_add(acc, fpv_mul(a, b));
        }
        if (set2v(gf, i, j, acc)) return NULL;
        if (j != i && set2v(gf, j, i, acc)) return NULL;
    }
    Py_RETURN_NONE;
}

/* lovasz_chain(mu, r, row, kappa, g0, kind) -> [l_0, ..., l_kappa]
 * l_0 = g0; l_i = l_{i-1} - mu(row, i-1) * r(row, i-1)  (lll.cpp:109-125) */
static PyObject *mod_lovasz_chain(PyObject *mod, PyObject *args)
{
    PyObject *muo, *ro, *g0o, *out;
    int row, kappa, kind;
    PyArrayObject *mu, *r;
    fpv acc;
    npy_intp i;
    (void)mod;
    if (!PyArg_ParseTuple(args, "OOiiOi", &muo, &ro, &row, &kappa, &g0o,
                          &kind))
        return NULL;
    if (check_obj_arr(muo, 2, "mu") || check_obj_arr(ro, 2, "r"))
        return NULL;
    mu = (PyArrayObject *)muo;
    r = (PyArrayObject *)ro;
    if (coerce_v(g0o, kind, &acc) != 0) {
        PyErr_SetString(PyExc_TypeError, "lovasz_chain: bad g0");
        return NULL;
    }
    out = PyList_New(kappa + 1);
    if (!out) return NULL;
    PyList_SET_ITEM(out, 0, (PyObject *)fp_from_v(acc));
    for (i = 1; i <= kappa; i++) {
        fpv mv, rv;
        if (get2v(mu, row, i - 1, kind, &mv) ||
            get2v(r, row, i - 1, kind, &rv)) {
            Py_DECREF(out);
            return NULL;
        }
        acc = fpv_sub(acc, fpv_mul(mv, rv));
        PyList_SET_ITEM(out, i, (PyObject *)fp_from_v(acc));
    }
    return out;
}

/* ldexp_arr(arr, e) -> new object ndarray, elementwise *2^e */
static PyObject *mod_ldexp_arr(PyObject *mod, PyObject *args)
{
    PyObject *arro;
    long e;
    PyArrayObject *arr, *out;
    npy_intp n, j;
    (void)mod;
    if (!PyArg_ParseTuple(args, "Ol", &arro, &e)) return NULL;
    if (check_obj_arr(arro, 1, "arr")) return NULL;
    arr = (PyArrayObject *)arro;
    n = PyArray_DIM(arr, 0);
    {
        npy_intp dims[1] = {n};
        out = (PyArrayObject *)PyArray_SimpleNew(1, dims, NPY_OBJECT);
        if (!out) return NULL;
    }
    for (j = 0; j < n; j++) {
        PyObject *o = *(PyObject **)PyArray_GETPTR1(arr, j);
        fpv v;
        if (!o || Py_TYPE(o) != &FpNumType) {
            PyErr_SetString(PyExc_TypeError, "ldexp_arr: fpnum array only");
            Py_DECREF(out);
            return NULL;
        }
        v = fpv_of((FpNum *)o);
        if (set1v(out, j, fpv_ldexp(v, e))) { Py_DECREF(out); return NULL; }
    }
    return (PyObject *)out;
}

static PyMethodDef mod_methods[] = {
    {"dpe", mod_dpe, METH_O, "dpe scalar from float/int"},
    {"dd", mod_dd, METH_O, "dd scalar from float/int (exact)"},
    {"qd", mod_qd, METH_O, "qd scalar from float/int (exact)"},
    {"dde", mod_dde, METH_O, "dd-mantissa + int64-exponent scalar"},
    {"qde", mod_qde, METH_O, "qd-mantissa + int64-exponent scalar"},
    {"dpe_me", mod_dpe_me, METH_VARARGS, "dpe from (mantissa, exp2)"},
    {"dd_pair", mod_dd_pair, METH_VARARGS, "dd from raw components"},
    {"qd_comp", mod_qd_comp, METH_VARARGS, "qd from raw components"},
    {"dot", mod_dot, METH_VARARGS, "sequential dot over fpnum sequences"},
    {"gso_row_update", mod_gso_row_update, METH_VARARGS,
     "one CGS row recurrence over object arrays"},
    {"babai_pass", mod_babai_pass, METH_VARARGS,
     "one lazy-size-reduction rounding pass"},
    {"mu_row_stats", mod_mu_row_stats, METH_VARARGS,
     "(finite, max_abs, max_exp) of a scaled mu row"},
    {"bf_row_from_ints", mod_bf_row_from_ints, METH_VARARGS,
     "vectorized basis-row -> float-context conversion"},
    {"ldexp_arr", mod_ldexp_arr, METH_VARARGS,
     "elementwise ldexp over an fpnum object array"},
    {"gram_row_fill", mod_gram_row_fill, METH_VARARGS,
     "lazy float-Gram cache fill for one row"},
    {"lovasz_chain", mod_lovasz_chain, METH_VARARGS,
     "prefix chain of Lovasz left-hand sides"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef fpnum_module = {
    PyModuleDef_HEAD_INIT, "fpnum",
    "compiled dpe/dd/qd scalar tower", -1, mod_methods,
    NULL, NULL, NULL, NULL,
};

PyMODINIT_FUNC PyInit_fpnum(void)
{
    PyObject *m;
    import_array();
    if (PyType_Ready(&FpNumType) < 0) return NULL;
    m = PyModule_Create(&fpnum_module);
    if (!m) return NULL;
    Py_INCREF(&FpNumType);
    if (PyModule_AddObject(m, "fpnum", (PyObject *)&FpNumType) < 0) {
        Py_DECREF(&FpNumType);
        Py_DECREF(m);
        return NULL;
    }
    return m;
}
