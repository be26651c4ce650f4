/* Native pruner cost primitives.
 *
 * C implementations of the numerical kernels of the pruning optimizer
 * so the local-adjust heuristic passes (hundreds of target-function
 * evaluations each) and block-90 strategy generation run at compiled
 * speed:
 *
 *   - relative volume of the even cylinder-intersection body
 *     (reference: fplll/pruner/pruner_simplex.h:28-46)
 *   - single_enum_cost_evec (reference: fplll/pruner/pruner_cost.cpp:8-67)
 *   - svp_probability_evec  (reference: fplll/pruner/pruner_prob.cpp)
 *
 * The polynomial-integration recurrence cancels catastrophically in
 * plain double for extreme pruning profiles at d >~ 20, which is why
 * the reference instantiates Pruner<FP_NR<dd_real>> / <mpfr_t>
 * (pruner.cpp:236-271).  We run the recurrence in double-double
 * (TwoSum/TwoProd error-free transformations, ~106-bit), the same
 * precision class as the reference's dd instantiation.
 */

#include <math.h>
#include <stdlib.h>
#include <string.h>

#define MAXD 2048

static double tab_ball_vol[MAXD];
static double tab_factorial[MAXD];
static int tables_ready = 0;

static void init_tables(void)
{
    int i;
    if (tables_ready)
        return;
    for (i = 0; i < MAXD; i++) {
        /* log vol of unit i-ball; exp() overflows to inf beyond ~170!
         * exactly like the reference's double-typed tables
         * (pruner.cpp:190-201) */
        tab_ball_vol[i] =
            exp((i / 2.0) * log(M_PI) - lgamma(i / 2.0 + 1.0));
        tab_factorial[i] = exp(lgamma(i + 1.0));
    }
    tables_ready = 1;
}

/* ----- double-double arithmetic (error-free transformations) ----- */
typedef struct { double hi, lo; } dd_t;

static inline dd_t dd_from(double x) { dd_t r = {x, 0.0}; return r; }

static inline dd_t two_sum(double a, double b)
{
    dd_t r;
    double bb;
    r.hi = a + b;
    bb   = r.hi - a;
    r.lo = (a - (r.hi - bb)) + (b - bb);
    return r;
}

static inline dd_t two_prod(double a, double b)
{
    dd_t r;
    r.hi = a * b;
    r.lo = fma(a, b, -r.hi);
    return r;
}

static inline dd_t dd_add(dd_t a, dd_t b)
{
    dd_t s = two_sum(a.hi, b.hi);
    double lo = s.lo + a.lo + b.lo;
    dd_t r = two_sum(s.hi, lo);
    return r;
}

static inline dd_t dd_mul(dd_t a, dd_t b)
{
    dd_t p = two_prod(a.hi, b.hi);
    double lo = p.lo + a.hi * b.lo + a.lo * b.hi;
    dd_t r = two_sum(p.hi, lo);
    return r;
}

static inline dd_t dd_mul_d(dd_t a, double b)
{
    dd_t p = two_prod(a.hi, b);
    double lo = p.lo + a.lo * b;
    dd_t r = two_sum(p.hi, lo);
    return r;
}

static inline dd_t dd_div_d(dd_t a, double b)
{
    dd_t r;
    double q1 = a.hi / b;
    dd_t p = two_prod(q1, b);
    double q2 = ((a.hi - p.hi) - p.lo + a.lo) / b;
    r = two_sum(q1, q2);
    return r;
}

static inline dd_t dd_neg(dd_t a) { dd_t r = {-a.hi, -a.lo}; return r; }

/* Relative volume of the even cylinder-intersection body times rd!
 * via the even-simplex polynomial recurrence (pruner_simplex.h:28-46),
 * evaluated in double-double. */
static dd_t rel_vol_dd(int rd, const double *b)
{
    dd_t P[MAXD + 2];
    dd_t acc;
    int i, k, ld = 0;
    double binv = 1.0 / b[rd - 1];
    memset(P, 0, sizeof(dd_t) * (rd + 2));
    P[0] = dd_from(1.0);
    for (i = rd - 1; i >= 0; --i) {
        for (k = ld; k >= 0; --k)
            P[k + 1] = dd_div_d(P[k], (double)(k + 1));
        ld += 1;
        /* P[0] = -eval_poly(ld, P, b[i]/b[rd-1]) with P[0]-term zero */
        dd_t x = dd_from(b[i] * binv);
        acc = dd_from(0.0);
        for (k = ld; k >= 1; --k)
            acc = dd_add(dd_mul(acc, x), P[k]);
        acc = dd_mul(acc, x);
        P[0] = dd_neg(acc);
    }
    acc = dd_mul_d(P[0], tab_factorial[rd]);
    return (rd % 2) ? dd_neg(acc) : acc;
}

double pruner_rel_vol(int rd, const double *b)
{
    init_tables();
    if (rd + 2 > MAXD)
        return nan("");
    dd_t v = rel_vol_dd(rd, b);
    return v.hi + v.lo;
}

/* single_enum_cost_evec: expected node count of one pruned enumeration.
 * b: d pruning coefficients (evec), ipv: 2d inverse partial volumes,
 * detailed (nullable): per-level costs in user order (2d entries). */
double pruner_cost_evec(int d, const double *b, const double *ipv,
                        double norm_radius, double sym, double *detailed)
{
    double rv[2 * MAXD];
    double total = 0.0, rp;
    int i;
    init_tables();
    if (2 * d + 2 > MAXD)
        return nan("");
    for (i = 0; i < d; i++)
        rv[2 * i + 1] = pruner_rel_vol(i + 1, b);
    rv[0] = 1.0;
    for (i = 1; i < d; i++)
        rv[2 * i] = sqrt(rv[2 * i - 1] * rv[2 * i + 1]);
    rp = norm_radius;
    for (i = 0; i < 2 * d; i++) {
        double tmp = rp * rv[i] * tab_ball_vol[i + 1] *
                     sqrt(pow(b[i / 2], 1 + i)) * ipv[i];
        tmp *= sym;
        if (detailed)
            detailed[2 * d - (i + 1)] = tmp;
        total += tmp;
        rp *= norm_radius;
    }
    return total;
}

/* svp_probability_evec (pruner_prob.cpp): lower-bound success
 * probability via the shell-difference trick.  The shell difference
 * dxn*rel_vol(bmdb) - rel_vol(b) also cancels, so it is combined in
 * double-double before the final division. */
double pruner_svp_prob_evec(int d, const double *b, double shell_ratio)
{
    double bmdb[MAXD];
    double dx = shell_ratio;
    double dxn;
    dd_t vol, vol2, dvol;
    int i;
    init_tables();
    if (d + 2 > MAXD)
        return nan("");
    for (i = 0; i < d; i++) {
        double v = b[i] / (dx * dx);
        bmdb[i] = v < 1.0 ? v : 1.0;
    }
    vol = rel_vol_dd(d, b);
    dxn = pow(dx, 2 * d);
    vol2 = rel_vol_dd(d, bmdb);
    dvol = dd_add(dd_mul_d(vol2, dxn), dd_neg(vol));
    return (dvol.hi + dvol.lo) / (dxn - 1.0);
}
