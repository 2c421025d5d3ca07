"""The KL dual's whole projected-Newton solve in one Pallas kernel,
compiled for the GPU through Triton.

Each grid program takes a tile of ``bt`` instances, each a padded
(npad,) row per constraint, and runs the fixed-schedule active-set
projected-Newton solve of the closed-form dual to its end without
leaving the kernel:

    y      = p exp(-(B'z) - 1)   (uniform p: 1/(n e))  (bt, n)
    grad   = w - B y                                   dim x (bt, 1)
    hess   = B diag(y) B'  (unrolled scalar Cholesky)  dim(dim+1)/2 x (bt,1)
    dz     = -Hf^-1 gf       (bound-active coords frozen)
    line search over halvings of the fraction-to-boundary step (one exp
    + cheap squarings), value acceptance with a guarded exact
    quadratic-model fallback below the value-resolution floor

then recovers x = y / sum(y) and the measured in-kernel gap f(x) - g(z).
Under XLA the same solve (``DistKL.solve_dual_newton`` under vmap) is
~40 small operations per Newton step; here it is one launch, and the
working set of a program stays in registers.

Shapes: B = [H; 1'; A] with k inequality rows, the sum-to-one equality and
mE extra equality rows; dual dim = k + 1 + mE <= 16 (the closed-form
2x2/3x3 adjugate handles dim <= 3; an unrolled scalar Cholesky handles
4-16 — straight-line code on (bt, 1) values).  Triton needs power-of-two
blocks, so the wrapper pads the row width n, the stacked row axis
k + mE and the dual-iterate output to powers of two with inert values
(zero rows, u = 1 on padded inequality slots), and interpret mode uses
the very same blocks — the CPU tests run the GPU's padding.  Every
program is independent of every other, so the grid runs in parallel.

Reference parity: Dist_KL.scala:59-65 (the dual is the preferred route),
:114-171 (closed forms, dim-generic); the active-set Newton replaces the
reference's barrier-on-the-dual with a direct bound-constrained solve.
"""

from __future__ import annotations

import functools
import types

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .. import backend
from ..backend import FUSED_MAX_DIM

KERNEL_NAME = "kl_dual_newton"


def _solve_small(m, gf, dim, dtype):
    """dz = -M^-1 gf for the scalar-register Newton system, plus a
    per-lane ``sick`` flag for (near-)singular free subspaces.

    ``m`` maps (i, j), i <= j, to the (bt, 1) entries of the symmetric
    positive-definite M (frozen coordinates carry a unit diagonal).
    dim <= 3 uses the closed-form adjugate; dim 4-16 an unrolled Cholesky
    (straight-line code, ~dim^3/3 scalar ops on (bt, 1) values, no
    (bt, dim, dim) tensor in the kernel).

    ``sick`` (bt, 1) bool: the free-set Hessian lost (almost) all of a
    pivot to cancellation — e.g. EXACTLY ANTI-PARALLEL constraint rows
    whose lams are transiently both free (found by a round-5 mixed-fleet
    family: P(A) >= pA and P(A) <= qA rows are +/-I_A; an overshoot past
    qA releases the second lam, M goes singular, and the adjugate emits a
    garbage direction every step — the solve jammed permanently at gap
    0.47).  Callers substitute a Jacobi-preconditioned gradient step for
    sick lanes (a guaranteed descent direction through the same
    value-checked line search).  Detection: pivot <= 10 eps * its
    pre-elimination diagonal (dim >= 4) / det <= 10 eps * the Hadamard
    diagonal product (dim <= 3).  Returns ``(dz, sick)``.
    """
    eps10 = 10.0 * jnp.asarray(jnp.finfo(dtype).eps, dtype)
    if dim == 1:
        return [-gf[0] / m[(0, 0)]], jnp.zeros_like(gf[0], jnp.bool_)
    if dim == 2:
        det = m[(0, 0)] * m[(1, 1)] - m[(0, 1)] * m[(0, 1)]
        sick = det <= eps10 * (m[(0, 0)] * m[(1, 1)])
        return [
            -(m[(1, 1)] * gf[0] - m[(0, 1)] * gf[1]) / det,
            -(m[(0, 0)] * gf[1] - m[(0, 1)] * gf[0]) / det,
        ], sick
    if dim > FUSED_MAX_DIM:
        raise ValueError(f"_solve_small: dim {dim} > {FUSED_MAX_DIM}")
    if dim == 3:
        c00 = m[(1, 1)] * m[(2, 2)] - m[(1, 2)] * m[(1, 2)]
        c01 = m[(1, 2)] * m[(0, 2)] - m[(0, 1)] * m[(2, 2)]
        c02 = m[(0, 1)] * m[(1, 2)] - m[(1, 1)] * m[(0, 2)]
        det = m[(0, 0)] * c00 + m[(0, 1)] * c01 + m[(0, 2)] * c02
        sick = det <= eps10 * (m[(0, 0)] * m[(1, 1)] * m[(2, 2)])
        return [
            -(c00 * gf[0] + c01 * gf[1] + c02 * gf[2]) / det,
            -(c01 * gf[0] + (m[(0, 0)] * m[(2, 2)]
                             - m[(0, 2)] * m[(0, 2)]) * gf[1]
              + (m[(0, 1)] * m[(0, 2)]
                 - m[(0, 0)] * m[(1, 2)]) * gf[2]) / det,
            -(c02 * gf[0] + (m[(0, 1)] * m[(0, 2)]
                             - m[(0, 0)] * m[(1, 2)]) * gf[1]
              + (m[(0, 0)] * m[(1, 1)]
                 - m[(0, 1)] * m[(0, 1)]) * gf[2]) / det,
        ], sick
    # dim 4-16: unrolled Cholesky M = L L', forward+back substitution.
    # max(.., tiny) keeps batch-padded instances (all-zero rows) finite —
    # their garbage steps reject on value and never leave the pad lanes.
    tiny = jnp.asarray(jnp.finfo(dtype).tiny, dtype)
    L = {}
    sick = None
    for j in range(dim):
        d = m[(j, j)]
        for p in range(j):
            d = d - L[(j, p)] * L[(j, p)]
        bad_j = d <= eps10 * m[(j, j)]
        sick = bad_j if sick is None else jnp.logical_or(sick, bad_j)
        L[(j, j)] = jnp.sqrt(jnp.maximum(d, tiny))
        for i in range(j + 1, dim):
            off = m[(j, i)]
            for p in range(j):
                off = off - L[(i, p)] * L[(j, p)]
            L[(i, j)] = off / L[(j, j)]
    yv = []
    for i in range(dim):
        s = -gf[i]
        for p in range(i):
            s = s - L[(i, p)] * yv[p]
        yv.append(s / L[(i, i)])
    dz = [None] * dim
    for i in range(dim - 1, -1, -1):
        s = yv[i]
        for p in range(i + 1, dim):
            s = s - L[(p, i)] * dz[p]
        dz[i] = s / L[(i, i)]
    return dz, sick


def _make_ctx(rows, ws_in, logp, *, k: int, m_eq: int, n_valid: int):
    """Closures over one instance tile: ``rows`` are the k + mE (bt, n)
    constraint rows [H; A], ``ws_in`` their (bt, 1) right-hand sides."""
    dtype = rows[0].dtype
    bt, n = rows[0].shape
    dim = k + 1 + m_eq

    # B = [H; 1'; A] row layout; w = (u, 1, r)
    def hrow(i):
        if i < k:
            return rows[i]
        if i == k:
            return jnp.ones((bt, 1), dtype)          # broadcasting row of 1s
        return rows[i - 1]

    ws = (list(ws_in[:k]) + [jnp.ones((bt, 1), dtype)]
          + list(ws_in[k:]))
    valid = (lax.broadcasted_iota(jnp.int32, (1, n), 1) < n_valid
             ).astype(dtype)                         # (1, n)

    def rsum(a):
        return jnp.sum(a * valid, axis=1, keepdims=True)     # (bt, 1)

    def btz_of(z):
        # B'z: (bt, n); the ones-row contributes a broadcast scalar
        out = z[k] * jnp.ones((bt, 1), dtype)
        for j in range(dim):
            if j != k:
                out = out + z[j] * hrow(j)
        return out

    def y_of(z):
        # y = p exp(-(B'z) - 1), masked to valid lanes; logp is the
        # shared log-prior row (uniform: the constant -log n)
        return jnp.exp(-(btz_of(z)) - 1.0 + logp) * valid

    def val_of(z, y):
        v = rsum(y)
        for i in range(dim):
            v = v + ws[i] * z[i]
        return v                                             # (bt, 1)

    def grad_of(z, y):
        g = []
        for j in range(dim):
            if j == k:
                g.append(ws[j] - rsum(y))
            else:
                g.append(ws[j] - rsum(hrow(j) * y))
        return g                                             # dim x (bt, 1)

    def pgnorm(z, g):
        # projected-gradient norm^2: lam coords at 0 wanting to decrease
        # are optimal, drop them
        s = jnp.zeros((bt, 1), dtype)
        for j in range(dim):
            if j < k:
                at_b = jnp.logical_and(z[j] <= 0.0, g[j] > 0.0)
                gj = jnp.where(at_b, 0.0, g[j])
                s = s + gj * gj
            else:
                s = s + g[j] * g[j]
        return s                                             # (bt, 1)

    def project(z):
        return [jnp.maximum(z[j], 0.0) if j < k else z[j]
                for j in range(dim)]

    return types.SimpleNamespace(
        dtype=dtype, bt=bt, n=n, dim=dim, k=k, m_eq=m_eq, hrow=hrow,
        ws=ws, valid=valid, rsum=rsum, btz_of=btz_of, y_of=y_of,
        val_of=val_of, grad_of=grad_of, pgnorm=pgnorm, project=project)


def _newton_z(ctx, *, n_steps: int, z0: float, n_ls: int, eps: float):
    """The fixed-schedule active-set projected-Newton loop on a ctx from
    ``_make_ctx``; returns the final dual iterate as dim (bt, 1) values."""
    dtype, bt, dim, k = ctx.dtype, ctx.bt, ctx.dim, ctx.k
    hrow, ws, valid, rsum = ctx.hrow, ctx.ws, ctx.valid, ctx.rsum
    y_of, val_of, grad_of = ctx.y_of, ctx.val_of, ctx.grad_of
    pgnorm, project = ctx.pgnorm, ctx.project

    def step(_, zs):
        z = list(zs)
        y = y_of(z)
        # shared (bt, n) products y * B_j and their row sums: the gradient
        # AND the Hessian's k-column both consume rsum(y * B_j), and the
        # remaining Hessian entries consume (y * B_i) * B_j — computing
        # yh[] once removes ~dim redundant full-width multiply passes per
        # Newton step (round-4 kernel diet, with the squared line-search
        # chain below)
        yh = {}
        ryh = {}
        for j in range(dim):
            if j != k:
                yh[j] = y * hrow(j)
                ryh[j] = rsum(yh[j])
        ry = rsum(y)
        f0 = ry
        for i in range(dim):
            f0 = f0 + ws[i] * z[i]
        g = [ws[j] - (ry if j == k else ryh[j]) for j in range(dim)]

        # active-set mask: frozen coordinates get a unit row/col
        frees = []
        gf = []
        for j in range(dim):
            if j < k:
                at_b = jnp.logical_and(z[j] <= 0.0, g[j] > 0.0)
                fr = jnp.where(at_b, 0.0, jnp.ones_like(g[j]))
            else:
                fr = jnp.ones_like(g[j])
            frees.append(fr)
            gf.append(g[j] * fr)

        # Hessian entries m_ij = sum y B_i B_j, masked + unit diagonal
        m = {}
        for i in range(dim):
            for j in range(i, dim):
                if i == k and j == k:
                    mij = ry
                elif i == k:
                    mij = ryh[j]
                elif j == k:
                    mij = ryh[i]
                else:
                    mij = rsum(yh[i] * hrow(j))
                mij = mij * frees[i] * frees[j]
                if i == j:
                    mij = mij + (1.0 - frees[i])
                    mij = mij * (1.0 + 10.0 * eps)
                m[(i, j)] = mij

        dz, sick = _solve_small(m, gf, dim, dtype)
        # sick (near-singular free set, e.g. transiently-free ANTI-PARALLEL
        # rows): the Newton direction is garbage and every candidate
        # rejects — the round-5 jam (see _solve_small).  Substitute a
        # Jacobi-preconditioned gradient direction: guaranteed descent,
        # same value-checked line search, no extra exp passes; once the
        # overshoot unwinds the redundant lam refreezes and Newton resumes.
        for j in range(dim):
            dz[j] = jnp.where(sick, -gf[j] / m[(j, j)], dz[j])

        # a lam ALREADY at its bound cannot move down: zero that component
        # of the direction (otherwise t_bd = 0 freezes the whole step; the
        # active-set mask above catches the g > 0 case, this catches the
        # rarer coupled g < 0, dz < 0 case)
        for j in range(k):
            dz[j] = jnp.where(jnp.logical_and(z[j] <= 0.0, dz[j] < 0.0),
                              0.0, dz[j])
        # fraction-to-boundary: cap the full step at the first lam boundary
        # so NO candidate needs projection (z + t dz keeps lam >= 0 for
        # t <= t_bd; the t_bd candidate lands exactly ON the boundary and
        # the next step freezes that coordinate).  No artificial floor —
        # a floor above t_bd would score candidates at unprojected
        # (lam < 0) points and break the monotone-bound property.
        t_bd = jnp.full((bt, 1), jnp.inf, dtype)
        for j in range(k):
            tj = jnp.where(dz[j] < 0, -z[j] / jnp.where(dz[j] < 0, dz[j],
                                                        -1.0), jnp.inf)
            t_bd = jnp.minimum(t_bd, tj)
        # far-field trust cap: on a COLD start (z ~ 0, optimum at
        # lam* = O(log n)) the exp-linear dual is locally near-linear in a
        # climbing lam, so the Newton step is O(grad/hess) = O(100+) —
        # and the n_ls halvings of such a step are ALL oversized (the
        # deepest candidate is t_full/2^(n_ls-1)), so the iterate crawls.
        # Capping the step at L_TRUST per coordinate turns the far phase
        # into log-scale progress of up to L_TRUST per step (the optimum
        # moves multiplicatively in y = exp(-B'z)); near the optimum
        # ||dz|| << L_TRUST and the cap is inactive, so quadratic
        # convergence is untouched.  Fixes the n >= 1000 extreme-
        # concentration instances (lam* ~ 8) that 16 steps previously
        # could not reach from z0 = 1e-3.
        dz_inf = jnp.zeros((bt, 1), dtype)
        for j in range(dim):
            dz_inf = jnp.maximum(dz_inf, jnp.abs(dz[j]))
        l_trust = jnp.asarray(8.0, dtype)
        t_trust = l_trust / jnp.maximum(dz_inf, l_trust)  # min(1, L/||dz||)
        t_full = jnp.minimum(jnp.clip(t_bd, 0.0, 1.0), t_trust)

        # candidates are halvings of t_full along the ray:
        #   y(z + t dz) = y(z) * exp(-t (B'dz)).  Evaluated DEEPEST-FIRST
        #   with ONE exp at the deepest exponent and a squaring per level
        #   (exp(e/2^i)^2 = exp(e/2^(i-1))): n_ls exps -> 1 exp +
        #   (n_ls - 1) multiplies per step (round-4 kernel diet).  The
        #   squared chain is sound where the old caveat about a CLIPPED
        #   sqrt chain was not: squaring a clipped/overflowed factor only
        #   OVERSTATES the deeper candidates' exp (inf/huge), which
        #   disqualifies them via the isfinite test — it can never make a
        #   truly-huge step look acceptable.  Squaring relative error
        #   (~2^i eps at level i) lands only in candidate SCORING, far
        #   below the value-resolution acceptance band; the accepted z
        #   update z + t dz is exact either way.
        wdir = dz[k] * jnp.ones((bt, 1), dtype)
        for j in range(dim):
            if j != k:
                wdir = wdir + dz[j] * hrow(j)
        max_e = 0.9 * jnp.log(jnp.finfo(dtype).max)
        scale_deep = 1.0 / float(2 ** (n_ls - 1))
        e_deep = -(t_full * scale_deep) * wdir
        # a lane whose DEEPEST exponent already clips would score every
        # candidate on a distorted factor: disqualify the whole chain
        chain_bad = jnp.max(e_deep * valid, axis=1,
                            keepdims=True) > max_e
        efac = jnp.exp(jnp.clip(e_deep, -max_e, max_e))
        best_f = f0
        tf = jnp.zeros((bt, 1), dtype)
        t = t_full * scale_deep
        for lev in range(n_ls):
            sy = rsum(y * efac)
            ft = sy
            for i in range(dim):
                ft = ft + ws[i] * (z[i] + t * dz[i])
            ft = jnp.where(jnp.logical_or(jnp.logical_not(jnp.isfinite(ft)),
                                          chain_bad), jnp.inf, ft)
            # accept only strict improvements over f0; among equal-valued
            # improvements the LARGER t wins (the <= replaces as t grows),
            # matching the old large-to-small strict-< scan
            bf = jnp.logical_and(ft < f0, ft <= best_f)
            best_f = jnp.where(bf, ft, best_f)
            tf = jnp.where(bf, t, tf)
            if lev < n_ls - 1:
                efac = efac * efac
                t = 2.0 * t

        finite = jnp.ones((bt, 1), jnp.bool_)
        for j in range(dim):
            finite = jnp.logical_and(finite, jnp.isfinite(dz[j]))
        f_ok = jnp.logical_and(best_f < f0, finite)
        # no candidate beats f0 once improvements drop below the value's
        # rounding resolution — evaluate ONE fallback candidate at
        # t* = clip(-g.dz / dz'M dz, 0, t_full), accepted only if it
        # strictly shrinks the projected-gradient norm without leaving the
        # f0 noise band (the gradient resolves far below the value's
        # cancellation floor).  For an UNMODIFIED Newton direction
        # q = -dz'M dz so t* == t_full — i.e. this re-tests the full
        # capped step under the gradient criterion; t* differs only when
        # the coupled (z<=0, dz<0) zeroing above altered dz.
        q = g[0] * dz[0]
        for j in range(1, dim):
            q = q + g[j] * dz[j]
        curv = jnp.zeros((bt, 1), dtype)
        for i in range(dim):
            for j in range(dim):
                mij = m[(i, j)] if i <= j else m[(j, i)]
                curv = curv + mij * dz[i] * dz[j]
        t_star = jnp.clip(-q / jnp.maximum(curv, jnp.finfo(dtype).tiny),
                          0.0, t_full)
        zs_ = [z[j] + t_star * dz[j] for j in range(dim)]
        ys_ = y * jnp.exp(jnp.clip(-t_star * wdir, -max_e, max_e))
        fs_ = val_of(zs_, ys_)
        gs_ = grad_of(zs_, ys_)
        noise = 32.0 * eps * (1.0 + jnp.abs(f0))
        gn0 = pgnorm(z, g)
        g_ok = jnp.logical_and(
            jnp.logical_and(pgnorm(zs_, gs_) < 0.81 * gn0,  # (0.9|g|)^2
                            fs_ <= f0 + noise),
            finite)
        t_take = jnp.where(f_ok, tf, t_star)
        take = jnp.logical_or(f_ok, g_ok)
        z_new = project([jnp.where(take, z[j] + t_take * dz[j], z[j])
                         for j in range(dim)])
        if dim > 8:
            # PROJECTED full-step candidate (wide dims only — statically
            # gated so the dim <= 8 program is bit-unchanged): the
            # fraction-to-boundary cap above retires at most ONE slack lam
            # per step, so a cold start with many slack constraints spends
            # ~k steps just freezing lams (measured: a (k=13, mE=2) family
            # needed 32 steps where dim <= 8 families need ~10).  The
            # classic projected-Newton move max(z + t dz, 0) crosses ALL
            # descending boundaries at once; it costs one extra exp pass
            # (the squared-chain trick only works along the unprojected
            # ray) and is accepted on strict value improvement over both
            # f0 and the ray winner — monotonicity is preserved.
            t_pr = jnp.minimum(jnp.asarray(1.0, dtype), t_trust)
            z_pr = project([z[j] + t_pr * dz[j] for j in range(dim)])
            y_pr = y_of(z_pr)
            f_pr = val_of(z_pr, y_pr)
            pr_ok = jnp.logical_and(
                jnp.logical_and(jnp.isfinite(f_pr), f_pr < best_f),
                finite)
            z_new = [jnp.where(pr_ok, z_pr[j], z_new[j])
                     for j in range(dim)]
        # SNAP to the bound: the step-to-boundary candidate leaves an
        # O(eps*z) positive residual in the landing lam, which then never
        # freezes and the coupled direction jams.  8 eps |z| catches the
        # <= ~4 eps |z| landing residual without zeroing a deliberately
        # computed small positive lam (see duality._polish_dual).
        # BOUNDARY-JAM PURGE (found by the dim-8 widening stress family):
        # when several SLACK lams must creep to 0, the fraction-to-boundary
        # cap shrinks t_bd until the available value improvement
        # (~t_bd * |g.dz|) falls below f32 value resolution — every
        # candidate "ties" f0, the gradient fallback can't shrink the norm
        # by 10% either, and the solve stalls with |g_free| = O(1)
        # (measured: 4/10000 instances of a random 5-row family, gap
        # stuck at 0.37).  A lam below ~32 eps scale whose gradient says
        # "decrease" (g_j > 0) is KKT-identified inactive: zero it
        # directly.  A wrongly purged weakly-active lam costs only
        # ~M_jj lam^2 = O(1e-12) in value and is self-healing (g_j < 0 at
        # 0 unfreezes it next step / in the f64 finishing pass).
        zinf = jnp.zeros((bt, 1), dtype)
        for j in range(dim):
            zinf = jnp.maximum(zinf, jnp.abs(z[j]))
        purge_th = 32.0 * eps * (1.0 + zinf)
        for j in range(k):
            z_new[j] = jnp.where(
                jnp.logical_or(
                    z_new[j] <= 8.0 * eps * jnp.abs(z[j]),
                    jnp.logical_and(g[j] > 0.0, z_new[j] <= purge_th)),
                0.0, z_new[j])
        return tuple(z_new)

    z0s = tuple(jnp.full((bt, 1), z0, dtype) for _ in range(dim))
    # int32 loop bounds: with jax_enable_x64 the Python ints would trace
    # as i64 counters
    return list(lax.fori_loop(jnp.int32(0), jnp.int32(n_steps), step, z0s))



def _kl_dual_kernel(hs_ref, u_ref, logp_ref, x_ref, gap_ref, z_ref, *,
                    k: int, m_eq: int, n_valid: int, n_steps: int,
                    z0: float, n_ls: int, eps: float):
    km = k + m_eq
    # one (bt, npad) load per constraint row and a (bt, 1) load per
    # right-hand side; the padded rows beyond k + mE are never read
    rows = [hs_ref[:, i, :] for i in range(km)]
    ws_in = [u_ref[:, i:i + 1] for i in range(km)]
    logp = logp_ref[...]
    ctx = _make_ctx(rows, ws_in, logp, k=k, m_eq=m_eq, n_valid=n_valid)
    dtype, valid, rsum, val_of = ctx.dtype, ctx.valid, ctx.rsum, ctx.val_of
    z = _newton_z(ctx, n_steps=n_steps, z0=z0, n_ls=n_ls, eps=eps)

    y = ctx.y_of(z)
    sy = rsum(y)
    # sum(y) can underflow to exactly 0 (primal-infeasible instance whose
    # dual climbs without bound): guard the renormalization and force the
    # gap to +inf instead of NaN-poisoning downstream max() metrics
    dead = sy <= 0.0
    x = y / jnp.where(dead, 1.0, sy)
    x_ref[...] = x * valid
    # measured gap f(x) - g(z) = x.(log x - log p) + (w.z + sum y)
    logx = jnp.log(jnp.where(valid > 0, jnp.where(x > 0, x, 1.0), 1.0))
    f_primal = rsum(x * (logx - logp))
    gap_ref[...] = jnp.where(dead, jnp.asarray(jnp.inf, dtype),
                             f_primal + val_of(z, y))
    # the dual iterate itself, one column store per coordinate: the f64
    # finishing pass (models/dist_kl.py kl_certify) warm-starts from it
    # with the active set already settled
    for j in range(ctx.dim):
        z_ref[:, j:j + 1] = z[j]


def _tile(npad: int) -> tuple[int, int]:
    """(instances per program, warps per program) for a padded row width.

    One instance per program, one warp per 256 lanes of its row (at most
    8): a program keeps ~2 dim live rows, and a thread's share of them has
    to stay in registers.  On an H100 (400 W limit) at n = 100, dual dim
    3, one instance on one warp ran 0.48 ms per 10,000 instances against
    0.61-3.1 ms for 2-16 instances on 1-4 warps (PERF.md, "Findings")."""
    return 1, max(1, min(8, npad // 256))


@functools.partial(
    jax.jit,
    static_argnames=("n_steps", "z0", "n_ls", "bt", "num_warps",
                     "interpret"))
def kl_dual_fused(
    Hs: jax.Array,   # (B, k, n) scenario inequality rows
    u: jax.Array,    # (B, k)
    A: jax.Array | None = None,   # (B, m_eq, n) extra equality rows
    r: jax.Array | None = None,   # (B, m_eq)
    log_prior: jax.Array | None = None,   # (n,) shared log p, None=uniform
    *,
    n_steps: int = 16,
    z0: float = 1e-3,
    n_ls: int = 5,
    bt: int | None = None,
    num_warps: int | None = None,
    interpret: bool = False,
):
    """Solve a batch of KL duals entirely inside one Pallas kernel.

    Returns ``(x, gap, z)``: the recovered primal distributions (B, n),
    the MEASURED per-instance duality-gap certificate f(x) - g(z) (g(z)
    is a true lower bound on p* for the dual-feasible z the kernel ends
    at; note x = y/sum(y) restores the simplex but may violate an active
    H row by O(f32 eps), so the gap bounds suboptimality only up to that
    primal residual — pair it with DistKL._ineq_res / Solution.ineq_res,
    and it can be slightly NEGATIVE for a near-optimal infeasible x), and
    the dual iterate z (B, k + 1 + m_eq) itself — the f64 finishing pass
    warm-starts from it.
    Constraint set: Hs x <= u (k >= 0 rows), sum-to-one, and A x = r
    (m_eq >= 0 extra equality rows); dual dim = k + 1 + m_eq <= 16.  Use
    DistKL.solve(method='dual_fast') for larger shapes.
    ``log_prior`` generalizes the objective to d_KL(x, p) for a SHARED
    (n,) prior p (beyond the reference, whose Dist_KL fixes p uniform —
    Dist_KL.scala:218): the dual closed form only changes through
    R = p/e, i.e. one extra broadcast row.

    The kernel is compiled through Triton; ``interpret=True`` runs the
    same blocks in the Pallas interpreter, and only then does it run off
    the GPU (``backend.pallas_mode`` raises otherwise).  ``bt`` and
    ``num_warps`` default to ``_tile``'s choice.
    """
    B, k, n = Hs.shape
    if (A is None) != (r is None):
        raise ValueError("kl_dual_fused: A and r must be given together "
                         "(extra equality rows A x = r)")
    if A is None:
        A = jnp.zeros((B, 0, n), Hs.dtype)
        r = jnp.zeros((B, 0), Hs.dtype)
    if log_prior is None:
        log_prior = jnp.full((n,), -jnp.log(float(n)), Hs.dtype)
    m_eq = A.shape[1]
    km = k + m_eq
    dim = km + 1
    if not (km >= 1 and dim <= FUSED_MAX_DIM):
        raise ValueError(
            f"kl_dual_fused supports 1 <= k + m_eq and k + 1 + m_eq <= "
            f"{FUSED_MAX_DIM}, got k={k}, m_eq={m_eq}")
    interpret = backend.pallas_mode(interpret) == "interpret"
    dtype = Hs.dtype
    npad = pl.next_power_of_2(n)
    kmpad = pl.next_power_of_2(km)
    dimpad = pl.next_power_of_2(dim)
    bt_auto, warps_auto = _tile(npad)
    bt = bt or bt_auto
    num_warps = num_warps or warps_auto
    if bt != pl.next_power_of_2(bt):
        raise ValueError(f"kl_dual_fused: bt must be a power of two, "
                         f"got {bt}")
    bpad = -(-B // bt) * bt

    # one stacked (B, k + m_eq, n) row tensor and (B, k + m_eq) rhs keep the
    # kernel signature fixed.  Padding: inequality rows 0 with u = 1
    # (inactive); equality rows 0 with r = 0 (zero gradient, inert); the
    # power-of-two row slots beyond k + m_eq are never read.
    rows = jnp.concatenate([Hs, A], axis=1)
    rhs_pad = jnp.concatenate([jnp.ones((bpad, k), dtype),
                               jnp.zeros((bpad, kmpad - k), dtype)], axis=1)
    rows_p = jnp.zeros((bpad, kmpad, npad), dtype).at[:B, :km, :n].set(rows)
    rhs_p = rhs_pad.at[:B, :k].set(u.astype(dtype))
    if m_eq > 0:
        rhs_p = rhs_p.at[:B, k:km].set(r.astype(dtype))
    # shared (1, npad) log-prior row, zero on pad lanes (masked in-kernel)
    logp_p = jnp.zeros((1, npad), dtype).at[0, :n].set(
        jnp.asarray(log_prior, dtype))

    kern = functools.partial(
        _kl_dual_kernel, k=k, m_eq=m_eq, n_valid=n, n_steps=n_steps,
        z0=z0, n_ls=n_ls, eps=float(jnp.finfo(dtype).eps))
    x, gap, z = pl.pallas_call(
        kern,
        out_shape=(jax.ShapeDtypeStruct((bpad, npad), dtype),
                   jax.ShapeDtypeStruct((bpad, 1), dtype),
                   jax.ShapeDtypeStruct((bpad, dimpad), dtype)),
        grid=(bpad // bt,),
        in_specs=[
            pl.BlockSpec((bt, kmpad, npad), lambda i: (i, 0, 0)),
            pl.BlockSpec((bt, kmpad), lambda i: (i, 0)),
            pl.BlockSpec((1, npad), lambda i: (0, 0)),
        ],
        out_specs=(pl.BlockSpec((bt, npad), lambda i: (i, 0)),
                   pl.BlockSpec((bt, 1), lambda i: (i, 0)),
                   pl.BlockSpec((bt, dimpad), lambda i: (i, 0))),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        interpret=interpret,
        name=KERNEL_NAME,
    )(rows_p, rhs_p, logp_p)
    return x[:B, :n], gap[:B, 0], z[:B, :dim]
