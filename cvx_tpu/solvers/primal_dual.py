"""Infeasible-start primal-dual interior-point solver.

Re-design of cvx/PrimalDualSolver.scala (:18-728), which
implements Boyd–Vandenberghe section 11.7.  One ``lax.while_loop`` carries
(x, lambda, nu); each iteration:

  residuals (B-V p610, PrimalDualSolver.scala:63-144):
      r_dual = grad f + Dg^T lambda (+ A^T nu)
      r_cent = -diag(lambda) f(x) - (1/t) 1          (f = g - ub < 0)
      r_pri  = A x - b

  reduced KKT matrix with delta-lambda eliminated (11.56, :216-240):
      H_pd = hess f + sum_i lambda_i hess g_i + Dg^T diag(-lambda/f) Dg

  reduced right-hand side (11.55 top row, re-derived from B-V — the
  reference's version at PrimalDualSolver.scala:268-285 carries a sign
  ambiguity flagged 'FIX ME' in its own comment):
      H_pd dx + A^T dnu = -grad f - A^T nu + (1/t) Dg^T (1/f)
      A dx              = -r_pri

  delta-lambda back-substitution (:184-209):
      dlambda_i = (-lambda_i (Dg dx)_i + r_cent_i) / f_i

  line search (11.7.3, :311-374): s = 0.99 * min(1, min_{dl<0} -l/dl), then
  backtrack until strictly feasible AND ||r_t|| decreased by (1 - alpha*s).

  t = mu * m / eta_hat with surrogate gap eta_hat = -f(x).lambda (:289-297).

The constraint-side quantities use the fused ConstraintSet views, so H_pd
assembly is einsum-dense rather than the reference's per-constraint loop.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
from jax import lax

from ..problem.constraint_set import ConstraintSet
from ..problem.equality import EqualityConstraint
from ..ops.kkt import kkt_solve, sym_solve
from .types import OptState, Solution, SolverParams
from ..tree import mxu_exact


@mxu_exact
def primal_dual_solve(
    obj,
    cnts: ConstraintSet,
    x0: jax.Array,
    pars: SolverParams | None = None,
    eqs: EqualityConstraint | None = None,
    criterion: Callable | None = None,
) -> Solution:
    """Minimize ``obj`` s.t. ``cnts`` (+ optional ``A x = b``) from the
    strictly feasible point ``x0``.

    Default termination (PrimalDualSolver.scala:630-631): surrogate gap and
    dual-residual norm below tol (plus equality gap when equalities exist).
    """
    pars = pars or SolverParams()
    m = cnts.m
    # follow JAX promotion semantics for mixed-precision inputs: an f32 x0
    # against f64 constraint data computes in f64 (the residual dtype), so
    # promote the iterate up front — otherwise the while_loop carry mixes
    # dtypes and trips the trace-time type check
    x0 = x0.astype(jnp.result_type(
        x0.dtype, jax.eval_shape(cnts.residual, x0).dtype))
    dtype = x0.dtype
    nan = jnp.asarray(jnp.nan, dtype)
    has_eqs = eqs is not None
    p = eqs.p if has_eqs else 0
    # max backtracking steps: beta^k < 1e-13  (PrimalDualSolver.scala:354).
    # ls_max shapes the trace, so it needs a CONCRETE beta; when pars cross
    # a jit boundary as an argument the float leaves are tracers — fall
    # back to the static ls_max_steps (its compressed-exponent schedule
    # reaches beta^125 ~ 7e-13 at the default beta, same coverage).
    try:
        ls_max = int(-30.0 / float(jnp.log(pars.beta))) + 1
    except jax.errors.ConcretizationTypeError:
        ls_max = pars.ls_max_steps

    if criterion is None:
        # dtype-aware floors: residual norms bottom out at ~eps * scale, so
        # absolute 1e-8 targets never fire in float32 (same rationale as
        # barrier_solve)
        eps = jnp.finfo(dtype).eps
        gap_tol = jnp.maximum(jnp.asarray(pars.tol, dtype), 50.0 * eps)
        res_tol = jnp.maximum(jnp.asarray(pars.tol, dtype), 1e3 * eps)

        def criterion(s: OptState):
            ok = jnp.logical_and(s.duality_gap < gap_tol,
                                 s.norm_dual_residual < res_tol)
            if has_eqs:
                ok = jnp.logical_and(ok, s.eq_gap < jnp.sqrt(gap_tol))
            return ok

    def residual(t, x, lam, nu):
        """Full residual vector r_t = (r_dual, r_cent[, r_pri])."""
        f = cnts.residual(x)
        G = cnts.jac(x)
        r_dual = obj.grad(x) + G.T @ lam
        if has_eqs:
            r_dual = r_dual + eqs.A.T @ nu
        r_cent = -lam * f - 1.0 / t
        parts = [r_dual, r_cent]
        if has_eqs:
            parts.append(eqs.A @ x - eqs.b)
        return jnp.concatenate(parts)

    def surrogate_gap(x, lam):
        return -(cnts.residual(x) @ lam)

    def body(carry):
        x, lam, nu, _, _, _, it, _ = carry
        eta = surrogate_gap(x, lam)
        t = pars.mu * m / eta

        f = cnts.residual(x)
        G = cnts.jac(x)
        inv_f = 1.0 / f
        # reduced KKT matrix H_pd (11.56)
        H_pd = (obj.hess(x) + cnts.whess(x, lam)
                + jnp.einsum("mi,m,mj->ij", G, -lam * inv_f, G))
        # reduced rhs (11.55): H_pd dx + A^T dnu = rhs_top, A dx = -r_pri
        rhs_top = -obj.grad(x) + (1.0 / t) * (G.T @ inv_f)
        if has_eqs:
            rhs_top = rhs_top - eqs.A.T @ nu
            r_pri = eqs.A @ x - eqs.b
            dx, dnu, _ = kkt_solve(H_pd, eqs.A, -rhs_top, -r_pri,
                                   method=pars.kkt_method,
                                   refine=pars.kkt_refine,
                                   delta=pars.chol_delta,
                                   tol=pars.tol_eq_solve)
        else:
            dx, _ = sym_solve(H_pd, rhs_top, method=pars.kkt_method,
                              refine=pars.kkt_refine, delta=pars.chol_delta,
                              tol=pars.tol_eq_solve)
            dnu = jnp.zeros((0,), dtype)
        # f64 pars leaves (chol_delta under jax_enable_x64) must not
        # promote the carry through the step
        dx = dx.astype(dtype)
        dnu = dnu.astype(dtype)

        # delta-lambda back-substitution
        r_cent = -lam * f - 1.0 / t
        w = G @ dx
        dlam = (-lam * w + r_cent) * inv_f

        # line search: largest s keeping lambda > 0, then vectorized
        # backtracking — all candidate steps evaluated in one fused pass
        # (see newton._backtrack for the rationale)
        ratios = jnp.where(dlam < 0, -lam / dlam, jnp.inf)
        s0 = pars.pd_step_frac * jnp.minimum(1.0, jnp.min(ratios))
        norm_rt = jnp.linalg.norm(residual(t, x, lam, nu))

        def accept(s):
            xs = x + s * dx
            lams = lam + s * dlam
            nus = nu + s * dnu
            feas = cnts.satisfied_strictly(xs)
            dec = (jnp.linalg.norm(residual(t, xs, lams, nus))
                   <= (1.0 - pars.alpha * s) * norm_rt)
            return jnp.logical_and(feas, dec)

        _kk = jnp.arange(ls_max)
        _expo = jnp.where(_kk < 32, _kk, 32 + 3 * (_kk - 32)).astype(dtype)
        ss = (s0 * pars.beta ** _expo).astype(dtype)
        accepts = jax.vmap(accept)(ss)
        # true select + finiteness guard: with s = 0 and a non-finite Newton
        # direction, x + s * dx would be NaN (0 * inf)
        ok = jnp.logical_and(
            jnp.any(accepts),
            jnp.all(jnp.isfinite(dx)) & jnp.all(jnp.isfinite(dlam)))
        stalled = jnp.logical_not(ok)
        s = jnp.where(ok, ss[jnp.argmax(accepts)], 0.0)

        x_n = jnp.where(ok, x + s * dx, x)
        lam_n = jnp.where(ok, lam + s * dlam, lam)
        nu_n = jnp.where(ok, nu + s * dnu, nu)

        gap = surrogate_gap(x_n, lam_n)
        Gn = cnts.jac(x_n)
        r_dual = obj.grad(x_n) + Gn.T @ lam_n
        if has_eqs:
            r_dual = r_dual + eqs.A.T @ nu_n
            eq_gap = jnp.linalg.norm(eqs.A @ x_n - eqs.b)
        else:
            eq_gap = jnp.asarray(0.0, dtype)
        return (x_n, lam_n, nu_n, gap, jnp.linalg.norm(r_dual), eq_gap,
                it + 1, stalled)

    def cond(carry):
        x, lam, nu, gap, ndr, eq_gap, it, stalled = carry
        state = OptState(norm_grad=nan, newton_decrement=nan,
                         duality_gap=gap, eq_gap=eq_gap,
                         obj_value=obj.value(x), norm_dual_residual=ndr)
        go = jnp.logical_not(criterion(state))
        go = jnp.logical_and(go, it < 2 * pars.outer_max_iter)
        go = jnp.logical_and(go, jnp.logical_not(stalled))
        return go

    lam0 = cnts.lambda_init(x0)  # -1/f_i  (ConstraintSet.scala:116-120)
    nu0 = jnp.zeros((p,), dtype)
    inf = jnp.asarray(jnp.inf, dtype)
    init = (x0, lam0, nu0, surrogate_gap(x0, lam0), inf, inf,
            jnp.asarray(0), jnp.asarray(False))
    x, lam, nu, gap, ndr, eq_gap, it, stalled = lax.while_loop(
        cond, body, init
    )
    return Solution(
        x=x, lam=lam, nu=nu, newton_decrement=nan, duality_gap=gap,
        eq_gap=eq_gap, norm_grad=nan, norm_dual_residual=ndr, iters=it,
        maxed_out=it >= 2 * pars.outer_max_iter,
        stalled=stalled,
    )
