"""Log-barrier interior-point solver.

Re-design of cvx/BarrierSolver.scala (:22-317): the outer
continuation over the barrier parameter t (t <- mu*t, duality gap m/t) is a
``lax.while_loop`` whose body runs a full inner Newton solve on the barrier
function phi(t,x) = t f(x) - sum_i log(u_i - g_i(x)).  The barrier value /
gradient / Hessian come from the fused assembly in
ConstraintSet.barrier_value_grad_hess instead of the reference's
per-constraint fold (BarrierSolver.scala:269-316).

The whole solve — continuation, Newton, line searches, KKT factorizations —
is ONE jit-compiled program and vmaps over instance batches.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
from jax import lax

from ..problem.constraint_set import ConstraintSet
from ..problem.equality import EqualityConstraint
from .newton import newton_minimize, newton_minimize_eq
from .types import OptState, Solution, SolverParams
from ..tree import mxu_exact


@mxu_exact
def barrier_solve(
    obj,
    cnts: ConstraintSet,
    x0: jax.Array,
    pars: SolverParams | None = None,
    eqs: EqualityConstraint | None = None,
    criterion: Callable | None = None,
    stop_inner: Callable | None = None,
    t0: float = 1.0,
) -> Solution:
    """Minimize ``obj`` s.t. ``cnts`` (+ optional ``A x = b``) from the
    STRICTLY FEASIBLE point ``x0`` by the barrier method.

    ``criterion(OptState) -> bool`` is the injectable outer termination test
    (BarrierSolver.scala:87,144); default = duality gap m/t < tol and
    equality gap < tol.  ``stop_inner(x) -> bool`` optionally terminates the
    inner Newton solves early (phase-I).
    """
    pars = pars or SolverParams()
    m = cnts.m
    # promote the iterate to the joint dtype with the constraint data (see
    # primal_dual_solve — mixed f32/f64 inputs must follow JAX promotion,
    # not crash the while_loop carry type check)
    x0 = x0.astype(jnp.result_type(
        x0.dtype, jax.eval_shape(cnts.residual, x0).dtype))
    dtype = x0.dtype
    # dtype-aware equality tolerance: ||Ax-b|| has a floor of ~eps * scale,
    # so an absolute 1e-8 can never fire in float32 — without this, t grows
    # until the barrier Hessian overflows (the f32 fast path).
    eps = jnp.finfo(dtype).eps
    eq_tol = jnp.maximum(jnp.asarray(pars.tol, dtype), 100.0 * eps)
    if criterion is None:
        def criterion(s: OptState):
            return jnp.logical_and(s.duality_gap < pars.tol,
                                   s.eq_gap < eq_tol)
    # no point growing t beyond the gap target (plus one decade of margin)
    t_max = 10.0 * pars.mu * m / pars.tol
    nan = jnp.asarray(jnp.nan, dtype)
    inf = jnp.asarray(jnp.inf, dtype)

    def in_set(x):
        return cnts.satisfied_strictly(x)

    def state_of(gap, eq_gap, fval):
        return OptState(norm_grad=nan, newton_decrement=nan,
                        duality_gap=gap, eq_gap=eq_gap, obj_value=fval,
                        norm_dual_residual=nan)

    def cond(carry):
        x, t, gap, eq_gap, fval, it, n_newton, stalled, t_active = carry
        done = criterion(state_of(gap, eq_gap, fval))
        go = jnp.logical_not(done)
        go = jnp.logical_and(go, it < pars.outer_max_iter)
        go = jnp.logical_and(go, t <= t_max)
        # inner stalls do NOT abort the continuation: the duality-gap bound
        # m/t keeps improving as t anneals even when the iterate can no
        # longer move at this dtype's resolution, and a stalled stage exits
        # its inner loop after a single Newton step (cheap).  t_max and
        # outer_max_iter bound the loop.
        return go

    # a line-search stall is benign once the continuation gap m/t is near
    # the target (extreme-t barrier arithmetic runs out of mantissa and the
    # decrement is cancellation-inflated); a REAL failure stalls while the
    # gap bound is still far above tol.  Sticky across stages.
    hard_stall_gap = jnp.sqrt(jnp.maximum(
        jnp.asarray(pars.tol, dtype), 50.0 * eps))

    def body(carry):
        x, t, _, _, _, it, n_newton, hard, t_active = carry

        def fgh(x_):
            return cnts.barrier_value_grad_hess(obj, t, x_)

        if eqs is not None:
            res = newton_minimize_eq(fgh, in_set, x, eqs.A, eqs.b, pars,
                                     stop_fn=stop_inner)
            eq_gap = res.eq_gap
        else:
            res = newton_minimize(fgh, in_set, x, pars, stop_fn=stop_inner)
            eq_gap = jnp.asarray(0.0, dtype)

        gap = m / t
        fval = obj.value(res.x)
        hard = jnp.logical_or(hard, jnp.logical_and(
            res.stalled, gap > hard_stall_gap))
        # track the last t at which the iterate actually moved: at high t in
        # low precision the Newton math drops below roundoff and x freezes —
        # the dual estimate must use the t x actually tracks, not the final
        # continuation value
        moved = jnp.any(res.x != x)
        t_active = jnp.where(moved, t, t_active)
        return (res.x, pars.mu * t, gap, eq_gap, fval, it + 1,
                n_newton + res.iters, hard, t_active)

    init = (x0, jnp.asarray(t0, dtype), inf, inf, inf,
            jnp.asarray(0), jnp.asarray(0), jnp.asarray(False),
            jnp.asarray(t0, dtype))
    (x, t, gap, eq_gap, fval, outer_it, n_newton, stalled,
     t_active) = lax.while_loop(cond, body, init)

    # dual estimate from the last tracked barrier subproblem:
    # lambda_i = 1 / (t * d_i)  (Boyd-Vandenberghe section 11.2.2)
    t_solved = t_active
    d_exit = cnts.margins(x)
    lam = 1.0 / (t_solved * d_exit)
    # exit-state sanity: non-finite or clearly violated margins mean the
    # instance was poisoned/overflowed and froze — flag it per instance.
    # Active margins legitimately round to ~0 at the final t; allow
    # rounding-scale slack.
    slack = 100.0 * eps * (1.0 + jnp.abs(cnts.ub))
    healthy = jnp.logical_and(
        jnp.all(jnp.isfinite(x)),
        jnp.logical_and(jnp.all(jnp.isfinite(d_exit)),
                        jnp.all(d_exit > -slack)))
    p = eqs.p if eqs is not None else 0
    return Solution(
        x=x, lam=lam, nu=jnp.full((p,), jnp.nan, dtype),
        newton_decrement=nan,
        duality_gap=jnp.where(healthy, gap, nan), eq_gap=eq_gap,
        norm_grad=nan, norm_dual_residual=nan,
        iters=n_newton, maxed_out=outer_it >= pars.outer_max_iter,
        stalled=jnp.logical_or(stalled, jnp.logical_not(healthy)),
    )
