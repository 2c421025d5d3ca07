"""Damped-Newton minimization over an open convex set.

Re-design of cvx/UnconstrainedSolver.scala (:22-209) and
cvx/EqualityConstrainedSolver.scala (:18-170): the inner engines of the
barrier method.  The reference's mutable while loops become
``lax.while_loop``s over explicit carry pytrees; the whole solve is one
compiled program and vmaps over instance batches.

Line search: from x + d backtrack x + t*d (t *= beta) until the point is
inside the set AND satisfies Armijo f(x+t d) <= f + alpha*t*(g.d), as a
single inner while_loop (equivalent to the reference's two sequential
backtracking loops at UnconstrainedSolver.scala:91-111 since t shrinks
monotonically).  NaN-safe: an out-of-domain trial where f is NaN fails the
explicit acceptance predicate.

A note on the reference's trust region (UnconstrainedSolver.scala:85-105):
its adaptation factor is ``val rho = 1+1/4`` — integer division, so rho == 1
and the radius never changes; the trust region is effectively inert.  We
implement plain damped Newton, matching the reference's actual behavior.

Per-instance failure (line-search exhaustion) becomes a ``stalled`` flag in
the carry instead of a LineSearchFailedException — a vmapped batch keeps
going for the healthy instances (SURVEY.md section 7.3 'exceptions->masks').
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
from jax import lax

from ..ops.kkt import kkt_solve, sym_solve
from ..tree import mxu_exact
from .types import NewtonResult, SolverParams


def _backtrack(value_fn, in_set, x, d, f0, q, pars, require_armijo=True):
    """Vectorized backtracking line search.  Returns (t, accepted).

    Instead of the reference's sequential t *= beta loop
    (UnconstrainedSolver.scala:91-111) — which under jit becomes a
    while_loop whose every trial re-evaluates all constraints — ALL
    candidate step sizes beta^k, k = 0..ls_max_steps, are evaluated in one
    batched pass (one fused kernel; the constraint evaluations become a
    single matmul over the trial axis) and the largest acceptable t wins.
    Identical result to sequential backtracking, with no serial loop.

    ``require_armijo`` may be a traced bool: when False the search only
    backtracks into the set (used for pure feasibility-restoration steps of
    the infeasible-start equality-constrained Newton, where g.d can be 0).
    """
    kk = jnp.arange(pars.ls_max_steps)
    expo = jnp.where(kk < 32, kk, 32 + 3 * (kk - 32)).astype(x.dtype)
    # under jax_enable_x64 the pars scalar LEAVES canonicalize to f64, so
    # beta ** expo would promote the step (and then the iterate) to f64 —
    # pin everything step-shaped to the iterate dtype
    ts = (pars.beta ** expo).astype(x.dtype)

    def acceptable(t):
        xt = x + t * d
        ft = value_fn(xt)
        ok = jnp.logical_and(in_set(xt), jnp.isfinite(ft))
        armijo = ft <= f0 + pars.alpha * t * q
        return jnp.logical_and(
            ok, jnp.logical_or(jnp.logical_not(require_armijo), armijo)
        )

    accept = jax.vmap(acceptable)(ts)
    idx = jnp.argmax(accept)  # first True (largest t)
    return ts[idx], jnp.any(accept)


@mxu_exact
def newton_minimize(
    fgh: Callable,
    in_set: Callable,
    x0: jax.Array,
    pars: SolverParams,
    stop_fn: Callable | None = None,
) -> NewtonResult:
    """Minimize f over the open set C by damped Newton.

    ``fgh(x) -> (f, g, H)``; ``in_set(x) -> bool`` is the strict-membership
    predicate used by the backtracking line search; ``stop_fn(x) -> bool``
    optionally terminates early (phase-I: stop once the slack goes negative).

    Loop condition mirrors UnconstrainedSolver.scala:47:
    ``iter < maxIter && newtonDecrement > tol && normGrad > tol``.
    """

    def value_fn(x):
        return fgh(x)[0]

    big = jnp.asarray(jnp.inf, x0.dtype)
    # dtype-aware decrement/gradient tolerance: 1e-8 is below float32's
    # resolution of the decrement, so the loop would burn max_iter steps
    tol = jnp.maximum(jnp.asarray(pars.tol, x0.dtype),
                      50.0 * jnp.finfo(x0.dtype).eps)

    def cond(carry):
        x, dec, ngrad, it, stalled = carry
        go = jnp.logical_and(dec > tol, ngrad > tol)
        go = jnp.logical_and(go, it < pars.max_iter)
        go = jnp.logical_and(go, jnp.logical_not(stalled))
        if stop_fn is not None:
            go = jnp.logical_and(go, jnp.logical_not(stop_fn(x)))
        return go

    def body(carry):
        x, _, _, it, _ = carry
        f, g, H = fgh(x)
        # Newton step: always-regularized solve (replaces the reference's
        # choleskySolve -> +1e-9 I -> symSolve ladder,
        # UnconstrainedSolver.scala:54-67)
        d, _ = sym_solve(H, -g, method=pars.kkt_method,
                         refine=pars.kkt_refine, delta=pars.chol_delta,
                         tol=pars.tol_eq_solve)
        d = d.astype(x.dtype)  # f64 pars leaves must not promote the carry
        q = d @ g
        dec = -q / 2.0

        def do_step(_):
            t, accepted = _backtrack(value_fn, in_set, x, d, f, q, pars)
            # a failed/overflowed factorization yields non-finite d: keep the
            # iterate via a true select (an arithmetic blend would turn the
            # frozen iterate into NaN through 0 * inf)
            accepted = jnp.logical_and(accepted, jnp.all(jnp.isfinite(d)))
            x_new = jnp.where(accepted, x + t * d, x)
            return x_new, jnp.logical_not(accepted)

        def no_step(_):
            # not a descent direction or already converged-by-decrement:
            # loop exits via dec <= tol
            return x, jnp.asarray(False)

        x_new, stalled = lax.cond(dec > tol, do_step, no_step, None)
        g_new = fgh(x_new)[1]
        return x_new, dec, jnp.linalg.norm(g_new), it + 1, stalled

    f0, g0, _ = fgh(x0)
    init = (x0, big, jnp.linalg.norm(g0), jnp.asarray(0),
            jnp.asarray(False))
    x, dec, ngrad, it, stalled = lax.while_loop(cond, body, init)
    return NewtonResult(
        x=x, newton_decrement=dec, norm_grad=ngrad,
        eq_gap=jnp.asarray(jnp.nan, x.dtype), iters=it,
        maxed_out=it >= pars.max_iter, stalled=stalled,
    )


@mxu_exact
def newton_minimize_eq(
    fgh: Callable,
    in_set: Callable,
    x0: jax.Array,
    A: jax.Array,
    b: jax.Array,
    pars: SolverParams,
    stop_fn: Callable | None = None,
) -> NewtonResult:
    """Newton with equality constraints A x = b (infeasible start allowed).

    Steps solve the KKT system [[H, A^T], [A, 0]] (d, w) = (-g, b - A x)
    (EqualityConstrainedSolver.scala:49-99).  Loop runs while
    ``(dec > tol && ngrad > tol) || ||Ax-b|| > tol``.
    """

    def value_fn(x):
        return fgh(x)[0]

    big = jnp.asarray(jnp.inf, x0.dtype)
    tol = jnp.maximum(jnp.asarray(pars.tol, x0.dtype),
                      50.0 * jnp.finfo(x0.dtype).eps)

    def cond(carry):
        x, dec, ngrad, eq_err, it, stalled = carry
        opt = jnp.logical_and(dec > tol, ngrad > tol)
        go = jnp.logical_or(opt, eq_err > tol)
        go = jnp.logical_and(go, it < pars.max_iter)
        go = jnp.logical_and(go, jnp.logical_not(stalled))
        if stop_fn is not None:
            go = jnp.logical_and(go, jnp.logical_not(stop_fn(x)))
        return go

    def body(carry):
        x, _, _, _, it, _ = carry
        f, g, H = fgh(x)
        eq_diff = b - A @ x
        d, _, _ = kkt_solve(H, A, g, eq_diff, method=pars.kkt_method,
                            refine=pars.kkt_refine, delta=pars.chol_delta,
                            tol=pars.tol_eq_solve)
        d = d.astype(x.dtype)  # f64 pars leaves must not promote the carry
        q = d @ g
        dec = -q / 2.0
        eq_err0 = jnp.linalg.norm(eq_diff)

        # Step whenever there is optimality OR feasibility progress to make.
        # When the decrement is ~0 but Ax != b (e.g. zero gradient at an
        # infeasible start) the Newton step still restores A(x+d) = b, so
        # take it — but ONLY if it actually shrinks ||Ax-b|| (otherwise the
        # equality residual has hit its numerical floor and stepping would
        # random-walk the iterate; stall out instead and let the outer loop
        # proceed with the floor-level equality gap).
        descent = dec > tol
        take_step = jnp.logical_or(descent, eq_err0 > tol)

        def do_step(_):
            kk = jnp.arange(pars.ls_max_steps)
            expo = jnp.where(kk < 32, kk, 32 + 3 * (kk - 32)).astype(x.dtype)
            ts = (pars.beta ** expo).astype(x.dtype)  # see _backtrack

            def acceptable(t):
                xt = x + t * d
                ft = value_fn(xt)
                ok = jnp.logical_and(in_set(xt), jnp.isfinite(ft))
                armijo = ft <= f + pars.alpha * t * q
                eq_improves = (jnp.linalg.norm(b - A @ xt)
                               <= (1.0 - pars.alpha * t) * eq_err0)
                return jnp.logical_and(
                    ok, jnp.where(descent, armijo, eq_improves)
                )

            accept = jax.vmap(acceptable)(ts)
            idx = jnp.argmax(accept)
            t = ts[idx]
            accepted = jnp.logical_and(jnp.any(accept),
                                       jnp.all(jnp.isfinite(d)))
            x_new = jnp.where(accepted, x + t * d, x)
            return x_new, jnp.logical_not(accepted)

        def no_step(_):
            return x, jnp.asarray(False)

        x_new, stalled = lax.cond(take_step, do_step, no_step, None)
        g_new = fgh(x_new)[1]
        eq_err = jnp.linalg.norm(b - A @ x_new)
        return (x_new, dec, jnp.linalg.norm(g_new), eq_err, it + 1, stalled)

    g0 = fgh(x0)[1]
    init = (x0, big, jnp.linalg.norm(g0),
            jnp.linalg.norm(b - A @ x0), jnp.asarray(0), jnp.asarray(False))
    x, dec, ngrad, eq_err, it, stalled = lax.while_loop(cond, body, init)
    return NewtonResult(
        x=x, newton_decrement=dec, norm_grad=ngrad, eq_gap=eq_err,
        iters=it, maxed_out=it >= pars.max_iter, stalled=stalled,
    )
