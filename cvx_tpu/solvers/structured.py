"""Structure-exploiting barrier solver: diagonal Hessian + low-rank rows.

The flagship workload's barrier Hessian is NOT a generic dense matrix:

    phi(t,x) = t f(x) - sum_j log(x_j) - sum_i log(u_i - (Ux)_i)
    hess     = diag(t f''(x) + 1/x^2)  +  U^T diag(1/d^2) U,

with f'' DIAGONAL (KL: 1/x; separable QPs; LPs: 0) and U just the k dense
scenario rows (k << n) — the n positivity constraints contribute only to the
diagonal.  The reference always materializes and factors the dense n x n
Hessian (KKTSystem.scala); here the Newton-KKT solve uses the Woodbury
identity and a (k+p)-level Schur complement:

    H^-1 r = D^-1 r - D^-1 U^T (W^-1 + U D^-1 U^T)^-1 U D^-1 r

so one Newton step costs O(n (k+p)^2 + (k+p)^3) instead of O(n^3) — about
300x fewer FLOPs at n=100, k=2, p=1, and NO (n, n) intermediates, which is
what actually matters on an accelerator (HBM traffic of a 10k-instance batch drops from
650 MB to 4 MB per tensor).  The line search reuses the directional
quantities (U dx, A dx), making each candidate O(n).

This is the batched answer to the reference's ``kktType = 1`` hook ("take
advantage of special structure in the matrix H", KKTSystem.scala:17-21).
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
from jax import lax

from .types import Solution, SolverParams
from ..ops.cholesky import default_delta
from ..tree import mxu_exact


def _woodbury_solver(h: jax.Array, U: jax.Array, w: jax.Array,
                     delta: float):
    """Return solveH(r) for H = diag(h) + U^T diag(w) U  (w > 0).

    M = diag(1/w) + U D^-1 U^T is (k, k); factored once per Newton step.
    """
    k = U.shape[0]
    inv_h = 1.0 / h
    UD = U * inv_h[None, :]                # (k, n) = U D^-1
    if k == 0:
        def solveH(r):
            return (inv_h * r.T).T if r.ndim == 2 else inv_h * r

        return solveH

    M = jnp.diag(1.0 / w) + UD @ U.T       # (k, k)
    # scale-RELATIVE shift (an absolute one would swamp M when H ~ t grows)
    scale = jnp.mean(jnp.abs(jnp.diag(M)))
    M = M + (delta * scale) * jnp.eye(k, dtype=h.dtype)
    L = jnp.linalg.cholesky(M)

    def solveH(r):
        # r: (n,) or (n, q)
        Dr = (inv_h * r.T).T if r.ndim == 2 else inv_h * r
        s = UD @ r
        y = jax.scipy.linalg.cho_solve((L, True), s)
        corr = UD.T @ y
        return Dr - corr

    return solveH


@mxu_exact
def barrier_solve_structured(
    obj: Any,
    U: jax.Array,
    ub: jax.Array,
    A: jax.Array,
    b: jax.Array,
    x0: jax.Array,
    pars: SolverParams | None = None,
    t0: float = 1.0,
) -> Solution:
    """Barrier method for  min f(x)  s.t.  U x <= ub,  x > 0,  A x = b.

    Requirements: ``obj`` exposes value/grad and DIAGONAL hess_diag; the
    inequality rows U are few (k << n); positivity of x is implied (its
    barrier term is built in).  x0 must be strictly feasible (x0 > 0,
    U x0 < ub).  This covers the KL primal problem and diagonal-QP/LP
    families at O(n (k+p)^2) per Newton step.
    """
    pars = pars or SolverParams()
    dtype = x0.dtype
    n = x0.shape[0]
    k = U.shape[0]
    p = A.shape[0]
    m = k + n  # inequality count incl. positivity
    eps = jnp.finfo(dtype).eps
    tol = jnp.maximum(jnp.asarray(pars.tol, dtype), 50.0 * eps)
    eq_tol = jnp.maximum(jnp.asarray(pars.tol, dtype), 100.0 * eps)
    delta = pars.chol_delta
    if delta is None:
        delta = default_delta(dtype)
    t_max = 10.0 * pars.mu * m / pars.tol
    # the feasible step range is computed in closed form (all constraints are
    # linear in s), so only a few Armijo candidates are needed below s_max
    n_ls = min(pars.ls_max_steps, 12)
    ls_ts = pars.beta ** jnp.arange(n_ls, dtype=dtype)

    def barrier_val(t, x, d):
        return (t * obj.value(x) - jnp.sum(jnp.log(d))
                - jnp.sum(jnp.log(x)))

    def newton_step(t, x):
        d = ub - U @ x                       # (k,) margins of dense rows
        inv_d = 1.0 / d
        g = t * obj.grad(x) + U.T @ inv_d - 1.0 / x
        h = t * obj.hess_diag(x) + 1.0 / (x * x)
        solveH = _woodbury_solver(h, U, inv_d * inv_d, delta)

        # KKT with equalities: Schur on the p-level
        HiAt = solveH(A.T)                   # (n, p)
        Hig = solveH(g)                      # (n,)
        S = A @ HiAt                         # (p, p)
        S = 0.5 * (S + S.T)
        # NO shift on S: the Schur solve computed consistently from the same
        # (approximate) inner solver preserves A dx = rhs EXACTLY; a shift
        # here injects equality drift ~ delta * ||H^-1 g||, which grows with
        # t for LP-type objectives.  Requires A of full row rank.
        Ls = jnp.linalg.cholesky(S)
        rhs_eq = b - A @ x
        z = -(rhs_eq + A @ Hig)
        wv = jax.scipy.linalg.cho_solve((Ls, True), z)
        dx = -(Hig + HiAt @ wv)

        q = dx @ g
        dec = -q / 2.0

        # closed-form max feasible step (every constraint is linear in s):
        #   x + s dx > 0  and  d - s (U dx) > 0
        Udx = U @ dx
        sx = jnp.min(jnp.where(dx < 0, -x / dx, jnp.inf))
        sd = (jnp.min(jnp.where(Udx > 0, d / Udx, jnp.inf))
              if k > 0 else jnp.asarray(jnp.inf, dtype))
        s_max = 0.99 * jnp.minimum(1.0 / 0.99, jnp.minimum(sx, sd))
        f0 = barrier_val(t, x, d)

        def accept(s):
            xs = x + s * dx
            ds = d - s * Udx
            ok = jnp.logical_and(jnp.all(xs > 0), jnp.all(ds > 0))
            fs = jnp.where(ok, barrier_val(t, xs, ds), jnp.inf)
            armijo = fs <= f0 + pars.alpha * s * q
            # A(x+s dx) - b = (1-s)(Ax-b): equality error is monotone in s
            return jnp.logical_and(ok, armijo)

        acc = jax.vmap(accept)(s_max * ls_ts)
        any_acc = jnp.any(acc)
        s = jnp.where(any_acc, s_max * ls_ts[jnp.argmax(acc)], 0.0)
        # true select + finiteness guard: dx can be non-finite once an
        # instance's margins drop below this dtype's resolution; a blend
        # (0 * NaN) would poison the frozen iterate
        take = jnp.logical_and(jnp.logical_and(dec > tol, any_acc),
                               jnp.all(jnp.isfinite(dx)))
        x_new = jnp.where(take, x + s * dx, x)
        stalled = jnp.logical_and(dec > tol, jnp.logical_not(take))
        return x_new, dec, stalled

    # a line-search failure is BENIGN once the continuation gap m/t is near
    # the target (at extreme t the margin/log arithmetic runs out of
    # mantissa — the final stages routinely stall with the iterate already
    # optimal to the dtype's practical resolution, and the decrement itself
    # is cancellation-inflated there, so it cannot be the signal).  A stall
    # is REAL when the gap bound was still far above tol.  Sticky.
    hard_stall_gap = jnp.sqrt(tol)

    def inner(t, x):
        def cond(c):
            x, dec, it, stalled, _ = c
            go = jnp.logical_and(dec > tol, it < pars.max_iter)
            return jnp.logical_and(go, jnp.logical_not(stalled))

        def body(c):
            x, _, it, _, hard = c
            x, dec, stalled = newton_step(t, x)
            hard = jnp.logical_or(
                hard, jnp.logical_and(stalled, m / t > hard_stall_gap))
            return x, dec, it + 1, stalled, hard

        big = jnp.asarray(jnp.inf, dtype)
        x, dec, it, _, hard = lax.while_loop(
            cond, body,
            (x, big, jnp.asarray(0), jnp.asarray(False), jnp.asarray(False)))
        return x, it, hard

    def outer_cond(c):
        x, t, it, n_newton, hard = c
        gap = m / (t / pars.mu)
        go = jnp.logical_not(
            jnp.logical_and(gap < pars.tol,
                            jnp.linalg.norm(b - A @ x) < eq_tol))
        go = jnp.logical_and(go, it < pars.outer_max_iter)
        return jnp.logical_and(go, t <= t_max)

    def outer_body(c):
        x, t, it, n_newton, hard = c
        x, inner_it, hard_i = inner(t, x)
        return (x, pars.mu * t, it + 1, n_newton + inner_it,
                jnp.logical_or(hard, hard_i))

    x, t, outer_it, n_newton, hard_stall = lax.while_loop(
        outer_cond, outer_body,
        (x0, jnp.asarray(t0, dtype), jnp.asarray(0), jnp.asarray(0),
         jnp.asarray(False)))

    # exit-state sanity: a poisoned/overflowed instance freezes at a finite
    # iterate but its margins/data are non-finite or clearly violated — flag
    # it (per-instance status instead of exceptions, SURVEY.md section 7.3).
    # Active margins at the final t are ~1/(t*lam) and legitimately round to
    # ~0 through the ub - Ux subtraction, so allow rounding-scale slack.
    d_exit = ub - U @ x
    slack = 100.0 * eps * (1.0 + jnp.abs(ub))
    healthy = jnp.logical_and(
        jnp.all(jnp.isfinite(x)),
        jnp.logical_and(jnp.all(jnp.isfinite(d_exit)),
                        jnp.logical_and(jnp.all(d_exit > -slack),
                                        jnp.all(x > 0))))
    stalled = jnp.logical_or(hard_stall, jnp.logical_not(healthy))

    t_solved = t / pars.mu
    lam = jnp.concatenate([1.0 / (t_solved * d_exit),
                           1.0 / (t_solved * x)])
    nan = jnp.asarray(jnp.nan, dtype)
    return Solution(
        x=x, lam=lam, nu=jnp.full((p,), jnp.nan, dtype),
        newton_decrement=nan,
        # the continuation bound m/t is meaningless for an unhealthy exit
        duality_gap=jnp.where(healthy, m / t_solved, nan),
        eq_gap=jnp.linalg.norm(b - A @ x), norm_grad=nan,
        norm_dual_residual=nan, iters=n_newton,
        maxed_out=outer_it >= pars.outer_max_iter,
        stalled=stalled,
    )
