"""Convex duality: solve the primal through its dual.

Re-design of cvx/Duality.scala (:38-135): given the (concave) dual objective
L*(z) of a problem — z = (lambda, nu) with lambda the inequality duals — the
dual problem is

    min -L*(z)   subject to   lambda = z[:num_ineq] >= 0,

solved with the same interior-point machinery from the strictly feasible
start z0 = dual_start * 1 (Duality.scala:107), after which the primal optimum
is recovered via the problem-specific map x* = primal_optimum(z*)
(Duality.scala:119-133).
"""

from __future__ import annotations

from typing import Any, Callable

import jax
import jax.numpy as jnp

from .problem.constraint_set import ConstraintSet
from .problem.constraints import first_coordinates_positive
from .solvers.barrier import barrier_solve
from .solvers.primal_dual import primal_dual_solve
from .solvers.types import Solution, SolverParams
from .tree import mxu_exact


def _small_solve(A: jax.Array, b: jax.Array) -> jax.Array:
    """Solve a tiny symmetric positive-definite system in closed form.

    dim <= 3 uses the adjugate; dim 4-8 an UNROLLED scalar Cholesky
    (straight-line code, vectorizes cleanly under vmap into elementwise
    ops over the batch); dim > 8 a Cholesky plus triangular solves.
    Callers (the dual Newton systems) are SPD by construction:
    B diag(y) B' + ridge with unit rows for frozen coordinates.
    """
    dim = A.shape[0]
    if dim == 1:
        return b / A[0, 0]
    if dim == 2:
        det = A[0, 0] * A[1, 1] - A[0, 1] * A[1, 0]
        return jnp.stack([
            (A[1, 1] * b[0] - A[0, 1] * b[1]) / det,
            (A[0, 0] * b[1] - A[1, 0] * b[0]) / det,
        ])
    if dim == 3:
        c00 = A[1, 1] * A[2, 2] - A[1, 2] * A[2, 1]
        c01 = A[1, 2] * A[2, 0] - A[1, 0] * A[2, 2]
        c02 = A[1, 0] * A[2, 1] - A[1, 1] * A[2, 0]
        det = A[0, 0] * c00 + A[0, 1] * c01 + A[0, 2] * c02
        c10 = A[0, 2] * A[2, 1] - A[0, 1] * A[2, 2]
        c11 = A[0, 0] * A[2, 2] - A[0, 2] * A[2, 0]
        c12 = A[0, 1] * A[2, 0] - A[0, 0] * A[2, 1]
        c20 = A[0, 1] * A[1, 2] - A[0, 2] * A[1, 1]
        c21 = A[0, 2] * A[1, 0] - A[0, 0] * A[1, 2]
        c22 = A[0, 0] * A[1, 1] - A[0, 1] * A[1, 0]
        return jnp.stack([
            (c00 * b[0] + c10 * b[1] + c20 * b[2]) / det,
            (c01 * b[0] + c11 * b[1] + c21 * b[2]) / det,
            (c02 * b[0] + c12 * b[1] + c22 * b[2]) / det,
        ])
    # floor for pathological (masked-singular) instances (f32's tiny for
    # every dtype: the floor only has to keep garbage steps finite)
    tiny = jnp.asarray(float(jnp.finfo(jnp.float32).tiny), A.dtype)
    if dim <= 8:
        # unrolled Cholesky A = L L' + forward/back substitution; max(.,
        # tiny) keeps garbage steps finite — the callers' line searches
        # reject them
        L = {}
        for j in range(dim):
            d = A[j, j]
            for p in range(j):
                d = d - L[(j, p)] * L[(j, p)]
            L[(j, j)] = jnp.sqrt(jnp.maximum(d, tiny))
            for i in range(j + 1, dim):
                off = A[i, j]
                for p in range(j):
                    off = off - L[(i, p)] * L[(j, p)]
                L[(i, j)] = off / L[(j, j)]
        yv = []
        for i in range(dim):
            s = b[i]
            for p in range(i):
                s = s - L[(i, p)] * yv[p]
            yv.append(s / L[(i, i)])
        x = [None] * dim
        for i in range(dim - 1, -1, -1):
            s = yv[i]
            for p in range(i + 1, dim):
                s = s - L[(p, i)] * x[p]
            x[i] = s / L[(i, i)]
        return jnp.stack(x)
    Lc = jnp.linalg.cholesky(A + tiny * jnp.eye(dim, dtype=A.dtype))
    yv = jax.scipy.linalg.solve_triangular(Lc, b, lower=True)
    return jax.scipy.linalg.solve_triangular(Lc.T, yv, lower=False)


def _polish_dual(obj: Any, z: jax.Array, num_ineq: int,
                 steps: int) -> jax.Array:
    """Active-set projected-Newton polish of the dual optimum.

    The barrier solve stops at duality gap ~ m/t; the PRIMAL recovery
    x = R exp(-B'z) amplifies the remaining dual error by |B'| through the
    exponential — in f32 tail instances lose ~1e-2 of probability mass.
    Moreover the dual value is LINEARLY sensitive to multipliers of
    inactive constraints (d(-L*)/dlam_i = slack_i > 0), so tiny positive
    lam_i on inactive rows cost real gap.

    Per step: multipliers sitting AT the bound with inward gradient are
    frozen (their row/col masked out of the Newton system — a naively
    projected coupled step jams: the clamped coordinate's compensation
    moves the free ones the wrong way); the free-subspace Newton step is
    tried at backtracking fractions PLUS the exact step-to-boundary, and
    the best strictly-decreasing candidate wins.  Monotone (each accepted
    step improves a valid bound), O(dual_dim^3) per step — negligible next
    to the solve."""
    dtype = z.dtype
    dim = z.shape[0]
    mask = (jnp.arange(dim) < num_ineq)
    ts = 0.5 ** jnp.arange(8, dtype=dtype)  # 1, 1/2, ..., 1/128
    eps = jnp.finfo(dtype).eps
    # the gradient-fallback acceptance band must cover the VALUE's
    # evaluation error (32 eps), or near-optimal steps get
    # deterministically rejected
    band_eps = 32.0 * eps
    eye = jnp.eye(dim, dtype=dtype)

    def project(z_):
        return jnp.where(mask, jnp.maximum(z_, 0.0), z_)

    def step(_, z):
        # PRE-snap: a lam that is positive but below rounding resolution
        # (e.g. the O(eps) residue of a least-squares init's clamp) fails
        # the z <= 0 freeze test while its large inward gradient poisons
        # the coupled Newton direction — every candidate then increases
        # the value and the polish jams at the start.  Anything within
        # rounding of 0 must BE 0 so the active-set mask can freeze it.
        z = jnp.where(
            jnp.logical_and(mask,
                            z <= 64.0 * eps * (1.0 + jnp.max(jnp.abs(z)))),
            0.0, z)
        f0 = obj.value(z)
        g = obj.grad(z)
        H = obj.hess(z)
        at_bound = jnp.logical_and(mask,
                                   jnp.logical_and(z <= 0.0, g > 0.0))
        free = jnp.logical_not(at_bound)
        freef = free.astype(dtype)
        gf = jnp.where(free, g, 0.0)
        Hf = H * (freef[:, None] * freef[None, :]) + jnp.diag(1.0 - freef)
        Hf = Hf + (10.0 * eps * jnp.mean(jnp.abs(jnp.diag(Hf)))) * eye
        d = -_small_solve(Hf, gf)
        # a lam ALREADY at its bound cannot move down: the mask above
        # freezes it when g > 0; this catches the coupled g < 0, d < 0 case,
        # whose projected steps are no descent direction (the same guard as
        # the fused kernel and _kl_warm_polish)
        d = jnp.where(jnp.logical_and(mask, jnp.logical_and(z <= 0.0,
                                                            d < 0.0)),
                      0.0, d)
        # far-field trust cap (the fused kernel's): from a COLD start the
        # exp-linear dual is locally near-linear, the Newton step is
        # O(grad/hess) = O(100+) at n >= 1000, and every backtracking
        # fraction of it overshoots, so the iterate crawls.  Capping the
        # step at 8 per coordinate gives log-scale progress instead; near
        # the optimum the cap is inactive
        l_trust = jnp.asarray(8.0, dtype)
        d = d * (l_trust / jnp.maximum(jnp.max(jnp.abs(d)), l_trust))
        # exact step to the first lam_i >= 0 boundary crossed (the next
        # iteration freezes it and Newton continues in the rest)
        neg = jnp.logical_and(mask, d < 0)
        t_bd = jnp.min(jnp.where(neg, -z / jnp.where(neg, d, -1.0), jnp.inf))
        cand = jnp.concatenate([ts, jnp.clip(t_bd, 0.0, 1.0)[None]])

        def proj_grad_norm(zt, gt):
            # bound-active coordinates (lam at 0 wanting to decrease) are
            # OPTIMAL, not violations — measure only the free components
            at_b = jnp.logical_and(mask,
                                   jnp.logical_and(zt <= 0.0, gt > 0.0))
            return jnp.linalg.norm(jnp.where(at_b, 0.0, gt))

        def trial(t):
            zt = project(z + t * d)
            ft = obj.value(zt)
            gnt = proj_grad_norm(zt, obj.grad(zt))
            bad = jnp.logical_not(jnp.isfinite(ft))
            return (jnp.where(bad, jnp.inf, ft), jnp.where(bad, jnp.inf, gnt))

        fs, gns = jax.vmap(trial)(cand)
        dir_ok = jnp.all(jnp.isfinite(d))
        # primary acceptance: value decrease.  Near the optimum the value
        # comparison drowns in eps*|f| rounding noise while the GRADIENT is
        # computed directly (w - B y, no cancellation of near-equal large
        # values) — so when no candidate decreases the value, accept a
        # strict projected-gradient-norm decrease instead.  This pushes the
        # dual to grad ~ eps resolution instead of sqrt(eps) (the f32 gap
        # floor drops by ~100x).
        bf = jnp.argmin(fs)
        f_ok = jnp.logical_and(fs[bf] < f0, dir_ok)
        gn0 = jnp.linalg.norm(gf)
        bg = jnp.argmin(gns)
        # the gradient fallback must not WEAKEN the bound: only accept a
        # grad-norm decrease whose value change is within rounding noise of
        # f0 (it exists to escape the value-resolution floor, not to trade
        # value for gradient far from the optimum)
        noise = band_eps * (1.0 + jnp.abs(f0))
        g_ok = jnp.logical_and(
            jnp.logical_and(gns[bg] < 0.9 * gn0, fs[bg] <= f0 + noise),
            dir_ok)
        t_take = jnp.where(f_ok, cand[bf], cand[bg])
        take = jnp.logical_or(f_ok, g_ok)
        z_out = jnp.where(take, project(z + t_take * d), z)
        # SNAP to the bound: the exact step-to-boundary leaves an O(eps*z)
        # positive residual in the landing coordinate, which then never
        # freezes — the next direction re-crashes into the boundary and the
        # coupled step jams.  The landing residual is <= ~4 eps |z| (one
        # divide + one multiply-add), so 8 eps |z| catches it while leaving
        # a DELIBERATELY computed small positive lam (an interior minimum
        # near the bound, resolvable above rounding) alone.
        snap = 8.0 * eps * jnp.abs(z)
        z_out = jnp.where(jnp.logical_and(mask, z_out <= snap), 0.0, z_out)
        return z_out

    return jax.lax.fori_loop(0, steps, step, z)


@mxu_exact
def solve_dual(
    neg_dual_objective: Any,
    num_ineq: int,
    dual_dim: int,
    primal_optimum: Callable[[jax.Array], jax.Array],
    *,
    method: str = "BR",
    pars: SolverParams | None = None,
    polish_steps: int = 3,
) -> Solution:
    """Solve min -L*(z) s.t. z[:num_ineq] >= 0; map back to the primal.

    ``neg_dual_objective`` exposes value/grad/hess of -L* (already negated,
    i.e. convex).  Returns a Solution whose ``x`` is the PRIMAL optimum and
    whose ``lam``/``nu`` are the dual optimum split as in Duality.scala:128-132.
    """
    pars = pars or SolverParams()
    # dtype follows the dual objective's DATA (f32 problems keep the f32
    # fast path even under jax_enable_x64, where a canonical-float default
    # would silently promote the whole dual solve to f64)
    leaves = jax.tree_util.tree_leaves(neg_dual_objective)
    dtype = jnp.result_type(*leaves) if leaves else jnp.result_type(float)
    z0 = jnp.full((dual_dim,), pars.dual_start, dtype)

    if num_ineq > 0:
        cnts = ConstraintSet(
            blocks=(first_coordinates_positive(dual_dim, num_ineq,
                                               dtype=dtype),)
        )
        if method == "BR":
            sol = barrier_solve(neg_dual_objective, cnts, z0, pars)
        elif method == "PD":
            sol = primal_dual_solve(neg_dual_objective, cnts, z0, pars)
        else:
            raise ValueError(f"unknown solver method: {method!r}")
    else:
        # no inequality duals: unconstrained dual
        from .solvers.newton import newton_minimize

        def fgh(z):
            return (neg_dual_objective.value(z),
                    neg_dual_objective.grad(z),
                    neg_dual_objective.hess(z))

        res = newton_minimize(fgh, lambda z: jnp.asarray(True), z0, pars)
        nan = jnp.asarray(jnp.nan, dtype)
        sol = Solution(x=res.x, lam=jnp.zeros((0,), dtype),
                       nu=jnp.zeros((0,), dtype), newton_decrement=nan,
                       duality_gap=nan, eq_gap=nan, norm_grad=res.norm_grad,
                       norm_dual_residual=nan, iters=res.iters,
                       maxed_out=res.maxed_out, stalled=res.stalled)

    z = sol.x
    if polish_steps > 0:
        # f32 repair (and free f64 sharpening): see _polish_dual
        z = _polish_dual(neg_dual_objective, z, num_ineq, polish_steps)
    from .tree import replace

    # refresh the gradient diagnostic for the POLISHED point.  duality_gap
    # keeps the dual barrier's m/t bound: the polish only improves z, so
    # the bound stays valid (conservative); problem-specific callers with a
    # closed-form primal objective report measured certificates instead
    # (e.g. DistKL.solve_dual_newton).
    g_pol = neg_dual_objective.grad(z)
    at_b = jnp.logical_and(jnp.arange(z.shape[0]) < num_ineq,
                           jnp.logical_and(z <= 0.0, g_pol > 0.0))
    return replace(
        sol,
        x=primal_optimum(z),
        lam=z[:num_ineq],
        nu=z[num_ineq:],
        norm_grad=jnp.linalg.norm(jnp.where(at_b, 0.0, g_pol)),
    )
