"""Phase-I feasibility analysis.

Re-design of the reference's phase-I subsystem
(cvx/ConstraintSet.scala:123-575): find a strictly feasible point of
``g_i(x) <= u_i`` (optionally with ``A x = b``), or certify infeasibility.

Three analyses, as in the reference:

  * simple (no equalities): lift to (x, s), minimize s until s < 0
    (ConstraintSet.scala:355-395, [boyd] 11.4.1);
  * with equalities: either convert A x = b to +/- inequalities with a small
    tolerance and recurse (ConstraintSet.scala:326-347, the reference's
    default), or ELIMINATE the equalities via x = z0 + F u and run the
    no-equality analysis in u (ConstraintSet.scala:424-477,
    ``phase_I_Analysis_by_reduction``) — the reduction is this framework's
    default: it is exact (no tolerance hack), lowers the dimension, and jits
    cleanly;
  * sum-of-infeasibilities (SOI): one slack per constraint
    (ConstraintSet.scala:511-545) — localizes which constraints are
    infeasible.

All analyses are jittable and return a ``FeasibilityReport`` pytree (no
exceptions — SURVEY.md section 7.3).  The host-side ``find_feasible_point``
raises ``InfeasibleProblemError`` like the reference's
``ConstraintSet.withFeasiblePoint`` (ConstraintSet.scala:556-575).
"""

from __future__ import annotations

import jax
from jax import lax
import jax.numpy as jnp

from ..ops.cholesky import default_delta
from ..problem.constraint_set import ConstraintSet
from ..problem.equality import EqualityConstraint
from ..problem.objective import LinearObjective
from ..tree import mxu_exact, pytree_dataclass, replace as tree_replace
from .barrier import barrier_solve
from .types import SolverParams, phase1_criterion


class InfeasibleProblemError(Exception):
    """Raised by find_feasible_point when phase-I certifies infeasibility
    (cvx/InfeasibleProblemException.scala)."""

    def __init__(self, report, violations=None):
        self.report = report
        self.violations = violations or []
        listing = ""
        if self.violations:
            rows = ", ".join(f"{name} (violation {v:+.3e})"
                             for name, _, v in self.violations[:10])
            more = (f", ... ({len(self.violations) - 10} more)"
                    if len(self.violations) > 10 else "")
            listing = f"; violated: {rows}{more}"
        super().__init__(
            f"problem infeasible: max slack {report.s_max}, "
            f"equality error {report.eq_error}{listing}"
        )


def violated_constraints(cnts: ConstraintSet, x, tol: float = 0.0):
    """Host-side listing of the constraints violated at ``x``
    (FeasibilityReport.scala:32-47): ``[(name, global_index, violation)]``
    with ``violation = g_i(x) - ub_i > tol``, sorted worst first.

    ``name`` is ``label[i]`` from the owning block (factories set labels:
    "positivity", "rows_leq", ...; pass ``label=`` for custom names)."""
    import numpy as np

    out = []
    off = 0
    for b in cnts.blocks:
        r = np.asarray(b.value(x) - b.ub)
        for i in np.where(r > tol)[0]:
            name = f"{b.label or type(b).__name__}[{int(i)}]"
            out.append((name, off + int(i), float(r[i])))
        off += b.m
    return sorted(out, key=lambda t: -t[2])


@pytree_dataclass
class FeasibilityReport:
    """Result of a phase-I analysis (cvx/FeasibilityReport.scala)."""

    x: jax.Array               # feasibility candidate
    s_max: jax.Array           # max slack (< 0 => strictly feasible)
    slacks: jax.Array          # per-constraint slack (SOI) or (1,) scalar
    strictly_feasible: jax.Array  # bool
    eq_error: jax.Array        # ||A x - b|| at the candidate

    def is_feasible(self, tol: float) -> jax.Array:
        """Feasible up to tolerance (FeasibilityReport.scala:35-36)."""
        return jnp.logical_and(self.s_max < tol, self.eq_error < tol)

    def violations(self, cnts: ConstraintSet, tol: float = 0.0):
        """Violated-constraint listing at the phase-I candidate
        (FeasibilityReport.scala:32-47) — host-side."""
        return violated_constraints(cnts, self.x, tol)


def _eq_tol(pars: SolverParams, dtype):
    """Dtype-aware equality tolerance: ||Ax-b|| floors at ~eps * scale, so
    the f32 path cannot certify 1e-8 (same rationale as barrier_solve)."""
    return jnp.maximum(jnp.asarray(pars.tol, dtype),
                       100.0 * jnp.finfo(dtype).eps)


def _slack_objective(n: int, dtype) -> LinearObjective:
    """f(x, s) = s (ConstraintSet.scala:131-144)."""
    a = jnp.zeros((n + 1,), dtype).at[n].set(1.0)
    return LinearObjective(a=a, r=jnp.zeros((), dtype))


@mxu_exact
def _phase1_linear_structured(
    cnts: ConstraintSet,
    x0: jax.Array,
    pars: SolverParams,
) -> FeasibilityReport:
    """Phase-I for ALL-LINEAR constraint sets via exact low-rank Newton.

    The phase-I barrier Hessian is J^T diag(1/d^2) J with J = [G, -1] — rank
    at most m, usually << dim + 1.  Generic dense solvers then move only in
    range(J^T) (spectral pseudo-inverse) or crawl along null directions with
    roundoff-scale steps (shifted Cholesky in f32): BOTH fail to ride the
    unbounded descent direction that makes s -> -infinity once the problem
    is strictly feasible.  Here the Jacobi-regularized system

        (eps * diag(J^T W J) + J^T W J) dz = -g

    is solved EXACTLY by the Woodbury identity, so the null-space gradient
    motion is well-scaled and phase-I terminates in a handful of steps.
    """
    n = cnts.dim
    dtype = x0.dtype
    G = jnp.concatenate([b.G for b in cnts.blocks], axis=0)
    c0 = jnp.concatenate([b.c for b in cnts.blocks])
    ub = jnp.concatenate([b.ub for b in cnts.blocks])
    m = G.shape[0]
    J = jnp.concatenate([G, -jnp.ones((m, 1), dtype)], axis=1)  # (m, n+1)
    z0 = cnts.phase1_feasible_point(x0)
    eps = jnp.asarray(1e-6 if jnp.finfo(dtype).bits >= 64 else 1e-4, dtype)
    tol_feas = pars.tol_feas
    kk = jnp.arange(pars.ls_max_steps)
    expo = jnp.where(kk < 32, kk, 32 + 3 * (kk - 32)).astype(dtype)
    ls_ts = pars.beta ** expo

    def margins(z):
        return ub - c0 - J @ z

    def newton_step(t, z):
        d = margins(z)
        inv_d = 1.0 / d
        w = inv_d * inv_d
        g = jnp.zeros((n + 1,), dtype).at[n].set(t) + J.T @ inv_d
        # Jacobi floor + exact Woodbury solve of (diag(h) + J^T W J)
        h = eps * jnp.einsum("mi,m->i", J * J, w) + jnp.finfo(dtype).tiny
        inv_h = 1.0 / h
        JD = J * inv_h[None, :]
        M = jnp.diag(1.0 / w) + JD @ J.T
        M = M + default_delta(dtype) * \
            jnp.mean(jnp.abs(jnp.diag(M))) * jnp.eye(m, dtype=dtype)
        L = jnp.linalg.cholesky(M)
        y = jax.scipy.linalg.cho_solve((L, True), JD @ g)
        dz = -(inv_h * g - JD.T @ y)
        # cap the slack decrease per step: the phase-I objective is
        # unbounded below once feasible, and a huge step along the descent
        # ray amplifies roundoff in downstream affine pullbacks; s < -1 is
        # already certified-strictly-feasible with margin
        cap = jnp.where(dz[n] < 0,
                        jnp.minimum(1.0, (jnp.abs(z[n]) + 1.0) /
                                    jnp.maximum(-dz[n], 1e-30)),
                        1.0)
        dz = cap * dz

        q = dz @ g
        f0 = t * z[n] - jnp.sum(jnp.log(d))
        Jdz = J @ dz

        def accept(s):
            ds = d - s * Jdz
            ok = jnp.all(ds > 0)
            fs = t * (z[n] + s * dz[n]) - jnp.sum(
                jnp.log(jnp.where(ds > 0, ds, 1.0)))
            return jnp.logical_and(ok, fs <= f0 + pars.alpha * s * q)

        acc = jax.vmap(accept)(ls_ts)
        # true select + finiteness guard (0 * NaN would poison a frozen
        # iterate when the factorization overflowed)
        take = jnp.logical_and(jnp.any(acc), jnp.all(jnp.isfinite(dz)))
        s = jnp.where(take, ls_ts[jnp.argmax(acc)], 0.0)
        dec = -q / 2.0
        return jnp.where(take, z + s * dz, z), dec, jnp.logical_not(take)

    tol = jnp.maximum(jnp.asarray(pars.tol, dtype),
                      50.0 * jnp.finfo(dtype).eps)
    # cap t: once the duality gap m/t certifies s* within tol of its limit,
    # further continuation only risks overflow (infeasible problems have
    # s* > 0 and never hit the s < 0 exit)
    t_max = 10.0 * pars.mu * m / pars.tol

    def inner(t, z):
        def cond(c):
            z, dec, it, stalled = c
            go = jnp.logical_and(it < pars.max_iter, z[n] > -tol_feas)
            go = jnp.logical_and(go, dec > tol)
            return jnp.logical_and(go, jnp.logical_not(stalled))

        def body(c):
            z, _, it, _ = c
            z, dec, stalled = newton_step(t, z)
            return z, dec, it + 1, stalled

        big = jnp.asarray(jnp.inf, dtype)
        z, dec, it, _ = lax.while_loop(
            cond, body, (z, big, jnp.asarray(0), jnp.asarray(False)))
        return z, it

    def outer_cond(c):
        z, t, it = c
        go = jnp.logical_and(z[n] > -tol_feas, it < pars.outer_max_iter)
        return jnp.logical_and(go, t <= t_max)

    def outer_body(c):
        z, t, it = c
        z, _ = inner(t, z)
        return z, pars.mu * t, it + 1

    z, t, _ = lax.while_loop(outer_cond, outer_body,
                             (z0, jnp.asarray(1.0, dtype), jnp.asarray(0)))
    x = z[:n]
    s = z[n]
    return FeasibilityReport(
        x=x, s_max=s, slacks=s[None],
        strictly_feasible=cnts.satisfied_strictly(x),
        eq_error=jnp.zeros((), dtype),
    )


def phase1_simple(
    cnts: ConstraintSet,
    x0: jax.Array,
    pars: SolverParams | None = None,
    early_exit: bool = True,
) -> FeasibilityReport:
    """Basic phase-I without equalities: minimize the shared slack s.

    ``early_exit`` terminates the inner Newton solves as soon as s < 0
    (a strictly feasible point exists; the reference only exits at the outer
    level, ConstraintSet.scala:371-374).  Set False to center the point more.

    All-linear constraint sets dispatch to the exact low-rank structured
    solver (see _phase1_linear_structured); sets with quadratic/nonlinear
    blocks use the generic barrier machinery.
    """
    pars = pars or SolverParams()
    from ..problem.constraints import LinearBlock

    if all(isinstance(b, LinearBlock) for b in cnts.blocks):
        return _phase1_linear_structured(cnts, x0, pars)
    pars = tree_replace(pars, kkt_method=pars.phase1_kkt_method)
    n = cnts.dim
    lifted = cnts.lift_phase1()
    xs0 = cnts.phase1_feasible_point(x0)
    obj = _slack_objective(n, x0.dtype)

    stop_inner = (lambda xs: xs[n] < -pars.tol_feas) if early_exit else None
    sol = barrier_solve(obj, lifted, xs0, pars,
                        criterion=phase1_criterion(pars),
                        stop_inner=stop_inner)
    x = sol.x[:n]
    s = sol.x[n]
    strictly = cnts.satisfied_strictly(x)
    return FeasibilityReport(
        x=x, s_max=s, slacks=s[None],
        strictly_feasible=strictly,
        eq_error=jnp.zeros((), x.dtype),
    )


def phase1_with_eqs_as_ineqs(
    cnts: ConstraintSet,
    eqs: EqualityConstraint,
    x0: jax.Array,
    pars: SolverParams | None = None,
) -> FeasibilityReport:
    """Equalities as +/- inequalities with tolerance, then simple analysis
    (ConstraintSet.scala:326-347, tol = pars.phase1_eq_tol)."""
    pars = pars or SolverParams()
    ext = cnts.add_blocks(eqs.as_inequalities(pars.phase1_eq_tol))
    rep = phase1_simple(ext, x0, pars)
    eq_err = eqs.error(rep.x)
    return FeasibilityReport(
        x=rep.x, s_max=rep.s_max, slacks=rep.slacks,
        strictly_feasible=jnp.logical_and(
            cnts.satisfied_strictly(rep.x), eq_err < _eq_tol(pars, rep.x.dtype)
        ),
        eq_error=eq_err,
    )


def phase1_by_reduction(
    cnts: ConstraintSet,
    eqs: EqualityConstraint,
    x0: jax.Array,
    pars: SolverParams | None = None,
) -> FeasibilityReport:
    """Eliminate A x = b via x = z0 + F u, analyze in u
    (ConstraintSet.scala:424-477).  Exact: the candidate satisfies the
    equalities to solver precision by construction."""
    pars = pars or SolverParams()
    ss = eqs.solution_space()
    cnts_u = cnts.affine_pullback(ss.z0, ss.F)
    u0 = ss.parameter(x0)
    rep_u = phase1_simple(cnts_u, u0, pars)
    x = ss.point(rep_u.x)
    eq_err = eqs.error(x)
    return FeasibilityReport(
        x=x, s_max=rep_u.s_max, slacks=rep_u.slacks,
        strictly_feasible=jnp.logical_and(
            cnts.satisfied_strictly(x), eq_err < _eq_tol(pars, x.dtype)
        ),
        eq_error=eq_err,
    )


def phase1_soi(
    cnts: ConstraintSet,
    x0: jax.Array,
    pars: SolverParams | None = None,
    eqs: EqualityConstraint | None = None,
) -> FeasibilityReport:
    """Sum-of-infeasibilities analysis: minimize sum_i s_i with one slack per
    constraint (ConstraintSet.scala:511-545).  When infeasible, the slack
    vector localizes the violated constraints."""
    pars = pars or SolverParams()
    n = cnts.dim
    p = cnts.m
    lifted = cnts.lift_soi()
    xs0 = cnts.soi_feasible_point(x0)
    dtype = x0.dtype
    a = jnp.concatenate([jnp.zeros((n,), dtype), jnp.ones((p,), dtype)])
    obj = LinearObjective(a=a, r=jnp.zeros((), dtype))
    eqs_l = eqs.lift_phase1(extra=p) if eqs is not None else None
    sol = barrier_solve(obj, lifted, xs0, pars, eqs=eqs_l)
    x = sol.x[:n]
    s = sol.x[n:]
    eq_err = eqs.error(x) if eqs is not None else jnp.zeros((), dtype)
    return FeasibilityReport(
        x=x, s_max=jnp.max(s), slacks=s,
        strictly_feasible=jnp.logical_and(
            cnts.satisfied_strictly(x), eq_err < _eq_tol(pars, x.dtype)
        ),
        eq_error=eq_err,
    )


def feasibility_analysis(
    cnts: ConstraintSet,
    x0: jax.Array,
    pars: SolverParams | None = None,
    eqs: EqualityConstraint | None = None,
    method: str = "auto",
) -> FeasibilityReport:
    """Dispatch like ConstraintSet.phase_I_Analysis (:404-413).

    method: "auto" (reduction when equalities present, else simple),
    "simple", "eqs_as_ineqs", "reduction", "soi".
    """
    pars = pars or SolverParams()
    if method == "soi":
        return phase1_soi(cnts, x0, pars, eqs)
    if eqs is None:
        return phase1_simple(cnts, x0, pars)
    if method in ("auto", "reduction"):
        return phase1_by_reduction(cnts, eqs, x0, pars)
    if method in ("simple", "eqs_as_ineqs"):
        return phase1_with_eqs_as_ineqs(cnts, eqs, x0, pars)
    raise ValueError(f"unknown phase-I method: {method!r}")


def find_feasible_point(
    cnts: ConstraintSet,
    x0: jax.Array,
    pars: SolverParams | None = None,
    eqs: EqualityConstraint | None = None,
    method: str = "auto",
) -> jax.Array:
    """Host-side gate: return a strictly feasible point or raise
    InfeasibleProblemError (ConstraintSet.scala:556-575)."""
    pars = pars or SolverParams()
    report = feasibility_analysis(cnts, x0, pars, eqs, method)
    if not bool(report.is_feasible(float(_eq_tol(pars, report.x.dtype)))):
        raise InfeasibleProblemError(
            report, violations=violated_constraints(cnts, report.x))
    return report.x
