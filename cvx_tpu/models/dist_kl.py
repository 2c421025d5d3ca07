"""Kullback–Leibler distance minimization over discrete distributions.

A re-design of cvx/Dist_KL.scala for batched accelerators — the reference's flagship
application (README.md:7-8):

    Q* = argmin_Q  d_KL(Q, P)   s.t.   H Q <= u,   A Q = r,

with d_KL(Q,P) = sum_j q_j (log q_j - log p_j).  The reference supports
ONLY the uniform prior P = 1/n (Dist_KL.scala:218,259 — then
d_KL = x . log(n x)); this implementation additionally accepts a general
strictly positive prior (``DistKL.create(..., prior=p)``) on every route —
the dual closed forms only change through R = p/e, and the primal Hessian
diag(1/x) is prior-independent.

Both routes of the reference are provided:

  * PRIMAL: objective x.log(nx) with gradient 1 + log(nx) and exact diagonal
    Hessian 1/x (Dist_KL.scala:223-239); constraints = rows of H, positivity;
    equalities = [1'; A] x = [1; r] (the probability constraint is always
    appended, Dist_KL.scala:296-297); phase-I runs at construction
    (Dist_KL.scala:307) and the barrier or primal-dual solver finishes.
  * DUAL (the preferred route — its dimension is mI + mE + 1 << n,
    Dist_KL.scala:59-65): closed forms from docs/maxent.pdf
        -L*(z) = w.z + R.exp(-B' z),        R = 1/(n e),  B = [H; 1'; A],
        grad   = w - B (R * exp(-B' z)),
        hess   = B diag(R * exp(-B' z)) B',
    primal recovery Q(z) = R * exp(-B' z)  (Dist_KL.scala:146-171).

Everything is a pytree over (H, u, A, r): one ``jit(vmap(...))`` solves
thousands of scenario instances per device (the north-star batch workload).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .. import backend
from ..duality import solve_dual
from ..problem.constraint_set import ConstraintSet
from ..problem.constraints import positivity, rows_leq
from ..problem.equality import EqualityConstraint, sum_to_one

from ..solvers.barrier import barrier_solve
from ..solvers.phase1 import feasibility_analysis, find_feasible_point
from ..solvers.primal_dual import primal_dual_solve
from ..solvers.types import Solution, SolverParams
from ..tree import mxu_exact, pytree_dataclass, static_field


@pytree_dataclass
class KLObjective:
    """d_KL(x, p) = x . (log x - log p); grad 1 + log x - log p;
    hess diag(1/x) (Dist_KL.scala:223-239).  ``log_prior`` None means the
    reference's uniform prior p = 1/n (its Dist_KL supports ONLY that,
    Dist_KL.scala:218); a general (n,) log-prior is a capability beyond
    the reference — the Hessian, and hence every solver code path, is
    prior-independent."""

    n: int = static_field()
    log_prior: jax.Array | None = None

    def _logp(self, x):
        if self.log_prior is None:
            return -jnp.log(jnp.asarray(float(self.n), x.dtype))
        return self.log_prior.astype(x.dtype)

    def value(self, x):
        return jnp.einsum("n,n->", x, jnp.log(x) - self._logp(x),
                          precision="highest")

    def grad(self, x):
        return 1.0 + jnp.log(x) - self._logp(x)

    def hess(self, x):
        return jnp.diag(1.0 / x)

    def hess_diag(self, x):
        return 1.0 / x


@pytree_dataclass
class _NegDualObjective:
    """-L*(z) = w.z + R.exp(-B'z) (convex), docs/maxent.pdf eq.(20)-(22).

    All contractions run at Precision.HIGHEST: a reduced-precision f32
    matmul (TF32 on the GPU, ~1e-3 relative) poisons the tiny (dim ~ 3)
    dual Newton systems — gradients stall at ~1e-3 and the recovered
    primal violates its constraints.  These are O(n * dim) matvecs, so
    full precision costs nothing.
    """

    B: jax.Array   # (mI + 1 + mE, n)
    w: jax.Array   # (mI + 1 + mE,)
    R: jax.Array   # (n,)

    def _y(self, z):
        Btz = jnp.einsum("in,i->n", self.B, z, precision="highest")
        return self.R * jnp.exp(-Btz)

    def value(self, z):
        return (jnp.einsum("i,i->", self.w, z, precision="highest")
                + jnp.sum(self._y(z)))

    def grad(self, z):
        return self.w - jnp.einsum("in,n->i", self.B, self._y(z),
                                   precision="highest")

    def hess(self, z):
        y = self._y(z)
        return jnp.einsum("in,n,jn->ij", self.B, y, self.B,
                          precision="highest")


def _prior_terms(prior, n, dtype):
    """(log p, R = p/e) for an optional shared prior (None = the
    reference's uniform).  The ONE place the conversion lives — the dual
    certificate, the finishing pass and the model's R must stay in exact
    agreement or the routes silently diverge."""
    if prior is None:
        return (-jnp.log(jnp.asarray(float(n), dtype)),
                jnp.full((n,), 1.0 / (n * np.e), dtype))
    p = jnp.asarray(prior, dtype)
    return jnp.log(p), p / np.e


@mxu_exact
def kl_dual_gap(H, u, A, b, x, polish_steps: int = 8, prior=None):
    """MEASURED duality-gap certificate for the KL problem at iterate ``x``.

    ``H`` (k, n) / ``u`` (k,) are the scenario inequality rows; ``A`` (p, n) /
    ``b`` (p,) the FULL equality system (sum-to-one row included).

    For ANY lam >= 0 and ANY nu the KL dual function has the closed form
    (Dist_KL.scala:146-165, docs/maxent.pdf)

        g(lam, nu) = -(w.z + sum_j R_j exp(-(B'z)_j)),   B = [H; A],
        w = (u, b),  R = 1/(n e),  z = (lam, nu),

    a TRUE lower bound on the primal optimum — so f(x) - g(z) is an honest
    certificate, unlike the central-path bound m/t which holds only at the
    exact central point.  The bound is LINEARLY sensitive to multipliers on
    inactive constraints (dg/dlam_i = -slack_i), so after a least-squares
    fit of the stationarity residual log(n x) + 1 + B'z = 0 the dual point
    is sharpened by a few projected-Newton steps on -g itself (monotone:
    each step can only improve a valid bound).  Returns ``(gap, z)``.
    O(n (k+p)^2 * polish_steps) per instance; jittable and vmappable.
    """
    from ..duality import _polish_dual, _small_solve

    n = x.shape[0]
    dtype = x.dtype
    # clamp coordinates that underflowed to exactly 0: log(0) = -inf would
    # poison the fit; x log(n x) -> 0 as x -> 0+, so f changes negligibly
    x = jnp.maximum(x, jnp.asarray(1e-30, dtype))
    k = H.shape[0]
    B = jnp.concatenate([H, A], axis=0)          # (k+p, n)
    w = jnp.concatenate([u, b])
    # general prior p (beyond the uniform-only reference): R = p/e and the
    # stationarity/objective terms swap log(n x) for log x - log p
    logp, R = _prior_terms(prior, n, dtype)
    dim = B.shape[0]
    mask = jnp.arange(dim) < k

    # init: least-squares fit of B'z = -(1 + log x - log p), lam >= 0
    c = -(1.0 + jnp.log(x) - logp)
    BBt = jnp.einsum("in,jn->ij", B, B, precision="highest")
    BBt = BBt + (10 * jnp.finfo(dtype).eps
                 * jnp.mean(jnp.abs(jnp.diag(BBt)))
                 * jnp.eye(dim, dtype=dtype))
    # closed-form/unrolled small solve of the (dim, dim) system
    z = _small_solve(BBt, jnp.einsum("in,n->i", B, c,
                                     precision="highest"))
    z = jnp.where(mask, jnp.maximum(z, 0.0), z)

    neg_dual = _NegDualObjective(B=B, w=w, R=R)
    z = _polish_dual(neg_dual, z, num_ineq=k, steps=polish_steps)
    dual_val = -neg_dual.value(z)
    primal_val = jnp.einsum("n,n->", x, jnp.log(x) - logp,
                            precision="highest")
    return primal_val - dual_val, z


def _kl_warm_polish(B, w, R, z, k, steps: int):
    """Lean fixed-count projected-Newton polish of the KL dual from a WARM
    start whose active set is already settled (the f32 kernel's final z).

    No value-based line search: a full Newton step capped at the first
    lam boundary (fraction-to-boundary), bound-active coordinates frozen
    out of the tiny (dim <= 16) system — the same active-set algebra as
    the Pallas kernel (ops/pallas_kl_dual.py), in XLA f64.  From a
    ~1e-6-accurate start the iteration is inside the quadratic-convergence
    basin, so each step costs ONE (n,)-exp + a handful of O(n dim)
    contractions; the line-searched ``duality._polish_dual`` step costs
    ~25 exps.  Monotonicity is not enforced —
    the caller measures the final gap and keeps the better of
    {refined, input}, so a (never observed) bad step cannot corrupt the
    certificate, only weaken it.
    """
    from ..duality import _small_solve

    dim = B.shape[0]
    dtype = z.dtype
    eps = jnp.finfo(dtype).eps
    ineq = jnp.arange(dim) < k
    # host-computed clip bound for exp(-B'z) in the working dtype
    max_e = jnp.asarray(0.9 * float(np.log(np.finfo(np.float64).max)
                                    if dtype == jnp.float64
                                    else np.log(np.finfo(np.float32).max)),
                        dtype)

    def step(z, _):
        Btz = jnp.einsum("in,i->n", B, z, precision="highest")
        y = R * jnp.exp(jnp.clip(-Btz, -max_e, max_e))
        g = w - jnp.einsum("in,n->i", B, y, precision="highest")
        at_bound = jnp.logical_and(ineq,
                                   jnp.logical_and(z <= 0.0, g > 0.0))
        free = jnp.where(at_bound, 0.0, 1.0).astype(dtype)
        Hm = jnp.einsum("in,n,jn->ij", B, y, B, precision="highest")
        Hm = Hm * (free[:, None] * free[None, :]) + jnp.diag(1.0 - free)
        # 1e-13 relative ridge: keeps the Cholesky of a near-degenerate
        # active-set Hessian stable without limiting the 1e-8 contract
        Hm = Hm + 1e-13 * jnp.diag(jnp.diag(Hm))
        dz = _small_solve(Hm, -(g * free))
        # a lam already AT its bound cannot move down (the mask catches
        # g > 0; this catches the coupled g < 0, dz < 0 case)
        dz = jnp.where(jnp.logical_and(ineq, jnp.logical_and(z <= 0.0,
                                                             dz < 0.0)),
                       0.0, dz)
        hit = jnp.logical_and(ineq, dz < 0.0)
        t_bd = jnp.min(jnp.where(hit, -z / jnp.where(hit, dz, -1.0),
                                 jnp.inf))
        t = jnp.minimum(jnp.asarray(1.0, dtype), t_bd)
        z_new = z + t * dz
        z_new = jnp.where(ineq, jnp.maximum(z_new, 0.0), z_new)
        # snap boundary landings (O(eps |z|) residue) to exactly 0 so the
        # coordinate freezes next step instead of jamming t_bd at ~0
        z_new = jnp.where(jnp.logical_and(
            ineq, z_new <= 8.0 * eps * jnp.abs(z)), 0.0, z_new)
        # defensive: a non-finite step (divergent dual of an INFEASIBLE
        # instance) OR an ABSURD one (a broken — e.g. singular
        # anti-parallel-rows — free-set Hessian emits ||dz|| ~ 1e7; there
        # is no line search here, while rough-but-sane warm starts move
        # O(1)) keeps the previous iterate — the measured gap is then
        # honest at the input point and the stall flags fire
        ok = jnp.logical_and(jnp.all(jnp.isfinite(z_new)),
                             jnp.max(jnp.abs(dz)) <= 1e3)
        z_new = jnp.where(ok, z_new, z)
        return z_new, None

    z, _ = jax.lax.scan(step, z, None, length=steps)
    return z


@pytree_dataclass
class KLCertificate:
    """F64-certified refinement of a KL iterate (see ``kl_certify``)."""

    x: jax.Array          # refined primal (f64)
    gap: jax.Array        # MEASURED f(x) - g(z) in f64 (true bound)
    ineq_res: jax.Array   # max(Hx - u, -x)_+ — inequality violation
    eq_res: jax.Array     # max |Ax - b| over the FULL equality system
    lam: jax.Array        # polished inequality duals (f64)
    nu: jax.Array         # polished equality duals (f64)


def kl_certify(H, u, A, b, x, polish_steps: int = 6, z0=None, prior=None,
               compare_input: bool = True):
    """F64 finishing pass: refine a KL iterate to the reference's WRITTEN
    1e-8 duality-gap contract and certify it with measured residuals.

    The reference's whole accuracy story is f64 with gap < tolSolver = 1e-8
    (SolverParams.scala:41, BarrierSolver.scala:102).  The f32 routes
    floor at a ~1e-6 measured gap (f32 value-resolution limit); this pass
    lifts the data and the iterate to native f64, polishes a dual-feasible
    z, recovers the refined primal x(z) = R exp(-B'z)/sum, and keeps
    whichever of {refined, input} primal certifies the smaller gap +
    violation score.  O(n dim^2) per polish step.

    Two dual-start modes:
      * ``z0=None`` (cold): least-squares stationarity fit at ``x`` +
        line-searched ``_polish_dual`` (``kl_dual_gap``) — robust for an
        iterate of unknown quality (e.g. a primal-route x).
      * ``z0=`` the f32 kernel's dual (layout [lam_k, nu_sum1, nu_mE],
        exactly ``kl_dual_fused``'s third output): the active set is
        already settled, so a lean fixed-count Newton polish with NO
        line-search value evaluations suffices (``_kl_warm_polish``) —
        ~25x fewer exps per step.

    ``A``/``b`` are the FULL equality system (sum-to-one row included).
    Requires ``jax_enable_x64`` (raises at trace time otherwise — an f32
    "certificate" would be the exact lie this function exists to prevent).
    Jittable and vmappable; returns a ``KLCertificate``.

    ``compare_input=False`` (warm production path): always return the
    REFINED primal with its measured gap, falling back to the input only
    when the refinement is non-finite (then gap = +inf, never a lie).
    Skipping the input's objective drops the whole (n,) f64 ``log`` pass —
    one of three remaining transcendental passes on the certified route —
    at the cost of the (never-observed) possibility of returning a
    slightly worse-but-still-certified point than the caller supplied.
    """
    f64 = jnp.float64
    if jnp.zeros((), f64).dtype != jnp.float64:
        raise RuntimeError(
            "kl_certify needs jax_enable_x64 (without x64 the cast "
            "silently stays f32)")
    H64 = H.astype(f64)
    u64 = u.astype(f64)
    A64 = A.astype(f64)
    b64 = b.astype(f64)
    x64 = x.astype(f64)
    n = x.shape[0]
    k = H.shape[0]
    B = jnp.concatenate([H64, A64], axis=0)
    w = jnp.concatenate([u64, b64])
    logp, R = _prior_terms(prior, n, f64)
    if z0 is None:
        gap0, z = kl_dual_gap(H64, u64, A64, b64, x64,
                              polish_steps=polish_steps, prior=prior)
    else:
        z = _kl_warm_polish(B, w, R, z0.astype(f64), k,
                            steps=polish_steps)
        gap0 = None   # computed below from the shared exp(-B'z) pass
    # ONE transcendental (n,) pass serves the refined primal, BOTH gap
    # terms, and f_ref
    Btz = jnp.einsum("in,i->n", B, z, precision="highest")
    y = R * jnp.exp(-Btz)               # = exp(-B'z - 1 + log p)
    sum_y = jnp.sum(y)
    if gap0 is None and compare_input:
        # warm branch: g(z) = -(w.z + sum_y) reuses the same exp pass
        xs = jnp.maximum(x64, jnp.asarray(1e-30, f64))
        gap0 = (jnp.einsum("n,n->", xs, jnp.log(xs) - logp,
                           precision="highest") + (w @ z + sum_y))
    x_ref = y / sum_y
    # log x_ref - log p = -B'z - 1 - log(sum_y): the (n,) log collapses to
    # one SCALAR log plus a dot with the already-computed B'z
    f_ref = (-jnp.einsum("n,n->", x_ref, Btz, precision="highest")
             - 1.0 - jnp.log(sum_y))
    gap_ref = f_ref + (w @ z + sum_y)   # f(x_ref) - g(z)

    def residuals(xc):
        viol = jnp.maximum(jnp.max(-xc), 0.0)
        if k > 0:
            viol = jnp.maximum(
                viol, jnp.max(jnp.maximum(
                    jnp.einsum("in,n->i", H64, xc,
                               precision="highest") - u64, 0.0)))
        eq = jnp.max(jnp.abs(
            jnp.einsum("in,n->i", A64, xc, precision="highest") - b64))
        return viol, eq

    viol_ref, eq_ref = residuals(x_ref)
    score_ref = jnp.maximum(gap_ref, 0.0) + viol_ref + eq_ref
    if gap0 is None:
        # no-compare production path: the refined point with its MEASURED
        # gap, or the input with gap = +inf if refinement went non-finite
        # (an infeasible instance's divergent dual) — the stall flag fires
        # either way; the certificate is never fabricated
        ok = jnp.isfinite(score_ref)
        x_out = jnp.where(ok, x_ref, x64)
        gap = jnp.where(ok, gap_ref, jnp.asarray(jnp.inf, f64))
        viol_in, eq_in = residuals(x64)
        viol = jnp.where(ok, viol_ref, viol_in)
        eq_res = jnp.where(ok, eq_ref, eq_in)
        return KLCertificate(x=x_out, gap=gap, ineq_res=viol,
                             eq_res=eq_res, lam=z[:k], nu=z[k:])
    viol_in, eq_in = residuals(x64)
    # Selection must weigh FEASIBILITY, not just the signed gap: an
    # infeasible x has f(x) below p*, so its "gap" f(x) - g(z) can be
    # spuriously NEGATIVE (the f32 kernel's renormalized x violates its
    # active row by ~1e-7 and "wins" a min-gap comparison while being the
    # worse point).  Score = suboptimality + violations, both ~multiplier
    # scaled.
    score_in = jnp.maximum(gap0, 0.0) + viol_in + eq_in
    # a non-finite input score (NaN x from an underflowed f32 lane) must
    # LOSE to any finite refinement — NaN comparisons are False, so the
    # <= test alone would keep the broken input
    better = jnp.logical_and(
        jnp.isfinite(score_ref),
        jnp.logical_or(score_ref <= score_in,
                       jnp.logical_not(jnp.isfinite(score_in))))
    x_out = jnp.where(better, x_ref, x64)
    gap = jnp.where(better, gap_ref, gap0)
    viol = jnp.where(better, viol_ref, viol_in)
    eq_res = jnp.where(better, eq_ref, eq_in)
    return KLCertificate(x=x_out, gap=gap, ineq_res=viol, eq_res=eq_res,
                         lam=z[:k], nu=z[k:])


@pytree_dataclass
class DistKL:
    """The KL-minimization problem (canonical form: empty blocks allowed).

    Use ``DistKL.create(n, H=..., u=..., A=..., r=...)``.
    """

    H: jax.Array   # (mI, n) inequality data, mI may be 0
    u: jax.Array   # (mI,)
    A: jax.Array   # (mE, n) extra equalities, mE may be 0
    r: jax.Array   # (mE,)
    n: int = static_field()
    prior: jax.Array | None = None   # (n,) prior p; None = uniform

    @classmethod
    def create(cls, n: int, H=None, u=None, A=None, r=None,
               dtype=None, prior=None) -> "DistKL":
        """``prior`` (optional): a strictly positive (n,) weight vector p
        (normalized here) generalizing the objective to d_KL(Q, p) — the
        reference's Dist_KL fixes p uniform (Dist_KL.scala:218,259); all
        routes (BR/PD/BR_fast/dual/dual_fast/dual_fused/certified) accept
        a general prior."""
        # default to the INPUT arrays' joint dtype (f32 data stays f32 even
        # under jax_enable_x64, which the certified route requires) — a
        # canonical-float default would silently upcast the f32 fleet to
        # f64; same policy as QP.create
        if dtype is None:
            given = [v for v in (H, u, A, r) if v is not None]
            dtype = (jnp.result_type(*given, float) if given
                     else jnp.result_type(float))
        if (H is None) != (u is None) or (A is None) != (r is None):
            raise ValueError("H,u (and A,r) must be given together")
        if H is None:
            H = jnp.zeros((0, n), dtype)
            u = jnp.zeros((0,), dtype)
        if A is None:
            A = jnp.zeros((0, n), dtype)
            r = jnp.zeros((0,), dtype)
        H = jnp.asarray(H, dtype)
        u = jnp.asarray(u, dtype)
        A = jnp.asarray(A, dtype)
        r = jnp.asarray(r, dtype)
        if H.shape[0] == 0 and A.shape[0] == 0:
            raise ValueError("need at least one constraint (H,u or A,r)")
        if H.shape[1] != n or A.shape[1] != n:
            raise ValueError("H and A must have n columns")
        if prior is not None:
            prior = jnp.asarray(prior, dtype)
            if prior.shape != (n,):
                raise ValueError(f"prior must have shape ({n},), got "
                                 f"{prior.shape}")
            if not isinstance(prior, jax.core.Tracer) and not bool(
                    jnp.all(prior > 0)):
                raise ValueError("prior must be strictly positive")
            prior = prior / jnp.sum(prior)
        return cls(H=H, u=u, A=A, r=r, n=n, prior=prior)

    # ------------------------------------------------------------ primal side
    @property
    def objective(self) -> KLObjective:
        lp = None if self.prior is None else jnp.log(self.prior)
        return KLObjective(n=self.n, log_prior=lp)

    @property
    def equalities(self) -> EqualityConstraint:
        """[1'; A] x = [1; r] — probability constraint always first
        (Dist_KL.scala:193-209, 296-297)."""
        eq = sum_to_one(self.n, dtype=self.H.dtype)
        if self.A.shape[0] == 0:
            return eq
        return eq.stack(EqualityConstraint(A=self.A, b=self.r))

    @property
    def inequalities(self) -> ConstraintSet:
        """Rows of H plus positivity.  The domain stays the WHOLE space
        (Dist_KL.scala:293 `val C = ConvexSets.wholeSpace(n)`): positivity is
        enforced by the constraints, so the strictly feasible set already has
        x > 0 and the log in the objective is safe — while phase-I remains
        free to relax positivity through its slack variable."""
        blocks = []
        if self.H.shape[0] > 0:
            blocks.append(rows_leq(self.H, self.u))
        blocks.append(positivity(self.n, dtype=self.H.dtype))
        return ConstraintSet(blocks=tuple(blocks))

    # -------------------------------------------------------------- dual side
    @property
    def num_ineq_dual(self) -> int:
        return self.H.shape[0]

    @property
    def dual_dim(self) -> int:
        """mI + 1 + mE (Dist_KL.scala:115-116)."""
        return self.H.shape[0] + 1 + self.A.shape[0]

    def _R(self, dtype=None) -> jax.Array:
        """Dual constant R = p/e (uniform: 1/(n e), Dist_KL.scala:131)."""
        return _prior_terms(self.prior, self.n,
                            dtype or self.H.dtype)[1]

    def neg_dual_objective(self) -> _NegDualObjective:
        n = self.n
        dtype = self.H.dtype
        ones = jnp.ones((1, n), dtype)
        B = jnp.concatenate([self.H, ones, self.A], axis=0)
        w = jnp.concatenate([self.u, jnp.ones((1,), dtype), self.r])
        return _NegDualObjective(B=B, w=w, R=self._R())

    def primal_optimum(self, z: jax.Array) -> jax.Array:
        """Q(z) = R * exp(-B'z) (Dist_KL.scala:171), renormalized to
        sum 1 — exact at the true dual optimum, and a strict feasibility
        improvement at an approximate one (the f32 tail loses ~1e-2 of
        mass through the exp otherwise)."""
        d = self.neg_dual_objective()
        q = d._y(z)
        return q / jnp.sum(q)

    # ----------------------------------------------------------------- solve
    @mxu_exact
    def solve_dual_newton(self, pars: SolverParams | None = None,
                          steps: int = 30) -> Solution:
        """Direct active-set projected-Newton solve of the closed-form dual
        (method="dual_fast") — the fastest route for the scenario-batch
        workload.

        The dual dimension is mI + 1 + mE << n (Dist_KL.scala:59-65, the
        reference's own preferred route), so instead of running the full
        barrier machinery on it (log-barrier continuation + inner Newton =
        hundreds of kernel launches), -L*(z) is minimized directly over
        {lam >= 0}: a FIXED schedule of projected-Newton steps with
        bound-active multipliers frozen out of the (tiny) Newton system and
        an exact step-to-boundary candidate in the line search
        (duality._polish_dual).  Each step is a handful of batched matmuls
        and one (n,)-exp — under vmap the whole batch advances in ~30 fused
        XLA ops per step.  The returned duality_gap is the MEASURED
        certificate f(x) - g(z) (g any dual-feasible value => true bound),
        not a schedule constant.
        """
        from ..duality import _polish_dual

        pars = pars or SolverParams()
        d = self.neg_dual_objective()
        dtype = self.H.dtype
        k = self.num_ineq_dual
        z0 = jnp.full((self.dual_dim,), pars.dual_start, dtype)
        z = _polish_dual(d, z0, num_ineq=k, steps=steps)
        x = self.primal_optimum(z)
        # f(x) - g(z), measured; highest precision: a reduced-precision
        # matmul (~1e-3 relative) would put ~1e-3 noise on the certificate
        gap = self.objective.value(x) + d.value(z)
        nan = jnp.asarray(jnp.nan, dtype)
        grad_norm = jnp.linalg.norm(d.grad(z))
        eps = jnp.finfo(dtype).eps
        # |gap|: an INFEASIBLE problem drives the dual up without bound
        # (g -> inf is the infeasibility certificate), so the measured gap
        # goes hugely NEGATIVE — a one-sided gap > tol check would miss
        # it.  The recovered x's own measured violation catches the cases
        # the finite-step dual has not yet blown up on.
        ineq = self._ineq_res(x)
        stalled = jnp.logical_or(
            jnp.logical_not(jnp.all(jnp.isfinite(x))),
            jnp.logical_not(jnp.logical_and(      # NaN-safe: NaN flags
                jnp.abs(gap) <= jnp.sqrt(eps),
                ineq <= jnp.sqrt(eps))))
        return Solution(
            x=x, lam=z[:k], nu=z[k:], newton_decrement=nan,
            duality_gap=gap, eq_gap=jnp.abs(jnp.sum(x) - 1.0),
            norm_grad=grad_norm, norm_dual_residual=nan,
            iters=jnp.asarray(steps), maxed_out=jnp.asarray(False),
            stalled=stalled, ineq_res=ineq,
        )

    def _ineq_res(self, x: jax.Array) -> jax.Array:
        """Measured max inequality violation max(Hx - u, -x)_+ of an
        iterate — the renormalized dual-route x can slightly violate an
        active row, which a small gap alone would mask."""
        viol = jnp.maximum(jnp.max(-x), 0.0)
        if self.H.shape[0] > 0:
            viol = jnp.maximum(viol, jnp.max(jnp.maximum(
                jnp.einsum("in,n->i", self.H, x,
                           precision="highest") - self.u, 0.0)))
        return viol

    def solve_dual_fused(self, pars: SolverParams | None = None,
                         steps: int = 16,
                         interpret: bool = False) -> Solution:
        """Whole dual solve in one Pallas kernel (method="dual_fused") —
        see ops/pallas_kl_dual.py.  The route is ``backend.kl_dual_route``'s
        choice: the Triton kernel on the GPU (dual dim k + 1 + mE <=
        ``backend.TRITON_MAX_DIM``, n <= ``backend.TRITON_MAX_N``), the
        same kernel (dim <= 16) in the Pallas
        interpreter only when ``interpret=True``, and otherwise the XLA
        dual_fast route."""
        pars = pars or SolverParams()
        k = self.H.shape[0]
        m_eq = self.A.shape[0]
        route = backend.kl_dual_route(self.n, k, m_eq, interpret=interpret)
        if route == "xla":
            return self.solve_dual_newton(pars)
        from ..ops.pallas_kl_dual import kl_dual_fused

        dtype = self.H.dtype
        lp = None if self.prior is None else jnp.log(self.prior)
        x, gap, z = kl_dual_fused(self.H[None], self.u[None],
                                  self.A[None] if m_eq > 0 else None,
                                  self.r[None] if m_eq > 0 else None,
                                  log_prior=lp, n_steps=steps,
                                  z0=float(pars.dual_start),
                                  interpret=route == "interpret")
        x, gap, z = x[0], gap[0], z[0]
        nan = jnp.asarray(jnp.nan, dtype)
        eps = jnp.finfo(dtype).eps
        ineq = self._ineq_res(x)
        return Solution(
            x=x, lam=z[:k], nu=z[k:], newton_decrement=nan,
            duality_gap=gap, eq_gap=jnp.abs(jnp.sum(x) - 1.0),
            norm_grad=nan, norm_dual_residual=nan,
            iters=jnp.asarray(steps), maxed_out=jnp.asarray(False),
            stalled=jnp.logical_or(
                jnp.logical_not(jnp.all(jnp.isfinite(x))),
                jnp.logical_not(jnp.logical_and(  # |.|: infeasible ->
                    jnp.abs(gap) <= jnp.sqrt(eps),   # -inf; NaN-safe form
                    ineq <= jnp.sqrt(eps)))),
            ineq_res=ineq,
        )

    def solve_certified(self, pars: SolverParams | None = None,
                        steps: int = 16,
                        polish_steps: int = 2,
                        interpret: bool = False) -> Solution:
        """F32 dual solve + native-f64 finishing pass
        (method="dual_fused_cert"): the route to the reference's WRITTEN
        accuracy contract gap < tolSolver = 1e-8 (SolverParams.scala:41,
        BarrierSolver.scala:102).

        ``solve_dual_fused`` does the heavy lifting in f32; ``kl_certify``
        then lifts the iterate AND the dual z to f64 and runs the lean
        warm-started Newton polish (the active set is already settled;
        quadratic convergence from the ~1e-6 f32 start reaches the f64
        floor in 2 steps) and returns the refined primal with MEASURED
        gap / inequality / equality residuals.  Requires
        ``jax_enable_x64``.
        """
        pars = pars or SolverParams()
        sol = self.solve_dual_fused(pars, steps=steps, interpret=interpret)
        eqs = self.equalities
        cert = kl_certify(self.H, self.u, eqs.A, eqs.b, sol.x,
                          polish_steps=polish_steps,
                          z0=jnp.concatenate([sol.lam, sol.nu]),
                          prior=self.prior, compare_input=False)
        nan = jnp.asarray(jnp.nan, jnp.float64)
        stalled = jnp.logical_or(
            jnp.logical_not(jnp.all(jnp.isfinite(cert.x))),
            jnp.logical_not(jnp.logical_and(
                jnp.abs(cert.gap) <= pars.tol,
                jnp.logical_and(cert.ineq_res <= pars.tol_feas,
                                cert.eq_res <= pars.tol_feas))))  # |.|:
        # infeasible -> -inf; not-<= form: a NaN gap must flag too; the
        # measured residuals join the predicate (a small gap alone cannot
        # certify feasibility — see solve_certified_batch)
        return Solution(
            x=cert.x, lam=cert.lam, nu=cert.nu, newton_decrement=nan,
            duality_gap=cert.gap, eq_gap=cert.eq_res,
            norm_grad=nan, norm_dual_residual=nan,
            iters=jnp.asarray(steps + polish_steps),
            maxed_out=jnp.asarray(False), stalled=stalled,
            ineq_res=cert.ineq_res,
        )

    def fleet_route(self, interpret: bool = False) -> str:
        """The route ``solve_batch`` / ``solve_certified_batch`` take for
        this problem's shape on this device (``backend.kl_dual_route``)."""
        return backend.kl_dual_route(self.n, self.H.shape[0],
                                     self.A.shape[0], interpret=interpret)

    def _batch_rhs(self, u, r):
        B = u.shape[0]
        m_eq = self.A.shape[0]
        dtype = self.H.dtype
        u = jnp.asarray(u, dtype)
        if m_eq == 0:
            return u, jnp.zeros((B, 0), dtype)
        rb = (jnp.broadcast_to(self.r[None], (B, m_eq))
              if r is None else jnp.asarray(r, dtype))
        return u, rb

    def solve_batch(self, u, r=None, pars: SolverParams | None = None,
                    steps: int = 16, interpret: bool = False) -> Solution:
        """Batched f32-floor solve: per-instance bounds ``u`` (B, k) (and
        optionally ``r`` (B, mE)) against this problem's SHARED rows, in
        the problem's own dtype, on the route ``fleet_route()`` reports —
        the Triton dual kernel (ops/pallas_kl_dual.py) on the GPU, the
        same kernel in the Pallas interpreter when ``interpret=True``, or
        the XLA dual_fast route under vmap (dual dim or row width beyond
        ``backend.TRITON_MAX_DIM`` / ``TRITON_MAX_N``, or a device with no
        compiled kernel route).  ONE call over the whole batch; the gap
        leaf is the measured certificate f(x) - g(z).
        """
        pars = pars or SolverParams()
        k = self.H.shape[0]
        m_eq = self.A.shape[0]
        u, rb = self._batch_rhs(u, r)
        B = u.shape[0]
        dtype = self.H.dtype
        route = self.fleet_route(interpret)
        if route != "xla":
            from ..ops.pallas_kl_dual import kl_dual_fused

            lp = None if self.prior is None else jnp.log(self.prior)
            Hb = jnp.broadcast_to(self.H[None], (B, k, self.n))
            Ab = (jnp.broadcast_to(self.A[None], (B, m_eq, self.n))
                  if m_eq > 0 else None)
            x, gap, z = kl_dual_fused(Hb, u, Ab, rb if m_eq > 0 else None,
                                      log_prior=lp, n_steps=steps,
                                      z0=float(pars.dual_start),
                                      interpret=route == "interpret")
        else:
            # the XLA route starts COLD at the same schedule as
            # solve_dual_newton, so it gets at least its own tuned step
            # count even when the caller passes the kernel-sized default
            steps = max(steps, 30)

            def one(ui, ri):
                prob = DistKL(H=self.H, u=ui, A=self.A, r=ri, n=self.n,
                              prior=self.prior)
                s = prob.solve_dual_newton(pars, steps=steps)
                return s.x, s.duality_gap, jnp.concatenate([s.lam, s.nu])

            x, gap, z = jax.vmap(one)(u, rb)
        eps = jnp.finfo(dtype).eps
        ineq = jnp.maximum(jnp.max(-x, axis=1), 0.0)
        if k > 0:
            ineq = jnp.maximum(ineq, jnp.max(jnp.maximum(
                jnp.einsum("in,bn->bi", self.H, x, precision="highest")
                - u, 0.0), axis=1))
        nan = jnp.full((B,), jnp.nan, dtype)
        return Solution(
            x=x, lam=z[:, :k], nu=z[:, k:], newton_decrement=nan,
            duality_gap=gap, eq_gap=jnp.abs(jnp.sum(x, axis=1) - 1.0),
            norm_grad=nan, norm_dual_residual=nan,
            iters=jnp.full((B,), steps),
            maxed_out=jnp.zeros((B,), bool),
            stalled=jnp.logical_or(
                jnp.logical_not(jnp.all(jnp.isfinite(x), axis=1)),
                jnp.logical_not(jnp.logical_and(   # |.|, NaN-safe form
                    jnp.abs(gap) <= jnp.sqrt(eps), ineq <= jnp.sqrt(eps)))),
            ineq_res=ineq,
        )

    def solve_certified_batch(self, u, r=None,
                              pars: SolverParams | None = None,
                              steps: int = 16,
                              polish_steps: int = 2,
                              interpret: bool = False) -> Solution:
        """Batched certified solve: ``solve_batch`` (one f32 solve over the
        whole batch on the route ``fleet_route()`` reports), then the
        vmapped native-f64 finish (``kl_certify`` warm-started from the
        f32 dual).  Returns a batched Solution with MEASURED f64
        certificate leaves; requires ``jax_enable_x64``.
        """
        pars = pars or SolverParams()
        f32 = self.solve_batch(u, r, pars, steps=steps, interpret=interpret)
        u, rb = self._batch_rhs(u, r)
        B = u.shape[0]
        dtype = self.H.dtype
        xs = f32.x
        zs = jnp.concatenate([f32.lam, f32.nu], axis=1)
        eq_A = jnp.concatenate([jnp.ones((1, self.n), dtype), self.A],
                               axis=0)

        def certify_one(ui, ri, xi, zi):
            bi = jnp.concatenate([jnp.ones((1,), dtype), ri])
            return kl_certify(self.H, ui, eq_A, bi, xi, prior=self.prior,
                              polish_steps=polish_steps, z0=zi,
                              compare_input=False)

        certs = jax.vmap(certify_one)(u, rb, xs, zs)
        # health = gap AND measured residuals: an INFEASIBLE instance whose
        # finite-step dual has not diverged far can land at a small
        # measured gap (g bounds an infeasible problem's +inf optimum, so
        # f - g says nothing about feasibility) while x violates its rows
        # by O(margin)
        stalled = jnp.logical_or(
            jnp.logical_not(jnp.all(jnp.isfinite(certs.x), axis=1)),
            jnp.logical_not(jnp.logical_and(          # NaN-safe form
                jnp.abs(certs.gap) <= pars.tol,
                jnp.logical_and(certs.ineq_res <= pars.tol_feas,
                                certs.eq_res <= pars.tol_feas))))
        nan = jnp.full((B,), jnp.nan, jnp.float64)
        return Solution(
            x=certs.x, lam=certs.lam, nu=certs.nu, newton_decrement=nan,
            duality_gap=certs.gap, eq_gap=certs.eq_res,
            norm_grad=nan, norm_dual_residual=nan,
            iters=f32.iters + polish_steps,
            maxed_out=jnp.zeros((B,), bool), stalled=stalled,
            ineq_res=certs.ineq_res,
        )

    def solve(self, method: str = "dual", pars: SolverParams | None = None,
              feasible_point: jax.Array | None = None) -> Solution:
        """Solve the problem.

        method: "dual" (barrier on the closed-form dual — the preferred
        low-dimensional route), "dual_fast" (direct projected-Newton on the
        dual — the batch workhorse), "dual_fused" (whole dual solve in one
        Pallas kernel where ``backend.kl_dual_route`` picks it),
        "dual_fused_cert" (the same + f64 finishing pass certified to
        gap < 1e-8, needs x64), "dual_PD", "BR" (primal barrier),
        "BR_fast" (structured primal barrier), "PD" (primal primal-dual).
        Primal routes run phase-I at construction unless ``feasible_point``
        is given (Dist_KL.scala:307).
        """
        pars = pars or SolverParams()
        if method in ("dual_fast", "dual_fused", "dual_fused_cert", "dual",
                      "dual_BR", "dual_PD"):
            return self._solve_dual_route(method, pars)
        if method not in ("BR", "PD", "BR_fast"):
            raise ValueError(f"unknown method: {method!r}")
        cnts = self.inequalities
        eqs = self.equalities
        if feasible_point is None:
            x0 = jnp.full((self.n,), 1.0 / self.n, self.H.dtype)
            feasible_point = find_feasible_point(cnts, x0, pars, eqs)
        return self.solve_jittable(feasible_point, method=method, pars=pars)

    def _solve_dual_route(self, method: str, pars: SolverParams) -> Solution:
        if method == "dual_fast":
            return self.solve_dual_newton(pars)
        if method == "dual_fused":
            return self.solve_dual_fused(pars)
        if method == "dual_fused_cert":
            return self.solve_certified(pars)
        inner = "PD" if method == "dual_PD" else "BR"
        return solve_dual(self.neg_dual_objective(), self.num_ineq_dual,
                          self.dual_dim, self.primal_optimum,
                          method=inner, pars=pars)

    def solve_jittable(self, feasible_point: jax.Array,
                       method: str = "BR",
                       pars: SolverParams | None = None) -> Solution:
        """Fully jittable primal solve from a given strictly feasible point
        (no host-side phase-I gate) — the vmap/batch entry point."""
        pars = pars or SolverParams()
        if method == "BR":
            return barrier_solve(self.objective, self.inequalities,
                                 feasible_point, pars, eqs=self.equalities)
        if method == "PD":
            return primal_dual_solve(self.objective, self.inequalities,
                                     feasible_point, pars,
                                     eqs=self.equalities)
        if method == "BR_fast":
            # structure-exploiting primal barrier: the KL barrier Hessian is
            # diag + rank-mI, so Newton steps cost O(n (mI+mE)^2) instead of
            # O(n^3) (solvers/structured.py)
            from ..solvers.structured import barrier_solve_structured

            eqs = self.equalities
            return barrier_solve_structured(
                self.objective, self.H, self.u, eqs.A, eqs.b,
                feasible_point, pars,
            )
        if method in ("dual_fast", "dual_fused", "dual_fused_cert", "dual",
                      "dual_BR", "dual_PD"):
            return self._solve_dual_route(method, pars)
        raise ValueError(f"unknown method: {method!r}")

    def feasibility(self, pars: SolverParams | None = None):
        """Jittable phase-I report for this problem's constraints."""
        pars = pars or SolverParams()
        x0 = jnp.full((self.n,), 1.0 / self.n, self.H.dtype)
        return feasibility_analysis(self.inequalities, x0, pars,
                                    self.equalities)

    def feasibility_batch(self, u, pars: SolverParams | None = None):
        """FLEET phase-I screen: per-instance bounds ``u`` (B, k) against
        this problem's shared rows.  Returns ``(s_max (B,),
        strictly_feasible (B,))`` — ``s_max > 0`` is the per-instance
        infeasibility certificate (the minimized shared slack cannot reach
        0, i.e. NO point satisfies the constraints; the reference raises
        InfeasibleProblemException from exactly this condition,
        ConstraintSet.scala:571-572).

        The generic per-instance route (``feasibility_analysis`` under
        vmap) re-eliminates the SHARED equality system in every lane — a
        per-instance nullspace QR that dominates fleet screening.  Here
        the reduction x = z0 + F v is computed ONCE (the equalities do not
        vary across the fleet), the all-linear inequality set pulls back
        to shared (G_v, c_v) with only ``ub`` varying, and the exact
        low-rank structured phase-I vmaps over bounds alone.  Same math as
        phase1_by_reduction -> _phase1_linear_structured
        (ConstraintSet.scala:424-477), restructured for the fleet.
        """
        from ..problem.constraints import LinearBlock
        from ..solvers.phase1 import _phase1_linear_structured

        pars = pars or SolverParams()
        dtype = self.H.dtype
        k = self.H.shape[0]
        eqs = self.equalities
        ss = eqs.solution_space()             # ONCE: shared across fleet
        # x-space blocks: H x <= u_i (varying ub), -x <= 0 (fixed)
        Gv_rows = self.H @ ss.F               # (k, n - p)
        cv_rows = self.H @ ss.z0
        Gv_pos = -ss.F
        cv_pos = -ss.z0
        v0 = jnp.zeros((ss.F.shape[1],), dtype)

        def screen_one(ui):
            blocks = []
            if k > 0:
                blocks.append(LinearBlock(G=Gv_rows, c=cv_rows, ub=ui,
                                          label="rows"))
            blocks.append(LinearBlock(G=Gv_pos, c=cv_pos,
                                      ub=jnp.zeros((self.n,), dtype),
                                      label="positivity"))
            cnts_v = ConstraintSet(blocks=tuple(blocks))
            rep = _phase1_linear_structured(cnts_v, v0, pars)
            return rep.s_max, rep.strictly_feasible

        return jax.vmap(screen_one)(jnp.asarray(u, dtype))

    def feasibility_screen_batch(self, u, *, t0: float = 4.0,
                                 mu_t: float = 4.0, stages: int = 6,
                                 newton_steps: int = 4,
                                 polish_steps: int = 16,
                                 eq_tol: float = 1e-4):
        """Fast FLEET phase-I screen: entropy-smoothed GAME dual.

        The generic phase-I (``feasibility_batch`` /
        ``feasibility_analysis``, the reference's construction-time gate —
        Dist_KL.scala:307, ConstraintSet.scala:355-477) couples every vmap
        lane through one while_loop, so every lane waits for the slowest.  This
        screen is a RE-DESIGN of the same decision for the KL family's
        geometry: by LP duality on the simplex,

            s* = min_{x in simplex} max_i (H_i x - u_i)
               = max_{w in simplex_k} [ min_j (w'H)_j - w'u ],

        and ANY primal/dual pair gives MEASURED two-sided certificates

            s_lower = min_j (w'H)_j - w'u  <=  s*  <=
            s_upper = max_i (H_i x - u_i),

        so the method needs no convergence proof to be sound — only to be
        tight.  It ascends the entropy-smoothed dual (smoothing gap
        log(n)/t) with a damped-Newton fixed schedule (`stages` stages of
        temperature continuation t <- mu_t * t, `newton_steps` steps each
        — no data-dependent control flow, so lanes do NOT couple), and
        recovers the strictly positive primal x(w) = softmax(-t w'H).
        Decision per instance: ``s_upper < 0`` => strictly feasible (x is
        the point — strictly positive, sums to one, H x < u);
        ``s_lower > 0`` => INFEASIBLE certificate (w proves no point of
        the closed simplex satisfies H x <= u — the condition from which
        the reference raises, ConstraintSet.scala:571-572); neither =>
        ``undecided`` (|s*| below the smoothing floor ~ log(n)/t_final;
        escalate those few instances to ``feasibility_batch``).

        NOTE the value convention: s* here is the game value over the
        CLOSED simplex (positivity hard), while ``feasibility_batch``'s
        s_max also slacks the positivity rows — the SIGNS agree (both
        decide strict feasibility of the same set), the magnitudes need
        not.  Extra equality rows A x = r are folded in as the ±row
        pairs A x <= r + eq_tol, -A x <= -r + eq_tol — the REFERENCE'S
        own phase-I treatment of equalities (eqs-as-inequalities with
        tol 1e-6, ConstraintSet.scala:326-347); ``strictly_feasible``
        then certifies a point meeting the equalities within eq_tol
        (use ``feasibility_batch`` for the exact-equality nullspace
        treatment), while ``infeasible`` certifies the ORIGINAL problem
        infeasible (the relaxation is strictly weaker).  The ± pairs
        are anti-parallel rows — exactly the degenerate-payoff shape
        the primal polish exists for.  Default eq_tol = 1e-4 is what
        the default schedule DECIDES (measured: returned points meet
        the equalities to ~1e-5 in f32, ~1e-6 in f64); at the
        reference's written 1e-6 the feasible side honestly lands in
        ``undecided`` (never a false flag) — escalate those lanes to
        ``feasibility_batch``.
        """
        u = jnp.asarray(u, self.H.dtype)
        H, mE = self.H, self.A.shape[0]
        if mE > 0:
            tol = jnp.asarray(eq_tol, H.dtype)
            H = jnp.concatenate([H, self.A, -self.A], axis=0)
            pad = jnp.concatenate([self.r + tol, -self.r + tol])
            u = jnp.concatenate(
                [u, jnp.tile(pad[None, :], (u.shape[0], 1))], axis=1)
        return kl_feasibility_screen(H, u, t0=t0, mu_t=mu_t,
                                     stages=stages,
                                     newton_steps=newton_steps,
                                     polish_steps=polish_steps)


@pytree_dataclass
class FeasibilityScreen:
    """Batched result of :meth:`DistKL.feasibility_screen_batch`.

    ``s_lower <= s* <= s_upper`` are MEASURED certificates of the game
    value s* = min_{x in simplex} max_i (H_i x - u_i); the flags are the
    per-instance decisions (``undecided`` = the interval straddles 0)."""

    s_lower: jax.Array            # (B,)
    s_upper: jax.Array            # (B,)
    x: jax.Array                  # (B, n) strictly positive, sums to one
    w: jax.Array                  # (B, k) dual weights on the simplex
    strictly_feasible: jax.Array  # (B,) bool: s_upper < 0
    infeasible: jax.Array         # (B,) bool: s_lower > 0
    undecided: jax.Array          # (B,) bool


def kl_feasibility_screen(H, u, *, t0: float = 4.0, mu_t: float = 4.0,
                          stages: int = 6, newton_steps: int = 4,
                          polish_steps: int = 16):
    """Entropy-smoothed game-dual feasibility screen (jittable core).

    ``H`` (k, n) shared rows, ``u`` (B, k) per-instance bounds; returns a
    :class:`FeasibilityScreen`.  See ``DistKL.feasibility_screen_batch``
    for the math.  Two measured halves per continuation stage:

    * LOWER bound: damped-Newton ascent of the x-smoothed dual on softmax
      logits theta (any iterate maps to a valid w in the simplex, so every
      stage's bound is sound); the tiny Newton system goes through the
      closed-form/unrolled ``duality._small_solve``.
    * UPPER bound: ``polish_steps`` multiplicative-weights steps on the
      w-smoothed max-violation F_t(x) = (1/t) logsumexp(t(Hx - u))
      (exponentiated gradient: x <- softmax(log x - eta H'sigma), sigma =
      softmax(t(Hx - u))), warm-started from the running best x.  This is
      NOT redundant with x(w) = softmax(-t w'H): when constraint rows
      cancel along the optimal w (e.g. the ANTI-PARALLEL +/-I_A family,
      the round-5 mixed-fleet stress case), the payoff w*'H is flat and
      x(w*) degenerates to uniform — the dual alone cannot recover a
      feasible point there, while the primal descent walks straight into
      the feasible band.

    Bounds are accumulated as the running BEST across stages — they only
    ever tighten.  polish_steps=16 default: on the eq-fold family 8 steps
    left ~10% of feasible instances just outside the 1e-4 band (973/10k
    undecided) while 16 decided all — polish steps are the cheapest ops
    in the screen (two (k,n) matvecs each).  All contractions run at
    precision="highest": reduced-precision matmuls would poison the tiny Newton
    systems (see _NegDualObjective).
    """
    from ..duality import _small_solve

    H = jnp.asarray(H)
    dtype = H.dtype
    k, n = H.shape
    u = jnp.asarray(u, dtype)
    logn = float(np.log(n))
    # host-side static temperature schedule (continuation in the
    # smoothing parameter, like the barrier's mu schedule)
    ts = [float(t0) * float(mu_t) ** j for j in range(stages)]
    eye = jnp.eye(k, dtype=dtype)
    damp = 64.0 * float(jnp.finfo(dtype).eps)
    # exponentiated-gradient step: |grad log-space update| <= eta * max|H|
    eta = 1.0 / (jnp.max(jnp.abs(H)) + jnp.asarray(
        float(jnp.finfo(jnp.float32).tiny), dtype))

    def _wa(theta):
        w = jax.nn.softmax(theta)
        a = jnp.einsum("i,in->n", w, H, precision="highest")
        return w, a

    def _phi(theta, t, ui):
        # smoothed dual value: -(1/t)(logsumexp(-t w'H) - log n) - w'u
        w, a = _wa(theta)
        inner = -(jax.nn.logsumexp(-t * a) - logn) / t
        return inner - jnp.einsum("i,i->", w, ui, precision="highest")

    def _lower(theta, ui):
        # MEASURED (unsmoothed) dual certificate at the current iterate
        w, a = _wa(theta)
        wu = jnp.einsum("i,i->", w, ui, precision="highest")
        return jnp.min(a) - wu, w

    def _viol(x, ui):
        return jnp.einsum("in,n->i", H, x, precision="highest") - ui

    # the returned x must be STRICTLY positive (it seeds barrier solves,
    # whose log(x) cannot take the exact-0 entries softmax underflows to
    # at high t): mix in a vanishing uniform mass BEFORE measuring, so
    # s_upper certifies the point actually returned
    delta = 32.0 * float(jnp.finfo(dtype).eps)

    def _mix(x):
        return (1.0 - delta) * x + (delta / n)

    def screen_one(ui):
        theta = jnp.zeros((k,), dtype)
        x = jnp.full((n,), 1.0 / n, dtype)
        s_lb, w = _lower(theta, ui)
        s_ub = jnp.max(_viol(x, ui))
        for t in ts:
            phi_t = lambda th: _phi(th, t, ui)  # noqa: E731
            for _ in range(newton_steps):
                # GAUSS-NEWTON metric, not jax.hessian: phi is concave in
                # w but phi(softmax(theta)) is NOT concave in theta (the
                # softmax-curvature term grad_w phi . d2 softmax is
                # indefinite, and _small_solve's floored Cholesky turns an
                # indefinite system into inf/NaN).  Pull the NSD w-space
                # Hessian  -t H (diag(x) - x x') H'  back through the
                # softmax Jacobian J = diag(w) - w w' (PSD by construction
                # as J Mw J); the dropped term vanishes at stationarity.
                # wi is LOOP-LOCAL: `w` carries the running-best dual
                # certificate across stages — reusing the name here
                # clobbered it, and the returned w could then fail to
                # reproduce s_lower (caught by the round-5 code review;
                # pinned in TestFeasibilityScreen::test_returned_w_
                # reproduces_s_lower)
                wi, a = _wa(theta)
                x_t = jax.nn.softmax(-t * a)
                hx = jnp.einsum("in,n->i", H, x_t, precision="highest")
                hv = hx - ui                          # grad_w phi
                g = wi * hv - wi * jnp.einsum("i,i->", wi, hv,
                                              precision="highest")
                G = H * x_t[None, :]
                Mw = t * (jnp.einsum("in,jn->ij", G, H,
                                     precision="highest")
                          - jnp.outer(hx, hx))
                JM = wi[:, None] * Mw - wi[:, None] * jnp.einsum(
                    "i,ij->j", wi, Mw, precision="highest")[None, :]
                Hm = (JM * wi[None, :]
                      - jnp.einsum("ij,j->i", JM, wi,
                                   precision="highest")[:, None]
                      * wi[None, :])
                Hm = 0.5 * (Hm + Hm.T)                # exact symmetry
                # damping must dominate the f32 ROUNDING of Hm's own
                # construction (~eps * max|Mw| ~ eps * t), not just its
                # trace: a saturated softmax sends J -> 0 and Hm -> 0
                # while Mw stays O(t) — with trace-only damping the k > 8
                # lax Cholesky in _small_solve met an (f32-)indefinite
                # matrix and emitted NaN (one instance of the 80k sweep)
                lam = damp * (jnp.trace(Hm) / k + 1.0
                              + jnp.max(jnp.abs(Hm)))
                d = _small_solve(Hm + lam * eye, g)  # ascent direction
                # belt-and-braces: any residual non-finite direction
                # falls back to plain gradient ascent (the line search
                # validates either)
                d = jnp.where(jnp.all(jnp.isfinite(d)), d, g)
                # fixed-candidate line search on the true smoothed dual
                # (+ a safeguarded gradient candidate: d can be garbage
                # when the softmax saturates and Hm loses rank)
                tiny = jnp.asarray(float(jnp.finfo(jnp.float32).tiny),
                                   dtype)
                gn = g / (jnp.sqrt(jnp.einsum("i,i->", g, g,
                                              precision="highest")) + tiny)
                # cap the Newton step in logit space: a saturated softmax
                # flattens the Hessian to ~0 and the damped solve emits
                # enormous d; unchecked, theta runs to +/-inf and softmax
                # turns NaN (inf - inf), poisoning BOTH bounds
                dn = jnp.sqrt(jnp.einsum("i,i->", d, d,
                                         precision="highest"))
                d = d * jnp.minimum(1.0, 10.0 / (dn + tiny))
                cands = [theta + alpha * d
                         for alpha in (1.0, 0.25, 0.0625)]
                cands.append(theta + gn)
                cands.append(theta)                  # never go downhill
                vals = jnp.stack([phi_t(c) for c in cands])
                theta = jnp.stack(cands)[jnp.argmax(vals)]
                # recenter (softmax-invariant) and clip: keeps logits
                # finite forever; -60 still represents weight ~ 1e-26
                theta = jnp.clip(theta - jnp.max(theta), -60.0, 0.0)
            lb, wt = _lower(theta, ui)
            w = jnp.where(lb > s_lb, wt, w)
            s_lb = jnp.maximum(s_lb, lb)
            # primal polish (in LOG space — x(w) entries underflow to
            # exact 0 at high t, and log(0) would re-poison the
            # exponentiated-gradient update): start from the better of
            # the running best x and the dual recovery x(w)
            _, a = _wa(theta)
            lw = jax.nn.log_softmax(-t * a)
            xw = _mix(jnp.exp(lw))
            ub_w = jnp.max(_viol(xw, ui))
            lx = jnp.where(ub_w < s_ub, lw,
                           jnp.log(jnp.maximum(x, jnp.asarray(
                               float(jnp.finfo(jnp.float32).tiny), dtype))))
            x = jnp.where(ub_w < s_ub, xw, x)
            s_ub = jnp.minimum(s_ub, ub_w)
            for _ in range(polish_steps):
                sig = jax.nn.softmax(t * _viol(jnp.exp(lx), ui))
                lx = jax.nn.log_softmax(
                    lx - eta * jnp.einsum(
                        "i,in->n", sig, H, precision="highest"))
                xp = _mix(jnp.exp(lx))
                ub_p = jnp.max(_viol(xp, ui))
                x = jnp.where(ub_p < s_ub, xp, x)
                s_ub = jnp.minimum(s_ub, ub_p)
        return s_lb, s_ub, x, w

    s_lb, s_ub, x, w = jax.vmap(screen_one)(u)
    zero = jnp.zeros((), dtype)
    feas = s_ub < zero
    infeas = s_lb > zero
    return FeasibilityScreen(
        s_lower=s_lb, s_upper=s_ub, x=x, w=w,
        strictly_feasible=feas, infeasible=infeas,
        undecided=jnp.logical_not(jnp.logical_or(feas, infeas)))
