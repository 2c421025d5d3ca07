"""Round-3 regression suite.

Pins the round-3 verdict items:
  1. 1e-8-certified solutions on the (f32-kernel + f64 finishing pass)
     path — the reference's written accuracy contract
     (SolverParams.scala:41 tolSolver = 1e-8, BarrierSolver.scala:102).
  2. the advisor findings: measured inequality residuals on dual routes,
     the polish pre-snap fix (positive-but-below-rounding multipliers
     jamming the active-set Newton), checkpoint shape/dtype validation.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cvx_tpu.models import DistKL
from cvx_tpu.models.dist_kl import kl_certify
from cvx_tpu.solvers import SolverParams


def _scenario(n=100, dtype=jnp.float32):
    IA = np.zeros(n); IA[:3] = 1.0
    IB = np.zeros(n); IB[n // 2:] = 1.0
    return jnp.asarray(np.stack([-IA, IB]), dtype)


class TestCertified1e8:
    """Verdict item 1: the f32 + f64-finish path to the written 1e-8 gap
    contract."""

    def test_single_instance_certified(self):
        H = _scenario()
        prob = DistKL.create(100, H=H, u=jnp.asarray([-0.4, 0.7],
                                                     jnp.float32),
                             dtype=jnp.float32)
        sol = prob.solve_certified(interpret=True)
        assert sol.x.dtype == jnp.float64
        gap = float(sol.duality_gap)
        assert gap <= 1e-8 and gap >= -1e-12, gap
        assert float(sol.ineq_res) <= 1e-10
        assert float(sol.eq_gap) <= 1e-10
        assert not bool(sol.stalled)

    def test_batched_certified_contract(self):
        """128 varied instances (active/inactive constellations): every
        certificate must beat 1e-8 with measured feasibility."""
        n = 100
        H = _scenario(n)
        pA = jnp.linspace(0.05, 0.5, 128)
        pB = jnp.linspace(0.45, 0.95, 128)

        def one(a, b):
            u = jnp.stack([-a, b]).astype(jnp.float32)
            return DistKL.create(n, H=H, u=u, dtype=jnp.float32
                                 ).solve_certified(interpret=True)

        sols = jax.jit(jax.vmap(one))(pA, pB)
        gaps = np.asarray(sols.duality_gap)
        assert gaps.max() <= 1e-8, gaps.max()
        assert gaps.min() >= -1e-12, gaps.min()
        assert np.asarray(sols.ineq_res).max() <= 1e-10
        assert np.asarray(sols.eq_gap).max() <= 1e-10
        assert not np.asarray(sols.stalled).any()

    def test_batched_certified_entry(self):
        """solve_certified_batch: one kernel call over the batch (a vmapped
        per-instance kernel burns ~bt-fold padding work), then the vmapped
        f64 finish — the production certified shape."""
        n = 100
        H = _scenario(n)
        prob = DistKL.create(n, H=H, u=jnp.zeros((2,), jnp.float32),
                             dtype=jnp.float32)
        pA = jnp.linspace(0.05, 0.5, 64)
        pB = jnp.linspace(0.45, 0.95, 64)
        u = jnp.stack([-pA, pB], axis=1).astype(jnp.float32)
        s = jax.jit(functools.partial(prob.solve_certified_batch,
                              interpret=True))(u)
        g = np.asarray(s.duality_gap)
        assert g.max() <= 1e-8 and g.min() >= -1e-12
        assert np.asarray(s.ineq_res).max() <= 1e-10
        assert not np.asarray(s.stalled).any()

    def test_batched_certified_with_equalities(self):
        n = 100
        H = _scenario(n)
        A = jnp.asarray(np.linspace(0.2, 0.8, n)[None], jnp.float32)
        prob = DistKL.create(n, H=H, u=jnp.zeros((2,), jnp.float32),
                             A=A, r=jnp.asarray([0.5], jnp.float32),
                             dtype=jnp.float32)
        pA = jnp.linspace(0.05, 0.35, 32)
        pB = jnp.linspace(0.45, 0.95, 32)
        u = jnp.stack([-pA, pB], axis=1).astype(jnp.float32)
        r = jnp.linspace(0.44, 0.50, 32)[:, None].astype(jnp.float32)
        s = jax.jit(functools.partial(prob.solve_certified_batch,
                              interpret=True))(u, r)
        assert np.asarray(s.duality_gap).max() <= 1e-8
        assert not np.asarray(s.stalled).any()

    def test_infeasible_instances_are_flagged(self):
        """An INFEASIBLE instance drives the dual up without bound, so the
        measured gap goes hugely NEGATIVE — the two-sided |gap| stall
        check must flag it (a one-sided gap > tol check missed it)."""
        n = 100
        H = _scenario(n)
        A = jnp.asarray(np.linspace(0.2, 0.8, n)[None], jnp.float32)
        prob = DistKL.create(n, H=H, u=jnp.zeros((2,), jnp.float32),
                             A=A, r=jnp.asarray([0.5], jnp.float32),
                             dtype=jnp.float32)
        # unreachable: with P(A) >= 0.4 pinned at A-values ~0.2, max A.x
        # is ~0.56 < 0.75
        u_bad = jnp.tile(jnp.asarray([[-0.4, 0.85]], jnp.float32), (4, 1))
        r_bad = jnp.full((4, 1), 0.75, jnp.float32)
        s = jax.jit(functools.partial(prob.solve_certified_batch,
                              interpret=True))(u_bad, r_bad)
        assert np.asarray(s.stalled).all()
        # the raw f32 dual routes flag it too
        prob_bad = DistKL.create(
            n, H=H, u=jnp.asarray([-0.4, 0.85], jnp.float32), A=A,
            r=jnp.asarray([0.75], jnp.float32), dtype=jnp.float32)
        assert bool(prob_bad.solve(method="dual_fast").stalled)
        assert bool(prob_bad.solve_dual_fused(interpret=True).stalled)

    def test_certify_rejects_infeasible_input(self):
        """kl_certify must not report a spuriously negative gap for an
        INFEASIBLE input iterate (f(x) < p* when x violates an active
        row): the feasibility-weighted selection keeps the refined x."""
        n = 100
        H = _scenario(n)
        u = jnp.asarray([-0.4, 0.7], jnp.float32)
        prob = DistKL.create(n, H=H, u=u, dtype=jnp.float32)
        eqs = prob.equalities
        # deliberately infeasible input: violate the active row by 1e-4
        x_bad = np.full(n, 1.0 / n)
        x_bad[:3] = (0.4 - 1e-4) / 3
        x_bad[3:] = (0.6 + 1e-4) / 97
        cert = kl_certify(prob.H, prob.u, eqs.A, eqs.b,
                          jnp.asarray(x_bad, jnp.float32))
        assert float(cert.gap) >= -1e-12
        assert float(cert.gap) <= 1e-8
        assert float(cert.ineq_res) <= 1e-10

    @pytest.mark.filterwarnings(
        "ignore:Explicitly requested dtype float64:UserWarning")
    def test_certify_requires_x64(self):
        prev = jax.config.jax_enable_x64
        jax.config.update("jax_enable_x64", False)
        try:
            H = _scenario()
            prob = DistKL.create(100, H=H,
                                 u=jnp.asarray([-0.4, 0.7], jnp.float32),
                                 dtype=jnp.float32)
            eqs = prob.equalities
            with pytest.raises(RuntimeError, match="x64"):
                kl_certify(prob.H, prob.u, eqs.A, eqs.b,
                           jnp.full((100,), 0.01, jnp.float32))
        finally:
            jax.config.update("jax_enable_x64", prev)

    def test_polish_does_not_jam_on_tiny_positive_lam(self):
        """The least-squares dual init can leave a multiplier at +O(eps):
        not <= 0, so the freeze test missed it and its huge inward
        gradient poisoned the coupled Newton step — the polish then
        jammed at the init forever.  The pre-snap must let it converge."""
        from cvx_tpu.duality import _polish_dual
        from cvx_tpu.models.dist_kl import _NegDualObjective

        n = 100
        H = _scenario(n, jnp.float64)
        u = jnp.asarray([-0.40787402, 0.84763779], jnp.float64)
        B = jnp.concatenate([H, jnp.ones((1, n), jnp.float64)], axis=0)
        w = jnp.concatenate([u, jnp.ones((1,), jnp.float64)])
        d = _NegDualObjective(B=B, w=w,
                              R=jnp.full((n,), 1 / (n * np.e), jnp.float64))
        # near-optimal z with a positive-but-below-rounding second lam
        z0 = jnp.asarray([3.10333707, 6.18e-15, -0.50642342], jnp.float64)
        z = _polish_dual(d, z0, num_ineq=2, steps=6)
        g = d.grad(z)
        free = jnp.asarray([True, False, True])   # lam_2 frozen at bound
        assert float(jnp.max(jnp.abs(jnp.where(free, g, 0.0)))) < 1e-10


class TestFusedKernelDim5:
    """Verdict item 2: the fused dual kernel covers dual dim
    k + 1 + mE <= 5 (was k <= 2, no equalities) — no silent fall-off to
    the slower XLA route inside the supported envelope."""

    @pytest.mark.parametrize("k,m_eq", [(1, 0), (2, 0), (3, 0), (4, 0),
                                        (1, 1), (2, 1), (2, 2), (3, 1),
                                        (0, 1), (0, 2)])
    def test_fused_matches_dual_fast(self, k, m_eq):
        n = 64
        rng = np.random.default_rng(k * 10 + m_eq)
        # random disjoint-ish event rows, feasible by construction around
        # a point x0 concentrated on nothing in particular
        x0 = rng.uniform(0.5, 1.5, n)
        x0 = x0 / x0.sum()
        H = rng.uniform(0.0, 1.0, (k, n))
        u = H @ x0 + rng.uniform(0.05, 0.2, k)      # strictly feasible
        A = rng.uniform(0.0, 1.0, (m_eq, n))
        r = A @ x0                                   # consistent
        prob = DistKL.create(
            n, H=jnp.asarray(H, jnp.float32), u=jnp.asarray(u, jnp.float32),
            A=jnp.asarray(A, jnp.float32) if m_eq else None,
            r=jnp.asarray(r, jnp.float32) if m_eq else None,
            dtype=jnp.float32)
        s_fused = prob.solve_dual_fused(interpret=True)
        s_fast = prob.solve(method="dual_fast")
        gap_fused = float(s_fused.duality_gap)
        gap_fast = float(s_fast.duality_gap)
        assert gap_fused < 1e-5, (k, m_eq, gap_fused)
        assert np.allclose(np.asarray(s_fused.x), np.asarray(s_fast.x),
                           atol=5e-5), (k, m_eq)
        assert abs(gap_fused - gap_fast) < 1e-5

    @pytest.mark.parametrize("k,m_eq", [(1, 0), (2, 0), (3, 0), (4, 0),
                                        (1, 1), (2, 1), (2, 2), (3, 1)])
    def test_fused_matches_dual_fast_active(self, k, m_eq):
        """Same envelope sweep with BINDING rows: H = -W forces
        E[W] >= E_x0[W] + delta, so the active-set freeze/release logic is
        exercised at every (k, m_eq) — the feasible-by-construction sweep
        above settles with all lam = 0 and tests only the trivial
        inactive branch."""
        n = 64
        rng = np.random.default_rng(100 + k * 10 + m_eq)
        x0 = rng.uniform(0.5, 1.5, n)
        x0 = x0 / x0.sum()
        W = rng.uniform(0.0, 1.0, (k, n))
        delta = 0.02 if m_eq else 0.06
        H = -W
        u = -(W @ x0 + delta)                        # ACTIVE at optimum
        A = rng.uniform(0.0, 1.0, (m_eq, n))
        r = A @ x0                                   # consistent
        prob = DistKL.create(
            n, H=jnp.asarray(H, jnp.float32), u=jnp.asarray(u, jnp.float32),
            A=jnp.asarray(A, jnp.float32) if m_eq else None,
            r=jnp.asarray(r, jnp.float32) if m_eq else None,
            dtype=jnp.float32)
        s_fused = prob.solve_dual_fused(interpret=True)
        s_fast = prob.solve(method="dual_fast")
        assert not bool(s_fused.stalled), (k, m_eq)
        # the binding rows carry REAL multipliers
        assert float(jnp.max(s_fast.lam)) > 1e-2, (k, m_eq)
        assert float(s_fused.duality_gap) < 1e-5, (k, m_eq)
        assert np.allclose(np.asarray(s_fused.x), np.asarray(s_fast.x),
                           atol=5e-5), (k, m_eq)

    def test_fused_active_constraints_dim5(self):
        """k=3 active-ish rows + 1 equality (dim 5) certified end to end."""
        n = 100
        IA = np.zeros(n); IA[:3] = 1.0
        IB = np.zeros(n); IB[n // 2:] = 1.0
        IC = np.zeros(n); IC[10:30] = 1.0
        H = jnp.asarray(np.stack([-IA, IB, IC]), jnp.float32)
        A = jnp.asarray(np.linspace(0.2, 0.8, n)[None], jnp.float32)
        prob = DistKL.create(
            n, H=H, u=jnp.asarray([-0.3, 0.7, 0.4], jnp.float32),
            A=A, r=jnp.asarray([0.52], jnp.float32), dtype=jnp.float32)
        sol = prob.solve_certified(interpret=True)
        assert float(sol.duality_gap) <= 1e-8
        assert float(sol.ineq_res) <= 1e-10
        assert float(sol.eq_gap) <= 1e-10

    def test_fallback_beyond_dim5(self):
        """dim > 5 still solves (XLA dual_fast fallback, no exception)."""
        n = 64
        rng = np.random.default_rng(7)
        x0 = np.full(n, 1.0 / n)
        H = rng.uniform(0.0, 1.0, (5, n))
        u = H @ x0 + 0.1
        prob = DistKL.create(n, H=jnp.asarray(H, jnp.float32),
                             u=jnp.asarray(u, jnp.float32),
                             dtype=jnp.float32)
        sol = prob.solve(method="dual_fused")   # dim 6 -> fallback
        assert float(sol.duality_gap) < 1e-5


class TestIneqResidualReporting:
    """Advisor finding 1: dual routes report measured inequality
    feasibility of the renormalized x, mirroring eq_gap."""

    def test_dual_routes_carry_ineq_res(self):
        H = _scenario()
        prob = DistKL.create(100, H=H,
                             u=jnp.asarray([-0.4, 0.7], jnp.float32),
                             dtype=jnp.float32)
        for method in ("dual_fast", "dual_fused", "dual_fused_cert"):
            sol = prob.solve(method=method)
            assert sol.ineq_res is not None, method
            v = float(sol.ineq_res)
            assert np.isfinite(v) and v >= 0.0, (method, v)
            # f32 routes may violate by ~1e-6; never by more
            assert v < 1e-5, (method, v)

    def test_ineq_res_detects_violation(self):
        H = _scenario()
        prob = DistKL.create(100, H=H,
                             u=jnp.asarray([-0.4, 0.7], jnp.float32),
                             dtype=jnp.float32)
        x_bad = jnp.full((100,), 0.01, jnp.float32)  # P(A)=0.03 < 0.4
        assert float(prob._ineq_res(x_bad)) == pytest.approx(0.37, rel=1e-5)


class TestStructuredFrontDoor:
    """Verdict item 4: LP()/DiagQP get a no-feasible-point .solve() and
    api.minimize routes DiagQP-shaped problems to the Woodbury path
    (reference: OptimizationProblem.scala:174-196 factories)."""

    def test_lp_solve_from_nothing(self):
        """min a.x s.t. sum x = 1, x > 0 — optimum concentrates on the
        smallest coefficient."""
        from cvx_tpu.models import LP

        n = 16
        a = jnp.arange(1.0, n + 1.0)          # argmin at coordinate 0
        lp = LP(a, A=jnp.ones((1, n)), b=jnp.ones((1,)))
        sol = lp.solve()
        x = np.asarray(sol.x)
        assert abs(float(a @ sol.x) - 1.0) < 1e-2    # f* = a_0 = 1
        assert x[0] > 0.99
        # the structured path restores equality feasibility progressively
        # from the phase-I output; at tol=1e-8 it lands ~1e-5
        assert float(sol.eq_gap) < 1e-4

    def test_lp_solve_with_rows(self):
        """LP with a dense inequality row capping the best coordinate."""
        from cvx_tpu.models import LP

        n = 8
        a = jnp.arange(1.0, n + 1.0)
        U = jnp.zeros((1, n)).at[0, 0].set(1.0)   # x_0 <= 0.25
        lp = LP(a, U=U, ub=jnp.asarray([0.25]),
                A=jnp.ones((1, n)), b=jnp.ones((1,)))
        sol = lp.solve()
        x = np.asarray(sol.x)
        # optimum: x_0 = 0.25 (capped), rest on coordinate 1
        assert abs(x[0] - 0.25) < 1e-3
        assert abs(x[1] - 0.75) < 1e-3
        assert abs(float(a @ sol.x) - (0.25 * 1 + 0.75 * 2)) < 1e-2

    def test_diagqp_solve_from_nothing(self):
        from cvx_tpu.models import DiagQP

        n = 12
        c = jnp.ones((n,))
        a = -jnp.linspace(0.5, 1.5, n)
        qp = DiagQP(c=c, a=a, U=jnp.zeros((0, n)), ub=jnp.zeros((0,)),
                    A=jnp.ones((1, n)), b=jnp.ones((1,)))
        sol = qp.solve()
        assert float(sol.duality_gap) < 1e-7
        assert float(sol.eq_gap) < 1e-7
        # KKT: x = a_neg + nu spread s.t. sum = 1 (projected), all > 0
        assert float(jnp.min(sol.x)) > 0

    def test_diagqp_infeasible_raises(self):
        from cvx_tpu.models import DiagQP
        from cvx_tpu.solvers.phase1 import InfeasibleProblemError

        n = 4
        # x > 0 with sum x = -1: infeasible
        qp = DiagQP(c=jnp.ones((n,)), a=jnp.zeros((n,)),
                    U=jnp.zeros((0, n)), ub=jnp.zeros((0,)),
                    A=jnp.ones((1, n)), b=-jnp.ones((1,)))
        with pytest.raises(InfeasibleProblemError):
            qp.solve()

    def test_minimize_dispatches_br_fast(self):
        """minimize(method='BR_fast') routes a DiagQP-shaped problem to the
        structured Woodbury path and matches the dense barrier."""
        from cvx_tpu import minimize
        from cvx_tpu.problem.constraint_set import ConstraintSet
        from cvx_tpu.problem.constraints import positivity, rows_leq
        from cvx_tpu.problem.equality import EqualityConstraint
        from cvx_tpu.models.dist_kl import KLObjective

        n = 32
        obj = KLObjective(n=n)
        U = jnp.zeros((1, n)).at[0, :3].set(-1.0)     # P(A) >= 0.3
        cnts = ConstraintSet(blocks=(rows_leq(U, jnp.asarray([-0.3])),
                                     positivity(n)))
        eqs = EqualityConstraint(A=jnp.ones((1, n)), b=jnp.ones((1,)))
        x0 = jnp.full((n,), 1.0 / n)
        fp = jnp.where(jnp.arange(n) < 3, 0.35 / 3, 0.65 / (n - 3))
        s_fast = minimize(obj, cnts, eqs, x0=x0, feasible_point=fp,
                          method="BR_fast")
        s_dense = minimize(obj, cnts, eqs, x0=x0, feasible_point=fp,
                           method="BR")
        assert float(s_fast.duality_gap) < 1e-7
        assert np.allclose(np.asarray(s_fast.x), np.asarray(s_dense.x),
                           atol=1e-6)

    def test_minimize_br_fast_rejects_unstructured(self):
        from cvx_tpu import minimize
        from cvx_tpu.problem.constraint_set import ConstraintSet
        from cvx_tpu.problem.constraints import rows_leq
        from cvx_tpu.models.dist_kl import KLObjective

        n = 8
        obj = KLObjective(n=n)
        cnts = ConstraintSet(blocks=(rows_leq(jnp.ones((1, n)),
                                              jnp.ones((1,))),))
        with pytest.raises(ValueError, match="positivity"):
            minimize(obj, cnts, x0=jnp.full((n,), 1.0 / n),
                     feasible_point=jnp.full((n,), 1.0 / (2 * n)),
                     method="BR_fast")


class TestSchurSolutionRecord:
    """Verdict item 6: the Schur-consensus barrier returns a Solution with
    per-block status flags; a poisoned block is flagged like poisoned
    instances are elsewhere."""

    def _problem(self, key, K=4, nb=8, mb=4, p=2):
        from cvx_tpu.parallel.schur import SeparableProblem

        ks = jax.random.split(key, 4)
        eye = jnp.eye(nb)
        P = jnp.tile((eye + 0.1)[None], (K, 1, 1))
        a = jax.random.normal(ks[0], (K, nb))
        G = jnp.tile(jnp.concatenate([eye, -eye], axis=0)[None],
                     (K, 1, 1))[:, :mb]
        u = jnp.full((K, mb), 10.0)
        C = jax.random.normal(ks[1], (K, p, nb)) / np.sqrt(nb)
        c = 0.1 * jax.random.normal(ks[2], (p,))
        return SeparableProblem(P=P, a=a, G=G, u=u, C=C, c=c)

    def test_healthy_solution_record(self, key=jax.random.PRNGKey(3)):
        from cvx_tpu.diagnostics import solve_stats
        from cvx_tpu.parallel.schur import separable_barrier_solve

        prob = self._problem(key)
        sol = separable_barrier_solve(prob, jnp.zeros((prob.K, prob.nb)))
        assert sol.x.shape == (prob.K, prob.nb)
        assert sol.lam.shape == prob.u.shape
        assert sol.nu.shape == prob.c.shape
        assert sol.stalled.shape == (prob.K,)
        assert not bool(jnp.any(sol.stalled))
        stats = solve_stats(sol)
        assert stats["stalled_frac"] == 0.0
        # equality duals satisfy block stationarity approximately:
        # t P_k x_k + t a_k + G' (1/(t d)) ... lam,nu barrier estimates
        grad_lag = (jnp.einsum("kij,kj->ki", prob.P, sol.x) + prob.a
                    + jnp.einsum("kmn,km->kn", prob.G, sol.lam)
                    + jnp.einsum("kpn,p->kn", prob.C, sol.nu))
        assert float(jnp.max(jnp.abs(grad_lag))) < 1e-2

    def test_poisoned_block_is_flagged(self, key=jax.random.PRNGKey(4)):
        """An instance with NaN data poisons ONLY its own block flags."""
        from cvx_tpu.parallel.schur import separable_barrier_solve
        from cvx_tpu.tree import replace

        prob = self._problem(key)
        a_bad = prob.a.at[1].set(jnp.nan)
        prob_bad = replace(prob, a=a_bad)
        sol = separable_barrier_solve(prob_bad,
                                      jnp.zeros((prob.K, prob.nb)))
        stalled = np.asarray(sol.stalled)
        assert stalled[1]               # the poisoned block is flagged


class TestResumeProduction:
    """Verdict item 7: checkpoint/resume for the PRODUCTION routes.
    Preempt the BR_fast continuation mid-flight; the resumed run must
    match straight-through to certificate level."""

    def _prob(self):
        n = 100
        H = _scenario(n, jnp.float64)
        return DistKL.create(n, H=H, u=jnp.asarray([-0.4, 0.7]),
                             dtype=jnp.float64)

    def test_resume_br_fast_matches_straight_through(self, tmp_path):
        from cvx_tpu.checkpoint import (load_pytree, resume_structured,
                                        save_pytree)
        from cvx_tpu.models.dist_kl import kl_dual_gap

        prob = self._prob()
        eqs = prob.equalities
        n = prob.n
        x0 = jnp.where(jnp.arange(n) < 3, 0.45 / 3, 0.55 / (n - 3))
        pars_full = SolverParams(tol=1e-9, mu=20.0)
        sol_full = prob.solve_jittable(x0, method="BR_fast",
                                       pars=pars_full)

        # preempt: only 2 continuation stages, then checkpoint to disk
        pars_cut = SolverParams(tol=1e-9, mu=20.0, outer_max_iter=2)
        sol_cut = prob.solve_jittable(x0, method="BR_fast", pars=pars_cut)
        assert float(sol_cut.duality_gap) > 1e-9   # genuinely unfinished
        path = str(tmp_path / "preempted.npz")
        save_pytree(path, sol_cut)
        sol_loaded = load_pytree(path, sol_cut)

        sol_res = resume_structured(prob.objective, prob.H, prob.u,
                                    eqs.A, eqs.b, sol_loaded, pars_full)
        # same certificate level as straight-through (measured, not m/t)
        g_full, _ = kl_dual_gap(prob.H, prob.u, eqs.A, eqs.b, sol_full.x)
        g_res, _ = kl_dual_gap(prob.H, prob.u, eqs.A, eqs.b, sol_res.x)
        assert float(g_res) < 1e-9
        assert abs(float(g_res) - float(g_full)) < 1e-9
        assert float(jnp.max(jnp.abs(sol_res.x - sol_full.x))) < 1e-6

    def test_resume_finished_checkpoint_is_identity(self):
        from cvx_tpu.checkpoint import resume_structured

        prob = self._prob()
        eqs = prob.equalities
        n = prob.n
        x0 = jnp.where(jnp.arange(n) < 3, 0.45 / 3, 0.55 / (n - 3))
        pars = SolverParams(tol=1e-9, mu=20.0)
        sol = prob.solve_jittable(x0, method="BR_fast", pars=pars)
        assert float(sol.duality_gap) <= 1e-9
        sol2 = resume_structured(prob.objective, prob.H, prob.u,
                                 eqs.A, eqs.b, sol, pars)
        assert sol2 is sol

    def test_resume_unhealthy_raises(self):
        from cvx_tpu.checkpoint import resume_structured
        from cvx_tpu.tree import replace

        prob = self._prob()
        eqs = prob.equalities
        n = prob.n
        x0 = jnp.where(jnp.arange(n) < 3, 0.45 / 3, 0.55 / (n - 3))
        sol = prob.solve_jittable(x0, method="BR_fast",
                                  pars=SolverParams(outer_max_iter=1))
        bad = replace(sol, duality_gap=jnp.asarray(jnp.nan, jnp.float64))
        with pytest.raises(ValueError, match="unhealthy"):
            resume_structured(prob.objective, prob.H, prob.u,
                              eqs.A, eqs.b, bad)


class TestRuizVariants:
    """Verdict item 9: EVIDENCE for the claim that the convergent l2 Ruiz
    loop subsumes the reference's l-inf + 5xl2 variant
    (MatrixUtils.scala:278-307 ruizEquilibrate0).  Port of the
    condition-number-ratio study MatrixUtilsTests.scala:384-404: both
    variants run on random SPD stress matrices with prescribed condition
    numbers; the l2 loop must reduce the condition number at least as well
    (up to a small slack) on EVERY instance."""

    @pytest.mark.parametrize("cond", [1e6, 1e10, 1e14])
    def test_l2_loop_subsumes_linf_variant(self, key, cond):
        from cvx_tpu.ops.equilibrate import (condition_number,
                                             ruiz_equilibrate,
                                             ruiz_equilibrate0)
        from cvx_tpu.ops.testmat import random_spd

        n = 64
        ratios = []
        for i in range(8):
            ki = jax.random.fold_in(key, i + int(np.log10(cond)))
            H = random_spd(ki, n, cond)
            c0 = float(condition_number(H))
            _, Q2 = ruiz_equilibrate(H)
            _, Q0 = ruiz_equilibrate0(H)
            c2 = float(condition_number(Q2))
            cinf = float(condition_number(Q0))
            # neither variant HURTS meaningfully (equilibration cannot
            # always help: rotated-spectrum SPD matrices already have
            # near-uniform row norms, so reductions here are modest)
            assert c2 < 1.1 * c0 and cinf < 1.1 * c0
            ratios.append(c2 / cinf)
        # MEASURED PARITY (the "subsumed" claim, now evidenced): the
        # convergent l2 loop lands within 5% of the l-inf+5xl2 variant on
        # every stress instance (observed: within 0.7%)
        assert max(ratios) < 1.05, ratios

    def test_variants_agree_on_solve(self, key):
        """Both equilibrations feed the same downstream recipe: solve
        Q u = d b, x = d u — answers must agree."""
        from cvx_tpu.ops.equilibrate import (ruiz_equilibrate,
                                             ruiz_equilibrate0)
        from cvx_tpu.ops.testmat import random_spd

        n = 32
        H = random_spd(key, n, 1e8)
        b = jax.random.normal(jax.random.fold_in(key, 1), (n,))
        for eq in (ruiz_equilibrate, ruiz_equilibrate0):
            d, Q = eq(H)
            x = d * jnp.linalg.solve(Q, d * b)
            assert float(jnp.linalg.norm(H @ x - b)) < 1e-6 * float(
                jnp.linalg.norm(b))


class TestCheckpointValidation:
    """Advisor finding 3: load_pytree validates shapes and dtypes."""

    def test_shape_mismatch_raises(self, tmp_path):
        from cvx_tpu.checkpoint import load_pytree, save_pytree

        tree = {"a": jnp.ones((4,)), "b": jnp.zeros((2, 2))}
        path = str(tmp_path / "ck.npz")
        save_pytree(path, tree)
        bad = {"a": jnp.ones((5,)), "b": jnp.zeros((2, 2))}
        with pytest.raises(ValueError, match="leaf 0"):
            load_pytree(path, bad)

    def test_dtype_mismatch_raises(self, tmp_path):
        from cvx_tpu.checkpoint import load_pytree, save_pytree

        tree = {"a": jnp.ones((4,), jnp.float32)}
        path = str(tmp_path / "ck.npz")
        save_pytree(path, tree)
        with pytest.raises(ValueError, match="leaf 0"):
            load_pytree(path, {"a": jnp.ones((4,), jnp.float64)})


class TestConvexSetSurface:
    """Round-3 close-out of verdict missing item 4: the general Cartesian
    product of convex sets (ConvexSets.scala:57-86) + StrictlyFeasibleSet
    (ConvexSet.scala:86-109) + sample-point plumbing on Domain."""

    def test_cartesian_product_membership_and_sample(self):
        from cvx_tpu.problem import (cartesian_product, positive_orthant,
                                     whole_space)
        C = positive_orthant(3)
        D = whole_space(2)
        P = cartesian_product(C, D, n=3)
        assert bool(P.contains(jnp.asarray([1.0, 2.0, 3.0, -5.0, 0.0])))
        assert not bool(P.contains(jnp.asarray([1.0, -2.0, 3.0, 0.0, 0.0])))
        s = np.asarray(P.sample)
        assert s.shape == (5,)
        assert bool(P.contains(jnp.asarray(s)))

    def test_cartesian_product_sample_requires_both(self):
        from cvx_tpu.problem import (Domain, cartesian_product,
                                     positive_orthant)
        P = cartesian_product(positive_orthant(3), Domain(), n=3)
        assert P.sample is None

    def test_strictly_feasible_set(self):
        from cvx_tpu.problem import (ConstraintSet, positivity, rows_leq,
                                     strictly_feasible_set)
        n = 4
        cnts = ConstraintSet(blocks=(
            rows_leq(jnp.ones((1, n)), jnp.asarray([1.0])), positivity(n)))
        S = strictly_feasible_set(cnts)
        assert bool(S.contains(jnp.full((n,), 0.2)))
        assert not bool(S.contains(jnp.full((n,), 0.3)))   # sum = 1.2 > 1
        assert not bool(S.contains(jnp.asarray([0.1, -0.1, 0.1, 0.1])))

    def test_strictly_feasible_set_validates_sample(self):
        from cvx_tpu.problem import positivity, strictly_feasible_set
        cnts = positivity(3)
        S = strictly_feasible_set(cnts, jnp.asarray([0.1, 0.2, 0.3]))
        assert np.allclose(np.asarray(S.sample), [0.1, 0.2, 0.3])
        with pytest.raises(ValueError, match="strictly"):
            strictly_feasible_set(cnts, jnp.asarray([0.1, -0.2, 0.3]))

    def test_lift_and_pullback_carry_sample(self):
        from cvx_tpu.problem import positive_orthant
        C = positive_orthant(3)
        L = C.lift(2)
        assert np.asarray(L.sample).shape == (5,)
        assert bool(L.contains(jnp.asarray(np.asarray(L.sample))))
        # pullback through x = z + F u with F the first-2-coords embedding
        z = jnp.full((3,), 0.5)
        F = jnp.asarray([[1.0, 0.0], [0.0, 1.0], [0.0, 0.0]])
        P = C.affine_pullback(z, F)
        u0 = np.asarray(P.sample)
        assert np.allclose(z + F @ u0,
                           np.asarray([1 / 3, 1 / 3, 0.5]), atol=1e-6)
        assert bool(P.contains(jnp.asarray(u0)))


class TestColdStartTrustCap:
    """The fused dual kernel's far-field trust cap: a cold start on an
    extreme-concentration instance (few atoms carrying large mass, so the
    optimal multiplier is lam* ~ log n) must converge within the default
    16 Newton steps.  Without the cap the Newton direction from z ~ 0 is
    O(grad/hess) = O(100+) and all line-search halvings overshoot — the
    n >= 1000 rows of the scaling ladder regressed exactly this way."""

    @pytest.mark.parametrize("n", [1000, 4000])
    def test_extreme_concentration_converges(self, n):
        from cvx_tpu.ops.pallas_kl_dual import kl_dual_fused
        # the bench_scaling family: nA = 3 atoms forced to carry pA ~ 0.5
        nA = 3
        IA = np.zeros(n); IA[:nA] = 1.0
        IB = np.zeros(n); IB[n // 2:] = 1.0
        H = jnp.asarray(np.stack([-IA, IB]), jnp.float32)
        u = jnp.asarray([-0.5, 0.8], jnp.float32)   # P(A) >= 0.5: lam* ~ 6
        xs, gaps, _ = kl_dual_fused(H[None], u[None], n_steps=16,
                                    interpret=True, bt=8)
        assert float(gaps[0]) < 5e-5, float(gaps[0])
        assert abs(float(jnp.sum(xs[0])) - 1.0) < 1e-5

    def test_warm_region_unaffected(self):
        """Near-feasible instances (small lam*) keep their f32-floor gap —
        the cap must be inactive when ||dz|| is already small."""
        from cvx_tpu.ops.pallas_kl_dual import kl_dual_fused
        H = _scenario(100)
        u = jnp.asarray([-0.3, 0.8], jnp.float32)
        xs, gaps, _ = kl_dual_fused(H[None], u[None], n_steps=16,
                                    interpret=True, bt=8)
        assert float(gaps[0]) < 5e-6, float(gaps[0])


class TestF32ImmuneToF64ParsLeaves:
    """Under jax_enable_x64, SolverParams float leaves canonicalize to f64
    when the params cross a jit boundary as an ARGUMENT; the f32 solver
    paths must pin step/iterate dtypes so the while_loop carries stay f32
    (otherwise: carry dtype mismatch at trace time)."""

    def _small_qp(self, dtype=jnp.float32):
        from cvx_tpu.models.qp import QP
        rng = np.random.default_rng(0)
        n, m = 8, 16
        M = rng.standard_normal((n, n))
        P = (M @ M.T + n * np.eye(n)).astype(np.float32)
        a = rng.standard_normal(n).astype(np.float32)
        G = rng.standard_normal((m, n)).astype(np.float32)
        h = (np.abs(rng.standard_normal(m)) + 1.0).astype(np.float32)
        A = rng.standard_normal((2, n)).astype(np.float32)
        x_feas = (np.ones(n) / n).astype(np.float32)
        b = (A @ x_feas).astype(np.float32)
        qp = QP.create(P, a, G, h, A, b, dtype=dtype)
        return qp, jnp.asarray(x_feas, dtype)

    @pytest.mark.parametrize("method", ["BR", "PD"])
    def test_qp_solve_f32_with_traced_pars(self, method):
        assert jax.config.jax_enable_x64  # conftest turns this on
        qp, x_feas = self._small_qp()
        pars = SolverParams(kkt_method="chol", kkt_refine=1, tol=1e-6)

        @jax.jit
        def run(pars):
            return qp.solve_jittable(x_feas, method, pars)

        sol = run(pars)   # must not raise a carry-dtype mismatch
        assert sol.x.dtype == jnp.float32
        assert float(sol.duality_gap) < 1e-4


class TestDtypeFollowsInputs:
    """QP.create / LP with no explicit dtype must follow the INPUT arrays'
    dtype — under jax_enable_x64 the old canonical-float default silently
    upcast f32 data to f64 and then an f32 x0 tripped the while_loop carry
    type check mid-trace (found by the round-3 verify drive)."""

    def _f32_parts(self):
        from cvx_tpu.models.qp import QP
        rng = np.random.default_rng(1)
        n, m = 8, 16
        M = rng.standard_normal((n, n))
        P = (M @ M.T + n * np.eye(n)).astype(np.float32)
        a = rng.standard_normal(n).astype(np.float32)
        G = rng.standard_normal((m, n)).astype(np.float32)
        h = (np.abs(rng.standard_normal(m)) + 1.0).astype(np.float32)
        return QP.create(P, a, G, h)   # NO dtype kwarg

    @pytest.mark.parametrize("method", ["BR", "PD"])
    def test_qp_create_keeps_f32(self, method):
        assert jax.config.jax_enable_x64
        qp = self._f32_parts()
        assert qp.P.dtype == jnp.float32     # followed the inputs
        sol = qp.solve_jittable(jnp.zeros((8,), jnp.float32), method,
                                SolverParams(kkt_method="chol", tol=1e-6))
        assert sol.x.dtype == jnp.float32
        assert float(sol.duality_gap) < 1e-3

    def test_lp_follows_inputs(self):
        from cvx_tpu.models.qp import LP
        lp = LP(np.ones(4, np.float32), A=np.ones((1, 4), np.float32),
                b=np.ones(1, np.float32))
        assert lp.a.dtype == jnp.float32
        lp64 = LP(np.ones(4))   # f64 input stays f64 under x64
        assert lp64.a.dtype == jnp.float64

    @pytest.mark.parametrize("method", ["BR", "PD"])
    def test_mixed_f32_x0_f64_data_promotes(self, method):
        """An f32 x0 against f64 problem data follows JAX promotion (the
        solve runs in f64) instead of crashing the carry type check."""
        from cvx_tpu.models.qp import QP
        rng = np.random.default_rng(2)
        n, m = 6, 10
        M = rng.standard_normal((n, n))
        qp = QP.create(M @ M.T + n * np.eye(n), rng.standard_normal(n),
                       rng.standard_normal((m, n)),
                       np.abs(rng.standard_normal(m)) + 1.0)
        assert qp.P.dtype == jnp.float64
        sol = qp.solve_jittable(jnp.zeros((n,), jnp.float32), method,
                                SolverParams(kkt_method="chol"))
        assert sol.x.dtype == jnp.float64
        assert float(sol.duality_gap) < 1e-7


class TestSelfReviewFixes:
    """Regressions for the round-3 self-review findings."""

    def test_certify_rescues_nan_input(self):
        """A NaN input iterate must LOSE to the finite refined primal —
        NaN comparisons are False, so score_ref <= score_in alone would
        keep the broken input and return a NaN gap."""
        n, k = 16, 1
        H = jnp.zeros((k, n), jnp.float64).at[0, :4].set(-1.0)
        u = jnp.asarray([-0.3])
        A = jnp.ones((1, n), jnp.float64)
        b = jnp.ones((1,), jnp.float64)
        x_nan = jnp.full((n,), jnp.nan, jnp.float64)
        z0 = jnp.asarray([1.0, 0.0], jnp.float64)
        cert = kl_certify(H, u, A, b, x_nan, z0=z0, polish_steps=8)
        assert bool(jnp.all(jnp.isfinite(cert.x)))
        assert float(cert.gap) < 1e-8
        assert float(cert.ineq_res) < 1e-8

    def test_certified_batch_dim_over_8(self):
        """k = 9 inequality rows (dual dim 11): the certified route's
        dim > 5 branch reaches _small_solve above the unrolled-Cholesky
        cutoff (a Cholesky + triangular solve) and still certify 1e-8."""
        n, k, B = 24, 9, 4
        rng = np.random.default_rng(5)
        rows = np.zeros((k, n))
        for i in range(k):
            rows[i, rng.choice(n, 4, replace=False)] = 1.0
        H = jnp.asarray(rows)
        prob = DistKL.create(n, H=H, u=jnp.full((k,), 0.9))
        u = jnp.asarray(0.3 + 0.25 * rng.random((B, k)))
        sol = prob.solve_certified_batch(u, interpret=True)
        assert bool(jnp.all(jnp.isfinite(sol.x)))
        assert float(jnp.max(jnp.abs(sol.duality_gap))) < 1e-8
        assert not bool(jnp.any(sol.stalled))

    def test_msharded_rejects_positive_orthant_domain(self):
        """positive_orthant() is parameter-free yet nontrivial: the m-shard
        guard must reject it by PREDICATE (the sharded line search checks
        margins only), and must ACCEPT whole_space(dim) whose sample leaf
        carries no constraint axis."""
        from cvx_tpu.parallel.constraint_shard import _check_shardable
        from cvx_tpu.problem.constraint_set import ConstraintSet
        from cvx_tpu.problem.constraints import LinearBlock
        from cvx_tpu.problem.sets import positive_orthant, whole_space
        n, m = 4, 8
        blk = LinearBlock(G=jnp.ones((m, n)), c=jnp.zeros((m,)),
                          ub=jnp.ones((m,)))
        bad = ConstraintSet(blocks=(blk,), domain=positive_orthant())
        with pytest.raises(ValueError, match="whole-space"):
            _check_shardable(bad, 2)
        ok = ConstraintSet(blocks=(blk,), domain=whole_space(n))
        _check_shardable(ok, 2)   # must not raise

    def test_structured_dispatch_no_eye_and_traced_error(self):
        """Positivity recognition is structural (no dense eye): a diagonal
        -I block with nonzero offsets must NOT be eaten as positivity, and
        traced block data raises a clear ValueError instead of a
        TracerArrayConversionError."""
        from cvx_tpu.api import _extract_structured_rows
        from cvx_tpu.problem.constraint_set import ConstraintSet
        from cvx_tpu.problem.constraints import LinearBlock, positivity
        n = 5
        lower = LinearBlock(G=-jnp.eye(n), c=jnp.zeros((n,)),
                            ub=jnp.full((n,), 2.0))   # x > -2, NOT positivity
        cnts = ConstraintSet(blocks=(positivity(n), lower))
        U, ub = _extract_structured_rows(cnts)
        assert U.shape == (n, n) and bool(jnp.all(ub == 2.0))

        def traced(G):
            cs = ConstraintSet(blocks=(LinearBlock(
                G=G, c=jnp.zeros((n,)), ub=jnp.ones((n,))),))
            return _extract_structured_rows(cs)

        with pytest.raises(ValueError, match="traced"):
            jax.jit(traced)(jnp.ones((n, n)))

    def test_strictly_feasible_set_list_sample(self):
        """A list feasible_point must be stored as an array so lift()/
        affine_pullback() work and the Domain stays a fixed-arity pytree."""
        from cvx_tpu.problem.constraints import positivity
        from cvx_tpu.problem.sets import strictly_feasible_set
        dom = strictly_feasible_set(positivity(3),
                                    feasible_point=[0.1, 0.2, 0.3])
        assert isinstance(dom.sample, jax.Array)
        lifted = dom.lift(2)
        assert lifted.sample.shape == (5,)
        assert bool(lifted.contains(jnp.asarray([0.1, 0.2, 0.3, -9.0, 9.0])))

    def test_dual_fused_A_without_r_raises(self):
        from cvx_tpu.ops.pallas_kl_dual import kl_dual_fused
        B, k, n = 2, 1, 8
        Hs = jnp.ones((B, k, n))
        u = jnp.ones((B, k))
        A = jnp.ones((B, 1, n))
        with pytest.raises(ValueError, match="together"):
            kl_dual_fused(Hs, u, A)


class TestDeepReviewFixes:
    """Regressions for the whole-core (high-effort) review findings."""

    def _infeasible_prob(self, n=16):
        I_A = np.zeros(n); I_A[:4] = 1.0
        H = jnp.asarray(-I_A)[None]          # P(A) >= 0.6 with |A|/n = 0.25
        return DistKL.create(n, H=H, u=jnp.asarray([-0.6]))

    def test_create_dtype_follows_inputs(self):
        """f32 H/u must stay f32 under jax_enable_x64 (the canonical-float
        default upcast pushed the Pallas kernel off its x32 trace guard);
        same policy QP.create got in the same round."""
        assert jax.config.jax_enable_x64
        n = 8
        prob = DistKL.create(n, H=jnp.ones((1, n), jnp.float32),
                             u=jnp.ones((1,), jnp.float32))
        assert prob.H.dtype == jnp.float32
        assert prob.r.dtype == jnp.float32
        prob64 = DistKL.create(n, H=np.ones((1, n)), u=np.ones((1,)))
        assert prob64.H.dtype == jnp.float64

    def test_solve_dual_follows_objective_dtype(self):
        """solve_dual's z0/constraints follow the dual objective's data
        dtype — an f32 problem must not silently run its whole dual
        barrier in f64."""
        n = 12
        I_A = np.zeros(n); I_A[:3] = 1.0
        prob = DistKL.create(n, H=jnp.asarray(-I_A, jnp.float32)[None],
                             u=jnp.asarray([-0.4], jnp.float32))
        sol = prob.solve(method="dual")
        assert sol.x.dtype == jnp.float32
        assert sol.lam.dtype == jnp.float32

    def test_certified_batch_fallback_iters_honest(self):
        """The beyond-kernel fallback (dual dim > 16 since the round-5
        widening; was > 8) runs its own cold-start schedule (>= 30 steps)
        and reports THAT in iters, not the kernel-sized default."""
        n, k, B = 24, 17, 2
        rng = np.random.default_rng(5)
        rows = np.zeros((k, n))
        for i in range(k):
            rows[i, rng.choice(n, 4, replace=False)] = 1.0
        prob = DistKL.create(n, H=jnp.asarray(rows), u=jnp.full((k,), 0.9))
        u = jnp.asarray(0.3 + 0.25 * rng.random((B, k)))
        sol = prob.solve_certified_batch(u, steps=16, polish_steps=4)
        assert int(sol.iters[0]) == 34        # 30 cold steps + 4 polish
        assert float(jnp.max(jnp.abs(sol.duality_gap))) < 1e-8


class TestInfraReviewFixes:
    """Regressions for the parallel/problem/infra review findings."""

    def test_checkpoint_suffix_roundtrip(self, tmp_path):
        """np.savez appends .npz to other suffixes; save/load must agree
        so any caller-picked path (e.g. 'run1.ckpt') round-trips."""
        from cvx_tpu.checkpoint import load_pytree, save_pytree
        tree = {"a": jnp.arange(4.0), "b": jnp.ones((2, 2))}
        p = str(tmp_path / "run1.ckpt")
        save_pytree(p, tree)
        back = load_pytree(p, tree)
        assert float(jnp.max(jnp.abs(back["a"] - tree["a"]))) == 0.0

    def test_batched_resume_structured(self, tmp_path):
        """The module docstring promises batched fleet runs resume for
        free: a vmapped BR_fast checkpoint (B > 1) must resume to
        certificate level, converged and unconverged instances alike."""
        from cvx_tpu.checkpoint import (load_pytree, resume_structured,
                                        save_pytree)
        from cvx_tpu.models import DistKL
        from cvx_tpu.solvers.structured import barrier_solve_structured
        n, B = 12, 3
        I_A = np.zeros(n); I_A[:3] = 1.0
        u = jnp.asarray([-0.4])        # P(A) >= 0.4, shared rows + bound
        prob = DistKL.create(n, H=jnp.asarray(-I_A)[None], u=u)
        eqs = prob.equalities
        ws = jnp.asarray([0.45, 0.55, 0.7])     # strictly feasible starts
        x0s = jax.vmap(lambda w: w * jnp.asarray(I_A) / 3
                       + (1 - w) * jnp.asarray(1 - I_A) / (n - 3))(ws)
        # partial run: few outer stages -> a mid-continuation checkpoint
        pars_short = SolverParams(outer_max_iter=3, mu=10.0, tol=1e-9)
        mid = jax.vmap(lambda x0: barrier_solve_structured(
            prob.objective, prob.H, u, eqs.A, eqs.b, x0, pars_short))(x0s)
        assert float(jnp.min(mid.duality_gap)) > 1e-9   # genuinely partial
        p = str(tmp_path / "fleet.npz")
        save_pytree(p, mid)
        restored = load_pytree(p, mid)
        pars = SolverParams(mu=10.0, tol=1e-9)
        fin = resume_structured(prob.objective, prob.H, u,
                                eqs.A, eqs.b, restored, pars)
        assert fin.x.shape == (B, n)
        assert float(jnp.max(fin.duality_gap)) < 1e-7
        assert not bool(jnp.any(fin.stalled))

    def test_msharded_cnts_accepts_whole_space_dim(self, key=jax.random.PRNGKey(9)):
        """whole_space(n) carries an (n,) interior sample with NO
        constraint axis: the spec pytree must replicate domain leaves
        (P()) instead of sharding them on the m axis — n = 36 is not
        divisible by the 8-device mesh, so a mis-sharded sample crashes."""
        from cvx_tpu.parallel import instance_mesh
        from cvx_tpu.parallel.constraint_shard import \
            barrier_solve_msharded_cnts
        from cvx_tpu.problem.constraint_set import ConstraintSet
        from cvx_tpu.problem.constraints import LinearBlock
        from cvx_tpu.problem.objective import QuadraticObjective
        from cvx_tpu.problem.sets import whole_space
        from cvx_tpu.solvers.barrier import barrier_solve
        m, n = 64, 36
        k1, k2 = jax.random.split(key)
        G = jax.random.normal(k1, (m, n)) / np.sqrt(n)
        ub = jnp.abs(G @ jnp.zeros((n,))) + \
            jax.random.uniform(k2, (m,), minval=0.5, maxval=1.0)
        blk = LinearBlock(G=G, c=jnp.zeros((m,)), ub=ub)
        cnts = ConstraintSet(blocks=(blk,), domain=whole_space(n))
        z = jnp.ones((n,)) / n
        obj = QuadraticObjective(P=jnp.eye(n), a=-z,
                                 r=jnp.asarray(0.5 * float(z @ z)))
        pars = SolverParams(tol=1e-9, mu=20.0)
        mesh = instance_mesh(8, axis="m")
        sol_sh = barrier_solve_msharded_cnts(obj, cnts, jnp.zeros((n,)),
                                             pars, mesh=mesh)
        sol_lo = barrier_solve(obj, cnts, jnp.zeros((n,)), pars)
        assert not bool(sol_sh.stalled)
        assert float(jnp.max(jnp.abs(sol_sh.x - sol_lo.x))) < 1e-6

    def test_schur_stall_exits_quickly(self, key=jax.random.PRNGKey(4)):
        """A rejected step leaves the state identical; the inner loop must
        exit instead of recomputing the same rejected step max_iter times
        per outer stage (a NaN block + violated coupling equalities kept
        the old cond true through dec=0)."""
        from cvx_tpu.parallel.schur import SeparableProblem, \
            separable_barrier_solve
        from cvx_tpu.tree import replace as tree_replace
        K, nb, mb, p = 4, 8, 4, 2
        ks = jax.random.split(key, 4)
        eye = jnp.eye(nb)
        P = jnp.tile((eye + 0.1)[None], (K, 1, 1))
        a = jax.random.normal(ks[0], (K, nb)).at[1].set(jnp.nan)
        G = jnp.tile(jnp.concatenate([eye, -eye], axis=0)[None],
                     (K, 1, 1))[:, :mb]
        u = jnp.full((K, mb), 10.0)
        C = jax.random.normal(ks[1], (K, p, nb)) / np.sqrt(nb)
        c = 0.1 * jax.random.normal(ks[2], (p,))
        prob = SeparableProblem(P=P, a=a, G=G, u=u, C=C, c=c)
        sol = separable_barrier_solve(prob, jnp.zeros((K, nb)))
        assert bool(np.asarray(sol.stalled)[1])
        # one futile iteration per outer stage at most — not max_iter each
        assert int(sol.iters) <= 200

    def test_domain_lift_zero_is_identity(self):
        from cvx_tpu.problem.sets import positive_orthant
        dom = positive_orthant(3)
        lifted = dom.lift(0)
        assert not bool(lifted.contains(jnp.asarray([1.0, -1.0, 1.0])))
        assert bool(lifted.contains(jnp.asarray([1.0, 2.0, 3.0])))

    def test_msharded_pd_f64_pars_leaves(self, key=jax.random.PRNGKey(11)):
        """The m-sharded PD gets the same f64-pars immunity as its local
        twin: f32 problem data + params crossing a jit boundary must not
        promote the carry (and ls_max falls back to the static schedule)."""
        assert jax.config.jax_enable_x64
        from cvx_tpu.parallel import instance_mesh
        from cvx_tpu.parallel.constraint_shard import \
            primal_dual_solve_msharded
        from cvx_tpu.problem.constraint_set import ConstraintSet
        from cvx_tpu.problem.constraints import LinearBlock
        from cvx_tpu.problem.objective import QuadraticObjective
        m, n = 64, 16
        k1, k2 = jax.random.split(key)
        # float(): a strong np.float64 scalar would promote G to f64
        G = jax.random.normal(k1, (m, n), jnp.float32) / float(np.sqrt(n))
        ub = jax.random.uniform(k2, (m,), jnp.float32, 0.5, 1.0)
        cnts = ConstraintSet(blocks=(LinearBlock(
            G=G, c=jnp.zeros((m,), jnp.float32), ub=ub),))
        z = jnp.ones((n,), jnp.float32) / n
        obj = QuadraticObjective(P=jnp.eye(n, dtype=jnp.float32), a=-z,
                                 r=jnp.asarray(0.5 * float(z @ z),
                                               jnp.float32))
        mesh = instance_mesh(8, axis="m")
        pars = SolverParams(tol=1e-6, kkt_method="chol")

        @jax.jit
        def run(pars):
            return primal_dual_solve_msharded(
                obj, cnts, jnp.zeros((n,), jnp.float32), pars, mesh=mesh)

        sol = run(pars)    # must not raise a carry-dtype mismatch
        assert sol.x.dtype == jnp.float32
        assert float(sol.duality_gap) < 1e-3

    def test_barrier_history_single_stage_params(self):
        """barrier_history's one-stage params now come from tree.replace
        (no hand-rolled dataclass copy)."""
        from cvx_tpu.diagnostics import barrier_history
        from cvx_tpu.models import DistKL
        n = 8
        I_A = np.zeros(n); I_A[:2] = 1.0
        prob = DistKL.create(n, H=jnp.asarray(-I_A)[None],
                             u=jnp.asarray([-0.3]))
        x0 = 0.35 * jnp.asarray(I_A) / 2 + \
            0.65 * jnp.asarray(1 - I_A) / (n - 2)
        hist = barrier_history(prob.objective, prob.inequalities, x0,
                               eqs=prob.equalities, max_stages=25)
        assert hist[-1]["gap"] < 1e-6


class TestGeneralPrior:
    """Beyond-reference capability: d_KL(Q, p) with a general strictly
    positive prior p (the reference's Dist_KL is uniform-only,
    Dist_KL.scala:218,259).  The dual closed forms change only through
    R = p/e; every route must agree."""

    def _prior(self, n, key=jax.random.PRNGKey(42)):
        w = jnp.exp(0.7 * jax.random.normal(key, (n,)))
        return w / jnp.sum(w)

    def test_inactive_constraints_recover_prior(self):
        """With only inactive inequalities, argmin d_KL(Q, p) s.t.
        sum Q = 1 is exactly Q = p — on the dual, primal-barrier and
        structured routes alike."""
        n = 16
        p = self._prior(n)
        I_A = np.zeros(n); I_A[:4] = 1.0
        prob = DistKL.create(n, H=jnp.asarray(I_A)[None],
                             u=jnp.asarray([0.999]), prior=p)  # inactive
        for method in ("dual_fast", "dual_fused", "BR", "BR_fast"):
            sol = prob.solve(method=method)
            err = float(jnp.max(jnp.abs(sol.x - p)))
            assert err < 5e-5, (method, err)
            assert not bool(sol.stalled), method

    def test_active_constraint_exponential_tilt(self):
        """With an ACTIVE bound E_Q[1_A] >= a > p(A), the optimum is the
        exponentially tilted prior q_j = p_j e^{lam h_j} / Z on A
        (h = 1_A): verify the analytic form from the returned multiplier
        and the cross-route agreement."""
        n = 20
        p = self._prior(n)
        I_A = np.zeros(n); I_A[:5] = 1.0
        a = float(jnp.sum(p[:5])) + 0.25          # force activity
        prob = DistKL.create(n, H=jnp.asarray(-I_A)[None],
                             u=jnp.asarray([-a]), prior=p)
        sol_d = prob.solve(method="dual_fast")
        sol_b = prob.solve(method="BR")
        assert float(jnp.max(jnp.abs(sol_d.x - sol_b.x))) < 2e-5
        assert abs(float(jnp.sum(sol_d.x[:5])) - a) < 1e-5   # active
        # analytic tilt: q = p exp(lam 1_A) / Z with lam = sol.lam[0]
        lam = sol_d.lam[0]
        q = p * jnp.exp(lam * jnp.asarray(I_A))
        q = q / jnp.sum(q)
        assert float(jnp.max(jnp.abs(sol_d.x - q))) < 1e-5

    def test_certified_with_prior(self):
        """The certified route hits the 1e-8 contract with a general
        prior; the measured residuals come back clean."""
        n, B = 24, 8
        p = self._prior(n, jax.random.PRNGKey(3))
        I_A = np.zeros(n); I_A[:6] = 1.0
        prob = DistKL.create(n, H=jnp.asarray(-I_A)[None],
                             u=jnp.zeros((1,)), prior=p)
        pA = float(jnp.sum(p[:6]))
        us = -jnp.linspace(pA + 0.05, min(pA + 0.3, 0.9), B)[:, None]
        sol = prob.solve_certified_batch(us, interpret=True)
        assert float(jnp.max(jnp.abs(sol.duality_gap))) < 1e-8
        assert float(jnp.max(sol.ineq_res)) < 1e-8
        assert not bool(jnp.any(sol.stalled))

    def test_host_certificate_matches_jax(self):
        """kl_gap_certificate_np(prior=...) agrees with the in-graph
        kl_dual_gap certificate."""
        from cvx_tpu.diagnostics import kl_gap_certificate_np
        from cvx_tpu.models.dist_kl import kl_dual_gap
        n, B = 16, 4
        p = self._prior(n, jax.random.PRNGKey(5))
        I_A = np.zeros(n); I_A[:4] = 1.0
        H = jnp.asarray(-I_A)[None]
        prob = DistKL.create(n, H=H, u=jnp.zeros((1,)), prior=p)
        pA = float(jnp.sum(p[:4]))
        us = -jnp.linspace(pA + 0.05, pA + 0.3, B)[:, None]
        xs = jax.vmap(lambda u: DistKL(
            H=H, u=u, A=prob.A, r=prob.r, n=n, prior=p
        ).solve_dual_newton().x)(us)
        A_full = jnp.ones((1, n))
        b_full = jnp.ones((1,))
        gaps_jax = jax.vmap(lambda u, x: kl_dual_gap(
            H, u, A_full, b_full, x, prior=p)[0])(us, xs)
        gaps_np = kl_gap_certificate_np(np.asarray(xs), H, np.asarray(us),
                                        prior=np.asarray(p))
        assert np.allclose(np.asarray(gaps_jax), gaps_np, atol=1e-9)

    def test_prior_validation(self):
        n = 8
        with pytest.raises(ValueError, match="positive"):
            DistKL.create(n, H=jnp.ones((1, n)), u=jnp.ones((1,)),
                          prior=jnp.zeros((n,)))
        with pytest.raises(ValueError, match="shape"):
            DistKL.create(n, H=jnp.ones((1, n)), u=jnp.ones((1,)),
                          prior=jnp.ones((n + 1,)))
        # normalization: unnormalized weights are accepted and scaled
        prob = DistKL.create(n, H=jnp.ones((1, n)), u=jnp.ones((1,)),
                             prior=jnp.full((n,), 3.0))
        assert abs(float(jnp.sum(prob.prior)) - 1.0) < 1e-12

    def test_certified_batch_prior_dim_over_5(self):
        """The dual-dim > 5 XLA fallback must carry the prior into the
        inner solve — constructing the uniform problem there warm-starts
        the f64 polish from the WRONG basin and every instance stalls."""
        n, k, B = 24, 5, 4
        p = self._prior(n, jax.random.PRNGKey(7))
        rng = np.random.default_rng(9)
        rows = np.zeros((k, n))
        for i in range(k):
            rows[i, rng.choice(n, 5, replace=False)] = 1.0
        prob = DistKL.create(n, H=jnp.asarray(rows), u=jnp.full((k,), 0.9),
                             prior=p)
        u = jnp.asarray(0.35 + 0.2 * rng.random((B, k)))
        sol = prob.solve_certified_batch(u)
        assert float(jnp.max(jnp.abs(sol.duality_gap))) < 1e-8
        assert not bool(jnp.any(sol.stalled))

    def test_per_instance_priors_via_vmap(self):
        """Per-INSTANCE priors need no kernel support: DistKL is a pytree,
        so vmapping over the prior leaf batches the XLA dual route —
        each instance recovers ITS OWN prior when constraints are
        inactive."""
        n, B = 12, 5
        keys = jax.random.split(jax.random.PRNGKey(8), B)
        ps = jax.vmap(lambda k: jax.nn.softmax(
            0.5 * jax.random.normal(k, (n,))))(keys)
        I_A = np.zeros(n); I_A[:3] = 1.0
        H = jnp.asarray(I_A)[None]
        u = jnp.asarray([0.999])          # inactive for every prior

        def one(p):
            prob = DistKL(H=H, u=u, A=jnp.zeros((0, n)),
                          r=jnp.zeros((0,)), n=n, prior=p)
            return prob.solve_dual_newton().x

        xs = jax.jit(jax.vmap(one))(ps)
        assert float(jnp.max(jnp.abs(xs - ps))) < 5e-9


class TestQPCertified:
    """qp_certify / QP.solve_certified: the certified-1e-8 story extended
    beyond the KL flagship to the strictly convex QP family (the
    reference's written contract SolverParams.scala:41 is family-wide)."""

    def _qp(self, n=12, m=20, p=2, dtype=jnp.float32,
            key=jax.random.PRNGKey(0)):
        from cvx_tpu.models.qp import QP
        ks = jax.random.split(key, 5)
        M = jax.random.normal(ks[0], (n, n), dtype) / float(np.sqrt(n))
        P = M @ M.T + jnp.eye(n, dtype=dtype)
        z = jax.random.normal(ks[1], (n,), dtype)
        a = -(P @ z)                                   # optimum near z
        G = jax.random.normal(ks[2], (m, n), dtype) / float(np.sqrt(n))
        h = G @ jnp.zeros((n,)) + \
            jax.random.uniform(ks[3], (m,), dtype, 0.1, 0.6)  # 0 feasible
        A = jax.random.normal(ks[4], (p, n), dtype) / float(np.sqrt(n))
        b = jnp.zeros((p,), dtype)                     # 0 on A x = b
        return QP.create(P, a, G, h, A, b, dtype=dtype)

    def test_certified_f32_reaches_1e8(self):
        """An f32 PD solve (floors ~1e-5) certified into f64: measured gap
        beats the written 1e-8 contract with clean residuals."""
        qp = self._qp()
        pars = SolverParams(tol=1e-5, kkt_method="chol")
        x0 = jnp.zeros((12,), jnp.float32)
        raw = qp.solve_jittable(x0, "PD", pars)
        sol = qp.solve_certified(x0, pars)
        assert sol.x.dtype == jnp.float64
        assert float(jnp.abs(sol.duality_gap)) < 1e-8
        assert float(sol.ineq_res) < 1e-10
        assert float(sol.eq_gap) < 1e-10
        assert not bool(sol.stalled)
        # the certificate genuinely sharpened the f32 result
        from cvx_tpu.models.qp import qp_certify
        cert_raw = qp_certify(qp.P, qp.a, qp.G, qp.h, qp.A, qp.b,
                              raw.x, raw.lam, raw.nu, polish_steps=0)
        assert float(jnp.abs(sol.duality_gap)) < float(
            jnp.abs(cert_raw.gap))

    def test_certificate_is_valid_bound(self):
        """The dual value is a TRUE lower bound for ANY lam >= 0: even a
        deliberately perturbed multiplier gives gap >= 0 at the f64
        optimum (never a negative 'certificate')."""
        from cvx_tpu.models.qp import qp_certify
        qp = self._qp(dtype=jnp.float64)
        x0 = jnp.zeros((12,))
        sol = qp.solve_jittable(x0, "PD", SolverParams(tol=1e-10,
                                                       kkt_method="chol"))
        lam_bad = sol.lam * 1.7 + 0.05                 # valid but lousy
        cert = qp_certify(qp.P, qp.a, qp.G, qp.h, qp.A, qp.b,
                          sol.x, lam_bad, sol.nu, polish_steps=0)
        assert float(cert.gap) >= -1e-12
        # with polish the lousy multipliers recover the tight bound
        cert_p = qp_certify(qp.P, qp.a, qp.G, qp.h, qp.A, qp.b,
                            sol.x, lam_bad, sol.nu, polish_steps=4)
        assert float(jnp.abs(cert_p.gap)) < 1e-9

    def test_active_constraints(self):
        """Binding rows carry positive polished multipliers and the
        refined primal sits ON the active face to f64 accuracy."""
        from cvx_tpu.models.qp import QP, qp_certify
        n = 6
        P = jnp.eye(n)
        a = -jnp.ones((n,))                  # unconstrained opt at 1
        G = jnp.eye(n)[:2]
        h = jnp.asarray([0.3, 0.5])          # x0 <= 0.3, x1 <= 0.5 BIND
        qp = QP.create(P, a, G, h)
        sol = qp.solve_jittable(jnp.zeros((n,)), "PD",
                                SolverParams(tol=1e-8, kkt_method="chol"))
        cert = qp_certify(qp.P, qp.a, qp.G, qp.h, qp.A, qp.b,
                          sol.x, sol.lam, sol.nu)
        assert float(jnp.abs(cert.gap)) < 1e-10
        assert float(jnp.min(cert.lam)) > 0.1          # both rows bind
        assert abs(float(cert.x[0]) - 0.3) < 1e-9
        assert abs(float(cert.x[1]) - 0.5) < 1e-9
        assert float(jnp.max(jnp.abs(cert.x[2:] - 1.0))) < 1e-9

    def test_vmapped_certified_batch(self):
        """qp_certify is jittable/vmappable: a batch of f32 QP solves
        certified in one fused f64 pass, every instance to 1e-8."""
        from cvx_tpu.models.qp import qp_certify
        qp = self._qp(n=10, m=25, p=2)     # m + p > n: singular dual Hessian
        B = 6
        shifts = jnp.linspace(0.0, 0.5, B).astype(jnp.float32)
        pars = SolverParams(tol=1e-5, kkt_method="chol")

        def solve_one(s):
            from cvx_tpu.models.qp import QP
            q2 = QP.create(qp.P, qp.a + s, qp.G, qp.h, qp.A, qp.b,
                           dtype=jnp.float32)
            sol = q2.solve_jittable(jnp.zeros((10,), jnp.float32), "PD",
                                    pars)
            return qp_certify(q2.P, q2.a, q2.G, q2.h, q2.A, q2.b,
                              sol.x, sol.lam, sol.nu)

        certs = jax.jit(jax.vmap(solve_one))(shifts)
        assert float(jnp.max(jnp.abs(certs.gap))) < 1e-8
        assert float(jnp.max(certs.ineq_res)) < 1e-10
        assert float(jnp.max(certs.eq_res)) < 1e-10

    def test_diagqp_certified(self):
        """The structured family's certified finish: diagonal P keeps the
        P solves O(n); positivity rows join the certificate system."""
        from cvx_tpu.models.qp import DiagQP
        n, k = 24, 2
        rng = np.random.default_rng(3)
        c = jnp.asarray(0.5 + rng.random(n))
        a = jnp.asarray(rng.standard_normal(n))
        U = jnp.asarray(rng.random((k, n)))
        x_ref = jnp.full((n,), 0.5)
        ub = U @ x_ref + 0.2
        prob = DiagQP(c=c, a=a, U=U, ub=ub,
                      A=jnp.ones((1, n)), b=jnp.asarray([float(n) / 2]))
        sol = prob.solve(SolverParams(tol=1e-9, kkt_method="chol"))
        cert = prob.solve_certified(x_ref)
        assert float(jnp.abs(cert.duality_gap)) < 1e-8
        assert float(cert.ineq_res) < 1e-10
        assert float(cert.eq_gap) < 1e-10
        assert not bool(cert.stalled)
        assert float(jnp.max(jnp.abs(cert.x - sol.x))) < 1e-5

    def test_lp_certified_raises(self):
        from cvx_tpu.models.qp import LP
        lp = LP(jnp.ones(4), A=jnp.ones((1, 4)), b=jnp.ones(1))
        with pytest.raises(ValueError, match="singular"):
            lp.solve_certified(jnp.full((4,), 0.25))


class TestBatchedBarrierResume:
    def test_batched_resume_barrier(self, tmp_path):
        """resume_barrier (dense route) accepts a vmapped Solution: mixed
        converged/unconverged instances resume to certificate level (the
        structured twin is covered in TestInfraReviewFixes)."""
        from cvx_tpu.checkpoint import (load_pytree, resume_barrier,
                                        save_pytree)
        from cvx_tpu.models import DistKL
        from cvx_tpu.solvers.barrier import barrier_solve
        n, B = 10, 3
        I_A = np.zeros(n); I_A[:3] = 1.0
        prob = DistKL.create(n, H=jnp.asarray(-I_A)[None],
                             u=jnp.asarray([-0.4]))
        cnts = prob.inequalities
        eqs = prob.equalities
        ws = jnp.asarray([0.45, 0.55, 0.7])
        x0s = jax.vmap(lambda w: w * jnp.asarray(I_A) / 3
                       + (1 - w) * jnp.asarray(1 - I_A) / (n - 3))(ws)
        pars_short = SolverParams(outer_max_iter=3, mu=10.0, tol=1e-9)
        mid = jax.vmap(lambda x0: barrier_solve(
            prob.objective, cnts, x0, pars_short, eqs=eqs))(x0s)
        assert float(jnp.min(mid.duality_gap)) > 1e-9   # genuinely partial
        p = str(tmp_path / "dense_fleet")
        save_pytree(p, mid)
        back = load_pytree(p, mid)
        fin = resume_barrier(prob.objective, cnts, back,
                             SolverParams(mu=10.0, tol=1e-9), eqs=eqs)
        assert fin.x.shape == (B, n)
        assert float(jnp.max(fin.duality_gap)) < 1e-8
        assert not bool(jnp.any(fin.stalled))
