"""Round-2 regression tests: measured gap certificates, per-instance status,
violated-constraint reporting, svd/non-symmetric solves, dual-route
polish.

Each test pins one VERDICT/ADVICE item from round 1:
  * the kl_dual_gap certificate is a measured, true bound;
  * a batch with one poisoned instance must flag exactly that instance
    (Solution.status, SURVEY.md section 7.3 exceptions->masks);
  * infeasibility reports must NAME the violated constraints
    (FeasibilityReport.scala:32-47);
  * svd_solve / lin_solve port MatrixUtils.scala:712-729 and the
    non-symmetric branch of SymmetricLinearSystem.scala:28-55.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cvx_tpu.models import DistKL
from cvx_tpu.models.dist_kl import kl_dual_gap
from cvx_tpu.ops import lin_solve, svd_solve, sym_solve_eig
from cvx_tpu.ops.testmat import (decaying_spectrum, nasty_rhs,
                                 random_orthogonal)
from cvx_tpu.solvers import InfeasibleProblemError, SolverParams
from cvx_tpu.solvers.phase1 import violated_constraints


def bench_family(n, pA=0.3, pB=0.7, dtype=jnp.float64):
    """The bench.py scenario family: P(A) >= pA (active), P(B) <= pB."""
    nA, nB = 3, n // 2
    I_A = np.zeros(n); I_A[:nA] = 1.0
    I_B = np.zeros(n); I_B[nB:] = 1.0
    H = jnp.asarray(np.stack([-I_A, I_B]), dtype)
    u = jnp.asarray([-pA, pB], dtype)
    w = pA + 0.05
    x0 = jnp.asarray((w / nA) * I_A + ((1.0 - w) / (n - nA)) * (1 - I_A),
                     dtype)
    return DistKL.create(n, H=H, u=u, dtype=dtype), x0


class TestMeasuredGap:
    def test_certificate_is_true_bound(self):
        """gap_cert = f(x) - g(z) >= f(x) - p* for any feasible-ish x: verify
        against the analytically converged solution."""
        n = 50
        prob, x0 = bench_family(n)
        pars = SolverParams(tol=1e-10, mu=30.0, kkt_method="chol")
        sol = prob.solve_jittable(x0, method="BR_fast", pars=pars)
        A = jnp.ones((1, n), jnp.float64)
        b = jnp.ones((1,), jnp.float64)
        gap, z = kl_dual_gap(prob.H, prob.u, A, b, sol.x)
        # dual value is a lower bound on the optimum, so gap >= f(x) - p*.
        # x is essentially optimal here, so 0 <= gap and gap is tiny.
        assert float(gap) >= -1e-12
        assert float(gap) < 1e-8
        # lam is dual feasible
        assert bool(jnp.all(z[:2] >= 0))

    def test_certificate_detects_bad_iterate(self):
        """A non-optimal iterate must NOT certify a small gap."""
        n = 50
        prob, x0 = bench_family(n)
        A = jnp.ones((1, n), jnp.float64)
        b = jnp.ones((1,), jnp.float64)
        gap, _ = kl_dual_gap(prob.H, prob.u, A, b, x0)
        assert float(gap) > 1e-3  # x0 is feasible but far from optimal


class TestPerInstanceStatus:
    def test_poisoned_instance_flagged(self):
        """One NaN-poisoned instance in a vmapped batch: exactly that
        instance reports stalled, keeps a FINITE frozen iterate (the 0*NaN
        guard), and the healthy instances still converge."""
        n = 16
        prob0, x0 = bench_family(n, pA=0.2, pB=0.8)
        us = jnp.tile(prob0.u[None], (4, 1))
        us = us.at[2, 0].set(jnp.nan)  # poison instance 2

        def solve_one(u):
            prob = DistKL.create(n, H=prob0.H, u=u)
            return prob.solve_jittable(
                x0, method="BR_fast",
                pars=SolverParams(tol=1e-8, mu=30.0))

        sols = jax.jit(jax.vmap(solve_one))(us)
        stalled = np.asarray(sols.stalled)
        status = np.asarray(sols.status)
        assert stalled.tolist() == [False, False, True, False]
        assert status[2] == 2 and status[0] == 0
        # poisoned instance's iterate stayed finite (frozen at x0)
        assert bool(jnp.all(jnp.isfinite(sols.x[2])))
        np.testing.assert_allclose(np.asarray(sols.x[2]), np.asarray(x0))
        # healthy instances converged
        assert float(jnp.max(sols.duality_gap[np.array([0, 1, 3])])) < 1e-7

    def test_solve_stats_reports_stalls(self):
        from cvx_tpu.diagnostics import solve_stats

        n = 16
        prob0, x0 = bench_family(n, pA=0.2, pB=0.8)
        us = jnp.tile(prob0.u[None], (3, 1)).at[1, 0].set(jnp.nan)

        def solve_one(u):
            prob = DistKL.create(n, H=prob0.H, u=u)
            return prob.solve_jittable(x0, method="BR_fast",
                                       pars=SolverParams(tol=1e-8))

        stats = solve_stats(jax.jit(jax.vmap(solve_one))(us))
        assert stats["stalled_frac"] == pytest.approx(1.0 / 3.0)
        assert stats["stalled_instances"] == [1]


class TestViolatedConstraints:
    def test_infeasible_kl_names_probability_rows(self):
        """infeasible_kl_1 (OptimizationProblems.scala:379-405): the report
        must NAME the two violated probability constraints."""
        n = 20
        I_A = np.zeros(n); I_A[:3] = 1.0
        I_B = np.zeros(n); I_B[n // 2:] = 1.0
        H = jnp.asarray(np.stack([-I_A, -I_B]))
        u = jnp.asarray([-0.51, -0.51])
        prob = DistKL.create(n, H=H, u=u)
        with pytest.raises(InfeasibleProblemError) as ei:
            prob.solve(method="BR")
        names = [name for name, _, _ in ei.value.violations]
        # at least one of the two probability rows is violated at the
        # phase-I candidate (both cannot hold simultaneously)
        assert any(nm.startswith("rows_leq[") for nm in names), names
        assert any("rows_leq" in nm for nm in str(ei.value).split(";")[-1:]
                   ), str(ei.value)

    def test_listing_indices_and_margins(self):
        from cvx_tpu.problem.constraint_set import ConstraintSet
        from cvx_tpu.problem.constraints import positivity, rows_leq

        n = 4
        cnts = ConstraintSet(blocks=(
            rows_leq(jnp.eye(n), jnp.full((n,), 0.5), label="cap"),
            positivity(n),
        ))
        x = jnp.asarray([0.9, 0.1, -0.2, 0.6])
        v = violated_constraints(cnts, x)
        names = {name for name, _, _ in v}
        assert names == {"cap[0]", "cap[3]", "positivity[2]"}
        # worst first
        assert v[0][0] == "cap[0]" and v[0][2] == pytest.approx(0.4)
        # global indices: caps occupy 0..3, positivity 4..7
        idx = {name: gi for name, gi, _ in v}
        assert idx["positivity[2]"] == 4 + 2


class TestSvdSolve:
    def test_svd_vs_eig_on_ill_conditioned(self, key):
        """Port of MatrixUtilsTests.scala:418-459: on an ill-conditioned
        symmetric system with an adversarial rhs, the SVD solve must match
        the spectral solve's residual quality."""
        n = 40
        k1, k2 = jax.random.split(key)
        d = decaying_spectrum(n, 1e12)
        U = random_orthogonal(k1, n)
        Q = U @ jnp.diag(d) @ U.T
        b = nasty_rhs(k2, d, U)
        x_eig, res_eig = sym_solve_eig(Q, b)
        x_svd, res_svd = svd_solve(Q, b)
        assert float(res_svd) < 1e-4
        assert float(res_svd) < 10.0 * float(res_eig) + 1e-9

    def test_nonsymmetric_solve(self, key):
        """svd_solve handles general square systems (the reference's
        svdSolve, MatrixUtils.scala:712-729)."""
        n = 30
        A = jax.random.normal(key, (n, n))
        x_true = jax.random.normal(jax.random.split(key)[0], (n,))
        b = A @ x_true
        x, res = svd_solve(A, b)
        assert float(jnp.max(jnp.abs(x - x_true))) < 1e-8
        assert float(res) < 1e-10

    def test_lin_solve_dispatch(self, key):
        """lin_solve mirrors SymmetricLinearSystem.scala:28-55: symmetric
        input -> Cholesky path; non-symmetric -> SVD path.  Both must solve."""
        n = 20
        M = jax.random.normal(key, (n, n))
        S = M @ M.T + jnp.eye(n)           # SPD
        x_true = jnp.arange(1.0, n + 1.0)
        xs, rs = lin_solve(S, S @ x_true)
        assert float(jnp.max(jnp.abs(xs - x_true))) < 1e-8
        N = M + 0.5 * jnp.eye(n)           # non-symmetric
        xn, rn = lin_solve(N, N @ x_true)
        assert float(jnp.max(jnp.abs(xn - x_true))) < 1e-6


class TestDualPolish:
    def test_f32_dual_route_mass_conservation(self):
        """The f32 closed-form dual route must recover sum(q) = 1 to 1e-4
        BEFORE renormalization (round-1 caveat: ~8e-2 on tail instances)."""
        n = 100
        # 5 probes spanning the family (was 16: the round-4 suite audit
        # found this test 23 s — the tail behavior it pins shows up at the
        # ends and midpoint, not between neighboring pA values)
        pAs = np.array([0.2, 0.275, 0.35, 0.425, 0.5])
        worst = 0.0
        for pA in pAs:
            prob, _ = bench_family(n, pA=float(pA), pB=0.7,
                                   dtype=jnp.float32)
            sol = prob.solve(method="dual")
            z = jnp.concatenate([sol.lam, sol.nu])
            d = prob.neg_dual_objective()
            q_raw = d.R * jnp.exp(-(d.B.T @ z))  # pre-renormalization
            worst = max(worst, abs(float(jnp.sum(q_raw)) - 1.0))
        assert worst < 1e-4, worst

    def test_polish_improves_f64_gap(self):
        n = 30
        prob, _ = bench_family(n)
        # solve the dual WITHOUT the polish: the barrier-on-the-dual stop
        # leaves a measurably worse dual value than the polished route
        from cvx_tpu.duality import solve_dual
        sol_raw = solve_dual(prob.neg_dual_objective(), prob.num_ineq_dual,
                             prob.dual_dim, prob.primal_optimum,
                             method="BR", polish_steps=0)
        sol = prob.solve(method="dual")
        neg_dual = prob.neg_dual_objective()
        z_raw = jnp.concatenate([sol_raw.lam, sol_raw.nu])
        z = jnp.concatenate([sol.lam, sol.nu])
        # the polish IMPROVES the dual value (minimizing -L*): strictly
        # better than the unpolished stop, not just 'both small'
        v_raw = float(neg_dual.value(z_raw))
        v_pol = float(neg_dual.value(z))
        assert v_pol <= v_raw
        primal_val = float(sol.x @ jnp.log(n * sol.x))
        dual_val = -v_pol
        gap_pol = abs(primal_val - dual_val)
        assert gap_pol < 1e-8
        # and the unpolished gap is genuinely worse (the behavior the
        # test name claims)
        p_raw = float(sol_raw.x @ jnp.log(n * sol_raw.x))
        assert abs(p_raw - (-v_raw)) > gap_pol


class TestDualFastRoutes:
    """dual_fast (XLA projected-Newton) and dual_fused (whole-solve Pallas
    kernel, here in the interpreter): accuracy vs analytic optimum and the
    measured certificate."""

    def _analytic(self, n, pA):
        xs = np.full(n, (1 - pA) / (n - 3))
        xs[:3] = pA / 3
        return xs

    @pytest.mark.parametrize("method", ["dual_fast", "dual_fused"])
    def test_matches_analytic(self, method):
        n, pA = 100, 0.4
        prob, _ = bench_family(n, pA=pA, pB=0.7)
        sol = (prob.solve_dual_fused(interpret=True)
               if method == "dual_fused" else prob.solve(method=method))
        xs = self._analytic(n, pA)
        assert float(jnp.max(jnp.abs(sol.x - xs))) < 1e-8
        # the reported duality_gap is MEASURED (a valid bound), tiny in f64
        assert 0 <= float(sol.duality_gap) + 1e-12 < 1e-8
        assert not bool(sol.stalled)

    def test_dual_fused_fallback_shapes(self):
        """k=3 rows or extra equalities dispatch to the XLA dual_fast."""
        n = 30
        I_A = np.zeros(n); I_A[:3] = 1.0
        rows = np.stack([-I_A, np.roll(I_A, 5), np.roll(I_A, 10)])
        prob = DistKL.create(n, H=jnp.asarray(rows),
                             u=jnp.asarray([-0.2, 0.9, 0.9]))
        sol = prob.solve(method="dual_fused")  # no Pallas path for k=3
        assert float(sol.duality_gap) < 1e-10
        assert float(jnp.abs(jnp.sum(sol.x) - 1.0)) < 1e-8

    def test_dual_fast_batched_certificate(self):
        """vmapped dual_fast over a batch: every instance's measured gap is
        a true bound and tiny in f64."""
        n = 64
        prob0, _ = bench_family(n, pA=0.3, pB=0.7)
        pAs = jnp.linspace(0.2, 0.45, 16)

        def solve_one(pA):
            u = jnp.stack([-pA, jnp.asarray(0.7)])
            prob = DistKL.create(n, H=prob0.H, u=u)
            s = prob.solve_dual_newton()
            return s.x, s.duality_gap

        xs, gaps = jax.jit(jax.vmap(solve_one))(pAs)
        assert float(jnp.max(gaps)) < 1e-9
        from cvx_tpu.diagnostics import kl_gap_certificate_np

        u_np = np.column_stack([-np.asarray(pAs), np.full(16, 0.7)])
        cert = kl_gap_certificate_np(np.asarray(xs), np.asarray(prob0.H),
                                     u_np)
        assert float(cert.max()) < 1e-9
        assert float(cert.min()) > -1e-12
