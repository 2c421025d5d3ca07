"""M4: Kullback–Leibler distance minimization — the flagship workload.

Ports the reference's KL problem zoo with analytic solutions
(OptimizationProblems.scala:131-405): kl_1/kl_1A (inequality form),
kl_2/kl_2A (equality form), infeasible_kl_1.  Each problem is solved via
the primal barrier, primal primal-dual, AND the closed-form dual, and all
routes must agree with the analytic minimizer within the reference's
acceptance tolerance |f - f*| < 1e-2 (Runner.scala:30, KnownMinimizer).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cvx_tpu.models import DistKL
from cvx_tpu.solvers import InfeasibleProblemError, SolverParams

TOL_SOLUTION = 1e-2


def kl1_analytic(n: int) -> np.ndarray:
    """OptimizationProblems.scala:136-141."""
    x = np.zeros(n)
    if n <= 15:
        x[: n // 2] = 1.8 / n
        x[n // 2:] = 0.2 / n
    else:
        x[:3] = 0.12
        x[n // 2:] = 0.2 / n
        x[3: n // 2] = 1.08 / (n - 6)
    return x


def kl2_analytic(n: int) -> np.ndarray:
    """OptimizationProblems.scala:249-251."""
    x = np.zeros(n)
    x[:3] = 0.36 / 3
    x[n // 2:] = 0.2 / n
    x[3: n // 2] = 1.08 / (n - 6)
    return x


def kl_value(x: np.ndarray) -> float:
    n = len(x)
    x = np.maximum(x, 1e-300)
    return float(np.sum(x * np.log(n * x)))


def kl1_problem(n: int) -> DistKL:
    """P(A) >= 0.36, P(B) <= 0.1 with A = {0,1,2}, B = {n/2..n-1}
    (OptimizationProblems.scala:217-244 kl_1A)."""
    I_A = np.zeros(n); I_A[:3] = 1.0
    I_B = np.zeros(n); I_B[n // 2:] = 1.0
    H = jnp.asarray(np.stack([-I_A, I_B]))
    u = jnp.asarray([-0.36, 0.1])
    return DistKL.create(n, H=H, u=u)


def kl2_problem(n: int) -> DistKL:
    """P(A) = 0.36, P(B) = 0.1 as equalities
    (OptimizationProblems.scala:341-369 kl_2A)."""
    I_A = np.zeros(n); I_A[:3] = 1.0
    I_B = np.zeros(n); I_B[n // 2:] = 1.0
    A = jnp.asarray(np.stack([I_A, I_B]))
    r = jnp.asarray([0.36, 0.1])
    return DistKL.create(n, A=A, r=r)


class TestKL1:
    @pytest.mark.parametrize("n", [20])
    @pytest.mark.parametrize("method", ["dual", "BR", "PD"])
    def test_matches_analytic(self, n, method):
        prob = kl1_problem(n)
        sol = prob.solve(method=method)
        x = np.asarray(sol.x)
        f_star = kl_value(kl1_analytic(n))
        assert abs(kl_value(x) - f_star) < TOL_SOLUTION, (method, x[:6])
        # constraints hold
        assert x[:3].sum() >= 0.36 - 1e-4
        assert x[n // 2:].sum() <= 0.1 + 1e-4
        assert abs(x.sum() - 1.0) < 1e-4

    def test_primal_dual_cross_check(self):
        """MinimizationTests.scala:40-45: solve directly and via the dual,
        compare objective values."""
        prob = kl1_problem(20)
        f_br = kl_value(np.asarray(prob.solve(method="BR").x))
        f_dual = kl_value(np.asarray(prob.solve(method="dual").x))
        assert abs(f_br - f_dual) < TOL_SOLUTION


class TestKL2:
    @pytest.mark.parametrize("n", [20])
    @pytest.mark.parametrize("method", ["dual", "BR", "PD"])
    def test_matches_analytic(self, n, method):
        prob = kl2_problem(n)
        sol = prob.solve(method=method)
        x = np.asarray(sol.x)
        f_star = kl_value(kl2_analytic(n))
        assert abs(kl_value(x) - f_star) < TOL_SOLUTION, (method, x[:6])
        assert abs(x[:3].sum() - 0.36) < 1e-4
        assert abs(x[n // 2:].sum() - 0.1) < 1e-4


class TestInfeasible:
    def test_infeasible_kl_detected(self):
        """P(A) >= 0.51 and P(B) >= 0.51 on disjoint A, B: must be flagged
        (OptimizationProblems.scala:379-405, FeasibilityTests.scala:125-131).
        """
        n = 20
        I_A = np.zeros(n); I_A[:3] = 1.0
        I_B = np.zeros(n); I_B[n // 2:] = 1.0
        H = jnp.asarray(np.stack([-I_A, -I_B]))
        u = jnp.asarray([-0.51, -0.51])
        prob = DistKL.create(n, H=H, u=u)
        rep = prob.feasibility()
        assert not bool(rep.strictly_feasible)
        with pytest.raises(InfeasibleProblemError):
            prob.solve(method="BR")

    def test_feasible_report(self):
        rep = kl1_problem(20).feasibility()
        assert bool(rep.strictly_feasible)


class TestDualGap:
    def test_dual_route_tight_gap(self):
        """The dual route must certify near-zero duality gap: L*(z*) equals
        the primal optimum value up to solver tolerance."""
        prob = kl1_problem(20)
        sol = prob.solve(method="dual")
        z = jnp.concatenate([sol.lam, sol.nu])
        neg_dual = prob.neg_dual_objective()
        primal_val = kl_value(np.asarray(sol.x))
        dual_val = -float(neg_dual.value(z))
        assert abs(primal_val - dual_val) < 1e-5


class TestBatched:
    def test_vmap_dual_solve(self, key):
        """Batch of KL instances with different bounds, one jitted vmap."""
        n = 16
        I_A = np.zeros(n); I_A[:3] = 1.0
        I_B = np.zeros(n); I_B[n // 2:] = 1.0
        H = jnp.asarray(np.stack([-I_A, I_B]))

        pAs = jnp.linspace(0.25, 0.45, 8)

        def solve_one(pA):
            u = jnp.stack([-pA, jnp.asarray(0.1)])
            prob = DistKL.create(n, H=H, u=u)
            return prob.solve_jittable(
                feasible_point=jnp.full((n,), 1.0 / n),
                method="dual",
            ).x

        xs = jax.jit(jax.vmap(solve_one))(pAs)
        assert xs.shape == (8, n)
        # each instance sums to ~1 and satisfies its own P(A) bound
        sums = jnp.sum(xs, axis=1)
        assert float(jnp.max(jnp.abs(sums - 1.0))) < 1e-4
        pA_real = jnp.sum(xs[:, :3], axis=1)
        assert bool(jnp.all(pA_real >= pAs - 1e-4))

    def test_vmap_primal_barrier_solve(self, key):
        n = 16
        I_A = np.zeros(n); I_A[:3] = 1.0
        I_B = np.zeros(n); I_B[n // 2:] = 1.0
        H = jnp.asarray(np.stack([-I_A, I_B]))
        pAs = jnp.linspace(0.25, 0.45, 4)

        # NOTE: this test previously passed the UNIFORM start as the
        # feasible point against a P(B) <= 0.1 bound it violates (P(B)
        # uniform = 0.5): the barrier could not move and returned x0, and
        # the old finiteness + sum-to-1 asserts could not tell.  The start
        # below strictly satisfies both rows and the pA bound BINDS.
        def start(pA):
            w = pA + 0.05
            return jnp.asarray(np.where(np.arange(n) < 3, 1.0, 0.0)) * \
                (w / 3) + jnp.asarray(
                    np.where(np.arange(n) < 3, 0.0, 1.0)) * \
                ((1.0 - w) / (n - 3))

        def solve_one(pA):
            u = jnp.stack([-pA, jnp.asarray(0.6)])
            prob = DistKL.create(n, H=H, u=u)
            return prob.solve_jittable(
                feasible_point=start(pA), method="BR",
            ).x

        pAs = jnp.linspace(0.25, 0.45, 4)    # all above uniform P(A)=3/16
        xs = jax.jit(jax.vmap(solve_one))(pAs)
        assert bool(jnp.all(jnp.isfinite(xs)))
        assert float(jnp.max(jnp.abs(jnp.sum(xs, axis=1) - 1.0))) < 1e-6
        # the real checks: per-instance MEASURED gap + residuals and the
        # BINDING row actually holds with mass moved onto A
        from cvx_tpu.models.dist_kl import kl_dual_gap
        A_full = jnp.ones((1, n)); b_full = jnp.ones((1,))
        for i, pA in enumerate(pAs):
            u = jnp.stack([-pA, jnp.asarray(0.6)])
            gap, _ = kl_dual_gap(H, u, A_full, b_full, xs[i])
            assert abs(float(gap)) < 1e-7, i
            assert abs(float(jnp.sum(xs[i][:3])) - float(pA)) < 1e-5, i
