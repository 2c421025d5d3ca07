"""Cross-route fuzz: random problem instances solved by INDEPENDENT routes
must agree.

The reference cross-checks each Duality-capable problem primal-vs-dual
(MinimizationTests.scala:40-45); here the check runs over random families
and over every route pair — the strongest internal-consistency evidence the
framework can produce without external solvers.  Fixed seeds, f64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cvx_tpu.models import DistKL
from cvx_tpu.models.qp import QP, DiagQP, LP
from cvx_tpu.solvers import SolverParams


def _kl_value(x, n):
    x = np.maximum(np.asarray(x), 1e-300)
    return float(np.sum(x * np.log(n * x)))


class TestKLRoutesAgree:
    @pytest.mark.parametrize("seed", [0, 1, 2, 3])
    def test_five_routes(self, seed):
        """dual (barrier), dual_fast, dual_fused (interpret), BR_fast, BR
        on a random 2-row scenario instance: all objectives within 1e-6."""
        rng = np.random.default_rng(seed)
        n = 40
        nA = rng.integers(2, 6)
        idx = rng.permutation(n)
        I_A = np.zeros(n); I_A[idx[:nA]] = 1.0
        I_B = np.zeros(n); I_B[idx[nA:nA + n // 2]] = 1.0
        pA = float(rng.uniform(0.15, 0.45))
        pB = float(rng.uniform(0.55, 0.85))
        H = jnp.asarray(np.stack([-I_A, I_B]))
        u = jnp.asarray([-pA, pB])
        prob = DistKL.create(n, H=H, u=u)
        w = pA + 0.05
        x0 = jnp.asarray((w / nA) * I_A + ((1 - w) / (n - nA)) * (1 - I_A))

        vals = {}
        for method in ("dual", "dual_fast"):
            vals[method] = _kl_value(prob.solve(method=method).x, n)
        vals["dual_fused"] = _kl_value(
            prob.solve_dual_fused(interpret=True).x, n)
        pars = SolverParams(tol=1e-10, mu=30.0, kkt_method="chol")
        vals["BR_fast"] = _kl_value(
            prob.solve_jittable(x0, method="BR_fast", pars=pars).x, n)
        vals["BR"] = _kl_value(
            prob.solve_jittable(x0, method="BR",
                                pars=SolverParams(tol=1e-9)).x, n)
        lo, hi = min(vals.values()), max(vals.values())
        assert hi - lo < 1e-6, vals


class TestQPRoutesAgree:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_br_vs_pd(self, seed):
        """Random dense QP with inequalities + equalities: barrier and
        primal-dual optima agree."""
        rng = np.random.default_rng(100 + seed)
        n, m, p = 20, 12, 3
        M = rng.normal(size=(n, n)) / np.sqrt(n)
        P = M @ M.T + np.eye(n)
        a = rng.normal(size=n)
        G = rng.normal(size=(m, n)) / np.sqrt(n)
        h = rng.uniform(0.5, 1.5, size=m)       # x0 = 0 strictly feasible
        A = rng.normal(size=(p, n)) / np.sqrt(n)
        b = np.zeros(p)                          # x0 = 0 on Ax = b
        qp = QP.create(P, a, G=G, h=h, A=A, b=b)
        x0 = jnp.zeros((n,))
        pars = SolverParams(tol=1e-9)
        f_br = float(qp.objective.value(
            qp.solve_jittable(x0, "BR", pars).x))
        f_pd = float(qp.objective.value(
            qp.solve_jittable(x0, "PD", pars).x))
        assert abs(f_br - f_pd) < 1e-6, (f_br, f_pd)

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_structured_vs_dense(self, seed):
        """Random diagonal QP (x > 0, few dense rows, one equality): the
        O(n (k+p)^2) Woodbury path matches the dense barrier path."""
        from cvx_tpu.problem.constraint_set import ConstraintSet
        from cvx_tpu.problem.constraints import positivity, rows_leq
        from cvx_tpu.problem.equality import EqualityConstraint
        from cvx_tpu.solvers.barrier import barrier_solve

        rng = np.random.default_rng(200 + seed)
        n, k = 24, 2
        c = rng.uniform(0.5, 2.0, size=n)
        a = rng.normal(size=n)
        U = np.abs(rng.normal(size=(k, n))) / np.sqrt(n)
        A = np.ones((1, n))
        b = np.ones(1)
        x0 = np.full(n, 1.0 / n)
        ub = U @ x0 + rng.uniform(0.3, 0.8, size=k)   # x0 strictly feasible

        dqp = DiagQP(c=jnp.asarray(c), a=jnp.asarray(a), U=jnp.asarray(U),
                     ub=jnp.asarray(ub), A=jnp.asarray(A), b=jnp.asarray(b))
        pars = SolverParams(tol=1e-10, mu=20.0, kkt_method="chol")
        sol_s = dqp.solve_jittable(jnp.asarray(x0), pars)

        cnts = ConstraintSet(blocks=(
            rows_leq(jnp.asarray(U), jnp.asarray(ub)),
            positivity(n)))

        class Dense:
            def value(self, x):
                return dqp.value(x)

            def grad(self, x):
                return dqp.grad(x)

            def hess(self, x):
                return jnp.diag(dqp.hess_diag(x))

        sol_d = barrier_solve(Dense(), cnts, jnp.asarray(x0),
                              SolverParams(tol=1e-10, mu=20.0),
                              eqs=EqualityConstraint(A=jnp.asarray(A),
                                                     b=jnp.asarray(b)))
        f_s = float(dqp.value(sol_s.x))
        f_d = float(dqp.value(sol_d.x))
        assert abs(f_s - f_d) < 1e-7, (f_s, f_d)

    def test_lp_structured(self):
        """LP over the simplex with one budget row: analytic solution is a
        vertex-interior blend; check against scipy-free closed reasoning —
        min a.x over the simplex is the min-coordinate vertex (relaxed by
        the budget row's inactivity)."""
        n = 12
        a = jnp.asarray(np.linspace(1.0, 2.0, n))
        lp = LP(a, A=jnp.ones((1, n)), b=jnp.ones((1,)))
        x0 = jnp.full((n,), 1.0 / n)
        sol = lp.solve_jittable(x0, SolverParams(tol=1e-10, mu=20.0))
        # optimum concentrates on coordinate 0 (smallest cost)
        assert float(sol.x[0]) > 0.999
        assert abs(float(lp.value(sol.x)) - float(a[0])) < 1e-3
