"""M5/M6: batching, sharding, Schur consensus.

Multi-chip logic runs on the 8-device virtual CPU mesh (conftest), per
SURVEY.md section 4's test strategy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cvx_tpu import ops, parallel
from cvx_tpu import problem as pb
from cvx_tpu.models import DistKL
from cvx_tpu.parallel.schur import (SeparableProblem, schur_kkt_solve,
                                    separable_barrier_solve,
                                    make_sharded_schur_solver)
from cvx_tpu.solvers import SolverParams


def _kl_batch(n, B):
    I_A = np.zeros(n); I_A[:3] = 1.0
    I_B = np.zeros(n); I_B[n // 2:] = 1.0
    H = jnp.asarray(np.stack([-I_A, I_B]))
    pAs = jnp.linspace(0.08, 0.14, B)

    def make(pA):
        u = jnp.stack([-pA, jnp.asarray(0.2)])
        return DistKL.create(n, H=H, u=u)

    return jax.vmap(make)(pAs)


class TestBatchedSolve:
    def test_vmap_solve_kl(self):
        n, B = 16, 8
        probs = _kl_batch(n, B)
        x0 = jnp.tile(jnp.full((n,), 1.0 / n), (B, 1))
        solve = parallel.vmap_solve(
            lambda p, x: p.solve_jittable(x, method="BR").x)
        xs = solve(probs, x0)
        assert xs.shape == (B, n)
        assert float(jnp.max(jnp.abs(xs.sum(1) - 1.0))) < 1e-6

    def test_shard_solve_matches_vmap(self):
        n, B = 16, 8
        probs = _kl_batch(n, B)
        x0 = jnp.tile(jnp.full((n,), 1.0 / n), (B, 1))
        fn = lambda p, x: p.solve_jittable(x, method="BR").x
        xs_local = parallel.vmap_solve(fn)(probs, x0)
        mesh = parallel.instance_mesh(8)
        xs_shard = parallel.shard_solve(fn, mesh)(probs, x0)
        assert jnp.allclose(xs_local, xs_shard, atol=1e-8)

    def test_sharded_feasibility_screen_matches_local(self):
        # the game-dual screen is embarrassingly parallel over instances:
        # shard the (B, k) bounds over the mesh axis, screen per device
        from jax import shard_map
        from jax.sharding import PartitionSpec as P

        n, B = 16, 32
        rng = np.random.default_rng(0)
        I_A = np.zeros(n); I_A[:3] = 1.0
        H = jnp.asarray(np.stack([-I_A, I_A]))
        pA = rng.uniform(0.3, 0.5, B)
        qA = pA + rng.uniform(0.05, 0.2, B)
        bad = np.zeros(B, bool); bad[::4] = True
        qA[bad] = pA[bad] - rng.uniform(0.05, 0.1, bad.sum())
        u = jnp.asarray(np.stack([-pA, qA], axis=1))
        prob = DistKL.create(n, H=H, u=jnp.zeros((2,), H.dtype))

        local = jax.jit(prob.feasibility_screen_batch)(u)
        mesh = parallel.instance_mesh(8)
        sharded = jax.jit(shard_map(
            prob.feasibility_screen_batch, mesh=mesh,
            in_specs=P("dp"), out_specs=P("dp"), check_vma=False))(u)
        assert np.array_equal(np.asarray(sharded.infeasible), bad)
        for leaf_l, leaf_s in zip(jax.tree.leaves(local),
                                  jax.tree.leaves(sharded)):
            assert jnp.allclose(leaf_l, leaf_s, atol=1e-12), leaf_l


class TestSchur:
    def _random_problem(self, key, K=8, nb=6, mb=4, p=3):
        ks = jax.random.split(key, 5)
        P = jax.vmap(lambda k: ops.random_spd(k, nb, cond=100.0))(
            jax.random.split(ks[0], K))
        a = jax.random.normal(ks[1], (K, nb))
        # inequalities: -x <= 10 and x <= 10 boxes (always feasible at 0)
        I = jnp.eye(nb)
        G = jnp.tile(jnp.concatenate([I, -I], axis=0)[None], (K, 1, 1))[:, :mb]
        u = jnp.full((K, mb), 10.0)
        C = jax.random.normal(ks[2], (K, p, nb)) / np.sqrt(nb)
        c = jax.random.normal(ks[3], (p,)) * 0.1
        return SeparableProblem(P=P, a=a, G=G, u=u, C=C, c=c)

    def test_schur_kkt_matches_dense(self, key):
        prob = self._random_problem(key)
        K, nb = prob.K, prob.nb
        p = prob.C.shape[1]
        x = jnp.zeros((K, nb))
        q = jax.random.normal(key, (K, nb))
        rhs = jax.random.normal(jax.random.PRNGKey(1), (p,)) * 0.1
        dx, w = schur_kkt_solve(prob.P + jnp.eye(nb)[None], prob.C, q, rhs)
        # dense reference: block-diag H, stacked C
        import scipy.linalg as sla
        Hd = sla.block_diag(*np.asarray(prob.P + jnp.eye(nb)[None]))
        Cd = np.concatenate(np.asarray(prob.C), axis=1)  # (p, K*nb)
        KKT = np.block([[Hd, Cd.T], [Cd, np.zeros((p, p))]])
        rhs_d = np.concatenate([-np.asarray(q).ravel(), np.asarray(rhs)])
        sol = np.linalg.solve(KKT, rhs_d)
        assert np.max(np.abs(np.asarray(dx).ravel() - sol[:K * nb])) < 1e-8
        assert np.max(np.abs(np.asarray(w) - sol[K * nb:])) < 1e-8

    def test_separable_barrier_solve(self, key):
        prob = self._random_problem(key)
        x0 = jnp.zeros((prob.K, prob.nb))
        sol = separable_barrier_solve(prob, x0)
        x = sol.x
        # KKT check: coupling holds, gradient stationarity on the span
        coupling = jnp.einsum("kpn,kn->p", prob.C, x) - prob.c
        assert float(jnp.linalg.norm(coupling)) < 1e-4
        assert float(sol.duality_gap) < 1e-7
        # Solution-record discipline (round-3 item 6): per-block flags
        assert sol.stalled.shape == (prob.K,)
        assert not bool(jnp.any(sol.stalled))
        assert sol.lam.shape == prob.u.shape
        assert bool(jnp.all(sol.lam > 0))

    def test_sharded_schur_matches_local(self, key):
        prob = self._random_problem(key, K=8)
        q = jax.random.normal(key, (prob.K, prob.nb))
        rhs = jnp.zeros((prob.C.shape[1],))
        H = prob.P + jnp.eye(prob.nb)[None]
        dx_l, w_l = schur_kkt_solve(H, prob.C, q, rhs)
        mesh = parallel.block_mesh(8)
        solver = make_sharded_schur_solver(mesh)
        dx_s, w_s = solver(H, prob.C, q, rhs)
        assert jnp.allclose(dx_l, dx_s, atol=1e-10)
        assert jnp.allclose(w_l, w_s, atol=1e-10)

    def test_sharded_separable_solve(self, key):
        prob = self._random_problem(key, K=8)
        mesh = parallel.block_mesh(8)
        solver = make_sharded_schur_solver(mesh)
        x0 = jnp.zeros((prob.K, prob.nb))
        x_local = separable_barrier_solve(prob, x0).x
        x_shard = separable_barrier_solve(prob, x0, kkt_solver=solver).x
        assert jnp.allclose(x_local, x_shard, atol=1e-6)
