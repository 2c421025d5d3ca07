"""Round-5 pins.

1. The fused dual kernel's widened envelope (dual dim 9-16; round-5
   extension — the reference's dual is dimension-generic,
   Dist_KL.scala:59-65,114-165, and dim 9+ previously fell off onto the
   launch-bound XLA route): dims 12/16 must agree with the XLA dual_fast
   route, converge within the model-default 16 steps (the projected
   full-step line-search candidate: without it a cold start spends ~k
   steps retiring slack lams one fraction-to-boundary cap at a time), and
   hold the certified 1e-8 contract through ``solve_certified_batch``.
2. The multi-boundary cold start that motivated the projected candidate,
   pinned at the exact (k=13, mE=2) family drawn below: 16 steps reached
   only gap ~9e-6 pre-fix, ~1e-10 post-fix.
3. Batched phase-I infeasibility certificates: a mixed
   feasible/infeasible fleet flags EXACTLY the infeasible instances, both
   via ``feasibility_analysis`` (s* > 0) and via the certified batch
   route's stall flags (VERDICT round 4 item 5).
4. The game-dual fleet screen (``DistKL.feasibility_screen_batch``):
   measured two-sided certificates bracket brute-force LP, flags match
   the generic phase-I, anti-parallel/equality-fold degeneracies decide,
   the f32 returned point is strictly positive and f64-audited feasible,
   the saturated-softmax NaN and the clobbered-w certificate leaf stay
   pinned, and the screen shards over a mesh (test_parallel.py).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from cvx_tpu.models.dist_kl import DistKL


def _family(k, mE, n, seed=0):
    rng = np.random.default_rng(seed)
    H = rng.uniform(0.0, 1.0, (k, n)); H[H < 0.6] = 0.0
    x0 = rng.uniform(0.5, 1.5, n); x0 /= x0.sum()
    u = H @ x0 + rng.uniform(0.05, 0.15, k)
    A = rng.uniform(0.0, 1.0, (mE, n)) if mE else None
    r = (A @ x0) if mE else None
    return H, u, A, r


class TestDualDim16:
    """Widened in-register envelope: dual dim 9-16 (round 5)."""

    @pytest.mark.parametrize("k,mE", [(11, 0), (13, 2), (15, 0)])
    def test_fused_matches_dual_fast(self, k, mE):
        n = 24
        H, u, A, r = _family(k, mE, n)
        prob = DistKL.create(
            n, H=jnp.asarray(H, jnp.float64), u=jnp.asarray(u, jnp.float64),
            A=None if A is None else jnp.asarray(A, jnp.float64),
            r=None if r is None else jnp.asarray(r, jnp.float64))
        s_fast = prob.solve(method="dual_fast")
        s_fused = prob.solve_dual_fused(interpret=True)
        assert float(jnp.max(jnp.abs(s_fast.x - s_fused.x))) < 1e-6
        assert float(jnp.abs(s_fused.duality_gap)) < 1e-8
        assert not bool(s_fused.stalled)

    def test_multi_boundary_cold_start_converges_in_16(self):
        # the instance that motivated the projected full-step candidate:
        # 13 slack lams + 2 equality duals; the fraction-to-boundary cap
        # alone retires one lam per step, so 16 steps stalled at gap
        # ~9.2e-6 (f64) with nu off by ~6e-5
        n = 24
        H, u, A, r = _family(13, 2, n)
        prob = DistKL.create(
            n, H=jnp.asarray(H, jnp.float64), u=jnp.asarray(u, jnp.float64),
            A=jnp.asarray(A, jnp.float64), r=jnp.asarray(r, jnp.float64))
        s = prob.solve_dual_fused(steps=16, interpret=True)
        assert float(jnp.abs(s.duality_gap)) < 1e-8
        assert float(jnp.max(jnp.abs(s.lam))) == 0.0   # all slack, purged
        assert not bool(s.stalled)

    @pytest.mark.parametrize("k,mE", [(11, 0), (15, 0)])
    def test_certified_contract_dim12_16(self, k, mE):
        # the f32 kernel (interpreted) + native-f64 finish at dims 12/16
        n, B = 24, 3
        H, u, A, r = _family(k, mE, n, seed=1)
        prob = DistKL.create(n, H=jnp.asarray(H, jnp.float32),
                             u=jnp.zeros((k,), jnp.float32),
                             dtype=jnp.float32)
        U = jnp.asarray(np.stack([u * s for s in (1.0, 1.05, 1.1)]),
                        jnp.float32)
        s = prob.solve_certified_batch(U, interpret=True)
        assert float(jnp.max(jnp.abs(s.duality_gap))) <= 1e-8
        assert float(jnp.max(s.ineq_res)) <= 1e-10
        assert not bool(jnp.any(s.stalled))

    def test_dim_17_falls_back_to_dual_fast(self):
        n = 24
        H, u, _, _ = _family(16, 0, n)
        prob = DistKL.create(n, H=jnp.asarray(H, jnp.float64),
                             u=jnp.asarray(u, jnp.float64))
        s = prob.solve(method="dual_fused")   # dim 17: silent fallback
        assert float(jnp.abs(s.duality_gap)) < 1e-8
        assert not bool(s.stalled)


class TestAntiParallelRows:
    """Round-5 robustness pin: ANTI-PARALLEL constraint rows (P(A) >= pA
    and P(A) <= qA are -I_A and +I_A) make the free-set dual Hessian
    EXACTLY singular whenever an overshoot transiently releases both lams
    — the adjugate/Cholesky then emits a garbage direction, every
    line-search candidate rejects, and the solve jammed permanently
    (instance 1423 of the round-5 mixed-fleet family froze at gap 0.47
    with lam1 = 3.75).  Fixed by the per-lane ``sick`` detection in
    _solve_small + the Jacobi-gradient substitute direction; the warm
    polish paths take NO step on a sick/oversized direction instead."""

    # the exact jammed instance (batch 2000, seed 0, index 1423)
    PA, QA = 0.4444439978653988, 0.49597226141316375

    def test_jammed_instance_converges(self):
        n = 100
        I_A = np.zeros(n); I_A[:3] = 1.0
        H = np.stack([-I_A, I_A]).astype(np.float32)
        u = np.array([[-self.PA, self.QA]], np.float32)
        from cvx_tpu.ops.pallas_kl_dual import kl_dual_fused
        with jax.enable_x64(False):
            x, gap, z = kl_dual_fused(jnp.asarray(H)[None],
                                      jnp.asarray(u), n_steps=16, bt=8,
                                      interpret=True)
        assert abs(float(gap[0])) < 1e-5           # f32 in-kernel floor
        # the lower constraint is active at the optimum: P(A) = pA
        assert abs(float(jnp.sum(x[0][:3])) - self.PA) < 1e-5
        assert float(z[0][1]) == 0.0               # redundant lam purged

    def test_certified_contract_on_jammed_instance(self):
        n = 100
        I_A = np.zeros(n); I_A[:3] = 1.0
        H = np.stack([-I_A, I_A]).astype(np.float32)
        u = jnp.asarray(np.array([[-self.PA, self.QA]]), jnp.float32)
        prob = DistKL.create(n, H=jnp.asarray(H),
                             u=jnp.zeros((2,), jnp.float32),
                             dtype=jnp.float32)
        s = prob.solve_certified_batch(u, interpret=True)
        assert abs(float(s.duality_gap[0])) <= 1e-8
        assert float(s.ineq_res[0]) <= 1e-10
        assert not bool(s.stalled[0])


class TestSeparableCertify:
    """Round-5: measured f64 certificate for the block-separable Schur
    route (VERDICT round-4 item 4 — the config-5 row reported a
    continuation bound and an f32 coupling error of 6.5e-5)."""

    def _problem(self, K=4, nb=12, mb=6, p=3, dtype=jnp.float32, seed=5):
        from cvx_tpu.parallel.schur import SeparableProblem

        ks = jax.random.split(jax.random.PRNGKey(seed), 4)
        eye = jnp.eye(nb, dtype=dtype)
        M = jax.random.normal(ks[0], (K, nb, nb), dtype) / float(np.sqrt(nb))
        P = jnp.einsum("kij,klj->kil", M, M) + eye[None]
        a = jax.random.normal(ks[1], (K, nb), dtype)
        G = jnp.tile(jnp.concatenate([eye, -eye], axis=0)[None],
                     (K, 1, 1))[:, :mb]
        u = jnp.full((K, mb), 10.0, dtype)
        C = jax.random.normal(ks[2], (K, p, nb), dtype) / float(np.sqrt(nb))
        c = 0.1 * jax.random.normal(ks[3], (p,), dtype)
        return SeparableProblem(P=P, a=a, G=G, u=u, C=C, c=c)

    def test_certifies_barrier_exit_to_1e8(self):
        from cvx_tpu.parallel.schur import (separable_barrier_solve,
                                            separable_certify)
        from cvx_tpu.solvers.types import SolverParams

        prob = self._problem()
        pars = SolverParams(tol=1e-7, mu=20.0, max_iter=12)
        x0 = jnp.zeros((prob.K, prob.nb), jnp.float32)
        sol = separable_barrier_solve(prob, x0, pars)
        cert = separable_certify(prob, sol.x, sol.lam, sol.nu)
        assert abs(float(cert.gap)) <= 1e-8
        assert float(cert.ineq_res) <= 1e-10
        assert float(cert.eq_res) <= 1e-9
        # the certificate is a true bound: check against an independent
        # host-f64 dual-value recompute at the SAME (lam, w)
        P = np.asarray(prob.P, np.float64); a_ = np.asarray(prob.a,
                                                            np.float64)
        G = np.asarray(prob.G, np.float64); u = np.asarray(prob.u,
                                                           np.float64)
        C = np.asarray(prob.C, np.float64); c = np.asarray(prob.c,
                                                           np.float64)
        lam = np.asarray(cert.lam); w = np.asarray(cert.nu)
        x = np.asarray(cert.x)
        assert np.min(lam) >= 0.0
        g = -w @ c
        f = 0.0
        for k in range(prob.K):
            wv = a_[k] + G[k].T @ lam[k] + C[k].T @ w
            y = np.linalg.solve(P[k], wv)
            g += -0.5 * wv @ y - lam[k] @ u[k]
            f += a_[k] @ x[k] + 0.5 * x[k] @ (P[k] @ x[k])
        assert abs((f - g) - float(cert.gap)) < 1e-10

    def test_sharded_certify_matches_local(self):
        # 8 blocks over the 8-device CPU mesh: the psum'd certificate must
        # equal the single-device one (same reduction order up to psum)
        from cvx_tpu import parallel
        from cvx_tpu.parallel.schur import (make_sharded_separable_certify,
                                            separable_barrier_solve,
                                            separable_certify)
        from cvx_tpu.solvers.types import SolverParams

        prob = self._problem(K=8)
        pars = SolverParams(tol=1e-7, mu=20.0, max_iter=12)
        x0 = jnp.zeros((prob.K, prob.nb), jnp.float32)
        sol = separable_barrier_solve(prob, x0, pars)
        c_loc = separable_certify(prob, sol.x, sol.lam, sol.nu)
        mesh = parallel.block_mesh(8)
        c_sh = make_sharded_separable_certify(mesh)(prob, sol.x, sol.lam,
                                                    sol.nu)
        assert abs(float(c_sh.gap)) <= 1e-8
        assert float(c_sh.eq_res) <= 1e-9
        assert abs(float(c_sh.gap - c_loc.gap)) < 1e-10
        assert float(jnp.max(jnp.abs(c_sh.x - c_loc.x))) < 1e-10

    def test_certify_with_active_constraints(self):
        # tighten the box so some G rows are ACTIVE at the optimum —
        # exercises the membership update, not just the all-inactive case
        from cvx_tpu.parallel.schur import (separable_barrier_solve,
                                            separable_certify)
        from cvx_tpu.solvers.types import SolverParams
        from cvx_tpu.tree import replace

        prob = self._problem()
        prob = replace(prob, u=jnp.full_like(prob.u, 0.15))
        pars = SolverParams(tol=1e-7, mu=20.0, max_iter=12)
        x0 = jnp.zeros((prob.K, prob.nb), jnp.float32)
        sol = separable_barrier_solve(prob, x0, pars)
        cert = separable_certify(prob, sol.x, sol.lam, sol.nu)
        assert abs(float(cert.gap)) <= 1e-8
        assert float(cert.ineq_res) <= 1e-10
        assert float(cert.eq_res) <= 1e-9
        assert float(jnp.max(cert.lam)) > 0.0   # something really active


class TestBatchedInfeasibility:
    """VERDICT round-4 item 5: a mixed feasible/infeasible fleet must flag
    EXACTLY the infeasible instances."""

    def _mixed_batch(self, n=32, B=20, frac_infeasible=0.25, seed=0):
        # P(A) >= pA and P(B) <= pB on disjoint A, B with |A| + |B| < n:
        # infeasible iff pA > 1 (never) — instead use P(A) >= pA,
        # P(A) <= qA with qA < pA for the infeasible slice
        rng = np.random.default_rng(seed)
        I_A = np.zeros(n); I_A[:3] = 1.0
        H = np.stack([-I_A, I_A])          # -P(A) <= -pA, P(A) <= qA
        pA = rng.uniform(0.3, 0.5, B)
        qA = pA + rng.uniform(0.05, 0.2, B)          # feasible band
        bad = np.zeros(B, bool); bad[:: int(1 / frac_infeasible)] = True
        qA[bad] = pA[bad] - rng.uniform(0.05, 0.1, bad.sum())  # qA < pA
        u = np.stack([-pA, qA], axis=1)
        return H, u, bad

    def test_feasibility_analysis_flags_exactly(self):
        from cvx_tpu.solvers.phase1 import feasibility_analysis
        from cvx_tpu.solvers.types import SolverParams

        n, B = 32, 20
        H, u, bad = self._mixed_batch(n=n, B=B)
        pars = SolverParams()

        def one(ui):
            prob = DistKL.create(n, H=jnp.asarray(H, jnp.float64),
                                 u=ui)
            rep = feasibility_analysis(prob.inequalities,
                                       jnp.full((n,), 1.0 / n),
                                       pars, prob.equalities)
            return rep.s_max, rep.strictly_feasible

        s_max, strict = jax.vmap(one)(jnp.asarray(u, jnp.float64))
        flagged = np.asarray(s_max) > 0.0
        assert np.array_equal(flagged, bad)
        assert np.array_equal(np.asarray(strict), ~bad)

    def test_feasibility_batch_flags_exactly(self):
        # the fleet screen (shared-equality elimination hoisted out of the
        # vmap) must agree with the generic per-instance analysis
        from cvx_tpu.solvers.types import SolverParams

        n, B = 32, 20
        H, u, bad = self._mixed_batch(n=n, B=B)
        prob = DistKL.create(n, H=jnp.asarray(H, jnp.float64),
                             u=jnp.zeros((2,), jnp.float64))
        s_max, strict = prob.feasibility_batch(
            jnp.asarray(u, jnp.float64), SolverParams(tol=1e-6,
                                                      max_iter=60))
        flagged = np.asarray(s_max) > 0.0
        assert np.array_equal(flagged, bad)
        assert np.array_equal(np.asarray(strict), ~bad)

    def test_certified_batch_flags_exactly(self):
        # the certified route's stall flags are the fleet-scale
        # infeasibility surface: an infeasible instance's dual climbs
        # without bound, the measured |gap| blows past tol, stalled fires
        n, B = 32, 20
        H, u, bad = self._mixed_batch(n=n, B=B)
        prob = DistKL.create(n, H=jnp.asarray(H, jnp.float32),
                             u=jnp.zeros((2,), jnp.float32),
                             dtype=jnp.float32)
        s = prob.solve_certified_batch(jnp.asarray(u, jnp.float32),
                                       interpret=True)
        flagged = np.asarray(s.stalled)
        assert np.array_equal(flagged, bad), (flagged, bad)
        # the feasible instances still certify
        ok = ~bad
        assert float(np.max(np.abs(np.asarray(s.duality_gap)[ok]))) <= 1e-8


class TestFeasibilityScreen:
    """Round-5 game-dual fleet screen (``DistKL.feasibility_screen_batch``):
    by LP duality s* = min_{x in simplex} max_i (H_i x - u_i) =
    max_{w in simplex_k} [min_j (w'H)_j - w'u], and ANY (x, w) pair gives
    MEASURED two-sided certificates — the screen's soundness is checked
    here against brute-force LP (scipy linprog), its decisions against the
    generic phase-I, and its returned point against the strict-feasibility
    definition in f64."""

    def _mixed_batch(self, n=32, B=20, seed=0):
        rng = np.random.default_rng(seed)
        I_A = np.zeros(n); I_A[:3] = 1.0
        H = np.stack([-I_A, I_A])          # -P(A) <= -pA, P(A) <= qA
        pA = rng.uniform(0.3, 0.5, B)
        qA = pA + rng.uniform(0.05, 0.2, B)
        bad = np.zeros(B, bool); bad[::4] = True
        qA[bad] = pA[bad] - rng.uniform(0.05, 0.1, bad.sum())
        return H, np.stack([-pA, qA], axis=1), bad

    def test_anti_parallel_family_flags_exact_and_tight(self):
        # +/-I_A rows cancel along the optimal w, so the dual recovery
        # x(w*) degenerates to uniform — the primal polish must still find
        # the feasible band; the true game value here is (pA - qA)/2
        n, B = 32, 20
        H, u, bad = self._mixed_batch(n=n, B=B)
        prob = DistKL.create(n, H=jnp.asarray(H, jnp.float64),
                             u=jnp.zeros((2,), jnp.float64))
        scr = jax.jit(prob.feasibility_screen_batch)(
            jnp.asarray(u, jnp.float64))
        assert np.array_equal(np.asarray(scr.infeasible), bad)
        assert np.array_equal(np.asarray(scr.strictly_feasible), ~bad)
        assert int(np.asarray(scr.undecided).sum()) == 0
        s_true = (-u[:, 0] - u[:, 1]) / 2.0         # (pA - qA) / 2
        slb = np.asarray(scr.s_lower); sub = np.asarray(scr.s_upper)
        assert float(np.max(sub - slb)) < 1e-6
        assert np.all(slb <= s_true + 1e-9) and np.all(sub >= s_true - 1e-9)

    def test_bounds_bracket_linprog(self):
        # random sparse wide-k family: the measured interval must bracket
        # the true LP value, and the upper bound must be tight
        from scipy.optimize import linprog

        n, B, k = 40, 6, 7
        rng = np.random.default_rng(3)
        H = rng.uniform(0.0, 1.0, (k, n)); H[H < 0.6] = 0.0
        x0 = rng.uniform(0.5, 1.5, n); x0 /= x0.sum()
        u = (H @ x0)[None, :] + rng.uniform(0.05, 0.15, (B, k))
        prob = DistKL.create(n, H=jnp.asarray(H, jnp.float64),
                             u=jnp.zeros((k,), jnp.float64))
        scr = jax.jit(prob.feasibility_screen_batch)(
            jnp.asarray(u, jnp.float64))
        slb = np.asarray(scr.s_lower); sub = np.asarray(scr.s_upper)
        assert int(np.asarray(scr.undecided).sum()) == 0
        for b in range(B):
            c = np.zeros(n + 1); c[-1] = 1.0
            res = linprog(
                c, A_ub=np.hstack([H, -np.ones((k, 1))]), b_ub=u[b],
                A_eq=np.hstack([np.ones((1, n)), np.zeros((1, 1))]),
                b_eq=[1.0], bounds=[(0, None)] * n + [(None, None)])
            assert res.status == 0
            assert slb[b] <= res.fun + 1e-9, (b, slb[b], res.fun)
            assert sub[b] >= res.fun - 1e-9, (b, sub[b], res.fun)
            assert sub[b] - res.fun < 5e-3          # tight upper bound

    def test_f32_returns_strictly_positive_feasible_point(self):
        # the returned x seeds barrier solves: it must be strictly
        # positive (f32 softmax underflow would give exact zeros without
        # the uniform-mixing guard) and genuinely strictly feasible in f64
        n, B = 32, 40
        H, u, bad = self._mixed_batch(n=n, B=B, seed=1)
        prob = DistKL.create(n, H=jnp.asarray(H, jnp.float32),
                             u=jnp.zeros((2,), jnp.float32))
        scr = jax.jit(prob.feasibility_screen_batch)(
            jnp.asarray(u, jnp.float32))
        assert np.array_equal(np.asarray(scr.infeasible), bad)
        x = np.asarray(scr.x)
        assert (x > 0.0).all()
        assert float(np.max(np.abs(x.sum(1) - 1.0))) < 1e-5
        feas = np.asarray(scr.strictly_feasible)
        viol = x[feas].astype(np.float64) @ H.T - u[feas]
        assert (viol < 0.0).all()

    def test_agrees_with_generic_phase1(self):
        from cvx_tpu.solvers.types import SolverParams

        n, B = 32, 20
        H, u, bad = self._mixed_batch(n=n, B=B, seed=2)
        prob = DistKL.create(n, H=jnp.asarray(H, jnp.float64),
                             u=jnp.zeros((2,), jnp.float64))
        scr = jax.jit(prob.feasibility_screen_batch)(
            jnp.asarray(u, jnp.float64))
        _, strict = prob.feasibility_batch(
            jnp.asarray(u, jnp.float64),
            SolverParams(tol=1e-6, max_iter=60))
        assert np.array_equal(np.asarray(scr.strictly_feasible),
                              np.asarray(strict))

    def test_equality_rows_fold_as_pair(self):
        # extra equalities enter as the reference's eqs-as-±inequalities
        # (tol band, ConstraintSet.scala:326-347): a mixed family with
        # E[W] = r must flag exactly, and the returned feasible points
        # must meet the equality within eq_tol
        rng = np.random.default_rng(2)
        n, B = 64, 32
        I_A = np.zeros(n); I_A[:3] = 1.0
        H = np.stack([-I_A, I_A])
        pA = rng.uniform(0.2, 0.4, B)
        qA = pA + rng.uniform(0.05, 0.2, B)
        bad = np.zeros(B, bool); bad[::8] = True
        qA[bad] = pA[bad] - rng.uniform(0.05, 0.1, bad.sum())
        u = np.stack([-pA, qA], axis=1)
        W = rng.uniform(0.5, 1.5, n)
        m1 = (pA[1] + qA[1]) / 2.0
        xf = m1 * I_A / 3 + (1 - m1) * (1 - I_A) / (n - 3)
        r = np.array([W @ xf])          # consistent with instance 1's band
        prob = DistKL.create(n, H=jnp.asarray(H, jnp.float64),
                             u=jnp.zeros((2,), jnp.float64),
                             A=jnp.asarray(W[None, :], jnp.float64),
                             r=jnp.asarray(r, jnp.float64))
        scr = jax.jit(prob.feasibility_screen_batch)(
            jnp.asarray(u, jnp.float64))
        inf = np.asarray(scr.infeasible)
        assert bool(inf[bad].all())           # real infeasibility certified
        assert int(inf[~bad].sum()) == 0      # never a false infeasible
        feas = np.asarray(scr.strictly_feasible)
        assert feas.any()
        x = np.asarray(scr.x)[feas]
        assert float(np.abs(x @ W - r[0]).max()) < 1e-4   # eq_tol default
        assert bool(((x @ H.T) - u[feas] < 0).all())

    def test_near_saturated_softmax_stays_finite(self):
        # pinned from the round-5 80k-instance sweep: instance 6049 of the
        # (k=11, pair) family NaN'd BOTH bounds in f32 — near-saturated
        # softmax sends the Gauss-Newton matrix Hm -> 0 while its
        # construction rounding stays O(eps * t), so trace-only damping
        # under-regularized and the k > 8 lax Cholesky met an
        # (f32-)indefinite matrix.  The damping now scales with max|Hm|
        # (and a non-finite direction falls back to the gradient).  The
        # exact instance is replayed through the sweep's rng stream.
        rng = np.random.default_rng(0)
        B = 10000
        configs = [
            (2, 100, 0.05, 0.10, "negu"), (3, 100, 0.02, 0.10, "pair"),
            (5, 100, 0.10, 0.50, "negu"), (7, 100, 0.05, 0.10, "pair"),
            (9, 300, 0.02, 0.10, "negu"), (11, 100, 0.15, 0.25, "pair"),
        ]
        for (k, n, margin, frac, mode) in configs:
            Hw = rng.uniform(0.0, 1.0, (k, n)); Hw[Hw < 0.6] = 0.0
            if mode == "pair":
                h = rng.uniform(0.0, 1.0, n); Hw[k - 2] = h; Hw[k - 1] = -h
            x0 = rng.uniform(0.5, 1.5, n); x0 /= x0.sum()
            uw = (Hw @ x0)[None, :] + rng.uniform(margin, 2 * margin,
                                                  (B, k))
            bad = np.zeros(B, bool)
            bad[rng.permutation(B)[:int(B * frac)]] = True
            if mode == "negu":
                uw[bad, 0] = -rng.uniform(margin, 2 * margin, bad.sum())
            else:
                a = h @ x0
                uw[bad, k - 2] = a - rng.uniform(margin, 2 * margin,
                                                 bad.sum())
                uw[bad, k - 1] = -a
        assert abs(float(Hw.sum()) - 282.53496039970514) < 1e-6  # replay ok
        prob = DistKL.create(100, H=jnp.asarray(Hw, jnp.float32),
                             u=jnp.zeros((11,), jnp.float32))
        scr = jax.jit(prob.feasibility_screen_batch)(
            jnp.asarray(uw[6049:6050], jnp.float32))
        assert bool(np.isfinite(np.asarray(scr.s_lower)).all())
        assert bool(np.isfinite(np.asarray(scr.s_upper)).all())
        assert not bool(np.asarray(scr.undecided)[0])
        assert bool(np.asarray(scr.strictly_feasible)[0])  # bad[6049]=False

    def test_returned_w_reproduces_s_lower(self):
        # round-5 code-review catch: the Newton loop reused the name `w`,
        # clobbering the running-best dual certificate — on this family
        # 2/50 flagged-infeasible instances returned a w whose recomputed
        # certificate min_j(w'H)_j - w'u no longer certified anything.
        # The returned w must reproduce s_lower, and must be a POSITIVE
        # certificate on every flagged-infeasible lane.
        n, B = 32, 200
        H, u, bad = self._mixed_batch(n=n, B=B, seed=0)
        prob = DistKL.create(n, H=jnp.asarray(H, jnp.float64),
                             u=jnp.zeros((2,), jnp.float64))
        scr = jax.jit(prob.feasibility_screen_batch)(
            jnp.asarray(u, jnp.float64))
        w = np.asarray(scr.w)
        # w lives on the k-simplex
        assert (w >= 0).all()
        assert float(np.max(np.abs(w.sum(1) - 1.0))) < 1e-12
        recomputed = np.min(w @ H, axis=1) - np.sum(w * u, axis=1)
        slb = np.asarray(scr.s_lower)
        assert float(np.max(np.abs(recomputed - slb))) < 1e-9
        inf = np.asarray(scr.infeasible)
        assert (recomputed[inf] > 0).all()   # re-checkable proof
