"""Round-4 regression suite: pins for this round's verdict items.

1. The certified 1e-8 contract is SHAPE-INDEPENDENT (reference:
   SolverParams.scala:41 — one tolerance, no n anywhere): certified rows
   must hold at n = 1000 and n = 10000, not just the flagship n = 100
   (round-3 verdict missing item 2).
2. Fixed-sweep Ruiz equilibration (the round-4 hot-path mode) matches the
   convergent loop's conditioning quality and leaves KKT residuals
   unchanged (round-3 verdict next item 4).
3. The lean certified finishing pass (one shared exp(-B'z) pass + scalar
   log identity, round 4) reports a gap that matches an INDEPENDENT host
   f64 recompute — the refactor must not have decoupled the reported
   certificate from the true f(x) - g(z).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cvx_tpu.models import DistKL
from cvx_tpu.models.dist_kl import kl_certify
from cvx_tpu.ops.equilibrate import ruiz_equilibrate
from cvx_tpu.ops.kkt import kkt_solve
from cvx_tpu.ops.testmat import random_spd


def _kl_fixture(n, B, dtype=jnp.float32):
    I_A = np.zeros(n); I_A[:3] = 1.0
    I_B = np.zeros(n); I_B[n // 2:] = 1.0
    H = jnp.asarray(np.stack([-I_A, I_B]), dtype)
    u = jnp.asarray(np.column_stack([-np.linspace(0.25, 0.45, B),
                                     np.linspace(0.6, 0.75, B)]), dtype)
    prob = DistKL.create(n, H=H, u=jnp.zeros((2,), dtype), dtype=dtype)
    return prob, H, u


class TestCertifiedShapeIndependent:
    """Contract gap <= 1e-8 at n = 1000 / 10000 through the fleet entry
    (f32 kernel route in interpret mode + f64 finish)."""

    @pytest.mark.parametrize("n,B", [(1000, 4), (10000, 2)])
    def test_certified_contract_large_n(self, n, B):
        prob, H, u = _kl_fixture(n, B)
        s = prob.solve_certified_batch(u, interpret=True)
        assert float(jnp.max(jnp.abs(s.duality_gap))) <= 1e-8
        assert float(jnp.max(s.ineq_res)) <= 1e-10
        assert float(jnp.max(s.eq_gap)) <= 1e-10
        assert not bool(jnp.any(s.stalled))

    def test_two_polish_steps_suffice_from_f32_start(self):
        # quadratic convergence: from the kernel's ~1e-5..1e-6 f32 start,
        # 2 f64 Newton steps land far below the contract (the round-3
        # default of 3 was margin, measured again here at n=1000)
        prob, H, u = _kl_fixture(1000, 4)
        s2 = prob.solve_certified_batch(u, polish_steps=2, interpret=True)
        s3 = prob.solve_certified_batch(u, polish_steps=3, interpret=True)
        assert float(jnp.max(jnp.abs(s2.duality_gap))) <= 1e-10
        # the third step buys nothing beyond the rounding floor
        assert float(jnp.max(jnp.abs(s3.duality_gap))) <= \
            max(1e-12, 10 * float(jnp.max(jnp.abs(s2.duality_gap))))


class TestRuizFixedSweeps:
    def test_fixed_matches_convergent_conditioning(self, key):
        H = random_spd(key, 64, cond=1e8)
        d_conv, Q_conv = ruiz_equilibrate(H)
        d_fix, Q_fix = ruiz_equilibrate(H, sweeps=4)
        from cvx_tpu.ops.equilibrate import condition_number
        c_conv = float(condition_number(Q_conv))
        c_fix = float(condition_number(Q_fix))
        # same order of conditioning improvement (both ~sqrt(cond))
        assert c_fix <= 10.0 * c_conv

    def test_kkt_residual_unchanged(self, key):
        n, p = 96, 8
        ks = jax.random.split(key, 3)
        H = random_spd(ks[0], n, cond=1e10)
        A = jax.random.normal(ks[1], (p, n)) / np.sqrt(n)
        q = jax.random.normal(ks[2], (n,))
        b = jnp.zeros((p,))
        x, w, rr = kkt_solve(H, A, q, b, method="chol", refine=2)
        assert float(rr) < 1e-10

    def test_fixed_sweeps_vmaps(self, key):
        Hs = jax.vmap(lambda k: random_spd(k, 32, cond=1e6))(
            jax.random.split(key, 4))
        d, Q = jax.vmap(lambda H: ruiz_equilibrate(H, sweeps=4))(Hs)
        assert d.shape == (4, 32)
        rows = jnp.linalg.norm(Q, axis=-1)
        assert float(jnp.max(jnp.abs(rows - 1.0))) < 0.2


class TestBlockedCholesky:
    """Coarse-blocked single-instance Cholesky (ops/blocked_chol.py) must
    agree with the XLA built-in to rounding at every blocking shape,
    including ragged last blocks and f32."""

    @pytest.mark.parametrize("n,bk", [(64, 32), (100, 32), (384, 128),
                                      (1000, 256)])
    def test_matches_xla(self, n, bk):
        from cvx_tpu.ops.blocked_chol import cholesky_blocked
        M = np.random.default_rng(n).standard_normal((n, n)) / np.sqrt(n)
        H = jnp.asarray(M @ M.T + 2 * np.eye(n))
        L = cholesky_blocked(H, bk=bk)
        assert float(jnp.max(jnp.abs(L - jnp.linalg.cholesky(H)))) < 1e-13
        assert float(jnp.max(jnp.abs(L @ L.T - H))) < 1e-12

    def test_f32(self):
        from cvx_tpu.ops.blocked_chol import cholesky_blocked
        n = 512
        M = np.random.default_rng(0).standard_normal((n, n)) / np.sqrt(n)
        H = jnp.asarray(M @ M.T + 2 * np.eye(n), jnp.float32)
        L = cholesky_blocked(H, bk=128)
        err = float(jnp.max(jnp.abs(
            L.astype(jnp.float64) @ L.astype(jnp.float64).T
            - H.astype(jnp.float64))))
        assert err < 1e-5

    def test_small_n_delegates(self):
        from cvx_tpu.ops.blocked_chol import cholesky_blocked
        H = jnp.eye(16) * 4.0
        assert float(jnp.max(jnp.abs(
            cholesky_blocked(H, bk=512) - 2.0 * jnp.eye(16)))) < 1e-14


class TestCertifyGapIsMeasured:
    def test_reported_gap_matches_host_recompute(self):
        """kl_certify's gap must equal the independently recomputed
        f(x) - g(z) in host f64 (guards the shared-exp/scalar-log
        refactor of round 4)."""
        n, B = 200, 6
        prob, H, u = _kl_fixture(n, B)
        s = prob.solve_certified_batch(u)
        x = np.asarray(s.x, np.float64)
        lam = np.asarray(s.lam, np.float64)
        nu = np.asarray(s.nu, np.float64)
        Hn = np.asarray(H, np.float64)
        A = np.ones((1, n))
        Bmat = np.concatenate([Hn, A], axis=0)
        for i in range(B):
            z = np.concatenate([lam[i], nu[i]])
            w = np.concatenate([np.asarray(u[i], np.float64), [1.0]])
            # uniform prior: R = 1/(n e), g(z) = -(w.z + sum R exp(-B'z))
            g = -(w @ z + np.sum(np.exp(-Bmat.T @ z - 1.0)) / n)
            xi = np.maximum(x[i], 1e-300)
            f = np.sum(xi * np.log(n * xi))
            assert abs((f - g) - float(s.duality_gap[i])) < 1e-12


class TestDualDim8:
    """Round-4 widening: the fused dual kernel's in-register envelope grew
    from dual dim <= 5 to <= 8 (the same straight-line-Cholesky envelope
    as duality._small_solve) — and its stress family exposed a BOUNDARY-JAM
    stall in the f32 phase (fixed by the KKT-consistent purge in
    _newton_z; see the kernel comment).  Pins here:

    1. dims 6/7/8 agree with the XLA dual_fast route to solver precision;
    2. the exact jammed instance (4/10000 of a random 5-row family stuck
       at gap 0.37 pre-fix) now converges;
    3. the certified fallback path holds the 1e-8 contract at dim 6-8.
    """

    def _random_family(self, k, mE, n, seed=0):
        rng = np.random.default_rng(seed)
        H = rng.uniform(0.0, 1.0, (k, n)); H[H < 0.6] = 0.0
        x0 = rng.uniform(0.5, 1.5, n); x0 /= x0.sum()
        u = H @ x0 + rng.uniform(0.05, 0.15, k)
        A = rng.uniform(0.0, 1.0, (mE, n)) if mE else None
        r = (A @ x0) if mE else None
        return H, u, A, r

    @pytest.mark.parametrize("k,mE", [(5, 0), (4, 2), (7, 0)])
    def test_fused_matches_dual_fast(self, k, mE):
        n = 24
        H, u, A, r = self._random_family(k, mE, n)
        prob = DistKL.create(
            n, H=jnp.asarray(H, jnp.float64), u=jnp.asarray(u, jnp.float64),
            A=None if A is None else jnp.asarray(A, jnp.float64),
            r=None if r is None else jnp.asarray(r, jnp.float64))
        s_fast = prob.solve(method="dual_fast")
        s_fused = prob.solve_dual_fused(interpret=True)
        assert float(jnp.max(jnp.abs(s_fast.x - s_fused.x))) < 1e-6
        assert float(jnp.abs(s_fused.duality_gap)) < 1e-8
        assert not bool(s_fused.stalled)

    def test_boundary_jam_instance_converges(self):
        # the pre-fix worst offender: instance 5579 of the (k=5, n=100,
        # seed 0, batch 10000) family — ALL five constraints slack at the
        # optimum (z* = (0,...,0, -1)); the creeping fraction-to-boundary
        # steps starved the f32 line search below value resolution and the
        # solve froze at gap 0.369
        n, batch, k = 100, 10000, 5
        rng = np.random.default_rng(0)
        H = rng.uniform(0.0, 1.0, (k, n)); H[H < 0.6] = 0.0
        x0 = rng.uniform(0.5, 1.5, n); x0 /= x0.sum()
        margins = rng.uniform(0.05, 0.15, (batch, k))
        u = (H @ x0)[None, :] + margins
        from cvx_tpu.ops.pallas_kl_dual import kl_dual_fused
        Hi = jnp.asarray(H, jnp.float32)[None]
        ui = jnp.asarray(u[5579], jnp.float32)[None]
        x, gap, z = kl_dual_fused(Hi, ui, n_steps=16, bt=8, interpret=True)
        assert abs(float(gap[0])) < 1e-5          # f32 in-kernel floor
        assert float(jnp.max(jnp.abs(z[0][:k]))) == 0.0   # all lam purged
        assert abs(float(z[0][k]) + 1.0) < 1e-4   # nu -> -1 (uniform opt)

    @pytest.mark.parametrize("k,mE", [(5, 0), (7, 0)])
    def test_certified_contract_dim6_8(self, k, mE):
        # the f32 kernel (interpreted) + native-f64 finish at the widened
        # dims
        n, B = 24, 3
        H, u, A, r = self._random_family(k, mE, n, seed=1)
        prob = DistKL.create(n, H=jnp.asarray(H, jnp.float32),
                             u=jnp.zeros((k,), jnp.float32),
                             dtype=jnp.float32)
        U = jnp.asarray(np.stack([u * s for s in (1.0, 1.05, 1.1)]),
                        jnp.float32)
        s = prob.solve_certified_batch(U, interpret=True)
        assert float(jnp.max(jnp.abs(s.duality_gap))) <= 1e-8
        assert float(jnp.max(s.ineq_res)) <= 1e-10
        assert not bool(jnp.any(s.stalled))
