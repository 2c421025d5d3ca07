"""The fused KL dual kernel (ops/pallas_kl_dual.py) and the capability
module that routes to it (cvx_tpu/backend.py).

On the CPU the kernel runs in the Pallas interpreter with the very blocks
the GPU compiles, and its Triton lowering for CUDA is checked without a
card.  The card itself is reached only by tests marked ``gpu`` (skipped
here; ``python chip_smoke.py`` runs the same checks on the card).
"""

import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cvx_tpu import backend
from cvx_tpu.models import DistKL
from cvx_tpu.ops.pallas_kl_dual import KERNEL_NAME, _tile, kl_dual_fused

REPO = pathlib.Path(__file__).resolve().parent.parent


def _family(k, m_eq, n, B, seed=0, prior=False):
    """Random rows with per-instance slack margins, consistent equalities
    and an optional non-uniform prior; data rounded to f32 exactly."""
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(0.5, 1.5, n); x0 /= x0.sum()
    H = rng.uniform(0.0, 1.0, (k, n)); H[H < 0.5] = 0.0
    u = (H @ x0)[None, :] + rng.uniform(0.02, 0.15, (B, k))
    if k:
        # make the first row bind: E[W] >= E_x0[W] + delta
        u[:, 0] = -(H[0] @ x0) - rng.uniform(0.01, 0.04, B)
        H[0] = -H[0]
    A = rng.uniform(0.0, 1.0, (m_eq, n))
    r = np.tile(A @ x0, (B, 1))
    p = rng.uniform(0.5, 2.0, n) if prior else None
    f32 = lambda a: None if a is None else np.asarray(  # noqa: E731
        a, np.float32).astype(np.float64)
    return f32(H), f32(u), f32(A), f32(r), (None if p is None
                                            else p / p.sum())


def _reference_x(H, u, A, r, prior):
    """The plain f64 reference: solve_dual_newton per instance."""
    m_eq = A.shape[0]

    def one(ui, ri):
        prob = DistKL.create(H.shape[1], H=jnp.asarray(H), u=ui,
                             A=jnp.asarray(A) if m_eq else None,
                             r=ri if m_eq else None, prior=prior)
        return prob.solve_dual_newton(steps=40).x

    return np.asarray(jax.vmap(one)(jnp.asarray(u), jnp.asarray(r)))


def _kernel(H, u, A, r, prior, **kw):
    B = u.shape[0]
    k, n = H.shape
    m_eq = A.shape[0]
    Hb = jnp.broadcast_to(jnp.asarray(H, jnp.float32)[None], (B, k, n))
    Ab = (jnp.broadcast_to(jnp.asarray(A, jnp.float32)[None], (B, m_eq, n))
          if m_eq else None)
    lp = None if prior is None else jnp.log(jnp.asarray(prior, jnp.float32))
    return kl_dual_fused(Hb, jnp.asarray(u, jnp.float32), Ab,
                         jnp.asarray(r, jnp.float32) if m_eq else None,
                         log_prior=lp, **kw)


class TestKernelAgainstReference:
    """Interpret mode against the f64 reference over dual dims 2-16."""

    @pytest.mark.parametrize("k,m_eq,n,B,prior", [
        (1, 0, 100, 3, False),     # dim 2
        (2, 0, 100, 5, False),     # dim 3, the flagship shape
        (2, 0, 60, 7, True),       # dim 3, prior, n not a power of two
        (0, 1, 33, 4, False),      # dim 2, equality only
        (0, 3, 40, 3, False),      # dim 4, equalities only
        (3, 1, 37, 9, False),      # dim 5, B not a multiple of the tile
        (4, 2, 50, 6, True),       # dim 7, equalities + prior
        (7, 0, 24, 5, False),      # dim 8
        (9, 2, 30, 3, False),      # dim 12
        (11, 0, 24, 3, True),      # dim 12, prior
        (13, 2, 24, 2, False),     # dim 16
        (15, 0, 24, 3, False),     # dim 16
    ])
    def test_matches_f64_reference(self, k, m_eq, n, B, prior):
        H, u, A, r, p = _family(k, m_eq, n, B, seed=k + 10 * m_eq,
                                prior=prior)
        x, gap, z = _kernel(H, u, A, r, p, interpret=True)
        assert x.shape == (B, n) and gap.shape == (B,)
        assert z.shape == (B, k + 1 + m_eq)
        x_ref = _reference_x(H, u, A, r, p)
        assert float(np.max(np.abs(np.asarray(x) - x_ref))) < 5e-5
        assert float(np.max(np.abs(np.asarray(gap)))) < 1e-5
        assert float(np.max(np.abs(np.sum(np.asarray(x), 1) - 1.0))) < 1e-5


class TestWrapper:
    """Padding, tile choice and the GPU lowering of the wrapper's blocks."""

    @pytest.mark.parametrize("bt", [1, 2, 4, 8])
    def test_padding_is_inert(self, bt):
        # B = 5 instances on tiles of bt: the padded instances and lanes
        # change nothing — each instance equals its solve alone
        H, u, A, r, p = _family(3, 1, 37, 5, seed=4)
        x, gap, z = _kernel(H, u, A, r, p, bt=bt, interpret=True)
        for i in (0, 4):
            xi, gi, zi = _kernel(H, u[i:i + 1], A, r[i:i + 1], p, bt=1,
                                 interpret=True)
            np.testing.assert_allclose(np.asarray(x[i]), np.asarray(xi[0]),
                                       atol=1e-6)
            np.testing.assert_allclose(np.asarray(z[i]), np.asarray(zi[0]),
                                       atol=1e-4)

    @pytest.mark.parametrize("npad", [32, 128, 512, 1024, 2048, 16384])
    def test_tile_choice(self, npad):
        bt, warps = _tile(npad)
        assert bt == 1                     # one instance per program
        assert warps in (1, 2, 4, 8)
        assert npad // warps <= max(256, npad // 8)   # lanes per warp

    def test_non_power_of_two_bt_raises(self):
        H, u, A, r, p = _family(2, 0, 16, 3)
        with pytest.raises(ValueError, match="power of two"):
            _kernel(H, u, A, r, p, bt=3, interpret=True)

    @pytest.mark.parametrize("k,m_eq,n", [
        (2, 0, 100), (1, 0, 37), (3, 2, 129), (7, 0, 100), (15, 0, 100),
        (13, 2, 24), (2, 0, 10000)])
    def test_lowers_to_triton_for_cuda(self, k, m_eq, n, monkeypatch):
        # the Triton lowering refuses non-power-of-two blocks and
        # primitives it has no rule for, so this checks the GPU route's
        # blocks and body without a card
        monkeypatch.setattr(backend, "is_gpu", lambda: True)
        B = 6
        Hs = jnp.ones((B, k, n), jnp.float32)
        u = jnp.ones((B, k), jnp.float32)
        A = jnp.ones((B, m_eq, n), jnp.float32) if m_eq else None
        r = jnp.ones((B, m_eq), jnp.float32) if m_eq else None
        lowered = jax.jit(kl_dual_fused).trace(Hs, u, A, r).lower(
            lowering_platforms=("cuda",))
        text = lowered.as_text()
        assert "__gpu$xla.gpu.triton" in text
        assert KERNEL_NAME in text


class TestRoutes:
    """backend.py: one place decides the route, and the interpreter runs
    only on request."""

    def test_cpu_takes_xla_unless_interpret_asked(self):
        assert backend.kl_dual_route(100, 2, 0) == "xla"
        assert backend.kl_dual_route(100, 2, 0, interpret=True) == \
            "interpret"

    @pytest.mark.parametrize("k,m_eq", [(16, 0), (0, 0), (10, 6)])
    def test_outside_kernel_envelope_is_xla(self, k, m_eq):
        assert backend.kl_dual_route(100, k, m_eq, interpret=True) == "xla"

    def test_gpu_routes(self, monkeypatch):
        monkeypatch.setattr(backend, "is_gpu", lambda: True)
        assert backend.kl_dual_route(100, 2, 0) == "triton"
        dmax = backend.TRITON_MAX_DIM
        assert backend.kl_dual_route(backend.TRITON_MAX_N, dmax - 3, 2) == \
            "triton"
        assert backend.kl_dual_route(backend.TRITON_MAX_N + 1, 2, 0) == \
            "xla"
        assert backend.kl_dual_route(100, dmax, 0) == "xla"   # dim + 1
        assert backend.kl_dual_route(100, dmax, 0, interpret=True) == \
            "interpret"
        assert backend.pallas_mode() == "triton"

    def test_pallas_mode_raises_without_compiled_route(self):
        with pytest.raises(RuntimeError, match="interpret=True"):
            backend.pallas_mode()
        assert backend.pallas_mode(interpret=True) == "interpret"

    def test_kernel_never_interprets_silently(self):
        # a compiled call off the GPU is refused before Pallas sees it
        H, u, A, r, p = _family(2, 0, 16, 2)
        with pytest.raises(RuntimeError, match="interpret=True"):
            _kernel(H, u, A, r, p)

    def test_model_reports_the_route_it_takes(self):
        H, u, A, r, p = _family(2, 0, 32, 4)
        prob = DistKL.create(32, H=jnp.asarray(H, jnp.float32),
                             u=jnp.zeros((2,), jnp.float32))
        assert prob.fleet_route() == "xla"
        assert prob.fleet_route(interpret=True) == "interpret"
        lowered = jax.jit(prob.solve_batch).lower(
            jnp.asarray(u, jnp.float32))
        assert KERNEL_NAME not in lowered.as_text()

    def test_fleet_routes_agree(self):
        H, u, A, r, p = _family(2, 0, 48, 6, seed=3)
        prob = DistKL.create(48, H=jnp.asarray(H, jnp.float32),
                             u=jnp.zeros((2,), jnp.float32))
        u32 = jnp.asarray(u, jnp.float32)
        s_x = prob.solve_batch(u32)
        s_k = prob.solve_batch(u32, interpret=True)
        np.testing.assert_allclose(np.asarray(s_x.x), np.asarray(s_k.x),
                                   atol=5e-5)
        assert not bool(jnp.any(s_k.stalled))
        assert float(jnp.max(jnp.abs(s_k.duality_gap))) < 1e-5
        assert int(s_x.iters[0]) == 30 and int(s_k.iters[0]) == 16

    def test_fused_primal_method_is_gone(self):
        H, u, A, r, p = _family(2, 0, 16, 1)
        prob = DistKL.create(16, H=jnp.asarray(H), u=jnp.asarray(u[0]))
        with pytest.raises(ValueError, match="unknown method"):
            prob.solve_jittable(jnp.full((16,), 1.0 / 16), method="fused")
        with pytest.raises(ValueError, match="unknown method"):
            prob.solve(method="fused")


class TestCertifiedRoute:
    """f32 kernel (interpreted) + native-f64 finish to the 1e-8 contract
    (SolverParams.scala:41)."""

    @pytest.mark.parametrize("k,m_eq", [(2, 0), (5, 2), (11, 0)])
    def test_contract(self, k, m_eq):
        n, B = 40, 4
        H, u, A, r, p = _family(k, m_eq, n, B, seed=20 + k)
        prob = DistKL.create(n, H=jnp.asarray(H, jnp.float32),
                             u=jnp.zeros((k,), jnp.float32),
                             A=jnp.asarray(A, jnp.float32) if m_eq else None,
                             r=(jnp.zeros((m_eq,), jnp.float32)
                                if m_eq else None))
        s = prob.solve_certified_batch(
            jnp.asarray(u, jnp.float32),
            jnp.asarray(r, jnp.float32) if m_eq else None, interpret=True)
        assert s.x.dtype == jnp.float64
        assert float(jnp.max(jnp.abs(s.duality_gap))) <= 1e-8
        assert float(jnp.max(s.ineq_res)) <= 1e-10
        assert float(jnp.max(s.eq_gap)) <= 1e-10
        assert not bool(jnp.any(s.stalled))
        x_ref = _reference_x(H, u, A, r, None)
        assert float(np.max(np.abs(np.asarray(s.x) - x_ref))) < 1e-8


class TestCompileCache:
    def test_env_wins_and_nothing_is_set(self, monkeypatch, tmp_path):
        monkeypatch.setenv(backend.CACHE_ENV, str(tmp_path))
        before = jax.config.jax_compilation_cache_dir
        assert backend.enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == before

    def test_default_is_one_fixed_ignored_path(self, monkeypatch):
        monkeypatch.delenv(backend.CACHE_ENV, raising=False)
        path = backend.compile_cache_dir()
        assert path == backend.compile_cache_dir()
        assert pathlib.Path(path) == REPO / ".jax_cache"
        ignored = (REPO / ".gitignore").read_text().split()
        assert ".jax_cache/" in ignored

    def test_default_is_applied(self, monkeypatch):
        monkeypatch.delenv(backend.CACHE_ENV, raising=False)
        before = jax.config.jax_compilation_cache_dir
        try:
            path = backend.enable_compile_cache()
            assert jax.config.jax_compilation_cache_dir == path
            assert os.path.isabs(path)
        finally:
            jax.config.update("jax_compilation_cache_dir", before)


@pytest.fixture
def gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU; run python chip_smoke.py there")


@pytest.mark.gpu
class TestOnCard:
    """The compiled Triton kernel on the card (the checks chip_smoke.py
    makes, at a small fleet)."""

    def test_fleet(self, gpu, monkeypatch):
        monkeypatch.syspath_prepend(str(REPO))
        import chip_smoke
        out = chip_smoke.phase_fleet(batch=512)
        assert out["route"] == "triton"

    def test_certified(self, gpu, monkeypatch):
        monkeypatch.syspath_prepend(str(REPO))
        import chip_smoke
        out = chip_smoke.phase_certified(batch=256)
        assert all(v["route"] == "triton" for v in out.values())
