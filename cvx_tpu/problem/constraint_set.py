"""ConstraintSet — the inequality-constraint aggregate.

Re-design of cvx/ConstraintSet.scala.  Holds a tuple of homogeneous blocks
(LinearBlock / QuadBlock / NonlinearBlock) and exposes:

  * vectorized views used by both solvers: all constraint values, the
    stacked gradient matrix Dg(x) (ConstraintSet.scala:90-110), dual
    initialization lambda_i = -1/f_i(x) (:116-120);
  * strict-feasibility predicate for line searches (:28-40);
  * fused barrier assembly — the hot path the reference folds one constraint
    at a time (BarrierSolver.scala:269-316):

        phi(t,x)  = t f0(x) - sum_i log d_i,           d = ub - g(x)
        grad      = t g0    + Dg(x)^T (1/d)
        hess      = t H0    + Dg^T diag(1/d^2) Dg + sum_i hess(g_i)/d_i

    as three einsum-fused expressions (matmul-dense in the Dg contraction);
  * phase-I lifts (simple: ConstraintSet.scala:131-168; SOI: :233-282).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..tree import pytree_dataclass
from .constraints import LinearBlock
from .sets import Domain, whole_space


@pytree_dataclass
class ConstraintSet:
    blocks: tuple
    domain: Domain = None  # set where constraints are defined

    def __post_init__(self):
        if self.domain is None:
            object.__setattr__(self, "domain", whole_space())

    # ------------------------------------------------------------------ views
    @property
    def m(self) -> int:
        return sum(b.m for b in self.blocks)

    @property
    def dim(self) -> int:
        return self.blocks[0].dim

    @property
    def ub(self) -> jax.Array:
        return jnp.concatenate([b.ub for b in self.blocks])

    def value(self, x: jax.Array) -> jax.Array:
        """All g_i(x), stacked (ConstraintSet.scala:90-94)."""
        return jnp.concatenate([b.value(x) for b in self.blocks])

    def residual(self, x: jax.Array) -> jax.Array:
        """f_i(x) = g_i(x) - ub_i  (<= 0 when feasible)."""
        return self.value(x) - self.ub

    def margins(self, x: jax.Array) -> jax.Array:
        """d_i = ub_i - g_i(x)  (> 0 when strictly feasible)."""
        return self.ub - self.value(x)

    def jac(self, x: jax.Array) -> jax.Array:
        """Stacked Dg(x), one constraint gradient per row
        (ConstraintSet.scala:100-110)."""
        return jnp.concatenate([b.jac(x) for b in self.blocks], axis=0)

    def whess(self, x: jax.Array, w: jax.Array) -> jax.Array:
        """sum_i w_i hess(g_i)(x), split across blocks."""
        out = jnp.zeros((self.dim, self.dim), x.dtype)
        off = 0
        for b in self.blocks:
            out = out + b.whess(x, w[off:off + b.m])
            off += b.m
        return out

    def satisfied_strictly(self, x: jax.Array, slack: float = 0.0):
        """all g_i(x) < ub_i (strictly), and x in the domain
        (ConstraintSet.scala:28, Constraint.scala:23)."""
        ok = jnp.all(self.margins(x) > slack)
        return jnp.logical_and(ok, self.domain.contains(x))

    def lambda_init(self, x: jax.Array) -> jax.Array:
        """Dual start lambda_i = -1/f_i(x) (ConstraintSet.scala:116-120)."""
        return -1.0 / self.residual(x)

    # -------------------------------------------------------------- barrier
    def barrier_value(self, obj, t, x):
        d = self.margins(x)
        return t * obj.value(x) - jnp.sum(jnp.log(d))

    def barrier_grad(self, obj, t, x):
        d = self.margins(x)
        G = self.jac(x)
        return t * obj.grad(x) + G.T @ (1.0 / d)

    def barrier_hess(self, obj, t, x):
        d = self.margins(x)
        G = self.jac(x)
        H = t * obj.hess(x)
        H = H + jnp.einsum("mi,m,mj->ij", G, 1.0 / (d * d), G)
        return H + self.whess(x, 1.0 / d)

    def barrier_value_grad_hess(self, obj, t, x):
        """All three barrier quantities with the margins/jacobian computed
        once (the per-Newton-iteration hot path)."""
        d = self.margins(x)
        G = self.jac(x)
        inv_d = 1.0 / d
        val = t * obj.value(x) - jnp.sum(jnp.log(d))
        grad = t * obj.grad(x) + G.T @ inv_d
        hess = (t * obj.hess(x)
                + jnp.einsum("mi,m,mj->ij", G, inv_d * inv_d, G)
                + self.whess(x, inv_d))
        return val, grad, hess

    # -------------------------------------------------------------- phase I
    def lift_phase1(self) -> "ConstraintSet":
        """Constraints g_j(x) - s <= ub_j on (x, s) — basic phase I
        (ConstraintSet.scala:153-168)."""
        return ConstraintSet(
            blocks=tuple(b.lift_phase1() for b in self.blocks),
            domain=self.domain.lift(1),
        )

    def phase1_feasible_point(self, x0: jax.Array) -> jax.Array:
        """(x0, s0) with s0 = 1 + max_j (g_j(x0) - ub_j): strictly feasible
        for the lifted constraints (ConstraintSet.scala:161-163)."""
        s0 = 1.0 + jnp.max(self.residual(x0))
        return jnp.concatenate([x0, s0[None]])

    def lift_soi(self) -> "ConstraintSet":
        """One slack per constraint: g_i(x) - s_i <= ub_i plus s_i >= 0,
        on (x, s) in dimension n + m (ConstraintSet.scala:233-282,
        Constraint.scala:101-159)."""
        p = self.m
        n = self.dim
        lifted = []
        off = 0
        for b in self.blocks:
            lifted.append(b.lift_soi(p, off))
            off += b.m
        # slack positivity: -s <= 0
        dtype = self.ub.dtype
        Gs = jnp.concatenate(
            [jnp.zeros((p, n), dtype), -jnp.eye(p, dtype=dtype)], axis=1
        )
        lifted.append(LinearBlock(G=Gs, c=jnp.zeros((p,), dtype),
                                  ub=jnp.zeros((p,), dtype)))
        return ConstraintSet(blocks=tuple(lifted), domain=self.domain.lift(p))

    def soi_feasible_point(self, x0: jax.Array) -> jax.Array:
        """(x0, s0) with s0_i = max(0.5, 1 + g_i(x0) - ub_i)
        (ConstraintSet.scala:269-271)."""
        s0 = jnp.maximum(0.5, 1.0 + self.residual(x0))
        return jnp.concatenate([x0, s0])

    # ------------------------------------------------------------- transform
    def affine_pullback(self, z, F) -> "ConstraintSet":
        """Restrict to the affine space x = z + F u
        (ConstraintSet.scala:580-591)."""
        return ConstraintSet(
            blocks=tuple(b.affine_pullback(z, F) for b in self.blocks),
            domain=self.domain.affine_pullback(z, F),
        )

    def add_blocks(self, *extra) -> "ConstraintSet":
        return ConstraintSet(blocks=self.blocks + tuple(extra),
                             domain=self.domain)
