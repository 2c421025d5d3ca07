"""Inequality-constraint blocks (array-of-structs constraint modeling).

Re-design of cvx/Constraint.scala, cvx/LinearConstraint.scala,
cvx/QuadraticConstraint.scala and the factory zoo cvx/Constraints.scala.

The reference stores ONE closure object per scalar constraint and folds over
the list (BarrierSolver.scala:280-316) — m sequential rank-1 updates.  That
design cannot batch into matmuls.  Here constraints live in homogeneous BLOCKS:

  * ``LinearBlock``     g(x) = c + G x           <= ub   (m, n) arrays
  * ``QuadBlock``       g_i  = r_i + a_i.x + x'P_i x/2   (m, n, n) arrays
  * ``NonlinearBlock``  g(x) = fn(params, x)              one traced callable
                        returning all m values; jacobian via jacfwd

Each block exposes vectorized ``value``/``jac``/``whess`` (weighted Hessian
sum, the term Σ_i w_i ∇²g_i of barrier/primal-dual Hessians) so the whole
barrier Hessian assembles as a handful of fused einsums — one XLA kernel
instead of a fold.  Blocks also know how to lift themselves for phase-I
(one shared slack, Constraint.scala:64-89) and SOI phase-I (one slack per
constraint, Constraint.scala:101-123), and how to pull back through affine
variable changes x = z + F u (Constraint.scala:38-52).
"""

from __future__ import annotations

from typing import Any, Callable

import jax
import jax.numpy as jnp

from ..tree import pytree_dataclass, static_field


@pytree_dataclass
class LinearBlock:
    """m linear constraints c + G x <= ub."""

    G: jax.Array   # (m, n)
    c: jax.Array   # (m,)
    ub: jax.Array  # (m,)
    label: str | None = static_field(default=None)  # for violation reports

    @property
    def m(self) -> int:
        return self.G.shape[0]

    @property
    def dim(self) -> int:
        return self.G.shape[1]

    def value(self, x):
        return self.c + self.G @ x

    def jac(self, x):
        return self.G

    def whess(self, x, w):
        n = self.dim
        return jnp.zeros((n, n), self.G.dtype)

    def lift_phase1(self):
        """g(x) - s <= ub in dimension n+1 (slack appended last)."""
        col = -jnp.ones((self.m, 1), self.G.dtype)
        return LinearBlock(G=jnp.concatenate([self.G, col], axis=1),
                           c=self.c, ub=self.ub, label=self.label)

    def lift_soi(self, n_total: int, offset: int):
        """g_i(x) - s_{offset+i} <= ub_i in dimension dim + n_total."""
        S = jnp.zeros((self.m, n_total), self.G.dtype)
        S = S.at[jnp.arange(self.m), offset + jnp.arange(self.m)].set(-1.0)
        return LinearBlock(G=jnp.concatenate([self.G, S], axis=1),
                           c=self.c, ub=self.ub, label=self.label)

    def affine_pullback(self, z, F):
        return LinearBlock(G=self.G @ F, c=self.c + self.G @ z, ub=self.ub,
                           label=self.label)


@pytree_dataclass
class QuadBlock:
    """m quadratic constraints r_i + a_i.x + x' P_i x / 2 <= ub_i."""

    P: jax.Array   # (m, n, n), each symmetric
    a: jax.Array   # (m, n)
    r: jax.Array   # (m,)
    ub: jax.Array  # (m,)
    label: str | None = static_field(default=None)  # for violation reports

    @property
    def m(self) -> int:
        return self.a.shape[0]

    @property
    def dim(self) -> int:
        return self.a.shape[1]

    def value(self, x):
        return self.r + self.a @ x + 0.5 * jnp.einsum(
            "mij,i,j->m", self.P, x, x
        )

    def jac(self, x):
        return self.a + jnp.einsum("mij,j->mi", self.P, x)

    def whess(self, x, w):
        return jnp.einsum("m,mij->ij", w, self.P)

    def lift_phase1(self):
        m, n = self.a.shape
        a = jnp.concatenate([self.a, -jnp.ones((m, 1), self.a.dtype)], axis=1)
        P = jnp.pad(self.P, ((0, 0), (0, 1), (0, 1)))
        return QuadBlock(P=P, a=a, r=self.r, ub=self.ub, label=self.label)

    def lift_soi(self, n_total: int, offset: int):
        m, n = self.a.shape
        S = jnp.zeros((m, n_total), self.a.dtype)
        S = S.at[jnp.arange(m), offset + jnp.arange(m)].set(-1.0)
        a = jnp.concatenate([self.a, S], axis=1)
        P = jnp.pad(self.P, ((0, 0), (0, n_total), (0, n_total)))
        return QuadBlock(P=P, a=a, r=self.r, ub=self.ub, label=self.label)

    def affine_pullback(self, z, F):
        az = self.a + jnp.einsum("mij,j->mi", self.P, z)
        return QuadBlock(
            P=jnp.einsum("ki,mkl,lj->mij", F, self.P, F),
            a=az @ F,
            r=self.r + self.a @ z
            + 0.5 * jnp.einsum("mij,i,j->m", self.P, z, z),
            ub=self.ub,
            label=self.label,
        )


@pytree_dataclass
class NonlinearBlock:
    """m smooth constraints fn(params, x) <= ub, autodiff-derived."""

    fn: Callable[[Any, jax.Array], jax.Array] = static_field()
    params: Any = None
    ub: jax.Array = None
    num: int = static_field(default=0)      # m (static: shapes)
    in_dim: int = static_field(default=0)   # n
    label: str | None = static_field(default=None)  # for violation reports

    @property
    def m(self) -> int:
        return self.num

    @property
    def dim(self) -> int:
        return self.in_dim

    def value(self, x):
        return self.fn(self.params, x)

    def jac(self, x):
        return jax.jacfwd(self.fn, argnums=1)(self.params, x)

    def whess(self, x, w):
        # Hessian of the scalar w . fn(params, x); w enters as data.
        def weighted(x_):
            return jnp.dot(w, self.fn(self.params, x_))

        return jax.jacfwd(jax.grad(weighted))(x)

    def lift_phase1(self):
        fn = self.fn

        def lifted(params, xs):
            return fn(params, xs[:-1]) - xs[-1]

        return NonlinearBlock(fn=lifted, params=self.params, ub=self.ub,
                              num=self.num, in_dim=self.in_dim + 1,
                              label=self.label)

    def lift_soi(self, n_total: int, offset: int):
        fn, n, m = self.fn, self.in_dim, self.num

        def lifted(params, xs):
            return fn(params, xs[:n]) - xs[n + offset:n + offset + m]

        return NonlinearBlock(fn=lifted, params=self.params, ub=self.ub,
                              num=self.num, in_dim=n + n_total,
                              label=self.label)

    def affine_pullback(self, z, F):
        fn = self.fn

        def pulled(params, u):
            inner, z_, F_ = params
            return fn(inner, z_ + F_ @ u)

        return NonlinearBlock(fn=pulled, params=(self.params, z, F),
                              ub=self.ub, num=self.num, in_dim=F.shape[1],
                              label=self.label)


# ---------------------------------------------------------------------------
# factory zoo (Constraints.scala)
# ---------------------------------------------------------------------------


def positivity(n: int, dtype=jnp.float64) -> LinearBlock:
    """x_j >= 0 for all j, as -x <= 0 (Constraints.scala:26-69)."""
    return LinearBlock(
        G=-jnp.eye(n, dtype=dtype),
        c=jnp.zeros((n,), dtype),
        ub=jnp.zeros((n,), dtype),
        label="positivity",
    )


def first_coordinates_positive(n: int, m: int, dtype=jnp.float64) -> LinearBlock:
    """x_0..x_{m-1} >= 0 in dimension n (Constraints.scala:42-49)."""
    G = jnp.zeros((m, n), dtype).at[jnp.arange(m), jnp.arange(m)].set(-1.0)
    return LinearBlock(G=G, c=jnp.zeros((m,), dtype),
                       ub=jnp.zeros((m,), dtype),
                       label="first_coordinates_positive")


def rows_leq(H: jax.Array, u: jax.Array,
             label: str = "rows_leq") -> LinearBlock:
    """Coordinatewise H x <= u (ConstraintSet.scala:621-638)."""
    return LinearBlock(G=H, c=jnp.zeros((H.shape[0],), H.dtype), ub=u,
                       label=label)


def expectation_lt(w: jax.Array, r: float) -> LinearBlock:
    """E[W] < r for discrete W with values w: w.x <= r
    (Constraints.scala:109-153).  P[E] > r is expectation_lt(-1_E, -r)."""
    return LinearBlock(
        G=w[None, :],
        c=jnp.zeros((1,), w.dtype),
        ub=jnp.asarray([r], w.dtype),
    )


def abs_bounded(ub: jax.Array) -> LinearBlock:
    """|x_j| <= ub_j for each j: the 2n rows  x_j <= ub_j, -x_j <= ub_j.

    (Per-coordinate version; the reference's 2^k sign-combination expansion of
    sum-of-|x_j| bounds lives in ops.testmat.sign_combination_matrix.)
    """
    n = ub.shape[0]
    I = jnp.eye(n, dtype=ub.dtype)
    return LinearBlock(
        G=jnp.concatenate([I, -I], axis=0),
        c=jnp.zeros((2 * n,), ub.dtype),
        ub=jnp.concatenate([ub, ub]),
    )


def half_norm2_bounded(n: int, ub: float, dtype=jnp.float64) -> QuadBlock:
    """||x||^2 / 2 <= ub (Constraints.scala:299-309)."""
    return QuadBlock(
        P=jnp.eye(n, dtype=dtype)[None],
        a=jnp.zeros((1, n), dtype),
        r=jnp.zeros((1,), dtype),
        ub=jnp.asarray([ub], dtype),
    )


def abs_sum_bounded(n: int, p: int, q: int, ub: float,
                    dtype=jnp.float64) -> LinearBlock:
    """|x_p| + ... + |x_{q-1}| <= ub via the 2^(q-p) sign-combination rows
    (Constraints.scala:252-296, MatrixUtils.scala:108-127).  Keep q - p
    small — the row count is exponential, exactly as in the reference."""
    from ..ops.testmat import sign_combination_matrix_padded

    G = jnp.asarray(sign_combination_matrix_padded(n, p, q), dtype)
    m = G.shape[0]
    return LinearBlock(G=G, c=jnp.zeros((m,), dtype),
                       ub=jnp.full((m,), ub, dtype))
