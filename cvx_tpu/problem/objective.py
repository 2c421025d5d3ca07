"""Objective functions.

Re-design of cvx/ObjectiveFunction.scala (:8-35),
cvx/LinearObjectiveFunction.scala, cvx/QuadraticObjectiveFunction.scala and
the factory zoo cvx/ObjectiveFunctions.scala.  Where the reference asks users
to hand-code valueAt/gradientAt/hessianAt closures, here:

  * ``CustomObjective`` wraps ONE pure JAX callable ``fn(params, x) -> scalar``
    and derives the gradient with ``jax.grad`` and the Hessian with
    ``jacfwd(grad)`` (forward-over-reverse, the right mode for dense n x n
    Hessians);
  * ``LinearObjective`` / ``QuadraticObjective`` are structured fast paths
    evaluated without autodiff (zero / constant Hessians);
  * everything is a pytree dataclass, so objectives vmap over parameter
    batches (e.g. 10k KL instances with different constraint data).
"""

from __future__ import annotations

from typing import Any, Callable

import jax
import jax.numpy as jnp

from ..tree import pytree_dataclass, static_field


@pytree_dataclass
class CustomObjective:
    """f(x) = fn(params, x) with autodiff-derived gradient and Hessian.

    Replaces the closure-object protocol of ObjectiveFunction.scala:12-14.
    """

    fn: Callable[[Any, jax.Array], jax.Array] = static_field()
    params: Any = None

    def value(self, x: jax.Array) -> jax.Array:
        return self.fn(self.params, x)

    def grad(self, x: jax.Array) -> jax.Array:
        return jax.grad(self.fn, argnums=1)(self.params, x)

    def hess(self, x: jax.Array) -> jax.Array:
        return jax.jacfwd(jax.grad(self.fn, argnums=1), argnums=1)(
            self.params, x
        )


@pytree_dataclass
class LinearObjective:
    """f(x) = r + a.x  (LinearObjectiveFunction.scala:19-21)."""

    a: jax.Array
    r: jax.Array

    def value(self, x):
        return self.r + self.a @ x

    def grad(self, x):
        return self.a

    def hess(self, x):
        n = self.a.shape[-1]
        return jnp.zeros((n, n), self.a.dtype)


@pytree_dataclass
class QuadraticObjective:
    """f(x) = r + a.x + x'Px/2, P symmetric
    (QuadraticObjectiveFunction.scala:29-36)."""

    P: jax.Array
    a: jax.Array
    r: jax.Array

    def value(self, x):
        return self.r + self.a @ x + 0.5 * x @ (self.P @ x)

    def grad(self, x):
        return self.a + self.P @ x

    def hess(self, x):
        return self.P


@pytree_dataclass
class AffineObjective:
    """Pullback h(u) = f(z + F u): grad = F' g, hess = F' H F.

    Reference: ObjectiveFunction.scala:26-35 ``affineTransformed``.  Applied
    ONCE at the outer level per the performance remark in
    BarrierSolver.scala:7-11.
    """

    base: Any
    z: jax.Array
    F: jax.Array

    def value(self, u):
        return self.base.value(self.z + self.F @ u)

    def grad(self, u):
        return self.F.T @ self.base.grad(self.z + self.F @ u)

    def hess(self, u):
        x = self.z + self.F @ u
        return self.F.T @ self.base.hess(x) @ self.F


def affine_pullback(obj, z: jax.Array, F: jax.Array):
    """Structure-preserving affine transform x = z + F u of an objective."""
    if isinstance(obj, LinearObjective):
        return LinearObjective(a=F.T @ obj.a, r=obj.r + obj.a @ z)
    if isinstance(obj, QuadraticObjective):
        az = obj.a + obj.P @ z
        return QuadraticObjective(
            P=F.T @ obj.P @ F,
            a=F.T @ az,
            r=obj.r + obj.a @ z + 0.5 * z @ (obj.P @ z),
        )
    return AffineObjective(base=obj, z=z, F=F)


# ---------------------------------------------------------------------------
# factory zoo (ObjectiveFunctions.scala)
# ---------------------------------------------------------------------------


def norm_squared(n: int, dtype=jnp.float64) -> QuadraticObjective:
    """f(x) = ||x||^2 / 2  (ObjectiveFunctions.scala:11-16)."""
    return QuadraticObjective(
        P=jnp.eye(n, dtype=dtype),
        a=jnp.zeros((n,), dtype),
        r=jnp.zeros((), dtype),
    )


def quadratic_residual(R: jax.Array, x0: jax.Array) -> QuadraticObjective:
    """f(x) = ||R(x - x0)||^2 / 2  (ObjectiveFunctions.scala:21-34)."""
    P = R.T @ R
    return QuadraticObjective(P=P, a=-(P @ x0), r=0.5 * x0 @ (P @ x0))


def regularized_equation_residual(
    A: jax.Array, b: jax.Array, delta: float
) -> QuadraticObjective:
    """f(x) = (||Ax-b||^2 + delta*||A||*||x||^2)/2 — the phase-I-with-
    equalities objective (ObjectiveFunctions.scala:50-61)."""
    n = A.shape[1]
    normA = jnp.linalg.norm(A)
    P = A.T @ A + delta * normA * jnp.eye(n, dtype=A.dtype)
    return QuadraticObjective(P=P, a=-(A.T @ b), r=0.5 * b @ b)


def p_norm_p(n: int, p: float) -> CustomObjective:
    """f(x) = sum_j |x_j|^p, p >= 2  (ObjectiveFunctions.scala:70-83)."""
    assert p >= 2, "p-norm objective needs p >= 2 for C^2 smoothness"

    def fn(params, x):
        return jnp.sum(jnp.abs(x) ** params)

    return CustomObjective(fn=fn, params=jnp.asarray(p))


def power_objective(A: jax.Array, alpha: jax.Array, q: float):
    """f(x) = sum_j alpha_j (a_j . x)^(2q), a_j = row_j(A).

    The Type1Function power family (Type1Function.scala:91-107): u^(2q) is
    evaluated as (u*u)^q so it is defined (and convex, C^2 for q > 1) for
    u < 0 and fractional q.  Global minimum 0 on ker(A).
    """
    assert q >= 1

    def fn(params, x):
        A, alpha, q = params
        u = A @ x
        return jnp.sum(alpha * (u * u) ** q)

    return CustomObjective(fn=fn, params=(A, alpha, jnp.asarray(q)))
