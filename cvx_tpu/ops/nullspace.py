"""Nullspace parametrization of underdetermined systems A x = b.

Re-design of cvx/SolutionSpace.scala:20-37 and
cvx/MatrixUtils.scala:536-550 (``solveUnderdetermined``): for A (p x n) of
full row rank p < n, every solution of ``A x = b`` is ``x = z0 + F u`` where
``z0`` is the minimum-norm solution and F's columns are an orthonormal basis
of ker(A).  Built from a complete QR factorization of A^T (XLA Householder QR,
blocked matmuls).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .cholesky import tri_solve
from ..tree import pytree_dataclass


@pytree_dataclass
class SolutionSpace:
    """Affine solution space ``{x : A x = b} = {z0 + F u}``."""

    z0: jax.Array  # (n,)  minimum-norm solution
    F: jax.Array   # (n, n-p) orthonormal basis of ker(A)

    def parameter(self, x0: jax.Array) -> jax.Array:
        """u0 with ``x0 = z0 + F u0`` (exact when A x0 = b):  F^T (x0 - z0).

        Reference: SolutionSpace.scala:24-32.
        """
        return self.F.T @ (x0 - self.z0)

    def point(self, u: jax.Array) -> jax.Array:
        return self.z0 + self.F @ u


@jax.jit
def solution_space(A: jax.Array, b: jax.Array) -> SolutionSpace:
    """Compute ``(z0, F)`` for ``A x = b`` via complete QR of A^T."""
    p, n = A.shape
    Q, R = jnp.linalg.qr(A.T, mode="complete")  # A^T = Q R,  Q (n,n), R (n,p)
    # A x = b  <=>  R^T Q^T x = b; set y = solve(R[:p].T, b), z0 = Q[:, :p] y
    y = tri_solve(R[:p, :], b, lower=False, trans=True)
    z0 = Q[:, :p] @ y
    F = Q[:, p:]
    return SolutionSpace(z0=z0, F=F)
