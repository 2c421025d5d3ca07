"""Spectral (eigendecomposition) solves with regularization sweep.

Re-design of the reference's last-resort solvers
(cvx/MatrixUtils.scala:603-751: ``diagonalizationSolve``, ``svdSolve``,
``symSolve``).  The reference sweeps Tikhonov parameters
delta = 1e-14 * 10^k, k < 18, sequentially, keeping the best residual, and
throws if none is good enough.  Here the whole sweep is evaluated at once in
the eigenbasis (a (num_deltas, n) broadcast — O(18 n) after the O(n^3)
decomposition), the best candidate is selected with ``argmin``, and the
residual is returned as a diagnostic instead of an exception.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .cholesky import relative_residual

# delta sweep of the reference: 1e-14 * 10^k, k = 0..17
_NUM_DELTAS = 18


@partial(jax.jit, static_argnames=())
def sym_solve_eig(H: jax.Array, b: jax.Array, *, tol: float = 1e-10):
    """Solve symmetric ``H x = b`` via eigendecomposition + Tikhonov sweep.

    Returns ``(x, relres)``.  Handles singular and indefinite H: components of
    ``b`` outside the numerical range of H are dropped (sharp cutoff), then a
    geometric sweep of Tikhonov parameters is scored by true residual in the
    eigenbasis and the best candidate wins.  Mirrors the *behavior* of
    MatrixUtils.scala:649-699 without data-dependent control flow.
    """
    lam, V = jnp.linalg.eigh(H)
    c = V.T @ b  # coordinates of b in the eigenbasis
    abs_lam = jnp.abs(lam)
    lam_max = jnp.maximum(jnp.max(abs_lam), jnp.finfo(H.dtype).tiny)
    # sharp cutoff, relative (the reference uses |d| > 0; exact zeros are rare
    # in floating point so we cut at eps * lam_max which is what "numerically
    # zero" actually means)
    eps_cut = jnp.finfo(H.dtype).eps * lam_max
    nonzero = abs_lam > eps_cut

    # candidate 0: plain pseudo-inverse solution
    z_pinv = jnp.where(nonzero, c / jnp.where(nonzero, lam, 1.0), 0.0)

    # candidates 1..18: Tikhonov z_j = lam_j c_j / (lam_j^2 + delta)
    deltas = 1e-14 * (10.0 ** jnp.arange(_NUM_DELTAS, dtype=H.dtype))
    deltas = deltas * lam_max**2  # scale-invariant sweep
    z_tik = (lam * c)[None, :] / (lam[None, :] ** 2 + deltas[:, None])

    z_all = jnp.concatenate([z_pinv[None, :], z_tik], axis=0)
    # residual in eigenbasis: ||H V z - b|| = ||diag(lam) z - c||
    res = jnp.linalg.norm(lam[None, :] * z_all - c[None, :], axis=1)
    best = jnp.argmin(res)
    x = V @ z_all[best]
    return x, relative_residual(H, x, b, tol)


@partial(jax.jit, static_argnames=())
def svd_solve(A: jax.Array, b: jax.Array, *, tol: float = 1e-10):
    """Solve general (possibly non-symmetric / singular) ``A x = b`` via SVD
    with the same Tikhonov sweep (MatrixUtils.scala:712-729).

    Returns ``(x, relres)``.  With A = U diag(s) V', candidates are the
    truncated pseudo-inverse solution and the Tikhonov family
    z_j = s_j c_j / (s_j^2 + delta) in the singular basis; the best true
    residual wins.  The non-symmetric fallback of
    SymmetricLinearSystem.scala:28-55 ('if not symmetric -> svdSolve').
    """
    U, s, Vt = jnp.linalg.svd(A, full_matrices=False)
    c = U.T @ b
    s_max = jnp.maximum(jnp.max(s), jnp.finfo(A.dtype).tiny)
    nonzero = s > jnp.finfo(A.dtype).eps * s_max

    z_pinv = jnp.where(nonzero, c / jnp.where(nonzero, s, 1.0), 0.0)
    deltas = 1e-14 * (10.0 ** jnp.arange(_NUM_DELTAS, dtype=A.dtype))
    deltas = deltas * s_max**2  # scale-invariant sweep
    z_tik = (s * c)[None, :] / (s[None, :] ** 2 + deltas[:, None])

    z_all = jnp.concatenate([z_pinv[None, :], z_tik], axis=0)
    # residual in the singular basis: ||A V' z - b|| >= ||diag(s) z - c||
    # with equality on range(U); score by the true residual to also penalize
    # the out-of-range component of b
    res = jnp.linalg.norm(
        jnp.einsum("ij,kj->ki", A, z_all @ Vt) - b[None, :], axis=1)
    best = jnp.argmin(res)
    x = Vt.T @ z_all[best]
    return x, relative_residual(A, x, b, tol)
