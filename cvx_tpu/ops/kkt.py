"""KKT system solves:  H x + A^T w = -q,   A x = b.

Re-design of cvx/KKTSystem.scala.  The reference's solution is an
exception ladder (KKTSystem.scala:43-66):

  1. ``solvePD``: Ruiz-equilibrate H, Cholesky, block elimination with the
     Schur complement S = A H^-1 A^T                (KKTSystem.scala:99-246);
  2. on failure: the singular-H transform K = H + A^T A, z = q - A^T b
     (equivalent system, K positive definite whenever [H; A] has full column
     rank)                                          (KKTSystem.scala:55-59);
  3. on failure: full (n+p) symmetric-eig solve     (KKTSystem.scala:283-310).

Under jit/vmap exceptions don't exist, so this module provides:

  * ``kkt_solve(..., method="aug")``  — the DEFAULT and the batched hot path:
    always apply the H + A^T A transform + shifted Cholesky + iterative
    refinement on the original system.  One code path, no branches, matmul-dense.
    Handles singular H (LPs, phase-I objectives) by construction.
  * ``kkt_solve(..., method="chol")`` — stage 1 only (fastest when H is known
    PD, e.g. KL barrier Hessians).
  * ``kkt_solve(..., method="ladder")`` — faithful 3-stage escalation via
    ``lax.cond`` for robust single-instance solves (both branches execute
    under vmap; don't use it in large batches).

All functions return ``(x, w, relres)`` where relres is the max of the two
relative residuals of the ORIGINAL system — the caller decides what to do
with it (the reference throws LinSolveException at tolEqSolve).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from .cholesky import chol_solve_factored, regularized_cholesky
from .eigsolve import sym_solve_eig
from .equilibrate import ruiz_equilibrate


def _make_block_solver(H, A, *, delta, equil_sweeps=4):
    """Factor once, solve many: block elimination assuming H is (near) PD.

    Equilibrate H -> Q = D H D; factor Q + shift I = L L^T and the Schur
    complement S = B Q^-1 B^T (B = A D, symmetrized, shifted Cholesky).  The
    returned closure solves ``H x + A^T w = -q_``, ``A x = b_`` in O(n^2).
    Reference: KKTSystem.scala:99-167 (solveWithCholFactor) + :200-246
    (solvePD).

    Equilibration runs a FIXED sweep count by default (round-4 fix): the
    convergent while_loop serialized ~20 data-dependent n^2 rounds ahead
    of every factorization and coupled vmap lanes; 4 fixed sweeps match
    the reference's practical usage and iterative refinement keeps relres
    unchanged (measured: tests/test_ops_core.py tortures still pass).
    """
    p = A.shape[0]
    d, Q = ruiz_equilibrate(H, sweeps=equil_sweeps)
    L, _ = regularized_cholesky(Q, delta)
    B = A * d[None, :]
    Hinv_Bt = chol_solve_factored(L, B.T)
    S = B @ Hinv_Bt
    S = 0.5 * (S + S.T)
    Ls, _ = regularized_cholesky(S, delta)

    def solve_template(q_, b_):
        Hinv_q = chol_solve_factored(L, d * q_)
        z = -(b_ + B @ Hinv_q)
        w = chol_solve_factored(Ls, z)
        y = -(Hinv_q + Hinv_Bt @ w)
        return d * y, w

    return solve_template


def _block_solve(H, A, q, b, *, delta, refine):
    """One-shot block elimination + iterative refinement on the original KKT."""
    solve_template = _make_block_solver(H, A, delta=delta)
    x, w = solve_template(q, b)

    def refine_step(_, xw):
        x, w = xw
        r1 = H @ x + A.T @ w + q
        r2 = A @ x - b
        dx, dw = solve_template(r1, -r2)
        return x + dx, w + dw

    if refine > 0:
        x, w = lax.fori_loop(0, refine, refine_step, (x, w))
    return x, w


def _kkt_residual(H, A, q, b, x, w, tol):
    """max of the two normwise-backward-error residuals of the original
    KKT system: each equation's residual is measured against the terms
    that produced it (a zero right-hand side would otherwise divide the
    dtype's rounding noise by ``tol`` — see ops.cholesky.relative_residual).
    """
    nx = jnp.linalg.norm(x)
    nA = jnp.linalg.norm(A)
    r1 = jnp.linalg.norm(H @ x + A.T @ w + q)
    r2 = jnp.linalg.norm(A @ x - b)
    s1 = (tol + jnp.linalg.norm(q) + jnp.linalg.norm(H) * nx
          + nA * jnp.linalg.norm(w))
    s2 = tol + jnp.linalg.norm(b) + nA * nx
    return jnp.maximum(r1 / s1, r2 / s2)


def _augmented(H, A, q, b):
    """The singular-H transform: same solution set, PD left-hand block.

    If Ax=b then A^T A x = A^T b, so
      H x + A^T w = -q,  A x = b   <=>   (H + A^T A) x + A^T w = -(q - A^T b),
    Reference: KKTSystem.scala:55-59 (discovered fix per docs/ToDo.txt
    2017-11-22); first-class here per SURVEY.md section 7.3.
    """
    K = H + A.T @ A
    z = q - A.T @ b
    return K, z


def _kkt_eig_solve(H, A, q, b, *, tol):
    """Stage 3: full (n+p) x (n+p) symmetric solve of [[H, A^T], [A, 0]].

    Reference: KKTSystem.scala:253-310 (kktMatrix + kktSymSolve).
    """
    n = H.shape[0]
    p = A.shape[0]
    Z = jnp.zeros((p, p), dtype=H.dtype)
    M = jnp.block([[H, A.T], [A, Z]])
    rhs = jnp.concatenate([-q, b])
    sol, relres = sym_solve_eig(M, rhs, tol=tol)
    return sol[:n], sol[n:], relres


@partial(jax.jit, static_argnames=("method", "refine"))
def kkt_solve(
    H: jax.Array,
    A: jax.Array,
    q: jax.Array,
    b: jax.Array,
    *,
    method: str = "aug",
    delta: float | None = None,
    refine: int = 2,
    tol: float = 1e-10,
):
    """Solve ``H x + A^T w = -q``, ``A x = b``.  Returns ``(x, w, relres)``."""
    if A.shape[0] == 0:
        # no equality constraints degenerates to a symmetric solve
        x, relres = sym_solve(H, -q, method=method, delta=delta,
                              refine=refine, tol=tol)
        return x, jnp.zeros((0,), H.dtype), relres

    if method == "chol":
        x, w = _block_solve(H, A, q, b, delta=delta, refine=refine)
        return x, w, _kkt_residual(H, A, q, b, x, w, tol)

    if method == "aug":
        K, z = _augmented(H, A, q, b)
        solve_template = _make_block_solver(K, A, delta=delta)
        x, w = solve_template(z, b)

        # refine against the ORIGINAL system through the augmented template
        def refine_step(_, xw):
            x, w = xw
            r1 = H @ x + A.T @ w + q
            r2 = A @ x - b
            _, zr = _augmented(H, A, r1, -r2)
            dx, dw = solve_template(zr, -r2)
            return x + dx, w + dw

        if refine > 0:
            x, w = lax.fori_loop(0, refine, refine_step, (x, w))
        return x, w, _kkt_residual(H, A, q, b, x, w, tol)

    if method == "ladder":
        # stage 1 -> stage 2 -> stage 3, escalating on bad residuals
        x1, w1 = _block_solve(H, A, q, b, delta=delta, refine=refine)
        r1 = _kkt_residual(H, A, q, b, x1, w1, tol)

        def stage2(_):
            K, z = _augmented(H, A, q, b)
            x2, w2 = _block_solve(K, A, z, b, delta=delta, refine=refine)
            r2 = _kkt_residual(H, A, q, b, x2, w2, tol)

            def stage3(_):
                return _kkt_eig_solve(H, A, q, b, tol=tol)

            return lax.cond(r2 <= tol, lambda _: (x2, w2, r2), stage3,
                            operand=None)

        return lax.cond(r1 <= tol, lambda _: (x1, w1, r1), stage2,
                        operand=None)

    raise ValueError(f"unknown kkt method: {method!r}")


@partial(jax.jit, static_argnames=("method", "refine"))
def sym_solve(
    H: jax.Array,
    r: jax.Array,
    *,
    method: str = "aug",
    delta: float | None = None,
    refine: int = 2,
    tol: float = 1e-10,
):
    """Solve symmetric ``H x = r`` (no equality constraints).

    Re-design of cvx/SymmetricLinearSystem.scala:15-56: equilibrate + shifted
    Cholesky + refinement; with ``method="ladder"`` escalate to the spectral
    solve on a bad residual via ``lax.cond``.  Returns ``(x, relres)``.
    """
    from .cholesky import cholesky_solve  # local import to avoid cycle

    x, relres = cholesky_solve(H, r, delta=delta, refine=refine, tol=tol)
    if method == "ladder":
        def escalate(_):
            return sym_solve_eig(H, r, tol=tol)
        x, relres = lax.cond(relres <= tol, lambda _: (x, relres), escalate,
                             operand=None)
    return x, relres


@partial(jax.jit, static_argnames=("refine",))
def lin_solve(
    A: jax.Array,
    b: jax.Array,
    *,
    delta: float | None = None,
    refine: int = 2,
    tol: float = 1e-10,
    sym_tol: float = 1e-12,
):
    """General square solve with the reference's symmetry dispatch
    (SymmetricLinearSystem.scala:28-55): symmetric to tolerance -> the
    equilibrated Cholesky/eig path; non-symmetric -> ``svd_solve``.

    The symmetry test is data-dependent, so under jit it becomes a
    ``lax.cond`` (both branches trace; intended for single-instance use).
    Returns ``(x, relres)``.
    """
    from .eigsolve import svd_solve

    scale = jnp.maximum(jnp.max(jnp.abs(A)), jnp.finfo(A.dtype).tiny)
    asym = jnp.max(jnp.abs(A - A.T)) / scale

    def sym_path(_):
        return sym_solve(A, b, method="ladder", delta=delta, refine=refine,
                         tol=tol)

    def svd_path(_):
        return svd_solve(A, b, tol=tol)

    return lax.cond(asym <= sym_tol, sym_path, svd_path, operand=None)
