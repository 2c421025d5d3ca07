"""Coarse-blocked Cholesky for SINGLE LARGE matrices (n >= ~2048).

Re-design target: the reference's only native capability is its LAPACK
dpotrf boundary (cvx/MatrixUtils.scala:362-376, :452-461).  XLA expands
``lax.linalg.cholesky`` with a fixed narrow-panel algorithm on some
backends; this module is the coarser re-blocking to compare against.
Production paths (ops/kkt.py, ops/cholesky.py) use the XLA built-in
(cuSOLVER on the GPU); bench_scaling.py times both (``chol_*`` rows).

This module re-blocks the factorization at a COARSE width ``bk`` (512 by
default) with a static Python loop (n/bk unrolled HLO steps, all shapes
static):

  for each column block k:
    1. diagonal block  -> ``lax.linalg.cholesky``  (128-expander, tiny share)
    2. panel           -> one triangular solve     (bk x bk against n-k rows)
    3. trailing update -> ONE big syrk  M -= P P^T (the n^3/3 FLOPs, at
       matmul efficiency, precision="highest" — reduced-precision passes
       would poison interior-point numerics, see tree.mxu_exact)

so asymptotically all work runs at large-matmul MFU instead of the
expander's narrow-panel rate.  Factorization only — solves reuse
``ops.cholesky.chol_solve_factored``.

``cholesky_blocked(H, bk=...)`` is exact (no regularization): callers
shift/equilibrate first exactly as with the XLA built-in.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax


@partial(jax.jit, static_argnames=("bk", "panel_via_inverse"))
def cholesky_blocked(H: jax.Array, *, bk: int = 512,
                     panel_via_inverse: bool = True) -> jax.Array:
    """Lower Cholesky factor of symmetric PD ``H`` (n, n), coarse-blocked.

    Supports any n >= 1 (last block may be ragged).  Single instance only —
    for batches of small matrices use ``lax.linalg.cholesky``, which is
    batched and memory-bound there.

    ``panel_via_inverse=True`` (default) computes the row panel as
    ``P @ (Ld^-1)^T`` with an explicitly inverted bk x bk diagonal factor
    (one identity-RHS triangular solve per block step) — the cuSOLVER
    TRTRI+GEMM trick: XLA's TriangularSolveExpander is itself 128-blocked
    and would re-serialize the (n-k) x bk panel; an explicit inverse turns
    it into one matmul.  On an equilibrated + shifted block (condition
    O(1/delta) at worst) the extra forward-error factor is benign and the
    caller's iterative refinement absorbs it; ``False`` uses the
    triangular solve.
    """
    n = H.shape[-1]
    if H.ndim != 2:
        raise ValueError("cholesky_blocked is single-instance (n, n); "
                         "vmap/batched shapes should use lax.linalg.cholesky")
    if n <= bk:
        return lax.linalg.cholesky(H)

    dtype = H.dtype
    hi = partial(jnp.matmul, precision="highest")

    # working copy: M holds the not-yet-factored trailing matrix; L blocks
    # are written into `cols` and concatenated at the end (static shapes,
    # no dynamic updates)
    M = H
    col_blocks = []
    for k0 in range(0, n, bk):
        kb = min(bk, n - k0)
        rest = n - k0 - kb
        D = M[:kb, :kb]
        Ld = lax.linalg.cholesky(D)
        if rest > 0:
            P = M[kb:, :kb]                       # (rest, kb)
            # P_L = P Ld^{-T}: row-panel of L below the diagonal block
            if panel_via_inverse:
                Ld_inv = lax.linalg.triangular_solve(
                    Ld, jnp.eye(kb, dtype=dtype), left_side=True,
                    lower=True)
                P_L = hi(P, Ld_inv.T)
            else:
                P_L = lax.linalg.triangular_solve(
                    Ld, P, left_side=False, lower=True, transpose_a=True)
            # trailing syrk: the matmul-dominant step
            T = M[kb:, kb:] - hi(P_L, P_L.T)
            T = 0.5 * (T + T.T)   # resymmetrize: rounding drift compounds
            M = T
            col = jnp.concatenate([Ld, P_L], axis=0)      # (n - k0, kb)
        else:
            col = Ld
        # pad the column block back to full height with zeros above
        if k0 > 0:
            col = jnp.concatenate(
                [jnp.zeros((k0, kb), dtype), col], axis=0)
        col_blocks.append(col)
    return jnp.concatenate(col_blocks, axis=1)
