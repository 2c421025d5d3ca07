"""Tensor-parallel dense factorization: sharded Cholesky / KKT for ONE
large instance.

SURVEY.md section 2.4 (TP row): a single huge Newton system (n ~ 10k dense
Hessian) does not fit one chip's HBM comfortably and its O(n^3)
factorization should ride the whole slice.  This module generalizes the
reference's block elimination (cvx/KKTSystem.scala:99-167,
solveWithCholFactor) to a ROW-SHARDED H under ``shard_map``:

  * ``sharded_cholesky``: blocked right-looking Cholesky.  H is sharded by
    block rows over the mesh axis; per block column k the owner's block row
    is broadcast (one psum of (bs, n)), every device factors the (bs, bs)
    diagonal block redundantly (tiny), computes its local panel piece with a
    triangular solve, all-gathers the (n, bs) panel over the mesh, and applies
    the rank-bs trailing update to its local slab.  Communication per step
    is O(n*bs); total O(n^2) — subordinate to the O(n^3/D) local GEMM work,
    which keeps the work in large matmuls.
  * ``sharded_chol_solve``: forward/back substitution on the sharded
    factor.  Forward: the owner of block k solves locally and broadcasts
    y_k (a (bs, nrhs) psum).  Backward: the column-panel dot products are
    genuinely distributed (each device contributes its rows) and psum'd.
  * ``tp_kkt_solve``: block elimination for [[H, A^T], [A, 0]] with H
    sharded and the p equality rows replicated — factor H distributed,
    solve H X = [A^T, -q] distributed, form the small Schur complement
    S = A X replicated, back-substitute.  KKTSystem.scala:99-167 at
    mesh scale.

Correctness: sharded == jnp.linalg on the 8-device CPU mesh at n = 2048
(tests/test_tp_chol.py); the driver dryrun compiles it multi-device.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax, shard_map
from jax.sharding import Mesh, PartitionSpec as P


def _block_owner_bcast(A_loc, k, bs, rows_loc, axis):
    """Broadcast block row k (bs, n) of the row-sharded matrix: the owner
    contributes its slab slice, everyone else zeros; one psum."""
    d = lax.axis_index(axis)
    my_start = d * rows_loc
    local_start = k * bs - my_start
    in_mine = jnp.logical_and(local_start >= 0,
                              local_start + bs <= rows_loc)
    start = jnp.clip(local_start, 0, rows_loc - bs)
    piece = lax.dynamic_slice(A_loc, (start, jnp.zeros_like(start)),
                              (bs, A_loc.shape[1]))
    piece = jnp.where(in_mine, piece, 0.0)
    return lax.psum(piece, axis)


def _make_cholesky_local(n: int, bs: int, axis: str):
    """The per-device body of the sharded blocked Cholesky."""
    nblocks = n // bs

    def local(A_loc):
        rows_loc = A_loc.shape[0]
        d = lax.axis_index(axis)
        rows_glob = d * rows_loc + jnp.arange(rows_loc)
        L_loc = jnp.zeros_like(A_loc)

        def step(k, carry):
            A_loc, L_loc = carry
            blockrow = _block_owner_bcast(A_loc, k, bs, rows_loc, axis)
            Akk = lax.dynamic_slice(blockrow, (0, k * bs), (bs, bs))
            Lkk = jnp.linalg.cholesky(Akk)       # redundant tiny factor
            # local panel piece: A_ik Lkk^{-T} for my below-diagonal rows
            Acol = lax.dynamic_slice(A_loc, (0, k * bs), (rows_loc, bs))
            Ppiece = jax.scipy.linalg.solve_triangular(
                Lkk, Acol.T, lower=True).T       # (rows_loc, bs)
            below = (rows_glob >= (k + 1) * bs)[:, None]
            Pbelow = jnp.where(below, Ppiece, 0.0)
            # my rows inside block k take the rows of Lkk itself
            in_k = jnp.logical_and(rows_glob >= k * bs,
                                   rows_glob < (k + 1) * bs)
            idx = jnp.clip(rows_glob - k * bs, 0, bs - 1)
            Lcol = jnp.where(in_k[:, None], Lkk[idx, :], Pbelow)
            L_loc = lax.dynamic_update_slice(L_loc, Lcol, (0, k * bs))
            # trailing rank-bs update with the full (n, bs) panel
            Pfull = lax.all_gather(Pbelow, axis, tiled=True)  # (n, bs)
            A_loc = A_loc - Pbelow @ Pfull.T
            return A_loc, L_loc

        _, L_loc = lax.fori_loop(0, nblocks, step, (A_loc, L_loc))
        return L_loc

    return local


def _make_solve_local(n: int, bs: int, axis: str):
    """Forward + back substitution on the row-sharded factor; rhs
    replicated (n, nrhs); solution replicated."""
    nblocks = n // bs

    def local(L_loc, B):
        rows_loc = L_loc.shape[0]
        d = lax.axis_index(axis)
        my_start = d * rows_loc
        nrhs = B.shape[1]

        # ---- forward: L y = B, block k solved by its owner, broadcast ----
        def fwd(k, Y):
            blockrow = _block_owner_bcast(L_loc, k, bs, rows_loc, axis)
            Lkk = lax.dynamic_slice(blockrow, (0, k * bs), (bs, bs))
            Bk = lax.dynamic_slice(B, (k * bs, 0), (bs, nrhs))
            # columns < k*bs of the block row hit already-known y
            col_mask = (jnp.arange(n) < k * bs).astype(L_loc.dtype)
            rhs = Bk - (blockrow * col_mask[None, :]) @ Y
            Yk = jax.scipy.linalg.solve_triangular(Lkk, rhs, lower=True)
            return lax.dynamic_update_slice(Y, Yk, (k * bs, 0))

        Y = lax.fori_loop(0, nblocks, fwd, jnp.zeros((n, nrhs), B.dtype))

        # ---- backward: L^T x = y; panel dot products are distributed ----
        rows_glob = my_start + jnp.arange(rows_loc)

        def bwd(i, X):
            k = nblocks - 1 - i
            # sum_{j > k} L_jk^T x_j: each device contributes its rows
            Lcol = lax.dynamic_slice(L_loc, (0, k * bs), (rows_loc, bs))
            below = (rows_glob >= (k + 1) * bs)[:, None]
            Xloc = lax.dynamic_slice(X, (my_start, jnp.zeros_like(my_start)),
                                     (rows_loc, nrhs))
            part = (jnp.where(below, Lcol, 0.0)).T @ Xloc    # (bs, nrhs)
            s = lax.psum(part, axis)
            blockrow = _block_owner_bcast(L_loc, k, bs, rows_loc, axis)
            Lkk = lax.dynamic_slice(blockrow, (0, k * bs), (bs, bs))
            Yk = lax.dynamic_slice(Y, (k * bs, 0), (bs, nrhs))
            Xk = jax.scipy.linalg.solve_triangular(Lkk, Yk - s, lower=True,
                                                   trans=1)
            return lax.dynamic_update_slice(X, Xk, (k * bs, 0))

        X = lax.fori_loop(0, nblocks, bwd, jnp.zeros((n, nrhs), B.dtype))
        return X

    return local


def _check_shapes(n: int, n_devices: int, bs: int):
    if n % (n_devices * bs) != 0:
        raise ValueError(
            f"n={n} must be divisible by n_devices*block "
            f"({n_devices}*{bs}) so block rows never straddle devices")


def make_sharded_cholesky(mesh: Mesh, n: int, *, axis: str = "tp",
                          block: int = 128):
    """Return ``chol(H) -> L`` for an (n, n) SPD matrix row-sharded over
    ``mesh``.  Input/output sharding: P(axis, None)."""
    D = mesh.shape[axis]
    _check_shapes(n, D, block)
    fn = shard_map(_make_cholesky_local(n, block, axis), mesh=mesh,
                   in_specs=P(axis, None), out_specs=P(axis, None),
                   check_vma=False)
    return jax.jit(fn)


def make_sharded_chol_solve(mesh: Mesh, n: int, *, axis: str = "tp",
                            block: int = 128):
    """Return ``solve(L, B) -> X`` with L row-sharded (from
    make_sharded_cholesky) and B/X replicated (n, nrhs)."""
    D = mesh.shape[axis]
    _check_shapes(n, D, block)
    fn = shard_map(_make_solve_local(n, block, axis), mesh=mesh,
                   in_specs=(P(axis, None), P()), out_specs=P(),
                   check_vma=False)
    return jax.jit(fn)


def make_tp_kkt_solver(mesh: Mesh, n: int, p: int, *, axis: str = "tp",
                       block: int = 128):
    """Return ``kkt(H, A, q, b) -> (x, w)`` solving

        H x + A^T w = -q,    A x = b,

    with H (n, n) row-sharded over the mesh and A (p, n) replicated
    (p << n).  Block elimination with the Schur complement S = A H^-1 A^T,
    generalizing KKTSystem.scala:99-167 to mesh scale: ONE distributed
    factorization, one distributed multi-rhs solve, a replicated (p, p)
    factorization, one more distributed solve for the final x.
    """
    D = mesh.shape[axis]
    _check_shapes(n, D, block)
    chol_local = _make_cholesky_local(n, block, axis)
    solve_local = _make_solve_local(n, block, axis)

    def local(H_loc, A, q, b):
        L_loc = chol_local(H_loc)
        rhs = jnp.concatenate([A.T, q[:, None]], axis=1)   # (n, p+1)
        X = solve_local(L_loc, rhs)                        # H^-1 [A^T q]
        Hinv_At, Hinv_q = X[:, :p], X[:, p]
        S = A @ Hinv_At                                    # (p, p) replicated
        S = 0.5 * (S + S.T)
        Ls = jnp.linalg.cholesky(S)
        z = -(b + A @ Hinv_q)
        w = jax.scipy.linalg.cho_solve((Ls, True), z)
        x = -(Hinv_q + Hinv_At @ w)
        return x, w

    fn = shard_map(local, mesh=mesh,
                   in_specs=(P(axis, None), P(), P(), P()),
                   out_specs=(P(), P()), check_vma=False)
    return jax.jit(fn)
