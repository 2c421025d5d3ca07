"""Checkpoint / resume for solver state.

The reference has no checkpointing (SURVEY.md section 5.4: solves are
short-lived, state is local ``var``s).  In this framework every solver's
state is an explicit pytree (Solution, FeasibilityReport, while_loop
carries), so checkpointing is pure serialization:

  * ``save_pytree`` / ``load_pytree`` persist ANY pytree of arrays to one
    ``.npz`` file (leaves in tree order; the treedef is reconstructed from
    a structural template at load — classes and static fields never touch
    disk, so files stay portable across code changes that don't alter the
    leaf structure);
  * ``resume_barrier`` continues a barrier continuation from a
    checkpointed Solution: the continuation is memoryless given (x, t) —
    the barrier parameter is recovered from the certified gap (t = m/gap)
    and passed back as ``t0`` (barrier_solve/BarrierSolver.scala:73 starts
    at t0=1 only because the reference cannot resume);
  * ``resume_structured`` — the same (x, t)-memorylessness argument for
    the PRODUCTION route ``solvers.structured.barrier_solve_structured``
    (BR_fast): fleet preemption coverage for the fast path, not only the
    dense one.

The fused dual kernel (ops/pallas_kl_dual.py) runs a FIXED branch-free
schedule with no mid-kernel state to checkpoint and solves a whole fleet
in one call: re-running it outright IS the resume.

Large batched runs (the north-star fleet workloads) can therefore be
stopped and continued for free, e.g. between preemptions.
"""

from __future__ import annotations

from typing import Any, TypeVar

import jax
import jax.numpy as jnp
import numpy as np

_T = TypeVar("_T")


def _npz_path(path: str) -> str:
    # np.savez silently appends '.npz' to other suffixes but np.load does
    # not — normalizing BOTH sides keeps save/load round-trips working for
    # any path the caller picked (e.g. 'run1.ckpt')
    return path if path.endswith(".npz") else path + ".npz"


def save_pytree(path: str, tree: Any) -> int:
    """Save every array leaf of ``tree`` to ``path`` (.npz appended when
    missing).  Returns the number of leaves written."""
    leaves = jax.tree_util.tree_leaves(tree)
    np.savez(_npz_path(path), **{f"leaf_{i}": np.asarray(leaf)
                                 for i, leaf in enumerate(leaves)})
    return len(leaves)


def load_pytree(path: str, like: _T) -> _T:
    """Load a pytree saved by ``save_pytree``.  ``like`` supplies the
    structure (same type/treedef as the saved object; its leaf VALUES are
    ignored)."""
    data = np.load(_npz_path(path))
    leaves_like, treedef = jax.tree_util.tree_flatten(like)
    if len(data.files) != len(leaves_like):
        raise ValueError(
            f"checkpoint has {len(data.files)} leaves, template has "
            f"{len(leaves_like)} — structure changed since saving")
    leaves = []
    for i, tmpl in enumerate(leaves_like):
        loaded = data[f"leaf_{i}"]
        t_shape = jnp.shape(tmpl)
        t_dtype = jnp.result_type(tmpl)
        if loaded.shape != t_shape or loaded.dtype != t_dtype:
            raise ValueError(
                f"checkpoint leaf {i} is {loaded.dtype}{list(loaded.shape)} "
                f"but the template expects {t_dtype}{list(t_shape)} — "
                "same-arity reshape would mis-broadcast downstream")
        leaves.append(jnp.asarray(loaded))
    return jax.tree_util.tree_unflatten(treedef, leaves)


def resume_barrier(obj, cnts, sol, pars=None, eqs=None):
    """Continue a barrier continuation from a checkpointed Solution.

    The barrier method's whole state is (x, t): ``sol.x`` is strictly
    feasible (it is an interior iterate) and the barrier parameter is
    recovered from the reported continuation gap ``m/t``.  Returns the
    finished Solution — bitwise-equivalent in result quality to having run
    the continuation straight through (the continuation is memoryless).
    """
    from .solvers.barrier import barrier_solve
    from .solvers.types import SolverParams

    pars = pars or SolverParams()
    m = cnts.m
    gaps = np.asarray(sol.duality_gap)
    if not np.all(np.isfinite(gaps)) or np.any(gaps <= 0):
        raise ValueError(
            f"cannot resume from gap={gaps!r} (unhealthy checkpoint — "
            "check sol.status)")
    if np.all(gaps <= pars.tol):
        # already past the target: re-entering the continuation with
        # t0 > t_max would skip the loop and return its (inf, inf) init
        # diagnostics — the checkpoint IS the finished solution
        return sol
    if gaps.ndim >= 1:
        # batched (vmapped) Solution: per-instance t, whole batch resumed
        # in one vmapped continuation.  t0 clamped below the loop's entry
        # threshold so ALREADY-converged instances of a mixed batch still
        # run one (cheap) closing stage instead of skipping the loop and
        # returning its (inf, inf) init diagnostics.
        t_cap = 0.99 * pars.mu * m / pars.tol
        t0s = jnp.minimum(pars.mu * m / jnp.asarray(gaps), t_cap)
        return jax.vmap(
            lambda x, t0: barrier_solve(obj, cnts, x, pars, eqs=eqs, t0=t0)
        )(sol.x, t0s)
    t0 = pars.mu * m / float(gaps)  # next stage after the checkpointed one
    return barrier_solve(obj, cnts, sol.x, pars, eqs=eqs, t0=t0)


def resume_structured(obj, U, ub, A, b, sol, pars=None):
    """Continue a STRUCTURED (Woodbury) barrier continuation — the BR_fast
    production route — from a checkpointed Solution.

    Same memorylessness argument as ``resume_barrier``: the continuation
    state is exactly (x, t); ``sol.x`` is a strictly feasible interior
    iterate and t is recovered from the reported continuation gap
    m/t with m = k + n (the k dense rows plus the n built-in positivity
    terms, solvers/structured.py).  The finished Solution matches a
    straight-through run to certificate level
    (tests/test_round3.py::TestResumeProduction).
    """
    from .solvers.structured import barrier_solve_structured
    from .solvers.types import SolverParams

    pars = pars or SolverParams()
    m = U.shape[0] + sol.x.shape[-1]
    gaps = np.asarray(sol.duality_gap)
    if not np.all(np.isfinite(gaps)) or np.any(gaps <= 0):
        raise ValueError(
            f"cannot resume from gap={gaps!r} (unhealthy checkpoint — "
            "check sol.status)")
    if np.all(gaps <= pars.tol):
        return sol
    if gaps.ndim >= 1:
        # batched fleet checkpoint (see resume_barrier)
        t_cap = 0.99 * pars.mu * m / pars.tol
        t0s = jnp.minimum(pars.mu * m / jnp.asarray(gaps), t_cap)
        return jax.vmap(
            lambda x, t0: barrier_solve_structured(obj, U, ub, A, b, x,
                                                   pars, t0=t0)
        )(sol.x, t0s)
    t0 = pars.mu * m / float(gaps)
    return barrier_solve_structured(obj, U, ub, A, b, sol.x, pars, t0=t0)
