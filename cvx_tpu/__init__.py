"""cvx_tpu — a dense convex-minimization framework for accelerators.

Brand-new implementation of the capabilities of the reference library
spyqqqdia/cvx (Boyd–Vandenberghe interior-point methods: log-barrier and
infeasible-start primal-dual solvers, phase-I feasibility analysis, convex
duality, and Kullback–Leibler distance minimization), re-designed for
JAX/XLA/Pallas (the GPU is the accelerator of record): autodiff objectives, jit-compiled lax.while_loop
solver loops, vmap instance batching, and shard_map distribution.

See SURVEY.md for the layer map and the reference cross-references.
"""

__version__ = "0.1.0"

from . import (checkpoint, diagnostics, models, ops, parallel, problem,  # noqa: F401
               solvers, testing)
from .api import minimize  # noqa: F401
from .checkpoint import load_pytree, resume_barrier, save_pytree  # noqa: F401
from .duality import solve_dual  # noqa: F401
