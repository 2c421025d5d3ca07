"""What the device offers, decided in one place.

Every route choice that depends on the hardware asks this module:

  * ``is_gpu()`` — is the default JAX device an NVIDIA GPU?
  * ``pallas_mode(interpret)`` — how a Pallas kernel runs: compiled through
    Triton on the GPU, or in the Pallas interpreter, but ONLY when the
    caller asked for it.  Anywhere else there is no compiled route, and
    asking for one raises instead of dropping into the interpreter.
  * ``kl_dual_route(n, k, m_eq, interpret)`` — which route the KL fleet
    takes (the kernel only where it measured faster: ``TRITON_MAX_DIM``,
    ``TRITON_MAX_N``):
    ``"triton"`` (the fused dual kernel, ops/pallas_kl_dual.py),
    ``"interpret"`` (the same kernel in the interpreter, by request) or
    ``"xla"`` (``DistKL.solve_dual_newton`` under vmap).  The model layer
    uses the answer and ``chip_smoke.py`` checks that the route it reports
    is the route that ran.
  * ``enable_compile_cache()`` — where the persistent XLA compile cache
    lives.  Entry points (``chip_smoke.py``, ``bench.py``,
    ``bench_scaling.py``) call it; importing the library does not.
"""

from __future__ import annotations

import os
import pathlib

import jax

# widest dual dimension k + 1 + mE the fused kernel unrolls per program
# (its small Newton system is straight-line code over (bt, 1) scalars)
FUSED_MAX_DIM = 16

# Where the fleet takes the Triton kernel, as measured on an H100 against
# the XLA route (PERF.md, "Findings"): it won at every dual dim from 3 to
# 12 (6.3x at dim 3, 1.25x at dim 12) and lost at dim 16 (33.3 vs
# 10.8 ms per 10,000 instances); it won at every row width measured,
# up to n = 10,000 (13x).  Beyond either bound the XLA route runs.
TRITON_MAX_DIM = 12
TRITON_MAX_N = 10000

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"


def platform() -> str:
    """Platform of the default device: "gpu", "cpu", ..."""
    return jax.devices()[0].platform


def is_gpu() -> bool:
    return platform() == "gpu"


def pallas_mode(interpret: bool = False) -> str:
    """``"interpret"`` when asked for, else ``"triton"`` on a GPU; raises
    where no compiled Pallas route exists."""
    if interpret:
        return "interpret"
    if is_gpu():
        return "triton"
    raise RuntimeError(
        f"no compiled Pallas route on platform {platform()!r}; pass "
        "interpret=True to run the kernel in the Pallas interpreter")


def kl_dual_route(n: int, k: int, m_eq: int, *,
                  interpret: bool = False) -> str:
    """The KL fleet route for n scenarios, k inequality rows and m_eq
    extra equalities: ``"triton"``, ``"interpret"`` or ``"xla"``."""
    if not (k + m_eq >= 1 and k + 1 + m_eq <= FUSED_MAX_DIM):
        return "xla"
    if interpret:
        return "interpret"
    if is_gpu() and n <= TRITON_MAX_N and k + 1 + m_eq <= TRITON_MAX_DIM:
        return "triton"
    return "xla"


def compile_cache_dir() -> str:
    """``$JAX_COMPILATION_CACHE_DIR`` if set, else ``<checkout>/.jax_cache``
    (one fixed path: the cache key includes it, so it must not move)."""
    env = os.environ.get(CACHE_ENV)
    if env:
        return env
    return str(pathlib.Path(__file__).resolve().parent.parent / ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at ``compile_cache_dir()``.

    With ``JAX_COMPILATION_CACHE_DIR`` set, JAX already reads it and this
    sets nothing.  Returns the directory in use."""
    path = compile_cache_dir()
    if not os.environ.get(CACHE_ENV):
        jax.config.update("jax_compilation_cache_dir", path)
    return path
