"""Pytree-dataclass helper.

All problem/solver objects in cvx_tpu are frozen dataclasses registered as JAX
pytrees so they can flow through jit / vmap / shard_map.  Array-valued fields
are leaves; callables and structural metadata are static (part of the treedef,
so changing them triggers retracing, as intended).

Usage:

    @pytree_dataclass
    class LinearObjective:
        a: jax.Array
        r: jax.Array
        dim: int = static_field()
"""

from __future__ import annotations

import dataclasses
from typing import Any, TypeVar

import jax

_T = TypeVar("_T")


def static_field(**kwargs: Any) -> Any:
    """A dataclass field treated as static metadata (not a pytree leaf)."""
    metadata = dict(kwargs.pop("metadata", {}) or {})
    metadata["static"] = True
    return dataclasses.field(metadata=metadata, **kwargs)


def pytree_dataclass(cls: type[_T]) -> type[_T]:
    """Decorator: freeze the class and register it as a JAX pytree node."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    data_fields = []
    meta_fields = []
    for f in dataclasses.fields(cls):
        if f.metadata.get("static", False):
            meta_fields.append(f.name)
        else:
            data_fields.append(f.name)
    return jax.tree_util.register_dataclass(
        cls, data_fields=data_fields, meta_fields=meta_fields
    )


def replace(obj: _T, **changes: Any) -> _T:
    """dataclasses.replace that works on pytree dataclasses."""
    return dataclasses.replace(obj, **changes)


def mxu_exact(fn):
    """Trace the wrapped solver under exact-f32 matmul precision.

    On the GPU, f32 matmuls/einsums may run in TF32 (about three decimal
    digits).  That is fine for neural nets, but it poisons interior-point
    arithmetic: Newton gradients stall around 1e-3 and the measured
    duality gap of an f32 route floors near 1e-3 instead of ~1e-6.  Every solver entry point is wrapped so
    all contractions traced inside run at Precision.HIGHEST; dense
    factorizations (lax.linalg) are unaffected (natively f32).
    """
    import functools

    import jax as _jax

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with _jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapped
