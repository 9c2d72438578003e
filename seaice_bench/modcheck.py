"""The check that no JAX module is loaded in the measuring process.

Names are compared by their top-level part (before the first dot) whole:
``climaseaice_jl_tpu_torch`` is the measured package, ``climaseaice_jl_tpu``
the JAX one."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "climaseaice_jl_tpu")


def forbidden_modules(names=None):
    """The forbidden top-level names among ``names`` (default: the loaded
    modules), sorted."""
    names = sys.modules if names is None else names
    return sorted({n.split(".", 1)[0] for n in names} & set(FORBIDDEN))
