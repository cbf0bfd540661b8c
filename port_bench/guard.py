"""The import guard: the benchmark measures the PyTorch port, and nothing
in the process that prints the result may have loaded JAX or the JAX
package.  Module names are compared by their top-level name (the part
before the first dot) as a whole, since the port's name begins with the
JAX package's."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "wrfchem_arc_interactions_tpu"})


def jax_modules(modules=None) -> list:
    """The loaded modules whose top-level name is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".", 1)[0] in FORBIDDEN)
