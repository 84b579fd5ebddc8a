"""The modules a run may not load: JAX and the JAX package the port was
made from. Compared by whole top-level name (the part before the first
dot), so `repro_torch` passes and `repro` does not."""
from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_loaded(modules=None) -> list:
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)
