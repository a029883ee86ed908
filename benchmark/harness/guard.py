"""The modules a run must not hold: JAX and the JAX package, compared by
the top-level name of each loaded module (the part before the first dot),
whole, so that the port, whose name begins with the JAX package's, passes."""

import sys

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'multi_part_assembly_tpu')


def forbidden_modules(modules=None):
    """Sorted top-level names of loaded modules that are forbidden."""
    names = sys.modules if modules is None else modules
    return sorted({m.split('.', 1)[0] for m in names} & set(FORBIDDEN))
