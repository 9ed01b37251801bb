"""Traversal schemes and the one rule that picks between them.

Every renderer resolves ``scheme="auto"`` here, and the rule reads only
the scene: the same XLA formulations serve every backend. The denoise
passes (post.filters, jnp gathers) and FXAA (post.fxaa.fxaa) have a
single implementation each, so traversal is the only choice left.

- ``scan``      chunked linear scan of every triangle (ops.traverse) —
                the correctness oracle
- ``packet``    skip-pointer BVH walk over coherent ray packets
- ``mxu``       Möller-Trumbore as one [N, 16] @ [16, 4T] contraction
                against every triangle (ops.traverse_mxu)
- ``clustered`` two-phase cluster cull + the same contraction per
                candidate chunk (ops.traverse_clustered)
"""

from __future__ import annotations

SCHEMES = ("scan", "packet", "mxu", "clustered")

# Largest scene `auto` sends to the all-pairs `mxu` cast; above it the
# [N, 4T] product outgrows the cluster cull's overhead and `clustered`
# takes over. See PERF.md for the crossover measurement behind it.
MXU_MAX_TRIS = 8192


def check_scheme(scheme: str) -> str:
    """Return `scheme` if it names a traversal scheme, else raise."""
    if scheme not in SCHEMES:
        raise ValueError(f"unknown traversal scheme {scheme!r}; "
                         f"expected 'auto' or one of {', '.join(SCHEMES)}")
    return scheme


def resolve_scheme(scheme: str, n_tris: int) -> str:
    """The scheme a renderer runs: `scheme` itself, or for "auto" the
    all-pairs cast up to MXU_MAX_TRIS triangles and the clustered cast
    above."""
    if scheme == "auto":
        return "mxu" if n_tris <= MXU_MAX_TRIS else "clustered"
    return check_scheme(scheme)
