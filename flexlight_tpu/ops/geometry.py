"""Per-frame geometry world-transform pass.

Design departure from the reference: the GLSL traversal re-bases
the *ray* into each node's object space whenever the transform id changes
(pathtracer_fragment.glsl:193-203). That is the right call for a scalar
per-pixel kernel, but in a batched wavefront it would put a mat3
gather+matvec inside the innermost traversal loop of every ray.

Instead we bake transforms into the geometry once per frame: a single
vectorized [S]-wide pass producing world-space triangles and conservative
world-space AABBs (rotate the 8 corners, re-box). Traversal then needs no
transform logic at all. Hit parameters (s, u, v) are identical because the
object-space ray test is an affine re-parameterization of the world-space
test (vertex transform: pathtracer_vertex.glsl:65).

Cost: O(S) elementwise work per frame (S = slots), fully fused by XLA —
negligible next to traversal, and it keeps transforms runtime inputs so
per-frame animation (wave.js:64-73) never re-flattens.
"""

from __future__ import annotations

import jax.numpy as jnp

from .buffers import SceneBuffers


def world_geometry(buffers: SceneBuffers) -> jnp.ndarray:
    """geometry [S,12] + transforms -> world-space geometry [S,12]."""
    g = buffers.geometry
    t_idx = g[:, 9].astype(jnp.int32)
    # Full-row gathers, then column slices
    rot = buffers.rotations[t_idx][:, 0]   # [S, 3, 3] forward rotation*scale
    pos = buffers.shifts[t_idx][:, 0]      # [S, 3]
    kind = g[:, 10]

    # Triangles: world v = R v + pos (pathtracer_vertex.glsl:65)
    verts = g[:, 0:9].reshape(-1, 3, 3)
    world_verts = jnp.einsum("sij,svj->svi", rot, verts) + pos[:, None, :]

    # BVH nodes: transform the 8 AABB corners, take the new min/max box.
    # Conservative (>= exact transformed box), so traversal stays correct.
    mins, maxs = g[:, 0:3], g[:, 3:6]
    corners = jnp.stack([
        jnp.stack([jnp.where(jnp.bool_((c >> a) & 1), maxs[:, a], mins[:, a])
                   for a in range(3)], axis=-1)
        for c in range(8)
    ], axis=1)                              # [S, 8, 3]
    world_corners = jnp.einsum("sij,scj->sci", rot, corners) + pos[:, None, :]
    w_min = world_corners.min(axis=1)
    w_max = world_corners.max(axis=1)

    is_tri = (kind == 2.0)[:, None]
    first9 = jnp.where(
        is_tri,
        world_verts.reshape(-1, 9),
        jnp.concatenate([w_min, w_max, g[:, 6:9]], axis=-1),
    )
    return jnp.concatenate([first9, g[:, 9:]], axis=-1)
