"""Ray-primitive intersection tests (vectorized, jnp).

Counterparts of the device routines in
`shaders/pathtracer_fragment.glsl`:

- moeller_trumbore       — full two-sided test (glsl:123-140)
- moeller_trumbore_cull  — front-face any-hit test for shadows (glsl:143-158)
- ray_cuboid             — slab AABB test (glsl:161-167)

All functions broadcast over leading dimensions; rays and triangles are
[..., 3] float32. The BIAS epsilon and every accept/reject condition match
the reference exactly (including its asymmetries), so hits are identical.
"""

from __future__ import annotations

import jax.numpy as jnp

BIAS = 0.0000152587890625  # 2^-16, glsl:8
POW32 = 4294967296.0


def _cross(a, b):
    return jnp.cross(a, b)


def _dot(a, b):
    return jnp.sum(a * b, axis=-1)


def moeller_trumbore(v0, v1, v2, origin, direction, max_len):
    """Two-sided Möller-Trumbore. Returns suv [..., 3]; suv[...,0]==0 on miss.

    Accept window (glsl:128-139): |det|>=BIAS, u in (BIAS, 1], v > BIAS,
    u+v <= 1, s in (BIAS, max_len].
    """
    edge1 = v1 - v0
    edge2 = v2 - v0
    pvec = _cross(direction, edge2)
    det = _dot(edge1, pvec)
    inv_det = 1.0 / det
    tvec = origin - v0
    u = _dot(tvec, pvec) * inv_det
    qvec = _cross(tvec, edge1)
    v = _dot(direction, qvec) * inv_det
    s = _dot(edge2, qvec) * inv_det
    valid = (jnp.abs(det) >= BIAS)
    valid &= (u >= BIAS) & (u <= 1.0)
    valid &= (v >= BIAS) & (u + v <= 1.0)
    valid &= (s <= max_len) & (s > BIAS)
    suv = jnp.stack([s, u, v], axis=-1)
    return jnp.where(valid[..., None], suv, 0.0)


def moeller_trumbore_cull(v0, v1, v2, origin, direction, max_len):
    """Front-facing-only any-hit test (glsl:143-158). Returns bool [...]. """
    edge1 = v1 - v0
    edge2 = v2 - v0
    pvec = _cross(direction, edge2)
    det = _dot(edge1, pvec)
    inv_det = 1.0 / det
    tvec = origin - v0
    u = _dot(tvec, pvec) * inv_det
    qvec = _cross(tvec, edge1)
    v = _dot(direction, qvec) * inv_det
    s = _dot(edge2, qvec) * inv_det
    hit = det >= BIAS
    hit &= (u >= BIAS) & (u <= 1.0)
    hit &= (v >= BIAS) & (u + v <= 1.0)
    hit &= (s <= max_len) & (s > BIAS)
    return hit


def ray_cuboid(max_len, origin, inv_direction, min_corner, max_corner):
    """Slab AABB test (glsl:161-167). Takes 1/direction so the reciprocal is
    hoisted out of traversal loops. Returns bool [...]."""
    v0 = (min_corner - origin) * inv_direction
    v1 = (max_corner - origin) * inv_direction
    lo = jnp.minimum(v0, v1)
    hi = jnp.maximum(v0, v1)
    tmin = jnp.max(lo, axis=-1)
    tmax = jnp.min(hi, axis=-1)
    return (tmax >= jnp.maximum(tmin, BIAS)) & (tmin < max_len)
