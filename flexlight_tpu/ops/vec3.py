"""SoA 3-vector helpers for the wavefront shading path.

A vector batch is a tuple ``(x, y, z)`` of [N] float32 arrays. An AoS
``[N, 3]`` array puts a 3-wide axis minor, which vector hardware pads
or strides; separate [N] arrays keep every elementwise op dense and
contiguous, and 3x3 products become plain multiply-adds.

Boundary conversions to/from [N, 3] (``stack3``/``unstack3``) are single
relayouts; use them only at kernel and MRT-contract boundaries.
"""

from __future__ import annotations

import jax.numpy as jnp

V3 = tuple  # (x, y, z) of [N] arrays


def stack3(v) -> jnp.ndarray:
    return jnp.stack(v, axis=-1)


def unstack3(a: jnp.ndarray) -> V3:
    # one transpose, then free major-axis row views
    t = a.T
    return (t[0], t[1], t[2])


def add3(a: V3, b: V3) -> V3:
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def sub3(a: V3, b: V3) -> V3:
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def mul3(a: V3, b: V3) -> V3:
    return (a[0] * b[0], a[1] * b[1], a[2] * b[2])


def scale3(a: V3, s) -> V3:
    return (a[0] * s, a[1] * s, a[2] * s)


def neg3(a: V3) -> V3:
    return (-a[0], -a[1], -a[2])


def dot3(a: V3, b: V3) -> jnp.ndarray:
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross3(a: V3, b: V3) -> V3:
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def norm3(a: V3) -> jnp.ndarray:
    return jnp.sqrt(dot3(a, a))


def normalize3(a: V3) -> V3:
    inv = 1.0 / jnp.maximum(norm3(a), 1e-30)
    return scale3(a, inv)


def where3(m, a: V3, b: V3) -> V3:
    return (jnp.where(m, a[0], b[0]), jnp.where(m, a[1], b[1]),
            jnp.where(m, a[2], b[2]))


def mix3(a: V3, b: V3, t) -> V3:
    return (a[0] + (b[0] - a[0]) * t, a[1] + (b[1] - a[1]) * t,
            a[2] + (b[2] - a[2]) * t)


def full3(val, like) -> V3:
    x = jnp.full_like(like, val)
    return (x, x, x)


def const3(vec, like) -> V3:
    """Broadcast a length-3 constant vector over [N]."""
    return (jnp.full_like(like, vec[0]), jnp.full_like(like, vec[1]),
            jnp.full_like(like, vec[2]))


def matvec3(m, v: V3) -> V3:
    """m: 9 [N] (or scalar) entries row-major; returns m @ v."""
    return (m[0] * v[0] + m[1] * v[1] + m[2] * v[2],
            m[3] * v[0] + m[4] * v[1] + m[5] * v[2],
            m[6] * v[0] + m[7] * v[1] + m[8] * v[2])
