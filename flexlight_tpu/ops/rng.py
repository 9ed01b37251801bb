"""Stochastic noise for the path tracer, two modes behind Config.rng
(SURVEY §7 "RNG & reproducibility"):

- "hash" (default, reference-compat): reproduces the GLSL `noise()`
  semantics (pathtracer_fragment.glsl:119-121) bit-for-bit-style in
  float32 for golden-image parity:

      fract(sin(dot(n, (12.9898, 78.233)) + (53,59,61,67)*(seed+rs*PHI))
            * 43758.5453) * 2 - 1

  The sin-hash is fragile: correlated stripes at large |arg| and heavy
  precision loss where sin'(x)≈0.

- "counter" (quality): a stateless counter-based integer hash — the
  float32 BITS of the same four inputs chained through murmur3
  finalizer rounds (full avalanche), one extra round per output
  channel. Integer xor/mul/logical-shift only, so it gives the same
  bits on every backend. Same call contract and determinism (pure function of the
  inputs); different sample sequence, so goldens/oracle tests pin the
  hash mode only.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

# murmur3 finalizer constants as python ints (two's-complement int32)
_M1 = int(np.uint32(0x85EBCA6B).astype(np.int32))
_M2 = int(np.uint32(0xC2B2AE35).astype(np.int32))
_C4 = tuple(int(np.uint32(c).astype(np.int32))
            for c in (0x9E3779B9, 0x7F4A7C15, 0x94D049BB, 0xBF58476D))

PHI = 1.61803398874989484820459
_OFFSETS = jnp.array([53.0, 59.0, 61.0, 67.0], dtype=jnp.float32)
_DOT = jnp.array([12.9898, 78.233], dtype=jnp.float32)


def fract(x):
    return x - jnp.floor(x)


def noise(n: jnp.ndarray, seed, random_seed) -> jnp.ndarray:
    """n: [..., 2] -> [..., 4] in [-1, 1)."""
    n = n.astype(jnp.float32)
    d = n[..., 0] * _DOT[0] + n[..., 1] * _DOT[1]
    arg = d[..., None] + _OFFSETS * (jnp.float32(seed) + jnp.float32(random_seed) * jnp.float32(PHI))
    return fract(jnp.sin(arg) * jnp.float32(43758.5453)) * 2.0 - 1.0


def noise4(n0: jnp.ndarray, n1: jnp.ndarray, seed, random_seed,
           mode: str = "hash"):
    """SoA form of `noise`: two [N] coordinate components -> four [N]
    channels in [-1, 1) (SoA layout; see ops.vec3). `mode` picks the sin-hash (reference compat) or the counter hash
    (quality; see module docstring)."""
    if mode == "counter":
        return noise4_counter(n0, n1, seed, random_seed)
    d = (n0.astype(jnp.float32) * jnp.float32(12.9898)
         + n1.astype(jnp.float32) * jnp.float32(78.233))
    t = jnp.float32(seed) + jnp.float32(random_seed) * jnp.float32(PHI)
    mul = jnp.float32(43758.5453)
    return tuple(fract(jnp.sin(d + jnp.float32(o) * t) * mul) * 2.0 - 1.0
                 for o in (53.0, 59.0, 61.0, 67.0))


def _mix32(h):
    """murmur3 fmix32: full-avalanche 32-bit mix (logical shifts)."""
    h = h ^ jax.lax.shift_right_logical(h, 16)
    h = h * jnp.int32(_M1)
    h = h ^ jax.lax.shift_right_logical(h, 13)
    h = h * jnp.int32(_M2)
    h = h ^ jax.lax.shift_right_logical(h, 16)
    return h


def _bits(x):
    return jax.lax.bitcast_convert_type(jnp.asarray(x, jnp.float32),
                                        jnp.int32)


def noise4_counter(n0: jnp.ndarray, n1: jnp.ndarray, seed, random_seed):
    """Counter-hash noise: chain the float32 bits of the four inputs
    through fmix32 rounds; one keyed round per output channel. Output in
    [-1, 1) with 24 bits of mantissa-uniformity. Scalars are broadcast
    to the input shape before bitcasting."""
    shp = jnp.shape(n0)
    h = _mix32(_bits(n0))
    h = _mix32(h ^ _bits(n1))
    h = _mix32(h ^ _bits(jnp.broadcast_to(jnp.float32(seed), shp)))
    h = _mix32(h ^ _bits(jnp.broadcast_to(jnp.float32(random_seed), shp)))
    out = []
    for c in _C4:
        g = _mix32(h ^ jnp.int32(c))
        u = jax.lax.shift_right_logical(g, 8)        # [0, 2^24)
        out.append(u.astype(jnp.float32) * jnp.float32(2.0 ** -23) - 1.0)
    return tuple(out)
