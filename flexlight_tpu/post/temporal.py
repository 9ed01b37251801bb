"""Temporal accumulation.

Counterpart of the runtime-generated temporal shader
(pathtracerWGL2.js:571-662): average up to `temporal_samples` history
frames, gated per pixel on exact equality of the quantized id channel; a
separate glass counter gated on the originalId channel. The reference's
texture ring (pathtracerWGL2.js:391-394) becomes a functional history
pytree carried across jit steps.

Known-unobservable deviation: when (temporalSamples - 1) % 4 != 0 the
generated shader pads its last mat4 with vec4(0) slots whose id compare
can match and inflate the counters (pathtracerWGL2.js:608-612). That
only triggers for pixels with an all-zero quantized id — impossible for
covered pixels (render_id.w and originalId.w both get +1/255,
glsl:637/643) and a 0/(n+1) == 0/n no-op for sky — so this port loops
over the real frames only.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from .common import INV_256, quantize_rgba8, split_hdr


class TemporalState(NamedTuple):
    """History ring, newest frame at index 0. All RGBA8-quantized."""
    color: jnp.ndarray   # [T, H, W, 4]  fract color + alpha
    ip: jnp.ndarray      # [T, H, W, 4]  floor/256 color + glassFilter
    ids: jnp.ndarray     # [T, H, W, 4]
    oid: jnp.ndarray     # [T, H, W, 4]

    @staticmethod
    def create(temporal_samples: int, height: int, width: int) -> "TemporalState":
        z = jnp.zeros((temporal_samples, height, width, 4), dtype=jnp.float32)
        return TemporalState(color=z, ip=z, ids=z, oid=z)


def push_frame(state: TemporalState, color_q, ip_q, id_q, oid_q) -> TemporalState:
    """Rotate the ring: new frame in, oldest out (pathtracerWGL2.js:391-394)."""
    def rot(ring, new):
        return jnp.concatenate([new[None], ring[:-1]], axis=0)

    return TemporalState(
        color=rot(state.color, color_q),
        ip=rot(state.ip, ip_q),
        ids=rot(state.ids, id_q),
        oid=rot(state.oid, oid_q),
    )


def temporal_average(state: TemporalState):
    """The generated temporal kernel (pathtracerWGL2.js:595-639).

    Returns (color [H,W,3] fp32 HDR, glass [H,W], center_w [H,W]).
    """
    cur_id = state.ids[0]
    cur_oid = state.oid[0]
    center_w = state.color[0, :, :, 3]
    color = state.color[0, :, :, 0:3] + state.ip[0, :, :, 0:3] * 256.0
    counter = jnp.ones_like(center_w)
    glass = state.ip[0, :, :, 3]
    glass_counter = jnp.ones_like(center_w)

    t = state.color.shape[0]
    for j in range(1, t):
        id_match = jnp.all(state.ids[j] == cur_id, axis=-1)
        c_j = state.color[j, :, :, 0:3] + state.ip[j, :, :, 0:3] * 256.0
        color = jnp.where(id_match[..., None], color + c_j, color)
        counter = counter + id_match.astype(jnp.float32)
        oid_match = jnp.all(state.oid[j] == cur_oid, axis=-1)
        glass = jnp.where(oid_match, glass + state.ip[j, :, :, 3], glass)
        glass_counter = glass_counter + oid_match.astype(jnp.float32)

    color = color / counter[..., None]
    glass = glass / glass_counter
    return color, glass, center_w


def store_mrt_color(color_hdr: jnp.ndarray, alpha: jnp.ndarray):
    """Store a fresh pathtracer color frame the way the MRT pass does in
    temporal/filter mode (glsl:621-623): quantized fract + floor/256."""
    frac_q, high_q = split_hdr(color_hdr)
    color_q = jnp.concatenate([frac_q, alpha[..., None]], axis=-1)
    return color_q, frac_q, high_q
