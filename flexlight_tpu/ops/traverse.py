"""BVH traversal over the skip-pointer geometry list.

The flattened scene is a linear list of slots (triangles + AABB nodes with
skip counts + a kind=0 end sentinel) — exactly the stackless encoding the
reference's fragment shader walks one slot at a time per pixel
(pathtracer_fragment.glsl:172-280). Two vectorized schedules over the same
encoding:

- `traverse_scan` / `shadow_scan`: chunk-vectorized linear scan. Every ray
  tests every triangle chunk; AABB nodes are ignored (testing a skipped
  subtree cannot change the closest hit, since any contained triangle hit
  implies the enclosing AABB hit). All work is [chunk, N]-wide elementwise
  + argmin reductions — zero gathers. The right schedule for
  small scenes (tens to hundreds of slots) and the golden oracle for the
  others.

- `traverse_coherent` / `shadow_coherent`: ray-packet traversal. Each tile
  of rays shares one scalar list cursor; an AABB subtree is skipped when
  *every* ray in the tile misses it (conservative packet skip — identical
  results, data-dependent trip count). vmapped over tiles; tiles proceed
  in lockstep under vmap, so wall time follows the worst tile. The right
  schedule for large scenes with coherent rays.

Both consume world-space geometry from `ops.geometry.world_geometry`, so no
transform logic appears in the inner loop.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .intersect import BIAS, POW32


class Hit(NamedTuple):
    suv: jnp.ndarray       # [N, 3] (s, u, v); s == POW32 on miss
    triangle: jnp.ndarray  # [N] int32 slot index, -1 on miss


def _mt_chunk(v0, v1, v2, origin, direction, max_len, cull: bool,
              edge: float = BIAS):
    """Möller-Trumbore of N rays against C triangles -> s,u,v,valid [C,N].

    Inlined rather than calling ops.intersect so XLA fuses the broadcasted
    [C,N,3] intermediates; accept conditions identical to glsl:123-158.

    `edge` is the lower bound of the u/v accept window. The fragment
    shader's BIAS rejection band (glsl:134-136) carves a visible gap
    along shared triangle edges when primaries are ray-cast rather than
    rasterized (the reference's raster pass is watertight); primary
    casts pass edge=-BIAS to close it, bounce/shadow rays keep the
    reference-exact +BIAS window.
    """
    edge1 = (v1 - v0)[:, None, :]
    edge2 = (v2 - v0)[:, None, :]
    d = direction[None, :, :]
    pvec = jnp.cross(d, edge2)
    det = jnp.sum(edge1 * pvec, axis=-1)
    inv_det = 1.0 / det
    tvec = origin[None, :, :] - v0[:, None, :]
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, edge1)
    v = jnp.sum(d * qvec, axis=-1) * inv_det
    s = jnp.sum(edge2 * qvec, axis=-1) * inv_det
    valid = (det >= BIAS) if cull else (jnp.abs(det) >= BIAS)
    valid &= (u >= edge) & (u <= 1.0)
    valid &= (v >= edge) & (u + v <= 1.0)
    valid &= (s <= max_len) & (s > BIAS)
    return s, u, v, valid


def traverse_scan(geometry: jnp.ndarray, origin: jnp.ndarray,
                  direction: jnp.ndarray, chunk: int = 16,
                  edge: float = BIAS) -> Hit:
    """Closest-hit over all rays; chunked linear scan (glsl:172-227)."""
    s_slots = geometry.shape[0]
    n_chunks = s_slots // chunk
    n = origin.shape[0]

    def body(carry, step):
        min_len, ended, tri = carry
        rows = jax.lax.dynamic_slice(geometry, (step * chunk, 0), (chunk, geometry.shape[1]))
        verts = rows[:, 0:9].reshape(chunk, 3, 3)
        kind = rows[:, 10]
        # End-of-list sentinel: everything at or after a kind==0 row is dead
        # (glsl:208). Slots are emitted densely, so prefix logic is exact.
        sentinel = jnp.cumsum((kind == 0.0).astype(jnp.int32)) > 0
        live_tri = (kind == 2.0) & ~sentinel & ~ended

        s, u, v, valid = _mt_chunk(verts[:, 0], verts[:, 1], verts[:, 2],
                                   origin, direction, min_len[None, :],
                                   cull=False, edge=edge)
        valid &= live_tri[:, None]
        s_masked = jnp.where(valid, s, POW32)
        best = jnp.argmin(s_masked, axis=0)                       # [N]
        best_s = jnp.take_along_axis(s_masked, best[None], axis=0)[0]
        hit_any = best_s < POW32
        take = hit_any & (best_s <= min_len)
        min_len = jnp.where(take, best_s, min_len)
        best_u = jnp.take_along_axis(u, best[None], axis=0)[0]
        best_v = jnp.take_along_axis(v, best[None], axis=0)[0]
        tri = Hit(
            suv=jnp.where(take[:, None],
                          jnp.stack([best_s, best_u, best_v], axis=-1), tri.suv),
            triangle=jnp.where(take, step * chunk + best, tri.triangle),
        )
        ended = ended | jnp.any(sentinel)
        return (min_len, ended, tri), None

    init = (
        jnp.full((n,), POW32, dtype=jnp.float32),
        jnp.bool_(False),
        Hit(suv=jnp.zeros((n, 3), dtype=jnp.float32),
            triangle=jnp.full((n,), -1, dtype=jnp.int32)),
    )
    (_, _, hit), _ = jax.lax.scan(body, init, jnp.arange(n_chunks))
    return hit


def shadow_scan(geometry: jnp.ndarray, origin: jnp.ndarray,
                direction: jnp.ndarray, max_len: jnp.ndarray,
                chunk: int = 16) -> jnp.ndarray:
    """Any-hit (front-face-culled) shadow test (glsl:231-280) -> bool [N]."""
    s_slots = geometry.shape[0]
    n_chunks = s_slots // chunk

    def body(carry, step):
        shadowed, ended = carry
        rows = jax.lax.dynamic_slice(geometry, (step * chunk, 0), (chunk, geometry.shape[1]))
        verts = rows[:, 0:9].reshape(chunk, 3, 3)
        kind = rows[:, 10]
        sentinel = jnp.cumsum((kind == 0.0).astype(jnp.int32)) > 0
        live_tri = (kind == 2.0) & ~sentinel & ~ended
        _, _, _, valid = _mt_chunk(verts[:, 0], verts[:, 1], verts[:, 2],
                                   origin, direction, max_len[None, :], cull=True)
        shadowed = shadowed | jnp.any(valid & live_tri[:, None], axis=0)
        ended = ended | jnp.any(sentinel)
        return (shadowed, ended), None

    init = (jnp.zeros(origin.shape[0], dtype=bool), jnp.bool_(False))
    (shadowed, _), _ = jax.lax.scan(body, init, jnp.arange(n_chunks))
    return shadowed


# ----------------------------------------------------------------------
# Packet (tile-coherent) traversal
# ----------------------------------------------------------------------

def _traverse_packet(geometry, origin, direction, max_len0, edge=BIAS):
    """One ray packet walks the skip-pointer list with a shared cursor."""
    s_slots = geometry.shape[0]
    inv_dir = 1.0 / direction

    def cond(state):
        i, ended, *_ = state
        return (i < s_slots) & ~ended

    def body(state):
        i, ended, min_len, suv, tri = state
        row = jax.lax.dynamic_slice(geometry, (i, 0), (1, geometry.shape[1]))[0]
        kind = row[10]
        v0, v1, v2 = row[0:3], row[3:6], row[6:9]

        # AABB packet test (glsl:161-167): skip subtree iff no ray enters.
        t0 = (v0 - origin) * inv_dir
        t1 = (v1 - origin) * inv_dir
        tmin = jnp.max(jnp.minimum(t0, t1), axis=-1)
        tmax = jnp.min(jnp.maximum(t0, t1), axis=-1)
        aabb_hit = (tmax >= jnp.maximum(tmin, BIAS)) & (tmin < min_len)
        skip_all = (kind == 1.0) & ~jnp.any(aabb_hit)

        # Triangle test (two-sided MT)
        s, u, v, valid = _mt_chunk(v0[None], v1[None], v2[None],
                                   origin, direction, min_len[None, :],
                                   cull=False, edge=edge)
        take = valid[0] & (kind == 2.0)
        min_len = jnp.where(take, s[0], min_len)
        suv = jnp.where(take[:, None], jnp.stack([s[0], u[0], v[0]], axis=-1), suv)
        tri = jnp.where(take, i, tri)

        ended = ended | (kind == 0.0)
        i = i + jnp.where(skip_all, row[6].astype(jnp.int32) + 1, 1)
        return i, ended, min_len, suv, tri

    n = origin.shape[0]
    state = (
        jnp.int32(0), jnp.bool_(False),
        jnp.full((n,), max_len0, dtype=jnp.float32),
        jnp.zeros((n, 3), dtype=jnp.float32),
        jnp.full((n,), -1, dtype=jnp.int32),
    )
    _, _, _, suv, tri = jax.lax.while_loop(cond, body, state)
    return suv, tri


def traverse_coherent(geometry: jnp.ndarray, origin: jnp.ndarray,
                      direction: jnp.ndarray, tile: int = 1024,
                      edge: float = BIAS) -> Hit:
    """Packet traversal vmapped over ray tiles. N must be divisible by tile."""
    n = origin.shape[0]
    o = origin.reshape(n // tile, tile, 3)
    d = direction.reshape(n // tile, tile, 3)
    suv, tri = jax.vmap(
        lambda oo, dd: _traverse_packet(geometry, oo, dd, POW32, edge=edge))(o, d)
    return Hit(suv=suv.reshape(n, 3), triangle=tri.reshape(n))


def _shadow_packet(geometry, origin, direction, max_len):
    s_slots = geometry.shape[0]
    inv_dir = 1.0 / direction

    def cond(state):
        i, ended, shadowed = state
        return (i < s_slots) & ~ended & ~jnp.all(shadowed)

    def body(state):
        i, ended, shadowed = state
        row = jax.lax.dynamic_slice(geometry, (i, 0), (1, geometry.shape[1]))[0]
        kind = row[10]
        v0, v1, v2 = row[0:3], row[3:6], row[6:9]
        t0 = (v0 - origin) * inv_dir
        t1 = (v1 - origin) * inv_dir
        tmin = jnp.max(jnp.minimum(t0, t1), axis=-1)
        tmax = jnp.min(jnp.maximum(t0, t1), axis=-1)
        aabb_hit = (tmax >= jnp.maximum(tmin, BIAS)) & (tmin < max_len)
        skip_all = (kind == 1.0) & ~jnp.any(aabb_hit & ~shadowed)
        _, _, _, valid = _mt_chunk(v0[None], v1[None], v2[None],
                                   origin, direction, max_len[None, :], cull=True)
        shadowed = shadowed | (valid[0] & (kind == 2.0))
        ended = ended | (kind == 0.0)
        i = i + jnp.where(skip_all, row[6].astype(jnp.int32) + 1, 1)
        return i, ended, shadowed

    state = (jnp.int32(0), jnp.bool_(False),
             jnp.zeros(origin.shape[0], dtype=bool))
    _, _, shadowed = jax.lax.while_loop(cond, body, state)
    return shadowed


def shadow_coherent(geometry: jnp.ndarray, origin: jnp.ndarray,
                    direction: jnp.ndarray, max_len: jnp.ndarray,
                    tile: int = 1024) -> jnp.ndarray:
    n = origin.shape[0]
    o = origin.reshape(n // tile, tile, 3)
    d = direction.reshape(n // tile, tile, 3)
    l = max_len.reshape(n // tile, tile)
    out = jax.vmap(lambda oo, dd, ll: _shadow_packet(geometry, oo, dd, ll))(o, d, l)
    return out.reshape(n)
