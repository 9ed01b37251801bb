"""All-pairs ray-triangle traversal: Möller-Trumbore as one big matmul.

Reformulation of the reference's per-pixel triangle loop
(pathtracer_fragment.glsl:172-227). The MT quantities are (bi)linear in
the ray:

    det       = -d . n                     n  = e1 x e2
    u * det   = d . (e2 x (o - v0))        (bilinear in d, o)
    v * det   = d . ((o - v0) x e1)        (bilinear in d, o)
    s * det   = (o - v0) . n               (linear in o)

so with the 16-dim ray feature vector  f = [1, o, d, vec(d (x) o)]  all
four values for every (ray, triangle) pair are one matrix product
F[N,16] @ W[16, 4T] — a large, batched fp32 contraction that XLA hands to
cuBLAS on the GPU. The accept conditions and the closest-hit argmin run
as an elementwise epilogue over [N, T] that XLA fuses.

W is rebuilt per frame from world-space triangles — an O(T) elementwise
pass fused by XLA, negligible next to traversal. Results match the scan
traversal bit-for-bit in ids away from fp ties (tests assert id equality
on real scenes).

This is the path for scenes up to ops.schemes.MXU_MAX_TRIS triangles;
larger scenes take the cluster-culled cast (ops.traverse_clustered).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .intersect import BIAS, POW32
from .traverse import Hit

# True fp32 products: on the H100, DEFAULT precision would run the f32
# contraction in TF32 (10-bit mantissa), which moves hit distances and
# flips near-tie triangle choices against the scan oracle.
MATMUL_PRECISION = jax.lax.Precision.HIGHEST

# Working-set budget of one ray block: the [block, 4T] f32 product plus
# about six [block, T] epilogue temporaries (det/u/v/s, mask, masked s),
# i.e. ~40*T bytes per ray. Confirmed against compiled.memory_analysis()
# on the H100 (see PERF.md).
BLOCK_BYTES = 1 << 31
MAX_BLOCK = 1 << 18


def _skew(v):
    """Cross-product matrix: skew(a) @ b == cross(a, b). v: [T,3] -> [T,3,3]."""
    zero = jnp.zeros_like(v[:, 0])
    return jnp.stack([
        jnp.stack([zero, -v[:, 2], v[:, 1]], axis=-1),
        jnp.stack([v[:, 2], zero, -v[:, 0]], axis=-1),
        jnp.stack([-v[:, 1], v[:, 0], zero], axis=-1),
    ], axis=-2)


def tri_rows(world_geometry: jnp.ndarray, id_buffer: jnp.ndarray):
    """The four MT constant rows (det, udet, vdet, sdet), each [T, 16].

    Built by pure concatenation (no scatters), fused by XLA into the
    per-frame geometry pass.
    """
    tris = world_geometry[id_buffer]            # [T, 12]
    v0, v1, v2 = tris[:, 0:3], tris[:, 3:6], tris[:, 6:9]
    e1 = v1 - v0
    e2 = v2 - v0
    n = jnp.cross(e1, e2)

    t = v0.shape[0]
    z1 = jnp.zeros((t, 1), dtype=jnp.float32)
    z3 = jnp.zeros((t, 3), dtype=jnp.float32)
    z9 = jnp.zeros((t, 9), dtype=jnp.float32)
    # det = e1 . (d x e2) = d . (e2 x e1) = -d . n
    det = jnp.concatenate([z1, z3, -n, z9], axis=-1)
    # u*det = sum_ik d_i o_k skew(e2)[i,k]  -  d . cross(e2, v0)
    udet = jnp.concatenate(
        [z1, z3, -jnp.cross(e2, v0), _skew(e2).reshape(t, 9)], axis=-1)
    # v*det = -sum_ik d_i o_k skew(e1)[i,k] - d . cross(v0, e1)
    vdet = jnp.concatenate(
        [z1, z3, -jnp.cross(v0, e1), -_skew(e1).reshape(t, 9)], axis=-1)
    # s*det = o . n - v0 . n
    sdet = jnp.concatenate(
        [-jnp.sum(v0 * n, axis=-1, keepdims=True), n, z3, z9], axis=-1)
    return det, udet, vdet, sdet


def build_tri_matrix(world_geometry: jnp.ndarray, id_buffer: jnp.ndarray) -> jnp.ndarray:
    """Per-triangle MT constants. Returns W [16, 4T] (det, udet, vdet, sdet
    interleaved per triangle as the last axis reshaped [T,4])."""
    w = jnp.stack(tri_rows(world_geometry, id_buffer), axis=1)  # [T, 4, 16]
    return w.reshape(-1, 16).T                  # [16, 4T]


def _ray_features(origin, direction):
    """f = [1, o, d, vec(d (x) o)] : [N, 16]."""
    n = origin.shape[0]
    one = jnp.ones((n, 1), dtype=jnp.float32)
    do = (direction[:, :, None] * origin[:, None, :]).reshape(n, 9)
    return jnp.concatenate([one, origin, direction, do], axis=-1)


def _mt_products(w, origin, direction):
    """[N,16] @ [16,4T] -> det, udet, vdet, sdet each [N, T]."""
    f = _ray_features(origin, direction)
    prod = jnp.dot(f, w, precision=MATMUL_PRECISION)   # [N, 4T]
    prod = prod.reshape(origin.shape[0], -1, 4)
    return prod[..., 0], prod[..., 1], prod[..., 2], prod[..., 3]


def _closest_hit_block(w, id_buffer, origin, direction, edge=BIAS):
    det, udet, vdet, sdet = _mt_products(w, origin, direction)
    inv = 1.0 / det
    u = udet * inv
    v = vdet * inv
    s = sdet * inv
    # Full two-sided accept window (glsl:123-139); NaNs (det==0) reject.
    # edge=-BIAS on primary casts closes the shared-edge rejection band
    # (see ops.traverse._mt_chunk).
    valid = (jnp.abs(det) >= BIAS)
    valid &= (u >= edge) & (u <= 1.0)
    valid &= (v >= edge) & (u + v <= 1.0)
    valid &= (s > BIAS)
    s_masked = jnp.where(valid, s, POW32)
    best = jnp.argmin(s_masked, axis=-1)
    best_s = jnp.take_along_axis(s_masked, best[:, None], axis=-1)[:, 0]
    hit_any = best_s < POW32
    best_u = jnp.take_along_axis(u, best[:, None], axis=-1)[:, 0]
    best_v = jnp.take_along_axis(v, best[:, None], axis=-1)[:, 0]
    suv = jnp.where(hit_any[:, None],
                    jnp.stack([best_s, best_u, best_v], axis=-1), 0.0)
    tri = jnp.where(hit_any, id_buffer[best], -1)
    return Hit(suv=suv, triangle=tri.astype(jnp.int32))


def _shadow_block(w, origin, direction, max_len):
    det, udet, vdet, sdet = _mt_products(w, origin, direction)
    inv = 1.0 / det
    u = udet * inv
    v = vdet * inv
    s = sdet * inv
    # Front-face-culled any-hit (glsl:143-158)
    valid = (det >= BIAS)
    valid &= (u >= BIAS) & (u <= 1.0)
    valid &= (v >= BIAS) & (u + v <= 1.0)
    valid &= (s > BIAS) & (s <= max_len[:, None])
    return jnp.any(valid, axis=-1)


def _blocked(fn, n, block, *args):
    """Apply fn over ray blocks to bound the [block, T] epilogue footprint."""
    if n <= block:
        return fn(*args)
    pad = (-n) % block
    padded = [jnp.pad(a, [(0, pad)] + [(0, 0)] * (a.ndim - 1)) for a in args]
    stacked = [a.reshape(-1, block, *a.shape[1:]) for a in padded]
    out = jax.lax.map(lambda xs: fn(*xs), tuple(stacked))
    out = jax.tree.map(lambda x: x.reshape(-1, *x.shape[2:])[:n], out)
    return out


def block_size(n_tris: int) -> int:
    """Rays per block so one block's working set stays within BLOCK_BYTES
    (a multiple of 1024, at most MAX_BLOCK)."""
    fit = BLOCK_BYTES // (40 * max(int(n_tris), 1))
    return int(min(MAX_BLOCK, max(1024, fit // 1024 * 1024)))


def traverse_mxu(w, id_buffer, origin, direction, block: int | None = None,
                 edge: float = BIAS) -> Hit:
    """Closest hit of N rays against all T triangles via one contraction
    per ray block (`block` defaults to block_size(T))."""
    block = block or block_size(w.shape[1] // 4)
    return _blocked(partial(_closest_hit_block, w, id_buffer, edge=edge),
                    origin.shape[0], block, origin, direction)


def shadow_mxu(w, origin, direction, max_len,
               block: int | None = None) -> jnp.ndarray:
    block = block or block_size(w.shape[1] // 4)
    return _blocked(partial(_shadow_block, w),
                    origin.shape[0], block, origin, direction, max_len)
