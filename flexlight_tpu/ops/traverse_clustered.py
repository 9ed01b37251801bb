"""Clustered two-phase traversal for large scenes.

The skip-pointer walk (ops.traverse) is the reference's schedule; its
per-step control flow serializes once scenes grow. This schedule turns
large scenes into a few batched contractions per ray group:

1. Triangles are chunked into K clusters of C consecutive triangles in
   flattened BVH DFS order (spatially coherent by construction — the
   flattener emits subtrees contiguously, scene.js:224-282). Cluster AABBs
   are reduced on device per frame from world-space vertices.
2. Phase A: every ray slab-tests every cluster AABB ([N, K] elementwise
   pass, a few flops per pair); rays are grouped into blocks and each block
   takes the union of its rays' cluster hits.
3. Phase B: clusters are reordered by the group's hit union (hit first,
   nearest entry first) and scanned in chunks of `k_cand`; each chunk is
   one batched [R, 16] x [16, k_cand*4C] contraction (the
   MT-as-matmul formulation of ops.traverse_mxu), and chunks whose
   clusters nobody hit are skipped via lax.cond inside the scan. Cost is
   therefore ceil(hit_clusters / k_cand) chunks per group — one chunk for
   coherent primary/shadow blocks, a handful for incoherent bounce rays,
   and exactly correct in all cases (every hit cluster is evaluated).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .intersect import BIAS, POW32
from .traverse import Hit
from .traverse_mxu import MATMUL_PRECISION, _ray_features, build_tri_matrix


class Clusters(NamedTuple):
    w: jnp.ndarray            # [K, 16, 4C] per-cluster MT constants
    aabb_min: jnp.ndarray     # [K, 3]
    aabb_max: jnp.ndarray     # [K, 3]
    tri_slots: jnp.ndarray    # [K, C] int32 geometry slot per padded triangle (-1 pad)


def build_clusters(world_geometry: jnp.ndarray, id_buffer: jnp.ndarray,
                   cluster_size: int = 64) -> Clusters:
    t = id_buffer.shape[0]
    c = cluster_size
    k = -(-t // c)
    pad = k * c - t
    w = build_tri_matrix(world_geometry, id_buffer)          # [16, 4T]
    w = jnp.pad(w, ((0, 0), (0, pad * 4)))
    w = w.reshape(16, k, c * 4).transpose(1, 0, 2)            # [K, 16, 4C]

    tris = world_geometry[id_buffer]
    verts = tris[:, 0:9].reshape(t, 3, 3)
    vmin = jnp.pad(verts.min(axis=1), ((0, pad), (0, 0)), constant_values=jnp.inf)
    vmax = jnp.pad(verts.max(axis=1), ((0, pad), (0, 0)), constant_values=-jnp.inf)
    aabb_min = vmin.reshape(k, c, 3).min(axis=1)
    aabb_max = vmax.reshape(k, c, 3).max(axis=1)

    tri_slots = jnp.pad(id_buffer, (0, pad), constant_values=-1).reshape(k, c)
    return Clusters(w=w, aabb_min=aabb_min, aabb_max=aabb_max, tri_slots=tri_slots)


def _cluster_hits(clusters: Clusters, origin, direction, max_len):
    """Slab test rays x clusters -> (hit [.., K], tmin [.., K])."""
    inv_d = 1.0 / direction
    t0 = (clusters.aabb_min[None, :, :] - origin[:, None, :]) * inv_d[:, None, :]
    t1 = (clusters.aabb_max[None, :, :] - origin[:, None, :]) * inv_d[:, None, :]
    tmin = jnp.max(jnp.minimum(t0, t1), axis=-1)
    tmax = jnp.min(jnp.maximum(t0, t1), axis=-1)
    hit = (tmax >= jnp.maximum(tmin, BIAS)) & (tmin < max_len)
    return hit, tmin


def _mt_epilogue(prod, cull: bool, max_len, edge=BIAS):
    """prod [..., 4] -> (s, u, v, valid) with the glsl accept window.

    edge=-BIAS on primary casts closes the shared-edge rejection band
    (see ops.traverse._mt_chunk)."""
    det = prod[..., 0]
    inv = 1.0 / det
    u = prod[..., 1] * inv
    v = prod[..., 2] * inv
    s = prod[..., 3] * inv
    valid = (det >= BIAS) if cull else (jnp.abs(det) >= BIAS)
    valid &= (u >= edge) & (u <= 1.0)
    valid &= (v >= edge) & (u + v <= 1.0)
    valid &= (s > BIAS) & (s <= max_len)
    return s, u, v, valid


class _Best(NamedTuple):
    s: jnp.ndarray    # [R] best distance (POW32 = miss)
    u: jnp.ndarray
    v: jnp.ndarray
    tri: jnp.ndarray  # [R] geometry slot, -1 = miss


def _best_none(r):
    return _Best(s=jnp.full((r,), POW32, dtype=jnp.float32),
                 u=jnp.zeros((r,), dtype=jnp.float32),
                 v=jnp.zeros((r,), dtype=jnp.float32),
                 tri=jnp.full((r,), -1, dtype=jnp.int32))


def _best_merge(a: _Best, b: _Best) -> _Best:
    take_b = b.s < a.s
    return _Best(s=jnp.where(take_b, b.s, a.s),
                 u=jnp.where(take_b, b.u, a.u),
                 v=jnp.where(take_b, b.v, a.v),
                 tri=jnp.where(take_b, b.tri, a.tri))


def _best_of(s, u, v, valid, tri_slots) -> _Best:
    """Reduce [R, M, C] products to the per-ray best hit."""
    r = s.shape[0]
    s_masked = jnp.where(valid, s, POW32).reshape(r, -1)
    best = jnp.argmin(s_masked, axis=-1)
    take = lambda x: jnp.take_along_axis(x.reshape(r, -1), best[:, None], axis=-1)[:, 0]
    best_s = take(s_masked)
    tri = jnp.broadcast_to(tri_slots[None], s.shape).reshape(r, -1)
    tri_best = jnp.take_along_axis(tri, best[:, None], axis=-1)[:, 0]
    miss = best_s >= POW32
    return _Best(s=best_s,
                 u=jnp.where(miss, 0.0, take(u)),
                 v=jnp.where(miss, 0.0, take(v)),
                 tri=jnp.where(miss, -1, tri_best).astype(jnp.int32))


@partial(jax.jit, static_argnames=("block", "k_cand", "group", "shadow",
                                   "sort_rays", "edge"))
def _traverse_impl(clusters: Clusters, origin, direction, max_len,
                   block: int = 1024, k_cand: int = 64, group: int = 2,
                   shadow: bool = False, sort_rays: bool = True,
                   edge: float = BIAS):
    n = origin.shape[0]
    # Wavefront compaction: a stable sort by direction octant groups rays
    # of like direction while preserving the (already spatially coherent)
    # pixel order within each octant — incoherent bounce wavefronts then
    # produce small per-group cluster unions instead of near-full scans.
    if sort_rays:
        key = ((direction[:, 0] > 0) * 4 + (direction[:, 1] > 0) * 2
               + (direction[:, 2] > 0)).astype(jnp.int32)
        perm = jnp.argsort(key, stable=True)
        inv_perm = jnp.argsort(perm)
        origin = origin[perm]
        direction = direction[perm]
        max_len = max_len[perm]
    k, _, c4 = clusters.w.shape
    c = c4 // 4
    k_cand = min(k_cand, k)
    nb = -(-n // block)
    pad = nb * block - n

    def pad_rays(x, fill=0.0):
        return jnp.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1), constant_values=fill)

    safe_dir = jnp.where(jnp.linalg.norm(direction, axis=-1, keepdims=True) > 0,
                         direction, jnp.array([0.0, 0.0, 1.0]))
    origin_p = pad_rays(origin).reshape(nb, block, 3)
    direction_p = pad_rays(safe_dir, 1.0).reshape(nb, block, 3)
    max_len_p = pad_rays(max_len).reshape(nb, block)

    ng = -(-nb // group)
    gpad = ng * group - nb
    origin_g = jnp.pad(origin_p, ((0, gpad), (0, 0), (0, 0))).reshape(ng, group, block, 3)
    direction_g = jnp.pad(direction_p, ((0, gpad), (0, 0), (0, 0)),
                          constant_values=1.0).reshape(ng, group, block, 3)
    max_len_g = jnp.pad(max_len_p, ((0, gpad), (0, 0))).reshape(ng, group, block)

    nchunks = -(-k // k_cand)
    kpad = nchunks * k_cand - k

    def eval_clusters(w_sel, tri_sel, o, d, ml) -> _Best:
        """Intersect rays with the selected clusters (one contraction)."""
        f = _ray_features(o, d)                                   # [R,16]
        wflat = w_sel.transpose(1, 0, 2).reshape(16, -1)          # [16, M*4C]
        prod = jnp.dot(f, wflat, precision=MATMUL_PRECISION)
        prod = prod.reshape(o.shape[0], -1, c, 4)                 # [R, M, C, 4]
        s, u, v, valid = _mt_epilogue(prod, shadow, ml[:, None, None], edge=edge)
        valid &= (tri_sel >= 0)[None]
        return _best_of(s, u, v, valid, tri_sel)

    def group_fn(o, d, ml):
        of = o.reshape(group * block, 3)
        df = d.reshape(group * block, 3)
        mf = ml.reshape(group * block)
        # Phase A: hit union over the whole group, clusters reordered by
        # (hit, nearest entry); pad with guaranteed-miss slots.
        hit, tmin = _cluster_hits(clusters, of, df, mf[:, None])  # [R, K]
        any_hit = jnp.any(hit, axis=0)
        entry = jnp.min(jnp.where(hit, tmin, POW32), axis=0)
        order = jnp.argsort(jnp.where(any_hit, entry, POW32))     # hit first
        hit_sorted = jnp.pad(any_hit[order], (0, kpad))           # pad = miss
        # Pad order with index 0: padded slots only run when their chunk
        # also contains a real hit, and re-evaluating a cluster is
        # idempotent for both closest-hit and any-hit.
        order = jnp.pad(order, (0, kpad))
        w_sorted = clusters.w[order]                               # [K+pad,16,4C]
        tri_sorted = clusters.tri_slots[order]

        def body(carry, idx):
            chunk_hit = jax.lax.dynamic_slice_in_dim(hit_sorted, idx * k_cand, k_cand)

            def live(carry):
                ws = jax.lax.dynamic_slice_in_dim(w_sorted, idx * k_cand, k_cand, axis=0)
                ts = jax.lax.dynamic_slice_in_dim(tri_sorted, idx * k_cand, k_cand, axis=0)
                return _best_merge(carry, eval_clusters(ws, ts, of, df, mf))

            return jax.lax.cond(jnp.any(chunk_hit), live, lambda cr: cr, carry), None

        best, _ = jax.lax.scan(body, _best_none(group * block), jnp.arange(nchunks))
        best = jax.tree.map(lambda x: x.reshape(group, block), best)
        if shadow:
            return best.tri >= 0
        return best

    out = jax.lax.map(lambda xs: group_fn(*xs), (origin_g, direction_g, max_len_g))
    if shadow:
        res = out.reshape(-1)[:n]
        return res[inv_perm] if sort_rays else res
    flat = jax.tree.map(lambda x: x.reshape(-1)[:n], out)
    if sort_rays:
        flat = jax.tree.map(lambda x: x[inv_perm], flat)
    suv = jnp.where((flat.tri >= 0)[:, None],
                    jnp.stack([flat.s, flat.u, flat.v], axis=-1), 0.0)
    return Hit(suv=suv, triangle=flat.tri)


def traverse_clustered(clusters: Clusters, origin, direction,
                       block: int = 1024, k_cand: int = 64,
                       group: int = 2, edge: float = BIAS) -> Hit:
    max_len = jnp.full(origin.shape[:1], POW32, dtype=jnp.float32)
    return _traverse_impl(clusters, origin, direction, max_len,
                          block=block, k_cand=k_cand, group=group,
                          shadow=False, edge=edge)


def shadow_clustered(clusters: Clusters, origin, direction, max_len,
                     block: int = 1024, k_cand: int = 64,
                     group: int = 2) -> jnp.ndarray:
    return _traverse_impl(clusters, origin, direction, max_len,
                          block=block, k_cand=k_cand, group=group, shadow=True)
