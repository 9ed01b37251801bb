"""Clustered-traversal equivalence vs the scan oracle on a generated
mesh (the wave example's pillar grid: 434 triangles, many clusters)."""

import os
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from flexlight_tpu.ops import buffers as bufmod
from flexlight_tpu.ops.geometry import world_geometry
from flexlight_tpu.ops.traverse import shadow_scan, traverse_scan
from flexlight_tpu.ops.traverse_clustered import (
    Clusters, build_clusters, shadow_clustered, traverse_clustered)


@pytest.fixture(scope="module")
def mesh():
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))
    import wave

    from flexlight_tpu.scene.transform import reset_global_registry

    reset_global_registry()
    engine, _ = wave.build_scene(side_length=6)
    buffers = bufmod.build_scene_buffers(engine.scene)
    wg = world_geometry(buffers)
    return buffers, wg


def _rays(n, seed=0, origin_base=(3.0, 6.0, -4.0)):
    rng = np.random.default_rng(seed)
    origin = np.tile(np.asarray(origin_base, np.float32), (n, 1))
    origin += rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] = np.abs(d[:, 2]) + 0.5  # toward the mesh
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(origin), jnp.asarray(d)


@pytest.mark.slow
def test_clustered_matches_scan_coherent(mesh):
    buffers, wg = mesh
    o, d = _rays(256)
    ref = traverse_scan(wg, o, d, chunk=32)
    clusters = build_clusters(wg, buffers.id_buffer, cluster_size=32)
    got = traverse_clustered(clusters, o, d, block=64, k_cand=16, group=2)
    np.testing.assert_array_equal(np.asarray(got.triangle), np.asarray(ref.triangle))
    hit = np.asarray(ref.triangle) != -1
    np.testing.assert_allclose(np.asarray(got.suv)[hit], np.asarray(ref.suv)[hit],
                               rtol=1e-3, atol=1e-3)


def test_clustered_overflow_fallback(mesh):
    """Tiny k_cand forces the full-scan fallback path; results identical."""
    buffers, wg = mesh
    o, d = _rays(128, seed=1)
    ref = traverse_scan(wg, o, d, chunk=32)
    clusters = build_clusters(wg, buffers.id_buffer, cluster_size=32)
    got = traverse_clustered(clusters, o, d, block=32, k_cand=2, group=2)
    np.testing.assert_array_equal(np.asarray(got.triangle), np.asarray(ref.triangle))


def test_clustered_shadow_matches_scan(mesh):
    buffers, wg = mesh
    o, d = _rays(256, seed=2)
    max_len = jnp.full((256,), 10.0, dtype=jnp.float32)
    ref = shadow_scan(wg, o, d, max_len, chunk=32)
    clusters = build_clusters(wg, buffers.id_buffer, cluster_size=32)
    got = shadow_clustered(clusters, o, d, max_len, block=64, k_cand=16, group=2)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def test_cluster_build_shapes(mesh):
    buffers, wg = mesh
    clusters = build_clusters(wg, buffers.id_buffer, cluster_size=64)
    t = buffers.id_buffer.shape[0]
    k = -(-t // 64)
    assert clusters.w.shape == (k, 16, 256)
    assert clusters.aabb_min.shape == (k, 3)
    assert clusters.tri_slots.shape == (k, 64)
    # AABBs must contain their triangles
    tris = np.asarray(wg)[np.asarray(buffers.id_buffer)][:, 0:9].reshape(-1, 3, 3)
    first = tris[:64]
    assert (np.asarray(clusters.aabb_min[0]) <= first.reshape(-1, 3).min(axis=0) + 1e-5).all()
