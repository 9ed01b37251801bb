"""filter_mode="fast" — the tile-quantized denoise mode.

Fast mode replaces the per-pixel noisy blur radius key (originalColor.w,
pathtracer_fragment.glsl:558,635) with its per-tile mean
(post.common.tileize_blur_key); the id-equality edge-stopping gates are
untouched. These tests pin:

1. fast == compat exactly when the key is already tile-uniform (the
   machinery changes nothing beyond the key),
2. fast stays within an image-delta budget of compat on noisy keys
   (the product-quality bound; the committed per-scene report is
   docs/parity/fast_vs_compat.json from scripts/fast_vs_compat.py),
3. the sharded psum-based tileize matches the single-chip grid exactly,
4. the halo pipeline's config-reach guard falls back to all_gather when
   the worst-case stencil reach exceeds the strip height.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from flexlight_tpu import Config
from flexlight_tpu.models.pathtracer import _filter_chain
from flexlight_tpu.post.common import quantize_rgba8, tileize_blur_key

from tests.scenes import cornell_config


def _q(rng, shape):
    return jnp.asarray(np.round(rng.random(shape) * 255.0).astype(np.float32)
                       / 255.0)


def _images(rng, h, w, key_mode: str):
    """Random quantized filter-chain inputs with a controlled blur key."""
    color = _q(rng, (h, w, 4))
    ip = _q(rng, (h, w, 4))
    ids = _q(rng, (h, w, 4))
    # coherent-ish id planes so gates pass often enough to blur
    ids = quantize_rgba8(jnp.round(ids * 3.0) / 3.0)
    oid = jnp.concatenate([jnp.zeros((h, w, 3)), _q(rng, (h, w, 1))], axis=-1)
    oid = oid.at[..., 3].set(jnp.where(oid[..., 3] > 0.9, oid[..., 3], 0.0))
    ocolor = _q(rng, (h, w, 4))
    if key_mode == "uniform_tiles":
        ocolor = tileize_blur_key(ocolor)
    elif key_mode == "zero":
        ocolor = ocolor.at[..., 3].set(0.0)
    return color, ip, ocolor, ids, oid


def _chain(cfg, imgs):
    color, ip, ocolor, ids, oid = imgs
    return np.asarray(_filter_chain(cfg, color, ip, ocolor, ids, oid))


def test_fast_equals_compat_on_tile_uniform_keys():
    rng = np.random.default_rng(3)
    imgs = _images(rng, 64, 160, "uniform_tiles")
    cfg_fast = cornell_config(filter=True, filter_mode="fast",
                              first_passes=2, second_passes=2)
    cfg_compat = cfg_fast.replace(filter_mode="compat")
    fast = _chain(cfg_fast, imgs)
    compat = _chain(cfg_compat, imgs)
    # first passes see identical keys; later passes re-tileize the second
    # filter's ocolor output, whose w is already near-tile-uniform — exact
    # equality holds when the starting key is tile-uniform and glass is
    # sparse enough that second-pass ocolor.w stays tile-uniform too. Use
    # a glass-free variant for the strict check:
    color, ip, ocolor, ids, oid = imgs
    oid0 = oid.at[..., 3].set(0.0)
    strict = (color, ip, ocolor, ids, oid0)
    np.testing.assert_array_equal(_chain(cfg_fast, strict),
                                  _chain(cfg_compat, strict))
    # with glass: still within one quantization step almost everywhere
    diff = np.abs(fast - compat)
    assert (diff > 2.0 / 255.0).mean() < 0.02


def test_fast_delta_budget_on_noisy_keys():
    rng = np.random.default_rng(7)
    imgs = _images(rng, 64, 160, "noisy")
    cfg_fast = cornell_config(filter=True, filter_mode="fast",
                              first_passes=2, second_passes=2)
    out_fast = _chain(cfg_fast, imgs)
    out_compat = _chain(cfg_fast.replace(filter_mode="compat"), imgs)
    # worst case (iid random keys, no spatial structure): the tile mean is
    # a fair radius representative; the blur's gated average keeps the
    # outputs close even though individual taps differ
    diff = np.abs(out_fast - out_compat)
    assert float(diff.mean()) < 0.05, diff.mean()
    # iid keys are the adversarial worst case (no spatial structure at
    # all); real-scene deltas are far tighter and pinned per scene by
    # scripts/fast_vs_compat.py -> docs/parity/fast_vs_compat.json
    assert float((diff > 0.25).mean()) < 0.10


def test_zero_keys_identical_in_both_modes():
    """ocolor.w == 0 pixels pass through the first filter untouched
    (first_filter.glsl:96-98) — fast mode must preserve that exactly."""
    rng = np.random.default_rng(11)
    imgs = _images(rng, 40, 140, "zero")
    cfg = cornell_config(filter=True, first_passes=1, second_passes=1)
    np.testing.assert_array_equal(
        _chain(cfg.replace(filter_mode="fast"), imgs),
        _chain(cfg.replace(filter_mode="compat"), imgs))


@pytest.mark.skipif(jax.device_count() < 4, reason="needs 4 virtual devices")
def test_sharded_tileize_matches_single_chip():
    from flexlight_tpu.parallel.tile_sharding import (
        make_mesh, tileize_blur_key_sharded)
    from jax.sharding import PartitionSpec as P

    rng = np.random.default_rng(5)
    h, w = 72, 200  # 4 strips of 18 rows; 32-row tiles straddle strips
    oc = _q(rng, (h, w, 4))
    oc = oc.at[..., 3].set(jnp.where(oc[..., 3] > 0.2, oc[..., 3], 0.0))
    ref = np.asarray(tileize_blur_key(oc))
    mesh = make_mesh(4, 1)
    rows_local = h // 4

    def shard_fn(oc_strip):
        row0 = jax.lax.axis_index("tile") * rows_local
        out = tileize_blur_key_sharded(oc_strip, row0, h, "tile")
        return out

    fn = jax.shard_map(shard_fn, mesh=mesh,
                       in_specs=P("tile"), out_specs=P("tile"))
    got = np.asarray(fn(oc))
    np.testing.assert_allclose(got, ref, atol=1.0 / 255.0 + 1e-6)
    # the quantized keys must agree exactly up to fp-reorder rounding ties
    assert (np.abs(got[..., 3] - ref[..., 3]) > 1e-6).mean() < 0.001


@pytest.mark.slow  # sharded full pipeline; dryrun covers the guard too
@pytest.mark.skipif(jax.device_count() < 4, reason="needs 4 virtual devices")
def test_halo_guard_falls_back_when_reach_exceeds_strip():
    """rows_local below the config worst-case reach: the halo pipeline
    must produce the all_gather pipeline's exact result (fallback), not a
    truncated stencil."""
    from flexlight_tpu.ops.buffers import build_scene_buffers
    from flexlight_tpu.parallel.tile_sharding import (
        frame_pipeline_sharded, frame_pipeline_sharded_halo, make_mesh,
        required_post_halo)
    from flexlight_tpu.post.taa import TAAState
    from flexlight_tpu.post.temporal import TemporalState

    from tests.scenes import cornell_scene

    scene, camera = cornell_scene()
    buffers = build_scene_buffers(scene)
    cfg = Config(temporal=True, temporal_samples=2, filter=True,
                 antialiasing=None, samples_per_ray=1, max_reflections=2)
    assert required_post_halo(cfg) > 8  # first filter reach is 42
    size = 32  # rows_local 8 < reach -> must fall back
    view = jnp.asarray(camera.view_matrix(size, size))
    pos = jnp.asarray(camera.position)
    temporal = TemporalState.create(2, size, size)
    taa = TAAState.create(size, size)
    mesh = make_mesh(4, 1)
    a, _, _ = frame_pipeline_sharded_halo(
        buffers, pos, view, jnp.float32(0.0), temporal, taa,
        width=size, height=size, config=cfg, mesh=mesh, halo=4)
    b, _, _ = frame_pipeline_sharded(
        buffers, pos, view, jnp.float32(0.0), temporal, taa,
        width=size, height=size, config=cfg, mesh=mesh)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_required_post_halo_values():
    from flexlight_tpu.parallel.tile_sharding import required_post_halo

    assert required_post_halo(Config(filter=False, antialiasing=None)) == 0
    assert required_post_halo(Config(filter=False, antialiasing="fxaa")) == 7
    # first filter: trunc(3 * 14) = 42
    assert required_post_halo(Config(filter=True)) == 42
    # second/final only
    no_first = Config(filter=True, first_passes=0, antialiasing=None)
    assert 8 <= required_post_halo(no_first) <= 9
