"""End-to-end render tests on the Cornell scene (small resolutions, CPU)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from flexlight_tpu import FlexLight
from tests.scenes import cornell_config, cornell_scene


def _engine(config, size=(32, 32)):
    engine = FlexLight(size)
    scene, camera = cornell_scene()
    engine.scene = scene
    engine.camera = camera
    engine.config = config
    return engine


@pytest.mark.slow
def test_pathtracer_direct_mode_renders():
    engine = _engine(cornell_config())
    engine.renderer = "pathtracer"
    img = engine.renderer.render_frame()
    assert img.shape == (32, 32, 3)
    assert np.isfinite(img).all()
    assert img.max() > 0.02  # something lit
    assert img.min() >= 0.0 and img.max() <= 1.0
    # Left wall red-ish, right wall green-ish: check hue split
    left = img[:, :4].mean(axis=(0, 1))
    right = img[:, -4:].mean(axis=(0, 1))
    assert left[0] > left[1]   # red dominant on left
    assert right[1] > right[0]  # green dominant on right


def test_pathtracer_deterministic():
    engine = _engine(cornell_config())
    engine.renderer = "pathtracer"
    a = engine.renderer.render_frame()
    b = engine.renderer.render_frame()
    np.testing.assert_array_equal(a, b)  # temporal off -> same seed -> identical


def test_pathtracer_temporal_mode():
    engine = _engine(cornell_config(temporal=True, temporal_samples=2))
    engine.renderer = "pathtracer"
    imgs = [engine.renderer.render_frame() for _ in range(3)]
    for img in imgs:
        assert np.isfinite(img).all()
    # Different random seeds -> frames differ before accumulation converges
    assert not np.array_equal(imgs[0], imgs[1])


@pytest.mark.slow
def test_pathtracer_filter_mode():
    engine = _engine(cornell_config(filter=True, temporal=False,
                                    first_passes=2, second_passes=2))
    engine.renderer = "pathtracer"
    img = engine.renderer.render_frame()
    assert np.isfinite(img).all()
    assert img.max() > 0.02


@pytest.mark.slow
def test_pathtracer_fxaa():
    engine = _engine(cornell_config(antialiasing="fxaa"))
    engine.renderer = "pathtracer"
    img = engine.renderer.render_frame()
    assert np.isfinite(img).all()
    assert img.max() > 0.02


def test_pathtracer_taa():
    engine = _engine(cornell_config(antialiasing="taa"))
    engine.renderer = "pathtracer"
    img = engine.renderer.render_frame()
    assert np.isfinite(img).all()


def test_rasterizer_renders():
    engine = _engine(cornell_config(hdr=True))
    engine.renderer = "rasterizer"
    img = engine.renderer.render_frame()
    assert img.shape == (32, 32, 3)
    assert np.isfinite(img).all()
    assert img.max() > 0.02


def test_simple_renderer():
    engine = _engine(cornell_config())
    engine.api = "webgpu"
    engine.renderer = "pathtracer"
    img = engine.renderer.render_frame()
    assert img.shape == (32, 32, 3)
    assert np.isfinite(img).all()


def test_render_quality_scales_resolution():
    engine = _engine(cornell_config(render_quality=0.5))
    engine.renderer = "pathtracer"
    img = engine.renderer.render_frame()
    assert img.shape == (16, 16, 3)


def test_emissive_surface_glows():
    engine = _engine(cornell_config())
    # Make the rear cube face emissive and check it shows up bright
    scene = engine.scene
    for item in scene.queue[0]:  # [cube0, cube1]
        item.emissiveness = 4.0
    engine.renderer = "pathtracer"
    img = engine.renderer.render_frame()
    assert img.max() > 0.5


def test_block_tile_roundtrip():
    import jax.numpy as jnp

    from flexlight_tpu.ops.pathtrace import block_tile, block_untile

    rows, width, bh, bw = 64, 128, 32, 32
    x = jnp.arange(rows * width, dtype=jnp.float32)
    t = block_tile(x, rows, width, bh, bw)
    np.testing.assert_array_equal(np.asarray(block_untile(t, rows, width, bh, bw)),
                                  np.asarray(x))
    xc = jnp.stack([x, x * 2], axis=-1)
    tc = block_tile(xc, rows, width, bh, bw)
    np.testing.assert_array_equal(np.asarray(block_untile(tc, rows, width, bh, bw)),
                                  np.asarray(xc))
    # first block really is the top-left 32x32 pixel block
    img = np.asarray(x).reshape(rows, width)
    np.testing.assert_array_equal(np.asarray(t)[:bh * bw].reshape(bh, bw),
                                  img[:bh, :bw])


def test_block_tiled_render_matches_unblocked():
    """Forcing block tiling on (threshold lowered) must not change the
    clustered scheme's MRT."""
    import flexlight_tpu.ops.pathtrace as pt
    import jax.numpy as jnp
    from flexlight_tpu.ops.buffers import build_scene_buffers

    scene, camera = cornell_scene()
    buffers = build_scene_buffers(scene)
    cfg = cornell_config(max_reflections=2)
    size = 32
    view = jnp.asarray(camera.view_matrix(size, size))
    pos = jnp.asarray(camera.position)
    ref = pt.render_mrt(buffers, size, size, pos, view, cfg, 0.0, scheme="clustered")
    old = pt.BLOCK_TILE_MIN_TRIS
    try:
        pt.BLOCK_TILE_MIN_TRIS = 1
        got = pt.render_mrt(buffers, size, size, pos, view, cfg, 0.0, scheme="clustered")
    finally:
        pt.BLOCK_TILE_MIN_TRIS = old
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(got)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)


def test_force_2d_layout_matches_flat():
    """The 2-D [G, 1024] shading layout (threshold lowered so a small
    frame takes it) must be a pure layout change: bit-identical MRT."""
    import flexlight_tpu.ops.pathtrace as pt
    import jax.numpy as jnp
    from flexlight_tpu.ops.buffers import build_scene_buffers

    scene, camera = cornell_scene()
    buffers = build_scene_buffers(scene)
    cfg = cornell_config(max_reflections=3)
    size = 32
    view = jnp.asarray(camera.view_matrix(size, size))
    pos = jnp.asarray(camera.position)
    ref = pt.render_mrt(buffers, size, size, pos, view, cfg, 0.0)
    old = pt.SHADE_2D_MIN_RAYS
    try:
        pt.SHADE_2D_MIN_RAYS = 1
        got = pt.render_mrt(buffers, size, size, pos, view, cfg, 0.0)
    finally:
        pt.SHADE_2D_MIN_RAYS = old
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(got)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
