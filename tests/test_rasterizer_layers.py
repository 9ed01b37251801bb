"""Rasterizer translucency layering.

The reference rasterizer draws every triangle with depth test, depth
WRITES, and blending all enabled (rasterizerWGL2.js:394-399,
blendFuncSeparate(ONE, ONE_MINUS_SRC_ALPHA, ONE, ONE)) — so the blended
result is draw-order dependent: a translucent surface drawn BEFORE the
geometry behind it occludes that geometry via the depth buffer, while one
drawn AFTER blends over it. These tests pin both orderings against
compositing the isolated single-surface renders.
"""

import numpy as np

from flexlight_tpu import Camera, Config, FlexLight, Scene

SIZE = 24


def _build(order):
    """Opaque back wall at z=5, translucent glass pane at z=0, camera at
    z=-5 looking +z, light placed so neither surface shadows the other.
    `order` = 'wall_first' or 'glass_first' controls draw (slot) order."""
    scene = Scene()
    scene.primaryLightSources = [[0, 0.5, 2.5]]
    scene.primary_light_sources[0].intensity = 20
    wall = scene.Plane([-4, -4, 5], [4, -4, 5], [4, 4, 5], [-4, 4, 5])
    wall.color = [200, 40, 40]
    glass = scene.Plane([-4, -4, 0], [4, -4, 0], [4, 4, 0], [-4, 4, 0])
    glass.color = [40, 200, 40]
    glass.translucency = 0.5
    if order == "wall_first":
        scene.queue.push(wall, glass)
    else:
        scene.queue.push(glass, wall)
    camera = Camera()
    camera.z = -5
    return scene, camera


def _render(scene, camera, layers=4):
    engine = FlexLight((SIZE, SIZE))
    engine.scene = scene
    engine.camera = camera
    engine.config = Config(temporal=False, filter=False, antialiasing=None,
                           hdr=False)
    engine.renderer = "rasterizer"
    engine.renderer.layers = layers
    return engine.renderer.render_frame()


def _solo(kind):
    """Render only the wall or only the glass (same light)."""
    scene = Scene()
    scene.primaryLightSources = [[0, 0.5, 2.5]]
    scene.primary_light_sources[0].intensity = 20
    if kind == "wall":
        surf = scene.Plane([-4, -4, 5], [4, -4, 5], [4, 4, 5], [-4, 4, 5])
        surf.color = [200, 40, 40]
    else:
        surf = scene.Plane([-4, -4, 0], [4, -4, 0], [4, 4, 0], [-4, 4, 0])
        surf.color = [40, 200, 40]
        surf.translucency = 0.5
    scene.queue.push(surf)
    camera = Camera()
    camera.z = -5
    return _render(scene, camera, layers=1)


def test_glass_drawn_after_wall_blends():
    """Wall drawn first: glass passes the depth test afterwards and blends
    dst = glass.rgb + wall.rgb * (1 - glass.a), glass.a = 1 - 0.5*0.5."""
    scene, camera = _build("wall_first")
    img = _render(scene, camera)
    wall = _solo("wall")
    glass = _solo("glass")
    expected = np.clip(glass + wall * (1.0 - 0.75), 0.0, 1.0)
    assert np.allclose(img, expected, atol=1e-3), (
        np.abs(img - expected).max())
    # sanity: the wall really shows through
    assert (img - glass).max() > 0.01


def test_glass_drawn_before_wall_occludes():
    """Glass drawn first writes depth; the wall behind then fails the
    depth test everywhere — glass alone is visible (the reference's
    order-dependence, reproduced)."""
    scene, camera = _build("glass_first")
    img = _render(scene, camera)
    glass = _solo("glass")
    assert np.allclose(img, glass, atol=1e-3)


def test_opaque_scene_layered_matches_single():
    """With no translucency the engine resolves to 1 layer; forcing 4
    layers must not change the image (blend replay reduces to closest
    hit)."""
    from flexlight_tpu.models.rasterizer import raster_frame
    import jax.numpy as jnp

    from tests.scenes import cornell_scene

    scene, camera = cornell_scene()
    engine = FlexLight((SIZE, SIZE))
    engine.scene = scene
    engine.camera = camera
    engine.config = Config(temporal=False, filter=False, antialiasing=None)
    engine.renderer = "rasterizer"
    r = engine.renderer
    single = r.render_frame()
    assert r._has_translucency is False
    view = camera.view_matrix(SIZE, SIZE)
    forced, _ = raster_frame(
        r._buffers, jnp.asarray(camera.position), jnp.asarray(view),
        r._taa_state, width=SIZE, height=SIZE, config=r.config,
        scheme="mxu", layers=4)
    assert np.allclose(single, np.asarray(forced), atol=1e-5)
