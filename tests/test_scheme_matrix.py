"""Full MRT renders on the two XLA casts `auto` dispatches between
(`mxu`, `clustered`) against the scan oracle, over the renderer's scene
and config axes: bounce depth, reservoir (unrolled and lax.scan light
loops, with jitter), refraction + emission, a real texture atlas,
multisample and the counter RNG.

Channels with no RNG upstream of the primary hit (coverage, the location
id) must match exactly. The rest sit downstream of fp-ulp differences in
hit distances that move reservoir weights and Fresnel decisions, and the
hash RNG turns a flipped decision into a different path (the same chaos
class as the golden harness), so they get aggregate + outlier budgets.
"""

import os
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from flexlight_tpu.ops.buffers import build_scene_buffers
from flexlight_tpu.ops.pathtrace import render_mrt
from tests.scenes import cornell_config, cornell_scene

SIZE = 24


def _lights(n):
    def build():
        scene, camera = cornell_scene()
        scene.primaryLightSources = [
            [i % 4 - 1.5, 4, (i // 4) - 2.0] for i in range(n)]
        for i, light in enumerate(scene.primary_light_sources):
            light.intensity = 30 + i
            light.variation = 0.2
        return scene, camera
    return build


def _textured():
    """Cornell + a 128x128 RME texture on the first cube (a real atlas:
    removing it moves color by O(1))."""
    scene, camera = cornell_scene()
    rng = np.random.default_rng(0)
    tex = scene.texture_from_rme(
        rng.uniform(0.1, 0.9, 128 * 128 * 3).astype(np.float32), 128, 128)
    scene.pbr_textures.push(tex)
    scene.standardTextureSizes = [128, 128]
    scene.queue[0][0].textureNums = [-1, 0, -1]
    return scene, camera


def _emissive():
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))
    import emissive

    engine = emissive.build_scene()
    return engine.scene, engine.camera


CASES = {
    "bounces1": (cornell_scene, dict(max_reflections=1)),
    "bounces5": (cornell_scene, dict(max_reflections=5)),
    "reservoir8": (_lights(8), dict(max_reflections=2)),
    "reservoir20_scan": (_lights(20), dict(max_reflections=2)),
    "refraction_emission": (_emissive, dict(max_reflections=3)),
    "textures": (_textured, dict(max_reflections=3)),
    "multisample": (cornell_scene, dict(max_reflections=2, samples_per_ray=2)),
    "counter_rng": (cornell_scene, dict(max_reflections=3, rng="counter")),
}

_scan_cache = {}


def _render(case, scheme):
    build, overrides = CASES[case]
    scene, camera = build()
    buffers = build_scene_buffers(scene)
    cfg = cornell_config(**overrides)
    view = jnp.asarray(camera.view_matrix(SIZE, SIZE))
    pos = jnp.asarray(camera.position)
    mrt = render_mrt(buffers, SIZE, SIZE, pos, view, cfg, jnp.float32(0.0),
                     scheme=scheme)
    return jax.tree.map(np.asarray, mrt)


@pytest.mark.parametrize("scheme", ["mxu", "clustered"])
@pytest.mark.parametrize("case", list(CASES))
def test_render_matches_scan(case, scheme):
    from flexlight_tpu.scene.transform import reset_global_registry

    if case not in _scan_cache:
        _scan_cache[case] = _render(case, "scan")
        reset_global_registry()
    ref = _scan_cache[case]
    got = _render(case, scheme)
    # no RNG upstream of the primary hit: exact coverage and location
    np.testing.assert_array_equal(got.alpha, ref.alpha)
    assert ref.alpha.mean() > 0.5
    np.testing.assert_allclose(got.location_id, ref.location_id, atol=1e-5)
    # RNG-downstream: aggregates match, isolated pixels may flip (about
    # 2% of a 24^2 frame on the CPU)
    a, b = ref.color, got.color
    assert abs(a.mean() - b.mean()) <= 0.03 * max(a.mean(), 1e-6)
    close = np.isclose(a, b, atol=1e-3).all(axis=-1)
    assert close.mean() >= 0.95, close.mean()
    ids_equal = (ref.render_id == got.render_id).all(axis=-1)
    assert ids_equal.mean() >= 0.95, ids_equal.mean()
