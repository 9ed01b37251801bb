"""Reference-output parity: vectorized pipeline vs scalar GLSL oracle.

`tests/reference_oracle.py` is an independent per-pixel float32
transcription of `shaders/pathtracer_fragment.glsl`; `render_mrt` is the
vectorized pipeline (SoA wavefront, scheme-dispatched traversal). Agreement
between the two on every MRT channel is the proof that the build computes
the reference renderer's observable output (VERDICT round-1 item 6) —
the screenshot diff cannot serve that role because the shipped browser
screenshots span renderer vintages and interactive camera poses (see
docs/PARITY.md).

Comparison contract:
- pixels where both sides pick the same primary triangle must match to
  float32 accumulation noise (atol 1e-4) on color and bit-exactly-ish on
  the aux channels;
- pixels picking different primaries must be bit-exact DISTANCE TIES
  (s equal to ~1 ulp): with the relaxed primary edge window, a ray
  through a shared edge legitimately hits both coplanar triangles and
  the winner is an fp/order coin flip. Anything else is a real bug.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import tests.reference_oracle as oracle  # noqa: E402
from tests.scenes import cornell_config, cornell_scene  # noqa: E402

SIZE = 12


@pytest.fixture(autouse=True)
def _aligned_sin():
    """Align the oracle's sin with XLA's: the hash RNG multiplies sin by
    43758.5453, so a 1-ulp libm difference flips random branches at ~10%
    of pixels. Everything under test stays independent."""
    prev = oracle.SIN, oracle.COS
    oracle.SIN = lambda x: np.asarray(jnp.sin(jnp.asarray(x, dtype=jnp.float32)))
    oracle.COS = lambda x: np.asarray(jnp.cos(jnp.asarray(x, dtype=jnp.float32)))
    yield
    oracle.SIN, oracle.COS = prev


def _build(scene_mutator=None):
    from flexlight_tpu.ops.buffers import build_scene_buffers

    scene, camera = cornell_scene()
    if scene_mutator is not None:
        scene_mutator(scene)
    buffers = build_scene_buffers(scene)
    view = camera.view_matrix(SIZE, SIZE)
    cam = np.array([camera.x, camera.y, camera.z], np.float32)
    return buffers, cam, view


def _compare(buffers, cam, view, config, seed=0.0, outliers=0):
    from flexlight_tpu.ops.geometry import world_geometry
    from flexlight_tpu.ops.pathtrace import camera_rays, render_mrt
    from flexlight_tpu.ops.traverse import traverse_scan

    h = w = SIZE
    mrt = render_mrt(buffers, w, h, cam, view, config, seed, scheme="scan")
    out = oracle.render(buffers, w, h, cam, view, config, seed)

    # Primary-agreement mask + tie validation
    o3, d3, _ = camera_rays(w, h, cam, view)
    hit = traverse_scan(world_geometry(buffers), o3, d3, edge=-oracle.BIAS)
    tri_pipe = np.asarray(hit.triangle).reshape(h, w)
    s_pipe = np.asarray(hit.suv)[:, 0].reshape(h, w)
    d3n = np.asarray(d3)
    b = oracle._Buffers(buffers)
    agree = np.ones((h, w), dtype=bool)
    for y in range(h):
        for x in range(w):
            suv, _, tri = oracle.ray_tracer(
                b, cam, d3n[y * w + x].astype(np.float32), edge=-oracle.BIAS)
            if tri == tri_pipe[y, x]:
                continue
            agree[y, x] = False
            assert tri != -1 and tri_pipe[y, x] != -1, (
                f"coverage mismatch at {(y, x)}: oracle {tri}, "
                f"pipeline {tri_pipe[y, x]}")
            rel = abs(suv[0] - s_pipe[y, x]) / max(s_pipe[y, x], 1e-6)
            assert rel < 1e-5, (
                f"primary mismatch at {(y, x)} is not a distance tie: "
                f"oracle tri {tri} s {suv[0]}, pipeline tri "
                f"{tri_pipe[y, x]} s {s_pipe[y, x]}")
    assert agree.mean() > 0.85, f"too many edge ties: {1 - agree.mean():.1%}"

    def check(name, pipe, atol):
        diff = np.abs(out[name] - np.asarray(pipe).reshape(out[name].shape))
        masked = diff[agree]
        # `outliers` pixels may exceed atol: a bounce ray grazing a
        # triangle edge can land on different geometry between the two
        # implementations from a 1-ulp direction difference (fp chaos,
        # not a semantic divergence) — but only for stochastic configs
        # that opt in, and never more than the budget.
        if masked.ndim > 1:
            masked = masked.max(axis=-1)
        n_over = int((masked > atol).sum())
        assert n_over <= outliers, (
            f"{name}: {n_over} pixels exceed {atol} on primary-agreeing "
            f"pixels (budget {outliers}); max diff {masked.max():.2e}")

    check("color", mrt.color, 2e-4)
    check("original_color", mrt.original_color, 1e-5)
    check("render_id", mrt.render_id, 1e-5)
    check("original_w", mrt.original_w, 1e-5)
    check("original_id_w", mrt.original_id_w, 1e-5)
    check("glass", mrt.glass, 0.0)
    check("location_id", mrt.location_id, 1e-5)
    check("alpha", mrt.alpha, 0.0)
    return agree.mean()


@pytest.mark.parametrize("bounces", [1, 3])
def test_cornell_parity(bounces):
    buffers, cam, view = _build()
    _compare(buffers, cam, view, cornell_config(max_reflections=bounces))


@pytest.mark.slow
def test_cornell_parity_two_lights():
    """Reservoir selection across lights (glsl:409-436): a second light
    makes the weighted-reservoir branch and its noise chain decisive."""

    def add_light(scene):
        scene.primaryLightSources = [[0, 4, 0], [-3, 4, -10]]
        scene.primary_light_sources[0].intensity = 160
        scene.primary_light_sources[1].intensity = 100
        scene.primary_light_sources[1].variation = 0.2

    buffers, cam, view = _build(add_light)
    assert buffers.lights.shape[0] == 2
    _compare(buffers, cam, view, cornell_config(max_reflections=2))


@pytest.mark.slow
def test_cornell_parity_translucent():
    """Fresnel-chance refraction path (glsl:550, 582-589) + glassFilter
    accumulation: make one cube translucent glass."""

    def glassify(scene):
        cube = scene.queue[0][1]
        cube.translucency = 0.8
        cube.ior = 1.5
        cube.roughness = 0.0
        cube.color = [255, 220, 220]

    buffers, cam, view = _build(glassify)
    _compare(buffers, cam, view, cornell_config(max_reflections=3))


@pytest.mark.slow
def test_cornell_parity_textured():
    """Texture-atlas path (fetch_tex_val, glsl:100-117): the cornell.js
    PBR checker texture (cornell.js:18-31) drives per-pixel roughness/
    metallicity through the NEAREST atlas fetch on both sides."""
    import numpy as np_

    def texture(scene):
        tile = np_.zeros((128, 128, 3), dtype=np_.float32)
        tile[:64, :64] = tile[64:, 64:] = [1, 0, 0.4]
        tile[:64, 64:] = tile[64:, :64] = [0.1, 1, 0]
        scene.pbr_textures.push(scene.texture_from_rme(tile.reshape(-1),
                                                       128, 128))
        scene.standardTextureSizes = [128, 128]
        scene.queue[0][1].textureNums = [-1, 0, -1]

    buffers, cam, view = _build(texture)
    _compare(buffers, cam, view, cornell_config(max_reflections=2))


@pytest.mark.slow
def test_cornell_parity_multisample_seeded():
    """samples_per_ray > 1 (cosine sample phases, glsl:611-612) and a
    non-zero randomSeed uniform."""
    buffers, cam, view = _build()
    cfg = cornell_config(max_reflections=2, samples_per_ray=2)
    _compare(buffers, cam, view, cfg, seed=0.375, outliers=2)
