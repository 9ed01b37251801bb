"""Rasterizer-equivalent renderer: single-bounce direct lighting.

Counterpart of `modules/rasterizerWGL2.js` +
`shaders/rasterizer_fragment.glsl`: the same scene-buffer contract, primary
visibility (here by ray cast instead of instanced rasterization), per-light
Cook-Torrance with shadow rays through the same skip-pointer traversal,
translucency fade, Reinhard+gamma, optional FXAA/TAA.

Reference quirks reproduced: forwardTrace receives the light vector
relative to the *local* (untransformed) position and the view vector
`camera - localPosition` (rasterizer_fragment.glsl:269), while the shadow
ray starts from the world position (glsl:267-268).
"""

from __future__ import annotations

import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import traverse as trv
from ..ops.brdf import forward_trace, normalize
from ..ops.buffers import build_scene_buffers, fetch_tex_val
from ..ops.geometry import world_geometry
from ..ops.intersect import BIAS
from ..ops.pathtrace import camera_rays
from ..ops.schemes import check_scheme, resolve_scheme
from ..post.common import quantize_rgba8, reinhard_gamma
from ..post.fxaa import fxaa
from ..post.taa import Jitter, TAAState, taa_apply


def _shade(buffers, cam_pos, hit, shadow_fn, n, config):
    """Shade one primary-visibility layer (rasterizer_fragment.glsl main):
    per-light Cook-Torrance + shadow rays, translucency fade, Reinhard.
    Returns (rgb [N,3] clamped, alpha [N]) — the fragment shader's
    vec4(finalColor, 1 - 0.5*tpo.x) output (glsl:291)."""
    tri = jnp.maximum(hit.triangle, 0)
    uvw = jnp.stack([1.0 - hit.suv[:, 1] - hit.suv[:, 2],
                     hit.suv[:, 1], hit.suv[:, 2]], axis=-1)

    # Full-row gathers, then column slices
    t_idx = buffers.geometry[tri][:, 9].astype(jnp.int32)
    rot_f = buffers.rotations[t_idx][:, 0]
    shift_f = buffers.shifts[t_idx][:, 0]

    # Local position: barycentric over untransformed vertices (the vertex
    # shader varying `position`), world = R p + shift (glsl:228).
    local_verts = buffers.geometry[tri][:, 0:9].reshape(n, 3, 3)
    local_pos = jnp.einsum("nvi,nv->ni", local_verts, uvw)
    world_pos = jnp.einsum("nij,nj->ni", rot_f, local_pos) + shift_f

    attr = buffers.attributes[tri]
    vertex_normals = attr[:, 0:9].reshape(n, 3, 3)
    smooth_normal = normalize(jnp.einsum(
        "nij,nj->ni", rot_f, jnp.einsum("nvi,nv->ni", vertex_normals, uvw)))
    uv_verts = attr[:, 9:15].reshape(n, 3, 2)
    barycentric = jnp.einsum("nvi,nv->ni", uv_verts, uvw)
    albedo = fetch_tex_val(buffers.albedo_atlas, barycentric, attr[:, 15],
                           attr[:, 18:21], buffers.texture_width)
    rme = fetch_tex_val(buffers.pbr_atlas, barycentric, attr[:, 16],
                        attr[:, 21:24], buffers.texture_width)
    tpo = fetch_tex_val(buffers.tpo_atlas, barycentric, attr[:, 17],
                        attr[:, 24:27], buffers.texture_width)

    final = rme[:, 2:3] + buffers.ambient[None, :]
    v = normalize(cam_pos[None, :] - local_pos)
    for j in range(buffers.lights.shape[0]):
        light = buffers.lights[j, 0]
        strength = buffers.lights[j, 1, 0]
        active = strength > 0.0
        local_color = forward_trace(albedo, rme, light[None, :] - local_pos,
                                    strength, smooth_normal, v)
        show = jnp.linalg.norm(local_color, axis=-1) == 0.0
        d = light[None, :] - world_pos
        dist = jnp.linalg.norm(d, axis=-1)
        shadowed = shadow_fn(world_pos, d / jnp.maximum(dist, 1e-30)[:, None], dist)
        add = active & (show | ~shadowed)
        final = jnp.where(add[:, None], final + local_color, final)

    final = final * albedo
    peak = jnp.max(final, axis=-1)
    t_factor = jnp.minimum(1.0 + peak - tpo[:, 0], 1.0)[:, None]
    final = albedo * albedo + (final - albedo * albedo) * t_factor
    if config.hdr:
        final = reinhard_gamma(final)
    alpha = 1.0 - 0.5 * tpo[:, 0]
    return jnp.clip(final, 0.0, 1.0), alpha


def _blend_layers(layers_data):
    """Simulate the reference's GL raster state — depth test LESS with
    depth writes AND blending both on (rasterizerWGL2.js:394-399:
    blendFuncSeparate(ONE, ONE_MINUS_SRC_ALPHA, ONE, ONE)) — over K
    depth-ordered hit layers per pixel.

    GL processes fragments in triangle draw order (= geometry-slot order,
    the flattener emits slots in DFS draw order): a fragment passes iff it
    is strictly closer than every earlier-drawn fragment, then blends
    dst = src.rgb + dst.rgb * (1 - src.a), dst.a = src.a + dst.a, with the
    RGBA8 canvas clamping each write. Sorting the layers by slot id and
    replaying that z-buffer scan reproduces the order-dependent result
    exactly (for hits beyond the K extracted layers, nothing blends —
    they are almost always depth-rejected anyway)."""
    # Static compare-swap sort by draw order (slot id; misses sort last).
    layers = list(layers_data)
    k = len(layers)
    key = [jnp.where(l[4], l[1], jnp.int32(2**30)) for l in layers]

    def _where(cond, a, b):
        return jnp.where(cond[:, None] if b.ndim == 2 else cond, a, b)

    def swapped(i, j):
        take = key[j] < key[i]
        ki, kj = (jnp.where(take, key[j], key[i]),
                  jnp.where(take, key[i], key[j]))
        li = tuple(_where(take, b, a) for a, b in zip(layers[i], layers[j]))
        lj = tuple(_where(take, a, b) for a, b in zip(layers[i], layers[j]))
        key[i], key[j] = ki, kj
        layers[i], layers[j] = li, lj

    pairs = {1: [], 2: [(0, 1)], 3: [(0, 1), (1, 2), (0, 1)],
             4: [(0, 1), (2, 3), (0, 2), (1, 3), (1, 2)]}
    for i, j in pairs.get(k, [(a, b) for a in range(k) for b in range(a + 1, k)]):
        swapped(i, j)

    n = layers[0][0].shape[0]
    z = jnp.full((n,), jnp.inf, dtype=jnp.float32)
    rgb = jnp.zeros((n, 3), dtype=jnp.float32)
    a_dst = jnp.zeros((n,), dtype=jnp.float32)
    for dist, _slot, src_rgb, src_a, covered in layers:
        passes = covered & (dist < z)
        blended = jnp.clip(src_rgb + rgb * (1.0 - src_a[:, None]), 0.0, 1.0)
        rgb = jnp.where(passes[:, None], blended, rgb)
        a_dst = jnp.where(passes, jnp.clip(src_a + a_dst, 0.0, 1.0), a_dst)
        z = jnp.where(passes, dist, z)
    return rgb, a_dst


@partial(jax.jit, static_argnames=("width", "height", "config", "scheme",
                                   "tile", "layers"))
def raster_frame(buffers, cam_pos, view, taa_state, width, height, config,
                 scheme="scan", tile=1024, layers: int = 1):
    check_scheme(scheme)
    world_geom = world_geometry(buffers)
    if scheme == "mxu":
        from ..ops.traverse_mxu import build_tri_matrix, shadow_mxu, traverse_mxu

        w = build_tri_matrix(world_geom, buffers.id_buffer)
        traverse_fn = lambda o, d: traverse_mxu(w, buffers.id_buffer, o, d,
                                                edge=-BIAS)
        shadow_fn = lambda o, d, l: shadow_mxu(w, o, d, l)
    elif scheme == "clustered":
        from ..ops.traverse_clustered import (build_clusters, shadow_clustered,
                                              traverse_clustered)

        clusters = build_clusters(world_geom, buffers.id_buffer)
        traverse_fn = lambda o, d: traverse_clustered(clusters, o, d, edge=-BIAS)
        shadow_fn = lambda o, d, l: shadow_clustered(clusters, o, d, l)
    elif scheme == "packet":
        def shadow_fn(o, d, l):
            return trv.shadow_coherent(world_geom, o, d, l, tile=tile)
        traverse_fn = lambda o, d: trv.traverse_coherent(world_geom, o, d,
                                                         tile=tile, edge=-BIAS)
    else:
        def shadow_fn(o, d, l):
            return trv.shadow_scan(world_geom, o, d, l)
        traverse_fn = lambda o, d: trv.traverse_scan(world_geom, o, d, edge=-BIAS)

    origin, direction, _ = camera_rays(width, height, cam_pos, view)
    n = origin.shape[0]

    # All casts stand in for the reference's raster draw (watertight
    # coverage), so they use the relaxed edge window (ops.traverse._mt_chunk).
    # Extract up to `layers` hit layers front-to-back by ray continuation
    # (re-cast from each hit point; s > BIAS rejects the surface itself),
    # then replay GL's draw-order blending over them. layers == 1 is the
    # opaque fast path: with everything opaque the blend replay reduces to
    # the closest hit, so the engine only requests more layers when the
    # scene has translucent material.
    layers_data = []
    o = origin
    cum = jnp.zeros((n,), dtype=jnp.float32)
    for layer in range(layers):
        hit = traverse_fn(o, direction)
        covered_l = hit.triangle != -1
        rgb_l, a_l = _shade(buffers, cam_pos, hit, shadow_fn, n, config)
        dist_l = cum + hit.suv[:, 0]
        layers_data.append((dist_l, hit.triangle, rgb_l, a_l, covered_l))
        if layer + 1 < layers:
            o = o + direction * hit.suv[:, 0:1]
            cum = dist_l

    if layers == 1:
        dist0, _slot, rgb_l, a_l, covered = layers_data[0]
        rgb = jnp.where(covered[:, None], rgb_l, 0.0)
        a = jnp.where(covered, a_l, 0.0)
    else:
        rgb, a = _blend_layers(layers_data)
    display = rgb.reshape(height, width, 3)
    alpha_img = a.reshape(height, width)

    if config.antialiasing in ("fxaa", "taa"):
        aa_in = jnp.concatenate([quantize_rgba8(display),
                                 quantize_rgba8(alpha_img)[..., None]], axis=-1)
        if config.antialiasing == "fxaa":
            display = fxaa(aa_in)[..., 0:3]
        else:
            out, taa_state = taa_apply(taa_state, aa_in)
            display = out[..., 0:3]
    return jnp.clip(display, 0.0, 1.0), taa_state


class Rasterizer:
    type = "rasterizer"

    def __init__(self, width, height, scene, camera, config,
                 scheme: str = "auto", tile: int = 1024):
        self.scene = scene
        self.camera = camera
        self.config = config
        self.canvas_width = int(width)
        self.canvas_height = int(height)
        self.fps = 0.0
        self.fps_limit = float("inf")
        # `freeze` pauses rendering: render_frame returns the last frame
        # (reference surface per obj.js:72 / highpoly.js:490).
        self.freeze = False
        self.scheme = scheme
        self.tile = tile
        # Max translucency layers blended per pixel (GL blends every
        # fragment; 4 depth layers cover the examples' glass). Resolved to
        # 1 when the scene has no translucent material.
        self.layers = 4
        self._halt = True
        self._has_translucency = False
        self._buffers = None
        self._taa_state = None
        self._jitter = Jitter()
        self._prepared_shape = None
        self._last_frame = None
        self._last_frame_time = None
        self._fps_window_start = time.perf_counter()
        self._fps_frames = 0
        self._frame_count = 0
        from ..utils.metrics import FrameMetrics

        self.metrics = FrameMetrics()

    @property
    def width(self):
        return max(int(self.canvas_width * self.config.render_quality), 1)

    @property
    def height(self):
        return max(int(self.canvas_height * self.config.render_quality), 1)

    def halt(self):
        self._halt = True

    def update_scene(self):
        self._buffers = build_scene_buffers(self.scene)
        # attributes[:, 24] = per-triangle translucency; a non-degenerate
        # TPO atlas means texture-driven translucency is possible.
        self._has_translucency = bool(
            np.any(np.asarray(self._buffers.attributes[:, 24]) > 0.0)
            or self._buffers.tpo_atlas.size > 3)

    def update_primary_light_sources(self):
        if self._buffers is None:
            self.update_scene()
        else:
            self._buffers = self._buffers._replace(
                lights=jnp.asarray(self.scene.build_light_array()))

    updateScene = update_scene
    updatePrimaryLightSources = update_primary_light_sources

    @property
    def fpsLimit(self):
        return self.fps_limit

    @fpsLimit.setter
    def fpsLimit(self, value):
        self.fps_limit = value

    def render(self):
        self._halt = False
        self._prepare()

    def _prepare(self):
        if self._buffers is None:
            self.update_scene()
        shape = (self.height, self.width, self.config)
        if self._prepared_shape != shape:
            self._taa_state = TAAState.create(self.height, self.width)
            self._prepared_shape = shape

    def render_frame(self) -> np.ndarray:
        if self.freeze and self._last_frame is not None:
            return self._last_frame
        if self._halt:
            self.render()
        # fpsLimit throttling (rasterizerWGL2.js:248-250)
        if self.fps_limit != float("inf") and self._last_frame_time is not None:
            wait = 1.0 / self.fps_limit - (time.perf_counter() - self._last_frame_time)
            if wait > 0:
                time.sleep(wait)
        self._prepare()
        from ..scene.transform import global_registry

        rot, shift = global_registry().build_arrays()
        self._buffers = self._buffers._replace(
            rotations=jnp.asarray(rot), shifts=jnp.asarray(shift))
        frame_t0 = time.perf_counter()
        jitter = (0.0, 0.0)
        if self.config.antialiasing == "taa":
            jitter = self._jitter.next(self.width, self.height)
        view = self.camera.view_matrix(self.width, self.height, jitter)
        scheme = resolve_scheme(self.scheme, self._buffers.id_buffer.shape[0])
        layers = max(int(self.layers), 1) if self._has_translucency else 1
        display, self._taa_state = raster_frame(
            self._buffers, jnp.asarray(self.camera.position), jnp.asarray(view),
            self._taa_state, width=self.width, height=self.height,
            config=self.config, scheme=scheme, tile=self.tile, layers=layers)
        from ..utils.debug import assert_finite

        assert_finite(display, "rasterizer.frame")
        self._fps_frames += 1
        now = time.perf_counter()
        self._last_frame_time = now
        if now - self._fps_window_start > 0.5:
            self.fps = self._fps_frames / (now - self._fps_window_start)
            self._fps_window_start = now
            self._fps_frames = 0
        self._frame_count += 1
        self._last_frame = np.asarray(display)
        from ..utils.metrics import frame_record

        frame_record(self, (now - frame_t0) * 1000.0, scheme=scheme,
                     layers=layers)
        return self._last_frame
