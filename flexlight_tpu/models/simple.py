"""Simple renderer — WGPU-backend parity mode.

Counterpart of `modules/pathtracerWGPU.js` +
`shaders/pathtracer.wgsl`: the reference's WebGPU backend only implements
shadowed diffuse against lights[0] (pathtracer.wgsl:221-238) — flat first
vertex normal, inline albedo, 0.1x albedo in shadow, no bounces, no post.
"""

from __future__ import annotations

import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import traverse as trv
from ..ops.buffers import build_scene_buffers
from ..ops.geometry import world_geometry
from ..ops.intersect import BIAS
from ..ops.pathtrace import camera_rays


@partial(jax.jit, static_argnames=("width", "height"))
def simple_frame(buffers, cam_pos, view, width, height):
    world_geom = world_geometry(buffers)
    origin, direction, _ = camera_rays(width, height, cam_pos, view)
    n = origin.shape[0]
    # The reference WGPU backend rasterizes primaries (watertight);
    # relaxed edge window closes the ray-cast seam (ops.traverse._mt_chunk).
    hit = trv.traverse_scan(world_geom, origin, direction, edge=-BIAS)
    covered = hit.triangle != -1
    tri = jnp.maximum(hit.triangle, 0)

    world_pos = origin + hit.suv[:, 0:1] * direction
    attr = buffers.attributes[tri]
    normal = attr[:, 0:3]           # flat first-vertex normal (wgsl:228)
    albedo = attr[:, 18:21]

    light = buffers.lights[0, 0]
    d = light[None, :] - world_pos
    dist = jnp.linalg.norm(d, axis=-1)
    unit = d / jnp.maximum(dist, 1e-30)[:, None]
    shadowed = trv.shadow_scan(world_geom, world_pos, unit, dist)
    n_dot_l = jnp.sum(normal * unit, axis=-1)
    color = jnp.where(shadowed[:, None], 0.1 * albedo, albedo * n_dot_l[:, None])
    rgb = jnp.where(covered[:, None], jnp.clip(color, 0.0, 1.0), 0.0)
    return rgb.reshape(height, width, 3)


class SimplePathTracer:
    type = "pathtracer"

    def __init__(self, width, height, scene, camera, config):
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
        self._halt = True
        self._buffers = None
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
        if self._buffers is None:
            self.update_scene()

    def render_frame(self) -> np.ndarray:
        if self.freeze and self._last_frame is not None:
            return self._last_frame
        if self._buffers is None:
            self.update_scene()
        # fpsLimit throttling (pathtracerWGPU.js frameCycle cadence)
        if self.fps_limit != float("inf") and self._last_frame_time is not None:
            wait = 1.0 / self.fps_limit - (time.perf_counter() - self._last_frame_time)
            if wait > 0:
                time.sleep(wait)
        frame_t0 = time.perf_counter()
        view = self.camera.view_matrix(self.width, self.height)
        out = simple_frame(self._buffers, jnp.asarray(self.camera.position),
                           jnp.asarray(view), width=self.width, height=self.height)
        self._fps_frames += 1
        now = time.perf_counter()
        self._last_frame_time = now
        if now - self._fps_window_start > 0.5:
            self.fps = self._fps_frames / (now - self._fps_window_start)
            self._fps_window_start = now
            self._fps_frames = 0
        self._frame_count += 1
        self._last_frame = np.asarray(out)
        from ..utils.metrics import frame_record

        frame_record(self, (now - frame_t0) * 1000.0, scheme="scan")
        return self._last_frame
