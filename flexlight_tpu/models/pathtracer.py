"""PathTracer renderer — the flagship model.

Counterpart of `modules/pathtracerWGL2.js`: owns the compiled
frame pipeline (pathtrace MRT -> temporal -> denoise filters -> AA), the
functional history state, scene-buffer uploads, and FPS accounting. The
reference's per-frame GL orchestration (renderFrame,
pathtracerWGL2.js:375-554) becomes one jitted pure function of
(scene buffers, camera, history state, random seed); the texture ping-pong
index dance of the filter chain is replicated exactly with static Python
indices, including its dropped-attachment quirks (see _filter_chain).
"""

from __future__ import annotations

import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Config
from ..ops.buffers import build_scene_buffers
from ..ops.pathtrace import render_mrt
from ..ops.schemes import resolve_scheme
from ..post.common import quantize_rgba8, split_hdr, tileize_blur_key
from ..post.filters import final_filter, first_filter, second_filter
from ..post.fxaa import fxaa
from ..post.taa import Jitter, TAAState, taa_apply
from ..post.temporal import TemporalState, push_frame, temporal_average


def _quantized_mrt(mrt, height, width):
    """Reshape flat MRT to images and apply RGBA8 store quantization the
    way the reference's render-target textures do (renderTextureBuilder,
    pathtracerWGL2.js:790-806)."""
    def img(x, c=None):
        return x.reshape(height, width) if c is None else x.reshape(height, width, c)

    color = img(mrt.color, 3)
    alpha = img(mrt.alpha)
    frac_q, high_q = split_hdr(color)
    color_q = jnp.concatenate([frac_q, alpha[..., None]], axis=-1)
    ip_q = jnp.concatenate([high_q, quantize_rgba8(img(mrt.glass))[..., None]], axis=-1)
    id_q = quantize_rgba8(img(mrt.render_id, 4))
    oid_q = jnp.concatenate([jnp.zeros((height, width, 3)),
                             quantize_rgba8(img(mrt.original_id_w))[..., None]], axis=-1)
    ocolor_q = quantize_rgba8(jnp.concatenate(
        [img(mrt.original_color, 3), img(mrt.original_w)[..., None]], axis=-1))
    return color, alpha, color_q, ip_q, id_q, oid_q, ocolor_q


def _filter_chain(config: Config, r0, ip0, oc0, id0, oid, lift=None,
                  tileize=None):
    """The first/second/final filter ping-pong, index-exact to
    pathtracerWGL2.js:462-549 — including the reference's quirk that the
    first two second-pass originalColor writes land on a nonexistent
    attachment (IdRenderTexture[2/3]) and are dropped, so the second
    second-pass reads a zero originalColor texture.

    `lift` wraps each individual pass — the sharded pipeline injects a
    ppermute halo exchange per pass here (parallel.halo.with_halo).
    `tileize` is the fast-mode blur-key quantizer applied to every
    originalColor a pass consumes (defaults to post.common.tileize_blur_key;
    the halo-sharded pipeline passes its psum-based global-grid variant)."""
    fast = config.filter_mode == "fast"
    lift = lift if lift is not None else (lambda f: f)
    if fast and tileize is None:
        tileize = tileize_blur_key
    key_fn = tileize if fast else (lambda x: x)
    zeros = jnp.zeros_like(r0)
    render = {0: r0, 1: zeros, 2: zeros, 3: zeros}
    ip = {0: ip0, 1: zeros, 2: zeros, 3: zeros}
    ids = {0: id0, 1: zeros}
    ocolor = {0: key_fn(oc0), 1: zeros}
    n = n_id = n_original = 0
    first, second = config.first_passes, config.second_passes
    for i in range(first + second):
        np_ = (i % 2) ^ 1
        npo = ((i - first) % 2) ^ 1
        if i >= first:
            np_ += 2
        inputs = (render[n], ip[n], ocolor[n_original], ids[n_id], oid)
        if i < first:
            c, p, idout = lift(first_filter)(*inputs)
            render[np_], ip[np_] = c, p
            ids[np_] = idout
        else:
            c, p, oc = lift(second_filter)(*inputs)
            render[np_], ip[np_] = c, p
            if i - 2 >= first:
                ocolor[npo] = key_fn(oc)  # earlier second passes: write dropped
        n = np_
        if i >= first:
            n_original = npo
        else:
            n_id = np_
    index = 2 + (first + second) % 2
    index_id = first % 2
    index_original = second % 2
    return lift(lambda *xs: final_filter(*xs, config.hdr))(
        render[index], ip[index], ocolor[index_original], ids[index_id], oid)


def postprocess_mrt(mrt, temporal_state: TemporalState, taa_state: TAAState,
                    width: int, height: int, config: Config):
    """temporal -> denoise -> AA, shared by the single-chip and sharded
    pipelines. Returns (display rgb [H,W,3] in [0,1], temporal, taa)."""
    color, alpha, color_q, ip_q, id_q, oid_q, ocolor_q = _quantized_mrt(mrt, height, width)

    use_aa = config.antialiasing in ("fxaa", "taa")
    display = None

    if config.temporal:
        # randomSeed-synced accumulation ring (pathtracerWGL2.js:389-401)
        temporal_state = push_frame(temporal_state, color_q, ip_q, id_q, oid_q)
        t_color, t_glass, center_w = temporal_average(temporal_state)
        if config.filter:
            frac_q, high_q = split_hdr(t_color)
            r0 = jnp.concatenate([frac_q, center_w[..., None]], axis=-1)
            ip0 = jnp.concatenate([high_q, quantize_rgba8(t_glass)[..., None]], axis=-1)
            display = _filter_chain(config, r0, ip0, ocolor_q, id_q, oid_q)
        else:
            # Temporal-only output is raw (the generated shader's HDR branch
            # is dead code, overwritten at pathtracerWGL2.js:660) and lands
            # in an RGBA8 target -> clamp.
            display = jnp.clip(t_color, 0.0, 1.0)
            if use_aa:
                display = quantize_rgba8(display)
    elif config.filter:
        display = _filter_chain(config, color_q, ip_q, ocolor_q, id_q, oid_q)
    else:
        # Direct mode (glsl:625-632): fold in first-hit albedo, no tone map.
        direct = color * mrt.original_color.reshape(height, width, 3)
        display = jnp.clip(direct, 0.0, 1.0)

    if use_aa:
        aa_in = jnp.concatenate([quantize_rgba8(display),
                                 (alpha > 0).astype(jnp.float32)[..., None]], axis=-1)
        if config.antialiasing == "fxaa":
            display = fxaa(aa_in)[..., 0:3]
        else:
            out, taa_state = taa_apply(taa_state, aa_in)
            display = out[..., 0:3]

    return jnp.clip(display, 0.0, 1.0), temporal_state, taa_state


@partial(jax.jit, static_argnames=("width", "height", "config", "scheme", "tile"))
def frame_pipeline(buffers, cam_pos, view, random_seed,
                   temporal_state: TemporalState, taa_state: TAAState,
                   width: int, height: int, config: Config,
                   scheme: str = "scan", tile: int = 1024):
    """One full single-chip frame: MRT pathtrace pass + post."""
    mrt = render_mrt(buffers, width, height, cam_pos, view, config,
                     random_seed, scheme=scheme, tile=tile)
    return postprocess_mrt(mrt, temporal_state, taa_state, width, height, config)


@jax.jit
def _quantize_u8(display):
    """[H, W, 3] f32 in [0,1] -> uint8 on device (round-to-nearest, the
    reference's RGBA8 canvas store)."""
    return jnp.round(jnp.clip(display, 0.0, 1.0) * 255.0).astype(jnp.uint8)


class PathTracer:
    """Drop-in renderer object with the reference's duck-type surface
    (render/halt/updateScene/updatePrimaryLightSources/fps/fpsLimit)."""

    type = "pathtracer"

    def __init__(self, width, height, scene, camera, config,
                 scheme: str = "auto", tile: int = 1024):
        self.scene = scene
        self.camera = camera
        self.config = config
        self.canvas_width = int(width)
        self.canvas_height = int(height)
        self.fps = 0.0
        self.fps_limit = float("inf")
        # `freeze` pauses accumulation/animation: render_frame returns the
        # last frame (obj.js:72 references it; implemented in the dead
        # highpoly.js:490 renderer — here it is first-class).
        self.freeze = False
        # Pipelined fetch: render_frame returns frame N-k while frame N
        # computes (see render_frame docstring). `pipelined` is the
        # swapchain depth k: False/0 = synchronous, True/1 = classic
        # double buffer, k > 1 keeps k device->host transfers in flight.
        self.pipelined = False
        self._pending_display = []
        self.scheme = scheme
        self.tile = tile
        self._halt = True
        self._last_frame = None
        self._last_frame_time = None
        self._buffers = None
        self._temporal_state = None
        self._taa_state = None
        self._frame_count = 0
        self._jitter = Jitter()
        self._fps_window_start = time.perf_counter()
        self._fps_frames = 0
        self._prepared_shape = None
        from ..utils.metrics import FrameMetrics

        self.metrics = FrameMetrics()

    # --- size derived from renderQuality (pathtracerWGL2.js:809-812) ---
    @property
    def width(self) -> int:
        return max(int(self.canvas_width * self.config.render_quality), 1)

    @property
    def height(self) -> int:
        return max(int(self.canvas_height * self.config.render_quality), 1)

    def halt(self):
        self._halt = True

    def update_scene(self):
        self._buffers = build_scene_buffers(self.scene)

    def _resolved_scheme(self) -> str:
        return resolve_scheme(self.scheme, self._buffers.id_buffer.shape[0])

    def update_primary_light_sources(self):
        if self._buffers is None:
            self.update_scene()
        else:
            self._buffers = self._buffers._replace(
                lights=jnp.asarray(self.scene.build_light_array()),
                ambient=jnp.asarray(np.asarray(self.scene.ambient_light, dtype=np.float32)),
            )

    def _refresh_transforms(self):
        """Per-frame transform upload, mirroring the reference's UBO refill
        every pathtracing pass (pathtracerWGL2.js:361-363) so animated
        transforms (wave.js:64-73) take effect without re-flattening."""
        from ..scene.transform import global_registry

        reg = global_registry()
        # key on the registry object's identity too: after
        # reset_global_registry() a fresh registry could coincide with the
        # cached counter value and skip the upload with stale arrays
        if getattr(self, "_transform_version", None) == (id(reg), reg.version):
            return  # nothing moved: skip the rebuild AND the upload
        self._transform_version = (id(reg), reg.version)
        rot, shift = reg.build_arrays()
        self._buffers = self._buffers._replace(
            rotations=jnp.asarray(rot), shifts=jnp.asarray(shift))

    # camelCase aliases (reference API)
    updateScene = update_scene
    updatePrimaryLightSources = update_primary_light_sources

    @property
    def fpsLimit(self):
        return self.fps_limit

    @fpsLimit.setter
    def fpsLimit(self, value):
        self.fps_limit = value

    def render(self):
        """Prepare the engine (buffers + state); frames are then produced by
        `render_frame()` — the headless analogue of the RAF loop."""
        self._halt = False
        self._prepare()

    def _prepare(self):
        if self._buffers is None:
            self.update_scene()
        shape = (self.height, self.width, self.config)
        if self._prepared_shape != shape:
            self._temporal_state = TemporalState.create(
                self.config.temporal_samples, self.height, self.width)
            self._taa_state = TAAState.create(self.height, self.width)
            self._frame_count = 0
            self._prepared_shape = shape
            self._pending_display = []

    def render_frame(self) -> np.ndarray:
        """Render one frame; returns [H, W, 3] float32 in [0, 1].

        With `self.pipelined = True`, the fetch is double-buffered: the
        call dispatches frame N and returns frame N-1's pixels (one frame
        of latency, like a GPU swapchain) so the device->host transfer
        overlaps the next frame's compute."""
        return self._render_fetch(as_u8=False)

    def render_frame_u8(self) -> np.ndarray:
        """Like render_frame but quantizes to rgba8-style uint8 ON DEVICE
        and fetches [H, W, 3] uint8 — 4x less transfer traffic; matches
        the reference's canvas precision (RGBA8 backbuffer)."""
        return self._render_fetch(as_u8=True)

    def _render_fetch(self, as_u8: bool) -> np.ndarray:
        if self.freeze and self._last_frame is not None:
            return self._last_frame
        if self._halt:
            self.render()
        # fpsLimit throttling (pathtracerWGL2.js:300-302)
        if self.fps_limit != float("inf") and self._last_frame_time is not None:
            wait = 1.0 / self.fps_limit - (time.perf_counter() - self._last_frame_time)
            if wait > 0:
                time.sleep(wait)
        self._prepare()
        self._refresh_transforms()
        frame_t0 = time.perf_counter()
        jitter = (0.0, 0.0)
        if self.config.antialiasing == "taa":
            jitter = self._jitter.next(self.width, self.height)
        view = self.camera.view_matrix(self.width, self.height, jitter)
        temporal_frame = self._frame_count % self.config.temporal_samples
        random_seed = float(temporal_frame) if self.config.temporal else 0.0

        display, self._temporal_state, self._taa_state = frame_pipeline(
            self._buffers, jnp.asarray(self.camera.position), jnp.asarray(view),
            jnp.float32(random_seed), self._temporal_state, self._taa_state,
            width=self.width, height=self.height, config=self.config,
            scheme=self._resolved_scheme(), tile=self.tile)
        from ..utils.debug import assert_finite

        assert_finite((display, self._temporal_state), "pathtracer.frame")
        if as_u8:
            display = _quantize_u8(display)
        if self.pipelined:
            # swapchain: fetch frame N-k (its transfer started k calls
            # ago) while this frame computes; dispatch is async on all
            # jax backends. copy_to_host_async starts the device->host
            # transfer NOW, so with depth k there are k transfers in
            # flight.
            depth = int(self.pipelined)
            try:
                display.copy_to_host_async()
            except AttributeError:
                pass  # non-jax arrays (freeze path) / older backends
            self._pending_display.append(display)
            if len(self._pending_display) > depth:
                # drain fully so a lowered depth takes effect immediately
                while len(self._pending_display) > depth:
                    display = self._pending_display.pop(0)
            else:
                # warmup: return the OLDEST pending frame so the displayed
                # sequence stays monotonic (0,0,..,1,2,...) instead of
                # showing each warmup frame twice and jumping back
                display = self._pending_display[0]
        self._frame_count += 1
        self._fps_frames += 1
        now = time.perf_counter()
        self._last_frame_time = now
        elapsed = now - self._fps_window_start
        if elapsed > 0.5:  # 500ms window (pathtracerWGL2.js:293-298)
            self.fps = self._fps_frames / elapsed
            self._fps_window_start = now
            self._fps_frames = 0
        self._last_frame = np.asarray(display)
        from ..utils.metrics import frame_record

        frame_record(self, (now - frame_t0) * 1000.0,
                     scheme=self._resolved_scheme())
        return self._last_frame
