#!/usr/bin/env python
"""Benchmark: the BASELINE.md configs in one JSON line, on one GPU.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device",
"detail"}. Lines before it give the card's name and power limit as
nvidia-smi reports them.

Primary metric is the BASELINE.md north star (BASELINE.md:20-22): FPS on
a 1920x1080, 1 spp, full-denoise frame (theater.js config: 9 lights,
temporal + 3-pass filter chain + FXAA). vs_baseline = fps / 60.

detail.configs carries every BASELINE.json config (cornell-256 direct,
emissive-512 direct, obj-720p TAA, dragon-1080p direct AND full
pipeline, theater-1080p full pipeline, bike-1080p direct). Frames are
timed on the host clock around work that ends in block_until_ready,
after a warm-up call. Scenes that load reference assets (theater, obj,
dragon, bike) need them under FLEXLIGHT_ASSETS.

Usage: python bench.py
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "examples"))
sys.path.insert(0, os.path.join(ROOT, "tests"))
sys.path.insert(0, ROOT)

RES = 256
ITERS = 8
E2E_FRAMES = 20
NS_W, NS_H = 1920, 1080


def time_ms(fn, *args, iters=ITERS):
    """Host ms per call of fn(*args), each call ending in
    block_until_ready, after one warm-up (compile) call."""
    import jax

    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        jax.block_until_ready(fn(*args))
    return (time.perf_counter() - t0) / iters * 1000.0


def _load_renderer(scene_name, w, h, config):
    import importlib

    import jax.numpy as jnp

    mod = importlib.import_module(scene_name)
    engine = mod.build_scene()
    if isinstance(engine, tuple):
        engine = engine[0]
    engine.canvas = (w, h)
    engine.config = config
    engine.renderer = "pathtracer"
    renderer = engine.renderer
    renderer.render()
    view = jnp.asarray(engine.camera.view_matrix(w, h))
    pos = jnp.asarray(engine.camera.position)
    return renderer, pos, view


def _result(ms, w, h, scheme, pipeline, **extra):
    return {"ms_per_frame": round(ms, 3), "fps": round(1000.0 / ms, 2),
            "resolution": [w, h], "scheme": scheme, "pipeline": pipeline,
            **extra}


def bench_direct_cfg(scene_name, w, h):
    """1 spp, 5 bounces, no post — the direct-frame cost."""
    import jax
    import jax.numpy as jnp

    from flexlight_tpu import Config
    from flexlight_tpu.ops.pathtrace import render_mrt

    config = Config(samples_per_ray=1, max_reflections=5, temporal=False,
                    filter=False, antialiasing=None)
    renderer, pos, view = _load_renderer(scene_name, w, h, config)
    scheme = renderer._resolved_scheme()

    @jax.jit
    def frame(buffers, pos, view):
        return render_mrt(buffers, w, h, pos, view, config,
                          jnp.float32(0.0), scheme=scheme).color

    ms = time_ms(frame, renderer._buffers, pos, view)
    return _result(ms, w, h, scheme, "direct (1 spp, 5 bounces, no post)")


def bench_pipeline_cfg(scene_name, w, h, antialiasing="fxaa",
                       use_filter=True, temporal=True):
    """Full-pipeline frame: temporal + denoise chain + AA as configured."""
    import jax.numpy as jnp

    from flexlight_tpu import Config
    from flexlight_tpu.models.pathtracer import frame_pipeline
    from flexlight_tpu.post.taa import TAAState
    from flexlight_tpu.post.temporal import TemporalState

    config = Config(temporal=temporal, temporal_samples=4,
                    filter=use_filter, antialiasing=antialiasing,
                    samples_per_ray=1, max_reflections=5)
    renderer, pos, view = _load_renderer(scene_name, w, h, config)
    scheme = renderer._resolved_scheme()
    temporal_st = TemporalState.create(config.temporal_samples, h, w)
    taa = TAAState.create(h, w)

    def frame(buffers, pos, view, temporal_st, taa):
        return frame_pipeline(buffers, pos, view, jnp.float32(0.0),
                              temporal_st, taa, width=w, height=h,
                              config=config, scheme=scheme)[0]

    ms = time_ms(frame, renderer._buffers, pos, view, temporal_st, taa)
    parts = (["temporal"] if temporal else []) \
        + (["filter(3+3+final)"] if use_filter else []) \
        + ([antialiasing] if antialiasing else [])
    return _result(ms, w, h, scheme, "+".join(["direct"] + parts), spp=1,
                   max_reflections=config.max_reflections)


def bench_cornell():
    """cornell 256^2 direct: the device frame, plus the interactive path
    a client sees (render_frame_u8 with a one-frame swapchain)."""
    import jax
    import jax.numpy as jnp

    from flexlight_tpu import Config
    from flexlight_tpu.models.pathtracer import PathTracer
    from flexlight_tpu.ops.pathtrace import render_mrt
    from scenes import cornell_scene

    scene, camera = cornell_scene()
    config = Config(temporal=False, filter=False, antialiasing=None,
                    samples_per_ray=1, max_reflections=5)
    pt = PathTracer(RES, RES, scene, camera, config)
    pt.render()
    scheme = pt._resolved_scheme()
    view = jnp.asarray(camera.view_matrix(RES, RES))
    pos = jnp.asarray(camera.position)

    @jax.jit
    def frame(buffers, pos, view):
        return render_mrt(buffers, RES, RES, pos, view, config,
                          jnp.float32(0.0), scheme=scheme).color

    device_ms = time_ms(frame, pt._buffers, pos, view)
    coverage = float((pt.render_frame().sum(axis=-1) > 0).mean())
    pt.pipelined = 1
    pt.render_frame_u8()  # prime the swapchain
    t0 = time.perf_counter()
    for _ in range(E2E_FRAMES):
        pt.render_frame_u8()
    e2e_ms = (time.perf_counter() - t0) / E2E_FRAMES * 1000.0
    rays = RES * RES * (1 + 2 * config.max_reflections * coverage)
    return _result(device_ms, RES, RES, scheme,
                   "direct (1 spp, 5 bounces, no post)",
                   mrays_per_s=round(rays / device_ms / 1e3, 2),
                   e2e_ms_per_frame=round(e2e_ms, 3), swapchain_depth=1,
                   coverage=round(coverage, 3))


def nvidia_smi():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30)
    return out.stdout.strip()


def main():
    import jax

    from flexlight_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py measures the GPU; the default device is "
                 f"{dev.platform!r}")
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices()), "nvidia_smi": nvidia_smi()}
    print(device["nvidia_smi"], flush=True)

    configs = {"theater_1080p_full": bench_pipeline_cfg("theater", NS_W, NS_H)}
    ns = configs["theater_1080p_full"]
    configs["cornell_256_direct"] = bench_cornell()
    configs["emissive_512_direct"] = bench_direct_cfg("emissive", 512, 512)
    configs["obj_720p_taa"] = bench_pipeline_cfg("obj", 1280, 720, "taa",
                                                 False, False)
    configs["dragon_1080p_direct"] = bench_direct_cfg("dragon", NS_W, NS_H)
    configs["dragon_1080p_full"] = bench_pipeline_cfg("dragon", NS_W, NS_H)
    configs["bike_1080p_direct"] = bench_direct_cfg("bike", NS_W, NS_H)
    print(json.dumps({
        "metric": "theater_1080p_full_pipeline_fps",
        "value": ns["fps"], "unit": "fps",
        "vs_baseline": round(ns["fps"] / 60.0, 4), "device": device,
        "detail": {**ns, "scene": "theater", "configs": configs},
    }))


if __name__ == "__main__":
    main()
