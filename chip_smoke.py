#!/usr/bin/env python
"""Main-path smoke run of the renderer on one GPU.

Every phase goes through the entry points a user calls (FlexLight ->
engine.renderer -> render_frame) and checks what comes out:

  1 device      jax.devices()[0].platform must be "gpu"
  2 pathtracer  cornell 1920x1080: temporal (4) + 3+3+final denoise (fast)
                + FXAA, 8 frames; one more frame with filter_mode="compat"
  3 rasterizer  cornell 1920x1080 + FXAA (the engine's default renderer)
  4 clustered   wave scene, 32x32 pillars (12,290 tris, above
                MXU_MAX_TRIS) 1920x1080 direct, 3 animated frames; then the
                mxu/clustered cast times at about 2k, 8k and 32k tris
  5 materials   emissive (emission, refraction, Fresnel) and example2
                (64 lights: the reservoir lax.scan) at 512x512
  6 reference   mxu and clustered casts against the scan oracle on the
                card; one full frame on the GPU against the CPU

Each phase prints its compile seconds, ms/frame (block_until_ready after
warm-up; informative, not a claim), the frame step's
compiled.memory_analysis() and peak_bytes_in_use. The last stdout line is
one JSON object {"ok": ..., "device": {"platform", "kind", "count"}}; the
exit code is 0 only when every phase passed on a GPU. A failed phase is
reported and the run goes on, so one run shows every failure.

Usage:
  python chip_smoke.py          one card, every phase
  python chip_smoke.py --multi  four cards: frame_pipeline_sharded on a
                                2x2 (tile x sample) mesh and
                                frame_pipeline_sharded_halo on 4 tiles,
                                each against the one-card frame
  python chip_smoke.py --tiny   the same phases at toy sizes, for a CPU
                                rehearsal (which exits 1 with "ok": false)

Without a GPU and without --tiny the run stops after the device phase.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "examples"))
sys.path.insert(0, os.path.join(ROOT, "tests"))

# The GPU-vs-CPU phase needs the CPU backend beside the GPU one.
_platforms = os.environ.get("JAX_PLATFORMS", "")
if _platforms and "cpu" not in _platforms.split(","):
    os.environ["JAX_PLATFORMS"] = _platforms + ",cpu"

import numpy as np  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from flexlight_tpu import Config, FlexLight  # noqa: E402
from flexlight_tpu.models.pathtracer import frame_pipeline  # noqa: E402
from flexlight_tpu.models.rasterizer import raster_frame  # noqa: E402
from flexlight_tpu.ops.geometry import world_geometry  # noqa: E402
from flexlight_tpu.ops.intersect import BIAS  # noqa: E402
from flexlight_tpu.ops.pathtrace import camera_rays  # noqa: E402
from flexlight_tpu.ops.schemes import resolve_scheme  # noqa: E402
from flexlight_tpu.ops.traverse import traverse_scan  # noqa: E402
from flexlight_tpu.ops.traverse_clustered import (  # noqa: E402
    build_clusters, traverse_clustered)
from flexlight_tpu.ops.traverse_mxu import (  # noqa: E402
    block_size, build_tri_matrix, traverse_mxu)
from flexlight_tpu.scene.transform import reset_global_registry  # noqa: E402
from flexlight_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402
from scenes import cornell_scene  # noqa: E402

# Traversal against the scan oracle (precision HIGHEST: true fp32, no
# TF32). A ray agrees when it hits the same triangle, or another one at
# the same distance: coplanar overlapping faces (cornell's cube bottoms
# on the floor) tie, and each formulation keeps a different first.
# Distances are compared as |ds| / max(s, 1): the all-pairs contraction
# forms s*det = o.n - v0.n, whose cancellation costs ~ulp(|v0| |n|) / det
# in absolute terms; on wave's 200-unit ground plane that is ~1e-4 for
# short bounce rays (measured on the CPU as well), while TF32 products
# would be off by far more.
AGREE_MIN = 0.999
S_ERR_MAX = 1e-3
# GPU against CPU, one full frame with the counter RNG: transcendental
# functions and fused multiply-adds differ in the last ulp between the
# backends; rgba8 quantization between passes absorbs most of it, and
# only a flipped filter gate or Fresnel decision moves a pixel further.
GPU_CPU_BEYOND_2_255_MAX = 0.01
GPU_CPU_MEAN_ABS_MAX = 1.0 / 255.0
COVERAGE_MIN = 0.95

# cross_sides: wave pillar grids of 110, 434, 974, 2030, 8114, 32450 tris
FULL = dict(w=1920, h=1080, small=512, gpu_cpu=256, wave_side=32,
            frames=8, wave_frames=3, cross_res=(960, 540),
            cross_sides=(3, 6, 9, 13, 26, 52), cmp_wave=512, timed=5,
            cross_timed=3)
TINY = dict(w=32, h=18, small=16, gpu_cpu=16, wave_side=32,
            frames=4, wave_frames=2, cross_res=(16, 16),
            cross_sides=(3, 5), cmp_wave=16, timed=1, cross_timed=1)


def log(*parts):
    print(*parts, flush=True)


def _fmt(x):
    return f"{x:.3f}" if isinstance(x, float) else str(x)


def report(phase, **kv):
    log(f"[{phase}] " + " ".join(f"{k}={_fmt(v)}" for k, v in kv.items()))


def peak_bytes():
    stats = jax.devices()[0].memory_stats()
    return None if not stats else stats.get("peak_bytes_in_use")


def memory_summary(compiled):
    m = compiled.memory_analysis()
    if m is None:
        return "n/a"
    return (f"args={m.argument_size_in_bytes} out={m.output_size_in_bytes} "
            f"temp={m.temp_size_in_bytes} code={m.generated_code_size_in_bytes}")


def check_image(img, h, w, what):
    img = np.asarray(img)
    assert img.shape == (h, w, 3), f"{what}: shape {img.shape}"
    assert np.isfinite(img).all(), f"{what}: non-finite pixels"
    assert img.max() > 0.0, f"{what}: all-black frame"
    return float((img.max(axis=-1) > 0.0).mean())


def time_step(compiled, args, n):
    """ms per call of a compiled step, after one warm-up call."""
    jax.block_until_ready(compiled(*args))
    t0 = time.perf_counter()
    for _ in range(n):
        jax.block_until_ready(compiled(*args))
    return (time.perf_counter() - t0) / n * 1000.0


def pathtracer_step(r):
    """The jitted frame step render_frame runs, with its arguments."""
    view = jnp.asarray(r.camera.view_matrix(r.width, r.height))
    args = (r._buffers, jnp.asarray(r.camera.position), view,
            jnp.float32(0.0), r._temporal_state, r._taa_state)
    static = dict(width=r.width, height=r.height, config=r.config,
                  scheme=r._resolved_scheme(), tile=r.tile)
    return frame_pipeline, args, static


def rasterizer_step(r):
    view = jnp.asarray(r.camera.view_matrix(r.width, r.height))
    layers = max(int(r.layers), 1) if r._has_translucency else 1
    args = (r._buffers, jnp.asarray(r.camera.position), view, r._taa_state)
    static = dict(width=r.width, height=r.height, config=r.config,
                  scheme=resolve_scheme(r.scheme,
                                        r._buffers.id_buffer.shape[0]),
                  tile=r.tile, layers=layers)
    return raster_frame, args, static


def run_renderer(phase, engine, step_fn, frames, timed, animate=None):
    """Compile the frame step ahead of time (compile seconds + memory),
    then render `frames` frames through engine.renderer.render_frame."""
    r = engine.renderer
    r.render()
    fn, args, static = step_fn(r)
    t0 = time.perf_counter()
    compiled = fn.lower(*args, **static).compile()
    compile_s = time.perf_counter() - t0
    h, w = r.height, r.width
    coverage = 0.0
    t_first = None
    t0 = time.perf_counter()
    for t in range(frames):
        if animate is not None:
            animate(t)
            r.update_primary_light_sources()
        img = r.render_frame()
        if t_first is None:
            t_first = time.perf_counter() - t0
        coverage = check_image(img, h, w, f"{phase} frame {t}")
    step_ms = time_step(compiled, args, timed)
    report(phase, size=f"{w}x{h}", scheme=static["scheme"],
           compile_s=compile_s, first_frame_s=t_first,
           ms_per_frame=step_ms, coverage=coverage,
           peak_bytes_in_use=peak_bytes())
    report(phase, memory_analysis=memory_summary(compiled))
    return img, coverage


def cornell_engine(w, h, config, renderer):
    reset_global_registry()
    engine = FlexLight((w, h))
    scene, camera = cornell_scene()
    engine.scene = scene
    engine.camera = camera
    engine.config = config
    engine.renderer = renderer
    return engine


def full_config(**kw):
    base = dict(temporal=True, temporal_samples=4, filter=True,
                filter_mode="fast", antialiasing="fxaa")
    base.update(kw)
    return Config(**base)


def phase_pathtracer(sz):
    engine = cornell_engine(sz["w"], sz["h"], full_config(), "pathtracer")
    _, coverage = run_renderer("pathtracer", engine, pathtracer_step,
                               sz["frames"], sz["timed"])
    assert coverage >= COVERAGE_MIN, f"pathtracer coverage {coverage}"
    engine = cornell_engine(sz["w"], sz["h"],
                            full_config(filter_mode="compat"), "pathtracer")
    run_renderer("pathtracer-compat", engine, pathtracer_step, 1,
                 sz["timed"])


def phase_rasterizer(sz):
    engine = cornell_engine(sz["w"], sz["h"], Config(antialiasing="fxaa"),
                            "rasterizer")
    _, coverage = run_renderer("rasterizer", engine, rasterizer_step,
                               sz["frames"], sz["timed"])
    assert coverage >= COVERAGE_MIN, f"rasterizer coverage {coverage}"


def wave_engine(side, w, h, config):
    import wave

    reset_global_registry()
    engine, animate = wave.build_scene(side_length=side)
    engine.canvas = (w, h)
    engine.config = config
    return engine, animate


DIRECT = dict(temporal=False, filter=False, antialiasing=None)


def incoherent_rays(origin, direction, hit, seed):
    """One bounce wavefront: rays leaving the primary hit points in
    random directions (misses restart at the camera)."""
    s = hit.suv[:, 0:1]
    o = jnp.where(hit.triangle[:, None] >= 0, origin + direction * s * 0.999,
                  origin)
    d = jax.random.normal(jax.random.PRNGKey(seed), origin.shape)
    return o, d / jnp.linalg.norm(d, axis=-1, keepdims=True)


def primary_rays(engine, w, h):
    cam = engine.camera
    o, d, _ = camera_rays(w, h, jnp.asarray(cam.position),
                          jnp.asarray(cam.view_matrix(w, h)))
    return o, d


def scene_casts(buffers, edge=BIAS):
    """Closest-hit casts of the three XLA schemes on one scene. Primary
    rays take edge=-BIAS, the relaxed window render_mrt gives them. The
    scene arrays are arguments, not constants baked into the program."""
    wg = world_geometry(buffers)
    ids = buffers.id_buffer
    scan = jax.jit(lambda g, o, d: traverse_scan(g, o, d, edge=edge))
    mxu = jax.jit(lambda w, i, o, d: traverse_mxu(w, i, o, d, edge=edge))
    clustered = jax.jit(
        lambda c, o, d: traverse_clustered(c, o, d, edge=edge))
    w = build_tri_matrix(wg, ids)
    clusters = build_clusters(wg, ids)
    return {
        "scan": lambda o, d: scan(wg, o, d),
        "mxu": lambda o, d: mxu(w, ids, o, d),
        "clustered": lambda o, d: clustered(clusters, o, d),
    }


def phase_clustered(sz):
    engine, animate = wave_engine(sz["wave_side"], sz["w"], sz["h"],
                                  Config(**DIRECT))
    run_renderer("clustered", engine, pathtracer_step, sz["wave_frames"],
                 sz["timed"], animate=animate)
    r = engine.renderer
    assert r._resolved_scheme() == "clustered", r._resolved_scheme()
    crossover(sz)


def mxu_temp_bytes(buffers, o, d):
    """Device scratch of one compiled mxu cast: the check that
    traverse_mxu.block_size keeps a ray block within BLOCK_BYTES."""
    w = build_tri_matrix(world_geometry(buffers), buffers.id_buffer)
    m = jax.jit(traverse_mxu).lower(w, buffers.id_buffer, o, d) \
        .compile().memory_analysis()
    return None if m is None else m.temp_size_in_bytes


def crossover(sz):
    """mxu and clustered cast times on wave scenes of growing size: the
    measurement MXU_MAX_TRIS is set from."""
    cw, ch = sz["cross_res"]
    for side in sz["cross_sides"]:
        engine, _ = wave_engine(side, cw, ch, Config(**DIRECT))
        engine.renderer.render()
        buffers = engine.renderer._buffers
        casts = scene_casts(buffers)
        o, d = primary_rays(engine, cw, ch)
        hit = casts["scan"](o, d)
        bo, bd = incoherent_rays(o, d, hit, seed=side)
        row = {"tris": int(buffers.id_buffer.shape[0]), "rays": cw * ch,
               "mxu_block": block_size(buffers.id_buffer.shape[0]),
               "mxu_temp_bytes": mxu_temp_bytes(buffers, o, d)}
        for scheme in ("mxu", "clustered"):
            fn = casts[scheme]
            for name, (oo, dd) in (("primary", (o, d)), ("bounce", (bo, bd))):
                jax.block_until_ready(fn(oo, dd))
                t0 = time.perf_counter()
                for _ in range(sz["cross_timed"]):
                    jax.block_until_ready(fn(oo, dd))
                row[f"{scheme}_{name}_ms"] = \
                    (time.perf_counter() - t0) / sz["cross_timed"] * 1000.0
        report("crossover", **row)


def phase_materials(sz):
    import emissive
    import example2

    n = sz["small"]
    for name, mod in (("emissive", emissive), ("example2", example2)):
        reset_global_registry()
        engine = mod.build_scene()
        if isinstance(engine, tuple):
            engine = engine[0]
        engine.canvas = (n, n)
        run_renderer(name, engine, pathtracer_step, 2, sz["timed"])


def compare_casts(label, casts, o, d):
    ref = casts["scan"](o, d)
    ref_tri = np.asarray(ref.triangle)
    ref_s = np.asarray(ref.suv)[:, 0]
    ok = True
    for scheme in ("mxu", "clustered"):
        got = casts[scheme](o, d)
        tri = np.asarray(got.triangle)
        err = np.abs(np.asarray(got.suv)[:, 0] - ref_s) / np.maximum(ref_s, 1.0)
        same = tri == ref_tri
        tie = ~same & (tri >= 0) & (ref_tri >= 0) & (err <= S_ERR_MAX)
        agree = float((same | tie).mean())
        hit = same & (ref_tri >= 0)
        err_max = float(err[hit].max()) if hit.any() else 0.0
        report("reference", case=label, scheme=scheme, rays=tri.size,
               index_agreement=f"{same.mean():.6f}",
               agreement=f"{agree:.6f}", ties=int(tie.sum()),
               s_err_max=f"{err_max:.3g}")
        ok &= agree >= AGREE_MIN and err_max <= S_ERR_MAX
    return ok


def gpu_cpu_frame(n):
    """The last of 4 temporal frames rendered through the engine."""
    engine = cornell_engine(n, n, full_config(rng="counter"), "pathtracer")
    r = engine.renderer
    r.render()
    for _ in range(4):
        img = r.render_frame()
    return np.asarray(img)


def compare_scene(label, engine, w, h, seed):
    """Primary rays, then one incoherent bounce wavefront from their
    hits, each cast by mxu and clustered against scan."""
    engine.renderer.render()
    buffers = engine.renderer._buffers
    o, d = primary_rays(engine, w, h)
    primary = scene_casts(buffers, edge=-BIAS)
    ok = compare_casts(f"{label} primary", primary, o, d)
    bo, bd = incoherent_rays(o, d, primary["scan"](o, d), seed=seed)
    return ok & compare_casts(f"{label} bounce", scene_casts(buffers), bo, bd)


def phase_reference(sz):
    ok = compare_scene("cornell", cornell_engine(
        sz["w"], sz["h"], Config(**DIRECT), "pathtracer"),
        sz["w"], sz["h"], seed=1)
    n = sz["cmp_wave"]
    engine, _ = wave_engine(sz["wave_side"], n, n, Config(**DIRECT))
    ok &= compare_scene("wave", engine, n, n, seed=2)

    m = sz["gpu_cpu"]
    gpu = gpu_cpu_frame(m)
    with jax.default_device(jax.devices("cpu")[0]):
        cpu = gpu_cpu_frame(m)
    diff = np.abs(gpu - cpu)
    mean_abs = float(diff.mean())
    beyond = float((diff.max(axis=-1) > 2.0 / 255.0).mean())
    report("reference", case=f"gpu vs cpu frame {m}x{m}",
           mean_abs_diff=f"{mean_abs:.3g}",
           share_beyond_2_255=f"{beyond:.3g}")
    ok &= (beyond <= GPU_CPU_BEYOND_2_255_MAX
           and mean_abs <= GPU_CPU_MEAN_ABS_MAX)
    assert ok, "a comparison with the plain reference is outside its bound"


def phase_multi(sz):
    from __graft_entry__ import check_sharded_frame
    from flexlight_tpu.ops.buffers import build_scene_buffers
    from flexlight_tpu.parallel.tile_sharding import (
        frame_pipeline_sharded, frame_pipeline_sharded_halo, make_mesh,
        required_post_halo)
    from flexlight_tpu.post.taa import TAAState
    from flexlight_tpu.post.temporal import TemporalState

    assert len(jax.devices()) >= 4, f"need 4 devices, have {jax.devices()}"
    w, h = sz["w"], sz["h"]
    config = full_config(samples_per_ray=2)
    reset_global_registry()
    scene, camera = cornell_scene()
    buffers = build_scene_buffers(scene)
    pos = jnp.asarray(camera.position)
    view = jnp.asarray(camera.view_matrix(w, h))
    scheme = resolve_scheme("auto", buffers.id_buffer.shape[0])

    def states():
        return (TemporalState.create(config.temporal_samples, h, w),
                TAAState.create(h, w))

    t0 = time.perf_counter()
    ref, _, _ = frame_pipeline(buffers, pos, view, jnp.float32(0.0),
                               *states(), width=w, height=h, config=config,
                               scheme=scheme)
    ref = np.asarray(ref)
    report("multi", case="one card", size=f"{w}x{h}",
           first_frame_s=time.perf_counter() - t0)
    check_image(ref, h, w, "one-card frame")
    assert h // 4 > required_post_halo(config), "strips too short for halo"
    for name, fn, mesh in (
            ("frame_pipeline_sharded 2x2", frame_pipeline_sharded,
             make_mesh(2, 2)),
            ("frame_pipeline_sharded_halo 4", frame_pipeline_sharded_halo,
             make_mesh(4, 1))):
        t0 = time.perf_counter()
        out, _, _ = fn(buffers, pos, view, jnp.float32(0.0), *states(),
                       width=w, height=h, config=config, mesh=mesh,
                       scheme=scheme)
        jax.block_until_ready(out)
        first = time.perf_counter() - t0
        held = sorted(str(s.device) for s in out.addressable_shards)
        assert len(set(held)) == 4, f"{name}: output only on {held}"
        sub = check_sharded_frame(out, ref, name)
        check_image(out, h, w, name)
        report("multi", case=name, first_frame_s=first,
               max_abs_diff=float(np.abs(np.asarray(out) - ref).max()),
               share_sub_step_diff=sub, devices=len(set(held)))


def nvidia_smi():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        lines = out.stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        lines = []
    return lines or ["nvidia-smi: unavailable"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="four cards: the sharded pipelines only")
    ap.add_argument("--tiny", action="store_true",
                    help="toy sizes, for a CPU rehearsal")
    args = ap.parse_args(argv)
    sz = TINY if args.tiny else FULL
    if args.tiny and args.multi:
        sz = dict(sz, w=64, h=192)   # 48-row strips: the halo path runs

    cache = enable_compile_cache()
    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    log(f"jax {jax.__version__}  XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}"
        f"  compile cache {cache}")
    log(f"device_kind={dev.device_kind} platform={dev.platform} "
        f"count={device['count']}")
    for line in nvidia_smi():
        log(line)

    on_gpu = dev.platform == "gpu"
    failed = []
    if not on_gpu:
        failed.append("device")
        log(f"[device] FAILED: platform is {dev.platform!r}, not 'gpu'")
    phases = ([("multi", phase_multi)] if args.multi else
              [("pathtracer", phase_pathtracer),
               ("rasterizer", phase_rasterizer),
               ("clustered", phase_clustered),
               ("materials", phase_materials),
               ("reference", phase_reference)])
    if on_gpu or args.tiny:
        for name, fn in phases:
            t0 = time.perf_counter()
            try:
                fn(sz)
                log(f"[{name}] ok in {time.perf_counter() - t0:.1f} s")
            except Exception:  # report every phase, then fail the run
                failed.append(name)
                traceback.print_exc()
                log(f"[{name}] FAILED after {time.perf_counter() - t0:.1f} s")
    if failed:
        log(f"failed phases: {', '.join(failed)}")
    print(json.dumps({"ok": not failed, "device": device}), flush=True)
    return 0 if not failed else 1


if __name__ == "__main__":
    sys.exit(main())
