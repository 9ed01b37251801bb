"""The one dispatch rule (ops.schemes), the compile-cache rule
(utils.compile_cache) and the main-path smoke script's CPU rehearsal."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from flexlight_tpu import Config, FlexLight
from flexlight_tpu.ops.schemes import MXU_MAX_TRIS, SCHEMES, resolve_scheme
from tests.scenes import cornell_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REMOVED = ["fused", "fused_split", "kernel", "sparse"]


@pytest.mark.parametrize("n_tris,want", [
    (1, "mxu"), (MXU_MAX_TRIS, "mxu"), (MXU_MAX_TRIS + 1, "clustered"),
    (50_000, "clustered")])
def test_auto_follows_triangle_count(n_tris, want):
    assert resolve_scheme("auto", n_tris) == want
    for scheme in SCHEMES:          # an explicit scheme is kept
        assert resolve_scheme(scheme, n_tris) == scheme


def _engine(renderer, scheme="auto", size=8):
    engine = FlexLight((size, size))
    scene, camera = cornell_scene()
    engine.scene = scene
    engine.camera = camera
    engine.config = Config(temporal=False, filter=False, antialiasing=None,
                           max_reflections=1)
    engine.renderer = renderer
    engine.renderer.scheme = scheme
    return engine


@pytest.mark.parametrize("renderer", ["pathtracer", "rasterizer"])
@pytest.mark.parametrize("backend", ["cpu", "gpu"])
def test_same_choice_on_every_platform(renderer, backend, monkeypatch):
    """The rule reads the scene, never the backend: a renderer that
    believes it runs on a GPU picks what it picks on the CPU."""
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    engine = _engine(renderer)
    frame = engine.renderer.render_frame()
    assert np.isfinite(frame).all()
    assert engine.renderer.metrics.last["scheme"] == "mxu"


@pytest.mark.parametrize("renderer", ["pathtracer", "rasterizer"])
@pytest.mark.parametrize("scheme", REMOVED)
def test_removed_scheme_raises(renderer, scheme):
    engine = _engine(renderer, scheme=scheme)
    with pytest.raises(ValueError, match="scan, packet, mxu, clustered"):
        engine.renderer.render_frame()


def test_render_mrt_rejects_unknown_scheme():
    import jax.numpy as jnp

    from flexlight_tpu.ops.buffers import build_scene_buffers
    from flexlight_tpu.ops.pathtrace import render_mrt

    scene, camera = cornell_scene()
    with pytest.raises(ValueError, match="unknown traversal scheme 'sparse'"):
        render_mrt(build_scene_buffers(scene), 4, 4,
                   jnp.asarray(camera.position),
                   jnp.asarray(camera.view_matrix(4, 4)), Config(), 0.0,
                   scheme="sparse")


def _cache_dir_in_child(env_dir):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    code = ("import jax; from flexlight_tpu.utils.compile_cache import "
            "enable_compile_cache; used = enable_compile_cache(); "
            "print(used); print(jax.config.jax_compilation_cache_dir)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.split()


def test_compile_cache_uses_env_dir(tmp_path):
    used, configured = _cache_dir_in_child(str(tmp_path))
    assert used == configured == str(tmp_path)
    assert not os.listdir(tmp_path)     # nothing set up in code


def test_compile_cache_defaults_to_repo_dir():
    used, configured = _cache_dir_in_child(None)
    assert used == configured == os.path.join(ROOT, ".jax_cache")


def test_chip_smoke_rehearsal_fails_without_gpu(tmp_path):
    """Every phase runs at toy size on the CPU; the run still fails (no
    GPU) and says so on its last line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path), XLA_FLAGS="")
    out = subprocess.run([sys.executable, "chip_smoke.py", "--tiny"],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=1200)
    lines = out.stdout.strip().splitlines()
    assert out.returncode != 0
    last = json.loads(lines[-1])
    assert last == {"ok": False, "device": {"platform": "cpu", "kind": "cpu",
                                            "count": 1}}
    for phase in ("pathtracer", "rasterizer", "clustered", "materials",
                  "reference"):
        assert any(line.startswith(f"[{phase}] ok in") for line in lines), \
            (phase, out.stdout[-3000:], out.stderr[-3000:])
    assert "failed phases: device" in lines
