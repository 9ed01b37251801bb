"""Checks that only mean something on the GPU (marker `gpu`; they skip
elsewhere). Run them on a card with:

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from flexlight_tpu import Config, FlexLight
from flexlight_tpu.ops.intersect import BIAS
from tests.scenes import cornell_scene
from tests.test_traverse import _assert_hits_match, _closest, _scene_rays

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("scheme", ["mxu", "clustered"])
@pytest.mark.parametrize("kind", ["primary", "incoherent"])
def test_xla_casts_match_scan_on_gpu(scheme, kind):
    """HIGHEST precision keeps the contraction in fp32 on the card (TF32
    would move hit distances far past the tie tolerance)."""
    buffers, o, d, alive = _scene_rays("wave", kind, n=4096)
    edge = -BIAS if kind == "primary" else BIAS
    ref = _closest("scan", buffers, o, d, edge=edge)
    got = _closest(scheme, buffers, o, d, edge=edge)
    _assert_hits_match(ref, got, alive)


def _frame(size=64):
    engine = FlexLight((size, size))
    scene, camera = cornell_scene()
    engine.scene = scene
    engine.camera = camera
    engine.config = Config(temporal=True, temporal_samples=4, filter=True,
                           antialiasing="fxaa", rng="counter")
    engine.renderer = "pathtracer"
    for _ in range(4):
        img = engine.renderer.render_frame()
    return np.asarray(img)


def test_frame_gpu_matches_cpu():
    """Full pipeline, counter RNG: the backends differ by last-ulp
    transcendentals, absorbed by rgba8 quantization except where a gate
    flips (same bound as chip_smoke.py)."""
    gpu = _frame()
    with jax.default_device(jax.devices("cpu")[0]):
        cpu = _frame()
    beyond = (np.abs(gpu - cpu).max(axis=-1) > 2.0 / 255.0).mean()
    assert beyond <= 0.01, beyond
