"""RNG modes (SURVEY §7): the GLSL sin-hash compat default and the
counter-hash quality mode behind Config.rng."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from flexlight_tpu import Config
from flexlight_tpu.ops.intersect import BIAS
from flexlight_tpu.ops.rng import noise4, noise4_counter
from tests.scenes import cornell_config, cornell_scene


def _grid(n=4096, seed=5):
    rng = np.random.default_rng(seed)
    return (jnp.asarray(rng.uniform(-1, 1, n).astype(np.float32)),
            jnp.asarray(rng.uniform(-1, 1, n).astype(np.float32)))


def test_counter_noise_range_and_determinism():
    n0, n1 = _grid()
    a = noise4_counter(n0, n1, BIAS, jnp.float32(0.25))
    b = noise4_counter(n0, n1, BIAS, jnp.float32(0.25))
    for ca, cb in zip(a, b):
        ca, cb = np.asarray(ca), np.asarray(cb)
        np.testing.assert_array_equal(ca, cb)       # pure function
        assert (ca >= -1.0).all() and (ca < 1.0).all()


def test_counter_noise_statistics():
    """Uniform[-1,1) moments + decorrelation — the properties the
    sin-hash lacks at large arguments."""
    n0, n1 = _grid(n=65536)
    ch = [np.asarray(c) for c in noise4_counter(n0, n1, BIAS,
                                                jnp.float32(0.5))]
    for c in ch:
        assert abs(c.mean()) < 0.02                  # E=0 (se ~ 0.0023)
        assert abs(c.std() - 1 / np.sqrt(3)) < 0.01  # std of U[-1,1)
    # channels pairwise decorrelated
    for i in range(4):
        for j in range(i + 1, 4):
            assert abs(np.corrcoef(ch[i], ch[j])[0, 1]) < 0.02
    # seed changes decorrelate
    ch2 = np.asarray(noise4_counter(n0, n1, BIAS, jnp.float32(0.5001))[0])
    assert abs(np.corrcoef(ch[0], ch2)[0, 1]) < 0.02


def test_noise4_mode_dispatch():
    n0, n1 = _grid(n=256)
    h = noise4(n0, n1, BIAS, jnp.float32(0.1))
    c = noise4(n0, n1, BIAS, jnp.float32(0.1), mode="counter")
    cc = noise4_counter(n0, n1, BIAS, jnp.float32(0.1))
    assert not np.allclose(np.asarray(h[0]), np.asarray(c[0]))
    np.testing.assert_array_equal(np.asarray(c[0]), np.asarray(cc[0]))


def test_render_counter_rng_end_to_end():
    """Config(rng='counter') renders a sane, deterministic cornell frame
    that differs from the hash-mode sequence."""
    from flexlight_tpu.ops.buffers import build_scene_buffers
    from flexlight_tpu.ops.pathtrace import render_mrt

    scene, camera = cornell_scene()
    buffers = build_scene_buffers(scene)
    view = jnp.asarray(camera.view_matrix(24, 24))
    pos = jnp.asarray(camera.position)
    base_cfg = cornell_config(max_reflections=3)

    out_h = render_mrt(buffers, 24, 24, pos, view, base_cfg,
                       jnp.float32(0.0))
    cfg = base_cfg.replace(rng="counter") if hasattr(base_cfg, "replace") \
        else __import__("dataclasses").replace(base_cfg, rng="counter")
    out_c = render_mrt(buffers, 24, 24, pos, view, cfg, jnp.float32(0.0))
    out_c2 = render_mrt(buffers, 24, 24, pos, view, cfg, jnp.float32(0.0))

    c = np.stack([np.asarray(x) for x in out_c.color])
    h = np.stack([np.asarray(x) for x in out_h.color])
    assert np.isfinite(c).all() and c.max() > 0.0
    c2 = np.stack([np.asarray(x) for x in out_c2.color])
    np.testing.assert_array_equal(c, c2)             # deterministic
    assert not np.array_equal(c, h)                  # different sequence
    # same geometry/lighting: images agree in the mean (MC noise only)
    assert abs(c.mean() - h.mean()) < 0.15 * max(h.mean(), 1e-6)
