import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from flexlight_tpu.post.common import quantize_rgba8, split_hdr
from flexlight_tpu.post.filters import final_filter, first_filter, second_filter
from flexlight_tpu.post.fxaa import fxaa
from flexlight_tpu.post.taa import FRAMES, Jitter, TAAState, gen_zero_sum_jitter, taa_apply
from flexlight_tpu.post.temporal import TemporalState, push_frame, temporal_average


def test_quantize_rgba8():
    v = jnp.array([0.0, 1.0, 0.5, 2.0, -1.0, 1.0 / 255.0])
    q = np.asarray(quantize_rgba8(v))
    np.testing.assert_allclose(q, [0.0, 1.0, 128 / 255, 1.0, 0.0, 1 / 255], atol=1e-7)


def test_split_hdr_roundtrip():
    c = jnp.array([[[0.25, 1.5, 3.75]]])
    frac, high = split_hdr(c)
    recon = np.asarray(frac + high * 256.0)
    # RGBA8 storage quantizes the floor/256 channel to 1/255 steps; the
    # reconstruction error bound is 256/255/2 ~ 0.5*(1/255)*256 ~ 0.5*0.004*256
    np.testing.assert_allclose(recon[0, 0], [0.25, 1.5, 3.75], atol=0.03)


def test_temporal_average_gates_on_id():
    state = TemporalState.create(3, 2, 2)
    idq = jnp.ones((2, 2, 4)) * 0.5
    oid = jnp.zeros((2, 2, 4))
    c1 = jnp.concatenate([jnp.full((2, 2, 3), 0.2), jnp.ones((2, 2, 1))], axis=-1)
    c2 = jnp.concatenate([jnp.full((2, 2, 3), 0.4), jnp.ones((2, 2, 1))], axis=-1)
    ip = jnp.zeros((2, 2, 4))
    state = push_frame(state, c1, ip, idq, oid)
    state = push_frame(state, c2, ip, idq, oid)
    color, glass, center_w = temporal_average(state)
    # Two matching frames average; third (empty, id=0) excluded
    np.testing.assert_allclose(np.asarray(color[0, 0]), [0.3, 0.3, 0.3], atol=1e-6)
    # Now a frame with different id resets the gate
    id2 = jnp.ones((2, 2, 4)) * 0.7
    c3 = jnp.concatenate([jnp.full((2, 2, 3), 0.9), jnp.ones((2, 2, 1))], axis=-1)
    state = push_frame(state, c3, ip, id2, oid)
    color, _, _ = temporal_average(state)
    np.testing.assert_allclose(np.asarray(color[0, 0]), [0.9, 0.9, 0.9], atol=1e-6)


def test_first_filter_passthrough_when_no_blur_key():
    # NB: a channel of exactly 1.0 would wrap to 0 through the shader's
    # mod(color, 1.0) (first_filter.glsl:121) — faithful reference quirk.
    h = w = 8
    color = jnp.zeros((h, w, 4)).at[:, :, 3].set(1.0).at[4, 4, 0].set(0.9)
    ip = jnp.zeros((h, w, 4))
    # originalColor.w == 0 -> no blur branch (first_filter.glsl:96-98)
    ocolor = jnp.zeros((h, w, 4))
    ids = jnp.zeros((h, w, 4))
    oid = jnp.zeros((h, w, 4))
    out_c, out_ip, out_id = first_filter(color, ip, ocolor, ids, oid)
    np.testing.assert_allclose(np.asarray(out_c[4, 4, 0]), 0.9, atol=1e-2)
    np.testing.assert_allclose(np.asarray(out_c[..., 0:3]), np.asarray(color[..., 0:3]), atol=1e-2)


def test_first_filter_blurs_uniform_region():
    h = w = 16
    rng = np.random.default_rng(0)
    noise = rng.uniform(0.2, 0.4, (h, w, 3)).astype(np.float32)
    color = jnp.concatenate([jnp.asarray(noise), jnp.ones((h, w, 1))], axis=-1)
    ip = jnp.zeros((h, w, 4))
    ocolor = jnp.zeros((h, w, 4)).at[:, :, 3].set(0.2)  # blur key on
    ids = jnp.full((h, w, 4), 0.5)
    oid = jnp.full((h, w, 4), 0.25)
    out_c, _, _ = first_filter(color, ip, ocolor, ids, oid)
    # Uniform ids -> blur averages: variance must drop
    assert np.asarray(out_c[3:-3, 3:-3, 0]).std() < noise[3:-3, 3:-3, 0].std() * 0.6


def test_second_and_final_filter_smoke():
    h = w = 12
    color = jnp.concatenate([jnp.full((h, w, 3), 0.5), jnp.ones((h, w, 1))], axis=-1)
    ip = jnp.zeros((h, w, 4))
    ocolor = jnp.concatenate([jnp.full((h, w, 3), 0.8), jnp.full((h, w, 1), 0.1)], axis=-1)
    ids = jnp.full((h, w, 4), 0.5)
    oid = jnp.zeros((h, w, 4)).at[:, :, 3].set(0.05)
    c, p, oc = second_filter(color, ip, ocolor, ids, oid)
    assert np.isfinite(np.asarray(c)).all()
    out = final_filter(c, p, oc, ids, oid, hdr=True)
    assert np.isfinite(np.asarray(out)).all()
    # Uniform input -> roughly uniform tone-mapped output, scaled by oColor
    assert 0.05 < float(out[6, 6, 0]) < 1.0


@pytest.mark.slow
def test_fxaa_flat_image_unchanged():
    # Interior only: texelFetch out of bounds returns 0 (both here and in
    # WebGL2), so border pixels see artificial contrast — reference-faithful.
    img = jnp.full((16, 16, 4), 0.5)
    out = np.asarray(fxaa(img))
    np.testing.assert_allclose(out[2:-2, 2:-2], 0.5, atol=1e-5)


@pytest.mark.slow
def test_fxaa_softens_edge():
    img = jnp.zeros((16, 16, 4)).at[:, 8:, :].set(1.0).at[:, :, 3].set(1.0)
    out = np.asarray(fxaa(img))
    assert np.isfinite(out).all()
    # Edge column should be blended (neither 0 nor 1 everywhere)
    edge = out[8, 7:9, 0]
    assert 0.0 < edge.mean() < 1.0


def test_taa_history_average():
    state = TAAState.create(8, 8)
    frame = jnp.full((8, 8, 4), 0.9)
    out, state = taa_apply(state, frame)
    # First frame: history zeros clamp to min of 3x3 = 0.9 ... min_rgb<=history
    assert np.isfinite(np.asarray(out)).all()
    for _ in range(FRAMES):
        out, state = taa_apply(state, frame)
    np.testing.assert_allclose(np.asarray(out), 0.9, atol=1e-5)


def test_zero_sum_jitter():
    vecs = gen_zero_sum_jitter()
    np.testing.assert_allclose(vecs.sum(axis=0), [0, 0], atol=1e-9)
    j = Jitter()
    dx, dy = j.next(512, 512)
    assert abs(dx) <= 0.3 / 512 + 1e-9 and abs(dy) <= 0.3 / 512 + 1e-9


def _filter_inputs(rng, h, w):
    """Random rgba8-quantized pass inputs with coherent id planes (so the
    edge-stopping gates pass often enough to blur) and sparse glass."""
    def q(shape):
        return np.round(rng.random(shape) * 255.0).astype(np.float32) / 255.0

    color, ip, ocolor = q((h, w, 4)), q((h, w, 4)), q((h, w, 4))
    ids = np.asarray(quantize_rgba8(jnp.round(jnp.asarray(q((h, w, 4))) * 3.0) / 3.0))
    oid = np.zeros((h, w, 4), np.float32)
    oid[..., 3] = np.where(rng.random((h, w)) > 0.8, q((h, w)), 0.0)
    ocolor[..., 3] = np.where(rng.random((h, w)) > 0.2, ocolor[..., 3], 0.0)
    return color, ip, ocolor, ids, oid


@pytest.mark.parametrize("mode", ["compat", "fast"])
@pytest.mark.parametrize("which", ["first", "second", "final"])
def test_filter_pass_matches_scalar_oracle(which, mode):
    """Each gather pass against the per-pixel transcription in
    tests/reference_oracle.py; fast mode feeds both the tile-mean key.
    Sums run in another order, so a value on an rgba8 step may land one
    step away: at most 1.5/255 anywhere, on at most 2% of the values."""
    from tests import reference_oracle as oracle

    rng = np.random.default_rng({"first": 1, "second": 2, "final": 3}[which])
    imgs = _filter_inputs(rng, 36, 136)   # partial tiles on both axes
    if mode == "fast":
        from flexlight_tpu.post.common import tileize_blur_key

        color, ip, ocolor, ids, oid = imgs
        key = oracle.tileize_blur_key(ocolor)
        np.testing.assert_array_equal(
            np.asarray(tileize_blur_key(jnp.asarray(ocolor))), key)
        imgs = (color, ip, key, ids, oid)
    if which == "final":
        want = (oracle.filter_image(oracle.final_filter_pixel, *imgs),)
        got = (final_filter(*map(jnp.asarray, imgs), hdr=True),)
    else:
        fn = first_filter if which == "first" else second_filter
        pixel = (oracle.first_filter_pixel if which == "first"
                 else oracle.second_filter_pixel)
        want = oracle.filter_image(pixel, *imgs)
        got = fn(*map(jnp.asarray, imgs))
    for k, (a, b) in enumerate(zip(want, got)):
        d = np.abs(np.asarray(a) - np.asarray(b))
        assert float(d.max()) <= 1.5 / 255.0, (k, d.max())
        assert float((d > 1e-4).mean()) <= 0.02, (k, (d > 1e-4).mean())


def test_offset_table_covers_all_taps():
    """Every (tap, scale) combination maps to exactly one table offset
    whose tap list contains it — checked densely over each filter's scale
    range; max_radius is what the sharded pipeline's halo reads."""
    from flexlight_tpu.post.filters import (FINAL_BOUNDS, FIRST_BOUNDS,
                                            SECOND_BOUNDS, STENCIL3,
                                            STENCIL3_NO_CENTER, offset_table)

    for key, (lo, hi) in [("disc37", FIRST_BOUNDS),
                          ("disc36", SECOND_BOUNDS),
                          ("disc37", FINAL_BOUNDS)]:
        entries, max_r, _ = offset_table(key, lo, hi)
        table = {}
        for oy, ox, _, _, taps in entries:
            for sy, sx, tlo, thi in taps:
                table.setdefault((oy, ox), set()).add((sy, sx))
        stencil = STENCIL3 if key == "disc37" else STENCIL3_NO_CENTER
        reach = 0
        for s in np.linspace(lo, hi, 997, dtype=np.float32):
            for sy, sx in stencil.astype(np.float32):
                o = (int(np.trunc(sy * s)), int(np.trunc(sx * s)))
                assert (int(sy), int(sx)) in table.get(o, set()), (key, s, o)
                reach = max(reach, abs(o[0]), abs(o[1]))
        assert max_r == reach, (key, max_r, reach)
