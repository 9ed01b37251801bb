"""FXAA parity: post/fxaa.py vs a scalar transcription of the reference
FXAA shader (modules/fxaa.js:7-137 — NVIDIA-paper luma/contrast/edge
detection, 6-step dual-cursor search with 3x3 blur and sub-pixel
aliasing blend). Out-of-frame texelFetch returns zeros on both sides."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

F = np.float32
EDGE_THRESHOLD_MIN = F(1.0 / 32.0)
EDGE_THRESHOLD = F(1.0 / 2.0)
SUBPIX_TRIM = F(0.0)
SUBPIX_TRIM_SCALE = F(1.0)
SUBPIX_CAP = F(7.0 / 8.0)
SEARCH_STEPS = 6


def _mk_fetch(img, px, py):
    h, w = img.shape[:2]

    def fetch(x, y):
        xx, yy = px + x, py + y
        if 0 <= xx < w and 0 <= yy < h:
            return img[yy, xx].astype(np.float32)
        return np.zeros(4, np.float32)

    return fetch


def _luma(rgba):
    return F((rgba[1] * F(0.587 / 0.299) + rgba[0]) * rgba[3])


def fxaa_pixel(img, px, py):
    fetch = _mk_fetch(img, px, py)
    tex_luma = lambda x, y: _luma(fetch(x, y))

    def contrast(x, y):
        c = tex_luma(x, y)
        vals = [c, tex_luma(x, y - 1), tex_luma(x - 1, y),
                tex_luma(x, y + 1), tex_luma(x + 1, y)]
        return F(min(vals)), F(max(vals))

    def is_low_contrast(x, y):
        lo, hi = contrast(x, y)
        return (hi - lo) < max(EDGE_THRESHOLD_MIN, hi * EDGE_THRESHOLD)

    def blur_3x3(x, y):
        acc = np.zeros(4, np.float32)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                acc = acc + fetch(x + dx, y + dy)
        return (F(1.0 / 9.0) * acc).astype(np.float32)

    def sub_pixel_aliasing(x, y):
        luma_l = F(0.25) * (tex_luma(x, y - 1) + tex_luma(x - 1, y)
                            + tex_luma(x + 1, y) + tex_luma(x, y + 1))
        range_l = abs(luma_l - tex_luma(x, y))
        lo, hi = contrast(x, y)
        rng = hi - lo
        blend = max(F(0.0), F(range_l / rng) - SUBPIX_TRIM) * SUBPIX_TRIM_SCALE
        return min(SUBPIX_CAP, F(blend))

    original_color = fetch(0, 0)
    L = {(x, y): tex_luma(x, y) for x in (-1, 0, 1) for y in (-1, 0, 1)}

    edge_vert = (
        abs(F(0.25) * L[-1, -1] + F(-0.5) * L[0, -1] + F(0.25) * L[1, -1])
        + abs(F(0.50) * L[-1, 0] + F(-1.0) * L[0, 0] + F(0.50) * L[1, 0])
        + abs(F(0.25) * L[-1, 1] + F(-0.5) * L[0, 1] + F(0.25) * L[1, 1]))
    edge_horz = (
        abs(F(0.25) * L[-1, -1] + F(-0.5) * L[-1, 0] + F(0.25) * L[-1, 1])
        + abs(F(0.50) * L[0, -1] + F(-1.0) * L[0, 0] + F(0.50) * L[0, 1])
        + abs(F(0.25) * L[1, -1] + F(-0.5) * L[1, 0] + F(0.25) * L[1, 1]))

    step = (1, 0) if edge_horz >= edge_vert else (0, 1)

    if is_low_contrast(0, 0):
        return original_color

    pos_n = (-step[0], -step[1])
    pos_p = step
    color = original_color.copy()
    pixel_count = F(1.0)
    done_n = done_p = False

    luma_mcn = max(abs(L[0, -1] - L[0, 0]), abs(L[1, 0] - L[0, 0]),
                   abs(L[0, 1] - L[0, 0]), abs(L[-1, 0] - L[0, 0]))
    gradient = abs(luma_mcn - L[0, 0])

    for _ in range(SEARCH_STEPS):
        if not done_n:
            blur = blur_3x3(*pos_n)
            done_n = abs(_luma(blur) - luma_mcn) >= gradient
            t = sub_pixel_aliasing(*pos_n)
            color = color + fetch(*pos_n) * (F(1.0) - t) + blur * t
            pixel_count += F(1.0)
            pos_n = (pos_n[0] - step[0], pos_n[1] - step[1])
        elif not done_p:
            blur = blur_3x3(*pos_p)
            done_p = abs(_luma(blur) - luma_mcn) >= gradient
            t = sub_pixel_aliasing(*pos_p)
            color = color + fetch(*pos_p) * (F(1.0) - t) + blur * t
            pixel_count += F(1.0)
            pos_p = (pos_p[0] + step[0], pos_p[1] + step[1])
        else:
            break
    return (color / pixel_count).astype(np.float32)


def _img(h, w, seed, blocky=False):
    """rgba8-quantized frames: block structure (real edges) + noise, or
    flat blocks with specks; alpha varies."""
    rng = np.random.default_rng(seed)
    img = np.round(rng.uniform(0, 1, (h, w, 4)) * 255) / 255.0
    if blocky:
        pool = np.round(rng.uniform(0, 1, (6, 4)) * 255) / 255.0
        blocks = rng.integers(0, 6, (-(-h // 8), -(-w // 8)))
        img = pool[np.repeat(np.repeat(blocks, 8, 0), 8, 1)[:h, :w]].copy()
        speck = rng.uniform(size=(h, w)) < 0.07
        img[speck] = np.round(rng.uniform(0, 1, (speck.sum(), 4)) * 255) / 255.0
    else:
        img[:, : w // 2, 0:3] = np.round(img[:, : w // 2, 0:3] * 0.2 * 255) / 255.0
    img[h // 2:, :, 3] = 1.0
    img[: h // 2, :, 3] = np.round(img[: h // 2, :, 3])
    return img.astype(np.float32)


@pytest.mark.parametrize("shape,seed,blocky", [
    ((16, 20), 31, False),
    ((40, 72), 0, False),
    ((48, 80), 1, True),
    ((33, 47), 7, True),      # odd sizes: the frame border on every side
])
def test_fxaa_matches_oracle(shape, seed, blocky):
    from flexlight_tpu.post.fxaa import fxaa

    h, w = shape
    img = _img(h, w, seed, blocky)
    got = np.asarray(fxaa(img))
    n_diff = 0
    for y in range(h):
        for x in range(w):
            want = fxaa_pixel(img, x, y)
            if not np.allclose(got[y, x], want, atol=2e-5):
                n_diff += 1
    assert n_diff == 0, n_diff
