"""FXAA.

Counterpart of the inline FXAA shader (modules/fxaa.js:7-137),
an NVIDIA-whitepaper port: luma edge detection, 6-step edge search with
per-pixel early-out, sub-pixel blend. The data-dependent search loop is
unrolled with per-pixel masks; all neighborhood terms are precomputed as
shifted images so each unrolled step is a take_along_axis over a
6-deep shift stack.
"""

from __future__ import annotations

import jax.numpy as jnp

EDGE_THRESHOLD_MIN = 1.0 / 32.0
EDGE_THRESHOLD = 1.0 / 2.0
SUBPIX_TRIM = 0.0
SUBPIX_TRIM_SCALE = 1.0
SUBPIX_CAP = 7.0 / 8.0
SEARCH_STEPS = 6


def _shift(img: jnp.ndarray, dy: int, dx: int) -> jnp.ndarray:
    """Zero-padded whole-image shift: out[y, x] = img[y+dy, x+dx]."""
    h, w = img.shape[0], img.shape[1]
    out = jnp.zeros_like(img)
    ys_src = slice(max(dy, 0), h + min(dy, 0))
    xs_src = slice(max(dx, 0), w + min(dx, 0))
    ys_dst = slice(max(-dy, 0), h + min(-dy, 0))
    xs_dst = slice(max(-dx, 0), w + min(-dx, 0))
    return out.at[ys_dst, xs_dst].set(img[ys_src, xs_src])


def _luma(rgba: jnp.ndarray) -> jnp.ndarray:
    """(g * 0.587/0.299 + r) * a (fxaa.js:26-28)."""
    return (rgba[..., 1] * (0.587 / 0.299) + rgba[..., 0]) * rgba[..., 3]


def fxaa(img: jnp.ndarray) -> jnp.ndarray:
    """img: [H, W, 4] -> antialiased [H, W, 4].

    The image is zero-padded by SEARCH_STEPS+2 first so that samples taken
    just outside the frame see blur/luma values computed from zero texels
    (texelFetch OOB semantics) rather than being zeroed wholesale — this is
    what the GLSL does when blur_3x3 runs at an out-of-frame search
    position (fxaa.js:50-56), and it makes the op invariant to the halo
    padding the sharded pipeline applies.
    """
    p = SEARCH_STEPS + 2
    padded = jnp.pad(img, ((p, p), (p, p), (0, 0)))
    return _fxaa_core(padded)[p:-p, p:-p]


def _fxaa_core(img: jnp.ndarray) -> jnp.ndarray:
    luma = _luma(img)

    # 3x3 box blur and its luma (fxaa.js:50-56)
    blur = sum(_shift(img, dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)) / 9.0
    blur_luma = _luma(blur)

    lm = {(dy, dx): _shift(luma, dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)}

    # Contrast range (fxaa.js:36-41) and sub-pixel blend factor (fxaa.js:58-68)
    cross_min = jnp.minimum(jnp.minimum(lm[(-1, 0)], lm[(0, -1)]),
                            jnp.minimum(lm[(1, 0)], lm[(0, 1)]))
    cross_max = jnp.maximum(jnp.maximum(lm[(-1, 0)], lm[(0, -1)]),
                            jnp.maximum(lm[(1, 0)], lm[(0, 1)]))
    range_min = jnp.minimum(luma, cross_min)
    range_max = jnp.maximum(luma, cross_max)
    rng = range_max - range_min
    low_contrast = rng < jnp.maximum(EDGE_THRESHOLD_MIN, range_max * EDGE_THRESHOLD)

    luma_l = 0.25 * (lm[(-1, 0)] + lm[(0, -1)] + lm[(1, 0)] + lm[(0, 1)])
    range_l = jnp.abs(luma_l - luma)
    blend_l = jnp.minimum(SUBPIX_CAP, jnp.maximum(
        0.0, range_l / jnp.maximum(rng, 1e-10) - SUBPIX_TRIM) * SUBPIX_TRIM_SCALE)

    # Edge direction (fxaa.js:82-95). lm[(dy,dx)] = luma at (x+dx, y+dy);
    # the GLSL mat3 is column-major: luma[c][r] = tex_luma(r-1, c-1) =
    # lm[(c-1, r-1)]. edge_vert sums |d2/dx2| per row (vertical edge ->
    # luma varies along x); edge_horz sums |d2/dy2| per column.
    edge_vert = (
        jnp.abs(0.25 * lm[(-1, -1)] - 0.5 * lm[(-1, 0)] + 0.25 * lm[(-1, 1)])
        + jnp.abs(0.50 * lm[(0, -1)] - 1.0 * lm[(0, 0)] + 0.50 * lm[(0, 1)])
        + jnp.abs(0.25 * lm[(1, -1)] - 0.5 * lm[(1, 0)] + 0.25 * lm[(1, 1)]))
    edge_horz = (
        jnp.abs(0.25 * lm[(-1, -1)] - 0.5 * lm[(0, -1)] + 0.25 * lm[(1, -1)])
        + jnp.abs(0.50 * lm[(-1, 0)] - 1.0 * lm[(0, 0)] + 0.50 * lm[(1, 0)])
        + jnp.abs(0.25 * lm[(-1, 1)] - 0.5 * lm[(0, 1)] + 0.25 * lm[(1, 1)]))
    # horizontal span (edge runs along x) -> search steps along x
    horz_span = edge_horz >= edge_vert  # step = (1,0) in x when true

    # Highest-contrast neighbor luma + gradient (fxaa.js:109-115)
    luma_mcn = jnp.maximum(
        jnp.maximum(jnp.abs(lm[(-1, 0)] - luma), jnp.abs(lm[(0, 1)] - luma)),
        jnp.maximum(jnp.abs(lm[(1, 0)] - luma), jnp.abs(lm[(0, -1)] - luma)))
    gradient = jnp.abs(luma_mcn - luma)

    # Precompute the +-k*step shift stacks for both span directions
    def stack(image, sign):
        xs = jnp.stack([_shift(image, 0, sign * k) for k in range(1, SEARCH_STEPS + 1)], axis=2)
        ys = jnp.stack([_shift(image, sign * k, 0) for k in range(1, SEARCH_STEPS + 1)], axis=2)
        sel = horz_span[:, :, None] if image.ndim == 2 else horz_span[:, :, None, None]
        return jnp.where(sel, xs, ys)

    img_n, img_p = stack(img, -1), stack(img, 1)
    blur_n, blur_p = stack(blur, -1), stack(blur, 1)
    blur_luma_n, blur_luma_p = stack(blur_luma, -1), stack(blur_luma, 1)
    blend_n, blend_p = stack(blend_l, -1), stack(blend_l, 1)

    h, w = luma.shape
    color = img
    pixel_count = jnp.ones((h, w), dtype=jnp.float32)
    done_n = jnp.zeros((h, w), dtype=bool)
    done_p = jnp.zeros((h, w), dtype=bool)
    kn = jnp.zeros((h, w), dtype=jnp.int32)
    kp = jnp.zeros((h, w), dtype=jnp.int32)

    def pick(stackv, k):
        # static select-sum over the 6 search steps
        out = jnp.zeros(stackv.shape[:2] + stackv.shape[3:], stackv.dtype)
        for step in range(SEARCH_STEPS):
            sel = (k == step)
            sel = sel[..., None] if stackv.ndim == 4 else sel
            out = jnp.where(sel, stackv[:, :, step], out)
        return out

    for _ in range(SEARCH_STEPS):
        take_n = ~done_n
        take_p = done_n & ~done_p
        # negative direction step (fxaa.js:119-124)
        lb_n = pick(blur_n, kn)
        lbl_n = pick(blur_luma_n, kn)
        fv_n = pick(img_n, kn)
        bl_n = pick(blend_n, kn)
        contrib_n = fv_n + (lb_n - fv_n) * bl_n[..., None]
        done_n = jnp.where(take_n, jnp.abs(lbl_n - luma_mcn) >= gradient, done_n)
        color = jnp.where(take_n[..., None], color + contrib_n, color)
        pixel_count = jnp.where(take_n, pixel_count + 1.0, pixel_count)
        kn = jnp.where(take_n, jnp.minimum(kn + 1, SEARCH_STEPS - 1), kn)
        # positive direction step (fxaa.js:125-130)
        lb_p = pick(blur_p, kp)
        lbl_p = pick(blur_luma_p, kp)
        fv_p = pick(img_p, kp)
        bl_p = pick(blend_p, kp)
        contrib_p = fv_p + (lb_p - fv_p) * bl_p[..., None]
        done_p = jnp.where(take_p, jnp.abs(lbl_p - luma_mcn) >= gradient, done_p)
        color = jnp.where(take_p[..., None], color + contrib_p, color)
        pixel_count = jnp.where(take_p, pixel_count + 1.0, pixel_count)
        kp = jnp.where(take_p, jnp.minimum(kp + 1, SEARCH_STEPS - 1), kp)

    out = color / pixel_count[..., None]
    return jnp.where(low_contrast[..., None], img, out)
