"""Shared post-processing helpers.

The reference stores every intermediate pass in RGBA8 textures; gating in
the temporal/denoise passes compares those quantized values for exact
equality (e.g. pathtracerWGL2.js:571-662, pathtracer_first_filter.glsl:112).
`quantize_rgba8` reproduces store-quantization so the gates behave
identically; `gather` reproduces texelFetch's zero result out of bounds.
"""

from __future__ import annotations

import jax.lax
import jax.numpy as jnp

INV_255 = 1.0 / 255.0
INV_256 = 1.0 / 256.0


def quantize_rgba8(v: jnp.ndarray) -> jnp.ndarray:
    """Clamp to [0,1] and snap to 8-bit levels (RGBA8 texture store)."""
    return jnp.round(jnp.clip(v, 0.0, 1.0) * 255.0) * INV_255


def split_hdr(color: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """fract/floor HDR split for RGBA8 storage (glsl:621-623)."""
    frac = color - jnp.floor(color)
    high = jnp.floor(color) * INV_256
    return quantize_rgba8(frac), quantize_rgba8(high)


def gather(img: jnp.ndarray, dy: jnp.ndarray, dx: jnp.ndarray) -> jnp.ndarray:
    """texelFetch at (pixel + offset) with zero out-of-bounds.

    img: [H, W, C]; dy/dx: [H, W, K] int32 offsets -> [H, W, K, C].

    Implemented as a single flattened row-index gather (one index per
    tap instead of a two-axis `img[yy, xx]` gather).
    """
    h, w = img.shape[0], img.shape[1]
    yy = jnp.arange(h, dtype=jnp.int32)[:, None, None] + dy
    xx = jnp.arange(w, dtype=jnp.int32)[None, :, None] + dx
    inb = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
    flat_idx = jnp.clip(yy, 0, h - 1) * w + jnp.clip(xx, 0, w - 1)
    vals = img.reshape(h * w, -1)[flat_idx.reshape(-1)]
    vals = vals.reshape(h, w, dy.shape[-1], img.shape[-1])
    return jnp.where(inb[..., None], vals, 0.0)


def shifted(img: jnp.ndarray, dy: int, dx: int) -> jnp.ndarray:
    """out[y, x] = img[y+dy, x+dx] with zero out-of-bounds — the static
    form of `gather` for compile-time offsets (pad + slice, which XLA
    fuses; no gather at all)."""
    h, w = img.shape[0], img.shape[1]
    py = (max(-dy, 0), max(dy, 0))
    px = (max(-dx, 0), max(dx, 0))
    pad = (py, px) + ((0, 0),) * (img.ndim - 2)
    p = jnp.pad(img, pad)
    start = (py[0] + dy, px[0] + dx) + (0,) * (img.ndim - 2)
    limit = (py[0] + dy + h, px[0] + dx + w) + img.shape[2:]
    return jax.lax.slice(p, start, limit)


def gather_multi(imgs, dy: jnp.ndarray, dx: jnp.ndarray):
    """Gather several same-shape images at the same tap coordinates with a
    single fused row gather (one wide gather instead of one per image).
    Returns a tuple matching `imgs`."""
    h, w = imgs[0].shape[0], imgs[0].shape[1]
    channels = [im.shape[-1] for im in imgs]
    stacked = jnp.concatenate([im.reshape(h, w, -1) for im in imgs], axis=-1)
    vals = gather(stacked, dy, dx)
    out = []
    start = 0
    for im, c in zip(imgs, channels):
        out.append(vals[..., start:start + c])
        start += c
    return tuple(out)


def tileize_blur_key(ocolor: jnp.ndarray, ty: int = 32, tx: int = 128) -> jnp.ndarray:
    """Fast-filter blur-key quantization (``Config.filter_mode="fast"``).

    The reference's denoise blur radius key (originalColor.w) is per-pixel
    NOISY: it accumulates material roughness along the RANDOM path
    (pathtracer_fragment.glsl:558) and stores min(acc, firstRayLength)
    (glsl:635), so rough surfaces carry a full-spread random radius per
    pixel. Fast mode replaces the key with its per-(ty, tx)-tile mean
    over nonzero pixels, so each tile has a single-valued blur scale
    (the property a tiled filter kernel can exploit to skip offsets). Zero keys stay exactly zero
    (they gate the first filter's passthrough, first_filter.glsl:96-98),
    and the mean snaps to rgba8 steps like any texture store. The
    id-equality edge-stopping gates are untouched; only the blur RADIUS
    is rounded to the tile's mean radius.

    ocolor: [H, W, 4] quantized f32 -> same, with channel 3 tileized.
    The (ty, tx) grid anchors at the image origin.
    """
    w = ocolor[..., 3]
    h, wd = w.shape
    hp = -(-h // ty) * ty
    wp = -(-wd // tx) * tx
    wpad = jnp.pad(w, ((0, hp - h), (0, wp - wd)))
    t = wpad.reshape(hp // ty, ty, wp // tx, tx)
    nz = t > 0.0
    s = jnp.sum(jnp.where(nz, t, 0.0), axis=(1, 3))
    c = jnp.sum(nz, axis=(1, 3)).astype(jnp.float32)
    mean = quantize_rgba8(s / jnp.maximum(c, 1.0))
    mean_full = jnp.broadcast_to(
        mean[:, None, :, None], t.shape).reshape(hp, wp)[:h, :wd]
    new_w = jnp.where(w > 0.0, mean_full, 0.0)
    return jnp.concatenate([ocolor[..., 0:3], new_w[..., None]], axis=-1)


def reinhard_gamma(color: jnp.ndarray) -> jnp.ndarray:
    """Reinhard tone map + the reference's gamma curve
    (pathtracer_final_filter.glsl:61-67)."""
    c = color / (color + 1.0)
    return jnp.power(jnp.maximum(4.0 * c, 0.0), 1.0 / 0.8) / 4.0 * 1.3
