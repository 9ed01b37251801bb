"""Device scene buffers.

The flattened scene as a pytree of jnp arrays — the single input contract
between the host scene layer and every kernel. Mirrors the reference's
GPU-texture data contracts (SURVEY §2.3):

- geometry [S, 12]  — geometryTex, 3 RGBA32F texels/slot (scene.js:294-298)
- attributes [S, 28] — sceneTex, 7 texels/slot (scene.js:636-641)
- rotations [M, 2, 3, 3] / shifts [M, 2, 3] — transform UBO, even=forward,
  odd=pseudo-inverse (scene.js:500-521)
- lights [L, 2, 3] — lightTex, 2 texels/light (pathtracerWGL2.js:154-165)
- 3 texture atlases, 2048px-wide tile rows (pathtracerWGL2.js:85-104)
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

ATLAS_WIDTH_PX = 2048  # pathtracerWGL2.js:93

# Texel tables at or below this row count are fetched with an exact one-hot
# contraction instead of an XLA gather. The threshold was tuned for an
# earlier accelerator and is not measured on the H100 (see ROADMAP.md).
ONE_HOT_TEXELS = 64
ONE_HOT_SLOTS = 64


class AtlasTable(NamedTuple):
    """Compact texel table for the hot wavefront fetch.

    The standard-tile atlas (`build_atlas`) pads every texture to
    `standardTextureSizes` inside a `height*n x 2048` canvas, so a scene
    whose textures are 1x1 constants still gathers from a multi-megarow
    table. This stores each tile at `min(native, standard)` resolution in
    one flat texel list plus a per-slot (offset, stored_w, stored_h)
    directory, and reproduces the padded atlas's values exactly: the
    virtual-atlas coordinate math of `fetch_tex_val` (glsl:108-117) runs
    unchanged, then the standard-tile pixel is mapped to the stored tile
    with the same nearest-index arithmetic `build_atlas` resamples with.

    texels: [K, 3] f32, or uint8 when `round(v*255)/255` reconstructs the
        float data bit-exactly (true for image-sourced textures, which the
        reference stores as Uint8ClampedArray — scene.js:22-39).
    tile_info: [S, 3] i32 — (flat texel offset, stored w, stored h) per
        virtual tile slot; slots past the texture count point at a zero
        texel, matching the padded atlas's zero fill.
    meta: [5] i32 — (std_w, std_h, tiles_per_row, virt_h, virt_w).
    """
    texels: jnp.ndarray
    tile_info: jnp.ndarray
    meta: jnp.ndarray


class SceneBuffers(NamedTuple):
    geometry: jnp.ndarray       # [S, 12] f32
    attributes: jnp.ndarray     # [S, 28] f32
    id_buffer: jnp.ndarray      # [T] int32 — triangle slot per drawable tri
    rotations: jnp.ndarray      # [M, 2, 3, 3] f32
    shifts: jnp.ndarray         # [M, 2, 3] f32
    lights: jnp.ndarray         # [L, 2, 3] f32
    ambient: jnp.ndarray        # [3] f32
    albedo_atlas: jnp.ndarray   # [Ha, Wa, 3] f32
    pbr_atlas: jnp.ndarray      # [Hp, Wp, 3] f32
    tpo_atlas: jnp.ndarray      # [Ht, Wt, 3] f32
    texture_width: jnp.ndarray  # [] f32 — tiles per atlas row
    albedo_tab: AtlasTable | None = None
    pbr_tab: AtlasTable | None = None
    tpo_tab: AtlasTable | None = None


def build_atlas(textures, standard_size) -> np.ndarray:
    """Pack textures into 2048px-wide rows of standard-size tiles
    (pathtracerWGL2.js:85-104). Returns [H, W, 3] float32."""
    if not textures:
        return np.zeros((1, 1, 3), dtype=np.float32)
    width, height = int(standard_size[0]), int(standard_size[1])
    tiles_per_row = max(ATLAS_WIDTH_PX // width, 1)
    n = len(textures)
    atlas = np.zeros((height * n, width * tiles_per_row, 3), dtype=np.float32)
    for i, tex in enumerate(textures):
        row, col = i // tiles_per_row, i % tiles_per_row
        data = tex.data
        # Resample to the standard tile size with nearest sampling if needed
        if data.shape[0] != height or data.shape[1] != width:
            ys = (np.arange(height) * data.shape[0] // height).clip(0, data.shape[0] - 1)
            xs = (np.arange(width) * data.shape[1] // width).clip(0, data.shape[1] - 1)
            data = data[ys][:, xs]
        atlas[row * height:(row + 1) * height, col * width:(col + 1) * width] = data
    return atlas


def build_atlas_table(textures, standard_size) -> AtlasTable:
    """Compact-table counterpart of `build_atlas` (see AtlasTable)."""
    std_w, std_h = int(standard_size[0]), int(standard_size[1])
    tpr = max(ATLAS_WIDTH_PX // std_w, 1)
    if not textures:
        # Matches the 1x1 zero placeholder atlas: any non-miss fetch reads 0.
        return AtlasTable(
            texels=jnp.zeros((1, 3), dtype=jnp.float32),
            tile_info=jnp.asarray([[0, 1, 1]], dtype=jnp.int32),
            meta=jnp.asarray([1, 1, 1, 1, 1], dtype=jnp.int32))
    n = len(textures)
    rows, texel_rows, off = [], [], 0
    for tex in textures:
        d = np.asarray(tex.data, dtype=np.float32)
        if d.shape[0] * d.shape[1] > std_h * std_w:
            # Big source: store the standard-tile resample (identical values
            # to the padded atlas, which holds exactly this resample).
            ys = (np.arange(std_h) * d.shape[0] // std_h).clip(0, d.shape[0] - 1)
            xs = (np.arange(std_w) * d.shape[1] // std_w).clip(0, d.shape[1] - 1)
            d = d[ys][:, xs]
        rows.append((off, d.shape[1], d.shape[0]))
        texel_rows.append(d.reshape(-1, 3))
        off += d.shape[0] * d.shape[1]
    # One zero texel backs every padding slot (the padded atlas is zero there)
    zero_off = off
    texel_rows.append(np.zeros((1, 3), dtype=np.float32))
    n_slots = n * tpr  # virtual grid: n tile rows (build_atlas allocates h*n)
    for _ in range(n, n_slots):
        rows.append((zero_off, 1, 1))
    texels = np.concatenate(texel_rows, axis=0)
    # uint8 storage only when the on-device reconstruction u8 * (1/255) is
    # bit-exact, so golden outputs cannot move.
    q = np.round(texels * 255.0)
    if (texels >= 0).all() and (texels <= 1).all() and np.array_equal(
            q.astype(np.float32) * np.float32(1.0 / 255.0), texels):
        texels = q.astype(np.uint8)
    return AtlasTable(
        texels=jnp.asarray(texels),
        tile_info=jnp.asarray(np.asarray(rows, dtype=np.int32)),
        meta=jnp.asarray([std_w, std_h, tpr, std_h * n, std_w * tpr],
                         dtype=jnp.int32))


def fetch_tex_val_table(table: AtlasTable, u, v, tex_num, default3):
    """`fetch_tex_val_soa` over an AtlasTable — value-identical, but the
    gather runs against the compact texel list (or an exact one-hot
    contraction when the list is tiny)."""
    texels, tile_info, meta = table
    k = texels.shape[0]
    n_slots = tile_info.shape[0]
    miss = tex_num == -1.0
    if k == 1:
        flat = texels.astype(jnp.float32)
        if texels.dtype == jnp.uint8:
            flat = flat * jnp.float32(1.0 / 255.0)
        return tuple(jnp.where(miss, d, flat[0, c])
                     for c, d in enumerate(default3))
    std_w, std_h, tpr = meta[0], meta[1], meta[2]
    hf = meta[3].astype(jnp.float32)
    wf = meta[4].astype(jnp.float32)
    tw = tpr.astype(jnp.float32)
    height_factor = wf / hf
    cx = (u + jnp.mod(tex_num, tw)) / tw
    cy = (v + jnp.floor(tex_num / tw)) * height_factor / tw
    px = jnp.clip(jnp.floor(jnp.mod(cx, 1.0) * wf).astype(jnp.int32),
                  0, meta[4] - 1)
    py = jnp.clip(jnp.floor(jnp.mod(cy, 1.0) * hf).astype(jnp.int32),
                  0, meta[3] - 1)
    col = px // std_w
    row = py // std_h
    slot = jnp.clip(row * tpr + col, 0, n_slots - 1)
    if n_slots <= ONE_HOT_SLOTS:
        hot = (slot[..., None] == jnp.arange(n_slots)).astype(jnp.float32)
        # exact: tile_info values are < 2^24 so the f32 contraction is exact
        info = jnp.dot(hot, tile_info.astype(jnp.float32),
                       precision=jax.lax.Precision.HIGHEST).astype(jnp.int32)
        off, sw, sh = info[..., 0], info[..., 1], info[..., 2]
    else:
        info = tile_info[slot]
        off, sw, sh = info[..., 0], info[..., 1], info[..., 2]
    # standard-tile pixel -> stored-tile pixel, same nearest arithmetic as
    # the build_atlas resample (ys = arange(std)*src//std)
    sx = ((px - col * std_w) * sw) // std_w
    sy = ((py - row * std_h) * sh) // std_h
    idx = off + sy * sw + sx
    if k <= ONE_HOT_TEXELS:
        hot = (idx[..., None] == jnp.arange(k)).astype(jnp.float32)
        tabf = texels.astype(jnp.float32)
        if texels.dtype == jnp.uint8:
            tabf = tabf * jnp.float32(1.0 / 255.0)
        sampled = jnp.dot(hot, tabf, precision=jax.lax.Precision.HIGHEST)
        return tuple(jnp.where(miss, d, sampled[..., c])
                     for c, d in enumerate(default3))
    else:
        # slice per channel BEFORE any f32 cast so the [N, 3] u8 gather
        # result is never widened as a whole (values identical: cast and
        # slice commute)
        sampled = texels[idx]
        ch = tuple(sampled[..., c].astype(jnp.float32) for c in range(3))
        if texels.dtype == jnp.uint8:
            ch = tuple(c * jnp.float32(1.0 / 255.0) for c in ch)
        return tuple(jnp.where(miss, d, c)
                     for c, d in zip(ch, default3))


def build_scene_buffers(scene, registry=None) -> SceneBuffers:
    """Flatten a host Scene into device arrays (the updateScene equivalent,
    pathtracerWGL2.js:167-189)."""
    from ..scene.transform import global_registry

    built = scene.generate_arrays()
    registry = registry or global_registry()
    rotations, shifts = registry.build_arrays()
    lights = scene.build_light_array()
    width = int(scene.standard_texture_sizes[0])
    tiles_per_row = max(ATLAS_WIDTH_PX // width, 1)
    return SceneBuffers(
        geometry=jnp.asarray(built.geometry),
        attributes=jnp.asarray(built.attributes),
        id_buffer=jnp.asarray(built.id_buffer, dtype=jnp.int32),
        rotations=jnp.asarray(rotations),
        shifts=jnp.asarray(shifts),
        lights=jnp.asarray(lights),
        ambient=jnp.asarray(np.asarray(scene.ambient_light, dtype=np.float32)),
        albedo_atlas=jnp.asarray(build_atlas(scene.textures, scene.standard_texture_sizes)),
        pbr_atlas=jnp.asarray(build_atlas(scene.pbr_textures, scene.standard_texture_sizes)),
        tpo_atlas=jnp.asarray(build_atlas(scene.translucency_textures, scene.standard_texture_sizes)),
        texture_width=jnp.float32(tiles_per_row),
        albedo_tab=build_atlas_table(scene.textures, scene.standard_texture_sizes),
        pbr_tab=build_atlas_table(scene.pbr_textures, scene.standard_texture_sizes),
        tpo_tab=build_atlas_table(scene.translucency_textures, scene.standard_texture_sizes),
    )


def fetch_tex_val(atlas: jnp.ndarray, uv: jnp.ndarray, tex_num: jnp.ndarray,
                  default: jnp.ndarray, texture_width: jnp.ndarray) -> jnp.ndarray:
    """Atlas lookup (pathtracer_fragment.glsl:108-117): NEAREST sampling with
    REPEAT wrap on the normalized coordinates the reference computes.

    uv: [..., 2], tex_num: [...], default: [..., 3] -> [..., 3]
    """
    h, w = atlas.shape[0], atlas.shape[1]
    height_factor = jnp.float32(w) / jnp.float32(h)
    cx = (uv[..., 0] + jnp.mod(tex_num, texture_width)) / texture_width
    cy = (uv[..., 1] + jnp.floor(tex_num / texture_width)) * height_factor / texture_width
    px = jnp.floor(jnp.mod(cx, 1.0) * w).astype(jnp.int32).clip(0, w - 1)
    py = jnp.floor(jnp.mod(cy, 1.0) * h).astype(jnp.int32).clip(0, h - 1)
    # flat row gather over the [H*W, C] view of the atlas
    flat_idx = jax.lax.optimization_barrier(py * w + px)
    sampled = atlas.reshape(h * w, atlas.shape[-1])[flat_idx]
    return jnp.where((tex_num == -1.0)[..., None], default, sampled)


def fetch_tex_val_soa(atlas: jnp.ndarray, u, v, tex_num, default3,
                      texture_width):
    """SoA `fetch_tex_val`: uv as two [N] arrays, default as a 3-tuple.
    Skips the gather entirely for the 1x1 placeholder atlas (scene has no
    textures of this kind)."""
    h, w = atlas.shape[0], atlas.shape[1]
    miss = tex_num == -1.0
    if h * w == 1:
        return tuple(jnp.where(miss, d, atlas[0, 0, c])
                     for c, d in enumerate(default3))
    height_factor = jnp.float32(w) / jnp.float32(h)
    cx = (u + jnp.mod(tex_num, texture_width)) / texture_width
    cy = (v + jnp.floor(tex_num / texture_width)) * height_factor / texture_width
    px = jnp.floor(jnp.mod(cx, 1.0) * w).astype(jnp.int32).clip(0, w - 1)
    py = jnp.floor(jnp.mod(cy, 1.0) * h).astype(jnp.int32).clip(0, h - 1)
    sampled = jnp.moveaxis(
        atlas.reshape(h * w, atlas.shape[-1])[
            jax.lax.optimization_barrier(py * w + px)], -1, 0)
    return tuple(jnp.where(miss, d, sampled[c]) for c, d in enumerate(default3))
