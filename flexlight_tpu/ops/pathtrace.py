"""Wavefront path tracer core.

Re-design of the reference's fragment-shader megakernel
(`shaders/pathtracer_fragment.glsl:400-646`). One GLSL invocation per pixel
becomes one jitted pure function over the whole ray batch [N = H*W]:

- primary hits come from tracing camera rays through the same skip-pointer
  list the reference walks (the reference rasterizes primaries,
  pathtracer_vertex.glsl:40-73 — observable output is identical since the
  raster pass only produced first-hit distance/uv/id);
- the bounce loop is statically unrolled to `max_reflections` with per-ray
  kill masks (the reference's dynamic exit, glsl:475, becomes masking);
- next-event estimation is the same weighted reservoir sample over all
  lights with a single shadow ray (glsl:400-461);
- every output channel of the 6-target MRT contract (glsl:601-646) is
  reproduced, in fp32 (quantization to RGBA8 happens in the post layer's
  compat mode).

All math is elementwise over [N]-wide arrays, fused by XLA; traversal is
delegated to the scheme's cast (ops.traverse, ops.traverse_mxu,
ops.traverse_clustered).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import traverse as trv
from . import vec3 as v3
from .brdf import SQRT3, forward_trace_soa, normalize
from .buffers import SceneBuffers, fetch_tex_val_soa, fetch_tex_val_table
from .geometry import world_geometry
from .intersect import BIAS
from .rng import noise4
from .schemes import check_scheme

INV_255 = 1.0 / 255.0
INV_PI = 0.3183098861837907

# Scenes below this triangle count have too few clusters for culling to
# matter; block-tiled ray order is skipped (tests lower it). Tuned on an
# earlier accelerator; not measured on the H100.
BLOCK_TILE_MIN_TRIS = 2048

# Ray count from which shading runs on [G, 1024] 2-D shapes (tests lower
# it). Tuned on an earlier accelerator; not measured on the H100.
SHADE_2D_MIN_RAYS = 1_500_000

# Light count at which reservoir NEE switches from an unrolled light loop
# (fully fused) to a lax.scan over the light axis (bounded compile time —
# the 64-light example2 scene compiles for minutes unrolled).
SCAN_LIGHTS_MIN = 16


class MRT(NamedTuple):
    """Flat per-pixel render targets, fp32 (glsl:74-79)."""
    color: jnp.ndarray          # [N, 3] finalColor (originalColor NOT folded in)
    glass: jnp.ndarray          # [N] glassFilter -> colorIp.w in filter mode
    original_color: jnp.ndarray  # [N, 3] first-hit albedo product
    original_w: jnp.ndarray     # [N] min(originalRMEx, firstRayLength) + 1/255
    render_id: jnp.ndarray      # [N, 4] packed normal/rme + light/shadow in w
    original_id_w: jnp.ndarray  # [N] originalTPOx + 1/255 (glsl:639)
    location_id: jnp.ndarray    # [N, 4] mod of local position (glsl:641-642)
    alpha: jnp.ndarray          # [N] coverage (0 where no primary hit)


def _dot(a, b):
    return jnp.sum(a * b, axis=-1)


def _mix(a, b, t):
    return a + (b - a) * t


def to_4bit_representation(a, b):
    """Pack two [0,1] floats into high/low nibbles of one byte (glsl:91-95)."""
    aui = (a * 255.0).astype(jnp.uint32) & jnp.uint32(240)
    bui = ((b * 255.0).astype(jnp.uint32) & jnp.uint32(240)) >> 4
    return (aui | bui).astype(jnp.float32) * INV_255


def combine_normal_rme(n, rme):
    """4-bit spherical normal + rme packing for the id channel (glsl:97-105)."""
    phi = jnp.arctan2(n[..., 2], n[..., 0]) * INV_PI * 0.5 + 0.5
    theta = jnp.arctan2(n[..., 0], n[..., 1]) * INV_PI * 0.5 + 0.5
    packed_n = to_4bit_representation(phi, theta)
    return jnp.stack([packed_n, rme[..., 0],
                      to_4bit_representation(rme[..., 1], rme[..., 2])], axis=-1)


def camera_rays(width: int, height: int, position, view_matrix,
                row0=0, rows: int | None = None):
    """Camera ray generation replacing the instanced raster pass.

    Pixel centers map to the NDC coordinates the reference's vertex shader
    produces (clipSpace.xy / clipSpace.z, pathtracer_vertex.glsl:66-68);
    directions invert the 3x3 view matrix so viewMatrix @ dir = (ndc, 1).

    `row0`/`rows` select a horizontal image strip — the unit of image-tile
    sharding across chips (row0 may be traced, e.g. axis_index * rows).
    Returns (origin [N,3], dir [N,3], ndc [N,2]) with N = rows*width.
    """
    rows = height if rows is None else rows
    px = (jnp.arange(width, dtype=jnp.float32) + 0.5) / width * 2.0 - 1.0
    row_idx = jnp.arange(rows, dtype=jnp.float32) + jnp.float32(row0)
    py = 1.0 - (row_idx + 0.5) / height * 2.0
    ndc_x, ndc_y = jnp.meshgrid(px, py)  # [rows, W]
    ndc = jnp.stack([ndc_x.reshape(-1), ndc_y.reshape(-1)], axis=-1)
    inv_view = jnp.linalg.inv(view_matrix)
    clip = jnp.concatenate([ndc, jnp.ones_like(ndc[:, :1])], axis=-1)
    direction = normalize(clip @ inv_view.T)
    origin = jnp.broadcast_to(position, direction.shape)
    return origin, direction, ndc


class ReservoirPick(NamedTuple):
    """Reservoir-selection outputs (glsl:400-447): the shadow-ray request
    plus everything `reservoir_finish` consumes after the shadow test."""
    local_color: tuple
    res_num: jnp.ndarray
    show_color: jnp.ndarray
    show_shadow: jnp.ndarray
    offset_target: tuple
    light_dir: tuple            # unit direction to the selected light
    max_len: jnp.ndarray        # distance to the selected light


def reservoir_finish(pick: ReservoirPick, emis, shadowed):
    """Reservoir epilogue after the shadow test (glsl:448-461)."""
    in_shadow = ~pick.show_color & (pick.show_shadow | shadowed)
    id_w = (jnp.mod(pick.res_num, 128) * 2).astype(jnp.float32) * INV_255
    id_w = id_w + jnp.where(in_shadow, INV_255, 0.0)
    keep = pick.show_color | ~in_shadow
    color = v3.where3(keep, v3.add3(pick.local_color, (emis, emis, emis)),
                      (emis, emis, emis))
    return color, id_w


def reservoir_sample(buffers: SceneBuffers, albedo3, rough, metal, emis,
                     origin3, unit_dir3, random_vec4, n_rough3, n_smooth3,
                     geometry_offset, random_seed, shadow_soa, alive_mask=None,
                     rng_mode: str = "hash"):
    """Weighted reservoir NEE over all lights + one shadow ray
    (glsl:400-461), SoA form (see ops.vec3). Returns (color 3-tuple, id_w
    [N]). Composition of reservoir_select -> shadow -> reservoir_finish."""
    pick = reservoir_select(buffers, albedo3, rough, metal, emis, origin3,
                            unit_dir3, random_vec4, n_rough3, n_smooth3,
                            geometry_offset, random_seed, rng_mode=rng_mode)
    shadowed = shadow_soa(pick.offset_target, pick.light_dir, pick.max_len,
                          alive=alive_mask)
    return reservoir_finish(pick, emis, shadowed)


def reservoir_select(buffers: SceneBuffers, albedo3, rough, metal, emis,
                     origin3, unit_dir3, random_vec4, n_rough3, n_smooth3,
                     geometry_offset, random_seed,
                     rng_mode: str = "hash") -> ReservoirPick:
    """The reservoir light loop + selection, up to (and excluding) the
    shadow ray (glsl:400-447)."""
    shp = origin3[0].shape
    num_lights = buffers.lights.shape[0]
    zero = jnp.zeros(shp, dtype=jnp.float32)

    local_color = (zero, zero, zero)
    res_length = zero
    total_weight = zero
    res_num = jnp.zeros(shp, dtype=jnp.int32)
    res_weight = zero
    res_dir = (zero, zero, zero)
    lr = noise4(random_vec4[2], random_vec4[3], BIAS, random_seed,
                mode=rng_mode)[0:2]

    v = v3.neg3(unit_dir3)

    def light_step(carry, j, light_row):
        """One reservoir update (glsl:409-459); j may be a traced scalar."""
        (local_color, res_length, total_weight, res_num, res_weight,
         res_dir, lr) = carry
        strength = light_row[1, 0]
        variation = light_row[1, 1]
        active = strength > 0.0  # skip dead lights (glsl:415)
        light = tuple(light_row[0, c] + random_vec4[c] * variation
                      for c in range(3))
        d = v3.sub3(light, origin3)
        cfl = forward_trace_soa(albedo3, rough, metal, emis, d, strength,
                                n_rough3, v)
        weight = v3.norm3(cfl)
        local_color = v3.where3(active, v3.add3(local_color, cfl), local_color)
        res_length = jnp.where(active, res_length + 1.0, res_length)
        total_weight = jnp.where(active, total_weight + weight, total_weight)
        sel = active & (jnp.abs(lr[1]) * total_weight <= weight)
        res_num = jnp.where(sel, j, res_num)
        res_weight = jnp.where(sel, weight, res_weight)
        res_dir = v3.where3(sel, d, res_dir)
        nxt = noise4(lr[0], lr[1], BIAS, random_seed, mode=rng_mode)[2:4]
        lr = (jnp.where(active, nxt[0], lr[0]), jnp.where(active, nxt[1], lr[1]))
        return (local_color, res_length, total_weight, res_num, res_weight,
                res_dir, lr)

    carry = (local_color, res_length, total_weight, res_num, res_weight,
             res_dir, lr)
    if num_lights < SCAN_LIGHTS_MIN:
        # few lights: unroll so XLA fuses the whole chain into the bounce
        for j in range(num_lights):
            carry = light_step(carry, j, buffers.lights[j])
    else:
        # many lights (example2.js's 64-light stress): the unrolled chain
        # explodes compile time; a scan over the light axis is the same
        # sequential arithmetic (the reservoir noise chain forces order)
        carry = jax.lax.scan(
            lambda c, jl: (light_step(c, jl[0], jl[1]), None),
            carry, (jnp.arange(num_lights, dtype=jnp.int32), buffers.lights),
        )[0]
    (local_color, res_length, total_weight, res_num, res_weight,
     res_dir, lr) = carry

    unit_light_dir = v3.normalize3(res_dir)
    show_color = (res_length == 0.0) | (res_weight == 0.0)
    show_shadow = v3.dot3(n_smooth3, unit_light_dir) <= BIAS
    offset_target = v3.add3(origin3, v3.scale3(n_smooth3, geometry_offset))
    return ReservoirPick(
        local_color=local_color, res_num=res_num, show_color=show_color,
        show_shadow=show_shadow, offset_target=offset_target,
        light_dir=unit_light_dir, max_len=v3.norm3(res_dir))


def build_material_table(buffers: SceneBuffers, world_geom) -> jnp.ndarray:
    """Per-triangle shading row [T, 49]: world geometry (12), attributes
    (28), forward rotation (9) — one wide row gather per bounce instead of
    five (geometry/rotations/shifts/world_geom/attributes)."""
    t_idx = buffers.geometry[:, 9].astype(jnp.int32)
    rot_f = buffers.rotations[t_idx][:, 0].reshape(-1, 9)
    return jnp.concatenate([world_geom, buffers.attributes, rot_f], axis=1)


def fetch_rows_t(mat: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """mat[idx] transposed to a leading channel axis: [C, *idx.shape].

    For small tables the whole fetch is a one-hot matmul (exact: one 1.0
    per column); otherwise an optimization barrier forces a real relayout
    after the row gather, so SoA row reads downstream are contiguous.

    With 2-D [G, 1024] ray shapes the result is [C, G, 1024]: row reads
    are then leading-dim slices."""
    t = mat.shape[0]
    flat = idx.reshape(-1)
    n = flat.shape[0]
    # One-hot cap is memory-based: the [t, n] f32 one-hot materializes in
    # device memory, so bound t*n (512 MiB) rather than n alone. Tuned on
    # an earlier accelerator; not measured on the H100.
    if t <= 256 and t * n <= (1 << 27):
        onehot = (flat[None, :] == jnp.arange(t, dtype=flat.dtype)[:, None])
        out = jnp.dot(mat.T, onehot.astype(mat.dtype),
                      precision=jax.lax.Precision.HIGHEST)
        return out.reshape((mat.shape[1],) + idx.shape)
    rows = jax.lax.optimization_barrier(mat[flat])
    rows = rows.reshape(idx.shape + (mat.shape[1],))
    return jnp.moveaxis(rows, -1, 0)


def combine_normal_rme_soa(n3, rough, metal, emis):
    """SoA combine_normal_rme -> 3 [N] channels (glsl:97-105)."""
    phi = jnp.arctan2(n3[2], n3[0]) * INV_PI * 0.5 + 0.5
    theta = jnp.arctan2(n3[0], n3[1]) * INV_PI * 0.5 + 0.5
    return (to_4bit_representation(phi, theta), rough,
            to_4bit_representation(metal, emis))


class BounceCarry(NamedTuple):
    """Loop-carried wavefront state of the bounce loop: the GLSL
    per-pixel locals (glsl:464-599) plus the shader globals threaded via
    `aux`; light_trace threads it through the bounce stages below."""
    alive: jnp.ndarray
    tri: jnp.ndarray
    hs: jnp.ndarray
    hu: jnp.ndarray
    hv: jnp.ndarray
    ray_origin: tuple
    ray_dir: tuple
    last_hit_point: tuple
    importancy: tuple
    original_color: tuple
    dont_filter: jnp.ndarray
    final_color: tuple
    render_id: tuple
    original_id_acc: tuple
    glass: jnp.ndarray
    original_rme_x: jnp.ndarray
    original_tpo_x: jnp.ndarray
    first_ray_length: jnp.ndarray


class BounceSurface(NamedTuple):
    """Per-bounce surface quantities produced BEFORE the texture fetch
    (bounce_pre) and consumed after it (bounce_post)."""
    m: jnp.ndarray
    smooth_normal: tuple
    geometry_offset: jnp.ndarray
    bary_u: jnp.ndarray
    bary_v: jnp.ndarray
    tex_nums: tuple
    inline_albedo: tuple
    inline_rme: tuple
    inline_tpo: tuple


def bounce_carry_init(primary_parts, camera_pos, direction3, aux) -> BounceCarry:
    ps, pu, pv, ptri = primary_parts
    shp = ps.shape
    zero = jnp.zeros(shp, dtype=jnp.float32)
    one = jnp.ones(shp, dtype=jnp.float32)
    (render_id, original_id_acc, glass, original_rme_x, original_tpo_x,
     first_ray_length) = aux
    ray_origin = tuple(jnp.broadcast_to(camera_pos[c], shp).astype(jnp.float32)
                       for c in range(3))
    return BounceCarry(
        alive=ptri != -1, tri=jnp.maximum(ptri, 0), hs=ps, hu=pu, hv=pv,
        ray_origin=ray_origin, ray_dir=direction3, last_hit_point=ray_origin,
        importancy=(one, one, one), original_color=(one, one, one),
        dont_filter=jnp.ones(shp, dtype=bool), final_color=(zero, zero, zero),
        render_id=render_id, original_id_acc=original_id_acc, glass=glass,
        original_rme_x=original_rme_x, original_tpo_x=original_tpo_x,
        first_ray_length=first_ray_length)


def bounce_pre(carry: BounceCarry, i: int, mat, config):
    """Bounce stage 1 (glsl:475-526): importance kill, material row
    fetch, hit-point update, normal interpolation, texture coords.
    Returns (carry, BounceSurface)."""
    shp = carry.hs.shape
    zero = jnp.zeros(shp, dtype=jnp.float32)
    importance_len = v3.norm3(v3.mul3(carry.importancy, carry.original_color))
    alive = carry.alive & (importance_len >= config.min_importancy * SQRT3)
    m = alive

    # gather full rows, then read channels from the relaid [49, N] table
    rowt = fetch_rows_t(mat, carry.tri)
    rot = tuple(rowt[40 + k] for k in range(9))

    new_origin = v3.add3(v3.scale3(carry.ray_dir, carry.hs), carry.ray_origin)
    ray_origin = v3.where3(m, new_origin, carry.ray_origin)
    uvw = (1.0 - carry.hu - carry.hv, carry.hu, carry.hv)

    # World-space triangle (glsl:492)
    wv = [(rowt[3 * k], rowt[3 * k + 1], rowt[3 * k + 2]) for k in range(3)]
    geometry_normal = v3.normalize3(v3.cross3(
        v3.sub3(wv[0], wv[1]), v3.sub3(wv[0], wv[2])))

    smooth_normal = (zero, zero, zero)
    geometry_offset = zero
    bary_u = zero
    bary_v = zero
    for k in range(3):
        vn = (rowt[12 + 3 * k], rowt[13 + 3 * k], rowt[14 + 3 * k])
        wn = v3.matvec3(rot, vn)
        smooth_normal = v3.add3(smooth_normal, v3.scale3(wn, uvw[k]))
        # tan(acos(x)) = sqrt(1-x^2)/x — shadow-acne offset (glsl:516-518)
        cos_a = jnp.abs(jnp.clip(v3.dot3(geometry_normal, wn), -1.0, 1.0))
        tan_a = jnp.clip(jnp.sqrt(1.0 - cos_a * cos_a) / cos_a, 0.0, 1.0)
        diff = v3.norm3(v3.sub3(ray_origin, wv[k]))
        geometry_offset = geometry_offset + diff * tan_a * uvw[k]
        bary_u = bary_u + rowt[21 + 2 * k] * uvw[k]
        bary_v = bary_v + rowt[22 + 2 * k] * uvw[k]
    smooth_normal = v3.normalize3(smooth_normal)

    surface = BounceSurface(
        m=m, smooth_normal=smooth_normal, geometry_offset=geometry_offset,
        bary_u=bary_u, bary_v=bary_v,
        tex_nums=(rowt[27], rowt[28], rowt[29]),
        inline_albedo=(rowt[30], rowt[31], rowt[32]),
        inline_rme=(rowt[33], rowt[34], rowt[35]),
        inline_tpo=(rowt[36], rowt[37], rowt[38]))
    return carry._replace(alive=alive, ray_origin=ray_origin), surface


def bounce_tex(buffers: SceneBuffers, surface: BounceSurface):
    """Bounce stage 2: the three atlas fetches (glsl:502-510). Returns
    (albedo3, rough, metal, emis, tpo3)."""
    if buffers.albedo_tab is not None:
        # Compact-table fetch: value-identical to the padded-atlas gather
        # over a much smaller table (see AtlasTable)
        albedo = fetch_tex_val_table(
            buffers.albedo_tab, surface.bary_u, surface.bary_v,
            surface.tex_nums[0], surface.inline_albedo)
        rough, metal, emis = fetch_tex_val_table(
            buffers.pbr_tab, surface.bary_u, surface.bary_v,
            surface.tex_nums[1], surface.inline_rme)
        tpo = fetch_tex_val_table(
            buffers.tpo_tab, surface.bary_u, surface.bary_v,
            surface.tex_nums[2], surface.inline_tpo)
        return (albedo, rough, metal, emis, tpo)
    albedo = fetch_tex_val_soa(
        buffers.albedo_atlas, surface.bary_u, surface.bary_v,
        surface.tex_nums[0], surface.inline_albedo, buffers.texture_width)
    rough, metal, emis = fetch_tex_val_soa(
        buffers.pbr_atlas, surface.bary_u, surface.bary_v,
        surface.tex_nums[1], surface.inline_rme, buffers.texture_width)
    tpo = fetch_tex_val_soa(
        buffers.tpo_atlas, surface.bary_u, surface.bary_v,
        surface.tex_nums[2], surface.inline_tpo, buffers.texture_width)
    return (albedo, rough, metal, emis, tpo)


class ShadeRequest(NamedTuple):
    """bounce_shade -> bounce_apply crossing: the NEE shadow-ray request
    (pick) plus the shading-frame values the post-shadow stage consumes."""
    m: jnp.ndarray
    ray_dir: tuple              # recomputed incoming unit direction
    smooth_normal: tuple        # sign-flipped shading normal
    sign_dir: jnp.ndarray
    random_sphere: tuple
    roughness_brdf: jnp.ndarray
    is_solid: jnp.ndarray
    write_id_w: jnp.ndarray
    pick: ReservoirPick


def bounce_shade(carry: BounceCarry, surface: BounceSurface, tex, i: int,
                 buffers: SceneBuffers, camera_pos, ndc2, cos_sample_n,
                 config, random_seed):
    """Bounce stage 3a (glsl:529-576 + reservoir selection 400-447):
    shading frame, Fresnel-chance decision, first-surface bookkeeping,
    reservoir light selection — everything up to (and excluding) the NEE
    shadow ray. `i` is the static bounce index. Returns
    (carry, ShadeRequest)."""
    albedo, rough, metal, emis, tpo = tex
    m = surface.m
    smooth_normal = surface.smooth_normal
    geometry_offset = surface.geometry_offset
    shp = carry.hs.shape
    zero = jnp.zeros(shp, dtype=jnp.float32)

    ray_origin = carry.ray_origin
    last_hit_point = carry.last_hit_point
    dont_filter = carry.dont_filter
    render_id = carry.render_id
    original_id_acc = carry.original_id_acc

    ray_dir = v3.where3(m, v3.normalize3(v3.sub3(ray_origin, last_hit_point)),
                        carry.ray_dir)
    sign_dir = jnp.sign(v3.dot3(ray_dir, smooth_normal))
    smooth_normal = v3.scale3(smooth_normal, -sign_dir)

    rv = noise4(ndc2[0], ndc2[1], jnp.float32(i) + cos_sample_n, random_seed,
                mode=config.rng)
    random_sphere = v3.normalize3(v3.add3(
        smooth_normal, v3.normalize3((rv[0], rv[1], rv[2]))))
    brdf = _mix(1.0, jnp.abs(v3.dot3(smooth_normal, ray_dir)), metal)
    roughness_brdf = rough * brdf
    rough_normal = v3.normalize3(v3.mix3(smooth_normal, random_sphere,
                                         roughness_brdf))

    h = v3.normalize3(v3.sub3(rough_normal, ray_dir))
    v_dot_h = jnp.maximum(-v3.dot3(ray_dir, h), 0.0)
    one_m_theta5 = (1.0 - v_dot_h) ** 5
    fresnel_reflect = zero
    for c in range(3):
        f0 = albedo[c] * brdf
        fresnel_reflect = jnp.maximum(
            fresnel_reflect, f0 + (1.0 - f0) * one_m_theta5)
    # Fresnel-chance solid/translucent decision (glsl:550)
    is_solid = tpo[0] * fresnel_reflect <= jnp.abs(rv[3])

    # First-surface bookkeeping vs importancy accumulation (glsl:553-573)
    df = dont_filter & m
    original_tpo_x = jnp.where(df, tpo[0], carry.original_tpo_x)
    original_color = v3.where3(df, v3.mul3(carry.original_color, albedo),
                               carry.original_color)
    original_rme_x = jnp.where(df, carry.original_rme_x + rough,
                               carry.original_rme_x)
    idu = combine_normal_rme_soa(smooth_normal, rough, metal, emis)
    scale_i = 2.0 ** -i
    render_id = (
        render_id[0] + jnp.where(df, scale_i * idu[0], 0.0),
        render_id[1] + jnp.where(df, scale_i * idu[1], 0.0),
        render_id[2] + jnp.where(df, scale_i * idu[2], 0.0),
        render_id[3],
    )
    if i == 0:
        original_id_acc = tuple(
            original_id_acc[c] + jnp.where(df, scale_i * idu[c], 0.0)
            for c in range(3)) + (original_id_acc[3],)
    new_dont_filter = ((rough < 0.01) & is_solid) | ~is_solid
    is_glass = is_solid & (tpo[0] > 0.01)
    glass = jnp.where(df & is_glass, carry.glass + 1.0, carry.glass)
    new_dont_filter = new_dont_filter & ~is_glass
    importancy = v3.where3(~dont_filter & m,
                           v3.mul3(carry.importancy, albedo),
                           carry.importancy)
    dont_filter = (df & new_dont_filter) | (~df & dont_filter)

    first_ray_length = carry.first_ray_length
    if i == 1:
        ratio = (v3.norm3(v3.sub3(ray_origin, last_hit_point))
                 / jnp.maximum(v3.norm3(v3.sub3(
                     last_hit_point,
                     tuple(jnp.broadcast_to(camera_pos[c], shp)
                           for c in range(3)))), 1e-30))
        first_ray_length = jnp.where(
            m, jnp.minimum(ratio, first_ray_length), first_ray_length)

    pick = reservoir_select(
        buffers, albedo, rough, metal, emis, ray_origin, ray_dir,
        rv, v3.scale3(rough_normal, -sign_dir),
        v3.scale3(smooth_normal, -sign_dir), geometry_offset,
        random_seed, rng_mode=config.rng)
    write_id_w = (dont_filter | (i == 0)) & m

    carry = carry._replace(
        importancy=importancy, original_color=original_color,
        dont_filter=dont_filter, original_id_acc=original_id_acc,
        glass=glass, original_rme_x=original_rme_x,
        original_tpo_x=original_tpo_x, first_ray_length=first_ray_length,
        render_id=render_id)
    return carry, ShadeRequest(
        m=m, ray_dir=ray_dir, smooth_normal=smooth_normal,
        sign_dir=sign_dir, random_sphere=random_sphere,
        roughness_brdf=roughness_brdf, is_solid=is_solid,
        write_id_w=write_id_w, pick=pick)


def bounce_apply(carry: BounceCarry, tex, req: ShadeRequest,
                 shadowed) -> BounceCarry:
    """Bounce stage 3b (glsl:448-461 + 577-589): apply the NEE shadow
    result, accumulate radiance, compute the next ray direction."""
    emis, tpo = tex[3], tex[4]
    m = req.m
    local_color, id_w = reservoir_finish(req.pick, emis, shadowed)
    render_id = carry.render_id[0:3] + (
        jnp.where(req.write_id_w, id_w, carry.render_id[3]),)

    final_color = v3.where3(
        m, v3.add3(carry.final_color,
                   v3.mul3(local_color, carry.importancy)),
        carry.final_color)

    ray_dir = v3.where3(m, next_ray_dir(req, tpo), req.ray_dir)
    return carry._replace(render_id=render_id, final_color=final_color,
                          ray_dir=ray_dir)


def next_ray_dir(req: ShadeRequest, tpo):
    """The next bounce direction (glsl:582-589): reflect, or
    Fresnel-chance refract, roughness-mixed. Unmasked — callers blend
    with the live mask."""
    ray_dir = req.ray_dir
    smooth_normal = req.smooth_normal
    zero = jnp.zeros(ray_dir[0].shape, dtype=jnp.float32)
    n_dot_i = v3.dot3(smooth_normal, ray_dir)
    reflected = v3.sub3(ray_dir, v3.scale3(smooth_normal, 2.0 * n_dot_i))
    eta = _mix(1.0 / tpo[2], tpo[2], jnp.maximum(req.sign_dir, 0.0))
    k = 1.0 - eta * eta * (1.0 - n_dot_i * n_dot_i)
    refr_coef = eta * n_dot_i + jnp.sqrt(jnp.maximum(k, 0.0))
    refracted = v3.where3(
        k < 0.0, (zero, zero, zero),
        v3.sub3(v3.scale3(ray_dir, eta),
                v3.scale3(smooth_normal, refr_coef)))
    bounce_base = v3.where3(req.is_solid, reflected, refracted)
    return v3.normalize3(v3.mix3(bounce_base, req.random_sphere,
                                 req.roughness_brdf))


def bounce_commit(carry: BounceCarry, m, traverse_soa) -> BounceCarry:
    """Bounce stage 3c (glsl:591-597): the next closest hit."""
    shp = carry.hs.shape
    zero = jnp.zeros(shp, dtype=jnp.float32)
    one = jnp.ones(shp, dtype=jnp.float32)
    ns, nu, nv, ntri = traverse_soa(
        v3.where3(m, carry.ray_origin, (zero, zero, zero)),
        v3.where3(m, carry.ray_dir, (zero, zero, one)))
    hs = jnp.where(m, ns, carry.hs)
    hu = jnp.where(m, nu, carry.hu)
    hv = jnp.where(m, nv, carry.hv)
    new_tri = jnp.where(m, ntri, -1)
    alive = carry.alive & (new_tri != -1)
    tri = jnp.maximum(jnp.where(m, new_tri, carry.tri), 0)
    last_hit_point = v3.where3(m, carry.ray_origin, carry.last_hit_point)
    return carry._replace(alive=alive, tri=tri, hs=hs, hu=hu, hv=hv,
                          last_hit_point=last_hit_point)


def bounce_post(carry: BounceCarry, surface: BounceSurface, tex, i: int,
                buffers: SceneBuffers, camera_pos, ndc2, cos_sample_n,
                config, random_seed, traverse_soa, shadow_soa) -> BounceCarry:
    """Bounce stage 3 (glsl:529-599): bounce_shade -> NEE shadow ray ->
    bounce_apply -> next closest hit (skipped after the last bounce)."""
    carry, req = bounce_shade(carry, surface, tex, i, buffers, camera_pos,
                              ndc2, cos_sample_n, config, random_seed)
    shadowed = shadow_soa(req.pick.offset_target, req.pick.light_dir,
                          req.pick.max_len)
    carry = bounce_apply(carry, tex, req, shadowed)
    if i + 1 < config.max_reflections:
        carry = bounce_commit(carry, req.m, traverse_soa)
    return carry


def light_trace(buffers: SceneBuffers, mat, primary_parts, camera_pos,
                direction3, ndc2, cos_sample_n, config, random_seed,
                traverse_soa, shadow_soa, aux, hit_record=None):
    """The bounce loop (glsl:464-599), unrolled with kill masks, SoA over
    [N] component arrays (ops.vec3). Composed of the stage functions
    above (pre -> tex -> post).

    `aux` carries the shader's globals across samples (glsl:84-89).
    `hit_record`: optional list; when given, each bounce appends its
    landed triangle (-1 for dead rays)."""
    carry = bounce_carry_init(primary_parts, camera_pos, direction3, aux)
    for i in range(config.max_reflections):
        carry, surface = bounce_pre(carry, i, mat, config)
        tex = bounce_tex(buffers, surface)
        carry = bounce_post(carry, surface, tex, i, buffers, camera_pos,
                            ndc2, cos_sample_n, config, random_seed,
                            traverse_soa, shadow_soa)
        if hit_record is not None:
            hit_record.append(jnp.where(carry.alive, carry.tri, -1))

    final_color = tuple(
        carry.final_color[c] + carry.importancy[c] * buffers.ambient[c]
        for c in range(3))
    aux = (carry.render_id, carry.original_id_acc, carry.glass,
           carry.original_rme_x, carry.original_tpo_x,
           carry.first_ray_length)
    return final_color, carry.original_color, carry.original_tpo_x, aux


def _pick_block(rows: int, width: int):
    """Squarest pixel block of 1024 rays that tiles the image exactly."""
    for bh, bw in ((32, 32), (16, 64), (8, 128)):
        if rows % bh == 0 and width % bw == 0:
            return bh, bw
    return None


def block_tile(x, rows: int, width: int, bh: int, bw: int):
    """Reorder flat row-major pixels into bh x bw block order.

    Ray groups (consecutive rays) are the unit of cluster culling in
    ops.traverse_clustered; in row-major order a group is a half-row
    sliver of the image whose frustum spans the whole scene. As a
    square-ish pixel block the same 1024 rays form a tight frustum, so
    the per-group cluster unions collapse. Pure reshape/transpose — a
    static relayout, no gathers; shading is pointwise so the entire bounce
    pipeline runs in block order and only the MRT assembly un-tiles."""
    lead = x.shape[1:]
    x = x.reshape(rows // bh, bh, width // bw, bw, *lead)
    return jnp.swapaxes(x, 1, 2).reshape(rows * width, *lead)


def block_untile(x, rows: int, width: int, bh: int, bw: int):
    lead = x.shape[1:]
    x = x.reshape(rows // bh, width // bw, bh, bw, *lead)
    return jnp.swapaxes(x, 1, 2).reshape(rows * width, *lead)


def render_mrt(buffers: SceneBuffers, width: int, height: int, camera_pos,
               view_matrix, config, random_seed, scheme: str = "scan",
               tile: int = 1024, row0=0, rows: int | None = None,
               sample_offset=0.0, local_samples: int | None = None,
               with_raw_aux: bool = False, with_trace_hints: bool = False):
    """Full primary+bounce render to the 6-channel MRT contract
    (glsl:601-646). Returns flat [N=rows*W] per-pixel outputs.

    `scheme` names the traversal (ops.schemes.SCHEMES).

    `row0`/`rows` render an image strip (tile sharding); `sample_offset`/
    `local_samples` render a slice of the per-pixel sample loop (sample
    sharding): global sample index i uses cos(i) as its noise phase
    (glsl:611-612), so shards pass sample_offset = axis_index * local.

    `with_raw_aux` additionally returns (original_rme_x, first_ray_length)
    unmixed: MRT.original_w folds them as min(rme, frl) (glsl:635), but
    rme sums across samples while frl is a running min, so sample shards
    must combine the raw channels before folding (parallel.tile_sharding).

    `with_trace_hints` additionally returns a tuple of per-bounce [H*W]
    int32 row-major arrays: each pixel's landed triangle at that bounce
    of the last sample (-1 when the path died) — the per-bounce path
    record the parity tests compare against the oracle's."""
    check_scheme(scheme)
    world_geom = world_geometry(buffers)

    if scheme == "mxu":
        from .traverse_mxu import build_tri_matrix, shadow_mxu, traverse_mxu

        w = build_tri_matrix(world_geom, buffers.id_buffer)

        def traverse_fn(o, d, edge=BIAS):
            return traverse_mxu(w, buffers.id_buffer, o, d, edge=edge)

        def shadow_fn(o, d, l):
            return shadow_mxu(w, o, d, l)
    elif scheme == "clustered":
        from .traverse_clustered import build_clusters, shadow_clustered, traverse_clustered

        clusters = build_clusters(world_geom, buffers.id_buffer)

        def traverse_fn(o, d, edge=BIAS):
            return traverse_clustered(clusters, o, d, edge=edge)

        def shadow_fn(o, d, l):
            return shadow_clustered(clusters, o, d, l)
    elif scheme == "packet":
        def traverse_fn(o, d, edge=BIAS):
            return trv.traverse_coherent(world_geom, o, d, tile=tile, edge=edge)

        def shadow_fn(o, d, l):
            return trv.shadow_coherent(world_geom, o, d, l, tile=tile)
    else:
        def traverse_fn(o, d, edge=BIAS):
            return trv.traverse_scan(world_geom, o, d, edge=edge)

        def shadow_fn(o, d, l):
            return trv.shadow_scan(world_geom, o, d, l)

    origin, direction, ndc = camera_rays(width, height, camera_pos, view_matrix,
                                         row0=row0, rows=rows)
    # Block-tiled ray order: big-scene cluster culling needs tight per-group
    # frusta (see block_tile). Small scenes have nothing to cull.
    n_rows = height if rows is None else rows
    block = _pick_block(n_rows, width)
    blocked = (scheme == "clustered" and block is not None
               and buffers.id_buffer.shape[0] >= BLOCK_TILE_MIN_TRIS)
    if blocked:
        bh, bw = block
        origin = block_tile(origin, n_rows, width, bh, bw)
        direction = block_tile(direction, n_rows, width, bh, bw)
        ndc = block_tile(ndc, n_rows, width, bh, bw)
    mat = build_material_table(buffers, world_geom)
    n = origin.shape[0]
    # Primary rays replace the reference's watertight raster pass
    # (pathtracerWGL2.js vertex stage), so they use the relaxed edge
    # window; bounce rays (traverse_soa below) keep the fragment
    # shader's exact +BIAS window (glsl:134-136).
    primary = traverse_fn(origin, direction, edge=-BIAS)
    covered = primary.triangle != -1

    # Large material tables (> the one-hot threshold) fetch via row
    # gathers, and large ray counts shade on [G, 1024] 2-D shapes where
    # the [C, G, 1024] rows of fetch_rows_t are leading-dim slices.
    use2d = mat.shape[0] > 256 or n >= SHADE_2D_MIN_RAYS
    if use2d:
        pad2 = (-n) % 1024
        g2 = (n + pad2) // 1024

        def to2d(x, fill=0.0):
            return jnp.pad(x, (0, pad2), constant_values=fill).reshape(g2, 1024)

        def to1d(x):
            return x.reshape(-1)[:n]
    else:
        g2 = n
        to2d = lambda x, fill=0.0: x
        to1d = lambda x: x

    psuv = primary.suv.T
    # padded rays: tri = -1 -> dead from the first bounce
    primary_parts = (to2d(psuv[0]), to2d(psuv[1]), to2d(psuv[2]),
                     to2d(primary.triangle, -1))
    dflat = v3.unstack3(direction)
    direction3 = tuple(to2d(c) for c in dflat)
    ndct = ndc.T
    ndc2 = (to2d(ndct[0]), to2d(ndct[1]))

    def _flat3(x3):
        return jnp.stack([c.reshape(-1) for c in x3], axis=-1)

    rshape = (g2, 1024) if use2d else (n,)

    def traverse_soa(o3, d3):
        hit = traverse_fn(_flat3(o3), _flat3(d3))
        hsuv = hit.suv.T
        return (hsuv[0].reshape(rshape), hsuv[1].reshape(rshape),
                hsuv[2].reshape(rshape), hit.triangle.reshape(rshape))

    def shadow_soa(o3, d3, max_len):
        return shadow_fn(_flat3(o3), _flat3(d3),
                         max_len.reshape(-1)).reshape(rshape)

    zero = jnp.zeros(rshape, dtype=jnp.float32)
    one = jnp.ones(rshape, dtype=jnp.float32)
    aux = (
        (zero, zero, zero, zero),   # render_id
        (zero, zero, zero, zero),   # original_id accumulation
        zero,                       # glassFilter
        zero,                       # originalRMEx
        zero,                       # originalTPOx
        one,                        # firstRayLength
    )
    total = (zero, zero, zero)
    original_color = (one, one, one)
    original_tpo_x = zero

    hit_record = [] if with_trace_hints else None
    n_local = config.samples_per_ray if local_samples is None else local_samples
    for s in range(n_local):
        cos_sample_n = jnp.cos(jnp.float32(s) + sample_offset)
        rec = hit_record if s == n_local - 1 else None
        color, original_color, original_tpo_x, aux = light_trace(
            buffers, mat, primary_parts, camera_pos, direction3, ndc2,
            cos_sample_n, config, random_seed, traverse_soa, shadow_soa, aux,
            hit_record=rec)
        total = v3.add3(total, color)
    final_color = v3.scale3(total, 1.0 / config.samples_per_ray)

    render_id, _original_id_acc, glass, original_rme_x, original_tpo_x, first_ray_length = aux
    rid3 = render_id[3] + INV_255  # glsl:637

    # Primary-hit local position for the location id channel (glsl:641-642)
    ptri = jnp.maximum(primary_parts[3], 0)
    lrow = fetch_rows_t(buffers.geometry, ptri)     # [12, ...rshape]
    puvw = (1.0 - primary_parts[1] - primary_parts[2],
            primary_parts[1], primary_parts[2])
    rel_pos = (zero, zero, zero)
    for k in range(3):
        lv = (lrow[3 * k], lrow[3 * k + 1], lrow[3 * k + 2])
        rel_pos = v3.add3(rel_pos, v3.scale3(lv, puvw[k]))
    cam3 = tuple(jnp.broadcast_to(camera_pos[c], rshape) for c in range(3))
    div = jnp.maximum(2.0 * v3.norm3(v3.sub3(rel_pos, cam3)), 1e-30)
    loc3 = tuple(to1d(jnp.mod(rel_pos[c], div) / div) for c in range(3))

    final_color = tuple(to1d(c) for c in final_color)
    original_color = tuple(to1d(c) for c in original_color)
    render_id = tuple(to1d(c) for c in render_id)
    rid3 = to1d(rid3)
    glass = to1d(glass)
    original_rme_x = to1d(original_rme_x)
    original_tpo_x = to1d(original_tpo_x)
    first_ray_length = to1d(first_ray_length)

    cov = covered
    covf = cov[:, None]
    zero3 = jnp.zeros((n, 3), dtype=jnp.float32)
    render_id4 = jnp.stack(
        [render_id[0], render_id[1], render_id[2], rid3], axis=-1)
    location_id4 = jnp.stack(
        [loc3[0], loc3[1], loc3[2], jnp.full((n,), INV_255)], axis=-1)
    mrt = MRT(
        color=jnp.where(covf, v3.stack3(final_color), zero3),
        glass=jnp.where(cov, glass, 0.0),
        original_color=jnp.where(covf, v3.stack3(original_color), zero3),
        original_w=jnp.where(cov, jnp.minimum(original_rme_x, first_ray_length) + INV_255, 0.0),
        render_id=jnp.where(covf, render_id4, jnp.zeros((n, 4))),
        original_id_w=jnp.where(cov, original_tpo_x + INV_255, 0.0),
        location_id=jnp.where(covf, location_id4, jnp.zeros((n, 4))),
        alpha=cov.astype(jnp.float32),
    )
    if blocked:
        mrt = jax.tree.map(
            lambda x: block_untile(x, n_rows, width, bh, bw), mrt)
    extras = []
    if with_raw_aux:
        raw = (original_rme_x, first_ray_length)
        if blocked:
            raw = tuple(block_untile(x, n_rows, width, bh, bw) for x in raw)
        extras.append(raw)
    if with_trace_hints:
        hints_out = tuple(to1d(h) for h in hit_record)
        if blocked:
            hints_out = tuple(block_untile(h, n_rows, width, bh, bw)
                              for h in hints_out)
        extras.append(hints_out)
    if extras:
        return (mrt, *extras)
    return mrt
