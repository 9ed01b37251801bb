"""Edge-aware denoise filter passes.

Counterparts of the reference's three filter kernels, ported
arithmetic-for-arithmetic (the id-equality gates are load-bearing for
output parity):

- first_filter  — shadow-vote repair on the 4-neighborhood + 37-tap disc
  blur with radius (1+w)^2*3.5 (pathtracer_first_filter.glsl:18-124)
- second_filter — 36-tap disc blur, radius 1+2*tanh(ow + oidw*4), separate
  original-color accumulation for glass (pathtracer_second_filter.glsl)
- final_filter  — 37-tap blur, first-hit albedo multiply, Reinhard+gamma
  (pathtracer_final_filter.glsl)

All passes are jnp gathers + elementwise math over [H, W, 4] quantized
images; the variable per-pixel radius becomes a dynamic gather.
"""

from __future__ import annotations

from functools import lru_cache

import jax.numpy as jnp
import numpy as np

from .common import (INV_256, gather, gather_multi, quantize_rgba8,
                     reinhard_gamma, shifted)

# 4-neighborhood (first_filter.glsl:36-40)
STENCIL1 = np.array([[-1, 0], [0, -1], [0, 1], [1, 0]], dtype=np.int32)

# 37-tap disc (first_filter.glsl:50-58)
STENCIL3 = np.array([
    [-3, -1], [-3, 0], [-3, 1],
    [-2, -2], [-2, -1], [-2, 0], [-2, 1], [-2, 2],
    [-1, -3], [-1, -2], [-1, -1], [-1, 0], [-1, 1], [-1, 2], [-1, 3],
    [0, -3], [0, -2], [0, -1], [0, 0], [0, 1], [0, 2], [0, 3],
    [1, -3], [1, -2], [1, -1], [1, 0], [1, 1], [1, 2], [1, 3],
    [2, -2], [2, -1], [2, 0], [2, 1], [2, 2],
    [3, -1], [3, 0], [3, 1],
], dtype=np.float32)

# 36-tap disc: STENCIL3 without the center (second_filter.glsl:40-48)
STENCIL3_NO_CENTER = np.array([r for r in STENCIL3 if not (r[0] == 0 and r[1] == 0)],
                              dtype=np.float32)

# scale bounds per filter (see the scale formulas below):
#   first : (1 + ow)^2 * 3.5, ow in [0, 1]        -> [3.5, 14]
#   second: 1 + 2*tanh(x), x >= 0                  -> [1, 3)
#   final : 0.7 + 2*tanh(x), x >= 0                -> [0.7, 2.7)
FIRST_BOUNDS = (3.5, 14.0)
SECOND_BOUNDS = (1.0, 3.0)
FINAL_BOUNDS = (0.7, 2.7)


@lru_cache(maxsize=None)
def offset_table(stencil_key: str, smin: float, smax: float):
    """Enumerate the distinct integer offsets the scaled stencil can
    produce for scale in [smin, smax].

    Each tap's offset trunc(s * scale) is a monotone staircase of scale,
    so a tap reaches each offset over one contiguous scale interval; the
    table records, per offset, the taps that can reach it and the union
    of their intervals. The sharded pipeline reads `max_radius` as the
    pass's worst-case halo.

    Returns (entries, max_radius, svals): entries = tuple of
    (oy, ox, union_lo, union_hi, taps) sorted by (oy, ox) with taps a
    tuple of (sy, sx, tap_lo, tap_hi); svals = distinct |s| stencil
    magnitudes."""
    stencil = {"disc37": STENCIL3, "disc36": STENCIL3_NO_CENTER}[stencil_key]
    ts = np.linspace(smin, smax, 400001).astype(np.float32)
    margin = float(ts[1] - ts[0]) * 2.0
    offs = {}
    max_r = 0
    for sy, sx in stencil.astype(np.float32):
        dy = np.trunc(sy * ts).astype(np.int64)
        dx = np.trunc(sx * ts).astype(np.int64)
        code = dy * 100000 + dx
        change = np.flatnonzero(np.diff(code)) + 1
        starts = np.concatenate([[0], change])
        ends = np.concatenate([change - 1, [len(ts) - 1]])
        for s0, s1 in zip(starts, ends):
            oy, ox = int(dy[s0]), int(dx[s0])
            lo, hi = float(ts[s0]) - margin, float(ts[s1]) + margin
            e = offs.setdefault((oy, ox), [np.inf, -np.inf, []])
            e[0] = min(e[0], lo)
            e[1] = max(e[1], hi)
            e[2].append((int(sy), int(sx), lo, hi))
            max_r = max(max_r, abs(oy), abs(ox))
    entries = tuple(
        (oy, ox, lo, hi, tuple(taps))
        for (oy, ox), (lo, hi, taps) in sorted(offs.items()))
    svals = tuple(sorted({abs(int(s)) for s in stencil.flatten() if s != 0}))
    return entries, max_r, svals


def _scaled_offsets(stencil: np.ndarray, scale: jnp.ndarray):
    """ivec2(stencil * scale) per pixel: truncation toward zero like GLSL
    float->int conversion. scale: [H, W] -> dy, dx: [H, W, K] int32."""
    s = stencil[None, None, :, :] * scale[:, :, None, None]
    s = jnp.trunc(s).astype(jnp.int32)
    return s[..., 0], s[..., 1]


def vote_repair(color, ip, ocolor, ids, oid):
    """Shadow-vote repair on the static 4-neighborhood
    (first_filter.glsl:60-94) -> (render_id, render_ip_w). The offsets
    are static, so these are static shifts, not gathers."""
    center_id = ids
    center_oid = oid

    render_id = center_id
    render_ip_w = ip[..., 3]

    # neighbor stacks [H, W, tap, ch] (gather layout)
    n_ids = jnp.stack([shifted(ids, int(r[0]), int(r[1])) for r in STENCIL1],
                      axis=2)
    n_oids = jnp.stack([shifted(oid, int(r[0]), int(r[1])) for r in STENCIL1],
                       axis=2)
    n_ipws = jnp.stack(
        [shifted(ip[..., 3], int(r[0]), int(r[1])) for r in STENCIL1], axis=2)

    votes = []
    for i in range(4):
        v = jnp.where(n_ipws[..., i] == 0.0, 1, 0)
        match_center = (jnp.all(n_ids[..., i, 0:3] == center_id[..., 0:3], axis=-1)
                        & jnp.all(n_oids[..., i, :] == center_oid, axis=-1))
        v = v + jnp.where((n_ipws[..., i] == 0.0) & match_center, 1, 0)
        for j in range(i + 1, 4):
            pair = (jnp.all(n_ids[..., i, 0:3] == n_ids[..., j, 0:3], axis=-1)
                    & jnp.all(n_oids[..., i, :] == n_oids[..., j, :], axis=-1))
            v = v + jnp.where((n_ipws[..., i] == 0.0) & pair, 1, 0)
        votes.append(v)
    votes = jnp.stack(votes, axis=-1)  # [H, W, 4]

    max_vote = votes[..., 0]
    id_number = jnp.zeros_like(max_vote)
    for i in range(1, 4):
        better = votes[..., i] >= max_vote
        max_vote = jnp.where(better, votes[..., i], max_vote)
        id_number = jnp.where(better, i, id_number)

    voted_id = jnp.take_along_axis(n_ids, id_number[..., None, None].astype(jnp.int32),
                                   axis=2)[..., 0, :]
    repair = (center_oid[..., 3] != 0.0) & (ip[..., 3] != 0.0)
    render_id = jnp.where(repair[..., None], voted_id, render_id)
    render_ip_w = jnp.where(
        repair, jnp.maximum(1.0 - jnp.sign(max_vote.astype(jnp.float32)), 0.0), render_ip_w)
    return render_id, render_ip_w


def first_filter(color, ip, ocolor, ids, oid):
    """(color, ip, id) <- shadow-vote repair + gated disc blur."""
    center_color = color
    center_ip = ip
    center_ocolor = ocolor
    center_id = ids
    center_oid = oid

    center_idw = jnp.round(center_id[..., 3] * 255.0).astype(jnp.int32)
    center_light = center_idw // 2
    center_shadow = center_idw % 2

    render_id, render_ip_w = vote_repair(color, ip, ocolor, ids, oid)

    # --- gated disc blur (glsl:96-117) ---
    scale = (1.0 + center_ocolor[..., 3]) ** 2 * 3.5
    dy3, dx3 = _scaled_offsets(STENCIL3, scale)
    b_id, b_oid, b_color, b_ip = gather_multi((ids, oid, color, ip), dy3, dx3)

    idw = jnp.round(b_id[..., 3] * 255.0).astype(jnp.int32)
    light = idw // 2
    shadow = idw % 2
    gate = (jnp.all(b_id[..., 0:3] == center_id[..., None, 0:3], axis=-1)
            & jnp.all(b_oid == center_oid[..., None, :], axis=-1)
            & ((center_light[..., None] != light) | (center_shadow[..., None] == shadow)))
    contrib = b_color[..., 0:3] + b_ip[..., 0:3] * 256.0
    blur_color = jnp.sum(jnp.where(gate[..., None], contrib, 0.0), axis=2)
    blur_count = jnp.sum(gate, axis=2).astype(jnp.float32)

    no_blur = center_ocolor[..., 3] == 0.0
    out_color3 = jnp.where(no_blur[..., None], center_color[..., 0:3], blur_color)
    count = jnp.where(no_blur, 1.0, jnp.maximum(blur_count, 1.0))

    inv = 1.0 / count[..., None]
    sgn = jnp.sign(center_color[..., 3:4])
    new_color = sgn * jnp.concatenate(
        [jnp.mod(out_color3 * inv, 1.0), center_color[..., 3:4]], axis=-1)
    new_ip = sgn * jnp.concatenate(
        [jnp.floor(out_color3 * inv) * INV_256, render_ip_w[..., None]], axis=-1)
    return quantize_rgba8(new_color), quantize_rgba8(new_ip), quantize_rgba8(render_id)


def second_filter(color, ip, ocolor, ids, oid):
    """(color, ip, ocolor) <- glass-aware disc blur (second_filter.glsl)."""
    center_color = color
    center_ip = ip
    center_ocolor = ocolor
    center_id = ids
    center_oid = oid

    acc_color = jnp.concatenate(
        [center_color[..., 0:3] + center_ip[..., 0:3] * 256.0,
         center_color[..., 3:4]], axis=-1)
    acc_ocolor = center_ocolor
    ipw = center_ip[..., 3]
    count = jnp.ones(color.shape[:2], dtype=jnp.float32)
    ocount = jnp.ones(color.shape[:2], dtype=jnp.float32)

    scale = 1.0 + 2.0 * jnp.tanh(center_ocolor[..., 3] + center_oid[..., 3] * 4.0)
    dy, dx = _scaled_offsets(STENCIL3_NO_CENTER, scale)
    b_id, b_oid, b_color, b_ip, b_ocolor = gather_multi(
        (ids, oid, color, ip, ocolor), dy, dx)

    oid_xyz_match = jnp.all(b_oid[..., 0:3] == center_oid[..., None, 0:3], axis=-1)
    full_id_match = jnp.all(b_id == center_id[..., None, :], axis=-1)
    id_xyz_match = jnp.all(b_id[..., 0:3] == center_id[..., None, 0:3], axis=-1)
    glassy = (jnp.minimum(center_oid[..., None, 3], b_oid[..., 3]) > 0.1) \
        & (full_id_match | (jnp.maximum(b_ip[..., 3], center_ip[..., None, 3]) >= 0.1))

    branch_a = oid_xyz_match & glassy
    branch_b = oid_xyz_match & ~glassy & id_xyz_match
    add_color = branch_a | branch_b

    contrib = jnp.concatenate(
        [b_color[..., 0:3] + b_ip[..., 0:3] * 256.0, b_color[..., 3:4]], axis=-1)
    acc_color = acc_color + jnp.sum(jnp.where(add_color[..., None], contrib, 0.0), axis=2)
    count = count + jnp.sum(add_color, axis=2)
    ipw = ipw + jnp.sum(jnp.where(branch_a, b_ip[..., 3], 0.0), axis=2)
    acc_ocolor = acc_ocolor + jnp.sum(jnp.where(branch_a[..., None], b_ocolor, 0.0), axis=2)
    ocount = ocount + jnp.sum(branch_a, axis=2)

    inv = 1.0 / count[..., None]
    cw = center_color[..., 3:4]
    new_color = cw * jnp.concatenate(
        [jnp.mod(acc_color[..., 0:3] * inv, 1.0), acc_color[..., 3:4] * inv], axis=-1)
    new_ip = cw * jnp.concatenate(
        [jnp.floor(acc_color[..., 0:3] * inv) * INV_256, ipw[..., None]], axis=-1)
    new_ocolor = cw * acc_ocolor / ocount[..., None]
    return quantize_rgba8(new_color), quantize_rgba8(new_ip), quantize_rgba8(new_ocolor)


def final_filter(color, ip, ocolor, ids, oid, hdr: bool):
    """Final blur + first-hit albedo multiply + tone map -> [H,W,3] in [0,1]."""
    center_color = color
    center_ip = ip
    center_ocolor = ocolor
    center_id = ids
    center_oid = oid

    scale = 0.7 + 2.0 * jnp.tanh(center_ocolor[..., 3] + center_oid[..., 3] * 4.0)
    dy, dx = _scaled_offsets(STENCIL3, scale)
    b_id, b_oid, b_color, b_ip, b_ocolor = gather_multi(
        (ids, oid, color, ip, ocolor), dy, dx)

    blur_translucent = (jnp.maximum(b_ip[..., 3], center_ip[..., None, 3]) != 0.0) \
        & (jnp.minimum(center_oid[..., None, 3], b_oid[..., 3]) > 0.0)
    oid_xyz_match = jnp.all(b_oid[..., 0:3] == center_oid[..., None, 0:3], axis=-1)
    id_xyz_match = jnp.all(b_id[..., 0:3] == center_id[..., None, 0:3], axis=-1)

    o_gate = blur_translucent & oid_xyz_match
    ocolor_sum = jnp.sum(jnp.where(o_gate[..., None], b_ocolor, 0.0), axis=2)
    ocount = jnp.sum(o_gate, axis=2).astype(jnp.float32)

    c_gate = (blur_translucent | id_xyz_match) & oid_xyz_match
    contrib = b_color + b_ip * 255.0  # note: 255, not 256 (final_filter.glsl:51)
    color_sum = jnp.sum(jnp.where(c_gate[..., None], contrib, 0.0), axis=2)
    count = jnp.sum(c_gate, axis=2).astype(jnp.float32)

    final = color_sum[..., 0:3] / jnp.maximum(count, 1.0)[..., None]
    o_final = jnp.where((ocount == 0.0)[..., None], center_ocolor[..., 0:3],
                        ocolor_sum[..., 0:3] / jnp.maximum(ocount, 1.0)[..., None])
    final = final * o_final
    if hdr:
        final = reinhard_gamma(final)
    covered = center_color[..., 3] > 0.0
    return jnp.where(covered[..., None], jnp.clip(final, 0.0, 1.0), 0.0)
