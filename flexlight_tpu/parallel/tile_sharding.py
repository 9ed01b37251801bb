"""Multi-device rendering: image-tile x sample sharding over a device mesh.

The reference is single-GPU; its per-pixel SIMT parallelism (SURVEY §2.5)
scales across devices here as a 2D `jax.sharding.Mesh`:

- 'tile' axis — data parallelism over horizontal image strips. Each device
  traces camera rays for its own rows against the replicated scene; strips
  are assembled with an all_gather.
- 'sample' axis — the per-pixel sample loop (glsl:610-614) split across
  devices; radiance is averaged with a psum.

Post-processing (temporal + the 7x7-ish denoise stencils + FXAA/TAA) runs
on the gathered image in `frame_pipeline_sharded`. The stencil radius is
dynamic per pixel (first_filter.glsl:101), so a halo exchange needs a
bound: `frame_pipeline_sharded_halo` keeps post strip-sharded and
exchanges `required_post_halo(config)` rows with its neighbours by
ppermute.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.pathtrace import MRT, render_mrt


def make_mesh(n_tile: int, n_sample: int = 1, devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    need = n_tile * n_sample
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    arr = np.array(devices[:need]).reshape(n_tile, n_sample)
    return Mesh(arr, axis_names=("tile", "sample"))


def required_post_halo(config) -> int:
    """Worst-case cross-pixel read reach of any single lifted post pass.

    The denoise blur offset is ivec2(stencil * scale) with scale bounded
    per filter (pathtracer_first_filter.glsl:101, second:50, final:56);
    the exact per-filter maxima come from post.filters.offset_table. FXAA reads at most search-step 6 of the 3x3-blur
    image = 7 rows (fxaa.js:119-130); TAA's neighborhood clamp reads 1.
    The halo pipeline is exact iff every pass reach fits its halo, and a
    one-hop ppermute bounds halo <= rows_local."""
    need = 0
    if config.filter:
        from ..post.filters import (FINAL_BOUNDS, FIRST_BOUNDS,
                                    SECOND_BOUNDS, offset_table)

        if config.first_passes > 0:
            need = max(need, offset_table("disc37", *FIRST_BOUNDS)[1], 1)
        if config.second_passes > 0:
            need = max(need, offset_table("disc36", *SECOND_BOUNDS)[1])
        need = max(need, offset_table("disc37", *FINAL_BOUNDS)[1])
    if config.antialiasing == "fxaa":
        need = max(need, 7)
    elif config.antialiasing == "taa":
        need = max(need, 1)
    return need


def tileize_blur_key_sharded(ocolor, row0, height: int, axis_name: str,
                             ty: int = 32, tx: int = 128):
    """post.common.tileize_blur_key on row strips, exactly matching the
    single-chip global (ty, tx) grid anchored at the image origin.

    Each shard reduces its rows into the global tile-row bins it overlaps
    (segment_sum over traced global tile indices), a psum completes tiles
    that straddle strip boundaries, and each shard reads back the means
    for its own rows. The psum payload is the [ceil(H/ty), ceil(W/tx)]
    stat grid — a few KB, not an image."""
    from ..post.common import quantize_rgba8

    w = ocolor[..., 3]
    rows_local, wd = w.shape
    wp = -(-wd // tx) * tx
    wpad = jnp.pad(w, ((0, 0), (0, wp - wd)))
    cols = wpad.reshape(rows_local, wp // tx, tx)
    nz = cols > 0.0
    s_col = jnp.sum(jnp.where(nz, cols, 0.0), axis=2)     # [rows, ntx]
    c_col = jnp.sum(nz, axis=2).astype(jnp.float32)
    gtr = (row0 + jnp.arange(rows_local, dtype=jnp.int32)) // ty
    ntr = -(-height // ty)
    s_t = jax.ops.segment_sum(s_col, gtr, num_segments=ntr)
    c_t = jax.ops.segment_sum(c_col, gtr, num_segments=ntr)
    s_t = jax.lax.psum(s_t, axis_name)
    c_t = jax.lax.psum(c_t, axis_name)
    mean = quantize_rgba8(s_t / jnp.maximum(c_t, 1.0))    # [ntr, ntx]
    mean_rows = mean[gtr]                                  # [rows, ntx]
    mean_full = jnp.repeat(mean_rows, tx, axis=1)[:, :wd]
    new_w = jnp.where(w > 0.0, mean_full, 0.0)
    return jnp.concatenate([ocolor[..., 0:3], new_w[..., None]], axis=-1)


def render_mrt_sharded(buffers, width: int, height: int, camera_pos,
                       view_matrix, config, random_seed, mesh: Mesh,
                       scheme: str = "scan", tile: int = 1024) -> MRT:
    """Render the full-frame MRT with rows sharded over 'tile' and the
    sample loop over 'sample'. Returns replicated flat [H*W] MRT."""
    n_tile = mesh.shape["tile"]
    n_sample = mesh.shape["sample"]
    if height % n_tile != 0:
        raise ValueError(f"height {height} not divisible by tile axis {n_tile}")
    if config.samples_per_ray % n_sample != 0:
        raise ValueError("samples_per_ray not divisible by sample axis")
    rows_local = height // n_tile
    samples_local = config.samples_per_ray // n_sample

    def shard_fn(buffers, camera_pos, view_matrix, random_seed):
        ti = jax.lax.axis_index("tile")
        si = jax.lax.axis_index("sample")
        mrt, (rme_x, frl) = render_mrt(
            buffers, width, height, camera_pos, view_matrix, config,
            random_seed, scheme=scheme, tile=tile,
            row0=ti * rows_local, rows=rows_local,
            sample_offset=si.astype(jnp.float32) * samples_local,
            local_samples=samples_local, with_raw_aux=True)

        # Cross-sample combine matching the reference's sequential sample
        # loop over shader globals (glsl:84-89, 555-576):
        #  - renderId.xyz, originalId.w base (originalTPOx is overwrite —
        #    see below), glassFilter, originalRMEx: `+=` across samples
        #  - originalColor, originalTPOx, renderId.w: overwritten each
        #    sample -> the globally-last sample (shard n_sample-1) wins
        #  - firstRayLength: running min across samples
        # The coverage mask and location channels are sample-independent.
        def sum_s(x):
            return jax.lax.psum(x, "sample")

        def last_s(x):
            sel = (si == n_sample - 1).astype(x.dtype)
            return jax.lax.psum(x * (sel if x.ndim == 1 else sel[..., None]),
                                "sample")

        color = sum_s(mrt.color)
        glass = sum_s(mrt.glass)
        cov = mrt.alpha > 0.0
        # original_w = min(rme accumulated over ALL samples, min frl)
        # (glsl:635) — folded here from the raw channels.
        rme_total = sum_s(rme_x)
        frl_min = jax.lax.pmin(frl, "sample")
        original_w = jnp.where(
            cov, jnp.minimum(rme_total, frl_min) + np.float32(1.0 / 255.0), 0.0)
        render_id = jnp.concatenate(
            [sum_s(mrt.render_id[..., 0:3]), last_s(mrt.render_id[..., 3:4])],
            axis=-1)
        out = MRT(
            color=color,
            glass=glass,
            original_color=last_s(mrt.original_color),
            original_w=original_w,
            render_id=render_id,
            original_id_w=last_s(mrt.original_id_w),
            location_id=last_s(mrt.location_id),
            alpha=last_s(mrt.alpha),
        )
        # Assemble image strips across the tile axis (ICI all_gather)
        return jax.tree.map(
            lambda x: jax.lax.all_gather(x, "tile", axis=0, tiled=True), out)

    # check_vma=False: traversal scan carries start from constants
    # (min_len=POW32), which the varying-manual-axes checker would force
    # through pcast on every carry leg; the function is replication-safe
    # by construction (same scene on every shard, per-shard ray strips).
    fn = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(), P(), P(), P()),
        out_specs=P(),
        check_vma=False,
    )
    return fn(buffers, camera_pos, view_matrix, random_seed)


@partial(jax.jit, static_argnames=("width", "height", "config", "mesh",
                                   "scheme", "tile"))
def frame_pipeline_sharded(buffers, cam_pos, view, random_seed,
                           temporal_state, taa_state, width: int, height: int,
                           config, mesh: Mesh, scheme: str = "scan",
                           tile: int = 1024):
    """Full multi-chip frame: sharded pathtrace + replicated post.

    Mirrors models.pathtracer.frame_pipeline with the MRT pass distributed.
    """
    from ..models.pathtracer import postprocess_mrt

    mrt = render_mrt_sharded(buffers, width, height, cam_pos, view, config,
                             random_seed, mesh, scheme=scheme, tile=tile)
    return postprocess_mrt(mrt, temporal_state, taa_state, width, height, config)


@partial(jax.jit, static_argnames=("width", "height", "config", "mesh",
                                   "scheme", "tile", "halo", "check_halo"))
def frame_pipeline_sharded_halo(buffers, cam_pos, view, random_seed,
                                temporal_state, taa_state,
                                width: int, height: int, config, mesh: Mesh,
                                scheme: str = "scan", tile: int = 1024,
                                halo: int = 32, check_halo: bool = True):
    """Fully-sharded frame: pathtrace AND post-processing stay strip-sharded.

    Temporal accumulation is pointwise per strip; the denoise stencils and
    FXAA exchange `halo` boundary rows with mesh neighbors via ppermute
    (parallel.halo) instead of all_gathering frames. Identical to the
    single-chip pipeline wherever the per-pixel stencil radius fits the
    halo. Only the final RGB strips (and updated history strips) are
    gathered. 1D 'tile' mesh.
    """
    from ..models.pathtracer import _filter_chain, _quantized_mrt
    from ..ops.pathtrace import render_mrt
    from ..post.common import quantize_rgba8, split_hdr
    from ..post.fxaa import fxaa
    from ..post.temporal import TemporalState, push_frame, temporal_average
    from .halo import with_halo

    n_tile = mesh.shape["tile"]
    if height % n_tile != 0:
        raise ValueError(f"height {height} not divisible by tile axis {n_tile}")
    rows_local = height // n_tile
    # Exactness guard: every lifted pass must fit its stencil reach in the
    # halo, and a one-hop ppermute reaches at most the adjacent strip. If
    # the config's worst-case reach exceeds rows_local (fine meshes /
    # wide-radius filters), fall back to the all_gather-post pipeline
    # rather than silently truncating the stencil. check_halo=False keeps
    # the halo path for callers that know their scene's DATA reach fits
    # the given halo (the bound is the config's worst case, not the
    # frame's; blur radii are data-dependent).
    if check_halo:
        need = required_post_halo(config)
        if need > rows_local:
            return frame_pipeline_sharded(
                buffers, cam_pos, view, random_seed, temporal_state,
                taa_state, width=width, height=height, config=config,
                mesh=mesh, scheme=scheme, tile=tile)
        halo = max(halo, need)
    # One-hop ppermute reaches at most the adjacent strip
    halo = min(halo, rows_local)
    use_aa = config.antialiasing in ("fxaa", "taa")

    def shard_fn(buffers, cam_pos, view, random_seed, temporal_state, taa_state):
        ti = jax.lax.axis_index("tile")
        row0 = ti * rows_local
        mrt = render_mrt(buffers, width, height, cam_pos, view, config,
                         random_seed, scheme=scheme, tile=tile,
                         row0=row0, rows=rows_local)
        color, alpha, color_q, ip_q, id_q, oid_q, ocolor_q = _quantized_mrt(
            mrt, rows_local, width)
        # fast-mode blur-key quantizer on the single-chip global grid
        # (psum-completed tiles straddling strip boundaries)
        tileize = partial(tileize_blur_key_sharded, row0=row0, height=height,
                          axis_name="tile")

        # slice this shard's strip of the (replicated) history ring
        my_state = jax.tree.map(
            lambda x: jax.lax.dynamic_slice_in_dim(x, row0, rows_local, axis=1),
            temporal_state)

        display = None
        if config.temporal:
            my_state = push_frame(my_state, color_q, ip_q, id_q, oid_q)
            t_color, t_glass, center_w = temporal_average(my_state)
            if config.filter:
                frac_q, high_q = split_hdr(t_color)
                r0 = jnp.concatenate([frac_q, center_w[..., None]], axis=-1)
                ip0 = jnp.concatenate(
                    [high_q, quantize_rgba8(t_glass)[..., None]], axis=-1)
                display = _filter_chain(
                    config, r0, ip0, ocolor_q, id_q, oid_q,
                    lift=lambda f: with_halo(f, halo, "tile"),
                    tileize=tileize)
            else:
                display = jnp.clip(t_color, 0.0, 1.0)
                if use_aa:
                    display = quantize_rgba8(display)
        elif config.filter:
            display = _filter_chain(
                config, color_q, ip_q, ocolor_q, id_q, oid_q,
                lift=lambda f: with_halo(f, halo, "tile"),
                tileize=tileize)
        else:
            direct = color * mrt.original_color.reshape(rows_local, width, 3)
            display = jnp.clip(direct, 0.0, 1.0)

        new_taa = taa_state
        if use_aa:
            aa_in = jnp.concatenate(
                [quantize_rgba8(display),
                 (alpha.reshape(rows_local, width) > 0).astype(jnp.float32)[..., None]],
                axis=-1)
            if config.antialiasing == "fxaa":
                display = with_halo(fxaa, halo, "tile")(aa_in)[..., 0:3]
            else:
                # TAA: the 3x3 clip-clamp is the only cross-pixel read
                # (history averaging is pointwise), so only the clamp needs
                # a 1-row halo; history strips stay local.
                from ..post.taa import neighborhood_clamp, taa_apply
                from .halo import exchange_halo

                my_taa = jax.tree.map(
                    lambda x: jax.lax.dynamic_slice_in_dim(
                        x, row0, rows_local, axis=1), taa_state)
                padded = exchange_halo(aa_in, 1, "tile")
                mn, mx = neighborhood_clamp(padded)
                out, my_taa = taa_apply(my_taa, aa_in,
                                        clamp=(mn[1:-1], mx[1:-1]))
                display = out[..., 0:3]
                new_taa = my_taa

        display = jnp.clip(display, 0.0, 1.0)
        gather = lambda x, axis: jax.lax.all_gather(x, "tile", axis=axis, tiled=True)
        new_state = jax.tree.map(lambda x: gather(x, 1), my_state)
        if config.antialiasing == "taa":
            new_taa = jax.tree.map(lambda x: gather(x, 1), new_taa)
        return gather(display, 0), new_state, new_taa

    fn = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(), P()),
        out_specs=P(),
        check_vma=False,
    )
    display, new_temporal, new_taa = fn(buffers, cam_pos, view, random_seed,
                                        temporal_state, taa_state)
    return display, new_temporal, new_taa
