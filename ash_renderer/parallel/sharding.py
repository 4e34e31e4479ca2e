"""Multi-device rendering: shard the framebuffer tile grid across a device mesh.

The reference is strictly single-GPU (SURVEY §2's parallelism inventory: no
DP/TP/PP/SP, no communication backend); scale-out here is new design.  The
natural decomposition for a rasterizer is data parallelism over pixels:
each device owns a horizontal slab of framebuffer tile rows.

  * Geometry (vertex transform + clip + setup) is replicated — it is a small
    fraction of frame cost and replicating it avoids an all_gather of the
    setup buffers that every slab needs anyway.
  * Binning runs per-device against its own tile-row window (the window
    parameter of ops/binning.bin_triangles), so each device sorts and
    streams only the triangles that touch its slab.
  * The visibility kernel and deferred shading run on slab-local buffers;
    no cross-device communication exists at all until the final frame
    assembly, which is a pure all_gather of RGBA8 rows (over NVLink between
    GPUs) — the cheapest possible collective pattern (compositing needs no
    depth merge because slabs partition the screen).

Implemented with shard_map over a 1-D Mesh("rows"); jit of the wrapper
inserts the all_gather.  Works identically on N GPUs or the CPU
xla_force_host_platform_device_count mesh used in tests.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import binning, geometry, raster_pallas, shade


def make_render_mesh(devices=None) -> Mesh:
    devices = devices or jax.devices()
    return Mesh(np.array(devices), axis_names=("rows",))


def _slab_pipeline(
    statics,
    rows_per: int,
    positions, vert_obj, normals, colors, uvs,
    tri_v, tri_obj, obj_material,
    model_mats, mvp_mats, camera_pos,
    materials, atlas, light,
):
    """Per-device body (runs under shard_map): renders this device's slab.

    rows_per: tile rows per slab = ceil(grid_h / n_dev) — when grid_h is
    not divisible the last slab(s) extend past the screen; their windowed
    binning keys are all dead (py_lo > py_hi) so they render background,
    and the wrapper crops the assembled frame back to the display height."""
    cfg = statics.cfg
    st = statics.settings
    dev = jax.lax.axis_index("rows")
    tile_row0 = dev * rows_per

    clip, attrs = geometry.transform_vertices(
        positions, vert_obj, normals, colors, uvs, model_mats, mvp_mats
    )
    su, attrs_full, gstats = geometry.geometry_device(
        clip, attrs, tri_v, tri_obj, obj_material, cfg, st.clip_budget,
    )
    # Windowed binning: static window size (rows_per), traced row origin.
    # Each slab gets the FULL pair budget: a slab's pairs are a subset of the
    # full frame's, so any scene that fits the single-device budget fits every
    # slab's — dividing by n_dev could overflow a slab that concentrates the
    # geometry while the single-device path does not, silently breaking the
    # sharded == single-device bitwise contract.
    records, tile_start, tile_count, bstats = binning.bin_triangles(
        su, cfg, st.max_pairs, tile_row0, rows_per
    )
    vis_d, vis_t = raster_pallas.rasterize_visibility(
        records, tile_start, tile_count, cfg,
        interpret=statics.interpret, tile_rows=rows_per,
    )
    rgba = shade.shade(
        jnp,
        vis_t,
        su,
        attrs_full,
        materials=materials if statics.has_materials else None,
        atlas=atlas if statics.has_atlas else None,
        light=light if statics.has_light else None,
        camera_pos=camera_pos,
        cfg=cfg,
        clear_color=st.clear_color,
        py_offset=tile_row0 * cfg.tile_h,
    )
    rgba8 = shade.resolve_and_pack(jnp, rgba, st.supersample, st.srgb_output)
    # surface per-slab budget overflows (worst across slabs via the replicated
    # max below) instead of discarding them — a slab overflow means dropped
    # triangles and must be visible to debugging.validate_frame
    overflow = {
        "pairs_overflow": jax.lax.pmax(bstats["pairs_overflow"], "rows"),
        "clip_overflow": gstats["clip_overflow"],  # replicated geometry
    }
    return rgba8, overflow


def render_frame_sharded(
    statics,
    mesh: Mesh,
    positions, vert_obj, normals, colors, uvs,
    tri_v, tri_obj, obj_material,
    model_mats, mvp_mats, camera_pos,
    materials=None, atlas=None, light=None,
):
    """Full-frame multi-device render.  The framebuffer comes back sharded
    over mesh axis "rows" (display-resolution rows); jax assembles on
    readback.  Returns (rgba8, stats) with stats["pairs_overflow"] = the
    worst per-slab pair-budget overflow (0 means no triangles were dropped
    anywhere) and stats["clip_overflow"].

    Indivisible grid_h is padded up (past-the-screen slab rows render
    background and are cropped from the assembled frame), so ANY
    resolution works on any device count.
    """
    n_dev = mesh.devices.size
    cfg = statics.cfg
    rows_per = -(-cfg.grid_h // n_dev)
    slab_disp_rows = rows_per * cfg.tile_h
    if slab_disp_rows % statics.settings.supersample:
        raise ValueError("slab rows not divisible by supersample factor")

    body = functools.partial(_slab_pipeline, statics, rows_per)
    spec_repl = P()
    fn = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=tuple([spec_repl] * 14),
        out_specs=(P("rows", None, None), spec_repl),
        check_vma=False,
    )
    rgba8, overflow = fn(
        positions, vert_obj, normals, colors, uvs,
        tri_v, tri_obj, obj_material,
        model_mats, mvp_mats, camera_pos,
        materials, atlas, light,
    )
    return rgba8[: statics.settings.height], overflow
