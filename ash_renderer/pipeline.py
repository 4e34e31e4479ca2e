"""The jitted frame pipeline: scene buffers + camera matrices -> RGBA8 frame.

This is the analogue of the reference's recorded draw command stream
(``src/renderer.rs:466-568``): one compiled function per (resolution,
settings) world, traced once and reused every frame; the only per-frame
host->device traffic is the camera/model matrices (the reference's 192-byte
UBO write, ``renderer.rs:431-439``).

Stages: vertex transform -> clip/snap/cull setup -> tile binning -> Pallas
visibility raster -> deferred shading -> supersample resolve + RGBA8 pack.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .config import RasterConfig, RendererSettings
from .ops import binning, geometry, raster_pallas, shade
from .rtypes import LightPack, MaterialsPack

F32 = np.float32
I32 = np.int32


@dataclasses.dataclass(frozen=True)
class FrameStatics:
    """Static (hashable) configuration captured by the jit trace."""

    cfg: RasterConfig
    settings: RendererSettings
    has_materials: bool
    has_atlas: bool
    has_light: bool
    interpret: bool


def render_frame(
    statics: FrameStatics,
    positions,
    vert_obj,
    normals,
    colors,
    uvs,
    tri_v,
    tri_obj,
    obj_material,
    model_mats,
    mvp_mats,
    camera_pos,
    materials: Optional[MaterialsPack],
    atlas,
    light: Optional[LightPack],
    tri_mat=None,
):
    """Pure function of device arrays -> (rgba8, aux dict).  Jitted by the
    Renderer with `statics` as a static argument."""
    cfg = statics.cfg
    st = statics.settings

    clip, attrs = geometry.transform_vertices(
        positions, vert_obj, normals, colors, uvs, model_mats, mvp_mats
    )
    su, attrs_full, gstats = geometry.geometry_device(
        clip, attrs, tri_v, tri_obj, obj_material, cfg, st.clip_budget,
        tri_mat=tri_mat,
    )
    records, tile_start, tile_count, bstats = binning.bin_triangles(
        su, cfg, st.max_pairs
    )
    vis_d, vis_t = raster_pallas.rasterize_visibility(
        records, tile_start, tile_count, cfg, interpret=statics.interpret
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
    )
    rgba8 = shade.resolve_and_pack(jnp, rgba, st.supersample, st.srgb_output)
    aux = {
        "vis_d16": vis_d,
        "vis_tri": vis_t,
        **gstats,
        **bstats,
    }
    return rgba8, aux


render_frame_jit = jax.jit(render_frame, static_argnames=("statics",))


# ---------------------------------------------------------------------------
# Staged execution: four separately-jitted stages.  Identical results (every
# stage boundary is a materialized array anyway); the development-iteration
# mode (RendererSettings.staged_pipeline).
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("cfg", "clip_budget"))
def _stage_geometry(cfg, clip_budget, positions, vert_obj, normals, colors,
                    uvs, tri_v, tri_obj, obj_material, model_mats, mvp_mats,
                    tri_mat=None):
    clip, attrs = geometry.transform_vertices(
        positions, vert_obj, normals, colors, uvs, model_mats, mvp_mats
    )
    return geometry.geometry_device(
        clip, attrs, tri_v, tri_obj, obj_material, cfg, clip_budget,
        tri_mat=tri_mat,
    )


@functools.partial(jax.jit, static_argnames=("cfg", "max_pairs"))
def _stage_binning(cfg, max_pairs, su):
    return binning.bin_triangles(su, cfg, max_pairs)


@functools.partial(jax.jit, static_argnames=("statics",))
def _stage_shade(statics, vis_t, su, attrs_full, camera_pos, materials, atlas,
                 light):
    st = statics.settings
    rgba = shade.shade(
        jnp,
        vis_t,
        su,
        attrs_full,
        materials=materials if statics.has_materials else None,
        atlas=atlas if statics.has_atlas else None,
        light=light if statics.has_light else None,
        camera_pos=camera_pos,
        cfg=statics.cfg,
        clear_color=st.clear_color,
    )
    return shade.resolve_and_pack(jnp, rgba, st.supersample, st.srgb_output)


def render_frame_staged(
    statics: FrameStatics,
    positions, vert_obj, normals, colors, uvs,
    tri_v, tri_obj, obj_material,
    model_mats, mvp_mats, camera_pos,
    materials, atlas, light,
    tri_mat=None,
):
    """Same signature/results as render_frame, via per-stage jits."""
    cfg = statics.cfg
    st = statics.settings
    su, attrs_full, gstats = _stage_geometry(
        cfg, st.clip_budget, positions, vert_obj, normals, colors, uvs,
        tri_v, tri_obj, obj_material, model_mats, mvp_mats, tri_mat=tri_mat,
    )
    records, tile_start, tile_count, bstats = _stage_binning(
        cfg, st.max_pairs, su
    )
    vis_d, vis_t = raster_pallas.rasterize_visibility(
        records, tile_start, tile_count, cfg, interpret=statics.interpret
    )
    rgba8 = _stage_shade(
        statics, vis_t, su, attrs_full, camera_pos, materials, atlas, light
    )
    aux = {"vis_d16": vis_d, "vis_tri": vis_t, **gstats, **bstats}
    return rgba8, aux
