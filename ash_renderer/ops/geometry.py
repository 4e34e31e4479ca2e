"""Device geometry stage: vertex transform, clipping, snap, cull, setup.

The software replacement for the reference's vertex shader + fixed-function
primitive assembly (``shaders/vertex_shader.glsl:12-15``: clip = P*V*M*pos;
``graphics_pipeline_components.rs:69-108``: CCW front, back cull, triangle
list).  All shapes are static:

* the vertex transform is one batched pass over all packed vertices, as
  explicit mul/add chains (no matrix product);
* triangles classify into fast-path (fully inside guard planes), culled, or
  needs-clip; the expensive Sutherland-Hodgman clipper runs only on a
  ``clip_budget``-bounded compaction of flagged triangles (static shape),
  mirroring GPU guard-band clipping where the clip path is rare;
* clipped fans land in deterministic slots (rank-ordered), bit-identical to
  the oracle's layout (oracle/raster_cpu.py).

Everything here matches the oracle bit-for-bit: integer snapping/culling is
exact by construction, float steps use only specmath's deterministic ops.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np

from .. import specmath as sm
from ..config import RasterConfig
from ..rtypes import TriangleSetup

F32 = np.float32
I32 = np.int32

ATTR_COLS = 12
MAX_CLIP_VERTS = 9
MAX_CLIP_TRIS = MAX_CLIP_VERTS - 2
# Sutherland-Hodgman intermediate polygon can exceed the final 9 vertices
# mid-pipeline; 12 slots are safe (3 + 6 planes padded up).
POLY_SLOTS = 12


def transform_vertices(positions, vert_obj, normals, colors, uvs, model_mats, mvp_mats):
    """Batched vertex stage: clip positions + combined attribute table
    ([color4, world normal3, uv2, world pos3]).

    model_mats / mvp_mats: (O,4,4) host-composed f32 (oracle shares the same
    bits).  Per-vertex application uses specmath's fixed mul/add chains, not
    einsum — matrix-unit accumulation order is platform-dependent and this
    stage is parity-critical (it feeds the snapper)."""
    if model_mats.shape[0] == 1:
        # single-object fast path: broadcast instead of a V-sized gather
        models = model_mats[0]
        mvps = mvp_mats[0]
    else:
        models = model_mats[vert_obj]  # (V,4,4)
        mvps = mvp_mats[vert_obj]
    px, py, pz = positions[:, 0], positions[:, 1], positions[:, 2]
    wx, wy, wz, _ = sm.apply_mat4_point(models, px, py, pz)
    cx, cy, cz, cw = sm.apply_mat4_point(mvps, px, py, pz)
    clip = jnp.stack([cx, cy, cz, cw], axis=1)
    nx, ny, nz = sm.apply_mat3_vec(
        models, normals[:, 0], normals[:, 1], normals[:, 2]
    )
    attrs = jnp.concatenate(
        [
            colors,
            jnp.stack([nx, ny, nz], axis=1),
            uvs,
            jnp.stack([wx, wy, wz], axis=1),
        ],
        axis=1,
    )
    return clip, attrs


def _plane_dists(c, gx, gy):
    """(..., 4) clip coords -> (..., 6) plane distances; same order as the
    oracle: near, far, left, right, top, bottom."""
    x, y, z, w = c[..., 0], c[..., 1], c[..., 2], c[..., 3]
    return jnp.stack(
        [z, w - z, F32(gx) * w + x, F32(gx) * w - x, F32(gy) * w + y, F32(gy) * w - y],
        axis=-1,
    )


def _snap_corner(cx, cy, cz, cw, cfg: RasterConfig):
    """One corner's clip coords (flat arrays) -> snapped ints + zq + iw,
    matching oracle emit()."""
    iw_raw = sm.recip_spec(cw, jnp)
    iw = jnp.where(jnp.isfinite(iw_raw), iw_raw, F32(0.0))

    def nd(v):
        r = v * iw
        return jnp.where(jnp.isfinite(r), r, F32(0.0))

    xi = sm.snap_coord(
        nd(cx), cfg.width, cfg.subpixel_scale, cfg.min_coord, cfg.max_coord_x,
        jnp,
    )
    yi = sm.snap_coord(
        nd(cy), cfg.height, cfg.subpixel_scale, cfg.min_coord, cfg.max_coord_y,
        jnp,
    )
    zq = sm.quantize_depth(nd(cz), jnp)
    return xi, yi, zq, iw


def _finish_tri(corners, vids, mat, alive):
    """Orientation cull + winding normalization; returns per-field dict with
    a validity flag.  corners: tuple of three (xi, yi, zq, iw) corner tuples;
    vids: tuple of three index arrays."""
    (xa, ya, za, ia), (xb, yb, zb, ib), (xc, yc, zc, ic) = corners
    sl = sm.shoelace2(xa, ya, xb, yb, xc, yc)
    valid = alive & (sl < 0)
    # rewind 0,2,1 so area2 > 0
    x0, x1, x2 = xa, xc, xb
    y0, y1, y2 = ya, yc, yb
    z0, z1, z2 = za, zc, zb
    i0, i1, i2 = ia, ic, ib
    v0, v1, v2 = vids[0], vids[2], vids[1]
    area2 = jnp.where(valid, -sl, I32(1))
    out = dict(
        valid=valid,
        x0=x0, y0=y0, x1=x1, y1=y1, x2=x2, y2=y2,
        area2=area2,
        inv_area2=sm.recip_spec(area2.astype(F32), jnp),
        zq0=z0, zq1=z1, zq2=z2,
        iw0=i0, iw1=i1, iw2=i2,
        v0=v0, v1=v1, v2=v2,
        mat=mat,
    )
    # zero every field of invalid rows: matches the oracle's zero-initialized
    # buffer bit-for-bit and makes downstream masking trivial
    for k, v in out.items():
        if k != "valid":
            out[k] = jnp.where(valid, v, v.dtype.type(0))
    return out


def _clip_polygons(cverts, avals, gx, gy):
    """Vectorized Sutherland-Hodgman over a batch of triangles.

    cverts: (B, 3, 4) clip positions; avals: (B, 3, A) attributes.
    Returns (B, POLY_SLOTS, 4), (B, POLY_SLOTS, A), counts (B,).

    Per plane, each edge (i, i+1 mod n) emits 0-2 vertices; output positions
    come from an exclusive cumsum of per-edge emission counts, realized as a
    one-hot select-accumulate (no dynamic scatter).
    """
    b = cverts.shape[0]
    av = jnp.concatenate([cverts, avals], axis=-1)  # (B, 3, 4+A)
    ch = av.shape[-1]
    buf = jnp.zeros((b, POLY_SLOTS, ch), dtype=F32)
    buf = buf.at[:, :3].set(av)
    count = jnp.full((b,), 3, dtype=I32)

    for plane in range(6):
        d = _plane_dists(buf[..., :4], gx, gy)[..., plane]  # (B, P)
        idx = jnp.arange(POLY_SLOTS, dtype=I32)
        in_poly = idx[None, :] < count[:, None]
        nxt = jnp.where(idx + 1 >= count[:, None], 0, idx + 1)
        d_a = d
        d_b = jnp.take_along_axis(d, nxt, axis=1)
        a_in = (d_a >= 0) & in_poly
        crossing = ((d_a >= 0) != (d_b >= 0)) & in_poly
        emit = a_in.astype(I32) + crossing.astype(I32)  # 0..2 per edge
        offs = jnp.cumsum(emit, axis=1) - emit  # exclusive cumsum
        new_count = jnp.where(in_poly[:, 0], offs[:, -1] + emit[:, -1], 0)

        t = sm.div_spec(d_a, d_a - d_b, jnp)
        v_a = buf
        v_b = jnp.take_along_axis(buf, nxt[..., None], axis=1)
        inter = v_a + t[..., None] * (v_b - v_a)
        # sanitize: a single non-finite value would poison the one-hot
        # accumulation below (inf * 0 = NaN)
        inter = jnp.where(jnp.isfinite(inter), inter, F32(0.0))

        # Scatter each edge's 0-2 emitted vertices to their cumsum positions.
        # Emission positions are unique, so at most one source contributes per
        # output slot; an explicit select-accumulate over the (small, static)
        # source axis keeps this bit-exact (a one-hot matrix product could
        # route f32 values through reduced-precision passes).
        def one_hot_place(pos, mask, vals, acc):
            oh = (idx[None, None, :] == pos[..., None]) & mask[..., None]
            for p in range(POLY_SLOTS):
                acc = acc + jnp.where(
                    oh[:, p, :, None], vals[:, p : p + 1, :], F32(0.0)
                )
            return acc

        acc = jnp.zeros_like(buf)
        acc = one_hot_place(offs, a_in, v_a, acc)
        acc = one_hot_place(offs + a_in.astype(I32), crossing, inter, acc)
        buf = acc
        count = new_count
    return buf[..., :4], buf[..., 4:], count


def clip_fan_path(cvb, ab, matb, sel_ok, cfg: RasterConfig, vbase):
    """Shared Sutherland-Hodgman + fan-triangulation path over the budgeted
    compaction of needs-clip triangles.

    cvb: (B, 3, 4) clip positions; ab: (B, 3, A) attributes; matb: (B,)
    material ids; sel_ok: (B,) live-slot mask; vbase: (B,) first extra
    attribute-row id per polygon (classic path's vertex ids).

    Returns (clipped fields dict with (B, MAX_CLIP_TRIS) entries,
    fan_attrs [3 x (B, MAX_CLIP_TRIS, A) per-corner attributes, zeroed on
    dead slots], poly_a (B, POLY_SLOTS, A) polygon attribute rows).
    """
    gx = 1.0 + 2.0 * cfg.guard_px / cfg.width
    gy = 1.0 + 2.0 * cfg.guard_px / cfg.height
    poly_v, poly_a, poly_n = _clip_polygons(cvb, ab, gx, gy)
    # iw per polygon vertex (computed once per vertex, as in the oracle)
    iw_poly_raw = sm.recip_spec(poly_v[..., 3], jnp)
    iw_poly = jnp.where(jnp.isfinite(iw_poly_raw), iw_poly_raw, F32(0.0))

    # fan triangles j = (0, j+1, j+2), j in [0, MAX_CLIP_TRIS)
    j_idx = jnp.arange(MAX_CLIP_TRIS, dtype=I32)
    fan = jnp.stack(
        [jnp.zeros_like(j_idx), j_idx + 1, j_idx + 2], axis=-1
    )  # (7,3)
    fan_alive = (j_idx[None, :] + 2 < poly_n[:, None]) & sel_ok[:, None]
    fanc = jnp.clip(fan, 0, POLY_SLOTS - 1)
    fan_corners = []
    fan_vids = []
    fan_attrs = []
    for k in range(3):
        fvk = poly_v[:, fanc[:, k]]  # (B,7,4)
        snap = _snap_corner(
            fvk[..., 0], fvk[..., 1], fvk[..., 2], fvk[..., 3], cfg
        )
        # use the per-polygon-vertex iw (same bits; oracle computes it once
        # per polygon vertex)
        fan_corners.append(
            (snap[0], snap[1], snap[2], iw_poly[:, fanc[:, k]])
        )
        fan_vids.append(vbase[:, None] + fanc[None, :, k])
        fan_attrs.append(poly_a[:, fanc[:, k]])  # (B,7,A)
    clipped = _finish_tri(
        tuple(fan_corners), tuple(fan_vids),
        jnp.broadcast_to(matb[:, None], fan_alive.shape), fan_alive,
    )
    fan_attrs = [
        jnp.where(clipped["valid"][..., None], a, F32(0.0)) for a in fan_attrs
    ]
    return clipped, fan_attrs, poly_a


def _select_budgeted(flags, t_in: int, budget: int):
    """First ``budget`` flagged row indices ascending, -1 fill — identical
    to nonzero(size=budget, fill_value=-1), via sort-select."""
    all_idx = jnp.arange(t_in, dtype=I32)
    sel = jax.lax.sort(jnp.where(flags, all_idx, I32(t_in)))
    if t_in < budget:
        sel = jnp.pad(sel, (0, budget - t_in), constant_values=I32(t_in))
    sel = sel[:budget]
    return jnp.where(sel < t_in, sel, I32(-1))


def _vertex_post(clip, cfg: RasterConfig):
    """Per-vertex snap + frustum outcode, packed (V, 8) i32.

    Snapping and plane tests are per-vertex pure functions, so doing them
    once per vertex and row-gathering the packed results per triangle
    corner is less work than per-corner recomputation at T ~= 2V triangles —
    and bit-identical (same inputs, same spec formulas).
    Outcode bit p set <=> plane p distance < 0 (oracle plane order)."""
    cx, cy, cz, cw = clip[:, 0], clip[:, 1], clip[:, 2], clip[:, 3]
    gx = F32(1.0 + 2.0 * cfg.guard_px / cfg.width)
    gy = F32(1.0 + 2.0 * cfg.guard_px / cfg.height)
    xi, yi, zq, iw = _snap_corner(cx, cy, cz, cw, cfg)
    # bits 0-5: guard-frustum planes; bits 6-9: SCREEN side planes (g = 1),
    # consumed only by the clip-path trivial reject (oracle _screen_dists)
    ds = (
        cz, cw - cz,
        gx * cw + cx, gx * cw - cx,
        gy * cw + cy, gy * cw - cy,
        cw + cx, cw - cx, cw + cy, cw - cy,
    )
    outcode = jnp.zeros_like(xi)
    for pi, d in enumerate(ds):
        outcode = outcode | ((d < 0).astype(I32) << pi)
    zero = jnp.zeros_like(xi)
    return jnp.stack(
        [xi, yi, zq, sm._bitcast_i32(iw, jnp), outcode, zero, zero, zero],
        axis=1,
    )


def geometry_device(
    clip,
    attrs,
    tri_v,
    tri_obj,
    obj_material,
    cfg: RasterConfig,
    clip_budget: int,
    tri_mat=None,
):
    """Full triangle setup on device; mirrors oracle geometry_oracle.

    Returns (TriangleSetup, combined_attrs, stats) with static shapes
    S = T + 7*clip_budget rows and VA = V + 9*clip_budget attribute rows.
    Padding rows (tri_v = -1) come out invalid.
    """
    t_in = tri_v.shape[0]
    nv_pad = clip.shape[0]

    vid_ok = tri_v[:, 0] >= 0
    vid = jnp.clip(tri_v, 0, nv_pad - 1)
    if tri_mat is not None:
        # static per scene — the Renderer precomputes this on the host
        mat_id = tri_mat
    else:
        mat_id = obj_material[jnp.clip(tri_obj, 0, obj_material.shape[0] - 1)]

    # per-vertex snap + outcodes once, then one packed row-gather per corner
    vtx = _vertex_post(clip, cfg)  # (V, 8)
    corner_pack = [vtx[vid[:, k]] for k in range(3)]  # 3x (T, 8)
    oc0, oc1, oc2 = (c[:, 4] for c in corner_pack)
    oc_and = oc0 & oc1 & oc2
    out_any = (oc_and & 0x3F) != 0  # all corners outside one guard plane
    all_in = ((oc0 | oc1 | oc2) & 0x3F) == 0
    # all corners outside one SCREEN side plane -> coverage provably empty
    # (half-space argument in clip space); skip the clip tail entirely
    out_screen = (oc_and >> 6) != 0
    fast = vid_ok & all_in
    needs_clip = vid_ok & ~all_in & ~out_any & ~out_screen

    # ---- fast path
    corner_snaps = tuple(
        (c[:, 0], c[:, 1], c[:, 2], sm._bitcast_f32(c[:, 3], jnp))
        for c in corner_pack
    )
    main = _finish_tri(
        corner_snaps, (vid[:, 0], vid[:, 1], vid[:, 2]), mat_id, fast
    )

    # ---- clip path: budgeted compaction of flagged triangles
    clip_overflow = jnp.sum(needs_clip.astype(I32)) - jnp.minimum(
        jnp.sum(needs_clip.astype(I32)), clip_budget
    )
    sel = _select_budgeted(needs_clip, t_in, clip_budget)
    sel_ok = sel >= 0
    sel_c = jnp.clip(sel, 0, t_in - 1)
    cvb = clip[vid[sel_c]]  # (B,3,4) — small multi-dim gather, B=clip_budget
    ab = attrs[vid[sel_c]]  # (B,3,A)
    matb = mat_id[sel_c]

    clipped, fan_attrs, poly_a = clip_fan_path(
        cvb, ab, matb, sel_ok, cfg,
        vbase=nv_pad + MAX_CLIP_VERTS * jnp.arange(clip_budget, dtype=I32),
    )
    del fan_attrs  # classic path shades via attrs_full + fan vids

    # ---- assemble the static setup buffer
    def cat(k):
        flat = clipped[k].reshape(clip_budget * MAX_CLIP_TRIS)
        return jnp.concatenate([main[k], flat])

    su = TriangleSetup(
        **{
            k: cat(k)
            for k in (
                "valid x0 y0 x1 y1 x2 y2 area2 inv_area2 "
                "zq0 zq1 zq2 iw0 iw1 iw2 v0 v1 v2 mat".split()
            )
        }
    )

    # extra attribute rows: polygon vertices in rank slots
    extra = jnp.where(
        sel_ok[:, None, None], poly_a[:, :MAX_CLIP_VERTS], F32(0.0)
    ).reshape(clip_budget * MAX_CLIP_VERTS, ATTR_COLS)
    combined_attrs = jnp.concatenate([attrs, extra], axis=0)

    stats = {
        "clip_overflow": clip_overflow,
        "n_fast": jnp.sum(fast.astype(I32)),
        "n_clipped": jnp.sum(needs_clip.astype(I32)),
        "n_valid": jnp.sum(su.valid.astype(I32)),
        # static setup-row count: the valid range for visibility-buffer
        # triangle ids (utils/debugging.validate_frame range check)
        "n_setup": jnp.int32(su.valid.shape[0]),
    }
    return su, combined_attrs, stats
