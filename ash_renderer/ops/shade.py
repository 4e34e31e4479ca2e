"""Deferred shading: visibility buffer -> shaded RGBA, backend-agnostic.

This is the fragment stage of the pipeline — the software replacement for
the reference's fragment shader (``shaders/fragment_shader.glsl:6-8``: output
= interpolated vertex color) extended with the capabilities the reference
scaffolded: Blinn-Phong directional lighting and mipmapped bilinear texture
sampling (``src/renderer/textures.rs`` intent).

Runs identically under numpy (oracle) and jax.numpy (device): every operation
is a deterministic IEEE f32 / int32 op (see ``specmath``).  The per-pixel
work is dense and gather-based: attribute interpolation is elementwise
arithmetic, texture taps are device-memory gathers.

Why deferred: the visibility pass stores only ``(d16, triangle_id)`` per
pixel, so each pixel's attributes are fetched and shaded exactly once, after
all depth resolution — no shading work is wasted on occluded fragments, and
the rasterizer's inner loop stays tiny.
"""

from __future__ import annotations

import numpy as np

from .. import specmath as sm
from ..config import RasterConfig

F32 = np.float32
I32 = np.int32


def _take(arr, idx, xp):
    """Clipped gather along axis 0 (identical OOB behavior on both backends).
    Coerces constant (numpy) tables to the backend so traced indices work.

    Tables with few rows (K <= 32) use a K-way select tree instead of a
    gather — bit-identical, since selects copy values.  Whether that still
    beats a gather on the GPU is not measured yet."""
    arr = xp.asarray(arr)
    n = arr.shape[0]
    idx = xp.clip(idx, 0, n - 1)
    if n <= 32 and arr.ndim == 1:
        out = xp.broadcast_to(arr[0], idx.shape)
        for k in range(1, n):
            out = xp.where(idx == k, arr[k], out)
        return out
    if n <= 32 and arr.ndim == 2:
        out = xp.broadcast_to(arr[0], idx.shape + arr.shape[1:])
        for k in range(1, n):
            out = xp.where((idx == k)[..., None], arr[k], out)
        return out
    return arr[idx]


def _edges_at_pixels(su_g, px, py, cfg: RasterConfig, xp):
    """Recompute the three int32 edge values at pixel centers for the gathered
    per-pixel triangle setup ``su_g`` (dict of (H,W) arrays)."""
    sx, sy = sm.pixel_sample_coords(px, py, cfg.subpixel_scale)
    x0, y0 = su_g["x0"], su_g["y0"]
    x1, y1 = su_g["x1"], su_g["y1"]
    x2, y2 = su_g["x2"], su_g["y2"]
    a0, b0, _ = sm.edge_coeffs(x1, y1, x2, y2)
    a1, b1, _ = sm.edge_coeffs(x2, y2, x0, y0)
    a2, b2, _ = sm.edge_coeffs(x0, y0, x1, y1)
    e0 = sm.edge_at(a0, b0, x1, y1, sx, sy)
    e1 = sm.edge_at(a1, b1, x2, y2, sx, sy)
    e2 = sm.edge_at(a2, b2, x0, y0, sx, sy)
    return (e0, e1, e2), (a0, a1, a2)


def _normalize3(v, xp):
    """Deterministic vector normalize via spec rsqrt; zero-safe."""
    n2 = sm.dot3(v[..., 0], v[..., 0], v[..., 1], v[..., 1], v[..., 2], v[..., 2])
    inv = sm.rsqrt_spec(xp.maximum(n2, F32(1e-30)), xp)
    return v * inv[..., None], n2


def sample_texture(xp, atlas, tex_id, u, v, level):
    """Wrap-addressed bilinear tap at an explicit mip level.

    tex_id/level are per-pixel int32; negative tex_id pixels still compute a
    (clamped) tap and are masked by the caller.
    """
    from ..textures import MAX_LEVELS

    tex_c = xp.clip(tex_id, 0, atlas.level_offset.shape[0] - 1)
    flat = tex_c * MAX_LEVELS + level
    off = _take(atlas.level_offset.reshape(-1), flat, xp)
    w = _take(atlas.level_w.reshape(-1), flat, xp)
    h = _take(atlas.level_h.reshape(-1), flat, xp)

    # sanitize: background pixels carry garbage uv (masked later); NaN->int
    # casts are platform-UB so zero them first
    u = xp.where(xp.isfinite(u), u, F32(0.0))
    v = xp.where(xp.isfinite(v), v, F32(0.0))
    ut = u * w.astype(F32) - F32(0.5)
    vt = v * h.astype(F32) - F32(0.5)
    iu0 = xp.floor(ut).astype(I32)
    iv0 = xp.floor(vt).astype(I32)
    fu = ut - iu0.astype(F32)
    fv = vt - iv0.astype(F32)
    iu0w = xp.mod(iu0, w)
    iv0w = xp.mod(iv0, h)

    # ONE row-gather fetches the whole 2x2 bilinear footprint: the quad
    # table stores [texel, right, down, downright] with the same wrap
    # addressing the four separate taps used (textures.build_quads), so the
    # values — and the interpolation below — are bit-identical.
    tap = off + iv0w * w + iu0w
    quad = _take(atlas.quads, tap, xp)  # (..., 4) i32

    def unpack(t32):
        # unpack packed-RGBA int32 with exact integer shifts
        return xp.stack(
            [
                ((t32 >> 0) & 255).astype(F32) * F32(1.0 / 255.0),
                ((t32 >> 8) & 255).astype(F32) * F32(1.0 / 255.0),
                ((t32 >> 16) & 255).astype(F32) * F32(1.0 / 255.0),
                ((t32 >> 24) & 255).astype(F32) * F32(1.0 / 255.0),
            ],
            axis=-1,
        )

    c00 = unpack(quad[..., 0])
    c10 = unpack(quad[..., 1])
    c01 = unpack(quad[..., 2])
    c11 = unpack(quad[..., 3])
    top = sm.lerp(c00, c10, fu[..., None])
    bot = sm.lerp(c01, c11, fu[..., None])
    return sm.lerp(top, bot, fv[..., None])


def interp_fields(xp, g, a0, a1, a2, px, py, cfg):
    """The interpolation half of shading: per-pixel edge functions,
    perspective-correct weights, attribute interpolation, and the raw uv
    screen-derivative terms the mip selector consumes.

    a0/a1/a2: per-corner attributes as LISTS of 12 per-channel arrays
    (wrapping (..., 12) arrays — the per-channel dot3 is elementwise
    identical to the broadcast form).  Returns (attr list of 12, (durx,
    dvrx, dury, dvry)) where du = durx * level_w exactly reproduces
    _mip_level's ((dux - u*dsx) * inv_s) * bw chain."""
    (e0, e1, e2), (a0c, a1c, a2c) = _edges_at_pixels(g, px, py, cfg, xp)
    l0, l1, l2 = sm.bary_weights(e0, e1, e2, g["inv_area2"], xp)
    m0, m1, m2 = sm.persp_weights(
        l0, l1, l2, g["iw0"], g["iw1"], g["iw2"], xp
    )
    attr = [
        sm.dot3(m0, a0[ch], m1, a1[ch], m2, a2[ch]) for ch in range(12)
    ]

    # mip derivative raws (cut exactly at _mip_level's "* bw" boundary)
    scale = F32(cfg.subpixel_scale)
    x0, y0 = g["x0"], g["y0"]
    x1, y1 = g["x1"], g["y1"]
    x2, y2 = g["x2"], g["y2"]
    b0 = x2 - x1
    b1 = x0 - x2
    b2 = x1 - x0
    inv_area = g["inv_area2"]
    dp = []
    for (ea, eb), iw in (
        ((a0c, b0), g["iw0"]),
        ((a1c, b1), g["iw1"]),
        ((a2c, b2), g["iw2"]),
    ):
        gx = ea.astype(F32) * scale * inv_area * iw
        gy = eb.astype(F32) * scale * inv_area * iw
        dp.append((gx, gy))
    p0 = e0.astype(F32) * inv_area * g["iw0"]
    p1 = e1.astype(F32) * inv_area * g["iw1"]
    p2 = e2.astype(F32) * inv_area * g["iw2"]
    s = (p0 + p1) + p2
    inv_s = sm.recip_spec(s, xp)
    u0, v0c = a0[7], a0[8]
    u1, v1c = a1[7], a1[8]
    u2, v2c = a2[7], a2[8]
    u, v = attr[7], attr[8]

    def raws(axis):
        dsx = sm.dot3(
            dp[0][axis], F32(1.0), dp[1][axis], F32(1.0), dp[2][axis],
            F32(1.0),
        )
        dux = sm.dot3(dp[0][axis], u0, dp[1][axis], u1, dp[2][axis], u2)
        dvx = sm.dot3(dp[0][axis], v0c, dp[1][axis], v1c, dp[2][axis], v2c)
        return (dux - u * dsx) * inv_s, (dvx - v * dsx) * inv_s

    durx, dvrx = raws(0)
    dury, dvry = raws(1)
    return attr, (durx, dvrx, dury, dvry)


_PACK_FIELDS = "x0 y0 x1 y1 x2 y2 inv_area2 iw0 iw1 iw2 v0 v1 v2 mat".split()
_PACK_FLOAT = {"inv_area2", "iw0", "iw1", "iw2"}


def pack_setup_table(su, xp):
    """(S, 16) i32 packed shading fields (floats bitcast): one row-gather
    per pixel instead of 14 per-field gathers."""
    cols = []
    for k in _PACK_FIELDS:
        v = getattr(su, k)
        if k in _PACK_FLOAT:
            v = sm._bitcast_i32(v, xp)
        cols.append(v)
    cols.append(xp.zeros_like(cols[0]))
    cols.append(xp.zeros_like(cols[0]))
    return xp.stack(cols, axis=1)


def shade(
    xp,
    vis_tri,
    su,
    attrs,
    materials=None,
    atlas=None,
    light=None,
    camera_pos=None,
    cfg: RasterConfig = None,
    clear_color=(0.0, 0.0, 0.0, 1.0),
    py_offset: int = 0,
):
    """Shade the visibility buffer into an f32 RGBA image (render resolution).

    su: TriangleSetup (numpy or jnp arrays); attrs: (VA, 12) combined
    attribute table (see oracle/raster_cpu.py layout).  py_offset: global
    pixel row of vis_tri's first row (multi-device slab shading).
    """
    h, w = vis_tri.shape
    valid = vis_tri >= 0
    t = xp.clip(vis_tri, 0, su.x0.shape[0] - 1)

    packed = _take(pack_setup_table(su, xp), t, xp)  # (H, W, 16)
    g = {}
    for i, k in enumerate(_PACK_FIELDS):
        v = packed[..., i]
        if k in _PACK_FLOAT:
            v = sm._bitcast_f32(v, xp)
        g[k] = v

    a_v0 = _take(attrs, g["v0"], xp)  # (H, W, 12)
    a_v1 = _take(attrs, g["v1"], xp)
    a_v2 = _take(attrs, g["v2"], xp)
    return shade_gathered(
        xp, valid, g, a_v0, a_v1, a_v2,
        materials=materials, atlas=atlas, light=light,
        camera_pos=camera_pos, cfg=cfg, clear_color=clear_color,
        py_offset=py_offset,
    )


def shade_gathered(
    xp,
    valid,
    g,
    a_v0,
    a_v1,
    a_v2,
    materials=None,
    atlas=None,
    light=None,
    camera_pos=None,
    cfg: RasterConfig = None,
    clear_color=(0.0, 0.0, 0.0, 1.0),
    py_offset: int = 0,
    px=None,
    py=None,
):
    """The per-pixel shading math given already-fetched winner data: the
    per-pixel setup dict ``g`` (x0..y2, inv_area2, iw0-2, mat) and the three
    corner attribute rows, as fetched by the gather path above (oracle and
    device pipeline).

    px/py: explicit per-element pixel coordinates; default is the (H, W)
    raster order.
    """
    h, w = valid.shape
    if px is None:
        px = _iota2(xp, h, w, 1)
    if py is None:
        # py_offset may be traced (per-device slab origin under shard_map)
        py = _iota2(xp, h, w, 0) + py_offset
    a0 = [a_v0[..., ch] for ch in range(12)]
    a1 = [a_v1[..., ch] for ch in range(12)]
    a2 = [a_v2[..., ch] for ch in range(12)]
    attr, duv = interp_fields(xp, g, a0, a1, a2, px, py, cfg)
    return shade_surface(
        xp, valid, attr, g["mat"], duv,
        materials=materials, atlas=atlas, light=light,
        camera_pos=camera_pos, clear_color=clear_color,
    )


def shade_surface(
    xp,
    valid,
    attr,
    mat_id,
    duv,
    materials=None,
    atlas=None,
    light=None,
    camera_pos=None,
    clear_color=(0.0, 0.0, 0.0, 1.0),
):
    """The surface half of shading, from interpolated values: material
    modulation, mip selection (from interp_fields' raw derivatives) +
    texture tap, Blinn-Phong lighting, background clear.  attr: list of 12
    interpolated channels; duv: (durx, dvrx, dury, dvry)."""
    color = xp.stack(attr[0:4], axis=-1)
    normal = xp.stack(attr[4:7], axis=-1)
    u, v = attr[7], attr[8]
    wpos = xp.stack(attr[9:12], axis=-1)

    rgba = color
    if materials is not None:
        mat = xp.clip(mat_id, 0, materials.base_color.shape[0] - 1)
        base = _take(materials.base_color, mat, xp)
        rgba = rgba * base
        if atlas is not None:
            tex_id = _take(materials.tex_id, mat, xp)
            level = _mip_from_raws(xp, duv, atlas, tex_id)
            texel = sample_texture(xp, atlas, tex_id, u, v, level)
            rgba = xp.where((tex_id >= 0)[..., None], rgba * texel, rgba)

    if light is not None:
        n, n2 = _normalize3(normal, xp)
        lit = n2 > F32(1e-12)  # vertices without normals stay unlit
        ldir, _ = _normalize3(
            xp.broadcast_to(light.direction, normal.shape), xp
        )
        ndotl = xp.maximum(
            F32(0.0),
            -sm.dot3(
                n[..., 0], ldir[..., 0], n[..., 1], ldir[..., 1], n[..., 2],
                ldir[..., 2],
            ),
        )
        diffuse = light.ambient + ndotl[..., None] * light.color
        rgb = rgba[..., :3] * diffuse
        if materials is not None and camera_pos is not None:
            spec_k = _take(materials.specular, mat, xp)
            shin = _take(materials.shininess, mat, xp)
            vdir, _ = _normalize3(camera_pos - wpos, xp)
            hv, _ = _normalize3(vdir - ldir, xp)
            ndoth = xp.maximum(
                F32(0.0),
                sm.dot3(
                    n[..., 0], hv[..., 0], n[..., 1], hv[..., 1], n[..., 2],
                    hv[..., 2],
                ),
            )
            spec = sm.powi(ndoth, shin, 8, xp) * spec_k
            rgb = rgb + spec[..., None] * light.color
        rgba = xp.concatenate(
            [xp.where(lit[..., None], rgb, rgba[..., :3]), rgba[..., 3:4]],
            axis=-1,
        )

    clear = xp.asarray(np.asarray(clear_color, dtype=F32))
    return xp.where(valid[..., None], rgba, clear)


def _mip_from_raws(xp, duv, atlas, tex_id):
    """Nearest mip level from interp_fields' raw uv screen derivatives:
    du = durx * level_w reproduces the analytic plane-identity chain
    exactly; level = floor(log2 sqrt(max footprint^2)) via exponent bits
    (transcendental-free, deterministic)."""
    durx, dvrx, dury, dvry = duv
    tex_c = xp.clip(tex_id, 0, atlas.level_w.shape[0] - 1)
    bw = _take(atlas.level_w[:, 0], tex_c, xp).astype(F32)
    bh = _take(atlas.level_h[:, 0], tex_c, xp).astype(F32)
    nl = _take(atlas.n_levels, tex_c, xp)

    def footprint2(dur, dvr):
        du = dur * bw
        dv = dvr * bh
        return du * du + dv * dv

    rho2 = xp.maximum(footprint2(durx, dvrx), footprint2(dury, dvry))
    rho2 = xp.maximum(rho2, F32(1e-20))
    e2b = sm.float_exponent(rho2, xp)
    level = e2b >> 1
    return xp.clip(level, 0, xp.maximum(nl - 1, 0)).astype(I32)


def _iota2(xp, h, w, axis):
    if xp is np:
        return (
            np.broadcast_to(np.arange(w, dtype=I32)[None, :], (h, w))
            if axis == 1
            else np.broadcast_to(np.arange(h, dtype=I32)[:, None], (h, w))
        )
    import jax

    return jax.lax.broadcasted_iota(I32, (h, w), axis)


def _mip_level(xp, g, edges, mus, a_v0, a_v1, a_v2, atlas, tex_id, cfg):
    """Analytic screen-space uv derivatives -> nearest mip level.

    Uses the plane identity: with p_i = lambda_i * iw_i and S = sum p_i,
    u = (sum p_i u_i) / S, and dp_i/dpx is a per-triangle constant, so
    du/dpx = (sum dp_i u_i - u * sum dp_i) / S.  The level is
    floor(log2(max texel-space footprint)) taken from exponent bits
    (transcendental-free, deterministic).
    """
    e0, e1, e2 = edges
    m0, m1, m2 = mus
    scale = F32(cfg.subpixel_scale)

    x0, y0 = g["x0"], g["y0"]
    x1, y1 = g["x1"], g["y1"]
    x2, y2 = g["x2"], g["y2"]
    # edge function gradients (per triangle): dE/dpx = A * subpixel_scale,
    # dE/dpy = B * subpixel_scale
    a0, b0, _ = sm.edge_coeffs(x1, y1, x2, y2)
    a1, b1, _ = sm.edge_coeffs(x2, y2, x0, y0)
    a2, b2, _ = sm.edge_coeffs(x0, y0, x1, y1)

    inv_area = g["inv_area2"]
    dp = []
    for (ea, eb), iw in (
        ((a0, b0), g["iw0"]),
        ((a1, b1), g["iw1"]),
        ((a2, b2), g["iw2"]),
    ):
        gx = ea.astype(F32) * scale * inv_area * iw
        gy = eb.astype(F32) * scale * inv_area * iw
        dp.append((gx, gy))

    p0 = e0.astype(F32) * inv_area * g["iw0"]
    p1 = e1.astype(F32) * inv_area * g["iw1"]
    p2 = e2.astype(F32) * inv_area * g["iw2"]
    s = (p0 + p1) + p2
    inv_s = sm.recip_spec(s, xp)

    u0, v0c = a_v0[..., 7], a_v0[..., 8]
    u1, v1c = a_v1[..., 7], a_v1[..., 8]
    u2, v2c = a_v2[..., 7], a_v2[..., 8]
    u = sm.dot3(m0, u0, m1, u1, m2, u2)
    v = sm.dot3(m0, v0c, m1, v1c, m2, v2c)

    tex_c = xp.clip(tex_id, 0, atlas.level_w.shape[0] - 1)
    bw = _take(atlas.level_w[:, 0], tex_c, xp).astype(F32)
    bh = _take(atlas.level_h[:, 0], tex_c, xp).astype(F32)
    nl = _take(atlas.n_levels, tex_c, xp)

    def footprint2(axis):
        dsx = sm.dot3(dp[0][axis], F32(1.0), dp[1][axis], F32(1.0), dp[2][axis], F32(1.0))
        dux = sm.dot3(dp[0][axis], u0, dp[1][axis], u1, dp[2][axis], u2)
        dvx = sm.dot3(dp[0][axis], v0c, dp[1][axis], v1c, dp[2][axis], v2c)
        du = (dux - u * dsx) * inv_s * bw
        dv = (dvx - v * dsx) * inv_s * bh
        return du * du + dv * dv

    rho2 = xp.maximum(footprint2(0), footprint2(1))
    rho2 = xp.maximum(rho2, F32(1e-20))
    # level = floor(log2(sqrt(rho2))) = floor(exponent(rho2) / 2)
    e2b = sm.float_exponent(rho2, xp)
    level = e2b >> 1
    return xp.clip(level, 0, xp.maximum(nl - 1, 0)).astype(I32)


def resolve_and_pack(xp, rgba, supersample: int, srgb: bool):
    """Box-resolve the supersampled image and pack to RGBA8.

    Resolve order is spec'd: ordered accumulation over the ss*ss footprint
    then multiply by 1/ss^2.
    """
    if supersample > 1:
        h, w = rgba.shape[0] // supersample, rgba.shape[1] // supersample
        r = rgba.reshape(h, supersample, w, supersample, 4)
        acc = None
        for i in range(supersample):
            for j in range(supersample):
                term = r[:, i, :, j, :]
                acc = term if acc is None else acc + term
        rgba = acc * F32(1.0 / (supersample * supersample))
    if srgb:
        lut = xp.asarray(sm.srgb_encode_lut())
        idx = xp.round(
            xp.clip(rgba[..., :3], F32(0.0), F32(1.0)) * F32(4095.0)
        ).astype(I32)
        rgb = lut[idx]
        rgba = xp.concatenate([rgb, rgba[..., 3:4]], axis=-1)
    return sm.pack_unorm8(rgba, xp)
