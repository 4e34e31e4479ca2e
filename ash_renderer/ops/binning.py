"""Triangle -> tile binning: how the software rasterizer scales.

The reference draws its whole scene with one ``cmd_draw_indexed``
(``src/renderer.rs:533-540``) and lets GPU hardware distribute fragments;
here the screen is split into tiles and triangles are binned to the tiles
their AABB touches, so the visibility kernel streams only relevant
triangles per tile (SURVEY §5's blockwise scheduling analogue).

Pipeline (all static shapes, pure XLA):

1. per-triangle pixel AABB -> covered tile range -> pair count;
2. pair expansion: pair i -> triangle via searchsorted over the inclusive
   count prefix;
3. per-pair tile id (elementwise from a packed (S,4) bin table gather);
4. unstable sort of pairs by tile id — order within a tile is irrelevant
   because the visibility key (d16, -draw_idx) is order-independent, so
   bitwise parity survives any processing order;
5. one row-gather of the packed per-triangle table, then elementwise
   reconstruction of the kernel records: tile-corner edge values from edge
   coefficients + anchors, and E2c = area2 - E0c - E1c (exact by modular
   int32 arithmetic since the true value fits in int32);
6. per-tile start/count tables.

Kernel record layout — int32 array (P, 16), one row per (triangle, tile):
  0:A0 1:B0 2:A1 3:B1 4:A2 5:B2  — edge increments (per subpixel step)
  6:E0c 7:E1c 8:E2c              — edge values at tile-corner pixel sample
  9:zq0 10:zq1 11:zq2            — D16 vertex depths
  12:tri_id  13:bias bits (b0|b1<<1|b2<<2)  14:inv_area2 (f32 bits)  15:pad
Dead rows are all zero, which covers no pixel.
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

RECORD_WORDS = 16


def _pack_tri_table(su: TriangleSetup):
    """(S, 16) i32 per-triangle record source: edge coeffs, two edge anchors,
    depths, bias bits, inv_area2 bits, area2."""
    a0, b0, tl0 = sm.edge_coeffs(su.x1, su.y1, su.x2, su.y2)
    a1, b1, tl1 = sm.edge_coeffs(su.x2, su.y2, su.x0, su.y0)
    a2, b2, tl2 = sm.edge_coeffs(su.x0, su.y0, su.x1, su.y1)
    bias = tl0.astype(I32) | (tl1.astype(I32) << 1) | (tl2.astype(I32) << 2)
    inv_bits = sm._bitcast_i32(su.inv_area2, jnp)
    return jnp.stack(
        [
            a0, b0, a1, b1, a2, b2,
            su.x1, su.y1, su.x2, su.y2,
            su.zq0, su.zq1, su.zq2,
            bias, inv_bits, su.area2,
        ],
        axis=1,
    )


def bin_triangles(su: TriangleSetup, cfg: RasterConfig, max_pairs: int,
                  tile_row0: int = 0, tile_rows: int | None = None):
    """Returns (records (P, 16), tile_start, tile_count, stats) for the
    tile-row window [tile_row0, tile_row0 + tile_rows) — windowing is how
    multi-device sharding gives each device its slab of the framebuffer
    (parallel/sharding.py).  Defaults to the full grid."""
    ss = cfg.subpixel_scale
    half = ss // 2
    s_rows = su.x0.shape[0]
    if tile_rows is None:
        tile_rows = cfg.grid_h
    n_tiles_w = tile_rows * cfg.grid_w
    # tile_row0 may be a traced scalar (per-device slab origin in shard_map)
    py_lo = tile_row0 * cfg.tile_h
    py_hi = jnp.minimum((tile_row0 + tile_rows) * cfg.tile_h, cfg.height) - 1

    xmin = jnp.minimum(jnp.minimum(su.x0, su.x1), su.x2)
    xmax = jnp.maximum(jnp.maximum(su.x0, su.x1), su.x2)
    ymin = jnp.minimum(jnp.minimum(su.y0, su.y1), su.y2)
    ymax = jnp.maximum(jnp.maximum(su.y0, su.y1), su.y2)

    pxmin = jnp.maximum(0, (xmin - half + ss - 1) // ss)
    pxmax = jnp.minimum(cfg.width - 1, (xmax - half) // ss)
    pymin = jnp.maximum(py_lo, (ymin - half + ss - 1) // ss)
    pymax = jnp.minimum(py_hi, (ymax - half) // ss)

    live = su.valid & (pxmax >= pxmin) & (pymax >= pymin)
    tx0 = jnp.where(live, pxmin // cfg.tile_w, 0)
    tx1 = jnp.where(live, pxmax // cfg.tile_w, -1)
    ty0 = jnp.where(live, pymin // cfg.tile_h - tile_row0, 0)
    ty1 = jnp.where(live, pymax // cfg.tile_h - tile_row0, -1)
    ntx = tx1 - tx0 + 1
    count = jnp.where(live, ntx * (ty1 - ty0 + 1), 0)

    ends = jnp.cumsum(count)
    offsets = ends - count
    total = ends[-1] if s_rows else jnp.int32(0)
    overflow = jnp.maximum(total - max_pairs, 0)

    # pair i -> owning triangle (first t with ends[t] > i)
    i_idx = jnp.arange(max_pairs, dtype=I32)
    t_of = jnp.searchsorted(
        ends, i_idx, side="right", method="sort"
    ).astype(I32)
    in_range = i_idx < jnp.minimum(total, max_pairs)
    t_c = jnp.clip(t_of, 0, s_rows - 1)

    # per-pair tile id via ONE packed row gather
    bin4 = jnp.stack([offsets, jnp.maximum(ntx, 1), tx0, ty0], axis=1)[t_c]
    k = i_idx - bin4[:, 0]
    dy = k // bin4[:, 1]
    dx = k - dy * bin4[:, 1]
    tile = (bin4[:, 3] + dy) * cfg.grid_w + (bin4[:, 2] + dx)
    tile = jnp.where(in_range, tile, n_tiles_w)  # sentinel bucket at end

    tile_sorted, tri_sorted = jax.lax.sort_key_val(tile, t_c)
    tri_sorted = jnp.where(tile_sorted < n_tiles_w, tri_sorted, -1)

    tile_ids = jnp.arange(n_tiles_w, dtype=I32)
    tile_start = jnp.searchsorted(tile_sorted, tile_ids, side="left").astype(I32)
    tile_end = jnp.searchsorted(tile_sorted, tile_ids, side="right").astype(I32)
    tile_count = tile_end - tile_start

    # ONE packed row-gather of triangle data, then elementwise records
    tpack = _pack_tri_table(su)[jnp.clip(tri_sorted, 0, s_rows - 1)]  # (P,16)
    live_p = tri_sorted >= 0
    tile_c = jnp.clip(tile_sorted, 0, n_tiles_w - 1)
    sx = ((tile_c % cfg.grid_w) * cfg.tile_w) * ss + half
    sy = ((tile_c // cfg.grid_w + tile_row0) * cfg.tile_h) * ss + half
    a0, b0 = tpack[:, 0], tpack[:, 1]
    a1, b1 = tpack[:, 2], tpack[:, 3]
    e0c = sm.edge_at(a0, b0, tpack[:, 6], tpack[:, 7], sx, sy)
    e1c = sm.edge_at(a1, b1, tpack[:, 8], tpack[:, 9], sx, sy)
    # exact via modular int32 arithmetic: the true E2c fits in int32
    e2c = tpack[:, 15] - e0c - e1c

    words = [
        a0, b0, a1, b1, tpack[:, 4], tpack[:, 5],
        e0c, e1c, e2c,
        tpack[:, 10], tpack[:, 11], tpack[:, 12],
        tri_sorted, tpack[:, 13], tpack[:, 14], jnp.zeros_like(a0),
    ]
    records = jnp.where(live_p[:, None], jnp.stack(words, axis=1), 0)
    stats = {"pairs_total": total, "pairs_overflow": overflow}
    return records, tile_start, tile_count, stats
