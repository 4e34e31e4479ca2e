"""Visibility kernel: tile-binned rasterization with a D16 depth key.

The hot loop of the framework — the software replacement for the GPU's
fixed-function rasterizer + depth unit (the reference's single
``cmd_draw_indexed``, ``src/renderer.rs:533-540``).  One Triton program per
framebuffer tile: the tile's (d16, tri_id) accumulators stay in registers
while a loop streams that tile's ``[start, start + count)`` binned records,
one contiguous 16-word row per triangle (ops/binning.py record layout).

Per triangle: evaluate the three int32 edge functions from the tile-corner
values and per-sample increments, apply the top-left fill rule, interpolate
D16 depth, and merge with the order-independent key min
(specmath.depth_key_better).  Two triangles hitting one pixel are resolved
by compare-select, so the result does not depend on record order.

The kernel compiles through Pallas' Triton route on the GPU and runs under
``interpret=True`` on the CPU, which is how the tests check it bit for bit
against the oracle.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from .. import specmath as sm
from ..config import RasterConfig
from .binning import RECORD_WORDS

I32 = np.int32

# Triton warps per tile program: one warp covers a 4x64 tile at 8 pixels
# per thread (tile shape and warps chosen on an H100, PERF.md)
NUM_WARPS = 1


def _eval_record(f, col_s, row_s, d, t):
    """Merge one record (sequence of its 16 int32 words) into the (d, t)
    accumulators; every operand broadcasts against col_s / row_s."""
    e0 = (f[6] + f[0] * col_s) + f[1] * row_s
    e1 = (f[7] + f[2] * col_s) + f[3] * row_s
    e2 = (f[8] + f[4] * col_s) + f[5] * row_s
    bias = f[13]
    # top-left rule: covered iff E_i >= (1 - topleft_bit)
    cov = (
        (e0 >= I32(1) - (bias & 1))
        & (e1 >= I32(1) - ((bias >> 1) & 1))
        & (e2 >= I32(1) - ((bias >> 2) & 1))
    )

    def merge(dt):
        d, t = dt
        inv_area = jax.lax.bitcast_convert_type(f[14], jnp.float32)
        d16 = sm.interp_depth16(e0, e1, e2, inv_area, f[9], f[10], f[11], jnp)
        better = cov & sm.depth_key_better(d16, f[12], d, t)
        return jnp.where(better, d16, d), jnp.where(better, f[12], t)

    # skip the depth work when the triangle covers no sample of the tile
    # (measured faster on the H100, PERF.md)
    return jax.lax.cond(
        jnp.max(cov.astype(I32)) > 0, merge, lambda dt: dt, (d, t)
    )


def _kernel(start_ref, count_ref, rec_ref, vis_d_ref, vis_t_ref, *,
            cfg: RasterConfig):
    tile = pl.program_id(0)
    start = start_ref[tile]
    count = count_ref[tile]
    shape = (cfg.tile_h, cfg.tile_w)
    ss = cfg.subpixel_scale
    # tile-local sample offsets in subpixel units (corner sample is offset 0)
    col_s = jax.lax.broadcasted_iota(I32, shape, 1) * ss
    row_s = jax.lax.broadcasted_iota(I32, shape, 0) * ss

    last = rec_ref.shape[0] - 1

    def load(j):
        j = jnp.minimum(j, last)
        return [rec_ref[j, k] for k in range(RECORD_WORDS - 1)]

    def body(j, carry):
        f, d, t = carry
        # issue the next record's loads before this record's arithmetic:
        # the loop is bound by load latency, not by the per-pixel work
        nxt = load(j + 1)
        return (nxt, *_eval_record(f, col_s, row_s, d, t))

    _, d, t = jax.lax.fori_loop(
        start, start + count, body,
        (load(start), jnp.full(shape, sm.DEPTH_MAX, I32),
         jnp.full(shape, sm.BG_TRI, I32)),
    )
    vis_d_ref[...] = d
    vis_t_ref[...] = t


@functools.partial(
    jax.jit, static_argnames=("cfg", "interpret", "tile_rows")
)
def rasterize_visibility(
    records, tile_start, tile_count, cfg: RasterConfig,
    interpret: bool = False, tile_rows: int | None = None
):
    """records: (P, 16) i32; returns (vis_d16, vis_tri) cropped to
    (height, width).  tile_rows renders only a slab of that many tile rows
    (records must be binned with the matching window) — the multi-device
    sharding path."""
    full = tile_rows is None
    if full:
        tile_rows = cfg.grid_h
    out = jax.ShapeDtypeStruct(
        (tile_rows * cfg.tile_h, cfg.grid_w * cfg.tile_w), I32
    )
    block = pl.BlockSpec(
        (cfg.tile_h, cfg.tile_w), lambda t: (t // cfg.grid_w, t % cfg.grid_w)
    )
    whole = pl.BlockSpec(memory_space=pl.ANY)
    vis_d, vis_t = pl.pallas_call(
        functools.partial(_kernel, cfg=cfg),
        out_shape=(out, out),
        grid=(tile_rows * cfg.grid_w,),
        in_specs=[whole, whole, whole],
        out_specs=(block, block),
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=NUM_WARPS),
        interpret=interpret,
        name="rasterize_visibility",
    )(tile_start, tile_count, records)
    rows = cfg.height if full else vis_d.shape[0]
    return vis_d[:rows, : cfg.width], vis_t[:rows, : cfg.width]
