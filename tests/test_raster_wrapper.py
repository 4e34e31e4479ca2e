"""The visibility kernel's wrapper: record-list bounds, tile shapes, slab
windows, and the packed scene's padding rows through the main path."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ash_renderer import Camera, Mesh, Scene, SceneObject, derive_raster_config
from ash_renderer import specmath as sm
from ash_renderer.oracle import geometry_oracle, visibility_oracle
from ash_renderer.ops import binning, raster_pallas

F32 = np.float32
I32 = np.int32


def _scene(seed=0, nv=100, nt=120):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-2, 2, (nv, 3)).astype(F32)
    pos[:, 2] += 3.5
    scene = Scene()
    scene.add_object(
        SceneObject(
            mesh=scene.add_mesh(
                Mesh(positions=pos, indices=rng.integers(0, nv, (nt, 3)))
            )
        )
    )
    return scene


def _setup(cfg, seed=0):
    scene, cam = _scene(seed), Camera()
    su, _ = geometry_oracle(
        scene.pack(), scene.model_matrices(), cam.view_matrix(),
        cam.projection_matrix(cfg.width / cfg.height), cfg, 256,
    )
    return su


def numpy_raster(rec, ts, tc, cfg, tile_rows):
    """Straight per-tile, per-record evaluation of the record stream."""
    rec, ts, tc = np.asarray(rec), np.asarray(ts), np.asarray(tc)
    ss = cfg.subpixel_scale
    col = np.arange(cfg.tile_w, dtype=I32)[None, :] * ss
    row = np.arange(cfg.tile_h, dtype=I32)[:, None] * ss
    d = np.full((tile_rows * cfg.tile_h, cfg.grid_w * cfg.tile_w),
                sm.DEPTH_MAX, I32)
    t = np.full_like(d, sm.BG_TRI)
    for tile in range(tile_rows * cfg.grid_w):
        ty, tx = divmod(tile, cfg.grid_w)
        ys = slice(ty * cfg.tile_h, (ty + 1) * cfg.tile_h)
        xs = slice(tx * cfg.tile_w, (tx + 1) * cfg.tile_w)
        for j in range(ts[tile], ts[tile] + tc[tile]):
            f = rec[j]
            e = [f[6 + i] + f[2 * i] * col + f[2 * i + 1] * row
                 for i in range(3)]
            cov = np.ones(e[0].shape, bool)
            for i in range(3):
                cov &= e[i] >= 1 - ((f[13] >> i) & 1)
            inv = np.asarray(f[14], I32).view(F32)
            d16 = sm.interp_depth16(*e, inv, f[9], f[10], f[11], np)
            better = cov & sm.depth_key_better(d16, f[12], d[ys, xs],
                                               t[ys, xs])
            d[ys, xs] = np.where(better, d16, d[ys, xs])
            t[ys, xs] = np.where(better, f[12], t[ys, xs])
    return d, t


@pytest.mark.parametrize("limit", [0, 1, 2, 31])
def test_record_list_bounds(limit):
    """Per-tile lists cut to 0, 1, 2 and 31 records: the kernel reads
    exactly [start, start + count) of each tile."""
    cfg = derive_raster_config(160, 96)
    rec, ts, tc, _ = binning.bin_triangles(
        jax.tree.map(jnp.asarray, _setup(cfg)), cfg, 1 << 14
    )
    tc = jnp.minimum(tc, limit)
    kd, kt = raster_pallas.rasterize_visibility(
        rec, ts, tc, cfg, interpret=True
    )
    rd, rt = numpy_raster(rec, ts, tc, cfg, cfg.grid_h)
    np.testing.assert_array_equal(np.asarray(kt), rt[: cfg.height, : cfg.width])
    np.testing.assert_array_equal(np.asarray(kd), rd[: cfg.height, : cfg.width])
    if limit == 0:
        assert (np.asarray(kt) == sm.BG_TRI).all()


def test_records_past_the_last_list_are_ignored():
    """Rows after the last tile's list (here: a record covering every pixel
    with a winning id and depth 0) must never be read."""
    cfg = derive_raster_config(128, 64)
    rec, ts, tc, _ = binning.bin_triangles(
        jax.tree.map(jnp.asarray, _setup(cfg)), cfg, 1 << 13
    )
    end = int(ts[-1] + tc[-1])
    trap = np.zeros(16, I32)
    trap[12] = 1 << 30  # tri id beats everything on ties
    trap[13] = 7  # top-left on all edges: E == 0 covers
    rec_t = np.asarray(rec).copy()
    rec_t[end:] = trap
    base = raster_pallas.rasterize_visibility(rec, ts, tc, cfg, interpret=True)
    got = raster_pallas.rasterize_visibility(
        jnp.asarray(rec_t), ts, tc, cfg, interpret=True
    )
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(base[1]))
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(base[0]))


@pytest.mark.parametrize("tile", [(8, 128), (16, 64), (32, 32)])
def test_tile_shapes(tile):
    cfg = derive_raster_config(160, 96, tile_h=tile[0], tile_w=tile[1])
    su = _setup(cfg, seed=1)
    od, ot = visibility_oracle(su, cfg)
    rec, ts, tc, _ = binning.bin_triangles(
        jax.tree.map(jnp.asarray, su), cfg, 1 << 14
    )
    kd, kt = raster_pallas.rasterize_visibility(
        rec, ts, tc, cfg, interpret=True
    )
    np.testing.assert_array_equal(np.asarray(kt), ot)
    np.testing.assert_array_equal(np.asarray(kd), od)


def test_headline_tile_keeps_four_subpixel_bits():
    """The stored 1080p goldens were rendered with 4 subpixel bits."""
    assert derive_raster_config(1920, 1080).subpixel_bits == 4
    assert derive_raster_config(1600, 1200).subpixel_bits == 4


@pytest.mark.parametrize("row0,rows", [(0, 2), (1, 3), (4, 2)])
def test_slab_window(row0, rows):
    """A window of tile rows, binned and rasterized alone, equals those rows
    of the full frame (the sharded path's slabs)."""
    cfg = derive_raster_config(160, 96)  # grid_h 6
    su = _setup(cfg, seed=2)
    od, ot = visibility_oracle(su, cfg)
    rec, ts, tc, _ = binning.bin_triangles(
        jax.tree.map(jnp.asarray, su), cfg, 1 << 14, row0, rows
    )
    kd, kt = raster_pallas.rasterize_visibility(
        rec, ts, tc, cfg, interpret=True, tile_rows=rows
    )
    y0, y1 = row0 * cfg.tile_h, min((row0 + rows) * cfg.tile_h, cfg.height)
    np.testing.assert_array_equal(np.asarray(kt)[: y1 - y0], ot[y0:y1])
    np.testing.assert_array_equal(np.asarray(kd)[: y1 - y0], od[y0:y1])


def test_packed_padding_rows_are_invalid():
    """Meshlet packing pads each meshlet to 128 triangle rows with
    tri_v = -1; the device geometry stage must treat them as culled."""
    from ash_renderer import RendererSettings
    from ash_renderer.renderer import Renderer

    scene = _scene(nt=130)
    packed = scene.pack()
    assert packed.tri_v.shape[0] % 128 == 0
    pad = packed.tri_v[:, 0] < 0
    assert pad.sum() > 0
    r = Renderer(scene, RendererSettings(width=96, height=64, clip_budget=64))
    _, aux = r.render_frame(Camera())
    vis = np.asarray(aux["vis_tri"])
    assert not np.isin(vis[vis >= 0], np.nonzero(pad)[0]).any()
    assert int(aux["n_valid"]) <= int((~pad).sum())
