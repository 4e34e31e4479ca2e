"""Multi-device sharding tests on the 8-virtual-device CPU mesh: the sharded
tile-row renderer must reproduce the single-device frame bit-for-bit."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ash_renderer import (
    Camera,
    Mesh,
    RendererSettings,
    Scene,
    SceneObject,
    derive_raster_config,
)
from ash_renderer.oracle.raster_cpu import compose_mvp
from ash_renderer.parallel import make_render_mesh, render_frame_sharded
from ash_renderer.pipeline import FrameStatics, render_frame_jit
from ash_renderer.rtypes import MaterialsPack


def _scene(seed=3, nv=90, nt=70):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-2, 2, (nv, 3)).astype(np.float32)
    pos[:, 2] += 3.0
    mesh = Mesh(
        positions=pos,
        indices=rng.integers(0, nv, (nt, 3)).astype(np.int32),
        colors=rng.uniform(0, 1, (nv, 4)).astype(np.float32),
    )
    sc = Scene()
    sc.add_object(SceneObject(mesh=sc.add_mesh(mesh)))
    return sc


@pytest.mark.parametrize("n_dev", [2, 8])
def test_sharded_matches_single_device(n_dev):
    devices = jax.devices()[:n_dev]
    assert len(devices) == n_dev
    mesh = make_render_mesh(devices)

    scene = _scene()
    height = 8 * 8 * n_dev  # grid_h divisible by n_dev
    settings = RendererSettings(
        width=128, height=height, clip_budget=128, max_pairs=1 << 14
    )
    cam = Camera()
    cfg = derive_raster_config(128, height)
    packed = scene.pack()
    view = cam.view_matrix()
    proj = cam.projection_matrix(128 / height)
    mm = scene.model_matrices()
    mvp = compose_mvp(mm, view, proj)
    mats = MaterialsPack(
        base_color=np.ones((1, 4), np.float32),
        tex_id=np.full(1, -1, np.int32),
        specular=np.zeros(1, np.float32),
        shininess=np.full(1, 32, np.int32),
    )
    statics = FrameStatics(
        cfg=cfg, settings=settings, has_materials=True, has_atlas=False,
        has_light=False, interpret=True,
    )
    arrs = (
        jnp.asarray(packed.positions), jnp.asarray(packed.vert_obj),
        jnp.asarray(packed.normals), jnp.asarray(packed.colors),
        jnp.asarray(packed.uvs), jnp.asarray(packed.tri_v),
        jnp.asarray(packed.tri_obj), jnp.asarray(packed.obj_material),
        jnp.asarray(mm), jnp.asarray(mvp),
        jnp.asarray(cam.position.astype(np.float32)),
    )
    single, aux = render_frame_jit(statics, *arrs, mats, None, None)
    sharded, sstats = jax.jit(
        lambda *a: render_frame_sharded(statics, mesh, *a)
    )(*arrs, mats, None, None)
    assert (np.asarray(aux["vis_tri"]) >= 0).sum() > 50
    assert int(np.asarray(sstats["pairs_overflow"])) == 0
    np.testing.assert_array_equal(np.asarray(single), np.asarray(sharded))


def test_sharded_concentrated_slab_budget():
    """All geometry concentrated in ONE slab: every slab gets the full pair
    budget (not budget/n_dev), so a scene that fits single-device must render
    bit-identically sharded — the round-1 silent-drop regression."""
    n_dev = 8
    devices = jax.devices()[:n_dev]
    mesh = make_render_mesh(devices)

    # dense stack of triangles squeezed into a thin horizontal band (one
    # slab's rows) near the top of the screen
    rng = np.random.default_rng(11)
    nv, nt = 240, 700
    pos = rng.uniform(-2, 2, (nv, 3)).astype(np.float32)
    pos[:, 1] = rng.uniform(-1.35, -1.05, nv).astype(np.float32)  # thin band
    pos[:, 2] += 3.0
    m = Mesh(
        positions=pos,
        indices=rng.integers(0, nv, (nt, 3)).astype(np.int32),
        colors=rng.uniform(0, 1, (nv, 4)).astype(np.float32),
    )
    sc = Scene()
    sc.add_object(SceneObject(mesh=sc.add_mesh(m)))

    height = 8 * 8 * n_dev
    # budget sized so the full scene fits, but budget // n_dev would not
    settings = RendererSettings(
        width=128, height=height, clip_budget=512, max_pairs=1 << 15
    )
    cam = Camera()
    cfg = derive_raster_config(128, height)
    packed = sc.pack()
    view = cam.view_matrix()
    proj = cam.projection_matrix(128 / height)
    mm = sc.model_matrices()
    mvp = compose_mvp(mm, view, proj)
    mats = MaterialsPack(
        base_color=np.ones((1, 4), np.float32),
        tex_id=np.full(1, -1, np.int32),
        specular=np.zeros(1, np.float32),
        shininess=np.full(1, 32, np.int32),
    )
    statics = FrameStatics(
        cfg=cfg, settings=settings, has_materials=True, has_atlas=False,
        has_light=False, interpret=True,
    )
    arrs = (
        jnp.asarray(packed.positions), jnp.asarray(packed.vert_obj),
        jnp.asarray(packed.normals), jnp.asarray(packed.colors),
        jnp.asarray(packed.uvs), jnp.asarray(packed.tri_v),
        jnp.asarray(packed.tri_obj), jnp.asarray(packed.obj_material),
        jnp.asarray(mm), jnp.asarray(mvp),
        jnp.asarray(cam.position.astype(np.float32)),
    )
    single, aux = render_frame_jit(statics, *arrs, mats, None, None)
    pairs = int(np.asarray(aux["pairs_total"]))
    assert int(np.asarray(aux["pairs_overflow"])) == 0
    assert pairs > settings.max_pairs // n_dev, (
        "test must exceed the old divided budget to be meaningful"
    )
    sharded, sstats = jax.jit(
        lambda *a: render_frame_sharded(statics, mesh, *a)
    )(*arrs, mats, None, None)
    assert int(np.asarray(sstats["pairs_overflow"])) == 0
    np.testing.assert_array_equal(np.asarray(single), np.asarray(sharded))


def test_graft_entry_single_chip():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "graft_entry", "__graft_entry__.py"
    )
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    fn, args = m.entry()
    rgba8, aux = jax.jit(fn).lower(*args).compile()(*args)
    assert np.asarray(rgba8).shape[-1] == 4


def test_graft_entry_multichip():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "graft_entry", "__graft_entry__.py"
    )
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    m.dryrun_multichip(4)


# ---------------------------------------------------------------------------
# Renderer facade multi-device path: Renderer(scene, settings, mesh=...) /
# RendererSettings.n_devices must route through the sharded pipeline with
# no direct parallel/ imports by the user, bit-equal to single-device.
# ---------------------------------------------------------------------------


def test_renderer_mesh_facade_classic():
    import dataclasses

    from ash_renderer import Renderer

    mesh = make_render_mesh(jax.devices()[:2])
    scene = _scene()
    settings = RendererSettings(
        width=128, height=64, clip_budget=128, max_pairs=1 << 14,
    )
    cam = Camera()
    r_multi = Renderer(scene, settings, mesh=mesh)
    assert r_multi.warmup(parallel=False) >= 0.0
    rgba_m, aux_m = r_multi.render_frame(cam)
    assert int(np.asarray(aux_m["pairs_overflow"])) == 0
    rgba_s, _ = Renderer(scene, settings).render_frame(cam)
    np.testing.assert_array_equal(np.asarray(rgba_m), np.asarray(rgba_s))


def test_renderer_n_devices_facade_fused():
    """RendererSettings.n_devices routes the main pipeline through the
    sharded path (the name predates the single pipeline)."""
    import dataclasses

    from ash_renderer import Renderer

    scene = _scene()
    settings = RendererSettings(
        width=128, height=64, clip_budget=128, max_pairs=1 << 14,
        n_devices=2,
    )
    cam = Camera()
    r = Renderer(scene, settings)
    assert r.mesh is not None and r.mesh.devices.size == 2
    rgba_m, aux_m = r.render_frame(cam)
    assert int(np.asarray(aux_m["clip_overflow"])) == 0
    assert int(np.asarray(aux_m["pairs_overflow"])) == 0
    single = dataclasses.replace(settings, n_devices=None)
    rgba_s, _ = Renderer(scene, single).render_frame(cam)
    np.testing.assert_array_equal(np.asarray(rgba_m), np.asarray(rgba_s))


def test_renderer_indivisible_height_pads():
    """An indivisible tile-row count must WORK (padded slabs render
    background and the frame is cropped) and stay bit-equal to
    single-device — a window resize to an odd extent must never crash the
    loop (the reference's OUT_OF_DATE recovery never hard-fails,
    renderer.rs:416-428)."""
    import dataclasses

    from ash_renderer import Renderer

    scene = _scene()
    for height in (48, 80):  # grid_h 3 and 5: both odd vs 2 devices
        settings = RendererSettings(
            width=128, height=height, clip_budget=128, max_pairs=1 << 14,
            n_devices=2,
        )
        cam = Camera()
        rgba_m, _ = Renderer(scene, settings).render_frame(cam)
        single = dataclasses.replace(settings, n_devices=None)
        rgba_s, _ = Renderer(scene, single).render_frame(cam)
        assert rgba_m.shape == rgba_s.shape
        np.testing.assert_array_equal(np.asarray(rgba_m), np.asarray(rgba_s))


@pytest.mark.slow
def test_renderer_headline_1080p_8dev():
    """The full 1920x1080 headline shape through the Renderer facade on 8
    devices.  grid_h = 68 is indivisible by 8, so this exercises the
    pad-tile-rows-and-crop path at the exact decomposition the real
    headline uses — bitwise equal to the single-device frame."""
    import dataclasses

    from ash_renderer import Renderer

    scene = _scene(seed=11, nv=160, nt=240)
    settings = RendererSettings(
        width=1920, height=1080, clip_budget=256, max_pairs=1 << 15,
        n_devices=8,
    )
    cam = Camera()
    rgba_m, aux_m = Renderer(scene, settings).render_frame(cam)
    assert rgba_m.shape == (1080, 1920, 4)
    assert int(np.asarray(aux_m["clip_overflow"])) == 0
    single = dataclasses.replace(settings, n_devices=None)
    rgba_s, _ = Renderer(scene, single).render_frame(cam)
    np.testing.assert_array_equal(np.asarray(rgba_m), np.asarray(rgba_s))


@pytest.mark.parametrize("n_dev", [2, 4])
def test_sharded_dense_near_plane(n_dev):
    """A near-plane-crossing magnified sphere: triangles span many tiles and
    straddle the guard planes, so the sharded slabs bin long tile lists
    and a live Sutherland-Hodgman clip tail — still bitwise equal to the
    single-device frame."""
    import dataclasses

    from ash_renderer import Renderer, mathx
    from ash_renderer.models import icosphere

    scene = Scene()
    # camera just outside the unit sphere: magnified front cap crossing
    # the near plane
    scene.add_object(
        SceneObject(
            mesh=scene.add_mesh(icosphere(2)),
            model=mathx.translation([0, 0, 1.02]),
        )
    )
    settings = RendererSettings(
        width=128, height=160, clip_budget=512, max_pairs=1 << 14,
        n_devices=n_dev,
    )
    cam = Camera()
    rgba_m, aux_m = Renderer(scene, settings).render_frame(cam)
    single = dataclasses.replace(settings, n_devices=None)
    rgba_s, aux_s = Renderer(scene, single).render_frame(cam)
    assert int(np.asarray(aux_s["n_clipped"])) > 0
    assert int(np.asarray(aux_m["clip_overflow"])) == 0
    assert int(np.asarray(aux_m["pairs_overflow"])) == 0
    assert (np.asarray(aux_s["vis_tri"]) >= 0).sum() > 2000
    np.testing.assert_array_equal(np.asarray(rgba_m), np.asarray(rgba_s))
