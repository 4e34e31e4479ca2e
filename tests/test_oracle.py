"""Oracle rasterizer tests: hand-computed goldens, fill-rule properties, and
the reference scene's exact semantics (only the z=2 triangle is front-facing
under CCW-front + back-cull)."""

import numpy as np
import pytest

from ash_renderer import (
    Camera,
    Mesh,
    RendererSettings,
    Scene,
    SceneObject,
    derive_raster_config,
    reference_two_triangle_scene,
)
from ash_renderer import mathx, specmath as sm
from ash_renderer.oracle import geometry_oracle, visibility_oracle, render_oracle


def _render_simple(scene, settings, camera=None):
    cam = camera or Camera()
    packed = scene.pack()
    cfg = derive_raster_config(settings.render_width, settings.render_height)
    view = cam.view_matrix()
    proj = cam.projection_matrix(settings.render_width / settings.render_height)
    su, attrs = geometry_oracle(
        packed, scene.model_matrices(), view, proj, cfg, settings.clip_budget
    )
    vis_d, vis_t = visibility_oracle(su, cfg)
    return su, attrs, vis_d, vis_t, cfg


def test_reference_scene_culling():
    """The z=3 triangle winds clockwise in framebuffer space -> culled."""
    scene = reference_two_triangle_scene()
    settings = RendererSettings(width=800, height=600)
    su, attrs, vis_d, vis_t, cfg = _render_simple(scene, settings)
    assert bool(su.valid[0])  # z=2 triangle front-facing
    assert not bool(su.valid[1])  # z=3 triangle culled
    # the surviving triangle actually covers pixels
    covered = vis_t >= 0
    assert covered.sum() > 1000
    assert set(np.unique(vis_t[covered])) == {0}
    # depth of the z=2 plane: z_ndc = (m22*(-2) + m23)/2 with GL-style proj
    proj = Camera().projection_matrix(800 / 600)
    z_ndc = (proj[2, 2] * -2.0 + proj[2, 3]) / 2.0
    d16 = int(round(z_ndc * 65535))
    ds = vis_d[covered]
    assert np.abs(ds - d16).max() <= 2  # interpolation quantization slack


def test_reference_scene_geometry_position():
    """The z=2 triangle's apex is near screen x=400 (center), bottom edge
    near the bottom; hand-derived from the matrix stack."""
    scene = reference_two_triangle_scene()
    settings = RendererSettings(width=800, height=600)
    su, attrs, vis_d, vis_t, cfg = _render_simple(scene, settings)
    ss = cfg.subpixel_scale
    xs = np.array([su.x0[0], su.x1[0], su.x2[0]]) / ss
    ys = np.array([su.y0[0], su.y1[0], su.y2[0]]) / ss
    # apex (world (0,-1,2)) projects to x=400, y ~ 31.5; base y ~ 568
    assert min(abs(xs - 400.0)) < 1.0
    assert abs(min(ys) - 31.4) < 2.0
    assert abs(max(ys) - 568.5) < 2.0


def _screen_tri_scene(pts2d, w, h, colors=None, depth=0.5):
    """Place one triangle at exact NDC coords via w=1 geometry and an identity
    view/proj, by crafting positions so that clip = (x_ndc, y_ndc, z, 1)."""
    pts = np.asarray(pts2d, dtype=np.float32)
    ndc = np.stack(
        [
            pts[:, 0] / w * 2.0 - 1.0,
            pts[:, 1] / h * 2.0 - 1.0,
            np.full(len(pts), depth, np.float32),
        ],
        axis=1,
    )
    mesh = Mesh(
        positions=ndc,
        indices=np.arange(len(pts), dtype=np.int32).reshape(-1, 3),
        colors=colors,
    )
    scene = Scene()
    scene.add_object(SceneObject(mesh=scene.add_mesh(mesh)))
    return scene


IDENTITY_CAM_VIEW = np.eye(4, dtype=np.float32)


def _render_ndc(scene, w, h, clip_budget=64):
    """Render with identity view/proj: positions are already NDC."""
    packed = scene.pack()
    cfg = derive_raster_config(w, h)
    su, attrs = geometry_oracle(
        packed,
        scene.model_matrices(),
        np.eye(4, dtype=np.float32),
        np.eye(4, dtype=np.float32),
        cfg,
        clip_budget,
    )
    vis_d, vis_t = visibility_oracle(su, cfg)
    return su, attrs, vis_d, vis_t, cfg


def test_single_triangle_coverage_golden():
    # Screen-space right triangle with vertices at pixel corners:
    # (10,10), (50,10), (10,50) in a 64x64 target, wound to be front-facing.
    # Note y-down: front-facing requires shoelace < 0.
    scene = _screen_tri_scene([(10, 10), (10, 50), (50, 10)], 64, 64)
    su, attrs, vis_d, vis_t, cfg = _render_ndc(scene, 64, 64)
    assert su.valid[0]
    cov = vis_t >= 0
    # Interior: pixels with center strictly inside the triangle
    # x+y < 60 boundary is the diagonal (hypotenuse) edge.
    for px, py, expect in [
        (10, 10, True),  # top-left corner pixel: on top & left edges -> in
        (49, 10, False),  # on the diagonal edge? center (49.5,10.5): x+y=60 on diag -> right edge, out
        (30, 30, False),  # center (30.5,30.5) gives x+y=61 > 60 -> outside
        (29, 29, True),  # center (29.5,29.5) x+y=59 < 60 -> inside
        (9, 10, False),
        (10, 49, False),  # center (10.5,49.5) x+y=60 on diagonal -> out
        (10, 48, True),
    ]:
        assert bool(cov[py, px]) == expect, (px, py, expect)


def test_watertight_shared_edge():
    """Two triangles sharing a diagonal edge: every pixel in the union square
    is covered exactly once (no double-hit, no gap)."""
    pts = [(8, 8), (8, 40), (40, 8), (40, 40)]
    # triangle A: 0,1,2 ; triangle B: 2,1,3 — both need front winding.
    scene = Scene()
    mesh = Mesh(
        positions=np.array(
            [
                [p[0] / 64 * 2 - 1, p[1] / 64 * 2 - 1, 0.5]
                for p in pts
            ],
            dtype=np.float32,
        ),
        indices=np.array([[0, 1, 2], [2, 1, 3]], dtype=np.int32),
    )
    scene.add_object(SceneObject(mesh=scene.add_mesh(mesh)))
    su, attrs, vis_d, vis_t, cfg = _render_ndc(scene, 64, 64)
    assert su.valid.sum() == 2
    cov = vis_t >= 0
    # interior of the square: pixel centers in (8.5..39.5)^2 -> pixels 8..39
    assert cov[8:40, 8:40].all()
    assert not cov[:8, :].any() and not cov[:, :8].any()
    assert not cov[40:, :].any() and not cov[:, 40:].any()
    # watertight: the diagonal pixels belong to exactly one triangle — implied
    # by vis_tri being single-valued; double-hits can't be observed here, so
    # check via equal-depth tie rule: depth identical, so winner must be the
    # later-drawn triangle (idx 1) strictly on its side and on the shared edge
    # only where the fill rule assigns it.
    assert set(np.unique(vis_t[cov])) == {0, 1}


def test_backface_culled_in_ndc():
    # reversed winding -> shoelace > 0 -> culled
    scene = _screen_tri_scene([(10, 10), (50, 10), (10, 50)], 64, 64)
    su, attrs, vis_d, vis_t, cfg = _render_ndc(scene, 64, 64)
    assert not su.valid.any()
    assert (vis_t == sm.BG_TRI).all()


def test_depth_occlusion_and_tie():
    # two overlapping triangles at different depths: nearer wins
    sc = Scene()
    tri = lambda z: Mesh(
        positions=np.array(
            [[-0.5, -0.5, z], [-0.5, 0.5, z], [0.5, -0.5, z]], np.float32
        ),
        indices=np.array([[0, 1, 2]], np.int32),
    )
    a = sc.add_mesh(tri(0.25))
    b = sc.add_mesh(tri(0.75))
    sc.add_object(SceneObject(mesh=a))
    sc.add_object(SceneObject(mesh=b))
    su, attrs, vis_d, vis_t, cfg = _render_ndc(sc, 64, 64)
    cov = vis_t >= 0
    assert set(np.unique(vis_t[cov])) == {0}
    # same depth: later draw (higher setup row) wins ties
    sc2 = Scene()
    a2 = sc2.add_mesh(tri(0.5))
    b2 = sc2.add_mesh(tri(0.5))
    sc2.add_object(SceneObject(mesh=a2))
    sc2.add_object(SceneObject(mesh=b2))
    su2, _, _, vt2, _ = _render_ndc(sc2, 64, 64)
    assert set(np.unique(vt2[vt2 >= 0])) == {1}


def test_near_clip_produces_two_triangles():
    """A triangle crossing z_c=0 clips into a quad (2 fan triangles)."""
    # Use a real perspective camera; put one vertex behind the near plane.
    cam = Camera()
    sc = Scene()
    mesh = Mesh(
        positions=np.array(
            [[-1.0, 1.0, 2.0], [1.0, 1.0, 2.0], [0.0, -1.0, -1.0]],
            np.float32,
        ),
        indices=np.array([[0, 1, 2]], np.int32),
    )
    sc.add_object(SceneObject(mesh=sc.add_mesh(mesh)))
    settings = RendererSettings(width=128, height=128)
    packed = sc.pack()
    cfg = derive_raster_config(128, 128)
    su, attrs = geometry_oracle(
        packed,
        sc.model_matrices(),
        cam.view_matrix(),
        cam.projection_matrix(1.0),
        cfg,
        settings.clip_budget,
    )
    # clip outputs land in the extra region (row >= padded tri count)
    t_pad = len(packed.tri_v)
    assert not su.valid[:t_pad].any()
    n_clip = su.valid[t_pad:].sum()
    assert n_clip >= 1  # at least part of it is visible


def test_guard_band_avoids_clipping():
    """A triangle slightly off-screen but inside the guard band takes the
    fast path (its setup row == its input row) and is scissored by raster."""
    scene = _screen_tri_scene([(-10, 10), (-10, 50), (30, 10)], 64, 64)
    su, attrs, vis_d, vis_t, cfg = _render_ndc(scene, 64, 64)
    assert su.valid[0]  # fast path row
    cov = vis_t >= 0
    assert cov.any()
    assert not cov[:, 31:].any()  # nothing past the hypotenuse


def test_color_interpolation_golden():
    """Flat color triangle shades to its color; checks shared shade()."""
    scene = _screen_tri_scene(
        [(0, 0), (0, 64), (64, 0)],
        64,
        64,
        colors=np.array(
            [[1, 0, 0, 1], [1, 0, 0, 1], [1, 0, 0, 1]], np.float32
        ),
    )
    packed = scene.pack()
    out = render_oracle(
        packed,
        scene.model_matrices(),
        np.eye(4, dtype=np.float32),
        np.eye(4, dtype=np.float32),
        RendererSettings(width=64, height=64),
    )
    cov = out["vis_tri"] >= 0
    assert cov.any()
    rgba8 = out["rgba8"]
    assert (rgba8[cov] == np.array([255, 0, 0, 255], np.uint8)).all()
    assert (rgba8[~cov] == np.array([0, 0, 0, 255], np.uint8)).all()


def test_vertex_color_gradient():
    scene = _screen_tri_scene(
        [(0, 0), (0, 64), (64, 0)],
        64,
        64,
        colors=np.array(
            [[1, 0, 0, 1], [0, 1, 0, 1], [0, 0, 1, 1]], np.float32
        ),
    )
    packed = scene.pack()
    out = render_oracle(
        packed,
        scene.model_matrices(),
        np.eye(4, dtype=np.float32),
        np.eye(4, dtype=np.float32),
        RendererSettings(width=64, height=64),
    )
    rgba8 = out["rgba8"]
    # near vertex 0 (top-left): red dominates
    assert rgba8[1, 1, 0] > 200
    # near vertex 1 (bottom-left): green dominates (pixel (0,62) center
    # (0.5,62.5) is inside; (1,62) lies exactly on the hypotenuse -> excluded)
    assert rgba8[62, 0, 1] > 200
    # near vertex 2 (top-right): blue dominates
    assert rgba8[1, 61, 2] > 200
