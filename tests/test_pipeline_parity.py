"""End-to-end device pipeline vs CPU oracle: pixel-exact frame parity.

The device path runs the REAL Pallas kernel in interpret mode on the CPU
backend; on a GPU the same kernel compiles through Triton (chip_smoke.py
checks parity there).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from ash_renderer import (
    Camera,
    DirectionalLight,
    Material,
    Mesh,
    RendererSettings,
    Scene,
    SceneObject,
    derive_raster_config,
    mathx,
    reference_two_triangle_scene,
)
from ash_renderer.oracle import render_oracle
from ash_renderer.oracle.raster_cpu import compose_mvp
from ash_renderer.pipeline import FrameStatics, render_frame_jit
from ash_renderer.rtypes import LightPack, MaterialsPack
from ash_renderer.textures import TextureAtlas, checkerboard


def materials_pack(scene):
    return MaterialsPack(
        base_color=np.array([m.base_color for m in scene.materials], np.float32),
        tex_id=np.array([m.texture_id for m in scene.materials], np.int32),
        specular=np.array([m.specular for m in scene.materials], np.float32),
        shininess=np.array([m.shininess for m in scene.materials], np.int32),
    )


def light_pack(light):
    if light is None:
        return None
    return LightPack(
        direction=np.asarray(light.direction, np.float32),
        color=np.asarray(light.color, np.float32),
        ambient=np.float32(light.ambient),
    )


def run_device(scene, settings, camera, atlas=None):
    cfg = derive_raster_config(settings.render_width, settings.render_height)
    packed = scene.pack()
    view = camera.view_matrix()
    proj = camera.projection_matrix(settings.render_width / settings.render_height)
    model_mats = scene.model_matrices()
    mvp = compose_mvp(model_mats, view, proj)
    mats = materials_pack(scene)
    light = light_pack(scene.light)
    statics = FrameStatics(
        cfg=cfg,
        settings=settings,
        has_materials=True,
        has_atlas=atlas is not None,
        has_light=light is not None,
        interpret=True,
    )
    rgba8, aux = render_frame_jit(
        statics,
        jnp.asarray(packed.positions),
        jnp.asarray(packed.vert_obj),
        jnp.asarray(packed.normals),
        jnp.asarray(packed.colors),
        jnp.asarray(packed.uvs),
        jnp.asarray(packed.tri_v),
        jnp.asarray(packed.tri_obj),
        jnp.asarray(packed.obj_material),
        jnp.asarray(model_mats),
        jnp.asarray(mvp),
        jnp.asarray(camera.position.astype(np.float32)),
        mats,
        atlas,
        light,
    )
    return np.asarray(rgba8), {k: np.asarray(v) for k, v in aux.items()}


def run_oracle(scene, settings, camera, atlas=None):
    packed = scene.pack()
    view = camera.view_matrix()
    proj = camera.projection_matrix(settings.render_width / settings.render_height)
    return render_oracle(
        packed,
        scene.model_matrices(),
        view,
        proj,
        settings,
        materials=materials_pack(scene),
        atlas=atlas,
        light=light_pack(scene.light),
        camera_pos=camera.position.astype(np.float32),
    )


def assert_frame_parity(scene, settings, camera=None, atlas=None):
    camera = camera or Camera()
    d_rgba8, d_aux = run_device(scene, settings, camera, atlas)
    o = run_oracle(scene, settings, camera, atlas)
    np.testing.assert_array_equal(d_aux["vis_tri"], o["vis_tri"])
    np.testing.assert_array_equal(d_aux["vis_d16"], o["vis_d16"])
    np.testing.assert_array_equal(d_rgba8, o["rgba8"])
    return d_rgba8, d_aux


def test_reference_scene_full_parity():
    scene = reference_two_triangle_scene()
    settings = RendererSettings(width=256, height=192)
    rgba8, aux = assert_frame_parity(scene, settings)
    assert (aux["vis_tri"] >= 0).sum() > 500  # the z=2 triangle is visible


def test_random_scene_parity():
    rng = np.random.default_rng(5)
    nv, nt = 100, 80
    pos = rng.uniform(-2, 2, (nv, 3)).astype(np.float32)
    pos[:, 2] += 3.5
    mesh = Mesh(
        positions=pos,
        indices=rng.integers(0, nv, (nt, 3)).astype(np.int32),
        colors=rng.uniform(0, 1, (nv, 4)).astype(np.float32),
    )
    scene = Scene()
    scene.add_object(SceneObject(mesh=scene.add_mesh(mesh)))
    settings = RendererSettings(width=160, height=96)
    rgba8, aux = assert_frame_parity(scene, settings)
    assert (aux["vis_tri"] >= 0).sum() > 100


def test_clip_heavy_scene_parity():
    rng = np.random.default_rng(6)
    nv, nt = 60, 50
    pos = rng.uniform(-4, 4, (nv, 3)).astype(np.float32)
    pos[:, 2] += 0.8  # straddles the near plane
    mesh = Mesh(
        positions=pos,
        indices=rng.integers(0, nv, (nt, 3)).astype(np.int32),
        colors=rng.uniform(0, 1, (nv, 4)).astype(np.float32),
    )
    scene = Scene()
    scene.add_object(SceneObject(mesh=scene.add_mesh(mesh)))
    settings = RendererSettings(width=128, height=64)
    assert_frame_parity(scene, settings)


def test_lit_textured_supersampled_parity():
    rng = np.random.default_rng(8)
    nv, nt = 64, 48
    pos = rng.uniform(-1.5, 1.5, (nv, 3)).astype(np.float32)
    pos[:, 2] += 3.0
    mesh = Mesh(
        positions=pos,
        indices=rng.integers(0, nv, (nt, 3)).astype(np.int32),
        colors=rng.uniform(0.2, 1, (nv, 4)).astype(np.float32),
        uvs=rng.uniform(0, 2, (nv, 2)).astype(np.float32),
    ).compute_normals()
    scene = Scene(
        materials=[Material(texture_id=0, specular=0.5, shininess=32)],
        light=DirectionalLight(direction=(0.4, -0.6, 0.7), ambient=0.2),
    )
    scene.add_object(SceneObject(mesh=scene.add_mesh(mesh)))
    atlas = TextureAtlas.build([checkerboard(64)])
    settings = RendererSettings(width=96, height=64, supersample=2)
    assert_frame_parity(scene, settings, atlas=atlas)


def test_multi_object_depth_overlap_parity():
    """BASELINE config 2: multi-mesh scene, per-object models, depth overlap."""
    rng = np.random.default_rng(10)
    quad = Mesh(
        positions=np.array(
            [[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]], np.float32
        ),
        indices=np.array([[0, 2, 1], [0, 3, 2]], np.int32),
        colors=rng.uniform(0, 1, (4, 4)).astype(np.float32),
    )
    scene = Scene()
    mi = scene.add_mesh(quad)
    for i in range(5):
        scene.add_object(
            SceneObject(
                mesh=mi,
                model=mathx.compose(
                    mathx.translation([0.3 * i - 0.6, 0.2 * i - 0.4, 2.5 + 0.5 * i]),
                    mathx.rotation_z(0.3 * i),
                ),
            )
        )
    settings = RendererSettings(width=144, height=112)
    rgba8, aux = assert_frame_parity(scene, settings)
    assert len(np.unique(aux["vis_tri"][aux["vis_tri"] >= 0])) >= 3
