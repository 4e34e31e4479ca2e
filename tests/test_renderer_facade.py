"""Renderer facade: lifecycle tiers, frame loop, present ring, debug mode."""

import numpy as np
import pytest

from ash_renderer import Camera, RendererSettings, reference_two_triangle_scene
from ash_renderer.camera import CameraController
from ash_renderer.present import FrameCollector
from ash_renderer.renderer import Renderer
from ash_renderer.utils.debugging import validate_frame


@pytest.fixture(scope="module")
def renderer():
    scene = reference_two_triangle_scene()
    settings = RendererSettings(width=128, height=96, clip_budget=64)
    return Renderer(scene, settings)


def test_draw_frame_loop(renderer):
    cam = Camera()
    ctl = CameraController(speed=0.01, mouse_sens=0.01)
    collector = FrameCollector()
    presented = []
    for i in range(4):
        ctl.forward_pressed = True
        ctl.update_camera(cam)
        out = renderer.draw_frame(cam, on_present=collector)
        presented.append(out)
    rest = renderer.finish()
    # frames_in_flight=2: first two draws return None, later ones return
    # completed older frames
    assert presented[0] is None and presented[1] is None
    assert presented[2] is not None
    assert len(collector.frames) == 4
    assert collector.frames[0].shape == (96, 128, 4)
    # camera moved forward each frame -> triangle grows; frames differ
    assert not np.array_equal(collector.frames[0], collector.frames[-1])
    assert renderer.stats.n_frames == 4
    assert renderer.stats.summary()["frames"] == 4


def test_resize_rebuild(renderer):
    renderer.resize(160, 120)
    rgba8, aux = renderer.render_frame(Camera())
    assert np.asarray(rgba8).shape == (120, 160, 4)
    renderer.resize(128, 96)


def test_update_settings_rebuild(renderer):
    import dataclasses

    new = dataclasses.replace(
        renderer.settings, clear_color=(1.0, 0.0, 0.0, 1.0)
    )
    renderer.update_settings(new)
    rgba8, aux = renderer.render_frame(Camera())
    host = np.asarray(rgba8)
    bg = np.asarray(aux["vis_tri"]) < 0
    assert (host[bg] == np.array([255, 0, 0, 255], np.uint8)).all()


def test_validate_frame(renderer):
    rgba8, aux = renderer.render_frame(Camera())
    findings = validate_frame(aux, rgba8)
    assert all(f.severity != "ERROR" for f in findings)


def test_mesh_update(renderer):
    """update_vertices analogue: editing mesh data re-uploads geometry."""
    import copy

    scene = renderer.scene
    mesh = copy.deepcopy(scene.meshes[0])
    before = np.asarray(renderer.render_frame(Camera())[0]).copy()
    # (note: uniform scaling about the camera origin would be projectively
    # invisible; translate instead)
    mesh.positions = mesh.positions + np.float32([0.5, 0.2, 0.0])
    renderer.update_mesh(0, mesh)
    after = np.asarray(renderer.render_frame(Camera())[0])
    assert not np.array_equal(before, after)


def test_warmup_fused_stages():
    """Renderer.warmup precompiles the pipeline's stages from abstract
    shapes and the warmed renderer produces the same frame (the name
    predates the single pipeline)."""
    import numpy as np

    from ash_renderer import Mesh, RendererSettings, Scene, SceneObject
    from ash_renderer.renderer import Renderer

    rng = np.random.default_rng(2)
    nv, nt = 150, 4200
    pos = rng.uniform(-2, 2, (nv, 3)).astype(np.float32)
    pos[:, 2] += 3.0
    mesh = Mesh(
        positions=pos,
        indices=rng.integers(0, nv, (nt, 3)).astype(np.int32),
        colors=rng.uniform(0, 1, (nv, 4)).astype(np.float32),
    )
    sc = Scene()
    sc.add_object(SceneObject(mesh=sc.add_mesh(mesh)))
    settings = RendererSettings(width=128, height=96, clip_budget=128)
    r = Renderer(sc, settings)
    dt = r.warmup()
    assert dt >= 0.0
    rgba8, aux = r.render_frame(Camera())
    r2 = Renderer(sc, settings)
    rgba8_cold, _ = r2.render_frame(Camera())
    np.testing.assert_array_equal(np.asarray(rgba8), np.asarray(rgba8_cold))
    rgba8_c = rgba8

    # staged warmup calls the four _stage_* jits with the exact runtime
    # signature (not the monolithic jit the staged runtime never calls)
    r4 = Renderer(
        sc,
        RendererSettings(
            width=128, height=96, clip_budget=128, staged_pipeline=True
        ),
    )
    assert r4.warmup() >= 0.0
    rgba8_s, _ = r4.render_frame(Camera())
    np.testing.assert_array_equal(np.asarray(rgba8_c), np.asarray(rgba8_s))
