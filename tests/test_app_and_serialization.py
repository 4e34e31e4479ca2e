"""App shell frame loop, CLI, and scene serialization round trip."""

import os

import numpy as np
import pytest

from ash_renderer import (
    Camera,
    DirectionalLight,
    Material,
    RendererSettings,
    Scene,
    SceneObject,
    reference_two_triangle_scene,
)
from ash_renderer.app import App, InputEvent, render_to_images
from ash_renderer.models import cube
from ash_renderer.serialization import load_scene, save_scene
from ash_renderer.textures import TextureAtlas, checkerboard


def test_app_step_loop():
    app = App(
        reference_two_triangle_scene(),
        RendererSettings(width=96, height=64, clip_budget=64),
    )
    events = [InputEvent(forward=True)] * 3 + [InputEvent(mouse_dx=5.0)]
    stats = app.run(4, events)
    assert stats.n_frames == 4
    # forward x3 at default speed
    assert app.camera.position[2] == pytest.approx(0.03, abs=1e-6)
    assert app.camera.theta == pytest.approx(0.05)


def test_app_warmup_default_is_gpu_only(monkeypatch):
    """App precompiles stages by default, but ONLY where the kernels are
    compiled (a GPU): in CPU interpret mode the warmup costs more than the
    first frame it would hide (this suite runs on CPU — warmup must not
    run)."""
    from ash_renderer.renderer import Renderer

    def boom(self, parallel=True):  # pragma: no cover - must not be hit
        raise AssertionError("warmup() ran in interpret mode")

    monkeypatch.setattr(Renderer, "warmup", boom)
    App(
        reference_two_triangle_scene(),
        RendererSettings(width=96, height=64, clip_budget=64),
    )  # default warmup=True, CPU backend -> gate must skip it


def test_render_to_images(tmp_path):
    paths = render_to_images(
        reference_two_triangle_scene(),
        RendererSettings(width=64, height=48, clip_budget=64),
        [Camera(), Camera(theta=0.3)],
        str(tmp_path),
    )
    assert len(paths) == 2
    from PIL import Image

    img = np.asarray(Image.open(paths[0]))
    assert img.shape == (48, 64, 4)
    img2 = np.asarray(Image.open(paths[1]))
    assert not np.array_equal(img, img2)


def test_scene_serialization_roundtrip(tmp_path):
    scene = Scene(
        materials=[Material(base_color=(0.5, 0.6, 0.7, 1.0), texture_id=0,
                            specular=0.3, shininess=16)],
        light=DirectionalLight(direction=(0.1, -0.9, 0.3), ambient=0.2),
    )
    scene.atlas = TextureAtlas.build([checkerboard(16)])
    scene.add_object(SceneObject(mesh=scene.add_mesh(cube())))
    cams = [Camera(), Camera(theta=1.0)]
    path = os.path.join(str(tmp_path), "scene.npz")
    save_scene(path, scene, cams)
    back, back_cams = load_scene(path)
    assert len(back.meshes) == 1
    np.testing.assert_array_equal(
        back.meshes[0].positions, scene.meshes[0].positions
    )
    np.testing.assert_array_equal(
        back.meshes[0].indices, scene.meshes[0].indices
    )
    assert back.materials[0].texture_id == 0
    assert back.light.ambient == pytest.approx(0.2)
    np.testing.assert_array_equal(
        np.asarray(back.atlas.texels), np.asarray(scene.atlas.texels)
    )
    assert len(back_cams) == 2
    assert back_cams[1].theta == pytest.approx(1.0)

    # serialized scene renders identically
    from ash_renderer.oracle import render_oracle
    from ash_renderer.oracle.raster_cpu import compose_mvp

    st = RendererSettings(width=48, height=32, clip_budget=32)
    for sc in (scene, back):
        out = render_oracle(
            sc.pack(),
            sc.model_matrices(),
            cams[0].view_matrix(),
            cams[0].projection_matrix(48 / 32),
            st,
        )
        if sc is scene:
            first = out["rgba8"]
    np.testing.assert_array_equal(first, out["rgba8"])


def test_cli_smoke(tmp_path):
    from ash_renderer.app import main

    out = os.path.join(str(tmp_path), "frames")
    main(["reference", "--size", "64x48", "--out", out])
    assert os.path.exists(os.path.join(out, "frame_0000.png"))


def test_app_self_recovering_resize():
    """A resize event under a running loop recovers inside draw_frame —
    the OUT_OF_DATE/SUBOPTIMAL self-recovery (renderer.rs:416-428): no
    explicit renderer.resize() call anywhere."""
    from ash_renderer.present import FrameCollector

    app = App(
        reference_two_triangle_scene(),
        RendererSettings(width=96, height=64, clip_budget=64,
                         frames_in_flight=1),
    )
    coll = FrameCollector()
    app.step(on_present=coll)
    app.request_resize(128, 80)  # window event; loop keeps running
    app.step(on_present=coll)
    app.renderer.finish()
    assert app.renderer.settings.width == 128
    assert app.renderer.settings.height == 80
    shapes = [f.shape for f in coll.frames]
    assert (64, 96, 4) in shapes and (80, 128, 4) in shapes


def test_http_viewer_pixel_exact():
    """present.HttpViewer serves the LATEST presented frame as a lossless
    PNG: fetching /frame.png must reproduce the frame byte-for-byte (the
    pixel-accurate live-view contract), and /stats must serve JSON."""
    import io
    import json
    import urllib.request

    import numpy as np

    from ash_renderer.present import HttpViewer
    from ash_renderer.utils.profiling import FrameStats

    stats = FrameStats()
    v = HttpViewer(port=0, stats=stats)  # ephemeral port
    try:
        rng = np.random.default_rng(3)
        f1 = rng.integers(0, 256, (24, 32, 4), dtype=np.uint8)
        f2 = rng.integers(0, 256, (24, 32, 4), dtype=np.uint8)
        v(f1)
        v(f2)  # latest wins
        url = f"http://127.0.0.1:{v.port}"
        data = urllib.request.urlopen(f"{url}/frame.png", timeout=10).read()
        from PIL import Image

        got = np.asarray(Image.open(io.BytesIO(data)))
        np.testing.assert_array_equal(got, f2)
        st = json.loads(
            urllib.request.urlopen(f"{url}/stats", timeout=10).read()
        )
        assert st["frames"] == 0
        html = urllib.request.urlopen(url, timeout=10).read()
        assert b"frame.png" in html
    finally:
        v.close()


def test_frame_stats_summary_nonblocking():
    """VERDICT r3 #8: summary() must be async-safe — a pipeline counter
    still attached to an in-flight frame (is_ready() False) is reported as
    None rather than converted (conversion would block the host on the
    device pipeline, serializing an App loop that shows stats per frame).
    sync=True opts into blocking."""
    from ash_renderer.utils.profiling import FrameStats

    class InFlight:
        """Device-scalar stand-in whose conversion is a test failure."""

        def is_ready(self):
            return False

        def __int__(self):
            raise AssertionError("summary() blocked on an unready scalar")

    stats = FrameStats()
    stats.record_frame(0.01, aux={"n_clipped": InFlight()})
    out = stats.summary()  # must not raise: unready -> None
    assert out["n_clipped"] is None
    assert out["frames"] == 1

    class Ready:
        def is_ready(self):
            return True

        def __int__(self):
            return 7

    stats.record_frame(0.01, aux={"n_clipped": Ready()})
    assert stats.summary()["n_clipped"] == 7
