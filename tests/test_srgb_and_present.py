"""sRGB output end-to-end parity, frame pacing, terminal viewer."""

import io
import time

import numpy as np

from ash_renderer import Mesh, RendererSettings, Scene, SceneObject
from ash_renderer.present import FrameLimiter, TerminalViewer, write_gif
from tests.test_pipeline_parity import assert_frame_parity


def test_srgb_output_parity():
    rng = np.random.default_rng(21)
    nv, nt = 40, 30
    pos = rng.uniform(-1.5, 1.5, (nv, 3)).astype(np.float32)
    pos[:, 2] += 3.0
    mesh = Mesh(
        positions=pos,
        indices=rng.integers(0, nv, (nt, 3)).astype(np.int32),
        colors=rng.uniform(0, 1, (nv, 4)).astype(np.float32),
    )
    scene = Scene()
    scene.add_object(SceneObject(mesh=scene.add_mesh(mesh)))
    settings = RendererSettings(width=96, height=64, srgb_output=True)
    rgba8, aux = assert_frame_parity(scene, settings)
    cov = aux["vis_tri"] >= 0
    assert cov.any()
    # sRGB brightens midtones: covered pixels should skew brighter than
    # the same scene rendered linear
    lin8, _ = assert_frame_parity(
        scene, RendererSettings(width=96, height=64, srgb_output=False)
    )
    assert rgba8[cov][:, :3].mean() > lin8[cov][:, :3].mean()


def test_frame_limiter_modes():
    lim = FrameLimiter("fifo", refresh_rate=200)
    t0 = time.perf_counter()
    for _ in range(4):
        lim.pace()
    assert time.perf_counter() - t0 >= 0.012
    lim2 = FrameLimiter("mailbox")
    t0 = time.perf_counter()
    for _ in range(100):
        lim2.pace()
    assert time.perf_counter() - t0 < 0.05


def test_terminal_viewer_output():
    buf = io.StringIO()
    v = TerminalViewer(max_cols=8, stream=buf)
    frame = np.zeros((8, 16, 4), np.uint8)
    frame[..., 1] = 123
    v(frame)
    v(frame)
    s = buf.getvalue()
    assert "▀" in s and "38;2;0;123;0" in s and "\x1b[1F" in s


def test_write_gif(tmp_path):
    frames = [
        np.full((8, 8, 4), 40 * i, np.uint8) for i in range(3)
    ]
    p = str(tmp_path / "anim.gif")
    write_gif(p, frames, fps=10)
    from PIL import Image

    img = Image.open(p)
    assert img.n_frames == 3
