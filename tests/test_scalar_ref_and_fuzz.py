"""Three-tier validation: scalar reference vs vectorized oracle, plus
randomized fuzz parity between oracle and device pipeline."""

import numpy as np
import pytest

from ash_renderer import (
    Camera,
    Mesh,
    RendererSettings,
    Scene,
    SceneObject,
    derive_raster_config,
)
from ash_renderer.oracle import geometry_oracle, visibility_oracle
from ash_renderer.oracle.scalar_ref import visibility_scalar


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_scalar_ref_matches_oracle(seed):
    rng = np.random.default_rng(seed)
    nv, nt = 24, 16
    pos = rng.uniform(-1.5, 1.5, (nv, 3)).astype(np.float32)
    pos[:, 2] += 2.5
    mesh = Mesh(
        positions=pos,
        indices=rng.integers(0, nv, (nt, 3)).astype(np.int32),
    )
    scene = Scene()
    scene.add_object(SceneObject(mesh=scene.add_mesh(mesh)))
    cfg = derive_raster_config(48, 32)
    cam = Camera()
    su, attrs = geometry_oracle(
        scene.pack(),
        scene.model_matrices(),
        cam.view_matrix(),
        cam.projection_matrix(48 / 32),
        cfg,
        32,
    )
    vd_o, vt_o = visibility_oracle(su, cfg)
    vd_s, vt_s = visibility_scalar(su, cfg)
    np.testing.assert_array_equal(vt_o, vt_s)
    np.testing.assert_array_equal(vd_o, vd_s)


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_device_oracle_parity(seed):
    """Randomized scenes including degenerate/duplicate/sliver triangles."""
    from tests.test_pipeline_parity import assert_frame_parity

    rng = np.random.default_rng(100 + seed)
    nv = int(rng.integers(12, 120))
    nt = int(rng.integers(8, 150))
    pos = rng.uniform(-3, 3, (nv, 3)).astype(np.float32)
    pos[:, 2] += rng.uniform(0.5, 5.0)
    idx = rng.integers(0, nv, (nt, 3)).astype(np.int32)
    # inject degeneracies: duplicated vertices and zero-area triangles
    idx[:: max(nt // 5, 1), 1] = idx[:: max(nt // 5, 1), 0]
    mesh = Mesh(
        positions=pos,
        indices=idx,
        colors=rng.uniform(0, 1, (nv, 4)).astype(np.float32),
    )
    scene = Scene()
    scene.add_object(SceneObject(mesh=scene.add_mesh(mesh)))
    settings = RendererSettings(
        width=int(rng.integers(40, 160) // 8 * 8) or 64,
        height=int(rng.integers(32, 120) // 8 * 8) or 32,
        clip_budget=256,
    )
    assert_frame_parity(scene, settings)


def test_triangle_fan_watertight():
    """A triangle fan: every interior pixel covered exactly once."""
    n = 12
    ang = np.linspace(0, 2 * np.pi, n + 1)
    rim = np.stack(
        [0.8 * np.cos(ang), 0.8 * np.sin(ang), np.full(n + 1, 0.5)], axis=1
    )
    pos = np.concatenate([[[0, 0, 0.5]], rim]).astype(np.float32)
    # wind so front-facing (shoelace < 0 in y-down screen coords)
    idx = np.array(
        [[0, 1 + (i + 1) % n, 1 + i] for i in range(n)], np.int32
    )
    scene = Scene()
    scene.add_object(SceneObject(mesh=scene.add_mesh(Mesh(pos, idx))))
    cfg = derive_raster_config(64, 64)
    su, attrs = geometry_oracle(
        scene.pack(),
        scene.model_matrices(),
        np.eye(4, dtype=np.float32),
        np.eye(4, dtype=np.float32),
        cfg,
        32,
    )
    kept = int(su.valid.sum())
    if kept == 0:  # other winding: flip and re-run
        idx = idx[:, [0, 2, 1]]
        scene2 = Scene()
        scene2.add_object(SceneObject(mesh=scene2.add_mesh(Mesh(pos, idx))))
        su, attrs = geometry_oracle(
            scene2.pack(),
            scene2.model_matrices(),
            np.eye(4, dtype=np.float32),
            np.eye(4, dtype=np.float32),
            cfg,
            32,
        )
        kept = int(su.valid.sum())
    assert kept == n
    vd, vt = visibility_oracle(su, cfg)
    cov = vt >= 0
    # interior disk fully covered (radius in pixels ~ 0.8*32 = 25.6)
    yy, xx = np.mgrid[0:64, 0:64]
    r = np.hypot(xx + 0.5 - 32, yy + 0.5 - 32)
    assert cov[r < 24].all()  # no gaps along shared fan edges
    assert not cov[r > 27].any()
