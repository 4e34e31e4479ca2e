"""The visibility kernel (interpret mode) against the oracle's visibility
buffer, bit for bit, over the regimes that stress coverage and the depth
key: random soups, clipping, grazing views, d16 ties decided by id,
coplanar duplicates, watertight fans, full-screen and empty frames, odd
resolutions and supersampled render sizes.

Geometry comes from the oracle, so these isolate binning + the kernel."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ash_renderer import (
    Camera,
    Mesh,
    Scene,
    SceneObject,
    derive_raster_config,
    mathx,
)
from ash_renderer.models import icosphere
from ash_renderer.oracle import geometry_oracle, visibility_oracle
from ash_renderer.ops import binning, raster_pallas

F32 = np.float32
I32 = np.int32


def kernel_vs_oracle(scene, width, height, cam=None, clip_budget=256,
                     max_pairs=1 << 15):
    cam = cam or Camera()
    cfg = derive_raster_config(width, height)
    su, _ = geometry_oracle(
        scene.pack(), scene.model_matrices(), cam.view_matrix(),
        cam.projection_matrix(width / height), cfg, clip_budget,
    )
    od, ot = visibility_oracle(su, cfg)
    rec, ts, tc, st = binning.bin_triangles(
        jax.tree.map(jnp.asarray, su), cfg, max_pairs
    )
    assert int(st["pairs_overflow"]) == 0
    kd, kt = raster_pallas.rasterize_visibility(
        rec, ts, tc, cfg, interpret=True
    )
    np.testing.assert_array_equal(np.asarray(kt), ot)
    np.testing.assert_array_equal(np.asarray(kd), od)
    return od, ot


def one_mesh(positions, indices, model=None):
    scene = Scene()
    scene.add_object(
        SceneObject(
            mesh=scene.add_mesh(
                Mesh(positions=np.asarray(positions, F32),
                     indices=np.asarray(indices, I32))
            ),
            model=mathx.IDENTITY if model is None else model,
        )
    )
    return scene


def soup(seed, nv=100, nt=120, spread=2.0, z=3.5):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-spread, spread, (nv, 3)).astype(F32)
    pos[:, 2] += z
    return one_mesh(pos, rng.integers(0, nv, (nt, 3)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_soup(seed):
    _, ot = kernel_vs_oracle(soup(seed), 160, 96)
    assert (ot >= 0).sum() > 1000


def test_clip_heavy():
    # vertices straddle the near plane: a live clip tail
    kernel_vs_oracle(soup(6, nv=60, nt=50, spread=4.0, z=0.8), 128, 64)


def test_graze():
    """Camera just outside a sphere, looking past it: magnified triangles
    crossing the near plane and spanning many tiles."""
    scene = Scene()
    scene.add_object(
        SceneObject(
            mesh=scene.add_mesh(icosphere(3)),
            model=mathx.translation([0.0, 0.0, 2.0]),
        )
    )
    cam = Camera(position=np.array([1.02, 0.0, 1.6], F32))
    _, ot = kernel_vs_oracle(scene, 128, 96, cam=cam, clip_budget=1024)
    assert (ot >= 0).sum() > 1000


def test_d16_ties_decided_by_id():
    """Two overlapping coplanar quads: equal d16 on the overlap, so the
    higher triangle id must win there."""
    quad = [[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]]
    pos = np.concatenate([
        np.asarray(quad, F32) + F32([-0.4, 0.0, 3.0]),
        np.asarray(quad, F32) + F32([0.4, 0.2, 3.0]),
    ])
    idx = [[0, 2, 1], [0, 3, 2], [4, 6, 5], [4, 7, 6]]
    _, ot = kernel_vs_oracle(one_mesh(pos, idx), 128, 96)
    assert len(np.unique(ot[ot >= 0])) == 4


def test_coplanar_duplicates():
    """The same triangles twice: every covered pixel is a tie."""
    rng = np.random.default_rng(4)
    pos = rng.uniform(-1.5, 1.5, (30, 3)).astype(F32)
    pos[:, 2] = 3.0
    idx = rng.integers(0, 30, (20, 3))
    kernel_vs_oracle(one_mesh(pos, np.concatenate([idx, idx])), 128, 96)


def test_watertight_fan():
    """A disk fanned around its centre: shared edges cover each pixel
    exactly once (top-left rule), so the frame has no holes."""
    n = 24
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    ring = np.stack([np.cos(ang), np.sin(ang), np.full(n, 3.0)], 1)
    pos = np.concatenate([[[0.0, 0.0, 3.0]], ring]).astype(F32)
    idx = [[0, 1 + (i + 1) % n, 1 + i] for i in range(n)]
    od, ot = kernel_vs_oracle(one_mesh(pos, idx), 128, 96)
    # the disk's interior is one connected covered region
    assert (ot >= 0).sum() > 2000


def test_full_screen_triangle():
    pos = [[-40.0, -40.0, 3.0], [40.0, -40.0, 3.0], [0.0, 40.0, 3.0]]
    _, ot = kernel_vs_oracle(one_mesh(pos, [[0, 2, 1]]), 128, 64)
    assert (ot >= 0).all()


def test_empty_frame():
    """Geometry behind the camera: every tile has an empty record list."""
    _, ot = kernel_vs_oracle(soup(3, z=-6.0), 128, 64)
    assert (ot < 0).all()


def test_odd_resolution():
    _, ot = kernel_vs_oracle(soup(7), 131, 77)
    assert (ot >= 0).sum() > 500


def test_supersampled_render_size():
    """4x SSAA renders at twice the display size per axis."""
    kernel_vs_oracle(soup(8), 2 * 96, 2 * 56)
