"""Device geometry stage vs CPU oracle: bitwise setup-buffer parity."""

import dataclasses

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
)
from ash_renderer.oracle import geometry_oracle
from ash_renderer.oracle.raster_cpu import compose_mvp
from ash_renderer.ops import geometry as gd


def run_both(scene, w, h, clip_budget=64, camera=None):
    cam = camera or Camera()
    cfg = derive_raster_config(w, h)
    packed = scene.pack()
    view = cam.view_matrix()
    proj = cam.projection_matrix(w / h)
    model_mats = scene.model_matrices()

    su_o, attrs_o = geometry_oracle(
        packed, model_mats, view, proj, cfg, clip_budget
    )

    mvp = compose_mvp(model_mats, view, proj)
    fn = jax.jit(
        lambda pos, vo, nrm, col, uv, mm, mv, tv, to, om: gd.geometry_device(
            *gd.transform_vertices(pos, vo, nrm, col, uv, mm, mv),
            tv, to, om, cfg=cfg, clip_budget=clip_budget,
        ),
        static_argnames=(),
    )
    clip_d, attrs_d = gd.transform_vertices(
        jnp.asarray(packed.positions),
        jnp.asarray(packed.vert_obj),
        jnp.asarray(packed.normals),
        jnp.asarray(packed.colors),
        jnp.asarray(packed.uvs),
        jnp.asarray(model_mats),
        jnp.asarray(mvp),
    )
    su_d, attrs_full_d, stats = jax.jit(
        lambda c, a, tv, to, om: gd.geometry_device(
            c, a, tv, to, om, cfg, clip_budget
        )
    )(
        clip_d,
        attrs_d,
        jnp.asarray(packed.tri_v),
        jnp.asarray(packed.tri_obj),
        jnp.asarray(packed.obj_material),
    )
    return su_o, attrs_o, su_d, attrs_full_d, stats


def assert_setup_equal(su_o, su_d):
    for f in dataclasses.fields(su_o):
        a = np.asarray(getattr(su_o, f.name))
        b = np.asarray(getattr(su_d, f.name))
        if a.dtype == np.float32:
            ne = (a.view(np.int32) != b.view(np.int32)).sum()
        else:
            ne = (a != b).sum()
        assert ne == 0, f"{f.name}: {ne} mismatching rows"


def random_scene(seed, nv=80, nt=60, span=3.0, z_shift=3.0):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-span, span, (nv, 3)).astype(np.float32)
    pos[:, 2] += z_shift
    mesh = Mesh(
        positions=pos,
        indices=rng.integers(0, nv, (nt, 3)).astype(np.int32),
        colors=rng.uniform(0, 1, (nv, 4)).astype(np.float32),
        uvs=rng.uniform(0, 1, (nv, 2)).astype(np.float32),
    )
    sc = Scene()
    sc.add_object(SceneObject(mesh=sc.add_mesh(mesh)))
    return sc


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_parity_in_view(seed):
    sc = random_scene(seed)
    su_o, attrs_o, su_d, attrs_d, stats = run_both(sc, 160, 120)
    assert_setup_equal(su_o, su_d)
    np.testing.assert_array_equal(
        attrs_o.view(np.int32), np.asarray(attrs_d).view(np.int32)
    )


@pytest.mark.parametrize("seed", [3, 4])
def test_parity_clip_heavy(seed):
    """Geometry straddling the camera plane: many triangles need clipping."""
    sc = random_scene(seed, span=6.0, z_shift=0.5)
    su_o, attrs_o, su_d, attrs_d, stats = run_both(sc, 128, 128)
    assert int(stats["n_clipped"]) > 0
    assert_setup_equal(su_o, su_d)
    np.testing.assert_array_equal(
        attrs_o.view(np.int32), np.asarray(attrs_d).view(np.int32)
    )


def test_parity_reference_scene():
    from ash_renderer import reference_two_triangle_scene

    sc = reference_two_triangle_scene()
    su_o, attrs_o, su_d, attrs_d, stats = run_both(sc, 800, 600)
    assert_setup_equal(su_o, su_d)
    assert int(stats["n_valid"]) == 1  # only the z=2 triangle survives


def test_parity_multi_object():
    from ash_renderer import mathx

    rng = np.random.default_rng(9)
    sc = Scene()
    mesh = Mesh(
        positions=rng.uniform(-1, 1, (30, 3)).astype(np.float32),
        indices=rng.integers(0, 30, (20, 3)).astype(np.int32),
        colors=rng.uniform(0, 1, (30, 4)).astype(np.float32),
    )
    mi = sc.add_mesh(mesh)
    for i in range(4):
        sc.add_object(
            SceneObject(
                mesh=mi,
                model=mathx.compose(
                    mathx.translation([i - 1.5, 0, 4 + i]),
                    mathx.rotation_y(0.7 * i),
                ),
            )
        )
    su_o, attrs_o, su_d, attrs_d, stats = run_both(sc, 200, 160)
    assert_setup_equal(su_o, su_d)
    np.testing.assert_array_equal(
        attrs_o.view(np.int32), np.asarray(attrs_d).view(np.int32)
    )


def test_clip_budget_overflow_counted():
    sc = random_scene(11, nv=200, nt=400, span=8.0, z_shift=0.2)
    su_o, attrs_o, su_d, attrs_d, stats = run_both(sc, 96, 96, clip_budget=2)
    assert int(stats["clip_overflow"]) > 0
    # oracle with the same tiny budget must still agree
    assert_setup_equal(su_o, su_d)
