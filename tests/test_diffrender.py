"""Differentiable shading: inverse rendering recovers scene parameters."""

import numpy as np
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
from ash_renderer.diffrender import fit_to_image, shade_params_fn
from ash_renderer.oracle import geometry_oracle, visibility_oracle
from ash_renderer.ops import shade as shade_mod
from ash_renderer.rtypes import LightPack, MaterialsPack


def setup_scene():
    mesh = Mesh(
        positions=np.array(
            [[-0.8, -0.8, 0.5], [-0.8, 0.8, 0.5], [0.8, -0.8, 0.5]],
            np.float32,
        ),
        indices=np.array([[0, 1, 2]], np.int32),
        colors=np.array(
            [[0.9, 0.2, 0.1, 1], [0.1, 0.8, 0.3, 1], [0.2, 0.3, 0.9, 1]],
            np.float32,
        ),
    )
    scene = Scene()
    scene.add_object(SceneObject(mesh=scene.add_mesh(mesh)))
    cfg = derive_raster_config(64, 64)
    su, attrs = geometry_oracle(
        scene.pack(),
        scene.model_matrices(),
        np.eye(4, dtype=np.float32),
        np.eye(4, dtype=np.float32),
        cfg,
        16,
    )
    vis_d, vis_t = visibility_oracle(su, cfg)
    mats = MaterialsPack(
        base_color=np.ones((1, 4), np.float32),
        tex_id=np.full(1, -1, np.int32),
        specular=np.zeros(1, np.float32),
        shininess=np.full(1, 8, np.int32),
    )
    return scene, cfg, su, attrs, vis_t, mats


def test_recover_vertex_colors():
    scene, cfg, su, attrs, vis_t, mats = setup_scene()
    import jax

    su_j = jax.tree.map(jnp.asarray, su)
    fn = shade_params_fn(
        jnp.asarray(vis_t), su_j, jnp.asarray(attrs), cfg, mats
    )
    target = fn({"vertex_colors": jnp.asarray(attrs[:, :4])})

    # start from gray, recover the true vertex colors by gradient descent
    p0 = {"vertex_colors": jnp.full_like(jnp.asarray(attrs[:, :4]), 0.5)}
    params, losses = fit_to_image(np.asarray(target), fn, p0, steps=150, lr=0.1)
    assert losses[-1] < 1e-4, losses[-1]
    # the three real vertices' colors recovered (rows 0..2 of attrs)
    rec = np.asarray(params["vertex_colors"])[:3, :3]
    true = attrs[:3, :3]
    assert np.abs(rec - true).max() < 0.06


def test_gradients_flow_through_lighting():
    import jax

    scene, cfg, su, attrs, vis_t, mats = setup_scene()
    # add normals facing the camera so lighting has effect
    attrs = attrs.copy()
    attrs[:, 4:7] = [0, 0, -1.0]
    su_j = jax.tree.map(jnp.asarray, su)
    light = LightPack(
        direction=jnp.asarray(np.array([0.2, -0.3, 0.9], np.float32)),
        color=jnp.asarray(np.ones(3, np.float32)),
        ambient=jnp.float32(0.1),
    )
    fn = shade_params_fn(
        jnp.asarray(vis_t), su_j, jnp.asarray(attrs), cfg, mats,
        light=light, camera_pos=np.zeros(3, np.float32),
    )

    def loss(amb):
        img = fn({"light": LightPack(light.direction, light.color, amb)})
        return jnp.mean(img[..., :3])

    g = jax.grad(loss)(jnp.float32(0.1))
    assert np.isfinite(float(g)) and float(g) > 0  # more ambient -> brighter
