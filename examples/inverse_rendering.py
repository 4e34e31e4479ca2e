#!/usr/bin/env python
"""Inverse rendering demo: recover vertex colors from a target image by
gradient descent through the device shading stage (impossible in the original
Vulkan pipeline — a JAX-native framework capability).

  python examples/inverse_rendering.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import jax
import jax.numpy as jnp

from ash_renderer import (
    Camera,
    Mesh,
    Scene,
    SceneObject,
    derive_raster_config,
)
from ash_renderer.diffrender import fit_to_image, shade_params_fn
from ash_renderer.models import icosphere
from ash_renderer.oracle import geometry_oracle, visibility_oracle
from ash_renderer.present import write_png
from ash_renderer.rtypes import MaterialsPack
from ash_renderer import mathx


def main():
    rng = np.random.default_rng(0)
    mesh = icosphere(3)
    true_colors = rng.uniform(0.1, 1.0, (mesh.num_vertices, 4)).astype(
        np.float32
    )
    true_colors[:, 3] = 1.0
    mesh.colors = true_colors
    scene = Scene()
    scene.add_object(
        SceneObject(mesh=scene.add_mesh(mesh), model=mathx.translation([0, 0, 3]))
    )

    cfg = derive_raster_config(128, 128)
    cam = Camera()
    su, attrs = geometry_oracle(
        scene.pack(),
        scene.model_matrices(),
        cam.view_matrix(),
        cam.projection_matrix(1.0),
        cfg,
        64,
    )
    _, vis_t = visibility_oracle(su, cfg)
    mats = MaterialsPack(
        base_color=np.ones((1, 4), np.float32),
        tex_id=np.full(1, -1, np.int32),
        specular=np.zeros(1, np.float32),
        shininess=np.full(1, 8, np.int32),
    )
    su_j = jax.tree.map(jnp.asarray, su)
    fn = shade_params_fn(jnp.asarray(vis_t), su_j, jnp.asarray(attrs), cfg, mats)

    target = fn({"vertex_colors": jnp.asarray(attrs[:, :4])})
    write_png("/tmp/inv_target.png", np.asarray(
        jnp.round(jnp.clip(target, 0, 1) * 255).astype(jnp.uint8)))

    p0 = {"vertex_colors": jnp.full_like(jnp.asarray(attrs[:, :4]), 0.5)}
    params, losses = fit_to_image(np.asarray(target), fn, p0, steps=120, lr=0.1)
    print(f"loss: {losses[0]:.5f} -> {losses[-1]:.6f}")
    recovered = fn(params)
    write_png("/tmp/inv_recovered.png", np.asarray(
        jnp.round(jnp.clip(recovered, 0, 1) * 255).astype(jnp.uint8)))
    err = np.abs(
        np.asarray(params["vertex_colors"])[: mesh.num_vertices, :3]
        - true_colors[:, :3]
    )
    # report error only over vertices that are actually visible
    # (occluded vertices keep their init — no gradient reaches them)
    finite = np.isfinite(err).all(axis=1)
    print(f"median vertex-color error (finite): {np.median(err[finite]):.4f}")
    print("wrote /tmp/inv_target.png and /tmp/inv_recovered.png")


if __name__ == "__main__":
    main()
