"""The five BASELINE benchmark/validation configs as reusable scene builders.

From BASELINE.json `configs`:
  1. single textured OBJ mesh, perspective camera, 800x600
  2. multi-mesh scene with per-object model matrices + depth overlap
  3. Blinn-Phong directional lighting with interpolated normals + specular
  4. 1M-triangle scene, tile-binned rasterization with early-Z at 1080p
  5. animated camera fly-through, mipmapped bilinear textures, 4x supersample

Each builder returns (scene, settings, cameras) where cameras is a list (one
entry = static frame; many = animation path).
"""

from __future__ import annotations

import math
import os
import tempfile

import numpy as np

from .camera import Camera, orbit_path
from .config import RendererSettings
from .models import cube, icosphere, terrain, uv_sphere
from .models.obj import load_obj, save_obj
from .scene import DirectionalLight, Material, Scene, SceneObject
from .textures import TextureAtlas, checkerboard
from . import mathx

F32 = np.float32


def config1_textured_obj(obj_path: str | None = None):
    """Single textured OBJ mesh at 800x600."""
    if obj_path is None:
        # generate a deterministic OBJ round-trip (sphere) if none given
        obj_path = os.path.join(tempfile.gettempdir(), "ash_bench_sphere.obj")
        if not os.path.exists(obj_path):
            save_obj(obj_path, uv_sphere(48, 96))
    mesh = load_obj(obj_path)
    scene = Scene(materials=[Material(texture_id=0)])
    scene.atlas = TextureAtlas.build([checkerboard(512)])
    scene.add_object(
        SceneObject(mesh=scene.add_mesh(mesh), model=mathx.translation([0, 0, 3]))
    )
    cam = Camera()
    return scene, RendererSettings(width=800, height=600), [cam]


def config2_multi_mesh():
    """Multi-mesh scene with per-object model matrices and depth overlap."""
    scene = Scene(materials=[Material()])
    meshes = [cube(1.2), uv_sphere(24, 48, 0.7), icosphere(3, 0.6)]
    ids = [scene.add_mesh(m) for m in meshes]
    rng = np.random.default_rng(42)
    for i in range(12):
        scene.add_object(
            SceneObject(
                mesh=ids[i % 3],
                model=mathx.compose(
                    mathx.translation(
                        [
                            1.6 * math.cos(i * 0.7) * (1 + 0.2 * (i % 3)),
                            1.1 * math.sin(i * 1.1),
                            4.0 + 0.8 * math.sin(i * 2.1),
                        ]
                    ),
                    mathx.rotation_y(i * 0.6),
                    mathx.rotation_x(i * 0.3),
                ),
            )
        )
    # deterministic vertex colors for visual variety
    for m in scene.meshes:
        n = m.num_vertices
        m.colors = np.stack(
            [
                0.5 + 0.5 * np.sin(np.arange(n) * 0.1),
                0.5 + 0.5 * np.cos(np.arange(n) * 0.13),
                np.linspace(0.3, 1.0, n),
                np.ones(n),
            ],
            axis=1,
        ).astype(F32)
    return scene, RendererSettings(width=800, height=600), [Camera()]


def config3_blinn_phong():
    """Blinn-Phong directional lighting, interpolated normals + specular."""
    scene = Scene(
        materials=[Material(base_color=(0.8, 0.3, 0.25, 1.0), specular=0.8,
                            shininess=64)],
        light=DirectionalLight(
            direction=(0.4, -0.5, 0.75), color=(1.0, 0.95, 0.9), ambient=0.12
        ),
    )
    mesh = icosphere(4)
    scene.add_object(
        SceneObject(mesh=scene.add_mesh(mesh), model=mathx.translation([0, 0, 3]))
    )
    return scene, RendererSettings(width=800, height=600), [Camera()]


def config4_million_tri(subdiv: int = 8):
    """1M+-triangle scene at 1080p: an icosphere (20 * 4^subdiv triangles;
    subdiv=8 -> 1,310,720) filling the frame, textured + lit.

    Why a sphere and not a terrain: with the spec's 1/16-pixel snapping,
    sub-1/16-px triangles legitimately degenerate and cull, so a perspective
    heightfield (exponentially distributed projected sizes) mostly decimates
    to dust at this density.  A frame-filling sphere gives uniform ~1.6 px^2
    front-facing triangles — the honest fill-rate + binning workload."""
    mesh = icosphere(subdiv)
    scene = Scene(
        materials=[Material(texture_id=0, specular=0.4, shininess=32)],
        light=DirectionalLight(direction=(0.3, -0.7, 0.5), ambient=0.25),
    )
    scene.atlas = TextureAtlas.build([checkerboard(512)])
    scene.add_object(
        SceneObject(mesh=scene.add_mesh(mesh), model=mathx.translation([0, 0, 2.0]))
    )
    cam = Camera()
    return (
        scene,
        RendererSettings(width=1920, height=1080, max_pairs=1 << 20),
        [cam],
    )


def config4_terrain(n: int = 708):
    """The heightfield variant of config 4 (kept for perspective/LOD-stress
    testing: most triangles are subpixel and decimate in snapping)."""
    mesh = terrain(n=n)
    scene = Scene(
        materials=[Material(texture_id=0)],
        light=DirectionalLight(direction=(0.3, -0.7, 0.5), ambient=0.25),
    )
    scene.atlas = TextureAtlas.build([checkerboard(512)])
    scene.add_object(SceneObject(mesh=scene.add_mesh(mesh)))
    cam = Camera(position=np.array([0.0, -2.0, -6.0], F32))
    return (
        scene,
        RendererSettings(width=1920, height=1080, max_pairs=1 << 20),
        [cam],
    )


def config5_flythrough(n_frames: int = 32):
    """Animated orbit fly-through, mipmapped bilinear textures, 4x SSAA."""
    scene = Scene(
        materials=[Material(texture_id=0, specular=0.3, shininess=16)],
        light=DirectionalLight(direction=(0.2, -0.6, 0.75), ambient=0.2),
    )
    scene.atlas = TextureAtlas.build([checkerboard(512), checkerboard(256)])
    ground = terrain(n=128, extent=6.0, height=0.8)
    scene.add_object(SceneObject(mesh=scene.add_mesh(ground)))
    ball = icosphere(3, 0.8)
    scene.add_object(
        SceneObject(
            mesh=scene.add_mesh(ball),
            model=mathx.translation([0, -1.2, 0]),
            material=0,
        )
    )
    cams = orbit_path(n_frames, radius=5.0, height=-1.5)
    return scene, RendererSettings(width=800, height=600, supersample=2), cams


def reference_scene_config():
    """The reference's own 2-triangle scene at its startup default."""
    from .scene import reference_two_triangle_scene

    return (
        reference_two_triangle_scene(),
        RendererSettings(width=800, height=600),
        [Camera()],
    )


ALL_CONFIGS = {
    "reference": reference_scene_config,
    "config1_textured_obj": config1_textured_obj,
    "config2_multi_mesh": config2_multi_mesh,
    "config3_blinn_phong": config3_blinn_phong,
    "config4_million_tri": config4_million_tri,
    "config4_terrain": config4_terrain,
    "config5_flythrough": config5_flythrough,
}
