"""Deterministic feature-coverage scenes shared by the golden-frame tests and
the golden regeneration script (tests/regen_goldens.py).

Each builder returns (packed_args_dict, settings) where packed_args_dict has
everything render_oracle needs.  All content is procedurally deterministic
(no image-file dependencies), so the pinned hashes are reproducible anywhere.
"""

import numpy as np

from ash_renderer import (
    Camera,
    DirectionalLight,
    Material,
    RendererSettings,
    Scene,
    SceneObject,
    mathx,
)
from ash_renderer.models import cube, icosphere, uv_sphere
from ash_renderer.rtypes import LightPack, MaterialsPack
from ash_renderer.textures import TextureAtlas, checkerboard

F32 = np.float32


def _mats_pack(scene):
    return MaterialsPack(
        base_color=np.array([m.base_color for m in scene.materials], F32),
        tex_id=np.array([m.texture_id for m in scene.materials], np.int32),
        specular=np.array([m.specular for m in scene.materials], F32),
        shininess=np.array([m.shininess for m in scene.materials], np.int32),
    )


def _light_pack(scene):
    if scene.light is None:
        return None
    return LightPack(
        direction=np.asarray(scene.light.direction, F32),
        color=np.asarray(scene.light.color, F32),
        ambient=np.float32(scene.light.ambient),
    )


def textured_mipmap():
    """Textured sphere with strong uv perspective -> exercises bilinear taps
    and several mip levels in one frame."""
    scene = Scene(materials=[Material(texture_id=0)])
    scene.atlas = TextureAtlas.build([checkerboard(256, cells=16)])
    scene.add_object(
        SceneObject(
            mesh=scene.add_mesh(uv_sphere(24, 48, 1.4)),
            model=mathx.translation([0.2, 0.1, 2.2]),
        )
    )
    return scene, RendererSettings(width=200, height=150)


def blinn_phong_specular():
    """Lit icosphere with a bright specular highlight (config3 semantics)."""
    scene = Scene(
        materials=[
            Material(base_color=(0.75, 0.3, 0.2, 1.0), specular=0.9,
                     shininess=64)
        ],
        light=DirectionalLight(
            direction=(0.4, -0.5, 0.75), color=(1.0, 0.95, 0.9), ambient=0.12
        ),
    )
    scene.add_object(
        SceneObject(
            mesh=scene.add_mesh(icosphere(3)),
            model=mathx.translation([0, 0, 2.6]),
        )
    )
    return scene, RendererSettings(width=200, height=150)


def multi_material():
    """Three objects, three materials: textured, tinted-untextured, and a
    second texture — exercises per-pixel material routing."""
    scene = Scene(
        materials=[
            Material(texture_id=0, base_color=(1, 1, 1, 1)),
            Material(base_color=(0.2, 0.9, 0.4, 1.0)),
            Material(texture_id=1, base_color=(1.0, 0.8, 0.8, 1.0)),
        ],
        light=DirectionalLight(direction=(0.2, -0.6, 0.75), ambient=0.3),
    )
    scene.atlas = TextureAtlas.build(
        [checkerboard(64, cells=8), checkerboard(32, cells=4)]
    )
    m_sphere = scene.add_mesh(uv_sphere(16, 32, 0.7))
    m_cube = scene.add_mesh(cube(0.9))
    scene.add_object(
        SceneObject(mesh=m_sphere, material=0,
                    model=mathx.translation([-1.0, 0, 2.6]))
    )
    scene.add_object(
        SceneObject(
            mesh=m_cube, material=1,
            model=mathx.compose(
                mathx.translation([0.9, 0.2, 3.2]), mathx.rotation_y(0.6)
            ),
        )
    )
    scene.add_object(
        SceneObject(mesh=m_sphere, material=2,
                    model=mathx.translation([0.1, -0.8, 2.1]))
    )
    return scene, RendererSettings(width=200, height=150)


def ssaa_srgb():
    """4x supersampling + sRGB encode over a textured, lit scene (config5
    semantics: resolve order and the sRGB LUT are part of the contract)."""
    scene = Scene(
        materials=[Material(texture_id=0, specular=0.3, shininess=16)],
        light=DirectionalLight(direction=(0.2, -0.6, 0.75), ambient=0.2),
    )
    scene.atlas = TextureAtlas.build([checkerboard(128)])
    scene.add_object(
        SceneObject(
            mesh=scene.add_mesh(icosphere(2, 1.0)),
            model=mathx.translation([0, 0, 2.4]),
        )
    )
    return scene, RendererSettings(
        width=160, height=120, supersample=2, srgb_output=True
    )


GOLDEN_SCENES = {
    "textured_mipmap": textured_mipmap,
    "blinn_phong_specular": blinn_phong_specular,
    "multi_material": multi_material,
    "ssaa_srgb": ssaa_srgb,
}


def render_scene_oracle(name: str):
    """Render one golden scene with the numpy oracle; returns (rgba8, aux)."""
    from ash_renderer.oracle import render_oracle
    from ash_renderer.oracle.raster_cpu import compose_mvp

    scene, st = GOLDEN_SCENES[name]()
    cam = Camera()
    packed = scene.pack()
    view = cam.view_matrix()
    proj = cam.projection_matrix(st.render_width / st.render_height)
    mm = scene.model_matrices()
    out = render_oracle(
        packed,
        mm,
        view,
        proj,
        st,
        materials=_mats_pack(scene),
        atlas=scene.atlas,
        light=_light_pack(scene),
        camera_pos=cam.position.astype(F32),
    )
    return out["rgba8"], out
