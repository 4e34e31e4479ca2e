"""Multi-material / multi-texture scenes end-to-end, and textured glTF."""

import base64
import json
import os

import numpy as np

from ash_renderer import (
    Camera,
    Material,
    Mesh,
    RendererSettings,
    Scene,
    SceneObject,
    mathx,
)
from ash_renderer.textures import TextureAtlas, checkerboard
from tests.test_pipeline_parity import assert_frame_parity


def solid_tex(r, g, b, size=8):
    img = np.zeros((size, size, 4), np.uint8)
    img[..., 0], img[..., 1], img[..., 2], img[..., 3] = r, g, b, 255
    return img


def quad(z=2.5):
    return Mesh(
        positions=np.array(
            [[-0.8, -0.8, z], [0.8, -0.8, z], [0.8, 0.8, z], [-0.8, 0.8, z]],
            np.float32,
        ),
        indices=np.array([[0, 2, 1], [0, 3, 2]], np.int32),
        uvs=np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32),
    )


def test_two_textures_two_materials():
    scene = Scene(
        materials=[
            Material(texture_id=0),
            Material(texture_id=1, base_color=(1.0, 1.0, 1.0, 1.0)),
        ]
    )
    atlas = TextureAtlas.build([solid_tex(200, 10, 10), solid_tex(10, 10, 200)])
    mi = scene.add_mesh(quad())
    scene.add_object(
        SceneObject(mesh=mi, model=mathx.translation([-0.9, 0, 0]), material=0)
    )
    scene.add_object(
        SceneObject(mesh=mi, model=mathx.translation([0.9, 0, 0]), material=1)
    )
    settings = RendererSettings(width=128, height=96)
    rgba8, aux = assert_frame_parity(scene, settings, atlas=atlas)
    cov = aux["vis_tri"] >= 0
    # left half red-ish texture, right half blue-ish
    left = rgba8[:, :64][cov[:, :64]]
    right = rgba8[:, 64:][cov[:, 64:]]
    assert left[:, 0].mean() > left[:, 2].mean()
    assert right[:, 2].mean() > right[:, 0].mean()


def test_untextured_material_among_textured():
    scene = Scene(
        materials=[
            Material(texture_id=0),
            Material(texture_id=-1, base_color=(0.1, 0.9, 0.1, 1.0)),
        ]
    )
    atlas = TextureAtlas.build([checkerboard(16)])
    mi = scene.add_mesh(quad())
    scene.add_object(SceneObject(mesh=mi, material=0))
    scene.add_object(
        SceneObject(
            mesh=mi, model=mathx.translation([0, 0, -0.5]), material=1
        )
    )
    settings = RendererSettings(width=96, height=96)
    rgba8, aux = assert_frame_parity(scene, settings, atlas=atlas)
    # the nearer untextured quad wins depth; its green base color shows
    cov = aux["vis_tri"] >= 0
    assert rgba8[cov][:, 1].mean() > 150


def test_gltf_with_embedded_texture(tmp_path):
    """glTF with a base64 PNG texture renders textured, parity-exact."""
    from PIL import Image
    import io

    from ash_renderer.models import load_gltf

    img = Image.fromarray(solid_tex(30, 180, 240, 8))
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    img_uri = "data:image/png;base64," + base64.b64encode(
        buf.getvalue()
    ).decode()

    pos = np.array(
        [[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]], np.float32
    )
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    idx = np.array([0, 2, 1, 0, 3, 2], np.uint16)
    bin_data = pos.tobytes() + uv.tobytes() + idx.tobytes()
    doc = {
        "asset": {"version": "2.0"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0, "translation": [0, 0, 2.5]}],
        "meshes": [
            {
                "primitives": [
                    {
                        "attributes": {"POSITION": 0, "TEXCOORD_0": 1},
                        "indices": 2,
                        "material": 0,
                    }
                ]
            }
        ],
        "materials": [
            {
                "pbrMetallicRoughness": {
                    "baseColorTexture": {"index": 0},
                }
            }
        ],
        "textures": [{"source": 0}],
        "images": [{"uri": img_uri}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 4, "type": "VEC3"},
            {"bufferView": 1, "componentType": 5126, "count": 4, "type": "VEC2"},
            {"bufferView": 2, "componentType": 5123, "count": 6, "type": "SCALAR"},
        ],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": 48},
            {"buffer": 0, "byteOffset": 48, "byteLength": 32},
            {"buffer": 0, "byteOffset": 80, "byteLength": 12},
        ],
        "buffers": [
            {
                "uri": "data:application/octet-stream;base64,"
                + base64.b64encode(bin_data).decode(),
                "byteLength": len(bin_data),
            }
        ],
    }
    path = os.path.join(str(tmp_path), "tex.gltf")
    with open(path, "w") as f:
        json.dump(doc, f)
    scene = load_gltf(path)
    assert scene.atlas is not None
    assert scene.materials[0].texture_id == 0
    settings = RendererSettings(width=96, height=96)
    rgba8, aux = assert_frame_parity(scene, settings, atlas=scene.atlas)
    cov = aux["vis_tri"] >= 0
    assert cov.any()
    # the texture's cyan-ish color dominates
    assert rgba8[cov][:, 2].mean() > 180
