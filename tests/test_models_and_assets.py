"""Model loaders, procedural generators, textures, present sinks."""

import io
import json
import os
import struct
import tempfile

import numpy as np
import pytest

from ash_renderer.models import (
    cube,
    grid_sheet,
    icosphere,
    load_gltf,
    load_obj,
    terrain,
    tri_soup,
    uv_sphere,
)
from ash_renderer.models.obj import load_obj_python, save_obj
from ash_renderer.present import FrameCollector, FrameRing, write_png, write_ppm
from ash_renderer.textures import TextureAtlas, build_mip_chain, checkerboard


def test_procedural_meshes_valid():
    for mesh in (cube(), uv_sphere(8, 16), icosphere(1), grid_sheet(4, 4),
                 terrain(16), tri_soup(50)):
        assert mesh.indices.min() >= 0
        assert mesh.indices.max() < mesh.num_vertices
        assert mesh.positions.dtype == np.float32
        assert np.isfinite(mesh.positions).all()


def test_terrain_triangle_count():
    assert terrain(16).num_triangles == 2 * 16 * 16


def test_obj_roundtrip():
    mesh = uv_sphere(6, 12)
    path = os.path.join(tempfile.gettempdir(), "rt.obj")
    save_obj(path, mesh)
    back = load_obj_python(path)
    assert back.num_triangles == mesh.num_triangles
    # the loader dedups/reorders vertices: compare per-face geometry instead
    a = np.sort(mesh.positions[mesh.indices].reshape(-1, 9), axis=0)
    b = np.sort(back.positions[back.indices].reshape(-1, 9), axis=0)
    np.testing.assert_allclose(a, b, atol=1e-4)


def test_obj_polygons_and_negative_indices():
    src = """
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
f 1 2 3 4
f -4 -3 -2
"""
    path = os.path.join(tempfile.gettempdir(), "poly.obj")
    with open(path, "w") as f:
        f.write(src)
    mesh = load_obj_python(path, compute_normals_if_missing=False)
    assert mesh.num_triangles == 3  # quad fan (2) + explicit tri (1)
    assert mesh.num_vertices == 4


def test_native_obj_matches_python():
    from ash_renderer import native

    if not native.available():
        pytest.skip("native lib not built")
    mesh = icosphere(2)
    path = os.path.join(tempfile.gettempdir(), "nat.obj")
    save_obj(path, mesh)
    a = load_obj_python(path)
    b_arrays = native.parse_obj(path)
    assert b_arrays is not None
    pos, uv, nrm, faces = b_arrays
    np.testing.assert_array_equal(a.positions, pos)
    np.testing.assert_array_equal(a.indices, faces)
    np.testing.assert_array_equal(a.uvs, uv)


def test_native_meshlets_match_python():
    """The C++ greedy meshlet builder must be BIT-IDENTICAL to the Python
    loop: meshlet boundaries set the triangle draw order (depth tie-break),
    so any divergence changes frames."""
    from ash_renderer import native
    from ash_renderer import scene as sc

    if not native.available():
        pytest.skip("native lib not built")
    rng = np.random.default_rng(7)
    for trial in range(8):
        v = int(rng.integers(4, 700))
        t = int(rng.integers(1, 3000))
        tri = rng.integers(0, v, size=(t, 3)).astype(np.int32)
        tri[rng.random(t) < 0.07, 0] = -1  # padding rows
        dup = rng.random(t) < 0.05  # degenerate duplicate-corner tris
        tri[dup, 2] = tri[dup, 0]
        pos = rng.random((v, 3)).astype(np.float32)
        use_pos = pos if trial % 2 == 0 else None
        fast = sc.build_meshlets(tri, v, use_pos)
        real_fn = native.build_meshlets
        native.build_meshlets = lambda *a: None
        try:
            slow = sc.build_meshlets(tri, v, use_pos)
        finally:
            native.build_meshlets = real_fn
        for a, b in zip(fast, slow):
            np.testing.assert_array_equal(a, b)


def _minimal_gltf(tmpdir):
    pos = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    idx = np.array([0, 1, 2], np.uint16)
    bin_data = pos.tobytes() + idx.tobytes()
    doc = {
        "asset": {"version": "2.0"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0, "translation": [0, 0, 3]}],
        "meshes": [
            {
                "primitives": [
                    {
                        "attributes": {"POSITION": 0},
                        "indices": 1,
                    }
                ]
            }
        ],
        "accessors": [
            {
                "bufferView": 0,
                "componentType": 5126,
                "count": 3,
                "type": "VEC3",
            },
            {
                "bufferView": 1,
                "componentType": 5123,
                "count": 3,
                "type": "SCALAR",
            },
        ],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": 36},
            {"buffer": 0, "byteOffset": 36, "byteLength": 6},
        ],
        "buffers": [{"uri": "geom.bin", "byteLength": len(bin_data)}],
    }
    with open(os.path.join(tmpdir, "geom.bin"), "wb") as f:
        f.write(bin_data)
    path = os.path.join(tmpdir, "tri.gltf")
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def test_gltf_loader(tmp_path):
    path = _minimal_gltf(str(tmp_path))
    scene = load_gltf(path)
    assert len(scene.meshes) == 1
    assert scene.meshes[0].num_triangles == 1
    assert len(scene.objects) == 1
    # node translation applied
    assert scene.objects[0].model[2, 3] == 3.0


def test_glb_container(tmp_path):
    gltf_path = _minimal_gltf(str(tmp_path))
    with open(gltf_path) as f:
        doc = json.load(f)
    with open(os.path.join(str(tmp_path), "geom.bin"), "rb") as f:
        bin_data = f.read()
    del doc["buffers"][0]["uri"]
    js = json.dumps(doc).encode()
    js += b" " * (-len(js) % 4)
    bd = bin_data + b"\0" * (-len(bin_data) % 4)
    glb = (
        struct.pack("<III", 0x46546C67, 2, 12 + 8 + len(js) + 8 + len(bd))
        + struct.pack("<II", len(js), 0x4E4F534A) + js
        + struct.pack("<II", len(bd), 0x004E4942) + bd
    )
    path = os.path.join(str(tmp_path), "tri.glb")
    with open(path, "wb") as f:
        f.write(glb)
    scene = load_gltf(path)
    assert scene.meshes[0].num_triangles == 1


def test_mip_chain_exact_box_filter():
    img = np.zeros((4, 4, 4), np.uint8)
    img[0, 0] = [100, 0, 0, 255]
    img[0, 1] = [102, 0, 0, 255]
    img[1, 0] = [104, 0, 0, 255]
    img[1, 1] = [106, 0, 0, 255]
    chain = build_mip_chain(img)
    assert len(chain) == 3  # 4 -> 2 -> 1
    assert chain[1][0, 0, 0] == (100 + 102 + 104 + 106 + 2) // 4
    assert chain[1].shape == (2, 2, 4)
    assert chain[2].shape == (1, 1, 4)


def test_atlas_tables():
    atlas = TextureAtlas.build([checkerboard(16), checkerboard(8)])
    assert int(atlas.n_levels[0]) == 5
    assert int(atlas.n_levels[1]) == 4
    assert int(atlas.level_w[0, 0]) == 16
    assert int(atlas.level_w[0, 4]) == 1
    total = (16 * 16 + 8 * 8 + 4 * 4 + 2 * 2 + 1) + (8 * 8 + 16 + 4 + 1)
    assert atlas.texels.shape == (total,)  # packed int32 RGBA


def test_non_pot_texture_single_level():
    img = np.zeros((10, 12, 4), np.uint8)
    atlas = TextureAtlas.build([img])
    assert int(atlas.n_levels[0]) == 1


def test_present_ring_and_sinks(tmp_path):
    ring = FrameRing(frames_in_flight=2)
    collector = FrameCollector()
    frames = [np.full((4, 4, 4), i, np.uint8) for i in range(5)]
    for f in frames:
        ring.push(f, collector)
    rest = ring.drain()
    assert len(collector.frames) == 5
    np.testing.assert_array_equal(collector.frames[0], frames[0])
    assert len(rest) == 2

    png = os.path.join(str(tmp_path), "f.png")
    write_png(png, frames[0])
    from PIL import Image

    np.testing.assert_array_equal(np.asarray(Image.open(png)), frames[0])
    ppm = os.path.join(str(tmp_path), "f.ppm")
    write_ppm(ppm, frames[0])
    assert open(ppm, "rb").read(2) == b"P6"
