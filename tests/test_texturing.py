"""Texture sampling goldens: bilinear weights, wrap addressing, mip selection,
and the supersample resolve — checked against hand-computed values."""

import numpy as np
import pytest

from ash_renderer.ops import shade as sh
from ash_renderer.textures import MAX_LEVELS, TextureAtlas


def solid_atlas():
    """2-level friendly 2x2 texture with distinct texel values."""
    img = np.zeros((2, 2, 4), np.uint8)
    img[0, 0] = [10, 0, 0, 255]
    img[0, 1] = [20, 0, 0, 255]
    img[1, 0] = [30, 0, 0, 255]
    img[1, 1] = [40, 0, 0, 255]
    return TextureAtlas.build([img])


def sample(atlas, u, v, level=0, tex=0):
    out = sh.sample_texture(
        np,
        atlas,
        np.array([tex], np.int32),
        np.array([u], np.float32),
        np.array([v], np.float32),
        np.array([level], np.int32),
    )
    return out[0]


def test_bilinear_texel_centers():
    atlas = solid_atlas()
    # texel centers: u = (i + 0.5) / 2
    assert sample(atlas, 0.25, 0.25)[0] == pytest.approx(10 / 255)
    assert sample(atlas, 0.75, 0.25)[0] == pytest.approx(20 / 255)
    assert sample(atlas, 0.25, 0.75)[0] == pytest.approx(30 / 255)
    assert sample(atlas, 0.75, 0.75)[0] == pytest.approx(40 / 255)


def test_bilinear_midpoint_average():
    atlas = solid_atlas()
    # center of the texture: average of all four texels
    assert sample(atlas, 0.5, 0.5)[0] == pytest.approx(25 / 255, abs=1e-6)


def test_wrap_addressing():
    atlas = solid_atlas()
    a = sample(atlas, 0.25, 0.25)[0]
    assert sample(atlas, 1.25, 0.25)[0] == pytest.approx(a)
    assert sample(atlas, -0.75, 0.25)[0] == pytest.approx(a)
    # wrap across the border blends opposite edges
    edge = sample(atlas, 0.0, 0.25)[0]
    assert edge == pytest.approx((10 + 20) / 2 / 255, abs=1e-6)


def test_mip_level_sampling():
    atlas = solid_atlas()
    # level 1 is the 1x1 box average of the four texels
    avg = (10 + 20 + 30 + 40 + 2) // 4
    assert sample(atlas, 0.3, 0.8, level=1)[0] == pytest.approx(avg / 255)


def test_resolve_box_filter_exact():
    rgba = np.zeros((2, 2, 4), np.float32)
    rgba[0, 0] = [0.1, 0, 0, 1]
    rgba[0, 1] = [0.2, 0, 0, 1]
    rgba[1, 0] = [0.3, 0, 0, 1]
    rgba[1, 1] = [0.6, 0, 0, 1]
    out = sh.resolve_and_pack(np, rgba, 2, False)
    assert out.shape == (1, 1, 4)
    assert out[0, 0, 0] == round(((0.1 + 0.2) + (0.3 + 0.6)) * 0.25 * 255)


def test_srgb_pack():
    rgba = np.array([[[0.5, 0.0, 1.0, 0.5]]], np.float32)
    out = sh.resolve_and_pack(np, rgba, 1, True)
    # sRGB(0.5) ~ 0.7354
    assert out[0, 0, 0] == pytest.approx(round(0.7354 * 255), abs=1)
    assert out[0, 0, 2] == 255
    assert out[0, 0, 3] == 128  # alpha stays linear


def test_mip_level_from_derivatives_monotonic():
    """_mip_level picks coarser levels as the triangle shrinks on screen."""
    from ash_renderer import (
        Camera,
        Material,
        Mesh,
        RendererSettings,
        Scene,
        SceneObject,
        derive_raster_config,
    )
    from ash_renderer.oracle import render_oracle
    from ash_renderer.rtypes import MaterialsPack
    from ash_renderer.textures import checkerboard

    levels_seen = []
    for z in (2.0, 8.0, 32.0):
        quad = Mesh(
            positions=np.array(
                [[-1, -1, z], [1, -1, z], [1, 1, z], [-1, 1, z]], np.float32
            ),
            indices=np.array([[0, 2, 1], [0, 3, 2]], np.int32),
            uvs=np.array([[0, 0], [4, 0], [4, 4], [0, 4]], np.float32),
        )
        scene = Scene(materials=[Material(texture_id=0)])
        atlas = TextureAtlas.build([checkerboard(256)])
        scene.add_object(SceneObject(mesh=scene.add_mesh(quad)))
        st = RendererSettings(width=96, height=96)
        out = render_oracle(
            scene.pack(),
            scene.model_matrices(),
            Camera().view_matrix(),
            Camera().projection_matrix(1.0),
            st,
            materials=MaterialsPack(
                base_color=np.ones((1, 4), np.float32),
                tex_id=np.zeros(1, np.int32),
                specular=np.zeros(1, np.float32),
                shininess=np.ones(1, np.int32),
            ),
            atlas=atlas,
        )
        cov = out["vis_tri"] >= 0
        if cov.any():
            # recover implied mip usage from output contrast: finer mips have
            # high-contrast checker, coarse mips wash out to the mean
            px = out["rgba8"][cov][:, 0].astype(np.float64)
            levels_seen.append(px.std())
    assert len(levels_seen) == 3
    assert levels_seen[0] > levels_seen[1] > levels_seen[2]
