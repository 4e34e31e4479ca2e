"""The five BASELINE configs render end-to-end, pixel-exact vs oracle, at
reduced size (full size runs on hardware via bench.py)."""

import dataclasses

import numpy as np
import pytest

from ash_renderer import RendererSettings
from ash_renderer import benchmarks as bm
from tests.test_pipeline_parity import assert_frame_parity, run_device


def shrink(settings, w=96, h=64):
    return dataclasses.replace(
        settings, width=w, height=h, clip_budget=256, max_pairs=1 << 14
    )


def test_config1_textured_obj():
    scene, settings, cams = bm.config1_textured_obj()
    rgba8, aux = assert_frame_parity(
        scene, shrink(settings), cams[0], atlas=scene.atlas
    )
    assert (aux["vis_tri"] >= 0).sum() > 200


def test_config2_multi_mesh():
    scene, settings, cams = bm.config2_multi_mesh()
    rgba8, aux = assert_frame_parity(scene, shrink(settings), cams[0])
    vt = aux["vis_tri"]
    assert len(np.unique(vt[vt >= 0])) > 20  # many objects visible


def test_config3_blinn_phong():
    scene, settings, cams = bm.config3_blinn_phong()
    rgba8, aux = assert_frame_parity(scene, shrink(settings), cams[0])
    cov = aux["vis_tri"] >= 0
    # specular highlight: some pixels much brighter than the base color
    assert rgba8[cov][:, 0].max() > 230


def test_config4_small_sphere():
    scene, settings, cams = bm.config4_million_tri(subdiv=3)
    rgba8, aux = assert_frame_parity(
        scene, shrink(settings), cams[0], atlas=scene.atlas
    )
    assert (aux["vis_tri"] >= 0).sum() > 1000


def test_config5_flythrough_frames():
    scene, settings, cams = bm.config5_flythrough(n_frames=2)
    settings = shrink(settings)
    assert settings.supersample == 2  # preserved by shrink
    frames = []
    for cam in cams:
        rgba8, aux = assert_frame_parity(
            scene, settings, cam, atlas=scene.atlas
        )
        frames.append(rgba8)
    assert not np.array_equal(frames[0], frames[1])  # camera animates
