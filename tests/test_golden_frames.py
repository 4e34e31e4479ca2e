"""Golden-frame regression: pinned hashes of oracle output catch any
unintended change to the rasterization semantics (which would silently
re-baseline every parity test, since device and oracle share the spec)."""

import hashlib

import numpy as np

from ash_renderer import (
    Camera,
    RendererSettings,
    reference_two_triangle_scene,
)
from ash_renderer.oracle import render_oracle

GOLDEN_SHA = "39b86430fefc451ba3762f44f61f7d44ed29bdd07e85e190745edbd1cee4235e"


def test_reference_scene_golden_hash():
    scene = reference_two_triangle_scene()
    st = RendererSettings(width=320, height=240)
    cam = Camera()
    out = render_oracle(
        scene.pack(),
        scene.model_matrices(),
        cam.view_matrix(),
        cam.projection_matrix(320 / 240),
        st,
    )
    rgba8 = out["rgba8"]
    assert int((out["vis_tri"] >= 0).sum()) == 23328
    assert hashlib.sha256(rgba8.tobytes()).hexdigest() == GOLDEN_SHA, (
        "rasterization semantics changed: if intentional, re-pin the golden "
        "hash AND regenerate tests/golden/reference_320x240.png"
    )
    # and the stored image matches
    from PIL import Image

    stored = np.asarray(Image.open("tests/golden/reference_320x240.png"))
    np.testing.assert_array_equal(stored, rgba8)


# Feature-coverage goldens: textured+mipmapped, Blinn-Phong+specular,
# multi-material, and 4x SSAA + sRGB.  These are the independent pin for the
# shading feature set — the oracle and device share ops/shade.py, so only a
# stored image catches a shading regression that changes both sides equally.
FEATURE_GOLDEN_SHA = {
    "textured_mipmap": "dda4c11de0f579f92b7dbe275631a25e86def6a74bdf51e03dd1d3b72d24627b",
    "blinn_phong_specular": "df9b5911b5aeaf36a76fe5ce8dcb29b03a48e5932d27a33962d5bfea842c7da3",
    "multi_material": "03fe7564304b3fe9d55354f6395660fb07ce0d6465e692345c6b4f0d1e2d7185",
    "ssaa_srgb": "e9a8816147fa7aeb5649d52c816d8b489325ce81e38eccfcfa8ced25fdd02ddd",
}


import pytest  # noqa: E402


@pytest.mark.parametrize("name", sorted(FEATURE_GOLDEN_SHA))
def test_feature_golden(name):
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from golden_scenes import render_scene_oracle

    rgba8, out = render_scene_oracle(name)
    assert int((out["vis_tri"] >= 0).sum()) > 5000  # real coverage
    assert (
        hashlib.sha256(rgba8.tobytes()).hexdigest()
        == FEATURE_GOLDEN_SHA[name]
    ), (
        f"shading semantics changed for {name}: if intentional, re-pin the "
        f"hash AND regenerate tests/golden/golden_{name}.png"
    )
    from PIL import Image

    stored = np.asarray(Image.open(f"tests/golden/golden_{name}.png"))
    np.testing.assert_array_equal(stored, rgba8)
