"""Device selection mirrors the reference's preference+scoring semantics."""

import types

import jax
import pytest

from ash_renderer import RendererSettings
from ash_renderer.renderer import select_device


def test_explicit_preference_honored():
    devices = jax.devices()
    st = RendererSettings(preferred_device_index=len(devices) - 1)
    assert select_device(st) is devices[len(devices) - 1]


def test_score_order(monkeypatch):
    fake = [
        types.SimpleNamespace(platform="cpu", id=0),
        types.SimpleNamespace(platform="gpu", id=1),
        types.SimpleNamespace(platform="gpu", id=2),
    ]
    monkeypatch.setattr(jax, "devices", lambda: fake)
    assert select_device(RendererSettings()) is fake[1]  # first GPU wins
    assert (
        select_device(RendererSettings(preferred_device_index=0)).platform
        == "cpu"
    )
    monkeypatch.setattr(jax, "devices", lambda: fake[:1])
    assert select_device(RendererSettings()) is fake[0]  # CPU-only host


def test_update_settings_reselects_device():
    import dataclasses

    import jax

    from ash_renderer import reference_two_triangle_scene
    from ash_renderer.renderer import Renderer

    devices = jax.devices()
    r = Renderer(
        reference_two_triangle_scene(),
        dataclasses.replace(
            __import__("ash_renderer").RendererSettings(
                width=64, height=48, clip_budget=32
            ),
            preferred_device_index=0,
        ),
    )
    assert r.device is devices[0]
    new = dataclasses.replace(
        r.settings, preferred_device_index=len(devices) - 1
    )
    r.update_settings(new)
    assert r.device is devices[len(devices) - 1]
    # renders on the new device
    from ash_renderer import Camera
    import numpy as np

    rgba8, aux = r.render_frame(Camera())
    assert np.asarray(rgba8).shape == (48, 64, 4)
