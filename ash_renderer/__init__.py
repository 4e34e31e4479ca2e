"""ash_renderer — a real-time software rendering framework in JAX.

A from-scratch JAX/Pallas reimagining of the capabilities of
JosephWest2/ash_renderer (a Rust/Vulkan forward renderer): the entire
per-frame render loop runs on the accelerator — batched MVP vertex
transform, tile-binned visibility rasterization with D16 early-Z, and
deferred perspective-correct shading with Blinn-Phong lighting and
mipmapped bilinear texturing — held to pixel-exact parity with a CPU oracle.
"""

from . import backend as _backend

# before any JAX backend starts: XLA:GPU must not contract mul/add
_backend.configure_xla_flags()

from .camera import Camera, CameraController, orbit_path  # noqa: F401
from .config import RendererSettings, RasterConfig, derive_raster_config  # noqa: F401
from .scene import (  # noqa: F401
    DirectionalLight,
    Material,
    Mesh,
    PackedScene,
    Scene,
    SceneObject,
    reference_two_triangle_scene,
)


def __getattr__(name):
    # lazy top-level conveniences (avoid importing jax at package import)
    if name == "Renderer":
        from .renderer import Renderer

        return Renderer
    if name == "App":
        from .app import App

        return App
    raise AttributeError(f"module 'ash_renderer' has no attribute {name!r}")


__version__ = "0.1.0"
