"""Configuration for the renderer.

The reference keeps one knob — ``UserSettings { preferred_physical_device_id }``
(``src/renderer.rs:34-44``) — with the contract that changing settings rebuilds
the whole settings-dependent world (``renderer.rs:624-627``), and that resizing
rebuilds only the resolution-dependent components (``renderer.rs:601-620``).

We keep the same three-tier contract (see ``renderer.py``):

* process/runtime init (jax platform, device list) — settings independent;
* :class:`RendererSettings` — changing any field rebuilds compiled kernels and
  device buffers (the SDC analogue);
* resolution (``width``/``height``/``supersample``) — changing it re-allocates
  framebuffers and re-jits shape-specialized kernels (the RDC analogue).

:class:`RasterConfig` holds the derived fixed-point / tiling parameters of the
rasterizer.  Everything here is hashable and static so it can key jit caches.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["RendererSettings", "RasterConfig", "derive_raster_config"]


@dataclasses.dataclass(frozen=True)
class RendererSettings:
    """User-facing settings (analogue of UserSettings, renderer.rs:34-44)."""

    # Device preference: index into jax.devices(); None = the first GPU, else
    # the first device (the reference scores discrete > integrated > virtual
    # > cpu, renderer.rs:370-386; backend.select_device).
    preferred_device_index: Optional[int] = None

    width: int = 800
    height: int = 600
    # Supersampling factor per axis: 1 = off, 2 = 4x SSAA (BASELINE config 5).
    supersample: int = 1
    # Clear values (renderer.rs:441-457: color clear + depth cleared to 1.0).
    clear_color: tuple[float, float, float, float] = (0.0, 0.0, 0.0, 1.0)
    # Encode framebuffer to sRGB on RGBA8 pack (the reference presents to the
    # first surface format the driver reports, commonly *_SRGB; we make the
    # choice explicit and default linear for oracle-parity simplicity).
    srgb_output: bool = False
    # Debug mode: NaN/inf guards + overflow counters (stand-in for the
    # reference's validation layer, debug_components.rs).
    debug: bool = False
    # Cap on triangles needing polygon clipping per frame (static shape;
    # overflow is counted and dropped in debug stats).
    clip_budget: int = 4096
    # Cap on (triangle, tile) pairs for the binner (static shape).
    max_pairs: int = 1 << 21
    # Number of framebuffer ring slots (swapchain image-count analogue;
    # the reference asks for min_image_count + 1, swapchain_components.rs:35-41).
    frames_in_flight: int = 2
    # Per-stage jits instead of one frame function: faster compiles at
    # 1M-triangle shapes, for the cost of materialising stage boundaries.
    staged_pipeline: bool = False
    # Multi-device rendering: render over the first n jax devices as a 1-D
    # framebuffer-row mesh (parallel/sharding.py); None = single device.
    # Any resolution works: an indivisible tile-row count is padded up
    # inside the sharded path and the frame cropped back.
    # The frame comes back bit-identical to single-device rendering
    # (tests/test_sharding.py); an explicit ``mesh=`` argument to Renderer
    # overrides this knob.
    n_devices: Optional[int] = None

    @property
    def render_width(self) -> int:
        return self.width * self.supersample

    @property
    def render_height(self) -> int:
        return self.height * self.supersample


@dataclasses.dataclass(frozen=True)
class RasterConfig:
    """Derived static rasterizer parameters.

    Fixed-point contract: vertex positions are snapped to a grid of
    ``1 / (1 << subpixel_bits)`` pixels and clamped to a guard rect extending
    ``guard_px`` beyond the screen.  With the rect's total extent bounded by
    ``2**15 - 16`` subpixel units, every edge-function value and the signed
    area fit in int32 (|E| <= 2 * extent^2 < 2^31), making coverage and depth
    bit-exact and platform-independent.  This replaces the float rasterization
    the GPU fixed-function hardware performs in the reference
    (graphics_pipeline_components.rs:69-108) with an exactly specified one.
    """

    width: int
    height: int
    subpixel_bits: int
    guard_px: int
    tile_h: int
    tile_w: int

    @property
    def subpixel_scale(self) -> int:
        return 1 << self.subpixel_bits

    @property
    def grid_h(self) -> int:
        return -(-self.height // self.tile_h)

    @property
    def grid_w(self) -> int:
        return -(-self.width // self.tile_w)

    @property
    def n_tiles(self) -> int:
        return self.grid_h * self.grid_w

    # Guard-rect bounds in snapped subpixel units (inclusive).
    @property
    def min_coord(self) -> int:
        return -self.guard_px * self.subpixel_scale

    @property
    def max_coord_x(self) -> int:
        return (self.width + self.guard_px) * self.subpixel_scale

    @property
    def max_coord_y(self) -> int:
        return (self.height + self.guard_px) * self.subpixel_scale


_MAX_EXTENT_SUBPIX = (1 << 15) - 16  # keeps 2*extent^2 < 2^31 with headroom

# Framebuffer tile of the visibility kernel (powers of two, as Triton
# blocks must be), chosen on an H100 (PERF.md): small tiles keep the
# longest per-tile record list short.  The width must divide 1920 for 1080p
# frames to keep 4 subpixel bits, which the stored goldens were rendered
# with.
TILE_H = 4
TILE_W = 64


def derive_raster_config(
    width: int,
    height: int,
    tile_h: int = TILE_H,
    tile_w: int = TILE_W,
    guard_px: int = 32,
) -> RasterConfig:
    """Pick the largest subpixel precision that keeps int32 edge functions safe.

    The extent bound covers the tile-padded framebuffer (edge tiles extend
    past the screen, and the raster kernel evaluates edge functions at those
    samples too)."""
    pad_w = -(-width // tile_w) * tile_w
    pad_h = -(-height // tile_h) * tile_h
    extent_px = max(pad_w, pad_h, width, height) + 2 * guard_px
    subpixel_bits = 4
    while subpixel_bits > 0 and extent_px * (1 << subpixel_bits) > _MAX_EXTENT_SUBPIX:
        subpixel_bits -= 1
    if extent_px * (1 << subpixel_bits) > _MAX_EXTENT_SUBPIX:
        raise ValueError(
            f"resolution {width}x{height} too large for int32 fixed-point raster"
        )
    return RasterConfig(
        width=width,
        height=height,
        subpixel_bits=subpixel_bits,
        guard_px=guard_px,
        tile_h=tile_h,
        tile_w=tile_w,
    )
