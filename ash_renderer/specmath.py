"""The exact rasterization semantics, shared by device pipeline and CPU oracle.

This module is the single source of truth for every bit-exactness-critical
formula.  Functions take an array-namespace argument ``xp`` (``numpy`` or
``jax.numpy``) and use only operations whose results are identical IEEE-754
float32 / int32 on both backends: add, sub, mul, div, sqrt, comparisons,
integer arithmetic, and int<->float conversions.  No transcendentals.

Semantic contract (mirroring the reference's fixed-function GPU state,
``src/renderer/graphics_pipeline_components.rs:32-108``):

* Fixed-point coverage: vertex screen positions snapped to
  ``1 / subpixel_scale`` pixels, int32 edge functions, top-left fill rule.
  Front face: the reference configures CULL_BACK + FRONT_FACE_COUNTER_CLOCKWISE
  (graphics_pipeline_components.rs:69-73).  Vulkan computes facing from the
  framebuffer-space signed area with y pointing down; with the reference's
  matrix stack that means a triangle is front-facing iff the shoelace value
  ``(x1-x0)(y2-y0) - (y1-y0)(x2-x0) < 0`` in y-down snapped coordinates
  (under which the reference's z=2 triangle is kept and its z=3 triangle is
  culled).  Front triangles are rewound (v1<->v2) so the rasterizer always
  sees positive area with interior-positive edge functions.
* Depth: D16_UNORM semantics (depth_image_components.rs:5).  Vertex NDC depth
  is quantized to 16 bits, interpolated with screen-space barycentric weights
  in f32, rounded.  Depth test LESS_OR_EQUAL against a buffer cleared to 1.0
  (renderer.rs:447-457), with later draws winning ties — expressed
  order-independently as a per-pixel min over the key ``(d16, -triangle_id)``.
* Interpolation: perspective-correct via per-vertex 1/w_clip, the standard
  "attributes and 1/w are affine in screen space" identity.
"""

from __future__ import annotations

import numpy as np

F32 = np.float32
I32 = np.int32

DEPTH_MAX = 65535  # D16_UNORM clear value (depth cleared to 1.0)
BG_TRI = -1  # background triangle id; any fragment (idx >= 0) beats it on ties


# ---------------------------------------------------------------------------
# Orientation / culling
# ---------------------------------------------------------------------------

def shoelace2(x0, y0, x1, y1, x2, y2):
    """Twice the signed shoelace area of snapped int32 coords (y-down).

    Negative => front-facing under the reference's CCW-front convention.
    Magnitude bounded < 2^31 by the guard-rect clamp (config.RasterConfig).
    """
    return (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)


# ---------------------------------------------------------------------------
# Edge functions & fill rule
# ---------------------------------------------------------------------------

def edge_coeffs(xa, ya, xb, yb):
    """Directed edge a->b: returns (A, B, is_top_left) with
    ``E(p) = A*(px - xa) + B*(py - ya)``; interior (for a positive-area
    triangle) has E > 0.  A = -(yb - ya), B = (xb - xa).

    Top-left rule (y-down, interior-positive): accept E == 0 for top edges
    (dy == 0 and dx > 0) and left edges (dy < 0).
    """
    dx = xb - xa
    dy = yb - ya
    a = -dy
    b = dx
    top = (dy == 0) & (dx > 0)
    left = dy < 0
    return a, b, top | left


def fill_bias(is_top_left, xp):
    """Per-edge bias: 0 for top-left edges, -1 otherwise, so coverage is
    ``E + bias >= 0``  <=>  ``E > 0  or  (E == 0 and top-left)``."""
    return xp.where(is_top_left, I32(0), I32(-1))


def edge_at(a, b, xa, ya, px, py):
    """Evaluate E = A*(px - xa) + B*(py - ya) at sample points (int32).

    Safe in int32 when both the vertex and the samples lie in the guard rect.
    """
    return a * (px - xa) + b * (py - ya)


def pixel_sample_coords(px, py, subpixel_scale):
    """Snapped coordinates of the center of pixel (px, py): Vulkan samples at
    pixel centers (+0.5)."""
    half = subpixel_scale // 2
    return px * subpixel_scale + half, py * subpixel_scale + half


# ---------------------------------------------------------------------------
# Vertex transform
# ---------------------------------------------------------------------------

def apply_mat4_point(m, x, y, z):
    """Transform a point (w=1) by a row-major 4x4 with the spec's fixed
    association per output component: ((m0*x + m1*y) + (m2*z + m3)).

    Replaces matmul/einsum in parity-critical paths: matrix-unit/BLAS
    accumulation orders (and TF32 on GPUs) are platform-dependent, explicit
    mul/add chains are not.
    Returns (cx, cy, cz, cw); m indexable as m[..., row, col] with leading
    dims broadcastable against x/y/z.
    """

    def row(r):
        return (m[..., r, 0] * x + m[..., r, 1] * y) + (
            m[..., r, 2] * z + m[..., r, 3]
        )

    return row(0), row(1), row(2), row(3)


def apply_mat3_vec(m, x, y, z):
    """Transform a direction by the upper 3x3: (m0*x + m1*y) + m2*z."""

    def row(r):
        return (m[..., r, 0] * x + m[..., r, 1] * y) + m[..., r, 2] * z

    return row(0), row(1), row(2)


# ---------------------------------------------------------------------------
# Snapping
# ---------------------------------------------------------------------------

def snap_coord(ndc, size_px, subpixel_scale, min_c, max_c, xp):
    """NDC in [-1,1] -> snapped int32 subpixel coordinate, clamped to the
    guard rect.  Spec formula: round(ndc * half + half) with the exact f32
    constant half = size_px * subpixel_scale / 2 (pre-distributed so XLA's
    constant-reassociation rules have nothing to rewrite)."""
    half = F32(F32(size_px * subpixel_scale) * F32(0.5))
    s = ndc * half + half
    return xp.clip(xp.round(s), min_c, max_c).astype(I32)


def quantize_depth(z_ndc, xp):
    """Per-vertex D16 depth: round(z_ndc * 65535), clamped."""
    return xp.clip(xp.round(z_ndc * F32(DEPTH_MAX)), 0, DEPTH_MAX).astype(I32)


# ---------------------------------------------------------------------------
# Interpolation
# ---------------------------------------------------------------------------

def dot3(w0, a0, w1, a1, w2, a2):
    """The spec's 3-term dot product with fixed association:
    (w0*a0 + w1*a1) + w2*a2."""
    return (w0 * a0 + w1 * a1) + w2 * a2


def bary_weights(e0, e1, e2, inv_area2, xp):
    """Screen-space barycentric weights from int32 edge values and the
    precomputed f32 reciprocal of the (positive) doubled area."""
    del xp
    return (
        e0.astype(F32) * inv_area2,
        e1.astype(F32) * inv_area2,
        e2.astype(F32) * inv_area2,
    )


def interp_depth16(e0, e1, e2, inv_area2, zq0, zq1, zq2, xp):
    """f32 barycentric interpolation of 16-bit vertex depths -> int32 d16.

    Structured as (sum e_i * z_i) * inv_area2 — a single shared factor applied
    AFTER the sum — so XLA's algebraic simplifier (which rewrites
    ``a*c + b*c -> (a+b)*c``, changing rounding) sees no factorable pattern.
    """
    num = dot3(
        e0.astype(F32), zq0.astype(F32),
        e1.astype(F32), zq1.astype(F32),
        e2.astype(F32), zq2.astype(F32),
    )
    return round_depth16(num * inv_area2, xp)


def round_depth16(x, xp):
    """clip(round_half_even(x), 0, DEPTH_MAX) as int32, from floor and
    exact compares (Triton has no rounding primitive).  After the clip to
    [-1, 2**16], ``y - floor(y)`` is exact, so the tie test is too; the clip
    also keeps the multiply that produced x out of a fused multiply-add."""
    y = xp.clip(x, F32(-1.0), F32(DEPTH_MAX + 1))
    fl = xp.floor(y)
    frac = y - fl
    r = fl.astype(I32)
    up = (frac > F32(0.5)) | ((frac == F32(0.5)) & ((r & 1) == 1))
    return xp.clip(r + up.astype(I32), 0, DEPTH_MAX)


def persp_weights(l0, l1, l2, iw0, iw1, iw2, xp):
    """Perspective-correct weights from screen barycentrics and per-vertex
    1/w_clip.  Returns (m0, m1, m2) summing to 1."""
    p0 = l0 * iw0
    p1 = l1 * iw1
    p2 = l2 * iw2
    s = (p0 + p1) + p2
    inv = recip_spec(s, xp)
    return p0 * inv, p1 * inv, p2 * inv


def depth_key_better(d_new, idx_new, d_old, idx_old):
    """LESS_OR_EQUAL depth test with draw order resolved order-independently:
    the fragment minimizing (d16, -draw_index) wins.  Equivalent to the
    reference's sequential LE-replace in submission order
    (renderer.rs:533-540 relies on API draw order for ties)."""
    return (d_new < d_old) | ((d_new == d_old) & (idx_new > idx_old))


# ---------------------------------------------------------------------------
# Output packing
# ---------------------------------------------------------------------------

def srgb_encode_lut() -> np.ndarray:
    """4096-entry sRGB encode LUT over linear [0,1] -> [0,1].  Gather-based so
    the device path stays transcendental-free and bit-exact vs the oracle."""
    x = np.linspace(0.0, 1.0, 4096, dtype=np.float64)
    y = np.where(x <= 0.0031308, 12.92 * x, 1.055 * np.power(x, 1 / 2.4) - 0.055)
    return y.astype(F32)


def pack_unorm8(c, xp):
    """f32 [0,1] -> uint8: round(clamp(c) * 255)."""
    return xp.round(xp.clip(c, F32(0.0), F32(1.0)) * F32(255.0)).astype(np.uint8)


# ---------------------------------------------------------------------------
# Bit-exact helpers
# ---------------------------------------------------------------------------
#
# Accelerator division / sqrt may be approximate (reciprocal-unit based or
# fast-math lowered) and need not round like IEEE numpy, while mul/add/sub/
# int-conversions are bit-exact as long as nothing contracts a*b+c into a
# fused multiply-add (XLA:CPU is held to SSE4.2 in the tests; XLA:GPU and
# the Triton kernel are held by backend.NO_FMA_FLAG, checked by
# exactness.CHAINS on the card).  So the spec defines its own division and
# rsqrt from exact primitives only: a bit-trick seed plus Newton-Raphson
# refinements.  Deterministic on every backend, accurate to ~2 ulp.


def _bitcast_i32(x, xp):
    if xp is np:
        a = np.ascontiguousarray(np.asarray(x, dtype=F32))
        return a.view(np.int32).reshape(np.shape(x))
    import jax

    return jax.lax.bitcast_convert_type(x, np.int32)


def _bitcast_f32(x, xp):
    if xp is np:
        a = np.ascontiguousarray(np.asarray(x, dtype=I32))
        return a.view(F32).reshape(np.shape(x))
    import jax

    return jax.lax.bitcast_convert_type(x, F32)


def recip_spec(x, xp):
    """Deterministic ~2-ulp reciprocal of finite nonzero x (any sign).

    Near-zero / huge inputs legitimately overflow intermediates to inf
    (callers sanitize); silence numpy's RuntimeWarning for those — the jnp
    trace path never warns."""
    import contextlib

    ctx = (
        np.errstate(over="ignore", invalid="ignore")
        if xp is np
        else contextlib.nullcontext()
    )
    with ctx:
        bits = _bitcast_i32(x, xp)
        sign = bits & I32(-2147483648)
        mag = bits & I32(0x7FFFFFFF)
        r = _bitcast_f32(I32(0x7EF311C3) - mag, xp)
        ax = _bitcast_f32(mag, xp)
        for _ in range(3):
            r = r * (F32(2.0) - ax * r)
        return _bitcast_f32(_bitcast_i32(r, xp) ^ sign, xp)


def div_spec(a, b, xp):
    """The spec's division: a * recip_spec(b)."""
    return a * recip_spec(b, xp)


def rsqrt_spec(x, xp):
    """Deterministic ~2-ulp reciprocal square root of positive x."""
    bits = _bitcast_i32(x, xp)
    r = _bitcast_f32(I32(0x5F375A86) - (bits >> 1), xp)
    for _ in range(3):
        r = r * (F32(1.5) - F32(0.5) * x * r * r)
    return r


def lerp(a, b, t):
    """The spec's linear interpolation: a + (b - a) * t."""
    return a + (b - a) * t


def float_exponent(x, xp):
    """floor(log2(|x|)) for normalized positive f32, via exponent bits —
    transcendental-free and bit-exact on both backends."""
    if xp is np:
        bits = np.ascontiguousarray(np.asarray(x, dtype=F32)).view(np.int32)
    else:
        import jax

        bits = jax.lax.bitcast_convert_type(x, np.int32)
    return ((bits >> 23) & 0xFF) - 127


FLT_MIN_NORMAL = F32(1.1754944e-38)


def flush_subnormal(v, xp):
    """Map subnormals to 0: XLA backends flush-to-zero, numpy does not, so
    the spec defines all sub-FLT_MIN magnitudes as exactly 0."""
    return xp.where(xp.abs(v) < FLT_MIN_NORMAL, F32(0.0), v)


def powi(x, e, max_bits, xp):
    """x ** e for x in [0, 1] and a per-element non-negative integer exponent
    e < 2**max_bits, by square-and-multiply with a fixed op sequence.
    Underflowing results are flushed to 0 (see flush_subnormal); with x <= 1
    every intermediate shrinks monotonically so the final flush canonicalizes
    both backends."""
    result = xp.ones_like(x)
    base = x
    for bit in range(max_bits):
        take = (e >> bit) & 1
        result = xp.where(take == 1, result * base, result)
        if bit + 1 < max_bits:
            base = base * base
    return flush_subnormal(result, xp)
