"""Bitwise exactness probes for a JAX backend.

Every frame must equal the NumPy oracle bit for bit, which holds only if the
backend rounds each f32 multiply and add on its own (no fused multiply-add
contraction) and does not re-associate the spec's formulas.  Two probes check
that on whatever device they are given:

* :data:`CHAINS` — each parity-critical specmath chain, evaluated by numpy
  and by jitted XLA on random inputs, compared bit for bit;
* :func:`parity_gate` — a 160-triangle scene rendered at 256x192 through the
  full device pipeline, compared with the oracle frame bit for bit.

The CPU tests run both on XLA:CPU; on a GPU they are the first phase of
``chip_smoke.py``.
"""

from __future__ import annotations

import numpy as np

from . import specmath as sm

F32 = np.float32
I32 = np.int32


def _recip(rng, n):
    x = np.concatenate(
        [rng.uniform(1e-6, 1e6, n // 2), rng.uniform(-1e6, -1e-6, n // 2)]
    ).astype(F32)
    return (lambda xp, v: sm.recip_spec(v, xp)), (x,)


def _rsqrt(rng, n):
    pos = rng.uniform(1e-12, 1e12, n).astype(F32)
    return (lambda xp, v: sm.rsqrt_spec(v, xp)), (pos,)


def _snap(rng, n):
    ndc = rng.uniform(-1.5, 1.5, n).astype(F32)
    return (
        lambda xp, v: sm.snap_coord(v, 1920, 16, -512, (1920 + 32) * 16, xp)
    ), (ndc,)


def _quantize_depth(rng, n):
    z = rng.uniform(-0.1, 1.1, n).astype(F32)
    return (lambda xp, v: sm.quantize_depth(v, xp)), (z,)


def _depth_interp(rng, n):
    area = rng.integers(1, 2**30, n).astype(I32)
    # edge values in [0, area] as for interior pixels
    f = rng.uniform(0, 1, (2, n))
    e0 = (f[0] * area).astype(I32)
    e1 = (f[1] * (area - e0)).astype(I32)
    e2 = area - e0 - e1
    zq = rng.integers(0, 65536, (3, n)).astype(I32)

    def chain(xp, e0, e1, e2, area, z0, z1, z2):
        inv = sm.recip_spec(area.astype(F32), xp)
        return sm.interp_depth16(e0, e1, e2, inv, z0, z1, z2, xp)

    return chain, (e0, e1, e2, area, zq[0], zq[1], zq[2])


def _perspective_weights(rng, n):
    area = rng.integers(1, 2**30, n).astype(I32)
    e = rng.integers(0, 2**24, (3, n)).astype(I32)
    iw = rng.uniform(0.01, 100, (3, n)).astype(F32)
    attr = rng.uniform(-5, 5, (3, n)).astype(F32)

    def chain(xp, e0, e1, e2, area, iw0, iw1, iw2, a0, a1, a2):
        inv = sm.recip_spec(area.astype(F32), xp)
        l0, l1, l2 = sm.bary_weights(e0, e1, e2, inv, xp)
        m0, m1, m2 = sm.persp_weights(l0, l1, l2, iw0, iw1, iw2, xp)
        return sm.dot3(m0, a0, m1, a1, m2, a2)

    return chain, (e[0], e[1], e[2], area, iw[0], iw[1], iw[2], *attr)


def _mat4_apply(rng, n):
    m = rng.uniform(-2, 2, (n, 4, 4)).astype(F32)
    p = rng.uniform(-10, 10, (3, n)).astype(F32)
    return (lambda xp, m, x, y, z: sm.apply_mat4_point(m, x, y, z)), (
        m, p[0], p[1], p[2],
    )


def _lerp(rng, n):
    a, b = rng.uniform(-10, 10, (2, n)).astype(F32)
    t = rng.uniform(0, 1, n).astype(F32)
    return (lambda xp, a, b, t: sm.lerp(a, b, t)), (a, b, t)


def _powi(rng, n):
    x = rng.uniform(0, 1, n).astype(F32)
    e = rng.integers(0, 256, n).astype(I32)
    return (lambda xp, x, e: sm.powi(x, e, 8, xp)), (x, e)


def _float_exponent(rng, n):
    x = rng.uniform(1e-20, 1e20, n).astype(F32)
    return (lambda xp, v: sm.float_exponent(v, xp)), (x,)


def _normalize(rng, n):
    v = rng.uniform(-100, 100, (n, 3)).astype(F32)

    def chain(xp, v):
        n2 = sm.dot3(
            v[..., 0], v[..., 0], v[..., 1], v[..., 1], v[..., 2], v[..., 2]
        )
        inv = sm.rsqrt_spec(xp.maximum(n2, F32(1e-30)), xp)
        return v * inv[..., None]

    return chain, (v,)


def _pack_unorm8(rng, n):
    c = rng.uniform(-0.2, 1.2, n).astype(F32)
    return (lambda xp, c: sm.pack_unorm8(c, xp)), (c,)


def _edges(rng, n):
    xs = rng.integers(-(2**14), 2**14, (3, n)).astype(I32)
    ys = rng.integers(-(2**14), 2**14, (3, n)).astype(I32)

    def chain(xp, xa, ya, xb, yb, px, py):
        a, b, tl = sm.edge_coeffs(xa, ya, xb, yb)
        return sm.edge_at(a, b, xa, ya, px, py) + sm.fill_bias(tl, xp)

    return chain, (xs[0], ys[0], xs[1], ys[1], xs[2], ys[2])


# name -> builder(rng, n) -> (fn(xp, *args), args)
CHAINS = {
    "recip": _recip,
    "rsqrt": _rsqrt,
    "snap": _snap,
    "quantize_depth": _quantize_depth,
    "depth_interp": _depth_interp,
    "perspective_weights": _perspective_weights,
    "mat4_apply": _mat4_apply,
    "lerp": _lerp,
    "powi": _powi,
    "float_exponent": _float_exponent,
    "normalize": _normalize,
    "pack_unorm8": _pack_unorm8,
    "edges": _edges,
}


def bit_mismatches(a, b) -> int:
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype != b.dtype:
        raise TypeError(f"dtype differs: {a.dtype} vs {b.dtype}")
    if a.dtype == F32:
        return int((a.view(I32) != b.view(I32)).sum())
    return int((a != b).sum())


def chain_mismatches(name: str, device=None, n: int = 100_000,
                     seed: int = 1234) -> int:
    """Bits that differ between numpy and jitted XLA on ``device`` (default:
    JAX's default device) for chain ``name``."""
    import jax
    import jax.numpy as jnp

    fn, args = CHAINS[name](np.random.default_rng(seed), n)
    ref = fn(np, *args)
    dev_args = jax.device_put(args, device)
    got = jax.jit(lambda *a: fn(jnp, *a))(*dev_args)
    if isinstance(ref, tuple):
        return sum(bit_mismatches(r, g) for r, g in zip(ref, got))
    return bit_mismatches(ref, got)


def parity_scene():
    """160 random triangles in front of the default camera, at 256x192."""
    from .config import RendererSettings
    from .scene import Mesh, Scene, SceneObject

    rng = np.random.default_rng(5)
    nv, nt = 200, 160
    pos = rng.uniform(-2, 2, (nv, 3)).astype(F32)
    pos[:, 2] += 3.5
    mesh = Mesh(
        positions=pos,
        indices=rng.integers(0, nv, (nt, 3)).astype(I32),
        colors=rng.uniform(0, 1, (nv, 4)).astype(F32),
    )
    scene = Scene()
    scene.add_object(SceneObject(mesh=scene.add_mesh(mesh)))
    return scene, RendererSettings(width=256, height=192)


def parity_gate(device=None) -> bool:
    """Render :func:`parity_scene` through ``Renderer`` on ``device`` (by
    index into ``jax.devices()``; default: the renderer's choice) and
    compare the frame with the oracle's, bit for bit."""
    import dataclasses

    import jax

    from .camera import Camera
    from .oracle import render_oracle
    from .renderer import Renderer

    scene, settings = parity_scene()
    if device is not None:
        settings = dataclasses.replace(
            settings, preferred_device_index=jax.devices().index(device)
        )
    r = Renderer(scene, settings)
    cam = Camera()
    rgba8, aux = r.render_frame(cam)
    o = render_oracle(
        scene.pack(), scene.model_matrices(), cam.view_matrix(),
        cam.projection_matrix(settings.width / settings.height), settings,
        materials=jax.tree.map(np.asarray, r.materials), cfg=r.cfg,
    )
    return bool(
        np.array_equal(np.asarray(rgba8), o["rgba8"])
        and np.array_equal(np.asarray(aux["vis_tri"]), o["vis_tri"])
        and np.array_equal(np.asarray(aux["vis_d16"]), o["vis_d16"])
    )
