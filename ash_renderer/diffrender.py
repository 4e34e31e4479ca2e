"""Differentiable shading: gradients through the deferred shading stage.

A capability unlocked by building the renderer in JAX (no analogue exists or
could exist in the reference's Vulkan pipeline): with visibility held fixed
(the rasterizer is integer/discrete), the deferred shading stage is a pure
differentiable function of vertex colors, material parameters, light
parameters, and texture contents.  That makes inverse-rendering problems —
"what colors/light reproduce this image?" — a jax.grad away, running on the
same device code as the forward path.

The discrete pack/resolve steps are bypassed: losses are computed on the
float RGBA image from ops/shade.shade.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .config import RasterConfig
from .ops import shade as shade_mod
from .rtypes import LightPack, MaterialsPack

F32 = np.float32


def shade_params_fn(
    vis_tri,
    su,
    attrs,
    cfg: RasterConfig,
    materials: MaterialsPack,
    atlas=None,
    light: Optional[LightPack] = None,
    camera_pos=None,
    clear_color=(0.0, 0.0, 0.0, 1.0),
):
    """Returns f(params) -> float RGBA image, differentiable in params.

    params is a dict with any of:
      "vertex_colors": (VA, 4) overrides attrs[:, :4]
      "materials": MaterialsPack
      "light": LightPack
    Visibility (vis_tri) and geometry (su) are constants of the closure.
    """

    def fn(params):
        a = attrs
        if "vertex_colors" in params:
            a = jnp.concatenate([params["vertex_colors"], attrs[:, 4:]], axis=1)
        mats = params.get("materials", materials)
        lt = params.get("light", light)
        return shade_mod.shade(
            jnp,
            vis_tri,
            su,
            a,
            materials=mats,
            atlas=atlas,
            light=lt,
            camera_pos=camera_pos,
            cfg=cfg,
            clear_color=clear_color,
        )

    return fn


def fit_to_image(
    target_rgba: np.ndarray,
    shade_fn: Callable,
    params0: dict,
    steps: int = 200,
    lr: float = 0.05,
):
    """Adam-fit shading parameters to a target image (inverse rendering).

    Returns (params, losses).  Uses optax if present, plain SGD otherwise.
    """
    target = jnp.asarray(np.asarray(target_rgba, dtype=F32))

    def loss_fn(params):
        img = shade_fn(params)
        return jnp.mean((img[..., :3] - target[..., :3]) ** 2)

    def sanitize(g):
        # pixels hit masked/degenerate branches (e.g. zero-area barycentrics)
        # can emit NaN cotangents through jnp.where; zero them so unaffected
        # parameters aren't corrupted
        return jax.tree.map(lambda x: jnp.nan_to_num(x), g)

    grad_fn = jax.jit(jax.value_and_grad(loss_fn))
    try:
        import optax

        opt = optax.adam(lr)
        state = opt.init(params0)

        @jax.jit
        def step(params, state):
            loss, g = jax.value_and_grad(loss_fn)(params)
            g = sanitize(g)
            updates, state = opt.update(g, state)
            return optax.apply_updates(params, updates), state, loss

        params = params0
        losses = []
        for _ in range(steps):
            params, state, loss = step(params, state)
            losses.append(float(loss))
        return params, losses
    except ImportError:  # pragma: no cover
        params = params0
        losses = []
        for _ in range(steps):
            loss, g = grad_fn(params)
            g = sanitize(g)
            params = jax.tree.map(lambda p, gg: p - lr * gg, params, g)
            losses.append(float(loss))
        return params, losses
