"""Bitwise determinism canaries: every parity-critical spec formula must
produce IDENTICAL bits under numpy and jitted XLA.

These tests guard against XLA rewrites that change f32 rounding (FMA
contraction — disabled on CPU via --xla_cpu_max_isa=SSE4_2 in conftest and
on the GPU via ash_renderer.backend.NO_FMA_FLAG — and algebraic factoring
like a*c + b*c -> (a+b)*c, which the spec formulas are structured to avoid).
The chains live in ash_renderer.exactness; the ``gpu`` cases run them on
the card.  If any fail after a JAX upgrade, the spec in specmath.py must be
re-hardened.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ash_renderer import exactness
from ash_renderer import specmath as sm

N = 100000


def bits_equal(a, b):
    return exactness.bit_mismatches(a, b)


def check(*names):
    for name in names:
        mism = exactness.chain_mismatches(name, n=N)
        assert mism == 0, f"{name}: {mism} bit mismatches"


def test_recip_rsqrt_spec():
    check("recip", "rsqrt")


def test_recip_rsqrt_accuracy():
    rng = np.random.default_rng(1234)
    x = rng.uniform(1e-6, 1e6, N).astype(np.float32)
    r = sm.recip_spec(x, np).astype(np.float64)
    rel = np.abs((r - 1.0 / x.astype(np.float64)) * x.astype(np.float64))
    assert rel.max() < 3e-7  # ~2 ulp
    rs = sm.rsqrt_spec(x, np).astype(np.float64)
    rel = np.abs(rs * np.sqrt(x.astype(np.float64)) - 1.0)
    assert rel.max() < 3e-7


def test_snap_and_depth_quantize():
    check("snap", "quantize_depth")


def test_depth_interp_chain():
    check("depth_interp")


def test_perspective_weight_chain():
    check("perspective_weights")


def test_mat4_apply_chain():
    check("mat4_apply")


def test_lerp_and_powi():
    check("lerp", "powi")


def test_float_exponent():
    check("float_exponent")
    # sanity: equals floor(log2)
    x = np.random.default_rng(1234).uniform(1e-20, 1e20, N).astype(np.float32)
    ref = np.floor(np.log2(x.astype(np.float64))).astype(np.int64)
    got = sm.float_exponent(x, np).astype(np.int64)
    assert (ref == got).all()


def test_normalize_chain():
    check("normalize")


def test_pack_unorm8_and_edges():
    check("pack_unorm8", "edges")


def test_round_depth16_is_round_half_even():
    """The rounding in interp_depth16 (floor + exact tie test, no round
    primitive) equals clip(round_half_even(x)) at every tie, its
    neighbours, and far out of range — under numpy and jitted XLA."""
    rng = np.random.default_rng(3)
    k = np.arange(-4, 65541).astype(np.float32)
    x = np.concatenate([
        rng.uniform(-3, 66000, 200000), k, k + np.float32(0.5),
        rng.uniform(-1e9, 1e9, 10000),
    ]).astype(np.float32)
    x = np.concatenate([
        x, np.nextafter(x, np.float32(np.inf)),
        np.nextafter(x, np.float32(-np.inf)),
    ])
    ref = np.clip(np.round(x), 0, sm.DEPTH_MAX).astype(np.int32)
    np.testing.assert_array_equal(sm.round_depth16(x, np), ref)
    got = jax.jit(lambda v: sm.round_depth16(v, jnp))(x)
    np.testing.assert_array_equal(np.asarray(got), ref)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(exactness.CHAINS))
def test_chain_on_gpu(name, gpu_device):
    assert exactness.chain_mismatches(name, device=gpu_device, n=N) == 0


@pytest.mark.gpu
def test_parity_gate_on_gpu(gpu_device):
    assert exactness.parity_gate(gpu_device)


def test_parity_gate_on_cpu():
    """The 256x192 gate that chip_smoke.py runs on the card, here on CPU."""
    assert exactness.parity_gate(jax.devices("cpu")[0])


def test_full_shade_parity_small_scene():
    """End-to-end: the shared shade() under numpy vs jit must agree bitwise
    on a real visibility buffer (lit, textured, perspective camera)."""
    from ash_renderer import (
        Camera,
        DirectionalLight,
        Material,
        Mesh,
        RendererSettings,
        Scene,
        SceneObject,
        derive_raster_config,
    )
    from ash_renderer.oracle import geometry_oracle, visibility_oracle
    from ash_renderer.oracle.raster_cpu import compose_mvp
    from ash_renderer.ops import shade as shmod
    from ash_renderer.rtypes import LightPack, MaterialsPack
    from ash_renderer.textures import TextureAtlas, checkerboard

    rng = np.random.default_rng(7)
    nv, nt = 60, 40
    pos = rng.uniform(-1.5, 1.5, (nv, 3)).astype(np.float32)
    pos[:, 2] += 3.0
    mesh = Mesh(
        positions=pos,
        indices=rng.integers(0, nv, (nt, 3)).astype(np.int32),
        colors=rng.uniform(0, 1, (nv, 4)).astype(np.float32),
        uvs=rng.uniform(-1, 2, (nv, 2)).astype(np.float32),
    ).compute_normals()
    scene = Scene(materials=[Material(texture_id=0, specular=0.4, shininess=16)])
    scene.add_object(SceneObject(mesh=scene.add_mesh(mesh)))
    settings = RendererSettings(width=96, height=64)
    cfg = derive_raster_config(96, 64)
    cam = Camera()
    packed = scene.pack()
    su, attrs = geometry_oracle(
        packed,
        scene.model_matrices(),
        cam.view_matrix(),
        cam.projection_matrix(96 / 64),
        cfg,
        64,
    )
    vis_d, vis_t = visibility_oracle(su, cfg)
    assert (vis_t >= 0).sum() > 50  # scene actually covers pixels

    atlas = TextureAtlas.build([checkerboard(64)])
    mats = MaterialsPack(
        base_color=np.array([[1, 1, 1, 1]], np.float32),
        tex_id=np.array([0], np.int32),
        specular=np.array([0.4], np.float32),
        shininess=np.array([16], np.int32),
    )
    light = LightPack(
        direction=np.array([0.3, -0.5, 0.8], np.float32),
        color=np.array([1.0, 0.9, 0.8], np.float32),
        ambient=np.float32(0.15),
    )
    cam_pos = cam.position.astype(np.float32)

    kwargs = dict(
        materials=mats,
        atlas=atlas,
        light=light,
        camera_pos=cam_pos,
        cfg=cfg,
        clear_color=(0.1, 0.2, 0.3, 1.0),
    )
    out_np = shmod.shade(np, vis_t, su, attrs, **kwargs)
    out_j = jax.jit(
        lambda vt, su_, at_: shmod.shade(jnp, vt, su_, at_, **kwargs)
    )(vis_t, su, attrs)
    assert bits_equal(out_np, np.asarray(out_j)) == 0
    # and the packed output
    p_np = shmod.resolve_and_pack(np, out_np, 1, False)
    p_j = jax.jit(lambda o: shmod.resolve_and_pack(jnp, o, 1, False))(out_j)
    assert bits_equal(p_np, np.asarray(p_j)) == 0
