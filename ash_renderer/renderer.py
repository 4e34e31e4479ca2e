"""Renderer facade: the stateful top-level object with the reference's
three-tier lifecycle.

Mirrors ``src/renderer.rs``'s architecture exactly (SURVEY §1):

* **Settings-independent tier** (SettingsIndependentComponents,
  renderer.rs:75-153): process/JAX runtime init + device selection — done
  once in ``__init__``.
* **Settings-dependent tier** (SettingsDependentComponents,
  renderer.rs:156-308): scene buffers uploaded to the device, materials/
  atlas/light packs, and the jit-compiled frame function — rebuilt wholesale
  by :meth:`update_settings` (the update_user_settings analogue,
  renderer.rs:624-627).
* **Resize-dependent tier** (ResizeDependentComponents,
  renderer.rs:601-620): the RasterConfig + shape-specialized compiled kernels
  + framebuffer ring — rebuilt by :meth:`resize`.

Per frame (:meth:`draw_frame`, the renderer.rs:389-597 analogue): the host
composes camera + per-object matrices (the 192-byte UBO write), calls the
compiled pipeline (async dispatch), and pushes the frame into the present
ring, which blocks only frames_in_flight frames later (fence analogue).
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from . import backend
from .camera import Camera
from .config import RendererSettings, derive_raster_config
from .oracle.raster_cpu import compose_mvp
from .pipeline import FrameStatics, render_frame_jit, render_frame_staged
from .present import FrameRing
from .rtypes import LightPack, MaterialsPack
from .scene import Scene
from .utils.profiling import FrameStats

F32 = np.float32


def select_device(settings: RendererSettings):
    """Device selection mirroring the reference's scoring
    (renderer.rs:332-387): honor the explicit preference, else prefer a GPU
    (backend.select_device)."""
    return backend.select_device(settings.preferred_device_index)


class Renderer:
    def __init__(
        self,
        scene: Scene,
        settings: Optional[RendererSettings] = None,
        mesh=None,
    ):
        """mesh: optional jax.sharding.Mesh (1-D, any axis name) for
        multi-device rendering — framebuffer tile rows are data-parallel over
        its devices (parallel/sharding.py) and the frame is bit-identical to
        single-device output.  Alternatively set
        ``RendererSettings.n_devices``; the explicit mesh wins."""
        settings = settings or RendererSettings()
        # --- settings-independent tier
        self._mesh_arg = mesh
        self._set_device(
            select_device(settings) if mesh is None else mesh.devices.flat[0]
        )
        self.stats = FrameStats()
        self._build_settings_dependent(scene, settings)

    def _set_device(self, device):
        # compiled kernels on a GPU, interpret mode on the CPU, else an error
        self.interpret = backend.interpret_mode(device)
        backend.check_exact_backend(device)
        if not self.interpret:
            backend.enable_compile_cache()
        self.device = device

    # ----- settings-dependent world -------------------------------------
    def _build_settings_dependent(self, scene: Scene, settings: RendererSettings):
        self.scene = scene
        self.settings = settings
        # multi-device: resolve the device mesh (explicit Renderer(mesh=...)
        # wins; else settings.n_devices slices jax.devices())
        self.mesh = self._mesh_arg
        if self.mesh is None and settings.n_devices is not None:
            from .parallel import make_render_mesh

            devs = jax.devices()
            if len(devs) < settings.n_devices:
                raise ValueError(
                    f"n_devices={settings.n_devices} but only {len(devs)} "
                    "jax devices exist"
                )
            self.mesh = make_render_mesh(devs[: settings.n_devices])
        packed = scene.pack()
        self.packed = packed
        if self.mesh is not None:
            # replicate scene buffers across the mesh so the sharded frame
            # jit never sees single-device-committed inputs
            from jax.sharding import NamedSharding, PartitionSpec

            repl = NamedSharding(self.mesh, PartitionSpec())
            put = lambda a: jax.device_put(jnp.asarray(a), repl)
        else:
            dev = self.device
            put = lambda a: jax.device_put(jnp.asarray(a), dev)
        self._buffers = dict(
            positions=put(packed.positions),
            vert_obj=put(packed.vert_obj),
            normals=put(packed.normals),
            colors=put(packed.colors),
            uvs=put(packed.uvs),
            tri_v=put(packed.tri_v),
            tri_obj=put(packed.tri_obj),
            obj_material=put(packed.obj_material),
            # static per scene: per-triangle material ids precomputed on the
            # host instead of gathered every frame
            tri_mat=put(
                packed.obj_material[
                    np.clip(packed.tri_obj, 0, len(packed.obj_material) - 1)
                ]
            ),
        )
        self.materials = MaterialsPack(
            base_color=put(
                np.array([m.base_color for m in scene.materials], F32)
            ),
            tex_id=put(
                np.array([m.texture_id for m in scene.materials], np.int32)
            ),
            specular=put(np.array([m.specular for m in scene.materials], F32)),
            shininess=put(
                np.array([m.shininess for m in scene.materials], np.int32)
            ),
        )
        self.atlas = None
        if scene.atlas is not None:
            self.atlas = jax.tree.map(put, scene.atlas)
        self.light = None
        if scene.light is not None:
            self.light = LightPack(
                direction=put(np.asarray(scene.light.direction, F32)),
                color=put(np.asarray(scene.light.color, F32)),
                ambient=put(np.asarray(scene.light.ambient, F32)),
            )
        self._build_resize_dependent()

    # ----- resize-dependent tier ----------------------------------------
    def _build_resize_dependent(self):
        st = self.settings
        # Scene-adaptive pair budget: binning's fixed-shape passes scale with
        # the static budget, so cap it by triangle count (8x headroom, floor
        # 16k) instead of paying the worst-case budget on small scenes.
        # settings.max_pairs remains the explicit ceiling; overflow is
        # counted in aux/pairs_overflow and surfaced by the debug validator.
        t = self.packed.tri_v.shape[0]
        eff_pairs = min(
            st.max_pairs, max(1 << 14, -(-8 * t // 128) * 128)
        )
        if eff_pairs != st.max_pairs:
            st = dataclasses.replace(st, max_pairs=eff_pairs)
        self.cfg = derive_raster_config(st.render_width, st.render_height)
        self.statics = FrameStatics(
            cfg=self.cfg,
            settings=st,
            has_materials=True,
            has_atlas=self.atlas is not None,
            has_light=self.light is not None,
            interpret=self.interpret,
        )
        self._sharded_fn = None
        if self.mesh is not None:
            # any resolution works on any device count: the sharded path
            # pads the tile-row decomposition up and crops (sharding.py),
            # so resize (incl. the in-draw self-recovery) never hard-fails
            from .parallel import render_frame_sharded

            self._sharded_fn = jax.jit(
                functools.partial(render_frame_sharded, self.statics, self.mesh)
            )
        self.ring = FrameRing(st.frames_in_flight)

    # ----- public API ----------------------------------------------------
    def update_settings(self, settings: RendererSettings, scene: Scene = None):
        """Rebuild the whole settings-dependent world
        (update_user_settings analogue, renderer.rs:624-627) — including
        re-selecting the device when the preference changed (the reference's
        switch-GPU path re-creates the logical device on the new adapter)."""
        self.ring.drain()
        if settings.preferred_device_index != self.settings.preferred_device_index:
            self._set_device(select_device(settings))
        self._build_settings_dependent(scene or self.scene, settings)

    def resize(self, width: int, height: int):
        """Swapchain-invalidation path: rebuild resolution-keyed state
        (renderer.rs:601-620)."""
        self.ring.drain()
        self.settings = dataclasses.replace(
            self.settings, width=width, height=height
        )
        self._build_resize_dependent()

    def update_mesh(self, mesh_index: int, mesh):
        """Re-upload geometry after a mesh edit (update_vertices analogue,
        vertex_buffer_components.rs:71-87)."""
        self.scene.meshes[mesh_index] = mesh
        self.update_settings(self.settings, self.scene)

    def warmup(self, parallel: bool = True, execute: bool = True,
               verbose: bool = False) -> float:
        """Warm every pipeline stage for the current configuration by
        CALLING the real per-stage jits with dummy device inputs, in
        parallel threads, then running one real frame.

        Why calls and not AOT: ``.lower().compile()`` populates only the
        persistent compilation cache — the jit CALL cache is keyed by real
        calls, so the first frame after an AOT warmup would trace and load
        every stage again.  A dummy call through each stage jit warms trace
        + compile + load in ONE pass on the exact call path real frames
        use; running the stage calls in threads overlaps their compiles.
        Dummy inputs are zeros (empty runs / identity matrices), so the
        device work per stage is one steady-state execution.  Single-program
        paths (multi-device, unstaged) simply run one real frame.  Returns
        seconds spent."""
        import concurrent.futures
        import time as _time

        from . import pipeline as plmod
        from .camera import Camera as _Cam
        from .ops import raster_pallas

        t0 = _time.perf_counter()

        def say(msg):
            if verbose:
                import sys as _sys

                print(f"warmup: {msg} [{_time.perf_counter()-t0:.1f}s]",
                      file=_sys.stderr, flush=True)

        def finish_real_frame():
            # one real frame through the exact render_frame path: absorbs
            # anything the dummy calls missed (host-side matrix composition,
            # the aux pytree, present-path conversions)
            if execute:
                rgba8, _ = self.render_frame(_Cam())
                jax.block_until_ready(rgba8)
                say("real frame done")
            return _time.perf_counter() - t0

        stt = self.statics.settings  # resize tier may have capped max_pairs
        if self._sharded_fn is not None or not stt.staged_pipeline:
            return finish_real_frame()

        b = self._buffers
        cfg = self.cfg
        interpret = self.statics.interpret

        def zdev(sd):
            return jax.device_put(jnp.zeros(sd.shape, sd.dtype), self.device)

        o = self.scene.model_matrices().shape[0]
        # identity matrices: finite w everywhere, geometry mostly culled —
        # a cheap but semantically well-formed frame for the front stages
        eye = jnp.asarray(np.broadcast_to(np.eye(4, dtype=F32), (o, 4, 4)))
        cam0 = jnp.asarray(np.zeros(3, F32))
        absd = lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype)
        geo_arrs = (
            b["positions"], b["vert_obj"], b["normals"], b["colors"],
            b["uvs"], b["tri_v"], b["tri_obj"], b["obj_material"], eye, eye,
        )
        su, attrs_full, _ = jax.eval_shape(
            functools.partial(
                plmod._stage_geometry.__wrapped__, cfg, stt.clip_budget
            ),
            *jax.tree.map(absd, geo_arrs),
            tri_mat=absd(b["tri_mat"]),
        )
        records, tstart, tcount, _ = jax.eval_shape(
            functools.partial(
                plmod._stage_binning.__wrapped__, cfg, stt.max_pairs
            ),
            su,
        )
        vis_d, vis_t = jax.eval_shape(
            functools.partial(
                raster_pallas.rasterize_visibility.__wrapped__,
                cfg=cfg, interpret=interpret,
            ),
            records, tstart, tcount,
        )
        su_z = jax.tree.map(zdev, su)
        attrs_z = jax.tree.map(zdev, attrs_full)
        calls = [
            lambda: plmod._stage_geometry(
                cfg, stt.clip_budget, *geo_arrs, tri_mat=b["tri_mat"]
            ),
            lambda: plmod._stage_binning(cfg, stt.max_pairs, su_z),
            lambda: raster_pallas.rasterize_visibility(
                zdev(records), zdev(tstart), zdev(tcount), cfg,
                interpret=interpret,
            ),
            lambda: plmod._stage_shade(
                self.statics, zdev(vis_t), su_z, attrs_z, cam0,
                self.materials, self.atlas, self.light,
            ),
        ]
        say(f"{len(calls)} stage calls built")

        def run_stage(i_fn):
            i, fn = i_fn
            jax.block_until_ready(fn())
            say(f"stage {i} warm")

        if parallel:
            with concurrent.futures.ThreadPoolExecutor(
                max_workers=len(calls)
            ) as ex:
                list(ex.map(run_stage, enumerate(calls)))
        else:
            for item in enumerate(calls):
                run_stage(item)
        return finish_real_frame()

    def render_frame(self, camera: Camera, model_mats: np.ndarray = None):
        """Render one frame; returns (device rgba8, aux).  Async: does not
        block on device completion."""
        t0 = time.perf_counter()
        st = self.settings
        if model_mats is None:
            model_mats = self.scene.model_matrices()
        view = camera.view_matrix()
        proj = camera.projection_matrix(st.render_width / st.render_height)
        mvp = compose_mvp(model_mats, view, proj)
        b = self._buffers
        args = (
            b["positions"], b["vert_obj"], b["normals"], b["colors"],
            b["uvs"], b["tri_v"], b["tri_obj"], b["obj_material"],
            jnp.asarray(model_mats), jnp.asarray(mvp),
            jnp.asarray(camera.position.astype(F32)),
            self.materials, self.atlas, self.light,
        )
        if self._sharded_fn is not None:
            rgba8, aux = self._sharded_fn(*args)
        elif self.statics.settings.staged_pipeline:
            rgba8, aux = render_frame_staged(
                self.statics, *args, tri_mat=b["tri_mat"]
            )
        else:
            rgba8, aux = render_frame_jit(
                self.statics, *args, tri_mat=b["tri_mat"]
            )
        self.stats.record_dispatch(time.perf_counter() - t0)
        return rgba8, aux

    def draw_frame(self, camera: Camera, model_mats=None, on_present=None,
                   extent=None):
        """Frame-loop step: render + submit to the present ring.  Returns the
        host RGBA8 of a frame completed frames_in_flight ago (or None).

        extent: the present target's current (width, height), when the
        caller has one (App passes its window extent).  If it no longer
        matches the built framebuffers, the renderer rebuilds its
        resize-dependent tier HERE, without caller help — the reference's
        in-draw OUT_OF_DATE/SUBOPTIMAL swapchain recovery
        (renderer.rs:416-428, 587-596)."""
        t0 = time.perf_counter()
        if extent is not None and tuple(extent) != (
            self.settings.width,
            self.settings.height,
        ):
            self.resize(*extent)
        rgba8, aux = self.render_frame(camera, model_mats)
        presented = self.ring.push(rgba8, on_present)
        self.stats.record_frame(time.perf_counter() - t0, aux)
        return presented

    def finish(self):
        """Drain in-flight frames (device_wait_idle analogue)."""
        return self.ring.drain()

    def read_frame(self, rgba8) -> np.ndarray:
        """Blocking readback of one frame."""
        return np.asarray(jax.device_get(rgba8))
