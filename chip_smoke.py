#!/usr/bin/env python
"""Smoke test of the renderer on one NVIDIA GPU, through its user entry
points (``Renderer``, ``App``), checked bit for bit.

Phases, in one process; the first failure exits non-zero:

  (a) the device must be a GPU (no CPU fallback); prints the card;
  (b) exactness on the card: the specmath canary chains and the 256x192
      parity gate (ash_renderer.exactness, the ``gpu`` tests' checks);
  (c) the visibility kernel at 1920x1080: the 20k-triangle sphere frame
      against its stored golden, and a few-thousand-triangle scene's
      (vis_d16, vis_tri) against the live numpy oracle;
  (d) the full-width main path: the 1.31M-triangle sphere (static + orbit
      frames), the 1.0M-triangle terrain and config5's first fly-through
      frame (through App), each against its stored golden sha256 with zero
      pair and clip overflow; prints first-frame time (compile included),
      steady ms/frame and peak device memory.

``--devices 4`` runs only the sharded path instead: the 1.31M-triangle
frame over four GPUs, bitwise against the single-GPU frame and the golden.

The last line of stdout is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
Usage: python chip_smoke.py [--devices 4]
"""

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)


def log(*a):
    print(*a, flush=True)


def fail(msg):
    log(f"FAIL: {msg}")
    sys.exit(1)


def check(ok, what):
    log(f"{what}: {'EXACT' if ok else 'MISMATCH'}")
    if not ok:
        fail(what)


def golden_sha(name):
    with open(os.path.join(ROOT, "docs", "golden", name)) as f:
        return json.load(f)["sha256"]


def sha256(frame):
    import numpy as np

    return hashlib.sha256(np.asarray(frame).tobytes()).hexdigest()


def peak_gb(device):
    stats = device.memory_stats() or {}
    return stats.get("peak_bytes_in_use", 0) / 1e9


def check_overflow(aux, what):
    for k in ("pairs_overflow", "clip_overflow"):
        if int(aux[k]) != 0:
            fail(f"{what}: {k} = {int(aux[k])}")


def timed_frames(r, cams, n):
    """Steady ms/frame over n frames cycling through cams."""
    import jax

    t0 = time.perf_counter()
    for i in range(n):
        rgba8, _ = r.render_frame(cams[i % len(cams)])
    jax.block_until_ready(rgba8)
    return (time.perf_counter() - t0) / n * 1000


def phase_exactness(device):
    from ash_renderer import exactness

    for name in exactness.CHAINS:
        mism = exactness.chain_mismatches(name, device=device)
        check(mism == 0, f"canary {name} ({mism} bits differ)")
    check(exactness.parity_gate(device), "parity gate 256x192, 160 tris")


def phase_kernel_1080p(device):
    import numpy as np
    import jax

    from ash_renderer import Camera, Renderer, RendererSettings
    from ash_renderer.benchmarks import config4_million_tri
    from ash_renderer.models import tri_soup
    from ash_renderer.oracle import render_oracle
    from ash_renderer.scene import Scene, SceneObject

    scene, settings, cams = config4_million_tri(subdiv=5)
    r = Renderer(scene, settings)
    rgba8, aux = r.render_frame(cams[0])
    check_overflow(aux, "headline_config4_s5")
    check(sha256(rgba8) == golden_sha("headline_config4_s5.json"),
          "headline_config4_s5 (20480 tris, 1920x1080)")

    soup = Scene()
    soup.add_object(SceneObject(mesh=soup.add_mesh(tri_soup(4000, seed=3))))
    st = RendererSettings(width=1920, height=1080)
    r = Renderer(soup, st)
    cam = Camera()
    _, aux = r.render_frame(cam)
    o = render_oracle(
        soup.pack(), soup.model_matrices(), cam.view_matrix(),
        cam.projection_matrix(st.width / st.height), st,
        materials=jax.tree.map(np.asarray, r.materials), cfg=r.cfg,
    )
    check(
        np.array_equal(np.asarray(aux["vis_tri"]), o["vis_tri"])
        and np.array_equal(np.asarray(aux["vis_d16"]), o["vis_d16"]),
        "visibility 1920x1080, 4000-tri soup vs live oracle",
    )


def phase_main_path(device):
    import numpy as np
    import jax

    from ash_renderer import App, Renderer
    from ash_renderer.benchmarks import (
        config4_million_tri,
        config4_terrain,
        config5_flythrough,
    )
    from ash_renderer.camera import orbit_path
    from ash_renderer.present import FrameCollector

    def headline(name, builder, golden, orbit=False):
        t0 = time.perf_counter()
        scene, settings, cams = builder()
        r = Renderer(scene, settings)
        t1 = time.perf_counter()
        rgba8, aux = r.render_frame(cams[0])
        jax.block_until_ready(rgba8)
        first = time.perf_counter() - t1
        check_overflow(aux, name)
        check(sha256(rgba8) == golden_sha(golden), f"{name} static frame")
        ms = timed_frames(r, cams[:1], 10)
        check(sha256(r.render_frame(cams[0])[0]) == golden_sha(golden),
              f"{name} static frame, again")
        line = (f"{name}: {aux['n_valid']} valid tris, {aux['pairs_total']} "
                f"pairs; set-up {t1 - t0:.2f} s, first frame (compile "
                f"included) {first:.2f} s, steady {ms:.3f} ms/frame")
        if orbit:
            ocams = orbit_path(8, radius=2.0, center=np.array([0, 0, 2.0]))
            for oc in ocams:  # every orbit frame within budget
                _, oaux = r.render_frame(oc)
                check_overflow(oaux, f"{name} orbit")
            line += f", orbit {timed_frames(r, ocams, 16):.3f} ms/frame"
        log(line)
        log(f"{name}: peak device memory {peak_gb(device):.3f} GB")

    headline("headline_config4", config4_million_tri, "headline_config4.json",
             orbit=True)
    headline("headline_terrain", config4_terrain, "headline_terrain.json")

    # config5 through App: the frame loop, present ring and host readback
    scene, settings, cams = config5_flythrough()
    t0 = time.perf_counter()
    app = App(scene, settings)
    t1 = time.perf_counter()
    frames = FrameCollector()
    app.run_path(cams[:4], on_present=frames)
    t2 = time.perf_counter()
    check_overflow(app.renderer.render_frame(cams[0])[1], "headline_config5")
    check(sha256(frames.frames[0]) == golden_sha("headline_config5.json"),
          "headline_config5 frame 0 (through App)")
    ms = timed_frames(app.renderer, cams, 16)
    log(f"headline_config5: App start-up with warmup (compile included) "
        f"{t1 - t0:.2f} s, 4 presented frames {t2 - t1:.2f} s, fly-through "
        f"{ms:.3f} ms/frame; peak device memory {peak_gb(device):.3f} GB")


def phase_sharded(n):
    import dataclasses

    import jax

    from ash_renderer import Renderer
    from ash_renderer.benchmarks import config4_million_tri

    scene, settings, cams = config4_million_tri()
    r = Renderer(scene, dataclasses.replace(settings, n_devices=n))
    t0 = time.perf_counter()
    multi, aux = r.render_frame(cams[0])
    jax.block_until_ready(multi)
    first = time.perf_counter() - t0
    check_overflow(aux, "sharded headline_config4")
    held = {s.device for s in multi.addressable_shards if s.data.size}
    log(f"sharded frame held by {len(held)} devices: "
        f"{sorted(d.id for d in held)}")
    if len(held) != n:
        fail(f"{len(held)} of {n} devices hold slabs")
    single, _ = Renderer(scene, settings).render_frame(cams[0])
    check(sha256(multi) == sha256(single),
          f"sharded over {n} GPUs vs single GPU, 1920x1080, 1.31M tris")
    check(sha256(multi) == golden_sha("headline_config4.json"),
          "sharded headline_config4 vs golden")
    log(f"sharded first frame (compile included) {first:.2f} s, steady "
        f"{timed_frames(r, cams, 10):.3f} ms/frame")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=1,
                    help="4: run only the sharded path over four GPUs")
    args = ap.parse_args()

    import ash_renderer  # noqa: F401  (XLA flags before JAX starts)
    import jax

    from ash_renderer import backend

    # (a) a GPU, or nothing
    try:
        devices = jax.devices()
    except RuntimeError as e:
        fail(f"no JAX backend: {e}")
    dev = devices[0]
    if dev.platform != "gpu":
        fail(f"needs an NVIDIA GPU; JAX found {dev.platform!r}")
    backend.enable_compile_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    log(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
        else "nvidia-smi: no output")
    log(f"device_kind: {dev.device_kind}; {len(devices)} device(s)")

    t0 = time.perf_counter()
    if args.devices > 1:
        if len(devices) < args.devices:
            fail(f"--devices {args.devices} but {len(devices)} GPUs")
        phase_sharded(args.devices)
        count = args.devices
    else:
        phase_exactness(dev)
        phase_kernel_1080p(dev)
        phase_main_path(dev)
        count = 1
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({
        "ok": True,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": count},
    }), flush=True)


if __name__ == "__main__":
    main()
