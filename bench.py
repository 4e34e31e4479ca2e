#!/usr/bin/env python
"""Headline benchmark: frames/sec at 1920x1080 on a 1M-triangle textured,
lit scene (BASELINE config 4), plus a pixel-parity gate vs the CPU oracle.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"} where
vs_baseline is value / 60 FPS (the BASELINE.json north-star target; the
reference itself publishes no numbers — see BASELINE.md).

Usage: python bench.py [--config N] [--frames N] [--small]
Extra diagnostics go to stderr; stdout carries only the JSON line.  Needs an
NVIDIA GPU: on any other device it fails instead of falling back.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def parity_gate() -> bool:
    """Small-scene pixel parity vs the CPU oracle on the live backend."""
    from ash_renderer import exactness

    ok = exactness.parity_gate()
    log(f"parity gate (256x192, 160 tris): {'EXACT' if ok else 'MISMATCH'}")
    return ok


def headline_hash_gate(rgba8, subdiv: int, config: str) -> bool | None:
    """Scale-exactness gate: the device headline frame must byte-equal the
    offline numpy-oracle render (docs/golden/headline_*.json, written by
    experiments/oracle_headline.py) — both the 1.31M-tri sphere and the
    1.0M-tri terrain have goldens.  Returns None when no golden matches
    (non-headline subdiv), else pass/fail."""
    import hashlib

    root = os.path.dirname(os.path.abspath(__file__))
    if config == "config4_terrain":
        name = "headline_terrain.json"
    elif config == "config5_flythrough":
        name = "headline_config5.json"
    elif subdiv == 8:
        name = "headline_config4.json"
    else:
        name = f"headline_config4_s{subdiv}.json"
    path = os.path.join(root, "docs", "golden", name)
    if not os.path.exists(path):
        log(f"headline hash gate: no golden for subdiv={subdiv}, skipped")
        return None
    with open(path) as f:
        golden = json.load(f)
    frame = np.asarray(rgba8)
    digest = hashlib.sha256(frame.tobytes()).hexdigest()
    ok = digest == golden["sha256"]
    log(
        f"headline hash gate ({frame.shape[1]}x{frame.shape[0]}, "
        f"{golden['n_tris']} tris): {'EXACT' if ok else 'MISMATCH'}"
    )
    if not ok:
        npz = path.replace(".json", "_rgba8.npz")
        if os.path.exists(npz):
            ref = np.load(npz)["rgba8"]
            if ref.shape == frame.shape:
                bad = int((ref != frame).any(axis=-1).sum())
                log(f"  differing pixels: {bad} / {frame.shape[0]*frame.shape[1]}")
    return ok


def flyby_path(n_frames: int):
    """Camera path that grazes the headline sphere (center [0,0,2], r=1):
    a straight fly-by at impact parameter 1.02 looking along +Z, so frames
    near closest approach have surface geometry crossing the near plane —
    the clip-tail branch runs for real (the static headline camera never
    takes it)."""
    from ash_renderer import Camera

    cams = []
    for i in range(n_frames):
        z = -1.0 + 6.0 * i / max(n_frames - 1, 1)
        cams.append(
            Camera(position=np.array([1.02, 0.0, z], np.float32))
        )
    return cams


def require_gpu():
    """The benchmark measures the GPU or nothing."""
    import ash_renderer  # noqa: F401  (XLA flags before JAX starts)
    import jax

    from ash_renderer import backend

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs an NVIDIA GPU; found {dev.platform!r}")
    backend.enable_compile_cache()
    log(f"device: {dev.device_kind} x{len(jax.devices())}")
    return dev


def sweep(args):
    """All benchmark configs, one process: per-config cold start (first
    frame, compile included) and steady-state FPS, ending with the headline
    JSON."""
    import time as _time

    import jax

    from ash_renderer.benchmarks import ALL_CONFIGS
    from ash_renderer.renderer import Renderer

    require_gpu()
    force = jax.block_until_ready
    results = {}
    headline = None
    for name, builder in ALL_CONFIGS.items():
        t0 = _time.time()
        scene, settings, cams = builder()
        r = Renderer(scene, settings)
        t1 = _time.time()
        rgba8, aux = r.render_frame(cams[0])
        force(rgba8)
        first = _time.time() - t1
        nf = args.frames
        t1 = _time.time()
        for i in range(nf):
            rgba8, aux = r.render_frame(cams[i % len(cams)])
        force(rgba8)
        fps = nf / (_time.time() - t1)
        results[name] = fps
        if name == "config4_million_tri":
            headline = (fps, settings, scene)
        log(
            f"{name:22s} {fps:7.2f} FPS  "
            f"first-frame {first:5.2f}s "
            f"(total cold {_time.time()-t0:5.1f}s)"
        )
        del r
    fps, settings, scene = headline
    n_tris = sum(m.num_triangles for m in scene.meshes)
    print(json.dumps({
        "metric": (
            f"frames/sec at {settings.width}x{settings.height} on "
            f"config4_million_tri ({n_tris} tris) [sweep]"
        ),
        "value": round(fps, 3),
        "unit": "fps",
        "vs_baseline": round(fps / 60.0, 4),
    }))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=50)
    ap.add_argument("--config", default="config4_million_tri",
                    help="benchmark config name (see ash_renderer."
                         "benchmarks.ALL_CONFIGS)")
    ap.add_argument("--subdiv", type=int, default=8,
                    help="icosphere subdivisions (20*4^s triangles)")
    ap.add_argument("--small", action="store_true",
                    help="reduced scene for smoke testing")
    ap.add_argument("--skip-parity", action="store_true")
    ap.add_argument("--sweep", action="store_true",
                    help="run EVERY benchmark config in this one process "
                         "(shared compilations) and print a summary table; "
                         "the final JSON line still reports the headline")
    args = ap.parse_args()

    if args.sweep:
        return sweep(args)

    import jax

    from ash_renderer.benchmarks import ALL_CONFIGS, config4_million_tri
    from ash_renderer.renderer import Renderer

    require_gpu()
    force = jax.block_until_ready

    parity_ok = True
    if not args.skip_parity:
        try:
            parity_ok = parity_gate()
        except Exception as e:  # pragma: no cover
            log(f"parity gate error: {e!r}")
            parity_ok = False

    t0 = time.time()
    if args.config == "config4_million_tri":
        n = 4 if args.small else args.subdiv
        scene, settings, cams = config4_million_tri(subdiv=n)
    else:
        scene, settings, cams = ALL_CONFIGS[args.config]()
    n_tris = sum(m.num_triangles for m in scene.meshes)
    log(f"scene: {n_tris} triangles (built in {time.time()-t0:.1f}s)")

    r = Renderer(scene, settings)
    cam = cams[0]

    t0 = time.time()
    rgba8, aux = r.render_frame(cam)
    force(rgba8)
    log(f"first frame (incl. compile): {time.time()-t0:.1f}s")
    log(
        f"valid tris: {int(aux['n_valid'])},"
        f" pairs: {int(aux['pairs_total'])},"
        f" overflow: {int(aux['pairs_overflow'])},"
        f" covered px: {int((np.asarray(aux['vis_tri']) >= 0).sum())}"
    )

    # scale-exactness gate: headline frame vs the offline oracle render
    hash_ok = True
    if (
        args.config
        in ("config4_million_tri", "config4_terrain", "config5_flythrough")
        and not args.small
    ):
        res = headline_hash_gate(rgba8, args.subdiv, args.config)
        hash_ok = res is not False
        try:  # keep the gallery's headline render current
            from PIL import Image

            gal = os.path.join(
                os.path.dirname(os.path.abspath(__file__)),
                "docs", "gallery", f"{args.config}.png",
            )
            Image.fromarray(np.asarray(rgba8)).save(gal)
            log(f"gallery render saved: {gal}")
        except Exception as e:  # PIL absent / fs read-only: non-fatal
            log(f"gallery save skipped: {e!r}")

    # steady-state timing (static camera)
    nf = args.frames
    t0 = time.time()
    for _ in range(nf):
        rgba8, aux = r.render_frame(cam)
    force(rgba8)
    dt = (time.time() - t0) / nf
    fps = 1.0 / dt
    log(f"steady state: {dt*1000:.1f} ms/frame = {fps:.2f} FPS")

    # moving-camera steady state: a fly-by grazing the scene, so clip-active
    # frames pay their real cost (the static camera never takes the
    # clip-tail branch); same compiled executable, no re-trace
    orbit_fps = None
    orbit_const_fps = None
    if args.config == "config4_million_tri" and not args.small:
        fcams = flyby_path(24)
        r.render_frame(fcams[0])  # clip-branch not a new compile, but warm it
        per = []  # per-frame counters (device scalars, read after the loop)
        t0 = time.time()
        for fc in fcams:
            rgba8_m, aux_m = r.render_frame(fc)
            per.append({
                k: aux_m[k]
                for k in ("n_clipped", "pairs_total", "pairs_overflow")
            })
        force(rgba8_m)
        mdt = (time.time() - t0) / len(fcams)
        orbit_fps = 1.0 / mdt
        per = [{k: int(np.asarray(v)) for k, v in d.items()} for d in per]
        ncl = [d["n_clipped"] for d in per]
        log(
            f"moving camera (fly-by): {mdt*1000:.1f} ms/frame = "
            f"{orbit_fps:.2f} FPS; clipped tris/frame min={min(ncl)} "
            f"max={max(ncl)} (frames with clips: "
            f"{sum(1 for c in ncl if c > 0)}/{len(ncl)}); pairs/frame "
            f"max={max(d['pairs_total'] for d in per)} of "
            f"{r.statics.settings.max_pairs}, overflow "
            f"max={max(d['pairs_overflow'] for d in per)}"
        )
        # coverage-CONSTANT moving camera: an orbit at the static pose's
        # radius keeping the sphere frame-filling on every frame (frame 0
        # IS the static pose), so this number cannot hide a motion-
        # dependent regression behind coverage loss the way the grazing
        # fly-by can (every fly-by frame near closest approach covers
        # fewer pixels than the static pose — DESIGN.md counter analysis)
        from ash_renderer.camera import orbit_path as _orbit

        ocams = _orbit(24, radius=2.0, center=np.array([0, 0, 2.0]))
        r.render_frame(ocams[1])  # absorb any first-call overhead
        t0 = time.time()
        for oc in ocams:
            rgba8_o, _ = r.render_frame(oc)
        force(rgba8_o)
        odt = (time.time() - t0) / len(ocams)
        orbit_const_fps = 1.0 / odt
        log(
            f"moving camera (orbit, coverage-constant): {odt*1000:.1f} "
            f"ms/frame = {orbit_const_fps:.2f} FPS"
        )

        # a static frame rendered AFTER the moving sequences must still
        # byte-equal the golden
        rgba8_s, _ = r.render_frame(cam)
        res2 = headline_hash_gate(rgba8_s, args.subdiv, args.config)
        if res2 is not None:
            hash_ok = hash_ok and res2
            log(f"post-motion static re-gate: {'EXACT' if res2 else 'MISMATCH'}")

    value = round(fps, 3)
    flags = ("" if parity_ok else " [PARITY GATE FAILED]") + (
        "" if hash_ok else " [HEADLINE HASH MISMATCH]"
    )
    result = {
        "metric": (
            f"frames/sec at {settings.width}x{settings.height} on "
            f"{args.config} ({n_tris} tris)" + flags
        ),
        "value": value,
        "unit": "fps",
        "vs_baseline": round(value / 60.0, 4),
    }
    if orbit_fps is not None:
        result["moving_camera_fps"] = round(orbit_fps, 3)
    if orbit_const_fps is not None:
        result["orbit_camera_fps"] = round(orbit_const_fps, 3)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
