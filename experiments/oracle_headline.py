"""Render the headline frame (config4_million_tri) through the numpy oracle
and pin its hash: the scale-exactness gate for bench.py (VERDICT r2 item 2).

The small parity gate is 160 tris at 256x192; this renders the exact frame
bench.py and chip_smoke.py measure — same meshlet-packed buffers (triangle
ids/draw order are part of the tie-break semantics), same subpixel precision
(the tile shape matters only through derive_raster_config's subpixel_bits,
4 at these sizes), same materials/atlas/light/camera bits — through
oracle.raster_cpu ONCE offline, and stores the sha256 + a preview PNG under
docs/golden/.

Usage: python experiments/oracle_headline.py [--subdiv N] [--out PATH]
                                             [--config NAME]
--config config4_terrain renders the terrain headline variant instead
(its own golden: docs/golden/headline_terrain.json, gating
bench.py --config config4_terrain); --config config5_flythrough pins frame 0
of the 4xSSAA textured fly-through (docs/golden/headline_config5.json) —
the purest shade-bound config (seconds of numpy; subdiv=8, 1.31M tris:
hours of single-core numpy — run detached).
"""

import argparse
import hashlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np

F32 = np.float32


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--subdiv", type=int, default=8)
    ap.add_argument("--out", default=None,
                    help="output JSON path (default docs/golden/"
                         "headline_config4.json for subdiv=8)")
    ap.add_argument("--config", default="config4_million_tri",
                    choices=["config4_million_tri", "config4_terrain",
                             "config5_flythrough"])
    args = ap.parse_args()

    from ash_renderer.benchmarks import (
        config4_million_tri,
        config4_terrain,
        config5_flythrough,
    )
    from ash_renderer.config import derive_raster_config
    from ash_renderer.oracle.raster_cpu import compose_mvp, render_oracle
    from ash_renderer.rtypes import LightPack, MaterialsPack

    t0 = time.time()
    if args.config == "config4_terrain":
        scene, settings, cams = config4_terrain()
    elif args.config == "config5_flythrough":
        scene, settings, cams = config5_flythrough()
    else:
        scene, settings, cams = config4_million_tri(subdiv=args.subdiv)
    cam = cams[0]
    # EXACTLY the Renderer's world: meshlet packing (triangle order feeds
    # the (d16, -tri_id) tie-break) and its RasterConfig
    packed = scene.pack()
    cfg = derive_raster_config(settings.render_width, settings.render_height)
    model_mats = scene.model_matrices()
    view = cam.view_matrix()
    proj = cam.projection_matrix(settings.render_width / settings.render_height)
    materials = MaterialsPack(
        base_color=np.array([m.base_color for m in scene.materials], F32),
        tex_id=np.array([m.texture_id for m in scene.materials], np.int32),
        specular=np.array([m.specular for m in scene.materials], F32),
        shininess=np.array([m.shininess for m in scene.materials], np.int32),
    )
    light = None
    if scene.light is not None:
        light = LightPack(
            direction=np.asarray(scene.light.direction, F32),
            color=np.asarray(scene.light.color, F32),
            ambient=np.float32(scene.light.ambient),
        )
    n_tris = int((packed.tri_v[:, 0] >= 0).sum())
    print(f"scene packed: {n_tris} real tris, cfg={cfg}", flush=True)
    print(f"[{time.time()-t0:.0f}s] starting oracle render", flush=True)

    o = render_oracle(
        packed, model_mats, view, proj, settings,
        materials=materials, atlas=scene.atlas, light=light,
        camera_pos=cam.position.astype(F32), cfg=cfg,
    )
    rgba8 = np.asarray(o["rgba8"])
    covered = int((o["vis_tri"] >= 0).sum())
    digest = hashlib.sha256(rgba8.tobytes()).hexdigest()
    print(
        f"[{time.time()-t0:.0f}s] oracle done: shape={rgba8.shape} "
        f"covered_px={covered} sha256={digest}",
        flush=True,
    )

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
    outdir = os.path.join(root, "docs", "golden")
    os.makedirs(outdir, exist_ok=True)
    if args.config == "config4_terrain":
        default_name = "headline_terrain.json"
    elif args.config == "config5_flythrough":
        default_name = "headline_config5.json"
    elif args.subdiv == 8:
        default_name = "headline_config4.json"
    else:
        default_name = f"headline_config4_s{args.subdiv}.json"
    out = args.out or os.path.join(outdir, default_name)
    meta = {
        "config": args.config,
        "subdiv": args.subdiv,
        "n_tris": n_tris,
        "width": int(rgba8.shape[1]),
        "height": int(rgba8.shape[0]),
        "covered_px": covered,
        "sha256": digest,
        "pack": "meshlets",
        "subpixel_bits": cfg.subpixel_bits,
    }
    with open(out, "w") as f:
        json.dump(meta, f, indent=1)
    # full frame (for byte-diff debugging) + preview PNG
    np.savez_compressed(out.replace(".json", "_rgba8.npz"), rgba8=rgba8)
    try:
        from ash_renderer.native import write_png

        write_png(
            os.path.join(outdir, os.path.basename(out).replace(".json", ".png")),
            rgba8[::4, ::4],
        )
    except Exception as e:
        print(f"png preview skipped: {e!r}", flush=True)
    print(f"wrote {out}", flush=True)


if __name__ == "__main__":
    main()
