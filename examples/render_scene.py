#!/usr/bin/env python
"""Render a benchmark scene (or your own OBJ/glTF) to PNG frames.

  python examples/render_scene.py config3_blinn_phong --out /tmp/frames
  python examples/render_scene.py path/to/model.gltf --frames 16
"""

import sys
import os

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from ash_renderer.app import main

if __name__ == "__main__":
    main(sys.argv[1:] or ["config3_blinn_phong", "--out", "/tmp/frames"])
