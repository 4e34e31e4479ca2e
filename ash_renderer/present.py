"""Present layer: framebuffer ring + async device->host readback + image sinks.

The reference presents via a Vulkan swapchain with acquire/present semaphores
(``src/renderer/resize_dependent_components/swapchain_components.rs``,
``renderer.rs:570-585``).  The equivalent here: rendering is async-dispatched,
frames are held as device arrays in a small ring (image-count analogue,
min+1 per swapchain_components.rs:35-41), and "present" is a device->host
copy of the RGBA8 framebuffer that only blocks ``frames_in_flight`` frames
later — the fence-wait analogue (renderer.rs:395-404) — so readback overlaps
the next frames' compute.

Sinks: PNG/PPM file writers (PIL when available, pure-Python PPM otherwise)
and an in-memory collector for video/benchmarks.
"""

from __future__ import annotations

import collections
from typing import Callable, Optional

import jax
import numpy as np


class FrameRing:
    """Ring of in-flight frames with deferred blocking readback."""

    def __init__(self, frames_in_flight: int = 2):
        self.frames_in_flight = max(1, frames_in_flight)
        self._ring = collections.deque()

    def push(self, device_frame, on_ready: Optional[Callable] = None):
        """Submit a rendered device frame; returns the oldest frame's host
        array if the ring is full (the blocking 'fence wait'), else None."""
        self._ring.append((device_frame, on_ready))
        if len(self._ring) > self.frames_in_flight:
            return self._pop_ready()
        return None

    def _pop_ready(self):
        frame, cb = self._ring.popleft()
        host = np.asarray(jax.device_get(frame))
        if cb is not None:
            cb(host)
        return host

    def drain(self):
        """Flush all in-flight frames (teardown: the device_wait_idle
        analogue, renderer.rs:602)."""
        out = []
        while self._ring:
            out.append(self._pop_ready())
        return out


def write_ppm(path: str, rgba8: np.ndarray) -> None:
    """Dependency-free PPM (P6) writer; drops alpha."""
    h, w = rgba8.shape[:2]
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(np.ascontiguousarray(rgba8[..., :3]).tobytes())


def write_png(path: str, rgba8: np.ndarray) -> None:
    """PNG via PIL; falls back to PPM (path gets .ppm suffix) without it."""
    try:
        from PIL import Image
    except ImportError:  # pragma: no cover
        write_ppm(path.rsplit(".", 1)[0] + ".ppm", rgba8)
        return
    Image.fromarray(rgba8, mode="RGBA").save(path)


class FrameCollector:
    """Collects presented frames in memory (tests, video assembly)."""

    def __init__(self):
        self.frames: list[np.ndarray] = []

    def __call__(self, frame: np.ndarray) -> None:
        self.frames.append(frame)


class FrameLimiter:
    """Present-mode pacing: the reference prefers MAILBOX (uncapped) and
    falls back to FIFO (vsync-capped) — swapchain_components.rs:60-70.
    "mailbox" returns immediately; "fifo" sleeps to hold refresh_rate."""

    def __init__(self, mode: str = "mailbox", refresh_rate: float = 60.0):
        if mode not in ("mailbox", "fifo"):
            raise ValueError(f"unknown present mode {mode!r}")
        self.mode = mode
        self.period = 1.0 / refresh_rate
        self._last = None

    def pace(self) -> None:
        import time

        if self.mode == "mailbox":
            return
        now = time.perf_counter()
        if self._last is not None:
            wait = self.period - (now - self._last)
            if wait > 0:
                time.sleep(wait)
        self._last = time.perf_counter()


class TerminalViewer:
    """Live preview in a terminal using half-block characters — the
    headless stand-in for the reference's winit window (CPU-blit analogue).
    Each character cell shows two pixels via fg/bg 24-bit color."""

    def __init__(self, max_cols: int = 100, stream=None):
        import sys as _sys

        self.max_cols = max_cols
        self.stream = stream or _sys.stdout
        self._first = True

    def __call__(self, frame: np.ndarray) -> None:
        h, w = frame.shape[:2]
        step = max(1, (w + self.max_cols - 1) // self.max_cols)
        img = frame[:: 2 * step, ::step, :3]
        top = img[0::2]
        bot = img[1::2][: top.shape[0]]
        top = top[: bot.shape[0]]
        lines = []
        for rt, rb in zip(top, bot):
            line = []
            for (tr, tg, tb_), (br, bg, bb) in zip(rt, rb):
                line.append(
                    f"\x1b[38;2;{tr};{tg};{tb_}m\x1b[48;2;{br};{bg};{bb}m▀"
                )
            lines.append("".join(line) + "\x1b[0m")
        out = "\n".join(lines)
        if not self._first:
            self.stream.write(f"\x1b[{len(lines)}F")  # cursor up, redraw
        self._first = False
        self.stream.write(out + "\n")
        self.stream.flush()


class HttpViewer:
    """Pixel-accurate live view over HTTP — the windowless analogue of the
    reference's winit window (renderer.rs:86-88) for headless hosts: point
    a browser at ``http://localhost:<port>/`` to watch the frame loop live.

    Serves:
      /           a minimal page that re-fetches the frame continuously;
      /frame.png  the LATEST presented frame, lossless PNG (exact bytes —
                  unlike the TerminalViewer's downsampled half-blocks);
      /stats      the renderer's FrameStats summary as JSON (when a stats
                  object is attached).

    Runs a daemon ThreadingHTTPServer; ``__call__(frame)`` (the FrameRing
    on_ready signature) swaps in the newest frame — presents never block
    on encoding (PNG is encoded per request, cached by frame id)."""

    def __init__(self, port: int = 8400, stats=None):
        import http.server
        import threading

        self.port = port
        self.stats = stats
        self._frame = None
        self._frame_id = 0
        self._png_cache = (None, b"")
        self._lock = threading.Lock()
        viewer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                if self.path.startswith("/frame.png"):
                    data = viewer._encode_png()
                    if data is None:
                        self.send_error(404, "no frame presented yet")
                        return
                    self.send_response(200)
                    self.send_header("Content-Type", "image/png")
                    self.send_header("Content-Length", str(len(data)))
                    self.send_header("Cache-Control", "no-store")
                    self.end_headers()
                    self.wfile.write(data)
                elif self.path.startswith("/stats"):
                    import json as _json

                    body = _json.dumps(
                        viewer.stats.summary() if viewer.stats else {}
                    ).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    body = (
                        b"<!doctype html><title>ash_renderer</title>"
                        b"<body style='margin:0;background:#111'>"
                        b"<img id=v style='image-rendering:pixelated;"
                        b"width:100vw' src=/frame.png>"
                        b"<script>const v=document.getElementById('v');"
                        b"function n(){const i=new Image();"
                        b"i.onload=()=>{v.src=i.src;requestAnimationFrame(n)};"
                        b"i.onerror=()=>setTimeout(n,250);"
                        b"i.src='/frame.png?'+Date.now()}n()</script>"
                    )
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)

        self._server = http.server.ThreadingHTTPServer(
            ("127.0.0.1", port), Handler
        )
        self.port = self._server.server_address[1]  # resolved when port=0
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )
        self._thread.start()

    def _encode_png(self):
        with self._lock:
            frame, fid = self._frame, self._frame_id
        if frame is None:
            return None
        cid, data = self._png_cache
        if cid == fid:
            return data
        import io

        try:
            from PIL import Image

            buf = io.BytesIO()
            Image.fromarray(frame, mode="RGBA").save(buf, format="PNG")
            data = buf.getvalue()
        except ImportError:  # pragma: no cover
            return None
        self._png_cache = (fid, data)
        return data

    def __call__(self, frame: np.ndarray) -> None:
        with self._lock:
            self._frame = frame
            self._frame_id += 1

    def close(self):
        self._server.shutdown()
        self._server.server_close()


def write_gif(path: str, frames: list, fps: int = 20) -> None:
    """Animated GIF from RGBA8 frames (flythrough videos) via PIL."""
    from PIL import Image

    imgs = [Image.fromarray(f, mode="RGBA").convert("P") for f in frames]
    imgs[0].save(
        path,
        save_all=True,
        append_images=imgs[1:],
        duration=max(1000 // fps, 20),
        loop=0,
    )
