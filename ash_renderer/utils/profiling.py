"""Frame statistics and profiling hooks.

The reference has no timers at all (SURVEY §5: the only observability is the
debug messenger's stdout).  Here: per-frame wall clock, FPS, dispatch time,
pipeline counters (clipped/culled/binned triangles, pair overflow), and
jax.profiler trace capture for per-kernel timing.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np


class FrameStats:
    def __init__(self, window: int = 120):
        self.window = window
        self.frame_times: list[float] = []
        self.dispatch_times: list[float] = []
        self.counters: dict = {}
        self.n_frames = 0

    def record_dispatch(self, dt: float) -> None:
        self.dispatch_times.append(dt)
        del self.dispatch_times[: -self.window]

    def record_frame(self, dt: float, aux=None) -> None:
        self.n_frames += 1
        self.frame_times.append(dt)
        del self.frame_times[: -self.window]
        if aux is not None:
            for k in ("n_valid", "n_clipped", "clip_overflow",
                      "pairs_total", "pairs_overflow"):
                if k in aux:
                    self.counters[k] = aux[k]  # device scalars; read lazily

    @property
    def fps(self) -> float:
        if not self.frame_times:
            return 0.0
        return len(self.frame_times) / max(sum(self.frame_times), 1e-9)

    def summary(self, sync: bool = False) -> dict:
        """Async-safe stats snapshot.  Pipeline counters are device scalars
        still attached to in-flight frames; converting an unready one would
        BLOCK the host on the device pipeline (serializing an App loop that
        displays stats every frame).  By default unready counters are
        reported as None; pass sync=True to block and read them all."""
        out = {
            "frames": self.n_frames,
            "fps_host_loop": round(self.fps, 2),
            "avg_dispatch_ms": round(
                1000 * float(np.mean(self.dispatch_times)), 3
            )
            if self.dispatch_times
            else None,
        }
        for k, v in self.counters.items():
            ready = not hasattr(v, "is_ready") or v.is_ready()
            out[k] = int(v) if (sync or ready) else None
        return out


@contextlib.contextmanager
def trace(path: str):
    """jax.profiler trace capture into ``path`` around a block (stage/kernel
    timings)."""
    import jax

    jax.profiler.start_trace(path)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class Timer:
    """Simple named wall-clock scopes for stage timing."""

    def __init__(self):
        self.times: dict[str, float] = {}

    @contextlib.contextmanager
    def scope(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.times[name] = self.times.get(name, 0.0) + (
                time.perf_counter() - t0
            )
