"""The one place that decides how the renderer uses the device it runs on.

* ``gpu``: the compiled kernels.  XLA:GPU must not contract ``a*b + c``
  into fused multiply-adds, because the frame is specified to round every
  multiply and add on its own (``specmath``); :data:`NO_FMA_FLAG` turns
  contraction off in LLVM's NVPTX backend, which also compiles the Triton
  kernels.  It must be in ``XLA_FLAGS`` before the backend starts, so
  :func:`configure_xla_flags` runs when the package is imported.
* ``cpu``: Pallas interpret mode, an explicit mode for tests and
  development.
* anything else: an error.
"""

from __future__ import annotations

import os

# LLVM option passed through XLA: with contraction disabled the NVPTX
# backend emits mul.rn/add.rn, which ptxas never fuses.  Harmless on XLA:CPU.
NO_FMA_FLAG = "--xla_backend_extra_options=-nvptx-fma-level=0"

# in-checkout compile cache used when JAX_COMPILATION_CACHE_DIR is unset
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)

_flag_set_late = False


def configure_xla_flags() -> None:
    """Append :data:`NO_FMA_FLAG` to ``XLA_FLAGS``.  If a JAX backend was
    already running when this was called, the flag cannot take effect;
    :func:`check_exact_backend` then refuses the GPU."""
    global _flag_set_late
    flags = os.environ.get("XLA_FLAGS", "")
    if NO_FMA_FLAG in flags.split():
        return
    os.environ["XLA_FLAGS"] = (flags + " " + NO_FMA_FLAG).strip()
    try:
        from jax._src import xla_bridge

        _flag_set_late = xla_bridge.backends_are_initialized()
    except (ImportError, AttributeError):
        _flag_set_late = False


def interpret_mode(device) -> bool:
    """True when Pallas kernels must run in interpret mode on ``device``:
    False on a GPU, True on the CPU, and an error on any other platform."""
    if device.platform == "gpu":
        return False
    if device.platform == "cpu":
        return True
    raise ValueError(
        f"unsupported platform {device.platform!r}: the renderer runs on an "
        "NVIDIA GPU, or on the CPU in interpret mode"
    )


def check_exact_backend(device) -> None:
    """Refuse a GPU whose XLA backend was started without
    :data:`NO_FMA_FLAG`: its frames would not be bit-exact."""
    if device.platform != "gpu":
        return
    if _flag_set_late or NO_FMA_FLAG not in os.environ.get("XLA_FLAGS", "").split():
        raise RuntimeError(
            f"the GPU backend was started without {NO_FMA_FLAG!r} in "
            "XLA_FLAGS; import ash_renderer before initialising JAX"
        )


def select_device(preferred_index=None):
    """The explicitly preferred device, else the first GPU, else the first
    device (the reference prefers a discrete GPU over the CPU)."""
    import jax

    devices = jax.devices()
    if preferred_index is not None:
        return devices[preferred_index]
    return next((d for d in devices if d.platform == "gpu"), devices[0])


def compile_cache_dir() -> str:
    """``JAX_COMPILATION_CACHE_DIR`` if set, else the in-checkout default."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at :func:`compile_cache_dir`.
    JAX reads ``JAX_COMPILATION_CACHE_DIR`` itself, so nothing is set in
    code when it is present."""
    path = compile_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        import jax

        jax.config.update("jax_compilation_cache_dir", path)
    return path
