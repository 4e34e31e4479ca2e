"""The one platform decision (ash_renderer.backend), the compile-cache
rule, and chip_smoke.py's refusal to run without a GPU."""

import os
import shutil
import subprocess
import sys
import types

import jax
import pytest

from ash_renderer import backend

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("platform,interpret", [("gpu", False), ("cpu", True)])
def test_interpret_mode(platform, interpret):
    dev = types.SimpleNamespace(platform=platform)
    assert backend.interpret_mode(dev) is interpret


def test_other_platforms_are_refused():
    with pytest.raises(ValueError, match="unsupported platform"):
        backend.interpret_mode(types.SimpleNamespace(platform="rocm"))


def test_renderer_takes_interpret_mode_on_cpu():
    from ash_renderer import RendererSettings, reference_two_triangle_scene
    from ash_renderer.renderer import Renderer

    r = Renderer(
        reference_two_triangle_scene(),
        RendererSettings(width=64, height=48, clip_budget=32),
    )
    assert r.device.platform == "cpu" and r.interpret
    assert r.statics.interpret


def test_gpu_without_fma_flag_is_refused(monkeypatch):
    gpu = types.SimpleNamespace(platform="gpu")
    flags = os.environ["XLA_FLAGS"].replace(backend.NO_FMA_FLAG, "")
    monkeypatch.setenv("XLA_FLAGS", flags)
    with pytest.raises(RuntimeError, match="nvptx-fma-level"):
        backend.check_exact_backend(gpu)
    monkeypatch.setenv("XLA_FLAGS", flags + " " + backend.NO_FMA_FLAG)
    backend.check_exact_backend(gpu)
    backend.check_exact_backend(types.SimpleNamespace(platform="cpu"))


def test_fma_flag_set_once_at_import(monkeypatch):
    assert backend.NO_FMA_FLAG in os.environ["XLA_FLAGS"].split()
    monkeypatch.setattr(backend, "_flag_set_late", backend._flag_set_late)
    monkeypatch.setenv("XLA_FLAGS", "--xla_cpu_max_isa=SSE4_2")
    backend.configure_xla_flags()
    backend.configure_xla_flags()
    flags = os.environ["XLA_FLAGS"].split()
    assert flags.count(backend.NO_FMA_FLAG) == 1
    assert "--xla_cpu_max_isa=SSE4_2" in flags
    # added after this process's backend started: a GPU would be refused
    with pytest.raises(RuntimeError):
        backend.check_exact_backend(types.SimpleNamespace(platform="gpu"))


def test_compile_cache_follows_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert backend.enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself: nothing else is set in code
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_into_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = backend.enable_compile_cache()
        assert path == os.path.join(ROOT, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def _run_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def _no_result(proc):
    lines = proc.stdout.strip().splitlines()
    return proc.returncode != 0 and not (lines and lines[-1].startswith("{"))


def test_chip_smoke_refuses_cpu():
    proc = _run_smoke(ROOT)
    assert _no_result(proc), proc.stdout
    assert "needs an NVIDIA GPU" in proc.stdout


def test_chip_smoke_needs_the_repo(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    assert _no_result(_run_smoke(tmp_path))
