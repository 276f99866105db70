"""Runtime setup helpers (compilation cache, device checks, virtual CPU
meshes)."""

from __future__ import annotations

import os

# The in-checkout cache directory, found relative to this file so that
# every process of one checkout shares it wherever the checkout lives.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compilation_cache() -> None:
    """Persistent XLA compilation cache: first compiles of the big configs
    take minutes; later processes hit the cache.

    With ``JAX_COMPILATION_CACHE_DIR`` set, JAX already reads it and no
    directory is set here. JAX's default XLA caches stay on, so on the
    GPU XLA's autotuning results are kept beside the programs and a new
    process does not autotune again.
    """
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


def require_gpu():
    """``jax.devices()`` when JAX's default backend is a GPU; otherwise
    SystemExit with the reason. Measurement entry points call this first:
    with no GPU they stop, they do not fall back to the CPU."""
    import jax

    try:
        devices = jax.devices()
    # JAX_PLATFORMS=cuda without a card raises RuntimeError; without the
    # CUDA plugin, JAX's backend table ends empty (AssertionError).
    except (RuntimeError, AssertionError) as exc:
        raise SystemExit(f"no GPU: JAX could not start a backend: {exc!r}")
    if devices[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX's devices are {devices}")
    return devices


def gpu_name_and_power_limit() -> str:
    """The first card's ``name, power.limit`` as nvidia-smi prints them,
    read in a child process that stays off JAX."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def force_cpu_mesh(devices: int = 8) -> None:
    """Select the virtual multi-device CPU platform (tests / dry runs).

    Must run before any JAX backend initialisation: it sets the host
    device count in XLA_FLAGS and pins the platform to the CPU.
    """
    import jax

    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={devices}"
        ).strip()
    jax.config.update("jax_platforms", "cpu")
