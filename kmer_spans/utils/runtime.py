"""Process set-up shared by the entry points (CLI, bench, chip smoke).

* ``enable_compile_cache`` — JAX's persistent compilation cache at a
  fixed path, so a second process reuses the first one's programs.
* ``require_gpu`` — the measurement entry points run on a GPU or not at
  all; they never fall back to the CPU.
* ``card_info`` — the card's name and power limit, printed beside every
  measurement (a card set below its maximum power runs slower).
"""

from __future__ import annotations

import os
import subprocess

#: default cache directory: <repo>/.jax_cache (listed in .gitignore)
REPO_CACHE_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", ".jax_cache"))


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and no
    other directory is set here.  Otherwise the cache goes to
    REPO_CACHE_DIR.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    return REPO_CACHE_DIR


def require_gpu():
    """The visible JAX devices, or SystemExit when they are not GPUs."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX runs on {devs[0].platform!r} "
            f"({devs[0].device_kind}); refusing to measure")
    return devs


def card_info() -> str:
    """``name, power.limit`` of each card, as nvidia-smi prints them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        return f"unknown ({type(e).__name__})"
    return "; ".join(
        line.strip() for line in out.stdout.splitlines() if line.strip())
