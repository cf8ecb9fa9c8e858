"""Device timing and compile-cache setup shared by the benchmark scripts.

Timing protocol: compile and warm the step off the clock, then time N
back-to-back calls and wait for the last result with `block_until_ready`
(JAX dispatch is asynchronous, so a timing without the barrier measures
only the enqueue).  The median over `reps` such windows is reported.
"""

from __future__ import annotations

import os
import subprocess
import time
from pathlib import Path
from typing import Callable

import jax
import numpy as np

CHECKOUT_ROOT = Path(__file__).resolve().parents[2]


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at `JAX_COMPILATION_CACHE_DIR`
    when it is set, else at the fixed `<checkout>/.jax_compile_cache` (a
    fixed path, because the path is part of the cache key).

    With the variable set, JAX already reads it; it is applied again here
    only so a value set after `import jax` takes effect too, and no other
    directory is ever configured.  Returns the directory."""
    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(
        CHECKOUT_ROOT / ".jax_compile_cache")
    os.makedirs(cache_dir, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    return cache_dir


def time_ms(fn: Callable, *args, n: int = 10, reps: int = 3,
            warmup: int = 1) -> float:
    """Median milliseconds per call of `fn(*args)` (an already-jitted
    function): `warmup` untimed calls (the first compiles), then `reps`
    windows of `n` back-to-back calls, each closed by `block_until_ready`
    on its last output."""
    for _ in range(max(warmup, 1)):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(n):
            out = fn(*args)
        jax.block_until_ready(out)
        times.append((time.perf_counter() - t0) / n)
    return float(np.median(times) * 1e3)


def chained_ms(
    step: Callable,
    x0,
    n_lo: int = 1,
    n_hi: int = 17,
    reps: int = 3,
) -> float:
    """Median milliseconds per call of `jax.jit(step)(x0)` (x0 any pytree):
    `n_lo` warm-up calls, then `reps` windows of `n_hi` calls (time_ms)."""
    return time_ms(jax.jit(step), x0, n=n_hi, reps=reps, warmup=n_lo)


def gpu_card() -> str:
    """The card's name and power limit, as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` prints
    them (one line per card).  Raises when nvidia-smi fails."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()
