"""Checks that need a CUDA GPU: outputs placed on the card, and the compiled
best-2 matcher kernel against its plain XLA reference.

`chip_smoke.py` calls these in-process on the card; `tests/test_gpu.py`
wraps them under the `gpu` pytest marker (they skip where JAX has no GPU).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.match import _best2_l2
from ..ops.pallas.matchk import best2_l2_triton
from .benchtool import time_ms


def assert_on_gpu(tree, what: str = "output") -> None:
    """Every array leaf of `tree` lives on GPU devices only."""
    for leaf in jax.tree_util.tree_leaves(tree):
        plats = {d.platform for d in leaf.devices()}
        if plats != {"gpu"}:
            raise AssertionError(f"{what}: array on {plats}, not the GPU")


def best2_inputs(n1: int, n2: int, seed: int = 0):
    """Full-range uint8 descriptors with the cases the kernel must keep
    exact: invalid columns, duplicated set-2 columns (distance ties) and
    queries equal to a set-2 row (zero best)."""
    rng = np.random.default_rng(seed)
    d2 = rng.integers(0, 256, (n2, 128)).astype(np.uint8)
    d1 = rng.integers(0, 256, (n1, 128)).astype(np.uint8)
    step = max(n2 // 7, 1)
    d2[step::step] = d2[0]                      # ties across column tiles
    k = min(n1, n2) // 3
    d1[:k] = d2[rng.integers(0, n2, k)]         # exact matches
    valid2 = rng.uniform(size=n2) < 0.9
    return tuple(map(jnp.asarray, (d1, d2, valid2)))


def check_best2_kernel(n1: int, n2: int, seed: int = 0, n: int = 20,
                       reps: int = 3) -> dict:
    """Compiled Triton kernel == _best2_l2 bit for bit on (N1, N2) uint8
    descriptors.  Returns both times in ms (median, see time_ms)."""
    d1, d2, v2 = best2_inputs(n1, n2, seed)
    ref = jax.jit(_best2_l2)
    want = ref(d1, d2, v2)
    got = best2_l2_triton(d1, d2, v2)
    assert_on_gpu((want, got), "best2")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    return {
        "n1": n1, "n2": n2,
        "kernel_ms": time_ms(best2_l2_triton, d1, d2, v2, n=n, reps=reps),
        "xla_ms": time_ms(ref, d1, d2, v2, n=n, reps=reps),
    }
