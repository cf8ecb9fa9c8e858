"""Detection ops vs the oracle (reference: test/test_image.py — SURVEY.md §4)."""

import numpy as np
import jax.numpy as jnp
import pytest

from sift_pyocl_jax import oracle as O
from sift_pyocl_jax.ops.detect import (
    compact_extrema,
    detect_octave,
    extrema_mask,
    refine_candidates,
)


@pytest.fixture(scope="module")
def octaves(scene128, small_cfg):
    return O.build_scale_space(scene128, small_cfg)


def test_extrema_parity(octaves, small_cfg):
    total = 0
    for o, (_, dogs) in enumerate(octaves[:3]):
        ref = set(map(tuple, O.local_maxmin(dogs, small_cfg, o)))
        m = np.asarray(extrema_mask(jnp.asarray(dogs), small_cfg, o))
        s, r, c = np.nonzero(m)
        bd = small_cfg.border_dist
        got = set(zip(s + 1, r + bd, c + bd))
        assert got == ref, f"octave {o}: {got ^ ref}"
        total += len(ref)
    assert total > 5  # scene must actually exercise the path


def test_compact_count_and_indices(octaves, small_cfg):
    dogs = jnp.asarray(octaves[1][1])
    m = extrema_mask(dogs, small_cfg, 1)
    cands = compact_extrema(m, small_cfg, 256)
    n = int(np.asarray(m).sum())
    assert int(cands.count) == n
    assert int(cands.valid.sum()) == min(n, 256)
    # compacted indices point at true extrema
    mn = np.asarray(m)
    bd = small_cfg.border_dist
    for i in range(int(cands.valid.sum())):
        s, r, c = int(cands.s[i]), int(cands.r[i]), int(cands.c[i])
        assert mn[s - 1, r - bd, c - bd]


@pytest.mark.parametrize("density,cap", [(0.002, 256), (0.02, 512),
                                          (0.2, 300)])
def test_compact_extrema_matches_nonzero(small_cfg, density, cap):
    """compact_extrema == np.nonzero in exact row-major order, with the true
    count kept when it overflows the capacity (the 0.2 case)."""
    rng = np.random.default_rng(int(density * 1000))
    mask = rng.uniform(size=(3, 40, 57)) < density
    cands = compact_extrema(jnp.asarray(mask), small_cfg, cap)
    s, r, c = np.nonzero(mask)
    n = len(s)
    k = min(n, cap)
    assert int(cands.count) == n
    assert np.asarray(cands.valid).sum() == k
    bd = small_cfg.border_dist
    np.testing.assert_array_equal(np.asarray(cands.s)[:k], s[:k] + 1)
    np.testing.assert_array_equal(np.asarray(cands.r)[:k], r[:k] + bd)
    np.testing.assert_array_equal(np.asarray(cands.c)[:k], c[:k] + bd)


def test_refinement_parity(octaves, small_cfg):
    checked = 0
    for o, (_, dogs) in enumerate(octaves[:2]):
        cands_ref = O.local_maxmin(dogs, small_cfg, o)
        dj = jnp.asarray(dogs)
        cands = compact_extrema(extrema_mask(dj, small_cfg, o), small_cfg, 256)
        ref = refine_candidates(dj, cands, small_cfg)
        got = {}
        for i in range(cands.s.shape[0]):
            if bool(ref.valid[i]):
                got[(int(cands.s[i]), int(cands.r[i]), int(cands.c[i]))] = (
                    float(ref.fs[i]), float(ref.fr[i]), float(ref.fc[i]),
                    float(ref.peak[i]),
                )
        exp = {}
        for s, r, c in cands_ref:
            res = O.interp_keypoint(dogs, int(s), int(r), int(c), small_cfg)
            if res is not None:
                exp[(int(s), int(r), int(c))] = (res[1], res[2], res[3], res[0])
        assert set(got) == set(exp)
        for k in exp:
            np.testing.assert_allclose(got[k], exp[k], atol=1e-3)
        checked += len(exp)
    assert checked > 3


def test_detect_octave_end_to_end(octaves, small_cfg):
    dogs = jnp.asarray(octaves[0][1])
    kps = detect_octave(dogs, small_cfg, 0, 256)
    n = int(kps.valid.sum())
    assert n > 0
    fr = np.asarray(kps.fr)[np.asarray(kps.valid)]
    fc = np.asarray(kps.fc)[np.asarray(kps.valid)]
    H, W = dogs.shape[1:]
    assert fr.min() >= small_cfg.border_dist - 1.5
    assert fc.max() <= W - small_cfg.border_dist + 1.5
