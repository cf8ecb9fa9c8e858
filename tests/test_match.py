"""Matching ops vs the oracle (reference: test/test_matching.py — SURVEY.md §4)."""

import numpy as np
import jax.numpy as jnp
import pytest

from sift_pyocl_jax import MatchPlan
from sift_pyocl_jax.oracle import KP_DTYPE, match_descriptors, sift_numpy
from sift_pyocl_jax.ops.match import match_descriptors_jax
from sift_pyocl_jax.utils.testimage import transformed_pair


@pytest.fixture(scope="module")
def desc_pair():
    rng = np.random.default_rng(0)
    base = rng.integers(0, 90, (80, 128), dtype=np.uint8)
    noisy = np.clip(base.astype(int) + rng.integers(-3, 4, base.shape), 0, 255)
    # shuffle second set so index mapping is nontrivial
    perm = rng.permutation(80)
    return base, noisy[perm].astype(np.uint8), perm


def test_l1_matching_parity(desc_pair):
    d1, d2, _ = desc_pair
    ref = match_descriptors(d1, d2)
    res = match_descriptors_jax(
        jnp.asarray(d1), jnp.ones(len(d1), bool),
        jnp.asarray(d2), jnp.ones(len(d2), bool), metric="L1",
    )
    m = np.asarray(res.valid)
    got = set(zip(np.asarray(res.idx1)[m].tolist(), np.asarray(res.idx2)[m].tolist()))
    assert got == set(map(tuple, ref))
    assert int(res.count) == len(ref)


def test_l1_recovers_permutation(desc_pair):
    d1, d2, perm = desc_pair
    res = match_descriptors_jax(
        jnp.asarray(d1), jnp.ones(len(d1), bool),
        jnp.asarray(d2), jnp.ones(len(d2), bool), metric="L1",
    )
    m = np.asarray(res.valid)
    i1 = np.asarray(res.idx1)[m]
    i2 = np.asarray(res.idx2)[m]
    # matched pairs must agree with the known permutation
    inv = np.argsort(perm)
    assert (i2 == inv[i1]).mean() > 0.95


def test_l2_mode(desc_pair):
    d1, d2, perm = desc_pair
    res = match_descriptors_jax(
        jnp.asarray(d1), jnp.ones(len(d1), bool),
        jnp.asarray(d2), jnp.ones(len(d2), bool), metric="L2",
    )
    m = np.asarray(res.valid)
    inv = np.argsort(perm)
    assert (np.asarray(res.idx2)[m] == inv[np.asarray(res.idx1)[m]]).mean() > 0.95


def test_validity_masks(desc_pair):
    d1, d2, _ = desc_pair
    v2 = np.ones(len(d2), bool)
    v2[:40] = False
    res = match_descriptors_jax(
        jnp.asarray(d1), jnp.ones(len(d1), bool), jnp.asarray(d2), jnp.asarray(v2),
    )
    m = np.asarray(res.valid)
    assert (np.asarray(res.idx2)[m] >= 40).all()


def test_empty_inputs():
    mp = MatchPlan()
    out = mp.match(np.zeros(0, KP_DTYPE), np.zeros(5, KP_DTYPE))
    assert out.shape == (0, 2)


def test_match_plan_translated_scene(small_cfg):
    from sift_pyocl_jax import SiftPlan

    a, b = transformed_pair((128, 128), seed=1, dx=5, dy=-3)
    pa = SiftPlan(shape=a.shape, config=small_cfg)
    ka, kb = pa.keypoints(a), pa.keypoints(b)
    mp = MatchPlan()
    m = mp.match(ka, kb)
    assert len(m) >= 5
    dx = np.median(m[:, 1]["x"] - m[:, 0]["x"])
    dy = np.median(m[:, 1]["y"] - m[:, 0]["y"])
    assert abs(dx + 5) < 0.5 and abs(dy - 3) < 0.5


def _assert_best2_equal(got, want, rows=slice(None)):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g)[rows], np.asarray(w)[rows])


def test_pallas_best2_matches_xla(desc_pair):
    """Triton best-2 kernel (interpret mode) == XLA _best2_l2 bit for bit:
    distances, argmin identity, and tie-breaking."""
    from sift_pyocl_jax.ops.match import _best2_l2
    from sift_pyocl_jax.ops.pallas.matchk import best2_l2_triton

    d1s, d2s, _perm = desc_pair
    rng = np.random.default_rng(3)
    valid2 = jnp.asarray(rng.uniform(size=len(d2s)) < 0.8)
    # plant exact duplicates to exercise tie-breaking
    d2s = np.array(d2s)
    d2s[7] = d2s[3]
    a, b = jnp.asarray(d1s), jnp.asarray(d2s)
    _assert_best2_equal(best2_l2_triton(a, b, valid2, interpret=True),
                        _best2_l2(a, b, valid2))


def test_pallas_best2_degenerate():
    """Zero / one valid column rows keep XLA semantics through the kernel."""
    from sift_pyocl_jax.ops.match import _best2_l2
    from sift_pyocl_jax.ops.pallas.matchk import best2_l2_triton

    rng = np.random.default_rng(4)
    a = jnp.asarray(rng.integers(0, 255, (8, 128)), jnp.uint8)
    b = jnp.asarray(rng.integers(0, 255, (16, 128)), jnp.uint8)
    for nvalid in (0, 1):
        v = jnp.asarray(np.arange(16) < nvalid)
        _assert_best2_equal(best2_l2_triton(a, b, v, interpret=True),
                            _best2_l2(a, b, v))


def test_pallas_best2_ratio_test_agrees(desc_pair):
    """The kernel's (d1, d2, i1) put through the ratio test keep the same
    matches, with the same partners, as match_descriptors_dense on the XLA
    path."""
    from sift_pyocl_jax.ops.match import match_descriptors_dense
    from sift_pyocl_jax.ops.pallas.matchk import best2_l2_triton

    d1s, d2s, _perm = desc_pair
    rng = np.random.default_rng(5)
    valid1 = jnp.asarray(rng.uniform(size=len(d1s)) < 0.7)
    valid2 = jnp.asarray(rng.uniform(size=len(d2s)) < 0.8)
    a, b = jnp.asarray(d1s), jnp.asarray(d2s)
    ratio_sq = 0.73 ** 2
    keep, idx2, dist, _ = match_descriptors_dense(a, valid1, b, valid2,
                                                  ratio_sq=ratio_sq)
    k1, k2, ki = (np.asarray(x) for x in
                  best2_l2_triton(a, b, valid2, interpret=True))
    kkeep = np.asarray(valid1) & np.isfinite(k2) & (k2 > 0) & (k1 < ratio_sq * k2)
    keep = np.asarray(keep)
    assert keep.sum() > 10
    np.testing.assert_array_equal(kkeep, keep)
    np.testing.assert_array_equal(ki[keep], np.asarray(idx2)[keep])
    np.testing.assert_array_equal(k1[keep], np.asarray(dist)[keep])


def test_pallas_best2_bf16_u8_exact(desc_pair):
    """Full-range u8 descriptors through the kernel's bf16 tensor-core dot ==
    the f32 XLA reduction bit-for-bit (u8 values, products and 128-term sums
    are all exact)."""
    from sift_pyocl_jax.ops.match import _best2_l2
    from sift_pyocl_jax.ops.pallas.matchk import best2_l2_triton

    rng = np.random.default_rng(6)
    a = jnp.asarray(rng.integers(0, 256, (300, 128)), jnp.uint8)
    b = jnp.asarray(rng.integers(0, 256, (200, 128)), jnp.uint8)
    v2 = jnp.asarray(rng.uniform(size=200) < 0.9)
    _assert_best2_equal(best2_l2_triton(a, b, v2, interpret=True),
                        _best2_l2(a, b, v2))


def _lowered_text(dtype, platform):
    from sift_pyocl_jax.ops.match import match_descriptors_dense

    d = jnp.zeros((64, 128), dtype)
    v = jnp.ones(64, bool)
    return match_descriptors_dense.trace(d, v, d, v).lower(
        lowering_platforms=(platform,)).as_text()


def test_matcher_choice_u8_on_gpu_uses_kernel():
    """u8 descriptors lowered for a CUDA GPU go through the Triton kernel."""
    assert "best2_l2" in _lowered_text(jnp.uint8, "cuda")


@pytest.mark.parametrize("dtype,platform", [(jnp.float32, "cuda"),
                                            (jnp.uint8, "cpu")])
def test_matcher_choice_f32_or_cpu_uses_xla(dtype, platform):
    """f32 descriptors, or any lowering for the CPU, take the XLA reduction."""
    txt = _lowered_text(dtype, platform)
    assert "best2_l2" not in txt and "triton" not in txt
