"""Test environment: CPU backend with 8 virtual devices.

Mirrors the reference's single-device unittest strategy (SURVEY.md §4) but on
the CPU backend for determinism and adds an 8-device virtual mesh so the
multi-chip sharding paths (parallel/, sfm distributed BA) are testable without
a pod — per the multi-host test strategy in SURVEY.md §4.
"""

import os
import resource

# The default 8 MB stack is not enough for XLA's recursive compile passes on
# the big fused graphs (vo_step at production capacities): the suite
# intermittently SEGFAULTS mid-compile with ~128 GB of RAM free (observed
# twice in round 4; the faulthandler dump ends inside a compile call).
# Raise the soft limit to the hard limit (or 512 MB) before any compilation.
try:
    _soft, _hard = resource.getrlimit(resource.RLIMIT_STACK)
    _want = 512 * 1024 * 1024
    if _hard != resource.RLIM_INFINITY:
        _want = min(_want, _hard)
    if _soft != resource.RLIM_INFINITY and _soft < _want:
        resource.setrlimit(resource.RLIMIT_STACK, (_want, _hard))
except (ValueError, OSError):  # platform refuses: keep the default
    pass

# Run on CPU unless JAX_PLATFORMS names the platforms (the `gpu`-marked
# tests run on the card with JAX_PLATFORMS=cuda,cpu), even where jax was
# imported before this file ran (env edits are then too late — only
# jax.config.update works post-import).  CPU runs are deterministic and see
# the 8-device virtual mesh.
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")

import pytest  # noqa: E402

from sift_pyocl_jax.config import SiftConfig  # noqa: E402
from sift_pyocl_jax.oracle import match_keypoint_sets  # noqa: E402,F401
from sift_pyocl_jax.utils.testimage import synthetic_scene  # noqa: E402

# --- fast verification lane ----------------------
# One representative test per subsystem, selected to keep `pytest -m quick`
# under ~5 minutes on one CPU so any driver/judge/builder can cheaply confirm
# green.  Centralized here (not as per-file decorators) so the lane is easy
# to audit and rebalance.  Full-suite coverage is unchanged.
QUICK_TESTS = {
    "test_config.py::test_reference_defaults",        # L3 params
    "test_config.py::test_par_bridge",                # legacy par dict
    "test_pyramid.py::test_blur_jax_vs_oracle",       # L0 blur vs oracle
    "test_pyramid.py::test_scale_space_parity",       # pyramid ladder
    "test_detect.py::test_compact_count_and_indices",  # compaction
    "test_match.py::test_pallas_best2_matches_xla",   # best-2 kernel
    "test_detect.py::test_extrema_parity",            # extrema mask
    "test_orient_desc.py::test_orientation_parity",   # orientation
    "test_orient_desc.py::test_descriptor_parity",    # descriptor
    "test_pipeline.py::test_end_to_end_parity",       # SiftPlan e2e
    "test_pipeline.py::test_output_format",           # KP_DTYPE surface
    "test_match.py::test_l1_matching_parity",         # MatchPlan numerics
    "test_transform.py::test_warp_vs_oracle",         # affine warp
    "test_align.py::test_align_recovers_translation", # LinearAlign e2e
    "test_ransac.py::test_ransac_affine_with_outliers",
    "test_sfm_geometry.py::test_essential_pipeline",  # two-view geometry
    "test_pnp_posegraph.py::test_pnp_refine_converges",
    "test_ba.py::test_ba_converges",                  # LM/Schur BA
    # VO: the production-capacity vo_step jit costs ~140 s of CPU compile,
    # which blows the lane budget — quick runs the tiny-capacity e2e
    # (window=3, 32 pts, 96^2: ~55 s total) plus the matching gates; the
    # full-capacity vo_step stays in the full suite and bench.py.
    "test_vo.py::test_vo_step_quick",
    "test_vo.py::test_match_xy_radius_gating",
    "test_video.py::test_frames_mesh",                # DP sharding
    "test_spatial.py::test_sharded_scale_space_matches_single_device",  # TP
    "test_checkpoint_multihost.py::test_ba_checkpoint_roundtrip",
    "test_evaluate_cli.py::test_gt_parsers",          # evaluate CLI
    "test_fixtures.py::test_fixture_roundtrip",       # ingestion
    "test_framesource.py::test_native_matches_numpy", # C++ decoder
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        key = f"{os.path.basename(str(item.fspath))}::{item.name.split('[')[0]}"
        if key in QUICK_TESTS:
            item.add_marker(pytest.mark.quick)


@pytest.fixture(scope="session")
def small_cfg():
    """Low-capacity config: identical numerics, small compile."""
    return SiftConfig(kp_per_octave_cap=256)


@pytest.fixture(scope="session")
def scene128():
    return synthetic_scene((128, 128), n_blobs=15, seed=0)


@pytest.fixture(scope="session")
def scene160():
    return synthetic_scene((160, 128), n_blobs=20, seed=3)
