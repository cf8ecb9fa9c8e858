"""Keypoint repeatability / descriptor-matching invariance battery.

The reference validated its numerics end-to-end by cross-checking keypoints
against the IPOL `sift.cpp` outputs on real images (SURVEY.md §4); with no
reference mount and no network, the only reference-free end-to-end
validation of SIFT numerics is the classic acceptance test: keypoints must
REPEAT and descriptors must MATCH under known transforms of the same scene
(Lowe 2004 §7; Mikolajczyk & Schmid 2005 protocol).

Protocol: TWO scenes on a fixed
256^2 canvas — the round-4 Gaussian-blob scene and a multi-frequency
textured scene (noise octaves + hard edges + illumination gradient, much
closer to photographic statistics; `utils/testimage.py::textured_scene`) —
warped with the production affine warp over the Mikolajczyk axes: rotation
15/30/45/90 deg, zoom 0.5x/2x, additive noise, anisotropic viewpoint tilt,
and a photometric gain/bias case; detect with the SAME SiftPlan (one
compile); score
  repeatability — fraction of eligible original keypoints (mapped location
      inside the frame with margin, and inside the warp's source coverage)
      with a detected keypoint within TOL_PX in the transformed image and a
      scale within a factor-1.7 band of the expected scale;
  match precision — fraction of MatchPlan ratio-test matches whose pair is
      geometrically consistent with the known transform (< 3 px).

Thresholds were CALIBRATED per (scene, case) (see PARITY.md "Invariance
battery" table for the measured values) and frozen with a safety margin —
they catch regressions in any pipeline stage, not inter-library parity.
This battery caught the round-1..3 descriptor rotation-convention bug
(R(-a) instead of R(+a): descriptors matched at ZERO rate under rotation
while repeatability was 0.9).
"""

import numpy as np
import pytest

from sift_pyocl_jax import MatchPlan, SiftPlan
from sift_pyocl_jax.ops.transform import affine_warp_jax
from sift_pyocl_jax.utils.testimage import synthetic_scene, textured_scene

SHAPE = (256, 256)
TOL_PX = 2.0          # repeatability localization tolerance
MATCH_TOL_PX = 3.0    # geometric-consistency tolerance for matches
MARGIN = 12.0         # ignore keypoints mapping near the frame border
SCALE_BAND = 1.7      # detected scale must be within this factor of expected

# (name, angle_deg, zoom, tilt, noise_sigma, gain, bias).  `tilt` is the
# Mikolajczyk viewpoint parameter: the x (column) axis is compressed by
# 1/tilt before rotation/zoom.  gain/bias apply photometrically after the
# warp: I' = clip(gain*I + bias, 0, 255).
CASES = [
    ("rot15",    15.0, 1.0, 1.0, 0.0, 1.0, 0.0),
    ("rot30",    30.0, 1.0, 1.0, 0.0, 1.0, 0.0),
    ("rot45",    45.0, 1.0, 1.0, 0.0, 1.0, 0.0),
    ("rot90",    90.0, 1.0, 1.0, 0.0, 1.0, 0.0),
    ("zoom_out",  0.0, 0.5, 1.0, 0.0, 1.0, 0.0),
    ("zoom_in",   0.0, 2.0, 1.0, 0.0, 1.0, 0.0),
    ("noise8",    0.0, 1.0, 1.0, 8.0, 1.0, 0.0),
    ("tilt1.4",  20.0, 1.0, 1.4, 0.0, 1.0, 0.0),
    ("gainbias",  0.0, 1.0, 1.0, 0.0, 0.7, 40.0),
]

# Frozen floors per (scene, case): (min_repeatability, min_precision,
# min_eligible, min_matches).  Blob floors from the 2026-08-20 r4
# calibration; texture + tilt/gainbias floors from the 2026-08-20 r5
# calibration (measured values in PARITY.md), both with ~15% margin.
FLOORS = {
    ("blobs", "rot15"):    (0.75, 0.90, 25, 40),
    ("blobs", "rot30"):    (0.75, 0.90, 25, 35),
    ("blobs", "rot45"):    (0.75, 0.90, 25, 35),
    ("blobs", "rot90"):    (0.85, 0.90, 25, 50),
    ("blobs", "zoom_out"): (0.55, 0.90, 25, 25),
    ("blobs", "zoom_in"):  (0.55, 0.90, 10, 12),
    ("blobs", "noise8"):   (0.85, 0.90, 25, 50),
    ("blobs", "tilt1.4"):  (0.60, 0.90, 25, 20),
    ("blobs", "gainbias"): (0.85, 0.95, 25, 55),
    ("texture", "rot15"):    (0.70, 0.90, 40, 45),
    ("texture", "rot30"):    (0.70, 0.90, 40, 40),
    ("texture", "rot45"):    (0.70, 0.90, 40, 40),
    ("texture", "rot90"):    (0.80, 0.90, 40, 55),
    ("texture", "zoom_out"): (0.43, 0.85, 40, 20),
    ("texture", "zoom_in"):  (0.45, 0.85, 15, 8),
    ("texture", "noise8"):   (0.75, 0.90, 40, 45),
    ("texture", "tilt1.4"):  (0.55, 0.90, 40, 20),
    ("texture", "gainbias"): (0.80, 0.95, 40, 55),
}


def _forward_affine(angle_deg: float, zoom: float, shape, tilt: float = 1.0):
    """Forward map p' = A p + b in (row, col) about the image center.

    A = zoom * R(angle) @ diag(1, 1/tilt): the column axis is foreshortened
    by 1/tilt (viewpoint change about a vertical axis), then rotated/zoomed.
    """
    th = np.deg2rad(angle_deg)
    R = np.array([[np.cos(th), -np.sin(th)],
                  [np.sin(th), np.cos(th)]], np.float64)
    A = zoom * R @ np.diag([1.0, 1.0 / tilt])
    c = np.array([(shape[0] - 1) / 2.0, (shape[1] - 1) / 2.0])
    b = c - A @ c
    return A, b


def _warp(img: np.ndarray, A: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Apply the FORWARD transform (A, b) with the production inverse warp."""
    Ainv = np.linalg.inv(A)
    off = -Ainv @ b
    return np.asarray(affine_warp_jax(img, Ainv.astype(np.float32),
                                      off.astype(np.float32)))


def _kp_rc(kp):
    """Keypoint positions as (N, 2) (row, col): kp.x is column, kp.y row."""
    return np.stack([np.asarray(kp["y"]), np.asarray(kp["x"])], axis=-1)


@pytest.fixture(scope="module")
def plan():
    return SiftPlan(SHAPE, "float32")


@pytest.fixture(scope="module", params=["blobs", "texture"])
def scene_and_kp(request, plan):
    name = request.param
    if name == "blobs":
        img = synthetic_scene(SHAPE, n_blobs=90, seed=7)
    else:
        img = textured_scene(SHAPE, seed=7)
    kp0 = plan.keypoints(img)
    assert len(kp0) >= 50, f"{name}: calibration scene must be feature-rich"
    return name, img, kp0


@pytest.mark.slow
@pytest.mark.parametrize(
    "name,angle,zoom,tilt,noise,gain,bias", CASES, ids=[c[0] for c in CASES])
def test_invariance(scene_and_kp, plan, name, angle, zoom, tilt, noise,
                    gain, bias):
    scene, img, kp0 = scene_and_kp
    min_rep, min_prec, min_elig, min_match = FLOORS[(scene, name)]
    A, b = _forward_affine(angle, zoom, SHAPE, tilt)
    warped = _warp(img, A, b)
    if noise > 0:
        rng = np.random.default_rng(11)
        warped = warped + rng.normal(0.0, noise, warped.shape)
    if gain != 1.0 or bias != 0.0:
        warped = gain * warped + bias
    warped = np.clip(warped, 0, 255).astype(np.float32)
    kp1 = plan.keypoints(warped)
    assert len(kp1) > 0

    # --- repeatability -----------------------------------------------------
    p0 = _kp_rc(kp0)
    mapped = p0 @ A.T + b
    h, w = SHAPE
    inside = ((mapped[:, 0] > MARGIN) & (mapped[:, 0] < h - 1 - MARGIN)
              & (mapped[:, 1] > MARGIN) & (mapped[:, 1] < w - 1 - MARGIN))
    # the warp only covers source pixels that land in-frame; for zoom-in the
    # source coverage is the central 1/zoom region — eligibility already
    # handled because mapped stays in-frame only for covered sources.
    elig = np.where(inside)[0]
    assert len(elig) >= min_elig, f"{name}: too few eligible kps {len(elig)}"

    p1 = _kp_rc(kp1)
    s0 = np.asarray(kp0["scale"])
    s1 = np.asarray(kp1["scale"])
    # expected scale under the anisotropic map: geometric mean of the two
    # singular values = zoom / sqrt(tilt)
    s_fac = zoom / np.sqrt(tilt)
    hits = 0
    for i in elig:
        d = np.hypot(p1[:, 0] - mapped[i, 0], p1[:, 1] - mapped[i, 1])
        near = d < TOL_PX
        if not near.any():
            continue
        exp_s = s0[i] * s_fac
        ratio = s1[near] / max(exp_s, 1e-6)
        if ((ratio < SCALE_BAND) & (ratio > 1.0 / SCALE_BAND)).any():
            hits += 1
    rep = hits / len(elig)

    # --- ratio-test match precision ----------------------------------------
    mp = MatchPlan()
    m = mp.match(kp0, kp1)
    prec = 1.0
    n_match = len(m)
    if n_match:
        pa = np.stack([m[:, 0]["y"], m[:, 0]["x"]], -1)
        pb = np.stack([m[:, 1]["y"], m[:, 1]["x"]], -1)
        pa_m = pa @ A.T + b
        good = np.hypot(*(pb - pa_m).T) < MATCH_TOL_PX
        prec = float(good.mean())
    print(f"[invariance] {scene}/{name}: repeatability {rep:.3f} "
          f"({hits}/{len(elig)}), matches {n_match}, precision {prec:.3f}")

    assert rep >= min_rep, (
        f"{scene}/{name}: repeatability {rep:.3f} < {min_rep} "
        f"({hits}/{len(elig)})")
    assert n_match >= min_match, (
        f"{scene}/{name}: only {n_match} ratio-test matches (< {min_match})")
    assert prec >= min_prec, (
        f"{scene}/{name}: match precision {prec:.3f} < {min_prec} "
        f"over {n_match}")


@pytest.mark.slow
def test_zoom_out_double_im_size_recovers(plan):
    """Regression fence for the zoom-axis diagnosis (PARITY.md, r5): the
    0.5x zoom-out repeatability deficit is a representable-scale-floor
    issue, and detecting the ZOOMED-OUT image with `double_im_size=True`
    (the reference's par.DoubleImSize remedy — adds the -1 octave) must
    keep recovering it: measured 0.707 -> 0.880 repeatability and
    39 -> 53 matches on the calibration scene (tools/diag_zoom.py)."""
    from sift_pyocl_jax import SiftConfig

    img = synthetic_scene(SHAPE, n_blobs=90, seed=7)
    kp0 = plan.keypoints(img)
    plan_d = SiftPlan(SHAPE, "float32",
                      config=SiftConfig(double_im_size=True))
    A, b = _forward_affine(0.0, 0.5, SHAPE)
    warped = _warp(img, A, b)
    kp1 = plan_d.keypoints(warped)

    p0 = _kp_rc(kp0)
    p1 = _kp_rc(kp1)
    mapped = p0 @ A.T + b
    h, w = SHAPE
    inside = ((mapped[:, 0] > MARGIN) & (mapped[:, 0] < h - 1 - MARGIN)
              & (mapped[:, 1] > MARGIN) & (mapped[:, 1] < w - 1 - MARGIN))
    elig = np.where(inside)[0]
    s0 = np.asarray(kp0["scale"])
    s1 = np.asarray(kp1["scale"])
    hits = 0
    for i in elig:
        d = np.hypot(p1[:, 0] - mapped[i, 0], p1[:, 1] - mapped[i, 1])
        near = d < TOL_PX
        if near.any():
            ratio = s1[near] / max(s0[i] * 0.5, 1e-6)
            if ((ratio < SCALE_BAND) & (ratio > 1.0 / SCALE_BAND)).any():
                hits += 1
    rep = hits / len(elig)
    m = MatchPlan().match(kp0, kp1)
    print(f"[invariance] double_im_size zoom_out: repeatability {rep:.3f} "
          f"({hits}/{len(elig)}), matches {len(m)}")
    # measured 0.880 / 53; frozen with ~15% margin (default-config floor
    # for the same warp is 0.55 — the recovery must stay well above it)
    assert rep >= 0.75, rep
    assert len(m) >= 40, len(m)


@pytest.mark.slow
def test_rotation_rotates_keypoint_angles(scene_and_kp, plan):
    """Matched keypoints' orientations must rotate with the image (the
    orientation-assignment analog of repeatability)."""
    scene, img, kp0 = scene_and_kp
    th = np.deg2rad(30.0)
    A, b = _forward_affine(30.0, 1.0, SHAPE)
    kp1 = plan.keypoints(_warp(img, A, b))
    m = MatchPlan().match(kp0, kp1)
    assert len(m) >= 10
    # image rows grow downward: a +th image rotation shifts gradient
    # orientations by -th in the (x, y)-math convention used for angles
    da = np.asarray(m[:, 1]["angle"]) - np.asarray(m[:, 0]["angle"])
    da = np.mod(da + th + np.pi, 2 * np.pi) - np.pi
    frac = float((np.abs(da) < 0.30).mean())
    print(f"[invariance] {scene} angle consistency: {frac:.3f} of {len(m)}")
    # calibration measured 1.000 (blobs) / >=0.97 (texture); frozen w/margin
    assert frac >= 0.90, f"only {frac:.2f} of matches rotate their angle"
