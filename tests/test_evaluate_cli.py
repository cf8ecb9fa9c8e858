"""End-to-end test of the ATE evaluation CLI: render a sequence to disk as
PGM + TUM ground truth, run `python -m sift_pyocl_jax.evaluate` logic, and
check the reported ATE (one command, files on disk -> ATE)."""

import json

import numpy as np
import pytest

from sift_pyocl_jax.evaluate import (
    load_gt_centers,
    main,
    probe_pgm_shape,
    save_sequence,
)
from sift_pyocl_jax.sfm.evaluate import camera_centers
from sift_pyocl_jax.utils.render3d import render_sequence


def test_gt_parsers(tmp_path):
    p = tmp_path / "tum.txt"
    p.write_text("# comment\n0.0 1 2 3 0 0 0 1\n1.0 4 5 6 0 0 0 1\n")
    np.testing.assert_allclose(load_gt_centers(p), [[1, 2, 3], [4, 5, 6]])
    p2 = tmp_path / "kitti.txt"
    p2.write_text("1 0 0 9 0 1 0 8 0 0 1 7\n")
    np.testing.assert_allclose(load_gt_centers(p2), [[9, 8, 7]])
    p3 = tmp_path / "xyz.txt"
    p3.write_text("1 2 3\n")
    np.testing.assert_allclose(load_gt_centers(p3), [[1, 2, 3]])


def test_save_and_probe_roundtrip(tmp_path):
    frames = [np.linspace(0, 255, 48 * 64, dtype=np.float32).reshape(48, 64)]
    R = np.eye(3, dtype=np.float32)[None]
    t = np.zeros((1, 3), np.float32)
    out, gt = save_sequence(tmp_path / "seq", frames, R, t)
    pgm = sorted(out.glob("*.pgm"))[0]
    assert probe_pgm_shape(pgm) == (48, 64)
    np.testing.assert_allclose(load_gt_centers(gt), camera_centers(R, t))


@pytest.mark.slow
def test_evaluate_cli_sfm_ate(tmp_path, capsys):
    K, frames, gtR, gtT = render_sequence(
        n_frames=7, n_points=70, image_size=(320, 240), seed=0, arc_deg=25.0
    )
    seq_dir, gt_path = save_sequence(tmp_path / "seq", frames, gtR, gtT)
    rc = main([
        "--frames", str(seq_dir), "--gt", str(gt_path),
        "--mode", "sfm", "--fx", str(float(K[0, 0])),
    ])
    out = capsys.readouterr().out.strip().splitlines()[-1]
    rep = json.loads(out)
    assert rc == 0, rep
    assert rep["n_registered"] >= 6
    # PGM u8 quantization costs some accuracy vs the float test (0.08 bound)
    assert rep["ate_rmse"] < 0.15, rep


def test_quat_from_R_roundtrip():
    from sift_pyocl_jax.evaluate import quat_from_R

    rng = np.random.default_rng(0)
    for _ in range(20):
        a = rng.normal(size=3)
        th = np.linalg.norm(a)
        k = a / th
        Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        R = np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx
        x, y, z, w = quat_from_R(R)
        # rebuild R from the quaternion
        R2 = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ])
        np.testing.assert_allclose(R2, R, atol=1e-9)


def test_save_trajectory_tum_roundtrip(tmp_path):
    """--save-traj output parses as TUM gt with matching centers."""
    from sift_pyocl_jax.evaluate import save_trajectory_tum

    rng = np.random.default_rng(1)
    n = 5
    Rs = []
    for _ in range(n):
        a = rng.normal(size=3) * 0.3
        th = np.linalg.norm(a)
        k = a / th
        Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        Rs.append(np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx)
    Rs = np.stack(Rs)
    ts = rng.normal(size=(n, 3))
    p = tmp_path / "traj.txt"
    save_trajectory_tum(p, Rs, ts)
    got = load_gt_centers(p)
    np.testing.assert_allclose(got, camera_centers(Rs, ts), atol=1e-6)
