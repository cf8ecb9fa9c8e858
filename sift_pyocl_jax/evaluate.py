"""Standard-sequence trajectory evaluation CLI.

    python -m sift_pyocl_jax.evaluate --frames DIR --gt poses.txt \
        [--mode sfm|vo] [--fx F] [--shape H W]

Runs the SfM pipeline (or the fused VO loop) over a directory of PGM/PPM/.f32
frames loaded through utils.framesource.FrameSource and reports ATE RMSE
against a ground-truth trajectory — the BASELINE.json "ATE within reference
bounds on standard benchmark sequences" criterion, made runnable from files
on disk.  Ground-truth formats, auto-detected per line:

  * TUM:    timestamp tx ty tz qx qy qz qw   (camera centers = t)
  * KITTI:  r11 r12 r13 tx r21 ... tz        (3x4 cam-to-world, centers = t)
  * plain:  cx cy cz                         (centers directly)

Prints ONE JSON line: {"ate_rmse": ..., "n_frames": N, "n_registered": M,
"mode": "..."}.  No reference counterpart (the reference is a per-image
library); the protocol follows the standard TUM ATE evaluation.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from .sfm.evaluate import ate_rmse, camera_centers

FRAME_SUFFIXES = (".pgm", ".ppm", ".f32", ".png", ".jpg", ".jpeg")


def probe_pgm_shape(path: Path) -> Tuple[int, int]:
    """(H, W) from a PGM/PPM header (or any PIL-readable image)."""
    if path.suffix.lower() not in (".pgm", ".ppm"):
        from PIL import Image

        with Image.open(path) as im:
            w, h = im.size
        return h, w
    data = path.read_bytes()[:256]
    if not data.startswith((b"P5", b"P6")):
        raise ValueError(f"{path}: cannot probe shape (not PGM/PPM)")
    vals: List[int] = []
    i = 2
    while len(vals) < 2:
        while data[i : i + 1].isspace():
            i += 1
        if data[i : i + 1] == b"#":
            while data[i : i + 1] != b"\n":
                i += 1
            continue
        j = i
        while not data[j : j + 1].isspace():
            j += 1
        vals.append(int(data[i:j]))
        i = j
    w, h = vals
    return h, w


def load_gt_centers(path: Path) -> np.ndarray:
    """(N, 3) camera centers from a TUM / KITTI / plain trajectory file."""
    rows = []
    for line in path.read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        vals = [float(v) for v in line.split()]
        if len(vals) == 8:        # TUM: t x y z qx qy qz qw
            rows.append(vals[1:4])
        elif len(vals) == 12:     # KITTI 3x4 row-major cam-to-world
            rows.append([vals[3], vals[7], vals[11]])
        elif len(vals) == 3:      # plain centers
            rows.append(vals)
        else:
            raise ValueError(f"unrecognized gt line ({len(vals)} fields)")
    return np.asarray(rows, np.float64)


def save_sequence(
    out_dir, frames, gtR: np.ndarray, gtT: np.ndarray
) -> Tuple[Path, Path]:
    """Write frames as PGM and the trajectory as a TUM gt file (for demos
    and for testing this CLI end-to-end without network datasets)."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    for i, f in enumerate(frames):
        u8 = np.clip(np.asarray(f), 0, 255).astype(np.uint8)
        h, w = u8.shape
        (out / f"frame_{i:05d}.pgm").write_bytes(
            b"P5\n%d %d\n255\n" % (w, h) + u8.tobytes()
        )
    centers = camera_centers(gtR, gtT)
    lines = []
    for i, c in enumerate(centers):
        # identity quaternion: only centers are used by the ATE protocol
        lines.append(f"{i:.1f} {c[0]:.8f} {c[1]:.8f} {c[2]:.8f} 0 0 0 1")
    gt_path = out / "groundtruth.txt"
    gt_path.write_text("\n".join(lines) + "\n")
    return out, gt_path


def quat_from_R(R: np.ndarray) -> np.ndarray:
    """Unit quaternion (x, y, z, w) from a rotation matrix (Shepperd)."""
    m = R
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (m[2, 1] - m[1, 2]) / s
        y = (m[0, 2] - m[2, 0]) / s
        z = (m[1, 0] - m[0, 1]) / s
    else:
        i = int(np.argmax(np.diag(m)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(1.0 + m[i, i] - m[j, j] - m[k, k], 1e-12)) * 2
        q = np.zeros(4)
        q[i] = 0.25 * s
        q[3] = (m[k, j] - m[j, k]) / s
        q[j] = (m[j, i] + m[i, j]) / s
        q[k] = (m[k, i] + m[i, k]) / s
        x, y, z, w = q
    q = np.array([x, y, z, w], np.float64)
    return q / np.linalg.norm(q)


def save_trajectory_tum(path, Rs: np.ndarray, ts: np.ndarray,
                        stamps=None) -> None:
    """Write poses as TUM lines: `t tx ty tz qx qy qz qw` (camera-to-world:
    center = -R^T t, orientation = R^T)."""
    centers = camera_centers(Rs, ts)
    lines = []
    for i, (R, c) in enumerate(zip(Rs, centers)):
        q = quat_from_R(np.asarray(R, np.float64).T)
        s = stamps[i] if stamps is not None else float(i)
        lines.append(
            f"{s:.6f} {c[0]:.8f} {c[1]:.8f} {c[2]:.8f} "
            f"{q[0]:.8f} {q[1]:.8f} {q[2]:.8f} {q[3]:.8f}"
        )
    Path(path).write_text("\n".join(lines) + "\n")


def run_sfm(K, frames, shape, **kw):
    from .sfm.pipeline import IncrementalSfM

    sfm = IncrementalSfM(K, shape, **kw)
    res = sfm.run(frames)
    if res is None:
        return None, [], None
    return (camera_centers(res.Rs, res.ts), res.frames_registered,
            (np.asarray(res.Rs), np.asarray(res.ts)))


def run_vo(K, frames, shape):
    import jax.numpy as jnp

    from .config import SiftConfig
    from .models.vo import VOConfig, vo_init, vo_step

    cfg = SiftConfig()
    vo = VOConfig()
    Kj = jnp.asarray(K)
    st = vo_init(jnp.asarray(frames[0]), Kj, cfg, vo)
    Rs = [np.eye(3, dtype=np.float32)]
    ts = [np.zeros(3, np.float32)]
    for f in frames[1:]:
        st, out = vo_step(st, jnp.asarray(f), Kj, cfg, vo)
        Rs.append(np.asarray(out.R))
        ts.append(np.asarray(out.t))
    Rs, ts = np.stack(Rs), np.stack(ts)
    return camera_centers(Rs, ts), list(range(len(frames))), (Rs, ts)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", required=True, help="directory of PGM/PPM/.f32")
    ap.add_argument("--gt", required=True, help="trajectory file (TUM/KITTI/xyz)")
    ap.add_argument("--mode", choices=("sfm", "vo"), default="sfm")
    ap.add_argument("--shape", type=int, nargs=2, default=None,
                    help="H W (default: probed from the first PGM)")
    ap.add_argument("--fx", type=float, default=None,
                    help="focal length px (default: max(H,W) heuristic)")
    ap.add_argument("--cx", type=float, default=None)
    ap.add_argument("--cy", type=float, default=None)
    ap.add_argument("--no-scale", action="store_true",
                    help="ATE without sim(3) scale alignment")
    ap.add_argument("--save-traj", default=None, metavar="PATH",
                    help="write the estimated trajectory in TUM format "
                         "(t tx ty tz qx qy qz qw; camera-to-world)")
    args = ap.parse_args(argv)

    frame_dir = Path(args.frames)
    paths = sorted(
        p for p in frame_dir.iterdir() if p.suffix.lower() in FRAME_SUFFIXES
    )
    if not paths:
        print(json.dumps({"error": f"no frames in {frame_dir}"}))
        return 1
    if args.shape:
        shape = tuple(args.shape)
    elif paths[0].suffix == ".f32":
        print(json.dumps({"error": "raw .f32 frames need --shape H W"}))
        return 1
    else:
        shape = probe_pgm_shape(paths[0])
    fx = args.fx if args.fx else float(max(shape))
    cx = args.cx if args.cx is not None else shape[1] / 2
    cy = args.cy if args.cy is not None else shape[0] / 2
    K = np.array([[fx, 0, cx], [0, fx, cy], [0, 0, 1]], np.float32)

    from .utils.framesource import FrameSource

    frames = [f for _, f in FrameSource(paths, shape)]
    gt = load_gt_centers(Path(args.gt))

    if args.mode == "vo":
        est, reg, pose_arrays = run_vo(K, frames, shape)
    else:
        est, reg, pose_arrays = run_sfm(K, frames, shape)
    if est is None or len(reg) < 3:
        print(json.dumps({"error": "trajectory estimation failed",
                          "n_registered": len(reg or [])}))
        return 1
    if args.save_traj and pose_arrays is not None:
        save_trajectory_tum(args.save_traj, *pose_arrays, stamps=reg)
    if len(gt) < len(frames):
        print(json.dumps({"error": f"gt has {len(gt)} poses for "
                          f"{len(frames)} frames"}))
        return 1
    ate = ate_rmse(est, gt[reg], with_scale=not args.no_scale)
    print(json.dumps({
        "ate_rmse": round(float(ate), 6),
        "n_frames": len(frames),
        "n_registered": len(reg),
        "mode": args.mode,
        "shape": list(shape),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
