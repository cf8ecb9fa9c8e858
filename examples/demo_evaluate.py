#!/usr/bin/env python
"""Demo: sequence ATE evaluation from files on disk.

Renders an out-and-back loop trajectory, writes it as PGM frames + a
TUM-format ground-truth file, then runs the evaluation CLI
(`python -m sift_pyocl_jax.evaluate`) over the directory — the same flow a
user follows with a real dataset on disk.

Usage: python examples/demo_evaluate.py [--out DIR] [--frames N]
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="output dir (default: temp)")
    ap.add_argument("--frames", type=int, default=10)
    args = ap.parse_args()

    from sift_pyocl_jax.evaluate import main as eval_main, save_sequence
    from sift_pyocl_jax.utils.render3d import render_sequence

    out = args.out or tempfile.mkdtemp(prefix="sift_eval_demo_")
    print(f"rendering {args.frames}-frame loop sequence -> {out}")
    K, frames, gtR, gtT = render_sequence(
        n_frames=args.frames, n_points=120, image_size=(320, 240), seed=0,
        arc_deg=30.0, out_and_back=True,
    )
    seq_dir, gt_path = save_sequence(out, frames, gtR, gtT)
    print("running: python -m sift_pyocl_jax.evaluate "
          f"--frames {seq_dir} --gt {gt_path} --fx {float(K[0,0])}")
    rc = eval_main([
        "--frames", str(seq_dir), "--gt", str(gt_path),
        "--mode", "sfm", "--fx", str(float(K[0, 0])),
    ])
    return rc


if __name__ == "__main__":
    sys.exit(main())
