"""Zoom-axis diagnosis for the invariance battery.

The battery's zoom repeatability (0.71/0.74 at 0.5x/2x on the blob scene)
is its weakest axis.  Hypotheses: (a) inherent to a +-1-octave scale change
(the detector can only re-find a keypoint if the shifted scale still lands
inside the sampled sigma ladder — boundary octaves lose their partners);
(b) a pipeline deficiency that the reference's own remedies would fix:
`DoubleImSize` (par.DoubleImSize — adds a -1 octave so fine scales survive
zoom-out... and zoom-in keypoints that map BELOW octave 0 are recovered) or
more `Scales` per octave (finer sigma sampling).

This tool measures the battery's zoom protocol under: default config,
double_im_size=True (on the original, the warped, and both), and scales=5.
Results are recorded in PARITY.md ("Zoom-axis diagnosis" table).

CPU-friendly (256^2 scene); run: python tools/diag_zoom.py
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def repeatability(kp0, kp1, A, b, shape, zoom, tol_px=2.0, margin=12.0,
                  scale_band=1.7):
    p0 = np.stack([np.asarray(kp0["y"]), np.asarray(kp0["x"])], -1)
    p1 = np.stack([np.asarray(kp1["y"]), np.asarray(kp1["x"])], -1)
    mapped = p0 @ A.T + b
    h, w = shape
    inside = ((mapped[:, 0] > margin) & (mapped[:, 0] < h - 1 - margin)
              & (mapped[:, 1] > margin) & (mapped[:, 1] < w - 1 - margin))
    elig = np.where(inside)[0]
    s0 = np.asarray(kp0["scale"])
    s1 = np.asarray(kp1["scale"])
    hits = 0
    for i in elig:
        d = np.hypot(p1[:, 0] - mapped[i, 0], p1[:, 1] - mapped[i, 1])
        near = d < tol_px
        if not near.any():
            continue
        ratio = s1[near] / max(s0[i] * zoom, 1e-6)
        if ((ratio < scale_band) & (ratio > 1.0 / scale_band)).any():
            hits += 1
    return hits, len(elig)


def main():
    from sift_pyocl_jax import MatchPlan, SiftPlan, SiftConfig
    from sift_pyocl_jax.ops.transform import affine_warp_jax
    from sift_pyocl_jax.utils.testimage import synthetic_scene

    shape = (256, 256)
    img = synthetic_scene(shape, n_blobs=90, seed=7)
    cfgs = {
        "default": (SiftConfig(), SiftConfig()),
        # DoubleImSize on BOTH sides (the reference's global par flag)
        "double_both": (SiftConfig(double_im_size=True),
                        SiftConfig(double_im_size=True)),
        # asymmetric: double only the side that lost fine scales
        "double_warped": (SiftConfig(), SiftConfig(double_im_size=True)),
        "scales5": (SiftConfig(scales=5), SiftConfig(scales=5)),
    }
    plans = {}

    def plan_for(cfg):
        if cfg not in plans:
            plans[cfg] = SiftPlan(shape, "float32", config=cfg)
        return plans[cfg]

    mp = MatchPlan()
    for label, (cfg0, cfg1) in cfgs.items():
        kp0 = plan_for(cfg0).keypoints(img)
        for zoom in (0.5, 2.0):
            A = zoom * np.eye(2)
            c = np.array([(shape[0] - 1) / 2.0, (shape[1] - 1) / 2.0])
            b = c - A @ c
            Ainv = np.linalg.inv(A)
            off = -Ainv @ b
            warped = np.asarray(affine_warp_jax(
                img, Ainv.astype(np.float32), off.astype(np.float32)))
            kp1 = plan_for(cfg1).keypoints(warped)
            hits, n_elig = repeatability(kp0, kp1, A, b, shape, zoom)
            m = mp.match(kp0, kp1)
            n_match = len(m)
            prec = 1.0
            if n_match:
                pa = np.stack([m[:, 0]["y"], m[:, 0]["x"]], -1)
                pb = np.stack([m[:, 1]["y"], m[:, 1]["x"]], -1)
                good = np.hypot(*(pb - (pa @ A.T + b)).T) < 3.0
                prec = float(good.mean())
            print(json.dumps({
                "config": label, "zoom": zoom,
                "kp0": len(kp0), "kp1": len(kp1),
                "repeatability": round(hits / max(n_elig, 1), 3),
                "eligible": n_elig, "matches": n_match,
                "precision": round(prec, 3),
            }), flush=True)


if __name__ == "__main__":
    main()
