"""Per-stage timing harness (parity for the reference's event profiling,
reference: sift-src/plan.py::log_profile — SURVEY.md §5).

Under XLA the pipeline is one fused program, so per-kernel event times do
not exist; this reports wall-clock per cumulative pipeline stage with
utils.benchtool.chained_ms.  Stage costs are the deltas between successive
cumulative rows.
"""

from __future__ import annotations

from typing import Dict

import jax.numpy as jnp
import numpy as np

from .benchtool import chained_ms


def stage_times(plan, image=None, n_hi: int = 9, reps: int = 2) -> Dict[str, float]:
    """Cumulative millisecond timings (each row includes the previous ones):
    pyramid -> +detect -> +orient -> full (= end_to_end)."""
    from ..models.sift import describe_octaves, octave_capacities
    from ..ops.detect import detect_octave
    from ..ops.orient_desc import assign_orientations, gradient_planes
    from ..ops.pyramid import build_scale_space_jax

    cfg = plan.cfg
    if image is None:
        rng = np.random.default_rng(0)
        image = rng.uniform(0, 255, plan.shape).astype(np.float32)
    img = jnp.asarray(image, dtype=jnp.float32)
    caps = octave_capacities(plan.shape, cfg)

    def upto(stage):
        def f(c):
            octs = build_scale_space_jax(c, cfg)
            acc = [b.sum() + d.sum() for b, d in octs]
            if stage == "pyramid":
                return {"s": acc}
            if stage == "full":
                b = describe_octaves(octs, plan.shape, cfg)
                acc += [b.x.sum(), b.angle.sum(),
                        b.desc.astype(jnp.float32).sum(), b.valid.sum()]
                return {"s": acc}
            for o, (blurs, dogs) in enumerate(octs):
                kps = detect_octave(dogs, cfg, o, caps[o][0])
                acc.append(kps.fr.sum() + kps.valid.sum())
                if stage == "detect":
                    continue
                mags, oris = gradient_planes(blurs, cfg)
                okps = assign_orientations(mags, oris, kps, cfg, caps[o][1])
                acc.append(okps.angle.sum() + okps.valid.sum())
            return {"s": acc}

        return f

    times = {}
    for stage in ("pyramid", "detect", "orient", "full"):
        key = {"full": "end_to_end_ms"}.get(stage, f"upto_{stage}_ms")
        times[key] = round(
            chained_ms(upto(stage), img, n_hi=n_hi, reps=reps), 3
        )
    return times
