"""sift_pyocl_jax — SIFT frontend + SfM engine in JAX, for NVIDIA GPUs.

A from-scratch JAX re-architecture with the full capability surface of
the reference PyOpenCL SIFT library (pierrepaleo/sift_pyocl): scale-space
pyramid, DoG extrema detection with subpixel refinement, orientation and
128-d descriptors, ratio-test matching, image alignment — extended with a
distributed SfM/bundle-adjustment backend the reference never had.

Public API mirrors the reference package (reference: sift-src/__init__.py):
    SiftPlan, MatchPlan, LinearAlign, par, KP_DTYPE
JAX additions:
    SiftConfig, detect_and_describe (jittable), match_descriptors_jax, sfm.*
"""

import jax as _jax

# XLA may run float32 matmuls and convolutions in reduced precision by
# default (TF32 on NVIDIA tensor cores), which injects ~0.1-0.5% error into
# geometry solves (triangulation, BA, 8-point fits) and breaks oracle
# parity.  SIFT/SfM is precision-sensitive numerical code, so the framework
# defaults every f32 matmul to full precision; hot kernels that tolerate
# reduced precision opt back in explicitly at the call site (the best-2
# matcher feeds exact uint8 values to the tensor cores as bf16).
_jax.config.update("jax_default_matmul_precision", "highest")

from .config import SiftConfig, par, config_from_par  # noqa: F401
from .oracle import KP_DTYPE  # noqa: F401
from .models.sift import SiftPlan, detect_and_describe, KeypointBuffer  # noqa: F401
from .models.match_align import MatchPlan, LinearAlign, fit_affine  # noqa: F401
from .ops.match import match_descriptors_jax, MatchResult  # noqa: F401

__version__ = "0.1.0"
