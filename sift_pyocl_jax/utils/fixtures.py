"""Reference test-image fixture ingestion.

The reference's test harness (reference: test/utilstest.py) downloads its
classic test images (e.g. the 512x512 image) over HTTP with a local cache.
This environment has no network, so the equivalent here is a disk-ingestion
path: drop image files into a fixtures directory (or point
SIFT_PYOCL_FIXTURES at one) and `reference_test_image(name)` serves them to
the parity tests; tests skip cleanly when a fixture is absent.  This is the
missing piece for closing BASELINE config 1 ("parity vs reference keypoints
on its test images") the moment real images are available.

Supported formats: .pgm/.ppm (via utils.framesource decoding), .npy, and
raw .f32 with a sidecar "<name>.shape" file of "H W".
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import List, Optional

import numpy as np

DEFAULT_DIRS = [
    Path(__file__).resolve().parent.parent.parent / "fixtures",
    Path.home() / ".cache" / "sift_pyocl_jax" / "fixtures",
]


def fixture_dirs() -> List[Path]:
    dirs = []
    env = os.environ.get("SIFT_PYOCL_FIXTURES")
    if env:
        dirs.append(Path(env))
    dirs.extend(DEFAULT_DIRS)
    return [d for d in dirs if d.is_dir()]


def _load(path: Path) -> np.ndarray:
    if path.suffix == ".npy":
        arr = np.load(path)
        if arr.ndim == 3:
            arr = arr[..., :3].astype(np.float32) @ np.array(
                [0.299, 0.587, 0.114], np.float32
            )
        return arr.astype(np.float32)
    if path.suffix.lower() in (".pgm", ".ppm", ".png", ".jpg", ".jpeg",
                               ".tif", ".tiff", ".bmp"):
        from ..evaluate import probe_pgm_shape
        from .framesource import _decode_numpy

        return _decode_numpy(path, probe_pgm_shape(path))
    if path.suffix == ".f32":
        shape_file = path.with_suffix(".shape")
        h, w = (int(v) for v in shape_file.read_text().split())
        return np.fromfile(path, np.float32, h * w).reshape(h, w)
    raise ValueError(f"unsupported fixture format: {path}")


def reference_test_image(name: str) -> Optional[np.ndarray]:
    """Float32 grayscale fixture image by stem name, or None if absent.

    >>> img = reference_test_image("lena")   # looks for lena.{pgm,ppm,npy,f32}
    """
    for d in fixture_dirs():
        for suffix in (".pgm", ".ppm", ".png", ".jpg", ".jpeg", ".npy",
                       ".f32"):
            p = d / f"{name}{suffix}"
            if p.is_file():
                return _load(p)
    return None
