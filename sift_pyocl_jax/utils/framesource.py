"""Streaming frame source with native double-buffered prefetch.

Feeds the video frontend (parallel/video.py — BASELINE.json config 3): the
C++ loader (native/framesource.cpp) decodes the NEXT frame on a background
thread while the caller ships the CURRENT one to the device, overlapping host
IO with device compute.  Falls back to a synchronous NumPy reader when no C++
toolchain is present (identical output, PGM/PPM/raw-f32 formats).
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Iterator, List, Sequence, Tuple, Union

import numpy as np


PIL_SUFFIXES = (".png", ".jpg", ".jpeg", ".tif", ".tiff", ".bmp")


def _decode_numpy(path: Path, shape: Tuple[int, int]) -> np.ndarray:
    H, W = shape
    if path.suffix == ".f32":
        return np.fromfile(path, dtype=np.float32, count=H * W).reshape(H, W)
    if path.suffix.lower() in PIL_SUFFIXES:
        # real benchmark sequences (TUM/KITTI) ship PNGs; PIL is optional
        from PIL import Image

        img = np.asarray(Image.open(path).convert("L"), dtype=np.float32)
        if img.shape != (H, W):
            raise ValueError(f"{path}: {img.shape} != expected {(H, W)}")
        return img
    data = path.read_bytes()
    if not data.startswith((b"P5", b"P6")):
        raise ValueError(f"unsupported format: {path}")
    # parse 3 header ints, skipping comments
    vals: List[int] = []
    i = 2
    while len(vals) < 3:
        while i < len(data) and data[i : i + 1].isspace():
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
    i += 1  # single whitespace after maxval
    w, h, maxval = vals
    if (h, w) != (H, W):
        raise ValueError(f"{path}: {h}x{w} != expected {H}x{W}")
    ch = 3 if data.startswith(b"P6") else 1
    if maxval < 256:
        px = np.frombuffer(data, np.uint8, h * w * ch, i).astype(np.float32)
    else:
        px = (
            np.frombuffer(data, ">u2", h * w * ch, i).astype(np.float32)
        )
    if ch == 3:
        px = px.reshape(h, w, 3) @ np.array(
            [0.299, 0.587, 0.114], np.float32
        )
    return px.reshape(h, w)


class FrameSource:
    """Iterate float32 grayscale frames from PGM/PPM/.f32 files.

    >>> for idx, frame in FrameSource(paths, (480, 640)):
    ...     plan.keypoints(frame)
    """

    def __init__(self, paths: Sequence[Union[str, Path]],
                 shape: Tuple[int, int], native: bool = True):
        from ..native import get_lib

        self.paths = [str(p) for p in paths]
        self.shape = tuple(shape)
        # the C++ loader decodes PGM/PPM/.f32; PNG/JPEG routes through PIL
        if any(Path(p).suffix.lower() in PIL_SUFFIXES for p in self.paths):
            native = False
        self._lib = get_lib() if native else None
        self.backend = "native" if self._lib is not None else "numpy"

    def __iter__(self) -> Iterator[Tuple[int, np.ndarray]]:
        H, W = self.shape
        if self._lib is None:
            for i, p in enumerate(self.paths):
                yield i, _decode_numpy(Path(p), self.shape)
            return
        arr = (ctypes.c_char_p * len(self.paths))(
            *[p.encode() for p in self.paths]
        )
        handle = self._lib.fs_open(arr, len(self.paths), H, W)
        try:
            out = np.empty((H, W), np.float32)
            while True:
                idx = self._lib.fs_next(
                    handle, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
                )
                if idx == -1:
                    return
                if idx == -2:
                    raise IOError("frame decode failed")
                yield int(idx), out.copy()
        finally:
            self._lib.fs_close(handle)
