"""Native + NumPy frame-source parity (PGM/PPM/raw-f32 decode, prefetch)."""

import numpy as np
import pytest

from sift_pyocl_jax.utils.framesource import FrameSource, _decode_numpy


def _write_pgm(path, img, maxval=255):
    h, w = img.shape
    with open(path, "wb") as f:
        f.write(f"P5\n# test\n{w} {h}\n{maxval}\n".encode())
        if maxval < 256:
            f.write(img.astype(np.uint8).tobytes())
        else:
            f.write(img.astype(">u2").tobytes())


def _write_ppm(path, rgb):
    h, w, _ = rgb.shape
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(rgb.astype(np.uint8).tobytes())


@pytest.fixture()
def frames_dir(tmp_path):
    rng = np.random.default_rng(0)
    paths, want = [], []
    h, w = 24, 32
    g8 = rng.integers(0, 255, (h, w))
    _write_pgm(tmp_path / "a.pgm", g8)
    paths.append(tmp_path / "a.pgm")
    want.append(g8.astype(np.float32))

    g16 = rng.integers(0, 65535, (h, w))
    _write_pgm(tmp_path / "b.pgm", g16, maxval=65535)
    paths.append(tmp_path / "b.pgm")
    want.append(g16.astype(np.float32))

    rgb = rng.integers(0, 255, (h, w, 3))
    _write_ppm(tmp_path / "c.ppm", rgb)
    paths.append(tmp_path / "c.ppm")
    want.append(
        (rgb.astype(np.float32) @ np.array([0.299, 0.587, 0.114], np.float32))
    )

    raw = rng.uniform(0, 255, (h, w)).astype(np.float32)
    raw.tofile(tmp_path / "d.f32")
    paths.append(tmp_path / "d.f32")
    want.append(raw)
    return paths, want, (h, w)


@pytest.mark.parametrize("native", [False, True])
def test_framesource_decodes_all_formats(frames_dir, native):
    paths, want, shape = frames_dir
    fs = FrameSource(paths, shape, native=native)
    if native and fs.backend != "native":
        pytest.skip("no C++ toolchain available")
    got = list(fs)
    assert [i for i, _ in got] == list(range(len(paths)))
    for (_, g), w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=5e-3)


def test_native_matches_numpy(frames_dir):
    paths, _, shape = frames_dir
    nat = FrameSource(paths, shape, native=True)
    if nat.backend != "native":
        pytest.skip("no C++ toolchain available")
    ref = [f for _, f in FrameSource(paths, shape, native=False)]
    for (_, g), w in zip(nat, ref):
        np.testing.assert_allclose(g, w, atol=5e-3)


def test_png_frames_via_pil(tmp_path):
    """PNG sequences (the format real TUM/KITTI data ships in) decode
    through the PIL fallback path."""
    PIL = pytest.importorskip("PIL.Image")
    import numpy as np

    from sift_pyocl_jax.utils.framesource import FrameSource

    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 255, (32, 40)).astype("uint8") for _ in range(3)]
    paths = []
    for i, im in enumerate(imgs):
        p = tmp_path / f"f{i:03d}.png"
        PIL.fromarray(im, mode="L").save(p)
        paths.append(p)
    fs = FrameSource(paths, (32, 40))
    assert fs.backend == "numpy"
    out = list(fs)
    assert len(out) == 3
    for (idx, frame), im in zip(out, imgs):
        np.testing.assert_allclose(frame, im.astype(np.float32))
