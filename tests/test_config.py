import math

from sift_pyocl_jax.config import SiftConfig, config_from_par, par


def test_reference_defaults():
    cfg = SiftConfig()
    assert cfg.init_sigma == 1.6
    assert cfg.border_dist == 5
    assert cfg.scales == 3
    assert abs(cfg.peak_thresh - 255.0 * 0.04 / 3.0) < 1e-12
    assert cfg.edge_thresh == 0.06
    assert cfg.edge_thresh1 == 0.08
    assert cfg.match_ratio == 0.73
    assert not cfg.double_im_size


def test_sigma_ladder():
    cfg = SiftConfig()
    lad = cfg.sigma_ladder()
    assert len(lad) == cfg.scales + 3
    assert lad[0] == 1.6
    assert abs(lad[cfg.scales] - 3.2) < 1e-12  # doubles after S intervals
    inc = cfg.sigma_increments()
    for s in range(1, len(lad)):
        assert abs(math.sqrt(lad[s - 1] ** 2 + inc[s - 1] ** 2) - lad[s]) < 1e-9


def test_octave_count():
    cfg = SiftConfig()
    assert cfg.n_octaves((512, 512)) == 6   # 512 .. 16 (13 stops)
    assert cfg.n_octaves((16, 16)) == 1
    assert SiftConfig(double_im_size=True).n_octaves((256, 256)) == 6


def test_par_bridge():
    assert par["InitSigma"] == 1.6
    cfg = config_from_par(dict(par, Scales=4, EdgeThresh=0.1))
    assert cfg.scales == 4
    assert cfg.edge_thresh == 0.1
    assert cfg.init_sigma == 1.6


def test_matchplan_padding_buckets():
    """MatchPlan(size=) honors a stable compile footprint."""
    from sift_pyocl_jax.models.match_align import MatchPlan

    mp = MatchPlan(size=1024)
    import numpy as np
    from sift_pyocl_jax.oracle import KP_DTYPE

    kp = np.zeros(300, KP_DTYPE)
    d, m, xy = mp._padded(kp, np.ones(300, bool))
    assert d.shape == (512, 128) and m.sum() == 300
    kp2 = np.zeros(900, KP_DTYPE)
    d2, m2, _ = mp._padded(kp2, np.ones(900, bool))
    assert d2.shape == (1024, 128)
    kp3 = np.zeros(1500, KP_DTYPE)
    d3, _, _ = mp._padded(kp3, np.ones(1500, bool))
    assert d3.shape == (2048, 128)  # beyond size: next pow2 bucket


def test_siftplan_memory_precheck():
    """Oversized plans raise at construction, not inside the compiler
    (reference: plan.py::_calc_memory)."""
    import pytest

    from sift_pyocl_jax import SiftPlan

    with pytest.raises(MemoryError):
        SiftPlan(shape=(120000, 120000))
    p = SiftPlan(shape=(512, 512))
    assert 0 < p.calc_memory() < (1 << 30)


class _FakeDevice:
    def __init__(self, platform, stats):
        self.platform, self.device_kind, self._stats = platform, "fake", stats

    def memory_stats(self):
        return self._stats


def test_memory_limit_from_device_stats_never_assumed(monkeypatch):
    """The plan limit is the device's reported bytes_limit; a device that
    reports none is an error, never a default size."""
    import pytest

    from sift_pyocl_jax import SiftPlan
    from sift_pyocl_jax.models import sift as S

    assert S.device_memory_limit(_FakeDevice("gpu", {"bytes_limit": 123})) == 123
    with pytest.raises(RuntimeError):
        S.device_memory_limit(_FakeDevice("gpu", {}))
    with pytest.raises(RuntimeError):
        S.device_memory_limit(_FakeDevice("gpu", None))
    monkeypatch.setattr(S.jax, "devices",
                        lambda: [_FakeDevice("gpu", {"bytes_limit": 1 << 20})])
    with pytest.raises(MemoryError):
        SiftPlan(shape=(512, 512))


def test_memory_limit_on_cpu_is_host_ram():
    import os

    from sift_pyocl_jax.models.sift import device_memory_limit

    ram = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    assert device_memory_limit(_FakeDevice("cpu", None)) == ram > 0


def test_max_ori_knob():
    """cfg.max_ori caps the orientations kept per keypoint exactly like
    capping the oracle's per-keypoint peak list."""
    import collections

    import jax.numpy as jnp
    import numpy as np

    from sift_pyocl_jax import SiftConfig
    from sift_pyocl_jax.models.sift import detect_and_describe
    from sift_pyocl_jax.oracle import sift_numpy
    from sift_pyocl_jax.utils.testimage import synthetic_scene

    scene = synthetic_scene((128, 128), n_blobs=15, seed=0)
    cfg = SiftConfig(kp_per_octave_cap=256)
    ref = sift_numpy(scene, cfg)
    per_kp = collections.Counter(
        zip(ref["x"].round(3), ref["y"].round(3), ref["scale"].round(3)))
    got = {}
    for mo in (1, 2, 3):
        b = detect_and_describe(jnp.asarray(scene),
                                SiftConfig(kp_per_octave_cap=256, max_ori=mo))
        got[mo] = int(np.asarray(b.valid).sum())
        want = sum(min(n, mo) for n in per_kp.values())
        assert abs(got[mo] - want) <= max(1, int(0.05 * want)), (mo, got, want)
    assert 5 < got[1] < got[2] <= got[3]
