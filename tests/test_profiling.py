"""Profiling utilities: roofline model sanity + stopwatch."""

import jax
import pytest

from lqr_tpu.profiling import PEAK_HBM_GBPS, seam_roofline, Stopwatch

H100 = "NVIDIA H100 80GB HBM3"


def test_roofline_model():
    r = seam_roofline(2048, 2048, device_kind=H100)
    # one seam at 2048^2 moves tens of MB; at the H100's 3.35 TB/s the
    # memory-traffic bound is some tens of thousands of seams/s
    assert 50 << 20 < r.hbm_bytes < 200 << 20
    assert r.sol_seams_per_s == pytest.approx(3350e9 / r.hbm_bytes)
    assert 10_000 < r.sol_seams_per_s < 50_000
    assert r.efficiency(r.sol_seams_per_s) == 1.0
    assert r.device_kind == H100
    # masks add compaction traffic
    r2 = seam_roofline(2048, 2048, has_bias=True, has_rig=True,
                       device_kind=H100)
    assert r2.hbm_bytes > r.hbm_bytes


@pytest.mark.parametrize("kind", sorted(PEAK_HBM_GBPS))
def test_roofline_known_devices(kind):
    r = seam_roofline(512, 384, device_kind=kind)
    assert r.sol_seams_per_s * r.hbm_bytes == pytest.approx(
        PEAK_HBM_GBPS[kind] * 1e9)


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-40GB",
                                  "NVIDIA H100", ""])
def test_roofline_unknown_device_raises(kind):
    with pytest.raises(ValueError, match="no peak bandwidth"):
        seam_roofline(2048, 2048, device_kind=kind)


def test_roofline_default_device_is_this_one():
    """Without a device_kind the first JAX device decides; the CPU has no
    peak on record, so the model refuses rather than guessing."""
    if jax.devices()[0].device_kind in PEAK_HBM_GBPS:
        assert seam_roofline(64, 128).device_kind == \
            jax.devices()[0].device_kind
    else:
        with pytest.raises(ValueError):
            seam_roofline(64, 128)


def test_stopwatch(make_image):
    import jax.numpy as jnp
    sw = Stopwatch()
    x = jnp.zeros((8, 8)) + 1
    dt = sw.lap("op", x)
    assert dt >= 0
    assert "op" in sw.report()
