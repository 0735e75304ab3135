"""Tests that need an NVIDIA GPU: the CUDA seam sweep on the card.

Run on the card with (README.md):

    LQR_TESTS_ON_GPU=1 python -m pytest tests/test_gpu.py -m gpu

Whether a GPU is present is decided inside the ``gpu`` fixture, never at
import, so every worker collects the same tests; without a card each test
skips with the reason.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from lqr_tpu import native
from lqr_tpu.core import dp
from lqr_tpu.parallel.batch import rigc_table

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU: LQR_TESTS_ON_GPU=1 python -m "
                    "pytest tests/test_gpu.py -m gpu")
    from lqr_tpu.ops import sweep
    sweep.load()
    return sweep


@functools.partial(jax.jit, static_argnums=(3, 4))
def _ref(e, rig, pref, dx, has_rig, h=None, rigc=None):
    M, bp = dp.dp_forward(e, rig, pref, dx, has_rig, h=h, rigc_vec=rigc)
    return dp.backtrack(M, bp, pref), M


def _energy(seed, H, W, Wb, levels=8):
    rng = np.random.default_rng(seed)
    e = np.full((H, Wb), np.inf, np.float32)
    e[:, :W] = np.round(rng.random((H, W)) * levels) / levels
    rig = np.zeros((H, Wb), np.float32)
    rig[:, :W] = np.round(rng.random((H, W)) * 4) * 10
    return jnp.asarray(e), jnp.asarray(rig)


@pytest.mark.parametrize("H,W,Wb", [(384, 512, 512), (2048, 2000, 2048),
                                    (100, 9000, 9088), (64, 16000, 16384)])
@pytest.mark.parametrize("dx,has_rig", [(0, False), (1, False), (1, True),
                                        (3, True), (10, True)])
def test_sweep_matches_scan_dp(gpu, H, W, Wb, dx, has_rig):
    e, rig = _energy(H + dx, H, W, Wb)
    for pref in (True, False):
        p = jnp.bool_(pref)
        s_ref, m_ref = _ref(e, rig, p, dx, has_rig)
        s, m = jax.jit(lambda e, r, p: gpu.sweep(e, r, p, dx, has_rig))(
            e, rig, p)
        assert np.array_equal(np.asarray(s), np.asarray(s_ref))
        assert np.array_equal(np.asarray(m).view(np.int32),
                              np.asarray(m_ref).view(np.int32))


def test_sweep_ragged_batch(gpu):
    rng = np.random.default_rng(3)
    B, H, Wb, dx = 8, 300, 640, 2
    e = np.full((B, H, Wb), np.inf, np.float32)
    rig = np.zeros((B, H, Wb), np.float32)
    for i in range(B):
        e[i, :, :600 - 20 * i] = np.round(rng.random((H, 600 - 20 * i)) * 8)
        rig[i] = rng.random((H, Wb)) * 20
    h = np.array([300, 1, 2, 150, 299, 77, 300, 10], np.int32)
    pref = np.arange(B) % 2 == 0
    rc = rigc_table(h, dx)
    args = tuple(jnp.asarray(a) for a in (e, rig, pref, h, rc))
    s_ref, m_ref = jax.vmap(lambda e, r, p, h, c: _ref(e, r, p, dx, True,
                                                       h, c))(*args)
    s, m = jax.jit(jax.vmap(lambda e, r, p, h, c: gpu.sweep(
        e, r, p, dx, True, h=h, rigc_vec=c)))(*args)
    assert np.array_equal(np.asarray(s), np.asarray(s_ref))
    assert np.array_equal(np.asarray(m).view(np.int32),
                          np.asarray(m_ref).view(np.int32))


def test_engine_lowers_the_kernel(gpu):
    from lqr_tpu.core.engine import extend_map
    from lqr_tpu.core.state import EngineConfig, init_state
    cfg = EngineConfig(H=64, Wb=128, C=3)
    st = init_state(cfg, np.zeros((64, 100, 3), np.uint8))
    hlo = extend_map.lower(cfg, st, jnp.int32(2)).as_text()
    assert gpu.TARGET in hlo


def test_carver_matches_native(gpu):
    from bench import make_test_image
    from lqr_tpu import Carver
    img = make_test_image(512)[:384]
    c = Carver(img, delta_x=2, rigidity=30.0)
    c.resize(412, 384)
    vs_ref = native.carve(img, 100, delta_x=2,
                          rig=np.full((384, 512), 30.0, np.float32))
    assert np.array_equal(c.vmap_dump().data, vs_ref)
    assert np.array_equal(c.get_image(), native.materialize(img, vs_ref,
                                                            412))


def test_batch_carver_matches_native(gpu):
    from bench import make_test_image
    from lqr_tpu.parallel.batch import BatchCarver
    imgs = [make_test_image(640, seed=i)[:h, :w]
            for i, (h, w) in enumerate([(480, 640), (400, 600),
                                        (480, 500)])]
    bc = BatchCarver(imgs)
    bc.carve(np.array([60, 40, 50], np.int32))
    vs = np.asarray(bc.state.vs)
    for i, (im, k) in enumerate(zip(imgs, (60, 40, 50))):
        h, w = im.shape[:2]
        assert np.array_equal(vs[i, :h, :w], native.carve(im, k))
