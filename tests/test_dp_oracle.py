"""The scan DP (core.dp.find_seam) against the NumPy oracle (SPEC.md §5).

The scan DP is the reference the GPU sweep kernel is held to bit for bit
(tests/test_gpu.py, chip_smoke.py), so its own semantics are pinned here
on the CPU: delta_x, rigidity, both side preferences, ties, ragged
heights and odd widths inside a padded buffer.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from lqr_tpu import oracle
from lqr_tpu.core import dp as jdp
from lqr_tpu.parallel.batch import rigc_table


@functools.partial(jax.jit, static_argnums=(3, 4))
def _find(e, rig, pref, delta_x, has_rig):
    return jdp.find_seam(e, rig, pref, delta_x, has_rig)


@functools.partial(jax.jit, static_argnums=(3, 4))
def _find_ragged(e, rig, pref, delta_x, has_rig, h, rigc):
    return jdp.find_seam(e, rig, pref, delta_x, has_rig, h=h, rigc_vec=rigc)


def _case(seed, H, W, Wb, levels=8, rig_scale=30.0):
    """Quantized energies (abundant ties) in a +inf-padded buffer, and a
    quantized rigidity field."""
    rng = np.random.default_rng(seed)
    e = np.full((H, Wb), np.inf, np.float32)
    e[:, :W] = np.round(rng.random((H, W), dtype=np.float32) * levels) \
        / levels
    rig = np.zeros((H, Wb), np.float32)
    rig[:, :W] = (np.round(np.abs(rng.standard_normal((H, W))) * 4) / 4
                  * rig_scale)
    return e, rig


def _oracle_seam(e, rig, W, delta_x, pref, has_rig, h=None):
    h = e.shape[0] if h is None else h
    r = rig[:h, :W] if has_rig else np.zeros((h, W), np.float32)
    return oracle.find_seam(e[:h, :W], r, delta_x, pref, h)


@pytest.mark.parametrize("has_rig", [False, True])
@pytest.mark.parametrize("pref", [True, False])
@pytest.mark.parametrize("delta_x", [0, 1, 2, 3])
@pytest.mark.parametrize("H,W,Wb", [(16, 40, 128), (24, 37, 128)])
def test_scan_dp_matches_oracle(H, W, Wb, delta_x, pref, has_rig):
    e, rig = _case(7 + delta_x, H, W, Wb)
    got = np.asarray(_find(jnp.asarray(e), jnp.asarray(rig),
                           jnp.bool_(pref), delta_x, has_rig))
    assert np.array_equal(got, _oracle_seam(e, rig, W, delta_x, pref,
                                            has_rig))


@pytest.mark.parametrize("pref", [True, False])
@pytest.mark.parametrize("delta_x", [1, 10])
def test_scan_dp_wide_buffer(delta_x, pref):
    """A buffer wider than one 1024-lane block (the 2-column-per-thread
    regime of the GPU kernel) with an unaligned width."""
    e, rig = _case(21, 12, 1500, 2048)
    got = np.asarray(_find(jnp.asarray(e), jnp.asarray(rig),
                           jnp.bool_(pref), delta_x, True))
    assert np.array_equal(got, _oracle_seam(e, rig, 1500, delta_x, pref,
                                            True))


@pytest.mark.parametrize("W", [1, 2, 127, 128])
def test_scan_dp_edge_widths(W):
    """One column, two columns, and widths at the buffer edge."""
    e, rig = _case(5, 10, W, 128)
    for pref in (True, False):
        got = np.asarray(_find(jnp.asarray(e), jnp.asarray(rig),
                               jnp.bool_(pref), 2, True))
        assert np.array_equal(got, _oracle_seam(e, rig, W, 2, pref, True))
        assert got.min() >= 0 and got.max() < W


@pytest.mark.parametrize("pref", [True, False])
@pytest.mark.parametrize("h", [1, 5, 17, 24])
def test_scan_dp_ragged_height(h, pref):
    """Rows >= h pass the frontier through: the seam's first h rows equal
    the oracle's on the [h, W] map (rigidity normalized by h), and the
    padded rows repeat the seam's last column."""
    H, W, Wb, dx = 24, 30, 128, 2
    e, rig = _case(11, H, W, Wb)
    rigc = jnp.asarray(rigc_table([h], dx)[0])
    got = np.asarray(_find_ragged(jnp.asarray(e), jnp.asarray(rig),
                                  jnp.bool_(pref), dx, True,
                                  jnp.int32(h), rigc))
    expect = _oracle_seam(e, rig, W, dx, pref, True, h=h)
    assert np.array_equal(got[:h], expect)
    assert np.all(got[h:] == expect[-1])


@pytest.mark.parametrize("pref", [True, False])
def test_scan_dp_all_ties_pick_side(pref):
    """A flat energy map: every column ties, so the side preference alone
    picks the seam start, and the seam runs straight down."""
    H, W, Wb = 8, 20, 128
    e = np.full((H, Wb), np.inf, np.float32)
    e[:, :W] = 0.5
    got = np.asarray(_find(jnp.asarray(e), jnp.zeros((H, Wb), jnp.float32),
                           jnp.bool_(pref), 1, False))
    assert np.all(got == (0 if pref else W - 1))


def test_forward_costmap_matches_oracle_accumulation():
    """M_last is the oracle's last DP row on valid lanes and +inf beyond."""
    H, W, Wb = 16, 30, 128
    e, rig = _case(3, H, W, Wb)
    M, _ = jdp.dp_forward(jnp.asarray(e), jnp.asarray(rig), jnp.bool_(True),
                          1, True)
    M = np.asarray(M)
    M_ref = e[0, :W].copy()
    for y in range(1, H):
        best = np.full(W, np.inf, np.float32)
        for dx in oracle.dx_order(1, True):
            src = np.arange(W) + dx
            ok = (src >= 0) & (src < W)
            c = np.full(W, np.inf, np.float32)
            c[ok] = M_ref[src[ok]] + rig[y, :W][ok] * np.float32(
                (abs(dx) ** 1.5) / H)
            best = np.where(c < best, c, best)
        M_ref = (e[y, :W] + best).astype(np.float32)
    assert np.array_equal(M[:W], M_ref)
    assert np.all(np.isinf(M[W:]))
