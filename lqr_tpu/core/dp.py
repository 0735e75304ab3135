"""Cumulative-cost DP and backtrack (SPEC.md §5), pure-JAX version.

This is the Bellman recursion at the heart of ``lqr_carver_resize``
(/root/reference/src/render.c:318; the hot loop identified in SURVEY.md §3.1):

    M[y, x] = E[y, x] + min_{|dx| <= delta_x} ( M[y-1, x+dx] + rig·|dx|^1.5/H )

implemented as a ``lax.scan`` over rows with the whole row frontier as the
carry (columns fully vectorized). Backpointers are recorded so the
backtrack is a cheap per-row pointer chase. The CUDA kernel with the same
contract lives in ``lqr_tpu.ops.sweep`` (native/seam_sweep.cu); this scan is
its reference and the path on every other platform.

Tie-breaking follows SPEC.md §5: candidates ranked by side preference
(side-switch law of ``lqr_carver_set_side_switch_frequency``,
/root/reference/src/render.c:237), strict-min in rank order.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .state import INF


def rank_tables(delta_x: int) -> tuple[dict, dict]:
    """Static candidate ranks for LEFT and RIGHT side preference."""
    left, right = {0: 0}, {0: 0}
    r = 1
    for m in range(1, delta_x + 1):
        left[-m], left[m] = r, r + 1
        right[m], right[-m] = r, r + 1
        r += 2
    return left, right


def shift_frontier(M: jnp.ndarray, dx: int) -> jnp.ndarray:
    """shifted[x] = M[x + dx], out-of-range -> +inf. M: [..., Wb]."""
    if dx == 0:
        return M
    Wb = M.shape[-1]
    lane = jnp.arange(Wb, dtype=jnp.int32)
    s = jnp.roll(M, -dx, axis=-1)
    if dx > 0:
        return jnp.where(lane >= Wb - dx, INF, s)
    return jnp.where(lane < -dx, INF, s)


def dp_forward(e_tot: jnp.ndarray, rig: jnp.ndarray, pref_left,
               delta_x: int, has_rig: bool, h=None, rigc_vec=None):
    """Run the DP. e_tot: [H, Wb] f32 (+inf at invalid lanes, bias included);
    rig: [H, Wb] f32; pref_left: traced bool scalar.

    Returns (M_last [Wb] f32, bp [H, Wb] int8). bp[0] = 0.

    Ragged batching (per-image true height inside a padded buffer):
    - h (traced, optional): rows >= h are PASS-THROUGH — the frontier rides
      through unchanged (M = M_prev, bp = 0), so the final-row argmin and
      the backtracked seam are bit-identical to running on an unpadded
      [h, Wb] map.
    - rigc_vec (traced [delta_x + 1] f32, optional): per-image rigidity
      step coefficients f32(|dx|^1.5 / h), host-rounded exactly once
      (SPEC.md §4); defaults to the static-H constants.
    """
    H = e_tot.shape[0]
    rank_l, rank_r = rank_tables(delta_x)
    dxs = sorted(rank_l.keys(), key=lambda d: rank_l[d])  # any fixed order
    ragged = h is not None

    def row_step(M_prev, row):
        if ragged:
            row_idx, row = row[0], row[1:]
        e_row, rig_row = row if has_rig else (row[0], None)
        best = jnp.full_like(M_prev, INF)
        best_rank = jnp.full(M_prev.shape, 127, jnp.int32)
        bp = jnp.zeros(M_prev.shape, jnp.int8)
        for dx in dxs:
            c = shift_frontier(M_prev, dx)
            if has_rig and dx != 0:
                rigc = (rigc_vec[abs(dx)] if rigc_vec is not None
                        else jnp.float32((abs(dx) ** 1.5) / float(H)))
                c = c + rig_row * rigc
            rank = jnp.where(pref_left,
                             jnp.int32(rank_l[dx]), jnp.int32(rank_r[dx]))
            take = (c < best) | ((c == best) & (rank < best_rank))
            best = jnp.where(take, c, best)
            best_rank = jnp.where(take, rank, best_rank)
            bp = jnp.where(take, jnp.int8(dx), bp)
        M = e_row + best
        if ragged:
            pad = row_idx >= h
            M = jnp.where(pad, M_prev, M)
            bp = jnp.where(pad, jnp.int8(0), bp)
        return M, bp

    M0 = e_tot[0]
    xs = (e_tot[1:],) + ((rig[1:],) if has_rig else ())
    if ragged:
        xs = (jnp.arange(1, H, dtype=jnp.int32),) + xs
    M_last, bp_rest = jax.lax.scan(row_step, M0, xs)
    bp = jnp.concatenate([jnp.zeros((1,) + bp_rest.shape[1:], jnp.int8),
                          bp_rest], axis=0)
    return M_last, bp


def backtrack(M_last: jnp.ndarray, bp: jnp.ndarray, pref_left) -> jnp.ndarray:
    """Extract the seam (SPEC.md §5). Returns seam [H] int32 (compacted
    coords). Invalid lanes of M_last must be +inf."""
    Wb = M_last.shape[-1]
    lane = jnp.arange(Wb, dtype=jnp.int32)
    m = jnp.min(M_last)
    left_x = jnp.min(jnp.where(M_last == m, lane, Wb))
    right_x = jnp.max(jnp.where(M_last == m, lane, -1))
    x0 = jnp.where(pref_left, left_x, right_x).astype(jnp.int32)

    def step(x, bp_row):
        x_next = x + bp_row[x].astype(jnp.int32)
        return x_next, x

    # walk rows H-1 .. 0; bp[0] is all-zero so the final step is a no-op
    _, xs_rev = jax.lax.scan(step, x0, bp[::-1])
    return xs_rev[::-1]


def find_seam(e_tot, rig, pref_left, delta_x: int, has_rig: bool,
              h=None, rigc_vec=None):
    M_last, bp = dp_forward(e_tot, rig, pref_left, delta_x, has_rig,
                            h=h, rigc_vec=rigc_vec)
    return backtrack(M_last, bp, pref_left)
