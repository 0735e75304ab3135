"""(min,+) associative-scan DP experiment — SURVEY §7 hard part #2.

The seam DP  M[y,x] = e[y,x] + min_{|d|<=dx} M[y-1, x+d]  is a linear
recurrence over the tropical (min,+) semiring, so it admits an
associative reformulation: split the H rows into B blocks of R rows,
compute each block's TRANSFER OPERATOR in parallel, then chain the
operators sequentially (or in a log-depth tree).

A block of R rows with |d| <= 1 per step is a BANDED tropical matrix
with 2R+1 diagonals:  T_b[d][x] = min over in-block paths from entry
column x+d to exit column x of the path's energy sum.  Operators
compose by banded tropical matmul; applying one to the frontier is
  M_out[x] = min_{|d|<=R} (M_in[x+d] + T_b[d][x]).

What the reformulation costs, counted:

1. WORK grows while DEPTH shrinks. Where the device issues the row
   chain's vector ops faster than their latency, cutting depth while
   growing work is a loss by construction:
     - sequential: H rows x (2 shifts + 2 mins + 1 add) ~ 5H vector ops.
     - block apply: per block, 2R+1 diagonals each needing a shift
       (|d| up to R: still one roll+fix) + add + min ~ 3(2R+1) ops;
       x H/R blocks ~ 6H ops — ALREADY more than the chain it replaces,
       before computing any operator.
     - operator construction (parallel over blocks, batched): step r
       grows the band from 2r-1 to 2r+1 diagonals; each output diagonal
       is a 3-way min of shifted+summed diagonals ~ 4(2r+1) batched ops;
       summed over r = 1..R ~ 4R^2 per block — at R=8 that is ~256
       batched ops per 8 rows (32/row-equivalent) on top.
   Total: ~(6 + 32/occupancy)H vs 5H. The reformulation can only pay
   where the sequential chain stalls on latency; the script measures
   which side of that line the live backend is on.

2. Bit-exactness is impossible in f32. The scan reassociates the path
   sum (e-sums accumulate inside T before meeting M), so ties and
   sub-ULP orderings differ from liblqr's row-by-row accumulation; the
   engine's oracle contract (SPEC.md: bit-equal vs maps) cannot be met.
   The prototype below measures the value drift too.

3. Backpointers get worse: the operator form yields only block-level
   argmins; recovering per-row backpointers requires either storing
   per-step argmin tensors (R x band extra state) or a second
   within-block pass (the sequential DP again).

This script measures the forward VALUE pass both ways on the live
backend and prints one JSON line; run with --json to record.
`python scripts/minplus_scan.py [H] [W] [R]`
"""

import json
import sys
import time

import numpy as np

args = [a for a in sys.argv[1:] if not a.startswith("-")]
H = int(args[0]) if args else 384
W = int(args[1]) if len(args) > 1 else 512
R = int(args[2]) if len(args) > 2 else 8

import jax
import jax.numpy as jnp

INF = jnp.float32(jnp.inf)


def seq_dp(e):
    """Row-sequential reference: M[y] = e[y] + min3(M[y-1])."""
    def row(M_prev, e_row):
        cm = jnp.concatenate([jnp.array([INF]), M_prev[:-1]])
        cp = jnp.concatenate([M_prev[1:], jnp.array([INF])])
        M = e_row + jnp.minimum(jnp.minimum(cm, M_prev), cp)
        return M, 0
    M0 = e[0]
    Mlast, _ = jax.lax.scan(row, M0, e[1:])
    return Mlast


def _shift_cols(a, d):
    """a[..., x+d] with +inf fill (a: [..., W])."""
    if d == 0:
        return a
    pad = jnp.full(a.shape[:-1] + (abs(d),), INF, a.dtype)
    if d > 0:
        return jnp.concatenate([a[..., d:], pad], axis=-1)
    return jnp.concatenate([pad, a[..., :d]], axis=-1)


def block_operators(e_blocks):
    """T[b, d+R, x]: banded tropical transfer operator of each R-row
    block, built by composing one row at a time (band grows by 1/side).
    e_blocks: [B, R, W]."""
    B = e_blocks.shape[0]
    # T after r rows has band 2r+1; store in fixed [2R+1] diag slots.
    T = jnp.full((B, 2 * R + 1, W), INF)
    # row 0 of the block: T[d][x] = e[0][x+d] for |d| <= ... band 1? A
    # single row y contributes e[y, x_exit] once entered; path enters at
    # x+d, steps to x: one step per row boundary. Define the operator of
    # r rows as: M_out[x] = min_{paths} (sum of e over the r rows) with
    # M_in read at the entry column. Row 1 alone: M_out[x] =
    # e[0][x] + min_{|d|<=1} M_in[x+d]  -> T1[d][x] = e[0][x], |d| <= 1.
    e0 = e_blocks[:, 0, :]
    T = T.at[:, R - 1:R + 2, :].set(
        jnp.broadcast_to(e0[:, None, :], (B, 3, W)))

    def add_row(T, e_r):
        # T'[d][x] = e_r[x] + min_{|s|<=1} T[d - s][x + s]
        def diag(d):
            m = None
            for s in (-1, 0, 1):
                k = d - s + R                    # static diagonal index
                if 0 <= k <= 2 * R:
                    t = _shift_cols(T[:, k, :], s)
                    m = t if m is None else jnp.minimum(m, t)
            return e_r + m
        return jnp.stack([diag(d) for d in range(-R, R + 1)], axis=1), 0

    def chain(T, rows):
        Tn, _ = jax.lax.scan(add_row, T, rows)
        return Tn
    T = chain(T, jnp.moveaxis(e_blocks[:, 1:, :], 1, 0))
    return T


def scan_dp(e):
    """Blocked (min,+) scan: parallel operator build + sequential band
    apply. Returns the last row's M values."""
    B = H // R
    e_blocks = e.reshape(B, R, W)
    T = block_operators(e_blocks)               # parallel over blocks

    def apply_block(M_in, T_b):
        cands = [_shift_cols(M_in, d) + T_b[d + R] for d in range(-R, R + 1)]
        M = cands[0]
        for c in cands[1:]:
            M = jnp.minimum(M, c)
        return M, 0

    # block 0 includes row 0 (no predecessor): emulate with M_in = 0
    M0 = jnp.zeros((W,), jnp.float32)
    Mlast, _ = jax.lax.scan(apply_block, M0, T)
    return Mlast


def main():
    rng = np.random.default_rng(0)
    e_np = rng.random((H, W), np.float32)
    e = jnp.asarray(e_np)

    seq = jax.jit(seq_dp)
    scn = jax.jit(scan_dp)

    def sync(x):
        return np.asarray(jax.device_get(x))

    a = sync(seq(e))
    b = sync(scn(e))
    drift = float(np.max(np.abs(a - b)))

    def timed(fn, n=50):
        es = jnp.asarray(rng.random((H, W), np.float32))
        sync(fn(es))
        outs = []
        for i in range(3):
            es = jnp.asarray(rng.random((H, W), np.float32))
            t0 = time.perf_counter()
            for _ in range(n):
                r = fn(es)
            sync(r)
            outs.append((time.perf_counter() - t0) / n)
        return float(np.median(outs))

    t_seq = timed(seq)
    t_scan = timed(scn)
    print(json.dumps({
        "metric": "minplus_scan_vs_sequential_dp",
        "size": f"{W}x{H}", "R": R,
        "t_seq_ms": round(t_seq * 1e3, 3),
        "t_scan_ms": round(t_scan * 1e3, 3),
        "scan_over_seq": round(t_scan / t_seq, 2),
        "max_value_drift": drift,
        "verdict": "sequential wins" if t_scan > t_seq else "scan wins",
        "note": "f32 drift != 0 -> scan cannot meet the bit-exact oracle "
                "contract regardless of speed",
    }))


if __name__ == "__main__":
    main()
