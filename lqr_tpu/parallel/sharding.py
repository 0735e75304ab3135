"""Multi-chip sharding: batch data-parallelism + column sharding of the DP.

The reference is a single-threaded C library (SURVEY.md §2.3: "parallelism:
none"); this module is the scaling design mandated by BASELINE.md:

- axis ``data``: images of a batch sharded across chips. This shards the
  REAL product hot loop — ``extend_map_batched`` (the batched
  ``lqr_carver_resize`` of /root/reference/src/render.c:318) is pure
  per-image work, so XLA partitions it with zero per-seam collectives
  (``shard_batch_state`` places the state; see also
  ``BatchCarver(mesh=...)``).

- axis ``cols``: image columns sharded across chips; the row-DP frontier is
  the sequential dependence (the sequence-parallel analog: rows are the
  sequential dimension, columns the parallel one — SURVEY.md §5 "long
  context"). Halos are exchanged per ROW-BLOCK, not per row: to compute R
  rows exactly in a shard's own columns, it needs G = R·delta_x frontier
  values and an [R, G] energy slab from each neighbor, then recomputes the
  shrinking halo cone redundantly. That is 2 collective pairs per R rows
  instead of 2 per row (R=32 default: 32x fewer collective launches).

Seam outputs are bitwise invariant to the shard count: the halo-extended
windowed min performs the identical f32 adds/compares as the unsharded scan
(values outside the exact cone are upper bounds that never reach a shard's
own columns).

Collectives are explicit under ``shard_map`` and XLA hands them to the
device interconnect (NCCL over NVLink on GPUs); no custom transport.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..core.state import INF, MapState
from ..core import dp as dp_mod
from ..core.energy import energy as energy_fn
from ..errors import LqrImageError
from ..i18n import _


def make_mesh(n_devices: int | None = None, data: int | None = None):
    """Build a (data, cols) mesh over the available devices.

    ``data`` devices split the batch and ``n_devices // data`` split image
    columns. Every device reaches every other at the same rate (NVLink all
    to all), so the split follows the job: the default puts all devices
    on 'data', which needs no per-seam collectives; pass ``data`` to give
    columns to wide images."""
    devs = jax.devices()
    n = n_devices or len(devs)
    devs = devs[:n]
    if data is None:
        data = n
    if data < 1 or n % data:
        raise ValueError(f"data={data} must divide the {n} devices")
    return Mesh(np.array(devs).reshape(data, n // data), ("data", "cols"))


# ---------------------------------------------------------------------------
# data parallelism over the real hot path
# ---------------------------------------------------------------------------

def shard_batch_state(st: MapState, mesh: Mesh,
                      cols: bool = False) -> MapState:
    """Place a batched MapState with the batch dim sharded over 'data'
    (and, with cols=True, image columns over 'cols').

    All ops in ``extend_map_batched`` are per-image (vmap), so jit
    partitions the whole resize loop data-parallel with no per-seam
    collectives — the sharded execution of the product path. With
    cols=True the plane arrays also split along lanes for
    ``extend_map_sharded``'s halo-exchanged DP."""
    def put(a):
        if a is None:
            return None
        if cols and a.ndim >= 3:
            spec = (P("data", None, "cols") if a.ndim == 3
                    else P("data", None, "cols", None))
        else:
            spec = P("data")
        return jax.device_put(a, NamedSharding(mesh, spec))

    B = st.ref.shape[0]
    n_data = mesh.shape["data"]
    if B % n_data != 0:
        raise LqrImageError(
            _("batch of {B} images cannot shard evenly over {n} 'data' "
              "devices; pad the batch to a multiple of {n}")
            .format(B=B, n=n_data))
    if cols:
        n_cols = mesh.shape["cols"]
        if st.ref.shape[2] % n_cols != 0:
            raise LqrImageError(
                _("width {w} cannot shard evenly over {n} 'cols' devices")
                .format(w=st.ref.shape[2], n=n_cols))
    return MapState(
        ref=put(st.ref), bias=put(st.bias), rig=put(st.rig), vs=put(st.vs),
        aux=tuple(put(a) for a in st.aux),
        cur_b=put(st.cur_b), cur_bias=put(st.cur_bias),
        cur_rig=put(st.cur_rig), ref_w=put(st.ref_w), depth=put(st.depth))


# ---------------------------------------------------------------------------
# column-sharded DP with row-block halo exchange
# ---------------------------------------------------------------------------

def _block_rows(H: int, delta_x: int, Wl: int) -> int:
    """Rows per halo-exchange block: largest R dividing H with halo
    G = R·delta_x at most half the local width (the exact-cone bound)."""
    for r in (32, 16, 8, 4, 2, 1):
        if H % r == 0 and r * max(delta_x, 1) * 2 <= Wl:
            return r
    return 1


def _dp_local_blocked(e_loc, rig_loc, pref_left, delta_x: int,
                      has_rig: bool, H: int, n_shards: int, R: int):
    """Per-shard forward DP, halos exchanged once per R-row block. Runs
    inside shard_map over 'cols'. e_loc: [H, Wl]. Returns
    (M_last [Wl], bp [H, Wl] i8)."""
    Wl = e_loc.shape[-1]
    idx = jax.lax.axis_index("cols")
    rank_l, rank_r = dp_mod.rank_tables(delta_x)
    dxs = sorted(rank_l.keys(), key=lambda d: rank_l[d])
    d = delta_x
    G = max(R * d, 1)        # halo width (>=1 keeps shapes non-empty at d=0)

    right_perm = [(i, i + 1) for i in range(n_shards - 1)]
    left_perm = [(i + 1, i) for i in range(n_shards - 1)]

    def exchange_all(M_loc, e_blk, rig_blk):
        """ONE packed exchange per neighbor per block. The [G] frontier, [R, G] energy slab and optional [R, G] rig slab
        are stacked into a single [1+R(+R), G] plane per direction, so
        each block issues exactly 2 ppermutes regardless of planes.
        Identical values travel — bit-exactness is untouched.

        Returns (frontier_l, frontier_r, e_l, e_r, rig_l, rig_r)."""
        shp1, shpR = (G,), (R, G)
        if n_shards == 1 or d == 0:
            return (jnp.full(shp1, INF), jnp.full(shp1, INF),
                    jnp.full(shpR, INF), jnp.full(shpR, INF),
                    jnp.zeros(shpR), jnp.zeros(shpR))

        def pack(sl):
            parts = [M_loc[None, sl], e_blk[:, sl]]
            if has_rig:
                parts.append(rig_blk[:, sl])
            return jnp.concatenate(parts, axis=0)

        halo_l = jax.lax.ppermute(pack(slice(-G, None)), "cols",
                                  right_perm)
        halo_r = jax.lax.ppermute(pack(slice(None, G)), "cols", left_perm)

        def unpack(h, edge):
            f = jnp.where(edge, INF, h[0])
            e = jnp.where(edge, INF, h[1:1 + R])
            if has_rig:
                # out-of-image rig is irrelevant (its energy is +inf);
                # a +inf rig would poison e+rig sums in the redundant
                # cone -> 0 at the mesh edge
                r = jnp.where(edge, 0.0, h[1 + R:])
            else:
                r = jnp.zeros(shpR)
            return f, e, r

        fl, el, rl = unpack(halo_l, idx == 0)
        fr, er, rr = unpack(halo_r, idx == n_shards - 1)
        return fl, fr, el, er, rl, rr

    def dp_row(M_prev, e_row, rig_row):
        """One exact DP row on the extended [We] frontier."""
        best = jnp.full_like(M_prev, INF)
        best_rank = jnp.full(M_prev.shape, 127, jnp.int32)
        bp = jnp.zeros(M_prev.shape, jnp.int8)
        for dx in dxs:
            c = dp_mod.shift_frontier(M_prev, dx)
            if has_rig and dx != 0:
                rigc = jnp.float32((abs(dx) ** 1.5) / float(H))
                c = c + rig_row * rigc
            rank = jnp.where(pref_left, jnp.int32(rank_l[dx]),
                             jnp.int32(rank_r[dx]))
            take = (c < best) | ((c == best) & (rank < best_rank))
            best = jnp.where(take, c, best)
            best_rank = jnp.where(take, rank, best_rank)
            bp = jnp.where(take, jnp.int8(dx), bp)
        return e_row + best, bp

    def block_step(carry, xs):
        M_loc, blk = carry
        e_blk, rig_blk = xs
        # one PACKED halo exchange per block: frontier [G] + energy slab
        # [R, G] (+ rig slab) travel together, one ppermute per neighbor
        fl, fr, el, er, rl, rr = exchange_all(M_loc, e_blk, rig_blk)
        Mext = jnp.concatenate([fl, M_loc, fr])
        eext = jnp.concatenate([el, e_blk, er], axis=-1)
        if has_rig:
            rext = jnp.concatenate([rl, rig_blk, rr], axis=-1)
        else:
            rext = jnp.zeros_like(eext)

        def row_fn(r, c):
            Mx, bps = c
            row = blk * R + r
            M_new, bp = dp_row(Mx, eext[r], rext[r])
            # global row 0 has no predecessor
            M_new = jnp.where(row == 0, eext[r], M_new)
            bp = jnp.where(row == 0, jnp.int8(0), bp)
            bps = jax.lax.dynamic_update_slice(
                bps, bp[None, G:G + Wl], (r, 0))
            return M_new, bps

        Mext, bps = jax.lax.fori_loop(
            0, R, row_fn, (Mext, jnp.zeros((R, Wl), jnp.int8)))
        return (Mext[G:G + Wl], blk + 1), bps

    n_blocks = H // R
    e_b = e_loc.reshape(n_blocks, R, Wl)
    rig_b = (rig_loc.reshape(n_blocks, R, Wl) if has_rig
             else jnp.zeros((n_blocks, R, 1), jnp.float32))
    (M_last, _), bp = jax.lax.scan(
        block_step, (jnp.full((Wl,), INF), jnp.int32(0)), (e_b, rig_b))
    return M_last, bp.reshape(H, Wl)


def find_seam_sharded(mesh: Mesh, e_tot, rig, pref_left, delta_x: int,
                      has_rig: bool):
    """Column-sharded seam search. e_tot: [H, Wb] (+inf at invalid lanes,
    bias already folded in, as in engine._carve_once).

    The forward DP runs sharded over 'cols' with row-block halo
    exchange; the backtrack (a scalar chase) runs on the gathered backpointer map.
    Bitwise-identical to core.dp.find_seam.
    """
    H, Wb = e_tot.shape
    n_shards = mesh.shape["cols"]
    Wl = Wb // n_shards
    R = _block_rows(H, delta_x, Wl)

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(None, "cols"), P(None, "cols"), P()),
        out_specs=(P("cols"), P(None, "cols")),
        check_vma=False)
    def run(e, r, pl):
        return _dp_local_blocked(e, r, pl, delta_x, has_rig, H, n_shards,
                                 R)

    if rig is None:
        rig = jnp.zeros((H, Wb), jnp.float32)
    M_last, bp = run(e_tot, rig, pref_left)
    return dp_mod.backtrack(M_last, bp, pref_left)


def _carve_seam_local(cb, cbs, crg, vs, w, s, pl_, active, ref_w, *,
                      n_shards: int, H: int, delta_x: int, has_bias: bool,
                      has_rig: bool, nrg: int, R: int):
    """One exact carve step on a shard's LOCAL slabs — runs inside
    shard_map over 'cols' (at the jit level, lane rolls and cumsums over
    the sharded axis would lower to lane-wide collectives).

    Every collective is explicit and O(1)-sized per seam:
      - energy column halo: 2 one-column ppermutes;
      - DP: 2 packed ppermutes per R-row block (_dp_local_blocked);
      - backtrack: all_gather of (M_last [Wb], bp [H, Wb] i8), then a
        replicated local chase;
      - compact: 1 packed one-column ppermute (the left-shift carry);
      - commit: all_gather of per-row visible counts [H] — local rank +
        exclusive shard-count prefix == the global visible-rank cumsum.

    Bit-exact vs engine._carve_once + seam_step's commit: identical f32
    ops on identical values (halos carry true neighbor values; the
    exact-cone bound keeps own columns exact — see module docstring).
    """
    from ..config import EnergyFunc

    Wl = cb.shape[-1]
    idx = jax.lax.axis_index("cols")
    lane_l = jnp.arange(Wl, dtype=jnp.int32)[None, :]
    glane = idx * Wl + lane_l                                 # [1, Wl]
    right_perm = [(i, i + 1) for i in range(n_shards - 1)]
    left_perm = [(i + 1, i) for i in range(n_shards - 1)]

    def from_left(x):
        """Left neighbor's slice (zeros at the mesh edge)."""
        return (jax.lax.ppermute(x, "cols", right_perm) if n_shards > 1
                else jnp.zeros_like(x))

    def from_right(x):
        return (jax.lax.ppermute(x, "cols", left_perm) if n_shards > 1
                else jnp.zeros_like(x))

    # --- energy: local stencil, one-column halo per direction ----------
    if EnergyFunc(nrg) == EnergyFunc.NULL:
        e = jnp.zeros((H, Wl), jnp.float32)
    else:
        bl_col = from_left(cb[:, -1:])
        br_col = from_right(cb[:, :1])
        br = jnp.concatenate([cb[:, 1:], br_col], axis=1)
        br = jnp.where(glane >= w - 1, cb, br)    # replicate right edge
        bl = jnp.concatenate([bl_col, cb[:, :-1]], axis=1)
        bl = jnp.where(glane == 0, cb, bl)        # replicate left edge
        gx = (br - bl) * jnp.float32(0.5)
        bd = jnp.concatenate([cb[1:], cb[-1:]], axis=0)
        bu = jnp.concatenate([cb[:1], cb[:-1]], axis=0)
        gy = (bd - bu) * jnp.float32(0.5)
        nrg_e = EnergyFunc(nrg)
        if nrg_e in (EnergyFunc.GRAD_XABS, EnergyFunc.LUMA_GRAD_XABS):
            e = jnp.abs(gx)
        elif nrg_e in (EnergyFunc.GRAD_SUMABS,
                       EnergyFunc.LUMA_GRAD_SUMABS):
            e = (jnp.abs(gx) + jnp.abs(gy)) * jnp.float32(0.5)
        else:
            e = jnp.sqrt(gx * gx + gy * gy)
    e = jnp.where(glane < w, e, INF)
    if has_bias:
        e = jnp.where(glane < w, e + cbs, INF)

    # --- forward DP (2 packed ppermutes per row block) -----------------
    M_loc, bp_loc = _dp_local_blocked(
        e, crg if has_rig else jnp.zeros_like(e), pl_, delta_x, has_rig,
        H, n_shards, R)

    # --- backtrack on the gathered backpointer map ---------------------
    if n_shards > 1:
        M_all = jax.lax.all_gather(M_loc, "cols", tiled=True)
        bp_all = jax.lax.all_gather(bp_loc, "cols", axis=1, tiled=True)
    else:
        M_all, bp_all = M_loc, bp_loc
    seam = dp_mod.backtrack(M_all, bp_all, pl_)               # [H]

    # --- compact: local left shift + one carry column ------------------
    ge = glane >= seam[:, None]
    keep = glane < (w - 1)
    planes = ([cb] + ([cbs] if has_bias else [])
              + ([crg] if has_rig else []))
    firsts = jnp.stack([p[:, :1] for p in planes])            # [P, H, 1]
    recv = from_right(firsts)
    act = active

    def compact(p, i):
        shifted = jnp.concatenate([p[:, 1:], recv[i]], axis=1)
        out = jnp.where(ge, shifted, p)
        out = jnp.where(keep, out, jnp.float32(0))
        return jnp.where(act, out, p)

    cb2 = compact(cb, 0)
    i = 1
    if has_bias:
        cbs2, i = compact(cbs, i), i + 1
    else:
        cbs2 = cbs
    crg2 = compact(crg, i) if has_rig else crg

    # --- commit: local visible-rank + shard-count prefix ---------------
    visible = (vs == 0) & (glane < ref_w)
    vis_i = visible.astype(jnp.int32)
    pos_l = jnp.cumsum(vis_i, axis=1) - vis_i
    counts = jnp.sum(vis_i, axis=1)                           # [H]
    if n_shards > 1:
        allc = jax.lax.all_gather(counts, "cols")             # [n, H]
        shard_row = jnp.arange(n_shards, dtype=jnp.int32)[:, None]
        offset = jnp.sum(jnp.where(shard_row < idx, allc, 0), axis=0)
    else:
        offset = jnp.zeros((H,), jnp.int32)
    hit = visible & (pos_l + offset[:, None] == seam[:, None])
    vs2 = jnp.where(hit & act, s.astype(jnp.int32), vs)
    return cb2, cbs2, crg2, vs2


@functools.partial(jax.jit, static_argnames=("mesh", "cfg"))
def extend_map_sharded(mesh: Mesh, cfg, st: MapState, k) -> MapState:
    """The column-sharded multi-seam RESIZE loop — the sharded execution of
    the reference's hot loop itself (``lqr_carver_resize``,
    /root/reference/src/render.c:318), not a single-step demo.

    st: batched MapState [B, ...] placed by ``shard_batch_state(mesh,
    cols=True)`` — batch over 'data', image columns over 'cols'. Carves
    k[b] seams per image. The WHOLE per-seam step (energy, DP, backtrack,
    compaction, visibility-map commit) runs inside one shard_map on local
    coordinates (_carve_seam_local), so the only collectives are the
    explicit halo/carry/count exchanges — ~2·(H/R)+3 permutes + 3
    all-gathers per seam. Seam outputs are bitwise invariant to
    the shard count (tests/test_parallel.py, __graft_entry__'s dryrun).
    """
    from ..core import engine as eng

    H, Wb = cfg.H, cfg.Wb
    B = st.ref.shape[0]
    k = jnp.broadcast_to(jnp.asarray(k, jnp.int32), (B,))
    kmax = jnp.max(k)
    has_bias, has_rig = cfg.has_bias, cfg.has_rig
    n_shards = mesh.shape["cols"]
    Wl = Wb // n_shards
    R = _block_rows(H, cfg.delta_x, Wl)

    local = functools.partial(
        _carve_seam_local, n_shards=n_shards, H=H, delta_x=cfg.delta_x,
        has_bias=has_bias, has_rig=has_rig, nrg=int(cfg.nrg), R=R)

    sharded = shard_map(
        local, mesh=mesh,
        in_specs=(P(None, "cols"), P(None, "cols"), P(None, "cols"),
                  P(None, "cols"), P(), P(), P(), P(), P()),
        out_specs=(P(None, "cols"), P(None, "cols"), P(None, "cols"),
                   P(None, "cols")),
        check_vma=False)

    def one_seam(cb, cbs, crg, vs, w_i, s_i, active_i, ref_w_i):
        pl_ = eng.pref_is_left(s_i, cfg.side_switch_freq)
        return sharded(cb, cbs, crg, vs, w_i, s_i, pl_, active_i, ref_w_i)

    def body(j, carry):
        cur_b, cur_bias, cur_rig, vs, depth = carry
        w = st.ref_w - depth
        s = depth + 1
        active = j < k                                     # [B]
        cbs_in = cur_bias if has_bias else cur_b           # dummy when absent
        crg_in = cur_rig if has_rig else cur_b
        cb2, cbs2, crg2, vs = jax.vmap(one_seam)(
            cur_b, cbs_in, crg_in, vs, w, s, active, st.ref_w)
        cur_b = cb2
        if has_bias:
            cur_bias = cbs2
        if has_rig:
            cur_rig = crg2
        depth = depth + active.astype(jnp.int32)
        return (cur_b, cur_bias, cur_rig, vs, depth)

    cur_b, cur_bias, cur_rig, vs, depth = jax.lax.fori_loop(
        0, kmax, body,
        (st.cur_b, st.cur_bias, st.cur_rig, st.vs, st.depth))
    return st._replace(vs=vs, cur_b=cur_b, cur_bias=cur_bias,
                       cur_rig=cur_rig, depth=depth)


@functools.partial(jax.jit,
                   static_argnames=("mesh", "delta_x", "nrg", "has_bias",
                                    "has_rig"))
def sharded_seam_step(mesh: Mesh, images, widths, pref_left,
                      delta_x: int = 1, nrg: int = 0,
                      bias=None, rig=None,
                      has_bias: bool = False, has_rig: bool = False):
    """One full carve step over a batch, sharded (data, cols).

    images: [B, H, Wb, C] u8, batch sharded over 'data', columns over
    'cols'. bias/rig: [B, H, Wb] f32 compacted fields (or None) — the
    cur_bias/cur_rig inputs the r1 version lacked. Computes energy
    (sharded elementwise), folds the bias, runs the column-sharded DP per
    image, backtracks, and compacts every plane — the unit that iterates
    in a sharded resize. Returns (new_images, new_bias, new_rig,
    seams [B, H]).
    """
    B, H, Wb, C = images.shape
    lane = jnp.broadcast_to(jnp.arange(Wb, dtype=jnp.int32), (H, Wb))

    def per_image(img, w, bias_i, rig_i):
        e = energy_fn(img, w, nrg)
        if has_bias:
            e = jnp.where(lane < w, e + bias_i, INF)
        seam = find_seam_sharded(mesh, e, rig_i if has_rig else None,
                                 pref_left, delta_x, has_rig)
        # compact (roll+select, elementwise — shards over cols fine)
        ge = lane >= seam[:, None]
        keep = lane < (w - 1)

        def compact(a, zero):
            ge_a = ge[..., None] if a.ndim == 3 else ge
            keep_a = keep[..., None] if a.ndim == 3 else keep
            out = jnp.where(ge_a, jnp.roll(a, -1, axis=1), a)
            return jnp.where(keep_a, out, zero)

        img2 = compact(img, jnp.uint8(0))
        bias2 = compact(bias_i, jnp.float32(0)) if has_bias else bias_i
        rig2 = compact(rig_i, jnp.float32(0)) if has_rig else rig_i
        return img2, bias2, rig2, seam

    zeros = jnp.zeros((B, 1, 1), jnp.float32)
    bias = bias if has_bias else zeros
    rig = rig if has_rig else zeros
    return jax.vmap(per_image)(images, widths, bias, rig)
