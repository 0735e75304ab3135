"""The arrayified carver engine: seam step, map extension, materialization.

This is the accelerator-native replacement for liblqr's carving core (the
hot loop of ``lqr_carver_resize``, SURVEY.md §3.1). Everything here is
functional and jittable with static shapes.

Hot-loop design (one seam on the compacted state):
- energy = gradients of the precomputed reader plane ``cur_b`` (SPEC.md §2;
  a pixel's reader value is carving-invariant so the u8 channels never enter
  the loop);
- DP + backtrack: the CUDA seam sweep (lqr_tpu.ops.sweep) on a GPU, the
  lax.scan DP (core.dp) elsewhere — chosen in ``_find_seam``;
- compaction is a roll+select (no gather): removing column s of a row is
  ``where(lane >= s, shift_left(row), row)`` — pure elementwise work;
- seams are NOT committed to the visibility map per step. They accumulate in
  a [KC, H] history of successive compacted coordinates; once per chunk
  ``_commit_hist`` composes the history back to reference coordinates (the
  exact inverse of the per-step column-map bookkeeping) and scatters all KC
  seam ids into ``vs`` at once. This keeps the per-seam device-memory
  traffic to (read plane, write backpointers, compact plane) — nothing
  else.

``extend_map(state, k)`` carves k further seams (dynamic trip count);
``materialize`` produces any width in [ref_w - depth, ref_w + depth] from
(ref, vs) per SPEC.md §6.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .state import EngineConfig, MapState, INF
from .energy import energy_from_plane
from . import dp as dp_mod
from ..ops import sweep

# seams per hot chunk: the seam history committed to vs in one pass.
# 128 rows of [KC, H] i32 history ~ 1 MB at H=2048 — negligible state.
KC = 128


def _lane(H: int, Wb: int):
    return jnp.broadcast_to(jnp.arange(Wb, dtype=jnp.int32), (H, Wb))


def pref_is_left(s, freq: int):
    """Side preference of (1-based, traced) seam index s. SPEC.md §5."""
    if freq <= 0:
        return jnp.bool_(True)
    return (((s - 1) // freq) % 2) == 0


def _find_seam(cfg: EngineConfig, e, rig, pl, h=None, rigc_vec=None):
    """The one place that picks the seam search: the CUDA sweep kernel
    when lowering for a GPU (and the buffer fits it), the scan DP
    everywhere else. Both return the identical seam."""
    def plain(e, rig, pl, h, rigc_vec):
        return dp_mod.find_seam(e, rig, pl, cfg.delta_x, cfg.has_rig,
                                h=h, rigc_vec=rigc_vec)

    if not sweep.supports(cfg.Wb):
        return plain(e, rig, pl, h, rigc_vec)

    def kernel(e, rig, pl, h, rigc_vec):
        return sweep.find_seam(e, rig, pl, cfg.delta_x, cfg.has_rig,
                               h=h, rigc_vec=rigc_vec)

    return jax.lax.platform_dependent(e, rig, pl, h, rigc_vec,
                                      cuda=kernel, default=plain)


def _carve_once(cfg: EngineConfig, cur_b, cur_bias, cur_rig, w, s,
                h=None, rigc_vec=None):
    """Find seam s (global 1-based index) on the compacted planes at width
    w and compact them. Returns (seam [H] i32, cur_b', cur_bias',
    cur_rig'). h / rigc_vec: per-image true height + rigidity coefficients
    for ragged batches (see dp.dp_forward)."""
    H, Wb = cfg.H, cfg.Wb
    lane = _lane(H, Wb)
    pl = pref_is_left(s, cfg.side_switch_freq)

    e = energy_from_plane(cur_b, w, cfg.nrg, h=h)
    if cfg.has_bias:
        e = jnp.where(lane < w, e + cur_bias, INF)

    seam = _find_seam(cfg, e, cur_rig, pl, h=h, rigc_vec=rigc_vec)

    ge = lane >= seam[:, None]
    keep_m = lane < (w - 1)

    def compact(a, zero):
        out = jnp.where(ge, jnp.roll(a, -1, axis=1), a)
        return jnp.where(keep_m, out, zero)

    cur_b = compact(cur_b, jnp.float32(0))
    if cfg.has_bias:
        cur_bias = compact(cur_bias, jnp.float32(0))
    if cfg.has_rig:
        cur_rig = compact(cur_rig, jnp.float32(0))
    return seam, cur_b, cur_bias, cur_rig


def seam_step(cfg: EngineConfig, st: MapState) -> MapState:
    """Carve one more seam into the map (depth += 1), committing it to vs.

    The single-seam public unit (used by the batched/sharded demos and
    tests); resize loops use ``extend_map``, which amortizes the vs commit
    over a whole chunk of seams.
    """
    H, Wb = cfg.H, cfg.Wb
    lane = _lane(H, Wb)
    w = st.ref_w - st.depth          # current compacted width
    s = st.depth + 1                 # global seam index within this map
    seam, cur_b, cur_bias, cur_rig = _carve_once(
        cfg, st.cur_b, st.cur_bias, st.cur_rig, w, s)

    # record in reference coords: the seam's compacted column equals its
    # rank among still-visible (vs == 0) reference columns of the row
    visible = (st.vs == 0) & (lane < st.ref_w)
    pos = jnp.cumsum(visible.astype(jnp.int32), axis=1) - visible
    hit = visible & (pos == seam[:, None])
    vs = jnp.where(hit, s.astype(jnp.int32), st.vs)

    return st._replace(vs=vs, cur_b=cur_b, cur_bias=cur_bias,
                       cur_rig=cur_rig, depth=st.depth + 1)


def _commit_hist(vs, ref_w, d0, kc, hist):
    """Commit a chunk's seam history into the visibility map.

    hist[j] ([H] per row) is in the coords of frame d0+j (the image with
    d0+j seams removed). Composing the removals maps every seam back to
    frame-d0 coords (position c in frame j+1 is position c + (c >= hist[j])
    in frame j), then the rank-of-visible map on vs lifts frame-d0 coords to
    reference columns. Bit-identical to per-seam column-map recording.

    The add-based commit relies on an invariant (ADVICE r3 #1): within a
    row, the kc committed (rank, seam) pairs hit kc DISTINCT visible
    columns — composed frame-d0 ranks of distinct seams are distinct by
    construction (composition is injective per row), every hit column has
    vs == 0, and rows j >= kc carry rank -1 which matches nothing. Two
    updates can therefore never land on the same element.
    """
    H, Wb = vs.shape
    irow = jnp.arange(KC, dtype=jnp.int32)[:, None]            # [KC, 1]

    def compose(t, R):
        jr = KC - 2 - t
        sj = jax.lax.dynamic_slice(hist, (jr, 0), (1, H))      # [1, H]
        return R + ((R >= sj) & (irow > jr)).astype(jnp.int32)

    R = jax.lax.fori_loop(0, KC - 1, compose, hist)            # frame-d0

    # A frame-d0 coordinate is the seam's rank among visible reference
    # columns of its row: commit seam j at the column where the running
    # visible-rank equals R[j]. One lane cumsum + a [KC, H, Wb] rank
    # match fused into the chunk reduction.
    lane = _lane(H, Wb)
    visible = (vs == 0) & (lane < ref_w)
    pos = jnp.cumsum(visible.astype(jnp.int32), axis=1) - visible
    iK = jnp.arange(KC, dtype=jnp.int32)[:, None]              # [KC, 1]
    Rm = jnp.where(iK < kc, R, jnp.int32(-1))                  # [KC, H]
    return vs + _rank_match_reduce(visible, pos, Rm, d0)


# chunk-reduce slab threshold: the rank-match commit builds a [KC, H, Wb]
# one-hot; XLA fuses the compare+select+reduce, but an unfused lowering
# would materialize KC*H*Wb bytes (~800 MB at cfg3 scale). Above this many
# H*Wb elements the reduce runs in KC/_COMMIT_SLABS-row slabs
# (bit-identical: slab sums hit disjoint columns), which bounds even a
# fully materialized intermediate to 1/_COMMIT_SLABS of that. The 2048^2
# flagship (4.2M elements) keeps the single fused reduce; cfg3-scale maps
# (2048x3072 = 6.3M) take the slabs.
_COMMIT_SLAB_ELEMS = 5 << 20
_COMMIT_SLABS = 8
assert KC % _COMMIT_SLABS == 0, "slabs must tile the chunk exactly"


def _rank_match_reduce(visible, pos, Rm, d0):
    """sum_k onehot(pos == Rm[k]) * (d0+1+k) over the chunk axis, slabbed
    when the plane is large (see _COMMIT_SLAB_ELEMS)."""
    H, Wb = visible.shape
    iK = jnp.arange(KC, dtype=jnp.int32)[:, None]              # [KC, 1]
    if H * Wb <= _COMMIT_SLAB_ELEMS:
        hit = visible[None] & (pos[None] == Rm[:, :, None])    # [KC, H, Wb]
        vals = (d0 + 1 + iK)[:, :, None]
        return jnp.sum(hit * vals, axis=0, dtype=jnp.int32)    # fused reduce

    KS = KC // _COMMIT_SLABS
    iS = jnp.arange(KS, dtype=jnp.int32)[:, None]              # [KS, 1]

    def slab(i, acc):
        Rs = jax.lax.dynamic_slice(Rm, (i * KS, 0), (KS, H))
        hit = visible[None] & (pos[None] == Rs[:, :, None])    # [KS, H, Wb]
        vals = (d0 + 1 + i * KS + iS)[:, :, None]
        return acc + jnp.sum(hit * vals, axis=0, dtype=jnp.int32)

    return jax.lax.fori_loop(0, _COMMIT_SLABS, slab,
                             jnp.zeros((H, Wb), jnp.int32))


def _extend_hot(cfg: EngineConfig, st: MapState, k) -> MapState:
    """Carve k further seams (k traced i32), chunked by KC.

    Only the mutating arrays ride the while carry; ref/bias/rig/aux are
    loop-invariant and stay outside (threading them costs copies).

    One FLAT while_loop over seams: a fori_loop of carve steps nested
    inside a chunk while_loop makes XLA copy the plane carries at the
    chunk boundary. The single-level loop carries the planes exactly
    once; the chunk commit rides a lax.cond that fires every KC-th seam
    (and on the last), so it is amortized over the chunk."""
    k = jnp.asarray(k, jnp.int32)
    H = cfg.H
    hist0 = jnp.zeros((KC, H), jnp.int32)

    def pack(b, bias, rig, rest):
        return ((b,) + ((bias,) if cfg.has_bias else ())
                + ((rig,) if cfg.has_rig else ()) + rest)

    def unpack(c):
        b, rest = c[0], c[1:]
        bias = rest[0] if cfg.has_bias else st.cur_bias
        rest = rest[1:] if cfg.has_bias else rest
        rig = rest[0] if cfg.has_rig else st.cur_rig
        rest = rest[1:] if cfg.has_rig else rest
        return b, bias, rig, rest

    def cond(c):
        return c[-1] < k

    def body(c):
        b, bias, rig, (vs, hist, depth, done) = unpack(c)
        j = done % jnp.int32(KC)              # row within the chunk
        seam, b, bias, rig = _carve_once(cfg, b, bias, rig,
                                         st.ref_w - depth, depth + 1)
        hist = jax.lax.dynamic_update_slice(hist, seam[None], (j, 0))
        depth = depth + 1
        done = done + 1
        kc = j + 1                            # seams in this chunk

        def commit(vh):
            v, h = vh
            return _commit_hist(v, st.ref_w, depth - kc, kc, h), h

        vs, hist = jax.lax.cond(
            (kc == KC) | (done >= k), commit, lambda vh: vh, (vs, hist))
        return pack(b, bias, rig, (vs, hist, depth, done))

    out = jax.lax.while_loop(
        cond, body,
        pack(st.cur_b, st.cur_bias, st.cur_rig,
             (st.vs, hist0, st.depth, jnp.int32(0))))
    cur_b, cur_bias, cur_rig, (vs, _, depth, _) = unpack(out)
    return st._replace(vs=vs, cur_b=cur_b, cur_bias=cur_bias,
                       cur_rig=cur_rig, depth=depth)


@functools.partial(jax.jit, static_argnums=0)
def extend_map(cfg: EngineConfig, st: MapState, k) -> MapState:
    """Carve k further seams (k: traced int32; dynamic trip count)."""
    return _extend_hot(cfg, st, k)


# ---------------------------------------------------------------------------
# materialization (SPEC.md §6)
# ---------------------------------------------------------------------------

def _avg_insert(a, b):
    """Value of a pixel inserted between a and b (SPEC.md §6)."""
    if a.dtype == jnp.uint8:
        return ((a.astype(jnp.uint16) + b.astype(jnp.uint16)) // 2) \
            .astype(jnp.uint8)
    return (a + b) * jnp.float32(0.5)


def materialize_array(arr, vs, ref_w, w, out_Wb: int):
    """Apply a visibility map to one reference-coordinate array.

    arr: [H, Wb] or [H, Wb, C]; vs: [H, Wb] i32; ref_w, w traced.
    Returns [H, out_Wb(,C)] with lanes >= w zeroed. Shrink and enlarge per
    SPEC.md §6; requires |w - ref_w| <= depth (caller's contract).

    SORT-based placement, no scatters: a stable row sort by target key
    produces the arrangement — surviving entries carry their target
    position as key and land compacted in order; dropped entries carry a
    big key and fall off the sliced end.
    """
    H, Wb = vs.shape
    lane = _lane(H, Wb)
    has_c = arr.ndim == 3
    chans = ([arr[:, :, c] for c in range(arr.shape[2])] if has_c
             else [arr])
    big = jnp.int32(1 << 30)                       # > any real key
    # (enlarge keys reach 2*(out width); a Wb-derived sentinel is NOT
    # enough — caught by cfg3's byte-exactness check)

    def fit(vals, cur: int):
        """Slice/pad sorted row-major values from width cur to out_Wb."""
        if cur >= out_Wb:
            return [v[:, :out_Wb] for v in vals]
        pad = out_Wb - cur
        return [jnp.concatenate(
            [v, jnp.zeros((H, pad), v.dtype)], axis=1) for v in vals]

    def shrink(_):
        k = ref_w - w
        visible = ((vs == 0) | (vs > k)) & (lane < ref_w)
        key = jnp.where(visible, lane, big)
        srt = jax.lax.sort((key,) + tuple(chans), dimension=1,
                           num_keys=1, is_stable=True)
        return fit(list(srt[1:]), Wb)

    def enlarge(_):
        k = w - ref_w
        valid = lane < ref_w
        dup = valid & (vs >= 1) & (vs <= k)
        pos = lane + jnp.cumsum(dup.astype(jnp.int32), axis=1) - dup
        k_orig = jnp.where(valid, 2 * pos, big)
        k_ins = jnp.where(dup, 2 * pos + 1, big)
        key = jnp.concatenate([k_orig, k_ins], axis=1)
        outs = []
        for ch in chans:
            nxt = jnp.roll(ch, -1, axis=1)
            nxt = jnp.where(lane == ref_w - 1, ch, nxt)
            ins = _avg_insert(ch, nxt)
            outs.append(jnp.concatenate([ch, ins], axis=1))
        srt = jax.lax.sort((key,) + tuple(outs), dimension=1,
                           num_keys=1, is_stable=True)
        return fit(list(srt[1:]), 2 * Wb)

    parts = jax.lax.cond(w <= ref_w, shrink, enlarge, None)
    lane_o = jnp.broadcast_to(jnp.arange(out_Wb, dtype=jnp.int32),
                              (H, out_Wb))
    parts = [jnp.where(lane_o < w, v, jnp.zeros((), v.dtype))
             for v in parts]
    return jnp.stack(parts, axis=2) if has_c else parts[0]


@functools.partial(jax.jit, static_argnums=(0, 3))
def materialize(cfg: EngineConfig, st: MapState, w, out_Wb: int):
    """Materialize the main image at width w -> u8 [H, out_Wb, C]."""
    return materialize_array(st.ref, st.vs, st.ref_w, w, out_Wb)


@functools.partial(jax.jit, static_argnums=(0, 3))
def materialize_all(cfg: EngineConfig, st: MapState, w, out_Wb: int):
    """Materialize main + bias + rig + all aux carvers at width w.

    Returns (img, bias, rig, aux_tuple) — the ingredients of a flatten
    (lqr_carver_flatten semantics, SPEC.md §6) and of aux write-back
    (write_aux_carver, /root/reference/src/render.c:902-916).
    """
    img = materialize_array(st.ref, st.vs, st.ref_w, w, out_Wb)
    bias = (materialize_array(st.bias, st.vs, st.ref_w, w, out_Wb)
            if st.bias is not None else None)
    rig = (materialize_array(st.rig, st.vs, st.ref_w, w, out_Wb)
           if st.rig is not None else None)
    aux = tuple(materialize_array(a, st.vs, st.ref_w, w, out_Wb)
                for a in st.aux)
    return img, bias, rig, aux
