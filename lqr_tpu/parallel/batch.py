"""Batched carving — vmap over images and seam schedules.

The reference processes one image per process (SURVEY.md §2.3 "parallelism:
none"); this module is the accelerator-native replacement for running N
GIMP processes: thousands of images carve together on one device (benchmark config
#4: 4096x 1MP, 25% width reduction).

Ragged batches are padded to a common [H, Wb] with per-image widths AND
heights. Padding is semantically invisible: lanes >= width are masked to
+inf by the energy law, and rows >= height are DP pass-through rows
(dp.dp_forward) with the bottom-edge gradient replicated at the true
height, so each image's seam sequence is bit-identical to carving it solo.
Per-image seam counts may differ: extension is masked per image.

Full feature surface of the solo Carver: bias fields (pres/disc masks),
rigidity + rigmask (per-image |dx|^1.5 / h coefficients, host-rounded
exactly once like the solo path), and attached aux carvers that undergo
the identical seam sequence (lqr_carver_attach,
/root/reference/src/render.c:243-248).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..core.state import EngineConfig, MapState, round_up
from ..core import engine as eng
from ..errors import LqrImageError
from ..i18n import _


def rigc_table(heights, delta_x: int) -> np.ndarray:
    """Per-image rigidity step coefficients [B, delta_x + 1] f32:
    rigc[b, m] = f32(m^1.5 / h_b), rounded exactly once (SPEC.md §4)."""
    heights = np.asarray(heights, np.int64)
    out = np.zeros((len(heights), delta_x + 1), np.float32)
    for m in range(1, delta_x + 1):
        out[:, m] = ((m ** 1.5) / heights).astype(np.float32)
    return out


def init_state_batched(cfg: EngineConfig, pixels, widths,
                       bias=None, rig=None, aux=()) -> MapState:
    """pixels: [B, H, Wb, C] u8 (padded; lanes >= widths[b] and rows >=
    heights[b] zero); widths: [B] int32. bias/rig: [B, H, Wb] f32 or None.
    aux: tuple of [B, H, Wb, C_i] u8 attached carvers."""
    from ..core.energy import reader_plane

    B, H, Wb, C = pixels.shape
    assert (H, Wb, C) == (cfg.H, cfg.Wb, cfg.C)
    pixels = jnp.asarray(pixels, jnp.uint8)
    # absent planes stay None (pytree-empty) — a [B, H, Wb] zero field per
    # plane would dominate batch device memory at throughput batch sizes
    bias = jnp.asarray(bias, jnp.float32) if cfg.has_bias else None
    rig = jnp.asarray(rig, jnp.float32) if cfg.has_rig else None
    aux_p = tuple(jnp.asarray(a, jnp.uint8) for a in aux)
    assert tuple(a.shape[3] for a in aux_p) == tuple(cfg.aux_channels)
    vs = jnp.zeros((B, H, Wb), jnp.int32)
    return MapState(ref=pixels, bias=bias, rig=rig, vs=vs, aux=aux_p,
                    cur_b=reader_plane(pixels, cfg.nrg),
                    cur_bias=bias, cur_rig=rig,
                    ref_w=jnp.asarray(widths, jnp.int32),
                    depth=jnp.zeros((B,), jnp.int32))


@functools.partial(jax.jit, static_argnums=0)
def extend_map_batched(cfg: EngineConfig, st: MapState, k,
                       heights=None, rigc=None) -> MapState:
    """Carve k[b] further seams into each image's map.

    FLAT single-level loop over seams, mirroring engine._extend_hot (a
    vmapped fori nested in a while makes XLA copy the plane carries).
    The seam search runs through engine._find_seam under vmap, so on a
    GPU one sweep-kernel launch covers the whole batch. Per-image seam
    counts are masked per step; the chunk commit rides a lax.cond every
    KC-th step with per-image chunk depths (images that exhausted their
    k simply stop accumulating — their chunk kc is smaller).

    heights: [B] i32 true heights (None = all rows real); rigc:
    [B, delta_x + 1] f32 per-image rigidity coefficients (required with
    heights + cfg.has_rig; see ``rigc_table``)."""
    k = jnp.asarray(k, jnp.int32)
    kmax = jnp.max(k)
    B, H = st.vs.shape[0], cfg.H
    KC = eng.KC
    hist0 = jnp.zeros((B, KC, H), jnp.int32)
    hh = None if heights is None else jnp.asarray(heights, jnp.int32)
    rc = (rigc if rigc is not None
          else (None if heights is None
                else jnp.zeros((B, cfg.delta_x + 1), jnp.float32)))

    def carve(cb, cbs, crg, w_i, s_i, *extra):
        h_i, rv_i = extra if heights is not None else (None, None)
        return eng._carve_once(cfg, cb, cbs, crg, w_i, s_i,
                               h=h_i, rigc_vec=rv_i)

    def cond(c):
        return c[-1] < kmax

    def body(c):
        cur_b, cur_bias, cur_rig, vs, hist, depth, chunk_d0, done = c
        j = done % jnp.int32(KC)
        active = done < k                                       # [B]
        args = (cur_b, cur_bias, cur_rig, st.ref_w - depth, depth + 1)
        if heights is not None:
            args = args + (hh, rc)
        seam, b2, bias2, rig2 = jax.vmap(carve)(*args)

        def upd(new, old):
            return jnp.where(active[:, None, None], new, old)

        cur_b = upd(b2, cur_b)
        if cfg.has_bias:
            cur_bias = upd(bias2, cur_bias)
        if cfg.has_rig:
            cur_rig = upd(rig2, cur_rig)
        hist = jax.lax.dynamic_update_slice(hist, seam[:, None, :],
                                            (0, j, 0))
        depth = depth + active.astype(jnp.int32)
        done = done + 1

        def commit(vh):
            v, h_ = vh
            kc_b = depth - chunk_d0          # per-image seams this chunk
            return jax.vmap(eng._commit_hist)(v, st.ref_w, chunk_d0,
                                              kc_b, h_), h_

        commit_now = (j + 1 == KC) | (done >= kmax)
        vs, hist = jax.lax.cond(commit_now, commit, lambda vh: vh,
                                (vs, hist))
        chunk_d0 = jnp.where(commit_now, depth, chunk_d0)
        return (cur_b, cur_bias, cur_rig, vs, hist, depth, chunk_d0,
                done)

    out = jax.lax.while_loop(
        cond, body,
        (st.cur_b, st.cur_bias, st.cur_rig, st.vs, hist0, st.depth,
         st.depth, jnp.int32(0)))
    cur_b, cur_bias, cur_rig, vs = out[0], out[1], out[2], out[3]
    depth = out[5]
    return st._replace(vs=vs, cur_b=cur_b, cur_bias=cur_bias,
                       cur_rig=cur_rig, depth=depth)


@functools.partial(jax.jit, static_argnums=(0, 3))
def materialize_batched(cfg: EngineConfig, st: MapState, w, out_Wb: int):
    """Materialize each image at width w[b] -> [B, H, out_Wb, C]."""
    w = jnp.asarray(w, jnp.int32)
    return jax.vmap(
        lambda ref, vs, rw, wi: eng.materialize_array(ref, vs, rw, wi,
                                                      out_Wb)
    )(st.ref, st.vs, st.ref_w, w)


@functools.partial(jax.jit, static_argnums=(0, 3))
def materialize_all_batched(cfg: EngineConfig, st: MapState, w, out_Wb: int):
    """Materialize main + every attached aux carver at width w[b].

    Returns (img [B, H, out_Wb, C], aux tuple) — the batched
    write_aux_carver (/root/reference/src/render.c:902-916)."""
    w = jnp.asarray(w, jnp.int32)
    img = jax.vmap(
        lambda ref, vs, rw, wi: eng.materialize_array(ref, vs, rw, wi,
                                                      out_Wb)
    )(st.ref, st.vs, st.ref_w, w)
    aux = tuple(
        jax.vmap(lambda a, vs, rw, wi: eng.materialize_array(a, vs, rw, wi,
                                                             out_Wb)
                 )(a, st.vs, st.ref_w, w)
        for a in st.aux)
    return img, aux


class BatchCarver:
    """Host API for batched width-carving of many images at once.

    This is the throughput path: one jitted program carves the whole batch.
    (Height carving: transpose inputs, as in the single Carver.)

    Feature parity with the solo ``Carver`` (benchmark configs #2 + #4
    combined): per-image ``biases`` (strength fields, the pres/disc
    bias_add result), ``rigmasks`` + global ``rigidity`` (x-mask law of
    SPEC.md §4), and ``aux`` carvers following the identical seam sequence.
    """

    def __init__(self, images, *, delta_x: int = 1, nrg: int = 0,
                 rigidity: float = 0.0, biases=None, rigmasks=None,
                 aux=None, mesh=None):
        """images: list of [h_i, w_i, C] u8 arrays (same C; ragged sizes
        padded internally — seam outputs are bit-identical to solo carves).

        biases: per-image f32 [h_i, w_i] additive energy fields or None
        entries; rigmasks: per-image f32 [h_i, w_i] rigidity-multiplier
        fields or None entries (with rigidity > 0 and no mask, the global
        value applies everywhere, as in Carver._build_map); aux: per-image
        lists of [h_i, w_i, C_j] u8 attached carvers (same count and
        channels across the batch).

        mesh: a jax Mesh with a 'data' axis — the batch dim of the whole
        carve state is sharded across it and the SAME jitted resize loop
        runs data-parallel (zero per-seam collectives; the sharded
        execution of the product hot path, BASELINE.md scaling target).
        With a 'cols' axis of size > 1, image columns additionally shard
        across it and ``carve`` runs the column-sharded resize loop
        (sharding.extend_map_sharded: per-seam row-block halo-exchange DP
        — the spatial/sequence-parallel axis; requires equal heights)."""
        if len(images) == 0:
            raise LqrImageError(
                _("BatchCarver needs at least one image"))
        if isinstance(images, np.ndarray) and images.ndim == 4:
            # pre-stacked equal-size batch (e.g. utils.codec.stage_wave's
            # output): when the lane dim is already padded to the bucket
            # the buffer is used AS-IS — zero host copies on the staging
            # path. Caller contract: lanes >= width (if any) are zero.
            if images.dtype != np.uint8:
                raise LqrImageError(
                    _("a stacked batch must be uint8, got {dt}")
                    .format(dt=images.dtype))
            B, H, W, C = images.shape
            Wb = max(128, round_up(W, 128))
            if Wb == W:
                buf = np.ascontiguousarray(images)
            else:
                buf = np.zeros((B, H, Wb, C), np.uint8)
                buf[:, :, :W] = images
            widths = np.full((B,), W, np.int32)
            heights = np.full((B,), H, np.int32)
        else:
            C = images[0].shape[2] if images[0].ndim == 3 else 1
            H = max(im.shape[0] for im in images)
            Wmax = max(im.shape[1] for im in images)
            Wb = max(128, round_up(Wmax, 128))
            B = len(images)
            buf = np.zeros((B, H, Wb, C), np.uint8)
            widths = np.zeros((B,), np.int32)
            heights = np.zeros((B,), np.int32)
            for i, im in enumerate(images):
                if im.ndim == 2:
                    im = im[:, :, None]
                if im.shape[2] != C:
                    raise LqrImageError(
                        _("image {i} has {c} channels, batch has {C}")
                        .format(i=i, c=im.shape[2], C=C))
                h, w = im.shape[:2]
                buf[i, :h, :w] = im
                widths[i] = w
                heights[i] = h

        has_bias = biases is not None and any(b is not None for b in biases)
        has_rig = (rigidity > 0
                   or (rigmasks is not None
                       and any(r is not None for r in rigmasks)))

        def field(entries, fold_rigidity=False):
            out = np.zeros((B, H, Wb), np.float32)
            for i in range(B):
                e = None if entries is None else entries[i]
                h, w = heights[i], widths[i]
                if e is not None:
                    out[i, :h, :w] = np.asarray(e, np.float32)
                    if fold_rigidity:
                        out[i, :h, :w] *= np.float32(rigidity)
                elif fold_rigidity and rigidity > 0:
                    out[i, :h, :w] = np.float32(rigidity)
            return out

        bias_f = field(biases) if has_bias else None
        # per-pixel rigidity = global rigidity x mask strength, or global
        # alone when no mask (Carver._build_map rule, SPEC.md §4)
        rig_f = field(rigmasks, fold_rigidity=True) if has_rig else None

        aux_planes = ()
        aux_channels = ()
        if aux is not None and any(a for a in aux):
            n_aux = len(aux[0])
            if any(len(a) != n_aux for a in aux):
                raise LqrImageError(
                    _("every image must attach the same number of aux "
                      "carvers"))
            planes = []
            chans = []
            for j in range(n_aux):
                cj = aux[0][j].shape[2] if aux[0][j].ndim == 3 else 1
                pj = np.zeros((B, H, Wb, cj), np.uint8)
                for i in range(B):
                    a = np.asarray(aux[i][j], np.uint8)
                    if a.ndim == 2:
                        a = a[:, :, None]
                    if a.shape[:2] != (heights[i], widths[i]):
                        raise LqrImageError(
                            _("aux {j} of image {i} is {aw}x{ah}, image "
                              "is {w}x{h}")
                            .format(j=j, i=i, aw=a.shape[1], ah=a.shape[0],
                                    w=widths[i], h=heights[i]))
                    pj[i, :heights[i], :widths[i]] = a
                planes.append(pj)
                chans.append(cj)
            aux_planes = tuple(planes)
            aux_channels = tuple(chans)

        self.cfg = EngineConfig(H=H, Wb=Wb, C=C, delta_x=delta_x, nrg=nrg,
                                has_bias=has_bias, has_rig=has_rig,
                                aux_channels=aux_channels)
        self.heights = heights
        self.widths = widths
        # ragged machinery only when heights actually differ — equal
        # heights take the leaner non-ragged program
        self.ragged = bool((heights != H).any())
        self._rigc = (jnp.asarray(rigc_table(heights, delta_x))
                      if (self.ragged and has_rig) else None)
        self.state = init_state_batched(self.cfg, buf, widths,
                                        bias=bias_f, rig=rig_f,
                                        aux=aux_planes)
        self.mesh = mesh
        self.col_sharded = (mesh is not None and "cols" in mesh.shape
                            and mesh.shape["cols"] > 1)
        if self.col_sharded and self.ragged:
            raise LqrImageError(
                _("column sharding requires equal image heights (pad or "
                  "batch same-height images together)"))
        if mesh is not None:
            from .sharding import shard_batch_state
            self.state = shard_batch_state(self.state, mesh,
                                           cols=self.col_sharded)

    def carve(self, n_seams):
        """Extend every map by n_seams (scalar or per-image array)."""
        n = np.broadcast_to(np.asarray(n_seams, np.int32),
                            self.widths.shape)
        if self.col_sharded:
            from .sharding import extend_map_sharded
            self.state = extend_map_sharded(self.mesh, self.cfg,
                                            self.state, jnp.asarray(n))
        else:
            self.state = extend_map_batched(
                self.cfg, self.state, jnp.asarray(n),
                heights=jnp.asarray(self.heights) if self.ragged else None,
                rigc=self._rigc)
        return self

    def images_at(self, new_widths):
        """Materialize all images at the given widths (scalar or [B])."""
        w = np.broadcast_to(np.asarray(new_widths, np.int32),
                            self.widths.shape)
        out = materialize_batched(self.cfg, self.state, jnp.asarray(w),
                                  self.cfg.Wb)
        out = np.asarray(jax.device_get(out))
        return [out[i, :self.heights[i], :w[i]] for i in range(len(w))]

    def aux_at(self, new_widths):
        """Materialize every attached aux carver at the given widths;
        returns a per-image list of per-aux lists (identical seam
        sequence, lqr_carver_attach semantics)."""
        w = np.broadcast_to(np.asarray(new_widths, np.int32),
                            self.widths.shape)
        _, aux = materialize_all_batched(self.cfg, self.state,
                                         jnp.asarray(w), self.cfg.Wb)
        aux = [np.asarray(jax.device_get(a)) for a in aux]
        return [[a[i, :self.heights[i], :w[i]] for a in aux]
                for i in range(len(w))]
