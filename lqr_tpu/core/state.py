"""Carver state pytree and static engine configuration.

Accelerator-native re-expression of liblqr's ``LqrCarver`` (SURVEY.md §2.3): the
mutable C struct becomes an immutable pytree of fixed-shape arrays
(``MapState``) threaded through jitted transforms, and the per-carver
settings become a hashable static config (``EngineConfig``) that keys the
jit cache.

Width is dynamic (traced) inside a fixed-capacity buffer ``Wb`` (bucketed to
a multiple of 128 so recompiles are bounded); height ``H`` is static for the
lifetime of a map (orientation switches re-bucket).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax.numpy as jnp

from ..config import EnergyFunc, DEFAULT_SIDE_SWITCH_FREQUENCY

INF = jnp.float32(jnp.inf)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static (hashable) engine parameters — the jit cache key."""

    H: int                # image height (rows; seams are vertical)
    Wb: int               # column buffer capacity (>= ref_w, mult of 128)
    C: int                # channels of the main image (1, 2, 3, 4)
    delta_x: int = 1      # max transversal seam step (lqr_carver_init)
    nrg: int = int(EnergyFunc.GRAD_XABS)
    side_switch_freq: int = DEFAULT_SIDE_SWITCH_FREQUENCY
    aux_channels: tuple = ()   # channel counts of attached aux carvers
    has_bias: bool = False     # bias field in use (skip its carve otherwise)
    has_rig: bool = False      # rigidity in use (skip rig DP terms otherwise)

    def __post_init__(self):
        assert 1 <= self.C <= 4
        assert 0 <= self.delta_x <= 10


class MapState(NamedTuple):
    """The visibility-map state triple (SPEC.md §6) in array form.

    Reference-coordinate fields (width ref_w inside buffer Wb):
      ref      u8  [H, Wb, C]  reference pixels
      bias     f32 [H, Wb]     additive energy bias field
      rig      f32 [H, Wb]     per-pixel rigidity
      vs       i32 [H, Wb]     visibility map (0 = never carved, s = seam #)
      aux      tuple of u8 [H, Wb, C_i] attached aux carvers' pixels

    Shrunk-most compacted fields (width = ref_w - depth; used to extend the
    map by carving further seams):
      cur_b    f32 [H, Wb]     precomputed reader plane (brightness/luma,
               SPEC.md §1). A pixel's reader value is carving-invariant, so
               the hot loop never touches the u8 channels — energy is
               gradients of this single plane (energy.reader_plane).
      cur_bias f32 [H, Wb]
      cur_rig  f32 [H, Wb]

    Scalars (traced): ref_w, depth.

    Seam recording: the hot loop does NOT maintain a column map or update
    ``vs`` per seam — seams accumulate in a chunk-local history and are
    committed to ``vs`` once per chunk (engine._commit_hist), which is
    algebraically identical to per-seam column-map recording.
    """

    ref: jnp.ndarray
    bias: jnp.ndarray
    rig: jnp.ndarray
    vs: jnp.ndarray
    aux: tuple
    cur_b: jnp.ndarray
    cur_bias: jnp.ndarray
    cur_rig: jnp.ndarray
    ref_w: jnp.ndarray
    depth: jnp.ndarray


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def lane_index(H: int, Wb: int) -> jnp.ndarray:
    """[H, Wb] int32 column index grid."""
    return jnp.broadcast_to(jnp.arange(Wb, dtype=jnp.int32), (H, Wb))


def init_state(cfg: EngineConfig, pixels, bias=None, rig=None,
               aux=()) -> MapState:
    """Build a fresh MapState from a [H, w, C] uint8 image (w <= Wb).

    bias/rig are f32 [H, w] fields on image coordinates (SPEC.md §3-§4).
    aux is a tuple of [H, w, C_i] uint8 images (lqr_carver_attach).
    """
    from .energy import reader_plane   # late import (energy imports INF)

    H, Wb = cfg.H, cfg.Wb
    pixels = jnp.asarray(pixels, jnp.uint8)
    h, w = pixels.shape[:2]
    if pixels.ndim == 2:
        pixels = pixels[:, :, None]
    assert h == H and w <= Wb and pixels.shape[2] == cfg.C, (
        f"shape {pixels.shape} vs cfg {cfg}")

    def pad_w(a, fill=0):
        pads = [(0, 0), (0, Wb - a.shape[1])] + [(0, 0)] * (a.ndim - 2)
        return jnp.pad(a, pads, constant_values=fill)

    pixels = pad_w(pixels)
    # absent bias/rig planes are stored as None (pytree-empty), not zero
    # arrays — they would otherwise double the state's device footprint for
    # the common no-mask case (cfg.has_bias/has_rig gate every use)
    if cfg.has_bias:
        assert bias is not None, "cfg.has_bias set but no bias given"
        bias = pad_w(jnp.asarray(bias, jnp.float32))
    else:
        bias = None
    if cfg.has_rig:
        assert rig is not None, "cfg.has_rig set but no rig given"
        rig = pad_w(jnp.asarray(rig, jnp.float32))
    else:
        rig = None
    aux_p = tuple(pad_w(jnp.asarray(a, jnp.uint8).reshape(H, w, -1))
                  for a in aux)
    assert tuple(a.shape[2] for a in aux_p) == tuple(cfg.aux_channels)
    vs = jnp.zeros((H, Wb), jnp.int32)
    return MapState(
        ref=pixels, bias=bias, rig=rig, vs=vs, aux=aux_p,
        cur_b=reader_plane(pixels, cfg.nrg), cur_bias=bias, cur_rig=rig,
        ref_w=jnp.int32(w), depth=jnp.int32(0),
    )
