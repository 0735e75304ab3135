"""The ``Carver`` host API — accelerator-native re-expression of liblqr's
carver.

Re-exposes every capability the reference plugin uses (SURVEY.md §2.3):

| liblqr symbol                          | here                              |
|----------------------------------------|-----------------------------------|
| lqr_carver_new / _init                 | Carver(pixels, delta_x, rigidity) |
| lqr_carver_bias_add_rgb_area           | Carver.bias_add                   |
| lqr_carver_rigmask_add_rgb_area        | Carver.rigmask_add                |
| lqr_carver_set_energy_function_builtin | Carver.set_energy_function        |
| lqr_carver_set_resize_order            | Carver.set_resize_order           |
| lqr_carver_set_side_switch_frequency   | Carver.set_side_switch_frequency  |
| lqr_carver_set_enl_step                | Carver.set_enl_step               |
| lqr_carver_set_dump_vmaps              | Carver.set_dump_vmaps             |
| lqr_carver_set_progress                | Carver.set_progress               |
| lqr_carver_attach                      | Carver.attach                     |
| lqr_carver_resize                      | Carver.resize                     |
| lqr_carver_flatten                     | Carver.flatten                    |
| lqr_carver_scan_line / scan_by_row     | Carver.get_image / .scan_by_row   |
| lqr_carver_get_* introspection         | properties                        |
| lqr_vmap_dump / list                   | Carver.vmap_dump / .vmaps         |

The host class owns orientation (the engine always carves vertical seams;
horizontal resizes run on transposed buffers, like liblqr's internal
``transposed`` flag) and the multi-pass enlargement stepping
(``enl_step``, /root/reference/help/en/index.wiki:91). All pixel data stays
on device; only ``get_image``/``vmap_dump`` pull to host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from .config import (EnergyFunc, ResizeOrder, DEFAULT_SIDE_SWITCH_FREQUENCY,
                     MAX_DELTA_X, MAX_ENL_STEP, MIN_ENL_STEP)
from .errors import (LqrConfigError, LqrImageError, LqrStateError,
                     check_channels, check_target_size)
from .core.state import EngineConfig, init_state, round_up
from .core import engine as eng
from .i18n import _
from . import oracle as _oracle  # strength() reader shared with the oracle


@dataclasses.dataclass
class VMap:
    """A recorded visibility map (lqr_vmap_* surface, SURVEY.md §2.3).

    ``data`` is [ref_h, ref_w] int32 in image (non-transposed) coordinates;
    value 0 = never carved, s in 1..depth = seam order. ``orientation``:
    0 = vertical seams (width resize), 1 = horizontal seams.
    """

    data: np.ndarray
    depth: int
    ref_w: int
    ref_h: int
    orientation: int


def _bucket(w: int) -> int:
    return max(128, round_up(w, 128))


def place_mask_numpy(mask: np.ndarray, H: int, W: int, x_off: int,
                     y_off: int) -> np.ndarray:
    """Pure-NumPy mask placement (the codec.place_mask fallback)."""
    s = _oracle.strength(mask)
    field = np.zeros((H, W), np.float32)
    hm, wm = s.shape
    y0, y1 = max(0, y_off), min(H, y_off + hm)
    x0, x1 = max(0, x_off), min(W, x_off + wm)
    if y1 > y0 and x1 > x0:
        field[y0:y1, x0:x1] = s[y0 - y_off:y1 - y_off, x0 - x_off:x1 - x_off]
    return field


class Carver:
    """A carver over an [H, W, C] uint8 image (C in 1..4)."""

    def __init__(self, pixels: np.ndarray, delta_x: int = 1,
                 rigidity: float = 0.0):
        pixels = np.ascontiguousarray(np.asarray(pixels, np.uint8))
        if pixels.ndim == 2:
            pixels = pixels[:, :, None]
        h, w, c = pixels.shape
        check_channels(c)
        if not 0 <= int(delta_x) <= MAX_DELTA_X:
            raise LqrConfigError(
                _("delta_x={v} out of range 0..{hi}")
                .format(v=delta_x, hi=MAX_DELTA_X))
        if rigidity < 0:
            raise LqrConfigError(
                _("rigidity={v} must be >= 0").format(v=rigidity))
        self.delta_x = int(delta_x)
        self.rigidity = float(rigidity)
        self.nrg = EnergyFunc.GRAD_XABS
        self.res_order = ResizeOrder.HOR
        self.side_switch_freq = DEFAULT_SIDE_SWITCH_FREQUENCY
        self.enl_step = 1.5
        self.dump_vmaps = False
        self.progress = None

        self._C = c
        # reference arrays, image-global orientation ([h, w] layout)
        self._ref_img = jnp.asarray(pixels)
        self._ref_bias = None               # f32 [h, w] or None
        self._ref_rig = None                # f32 [h, w] or None
        self._aux: list[jnp.ndarray] = []   # u8 [h, w, C_i]
        self._ref_w, self._ref_h = w, h
        self._w, self._h = w, h             # current materialized size
        # live map
        self._state = None
        self._cfg: EngineConfig | None = None
        self._orientation = 0
        self._vmaps: list[VMap] = []
        # host-side mirrors of the live map's depth and local ref width:
        # both are deterministic on the host, so the orchestration (resize
        # / flatten / dump) never waits on the device for bookkeeping
        self._depth_h = 0
        self._map_ref_w = 0

    # -- liblqr setters -----------------------------------------------------

    def set_energy_function(self, nrg: EnergyFunc):
        self._drop_map()
        self.nrg = EnergyFunc(nrg)

    def set_resize_order(self, order: ResizeOrder):
        self.res_order = ResizeOrder(order)

    def set_side_switch_frequency(self, f: int):
        self.side_switch_freq = int(f)

    def set_enl_step(self, step: float):
        if not MIN_ENL_STEP <= step <= MAX_ENL_STEP:
            raise LqrConfigError(
                _("enl_step={v} out of range [{lo}, {hi}] (100.1%-200%)")
                .format(v=step, lo=MIN_ENL_STEP, hi=MAX_ENL_STEP))
        self.enl_step = float(step)

    def set_dump_vmaps(self, flag: bool = True):
        self.dump_vmaps = bool(flag)

    def set_progress(self, progress):
        """progress: object with .init(msg), .update(frac), .end() — the
        LqrProgress protocol (/root/reference/src/render.c:767-779)."""
        self.progress = progress

    # -- masks --------------------------------------------------------------

    def bias_add(self, mask: np.ndarray, factor: float,
                 x_off: int = 0, y_off: int = 0):
        """lqr_carver_bias_add_rgb_area (SPEC.md §3). mask: [hm, wm(,C)] u8
        placed at (x_off, y_off) relative to the image; adds
        strength * factor/1000 to the energy bias of overlapping pixels."""
        self._flatten_if_carved()
        field = self._place_mask(mask, x_off, y_off)
        add = field * jnp.float32(float(factor) / 1000.0)
        self._ref_bias = add if self._ref_bias is None else self._ref_bias + add
        self._drop_map()

    def rigmask_add(self, mask: np.ndarray, x_off: int = 0, y_off: int = 0):
        """lqr_carver_rigmask_add_rgb_area (SPEC.md §4): per-pixel rigidity
        multiplier = mask strength (0 outside the mask area)."""
        self._flatten_if_carved()
        field = self._place_mask(mask, x_off, y_off)
        self._ref_rig = field if self._ref_rig is None else self._ref_rig + field
        self._drop_map()

    def _place_mask(self, mask, x_off, y_off) -> jnp.ndarray:
        """Strength field of a mask placed at an offset, on image coords
        (placement rule of /root/reference/src/io_functions.c:70-100).

        Runs through the native C++ marshalling path (the io_functions.c
        replacement, native/imagecodec.cpp lqr_place_mask) with a NumPy
        fallback when the native lib can't build; both produce the
        identical f32 field (tested in test_codec)."""
        mask = np.asarray(mask, np.uint8)
        try:
            from .utils import codec
            field = codec.place_mask(mask, self._ref_h, self._ref_w,
                                     x_off, y_off)
        except Exception:
            field = place_mask_numpy(mask, self._ref_h, self._ref_w,
                                     x_off, y_off)
        return jnp.asarray(field)

    # -- aux carvers --------------------------------------------------------

    def attach(self, aux_pixels: np.ndarray):
        """lqr_carver_attach: aux image (same h, w; any channels) undergoes
        the identical seam sequence (/root/reference/src/render.c:243-248)."""
        self._flatten_if_carved()
        a = np.asarray(aux_pixels, np.uint8)
        if a.ndim == 2:
            a = a[:, :, None]
        if a.shape[:2] != (self._ref_h, self._ref_w):
            # size law: /root/reference/src/render.c:881-900
            raise LqrImageError(
                _("attached aux carver is {aw}x{ah}, main image is "
                  "{w}x{h}; attached carvers must match the main size")
                .format(aw=a.shape[1], ah=a.shape[0], w=self._ref_w,
                        h=self._ref_h))
        check_channels(a.shape[2], "aux carver")
        self._aux.append(jnp.asarray(a))
        self._drop_map()

    # -- map plumbing -------------------------------------------------------

    def _drop_map(self):
        """Invalidate an (uncarved) map so config changes take effect.

        Callers must have committed carved seams first
        (``_flatten_if_carved``); dropping a carved map would silently lose
        the seam history."""
        if self._state is not None and self._depth_h:
            raise LqrStateError(
                _("internal: dropping a map with carved seams — this is "
                  "a bug; callers must flatten first"))
        self._state = None
        self._cfg = None

    def _flatten_if_carved(self):
        if self._state is not None and self._depth_h:
            self.flatten()

    def _local_dims(self, orientation):
        if orientation == 0:
            return self._ref_h, self._ref_w
        return self._ref_w, self._ref_h

    def _build_map(self, orientation: int):
        """Create a fresh MapState in the given orientation."""
        H, W = self._local_dims(orientation)
        Wb = _bucket(W)
        img = self._ref_img
        bias = self._ref_bias
        rig = self._ref_rig
        aux = list(self._aux)
        if orientation == 1:
            img = jnp.swapaxes(img, 0, 1)
            bias = None if bias is None else jnp.swapaxes(bias, 0, 1)
            rig = None if rig is None else jnp.swapaxes(rig, 0, 1)
            aux = [jnp.swapaxes(a, 0, 1) for a in aux]
        cfg = EngineConfig(
            H=H, Wb=Wb, C=self._C, delta_x=self.delta_x, nrg=int(self.nrg),
            side_switch_freq=self.side_switch_freq,
            aux_channels=tuple(a.shape[2] for a in aux),
            has_bias=bias is not None,
            has_rig=rig is not None or self.rigidity > 0,
        )
        rig_field = None
        if cfg.has_rig:
            # per-pixel rigidity = global rigidity x mask strength (or
            # global alone when no mask) — SPEC.md §4
            if rig is not None:
                rig_field = rig * jnp.float32(self.rigidity)
            else:
                rig_field = jnp.full((H, W), jnp.float32(self.rigidity))
        self._state = init_state(cfg, img, bias=bias, rig=rig_field, aux=aux)
        self._cfg = cfg
        self._orientation = orientation
        self._depth_h = 0
        self._map_ref_w = W

    def _ensure_map(self, orientation: int):
        if self._state is not None and self._orientation == orientation:
            return
        if self._state is not None:
            self.flatten()
        self._build_map(orientation)

    def _record_vmap(self):
        """Snapshot the live map as a VMap (lqr_vmap_dump semantics)."""
        if self._state is None:
            return None
        depth = self._depth_h
        if depth == 0:
            return None
        H, W = self._local_dims(self._orientation)
        vs = np.asarray(jax.device_get(self._state.vs))[:, :W]
        if self._orientation == 1:
            vs = vs.T
        vm = VMap(data=vs, depth=depth, ref_w=self._ref_w,
                  ref_h=self._ref_h, orientation=self._orientation)
        self._vmaps.append(vm)
        return vm

    # -- core ops -----------------------------------------------------------

    def _extend(self, need_depth: int):
        """Extend the live map to depth >= need_depth."""
        st = self._state
        depth = self._depth_h
        k = need_depth - depth
        if k <= 0:
            return
        prog = self.progress
        if prog is not None:
            from .i18n import _
            msg = (_("Resizing width...") if self._orientation == 0
                   else _("Resizing height..."))
            prog.init(msg)
            chunks = max(1, min(k, 20))
            base = k // chunks
            done = 0
            for i in range(chunks):
                step = base + (1 if i < k % chunks else 0)
                if step == 0:
                    continue
                st = eng.extend_map(self._cfg, st, jnp.int32(step))
                done += step
                # publish state + depth per completed chunk: a raising
                # progress callback (or a later extend failure) then
                # leaves the carver consistent at chunk granularity
                # (ADVICE r4: the old code claimed the FINAL depth before
                # any carving ran), and extend_map's donated input is
                # always an already-superseded state
                self._state = st
                self._depth_h = depth + done
                prog.update(done / k)
            prog.end()
        else:
            st = eng.extend_map(self._cfg, st, jnp.int32(k))
            self._state = st
            self._depth_h = need_depth

    def _resize_axis(self, orientation: int, target: int):
        """Resize the axis carved by the given orientation to target."""
        cur = self._w if orientation == 0 else self._h
        if target == cur:
            return
        if target < 1:
            raise LqrConfigError(
                _("target {axis} {v} is invalid; must be >= 1")
                .format(axis=_("width") if orientation == 0
                        else _("height"), v=target))
        while True:
            self._ensure_map(orientation)
            ref = self._ref_w if orientation == 0 else self._ref_h
            if target <= ref:
                self._extend(ref - target)
                self._set_cur(orientation, target)
                return
            # enlargement, possibly multi-pass (SPEC.md §7)
            cap = max(ref + 1, int(ref * self.enl_step))
            pass_target = min(target, cap)
            k = min(pass_target - ref, ref - 1)
            pass_target = ref + k
            self._extend(k)
            self._set_cur(orientation, pass_target)
            if pass_target == target:
                return
            if self.dump_vmaps:
                # liblqr records one visibility map per resize PASS: each
                # internal enlargement pass dumps before its flatten, and
                # write_all_vmaps emits one layer per recorded map
                # (/root/reference/src/io_functions.c:292-314, enabled at
                # render.c:241, written at render.c:340-346)
                self._record_vmap()
            self.flatten()   # restart for the next enlargement pass

    def _set_cur(self, orientation, v):
        if orientation == 0:
            self._w = v
        else:
            self._h = v

    def resize(self, width: int, height: int):
        """lqr_carver_resize: carve/insert to (width, height), axes in
        res_order (/root/reference/src/render.c:235, 318)."""
        order = ([0, 1] if self.res_order == ResizeOrder.HOR else [1, 0])
        for orientation in order:
            target = width if orientation == 0 else height
            before = self._w if orientation == 0 else self._h
            self._resize_axis(orientation, target)
            if (self.dump_vmaps and target != before):
                self._record_vmap()

    def flatten(self):
        """lqr_carver_flatten: current size becomes the new reference."""
        st, cfg = self._state, self._cfg
        if st is None:
            return
        w_local = self._w if self._orientation == 0 else self._h
        out_Wb = _bucket(max(w_local, self._map_ref_w))
        img, bias, rig, aux = eng.materialize_all(cfg, st, jnp.int32(w_local),
                                                  out_Wb)
        img = img[:, :w_local]
        if cfg.has_bias:
            bias = bias[:, :w_local]
        rig_np = rig[:, :w_local] if cfg.has_rig else None
        aux = [a[:, :w_local] for a in aux]
        if self._orientation == 1:
            img = jnp.swapaxes(img, 0, 1)
            bias = None if not cfg.has_bias else jnp.swapaxes(bias, 0, 1)
            rig_np = None if rig_np is None else jnp.swapaxes(rig_np, 0, 1)
            aux = [jnp.swapaxes(a, 0, 1) for a in aux]
        self._ref_img = img
        self._ref_bias = bias if cfg.has_bias else None
        # rig field folds the global rigidity in; unfold so _build_map can
        # re-apply it (keep as mask-equivalent: field / rigidity)
        if rig_np is not None and self.rigidity > 0:
            self._ref_rig = rig_np / jnp.float32(self.rigidity)
        elif rig_np is not None:
            self._ref_rig = rig_np
        else:
            self._ref_rig = None
        self._aux = aux
        self._ref_w, self._ref_h = self._w, self._h
        self._state = None
        self._cfg = None

    # -- output -------------------------------------------------------------

    def _materialized(self, arr_kind: str = "main"):
        """Current image (and aux) as device arrays, image orientation."""
        if self._state is None:
            return self._ref_img, list(self._aux)
        st, cfg = self._state, self._cfg
        w_local = self._w if self._orientation == 0 else self._h
        out_Wb = _bucket(max(w_local, self._map_ref_w))
        img, _, _, aux = eng.materialize_all(cfg, st, jnp.int32(w_local),
                                             out_Wb)
        img = img[:, :w_local]
        aux = [a[:, :w_local] for a in aux]
        if self._orientation == 1:
            img = jnp.swapaxes(img, 0, 1)
            aux = [jnp.swapaxes(a, 0, 1) for a in aux]
        return img, aux

    def get_image(self) -> np.ndarray:
        """Current materialized image, [h, w, C] uint8 (the
        write_carver_to_layer output stream, image orientation)."""
        img, _ = self._materialized()
        return np.asarray(jax.device_get(img))

    def get_image_device(self):
        """Current materialized image as a DEVICE array ([h, w, C] u8,
        image orientation) — for device-resident pipelines that feed the
        result onward without a host round trip (``get_image`` fetches
        to host)."""
        img, _ = self._materialized()
        return img

    def get_aux(self, i: int) -> np.ndarray:
        """Current materialized aux carver i (identical seam sequence)."""
        _, aux = self._materialized()
        return np.asarray(jax.device_get(aux[i]))

    def vmap_dump(self) -> VMap | None:
        """lqr_vmap_dump: snapshot the current visibility map."""
        return self._record_vmap()

    @property
    def vmaps(self) -> list[VMap]:
        """lqr_vmap_list: all recorded maps."""
        return list(self._vmaps)

    # -- introspection (lqr_carver_get_*) -----------------------------------

    @property
    def width(self) -> int:
        return self._w

    @property
    def height(self) -> int:
        return self._h

    @property
    def channels(self) -> int:
        return self._C

    @property
    def ref_width(self) -> int:
        return self._ref_w

    @property
    def ref_height(self) -> int:
        return self._ref_h

    @property
    def orientation(self) -> int:
        return self._orientation

    @property
    def depth(self) -> int:
        if self._state is None:
            return 0
        return self._depth_h

    @property
    def scan_by_row(self) -> bool:
        """lqr_carver_scan_by_row: False when the map is transposed."""
        return self._orientation == 0
