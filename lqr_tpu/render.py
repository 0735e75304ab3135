"""Render orchestration — the render.c replacement (SURVEY.md §2 L2).

Mirrors the five entry points of /root/reference/src/render.h:44-67 over the
GIMP-free image model:

- ``init_carver``          <- render_init_carver   (render.c:104-273)
- ``render_noninteractive``<- render_noninteractive(render.c:275-463)
- ``render_interactive``   <- render_interactive   (render.c:465-574)
- ``render_flatten``       <- render_flatten       (render.c:576-681)
- ``render_dump_vmap``     <- render_dump_vmap     (render.c:683-759)

The carve engine underneath is the device carver (lqr_tpu.carver.Carver); this
layer owns output targets, aux-layer cropping, scaleback modes, seam-map
layers, and alpha-lock restoration.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .config import (LqrConfig, SeamColors, OutputTarget, ScalebackMode,
                     MaskBehavior, ResizeOrder, layer_ref_set)
from .carver import Carver
from .image_model import Image, Layer, bilinear_scale
from .vmap_render import render_vmap


def rigidity_init(cfg: LqrConfig) -> float:
    """Rigidity x3 when a rigidity mask is used
    (/root/reference/src/render.c:781-792)."""
    if layer_ref_set(cfg.rigmask_layer):
        return 3.0 * cfg.rigidity
    return float(cfg.rigidity)


def compute_ignore_disc_mask(cfg: LqrConfig, old_w: int, old_h: int,
                             new_w: int, new_h: int) -> bool:
    """The no-disc-on-enlarge predicate
    (/root/reference/src/render.c:794-821): drop the discard mask when the
    first scaling direction (per res_order) enlarges."""
    if not cfg.no_disc_on_enlarge:
        return False
    if cfg.res_order == ResizeOrder.HOR:
        return (new_w > old_w) or (new_w == old_w and new_h > old_h)
    return (new_h > old_h) or (new_h == old_h and new_w > old_w)


@dataclasses.dataclass
class CarverData:
    """The CarverData struct (/root/reference/src/render.h:22-38)."""

    carver: Carver
    image: Image
    layer_name: str
    alpha_lock: bool = False
    alpha_lock_pres: bool = False
    alpha_lock_disc: bool = False
    alpha_lock_rigmask: bool = False
    aux_names: tuple = ()            # names of attached aux layers, in order
    seam_layer_name: str | None = None   # reused vmap layer (interactive)

    # introspection mirrors (refreshed by render_interactive)
    ref_w: int = 0
    ref_h: int = 0
    orientation: int = 0
    depth: int = 0
    enl_step: float = 1.5


def _crop_aux_to_layer(image: Image, ref, layer: Layer) -> bool:
    """resize_unlock_aux_layer (/root/reference/src/render.c:865-879): crop
    the aux layer to the active layer's bounds; returns its old alpha lock.
    ``ref`` is a layer name or int ID (main.c:556-576)."""
    aux = image.layer_ref(ref)
    if aux is None:
        return False
    lock = aux.alpha_lock
    aux.alpha_lock = False
    aux.resize(layer.width, layer.height,
               aux.x_off - layer.x_off, aux.y_off - layer.y_off)
    return lock


def init_carver(image: Image, cfg: LqrConfig, interactive: bool = False,
                progress=None) -> CarverData:
    """Build and fully configure the carver (render_init_carver)."""
    layer = (image.layer_ref(cfg.selected_layer_name)
             or image.active_layer)

    # UNMASK (render.c:147): apply or discard the layer mask
    if layer.mask is not None:
        if cfg.mask_behavior == MaskBehavior.APPLY:
            layer.apply_mask()
        else:
            layer.discard_mask()

    old_w, old_h = layer.width, layer.height

    ignore_disc = False
    if not interactive:
        ignore_disc = compute_ignore_disc_mask(
            cfg, old_w, old_h, cfg.new_width, cfg.new_height)

    # output target (render.c:170-196)
    if cfg.output_target == OutputTarget.NEW_LAYER:
        new_layer = layer.copy(name=f"{layer.name} LqR")
        new_layer.visible = False
        image.add_layer(new_layer, 0)
        work_layer = new_layer
    elif cfg.output_target == OutputTarget.NEW_IMAGE:
        x_off, y_off = layer.x_off, layer.y_off
        new_image = Image(width=old_w, height=old_h)
        work_layer = layer.copy()
        work_layer.translate(-x_off, -y_off)
        work_layer.visible = True
        new_image.add_layer(work_layer, 0)
        new_image.active = work_layer.name
        if cfg.resize_aux_layers:
            for aux_ref in (cfg.pres_layer, cfg.disc_layer,
                            cfg.rigmask_layer):
                aux = image.layer_ref(aux_ref)
                if aux is not None:
                    a2 = aux.copy()
                    # keep the ID so ID-based refs resolve in the new image
                    a2.layer_id = aux.layer_id
                    a2.translate(-x_off, -y_off)
                    new_image.add_layer(a2, 0)
        image = new_image
        layer = work_layer
    else:
        work_layer = layer

    alpha_lock = work_layer.alpha_lock
    work_layer.alpha_lock = False

    lock_pres = lock_disc = lock_rig = False
    if cfg.resize_aux_layers:
        lock_pres = _crop_aux_to_layer(image, cfg.pres_layer, work_layer)
        lock_disc = _crop_aux_to_layer(image, cfg.disc_layer, work_layer)
        lock_rig = _crop_aux_to_layer(image, cfg.rigmask_layer, work_layer)

    carver = Carver(work_layer.pixels, delta_x=cfg.delta_x,
                    rigidity=rigidity_init(cfg))
    if progress is not None:
        carver.set_progress(progress)

    def _mask_args(ref):
        aux = image.layer_ref(ref)
        if aux is None:
            return None
        return (aux.pixels, aux.x_off - work_layer.x_off,
                aux.y_off - work_layer.y_off)

    m = _mask_args(cfg.pres_layer)
    if m is not None and cfg.pres_coeff != 0:
        carver.bias_add(m[0], cfg.pres_coeff, m[1], m[2])
    if not ignore_disc:
        m = _mask_args(cfg.disc_layer)
        if m is not None and cfg.disc_coeff != 0:
            carver.bias_add(m[0], -cfg.disc_coeff, m[1], m[2])
    m = _mask_args(cfg.rigmask_layer)
    if m is not None:
        carver.rigmask_add(m[0], m[1], m[2])

    carver.set_energy_function(cfg.nrg_func)
    carver.set_resize_order(cfg.res_order)
    carver.set_side_switch_frequency(2)     # render.c:237
    carver.set_enl_step(cfg.enl_step)
    if (not interactive) and cfg.output_seams:
        carver.set_dump_vmaps(True)

    aux_names = []
    if cfg.resize_aux_layers:
        for aux_ref in (cfg.pres_layer, cfg.disc_layer, cfg.rigmask_layer):
            aux = image.layer_ref(aux_ref)
            if aux is not None:
                carver.attach(aux.pixels)
                aux_names.append(aux_ref)

    return CarverData(
        carver=carver, image=image, layer_name=work_layer.name,
        alpha_lock=alpha_lock, alpha_lock_pres=lock_pres,
        alpha_lock_disc=lock_disc, alpha_lock_rigmask=lock_rig,
        aux_names=tuple(aux_names),
        ref_w=old_w, ref_h=old_h, orientation=0, depth=0,
        enl_step=cfg.enl_step,
    )


def _write_vmaps(cd: CarverData, colors: SeamColors, x_off: int, y_off: int,
                 reuse: bool = False):
    """write_all_vmaps (/root/reference/src/io_functions.c:292-314):
    one RGBA layer per recorded map, named '<layer> seam map'."""
    name = f"{cd.layer_name} seam map"
    for vm in cd.carver.vmaps:
        rgba = render_vmap(vm.data, vm.depth, colors)
        existing = cd.image.layer_by_name(name) if reuse else None
        if existing is not None and reuse:
            existing.pixels = rgba
            existing.x_off, existing.y_off = x_off, y_off
        else:
            cd.image.add_layer(Layer(name=name, pixels=rgba,
                                     x_off=x_off, y_off=y_off), 0)
        cd.seam_layer_name = name
    cd.carver._vmaps.clear()


def _write_back(cd: CarverData, cfg: LqrConfig, new_w: int, new_h: int):
    """Write carver + aux outputs into their layers (render.c:348-374)."""
    image = cd.image
    layer = image.layer_by_name(cd.layer_name)
    x_off, y_off = layer.x_off, layer.y_off
    if cfg.resize_canvas:
        image.resize_canvas(new_w, new_h, -x_off, -y_off)
        layer.resize(new_w, new_h, layer.x_off, layer.y_off)
    else:
        layer.resize(new_w, new_h, 0, 0)
    layer.pixels = cd.carver.get_image()
    for i, aux_ref in enumerate(cd.aux_names):
        aux = image.layer_ref(aux_ref)
        aux.resize(new_w, new_h, 0, 0)
        aux.pixels = cd.carver.get_aux(i)


def _scale_layer_translated(layer: Layer, w: int, h: int,
                            x_off: int, y_off: int):
    """scale_layer_translated (/root/reference/src/render.c:918-925)."""
    layer.translate(-x_off, -y_off)
    layer.scale(w, h)
    layer.translate(x_off, y_off)


def render_noninteractive(cfg: LqrConfig, colors: SeamColors,
                          cd: CarverData) -> bool:
    """The benchmark path (render.c:275-463, call stack SURVEY.md §3.1)."""
    carver = cd.carver
    image = cd.image
    layer = image.layer_by_name(cd.layer_name)
    old_w, old_h = layer.width, layer.height
    x_off, y_off = layer.x_off, layer.y_off
    new_w, new_h = cfg.new_width, cfg.new_height

    carver.resize(new_w, new_h)

    if cfg.scaleback and cfg.scaleback_mode == ScalebackMode.LQRBACK:
        carver.flatten()
        new_w, new_h = old_w, old_h
        carver.resize(new_w, new_h)

    if cfg.output_seams:
        _write_vmaps(cd, colors, x_off, y_off)

    _write_back(cd, cfg, new_w, new_h)

    if cfg.scaleback and cfg.scaleback_mode != ScalebackMode.LQRBACK:
        # std scaleback variants (render.c:378-434)
        if cfg.scaleback_mode == ScalebackMode.STD:
            sb_w, sb_h = old_w, old_h
        elif cfg.scaleback_mode == ScalebackMode.STDW:
            sb_w = old_w
            sb_h = int(new_h * old_w / new_w)
        else:  # STDH
            sb_w = int(new_w * old_h / new_h)
            sb_h = old_h
        layer = image.layer_by_name(cd.layer_name)
        if cfg.resize_canvas:
            image.resize_canvas(sb_w, sb_h, 0, 0)
            layer.scale(sb_w, sb_h)
        else:
            _scale_layer_translated(layer, sb_w, sb_h, x_off, y_off)
        if cfg.resize_aux_layers:
            for aux_ref in cd.aux_names:
                aux = image.layer_ref(aux_ref)
                if aux is not None:
                    _scale_layer_translated(aux, sb_w, sb_h, x_off, y_off)

    # restore visibility + locks (render.c:440-460)
    layer = image.layer_by_name(cd.layer_name)
    layer.visible = True
    image.active = cd.layer_name
    layer.alpha_lock = cd.alpha_lock
    if cfg.resize_aux_layers:
        locks = ((cfg.pres_layer, cd.alpha_lock_pres),
                 (cfg.disc_layer, cd.alpha_lock_disc),
                 (cfg.rigmask_layer, cd.alpha_lock_rigmask))
        for ref, lock in locks:
            aux = image.layer_ref(ref)
            if aux is not None:
                aux.alpha_lock = lock
    return True


def revalidate_interactive(cd: CarverData) -> bool:
    """Re-check externally mutable state before an interactive render
    (render.c:485-500 plus the BPP_CHECK / IMAGE_TYPE_CHECK macros,
    render.c:48-62): the work layer must still exist with the carver's
    channel count, and every attached aux layer must still be present.
    Returns False for the FATAL response path (main.c:376-379)."""
    layer = cd.image.layer_by_name(cd.layer_name)
    if layer is None:
        return False
    if layer.bpp != cd.carver.channels:
        return False
    for aux_ref in cd.aux_names:
        if cd.image.layer_ref(aux_ref) is None:
            return False
    return True


def render_interactive(cfg: LqrConfig, cd: CarverData,
                       new_w: int, new_h: int) -> bool:
    """One interactive step (render.c:465-574): incremental resize +
    write-back + map-info refresh."""
    if not revalidate_interactive(cd):
        return False
    carver = cd.carver
    carver.resize(new_w, new_h)
    _write_back(cd, cfg, new_w, new_h)
    cd.ref_w, cd.ref_h = carver.ref_width, carver.ref_height
    cd.orientation = carver.orientation
    cd.depth = carver.depth
    cd.enl_step = carver.enl_step
    return True


def render_flatten(cd: CarverData) -> bool:
    """Map reset (render.c:576-681)."""
    cd.carver.flatten()
    cd.ref_w, cd.ref_h = cd.carver.ref_width, cd.carver.ref_height
    cd.depth = 0
    return True


def render_dump_vmap(cd: CarverData, colors: SeamColors) -> bool:
    """Manual seam-map dump (render.c:683-759): renders the current map into
    a reused RGBA layer."""
    vm = cd.carver.vmap_dump()
    if vm is None:
        return False
    layer = cd.image.layer_by_name(cd.layer_name)
    _write_vmaps(cd, colors, layer.x_off, layer.y_off, reuse=True)
    return True
