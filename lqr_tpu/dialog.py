"""Headless main dialog + plugin run-mode dispatch.

Two reference components live here without GTK:

- ``MainDialog`` — the capability surface and live state of the main
  dialog (/root/reference/src/interface.c, 2256 LoC): the size
  coordinates with chain link, feature-mask activation and layer
  eligibility, the disc-on-enlarge warning that tracks the current size
  (interface.c:857-902), the refresh/rebuild logic that revalidates the
  layer stack after external edits (interface.c:1066-1108), and the
  Reset response law (back to compiled defaults, main.c:336-340).

- ``run_plugin`` — the PDB ``run()`` dispatch state machine
  (/root/reference/src/main.c:296-450): NONINTERACTIVE takes a full
  config; INTERACTIVE retrieves stored values and loops a dialog driver
  through the response protocol (OK / RESET / INTERACTIVE /
  WORK_ON_AUX_LAYER / FATAL, main.h:26-33), saving values on success;
  WITH_LAST_VALS replays the stored config with aux masks re-resolved by
  name.
"""

from __future__ import annotations

import enum

from .config import LqrConfig, SeamColors, AuxLayerType, layer_ref_set
from .errors import LqrError
from .i18n import _
from .image_model import Image
from .masks import MaskEditSession
from .render import compute_ignore_disc_mask, init_carver, \
    render_noninteractive
from .settings import (SettingsStore, UIVals, save_vals, save_ui_vals,
                       retrieve_vals, retrieve_ui_vals,
                       retrieve_vals_use_aux_layers_names)
from .sizeentry import Coordinates


class Response(enum.IntEnum):
    """Dialog responses (/root/reference/src/main.h:26-33)."""

    OK = 0
    CANCEL = 1
    RESET = 2
    INTERACTIVE = 3
    WORK_ON_AUX_LAYER = 4
    FATAL = 5


class RunMode(enum.IntEnum):
    """GIMP run modes the plugin dispatches on (main.c:306-394)."""

    INTERACTIVE = 0
    NONINTERACTIVE = 1
    WITH_LAST_VALS = 2


class MainDialog:
    """The main dialog's state, headless.

    A UI (or a test) drives it through the same operations the GTK
    dialog exposes; every law is the reference's.
    """

    def __init__(self, image: Image, cfg: LqrConfig | None = None,
                 colors: SeamColors | None = None,
                 ui: UIVals | None = None):
        self.image = image
        self.cfg = cfg or LqrConfig()
        self.colors = colors or SeamColors()
        self.ui = ui or UIVals()
        layer = image.active_layer
        if not self.cfg.selected_layer_name:
            self.cfg = self.cfg.replace(selected_layer_name=image.active)
        # size section: chain link constrains the ORIGINAL aspect ratio;
        # the chain state is restored from the persisted UI record
        # (interface.c:387 passes ui_state->chain_active into
        # alt_coordinates_new)
        self.size = Coordinates(layer.width, layer.height,
                                chain_active=self.ui.chain_active)
        self.size.set_width(self.cfg.new_width)
        self.size.set_height(self.cfg.new_height)
        # expander states persist across sessions (main.h:62-63)
        self.seams_control_expanded = self.ui.seams_control_expanded
        self.operations_expanded = self.ui.operations_expanded
        self.refresh()

    # -- persisted UI state --------------------------------------------------

    def last_values_available(self) -> bool:
        """Sensitivity of the "Last used values" button: both stored
        dimensions present (interface.c:462-465)."""
        return (self.ui.last_used_width != -1
                and self.ui.last_used_height != -1)

    def use_last_values(self):
        """The "Last used values" button: size entries jump to the
        previous run's target size (callback_lastvalues_button,
        interface.c:963-975)."""
        if not self.last_values_available():
            raise LqrError(_("no last-used size is stored"))
        self.set_new_size(width=self.ui.last_used_width)
        self.set_new_size(height=self.ui.last_used_height)

    def snapshot_ui(self) -> UIVals:
        """The post-render UI record (main.c:406-412 + the dialog's
        OK-path saves, interface.c:770-775): statuses reflect the masks
        actually in use, last-used is the rendered target size, and the
        chain/expander states come from the live widgets."""
        return UIVals(
            chain_active=self.size.chain_active,
            pres_status=bool(self.cfg.pres_layer),
            disc_status=bool(self.cfg.disc_layer),
            rigmask_status=bool(self.cfg.rigmask_layer),
            last_used_width=int(self.cfg.new_width),
            last_used_height=int(self.cfg.new_height),
            last_layer_name=(self.cfg.selected_layer_name
                             or self.image.active),
            seams_control_expanded=self.seams_control_expanded,
            operations_expanded=self.operations_expanded)

    # -- size section -------------------------------------------------------

    def set_new_size(self, width=None, height=None, unit=None):
        """Edit the size coordinates (chain/percent laws apply); the
        disc warning below updates live (interface.c:857-902)."""
        if width is not None:
            self.size.set_width(width, unit=unit)
        if height is not None:
            self.size.set_height(height, unit=unit)
        self.cfg = self.cfg.replace(new_width=self.size.width,
                                    new_height=self.size.height)

    def reset_size_to_image(self):
        """The top size-reset button: back to the layer size."""
        self.size.reset()
        self.cfg = self.cfg.replace(new_width=self.size.width,
                                    new_height=self.size.height)

    # -- feature masks ------------------------------------------------------

    def eligible_mask_layers(self) -> list:
        """Layers selectable as masks: same image, not the active layer
        (dialog_layer_constraint, layers_combo.c:45-58)."""
        active = self.cfg.selected_layer_name or self.image.active
        return [l.name for l in self.image.layers if l.name != active]

    def feature_masks_available(self) -> bool:
        """count_extra_layers gate (layers_combo.c:36-43): the mask
        combos need at least one other layer."""
        return len(self.eligible_mask_layers()) > 0

    def disc_warning(self) -> bool:
        """The warning icon by the discard mask: the mask will be
        IGNORED because the first scaling direction enlarges
        (interface.c:857-902 mirrors compute_ignore_disc_mask)."""
        if not layer_ref_set(self.cfg.disc_layer):
            return False
        layer = self.image.layer_ref(
            self.cfg.selected_layer_name) or self.image.active_layer
        return compute_ignore_disc_mask(
            self.cfg, layer.width, layer.height,
            self.cfg.new_width, self.cfg.new_height)

    def new_mask(self, layer_type: AuxLayerType,
                 name: str | None = None) -> MaskEditSession:
        """The New button -> RESPONSE_WORK_ON_AUX_LAYER round trip: opens
        a mask-editor session on a fresh layer and selects it."""
        s = MaskEditSession(self.image, layer_type, name=name)
        self._select_mask(layer_type, s.layer.name)
        return s

    def edit_mask(self, layer_type: AuxLayerType) -> MaskEditSession:
        """The Edit button: session over the currently selected mask."""
        name = {AuxLayerType.PRES: self.cfg.pres_layer,
                AuxLayerType.DISC: self.cfg.disc_layer,
                AuxLayerType.RIGMASK: self.cfg.rigmask_layer}[
                    AuxLayerType(layer_type)]
        layer = self.image.layer_ref(name)
        if layer is None:
            raise LqrError(_("no {type} mask selected to edit").format(
                type=AuxLayerType(layer_type).name))
        return MaskEditSession(self.image, layer_type, layer=layer)

    def _select_mask(self, layer_type: AuxLayerType, name: str):
        key = {AuxLayerType.PRES: "pres_layer",
               AuxLayerType.DISC: "disc_layer",
               AuxLayerType.RIGMASK: "rigmask_layer"}[
                   AuxLayerType(layer_type)]
        self.cfg = self.cfg.replace(**{key: name})

    def select_mask(self, layer_type: AuxLayerType, name: str):
        """The layer combo: must pick an eligible layer."""
        if name and name not in self.eligible_mask_layers():
            raise LqrError(
                _("layer {name!r} is not selectable as a mask (must belong "
                  "to the image and not be the active layer)")
                .format(name=name))
        self._select_mask(layer_type, name)

    # -- refresh / reset ----------------------------------------------------

    def refresh(self):
        """The Refresh response (interface.c:1066-1108): revalidate
        against the (externally mutable) layer stack — mask selections
        whose layers disappeared or became the active layer are
        dropped."""
        eligible = set(self.eligible_mask_layers())
        kw = {}
        for key in ("pres_layer", "disc_layer", "rigmask_layer"):
            name = getattr(self.cfg, key)
            if name and name not in eligible:
                kw[key] = ""
        if kw:
            self.cfg = self.cfg.replace(**kw)

    def reset(self):
        """RESPONSE_RESET (main.c:336-340): all values back to the
        compiled defaults."""
        selected = self.cfg.selected_layer_name
        self.cfg = LqrConfig(selected_layer_name=selected)
        self.colors = SeamColors()
        self.reset_size_to_image()


def run_plugin(image: Image, run_mode: RunMode,
               cfg: LqrConfig | None = None,
               colors: SeamColors | None = None,
               store: SettingsStore | None = None,
               dialog_driver=None):
    """The PDB run() dispatch (main.c:296-450). Returns (image, cfg) of
    the rendered result.

    - NONINTERACTIVE: ``cfg`` is the full parameter record (the 27-arg
      PDB call; missing cfg is the wrong-number-of-arguments error).
    - WITH_LAST_VALS: config replayed from the store, masks by name.
    - INTERACTIVE: stored values retrieved, then ``dialog_driver(dialog)``
      is called repeatedly and must return a Response; RESET restores
      defaults and loops, WORK_ON_AUX_LAYER loops (the driver edits masks
      through the dialog), OK proceeds to render, anything else cancels.
      On success the values are persisted (main.c:438-441).
    """
    run_mode = RunMode(run_mode)
    store = store or SettingsStore()
    colors = colors or SeamColors()

    if run_mode == RunMode.NONINTERACTIVE:
        if cfg is None:
            raise LqrError(
                _("noninteractive run requires a full config"))
    elif run_mode == RunMode.WITH_LAST_VALS:
        cfg, colors = retrieve_vals_use_aux_layers_names(store, image)
    else:
        stored_cfg, stored_colors = retrieve_vals(store)
        dialog = MainDialog(image, cfg or stored_cfg, stored_colors,
                            ui=retrieve_ui_vals(store))
        if dialog_driver is None:
            raise LqrError(_("interactive run requires a dialog driver"))
        while True:
            resp = Response(dialog_driver(dialog))
            if resp == Response.OK:
                cfg, colors = dialog.cfg, dialog.colors
                break
            if resp == Response.RESET:
                dialog.reset()
                continue
            if resp == Response.WORK_ON_AUX_LAYER:
                dialog.refresh()
                continue
            if resp == Response.FATAL:
                raise LqrError(_("dialog reported a fatal state"))
            return image, None          # CANCEL: no render, nothing saved

    cd = init_carver(image, cfg)
    ok = render_noninteractive(cfg, colors, cd)
    if not ok:
        raise LqrError(_("render failed"))
    if run_mode == RunMode.INTERACTIVE:
        save_vals(store, cfg, colors,
                  pres_status=bool(cfg.pres_layer),
                  disc_status=bool(cfg.disc_layer),
                  rigmask_status=bool(cfg.rigmask_layer))
        # persist the UI record alongside (save_vals, main.c:495):
        # chain/expander state from the live dialog, statuses + last-used
        # size from the rendered config (main.c:406-412)
        save_ui_vals(store, dialog.snapshot_ui())
    return cd.image, cfg
