"""Settings persistence — the gimp_set_data/gimp_get_data replacement.

The reference persists its parameter records across invocations under the
keys ``plug_in_lqr`` / ``plug_in_lqr_ui`` / ``plug_in_lqr_col``
(/root/reference/src/main.c:487-506, keys main_common.h:26-29). That store
is also the GAP interop ABI: the animation iterator writes a per-frame
blended config under ``plug_in_lqr`` for the following
RUN_WITH_LAST_VALS invocation to pick up (/root/reference/gap/
plug_in_lqr_iter.c:114, replay main.c:388-390).

The analog here: a JSON dotfile keyed store. Laws mirrored exactly:

- ``save_vals`` applies the ``set_aux_layer_name`` rule
  (main.c:474-486): an aux layer's NAME is stored only while the mask is
  in use, else cleared — names, not ids, survive across images;
- ``retrieve_vals`` merges stored values over compiled defaults
  (main.c:499-506): a missing key leaves the defaults;
- ``retrieve_vals_use_aux_layers_names`` re-resolves the stored names
  against the target image (layer_from_name, main.c:452-472,
  508-517) — a name with no matching layer resolves to unset.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib

from .config import (LqrConfig, SeamColors, EnergyFunc, ResizeOrder,
                     OutputTarget, ScalebackMode, MaskBehavior)
from .image_model import Image

DATA_KEY_VALS = "plug_in_lqr"          # main_common.h:26
DATA_KEY_UI_VALS = "plug_in_lqr_ui"    # main_common.h:27
DATA_KEY_COL_VALS = "plug_in_lqr_col"  # main_common.h:28

_ENUM_FIELDS = {"output_target": OutputTarget, "nrg_func": EnergyFunc,
                "res_order": ResizeOrder, "mask_behavior": MaskBehavior,
                "scaleback_mode": ScalebackMode}


def default_settings_path() -> pathlib.Path:
    env = os.environ.get("LQR_TPU_SETTINGS")
    if env:
        return pathlib.Path(env)
    return pathlib.Path.home() / ".config" / "lqr_tpu" / "settings.json"


class SettingsStore:
    """Keyed persistent store (the gimp_set_data/get_data surface)."""

    def __init__(self, path: str | os.PathLike | None = None):
        self.path = pathlib.Path(path) if path else default_settings_path()

    def _read_all(self) -> dict:
        try:
            with open(self.path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return {}

    def get_data(self, key: str):
        """gimp_get_data: None when the key was never stored."""
        return self._read_all().get(key)

    def set_data(self, key: str, value: dict):
        data = self._read_all()
        data[key] = value
        self.path.parent.mkdir(parents=True, exist_ok=True)
        tmp = self.path.with_suffix(".tmp")
        with open(tmp, "w") as f:
            json.dump(data, f, indent=1, sort_keys=True)
        os.replace(tmp, self.path)


@dataclasses.dataclass(frozen=True)
class UIVals:
    """PlugInUIVals (/root/reference/src/main.h:54-71): dialog state
    persisted under ``plug_in_lqr_ui`` (save /root/reference/src/
    main.c:495, restore main.c:504); defaults mirror default_ui_vals
    (main.c:106-122). ``last_layer_ID`` becomes a layer NAME (names, not
    ids, are what survives across images in this store); the dialog
    window-position triple and the layer_on_edit fields are omitted —
    the reference needs them only because its process restarts around
    each mask-editor round trip, which the in-process MaskEditSession
    does not."""

    chain_active: bool = False
    pres_status: bool = False
    disc_status: bool = False
    rigmask_status: bool = False
    last_used_width: int = -1
    last_used_height: int = -1
    last_layer_name: str = ""
    seams_control_expanded: bool = False
    operations_expanded: bool = False


def save_ui_vals(store: SettingsStore, ui: UIVals):
    """The ui_vals half of save_vals (main.c:495)."""
    store.set_data(DATA_KEY_UI_VALS, dataclasses.asdict(ui))


def retrieve_ui_vals(store: SettingsStore) -> UIVals:
    """The ui_vals half of retrieve_vals (main.c:504): stored values
    over defaults; unknown keys ignored."""
    d = store.get_data(DATA_KEY_UI_VALS)
    if not d:
        return UIVals()
    fields = {f.name for f in dataclasses.fields(UIVals)}
    return UIVals(**{k: v for k, v in d.items() if k in fields})


def _set_aux_layer_name(in_use: str, status: bool) -> str:
    """set_aux_layer_name (main.c:474-486): keep the name only while the
    mask is actually in use."""
    return in_use if (status and in_use) else ""


def save_vals(store: SettingsStore, cfg: LqrConfig,
              colors: SeamColors | None = None, *,
              pres_status: bool = True, disc_status: bool = True,
              rigmask_status: bool = True) -> LqrConfig:
    """save_vals (main.c:487-496). Returns the config as stored (with the
    name fields refreshed per the set_aux_layer_name rule)."""
    cfg = cfg.replace(
        pres_layer_name=_set_aux_layer_name(cfg.pres_layer, pres_status),
        disc_layer_name=_set_aux_layer_name(cfg.disc_layer, disc_status),
        rigmask_layer_name=_set_aux_layer_name(cfg.rigmask_layer,
                                               rigmask_status))
    d = dataclasses.asdict(cfg)
    for k, enum_t in _ENUM_FIELDS.items():
        d[k] = int(d[k])
    store.set_data(DATA_KEY_VALS, d)
    if colors is not None:
        store.set_data(DATA_KEY_COL_VALS, dataclasses.asdict(colors))
    return cfg


def retrieve_vals(store: SettingsStore) -> tuple[LqrConfig, SeamColors]:
    """retrieve_vals (main.c:499-506): stored values over defaults."""
    cfg = LqrConfig()
    d = store.get_data(DATA_KEY_VALS)
    if d:
        fields = {f.name for f in dataclasses.fields(LqrConfig)}
        kw = {k: v for k, v in d.items() if k in fields}
        for k, enum_t in _ENUM_FIELDS.items():
            if k in kw:
                kw[k] = enum_t(kw[k])
        cfg = LqrConfig(**kw)
    colors = SeamColors()
    c = store.get_data(DATA_KEY_COL_VALS)
    if c:
        fields = {f.name for f in dataclasses.fields(SeamColors)}
        colors = SeamColors(**{k: v for k, v in c.items() if k in fields})
    return cfg, colors


def retrieve_vals_use_aux_layers_names(
        store: SettingsStore, image: Image) -> tuple[LqrConfig, SeamColors]:
    """retrieve_vals_use_aux_layers_names (main.c:508-517): the
    RUN_WITH_LAST_VALS entry — aux masks matched per-image BY NAME (the
    GAP per-frame replay contract, help/en/index.wiki:100-106)."""
    cfg, colors = retrieve_vals(store)

    def resolve(name: str) -> str:
        return name if image.layer_by_name(name) is not None else ""

    cfg = cfg.replace(pres_layer=resolve(cfg.pres_layer_name),
                      disc_layer=resolve(cfg.disc_layer_name),
                      rigmask_layer=resolve(cfg.rigmask_layer_name))
    return cfg, colors


def store_iterated_vals(store: SettingsStore, cfg: LqrConfig):
    """The GAP iterator's write (plug_in_lqr_iter.c:114): persist a
    blended per-frame config under ``plug_in_lqr`` so the next
    WITH_LAST_VALS run uses it."""
    d = dataclasses.asdict(cfg)
    for k in _ENUM_FIELDS:
        d[k] = int(d[k])
    store.set_data(DATA_KEY_VALS, d)
