"""Interactive resizing session — the headless ``dialog_I`` equivalent.

Re-expresses the reference's interactive mode (SURVEY.md §3.2,
/root/reference/src/interface_I.c) without GTK:

- a long-lived carver whose map makes re-targeting within
  [ref - depth, ref + depth] near-real-time (map lookup, no recompute);
- debounced size changes (the 20 ms poll + 400 ms "coordinates-alarm" of
  interface_I.c:44-46 becomes an explicit ``debounce_s`` on ``set_size``);
- the Map panel surface: ``map_info`` (orientation / reference size /
  range / next enl step, interface_I.c:531-587), ``reset_map`` (flatten
  button), ``dump_seam_map`` (vmap dump button);
- ``reset_size`` (size-reset button): back to the reference size, which
  reproduces the original image iff the map was never reset.
"""

from __future__ import annotations

import dataclasses
import time

from .config import LqrConfig, SeamColors
from .errors import LqrImageError
from .i18n import _
from .image_model import Image
from .render import (CarverData, init_carver, render_interactive,
                     render_flatten, render_dump_vmap)


@dataclasses.dataclass
class MapInfo:
    """The Map info label contents (interface_I.c:531-587)."""

    orientation: int        # 0 = horizontal (width), 1 = vertical
    ref_w: int
    ref_h: int
    depth: int
    range_min: int          # ref - depth along the map's axis
    range_max: int          # ref + depth
    next_enl_step: int      # size at which the next enlargement pass starts

    def describe(self) -> str:
        axis = _("width") if self.orientation == 0 else _("height")
        ref = self.ref_w if self.orientation == 0 else self.ref_h
        return _("map: {axis}, reference {ref} (image {w}x{h}), "
                 "depth {depth}, range [{lo}, {hi}], "
                 "next step at {step}").format(
            axis=axis, ref=ref, w=self.ref_w, h=self.ref_h,
            depth=self.depth, lo=self.range_min, hi=self.range_max,
            step=self.next_enl_step)


class InteractiveSession:
    """Drives render_interactive over a live carver."""

    def __init__(self, image: Image, cfg: LqrConfig | None = None,
                 colors: SeamColors | None = None, debounce_s: float = 0.0):
        self.cfg = cfg or LqrConfig()
        self.colors = colors or SeamColors()
        self.debounce_s = debounce_s
        self.cd: CarverData = init_carver(image, self.cfg, interactive=True)
        layer = self.cd.image.layer_by_name(self.cd.layer_name)
        self._initial_size = (layer.width, layer.height)
        self._pending = None
        self._pending_t = 0.0

    # -- size changes (debounced like the coordinates-alarm) ---------------

    def set_size(self, width: int, height: int):
        """Request a new size; applies immediately unless debouncing."""
        self._pending = (width, height)
        self._pending_t = time.monotonic()
        if self.debounce_s <= 0:
            return self.flush()
        return None

    def tick(self):
        """Poll (the 20 ms timer): applies the pending size once settled."""
        if (self._pending is not None
                and time.monotonic() - self._pending_t >= self.debounce_s):
            return self.flush()
        return None

    def flush(self):
        if self._pending is None:
            return None
        w, h = self._pending
        self._pending = None
        if not render_interactive(self.cfg, self.cd, w, h):
            # the FATAL response path: the image was mutated under the live
            # session (layer removed / bpp changed; render.c:485-500,
            # interface_I.c:521-525)
            raise LqrImageError(_(
                "image changed under the interactive session (layer removed "
                "or its type changed); the session cannot continue"))
        return self.image

    def reset_size(self):
        """Size-reset button: back to the initial size."""
        return self.set_size(*self._initial_size)

    # -- map panel ---------------------------------------------------------

    def map_info(self) -> MapInfo:
        cd = self.cd
        carver = cd.carver
        ref = carver.ref_width if carver.orientation == 0 \
            else carver.ref_height
        return MapInfo(
            orientation=carver.orientation,
            ref_w=carver.ref_width, ref_h=carver.ref_height,
            depth=carver.depth,
            range_min=ref - carver.depth,
            range_max=ref + carver.depth,
            next_enl_step=int(ref * carver.enl_step),
        )

    def reset_map(self):
        """Flatten ('reset map') button."""
        render_flatten(self.cd)

    def dump_seam_map(self) -> bool:
        """Seam-map dump button (reuses one layer, interface_I.c:636-652)."""
        return render_dump_vmap(self.cd, self.colors)

    # -- output ------------------------------------------------------------

    @property
    def image(self) -> Image:
        return self.cd.image

    def back(self):
        """The Back button: returns (image, cfg) for re-entering the main
        dialog flow; output target is forced back to SAME_LAYER
        (interface_I.c:429-454)."""
        self.flush()
        self.cfg = self.cfg.replace(output_target=0)
        return self.cd.image, self.cfg
